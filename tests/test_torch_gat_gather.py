"""GAT over the gather-only schedules of the PyTorch port: ``gat_aggregate``
and ``gat_aggregate_parts`` (un-stabilized, the exact row max, 'bound',
packed, a given row shift, every gather mode), the split ops of Figure 10a,
their gradients, ``Aggregator.run_gat``, the 3-layer GCN and GAT forwards
(multi-head too) and 3 Adam steps over ``Aggregator.schedule``, against
the JAX package on the CPU (``jax.grad``, optax) and the float64 oracle
``gat_aggregate_dense``, from the same numpy-seeded inputs.

Tolerance: max|port - jax| <= 1e-5 * max|jax| (float32 summation order
only) in the exact modes, within 4 ulps of the dtype times max|jax| where
a plain 16-bit gather mode is used; the exact results also pass the repo
gate (|y - ref| <= 1e-2*|ref| + 1e-5) against the float64 oracle.
Gradients within 1e-4 relative L2; training as tests/test_torch_train.py
holds it (losses within 1e-5 relative, parameters within 1e-5 *
max|param|)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_computing_tpu.aggregator import Aggregator as JAggregator
from gnn_computing_tpu.graph.reorder import degree_sort as j_degree_sort
from gnn_computing_tpu.models.gat import GATLayerParams as JGATLayerParams
from gnn_computing_tpu.models.gat import gat_forward as j_gat_forward
from gnn_computing_tpu.models.gcn import gcn_forward as j_gcn_forward
from gnn_computing_tpu.models.gcn import gcn_forward_bench as j_gcn_forward_bench
from gnn_computing_tpu.ops import gat as j_gat
from gnn_computing_tpu.schedule import make_plan as j_make_plan

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.convert import gat_params_from_jax, gcn_params_from_jax
from gnn_computing_tpu_torch.graph import degree_sort, normal_features
from gnn_computing_tpu_torch.models.gat import GATLayerParams, gat_forward, glorot_gat_weights
from gnn_computing_tpu_torch.models.gcn import gcn_forward, gcn_forward_bench, glorot_weights
from gnn_computing_tpu_torch.models.training import make_train_step
from gnn_computing_tpu_torch.ops import gat
from gnn_computing_tpu_torch.ops.reference import gat_aggregate_dense
from gnn_computing_tpu_torch.ops.validate import assert_valid
from gnn_computing_tpu_torch.schedule import make_plan

from test_torch_schedule_gather import both_graphs
from test_torch_spmm_gather import close, feats, rel_l2
from test_torch_train import DIMS, _check_training, _graphs, _jax_train

SCHEDULES = {
    "ng32": ("neighbor_grouping", dict(block_size=32)),
    "las": ("locality", dict(num_partitions=4)),
    "lasng8": ("locality_neighbor_grouping", dict(num_partitions=4, block_size=8)),
}


def setting(name: str, att_scale: float = 1.0):
    """(host graph, JAX plan, port plan, h, att) over the graph with
    isolated rows and sources; att ~ att_scale N(0, 1)."""
    sched, kw = SCHEDULES[name]
    gj, gp = both_graphs("isolated", with_val=False)
    h = feats(gp.n_src, 16, 21)
    att = (feats(gp.num_nodes, 2, 22) * att_scale).astype(np.float32)
    return gp, j_make_plan(gj, sched, **kw).device_put(), make_plan(gp, sched, **kw).to("cpu"), h, att


def oracle(gp, h, att):
    return gat_aggregate_dense(gp, h, att[:, 0], att[:, 1])[0]


@pytest.mark.parametrize("stabilize", [False, True, "bound"])
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_gat_aggregate_matches_jax(name, stabilize):
    """Output, slot scores and denominators; any truthy stabilize is the
    exact row max over a gather plan, in both packages."""
    gp, jplan, plan, h, att = setting(name)
    want = jax.jit(lambda p, hh, aa: j_gat.gat_aggregate(p, hh, aa, stabilize=stabilize, return_scores=True))(
        jplan, jnp.asarray(h), jnp.asarray(att))
    out, score, den = gat.gat_aggregate(plan, torch.from_numpy(h), torch.from_numpy(att), stabilize=stabilize,
                                        return_scores=True)
    close(out, want[0], f"gat_aggregate {name} {stabilize}", ref=oracle(gp, h, att))
    close(score, want[1], f"scores {name} {stabilize}")
    close(den, want[2], f"den {name} {stabilize}")
    if stabilize:  # every row's largest score is 1 (0 rows without edges)
        top = torch.zeros(gp.num_nodes).scatter_reduce_(0, plan.dst, score.amax(dim=1), "amax")
        assert torch.equal(top, torch.from_numpy((gp.degrees > 0).astype(np.float32)))


FIRST_CALL_TRIALS = 200  # a process each, for each of exp, log and tanh


def test_first_threaded_mkl_calls_after_import_are_exact():
    """PyTorch's CPU exp, log and tanh on float32 go through MKL's VML, called
    from every thread of a parallel_for at once.  The first such call of a
    process can leave part of its output up to 1.5e-4 relative off (about 1
    process in 100 for each of the three, 8 threads, 11,520 elements, 6
    processes at once; probes/first_threaded_call.py): the cause of
    test_gat_aggregate_matches_jax's occasional failure, whose first case
    made its xdist worker's first exp.  Importing the port runs one exp of
    one element on the calling thread, which sets VML up for all three.
    Here every trial is a process forked after the import that makes its
    first threaded call of one of them and holds it to float64 at 1e-6.  In
    a copy of the port without the import's exp, each of 6 runs of these 600
    trials found trials off (31 of 3,600 in all)."""
    code = (
        "import gnn_computing_tpu_torch\n"
        "from gnn_computing_tpu_torch.probes.first_threaded_call import main\n"
        f"main(['--ops', 'exp,log,tanh', '--warm', 'none', '--trials', '{FIRST_CALL_TRIALS}'])\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r["op"] for r in rows] == ["exp", "log", "tanh"]
    for r in rows:
        assert r["trials"] == FIRST_CALL_TRIALS and r["off_first"] == 0 and r["off_second"] == 0, r


# (att gather mode, h gather mode) of the port and of the JAX package, ulps
PART_MODES = {
    "exact": ((None, None), (None, None), None),
    "f16_split2": (("f16_split2", "f16_split2"), ("f16_split2", "f16_split2"), None),
    "f16_split2+bf16_split2": (("f16_split2", "bf16_split2"), ("f16_split2", "bf16_split2"), None),
    "bf16": ((torch.bfloat16, torch.bfloat16), (jnp.bfloat16, jnp.bfloat16), 4 * 2.0**-7),
    "f16": ((torch.float16, torch.float16), (jnp.float16, jnp.float16), 4 * 2.0**-10),
}


@pytest.mark.parametrize("stabilize", [False, True])
@pytest.mark.parametrize("mode", list(PART_MODES))
def test_gat_aggregate_parts_modes_match_jax(mode, stabilize):
    gp, jplan, plan, h, att = setting("lasng8")
    (pa, ph), (ja, jh), tol = PART_MODES[mode]
    want = jax.jit(lambda p, hh, aa: j_gat.gat_aggregate_parts(
        p, hh, aa, stabilize=stabilize, att_gather_dtype=ja, h_gather_dtype=jh))(jplan, jnp.asarray(h), jnp.asarray(att))
    got = gat.gat_aggregate_parts(plan, torch.from_numpy(h), torch.from_numpy(att), stabilize=stabilize,
                                  att_gather_dtype=pa, h_gather_dtype=ph)
    for g, w, what in zip(got, want, ("num", "den", "score")):
        close(g, w, f"{what} {mode} stabilize={stabilize}", tol)
    if tol is None and mode != "f16_split2+bf16_split2":
        assert_valid(got[0] / torch.where(got[1] == 0, 1.0, got[1])[:, None], oracle(gp, h, att), what=mode)
    with pytest.raises(ValueError):  # no attention mode in the JAX package either
        gat.gat_aggregate_parts(plan, torch.from_numpy(h), torch.from_numpy(att), att_gather_dtype="bf16_split2")


@pytest.mark.parametrize("name", ["ng32", "lasng8"])
def test_packed_and_row_shift_match_jax(name):
    gp, jplan, plan, h, att = setting(name)
    shift = feats(gp.num_nodes, 1, 23)[:, 0]
    cases = [dict(packed=True), dict(packed=True, stabilize=True), dict(row_shift=shift),
             dict(row_shift=shift, stabilize=True)]
    for kw in cases:
        jkw = {k: jnp.asarray(v) if k == "row_shift" else v for k, v in kw.items()}
        pkw = {k: torch.from_numpy(v) if k == "row_shift" else v for k, v in kw.items()}
        want = jax.jit(lambda p, hh, aa: j_gat.gat_aggregate_parts(p, hh, aa, **jkw))(
            jplan, jnp.asarray(h), jnp.asarray(att))
        got = gat.gat_aggregate_parts(plan, torch.from_numpy(h), torch.from_numpy(att), **pkw)
        for g, w, what in zip(got, want, ("num", "den", "score")):
            close(g, w, f"{what} {name} {sorted(kw)}")


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_wide_logits_stay_finite_when_stabilized(name):
    """att at scale 40: logits up to ~150, far past float32's exp range;
    stabilize=True stays finite and within the gate of the float64
    softmax, as the JAX package's."""
    gp, jplan, plan, h, att = setting(name, att_scale=40.0)
    assert np.abs(att).max() > 100.0
    raw = gat.gat_aggregate(plan, torch.from_numpy(h), torch.from_numpy(att))
    assert not bool(torch.isfinite(raw).all())  # the reference form overflows
    want = jax.jit(lambda p, hh, aa: j_gat.gat_aggregate(p, hh, aa, stabilize=True))(
        jplan, jnp.asarray(h), jnp.asarray(att))
    got = gat.gat_aggregate(plan, torch.from_numpy(h), torch.from_numpy(att), stabilize=True)
    close(got, want, f"wide logits {name}", ref=oracle(gp, h, att))


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_split_ops_match_jax(name):
    gp, jplan, plan, h, att = setting(name)
    sv = feats(plan.num_tasks_padded, plan.block_size, 24)
    nv = feats(gp.num_nodes, 1, 25)[:, 0]
    nv[::7] = 0.0

    @jax.jit
    def jax_side(p, hh, aa, ss, vv):
        return dict(
            u_add_v=j_gat.u_add_v(p, aa), add_to_center=j_gat.add_to_center(p, ss),
            div_each=j_gat.div_each(p, ss, vv), att_gat=j_gat.att_gat(p, aa),
            base=j_gat.gat_split_forward(p, hh, aa), adapter=j_gat.gat_split_forward(p, hh, aa, use_adapter=True),
        )

    want = jax_side(jplan, *(jnp.asarray(x) for x in (h, att, sv, nv)))
    ht, at, st, vt = (torch.from_numpy(x) for x in (h, att, sv, nv))
    got = dict(
        u_add_v=gat.u_add_v(plan, at), add_to_center=gat.add_to_center(plan, st), div_each=gat.div_each(plan, st, vt),
        att_gat=gat.att_gat(plan, at), base=gat.gat_split_forward(plan, ht, at),
        adapter=gat.gat_split_forward(plan, ht, at, use_adapter=True),
    )
    for k in want:
        close(got[k], want[k], f"{k} {name}", ref=oracle(gp, h, att) if k in ("base", "adapter") else None)
    close(gat.add_to_center(plan, st.reshape(-1)), want["add_to_center"], "add_to_center of flat slots")
    close(got["base"], gat.gat_aggregate(plan, ht, at).numpy(), f"the split pipeline is gat_aggregate ({name})")


@pytest.mark.parametrize("stabilize", [False, True])
@pytest.mark.parametrize("name", ["ng32", "lasng8"])
def test_gat_grads_match_jax(name, stabilize):
    """d(h), d(att) of gat_aggregate and of Aggregator.run_gat without
    tiles (with and without transposed plans) against jax.grad."""
    sched, kw = SCHEDULES[name]
    gj, gp = both_graphs("isolated", with_val=False)
    jagg = JAggregator.schedule(gj, sched, with_transpose=True, **kw)
    h, att, ct = feats(gp.n_src, 16, 26), feats(gp.num_nodes, 2, 27), feats(gp.num_nodes, 16, 28)
    want = jax.jit(jax.grad(lambda hh, aa: jnp.sum(jagg.run_gat(hh, aa, stabilize=stabilize) * ct), argnums=(0, 1)))(
        jnp.asarray(h), jnp.asarray(att))
    for with_t in (True, False):
        agg = Aggregator.schedule(gp, sched, with_transpose=with_t, device="cpu", **kw)
        ht = torch.from_numpy(h).requires_grad_(True)
        at = torch.from_numpy(att).requires_grad_(True)
        (agg.run_gat(ht, at, stabilize=stabilize) * torch.from_numpy(ct)).sum().backward()
        assert rel_l2(ht.grad, want[0]) <= 1e-4 and rel_l2(at.grad, want[1]) <= 1e-4


@pytest.mark.parametrize("name", ["ng32", "lasng8"])
def test_three_layer_forwards_match_jax(name):
    """The bench's GCN (ReLU after every layer; over a gather Aggregator,
    the residual dtype unused as in the JAX package) and gcn_forward (last
    layer linear, over the bare plan); GAT over the plan and over the
    Aggregator, and one 2-head layer."""
    sched, kw = SCHEDULES[name]
    gj, gp = both_graphs("isolated", with_val=False)
    jagg = JAggregator.schedule(gj, sched, with_transpose=True, **kw)
    agg = Aggregator.schedule(gp, sched, with_transpose=True, device="cpu", **kw)
    plan = make_plan(gp, sched, **kw).to("cpu")
    h = feats(gp.n_src, DIMS[0], 29) * 0.1
    ws = glorot_weights(DIMS, seed=0)
    gcn = gcn_params_from_jax(ws, device="cpu")
    jws = [jnp.asarray(w) for w in ws]
    gws = glorot_gat_weights(DIMS, seed=1)
    jgp = [JGATLayerParams(jnp.asarray(w), jnp.asarray(a)) for w, a in gws]
    gat_m = gat_params_from_jax(gws, device="cpu")
    heads = glorot_gat_weights(DIMS[:2], seed=2, heads=2)
    jheads = [JGATLayerParams(jnp.asarray(w), jnp.asarray(a)) for w, a in heads]
    pheads = [GATLayerParams(torch.from_numpy(w), torch.from_numpy(a)) for w, a in heads]

    @jax.jit
    def jax_side(ja, hh):
        return dict(
            bench=j_gcn_forward_bench(ja, jws, hh, residual_gather_dtype="f16_split2"),
            logits=j_gcn_forward(ja.plan, jws, hh), gat=j_gat_forward(ja.plan, jgp, hh),
            gat_agg=j_gat_forward(ja, jgp, hh, stabilize=True), heads=j_gat_forward(ja.plan, jheads, hh),
        )

    want = jax_side(jagg, jnp.asarray(h))
    ht = torch.from_numpy(h)
    with torch.no_grad():
        got = dict(
            bench=gcn_forward_bench(agg, list(gcn.weights), ht, residual_gather_dtype="f16_split2"),
            logits=gcn_forward(plan, list(gcn.weights), ht), gat=gat_m(plan, ht),
            gat_agg=gat_m(agg, ht, stabilize=True), heads=gat_forward(plan, pheads, ht),
        )
    assert got["heads"].shape == (gp.num_nodes, 2 * DIMS[1]) and bool((got["logits"] < 0).any())
    for k in want:
        close(got[k], want[k], f"{k} {name}")


@pytest.mark.parametrize("model_kind", ["gcn", "gat"])
def test_training_steps_over_gather_schedule_match_optax(model_kind):
    """3 Adam steps over Aggregator.schedule (locality + neighbor grouping,
    with transposed plans) against optax: the GCN's backward over the
    transposed plan (spmm_bidir), the GAT's through autograd with the exact
    row max (stabilize=True)."""
    gj, gp = _graphs(n=480, m=9000, seed=29)
    gj, gp = gj.reorder(j_degree_sort(gj)), gp.reorder(degree_sort(gp))
    kw = dict(num_partitions=4, block_size=8)
    jagg = JAggregator.schedule(gj, "locality_neighbor_grouping", with_transpose=True, **kw)
    agg = Aggregator.schedule(gp, "locality_neighbor_grouping", with_transpose=True, device="cpu", **kw)
    h = normal_features(gp.num_nodes, DIMS[0], seed=123) * 0.1
    labels = np.random.default_rng(7).integers(0, DIMS[-1], gp.num_nodes)
    if model_kind == "gcn":
        weights = glorot_weights(DIMS, seed=0)
        jparams = [jnp.asarray(w) for w in weights]
        model = gcn_params_from_jax(jparams, device="cpu")
        jfwd = jax.jit(lambda p, hh: j_gcn_forward_bench(jagg, p, hh, strategy="xla"))

        def fwd(hh):
            return model(agg, hh)
    else:
        weights = glorot_gat_weights(DIMS, seed=0)
        jparams = [JGATLayerParams(jnp.asarray(w), jnp.asarray(a)) for w, a in weights]
        model = gat_params_from_jax(jparams, device="cpu")
        jfwd = jax.jit(lambda p, hh: j_gat_forward(jagg, p, hh, stabilize=True))

        def fwd(hh):
            return model(agg, hh, stabilize=True)

    jlosses, jleaves = _jax_train(jfwd, jparams, h, labels)
    step = make_train_step(fwd, torch.optim.Adam(model.parameters(), lr=1e-3), device="cpu")
    losses = [float(step((torch.from_numpy(h),), labels)) for _ in range(3)]
    _check_training(losses, jlosses, model, jleaves)
