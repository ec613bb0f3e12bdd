"""The published multi-head GAT on the port (``models.gat.gat_heads_forward``)
on the CPU, where the ops run their plain versions.

At n = 300 with heads of width 12 and 9 (one width off a multiple of 4):
the forward, the loss and every leaf's gradient against the plain
reference (``ops.gat_heads_reference``, autograd, float64) on seeded random
weights, over a hybrid aggregator (int8 and 1-bit tiles, residual,
transposes) under each shift and over a gather plan; the benchmark's
float64 reference (``portbench/reference/gat_heads.py``, its backward
written out) against the same; the benchmark model's launches and useful
FLOPs against a hand count; the new spans and counters; and the
benchmark's harness over the model at these widths.

Tolerances: the port computes in float32 and the references in float64;
outputs and gradients within 2e-5 of the largest element (float32 sums of
a few dozen terms of O(1)); the two float64 references within 1e-8 of
the largest element (their backwards sum the softmax's terms in other
orders, and <g_i, z_j> - c_i cancels: 1.4e-9 seen)."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.graph import degree_sort, rmat_graph
from gnn_computing_tpu_torch.models.gat import GATHeadsLayerParams, gat_heads_forward
from gnn_computing_tpu_torch.ops import gat_heads_reference as ref
from gnn_computing_tpu_torch.utils.profiling import recording

N, M = 300, 4000
DIMS = (16, 12, 12, 9)
HEADS = (2, 2, 3)
SKIP = (False, True, False)
CFG = {"dims": list(DIMS), "gat": {"heads": list(HEADS), "skip": list(SKIP), "relu_slope": 0.2, "fast": False,
                                   "dot_mode": "exact", "stabilize": "bound"},
       "train": {"loss": "softmax_xent", "classes": DIMS[-1], "optimizer": "adam", "lr": 0.005,
                 "betas": [0.9, 0.999], "eps": 1e-08}}
SCHEDULE = dict(tile_rows=16, tile_cols=128, threshold=4, residual_block=8, pack=2, tile_dtype=np.int8,
                bit_tiles=True)


@pytest.fixture(scope="module")
def graph():
    g = rmat_graph(N, M, seed=5, with_val=False)
    return g.reorder(degree_sort(g))


@pytest.fixture(scope="module")
def hybrid(graph):
    return Aggregator.schedule_hybrid(graph, device="cpu", **SCHEDULE)


def edge_list(g):
    dst = torch.from_numpy(np.repeat(np.arange(g.num_nodes), np.diff(g.indptr))).long()
    return torch.from_numpy(g.indices.astype(np.int64)), dst


def drawn(seed: int = 1) -> tuple:
    """(x, labels, [W_1, a_1, ...]): float32 weights at the Glorot scale of
    one head's projection, as the benchmark draws them."""
    gen = torch.Generator().manual_seed(seed)
    leaves, f_in = [], DIMS[0]
    for i, (f, k) in enumerate(zip(DIMS[1:], HEADS)):
        scale = (2.0 / (f_in + f)) ** 0.5
        leaves += [torch.randn((f_in, k * f), generator=gen) * scale, torch.randn((k, f, 2), generator=gen) * scale]
        f_in = k * f
    x = torch.randn((N, DIMS[0]), generator=gen)
    labels = torch.randint(0, DIMS[-1], (N,), generator=gen)
    return x, labels, leaves


def port_loss_and_grads(agg, x, labels, leaves, **kw):
    leaves = [w.clone().requires_grad_(True) for w in leaves]
    params = [GATHeadsLayerParams(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
    out = gat_heads_forward(agg, params, x, SKIP, **kw)
    loss = torch.nn.functional.cross_entropy(out, labels)
    return out.detach(), loss.detach(), list(torch.autograd.grad(loss, leaves))


def close(got, want, what: str, rel: float = 2e-5):
    err = float((got.double() - want.double()).abs().max())
    assert err <= rel * float(want.abs().max()), (what, err, float(want.abs().max()))


@pytest.mark.parametrize("kind, stabilize", [("hybrid", "bound"), ("hybrid", True), ("hybrid", False),
                                             ("gather", "bound")])
def test_forward_loss_and_gradients_match_the_reference(graph, hybrid, kind, stabilize):
    agg = hybrid if kind == "hybrid" else Aggregator.schedule(graph, "neighbor_grouping", device="cpu")
    if kind == "hybrid":
        assert agg.tile_parts() and agg.plan.num_edges and agg.tile_parts_t()
    x, labels, leaves = drawn()
    out, loss, grads = port_loss_and_grads(agg, x, labels, leaves, stabilize=stabilize)
    src, dst = edge_list(graph)
    w64 = [w.double() for w in leaves]
    want = ref.forward(src, dst, N, x.double(), w64, SKIP)
    loss64, grads64 = ref.loss_and_grads(src, dst, N, x.double(), labels, w64, SKIP)
    assert out.shape == (N, DIMS[-1])
    close(out, want, "logits")
    assert abs(float(loss) - float(loss64)) <= 1e-6 * abs(float(loss64))
    for i, (g, g64) in enumerate(zip(grads, grads64)):
        close(g, g64, f"leaf {i}")


def test_benchmark_reference_matches_the_plain_reference(graph):
    from portbench.reference import common, gat_heads

    x, labels, leaves = drawn(seed=2)
    src, dst = edge_list(graph)
    edges = common.Edges(src=src, dst=dst, num_nodes=N)
    w64 = [w.double() for w in leaves]
    got = gat_heads.forward(CFG, edges, x, leaves)
    close(got, ref.forward(src, dst, N, x.double(), w64, SKIP), "forward", rel=1e-8)
    loss, grads = gat_heads.forward_backward(CFG, edges, x, labels, leaves)
    loss64, grads64 = ref.loss_and_grads(src, dst, N, x.double(), labels, w64, SKIP)
    assert abs(float(loss) - float(loss64)) <= 1e-12
    for i, (g, g64) in enumerate(zip(grads, grads64)):
        close(g, g64, f"leaf {i}", rel=1e-8)


def test_reference_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        x, _, leaves = drawn()
        src, dst = edge_list(rmat_graph(N, M, seed=5, with_val=False))
        ref.forward(src, dst, N, x, leaves, SKIP)
        assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("train", [False, True])
def test_benchmark_launches_a_head_per_part(train):
    from portbench.models import gat_heads

    cfg = {"dims": [512, 256, 256, 121], "gat": {"heads": [4, 4, 6], "skip": [False, True, False]}}
    got = gat_heads.tile_launches(cfg, train)
    want = [("B2", "fwd", 256)] * 4 + ([("B3", "fwd", 256)] * 4 + [("B4", "t", 256)] * 4 if train else []) \
        + [("B2", "fwd", 256)] * 4 + ([("B3", "fwd", 256)] * 4 + [("B4", "t", 256)] * 4 if train else []) \
        + [("B2", "fwd", 121)] * 6 + ([("B3", "fwd", 121)] * 6 + [("B4", "t", 121)] * 6 if train else [])
    assert got == want


@pytest.mark.parametrize("train, want", [(False, 3820.0), (True, 10400.0)])
def test_benchmark_flops_by_hand(train, want):
    # n = 10, m = 20, 4 -> 2 heads x 3 (concat, ELU) -> 2 heads x 3 (concat, identity skip, ELU) -> 2 heads x 2
    # (mean): per layer the projection, the heads, the merge 1 a value (ELU, skip, mean); the backward per
    # head, dW, the input's gradient past layer 1 and the merge's backward.
    from portbench.models import gat_heads

    cfg = {"dims": [4, 3, 3, 2], "gat": {"heads": [2, 2, 2], "skip": [False, True, False]}}
    n, m = 10, 20

    def head(f):  # per head: att 4nf, edges m(2f + 4), num / den nf
        return 4 * n * f + m * (2 * f + 4) + n * f

    def head_bwd(f):
        return m * (4 * f + 5) + 10 * n * f

    fwd = (2 * n * 4 * 6 + 2 * head(3) + n * 6) + (2 * n * 6 * 6 + 2 * head(3) + 2 * n * 6) \
        + (2 * n * 6 * 4 + 2 * head(2) + n * 4)
    bwd = (2 * head_bwd(3) + 2 * n * 4 * 6 + n * 6) + (2 * head_bwd(3) + 2 * 2 * n * 6 * 6 + 2 * n * 6) \
        + (2 * head_bwd(2) + 2 * 2 * n * 6 * 4 + n * 4)
    assert fwd + (bwd if train else 0) == want
    assert gat_heads.useful_flops(cfg, n, m, train) == want


def test_spans_and_counters_of_a_training_step(hybrid):
    from gnn_computing_tpu_torch.models.training import make_train_step

    x, labels, leaves = drawn()
    leaves = [w.requires_grad_(True) for w in leaves]
    params = [GATHeadsLayerParams(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
    step = make_train_step(lambda h: gat_heads_forward(hybrid, params, h, SKIP, stabilize="bound"),
                           torch.optim.Adam(leaves, lr=5e-3), device="cpu")
    with recording() as rec:
        step((x,), labels)
    sp = rec.spans
    heads = [s for s in sp if s.name == "gnn.gat.head"]
    assert [(s.attrs["layer"], s.attrs["head"], s.attrs["f"]) for s in heads] == [
        (i, k, f) for i, (f, h) in enumerate(zip(DIMS[1:], HEADS)) for k in range(h)]
    assert all(sp[s.parent].name == "gnn.forward" for s in heads)
    merges = [s for s in sp if s.name == "gnn.gat.merge"]
    assert len(merges) == len(HEADS) and all(sp[s.parent].name == "gnn.forward" for s in merges)
    for name in ("gnn.gat.tiles", "gnn.gat.residual"):
        inner = [s for s in sp if s.name == name]
        assert len(inner) == sum(HEADS) and all(sp[s.parent].name == "gnn.gat.head" for s in inner)
    need = [s for s in sp if s.name == "gnn.sync" and s.attrs["site"] == "gat.bound_need"]
    assert len(need) == sum(HEADS) and all(sp[s.parent].name == "gnn.gat.head" for s in need)
    copy = sum(N * h * f * 4 for f, h in zip(DIMS[1:], HEADS))
    assert rec.counters["gat.heads"] == sum(HEADS) and rec.counters["gat.head_copy_bytes"] == copy


def half_batch(monkeypatch):
    from gnn_computing_tpu_torch.models import training

    xent = training.softmax_xent
    monkeypatch.setattr(training, "softmax_xent", lambda z, y, mask=None: xent(z[: len(z) // 2], y[: len(y) // 2]))


def unchanged_state(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch}


@pytest.mark.parametrize("fault", [None, "unchanged_state", "half_batch"])
def test_benchmark_harness_over_the_model(monkeypatch, fault):
    """The gat-ppi cell at these widths through the harness on a small
    RMAT: correct under its limits, and not where Adam leaves the state or
    the loss leaves out half the batch (which ``loss_gap`` must catch: the
    TF32 control leaves the loss as it is)."""
    from portbench import harness, spec

    cell = spec.cell("gat-ppi.reddit-train")
    graph = dict(cell.traffic["graph"], n=1024, m=16384)
    cell = dataclasses.replace(cell, config=dict(cell.config, dims=CFG["dims"], gat=dict(cell.config["gat"],
                               heads=CFG["gat"]["heads"]), train=dict(cell.config["train"], classes=DIMS[-1])),
                               traffic=dict(cell.traffic, graph=graph))
    if fault:
        FAULTS[fault](monkeypatch)
    r = harness.run(cell, 2**31 + 17, 0.2, False, "cpu", time.time(), log=lambda *a: None)
    assert r["correct"] == (fault is None), r["checks"]
    checks = r["checks"]
    if fault is None:
        assert all(c["value"] < 1e-5 for c in checks.values()), checks
    elif fault == "half_batch":
        assert checks["loss_gap"]["value"] > checks["loss_gap"]["limit"], checks
