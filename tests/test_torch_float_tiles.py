"""Float-valued tiles in the PyTorch port against the JAX package: the GCN
normalization, float32 and bfloat16 ``densify`` (weighted multigraph,
factored scales), ``densify_gcn_norm``, ``TilePlan.astype`` / ``to`` /
``pad_runs`` / ``transpose`` keeping the tile format, the JAX defaults of
``schedule_hybrid`` (float32 tiles, transposed plans), the tile product and
the hybrid aggregation over float plans with their gradients, the
SDDMM -> ``tileplan_with_values`` -> weighted SpMM chain, the weighted
3-layer GCN forward, bench.py's ``--tile-dtype bf16`` forward and
``LayerOpts.aggregate_first``.

Tolerance: host arrays (tiles as float32 values or bfloat16 bit patterns,
indices, residual graphs) are compared for equality.  Float results: the
ops/validate gate (|y - ref| <= 1e-2*|ref| + 1e-5) against the JAX package
(and, where given, a float64 dense oracle), plus max|port - jax| <= 1e-5 *
max|jax| (float32 summation order only; assert_matches_jax)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_computing_tpu.aggregator import Aggregator as JAggregator
from gnn_computing_tpu.graph.reorder import degree_sort as j_degree_sort
from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat_graph
from gnn_computing_tpu.models.gcn import LayerOpts as JLayerOpts
from gnn_computing_tpu.models.gcn import fast_layer_opts as j_fast_layer_opts
from gnn_computing_tpu.models.gcn import gcn_forward_bench as j_gcn_forward_bench
from gnn_computing_tpu.ops.bcsr import bcsr_spmm as j_bcsr_spmm
from gnn_computing_tpu.ops.bcsr_sddmm import sddmm_bcsr as j_sddmm_bcsr
from gnn_computing_tpu.ops.bcsr_sddmm import tileplan_with_values as j_tileplan_with_values
from gnn_computing_tpu.schedule import tiles as j_tiles

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.convert import gcn_params_from_jax
from gnn_computing_tpu_torch.graph import CSRGraph, degree_sort, normal_features, rmat_graph
from gnn_computing_tpu_torch.models.gcn import LayerOpts, fast_layer_opts, gcn_forward_bench, glorot_weights
from gnn_computing_tpu_torch.ops import cuda_bcsr
from gnn_computing_tpu_torch.ops.bcsr import bcsr_spmm
from gnn_computing_tpu_torch.ops.bcsr_sddmm import sddmm_bcsr, tileplan_with_values
from gnn_computing_tpu_torch.schedule.tiles import densify, densify_gcn_norm, split_bit_tiles

from test_torch_spmm import assert_matches_jax

KW = dict(tile_rows=64, tile_cols=64, threshold=6)
FORMATS = {"f32": (np.float32, np.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _graphs(n=700, m=20000, seed=5, with_val=False):
    gj = j_rmat_graph(n, m, seed=seed, with_val=with_val, device="cpu")
    gp = rmat_graph(n, m, seed=seed, with_val=with_val)
    return gj.reorder(j_degree_sort(gj)), gp.reorder(degree_sort(gp))


def _multigraph():
    """A weighted multigraph: every edge twice or more, with its own value,
    so cells sum several values in edge order."""
    rng = np.random.default_rng(11)
    dst = rng.integers(0, 300, 6000)
    src = rng.integers(0, 300, 6000)
    dst = np.concatenate([dst, dst[:2000], dst[:500]])
    src = np.concatenate([src, src[:2000], src[:500]])
    val = rng.uniform(-1.0, 3.0, len(dst)).astype(np.float32)
    from gnn_computing_tpu.graph.csr import CSRGraph as JCSR

    return JCSR.from_edges(dst, src, 300, val=val), CSRGraph.from_edges(dst, src, 300, val=val)


def _bits(a):
    """Host tile values as comparable bits: bfloat16 as its uint16 pattern."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _same_plan(tj, tp):
    assert np.array_equal(_bits(tj.a), _bits(tp.a))
    for k in ("tile_col", "tile_row"):
        assert np.array_equal(np.asarray(getattr(tj, k)), getattr(tp, k)), k
    for k in ("num_tiles", "num_dense_edges", "num_nodes", "n_src", "tile_rows", "tile_cols"):
        assert getattr(tj, k) == getattr(tp, k), k
    for k in ("scale_dst", "scale_src"):
        assert (getattr(tj, k) is None) == (getattr(tp, k) is None)
        if getattr(tj, k) is not None:
            assert np.array_equal(np.asarray(getattr(tj, k)), np.asarray(getattr(tp, k))), k


def test_gcn_norm_val_equal():
    gj, gp = _graphs()
    assert np.array_equal(gj.gcn_norm_val(), gp.gcn_norm_val())
    jm, pm = _multigraph()
    assert np.array_equal(jm.gcn_norm_val(), pm.gcn_norm_val())


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("factored", [False, True])
def test_densify_float_equal(fmt, factored):
    """float32 values and bfloat16 bit patterns equal the JAX package's on a
    weighted multigraph (cell sums in float32 in edge order), with and
    without factored scales; so do pad_runs, transpose and the residual."""
    jdt, pdt = FORMATS[fmt]
    gj, gp = _multigraph()
    kw = dict(tile_rows=32, tile_cols=48, threshold=5)
    if factored:
        rng = np.random.default_rng(2)
        sd = rng.uniform(0.5, 2.0, 300).astype(np.float32)
        ss = rng.uniform(0.5, 2.0, 300).astype(np.float32)
        kw.update(scale_dst=sd, scale_src=ss)
    tj, rj = j_tiles.densify(gj, dtype=jdt, **kw)
    tp, rp = densify(gp, dtype=pdt, **kw)
    assert tp.format == ("float32" if fmt == "f32" else "bfloat16")
    assert np.asarray(tp.a).dtype == (np.float32 if fmt == "f32" else np.uint16)
    _same_plan(tj, tp)
    for pack in (1, 4):
        _same_plan(tj.pad_runs(pack), tp.pad_runs(pack))
    _same_plan(tj.transpose(), tp.transpose())
    assert np.array_equal(rj.indptr, rp.indptr) and np.array_equal(rj.indices, rp.indices)
    assert np.array_equal(rj.val, rp.val)
    # bfloat16 rounds the float32 sums to nearest even
    if fmt == "bf16":
        f32, _ = densify(gp, dtype=np.float32, **kw)
        want = torch.from_numpy(f32.a).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
        assert np.array_equal(_bits(tp.a), want)


def test_densify_gcn_norm_astype_and_to():
    """densify_gcn_norm (float32 counts plus scales), astype to bfloat16 and
    int8 equal the JAX package's; a 1-bit plan refuses astype; ``to`` and
    ``counts`` keep every format."""
    gj, gp = _graphs()
    tj, rj = j_tiles.densify_gcn_norm(gj, **KW)
    tp, rp = densify_gcn_norm(gp, **KW)
    _same_plan(tj, tp)
    assert np.array_equal(rj.val, rp.val)
    _same_plan(tj.astype(jnp.bfloat16), tp.astype(torch.bfloat16))
    _same_plan(tj.astype(np.int8), tp.astype(np.int8))
    on = tp.astype(torch.bfloat16).to("cpu")
    assert on.a.dtype == torch.bfloat16 and on.format == "bfloat16"
    assert torch.equal(on.astype(torch.float32).a, torch.from_numpy(tp.astype(torch.bfloat16).counts()))
    assert np.array_equal(on.counts().float().numpy(), tp.astype(torch.bfloat16).counts())
    assert tp.to("cpu").a.dtype == torch.float32
    counts, _ = densify(gp, dtype=np.int8, **KW)
    assert counts.to("cpu").a.dtype == torch.int8
    bits, _ = split_bit_tiles(counts)
    assert bits.to("cpu").a.dtype == torch.uint8 and bits.to("cpu").format == "bits"
    with pytest.raises(ValueError, match="1-bit"):
        bits.astype(np.float32)
    with pytest.raises(ValueError):
        split_bit_tiles(tp)


def test_schedule_hybrid_defaults_match_jax():
    """Without tile_dtype / with_transpose both packages build float32 tiles
    of the edge values and the transposed plans; bit_tiles over float tiles
    raises in both."""
    gj, gp = _graphs(with_val=True)
    kw = dict(KW, residual_block=4, pack=4)
    ja = JAggregator.schedule_hybrid(gj, device_put=False, **kw)
    pa = Aggregator.schedule_hybrid(gp, device="cpu", **kw)
    assert pa.tile.format == "float32" and pa.tile_t.format == "float32"
    for jt, pt in ((ja.tile, pa.tile), (ja.tile_t, pa.tile_t)):
        host = dataclasses.replace(pt, a=pt.a.numpy(), tile_col=pt.tile_col.numpy(), tile_row=pt.tile_row.numpy())
        _same_plan(jt, host)
    for k in ("src", "count", "dst", "val"):
        assert np.array_equal(np.asarray(getattr(ja.plan_t, k)).reshape(-1), getattr(pa.plan_t, k).numpy().reshape(-1)), k
    assert np.array_equal(np.asarray(ja.edge_map_t), pa.edge_map_t.numpy())
    assert np.array_equal(pa.in_degree.numpy(), gp.degrees)
    with pytest.raises(AssertionError):
        JAggregator.schedule_hybrid(gj, device_put=False, bit_tiles=True, **kw)
    with pytest.raises(ValueError, match="bit_tiles"):
        Aggregator.schedule_hybrid(gp, device="cpu", bit_tiles=True, **kw)


@pytest.mark.parametrize("setting", ["f32", "bf16", "factored"])
def test_float_hybrid_spmm_and_grad_match_jax(setting):
    """bcsr_spmm and the hybrid aggregation (forward and gradient, B1 over
    the transposed float parts) over float32, bfloat16 and factored float
    plans of the GCN-normalized graph, against the JAX package's XLA path
    and jax.grad, and a float64 dense oracle."""
    gj, gp = _graphs()
    val = gp.gcn_norm_val()
    kw = dict(KW, residual_block=4, pack=1)
    if setting == "factored":
        jt, _ = j_tiles.densify_gcn_norm(gj, **KW)
        pt, _ = densify_gcn_norm(gp, **KW)
        h = normal_features(gp.num_nodes, 12, seed=3)
        got = bcsr_spmm(pt.to("cpu"), torch.from_numpy(h))
        want = j_bcsr_spmm(jt, jnp.asarray(h), strategy="xla")
        assert_matches_jax(got.numpy(), jax.device_get(want), what="factored float bcsr_spmm")
        return
    jdt, pdt = FORMATS[setting]
    ja = JAggregator.schedule_hybrid(gj, val=val, tile_dtype=jdt, **kw)
    pa = Aggregator.schedule_hybrid(gp, val=val, tile_dtype=pdt, device="cpu", **kw)
    assert pa.tile.format == ("float32" if setting == "f32" else "bfloat16")
    h = normal_features(gp.num_nodes, 12, seed=3)
    w = np.cos(np.arange(gp.num_nodes * 12, dtype=np.float32)).reshape(-1, 12)

    def jloss(x):
        return jnp.sum(ja.run(x, strategy="xla") * jnp.asarray(w))

    want = ja.run(jnp.asarray(h), strategy="xla")
    want_grad = jax.grad(jloss)(jnp.asarray(h))
    x = torch.from_numpy(h).requires_grad_(True)
    got = pa.run(x)
    (got * torch.from_numpy(w)).sum().backward()
    tiles = np.zeros((gp.num_nodes, gp.n_src))
    np.add.at(tiles, (gp.dst_per_edge, gp.indices), val)
    if setting == "bf16":  # the oracle of the stored (rounded) tile values
        cells = pa.tile.counts().double().numpy()
        dense = np.zeros((pa.tile.num_row_tiles * 64, pa.tile.num_col_tiles * 64))
        for t in range(pa.tile.num_tiles):
            r, c = int(pa.tile.tile_row[t]), int(pa.tile.tile_col[t])
            dense[r * 64 : r * 64 + 64, c * 64 : c * 64 + 64] += cells[t]
        res = np.zeros_like(tiles)
        rg = pa.plan
        cnt = rg.count.numpy()
        valid = np.arange(rg.num_tasks_padded * 4) % 4 < np.repeat(cnt, 4)
        np.add.at(res, (np.repeat(rg.dst.numpy(), 4)[valid], rg.src.numpy().reshape(-1)[valid]),
                  rg.val.numpy().reshape(-1)[valid])
        tiles = dense[: gp.num_nodes, : gp.n_src] + res
    assert_matches_jax(got.detach().numpy(), jax.device_get(want), tiles @ h, what=f"{setting} hybrid")
    assert_matches_jax(x.grad.numpy(), jax.device_get(want_grad), tiles.T @ w, what=f"{setting} hybrid grad")
    assert cuda_bcsr.launches == 0


@pytest.mark.parametrize("bits", [False, True])
def test_tileplan_with_values_chain(bits):
    """SDDMM cells -> tileplan_with_values -> weighted SpMM (B6 -> B1 over
    float32 tiles) equals the JAX chain and the dense (S * A) @ h oracle,
    over an int8 plan and a 1-bit part (unpacked, bits=False)."""
    gj, gp = _graphs(n=600, m=18000, seed=4)
    tj, _ = j_tiles.densify(gj, dtype=np.int8, **KW)
    tp, _ = densify(gp, dtype=np.int8, **KW)
    if bits:
        tj, _ = j_tiles.split_bit_tiles(tj)
        tp, _ = split_bit_tiles(tp)
    tp = tp.to("cpu")
    a = normal_features(gp.num_nodes, 8, seed=3) * 0.1
    b = normal_features(gp.num_nodes, 8, seed=4) * 0.1
    h = normal_features(gp.num_nodes, 8, seed=5)
    jcells = j_sddmm_bcsr(tj, jnp.asarray(a), jnp.asarray(b), strategy="xla", out_dtype=jnp.float32)
    cells = sddmm_bcsr(tp, torch.from_numpy(a), torch.from_numpy(b), out_dtype=torch.float32)
    wj = j_tileplan_with_values(tj, jcells)
    wp = tileplan_with_values(tp, cells)
    assert not wp.bits and wp.format == "float32" and tuple(wp.a.shape) == (tp.num_tiles, 64, 64)
    assert_matches_jax(wp.a.numpy(), np.asarray(wj.a), what="weighted tiles")
    got = bcsr_spmm(wp, torch.from_numpy(h))
    want = j_bcsr_spmm(wj, jnp.asarray(h), strategy="xla")
    cnt = np.zeros((gp.num_nodes, gp.n_src))
    counts = tp.counts().double().numpy()
    for t in range(tp.num_tiles):
        r, c = int(tp.tile_row[t]), int(tp.tile_col[t])
        cnt[r * 64 : min(r * 64 + 64, gp.num_nodes), c * 64 : min(c * 64 + 64, gp.n_src)] += counts[t][
            : min(64, gp.num_nodes - r * 64), : min(64, gp.n_src - c * 64)
        ]
    s = b.astype(np.float64) @ a.astype(np.float64).T
    assert_matches_jax(got.numpy(), jax.device_get(want), (cnt * s) @ h, what="updateval spmm")


def _gcn_setting(tile_dtype_j, tile_dtype_p, weighted):
    gj, gp = _graphs(n=480, m=9000, seed=29)
    kw = dict(KW, threshold=4, residual_block=4, pack=1)
    if weighted:
        kw["val"] = gp.gcn_norm_val()
    ja = JAggregator.schedule_hybrid(gj, tile_dtype=tile_dtype_j, with_transpose=False, **kw)
    pa = Aggregator.schedule_hybrid(gp, tile_dtype=tile_dtype_p, with_transpose=False, device="cpu", **kw)
    return gp, ja, pa


@pytest.mark.parametrize("setting", ["weighted_f32", "bf16_counts", "aggregate_first"])
def test_gcn_forward_float_tiles_match_jax(setting):
    """The 3-layer GCN forward with fast_layer_opts over float32 tiles of the
    GCN-normalized graph (the slice's path 1), over bfloat16 count tiles
    (bench.py --tile-dtype bf16), and with aggregate_first on every layer,
    against the JAX package and a float64 dense oracle."""
    dims = (48, 32, 16, 8)
    weighted = setting != "bf16_counts"
    gp, ja, pa = _gcn_setting(
        jnp.bfloat16 if setting == "bf16_counts" else None,
        torch.bfloat16 if setting == "bf16_counts" else None,
        weighted,
    )
    weights = glorot_weights(dims, seed=0)
    h = normal_features(gp.num_nodes, dims[0], seed=123) * 0.1
    if setting == "aggregate_first":
        jopts = [JLayerOpts(aggregate_first=True) for _ in dims[1:]]
        opts = [LayerOpts(aggregate_first=True) for _ in dims[1:]]
    else:
        jopts, opts = j_fast_layer_opts(dims), fast_layer_opts(dims)
    want = j_gcn_forward_bench(ja, [jnp.asarray(w) for w in weights], jnp.asarray(h), strategy="xla",
                               layer_opts=jopts)
    model = gcn_params_from_jax(weights, device="cpu")
    with torch.no_grad():
        got = model(pa, torch.from_numpy(h), opts)
        same = gcn_forward_bench(pa, list(model.weights), torch.from_numpy(h), opts)
    assert torch.equal(got, same)
    adj = np.zeros((gp.num_nodes, gp.n_src))
    np.add.at(adj, (gp.dst_per_edge, gp.indices), gp.gcn_norm_val() if weighted else 1.0)
    ref = h.astype(np.float64)
    for w in weights:
        ref = np.maximum(adj @ (ref @ w.astype(np.float64)), 0.0)
    if setting == "bf16_counts":
        # bfloat16 holds the counts exactly: the forward equals the int8 one
        # bit for bit, whose 'split' mode misses the unrounded oracle at a
        # cancellation point here, in the JAX package too
        _, _, pi = _gcn_setting(np.int8, np.int8, False)
        with torch.no_grad():
            assert torch.equal(got, model(pi, torch.from_numpy(h), opts))
        ref = None
    assert_matches_jax(got.numpy(), jax.device_get(want), ref, what=f"gcn {setting}")
    if setting == "aggregate_first":
        with torch.no_grad():
            first = model(pa, torch.from_numpy(h))
        assert np.abs(got.numpy() - first.numpy()).max() <= 1e-5 * np.abs(first.numpy()).max()
    assert cuda_bcsr.launches == 0
