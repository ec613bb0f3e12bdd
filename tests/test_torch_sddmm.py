"""SDDMM of the PyTorch port against the JAX package: the tile SDDMM's plain
version (the counterpart of ``sddmm_bcsr_xla``, which the JAX package runs
on the CPU) over int8 and 1-bit tiles, the hybrid SDDMM with its residual
slot gather, the gather-only ``sddmm``, and bench.py's SDDMM configuration
as a whole; every edge's value against the float64 oracle ``sddmm_dense``.

Tolerance.  float32 outputs: the ops/validate gate (|y - ref| <=
1e-2*|ref| + 1e-5) against the float64 oracle, and max|port - jax| <= 1e-5 *
max|jax| (float32 summation order only).  bfloat16 cells: at most one
bfloat16 ulp from JAX's (two float32 dots that differ in their last bits
may round to neighbouring bfloat16 values).  Cells without an edge are
exactly +0 in both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_computing_tpu.aggregator import Aggregator as JAggregator
from gnn_computing_tpu.graph.reorder import degree_sort as j_degree_sort
from gnn_computing_tpu.graph.synthetic import normal_features as j_normal_features
from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat_graph
from gnn_computing_tpu.ops.bcsr_sddmm import hybrid_sddmm as j_hybrid_sddmm
from gnn_computing_tpu.ops.bcsr_sddmm import sddmm_bcsr as j_sddmm_bcsr
from gnn_computing_tpu.ops.reference import sddmm_dense as j_sddmm_dense
from gnn_computing_tpu.ops.sddmm import sddmm as j_sddmm
from gnn_computing_tpu.schedule import Schedule, make_plan
from gnn_computing_tpu.schedule import tiles as j_tiles

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.graph import degree_sort, normal_features, rmat_graph
from gnn_computing_tpu_torch.ops import cuda_sddmm
from gnn_computing_tpu_torch.ops.bcsr_sddmm import hybrid_sddmm, sddmm_bcsr, sddmm_bcsr_plain
from gnn_computing_tpu_torch.ops.reference import sddmm_dense
from gnn_computing_tpu_torch.ops.sddmm import sddmm
from gnn_computing_tpu_torch.ops.spmm import edge_values_from_slots_flat
from gnn_computing_tpu_torch.ops.validate import assert_valid
from gnn_computing_tpu_torch.schedule.neighbor_grouping import neighbor_grouping_plan
from gnn_computing_tpu_torch.schedule.tiles import densify, split_bit_tiles

# bench.py --model sddmm (strategy hybrid): [256, 128] tiles at t24, 1-bit
# tiles on, 4-slot residual, f = 32, split23 tile dots, f16_split2 residual
BENCH = dict(tile_rows=256, tile_cols=128, threshold=24, residual_block=4, bit_tiles=True)


def _graphs(n=1024, m=40000, seed=17):
    gj = j_rmat_graph(n, m, seed=seed, with_val=False, device="cpu")
    gp = rmat_graph(n, m, seed=seed, with_val=False)
    return gj.reorder(j_degree_sort(gj)), gp.reorder(degree_sort(gp))


def _inputs(n, f, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, f)) * 0.1).astype(np.float32), (rng.standard_normal((n, f)) * 0.1).astype(np.float32)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


def _cells_match(port: torch.Tensor, jax_out, counts: np.ndarray, what: str):
    """Port cells against JAX's at the tolerance of their dtype; cells with
    count 0 are +0 in both."""
    j = np.asarray(jnp.asarray(jax_out, jnp.float32))
    p = port.float().numpy()
    assert p.shape == j.shape
    zero = counts == 0
    assert not np.signbit(p[zero]).any() and (p[zero] == 0).all(), what
    assert (j[zero] == 0).all(), what
    if port.dtype == torch.bfloat16:
        assert (np.abs(p - j) <= _bf16_ulp(np.maximum(np.abs(p), np.abs(j)))).all(), what
    else:
        assert np.abs(p - j).max() <= 1e-5 * np.abs(j).max(), what


def _cell_oracle(tp, counts, a, b):
    """f64 <b[row], a[col]> at every cell with count > 0 (0 elsewhere)."""
    t, i, j = np.nonzero(counts)
    rows = np.asarray(tp.tile_row)[t].astype(np.int64) * tp.tile_rows + i
    cols = np.asarray(tp.tile_col)[t].astype(np.int64) * tp.tile_cols + j
    ref = np.zeros(counts.shape)
    ref[t, i, j] = np.einsum("ef,ef->e", b.astype(np.float64)[rows], a.astype(np.float64)[cols])
    return ref


@pytest.mark.parametrize("tr", [16, 256])
@pytest.mark.parametrize("f", [16, 32])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_tile_sddmm_matches_jax(tr, f, out):
    gj, gp = _graphs()
    kw = dict(tile_rows=tr, tile_cols=128, threshold=24 if tr == 256 else 3)
    tj, _ = j_tiles.densify(gj, dtype=np.int8, **kw)
    tp, _ = densify(gp, dtype=np.int8, **kw)
    a, b = _inputs(gp.num_nodes, f)
    jb, ji = j_tiles.split_bit_tiles(tj)
    pb, pi = split_bit_tiles(tp)
    assert pb is not None and pi is not None
    for jp, pp, label in ((tj, tp, "int8"), (jb, pb, "bit part"), (ji, pi, "int8 part")):
        want = j_sddmm_bcsr(jp.device_put(), jnp.asarray(a), jnp.asarray(b), strategy="xla", out_dtype=getattr(jnp, out))
        pp = pp.to("cpu")
        got = sddmm_bcsr(pp, torch.from_numpy(a), torch.from_numpy(b), out_dtype=getattr(torch, out))
        assert got.dtype == getattr(torch, out) and got.shape == (pp.num_tiles, tr, 128)
        assert torch.equal(got, sddmm_bcsr_plain(pp, torch.from_numpy(a), torch.from_numpy(b), getattr(torch, out)))
        counts = pp.counts().numpy()
        _cells_match(got, want, counts, f"{label} r{tr} f{f} {out}")
        if out == "float32":
            ref = _cell_oracle(pp, counts, a, b)
            assert_valid(got.numpy(), ref, what=f"{label} r{tr} f{f} vs f64 oracle")
    assert cuda_sddmm.launches == 0


def _schedules(gj, gp, pack=1):
    ja = JAggregator.schedule_hybrid(gj, tile_dtype=np.int8, with_transpose=False, pack=pack, **BENCH)
    pa = Aggregator.schedule_hybrid(gp, tile_dtype=np.int8, with_transpose=False, pack=pack, device="cpu", **BENCH)
    return ja, pa


@pytest.mark.parametrize("gather_dtype", [None, "f16_split2"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_hybrid_sddmm_matches_jax(gather_dtype, out):
    gj, gp = _graphs()
    ja, pa = _schedules(gj, gp, pack=4)
    a, b = _inputs(gp.num_nodes, 32)
    jc, jr = j_hybrid_sddmm(
        ja.tile_parts(), ja.plan, jnp.asarray(a), jnp.asarray(b), gather_dtype=gather_dtype,
        out_dtype=getattr(jnp, out), dot_mode="split23",
    )
    pc, pr = hybrid_sddmm(
        pa.tile_parts(), pa.plan, torch.from_numpy(a), torch.from_numpy(b), gather_dtype=gather_dtype,
        out_dtype=getattr(torch, out), dot_mode="split23",
    )
    assert len(pc) == len(jc) == 2
    for got, want, p in zip(pc, jc, pa.tile_parts()):
        _cells_match(got, want, p.counts().numpy(), f"bits={p.bits} {out}")
    jr = np.asarray(jr).reshape(-1)
    assert pr.shape == jr.shape and pr.dtype == torch.float32
    assert np.abs(pr.numpy() - jr).max() <= 1e-5 * np.abs(jr).max()


@pytest.mark.parametrize("gather_dtype", [None, "f16_split2"])
@pytest.mark.parametrize("block", [4, 8])
def test_sddmm_matches_jax(gather_dtype, block):
    gj, gp = _graphs(n=600, m=12000, seed=5)
    a, b = _inputs(gp.num_nodes, 24, seed=4)
    jplan = make_plan(gj, Schedule.neighbor_grouping, block_size=block).device_put()
    plan = neighbor_grouping_plan(gp, block_size=block).to("cpu")
    ref = sddmm_dense(gp, a, b)
    assert np.array_equal(ref, j_sddmm_dense(gj, a, b))
    for output in ("edges", "slots"):
        want = np.asarray(j_sddmm(jplan, jnp.asarray(a), jnp.asarray(b), output=output, gather_dtype=gather_dtype))
        got = sddmm(plan, torch.from_numpy(a), torch.from_numpy(b), output=output, gather_dtype=gather_dtype)
        want = want.reshape(-1)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    edges = sddmm(plan, torch.from_numpy(a), torch.from_numpy(b), gather_dtype=gather_dtype).numpy()
    assert edges.shape == (gp.num_edges,)
    assert_valid(edges, ref, what=f"sddmm {gather_dtype} vs f64 oracle")
    with pytest.raises(ValueError):
        sddmm(plan, torch.from_numpy(a), torch.from_numpy(b), output="tiles")
    with pytest.raises(ValueError):  # no gather mode in the JAX package either
        sddmm(plan, torch.from_numpy(a), torch.from_numpy(b), gather_dtype="bf16")


def _edge_values(pa, cells, gp):
    """Every edge's value in CSR order, from its tile cell or, where the
    edge lies in no tile or spilled past the int8 cap, from the residual;
    and the number of edges that took it from a cell."""
    dst = gp.dst_per_edge.astype(np.int64)
    src = gp.indices.astype(np.int64)
    vals = np.full(gp.num_edges, np.nan)
    from_cells = np.zeros(gp.num_edges, bool)
    for p, c in zip(pa.tile_parts(), cells):
        cnt = p.counts().numpy()
        tile = np.full((p.num_row_tiles, p.num_col_tiles), -1)
        real = cnt.reshape(p.num_tiles, -1).any(axis=1)  # not a filler
        tile[p.tile_row.numpy()[real], p.tile_col.numpy()[real]] = np.flatnonzero(real)
        t = tile[dst // p.tile_rows, src // p.tile_cols]
        hit = t >= 0
        i, j = dst[hit] % p.tile_rows, src[hit] % p.tile_cols
        assert (cnt[t[hit], i, j] > 0).all()
        vals[hit] = c.float().numpy()[t[hit], i, j]
        from_cells |= hit
    return vals, from_cells


def test_bench_sddmm_configuration_matches_jax_and_oracle():
    """The slice as a whole: bench.py's SDDMM path (split23 tile dots, a
    f16_split2 residual, bfloat16 cells) on a small degree-sorted RMAT graph,
    port against JAX and both against sddmm_dense; every edge is covered
    once: tile cells hold the counts of the dense edges, the residual the
    rest."""
    gj, gp = _graphs(n=2048, m=65536, seed=123)
    ja, pa = _schedules(gj, gp)
    a = j_normal_features(gp.num_nodes, 32, seed=3) * np.float32(0.1)
    b = j_normal_features(gp.num_nodes, 32, seed=4) * np.float32(0.1)
    assert np.array_equal(a, normal_features(gp.num_nodes, 32, seed=3) * np.float32(0.1))
    jc, jr = j_hybrid_sddmm(ja.tile_parts(), ja.plan, jnp.asarray(a), jnp.asarray(b), gather_dtype="f16_split2",
                            dot_mode="split23")
    with torch.no_grad():
        pc, pr = hybrid_sddmm(pa.tile_parts(), pa.plan, torch.from_numpy(a), torch.from_numpy(b),
                              gather_dtype="f16_split2", dot_mode="split23")
    assert [c.dtype for c in pc] == [torch.bfloat16] * 2
    for got, want, p in zip(pc, jc, pa.tile_parts()):
        _cells_match(got, want, p.counts().numpy(), f"bits={p.bits}")
    jr = np.asarray(jr).reshape(-1)
    assert np.abs(pr.numpy() - jr).max() <= 1e-5 * np.abs(jr).max()

    ref = sddmm_dense(gp, a, b)
    vals, from_cells = _edge_values(pa, pc, gp)
    assert_valid(vals[from_cells], ref[from_cells], what="dense edges vs f64 oracle")
    # the residual: its own edges, from the plan's slots in CSR order of the
    # residual graph, against the oracle over that graph
    _, res_graph = densify(gp, dtype=np.int8, tile_rows=256, tile_cols=128, threshold=24)
    res_vals = edge_values_from_slots_flat(pa.plan, pr).numpy()
    assert_valid(res_vals, sddmm_dense(res_graph, a, b), what="residual edges vs f64 oracle")
    dense_edges = sum(p.num_dense_edges for p in pa.tile_parts())
    assert sum(int(p.counts().sum()) for p in pa.tile_parts()) == dense_edges
    assert dense_edges + pa.plan.num_edges == gp.num_edges
    # an edge outside every tile is a residual edge; the edges of a tile that
    # are not in its counts spilled past the int8 cap
    assert (~from_cells).sum() <= pa.plan.num_edges
    assert from_cells.sum() - dense_edges == pa.plan.num_edges - (~from_cells).sum()


def test_forward_only_raises_on_grad():
    gj, gp = _graphs(n=600, m=12000, seed=5)
    pa = Aggregator.schedule_hybrid(gp, tile_dtype=np.int8, with_transpose=False, pack=1, device="cpu", **dict(BENCH, tile_rows=64, tile_cols=64, threshold=4))
    a, b = (torch.from_numpy(x) for x in _inputs(gp.num_nodes, 8))
    a.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        hybrid_sddmm(pa.tile_parts(), pa.plan, a, b)
    with pytest.raises(RuntimeError, match="forward-only"):
        sddmm_bcsr(pa.tile, a, b)
    with torch.no_grad():
        cells, res = hybrid_sddmm(pa.tile_parts(), pa.plan, a, b)
    assert len(cells) == 2 and res is not None
    with pytest.raises(ValueError):
        sddmm_bcsr(pa.tile, a.detach(), b, dot_mode="split2")
    # split33 at 4f > 128 is computed as exact, as the JAX package demotes it
    wide = torch.rand(gp.num_nodes, 40)
    assert torch.equal(sddmm_bcsr(pa.tile, wide, wide, dot_mode="split33"), sddmm_bcsr(pa.tile, wide, wide))
    with pytest.raises(ValueError):
        cuda_sddmm.sddmm_bcsr_cuda(pa.tile, wide, wide)
