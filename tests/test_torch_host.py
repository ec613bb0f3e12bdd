"""Host layer of the PyTorch port against the JAX package: the same numpy
inputs must give EQUAL arrays (CSR, reorder, neighbor-grouping plans, int8
tiles, run padding) — these are integer/bookkeeping outputs, so no
tolerance applies."""

import jax  # noqa: F401  (conftest pins it to the CPU)
import numpy as np
import pytest

from gnn_computing_tpu.graph.csr import CSRGraph as JCSR
from gnn_computing_tpu.graph.reorder import degree_sort as j_degree_sort
from gnn_computing_tpu.graph.synthetic import normal_features as j_normal_features
from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat_graph
from gnn_computing_tpu.schedule import Schedule, make_plan
from gnn_computing_tpu.schedule.tiles import densify as j_densify

from gnn_computing_tpu_torch.graph import CSRGraph, degree_sort, normal_features, rmat_graph
from gnn_computing_tpu_torch.schedule.neighbor_grouping import neighbor_grouping_plan
from gnn_computing_tpu_torch.schedule.tiles import densify, run_offsets


def _graphs(n, m, seed):
    return (
        j_rmat_graph(n, m, seed=seed, with_val=True, device="cpu"),
        rmat_graph(n, m, seed=seed, with_val=True),
    )


def _same_csr(gj, gp):
    assert np.array_equal(gj.indptr, gp.indptr)
    assert np.array_equal(gj.indices, gp.indices)
    assert (gj.val is None) == (gp.val is None)
    if gj.val is not None:
        assert np.array_equal(gj.val, gp.val)
    assert gj.n_src == gp.n_src


@pytest.mark.parametrize("n,m,seed", [(300, 4000, 1), (1000, 30000, 7)])
def test_csr_and_degree_sort_equal(n, m, seed):
    gj, gp = _graphs(n, m, seed)
    _same_csr(gj, gp)
    assert np.array_equal(gj.degrees, gp.degrees)
    assert np.array_equal(gj.dst_per_edge, gp.dst_per_edge)
    perm_j, perm_p = j_degree_sort(gj), degree_sort(gp)
    assert np.array_equal(perm_j, perm_p)
    _same_csr(gj.reorder(perm_j), gp.reorder(perm_p))


def test_from_edges_and_features_equal():
    rng = np.random.default_rng(3)
    dst = rng.integers(0, 50, 400)
    src = rng.integers(0, 60, 400)
    val = rng.standard_normal(400).astype(np.float32)
    _same_csr(
        JCSR.from_edges(dst, src, 50, val=val, n_src=60),
        CSRGraph.from_edges(dst, src, 50, val=val, n_src=60),
    )
    assert np.array_equal(j_normal_features(77, 9, seed=4), normal_features(77, 9, seed=4))


@pytest.mark.parametrize("block", [1, 4, 8])
def test_neighbor_grouping_plan_equal(block):
    gj, gp = _graphs(400, 6000, 11)
    pj = make_plan(gj, Schedule.neighbor_grouping, block_size=block)
    pp = neighbor_grouping_plan(gp, block_size=block)
    for k in ("src", "count", "dst", "val"):
        assert np.array_equal(getattr(pj, k), getattr(pp, k)), k
    for k in ("num_tasks", "num_tasks_padded", "num_edges", "num_nodes", "n_src", "partition_starts"):
        assert getattr(pj, k) == getattr(pp, k), k


def _compare_densify(gj, gp, pack, **kw):
    tj, rj = j_densify(gj, dtype=np.int8, **kw)
    tp, rp = densify(gp, dtype=np.int8, **kw)
    tj, tp = tj.pad_runs(pack), tp.pad_runs(pack)
    for k in ("a", "tile_col", "tile_row"):
        got, want = getattr(tp, k), np.asarray(getattr(tj, k))
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    for k in ("num_tiles", "num_dense_edges", "num_nodes", "n_src"):
        assert getattr(tj, k) == getattr(tp, k), k
    assert np.array_equal(tp.run_start, run_offsets(np.asarray(tj.tile_row), tp.num_row_tiles))
    _same_csr(rj, rp)
    for k in ("src", "count", "dst", "val"):
        pj = make_plan(rj, Schedule.neighbor_grouping, block_size=4)
        assert np.array_equal(getattr(pj, k), getattr(neighbor_grouping_plan(rp, block_size=4), k)), k
    return tp


@pytest.mark.parametrize("pack", [1, 4, 16])
@pytest.mark.parametrize("tr,tc,thr", [(64, 64, 6), (128, 32, 4), (48, 40, 3)])
def test_densify_pad_runs_equal(pack, tr, tc, thr):
    gj = j_rmat_graph(700, 20000, seed=5, with_val=False, device="cpu")
    gp = rmat_graph(700, 20000, seed=5, with_val=False)
    gj, gp = gj.reorder(j_degree_sort(gj)), gp.reorder(degree_sort(gp))
    tp = _compare_densify(gj, gp, pack, tile_rows=tr, tile_cols=tc, threshold=thr)
    assert np.all(np.diff(tp.run_start) % pack == 0)


def test_densify_spill_past_int8_cap():
    """A multigraph cell with 300 duplicates: the first 127 in edge order
    stay in the tile, the other 173 go to the residual, in both packages."""
    rng = np.random.default_rng(9)
    dst = np.concatenate([np.full(300, 5), rng.integers(0, 200, 3000), np.full(130, 70)])
    src = np.concatenate([np.full(300, 17), rng.integers(0, 200, 3000), np.full(130, 3)])
    perm = rng.permutation(len(dst))
    dst, src = dst[perm], src[perm]
    gj = JCSR.from_edges(dst, src, 200)
    gp = CSRGraph.from_edges(dst, src, 200)
    tp = _compare_densify(gj, gp, 1, tile_rows=32, tile_cols=32, threshold=8)
    assert tp.a.max() == 127


def test_densify_row_tile_without_tiles():
    """Rows 64..127 only have scattered edges: their row-tile gets one
    all-zero filler tile (a run made only of filler after pad_runs)."""
    rng = np.random.default_rng(2)
    dense_dst = rng.integers(0, 64, 4000)
    dense_src = rng.integers(0, 64, 4000)
    sparse_dst = rng.integers(64, 128, 40)
    sparse_src = rng.integers(0, 300, 40)
    dst = np.concatenate([dense_dst, sparse_dst, rng.integers(128, 300, 3000)])
    src = np.concatenate([dense_src, sparse_src, rng.integers(128, 300, 3000)])
    gj, gp = JCSR.from_edges(dst, src, 300), CSRGraph.from_edges(dst, src, 300)
    for pack in (1, 4):
        tp = _compare_densify(gj, gp, pack, tile_rows=64, tile_cols=64, threshold=20)
        run = slice(tp.run_start[1], tp.run_start[2])
        assert tp.run_start[2] > tp.run_start[1]
        assert not tp.a[run].any()
