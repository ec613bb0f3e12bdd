"""The port's reorders (``graph/reorder.py``) and the native tile fill of its
``densify`` against the JAX package on the same graphs.  Everything here is
integers or float32 sums in edge order, so every comparison is array
equality: a permutation equal to the JAX package's (and a bijection), and
plans equal array for array."""

import numpy as np
import pytest

from gnn_computing_tpu.graph import reorder as j_reorder
from gnn_computing_tpu.graph.csr import CSRGraph as JCSRGraph
from gnn_computing_tpu.graph.synthetic import community_graph as j_community
from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat
from gnn_computing_tpu.schedule.tiles import densify as j_densify

from gnn_computing_tpu_torch import native
from gnn_computing_tpu_torch.graph import reorder
from gnn_computing_tpu_torch.graph.csr import CSRGraph
from gnn_computing_tpu_torch.schedule import tiles
from gnn_computing_tpu_torch.schedule.tiles import densify

from test_torch_spmm import jax_native_from_port  # noqa: F401


def _isolated():
    """2,000 vertices: rows 0-399 have no in-edge and sources 1,600-1,999 no
    out-edge; duplicate edges allowed."""
    rng = np.random.default_rng(3)
    dst = rng.integers(400, 2000, 16000)
    src = rng.integers(0, 1600, 16000)
    return JCSRGraph.from_edges(dst, src.astype(np.int32), 2000)


GRAPHS = {
    "rmat": lambda: j_rmat(2000, 20000, seed=5, with_val=False),
    "community": lambda: j_community(2000, 20000, seed=5, with_val=False),
    "isolated": _isolated,
}


def both(kind):
    gj = GRAPHS[kind]()
    return gj, CSRGraph(gj.indptr, gj.indices, n_src=gj.n_src)


def assert_same_perm(got, want, n):
    want = np.asarray(want)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(np.sort(got), np.arange(n))


CASES = [
    ("degree_sort", {}),
    ("degree_sort", {"by": "in"}),
    ("degree_sort", {"by": "out"}),
    ("cluster_reorder", {}),
    ("cluster_reorder", {"threshold": 0.5, "max_cluster": 8, "bands": 8}),
    ("cluster_reorder_exact", {}),
    ("cluster_reorder_exact", {"max_cluster": 8, "num_perm": 32, "seed": 7}),
    ("label_propagation_reorder", {}),
    ("label_propagation_reorder", {"hubs": 64}),
    ("label_propagation_reorder", {"hubs": 300, "iters": 2}),
    ("label_propagation_reorder", {"self_weight": 0}),
    ("label_propagation_reorder", {"self_weight": 1, "degree_sort_within": False}),
    ("label_propagation_reorder", {"self_weight": 0, "degree_sort_within": False, "hubs": 16}),
]


@pytest.mark.parametrize("kind", sorted(GRAPHS))
@pytest.mark.parametrize("fn,kw", CASES, ids=[f"{f}-{'-'.join(f'{k}{v}' for k, v in kw.items()) or 'default'}" for f, kw in CASES])
def test_reorder_equals_jax(kind, fn, kw):
    gj, gp = both(kind)
    assert_same_perm(getattr(reorder, fn)(gp, **kw), getattr(j_reorder, fn)(gj, **kw), gp.num_nodes)


@pytest.mark.parametrize("num_shards", [1, 3, 7, 8, 2001])
def test_deal_shards_equals_jax(num_shards):
    """n = 2,000 is not a multiple of 3, 7 or 2,001."""
    gj, gp = both("rmat")
    perm = reorder.degree_sort(gp)
    got = reorder.deal_shards(perm, num_shards)
    assert_same_perm(got, j_reorder.deal_shards(perm, num_shards), gp.num_nodes)
    # each shard keeps the degree order: shard s holds ranks s, s + D, ...
    if num_shards == 3:
        assert np.array_equal(got[: -(-2000 // 3)], perm[0::3])


@pytest.mark.parametrize("kind", ["rmat", "community"])
@pytest.mark.parametrize("num_perm,bands", [(64, 16), (32, 8), (20, 3)])
def test_minhash_signatures_and_band_pairs_equal_jax(kind, num_perm, bands):
    """The int64 hash wraps by design; numpy's % keeps the divisor's sign.
    bands = 3 leaves a tail of the signature outside every band."""
    gj, gp = both(kind)
    sig = reorder._minhash_signatures(gp, num_perm, 123)
    want = j_reorder._minhash_signatures(gj, num_perm, 123)
    assert sig.dtype == want.dtype and np.array_equal(sig, want)
    pairs = reorder._banding_candidate_pairs(sig, bands)
    want_pairs = j_reorder._banding_candidate_pairs(want, bands)
    assert np.array_equal(pairs, want_pairs) and len(pairs)
    assert (pairs[:, 0] < pairs[:, 1]).all()


def test_signature_of_a_row_without_neighbors_is_the_sentinel():
    gj, gp = both("isolated")
    sig = reorder._minhash_signatures(gp, 16, 123)
    assert (sig[:400] == np.iinfo(np.int64).max).all() and (sig[400:] < (1 << 61) - 1).all()


def test_emit_clusters_first_seen_equals_jax():
    root = np.random.default_rng(0).integers(0, 50, 700)
    assert_same_perm(reorder._emit_clusters_first_seen(root), j_reorder._emit_clusters_first_seen(root), 700)


def test_empty_graph():
    gj = JCSRGraph(np.zeros(1, np.int32), np.zeros(0, np.int32))
    gp = CSRGraph(np.zeros(1, np.int32), np.zeros(0, np.int32))
    for fn in ("degree_sort", "cluster_reorder", "cluster_reorder_exact", "label_propagation_reorder"):
        got = getattr(reorder, fn)(gp)
        assert got.dtype == np.int64 and got.shape == (0,)
        assert np.array_equal(got, getattr(j_reorder, fn)(gj)), fn
    assert reorder.deal_shards(np.zeros(0, np.int64), 4).shape == (0,)


@pytest.mark.parametrize("fn", ["cluster_reorder", "cluster_reorder_exact"])
def test_no_candidate_pair_gives_the_identity(fn):
    """A ring (vertex i's one in-neighbour is i + 1): every signature differs
    in every band, so there is no candidate pair and the order stays."""
    n = 64
    src = ((np.arange(n) + 1) % n).astype(np.int32)
    gj, gp = JCSRGraph(np.arange(n + 1), src), CSRGraph(np.arange(n + 1), src)
    assert reorder._banding_candidate_pairs(reorder._minhash_signatures(gp, 64, 123), 16) is None
    assert_same_perm(getattr(reorder, fn)(gp), getattr(j_reorder, fn)(gj), n)
    assert np.array_equal(getattr(reorder, fn)(gp), np.arange(n))


def test_cluster_reorder_raises_without_the_native_library(monkeypatch):
    """The port's native entries raise where the library cannot be built;
    the reorder passes that on (the JAX module returns None there)."""
    def fail():
        raise RuntimeError("cannot build the host library")

    monkeypatch.setattr(native, "load", fail)
    _, gp = both("rmat")
    for fn in (reorder.cluster_reorder, reorder.cluster_reorder_exact):
        with pytest.raises(RuntimeError, match="host library"):
            fn(gp)


# ------------------------------------------------- densify's native tile fill
def _numpy_saturating_count_i8(flat, cap, out):
    """The fill densify had before it called the native library: rank the
    edges of a cell in edge order (stable sort), count up to ``cap``, spill
    the rest."""
    by_cell = np.argsort(flat, kind="stable")
    sc = flat[by_cell]
    new_cell = np.ones(len(sc), bool)
    new_cell[1:] = sc[1:] != sc[:-1]
    first = np.flatnonzero(new_cell)
    per_cell = np.diff(np.append(first, len(sc)))
    rank = np.arange(len(sc)) - np.repeat(first, per_cell)
    spill = np.zeros(len(flat), bool)
    spill[by_cell] = rank >= cap
    out[sc[first]] = np.minimum(per_cell, cap)
    return spill


def _numpy_scatter_add_f32(flat, val, out):
    np.add.at(out, flat, val)


def _capped_graph(weighted: bool):
    """RMAT edges plus 300 copies of (3 -> 5) and 127 of (8 -> 9): one cell
    past the int8 cap, one just at it."""
    g = j_rmat(1500, 30000, seed=9, with_val=False)
    dst = np.concatenate([g.dst_per_edge, np.full(300, 5), np.full(127, 9)])
    src = np.concatenate([g.indices, np.full(300, 3), np.full(127, 8)]).astype(np.int32)
    val = np.random.default_rng(2).uniform(0.5, 2.0, len(dst)).astype(np.float32) if weighted else None
    return JCSRGraph.from_edges(dst, src, 1500, val=val), CSRGraph.from_edges(dst, src, 1500, val=val)


@pytest.mark.parametrize("fmt", ["int8", "float32"])
@pytest.mark.parametrize("geometry", [dict(tile_rows=64, tile_cols=32, threshold=6), dict(tile_rows=256, tile_cols=128)])
def test_densify_native_fill_equals_numpy_fill_and_jax(fmt, geometry, monkeypatch):
    gj, gp = _capped_graph(weighted=fmt == "float32")
    dtype = np.int8 if fmt == "int8" else np.float32
    got_tp, got_res = densify(gp, dtype=dtype, **geometry)
    want_tp, want_res = j_densify(gj, dtype=dtype, **geometry)
    monkeypatch.setattr(native, "saturating_count_i8", _numpy_saturating_count_i8)
    monkeypatch.setattr(native, "scatter_add_f32", _numpy_scatter_add_f32)
    np_tp, np_res = densify(gp, dtype=dtype, **geometry)
    assert tiles.native is native
    for ref_tp, ref_res in ((np_tp, np_res), (want_tp, want_res)):
        for field in ("a", "tile_row", "tile_col"):
            got, want = getattr(got_tp, field), np.asarray(getattr(ref_tp, field))
            assert got.dtype == want.dtype and np.array_equal(got, want), field
        assert got_tp.num_dense_edges == ref_tp.num_dense_edges
        for field in ("indptr", "indices", "val"):
            assert np.array_equal(getattr(got_res, field), getattr(ref_res, field)), field
    if fmt == "int8":
        assert got_tp.a.max() == 127 and got_res.num_edges >= 300 - 127
