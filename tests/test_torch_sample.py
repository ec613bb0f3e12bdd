"""The port's host layer against the JAX package on the same inputs:
sampling (``graph/sample.py``), the synthetic generators
(``graph/synthetic.py``), dataset IO (``graph/io.py``) and every entry point
of the native host library (``native.py``).  Everything here is integers or
numpy streams, so every comparison is array equality."""

import os

import numpy as np
import pytest

from gnn_computing_tpu import native as j_native
from gnn_computing_tpu.graph import io as j_io
from gnn_computing_tpu.graph import sample as j_sample
from gnn_computing_tpu.graph import synthetic as j_synth
from gnn_computing_tpu.graph.csr import CSRGraph as JCSRGraph

from gnn_computing_tpu_torch import native
from gnn_computing_tpu_torch.graph import io, sample, synthetic
from gnn_computing_tpu_torch.graph.csr import CSRGraph


def mixed_edges(n=300, k=8, seed=0):
    """(dst, src) over n vertices: rows 0-39 isolated, rows 40-139 of
    degree 1..k-1, the rest of degree k..3k; duplicate edges allowed."""
    rng = np.random.default_rng(seed)
    deg = np.zeros(n, np.int64)
    deg[40:140] = rng.integers(1, k, 100)
    deg[140:] = rng.integers(k, 3 * k + 1, n - 140)
    dst = np.repeat(np.arange(n), deg)
    src = rng.integers(0, n, len(dst))
    perm = rng.permutation(len(dst))  # from_edges must sort them back
    return dst[perm], src[perm], n


def both(dst, src, n):
    return JCSRGraph.from_edges(dst, src.astype(np.int32), n), CSRGraph.from_edges(dst, src.astype(np.int32), n)


def assert_graphs_equal(got, want):
    for field in ("indptr", "indices"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype and np.array_equal(g, w), field
    assert (got.val is None) == (want.val is None)
    if got.val is not None:
        assert np.array_equal(got.val, want.val)
    assert got.n_src == want.n_src


# ------------------------------------------------------------------ sampling
def test_jax_side_takes_the_library_path():
    assert j_native.available() and native.available()


def test_full_graph_equals_jax():
    gj, gp = both(*mixed_edges())
    got, want = sample.full_graph(gp), j_sample.full_graph(gj)
    assert np.array_equal(got.vertices, want.vertices) and got.vertices.dtype == want.vertices.dtype
    assert got.num_v == want.num_v and got.num_e == want.num_e
    assert_graphs_equal(got.graph, want.graph)


@pytest.mark.parametrize("cap", [None, 4])
@pytest.mark.parametrize("hops", [0, 1, 2, 3])
@pytest.mark.parametrize("seed", [123, 7])
def test_sample_vertex_equals_jax(cap, hops, seed):
    """k-hop expansion and compaction; with a cap the library's reservoir
    picks the sources, and the port's from_edges keeps their order."""
    gj, gp = both(*mixed_edges(seed=1))
    seeds = np.array([0, 45, 150, 151, 299, 150])
    if cap is None:
        got, want = sample.sample_vertex(gp, seeds, hops, seed), j_sample.sample_vertex(gj, seeds, hops, seed)
    else:
        got = sample.sample_vertex_sample_neighbor(gp, seeds, hops, cap, seed)
        want = j_sample.sample_vertex_sample_neighbor(gj, seeds, hops, cap, seed)
        assert got.graph.max_degree() <= cap
    assert got.vertices.dtype == np.int32 and np.array_equal(got.vertices, want.vertices)
    assert_graphs_equal(got.graph, want.graph)
    if hops:
        assert got.num_v > len(set(seeds.tolist()))


def test_sample_neighbor_cap_keeps_reservoir_order():
    """A capped row is the reservoir's pick in the reservoir's order (not
    sorted), as the JAX package returns it; different seeds pick
    differently."""
    gj, gp = both(*mixed_edges(n=200, k=16, seed=2))
    seeds = np.arange(140, 200)
    a = sample.sample_vertex_sample_neighbor(gp, seeds, 1, 4, seed=3)
    b = sample.sample_vertex_sample_neighbor(gp, seeds, 1, 4, seed=4)
    assert_graphs_equal(a.graph, j_sample.sample_vertex_sample_neighbor(gj, seeds, 1, 4, seed=3).graph)
    assert not np.array_equal(a.graph.indices, b.graph.indices)
    rows = np.split(a.graph.indices, a.graph.indptr[1:-1])
    assert any(np.any(np.diff(r) < 0) for r in rows)


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("seed", [2, 5])
def test_presample_fixed_neighbors_equals_jax(k, seed):
    """All three branches: isolated rows (self-loops), 0 < deg < k (with
    replacement) and deg >= k (without replacement)."""
    gj, gp = both(*mixed_edges(k=8))
    deg = gp.degrees
    assert (deg == 0).any() and ((deg > 0) & (deg < k)).any() and (deg >= k).any()
    got = sample.presample_fixed_neighbors(gp, k=k, seed=seed)
    want = j_sample.presample_fixed_neighbors(gj, k=k, seed=seed)
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    assert_graphs_equal(sample.fixed_neighbors_to_graph(got), j_sample.fixed_neighbors_to_graph(want))


# ------------------------------------------------------------------ synthetic
def test_dataset_scales_and_mix64_equal_jax():
    assert synthetic.DATASET_SCALES == j_synth.DATASET_SCALES
    rng = np.random.default_rng(0)
    a, b = rng.integers(0, 1 << 62, 1000), rng.integers(0, 1 << 20, 1000)
    got = synthetic._mix64(a, b)
    assert got.dtype == np.uint64 and np.array_equal(got, j_synth._mix64(a, b))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(with_val=False, shuffle=False),
    dict(target_skew=0.0, cross_skew=0.0, min_comm=64, max_comm=128),
    dict(min_comm=32, max_comm=64, thread_size=8, overlap=0.5),
], ids=["default", "no_val_no_shuffle", "uniform_draws", "many_communities"])
def test_community_graph_equals_jax(kw):
    got = synthetic.community_graph(500, 4001, seed=9, **kw)
    want = j_synth.community_graph(500, 4001, seed=9, **kw)
    assert_graphs_equal(got, want)
    assert got.num_edges == 4001


@pytest.mark.parametrize("with_val", [True, False])
def test_uniform_and_fixed_degree_graphs_equal_jax(with_val):
    assert_graphs_equal(synthetic.uniform_graph(300, 2500, seed=4, with_val=with_val),
                        j_synth.uniform_graph(300, 2500, seed=4, with_val=with_val))
    got = synthetic.fixed_degree_graph(300, 16, seed=6)
    assert_graphs_equal(got, j_synth.fixed_degree_graph(300, 16, seed=6))
    assert (got.degrees == 16).all()


def test_scaled_dataset_equals_jax(monkeypatch):
    """scaled_dataset through a small entry added to both tables (the real
    entries hold millions of edges)."""
    for table in (synthetic.DATASET_SCALES, j_synth.DATASET_SCALES):
        monkeypatch.setitem(table, "tiny", (400, 3000))
    assert_graphs_equal(synthetic.scaled_dataset("tiny", seed=3), j_synth.rmat_graph(400, 3000, seed=3, device="host"))
    assert_graphs_equal(synthetic.scaled_dataset("tiny", seed=3, with_val=False),
                        j_synth.scaled_dataset("tiny", seed=3, with_val=False))


# ------------------------------------------------------------------ io
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_io_round_trip_between_packages(tmp_path, writer):
    """A graph saved by one package loads in the other (text parse, then
    the .npz cache, then without the cache), with a reorder file."""
    gj, gp = both(*mixed_edges(seed=3))
    w_io, r_io = (io, j_io) if writer == "port" else (j_io, io)
    w_io.save_graph(str(tmp_path), "g", gp if writer == "port" else gj)
    rows = np.random.default_rng(0).permutation(gp.num_nodes)
    path = w_io.save_reorder(str(tmp_path), "g", ".perm", rows)
    assert os.path.basename(path) == "g.reorder.perm"
    assert io.dataset_config(str(tmp_path), "g") == j_io.dataset_config(str(tmp_path), "g") == (
        gp.num_nodes, gp.num_edges)
    for reader in (r_io, w_io):
        for use_cache in (True, True, False):  # parse and write the cache, read it, parse again
            g, none = reader.load_graph(str(tmp_path), "g", use_cache=use_cache)
            assert none is None
            assert np.array_equal(g.indptr, gp.indptr) and np.array_equal(g.indices, gp.indices)
        assert os.path.exists(tmp_path / "g.graph.npz")
        assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]
        g, got_rows = reader.load_graph(str(tmp_path), "g", reorder_subfix=".perm")
        assert np.array_equal(got_rows, rows) and got_rows.dtype == np.int64
        want = gp.reorder(rows)
        assert np.array_equal(g.indptr, want.indptr) and np.array_equal(g.indices, want.indices)
    assert io.load_reorder(str(tmp_path), "g", ".none") is None
    assert np.array_equal(io.load_reorder(str(tmp_path), "g", ".perm"), j_io.load_reorder(str(tmp_path), "g", ".perm"))


def test_io_rejects_a_short_graph_file(tmp_path):
    gp = both(*mixed_edges())[1]
    io.save_graph(str(tmp_path), "g", gp)
    with open(tmp_path / "g.config", "w") as f:
        f.write(f"{gp.num_nodes} {gp.num_edges + 1}\n")
    with pytest.raises(ValueError, match="expected"):
        io.load_graph(str(tmp_path), "g", use_cache=False)


# ------------------------------------------------------------------ native
def _native_case(name, mod, tmp_path):
    rng = np.random.default_rng(11)
    dst, src, n = mixed_edges(n=200, seed=4)
    g = CSRGraph.from_edges(dst, src.astype(np.int32), n)
    if name == "parse_ints":
        path = tmp_path / "ints.txt"
        path.write_text("3 -4\n\n 17\t5 0 123456789012\n-1")
        return mod.parse_ints(str(path))
    if name == "ng_schedule":
        return mod.ng_schedule(g.indptr, 4)
    if name == "jaccard_cluster":
        pairs = rng.integers(0, n, (500, 2))
        return mod.jaccard_cluster(g.indptr, g.indices, pairs, 8)
    if name == "union_find_merge":
        return mod.union_find_merge(n, rng.integers(0, n, (300, 2)), 6)
    if name in ("subgraph_compact", "subgraph_compact_cap"):
        active = (rng.random(n) < 0.6).astype(np.uint8)
        vertices = np.flatnonzero(active).astype(np.int32)
        renum = np.full(n, -1, np.int64)
        renum[vertices] = np.arange(len(vertices))
        cap = 3 if name.endswith("cap") else 0
        return mod.subgraph_compact(vertices, g.indptr, g.indices, active, renum, cap=cap, seed=99)
    if name == "expand_frontier":
        active = np.zeros(n, np.uint8)
        active[[150, 160]] = 1
        new = mod.expand_frontier(np.array([150, 160]), g.indptr, g.indices, active)
        return new, active
    if name == "scatter_add_f32":
        out = np.zeros(50, np.float32)
        mod.scatter_add_f32(rng.integers(0, 50, 2000), rng.standard_normal(2000).astype(np.float32), out)
        return out
    if name == "saturating_count_i8":
        out = np.zeros(40, np.int8)
        spill = mod.saturating_count_i8(rng.integers(0, 40, 6000), 100, out)
        return spill, out
    if name == "counting_sort":
        return mod.counting_sort(rng.integers(0, 30, 1000), 30)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "parse_ints", "ng_schedule", "jaccard_cluster", "union_find_merge", "subgraph_compact",
    "subgraph_compact_cap", "expand_frontier", "scatter_add_f32", "saturating_count_i8", "counting_sort",
])
def test_native_entry_point_equals_jax(tmp_path, name):
    got, want = _native_case(name, native, tmp_path), _native_case(name, j_native, tmp_path)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    if name == "saturating_count_i8":
        assert got[0].any() and got[1].max() == 100


def test_native_raises_when_it_cannot_build(tmp_path, monkeypatch):
    """No fallback: a source that does not compile raises with g++'s
    message, and so does every entry point."""
    bad = tmp_path / "gnnhost.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load()
    assert not native.available()
    with pytest.raises(RuntimeError):
        native.counting_sort(np.zeros(3, np.int64), 1)
    with pytest.raises(RuntimeError):
        sample.sample_vertex(CSRGraph.from_edges(np.zeros(2), np.ones(2), 3), np.array([0]))
    monkeypatch.setattr(native, "SRC", tmp_path / "missing.cpp")
    with pytest.raises(RuntimeError, match="missing"):
        native.load()
