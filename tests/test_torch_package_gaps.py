"""The four small gaps of ported modules, closed beside the multi-device
slice, against the JAX package on the CPU: ``ops.validate.valid_reordered``,
``models.gat.init_gat_params``, ``graph.synthetic.rmat_edges_device`` /
``rmat_graph(device=)`` and the package exports (``models``, ``ops``, the
top level's ``CSRGraph`` and ``__version__``).

Tolerances: valid_reordered's verdicts equal the JAX package's; the
initial weights' shapes, dtypes and Glorot scale (sample std within 5% of
sqrt(2 / (f_in + f_out)) over >= 8,192 draws); the device RMAT stream, which
cannot be array-equal to the numpy one, by distribution: each bit level's
quadrant shares within 0.01 of the numpy stream's (a few thousandths is
the sampling spread at 200,000 edges) and the in-degree quantiles (50%,
90%, 99%, max) within 15%."""

import jax
import numpy as np
import pytest
import torch

import gnn_computing_tpu
import gnn_computing_tpu.models as j_models
import gnn_computing_tpu.ops as j_ops
from gnn_computing_tpu.graph.synthetic import rmat_edges as j_rmat_edges
from gnn_computing_tpu.models.gat import init_gat_params as j_init_gat_params
from gnn_computing_tpu.ops.validate import valid_reordered as j_valid_reordered

import gnn_computing_tpu_torch
import gnn_computing_tpu_torch.models as models
import gnn_computing_tpu_torch.ops as ops
from gnn_computing_tpu_torch.graph.synthetic import rmat_edges, rmat_edges_device, rmat_graph
from gnn_computing_tpu_torch.models.gat import GATLayerParams, init_gat_params
from gnn_computing_tpu_torch.ops.validate import valid_reordered

# the JAX package's ops names whose port counterpart has another name
OPS_NAMES = {
    "spmm_xla": "spmm_plain",
    "spmm_transpose_xla": "spmm_transpose",
    "sddmm_slots_xla": "sddmm_slots",
    "bcsr_spmm_xla": "bcsr_spmm_plain",
}


def test_valid_reordered_matches_jax():
    rng = np.random.default_rng(0)
    y_ref = rng.standard_normal((50, 4))
    rows = rng.permutation(50)
    good = y_ref[rows] * (1 + 1e-3)
    bad = good.copy()
    bad[7, 2] += 1.0
    for y in (good, bad, y_ref):
        want = j_valid_reordered(y, y_ref, rows)
        assert valid_reordered(y, y_ref, rows) == want
        assert valid_reordered(torch.from_numpy(y), torch.from_numpy(y_ref), rows) == want
    assert valid_reordered(good, y_ref, rows) and not valid_reordered(bad, y_ref, rows)


@pytest.mark.parametrize("heads", [1, 2])
def test_init_gat_params_matches_jax(heads):
    dims = (512, 128, 64)
    got = init_gat_params(dims, torch.Generator().manual_seed(0), device="cpu", heads=heads)
    want = j_init_gat_params(jax.random.key(0), dims, heads=heads)
    assert len(got) == len(want)
    for i, (p, q) in enumerate(zip(got, want)):
        assert isinstance(p, GATLayerParams)
        scale = np.sqrt(2.0 / (dims[i] + dims[i + 1]))
        for t, u in ((p.w, q.w), (p.w_att, q.w_att)):
            assert tuple(t.shape) == tuple(u.shape) and t.dtype == torch.float32 and t.is_leaf and t.requires_grad
            assert abs(float(t.detach().std()) / scale - 1.0) < 0.05 or t.numel() < 8192
    again = init_gat_params(dims, torch.Generator().manual_seed(0), device="cpu", heads=heads)
    assert all(torch.equal(a.w, b.w) and torch.equal(a.w_att, b.w_att) for a, b in zip(got, again))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            init_gat_params(dims, torch.Generator().manual_seed(0), device="cuda")


def _quadrant_shares(dst, src, n_log2):
    """[n_log2, 4] share of edges in each quadrant at every bit level."""
    out = []
    for bit in range(n_log2 - 1, -1, -1):
        q = ((dst >> bit) & 1) * 2 + ((src >> bit) & 1)
        out.append(np.bincount(q, minlength=4) / len(q))
    return np.array(out)


def test_rmat_edges_device_matches_distribution():
    n_log2, m = 12, 200_000
    jd, js = j_rmat_edges(n_log2, m, seed=5)
    nd, ns = rmat_edges(n_log2, m, seed=5)
    assert np.array_equal(nd, jd) and np.array_equal(ns, js)  # the numpy stream is the JAX package's
    dd, ds = rmat_edges_device(n_log2, m, seed=5, batch=1 << 16, device="cpu")
    assert dd.shape == (m,) and ds.shape == (m,) and dd.dtype == np.int64
    assert dd.min() >= 0 and dd.max() < 1 << n_log2 and ds.min() >= 0 and ds.max() < 1 << n_log2
    want = _quadrant_shares(jd, js, n_log2)
    assert np.abs(_quadrant_shares(dd, ds, n_log2) - want).max() < 0.01
    assert np.allclose(want.mean(axis=0), [0.57, 0.19, 0.19, 0.05], atol=0.01)
    deg_j, deg_d = np.bincount(jd, minlength=1 << n_log2), np.bincount(dd, minlength=1 << n_log2)
    for q in (50, 90, 99, 100):
        a, b = np.percentile(deg_d, q), np.percentile(deg_j, q)
        assert abs(a - b) <= 0.15 * b, (q, a, b)
    again = rmat_edges_device(n_log2, m, seed=5, batch=1 << 16, device="cpu")
    assert np.array_equal(again[0], dd) and not np.array_equal(dd, nd)


def test_rmat_graph_device():
    g = rmat_graph(3000, 40000, seed=2, device="cpu")
    assert g.num_nodes == 3000 and g.num_edges == 40000 and g.val is not None
    assert g.indices.max() < 3000
    assert np.array_equal(rmat_graph(3000, 40000, seed=2).indices, rmat_graph(3000, 40000, seed=2, device=None).indices)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            rmat_graph(300, 4000, device="cuda")


def test_exports_match_jax():
    assert gnn_computing_tpu_torch.__version__ == gnn_computing_tpu.__version__
    assert gnn_computing_tpu_torch.CSRGraph is gnn_computing_tpu_torch.graph.CSRGraph
    for name in j_models.__all__:
        assert name in models.__all__ and hasattr(models, name), name
    for name in j_ops.__all__:
        port = OPS_NAMES.get(name, name)
        assert port in ops.__all__ and callable(getattr(ops, port)) or port == "LSTMParams", name
    assert set(models.__all__) <= set(dir(models)) and set(ops.__all__) <= set(dir(ops))
