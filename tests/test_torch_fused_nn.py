"""The fused aggregate+GEMM (``ops/fused_nn.py``, bench's Figure 10b path) in
the PyTorch port against the JAX package's ``hybrid_spmm_nn`` on its CPU
path (the split form: the tile product, then a HIGHEST dot), over int8,
1-bit + int8 and float32 tile parts, plus the empty schedule and the
forward-only guard.

Tolerance: the ops/validate gate (|y - ref| <= 1e-2*|ref| + 1e-5) against
the JAX package and a float64 dense oracle, plus max|port - jax| <= 1e-5 *
max|jax| (float32 summation order only; assert_matches_jax), for both the
aggregate and its transform."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_computing_tpu.aggregator import Aggregator as JAggregator
from gnn_computing_tpu.graph.reorder import degree_sort as j_degree_sort
from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat_graph
from gnn_computing_tpu.ops.fused_nn import hybrid_spmm_nn as j_hybrid_spmm_nn

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.graph import CSRGraph, degree_sort, normal_features, rmat_graph
from gnn_computing_tpu_torch.ops import cuda_bcsr
from gnn_computing_tpu_torch.ops.fused_nn import bcsr_spmm_nn, bcsr_spmm_nn_plain, hybrid_spmm_nn

from test_torch_spmm import assert_matches_jax

# fig10b_pallas's schedule (benchmarks/fig10_fusion.py) at a test size:
# int8 tiles, residual block 4, no transposed plans
KW = dict(tile_rows=64, tile_cols=64, threshold=6, residual_block=4, pack=1, with_transpose=False)
SETTINGS = {
    "int8": dict(tile_dtype=np.int8),
    "bits": dict(tile_dtype=np.int8, bit_tiles=True),
    "f32": dict(tile_dtype=None),
}


def _setting(name):
    gj = j_rmat_graph(700, 20000, seed=5, with_val=False, device="cpu")
    gp = rmat_graph(700, 20000, seed=5, with_val=False)
    gj, gp = gj.reorder(j_degree_sort(gj)), gp.reorder(degree_sort(gp))
    kw = dict(KW, **SETTINGS[name])
    if name == "f32":
        kw["val"] = gp.gcn_norm_val()
    return gp, JAggregator.schedule_hybrid(gj, **kw), Aggregator.schedule_hybrid(gp, device="cpu", **kw), kw


@pytest.mark.parametrize("name", sorted(SETTINGS))
@pytest.mark.parametrize("f,f_out", [(16, 16), (12, 5)])
def test_hybrid_spmm_nn_matches_jax(name, f, f_out):
    gp, ja, pa, kw = _setting(name)
    assert len(pa.tile_parts()) == (2 if name == "bits" else 1)
    h = normal_features(gp.num_nodes, f, seed=3)
    w = (normal_features(f, f_out, seed=3) * 0.1).astype(np.float32)
    jagg, jtrans = j_hybrid_spmm_nn(ja, jnp.asarray(h), jnp.asarray(w))
    agg, trans = hybrid_spmm_nn(pa, torch.from_numpy(h), torch.from_numpy(w))
    adj = np.zeros((gp.num_nodes, gp.n_src))
    np.add.at(adj, (gp.dst_per_edge, gp.indices), kw.get("val", 1.0))
    ref = adj @ h.astype(np.float64)
    assert_matches_jax(agg.numpy(), jax.device_get(jagg), ref, what=f"{name} agg")
    assert_matches_jax(trans.numpy(), jax.device_get(jtrans), ref @ w.astype(np.float64), what=f"{name} trans")
    # each tile part's plain version is the tile product, then the matmul
    p = pa.tile_parts()[0]
    a_p, t_p = bcsr_spmm_nn(p, torch.from_numpy(h), torch.from_numpy(w))
    want_a, want_t = bcsr_spmm_nn_plain(p, torch.from_numpy(h), torch.from_numpy(w))
    assert torch.equal(a_p, want_a) and torch.equal(t_p, want_t)
    assert cuda_bcsr.launches == 0 and cuda_bcsr.epilogue_launches == 0


def test_empty_schedule_gives_zeros():
    """An aggregator without tile parts or residual edges gives zeros of the
    right shapes (the JAX function returns (None, None) there); a graph
    without edges gives zeros through its coverage tiles."""
    g = CSRGraph.from_edges(np.zeros(0, np.int64), np.zeros(0, np.int32), 100)
    agg = Aggregator.schedule_hybrid(g, tile_rows=32, tile_cols=32, residual_block=4, with_transpose=False,
                                     device="cpu")
    h, w = torch.rand(100, 8), torch.rand(8, 3)
    for sched in (agg, dataclasses.replace(agg, tile=None)):
        a, t = hybrid_spmm_nn(sched, h, w)
        assert a.shape == (100, 8) and t.shape == (100, 3)
        assert not a.any() and not t.any()


def test_hybrid_spmm_nn_is_forward_only():
    gp, _, pa, _ = _setting("int8")
    h = torch.rand(gp.num_nodes, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        hybrid_spmm_nn(pa, h, torch.rand(8, 4))
    with torch.no_grad():
        a, t = hybrid_spmm_nn(pa, h, torch.rand(8, 4))
    assert a.grad_fn is None and t.grad_fn is None
