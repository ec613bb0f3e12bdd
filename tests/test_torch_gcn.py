"""The slice as a whole: hybrid schedule + 3-layer GCN forward with the
main path's numeric modes (fast_layer_opts), PyTorch port against the JAX
package's ``gcn_forward_bench(strategy="xla")`` with the same weights
(carried through convert.py) and against a float64 dense oracle.

Tolerance: the ops/validate gate (|y - ref| <= 1e-2*|ref| + 1e-5) against
both, plus max|port - jax| <= 1e-5 * max|jax|, which covers float32
summation order only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_computing_tpu.aggregator import Aggregator as JAggregator
from gnn_computing_tpu.graph.reorder import degree_sort as j_degree_sort
from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat_graph
from gnn_computing_tpu.models.gcn import fast_layer_opts as j_fast_layer_opts
from gnn_computing_tpu.models.gcn import gcn_forward_bench as j_gcn_forward_bench

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.convert import gcn_params_from_jax
from gnn_computing_tpu_torch.graph import degree_sort, normal_features, rmat_graph
from gnn_computing_tpu_torch.models.gcn import fast_layer_opts, gcn_forward_bench, glorot_weights
from gnn_computing_tpu_torch.ops import cuda_bcsr
from gnn_computing_tpu_torch.ops.reference import dense_adjacency

from test_torch_spmm import assert_matches_jax

SCHEDULE = dict(tile_rows=64, tile_cols=64, threshold=4, residual_block=4)


@pytest.mark.parametrize("dims", [(64, 32, 16, 8), (48, 80, 24, 8)])
@pytest.mark.parametrize("pack", [1, 16])
def test_gcn_forward_matches_jax(dims, pack):
    gj = j_rmat_graph(480, 9000, seed=29, with_val=False, device="cpu")
    gp = rmat_graph(480, 9000, seed=29, with_val=False)
    gj, gp = gj.reorder(j_degree_sort(gj)), gp.reorder(degree_sort(gp))
    weights = glorot_weights(dims, seed=0)
    h = normal_features(gp.num_nodes, dims[0], seed=123) * 0.1

    jagg = JAggregator.schedule_hybrid(gj, tile_dtype=np.int8, with_transpose=False, pack=pack, **SCHEDULE)
    want = j_gcn_forward_bench(
        jagg, [jnp.asarray(w) for w in weights], jnp.asarray(h), strategy="xla",
        layer_opts=j_fast_layer_opts(dims),
    )

    agg = Aggregator.schedule_hybrid(gp, tile_dtype=np.int8, with_transpose=False, pack=pack, device="cpu", **SCHEDULE)
    assert agg.tile.num_tiles == jagg.tile.num_tiles
    model = gcn_params_from_jax(weights, device="cpu")
    assert [tuple(w.shape) for w in model.weights] == list(zip(dims[:-1], dims[1:]))
    got = model(agg, torch.from_numpy(h), fast_layer_opts(dims))
    same = gcn_forward_bench(agg, list(model.weights), torch.from_numpy(h), fast_layer_opts(dims))
    assert torch.equal(got, same)

    a = dense_adjacency(gp)
    ref = h.astype(np.float64)
    for w in weights:
        ref = np.maximum(a @ (ref @ w.astype(np.float64)), 0.0)
    assert_matches_jax(got.detach().numpy(), jax.device_get(want), ref, what=f"gcn {dims} pack{pack}")
    assert cuda_bcsr.launches == 0


def test_fast_layer_opts_match_jax():
    for jo, po in zip(j_fast_layer_opts(), fast_layer_opts()):
        assert (jo.residual_gather_dtype, jo.tile_h_mode) == (po.residual_gather_dtype, po.tile_h_mode)


def test_unported_options_raise():
    """What the JAX package refuses too: 1-bit tiles split integer count
    tiles only, and the default tiles are float32."""
    g = rmat_graph(100, 800, seed=1, with_val=False)
    with pytest.raises(ValueError, match="bit_tiles"):
        Aggregator.schedule_hybrid(g, bit_tiles=True, device="cpu")
