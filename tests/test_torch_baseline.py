"""Cross-framework oracle: JAX forwards vs independent PyTorch
implementations (the reference's DGL/PyG-comparison methodology,
SURVEY.md §4 item 2)."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from benchmarks.torch_baseline import gat_forward_torch, gcn_forward_torch
from gnn_computing_tpu.aggregator import Aggregator
from gnn_computing_tpu.graph.synthetic import rmat_graph
from gnn_computing_tpu.models.gat import GATLayerParams, gat_layer
from gnn_computing_tpu.models.gcn import gcn_forward_bench
from gnn_computing_tpu.ops.validate import assert_valid
from gnn_computing_tpu.schedule import neighbor_grouping_plan


def _setup(seed=41):
    g = rmat_graph(700, 9000, seed=seed, with_val=False)
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((g.num_nodes, 48)).astype(np.float32) * 0.1
    return g, rng, h


def test_gcn_matches_torch_both_styles():
    g, rng, h = _setup()
    dims = (48, 24, 12)
    ws = [
        rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.2
        for i in range(2)
    ]
    agg = Aggregator.schedule_hybrid(
        g, tile_dtype=np.int8, tile_rows=64, tile_cols=64, threshold=4, with_transpose=False
    )
    ours = gcn_forward_bench(
        agg, [jnp.asarray(w) for w in ws], jnp.asarray(h), strategy="xla"
    )
    for style in ("sparse", "pyg"):
        ref = gcn_forward_torch(
            g.indptr, g.indices,
            torch.from_numpy(h).double(),
            [torch.from_numpy(w).double() for w in ws],
            style=style,
        ).numpy()
        assert_valid(np.asarray(ours), ref, what=f"gcn vs torch-{style}")


def test_gat_matches_torch():
    g, rng, h = _setup(seed=43)
    dims = (48, 24, 12)
    params = []
    for i in range(2):
        params.append((
            rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32)
            * 0.2,
            rng.standard_normal((dims[i + 1], 2)).astype(np.float32) * 0.5,
        ))
    plan = neighbor_grouping_plan(g, 8)
    hj = jnp.asarray(h)
    for w, w_att in params:
        hj = gat_layer(
            plan, hj,
            GATLayerParams(w=jnp.asarray(w), w_att=jnp.asarray(w_att)),
        )
    ref = gat_forward_torch(
        g.indptr, g.indices,
        torch.from_numpy(h).double(),
        [(torch.from_numpy(w).double(), torch.from_numpy(a).double())
         for w, a in params],
    ).numpy()
    assert_valid(np.asarray(hj), ref, what="gat vs torch")
