"""Feature-dimension tensor parallelism for wide GNN layers.

Port of ``gnn_computing_tpu/parallel/feature_parallel.py``.  Aggregation
(A @ H) is feature-wise independent, so with H split on the feature axis
every rank runs the unmodified single-card hybrid aggregation
(``Aggregator.run``: B1 over the tiles on the card, the residual gather) on
its [n, f/D] slice with no communication.  The only collective is the
dense transform's contraction: with W row-sharded [f/D, f_out], each rank's
partial (A @ H_shard) @ W_shard is summed over the feature axis
(``mesh.psum``, an all-reduce) into the full [n, f_out] activation, one a
layer; the next layer takes the rank's column slice of it.

The plan is replicated (every rank holds the whole Aggregator).  Layer
semantics are the JAX module's: aggregate-first, relu((A @ h) @ W) between
layers, the last layer's full activation returned on every rank.
"""

from __future__ import annotations

from typing import Sequence

import torch

from gnn_computing_tpu_torch.parallel.mesh import FEATURE_AXIS, Mesh, psum


def _cols(x: torch.Tensor, rank: int, d: int) -> torch.Tensor:
    f = x.shape[1]
    if f % d:
        raise ValueError(f"width {f} is not divisible by the feature axis ({d})")
    return x[:, rank * (f // d) : (rank + 1) * (f // d)]


def shard_features(mesh: Mesh, h: torch.Tensor) -> torch.Tensor:
    """This rank's columns of [n, f] node features, on the mesh's device."""
    return _cols(h, mesh.rank(FEATURE_AXIS), mesh.size(FEATURE_AXIS)).contiguous().to(mesh.device)


def _rows(w: torch.Tensor, rank: int, d: int) -> torch.Tensor:
    if w.shape[0] % d:
        raise ValueError(f"{w.shape[0]} weight rows do not split over {d} ranks")
    k = w.shape[0] // d
    return w[rank * k : (rank + 1) * k]


def shard_w_rows(mesh: Mesh, w: torch.Tensor) -> torch.Tensor:
    """This rank's rows of an [f_in, f_out] weight (the contraction dim)."""
    return _rows(w, mesh.rank(FEATURE_AXIS), mesh.size(FEATURE_AXIS)).to(mesh.device)


def _feature_layers(
    agg, params, xs, ranks, d: int, w_rows, reduce, residual_gather_dtype, tile_h_mode
) -> torch.Tensor:
    """The layer loop shared by both forms, over the ranks ``ranks`` with
    their column shards ``xs``: each layer runs every rank's body
    (A @ x_r) @ w_rows(W, r), then ``reduce(partials, last)`` sums them over
    the feature axis and each rank keeps its columns of the ReLU.  Returns
    the last layer's sum."""
    for i, w in enumerate(params):
        last = i == len(params) - 1
        full = reduce([agg.run(x, residual_gather_dtype, tile_h_mode) @ w_rows(w, r) for r, x in zip(ranks, xs)], last)
        if not last:
            xs = [_cols(torch.relu(full), r, d) for r in ranks]
    return full


def feature_sharded_gcn_forward(
    mesh: Mesh,
    agg,
    params: Sequence[torch.Tensor],
    h_shard: torch.Tensor,
    residual_gather_dtype=None,
    tile_h_mode: str = "auto",
) -> torch.Tensor:
    """Multi-layer GCN with feature-dim tensor parallelism.  ``h_shard``:
    this rank's [n, f0/D] columns (shard_features); ``params``: this
    rank's weight rows (shard_w_rows).  Each layer computes

        out = psum_feature((A @ h_shard) @ W_shard)      [n, f_{i+1}]

    then keeps this rank's column slice for the next layer.  Returns the
    final layer's full [n, f_L] activations, the same on every rank; a
    loss over them is taken alike on every rank (its gradient is then each
    rank's shards' gradient, as ``jax.grad`` of the JAX forward's)."""
    d, r = mesh.size(FEATURE_AXIS), mesh.rank(FEATURE_AXIS)
    return _feature_layers(
        agg, params, [h_shard], [r], d, lambda w, _: w,
        lambda parts, last: psum(mesh, parts[0], FEATURE_AXIS, same_use=last), residual_gather_dtype, tile_h_mode,
    )


def feature_sharded_gcn_forward_bodies(
    agg, params: Sequence[torch.Tensor], h: torch.Tensor, d: int, residual_gather_dtype=None, tile_h_mode: str = "auto"
) -> torch.Tensor:
    """The D rank bodies in one process, over the full ``h`` and weights:
    each layer runs every rank's (A @ h_shard) @ W_shard and sums them (the
    psum), then each rank takes its columns."""
    ranks = range(d)
    return _feature_layers(
        agg, params, [_cols(h, r, d) for r in ranks], ranks, d, lambda w, r: _rows(w, r, d),
        lambda parts, last: sum(parts[1:], parts[0]), residual_gather_dtype, tile_h_mode,
    )
