"""The residual probe's kernels as redesigned for the card, on the CPU: P2
on B1's cell walk, and P1's task rows, which P2's residual blocks run.  The
CUDA kernels do not run here; what does is held to the JAX probe's Pallas
kernels run in TPU interpret mode (``pltpu.force_tpu_interpret_mode()``),
as ``tests/test_torch_probe_residual.py`` runs them:

- ``dma_task_sums`` (P1's plain version on CPU tensors) at residual blocks
  1, 3 and 8 (signed slot values; P1's slot loop whole, in unrolled steps
  and with a remainder), and ``fused_hybrid`` over a degree-sorted plan
  whose hub run holds most tiles;
- P2's dense summation order, emulated: per-tile partials of the 'split'
  operand (times scale_src), each chunk's in tile order, a run's chunk sums
  in chunk order (``cell_walk.chunked_sums`` over the plan's work list, cut
  so that the hub run spans several chunks), then times scale_dst, against
  the JAX ``fused_hybrid``'s dense_out over an int8 and a factored plan.

Tolerance: max|port - jax| <= 1e-5 * max|jax| (float32 summation order
only: the same rounded operand times exact counts, the same slot
products)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gnn_computing_tpu.graph.csr import CSRGraph as JCSRGraph
from gnn_computing_tpu.graph.reorder import degree_sort as j_degree_sort
from gnn_computing_tpu.schedule.tiles import densify as j_densify
from probes.overlap_dma_residual import dma_task_sums as j_dma_task_sums
from probes.overlap_dma_residual import fused_hybrid as j_fused_hybrid

from gnn_computing_tpu_torch.graph import CSRGraph, degree_sort, rmat_graph
from gnn_computing_tpu_torch.ops import cell_walk, cuda_bcsr, cuda_residual
from gnn_computing_tpu_torch.ops.bcsr import _pre_scale, round_h
from gnn_computing_tpu_torch.probes import overlap_dma_residual as probe
from gnn_computing_tpu_torch.schedule.neighbor_grouping import neighbor_grouping_plan
from gnn_computing_tpu_torch.schedule.tiles import densify

F = 24
N = 2048
HUB = 128  # rows of the hub run, one row tile
TILES = dict(tile_rows=HUB, tile_cols=64, threshold=10)


def _edges():
    """A degree-sorted graph of N nodes whose first row tile (the hub run)
    holds most tiles: HUB rows of 400 in-edges each; every other
    row 1 or 2."""
    rng = np.random.default_rng(5)
    hub_d = np.repeat(np.arange(HUB), 400)
    hub_s = np.concatenate([rng.choice(N, 400, replace=False) for _ in range(HUB)])
    rest_d = np.arange(HUB, N).repeat(1 + (np.arange(HUB, N) % 5 == 0))
    rest_s = rng.integers(0, N, rest_d.size)
    return np.concatenate([hub_d, rest_d]), np.concatenate([hub_s, rest_s])


def _setting(factored=False):
    """(JAX tile plan, port tile plan on the CPU, host residual plan, h) of
    the hub graph in both packages, int8 counts (``factored``: edge values
    sd[dst] * ss[src] with the scales factored out of the tiles)."""
    d, s = _edges()
    gj, gp = JCSRGraph.from_edges(d, s, N), CSRGraph.from_edges(d, s, N)
    gj, gp = gj.reorder(j_degree_sort(gj)), gp.reorder(degree_sort(gp))
    kw = dict(TILES)
    val = None
    if factored:
        rng = np.random.default_rng(8)
        sd = rng.uniform(0.2, 2.0, N).astype(np.float32)
        ss = rng.uniform(0.2, 2.0, N).astype(np.float32)
        val = sd[gp.dst_per_edge] * ss[gp.indices]
        kw.update(scale_dst=sd, scale_src=ss)
    tj, _ = j_densify(gj, val=val, dtype=np.int8, **kw)
    tp, res = densify(gp, val=val, dtype=np.int8, **kw)
    plan = neighbor_grouping_plan(res, block_size=4)
    h = np.random.default_rng(1).standard_normal((N, F)).astype(np.float32) * 0.1
    return tj, tp.to("cpu"), plan, h


def _jax_slots(plan, steps):
    """The JAX probe's residual inputs: the plan's slots padded to ``steps``
    grid steps of tpb tasks."""
    nt, blk = plan.src.shape
    tpb = -(-nt // steps)
    pad = steps * tpb - nt
    src = np.pad(plan.src, ((0, pad), (0, 0))).reshape(steps, tpb * blk).astype(np.int32)
    return jnp.asarray(src), jnp.asarray(np.pad(plan.val, ((0, pad), (0, 0)))), tpb, blk


@functools.lru_cache(maxsize=None)
def _jax_fused(factored):
    """The JAX fused_hybrid's (dense_out, task sums) over the hub plan, in
    interpret mode."""
    tj, _, plan, h = _setting(factored)
    idx, val, tpb, blk = _jax_slots(plan, steps=tj.a.shape[0])
    with pltpu.force_tpu_interpret_mode():
        dense, ts = j_fused_hybrid(tj.device_put(), jnp.asarray(h), idx, val, tpb, blk)
    return jax.device_get(dense), jax.device_get(ts)[: plan.src.shape[0]]


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= 1e-5 * scale, f"{what}: max|d| = {err:.3e}, max|ref| = {scale:.3e}"


def _launches():
    return cuda_bcsr.launches, cuda_residual.task_sums_launches, cuda_residual.fused_launches


def test_hub_run_holds_most_tiles():
    _, tp, _, _ = _setting()
    sizes = np.diff(tp.run_start.numpy())
    assert sizes[0] == sizes.max() and 2 * sizes[0] > tp.num_tiles


@pytest.mark.parametrize("block", [1, 3, 8])
def test_dma_task_sums_blocks_match_jax(block):
    g = rmat_graph(600, 1500, seed=9, with_val=False)
    val = np.random.default_rng(2).uniform(-1.0, 2.0, g.num_edges).astype(np.float32)
    plan = neighbor_grouping_plan(g, block_size=block, val=val)
    h = np.random.default_rng(1).standard_normal((g.n_src, F)).astype(np.float32) * 0.1
    nt = plan.src.shape[0]
    idx, val, tpb, blk = _jax_slots(plan, steps=-(-nt // 64))
    with pltpu.force_tpu_interpret_mode():
        want = j_dma_task_sums(jnp.asarray(h), idx, val, tpb, blk)
    got = probe.dma_task_sums(plan.to("cpu"), torch.from_numpy(h))
    assert got.shape == (nt, F)
    _close(got.numpy(), jax.device_get(want)[:nt], f"task sums B={block}")
    assert _launches() == (0, 0, 0)


@pytest.mark.parametrize("factored", [False, True])
def test_fused_hybrid_hub_plan_matches_jax(factored):
    _, tp, plan, h = _setting(factored)
    want_dense, want_ts = _jax_fused(factored)
    dense, ts = probe.fused_hybrid(tp, plan.to("cpu"), torch.from_numpy(h))
    _close(dense.numpy(), want_dense, f"dense factored={factored}")
    _close(ts.numpy(), want_ts, f"task sums factored={factored}")
    assert _launches() == (0, 0, 0)


@pytest.mark.parametrize("bound", [512, 4096, None])
@pytest.mark.parametrize("factored", [False, True])
def test_p2_dense_order_matches_jax(factored, bound):
    """P2's dense summation order (B1's walk, then scale_dst) against the
    JAX fused_hybrid's dense_out."""
    _, tp, _, h = _setting(factored)
    walk = cell_walk.build_walk(tp, bound)
    if bound is not None:
        run_chunk = walk.parts()["run_chunk"]
        assert run_chunk[1] - run_chunk[0] > 1  # the hub run spans several chunks
    x = _pre_scale(tp, round_h(torch.from_numpy(h), "split"))
    nct, tc = tp.num_col_tiles, tp.tile_cols
    x_tiles = torch.zeros((nct * tc, F)).index_copy_(0, torch.arange(tp.n_src), x).reshape(nct, tc, F)
    parts = torch.bmm(tp.counts().float(), x_tiles[tp.tile_col.long()])
    rows = cell_walk.chunked_sums(walk, parts).reshape(-1, F)[: tp.num_nodes]
    got = rows * tp.scale_dst[:, None] if factored else rows
    _close(got.numpy(), _jax_fused(factored)[0], f"P2 dense order factored={factored} bound={bound}")
