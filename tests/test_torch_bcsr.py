"""Tile product of the PyTorch port (the plain version that stands beside
the CUDA kernel) against the JAX package's ``bcsr_spmm`` — which on the CPU
runs its portable ``bcsr_spmm_xla`` path with the same h_mode rounding —
and against the float64 dense oracle.

Tolerance: the ops/validate gate (|y - ref| <= 1e-2*|ref| + 1e-5) against
both, plus max|port - jax| <= 1e-5 * max|jax|, which covers float32
summation order only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_computing_tpu.graph.reorder import degree_sort as j_degree_sort
from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat_graph
from gnn_computing_tpu.ops.bcsr import bcsr_spmm as j_bcsr_spmm
from gnn_computing_tpu.ops.pallas_bcsr import bf16_residue_chunks as j_chunks
from gnn_computing_tpu.schedule.tiles import densify as j_densify

from gnn_computing_tpu_torch.graph import degree_sort, rmat_graph
from gnn_computing_tpu_torch.ops import cuda_bcsr
from gnn_computing_tpu_torch.ops.bcsr import bcsr_spmm, bcsr_spmm_plain, round_h
from gnn_computing_tpu_torch.ops.reference import spmm_dense
from gnn_computing_tpu_torch.schedule.tiles import densify

from test_torch_spmm import assert_matches_jax


def _graphs(n=600, m=24000, seed=21):
    gj = j_rmat_graph(n, m, seed=seed, with_val=False, device="cpu")
    gp = rmat_graph(n, m, seed=seed, with_val=False)
    return gj.reorder(j_degree_sort(gj)), gp.reorder(degree_sort(gp))


def _scales(g):
    rng = np.random.default_rng(8)
    return (
        rng.uniform(0.2, 2.0, g.num_nodes).astype(np.float32),
        rng.uniform(0.2, 2.0, g.n_src).astype(np.float32),
    )


@pytest.mark.parametrize("h_mode", ["split", "split3", "native", "bf16"])
@pytest.mark.parametrize("pack", [1, 4])
@pytest.mark.parametrize("factored", [False, True])
def test_tile_product_matches_jax(h_mode, pack, factored):
    gj, gp = _graphs()
    kw = dict(tile_rows=64, tile_cols=64, threshold=6)
    val = None
    if factored:
        sd, ss = _scales(gp)
        val = sd[gp.dst_per_edge] * ss[gp.indices]
        kw.update(scale_dst=sd, scale_src=ss)
    tj, _ = j_densify(gj, val=val, dtype=np.int8, **kw)
    tp, _ = densify(gp, dtype=np.int8, val=val, **kw)
    tj, tp = tj.pad_runs(pack), tp.pad_runs(pack).to("cpu")
    h = np.random.default_rng(4).standard_normal((gp.n_src, 24)).astype(np.float32)

    want = j_bcsr_spmm(tj.device_put(), jnp.asarray(h), strategy="auto", h_mode=h_mode)
    got = bcsr_spmm(tp, torch.from_numpy(h), h_mode=h_mode)
    plain = bcsr_spmm_plain(tp, round_h(torch.from_numpy(h), h_mode))
    assert torch.equal(got, plain)

    # f64 oracle over the tile edges: A_tiles from the plan's own counts
    a_dense = np.zeros((tp.num_row_tiles * 64, tp.num_col_tiles * 64))
    for t in range(tp.num_tiles):
        r, c = tp.tile_row[t].item(), tp.tile_col[t].item()
        a_dense[r * 64 : r * 64 + 64, c * 64 : c * 64 + 64] += tp.a[t].numpy()
    a_dense = a_dense[: gp.num_nodes, : gp.n_src]
    if factored:
        a_dense = sd[:, None].astype(np.float64) * a_dense * ss[None, :]
    # the oracle takes the mode's operand: 'split' is defined as a 16-bit
    # rounding of h, which can miss the gate against unrounded h where a
    # row's sum cancels
    ref = a_dense @ round_h(torch.from_numpy(h), h_mode).double().numpy()
    assert_matches_jax(got.numpy(), jax.device_get(want), ref, what=f"tiles {h_mode} pack{pack}")
    assert cuda_bcsr.launches == 0


def test_tiles_plus_residual_is_whole_graph():
    _, gp = _graphs()
    tp, res = densify(gp, dtype=np.int8, tile_rows=64, tile_cols=64, threshold=6)
    h = np.random.default_rng(5).standard_normal((gp.n_src, 8)).astype(np.float32)
    got = bcsr_spmm(tp.pad_runs(4).to("cpu"), torch.from_numpy(h)).double().numpy()
    ref = spmm_dense(gp, h) - spmm_dense(res, h)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_split_rounding_equals_jax():
    x = np.random.default_rng(6).standard_normal((300, 7)).astype(np.float32) * 10.0 ** np.arange(-6, 1)
    hi, lo = j_chunks(jnp.asarray(x), 2)
    want = np.asarray(hi, np.float32) + np.asarray(lo, np.float32)
    assert np.array_equal(round_h(torch.from_numpy(x), "split").numpy(), want)
    with pytest.raises(ValueError):
        round_h(torch.from_numpy(x), "split4")
