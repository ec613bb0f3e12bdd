"""1-bit tiles in the PyTorch port against the JAX package: the plane-major
packing, split_bit_tiles, the bit_tiles=True hybrid schedule, the tile
product (B1's plain version) over 1-bit parts, the GCN forward of the
package's flagship compile check (``__graft_entry__.entry()``), and the
calls over 1-bit parts that equal themselves over the parts unpacked to
int8 (bit-tile training's own checks against the JAX package are in
``tests/test_torch_bits_train.py``).

Tolerance: host arrays are compared for equality.  Forwards: the ops/validate
gate (|y - ref| <= 1e-2*|ref| + 1e-5) against the JAX package and a float64
dense oracle, plus max|port - jax| <= 1e-5 * max|jax| (float32 summation
order only)."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_computing_tpu.aggregator import Aggregator as JAggregator
from gnn_computing_tpu.graph.reorder import degree_sort as j_degree_sort
from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat_graph
from gnn_computing_tpu.ops.bcsr import bcsr_spmm as j_bcsr_spmm
from gnn_computing_tpu.schedule import tiles as j_tiles

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.convert import gcn_params_from_jax
from gnn_computing_tpu_torch.graph import degree_sort, normal_features, rmat_graph
from gnn_computing_tpu_torch.models.gcn import gcn_forward_bench
from gnn_computing_tpu_torch.ops import cuda_bcsr, cuda_gat, cuda_gat_bwd, cuda_rowmax
from gnn_computing_tpu_torch.ops.bcsr import bcsr_rowmax, bcsr_rowmax_plain, bcsr_spmm, bcsr_spmm_plain
from gnn_computing_tpu_torch.ops.bcsr_gat import (
    gat_bcsr,
    gat_bcsr_plain,
    gat_bwd_dad,
    gat_bwd_dad_plain,
    gat_bwd_dh_das,
    gat_bwd_dh_das_plain,
)
from gnn_computing_tpu_torch.ops.reference import dense_adjacency
from gnn_computing_tpu_torch.ops.validate import assert_valid
from gnn_computing_tpu_torch.schedule.tiles import (
    TilePlan,
    densify,
    pack_bit_tiles,
    split_bit_tiles,
    unpack_bit_tiles,
)

from test_torch_spmm import assert_matches_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graphs(n=1024, m=40000, seed=13):
    gj = j_rmat_graph(n, m, seed=seed, with_val=False, device="cpu")
    gp = rmat_graph(n, m, seed=seed, with_val=False)
    return gj.reorder(j_degree_sort(gj)), gp.reorder(degree_sort(gp))


def _same_plan(jp, pp):
    """Host TilePlans (JAX, port) hold the same tiles."""
    assert (jp is None) == (pp is None)
    if jp is None:
        return
    assert np.asarray(jp.a).dtype == np.asarray(pp.a).dtype
    assert np.array_equal(np.asarray(jp.a), np.asarray(pp.a))
    assert np.array_equal(np.asarray(jp.tile_row), np.asarray(pp.tile_row))
    assert np.array_equal(np.asarray(jp.tile_col), np.asarray(pp.tile_col))
    for k in ("num_tiles", "num_dense_edges", "bits", "pack", "num_nodes", "n_src", "tile_rows", "tile_cols"):
        assert getattr(jp, k) == getattr(pp, k), k
    rows = np.asarray(pp.tile_row)
    assert np.array_equal(np.asarray(pp.run_start), np.searchsorted(rows, np.arange(pp.num_row_tiles + 1)))


@pytest.mark.parametrize("r", [8, 24, 64, 256])
def test_pack_unpack_round_trip_equals_jax(r):
    a = (np.random.default_rng(r).random((5, r, 40)) < 0.3).astype(np.int8)
    packed = pack_bit_tiles(a)
    assert packed.dtype == np.uint8 and packed.shape == (5, r // 8, 40)
    assert np.array_equal(packed, j_tiles.pack_bit_tiles(a))
    assert (packed > 127).any()
    back = unpack_bit_tiles(packed)
    assert back.dtype == np.int8 and np.array_equal(back, a)
    assert np.array_equal(back, j_tiles.unpack_bit_tiles(packed))
    # plane-major: bit b of packed[t, i, c] is cell (b*R/8 + i, c)
    t, i, c, b = 3, r // 8 - 1, 17, 5
    assert (packed[t, i, c] >> b) & 1 == a[t, b * (r // 8) + i, c]
    got = unpack_bit_tiles(torch.from_numpy(packed))
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), a)
    with pytest.raises(ValueError):
        pack_bit_tiles(np.zeros((1, 12, 4), np.int8))


@pytest.mark.parametrize("tr,tc,thr", [(64, 64, 6), (256, 128, 24), (24, 40, 3)])
def test_split_bit_tiles_equals_jax(tr, tc, thr):
    gj, gp = _graphs()
    tj, _ = j_densify_int8(gj, tile_rows=tr, tile_cols=tc, threshold=thr)
    tp, _ = densify(gp, dtype=np.int8, tile_rows=tr, tile_cols=tc, threshold=thr)
    jb, ji = j_tiles.split_bit_tiles(tj)
    pb, pi = split_bit_tiles(tp)
    assert pb is not None and pi is not None
    _same_plan(jb, pb)
    _same_plan(ji, pi)
    assert pb.num_dense_edges + pi.num_dense_edges == tp.num_dense_edges
    # both parts cover every row-tile, and the 1-bit part unpacks to its tiles
    for p in (pb, pi):
        assert set(np.asarray(p.tile_row)) == set(range(tp.num_row_tiles))
    assert unpack_bit_tiles(pb.a).max() <= 1 and np.asarray(pi.a).max() > 1


def j_densify_int8(g, **kw):
    return j_tiles.densify(g, dtype=np.int8, **kw)


def _hand_plans(counts):
    """The same host plan (JAX, port) from hand-made [T, 8, 8] counts, one
    tile per row-tile."""
    a = np.asarray(counts, np.int8)
    t = a.shape[0]
    rows = np.arange(t, dtype=np.int32)
    cols = np.zeros(t, np.int32)
    common = dict(num_nodes=8 * t, n_src=8, tile_rows=8, tile_cols=8, num_tiles=t,
                  num_dense_edges=int(a.sum()), scale_dst=None, scale_src=None)
    jp = j_tiles.TilePlan(a=a, tile_col=cols, tile_row=rows, **common)
    pp = TilePlan(a=a, tile_col=cols, tile_row=rows, run_start=np.arange(t + 1, dtype=np.int32), **common)
    return jp, pp


@pytest.mark.parametrize("case", ["all_bits", "all_int8", "empty"])
def test_split_bit_tiles_one_part_none(case):
    a = np.zeros((3, 8, 8), np.int8)
    if case == "all_bits":
        a[:, 2, 3] = 1
    elif case == "all_int8":
        a[:, 0, 0] = 2
    else:
        a = a[:0]
    jp, pp = _hand_plans(a)
    jb, ji = j_tiles.split_bit_tiles(jp)
    pb, pi = split_bit_tiles(pp)
    _same_plan(jb, pb)
    _same_plan(ji, pi)
    assert (pb is None) == (case != "all_bits")


@pytest.mark.parametrize("pack", [1, 8])
def test_schedule_hybrid_bit_tiles_equals_jax(pack):
    gj, gp = _graphs()
    kw = dict(tile_rows=64, tile_cols=64, threshold=6, residual_block=4, pack=pack, bit_tiles=True)
    ja = JAggregator.schedule_hybrid(gj, tile_dtype=np.int8, with_transpose=False, device_put=False, **kw)
    pa = Aggregator.schedule_hybrid(gp, tile_dtype=np.int8, with_transpose=False, device="cpu", **kw)
    assert pa.tile_bits.bits and not pa.tile.bits
    assert pa.tile_bits.a.dtype == torch.uint8 and pa.tile.a.dtype == torch.int8
    cpu = lambda p: dataclasses.replace(  # noqa: E731
        p, a=p.a.numpy(), tile_row=p.tile_row.numpy(), tile_col=p.tile_col.numpy(), run_start=p.run_start.numpy()
    )
    _same_plan(ja.tile_bits, cpu(pa.tile_bits))
    _same_plan(ja.tile, cpu(pa.tile))
    assert [p.bits for p in pa.tile_parts()] == [p.bits for p in ja.tile_parts()] == [True, False]
    assert pa.plan.num_edges == ja.plan.num_edges
    assert np.array_equal(pa.plan.src.numpy(), np.asarray(ja.plan.src).reshape(-1))


def test_to_and_pad_runs_keep_uint8():
    _, gp = _graphs()
    bits, _ = split_bit_tiles(densify(gp, dtype=np.int8, tile_rows=64, tile_cols=64, threshold=6)[0])
    assert (bits.a > 127).any()
    padded = bits.pad_runs(4)
    assert padded.a.dtype == np.uint8 and padded.num_tiles % 4 == 0
    assert unpack_bit_tiles(padded.a).sum() == unpack_bit_tiles(bits.a).sum()
    on = padded.to("cpu")
    assert on.a.dtype == torch.uint8 and on.bits
    assert np.array_equal(on.a.numpy(), padded.a)
    assert torch.equal(on.counts(), torch.from_numpy(unpack_bit_tiles(padded.a)))
    assert torch.equal(on.unpack_bits().a, on.counts()) and not on.unpack_bits().bits


@pytest.mark.parametrize("pack", [1, 4])
def test_tile_product_over_bits_matches_jax(pack):
    gj, gp = _graphs()
    kw = dict(tile_rows=64, tile_cols=64, threshold=6)
    jb, ji = j_tiles.split_bit_tiles(j_densify_int8(gj, **kw)[0])
    pb, pi = split_bit_tiles(densify(gp, dtype=np.int8, **kw)[0])
    h = np.random.default_rng(4).standard_normal((gp.n_src, 24)).astype(np.float32)
    ht = torch.from_numpy(h)
    a = dense_adjacency(gp)
    for jp, pp in ((jb, pb), (ji, pi)):
        jp, pp = jp.pad_runs(pack), pp.pad_runs(pack).to("cpu")
        want = j_bcsr_spmm(jp.device_put(), jnp.asarray(h), strategy="auto")
        got = bcsr_spmm(pp, ht)
        # a 1-bit plan and its unpacked int8 plan give the same numbers
        assert torch.equal(got, bcsr_spmm_plain(pp.unpack_bits(), ht))
        dense = np.zeros((pp.num_row_tiles * 64, pp.num_col_tiles * 64))
        cnt = pp.counts().numpy()
        for t in range(pp.num_tiles):
            r, c = pp.tile_row[t].item(), pp.tile_col[t].item()
            dense[r * 64 : r * 64 + 64, c * 64 : c * 64 + 64] += cnt[t]
        ref = dense[: gp.num_nodes, : gp.n_src] @ h.astype(np.float64)
        assert_matches_jax(got.numpy(), jax.device_get(want), ref, what=f"bits={pp.bits} pack{pack}")
    # the two parts together are the int8 plan's tiles
    both = bcsr_spmm((pb.to("cpu"), pi.to("cpu")), ht)
    whole = bcsr_spmm(densify(gp, dtype=np.int8, **kw)[0].to("cpu"), ht)
    assert (both - whole).abs().max() <= 1e-5 * whole.abs().max()
    assert cuda_bcsr.launches == 0


def _bit_part():
    _, gp = _graphs()
    bits, _ = split_bit_tiles(densify(gp, dtype=np.int8, tile_rows=64, tile_cols=64, threshold=6)[0])
    return gp, bits.to("cpu")


def _bit_calls():
    """name -> call(plan, h, gbar, c, v) of every plain version and
    dispatcher that reads tile counts, and of the aggregator paths."""
    return {
        "gat_bcsr_plain": lambda tp, h, g, c, v: gat_bcsr_plain(tp, h, v),
        "gat_bcsr": lambda tp, h, g, c, v: gat_bcsr(tp, h, v),
        "gat_bcsr_parts": lambda tp, h, g, c, v: gat_bcsr((tp,), h, v),
        "bcsr_rowmax_plain": lambda tp, h, g, c, v: bcsr_rowmax_plain(tp, c),
        "bcsr_rowmax": lambda tp, h, g, c, v: bcsr_rowmax(tp, c),
        "gat_bwd_dad_plain": lambda tp, h, g, c, v: gat_bwd_dad_plain(tp, h, g, c, v, v[:, 1], 0.2),
        "gat_bwd_dad": lambda tp, h, g, c, v: gat_bwd_dad(tp, h, g, c, v, v[:, 1], 0.2),
        "gat_bwd_dh_das_plain": lambda tp, h, g, c, v: gat_bwd_dh_das_plain(tp, h, g, c, v, v[:, 1], 0.2),
        "gat_bwd_dh_das": lambda tp, h, g, c, v: gat_bwd_dh_das(tp, h, g, c, v, v[:, 1], 0.2),
        "transpose": lambda tp, h, g, c, v: tp.transpose().counts(),
    }


@pytest.mark.parametrize("call", sorted(_bit_calls()))
def test_bit_variants_equal_unpacked(call):
    """Each call that raised on a 1-bit part before bit-tile training was
    ported runs on it, and equals the same call over the part unpacked to
    int8."""
    gp, tp = _bit_part()
    n = gp.num_nodes
    rng = np.random.default_rng(3)
    h, g, c, v = (torch.from_numpy(rng.random(s).astype(np.float32)) for s in ((n, 8), (n, 8), n, (n, 2)))
    fn = _bit_calls()[call]
    if call == "transpose":
        tp = dataclasses.replace(tp, a=tp.a.numpy(), tile_row=tp.tile_row.numpy(),
                                 tile_col=tp.tile_col.numpy(), run_start=tp.run_start.numpy())
    got, want = fn(tp, h, g, c, v), fn(tp.unpack_bits(), h, g, c, v)
    for x, y in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    assert (cuda_bcsr.launches, cuda_gat.launches, cuda_rowmax.launches) == (0, 0, 0)
    assert (cuda_gat_bwd.dad_launches, cuda_gat_bwd.dh_das_launches) == (0, 0)


def test_bit_aggregator_gat_and_training_run():
    """run_gat on a bit_tiles=True aggregator and the bit_tiles=True,
    with_transpose=True schedule run on the CPU and equal the same calls
    over the parts unpacked to int8; the kernel wrappers reach their device
    check on a 1-bit part (no format refusal)."""
    gp, tp = _bit_part()
    n = gp.num_nodes
    rng = np.random.default_rng(4)
    h = torch.from_numpy(rng.random((n, 8)).astype(np.float32))
    v = torch.from_numpy(rng.random((n, 2)).astype(np.float32))
    agg = Aggregator.schedule_hybrid(gp, tile_dtype=np.int8, tile_rows=64, tile_cols=64, threshold=6, bit_tiles=True,
                                     with_transpose=True, device="cpu")
    assert [p.bits for p in agg.tile_parts_t()] == [True, False]
    unpacked = dataclasses.replace(agg, tile_bits=agg.tile_bits.unpack_bits(),
                                   tile_bits_t=agg.tile_bits_t.unpack_bits())
    assert torch.equal(agg.run_gat(h, v), unpacked.run_gat(h, v))
    assert torch.equal(agg.run(h), unpacked.run(h))
    for call in (
        lambda: cuda_gat.gat_bcsr_cuda(tp, h, v, v[:, 1].contiguous(), 0.2),
        lambda: cuda_rowmax.rowmax_bcsr_cuda(tp, v[:, 1].contiguous()),
        lambda: cuda_gat_bwd.gat_bwd_dad_cuda(tp, h, h, v[:, 0].contiguous(), v, v[:, 1].contiguous(), 0.2),
        lambda: cuda_gat_bwd.gat_bwd_dh_das_cuda(tp, h, h, v[:, 0].contiguous(), v, v[:, 1].contiguous(), 0.2),
    ):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()


def _entry_module():
    sys.path.insert(0, REPO)
    import __graft_entry__

    return __graft_entry__


def test_entry_configuration_matches_jax():
    """The port's GCN forward over a CPU aggregator built as the flagship
    compile check builds its own (rmat 4096 / 65536 seed 123, [512, 128]
    tiles at t24, 1-bit tiles on, pack 8, 4-slot residual, exact modes),
    against the output of that check's JAX function, with its weights."""
    fn, (jagg, params, h) = _entry_module().entry()
    want = np.asarray(jax.device_get(fn(jagg, params, h)))

    g = rmat_graph(4096, 65536, seed=123, with_val=False)
    agg = Aggregator.schedule_hybrid(
        g, tile_dtype=np.int8, with_transpose=False, tile_rows=512, tile_cols=128, threshold=24, residual_block=4, bit_tiles=True, pack=8, device="cpu",
    )
    assert [p.num_tiles for p in agg.tile_parts()] == [p.num_tiles for p in jagg.tile_parts()]
    assert [p.bits for p in agg.tile_parts()] == [True, False]
    ws = [np.asarray(w) for w in params]
    model = gcn_params_from_jax(ws, device="cpu")
    x = torch.from_numpy(np.asarray(h))
    assert np.array_equal(x.numpy(), normal_features(4096, 512, seed=1) * np.float32(0.1))
    got = model(agg, x)
    assert torch.equal(got, gcn_forward_bench(agg, list(model.weights), x))

    adj = dense_adjacency(g)
    ref = x.double().numpy()
    for w in ws:
        ref = np.maximum(adj @ (ref @ w.astype(np.float64)), 0.0)
    # the JAX output itself misses the gate against the oracle at one
    # cancellation point (1 of 131,072 elements): the port is held to the
    # gate against both, and to the float32 bound against JAX
    assert_matches_jax(got.detach().numpy(), want, None, what="entry() configuration")
    assert_valid(got.detach().numpy(), ref, what="entry() configuration vs f64 oracle")
    assert cuda_bcsr.launches == 0
