"""The useful FLOPs and a launch's bytes and operations, against hand-worked values."""

import dataclasses

import pytest
import torch

from portbench import flops
from portbench.models import gat, gcn

GCN = {"dims": [512, 128, 64, 32]}
REDDIT = (232_965, 114_615_891)
PRODUCTS = (2_449_029, 123_718_280)


def test_gcn_flops_at_the_published_sizes():
    assert gcn.useful_flops(GCN, *REDDIT, train=False) / 1e9 == pytest.approx(86.65, abs=0.005)
    assert gcn.useful_flops(GCN, *REDDIT, train=True) / 1e9 == pytest.approx(178.1, abs=0.05)
    assert gcn.useful_flops(GCN, *PRODUCTS, train=False) / 1e9 == pytest.approx(426.6, abs=0.05)


@pytest.mark.parametrize("train, want", [(False, 560.0), (True, 1240.0)])
def test_gcn_flops_by_hand(train, want):
    # n = 10, m = 20, 4 -> 3 -> 2: forward 2*10*4*3 + 2*20*3 + 2*10*3*2 + 2*20*2;
    # the backward adds 2*20*3 + 2*10*4*3 and 2*20*2 + 2*10*3*2 + 2*10*3*2
    assert gcn.useful_flops({"dims": [4, 3, 2]}, 10, 20, train) == want


@pytest.mark.parametrize("train, want", [(False, 590.0), (True, 1470.0)])
def test_gat_flops_by_hand(train, want):
    # n = 10, m = 20, 4 -> 3: forward 240 + 120 + 20 * (6 + 4) + 30; the
    # backward adds 20 * (12 + 5) + 10 * (30 + 24)
    assert gat.useful_flops({"dims": [4, 3]}, 10, 20, train) == want


@dataclasses.dataclass
class Part:
    a: torch.Tensor
    tile_col: torch.Tensor
    tile_row: torch.Tensor
    tile_rows: int
    tile_cols: int
    n_src: int
    num_nodes: int
    bits: bool = False

    @property
    def num_tiles(self):
        return self.a.shape[0]


def test_int8_part_counts_and_bound():
    a = torch.zeros((3, 4, 4), dtype=torch.int8)
    a[0, 0, 0], a[0, 1, 2], a[0, 3, 3] = 1, 5, 2  # 3 cells
    a[1, 0, 1], a[1, 1, 1] = 1, 1  # 2 cells; tile 2 is filler
    p = Part(a, torch.tensor([0, 0, 1], dtype=torch.int32), torch.tensor([0, 1, 1], dtype=torch.int32), 4, 4, 6, 6)
    ps = flops.part_stats(p)
    assert ps == flops.PartStats(live_tiles=2, live_bytes=2 * (16 + 4), nonzero_cells=5, in_rows=4, out_rows=6)
    # f = 8: bytes 40 + 4 * 8 * (4 + 6) = 360, operations 2 * 5 * 8 = 80
    assert flops.launch_bound_s(ps, 8) == max(360 / flops.PEAK_BYTES_S, 80 / flops.PEAK_FLOPS_F32)


def test_bit_part_counts_set_bits():
    a = torch.zeros((2, 1, 8), dtype=torch.uint8)  # R = 8 rows packed in one byte per column
    a[0, 0, 0], a[0, 0, 7] = 0b1011_0001, 0xFF  # 4 + 8 cells
    p = Part(a, torch.tensor([1, 0], dtype=torch.int32), torch.tensor([0, 0], dtype=torch.int32), 8, 8, 12, 5, True)
    ps = flops.part_stats(p)
    # column tile 1 covers rows 8..11 of 12 sources; row tile 0 rows 0..4 of 5
    assert ps == flops.PartStats(live_tiles=1, live_bytes=8 + 4, nonzero_cells=12, in_rows=4, out_rows=5)


def test_tile_bounds_follow_the_counters():
    """B1 runs over each forward part per layer and, in training, over each
    transposed part: fewer launches than that read no roofline, more
    (a rescue) add time without bound."""
    import types

    from portbench import harness, spec

    a = torch.zeros((1, 4, 4), dtype=torch.int8)
    a[0, 0, 0] = 1
    part = Part(a, torch.tensor([0], dtype=torch.int32), torch.tensor([0], dtype=torch.int32), 4, 4, 4, 4)
    agg = types.SimpleNamespace(tile_parts=lambda: (part, part), tile_parts_t=lambda: (part,))
    cell = spec.cell("gcn3.reddit-train")
    s = types.SimpleNamespace(agg=agg, model=gcn, cell=cell, train=True)
    per = flops.launch_bound_s(flops.part_stats(part), 128) + flops.launch_bound_s(flops.part_stats(part), 64) \
        + flops.launch_bound_s(flops.part_stats(part), 32)
    assert harness._tile_bounds(s, {"B1": 2 * 9}, 2, print) == pytest.approx(2 * 3 * per)
    assert harness._tile_bounds(s, {"B1": 2 * 9 + 4, "B5": 1}, 2, print) == pytest.approx(2 * 3 * per)
    assert harness._tile_bounds(s, {"B1": 2 * 9 - 1}, 2, print) is None
