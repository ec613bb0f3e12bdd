"""The control on the card: the program with TF32 switched on for its
float32 matmuls (the configurations state float32 with TF32 off) has to
come out not correct against each cell's limits, and the program as
stated correct, from one set-up each, at sizes a test run holds.

Run on the card: python3 -m pytest -q -p no:cacheprovider portbench/tests -m cuda"""

import pytest

from portbench import calibrate, compare, harness

SIZES = [("gcn3.reddit-train", 32768, 4_000_000), ("gat3.reddit-train", 32768, 4_000_000),
         ("gcn3.products-forward", 262144, 4_000_000)]


@pytest.mark.cuda
@pytest.mark.parametrize("name, n, m", SIZES)
def test_tf32_control_fails_and_the_program_passes(card, small_cell, name, n, m):
    cell = small_cell(name, n, m)
    s = harness.prepare(cell, 2**31 + 101, card)
    progs = []
    for mode in ("sound", "tf32"):
        with calibrate.mode(mode):
            one, prog = harness.start(s)
            del one
        progs.append(prog)
    sound, tf32 = harness.reference_numbers(s, progs)
    assert compare.judge(sound, cell.limits)[0], sound
    assert not compare.judge(tf32, cell.limits)[0], tf32
