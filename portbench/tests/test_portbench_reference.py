"""At a tiny RMAT on the CPU, where the port runs its plain versions, the
float64 reference agrees with the port's training step and forward, and a
run with the timed path broken underneath comes out not correct.

Each run skips the harness's look for a card (``portbench.run``) and drives
the rest: set-up, the window, the comparison against the cell's limits."""

import time

import numpy as np
import pytest
import torch

from portbench import harness

# (cell, n, m): every tile part and the transposes are non-empty at these sizes
SMALL = [("gcn3.reddit-train", 2048, 65536), ("gat3.reddit-train", 1024, 16384),
         ("gcn3.products-forward", 8192, 131072)]
SEED = 2**31 + 17  # past 32 signed bits: seeds may be that large


def run(cell):
    return harness.run(cell, SEED, 0.2, False, "cpu", time.time(), log=lambda *a: None)


@pytest.mark.parametrize("name, n, m", SMALL)
def test_reference_matches_the_port(small_cell, name, n, m):
    cell = small_cell(name, n, m)
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert all(c["value"] < 1e-5 for c in r["checks"].values()), r["checks"]
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}


def test_same_seed_same_inputs(small_cell):
    cell = small_cell("gcn3.reddit-train", 2048, 65536)
    a, b = (harness.prepare(cell, SEED, "cpu") for _ in range(2))
    assert (a.graph.indptr == b.graph.indptr).all() and (a.graph.src == b.graph.src).all()
    assert all(torch.equal(x, y) for x, y in zip(a.w0, b.w0)) and torch.equal(a.h, b.h) and torch.equal(a.y, b.y)
    c = harness.prepare(cell, SEED + 1, "cpu")  # the traffic's one graph, the seed's data
    assert (c.graph.indptr == a.graph.indptr).all() and (c.graph.src == a.graph.src).all()
    assert torch.equal(c.perm_t, a.perm_t)
    assert not any(torch.equal(x, y) for x, y in zip(a.w0, c.w0))
    assert not torch.equal(c.h, a.h) and not torch.equal(c.y, a.y)


def unchanged_state(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_batch(monkeypatch):
    from gnn_computing_tpu_torch.models import training

    xent = training.softmax_xent
    monkeypatch.setattr(training, "softmax_xent", lambda z, y, mask=None: xent(z[: len(z) // 2], y[: len(y) // 2]))


def altered_answer(monkeypatch):
    from gnn_computing_tpu_torch.aggregator import Aggregator

    run_agg = Aggregator.run

    def altered(self, h, *a, **k):
        out = run_agg(self, h, *a, **k).clone()
        out[0] += 1.0
        return out

    monkeypatch.setattr(Aggregator, "run", altered)


@pytest.mark.parametrize("name, n, m, fault", [
    (*SMALL[0], unchanged_state), (*SMALL[0], half_batch),
    (*SMALL[1], unchanged_state), (*SMALL[1], half_batch),
    (*SMALL[2], altered_answer),
])
def test_broken_path_is_not_correct(small_cell, monkeypatch, name, n, m, fault):
    fault(monkeypatch)
    r = run(small_cell(name, n, m))
    assert not r["correct"], r["checks"]
