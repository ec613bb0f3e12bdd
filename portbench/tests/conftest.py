"""The benchmark's tests.  Those marked ``cuda`` need a CUDA card: they ask
for the ``card`` fixture, which decides inside the test whether there is one."""

import dataclasses

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card and nvcc; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def small_cell():
    """small_cell(name, n, m): the cell of BENCHMARK.json with its traffic's
    graph cut to n vertices and m edges (everything else as listed)."""
    from portbench import spec

    def make(name: str, n: int, m: int):
        cell = spec.cell(name)
        g = dict(cell.traffic["graph"], n=n, m=m)
        return dataclasses.replace(cell, traffic=dict(cell.traffic, graph=g))

    return make
