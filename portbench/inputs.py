"""The cell's inputs, drawn on the device: graph, features, labels, weights.

The graph stands for the traffic's dataset: one graph, drawn by the
generator module its ``kind`` names (``portbench/graphs/<kind>.py``, whose
``draw(spec, device)`` returns a ``Graph``) from the traffic's own
``structure_seed``, so that every seed runs the same plan and the same tile
work.  ``--seed`` draws the data on it: the features, the labels and the
weights.  Every kind of data has a stream of its own, so the features can
be drawn again after the window for the reference without holding a copy
through it.
"""

from __future__ import annotations

import dataclasses
import importlib
import math

import numpy as np
import torch

# the stream of each kind of data: seed * len(KINDS) + index
KINDS = ("features", "labels", "weights")


def generator(seed: int, kind: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * len(KINDS) + KINDS.index(kind)) % (1 << 63))


@dataclasses.dataclass
class Graph:
    """CSR by destination on the host: row i's in-edges come from
    ``src[indptr[i]:indptr[i + 1]]``, in the order drawn (stable sort)."""

    indptr: np.ndarray  # int64 [n + 1]
    src: np.ndarray  # int32 [m]

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.src)

    def dst(self) -> np.ndarray:
        return np.repeat(np.arange(self.num_nodes, dtype=np.int32), np.diff(self.indptr))


def csr_on_device(dst: torch.Tensor, src: torch.Tensor, n: int) -> Graph:
    """Edges (int64 dst, int32 src) sorted into CSR on their device."""
    dst, order = torch.sort(dst, stable=True)
    src = src[order]
    del order
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dst.device)
    torch.cumsum(torch.bincount(dst, minlength=n), 0, out=indptr[1:])
    return Graph(indptr=indptr.cpu().numpy(), src=src.cpu().numpy())


def graph(spec: dict, device) -> Graph:
    """The traffic's graph, by the generator module of its ``kind``."""
    return importlib.import_module(f"portbench.graphs.{spec['kind']}").draw(spec, device)


def features(f: int, seed: int, scale: float, n: int, device) -> torch.Tensor:
    """float32 [n, f] normals times ``scale``."""
    return torch.randn((n, f), generator=generator(seed, "features", device), device=device) * scale


def labels(classes: int, seed: int, n: int, device) -> torch.Tensor:
    """int64 [n] uniform over ``classes``."""
    return torch.randint(0, classes, (n,), generator=generator(seed, "labels", device), device=device)


def glorot(shapes, fan: list, seed: int, device) -> list:
    """float32 normals of the Glorot scale sqrt(2 / (fan_in + fan_out)), one
    tensor per shape; ``fan[i]`` is the (fan_in, fan_out) of shape i."""
    gen = generator(seed, "weights", device)
    return [
        torch.randn(shape, generator=gen, device=device) * math.sqrt(2.0 / (fi + fo))
        for shape, (fi, fo) in zip(shapes, fan)
    ]
