"""RMAT (Kronecker): each of the log2 bits of (dst, src) is drawn from the
quadrant distribution [[a, b], [c, 1 - a - b - c]] over the next power of
two, then folded onto n vertices by modulo.  A frozen copy of the port's
``graph.synthetic.rmat_edges_device`` (same distribution, same stream), so
that a change to the program never changes the benchmark's graphs; unlike
it, the edges stay on the device and are sorted into CSR there, and the
host receives only the finished arrays."""

from __future__ import annotations

import math

import torch

from portbench import inputs


def draw(spec: dict, device, batch: int = 1 << 24) -> inputs.Graph:
    """RMAT over ``spec`` {"n", "m", "a", "b", "c", "structure_seed"}."""
    n, m = int(spec["n"]), int(spec["m"])
    a, b, c = float(spec["a"]), float(spec["b"]), float(spec["c"])
    n_log2 = max(1, math.ceil(math.log2(n)))
    gen = torch.Generator(device=device).manual_seed(int(spec["structure_seed"]))
    t1, t2, t3 = a, a + b, a + b + c
    weights = 1 << torch.arange(n_log2 - 1, -1, -1, dtype=torch.int32, device=device)
    dst = torch.empty(m, dtype=torch.int64, device=device)
    src = torch.empty(m, dtype=torch.int32, device=device)
    for k0 in range(0, m, batch):
        k = min(batch, m - k0)
        r = torch.rand((k, n_log2), generator=gen, device=device)
        q = (r >= t1).to(torch.int32) + (r >= t2).to(torch.int32) + (r >= t3).to(torch.int32)
        del r
        dst[k0:k0 + k] = ((q >> 1) * weights).sum(dim=1) % n
        src[k0:k0 + k] = (((q & 1) * weights).sum(dim=1) % n).to(torch.int32)
        del q
    return inputs.csr_on_device(dst, src, n)
