"""Entry point of the port: the flagship GCN's forward step, then the
multi-device dry run.

Port of ``__graft_entry__.py``: ``entry()`` gives (fn, (agg, params, h)),
the 3-layer 512 -> 128 -> 64 -> 32 GCN forward of bench.py
(``models.gcn.gcn_forward_bench``, exact numeric modes: no layer options)
over bench.py's hybrid configuration in miniature: RMAT 4,096 v / 65,536 e
(seed 123, unweighted, not reordered), int8 [512, 128] tiles at threshold
24 split into a 1-bit and an int8 part, a residual of block 4, runs padded
to 8 tiles, no transposed plan.  The plan honours pack 8 as the JAX entry
does; the CUDA kernels take runs of any length, so the filler tiles only
add work there.  The graph comes from the numpy stream (the JAX entry's
``rmat_graph`` draws on the accelerator when it has one), the input is
``normal_features(4096, 512, seed=1) * 0.1``, and the weights are Glorot
normals from a torch generator seeded 0 (the JAX entry draws them from
jax.random.key(0)).  Everything is placed on ``device``: the card by
default (without one it raises), ``"cpu"`` for the plain versions.

Run: python -m gnn_computing_tpu_torch.entry [n_devices] [--device cuda|cpu] [--no-arxiv]
(n_devices defaults to 1: NCCL takes one card a rank.)
"""

from __future__ import annotations

import numpy as np
import torch

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.device import resolve_device
from gnn_computing_tpu_torch.graph.synthetic import normal_features, rmat_graph
from gnn_computing_tpu_torch.models.gcn import gcn_forward_bench, init_gcn_params

GRAPH = (4096, 65536)  # RMAT vertices, edges (seed 123)
PLAN = dict(tile_rows=512, tile_cols=128, threshold=24, residual_block=4, tile_dtype=np.int8, bit_tiles=True,
            with_transpose=False, pack=8)
DIMS = (512, 128, 64, 32)


def entry(device="cuda") -> tuple:
    """(fn, (agg, params, h)): ``fn(agg, params, h)`` is the flagship GCN's
    forward, its arguments the aggregator, weights and input on ``device``."""
    dev = resolve_device(device)
    g = rmat_graph(*GRAPH, seed=123, with_val=False)
    agg = Aggregator.schedule_hybrid(g, device=dev, **PLAN)
    params = init_gcn_params(DIMS, torch.Generator(device=dev).manual_seed(0), device=dev)
    h = torch.from_numpy(normal_features(g.num_nodes, DIMS[0], seed=1) * 0.1).to(dev)

    def fn(agg, params, h):
        return gcn_forward_bench(agg, params, h)

    return fn, (agg, params, h)


def main(argv=None) -> None:
    import argparse

    from gnn_computing_tpu_torch import multichip

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-arxiv", action="store_true")
    a = ap.parse_args(argv)
    fn, args = entry(a.device)
    with torch.no_grad():
        out = fn(*args)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("non-finite entry forward")
    print("entry OK", tuple(out.shape), flush=True)
    multichip.dryrun_multichip(a.n_devices, a.device, arxiv=not a.no_arxiv)


if __name__ == "__main__":
    main()
