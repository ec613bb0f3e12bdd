"""Dataset IO: ``.config`` / ``.graph`` text format with a binary ``.npz`` cache.

Port of ``gnn_computing_tpu/graph/io.py``; the files are the same in both
packages, so either reads what the other writes:
  * ``<dset>.config`` — one line: ``<num_v> <num_e>``.
  * ``<dset>.graph``  — line 1: n+1 whitespace-separated indptr ints,
                        line 2: m indices ints.
  * ``<dset>.reorder<subfix>`` — n ints, ``rows[i]`` = old vertex id placed
    at new position ``i``.

The first text parse (the native library's mmap scanner) writes a binary
sidecar ``<dset>.graph.npz`` that later loads read instead.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from gnn_computing_tpu_torch import native
from gnn_computing_tpu_torch.graph.csr import CSRGraph


def dataset_config(datadir: str, dset: str) -> Tuple[int, int]:
    path = os.path.join(datadir, dset + ".config")
    with open(path) as f:
        parts = f.readline().split()
    return int(parts[0]), int(parts[1])


def _read_int_tokens(path: str) -> np.ndarray:
    """All whitespace-separated ints in a text file (native scanner)."""
    return native.parse_ints(path)


def load_reorder(datadir: str, dset: str, subfix: str) -> Optional[np.ndarray]:
    """A reorder permutation file (new position -> old id), or None when
    there is none."""
    path = os.path.join(datadir, dset + ".reorder" + subfix)
    if not os.path.exists(path):
        return None
    return np.asarray(_read_int_tokens(path), dtype=np.int64)


def load_graph(
    datadir: str, dset: str, reorder_subfix: str = "", use_cache: bool = True
) -> Tuple[CSRGraph, Optional[np.ndarray]]:
    """Load a dataset; returns (graph, rows), ``rows`` the applied reorder
    permutation (new -> old) or None."""
    n, m = dataset_config(datadir, dset)
    graph_path = os.path.join(datadir, dset + ".graph")
    cache_path = graph_path + ".npz"

    if use_cache and os.path.exists(cache_path):
        z = np.load(cache_path)
        indptr, indices = z["indptr"], z["indices"]
    else:
        toks = _read_int_tokens(graph_path)
        if len(toks) != (n + 1) + m:
            raise ValueError(f"{graph_path}: expected {(n + 1) + m} ints, got {len(toks)}")
        indptr = toks[: n + 1].astype(np.int32)
        indices = toks[n + 1 :].astype(np.int32)
        if use_cache:
            # the cache's existence is taken as its validity, so it is
            # written beside and renamed into place: a loader killed
            # mid-write never publishes a truncated file
            tmp = f"{cache_path}.tmp.{os.getpid()}.npz"
            np.savez(tmp, indptr=indptr, indices=indices)
            os.replace(tmp, cache_path)

    if int(indptr[-1]) != m:
        raise ValueError(f"{graph_path}: indptr ends at {int(indptr[-1])}, the config says {m} edges")
    g = CSRGraph(indptr=indptr, indices=indices)

    rows = None
    if reorder_subfix:
        rows = load_reorder(datadir, dset, reorder_subfix)
        if rows is not None:
            g = g.reorder(rows)
    return g, rows


def save_graph(datadir: str, dset: str, g: CSRGraph) -> None:
    """Write a graph and its config in the text format."""
    os.makedirs(datadir, exist_ok=True)
    with open(os.path.join(datadir, dset + ".config"), "w") as f:
        f.write(f"{g.num_nodes} {g.num_edges}\n")
    with open(os.path.join(datadir, dset + ".graph"), "w") as f:
        f.write(" ".join(map(str, g.indptr.tolist())))
        f.write("\n")
        f.write(" ".join(map(str, g.indices.tolist())))
        f.write("\n")


def save_reorder(datadir: str, dset: str, subfix: str, rows: np.ndarray) -> str:
    path = os.path.join(datadir, dset + ".reorder" + subfix)
    with open(path, "w") as f:
        f.write("\n".join(map(str, np.asarray(rows).tolist())))
        f.write("\n")
    return path
