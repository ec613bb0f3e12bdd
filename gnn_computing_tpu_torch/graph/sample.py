"""Graph sampling: k-hop subgraphs and fixed-size neighbor sampling.

Port of ``gnn_computing_tpu/graph/sample.py`` (host side, numpy and the
native library): ``full_graph``, ``sample_vertex`` (k-hop frontier
expansion and compaction into a SubGraph), ``sample_vertex_sample_neighbor``
(the same with a per-vertex neighbor cap) and ``presample_fixed_neighbors``
(the [n, k] neighbor matrix the SAGE-LSTM model aggregates).  The same
seed gives the same arrays as the JAX package.

Compaction always runs in the native library (``native.subgraph_compact``,
a seeded xorshift reservoir for capped rows): there is no numpy fallback,
so a missing toolchain raises rather than giving another sample.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gnn_computing_tpu_torch import native
from gnn_computing_tpu_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class SubGraph:
    """A compacted sampled subgraph.

    vertices: int32[num_v] — original vertex id of each subgraph row.
    graph:    CSR over renumbered ids: row i aggregates sources given as
              positions into ``vertices``.
    """

    vertices: np.ndarray
    graph: CSRGraph

    @property
    def num_v(self) -> int:
        return len(self.vertices)

    @property
    def num_e(self) -> int:
        return self.graph.num_edges


def full_graph(g: CSRGraph) -> SubGraph:
    """The whole graph as a SubGraph (identity vertex map)."""
    return SubGraph(vertices=np.arange(g.num_nodes, dtype=np.int32), graph=g)


def _expand(g: CSRGraph, seeds: np.ndarray, hops: int) -> np.ndarray:
    """bool[n]: the vertices within ``hops`` in-edges of ``seeds``."""
    active = np.zeros(g.num_nodes, dtype=bool)
    active[seeds] = True
    frontier = seeds
    for _ in range(hops):
        if len(frontier) == 0:
            break
        starts = g.indptr[frontier].astype(np.int64)
        degs = g.indptr[frontier + 1].astype(np.int64) - starts
        # the edge positions of every frontier row, concatenated
        first = np.repeat(starts - (np.cumsum(degs) - degs), degs)
        nbrs = np.unique(g.indices[first + np.arange(int(degs.sum()), dtype=np.int64)].astype(np.int64))
        new = nbrs[~active[nbrs]]
        active[new] = True
        frontier = new
    return active


def _compact(g: CSRGraph, seeds: np.ndarray, hops: int, cap: Optional[int], rng: np.random.Generator) -> SubGraph:
    seeds = np.asarray(seeds, dtype=np.int64)
    active = _expand(g, seeds, hops)
    vertices = np.flatnonzero(active).astype(np.int32)
    renum = np.full(g.num_nodes, -1, dtype=np.int64)
    renum[vertices] = np.arange(len(vertices))
    # edges among the active vertices, rows = active vertices; the library's
    # seed is drawn even without a cap, as the JAX package draws it
    src, dst, _ = native.subgraph_compact(
        vertices, g.indptr, g.indices, active.astype(np.uint8), renum,
        cap=0 if cap is None else cap, seed=int(rng.integers(1, 2**63 - 1)),
    )
    # from_edges sorts stably by destination, so a capped row keeps the
    # reservoir's order
    sub = CSRGraph.from_edges(
        dst=dst.astype(np.int64), src=src.astype(np.int32), num_nodes=len(vertices), n_src=len(vertices),
    )
    return SubGraph(vertices=vertices, graph=sub)


def sample_vertex(g: CSRGraph, seeds: np.ndarray, hops: int = 2, seed: int = 123) -> SubGraph:
    """k-hop expansion and compaction."""
    return _compact(g, seeds, hops, None, np.random.default_rng(seed))


def sample_vertex_sample_neighbor(
    g: CSRGraph, seeds: np.ndarray, hops: int = 2, cap: int = 16, seed: int = 123
) -> SubGraph:
    """k-hop expansion with each row capped at ``cap`` sampled sources."""
    return _compact(g, seeds, hops, cap, np.random.default_rng(seed))


def presample_fixed_neighbors(g: CSRGraph, k: int = 16, seed: int = 123) -> np.ndarray:
    """int32[n, k] neighbor matrix: k sampled in-neighbors per vertex.

    Rows with deg >= k sample without replacement (per-edge random keys,
    the first k of each row after a lexsort); rows with 0 < deg < k sample
    with replacement; isolated rows self-loop."""
    n = g.num_nodes
    rng = np.random.default_rng(seed)
    deg = g.degrees.astype(np.int64)
    out = np.empty((n, k), dtype=np.int32)

    keys = rng.random(g.num_edges)
    dst = g.dst_per_edge.astype(np.int64)
    order = np.lexsort((keys, dst))
    sorted_src = g.indices[order]
    starts = g.indptr[:-1].astype(np.int64)
    pos_in_row = np.arange(g.num_edges, dtype=np.int64) - starts[dst[order]]
    sel = (deg >= k)[dst[order]] & (pos_in_row < k)
    out[dst[order][sel], pos_in_row[sel]] = sorted_src[sel]

    small = np.flatnonzero((deg > 0) & (deg < k))
    if len(small):
        offs = rng.integers(0, deg[small][:, None], size=(len(small), k))
        out[small] = g.indices[starts[small][:, None] + offs]

    iso = np.flatnonzero(deg == 0)
    if len(iso):
        out[iso] = iso[:, None].astype(np.int32)
    return out


def fixed_neighbors_to_graph(nbr: np.ndarray) -> CSRGraph:
    """An [n, k] neighbor matrix as the equivalent fixed-degree CSR."""
    n, k = nbr.shape
    indptr = np.arange(0, (n + 1) * k, k, dtype=np.int64)
    return CSRGraph(indptr=indptr.astype(np.int32), indices=np.asarray(nbr, np.int32).reshape(-1))
