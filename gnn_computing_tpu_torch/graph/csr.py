"""CSR graph container (host side, numpy).

Port of ``gnn_computing_tpu/graph/csr.py``: rows are destination vertices,
``indices`` are the source vertex of each in-edge, so aggregating row ``i``
produces the output feature of vertex ``i``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gnn_computing_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class CSRGraph:
    """A directed graph in CSR form.

    Attributes:
      indptr:  int32[n + 1] — row offsets.
      indices: int32[m] — source vertex of each edge, row-major by destination.
      val:     optional float32[m] — per-edge values.
      n_src:   number of source-side vertices (defaults to n).
    """

    indptr: np.ndarray
    indices: np.ndarray
    val: Optional[np.ndarray] = None
    n_src: Optional[int] = None

    def __post_init__(self):
        self.indptr = np.asarray(self.indptr, dtype=np.int32)
        self.indices = np.asarray(self.indices, dtype=np.int32)
        if self.val is not None:
            self.val = np.asarray(self.val, dtype=np.float32)
            if self.val.shape != self.indices.shape:
                raise ValueError("val must have one value per edge")
        if self.n_src is None:
            self.n_src = self.num_nodes
        if self.indptr.ndim != 1 or self.indices.ndim != 1:
            raise ValueError("indptr and indices must be 1-D")
        if int(self.indptr[0]) != 0 or int(self.indptr[-1]) != self.num_edges:
            raise ValueError("indptr must run from 0 to the edge count")

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    @property
    def degrees(self) -> np.ndarray:
        """In-degree of every destination row, int32[n]."""
        return np.diff(self.indptr).astype(np.int32)

    @property
    def dst_per_edge(self) -> np.ndarray:
        """Destination vertex of every edge (COO expansion), int32[m]."""
        return np.repeat(np.arange(self.num_nodes, dtype=np.int32), self.degrees)

    def max_degree(self) -> int:
        d = self.degrees
        return int(d.max()) if len(d) else 0

    @classmethod
    def from_edges(
        cls,
        dst: np.ndarray,
        src: np.ndarray,
        num_nodes: int,
        val: Optional[np.ndarray] = None,
        n_src: Optional[int] = None,
    ) -> "CSRGraph":
        """Build CSR from a COO edge list, sorting edges stably by destination."""
        dst = np.asarray(dst, dtype=np.int64)
        src = np.asarray(src, dtype=np.int32)
        order = np.argsort(dst, kind="stable")
        dst = dst[order]
        src = src[order]
        if val is not None:
            val = np.asarray(val, dtype=np.float32)[order]
        counts = np.bincount(dst, minlength=num_nodes).astype(np.int64)
        indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(indptr=indptr.astype(np.int32), indices=src, val=val, n_src=n_src)

    def with_val(self, val: np.ndarray) -> "CSRGraph":
        """A copy carrying per-edge values (CSR edge order)."""
        return CSRGraph(self.indptr, self.indices, val=val, n_src=self.n_src)

    def gcn_norm_val(self) -> np.ndarray:
        """Symmetric GCN normalization 1/sqrt(deg_dst * deg_src) per edge,
        float32 (degrees below 1 count as 1), as the JAX package computes
        it."""
        out_deg = np.bincount(self.indices, minlength=self.n_src).astype(np.float32)
        in_deg = self.degrees.astype(np.float32)
        denom = np.sqrt(np.maximum(in_deg[self.dst_per_edge], 1.0) * np.maximum(out_deg[self.indices], 1.0))
        return (1.0 / denom).astype(np.float32)

    def transpose(self) -> "CSRGraph":
        """Reverse every edge (dst <-> src), for backward aggregation."""
        return self.transpose_with_map()[0]

    def transpose_with_map(self) -> tuple:
        """(gt, edge_map): the transposed graph and the edge correspondence,
        transposed edge ``i`` being original edge ``edge_map[i]`` (int64).
        Carries per-edge values (e.g. attention scores) into aggregation
        over the reversed graph."""
        dst = self.indices.astype(np.int64)
        order = np.argsort(dst, kind="stable")
        gt = CSRGraph.from_edges(
            dst=dst, src=self.dst_per_edge, num_nodes=self.n_src, val=self.val, n_src=self.num_nodes,
        )
        return gt, order.astype(np.int64)

    def reorder(self, rows: np.ndarray) -> "CSRGraph":
        """Permute the graph so new row ``i`` is old row ``rows[i]``; sources
        are renumbered through the inverse permutation.  Square graphs only.
        Recorded as the span ``gnn.plan.reorder``."""
        n = self.num_nodes
        if self.n_src != n:
            raise ValueError("reorder requires a square graph")
        rows = np.asarray(rows, dtype=np.int64)
        if rows.shape != (n,):
            raise ValueError(f"permutation must have shape ({n},)")
        with span("gnn.plan.reorder"):
            reverse = np.empty(n, dtype=np.int32)
            reverse[rows] = np.arange(n, dtype=np.int32)

            new_deg = self.degrees.astype(np.int64)[rows]
            new_indptr = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(new_deg, out=new_indptr[1:])
            old_starts = self.indptr[rows].astype(np.int64)
            row_of_edge = np.repeat(np.arange(n, dtype=np.int64), new_deg)
            offs = np.arange(self.num_edges, dtype=np.int64) - new_indptr[row_of_edge]
            old_pos = old_starts[row_of_edge] + offs
            return CSRGraph(
                indptr=new_indptr.astype(np.int32),
                indices=reverse[self.indices[old_pos]],
                val=self.val[old_pos] if self.val is not None else None,
            )
