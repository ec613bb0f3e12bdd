"""Dense float64 numpy oracles (small graphs only), copies of every
function of ``gnn_computing_tpu/ops/reference.py``: ``dense_adjacency``,
``spmm_dense``, ``sddmm_dense``, ``gat_aggregate_dense`` and
``edge_mlp_dense``."""

from __future__ import annotations

import numpy as np

from gnn_computing_tpu_torch.graph.csr import CSRGraph


def dense_adjacency(g: CSRGraph, val=None) -> np.ndarray:
    """A[n, n_src] with A[dst, src] summing duplicate-edge values."""
    if val is None:
        val = g.val if g.val is not None else np.ones(g.num_edges, np.float32)
    a = np.zeros((g.num_nodes, g.n_src), dtype=np.float64)
    np.add.at(a, (g.dst_per_edge, g.indices), np.asarray(val, np.float64))
    return a


def spmm_dense(g: CSRGraph, h: np.ndarray, val=None) -> np.ndarray:
    return dense_adjacency(g, val) @ np.asarray(h, np.float64)


def sddmm_dense(g: CSRGraph, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-edge dots in CSR edge order: out[e] = <a[src_e], b[dst_e]>."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.einsum("ef,ef->e", a[g.indices], b[g.dst_per_edge])


def gat_aggregate_dense(
    g: CSRGraph, h: np.ndarray, att_dst: np.ndarray, att_src: np.ndarray, relu_slope: float = 0.2,
) -> tuple:
    """Fused-GAT math in float64 over the edge list:
    score_e = exp(leaky_relu(att_dst[dst_e] + att_src[src_e]));
    out[i] = sum_e score_e * h[src_e] / sum_e score_e, 0 for rows whose
    score sum is 0.  Returns (out, edge_scores_unnormalized, row_score_sums)."""
    h = np.asarray(h, np.float64)
    z = np.asarray(att_dst, np.float64)[g.dst_per_edge] + np.asarray(att_src, np.float64)[g.indices]
    score = np.exp(np.where(z > 0, z, z * relu_slope))
    num = np.zeros((g.num_nodes, h.shape[1]))
    np.add.at(num, g.dst_per_edge, score[:, None] * h[g.indices])
    denom = np.zeros(g.num_nodes)
    np.add.at(denom, g.dst_per_edge, score)
    safe = np.where(denom == 0.0, 1.0, denom)
    return num / safe[:, None], score, denom


def edge_mlp_dense(g: CSRGraph, h: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Per-edge MLP aggregation over the edge list:
    out[i] = sum_e relu((h[dst_e] + h[src_e]) @ W)."""
    h = np.asarray(h, np.float64)
    w = np.asarray(w, np.float64)
    z = np.maximum((h[g.dst_per_edge] + h[g.indices]) @ w, 0.0)
    out = np.zeros((g.num_nodes, w.shape[1]))
    np.add.at(out, g.dst_per_edge, z)
    return out
