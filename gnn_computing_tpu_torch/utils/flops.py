"""Throughput accounting.

The reference's universal metric: GFLOP/s = 2 * m * feature_len / t / 1e9
(util.py:3821-3822, include/util.h:120-128) — i.e. one multiply-add per
(edge, feature element) of aggregation.  edges/s = m / t; the BASELINE.json
north-star metric is edges/s/chip.
"""

from __future__ import annotations


def aggregation_gflops(num_edges: int, feature_len: int, seconds: float) -> float:
    return 2.0 * num_edges * feature_len / seconds / 1e9


def edges_per_sec(num_edges: int, seconds: float, passes: int = 1) -> float:
    return passes * num_edges / seconds
