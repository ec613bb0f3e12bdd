"""SDDMM over a gather plan: per-edge feature dot products.

Port of ``gnn_computing_tpu/ops/sddmm.py``: ``val[e] = <a[src_e], b[dst_e]>``
for every edge of the plan, in the flat slot layout (``output="slots"``,
[num_tasks_padded * B], 0 in pad slots) or in CSR edge order
(``output="edges"``, through the plan's edge permutation where it has one).
"""

from __future__ import annotations

import torch

from gnn_computing_tpu_torch.ops.spmm import check_strategy, edge_values_from_slots_flat, sddmm_slots
from gnn_computing_tpu_torch.schedule.plan import AggregationPlan


def sddmm(
    plan: AggregationPlan, a: torch.Tensor, b: torch.Tensor, output: str = "edges", strategy: str = "auto",
    gather_dtype=None,
) -> torch.Tensor:
    """out[e] = <a[src_e], b[dst_e]>; ``strategy`` 'auto' or 'xla' (the JAX
    names, both the gather); ``gather_dtype`` the source rows' gather mode
    (ops.spmm.gather_table)."""
    if output not in ("edges", "slots"):
        raise ValueError(f"output must be 'edges' or 'slots', got {output!r}")
    check_strategy(strategy)
    slots = sddmm_slots(plan, a, b, gather_dtype=gather_dtype)
    return slots if output == "slots" else edge_values_from_slots_flat(plan, slots)
