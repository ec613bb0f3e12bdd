"""Schedule layer: CSR -> dense count tiles and padded task plans.

``Schedule`` names the reference's four gather schedules and ``make_plan``
builds one (port of ``gnn_computing_tpu/schedule/__init__.py``)."""

import enum

from gnn_computing_tpu_torch.schedule.locality import (
    locality_neighbor_grouping_plan,
    locality_plan,
    source_partition_of,
)
from gnn_computing_tpu_torch.schedule.neighbor_grouping import neighbor_grouping_plan, nop_plan
from gnn_computing_tpu_torch.schedule.plan import AggregationPlan, build_plan


class Schedule(enum.Enum):
    """The reference's Schedule enum (graph_schedule.h:8-14)."""

    locality = "locality"
    neighbor_grouping = "neighbor_grouping"
    locality_neighbor_grouping = "locality_neighbor_grouping"
    nop = "nop"


def make_plan(g, schedule=Schedule.neighbor_grouping, **kw) -> AggregationPlan:
    """The host plan of ``schedule`` (a Schedule or its name) over ``g``;
    plain ``locality`` takes ``block_size=None`` (the longest run) unless
    given one."""
    schedule = Schedule(schedule)
    if schedule is Schedule.neighbor_grouping:
        return neighbor_grouping_plan(g, **kw)
    if schedule is Schedule.locality:
        kw.setdefault("block_size", None)
        return locality_plan(g, **kw)
    if schedule is Schedule.locality_neighbor_grouping:
        return locality_neighbor_grouping_plan(g, **kw)
    return nop_plan(g, **kw)


__all__ = [
    "AggregationPlan",
    "Schedule",
    "build_plan",
    "make_plan",
    "neighbor_grouping_plan",
    "nop_plan",
    "locality_plan",
    "locality_neighbor_grouping_plan",
    "source_partition_of",
]
