"""Fig8 analog: load balance — actual vs perfectly-balanced aggregation time.

Reference: Figure8/main.cu — per-block GPU clocks compare the measured
kernel time against the perfectly-balanced lower bound (sum of block
durations / parallel capacity), base vs neighbor-grouping.

Counterpart of ``benchmarks/fig8_balance.py``: the unbalanced baseline is
the ``nop`` schedule (one task per row padded to the max degree — the
analog of warp-per-row, aggr_gcn.h:5-36) vs the NG schedule, both on the
gather path (no kernel of the port); the "balanced" bound is
measured_time * slot_occupancy (valid slots / issued slots: the gather's
work is slot-proportional, so occupancy is the balance loss).  The hybrid
row is utils.profiling.decompose of the default hybrid schedule (B1 on
the card in its dense and total phases).

Run: python -m gnn_computing_tpu_torch.benchmarks.fig8_balance [--quick] [--device cpu]
"""

from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.benchmarks import common
from gnn_computing_tpu_torch.ops.spmm import spmm
from gnn_computing_tpu_torch.schedule import neighbor_grouping_plan, nop_plan
from gnn_computing_tpu_torch.utils.profiling import decompose


def base_plan(g, quick: bool):
    """The unscheduled warp-per-row analog.  True nop (pad to max degree)
    is only materializable for bounded-degree graphs; on skewed graphs the
    padded slot grid explodes (n * max_degree slots: rmat_arxiv would
    issue 268M slots), which the GPU's warp-per-row kernel never pays (idle
    lanes are not issued work).  Cap the materialized base block at 128
    and report BOTH the measured occupancy of that grid and the analytic
    occupancy of the true nop grid (m / (n * max_degree)) — the latter is
    the reference's actual imbalance figure."""
    if quick:
        return nop_plan(g)
    b = min(max(g.max_degree(), 1), 128)
    return neighbor_grouping_plan(g, b)


def plan_fields(g, sched: str, plan) -> dict:
    """A row's accounting keys: the plan's slot occupancy, tasks and block
    size, and for the base schedule the analytic occupancy of the true nop
    grid."""
    rec = dict(slot_occupancy=plan.stats()["slot_occupancy"], num_tasks=plan.num_tasks, block_size=plan.block_size)
    if sched == "base":
        rec["nop_occupancy_analytic"] = g.num_edges / (g.num_nodes * max(g.max_degree(), 1))
    return rec


def run(name, g, args) -> None:
    """fig8's rows for one dataset."""
    h = common.features(g.num_nodes, args.feature_len, 1, args)
    for sched, plan in (
        ("base", base_plan(g, args.quick).to(args.device)),
        ("NG", neighbor_grouping_plan(g, args.nei).to(args.device)),
    ):
        r = common.bench(args, f"fig8.{sched}", lambda hh, p: spmm(p, hh), h, plan, ctx=dict(graph=g))
        fields = plan_fields(g, sched, plan)
        rec = dict(dataset=name, schedule=sched, actual_s=r.min_s, balanced_s=r.min_s * fields["slot_occupancy"],
                   **fields)
        common.emit("fig8", rec, args)
    # measured per-phase decomposition of the hybrid schedule
    # (profiling.decompose — the reference's per-block-clock phase columns,
    # Figure8/main.cu:81-201)
    agg = Aggregator.schedule_hybrid(g, with_transpose=False, residual_block=4, device=args.device)
    common.checked(args, "fig8.hybrid", agg.run, h, ctx=dict(graph=g, agg=agg))
    phases = decompose(agg, h, iters=args.iters)
    rec = dict(
        dataset=name,
        schedule="hybrid",
        actual_s=(phases.get("total") or {}).get("ms", 0.0) / 1e3,
    )
    for k in ("dense", "residual", "residual_floor", "transform"):
        if k in phases:
            rec[f"{k}_ms"] = phases[k]["ms"]
            rec[f"{k}_noise_floor"] = phases[k]["noise_floor"]
    common.emit("fig8", rec, args)


def arg_parser():
    return common.parser(__doc__)


def main(argv=None, check=None):
    args = common.parse_args(arg_parser(), argv, check)
    for name, g in common.datasets(args):
        run(name, g, args)


if __name__ == "__main__":
    main()
