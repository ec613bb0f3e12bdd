"""Fig9 analog: locality — aggregation speed/traffic vs vertex reordering.

Reference: Figure9 measures the L2 hit rate of the aggregation kernel under
NG / LAS / NG+LSH-reorder vs DGL's kernel (nvprof l2_tex_hit_rate).

Counterpart of ``benchmarks/fig9_locality.py``: locality shows as (a) the
fraction of edges liftable into dense tiles (schedule/tiles.py) —
reordering concentrates the adjacency as it concentrated cache lines —
and (b) the measured hybrid aggregation time: hybrid_spmm over the float32
tiles (B1 on the card) and the NG-8 residual, beside spmm over an NG plan
(the gather path, no kernel).  Reported per reorder: none / degree sort /
label propagation / MinHash-LSH cluster / exact-Jaccard cluster (the
reference's cluster2.py analogs).  The cluster orders run the native
library's merge loops and raise when it does not build.

Run: python -m gnn_computing_tpu_torch.benchmarks.fig9_locality [--quick] [--device cpu]
"""

from gnn_computing_tpu_torch.benchmarks import common
from gnn_computing_tpu_torch.graph.reorder import (
    cluster_reorder,
    cluster_reorder_exact,
    degree_sort,
    label_propagation_reorder,
)
from gnn_computing_tpu_torch.ops.bcsr import hybrid_spmm
from gnn_computing_tpu_torch.ops.spmm import spmm
from gnn_computing_tpu_torch.schedule import neighbor_grouping_plan
from gnn_computing_tpu_torch.schedule.tiles import densify


def reorders(g) -> dict:
    """name -> permutation (None: the graph's own order), in the JAX
    harness's order."""
    return {
        "none": None,
        "degree": degree_sort(g),
        "lpa": label_propagation_reorder(g),
        "cluster": cluster_reorder(g, num_perm=32, bands=8, threshold=0.2),
        # reference-faithful exact-Jaccard PQ agglomeration with lazy root
        # re-enqueue (cluster2.py:108-153; native gs_jaccard_cluster)
        "cluster_exact": cluster_reorder_exact(g, num_perm=32, bands=8),
    }


def tiles(g2, tile_rows: int) -> tuple:
    """(float32 tile plan, residual graph, dense coverage: the share of
    edges the tiles hold) of the reordered graph."""
    tp, res = densify(g2, tile_rows=tile_rows, tile_cols=128)
    return tp, res, tp.num_dense_edges / max(g2.num_edges, 1)


def run(name, g, args) -> None:
    """fig9's rows for one dataset."""
    for rname, perm in reorders(g).items():
        g2 = g if perm is None else g.reorder(perm)
        h = common.features(g2.num_nodes, args.feature_len, 1, args)
        tp, res, coverage = tiles(g2, args.tile_rows)
        tpd = tp.to(args.device)
        rp = neighbor_grouping_plan(res, 8).to(args.device) if res.num_edges else None
        r = common.bench(args, "fig9.hybrid", lambda x, t, p: hybrid_spmm(t, p, x), h, tpd, rp, ctx=dict(graph=g2))
        base_plan = neighbor_grouping_plan(g2, args.nei).to(args.device)
        rb = common.bench(args, "fig9.gather", lambda x, p: spmm(p, x), h, base_plan, ctx=dict(graph=g2))
        common.emit(
            "fig9",
            dict(
                dataset=name,
                reorder=rname,
                dense_coverage=coverage,  # the "hit rate" analog
                hybrid_s=r.min_s,
                gather_s=rb.min_s,
                edges_per_s=g2.num_edges / min(r.min_s, rb.min_s),
            ),
            args,
        )


def arg_parser():
    ap = common.parser(__doc__)
    ap.add_argument("--tile-rows", type=int, default=256)
    return ap


def main(argv=None, check=None):
    args = common.parse_args(arg_parser(), argv, check)
    for name, g in common.datasets(args):
        run(name, g, args)


if __name__ == "__main__":
    main()
