"""Fig11 analog: GraphSAGE-LSTM strategy ablation.

Reference: Figure11/main.cu — the three LSTM-aggregation strategies on
fixed-16-neighbor sampled graphs, feature length 32:
  base (materialize)   — [n, k, f] neighbor tensor + dense gates
  +SpFetch             — gather raw features, re-transform per step
  +SpFetch+RedBypass   — transform once, gather gate rows (ours)

Counterpart of ``benchmarks/fig11_sage.py`` over ops.lstm.lstm_aggregate
(plain PyTorch: no kernel of the port), float16 gate gathers for
redundancy_bypass as in the JAX harness.

Run: python -m gnn_computing_tpu_torch.benchmarks.fig11_sage [--quick] [--device cpu]
"""

import torch

from gnn_computing_tpu_torch.benchmarks import common
from gnn_computing_tpu_torch.graph.sample import presample_fixed_neighbors
from gnn_computing_tpu_torch.ops.lstm import init_lstm_params, lstm_aggregate

STRATEGIES = {
    "base": "materialize",
    "+SpFetch": "sparse_fetch",
    "+SpFetch+RedBypass": "redundancy_bypass",
}


def run(name, g, args) -> None:
    """fig11's rows for one dataset."""
    f = args.feature_len
    nbr = torch.from_numpy(presample_fixed_neighbors(g, k=args.k, seed=2)).to(args.device)
    x = common.features(g.num_nodes, f, 3, args)
    params = init_lstm_params(f, f, common.generator(0, args), device=args.device)
    for label, strat in STRATEGIES.items():
        gdt = torch.float16 if strat == "redundancy_bypass" else None
        r = common.bench(
            args, f"fig11.{label}",
            lambda xx, p, nb, s=strat, d=gdt: lstm_aggregate(p, xx, nb, s, gate_gather_dtype=d),
            x, params, nbr, ctx=dict(gate_gather_dtype=gdt),
        )
        common.emit(
            "fig11",
            dict(
                dataset=name,
                strategy=label,
                seconds=r.min_s,
                edges_per_s=g.num_nodes * args.k / r.min_s,
            ),
            args,
        )


def arg_parser():
    ap = common.parser(__doc__)
    ap.add_argument("--k", type=int, default=16)
    return ap


def main(argv=None, check=None):
    args = common.parse_args(arg_parser(), argv, check)
    for name, g in common.datasets(args):
        run(name, g, args)


if __name__ == "__main__":
    main()
