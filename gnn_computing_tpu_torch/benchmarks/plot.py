"""Render the figure-analog results (this package's results/*.jsonl) as PDFs.

Counterpart of ``benchmarks/plot.py`` (the reference's draw_fig*.py layer
reduced to one generic grouped-bar renderer over the JSON-line logs).
matplotlib is imported only here, at run time: where it is missing (the
card's machine has none) the script says so and exits with code 2.

Run: python -m gnn_computing_tpu_torch.benchmarks.plot [tag ...] [--results-dir DIR]
"""

import argparse
import json
import os
import sys
from collections import defaultdict

from gnn_computing_tpu_torch.benchmarks.common import RESULTS_DIR

SPECS = {
    # tag: (group key, bar key, value key, ylabel, lower_is_better)
    "fig7": ("dataset", "model", "seconds", "forward time (s)", True),
    "fig8": ("dataset", "schedule", "actual_s", "aggregation time (s)", True),
    "fig9": ("dataset", "reorder", "dense_coverage", "dense-tile coverage", False),
    "fig10a": ("dataset", None, None, "time (s)", True),
    "fig10b": ("dataset", None, None, "time (s)", True),
    "fig11": ("dataset", "strategy", "seconds", "time (s)", True),
}


def load(tag, results=RESULTS_DIR):
    path = os.path.join(results, f"{tag}.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def plot(tag, results=RESULTS_DIR):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = load(tag, results)
    if not rows:
        print(f"{tag}: no results")
        return None
    group_key, bar_key, val_key, ylabel, _ = SPECS[tag]
    data = defaultdict(dict)
    if bar_key is None:  # fig10a/b: multiple *_s columns per row
        val_cols = [k for k in rows[-1] if k.endswith("_s") and k != "ts"]
        for r in rows:
            for c in val_cols:
                data[r[group_key]][c.replace("_s", "")] = r[c]
    else:
        for r in rows:
            data[r[group_key]][r[bar_key]] = r[val_key]

    groups = list(data)
    bars = sorted({b for g in data.values() for b in g})
    fig, ax = plt.subplots(figsize=(1.2 + 1.2 * len(groups), 3.2))
    w = 0.8 / max(len(bars), 1)
    for j, b in enumerate(bars):
        xs = [i + j * w for i in range(len(groups))]
        ys = [data[g].get(b, 0.0) for g in groups]
        ax.bar(xs, ys, width=w, label=b)
    ax.set_xticks([i + 0.4 - w / 2 for i in range(len(groups))])
    ax.set_xticklabels(groups, rotation=30, ha="right", fontsize=8)
    ax.set_ylabel(ylabel)
    ax.set_title(tag)
    ax.legend(fontsize=7)
    fig.tight_layout()
    out = os.path.join(results, f"{tag}.pdf")
    fig.savefig(out)
    plt.close(fig)
    print(f"{tag}: {out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tags", nargs="*", help=f"figures to render, of {list(SPECS)} (default: all)")
    ap.add_argument("--results-dir", default=RESULTS_DIR, dest="results_dir")
    args = ap.parse_args(argv)
    for tag in args.tags:
        if tag not in SPECS:
            ap.error(f"unknown figure {tag!r}; one of {list(SPECS)}")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("plot.py needs matplotlib, which is not installed here; the results/*.jsonl rows are unaffected",
              file=sys.stderr)
        return 2
    for tag in args.tags or list(SPECS):
        plot(tag, args.results_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
