"""Convert bench capture rows into fig7.jsonl rows (the full-scale dataset
sweep the plot layer reads: citation/ppa/protein columns).

Counterpart of ``benchmarks/capture_to_fig7.py``.  Takes the LATEST
capture row per (model, scale) among the gcn3/gat3/sagelstm metrics of a
capture log in bench.py's Emitter shape ({"metric", "value", "unit",
"vs_baseline", "time_s", "ts", ...}) and appends fig7-format rows (dataset
= "<scale>_scale_rmat", model GCN/GAT/SAGE-LSTM, seconds, the V100 'ours'
anchor, and the capture row's ``device``).  Skips (dataset, model) pairs
whose newest fig7 row is already as new as the capture row, so a second
run appends nothing.  Reads this package's results/capture.jsonl (the
card's rows), or ``--capture PATH``; never ``benchmarks/results/``, whose
rows are TPU times.

Run: python -m gnn_computing_tpu_torch.benchmarks.capture_to_fig7 [--capture PATH]
"""

import argparse
import json
import os

from gnn_computing_tpu_torch.benchmarks.common import RESULTS_DIR

# bench.py's SCALE_NM (bench.py:51-60, :108-114): (vertices, edges) per scale
SCALE_NM = {
    "reddit": (232_965, 114_615_891),
    "products": (2_449_029, 123_718_280),
    "citation": (2_927_963, 30_387_995),
    "ppa": (576_289, 42_463_862),
    "protein": (132_534, 79_122_504),
}

V100_OURS = {  # draw_fig7.py:68/:75/:84 columns
    ("GCN", "reddit"): 0.058089, ("GAT", "reddit"): 0.055538,
    ("SAGE-LSTM", "reddit"): 0.014204,
    ("GCN", "products"): 0.092553, ("GAT", "products"): 0.113309,
    ("SAGE-LSTM", "products"): None,  # V100 OOM
    ("GCN", "citation"): 0.068879, ("GAT", "citation"): 0.089002,
    ("SAGE-LSTM", "citation"): 0.178892,
    ("GCN", "ppa"): 0.030635, ("GAT", "ppa"): 0.035884,
    ("SAGE-LSTM", "ppa"): 0.035739,
    ("GCN", "protein"): 0.035486, ("GAT", "protein"): 0.034986,
    ("SAGE-LSTM", "protein"): 0.008578,
}
MODEL_NAME = {"gcn": "GCN", "gat": "GAT", "sage": "SAGE-LSTM"}


def _rows(path: str):
    with open(path) as fh:
        for line in fh:
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results-dir", default=RESULTS_DIR, dest="results_dir")
    ap.add_argument("--capture", default=None, help="capture log (default: <results-dir>/capture.jsonl)")
    args = ap.parse_args(argv)
    cap = args.capture or os.path.join(args.results_dir, "capture.jsonl")
    fig7 = os.path.join(args.results_dir, "fig7.jsonl")
    latest = {}
    for r in _rows(cap):
        m = r.get("metric", "")
        model = None
        for k in ("gcn3_", "gat3_", "sagelstm_"):
            if m.startswith(k) and "train" not in m:
                model = {"gcn3_": "gcn", "gat3_": "gat", "sagelstm_": "sage"}[k]
        if model is None or "time_s" not in r:
            continue
        scale = r.get("scale") or m.split("_scale_")[0].split("_")[-1]
        if scale not in SCALE_NM:
            continue
        key = (model, scale)
        if key not in latest or r["ts"] > latest[key]["ts"]:
            latest[key] = r

    have = {}
    if os.path.exists(fig7):
        for r in _rows(fig7):
            key = (r.get("dataset"), r.get("model"))
            have[key] = max(have.get(key, 0), r.get("ts", 0))

    added = 0
    os.makedirs(args.results_dir, exist_ok=True)
    with open(fig7, "a") as fh:
        for (model, scale), r in sorted(latest.items()):
            name = MODEL_NAME[model]
            ds = f"{scale}_scale_rmat"
            if have.get((ds, name), 0) >= r["ts"]:
                continue
            n, m_edges = SCALE_NM[scale]
            edges = n * 16 / r["time_s"] if model == "sage" else 3 * m_edges / r["time_s"]
            row = {
                "dataset": ds,
                "model": name,
                "seconds": r["time_s"],
                "edges_per_s": edges,
                "v100_ours_seconds": V100_OURS.get((name, scale)),
                "device": r.get("device"),
                "ts": r["ts"],
            }
            fh.write(json.dumps(row) + "\n")
            added += 1
            print(json.dumps(row))
    print(f"appended {added} rows to {fig7}")


if __name__ == "__main__":
    main()
