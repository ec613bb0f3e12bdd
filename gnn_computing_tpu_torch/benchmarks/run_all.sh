#!/bin/bash
# Run every figure-analog benchmark of the port (reference B10 run.sh layer),
# rows appended to gnn_computing_tpu_torch/benchmarks/results/.
# Usage: gnn_computing_tpu_torch/benchmarks/run_all.sh [--quick] [--device cpu] [...]
set -e
cd "$(dirname "$0")/../.."
ARGS="$@"
for fig in fig7_models fig8_balance fig9_locality fig10_fusion fig11_sage; do
  echo "=== $fig ==="
  python -m "gnn_computing_tpu_torch.benchmarks.$fig" $ARGS
done
# reddit-scale fig7 rows (the V100 anchor's scale) from the cached plans
# (build_all_plans.sh) in a process of their own; skipped in --quick runs
# and when the cache has not been built yet
if [[ "$ARGS" != *"--quick"* ]] && ls build/bench_cache/hybrid_rmat_n232965_* >/dev/null 2>&1; then
  echo "=== fig7 reddit-scale ==="
  python -m gnn_computing_tpu_torch.benchmarks.fig7_models --reddit $ARGS
fi
if python -c "import matplotlib" >/dev/null 2>&1; then
  python -m gnn_computing_tpu_torch.benchmarks.plot
else
  echo "plots skipped: matplotlib is not installed (the .jsonl rows are written)"
fi
