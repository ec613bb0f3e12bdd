"""Run one cell of BENCHMARK.json and print its result as the last line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Exits 2 without a card (or with fewer cards than the cell asks for) and 3
when JAX or the JAX package was loaded, printing no result either way.  The
numbers compared and their limits are the last lines on standard error and
the last key of the result line.  Kernel and compile caches stay inside the
checkout, at fixed paths.
"""

import time

T0 = time.time()  # set-up is counted from here, before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(CHECKOUT, "build", "portbench")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _finite(x):
    return x if not isinstance(x, float) or math.isfinite(x) else str(x)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    import torch

    from portbench import harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import gnn_computing_tpu_torch  # noqa: F401  (the system under test: fail here where it is missing)

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0, log=log)
    log(f"card: {power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    found = harness.forbidden_modules()
    if found:
        log(f"loaded in this process: {', '.join(found)} (the port must not load JAX or the JAX package)")
        return 3
    for name in [k for k, v in result["metrics"].items() if not math.isfinite(v["value"])]:
        log(f"metric {name} read {result['metrics'].pop(name)['value']}: left out")
    checks = {k: {kk: _finite(vv) for kk, vv in v.items()} for k, v in result.pop("checks").items()}
    result["checks"] = checks
    for k, v in checks.items():
        log(f"check {k}: {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
