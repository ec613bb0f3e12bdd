"""Nothing under portbench/ imports JAX, the JAX package or either figure
harness; the top-level name of each module is compared whole, since the
port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

from portbench import spec

FORBIDDEN_TOP = {"jax", "jaxlib", "flax", "gnn_computing_tpu", "benchmarks"}


def imported_modules(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def test_no_module_imports_jax_or_a_figure_harness():
    files = [os.path.join(d, f) for d, _, fs in os.walk(spec.HERE) for f in fs if f.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for name in imported_modules(path):
            assert name.split(".")[0] not in FORBIDDEN_TOP, (path, name)
            assert not name.startswith("gnn_computing_tpu_torch.benchmarks"), (path, name)


def test_prefix_is_not_a_match():
    assert "gnn_computing_tpu_torch".split(".")[0] not in FORBIDDEN_TOP


def test_a_run_loads_no_jax():
    """The harness, the adapters and every module of the port they reach
    leave sys.modules free of JAX and the JAX package."""
    code = ("import portbench.run, portbench.harness, portbench.calibrate, portbench.models.gcn, "
            "portbench.models.gat, gnn_computing_tpu_torch.aggregator, gnn_computing_tpu_torch.models, "
            "gnn_computing_tpu_torch.models.training, gnn_computing_tpu_torch.graph.reorder; "
            "from portbench.harness import counters, forbidden_modules; counters(); print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.CHECKOUT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=spec.CHECKOUT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
