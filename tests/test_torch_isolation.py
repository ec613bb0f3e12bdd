"""The PyTorch port stands alone: it imports neither jax nor the JAX package
(``gnn_computing_tpu`` or any ``gnn_computing_tpu.*`` module — note that
``gnn_computing_tpu_torch`` itself shares that prefix), and its entry
points raise instead of falling back when CUDA is asked for and absent."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises
import gnn_computing_tpu_torch
for info in pkgutil.walk_packages(gnn_computing_tpu_torch.__path__, "gnn_computing_tpu_torch."):
    importlib.import_module(info.name)
import chip_smoke  # noqa: F401  (the chip check's own imports)
sys.path.insert(0, "tests")
import torch_parallel_ranks  # noqa: F401  (what the spawned test ranks import)
bad = sorted(
    m for m, mod in sys.modules.items()
    if mod is not None
    and (m in ("jax", "gnn_computing_tpu") or m.startswith(("jax.", "gnn_computing_tpu.")))
)
print(len([m for m in sys.modules if m.startswith("gnn_computing_tpu_torch")]))
print(bad)
print(sorted(m for m in sys.modules if m.startswith("gnn_computing_tpu_torch.")))
"""

# modules whose walk the probe must include (a subpackage or module that
# failed to import would drop out of it)
WALKED = (
    "gnn_computing_tpu_torch.probes",
    "gnn_computing_tpu_torch.probes.overlap_dma_residual",
    "gnn_computing_tpu_torch.probes.first_threaded_call",
    "gnn_computing_tpu_torch.ops.cuda_residual",
    "gnn_computing_tpu_torch.ops.cuda_gat",
    "gnn_computing_tpu_torch.ops.bcsr_gat",
    "gnn_computing_tpu_torch.schedule.locality",
    "gnn_computing_tpu_torch.native",
    "gnn_computing_tpu_torch.graph.sample",
    "gnn_computing_tpu_torch.graph.io",
    "gnn_computing_tpu_torch.ops.lstm",
    "gnn_computing_tpu_torch.ops.edge_mlp",
    "gnn_computing_tpu_torch.models.sage_lstm",
    "gnn_computing_tpu_torch.graph.reorder",
    "gnn_computing_tpu_torch.utils.autotune",
    "gnn_computing_tpu_torch.utils.cli",
    "gnn_computing_tpu_torch.utils.flops",
    "gnn_computing_tpu_torch.utils.profiling",
    "gnn_computing_tpu_torch.utils.timing",
    "gnn_computing_tpu_torch.__main__",
    "gnn_computing_tpu_torch.parallel",
    "gnn_computing_tpu_torch.parallel.mesh",
    "gnn_computing_tpu_torch.parallel.partition",
    "gnn_computing_tpu_torch.parallel.ring",
    "gnn_computing_tpu_torch.parallel.ring_tiles",
    "gnn_computing_tpu_torch.parallel.allgather_tiles",
    "gnn_computing_tpu_torch.parallel.feature_parallel",
    "gnn_computing_tpu_torch.parallel.launch",
    "gnn_computing_tpu_torch.multichip",
)


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    n_loaded, bad, loaded = proc.stdout.strip().splitlines()
    assert int(n_loaded) >= 20
    assert bad == "[]", bad
    for name in WALKED:
        assert repr(name) in loaded, name


def test_entry_points_raise_without_cuda(monkeypatch):
    from gnn_computing_tpu_torch.aggregator import Aggregator
    from gnn_computing_tpu_torch.convert import gat_params_from_jax, gcn_params_from_jax
    from gnn_computing_tpu_torch.graph import rmat_graph
    from gnn_computing_tpu_torch.models.gat import GAT, glorot_gat_weights
    from gnn_computing_tpu_torch.models.gcn import GCN, glorot_weights
    from gnn_computing_tpu_torch.ops.cuda_bcsr import bcsr_spmm_cuda
    from gnn_computing_tpu_torch.ops.cuda_gat import gat_bcsr_cuda
    from gnn_computing_tpu_torch.ops.cuda_rowmax import rowmax_bcsr_cuda
    from gnn_computing_tpu_torch.utils.timing import cuda_time_ms

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = rmat_graph(64, 400, seed=3, with_val=False)
    weights = glorot_weights((8, 4), seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        Aggregator.schedule_hybrid(g, tile_dtype=np.int8, with_transpose=False, tile_rows=32, tile_cols=32)
    with pytest.raises(RuntimeError, match="cuda"):
        GCN(weights)
    with pytest.raises(RuntimeError, match="cuda"):
        gcn_params_from_jax(weights)
    gat_weights = glorot_gat_weights((8, 4), seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        GAT(gat_weights)
    with pytest.raises(RuntimeError, match="cuda"):
        gat_params_from_jax(gat_weights)
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda_time_ms(lambda: None)
    agg = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, with_transpose=False, tile_rows=32, tile_cols=32, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        agg.to("cuda")
    with pytest.raises(ValueError):
        bcsr_spmm_cuda(agg.tile, torch.zeros(64, 8))
    # run_gat on a CUDA request: the aggregator cannot be placed on the card,
    # and the kernel wrappers take CUDA tensors only
    with pytest.raises(RuntimeError, match="cuda"):
        Aggregator.schedule_hybrid(g, tile_dtype=np.int8, with_transpose=False, tile_rows=32, tile_cols=32, device="cpu").to("cuda").run_gat(
            torch.zeros(64, 8), torch.zeros(64, 2)
        )
    with pytest.raises(ValueError):
        gat_bcsr_cuda(agg.tile, torch.zeros(64, 8), torch.ones(64, 2), torch.ones(64), 0.2)
    with pytest.raises(ValueError):
        rowmax_bcsr_cuda(agg.tile, torch.zeros(64))
    assert agg.run_gat(torch.zeros(64, 8), torch.zeros(64, 2)).shape == (64, 8)


def test_sage_lstm_entry_points_raise_without_cuda(monkeypatch):
    """The LSTM and SAGE-LSTM entry points place their weights on the card
    unless asked for the CPU."""
    from gnn_computing_tpu_torch.convert import lstm_params_from_jax, sage_lstm_params_from_jax
    from gnn_computing_tpu_torch.models.sage_lstm import SageLSTM, init_sage_lstm_params
    from gnn_computing_tpu_torch.ops.lstm import init_lstm_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="cuda"):
        init_lstm_params(8, 4, gen)
    with pytest.raises(RuntimeError, match="cuda"):
        init_sage_lstm_params(8, 4, 2, gen)
    params = init_sage_lstm_params(8, 4, 2, gen, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        SageLSTM(params)
    with pytest.raises(RuntimeError, match="cuda"):
        lstm_params_from_jax([a.numpy() for a in params.lstm])
    with pytest.raises(RuntimeError, match="cuda"):
        sage_lstm_params_from_jax((tuple(a.numpy() for a in params.lstm), params.w_self.numpy(), params.w_out.numpy()))
    model = SageLSTM(params, device="cpu")
    assert model(torch.zeros(5, 8), torch.zeros(5, 3, dtype=torch.long)).shape == (5, 2)


def test_native_builds_outside_the_jax_package(tmp_path, monkeypatch):
    """The port's host library is built under the repo's ignored build/
    directory, from the repo's csrc/gnnhost.cpp, and its build writes
    nothing under gnn_computing_tpu/ (whose tracked libgnnhost.so the JAX
    module builds)."""
    from gnn_computing_tpu_torch import native

    jax_pkg = os.path.join(REPO, "gnn_computing_tpu")
    assert native.library_path().is_relative_to(os.path.join(REPO, "build"))
    assert not native.library_path().is_relative_to(jax_pkg)
    assert native.SRC == native.REPO / "csrc" / "gnnhost.cpp" and str(native.REPO) == REPO

    # every file's path, and its mtime but for the tracked library that the
    # JAX module itself may rebuild (from another test process) meanwhile
    jax_lib = os.path.join(jax_pkg, "_native", "libgnnhost.so")

    def snapshot():
        return {
            path: None if path == jax_lib else os.stat(path).st_mtime_ns
            for d, _, files in os.walk(jax_pkg) if "__pycache__" not in d
            for path in (os.path.join(d, f) for f in files)
        }

    before = snapshot()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    lib = native.load()
    assert native.library_path().parent == tmp_path / "native" and native.library_path().exists()
    assert [p.name for p in (tmp_path / "native").iterdir()] == [native.library_path().name]
    assert lib.gs_parse_ints.restype is not None
    assert np.array_equal(native.counting_sort(np.array([2, 0, 1, 0]), 3), [1, 3, 2, 0])
    assert snapshot() == before


def test_training_entry_points_raise_without_cuda(monkeypatch):
    from gnn_computing_tpu_torch.aggregator import Aggregator
    from gnn_computing_tpu_torch.graph import rmat_graph
    from gnn_computing_tpu_torch.models.gcn import GCN, glorot_weights
    from gnn_computing_tpu_torch.models.training import make_train_step
    from gnn_computing_tpu_torch.ops.cuda_gat_bwd import gat_bwd_dad_cuda, gat_bwd_dh_das_cuda

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = rmat_graph(64, 400, seed=3, with_val=False)
    with pytest.raises(RuntimeError, match="cuda"):
        Aggregator.schedule_hybrid(g, tile_dtype=np.int8, tile_rows=32, tile_cols=32, with_transpose=True)
    agg = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, tile_rows=32, tile_cols=32, with_transpose=True, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        agg.to("cuda")
    model = GCN(glorot_weights((8, 4), seed=0), device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    # the train step runs on the card unless asked for the CPU
    with pytest.raises(RuntimeError, match="cuda"):
        make_train_step(lambda h: model(agg, h), opt)
    with pytest.raises(RuntimeError, match="cuda"):
        make_train_step(lambda h: model(agg, h), opt, device="cuda")
    step = make_train_step(lambda h: model(agg, h), opt, device="cpu")
    assert torch.isfinite(step((torch.rand(64, 8),), torch.zeros(64, dtype=torch.long)))
    # the backward kernels' wrappers take CUDA tensors only
    z, dm = torch.zeros(64, 8), torch.ones(64, 2)
    with pytest.raises(ValueError):
        gat_bwd_dad_cuda(agg.tile, z, z, torch.zeros(64), dm, torch.ones(64), 0.2)
    with pytest.raises(ValueError):
        gat_bwd_dh_das_cuda(agg.tile_t, z, z, torch.zeros(64), dm, torch.ones(64), 0.2)


def test_probe_and_mode_entry_points_raise_without_cuda(monkeypatch):
    """The residual probe and the factored GAT kernel's wrapper run on the
    card unless asked for the CPU; the kernel wrappers refuse CPU tensors."""
    from gnn_computing_tpu_torch.graph import rmat_graph
    from gnn_computing_tpu_torch.ops.cuda_gat import gat_bcsr_factored_cuda
    from gnn_computing_tpu_torch.ops.cuda_residual import fused_hybrid_cuda, task_sums_cuda
    from gnn_computing_tpu_torch.probes import overlap_dma_residual as probe
    from gnn_computing_tpu_torch.schedule.neighbor_grouping import neighbor_grouping_plan
    from gnn_computing_tpu_torch.schedule.tiles import densify

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        probe.main(["--nodes", "256", "--edges", "2000"])
    g = rmat_graph(256, 2000, seed=3, with_val=False)
    tp, res = densify(g, dtype=np.int8, tile_rows=32, tile_cols=32, threshold=2)
    tp, plan = tp.to("cpu"), neighbor_grouping_plan(res, block_size=4).to("cpu")
    h = torch.zeros(256, 8)
    with pytest.raises(ValueError):
        task_sums_cuda(plan, h)
    with pytest.raises(ValueError):
        fused_hybrid_cuda(tp, plan, h, h)
    with pytest.raises(ValueError):
        gat_bcsr_factored_cuda(tp, "twodot", (h, h), torch.zeros(256, 4), torch.zeros(256, 4))
    # on CPU tensors the probe's functions run their plain versions
    assert probe.dma_task_sums(plan, h).shape == (plan.num_tasks_padded, 8)
    assert probe.fused_hybrid(tp, plan, h)[0].shape == (256, 8)


def test_utils_entry_points_raise_without_cuda(monkeypatch):
    """The autotune sweeps and the CLI's parameter init place their work on
    the card unless asked for the CPU; the timing helpers that report device
    time refuse to run without one."""
    from gnn_computing_tpu_torch.graph import rmat_graph
    from gnn_computing_tpu_torch.utils import autotune
    from gnn_computing_tpu_torch.models.gcn import init_gcn_params
    from gnn_computing_tpu_torch.utils.timing import device_ms

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = rmat_graph(256, 2000, seed=3, with_val=False)
    with pytest.raises(RuntimeError, match="cuda"):
        autotune.tune_gather(g, feature_len=4, block_sizes=(8,), iters=1)
    with pytest.raises(RuntimeError, match="cuda"):
        autotune.tune_hybrid(g, feature_len=4, thresholds=(4,), tile_rows=(64,), iters=1)
    with pytest.raises(RuntimeError, match="cuda"):
        autotune.tune(g, feature_len=4, iters=1)
    with pytest.raises(RuntimeError, match="cuda"):
        init_gcn_params((8, 4), torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        device_ms(lambda: None)
    r = autotune.tune_gather(g, feature_len=4, block_sizes=(8,), iters=1, device="cpu")
    assert r.best.plan.src.device.type == "cpu"
    assert [p.device.type for p in init_gcn_params((8, 4), torch.Generator().manual_seed(0), device="cpu")] == ["cpu"]


def test_multi_device_entry_points_raise_without_cuda(monkeypatch):
    """The dry run and the meshes run on the card unless asked for the CPU;
    rmat_graph's device stream and init_gat_params likewise."""
    from gnn_computing_tpu_torch import multichip
    from gnn_computing_tpu_torch.graph import rmat_graph
    from gnn_computing_tpu_torch.models.gat import init_gat_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        multichip.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="cuda"):
        multichip.toy_params("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        rmat_graph(64, 400, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        init_gat_params((8, 4), torch.Generator().manual_seed(0))
    assert len(multichip.toy_params("cpu")) == 2
