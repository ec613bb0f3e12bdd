"""The port's CLI (``python -m gnn_computing_tpu_torch``) against the JAX
package's on the same graphs: ``info`` and ``schedule`` print the same JSON
(``schedule_seconds`` apart), ``reorder`` and ``presample`` write
byte-identical files (array equality of the bytes); ``bench``, ``train``
and ``tune`` run with ``--device cpu`` and print the JAX CLI's keys, and
``tune`` sweeps the JAX CLI's configurations in its order; ``--device
cuda`` raises without a card."""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gnn_computing_tpu.graph.synthetic import rmat_graph as j_rmat
from gnn_computing_tpu.utils import autotune as j_autotune
from gnn_computing_tpu.utils.cli import main as j_main

from gnn_computing_tpu_torch.utils import autotune
from gnn_computing_tpu_torch.utils.cli import main

from test_torch_spmm import jax_native_from_port  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYN = ["rmat:600:5000", "community:600:5000:7"]


def run(fn, argv, capsys) -> dict:
    fn(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("syn", SYN)
def test_info_equals_jax(syn, capsys):
    assert run(main, ["info", "--syn", syn], capsys) == run(j_main, ["info", "--syn", syn], capsys)


@pytest.mark.parametrize("syn", SYN)
@pytest.mark.parametrize("sched", ["neighbor_grouping", "locality", "locality_neighbor_grouping", "nop"])
def test_schedule_equals_jax(syn, sched, capsys):
    argv = ["schedule", "--syn", syn, "--schedule", sched, "--nei", "16", "--partitions", "4"]
    got, want = run(main, argv, capsys), run(j_main, argv, capsys)
    assert got.pop("schedule_seconds") >= 0 and want.pop("schedule_seconds") >= 0
    assert got == want


def write_dataset(d, name="tiny"):
    g = j_rmat(300, 3000, seed=1)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{name}.config"), "w") as f:
        f.write(f"{g.num_nodes} {g.num_edges}\n")
    with open(os.path.join(d, f"{name}.graph"), "w") as f:
        f.write(" ".join(map(str, g.indptr.tolist())) + "\n")
        f.write(" ".join(map(str, g.indices.tolist())) + "\n")
    return g


@pytest.mark.parametrize("method,subfix", [("cluster", "_thres_0.2"), ("lpa", "_lpa"), ("degree", "_degree")])
def test_reorder_file_equals_jax(method, subfix, tmp_path, capsys):
    outs = {}
    for key, fn in (("port", main), ("jax", j_main)):
        d = str(tmp_path / key)
        write_dataset(d)
        out = run(fn, ["reorder", "--method", method, "--dataset", "tiny", "--datadir", d], capsys)
        assert out == {"output": os.path.join(d, f"tiny.reorder{subfix}"), "n": 300}
        with open(out["output"], "rb") as f:
            outs[key] = f.read()
        # the loader takes the file up through --reorder
        assert run(fn, ["info", "--dataset", "tiny", "--datadir", d, "--reorder", subfix], capsys)["reordered"]
    assert outs["port"] == outs["jax"]
    perm = np.array(outs["port"].split(), dtype=np.int64)
    assert np.array_equal(np.sort(perm), np.arange(300))


def test_reorder_output_flag(tmp_path, capsys):
    d = str(tmp_path)
    write_dataset(d)
    out = run(main, ["reorder", "--method", "cluster", "--threshold", "0.5", "--max-cluster", "8",
                     "--dataset", "tiny", "--datadir", d, "--output", str(tmp_path / "p.txt")], capsys)
    j_out = run(j_main, ["reorder", "--method", "cluster", "--threshold", "0.5", "--max-cluster", "8",
                         "--dataset", "tiny", "--datadir", d, "--output", str(tmp_path / "j.txt")], capsys)
    assert out["n"] == j_out["n"] == 300
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


@pytest.mark.parametrize("argv", [["--dataset", "tiny"], ["--syn", "community:400:4000"]], ids=["dataset", "syn"])
def test_presample_files_equal_jax(argv, tmp_path, capsys):
    files = {}
    for key, fn in (("port", main), ("jax", j_main)):
        d = str(tmp_path / key)
        write_dataset(d)
        out = run(fn, ["presample", *argv, "--datadir", d, "--k", "4", "--seed", "9"], capsys)
        files[key] = [open(out[k], "rb").read() for k in ("config", "graph")]
        name = "tiny_sample_4" if argv[0] == "--dataset" else "syn_sample_4"
        assert out == {"config": os.path.join(d, f"{name}.config"), "graph": os.path.join(d, f"{name}.graph")}
        # the sampled graph loads as a fixed-degree dataset
        assert run(fn, ["info", "--dataset", name, "--datadir", d], capsys)["max_degree"] == 4
    assert files["port"] == files["jax"]


@pytest.mark.parametrize("model", ["gcn", "gat", "sage_lstm"])
def test_bench_on_cpu(model, capsys):
    out = run(main, ["bench", "--device", "cpu", "--syn", "rmat:500:4000", "--model", model, "--iters", "2",
                     "--k", "4"], capsys)
    assert set(out) == {"model", "seconds", "edges_per_s", "gflops"} and out["model"] == model
    assert out["seconds"] > 0 and math.isclose(out["edges_per_s"], 4000 / out["seconds"])
    assert math.isclose(out["gflops"], 2.0 * 4000 * 32 / out["seconds"] / 1e9)


@pytest.mark.parametrize("sched", ["neighbor_grouping", "locality_neighbor_grouping"])
def test_train_on_cpu(sched, capsys):
    out = run(main, ["train", "--device", "cpu", "--syn", "rmat:500:4000", "--schedule", sched,
                     "--epochs", "6", "--classes", "4"], capsys)
    assert out["epochs"] == 6 and len(out["losses"]) == 6 and out["final_loss"] == out["losses"][-1]
    assert all(math.isfinite(v) for v in out["losses"]) and out["losses"][-1] < out["losses"][0]
    # parameters come from a seeded generator: a second run repeats the first
    assert run(main, ["train", "--device", "cpu", "--syn", "rmat:500:4000", "--schedule", sched,
                      "--epochs", "6", "--classes", "4"], capsys) == out


@pytest.mark.parametrize("syn", ["rmat:800:8000", "community:800:8000"])
def test_tune_sweeps_the_jax_configs(syn, monkeypatch, capsys):
    """With the timing stubbed (the JAX side would compile every candidate),
    both sweeps list the same configurations in the same order; synthetic
    graphs carry edge values, so the hybrid sweep skips int8 in both."""
    monkeypatch.setattr(j_autotune, "_time_agg", lambda agg, f, iters, seed=0: 1.0)
    want = run(j_main, ["tune", "--syn", syn, "--iters", "2"], capsys)
    got = run(main, ["tune", "--device", "cpu", "--syn", syn, "--iters", "2"], capsys)
    assert [{k: v for k, v in r.items() if k != "seconds"} for r in got["table"]] == [
        {k: v for k, v in r.items() if k != "seconds"} for r in want["table"]
    ]
    assert all(r["seconds"] > 0 for r in got["table"])
    assert got["best"] in [{k: v for k, v in r.items() if k != "seconds"} for r in got["table"]]
    hybrid = [r for r in got["table"] if r["strategy"] == "hybrid"]
    assert len(hybrid) == 6 and {r["tile_dtype"] for r in hybrid} == {"bf16"}


def test_tune_hybrid_candidates_pack_one():
    """The port schedules its hybrid candidates at pack 1: no filler tiles."""
    from gnn_computing_tpu_torch.graph.synthetic import rmat_graph

    r = autotune.tune_hybrid(rmat_graph(600, 6000, seed=3, with_val=False), feature_len=8, thresholds=(4,),
                             tile_rows=(64,), iters=1, device="cpu")
    assert [c for c, _ in r.table] == [{"tile_rows": 64, "threshold": 4, "tile_dtype": d} for d in ("int8", "bf16")]
    assert r.best.tile.pack == 1 and r.best.tile_t is None


@pytest.mark.parametrize("cmd", ["bench", "tune", "train"])
def test_device_cuda_raises_without_a_card(cmd, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main([cmd, "--syn", "rmat:200:1000"])
    with pytest.raises(RuntimeError, match="cuda"):
        main([cmd, "--syn", "rmat:200:1000", "--device", "cuda"])


def test_module_entry_point():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "gnn_computing_tpu_torch", "info", "--syn", "rmat:256:2048"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["num_edges"] == 2048
