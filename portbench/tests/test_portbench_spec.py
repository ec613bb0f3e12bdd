"""Every cell of BENCHMARK.json finds its configuration, traffic mix, limits
and metric readers by name, and the file keeps to BENCHMARK.json's limits on names, units and sizes."""

import json
import os
import re

import pytest

from portbench import harness, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(name):
    cell = spec.cell(name)
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert cell.traffic["pass"] in ("train", "forward")
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.load_reader(m["name"]))
        assert m["moves"] in reported


def test_names_units_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for k in ("end_to_end", "per_layer") for m in BENCH[k])
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(spec.CHECKOUT, c["file"]))
        assert c["reduced"] == []
    assert os.path.getsize(os.path.join(spec.CHECKOUT, "BENCHMARK.json")) < 64 * 1024
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert json.loads(json.dumps(BENCH)) == BENCH


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such.cell")


def test_metric_readers_by_base_name():
    assert harness.load_reader("mfu.train") is harness.load_reader("mfu.gat") is harness.load_reader("mfu")
    assert harness.load_reader("plan_s")({"plan_s": 3.5}) == 3.5


def test_traffic_names_its_program_functions_and_types():
    import numpy as np
    import torch

    from gnn_computing_tpu_torch.graph import reorder

    assert harness.program_function({"module": "gnn_computing_tpu_torch.graph.reorder",
                                     "function": "label_propagation_reorder"}) is reorder.label_propagation_reorder
    with pytest.raises(ValueError):
        harness.program_function({"module": "gnn_computing_tpu.graph", "function": "degree_sort"})
    assert harness.tile_dtype("int8") is np.int8
    assert harness.tile_dtype("bfloat16") is torch.bfloat16
    assert harness.tile_dtype(None) is None


def test_graph_kind_names_its_generator():
    from portbench import inputs

    g = inputs.graph({"kind": "rmat", "n": 100, "m": 1000, "a": 0.57, "b": 0.19, "c": 0.19, "structure_seed": 5},
                     "cpu")
    assert g.num_nodes == 100 and g.num_edges == 1000 and g.indptr[-1] == 1000
    with pytest.raises(ModuleNotFoundError):
        inputs.graph({"kind": "no_such_kind"}, "cpu")
