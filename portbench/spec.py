"""Cells, configurations, traffic mixes and limits, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells; a cell's
configuration is the file that its ``configs`` entry names, its traffic mix
is ``traffic/<traffic>.json`` and the limits of its comparison are
``limits/<cell>.json``.  A later cell adds files and entries here and edits
none.
"""

from __future__ import annotations

import dataclasses
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple  # the BENCHMARK.json entries of the metrics this cell reports
    per_layer: tuple


def _reported(metrics, cell: str) -> tuple:
    return tuple(m for m in metrics if "workloads" not in m or cell in m["workloads"])


def benchmark() -> dict:
    return load_json(os.path.join(CHECKOUT, "BENCHMARK.json"))


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files loaded; raises
    KeyError for a name the benchmark does not list."""
    bench = benchmark() if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(os.path.join(CHECKOUT, cfg_entry["file"])),
        traffic=load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
        limits=load_json(os.path.join(HERE, "limits", name + ".json")),
        end_to_end=_reported(bench["end_to_end"], name),
        per_layer=_reported(bench["per_layer"], name),
    )
