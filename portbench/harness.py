"""One run of one cell: set-up, the measured window, the trace, the comparison.

Set-up (counted in ``setup_s``, from the process's start to the first timed
step): the traffic's graph drawn on the device (``inputs.graph``), then the
program's own set-up through its public API, timed as the ``plan`` span:
the reorder the traffic names (a function of the port, such as
``graph.reorder.degree_sort``), ``CSRGraph.reorder`` and
``Aggregator.schedule_hybrid`` with the traffic's plan; then the seed's
features, labels and weights.  A training cell then builds one step
object (``models.training.make_train_step`` over the model's forward and
``torch.optim.Adam``) and drives it from the drawn weights through its
first three steps, which warm every shape and are what the reference
follows; a forward cell runs its forward twice.  The window then runs the
same object back to back, one caller, for ``seconds``.

After the window: the device's peak memory is read, the traced window
(``--trace 1``) is taken and read, the program's state is freed, and the
reference runs in float64 on the harness's own inputs in the vertex order
drawn.  The program's losses and leaves do not depend on the vertex order;
its forward's rows are put back into the drawn order through the
permutation the program's reorder gave.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import time

import numpy as np
import torch

from portbench import compare, flops, inputs, spec, trace
from portbench.reference import common as ref_common

WARM_STEPS = 3  # the steps the reference follows
TRACE_STEPS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "gnn_computing_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX package's."""
    import sys

    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def counters() -> dict:
    """The ops' launch counters by kernel (B2 with its factored modes)."""
    from gnn_computing_tpu_torch.ops import cuda_bcsr, cuda_gat, cuda_gat_bwd, cuda_rowmax, cuda_sddmm

    return dict(B1=cuda_bcsr.launches, B2=cuda_gat.launches + cuda_gat.twodot_launches + cuda_gat.merged_launches,
                B3=cuda_gat_bwd.dad_launches, B4=cuda_gat_bwd.dh_das_launches, B5=cuda_rowmax.launches,
                B6=cuda_sddmm.launches)


def load_reader(name: str):
    """The per-layer metric reader of ``name``: ``metrics/<base>.py`` (its
    ``read``), where the base is the name up to its first dot; the part
    after it (``mfu.train``, ``mfu.forward``) only splits the metric by
    the end-to-end metric it moves, and BENCHMARK.json lists its cells."""
    return importlib.import_module("portbench.metrics." + name.split(".")[0]).read


class Window:
    """Step boundaries: CUDA events recorded on the stream (no sync between
    steps) on a card, the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


PROGRAM = "gnn_computing_tpu_torch"


def program_function(entry: dict):
    """The port's function that a traffic names: {"module", "function"},
    the module under the port's package (its top-level name, whole)."""
    if entry["module"].split(".")[0] != PROGRAM:
        raise ValueError(f"{entry['module']!r} is not a module of {PROGRAM}")
    return getattr(importlib.import_module(entry["module"]), entry["function"])


def tile_dtype(name):
    """A plan's tile type by name: None (float32 edge values), a numpy type
    ("int8") or a torch one ("bfloat16")."""
    if name is None:
        return None
    return getattr(np, name) if hasattr(np, name) else getattr(torch, name)


def _plan(graph, traffic: dict, device):
    """The program's set-up of the graph: the traffic's reorder (new -> old)
    and the hybrid plan over the reordered graph."""
    from gnn_computing_tpu_torch.aggregator import Aggregator
    from gnn_computing_tpu_torch.graph.csr import CSRGraph

    g = CSRGraph(indptr=graph.indptr.astype(np.int32), indices=graph.src.copy())
    reorder = traffic["reorder"]
    perm = program_function(reorder)(g, **reorder.get("args", {}))
    p = dict(traffic["plan"])
    agg = Aggregator.schedule_hybrid(g.reorder(perm), tile_dtype=tile_dtype(p.pop("tile_dtype")), device=device,
                                     **p)
    return perm, agg


@dataclasses.dataclass
class Planned:
    """The traffic's graph and the program's set-up of it, shared by every
    seed and configuration on that traffic."""

    graph: inputs.Graph
    perm_t: torch.Tensor  # the program's vertex order (new -> drawn)
    agg: object  # the program's Aggregator
    plan_s: float


def plan_graph(traffic: dict, device) -> Planned:
    """Draw the traffic's graph and run the program's set-up of it."""
    device = torch.device(device)
    graph = inputs.graph(traffic["graph"], device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)  # the peak is the program's, not the generator's
    tp = time.perf_counter()
    perm, agg = _plan(graph, traffic, device)
    plan_s = time.perf_counter() - tp
    return Planned(graph, torch.from_numpy(perm).to(device), agg, plan_s)


@dataclasses.dataclass
class Setup:
    """One seed's inputs and the program's set-up of them."""

    cell: spec.Cell
    model: object  # portbench.models.<model>
    seed: int
    device: torch.device
    graph: inputs.Graph
    w0: list  # the drawn weights, the leaves in order
    perm_t: torch.Tensor  # the program's vertex order (new -> drawn)
    agg: object  # the program's Aggregator
    h: torch.Tensor  # features in the program's order
    y: torch.Tensor | None  # labels in the program's order (training)
    plan_s: float

    @property
    def train(self) -> bool:
        return self.cell.traffic["pass"] == "train"


def prepare(cell: spec.Cell, seed: int, device, planned: Planned | None = None) -> Setup:
    """The traffic's graph and the program's set-up of it (``planned``, or
    anew), and the seed's data."""
    device = torch.device(device)
    cfg, tr = cell.config, cell.traffic
    model = importlib.import_module(f"portbench.models.{cfg['model']}")
    p = plan_graph(tr, device) if planned is None else planned
    n = p.graph.num_nodes
    w0 = model.weights(cfg, seed, device)
    h = inputs.features(cfg["dims"][0], seed, tr["features_scale"], n, device).index_select(0, p.perm_t)
    y = None
    if tr["pass"] == "train":
        y = inputs.labels(cfg["train"]["classes"], seed, n, device).index_select(0, p.perm_t)
    return Setup(cell, model, seed, device, p.graph, w0, p.perm_t, p.agg, h, y, p.plan_s)


def start(s: Setup):
    """(one, prog): the window's pass, one call of it, built once from the
    drawn weights and run through its first passes; ``prog`` holds what
    the comparison reads of them (training: the three steps' losses, the
    first gradient from Adam's state, the leaves' change)."""
    cfg = s.cell.config
    leaves = [w.clone().requires_grad_(s.train) for w in s.w0]
    forward = s.model.program(cfg, s.agg, leaves)
    if not s.train:
        def one():
            with torch.no_grad():
                return forward(s.h)

        one()
        return one, {"out": one()}

    from gnn_computing_tpu_torch.models.training import make_train_step

    t = cfg["train"]
    opt = torch.optim.Adam(leaves, lr=t["lr"], betas=tuple(t["betas"]), eps=t["eps"])
    step = make_train_step(forward, opt, device=s.device)
    h, y = s.h, s.y

    def one():
        return step((h,), y)

    prog, losses = {}, []
    for k in range(WARM_STEPS):
        losses.append(one())
        if k == 0:
            prog["grads"] = [
                opt.state[p]["exp_avg"].detach() / (1.0 - t["betas"][0]) if "exp_avg" in opt.state[p]
                else torch.zeros_like(p) for p in leaves]
    prog["losses"] = [float(x) for x in losses]
    prog["changes"] = [p.detach() - w for p, w in zip(leaves, s.w0)]
    return one, prog


@dataclasses.dataclass
class Measured:
    attempted: int
    failed: int
    window_s: float
    steps_ms: list  # each completed pass's device time between step-boundary events
    out: object  # the last pass's output

    @property
    def mean_ms(self) -> float:
        return self.window_s * 1e3 / max(len(self.steps_ms), 1)


def measure(one, seconds: float, device, log=print) -> Measured:
    """Passes back to back until ``seconds`` have gone by on the host
    clock, then a synchronize: the window's time over the passes completed
    in it.  A pass that raises or gives a value that is not finite fails."""
    win = Window(device)
    bad = torch.zeros((), dtype=torch.int64, device=device)
    attempted = failed = 0
    out = None
    _sync(device)
    w_start = time.perf_counter()
    win.mark()
    while True:
        attempted += 1
        try:
            out = one()
        except RuntimeError as e:  # counted, and the window ends: the device's state is unknown
            log(f"pass {attempted} raised: {e}")
            failed += 1
            break
        bad += ~torch.isfinite(out).all()
        win.mark()
        if time.perf_counter() - w_start >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - w_start
    return Measured(attempted, failed + int(bad), window_s, win.step_ms(), out)


def run(cell: spec.Cell, seed: int, seconds: float, trace_on: bool, device, t0: float, log=print) -> dict:
    """One run; returns the result line's fields (checks last)."""
    device = torch.device(device)
    tr = cell.traffic
    s = prepare(cell, seed, device)
    c0 = counters()
    one, prog = start(s)
    c1 = counters()
    if not s.train:
        prog = None  # a forward cell is judged by the window's own last output
    _sync(device)
    setup_s = time.time() - t0
    log(f"set-up {setup_s:.3f} s (plan {s.plan_s:.3f} s)")

    w = measure(one, seconds, device, log)
    c2 = counters()
    p95 = float(np.percentile(w.steps_ms, 95)) if w.steps_ms else math.nan
    log(f"window {w.window_s:.3f} s, {len(w.steps_ms)} passes, {w.mean_ms:.4f} ms each, p95 {p95:.4f} ms")
    log(f"B5 launches (the 'bound' rescue's row max): set-up steps {c1['B5'] - c0['B5']}, "
        f"window {c2['B5'] - c1['B5']}")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    metrics = {}
    for mt in cell.end_to_end:
        name = mt["name"]
        if name == "setup_s":
            value = setup_s
        elif name.endswith(".p95"):
            value = p95
        elif name.split(".")[0].endswith("_ms"):
            value = w.mean_ms
        else:
            raise KeyError(f"the harness measures no end-to-end metric {name!r}")
        metrics[name] = {"value": value, "unit": mt["unit"]}

    result = {"attempted": w.attempted, "failed": w.failed}
    dev_info = {}
    if trace_on:
        n, m = int(tr["graph"]["n"]), int(tr["graph"]["m"])
        ctx = {"plan_s": s.plan_s, "step_s": w.mean_ms / 1e3,
               "useful_flops": s.model.useful_flops(cell.config, n, m, s.train)}
        if device.type == "cuda":
            events, agreed, moved = trace.capture(one, TRACE_STEPS, counters, lambda: _sync(device))
            summ = trace.summarize(events)
            del events
            ctx.update(summary=summ, launches_agree=agreed, counters=moved,
                       bounds=_tile_bounds(s, moved, summ.steps, log))
            dev_info = {"busy_s": summ.busy_s, "window_s": summ.window_s}
            result["breakdown"] = {"device_ops": summ.device_ops, "idle_gaps": summ.idle_gaps}
            log(f"trace: {summ.steps} passes, launches agree {agreed}, counters {moved}, "
                f"busy {summ.busy_s:.6f} of {summ.window_s:.6f} s, classes {summ.class_s}")
        for mt in cell.per_layer:
            value = load_reader(mt["name"])(ctx)
            if value is not None:
                metrics[mt["name"]] = {"value": value, "unit": mt["unit"]}

    if not s.train:
        prog = {"out": w.out}
    del one, w.out
    tc = time.perf_counter()
    numbers = reference_numbers(s, [prog])[0]
    if "left_out" in numbers:
        log(f"update_gap leaves out (leaf, reference gradient norm, median leaf's): {numbers['left_out']}")
    correct, checks = compare.judge(numbers, cell.limits)
    log(f"reference and comparison {time.perf_counter() - tc:.3f} s")
    result.update(
        correct=bool(correct and w.failed == 0 and w.steps_ms),
        metrics=metrics,
        device={"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": cell.chips, "memory_peak_bytes": int(peak), **dev_info},
        checks=checks,
    )
    return result


def _tile_bounds(s: Setup, moved: dict, steps: int, log):
    """Seconds of the tile kernels' least time over the traced passes'
    predicted launches, or None where the counters show fewer.  Launches
    beyond the prediction (the GAT's rescue of rows: B5 and a second B2
    pass) add device time and no bound: the share reads low, never high."""
    parts = {"fwd": s.agg.tile_parts(), "t": s.agg.tile_parts_t()}
    stats = {k: [flops.part_stats(p) for p in v] for k, v in parts.items()}
    expect, bound = {}, 0.0
    for kernel, side, f in s.model.tile_launches(s.cell.config, s.train):
        for ps in stats[side]:
            expect[kernel] = expect.get(kernel, 0) + steps
            bound += steps * flops.launch_bound_s(ps, f)
    if any(moved.get(k, 0) < v for k, v in expect.items()):
        log(f"tile launches: counted {moved}, the pass predicts {expect}: no roofline")
        return None
    if moved != expect:
        log(f"tile launches: counted {moved}, the pass predicts {expect}: the extra ones get no bound")
    return bound


def reference_numbers(s: Setup, progs: list) -> list:
    """Free the program's state held by ``s``, run the float64 reference
    once and compare each of ``progs`` with it."""
    s.agg = s.h = s.y = None
    gc.collect()
    if s.device.type == "cuda":
        torch.cuda.empty_cache()
    cfg, tr = s.cell.config, s.cell.traffic
    ref = importlib.import_module(f"portbench.reference.{cfg['model']}")
    edges = ref_common.Edges.from_graph(s.graph, s.device)
    n = s.graph.num_nodes
    x = inputs.features(cfg["dims"][0], s.seed, tr["features_scale"], n, s.device)
    if s.train:
        labels = inputs.labels(cfg["train"]["classes"], s.seed, n, s.device)
        r = ref_common.train(ref, cfg, edges, x, labels, s.w0, steps=WARM_STEPS)
        return [compare.train_numbers(p, r) for p in progs]
    r = ref.forward(cfg, edges, x, s.w0)
    del x, edges
    numbers = []
    for p in progs:
        aligned = torch.empty_like(p["out"])
        aligned[s.perm_t] = p["out"]
        numbers.append(compare.forward_numbers(aligned, r))
    return numbers
