"""Build and load the port's CUDA kernel libraries.

Each kernel source ``csrc/<name>.cu`` has a plain C interface (no PyTorch
headers, so a build takes seconds) and is compiled with ``nvcc`` for
``sm_90a`` into ``build/kernels/`` beside the package, keyed by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, then bound
with ctypes.  The compiler's report
(registers, spills) is kept beside each library as ``.log``.

``build_all`` starts one ``nvcc`` per source, all at once, and waits for
them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

from gnn_computing_tpu_torch.utils.profiling import span

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
KERNELS = (
    "bcsr_spmm", "gat_bcsr", "rowmax_bcsr", "gat_bwd_dad", "gat_bwd_dh_das", "sddmm_bcsr",
    "gat_bcsr_factored", "task_sums", "fused_hybrid",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        cuda_home and os.path.join(cuda_home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` with NVCC_FLAGS lives."""
    content = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(content + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, Tuple[Path, float]]:
    """Compile every named source that has no build of its exact content
    yet, one nvcc process each, all running at once.  Returns name ->
    (library path, seconds its nvcc ran; 0 for a build found in place);
    raises naming every source that failed to build."""
    libs = {name: library_path(name) for name in names}
    seconds = {name: 0.0 for name in libs}
    running = {}
    for name, lib in libs.items():
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        with open(lib.with_suffix(".log"), "w") as log:
            proc = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT,
            )
        running[name] = (tmp, proc, time.perf_counter())
    failed = []
    while running:
        for name, (tmp, proc, start) in list(running.items()):
            if proc.poll() is None:
                continue
            del running[name]
            seconds[name] = time.perf_counter() - start
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{libs[name].with_suffix('.log').read_text()}")
            else:
                os.replace(tmp, libs[name])
        if running:
            time.sleep(0.02)
    if failed:
        raise RuntimeError("nvcc failed building " + "\n".join(failed))
    return {name: (libs[name], seconds[name]) for name in libs}


def build(name: str) -> Path:
    return build_all((name,))[name][0]


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built if needed), with
    ``argtypes`` set from ``signatures`` (function -> argument types) and
    every function returning a cudaError_t as int.  A first load is
    recorded as the span ``gnn.build`` (attrs ``kernel``, and ``cached``:
    the build was found in place)."""
    lib = _loaded.get(name)
    if lib is None:
        with span("gnn.build", kernel=name, cached=library_path(name).exists()):
            lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check_tensor(x, name: str, dtype, shape, device):
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: the kernels take raw pointers and trust these."""
    if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {'contiguous' if x.is_contiguous() else 'strided'} {x.dtype} "
            f"{tuple(x.shape)} on {x.device}"
        )


# TilePlan.format -> the tag of a kernel's entry point for that A format
FORMAT_TAGS = {"int8": "i8", "bits": "b1", "float32": "f32", "bfloat16": "bf16"}
TAGS = tuple(FORMAT_TAGS.values())


def check_plan(tp, device) -> str:
    """Raise unless the plan's tiles, ``tile_col`` and ``run_start`` are what
    a run-walking tile kernel takes on ``device``: int8 [T, R, C] counts,
    1-bit uint8 [T, R/8, C] with R % 8 == 0, or float32 / bfloat16
    [T, R, C] values.  Returns the tag of the A format's entry point ('i8',
    'b1', 'f32' or 'bf16')."""
    t, r, c = tp.num_tiles, tp.tile_rows, tp.tile_cols
    tag = FORMAT_TAGS[tp.format]
    if tp.bits:
        if r % 8:
            raise ValueError(f"1-bit tiles need R % 8 == 0, got R = {r}")
        check_tensor(tp.a, "a", torch.uint8, (t, r // 8, c), device)
    else:
        check_tensor(tp.a, "a", {"i8": torch.int8, "f32": torch.float32, "bf16": torch.bfloat16}[tag], (t, r, c), device)
    check_tensor(tp.tile_col, "tile_col", torch.int32, (t,), device)
    check_tensor(tp.run_start, "run_start", torch.int32, (tp.num_row_tiles + 1,), device)
    return tag


def check_no_grad(*tensors):
    """Raise if grad is enabled and a tensor requires it: a kernel's output
    carries no graph, so outside the ops' autograd Functions (which launch
    the kernels with grad off) it would silently drop that gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "a CUDA kernel wrapper was called on a tensor that requires grad; "
            "go through the differentiable ops (hybrid_spmm, hybrid_gat) or torch.no_grad()"
        )


def stream_args(device) -> tuple:
    """(device index, current stream handle) for a kernel launch."""
    return (
        device.index if device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(device).cuda_stream,
    )
