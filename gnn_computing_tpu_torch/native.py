"""ctypes binding for the repo's native host library (``csrc/gnnhost.cpp``).

Port of ``gnn_computing_tpu/native.py``: the same C entry points, bound
with the same argument types, behind the same Python functions.  The
library is compiled with ``g++ -O3 -std=c++17 -shared -fPIC`` at first use
into ``build/native/`` beside the package, keyed by a hash of the source
and the flags, so a checkout never writes into its tracked files.

Unlike the JAX module, nothing here falls back to numpy: a failed build or
load raises and says why.  (A numpy fallback of ``subgraph_compact``
would sample capped rows with a different generator than the library's
xorshift reservoir, so it would silently give another subgraph.)

Public surface:
  available()            -> bool (the library builds and loads)
  parse_ints(path)       -> int64[]        (text graph/reorder parsing)
  ng_schedule(indptr, B) -> (start, count, dst)
  jaccard_cluster(indptr, indices, pairs, cap) -> root[n]
  union_find_merge(n, pairs, cap) -> root[n]
  subgraph_compact(...)  -> (src, dst, rowptr)
  expand_frontier(...)   -> newly active ids
  scatter_add_f32, saturating_count_i8, counting_sort
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "csrc" / "gnnhost.cpp"
BUILD_DIR = REPO / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the build of ``csrc/gnnhost.cpp`` with GXX_FLAGS lives."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgnnhost_{digest}.so"


def _build(path: Path) -> None:
    """Compile the library into ``path`` (through a temporary file renamed
    into place, so a process that loads it never sees half a file)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"cannot build the host library ({' '.join(cmd)}): {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build the host library ({' '.join(cmd)}):\n{r.stderr}")
    os.replace(tmp, path)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, i32, u8 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint8
    f32, i8, u64 = ctypes.c_float, ctypes.c_int8, ctypes.c_uint64
    P = ctypes.POINTER
    table = {
        "gs_parse_ints": (i64, [ctypes.c_char_p, P(i64), i64]),
        "gs_ng_schedule": (i64, [i64, P(i32), i64, P(i64), P(i32), P(i32)]),
        "gs_union_find_merge": (None, [i64, i64, P(i64), i64, P(i64)]),
        "gs_subgraph_compact": (i64, [i64, P(i32), P(i32), P(i32), P(u8), P(i64), i64, u64, P(i32), P(i32), P(i64)]),
        "gs_expand_frontier": (i64, [i64, P(i32), P(i32), P(i32), P(u8), P(i32), i64]),
        "gs_scatter_add_f32": (None, [i64, P(i64), P(f32), P(f32)]),
        "gs_saturating_count_i8": (None, [i64, P(i64), i64, P(i8), P(u8)]),
        "gs_counting_sort": (None, [i64, P(i64), i64, P(i64), P(i64)]),
        "gs_jaccard_cluster": (None, [i64, P(i64), P(i32), i64, P(i64), i64, P(i64)]),
    }
    for name, (restype, argtypes) in table.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def load() -> ctypes.CDLL:
    """The bound library, built first if this source has no build yet.
    Raises RuntimeError when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not SRC.exists():
            raise RuntimeError(f"host library source {SRC} is missing")
        path = library_path()
        if not path.exists():
            _build(path)
        try:
            _lib = _bind(ctypes.CDLL(str(path)))
        except (OSError, AttributeError) as e:
            raise RuntimeError(f"cannot load the host library {path}: {e}") from e
        return _lib


def available() -> bool:
    """Whether the library builds and loads (nothing falls back when it
    does not: every entry point then raises)."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def parse_ints(path: str) -> np.ndarray:
    """All whitespace-separated ints in a text file (mmap'd native
    scanner)."""
    lib = load()
    count = lib.gs_parse_ints(os.fsencode(path), None, 0)
    if count < 0:
        raise IOError(f"cannot read {path}")
    out = np.empty(count, dtype=np.int64)
    got = lib.gs_parse_ints(os.fsencode(path), _ptr(out, ctypes.c_int64), count)
    if got != count:
        raise IOError(f"{path} changed while it was read ({got} ints, then {count})")
    return out


def ng_schedule(indptr: np.ndarray, block: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Neighbor-grouping tasks of at most ``block`` edges a row: (start
    edge int64, count int32, dst int32)."""
    lib = load()
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    n = len(indptr) - 1
    num = lib.gs_ng_schedule(n, _ptr(indptr, ctypes.c_int32), block, None, None, None)
    start = np.empty(num, dtype=np.int64)
    count = np.empty(num, dtype=np.int32)
    dst = np.empty(num, dtype=np.int32)
    lib.gs_ng_schedule(
        n, _ptr(indptr, ctypes.c_int32), block,
        _ptr(start, ctypes.c_int64), _ptr(count, ctypes.c_int32), _ptr(dst, ctypes.c_int32),
    )
    return start, count, dst


def jaccard_cluster(indptr: np.ndarray, indices: np.ndarray, pairs: np.ndarray, cap: int) -> np.ndarray:
    """Exact-Jaccard priority-queue agglomeration over the LSH candidate
    ``pairs`` (int64[npairs, 2]), clusters capped at ``cap``; root[n]."""
    lib = load()
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    pairs = np.ascontiguousarray(pairs, dtype=np.int64)
    n = len(indptr) - 1
    root = np.empty(n, dtype=np.int64)
    lib.gs_jaccard_cluster(
        n, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        len(pairs), _ptr(pairs, ctypes.c_int64), cap, _ptr(root, ctypes.c_int64),
    )
    return root


def union_find_merge(n: int, pairs: np.ndarray, cap: int) -> np.ndarray:
    """pairs: int64[npairs, 2] best-first; returns root[n]."""
    lib = load()
    pairs = np.ascontiguousarray(pairs, dtype=np.int64)
    root = np.empty(n, dtype=np.int64)
    lib.gs_union_find_merge(n, len(pairs), _ptr(pairs, ctypes.c_int64), cap, _ptr(root, ctypes.c_int64))
    return root


def subgraph_compact(
    vertices: np.ndarray,
    indptr: np.ndarray,
    indices: np.ndarray,
    active: np.ndarray,
    renum: np.ndarray,
    cap: int = 0,
    seed: int = 123,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Edges among the active vertices, renumbered, rows capped at ``cap``
    sources by the library's seeded reservoir (0: no cap): (src int32,
    dst int32, rowptr int64)."""
    lib = load()
    vertices = np.ascontiguousarray(vertices, dtype=np.int32)
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    active = np.ascontiguousarray(active, dtype=np.uint8)
    renum = np.ascontiguousarray(renum, dtype=np.int64)
    num_v = len(vertices)
    args = (
        num_v, _ptr(vertices, ctypes.c_int32), _ptr(indptr, ctypes.c_int32), _ptr(indices, ctypes.c_int32),
        _ptr(active, ctypes.c_uint8), _ptr(renum, ctypes.c_int64), cap, seed,
    )
    total = lib.gs_subgraph_compact(*args, None, None, None)
    src = np.empty(total, dtype=np.int32)
    dst = np.empty(total, dtype=np.int32)
    rowptr = np.empty(num_v + 1, dtype=np.int64)
    lib.gs_subgraph_compact(
        *args, _ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32), _ptr(rowptr, ctypes.c_int64)
    )
    return src, dst, rowptr


def expand_frontier(frontier: np.ndarray, indptr: np.ndarray, indices: np.ndarray, active: np.ndarray) -> np.ndarray:
    """One hop; mutates ``active`` (uint8, C-contiguous) in place, returns
    the newly active ids."""
    lib = load()
    frontier = np.ascontiguousarray(frontier, dtype=np.int32)
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    if active.dtype != np.uint8 or not active.flags.c_contiguous:
        raise ValueError("active must be a C-contiguous uint8 array")
    cap = len(indices)
    out = np.empty(cap, dtype=np.int32)
    cnt = lib.gs_expand_frontier(
        len(frontier), _ptr(frontier, ctypes.c_int32), _ptr(indptr, ctypes.c_int32),
        _ptr(indices, ctypes.c_int32), _ptr(active, ctypes.c_uint8), _ptr(out, ctypes.c_int32), cap,
    )
    return out[:cnt].copy()


def scatter_add_f32(flat: np.ndarray, val: np.ndarray, out: np.ndarray) -> None:
    """out[flat] += val (flat int64, out a C-contiguous float32 buffer)."""
    lib = load()
    flat = np.ascontiguousarray(flat, dtype=np.int64)
    val = np.ascontiguousarray(val, dtype=np.float32)
    if out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError("out must be a C-contiguous float32 array")
    lib.gs_scatter_add_f32(len(flat), _ptr(flat, ctypes.c_int64), _ptr(val, ctypes.c_float), _ptr(out, ctypes.c_float))


def saturating_count_i8(flat: np.ndarray, cap: int, out: np.ndarray) -> np.ndarray:
    """out[flat] saturating-increment up to cap; returns the bool spill
    mask (True where the edge exceeded the cap)."""
    lib = load()
    flat = np.ascontiguousarray(flat, dtype=np.int64)
    if out.dtype != np.int8 or not out.flags.c_contiguous:
        raise ValueError("out must be a C-contiguous int8 array")
    spill = np.empty(len(flat), dtype=np.uint8)
    lib.gs_saturating_count_i8(
        len(flat), _ptr(flat, ctypes.c_int64), int(cap), _ptr(out, ctypes.c_int8), _ptr(spill, ctypes.c_uint8)
    )
    return spill.astype(bool)


def counting_sort(key: np.ndarray, nbins: int) -> np.ndarray:
    """Stable ascending-by-key permutation (int64 keys < nbins), O(m+nbins)."""
    lib = load()
    key = np.ascontiguousarray(key, dtype=np.int64)
    scratch = np.empty(nbins, dtype=np.int64)
    order = np.empty(len(key), dtype=np.int64)
    lib.gs_counting_sort(
        len(key), _ptr(key, ctypes.c_int64), int(nbins), _ptr(scratch, ctypes.c_int64), _ptr(order, ctypes.c_int64)
    )
    return order
