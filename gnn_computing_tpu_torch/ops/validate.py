"""Validation gate, a copy of ``gnn_computing_tpu/ops/validate.py``:
an element passes when |y - ref| <= rtol*|ref| + atol (rtol 1e-2 as the
reference's ``validate2``; atol 1e-5 for cancellation against f64 oracles).
Inputs may be numpy arrays or tensors on any device."""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_RTOL = 1e-2
DEFAULT_ATOL = 1e-5


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, dtype=np.float64)


def relative_error_count(y, y_ref, rtol: float = DEFAULT_RTOL, atol: float = DEFAULT_ATOL) -> int:
    """Number of elements failing |y - ref| <= rtol*|ref| + atol."""
    y, y_ref = _f64(y), _f64(y_ref)
    return int((np.abs(y - y_ref) > rtol * np.abs(y_ref) + atol).sum())


def valid(y, y_ref, rtol: float = DEFAULT_RTOL, atol: float = DEFAULT_ATOL) -> bool:
    return relative_error_count(y, y_ref, rtol, atol) == 0


def valid_reordered(y_reordered, y_ref, rows, rtol: float = DEFAULT_RTOL, atol: float = DEFAULT_ATOL) -> bool:
    """A run on the reordered graph against an unreordered reference: row
    ``i`` of the reordered output is original row ``rows[i]`` (the
    reference's validateReordered)."""
    return valid(y_reordered, _f64(y_ref)[np.asarray(rows, dtype=np.int64)], rtol, atol)


def assert_valid(y, y_ref, rtol: float = DEFAULT_RTOL, atol: float = DEFAULT_ATOL, what: str = ""):
    bad = relative_error_count(y, y_ref, rtol, atol)
    if bad:
        raise AssertionError(f"{what}: {bad} elements exceed rtol={rtol}/atol={atol}")
