"""The comparison that decides ``correct``: the program's numbers against the
plain reference's, each held to its limit in ``limits/<cell>.json``.

A training cell compares what its first three steps, run through the
window's own step object in set-up, left behind:

* ``loss_gap``: the largest |L_prog - L_ref| / |L_ref| over the three steps;
* ``grad_gap``: the worst leaf's gap between the norms of the first step's
  gradient (the program's read back from Adam's first moment after one
  step, m_1 = (1 - beta1) g_1), against the larger of the reference leaf's
  norm and the median leaf's;
* ``update_gap``: the same of each leaf's change after the three steps,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's (Adam moves those by round-off alone: its first steps
  move an element by about the learning rate whatever its gradient's size).

A forward cell compares the window's last output, row by row:

* ``out_gap``: the largest ||y_i - r_i|| / max(||r_i||, the median nonzero
  row norm) over the rows.

A gap of norms, not the norm of a difference: a leaf whose gradient is all
but zero flips Adam's step by rounding and would read as wrong.
"""

from __future__ import annotations

import math
import statistics

import torch

SMALL_LEAF = 1e-3  # a leaf under this share of the median leaf's gradient moves by round-off


def _worst_leaf_gap(prog: list, ref: list, keep=None) -> float:
    """The largest |norm(prog) - norm(ref)| / max(norm(ref), median leaf
    norm) over the kept leaves."""
    pn = [float(torch.linalg.vector_norm(p.double())) for p in prog]
    rn = [float(torch.linalg.vector_norm(r.double())) for r in ref]
    med = statistics.median(rn)
    if med <= 0:
        return math.inf
    return max(abs(p - r) / max(r, med) for i, (p, r) in enumerate(zip(pn, rn)) if keep is None or keep[i])


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"losses": [3 floats], "grads": [leaves],
    "changes": [leaves]}.  Beside the numbers compared, ``left_out`` lists
    the leaves that ``update_gap`` leaves out: [leaf, reference gradient
    norm, the median leaf's]."""
    losses = [abs(p - r) / abs(r) if r else math.inf for p, r in zip(prog["losses"], ref["losses"])]
    rn = [float(torch.linalg.vector_norm(g.double())) for g in ref["grads"]]
    med = statistics.median(rn)
    keep = [r >= SMALL_LEAF * med for r in rn]
    return {
        "loss_gap": max(losses) if len(losses) == len(ref["losses"]) else math.inf,
        "grad_gap": _worst_leaf_gap(prog["grads"], ref["grads"]),
        "update_gap": _worst_leaf_gap(prog["changes"], ref["changes"], keep),
        "left_out": [[i, r, med] for i, (r, k) in enumerate(zip(rn, keep)) if not k],
    }


def forward_numbers(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """``out`` in the reference's row order."""
    rn = torch.linalg.vector_norm(ref, dim=1)
    diff = torch.linalg.vector_norm(out.double() - ref, dim=1)
    nonzero = rn[rn > 0]
    med = float(nonzero.median()) if nonzero.numel() else 0.0
    if med == 0.0:
        return {"out_gap": math.inf}
    return {"out_gap": float((diff / torch.clamp(rn, min=med)).max())}


def judge(numbers: dict, limits: dict) -> tuple:
    """(every number finite and within its limit, {name: {"value", "limit"}})."""
    checks = {k: {"value": numbers.get(k, math.nan), "limit": v} for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
