"""GAT attention aggregation over dense tiles, hybrid with the residual.

Port of ``gnn_computing_tpu/ops/bcsr_gat.py``.  A tile cell (i, j) with
value v (an edge count, or a float tile's summed edge values) scores

  s_ij = v * exp(lrelu(ad_i + as_j) - M_i),   lrelu(z) = max(z, slope z),

with ad / as the dst / src halves of att and M a per-destination shift
(0 unstabilized).  num and den are the score-weighted sums of h and of 1
over the tiles.  The score is formed from ad, as and M for every cell whose
value is nonzero, and a cell whose value is 0 is never scored: a non-edge
cell is exactly 0, and its exp can overflow (0 * inf = NaN).  Selecting on
v != 0 rather than v > 0 keeps the negative cells of a signed float plan,
which the JAX forward multiplies in like any other (``gat_bcsr_xla`` has
no mask); so the forward equals the JAX package's on every plan, and the
backward below is the true gradient of that forward (the JAX backward masks
v > 0, so on a signed plan its gradient is not its forward's).  The row
max of ``stabilize=True`` (B5) runs over the same cells, so every scored
cell has |s| <= |v|.  With the exact or the bound shift every score is then
bounded by its cell's value and nothing overflows.  The JAX package factors
it into per-node exponentials u12_i = exp((ad_i, s ad_i) - M_i) and
v12_j = exp((as_j, s as_j)); v1_j overflows once as_j > ~88.7 whatever the
shift, a fault the port does not copy.  ``gat_bcsr`` launches the B2 kernel
(ops.cuda_gat) on a CUDA tensor and runs ``gat_bcsr_plain`` on a CPU
tensor; there is no fallback between the two.  ``hybrid_gat`` adds the
residual part (ops.gat.gat_aggregate_parts) and divides.

dot_mode: the TPU kernel offers 'exact' (a float32-grade MXU dot) and
'split2' (score and h as ~16-bit bf16 chunks, error ~2^-16, a speed trade of
the TPU's matrix unit).  The port computes both alike in float32: the
cell value (an exact count, or a float32 / widened bfloat16 value) times a
float32 score, summed in float32, which meets both error classes.
'default' is the TPU's single bf16 pass: the numerator's product takes the
score and h each rounded once to bfloat16 (round to nearest even), summed
in float32; den stays the unrounded float32 sum.  The backward of a
'default' forward is the exact one, as in the JAX package.

Modes (``gat_bcsr_tiles``, the counterpart of ``gat_bcsr_pallas``):
'maxdot' scores every cell as above (B2).  'twodot' and 'merged' are the
TPU kernel's factored forms: per-node exponentials formed once
(``factored_terms``), and per cell only a compare and a select:

  u1_i = exp(ad_i + A1 - M_i)      v1_j = exp(as_j - A1)
  u2_i = exp(s ad_i + A2 - M_i)    v2_j = exp(s as_j - A2)
  q_i  = exp((s - 1) ad_i + B)     r_j  = exp((s - 1) as_j - B)

so that u_b,i v_b,j = exp(s_b z_ij - M_i) (s_1 = 1, s_2 = s) and q_i r_j =
exp((s - 1) z_ij), with A1, A2 and B the least multiples of ln 2 at or
above the largest as_j, s as_j and (s - 1) as_j: every v and r lies in
(0, 1], and each factor is the JAX package's (A1 = A2 = B = 0) times a
power of two, which bf16 rounding commutes with, so the port rounds the
very values the TPU kernel rounds, scaled.  The JAX package's v1_j =
exp(as_j) is inf past as_j ~ 88.7 (the C1 fault); the port's is not.
  twodot: num_i = u1_i sum_j bf16(a1_ij) hv1_j + u2_i sum_j bf16(a2_ij) hv2_j,
          den_i = u1_i sum_j a1_ij v1_j + u2_i sum_j a2_ij v2_j,
          a1 = v where z > 0, a2 = v where z <= 0 (selected on the cell's
          value v != 0, never multiplied);
  merged: a_m = v where z > 0, else v (q_i r_j); num_i = u1_i sum_j
          bf16(a_m) hv1_j, den_i = u1_i sum_j a_m v1_j;
hv_b = v_b o h rounded to ``hv_chunks`` bf16 residue chunks (1: one
rounding, ~2^-9; 2: ~2^-17), and bf16(x) rounds a float32 tile's value
(counts up to 256 stay exact); den is float32.
Rescue.  A row whose u1, u2 (twodot) or q (merged) exceeds FACTOR_MAX =
2^32, or is not finite, takes the maxdot result.  Under the exact shift
u_b,i <= 2 exp(A - max_{j in N(i)} as_j), so such a row is one whose
neighbors' as all lie more than ~22 below the largest as (or a row with
no tile cell); under no shift, a row with ad_i + A past ~22; for 'merged'
also a row with ad_i + min_j as_j below -22 / (1 - s) (-28 at s = 0.2).  The
'bound' shift keeps u1 and u2 <= 2; its C2 rescue rows then take the
exact shift.  Below the mark a v_j under float32's normal range belongs to
a score below 2^-62 of its row's largest (1 under the exact shift), which
float32 sums cannot see.  The factored kernel still runs for every row;
the rescue is one device-to-host read a call, and a maxdot pass over the
tiles when a row needs it, counted in ``rescued``.

Stabilizers (one shift M shared by every part, so the partial
denominators still merge exactly; it cancels in num/den):
  stabilize=True / 'exact': M_i = lrelu(ad_i + max over in-neighbors of as_j),
      over the tiles (bcsr_rowmax, kernel B5) and the residual;
  stabilize='bound': M_i = max(ad_i + A, s (ad_i + A)), A = max_j as_j: O(n),
      no pass over the adjacency.  A row whose neighbor max lies far below
      A sees every score shrink: past ~44 logits den < 2^-64 (the backward's
      ct / den can overflow), past ~100 every score underflows and den is
      0.  Such rows (|den| < 2^-64 with in-edges; the magnitude, since a
      signed plan's den may be negative) are found after the pass and
      get the exact shift, and the pass is redone (``_bound_rescue``).
      Finding them costs one device-to-host read of a flag a call; the
      rescue itself runs only when a row needs it.

Backward (``hybrid_gat`` is a ``torch.autograd.Function``, the JAX op's
custom VJP).  out_i = num_i / den_i with M a constant (it cancels in
num/den).  With gbar_i = ct_i / den_i and c_i = <ct_i, out_i> / den_i:

  dh_j   = sum_i s_ij gbar_i                               (transposed SpMM)
  d ad_i = sum_j lrelu'(z_ij) s_ij (<gbar_i, h_j> - c_i)   (row sums)
  d as_j = sum_i lrelu'(z_ij) s_ij (<gbar_i, h_j> - c_i)   (column sums)

with lrelu'(z) = 1 for z >= 0, else slope.  d_ad streams the forward tile
plan (``gat_bwd_dad``: the B3 kernel on CUDA), (dh, d_as) the transposed
one (``gat_bwd_dh_das``: B4); both score the cells as the forward does, from
(ad, M) per destination and as per source.  The residual has a flat
hand-written backward over the forward and transposed residual plans
(``_residual_bwd_flat``).  The JAX package's fallback of AD through the
forward when no transposed plans exist is not ported: the backward raises
and asks for them.

Every function here takes every tile format alike (int8 counts, 1-bit,
float32 and bfloat16 values): the plain versions read a chunk of values at
a time through ``TilePlan.counts``, the kernels read each format themselves
(csrc/bit_tiles.cuh).  Over a weighted plan the tiles weight each edge's
score by its value while the residual ignores the residual plan's values,
as in the JAX package: only count-valued plans give a well-defined GAT.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from gnn_computing_tpu_torch.ops import cuda_gat, cuda_gat_bwd
from gnn_computing_tpu_torch.ops.bcsr import bcsr_rowmax, count_residual
from gnn_computing_tpu_torch.ops.gat import DEFAULT_SLOPE, gat_aggregate_parts, leaky_relu, slot_mask
from gnn_computing_tpu_torch.ops.spmm import (
    bf16_residue_chunks,
    edge_values_from_slots_flat,
    sddmm_slots,
    slots_from_edge_values_flat,
    spmm_plain,
)
from gnn_computing_tpu_torch.schedule.plan import AggregationPlan
from gnn_computing_tpu_torch.schedule.tiles import TilePlan
from gnn_computing_tpu_torch.utils.profiling import span

DOT_MODES = ("exact", "split2", "default")
GAT_MODES = ("maxdot", "twodot", "merged")
HV_CHUNKS = (1, 2)
# a factored row with u1, u2 (or q) above this takes the maxdot result
FACTOR_MAX = 2.0**32
LN2 = math.log(2.0)

# rows of the factored modes rescued through maxdot, and the calls that did
rescued = {"calls": 0, "rows": 0}


def _score_terms(att: torch.Tensor, row_shift: Optional[torch.Tensor] = None):
    """(dm [n, 2] = (ad_i, M_i) per destination, as [n] per source): what a
    cell's score is formed from (module doc); M is 0 without a shift."""
    ad = att[:, 0].float()
    m = torch.zeros_like(ad) if row_shift is None else row_shift.float()
    return torch.stack([ad, m], dim=1), att[:, 1].float().contiguous()


def _cell_scores(a_c, ad, m, asrc, relu_slope: float):
    """(s, z) of a chunk of tiles: z = ad + as and s = v * exp(lrelu(z) - M)
    where the cell's value v is nonzero, else 0; ``ad``, ``m`` and ``asrc``
    broadcast to the chunk's [ch, R, C].  Select on v != 0 (module doc): a
    non-edge's exp can be inf, and 0 * inf = NaN."""
    z = ad + asrc
    s = torch.where(a_c != 0, a_c * torch.exp(leaky_relu(z, relu_slope) - m), 0.0)
    return s, z


def _pad_to(x: torch.Tensor, size: int) -> torch.Tensor:
    if x.shape[0] == size:
        return x
    out = x.new_zeros((size,) + tuple(x.shape[1:]))
    out[: x.shape[0]] = x
    return out


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded once to bfloat16 (nearest even), back in float32."""
    return x.to(torch.bfloat16).float()


def gat_bcsr_plain(
    tp: TilePlan,
    h: torch.Tensor,
    att: torch.Tensor,
    relu_slope: float = DEFAULT_SLOPE,
    row_shift: Optional[torch.Tensor] = None,
    chunk: int = 256,
    dot_mode: str = "exact",
):
    """Plain PyTorch (num [n, f], den [n]) of the tile edges, the counterpart
    of ``gat_bcsr_xla``: per chunk of tiles, every cell's score (module
    doc), then one batched matmul against the gathered [h | 1] operands (den
    packed in as the last column), added into the destination row-tiles.
    dot_mode 'default' takes the numerator's product over the scores and h
    each rounded to bfloat16, and den from the unrounded scores."""
    _check_dot_mode(dot_mode)
    tr, tc = tp.tile_rows, tp.tile_cols
    f = h.shape[-1]
    nct, nrt = tp.num_col_tiles, tp.num_row_tiles
    dm, asrc = _score_terms(att, row_shift)
    dmp = _pad_to(dm, nrt * tr).reshape(nrt, tr, 2)
    asp = _pad_to(asrc, nct * tc).reshape(nct, tc)
    hp = _pad_to(h.float(), nct * tc)
    bf16_dot = dot_mode == "default"
    if bf16_dot:
        hp = _bf16(hp)
    h1 = torch.cat([hp, torch.ones_like(hp[:, :1])], dim=1).reshape(nct, tc, f + 1)
    out_t = torch.zeros((nrt, tr, f + 1), dtype=torch.float32, device=h.device)
    for s0 in range(0, tp.num_tiles, chunk):
        col = tp.tile_col[s0 : s0 + chunk].long()
        row = tp.tile_row[s0 : s0 + chunk].long()
        d = dmp.index_select(0, row)
        s, _ = _cell_scores(
            tp.counts(s0, s0 + chunk).float(), d[:, :, 0, None], d[:, :, 1, None],
            asp.index_select(0, col)[:, None, :], relu_slope,
        )
        hc = h1.index_select(0, col)
        if bf16_dot:
            part = torch.cat([torch.bmm(_bf16(s), hc[:, :, :f]), s.sum(dim=2, keepdim=True)], dim=2)
        else:
            part = torch.bmm(s, hc)
        out_t.index_add_(0, row, part)
    out = out_t.reshape(nrt * tr, f + 1)[: tp.num_nodes]
    return out[:, :f], out[:, f]


def gat_bcsr(
    tp,
    h: torch.Tensor,
    att: torch.Tensor,
    relu_slope: float = DEFAULT_SLOPE,
    row_shift: Optional[torch.Tensor] = None,
    dot_mode: str = "exact",
):
    """(num, den) of the tile edges (mode 'maxdot').  ``tp`` is a TilePlan or
    a sequence of them whose partial sums add.  CUDA tensors go through the
    B2 kernel, CPU tensors through the plain version."""
    _check_dot_mode(dot_mode)
    if isinstance(tp, (tuple, list)):
        parts = [p for p in tp if p is not None and p.num_tiles]
        num, den = gat_bcsr(parts[0], h, att, relu_slope, row_shift, dot_mode)
        for p in parts[1:]:
            n2, d2 = gat_bcsr(p, h, att, relu_slope, row_shift, dot_mode)
            num, den = num + n2, den + d2
        return num, den
    if h.device.type == "cuda":
        if h.dtype != torch.float32:
            raise ValueError(f"the CUDA GAT tile kernel takes float32 h, got {h.dtype}")
        dm, asrc = _score_terms(att, row_shift)
        return cuda_gat.gat_bcsr_cuda(
            tp, h.contiguous(), dm[: tp.num_nodes].contiguous(), asrc[: tp.n_src].contiguous(), relu_slope,
            bf16_dot=dot_mode == "default",
        )
    if h.device.type == "cpu":
        return gat_bcsr_plain(tp, h, att, relu_slope, row_shift, dot_mode=dot_mode)
    raise ValueError(f"no GAT tile aggregation for device {h.device}")


def _check_dot_mode(dot_mode: str):
    if dot_mode not in DOT_MODES:
        raise ValueError(f"dot_mode must be one of {DOT_MODES}, got {dot_mode!r}")


class FactoredTerms(NamedTuple):
    """The per-node operands of the factored modes (module doc): ``rows``
    [n, 4] = (ad, u1, u2, q) per destination, ``cols`` [n_src, 4] = (as,
    v1, v2, r) per source, ``hv`` the [n_src, f] float32 operands (v_b o h
    rounded to ``hv_chunks`` bf16 chunks, the chunks added: one operand
    for 'merged', two for 'twodot'), and ``need`` (bool [n]): the rows to
    rescue."""

    rows: torch.Tensor
    cols: torch.Tensor
    hv: tuple
    need: torch.Tensor


def _ln2_ceil(x: torch.Tensor) -> torch.Tensor:
    """The least multiple of ln 2 >= x: a column shift by it scales the JAX
    package's factor by a power of two, which bf16 rounding commutes with."""
    return torch.ceil(x / LN2) * LN2


def factored_terms(
    h: torch.Tensor,
    att: torch.Tensor,
    relu_slope: float,
    mode: str,
    hv_chunks: int = 2,
    row_shift: Optional[torch.Tensor] = None,
) -> FactoredTerms:
    """The factored modes' per-node operands, formed once per node on h's
    device (module doc)."""
    if mode not in ("twodot", "merged"):
        raise ValueError(f"factored mode must be 'twodot' or 'merged', got {mode!r}")
    if hv_chunks not in HV_CHUNKS:
        raise ValueError(f"hv_chunks must be one of {HV_CHUNKS}, got {hv_chunks!r}")
    n_src = h.shape[0]
    s = float(relu_slope)
    ad = att[:, 0].float()
    asv = att[: n_src, 1].float()
    m = torch.zeros_like(ad) if row_shift is None else row_shift.float()
    a1, a2, b = (_ln2_ceil((c * asv).max() if n_src else ad.new_zeros(())) for c in (1.0, s, s - 1.0))
    u1 = torch.exp(ad + a1 - m)
    u2 = torch.exp(s * ad + a2 - m)
    q = torch.exp((s - 1.0) * ad + b)
    v1 = torch.exp(asv - a1)
    v2 = torch.exp(s * asv - a2)
    r = torch.exp((s - 1.0) * asv - b)
    rows = torch.stack([ad, u1, u2, q], dim=1).contiguous()
    cols = torch.stack([asv, v1, v2, r], dim=1).contiguous()

    def chunks(v):
        parts = bf16_residue_chunks(h.float() * v[:, None], hv_chunks)
        return parts[0].float() if hv_chunks == 1 else parts[0].float() + parts[1].float()

    ok = (u1 <= FACTOR_MAX) & ((u2 if mode == "twodot" else q) <= FACTOR_MAX)
    hv = (chunks(v1), chunks(v2)) if mode == "twodot" else (chunks(v1),)
    return FactoredTerms(rows, cols, hv, ~ok)


def _factored_chunk(tp: TilePlan, rows, cols, hv, mode: str, s0: int, chunk: int):
    """One chunk of tiles' factored sums from the row-tile / column-tile
    views of the operands: (the tiles' row-tile ids, [(P_b [ch, R, f]
    products, D_b [ch, R] den sums) per branch]) before the row post-scales."""
    col = tp.tile_col[s0 : s0 + chunk].long()
    row = tp.tile_row[s0 : s0 + chunk].long()
    rw, cl = rows.index_select(0, row), cols.index_select(0, col)
    hv = [x.index_select(0, col) for x in hv]
    v = tp.counts(s0, s0 + chunk).float()
    pos = (rw[:, :, 0, None] + cl[:, None, :, 0]) > 0.0
    edge = v != 0
    if mode == "twodot":
        a1 = torch.where(edge & pos, v, 0.0)
        a2 = torch.where(edge & ~pos, v, 0.0)
        return row, [
            (torch.bmm(_bf16(a1), hv[0]), (a1 * cl[:, None, :, 1]).sum(dim=2)),
            (torch.bmm(_bf16(a2), hv[1]), (a2 * cl[:, None, :, 2]).sum(dim=2)),
        ]
    qr = rw[:, :, 3, None] * cl[:, None, :, 3]
    am = torch.where(edge, torch.where(pos, v, v * qr), 0.0)
    return row, [(torch.bmm(_bf16(am), hv[0]), (am * cl[:, None, :, 1]).sum(dim=2))]


def _factored_sums(tp: TilePlan, terms: FactoredTerms, mode: str, chunk: int = 256):
    """(num, den) of a factored mode from its per-node operands, in chunks of
    tiles: each branch's products and den sums accumulate per row-tile, and
    the row post-scales u_b apply once at the end, as in the kernel."""
    tr, tc, nrt, nct, n = tp.tile_rows, tp.tile_cols, tp.num_row_tiles, tp.num_col_tiles, tp.num_nodes
    f = terms.hv[0].shape[-1]
    dev = terms.rows.device
    rows = _pad_to(terms.rows, nrt * tr).reshape(nrt, tr, 4)
    cols = _pad_to(terms.cols, nct * tc).reshape(nct, tc, 4)
    hv = [_pad_to(x, nct * tc).reshape(nct, tc, f) for x in terms.hv]
    acc = [
        (torch.zeros((nrt, tr, f), dtype=torch.float32, device=dev), torch.zeros((nrt, tr), dtype=torch.float32, device=dev))
        for _ in hv
    ]
    for s0 in range(0, tp.num_tiles, chunk):
        row, parts = _factored_chunk(tp, rows, cols, hv, mode, s0, chunk)
        for (acc_p, acc_d), (p, d) in zip(acc, parts):
            acc_p.index_add_(0, row, p)
            acc_d.index_add_(0, row, d)
    num = den = 0.0
    for b, (acc_p, acc_d) in enumerate(acc):
        u = terms.rows[:n, 1 + b]
        num = num + u[:, None] * acc_p.reshape(nrt * tr, f)[:n]
        den = den + u * acc_d.reshape(nrt * tr)[:n]
    return num, den


def gat_bcsr_twodot_plain(
    tp: TilePlan,
    h: torch.Tensor,
    att: torch.Tensor,
    relu_slope: float = DEFAULT_SLOPE,
    hv_chunks: int = 2,
    row_shift: Optional[torch.Tensor] = None,
):
    """Plain PyTorch (num, den) of mode 'twodot' (module doc), before the
    rescue: rows marked in ``factored_terms(...).need`` may be inf or NaN
    here."""
    return _factored_sums(tp, factored_terms(h, att, relu_slope, "twodot", hv_chunks, row_shift), "twodot")


def gat_bcsr_merged_plain(
    tp: TilePlan,
    h: torch.Tensor,
    att: torch.Tensor,
    relu_slope: float = DEFAULT_SLOPE,
    hv_chunks: int = 2,
    row_shift: Optional[torch.Tensor] = None,
):
    """Plain PyTorch (num, den) of mode 'merged' (module doc), before the
    rescue."""
    return _factored_sums(tp, factored_terms(h, att, relu_slope, "merged", hv_chunks, row_shift), "merged")


def gat_bcsr_factored(tp: TilePlan, h, att, relu_slope=DEFAULT_SLOPE, mode="twodot", hv_chunks=2, row_shift=None):
    """(num, den, need) of a factored mode over one tile plan, before the
    rescue: the factored kernel (ops.cuda_gat) on CUDA tensors, the plain
    version on CPU tensors; ``need`` marks the rows to rescue."""
    if h.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no GAT tile aggregation for device {h.device}")
    if h.device.type == "cuda" and h.dtype != torch.float32:
        raise ValueError(f"the CUDA GAT tile kernel takes float32 h, got {h.dtype}")
    terms = factored_terms(h, att, relu_slope, mode, hv_chunks, row_shift)
    need = terms.need[: tp.num_nodes]
    if h.device.type == "cuda":
        rows = terms.rows[: tp.num_nodes].contiguous()
        return (*cuda_gat.gat_bcsr_factored_cuda(tp, mode, terms.hv, rows, terms.cols), need)
    return (*_factored_sums(tp, terms, mode), need)


def gat_bcsr_tiles(
    tp,
    h: torch.Tensor,
    att: torch.Tensor,
    relu_slope: float = DEFAULT_SLOPE,
    mode: str = "maxdot",
    hv_chunks: int = 2,
    row_shift: Optional[torch.Tensor] = None,
    dot_mode: str = "exact",
):
    """(num, den) of the tile edges in ``mode`` (module doc), the counterpart
    of ``gat_bcsr_pallas`` (the port schedules with pack 1, so there is no
    ``pack``).  ``tp`` is a TilePlan or a sequence of them.  'maxdot' is
    ``gat_bcsr`` with ``dot_mode``; 'twodot' and 'merged' ignore dot_mode,
    as the TPU kernel does.  Rows the factored form cannot hold take the
    exact maxdot result (counted in ``rescued``)."""
    if mode not in GAT_MODES:
        raise ValueError(f"mode must be one of {GAT_MODES}, got {mode!r}")
    _check_dot_mode(dot_mode)
    if mode == "maxdot":
        return gat_bcsr(tp, h, att, relu_slope, row_shift, dot_mode)
    if isinstance(tp, (tuple, list)):
        parts = [p for p in tp if p is not None and p.num_tiles]
        num, den = gat_bcsr_tiles(parts[0], h, att, relu_slope, mode, hv_chunks, row_shift)
        for p in parts[1:]:
            n2, d2 = gat_bcsr_tiles(p, h, att, relu_slope, mode, hv_chunks, row_shift)
            num, den = num + n2, den + d2
        return num, den
    num, den, need = gat_bcsr_factored(tp, h, att, relu_slope, mode, hv_chunks, row_shift)
    with span("gnn.sync", site="gat.factored_need"):
        any_need = bool(need.any())
    if not any_need:
        return num, den
    rescued["calls"] += 1
    with span("gnn.sync", site="gat.factored_rows"):
        rescued["rows"] += int(need.sum())
    exact_num, exact_den = gat_bcsr(tp, h, att, relu_slope, row_shift)
    return torch.where(need[:, None], exact_num, num), torch.where(need, exact_den, den)


def _branch_scores(a_c, ad, m, asrc, relu_slope: float):
    """(s, lrelu') of a chunk of tiles (see _cell_scores); lrelu'(z) is 1
    for z >= 0, else the slope."""
    s, z = _cell_scores(a_c, ad, m, asrc, relu_slope)
    return s, torch.where(z >= 0, 1.0, relu_slope)


def gat_bwd_dad_plain(tp: TilePlan, h, gbar, c, dm, asrc, relu_slope: float, chunk: int = 256) -> torch.Tensor:
    """d_att_dst [num_nodes] over the forward tile plan, the counterpart of
    ``gat_bwd_dad_xla``: per chunk of tiles, the cells' scores and branch
    slopes from ``dm`` = (ad, M) per destination and ``asrc`` per source
    (_score_terms), the [R, C] products <gbar_i, h_j> by bmm, and the row
    sums of lrelu' s (<gbar_i, h_j> - c_i) added into the destination
    row-tiles."""
    tr, tc = tp.tile_rows, tp.tile_cols
    nct, nrt = tp.num_col_tiles, tp.num_row_tiles
    f = h.shape[-1]
    dmp = _pad_to(dm.float(), nrt * tr).reshape(nrt, tr, 2)
    cp = _pad_to(c.float(), nrt * tr).reshape(nrt, tr)
    gb = _pad_to(gbar.float(), nrt * tr).reshape(nrt, tr, f)
    asp = _pad_to(asrc.float(), nct * tc).reshape(nct, tc)
    hp = _pad_to(h.float(), nct * tc).reshape(nct, tc, f)
    acc = torch.zeros((nrt, tr), dtype=torch.float32, device=h.device)
    for s0 in range(0, tp.num_tiles, chunk):
        col = tp.tile_col[s0 : s0 + chunk].long()
        row = tp.tile_row[s0 : s0 + chunk].long()
        d = dmp.index_select(0, row)
        s, lp = _branch_scores(
            tp.counts(s0, s0 + chunk).float(), d[:, :, 0, None], d[:, :, 1, None],
            asp.index_select(0, col)[:, None, :], relu_slope,
        )
        p = torch.bmm(gb.index_select(0, row), hp.index_select(0, col).transpose(1, 2))
        tt = lp * s * (p - cp.index_select(0, row)[:, :, None])
        acc.index_add_(0, row, tt.sum(dim=2))
    return acc.reshape(nrt * tr)[: tp.num_nodes]


def gat_bwd_dh_das_plain(tp_t: TilePlan, h, gbar, c, dm, asrc, relu_slope: float, chunk: int = 256):
    """(dh [n_src, f], d_att_src [n_src]) over the transposed tile plan (rows
    are sources j, columns destinations i), the counterpart of
    ``gat_bwd_dh_das_xla``: dh_j = sum_i s_ij gbar_i and the row sums of
    lrelu' s (<gbar_i, h_j> - c_i); ``dm`` is over the destinations (the
    plan's columns), ``asrc`` over the sources (its rows)."""
    tr, tc = tp_t.tile_rows, tp_t.tile_cols
    nct, nrt = tp_t.num_col_tiles, tp_t.num_row_tiles
    f = h.shape[-1]
    asp = _pad_to(asrc.float(), nrt * tr).reshape(nrt, tr)
    hp = _pad_to(h.float(), nrt * tr).reshape(nrt, tr, f)
    dmp = _pad_to(dm.float(), nct * tc).reshape(nct, tc, 2)
    cp = _pad_to(c.float(), nct * tc).reshape(nct, tc)
    gb = _pad_to(gbar.float(), nct * tc).reshape(nct, tc, f)
    acch = torch.zeros((nrt, tr, f), dtype=torch.float32, device=h.device)
    accs = torch.zeros((nrt, tr), dtype=torch.float32, device=h.device)
    for s0 in range(0, tp_t.num_tiles, chunk):
        col = tp_t.tile_col[s0 : s0 + chunk].long()
        row = tp_t.tile_row[s0 : s0 + chunk].long()
        d = dmp.index_select(0, col)
        s, lp = _branch_scores(
            tp_t.counts(s0, s0 + chunk).float(), d[:, None, :, 0], d[:, None, :, 1],
            asp.index_select(0, row)[:, :, None], relu_slope,
        )
        gbc = gb.index_select(0, col)
        acch.index_add_(0, row, torch.bmm(s, gbc))
        p = torch.bmm(hp.index_select(0, row), gbc.transpose(1, 2))
        tt = lp * s * (p - cp.index_select(0, col)[:, None, :])
        accs.index_add_(0, row, tt.sum(dim=2))
    n = tp_t.num_nodes
    return acch.reshape(nrt * tr, f)[:n], accs.reshape(nrt * tr)[:n]


def gat_bwd_dad(tp: TilePlan, h, gbar, c, dm, asrc, relu_slope: float) -> torch.Tensor:
    """d_att_dst over the forward tile plan: the B3 kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if h.device.type == "cuda":
        return cuda_gat_bwd.gat_bwd_dad_cuda(
            tp, h.float().contiguous(), gbar.float().contiguous(), c.float().contiguous(),
            dm[: tp.num_nodes].float().contiguous(), asrc[: tp.n_src].float().contiguous(), relu_slope,
        )
    if h.device.type == "cpu":
        return gat_bwd_dad_plain(tp, h, gbar, c, dm, asrc, relu_slope)
    raise ValueError(f"no GAT tile backward for device {h.device}")


def gat_bwd_dh_das(tp_t: TilePlan, h, gbar, c, dm, asrc, relu_slope: float):
    """(dh, d_att_src) over the transposed tile plan: the B4 kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if h.device.type == "cuda":
        return cuda_gat_bwd.gat_bwd_dh_das_cuda(
            tp_t, h.float().contiguous(), gbar.float().contiguous(), c.float().contiguous(),
            dm[: tp_t.n_src].float().contiguous(), asrc[: tp_t.num_nodes].float().contiguous(), relu_slope,
        )
    if h.device.type == "cpu":
        return gat_bwd_dh_das_plain(tp_t, h, gbar, c, dm, asrc, relu_slope)
    raise ValueError(f"no GAT tile backward for device {h.device}")


def _row_max(tp, plan: Optional[AggregationPlan], att: torch.Tensor) -> torch.Tensor:
    """max over in-neighbors j of as_j per destination, over the tiles
    (bcsr_rowmax) and the residual plan (a max per task, then per row);
    -inf for rows without in-edges."""
    asrc = att[:, 1].float()
    mx = torch.full((att.shape[0],), float("-inf"), dtype=torch.float32, device=asrc.device)
    for p in _parts(tp):
        mx = torch.maximum(mx, bcsr_rowmax(p, asrc))
    if plan is not None and plan.num_edges:
        nt, b = plan.num_tasks_padded, plan.block_size
        slots = torch.where(slot_mask(plan), asrc.index_select(0, plan.src_flat()), float("-inf"))
        task_max = slots.reshape(nt, b).amax(dim=1)
        rm = torch.full((plan.num_nodes,), float("-inf"), dtype=torch.float32, device=asrc.device)
        rm.scatter_reduce_(0, plan.dst, task_max, "amax")
        mx = torch.maximum(mx, rm)
    return mx


def _hybrid_row_shift(tp, plan: Optional[AggregationPlan], att: torch.Tensor, relu_slope: float) -> torch.Tensor:
    """Exact per-destination stabilizer shared by every part:
    M_i = lrelu(ad_i + max over in-neighbors j of as_j) (_row_max); 0 for
    rows without edges, so their scores stay finite."""
    m = leaky_relu(att[:, 0].float() + _row_max(tp, plan, att), relu_slope)
    return torch.where(torch.isfinite(m), m, 0.0)


def _global_bound_shift(att: torch.Tensor, relu_slope: float) -> torch.Tensor:
    """O(n) overflow bound: M_i = max(ad_i + A, s (ad_i + A)), A = max_j as_j,
    keeps every score <= 1 without a pass over the adjacency.
    Rows whose own neighbor max lies far below A under-scale num and den
    alike (the shift cancels) until den underflows, at a logit gap of ~80."""
    ad = att[:, 0].float()
    a_max = att[:, 1].float().max()
    m = torch.maximum(ad + a_max, relu_slope * (ad + a_max))
    return torch.where(torch.isfinite(m), m, 0.0)


def _resolve_shift(tp, plan, att, relu_slope, stabilize) -> torch.Tensor:
    if stabilize == "bound":
        return _global_bound_shift(att, relu_slope)
    if stabilize is True or stabilize == "exact":
        return _hybrid_row_shift(tp, plan, att, relu_slope)
    raise ValueError(f"stabilize must be False, True, 'exact' or 'bound', got {stabilize!r}")


# a 'bound'-shifted den below this is rescued with the exact shift
BOUND_DEN_MIN = 2.0**-64


def _bound_rescue(tp, plan, att, relu_slope, shift, den, has_edges) -> Optional[torch.Tensor]:
    """The 'bound' shift with the exact one on the rows whose |den| fell
    below BOUND_DEN_MIN although they have in-edges, or None when no row needs
    it.  ``has_edges`` (bool [n], from the aggregator's in-degrees) makes
    the check one device-to-host read; without it such rows are checked
    against the tiles' and residual's row max (B5) first."""
    need = den.abs() < BOUND_DEN_MIN
    if has_edges is not None:
        need = need & has_edges
    with span("gnn.sync", site="gat.bound_need"):
        any_need = bool(need.any())
    if not any_need:
        return None
    with span("gnn.gat.rescue"):
        mx = _row_max(tp, plan, att)
        need = need & torch.isfinite(mx)
        if has_edges is None:
            with span("gnn.sync", site="gat.bound_need_rowmax"):
                any_need = bool(need.any())
            if not any_need:
                return None
        exact = leaky_relu(att[:, 0].float() + mx, relu_slope)
        return torch.where(need, exact, shift)


def _tile_and_residual_sums(tp, plan, h, att, relu_slope, att_gather_dtype, h_gather_dtype, shift, dot_mode):
    """(num, den, flat residual slot scores or None) of every part under
    ``shift``: spans ``gnn.gat.tiles`` and ``gnn.gat.residual``."""
    with span("gnn.gat.tiles"):
        num, den = gat_bcsr(tp, h, att, relu_slope, row_shift=shift, dot_mode=dot_mode)
    score = None
    if plan is not None and plan.num_edges:
        with span("gnn.gat.residual"):
            count_residual(plan)
            nr, dr, score = gat_aggregate_parts(
                plan, h, att, relu_slope=relu_slope,
                att_gather_dtype=att_gather_dtype, h_gather_dtype=h_gather_dtype, row_shift=shift,
            )
            num = num + nr
            den = den + dr
            score = score.reshape(-1)
    return num, den, score


def _residual_bwd_flat(plan, plan_t, edge_map_t, h, gbar, c, score_flat, shift, relu_slope: float):
    """The residual's (dh, d_ad, d_as), every slot array flat: dz_e =
    lrelu' s_e (<gbar_i, h_j> - c_i); d_ad by task then destination sums on
    the forward plan, d_as by a scatter over sources, dh over the transposed
    plan with the slot scores carried across by the edge map.  The branch
    test comes from the saved score: z > 0 <=> exp(z - M) > exp(-M)."""
    b = plan.block_size
    dst = plan.dst
    s_flat = score_flat.float()
    p_flat = sddmm_slots(plan, h.float(), gbar)
    dsz = s_flat * (p_flat - c.index_select(0, dst).repeat_interleave(b))
    thr = 1.0 if shift is None else torch.exp(-shift.index_select(0, dst)).repeat_interleave(b)
    dz = torch.where(s_flat > thr, 1.0, relu_slope) * dsz
    d_ad = torch.zeros((plan.num_nodes,), dtype=torch.float32, device=h.device)
    d_ad.index_add_(0, dst, dz.reshape(-1, b).sum(dim=1))
    d_as = torch.zeros((plan.n_src,), dtype=torch.float32, device=h.device)
    d_as.index_add_(0, plan.src_flat(), dz)
    s_t = slots_from_edge_values_flat(plan_t, edge_values_from_slots_flat(plan, s_flat)[edge_map_t])
    dh = spmm_plain(plan_t, gbar, val=s_t)
    return dh, d_ad, d_as


def _parts(tp) -> list:
    return [p for p in (tp if isinstance(tp, (tuple, list)) else (tp,)) if p is not None and p.num_tiles]


class HybridGat(torch.autograd.Function):
    """The GAT aggregation over tiles + residual with the hand-written
    backward of the module doc.  The forward resolves the shift (the
    'bound' shift with its rescued rows) and saves it with out, den and the
    residual's slot scores.  Spans: ``gnn.gat.tiles``, ``gnn.gat.residual``
    and, where rows are rescued, ``gnn.gat.rescue`` (forward);
    ``gnn.gat_t.tiles`` (B3 and B4) and ``gnn.gat_t.residual`` (backward);
    ``gnn.sync`` around each device-to-host read."""

    @staticmethod
    def forward(ctx, h, att, tp, plan, tp_t, plan_t, edge_map_t, relu_slope, att_gather_dtype, h_gather_dtype,
                stabilize, dot_mode, has_edges):
        shift = _resolve_shift(tp, plan, att, relu_slope, stabilize) if stabilize else None
        sums = (tp, plan, h, att, relu_slope, att_gather_dtype, h_gather_dtype)
        num, den, score = _tile_and_residual_sums(*sums, shift, dot_mode)
        if stabilize == "bound":
            rescued = _bound_rescue(tp, plan, att, relu_slope, shift, den, has_edges)
            if rescued is not None:
                shift = rescued
                with span("gnn.gat.rescue"):
                    num, den, score = _tile_and_residual_sums(*sums, shift, dot_mode)
        safe = torch.where(den == 0.0, 1.0, den)
        out = (num / safe[:, None]).to(h.dtype)
        ctx.save_for_backward(h, att, out, safe, shift, score)
        ctx.plans = (tp, plan, tp_t, plan_t, edge_map_t)
        ctx.relu_slope = relu_slope
        return out

    @staticmethod
    def backward(ctx, ct):
        h, att, out, safe, shift, score = ctx.saved_tensors
        tp, plan, tp_t, plan_t, edge_map_t = ctx.plans
        has_residual = score is not None
        if tp_t is None or (has_residual and (plan_t is None or edge_map_t is None)):
            raise RuntimeError(
                "hybrid_gat backward needs the transposed plans: build the "
                "aggregator with schedule_hybrid(..., with_transpose=True)"
            )
        slope = ctx.relu_slope
        ctf = ct.float()
        gbar = ctf / safe[:, None]
        c = (ctf * out.float()).sum(dim=1) / safe
        dm, asrc = _score_terms(att, shift)
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        d_ad = torch.zeros((att.shape[0],), dtype=torch.float32, device=h.device)
        d_as = torch.zeros((att.shape[0],), dtype=torch.float32, device=h.device)
        with span("gnn.gat_t.tiles"):
            for p in _parts(tp):
                d_ad = d_ad + gat_bwd_dad(p, h, gbar, c, dm, asrc, slope)
            for p in _parts(tp_t):
                dht, dast = gat_bwd_dh_das(p, h, gbar, c, dm, asrc, slope)
                dh = dh + dht
                d_as = d_as + dast
        if has_residual:
            with span("gnn.gat_t.residual"):
                count_residual(plan)
                dh_r, dad_r, das_r = _residual_bwd_flat(plan, plan_t, edge_map_t, h, gbar, c, score, shift, slope)
                dh = dh + dh_r
                d_ad = d_ad + dad_r
                d_as = d_as + das_r
        datt = torch.stack([d_ad, d_as], dim=1).to(att.dtype)
        return (dh.to(h.dtype), datt) + (None,) * 11


def hybrid_gat(
    tp,
    plan: Optional[AggregationPlan],
    h: torch.Tensor,
    att: torch.Tensor,
    relu_slope: float = DEFAULT_SLOPE,
    att_gather_dtype=None,
    h_gather_dtype=None,
    stabilize=False,
    dot_mode: str = "exact",
    tp_t=None,
    plan_t: Optional[AggregationPlan] = None,
    edge_map_t=None,
    has_edges: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """GAT forward over a hybrid schedule: (num, den) of the tiles plus those
    of the residual, then num / den (rows with den 0 give 0).  The tiles must
    hold raw values (no factored scales): attention provides the edge
    weights.  stabilize=False is the reference's un-stabilized form, whose
    wide logits overflow as the reference's do.  Differentiable in (h, att)
    through HybridGat, whose backward needs the transposed tile parts
    ``tp_t`` and, where there is a residual, the transposed residual plan
    ``plan_t`` and ``edge_map_t`` (Aggregator.schedule_hybrid
    with_transpose=True); the backward computes 'exact' and 'split2' alike,
    in float32.  ``has_edges`` (bool [n]: the row has an in-edge) lets
    stabilize='bound' find the rows to rescue without a pass over the
    adjacency (module doc)."""
    for p in tp if isinstance(tp, (tuple, list)) else (tp,):
        if p.scale_dst is not None or p.scale_src is not None:
            raise ValueError("hybrid GAT needs raw count tiles (no factored scales)")
    _check_dot_mode(dot_mode)
    return HybridGat.apply(
        h, att, tp, plan, tp_t, plan_t, edge_map_t, relu_slope, att_gather_dtype, h_gather_dtype, stabilize, dot_mode,
        has_edges,
    )
