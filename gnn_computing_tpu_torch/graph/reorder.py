"""Vertex reordering for tile locality.

Port of ``gnn_computing_tpu/graph/reorder.py``: the same host numpy, so each
function returns a permutation array-equal to the JAX package's.  A
permutation that concentrates edges into few [R x C] adjacency blocks
moves more of the aggregation into the dense tiles (schedule/tiles.py):

  * degree_sort  — hubs first; cheap, effective on power-law graphs (hub
                   columns become dense tile stripes).
  * deal_shards  — an ordered permutation dealt round-robin over contiguous
                   shards, so each shard gets its share of every stratum.
  * cluster_reorder / cluster_reorder_exact — MinHash-LSH candidates merged
                   by union-find under a cluster-size cap (the reference's
                   script/cluster2.py), by estimated or by exact Jaccard.
  * label_propagation_reorder — synchronous label propagation makes whole
                   communities contiguous (rows and their columns at once),
                   optionally with the global hubs first (bench.py's
                   ``hublpa``).

Permutations map new id -> old id; apply with ``CSRGraph.reorder(perm)``.
The cluster reorders run their merge loops in the native host library
(``native.union_find_merge`` / ``native.jaccard_cluster``); where it does not
build they raise, as every entry of ``native`` does, instead of returning
None or falling back.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gnn_computing_tpu_torch import native
from gnn_computing_tpu_torch.graph.csr import CSRGraph
from gnn_computing_tpu_torch.utils.profiling import span


def _total_degree(g: CSRGraph) -> np.ndarray:
    in_deg = g.degrees.astype(np.int64)
    out_deg = np.bincount(g.indices, minlength=g.n_src).astype(np.int64)
    return in_deg + out_deg[: g.num_nodes]


def degree_sort(g: CSRGraph, by: str = "total") -> np.ndarray:
    """Permutation (new -> old) sorting vertices by descending degree,
    stable: ``by`` "in", "out" or (anything else) "total" = in + out.
    Recorded as the span ``gnn.plan.reorder``."""
    with span("gnn.plan.reorder"):
        if by == "in":
            d = g.degrees.astype(np.int64)
        elif by == "out":
            d = np.bincount(g.indices, minlength=g.n_src).astype(np.int64)
        else:
            d = _total_degree(g)
        return np.argsort(-d, kind="stable").astype(np.int64)


def deal_shards(perm: np.ndarray, num_shards: int) -> np.ndarray:
    """Re-deal an ordered permutation round-robin across contiguous shards:
    rank r goes to shard r % D at local position r // D, so each of the D
    contiguous row ranges gets an equal share of every degree stratum, and
    within a shard the order is kept (ranks s, s + D, s + 2D, ...)."""
    n = len(perm)
    d = int(num_shards)
    ss = -(-n // d)
    r = np.arange(n, dtype=np.int64)
    # a stable argsort of the target position is a bijection even when n is
    # not a multiple of D (gaps in the key space collapse in rank order)
    key = (r % d) * ss + r // d
    return perm[np.argsort(key, kind="stable")]


# ----------------------------------------------------------- MinHash-LSH
_MERSENNE = (1 << 61) - 1


def _minhash_signatures(g: CSRGraph, num_perm: int, seed: int) -> np.ndarray:
    """[n, num_perm] int64 MinHash signatures of each vertex's neighbor set;
    a row without neighbors keeps the int64 maximum.  The hash (a * id + b)
    wraps in int64 by design and numpy's % takes the sign of the divisor, as
    in the JAX package."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, _MERSENNE, size=num_perm, dtype=np.int64)
    b = rng.integers(0, _MERSENNE, size=num_perm, dtype=np.int64)
    n = g.num_nodes
    idx = g.indices.astype(np.int64)
    dst = g.dst_per_edge.astype(np.int64)
    sig = np.full((n, num_perm), np.iinfo(np.int64).max, dtype=np.int64)
    # blocks of permutations bound the [m, k] hash buffer
    step = max(1, min(num_perm, (1 << 27) // max(len(idx), 1)))
    for s in range(0, num_perm, step):
        hv = (idx[:, None] * a[None, s : s + step] + b[None, s : s + step]) % _MERSENNE
        np.minimum.at(sig[:, s : s + step], dst, hv)
    return sig


def _banding_candidate_pairs(sig: np.ndarray, bands: int) -> Optional[np.ndarray]:
    """LSH banding over the signatures: the unique (i < j) candidate pairs
    of vertices that share a bucket in some band (consecutive members of a
    bucket pair up, enough to chain it into one cluster under transitive
    merging), or None when there is none.  A band's rows are keyed by a
    structured view, sorted stably."""
    num_perm = sig.shape[1]
    rows_per_band = max(num_perm // bands, 1)
    cands = []
    for b in range(bands):
        band = sig[:, b * rows_per_band : (b + 1) * rows_per_band]
        if band.shape[1] == 0:
            continue
        key = np.ascontiguousarray(band).view([("", band.dtype)] * band.shape[1]).ravel()
        order = np.argsort(key, kind="stable")
        sorted_key = key[order]
        same = sorted_key[1:] == sorted_key[:-1]
        i = order[:-1][same]
        j = order[1:][same]
        if len(i):
            cands.append(np.stack([i, j], axis=1))
    if not cands:
        return None
    return np.unique(np.sort(np.concatenate(cands), axis=1), axis=0)


def _emit_clusters_first_seen(root: np.ndarray) -> np.ndarray:
    """Vertices ordered cluster by cluster, clusters ranked by the first
    appearance of their root in vertex order (cluster2.py:156-172)."""
    _, first, inv = np.unique(root, return_index=True, return_inverse=True)
    rank = np.argsort(np.argsort(first))[inv.reshape(-1)]
    return np.lexsort((np.arange(len(root)), rank)).astype(np.int64)


def cluster_reorder_exact(
    g: CSRGraph,
    num_perm: int = 64,
    bands: int = 16,
    max_cluster: int = 64,
    seed: int = 123,
) -> np.ndarray:
    """The reference's clustering: LSH banding candidates, then an
    exact-Jaccard max-heap agglomeration with lazy re-enqueue of the current
    roots (script/cluster2.py:108-153), in the native library
    (``native.jaccard_cluster``); clusters emitted in first-seen order."""
    n = g.num_nodes
    if n == 0:
        return np.zeros(0, np.int64)
    pairs = _banding_candidate_pairs(_minhash_signatures(g, num_perm, seed), bands)
    if pairs is None:
        return np.arange(n, dtype=np.int64)
    return _emit_clusters_first_seen(native.jaccard_cluster(g.indptr, g.indices, pairs, max_cluster))


def cluster_reorder(
    g: CSRGraph,
    num_perm: int = 64,
    bands: int = 16,
    threshold: float = 0.2,
    max_cluster: int = 64,
    max_pairs_per_vertex: int = 8,
    seed: int = 123,
) -> np.ndarray:
    """LSH-clustered permutation (new -> old): MinHash signatures, banding
    candidates scored by signature agreement (an unbiased Jaccard estimate),
    those at or above ``threshold`` merged best-first by union-find under
    the ``max_cluster`` cap (``native.union_find_merge``), clusters emitted
    in first-seen order.  ``max_pairs_per_vertex`` is unused, as in the JAX
    package."""
    del max_pairs_per_vertex
    n = g.num_nodes
    if n == 0:
        return np.zeros(0, np.int64)
    sig = _minhash_signatures(g, num_perm, seed)
    pairs = _banding_candidate_pairs(sig, bands)
    if pairs is None:
        return np.arange(n, dtype=np.int64)
    est = (sig[pairs[:, 0]] == sig[pairs[:, 1]]).mean(axis=1)
    keep = est >= threshold
    pairs, est = pairs[keep], est[keep]
    pairs = pairs[np.argsort(-est, kind="stable")]
    return _emit_clusters_first_seen(native.union_find_merge(n, pairs, max_cluster))


# ------------------------------------------------- label propagation (2D)
def label_propagation_reorder(
    g: CSRGraph,
    iters: int = 5,
    self_weight: int = 1,
    degree_sort_within: bool = True,
    hubs: int = 0,
) -> np.ndarray:
    """Community-contiguous permutation (new -> old) by synchronous label
    propagation: each vertex takes the most frequent label among its
    in-neighbours (plus ``self_weight`` votes for its own), ties to the
    smaller label, for at most ``iters`` rounds.  Communities are ranked by
    first appearance; ``degree_sort_within`` orders each by descending total
    degree.  ``hubs`` > 0 puts the ``hubs`` highest-degree vertices first
    (bench.py's ``hublpa``): cross-community edges concentrate on them, so
    the first column blocks become dense hub stripes for every row tile."""
    n = g.num_nodes
    if n == 0:
        return np.zeros(0, np.int64)
    dst = g.dst_per_edge.astype(np.int64)
    src = g.indices.astype(np.int64)
    label = np.arange(n, dtype=np.int64)
    for _ in range(iters):
        key = dst * n + label[src]
        if self_weight:
            own = np.arange(n, dtype=np.int64) * n + label
            key = np.concatenate([key] + [own] * self_weight)
        uk, cnt = np.unique(key, return_counts=True)
        kd = uk // n
        kl = uk % n
        # by dst, then count ascending, then the LARGER label first: the
        # last entry of a dst is (max count, smallest label among maxima)
        order = np.lexsort((-kl, cnt, kd))
        kd_o = kd[order]
        last = np.r_[kd_o[1:] != kd_o[:-1], True]
        new_label = label.copy()
        new_label[kd_o[last]] = kl[order][last]
        if np.array_equal(new_label, label):
            break
        label = new_label
    _, first_idx, inv = np.unique(label, return_index=True, return_inverse=True)
    rank = np.argsort(np.argsort(first_idx))[inv.reshape(-1)]
    d = _total_degree(g)
    if hubs > 0:
        # the set argpartition picks (not its order) decides the result
        hub_ids = np.argpartition(-d, hubs - 1)[:hubs]
        is_hub = np.zeros(n, dtype=bool)
        is_hub[hub_ids] = True
        rank = np.where(is_hub, -1, rank)
    if degree_sort_within:
        return np.lexsort((np.arange(n), -d, rank)).astype(np.int64)
    return np.lexsort((np.arange(n), rank)).astype(np.int64)
