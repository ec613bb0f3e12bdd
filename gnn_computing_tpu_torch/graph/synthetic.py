"""Synthetic graphs and features from fixed seeds.

Port of the numpy stream of ``gnn_computing_tpu/graph/synthetic.py``: the
same seed gives the same graph in both packages.  The JAX package switches
to the JAX PRNG for RMAT when an accelerator is present; this port uses
the numpy stream unless ``rmat_graph`` is given a torch device, where it
draws the edges (``rmat_edges_device``: same distribution, another
stream).  Generators: RMAT (power-law), the community graph
(reddit's co-comment shape), uniform, fixed-degree (the pre-sampled
``<dset>_sample_16`` SAGE-LSTM inputs) and RMAT at a reference dataset's
scale.
"""

from __future__ import annotations

import numpy as np
import torch

from gnn_computing_tpu_torch.device import resolve_device
from gnn_computing_tpu_torch.graph.csr import CSRGraph

# Named presets at the scale of the reference's benchmark datasets
# (vertex / edge counts, tabulated in BASELINE.md).
DATASET_SCALES = {
    "arxiv": (169_343, 1_166_243),
    "collab": (235_868, 2_358_104),
    "citation": (2_927_963, 30_387_995),
    "ddi": (4_267, 2_135_822),
    "protein": (132_534, 79_122_504),
    "ppa": (576_289, 42_463_862),
    "reddit": (232_965, 114_615_891),
    "products": (2_449_029, 123_718_280),
}


def rmat_edges(
    n_log2: int,
    num_edges: int,
    seed: int = 123,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    batch: int = 1 << 24,
) -> tuple[np.ndarray, np.ndarray]:
    """RMAT (Kronecker) edges over 2**n_log2 vertices: each bit of (dst,
    src) is drawn from the quadrant distribution [[a, b], [c, 1-a-b-c]]."""
    rng = np.random.default_rng(seed)
    t1, t2, t3 = a, a + b, a + b + c
    weights = (1 << np.arange(n_log2 - 1, -1, -1)).astype(np.int64)
    dsts, srcs = [], []
    remaining = num_edges
    while remaining > 0:
        k = min(batch, remaining)
        r = rng.random((k, n_log2), dtype=np.float32)
        q = (r >= t1).astype(np.int8) + (r >= t2).astype(np.int8) + (r >= t3).astype(np.int8)
        dsts.append((q >> 1).astype(np.int64) @ weights)
        srcs.append((q & 1).astype(np.int64) @ weights)
        remaining -= k
    return np.concatenate(dsts), np.concatenate(srcs)


def rmat_edges_device(
    n_log2: int,
    num_edges: int,
    seed: int = 123,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    batch: int = 1 << 24,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """RMAT edges drawn on a torch device from a ``torch.Generator`` seeded
    with ``seed``: the distribution of rmat_edges, another random stream
    (as the JAX package's ``rmat_edges_device`` has another than its numpy
    one)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t1, t2, t3 = a, a + b, a + b + c
    weights = 1 << torch.arange(n_log2 - 1, -1, -1, dtype=torch.int32, device=dev)
    dsts, srcs = [], []
    remaining = num_edges
    while remaining > 0:
        k = min(batch, remaining)
        r = torch.rand((k, n_log2), generator=gen, device=dev)
        q = (r >= t1).to(torch.int32) + (r >= t2).to(torch.int32) + (r >= t3).to(torch.int32)
        dsts.append(((q >> 1) * weights).sum(dim=1).cpu().numpy())
        srcs.append(((q & 1) * weights).sum(dim=1).cpu().numpy())
        remaining -= k
    return np.concatenate(dsts).astype(np.int64), np.concatenate(srcs).astype(np.int64)


def rmat_graph(
    num_nodes: int, num_edges: int, seed: int = 123, with_val: bool = True, device=None
) -> CSRGraph:
    """Power-law graph: RMAT over the next power of two, folded by modulo.
    ``device`` None draws the numpy stream (the JAX package's on the CPU);
    a torch device draws the edges there (rmat_edges_device)."""
    n_log2 = max(1, int(np.ceil(np.log2(num_nodes))))
    if device is None:
        dst, src = rmat_edges(n_log2, num_edges, seed=seed)
    else:
        dst, src = rmat_edges_device(n_log2, num_edges, seed=seed, device=device)
    dst = dst % num_nodes
    src = (src % num_nodes).astype(np.int32)
    val = None
    if with_val:
        val = np.random.default_rng(seed + 1).standard_normal(num_edges, dtype=np.float32)
    return CSRGraph.from_edges(dst, src, num_nodes, val=val)


def _mix64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Deterministic vectorized integer hash (splitmix64 finalizer)."""
    x = (a.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) ^ (b.astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9))
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def community_graph(
    num_nodes: int,
    num_edges: int,
    seed: int = 123,
    with_val: bool = True,
    p_within: float = 0.85,
    thread_size: int = 32,
    overlap: float = 0.75,
    sigma: float = 0.75,
    min_comm: int = 2048,
    max_comm: int = 32768,
    target_skew: float = 1.0,
    cross_skew: float = 2.0,
    shuffle: bool = True,
) -> CSRGraph:
    """Community-structured graph in the shape of reddit.dgl (a post
    co-comment graph: posts cluster by subreddit, and posts of one
    discussion share most of their neighbour sets).

      * communities with Zipf-ish sizes in [min_comm, max_comm], edge
        budget ~ size^1.1;
      * per-node degree weights z ~ exp(N(0, sigma));
      * nodes grouped in threads of ``thread_size``; a fraction ``overlap``
        of each within-community edge comes from the thread's shared
        (hash-defined) neighbour pool, the rest uniform in the community;
      * within-community targets drawn ~ z^target_skew (0: uniform);
      * (1 - p_within) of the edges cross communities, endpoints drawn ~
        z^cross_skew globally (0: uniform);
      * the half-edge list mirrored (symmetric), node ids permuted when
        ``shuffle``.

    Deterministic in ``seed``; the same stream as the JAX package's."""
    rng = np.random.default_rng(seed)
    m_pairs = num_edges // 2

    # community sizes: truncated Zipf until the nodes are covered
    sizes = []
    covered = 0
    while covered < num_nodes:
        u = rng.random()
        s = int(min_comm * (1.0 - u) ** -0.8)
        s = min(s, max_comm, num_nodes - covered)
        sizes.append(s)
        covered += s
    sizes = np.array(sizes, dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    ncomm = len(sizes)

    # per-community pair budgets ~ size^1.1
    m_within = int(p_within * m_pairs)
    w = sizes.astype(np.float64) ** 1.1
    mc = np.floor(w / w.sum() * m_within).astype(np.int64)
    mc[: m_within - mc.sum()] += 1

    # per-node degree weights and within-edge owner counts
    z = np.exp(sigma * rng.standard_normal(num_nodes))
    cz = np.add.reduceat(z, offs[:-1])
    frac = z / np.repeat(cz, sizes)
    target = frac * np.repeat(mc, sizes)
    cnt = np.floor(target).astype(np.int64)
    deficit = int(m_within - cnt.sum())
    if deficit > 0:
        extra = np.argsort(-(target - cnt))[:deficit]
        cnt[extra] += 1
    elif deficit < 0:
        donors = np.flatnonzero(cnt > 0)[:(-deficit)]
        cnt[donors] -= 1

    u_w = np.repeat(np.arange(num_nodes, dtype=np.int64), cnt)
    comm_of = np.repeat(np.arange(ncomm, dtype=np.int64), sizes)
    cu = comm_of[u_w]
    s_cu = sizes[cu]
    off_cu = offs[cu]

    # neighbour draw: thread pool or popularity-weighted in the community
    pool_sz = max(2 * (num_edges // max(num_nodes, 1)), 8)
    thread_of = (u_w - off_cu) // thread_size + (off_cu // thread_size)
    from_pool = rng.random(len(u_w)) < overlap
    r = rng.integers(0, 1 << 62, size=len(u_w))
    if target_skew > 0:
        # inverse-CDF draw ~ z^target_skew within the community, shared by
        # pool members (hash-positioned) and non-pool draws (uniform)
        zt = z**target_skew
        cum = np.cumsum(zt)
        ctot = np.add.reduceat(zt, offs[:-1])
        base = (cum - zt)[off_cu]
        ct_cu = ctot[cu]
        upool = _mix64(thread_of, r % pool_sz).astype(np.float64) / float(1 << 64)
        uunif = (r.astype(np.float64) / float(1 << 62)) % 1.0
        uu = np.where(from_pool, upool, uunif)
        v_w = np.searchsorted(cum, base + uu * ct_cu, side="right").astype(np.int64)
        np.minimum(v_w, off_cu + s_cu - 1, out=v_w)
        del zt, cum, ctot, base, ct_cu, upool, uunif, uu
    else:
        v_pool = off_cu + (_mix64(thread_of, r % pool_sz) % s_cu.astype(np.uint64)).astype(np.int64)
        v_w = np.where(from_pool, v_pool, off_cu + (r % s_cu))
        del v_pool
    del thread_of, from_pool, r, off_cu, s_cu, cu

    # cross-community edges (preferential to global hubs)
    m_cross = m_pairs - m_within
    if cross_skew > 0:
        zc = z**cross_skew
        cumc = np.cumsum(zc)
        tot = cumc[-1]
        u_x = np.searchsorted(cumc, rng.random(m_cross) * tot, side="right").astype(np.int64)
        v_x = np.searchsorted(cumc, rng.random(m_cross) * tot, side="right").astype(np.int64)
        np.minimum(u_x, num_nodes - 1, out=u_x)
        np.minimum(v_x, num_nodes - 1, out=v_x)
        del zc, cumc
    else:
        u_x = rng.integers(0, num_nodes, size=m_cross, dtype=np.int64)
        v_x = rng.integers(0, num_nodes, size=m_cross, dtype=np.int64)

    u = np.concatenate([u_w, u_x])
    v = np.concatenate([v_w, v_x])
    # symmetric directed edge list; an odd num_edges keeps one extra forward edge
    dst = np.concatenate([u, v, u[: num_edges - 2 * m_pairs]])
    src = np.concatenate([v, u, v[: num_edges - 2 * m_pairs]])

    if shuffle:
        perm = rng.permutation(num_nodes).astype(np.int64)
        dst = perm[dst]
        src = perm[src]

    val = None
    if with_val:
        val = np.random.default_rng(seed + 1).standard_normal(num_edges, dtype=np.float32)
    return CSRGraph.from_edges(dst, src.astype(np.int32), num_nodes, val=val)


def uniform_graph(num_nodes: int, num_edges: int, seed: int = 123, with_val: bool = True) -> CSRGraph:
    """Edges with uniform random endpoints."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
    src = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64).astype(np.int32)
    val = rng.standard_normal(num_edges, dtype=np.float32) if with_val else None
    return CSRGraph.from_edges(dst, src, num_nodes, val=val)


def fixed_degree_graph(num_nodes: int, degree: int, seed: int = 123) -> CSRGraph:
    """Every vertex has exactly ``degree`` in-edges with random sources
    (the reference's pre-sampled ``<dset>_sample_16`` graphs: a constant
    row length of 16)."""
    rng = np.random.default_rng(seed)
    indices = rng.integers(0, num_nodes, size=num_nodes * degree, dtype=np.int64).astype(np.int32)
    indptr = (np.arange(num_nodes + 1, dtype=np.int64) * degree).astype(np.int32)
    return CSRGraph(indptr=indptr, indices=indices)


def scaled_dataset(name: str, seed: int = 123, with_val: bool = True) -> CSRGraph:
    """RMAT graph at the vertex / edge scale of a reference dataset."""
    n, m = DATASET_SCALES[name]
    return rmat_graph(n, m, seed=seed, with_val=with_val)


def normal_features(n: int, f: int, seed: int = 123) -> np.ndarray:
    """Deterministic N(0, 1) float32 features [n, f] (drawn in float64, as
    the JAX package draws them)."""
    return np.random.default_rng(seed).standard_normal((n, f)).astype(np.float32)
