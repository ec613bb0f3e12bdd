"""The port's LSTM neighbor aggregation (``ops/lstm.py``) and SAGE-LSTM
layer (``models/sage_lstm.py``) against the JAX package on the CPU, with
the same weights carried over by ``convert.lstm_params_from_jax`` /
``sage_lstm_params_from_jax`` and the same numpy-seeded inputs.

Tolerances: float32 forwards within 1e-5 * max|jax| (float32 operation
order only), and within the repo gate (|y - ref| <= 1e-2*|ref| + 1e-5) of a
float64 step-by-step oracle; the 16-bit gate modes within the repo gate of
JAX and of the float64 oracle of their own rounding (gate rows rounded
once); gradients within 1e-4 relative L2 of ``jax.grad``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_computing_tpu.models.sage_lstm import init_sage_lstm_params as j_init_sage
from gnn_computing_tpu.models.sage_lstm import sage_lstm_layer as j_sage_layer
from gnn_computing_tpu.ops.lstm import init_lstm_params as j_init_lstm
from gnn_computing_tpu.ops.lstm import lstm_aggregate as j_lstm

from gnn_computing_tpu_torch.convert import lstm_params_from_jax, sage_lstm_params_from_jax
from gnn_computing_tpu_torch.models.sage_lstm import (
    BENCH_FEATURE_LEN,
    BENCH_NUM_NEIGHBORS,
    SageLSTM,
    init_sage_lstm_params,
    sage_lstm_aggregate_bench,
    sage_lstm_layer,
)
from gnn_computing_tpu_torch.ops.lstm import LSTMParams, init_lstm_params, lstm_aggregate
from gnn_computing_tpu_torch.ops.validate import relative_error_count

STRATEGIES = ("redundancy_bypass", "sparse_fetch", "materialize")


@functools.partial(jax.jit, static_argnames=("strategy", "gate_gather_dtype"))
def _j_lstm(params, x, nbr, strategy, gate_gather_dtype=None):
    return j_lstm(params, x, nbr, strategy, gate_gather_dtype=gate_gather_dtype)


def inputs(n=96, n_src=120, k=8, f_in=12, f=16, seed=0):
    """(JAX params, port params, x, nbr) with x ~ N(0, 1) float32 and nbr
    integers in [0, n_src)."""
    jp = j_init_lstm(jax.random.key(seed), f_in, f)
    # a nonzero bias, so the b slab is exercised too
    jp = jp._replace(b=jnp.asarray(np.random.default_rng(seed + 7).uniform(-0.5, 0.5, 4 * f).astype(np.float32)))
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((n_src, f_in)).astype(np.float32)
    nbr = rng.integers(0, n_src, (n, k)).astype(np.int32)
    return jp, lstm_params_from_jax(jp, device="cpu"), x, nbr


def oracle(params, x, nbr, gx_all=None):
    """The step loop in float64 (gate slabs [i, f, o, c~]); ``gx_all``
    replaces x @ wx (the rounded gate rows of a 16-bit mode)."""
    wx, wh, b = (np.asarray(p.detach() if isinstance(p, torch.Tensor) else p, np.float64) for p in params)
    n, k = nbr.shape
    f = wh.shape[0]
    h, c = np.zeros((n, f)), np.zeros((n, f))
    gx_all = np.asarray(x, np.float64) @ wx if gx_all is None else gx_all
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    for t in range(k):
        z = gx_all[nbr[:, t]] + h @ wh + b
        i, fg, o, ct = sig(z[:, :f]), sig(z[:, f : 2 * f]), sig(z[:, 2 * f : 3 * f]), np.tanh(z[:, 3 * f :])
        c = fg * c + i * ct
        h = o * np.tanh(c)
    return h


def close(got, want, what, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), f"{what}: max|port-jax| = {err:.3e}"


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("shape", [dict(), dict(n=40, n_src=40, k=3, f_in=5, f=4)], ids=["n96k8", "n40k3"])
def test_lstm_matches_jax(strategy, shape):
    jp, pp, x, nbr = inputs(**shape)
    want = np.asarray(_j_lstm(jp, jnp.asarray(x), jnp.asarray(nbr), strategy))
    got = lstm_aggregate(pp, torch.from_numpy(x), torch.from_numpy(nbr), strategy)
    close(got, want, strategy)
    assert relative_error_count(got, oracle(pp, x, nbr)) == 0


def test_strategies_and_unroll_agree():
    """The three strategies compute the same function; ``unroll`` has no
    effect."""
    _, pp, x, nbr = inputs()
    xt, nt = torch.from_numpy(x), torch.from_numpy(nbr)
    base = lstm_aggregate(pp, xt, nt)
    assert torch.equal(lstm_aggregate(pp, xt, nt, unroll=16), base)
    for s in STRATEGIES[1:]:
        close(lstm_aggregate(pp, xt, nt, s), base.numpy(), s)
    # int64 neighbor matrices work as well as int32
    assert torch.equal(lstm_aggregate(pp, xt, nt.long()), base)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_gate_gather_dtype(dtype):
    """The gate rows are rounded once to the 16-bit dtype, gathered and cast
    back: the repo gate against JAX's same mode and against the float64
    oracle of that rounding."""
    jp, pp, x, nbr = inputs(n=200, n_src=200, k=8, f_in=16, f=16)
    x = x * 0.1  # bench.py's input scale
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    got = lstm_aggregate(pp, torch.from_numpy(x), torch.from_numpy(nbr), gate_gather_dtype=td)
    want = np.asarray(_j_lstm(jp, jnp.asarray(x), jnp.asarray(nbr), "redundancy_bypass", gate_gather_dtype=jd))
    assert relative_error_count(got, want) == 0
    rounded = (torch.from_numpy(x) @ pp.wx).to(td).double().numpy()
    assert relative_error_count(got, oracle(pp, x, nbr, gx_all=rounded)) == 0
    # the rounding is really applied: the 16-bit run differs from float32
    assert not torch.equal(got, lstm_aggregate(pp, torch.from_numpy(x), torch.from_numpy(nbr)))
    with pytest.raises(ValueError):
        lstm_aggregate(pp, torch.from_numpy(x), torch.from_numpy(nbr), gate_gather_dtype="float16")


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_lstm_gradients_match_jax(strategy):
    """d/d(wx, wh, b, x) of sum(out * ct) against jax.grad."""
    jp, pp, x, nbr = inputs(n=64, n_src=80, k=6, f_in=8, f=8, seed=3)
    ct = np.random.default_rng(9).standard_normal((64, 8)).astype(np.float32)

    def j_loss(p, xx):
        return jnp.sum(j_lstm(p, xx, jnp.asarray(nbr), strategy) * ct)

    jg_p, jg_x = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = [t.clone().requires_grad_(True) for t in pp]
    xt = torch.from_numpy(x).requires_grad_(True)
    (lstm_aggregate(LSTMParams(*leaves), xt, torch.from_numpy(nbr), strategy) * torch.from_numpy(ct)).sum().backward()
    for name, got, want in zip(("wx", "wh", "b", "x"), [*(t.grad for t in leaves), xt.grad], [*jg_p, jg_x]):
        assert rel_l2(got, want) <= 1e-4, f"{strategy} d{name}: {rel_l2(got, want):.3e}"


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sage_lstm_layer_matches_jax(strategy):
    n, k, f_in, f, f_out = 80, 5, 12, 16, 6
    jp = j_init_sage(jax.random.key(4), f_in, f, f_out)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, f_in)).astype(np.float32)
    nbr = rng.integers(0, n, (n, k)).astype(np.int32)
    want = np.asarray(jax.jit(j_sage_layer, static_argnames="strategy")(jp, jnp.asarray(x), jnp.asarray(nbr),
                                                                        strategy=strategy))
    model = sage_lstm_params_from_jax(jp, device="cpu")
    assert isinstance(model, SageLSTM) and len(list(model.parameters())) == 5
    xt, nt = torch.from_numpy(x), torch.from_numpy(nbr)
    got = model(xt, nt, strategy=strategy)
    close(got, want, f"sage_lstm_layer {strategy}")
    assert torch.equal(sage_lstm_layer(model.params(), xt, nt, strategy), got)
    assert (got >= 0).all() and (got > 0).any()
    bench = sage_lstm_aggregate_bench(model.params().lstm, xt, nt, strategy)
    close(bench, np.asarray(_j_lstm(jp.lstm, jnp.asarray(x), jnp.asarray(nbr), strategy)), "aggregate bench")
    # the module's parameters take gradients
    got.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())


@pytest.mark.parametrize("perm", [(0, 1, 3, 2), (0, 3, 1, 2), (1, 0, 2, 3)], ids=["ifco", "torch_ifgo", "fioc"])
def test_permuted_gate_slabs_are_caught(perm):
    """Weights whose [i, f, o, c~] slabs are reordered (torch.nn.LSTM's
    [i, f, g, o] among them) give another function: far outside the
    tolerance that the true order meets."""
    jp, pp, x, nbr = inputs()
    want = np.asarray(_j_lstm(jp, jnp.asarray(x), jnp.asarray(nbr), "redundancy_bypass"))
    f = pp.wh.shape[0]
    idx = torch.cat([torch.arange(s * f, (s + 1) * f) for s in perm])
    permuted = LSTMParams(pp.wx[:, idx], pp.wh[:, idx], pp.b[idx])
    got = lstm_aggregate(permuted, torch.from_numpy(x), torch.from_numpy(nbr))
    err = np.abs(got.numpy() - want).max()
    assert err > 1e-2 * np.abs(want).max()
    close(lstm_aggregate(pp, torch.from_numpy(x), torch.from_numpy(nbr)), want, "true order")


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_zero_neighbors_give_zeros(strategy):
    """k = 0: the JAX scan over no step returns its zero carry.  (JAX's
    'materialize' cannot reshape its [n, 0, -1] gather there, a fault of
    the reference; it is held to the JAX 'redundancy_bypass' result.)"""
    jp, pp, x, _ = inputs()
    nbr = np.zeros((50, 0), np.int32)
    j_strategy = "redundancy_bypass" if strategy == "materialize" else strategy
    want = np.asarray(j_lstm(jp, jnp.asarray(x), jnp.asarray(nbr), j_strategy))
    got = lstm_aggregate(pp, torch.from_numpy(x), torch.from_numpy(nbr), strategy)
    assert got.shape == want.shape == (50, pp.wh.shape[0]) and not got.any() and not want.any()


def test_init_params_and_errors():
    gen = torch.Generator().manual_seed(0)
    p = init_lstm_params(12, 16, gen, device="cpu")
    assert p.wx.shape == (12, 64) and p.wh.shape == (16, 64) and p.b.shape == (64,) and not p.b.any()
    assert p.wx.abs().max() <= 12**-0.5 and p.wh.abs().max() <= 16**-0.5
    sp = init_sage_lstm_params(BENCH_FEATURE_LEN, BENCH_FEATURE_LEN, 8, torch.Generator().manual_seed(1), device="cpu")
    assert sp.w_self.shape == (32, 32) and sp.w_out.shape == (64, 8) and sp.w_out.abs().max() <= 64**-0.5
    again = init_sage_lstm_params(32, 32, 8, torch.Generator().manual_seed(1), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip((*sp.lstm, sp.w_self, sp.w_out), (*again.lstm, again.w_self,
                                                                                    again.w_out)))
    assert BENCH_NUM_NEIGHBORS == 16
    with pytest.raises(ValueError, match="strategy"):
        lstm_aggregate(p, torch.zeros(4, 12), torch.zeros(4, 2, dtype=torch.long), "dgl")
