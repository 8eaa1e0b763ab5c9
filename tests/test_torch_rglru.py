"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's ``repro.models.rglru`` on the CPU: the forward, its
``return_state`` cache, the decode step, the log-depth scan, the init
distributions and the gradients.

Weights come from JAX's ``init_rglru`` and are copied into the port's
``RGLRU``; inputs are numpy draws from a seed. The port's scan
(Hillis-Steele) sums in another order than ``lax.associative_scan``, so
the two agree along the trajectory within a tolerance, not bit for bit:
f32 outputs and states within 1e-4 relative plus 1e-5 absolute;
gradients within GRAD_TOL of each leaf's largest magnitude.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro.models import rglru as jrglru
from repro_torch.models import common, rglru
from torch_parity import t

RTOL, ATOL = 1e-4, 1e-5
GRAD_TOL = 1e-4
D, W = 64, 48


def _cfgs():
    base = dict(arch_type="hybrid", num_layers=3, d_model=D, lru_width=W,
                conv_width=4)
    return (jcommon.ModelConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                                **base),
            common.ModelConfig(dtype=torch.float32, param_dtype=torch.float32,
                               **base))


def _layer(seed=0):
    """JAX's ``init_rglru`` weights, with the zero biases drawn so that
    they count, and the port's ``RGLRU`` holding them."""
    jcfg, tcfg = _cfgs()
    params = jrglru.init_rglru(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 100)
    for name in ("conv_b", "b_a", "b_i"):
        params[name] = jnp.asarray(
            0.1 * rng.standard_normal(params[name].shape).astype(np.float32))
    layer = rglru.RGLRU(tcfg, "cpu")
    with torch.no_grad():
        for name, arr in params.items():
            getattr(layer, name).copy_(t(np.asarray(arr)))
    return params, layer, jcfg, tcfg


def _u(b, s, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, D)).astype(np.float32)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("s", [1, 2, 37, 64])
def test_rglru_forward_and_state_match_jax(s):
    params, layer, jcfg, tcfg = _layer(seed=s)
    u = _u(2, s, seed=s)
    want, jcache = jax.jit(functools.partial(
        jrglru.rglru_forward, cfg=jcfg, return_state=True))(params,
                                                            jnp.asarray(u))
    got, cache = rglru.rglru_forward(layer, t(u), tcfg, return_state=True)
    close(got, want)
    close(cache["h"], jcache["h"])
    assert cache["h"].dtype == torch.float32
    if s >= 3:                     # a whole conv history
        close(cache["conv"], jcache["conv"])


@pytest.mark.parametrize("steps", [1, 4])
def test_rglru_decode_step_matches_jax(steps):
    params, layer, jcfg, tcfg = _layer(seed=5)
    rng = np.random.default_rng(6)
    conv = rng.standard_normal((2, 3, W)).astype(np.float32)
    h = 0.5 * rng.standard_normal((2, W)).astype(np.float32)
    jcache = {"conv": jnp.asarray(conv), "h": jnp.asarray(h)}
    cache = {"conv": t(conv), "h": t(h)}
    u = _u(2, steps, seed=7)
    step = jax.jit(functools.partial(jrglru.rglru_decode_step, cfg=jcfg))
    for i in range(steps):
        want, jcache = step(params, jnp.asarray(u[:, i:i + 1]), jcache)
        got, cache = rglru.rglru_decode_step(layer, t(u[:, i:i + 1]), cache,
                                             tcfg)
        close(got, want)
        close(cache["conv"], jcache["conv"])
        close(cache["h"], jcache["h"])


def test_state_then_decode_is_the_forward():
    """The port against itself: the cache of 20 tokens and a decode step
    give the 21-token forward's last output."""
    _, layer, _, tcfg = _layer(seed=8)
    u = t(_u(1, 21, seed=8))
    whole = rglru.rglru_forward(layer, u, tcfg)
    _, cache = rglru.rglru_forward(layer, u[:, :20], tcfg, return_state=True)
    y, _ = rglru.rglru_decode_step(layer, u[:, 20:], cache, tcfg)
    close(y[:, 0], whole[:, -1].detach())


@pytest.mark.parametrize("s", [1, 5, 16, 100])
def test_linear_scan_is_the_recurrence(s):
    """``linear_scan`` against the sequential loop h_t = a_t h_{t-1} + b_t,
    within 1e-10 (f64 inputs, so only the order of the sums differs)."""
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (3, s, 7)))
    b = torch.from_numpy(rng.standard_normal((3, s, 7)))
    h, want = torch.zeros(3, 7, dtype=torch.float64), []
    for i in range(s):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    np.testing.assert_allclose(rglru.linear_scan(a, b).numpy(),
                               torch.stack(want, 1).numpy(), rtol=1e-10,
                               atol=1e-10)


def test_gradients_match_jax():
    params, layer, jcfg, tcfg = _layer(seed=9)
    u, r = _u(2, 24, seed=10), _u(2, 24, seed=11)
    want = jax.jit(jax.grad(lambda p: jnp.sum(jrglru.rglru_forward(
        p, jnp.asarray(u), jcfg) * jnp.asarray(r))))(params)
    leaves = dict(layer.named_parameters())
    for p in leaves.values():
        p.requires_grad_(True)
    out = rglru.rglru_forward(layer, t(u), tcfg)
    got = torch.autograd.grad((out * t(r)).sum(), list(leaves.values()))
    for name, g in zip(leaves, got):
        w = np.asarray(want[name], np.float64)
        err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL, (name, err)


def test_init_distributions():
    """sigmoid(lam) in [0.9, 0.999]; the gate weights f32 and the branch
    weights in ``param_dtype``; biases zero; the dense weights truncated
    at 2 / sqrt(d_in) (w_out at 2 / sqrt(2 W L))."""
    _, tcfg = _cfgs()
    layer = rglru.RGLRU(tcfg, "cpu")
    layer.reset_parameters(torch.Generator().manual_seed(0), tcfg)
    a = torch.sigmoid(layer.lam)
    assert 0.9 - 1e-6 <= float(a.min()) <= float(a.max()) <= 0.999 + 1e-6
    assert float(a.max() - a.min()) > 0.05               # spread, not one value
    for name in ("b_a", "b_i", "conv_b"):
        assert float(getattr(layer, name).abs().max()) == 0.0
    assert float(layer.w_a.abs().max()) <= 2.0 / W ** 0.5 + 1e-6
    assert float(layer.w_out.abs().max()) <= 2.0 / (W * 2 * 3) ** 0.5 + 1e-6
    assert abs(float(layer.conv_w.std()) - 0.1) < 0.02
    full = common.ModelConfig(arch_type="hybrid", d_model=2560,
                              lru_width=2560, num_layers=26)
    big = rglru.RGLRU(full, "meta")
    dtypes = {name: p.dtype for name, p in big.named_parameters()}
    assert dtypes["w_x"] == dtypes["w_gate"] == dtypes["w_out"] == torch.bfloat16
    assert all(dtypes[k] == torch.float32
               for k in ("w_a", "b_a", "w_i", "b_i", "lam"))
