"""The port's Mamba2 / SSD layer (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm`` on the CPU: the chunked forward (with and
without front padding), its ``return_state`` cache, the decode step, the
init distributions, and the gradients.

Weights come from JAX's ``init_ssm`` and are copied into the port's
``SSM``; inputs are numpy draws from a seed. Tolerance: f32 outputs and
states within 1e-4 relative plus 1e-5 absolute (the two frameworks sum
the chunk products in other orders, ~1e-6 apart here); gradients within
GRAD_TOL of each leaf's largest magnitude.

At mamba2-1.3b's chunk of 256, JAX's gradient is not finite: its decay
``where(causal, exp(rel), 0)`` overflows above the diagonal and the
backward pass of ``where`` multiplies inf by 0. The port masks before the
``exp``; there its gradient is held to the gradient of its own sequential
recurrence (``ssd_decode_step`` token by token).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro_torch.models import common, ssm
from torch_parity import t

RTOL, ATOL = 1e-4, 1e-5
GRAD_TOL = 1e-4
#: the chunked form against the sequential recurrence: another summation
#: order over 256 tokens
SEQ_GRAD_TOL = 1e-3


def _cfgs(chunk, **kw):
    """The JAX package's own SSD test layer: d_model 64, d_inner 128, 8
    heads of 16, state 16, conv width 4, f32."""
    base = dict(arch_type="ssm", num_layers=1, d_model=64, ssm_state=16,
                ssm_head_dim=16, ssm_expand=2, ssm_chunk=chunk, conv_width=4,
                **kw)
    return (jcommon.ModelConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                                **base),
            common.ModelConfig(dtype=torch.float32, param_dtype=torch.float32,
                               **base))


def _layer(jcfg, tcfg, seed=0, conv_b=False):
    """JAX's ``init_ssm`` weights (``conv_b`` drawn when asked, else JAX's
    zero) and the port's ``SSM`` holding them."""
    params = jssm.init_ssm(jax.random.PRNGKey(seed), jcfg)
    if conv_b:
        params["conv_b"] = 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 7),
                                                   params["conv_b"].shape)
    layer = ssm.SSM(tcfg, "cpu")
    with torch.no_grad():
        for name, arr in params.items():
            getattr(layer, name).copy_(t(np.asarray(arr)))
    return params, layer


def _u(b, s, d=64, seed=1):
    return 0.5 * np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


# ---------------------------------------------------------------------------
# forward, cache, decode


@pytest.mark.parametrize("chunk,s,conv_b", [
    (8, 32, True),       # 4 chunks, no padding, a non-zero conv bias
    (16, 32, True),
    (8, 21, False),      # front-padded by 3 (JAX's own case: conv_b zero)
    (8, 21, True),       # front-padded, a non-zero conv bias
    (16, 5, False),      # shorter than one chunk
])
def test_ssd_forward_and_state_match_jax(chunk, s, conv_b):
    jcfg, tcfg = _cfgs(chunk)
    params, layer = _layer(jcfg, tcfg, seed=chunk + s, conv_b=conv_b)
    u = _u(2, s, seed=s)
    want, jcache = jax.jit(functools.partial(
        jssm.ssd_forward, cfg=jcfg, return_state=True))(params, jnp.asarray(u))
    got, cache = ssm.ssd_forward(layer, t(u), tcfg, return_state=True)
    assert got.shape == (2, s, 64)
    close(got, want)
    close(cache["conv"], jcache["conv"])
    close(cache["state"], jcache["state"])
    assert cache["state"].dtype == torch.float32
    close(ssm.ssd_forward(layer, t(u), tcfg), want)


@pytest.mark.parametrize("conv_b", [False, True])
def test_front_padding_leaves_real_tokens_alone(conv_b):
    """JAX's padding test on the port: the first 21 of 24 tokens, front
    padded to 24, give the full run's first 21 outputs and the
    token-by-token recurrence's; with JAX's zero ``conv_b`` and with a
    drawn one (a padded token's B row is zero, so nothing of it reaches a
    real token)."""
    jcfg, tcfg = _cfgs(8)
    _, layer = _layer(jcfg, tcfg, seed=3, conv_b=conv_b)
    u = t(_u(1, 24, seed=3))
    full = ssm.ssd_forward(layer, u, tcfg)
    ragged = ssm.ssd_forward(layer, u[:, :21], tcfg)
    close(ragged, full[:, :21].detach(), rtol=2e-4, atol=2e-4)
    cache, outs = ssm.init_ssm_cache(tcfg, 1, torch.float32), []
    for i in range(21):
        y, cache = ssm.ssd_decode_step(layer, u[:, i:i + 1], cache, tcfg)
        outs.append(y)
    close(ragged, torch.cat(outs, 1).detach(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("steps", [1, 3])
def test_ssd_decode_step_matches_jax(steps):
    """Decode steps from a random cache: outputs and the new conv history
    and f32 state each step."""
    jcfg, tcfg = _cfgs(8)
    params, layer = _layer(jcfg, tcfg, seed=5, conv_b=True)
    rng = np.random.default_rng(6)
    conv = rng.standard_normal((2, 3, 128)).astype(np.float32)
    state = 0.3 * rng.standard_normal((2, 8, 16, 16)).astype(np.float32)
    jcache = {"conv": jnp.asarray(conv), "state": jnp.asarray(state)}
    cache = {"conv": t(conv), "state": t(state)}
    u = _u(2, steps, seed=7)
    step = jax.jit(functools.partial(jssm.ssd_decode_step, cfg=jcfg))
    for i in range(steps):
        want, jcache = step(params, jnp.asarray(u[:, i:i + 1]), jcache)
        got, cache = ssm.ssd_decode_step(layer, t(u[:, i:i + 1]), cache, tcfg)
        close(got, want)
        close(cache["conv"], jcache["conv"])
        close(cache["state"], jcache["state"])


def test_prefill_state_then_decode_is_the_forward():
    """The port against itself: the cache of 16 tokens and a decode step
    give the 17-token forward's last output."""
    jcfg, tcfg = _cfgs(8)
    _, layer = _layer(jcfg, tcfg, seed=2, conv_b=True)
    u = t(_u(1, 17, seed=2))
    whole = ssm.ssd_forward(layer, u, tcfg)
    _, cache = ssm.ssd_forward(layer, u[:, :16], tcfg, return_state=True)
    y, _ = ssm.ssd_decode_step(layer, u[:, 16:], cache, tcfg)
    close(y[:, 0], whole[:, -1].detach(), rtol=2e-4, atol=2e-4)


def test_init_distributions():
    """``a_log`` is log(linspace(1, 16, h)) rounded once to f32 (within 2
    f32 ulp of JAX's, whose linspace and log round on their own), d_skip 1
    and norm_scale 0 exactly, dt_bias in [-4, -1), conv_b 0; the full
    width's leaves in JAX's dtypes."""
    _, tcfg = _cfgs(8)
    layer = ssm.SSM(tcfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    layer.reset_parameters(gen, tcfg)
    h = tcfg.ssm_heads
    want = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    np.testing.assert_array_equal(layer.a_log.numpy(), want)
    jax_a_log = np.asarray(jnp.log(jnp.linspace(1.0, 16.0, h)))
    # log(16) < 4: an f32 ulp there is at most 2^-22
    assert np.abs(layer.a_log.numpy() - jax_a_log).max() <= 2 * 2.0 ** -22
    assert torch.equal(layer.d_skip, torch.ones(h))
    assert torch.equal(layer.norm_scale, torch.zeros(tcfg.d_inner))
    assert torch.equal(layer.conv_b, torch.zeros(tcfg.d_inner))
    assert -4.0 <= float(layer.dt_bias.min()) <= float(layer.dt_bias.max()) < -1.0
    assert abs(float(layer.conv_w.std()) - 0.1) < 0.02
    w_out_bound = 2.0 / (tcfg.d_inner * 2 * tcfg.num_layers) ** 0.5
    assert float(layer.w_out.abs().max()) <= w_out_bound + 1e-6
    full = common.ModelConfig(arch_type="ssm", d_model=2048, ssm_state=128,
                              ssm_head_dim=64, num_layers=48)
    big = ssm.SSM(full, "meta")
    dtypes = {name: p.dtype for name, p in big.named_parameters()}
    assert dtypes["w_in"] == dtypes["conv_w"] == torch.bfloat16
    assert dtypes["a_log"] == dtypes["dt_bias"] == torch.float32
    assert tuple(big.w_in.shape) == (2048, 2 * 4096 + 2 * 128 + 64)


# ---------------------------------------------------------------------------
# gradients


def _grads(layer, cfg, u, r):
    """The port's gradient of sum(ssd_forward(u) * r) on every leaf."""
    params = dict(layer.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    out = ssm.ssd_forward(layer, u, cfg)
    grads = torch.autograd.grad((out * r).sum(), list(params.values()))
    return dict(zip(params, grads))


def _jax_grads(params, u, r, jcfg):
    return jax.jit(jax.grad(lambda p: jnp.sum(jssm.ssd_forward(
        p, jnp.asarray(u), jcfg) * jnp.asarray(r))))(params)


def test_ssd_gradient_matches_jax_at_chunk_16():
    jcfg, tcfg = _cfgs(16)
    params, layer = _layer(jcfg, tcfg, seed=11, conv_b=True)
    u, r = _u(2, 32, seed=12), _u(2, 32, seed=13)
    want = _jax_grads(params, u, r, jcfg)
    got = _grads(layer, tcfg, t(u), t(r))
    for name, g in got.items():
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g.numpy(), want[name]) <= GRAD_TOL, name


def test_ssd_gradient_at_chunk_256_is_finite_and_sequential():
    """One 256-token chunk (mamba2-1.3b's): JAX's gradient has non-finite
    leaves; the port's is finite on every leaf and equals the gradient of
    the token-by-token recurrence (``ssd_decode_step``) within
    SEQ_GRAD_TOL of each leaf's max."""
    jcfg, tcfg = _cfgs(256)
    params, layer = _layer(jcfg, tcfg, seed=21)
    u, r = _u(1, 256, seed=22), _u(1, 256, seed=23)
    want = _jax_grads(params, u, r, jcfg)
    bad = [k for k, g in want.items() if not np.isfinite(np.asarray(g)).all()]
    assert bad, "JAX's SSD gradient was finite at chunk 256"
    got = _grads(layer, tcfg, t(u), t(r))
    cache = ssm.init_ssm_cache(tcfg, 1, torch.float32)
    outs = []
    for i in range(256):
        y, cache = ssm.ssd_decode_step(layer, t(u[:, i:i + 1]), cache, tcfg)
        outs.append(y)
    params_t = dict(layer.named_parameters())
    seq = torch.autograd.grad((torch.cat(outs, 1) * t(r)).sum(),
                              list(params_t.values()))
    for (name, g), gs in zip(got.items(), seq):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g.numpy(), gs.numpy()) <= SEQ_GRAD_TOL, name
    # where JAX is finite, the port agrees with it
    for name in set(want) - set(bad):
        assert _rel(got[name].numpy(), want[name]) <= SEQ_GRAD_TOL, name


def test_forward_matches_jax_at_chunk_256():
    """The forward at chunk 256 is finite in both and agrees."""
    jcfg, tcfg = _cfgs(256)
    params, layer = _layer(jcfg, tcfg, seed=21)
    u = _u(1, 256, seed=22)
    close(ssm.ssd_forward(layer, t(u), tcfg),
          jax.jit(functools.partial(jssm.ssd_forward, cfg=jcfg))(
              params, jnp.asarray(u)))


def test_decode_cache_dtypes_follow_the_activation_dtype():
    _, tcfg = _cfgs(8)
    bf = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    cache = ssm.init_ssm_cache(bf, 3, bf.dtype)
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["conv"].shape == (3, 3, 128)
    assert cache["state"].dtype == torch.float32
    assert cache["state"].shape == (3, 8, 16, 16)
