"""The port's sliding-window decode op (``repro_torch.kernels.swa``) against
the JAX package's Pallas kernel (interpret mode) and its oracle, on the same
numpy inputs; and the op's dispatch (plain version on the CPU, the kernel or
an error on CUDA, validation of what the kernel takes).

Tolerance: 2e-4 relative and absolute in f32, the JAX package's own for this
kernel against its oracle (``tests/test_kernels.py``): the two frameworks sum
the logits and the PV product in other orders. bf16 outputs agree within one
bf16 ulp of the output plus 1e-3 (both sides round an f32 result to bf16
once, from sums taken in other orders).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.swa import ops as jswa_ops
from repro.kernels.swa import ref as jswa_ref
from repro.models import attention as jattention
from repro_torch.kernels.swa import ops as swa_ops
from repro_torch.kernels.swa import ref as swa_ref
from tests.test_torch_kernels import _cuda_like
from tests.torch_parity import t

TOL = 2e-4
BF16_ULP = 2.0 ** -7          # relative spacing of bf16 numbers


def _inputs(b, h, hkv, hd, w, pos, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, w, hkv, hd), dtype=np.float32)
    v = rng.standard_normal((b, w, hkv, hd), dtype=np.float32)
    # a different position in each row: rows of one call mask differently
    posv = np.array([pos + 37 * i for i in range(b)], np.int32)
    return q, k, v, posv


@pytest.mark.parametrize("b,h,hkv,hd,w,pos", [
    # the shapes of tests/test_kernels.py::test_swa_decode_matches_oracle
    (2, 8, 2, 64, 512, 100),
    (1, 4, 1, 128, 1024, 70_000),
    (3, 16, 8, 64, 256, 255),
    (2, 4, 4, 128, 128, 4),
    # first positions: one and four valid slots
    (1, 4, 1, 64, 128, 0),
    (1, 4, 1, 64, 128, 3),
    # rep 3 over a ragged cache (W = 96); rep 1, hd 128, W = 100
    (2, 6, 2, 64, 96, 60),
    (2, 3, 3, 128, 100, 120),
    # rows on both sides of a full ring (pos 40, 77 and 114 over W = 64)
    (3, 8, 2, 64, 64, 40),
    # hd 32 (the MoE configs' smoke widths): a linear cache and a ring
    (2, 4, 2, 32, 40, 20),
    (2, 4, 4, 32, 16, 30),
    # recurrentgemma-2b's local attention (hd 256, MQA: H 10 over one kv
    # head): the serve shape (B 4, W 192) and its 2,048-slot ring, wrapped
    (4, 10, 1, 256, 192, 150),
    (1, 10, 1, 256, 2048, 8703),
])
def test_swa_plain_matches_jax(b, h, hkv, hd, w, pos):
    q, k, v, posv = _inputs(b, h, hkv, hd, w, pos, seed=b * h + w + pos)
    pallas = jswa_ops.swa_decode(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(posv),
                                 interpret=True)
    oracle = jswa_ref.swa_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(posv),
                                     window=w)
    before = swa_ops.launches
    out = swa_ops.swa_decode(t(q), t(k), t(v), t(posv))
    assert swa_ops.launches == before           # the CPU runs no kernel
    assert out.shape == (b, h, hd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), rtol=TOL,
                               atol=TOL)


def test_swa_plain_bf16_matches_jax_oracle():
    q, k, v, posv = _inputs(2, 8, 2, 64, 256, 300, seed=11)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jswa_ref.swa_decode_ref(jq, jk, jv, jnp.asarray(posv),
                                              window=256), np.float32)
    tq, tk, tv = (t(x).bfloat16() for x in (q, k, v))
    out = swa_ops.swa_decode(tq, tk, tv, t(posv))
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    np.testing.assert_array_less(np.abs(got - want),
                                 BF16_ULP * np.abs(want) + 1e-3)


@pytest.mark.parametrize("pos", [0, 3, 31, 32, 100])
def test_swa_on_a_linear_cache_is_causal_attention(pos):
    """Decode over a linear cache (the model's ``window == 0``) masks
    ``j <= pos`` (all slots once pos >= S); the op's ring mask with W = S
    is the same function, so ``decode_attention`` calls it for both."""
    b, h, hkv, hd, s = 2, 4, 2, 64, 32
    q, k, v, _ = _inputs(b, h, hkv, hd, s, 0, seed=pos)
    posv = np.full((b,), pos, np.int32)
    mask = np.where(np.arange(s)[None, :] <= posv[:, None], 0.0,
                    jattention.NEG_INF).astype(np.float32)[:, None, None, :]
    rep = h // hkv
    want = jattention.attend(jnp.asarray(q)[:, None],
                             jnp.repeat(jnp.asarray(k), rep, axis=2),
                             jnp.repeat(jnp.asarray(v), rep, axis=2),
                             jnp.asarray(mask))[:, 0]
    out = swa_ops.swa_decode(t(q), t(k), t(v), t(posv))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _bad_inputs():
    q, k, v, pos = (t(x) for x in _inputs(2, 8, 2, 64, 16, 5, seed=0))
    return {
        "head dim 48": (q[..., :48], k[..., :48], v[..., :48], pos),
        "rep 17": (torch.zeros(2, 17, 64), k[:, :, :1], v[:, :, :1], pos),
        "head dim 512": (torch.zeros(2, 8, 512), torch.zeros(2, 16, 2, 512),
                         torch.zeros(2, 16, 2, 512), pos),
        "H not a multiple of Hkv": (q[:, :7], k, v, pos),
        "float16": (q.half(), k.half(), v.half(), pos),
        "mixed dtypes": (q, k.bfloat16(), v, pos),
        "int64 positions": (q, k, v, pos.long()),
        "k and v differ": (q, k, v[:, :8], pos),
        "batch disagrees": (q[:1], k, v, pos),
        "positions disagree": (q, k, v, pos[:1]),
        "k not 4-d": (q, k[0], v[0], pos),
        "empty cache": (q, k[:, :0], v[:, :0], pos),
    }


@pytest.mark.parametrize("what", sorted(_bad_inputs()))
def test_swa_rejects_what_the_kernel_does_not_take(what):
    """The op checks its inputs on both devices, so a CPU run refuses what
    the card would."""
    with pytest.raises(ValueError):
        swa_ops.swa_decode(*_bad_inputs()[what])


def test_swa_cuda_tensors_launch_the_kernel_or_raise(monkeypatch):
    """On CUDA tensors the op builds and launches its kernel or raises; it
    never falls back to the plain version, and counts no launch it did not
    make."""
    from repro_torch.kernels import _build

    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load", no_library)
    q, k, v, pos = _inputs(2, 8, 2, 64, 16, 5, seed=0)
    before = swa_ops.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        swa_ops.swa_decode(*(_cuda_like(x) for x in (q, k, v, pos)))
    with pytest.raises(ValueError, match="device"):
        swa_ops.swa_decode(t(q), _cuda_like(k), t(v), t(pos))
    with pytest.raises(ValueError, match="contiguous"):
        swa_ops.swa_decode(_cuda_like(q), _cuda_like(k).transpose(1, 2)
                           .contiguous().transpose(1, 2), _cuda_like(v),
                           _cuda_like(pos))
    assert swa_ops.launches == before


def test_swa_plain_version_is_the_oracle_in_torch():
    """``ref.swa_decode_ref`` with a window below the cache length (the
    oracle's general form) against the JAX oracle."""
    q, k, v, posv = _inputs(2, 4, 2, 64, 64, 90, seed=5)
    want = jswa_ref.swa_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(posv),
                                   window=20)
    got = swa_ref.swa_decode_ref(t(q), t(k), t(v), t(posv), window=20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("sms", [132, 114])
def test_swa_plan_fills_the_card_at_long_500k_and_keeps_serve_whole(sms):
    """long_500k (B 1, Hkv 8, W 8192): at least a block a SM, each split
    at least MIN_SPLIT_SLOTS slots; the serve shape (B 4, W 192): one
    split, the output written directly with no combine."""
    p = swa_ops.plan(1, 8, 8192, sms)
    assert 8 * p.splits >= sms and p.slots >= swa_ops.MIN_SPLIT_SLOTS
    if sms == 132:                                  # an H100 SXM
        assert p == swa_ops.Plan(32, 256)
    assert swa_ops.plan(4, 8, 192, sms) == swa_ops.Plan(1, 192)


@pytest.mark.parametrize("b,hkv,w", [(1, 8, 8192), (4, 8, 192), (1, 1, 1),
                                     (2, 2, 1000), (1, 1, 65536),
                                     (64, 8, 8192)])
def test_swa_plan_covers_the_ring_and_never_sees_pos(b, hkv, w):
    """The split plan is a function of (B, Hkv, W, SM count) alone: ``pos``
    lives on the card and the decode loop never syncs to read it. Its
    splits tile [0, W) with no empty tail and stay within the combine."""
    assert list(inspect.signature(swa_ops.plan).parameters) == \
        ["b", "hkv", "w", "sms"]
    p = swa_ops.plan(b, hkv, w, 132)
    assert p.splits * p.slots >= w > (p.splits - 1) * p.slots
    assert 1 <= p.splits <= swa_ops.MAX_SPLITS


def _split_plans(w, b, hkv):
    """The planner's plan, one split, and splits of 16 or 37 slots."""
    return [swa_ops.plan(b, hkv, w, 132), swa_ops.Plan(1, w),
            swa_ops.Plan(-(-w // 16), 16), swa_ops.Plan(-(-w // 37), 37)]


@pytest.mark.parametrize("b,h,hkv,hd,w,pos", [
    (1, 8, 2, 64, 512, 0),        # one valid slot: every other split empty
    (1, 8, 2, 64, 512, 15),       # nv = 16 ends on a split edge
    (1, 8, 2, 64, 512, 16),       # one past it
    (2, 8, 2, 64, 512, 100),
    (1, 4, 1, 128, 1024, 70_000),  # full, wrapped ring
    (3, 8, 2, 64, 64, 40),        # rows on both sides of a full ring
    (2, 6, 2, 128, 96, 60),
    (1, 8, 2, 32, 1024, 700),     # hd 32
])
def test_swa_split_combine_matches_the_pallas_kernel(b, h, hkv, hd, w, pos):
    """The kernel's split-and-combine arithmetic (plain, in base 2,
    ``ref.swa_decode_split_ref``) under several plans, empty splits
    included, against the Pallas kernel in interpret mode."""
    q, k, v, posv = _inputs(b, h, hkv, hd, w, pos, seed=b * h + w + pos)
    pallas = np.asarray(jswa_ops.swa_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(posv),
        interpret=True))
    for p in _split_plans(w, b, hkv):
        out = swa_ref.swa_decode_split_ref(t(q), t(k), t(v), t(posv), p)
        assert out.shape == (b, h, hd) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), pallas, rtol=TOL, atol=TOL)


def test_swa_split_combine_bf16_matches_jax_oracle():
    q, k, v, posv = _inputs(2, 8, 2, 64, 256, 300, seed=12)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jswa_ref.swa_decode_ref(jq, jk, jv, jnp.asarray(posv),
                                              window=256), np.float32)
    tq, tk, tv = (t(x).bfloat16() for x in (q, k, v))
    for p in _split_plans(256, 2, 2):
        out = swa_ref.swa_decode_split_ref(tq, tk, tv, t(posv), p)
        assert out.dtype == torch.bfloat16
        np.testing.assert_array_less(np.abs(out.float().numpy() - want),
                                     BF16_ULP * np.abs(want) + 1e-3)
