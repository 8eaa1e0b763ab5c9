"""The causal flash-attention op (``repro_torch.kernels.flash``) on the CPU:
its plain version (the kernels' algorithms written out) against the
attention the port already had (``attention._attend`` after the GQA repeat,
and autograd through it), the wrapper's dispatch and validation, the tile
plan, and the route by which ``self_attention`` takes the kernel.

Tolerances, relative to the largest magnitude of the compared output or
gradient, M:
- f32: 2e-6 M. Both sides form the same f32 products and sum them in
  another order (key tiles with an online rescale, against one softmax
  over the row): some 16 f32 ulps (2^-23 each) of M.
- bf16 forward: 2^-6 M. Both round the probabilities to bf16 once (2^-9
  relative each) but at other points (the tile's unnormalised p against
  the normalised row), and the output once: two bf16 ulps (2^-8) of the
  output on either side.
- bf16 gradients: 2^-6 M. Autograd rounds dP and each kv head's gradient
  of every query head to bf16 where the kernel keeps f32 and a bf16 high
  and low pair of dS, and both round the result once.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.flash import ref as flash_ref
from repro_torch.models import attention

F32_TOL = 2e-6
BF16_TOL = 2.0 ** -6


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the wrapper takes its
    kernel route here, where no card exists."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_like(x):
    return x.as_subclass(_FakeCuda)


def _inputs(b, s, h, hkv, hd, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(dtype)
            for shape in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd))]


def _naive(q, k, v):
    """The port's attention before this op: the GQA repeat, the causal mask,
    ``_attend``."""
    rep = q.shape[2] // k.shape[2]
    s = q.shape[1]
    mask = attention._causal_mask(s, s, 0)[None, None]
    return attention._attend(q, attention._repeat_kv(k, rep),
                             attention._repeat_kv(v, rep), mask)


def _tol(dtype):
    return F32_TOL if dtype == torch.float32 else BF16_TOL


def _close(got, want, dtype):
    want = want.detach().float()
    err = float((got.detach().float() - want).abs().max())
    assert err <= _tol(dtype) * float(want.abs().max()), err


#: (B, S, H, Hkv, hd): GQA rep 2 with S past one 64-key tile and ragged;
#: rep 1 at hd 128 over three tiles, ragged; MQA rep 4; S of one token and
#: of exactly one tile
SHAPES = [(2, 70, 4, 2, 64), (1, 130, 2, 2, 128), (1, 37, 4, 1, 64),
          (2, 1, 2, 1, 64), (1, 64, 2, 2, 128)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,hkv,hd", SHAPES)
def test_plain_forward_matches_attend(b, s, h, hkv, hd, dtype):
    q, k, v = _inputs(b, s, h, hkv, hd, dtype, seed=s + h + hd)
    out, lse = flash_ref.flash_forward_ref(q, k, v)
    assert out.dtype == dtype and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    _close(out, _naive(q, k, v), dtype)


@pytest.mark.parametrize("key_tile", [16, 64, 1000])
def test_plain_forward_lse_is_the_rows_logsumexp(key_tile):
    """lse is the natural log-sum-exp of each row's scaled, masked logits,
    whatever the tile: within 1e-5 (some f32 ulps of values of ~5)."""
    b, s, h, hkv, hd = 2, 90, 4, 2, 64
    q, k, v = _inputs(b, s, h, hkv, hd, torch.float32, seed=key_tile)
    _, lse = flash_ref.flash_forward_ref(q, k, v, key_tile=key_tile)
    kk = k.repeat_interleave(h // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(hd)
    logits = logits + attention._causal_mask(s, s, 0)
    want = torch.logsumexp(logits, dim=-1)
    assert float((lse - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,hkv,hd", SHAPES[:3])
def test_plain_backward_matches_autograd_of_attend(b, s, h, hkv, hd, dtype):
    """The backward written out as the kernel runs it (P from the saved
    lse, D = rowsum(dO o O), dS split into a high and a low part, dK and dV
    summed over each kv head's query heads) against autograd through
    ``_attend`` after the GQA repeat."""
    q, k, v = _inputs(b, s, h, hkv, hd, dtype, seed=3 * s + hd)
    gen = torch.Generator().manual_seed(s)
    d_out = torch.randn((b, s, h, hd), generator=gen).to(dtype)
    out, lse = flash_ref.flash_forward_ref(q, k, v)
    got = flash_ref.flash_backward_ref(q, k, v, out, lse, d_out)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(_naive(*leaves), leaves, d_out)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape
        _close(g, w, dtype)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_plain_backward_keeps_ds_to_16_bits(seed):
    """In bf16 the high and low parts of dS carry its f32 value to ~2^-16:
    dq from the split is the correctly rounded dq of f32 dS on all but a
    few elements (under 1 %, each one bf16 ulp off, where the f32 sum lies
    next to a rounding boundary), where dS rounded once (the high part
    alone) misses on a third of them."""
    q, k, v = _inputs(1, 80, 2, 2, 64, torch.bfloat16, seed=seed)
    d_out = torch.randn((1, 80, 2, 64), generator=torch.Generator()
                        .manual_seed(seed + 1)).to(torch.bfloat16)
    out, lse = flash_ref.flash_forward_ref(q, k, v)
    dq, _, _ = flash_ref.flash_backward_ref(q, k, v, out, lse, d_out)
    # the same algorithm with dS kept in f32, its product rounded once
    qf, kf = q.float(), k.float()
    x = torch.einsum("bqhd,bkhd->bhqk", qf, kf) / 8.0
    past = torch.ones(80, 80, dtype=torch.bool).triu(1)
    p = torch.where(past, 0.0, torch.exp(x - lse[..., None]))
    dp = torch.einsum("bqhd,bkhd->bhqk", d_out.float(), v.float())
    delta = (d_out.float() * out.float()).sum(-1).permute(0, 2, 1)
    ds = p * (dp - delta[..., None]) / 8.0
    want = torch.einsum("bhqk,bkhd->bqhd", ds, kf).bfloat16()
    hi_only = torch.einsum("bhqk,bkhd->bqhd", ds.bfloat16().float(),
                           kf).bfloat16()
    off = dq != want
    assert float(off.float().mean()) < 0.01
    ulp = 2.0 ** (torch.floor(torch.log2(want.float().abs())) - 7)
    # one ulp, or a few f32 ulps of the largest value where a sum cancels
    slack = torch.clamp(ulp, min=2.0 ** -16 * float(want.float().abs().max()))
    assert bool(((dq.float() - want.float()).abs()[off] <= slack[off]).all())
    assert float((hi_only != want).float().mean()) > 0.2


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_wrapper_on_the_cpu_is_the_plain_version(dtype):
    """CPU tensors take the plain forward and backward, bit for bit, and
    count no launch."""
    q, k, v = _inputs(2, 70, 4, 2, 64, dtype, seed=5)
    d_out = torch.randn((2, 70, 4, 64), generator=torch.Generator()
                        .manual_seed(6)).to(dtype)
    before = (flash_ops.launches_fwd, flash_ops.launches_bwd)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_ops.flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, d_out)
    want_out, lse = flash_ref.flash_forward_ref(q, k, v)
    want = flash_ref.flash_backward_ref(q, k, v, want_out, lse, d_out)
    assert torch.equal(out, want_out)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    assert (flash_ops.launches_fwd, flash_ops.launches_bwd) == before


def test_cuda_tensors_launch_the_kernel_or_raise(monkeypatch):
    """On CUDA tensors the op builds and launches its kernel or raises; it
    never falls back to the plain version, and counts no launch it did not
    make."""
    from repro_torch.kernels import _build

    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load", no_library)
    q, k, v = _inputs(1, 16, 4, 2, 64, torch.bfloat16, seed=0)
    before = (flash_ops.launches_fwd, flash_ops.launches_bwd)
    with pytest.raises(RuntimeError, match="nvcc"):
        flash_ops.flash_attention(*(_cuda_like(x) for x in (q, k, v)))
    with pytest.raises(ValueError, match="device"):
        flash_ops.flash_attention(q, _cuda_like(k), v)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_ops.flash_attention(*(_cuda_like(x.float()) for x in (q, k, v)))
    with pytest.raises(ValueError, match="contiguous"):
        flash_ops.flash_attention(
            _cuda_like(q), _cuda_like(k.transpose(1, 2).contiguous()
                                      .transpose(1, 2)), _cuda_like(v))
    assert (flash_ops.launches_fwd, flash_ops.launches_bwd) == before


@pytest.mark.parametrize("q_shape,kv_shape,dtypes,match", [
    ((1, 8, 2, 32), (1, 8, 1, 32), None, "head dims"),
    ((1, 8, 2, 256), (1, 8, 2, 256), None, "head dims"),
    ((1, 8, 3, 64), (1, 8, 2, 64), None, "multiple"),
    ((1, 8, 2, 64), (1, 9, 2, 64), None, "disagree"),
    ((2, 8, 2, 64), (1, 8, 2, 64), None, "disagree"),
    ((8, 2, 64), (1, 8, 2, 64), None, r"\(B, S, H, hd\)"),
    ((1, 8, 2, 64), (1, 8, 2, 64), (torch.bfloat16, torch.float32), "dtype"),
])
def test_wrapper_refuses_what_the_kernel_is_not_built_for(q_shape, kv_shape,
                                                          dtypes, match):
    """Head dims other than 64 and 128, H not a multiple of Hkv, shapes that
    disagree and mixed dtypes raise on every device."""
    dq, dkv = dtypes or (torch.float32, torch.float32)
    q = torch.zeros(q_shape, dtype=dq)
    kv = torch.zeros(kv_shape, dtype=dkv)
    with pytest.raises(ValueError, match=match):
        flash_ops.flash_attention(q, kv, kv)


#: (B, H, S, hd) -> forward rows a block on 132 SMs: granite's cell (B 32)
#: and its card tests (B 4), deepseek's ladder from its shortest to its
#: longest rung, one more prompt past the line
PLANS = [((32, 16, 1024, 64), 128), ((4, 16, 1024, 64), 128),
         ((1, 16, 576, 128), 64), ((1, 16, 1500, 128), 64),
         ((1, 16, 2112, 128), 128), ((1, 16, 3968, 128), 128),
         ((1, 16, 2048, 128), 64)]


@pytest.mark.parametrize("shape,rows", PLANS)
def test_plan_of_the_cells_shapes(shape, rows):
    b, h, s, hd = shape
    assert flash_ops.plan(b, h, s, hd, 132) == rows
    blocks = b * h * -(-s // rows)
    # 128 rows only where that still gives two blocks a SM; 64 rows give
    # the shortest prompt more blocks than the card has SMs
    assert blocks >= 132
    if rows == 64:
        assert b * h * -(-s // 128) < 2 * 132


@pytest.mark.parametrize("args", [(0, 16, 1024, 64, 132),
                                  (1, 16, 1024, 32, 132),
                                  (1, 16, 0, 64, 132)])
def test_plan_refuses_empty_shapes_and_other_head_dims(args):
    with pytest.raises(ValueError):
        flash_ops.plan(*args)


#: flash_route's arguments on the main path of both cells, then one change
#: at a time; only the first takes the kernel
ROUTE_BASE = dict(device_type="cuda", dtype=torch.bfloat16, causal=True,
                  window=0, hd=64, impl="naive", dtensor=False, padded=False)
ROUTE_CASES = [
    ({}, True), (dict(hd=128), True),
    (dict(device_type="cpu"), False), (dict(device_type="meta"), False),
    (dict(dtype=torch.float32), False), (dict(dtype=torch.float16), False),
    (dict(causal=False), False), (dict(window=4096), False),
    (dict(hd=32), False), (dict(hd=256), False), (dict(hd=96), False),
    (dict(impl="chunked"), False), (dict(dtensor=True), False),
    (dict(padded=True), False),
]


@pytest.mark.parametrize("change,takes", ROUTE_CASES,
                         ids=[",".join(f"{k}={v}" for k, v in c.items())
                              or "main_path" for c, _ in ROUTE_CASES])
def test_route_to_the_kernel(change, takes):
    assert attention.flash_route(**{**ROUTE_BASE, **change}) is takes


@pytest.mark.parametrize("arch,takes", [
    ("granite-moe-1b-a400m", True), ("deepseek-moe-16b", True),
    ("llama3.2-1b", True), ("recurrentgemma-2b", False)])
def test_route_of_the_faithful_configs_on_the_card(arch, takes):
    """The faithful configs as the card runs them (bf16, naive): granite
    (hd 64) and deepseek (hd 128), the cells' models, and llama3.2-1b take
    the kernel; recurrentgemma's local attention (hd 256, a window) keeps
    its path; ``get_optimized``'s chunked path never takes it."""
    cfg = configs.get(arch)
    q = torch.empty((1, 1, cfg.num_heads, cfg.hd), dtype=torch.bfloat16,
                    device="meta")
    route = attention.flash_route("cuda", q.dtype, True, cfg.window, cfg.hd,
                                  cfg.attention_impl, False,
                                  cfg.pad_heads_to > cfg.num_heads)
    assert route is takes
    opt = configs.get_optimized(arch)
    if opt.attention_impl == "chunked":
        assert not attention.flash_route("cuda", q.dtype, True, opt.window,
                                         opt.hd, opt.attention_impl, False,
                                         opt.pad_heads_to > opt.num_heads)


@pytest.mark.parametrize("hd,window", [(64, 0), (128, 0), (64, 16)])
def test_self_attention_wires_the_kernel(monkeypatch, hd, window):
    """``self_attention`` with the route forced open on the CPU: the op
    takes q, k and v before the GQA repeat and the result, its projection
    and its gradients equal the naive path's within the bf16 bounds; with
    a window the route stays closed and the naive path runs."""
    cfg = dataclasses.replace(
        configs.get_smoke("llama3.2-1b"), dtype=torch.bfloat16,
        param_dtype=torch.bfloat16, head_dim=hd, window=window)
    assert cfg.num_heads > cfg.num_kv_heads and cfg.hd == hd
    torch.manual_seed(0)
    p = attention.Attention(cfg)
    p.reset_parameters(torch.Generator().manual_seed(1), cfg)
    x = torch.randn((2, 40, cfg.d_model)).to(torch.bfloat16)
    positions = torch.arange(40)[None].expand(2, 40)

    def run():
        xx = x.clone().requires_grad_()
        out, (k, v) = attention.self_attention(p, xx, positions, cfg)
        (g,) = torch.autograd.grad(out.float().square().sum(), xx)
        return out, k, v, g

    want = run()
    calls = []
    real = flash_ops.flash_attention

    def spy(q, k, v):
        calls.append((q.shape, k.shape))
        return real(q, k, v)

    route = attention.flash_route
    monkeypatch.setattr(flash_ops, "flash_attention", spy)
    monkeypatch.setattr(attention, "flash_route",
                        lambda device_type, *rest: route("cuda", *rest))
    got = run()
    if window:
        assert calls == []
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        return
    assert calls == [((2, 40, cfg.num_heads, hd),
                      (2, 40, cfg.num_kv_heads, hd))]
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b, torch.bfloat16)


def test_attend_counts_its_cuda_calls():
    """``attend`` counts the calls on plain CUDA tensors (those that did
    not take the kernel), not CPU ones."""
    q, k, v = _inputs(1, 8, 2, 2, 64, torch.float32, seed=2)
    mask = attention._causal_mask(8, 8, 0)[None, None]
    before = attention.plain_cuda_calls
    attention.attend(q, k, v, mask)
    assert attention.plain_cuda_calls == before
    attention.attend(*(_cuda_like(x) for x in (q, k, v)), mask)
    assert attention.plain_cuda_calls == before + 1


#: (name, got from want) for ``err_units``: one bf16 ulp at the largest
#: value; a late causal row (values ~0.03) moved by 8 %, as a dropped key
#: tile moves it; noise of 1e-6 on a row that is 0 (dq of query 0)
ERR_WANT = torch.tensor([[4.0, -3.0, 2.0, 1.0], [0.03, -0.02, 0.025, 0.01],
                         [0.0, 0.0, 0.0, 0.0]])
ERR_CASES = [("one ulp", lambda w: w + torch.tensor([[2.0 ** -5, 0, 0, 0],
                                                     [0] * 4, [0] * 4]),
              0.0, 1.0),
             ("late row", lambda w: w * torch.tensor([[1.0], [1.08], [1.0]]),
              9.0, 11.0),
             ("zero row", lambda w: w + torch.tensor([[0.0] * 4, [0.0] * 4,
                                                      [1e-6] * 4]),
              0.0, 0.1)]


@pytest.mark.parametrize("name,move,lo,hi", ERR_CASES)
def test_err_units_reads_ulps_of_the_value_or_its_row(name, move, lo, hi):
    """``flash_ref.err_units``, the card checks' measure: an ulp of the
    largest value reads at most 1; the late row's 8 % reads about 10 (a
    unit there is 2^-7 of 0.03), where 2^-7 of the tensor's largest value
    would pass it; a row of zeros takes 2^-8 of the tensor's RMS as its
    scale; a slack as large as the difference reads 0."""
    got = move(ERR_WANT)
    assert lo <= flash_ref.err_units(got, ERR_WANT) <= hi
    if name == "late row":
        assert float((got - ERR_WANT).abs().max()) < 2.0 ** -7 * 4.0
    assert flash_ref.err_units(got, ERR_WANT,
                               (got - ERR_WANT).abs()) == 0.0
