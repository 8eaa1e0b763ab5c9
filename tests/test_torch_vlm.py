"""The port's VLM family (qwen2-vl-72b) against the JAX package on the CPU:
M-RoPE and its text positions, the configs and ``input_specs``, one
full-width attention sublayer, and the smoke config (2 layers, d_model
256, GQA 4/2 at hd 64, M-RoPE sections (8, 12, 12), 16 patches), f32:
the forward (with seeded patch embeddings over a 4 x 4 grid of positions,
and text-only; also the chunked attention and CE of ``get_optimized``),
prefill and decode steps on a linear cache and on a wrapped ring with
every cache leaf, greedy generation with the patches in ``extra_batch``,
one train step with the probe, weights carried across with no new leaf,
and both launchers.

Weights come from the JAX package's ``init_params`` and are carried across
with ``convert.lm_params_from_numpy``; tokens, patch embeddings and
queries are numpy draws from a seed. Tolerances, as
``test_torch_audio_lm.py``: f32 logits, activations and cache leaves
within 1e-4 relative plus 2e-5 absolute (the frameworks sum in other
orders); M-RoPE alone within 1e-5 relative plus 1e-5 absolute (cos and
sin of the same f32 angles, up to 8,766 rad, differ by an ulp or two
between the libraries); train-step metrics within 1e-5 relative, first
moments within GRAD_TOL of each leaf's max. Greedy tokens must be equal,
except after a step whose top-two logit gap is within that tolerance.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import probe as jprobe
from repro.models import attention as jattention
from repro.models import rope as jrope
from repro.models import transformer as jtr
from repro.serving import serve_step as jserve
from repro.training import adamw as jadamw
from repro.training import train_step as jtrain
from repro_torch import configs, convert
from repro_torch.convert import state_from_numpy
from repro_torch.core import probe
from repro_torch.kernels.bmu import ref as bmu_ref
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import attention, rope, transformer
from repro_torch.serving import serve_step
from repro_torch.training import adamw, train_step
from torch_parity import (F32_EPS, assert_caches_close, assert_close,
                          assert_greedy_agrees, replay, step_draws, t)

ARCH = "qwen2-vl-72b"
B, S = 2, 24
#: the smoke config's patches, as a GRID x GRID grid, and its width
NPATCH, GRID, D = 16, 4, 256
RTOL, ATOL = 1e-4, 2e-5
ROPE_TOL = 1e-5
GRAD_TOL = 1e-4


def jax_cfg(**kw):
    return dataclasses.replace(jconfigs.get_smoke(ARCH),
                               **{"remat": False, **kw})


def torch_cfg(**kw):
    return dataclasses.replace(configs.get_smoke(ARCH), **kw)


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jtr.init_params(jax.random.PRNGKey(1), jax_cfg())


def _model(cfg=None, trainable=False):
    tree = jax.tree.map(np.asarray, _jax_params())
    model = convert.lm_params_from_numpy(tree, cfg or torch_cfg(), "cpu")
    return model.requires_grad_(trainable)


def _tokens(s=S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, s)).astype(
        np.int32)


def _vision(seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, NPATCH, D)).astype(np.float32)


def _batches(toks, vision=True):
    """The same batch for both packages: tokens, and with ``vision`` the
    seeded patch embeddings and the grid's positions3."""
    batch = {"tokens": toks}
    if vision:
        batch["vision_embeds"] = _vision()
        batch["positions3"] = rope.grid_positions3(
            B, toks.shape[1], GRID, GRID).numpy()
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: t(v) for k, v in batch.items()})


def close(got, want, rtol=RTOL, atol=ATOL):
    assert_close(got, want, rtol, atol)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _no_dtypes(cfg):
    out = dataclasses.asdict(cfg)
    for key in ("dtype", "param_dtype"):
        out.pop(key)
    return out


# ---------------------------------------------------------------------------
# M-RoPE


def test_text_positions3_is_jax_s_bitwise():
    pos = np.random.default_rng(2).integers(0, 9000, (3, 7)).astype(np.int32)
    got = rope.text_positions3(t(pos))
    want = np.asarray(jrope.text_positions3(jnp.asarray(pos)))
    assert tuple(got.shape) == want.shape == (3, 3, 7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_grid_positions3_numbers_the_patches_then_the_text():
    """t 0, h the row, w the column of each patch; the text from the
    grid's largest coordinate + 1 on, equal in all three."""
    p3 = rope.grid_positions3(2, 10, 2, 3)
    assert p3.dtype == torch.int32 and tuple(p3.shape) == (3, 2, 10)
    assert p3[:, 1].tolist() == [[0] * 6 + [3, 4, 5, 6],
                                 [0, 0, 0, 1, 1, 1, 3, 4, 5, 6],
                                 [0, 1, 2, 0, 1, 2, 3, 4, 5, 6]]
    assert torch.equal(p3[:, 0], p3[:, 1])
    with pytest.raises(ValueError, match="does not fit"):
        rope.grid_positions3(1, 8, 3, 3)


#: (sections, head_dim, theta): the smoke config's at JAX's default theta,
#: and qwen2-vl-72b's
MROPE_CASES = [((8, 12, 12), 64, 1e4), ((16, 24, 24), 128, 1e6)]


@pytest.mark.parametrize("positions", ["text", "grid", "long"])
@pytest.mark.parametrize("sections,hd,theta", MROPE_CASES)
def test_apply_mrope_matches_jax(sections, hd, theta, positions):
    """``apply_mrope`` against JAX's on (B 2, S 40, H 3) heads: text
    positions (where both equal ``apply_rope``), a 6 x 6 grid of patches
    then text, and text positions up to 8,766 (the long_500k run's last
    decode position)."""
    rng = np.random.default_rng(hd + len(positions))
    x = rng.standard_normal((2, 40, 3, hd)).astype(np.float32)
    if positions == "grid":
        p3 = rope.grid_positions3(2, 40, 6, 6).numpy()
    else:
        start = 8727 if positions == "long" else 0
        pos = np.broadcast_to(np.arange(start, start + 40, dtype=np.int32),
                              (2, 40)).copy()
        p3 = np.broadcast_to(pos[None], (3, 2, 40)).copy()
    got = rope.apply_mrope(t(x), t(p3), theta, sections)
    want = jrope.apply_mrope(jnp.asarray(x), jnp.asarray(p3), theta,
                             sections)
    close(got, want, ROPE_TOL, ROPE_TOL)
    if positions != "grid":
        close(got, jrope.apply_rope(jnp.asarray(x), jnp.asarray(p3[0]),
                                    theta), ROPE_TOL, ROPE_TOL)
        torch.testing.assert_close(got, rope.apply_rope(t(x), t(p3[0]),
                                                        theta))
    with pytest.raises(AssertionError):
        rope.apply_mrope(t(x), t(p3), theta, (1,) + sections)


# ---------------------------------------------------------------------------
# configs, the layer plan, input specs


def test_configs_match_jax():
    """``get``, ``get_smoke`` and ``get_optimized`` field by field (the
    optimised config: chunked attention and CE); ``for_shape`` (long_500k's
    window) and ``cache_len_for`` at every shape."""
    for get in ("get", "get_smoke", "get_optimized"):
        assert (_no_dtypes(getattr(configs, get)(ARCH))
                == _no_dtypes(getattr(jconfigs, get)(ARCH))), get
    opt = configs.get_optimized(ARCH)
    assert (opt.attention_impl, opt.chunked_ce) == ("chunked", True)
    for shape in configs.SHAPES:
        ours = configs.for_shape(configs.get(ARCH), shape)
        theirs = jconfigs.for_shape(jconfigs.get(ARCH), shape)
        assert _no_dtypes(ours) == _no_dtypes(theirs), shape
        assert (configs.cache_len_for(ours, shape)
                == jconfigs.cache_len_for(theirs, shape)), shape
    assert configs.for_shape(configs.get(ARCH), "long_500k").window == 8192


def test_full_config_builds_with_jax_s_parameter_count():
    """The dense plan of 80 blocks; 72,705,384,448 parameters on the
    ``meta`` device, JAX's ``init_params`` count."""
    cfg = configs.get(ARCH)
    assert transformer._layer_plan(cfg) == jtr._layer_plan(
        jconfigs.get(ARCH)) == ([("blocks", "attn", 80, False)], [])
    model = transformer.Transformer(cfg, "meta")
    shapes = jax.eval_shape(functools.partial(jtr.init_params,
                                              cfg=jconfigs.get(ARCH)),
                            jax.random.PRNGKey(0))
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(shapes)) == 72_705_384_448


_DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
           jnp.float32: torch.float32}


@pytest.mark.parametrize("shape", sorted(jconfigs.SHAPES))
def test_input_specs_match_jax(shape):
    """For every architecture at ``shape``: the port's meta tensors have
    the keys, shapes and dtypes of JAX's ``ShapeDtypeStruct``s (the VLM's
    vision embeddings and (3, B, S) positions, (3, B, 1) at decode; the
    audio family's frames)."""
    for arch in jconfigs.ALIASES:
        ours = configs.input_specs(configs.get(arch), shape)
        theirs = jconfigs.input_specs(jconfigs.get(arch), shape)
        assert sorted(ours) == sorted(theirs), (arch, shape)
        for key, spec in theirs.items():
            x = ours[key]
            assert x.device.type == "meta", (arch, key)
            assert tuple(x.shape) == spec.shape, (arch, shape, key)
            assert x.dtype == _DTYPES[spec.dtype.type], (arch, shape, key)
    vlm = configs.input_specs(configs.get(ARCH), shape)
    kind = configs.SHAPES[shape]["kind"]
    assert ("vision_embeds" in vlm) == (kind != "decode")
    assert vlm["positions3"].shape[0] == 3


# ---------------------------------------------------------------------------
# one attention sublayer at full width


def test_full_width_attention_sublayer_matches_jax():
    """``self_attention`` at qwen2-vl-72b's width (d 8,192, GQA 64/8 at hd
    128, M-RoPE (16, 24, 24), theta 1e6), f32, B 1 x S 64 with a 6 x 6
    grid of patch positions then text: the output and the K/V before the
    GQA repeat."""
    jc = dataclasses.replace(jconfigs.get(ARCH), dtype=jnp.float32,
                             param_dtype=jnp.float32)
    tc = dataclasses.replace(configs.get(ARCH), dtype=torch.float32,
                             param_dtype=torch.float32)
    rng = np.random.default_rng(27)
    d = tc.d_model
    shapes = {"wq": (d, tc.q_dim), "wk": (d, tc.kv_dim),
              "wv": (d, tc.kv_dim), "wo": (tc.q_dim, d)}
    weights = {k: rng.standard_normal(s, dtype=np.float32) / np.sqrt(s[0])
               for k, s in shapes.items()}
    x = rng.standard_normal((1, 64, d), dtype=np.float32)
    p3 = rope.grid_positions3(1, 64, 6, 6)
    positions = np.arange(64, dtype=np.int32)[None]
    want, (wk, wv) = jattention.self_attention(
        {k: jnp.asarray(w) for k, w in weights.items()}, jnp.asarray(x),
        jnp.asarray(positions), jc, positions3=jnp.asarray(p3.numpy()))
    p = attention.Attention(tc, "meta")
    for k, w in weights.items():
        setattr(p, k, torch.nn.Parameter(torch.from_numpy(w),
                                         requires_grad=False))
    got, (k, v) = attention.self_attention(p, t(x), t(positions), tc,
                                           positions3=p3)
    close(got, want)
    close(k, wk)
    close(v, wv)


# ---------------------------------------------------------------------------
# the smoke model: forward, prefill, decode, generate


@pytest.mark.parametrize("vision", [True, False])
def test_forward_train_matches_jax(vision):
    jb, tb = _batches(_tokens(), vision)
    want, waux = jax.jit(functools.partial(jtr.forward_train,
                                           cfg=jax_cfg()))(_jax_params(), jb)
    got, aux = transformer.forward_train(_model(), tb, torch_cfg())
    close(got, want)
    assert float(aux) == float(waux) == 0.0


def test_patches_replace_the_first_token_embeddings():
    """The spliced rows are the patch embeddings whatever the tokens under
    them: changing those tokens changes nothing, changing a patch does."""
    cfg, model = torch_cfg(), _model()
    _, tb = _batches(_tokens())
    base = transformer.forward_hidden(model, tb, cfg)[0]
    other = dict(tb, tokens=tb["tokens"].clone())
    other["tokens"][:, :NPATCH] = (other["tokens"][:, :NPATCH] + 1) % 512
    assert torch.equal(transformer.forward_hidden(model, other, cfg)[0], base)
    moved = dict(tb, vision_embeds=tb["vision_embeds"].clone())
    moved["vision_embeds"][:, 0] += 1.0
    again = transformer.forward_hidden(model, moved, cfg)[0]
    assert float((again[:, -1] - base[:, -1]).abs().max()) > 1e-4


def test_optimized_chunked_path_matches_jax():
    """``get_optimized``'s settings (chunked attention over chunks of 8,
    chunked CE over 8 positions) on the smoke model with patches: the
    hidden states and the chunked CE against JAX's, and the CE against the
    port's own unchunked path."""
    kw = dict(attention_impl="chunked", chunked_ce=True, attention_chunk=8,
              ce_chunk=8)
    jc, tc = jax_cfg(**kw), torch_cfg(**kw)
    jb, tb = _batches(_tokens())
    want, _ = jtr.forward_hidden(_jax_params(), jb, jc)
    model = _model(tc)
    got, _ = transformer.forward_hidden(model, tb, tc)
    close(got, want)
    ce = transformer.chunked_ce_loss(model, got, tb["tokens"], tc)
    jce = jtr.chunked_ce_loss(_jax_params(), want, jb["tokens"], jc)
    assert _rel(float(ce), float(jce)) <= 1e-5
    full = train_step.lm_loss(_model(), dict(tb, labels=tb["tokens"]),
                              torch_cfg())[1]
    assert _rel(float(ce), float(full)) <= 1e-5


PREFILL_CASES = {
    # a 24-token prompt (16 patches first) on a 40-slot linear cache
    "linear": (0, S, 40),
    # a 40-token prompt on a 16-slot ring (the window), wrapped
    "ring": (16, 40, 16),
}


@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_prefill_and_decode_steps_match_jax(case):
    """Prefill with patches over the grid: the last logits and every cache
    leaf (the patches' K/V, rotated by the grid's positions, included);
    then 3 decode steps from JAX's cache carried across, the first two at
    M-RoPE positions given (Qwen2-VL's, continuing the grid's numbering)
    and the last at text positions, logits and caches after each."""
    window, s, cache_len = PREFILL_CASES[case]
    jc, tc = jax_cfg(window=window), torch_cfg(window=window)
    params, model = _jax_params(), _model(tc)
    jb, tb = _batches(_tokens(s))
    want, jcache = jax.jit(functools.partial(jtr.prefill, cfg=jc,
                                             cache_len=cache_len))(params, jb)
    got, cache = transformer.prefill(model, tb, tc, cache_len=cache_len)
    close(got, want)
    assert_caches_close(cache, jcache, RTOL, ATOL)
    cache = convert.lm_cache_from_numpy(jax.tree.map(np.asarray, jcache),
                                        torch.float32, "cpu")
    step = jax.jit(functools.partial(jtr.decode_step, cfg=jc))
    nxt = np.random.default_rng(6).integers(0, 512, (B, 3)).astype(np.int32)
    last = int(tb["positions3"].max())
    for i in range(3):
        pos = np.full((B,), s + i, np.int32)
        p3 = (np.full((3, B, 1), last + 1 + i, np.int32) if i < 2 else None)
        want, jcache = step(params, jnp.asarray(nxt[:, i:i + 1]),
                            jnp.asarray(pos), jcache,
                            positions3=None if p3 is None
                            else jnp.asarray(p3))
        got, cache = transformer.decode_step(
            model, t(nxt[:, i:i + 1]), t(pos), cache, tc,
            positions3=None if p3 is None else t(p3))
        close(got, want)
        assert_caches_close(cache, jcache, RTOL, ATOL)


def test_decode_matches_own_forward_text_only():
    """The port against itself, text only: prefill of S - 1 tokens and one
    decode step give the forward's last logits."""
    cfg, model = torch_cfg(), _model()
    toks = t(_tokens())
    want = transformer.forward(model, {"tokens": toks}, cfg)[:, -1]
    _, cache = transformer.prefill(model, {"tokens": toks[:, :S - 1]}, cfg,
                                   cache_len=S)
    got, _ = transformer.decode_step(
        model, toks[:, S - 1:], torch.full((B,), S - 1, dtype=torch.int32),
        cache, cfg)
    close(got, want.detach())


@pytest.mark.parametrize("vision", [True, False])
def test_generate_matches_jax_greedy(vision):
    """``generate`` with the patches and grid positions in ``extra_batch``
    (the decode steps at text positions from S on, in both), and
    text-only."""
    toks, new = _tokens(), 10
    jb, tb = _batches(toks, vision)
    jextra = {k: v for k, v in jb.items() if k != "tokens"}
    textra = {k: v for k, v in tb.items() if k != "tokens"}
    want = jserve.generate(_jax_params(), jax_cfg(), jb["tokens"], new,
                           S + new, jax.random.PRNGKey(0),
                           extra_batch=jextra)
    got, logits = serve_step.generate(_model(), torch_cfg(), tb["tokens"],
                                      new, S + new, extra_batch=textra,
                                      return_logits=True)
    assert got.shape == (B, new)
    assert_greedy_agrees(got, want, logits, 2 * (RTOL + ATOL))


def test_decode_step_passes_positions3():
    """``make_decode_step`` hands the batch's positions3 to the model:
    text positions equal to ``pos`` give the step without them, other
    positions another result."""
    cfg, model = torch_cfg(), _model()
    _, tb = _batches(_tokens())
    step = serve_step.make_decode_step(cfg)
    pos = torch.full((B,), S, dtype=torch.int32)
    tok = t(_tokens(1, seed=3))
    out = {}
    for name, p3 in (("none", None), ("text", rope.text_positions3(
            pos[:, None])), ("other", torch.full((3, B, 1), 5,
                                                 dtype=torch.int32))):
        _, cache = transformer.prefill(model, tb, cfg, cache_len=S + 4)
        batch = {"tokens": tok, "pos": pos}
        if p3 is not None:
            batch["positions3"] = p3
        out[name] = step(model, batch, cache)[1]
    assert torch.equal(out["none"], out["text"])
    assert float((out["other"] - out["none"]).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# training


def _jax_probe_state(pcfg, seed):
    """A JAX probe map with every counter one below threshold, so that a
    successful drive sets off a cascade; i > 0."""
    st = jprobe.init(jax.random.PRNGKey(seed), pcfg).afm
    c = jnp.full(st.c.shape, pcfg.theta - 1, jnp.int32)
    return jprobe.ProbeState(st._replace(c=c, i=jnp.int32(24)))


def test_train_step_with_the_probe_matches_jax():
    """One ``make_train_step`` step with the probe from JAX's weights
    (remat on in both), on a batch with the launcher's inputs (zero patch
    embeddings over min(num_patches, S // 2) tokens, text positions3,
    ``stub_inputs``): loss, ce, grad_norm and lr within 1e-5 relative, the
    new first moments (the clipped gradients times 1 - b1) within GRAD_TOL
    of each leaf's max; the probe (JAX's key chain replayed) on the pooled
    hidden states: the same cascade size and counters where the BMU gap
    exceeds the tie bound, the weights within the vectors' difference."""
    jc, tc = jax_cfg(remat=True), torch_cfg(remat=True)
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    jparams = _jax_params()
    toks = _tokens()
    extra = transformer.stub_inputs(tc, B, "cpu", seq=S)
    assert tuple(extra["vision_embeds"].shape) == (B, min(NPATCH, S // 2), D)
    batch = {"tokens": t(toks), "labels": t(toks), **extra}
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    pkw = dict(side=6, dim=D, i_max=4000, c_m=1.0)
    jp = jprobe.ProbeConfig(**pkw)
    pstate = _jax_probe_state(jp, seed=9)
    key = jax.random.PRNGKey(0)
    jstate = jtrain.TrainState(jparams, jadamw.adamw_init(jparams),
                               jnp.int32(0), pstate)
    jnew, jm = jax.jit(jtrain.make_train_step(jc, opt, jp))(jstate, jbatch,
                                                            key)
    model = _model(tc, trainable=True)
    state = train_step.TrainState(
        model, adamw.adamw_init(dict(model.named_parameters())),
        torch.zeros((), dtype=torch.int32),
        probe.ProbeState(state_from_numpy(pstate.afm, "cpu")))
    w0 = state.probe.afm.w.clone()
    draws = replay(step_draws(key, jp.afm_config(), B, heuristic=False,
                              waves=64))
    step = train_step.make_train_step(
        tc, adamw.AdamWConfig(**dataclasses.asdict(opt)),
        probe.ProbeConfig(**pkw))
    new, m = step(state, batch, draws)
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert _rel(m[k].numpy(), jm[k]) <= 1e-5, k
    want = jax.tree.map(np.asarray, jnew.opt.mu)
    for name, mu in new.opt.mu.items():
        w = convert._leaf(want, name)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(mu.numpy() - w).max()) <= GRAD_TOL * scale, name
    _, _, jh = jtr.forward_train(jparams, jbatch, jc, return_hidden=True)
    jvecs = np.asarray(jprobe.pool_hidden(jh))
    hidden = transformer.forward_train(_model(tc), batch, tc,
                                       return_hidden=True)[2]
    vec_err = float(np.abs(probe.pool_hidden(hidden).detach().numpy()
                           - jvecs).max())
    assert vec_err <= RTOL * np.abs(jvecs).max() + ATOL
    assert int(jm["probe_cascade"]) > 0
    gap = bmu_ref.top2_gap(w0, t(jvecs)).numpy()
    bound = bmu_ref.tie_bound(w0, t(jvecs)).numpy()
    if np.all(gap > bound + 4 * vec_err):
        assert int(m["probe_cascade"]) == int(jm["probe_cascade"])
        np.testing.assert_array_equal(new.probe.afm.c.numpy(),
                                      np.asarray(jnew.probe.afm.c))
        dw = np.abs(new.probe.afm.w.numpy() - np.asarray(jnew.probe.afm.w))
        assert dw.max() <= (vec_err + 64 * F32_EPS
                            * np.abs(np.asarray(jnew.probe.afm.w)).max())


def test_stub_inputs_are_jax_s_launcher_s():
    """The train launcher's VLM inputs (JAX's ``launch/train.py``): zero
    patch embeddings over min(num_patches, seq // 2) tokens and text
    positions3; nothing without ``seq`` (JAX's serve launcher feeds a VLM
    nothing)."""
    cfg = torch_cfg()
    assert transformer.stub_inputs(cfg, 3, "cpu") == {}
    for seq, npatch in ((64, 16), (20, 10)):
        extra = transformer.stub_inputs(cfg, 3, "cpu", seq=seq)
        assert sorted(extra) == ["positions3", "vision_embeds"]
        assert tuple(extra["vision_embeds"].shape) == (3, npatch, D)
        assert not bool(extra["vision_embeds"].any())
        want = np.broadcast_to(np.arange(seq), (3, 3, seq))
        np.testing.assert_array_equal(extra["positions3"].numpy(), want)
    assert transformer.stub_inputs(configs.get_smoke("llama3.2-1b"), 3,
                                   "cpu", seq=64) == {}


# ---------------------------------------------------------------------------
# weights


def test_weights_carry_across_with_no_new_leaf():
    """JAX's qwen2-vl smoke tree is the dense tree: every port parameter
    is one of its leaves, every leaf is reached, and the tree comes back
    unchanged; ``adamw.decays`` is JAX's ``ndim >= 2`` on every leaf."""
    params, model = _jax_params(), _model()
    assert sorted(params) == ["blocks", "embed", "ln_f", "unembed"]
    flat = jax.tree_util.tree_leaves_with_path(params)
    tree = convert.lm_params_to_numpy(model)
    assert len(flat) == len(jax.tree.leaves(tree))
    for path, leaf in flat:
        node = tree
        for entry in path:
            node = node[entry.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    paths = set()
    for name, p in model.named_parameters():
        where = transformer.layer_of(name)
        parts = (tuple(name.split(".")) if where is None
                 else (where[0], *where[2]))
        leaf = params
        for part in parts:
            leaf = leaf[part]
        assert adamw.decays(name, p) == (leaf.ndim >= 2), name
        paths.add(parts)
    assert paths == {tuple(e.key for e in path) for path, _ in flat}


# ---------------------------------------------------------------------------
# the launchers


def test_serve_launcher_runs_on_the_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                    "2", "--prompt-len", "12", "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke" in out and "generated (2, 4)" in out


def test_train_launcher_runs_on_the_cpu(capsys):
    losses = train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--steps", "3", "--batch", "2", "--seq", "16",
                             "--log-every", "1", "--probe"])
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert f"arch={ARCH}-smoke" in out and "done: loss" in out
    assert "probe_cascade=" in out
