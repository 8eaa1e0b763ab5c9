"""The port's audio family (whisper-medium) against the JAX package on the
CPU, at its smoke config (2 encoder and 2 decoder layers, d_model 128, MHA
4/4, GELU MLP, 64 frames, learned positions), f32: configs, the layer
plan, cross-attention and the encoder alone, the forward, prefill and
decode steps (on a linear cache and on a wrapped ring), greedy generation
with frames, one train step with and without the probe, AdamW's decay rule
on every leaf, weights, caches and checkpoints, both launchers, and the
decode's two ``swa_decode`` calls a decoder layer.

Weights come from the JAX package's ``init_params`` and are carried across
with ``convert.lm_params_from_numpy``; tokens and frames are numpy draws
from a seed (frames not zeros, so the encoder matters). Tolerances, as
``test_torch_recurrent_lm.py``: f32 logits, activations and cache leaves
within 1e-4 relative plus 2e-5 absolute (the frameworks sum in other
orders); train-step metrics within 1e-5 relative, first moments within
GRAD_TOL of each leaf's max. Greedy tokens must be equal, except after a
step whose top-two logit gap is within that tolerance.
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
from repro.models import transformer as jtr
from repro.serving import serve_step as jserve
from repro.training import adamw as jadamw
from repro.training import checkpoint as jckpt
from repro.training import train_step as jtrain
from repro_torch import configs, convert
from repro_torch.convert import state_from_numpy
from repro_torch.core import probe
from repro_torch.kernels.bmu import ref as bmu_ref
from repro_torch.kernels.swa import ops as swa_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import attention, transformer
from repro_torch.serving import serve_step
from repro_torch.training import adamw, checkpoint, train_step
from torch_parity import F32_EPS, replay, step_draws, t

ARCH = "whisper-medium"
B, S = 2, 24
RTOL, ATOL = 1e-4, 2e-5
GRAD_TOL = 1e-4
#: the smoke config's encoder length and width
SE, D = 64, 128


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


def _frames(seed=1, se=SE):
    return np.random.default_rng(seed).standard_normal((B, se, D)).astype(
        np.float32)


def _batches(toks, frames):
    return ({"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
            {"tokens": t(toks), "frames": t(frames)})


def close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _close_caches(cache, jcache):
    assert sorted(cache) == sorted(jcache)
    for name, entry in cache.items():
        assert sorted(entry) == sorted(jcache[name]), name
        for leaf, x in entry.items():
            assert tuple(x.shape) == tuple(jcache[name][leaf].shape)
            close(x, jcache[name][leaf])


def _jax_path(name):
    where = transformer.layer_of(name)
    return tuple(name.split(".")) if where is None else (where[0], *where[2])


def _jax_leaf(tree, name):
    for part in _jax_path(name):
        tree = tree[part]
    return tree


# ---------------------------------------------------------------------------
# configs and the layer plan


def test_configs_match_jax():
    """``get`` and ``get_smoke`` field by field; ``for_shape`` (the learned
    position table grown to the shape, long_500k's window) and
    ``cache_len_for`` at every shape."""
    for get in ("get", "get_smoke"):
        ours = dataclasses.asdict(getattr(configs, get)(ARCH))
        theirs = dataclasses.asdict(getattr(jconfigs, get)(ARCH))
        for key in ("dtype", "param_dtype"):
            ours.pop(key), theirs.pop(key)
        assert ours == theirs, get
    for shape in configs.SHAPES:
        ours = dataclasses.asdict(configs.for_shape(configs.get(ARCH), shape))
        theirs = dataclasses.asdict(jconfigs.for_shape(jconfigs.get(ARCH),
                                                       shape))
        for key in ("dtype", "param_dtype"):
            ours.pop(key), theirs.pop(key)
        assert ours == theirs, shape
        assert (configs.cache_len_for(configs.for_shape(configs.get(ARCH),
                                                        shape), shape)
                == jconfigs.cache_len_for(jconfigs.for_shape(
                    jconfigs.get(ARCH), shape), shape)), shape
    assert configs.for_shape(configs.get(ARCH),
                             "long_500k").max_positions == 524_289


def test_get_optimized_builds_whisper():
    """whisper-medium has no optimised settings in either package: its
    ``get_optimized`` is its faithful config, and it builds with JAX's
    parameter count (~820.9 M)."""
    ours = dataclasses.asdict(configs.get_optimized(ARCH))
    theirs = dataclasses.asdict(jconfigs.get_optimized(ARCH))
    for key in ("dtype", "param_dtype"):
        ours.pop(key), theirs.pop(key)
    assert ours == theirs
    assert configs.get_optimized(ARCH) == configs.get(ARCH)
    assert ARCH not in configs.OPTIMIZED
    model = transformer.Transformer(configs.get_optimized(ARCH), "meta")
    shapes = jax.eval_shape(functools.partial(
        jtr.init_params, cfg=jconfigs.get_optimized(ARCH)),
        jax.random.PRNGKey(0))
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(shapes)) == 820_912_128


def test_layer_plans_match_jax():
    """The encoder's stack without cross-attention, the decoder's with it;
    the encoder's stack gets no cache, the decoder's cross K/V over
    ``encoder_seq`` frames."""
    for get in ("get", "get_smoke"):
        cfg = getattr(configs, get)(ARCH)
        jc = getattr(jconfigs, get)(ARCH)
        assert transformer._layer_plan(cfg) == jtr._layer_plan(jc)
    assert transformer._layer_plan(configs.get(ARCH)) == (
        [("enc_blocks", "attn", 24, False), ("dec_blocks", "attn", 24, True)],
        [])
    cache = transformer.init_cache(torch_cfg(), B, 40, device="cpu")
    jcache = jtr.init_cache(jax_cfg(), B, 40)
    assert sorted(cache) == sorted(jcache) == ["dec_blocks"]
    for leaf, x in cache["dec_blocks"].items():
        assert tuple(x.shape) == jcache["dec_blocks"][leaf].shape, leaf
    assert tuple(cache["dec_blocks"]["cross_k"].shape) == (2, B, SE, 4, 32)


# ---------------------------------------------------------------------------
# cross-attention and the encoder alone


def test_cross_attention_matches_jax():
    """``cross_attention`` of 7 queries over 64 encoder rows (no RoPE, a
    zero mask), from the K/V of the encoder's rows and from ``cross_kv``
    computed once."""
    jc, tc = jax_cfg(), torch_cfg()
    params = _jax_params()["dec_blocks"]["cross"]
    p = attention.Attention(tc, "cpu")
    with torch.no_grad():
        for k in ("wq", "wk", "wv", "wo"):
            getattr(p, k).copy_(t(np.asarray(params[k])[1]))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 7, D)).astype(np.float32)
    src = rng.standard_normal((B, SE, D)).astype(np.float32)
    want = jattention.cross_attention(
        jax.tree.map(lambda a: a[1], params), jnp.asarray(x),
        jnp.asarray(src), jc)
    close(attention.cross_attention(p, t(x), t(src), tc), want)
    kv = attention.cross_kv(p, t(src), tc)
    close(attention.cross_attention(p, t(x), None, tc, kv=kv), want)


def test_encode_matches_jax_and_is_bidirectional():
    """``_encode`` (learned positions, two bidirectional blocks,
    ``enc_ln_f``) against JAX's; changing the last frame moves the first
    frame's output, as only a bidirectional encoder does."""
    frames = _frames()
    want = jtr._encode(_jax_params(), jnp.asarray(frames), jax_cfg())
    model, cfg = _model(), torch_cfg()
    got = transformer._encode(model, t(frames), cfg)
    close(got, want)
    moved = frames.copy()
    moved[:, -1] += 1.0
    again = transformer._encode(model, t(moved), cfg)
    assert float((again[:, 0] - got[:, 0]).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="frames"):
        transformer._encode(model, t(_frames(se=SE + 1)), cfg)


# ---------------------------------------------------------------------------
# forward, prefill, decode, generate


def test_forward_train_matches_jax():
    jb, tb = _batches(_tokens(), _frames())
    want, waux = jax.jit(functools.partial(jtr.forward_train,
                                           cfg=jax_cfg()))(_jax_params(), jb)
    got, aux = transformer.forward_train(_model(), tb, torch_cfg())
    close(got, want)
    assert float(aux) == float(waux) == 0.0


PREFILL_CASES = {
    # a 24-token prompt on a 40-slot linear cache
    "linear": (0, S, 40),
    # a 40-token prompt on a 16-slot ring (the window), wrapped
    "ring": (16, 40, 16),
}


@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_prefill_and_decode_steps_match_jax(case):
    """Prefill: the last logits and every cache leaf (``cross_k`` and
    ``cross_v`` included); then 3 decode steps from JAX's cache carried
    across (``lm_cache_from_numpy``), logits and caches after each."""
    window, s, cache_len = PREFILL_CASES[case]
    jc, tc = jax_cfg(window=window), torch_cfg(window=window)
    params, model = _jax_params(), _model(tc)
    jb, tb = _batches(_tokens(s), _frames())
    want, jcache = jax.jit(functools.partial(jtr.prefill, cfg=jc,
                                             cache_len=cache_len))(params, jb)
    got, cache = transformer.prefill(model, tb, tc, cache_len=cache_len)
    close(got, want)
    _close_caches(cache, jcache)
    cache = convert.lm_cache_from_numpy(jax.tree.map(np.asarray, jcache),
                                        torch.float32, "cpu")
    step = jax.jit(functools.partial(jtr.decode_step, cfg=jc))
    nxt = np.random.default_rng(6).integers(0, 512, (B, 3)).astype(np.int32)
    for i in range(3):
        pos = np.full((B,), s + i, np.int32)
        want, jcache = step(params, jnp.asarray(nxt[:, i:i + 1]),
                            jnp.asarray(pos), jcache)
        got, cache = transformer.decode_step(model, t(nxt[:, i:i + 1]),
                                             t(pos), cache, tc)
        close(got, want)
        _close_caches(cache, jcache)


def test_decode_matches_own_forward():
    """The port against itself: prefill of S - 1 tokens and one decode step
    give the forward's last logits, over the same frames."""
    cfg, model = torch_cfg(), _model()
    toks, frames = t(_tokens()), t(_frames())
    want = transformer.forward(model, {"tokens": toks, "frames": frames},
                               cfg)[:, -1]
    _, cache = transformer.prefill(
        model, {"tokens": toks[:, :S - 1], "frames": frames}, cfg,
        cache_len=S)
    got, _ = transformer.decode_step(
        model, toks[:, S - 1:], torch.full((B,), S - 1, dtype=torch.int32),
        cache, cfg)
    close(got, want.detach())


def test_generate_matches_jax_greedy():
    """``generate`` with the frames in ``extra_batch`` against JAX's."""
    toks, frames, new = _tokens(), _frames(), 10
    want = jserve.generate(_jax_params(), jax_cfg(), jnp.asarray(toks), new,
                           S + new, jax.random.PRNGKey(0),
                           extra_batch={"frames": jnp.asarray(frames)})
    got, logits = serve_step.generate(_model(), torch_cfg(), t(toks), new,
                                      S + new,
                                      extra_batch={"frames": t(frames)},
                                      return_logits=True)
    assert got.shape == (B, new)
    want = np.asarray(want)
    for row in range(B):
        differ = np.flatnonzero(got[row].numpy() != want[row])
        if differ.size:
            top2 = np.sort(logits[row, differ[0]].numpy())[-2:]
            assert top2[1] - top2[0] <= 2 * (RTOL + ATOL), (row, differ[0])


def test_decode_calls_swa_decode_twice_a_decoder_layer(monkeypatch):
    """Each decode step calls ``swa_ops.swa_decode`` once for a decoder
    layer's self-attention (over the cache's W slots at ``pos``) and once
    for its cross-attention (over the Se frames at Se - 1, every row); the
    encoder's layers call it never."""
    calls = []

    def counted(q, k, v, pos):
        calls.append((k.shape[1], pos.tolist()))
        return real(q, k, v, pos)

    real = swa_ops.swa_decode
    monkeypatch.setattr(swa_ops, "swa_decode", counted)
    cfg, model = torch_cfg(), _model()
    _, cache = transformer.prefill(
        model, {"tokens": t(_tokens()), "frames": t(_frames())}, cfg,
        cache_len=40)
    assert not calls
    for i in range(2):
        transformer.decode_step(model, t(_tokens(1, seed=i)),
                                torch.full((B,), S + i, dtype=torch.int32),
                                cache, cfg)
    layers = cfg.num_layers
    assert len(calls) == 2 * 2 * layers
    assert calls[:2] == [(40, [S] * B), (SE, [SE - 1] * B)]
    assert calls.count((SE, [SE - 1] * B)) == 2 * layers


# ---------------------------------------------------------------------------
# training


def _state(model, probe_state=None):
    return train_step.TrainState(
        model, adamw.adamw_init(dict(model.named_parameters())),
        torch.zeros((), dtype=torch.int32), probe_state)


def _jax_probe_state(pcfg, seed):
    """A JAX probe map with every counter one below threshold, so that a
    successful drive sets off a cascade; i > 0."""
    st = jprobe.init(jax.random.PRNGKey(seed), pcfg).afm
    c = jnp.full(st.c.shape, pcfg.theta - 1, jnp.int32)
    return jprobe.ProbeState(st._replace(c=c, i=jnp.int32(24)))


@pytest.mark.parametrize("with_probe", [False, True])
def test_train_step_matches_jax(with_probe):
    """One ``make_train_step`` step from JAX's weights (remat on in both,
    so the encoder's gradient flows through the decoder blocks'
    checkpoints): loss, ce, grad_norm and lr within 1e-5 relative, the new
    first moments (the clipped gradients times 1 - b1, the encoder's and
    the cross-attention's included) within GRAD_TOL of each leaf's max.
    With the probe (JAX's key chain replayed) on the decoder's pooled
    hidden states: the same cascade size and counters where the BMU gap
    exceeds the tie bound, the weights within the vectors' difference."""
    jc, tc = jax_cfg(remat=True), torch_cfg(remat=True)
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    jparams = _jax_params()
    toks, frames = _tokens(), _frames()
    batch = {"tokens": toks, "labels": toks, "frames": frames}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    pkw = dict(side=6, dim=D, i_max=4000, c_m=1.0)
    jp = jprobe.ProbeConfig(**pkw) if with_probe else None
    pstate = _jax_probe_state(jp, seed=9) if with_probe else None
    key = jax.random.PRNGKey(0)
    jstate = jtrain.TrainState(jparams, jadamw.adamw_init(jparams),
                               jnp.int32(0), pstate)
    jnew, jm = jax.jit(jtrain.make_train_step(jc, opt, jp))(jstate, jbatch,
                                                            key)
    model = _model(tc, trainable=True)
    tp = probe.ProbeConfig(**pkw) if with_probe else None
    state = _state(model, probe.ProbeState(state_from_numpy(
        pstate.afm, "cpu")) if with_probe else None)
    w0 = state.probe.afm.w.clone() if with_probe else None
    draws = (replay(step_draws(key, jp.afm_config(), B, heuristic=False,
                               waves=64)) if with_probe else None)
    step = train_step.make_train_step(
        tc, adamw.AdamWConfig(**dataclasses.asdict(opt)), tp)
    new, m = step(state, {k: t(v) for k, v in batch.items()}, draws)
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert _rel(m[k].numpy(), jm[k]) <= 1e-5, k
    want = jax.tree.map(np.asarray, jnew.opt.mu)
    for name, mu in new.opt.mu.items():
        w = convert._leaf(want, name)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(mu.numpy() - w).max()) <= GRAD_TOL * scale, name
    assert float(new.opt.mu["enc_blocks.0.attn.wq"].abs().max()) > 0
    if not with_probe:
        return
    _, _, jh = jtr.forward_train(jparams, jbatch, jc, return_hidden=True)
    jvecs = np.asarray(jprobe.pool_hidden(jh))
    hidden = transformer.forward_train(
        _model(tc), {"tokens": t(toks), "frames": t(frames)}, tc,
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


def test_decay_rule_is_jax_s_on_every_leaf():
    """``adamw.decays`` of every parameter is JAX's ``ndim >= 2`` on JAX's
    leaf: the position tables and both stacks' 1-D leaves (``ln1``,
    ``ln_cross``, ``ln2``) decay; ``ln_f`` and ``enc_ln_f`` do not."""
    tree, model = _jax_params(), _model()
    paths = set()
    for name, p in model.named_parameters():
        assert adamw.decays(name, p) == (_jax_leaf(tree, name).ndim >= 2), name
        paths.add(_jax_path(name))
    assert paths == {tuple(e.key for e in path) for path, _ in
                     jax.tree_util.tree_leaves_with_path(tree)}
    assert not adamw.decays("ln_f", model.ln_f)
    assert not adamw.decays("enc_ln_f", model.enc_ln_f)
    assert adamw.decays("pos_embed", model.pos_embed)
    assert adamw.decays("enc_pos_embed", model.enc_pos_embed)
    assert adamw.decays("dec_blocks.1.ln_cross",
                        model.dec_blocks[1].ln_cross)
    assert adamw.decays("enc_blocks.0.ln1", model.enc_blocks[0].ln1)


# ---------------------------------------------------------------------------
# weights, caches, checkpoints


def test_weights_and_caches_round_trip():
    """The weights come back as JAX's tree leaf by leaf (``enc_blocks``,
    ``dec_blocks`` with ``ln_cross`` and ``cross``, the position tables,
    ``enc_ln_f``); a bf16 model's cache, ``cross_k`` and ``cross_v``
    included, through numpy unchanged."""
    params, model = _jax_params(), _model()
    tree = convert.lm_params_to_numpy(model)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree.leaves(tree))
    for path, leaf in flat:
        node = tree
        for entry in path:
            node = node[entry.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert tree["dec_blocks"]["cross"]["wq"].shape == (2, D, D)
    cfg = torch_cfg(dtype=torch.bfloat16)
    _, cache = transformer.prefill(
        model, {"tokens": t(_tokens()), "frames": t(_frames())}, cfg,
        cache_len=40)
    assert cache["dec_blocks"]["cross_k"].dtype == torch.bfloat16
    back = convert.lm_cache_from_numpy(convert.lm_cache_to_numpy(cache),
                                       torch.bfloat16, "cpu")
    assert sorted(back["dec_blocks"]) == ["cross_k", "cross_v", "k", "v"]
    for leaf, x in back["dec_blocks"].items():
        assert x.dtype == torch.bfloat16, leaf
        assert torch.equal(x, cache["dec_blocks"][leaf]), leaf


def test_bf16_checkpoint_byte_for_byte_with_jax(tmp_path):
    """bf16 weights (norm scales f32): the port's file of a model holding
    JAX's weights is JAX's ``save`` of them, byte for byte; each package
    restores the other's, bitwise."""
    jc = jax_cfg(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    tc = torch_cfg(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    jp = jtr.init_params(jax.random.PRNGKey(2), jc)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                         "cpu")
    tree = convert.lm_params_tree(model)
    assert tree["enc_pos_embed"].dtype == torch.bfloat16
    assert tree["dec_blocks"]["ln_cross"].dtype == torch.float32
    ours, theirs = str(tmp_path / "port.msgpack"), str(tmp_path / "jax.msgpack")
    checkpoint.save(ours, tree)
    jckpt.save(theirs, jp)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    back = jckpt.restore(ours, jp)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32))
    mine = checkpoint.restore(theirs, tree)
    for x, y in zip(jax.tree.leaves(mine), jax.tree.leaves(tree)):
        assert x.dtype == y.dtype and torch.equal(x, y)


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


def test_launchers_refuse_runs_past_the_learned_positions():
    """A run past the 1,024 learned positions of the smoke config raises
    before any work (JAX's gather would clamp the index)."""
    cfg = torch_cfg()
    model = transformer.Transformer(cfg, "meta")
    prompts = torch.zeros((1, 1000), dtype=torch.int64)
    with pytest.raises(ValueError, match="learned positions"):
        serve_cli.run(model, cfg, prompts, max_new=25, cache_len=1025)
    with pytest.raises(ValueError, match="learned positions"):
        train_cli.run(cfg, steps=1, batch=1, seq=1025, device="cpu")
