"""The port's recurrent LM families against the JAX package on the CPU, at
the smoke configs of mamba2-1.3b (SSM: 2 SSD layers, d_model 128, chunk
16) and recurrentgemma-2b (hybrid: one (rglru, rglru, attn) repeat and two
tail rglru layers, d_model 256, MQA 2/1 at hd 128, window 64), f32:
configs, the forward, prefill and decode steps (recurrentgemma also on a
ring the prompt has wrapped), greedy generation, one train step, AdamW's
decay rule on every leaf, weights, caches and checkpoints, and both
launchers.

Weights come from the JAX package's ``init_params`` and are carried across
with ``convert.lm_params_from_numpy``; inputs are numpy draws from a seed.
Tolerance: f32 logits and cache leaves within 1e-4 relative plus 2e-5
absolute (the two frameworks sum in other orders, and the RG-LRU scans in
another order: ~1e-6 apart here); train-step metrics within 1e-5
relative, first moments within GRAD_TOL of each leaf's max. Greedy tokens
must be equal, except after a step whose top-two logit gap is within
that tolerance.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtr
from repro.serving import serve_step as jserve
from repro.training import adamw as jadamw
from repro.training import checkpoint as jckpt
from repro.training import train_step as jtrain
from repro_torch import configs, convert
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer
from repro_torch.serving import serve_step
from repro_torch.training import adamw, checkpoint, train_step
from torch_parity import full_width_gradients_match_jax, t

ARCHS = ["mamba2-1.3b", "recurrentgemma-2b"]
B, S = 2, 32
RTOL, ATOL = 1e-4, 2e-5
GRAD_TOL = 1e-4


def jax_cfg(arch, **kw):
    return dataclasses.replace(jconfigs.get_smoke(arch),
                               **{"remat": False, **kw})


def torch_cfg(arch, **kw):
    return dataclasses.replace(configs.get_smoke(arch), **kw)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jtr.init_params(jax.random.PRNGKey(1), jax_cfg(arch))


def _model(arch, cfg=None, trainable=False):
    tree = jax.tree.map(np.asarray, _jax_params(arch))
    model = convert.lm_params_from_numpy(tree, cfg or torch_cfg(arch), "cpu")
    return model.requires_grad_(trainable)


def _tokens(s=S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, s)).astype(
        np.int32)


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
    """The JAX tree's path of the leaf behind a port parameter name (a
    stack's leaf, whole, with its layer axis)."""
    where = transformer.layer_of(name)
    return tuple(name.split(".")) if where is None else (where[0], *where[2])


def _jax_leaf(tree, name):
    for part in _jax_path(name):
        tree = tree[part]
    return tree


# ---------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    for get in ("get", "get_smoke", "get_optimized"):
        ours = dataclasses.asdict(getattr(configs, get)(arch))
        theirs = dataclasses.asdict(getattr(jconfigs, get)(arch))
        for key in ("dtype", "param_dtype"):
            ours.pop(key), theirs.pop(key)
        assert ours == theirs, get
    for shape in configs.SHAPES:
        ours = configs.for_shape(configs.get(arch), shape)
        theirs = jconfigs.for_shape(jconfigs.get(arch), shape)
        assert ours.window == theirs.window
        assert (configs.cache_len_for(ours, shape)
                == jconfigs.cache_len_for(theirs, shape))
    assert configs.cache_len_for(configs.get("recurrentgemma-2b"),
                                 "long_500k") == 2048


def test_layer_plans_match_jax():
    """Stacks and tails by name, kind and count; the hybrid grouped by kind
    in JAX's order, not interleaved."""
    for arch in ARCHS:
        for get in (configs.get, configs.get_smoke):
            cfg = get(arch)
            jc = getattr(jconfigs, get.__name__)(arch)
            assert transformer._layer_plan(cfg) == jtr._layer_plan(jc)
    stacks, tail = transformer._layer_plan(configs.get("recurrentgemma-2b"))
    assert [s[:3] for s in stacks] == [("pat0_rglru", "rglru", 8),
                                       ("pat1_rglru", "rglru", 8),
                                       ("pat2_attn", "attn", 8)]
    assert [s[:3] for s in tail] == [("tail0_rglru", "rglru", 1),
                                     ("tail1_rglru", "rglru", 1)]


# ---------------------------------------------------------------------------
# forward, prefill, decode, generate


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(arch):
    toks = _tokens()
    want, waux = jax.jit(functools.partial(jtr.forward_train,
                                           cfg=jax_cfg(arch)))(
        _jax_params(arch), {"tokens": jnp.asarray(toks)})
    got, aux = transformer.forward_train(_model(arch), {"tokens": t(toks)},
                                         torch_cfg(arch))
    close(got, want)
    assert float(aux) == float(waux) == 0.0


PREFILL_CASES = {
    "mamba2": ("mamba2-1.3b", 32, 40),          # two whole chunks
    "mamba2 padded": ("mamba2-1.3b", 21, 40),   # front-padded to 32
    "recurrentgemma linear": ("recurrentgemma-2b", 32, 40),
    # an 80-token prompt on a 64-slot ring (the window), wrapped
    "recurrentgemma ring": ("recurrentgemma-2b", 80, 64),
}


@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_prefill_and_decode_steps_match_jax(case):
    """Prefill: the last logits and every cache leaf; then 3 decode steps
    from JAX's cache carried across (``lm_cache_from_numpy``, per-leaf
    dtypes), logits and caches after each."""
    arch, s, cache_len = PREFILL_CASES[case]
    jc, tc = jax_cfg(arch), torch_cfg(arch)
    params, model = _jax_params(arch), _model(arch)
    toks = _tokens(s)
    want, jcache = jax.jit(functools.partial(jtr.prefill, cfg=jc,
                                             cache_len=cache_len))(
        params, {"tokens": jnp.asarray(toks)})
    got, cache = transformer.prefill(model, {"tokens": t(toks)}, tc,
                                     cache_len=cache_len)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_forward(arch):
    """The port against itself: prefill of S - 1 tokens and one decode step
    give the forward's last logits."""
    cfg, model, toks = torch_cfg(arch), _model(arch), t(_tokens())
    want = transformer.forward(model, {"tokens": toks}, cfg)[:, -1]
    _, cache = transformer.prefill(model, {"tokens": toks[:, :S - 1]}, cfg,
                                   cache_len=S)
    got, _ = transformer.decode_step(
        model, toks[:, S - 1:], torch.full((B,), S - 1, dtype=torch.int32),
        cache, cfg)
    close(got, want.detach())


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax_greedy(arch):
    toks, new = _tokens(), 10
    want = jserve.generate(_jax_params(arch), jax_cfg(arch),
                           jnp.asarray(toks), new, S + new,
                           jax.random.PRNGKey(0))
    got, logits = serve_step.generate(_model(arch), torch_cfg(arch), t(toks),
                                      new, S + new, return_logits=True)
    assert got.shape == (B, new)
    want = np.asarray(want)
    for row in range(B):
        differ = np.flatnonzero(got[row].numpy() != want[row])
        if differ.size:
            top2 = np.sort(logits[row, differ[0]].numpy())[-2:]
            assert top2[1] - top2[0] <= 2 * (RTOL + ATOL), (row, differ[0])


# ---------------------------------------------------------------------------
# training


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One ``make_train_step`` step from JAX's weights (remat on in both):
    loss, ce, grad_norm and lr within 1e-5 relative, and the new first
    moments (the clipped gradients times 1 - b1) within GRAD_TOL of each
    leaf's max."""
    jc, tc = jax_cfg(arch, remat=True), torch_cfg(arch)
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    jparams = _jax_params(arch)
    toks = _tokens()
    batch = {"tokens": toks, "labels": toks}
    jstate = jtrain.TrainState(jparams, jadamw.adamw_init(jparams),
                               jnp.int32(0))
    jnew, jm = jax.jit(jtrain.make_train_step(jc, opt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    model = _model(arch, trainable=True)
    state = train_step.TrainState(
        model, adamw.adamw_init(dict(model.named_parameters())),
        torch.zeros((), dtype=torch.int32))
    step = train_step.make_train_step(
        tc, adamw.AdamWConfig(**dataclasses.asdict(opt)))
    new, m = step(state, {k: t(v) for k, v in batch.items()})
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert _rel(m[k].numpy(), jm[k]) <= 1e-5, k
    want = jax.tree.map(np.asarray, jnew.opt.mu)
    for name, mu in new.opt.mu.items():
        w = convert._leaf(want, name)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(mu.numpy() - w).max()) <= GRAD_TOL * scale, name


def test_full_width_ssd_gradients_match_jax():
    """Two SSD layers at mamba2-1.3b's width (d 2,048, 64 heads of 64,
    state 128, chunk 256; vocab cut to 4,096), f32, S 256: the loss and
    every leaf's gradient within GRAD_TOL of JAX's. At the reference's
    init JAX's gradient is NaN at this width (even at chunk 16), so the
    decays are slowed (``a_log`` -4, ``dt_bias`` -6) until JAX's is
    finite."""
    kw = dict(num_layers=2, vocab_size=4096, remat=False)
    jc = dataclasses.replace(jconfigs.get("mamba2-1.3b"), dtype=jnp.float32,
                             param_dtype=jnp.float32, **kw)
    tc = dataclasses.replace(configs.get("mamba2-1.3b"), dtype=torch.float32,
                             param_dtype=torch.float32, **kw)
    params = jtr.init_params(jax.random.PRNGKey(0), jc)
    ssm_p = params["blocks"]["ssm"]
    ssm_p["a_log"] = jnp.full_like(ssm_p["a_log"], -4.0)
    ssm_p["dt_bias"] = jnp.full_like(ssm_p["dt_bias"], -6.0)
    toks = np.random.default_rng(0).integers(0, 4096, (1, 256)).astype(
        np.int32)
    batch = {"tokens": toks, "labels": toks}
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4,
                             grad_clip=0.0)
    jstate = jtrain.TrainState(params, jadamw.adamw_init(params),
                               jnp.int32(0))
    jnew, jm = jax.jit(jtrain.make_train_step(jc, opt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         tc, "cpu").requires_grad_(True)
    state = train_step.TrainState(
        model, adamw.adamw_init(dict(model.named_parameters())),
        torch.zeros((), dtype=torch.int32))
    new, m = train_step.make_train_step(
        tc, adamw.AdamWConfig(**dataclasses.asdict(opt)))(
            state, {k: t(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        assert _rel(m[k].numpy(), jm[k]) <= 1e-5, k
    want = jax.tree.map(np.asarray, jnew.opt.mu)
    for name, mu in new.opt.mu.items():
        w = convert._leaf(want, name)
        assert np.isfinite(w).all(), name
        scale = float(np.abs(w).max())
        assert float(np.abs(mu.numpy() - w).max()) <= GRAD_TOL * scale, name


def test_full_width_rglru_and_local_attention_gradients_match_jax():
    """One RG-LRU block and one local-attention block at recurrentgemma-2b's
    width (d 2,560, lru width 2,560, d_ff 7,680, MQA 10/1 at hd 256,
    window 2,048; vocab cut to 4,096), f32, B 1 x S 1,024: the loss and
    every leaf's gradient within GRAD_TOL of JAX's ``value_and_grad`` of
    the same loss."""
    kw = dict(num_layers=2, block_pattern=("rglru", "attn"), pattern_tail=(),
              vocab_size=4096, remat=False)
    jc = dataclasses.replace(jconfigs.get("recurrentgemma-2b"),
                             dtype=jnp.float32, param_dtype=jnp.float32, **kw)
    tc = dataclasses.replace(configs.get("recurrentgemma-2b"),
                             dtype=torch.float32, param_dtype=torch.float32,
                             **kw)
    assert [s[:3] for s in transformer._layer_plan(tc)[0]] == [
        ("pat0_rglru", "rglru", 1), ("pat1_attn", "attn", 1)]
    full_width_gradients_match_jax(jc, tc, seq=1024, tol=GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_rule_is_jax_s_on_every_leaf(arch):
    """``adamw.decays`` of every parameter is JAX's ``ndim >= 2`` on JAX's
    leaf: the stacks' 1-D leaves (norm scales, ``a_log``, ``lam``, ``b_a``)
    decay; ``ln_f`` and the tails' 1-D leaves do not."""
    tree, model = _jax_params(arch), _model(arch)
    paths = set()
    for name, p in model.named_parameters():
        assert adamw.decays(name, p) == (_jax_leaf(tree, name).ndim >= 2), name
        paths.add(_jax_path(name))
    assert paths == {tuple(e.key for e in path) for path, _ in
                     jax.tree_util.tree_leaves_with_path(tree)}
    assert not adamw.decays("ln_f", model.ln_f)
    if arch == "mamba2-1.3b":
        assert adamw.decays("blocks.0.ssm.a_log", model.blocks[0].ssm.a_log)
    else:
        assert adamw.decays("pat0_rglru.0.rec.lam",
                            model.pat0_rglru[0].rec.lam)
        assert not adamw.decays("tail0_rglru.rec.lam",
                                model.tail0_rglru.rec.lam)
        assert adamw.decays("tail0_rglru.rec.w_a", model.tail0_rglru.rec.w_a)


# ---------------------------------------------------------------------------
# weights, caches, checkpoints


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_and_caches_round_trip(arch):
    """The weights come back as JAX's tree leaf by leaf (tails without a
    layer axis); a bf16 model's cache through numpy keeps each leaf's dtype
    (the f32 states stay f32, not rounded to bf16)."""
    params, model = _jax_params(arch), _model(arch)
    tree = convert.lm_params_to_numpy(model)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree.leaves(tree))
    for path, leaf in flat:
        node = tree
        for entry in path:
            node = node[entry.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    cfg = torch_cfg(arch, dtype=torch.bfloat16)
    _, cache = transformer.prefill(model, {"tokens": t(_tokens())}, cfg,
                                   cache_len=40)
    back = convert.lm_cache_from_numpy(convert.lm_cache_to_numpy(cache),
                                       torch.bfloat16, "cpu")
    state = "state" if arch == "mamba2-1.3b" else "h"
    for name, entry in back.items():
        for leaf, x in entry.items():
            assert x.dtype == cache[name][leaf].dtype, (name, leaf)
            assert torch.equal(x, cache[name][leaf]), (name, leaf)
    name = "blocks" if arch == "mamba2-1.3b" else "tail0_rglru"
    assert back[name][state].dtype == torch.float32
    assert back[name]["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_checkpoint_byte_for_byte_with_jax(arch, tmp_path):
    """bf16 weights (their f32 leaves f32): the port's file of a model
    holding JAX's weights is JAX's ``save`` of them, byte for byte; each
    package restores the other's, bitwise."""
    jc = jax_cfg(arch, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    tc = torch_cfg(arch, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    jp = jtr.init_params(jax.random.PRNGKey(2), jc)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                         "cpu")
    tree = convert.lm_params_tree(model)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_on_the_cpu(arch, capsys):
    serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                    "2", "--prompt-len", "20", "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out and "generated (2, 4)" in out


def test_launchers_apply_jax_s_chunk_rules(monkeypatch):
    """serve: ``min(ssm_chunk, 16)`` when the chunk does not divide the
    prompt; train: ``min(ssm_chunk, seq)`` when it does not divide seq."""
    full = configs.get("mamba2-1.3b")
    assert serve_cli.config_for(full, 128).ssm_chunk == 16
    assert serve_cli.config_for(full, 8704).ssm_chunk == 256
    rg = configs.get("recurrentgemma-2b")
    assert serve_cli.config_for(rg, 100) is rg
    seen = []

    def spy(cfg, *args, **kwargs):
        seen.append(cfg.ssm_chunk)
        return train_step.make_train_step(cfg, *args, **kwargs)

    monkeypatch.setattr(train_cli, "make_train_step", spy)
    train_cli.run(torch_cfg("mamba2-1.3b", ssm_chunk=64), steps=1, batch=1,
                  seq=24, device="cpu", log_every=1)
    assert seen == [24]


@pytest.mark.parametrize("arch,with_probe", [("mamba2-1.3b", True),
                                             ("recurrentgemma-2b", False)])
def test_train_launcher_runs_on_the_cpu(arch, with_probe, capsys):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "32", "--log-every", "1"]
    losses = train_cli.main(argv + (["--probe"] if with_probe else []))
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert f"arch={arch}-smoke" in out and "done: loss" in out
    assert ("probe_cascade=" in out) == with_probe
