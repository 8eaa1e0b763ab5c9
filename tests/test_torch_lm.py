"""The port's dense LM serving path against the JAX package, at
``get_smoke("llama3.2-1b")`` (f32, 2 layers, d_model 256, GQA 4/2, hd 64):
configs, modules, prefill, decode steps, generation, weight and cache
conversion, and the serve launcher on the CPU.

Weights come from the JAX package's ``init_params`` and are carried across
with ``convert.lm_params_from_numpy``; inputs are numpy draws from a seed.
Tolerance: f32 outputs within 1e-4 relative plus 2e-5 absolute (logits of
magnitude ~1; the two frameworks sum in other orders, ~1e-6 apart here).
Greedy tokens must be equal, except after a step whose top-two logit gap is
within that tolerance (a near tie may break either way).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import rope as jrope
from repro.models import transformer as jtr
from repro.serving import serve_step as jserve
from repro_torch import configs, convert
from repro_torch.draws import GeneratorDraws, ReplayDraws
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention, common, mlp, rope, transformer
from repro_torch.serving import serve_step
from tests.torch_parity import t

ARCH = "llama3.2-1b"
B, S = 2, 32
RTOL, ATOL = 1e-4, 2e-5


def close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def jax_cfg(**kw):
    return dataclasses.replace(jconfigs.get_smoke(ARCH), remat=False, **kw)


def torch_cfg(**kw):
    return dataclasses.replace(configs.get_smoke(ARCH), **kw)


@pytest.fixture(scope="module")
def weights():
    """JAX smoke weights, and the port's model holding the same numbers."""
    params = jtr.init_params(jax.random.PRNGKey(1), jax_cfg())
    tree = jax.tree.map(np.asarray, params)
    return params, convert.lm_params_from_numpy(tree, torch_cfg(), "cpu")


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 512, (B, S))


def _jax_prefill(params, toks, cfg, cache_len):
    fn = jax.jit(functools.partial(jtr.prefill, cfg=cfg, cache_len=cache_len))
    return fn(params, {"tokens": jnp.asarray(toks)})


def _first_divergence_is_a_near_tie(got, want, logits, tol):
    """Per row: tokens equal up to the first step where they differ, and
    there ``logits`` (the run whose tokens are ``got``) has its top two
    within ``tol``."""
    got, want = np.asarray(got), np.asarray(want)
    for row in range(got.shape[0]):
        differ = np.flatnonzero(got[row] != want[row])
        if differ.size:
            top2 = np.sort(np.asarray(logits[row, differ[0]]))[-2:]
            assert top2[1] - top2[0] <= tol, (row, differ[0], top2)


# ---------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("arch", ["llama3.2-1b", "smollm-360m", "yi-9b",
                                  "deepseek-coder-33b"])
def test_dense_configs_match_jax(arch):
    for get in ("get", "get_smoke"):
        ours = dataclasses.asdict(getattr(configs, get)(arch))
        theirs = dataclasses.asdict(getattr(jconfigs, get)(arch))
        for key in ("dtype", "param_dtype"):
            ours.pop(key), theirs.pop(key)
        assert ours == theirs
    assert configs.get(arch).dtype == torch.bfloat16
    assert configs.get_smoke(arch).param_dtype == torch.float32
    for shape in configs.SHAPES:
        ours = configs.for_shape(configs.get(arch), shape)
        theirs = jconfigs.for_shape(jconfigs.get(arch), shape)
        assert ours.window == theirs.window
        assert (configs.cache_len_for(ours, shape)
                == jconfigs.cache_len_for(theirs, shape))


def test_unported_families_refuse():
    """Every family is ported: the port's ``ARCHS`` is JAX's, and a
    ``vlm`` config builds the dense family's parameters (no leaf of its
    own: its vision frontend is a stub input)."""
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.get("qwen2-vl-72b").arch_type == "vlm"
    vlm = transformer.Transformer(torch_cfg(arch_type="vlm"), "cpu")
    dense = transformer.Transformer(torch_cfg(), "cpu")
    assert ([(k, tuple(v.shape)) for k, v in vlm.named_parameters()]
            == [(k, tuple(v.shape)) for k, v in dense.named_parameters()])


# ---------------------------------------------------------------------------
# modules


def test_primitives_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 256), dtype=np.float32)
    scale = 0.1 * rng.standard_normal(256, dtype=np.float32)
    close(common.rms_norm(t(x), t(scale), 1e-6),
          jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    w = rng.standard_normal((256, 96), dtype=np.float32) / 16
    close(common.dense(t(x), t(w)), jcommon.dense(jnp.asarray(x),
                                                  jnp.asarray(w)))
    h = rng.standard_normal((2, 5, 4, 64), dtype=np.float32)
    positions = np.array([[0, 1, 2, 3, 4], [70_000, 9, 300, 8191, 8192]],
                         np.int32)
    close(rope.apply_rope(t(h), t(positions), 500_000.0),
          jrope.apply_rope(jnp.asarray(h), jnp.asarray(positions), 500_000.0))


def test_init_params_is_seeded_and_truncated():
    cfg = torch_cfg()
    a = transformer.init_params(cfg, seed=3, device="cpu")
    b = transformer.init_params(cfg, seed=3, device="cpu")
    c = transformer.init_params(cfg, seed=4, device="cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.blocks[0].attn.wq, c.blocks[0].attn.wq)
    wq = a.blocks[0].attn.wq
    assert float(wq.abs().max()) <= 2.0 / cfg.d_model ** 0.5 + 1e-6
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 0.88) < 0.05
    assert float(a.blocks[1].ln2.abs().max()) == 0.0
    full = configs.get(ARCH)
    assert transformer.Transformer(dataclasses.replace(
        full, num_layers=1, vocab_size=8), "meta").embed.dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_matches_jax(kind):
    params = jmlp.init_mlp(jax.random.PRNGKey(2), 256, 512, 2, jnp.float32,
                           kind=kind)
    ours = mlp.MLP(256, 512, torch.float32, kind, "cpu")
    with torch.no_grad():
        for name, arr in params.items():
            getattr(ours, name).copy_(t(arr))
    x = np.random.default_rng(4).standard_normal((2, 3, 256), np.float32)
    close(mlp.mlp(ours, t(x)), jmlp.mlp(params, jnp.asarray(x)))


@pytest.mark.parametrize("impl,window,pad", [
    ("naive", 0, 0), ("naive", 8, 0), ("chunked", 0, 0), ("chunked", 8, 0),
    ("naive", 0, 6)])
def test_self_attention_matches_jax(weights, impl, window, pad):
    """Naive and chunked, causal and windowed, and with the head axis
    zero-padded from 4 to 6 (``pad_heads_to``)."""
    params, model = weights
    kw = dict(attention_impl=impl, attention_chunk=8, window=window,
              pad_heads_to=pad)
    x = np.random.default_rng(5).standard_normal((B, S, 256), np.float32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    want, (wk, wv) = jattn.self_attention(jp, jnp.asarray(x),
                                          jnp.asarray(positions),
                                          jax_cfg(**kw))
    got, (k, v) = attention.self_attention(model.blocks[0].attn, t(x),
                                           t(positions), torch_cfg(**kw))
    close(got, want)
    close(k, wk)
    close(v, wv)


@pytest.mark.parametrize("s_cache,window,pos", [
    (32, 0, 20),       # linear cache
    (32, 0, 40),       # linear cache, past its end (slot clamped)
    (16, 16, 50),      # ring, wrapped three times
    (16, 16, 7),       # ring, not yet full
])
def test_decode_attention_matches_jax(weights, s_cache, window, pos):
    params, model = weights
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((B, 1, 256), np.float32)
    ck = rng.standard_normal((B, s_cache, 2, 64), np.float32)
    cv = rng.standard_normal((B, s_cache, 2, 64), np.float32)
    posv = np.array([pos, pos + 3], np.int32)
    jp = jax.tree.map(lambda a: a[1], params["blocks"]["attn"])
    want, wk, wv = jattn.decode_attention(jp, jnp.asarray(x), jnp.asarray(ck),
                                          jnp.asarray(cv), jnp.asarray(posv),
                                          jax_cfg(window=window))
    tk, tv = t(ck), t(cv)
    got, k, v = attention.decode_attention(model.blocks[1].attn, t(x), tk, tv,
                                           t(posv), torch_cfg(window=window))
    assert k is tk and v is tv                   # written in place
    close(got, want)
    close(k, wk)
    close(v, wv)


# ---------------------------------------------------------------------------
# prefill, decode, generate


@pytest.mark.parametrize("cache_len,window", [(40, 0), (16, 16)])
def test_prefill_and_decode_step_match_jax(weights, tokens, cache_len, window):
    """Prefill: last logits and the cache (linear, or a wrapped ring); then
    one decode step from the JAX prefill's cache, carried across."""
    params, model = weights
    jcfg, tcfg = jax_cfg(window=window), torch_cfg(window=window)
    want, jcache = _jax_prefill(params, tokens, jcfg, cache_len)
    got, cache = transformer.prefill(model, {"tokens": t(tokens)}, tcfg,
                                     cache_len=cache_len)
    close(got, want)
    for kv in ("k", "v"):
        close(cache["blocks"][kv], jcache["blocks"][kv])
    nxt = np.random.default_rng(6).integers(0, 512, (B, 1))
    pos = np.full((B,), S, np.int32)
    cache = convert.lm_cache_from_numpy(jax.tree.map(np.asarray, jcache),
                                        torch.float32, "cpu")
    want, jcache = jtr.decode_step(params, jnp.asarray(nxt), jnp.asarray(pos),
                                   jcache, jcfg)
    got, cache = transformer.decode_step(model, t(nxt), t(pos), cache, tcfg)
    close(got, want)
    for kv in ("k", "v"):
        close(cache["blocks"][kv], jcache["blocks"][kv])


@pytest.mark.parametrize("window,cache_len", [(0, S), (16, 16)])
def test_decode_matches_own_forward(weights, tokens, window, cache_len):
    """The port against itself: prefill of S - 1 tokens and one decode step
    give the full forward's last logits (linear cache; and a window-16
    ring, smaller than the history)."""
    _, model = weights
    cfg = torch_cfg(window=window)
    want = transformer.forward(model, {"tokens": t(tokens)}, cfg)[:, -1]
    _, cache = transformer.prefill(model, {"tokens": t(tokens[:, :S - 1])},
                                   cfg, cache_len=cache_len)
    got, _ = transformer.decode_step(
        model, t(tokens[:, S - 1:]), torch.full((B,), S - 1, dtype=torch.int32),
        cache, cfg)
    close(got, want)
    if window == 0:
        close(model(t(tokens))[:, -1], want)


def test_generate_matches_jax_greedy(weights, tokens):
    params, model = weights
    cfg, new = torch_cfg(), 12
    want = jserve.generate(params, jax_cfg(), jnp.asarray(tokens), new,
                           S + new, jax.random.PRNGKey(0))
    got, logits = serve_step.generate(model, cfg, t(tokens), new, S + new,
                                      return_logits=True)
    assert got.shape == (B, new) and logits.shape == (B, new, 512)
    _first_divergence_is_a_near_tie(got, want, logits, 2 * (RTOL + ATOL))


def test_generate_matches_jax_with_temperature(weights, tokens):
    """Temperature sampling on replayed ``jax.random.gumbel`` draws: the
    JAX package's ``categorical`` keys, in its order."""
    params, model = weights
    new, temp, key = 8, 0.7, jax.random.PRNGKey(9)
    want = jserve.generate(params, jax_cfg(), jnp.asarray(tokens), new,
                           S + new, key, temperature=temp)
    gumbels = [np.asarray(jax.random.gumbel(k, (B, 512), jnp.float32))
               for k in jax.random.split(key, new - 1)]
    draws = ReplayDraws(gumbels)
    got, logits = serve_step.generate(model, torch_cfg(), t(tokens), new,
                                      S + new, draws, temp, return_logits=True)
    assert len(draws) == 0
    noisy = logits[:, 1:] / temp + torch.from_numpy(np.stack(gumbels, 1))
    np.testing.assert_array_equal(got[:, 0].numpy(), np.asarray(want)[:, 0])
    _first_divergence_is_a_near_tie(got[:, 1:], np.asarray(want)[:, 1:],
                                    noisy, 2 * (RTOL + ATOL) / temp)


def test_generator_gumbel_draws_are_seeded_gumbel():
    """The production source's Gumbel noise: seeded, finite, and with the
    standard Gumbel's mean (Euler's gamma) and variance (pi^2 / 6) within
    five standard errors at n = 20,000."""
    g = GeneratorDraws(5, device="cpu").gumbel((20_000,))
    assert torch.equal(g, GeneratorDraws(5, device="cpu").gumbel((20_000,)))
    assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
    assert abs(float(g.mean()) - 0.5772) < 5 * 1.28 / 20_000 ** 0.5
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 5 * 3.5 / 20_000 ** 0.5


def test_weights_and_caches_round_trip(weights, tokens):
    params, model = weights
    tree = convert.lm_params_to_numpy(model)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree.leaves(tree))
    for path, leaf in flat:
        node = tree
        for entry in path:
            node = node[entry.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    _, cache = transformer.prefill(model, {"tokens": t(tokens)}, torch_cfg(),
                                   cache_len=40)
    back = convert.lm_cache_from_numpy(convert.lm_cache_to_numpy(cache),
                                       torch.bfloat16, "cpu")
    assert back["blocks"]["k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        convert.lm_cache_to_numpy(back)["blocks"]["v"],
        cache["blocks"]["v"].bfloat16().float().numpy())
    bad = dict(tree, embed=tree["embed"][:, :8])
    with pytest.raises(ValueError, match="embed"):
        convert.lm_params_from_numpy(bad, torch_cfg(), "cpu")


def test_serve_launcher_runs_on_the_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                    "2", "--prompt-len", "16", "--max-new", "5"])
    out = capsys.readouterr().out
    assert "generated (2, 5)" in out and "tok/s" in out and "first row" in out
    with pytest.raises(RuntimeError, match="cuda"):
        serve_cli.main(["--arch", ARCH, "--smoke"])
