"""The port's MoE family against the JAX package, at the f32 smoke widths
of ``granite-moe-1b-a400m`` (2 layers, d_model 128, GQA 4/2, 4 experts,
top-2) and ``deepseek-moe-16b`` (3 layers, one leading dense FFN, 4
experts, top-2, one shared expert): the configs, the router (``_routing``),
the dense and ragged paths, the grouped product, ``moe`` with shared
experts, the single-process ``ep`` fallback, and the model's forward,
prefill, decode and cache for each ``moe_impl``; the serve launcher.

Weights come from the JAX package's ``init_params`` / ``init_moe`` and are
carried across with ``convert``; inputs are numpy draws from a seed.
Tolerances (ROADMAP's parity contract): f32 outputs ULP-bounded, within
1e-5 relative plus 1e-6 of the largest value (one layer) or within 1e-4
relative plus 2e-5 (logits of the whole model, as ``test_torch_lm.py``);
top-k indices equal; greedy tokens equal except after a near tie.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mlp as jmlp
from repro.models import transformer as jtr
from repro.serving import serve_step as jserve
from repro_torch import configs, convert
from repro_torch.launch import serve as serve_cli
from repro_torch.models import mlp, transformer
from repro_torch.serving import serve_step
from torch_parity import t

ARCHS = ["granite-moe-1b-a400m", "deepseek-moe-16b"]
IMPLS = ["dense", "ragged", "ep"]
B, S = 2, 16
RTOL, ATOL = 1e-4, 2e-5            # whole-model logits
LAYER_RTOL, LAYER_ATOL = 1e-5, 1e-6   # one layer, ATOL times max |want|


def jax_cfg(arch, **kw):
    return dataclasses.replace(jconfigs.get_smoke(arch), remat=False, **kw)


def torch_cfg(arch, **kw):
    return dataclasses.replace(configs.get_smoke(arch), **kw)


def close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def layer_close(got, want):
    want = np.asarray(want)
    close(got, want, LAYER_RTOL, LAYER_ATOL * float(np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jtr.init_params(jax.random.PRNGKey(1), jax_cfg(arch))


def _model(arch, **kw):
    tree = jax.tree.map(np.asarray, _jax_params(arch))
    return convert.lm_params_from_numpy(tree, torch_cfg(arch, **kw), "cpu")


def _jax_moe(arch):
    """Layer 0 of the MoE stack of the JAX smoke model."""
    return jax.tree.map(lambda a: a[0], _jax_params(arch)["blocks"]["moe"])


def _x2d(seed, t_rows=B * S, d=128):
    return np.random.default_rng(seed).standard_normal((t_rows, d),
                                                       dtype=np.float32)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 512, (B, S))


# ---------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_configs_match_jax(arch):
    for get in ("get", "get_smoke", "get_optimized"):
        ours = dataclasses.asdict(getattr(configs, get)(arch))
        theirs = dataclasses.asdict(getattr(jconfigs, get)(arch))
        for key in ("dtype", "param_dtype"):
            ours.pop(key), theirs.pop(key)
        assert ours == theirs
    for shape in configs.SHAPES:
        ours = configs.for_shape(configs.get(arch), shape)
        theirs = jconfigs.for_shape(jconfigs.get(arch), shape)
        assert ours.window == theirs.window
        assert (configs.cache_len_for(ours, shape)
                == jconfigs.cache_len_for(theirs, shape))
    assert transformer._layer_plan(configs.get(arch)) == jtr._layer_plan(
        jconfigs.get(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_moe_builds(arch):
    """The published geometry builds (on the meta device): bf16 expert
    stacks, an f32 router, the stacks of JAX's layer plan."""
    cfg = configs.get(arch)
    model = transformer.Transformer(cfg, "meta")
    moe = model.blocks[0].moe
    fe = cfg.moe_d_ff
    assert moe.wg.shape == (cfg.num_experts, cfg.d_model, fe)
    assert moe.wd.shape == (cfg.num_experts, fe, cfg.d_model)
    assert moe.wg.dtype == torch.bfloat16 and moe.router.dtype == torch.float32
    assert len(model.blocks) == cfg.num_layers - cfg.first_dense_layers
    if cfg.first_dense_layers:
        assert model.dense_blocks[0].mlp.wg.shape == (cfg.d_model,
                                                      cfg.first_dense_d_ff)
        assert moe.shared.wg.shape == (cfg.d_model,
                                       fe * cfg.num_shared_experts)


def test_moe_init_is_seeded_and_scaled():
    cfg = torch_cfg("deepseek-moe-16b")
    a = transformer.init_params(cfg, seed=3, device="cpu")
    b = transformer.init_params(cfg, seed=3, device="cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    moe = a.blocks[0].moe
    d, fe = cfg.d_model, cfg.moe_d_ff
    assert float(moe.wg.abs().max()) <= 2.0 / d ** 0.5 + 1e-6
    assert abs(float(moe.wu.std()) * d ** 0.5 - 0.88) < 0.05
    assert float(moe.wd.abs().max()) <= 2.0 / (fe * 2 * cfg.num_layers) ** 0.5
    assert abs(float(moe.router.std()) * d ** 0.5 - 0.88) < 0.1


# ---------------------------------------------------------------------------
# the layer


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_matches_jax(arch):
    """Gates, top-k indices (equal), renormalised top-k probabilities and
    the Switch loss."""
    jc, tc = jax_cfg(arch), torch_cfg(arch)
    p = _model(arch).blocks[0].moe
    x = 3 * _x2d(1)
    jg, ji, jp, jaux = jmlp._routing(_jax_moe(arch), jnp.asarray(x), jc)
    g, i, pr, aux = mlp._routing(p, t(x), tc)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    layer_close(g, jg)
    layer_close(pr, jp)
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))


def test_routing_ties_go_to_the_lower_index():
    """A zero router gives every expert the same probability: both
    packages pick experts 0..k-1, in order, with equal gates."""
    arch = "granite-moe-1b-a400m"
    jc, tc = jax_cfg(arch), torch_cfg(arch)
    p = _model(arch).blocks[0].moe
    with torch.no_grad():
        p.router.zero_()
    jparams = dict(_jax_moe(arch), router=jnp.zeros((128, 4), jnp.float32))
    x = _x2d(2)
    jg, ji, _, jaux = jmlp._routing(jparams, jnp.asarray(x), jc)
    g, i, pr, aux = mlp._routing(p, t(x), tc)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert (i.numpy() == np.arange(tc.experts_per_token)).all()
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert float(aux) == float(jaux)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_and_ragged_paths_match_jax(arch):
    jc, tc = jax_cfg(arch), torch_cfg(arch)
    p, jp = _model(arch).blocks[0].moe, _jax_moe(arch)
    x = _x2d(3)
    jg, ji, jpr, _ = jmlp._routing(jp, jnp.asarray(x), jc)
    g, i, pr, _ = mlp._routing(p, t(x), tc)
    layer_close(mlp.moe_dense_path(p, t(x), g, torch.float32),
                jmlp.moe_dense_path(jp, jnp.asarray(x), jg, jnp.float32))
    layer_close(mlp.moe_ragged_path(p, t(x), i, pr, tc, torch.float32),
                jmlp.moe_ragged_path(jp, jnp.asarray(x), ji, jpr, jc,
                                     jnp.float32))


@pytest.mark.parametrize("sizes", [(5, 0, 9, 2), (0, 0, 16, 0), (4, 4, 4, 4)])
def test_grouped_mm_matches_loop_and_ragged_dot(sizes):
    """The grouped product against its per-expert loop (bitwise: the same
    f32 products on the CPU) and JAX's ``ragged_dot``; empty groups
    included."""
    rng = np.random.default_rng(sum(sizes))
    x = rng.standard_normal((sum(sizes), 24), dtype=np.float32)
    w = rng.standard_normal((len(sizes), 24, 40), dtype=np.float32)
    offs = t(np.cumsum(sizes).astype(np.int32))
    got = mlp.grouped_mm(t(x), t(w), offs)
    assert torch.equal(got, mlp.grouped_mm_ref(t(x), t(w), offs))
    layer_close(got, jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(sizes, jnp.int32)))
    e = t(np.repeat(np.arange(len(sizes)), sizes))
    assert torch.equal(mlp.group_offsets(e, len(sizes)), offs)


def test_grouped_mm_gradients_match_the_loop():
    rng = np.random.default_rng(8)
    x = t(rng.standard_normal((12, 16), dtype=np.float32))
    w = t(rng.standard_normal((3, 16, 8), dtype=np.float32))
    offs = t(np.array([5, 5, 12], np.int32))
    grads = []
    for fn in (mlp.grouped_mm, mlp.grouped_mm_ref):
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        # a sum's gradient is an expanded (stride 0) tensor
        fn(xx, ww, offs).sum().backward()
        grads.append((xx.grad, ww.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_jax(arch, impl):
    """``moe`` on (B, S, D): the output (with deepseek's shared expert) and
    aux; ``ep`` without a mesh is JAX's single-shard fallback."""
    jc, tc = jax_cfg(arch, moe_impl=impl), torch_cfg(arch, moe_impl=impl)
    p, jp = _model(arch).blocks[0].moe, _jax_moe(arch)
    x = _x2d(4).reshape(B, S, -1)
    jy, jaux = jmlp.moe(jp, jnp.asarray(x), jc)
    y, aux = mlp.moe(p, t(x), tc)
    assert y.shape == (B, S, 128) and aux.shape == ()
    layer_close(y, jy)
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))


@pytest.mark.parametrize("arch", ARCHS)
def test_single_process_ep_is_the_dense_path(arch):
    p = _model(arch).blocks[0].moe
    x = t(_x2d(5).reshape(B, S, -1))
    ep, aux_ep = mlp.moe(p, x, torch_cfg(arch, moe_impl="ep"))
    dense, aux = mlp.moe(p, x, torch_cfg(arch, moe_impl="dense"))
    assert torch.equal(ep, dense) and torch.equal(aux_ep, aux)


def test_moe_ep_path_on_one_process_matches_jax_and_drops():
    """``moe_ep_path`` with every expert on one process (``mesh=None``)
    against JAX's body on one shard, at a capacity that drops assignments
    and one that does not."""
    arch = "granite-moe-1b-a400m"
    jc, tc = jax_cfg(arch), torch_cfg(arch)
    p, jp = _model(arch).blocks[0].moe, _jax_moe(arch)
    x = _x2d(6)
    _, ji, jpr, _ = jmlp._routing(jp, jnp.asarray(x), jc)
    w = {n: getattr(p, n) for n in ("wg", "wu", "wd")}
    counts = np.bincount(np.asarray(ji).ravel(), minlength=4)
    for f, drops in ((2.0, False), (0.5, True)):
        cap = max(8, int(f * B * S * 2 / 4))
        assert bool((counts > cap).any()) == drops
        want = jax.vmap(lambda wg, wu, wd: jmlp.moe_ep_path(
            {"wg": wg, "wu": wu, "wd": wd}, jnp.asarray(x), ji, jpr, jc,
            jnp.float32, capacity_factor=f), axis_name="model")(
            *(jp[n][None] for n in ("wg", "wu", "wd")))[0]
        got = mlp.moe_ep_path(w, t(x), t(np.asarray(ji)).long(),
                              t(np.asarray(jpr)), tc, torch.float32,
                              capacity_factor=f)
        layer_close(got, want)


def test_moe_impl_is_validated():
    p = _model("granite-moe-1b-a400m").blocks[0].moe
    with pytest.raises(ValueError, match="moe_impl"):
        mlp.moe(p, torch.zeros(1, 2, 128),
                torch_cfg("granite-moe-1b-a400m", moe_impl="sparse"))


# ---------------------------------------------------------------------------
# the model


def _jax_prefill(params, toks, cfg, cache_len):
    fn = jax.jit(functools.partial(jtr.prefill, cfg=cfg, cache_len=cache_len))
    return fn(params, {"tokens": jnp.asarray(toks)})


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(arch, impl, tokens):
    jc, tc = jax_cfg(arch, moe_impl=impl), torch_cfg(arch, moe_impl=impl)
    jl, jaux = jtr.forward_train(_jax_params(arch),
                                 {"tokens": jnp.asarray(tokens)}, jc)
    logits, aux = transformer.forward_train(_model(arch),
                                            {"tokens": t(tokens)}, tc)
    assert logits.shape == (B, S, 512)
    close(logits, jl)
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))
    assert float(aux) > 0


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step_match_jax(arch, impl, tokens):
    """Prefill's last logits and its cache (one entry a stack of the layer
    plan), then one decode step from JAX's cache carried across."""
    jc, tc = jax_cfg(arch, moe_impl=impl), torch_cfg(arch, moe_impl=impl)
    params, model = _jax_params(arch), _model(arch)
    want, jcache = _jax_prefill(params, tokens, jc, 24)
    got, cache = transformer.prefill(model, {"tokens": t(tokens)}, tc,
                                     cache_len=24)
    close(got, want)
    assert sorted(cache) == sorted(jcache)
    for name in cache:
        for kv in ("k", "v"):
            assert cache[name][kv].shape == jcache[name][kv].shape
            close(cache[name][kv], jcache[name][kv])
    nxt = np.random.default_rng(6).integers(0, 512, (B, 1))
    pos = np.full((B,), S, np.int32)
    cache = convert.lm_cache_from_numpy(jax.tree.map(np.asarray, jcache),
                                        torch.float32, "cpu")
    want, jcache = jtr.decode_step(params, jnp.asarray(nxt), jnp.asarray(pos),
                                   jcache, jc)
    got, cache = transformer.decode_step(model, t(nxt), t(pos), cache, tc)
    close(got, want)
    for name in cache:
        close(cache[name]["k"], jcache[name]["k"])


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax_greedy(arch, tokens):
    new = 8
    want = jserve.generate(_jax_params(arch), jax_cfg(arch),
                           jnp.asarray(tokens), new, S + new,
                           jax.random.PRNGKey(0))
    got, logits = serve_step.generate(_model(arch), torch_cfg(arch),
                                      t(tokens), new, S + new,
                                      return_logits=True)
    got, want = got.numpy(), np.asarray(want)
    for row in range(B):
        differ = np.flatnonzero(got[row] != want[row])
        if differ.size:
            top2 = np.sort(logits[row, differ[0]].numpy())[-2:]
            assert top2[1] - top2[0] <= 2 * (RTOL + ATOL), (row, top2)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_weights_round_trip(arch):
    """``lm_params_to_numpy`` gives JAX's ``init_params`` tree back, leaf
    for leaf: ``dense_blocks``, the expert stacks, the f32 router and the
    shared experts included."""
    params = _jax_params(arch)
    tree = convert.lm_params_to_numpy(_model(arch))
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree.leaves(tree))
    for path, leaf in flat:
        node = tree
        for entry in path:
            node = node[entry.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert tree["blocks"]["moe"]["router"].dtype == np.float32


def test_unported_families_still_refuse():
    """No family is refused any more: the port's ``_layer_plan`` is JAX's
    for every architecture, full and smoke configs."""
    for arch in jconfigs.ALIASES:
        for get in ("get", "get_smoke"):
            assert (transformer._layer_plan(getattr(configs, get)(arch))
                    == jtr._layer_plan(getattr(jconfigs, get)(arch))), (
                        arch, get)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_moe_on_the_cpu(arch, capsys):
    serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                    "2", "--prompt-len", "12", "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out and "generated (2, 4)" in out
