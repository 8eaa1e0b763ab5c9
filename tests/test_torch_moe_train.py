"""Training the port's MoE family against the JAX package, and its expert
parallelism on ranks, at the f32 smoke widths of ``granite-moe-1b-a400m``
and ``deepseek-moe-16b`` (B = 2, S = 16): the step's loss and its
gradients leaf by leaf (the router included), AdamW on JAX's gradients
(the leading dense block's norm scales decay, as in JAX's stacked tree), a
whole train step, the bf16 MoE checkpoint byte for byte, the train
launcher, and ``moe_ep_path`` / ``moe(..., mesh=)`` on 2 gloo ranks against
JAX's ``moe_ep_path`` under ``jax.vmap(axis_name="model")``.

Weights come from the JAX package's ``init_params`` and are carried across
with ``convert``; inputs are numpy draws from a seed. Tolerances: the loss,
ce and moe_aux within 1e-5 relative; each gradient leaf within 1e-4 of
that leaf's max |g| (as ``test_torch_training.py``); AdamW on JAX's own
gradients within 4 f32 ulp of each leaf's max; the ep outputs within 1e-5
relative plus 1e-6 of the largest value (one layer in f32, the two ranks'
sums added in another order).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import transformer as jtr
from repro.training import adamw as jadamw
from repro.training import checkpoint as jckpt
from repro.training import train_step as jtrain
from repro_torch import configs, convert
from repro_torch.launch import train as train_cli
from repro_torch.training import adamw, checkpoint, train_step
from torch_parity import (F32_EPS, full_width_gradients_match_jax,
                          run_ranks, t)
import torch_ranks

ARCHS = ["granite-moe-1b-a400m", "deepseek-moe-16b"]
B, S = 2, 16
CE_RTOL = 1e-5
GRAD_TOL = 1e-4
RANK_TIMEOUT = 240


def jax_cfg(arch, **kw):
    return dataclasses.replace(jconfigs.get_smoke(arch), **kw)


def torch_cfg(arch, **kw):
    return dataclasses.replace(configs.get_smoke(arch), **kw)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jtr.init_params(jax.random.PRNGKey(1), jax_cfg(arch))


def _model(arch, cfg, trainable=True):
    tree = jax.tree.map(np.asarray, _jax_params(arch))
    return convert.lm_params_from_numpy(tree, cfg, "cpu").requires_grad_(
        trainable)


@pytest.fixture(scope="module")
def batch():
    toks = np.random.default_rng(0).integers(0, 512, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": toks}


def _tbatch(batch):
    return {k: t(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _jax_loss(params, batch, cfg):
    """JAX's ``make_train_step`` loss with its parts, as its ``loss_fn``
    computes them."""
    labels = batch["labels"]
    if cfg.chunked_ce:
        hidden, aux = jtr.forward_hidden(params, batch, cfg)
        ce = jtr.chunked_ce_loss(params, hidden, labels, cfg)
    else:
        logits, aux = jtr.forward_train(params, batch, cfg)
        ce = jcommon.softmax_cross_entropy(logits[:, :-1], labels[:, 1:])
    return ce + cfg.router_aux_coef * aux, (ce, aux)


# ---------------------------------------------------------------------------
# the loss and its gradients

GRAD_CASES = {
    "granite dense": ("granite-moe-1b-a400m", dict(remat=True)),
    "granite ragged": ("granite-moe-1b-a400m",
                       dict(remat=True, moe_impl="ragged")),
    "granite optimized": ("granite-moe-1b-a400m",
                          dict(remat=True, moe_impl="ep",
                               attention_impl="chunked", attention_chunk=8,
                               chunked_ce=True, ce_chunk=6)),
    "deepseek dense": ("deepseek-moe-16b", dict(remat=False)),
    "deepseek ragged": ("deepseek-moe-16b",
                        dict(remat=True, moe_impl="ragged")),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_moe_loss_and_gradients_match_jax(batch, case):
    """``lm_loss`` (ce + router_aux_coef * aux) and its gradient, leaf by
    leaf, against ``jax.value_and_grad`` of JAX's loss under the same
    config; the router's gradient is not zero."""
    arch, kw = GRAD_CASES[case]
    jc, tc = jax_cfg(arch, **kw), torch_cfg(arch, **kw)
    (jloss, (jce, jaux)), jgrads = jax.value_and_grad(
        _jax_loss, has_aux=True)(_jax_params(arch), _jbatch(batch), jc)
    model = _model(arch, tc)
    params = dict(model.named_parameters())
    loss, ce, aux, _ = train_step.lm_loss(model, _tbatch(batch), tc)
    grads = torch.autograd.grad(loss, list(params.values()))
    for got, want in ((loss, jloss), (ce, jce), (aux, jaux)):
        assert _rel(got.detach().numpy(), want) <= CE_RTOL
    assert float(aux.detach()) > 0
    jtree = jax.tree.map(np.asarray, jgrads)
    for name, g in zip(params, grads):
        want = convert._leaf(jtree, name)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)
    router = grads[list(params).index("blocks.0.moe.router")]
    assert float(router.abs().max()) > 0


@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_full_width_moe_block_gradients_match_jax(impl):
    """One granite-moe-1b-a400m block at full width (d 1,024, GQA 16/8, 32
    experts of d_ff 512, top 8; vocab cut to 4,096), f32, B 2 x S 256, on
    each ``moe_impl``: the loss (with the router's aux) and every leaf's
    gradient, the router's and the expert stacks' included, within
    GRAD_TOL of JAX's ``value_and_grad``."""
    kw = dict(num_layers=1, vocab_size=4096, remat=False, moe_impl=impl)
    jc = dataclasses.replace(jconfigs.get("granite-moe-1b-a400m"),
                             dtype=jnp.float32, param_dtype=jnp.float32, **kw)
    tc = dataclasses.replace(configs.get("granite-moe-1b-a400m"),
                             dtype=torch.float32, param_dtype=torch.float32,
                             **kw)
    full_width_gradients_match_jax(jc, tc, seq=256, batch=2, tol=GRAD_TOL)


# ---------------------------------------------------------------------------
# AdamW and a whole step


def _named(tree, model):
    return {name: t(convert._leaf(tree, name)).clone()
            for name, _ in model.named_parameters()}


def test_adamw_on_jax_grads_decays_the_dense_blocks(batch):
    """deepseek-moe's AdamW step fed JAX's own gradients, from JAX's params
    and a re-injected moment state: new params, mu and nu within 4 f32 ulp
    of each leaf's max. JAX stacks ``dense_blocks`` too, so its rule
    (``ndim >= 2``) decays the leading dense block's norm scales."""
    arch = "deepseek-moe-16b"
    jc = jax_cfg(arch)
    jparams = _jax_params(arch)
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=50)
    jgrads = jax.grad(lambda p: _jax_loss(p, _jbatch(batch), jc)[0])(jparams)
    jgrads = jax.tree.map(lambda g: 50.0 * g, jgrads)
    rng = np.random.default_rng(3)
    mu = jax.tree.map(lambda p: jnp.asarray(
        0.01 * rng.standard_normal(p.shape).astype(np.float32)), jparams)
    nu = jax.tree.map(lambda p: jnp.asarray(
        1e-4 * rng.random(p.shape).astype(np.float32)), jparams)
    jstate = jadamw.AdamWState(mu, nu, jnp.int32(7))
    jp, js, jm = jadamw.adamw_update(jparams, jgrads, jstate, opt)

    model = _model(arch, torch_cfg(arch), trainable=False)
    tree = lambda x: jax.tree.map(np.asarray, x)  # noqa: E731
    state = adamw.AdamWState(_named(tree(mu), model), _named(tree(nu), model),
                             torch.tensor(7, dtype=torch.int32))
    tp, ts, tm = adamw.adamw_update(_named(tree(jparams), model),
                                    _named(tree(jgrads), model), state,
                                    adamw.AdamWConfig(**dataclasses.asdict(
                                        opt)))
    assert _rel(tm["grad_norm"].numpy(), jm["grad_norm"]) <= 1e-6
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        want = tree(want)
        for name, x in got.items():
            w = convert._leaf(want, name)
            bound = 4 * F32_EPS * max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(x.numpy() - w).max()) <= bound, name
    assert adamw.decays("dense_blocks.0.ln1", model.dense_blocks[0].ln1)
    assert adamw.decays("blocks.1.moe.router", model.blocks[1].moe.router)
    assert not adamw.decays("ln_f", model.ln_f)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, batch):
    """One ``make_train_step`` step from JAX's weights: loss, ce, moe_aux,
    grad_norm and lr within 1e-5 relative, and the new first moments (the
    clipped gradients times 1 - b1; the router and the expert stacks
    included) within GRAD_TOL of each leaf's max. (The first step's
    weights are not compared: Adam moves each weight by about lr times the
    sign of its gradient, which flips with the rounding of a gradient near
    zero.)"""
    jc, tc = jax_cfg(arch), torch_cfg(arch)
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    jparams = _jax_params(arch)
    jstate = jtrain.TrainState(jparams, jadamw.adamw_init(jparams),
                               jnp.int32(0))
    jnew, jm = jax.jit(jtrain.make_train_step(jc, opt))(
        jstate, _jbatch(batch), None)
    model = _model(arch, tc)
    state = train_step.TrainState(
        model, adamw.adamw_init(dict(model.named_parameters())),
        torch.zeros((), dtype=torch.int32))
    step = train_step.make_train_step(
        tc, adamw.AdamWConfig(**dataclasses.asdict(opt)))
    new, m = step(state, _tbatch(batch))
    for k in ("loss", "ce", "moe_aux", "grad_norm", "lr"):
        assert _rel(m[k].numpy(), jm[k]) <= 1e-5, k
    assert int(new.step) == 1
    want = jax.tree.map(np.asarray, jnew.opt.mu)
    for name, mu in new.opt.mu.items():
        w = convert._leaf(want, name)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(mu.numpy() - w).max()) <= GRAD_TOL * scale, name


def test_bf16_moe_checkpoint_byte_for_byte_with_jax(tmp_path):
    """deepseek-moe's tree in bf16 (the router and norm scales f32): the
    port's file of a model holding JAX's weights is JAX's ``save`` of
    them, byte for byte; each package restores the other's, bitwise."""
    arch = "deepseek-moe-16b"
    jc = jax_cfg(arch, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    tc = torch_cfg(arch, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    jp = jtr.init_params(jax.random.PRNGKey(2), jc)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                         "cpu")
    tree = convert.lm_params_tree(model)
    assert tree["blocks"]["moe"]["wg"].dtype == torch.bfloat16
    assert tree["blocks"]["moe"]["router"].dtype == torch.float32
    assert tree["dense_blocks"]["mlp"]["wg"].shape[0] == 1
    ours = str(tmp_path / "port.msgpack")
    theirs = str(tmp_path / "jax.msgpack")
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
# the launcher


@pytest.mark.parametrize("arch,with_probe", [("granite-moe-1b-a400m", True),
                                             ("deepseek-moe-16b", False)])
def test_train_launcher_runs_moe_on_the_cpu(arch, with_probe, capsys):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "4",
            "--batch", "2", "--seq", "16", "--log-every", "2"]
    losses = train_cli.main(argv + (["--probe"] if with_probe else []))
    out = capsys.readouterr().out
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert f"arch={arch}-smoke" in out and "done: loss" in out
    assert ("probe_cascade=" in out) == with_probe


# ---------------------------------------------------------------------------
# expert parallelism on 2 ranks


def _jax_ep_body(jp, x, ji, jpr, jc, factor):
    """JAX's ``moe_ep_path`` on 2 expert shards under ``jax.vmap`` with
    ``axis_name="model"`` (its ``psum`` sums the shards): (T, D)."""
    e = jc.num_experts

    def shards(a):
        return a.reshape((2, e // 2) + a.shape[1:])

    def body(wg, wu, wd):
        return jmlp.moe_ep_path({"wg": wg, "wu": wu, "wd": wd}, x, ji, jpr,
                                jc, jnp.float32, capacity_factor=factor)

    out = jax.vmap(body, axis_name="model")(
        *(shards(jp[n]) for n in ("wg", "wu", "wd")))
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(out[1]))
    return np.asarray(out[0])


def test_moe_ep_on_two_ranks_matches_jax():
    """On 2 gloo ranks (16 tokens x 2, 4 experts, 2 a rank), at capacity
    factor 2.0 (nothing dropped) and 0.5 (cap 8, assignments dropped):
    ``moe_ep_path`` fed JAX's routing against JAX's body on 2 shards; and
    ``moe(..., mesh=)`` (its own routing, this rank's experts, deepseek's
    shared expert after the sum) against that body plus JAX's shared MLP,
    with aux equal to JAX's; both ranks bitwise equal."""
    factors = (2.0, 0.5)
    cases = {}
    for arch in ARCHS:
        jc = jax_cfg(arch)
        jp = jax.tree.map(lambda a: a[0],
                          _jax_params(arch)["blocks"]["moe"])
        x = np.random.default_rng(11).standard_normal(
            (B * S, jc.d_model)).astype(np.float32)
        _, ji, jpr, jaux = jmlp._routing(jp, jnp.asarray(x), jc)
        counts = np.bincount(np.asarray(ji).ravel(), minlength=4)
        assert counts.max() <= 32 and counts.max() > 8   # drops at cap 8
        bodies = [_jax_ep_body(jp, jnp.asarray(x), ji, jpr, jc, f)
                  for f in factors]
        shared = (np.asarray(jmlp.mlp(jp["shared"], jnp.asarray(x)))
                  if "shared" in jp else 0.0)
        arrays = {n: np.asarray(jp[n]) for n in ("router", "wg", "wu", "wd")}
        if "shared" in jp:
            arrays.update({f"shared_{n}": np.asarray(a)
                           for n, a in jp["shared"].items()})
        arrays.update(x=x, top_i=np.asarray(ji), top_p=np.asarray(jpr))
        cases[arch] = (arrays, bodies, shared, float(jaux))
    results = run_ranks(torch_ranks.moe_ep, 2, RANK_TIMEOUT,
                        {a: c[0] for a, c in cases.items()}, factors)
    for arch, (_, bodies, shared, jaux) in cases.items():
        for i, want in enumerate(bodies):
            r0, r1 = results[0][arch][i], results[1][arch][i]
            for key in ("body", "moe"):
                np.testing.assert_array_equal(r0[key], r1[key])
            atol = 1e-6 * float(np.abs(want).max())
            np.testing.assert_allclose(r0["body"], want, rtol=1e-5, atol=atol)
            np.testing.assert_allclose(r0["moe"], want + shared, rtol=1e-5,
                                       atol=atol)
            assert abs(r0["aux"] - jaux) <= 1e-5 * abs(jaux)
