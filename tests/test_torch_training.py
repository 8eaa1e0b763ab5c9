"""The port's LM training path against the JAX package, at
``get_smoke("llama3.2-1b")`` (f32, 2 layers, d_model 256) with B = 2,
S = 32: the cross-entropy (whole and chunked), ``forward_train``, the
gradients of the step's loss, AdamW, the AFM probe, one whole train step,
the token pipeline, ``get_optimized``, the training checkpoint of bf16
weights, and the train launcher on the CPU.

Weights come from the JAX package's ``init_params`` and are carried across
with ``convert.lm_params_from_numpy``; inputs are numpy draws from a seed;
the probe replays JAX's key chain (``torch_parity.step_draws``).
Tolerances: CE within 1e-5 relative; logits and hidden states within
1e-4 relative plus 2e-5 absolute (as ``test_torch_lm.py``); each gradient
leaf within 1e-4 of that leaf's max |g|; AdamW fed JAX's own gradients
within a few f32 ulp (the optimizer held apart from autograd); the probe's
integers bitwise, its weights within a few ulp an adaptation.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro import configs as jconfigs
from repro.core import probe as jprobe
from repro.models import common as jcommon
from repro.models import transformer as jtr
from repro.training import adamw as jadamw
from repro.training import checkpoint as jckpt
from repro.training import train_step as jtrain
from repro_torch import configs, convert
from repro_torch.convert import state_from_numpy
from repro_torch.core import probe
from repro_torch.data import tokens
from repro_torch.draws import GeneratorDraws
from repro_torch.kernels.bmu import ref as bmu_ref
from repro_torch.launch import train as train_cli
from repro_torch.models import common, transformer
from repro_torch.training import adamw, checkpoint, train_step
from torch_parity import F32_EPS, replay, step_draws, t

ARCH = "llama3.2-1b"
B, S = 2, 32
RTOL, ATOL = 1e-4, 2e-5
CE_RTOL = 1e-5
GRAD_TOL = 1e-4


def jax_cfg(**kw):
    return dataclasses.replace(jconfigs.get_smoke(ARCH), **kw)


def torch_cfg(**kw):
    return dataclasses.replace(configs.get_smoke(ARCH), **kw)


@pytest.fixture(scope="module")
def jparams():
    return jtr.init_params(jax.random.PRNGKey(1), jax_cfg())


def _model(params, cfg, trainable=True):
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         cfg, "cpu")
    return model.requires_grad_(trainable)


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


# ---------------------------------------------------------------------------
# cross-entropy


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((B, S, 512))).astype(np.float32)
    labels = rng.integers(0, 512, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.6).astype(np.float32) if masked else None
    want = jcommon.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = common.softmax_cross_entropy(t(logits), t(labels),
                                       None if mask is None else t(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    assert _rel(got.numpy(), want) <= CE_RTOL


@pytest.mark.parametrize("ce_chunk", [8, 12])
def test_chunked_ce_loss_matches_jax(jparams, ce_chunk):
    """ce_chunk 8 splits the 31 predictions into 3 chunks and a tail of 7;
    12 into 2 and a tail of 7; both against JAX and against the full CE."""
    rng = np.random.default_rng(4)
    hidden = rng.standard_normal((B, S, 256)).astype(np.float32)
    labels = rng.integers(0, 512, (B, S)).astype(np.int32)
    jc, tc = jax_cfg(ce_chunk=ce_chunk), torch_cfg(ce_chunk=ce_chunk)
    want = jtr.chunked_ce_loss(jparams, jnp.asarray(hidden),
                               jnp.asarray(labels), jc)
    model = _model(jparams, tc, trainable=False)
    got = transformer.chunked_ce_loss(model, t(hidden), t(labels), tc)
    assert _rel(got.numpy(), want) <= CE_RTOL
    full = common.softmax_cross_entropy(
        transformer._logits(model, t(hidden), tc)[:, :-1], t(labels)[:, 1:])
    assert _rel(got.numpy(), full.numpy()) <= CE_RTOL


# ---------------------------------------------------------------------------
# forward and gradients


def test_forward_train_matches_jax(jparams, batch):
    jc, tc = jax_cfg(), torch_cfg()
    jl, jaux, jh = jtr.forward_train(jparams, _jbatch(batch), jc,
                                     return_hidden=True)
    model = _model(jparams, tc)
    logits, aux, hidden = transformer.forward_train(model, _tbatch(batch),
                                                    tc, return_hidden=True)
    assert logits.dtype == torch.float32 and logits.shape == (B, S, 512)
    assert aux.shape == () and float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(hidden.detach().numpy(), np.asarray(jh),
                               rtol=RTOL, atol=ATOL)
    l2, aux2 = transformer.forward_train(model, _tbatch(batch), tc)
    assert torch.equal(l2, logits)


def _jax_loss(params, batch, cfg):
    """JAX's ``make_train_step`` loss, as its ``loss_fn`` computes it."""
    labels = batch["labels"]
    if cfg.chunked_ce:
        hidden, aux = jtr.forward_hidden(params, batch, cfg)
        ce = jtr.chunked_ce_loss(params, hidden, labels, cfg)
    else:
        logits, aux = jtr.forward_train(params, batch, cfg)
        ce = jcommon.softmax_cross_entropy(logits[:, :-1], labels[:, 1:])
    return ce + cfg.router_aux_coef * aux


GRAD_CASES = {
    "plain": dict(remat=False),
    "remat": dict(remat=True),
    "chunked attention": dict(remat=True, attention_impl="chunked",
                              attention_chunk=8),
    "chunked ce": dict(remat=True, chunked_ce=True, ce_chunk=12),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_loss_gradients_match_jax(jparams, batch, case):
    """The step's loss and its gradient, leaf by leaf, against
    ``jax.value_and_grad`` of JAX's loss under the same config."""
    kw = GRAD_CASES[case]
    jc, tc = jax_cfg(**kw), torch_cfg(**kw)
    jloss, jgrads = jax.value_and_grad(_jax_loss)(jparams, _jbatch(batch), jc)
    model = _model(jparams, tc)
    params = dict(model.named_parameters())
    loss, _, _, _ = train_step.lm_loss(model, _tbatch(batch), tc)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert _rel(loss.detach().numpy(), jloss) <= CE_RTOL
    jtree = jax.tree.map(np.asarray, jgrads)
    for (name, _), g in zip(params.items(), grads):
        want = convert._leaf(jtree, name)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)


def test_remat_runs_only_under_training(jparams, batch, monkeypatch):
    """A served model (weights not trainable) never checkpoints a block;
    a trainable one does under ``cfg.remat``, and gives the same values."""
    calls = []
    real = transformer.checkpoint

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(transformer, "checkpoint", counting)
    tc = torch_cfg(remat=True)
    served = transformer.forward(_model(jparams, tc, trainable=False),
                                 _tbatch(batch), tc)
    assert not calls
    trained = transformer.forward(_model(jparams, tc), _tbatch(batch), tc)
    assert len(calls) == tc.num_layers
    assert torch.equal(served, trained.detach())


# ---------------------------------------------------------------------------
# AdamW


def _jax_opt_state(params, seed, step):
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda p: jnp.asarray(
        0.01 * rng.standard_normal(p.shape).astype(np.float32)), params)
    nu = jax.tree.map(lambda p: jnp.asarray(
        1e-4 * rng.random(p.shape).astype(np.float32)), params)
    return jadamw.AdamWState(mu, nu, jnp.int32(step))


def _named(tree, model):
    """The port's name -> tensor dict of a JAX-layout numpy tree."""
    return {name: t(convert._leaf(tree, name)).clone()
            for name, _ in model.named_parameters()}


@pytest.mark.parametrize("step,clip", [(0, 1.0), (7, 1.0), (40, 0.0)])
def test_adamw_update_matches_jax_on_jax_grads(jparams, batch, step, clip):
    """``adamw_update`` fed JAX's own gradients, from JAX's params and a
    re-injected moment state: new params, mu and nu within a few f32 ulp of
    each leaf's max; lr and grad_norm within 1e-6. Weight decay follows
    JAX's ndim >= 2 on its stacked tree (the blocks' norm scales decay)."""
    jc = jax_cfg()
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=50,
                             grad_clip=clip)
    topt = adamw.AdamWConfig(**dataclasses.asdict(opt))
    jgrads = jax.grad(_jax_loss)(jparams, _jbatch(batch), jc)
    # scale the gradients up so that clipping, where set, bites
    jgrads = jax.tree.map(lambda g: 50.0 * g, jgrads)
    jstate = _jax_opt_state(jparams, seed=step + 1, step=step)
    jp, js, jm = jadamw.adamw_update(jparams, jgrads, jstate, opt)

    model = _model(jparams, torch_cfg(), trainable=False)
    tree = lambda x: jax.tree.map(np.asarray, x)  # noqa: E731
    params = _named(tree(jparams), model)
    grads = _named(tree(jgrads), model)
    state = adamw.AdamWState(_named(tree(jstate.mu), model),
                             _named(tree(jstate.nu), model),
                             torch.tensor(step, dtype=torch.int32))
    tp, ts, tm = adamw.adamw_update(params, grads, state, topt)
    assert int(ts.step) == int(js.step) == step + 1
    assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-6 * abs(
        float(jm["lr"])) + 1e-12
    assert _rel(tm["grad_norm"].numpy(), jm["grad_norm"]) <= 1e-6
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        want = tree(want)
        for name, x in got.items():
            w = convert._leaf(want, name)
            bound = 4 * F32_EPS * max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(x.numpy() - w).max()) <= bound, name
    assert adamw.decays("blocks.0.ln1", model.blocks[0].ln1)
    assert not adamw.decays("ln_f", model.ln_f)


def test_lr_schedule_matches_jax():
    cfg = jadamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                             min_lr_frac=0.1)
    tcfg = adamw.AdamWConfig(**dataclasses.asdict(cfg))
    for i in range(0, 121, 3):
        got = adamw.lr_schedule(tcfg, torch.tensor(i, dtype=torch.int32))
        want = jadamw.lr_schedule(cfg, jnp.int32(i))
        assert abs(float(got) - float(want)) <= 1e-6


def test_adamw_reduces_quadratic():
    """JAX's own optimizer test, on the port."""
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            total_steps=200, grad_clip=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.adamw_init(params)
    for _ in range(200):
        grads = {"w": 2.0 * params["w"]}
        params, state, _ = adamw.adamw_update(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.5


# ---------------------------------------------------------------------------
# the AFM probe

PROBE = dict(side=6, dim=24, i_max=400, c_m=1.0)


def _jax_probe_state(pcfg, seed):
    """A JAX probe map with every counter one below threshold, so that a
    successful drive sets off a cascade; i > 0."""
    st = jprobe.init(jax.random.PRNGKey(seed), pcfg).afm
    c = jnp.full(st.c.shape, pcfg.theta - 1, jnp.int32)
    return jprobe.ProbeState(st._replace(c=c, i=jnp.int32(24)))


def _assert_w_close(w, w_ref, adaptations):
    bound = 4 * F32_EPS * (1 + adaptations) * np.abs(w_ref).max()
    assert np.abs(np.asarray(w) - np.asarray(w_ref)).max() <= bound


@pytest.mark.parametrize("search", ["exact", "heuristic"])
def test_probe_update_matches_jax(search):
    """``probe.update`` on the CPU (``afm.EXACT_STAGES`` or
    ``DEFAULT_STAGES``) on identical vectors and JAX's own draws, three
    keys: GMUs, counters, cascade size and waves bitwise; w within a few
    ulp an adaptation."""
    jp = jprobe.ProbeConfig(search=search, **PROBE)
    tp = probe.ProbeConfig(search=search, **PROBE)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert dataclasses.asdict(tp.afm_config()) == dataclasses.asdict(
        jp.afm_config())
    jstate = _jax_probe_state(jp, seed=3)
    vecs = np.random.default_rng(5).standard_normal((4, 24)).astype(
        np.float32)
    acfg = jp.afm_config()
    total = 0
    for seed in range(3):
        key = jax.random.PRNGKey(20 + seed)
        jnew, jaux = jprobe.update(jstate, jnp.asarray(vecs), key, jp)
        draws = replay(step_draws(key, acfg, 4, heuristic=search != "exact",
                                  waves=int(jaux.waves)))
        tnew, taux = probe.update(
            probe.ProbeState(state_from_numpy(jstate.afm, "cpu")), t(vecs),
            draws, tp)
        assert len(draws) == 0
        for field in ("gmu", "cascade_size", "waves", "greedy_steps"):
            np.testing.assert_array_equal(getattr(taux, field).numpy(),
                                          np.asarray(getattr(jaux, field)))
        np.testing.assert_array_equal(tnew.afm.c.numpy(),
                                      np.asarray(jnew.afm.c))
        assert tnew.afm.i == int(jnew.afm.i)
        _assert_w_close(tnew.afm.w, jnew.afm.w, 1 + int(jaux.waves))
        total += int(jaux.waves)
    assert total > 0


def test_probe_pool_and_init():
    h = np.random.default_rng(6).standard_normal((3, 7, 5)).astype(np.float32)
    np.testing.assert_allclose(probe.pool_hidden(t(h)).numpy(),
                               np.asarray(jprobe.pool_hidden(jnp.asarray(h))),
                               rtol=1e-6, atol=1e-7)
    state = probe.init(GeneratorDraws(4, "cpu"), probe.ProbeConfig(**PROBE),
                       device="cpu")
    again = probe.init(GeneratorDraws(4, "cpu"), probe.ProbeConfig(**PROBE),
                       device="cpu")
    assert state.afm.w.shape == (36, 24) and state.afm.i == 0
    assert not bool(state.afm.c.any()) and state.afm.far.shape == (36, 8)
    assert torch.equal(state.afm.w, again.afm.w)
    # N(0, 0.1) weights, as JAX's init without samples
    assert 0.05 < float(state.afm.w.std()) < 0.15
    with pytest.raises(ValueError, match="search"):
        probe.stages_for(probe.ProbeConfig(search="greedy"),
                         torch.device("cpu"))


# ---------------------------------------------------------------------------
# a whole train step with the probe


def test_train_step_with_probe_matches_jax(jparams, batch):
    """One ``make_train_step`` step from JAX's weights and probe map: loss,
    ce, grad_norm, lr within tolerance; the probe's GMUs where the BMU gap
    exceeds the tie bound, and then its counters, cascade size bitwise and
    its weights within the vectors' difference."""
    jc, tc = jax_cfg(remat=True), torch_cfg(remat=True)
    jp = jprobe.ProbeConfig(side=6, dim=256, i_max=4000, c_m=1.0)
    tp = probe.ProbeConfig(side=6, dim=256, i_max=4000, c_m=1.0)
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=8)
    pstate = _jax_probe_state(jp, seed=9)
    jstate = jtrain.TrainState(jparams, jadamw.adamw_init(jparams),
                               jnp.int32(0), pstate)
    key = jax.random.PRNGKey(0)         # a key whose drive sets off a cascade
    jnew, jm = jax.jit(jtrain.make_train_step(jc, opt, jp))(
        jstate, _jbatch(batch), key)
    _, _, jh = jtr.forward_train(jparams, _jbatch(batch), jc,
                                 return_hidden=True)
    jvecs = np.asarray(jprobe.pool_hidden(jh))

    model = _model(jparams, tc)
    state = train_step.TrainState(
        model, adamw.adamw_init(dict(model.named_parameters())),
        torch.zeros((), dtype=torch.int32),
        probe.ProbeState(state_from_numpy(pstate.afm, "cpu")))
    w0 = state.probe.afm.w.clone()
    step = train_step.make_train_step(
        tc, adamw.AdamWConfig(**dataclasses.asdict(opt)), tp)
    # JAX's chain for the probe's key, with more waves than any cascade
    # here runs (the step takes what it needs)
    draws = replay(step_draws(key, jp.afm_config(), B, heuristic=False,
                              waves=64))
    new, m = step(state, _tbatch(batch), draws)
    assert set(m) == {"loss", "ce", "moe_aux", "grad_norm", "lr",
                      "probe_cascade"}
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert _rel(m[k].numpy(), jm[k]) <= 1e-5, k
    assert float(m["moe_aux"]) == 0.0 and int(new.step) == 1
    gap = bmu_ref.top2_gap(w0, t(jvecs)).numpy()
    bound = bmu_ref.tie_bound(w0, t(jvecs)).numpy()
    vec_err = float(np.abs(probe.pool_hidden(
        transformer.forward_train(_model(jparams, tc), _tbatch(batch), tc,
                                  return_hidden=True)[2]).detach().numpy()
        - jvecs).max())
    assert vec_err <= RTOL * np.abs(jvecs).max() + ATOL
    assert int(jm["probe_cascade"]) > 0
    if np.all(gap > bound + 4 * vec_err):
        assert int(m["probe_cascade"]) == int(jm["probe_cascade"])
        np.testing.assert_array_equal(new.probe.afm.c.numpy(),
                                      np.asarray(jnew.probe.afm.c))
        dw = np.abs(new.probe.afm.w.numpy() - np.asarray(jnew.probe.afm.w))
        assert dw.max() <= (vec_err + 64 * F32_EPS
                            * np.abs(np.asarray(jnew.probe.afm.w)).max())
    assert new.probe.afm.i == int(jnew.probe.afm.i) == 24 + B


# ---------------------------------------------------------------------------
# the token pipeline


def test_token_batches_walk_the_successor_table():
    """Shape, dtype and range; every row a walk of the successor table but
    for the ~2 % resamples; the successor slots taken with the Zipf
    weights (a chi-square test at a fixed seed, over the transitions from
    tokens whose table row has no repeated successor)."""
    vocab, b, s, k = 5000, 8, 400, 8
    out = list(tokens.batches(torch.Generator().manual_seed(7), vocab, b, s,
                              3, device="cpu"))
    table, weights = tokens.make_markov(torch.Generator().manual_seed(7),
                                        vocab)
    assert table.shape == (vocab, k)
    zipf = 1 / np.arange(1, k + 1)
    np.testing.assert_allclose(weights.numpy(), zipf / zipf.sum(), rtol=1e-6)
    tab = table.numpy()
    distinct = np.array([len(set(row)) == k for row in tab])
    counts = np.zeros(k)
    walks = total = 0
    for bt in out:
        toks = bt["tokens"]
        assert bt["labels"] is toks
        assert toks.shape == (b, s) and toks.dtype == torch.int32
        assert int(toks.min()) >= 0 and int(toks.max()) < vocab
        x = toks.numpy()
        prev, nxt = x[:, :-1].ravel(), x[:, 1:].ravel()
        hit = tab[prev] == nxt[:, None]                  # (transitions, k)
        on_walk = hit.any(axis=1)
        walks += int(on_walk.sum())
        total += on_walk.size
        use = on_walk & distinct[prev]
        counts += np.bincount(hit[use].argmax(axis=1), minlength=k)
    # all but the ~2 % resamples follow the table
    assert 0.96 <= walks / total <= 0.995
    # chi-square, 7 degrees of freedom, below its 0.999 quantile (24.32)
    expect = weights.numpy() * counts.sum()
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 24.32, (counts, expect)


# ---------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("arch", ["llama3.2-1b", "smollm-360m", "yi-9b",
                                  "deepseek-coder-33b", "deepseek-moe-16b",
                                  "granite-moe-1b-a400m", "mamba2-1.3b",
                                  "recurrentgemma-2b"])
def test_get_optimized_matches_jax(arch):
    ours = dataclasses.asdict(configs.get_optimized(arch))
    theirs = dataclasses.asdict(jconfigs.get_optimized(arch))
    for key in ("dtype", "param_dtype"):
        ours.pop(key), theirs.pop(key)
    assert ours == theirs
    assert configs.OPTIMIZED == jconfigs.OPTIMIZED


@pytest.mark.parametrize("arch", ["qwen2-vl-72b"])
def test_get_optimized_refuses_unported_families(arch):
    """The VLM's optimised config (chunked attention and CE) is JAX's,
    field for field, now that the family is ported."""
    ours = dataclasses.asdict(configs.get_optimized(arch))
    theirs = dataclasses.asdict(jconfigs.get_optimized(arch))
    for key in ("dtype", "param_dtype"):
        ours.pop(key), theirs.pop(key)
    assert ours == theirs
    assert (ours["attention_impl"], ours["chunked_ce"]) == ("chunked", True)


# ---------------------------------------------------------------------------
# checkpoints of the weights


def _bf16_cfgs():
    return (jax_cfg(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16),
            torch_cfg(dtype=torch.bfloat16, param_dtype=torch.bfloat16))


def test_bf16_weights_checkpoint_byte_for_byte_with_jax(tmp_path):
    """bf16 weights: the port's file of a model holding JAX's weights is
    byte for byte JAX's ``save`` of them; each package restores the
    other's, leaves bitwise."""
    jc, tc = _bf16_cfgs()
    jp = jtr.init_params(jax.random.PRNGKey(2), jc)
    model = _model(jp, tc, trainable=False)
    assert model.embed.dtype == torch.bfloat16
    ours, theirs = str(tmp_path / "port.msgpack"), str(tmp_path / "jax.msgpack")
    tree = convert.lm_params_tree(model)
    assert tree["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    checkpoint.save(ours, tree)
    jckpt.save(theirs, jp)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    back = jckpt.restore(ours, jp)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x).view(np.uint16),
                                      np.asarray(y).view(np.uint16))
    mine = checkpoint.restore(theirs, tree)
    for x, y in zip(jax.tree.leaves(mine), jax.tree.leaves(tree)):
        assert x.dtype == y.dtype and torch.equal(x.view(torch.int16),
                                                  y.view(torch.int16))


def test_bf16_leaf_round_trips_into_other_dtypes(tmp_path):
    """A bf16 record restores into an f32 ``like`` leaf (exact) and an f32
    record into a bf16 one (rounded as ``.to`` rounds)."""
    path = str(tmp_path / "x.msgpack")
    x = torch.randn(3, 5).bfloat16()
    checkpoint.save(path, {"a": x, "n": 3})
    out = checkpoint.restore(path, {"a": torch.zeros(3, 5), "n": 0})
    assert out["a"].dtype == torch.float32 and out["n"] == 3
    assert torch.equal(out["a"], x.float())
    y = torch.randn(4)
    checkpoint.save(path, {"a": y, "n": 1})
    out = checkpoint.restore(path, {"a": torch.zeros(4).bfloat16(), "n": 0})
    assert torch.equal(out["a"], y.bfloat16())


def test_launcher_checkpoint_is_jax_s_file(tmp_path, capsys):
    """``run(..., checkpoint=)`` of a smoke model: JAX restores it into its
    ``init_params`` tree of the same config, and JAX's ``save`` of what it
    restored is the port's file, byte for byte."""
    path = str(tmp_path / "smoke.msgpack")
    train_cli.run(configs.get_smoke(ARCH), steps=2, batch=2, seq=16,
                  checkpoint=path, device="cpu")
    assert f"saved params to {path}" in capsys.readouterr().out
    like = jtr.init_params(jax.random.PRNGKey(0), jax_cfg())
    restored = jckpt.restore(path, like)
    again = str(tmp_path / "jax.msgpack")
    jckpt.save(again, restored)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------------------
# the launcher


@pytest.mark.parametrize("with_probe", [False, True])
def test_train_launcher_runs_on_the_cpu(capsys, with_probe):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "8",
            "--batch", "4", "--seq", "32", "--log-every", "4"]
    losses = train_cli.main(argv + (["--probe"] if with_probe else []))
    out = capsys.readouterr().out
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert "arch=llama3.2-1b-smoke" in out and "done: loss" in out
    assert ("probe_cascade=" in out) == with_probe
    assert out.count("step ") == 3                     # steps 0, 4 and 7


def test_train_launcher_refuses(capsys):
    """Without a card the launcher refuses a run that does not ask for the
    CPU; the VLM, refused before it was ported, trains on the CPU through
    ``main`` and ``run``."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_cli.main(["--arch", ARCH, "--smoke", "--steps", "1"])
    losses = train_cli.main(["--arch", "qwen2-vl-72b", "--smoke", "--device",
                             "cpu", "--steps", "2", "--batch", "2", "--seq",
                             "16"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "arch=qwen2-vl-72b-smoke" in capsys.readouterr().out
    losses = train_cli.run(configs.get_smoke("qwen2-vl-72b"), steps=1,
                           batch=2, seq=16, device="cpu")
    assert len(losses) == 1 and np.isfinite(losses[0])


@pytest.mark.slow
def test_loss_decreases_small_lm():
    """JAX's ``tests/test_training.py`` loss-decrease test, on the port."""
    cfg = configs.get_smoke("smollm-360m")
    opt = adamw.AdamWConfig(lr=2e-3, total_steps=40, warmup_steps=4)
    state = train_step.init_train_state(cfg, seed=0, device="cpu")
    step = train_step.make_train_step(cfg, opt)
    losses = []
    for batch in tokens.batches(torch.Generator().manual_seed(0),
                                cfg.vocab_size, 4, 64, 40, device="cpu"):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert sum(losses[-5:]) < sum(losses[:5])
