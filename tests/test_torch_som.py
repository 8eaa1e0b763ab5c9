"""The port's SOM baseline against ``repro.core.som``, at side 8, dim 36
(satimage-shaped), on the CPU.

Both packages take the same numpy inputs; the port draws JAX's own numbers
through a ``ReplayDraws``: ``init``'s uniform or normal block, and
``train``'s per-step ``randint`` indices from JAX's ``split(key,
num_steps)``. Tiers: ``i`` and the lattice distances exact; ``init``'s
weights within 2 f32 ulps (XLA may contract ``u * (hi - lo) + lo`` into an
FMA); per step, with the state re-injected from JAX, BMU indices equal
outside the tie bound (``assert_bmu_tier``) and ``w`` within
``rtol = 1e-5, atol = 1e-6`` (``exp`` and the (B, N) x (B, D) product sum
in other orders); a 200-step run's held-out QE within 2 % of JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.core import metrics as jmetrics
from repro.core import search as jsearch
from repro.core import som as jsom
from repro_torch.api import TopoMap
from repro_torch.core import AFMConfig, SOMConfig, SOMState, classifier, som
from repro_torch.data import make_dataset
from repro_torch.kernels.bmu import ops as bmu_ops
from repro_torch.kernels.bmu import ref as bmu_ref
from torch_parity import assert_bmu_tier, replay, t

SIDE, DIM = 8, 36
W_RTOL, W_ATOL = 1e-5, 1e-6


def _data(n, seed):
    """Satimage-shaped: 6 classes of 36 features in (0, 1)."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0.2, 0.8, (6, DIM))
    y = rng.integers(0, 6, n)
    x = centres[y] + 0.08 * rng.standard_normal((n, DIM))
    return np.clip(x, 0.0, 1.0).astype(np.float32), y.astype(np.int32)


def _cfgs(**kw):
    kw = dict(side=SIDE, dim=DIM, i_max=2000, **kw)
    return jsom.SOMConfig(**kw), SOMConfig(**kw)


def test_config_matches_jax():
    for kw in ({}, dict(side=7, sigma0=2.5, i_max=99, batch=4)):
        jcfg, tcfg = jsom.SOMConfig(**kw), SOMConfig(**kw)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        for prop in ("n_units", "total_samples", "sigma_start"):
            assert getattr(jcfg, prop) == getattr(tcfg, prop)


def test_init_from_samples_matches_jax():
    jcfg, tcfg = _cfgs()
    x, _ = _data(300, seed=1)
    key = jax.random.PRNGKey(3)
    jstate = jsom.init(key, jcfg, jnp.asarray(x))
    u = jax.random.uniform(key, (tcfg.n_units, DIM))
    tstate = som.init(replay([u]), tcfg, t(x), device="cpu")
    assert tstate.i == int(jstate.i) == 0
    assert tstate.w.dtype == torch.float32 and tstate.w.device.type == "cpu"
    np.testing.assert_array_max_ulp(tstate.w.numpy(), np.asarray(jstate.w),
                                    maxulp=2)
    assert bool((tstate.w >= t(x).min(0).values).all())


def test_init_without_samples_matches_jax():
    jcfg, tcfg = _cfgs()
    key = jax.random.PRNGKey(4)
    jstate = jsom.init(key, jcfg)
    z = jax.random.normal(key, (tcfg.n_units, DIM))
    tstate = som.init(replay([z]), tcfg, device="cpu")
    np.testing.assert_array_max_ulp(tstate.w.numpy(), np.asarray(jstate.w),
                                    maxulp=2)


@pytest.mark.parametrize("side", [1, 5, SIDE, 30])
def test_lattice_dist2_bitwise(side):
    got = som._lattice_dist2(side, torch.device("cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jsom._lattice_dist2(side)))
    # built once per (side, device)
    assert som._lattice_dist2(side, torch.device("cpu")) is got


@pytest.mark.parametrize("b", [1, 8])
def test_train_step_matches_jax_per_step(b):
    """20 steps of JAX's ``train_step``; each step of the port starts from
    JAX's state before it."""
    jcfg, tcfg = _cfgs(batch=b)
    x, _ = _data(400, seed=b)
    jstate = jsom.init(jax.random.PRNGKey(b), jcfg, jnp.asarray(x))
    jstep = jax.jit(lambda s, xs: jsom.train_step(s, xs, jcfg))
    rng = np.random.default_rng(10 + b)
    compared = 0
    for _ in range(20):
        s = x[rng.integers(0, len(x), b)]
        w0 = np.asarray(jstate.w)
        tstate = som.train_step(SOMState(t(w0), int(jstate.i)), t(s), tcfg)
        jidx, jq2 = jsearch.exact_bmu(jstate.w, jnp.asarray(s))
        tidx, tq2 = bmu_ops.bmu(t(w0), t(s))
        assert_bmu_tier(tidx, tq2, jidx, jq2, w0, s)
        jstate = jstep(jstate, jnp.asarray(s))
        assert tstate.i == int(jstate.i)
        if np.array_equal(tidx.numpy(), np.asarray(jidx)):
            np.testing.assert_allclose(tstate.w.numpy(), np.asarray(jstate.w),
                                       rtol=W_RTOL, atol=W_ATOL)
            compared += 1
    assert compared >= 18


def test_train_step_searches_with_the_bmu_wrapper():
    """On CPU tensors the search is the wrapper's plain version: the same
    BMUs as ``bmu_ref``, and no kernel launch counted."""
    _, tcfg = _cfgs(batch=8)
    x, _ = _data(100, seed=5)
    state = som.init(replay([np.random.default_rng(0).random(
        (tcfg.n_units, DIM), dtype=np.float32)]), tcfg, t(x), device="cpu")
    before = bmu_ops.launches
    s = t(x[:8])
    new = som.train_step(state, s, tcfg)
    idx, _ = bmu_ref.bmu_ref(state.w, s)
    np.testing.assert_array_equal(
        new.w.numpy(), som.update(state, s, idx, tcfg).w.numpy())
    assert bmu_ops.launches == before


@pytest.mark.parametrize("b", [1, 8])
def test_train_matches_jax_quality(b):
    """200 steps from one JAX state on JAX's ``randint`` indices: the
    held-out QE within 2 % of JAX's, and below the initial QE."""
    jcfg, tcfg = _cfgs(batch=b)
    x, _ = _data(600, seed=20 + b)
    xtr, xte = x[:500], x[500:]
    key = jax.random.PRNGKey(7 + b)
    jstate0 = jsom.init(jax.random.PRNGKey(b), jcfg, jnp.asarray(xtr))
    jstate = jax.jit(lambda s, k: jsom.train(s, jnp.asarray(xtr), k, jcfg,
                                             num_steps=200))(jstate0, key)
    idx = [jax.random.randint(k, (b,), 0, len(xtr))
           for k in jax.random.split(key, 200)]
    draws = replay(idx)
    state0 = SOMState(t(np.asarray(jstate0.w)), 0)
    tstate = som.train(state0, t(xtr), draws, tcfg, num_steps=200,
                       device="cpu")
    assert len(draws) == 0 and tstate.i == int(jstate.i) == 200 * b
    jqe = float(jmetrics.quantization_error(jstate.w, jnp.asarray(xte)))
    tqe = float(som.quantization_error(tstate, t(xte)))
    assert abs(tqe - jqe) <= 0.02 * jqe, (tqe, jqe)
    assert tqe < float(som.quantization_error(state0, t(xte)))


def test_train_zero_and_negative_steps():
    _, tcfg = _cfgs()
    state = SOMState(torch.zeros(tcfg.n_units, DIM), 5)
    out = som.train(state, torch.zeros(4, DIM), replay([]), tcfg,
                    num_steps=0, device="cpu")
    assert out.i == 5 and torch.equal(out.w, state.w)
    with pytest.raises(ValueError, match="num_steps"):
        som.train(state, torch.zeros(4, DIM), replay([]), tcfg,
                  num_steps=-1, device="cpu")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine with no card")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        som.init(replay([np.zeros((tcfg.n_units, DIM), np.float32)]), tcfg)
    state = SOMState(torch.zeros(tcfg.n_units, DIM), 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        som.train(state, torch.zeros(4, DIM), replay([]), tcfg, num_steps=1)


def test_quantization_error_and_predict_match_plain():
    _, tcfg = _cfgs()
    x, y = _data(300, seed=9)
    state = som.init(replay([np.random.default_rng(1).random(
        (tcfg.n_units, DIM), dtype=np.float32)]), tcfg, t(x), device="cpu")
    idx, q2 = bmu_ref.bmu_ref(state.w, t(x))
    qe = som.quantization_error(state, t(x))
    assert qe.dim() == 0
    assert float(qe) == pytest.approx(float(torch.sqrt(q2).mean()), rel=1e-6)
    labels = classifier.label_units(state.w, t(x), t(y))
    np.testing.assert_array_equal(som.predict(state, labels, t(x)).numpy(),
                                  labels[idx.long()].numpy())
    got_idx, _ = som.best_units(state, t(x), chunk=64)   # five chunks
    np.testing.assert_array_equal(got_idx.numpy(), idx.numpy())


def test_som_baseline_improves():
    """The counterpart of ``tests/test_afm.py``'s SOM check: QE of held-out
    data falls by more than 30 % (satimage stand-in, 250 steps of B = 8)."""
    xtr, _, xte, _ = make_dataset("satimage", train_size=1000, test_size=300,
                                  device="cpu")
    cfg = SOMConfig(side=SIDE, dim=DIM, i_max=2000, batch=8)
    from repro_torch.draws import GeneratorDraws
    draws = GeneratorDraws(0, device="cpu")
    state = som.init(draws, cfg, xtr, device="cpu")
    q0 = float(som.quantization_error(state, xte))
    state = som.train(state, xtr, draws, cfg, device="cpu")
    assert float(som.quantization_error(state, xte)) < 0.7 * q0


def test_afm_comparable_to_som():
    """The counterpart of ``tests/test_system.py``'s Table 2 claim at
    reduced scale: on identical data (the satimage stand-in) the port's AFM
    classifies within 15 accuracy points of the port's same-budget SOM,
    both well above chance."""
    xtr, ytr, xte, yte = make_dataset("satimage", train_size=2000,
                                      test_size=500, device="cpu")
    acfg = AFMConfig(side=SIDE, dim=DIM, i_max=4000, batch=8, e_factor=1.0)
    tm = TopoMap(acfg, backend="batched", device="cpu").fit(xtr, ytr)
    acc_afm = float((tm.predict(xte) == yte).float().mean())

    from repro_torch.draws import GeneratorDraws
    scfg = SOMConfig(side=SIDE, dim=DIM, i_max=4000, batch=8)
    draws = GeneratorDraws(0, device="cpu")
    sstate = som.train(som.init(draws, scfg, xtr, device="cpu"), xtr, draws,
                       scfg, device="cpu")
    labels = classifier.label_units(sstate.w, xtr, ytr)
    acc_som = float((som.predict(sstate, labels, xte) == yte).float().mean())
    assert acc_afm > 1 / 6 * 1.5
    assert acc_afm > acc_som - 0.15, (acc_afm, acc_som)
