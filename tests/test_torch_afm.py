"""The port's AFM step and training loop against ``repro.core.afm``.

Each step starts from a ``state_from_numpy`` copy of a JAX state and draws
the numbers JAX's key chain produced. Tiers: GMUs, counters, cascade size
and waves, greedy steps bitwise; ``w`` within a few f32 ULP per adaptation
(XLA fuses the Eq. 3 and wave updates into FMAs, eager PyTorch does not);
``q2`` within the expanded-distance bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.core import afm as jafm
from repro_torch.api import backends as tbackends
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import afm as tafm
from repro_torch.kernels.cascade.ops import DEFAULT_WAVE_CAP
from torch_parity import (F32_EPS, assert_bmu_tier, fused_step_draws,
                          jax_cfg, replay, t, torch_cfg, train_draws)

# c_m = 1 raises the cascade probability p_i to ~0.8, for more cascades
CFG = dict(side=6, dim=12, e_factor=0.5, i_max=2000, c_m=1.0)


def _jax_state(cfg, seed, data):
    """A mid-training JAX state with every counter one below threshold, so
    that a successful drive sets off a cascade; i > 0."""
    state = jafm.init(jax.random.PRNGKey(seed), cfg, jnp.asarray(data))
    c = np.full(cfg.n_units, cfg.theta - 1, np.int32)
    return state._replace(c=jnp.asarray(c), i=jnp.int32(37))


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    centres = 2.0 * rng.standard_normal((4, d))
    x = centres[rng.integers(0, 4, n)] + 0.4 * rng.standard_normal((n, d))
    return x.astype(np.float32)


def _assert_w_close(w, w_ref, adaptations):
    bound = 4 * F32_EPS * (1 + adaptations) * np.abs(w_ref).max()
    assert np.abs(np.asarray(w) - np.asarray(w_ref)).max() <= bound


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("search", ["exact", "heuristic"])
def test_step_matches_jax(search, b):
    """One ``_step`` through the kernel backend's stages (plain versions on
    the CPU) against JAX's staged step, from three keys; at least one of
    them must set off a cascade. The kernel backend's cascade stage takes
    its wave draws as one block of ``DEFAULT_WAVE_CAP`` waves (then one per
    tail wave): JAX's per-wave draws, stacked."""
    kw = dict(CFG, batch=b)
    jcfg, tcfg = jax_cfg(**kw), torch_cfg(**kw)
    data = _data(64, jcfg.dim, seed=b)
    jstate = _jax_state(jcfg, seed=b + 1, data=data)
    samples = data[:b]
    jstages = jafm.EXACT_STAGES if search == "exact" else jafm.DEFAULT_STAGES
    jstep = jax.jit(lambda s, x, k: jafm._step(s, x, k, jcfg, jstages))
    stages = tbackends.get_backend("kernel", tcfg, search=search,
                                   device="cpu").stages
    total_waves = 0
    for seed in range(3):
        key = jax.random.PRNGKey(10 * b + seed)
        jnew, jaux = jstep(jstate, jnp.asarray(samples), key)
        draws = replay(fused_step_draws(key, jcfg, b,
                                        heuristic=search == "heuristic",
                                        wave_cap=DEFAULT_WAVE_CAP,
                                        waves=int(jaux.waves)))
        tnew, taux = tafm._step(state_from_numpy(jstate, device="cpu"),
                                t(samples), draws, tcfg, stages)
        assert len(draws) == 0
        for field in ("gmu", "cascade_size", "waves", "greedy_steps"):
            got = getattr(taux, field)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(getattr(jaux, field)))
        np.testing.assert_array_equal(tnew.c.numpy(), np.asarray(jnew.c))
        assert tnew.i == int(jnew.i) == 37 + b
        np.testing.assert_array_equal(tnew.far.numpy(), np.asarray(jnew.far))
        _assert_w_close(tnew.w, jnew.w, 1 + int(jaux.waves))
        assert_bmu_tier(taux.gmu, taux.q2, jaux.gmu, jaux.q2,
                        np.asarray(jstate.w), samples)
        total_waves += int(jaux.waves)
    assert total_waves > 0


def test_adapt_merges_duplicate_gmus():
    """Eq. 3 with conflicting GMUs: each hit unit moves towards the mean of
    its samples (as the JAX scatter-add merge), misses stay put."""
    cfg = torch_cfg(**dict(CFG, batch=5))
    jcfg = jax_cfg(**dict(CFG, batch=5))
    rng = np.random.default_rng(0)
    w = rng.standard_normal((cfg.n_units, cfg.dim)).astype(np.float32)
    s = rng.standard_normal((5, cfg.dim)).astype(np.float32)
    gmu = np.array([3, 7, 3, 3, 30], np.int32)
    tw, tc = tafm.adapt_merge(t(w), t(s), t(gmu), cfg)
    jw, jc = jafm.adapt_merge(jnp.asarray(w), jnp.asarray(s), jnp.asarray(gmu),
                              jcfg)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _assert_w_close(tw, jw, 2)
    untouched = np.setdiff1d(np.arange(cfg.n_units), gmu)
    np.testing.assert_array_equal(tw.numpy()[untouched], w[untouched])


@pytest.mark.parametrize("search", ["exact", "heuristic"])
def test_train_matches_jax(search):
    """``train``: sample indices then each step's draws, three steps, aux
    bitwise per step."""
    kw = dict(CFG, batch=3)
    jcfg, tcfg = jax_cfg(**kw), torch_cfg(**kw)
    data = _data(50, jcfg.dim, seed=7)
    jstate = _jax_state(jcfg, seed=8, data=data)
    key = jax.random.PRNGKey(5)
    jstages = jafm.EXACT_STAGES if search == "exact" else jafm.DEFAULT_STAGES
    jnew, jaux = jax.jit(lambda s, d, k: jafm.train(
        s, d, k, jcfg, num_steps=3, stages=jstages))(
            jstate, jnp.asarray(data), key)
    draws = replay(train_draws(key, jcfg, len(data), 3, np.asarray(jaux.waves),
                               heuristic=search == "heuristic"))
    tstages = tafm.EXACT_STAGES if search == "exact" else tafm.DEFAULT_STAGES
    tnew, taux = tafm.train(state_from_numpy(jstate, device="cpu"), t(data),
                            draws, tcfg, num_steps=3, stages=tstages)
    assert len(draws) == 0 and int(np.sum(jaux.waves)) > 0
    for field in ("gmu", "cascade_size", "waves", "greedy_steps"):
        np.testing.assert_array_equal(getattr(taux, field).numpy(),
                                      np.asarray(getattr(jaux, field)))
    np.testing.assert_array_equal(tnew.c.numpy(), np.asarray(jnew.c))
    _assert_w_close(tnew.w, jnew.w, 3 + int(np.sum(jaux.waves)))


@pytest.mark.parametrize("search", ["exact", "heuristic"])
def test_train_zero_steps_matches_jax(search):
    """``train`` with ``num_steps=0``: JAX's ``lax.scan`` runs no step and
    returns the state as it was and an aux with a zero-length step axis;
    the port returns the same state and an aux of the same shapes and
    dtypes, and draws nothing."""
    kw = dict(CFG, batch=3)
    jcfg, tcfg = jax_cfg(**kw), torch_cfg(**kw)
    data = _data(20, jcfg.dim, seed=2)
    jstate = _jax_state(jcfg, seed=4, data=data)
    jstages = jafm.EXACT_STAGES if search == "exact" else jafm.DEFAULT_STAGES
    jnew, jaux = jafm.train(jstate, jnp.asarray(data), jax.random.PRNGKey(0),
                            jcfg, num_steps=0, stages=jstages)
    tstages = tafm.EXACT_STAGES if search == "exact" else tafm.DEFAULT_STAGES
    draws = replay([])
    tnew, taux = tafm.train(state_from_numpy(jstate, device="cpu"), t(data),
                            draws, tcfg, num_steps=0, stages=tstages)
    for field in ("w", "c", "far", "near"):
        np.testing.assert_array_equal(getattr(tnew, field).numpy(),
                                      np.asarray(getattr(jnew, field)))
    assert tnew.i == int(jnew.i)
    for field in taux._fields:
        got, want = getattr(taux, field), np.asarray(getattr(jaux, field))
        assert tuple(got.shape) == want.shape, field
        assert got.numpy().dtype == want.dtype, field
    assert taux.gmu.shape == (0, 3)
    with pytest.raises(ValueError, match="num_steps"):
        tafm.train(tnew, t(data), draws, tcfg, num_steps=-1)


def test_state_numpy_round_trip():
    cfg = jax_cfg(**CFG)
    jstate = _jax_state(cfg, seed=3, data=_data(20, cfg.dim, seed=3))
    state = state_from_numpy(jstate, device="cpu")
    assert [state.w.dtype, state.c.dtype, state.far.dtype, state.near.dtype] \
        == [torch.float32, torch.int32, torch.int32, torch.int32]
    back = state_to_numpy(state)
    for f in ("w", "c", "far", "near", "i"):
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jstate, f)))
        assert back[f].dtype == np.asarray(getattr(jstate, f)).dtype
    again = state_from_numpy(back, device="cpu")
    assert torch.equal(again.w, state.w) and again.i == state.i


def test_init_shapes_and_bounds():
    from repro_torch.draws import GeneratorDraws
    cfg = torch_cfg(**CFG)
    data = t(_data(30, cfg.dim, seed=1))
    state = tafm.init(GeneratorDraws(0, device="cpu"), cfg, data)
    assert state.w.shape == (cfg.n_units, cfg.dim) and state.i == 0
    assert bool((state.w >= data.min(0).values).all())
    assert bool((state.w <= data.max(0).values).all())
    assert state.far.shape == (cfg.n_units, cfg.phi)
    free = tafm.init(GeneratorDraws(0, device="cpu"), cfg)
    assert abs(float(free.w.std()) - 0.1) < 0.02


def test_config_defaults_match_jax():
    assert dataclasses.asdict(torch_cfg()) == dataclasses.asdict(jax_cfg())
    cfg = torch_cfg()
    assert (cfg.n_units, cfg.dim, cfg.e, cfg.total_samples) == \
        (900, 784, 2700, 540_000)
