"""The port's sandpile oracle (``repro_torch.core.sandpile``) against the JAX
package's, on the CPU, bitwise: counters, cascade sizes and wave counts are
integer work, and the port replays JAX's draws (per chain step the site, the
grain, then one ``(4, side, side)`` uniform per wave). Also the event
engine's avalanche sizes at p = 1, which equal the sandpile chain's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.core import afm as jafm
from repro.core import sandpile as jsand
from repro_torch.convert import state_from_numpy
from repro_torch.core import events as tev
from repro_torch.core import sandpile as tsand
from repro_torch.core.search import SearchResult
from repro_torch.draws import GeneratorDraws
from repro_torch.kernels.cascade import ref as cas_ref
from torch_parity import jax_cfg, replay, t, torch_cfg


def _wave_draws(key, side, waves):
    out = []
    for _ in range(waves):
        key, sub = jax.random.split(key)
        out.append(jax.random.uniform(sub, (4, side, side)))
    return out


def _drive_draws(key, side, waves):
    k0, k1 = jax.random.split(key)
    return [jax.random.uniform(k0, ())] + _wave_draws(k1, side, waves)


@pytest.mark.parametrize("p", [1.0, 0.7])
def test_topple_matches_jax(p):
    rng = np.random.default_rng(0)
    c = rng.integers(0, 6, (8, 8)).astype(np.int32)
    fired = rng.random((8, 8)) < 0.2
    key = jax.random.PRNGKey(3)
    jo = jsand.topple(jnp.asarray(c), jnp.asarray(fired), p, 4, key)
    to = tsand.topple(t(c), t(fired), p, 4,
                      replay(_wave_draws(key, 8, int(jo.waves))))
    np.testing.assert_array_equal(np.asarray(jo.c), to.c.numpy())
    assert int(jo.size) == int(to.size) > 0
    assert int(jo.waves) == int(to.waves)


def test_topple_wave_fn_seam():
    """The seam takes any counter wave: the plain one gives the same run."""
    c = torch.full((8, 8), 4, dtype=torch.int32)
    fired = torch.ones((8, 8), dtype=torch.bool)
    a = tsand.topple(c, fired, 1.0, 4, GeneratorDraws(0, "cpu"))
    b = tsand.topple(c, fired, 1.0, 4, GeneratorDraws(0, "cpu"),
                     wave_fn=cas_ref.cascade_wave_ref)
    assert torch.equal(a.c, b.c) and int(a.size) == int(b.size)
    assert int(a.c.max()) < 4          # relaxed below theta


@pytest.mark.parametrize("p", [1.0, 0.6])
def test_drive_matches_jax(p):
    c = np.full((6, 6), 3, np.int32)
    key = jax.random.PRNGKey(5)
    site = jnp.asarray([2, 3])
    jo = jsand.drive(jnp.asarray(c), site, p, 4, key)
    draws = _drive_draws(key, 6, int(jo.waves))
    to = tsand.drive(t(c), torch.tensor([2, 3]), p, 4, replay(draws))
    np.testing.assert_array_equal(np.asarray(jo.c), to.c.numpy())
    assert (int(jo.size), int(jo.waves)) == (int(to.size), int(to.waves))


def _chain_draws(key, side, steps, p, theta=4):
    """``run_chain``'s draws in the port's order, replaying JAX's chain step
    by step to learn each step's wave count."""
    out = []
    c = jnp.zeros((side, side), jnp.int32)
    drive = jax.jit(lambda c, site, k: jsand.drive(c, site, p, theta, k))
    for k in jax.random.split(key, steps):
        k0, k1 = jax.random.split(k)
        site = jax.random.randint(k0, (2,), 0, side)
        res = drive(c, site, k1)
        c = res.c
        out += [site] + _drive_draws(k1, side, int(res.waves))
    return out


@pytest.mark.parametrize("p", [1.0, 0.9])
def test_run_chain_matches_jax(p):
    side, steps = 6, 200
    key = jax.random.PRNGKey(1)
    sizes_j = np.asarray(jsand.run_chain(key, side=side, steps=steps, p=p))
    sizes_t = tsand.run_chain(replay(_chain_draws(key, side, steps, p)),
                              side, steps, p)
    np.testing.assert_array_equal(sizes_j, sizes_t.numpy())
    assert sizes_j.max() >= 3          # real avalanches ran


def _site_search(state, samples, draws, cfg):
    """Routing stage: the sample's value is the target unit."""
    gmu = samples[:, 0].to(torch.int32)
    zeros = torch.zeros_like(gmu)
    return SearchResult(gmu, torch.zeros(gmu.shape), zeros, zeros)


@pytest.mark.parametrize("engine", ["auto", "event"])
def test_engine_avalanche_sizes_match_sandpile_at_p1(engine):
    """At p = 1 (the BTW abelian regime) the engine's per-sample cascade
    sizes equal the sandpile chain's exactly, on the chain's own sites:
    the fast path's kernels and the message rounds alike."""
    side, steps = 12, 300
    keys = jax.random.split(jax.random.PRNGKey(0), steps)
    sites = np.asarray(jax.vmap(lambda k: jax.random.randint(
        jax.random.split(k)[0], (2,), 0, side))(keys))
    flat = (sites[:, 0] * side + sites[:, 1]).astype(np.float32)[:, None]
    ref_sizes = np.asarray(jsand.run_chain(jax.random.PRNGKey(0), side=side,
                                           steps=steps, p=1.0))
    kw = dict(side=side, dim=1, l_s=0.0, theta=4, i_max=steps)
    state = state_from_numpy(jafm.init(jax.random.PRNGKey(0), jax_cfg(**kw)),
                             "cpu")
    state = state._replace(c=torch.zeros_like(state.c))
    _, aux, rep = tev.run_events(
        state, t(flat), GeneratorDraws(1, "cpu"), torch_cfg(**kw),
        tev.EventConfig(engine=engine), search=_site_search,
        p_fn=lambda i, cfg: 1.0, l_c_fn=lambda i, cfg: 0.25)
    np.testing.assert_array_equal(aux.cascade_size.numpy(), ref_sizes)
    assert rep.dropped == 0 and ref_sizes.max() >= 5


def test_chain_from_a_generator_is_seeded():
    a = tsand.run_chain(GeneratorDraws(4, "cpu"), 8, 40, 0.9)
    b = tsand.run_chain(GeneratorDraws(4, "cpu"), 8, 40, 0.9)
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert tsand.run_chain(GeneratorDraws(4, "cpu"), 8, 0, 0.9).shape == (0,)
