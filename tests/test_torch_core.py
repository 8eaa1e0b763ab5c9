"""The port's core modules against the JAX package's, on the CPU.

Same numpy inputs through both; the port draws the numbers JAX's key chain
produced (``ReplayDraws``). Tiers:

- bitwise: the near table, lattice shifts, counters, fired fronts, cascade
  size and waves, GMU indices and greedy step counts away from ties;
- ULP-bounded: f32 schedules, ``w`` and ``q2`` from identical inputs;
- statistical: far-link tables (the port draws its own), held to their
  distribution P(j -> k) ∝ 1 / D_jk.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.core import cascade as jcas
from repro.core import links as jlinks
from repro.core import schedules as jsched
from repro.core import search as jsearch
from repro_torch.core import cascade as tcas
from repro_torch.core import links as tlinks
from repro_torch.core import schedules as tsched
from repro_torch.core import search as tsearch
from repro_torch.draws import GeneratorDraws, ReplayDraws
from repro_torch.kernels.cascade import ops as cas_ops
from torch_parity import (F32_EPS, assert_bmu_tier, cascade_draws, replay,
                          search_draws, t)


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("i", [0, 1, 17, 500, 3599, 3600])
def test_schedules_match_jax_within_ulps(i):
    """f32 transcendental functions may round differently: 4 ULP."""
    pairs = [
        (jsched.cascade_learning_rate(i, 3600, 0.5, 0.5),
         tsched.cascade_learning_rate(i, 3600, 0.5, 0.5)),
        (jsched.cascade_probability(i, 3600, 36, 0.1, 100.0),
         tsched.cascade_probability(i, 3600, 36, 0.1, 100.0)),
        (jsched.som_sigma(i, 3600, 4.0), tsched.som_sigma(i, 3600, 4.0)),
        (jsched.som_lr(i, 3600, 0.5), tsched.som_lr(i, 3600, 0.5)),
    ]
    for j, tt in pairs:
        assert tt.dtype == torch.float32 and tt.shape == ()
        np.testing.assert_allclose(float(tt), float(j), rtol=4 * F32_EPS,
                                   atol=0)


def test_schedule_endpoints_exact():
    assert float(tsched.cascade_probability(0, 100, 900, 0.1, 100.0)) == \
        float(jsched.cascade_probability(0, 100, 900, 0.1, 100.0))
    assert float(tsched.cascade_probability(100, 100, 900, 0.1, 100.0)) >= 0


# -------------------------------------------------------------------- links

@pytest.mark.parametrize("side", [1, 2, 5, 8])
def test_near_table_coords_and_manhattan_bitwise(side):
    np.testing.assert_array_equal(tlinks.near_neighbor_table(side).numpy(),
                                  np.asarray(jlinks.near_neighbor_table(side)))
    np.testing.assert_array_equal(tlinks.unit_coords(side).numpy(),
                                  np.asarray(jlinks.unit_coords(side)))
    assert tlinks.near_neighbor_table(side).dtype == torch.int32
    for j in range(side * side):
        np.testing.assert_array_equal(
            tlinks.manhattan_row(side, torch.tensor(j)).numpy(),
            np.asarray(jlinks.manhattan_row(side, jnp.int32(j))))


def _distance_histogram(table, side):
    n, phi = table.shape
    src = torch.arange(n)[:, None].expand(n, phi)
    d = (torch.abs(src // side - table // side)
         + torch.abs(src % side - table % side))
    return np.bincount(d.flatten().numpy(), minlength=2 * side - 1)


def _expected_histogram(side, total):
    """P(j -> k) ∝ 1/D_jk: the share of links at each distance d."""
    d = tlinks.manhattan_row(side, torch.arange(side * side)).numpy()
    w = np.where(d > 0, 1.0 / np.maximum(d, 1), 0.0)
    w = w / w.sum(axis=1, keepdims=True)
    per_d = np.array([(w * (d == k)).sum() for k in range(2 * side - 1)])
    return total * per_d / side ** 2


@pytest.mark.parametrize("sampler", ["categorical", "ring"])
def test_far_links_distribution(sampler):
    """Range, no self-links, and the 1/D law (both samplers are exact; the
    counts per distance sit within 5 standard deviations of expectation)."""
    side, phi = 6, 400
    draws = GeneratorDraws(seed=3, device="cpu")
    table = (tlinks.far_links_categorical(draws, side, phi)
             if sampler == "categorical"
             else tlinks.far_links_ring(draws, side, phi))
    n = side * side
    assert table.shape == (n, phi) and table.dtype == torch.int32
    assert int(table.min()) >= 0 and int(table.max()) < n
    assert not (table == torch.arange(n)[:, None]).any()
    got = _distance_histogram(table.long(), side)
    want = _expected_histogram(side, n * phi)
    assert got[0] == 0
    sd = np.sqrt(want[1:] * (1 - want[1:] / (n * phi)))
    assert np.all(np.abs(got[1:] - want[1:]) <= 5 * sd + 1), (got, want)


def test_far_links_dispatch():
    draws = GeneratorDraws(seed=0, device="cpu")
    assert tlinks.far_links(draws, 4, 3).shape == (16, 3)
    ring = tlinks.far_links(draws, 4, 3, exact_threshold=8)
    assert ring.shape == (16, 3) and not (ring == torch.arange(16)[:, None]).any()


# ------------------------------------------------------------------- search

def _map_and_samples(n, d, b, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32))


@pytest.mark.parametrize("n,b,d,chunk", [(36, 9, 12, None), (49, 7, 8, 16),
                                         (64, 20, 36, 21), (33, 4, 10, 2)])
def test_exact_bmu_matches_jax(n, b, d, chunk):
    w, s = _map_and_samples(n, d, b, seed=n + b)
    ij, qj = jsearch.exact_bmu(jnp.asarray(w), jnp.asarray(s), unit_chunk=chunk)
    it, qt = tsearch.exact_bmu(t(w), t(s), unit_chunk=chunk)
    assert it.dtype == torch.int32
    assert_bmu_tier(it, qt, ij, qj, w, s)


def test_second_bmu_matches_jax_with_ties():
    """``jax.lax.top_k`` lists tied units lower index first; so must the
    port (bitwise indices, planted duplicate units included)."""
    w, s = _map_and_samples(25, 6, 40, seed=4)
    w[7] = w[3]
    w[20] = w[11]
    s[:5] = w[3]
    s[5:10] = w[11] + np.float32(1e-3)
    j1, j2 = jsearch.second_bmu(jnp.asarray(w), jnp.asarray(s))
    t1, t2 = tsearch.second_bmu(t(w), t(s))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))
    assert set(t2.numpy()[:5]) == {7} and set(t2.numpy()[5:10]) == {20}


@pytest.mark.parametrize("side,d,b,e,use_far", [(5, 8, 1, 12, True),
                                                (6, 12, 4, 30, True),
                                                (7, 10, 6, 20, False)])
def test_relay_race_matches_jax(side, d, b, e, use_far):
    """Carried link tables + replayed draws: the race is the same walk, so
    GMUs, explored and greedy step counts are bitwise; q2 is ULP-bounded."""
    n = side * side
    w, s = _map_and_samples(n, d, b, seed=side * 7 + b)
    near = jlinks.near_neighbor_table(side)
    far = jlinks.far_links(jax.random.PRNGKey(side), side, 4)
    key = jax.random.PRNGKey(99 + b)
    jres = jax.jit(lambda w, s, k: jsearch.heuristic_search(
        w, near, far, s, k, e, greedy_use_far=use_far))(
            jnp.asarray(w), jnp.asarray(s), key)
    draws = replay(search_draws(key, n, 4, b, e))
    tres = tsearch.heuristic_search(t(w), t(near), t(far), t(s), draws, e,
                                    greedy_use_far=use_far)
    assert len(draws) == 0
    for field in ("gmu", "greedy_steps", "explored"):
        got = getattr(tres, field)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jres, field)))
    np.testing.assert_allclose(tres.q2.numpy(), np.asarray(jres.q2),
                               rtol=8 * d * F32_EPS)


def test_greedy_phase_max_steps_caps_descent():
    side = 6
    w, s = _map_and_samples(side * side, 5, 3, seed=1)
    near = tlinks.near_neighbor_table(side)
    far = torch.zeros((side * side, 0), dtype=torch.int32)
    start = torch.zeros(3, dtype=torch.long)
    q0 = ((t(w)[start] - t(s)) ** 2).sum(-1)
    _, _, steps = tsearch.greedy_phase(t(w), near, far, t(s), start, q0,
                                       use_far=False, max_steps=1)
    assert int(steps.max()) <= 1


# ------------------------------------------------------------------ cascade

@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_shift_helpers_match_jax_bitwise(dtype):
    """Slot order below, above, right, left, and the ((up + dn) + lf) + rt
    sum order: f32 values spread over eight decades make any other order
    round differently."""
    rng = np.random.default_rng(0)
    if dtype == np.int32:
        x = rng.integers(-5, 9, (5, 5, 3)).astype(dtype)
    else:
        x = (rng.standard_normal((5, 5, 3))
             * 10.0 ** rng.uniform(-4, 4, (5, 5, 3))).astype(dtype)
    for jf, tf in ((jcas._shift_sum, tcas._shift_sum),
                   (jcas._shift4, tcas._shift4)):
        np.testing.assert_array_equal(tf(t(x)).numpy(), np.asarray(jf(x)))
        np.testing.assert_array_equal(tf(t(x[..., 0])).numpy(),
                                      np.asarray(jf(x[..., 0])))


CASCADE_CASES = [(6, 8, 0.9, 4, None), (8, 12, 1.0, 4, None), (5, 4, 0.6, 3, 3)]


@functools.lru_cache(maxsize=None)
def _jax_cascade(side, d, p, theta, max_waves):
    """Inputs and JAX's drive + cascade (shared by both wave_fn variants)."""
    rng = np.random.default_rng(side + theta)
    w = rng.standard_normal((side, side, d)).astype(np.float32)
    c = rng.integers(0, theta, (side, side)).astype(np.int32)
    mask = rng.integers(0, 3, (side, side)).astype(np.int32)
    key = jax.random.PRNGKey(side)
    jres = jax.jit(lambda w, c, m, k: jcas.drive_and_cascade(
        w, c, m, l_c=np.float32(0.3), p=np.float32(p), theta=theta, key=k,
        max_waves=max_waves))(w, c, mask, key)
    draws = cascade_draws(key, side, int(jres.waves))
    return (w, c, mask), jax.tree.map(np.asarray, jres), draws


@pytest.mark.parametrize("use_kernel_wrapper", [False, True])
@pytest.mark.parametrize("side,d,p,theta,max_waves", CASCADE_CASES)
def test_drive_and_cascade_matches_jax(side, d, p, theta, max_waves,
                                       use_kernel_wrapper):
    """Counters, size and waves bitwise; weights ULP-bounded per wave."""
    (w, c, mask), jres, jdraws = _jax_cascade(side, d, p, theta, max_waves)
    waves = int(jres.waves)
    draws = replay(jdraws)
    tres = tcas.drive_and_cascade(
        t(w), t(c), t(mask), l_c=float(np.float32(0.3)),
        p=float(np.float32(p)), theta=theta, draws=draws, max_waves=max_waves,
        wave_fn=cas_ops.cascade_wave if use_kernel_wrapper else None)
    assert len(draws) == 0 and waves > 0
    np.testing.assert_array_equal(tres.c.numpy(), jres.c)
    assert (tres.size, tres.waves) == (int(jres.size), waves)
    bound = 4 * F32_EPS * (1 + waves) * np.abs(jres.w).max()
    assert np.abs(tres.w.numpy() - jres.w).max() <= bound


def test_cascade_with_no_front_draws_nothing():
    side = 4
    w = torch.zeros(side, side, 2)
    c = torch.zeros(side, side, dtype=torch.int32)
    res = tcas.cascade(w, c, torch.zeros(side, side, dtype=torch.bool),
                       l_c=0.5, p=1.0, theta=4, draws=ReplayDraws([]))
    assert (res.size, res.waves) == (0, 0)


def test_abelian_counters_match_sequential():
    """p = 1, theta = 4: the parallel waves reach the paper's recursive
    fixed point (counters and size), as in ``tests/test_cascade.py``."""
    side = 7
    rng = np.random.default_rng(0)
    c = rng.integers(0, 4, (side, side)).astype(np.int32)
    c[3, 3] = 4
    w = rng.standard_normal((side, side, 3)).astype(np.float32)
    res = tcas.cascade(t(w), t(c), t(c >= 4), l_c=0.1, p=1.0, theta=4,
                       draws=GeneratorDraws(0, device="cpu"))
    _, c_ref, size_ref = tcas.sequential_cascade_reference(
        w, c, [(3, 3)], l_c=0.1, p=1.0, theta=4, seed=0)
    np.testing.assert_array_equal(res.c.numpy(), c_ref)
    assert res.size == size_ref
