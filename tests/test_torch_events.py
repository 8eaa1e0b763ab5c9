"""The port's discrete-event engine (``repro_torch.core.events``) against the
JAX package's, on the CPU.

Both run on the same numpy data and the same JAX initial state; the port
takes JAX's own draws, replayed (``torch_parity.event_draws``: per event the
search's draws, then the cascade's child: drive, a 16-wave block, tail
waves), and at exponential latency JAX's own delays
(``torch_parity.recorded_exponentials``). Tolerances:

- integer state and accounting bitwise: counters, GMUs, cascade sizes,
  wave counts, greedy steps, per-unit event counts, the free ring, and
  every count of the ``EventReport``;
- the float32 times bitwise (clocks, ``t_end``): both packages compute
  them with the same float32 operations;
- weights within ``W_ULPS`` ulps of the map's largest weight: XLA contracts
  an update's multiply-add into an FMA where torch rounds twice, a
  difference of an ulp or so an update, which these short runs (<= 64
  events) keep below the bound without moving any GMU; q2 within the BMU
  tie bound (``torch_parity.assert_bmu_tier``'s).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.core import afm as jafm
from repro.core import events as jev
from repro.core import search as jsearch_lib
from repro.core.placement import single as jsingle
from repro_torch.convert import state_from_numpy
from repro_torch.core import afm as tafm
from repro_torch.core import events as tev
from repro_torch.core.placement import single as tsingle
from repro_torch.draws import GeneratorDraws, ReplayDraws
from torch_parity import (F32_EPS, assert_same_run, cascade_draws,
                          event_draws, jax_cfg, recorded_exponentials, replay,
                          search_draws, t, torch_cfg)

CAP = tev.WAVE_CAP
#: weights: ulps of max |w| (see the module docstring)
W_ULPS = 8
HOT = dict(side=6, dim=12, theta=3, i_max=96, e_factor=0.5)
TEN = dict(side=10, dim=16, i_max=100, e_factor=0.3)


def _p_hot_j(i, cfg):
    del i, cfg
    return jnp.float32(0.8)


def _p_hot_t(i, cfg):
    del i, cfg
    return float(np.float32(0.8))


def _data(dim, n=256, seed=0):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(
        np.float32)


def _setup(kw, seed=0):
    jcfg, tcfg = jax_cfg(**kw), torch_cfg(**kw)
    data = _data(kw["dim"], seed=seed)
    key = jax.random.PRNGKey(100 + seed)
    k_init, k_steps, k_lat = jax.random.split(key, 3)
    state = jafm.init(k_init, jcfg, data)
    return jcfg, tcfg, data, state, k_steps, k_lat


_SEARCH = {"exact": (jafm.search_exact, tev.search_exact),
           "heuristic": (jafm.search_heuristic, tafm.search_heuristic)}


def _run_both(kw, ekw, num_events, *, search="exact", hot=True, seed=0,
              state_fn=None):
    """One JAX run and the port's on its replayed draws."""
    jcfg, tcfg, data, state, k_steps, k_lat = _setup(kw, seed)
    if state_fn is not None:
        state = state_fn(state)
    keys = jax.random.split(k_steps, num_events)
    jsearch, tsearch = _SEARCH[search]
    jkw = dict(ekw)
    if jkw.get("kernel") == "fused":
        jkw["kernel"] = "fused-interpret"      # the megakernel, interpreted
    pj = dict(p_fn=_p_hot_j) if hot else {}
    pt = dict(p_fn=_p_hot_t) if hot else {}
    lat = None
    if ekw.get("latency") == "exponential":
        with recorded_exponentials() as rec:
            jout = jev.run_events(state, data[:num_events], keys, jcfg,
                                  jev.EventConfig(**jkw), search=jsearch,
                                  lat_key=k_lat, **pj)
            jax.block_until_ready(jout[0].w)
        lat = replay(rec)
    else:
        jout = jev.run_events(state, data[:num_events], keys, jcfg,
                              jev.EventConfig(**jkw), search=jsearch,
                              lat_key=k_lat, **pj)
    draws = replay(event_draws(keys, jcfg, jout[1].waves,
                               heuristic=search == "heuristic",
                               wave_cap=CAP))
    tout = tev.run_events(state_from_numpy(state, "cpu"),
                          t(data[:num_events]), draws, tcfg,
                          tev.EventConfig(**ekw), search=tsearch,
                          lat_draws=lat, **pt)
    return jout, tout, state, data


def _assert_same(jout, tout, state, data):
    assert_same_run(jout, tout, np.asarray(state.w), data, W_ULPS)


# ---------------------------------------------------------- round selection


def _random_pool(rng, m, e, big=False):
    t_ = rng.integers(0, 4, m).astype(np.float32) * np.float32(0.5)
    t_[rng.random(m) < 0.3] = np.inf                        # free slots
    hi = 2 ** 31 - 3 if big else 6
    gen = rng.integers(hi - 6 if big else 0, hi, m).astype(np.int32)
    cid = rng.integers(0, e, m).astype(np.int32)
    if big:
        cid = (2 ** 31 - 1 - rng.integers(0, 3, m)).astype(np.int32)
    return t_, gen, cid


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("big", [False, True], ids=["small", "near_imax"])
def test_pool_min_lex_matches_jax(seed, big):
    """Random pools with time ties, +inf slots, and gen/cid near int32 max:
    the same (tmin, gmin, cmin, sel, have), bitwise."""
    rng = np.random.default_rng(seed)
    t_, gen, cid = _random_pool(rng, 64, 9, big)
    jo = jsingle.pool_min_lex(jnp.asarray(t_), jnp.asarray(gen),
                              jnp.asarray(cid))
    to = tsingle.pool_min_lex(t(t_), t(gen), t(cid))
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("seed", range(4))
def test_pool_min_packed_matches_jax(seed):
    """The packed lane (uint32 in JAX, int64 in the port) picks the same
    round, free slots carrying the all-ones key."""
    rng = np.random.default_rng(seed)
    e = 9
    t_, gen, cid = _random_pool(rng, 64, e)
    key = (gen.astype(np.uint64) * e + cid).astype(np.uint32)
    key[np.isinf(t_)] = 0xFFFFFFFF
    jo = jsingle.pool_min_packed(jnp.asarray(t_), jnp.asarray(key), e)
    to = tsingle.pool_min_packed(t(t_), t(key.astype(np.int64)), e)
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_pool_min_lex_survives_generations_near_int32_max():
    """JAX's regression case for the old ``2**30`` sentinel, on the port."""
    inf, imax = np.inf, 2 ** 31 - 1
    tmin, gmin, cmin, sel, have = tsingle.pool_min_lex(
        t(np.array([1.0, 1.0, inf, 1.0, 2.0], np.float32)),
        t(np.array([2 ** 30 + 5, 2 ** 30 + 3, 0, 2 ** 30 + 3, 1], np.int32)),
        t(np.array([7, 9, 0, 3, 0], np.int32)))
    assert bool(have) and float(tmin) == 1.0
    assert int(gmin) == 2 ** 30 + 3 and int(cmin) == 3
    assert sel.tolist() == [False, False, False, True, False]
    _, gmin2, cmin2, sel2, have2 = tsingle.pool_min_lex(
        t(np.array([3.0, 3.0], np.float32)),
        t(np.array([imax, imax], np.int32)), t(np.array([5, 2], np.int32)))
    assert bool(have2) and int(gmin2) == imax and int(cmin2) == 2
    assert sel2.tolist() == [False, True]
    assert not bool(tsingle.pool_min_lex(
        torch.full((3,), inf), torch.zeros(3, dtype=torch.int32),
        torch.zeros(3, dtype=torch.int32))[-1])


def test_key_scale_switches_to_the_lexicographic_min():
    for e, waves in ((48, 288), (48, 2 ** 27), (0, 5), (2 ** 16, 2 ** 16 - 2),
                     (2 ** 16, 2 ** 16 - 1)):
        assert tsingle.key_scale(e, waves) == jsingle.key_scale(e, waves)
    assert tsingle.key_scale(48, 2 ** 27) is None


def test_packed_key_and_lex_fallback_agree_with_jax():
    """A huge ``max_waves`` overflows the packed lane and selects the
    lexicographic min; both runs match JAX's."""
    for max_waves in (288, 2 ** 27):
        kw = dict(HOT, max_waves=max_waves)
        _assert_same(*_run_both(kw, dict(latency="constant", delay=0.5), 48))


# --------------------------------------------------------------- one round


def _port_state(jes, cfg, children, lat=None):
    """The port's ``EventState`` from a JAX one, with the given per-cascade
    child sources."""
    a = np.asarray
    m, e = a(jes.msg_t).shape[0], a(jes.gmu).shape[0]
    active = np.isfinite(a(jes.msg_t))
    inflight = np.bincount(a(jes.msg_key)[active].astype(np.int64) % e,
                           minlength=e)
    return tev.EventState(
        w=t(jes.w), c=t(jes.c), i=int(jes.i), clock=t(jes.clock),
        nevents=t(jes.nevents), msg_t=t(jes.msg_t),
        msg_key=torch.from_numpy(a(jes.msg_key).astype(np.int64)),
        msg_gen=t(jes.msg_gen), msg_cid=t(jes.msg_cid),
        msg_dst=t(jes.msg_dst).long(), msg_dir=t(jes.msg_dir).long(),
        msg_w=t(jes.msg_w), free_ring=t(jes.free_ring).long(),
        free_head=int(jes.free_head), free_n=int(jes.free_n),
        casc=children, blocks={}, inflight=inflight,
        wcount=a(jes.wcount).copy(), sizes=a(jes.sizes).copy(),
        gmu=t(jes.gmu), q2=t(jes.q2), greedy=t(jes.greedy), ev=int(jes.ev),
        t=np.float32(jes.t), rounds=int(jes.rounds),
        deliveries=int(jes.deliveries), dropped=int(jes.dropped),
        sent=int(jes.sent), lat=lat)


def _assert_state(jes, es):
    a = np.asarray
    for f in ("c", "clock", "nevents", "msg_t", "msg_gen", "msg_cid",
              "msg_dst", "msg_dir", "free_ring", "gmu", "greedy"):
        np.testing.assert_array_equal(a(getattr(jes, f)),
                                      getattr(es, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(a(jes.msg_key).astype(np.int64),
                                  es.msg_key.numpy())
    np.testing.assert_array_equal(a(jes.wcount), es.wcount)
    np.testing.assert_array_equal(a(jes.sizes), es.sizes)
    for f in ("i", "free_head", "free_n", "ev", "rounds", "deliveries",
              "dropped", "sent"):
        assert int(getattr(jes, f)) == getattr(es, f), f
    assert np.float32(jes.t) == es.t
    for f in ("w", "msg_w", "q2"):
        x, y = a(getattr(jes, f)), getattr(es, f).numpy()
        assert np.abs(x - y).max() <= W_ULPS * F32_EPS * max(
            np.abs(x).max(), 1.0), f


@pytest.mark.parametrize("search", ["exact", "heuristic"])
def test_sample_round_and_delivery_round_match_jax(search):
    """One sample round, then one delivery round, from identical states:
    the state after each, field for field."""
    e = 4
    jcfg, tcfg, data, state, k_steps, k_lat = _setup(HOT)
    # counters one below theta: the sample's GMU fires, and so do receivers
    state = state._replace(c=jnp.full_like(state.c, jcfg.theta - 1))
    ecfg = dict(latency="constant", delay=1.0)
    jsearch, tsearch = _SEARCH[search]
    # p = 1: the drive and every receipt count, so both rounds fire
    jfns = jev._make_round_fns(jcfg, jev.EventConfig(**ecfg), e, jsearch,
                               lambda i, cfg: jnp.float32(1.0),
                               jev._default_l_c, i0=state.i, far=state.far,
                               near=state.near)
    tstate = state_from_numpy(state, "cpu")
    tfns = tev._make_round_fns(tcfg, tev.EventConfig(**ecfg), e, tsearch,
                               lambda i, cfg: 1.0, tev._default_l_c,
                               i0=tstate.i, far=tstate.far, near=tstate.near)
    jes0 = jev.init_events(state, jcfg, jev.EventConfig(**ecfg), e, k_lat)
    key = jax.random.split(k_steps, e)[0]
    jes1 = jfns[0](jes0, jnp.asarray(data[0]), key)
    k_search, k_cascade = jax.random.split(key)
    draws = (search_draws(k_search, jcfg.n_units, jcfg.phi, 1, jcfg.e)
             if search == "heuristic" else [])
    draws.append(cascade_draws(k_cascade, jcfg.side, 0))
    es = _port_state(jes0, jcfg, [None] * e)
    tfns[0](es, t(data[0]), replay(draws))
    _assert_state(jes1, es)
    assert int(jes1.free_n) < int(jes1.msg_t.shape[0])   # it fired

    tmin, gmin, cmin, sel, have = jfns[2](jes1)
    jes2 = jfns[1](jes1, tmin, gmin, cmin, sel)
    # the cascade's child after its drive: the block from its chain key
    chain, block = jes1.casc_key[0], []
    for _ in range(CAP):
        chain, sub = jax.random.split(chain)
        block.append(np.asarray(jax.random.uniform(
            sub, (4, jcfg.side, jcfg.side))))
    child = ReplayDraws([np.stack(block)])
    es = _port_state(jes1, jcfg, [child] + [None] * (e - 1))
    key_t = tfns[3](es)
    to = tfns[2](es)
    for x, y in zip((tmin, gmin, cmin, sel, have), to):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    assert key_t[4] == int(np.sum(sel)) and key_t[5] == bool(have)
    tfns[1](es, *key_t[:5])
    _assert_state(jes2, es)
    # the GMU's broadcasts all delivered, and their receivers fired
    assert int(jes2.deliveries) == int(jes1.sent) < int(jes2.sent)


# ------------------------------------------------------------- whole runs


@pytest.mark.parametrize("search", ["exact", "heuristic"])
@pytest.mark.parametrize("variant", ["staged", "fused", "event"])
def test_zero_latency_runners_match_jax(variant, search):
    """The fast path (staged: search, merge, ``drive_cascade``; fused: the
    fused step with ``recv0``) and the forced engine, each against JAX's
    same runner (its fused one in interpret mode)."""
    ekw = {"staged": {}, "fused": dict(kernel="fused"),
           "event": dict(engine="event")}[variant]
    _assert_same(*_run_both(HOT, ekw, 64, search=search))


def test_zero_latency_default_schedule_matches_jax():
    """The default schedules (no hot p) on a 10x10 map, fast path."""
    _assert_same(*_run_both(TEN, {}, 60, hot=False, search="heuristic"))


@pytest.mark.parametrize("runner", ["engine", "budget"])
@pytest.mark.parametrize("delay,spacing", [(1.0, 1.0), (2.5, 1.0),
                                           (1.0, 0.7), (2.5, 0.7)])
def test_constant_latency_matches_jax(runner, delay, spacing):
    """Overlapping cascades at constant latency, round for round: the
    sample-scan engine and the budgeted loop (a budget it never reaches),
    with float32 times that a non-dyadic spacing makes inexact."""
    ekw = dict(latency="constant", delay=delay, sample_spacing=spacing)
    if runner == "budget":
        ekw["max_rounds"] = 10 ** 6
    _assert_same(*_run_both(HOT, ekw, 64))


@pytest.mark.parametrize("max_rounds", [5, 23, 60])
def test_budgeted_truncation_accounting_matches_jax(max_rounds):
    """A budget that cuts the run: rounds, consumed samples, stranded
    messages counted as dropped, all as JAX's."""
    ekw = dict(latency="constant", delay=2.5, max_rounds=max_rounds)
    out = _run_both(HOT, ekw, 64)
    _assert_same(*out)
    assert out[1][2].rounds == max_rounds and out[1][2].samples < 64


@pytest.mark.parametrize("search", ["exact", "heuristic"])
def test_exponential_latency_matches_jax_on_its_delays(search):
    """Exponential latency with JAX's own delays replayed (``delay`` 2.0:
    a power of two keeps ``exp * delay`` exact, so JAX's fused multiply-add
    into the time rounds as the port's two operations do)."""
    _assert_same(*_run_both(HOT, dict(latency="exponential", delay=2.0), 64,
                            search=search))


def test_undersized_pool_drops_match_jax():
    """A 4-slot pool overflows: which messages drop, and their count."""
    jout, tout, state, data = _run_both(
        HOT, dict(latency="constant", delay=2.5, capacity=4), 64)
    _assert_same(jout, tout, state, data)
    assert tout[2].dropped_overflow > 0
    r = tout[2]
    assert r.sent == r.deliveries + r.dropped_overflow + r.stranded


def test_empty_run():
    cfg = torch_cfg(**HOT)
    state = tafm.init(GeneratorDraws(0, "cpu"), cfg)
    st, aux, rep = tev.run_events(state, torch.zeros((0, cfg.dim)),
                                  GeneratorDraws(0, "cpu"), cfg)
    assert st is state and aux.cascade_size.shape == (0,)
    assert aux.gmu.shape == (0, 1) and aux.gmu.dtype == torch.int32
    assert rep.rounds == 0 and rep.clock.shape == (cfg.n_units,)


def test_bad_options():
    with pytest.raises(ValueError, match="delay"):
        tev.EventConfig(latency="constant", delay=-1.0)
    with pytest.raises(ValueError, match="no delay"):
        tev.EventConfig(latency="zero", delay=0.5)
    with pytest.raises(ValueError, match="engine"):
        tev.EventConfig(engine="warp")
    with pytest.raises(ValueError, match="latency"):
        tev.EventConfig(latency="warp")
    with pytest.raises(ValueError, match="sample_spacing"):
        tev.EventConfig(sample_spacing=0.0)
    with pytest.raises(ValueError, match="faults must be"):
        tev.EventConfig(faults={"p_loss": 0.1})


def test_fused_kernel_only_in_the_fast_regime():
    """kernel='fused' is refused outside the zero-latency fast path, and an
    undersized pool fails when the runner is built."""
    for bad in (dict(latency="constant", delay=1.0), dict(engine="event"),
                dict(max_rounds=100)):
        with pytest.raises(ValueError, match="fast-path"):
            tev.EventConfig(kernel="fused", **bad)
    with pytest.raises(ValueError, match="kernel must be one of"):
        tev.EventConfig(kernel="fused-interpret")
    cfg = torch_cfg(**HOT)
    with pytest.raises(ValueError, match="capacity"):
        tsingle.SinglePool().build_runner(
            cfg, tev.EventConfig(kernel="fused", capacity=cfg.n_units), 16,
            tev.search_exact, tev._default_p, tev._default_l_c)
    ok = tev._zero_fast_ok
    assert ok(cfg, tev.EventConfig(), 16)
    assert not ok(cfg, tev.EventConfig(engine="event"), 16)
    assert not ok(cfg, tev.EventConfig(max_rounds=100), 16)
    assert not ok(cfg, tev.EventConfig(capacity=cfg.n_units), 16)


def _site_search(state, samples, draws, cfg):
    """Routing stage for tests: the sample's value is the target unit."""
    gmu = samples[:, 0].to(torch.int32)
    zeros = torch.zeros_like(gmu)
    from repro_torch.core.search import SearchResult
    return SearchResult(gmu, torch.zeros(gmu.shape), zeros, zeros)


def test_quiescence_watchdog_raises_like_jax():
    """Exponential latency delivers each message in a round of its own; with
    one wave allowed, every sample firing 4 messages needs more rounds than
    the E * (max_waves + 2) + 1 safety cap. Both packages raise rather than
    return a truncated run."""
    kw = dict(side=5, dim=1, theta=1, i_max=16, max_waves=1)
    e = 16
    target = np.full((e, 1), 12.0, np.float32)
    ecfg = dict(latency="exponential", delay=1.0)

    def jsite(state, samples, key, cfg):
        gmu = samples[:, 0].astype(jnp.int32)
        z = jnp.zeros_like(gmu)
        return jsearch_lib.SearchResult(gmu, jnp.zeros(gmu.shape,
                                                       jnp.float32), z, z)

    jcfg = jax_cfg(**kw)
    state = jafm.init(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(RuntimeError, match="round budget exhausted"):
        jev.run_events(state, jnp.asarray(target),
                       jax.random.split(jax.random.PRNGKey(1), e), jcfg,
                       jev.EventConfig(**ecfg), search=jsite,
                       p_fn=_p_hot_j)
    tcfg = torch_cfg(**kw)
    with pytest.raises(RuntimeError, match="round budget exhausted"):
        tev.run_events(state_from_numpy(state, "cpu"), t(target),
                       GeneratorDraws(1, "cpu"), tcfg,
                       tev.EventConfig(**ecfg), search=_site_search,
                       p_fn=_p_hot_t)


def test_active_fault_plan_is_not_ported():
    """The stragglers need the mesh placement: the single pool refuses
    them, and a mesh run asks for its ranks (``test_torch_mesh.py`` runs
    them on gloo ranks); loss and dropout run in the engine, with every
    message accounted for."""
    from repro_torch.faults import FaultPlan
    assert not tev.EventConfig(faults=FaultPlan(seed=9)).fault_active
    cfg = torch_cfg(**HOT)
    state = tafm.init(GeneratorDraws(0, "cpu"), cfg)
    data = t(_data(HOT["dim"]))[:64]
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tev.run_events(state, torch.zeros((2, cfg.dim)),
                       GeneratorDraws(0, "cpu"), cfg, placement="mesh",
                       shards=2)
    with pytest.raises(ValueError, match="placement='mesh'"):
        tev.run_events(state, data, GeneratorDraws(0, "cpu"), cfg,
                       tev.EventConfig(faults=FaultPlan(
                           shard_latency_mult=(1.0, 2.0))))
    plan = FaultPlan(seed=9, p_loss=0.5, dropout_frac=0.25, dropout_len=8)
    _, _, rep = tev.run_events(state, data, GeneratorDraws(0, "cpu"), cfg,
                               tev.EventConfig(faults=plan), p_fn=_p_hot_t)
    assert rep.dropped_fault > 0
    assert rep.sent == (rep.deliveries + rep.dropped_overflow
                        + rep.dropped_fault + rep.stranded)


@pytest.mark.parametrize("search", ["exact", "heuristic"])
def test_zero_latency_runners_agree_from_one_generator_seed(search):
    """The staged and fused fast paths and the engine consume each
    cascade's child identically: from one ``GeneratorDraws`` seed they
    train the same map, integers and report bitwise, weights bitwise on
    the CPU (the plain versions share their arithmetic)."""
    cfg = torch_cfg(**HOT)
    data = t(_data(HOT["dim"], seed=1))
    state = tafm.init(GeneratorDraws(2, "cpu"), cfg, data)
    tsearch = _SEARCH[search][1]
    outs = [tev.run_events(state, data[:64], GeneratorDraws(7, "cpu"), cfg,
                           tev.EventConfig(**ekw), search=tsearch,
                           p_fn=_p_hot_t)
            for ekw in ({}, dict(kernel="fused"), dict(engine="event"))]
    (s0, a0, r0) = outs[0]
    assert int(a0.cascade_size.sum()) > 0
    for s, a, r in outs[1:]:
        assert torch.equal(s.w, s0.w) and torch.equal(s.c, s0.c)
        for x, y in zip(a, a0):
            assert torch.equal(x, y)
        for f in r._fields:
            x, y = getattr(r, f), getattr(r0, f)
            assert (torch.equal(x, y) if torch.is_tensor(x) else x == y), f


def test_delivery_round_sums_repeated_directions_in_slot_order():
    """Exact time ties (possible at exponential latency) can put two
    messages on one (receiver, direction) in one round: their payloads are
    summed direction slot by direction slot and, within one, in slot order,
    as JAX's scatter-add applies them; the receiver counts both."""
    cfg = torch_cfg(side=4, dim=3, theta=9, i_max=16)
    ecfg = tev.EventConfig(latency="exponential", delay=1.0)
    state = tafm.init(GeneratorDraws(0, "cpu"), cfg)
    es = tev.init_events(state, cfg, ecfg, 2, GeneratorDraws(1, "cpu"))
    fns = tev._make_round_fns(cfg, ecfg, 2, tev.search_exact,
                              lambda i, c: 1.0, lambda i, c: 0.25, i0=0,
                              far=state.far, near=state.near)
    rng = np.random.default_rng(0)
    # slots 5, 2, 9: receiver 6 from below twice (slots 2 then 5) and from
    # the left once; all of cascade 1, generation 3, time 1.5
    payload = {5: rng.standard_normal(3), 2: rng.standard_normal(3),
               9: rng.standard_normal(3)}
    for slot, (dst, d) in {5: (6, 0), 2: (6, 0), 9: (6, 3)}.items():
        es.msg_t[slot] = 1.5
        es.msg_key[slot] = 3 * 2 + 1
        es.msg_dst[slot], es.msg_dir[slot] = dst, d
        es.msg_w[slot] = torch.tensor(payload[slot], dtype=torch.float32)
    es.free_n -= 3
    es.free_ring[:] = torch.tensor([s for s in range(es.msg_t.shape[0])
                                    if s not in (2, 5, 9)] + [2, 5, 9])
    es.inflight[1] = 3
    es.casc[1] = ReplayDraws([np.zeros((CAP, 4, 4, 4), np.float32)])
    w0 = es.w.clone()
    fns[1](es, *fns[3](es)[:5])
    f32 = torch.float32
    acc = torch.zeros(3, dtype=f32)
    for slot in (2, 5, 9):                  # below (2, 5), then left (9)
        acc = acc + torch.tensor(payload[slot], dtype=f32)
    row = w0[6]
    assert torch.equal(es.w[6], row + 0.25 * (acc - 3.0 * row))
    assert int(es.nevents[6]) == 3 and es.deliveries == 3
    assert int(es.c[6]) == 3                # p = 1: driven once a message
    others = torch.ones(16, dtype=torch.bool)
    others[6] = False
    assert torch.equal(es.w[others], w0[others])
