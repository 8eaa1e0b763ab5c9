"""The port's ``async`` backend (``repro_torch.training.async_trainer``) and
its draw sources' per-cascade children, against the JAX package on the CPU.

``AsyncBackend.run``, ``step`` and ``TopoMap(backend="async").fit`` run on
the same numpy data and JAX initial state as JAX's, the port on JAX's draws
replayed (``torch_parity``: the run's sample indices first, then per event
the search's draws and the cascade's child) and, at exponential latency,
JAX's delays. Tolerances as ``tests/test_torch_events.py``: integers, the
report and the float32 times bitwise; weights within ``W_ULPS`` ulps of
the largest weight; q2 within the tie bound.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.api import TopoMap as JTopoMap
from repro.api import get_backend as jget_backend
from repro.core import afm as jafm
from repro_torch.api import TopoMap, available_backends, get_backend
from repro_torch.convert import state_from_numpy
from repro_torch.core import events as tev
from repro_torch.draws import GeneratorDraws, ReplayDraws
from repro_torch.kernels.bmu import ref as bmu_ref
from torch_parity import (assert_same_run, event_draws, jax_cfg,
                          recorded_exponentials, replay, select_run_draws, t,
                          torch_cfg)

CAP = tev.WAVE_CAP
W_ULPS = 8
KW = dict(side=6, dim=12, theta=2, i_max=128, e_factor=0.5)
X = np.random.default_rng(3).standard_normal((256, 12)).astype(np.float32)

OPTIONS = {
    "zero": {},
    "zero-fused-exact": dict(kernel="fused", search="exact"),
    "event": dict(engine="event"),
    "constant": dict(latency="constant", delay=1.5, search="exact"),
    "exponential": dict(latency="exponential", delay=2.0),
    "budget": dict(latency="constant", delay=2.5, max_rounds=40),
}


def _jax_opts(opts):
    return {k: ("fused-interpret" if v == "fused" else v)
            for k, v in opts.items()}


def _jax_run(fn, opts):
    """Run ``fn`` (a JAX backend call); at exponential latency also record
    its delays, replayed as the port's latency source."""
    if opts.get("latency") != "exponential":
        return fn(), None
    with recorded_exponentials() as rec:
        out = fn()
        jax.block_until_ready(out[0].w)
    return out, replay(rec)


def _heuristic(opts):
    return opts.get("search", "heuristic") == "heuristic"


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_async_run_matches_jax(name):
    opts = OPTIONS[name]
    jcfg, tcfg = jax_cfg(**KW), torch_cfg(**KW)
    state = jafm.init(jax.random.PRNGKey(1), jcfg, X)
    key = jax.random.PRNGKey(7)
    jb = jget_backend("async", jcfg, **_jax_opts(opts))
    (js, ja), lat = _jax_run(lambda: jb.run(state, X, key), opts)
    idx, keys = select_run_draws(key, X.shape[0], jcfg.i_max)
    draws = replay([idx] + event_draws(keys, jcfg, ja.waves,
                                       heuristic=_heuristic(opts),
                                       wave_cap=CAP))
    tb = get_backend("async", tcfg, device="cpu", **opts)
    if lat is not None:
        tb.lat_draws = lat
    ts, ta = tb.run(state_from_numpy(state, "cpu"), t(X), draws)
    if name != "budget":                        # every event ran
        assert len(draws) == 0
    assert tb.last_report.deliveries > 0        # cascades ran
    assert_same_run((js, ja, jb.last_report), (ts, ta, tb.last_report),
                    np.asarray(state.w), X[idx], W_ULPS)


@pytest.mark.parametrize("name", ["zero", "constant"])
def test_async_step_matches_jax(name):
    """``partial_fit``'s step: a (B, D) batch as B events, JAX splitting its
    key once per sample."""
    opts = OPTIONS[name]
    jcfg, tcfg = jax_cfg(**KW), torch_cfg(**KW)
    state = jafm.init(jax.random.PRNGKey(2), jcfg, X)
    key = jax.random.PRNGKey(9)
    jb = jget_backend("async", jcfg, **_jax_opts(opts))
    js, ja = jb.step(state, X[:16], key)
    draws = replay(event_draws(jax.random.split(key, 16), jcfg, ja.waves,
                               heuristic=_heuristic(opts), wave_cap=CAP))
    tb = get_backend("async", tcfg, device="cpu", **opts)
    ts, ta = tb.step(state_from_numpy(state, "cpu"), t(X[:16]), draws)
    assert_same_run((js, ja, jb.last_report), (ts, ta, tb.last_report),
                    np.asarray(state.w), X[:16], W_ULPS)


@pytest.mark.parametrize("name", ["zero", "constant", "exponential"])
def test_topomap_async_fit_matches_jax(name):
    """``TopoMap(backend="async").fit`` on the keys of JAX's fit: JAX's
    initial state (the packages' link samplers differ), then the fit's own
    draws; the fitted state, aux, report, labels and projections."""
    opts = OPTIONS[name]
    jcfg, tcfg = jax_cfg(**KW), torch_cfg(**KW)
    y = (X[:, 0] > 0).astype(np.int32)
    key = jax.random.PRNGKey(11)
    jtm = JTopoMap(jcfg, backend="async", backend_options=_jax_opts(opts))
    (_, _), lat = _jax_run(
        lambda: (jtm.fit(X, y, key=key).state_, None), opts)
    k_init, k_run = jax.random.split(key)
    state = jafm.init(k_init, jcfg, X)
    idx, keys = select_run_draws(k_run, X.shape[0], jcfg.i_max)
    draws = replay([idx] + event_draws(keys, jcfg, jtm.fit_aux_.waves,
                                       heuristic=_heuristic(opts),
                                       wave_cap=CAP))
    tm = TopoMap(tcfg, backend="async", backend_options=opts, device="cpu")
    tm.backend.init = lambda draws_, samples: state_from_numpy(state, "cpu")
    if lat is not None:
        tm.backend.lat_draws = lat
    tm.fit(X, y, draws=draws)
    assert tm.backend.last_report.deliveries > 0
    assert_same_run((jtm.state_, jtm.fit_aux_, jtm.backend.last_report),
                    (tm.state_, tm.fit_aux_, tm.backend.last_report),
                    np.asarray(state.w), X[idx], W_ULPS)
    np.testing.assert_array_equal(np.asarray(jtm.transform(X[:64])),
                                  tm.transform(X[:64]).numpy())
    np.testing.assert_array_equal(np.asarray(jtm.unit_labels_),
                                  tm.unit_labels_.numpy())


def test_async_backend_registered():
    assert "async" in available_backends()
    b = get_backend("async", torch_cfg(**dict(KW, batch=4)), device="cpu")
    assert b.cfg.batch == 1          # per-sample semantics, like reference
    assert b.ecfg == tev.EventConfig()


def test_async_rejects_bad_options():
    cfg = torch_cfg(**KW)
    with pytest.raises(ValueError, match="latency"):
        get_backend("async", cfg, latency="warp", device="cpu")
    with pytest.raises(ValueError, match="search"):
        get_backend("async", cfg, search="oracle", device="cpu")
    with pytest.raises(ValueError, match="engine"):
        get_backend("async", cfg, engine="fused", device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        get_backend("async", cfg, kernel="fused-interpret", device="cpu")
    with pytest.raises(ValueError, match="shards"):
        get_backend("async", cfg, shards=2, device="cpu")
    # 'mesh' resolves (one shard: the single-pool runner); more shards than
    # the side divides into row bands are refused at construction
    assert get_backend("async", cfg, placement="mesh",
                       device="cpu").placement.shards == 1
    with pytest.raises(ValueError, match="contiguous row bands"):
        get_backend("async", cfg, placement="mesh", shards=5, device="cpu")
    with pytest.raises(ValueError, match="FaultPlan disqualifies"):
        get_backend("async", cfg, faults={"p_loss": 0.1}, kernel="fused",
                    device="cpu")
    with pytest.raises(ValueError, match="faults must be"):
        get_backend("async", cfg, faults="p_loss=0.1", device="cpu")
    be = get_backend("async", cfg, faults={"seed": 3}, device="cpu")
    assert not be.ecfg.fault_active          # a seed alone injects nothing
    be = get_backend("async", cfg, faults={"p_loss": 0.1}, device="cpu")
    assert be.ecfg.fault_active


def test_async_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine with no card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_backend("async", torch_cfg(**KW))


def test_latency_stream_position_replays_a_run():
    """The latency source's generator state is the counterpart of JAX's
    ``lat_key``: restored, it replays an exponential run's delays."""
    cfg = torch_cfg(**KW)
    opts = dict(latency="exponential", delay=1.0, lat_seed=5, device="cpu")
    a = get_backend("async", cfg, **opts)
    state = a.init(GeneratorDraws(0, "cpu"), t(X))
    a.run(state, t(X), GeneratorDraws(1, "cpu"))        # moves the stream
    saved = a.lat_draws.generator.get_state()
    sa, _ = a.run(state, t(X), GeneratorDraws(2, "cpu"))
    b = get_backend("async", cfg, **opts)
    b.lat_draws.generator.set_state(saved)
    sb, _ = b.run(state, t(X), GeneratorDraws(2, "cpu"))
    assert a.last_report.sent > 0
    assert torch.equal(sa.w, sb.w) and a.last_report.rounds == \
        b.last_report.rounds
    c = get_backend("async", cfg, **opts)               # not restored
    sc, _ = c.run(state, t(X), GeneratorDraws(2, "cpu"))
    assert not torch.equal(sa.w, sc.w)


def test_donate_run_updates_in_place_with_the_same_result():
    cfg = torch_cfg(**KW)
    opts = dict(latency="constant", delay=1.0, device="cpu")
    state = get_backend("async", cfg, **opts).init(GeneratorDraws(0, "cpu"),
                                                   t(X))
    kept, _ = get_backend("async", cfg, **opts).run(
        state, t(X), GeneratorDraws(3, "cpu"))
    w0 = state.w.clone()
    given = state._replace(w=state.w.clone(), c=state.c.clone())
    donated, _ = get_backend("async", cfg, donate_run=True, **opts).run(
        given, t(X), GeneratorDraws(3, "cpu"))
    assert torch.equal(kept.w, donated.w)
    assert donated.w is given.w and torch.equal(state.w, w0)


def test_async_bmu_is_the_exact_search():
    cfg = torch_cfg(**KW)
    b = get_backend("async", cfg, device="cpu")
    w, s = t(X[:36]), t(X[100:140])
    idx, q2 = b.bmu(w, s)
    ref_idx, ref_q2 = bmu_ref.bmu_ref(w, s)
    assert torch.equal(idx, ref_idx) and torch.equal(q2, ref_q2)


# ------------------------------------------------------------ draw sources


def test_generator_spawn_is_seeded_and_leaves_the_parent_alone():
    a, b = GeneratorDraws(4, "cpu"), GeneratorDraws(4, "cpu")
    ka, kb = a.spawn(), b.spawn()
    assert torch.equal(ka.uniform((5,)), kb.uniform((5,)))
    assert torch.equal(a.uniform((5,)), GeneratorDraws(4, "cpu").uniform((5,)))
    second = a.spawn()
    assert not torch.equal(second.uniform((5,)), a.spawn().uniform((5,)))
    assert not torch.equal(GeneratorDraws(5, "cpu").spawn().uniform((5,)),
                           GeneratorDraws(4, "cpu").spawn().uniform((5,)))


def test_exponential_draws():
    x = GeneratorDraws(0, "cpu").exponential((20000,))
    assert x.dtype == torch.float32 and float(x.min()) >= 0.0
    assert abs(float(x.mean()) - 1.0) < 0.03
    r = ReplayDraws([np.full(3, 0.5, np.float32)])
    assert r.exponential((3,)).tolist() == [0.5] * 3


def test_replay_spawn_hands_out_nested_lists():
    r = ReplayDraws([np.zeros(2), [np.ones((1, 2)), np.full(3, 2.0)]])
    with pytest.raises(ValueError, match="child"):
        ReplayDraws([[np.ones(2)]]).uniform((2,))
    assert r.uniform((2,)).tolist() == [0.0, 0.0]
    child = r.spawn()
    assert child.uniform((1, 2)).tolist() == [[1.0, 1.0]]
    assert len(child) == 1 and len(r) == 0
    with pytest.raises(ValueError, match="spawn requested"):
        ReplayDraws([np.ones(2)]).spawn()
    with pytest.raises(IndexError, match="exhausted"):
        r.spawn()
