"""The port's map-serving tier against the JAX package's, on the CPU.

Counterparts of ``tests/test_serving_maps.py``, ``test_serving_gateway.py``
and ``test_serving_fleet.py`` (their CLI tests are in
``test_torch_map_cli.py``): the ``BmuEngine`` bucket ladder and its
process-wide ``CompileCache`` (the cache records each signature's first
use, and each chunk is one call of the ``bmu`` wrapper on exactly its rows:
the plain version here, the kernel on the card, see ``test_torch_gpu.py``),
``MapService`` endpoints,
swaps and hot updates, the coalescing ``MapGateway``, the ``MapFleet``'s
admission, health and rolling reload, ``LatencyHistogram`` and
``call_with_retries``.

The served map is a JAX-trained one carried over to the port, so the
endpoints are held against JAX's ``MapService`` on the same state:
indices and labels exactly, q2 within the f32 bound of the expanded
distance (``torch_parity.assert_bmu_tier``: XLA and PyTorch sum in other
orders, and JAX pads a chunk to its bucket, which changes its products'
shapes). A hot
update replays JAX's key chain and is held to JAX's step: integers
bitwise, weights within a few ulps.

Coalescing is made deterministic by queueing a burst while holding the
gateway's condition (re-entrant), so the dispatcher sees it whole;
results and ``dispatch_samples`` are asserted, not wall-clock windows.
"""
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.api import TopoMap as JTopoMap
from repro.serving import MapService as JMapService
from repro_torch.analysis.runtime import LockOrderRecorder, TraceGuard
from repro_torch.api import MapStore, TopoMap
from repro_torch.convert import state_from_numpy
from repro_torch.kernels.bmu import ref as bmu_ref
from repro_torch.serving import (BmuEngine, CompileCache, LatencyHistogram,
                                 MapFleet, MapGateway, MapService,
                                 Overloaded, call_with_retries)
from repro_torch.serving import maps as maps_lib
from torch_parity import (F32_EPS, assert_bmu_tier, jax_cfg, replay,
                          step_draws, t, torch_cfg)

KW = dict(side=6, dim=12, i_max=48, batch=4, e_factor=0.5)
CFG = torch_cfg(**KW)
N = CFG.n_units


def _engine(**kwargs):
    """A ``BmuEngine`` with an isolated cache (deterministic counts)."""
    kwargs.setdefault("cache", CompileCache())
    return BmuEngine(**kwargs)


def _data(n=256, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, KW["dim"])).astype(np.float32),
            rng.integers(0, 4, n).astype(np.int32))


X, Y = _data()


@pytest.fixture(scope="module")
def jfitted():
    return JTopoMap(jax_cfg(**KW)).fit(X, Y, key=jax.random.PRNGKey(7))


@pytest.fixture(scope="module")
def fitted(jfitted):
    """The JAX-trained map in the port."""
    return TopoMap.from_state(state_from_numpy(jfitted.state_, device="cpu"),
                              CFG, unit_labels=np.array(
                                  jfitted.unit_labels_), device="cpu")


def _ref_idx(tm, n):
    return bmu_ref.bmu_ref(tm.state_.w, t(X[:n]))[0].numpy()


@pytest.fixture
def wrapper_rows(monkeypatch):
    """The row counts the engine hands the ``bmu`` wrapper, call by call."""
    rows, bmu = [], maps_lib.bmu_ops.bmu

    def spy(w, s, **kwargs):
        rows.append(s.shape[0])
        return bmu(w, s, **kwargs)

    monkeypatch.setattr(maps_lib.bmu_ops, "bmu", spy)
    return rows


def _by_bucket(cache):
    out = {}
    for key, n in cache.dispatches.items():
        out[key[0]] = out.get(key[0], 0) + n
    return out


def _flip(state):
    return state._replace(w=torch.flip(state.w, [0]))


# ---------------------------------------------------------------- BmuEngine


def test_engine_matches_jax_engine_on_ragged_sizes(fitted, jfitted,
                                                    wrapper_rows):
    engine = _engine(buckets=(8, 64))
    jsvc = JMapService(jfitted.cfg, jfitted.state_, buckets=(8, 64))
    for n in (1, 3, 8, 9, 64, 100):
        idx, q2 = engine.bmu(fitted.state_.w, X[:n])
        jidx, jq2, _ = jsvc.serve_bmu(X[:n])
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert_bmu_tier(idx, q2, jidx, jq2, fitted.state_.w.numpy(), X[:n])
        ref_idx, ref_q2 = bmu_ref.bmu_ref(fitted.state_.w, t(X[:n]))
        assert torch.equal(idx, ref_idx)
        assert_bmu_tier(idx, q2, ref_idx, ref_q2, fitted.state_.w.numpy(),
                        X[:n])
    # no pad rows: 100 = 64 + 36, each chunk under its smallest bucket
    assert wrapper_rows == [1, 3, 8, 9, 64, 64, 36]
    assert _by_bucket(engine.cache) == {8: 3, 64: 4}


def test_engine_compiles_once_per_bucket(fitted):
    w = fitted.state_.w
    engine = _engine(buckets=(8, 64, 512))
    with TraceGuard(engine, expect=1):
        for n in (3, 5, 8, 1, 7):      # all land in the 8-bucket
            engine.bmu(w, X[:n])
    with TraceGuard(engine, expect=1):
        engine.bmu(w, X[:33])          # 64-bucket
        engine.bmu(w, X[:64])
    with TraceGuard(engine, expect=1):
        engine.bmu(w, X[:200])         # 512-bucket
    # 1060 = 512 + 512 + 36-tail-in-64: every chunk reuses a signature
    big = np.tile(X, (5, 1))[:1060]
    with TraceGuard(engine):
        idx, _ = engine.bmu(w, big)
    assert torch.equal(idx, bmu_ref.bmu_ref(w, t(big))[0])
    # one dispatch a chunk: 5 + 2 + 1 requests, then 512 + 512 + 36
    assert _by_bucket(engine.cache) == {8: 5, 64: 3, 512: 3}


def test_engine_new_map_shape_recompiles(fitted):
    engine = _engine(buckets=(8,))
    with TraceGuard(engine, expect=1):
        engine.bmu(fitted.state_.w, X[:4])
    with TraceGuard(engine, expect=1):
        engine.bmu(fitted.state_.w[:16], X[:4])


def test_engine_cap_clamps_into_ladder(fitted):
    cache = CompileCache()
    engine = _engine(buckets=(8, 64), cache=cache)
    big = np.tile(X, (2, 1))[:300]
    ref_idx = bmu_ref.bmu_ref(fitted.state_.w, t(big))[0]
    with TraceGuard(engine, max_new=len(engine.buckets)):
        for cap in (1, 5, 8, 9, 33, 64, 100, 5000):
            idx, _ = engine.bmu(fitted.state_.w, big, cap=cap)
            assert torch.equal(idx, ref_idx)
    assert {k[0] for k in cache.keys} <= set(engine.buckets)


def test_engines_share_process_wide_compile_cache(fitted):
    cache = CompileCache()
    engines = [_engine(buckets=(8, 64), cache=cache) for _ in range(4)]
    with TraceGuard(cache, max_new=2):   # the ladder, shared by all four
        for engine in engines:
            for n in (3, 8, 40, 64):
                engine.bmu(fitted.state_.w, X[:n])
    assert engines[0].trace_count == 2
    assert all(e.trace_count == 0 for e in engines[1:])


def test_services_can_share_one_engine(fitted):
    engine = _engine(buckets=(8, 64))
    a = MapService(CFG, fitted.state_, engine=engine, device="cpu")
    b = MapService(CFG, fitted.state_, engine=engine, device="cpu")
    with TraceGuard(engine, expect=1):
        a.transform(X[:5])
        b.transform(X[:6])
    assert a.engine is b.engine
    assert a.compiles == b.compiles == 1


def test_engine_rejects_bad_requests(fitted):
    engine = _engine()
    with TraceGuard(engine):            # an empty batch never captures
        idx, q2 = engine.bmu(fitted.state_.w, X[:0])
    assert idx.shape == (0,) and q2.shape == (0,)
    assert idx.dtype == torch.int32 and q2.dtype == torch.float32
    with pytest.raises(ValueError, match=r"expected \(B, D\)"):
        engine.bmu(fitted.state_.w, X[0])
    with pytest.raises(ValueError, match="D=5"):
        engine.bmu(fitted.state_.w, X[:2, :5])
    with pytest.raises(ValueError, match="buckets"):
        _engine(buckets=())
    with pytest.raises(ValueError, match="precision"):
        _engine(precision="tf32")


def test_topomap_transform_compiles_once_per_bucket(fitted, monkeypatch):
    monkeypatch.setattr(maps_lib, "GLOBAL_COMPILE_CACHE", CompileCache())
    tm = TopoMap.from_state(fitted.state_, CFG,
                            unit_labels=fitted.unit_labels_, device="cpu")
    with TraceGuard(tm.engine, expect=1):
        for n in (5, 7, 3, 8):
            tm.transform(X[:n])
    with TraceGuard(tm.engine):
        tm.predict(X[:6])
    tm2 = TopoMap.from_state(fitted.state_, CFG, device="cpu")
    with TraceGuard(tm2.engine, maps_lib.GLOBAL_COMPILE_CACHE):
        tm2.transform(X[:4])
    assert maps_lib.GLOBAL_COMPILE_CACHE.trace_count == 1


def test_topomap_10k_query_rides_the_ladder(fitted, wrapper_rows,
                                            monkeypatch):
    """10,000 samples are 4,096 + 4,096 + 1,808, each chunk on exactly its
    rows, all three under the signature of bucket 4,096."""
    cache = CompileCache()
    monkeypatch.setattr(maps_lib, "GLOBAL_COMPILE_CACHE", cache)
    tm = TopoMap.from_state(fitted.state_, CFG, device="cpu")
    data = np.tile(X, (40, 1))[:10000]
    idx = tm.transform(data)
    assert idx.shape == (10000,)
    assert wrapper_rows == [4096, 4096, 1808]
    assert _by_bucket(cache) == {4096: 3}
    assert torch.equal(idx, bmu_ref.bmu_ref(fitted.state_.w, t(data))[0])


# -------------------------------------------------------------- MapService


def test_service_matches_jax_service(fitted, jfitted):
    svc = MapService.from_estimator(fitted)
    jsvc = JMapService.from_estimator(jfitted)
    for n in (1, 17, 64, 200):
        np.testing.assert_array_equal(svc.transform(X[:n]).numpy(),
                                      np.asarray(jsvc.transform(X[:n])))
        assert torch.equal(svc.transform(X[:n]), fitted.transform(X[:n]))
    np.testing.assert_array_equal(
        svc.transform(X[:10], lattice=True).numpy(),
        np.asarray(jsvc.transform(X[:10], lattice=True)))
    np.testing.assert_array_equal(svc.predict(X[:50]).numpy(),
                                  np.asarray(jsvc.predict(X[:50])))
    assert svc.stats.requests == 10
    assert svc.stats.samples == 2 * (1 + 17 + 64 + 200) + 10 + 50


def test_service_quantization_error_and_u_matrix(fitted, jfitted):
    svc = MapService.from_estimator(fitted)
    jsvc = JMapService.from_estimator(jfitted)
    per = svc.quantization_errors(X).numpy()
    jper = np.asarray(jsvc.quantization_errors(X))
    _, q2 = bmu_ref.bmu_ref(fitted.state_.w, t(X))
    bound = bmu_ref.tie_bound(fitted.state_.w, t(X)).numpy()
    # |sqrt(a) - sqrt(b)| <= |a - b| / sqrt(q2)
    tol = bound / np.sqrt(np.maximum(q2.numpy(), 1e-6))
    assert np.all(np.abs(per - jper) <= tol)
    assert abs(svc.quantization_error(X) - jsvc.quantization_error(X)) <= \
        tol.mean()
    np.testing.assert_allclose(svc.u_matrix().numpy(), jsvc.u_matrix(),
                               rtol=4 * F32_EPS)


def test_service_predict_needs_labels(fitted):
    svc = MapService(CFG, fitted.state_, device="cpu")
    with pytest.raises(RuntimeError, match="unit labels"):
        svc.predict(X[:4])


def test_service_from_artifact_and_store(tmp_path, fitted):
    path = str(tmp_path / "art")
    fitted.save(path)
    svc = MapService.from_artifact(path, device="cpu")
    assert torch.equal(svc.transform(X[:13]), fitted.transform(X[:13]))
    MapStore(str(tmp_path / "store")).save(fitted, "toy")
    svc2 = MapService.from_store(str(tmp_path / "store"), "toy",
                                 device="cpu")
    assert torch.equal(svc2.predict(X[:13]), fitted.predict(X[:13]))


def test_service_validates_state_and_labels(fitted):
    with pytest.raises(ValueError, match="does not match config"):
        MapService(torch_cfg(side=5, dim=12), fitted.state_, device="cpu")
    with pytest.raises(ValueError, match="unit_labels shape"):
        MapService(CFG, fitted.state_, device="cpu",
                   unit_labels=torch.zeros(3, dtype=torch.int32))
    svc = MapService.from_estimator(fitted)
    with pytest.raises(ValueError, match="does not match config"):
        svc.swap(fitted.state_._replace(w=fitted.state_.w[:, :4]))
    with pytest.raises(ValueError, match="unit_labels shape"):
        svc.swap(fitted.state_, torch.zeros(3, dtype=torch.int32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MapService(CFG, fitted.state_)


# -------------------------------------------------------------- hot updates


def test_online_update_matches_jax_update(fitted, jfitted):
    """``update`` is one ``batched`` step on the served state: on JAX's key
    chain (replayed) it is JAX's update; from the service's own draws it is
    ``partial_fit`` on the same draws, bitwise."""
    jcfg = jax_cfg(**KW)
    svc = MapService.from_estimator(fitted)
    jsvc = JMapService.from_estimator(jfitted)
    key = jax.random.PRNGKey(5)
    jaux = jsvc.update(X[:8], key=key)
    draws = replay(step_draws(key, jcfg, 8, heuristic=True,
                              waves=int(jaux.waves)))
    aux = svc.update(X[:8], draws=draws)
    assert len(draws) == 0
    state, labels = svc.snapshot()
    jstate, _ = jsvc.snapshot()
    for f in ("gmu", "cascade_size", "waves"):
        np.testing.assert_array_equal(getattr(aux, f).numpy(),
                                      np.asarray(getattr(jaux, f)))
    np.testing.assert_array_equal(state.c.numpy(), np.asarray(jstate.c))
    assert state.i == int(jstate.i)
    bound = 4 * F32_EPS * (2 + int(jaux.waves)) * np.abs(
        np.asarray(jstate.w)).max()
    assert np.abs(state.w.numpy() - np.asarray(jstate.w)).max() <= bound
    assert torch.equal(labels, fitted.unit_labels_)
    assert svc.stats.updates == 1 and svc.stats.swaps == 1
    assert fitted.state_ is not state

    mine = MapService.from_estimator(fitted, seed=11)
    mine.update(X[:8])
    mirror = TopoMap.from_state(fitted.state_, CFG, device="cpu", seed=11)
    mirror.partial_fit(X[:8])
    assert torch.equal(mine.snapshot()[0].w, mirror.state_.w)


def test_update_does_not_recompile_inference(fitted):
    svc = MapService.from_estimator(fitted)
    svc.transform(X[:8])
    with TraceGuard(svc.engine):
        svc.update(X[:8])
        svc.transform(X[:8])


def test_swap_replaces_state_and_labels(fitted):
    svc = MapService.from_estimator(fitted)
    before = svc.transform(X[:40])
    svc.swap(_flip(fitted.state_), torch.flip(fitted.unit_labels_, [0]))
    assert torch.equal(svc.transform(X[:40]), N - 1 - before)
    assert torch.equal(svc.predict(X[:40]), fitted.predict(X[:40]))


# ------------------------------------------------------------------- stats


def test_stats_track_busy_and_wall_window(fitted):
    svc = MapService.from_estimator(fitted)
    svc.transform(X[:8])
    svc.transform(X[:40])
    s = svc.stats
    assert s.requests == 2 and s.samples == 48
    assert s.busy_seconds > 0 and s.seconds == s.busy_seconds
    assert s.window_seconds() >= s.busy_seconds
    assert s.throughput() == pytest.approx(48 / s.window_seconds())
    assert s.busy_throughput() == pytest.approx(48 / s.busy_seconds)
    lat = s.latency
    assert lat.count == s.requests == 2
    assert 0 < lat.quantiles()["p50"] <= lat.quantiles()["p99"]
    assert lat.total_seconds == pytest.approx(s.busy_seconds)


def test_stats_throughput_not_understated_under_concurrency(fitted):
    """Overlapping requests must not sum their spans into the throughput
    denominator. A barrier inside the engine call holds every thread's
    span open at once, so the requests overlap however the host schedules
    the threads (the plain version alone is too quick to overlap under
    load)."""
    svc = MapService.from_estimator(fitted)
    svc.transform(X[:8])
    svc.stats = type(svc.stats)()
    n_threads, per_thread = 4, 20
    barrier, bmu = threading.Barrier(n_threads, timeout=60), svc.engine.bmu

    def overlapping(w, data, **kwargs):
        barrier.wait()
        return bmu(w, data, **kwargs)

    svc.engine.bmu = overlapping

    def client():
        for _ in range(per_thread):
            svc.transform(X[:8])

    threads = [threading.Thread(target=client) for _ in range(n_threads)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    outer = time.perf_counter() - t0
    s = svc.stats
    assert s.requests == n_threads * per_thread
    assert s.window_seconds() <= outer + 1e-3
    assert s.throughput() >= s.busy_throughput() * 0.99


def test_concurrent_reads_with_hot_swaps_and_updates(fitted):
    svc = MapService.from_estimator(fitted)
    state_a, labels_a = svc.snapshot()
    state_b, labels_b = _flip(state_a), torch.flip(labels_a, [0])
    batch = X[:16]
    t_a = svc.transform(batch)
    t_b = N - 1 - t_a
    p_ok = svc.predict(batch)
    guard = TraceGuard(svc.engine)
    guard.__enter__()
    rec = LockOrderRecorder()
    rec.wrap(svc, "_lock")
    rec.wrap(svc, "_update_lock")
    stop = threading.Event()
    failures = []

    def reader():
        while not stop.is_set():
            got = svc.transform(batch)
            if not (torch.equal(got, t_a) or torch.equal(got, t_b)):
                failures.append(("torn transform", got))
            if not torch.equal(svc.predict(batch), p_ok):
                failures.append(("torn predict",))

    def writer():
        flipped = False
        while not stop.is_set():
            flipped = not flipped
            svc.swap(*((state_b, labels_b) if flipped else
                       (state_a, labels_a)))

    threads = [threading.Thread(target=reader) for _ in range(3)]
    threads.append(threading.Thread(target=writer))
    for th in threads:
        th.start()
    deadline = 100
    while svc.stats.swaps < 6 and deadline:
        deadline -= 1
        threads[0].join(0.01)
    stop.set()
    for th in threads:
        th.join()
    assert not failures, failures[:3]
    assert svc.stats.swaps >= 2
    guard.__exit__(None, None, None)
    rec.assert_no_inversions()

    svc.swap(state_a, labels_a)
    valid = set(labels_a.tolist())
    stop2 = threading.Event()

    def update_reader():
        while not stop2.is_set():
            got = svc.transform(batch)
            if not ((got >= 0).all() and (got < N).all()):
                failures.append(("out-of-range transform", got))
            if not set(svc.predict(batch).tolist()) <= valid:
                failures.append(("labels torn from map",))

    readers = [threading.Thread(target=update_reader) for _ in range(3)]
    with TraceGuard(svc.engine):
        for th in readers:
            th.start()
        for _ in range(3):
            svc.update(X[:8])
        stop2.set()
        for th in readers:
            th.join()
    assert not failures, failures[:3]
    assert svc.stats.updates == 3
    rec.assert_no_inversions()


# ------------------------------------------------------------------ gateway


@pytest.fixture
def gateway(fitted):
    with MapGateway(max_delay=0.001, device="cpu") as gw:
        gw.attach("toy", MapService.from_estimator(fitted))
        yield gw


def test_gateway_endpoints_match_jax_gateway(gateway, jfitted):
    from repro.serving import MapGateway as JMapGateway
    with JMapGateway(max_delay=0.001) as jgw:
        jgw.attach("toy", JMapService.from_estimator(jfitted))
        for n in (1, 7, 64, 200):
            np.testing.assert_array_equal(gateway.transform("toy", X[:n]),
                                          jgw.transform("toy", X[:n]))
        np.testing.assert_array_equal(
            gateway.transform("toy", X[:9], lattice=True),
            jgw.transform("toy", X[:9], lattice=True))
        np.testing.assert_array_equal(gateway.predict("toy", X[:33]),
                                      jgw.predict("toy", X[:33]))
    svc = gateway.service("toy")
    np.testing.assert_array_equal(gateway.quantization_errors("toy", X[:12]),
                                  svc.quantization_errors(X[:12]).numpy())
    assert gateway.quantization_error("toy", X[:12]) == pytest.approx(
        svc.quantization_error(X[:12]), rel=4 * F32_EPS)


def test_gateway_validates_requests(gateway, fitted):
    with pytest.raises(KeyError, match="no map 'nope'"):
        gateway.transform("nope", X[:2])
    with pytest.raises(ValueError, match=r"expected \(B, 12\)"):
        gateway.transform("toy", X[:2, :5])
    with pytest.raises(ValueError, match="kind"):
        gateway.submit("toy", X[:2], kind="u_matrix")
    assert gateway.transform("toy", X[:0]).shape == (0,)
    with MapGateway(max_delay=0.001, device="cpu") as gw:
        gw.attach("bare", MapService(CFG, fitted.state_, device="cpu"))
        with pytest.raises(RuntimeError, match="unit labels"):
            gw.predict("bare", X[:3])
        with pytest.raises(RuntimeError, match="unit labels"):
            gw.submit("bare", X[:1], kind="predict").result(10)


def test_gateway_coalesces_a_burst_into_one_dispatch(fitted):
    """48 batch-1 requests queued together ride one dispatch."""
    with MapGateway(max_delay=0.05, coalesce_max=64, device="cpu") as gw:
        gw.attach("toy", MapService.from_estimator(fitted))
        with gw._cond:                 # the dispatcher sees the burst whole
            futures = [gw.submit("toy", X[i:i + 1]) for i in range(48)]
        results = [f.result(30) for f in futures]
    np.testing.assert_array_equal(np.concatenate(results),
                                  _ref_idx(fitted, 48))
    assert gw.stats.dispatches == 1
    assert gw.stats.dispatch_requests == 48
    assert gw.stats.dispatch_samples == gw.stats.max_dispatch == 48
    assert gw.stats.mean_coalesced_requests() == 48
    assert gw.stats.direct == 0


def test_gateway_mixed_endpoints_share_one_dispatch(fitted):
    svc = MapService.from_estimator(fitted)
    with MapGateway(max_delay=0.05, coalesce_max=64, device="cpu") as gw:
        gw.attach("toy", MapService.from_estimator(fitted))
        with gw._cond:
            f_t = gw.submit("toy", X[:2], kind="transform")
            f_p = gw.submit("toy", X[2:4], kind="predict")
            f_q = gw.submit("toy", X[4:6], kind="quantization_errors")
        np.testing.assert_array_equal(f_t.result(30),
                                      svc.transform(X[:2]).numpy())
        np.testing.assert_array_equal(f_p.result(30),
                                      svc.predict(X[2:4]).numpy())
        _, q2 = bmu_ref.bmu_ref(fitted.state_.w, t(X[4:6]))
        bound = bmu_ref.tie_bound(fitted.state_.w, t(X[4:6])).numpy()
        assert np.all(np.abs(f_q.result(30) ** 2 - q2.numpy()) <= bound)
        assert gw.stats.dispatches == 1
        assert gw.stats.dispatch_samples == 6


def test_gateway_large_requests_go_direct(fitted):
    with MapGateway(max_delay=0.05, coalesce_max=64, device="cpu") as gw:
        gw.attach("toy", MapService.from_estimator(fitted))
        out = gw.transform("toy", X)
        assert gw.stats.direct == 1 and gw.stats.dispatches == 0
    np.testing.assert_array_equal(out, _ref_idx(fitted, len(X)))


def test_gateway_threaded_clients_match_oracle(fitted):
    ref = _ref_idx(fitted, 64)
    failures = []
    with MapGateway(max_delay=0.01, device="cpu") as gw:
        gw.attach("toy", MapService.from_estimator(fitted))
        rec = LockOrderRecorder()
        rec.wrap(gw, "_cond")
        rec.wrap(gw.service("toy"), "_lock")
        rec.wrap(gw.service("toy"), "_update_lock")

        def client(cid):
            for i in range(cid, 64, 8):
                got = int(gw.transform("toy", X[i:i + 1])[0])
                if got != int(ref[i]):
                    failures.append((i, got, int(ref[i])))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not failures, failures[:3]
        assert gw.stats.requests == 64
        assert gw.stats.dispatch_samples == 64
        rec.assert_no_inversions()


def test_k_same_shape_maps_compile_ladder_once(fitted, monkeypatch):
    cache = CompileCache()
    monkeypatch.setattr(maps_lib, "GLOBAL_COMPILE_CACHE", cache)
    with MapGateway(max_delay=0.001, buckets=(8, 64), device="cpu") as gw:
        for k in range(4):
            state = fitted.state_._replace(
                w=torch.roll(fitted.state_.w, k, 0))
            gw.attach(f"map{k}", MapService(
                CFG, state, buckets=(8, 64), device="cpu",
                unit_labels=fitted.unit_labels_))
        with TraceGuard(cache, max_new=2):
            for k in range(4):
                gw.transform(f"map{k}", X[:5])
                gw.predict(f"map{k}", X[:40])


def test_gateway_open_and_hot_reload(tmp_path, fitted):
    store = MapStore(str(tmp_path / "store"))
    store.save(fitted, "toy")
    with MapGateway(store=str(tmp_path / "store"), max_delay=0.001,
                    device="cpu") as gw:
        assert gw.open("toy") == "toy" and gw.names() == ["toy"]
        before = gw.transform("toy", X[:32])
        np.testing.assert_array_equal(before,
                                      fitted.transform(X[:32]).numpy())
        store.save(TopoMap.from_state(
            _flip(fitted.state_), CFG, device="cpu",
            unit_labels=torch.flip(fitted.unit_labels_, [0])), "toy")
        with TraceGuard(gw.service("toy").engine):
            assert gw.reload("toy") == 2
            after = gw.transform("toy", X[:32])
        np.testing.assert_array_equal(after, N - 1 - before)
        assert gw.service("toy").stats.swaps == 1
        assert gw.reload("toy") == 2
        assert gw.service("toy").stats.swaps == 1


def test_gateway_reload_under_alias(tmp_path, fitted):
    store = MapStore(str(tmp_path / "store"))
    store.save(fitted, "toy")
    with MapGateway(store=str(tmp_path / "store"), max_delay=0.001,
                    device="cpu") as gw:
        assert gw.open("toy@1", name="prod") == "prod"
        before = gw.transform("prod", X[:16])
        store.save(TopoMap.from_state(_flip(fitted.state_), CFG,
                                      device="cpu"), "toy")
        assert gw.reload("prod") == 2
        np.testing.assert_array_equal(gw.transform("prod", X[:16]),
                                      N - 1 - before)


def test_gateway_reload_shape_change_replaces_service(tmp_path, fitted):
    store = MapStore(str(tmp_path / "store"))
    store.save(fitted, "toy")
    with MapGateway(store=str(tmp_path / "store"), max_delay=0.001,
                    device="cpu") as gw:
        gw.open("toy")
        old = gw.service("toy")
        bigger = TopoMap(torch_cfg(**dict(KW, side=8)), device="cpu",
                         seed=9).fit(X, Y)
        store.save(bigger, "toy")
        gw.reload("toy")
        assert gw.service("toy") is not old
        assert gw.service("toy").device == torch.device("cpu")
        np.testing.assert_array_equal(gw.transform("toy", X[:16]),
                                      bigger.transform(X[:16]).numpy())


def test_gateway_without_store_refuses_open(fitted):
    with MapGateway(max_delay=0.001, device="cpu") as gw:
        with pytest.raises(RuntimeError, match="no store"):
            gw.open("toy")
        gw.attach("toy", MapService.from_estimator(fitted))
        with pytest.raises(RuntimeError, match="store"):
            gw.reload("toy")


def test_gateway_survives_cancelled_futures(fitted):
    ref = _ref_idx(fitted, 8)
    with MapGateway(max_delay=0.2, device="cpu") as gw:
        gw.attach("toy", MapService.from_estimator(fitted))
        doomed = gw.submit("toy", X[:1])
        cancelled = doomed.cancel()
        for i in range(1, 8):
            assert int(gw.submit("toy", X[i:i + 1]).result(30)[0]) == ref[i]
        if cancelled:
            assert doomed.cancelled()


def test_gateway_close_flushes_and_rejects_new_work(fitted):
    gw = MapGateway(max_delay=5.0, device="cpu")
    gw.attach("toy", MapService.from_estimator(fitted))
    futures = [gw.submit("toy", X[i:i + 1]) for i in range(5)]
    gw.close()
    ref = _ref_idx(fitted, 5)
    for i, f in enumerate(futures):
        assert int(f.result(1)[0]) == int(ref[i])
    with pytest.raises(RuntimeError, match="closed"):
        gw.submit("toy", X[:1])
    gw.close()


# ---------------------------------------------------------------- histogram


def test_latency_histogram_percentiles_and_merge():
    h = LatencyHistogram()
    assert h.percentile(0.5) == 0.0 and h.count == 0
    for ms in (1, 1, 2, 2, 2, 5, 10, 50, 200, 1000):
        h.record(ms / 1e3)
    assert h.count == 10
    assert 0.002 <= h.percentile(0.5) <= 0.0024
    assert 0.04 <= h.percentile(0.8) <= 0.06
    assert 1.0 <= h.percentile(0.95) <= 1.2
    assert 1.0 <= h.percentile(0.99) <= 1.2
    qs = h.quantiles()
    assert 0 < qs["p50"] <= qs["p95"] <= qs["p99"]
    assert h.mean() == pytest.approx(1.273 / 10, rel=1e-6)
    h2 = LatencyHistogram()
    for _ in range(90):
        h2.record(1e-4)
    h2.merge(h)
    assert h2.count == 100
    assert h2.percentile(0.5) < 2e-4
    assert h2.percentile(0.99) >= 0.2
    assert "p99" in h2.summary()


def test_latency_histogram_clamps_extremes():
    h = LatencyHistogram()
    h.record(0.0)
    h.record(1e9)
    assert h.count == 2
    assert h.percentile(0.01) == pytest.approx(h._edge(0))
    assert h.percentile(1.0) == pytest.approx(h.HI)
    with pytest.raises(ValueError, match="quantile"):
        h.percentile(1.5)


def test_latency_histogram_matches_jax():
    from repro.serving import LatencyHistogram as JHist
    rng = np.random.default_rng(0)
    a, b = LatencyHistogram(), JHist()
    for s in 10.0 ** rng.uniform(-7, 3, 500):
        a.record(float(s))
        b.record(float(s))
    assert a.quantiles() == b.quantiles() and a.summary() == b.summary()


# -------------------------------------------------------------------- fleet


def test_fleet_endpoints_match_service(fitted):
    fleet = MapFleet.from_estimator(fitted, replicas=3)
    svc = MapService.from_estimator(fitted)
    for n in (1, 7, 64, 200):
        assert torch.equal(fleet.transform(X[:n]), svc.transform(X[:n]))
    assert torch.equal(fleet.transform(X[:9], lattice=True),
                       svc.transform(X[:9], lattice=True))
    assert torch.equal(fleet.predict(X[:33]), svc.predict(X[:33]))
    assert torch.equal(fleet.quantization_errors(X[:12]),
                       svc.quantization_errors(X[:12]))
    assert fleet.quantization_error(X[:12]) == svc.quantization_error(X[:12])
    assert torch.equal(fleet.u_matrix(), svc.u_matrix())
    assert fleet.stats.completed == 8 and fleet.stats.sheds == 0
    assert fleet.stats.latency.count == 8
    assert fleet.merged_engine_latency().count == 8
    assert fleet.device == torch.device("cpu")


def test_fleet_validates_construction(fitted):
    with pytest.raises(ValueError, match="replicas"):
        MapFleet.from_estimator(fitted, replicas=0)
    with pytest.raises(ValueError, match="max_outstanding"):
        MapFleet.from_estimator(fitted, replicas=1, max_outstanding=0)


def test_fleet_round_robins_idle_replicas(fitted):
    fleet = MapFleet.from_estimator(fitted, replicas=3)
    for i in range(9):
        fleet.transform(X[i:i + 1])
    assert [s.stats.requests for s in fleet.services()] == [3, 3, 3]


def test_fleet_replicas_share_compile_cache(fitted, monkeypatch):
    cache = CompileCache()
    monkeypatch.setattr(maps_lib, "GLOBAL_COMPILE_CACHE", cache)
    fleet = MapFleet.from_estimator(fitted, replicas=4, buckets=(8, 64))
    with TraceGuard(cache, max_new=2):
        for i in range(8):
            fleet.transform(X[i:i + 1])
            fleet.transform(X[:40])


def _gate(svc):
    """Hold ``svc.serve_bmu`` until ``release`` is set."""
    release, entered = threading.Event(), threading.Semaphore(0)
    inner = svc.serve_bmu

    def gated(data):
        entered.release()
        assert release.wait(30)
        return inner(data)

    svc.serve_bmu = gated
    return release, entered


def test_fleet_admission_sheds_deterministically(fitted):
    fleet = MapFleet.from_estimator(fitted, replicas=1, max_outstanding=2,
                                    shed_deadline=0.05)
    release, entered = _gate(fleet.services()[0])
    results, errors = [], []

    def blocked_client(i):
        try:
            results.append(fleet.transform(X[i:i + 1]))
        except BaseException as e:  # noqa: BLE001 — recorded
            errors.append(e)

    threads = [threading.Thread(target=blocked_client, args=(i,))
               for i in range(2)]
    for th in threads:
        th.start()
    assert entered.acquire(timeout=30) and entered.acquire(timeout=30)
    t0 = time.perf_counter()
    with pytest.raises(Overloaded) as exc:
        fleet.transform(X[:1])
    assert time.perf_counter() - t0 >= 0.04
    assert exc.value.retry_after >= fleet.shed_deadline
    assert fleet.stats.sheds == 1 and fleet.stats.completed == 0
    release.set()
    for th in threads:
        th.join(30)
    assert not errors and len(results) == 2
    assert sorted(int(r[0]) for r in results) == sorted(
        _ref_idx(fitted, 2).tolist())
    assert fleet.stats.completed == 2 and fleet.stats.requests == 3
    assert fleet.outstanding() == 0


def test_fleet_shed_resolves_gateway_futures(fitted):
    fleet = MapFleet.from_estimator(fitted, replicas=1, max_outstanding=1,
                                    shed_deadline=0.02)
    release, entered = _gate(fleet.services()[0])
    with MapGateway(max_delay=0.001, coalesce_max=1, device="cpu") as gw:
        gw.attach("fleet", fleet)
        held = {}
        holder = threading.Thread(
            target=lambda: held.update(f=gw.submit("fleet", X[:1])))
        holder.start()
        assert entered.acquire(timeout=30)
        with pytest.raises(Overloaded):
            gw.submit("fleet", X[1:2]).result(30)
        release.set()
        holder.join(30)
        assert int(held["f"].result(30)[0]) == int(_ref_idx(fitted, 1)[0])


def test_fleet_ejects_and_readmits_slow_replica(fitted):
    fleet = MapFleet.from_estimator(fitted, replicas=2, eject_after=4,
                                    eject_factor=3.0, eject_cooldown=0.15)
    slow_svc = fleet.services()[1]
    inner = slow_svc.serve_bmu

    def slow(data):
        time.sleep(0.05)
        return inner(data)

    slow_svc.serve_bmu = slow
    for i in range(24):
        fleet.transform(X[i:i + 1])
        if fleet.stats.ejections:
            break
    assert fleet.stats.ejections >= 1
    assert any(r["ejected"] for r in fleet.replica_stats())
    served = slow_svc.stats.requests
    for i in range(6):
        fleet.transform(X[i:i + 1])
    assert slow_svc.stats.requests == served
    time.sleep(0.2)
    for i in range(4):
        fleet.transform(X[i:i + 1])
    assert slow_svc.stats.requests > served


def test_fleet_reload_requires_store_and_noops_when_current(tmp_path,
                                                           fitted):
    with pytest.raises(RuntimeError, match="store"):
        MapFleet.from_estimator(fitted, replicas=1).reload()
    MapStore(str(tmp_path / "store")).save(fitted, "toy")
    fleet = MapFleet.from_store(str(tmp_path / "store"), "toy", replicas=2,
                                device="cpu")
    assert fleet.version == 1 and fleet.reload() == 1
    assert fleet.stats.reloads == 0
    assert all(s.stats.swaps == 0 for s in fleet.services())


def test_fleet_rolling_reload_under_load(tmp_path, fitted):
    store = MapStore(str(tmp_path / "store"))
    store.save(fitted, "toy")
    fleet = MapFleet.from_store(str(tmp_path / "store"), "toy", replicas=2,
                                max_outstanding=64, shed_deadline=30.0,
                                device="cpu")
    batch = X[:16]
    t_a = fleet.transform(batch)
    t_b = N - 1 - t_a
    p_ok = fleet.predict(batch)
    guard = TraceGuard(*[s.engine for s in fleet.services()])
    guard.__enter__()
    rec = LockOrderRecorder()
    rec.wrap(fleet, "_cond")
    rec.wrap(fleet, "_reload_lock")
    for i, s in enumerate(fleet.services()):
        rec.wrap(s, "_lock", name=f"svc{i}._lock")
        rec.wrap(s, "_update_lock", name=f"svc{i}._update_lock")
    stop, failures = threading.Event(), []

    def reader():
        try:
            while not stop.is_set():
                got = fleet.transform(batch)
                if not (torch.equal(got, t_a) or torch.equal(got, t_b)):
                    failures.append(("torn transform", got))
                if not torch.equal(fleet.predict(batch), p_ok):
                    failures.append(("torn predict",))
        except BaseException as e:  # noqa: BLE001 — must be none
            failures.append(("request error", e))

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for th in threads:
        th.start()
    store.save_state("toy", cfg=CFG, state=_flip(fitted.state_),
                     unit_labels=torch.flip(fitted.unit_labels_, [0]))
    assert fleet.reload() == 2
    assert torch.equal(fleet.transform(batch), t_b)
    stop.set()
    for th in threads:
        th.join(30)
    assert not failures, failures[:3]
    assert fleet.version == 2 and fleet.stats.reloads == 1
    assert all(s.stats.swaps == 1 for s in fleet.services())
    guard.__exit__(None, None, None)
    rec.assert_no_inversions()
    assert fleet.stats.sheds == 0
    assert not any(r["draining"] for r in fleet.replica_stats())


def test_fleet_reload_shape_change_replaces_replicas(tmp_path, fitted):
    store = MapStore(str(tmp_path / "store"))
    store.save(fitted, "toy")
    fleet = MapFleet.from_store(str(tmp_path / "store"), "toy", replicas=2,
                                device="cpu")
    old = fleet.services()
    bigger = TopoMap(torch_cfg(**dict(KW, side=8)), device="cpu",
                     seed=9).fit(X, Y)
    store.save(bigger, "toy")
    assert fleet.reload() == 2
    assert all(a is not b for a, b in zip(fleet.services(), old))
    assert fleet.cfg.side == 8
    assert torch.equal(fleet.transform(X[:16]), bigger.transform(X[:16]))


# -------------------------------------------------------------------- retry


def test_retry_helper_honors_retry_after_and_backoff():
    sheds = [Overloaded("busy", retry_after=0.2),
             Overloaded("busy", retry_after=0.01)]
    calls, delays = [], []

    def flaky(x):
        calls.append(x)
        if sheds:
            raise sheds.pop(0)
        return x * 2

    out = call_with_retries(flaky, 21, max_retries=3, base_delay=0.05,
                            max_delay=2.0, sleep=delays.append)
    assert out == 42 and len(calls) == 3
    assert delays == [0.2, 0.1]


def test_retry_helper_gives_up_and_passes_other_errors():
    def always_shed():
        raise Overloaded("busy", retry_after=0.0)

    delays = []
    with pytest.raises(Overloaded):
        call_with_retries(always_shed, max_retries=2, sleep=delays.append)
    assert len(delays) == 2

    def boom():
        raise KeyError("not transient")

    with pytest.raises(KeyError):
        call_with_retries(boom, sleep=delays.append)
    assert len(delays) == 2
    with pytest.raises(ValueError, match="max_retries"):
        call_with_retries(boom, max_retries=-1)


def test_gateway_shed_retries_ride_out_a_shed(fitted):
    """``shed_retries`` retries an ``Overloaded`` dispatch (through
    ``call_with_retries``) before failing the riders."""
    fleet = MapFleet.from_estimator(fitted, replicas=1)
    inner, sheds = fleet.serve_bmu, [Overloaded("busy", retry_after=0.0)]

    def once_shed(data, **kw):
        if sheds:
            raise sheds.pop()
        return inner(data, **kw)

    fleet.serve_bmu = once_shed
    with MapGateway(max_delay=0.001, shed_retries=2, device="cpu") as gw:
        gw.attach("fleet", fleet)
        np.testing.assert_array_equal(gw.transform("fleet", X[:3]),
                                      _ref_idx(fitted, 3))
    with pytest.raises(ValueError, match="shed_retries"):
        MapGateway(shed_retries=-1, device="cpu")
