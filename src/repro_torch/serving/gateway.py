"""MapGateway — concurrent multi-map serving with cross-request coalescing,
port of ``repro.serving.gateway``.

``MapService`` serves one map to one caller at a time, and its bucket
ladder only cuts *within* a request — a stream of batch-1 callers pays one
dispatch each. The gateway turns the ladder into a cross-request
batching tool:

* **Registry** — named ``MapService``s, optionally backed by a
  ``MapStore`` for ``open``-by-spec and hot ``reload`` of new versions
  (same-shape reloads swap in place, so no new signature is recorded).
* **Coalescer** — concurrent small requests against the same map are
  merged into one bucket-sized BMU dispatch under a max-latency deadline
  (``max_delay`` seconds). Each dispatch serves every merged request from
  a single ``(state, labels)`` snapshot, so coalesced requests keep the
  per-request consistency guarantees of ``MapService``.
* **Shared signatures** — every service dispatches through the
  process-wide ``CompileCache``, so K same-shape maps record the bucket
  ladder once, not K times.

For *replicating one map* across N workers (admission control, rolling
reload, SLO histograms) see ``repro_torch.serving.fleet.MapFleet`` — a fleet can
be ``attach``-ed here to coalesce small requests in front of its replicas.

Requests at or above ``coalesce_max`` samples gain nothing from merging
and are served inline on the caller's thread; everything smaller is
enqueued and flushed by the dispatcher thread when the pending total fills
a bucket or the oldest request's deadline expires.

    gw = MapGateway(store="artifacts/maps", max_delay=0.002)
    gw.open("satimage-10x10")                  # -> name "satimage-10x10"
    units = gw.transform("satimage-10x10", x)  # blocking; coalesced
    fut = gw.submit("satimage-10x10", x)       # non-blocking Future
    gw.reload("satimage-10x10")                # hot-swap the latest version
    gw.close()                                 # or use as a context manager
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch.serving.maps import (DEFAULT_BUCKETS, MapService,
                                      postprocess, to_numpy)

_KINDS = ("transform", "predict", "quantization_errors")

#: Lock-discipline declarations (checked by ``repro_torch.analysis.locks``,
#: REP301).
#: One condition guards the whole gateway: registry, queues, stats, and
#: the closed flag all change together under ``_cond``.
GUARDED_BY = {
    "MapGateway": {"_services": "_cond", "_versions": "_cond",
                   "_open_opts": "_cond", "_map_names": "_cond",
                   "_queues": "_cond", "_closed": "_cond",
                   "stats": "_cond"},
}


@dataclasses.dataclass
class GatewayStats:
    """Coalescing counters for one ``MapGateway``.

    ``dispatches``/``dispatch_samples``/``dispatch_requests`` cover the
    coalescer only; ``direct`` counts large requests served inline. A mean
    dispatch size above 1 is the coalescing win: that many requests rode
    one BMU dispatch.
    """
    requests: int = 0            # everything submitted
    samples: int = 0
    direct: int = 0              # served inline (>= coalesce_max)
    dispatches: int = 0          # coalesced engine dispatches
    dispatch_samples: int = 0
    dispatch_requests: int = 0
    max_dispatch: int = 0        # largest merged sample count

    def mean_dispatch_size(self) -> float:
        """Mean merged samples per coalesced dispatch."""
        return (self.dispatch_samples / self.dispatches
                if self.dispatches else 0.0)

    def mean_coalesced_requests(self) -> float:
        """Mean requests merged per coalesced dispatch."""
        return (self.dispatch_requests / self.dispatches
                if self.dispatches else 0.0)


def _host_views(served, kinds):
    """A dispatch's (idx, q2, labels) as host numpy arrays, each copied off
    the card once and only where one of the merged requests' ``kinds``
    reads it (the rest None): per-request slicing is then free numpy views,
    with no further device work."""
    idx, q2, labels = served
    return (to_numpy(idx) if kinds - {"quantization_errors"} else None,
            to_numpy(q2) if "quantization_errors" in kinds else None,
            to_numpy(labels) if labels is not None and "predict" in kinds
            else None)


class _Pending:
    __slots__ = ("data", "kind", "lattice", "svc", "future", "size", "t_enq")

    def __init__(self, data, kind, lattice, svc):
        self.data = data
        self.kind = kind
        self.lattice = lattice
        self.svc = svc       # the service this request was validated against
        self.future = Future()
        self.size = int(data.shape[0])
        self.t_enq = time.perf_counter()


class MapGateway:
    """Front door for many named maps with cross-request coalescing.

    Args:
      store: ``MapStore`` (or its root path) backing ``open``/``reload``;
             optional when every service is ``attach``-ed directly.
      max_delay: seconds a queued request may wait for co-travellers
             before the dispatcher flushes it (the coalescing deadline).
      coalesce_max: merged-dispatch sample target; defaults to the top
             bucket. Requests this large or larger are served inline.
      shed_retries: when an attached fleet sheds a dispatch with
             ``Overloaded``, retry it this many times with bounded
             exponential backoff honoring ``retry_after``
             (``repro_torch.serving.retry``) before failing the riders. 0
             (default) keeps sheds immediate. The dispatcher thread sleeps
             through the backoff, so merged riders wait together — the
             coalesced dispatch *is* the retry unit.
      buckets / precision / update_backend / device: forwarded to
             services built by ``open``/``reload`` (``device``: CUDA
             unless the caller asks for the CPU).
    """

    def __init__(self, *, store=None, max_delay: float = 0.001,
                 coalesce_max: int | None = None, shed_retries: int = 0,
                 buckets=DEFAULT_BUCKETS, precision: str = "exact",
                 update_backend: str = "batched",
                 device: torch.device | str | None = None):
        if isinstance(store, str):
            from repro_torch.api import persistence
            store = persistence.MapStore(store)
        self.store = store
        self.max_delay = float(max_delay)
        self._svc_opts = dict(buckets=buckets, precision=precision,
                              update_backend=update_backend, device=device)
        buckets = tuple(sorted({int(b) for b in buckets}))
        self.coalesce_max = (buckets[-1] if coalesce_max is None
                             else int(coalesce_max))
        if self.coalesce_max < 1:
            raise ValueError(f"coalesce_max must be >= 1, got "
                             f"{self.coalesce_max}")
        self.shed_retries = int(shed_retries)
        if self.shed_retries < 0:
            raise ValueError(f"shed_retries must be >= 0, got "
                             f"{self.shed_retries}")
        # queue-stall grace: how long a queue must stop growing before it
        # flushes early (see _loop); max_delay stays the hard deadline
        self._stall_wait = min(max(self.max_delay / 8.0, 5e-5), 1e-3)
        self.stats = GatewayStats()
        self._services: dict[str, MapService] = {}
        self._versions: dict[str, int | None] = {}
        self._open_opts: dict[str, dict] = {}   # effective open() options
        self._map_names: dict[str, str] = {}    # registry name -> store name
        self._cond = threading.Condition()
        self._queues: dict[str, list[_Pending]] = {}
        self._closed = False
        self._dispatcher = threading.Thread(target=self._loop, daemon=True,
                                            name="map-gateway-dispatch")
        self._dispatcher.start()

    # ------------------------------------------------------------- registry

    def attach(self, name: str, service) -> "MapGateway":
        """Register an existing service under ``name``.

        Anything with ``cfg`` and ``serve_bmu(data)`` serves: a
        ``MapService``, or a ``repro_torch.serving.fleet.MapFleet`` — attaching
        a fleet puts the coalescer *in front of* the replicas, so merged
        dispatches are admission-controlled and routed like any other
        request (an ``Overloaded`` shed resolves every rider's future).
        """
        with self._cond:
            self._services[name] = service
            self._versions.setdefault(name, None)
        return self

    def open(self, spec: str, *, name: str | None = None, **kwargs) -> str:
        """Load ``name[@version]`` from the store and serve it.

        Returns the registry name (the spec's map name by default).
        ``kwargs`` override the gateway's default service options.
        """
        from repro_torch.api import persistence
        if self.store is None:
            raise RuntimeError("gateway has no store — attach() services "
                               "directly or construct with store=")
        map_name, version = persistence.parse_spec(spec)
        version = version or (self.store.versions(map_name) or [None])[-1]
        opts = {**self._svc_opts, **kwargs}
        svc = MapService.from_artifact(self.store.path(spec), **opts)
        name = name or map_name
        with self._cond:
            self._services[name] = svc
            self._versions[name] = version
            self._open_opts[name] = opts     # reload() keeps these overrides
            self._map_names[name] = map_name  # reload() under an alias too
        return name

    def reload(self, name: str) -> int | None:
        """Hot-reload ``name`` to the store's latest version.

        Same-shape versions are swapped into the live service — in-flight
        requests finish on the old weights, no new signature. A
        shape-changing version replaces the service wholesale
        (new signatures are unavoidable: the map itself changed shape).
        Returns the now-served version (no-op when already current).
        """
        if self.store is None:
            raise RuntimeError("reload needs a store-backed gateway")
        svc = self.service(name)
        with self._cond:
            map_name = self._map_names.get(name, name)
        versions = self.store.versions(map_name)
        if not versions:
            raise KeyError(f"map {map_name!r} not in store "
                           f"{self.store.root!r}")
        latest = versions[-1]
        with self._cond:
            if self._versions.get(name) == latest:
                return latest
        from repro_torch.api import persistence
        art = persistence.load_artifact(
            self.store.path(f"{map_name}@{latest}"), device=svc.device)
        if (art.cfg.n_units, art.cfg.dim) == (svc.cfg.n_units, svc.cfg.dim):
            svc.swap(art.state, art.unit_labels)
        else:
            with self._cond:
                opts = dict(self._open_opts.get(name, self._svc_opts))
            opts.pop("labeling", None)      # the new artifact's rule wins
            opts["device"] = svc.device
            svc = MapService(art.cfg, art.state, unit_labels=art.unit_labels,
                             labeling=art.labeling, **opts)
        with self._cond:
            self._services[name] = svc
            self._versions[name] = latest
        return latest

    def service(self, name: str) -> MapService:
        with self._cond:
            try:
                return self._services[name]
            except KeyError:
                raise KeyError(f"no map {name!r} in gateway; have "
                               f"{sorted(self._services)}") from None

    def names(self) -> list[str]:
        with self._cond:
            return sorted(self._services)

    # ------------------------------------------------------------ endpoints

    def submit(self, name: str, data, *, kind: str = "transform",
               lattice: bool = False) -> Future:
        """Enqueue one request; returns a ``Future`` of the endpoint result.

        Small requests wait up to ``max_delay`` to merge with concurrent
        traffic on the same map; requests of ``coalesce_max`` samples or
        more run inline on the calling thread.
        """
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
        svc = self.service(name)
        # requests stay numpy until the merged dispatch: one host->device
        # transfer and one engine call per dispatch, not per request
        data = to_numpy(data).astype(np.float32, copy=False)
        if data.ndim != 2 or data.shape[1] != svc.cfg.dim:
            raise ValueError(f"expected (B, {svc.cfg.dim}) request for map "
                             f"{name!r}, got shape {data.shape}")
        pending = _Pending(data, kind, lattice, svc)
        if pending.size == 0 or pending.size >= self.coalesce_max:
            with self._cond:
                self._check_open()
                self.stats.requests += 1
                self.stats.samples += pending.size
                self.stats.direct += 1
            self._serve_inline(svc, pending)
            return pending.future
        with self._cond:
            self._check_open()
            self.stats.requests += 1
            self.stats.samples += pending.size
            self._queues.setdefault(name, []).append(pending)
            self._cond.notify_all()
        return pending.future

    def transform(self, name: str, data, *, lattice: bool = False,
                  timeout: float | None = None) -> np.ndarray:
        """Coalesced BMU projection (blocking) — see ``MapService.transform``."""
        return self.submit(name, data, kind="transform",
                           lattice=lattice).result(timeout)

    def predict(self, name: str, data, *,
                timeout: float | None = None) -> np.ndarray:
        """Coalesced unit-label classification (blocking)."""
        return self.submit(name, data, kind="predict").result(timeout)

    def quantization_errors(self, name: str, data, *,
                            timeout: float | None = None) -> np.ndarray:
        """(B,) per-sample Euclidean BMU distances (blocking)."""
        return self.submit(name, data,
                           kind="quantization_errors").result(timeout)

    def quantization_error(self, name: str, data, *,
                           timeout: float | None = None) -> float:
        """Mean Euclidean BMU distance of the batch (blocking)."""
        return float(np.mean(self.quantization_errors(name, data,
                                                       timeout=timeout)))

    # ----------------------------------------------------------- dispatcher

    def _check_open(self):
        if self._closed:  # lint: unlocked-ok(every caller holds _cond)
            raise RuntimeError("gateway is closed")

    def _loop(self):
        # A queue is ready to flush when it fills a dispatch, when its
        # oldest request hits the max_delay deadline, or when it has gone
        # one short grace period without growing — blocking clients
        # resubmit within the grace, so steady traffic flushes at the
        # stall, not the deadline (the deadline only caps genuinely
        # trickling traffic). Among ready queues, the one with the oldest
        # waiting request dispatches first, so a continuously-busy map can
        # never starve the others.
        last_growth: dict[str, tuple[int, float]] = {}  # total, since
        while True:
            with self._cond:
                while not self._closed and not any(self._queues.values()):
                    last_growth.clear()
                    self._cond.wait()
                if self._closed and not any(self._queues.values()):
                    return
                now = time.perf_counter()
                ready_name, oldest_head, next_wake = None, None, None
                for name, queue in self._queues.items():
                    if not queue:
                        last_growth.pop(name, None)
                        continue
                    total = sum(p.size for p in queue)
                    prev = last_growth.get(name)
                    if prev is None or prev[0] != total:
                        last_growth[name] = (total, now)
                        since = now
                    else:
                        since = prev[1]
                    head = queue[0].t_enq
                    flush_at = min(head + self.max_delay,
                                   since + self._stall_wait)
                    if (total >= self.coalesce_max or now >= flush_at
                            or self._closed):
                        if ready_name is None or head < oldest_head:
                            ready_name, oldest_head = name, head
                    elif next_wake is None or flush_at < next_wake:
                        next_wake = flush_at
                if ready_name is None:
                    self._cond.wait(max(next_wake - now, 1e-4))
                    continue
                group = self._drain(ready_name)
                last_growth.pop(ready_name, None)
            try:
                self._dispatch(ready_name, group)
            except BaseException:           # noqa: BLE001 — thread must live
                # _dispatch resolves per-request errors into futures; only a
                # defect could land here, and it must not kill the
                # dispatcher (queued callers would hang forever)
                pass

    def _drain(self, name: str) -> list[_Pending]:
        """Pop whole requests up to ``coalesce_max`` samples (>= 1).

        Stops at a service boundary: requests validated against different
        service objects (a shape-changing ``reload`` landed between them)
        never merge into one dispatch.
        """
        queue = self._queues[name]  # lint: unlocked-ok(_loop holds _cond)
        taken, total = [], 0
        while queue and (not taken
                         or (total + queue[0].size <= self.coalesce_max
                             and queue[0].svc is taken[0].svc)):
            pending = queue.pop(0)
            taken.append(pending)
            total += pending.size
        return taken

    @staticmethod
    def _resolve(pending: _Pending, value=None, exc=None) -> None:
        """Complete a future, tolerating a caller who already cancelled it
        (a cancelled future raises InvalidStateError on set_*)."""
        future = pending.future
        if not future.set_running_or_notify_cancel():
            return                          # caller gave up; drop the result
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(value)

    def _serve_bmu(self, svc, data):
        """One backing ``serve_bmu`` call, retrying ``Overloaded`` sheds
        per the gateway's ``shed_retries`` policy (0 = raise through)."""
        if not self.shed_retries:
            return svc.serve_bmu(data)
        from repro_torch.serving.retry import call_with_retries
        return call_with_retries(svc.serve_bmu, data,
                                 max_retries=self.shed_retries)

    def _dispatch(self, name: str, group: list[_Pending]) -> None:
        del name
        try:
            # the service each request was validated against at submit time
            # — a shape-changing reload() mid-queue must not retarget them
            svc = group[0].svc
            merged = (group[0].data if len(group) == 1 else
                      np.concatenate([p.data for p in group], axis=0))
            idx, q2, labels = _host_views(
                self._serve_bmu(svc, merged), {p.kind for p in group})
        except BaseException as e:          # noqa: BLE001 — goes to callers
            for pending in group:
                self._resolve(pending, exc=e)
            return
        total = int(merged.shape[0])
        with self._cond:
            st = self.stats
            st.dispatches += 1
            st.dispatch_samples += total
            st.dispatch_requests += len(group)
            st.max_dispatch = max(st.max_dispatch, total)
        lo = 0
        for pending in group:
            sl = slice(lo, lo + pending.size)
            lo += pending.size
            try:
                self._resolve(pending, self._post(
                    svc, pending, None if idx is None else idx[sl],
                    None if q2 is None else q2[sl], labels))
            except BaseException as e:      # noqa: BLE001 — goes to caller
                self._resolve(pending, exc=e)

    def _serve_inline(self, svc: MapService, pending: _Pending) -> None:
        try:
            idx, q2, labels = _host_views(
                self._serve_bmu(svc, pending.data), {pending.kind})
            self._resolve(pending, self._post(svc, pending, idx, q2, labels))
        except BaseException as e:          # noqa: BLE001 — goes to caller
            self._resolve(pending, exc=e)

    @staticmethod
    def _post(svc: MapService, pending: _Pending, idx, q2, labels):
        """Endpoint-specific numpy view of one request's dispatch slice."""
        return postprocess(svc.cfg.side, pending.kind, pending.lattice,
                           idx, q2, labels, xp=np)

    # ------------------------------------------------------------ lifecycle

    def close(self, timeout: float | None = 5.0) -> None:
        """Stop accepting requests, flush the queues, join the dispatcher."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._dispatcher.join(timeout)

    def __enter__(self) -> "MapGateway":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self):
        n = self.stats.dispatches  # lint: unlocked-ok(stale ok in repr)
        return (f"MapGateway(maps={self.names()}, "
                f"coalesce_max={self.coalesce_max}, "
                f"max_delay={self.max_delay}, "
                f"dispatches={n})")
