"""MapFleet — replicated map serving with admission control and rolling
reload, port of ``repro.serving.fleet``.

One ``MapService`` serves one map from one engine; the gateway coalesces
requests but still funnels them through a single worker. The fleet is the
tier above: **N replica services of the same map behind one front door**,
which is what "heavy traffic" actually needs — concurrent dispatch across
workers, bounded queueing with explicit overload behavior, and hot updates
that never take the map offline.

* **Replication** — each replica owns its ``BmuEngine`` (independent
  dispatch, independent stats) but all replicas share the process-wide
  ``CompileCache``, so K replicas of one map still record the bucket
  ladder once. Requests route to the replica with the least outstanding
  work, breaking ties round-robin so equal-load replicas share traffic.
* **Admission control** — at most ``max_outstanding`` requests may be in
  flight fleet-wide. Beyond that, callers block (backpressure) up to
  ``shed_deadline`` seconds, then get a typed ``Overloaded`` rejection
  carrying a ``retry_after`` hint — never a deadlock, never a silent
  drop. Sheds are counted separately from completions.
* **Health** — a replica whose smoothed latency stays a configurable
  factor above the fleet median is **ejected** (routing skips it) for a
  cooldown, then re-admitted on probation with fresh accounting. At least
  one replica always stays routable.
* **Rolling reload** — ``reload()`` rolls the fleet to the store's latest
  ``name@version`` one replica at a time: drain (stop routing to it, wait
  for its in-flight work), swap via the same-shape atomic-swap path (or
  replace the service wholesale on a shape change), re-admit, next. With
  N >= 2 replicas the map never goes offline; every read lands on exactly
  one complete version (``MapService.snapshot`` semantics per replica).
* **SLO visibility** — ``stats.latency`` is a fleet-wide
  ``LatencyHistogram`` of end-to-end spans (admission wait + routing +
  engine); each replica's ``ServiceStats.latency`` holds its engine
  spans; ``merged_engine_latency()`` folds the replicas together.

    fleet = MapFleet.from_store("artifacts/maps", "satimage-10x10",
                                replicas=4)
    units = fleet.transform(x)            # routed; may raise Overloaded
    fleet.reload()                        # roll to the latest version
    print(fleet.stats.latency.summary())  # p50/p95/p99 in ms

The fleet exposes ``cfg`` and ``serve_bmu``, so a ``MapGateway`` can
``attach`` it and coalesce small requests *in front of* the replicas.
``repro_torch.launch.serve_map --replicas N`` is the CLI front end.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.serving.maps import (DEFAULT_BUCKETS, LatencyHistogram,
                                      MapService, postprocess)


#: Lock-discipline declarations (checked by ``repro_torch.analysis.locks``,
#: REP301).
#: ``_cond`` guards routing/admission state and the stats record;
#: ``_reload_lock`` serialises rolling reloads and owns ``_version``.
#: Per-replica fields (``_Replica``) are also guarded by ``_cond`` per the
#: class docstring, but are accessed through local aliases a checker
#: does not track.
GUARDED_BY = {
    "MapFleet": {"_outstanding": "_cond", "_rr": "_cond",
                 "stats": "_cond", "_version": "_reload_lock"},
}


class Overloaded(RuntimeError):
    """Typed load-shed rejection: the fleet's admission queue stayed full
    past the shed deadline. ``retry_after`` (seconds) is the fleet's
    drain-time estimate — a cooperative client should back off at least
    that long before retrying."""

    def __init__(self, message: str, *, retry_after: float):
        super().__init__(message)
        self.retry_after = float(retry_after)


@dataclasses.dataclass
class FleetStats:
    """Fleet-wide counters. ``completed`` and ``sheds`` partition finished
    admissions (errors re-raise to the caller and count as neither);
    ``latency`` holds end-to-end spans (admission wait included) for
    every completed request."""
    requests: int = 0            # admission attempts
    completed: int = 0
    samples: int = 0
    sheds: int = 0
    reloads: int = 0
    ejections: int = 0
    latency: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)


class _Replica:
    """One worker: a ``MapService`` plus routing/health accounting. All
    mutable fields are guarded by the fleet's condition lock."""

    __slots__ = ("svc", "outstanding", "ewma", "served", "ejected_until",
                 "draining")

    def __init__(self, svc: MapService):
        self.svc = svc
        self.outstanding = 0     # requests routed here and not yet finished
        self.ewma = None         # smoothed request latency (seconds)
        self.served = 0          # completions since (re-)admission
        self.ejected_until = 0.0  # monotonic deadline; 0 = healthy
        self.draining = False    # rolling reload: no new routes


class MapFleet:
    """N replica ``MapService`` workers behind one admission-controlled
    front door. See the module docstring for the full contract.

    Args:
      cfg, state: the served map (replicated by reference: updates and
          swaps replace the ``AFMState`` wholesale, so replicas share the
          tensors).
      replicas: worker count (>= 1).
      max_outstanding: fleet-wide in-flight bound (the admission queue);
          defaults to ``8 * replicas``.
      shed_deadline: seconds a caller may block for admission before the
          fleet sheds it with ``Overloaded``.
      eject_after: completions a replica must have before it can be
          health-ejected (warm-up grace).
      eject_factor: eject when a replica's smoothed latency exceeds this
          multiple of the healthy-replica median.
      eject_cooldown: seconds an ejected replica sits out before
          probationary re-admission.
      unit_labels / labeling / buckets / precision / update_backend /
      device: forwarded to every replica ``MapService`` (``device``: CUDA
          unless the caller asks for the CPU).
    """

    def __init__(self, cfg, state, *, replicas: int = 2, unit_labels=None,
                 labeling: str = "nearest", buckets=DEFAULT_BUCKETS,
                 precision: str = "exact",
                 max_outstanding: int | None = None,
                 shed_deadline: float = 0.5,
                 eject_after: int = 32, eject_factor: float = 4.0,
                 eject_cooldown: float = 2.0,
                 update_backend: str = "batched",
                 device: torch.device | str | None = None):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self._svc_opts = dict(unit_labels=unit_labels, labeling=labeling,
                              buckets=buckets, precision=precision,
                              update_backend=update_backend,
                              device=resolve_device(device))
        self._replicas = [_Replica(MapService(cfg, state, **self._svc_opts))
                          for _ in range(replicas)]
        self.max_outstanding = (8 * replicas if max_outstanding is None
                                else int(max_outstanding))
        if self.max_outstanding < 1:
            raise ValueError(f"max_outstanding must be >= 1, got "
                             f"{self.max_outstanding}")
        self.shed_deadline = float(shed_deadline)
        self.eject_after = int(eject_after)
        self.eject_factor = float(eject_factor)
        self.eject_cooldown = float(eject_cooldown)
        self.stats = FleetStats()
        self._cond = threading.Condition()
        self._outstanding = 0          # admitted and not yet finished
        self._rr = 0                   # round-robin tie-break cursor
        self._reload_lock = threading.Lock()
        self._store = None             # set by from_store: (MapStore, name)
        self._version: int | None = None

    # --------------------------------------------------------- constructors

    @classmethod
    def from_estimator(cls, tm, **kwargs) -> "MapFleet":
        """Replicate a fitted ``TopoMap`` (engine precision and device
        carry over, as in ``MapService.from_estimator``)."""
        kwargs.setdefault("labeling", tm.labeling)
        kwargs.setdefault("precision", tm.engine.precision)
        kwargs.setdefault("device", tm.device)
        return cls(tm.cfg, tm.state_, unit_labels=tm.unit_labels_, **kwargs)

    @classmethod
    def from_artifact(cls, path: str, **kwargs) -> "MapFleet":
        """Replicate a saved artifact directory."""
        from repro_torch.api import persistence
        art = persistence.load_artifact(path, device=kwargs.get("device"))
        kwargs.setdefault("labeling", art.labeling)
        return cls(art.cfg, art.state, unit_labels=art.unit_labels, **kwargs)

    @classmethod
    def from_store(cls, root: str, spec: str, **kwargs) -> "MapFleet":
        """Replicate ``name[@version]`` from a ``MapStore`` — and remember
        the store, so ``reload()`` can roll to later versions."""
        from repro_torch.api import persistence
        store = persistence.MapStore(root) if isinstance(root, str) else root
        name, version = persistence.parse_spec(spec)
        version = version or (store.versions(name) or [None])[-1]
        fleet = cls.from_artifact(store.path(spec), **kwargs)
        fleet._store = (store, name)
        fleet._version = version
        return fleet

    # ------------------------------------------------------------ admission

    def _healthy(self, now: float) -> list[_Replica]:
        return [r for r in self._replicas
                if not r.draining and r.ejected_until <= now]

    def _retry_after(self) -> float:
        """Drain-time estimate for the Overloaded hint: outstanding work
        divided across routable replicas, paced at the observed mean
        latency (floored at the shed deadline when latency is unknown)."""
        # caller (_admit_and_route) holds the condition lock
        mean = self.stats.latency.mean()  # lint: unlocked-ok(under _cond)
        n = max(1, len(self._healthy(time.monotonic())))
        pending = self._outstanding  # lint: unlocked-ok(under _cond)
        est = (pending / n) * mean if mean > 0 else 0.0
        return max(est, self.shed_deadline)

    def _admit_and_route(self, deadline: float | None) -> _Replica:
        """Block for an admission slot and a routable replica, or shed.

        Least-outstanding-work routing with a round-robin tie-break:
        scanning starts at a rotating cursor, so equally loaded replicas
        (the common case under light traffic) take turns instead of
        replica 0 absorbing everything.
        """
        limit = time.monotonic() + (self.shed_deadline if deadline is None
                                    else float(deadline))
        with self._cond:
            self.stats.requests += 1
            while True:
                now = time.monotonic()
                candidates = self._healthy(now)
                if not candidates:
                    # every replica ejected: health must never make the
                    # fleet unroutable — fall back to non-draining ones
                    candidates = [r for r in self._replicas
                                  if not r.draining]
                if self._outstanding < self.max_outstanding and candidates:
                    n = len(self._replicas)
                    best = None
                    for i in range(n):
                        r = self._replicas[(self._rr + i) % n]
                        if r in candidates and (
                                best is None
                                or r.outstanding < best.outstanding):
                            best = r
                    self._rr = (self._rr + 1) % n
                    self._outstanding += 1
                    best.outstanding += 1
                    return best
                remaining = limit - now
                if remaining <= 0:
                    self.stats.sheds += 1
                    raise Overloaded(
                        f"fleet saturated: {self._outstanding} in flight "
                        f">= max_outstanding={self.max_outstanding} past "
                        f"the {self.shed_deadline * 1e3:.0f} ms shed "
                        f"deadline", retry_after=self._retry_after())
                self._cond.wait(remaining)

    def _finish(self, replica: _Replica, seconds: float, ok: bool) -> None:
        with self._cond:
            self._outstanding -= 1
            replica.outstanding -= 1
            if ok:
                replica.served += 1
                a = 0.2                    # EWMA smoothing
                replica.ewma = (seconds if replica.ewma is None
                                else a * seconds + (1 - a) * replica.ewma)
                self._maybe_eject(replica)
            self._cond.notify_all()

    def _maybe_eject(self, replica: _Replica) -> None:
        """Eject ``replica`` when its smoothed latency is persistently far
        above its peers'. Called under the condition lock."""
        if replica.served < self.eject_after:
            return
        now = time.monotonic()
        peers = [r.ewma for r in self._healthy(now)
                 if r is not replica and r.ewma is not None
                 and r.served >= self.eject_after]
        if not peers:
            return                         # nobody to compare against
        peers.sort()
        median = peers[len(peers) // 2]
        if median > 0 and replica.ewma > self.eject_factor * median:
            replica.ejected_until = now + self.eject_cooldown
            # probation: fresh accounting when it comes back, so one bad
            # stretch doesn't echo forever in the EWMA
            replica.ewma = None
            replica.served = 0
            self.stats.ejections += 1  # lint: unlocked-ok(caller holds _cond)

    # ------------------------------------------------------------ endpoints

    def serve_bmu(self, data, *, deadline: float | None = None):
        """One routed, admission-controlled BMU dispatch — the fleet's
        analogue of ``MapService.serve_bmu`` (and the hook that lets a
        ``MapGateway`` coalesce in front of the fleet). Raises
        ``Overloaded`` if no admission slot frees up within ``deadline``
        (default: the fleet's ``shed_deadline``)."""
        t0 = time.perf_counter()
        replica = self._admit_and_route(deadline)
        ok = False
        try:
            out = replica.svc.serve_bmu(data)
            ok = True
        finally:
            t1 = time.perf_counter()
            self._finish(replica, t1 - t0, ok)
        with self._cond:
            self.stats.completed += 1
            self.stats.samples += int(out[0].shape[0])
        # deliberately outside _cond: the histogram has its own lock, and
        # recording under the fleet lock would serialise every completion
        self.stats.latency.record(t1 - t0)  # lint: unlocked-ok(self-locking)
        return out

    def transform(self, data, *, lattice: bool = False,
                  deadline: float | None = None):
        idx, q2, labels = self.serve_bmu(data, deadline=deadline)
        return postprocess(self.cfg.side, "transform", lattice, idx, q2,
                           labels)

    def predict(self, data, *, deadline: float | None = None):
        idx, q2, labels = self.serve_bmu(data, deadline=deadline)
        return postprocess(self.cfg.side, "predict", False, idx, q2, labels)

    def quantization_errors(self, data, *, deadline: float | None = None):
        idx, q2, labels = self.serve_bmu(data, deadline=deadline)
        return postprocess(self.cfg.side, "quantization_errors", False, idx,
                           q2, labels)

    def quantization_error(self, data, *,
                           deadline: float | None = None) -> float:
        return float(torch.mean(self.quantization_errors(
            data, deadline=deadline)))

    def u_matrix(self):
        """(side, side) mean neighbour distance (replica 0's snapshot — a
        map-level readback, not request traffic, so it skips admission)."""
        return self._replicas[0].svc.u_matrix()

    # -------------------------------------------------------- rolling reload

    def reload(self, *, drain_timeout: float = 30.0) -> int | None:
        """Roll every replica to the store's latest version, one at a time.

        Per replica: mark draining (routing skips it; with N >= 2 the
        others keep serving), wait for its in-flight requests, swap the
        new state in atomically (same shape) or replace the service
        wholesale (shape change), re-admit. No-op when already current.
        Returns the now-served version.
        """
        if self._store is None:
            raise RuntimeError("reload needs a store-backed fleet — build "
                               "it with MapFleet.from_store")
        from repro_torch.api import persistence
        store, name = self._store
        with self._reload_lock:
            versions = store.versions(name)
            if not versions:
                raise KeyError(f"map {name!r} not in store {store.root!r}")
            latest = versions[-1]
            if latest == self._version:
                return latest
            art = persistence.load_artifact(store.path(f"{name}@{latest}"),
                                            device=self.device)
            for replica in self._replicas:
                self._roll_one(replica, art, drain_timeout)
            with self._cond:
                self._version = latest
                self.stats.reloads += 1
        return latest

    def _roll_one(self, replica: _Replica, art, drain_timeout: float) -> None:
        with self._cond:
            replica.draining = True
            deadline = time.monotonic() + drain_timeout
            while replica.outstanding > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    replica.draining = False
                    self._cond.notify_all()
                    raise TimeoutError(
                        f"replica failed to drain within {drain_timeout}s "
                        f"({replica.outstanding} requests still in flight)")
                self._cond.wait(remaining)
        # the replica is idle and unroutable; swap outside the fleet lock
        # (the service's own locks make the swap atomic for any straggler)
        try:
            svc = replica.svc
            if (art.cfg.n_units, art.cfg.dim) == (svc.cfg.n_units,
                                                  svc.cfg.dim):
                svc.swap(art.state, art.unit_labels)
            else:
                opts = dict(self._svc_opts)
                opts.update(unit_labels=art.unit_labels,
                            labeling=art.labeling)
                replica.svc = MapService(art.cfg, art.state, **opts)
        finally:
            with self._cond:
                replica.draining = False
                self._cond.notify_all()

    # ------------------------------------------------------------- plumbing

    @property
    def cfg(self):
        """The served map's config (all replicas agree)."""
        return self._replicas[0].svc.cfg

    @property
    def device(self) -> torch.device:
        """Where the replicas serve."""
        return self._svc_opts["device"]

    @property
    def version(self) -> int | None:
        """The store version currently served (None when not store-backed)."""
        return self._version  # lint: unlocked-ok(single ref read)

    @property
    def replicas(self) -> int:
        return len(self._replicas)

    def services(self) -> list[MapService]:
        """The live replica services (read-only view for stats/tests)."""
        return [r.svc for r in self._replicas]

    def replica_stats(self) -> list[dict]:
        """Routing/health accounting per replica, for dashboards."""
        with self._cond:
            now = time.monotonic()
            return [{"outstanding": r.outstanding, "served_total":
                     r.svc.stats.requests, "ewma_ms":
                     None if r.ewma is None else r.ewma * 1e3,
                     "ejected": r.ejected_until > now,
                     "draining": r.draining} for r in self._replicas]

    def merged_engine_latency(self) -> LatencyHistogram:
        """All replicas' engine-span histograms folded into one."""
        merged = LatencyHistogram()
        for replica in self._replicas:
            merged.merge(replica.svc.stats.latency)
        return merged

    def outstanding(self) -> int:
        with self._cond:
            return self._outstanding

    def __repr__(self):
        version = self._version  # lint: unlocked-ok(stale ok in repr)
        st = self.stats  # lint: unlocked-ok(stale counters ok in repr)
        return (f"MapFleet(replicas={self.replicas}, side={self.cfg.side}, "
                f"dim={self.cfg.dim}, version={version}, "
                f"max_outstanding={self.max_outstanding}, "
                f"completed={st.completed}, "
                f"sheds={st.sheds})")
