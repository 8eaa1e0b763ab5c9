"""MapService: batched inference serving for trained topographic maps, port
of ``repro.serving.maps``.

The paper decouples training from use; this module is the "use" half. Three
layers:

``CompileCache``
    A process-wide record of the bucketed search's signatures, keyed
    ``(bucket, n_units, dim, precision, device)``. JAX compiles the search
    once per signature; the port's ``bmu`` kernel (``kernels/bmu/bmu.cu``)
    has no per-shape compile (its plan is made at each launch), so the
    cache records each signature's first use. ``trace_count`` counts those,
    which keeps JAX's "once per (bucket, map shape) for the whole process"
    contract testable, and ``dispatches`` counts the calls under each.

``BmuEngine``
    The shared batched-inference hot path: requests are cut into chunks of
    at most the top bucket, and each chunk is one call of the ``bmu``
    wrapper on exactly its rows, recorded under the smallest bucket that
    holds it. ``TopoMap.transform`` / ``predict`` run on this same engine.

``MapService``
    A serving front end over one map: ``transform`` / ``predict`` /
    ``quantization_error`` / ``u_matrix`` endpoints, request statistics,
    and **hot online updates**: ``update`` advances the served map by one
    ``partial_fit``-style training step and atomically swaps the new state
    in (readers always see a consistent map; in-flight requests finish on
    the old weights). Construct from a fitted estimator, an artifact
    directory, or a ``MapStore`` entry (``repro_torch.api.persistence``).

The engine pads nothing: JAX pads a chunk up to its bucket to bound its
compiles, and the port has no compile to bound. It captures no CUDA graph
either: a graph of the wrapper needs fixed buffers, and copying the
weights, the request and the answer through them cost a batch-1 request
more on the card and on the host than the wrapper's own two launches do
(PERF.md, "Where the time goes").

``repro_torch.serving.gateway.MapGateway`` fronts many services and
coalesces concurrent requests into bucket-sized dispatches.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time

import numpy as np
import torch

from repro_torch.core import metrics
from repro_torch.core.afm import AFMConfig, AFMState
from repro_torch.device import resolve_device
from repro_torch.draws import GeneratorDraws
from repro_torch.kernels.bmu import ops as bmu_ops

#: Requests larger than the top bucket are chunked by it; each chunk is
#: recorded under the smallest bucket that holds it, so the signature count
#: stays at four whatever the request sizes.
DEFAULT_BUCKETS = (8, 64, 512, 4096)

#: Lock-discipline declarations (checked by ``repro_torch.analysis.locks``,
#: REP301): every ``self.<attr>`` access outside ``with self.<lock>`` is a
#: finding unless annotated ``# lint: unlocked-ok(reason)``. ``__init__`` is
#: exempt (construction happens-before sharing).
GUARDED_BY = {
    "CompileCache": {"keys": "_lock", "trace_count": "_lock",
                     "dispatches": "_lock"},
    "BmuEngine": {"trace_count": "_counter_lock"},
    "LatencyHistogram": {"_counts": "_lock", "count": "_lock",
                         "total_seconds": "_lock"},
    "MapService": {"_state": "_lock", "_unit_labels": "_lock",
                   "stats": "_lock", "_update_backend": "_update_lock",
                   "_draws": "_update_lock"},
}


class CompileCache:
    """Process-wide record of the bucketed BMU search's signatures.

    Keys are ``(bucket, n_units, dim, precision, device)``. ``trace_count``
    counts first uses of a key (JAX's compiles), ``keys`` records every
    key, and ``dispatches`` maps each key to its calls of the ``bmu``
    wrapper (on the card each one kernel launch, which
    ``kernels.bmu.ops.launches`` counts too).

    ``GLOBAL_COMPILE_CACHE`` is the default shared by every ``BmuEngine``
    (and therefore every ``TopoMap`` / ``MapService`` / ``MapGateway`` in
    the process); pass a fresh instance for isolated accounting.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.keys: set[tuple] = set()
        self.trace_count = 0
        self.dispatches: dict[tuple, int] = {}

    def record(self, key: tuple) -> bool:
        """Count one dispatch under ``key``; True for exactly one caller per
        key, ever (the first), so engines can count the signatures they
        introduced without racing on concurrent cold dispatches."""
        with self._lock:
            self.dispatches[key] = self.dispatches.get(key, 0) + 1
            if key in self.keys:
                return False
            self.trace_count += 1
            self.keys.add(key)
            return True


#: Default process-wide cache; see ``CompileCache``.
GLOBAL_COMPILE_CACHE = CompileCache()


class BmuEngine:
    """Bucketed exact-BMU search over a dense map.

    ``precision`` picks the ``bmu`` kernel's distance tier (``'exact'``,
    the default, or ``'bf16'``); the device of the weights picks between
    the kernel and its plain version, as ``kernels.bmu.ops`` does.
    Signatures are recorded in ``cache`` (the process-wide
    ``GLOBAL_COMPILE_CACHE`` by default), so same-shape engines share them.

    ``trace_count`` counts the signatures *this engine* introduced (keys
    other engines used first don't inflate it).
    """

    def __init__(self, *, buckets=DEFAULT_BUCKETS, precision: str = "exact",
                 cache: CompileCache | None = None):
        if precision not in bmu_ops.PRECISIONS:
            raise ValueError(f"precision must be one of "
                             f"{bmu_ops.PRECISIONS}, got {precision!r}")
        buckets = tuple(sorted({int(b) for b in buckets}))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")
        self.buckets = buckets
        self.precision = precision
        self.cache = cache if cache is not None else GLOBAL_COMPILE_CACHE
        self.trace_count = 0      # signatures introduced by this engine
        self._counter_lock = threading.Lock()

    def _plan(self, cap: int | None) -> tuple[int, ...]:
        """The bucket ladder under an optional chunk ``cap``.

        ``cap`` clamps the largest chunk to the biggest ladder bucket
        ``<= cap``, never to ``cap`` itself, so every dispatch reuses an
        existing bucket signature and no ``cap`` value can append an
        oversized bucket or a fresh signature. A ``cap`` below the smallest
        bucket still cuts chunks of the smallest (the ladder floor).
        """
        if cap is None:
            return self.buckets
        cap = max(1, int(cap))
        eligible = tuple(b for b in self.buckets if b <= cap)
        return eligible or self.buckets[:1]

    def bmu(self, w, data, *, cap: int | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
        """argmin_j |w_j - s_i|^2 for a (B, D) request of any B.

        Returns (idx (B,) int32, q2 (B,) float32) on the device of ``w``.
        ``cap`` bounds the largest chunk (the ``chunk=`` escape hatch for
        memory ceilings); it is clamped into the bucket ladder (``_plan``).
        """
        w = torch.as_tensor(w, dtype=torch.float32)
        data = torch.as_tensor(data, dtype=torch.float32, device=w.device)
        if data.dim() != 2:
            raise ValueError(f"expected (B, D) request, got shape "
                             f"{tuple(data.shape)}")
        if data.shape[1] != w.shape[1]:
            raise ValueError(f"request has D={data.shape[1]}, the map "
                             f"D={w.shape[1]}")
        n = data.shape[0]
        if n == 0:
            return (torch.zeros((0,), dtype=torch.int32, device=w.device),
                    torch.zeros((0,), dtype=torch.float32, device=w.device))
        w = w.contiguous()
        buckets = self._plan(cap)
        idxs, q2s = [], []
        for pos in range(0, n, buckets[-1]):
            block = data[pos:pos + buckets[-1]].contiguous()
            bucket = next(b for b in buckets if b >= block.shape[0])
            key = (bucket, w.shape[0], w.shape[1], self.precision,
                   str(w.device))
            if self.cache.record(key):
                with self._counter_lock:
                    self.trace_count += 1
            idx, q2 = bmu_ops.bmu(w, block, precision=self.precision)
            idxs.append(idx)
            q2s.append(q2)
        if len(idxs) == 1:
            return idxs[0], q2s[0]
        return torch.cat(idxs), torch.cat(q2s)


class LatencyHistogram:
    """Streaming latency percentiles over fixed log-spaced buckets.

    SLO percentiles (p50/p95/p99) without an unbounded request log: spans
    land in one of ``n_buckets`` geometrically spaced buckets covering
    ``[lo, hi)`` seconds (default 1 µs .. 100 s, so every bucket is the
    same ~±15% wide in relative terms), plus an overflow bucket. A
    percentile reads back the **upper edge** of the bucket holding that
    quantile: conservative by at most one bucket width, monotone in the
    quantile, and always > 0 for a non-empty histogram, so
    ``p99 >= p50 > 0`` holds by construction.

    Thread-safe: ``record`` / ``merge`` / readers all take the instance
    lock, and replica histograms merge into fleet-wide ones with ``merge``
    (bucket-wise integer adds: merging never loses precision, unlike
    merging precomputed percentiles).
    """

    N_BUCKETS = 128
    LO = 1e-6     # seconds; spans below land in bucket 0
    HI = 100.0    # seconds; spans at/above land in the overflow bucket

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = [0] * (self.N_BUCKETS + 1)   # +1: overflow
        self._scale = self.N_BUCKETS / math.log(self.HI / self.LO)
        self.count = 0
        self.total_seconds = 0.0

    def _bucket(self, seconds: float) -> int:
        if seconds < self.LO:
            return 0
        if seconds >= self.HI:
            return self.N_BUCKETS
        return min(int(math.log(seconds / self.LO) * self._scale),
                   self.N_BUCKETS - 1)

    def _edge(self, bucket: int) -> float:
        """Upper edge of ``bucket`` in seconds (HI for the overflow)."""
        return self.LO * math.exp((min(bucket, self.N_BUCKETS - 1) + 1)
                                  / self._scale)

    def record(self, seconds: float) -> None:
        with self._lock:
            self._counts[self._bucket(seconds)] += 1
            self.count += 1
            self.total_seconds += seconds

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold ``other``'s buckets into this histogram (returns self)."""
        with other._lock:
            counts = list(other._counts)
            n, total = other.count, other.total_seconds
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self.count += n
            self.total_seconds += total
        return self

    def percentile(self, q: float) -> float:
        """Seconds at quantile ``q`` in [0, 1]; 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = max(1, math.ceil(q * self.count))
            seen = 0
            for bucket, c in enumerate(self._counts):
                seen += c
                if seen >= rank:
                    return self._edge(bucket)
        return self.HI                      # unreachable; counts sum to count

    def mean(self) -> float:
        with self._lock:
            return self.total_seconds / self.count if self.count else 0.0

    def quantiles(self) -> dict[str, float]:
        """The SLO trio, in seconds: ``{"p50": ..., "p95": ..., "p99": ...}``."""
        return {"p50": self.percentile(0.50), "p95": self.percentile(0.95),
                "p99": self.percentile(0.99)}

    def summary(self, unit: float = 1e3) -> str:
        """One-line human summary (default unit: milliseconds)."""
        qs = self.quantiles()
        n = self.count  # lint: unlocked-ok(single int read, display only)
        return (f"p50={qs['p50'] * unit:.2f} p95={qs['p95'] * unit:.2f} "
                f"p99={qs['p99'] * unit:.2f} (n={n})")

    def __repr__(self):
        return f"LatencyHistogram({self.summary()})"


@dataclasses.dataclass
class ServiceStats:
    """Rolling counters for one ``MapService``.

    Two clocks, because concurrent requests overlap:

    ``busy_seconds``
        Summed per-request engine spans (dispatch + device time, lock wait
        excluded). Under concurrency the spans overlap, so this can exceed
        wall time: it measures work attributed, not elapsed.
    ``window_seconds()``
        The wall-clock window from the first request's start to the latest
        request's end. ``throughput()`` divides by this, so it stays honest
        under concurrent load; ``busy_throughput()`` is the per-request
        serial rate.

    ``latency`` is a ``LatencyHistogram`` of per-request engine spans
    (same clock as ``busy_seconds``): p50/p95/p99 without a request log,
    mergeable across replicas (``repro_torch.serving.fleet``).
    """
    requests: int = 0
    samples: int = 0
    busy_seconds: float = 0.0
    updates: int = 0
    swaps: int = 0
    window_start: float | None = None
    window_end: float | None = None
    latency: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)

    @property
    def seconds(self) -> float:
        """Alias of ``busy_seconds``."""
        return self.busy_seconds

    def window_seconds(self) -> float:
        if self.window_start is None or self.window_end is None:
            return 0.0
        return self.window_end - self.window_start

    def throughput(self) -> float:
        """Samples/s over the wall-clock request window."""
        w = self.window_seconds()
        return self.samples / w if w > 0 else 0.0

    def busy_throughput(self) -> float:
        """Samples/s per second of attributed engine time."""
        return (self.samples / self.busy_seconds
                if self.busy_seconds > 0 else 0.0)


class _Unset:
    pass


_UNSET = _Unset()


def postprocess(side: int, kind: str, lattice: bool, idx, q2, labels, *,
                xp=torch):
    """One request's endpoint view of a BMU dispatch (idx, q2, labels).

    The single postprocessing implementation behind both ``MapService``
    endpoints (``xp=torch``) and the gateway's numpy-native coalesced
    dispatches (``xp=np``), so predict/lattice/QE semantics and error
    messages cannot drift between the two surfaces.
    """
    if kind == "predict":
        if labels is None:
            raise RuntimeError("predict endpoint needs unit labels — serve a "
                               "labelled map or swap labels in")
        return labels[idx.long() if xp is torch else idx]
    if kind == "quantization_errors":
        return xp.sqrt(q2)
    if kind != "transform":
        raise ValueError(f"unknown endpoint kind {kind!r}")
    if lattice:
        return xp.stack([idx // side, idx % side], -1)
    return idx


def wait_for(t: torch.Tensor) -> torch.Tensor:
    """``t`` once the work that computes it has finished (the current
    stream synchronised on CUDA), the counterpart of
    ``jax.block_until_ready``."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return t


def to_numpy(x):
    """A host numpy array of a tensor (copied off the card) or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def state_on(state: AFMState, device: torch.device) -> AFMState:
    """``state`` with its tensors on ``device`` (no copy where they are)."""
    return AFMState(*(torch.as_tensor(getattr(state, f)).to(device)
                      for f in ("w", "c", "far", "near")), i=int(state.i))


class MapService:
    """Batched-inference service over one trained map.

    State (``AFMState`` + optional unit labels) lives behind an atomic
    swap: endpoints snapshot it once per request, ``swap``/``update``
    replace it wholesale, so readers never observe a half-updated map.
    Because the engine's signatures are keyed on shapes only, swapping
    same-shape weights never adds one.

    Pass ``engine`` to share one ``BmuEngine`` (and its signature count)
    across services; by default each service gets its own engine, which
    still shares signatures through the process-wide ``CompileCache``.
    ``device`` is where the map is served (CUDA unless the caller asks for
    the CPU); ``update`` runs ``update_backend`` there, drawing from a
    ``GeneratorDraws(seed)`` unless it is handed ``draws``.
    """

    def __init__(self, cfg: AFMConfig, state: AFMState, *,
                 unit_labels=None, labeling: str = "nearest",
                 buckets=DEFAULT_BUCKETS, precision: str = "exact",
                 engine: BmuEngine | None = None,
                 update_backend: str = "batched",
                 update_backend_options: dict | None = None, seed: int = 0,
                 device: torch.device | str | None = None):
        self._validate_state(cfg, state)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.labeling = labeling
        self.engine = engine if engine is not None else BmuEngine(
            buckets=buckets, precision=precision)
        self.stats = ServiceStats()
        self._state = state_on(state, self.device)
        self._unit_labels = self._validate_labels(cfg, unit_labels,
                                                  self.device)
        self._lock = threading.Lock()           # guards the state snapshot
        # serialises writers (update and external swap) against each other so
        # an update's read-step-swap can't silently overwrite a concurrent
        # swap; re-entrant because update() calls swap() while holding it
        self._update_lock = threading.RLock()
        self._update_backend_name = update_backend
        self._update_backend_options = dict(update_backend_options or {})
        self._update_backend = None
        self._draws = GeneratorDraws(seed, self.device)

    # --------------------------------------------------------- constructors

    @classmethod
    def from_estimator(cls, tm, **kwargs) -> "MapService":
        """Serve a fitted ``TopoMap`` (shares no mutable state with it).

        The estimator's engine precision and device carry over, so the
        service's BMU path is bit-identical to ``tm.transform`` (and,
        through the shared ``CompileCache``, reuses its signatures).
        """
        kwargs.setdefault("labeling", tm.labeling)
        kwargs.setdefault("precision", tm.engine.precision)
        kwargs.setdefault("device", tm.device)
        return cls(tm.cfg, tm.state_, unit_labels=tm.unit_labels_, **kwargs)

    @classmethod
    def from_artifact(cls, path: str, **kwargs) -> "MapService":
        """Serve a saved artifact directory (``TopoMap.save`` output)."""
        from repro_torch.api import persistence
        art = persistence.load_artifact(path, device=kwargs.get("device"))
        kwargs.setdefault("labeling", art.labeling)
        return cls(art.cfg, art.state, unit_labels=art.unit_labels, **kwargs)

    @classmethod
    def from_store(cls, root: str, spec: str, **kwargs) -> "MapService":
        """Serve ``name[@version]`` out of a ``MapStore`` directory."""
        from repro_torch.api import persistence
        return cls.from_artifact(persistence.MapStore(root).path(spec),
                                 **kwargs)

    # ------------------------------------------------------------ endpoints

    def serve_bmu(self, data) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor | None]:
        """One snapshot-consistent BMU dispatch: (idx, q2, unit_labels).

        The building block under every read endpoint (and the gateway's
        coalesced dispatches): weights and labels come from a single
        snapshot, so the triple is consistent even when a swap lands
        mid-request.
        """
        state, labels = self.snapshot()
        idx, q2 = self._serve(state.w, data)
        return idx, q2, labels

    def transform(self, data, *, lattice: bool = False) -> torch.Tensor:
        """BMU projection: (B,) flat unit indices, or (B, 2) lattice
        coordinates when ``lattice=True``."""
        idx, q2, labels = self.serve_bmu(data)
        return postprocess(self.cfg.side, "transform", lattice, idx, q2,
                           labels)

    def predict(self, data) -> torch.Tensor:
        """Classify each sample with its BMU's unit label."""
        # one snapshot: weights and labels are always from the same map
        # version, even when a swap lands mid-request
        idx, q2, labels = self.serve_bmu(data)
        return postprocess(self.cfg.side, "predict", False, idx, q2, labels)

    def quantization_errors(self, data) -> torch.Tensor:
        """(B,) per-sample Euclidean distance of each sample to its BMU."""
        idx, q2, labels = self.serve_bmu(data)
        return postprocess(self.cfg.side, "quantization_errors", False, idx,
                           q2, labels)

    def quantization_error(self, data) -> float:
        """Mean Euclidean distance of the request batch to its BMUs."""
        return float(torch.mean(self.quantization_errors(data)))

    def u_matrix(self) -> torch.Tensor:
        """(side, side) mean neighbour distance of the served map."""
        state, _ = self.snapshot()
        return metrics.u_matrix(state.w, self.cfg.side)

    def _serve(self, w, data):
        t0 = time.perf_counter()
        idx, q2 = self.engine.bmu(w, data)
        wait_for(idx)
        t1 = time.perf_counter()          # span ends before any lock wait
        with self._lock:
            st = self.stats
            st.requests += 1
            st.samples += int(idx.shape[0])
            st.busy_seconds += t1 - t0
            st.window_start = t0 if st.window_start is None else min(
                st.window_start, t0)
            st.window_end = t1 if st.window_end is None else max(
                st.window_end, t1)
        st.latency.record(t1 - t0)
        return idx, q2

    # --------------------------------------------------------- live updates

    def snapshot(self) -> tuple[AFMState, torch.Tensor | None]:
        """Consistent (state, unit_labels) view of the served map."""
        with self._lock:
            return self._state, self._unit_labels

    def swap(self, state: AFMState, unit_labels=_UNSET) -> None:
        """Atomically replace the served map (and optionally its labels).

        The new state must match the served (n_units, dim) so that the
        engine's signatures, and the meaning of unit indices, survive the
        swap.
        """
        self._validate_state(self.cfg, state)
        state = state_on(state, self.device)
        if unit_labels is not _UNSET:
            unit_labels = self._validate_labels(self.cfg, unit_labels,
                                                self.device)
        with self._update_lock:
            with self._lock:
                self._state = state
                if unit_labels is not _UNSET:
                    self._unit_labels = unit_labels
                self.stats.swaps += 1

    def update(self, batch, *, draws=None):
        """Hot online update: one ``partial_fit`` training step on the
        served state, swapped in atomically. Returns the step's aux.

        The step draws from the service's ``GeneratorDraws(seed)`` unless
        ``draws`` is given. Unit labels are kept as-is (swap new ones in via
        ``swap`` after relabeling offline). Updates are serialised;
        inference is never blocked beyond the final swap.
        """
        batch = torch.as_tensor(batch, dtype=torch.float32,
                                device=self.device).contiguous()
        with self._update_lock:
            if draws is None:
                draws = self._draws
            backend = self._backend()
            state, _ = self.snapshot()
            new_state, aux = backend.step(backend.from_dense(state), batch,
                                          draws)
            self.swap(backend.to_dense(new_state))
            with self._lock:
                self.stats.updates += 1
        return aux

    def _backend(self):
        # re-entrant: update() already holds _update_lock when it calls this
        with self._update_lock:
            if self._update_backend is None:
                from repro_torch.api import backends as backends_lib
                self._update_backend = backends_lib.get_backend(
                    self._update_backend_name, self.cfg, device=self.device,
                    **self._update_backend_options)
            return self._update_backend

    # ------------------------------------------------------------- plumbing

    @property
    def compiles(self) -> int:
        """How many (bucket, map-shape) signatures this service introduced."""
        return self.engine.trace_count

    @staticmethod
    def _validate_state(cfg: AFMConfig, state: AFMState) -> None:
        n = cfg.n_units
        want = {"w": (n, cfg.dim), "c": (n,), "far": (n, cfg.phi),
                "near": (n, 4)}
        for field, shape in want.items():
            got = tuple(getattr(state, field).shape)
            if got != shape:
                raise ValueError(f"state {field} shape {got} does not match "
                                 f"config {shape}")

    @staticmethod
    def _validate_labels(cfg: AFMConfig, unit_labels, device):
        if unit_labels is None:
            return None
        unit_labels = torch.as_tensor(unit_labels).to(device=device,
                                                      dtype=torch.int32)
        if tuple(unit_labels.shape) != (cfg.n_units,):
            raise ValueError(f"unit_labels shape {tuple(unit_labels.shape)} "
                             f"!= ({cfg.n_units},)")
        return unit_labels

    def __repr__(self):
        labels = self._unit_labels  # lint: unlocked-ok(display-only read)
        served = self.stats.samples  # lint: unlocked-ok(stale ok in repr)
        labelled = "labelled" if labels is not None else "unlabelled"
        return (f"MapService(side={self.cfg.side}, dim={self.cfg.dim}, "
                f"{labelled}, buckets={self.engine.buckets}, "
                f"device={self.device}, served={served})")
