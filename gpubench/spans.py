"""The program's own spans in a traced window: the ``record_function``
ranges ``repro_torch::<name>`` that the port opens at its layer
boundaries (``repro_torch.analysis.spans``), read from the same kineto
events as ``trace.summarise``.

- ``span_s``: name -> **self** device seconds. Each kernel, memcpy and
  memset counts once, in the innermost span open at its launch call
  (``""``: outside every span, or no launch call in the trace). The values
  add up to the summed device time (durations, not their union).
- ``span_ops``: name -> {device op name: self seconds}, the same split by
  what ran.
- ``span_syncs``: name -> the host-blocking runtime calls (``SYNCS``)
  made in it. Calls outside every span, such as the closing synchronise of
  ``profile``, are left out.
- ``span_idle_s``: name -> device-idle seconds of the trace, each idle
  interval cut piece by piece by the innermost span open during it
  (``""``: outside every span). The trace runs from its first event's
  start to its last's end; the values add up to that length less the
  union of the device intervals.

Innermost means the shortest span holding the instant, on any host
thread: the step is serial, so a backward kernel launched on autograd's
thread lands in its layer's ``<layer>.backward`` span where one is open,
and in the step's span otherwise.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import time

import torch

from gpubench import trace

PREFIX = "repro_torch::"
SYNCS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize",
    "cuEventSynchronize", "cuMemcpy", "cuMemcpyDtoH", "cuMemcpyHtoD"})


@dataclasses.dataclass
class Spans:
    span_s: dict          # span -> self device seconds ("" outside)
    span_ops: dict        # span -> {device op name: self seconds}
    span_syncs: dict      # span -> host-blocking calls
    span_idle_s: dict     # span -> device-idle seconds ("" outside)


def _pieces(spans: list, t0: int, t1: int):
    """(starts, ends, names): [t0, t1) cut where the innermost span
    changes, each piece named by it ("" where none is open)."""
    cuts = sorted({t0, t1, *(c for a, b, _ in spans for c in (a, b)
                             if t0 < c < t1)})
    order = sorted(spans)
    heap, k = [], 0
    starts, ends, names = [], [], []
    for a, b in zip(cuts, cuts[1:]):
        while k < len(order) and order[k][0] <= a:
            s, e, name = order[k]
            heapq.heappush(heap, (e - s, s, e, name))
            k += 1
        while heap and heap[0][2] <= a:        # ended: never open again
            heapq.heappop(heap)
        name = heap[0][3] if heap else ""
        if names and names[-1] == name:
            ends[-1] = b
        else:
            starts.append(a)
            ends.append(b)
            names.append(name)
    return starts, ends, names


def read(kineto_events) -> Spans:
    """The spans' readings of the profiler's events
    (``prof.profiler.kineto_results.events()``)."""
    spans, dev, syncs, call_at = [], [], [], {}
    t0 = t1 = None
    for e in kineto_events:
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        t0 = a if t0 is None else min(t0, a)
        t1 = b if t1 is None else max(t1, b)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((a, b, e.correlation_id(),
                            e.linked_correlation_id(), name))
        elif name.startswith(PREFIX):
            if b > a:
                spans.append((a, b, name[len(PREFIX):]))
        elif name.startswith("cu"):             # a CUDA API call
            call_at[e.correlation_id()] = a
            if name in SYNCS:
                syncs.append(a)
    if t0 is None:
        return Spans({}, {}, {}, {})
    starts, ends, names = _pieces(spans, t0, t1)

    def at(t):
        k = bisect.bisect_right(starts, t) - 1
        return names[k] if k >= 0 and t < ends[k] else ""

    span_ns = {}
    for a, b, corr, linked, name in dev:
        t = call_at.get(corr, call_at.get(linked))
        ops = span_ns.setdefault("" if t is None else at(t), {})
        ops[name] = ops.get(name, 0) + (b - a)
    span_syncs = {}
    for t in syncs:
        key = at(t)
        if key:
            span_syncs[key] = span_syncs.get(key, 0) + 1
    idle, prev = [], t0
    for a, b in trace._merge([(a, b) for a, b, *_ in dev]):
        if a > prev:
            idle.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        idle.append((prev, t1))
    idle_ns, k = {}, 0
    for a, b in idle:
        while ends[k] <= a:
            k += 1
        j = k
        while j < len(starts) and starts[j] < b:
            piece = min(b, ends[j]) - max(a, starts[j])
            idle_ns[names[j]] = idle_ns.get(names[j], 0) + piece
            j += 1
    return Spans(span_s={k: sum(v.values()) * 1e-9
                         for k, v in span_ns.items()},
                 span_ops={k: {n: t * 1e-9 for n, t in v.items()}
                           for k, v in span_ns.items()},
                 span_syncs=span_syncs,
                 span_idle_s={k: v * 1e-9 for k, v in idle_ns.items()})


def profile(fn):
    """``trace.profile``'s window, read by both ``trace.summarise`` and
    ``read``: ``fn()``'s result, the ``trace.Summary`` and the ``Spans``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    return out, trace.summarise(events, window), read(events)
