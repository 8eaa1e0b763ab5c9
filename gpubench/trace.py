"""The traced window: ``torch.profiler`` over a callable, reduced to what
the per-layer readers read.

- device intervals: every kernel, memcpy and memset on the card; busy time
  is their union, so overlapping work counts once;
- launches: the launch API calls the host made (``cudaLaunchKernel``,
  ``cuLaunchKernel``, ``cuLaunchKernelEx``, ``cudaLaunchKernelExC``,
  ``cudaLaunchCooperativeKernel``);
- ranges: the device time of the work launched inside each of the
  harness's ``record_function`` ranges (``gpubench::<name>``), a kernel
  counted in the range whose span holds its launch call;
- the breakdown: the device operations that took most time, and the
  longest gaps between device intervals, each named by the innermost host
  operation under way at the gap's middle.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import time

import torch

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel")
RANGE_PREFIX = "gpubench::"


@contextlib.contextmanager
def ranges(targets: dict):
    """Wraps each ``(module, attribute)`` of ``targets`` (name -> pair) in
    a ``record_function`` range ``gpubench::<name>`` while the block runs,
    and puts the originals back after it."""
    saved = []
    try:
        for name, (module, attr) in targets.items():
            fn = getattr(module, attr)
            saved.append((module, attr, fn))

            @functools.wraps(fn)
            def wrapped(*args, __fn=fn, __name=RANGE_PREFIX + name, **kw):
                with torch.profiler.record_function(__name):
                    return __fn(*args, **kw)

            setattr(module, attr, wrapped)
        yield
    finally:
        for module, attr, fn in reversed(saved):
            setattr(module, attr, fn)


@dataclasses.dataclass
class Summary:
    window_s: float                 # host clock, the callable and a sync
    busy_s: float                   # union of device intervals
    launches: int
    device_ops: list                # [(name, seconds)], most time first
    idle_gaps: list                 # [(name, seconds)], longest first
    range_s: dict                   # range name -> device seconds
    by_name: dict                   # device op name -> (seconds, count)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(cpu, t):
    """The name of the shortest host op whose span holds ``t``, with the
    harness range around it where there is one."""
    best, rng = None, None
    for a, b, name in cpu:
        if a > t:
            break
        if b >= t:
            if name.startswith(RANGE_PREFIX):
                rng = name
            elif best is None or b - a < best[1] - best[0]:
                best = (a, b, name)
    label = best[2] if best else "host (no op)"
    return f"{rng} > {label}" if rng else label


def summarise(kineto_events, window_s: float, top: int = 10) -> Summary:
    """Reduces the profiler's events (``prof.profiler.kineto_results
    .events()``) of a window of ``window_s`` host seconds."""
    dev, cpu, launch_at, user = [], [], {}, {}
    for e in kineto_events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            name, e.correlation_id(),
                            e.linked_correlation_id()))
            continue
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if name in LAUNCHES:
            launch_at[e.correlation_id()] = a
            continue
        if name.startswith(RANGE_PREFIX):
            user.setdefault(name[len(RANGE_PREFIX):], []).append((a, b))
        if not name.startswith("cuda") and not name.startswith("cu"):
            cpu.append((a, b, name))
    busy = _merge([(a, b) for a, b, *_ in dev])
    by_name = {}
    for a, b, name, *_ in dev:
        s, n = by_name.get(name, (0.0, 0))
        by_name[name] = (s + (b - a) * 1e-9, n + 1)
    gaps = sorted(((b2[0] - b1[1], (b1[1] + b2[0]) // 2)
                   for b1, b2 in zip(busy, busy[1:])), reverse=True)[:top]
    cpu.sort()
    range_s = {}
    for rname, spans in user.items():
        spans.sort()
        starts = [a for a, _ in spans]
        total = 0
        for a, b, _, corr, linked in dev:
            t = launch_at.get(corr, launch_at.get(linked))
            if t is None:
                continue
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and spans[k][0] <= t <= spans[k][1]:
                total += b - a
        range_s[rname] = total * 1e-9
    return Summary(
        window_s=window_s,
        busy_s=sum(b - a for a, b in busy) * 1e-9,
        launches=len(launch_at),
        device_ops=sorted(((k, v[0]) for k, v in by_name.items()),
                          key=lambda kv: -kv[1])[:top],
        idle_gaps=[(_innermost(cpu, mid), g * 1e-9) for g, mid in gaps],
        range_s=range_s, by_name=by_name)


def profile(fn) -> tuple[object, Summary]:
    """Runs ``fn()`` under the profiler (host and card), ended by a
    synchronise; returns its result and the window's summary."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    return out, summarise(prof.profiler.kineto_results.events(), window)
