"""Runtime verification: TraceGuard and LockOrderRecorder.

``TraceGuard`` asserts how many *new* signatures a block is allowed to
introduce: the port's counterpart of a recompile counter. It reads the
port's counters: ``trace_count`` of ``serving.maps.CompileCache`` and
``BmuEngine`` (first uses of a (bucket, map shape) signature, JAX's
compiles) and ``MapService.compiles``.

``LockOrderRecorder`` wraps lock/condition attributes on live objects and
records, per thread, which locks were held when each lock was acquired.
``assert_no_inversions()`` then checks the resulting acquisition-order
graph for cycles — the static signature of an AB/BA deadlock between
Service/Gateway/Fleet — without having to actually hit the interleaving.
It is a copy of ``repro.analysis.runtime``'s.
"""

from __future__ import annotations

import threading


def _compile_count(source) -> int:
    """Read a signature counter from the port's counter idioms."""
    tc = getattr(source, "trace_count", None)
    if tc is not None:
        return int(tc)
    compiles = getattr(source, "compiles", None)
    if compiles is not None:
        return int(compiles)
    raise TypeError(
        f"TraceGuard source {source!r} exposes none of trace_count / "
        "compiles"
    )


class TraceGuard:
    """Assert a block introduces a bounded number of new signatures.

    ::

        with TraceGuard(engine, cache, max_new=0):
            svc.serve_bmu(batch)          # steady state: no recompiles

        with TraceGuard(engine, expect=2) as tg:
            engine.bmu(x)                 # exactly the two ladder buckets
        assert tg.new_compiles == 2

    Sources may be anything exposing ``trace_count`` (``BmuEngine``,
    ``CompileCache``) or ``compiles`` (``MapService``). ``expect=``
    asserts an exact count;
    ``max_new=`` (default 0) asserts an upper bound. The guard is
    reentrant-safe and does not swallow exceptions raised in the block.
    """

    def __init__(self, *sources, max_new: int = 0, expect: int | None = None):
        if not sources:
            raise ValueError("TraceGuard needs at least one counter source")
        self._sources = sources
        self._max_new = max_new
        self._expect = expect
        self._start: list[int] | None = None

    @property
    def new_compiles(self) -> int:
        if self._start is None:
            raise RuntimeError("TraceGuard not entered")
        return sum(
            _compile_count(s) - s0
            for s, s0 in zip(self._sources, self._start)
        )

    def __enter__(self) -> "TraceGuard":
        self._start = [_compile_count(s) for s in self._sources]
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            return False
        n = self.new_compiles
        detail = ", ".join(
            f"{type(s).__name__}:{_compile_count(s) - s0:+d}"
            for s, s0 in zip(self._sources, self._start or [])
        )
        if self._expect is not None:
            assert n == self._expect, (
                f"expected exactly {self._expect} new compile(s), "
                f"saw {n} ({detail})"
            )
        else:
            assert n <= self._max_new, (
                f"unexpected recompile: {n} new trace(s) > allowed "
                f"{self._max_new} ({detail})"
            )
        return False


class _LockProxy:
    """Wraps a Lock/RLock/Condition, reporting acquisitions to a recorder.

    Supports the ``with`` protocol plus the Condition API (``wait``,
    ``wait_for``, ``notify``, ``notify_all``); anything else delegates to
    the wrapped object.
    """

    def __init__(self, recorder: "LockOrderRecorder", name: str, inner):
        self._recorder = recorder
        self._name = name
        self._inner = inner

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._recorder._note_acquire(self._name)
        return got

    def release(self):
        self._recorder._note_release(self._name)
        return self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    # Condition API. ``wait`` drops and reacquires the underlying lock,
    # but for ordering purposes the caller still "owns" it — a second
    # lock acquired while waiting would be a hazard regardless.
    def wait(self, timeout=None):
        return self._inner.wait(timeout)

    def wait_for(self, predicate, timeout=None):
        return self._inner.wait_for(predicate, timeout)

    def notify(self, n=1):
        return self._inner.notify(n)

    def notify_all(self):
        return self._inner.notify_all()

    def locked(self):
        return self._inner.locked()

    def __getattr__(self, item):
        return getattr(self._inner, item)


class LockOrderRecorder:
    """Record cross-thread lock acquisition order; flag inversions.

    ::

        rec = LockOrderRecorder()
        rec.wrap(svc, "_lock")
        rec.wrap(svc, "_update_lock")
        rec.wrap(fleet, "_cond")
        ... run the hammer test ...
        rec.assert_no_inversions()

    Every ``A held while acquiring B`` observation adds the edge A->B.
    A cycle in that graph means two threads can acquire the same pair of
    locks in opposite orders — the precondition for deadlock.
    """

    def __init__(self) -> None:
        self._edges: dict[str, set[str]] = {}
        self._meta = threading.Lock()
        self._local = threading.local()

    def wrap(self, obj, attr: str, name: str | None = None) -> _LockProxy:
        """Replace ``obj.attr`` with a recording proxy; returns the proxy."""
        inner = getattr(obj, attr)
        label = name or f"{type(obj).__name__}.{attr}"
        if isinstance(inner, _LockProxy):
            return inner
        proxy = _LockProxy(self, label, inner)
        setattr(obj, attr, proxy)
        return proxy

    def _held(self) -> dict[str, int]:
        held = getattr(self._local, "held", None)
        if held is None:
            held = {}
            self._local.held = held
        return held

    def _note_acquire(self, name: str) -> None:
        held = self._held()
        with self._meta:
            for other, depth in held.items():
                if depth > 0 and other != name:
                    self._edges.setdefault(other, set()).add(name)
        held[name] = held.get(name, 0) + 1

    def _note_release(self, name: str) -> None:
        held = self._held()
        if held.get(name, 0) > 0:
            held[name] -= 1

    def edges(self) -> dict[str, set[str]]:
        with self._meta:
            return {k: set(v) for k, v in self._edges.items()}

    def find_cycle(self) -> list[str] | None:
        """Return one lock-order cycle as [A, B, ..., A], or None."""
        graph = self.edges()
        WHITE, GREY, BLACK = 0, 1, 2
        color = {n: WHITE for n in graph}
        stack: list[str] = []

        def dfs(node: str) -> list[str] | None:
            color[node] = GREY
            stack.append(node)
            for nxt in sorted(graph.get(node, ())):
                c = color.get(nxt, WHITE)
                if c == GREY:
                    return stack[stack.index(nxt) :] + [nxt]
                if c == WHITE:
                    found = dfs(nxt)
                    if found:
                        return found
            color[node] = BLACK
            stack.pop()
            return None

        for start in sorted(graph):
            if color.get(start, WHITE) == WHITE:
                cycle = dfs(start)
                if cycle:
                    return cycle
        return None

    def assert_no_inversions(self) -> None:
        cycle = self.find_cycle()
        if cycle is not None:
            order = " -> ".join(cycle)
            raise AssertionError(
                f"lock-order inversion (deadlock hazard): {order}; "
                f"observed edges: "
                + "; ".join(
                    f"{a}->{','.join(sorted(bs))}"
                    for a, bs in sorted(self.edges().items())
                )
            )
