"""repro_torch.analysis, the port's static checks: the sync check (REP101,
the counterpart of JAX's tracer check), the draw-source check (REP201/202),
the lock check (REP301), the ``torch.compile`` recompile check (REP401/402),
escape hatches, the baseline round trip, the CLI on the committed tree, and
the runtime companions (``TraceGuard`` on the port's counters,
``LockOrderRecorder``).

As in ``tests/test_analysis.py``, each checker meets a known-bad fixture
that must produce its code and a known-good fixture (with every hatch form)
that must come back clean.
"""
import ast
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro_torch.analysis import locks as locks_lib
from repro_torch.analysis import prng as prng_lib
from repro_torch.analysis import retrace as retrace_lib
from repro_torch.analysis import syncs as syncs_lib
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.__main__ import run as analysis_run
from repro_torch.analysis.base import (check_source, load_baseline,
                                       subtract_baseline, write_baseline)
from repro_torch.analysis.runtime import LockOrderRecorder, TraceGuard

ROOT = Path(__file__).resolve().parents[1]
LIB = "src/repro_torch/core/fake.py"     # a "library" path for the checkers
BASELINE = ROOT / "analysis-baseline-torch.json"


def _codes(checker, source, path=LIB):
    return [d.code for d in check_source([checker.check],
                                         textwrap.dedent(source), path)]


# ------------------------------------------------------------------ syncs


#: one loop body per sync form the check knows
SYNC_FORMS = {
    "item": "total += x.item()",
    "tolist": "rows = x.tolist()",
    "cpu": "host = x.cpu()",
    "numpy": "host = x.numpy()",
    "to_cpu": 'host = x.to("cpu")',
    "bool": "flag = bool(x.any())",
    "int": "n = int(x.sum())",
    "float": "v = float(x.max())",
    "if": "if x.sum() > 0:\n                total += 1",
    "ifexp": "total = 1 if x.any() else 0",
    "assert": "assert x.all()",
    "synchronize": "torch.cuda.synchronize()",
}


@pytest.mark.parametrize("form", sorted(SYNC_FORMS))
def test_syncs_flags_each_form_in_a_loop(form):
    src = f"""
    import torch

    def run(xs, steps: int):
        total = 0
        for _ in range(steps):
            x = torch.exp(xs)
            {SYNC_FORMS[form]}
        return total
    """
    assert _codes(syncs_lib, src) == ["REP101"]


@pytest.mark.parametrize("form", sorted(SYNC_FORMS))
def test_syncs_ignores_each_form_outside_hot_code(form):
    """Once a call, not once an iteration: not a hot-loop sync."""
    src = f"""
    import torch

    def once(xs):
        total = 0
        x = torch.exp(xs)
        {SYNC_FORMS[form]}
        return total
    """
    assert _codes(syncs_lib, src) == []


def test_syncs_flags_while_test_and_functions_a_loop_calls():
    src = """
    import torch

    def wave(fired):
        return int(fired.sum())          # hot: the loop below calls it

    def step(fired):
        return wave(fired)               # hot through step

    def cascade(fired, max_waves: int):
        waves = 0
        while waves < max_waves and bool(fired.any()):
            fired = torch.roll(fired, 1)
            waves += 1
        for _ in range(3):
            step(fired)
    """
    diags = check_source([syncs_lib.check], textwrap.dedent(src), LIB)
    assert [(d.code, d.line) for d in diags] == [("REP101", 5),
                                                 ("REP101", 12)]
    assert "hot function `wave`" in diags[0].message


def test_syncs_follows_a_seam_named_in_hot_code():
    src = """
    def wave(c, fired):
        return c + fired.to(c.dtype), bool(fired.any())

    def loop(c, fired, wave_fn):
        for _ in range(4):
            c, more = wave_fn(c, fired)
        return c

    def drive(c, fired):
        for _ in range(2):
            c = loop(c, fired, wave_fn=wave)
        return c
    """
    diags = check_source([syncs_lib.check], textwrap.dedent(src), LIB)
    assert [d.line for d in diags] == [3]


def test_syncs_follows_calls_across_modules():
    """A loop in one module makes a function of another hot, through the
    import (the driver checks the files together)."""
    ops = textwrap.dedent("""
    def finish(fired):
        if bool(fired.any()):
            return 1
        return 0
    """)
    loop = textwrap.dedent("""
    from repro_torch.kernels.toy import ops as toy_ops

    def train(fired, steps: int):
        for _ in range(steps):
            toy_ops.finish(fired)
    """)
    paths = {"src/repro_torch/kernels/toy/ops.py": ops,
             "src/repro_torch/core/toy.py": loop}
    indexes = [syncs_lib.index_module(ast.parse(src), path)
               for path, src in paths.items()]
    hot = syncs_lib.project_hot(indexes)
    assert hot == {"src/repro_torch/kernels/toy/ops.py": {"finish"},
                   "src/repro_torch/core/toy.py": set()}
    found = syncs_lib.check(ast.parse(ops), ops,
                            "src/repro_torch/kernels/toy/ops.py",
                            hot=hot["src/repro_torch/kernels/toy/ops.py"])
    assert [(d.code, d.line) for d in found] == [("REP101", 3)]
    # checked alone, the module has no loop that calls it
    assert _codes(syncs_lib, ops, "src/repro_torch/kernels/toy/ops.py") == []


def test_syncs_allows_metadata_identity_and_host_values():
    src = """
    import numpy as np
    import torch

    def _is_pair(x) -> bool:
        return isinstance(x, tuple) and len(x) == 2

    def run(xs, n: int, scale: float, gmu=None):
        out = []
        for i in range(n):
            x = torch.exp(xs)
            if x.shape[0] == 0 or x.numel() < 2:    # metadata: fine
                continue
            if gmu is None:                         # identity: fine
                gmu = x
            if _is_pair(x):                         # a host helper: fine
                continue
            if i > n // 2 and scale > 0.5:          # host scalars: fine
                out.append(float(np.float32(scale)))
            k = int(x.dim())                        # host value: fine
            out.append(k)
        return out
    """
    assert _codes(syncs_lib, src) == []


def test_syncs_escape_hatch_and_declaration_table():
    src = """
    import torch

    SYNCS_BY_DESIGN = {"lockstep": "every rank ends on the reduced flag"}

    def lockstep(flag, n: int):
        for _ in range(n):
            if bool(flag.any()):
                return

            def inner(x):              # nested in a declared function
                return x.item()
            inner(flag)

    def tail(fired, n: int):
        for _ in range(n):
            more = bool(fired.any())  # lint: sync-ok(one read a tail wave)
    """
    assert _codes(syncs_lib, src) == []


def test_syncs_hatch_must_sit_on_the_flagged_line():
    src = """
    def tail(fired, n: int):
        for _ in range(n):
            # lint: sync-ok(wrong line — must not silence the read below)
            more = bool(fired.any())
    """
    assert _codes(syncs_lib, src) == ["REP101"]


def test_syncs_flags_a_stale_declaration():
    src = """
    SYNCS_BY_DESIGN = {"gone": "was removed"}

    def here(x):
        return x
    """
    diags = check_source([syncs_lib.check], textwrap.dedent(src), LIB)
    assert [d.code for d in diags] == ["REP101"]
    assert "`gone`" in diags[0].message


# ------------------------------------------------------------------- prng


@pytest.mark.parametrize("build", [
    "GeneratorDraws(seed, device)",
    "GeneratorDraws.for_step(seed, step)",
    "parent.fold_in(shard)",
    "torch.Generator().manual_seed(seed)",
])
def test_prng_flags_a_source_rebuilt_with_the_same_arguments(build):
    src = f"""
    import torch
    from repro_torch.draws import GeneratorDraws

    def sources(seed, step, parent, shard, device):
        a = {build}
        b = {build}
        return a, b
    """
    assert _codes(prng_lib, src) == ["REP201"]


def test_prng_distinct_sources_are_clean():
    src = """
    from repro_torch.draws import GeneratorDraws

    def sources(seed, parent, device, steps: int):
        a, b = parent.spawn(), parent.spawn()      # spawn advances
        c, d = parent.split(), parent.split()      # split advances
        e = parent.fold_in(0)
        f = parent.fold_in(1)
        g = GeneratorDraws(seed, device)
        seed = seed + 1
        h = GeneratorDraws(seed, device)           # a new seed
        for step in range(steps):
            k = GeneratorDraws.for_step(seed, step)
        return a, b, c, d, e, f, g, h, k
    """
    assert _codes(prng_lib, src) == []


def test_prng_exclusive_branches_are_not_a_rebuild():
    src = """
    from repro_torch.draws import GeneratorDraws

    def source(seed, device, on_card):
        if on_card:
            return GeneratorDraws(seed, device)
        else:
            return GeneratorDraws(seed, device)
    """
    assert _codes(prng_lib, src) == []


@pytest.mark.parametrize("call", [
    "torch.manual_seed(0)",
    "torch.Generator().manual_seed(1234)",
    "GeneratorDraws(0)",
    "GeneratorDraws(seed=7, device='cpu')",
])
def test_prng_flags_a_constant_seed_in_library_code(call):
    src = f"""
    import torch
    from repro_torch.draws import GeneratorDraws

    def init():
        return {call}
    """
    assert _codes(prng_lib, src) == ["REP202"]
    # the same source in a test, an example or a fixture is fine
    for path in ("tests/test_fake.py", "examples/demo_torch.py",
                 "src/repro_torch/fixtures/toy.py"):
        assert _codes(prng_lib, src, path=path) == []


def test_prng_seeds_from_parameters_and_hatches_are_clean():
    src = """
    import torch
    from repro_torch.draws import GeneratorDraws

    def init(seed, device):
        gen = torch.Generator().manual_seed(seed)
        return gen, GeneratorDraws(seed + 1, device)

    def demo():
        return GeneratorDraws(0)  # lint: prng-ok(fixed demo seed)

    def twice(seed):
        a = GeneratorDraws(seed)
        b = GeneratorDraws(seed)  # lint: prng-ok(a replay of a on purpose)
        return a, b
    """
    assert _codes(prng_lib, src) == []


# ------------------------------------------------------------------ locks


_LOCKS_FIXTURE = """
import threading

GUARDED_BY = {"Box": {"_items": "_lock", "count": "_lock"}}


class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []               # __init__ is exempt
        self.count = 0

    def add(self, item):
        with self._lock:
            self._items.append(item)   # held: fine
            self.count += 1

    def peek(self):
        return self._items[-1]         # NOT held: REP301
"""


def test_locks_flags_unguarded_access():
    diags = check_source([locks_lib.check], textwrap.dedent(_LOCKS_FIXTURE),
                         LIB)
    assert [d.code for d in diags] == ["REP301"]
    assert "_items" in diags[0].message and "_lock" in diags[0].message


def test_locks_escape_hatch():
    src = _LOCKS_FIXTURE.replace(
        "return self._items[-1]         # NOT held: REP301",
        "return self._items[-1]  # lint: unlocked-ok(stale read is fine)")
    assert check_source([locks_lib.check], textwrap.dedent(src), LIB) == []


@pytest.mark.parametrize("module", ["maps", "gateway", "fleet"])
def test_locks_hold_on_the_ports_serving_tables(module):
    """The three GUARDED_BY tables of the port's serving tier are clean as
    committed (their unlocked-ok hatches honoured) and are checked: with
    the hatches stripped, each module has findings."""
    path = ROOT / "src" / "repro_torch" / "serving" / f"{module}.py"
    source = path.read_text()
    rel = f"src/repro_torch/serving/{module}.py"
    assert "GUARDED_BY = {" in source
    assert check_source([locks_lib.check], source, rel) == []
    stripped = source.replace("# lint: unlocked-ok", "# was-unlocked-ok")
    assert [d.code for d in check_source([locks_lib.check], stripped, rel)]


# ---------------------------------------------------------------- retrace


def test_retrace_flags_compiled_closure_over_a_tensor_argument():
    src = """
    import torch

    def serve(w, xs):
        def kernel(x):
            return ((w - x) ** 2).sum(dim=1)   # w guarded into the graph
        fn = torch.compile(kernel)
        return [fn(x) for x in xs]

    def serve_decorated(w, xs):
        @torch.compile(dynamic=True)
        def kernel(x):
            return w @ x
        return [kernel(x) for x in xs]
    """
    assert _codes(retrace_lib, src) == ["REP401", "REP401"]


def test_retrace_flags_float_keyed_signature():
    src = """
    import torch

    @torch.compile
    def step(x, lr: float):
        return x - lr * x

    def decay(x, rate=0.5):
        return x * rate

    fast_decay = torch.compile(decay)
    """
    assert _codes(retrace_lib, src) == ["REP402", "REP402"]


def test_retrace_good_closure_and_hatch():
    src = """
    import torch

    def make_kernel(cfg):
        def kernel(w, x):               # tensors are arguments: fine
            return ((w - x) ** 2).sum(dim=1) * cfg.scale
        return torch.compile(kernel)

    def pinned(w):
        def kernel(x):  # lint: retrace-ok(w constant for the process)
            return w + x
        return torch.compile(kernel)

    def eager(w):
        def kernel(x):                  # never compiled: fine
            return w + x
        return kernel

    @torch.compile
    def scaled(x, n: int):              # int-keyed: fine
        return x * n
    """
    assert _codes(retrace_lib, src) == []


# ------------------------------------------------- driver, hatches, baseline


def test_syntax_error_yields_rep000_not_crash():
    diags = check_source([syncs_lib.check], "def broken(:\n", LIB)
    assert [d.code for d in diags] == ["REP000"]


def test_baseline_round_trip_and_subtract(tmp_path):
    source = ("def f(x, n: int):\n    for _ in range(n):\n"
              "        if x.any():\n            return x\n    return -x\n")
    diags = check_source([syncs_lib.check], source, LIB)
    assert len(diags) == 1
    lines = source.splitlines()
    fp = diags[0].fingerprint(lines)
    assert fp == f"{LIB}::REP101::if x.any():"

    path = tmp_path / "baseline.json"
    write_baseline(path, {fp: 1})
    loaded = load_baseline(path)
    assert loaded == {fp: 1}

    # baselined finding is dropped; a second identical one is NOT (budget)
    assert subtract_baseline(diags, {LIB: lines}, loaded) == []
    assert subtract_baseline(diags * 2, {LIB: lines}, loaded) == diags
    # and the fingerprint survives a line-number shift
    shifted = "# a new header comment\n" + source
    moved = check_source([syncs_lib.check], shifted, LIB)
    assert moved[0].fingerprint(shifted.splitlines()) == fp


def test_cli_run_is_clean_on_this_repo():
    """The committed tree holds the burn-down: with the committed baseline
    there is no fresh finding."""
    assert analysis_main(["--baseline", str(BASELINE)]) == 0


def test_without_the_baseline_exactly_the_two_unplanned_syncs():
    """The baseline tracks the two unplanned syncs: the plain cascade's
    per-wave ``int(fired.sum())`` and ``finish_tail``'s
    ``bool(fired.any())``; nothing else in the tree is a finding."""
    diags, lines = analysis_run([ROOT / "src" / "repro_torch"], ROOT)
    found = [(d.path, d.line, d.code) for d in diags]
    assert found == [
        ("src/repro_torch/core/cascade.py", 105, "REP101"),
        ("src/repro_torch/kernels/cascade/ops.py", 273, "REP101"),
    ]
    assert "int(fired.sum())" in lines[found[0][0]][104]
    assert "bool(fired.any())" in lines[found[1][0]][272]
    assert load_baseline(BASELINE) == {
        d.fingerprint(lines[d.path]): 1 for d in diags}


def test_the_mesh_lockstep_reads_are_declared_not_found():
    """``core/distributed.py``'s lockstep reads (the wave loop's reduced
    count, the greedy descent's reduced ``active``) are syncs by design:
    not reported as committed, found once their declaration is gone."""
    rel = "src/repro_torch/core/distributed.py"
    source = (ROOT / rel).read_text()
    assert check_source([syncs_lib.check], source, rel) == []
    tree = ast.parse(source)
    tree.body = [n for n in tree.body if not (
        isinstance(n, ast.Assign)
        and getattr(n.targets[0], "id", "") == "SYNCS_BY_DESIGN")]
    undeclared = ast.unparse(tree)
    lines = undeclared.splitlines()
    flagged = {lines[d.line - 1].strip()
               for d in syncs_lib.check(ast.parse(undeclared), undeclared,
                                        rel)}
    assert any(".tolist()" in line and "mesh.psum" in line
               for line in flagged), flagged
    assert any(line.startswith("while bool(active.any())")
               for line in flagged), flagged


def test_checker_scopes():
    from repro_torch.analysis.__main__ import checkers_for
    assert len(checkers_for("src/repro_torch/core/som.py")) == 4
    assert len(checkers_for("src/repro_torch/api/backends.py")) == 4
    assert len(checkers_for("src/repro_torch/api/topomap.py")) == 3
    assert len(checkers_for("src/repro_torch/serving/maps.py")) == 3


def test_lint_entry_point_exits_clean():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.lint", "--no-ruff"],
        capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "repro_torch.analysis: clean (2 baselined findings)" in out.stdout


# ------------------------------------------------------------- TraceGuard


class _Counter:
    def __init__(self):
        self.trace_count = 0


def test_trace_guard_bounds_and_exact():
    c = _Counter()
    with TraceGuard(c):                       # max_new=0 default
        pass
    with TraceGuard(c, expect=2) as tg:
        c.trace_count += 2
    assert tg.new_compiles == 2
    with pytest.raises(AssertionError, match="unexpected recompile"):
        with TraceGuard(c):
            c.trace_count += 1
    with pytest.raises(AssertionError, match="expected exactly 1"):
        with TraceGuard(c, expect=1):
            pass


def test_trace_guard_sums_sources_and_keeps_exceptions():
    a, b = _Counter(), _Counter()
    with TraceGuard(a, b, max_new=3):
        a.trace_count += 1
        b.trace_count += 2
    with pytest.raises(KeyError):             # block error wins over guard
        with TraceGuard(a):
            a.trace_count += 5
            raise KeyError("boom")
    with pytest.raises(TypeError, match="none of trace_count"):
        TraceGuard(object()).__enter__()


def test_trace_guard_reads_the_ports_serving_counters():
    """``BmuEngine.trace_count``, ``CompileCache.trace_count`` and
    ``MapService.compiles``: one signature a bucket, none on reuse."""
    import numpy as np
    from repro_torch.api import TopoMap
    from repro_torch.serving import BmuEngine, CompileCache, MapService
    cache = CompileCache()
    engine = BmuEngine(buckets=(8, 64), cache=cache)
    w = torch.randn(16, 5)
    with TraceGuard(engine, cache, expect=2):          # one bucket each
        engine.bmu(w, torch.randn(3, 5))
    with TraceGuard(engine, cache):                    # bucket 8 again
        engine.bmu(w, torch.randn(8, 5))
    with TraceGuard(engine, expect=1):                 # bucket 64, first use
        engine.bmu(w, torch.randn(40, 5))
    x = np.random.default_rng(0).random((64, 5), dtype=np.float32)
    tm = TopoMap(side=4, dim=5, i_max=32, batch=4, backend="kernel",
                 device="cpu").fit(x)
    svc = MapService(tm.cfg, tm.state_, device="cpu")
    svc.engine.cache = CompileCache()
    with TraceGuard(svc, max_new=1):
        svc.transform(x[:6])
        svc.transform(x[:7])
    assert svc.compiles == 1


# ------------------------------------------------------ LockOrderRecorder


class _TwoLocks:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()


def test_lock_order_recorder_clean_order_passes():
    obj = _TwoLocks()
    rec = LockOrderRecorder()
    rec.wrap(obj, "a")
    rec.wrap(obj, "b")
    for _ in range(3):
        with obj.a:
            with obj.b:
                pass
    assert rec.find_cycle() is None
    rec.assert_no_inversions()


def test_lock_order_recorder_detects_inversion():
    obj = _TwoLocks()
    rec = LockOrderRecorder()
    rec.wrap(obj, "a", name="A")
    rec.wrap(obj, "b", name="B")

    def ab():
        with obj.a:
            with obj.b:
                pass

    def ba():
        with obj.b:
            with obj.a:
                pass

    # run serially so both orders are recorded without ever deadlocking
    ab()
    ba()
    cycle = rec.find_cycle()
    assert cycle is not None and cycle[0] == cycle[-1]
    with pytest.raises(AssertionError, match="lock-order inversion"):
        rec.assert_no_inversions()


def test_lock_order_recorder_handles_conditions_and_threads():
    class Obj:
        def __init__(self):
            self._cond = threading.Condition()
            self._lock = threading.Lock()

    obj = Obj()
    rec = LockOrderRecorder()
    rec.wrap(obj, "_cond")
    rec.wrap(obj, "_lock")

    def worker():
        for _ in range(5):
            with obj._cond:
                obj._cond.notify_all()
                with obj._lock:
                    pass

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert rec.edges() == {"Obj._cond": {"Obj._lock"}}
    rec.assert_no_inversions()
