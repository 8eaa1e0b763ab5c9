"""repro_torch.analysis — the port's static checks and runtime verification,
the counterpart of ``repro.analysis`` (the port keeps its own copy and
imports nothing of the JAX package).

Static side (``python -m repro_torch.analysis``): four AST checkers encode
the invariants the port's speed and serving claims rest on:

* ``REP101`` host sync in a hot loop (``analysis.syncs``): ``.item()``,
  ``bool(t)``, ``if t:`` and the like in training and search loops, the
  counterpart of JAX's tracer hazard (``repro.analysis.tracer``).
* ``REP201``/``REP202`` draw-source discipline (``analysis.prng``): a draw
  source rebuilt with the same arguments, and a constant seed in library
  code.
* ``REP301`` lock discipline (``analysis.locks``): ``GUARDED_BY``
  attributes touched outside their lock.
* ``REP401``/``REP402`` recompile hazards (``analysis.retrace``): a
  ``torch.compile``d closure over tensor data, and a compiled signature
  keyed on Python floats.

Runtime side (``analysis.runtime``): ``TraceGuard`` asserts how many new
signatures a block may introduce; ``LockOrderRecorder`` records lock
acquisition order across threads and flags ordering inversions.

Tracing (``analysis.spans``): ``span`` and ``mark_backward`` name each
layer's forward and backward in a ``torch.profiler`` trace
(``repro_torch::<layer>``), and cost one flag check when no profiler
collects.

Escape hatches are inline comments of the form ``# lint: <name>-ok(reason)``
where ``<name>`` is ``sync``, ``prng``, ``unlocked``, or ``retrace``.
``python -m repro_torch.launch.lint`` runs the checks against the
committed baseline ``analysis-baseline-torch.json``.
"""

from repro_torch.analysis.base import (
    CODE_TO_HATCH,
    Diagnostic,
    check_source,
    escape_hatches,
    load_baseline,
    write_baseline,
)
from repro_torch.analysis.runtime import LockOrderRecorder, TraceGuard
from repro_torch.analysis.spans import mark_backward, span

__all__ = [
    "CODE_TO_HATCH",
    "Diagnostic",
    "LockOrderRecorder",
    "TraceGuard",
    "check_source",
    "escape_hatches",
    "load_baseline",
    "mark_backward",
    "span",
    "write_baseline",
]
