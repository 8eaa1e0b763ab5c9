"""Shared infrastructure of the port's static checkers, a copy of
``repro.analysis.base`` (the port imports nothing of the JAX package).

A checker is a function ``check(tree, source, path) -> list[Diagnostic]``.
This module provides the pieces every checker shares: the ``Diagnostic``
record, escape-hatch comment parsing, baseline load/save/subtract, and the
``check_source`` driver that runs a set of checkers over one file and
applies hatches.

Baselines are keyed on ``(path, code, stripped source line)`` rather than
line numbers, so unrelated edits above a baselined violation don't
invalidate the baseline.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass
from pathlib import Path

# Maps a diagnostic code to the escape-hatch name that silences it:
# ``# lint: <name>-ok(reason)`` on the flagged line.
CODE_TO_HATCH = {
    "REP101": "sync",
    "REP201": "prng",
    "REP202": "prng",
    "REP301": "unlocked",
    "REP401": "retrace",
    "REP402": "retrace",
}

_HATCH_RE = re.compile(r"#\s*lint:\s*([a-z][a-z-]*)-ok\(([^)]*)\)")


@dataclass(frozen=True)
class Diagnostic:
    """One checker finding, pinned to a file:line with a stable code."""

    path: str
    line: int
    code: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"

    def fingerprint(self, source_lines: list[str]) -> str:
        """Line-number-independent identity used by the baseline file."""
        text = ""
        if 1 <= self.line <= len(source_lines):
            text = source_lines[self.line - 1].strip()
        return f"{self.path}::{self.code}::{text}"


def escape_hatches(source: str) -> dict[int, set[str]]:
    """Map line number -> set of hatch names declared on that line."""
    hatches: dict[int, set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        for m in _HATCH_RE.finditer(line):
            hatches.setdefault(i, set()).add(m.group(1))
    return hatches


def check_source(checkers, source: str, path: str) -> list[Diagnostic]:
    """Run ``checkers`` over one file's source, applying escape hatches.

    Returns diagnostics sorted by line. A syntax error yields a single
    REP000 diagnostic rather than raising, so one broken file doesn't
    abort the whole run.
    """
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [
            Diagnostic(path, e.lineno or 1, "REP000", f"syntax error: {e.msg}")
        ]
    hatches = escape_hatches(source)
    out: list[Diagnostic] = []
    for checker in checkers:
        for diag in checker(tree, source, path):
            hatch = CODE_TO_HATCH.get(diag.code)
            if hatch is not None and hatch in hatches.get(diag.line, ()):
                continue
            out.append(diag)
    out.sort(key=lambda d: (d.line, d.code))
    return out


def load_baseline(path: str | Path) -> dict[str, int]:
    """Load a baseline file: {fingerprint: allowed count}."""
    raw = json.loads(Path(path).read_text())
    entries = raw.get("entries", raw) if isinstance(raw, dict) else raw
    return {str(k): int(v) for k, v in entries.items()}


def write_baseline(path: str | Path, fingerprints: dict[str, int]) -> None:
    """Write a baseline file (sorted keys, so diffs are stable)."""
    payload = {
        "comment": (
            "Known pre-existing violations; repro_torch.analysis fails only "
            "on findings not covered here. Regenerate with --write-baseline."
        ),
        "entries": dict(sorted(fingerprints.items())),
    }
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")


def subtract_baseline(
    diags: list[Diagnostic],
    source_lines_by_path: dict[str, list[str]],
    baseline: dict[str, int],
) -> list[Diagnostic]:
    """Drop diagnostics covered by the baseline, up to each entry's count."""
    budget = dict(baseline)
    fresh: list[Diagnostic] = []
    for d in diags:
        fp = d.fingerprint(source_lines_by_path.get(d.path, []))
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
            continue
        fresh.append(d)
    return fresh


def dotted_name(node: ast.AST) -> str | None:
    """Render ``a.b.c`` chains; None for anything not a pure name chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def final_attr(node: ast.AST) -> str | None:
    """The last component of a call target: ``torch.compile`` -> ``compile``."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None
