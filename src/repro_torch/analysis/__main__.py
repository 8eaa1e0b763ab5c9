"""CLI driver: ``python -m repro_torch.analysis [paths...] [--baseline F]``.

Walks the given files/directories (default: ``src/repro_torch`` under the
repo root), runs every checker scoped to the directories it protects,
subtracts the baseline, and prints the remaining diagnostics as
``path:line: CODE message``. Exit status 1 iff any non-baselined
diagnostic remains.

The sync check (REP101) runs on the training and search code: the files
under ``core/``, ``kernels/`` and ``training/``, and ``api/backends.py``
(JAX's tracer check covers ``core``, ``kernels`` and ``training``). Those
files are checked together, so a loop's calls are followed across their
imports.

``--write-baseline FILE`` records the current findings as the new
baseline instead of failing on them.
"""

from __future__ import annotations

import argparse
import ast
import functools
import sys
from pathlib import Path

from repro_torch.analysis import locks, prng, retrace, syncs
from repro_torch.analysis.base import (
    Diagnostic,
    check_source,
    load_baseline,
    subtract_baseline,
    write_baseline,
)

_SYNC_DIRS = ("core", "kernels", "training")
_SYNC_FILES = ("api/backends.py",)


def _repo_root() -> Path:
    # src/repro_torch/analysis/__main__.py -> the repo root is three levels
    # up from the package directory's parent (src/).
    return Path(__file__).resolve().parents[3]


def _iter_py_files(paths: list[Path]) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    seen: set[Path] = set()
    out: list[Path] = []
    for f in files:
        r = f.resolve()
        if r not in seen:
            seen.add(r)
            out.append(f)
    return out


def syncs_apply(path: str) -> bool:
    """Whether the sync check covers one repo-relative posix path."""
    return any(d in path.split("/") for d in _SYNC_DIRS) or path.endswith(
        _SYNC_FILES)


def checkers_for(path: str, hot: dict[str, set[str]] | None = None):
    """Select the checker set for one repo-relative posix path; ``hot`` is
    the sync check's hot functions per path, found across the files."""
    selected = [prng.check, locks.check, retrace.check]
    if syncs_apply(path):
        sync = syncs.check if hot is None else functools.partial(
            syncs.check, hot=hot.get(path, set()))
        selected.insert(0, sync)
    return selected


def run(
    paths: list[Path], root: Path
) -> tuple[list[Diagnostic], dict[str, list[str]]]:
    """Check all files; returns (diagnostics, source lines per path)."""
    sources: dict[str, str] = {}
    for f in _iter_py_files(paths):
        try:
            rel = f.resolve().relative_to(root).as_posix()
        except ValueError:
            rel = f.as_posix()
        sources[rel] = f.read_text()
    indexes = []
    for rel, source in sources.items():
        if not syncs_apply(rel):
            continue
        try:
            indexes.append(syncs.index_module(ast.parse(source), rel))
        except SyntaxError:
            continue                   # reported as REP000 below
    hot = syncs.project_hot(indexes)
    diags: list[Diagnostic] = []
    lines_by_path: dict[str, list[str]] = {}
    for rel, source in sources.items():
        lines_by_path[rel] = source.splitlines()
        diags.extend(check_source(checkers_for(rel, hot), source, rel))
    diags.sort(key=lambda d: (d.path, d.line, d.code))
    return diags, lines_by_path


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The port's static checks (sync/PRNG/lock/retrace).",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help="files or directories to check (default: src/repro_torch "
        "under the repo root)",
    )
    parser.add_argument(
        "--baseline",
        help="baseline JSON; findings covered by it are not reported",
    )
    parser.add_argument(
        "--write-baseline",
        metavar="FILE",
        help="record current findings to FILE and exit 0",
    )
    parser.add_argument(
        "--root",
        help="repo root for relative paths/baseline keys (default: inferred)",
    )
    args = parser.parse_args(argv)

    root = Path(args.root).resolve() if args.root else _repo_root()
    paths = [Path(p) for p in args.paths] or [root / "src" / "repro_torch"]

    baseline = load_baseline(args.baseline) if args.baseline else None
    found, lines_by_path = run(paths, root)
    diags = (subtract_baseline(found, lines_by_path, baseline)
             if baseline else found)

    if args.write_baseline:
        fingerprints: dict[str, int] = {}
        for d in diags:
            fp = d.fingerprint(lines_by_path.get(d.path, []))
            fingerprints[fp] = fingerprints.get(fp, 0) + 1
        write_baseline(args.write_baseline, fingerprints)
        print(
            f"wrote {len(fingerprints)} baseline entr"
            f"{'y' if len(fingerprints) == 1 else 'ies'} "
            f"to {args.write_baseline}"
        )
        return 0

    for d in diags:
        print(d.format())
    n = len(diags)
    if n:
        print(f"\n{n} violation{'s' if n != 1 else ''} found", file=sys.stderr)
        return 1
    print(f"repro_torch.analysis: clean ({len(found)} baselined finding"
          f"{'' if len(found) == 1 else 's'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
