"""Run the port's static checks: repro_torch.analysis + (if installed) ruff.

Usage::

    python -m repro_torch.launch.lint                 # check src/repro_torch
    python -m repro_torch.launch.lint --no-ruff       # analysis checkers only
    python -m repro_torch.launch.lint src/repro_torch/serving

Equivalent to ``python -m repro_torch.analysis --baseline
analysis-baseline-torch.json`` followed by ``ruff check`` of the port's
files. ruff is optional: when it is not installed the ruff step is skipped
with a notice. The counterpart of ``launch/lint.py``, which checks the JAX
package; this entry point lives inside the port's package, so the JAX
checkers, which scan the root ``launch/`` directory, never see it.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

from repro_torch.analysis.__main__ import main as analysis_main

REPO_ROOT = Path(__file__).resolve().parents[3]
#: the port's files that ruff checks: the package, its examples and the
#: card's smoke run
RUFF_PATHS = ("src/repro_torch", "examples/quickstart_torch.py",
              "examples/classify_datasets_torch.py", "chip_smoke.py")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("paths", nargs="*",
                        help="paths for repro_torch.analysis")
    parser.add_argument(
        "--baseline",
        default=str(REPO_ROOT / "analysis-baseline-torch.json"),
        help="baseline JSON (default: analysis-baseline-torch.json at the "
             "repo root)",
    )
    parser.add_argument(
        "--no-ruff", action="store_true", help="skip the ruff step"
    )
    args = parser.parse_args(argv)

    analysis_args: list[str] = list(args.paths)
    if Path(args.baseline).exists():
        analysis_args += ["--baseline", args.baseline]
    rc = analysis_main(analysis_args)

    if not args.no_ruff:
        ruff = shutil.which("ruff")
        if ruff is None:
            print("lint: ruff not installed; skipping")
        else:
            paths = [str(REPO_ROOT / p) for p in RUFF_PATHS
                     if (REPO_ROOT / p).exists()]
            ruff_rc = subprocess.call([ruff, "check", *paths], cwd=REPO_ROOT)
            rc = rc or ruff_rc
    return rc


if __name__ == "__main__":
    sys.exit(main())
