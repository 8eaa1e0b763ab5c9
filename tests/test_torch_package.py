"""The port as a package: it imports no JAX, its entry points refuse to fall
back to the CPU, its draw sources and data are deterministic, and
``chip_smoke.py`` refuses to run without a card."""
import os
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

import repro_torch
from repro_torch.data import DATASETS, make_dataset
from repro_torch.draws import GeneratorDraws, ReplayDraws

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def _python(args, **env):
    """A fresh single-threaded interpreter with the port on its path."""
    return subprocess.run(
        [sys.executable, *args], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", **env})


_PROBE = """import sys
for m in {modules!r}: __import__(m)
from repro_torch.data import make_dataset
x = make_dataset('satimage', train_size=50, test_size=10, device='cpu')[0]
print(sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))
print(float(x.sum()))
"""


@pytest.fixture(scope="module")
def probes():
    """Two fresh interpreters with different string-hash salts: each imports
    every module of the port and makes a small dataset."""
    code = _PROBE.format(modules=_modules())
    return [_python(["-c", code], PYTHONHASHSEED=seed) for seed in ("1", "2")]


def test_import_leaves_jax_and_repro_out(probes):
    for out in probes:
        assert out.returncode == 0, out.stderr
        assert out.stdout.splitlines()[0] == "[]"
    assert len(_modules()) >= 20


def test_no_jax_or_repro_import_lines():
    """The package (its analysis layer included), the card's smoke run and
    the port's examples import neither JAX nor the JAX package."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert [f.name for f in examples] == ["classify_datasets_torch.py",
                                          "quickstart_torch.py"]
    assert (ROOT / "src" / "repro_torch" / "analysis" / "syncs.py") in files
    for f in files + examples:
        assert not pattern.search(f.read_text()), f


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """With no card, and in a directory that holds only the script, it
    exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine with no card")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        out = _python([str(script)])
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_replay_draws_checks_requests():
    draws = ReplayDraws([np.array([1, 2]), np.zeros((2, 3), np.float32)])
    with pytest.raises(ValueError, match="mismatch"):
        draws.randint(0, 5, (3,))
    draws = ReplayDraws([np.array([1, 7])])
    with pytest.raises(ValueError, match="outside"):
        draws.randint(0, 5, (2,))
    draws = ReplayDraws([np.array([1, 2]), np.full((2, 3), 0.5, np.float32)])
    assert draws.randint(0, 5, (2,)).dtype == torch.int64
    assert draws.uniform((2, 3)).dtype == torch.float32
    assert len(draws) == 0
    with pytest.raises(IndexError, match="exhausted"):
        draws.uniform((1,))


def test_generator_draws_are_seeded():
    a, b = GeneratorDraws(4, device="cpu"), GeneratorDraws(4, device="cpu")
    assert torch.equal(a.uniform((5,)), b.uniform((5,)))
    assert torch.equal(a.randint(0, 9, (5,)), b.randint(0, 9, (5,)))
    assert torch.equal(a.normal((3,)), b.normal((3,)))
    u = a.uniform((1000,))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_shapes_follow_table_1(name):
    spec = DATASETS[name]
    xtr, ytr, xte, yte = make_dataset(name, train_size=64, test_size=32,
                                      device="cpu")
    assert xtr.shape == (64, spec.features) and xte.shape == (32, spec.features)
    assert xtr.dtype == torch.float32 and ytr.dtype == torch.int32
    assert float(xtr.min()) >= 0.0 and float(xtr.max()) <= 1.0
    assert int(ytr.max()) < spec.classes and int(yte.min()) >= 0


def test_dataset_is_the_same_in_every_process(probes):
    """The seed is a stable hash of the name (``hash(str)`` is salted per
    process, so the JAX package's stand-in changes from run to run)."""
    sums = {out.stdout.splitlines()[1] for out in probes}
    assert len(sums) == 1
    here = make_dataset("satimage", train_size=50, test_size=10, device="cpu")
    assert sums == {f"{float(here[0].sum())}"}
    other = make_dataset("satimage", seed=1, train_size=50, test_size=10,
                         device="cpu")
    assert not torch.equal(here[0], other[0])
