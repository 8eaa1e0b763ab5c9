"""The port's two examples, ``examples/quickstart_torch.py`` and
``examples/classify_datasets_torch.py``: each ``main`` runs with
``--device cpu`` at a small size, and what it prints is parsed."""
import importlib.util
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NUMBER = r"([0-9]+\.[0-9]+)"


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_prints_quality_and_classification(capsys):
    _example("quickstart_torch").main(
        ["--device", "cpu", "--side", "6", "--train-size", "600",
         "--test-size", "200", "--budget", "20"])
    out = capsys.readouterr().out
    assert re.search(r"map 6x6, 36 exploration hops/sample, 45 steps, "
                     r"backend=kernel, device=cpu", out), out
    assert int(re.search(r"largest cascade a_i = ([0-9]+) units",
                         out).group(1)) >= 0
    values = {key: float(re.search(rf"{key}: {NUMBER}", out).group(1))
              for key in ("Q", "T", "F")}
    assert values["Q"] > 0 and 0 <= values["T"] <= 1 and 0 <= values["F"] <= 1
    acc, prec, rec = (float(x) for x in re.search(
        rf"acc={NUMBER} precision={NUMBER} recall={NUMBER}", out).groups())
    # six classes: chance is 0.167
    assert acc > 0.3 and 0 < prec <= 1 and 0 < rec <= 1


@pytest.mark.parametrize("backend", ["kernel", "batched"])
def test_classify_datasets_prints_table2(capsys, backend):
    _example("classify_datasets_torch").main(
        ["--device", "cpu", "--side", "5", "--datasets", "satimage,letters",
         "--train-size", "500", "--test-size", "200", "--budget", "20",
         "--backend", backend])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split() == ["dataset", "AFM", "prec", "AFM", "rec",
                                "SOM", "prec", "SOM", "rec"]
    rows = [line.split() for line in lines[1:]]
    assert [r[0] for r in rows] == ["satimage", "letters"]
    for row in rows:
        assert len(row) == 5
        assert all(0.0 <= float(x) <= 1.0 for x in row[1:])
    # satimage's six classes separate well at any of these sizes
    assert min(float(x) for x in rows[0][1:]) > 0.3


def test_classify_datasets_refuses_the_sharded_backend():
    with pytest.raises(SystemExit, match="sharded backend"):
        _example("classify_datasets_torch").main(
            ["--device", "cpu", "--backend", "sharded"])
