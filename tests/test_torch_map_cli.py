"""The port's map launchers on the CPU: ``repro_torch.launch.train_map``
writes artifacts and store versions, ``repro_torch.launch.serve_map`` serves
them (counterparts of the CLI tests of ``tests/test_serving_maps.py`` and
``test_serving_fleet.py``), held against JAX's ``serve_map`` on the same
artifact; ``add_backend_argument``; and the IDX loader that
``make_dataset`` uses when real files are present (a small file written
under ``tmp_path``, read by both packages)."""
import argparse
import gzip
import io
import json
import re
import struct
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.api import TopoMap as JTopoMap
from repro.data import idx as jidx
from repro.launch import serve_map as jserve_map
from repro_torch.api import MapStore, TopoMap, add_backend_argument
from repro_torch.api import available_backends
from repro_torch.data import idx as tidx
from repro_torch.data import make_dataset
from repro_torch.launch import serve_map, train_map
from repro_torch.serving import MapService
from torch_parity import jax_cfg, run_ranks
import torch_ranks

KW = dict(side=6, dim=12, i_max=48, batch=4, e_factor=0.5)
X = np.random.default_rng(3).standard_normal((256, 12)).astype(np.float32)
Y = np.random.default_rng(4).integers(0, 4, 256).astype(np.int32)


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """A JAX-trained map saved by JAX, and a store holding it as toy@1."""
    root = tmp_path_factory.mktemp("cli")
    j = JTopoMap(jax_cfg(**KW)).fit(X, Y, key=jax.random.PRNGKey(7))
    path = str(root / "art")
    j.save(path)
    from repro.api import MapStore as JMapStore
    JMapStore(str(root / "store")).save(j, "toy")
    return path, str(root / "store")


def _serve(capsys, argv):
    serve_map.main(argv + ["--device", "cpu"])
    return capsys.readouterr().out


def test_train_map_saves_artifact_and_store(tmp_path, capsys):
    args = ["--device", "cpu", "--dataset", "satimage", "--side", "5",
            "--train-size", "300", "--test-size", "60",
            "--save-artifact", str(tmp_path / "art"),
            "--store", str(tmp_path / "store")]
    tm = train_map.main(args)
    out = capsys.readouterr().out
    assert "device=cpu" in out and "quantization error" in out
    assert "saved to store" in out and "satimage-5x5@1" in out
    loaded = TopoMap.load(str(tmp_path / "art"), device="cpu")
    _, _, xte, _ = make_dataset("satimage", train_size=300, test_size=60,
                                device="cpu")
    assert torch.equal(loaded.predict(xte), tm.predict(xte))
    art = MapStore(str(tmp_path / "store")).load_artifact("satimage-5x5",
                                                          device="cpu")
    assert art.meta["extra"]["dataset"] == "satimage"
    assert art.backend == "batched"
    train_map.main(args[:-4] + ["--backend", "kernel",
                                "--store", str(tmp_path / "store")])
    assert "satimage-5x5@2" in capsys.readouterr().out


@pytest.mark.parametrize("flags,message", [
    (["--mesh", "2x2"], "only applies to the sharded backend"),
    (["--shards", "2"], "only applies to the async backend"),
    (["--backend", "async", "--shards", "2"], "torchrun --nproc-per-node 2"),
    (["--backend", "sharded", "--mesh", "2x2"],
     "torchrun --nproc-per-node 4"),
    (["--backend", "sharded", "--mesh", "2by2"], "DATAxMODEL")])
def test_train_map_mesh_names_the_roadmap_item(flags, message):
    """A mesh run without its ranks says how to start them; mesh flags on
    another backend are refused."""
    with pytest.raises(SystemExit, match=message):
        train_map.main(["--device", "cpu"] + flags)


@pytest.mark.parametrize("flags", [
    ["--backend", "sharded", "--mesh", "1x2", "--batch", "4"],
    ["--backend", "async", "--shards", "2", "--search", "exact"]])
def test_train_map_on_two_ranks(tmp_path, monkeypatch, flags):
    """``train_map`` on 2 gloo ranks on the CPU over a small IDX file:
    every rank ends with the same dense map, rank 0 saves it, and the
    saved map is the one trained."""
    d = tmp_path / "mnist"
    d.mkdir()
    rng = np.random.default_rng(1)
    _write_idx(str(d / "train-images-idx3-ubyte"),
               rng.integers(0, 256, (64, 28, 28)).astype(np.uint8))
    _write_idx(str(d / "train-labels-idx1-ubyte"),
               rng.integers(0, 10, 64).astype(np.uint8))
    _write_idx(str(d / "t10k-images-idx3-ubyte"),
               rng.integers(0, 256, (16, 28, 28)).astype(np.uint8))
    _write_idx(str(d / "t10k-labels-idx1-ubyte"),
               rng.integers(0, 10, 16).astype(np.uint8))
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))
    art = str(tmp_path / "art")
    argv = ["--device", "cpu", "--dataset", "mnist", "--side", "4",
            "--i-max", "32", "--train-size", "64", "--test-size", "16",
            "--dist-backend", "gloo", "--save-artifact", art] + flags
    ranks = run_ranks(torch_ranks.train_map_cli, 2, 240.0, argv)
    np.testing.assert_array_equal(ranks[0]["w"], ranks[1]["w"])
    loaded = TopoMap.load(art, device="cpu")
    assert loaded.backend.name == ranks[0]["backend"]
    np.testing.assert_array_equal(loaded.state_.w.numpy(), ranks[0]["w"])


def test_train_map_rejects_latency_flags_for_other_backends():
    with pytest.raises(SystemExit, match="async backend"):
        train_map.main(["--device", "cpu", "--delay", "1.0"])


def test_add_backend_argument_follows_the_registry():
    ap = argparse.ArgumentParser()
    add_backend_argument(ap, default="kernel")
    assert ap.parse_args([]).backend == "kernel"
    assert ap.parse_args(["--backend", "async"]).backend == "async"
    with pytest.raises(SystemExit):
        ap.parse_args(["--backend", "pallas"])
    assert set(ap._actions[-1].choices) == set(available_backends())


# ------------------------------------------------------------- serve_map


def test_serve_map_random_batch(capsys, art):
    out = _serve(capsys, ["--artifact", art[0], "--random", "32"])
    assert "output shape: (32,)" in out and "device=cpu" in out
    m = re.search(r"(\d+) bucket signatures", out)
    assert m and int(m.group(1)) <= 1
    assert re.search(r"latency ms: p50=\d", out)


def test_serve_map_jsonl_predict_matches_jax(tmp_path, monkeypatch, capsys,
                                             art):
    lines = [json.dumps(row.tolist()) for row in X[:5]]
    lines.append(json.dumps({"x": X[5].tolist()}))
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines) + "\n"))
    out_t = str(tmp_path / "t.npy")
    out = _serve(capsys, ["--artifact", art[0], "--requests", "-",
                          "--endpoint", "predict", "--output", out_t])
    assert "output shape: (6,)" in out
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("\n".join(lines) + "\n")
    out_j = str(tmp_path / "j.npy")
    monkeypatch.setattr(sys, "argv", [
        "serve_map", "--artifact", art[0], "--requests", str(reqs),
        "--endpoint", "predict", "--output", out_j])
    jserve_map.main()
    np.testing.assert_array_equal(np.load(out_t), np.load(out_j))
    tm = TopoMap.load(art[0], device="cpu")
    np.testing.assert_array_equal(np.load(out_t), tm.predict(X[:6]).numpy())


def test_serve_map_npy_store_and_umatrix(tmp_path, capsys, art):
    npy = str(tmp_path / "reqs.npy")
    np.save(npy, X[:9])
    out_npy = str(tmp_path / "out.npy")
    out = _serve(capsys, ["--store", art[1], "--map", "toy@1",
                          "--requests", npy, "--output", out_npy])
    assert "output shape: (9,)" in out
    tm = TopoMap.load(art[0], device="cpu")
    np.testing.assert_array_equal(np.load(out_npy), tm.transform(X[:9]))
    out = _serve(capsys, ["--store", art[1], "--map", "toy",
                          "--endpoint", "u-matrix"])
    assert f"output shape: ({KW['side']}, {KW['side']})" in out


def test_serve_map_quantization_error_per_sample(tmp_path, capsys, art):
    npy = str(tmp_path / "reqs.npy")
    np.save(npy, X[:11])
    out_npy = str(tmp_path / "qe.npy")
    out = _serve(capsys, ["--artifact", art[0], "--requests", npy,
                          "--endpoint", "quantization-error",
                          "--output", out_npy])
    assert "output shape: (11,)" in out
    svc = MapService.from_artifact(art[0], device="cpu")
    np.testing.assert_array_equal(np.load(out_npy),
                                  svc.quantization_errors(X[:11]).numpy())


def test_serve_map_concurrent_gateway(tmp_path, capsys, art):
    npy = str(tmp_path / "reqs.npy")
    np.save(npy, X[:64])
    out_npy = str(tmp_path / "out.npy")
    out = _serve(capsys, ["--artifact", art[0], "--requests", npy,
                          "--batch", "1", "--concurrency", "4", "--gateway",
                          "--output", out_npy])
    assert "output shape: (64,)" in out
    assert "gateway:" in out and "4 clients" in out
    tm = TopoMap.load(art[0], device="cpu")
    np.testing.assert_array_equal(np.load(out_npy), tm.transform(X[:64]))


def test_serve_map_fleet_with_rolling_reload(tmp_path, capsys, art):
    store = MapStore(str(tmp_path / "store"))
    store.save(TopoMap.load(art[0], device="cpu"), "toy")
    out = _serve(capsys, ["--store", str(tmp_path / "store"), "--map", "toy",
                          "--random", "64", "--batch", "4",
                          "--concurrency", "2", "--replicas", "2",
                          "--shed-deadline-ms", "2000",
                          "--reload-during-run", "--max-retries", "2"])
    assert "replicas=2" in out and "0 shed" in out
    assert re.search(r"fleet latency ms: p50=\d", out)
    assert re.search(r"replica 1: \d+ requests", out)
    assert "rolled to version 2 mid-run (reloads=1)" in out
    assert "output shape: (64,)" in out
    assert store.versions("toy") == [1, 2]


@pytest.mark.parametrize("argv,msg", [
    (["--artifact", "a", "--map", "toy", "--random", "4"], "--map"),
    (["--artifact", "a", "--random", "8", "--replicas", "2", "--gateway"],
     "--gateway coalesces"),
    (["--artifact", "a", "--random", "8", "--shed-deadline-ms", "10"],
     "--shed-deadline-ms"),
    (["--artifact", "a", "--random", "8", "--max-outstanding", "4"],
     "--max-outstanding"),
    (["--artifact", "a", "--random", "8", "--reload-during-run"],
     "--reload-during-run"),
    (["--artifact", "a", "--random", "8", "--replicas", "2",
      "--reload-during-run"], "needs --store"),
])
def test_serve_map_rejects_incompatible_flags(argv, msg):
    with pytest.raises(SystemExit, match=re.escape(msg)):
        serve_map.main(argv + ["--device", "cpu"])


def test_serve_map_defaults_to_cuda(art):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine with no card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_map.main(["--artifact", art[0], "--random", "4"])


# ------------------------------------------------------------------- IDX


def _write_idx(path, arr, gz=False):
    codes = {np.uint8: 0x08, np.int32: 0x0C, np.float32: 0x0D}
    header = struct.pack(">I", (codes[arr.dtype.type] << 8) | arr.ndim)
    header += struct.pack(">" + "I" * arr.ndim, *arr.shape)
    data = header + arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    (gzip.open if gz else open)(path, "wb").write(data)


def test_make_dataset_reads_local_idx_files(tmp_path, monkeypatch):
    d = tmp_path / "mnist"
    d.mkdir()
    rng = np.random.default_rng(0)
    xtr = rng.integers(0, 256, (20, 28, 28)).astype(np.uint8)
    xte = rng.integers(0, 256, (6, 28, 28)).astype(np.uint8)
    ytr = rng.integers(0, 10, 20).astype(np.uint8)
    yte = rng.integers(0, 10, 6).astype(np.uint8)
    _write_idx(str(d / "train-images-idx3-ubyte.gz"), xtr, gz=True)
    _write_idx(str(d / "train-labels-idx1-ubyte"), ytr)
    _write_idx(str(d / "t10k-images-idx3-ubyte"), xte)
    _write_idx(str(d / "t10k-labels-idx1-ubyte.gz"), yte, gz=True)
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))
    got = make_dataset("mnist", train_size=15, test_size=6, device="cpu")
    want = (xtr[:15].reshape(15, 784).astype(np.float32) / 255.0, ytr[:15],
            xte.reshape(6, 784).astype(np.float32) / 255.0, yte)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    # held to the files, not to the JAX package's reader: under numpy 2 that
    # one calls ``newbyteorder`` on a scalar type and raises TypeError
    # other datasets, and real_data_ok=False, keep the stand-in
    stand_in = make_dataset("mnist", train_size=15, test_size=6,
                            real_data_ok=False, device="cpu")
    assert not torch.equal(stand_in[0], got[0])
    assert make_dataset("satimage", train_size=8, test_size=4,
                        device="cpu")[0].shape == (8, 36)


def test_idx_csv_fallback_and_absence(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_DATA_DIR", raising=False)
    assert tidx.try_load("letters") is None
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))
    assert tidx.try_load("letters") is None
    d = tmp_path / "letters"
    d.mkdir()
    assert tidx.try_load("letters") is None
    rows = np.column_stack([np.arange(4) % 3,
                            np.arange(64).reshape(4, 16) / 64.0])
    np.savetxt(d / "train.csv", rows, delimiter=",")
    np.savetxt(d / "test.csv", rows[:2], delimiter=",")
    got, want = tidx.try_load("letters"), jidx.try_load("letters")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    xtr, ytr, _, _ = make_dataset("letters", device="cpu")
    assert xtr.shape == (4, 16) and ytr.tolist() == [0, 1, 2, 0]
