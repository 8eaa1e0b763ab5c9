"""The port's train-and-serve loop (``repro_torch.launch.stream_train``) on
the CPU: the cases of ``tests/test_async_trainer.py``'s stream section and
of ``tests/test_faults.py``'s kill-and-resume section carried over, the
loop held against JAX's ``run_stream`` on JAX's per-step draws, and the
CLI killed and resumed in processes of its own.

Parity: JAX's step ``s`` trains on ``fold_in(PRNGKey(seed), s)``; the port
takes the same numbers through ``run_stream``'s ``draws_for_step`` seam
(``torch_parity.JaxStepDraws``, per event the search's draws and the
cascade's child) and JAX's initial state (the packages' link samplers
differ). The final published weights agree within ``W_ULPS`` ulps of the
largest weight (as ``tests/test_torch_async.py``'s fits) and the sample
count exactly; JAX loads the port's artifact.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.api import MapStore as JMapStore
from repro.api import TopoMap as JTopoMap
from repro.core import afm as jafm
from repro.launch.stream_train import run_stream as jrun_stream
from repro_torch.api import AFMConfig, MapStore
from repro_torch.convert import state_from_numpy
from repro_torch.core import events as tev
from repro_torch.draws import GeneratorDraws
from repro_torch.launch import stream_train
from repro_torch.launch.stream_train import run_stream
from repro_torch.training.async_trainer import AsyncBackend
from torch_parity import F32_EPS, JaxStepDraws, jax_cfg

W_ULPS = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM_CFG = AFMConfig(side=4, dim=12, i_max=96, e_factor=0.5)


def _tiny_data(n=200, d=12, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _store_map(root):
    art = MapStore(root).load_artifact("m", device="cpu")
    return art.state.w, art.state.i


# ------------------------------------------------ stream train-and-serve


def test_stream_train_swap_is_torn_read_safe():
    """Gateway clients read per-sample QE for the whole run while the
    trainer swaps state in; every read is finite and error-free."""
    x = _tiny_data()
    rep = run_stream(STREAM_CFG, x, x[:64], backend="async", events=96,
                     chunk=16, swap_every=32, clients=2, client_batch=4,
                     device="cpu")
    assert rep.client_errors == []
    assert rep.events == 96
    assert rep.swaps >= 3
    assert rep.client_requests >= 1
    assert rep.qe_finite and rep.qe.shape == (64,)


def test_stream_train_store_backed_reload(tmp_path):
    """Store-backed publication: artifact versions append and the gateway
    serves the reloaded map."""
    x = _tiny_data()
    root = str(tmp_path / "maps")
    rep = run_stream(STREAM_CFG, x, x[:32], backend="batched", events=96,
                     chunk=16, swap_every=48, clients=1, client_batch=4,
                     store_root=root, name="stream-test", device="cpu")
    assert rep.client_errors == []
    assert rep.qe_finite
    assert len(MapStore(root).versions("stream-test")) >= 3
    assert rep.swaps >= 2


def test_stream_train_works_without_clients():
    x = _tiny_data(n=128)
    rep = run_stream(STREAM_CFG, x, x[:16], backend="batched", events=64,
                     chunk=32, swap_every=32, clients=0, device="cpu")
    assert rep.qe_finite and rep.client_requests == 0


# ------------------------------------------------- kill-and-resume (bitwise)


RESUME_OPTIONS = {
    "zero": {},
    "constant-faults": {"latency": "constant", "delay": 1.0, "faults": {
        "seed": 3, "p_loss": 0.2, "dropout_frac": 0.25, "dropout_start": 4,
        "dropout_len": 40}},
    "exponential": {"latency": "exponential", "delay": 1.0},
}


@pytest.mark.parametrize("name", sorted(RESUME_OPTIONS))
def test_stream_resume_reproduces_uninterrupted_run_bitwise(tmp_path, name):
    """SIGTERM at half the events and ``resume`` land on the state the
    uninterrupted run reaches, bitwise: the step-indexed draws, the fault
    plan's per-run stream and the restored latency stream."""
    cfg = AFMConfig(side=4, dim=3, i_max=96)
    rng = np.random.default_rng(0)
    xtr = rng.normal(size=(120, 3)).astype(np.float32)
    xte = rng.normal(size=(32, 3)).astype(np.float32)
    common = dict(backend="async", backend_options=RESUME_OPTIONS[name],
                  events=96, chunk=24, swap_every=48, clients=0,
                  min_client_reads=0, name="m", seed=7, device="cpu")

    r1 = run_stream(cfg, xtr, xte, store_root=str(tmp_path / "a"), **common)
    assert not r1.interrupted and r1.qe_finite

    ckdir = str(tmp_path / "ck")
    r2 = run_stream(cfg, xtr, xte, store_root=str(tmp_path / "b"),
                    checkpoint_dir=ckdir, checkpoint_every=24,
                    die_after=48, **common)
    assert r2.interrupted and r2.events == 48
    assert r2.checkpoint_path == ckdir

    logs = []
    r3 = run_stream(cfg, xtr, xte, store_root=str(tmp_path / "b"),
                    checkpoint_dir=ckdir, resume=True,
                    log=lambda *a: logs.append(" ".join(map(str, a))),
                    **common)
    assert not r3.interrupted and r3.qe_finite
    assert r3.resumed_from["consumed"] == 48
    assert any("checksum verified" in line for line in logs)

    wa, ia = _store_map(str(tmp_path / "a"))
    wb, ib = _store_map(str(tmp_path / "b"))
    assert ia == ib == 96
    assert torch.equal(wa, wb)


def test_stream_resume_rejects_config_mismatch(tmp_path):
    rng = np.random.default_rng(0)
    xtr = rng.normal(size=(60, 3)).astype(np.float32)
    xte = rng.normal(size=(16, 3)).astype(np.float32)
    ckdir = str(tmp_path / "ck")
    common = dict(backend="async", events=48, chunk=24, swap_every=48,
                  clients=0, min_client_reads=0, name="m", seed=7,
                  device="cpu")
    run_stream(AFMConfig(side=4, dim=3, i_max=48), xtr, xte,
               checkpoint_dir=ckdir, checkpoint_every=24, die_after=24,
               **common)
    with pytest.raises(ValueError, match="does not match"):
        run_stream(AFMConfig(side=6, dim=3, i_max=48), xtr, xte,
                   checkpoint_dir=ckdir, resume=True, **common)


def test_step_draws_depend_on_the_step_alone():
    """``GeneratorDraws.for_step``: the same (seed, step) gives the same
    numbers whatever came before; other steps and seeds, and a spawned
    child, give others."""
    a = GeneratorDraws.for_step(7, 3, "cpu").uniform((8,))
    GeneratorDraws.for_step(7, 2, "cpu").uniform((100,))
    assert torch.equal(a, GeneratorDraws.for_step(7, 3, "cpu").uniform((8,)))
    for other in (GeneratorDraws.for_step(7, 4, "cpu"),
                  GeneratorDraws.for_step(8, 3, "cpu"),
                  GeneratorDraws(7, "cpu").spawn()):
        assert not torch.equal(a, other.uniform((8,)))


# ------------------------------------------------- parity with JAX


@pytest.mark.parametrize("search", ["exact", "heuristic"])
def test_stream_matches_jax_run_stream(tmp_path, monkeypatch, search):
    """The port's loop and JAX's, zero latency, on the same data: the port
    fed JAX's initial state and JAX's per-step draws. The final published
    weights within the ulp contract, the sample count equal; JAX loads the
    port's artifact (backend ``kernel`` read as ``batched``)."""
    seed, chunk, events = 7, 24, 96
    kw = dict(side=4, dim=3, i_max=events, e_factor=0.5)
    rng = np.random.default_rng(1)
    xtr = rng.normal(size=(120, 3)).astype(np.float32)
    xte = rng.normal(size=(32, 3)).astype(np.float32)
    opts = {"search": search}
    common = dict(backend="async", backend_options=opts, events=events,
                  chunk=chunk, swap_every=48, clients=0, min_client_reads=0,
                  name="m", seed=seed)
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    jrun_stream(jax_cfg(**kw), xtr, xte, store_root=jroot, **common)

    jcfg = jax_cfg(**kw)
    k_init, k_step0 = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(seed), 0))
    jstate = jafm.init(k_init, jcfg, xtr[:chunk])
    monkeypatch.setattr(AsyncBackend, "init",
                        lambda self, draws, samples=None:
                        state_from_numpy(jstate, "cpu"))

    def draws_for_step(step):
        key = k_step0 if step == 0 else jax.random.fold_in(
            jax.random.PRNGKey(seed), step)
        return JaxStepDraws(jax.random.split(key, chunk), jcfg, tev.WAVE_CAP)

    rep = run_stream(AFMConfig(**kw), xtr, xte, store_root=troot,
                     device="cpu", draws_for_step=draws_for_step, **common)
    assert rep.events == events and rep.qe_finite

    jart = JMapStore(jroot).load_artifact("m")
    tw, ti = _store_map(troot)
    wj = np.asarray(jart.state.w)
    assert int(jart.state.i) == ti == events
    assert np.abs(wj - tw.numpy()).max() <= W_ULPS * F32_EPS * np.abs(
        wj).max()
    loaded = JTopoMap.load(MapStore(troot).path("m"), backend="batched")
    np.testing.assert_array_equal(np.asarray(loaded.state_.w), tw.numpy())


# --------------------------------------------------------------- the CLI


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.stream_train",
         "--device", "cpu", "--dataset", "satimage", "--side", "4",
         "--events", "96", "--chunk", "24", "--swap-every", "48",
         "--clients", "1", "--train-size", "200", "--eval-size", "32",
         *args], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_stream_cli_die_after_then_resume(tmp_path):
    """``--die-after`` stops the CLI through a real SIGTERM with a
    checkpoint; ``--resume`` verifies it and finishes on the uninterrupted
    run's map, bitwise."""
    ck = str(tmp_path / "ck")
    full = _cli("--store", str(tmp_path / "a"), "--name", "m")
    assert "finite=True" in full
    cut = _cli("--store", str(tmp_path / "b"), "--name", "m",
               "--checkpoint-dir", ck, "--die-after", "48")
    assert "stream interrupted at 48 events" in cut
    resumed = _cli("--store", str(tmp_path / "b"), "--name", "m",
                   "--checkpoint-dir", ck, "--resume")
    assert "checkpoint checksum verified" in resumed
    assert "stream qe:" in resumed and "finite=True" in resumed
    wa, ia = _store_map(str(tmp_path / "a"))
    wb, ib = _store_map(str(tmp_path / "b"))
    assert ia == ib == 96 and torch.equal(wa, wb)


def test_stream_cli_shards_need_the_mesh():
    """``--shards`` is the async backend's mesh: with another backend the
    CLI exits with JAX's message; with it, one process outside a process
    group is told how to start the ranks."""
    with pytest.raises(SystemExit) as err:
        stream_train.main(["--device", "cpu", "--backend", "batched",
                           "--shards", "2"])
    assert str(err.value) == ("--latency/--delay/--engine/--lat-seed/"
                              "--shards/--p-loss/--dropout-* only apply to "
                              "the async backend")
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2 -m "
                       "repro_torch.launch.stream_train"):
        stream_train.main(["--device", "cpu", "--shards", "2"])
    with pytest.raises(SystemExit, match="only apply to the async"):
        stream_train.main(["--device", "cpu", "--backend", "batched",
                           "--p-loss", "0.1"])
