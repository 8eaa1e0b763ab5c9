"""The port's train-and-serve loop on the mesh
(``repro_torch.launch.stream_train`` with ``placement="mesh"``) on 2 gloo
ranks on the CPU, against the JAX package's ``run_stream`` on 2 forced
XLA devices.

The JAX side runs once, in a subprocess with
``--xla_force_host_platform_device_count=2`` (``tests/test_torch_mesh.py``'s
way), store backed: JAX's in-memory mesh stream fails at its final QE (the
reference's ``ShardingTypeError`` in ``serving/maps.py``, ROADMAP queue 3),
its store-backed one runs. The subprocess wraps the async backend's
``init`` and ``step`` to record the initial state, each step's key and its
cascade sizes, and writes every step's per-shard draws
(``fold_in(key, shard)`` chains, as ``tests/test_torch_mesh.py``). The port
replays them through ``run_stream``'s ``draws_for_step`` seam
(``torch_ranks.stream_step_draws``).

Tolerances as ``tests/test_torch_mesh.py``: the final artifact's ``c`` and
``i`` bitwise, ``w`` within ``W_ULPS`` ulps of the largest weight. A
resumed mesh stream is the uninterrupted one's bitwise, at exponential
latency too (the latency stream's one generator state is every shard's
position).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.launch import stream_train as jstream_train
from repro_torch.launch import stream_train
from torch_parity import F32_EPS, run_ranks
import torch_ranks

_HERE = os.path.dirname(os.path.abspath(__file__))
W_ULPS = 8
RANK_TIMEOUT = 240.0
SHARDS = 2
SEARCHES = ("exact", "heuristic")

_JAX_SIDE = r"""
import json, os, sys
spec = json.loads(sys.argv[2])
os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count={spec['shards']}")
import jax
import numpy as np
from repro.api import AFMConfig, MapStore
from repro.launch import stream_train
from repro.training import async_trainer

out_dir, K = sys.argv[1], spec["shards"]
calls, inits = [], []
step0, init0 = async_trainer.AsyncBackend.step, async_trainer.AsyncBackend.init


def init(self, key, samples=None):
    st = init0(self, key, samples)
    inits.append(st)
    return st


def step(self, state, samples, key):
    state, aux = step0(self, state, samples, key)
    calls.append((key, np.asarray(aux.cascade_size)))
    return state, aux


async_trainer.AsyncBackend.init, async_trainer.AsyncBackend.step = init, step


def scan_split(key, count, draw):
    def body(k, _):
        k, sub = jax.random.split(k)
        return k, draw(sub)
    return jax.lax.scan(body, key, None, length=max(count, 1))[1]


rng = np.random.default_rng(1)
xtr = rng.normal(size=(120, 3)).astype(np.float32)
xte = rng.normal(size=(32, 3)).astype(np.float32)
cfg = AFMConfig(**spec["cfg"])
rows, side = cfg.side // K, cfg.side
L, e_local = rows * side, max(1, cfg.e // K)
for search in spec["searches"]:
    calls.clear(), inits.clear()
    root = os.path.join(out_dir, f"jax-{search}")
    rep = stream_train.run_stream(
        cfg, xtr, xte, backend="async", store_root=root, clients=0,
        min_client_reads=0,
        backend_options={"placement": "mesh", "shards": K, "search": search},
        **spec["run"])
    art = MapStore(root).load_artifact(spec["run"]["name"])
    st0 = inits[0]
    out = dict(xtr=xtr, xte=xte, w0=st0.w, c0=st0.c, far=st0.far,
               near=st0.near, w=art.state.w, c=art.state.c, i=art.state.i,
               qe=rep.qe)
    for s, (key, sizes) in enumerate(calls):
        step_keys = jax.random.split(key, len(sizes))
        pairs = jax.vmap(jax.random.split)(step_keys)
        k_search, k_cascade = pairs[:, 0], pairs[:, 1]
        dc = jax.vmap(jax.random.split)(k_cascade)
        bound = 4 * sizes
        for me in range(K):
            fold = jax.vmap(lambda k: jax.random.fold_in(k, me))
            if search == "heuristic":
                out[f"s{s}_probes{me}"] = jax.vmap(
                    lambda k: jax.random.randint(k, (e_local,), 0, L))(
                        fold(k_search))
            out[f"s{s}_drive{me}"] = jax.vmap(
                lambda k: jax.random.uniform(k, ()))(fold(dc[:, 0]))
            allr = np.asarray(jax.vmap(lambda k: scan_split(
                k, int(bound.max()),
                lambda u: jax.random.uniform(u, (4, rows, side))))(
                    fold(dc[:, 1])))
            out[f"s{s}_rounds{me}"] = np.concatenate(
                [allr[ev, :bound[ev]] for ev in range(len(sizes))])
            out[f"s{s}_roff{me}"] = np.concatenate([[0], np.cumsum(bound)])
    np.savez(os.path.join(out_dir, f"{search}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
print("ok")
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's store-backed mesh stream for each search, started once for
    the module: the subprocess runs while the port-only tests do."""
    root = tmp_path_factory.mktemp("jax_stream_mesh")
    script = root / "jax_stream_mesh.py"
    script.write_text(_JAX_SIDE)
    spec = {"shards": SHARDS, "searches": list(SEARCHES),
            "cfg": torch_ranks.STREAM_MESH, "run": torch_ranks.STREAM_RUN}
    env = dict(os.environ, PYTHONPATH=os.path.join(_HERE, "..", "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, str(script), str(root), json.dumps(spec)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield root, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def resumed(jax_side, tmp_path_factory):
    """The port's mesh stream killed and resumed at zero and exponential
    latency, and in memory (``torch_ranks.stream_mesh_resume``)."""
    root = tmp_path_factory.mktemp("stream_mesh_resume")
    return run_ranks(torch_ranks.stream_mesh_resume, SHARDS, RANK_TIMEOUT,
                     str(root), ["zero", "exponential"])


@pytest.fixture(scope="module")
def parity(jax_side, tmp_path_factory):
    """JAX's npz for each search and the port's ranks on its draws."""
    root, proc = jax_side
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    troot = tmp_path_factory.mktemp("stream_mesh_port")
    cases = [(str(root / f"{s}.npz"), s, str(troot / s)) for s in SEARCHES]
    ranks = run_ranks(torch_ranks.stream_mesh_parity, SHARDS, RANK_TIMEOUT,
                      cases, SHARDS)
    return {s: (dict(np.load(cases[k][0])), [r[k] for r in ranks])
            for k, s in enumerate(SEARCHES)}


@pytest.mark.parametrize("latency", ["zero", "exponential"])
def test_mesh_stream_resume_is_the_uninterrupted_run(resumed, latency):
    """Killed by ``die_after`` at half the events and resumed, the mesh
    stream ends on the uninterrupted run's artifact bitwise, on every rank
    alike; at exponential latency every shard's latency stream resumes
    where it stopped."""
    r0, r1 = (r[latency] for r in resumed)
    for r in (r0, r1):
        assert r["verified"]
        assert r["cut"]["interrupted"] and r["cut"]["events"] == 48
        assert not r["res"]["interrupted"] and r["res"]["events"] == 96
        assert r["full"]["swaps"] == r["res"]["swaps"] == 2
    a, b = r0["arts"]
    assert a["i"] == b["i"] == 96
    np.testing.assert_array_equal(a["c"], b["c"])
    np.testing.assert_array_equal(a["w"], b["w"])
    for key in ("full", "res"):
        np.testing.assert_array_equal(r0[key]["w"], r1[key]["w"])
        assert r0[key]["seconds"] == r1[key]["seconds"]
    np.testing.assert_array_equal(r0["res"]["w"], a["w"])


def test_mesh_stream_in_memory_serves_from_rank_0(resumed):
    """In memory, rank 0 serves a reader and answers a finite QE; its
    final served map is the store-backed run's; the other rank serves
    nothing (no reads, an empty QE) and holds the same state."""
    mem0, mem1 = (r["memory"] for r in resumed)
    store = resumed[0]["zero"]
    assert mem0["errors"] == 0 and mem0["reads"] >= 1
    assert mem0["qe"].shape == (32,) and np.isfinite(mem0["qe"]).all()
    np.testing.assert_array_equal(mem0["w"], store["arts"][0]["w"])
    np.testing.assert_array_equal(mem0["qe"], store["full"]["qe"])
    assert mem1["reads"] == 0 and mem1["qe"].shape == (0,)
    assert mem1["dispatches"] == 0
    np.testing.assert_array_equal(mem1["w"], mem0["w"])
    assert mem0["swaps"] == mem1["swaps"] == 2


def test_mesh_stream_cli_die_after_then_resume(tmp_path):
    """``main(["--shards", "2", ...])`` on 2 ranks: killed by
    ``--die-after`` through a real SIGTERM on every rank and resumed, it
    ends on the uninterrupted run's artifact bitwise; only rank 0
    prints and serves."""
    r0, r1 = run_ranks(torch_ranks.stream_mesh_cli, SHARDS, RANK_TIMEOUT,
                       str(tmp_path))
    full, cut, res, arts = r0
    assert [x["events"] for x in (full, cut, res)] == [96, 48, 96]
    assert cut["interrupted"] and "stream interrupted at 48 events" in \
        cut["stdout"]
    assert "checkpoint checksum verified" in res["stdout"]
    assert "2 ranks over gloo" in full["stdout"]
    assert "finite=True" in res["stdout"] and full["reads"] >= 1
    assert all(x["stdout"] == "" and x["reads"] == 0 for x in r1)
    assert [x["events"] for x in r1] == [96, 48, 96]
    a, b = arts["arts"]
    assert a["i"] == b["i"] == 96
    np.testing.assert_array_equal(a["w"], b["w"])
    np.testing.assert_array_equal(a["c"], b["c"])


@pytest.mark.parametrize("argv", [
    ["--backend", "sharded", "--search", "exact"],
    ["--backend", "batched", "--shards", "2"],
], ids=["sharded-search", "batched-shards"])
def test_stream_cli_refusals_match_jax(monkeypatch, argv):
    """The CLI refuses what JAX's refuses, with JAX's ``SystemExit``
    message."""
    monkeypatch.setattr(sys, "argv", ["stream_train", *argv,
                                      "--train-size", "64",
                                      "--eval-size", "16"])
    with pytest.raises(SystemExit) as want:
        jstream_train.main()
    with pytest.raises(SystemExit) as got:
        stream_train.main(["--device", "cpu", *argv])
    assert isinstance(want.value.code, str)
    assert got.value.code == want.value.code


@pytest.mark.parametrize("search", SEARCHES)
def test_mesh_stream_matches_jax_run_stream(parity, search):
    """The port's store-backed mesh stream on JAX's initial state and
    per-step per-shard draws against JAX's on 2 forced devices: the final
    artifact's ``c`` and ``i`` bitwise, ``w`` within ``W_ULPS`` ulps of
    max |w|; every rank holds the same state."""
    z, ranks = parity[search]
    art = ranks[0]["art"]
    assert int(z["i"]) == art["i"] == 96
    np.testing.assert_array_equal(art["c"], z["c"])
    wj = z["w"]
    assert np.abs(art["w"] - wj).max() <= W_ULPS * F32_EPS * np.abs(
        wj).max()
    np.testing.assert_array_equal(ranks[0]["w"], art["w"])
    for other in ranks[1:]:
        np.testing.assert_array_equal(other["w"], ranks[0]["w"])
        np.testing.assert_array_equal(other["c"], ranks[0]["c"])
    assert all(r["events"] == 96 for r in ranks)
    assert np.isfinite(ranks[0]["qe"]).all() and np.isfinite(z["qe"]).all()
