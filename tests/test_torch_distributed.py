"""The sharded backend (``repro_torch.core.distributed``,
``TopoMap(backend="sharded")``) and the port's mesh of ranks
(``repro_torch.sharding``), against the JAX package on the CPU.

The JAX side runs in a subprocess with four forced host devices: a few
``make_sharded_train_step`` steps on (1, 1), (1, 2) and (2, 2) meshes at
side 8, dim 36, writing every step's input state, samples, outputs and
each rank's draws (the probes from ``fold_in(fold_in(key, data index),
model index)``, the drive and per-wave draws from ``fold_in(fold_in(key,
10_000_019), model index)``). The port runs the same steps on gloo ranks on
the CPU (the 1 x 1 mesh in this process, with no process group), each from
JAX's input state, on the replayed draws. Tolerances: counters, cascade
sizes and wave counts bitwise; w within ``W_ULPS`` ulps of the largest
weight; the batch's mean q2 within ``Q2_ULPS`` ulps of its value.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.api import TopoMap as JTopoMap
from repro.api.persistence import load_artifact as jload_artifact
from repro_torch.api import TopoMap, get_backend
from repro_torch.core import afm as tafm
from repro_torch.draws import GeneratorDraws
from repro_torch.sharding import ShardMesh, init_distributed, rank_device
from torch_parity import F32_EPS, jax_cfg, run_ranks, torch_cfg
import torch_ranks

_HERE = os.path.dirname(os.path.abspath(__file__))
W_ULPS = 8
Q2_ULPS = 64
RANK_TIMEOUT = 240.0
MESHES = [(1, 1), (1, 2), (2, 2)]

_JAX_SIDE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from repro.core import afm, distributed
from repro.sharding import compat

out_dir = sys.argv[1]
STEPS, B, I_MAX = 4, 8, 320
cfg = afm.AFMConfig(side=8, dim=36, batch=B, i_max=I_MAX, e_factor=0.5,
                    theta=2)
k_init, k_data, k_steps = jax.random.split(jax.random.PRNGKey(7), 3)
data = jax.random.uniform(k_data, (256, cfg.dim))
keys = jax.random.split(k_steps, STEPS)


def chain(key, count, shape):
    def body(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.uniform(sub, shape)
    return jax.lax.scan(body, key, None, length=max(count, 1))[1]


for n_data, n_model in [(1, 1), (1, 2), (2, 2)]:
    mesh = compat.make_mesh((n_data, n_model), ("data", "model"))
    step_fn, _ = distributed.make_sharded_train_step(cfg, mesh)
    step = jax.jit(step_fn)
    rows = cfg.side // n_model
    L, e_local, b = rows * cfg.side, max(1, cfg.e // n_model), B // n_data
    state = afm.init(k_init, cfg, data)
    out = dict(far=state.far, near=state.near, steps=STEPS, batch=B,
               i_max=I_MAX, theta=cfg.theta)
    for s in range(STEPS):
        samples = data[s * B:(s + 1) * B]
        out.update({f"w_in{s}": state.w, f"c_in{s}": state.c,
                    f"i_in{s}": state.i, f"samples{s}": samples})
        sst = distributed.shard_state_for_mesh(state, cfg, mesh)
        new, aux = step(sst, samples, keys[s])
        out.update({f"w_out{s}": new.w.reshape(cfg.n_units, cfg.dim),
                    f"c_out{s}": new.c, f"size{s}": aux.cascade_size,
                    f"waves{s}": aux.waves, f"mean_q2{s}": aux.mean_q2})
        for me in range(n_model):
            for didx in range(n_data):
                k_search = jax.random.fold_in(
                    jax.random.fold_in(keys[s], didx), me)
                kp = jax.random.split(jax.random.split(k_search)[0])[0]
                out[f"probes{s}_{didx}_{me}"] = jax.random.randint(
                    kp, (b, e_local), 0, L)
            kd, kc = jax.random.split(jax.random.fold_in(
                jax.random.fold_in(keys[s], 10_000_019), me))
            out[f"drive{s}_{me}"] = jax.random.uniform(kd,
                                                       (8, rows, cfg.side))
            out[f"wave{s}_{me}"] = chain(kc, int(aux.waves),
                                         (4, rows, cfg.side))
        state = afm.AFMState(w=new.w.reshape(cfg.n_units, cfg.dim), c=new.c,
                             far=state.far, near=state.near, i=new.i)
    np.savez(os.path.join(out_dir, f"mesh{n_data}x{n_model}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
print("ok")
"""


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """JAX's steps on each mesh, and the port's on as many ranks."""
    root = tmp_path_factory.mktemp("sharded")
    script = root / "jax_sharded.py"
    script.write_text(_JAX_SIDE)
    env = dict(os.environ, PYTHONPATH=os.path.join(_HERE, "..", "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, str(script), str(root)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = {}
    for shape in MESHES:
        path = str(root / f"mesh{shape[0]}x{shape[1]}.npz")
        k = shape[0] * shape[1]
        ranks = ([torch_ranks.sharded_steps(0, path, shape)] if k == 1 else
                 run_ranks(torch_ranks.sharded_steps, k, RANK_TIMEOUT, path,
                           shape))
        res[shape] = (dict(np.load(path)), ranks)
    return res


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_matches_jax(steps, shape):
    """Each step from JAX's input state on JAX's draws: counters, sizes
    and waves bitwise, w within 8 ulps, mean q2 within 64 ulps, every
    rank's dense state alike, and every wave draw consumed."""
    z, ranks = steps[shape]
    assert sum(int(z[f"waves{s}"]) for s in range(int(z["steps"]))) > 0
    for s, got in enumerate(ranks[0]):
        np.testing.assert_array_equal(got["c"], z[f"c_out{s}"])
        assert got["size"] == int(z[f"size{s}"])
        assert got["waves"] == int(z[f"waves{s}"])
        assert got["i"] == int(z[f"i_in{s}"]) + int(z["batch"])
        assert got["left"] == 0
        wj = z[f"w_out{s}"]
        assert np.abs(got["w"] - wj).max() <= W_ULPS * F32_EPS * np.abs(
            wj).max()
        q = float(z[f"mean_q2{s}"])
        assert abs(got["mean_q2"] - q) <= Q2_ULPS * F32_EPS * q
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[s]["w"], got["w"])
            np.testing.assert_array_equal(other[s]["c"], got["c"])


# ------------------------------------------------------------- the mesh


def test_shard_mesh_collectives():
    """``all_gather`` bitwise (-0.0, NaN, a subnormal, bools) along a
    sub-group, ``psum`` / ``pmax`` / ``ppermute`` on a 2 x 2 mesh."""
    ranks = run_ranks(torch_ranks.collectives, 4, RANK_TIMEOUT)
    want_bits = torch.tensor([-0.0, 0.0, float("nan"), 1e-45]).view(
        torch.int32)
    for rank, r in enumerate(ranks):
        d, m = divmod(rank, 2)
        assert r["coords"] == (d, m)
        for col in range(2):
            bits = want_bits.clone()
            bits[1] = torch.tensor(float(2 * d + col)).view(torch.int32)
            np.testing.assert_array_equal(r["gather_model"][col], bits)
        np.testing.assert_array_equal(r["gather_bool"], [[m == 0], [m == 0]])
        np.testing.assert_array_equal(r["psum_data"], [m + (2 + m), 2])
        np.testing.assert_array_equal(r["pmax_model"], [2 * d + 1])
        np.testing.assert_array_equal(r["ppermute"],
                                      [2 * d + 10] if m == 1 else [0])
        assert r["calls"] == 5


def test_shard_mesh_needs_its_process_group():
    m = ShardMesh((1, 1), ("data", "model"))
    assert m.rank == 0 and m.coords == (0, 0) and m.dist_backend is None
    x = torch.arange(3.0)
    assert torch.equal(m.all_gather(x, "model"), x[None])
    assert torch.equal(m.psum(x, "data"), x) and m.calls == 0
    assert torch.equal(m.ppermute(x, "model", [(0, 0)]), x)
    with pytest.raises(RuntimeError, match="initialise torch.distributed"):
        ShardMesh((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="unique name"):
        ShardMesh((1, 1), ("data", "data"))
    with pytest.raises(ValueError, match=">= 1"):
        ShardMesh((0, 1), ("data", "model"))


def test_nccl_is_never_switched_quietly():
    """NCCL on more ranks than cards raises, naming gloo; an unknown
    transport raises; the ranks' devices follow the transport."""
    with pytest.raises(ValueError, match="dist_backend='gloo'"):
        init_distributed(0, 2, dist_backend="nccl",
                         init_method="file:///nonexistent")
    with pytest.raises(ValueError, match="dist_backend must be one of"):
        init_distributed(0, 1, dist_backend="mpi")
    assert rank_device("nccl", 3) == torch.device("cuda", 3)
    assert rank_device("gloo", 3, "cpu") == torch.device("cpu")
    assert rank_device("gloo", 3) == torch.device("cuda")


# ----------------------------------------------- the backend, one rank


KW = dict(side=6, dim=12, i_max=96, batch=4, e_factor=0.5, theta=2)
X = np.random.default_rng(3).standard_normal((256, 12)).astype(np.float32)


def test_topomap_sharded_one_by_one():
    """``TopoMap(backend="sharded")`` on its default 1 x 1 mesh (no process
    group): one seed replays bitwise, QE falls, the state is dense, and
    ``partial_fit`` goes on from it."""
    a = TopoMap(torch_cfg(**KW), backend="sharded", device="cpu").fit(X)
    b = TopoMap(torch_cfg(**KW), backend="sharded", device="cpu").fit(X)
    assert torch.equal(a.state_.w, b.state_.w)
    assert a.state_.w.shape == (36, 12) and a.state_.i == 96
    assert a.fit_aux_.cascade_size.shape == (24,)
    assert int(a.fit_aux_.waves.sum()) > 0
    init = TopoMap.from_state(tafm.init(GeneratorDraws(0, "cpu"), a.cfg,
                                        torch.from_numpy(X)), a.cfg,
                              device="cpu")
    assert a.quantization_error(X) < init.quantization_error(X)
    a.partial_fit(X[:4])
    assert a.state_.i == 100
    idx, q2 = a.backend.bmu(a.state_.w, torch.from_numpy(X[:8]))
    assert torch.equal(idx.long(), a.transform(X[:8]).long())
    with pytest.raises(ValueError, match="must divide over the data axes"):
        get_backend("sharded", torch_cfg(**dict(KW, batch=3)), device="cpu",
                    mesh=_FakeMesh())


class _FakeMesh:
    """A (2, 1) mesh's shape, to reach the batch check without ranks."""

    def axis_size(self, axis):
        return {"data": 2, "model": 1}[axis]

    def axis_index(self, axis):
        return 0


def test_sharded_artifact_round_trip(tmp_path):
    """A JAX 'sharded' artifact loads onto the port's 1 x 1 mesh, and the
    port's loads back into JAX's: transforms bitwise both ways."""
    from repro.api.persistence import save_artifact as jsave
    j = JTopoMap(jax_cfg(**KW)).fit(X, key=jax.random.PRNGKey(7))
    path = str(tmp_path / "jax")
    jsave(path, cfg=j.cfg, state=j.state_, backend="sharded")
    tm = TopoMap.load(path, device="cpu")
    assert tm.backend.name == "sharded"
    assert tm.backend.mesh.shape == {"data": 1, "model": 1}
    np.testing.assert_array_equal(tm.transform(X).numpy(),
                                  np.asarray(j.transform(X)))
    back = str(tmp_path / "port")
    tm.save(back)
    assert jload_artifact(back).backend == "sharded"
    jb = JTopoMap.load(back)
    np.testing.assert_array_equal(np.asarray(jb.transform(X)),
                                  tm.transform(X).numpy())
