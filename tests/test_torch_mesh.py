"""The mesh placement of the port's event engine
(``repro_torch.core.placement.mesh``), against the JAX package on the CPU.

The JAX side runs once per shard count, in a subprocess with
``--xla_force_host_platform_device_count=K`` as ``tests/test_placement.py``
does, and writes each case's outputs and every shard's draws to
``tmp_path``: per sample event the probes (heuristic search), the drive
and the cascade chain's per-round draws (``fold_in(key, shard)``), and the
latency (``fold_in(lat_key, shard)``) and fault (``fold_in(PRNGKey(seed),
shard)``) streams, both shapes at every draw site. The port runs K gloo
ranks on the CPU on those draws replayed (``torch_ranks.mesh_case``).

Tolerances as ``tests/test_torch_events.py``: integers, the report (every
shard's accounting row too) and the float32 times bitwise; weights within
``W_ULPS`` ulps of the largest weight; q2 within 4x the BMU tie bound.
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.core import afm as jafm
from repro.core import events as jev
from repro.core.placement import MeshPlacement as JMeshPlacement
from repro.faults import FaultPlan as JFaultPlan
from repro_torch.core import afm as tafm
from repro_torch.core import events as tev
from repro_torch.core.placement import MeshPlacement, resolve_placement
from repro_torch.draws import GeneratorDraws
from repro_torch.faults import FaultPlan
from torch_parity import assert_same_run, run_ranks, t, torch_cfg
import torch_ranks

_HERE = os.path.dirname(os.path.abspath(__file__))
W_ULPS = 8
RANK_TIMEOUT = 240.0

#: ``tests/test_placement.py``'s composite plan (loss, a dropout window and
#: a straggler shard), at 128 events
_COMPOSITE = dict(seed=21, p_loss=0.15, dropout_frac=0.2, dropout_start=32.0,
                  dropout_len=64.0)


def _case(latency, search, *, delay=1.0, events=160, hot=True, faults=None,
          seed=11):
    return dict(latency=latency, delay=0.0 if latency == "zero" else delay,
                search=search, events=events, hot=hot, faults=faults,
                seed=seed, i_max=1024)


CASES = {
    2: {
        "zero-heuristic": _case("zero", "heuristic", hot=False, events=192),
        "zero-exact": _case("zero", "exact"),
        "constant-heuristic": _case("constant", "heuristic"),
        "constant-exact": _case("constant", "exact"),
        "exponential-heuristic": _case("exponential", "heuristic"),
        "exponential-exact": _case("exponential", "exact", delay=0.5),
        "faults-heuristic": _case("constant", "heuristic", delay=0.5,
                                  events=128, faults=dict(
                                      _COMPOSITE,
                                      shard_latency_mult=(1.0, 3.0))),
    },
    3: {
        "zero-heuristic": _case("zero", "heuristic", events=128),
        "constant-exact": _case("constant", "exact", events=128),
        "exponential-heuristic": _case("exponential", "heuristic",
                                       events=128),
        "faults-exact": _case("exponential", "exact", delay=0.5, events=128,
                              faults=dict(_COMPOSITE,
                                          shard_latency_mult=(1.0, 3.0, 2.0))),
    },
}

_JAX_SIDE = r"""
import json, os, sys
K = int(sys.argv[2])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={K}"
import jax
import jax.numpy as jnp
import numpy as np
from repro.core import afm, events
from repro.faults import FaultPlan

out_dir, cases = sys.argv[1], json.loads(sys.argv[3])
p_one = lambda i, c: jnp.float32(1.0)


def scan_split(key, count, draw):
    # ``count`` draw sites of one key chain: split, then draw(sub)
    def body(k, _):
        k, sub = jax.random.split(k)
        return k, draw(sub)
    return jax.lax.scan(body, key, None, length=max(count, 1))[1]


for name, sp in cases.items():
    cfg = afm.AFMConfig(side=6, dim=3, i_max=sp["i_max"], e_factor=1.0)
    k_init, k_data, k_steps = jax.random.split(jax.random.PRNGKey(sp["seed"]),
                                               3)
    E = sp["events"]
    samples = jax.random.uniform(k_data, (E, cfg.dim))
    st0 = afm.init(k_init, cfg, samples)
    step_keys = jax.random.split(k_steps, E)
    plan = FaultPlan(**sp["faults"]) if sp["faults"] else None
    ecfg = events.EventConfig(latency=sp["latency"], delay=sp["delay"],
                              engine="event", faults=plan)
    lat_key = jax.random.PRNGKey(5)
    heuristic = sp["search"] == "heuristic"
    kw = dict(p_fn=p_one) if sp["hot"] else {}
    st, aux, rep = events.run_events(
        st0, samples, step_keys, cfg, ecfg,
        search=afm.search_heuristic if heuristic else afm.search_exact,
        lat_key=lat_key, placement="mesh", shards=K, **kw)
    rows, side = cfg.side // K, cfg.side
    L, e_local = rows * side, max(1, cfg.e // K)
    out = dict(w0=st0.w, c0=st0.c, far=st0.far, near=st0.near,
               samples=samples, w=st.w, c=st.c, i=st.i)
    out.update({f"aux_{f}": getattr(aux, f) for f in aux._fields})
    out.update({f"rep_{f}": getattr(rep, f) for f in rep._fields})
    if plan is not None and plan.dropout_active:
        out["dead"] = plan.dead_units(cfg.n_units)
    # each round of a cascade on a shard takes one of its messages at least,
    # and it sends at most 4 a firing; each draw site of the latency and
    # fault streams is a fire or an exchange: at most 2 a round
    bound = 4 * np.asarray(aux.cascade_size)
    n_sites = 2 * int(rep.rounds) + 2
    pairs = jax.vmap(jax.random.split)(step_keys)
    k_search, k_cascade = pairs[:, 0], pairs[:, 1]
    dc = jax.vmap(jax.random.split)(k_cascade)
    for me in range(K):
        fold = jax.vmap(lambda k: jax.random.fold_in(k, me))
        if heuristic:
            out[f"probes{me}"] = jax.vmap(lambda k: jax.random.randint(
                k, (e_local,), 0, L))(fold(k_search))
        out[f"drive{me}"] = jax.vmap(lambda k: jax.random.uniform(k, ()))(
            fold(dc[:, 0]))
        chains = fold(dc[:, 1])
        rmax = int(bound.max())
        allr = np.asarray(jax.vmap(lambda k: scan_split(
            k, rmax, lambda s: jax.random.uniform(s, (4, rows, side))))(
                chains))
        out[f"rounds{me}"] = np.concatenate(
            [allr[ev, :bound[ev]] for ev in range(E)])
        out[f"roff{me}"] = np.concatenate([[0], np.cumsum(bound)])
        shapes = ((4 * L,), (2 * side,))
        if sp["latency"] == "exponential":
            four, two = scan_split(jax.random.fold_in(lat_key, me), n_sites,
                                   lambda s: tuple(jax.random.exponential(
                                       s, sh) for sh in shapes))
            out[f"lat4_{me}"], out[f"lat2_{me}"] = four, two
        if plan is not None and plan.p_loss > 0:
            four, two = scan_split(
                jax.random.fold_in(jax.random.PRNGKey(plan.seed), me),
                n_sites, lambda s: tuple(jax.random.uniform(s, sh)
                                         for sh in shapes))
            out[f"flt4_{me}"], out[f"flt2_{me}"] = four, two
    np.savez(os.path.join(out_dir, f"{name}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
print("ok")
"""


def _jax_side(root, k):
    script = os.path.join(root, "jax_mesh.py")
    with open(script, "w") as f:
        f.write(_JAX_SIDE)
    env = dict(os.environ, PYTHONPATH=os.path.join(_HERE, "..", "src"))
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, script, str(root), str(k), json.dumps(CASES[k])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case of both shard counts: the JAX side's npz and the port's
    result on each rank."""
    roots = {k: tmp_path_factory.mktemp(f"mesh{k}") for k in CASES}
    procs = {k: _jax_side(roots[k], k) for k in CASES}
    out = {}
    try:
        # the 3-shard side has fewer cases: its ranks run while JAX's
        # 2-shard side still compiles
        for k in sorted(CASES, reverse=True):
            _, err = procs[k].communicate(timeout=600)
            assert procs[k].returncode == 0, err[-3000:]
            paths = [str(roots[k] / f"{name}.npz") for name in CASES[k]]
            ranks = run_ranks(torch_ranks.mesh_cases, k, RANK_TIMEOUT,
                              list(zip(paths, CASES[k].values())), k)
            for i, (name, path) in enumerate(zip(CASES[k], paths)):
                out[k, name] = (dict(np.load(path)), [r[i] for r in ranks])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _as_run(d, prefix_aux="", prefix_rep=""):
    """A (state, aux, report) of namespaces over one side's arrays."""
    def ns(fields, prefix):
        return types.SimpleNamespace(**{f: d[prefix + f] for f in fields})
    st = types.SimpleNamespace(w=d["w"], c=d["c"], i=d["i"])
    aux = ns(("gmu", "q2", "cascade_size", "waves", "greedy_steps"),
             prefix_aux)
    rep = ns(("rounds", "samples", "deliveries", "dropped", "t_end", "clock",
              "nevents", "sent", "dropped_fault", "stranded", "samples_dead",
              "shard_counts"), prefix_rep)
    return st, aux, rep


def _port_run(r):
    tens = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in r.items()}
    st, aux, rep = _as_run(tens)
    st.i = r["i"]
    return st, aux, rep


@pytest.mark.parametrize("k,name", [(k, n) for k in CASES for n in CASES[k]])
def test_mesh_matches_jax(runs, k, name):
    """The mesh engine on K ranks against JAX's on K forced devices, on
    JAX's draws: integers, the report (per-shard rows too) and the float32
    times bitwise, w within 8 ulps; every rank holds the same result."""
    z, ranks = runs[k, name]
    jout = _as_run(z, "aux_", "rep_")
    assert_same_run(jout, _port_run(ranks[0]), z["w0"], z["samples"],
                    W_ULPS)
    for other in ranks[1:]:
        for f in ("w", "c", "gmu", "q2", "clock", "nevents"):
            np.testing.assert_array_equal(other[f], ranks[0][f], err_msg=f)
        assert other["shard_counts"] == ranks[0]["shard_counts"]
    rep = jout[2]
    assert int(rep.deliveries) > 0                 # the run cascaded
    if CASES[k][name]["faults"]:
        rows = np.asarray(rep.shard_counts, np.int64)
        # per shard: sent == delivered + overflow + fault + stranded
        assert (rows[:, 0] == rows[:, 1] + rows[:, 2] + rows[:, 3]
                + rows[:, 4]).all()
        assert int(rep.dropped_fault) > 0 and int(rep.samples_dead) > 0


def test_mesh_stats_count_the_lockstep(runs):
    """The runner's instrumentation: one host gather an exchange, a device
    gather of the boundary rows only when an outbox is not empty."""
    _, ranks = runs[2, "constant-exact"]
    s = ranks[0]["stats"]
    assert s["drain_iterations"] > 0 and 0 < s["weight_gathers"]
    assert s["collectives"] >= s["drain_iterations"] + 2 * 128
    assert s["host_reads"] > 0


# ------------------------------------------------- in-process contracts


def _setup(side=6, n_events=64):
    cfg = torch_cfg(side=side, dim=3, e_factor=1.0, i_max=256)
    state = tafm.init(GeneratorDraws(2, "cpu"), cfg)
    samples = torch.from_numpy(np.random.default_rng(2).random(
        (n_events, 3), dtype=np.float32))
    return cfg, state, samples


@pytest.mark.parametrize("latency", ["zero", "constant", "exponential"])
def test_one_shard_mesh_is_the_single_pool(latency):
    """``shards=1`` runs the single-pool runner: bitwise the same run."""
    cfg, state, samples = _setup()
    ecfg = tev.EventConfig(latency=latency,
                           delay=0.0 if latency == "zero" else 1.0)
    outs = [tev.run_events(state, samples, GeneratorDraws(3, "cpu"), cfg,
                           ecfg, lat_draws=GeneratorDraws(4, "cpu"),
                           placement=pl, shards=sh)
            for pl, sh in (("single", None), ("mesh", 1),
                           (MeshPlacement(1), None))]
    for other in outs[1:]:
        for a, b in zip(outs[0][:2], other[:2]):
            for x, y in zip(a, b):
                if isinstance(x, torch.Tensor):
                    assert torch.equal(x, y)
        assert outs[0][2].rounds == other[2].rounds
        assert torch.equal(outs[0][2].clock, other[2].clock)


def test_resolve_placement_mesh():
    assert resolve_placement("mesh", shards=3) == MeshPlacement(3)
    assert resolve_placement("mesh") == MeshPlacement(1)
    assert resolve_placement(MeshPlacement(2), shards=2).shards == 2
    with pytest.raises(ValueError, match="shards=2 was also requested"):
        resolve_placement(MeshPlacement(3), shards=2)
    with pytest.raises(ValueError, match="shards must be >= 1"):
        MeshPlacement(0)


def _jax_error(side, shards, **ekw):
    cfg = jafm.AFMConfig(side=side, dim=3)
    plan = ekw.pop("faults", None)
    ecfg = jev.EventConfig(**ekw, faults=JFaultPlan(**plan) if plan else None)
    with pytest.raises(ValueError) as err:
        JMeshPlacement(shards).build_runner(cfg, ecfg, 8, jafm.search_exact,
                                            None, None)
    return str(err.value)


@pytest.mark.parametrize("side,shards,ekw", [
    (5, 2, {}),
    (6, 2, {"max_rounds": 10, "latency": "constant", "delay": 1.0}),
    (6, 2, {"kernel": "fused"}),
    (6, 2, {"latency": "constant", "delay": 1.0,
            "faults": {"shard_latency_mult": (1.0, 2.0, 3.0)}}),
])
def test_mesh_validation_matches_jax(side, shards, ekw):
    """The runner's refusals, with JAX's messages (the fused kernel's
    wording names the port's kernel)."""
    want = _jax_error(side, shards, **dict(ekw))
    plan = ekw.pop("faults", None)
    ecfg = tev.EventConfig(**ekw, faults=FaultPlan(**plan) if plan else None)
    with pytest.raises(ValueError) as err:
        MeshPlacement(shards).build_runner(torch_cfg(side=side, dim=3), ecfg,
                                           8, tafm.search_exact, None, None)
    if "fused" in want:
        assert "single-pool only" in str(err.value)
        assert "use shards=1" in str(err.value)
    else:
        assert str(err.value) == want


def test_mesh_needs_its_ranks():
    """Without a process group of K ranks a mesh run says what it needs."""
    cfg, state, samples = _setup()
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tev.run_events(state, samples, GeneratorDraws(0, "cpu"), cfg,
                       placement="mesh", shards=2)


def test_async_backend_mesh_options():
    from repro_torch.api import get_backend
    cfg = torch_cfg(side=6, dim=3, i_max=16)
    be = get_backend("async", cfg, placement="mesh", shards=2, device="cpu")
    assert be.placement == MeshPlacement(2)
    with pytest.raises(ValueError, match="contiguous row bands"):
        get_backend("async", torch_cfg(side=5, dim=3), placement="mesh",
                    shards=2, device="cpu")
    with pytest.raises(ValueError, match="single-pool only"):
        get_backend("async", cfg, placement="mesh", shards=2,
                    max_rounds=10, latency="constant", delay=1.0,
                    device="cpu")


def test_async_backend_trains_on_the_mesh():
    """``TopoMap(backend="async", placement="mesh")`` on 2 ranks: one seed
    replays bitwise, QE lands in the single pool's band, and a plan with
    ``shard_latency_mult`` (refused by the single pool) runs with every
    shard's messages accounted for."""
    from repro_torch.api import TopoMap
    faults = dict(seed=4, p_loss=0.1, shard_latency_mult=(1.0, 3.0))
    ranks = run_ranks(torch_ranks.async_mesh_fit, 2, RANK_TIMEOUT, faults)
    first, again, faulty = ranks[0]
    np.testing.assert_array_equal(first["w"], again["w"])
    np.testing.assert_array_equal(first["w"], ranks[1][0]["w"])
    x = np.random.default_rng(5).random((256, 3), dtype=np.float32)
    single = TopoMap(tafm.AFMConfig(side=6, dim=3, i_max=192, e_factor=1.0,
                                    theta=2),
                     backend="async", device="cpu", seed=3,
                     backend_options={"search": "exact"}).fit(x)
    qe_single = single.quantization_error(x)
    assert np.isfinite(first["qe"]) and first["qe"] < 1.3 * qe_single
    rows = np.asarray(faulty["rows"])
    assert (rows[:, 0] == rows[:, 1:].sum(axis=1)).all()
    assert faulty["dropped_fault"] > 0
    assert rows[:, 0].sum() == faulty["sent"]
    with pytest.raises(ValueError, match="placement='mesh'"):
        TopoMap(side=6, dim=3, i_max=16, backend="async", device="cpu",
                backend_options={"faults": faults}).fit(x)
