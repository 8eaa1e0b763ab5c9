"""Fault injection in the port's event engine (``repro_torch.faults``,
``repro_torch.core.events``), against the JAX package on the CPU.

The cases of ``tests/test_faults.py`` carried over to the port (plan
semantics, the dead-unit law, the fault-free contract, the loss, dropout and
pool-pressure laws, stragglers, the fast path), then parity with JAX's
``run_events`` for each fault axis at constant and exponential latency with
both searches: the port replays JAX's draws (``torch_parity.event_draws``),
JAX's delays (``recorded_exponentials``), JAX's loss uniforms
(``torch_parity.fault_draws``: ``split`` then ``uniform((4N,))`` from
``PRNGKey(plan.seed)``) and JAX's dead set (the ``dead=`` seam of
``run_events``: the packages draw their sets with other samplers).
Tolerances as ``tests/test_torch_events.py``: integers, the report and the
fault counts bitwise; weights within ``W_ULPS`` ulps of the largest weight.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.core import afm as jafm
from repro.core import events as jev
from repro.faults import FaultPlan as JFaultPlan
from repro_torch.convert import state_from_numpy
from repro_torch.core import afm as tafm
from repro_torch.core import events as tev
from repro_torch.draws import GeneratorDraws
from repro_torch.faults import FaultPlan, resolve_plan
from repro_torch.training.async_trainer import AsyncBackend
from torch_parity import (assert_same_run, event_draws, fault_draws, jax_cfg,
                          recorded_exponentials, replay, t, torch_cfg)

CAP = tev.WAVE_CAP
W_ULPS = 8
N_EVENTS = 48


def _p_one(i, cfg):
    del i, cfg
    return 1.0


def _setup(side=4, n_events=N_EVENTS, seed=2):
    """``test_faults.py``'s run on the port: a 4x4 map of 3-d units from
    its own draws, ``n_events`` uniform samples from numpy."""
    cfg = torch_cfg(side=side, dim=3, e_factor=1.0, i_max=n_events)
    state = tafm.init(GeneratorDraws(seed, "cpu"), cfg)
    samples = torch.from_numpy(np.random.default_rng(seed).random(
        (n_events, 3), dtype=np.float32))
    return cfg, state, samples


def _run(faults=None, latency="constant", delay=0.5, max_rounds=None,
         **setup):
    cfg, state, samples = _setup(**setup)
    ecfg = tev.EventConfig(latency=latency, delay=delay, engine="event",
                           max_rounds=max_rounds, faults=faults)
    out, _, rep = tev.run_events(state, samples, GeneratorDraws(3, "cpu"),
                                 cfg, ecfg, p_fn=_p_one,
                                 lat_draws=GeneratorDraws(5, "cpu"))
    return out, rep


def _identity(rep) -> int:
    return rep.sent - (rep.deliveries + rep.dropped_overflow
                       + rep.dropped_fault + rep.stranded)


# ------------------------------------------------------------ plan semantics


def test_plan_validation():
    with pytest.raises(ValueError, match="p_loss"):
        FaultPlan(p_loss=1.5)
    with pytest.raises(ValueError, match="dropout_frac"):
        FaultPlan(dropout_frac=-0.1)
    with pytest.raises(ValueError, match="shard_latency_mult"):
        FaultPlan(shard_latency_mult=(1.0, 0.0))
    with pytest.raises(ValueError, match="pool_reserve"):
        FaultPlan(pool_reserve=-1)
    with pytest.raises(ValueError, match="faults must be"):
        resolve_plan("p_loss=0.1")


def test_plan_hashable_and_resolvable():
    a = resolve_plan({"seed": 3, "p_loss": 0.1})
    assert a == FaultPlan(seed=3, p_loss=0.1)
    assert hash(a) == hash(FaultPlan(seed=3, p_loss=0.1))
    assert resolve_plan(None) is None
    assert resolve_plan(a) is a


def test_seed_only_plan_is_inactive():
    assert FaultPlan.none() == FaultPlan() and FaultPlan.none().is_none()
    assert FaultPlan(seed=99).is_none()
    assert not FaultPlan(p_loss=0.01).is_none()
    assert not tev.EventConfig(faults=FaultPlan(seed=99)).fault_active
    assert tev.EventConfig().plan == FaultPlan.none()


def test_eventconfig_rejects_dict_spec_and_fused_kernel():
    with pytest.raises(ValueError, match="resolved by the backend"):
        tev.EventConfig(faults={"p_loss": 0.1})
    with pytest.raises(ValueError, match="FaultPlan disqualifies"):
        tev.EventConfig(kernel="fused", faults=FaultPlan(p_loss=0.1))


def test_backend_resolves_dict_spec():
    cfg = torch_cfg(side=4, dim=3, i_max=16)
    be = AsyncBackend(cfg, faults={"seed": 3, "p_loss": 0.25}, device="cpu")
    assert be.ecfg.plan == FaultPlan(seed=3, p_loss=0.25)
    assert be.ecfg.fault_active


def test_dead_units_selection_is_seeded_and_sized():
    plan = FaultPlan(seed=13, dropout_frac=0.25, dropout_len=10.0)
    m1, m2 = plan.dead_units(16), plan.dead_units(16)
    assert m1.dtype == torch.bool and m1.device.type == "cpu"
    assert torch.equal(m1, m2) and int(m1.sum()) == 4
    # the head of a seeded CPU randperm, whatever device the run is on
    head = torch.randperm(16, generator=torch.Generator().manual_seed(13))
    assert torch.equal(torch.nonzero(m1)[:, 0], torch.sort(head[:4]).values)
    other = FaultPlan(seed=14, dropout_frac=0.25, dropout_len=10.0)
    assert int(other.dead_units(16).sum()) == 4
    # round(frac * n), as JAX's law; none without a window
    assert int(FaultPlan(dropout_frac=0.3, dropout_len=1).dead_units(
        10).sum()) == int(np.asarray(JFaultPlan(
            dropout_frac=0.3, dropout_len=1).dead_units(10)).sum()) == 3
    assert not FaultPlan(dropout_frac=0.5).dead_units(16).any()


# ----------------------------------------------- the fault-free contract


@pytest.mark.parametrize("latency", ["constant", "exponential"])
def test_none_plan_builds_identical_graph(latency):
    """``faults=None``, ``FaultPlan.none()`` and a seed-only plan run the
    same engine: the whole result bitwise, the same draws consumed, and the
    sent counter live (conservation holds fault-free too)."""
    base, rep0 = _run(faults=None, latency=latency)
    for plan in (FaultPlan.none(), FaultPlan(seed=77)):
        out, rep = _run(faults=plan, latency=latency)
        assert torch.equal(base.w, out.w) and torch.equal(base.c, out.c)
        for f in rep0._fields:
            a, b = getattr(rep0, f), getattr(rep, f)
            assert torch.equal(a, b) if torch.is_tensor(a) else a == b, f
    assert rep0.sent > 0 and _identity(rep0) == 0
    assert rep0.dropped_fault == 0 and rep0.samples_dead == 0


# -------------------------------------------------------- injected-fault law


def test_loss_counted_and_replayed_bitwise():
    plan = FaultPlan(seed=21, p_loss=0.3)
    a_out, a_rep = _run(faults=plan)
    b_out, b_rep = _run(faults=plan)
    assert torch.equal(a_out.w, b_out.w)
    assert a_rep.dropped_fault == b_rep.dropped_fault > 0
    assert _identity(a_rep) == 0
    assert a_rep.shard_counts[0][3] == a_rep.dropped_fault
    # the faulty trajectory genuinely differs from the fault-free one
    free, _ = _run(faults=None)
    assert not torch.equal(a_out.w, free.w)


def test_dropout_freezes_dead_units():
    """Dead units neither adapt nor fire for the whole window; messages to
    them are consumed as dropped_fault; they hold their initial weights."""
    plan = FaultPlan(seed=5, dropout_frac=0.5, dropout_start=0.0,
                     dropout_len=1e9)           # dead for the entire run
    cfg, state, samples = _setup(seed=3)        # GMUs dead and alive
    ecfg = tev.EventConfig(latency="constant", delay=0.5, engine="event",
                           faults=plan)
    out, _, rep = tev.run_events(state, samples, GeneratorDraws(3, "cpu"),
                                 cfg, ecfg, p_fn=_p_one)
    dead = plan.dead_units(cfg.n_units)
    assert torch.equal(out.w[dead], state.w[dead])
    assert not torch.equal(out.w[~dead], state.w[~dead])
    assert not rep.nevents[dead].any() and not rep.clock[dead].any()
    assert rep.samples_dead > 0 and rep.dropped_fault > 0
    assert _identity(rep) == 0


def test_pool_reserve_forces_overflow_not_fault_drops():
    plan = FaultPlan(seed=5, pool_reserve=8 * 16 - 6)   # 6 slots on a 4x4
    _, rep = _run(faults=plan)
    assert rep.dropped_overflow > 0
    assert rep.dropped_fault == 0
    assert _identity(rep) == 0


def test_straggler_mult_requires_mesh():
    with pytest.raises(ValueError, match="mesh"):
        _run(faults=FaultPlan(shard_latency_mult=(1.0, 4.0)))


def test_zero_latency_faults_leave_fast_path():
    """An active plan disqualifies the fast path (the engine simulates the
    faults) and still satisfies conservation."""
    cfg, _, _ = _setup()
    assert not tev._zero_fast_ok(cfg, tev.EventConfig(
        faults=FaultPlan(seed=3, p_loss=0.5)), N_EVENTS)
    _, rep = _run(faults=FaultPlan(seed=3, p_loss=0.5), latency="zero",
                  delay=0.0)
    assert rep.rounds > N_EVENTS             # the engine's delivery rounds
    assert rep.dropped_fault > 0
    assert _identity(rep) == 0


@pytest.mark.parametrize("runner", ["engine", "budget"])
def test_conservation_holds_on_every_runner(runner):
    """Loss, dropout and pool pressure at once, on the sample-scan engine
    and on the budgeted loop cutting the run short (stranded messages)."""
    plan = FaultPlan(seed=8, p_loss=0.2, dropout_frac=0.25,
                     dropout_start=4.0, dropout_len=20.0,
                     pool_reserve=8 * 16 - 4)
    _, rep = _run(faults=plan, latency="exponential", delay=2.0,
                  max_rounds=40 if runner == "budget" else None)
    assert rep.dropped_fault > 0 and _identity(rep) == 0
    if runner == "budget":
        assert rep.stranded > 0 and rep.samples < N_EVENTS
    else:
        assert rep.dropped_overflow > 0


def test_fault_stream_restarts_every_run():
    """The plan's draws restart with every run (JAX restarts
    ``PRNGKey(plan.seed)``): two runs of one backend from one state and
    one training seed are bitwise equal."""
    cfg, state, samples = _setup()
    ecfg = tev.EventConfig(latency="constant", delay=0.5,
                           faults=FaultPlan(seed=4, p_loss=0.4))
    (a, _, ra), (b, _, rb) = (
        tev.run_events(state, samples, GeneratorDraws(6, "cpu"), cfg, ecfg,
                       p_fn=_p_one) for _ in range(2))
    assert torch.equal(a.w, b.w) and ra.dropped_fault == rb.dropped_fault > 0


def test_topomap_trains_under_faults():
    """``TopoMap(backend="async", backend_options={"faults": {...}})``
    trains under loss and dropout with every message accounted for."""
    from repro_torch.api import TopoMap
    x = np.random.default_rng(1).standard_normal((256, 12)).astype(
        np.float32)
    tm = TopoMap(side=6, dim=12, theta=2, i_max=128, e_factor=0.5,
                 backend="async",
                 device="cpu", backend_options={
                     "latency": "constant", "delay": 1.0, "faults": {
                         "seed": 2, "p_loss": 0.2, "dropout_frac": 0.25,
                         "dropout_start": 10, "dropout_len": 60}}).fit(x)
    rep = tm.backend.last_report
    assert rep.dropped_fault > 0 and rep.samples_dead > 0
    assert _identity(rep) == 0 and np.isfinite(tm.quantization_error(x))


# ---------------------------------------------------- parity with JAX


AXES = {
    "loss": dict(seed=21, p_loss=0.3),
    "dropout": dict(seed=5, dropout_frac=0.5, dropout_start=6.0,
                    dropout_len=1e9),
    "both": dict(seed=3, p_loss=0.2, dropout_frac=0.5, dropout_start=2.0,
                 dropout_len=30.0),
    "pool": dict(seed=5, pool_reserve=8 * 16 - 4),     # 4 slots
}


def _jax_setup():
    """``test_faults.py``'s ``_setup`` (JAX's state, samples, keys)."""
    cfg = jax_cfg(side=4, dim=3, e_factor=1.0, i_max=N_EVENTS)
    k_init, k_data, k_steps = jax.random.split(jax.random.PRNGKey(2), 3)
    state = jafm.init(k_init, cfg)
    samples = jax.random.uniform(k_data, (N_EVENTS, cfg.dim))
    return cfg, state, samples, jax.random.split(k_steps, N_EVENTS)


@pytest.mark.parametrize("search", ["exact", "heuristic"])
@pytest.mark.parametrize("latency", ["constant", "exponential"])
@pytest.mark.parametrize("axis", sorted(AXES))
def test_faulty_run_matches_jax(axis, latency, search):
    jcfg, state, samples, step_keys = _jax_setup()
    jplan, plan = JFaultPlan(**AXES[axis]), FaultPlan(**AXES[axis])
    jsearch, tsearch = ((jafm.search_exact, tev.search_exact)
                        if search == "exact" else
                        (jafm.search_heuristic, tafm.search_heuristic))
    ekw = dict(latency=latency, delay=0.5 if latency == "constant" else 1.0,
               engine="event")

    def jrun():
        return jev.run_events(state, samples, step_keys, jcfg,
                              jev.EventConfig(faults=jplan, **ekw),
                              search=jsearch,
                              p_fn=lambda i, c: jnp.float32(1.0),
                              lat_key=jax.random.PRNGKey(5))

    lat = None
    if latency == "exponential":
        with recorded_exponentials() as rec:
            jout = jrun()
            jax.block_until_ready(jout[0].w)
        lat = replay(rec)
    else:
        jout = jrun()
    draws = replay(event_draws(step_keys, jcfg, jout[1].waves,
                               heuristic=search == "heuristic",
                               wave_cap=CAP))
    tout = tev.run_events(
        state_from_numpy(state, "cpu"), t(samples), draws,
        torch_cfg(side=4, dim=3, e_factor=1.0, i_max=N_EVENTS),
        tev.EventConfig(faults=plan, **ekw), search=tsearch, p_fn=_p_one,
        lat_draws=lat,
        fault_draws=fault_draws(plan.seed, 16, int(jout[2].rounds)),
        dead=t(jplan.dead_units(16)))
    assert len(draws) == 0                       # every event ran
    assert_same_run(jout, tout, np.asarray(state.w), np.asarray(samples),
                    W_ULPS)
    rep = tout[2]
    assert _identity(rep) == 0
    if axis in ("loss", "both"):
        assert rep.dropped_fault > 0
    if axis in ("dropout", "both"):
        assert rep.samples_dead > 0
    if axis == "pool":
        assert rep.dropped_overflow > 0 and rep.dropped_fault == 0
