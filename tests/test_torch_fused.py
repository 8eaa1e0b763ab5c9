"""The port's fused training step against the JAX package's, on the CPU.

On CPU tensors ``kernels.fused.ops.fused_step`` runs its plain version; the
JAX side runs the real Pallas kernel body of ``fused_step_pallas`` in
interpret mode. Both get the same numpy inputs, or the draws of the same
JAX key chain (``ReplayDraws``). Tiers, as in the other port tests:

- counters, the fired front, [size, waves], receive counts: bitwise;
- GMUs and q2: ``assert_bmu_tier`` (exact search), the bf16 tier contract
  of ``tests/test_kernels_properties.py`` (index agreement >= 0.95, q2
  within 8 ULP where the indices agree) for the bf16 search. Where a search
  picks another unit inside its bound, the rest of the step is held on the
  JAX GMUs through the GMU-given form, so its integers stay bitwise;
- w: within 8 (1 + waves) f32 ULP of max|w| per step (XLA contracts the
  merge and wave updates into FMAs, eager PyTorch does not).

The CUDA kernel runs only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.api.backends import get_backend as jget_backend
from repro.core import afm as jafm
from repro.kernels.fused import ops as jfused_ops
from repro.kernels.fused import ref as jfused_ref
from repro.kernels.fused.fused import fused_step_pallas
from repro_torch.api import TopoMap
from repro_torch.api.backends import get_backend
from repro_torch.convert import state_from_numpy
from repro_torch.core import afm as tafm
from repro_torch.core import search as tsearch
from repro_torch.kernels.cascade import ref as cas_ref
from repro_torch.kernels.fused import ops as fused_ops
from torch_parity import (F32_EPS, assert_bmu_tier, cascade_draws,
                          fused_step_draws, jax_cfg, replay, t,
                          torch_cfg)

#: (side, d, b, theta, max_waves) of ``test_kernels_properties.py``'s fused
#: interpret tests; a 4-wave block, so the budget binds
SHAPES = [(5, 8, 1, 2, None), (6, 12, 4, 3, 40), (4, 5, 3, 2, 3)]
WAVE_CAP = 4
#: the bf16 tier contract (``tests/test_kernels_properties.py``)
BF16_MIN_AGREEMENT = 0.95
BF16_Q2_ULP_BOUND = 8


def _hot_cfg(side, d, b, theta, max_waves=None, **kw):
    """Cascades must fire for the wave loop to run (as the JAX tests)."""
    return dict(side=side, dim=d, batch=b, i_max=50 * side * side,
                theta=theta, c_m=0.3, c_d=50.0, max_waves=max_waves, **kw)


def _assert_w_close(w, w_ref, waves):
    w, w_ref = np.asarray(w), np.asarray(w_ref)
    assert np.isfinite(w).all() and np.isfinite(w_ref).all()
    bound = 8 * (1 + waves) * F32_EPS * np.abs(w_ref).max()
    assert np.abs(w - w_ref).max() <= bound, np.abs(w - w_ref).max()


def _assert_bf16_tier(idx, q2, idx_ref, q2_ref):
    idx, idx_ref = np.asarray(idx), np.asarray(idx_ref)
    agree = idx == idx_ref
    assert agree.mean() >= BF16_MIN_AGREEMENT, agree.mean()
    a = np.asarray(q2, np.float32)[agree].view(np.int32).astype(np.int64)
    r = np.asarray(q2_ref, np.float32)[agree].view(np.int32).astype(np.int64)
    assert np.abs(a - r).max(initial=0) <= BF16_Q2_ULP_BOUND


def _inputs(side, d, b, theta, seed):
    rng = np.random.default_rng(seed)
    n = side * side
    return dict(
        w=rng.standard_normal((n, d)).astype(np.float32),
        c=np.full((side, side), theta - 1, np.int32),   # a hit unit fires
        s=rng.standard_normal((b, d)).astype(np.float32),
        drive=rng.random((8, side, side)) < 0.9,
        bern=rng.random((WAVE_CAP, 4, side, side)) < 0.8,
        gmu=rng.integers(0, n, b).astype(np.int32),
        l_s=np.float32(0.05), l_c=np.float32(0.3))


def _port(x, gmu, theta, budget, precision):
    return fused_ops.fused_step(
        t(x["w"]), t(x["c"]), t(x["s"]), float(x["l_s"]), float(x["l_c"]),
        t(x["drive"]), t(x["bern"]), None if gmu is None else t(gmu),
        theta=theta, budget=budget, precision=precision)


@pytest.mark.parametrize("mode", ["given", "exact", "bf16"])
@pytest.mark.parametrize("side,d,b,theta,max_waves", SHAPES)
def test_fused_step_matches_jax_kernel(side, d, b, theta, max_waves, mode):
    """``fused_step`` (plain version) against ``fused_step_pallas`` in
    interpret mode, with the GMUs given and with either search tier."""
    x = _inputs(side, d, b, theta, seed=side * 10 + d + b)
    budget = min(WAVE_CAP, 8 * side * side if max_waves is None
                 else max_waves)
    precision = "bf16" if mode == "bf16" else "exact"
    gmu = x["gmu"] if mode == "given" else None
    jout = fused_step_pallas(
        jnp.asarray(x["w"]), jnp.asarray(x["c"]), jnp.asarray(x["s"]),
        jnp.asarray([x["l_s"], x["l_c"]]), jnp.asarray(x["drive"]),
        jnp.asarray(x["bern"]), None if gmu is None else jnp.asarray(gmu),
        theta=theta, budget=budget, precision=precision, interpret=True)
    jout = [np.asarray(a) for a in jout]
    out = _port(x, gmu, theta, budget, precision)
    assert len(out) == len(jout)
    if gmu is None:
        if precision == "exact":
            assert_bmu_tier(out[5], out[6], jout[5], jout[6], x["w"], x["s"])
        else:
            _assert_bf16_tier(out[5].numpy(), out[6].numpy(), jout[5],
                              jout[6])
        if not np.array_equal(out[5].numpy(), jout[5]):
            out = _port(x, jout[5], theta, budget, precision)
    assert out[2].dtype == torch.bool and out[3].dtype == torch.int32
    np.testing.assert_array_equal(out[1].numpy(), jout[1])
    np.testing.assert_array_equal(out[2].numpy().astype(np.int32), jout[2])
    np.testing.assert_array_equal(out[3].numpy(), jout[3])
    np.testing.assert_array_equal(out[4].numpy(), jout[4])
    assert 0 < jout[3][1] <= budget
    _assert_w_close(out[0], jout[0], int(jout[3][1]))


def test_wave_loop_continues_with_seeded_accumulators():
    """``wave_loop`` from a mid-cascade front with size0/waves0/recv0 set,
    against JAX's on the same key chain: the tail's contract."""
    rng = np.random.default_rng(3)
    side, d, theta = 6, 5, 3
    w3 = rng.standard_normal((side, side, d)).astype(np.float32)
    c2 = rng.integers(0, theta, (side, side)).astype(np.int32)
    fired = rng.random((side, side)) < 0.3
    recv0 = rng.integers(0, 4, (side, side)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    kw = dict(l_c=np.float32(0.3), p_i=np.float32(0.8), theta=theta,
              max_waves=40)
    jw, jc, jsize, jwaves, jrecv = jfused_ref.wave_loop(
        jnp.asarray(w3), jnp.asarray(c2), jnp.asarray(fired), key,
        size0=7, waves0=4, recv0=jnp.asarray(recv0), **kw)
    n_tail = int(jwaves) - 4
    draws = []
    for _ in range(n_tail):
        key, sub = jax.random.split(key)
        draws.append(jax.random.uniform(sub, (4, side, side)))
    rd = replay(draws)
    tw, tc, tsize, twaves, trecv = cas_ref.wave_loop(
        t(w3), t(c2), t(fired), rd, size0=7, waves0=4, recv0=t(recv0),
        **{k: float(v) if k in ("l_c", "p_i") else v for k, v in kw.items()})
    assert len(rd) == 0 and n_tail > 0
    assert (int(tsize), int(twaves)) == (int(jsize), int(jwaves))
    assert tsize.dtype == twaves.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(trecv.numpy(), np.asarray(jrecv))
    _assert_w_close(tw, jw, n_tail)


def test_drive_from_draws_matches_jax():
    rng = np.random.default_rng(4)
    c2 = rng.integers(0, 4, (7, 7)).astype(np.int32)
    mask = rng.integers(0, 11, (7, 7)).astype(np.int32)
    draws = rng.random((8, 7, 7)) < 0.5
    np.testing.assert_array_equal(
        cas_ref.drive_from_draws(t(c2), t(mask), t(draws)).numpy(),
        np.asarray(jfused_ref.drive_from_draws(
            jnp.asarray(c2), jnp.asarray(mask), jnp.asarray(draws))))


def test_fused_topomap_matches_jax_pallas_fused_backend():
    """``TopoMap(backend="kernel", backend_options={"kernel": "fused"},
    device="cpu")`` against JAX's ``pallas`` backend with ``kernel="fused"``
    in interpret mode, one step at a time from the JAX state, on JAX's
    draws (the fused draw order, a tail where the cascade outlives 16
    waves). Exact search: the relay-race variant costs another interpret
    compile; ``test_fused_matches_staged_step`` holds it to the staged step,
    which ``test_torch_afm.py`` holds to JAX's."""
    search = "exact"
    kw = _hot_cfg(6, 12, 4, 3)
    jcfg, tcfg = jax_cfg(**kw), torch_cfg(**kw)
    rng = np.random.default_rng(5)
    data = rng.standard_normal((64, jcfg.dim)).astype(np.float32)
    jback = jget_backend("pallas", jcfg, search=search, kernel="fused",
                         use_pallas=True, interpret=True)
    jstate = jafm.init(jax.random.PRNGKey(2), jcfg, jnp.asarray(data))
    jstate = jstate._replace(c=jnp.full((jcfg.n_units,), jcfg.theta - 1,
                                        jnp.int32), i=jnp.int32(40))
    total_waves = 0
    for step in range(3):
        key = jax.random.PRNGKey(100 + step)
        samples = data[step * 4:step * 4 + 4]
        jnew, jaux = jback.step(jstate, jnp.asarray(samples), key)
        waves = int(jaux.waves)
        draws = replay(fused_step_draws(
            key, jcfg, 4, heuristic=False,
            wave_cap=fused_ops.DEFAULT_WAVE_CAP, waves=waves))
        tm = TopoMap.from_state(state_from_numpy(jstate, device="cpu"), tcfg,
                                backend="kernel", device="cpu",
                                backend_options={"kernel": "fused",
                                                 "search": search})
        tm.partial_fit(samples, draws=draws)
        assert len(draws) == 0
        tnew, taux = tm.state_, tm.fit_aux_
        assert_bmu_tier(taux.gmu, taux.q2, jaux.gmu, jaux.q2,
                        np.asarray(jstate.w), samples)
        if not np.array_equal(taux.gmu.numpy(), np.asarray(jaux.gmu)):
            zeros = torch.zeros(4, dtype=torch.int32)
            res = tsearch.SearchResult(t(jaux.gmu), t(jaux.q2), zeros, zeros)
            l_c, p_i = tafm.schedule_values(int(jstate.i), tcfg)
            parts = fused_ops.fused_step_parts(
                t(jstate.w), t(jstate.c), t(samples), replay(
                    fused_step_draws(key, jcfg, 4, heuristic=False,
                                     wave_cap=fused_ops.DEFAULT_WAVE_CAP,
                                     waves=waves)),
                tcfg, l_c=l_c, p_i=p_i, search_result=res)
            tnew = tnew._replace(w=parts.w, c=parts.c)
            taux = taux._replace(cascade_size=parts.size, waves=parts.waves)
        for field in ("cascade_size", "waves", "greedy_steps"):
            np.testing.assert_array_equal(getattr(taux, field).numpy(),
                                          np.asarray(getattr(jaux, field)))
        np.testing.assert_array_equal(tnew.c.numpy(), np.asarray(jnew.c))
        assert tnew.i == int(jnew.i)
        _assert_w_close(tnew.w, jnew.w, 1 + waves)
        total_waves += waves
        jstate = jnew
    assert total_waves > 0


@pytest.mark.parametrize("search", ["exact", "heuristic"])
@pytest.mark.parametrize("wave_cap,max_waves", [(4, None), (16, 3)])
def test_fused_matches_staged_step(search, wave_cap, max_waves):
    """Port fused step against port staged step on the CPU, from one state,
    on JAX's draws: the staged step takes the first ``DEFAULT_WAVE_CAP``
    waves stacked and the rest in its tail, the fused step the first
    ``wave_cap`` stacked and the rest in its tail; with a tail (``wave_cap``
    4) and with ``max_waves`` 3 < ``wave_cap``. Integers bitwise, w within
    the step bound."""
    kw = _hot_cfg(6, 12, 4, 3, max_waves=max_waves)
    jcfg, tcfg = jax_cfg(**kw), torch_cfg(**kw)
    rng = np.random.default_rng(6)
    data = rng.standard_normal((40, tcfg.dim)).astype(np.float32)
    staged = get_backend("kernel", tcfg, search=search, device="cpu").stages
    fused = staged._replace(fused=fused_ops.make_fused_stage(
        search=search, wave_cap=wave_cap))
    state = state_from_numpy(jafm.init(jax.random.PRNGKey(3), jcfg,
                                       jnp.asarray(data)), device="cpu")
    state = state._replace(c=torch.full((tcfg.n_units,), tcfg.theta - 1,
                                        dtype=torch.int32), i=60)
    saw_tail = False
    for step in range(3):
        key = jax.random.PRNGKey(200 + step)
        samples = t(data[step * 4:step * 4 + 4])
        sd = replay(fused_step_draws(key, jcfg, 4,
                                     heuristic=search == "heuristic",
                                     wave_cap=fused_ops.DEFAULT_WAVE_CAP,
                                     waves=8 * tcfg.n_units))
        snew, saux = tafm._step(state, samples, sd, tcfg, staged)
        waves = int(saux.waves)
        fd = replay(fused_step_draws(key, jcfg, 4,
                                     heuristic=search == "heuristic",
                                     wave_cap=wave_cap, waves=waves))
        fnew, faux = tafm._step(state, samples, fd, tcfg, fused)
        assert len(fd) == 0
        for field in ("gmu", "cascade_size", "waves", "greedy_steps"):
            np.testing.assert_array_equal(getattr(faux, field).numpy(),
                                          getattr(saux, field).numpy())
        np.testing.assert_array_equal(faux.q2.numpy(), saux.q2.numpy())
        np.testing.assert_array_equal(fnew.c.numpy(), snew.c.numpy())
        _assert_w_close(fnew.w, snew.w, 1 + waves)
        if max_waves is not None:
            assert waves <= max_waves
        saw_tail |= waves > wave_cap
        state = snew
    assert saw_tail or max_waves is not None


def test_fused_step_parts_adds_recv0():
    """``recv0`` seeds the receive counts (the async runner's sidecar)."""
    cfg = torch_cfg(**_hot_cfg(5, 6, 2, 2, max_waves=16))
    rng = np.random.default_rng(7)
    w = t(rng.standard_normal((cfg.n_units, cfg.dim)).astype(np.float32))
    c = torch.ones(cfg.n_units, dtype=torch.int32)
    s = t(rng.standard_normal((2, cfg.dim)).astype(np.float32))
    draws = cascade_draws(jax.random.PRNGKey(9), cfg.side, 16)
    block = [draws[0], np.stack([np.asarray(x) for x in draws[1:]])]
    recv0 = torch.arange(cfg.n_units, dtype=torch.int32)
    a = fused_ops.fused_step_parts(w, c, s, replay(block), cfg, l_c=0.3,
                                   p_i=0.9)
    b = fused_ops.fused_step_parts(w, c, s, replay(block), cfg, l_c=0.3,
                                   p_i=0.9, recv0=recv0)
    assert int(a.waves) > 0
    assert torch.equal(b.recv, a.recv + recv0)
    assert torch.equal(a.w, b.w) and torch.equal(a.c, b.c)


def test_fused_step_rejects_bad_inputs():
    x = _inputs(4, 3, 2, 2, seed=1)
    args = [t(x["w"]), t(x["c"]), t(x["s"]), 0.05, 0.3, t(x["drive"]),
            t(x["bern"])]
    kw = dict(theta=2, budget=WAVE_CAP)
    with pytest.raises(ValueError, match="precision"):
        fused_ops.fused_step(*args, precision="fp8", **kw)
    with pytest.raises(ValueError, match="budget"):
        fused_ops.fused_step(*args, theta=2, budget=WAVE_CAP + 1)
    with pytest.raises(ValueError, match=r"gmu must lie in \[0, 16\)"):
        fused_ops.fused_step(*args, torch.tensor([0, 16], dtype=torch.int32),
                             **kw)
    bad = list(args)
    bad[0] = bad[0][:-1]
    with pytest.raises(ValueError, match="side"):
        fused_ops.fused_step(*bad, **kw)
    bad = list(args)
    bad[6] = bad[6].to(torch.int32)
    with pytest.raises(ValueError, match="bool"):
        fused_ops.fused_step(*bad, **kw)
    with pytest.raises(ValueError, match="search"):
        fused_ops.make_fused_stage(search="psychic")
    with pytest.raises(ValueError, match="wave_cap"):
        fused_ops.fused_step_parts(args[0], args[1].reshape(-1), args[2],
                                   replay([]), torch_cfg(side=4, dim=3),
                                   l_c=0.3, p_i=0.5, wave_cap=0)
    assert fused_ops.wave_budget(torch_cfg(side=4)) == 128
    assert jfused_ops.wave_budget(jax_cfg(side=4)) == 128
