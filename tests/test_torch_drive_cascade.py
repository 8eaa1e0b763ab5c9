"""The staged step's drive and cascade (``kernels.cascade.ops.drive_cascade``
and its stage) against the JAX package's, on the CPU.

On CPU tensors ``drive_cascade`` runs its plain version,
``ref.drive_cascade_ref``; the JAX side runs ``core.cascade.
drive_and_cascade`` with the Pallas wave kernel (interpret mode) as its
``wave_fn``, on a key chain whose draws the port gets replayed in its own
order: the drive, the first ``wave_cap`` waves' draws stacked into one
block, then one a tail wave (``torch_parity.fused_step_draws``'s order).
Tiers: counters, [size, waves] bitwise; w within 4 (1 + waves) f32 ULP of
max|w| (XLA contracts the wave update into an FMA, eager PyTorch does not).

The CUDA kernel runs only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``); here its launch plan (pure Python) is held to what the
kernel needs, and its wrapper to its dispatch and validation.
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.core import cascade as jcascade
from repro.kernels.cascade.cascade import cascade_wave_pallas
from repro_torch.api.backends import get_backend
from repro_torch.core import afm as tafm
from repro_torch.draws import GeneratorDraws
from repro_torch.kernels.cascade import ops as cas_ops
from repro_torch.kernels.cascade import ref as cas_ref
from repro_torch.kernels.fused import ops as fused_ops
from torch_parity import F32_EPS, cascade_draws, replay, t, torch_cfg

#: an H100's SMs and opt-in shared memory a block (232,448 bytes = 227 KB)
H100_SMS, H100_SMEM = 132, 232448
CASCADE_CU = Path(cas_ops.__file__).resolve().parent / "cascade.cu"
THETA, P, L_C, D = 3, 0.8, 0.3, 6

#: case -> (wave_cap, max_waves): a whole cascade inside a 16-wave block,
#: a budget cut by max_waves 2 < wave_cap, a 2-wave block with a tail past
#: it, and a drive that fires nothing
CASES = {"block": (16, None), "cut": (16, 2), "tail": (2, None),
         "quiet": (16, None)}


def _assert_w_close(w, w_ref, adaptations):
    bound = 4 * F32_EPS * (1 + adaptations) * np.abs(w_ref).max()
    assert np.abs(np.asarray(w) - np.asarray(w_ref)).max() <= bound


def _inputs(side, case, seed):
    """Merged weights, counters and adaptation counts: counters one or two
    below threshold, so the drive sets off cascades, except in 'quiet',
    where they and the counts are 0 (no unit can reach theta)."""
    rng = np.random.default_rng(seed)
    n = side * side
    w3 = rng.standard_normal((side, side, D)).astype(np.float32)
    if case == "quiet":
        c2 = np.zeros((side, side), np.int32)
        counts = np.zeros((side, side), np.int32)
        counts.flat[rng.integers(0, n)] = 1
    else:
        c2 = rng.integers(THETA - 2, THETA, (side, side)).astype(np.int32)
        counts = rng.integers(0, 4, (side, side)).astype(np.int32)
        counts.flat[0] = 2
    return w3, c2, counts


def _jax_cascade(w3, c2, counts, key, max_waves):
    return jcascade.drive_and_cascade(
        jnp.asarray(w3), jnp.asarray(c2), jnp.asarray(counts),
        l_c=np.float32(L_C), p=np.float32(P), theta=THETA, key=key,
        max_waves=max_waves,
        wave_fn=functools.partial(cascade_wave_pallas, interpret=True))


def _block_draws(key, side, wave_cap, waves):
    """The key chain's draws in the port's order: the drive, the first
    ``wave_cap`` waves' stacked, then one a wave past the block."""
    chain = cascade_draws(key, side, max(waves, wave_cap))
    block = np.stack([np.asarray(x) for x in chain[1:1 + wave_cap]])
    return [chain[0], block] + chain[1 + wave_cap:1 + waves]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("side", [1, 5, 7, 12])
def test_drive_cascade_stage_matches_jax(side, case):
    """The staged step's cascade stage (``drive_cascade`` on its plain
    version, then the tail loop) against JAX's ``drive_and_cascade`` on the
    same key chain; the replay is used up exactly."""
    wave_cap, max_waves = CASES[case]
    w3, c2, counts = _inputs(side, case, seed=side * 10 + len(case))
    key = jax.random.PRNGKey(side * 100 + len(case))
    jw, jc, jsize, jwaves = _jax_cascade(w3, c2, counts, key, max_waves)
    waves = int(jwaves)
    cfg = torch_cfg(side=side, dim=D, theta=THETA, max_waves=max_waves)
    draws = replay(_block_draws(key, side, wave_cap, waves))
    out = cas_ops.drive_cascade_stage(
        t(w3).reshape(side * side, D), t(c2).reshape(-1),
        t(counts).reshape(-1), float(np.float32(L_C)), float(np.float32(P)), draws, cfg,
        wave_cap=wave_cap)
    assert len(draws) == 0
    assert out.size.dtype == out.waves.dtype == torch.int32
    assert (int(out.size), int(out.waves)) == (int(jsize), waves)
    np.testing.assert_array_equal(out.c.numpy(), np.asarray(jc))
    _assert_w_close(out.w, jw, waves)
    if case == "quiet":
        assert waves == 0
        np.testing.assert_array_equal(out.w.numpy(), w3)
    elif side > 1:
        assert waves > 0
    if case == "cut" and side > 1:
        assert waves == max_waves
    if case == "tail" and side > 1:
        assert waves > wave_cap


@pytest.mark.parametrize("side", [1, 5, 7, 12])
def test_drive_cascade_ref_matches_jax_within_the_budget(side):
    """``drive_cascade_ref`` itself, its budget cut by ``max_waves`` 2:
    counters and [size, waves] as JAX's at the cut; the front left alive is
    the units at threshold that received, and with the budget 0 only the
    drive runs."""
    w3, c2, counts = _inputs(side, "cut", seed=side)
    key = jax.random.PRNGKey(side)
    jw, jc, jsize, jwaves = _jax_cascade(w3, c2, counts, key, 2)
    chain = cascade_draws(key, side, 16)
    drive = t(chain[0]) < float(np.float32(P))
    bern = t(np.stack([np.asarray(x) for x in chain[1:]])) < float(
        np.float32(P))
    w = t(w3).reshape(-1, D)
    wo, co, fired, stats, recv = cas_ref.drive_cascade_ref(
        w, t(c2), t(counts), drive, bern, l_c=float(np.float32(L_C)),
        theta=THETA, budget=2)
    assert stats.tolist() == [int(jsize), int(jwaves)]
    np.testing.assert_array_equal(co.numpy(), np.asarray(jc))
    _assert_w_close(wo.reshape(side, side, D), jw, int(jwaves))
    # the front after the last wave: units at threshold that received
    assert not bool((fired & ~((co >= THETA) & (recv > 0))).any())
    assert bool(fired.any()) == (int(jwaves) == 2 and side > 1)
    assert recv.dtype == torch.int32
    w0, c0, fired0, stats0, recv0 = cas_ref.drive_cascade_ref(
        w, t(c2), t(counts), drive, bern, l_c=0.3, theta=THETA, budget=0)
    driven = cas_ref.drive_from_draws(t(c2), t(counts), drive)
    assert torch.equal(c0, driven) and torch.equal(fired0, driven >= THETA)
    assert stats0.tolist() == [0, 0] and not bool(recv0.any())
    assert torch.equal(w0, w)


def _args(side=4, d=3, w_cap=5, seed=0):
    gen = torch.Generator().manual_seed(seed)
    n = side * side
    return [torch.rand(n, d, generator=gen),
            torch.randint(0, 4, (side, side), generator=gen,
                          dtype=torch.int32),
            torch.randint(0, 3, (side, side), generator=gen,
                          dtype=torch.int32),
            torch.rand(8, side, side, generator=gen) < 0.7,
            torch.rand(w_cap, 4, side, side, generator=gen) < 0.7]


def test_drive_cascade_wrapper_validates():
    args = _args()
    kw = dict(l_c=0.3, theta=3, budget=5)
    with pytest.raises(ValueError, match="budget"):
        cas_ops.drive_cascade(*args, l_c=0.3, theta=3, budget=6)
    with pytest.raises(ValueError, match="budget"):
        cas_ops.drive_cascade(*args, l_c=0.3, theta=3, budget=-1)
    for slot, bad in ((0, args[0][:-1]), (2, args[2][:3]), (3, args[3][:7]),
                      (4, args[4][:, :3])):
        wrong = list(args)
        wrong[slot] = bad
        with pytest.raises(ValueError, match="side"):
            cas_ops.drive_cascade(*wrong, **kw)
    for slot, dtype in ((0, torch.float64), (1, torch.int64),
                        (2, torch.float32), (3, torch.int32),
                        (4, torch.uint8)):
        wrong = list(args)
        wrong[slot] = wrong[slot].to(dtype)
        with pytest.raises(ValueError, match="float32 w"):
            cas_ops.drive_cascade(*wrong, **kw)
    with pytest.raises(ValueError, match=r"\(N, D\)"):
        cas_ops.drive_cascade(args[0][0], *args[1:], **kw)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the wrapper takes its
    kernel route here, where no card exists."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_drive_cascade_dispatch(monkeypatch):
    """CPU tensors run the plain version and count no launch; CUDA tensors
    launch the kernel or raise (here: no library), never fall back; mixed
    devices are refused."""
    from repro_torch.kernels import _build
    args = _args(seed=3)
    kw = dict(l_c=0.3, theta=3, budget=5)
    before = cas_ops.drive_launches
    out = cas_ops.drive_cascade(*args, **kw)
    ref = cas_ref.drive_cascade_ref(*args, **kw)
    assert all(torch.equal(a, r) for a, r in zip(out, ref))
    assert cas_ops.drive_launches == before

    def no_library():
        raise RuntimeError("nvcc not found")

    def no_plan(*a):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load", no_library)
    monkeypatch.setattr(cas_ops, "_cascade_plan", no_plan)
    with pytest.raises(RuntimeError, match="nvcc"):
        cas_ops.drive_cascade(*[x.as_subclass(_FakeCuda) for x in args], **kw)
    mixed = list(args)
    mixed[4] = mixed[4].as_subclass(_FakeCuda)
    with pytest.raises(ValueError, match="device"):
        cas_ops.drive_cascade(*mixed, **kw)
    assert cas_ops.drive_launches == before


def _check_plan(n, d, sms, smem):
    """Either the plan's properties hold, or it is refused because one
    block's shared memory cannot fit."""
    ds = -(-d // sms)
    if cas_ops.cascade_shared_bytes(n, ds, 0) > smem:
        with pytest.raises(ValueError, match="shared memory"):
            cas_ops.plan_cascade(n, d, sms, smem)
        return None
    p = cas_ops.plan_cascade(n, d, sms, smem)
    assert (p.n, p.d, p.ds) == (n, d, ds)
    assert p.threads == cas_ops.THREADS
    assert p.smem == cas_ops.cascade_shared_bytes(n, p.ds, p.staged_waves)
    assert p.smem <= smem and p.smem % 16 == 0
    assert 1 <= p.blocks <= sms
    feats = [f for i in range(p.blocks) for f in range(*p.feature_range(i))]
    assert feats == list(range(d))               # each feature once
    assert all(p.feature_range(i)[0] < p.feature_range(i)[1]
               for i in range(p.blocks))         # every block owns one
    assert 0 <= p.staged_waves <= cas_ops.MAX_STAGED_WAVES
    if p.staged_waves < cas_ops.MAX_STAGED_WAVES:    # as many as fit
        assert cas_ops.cascade_shared_bytes(n, p.ds,
                                            p.staged_waves + 1) > smem
    assert list(p.c_array()) == [p.blocks, p.ds, p.threads, p.smem,
                                 p.staged_waves]
    return p


@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("d", [1, 13, 50, 783, 784])
@pytest.mark.parametrize("side", [1, 7, 30])
def test_cascade_plan_fits_and_covers_every_feature(side, d, sms):
    _check_plan(side * side, d, sms, H100_SMEM)


def test_cascade_plan_at_the_main_shape():
    """30x30x784 on an H100: 131 blocks of 6 features, the draws of 8 waves
    staged."""
    p = _check_plan(900, 784, H100_SMS, H100_SMEM)
    assert (p.blocks, p.ds, p.staged_waves) == (131, 6, 8)
    assert p.smem == cas_ops.cascade_shared_bytes(900, 6, 8) < H100_SMEM


def test_cascade_plan_stages_fewer_waves_or_refuses_where_memory_is_short():
    tight = cas_ops.cascade_shared_bytes(900, 6, 3)
    assert _check_plan(900, 784, H100_SMS, tight).staged_waves == 3
    zero = cas_ops.cascade_shared_bytes(900, 6, 0)
    assert _check_plan(900, 784, H100_SMS, zero).staged_waves == 0
    with pytest.raises(ValueError, match="shared memory"):
        cas_ops.plan_cascade(900, 784, H100_SMS, zero - 16)
    with pytest.raises(ValueError, match="16-bit"):
        cas_ops.plan_cascade(256 * 256, 4, H100_SMS, H100_SMEM)
    with pytest.raises(ValueError, match="plan"):
        cas_ops.plan_cascade(0, 784, H100_SMS, H100_SMEM)
    with pytest.raises(ValueError, match="plan"):
        cas_ops.plan_cascade(900, 784, 0, H100_SMEM)


def test_cascade_plan_constants_are_the_kernels():
    """The numbers ``plan_cascade`` assumes are those ``cascade.cu`` is
    built with (the card checks the rest: ``repro_cascade_plan``)."""
    src = CASCADE_CU.read_text()
    assert re.search(r"constexpr int THREADS = (\d+);", src).group(1) == \
        str(cas_ops.THREADS)
    # the layout's regions, in the kernel's order and count
    assert len(re.findall(r"= take\(at, ", src)) == 13


def test_staged_and_fused_stages_consume_one_stream_identically():
    """From one ``GeneratorDraws`` seed, three steps of the kernel backend's
    staged and fused stages on the CPU, each step from the staged state and
    the same generator state: GMUs, sizes, waves and counters bitwise, w
    within the step bound, and the generators in the same state after each
    step (the same numbers consumed)."""
    cfg = torch_cfg(side=6, dim=12, batch=4, i_max=1800, theta=3, c_m=0.3,
                    c_d=50.0)
    rng = np.random.default_rng(8)
    data = t(rng.standard_normal((64, cfg.dim)).astype(np.float32))
    staged = get_backend("kernel", cfg, device="cpu").stages
    fused = get_backend("kernel", cfg, kernel="fused", device="cpu").stages
    assert staged.fused is None and fused.fused is not None
    draws = GeneratorDraws(5, device="cpu")
    state = tafm.init(draws, cfg, data)
    state = state._replace(c=torch.full((cfg.n_units,), cfg.theta - 1,
                                        dtype=torch.int32), i=90)
    total = 0
    for step in range(3):
        samples = data[4 * step:4 * step + 4]
        other = GeneratorDraws(0, device="cpu")
        other.generator.set_state(draws.generator.get_state())
        snew, saux = tafm._step(state, samples, draws, cfg, staged)
        fnew, faux = tafm._step(state, samples, other, cfg, fused)
        assert torch.equal(draws.generator.get_state(),
                           other.generator.get_state())
        for field in ("gmu", "cascade_size", "waves"):
            assert torch.equal(getattr(saux, field), getattr(faux, field))
        assert torch.equal(snew.c, fnew.c)
        waves = int(saux.waves)
        _assert_w_close(fnew.w, snew.w.numpy(), 1 + waves)
        total += waves
        state = snew
    assert total > 0
    assert fused_ops.DEFAULT_WAVE_CAP is cas_ops.DEFAULT_WAVE_CAP
