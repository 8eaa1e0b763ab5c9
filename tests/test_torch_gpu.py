"""The port's CUDA kernels and kernel path on the card.

Every test here needs an NVIDIA card and skips without one. The file
imports neither JAX nor ``tests/conftest.py``'s helpers, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` is the full check on the card; these are the quick ones.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro_torch import configs
from repro_torch.api import TopoMap
from repro_torch.core.afm import AFMConfig
from repro_torch.device import sm_count
from repro_torch.kernels.bmu import ops as bmu_ops
from repro_torch.kernels.bmu import ref as bmu_ref
from repro_torch.kernels.cascade import ops as cas_ops
from repro_torch.kernels.cascade import ref as cas_ref
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.flash import ref as flash_ref
from repro_torch.kernels.fused import ops as fused_ops
from repro_torch.kernels.fused import ref as fused_ref
from repro_torch.kernels.swa import ops as swa_ops
from repro_torch.kernels.swa import ref as swa_ref
from repro_torch.models import attention, transformer
from repro_torch.serving import serve_step
from repro_torch.sharding import spawn_ranks
import torch_ranks  # the ranks' bodies, JAX-free

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


#: the main path's shapes (B 16 and 10,000); shapes that straddle the
#: plan: fewer units than the 132 splits of rows_kernel (37, 100), one unit
#: past a split or tile edge (133 over 132 splits; 129 and 1,025 past 128-
#: unit tiles), B at and one past rows_kernel's 32, ragged D (the scalar
#: loads)
BMU_SHAPES = [(900, 16, 784), (900, 10000, 784), (900, 300, 784),
              (37, 5, 13), (100, 16, 784), (133, 16, 784), (129, 65, 33),
              (1025, 300, 784), (900, 32, 784), (900, 33, 783),
              (900, 17, 785), (1, 3, 1)]


@pytest.mark.parametrize("precision", ["exact", "bf16"])
@pytest.mark.parametrize("n,b,d", BMU_SHAPES)
def test_bmu_kernel_matches_plain(cuda, precision, n, b, d):
    gen = torch.Generator(device=cuda).manual_seed(n + b + d)
    w = torch.randn(n, d, generator=gen, device=cuda)
    s = torch.randn(b, d, generator=gen, device=cuda)
    idx, q2 = bmu_ops.bmu(w, s, precision=precision)
    fn = bmu_ref.bmu_ref if precision == "exact" else bmu_ref.bmu_bf16_ref
    idx_r, q2_r = fn(w, s)
    bound = bmu_ref.tie_bound(w, s)
    differ = idx != idx_r
    assert bool((bmu_ref.top2_gap(w, s)[differ] <= bound[differ]).all())
    assert bool(((q2 - q2_r).abs() <= bound).all())


@pytest.mark.parametrize("precision", ["exact", "bf16"])
@pytest.mark.parametrize("b", [16, 300])
def test_bmu_ties_across_splits_go_to_the_lowest_index(cuda, precision, b):
    """Units duplicated into other splits (other 6-7-unit slices at B 16,
    other 128-unit tiles at B 300) tie bitwise; the lower index wins."""
    gen = torch.Generator(device=cuda).manual_seed(b)
    n, d = 900, 784
    w = torch.randn(n, d, generator=gen, device=cuda)
    lo = torch.tensor([3, 10, 130, 255, 500], device=cuda)
    hi = torch.tensor([800, 450, 899, 640, 777], device=cuda)
    w[hi] = w[lo]
    pick = torch.arange(b, device=cuda) % len(lo)
    s = w[hi[pick]] + 1e-3 * torch.randn(b, d, generator=gen, device=cuda)
    p = bmu_ops.plan(n, b, d, sm_count(cuda))
    assert all(_split_of(p, int(x)) != _split_of(p, int(y))
               for x, y in zip(lo, hi))
    idx, _ = bmu_ops.bmu(w, s, precision=precision)
    assert torch.equal(idx.long(), lo[pick])


def _split_of(p, unit):
    return next(i for i in range(p.splits)
                if p.unit_range(i)[0] <= unit < p.unit_range(i)[1])


@pytest.mark.parametrize("precision", ["exact", "bf16"])
@pytest.mark.parametrize("n,b,d", [(900, 16, 784), (900, 10000, 784),
                                   (37, 5, 13), (1025, 300, 783)])
def test_bmu_is_bitwise_repeatable_and_split_invariant(cuda, precision, n,
                                                       b, d):
    """Two calls give bitwise equal results (no atomics, fixed orders), and
    so does any other split count of the same kernel, empty splits
    included: a distance is summed in one order wherever its unit sits."""
    gen = torch.Generator(device=cuda).manual_seed(n + b)
    w = torch.rand(n, d, generator=gen, device=cuda)
    s = torch.rand(b, d, generator=gen, device=cuda)
    first = bmu_ops.bmu(w, s, precision=precision)
    again = bmu_ops.bmu(w, s, precision=precision)
    p = bmu_ops.plan(n, b, d, sm_count(cuda))
    units = -(-n // p.unit_step)
    for splits in (1, 3, units, units + 5):
        other = bmu_ops.run_plan(
            w, s, bmu_ops.Plan(p.kernel, n, b, p.sample_tile, splits),
            precision=precision)
        for a, r in zip(other, first):
            assert torch.equal(a, r), splits
    for a, r in zip(again, first):
        assert torch.equal(a, r)


@pytest.mark.parametrize("side", [1, 7, 30, 64])
def test_cascade_kernel_bitwise(cuda, side):
    gen = torch.Generator(device=cuda).manual_seed(side)
    c = torch.randint(0, 6, (side, side), generator=gen, device=cuda,
                      dtype=torch.int32)
    fired = torch.rand(side, side, generator=gen, device=cuda) < 0.3
    bern = torch.rand(4, side, side, generator=gen, device=cuda) < 0.7
    for a, r in zip(cas_ops.cascade_wave(c, fired, bern, 4),
                    cas_ref.cascade_wave_ref(c, fired, bern, 4)):
        assert torch.equal(a, r)


def test_kernel_backend_fits_on_the_card(cuda):
    """The staged path: a bmu search and one drive_cascade launch a step,
    cascade_wave only for the waves past the 16-wave block."""
    rng = np.random.default_rng(0)
    x = rng.random((500, 24), dtype=np.float32)
    before = (bmu_ops.launches, cas_ops.drive_launches, cas_ops.launches)
    tm = TopoMap(AFMConfig(side=8, dim=24, batch=8, i_max=800),
                 backend="kernel", device=cuda).fit(x, num_steps=40)
    tail = int((tm.fit_aux_.waves - cas_ops.DEFAULT_WAVE_CAP).clamp(
        min=0).sum())
    assert bmu_ops.launches > before[0]
    assert cas_ops.drive_launches == before[1] + 40
    assert cas_ops.launches == before[2] + tail
    assert tm.fit_aux_.waves.is_cuda and int(tm.fit_aux_.waves.sum()) > 0
    assert tm.state_.w.is_cuda and bool(torch.isfinite(tm.state_.w).all())
    assert tm.transform(x).shape == (500,)


def _drive_inputs(cuda, side, d, w_cap=16, seed=0, theta=4):
    """Merged weights, counters below theta, adaptation counts and the
    draws, made on the CPU and moved to the card."""
    gen = torch.Generator().manual_seed(seed)
    n = side * side
    out = (torch.rand(n, d, generator=gen),
           torch.randint(theta - 2, theta, (side, side), generator=gen,
                         dtype=torch.int32),
           torch.randint(0, 3, (side, side), generator=gen,
                         dtype=torch.int32),
           torch.rand(8, side, side, generator=gen) < 0.9,
           torch.rand(w_cap, 4, side, side, generator=gen) < 0.9)
    return tuple(x.to(cuda) for x in out)


#: (name, budget) on a 16-wave block: none, one wave, the whole block, and
#: a budget cut short
DRIVE_BUDGETS = [("zero", 0), ("one", 1), ("cap", 16), ("cut", 5)]


@pytest.mark.parametrize("budget", [b for _, b in DRIVE_BUDGETS],
                         ids=[name for name, _ in DRIVE_BUDGETS])
@pytest.mark.parametrize("d", [13, 50, 783, 784])
@pytest.mark.parametrize("side", [1, 7, 9, 12, 30])
def test_drive_cascade_kernel_matches_plain(cuda, side, d, budget):
    """The staged step's drive and cascade kernel against its plain version
    on the card, same inputs: the weights, counters, front, [size, waves]
    and receive counts bit for bit (the same _rn operations in the same
    order); one launch a call."""
    args = _drive_inputs(cuda, side, d, seed=side * 1000 + d + budget)
    kw = dict(l_c=0.3, theta=4, budget=budget)
    before = cas_ops.drive_launches
    out = cas_ops.drive_cascade(*args, **kw)
    assert cas_ops.drive_launches == before + 1
    ref = cas_ref.drive_cascade_ref(*args, **kw)
    for a, r in zip(out, ref):
        assert a.dtype == r.dtype and a.shape == r.shape
        assert _same_bits(a, r) if a.is_floating_point() else torch.equal(a, r)
    waves = int(ref[3][1])
    assert waves <= budget and (waves == budget or not bool(ref[2].any()))
    if side > 1 and budget > 0:
        assert waves > 0


@pytest.mark.parametrize("case", ["zeros", "overflow", "clean"])
def test_drive_cascade_is_bitwise_plain_on_any_weights(cuda, case):
    """Weights of both zero signs from the start, or an update that
    overflows in a wave, send the kernel's waves to the dirty path
    (every pair updated); each way the outputs are the plain version's bit
    for bit."""
    side, d = 12, 20
    w, c, counts, drive, bern = _drive_inputs(cuda, side, d, seed=11)
    n = side * side
    if case == "zeros":
        w[::7] = 0.0
        w[3::7] = -0.0
    elif case == "overflow":   # horizontal neighbours of opposite sign
        sign = 1.0 - 2.0 * (torch.arange(n, device=cuda) % 2)
        w = (3e38 * sign[:, None]).expand(n, d).contiguous()
    kw = dict(l_c=0.3, theta=4, budget=16)
    out = cas_ops.drive_cascade(w, c, counts, drive, bern, **kw)
    ref = cas_ref.drive_cascade_ref(w, c, counts, drive, bern, **kw)
    assert int(ref[3][1]) > 1
    assert bool(torch.isfinite(ref[0]).all()) == (case != "overflow")
    for a, r in zip(out[1:], ref[1:]):
        assert torch.equal(a, r)
    assert _same_bits(out[0], ref[0])


def test_drive_cascade_takes_inputs_off_16_byte_alignment(cuda):
    """W, the counters and counts 4 bytes past an aligned address and the
    draws 1 and 3 bytes past one: the kernel copies them in by 4-byte or
    plain copies and still gives the plain version's bits."""
    side, d = 30, 784
    args0 = _drive_inputs(cuda, side, d, seed=5)

    def shifted(x, by):
        flat = torch.empty(x.numel() + by, dtype=x.dtype, device=cuda)
        out = flat[by:].view(x.shape)
        out.copy_(x)
        return out

    args = [shifted(x, by) for x, by in zip(args0, (1, 1, 1, 1, 3))]
    assert all(x.data_ptr() % 16 for x in args)
    kw = dict(l_c=0.3, theta=4, budget=16)
    out = cas_ops.drive_cascade(*args, **kw)
    ref = cas_ref.drive_cascade_ref(*args0, **kw)
    assert int(ref[3][1]) > 0
    for a, r in zip(out[1:], ref[1:]):
        assert torch.equal(a, r)
    assert _same_bits(out[0], ref[0])


def test_drive_cascade_kernel_is_bitwise_repeatable(cuda):
    """No float atomics and fixed orders: two calls give the same bits."""
    args = _drive_inputs(cuda, 30, 784, seed=3)
    kw = dict(l_c=0.3, theta=4, budget=16)
    first = cas_ops.drive_cascade(*args, **kw)
    again = cas_ops.drive_cascade(*args, **kw)
    assert int(first[3][1]) > 0
    for a, r in zip(first, again):
        assert torch.equal(a, r)


def test_drive_cascade_plan_is_checked_by_the_kernel(cuda):
    """The C side holds ``ops.plan_cascade`` to the kernel as built: a plan
    whose blocks, features a block, threads, shared bytes or staged waves
    disagree with it is refused."""
    import ctypes
    from repro_torch.kernels import _build
    p = cas_ops._cascade_plan(cuda.index or 0, 900, 784)
    assert (p.blocks, p.ds) == (131, 6) or sm_count(cuda) != 132
    lib = _build.load()
    out = (ctypes.c_int32 * 2)()
    assert lib.repro_cascade_plan(900, 784, p.c_array(), out) == 0
    assert tuple(out)[0] == sm_count(cuda)
    for slot, value in ((0, p.blocks + 1), (1, p.ds + 1), (2, 256),
                        (3, p.smem + 16), (4, p.staged_waves + 1)):
        arr = p.c_array()
        arr[slot] = value
        assert lib.repro_cascade_plan(900, 784, arr, out) != 0, slot
    huge = cas_ops.CascadePlan(900, 784 * 40, 1, 784 * 40, 0)
    assert lib.repro_cascade_plan(900, 784 * 40, huge.c_array(), out) != 0


@pytest.mark.parametrize("side,d,b", [(30, 784, 16), (7, 13, 5),
                                      (12, 50, 40)])
def test_fused_cascade_equals_drive_cascade(cuda, side, d, b):
    """The cascade of a ``fused_step`` call with given GMUs equals the
    merge plus ``drive_cascade`` from the same merged W bit for bit: the
    two kernels run the same drive and waves (``runtime/waves.cuh``)."""
    w, c, s, drive, bern = _fused_inputs(cuda, side, d, b, seed=side + b)
    n = side * side
    gmu = (torch.arange(b, dtype=torch.int32) * 37 % n).to(cuda)
    out = fused_ops.fused_step(w, c, s, 0.05, 0.3, drive, bern, gmu,
                               theta=4, budget=16)
    merged, counts = fused_ref.merge(w, s, gmu, 0.05)
    staged = cas_ops.drive_cascade(merged.contiguous(), c,
                                   counts.reshape(side, side), drive, bern,
                                   l_c=0.3, theta=4, budget=16)
    assert int(out[3][1]) > 0
    for a, r in zip(out[1:5], staged[1:]):
        assert torch.equal(a, r)
    assert _same_bits(out[0], staged[0])


@pytest.mark.parametrize("search", ["given", "exact", "bf16"])
@pytest.mark.parametrize("side,d,b,w_cap,budget", [
    (30, 784, 16, 16, 16), (7, 13, 5, 3, 3), (30, 784, 16, 16, 5),
    (1, 3, 1, 2, 2), (30, 783, 40, 16, 16), (9, 50, 37, 20, 20),
    (30, 784, 16, 4, 0)])
def test_fused_kernel_matches_plain(cuda, side, d, b, w_cap, budget, search):
    """The fused kernel against its plain version on the card, same inputs:
    GMUs and q2 within the tie bound (a GMU that differs inside it: the
    plain version again on the kernel's GMUs), then the counters, front,
    [size, waves] and receive counts bitwise and w within 8 (1 + waves) f32
    ULP of max|w|."""
    gen = torch.Generator().manual_seed(side * 1000 + d + b)
    n = side * side
    w = torch.rand(n, d, generator=gen).to(cuda)
    s = torch.rand(b, d, generator=gen).to(cuda)
    c = torch.randint(2, 4, (side, side), generator=gen,
                      dtype=torch.int32).to(cuda)
    drive = (torch.rand(8, side, side, generator=gen) < 0.9).to(cuda)
    bern = (torch.rand(w_cap, 4, side, side, generator=gen) < 0.9).to(cuda)
    gmu = torch.randint(0, n, (b,), generator=gen, dtype=torch.int32).to(cuda)
    given = gmu if search == "given" else None
    kw = dict(theta=4, budget=budget,
              precision="bf16" if search == "bf16" else "exact")
    before = fused_ops.launches
    out = fused_ops.fused_step(w, c, s, 0.05, 0.3, drive, bern, given, **kw)
    assert fused_ops.launches == before + 1
    ref = fused_ref.fused_step_ref(w, c, s, 0.05, 0.3, drive, bern, given,
                                   **kw)
    if given is None:
        bound = bmu_ref.tie_bound(w, s)
        differ = out[5] != ref[5]
        rw, rs = (w, s) if search == "exact" else (w.bfloat16().float(),
                                                   s.bfloat16().float())
        assert bool((bmu_ref.top2_gap(rw, rs)[differ] <= bound[differ]).all())
        assert bool(((out[6] - ref[6]).abs()[~differ] <= bound[~differ]).all())
        if bool(differ.any()):
            ref = fused_ref.fused_step_ref(w, c, s, 0.05, 0.3, drive, bern,
                                           out[5], **kw)
    for a, r in zip(out[1:5], ref[1:5]):
        assert torch.equal(a, r)
    waves = int(ref[3][1])
    assert waves <= budget and (waves == budget or not bool(ref[2].any()))
    eps = torch.finfo(torch.float32).eps
    assert float((out[0] - ref[0]).abs().max()) <= \
        8 * (1 + waves) * eps * float(ref[0].abs().max())


def _fused_inputs(cuda, side, d, b, w_cap=16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    n = side * side
    w = torch.rand(n, d, generator=gen).to(cuda)
    s = torch.rand(b, d, generator=gen).to(cuda)
    c = torch.randint(2, 4, (side, side), generator=gen,
                      dtype=torch.int32).to(cuda)
    drive = (torch.rand(8, side, side, generator=gen) < 0.9).to(cuda)
    bern = (torch.rand(w_cap, 4, side, side, generator=gen) < 0.9).to(cuda)
    return w, c, s, drive, bern


#: (side, D, B): the main path's shape, B past two search tiles, ragged D
#: (the scalar loads), fewer units than blocks, one unit
FUSED_SEARCH_SHAPES = [(30, 784, 16), (30, 784, 40), (30, 783, 33),
                       (7, 13, 5), (10, 785, 16), (1, 3, 1)]


@pytest.mark.parametrize("side,d,b", FUSED_SEARCH_SHAPES)
def test_fused_exact_search_equals_bmu_bitwise(cuda, side, d, b):
    """The fused kernel's exact search and ``bmu``'s ``rows_kernel`` share
    their arithmetic (``runtime/search.cuh``): the same GMUs and q2, bit for
    bit, on the same W and samples, also where the two split the units
    differently (B > 16)."""
    w, c, s, drive, bern = _fused_inputs(cuda, side, d, b, seed=side + d + b)
    n = side * side
    assert bmu_ops.plan(n, b, d, sm_count(cuda)).kernel == "rows"
    out = fused_ops.fused_step(w, c, s, 0.05, 0.3, drive, bern, theta=4,
                               budget=16)
    idx, q2 = bmu_ops.bmu(w, s)
    assert torch.equal(out[5], idx)
    assert torch.equal(out[6], q2)


@pytest.mark.parametrize("precision", ["exact", "bf16"])
def test_fused_ties_across_splits_go_to_the_lowest_index(cuda, precision):
    """Rows duplicated into other blocks' splits tie bitwise; the fused
    search hands each tie to the lower index, as ``bmu`` does."""
    side, d, b = 30, 784, 16
    w, c, s, drive, bern = _fused_inputs(cuda, side, d, b, seed=7)
    lo = torch.tensor([3, 10, 130, 255, 500], device=cuda)
    hi = torch.tensor([800, 450, 899, 640, 777], device=cuda)
    w[hi] = w[lo]
    pick = torch.arange(b, device=cuda) % len(lo)
    gen = torch.Generator(device=cuda).manual_seed(7)
    s = (w[hi[pick]] + 1e-3 * torch.randn(b, d, generator=gen,
                                          device=cuda)).contiguous()
    p = fused_ops._plan(cuda.index or 0, side * side, d, b)
    split = [next(i for i in range(p.splits)
                  if p.unit_range(i)[0] <= int(u) < p.unit_range(i)[1])
             for u in torch.cat([lo, hi])]
    assert all(x != y for x, y in zip(split[:5], split[5:]))
    out = fused_ops.fused_step(w, c, s, 0.05, 0.3, drive, bern, theta=4,
                               budget=16, precision=precision)
    assert torch.equal(out[5].long(), lo[pick])


@pytest.mark.parametrize("search", ["given", "exact", "bf16"])
def test_fused_kernel_is_bitwise_repeatable(cuda, search):
    """No float atomics and fixed orders: two calls give the same bits."""
    side, d, b = 30, 784, 16
    w, c, s, drive, bern = _fused_inputs(cuda, side, d, b, seed=3)
    gmu = (torch.arange(b, dtype=torch.int32) * 37 % 900).to(cuda)
    given = gmu if search == "given" else None
    kw = dict(theta=4, budget=16,
              precision="bf16" if search == "bf16" else "exact")
    first = fused_ops.fused_step(w, c, s, 0.05, 0.3, drive, bern, given, **kw)
    again = fused_ops.fused_step(w, c, s, 0.05, 0.3, drive, bern, given, **kw)
    assert int(first[3][1]) > 0
    for a, r in zip(first, again):
        assert torch.equal(a, r)


def _same_bits(a, r):
    """Equal bit for bit, NaN where the other has NaN (its bits may vary)."""
    nan = torch.isnan(r)
    return torch.equal(torch.isnan(a), nan) and torch.equal(
        a[~nan].view(torch.int32), r[~nan].view(torch.int32))


@pytest.mark.parametrize("case", ["zeros", "overflow", "clean"])
def test_fused_waves_are_bitwise_plain_on_any_weights(cuda, case):
    """While every weight of a block's slice is finite and non-zero, the
    kernel's waves update only the sites that receive a broadcast (the
    others keep their bits); exact zeros of either sign from the start, or
    an update that overflows in a wave, switch it to updating every site.
    Each way the counters, front, [size, waves], receive counts and weights
    are the plain version's bit for bit."""
    side, d, b = 12, 20, 8
    w, c, s, drive, bern = _fused_inputs(cuda, side, d, b, seed=11)
    n = side * side
    if case == "zeros":
        w[::7] = 0.0
        w[3::7] = -0.0
    elif case == "overflow":   # horizontal neighbours of opposite sign
        sign = 1.0 - 2.0 * (torch.arange(n, device=cuda) % 2)
        w = (3e38 * sign[:, None]).expand(n, d).contiguous()
    gmu = (torch.arange(b, dtype=torch.int32) * 17 % n).to(cuda)
    kw = dict(theta=4, budget=16)
    out = fused_ops.fused_step(w, c, s, 0.05, 0.3, drive, bern, gmu, **kw)
    ref = fused_ref.fused_step_ref(w, c, s, 0.05, 0.3, drive, bern, gmu, **kw)
    assert int(ref[3][1]) > 1
    assert bool(torch.isfinite(ref[0]).all()) == (case != "overflow")
    for a, r in zip(out[1:5], ref[1:5]):
        assert torch.equal(a, r)
    assert _same_bits(out[0], ref[0])


@pytest.mark.parametrize("search", ["given", "exact"])
def test_fused_kernel_takes_inputs_off_16_byte_alignment(cuda, search):
    """W, the samples and the draws 4 bytes (or 1 byte) past an aligned
    address: the kernel copies them in without bulk or TMA copies and with
    scalar row loads, and still gives the plain version's integers and
    weights bit for bit (the GMUs within the tie bound)."""
    side, d, b, w_cap = 30, 784, 16, 16
    w0, c, s0, drive0, bern0 = _fused_inputs(cuda, side, d, b, seed=5)
    n = side * side

    def shifted(x, by):
        flat = torch.empty(x.numel() + by, dtype=x.dtype, device=cuda)
        out = flat[by:].view(x.shape)
        out.copy_(x)
        return out

    w, s = shifted(w0, 1), shifted(s0, 1)
    drive, bern = shifted(drive0, 1), shifted(bern0, 3)
    assert w.data_ptr() % 16 and bern.data_ptr() % 4
    gmu = (torch.arange(b, dtype=torch.int32) * 29 % n).to(cuda)
    given = gmu if search == "given" else None
    kw = dict(theta=4, budget=w_cap)
    out = fused_ops.fused_step(w, c, s, 0.05, 0.3, drive, bern, given, **kw)
    if given is None:
        aligned = fused_ops.fused_step(w0, c, s0, 0.05, 0.3, drive0, bern0,
                                       **kw)
        assert torch.equal(out[5], aligned[5]) or bool(
            (bmu_ref.top2_gap(w0, s0)[out[5] != aligned[5]]
             <= bmu_ref.tie_bound(w0, s0)[out[5] != aligned[5]]).all())
        given = out[5]
    ref = fused_ref.fused_step_ref(w0, c, s0, 0.05, 0.3, drive0, bern0, given,
                                   **kw)
    assert int(ref[3][1]) > 0
    for a, r in zip(out[1:5], ref[1:5]):
        assert torch.equal(a, r)
    assert _same_bits(out[0], ref[0])


def test_fused_plan_is_checked_by_the_kernel(cuda):
    """The C side holds ``ops.plan`` to the kernel as built: a plan whose
    threads, shared bytes or feature split disagree with it is refused."""
    import ctypes
    from repro_torch.kernels import _build
    p = fused_ops._plan(cuda.index or 0, 900, 784, 16)
    assert (p.blocks, p.ds, p.feature_blocks) == (sm_count(cuda), 6, 131)
    lib = _build.load()
    out = (ctypes.c_int32 * 3)()
    assert lib.repro_fused_plan(900, 784, 16, p.c_array(), out) == 0
    assert out[2] >= p.blocks
    for slot, value in ((2, 256), (3, p.smem + 16), (1, 5), (4, 2), (5, 8),
                        (7, 2)):
        arr = p.c_array()
        arr[slot] = value
        assert lib.repro_fused_plan(900, 784, 16, arr, out) != 0, slot


def test_fused_backend_fits_on_the_card(cuda):
    rng = np.random.default_rng(1)
    x = rng.random((500, 24), dtype=np.float32)
    before = fused_ops.launches
    tm = TopoMap(AFMConfig(side=8, dim=24, batch=8, i_max=800),
                 backend="kernel", backend_options={"kernel": "fused"},
                 device=cuda).fit(x, num_steps=40)
    assert fused_ops.launches == before + 40
    assert tm.fit_aux_.waves.is_cuda
    assert tm.state_.w.is_cuda and bool(torch.isfinite(tm.state_.w).all())
    assert tm.transform(x).shape == (500,)


#: (B, H, Hkv, hd, W, first pos): the long_500k decode shape of llama3.2-1b
#: at pos 0, 5, 8191 and 70,000; its serve shape (pos 128-191 over the
#: rows); the shapes of tests/test_kernels.py; rep 3 and rep 1 over ragged
#: caches; rows on both sides of a full ring; a one-slot cache. At
#: long_500k the kernel runs 32 splits of 256 slots: pos 0 leaves one
#: valid slot and 31 empty splits, pos 255 and 511 end the valid slots on
#: a split edge, pos 256 one past it, 70,000 is a full, wrapped ring
SWA_SHAPES = [(1, 32, 8, 64, 8192, p)
              for p in (0, 5, 255, 256, 511, 8191, 70_000)] + [
    (4, 32, 8, 64, 192, 128), (2, 8, 2, 64, 512, 100),
    (1, 4, 1, 128, 1024, 70_000), (3, 16, 8, 64, 256, 255),
    (2, 4, 4, 128, 128, 4), (2, 6, 2, 128, 96, 60), (2, 3, 3, 64, 100, 120),
    (3, 8, 2, 64, 64, 40), (2, 4, 4, 64, 1, 5),
    # the MoE decode shapes: granite-moe-1b-a400m, deepseek-moe-16b (rep 1,
    # hd 128), and hd 32 (their smoke widths) on one split and on several
    (4, 16, 8, 64, 192, 128), (4, 16, 16, 128, 160, 96),
    (2, 4, 2, 32, 40, 20), (1, 8, 2, 32, 1024, 700),
    # recurrentgemma-2b's local attention (hd 256, MQA rep 10): the serve
    # shape and the 2,048-slot ring (8 splits), wrapped; a ragged rep 12
    # and rep 16 at hd 256 and 64
    (4, 10, 1, 256, 192, 150), (1, 10, 1, 256, 2048, 8703),
    (2, 12, 1, 256, 300, 250), (2, 24, 2, 256, 64, 70),
    (2, 32, 2, 64, 512, 400), (1, 12, 1, 128, 1024, 900),
    # whisper-medium's decode (MHA 16/16, hd 64): the self-attention over
    # its 192-slot cache, and the cross-attention over the 1,500 frames at
    # pos 1,499 and past it (every slot valid; 5 splits of 300 slots, each
    # ending in a partial 128-slot chunk)
    (4, 16, 16, 64, 192, 128), (4, 16, 16, 64, 1500, 1499),
    # qwen2-vl-72b's decode (GQA 64/8, hd 128, rep 8): the serve shape and
    # the long_500k ring of 8,192 slots (32 splits of 256), wrapped
    (4, 64, 8, 128, 192, 128), (1, 64, 8, 128, 8192, 8703)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,hd,w,pos", SWA_SHAPES)
def test_swa_kernel_matches_plain(cuda, b, h, hkv, hd, w, pos, dtype):
    """The kernel against its plain version on the card, same inputs: within
    2e-4 relative and absolute in f32 (sums in another order), within one
    bf16 ulp of the output plus 1e-3 in bf16."""
    gen = torch.Generator().manual_seed(b * h + w + pos)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda, dtype)
               for shape in ((b, h, hd), (b, w, hkv, hd), (b, w, hkv, hd)))
    posv = (pos + 21 * torch.arange(b, dtype=torch.int32)).to(cuda)
    before = swa_ops.launches
    out = swa_ops.swa_decode(q, k, v, posv)
    assert swa_ops.launches == before + 1
    ref = swa_ref.swa_decode_ref(q, k, v, posv, window=w).float()
    err = (out.float() - ref).abs()
    if dtype == torch.float32:
        bound = 2e-4 + 2e-4 * ref.abs()
    else:
        bound = 2.0 ** -7 * ref.abs() + 1e-3
    assert bool((err <= bound).all()), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,pos", [(1, 255), (1, 70_000), (4, 128)])
def test_swa_kernel_is_bitwise_repeatable(cuda, b, pos, dtype):
    """The split combine runs in a fixed order: two calls are bitwise
    equal (long_500k's 32 splits; the serve shape's one), and the combine's
    tickets are back at zero after a call."""
    w = 8192 if b == 1 else 192
    gen = torch.Generator().manual_seed(pos)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda, dtype)
               for shape in ((b, 32, 64), (b, w, 8, 64), (b, w, 8, 64)))
    posv = (pos + torch.arange(b, dtype=torch.int32)).to(cuda)
    splits = swa_ops.plan(b, 8, w, sm_count(cuda)).splits
    assert (splits > 1) == (b == 1)
    assert torch.equal(swa_ops.swa_decode(q, k, v, posv),
                       swa_ops.swa_decode(q, k, v, posv))
    if splits > 1:          # the last block of each (row, kv head) reset it
        tickets = swa_ops.tickets(q.device, torch.cuda.current_stream(
            q.device).cuda_stream, b * 8)
        assert not bool(tickets.any())


def test_swa_kernel_refuses_what_it_is_not_built_for(cuda):
    """An hd or rep outside the built set raises on the card, as on the
    CPU, and launches nothing."""
    before = swa_ops.launches
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    for h, hkv, hd in ((8, 1, 96), (8, 1, 512), (17, 1, 64)):
        q = torch.zeros(1, h, hd, device=cuda).bfloat16()
        kv = torch.zeros(1, 16, hkv, hd, device=cuda).bfloat16()
        with pytest.raises(ValueError):
            swa_ops.swa_decode(q, kv, kv, pos)
    assert swa_ops.launches == before


#: the cells' attention shapes (B, S, H, Hkv, hd): granite-moe-1b-a400m's
#: training rows (4 of the cell's 32; GQA rep 2), deepseek-moe-16b's
#: prefill at the ladder's shortest, median and longest rung (MHA), a
#: ragged S at MQA rep 4, and two more configurations that reach the
#: kernel: qwen2-vl-72b's GQA rep 8 at hd 128 and whisper-medium's
#: decoder, MHA at hd 64
FLASH_SHAPES = [(4, 1024, 16, 8, 64), (1, 576, 16, 16, 128),
                (1, 1500, 16, 16, 128), (1, 3968, 16, 16, 128),
                (2, 77, 4, 1, 64), (1, 512, 64, 8, 128),
                (2, 448, 16, 16, 64)]


def _flash_inputs(cuda, b, s, h, hkv, hd, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
            for shape in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd))]


def _naive_attention(q, k, v):
    """``self_attention``'s path before the kernel: the GQA repeat, the
    causal mask, ``_attend``."""
    rep = q.shape[2] // k.shape[2]
    s = q.shape[1]
    mask = attention._causal_mask(s, s, 0, device=q.device)[None, None]
    return attention._attend(q, attention._repeat_kv(k, rep),
                             attention._repeat_kv(v, rep), mask)


def _within(got, want, units, slack=0.0):
    err = flash_ref.err_units(got, want, slack)
    assert err <= units, (err, units)


#: the kernels against their plain version, in ``flash_ref.err_units`` (a
#: bf16 ulp of the value or of its row's RMS): both sum the same f32
#: products in other orders (dQ's f32 atomics in no fixed order) and round
#: once, so a value may land on the other side of a bf16 rounding boundary
#: (1 unit); a P rounded to its other bf16 neighbour moves a value by ~2^-9
#: of one term of hundreds
PLAIN_UNITS = 2.0
#: against ``_attend`` (autograd through it for the gradients): up to three
#: roundings a value fall elsewhere (P rounded to bf16 after the
#: normalisation, not before; autograd's bf16 dP; its bf16 dK and dV of
#: each query head before the GQA sum), each within a unit of the value
ATTEND_UNITS = 6.0


def _dq_slack(q, k, v, out, d_out):
    """The modelled part of dq's distance from autograd through
    ``_attend``, a bound of each element: the kernel's D = rowsum(dO o O)
    takes the bf16 O, off the exact rowsum by eps_i <= 2^-8 sum |dO o O|_i;
    autograd rounds dP to bf16 (|delta| <= 2^-8 |dP|), inside its D too.
    dq_i = sum_j P_ij (dP_ij - D_i) k_j / sqrt(hd) then moves by at most
    (eps_i |P k|_i + 2^-8 (sum_j P_ij |dP_ij| |k_j| + sum_j P_ij |dP_ij|
    |P k|_i)) / sqrt(hd). Where dq is small beside these (a row whose P
    sits on one key), they dominate it."""
    rep = q.shape[2] // k.shape[2]
    hd, s = q.shape[3], q.shape[1]
    kf, vf = (x.float().repeat_interleave(rep, 2) for x in (k, v))
    x = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(hd)
    past = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(x.masked_fill(past, -math.inf), dim=-1)
    pk = torch.einsum("bhqk,bkhd->bqhd", p, kf).abs()
    p_dp = p * torch.einsum("bqhd,bkhd->bhqk", d_out.float(), vf).abs()
    eps = 2.0 ** -8 * (d_out.float() * out.float()).abs().sum(-1,
                                                              keepdim=True)
    return (eps * pk + 2.0 ** -8 * (
        torch.einsum("bhqk,bkhd->bqhd", p_dp, kf.abs())
        + p_dp.sum(-1).permute(0, 2, 1)[..., None] * pk)) / math.sqrt(hd)


#: the backward at the training shapes only: its plain versions hold f32
#: (B, H, S, S) tensors
FLASH_CASES = [("forward", *shape) for shape in FLASH_SHAPES] + [
    ("backward", *shape) for shape in FLASH_SHAPES if shape[1] <= 1024]


@pytest.mark.parametrize("direction,b,s,h,hkv,hd", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, direction, b, s, h, hkv, hd):
    """One direction of the kernel against its plain version on the card,
    same inputs, and against the path it replaces (``_attend``, autograd
    through it for the backward), each value in units of a bf16 ulp of it
    or of its row (``flash_ref.err_units``).
    - Against the plain version: the output and the gradients within
      PLAIN_UNITS; lse within 1e-5 (some f32 ulps of values below 16).
    - Against ``_attend``: within ATTEND_UNITS, dq after ``_dq_slack``."""
    q, k, v = _flash_inputs(cuda, b, s, h, hkv, hd, seed=s + hd)
    want, want_lse = flash_ref.flash_forward_ref(q, k, v)
    before = (flash_ops.launches_fwd, flash_ops.launches_bwd)
    if direction == "forward":
        out, lse = flash_ops._forward(q, k, v)
        torch.cuda.synchronize()
        assert (flash_ops.launches_fwd, flash_ops.launches_bwd) == (
            before[0] + 1, before[1])
        _within(out, want, PLAIN_UNITS)
        assert float((lse - want_lse).abs().max()) <= 1e-5
        _within(out, _naive_attention(q, k, v), ATTEND_UNITS)
        return
    gen = torch.Generator(device=cuda).manual_seed(s)
    d_out = torch.randn(q.shape, generator=gen, device=cuda).to(torch.bfloat16)
    grads = flash_ops._backward(q, k, v, want, want_lse, d_out)
    torch.cuda.synchronize()
    assert (flash_ops.launches_fwd, flash_ops.launches_bwd) == (
        before[0], before[1] + 1)
    plain = flash_ref.flash_backward_ref(q, k, v, want, want_lse, d_out)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(_naive_attention(*leaves), leaves, d_out)
    slack = _dq_slack(q, k, v, want, d_out)
    for g, r, a, x, sl in zip(grads, plain, auto, (q, k, v), (slack, 0, 0)):
        assert g.shape == x.shape and g.dtype == torch.bfloat16
        _within(g, r, PLAIN_UNITS)
        _within(g, a, ATTEND_UNITS, sl)


def test_flash_autograd_at_granite_s_shape(cuda):
    """``flash_attention`` under autograd at granite's shape: its dq, dk
    and dv against autograd through ``_attend`` within ATTEND_UNITS (dq
    after ``_dq_slack``), one launch each way."""
    q, k, v = _flash_inputs(cuda, 4, 1024, 16, 8, 64, seed=3)
    gen = torch.Generator(device=cuda).manual_seed(4)
    d_out = torch.randn(q.shape, generator=gen, device=cuda).to(torch.bfloat16)
    before = (flash_ops.launches_fwd, flash_ops.launches_bwd)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_ops.flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, d_out)
    assert (flash_ops.launches_fwd, flash_ops.launches_bwd) == (
        before[0] + 1, before[1] + 1)
    slack = _dq_slack(q, k, v, out.detach(), d_out)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(_naive_attention(*leaves), leaves, d_out)
    for g, w, sl in zip(got, want, (slack, 0, 0)):
        _within(g, w, ATTEND_UNITS, sl)


def test_flash_kernel_refuses_what_it_is_not_built_for(cuda):
    """f32 and other head dims raise on the card and launch nothing."""
    before = (flash_ops.launches_fwd, flash_ops.launches_bwd)
    q, k, v = _flash_inputs(cuda, 1, 64, 4, 2, 64, seed=0)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_ops.flash_attention(q.float(), k.float(), v.float())
    for hd in (32, 256):
        x = torch.zeros((1, 64, 2, hd), dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="head dims"):
            flash_ops.flash_attention(x, x, x)
    assert (flash_ops.launches_fwd, flash_ops.launches_bwd) == before


def test_granite_train_step_takes_the_flash_kernel(cuda):
    """One train step of granite-moe-1b-a400m at full width and depth (B 2
    x S 256, bf16, ragged, remat, the 8x8 probe): each layer launches the
    forward twice (the forward and its recompute under the block's
    checkpoint) and the backward once, and no call of ``attend`` runs on
    the card."""
    import dataclasses

    from repro_torch.core import probe
    from repro_torch.data import tokens
    from repro_torch.draws import GeneratorDraws
    from repro_torch.training import AdamWConfig, train_step
    cfg = dataclasses.replace(configs.get("granite-moe-1b-a400m"),
                              moe_impl="ragged", remat=True)
    pcfg = probe.ProbeConfig(side=8, dim=cfg.d_model, i_max=1000)
    step = train_step.make_train_step(
        cfg, AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10), pcfg)
    state = train_step.init_train_state(cfg, pcfg, seed=0, device=cuda)
    batch = next(iter(tokens.batches(torch.Generator().manual_seed(1),
                                     cfg.vocab_size, 2, 256, 1,
                                     device=cuda)))
    before = (flash_ops.launches_fwd, flash_ops.launches_bwd,
              attention.plain_cuda_calls)
    state, metrics = step(state, batch, GeneratorDraws.for_step(0, 0, cuda))
    torch.cuda.synchronize()
    assert (flash_ops.launches_fwd - before[0],
            flash_ops.launches_bwd - before[1],
            attention.plain_cuda_calls - before[2]) == (
                2 * cfg.num_layers, cfg.num_layers, 0)
    assert bool(torch.isfinite(metrics["loss"]))


def test_deepseek_forward_takes_the_flash_kernel(cuda):
    """A forward of deepseek-moe-16b at full width cut to its first two
    layers (the dense one and a MoE one; bf16) over a 576-token prompt, the
    ladder's shortest: one forward launch a layer, no backward, no call of
    ``attend`` on the card, finite logits."""
    import dataclasses
    cfg = dataclasses.replace(configs.get("deepseek-moe-16b"), num_layers=2,
                              moe_impl="ragged")
    model = transformer.init_params(cfg, seed=0, device=cuda)
    tokens_ = torch.randint(0, cfg.vocab_size, (1, 576),
                            generator=torch.Generator().manual_seed(2)
                            ).to(cuda)
    before = (flash_ops.launches_fwd, flash_ops.launches_bwd,
              attention.plain_cuda_calls)
    with torch.no_grad():
        logits = transformer.forward(model, {"tokens": tokens_}, cfg)
    torch.cuda.synchronize()
    assert (flash_ops.launches_fwd - before[0],
            flash_ops.launches_bwd - before[1],
            attention.plain_cuda_calls - before[2]) == (cfg.num_layers, 0, 0)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_recurrent_decode_on_the_card_equals_the_cpu(cuda, arch):
    """Prefill and 6 decode steps of each recurrent smoke config (f32) on
    the card and on the CPU from the same weights: logits within 2e-4 (1 +
    max|logit|) at each step (fed the CPU's tokens); recurrentgemma's
    attention layers launch ``swa_decode`` once each a step (hd 128, rep
    2), mamba2 none."""
    import copy
    cfg = configs.get_smoke(arch)
    model = transformer.init_params(cfg, seed=0, device="cpu")
    gpu = copy.deepcopy(model).to(cuda)
    prompt = torch.randint(0, cfg.vocab_size, (2, 20),
                           generator=torch.Generator().manual_seed(3))
    want, cache = transformer.prefill(model, {"tokens": prompt}, cfg,
                                      cache_len=32)
    got, gcache = transformer.prefill(gpu, {"tokens": prompt.to(cuda)}, cfg,
                                      cache_len=32)
    attn = sum(c for _, k, c, _ in transformer._layer_plan(cfg)[0]
               if k == "attn")
    for i in range(6):
        tol = 2e-4 * (1 + float(want.abs().max()))
        assert float((got.cpu() - want).abs().max()) <= tol, i
        tok = want.argmax(-1)[:, None]
        pos = torch.full((2,), 20 + i, dtype=torch.int32)
        want, cache = transformer.decode_step(model, tok, pos, cache, cfg)
        before = swa_ops.launches
        got, gcache = transformer.decode_step(gpu, tok.to(cuda),
                                              pos.to(cuda), gcache, cfg)
        assert swa_ops.launches == before + attn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_kernel_is_bitwise_repeatable_over_whisper_s_frames(cuda, dtype):
    """The cross-attention's shape (B 4 x W 1,500, 5 splits combined in a
    fixed order): two calls bitwise equal."""
    gen = torch.Generator().manual_seed(26)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda, dtype)
               for shape in ((4, 16, 64), (4, 1500, 16, 64),
                             (4, 1500, 16, 64)))
    pos = torch.full((4,), 1499, dtype=torch.int32, device=cuda)
    assert swa_ops.plan(4, 16, 1500, sm_count(cuda)).splits > 1
    assert torch.equal(swa_ops.swa_decode(q, k, v, pos),
                       swa_ops.swa_decode(q, k, v, pos))


def test_whisper_decode_on_the_card_equals_the_cpu(cuda):
    """Prefill (the encoder over seeded frames) and 6 decode steps of
    whisper's smoke config (f32) on the card and on the CPU from the same
    weights: logits within 2e-4 (1 + max|logit|) at each step (fed the
    CPU's tokens); each step launches ``swa_decode`` twice a decoder layer
    (self- and cross-attention)."""
    import copy
    cfg = configs.get_smoke("whisper-medium")
    model = transformer.init_params(cfg, seed=0, device="cpu")
    gpu = copy.deepcopy(model).to(cuda)
    gen = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (2, 20), generator=gen)
    frames = torch.randn(2, cfg.encoder_seq, cfg.d_model, generator=gen)
    want, cache = transformer.prefill(
        model, {"tokens": prompt, "frames": frames}, cfg, cache_len=32)
    got, gcache = transformer.prefill(
        gpu, {"tokens": prompt.to(cuda), "frames": frames.to(cuda)}, cfg,
        cache_len=32)
    for i in range(6):
        tol = 2e-4 * (1 + float(want.abs().max()))
        assert float((got.cpu() - want).abs().max()) <= tol, i
        tok = want.argmax(-1)[:, None]
        pos = torch.full((2,), 20 + i, dtype=torch.int32)
        want, cache = transformer.decode_step(model, tok, pos, cache, cfg)
        before = swa_ops.launches
        got, gcache = transformer.decode_step(gpu, tok.to(cuda),
                                              pos.to(cuda), gcache, cfg)
        assert swa_ops.launches == before + 2 * cfg.num_layers


def test_vlm_decode_on_the_card_equals_the_cpu(cuda):
    """Prefill with seeded patch embeddings over a 4 x 4 grid of M-RoPE
    positions, then 6 decode steps, of qwen2-vl-72b's smoke config (f32) on
    the card and on the CPU from the same weights: logits within 2e-4 (1 +
    max|logit|) at each step (fed the CPU's tokens, at text positions);
    each step launches ``swa_decode`` once a layer."""
    import copy
    from repro_torch.models import rope
    cfg = configs.get_smoke("qwen2-vl-72b")
    model = transformer.init_params(cfg, seed=0, device="cpu")
    gpu = copy.deepcopy(model).to(cuda)
    gen = torch.Generator().manual_seed(27)
    prompt = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen)
    batch = {"tokens": prompt,
             "vision_embeds": torch.randn(2, 16, cfg.d_model, generator=gen),
             "positions3": rope.grid_positions3(2, 24, 4, 4)}
    want, cache = transformer.prefill(model, batch, cfg, cache_len=32)
    got, gcache = transformer.prefill(
        gpu, {k: v.to(cuda) for k, v in batch.items()}, cfg, cache_len=32)
    for i in range(6):
        tol = 2e-4 * (1 + float(want.abs().max()))
        assert float((got.cpu() - want).abs().max()) <= tol, i
        tok = want.argmax(-1)[:, None]
        pos = torch.full((2,), 24 + i, dtype=torch.int32)
        want, cache = transformer.decode_step(model, tok, pos, cache, cfg)
        before = swa_ops.launches
        got, gcache = transformer.decode_step(gpu, tok.to(cuda),
                                              pos.to(cuda), gcache, cfg)
        assert swa_ops.launches == before + cfg.num_layers


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_recurrent_train_step_on_the_card_equals_the_cpu(cuda, arch):
    """One train step of each recurrent smoke config (f32) from the same
    weights and batch: loss, ce and grad_norm within 1e-5 relative."""
    import copy
    from repro_torch.training import adamw, train_step
    cfg = configs.get_smoke(arch)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    step = train_step.make_train_step(cfg, opt)
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(4))
    metrics = []
    for device in ("cpu", cuda):
        model = transformer.init_params(cfg, seed=1, device="cpu")
        model = copy.deepcopy(model).to(device).requires_grad_(True)
        state = train_step.TrainState(
            model, adamw.adamw_init(dict(model.named_parameters())),
            torch.zeros((), dtype=torch.int32, device=device))
        batch = {"tokens": toks.to(device), "labels": toks.to(device)}
        metrics.append(step(state, batch)[1])
    for k in ("loss", "ce", "grad_norm"):
        c, g = float(metrics[0][k]), float(metrics[1][k])
        assert abs(g - c) <= 1e-5 * abs(c), (k, c, g)


def test_generate_on_the_card_equals_the_cpu(cuda):
    """A smoke-width greedy generation on CUDA (decode attention on the
    kernel) against the same weights on the CPU (plain version): equal
    tokens unless the CPU's top two logits lie within the tolerance, and
    logits within 2e-4 (1 + max|logit|) while the tokens agree."""
    import copy
    cfg = configs.get_smoke("llama3.2-1b")
    model = transformer.init_params(cfg, seed=0, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(0))
    toks_c, logits_c = serve_step.generate(model, cfg, prompt, 12, 40,
                                           return_logits=True)
    before = swa_ops.launches
    toks_g, logits_g = serve_step.generate(copy.deepcopy(model).to(cuda), cfg,
                                           prompt.to(cuda), 12, 40,
                                           return_logits=True)
    assert swa_ops.launches == before + cfg.num_layers * 11
    tol = 2e-4 * (1 + float(logits_c.abs().max()))
    toks_g, logits_g = toks_g.cpu(), logits_g.cpu()
    for row in range(2):
        differ = (toks_g[row] != toks_c[row]).nonzero()
        upto = int(differ[0]) if len(differ) else 12
        if upto < 12:
            top2 = logits_c[row, upto].topk(2).values
            assert float(top2[0] - top2[1]) <= tol
        err = (logits_g[row, :upto + 1] - logits_c[row, :upto + 1]).abs()
        assert float(err.max()) <= tol


# ----------------------------------------- the async backend's B = 1 shapes


class _HostDraws:
    """Draws made by a seeded CPU generator and moved to ``device``, with
    children of their own: a CPU run and a card run consume the very same
    numbers."""

    def __init__(self, seed, device):
        self.device, self.seed, self.spawned = torch.device(device), seed, 0
        self.gen = torch.Generator().manual_seed(seed)

    def randint(self, low, high, shape):
        return torch.randint(low, high, tuple(shape), generator=self.gen
                             ).to(self.device)

    def uniform(self, shape):
        return torch.rand(tuple(shape), generator=self.gen).to(self.device)

    def exponential(self, shape):
        return -torch.log1p(-self.uniform(shape))

    def spawn(self):
        self.spawned += 1
        return _HostDraws(self.seed * 7919 + self.spawned, self.device)


def test_bmu_kernel_at_b1(cuda):
    """The async path's exact search: one sample against 30x30x784."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    w = torch.rand(900, 784, generator=gen, device=cuda)
    for k in range(8):
        s = torch.rand(1, 784, generator=gen, device=cuda)
        idx, q2 = bmu_ops.bmu(w, s)
        idx_r, q2_r = bmu_ref.bmu_ref(w, s)
        bound = bmu_ref.tie_bound(w, s)
        assert bool(idx == idx_r) or bool(bmu_ref.top2_gap(w, s) <= bound)
        assert bool((q2 - q2_r).abs() <= bound)


@pytest.mark.parametrize("search", ["given", "exact"])
def test_fused_step_parts_at_b1_with_recv0_matches_the_cpu(cuda, search):
    """``fused_step_parts`` as the async fast path calls it (one sample, a
    child's draws, ``recv0``) on the card against the plain version on the
    CPU: counters, receipts (``recv0`` added), size and waves bitwise, the
    GMU equal (given, or the exact search away from a tie), w within
    8 (1 + waves) ulps of max |w|."""
    from repro_torch.core.search import SearchResult
    cfg = AFMConfig(side=30, dim=784)
    w, c, s, _, _ = _fused_inputs(cuda, 30, 784, 1, seed=5)
    recv0 = torch.randint(0, 5, (900,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(2))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        res = None
        if search == "given":
            g = torch.tensor([417], dtype=torch.int32, device=dev)
            res = SearchResult(g, torch.zeros(1, device=dev), g * 0, g * 0)
        before = fused_ops.launches
        outs.append(fused_ops.fused_step_parts(
            w.to(dev), c.reshape(-1).to(dev), s.to(dev), _HostDraws(3, dev),
            cfg, l_c=0.3, p_i=0.9, search_result=res, recv0=recv0.to(dev)))
        assert fused_ops.launches == before + (dev.type == "cuda")
    card, cpu = outs
    assert int(cpu.waves) > 0
    for f in ("c", "gmu", "size", "waves", "recv"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    eps = torch.finfo(torch.float32).eps
    assert float((card.w.cpu() - cpu.w).abs().max()) <= \
        8 * (1 + int(cpu.waves)) * eps * float(cpu.w.abs().max())


def test_drive_cascade_from_one_samples_merge(cuda):
    """The staged fast path's cascade: ``drive_cascade`` fed from a
    one-sample Eq. 3 merge at 30x30x784, bitwise its plain version."""
    from repro_torch.core import afm
    cfg = AFMConfig(side=30, dim=784)
    w, c, s, drive, bern = _fused_inputs(cuda, 30, 784, 1, seed=7)
    c = torch.full_like(c, 3)              # the GMU's drive fires it
    gmu, _ = bmu_ops.bmu(w, s)
    merged, counts = afm.adapt_merge(w, s, gmu, cfg)
    args = (merged, c, counts.to(torch.int32).reshape(30, 30), drive, bern)
    out = cas_ops.drive_cascade(*args, l_c=0.3, theta=4, budget=16)
    ref = cas_ref.drive_cascade_ref(*args, l_c=0.3, theta=4, budget=16)
    assert int(ref[3][1]) > 0
    for a, r in zip(out, ref):
        assert _same_bits(a, r) if a.is_floating_point() else torch.equal(a, r)


def test_spawn_makes_no_host_sync(cuda):
    """A child source is seeded on the host: spawning one and drawing from
    it never waits for the card."""
    from repro_torch.draws import GeneratorDraws
    draws = GeneratorDraws(0, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            child = draws.spawn()
            child.uniform((8, 30, 30))
            child.uniform((16, 4, 30, 30))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    a, b = GeneratorDraws(0, cuda), GeneratorDraws(0, cuda)
    assert torch.equal(a.spawn().uniform((5,)), b.spawn().uniform((5,)))


ASYNC_CASES = {"staged": {}, "fused": dict(kernel="fused"),
               "event": dict(engine="event"),
               "constant": dict(latency="constant", delay=1.0),
               "exponential": dict(latency="exponential", delay=1.5)}


@pytest.mark.parametrize("name", sorted(ASYNC_CASES))
def test_run_events_on_the_card_equals_the_cpu(cuda, name):
    """A small run (8x8, D 16, 64 events, exact search, a hot schedule) on
    the card and on the CPU from the same host draws: integers, the report
    and the clocks bitwise, w within 64 ulps of max |w| (the fused kernel's
    merge rounds apart from the plain one's)."""
    from repro_torch.convert import state_to_numpy, state_from_numpy
    from repro_torch.core import afm
    from repro_torch.core import events
    cfg = AFMConfig(side=8, dim=16, theta=3, i_max=96, e_factor=0.5)
    gen = torch.Generator().manual_seed(4)
    data = torch.randn(64, 16, generator=gen)
    base = afm.init(_HostDraws(1, "cpu"), cfg, data)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        outs.append(events.run_events(
            state_from_numpy(state_to_numpy(base), dev), data.to(dev),
            _HostDraws(2, dev), cfg, events.EventConfig(**ASYNC_CASES[name]),
            search=events.search_exact, p_fn=lambda i, c: 0.8,
            lat_draws=_HostDraws(3, dev)))
    (sg, ag, rg), (sc, ac, rc) = outs
    assert rc.deliveries > 0
    assert torch.equal(sg.c.cpu(), sc.c)
    for a, r in zip(ag, ac):
        if a.is_floating_point():
            assert float((a.cpu() - r).abs().max()) <= 1e-4 * float(
                r.abs().max())
        else:
            assert torch.equal(a.cpu(), r)
    for f in rc._fields:
        a, r = getattr(rg, f), getattr(rc, f)
        assert torch.equal(a.cpu(), r) if torch.is_tensor(a) else a == r, f
    eps = torch.finfo(torch.float32).eps
    assert float((sg.w.cpu() - sc.w).abs().max()) <= \
        64 * eps * float(sc.w.abs().max())


FAULT_CASES = {
    "loss": dict(latency="constant", delay=1.0,
                 faults=dict(seed=11, p_loss=0.3)),
    "dropout": dict(latency="constant", delay=1.0,
                    faults=dict(seed=11, dropout_frac=0.25,
                                dropout_start=10.0, dropout_len=30.0)),
    "both-exponential": dict(latency="exponential", delay=1.5,
                             faults=dict(seed=11, p_loss=0.3,
                                         dropout_frac=0.25,
                                         dropout_start=10.0,
                                         dropout_len=30.0)),
    "zero-pool": dict(faults=dict(seed=11, p_loss=0.3,
                                  pool_reserve=8 * 64 - 8)),   # 8 slots
}


def _faulty_run(dev, name, base, data, cfg, fault_seed=5):
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import events
    from repro_torch.faults import FaultPlan
    opts = dict(FAULT_CASES[name])
    plan = FaultPlan(**opts.pop("faults"))
    return events.run_events(
        state_from_numpy(base, dev), data.to(dev), _HostDraws(2, dev), cfg,
        events.EventConfig(faults=plan, **opts), search=events.search_exact,
        p_fn=lambda i, c: 0.8, lat_draws=_HostDraws(3, dev),
        fault_draws=_HostDraws(fault_seed, dev))


def _conserved(rep):
    return rep.sent == (rep.deliveries + rep.dropped_overflow
                        + rep.dropped_fault + rep.stranded)


@pytest.mark.parametrize("name", sorted(FAULT_CASES))
def test_faulty_engine_on_the_card_equals_the_cpu(cuda, name):
    """The faulty engine (8x8, D 16, 64 events, exact search on the
    ``bmu`` kernel) on the card and on the CPU from the same host draws,
    fault draws included: integers, the report and the fault counts
    bitwise, w within 64 ulps of max |w|; every message accounted for."""
    from repro_torch.convert import state_to_numpy
    from repro_torch.core import afm
    cfg = AFMConfig(side=8, dim=16, theta=3, i_max=96, e_factor=0.5)
    data = torch.randn(64, 16, generator=torch.Generator().manual_seed(4))
    base = state_to_numpy(afm.init(_HostDraws(1, "cpu"), cfg, data))
    launches = bmu_ops.launches
    (sg, ag, rg), (sc, ac, rc) = (_faulty_run(dev, name, base, data, cfg)
                                  for dev in (cuda, torch.device("cpu")))
    assert bmu_ops.launches - launches == 64        # the search, a sample
    assert rc.deliveries > 0 and _conserved(rc)
    assert rc.dropped_fault > 0 or rc.dropped_overflow > 0
    assert torch.equal(sg.c.cpu(), sc.c)
    for a, r in zip(ag, ac):
        if a.is_floating_point():
            assert float((a.cpu() - r).abs().max()) <= 1e-4 * float(
                r.abs().max())
        else:
            assert torch.equal(a.cpu(), r)
    for f in rc._fields:
        a, r = getattr(rg, f), getattr(rc, f)
        assert torch.equal(a.cpu(), r) if torch.is_tensor(a) else a == r, f
    eps = torch.finfo(torch.float32).eps
    assert float((sg.w.cpu() - sc.w).abs().max()) <= \
        64 * eps * float(sc.w.abs().max())


def test_dead_units_stay_frozen_on_the_card(cuda):
    """A whole-run dropout window at 30x30x784: the dead units keep their
    initial weights bitwise, the live ones train, samples routed to dead
    units are counted, and every message is accounted for."""
    from repro_torch.core import afm
    from repro_torch.core import events
    from repro_torch.draws import GeneratorDraws
    from repro_torch.faults import FaultPlan
    cfg = AFMConfig(side=30, dim=784)
    gen = torch.Generator(device=cuda).manual_seed(0)
    # 16 tight clusters, so that GMUs repeat and cascades run
    centers = torch.rand(16, 784, generator=gen, device=cuda)
    data = centers[torch.arange(400, device=cuda) % 16] + 0.01 * torch.rand(
        400, 784, generator=gen, device=cuda)
    state = afm.init(GeneratorDraws(0, cuda), cfg, data)
    plan = FaultPlan(seed=11, dropout_frac=0.25, dropout_len=1e9)
    out, _, rep = events.run_events(
        state, data, GeneratorDraws(1, cuda), cfg,
        events.EventConfig(latency="constant", delay=1.0, faults=plan),
        search=events.search_exact, p_fn=lambda i, c: 0.8)
    dead = plan.dead_units(cfg.n_units).to(cuda)
    assert torch.equal(out.w[dead], state.w[dead])
    assert not torch.equal(out.w[~dead], state.w[~dead])
    assert rep.samples_dead > 0 and rep.dropped_fault > 0 and \
        _conserved(rep)


def test_stream_kill_and_resume_on_the_card_is_bitwise(cuda, tmp_path):
    """``run_stream`` on the card (async, zero latency, exact search, the
    fused kernel): SIGTERM at half the events, then ``resume``, ends on the
    uninterrupted run's published map bitwise."""
    from repro_torch.api import MapStore
    from repro_torch.launch.stream_train import run_stream
    cfg = AFMConfig(side=8, dim=16, i_max=256)
    gen = torch.Generator().manual_seed(0)
    xtr, xte = torch.randn(300, 16, generator=gen), torch.randn(
        32, 16, generator=gen)
    common = dict(backend="async", events=256, chunk=32, swap_every=64,
                  clients=1, client_batch=4, name="m", seed=3, device=cuda,
                  backend_options={"search": "exact", "kernel": "fused"})
    launches = fused_ops.launches
    run_stream(cfg, xtr, xte, store_root=str(tmp_path / "a"), **common)
    assert fused_ops.launches - launches == 256     # one an event
    ck = str(tmp_path / "ck")
    cut = run_stream(cfg, xtr, xte, store_root=str(tmp_path / "b"),
                     checkpoint_dir=ck, die_after=128, **common)
    assert cut.interrupted and cut.events == 128
    rep = run_stream(cfg, xtr, xte, store_root=str(tmp_path / "b"),
                     checkpoint_dir=ck, resume=True, **common)
    assert rep.client_errors == [] and rep.qe_finite
    arts = [MapStore(str(tmp_path / r)).load_artifact("m", device="cpu")
            for r in "ab"]
    assert arts[0].state.i == arts[1].state.i == 256
    assert torch.equal(arts[0].state.w, arts[1].state.w)


# ------------------------------------------------ the map-serving engine


def _served_map(cuda, side=30, d=784, seed=0):
    from repro_torch.core import afm
    from repro_torch.draws import GeneratorDraws
    cfg = AFMConfig(side=side, dim=d, batch=16)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    data = torch.rand(512, d, generator=gen, device=cuda)
    return cfg, afm.init(GeneratorDraws(seed, cuda), cfg, data), data


def _assert_bmu(idx, q2, w, s):
    idx_r, q2_r = bmu_ref.bmu_ref(w, s)
    bound = bmu_ref.tie_bound(w, s)
    differ = idx != idx_r
    assert bool((bmu_ref.top2_gap(w, s)[differ] <= bound[differ]).all())
    assert bool(((q2 - q2_r).abs() <= bound).all())


def test_engines_share_one_signature_per_bucket(cuda):
    """Four engines on one cache record each bucket once; each chunk is one
    ``bmu`` launch on exactly its rows, and its answer is the kernel's."""
    from repro_torch.serving import BmuEngine, CompileCache
    cfg, state, data = _served_map(cuda)
    cache = CompileCache()
    engines = [BmuEngine(cache=cache) for _ in range(4)]
    before = bmu_ops.launches
    for engine in engines:
        for n in (1, 8, 40, 64, 100, 5000):
            s = data.repeat(10, 1)[:n]
            idx, q2 = engine.bmu(state.w, s)
            _assert_bmu(idx, q2, state.w, s)
    assert cache.trace_count == 4        # buckets 8, 64, 512, 4096
    assert engines[0].trace_count == 4
    assert all(e.trace_count == 0 for e in engines[1:])
    # 5,000 = 4,096 + 904: seven chunks an engine
    assert bmu_ops.launches - before == sum(cache.dispatches.values()) \
        == 4 * 7


def test_swap_then_serve_returns_the_new_weights_bmus(cuda):
    """The engine reads the served weights at each dispatch: after a swap
    the same request gets the new map's units, with no new signature."""
    from repro_torch.serving import MapService
    cfg, state, data = _served_map(cuda)
    svc = MapService(cfg, state, device=cuda)
    s = data[:37]
    before = svc.transform(s)
    compiles = svc.engine.cache.trace_count
    flipped = state._replace(w=torch.flip(state.w, [0]).contiguous())
    svc.swap(flipped)
    after = svc.transform(s)
    assert svc.engine.cache.trace_count == compiles
    assert torch.equal(after, cfg.n_units - 1 - before)
    idx, q2, _ = svc.serve_bmu(s)
    _assert_bmu(idx, q2, flipped.w, s)
    # identical requests are bitwise identical
    idx2, q22, _ = svc.serve_bmu(s)
    assert torch.equal(idx, idx2) and torch.equal(q2, q22)


def test_threads_serve_mixed_sizes_from_a_cold_cache(cuda):
    """Eight threads, each its own engine on one cold cache: signatures are
    recorded while other threads dispatch, and every answer is the
    kernel's."""
    import threading
    from repro_torch.serving import BmuEngine, CompileCache
    cfg, state, data = _served_map(cuda)
    big = data.repeat(10, 1)
    cache = CompileCache()
    sizes = [1, 7, 64, 300, 5000, 3, 512, 4096]
    failures = []

    def client(k):
        engine = BmuEngine(cache=cache)
        try:
            for j in range(len(sizes)):
                n = sizes[(j + k) % len(sizes)]
                s = big[k:k + n]
                idx, q2 = engine.bmu(state.w, s)
                torch.cuda.current_stream().synchronize()
                _assert_bmu(idx, q2, state.w, s)
        except BaseException as e:  # noqa: BLE001 — reported below
            failures.append(e)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not failures, failures[:1]
    assert cache.trace_count == 4


def test_update_on_the_kernel_backend_equals_partial_fit(cuda):
    from repro_torch.serving import MapService
    cfg, state, data = _served_map(cuda)
    svc = MapService(cfg, state, update_backend="kernel", seed=3,
                     device=cuda)
    svc.transform(data)                  # record the bucket of 512
    compiles = svc.engine.cache.trace_count
    mirror = TopoMap.from_state(state, cfg, backend="kernel", seed=3,
                                device=cuda)
    for k in range(4):
        batch = data[16 * k:16 * (k + 1)]
        aux = svc.update(batch)
        mirror.partial_fit(batch)
        got, _ = svc.snapshot()
        for f in ("gmu", "cascade_size", "waves"):
            assert torch.equal(getattr(aux, f), getattr(mirror.fit_aux_, f))
        assert torch.equal(got.c, mirror.state_.c) and got.i == mirror.state_.i
        assert torch.equal(got.w.view(torch.int32),
                           mirror.state_.w.view(torch.int32))
    assert torch.equal(svc.transform(data), mirror.transform(data))
    assert svc.engine.cache.trace_count == compiles


# ------------------------------------------- meshes of ranks on one card


def test_gloo_gathers_cuda_tensors_bitwise(cuda):
    """Two gloo ranks on the card: ``all_gather`` of a CUDA tensor (an
    all_reduce of one slot a rank) returns every rank's bits on the card."""
    ranks = spawn_ranks(torch_ranks.cuda_collectives, 2, timeout=300.0)
    want = torch.tensor([[-0.0, float("nan"), 1e-45, 0.0],
                         [-0.0, float("nan"), 1e-45, 1.0]]).view(torch.int32)
    for r in ranks:
        assert r["device"].startswith("cuda")
        np.testing.assert_array_equal(r["bits"], want.numpy())
        np.testing.assert_array_equal(r["psum"], [4.0])


@pytest.mark.parametrize("latency", ["constant", "exponential"])
def test_mesh_on_the_card_equals_the_cpu(cuda, latency):
    """The mesh engine on 2 ranks on the card and on the CPU, same host
    draws: integers and clocks bitwise, w within 64 ulps of max |w|."""
    for card, cpu in spawn_ranks(torch_ranks.mesh_card_and_cpu, 2,
                                 (latency,), timeout=300.0):
        for f in ("c", "gmu", "sizes", "clock"):
            np.testing.assert_array_equal(card[f], cpu[f], err_msg=f)
        assert card["rows"] == cpu["rows"]
        assert card["rounds"] == cpu["rounds"] and cpu["deliveries"] > 0
        eps = np.finfo(np.float32).eps
        assert np.abs(card["w"] - cpu["w"]).max() <= 64 * eps * np.abs(
            cpu["w"]).max()


def test_sharded_step_on_the_card_equals_the_cpu(cuda):
    for card, cpu in spawn_ranks(torch_ranks.sharded_card_and_cpu, 2,
                                 timeout=300.0):
        np.testing.assert_array_equal(card["c"], cpu["c"])
        assert (card["size"], card["waves"]) == (cpu["size"], cpu["waves"])
        eps = np.finfo(np.float32).eps
        assert np.abs(card["w"] - cpu["w"]).max() <= 64 * eps * np.abs(
            cpu["w"]).max()


def _som_on_card(cuda, side=30, dim=784, batch=16, n=2000, seed=0):
    from repro_torch.core import som
    from repro_torch.draws import GeneratorDraws
    # the data's stream apart from the draw source's (seeded alike, the
    # initial units would be the first samples)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    data = torch.rand(n, dim, generator=gen, device=cuda)
    cfg = som.SOMConfig(side=side, dim=dim, batch=batch, i_max=500 * batch)
    draws = GeneratorDraws(seed, cuda)
    return cfg, som.init(draws, cfg, data, device=cuda), data, draws


@pytest.mark.parametrize("batch", [1, 16])
def test_som_step_on_the_card_matches_the_plain_step(cuda, batch):
    """Each of 30 steps from the kernel path's state: the ``bmu`` kernel's
    BMUs within the tie bound of ``bmu_ref``'s on the same card, and the
    weights bitwise the plain step's wherever the BMUs agree."""
    from repro_torch.core import som
    cfg, state, data, _ = _som_on_card(cuda, batch=batch)
    before, agreed = bmu_ops.launches, 0
    for k in range(30):
        s = data[batch * k:batch * (k + 1)].contiguous()
        idx, q2 = bmu_ops.bmu(state.w, s)
        idx_r, q2_r = bmu_ref.bmu_ref(state.w, s)
        _assert_bmu(idx, q2, state.w, s)
        new = som.train_step(state, s, cfg)
        plain = som.update(state, s, idx_r, cfg)
        assert new.i == plain.i == state.i + batch
        if torch.equal(idx, idx_r):
            assert torch.equal(new.w.view(torch.int32),
                               plain.w.view(torch.int32))
            agreed += 1
        state = new
    assert agreed >= 28
    assert bmu_ops.launches - before == 60    # one a search, one a step


def test_som_train_on_the_card_makes_no_host_sync(cuda):
    """100 steps of ``som.train`` after a first one: one ``bmu`` launch a
    step and no read back to the host; the QE of the data falls."""
    from repro_torch.core import som
    cfg, state, data, draws = _som_on_card(cuda)
    qe0 = float(som.quantization_error(state, data))
    state = som.train(state, data, draws, cfg, num_steps=1)   # warm
    before = bmu_ops.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = som.train(state, data, draws, cfg, num_steps=100)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bmu_ops.launches - before == 100
    assert state.w.device.type == "cuda" and state.i == 1616
    assert float(som.quantization_error(state, data)) < qe0


def test_trace_guard_bounds_the_engines_signatures_on_the_card(cuda):
    """``repro_torch.analysis.runtime.TraceGuard`` on the serving engine:
    a new bucket is one signature, a repeated one none, and every chunk one
    ``bmu`` launch."""
    from repro_torch.analysis.runtime import TraceGuard
    from repro_torch.serving import BmuEngine, CompileCache
    cfg, state, data = _served_map(cuda)
    cache = CompileCache()
    engine = BmuEngine(cache=cache)
    before = bmu_ops.launches
    with TraceGuard(engine, expect=2):             # buckets 8 and 64
        engine.bmu(state.w, data[:5].contiguous())
        engine.bmu(state.w, data[:40].contiguous())
    assert cache.trace_count == 2
    with TraceGuard(engine, cache):                # no new signature
        for n in (1, 8, 33, 64):
            idx, q2 = engine.bmu(state.w, data[:n].contiguous())
            _assert_bmu(idx, q2, state.w, data[:n])
    assert bmu_ops.launches - before == 6


# ---------------------------------------------------------------------------
# LM training with the AFM probe


def _probe_draws(seed, side, waves=64, cap=cas_ops.DEFAULT_WAVE_CAP):
    """One step's cascade draws as numbers, laid out for both stage sets:
    the plain stages' (the drive, one ``(4, side, side)`` a wave) and the
    kernel stages' (the drive, the first ``cap`` waves as one block, one a
    later wave). ``waves`` outlasts any cascade here."""
    rng = np.random.default_rng(seed)
    drive = rng.random((8, side, side), dtype=np.float32)
    per_wave = [rng.random((4, side, side), dtype=np.float32)
                for _ in range(waves)]
    return [drive, *per_wave], [drive, np.stack(per_wave[:cap]),
                                *per_wave[cap:]]


def _state_to(state, dev):
    """A copy of a train state on ``dev``: weights, moments, probe map."""
    import copy
    from repro_torch.core import probe
    from repro_torch.training import adamw
    model = copy.deepcopy(state.params).to(dev)
    opt = adamw.AdamWState({k: v.to(dev) for k, v in state.opt.mu.items()},
                           {k: v.to(dev) for k, v in state.opt.nu.items()},
                           state.opt.step.to(dev))
    a = state.probe.afm
    return type(state)(model, opt, state.step.to(dev), probe.ProbeState(
        a._replace(w=a.w.to(dev), c=a.c.to(dev), far=a.far.to(dev),
                   near=a.near.to(dev))))


def test_train_step_on_the_card_equals_the_cpu(cuda):
    """Three smoke-width train steps with the probe (side 6), each from the
    CPU run's state copied to the card, on the same batch and the same draw
    numbers: loss, ce, lr and grad_norm within 1e-5 relative; the probe's
    GMUs within the tie bound, and where they agree its counters and
    cascade size bitwise and its weights within the vectors' difference."""
    from repro_torch.core import probe
    from repro_torch.data import tokens
    from repro_torch.draws import ReplayDraws
    from repro_torch.training import AdamWConfig, train_step
    cfg = configs.get_smoke("llama3.2-1b")
    pcfg = probe.ProbeConfig(side=6, dim=cfg.d_model, i_max=400, c_m=1.0)
    step = train_step.make_train_step(
        cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3), pcfg)
    state = train_step.init_train_state(cfg, pcfg, seed=0, device="cpu")
    a = state.probe.afm                 # counters one below threshold
    state = state._replace(probe=probe.ProbeState(
        a._replace(c=torch.full_like(a.c, pcfg.theta - 1))))
    data = tokens.batches(torch.Generator().manual_seed(1), cfg.vocab_size,
                          2, 32, 3, device="cpu")
    fired = 0
    for k, batch in enumerate(data):
        card = _state_to(state, cuda)
        cpu_draws, card_draws = _probe_draws(k, pcfg.side)
        with torch.no_grad():
            vecs = {dev: probe.pool_hidden(train_step.lm_loss(
                s.params, {n: v.to(dev) for n, v in batch.items()}, cfg,
                return_hidden=True)[3].float())
                for dev, s in (("cpu", state), (cuda, card))}
        w0 = state.probe.afm.w
        gmu_cpu, _ = bmu_ref.bmu_ref(w0, vecs["cpu"])
        gmu_card, _ = bmu_ops.bmu(card.probe.afm.w, vecs[cuda])
        state, m = step(state, batch, ReplayDraws(cpu_draws))
        card, mc = step(card, {n: v.to(cuda) for n, v in batch.items()},
                        ReplayDraws(card_draws, device=cuda))
        for key in ("loss", "ce", "lr", "grad_norm"):
            want = float(m[key])
            assert abs(float(mc[key]) - want) <= 1e-5 * abs(want), key
        differ = (gmu_card.cpu() != gmu_cpu).numpy()
        if differ.any():
            gap = bmu_ref.top2_gap(w0, vecs["cpu"]).numpy()
            bound = bmu_ref.tie_bound(w0, vecs["cpu"]).numpy()
            vec_err = float((vecs[cuda].cpu() - vecs["cpu"]).abs().max())
            assert np.all(gap[differ] <= bound[differ] + 4 * vec_err)
            continue
        assert int(mc["probe_cascade"]) == int(m["probe_cascade"])
        assert torch.equal(card.probe.afm.c.cpu(), state.probe.afm.c)
        vec_err = float((vecs[cuda].cpu() - vecs["cpu"]).abs().max())
        dw = float((card.probe.afm.w.cpu() - state.probe.afm.w).abs().max())
        assert dw <= vec_err + 64 * 1.2e-7 * float(state.probe.afm.w.abs()
                                                   .max())
        fired += int(m["probe_cascade"]) > 0
    assert fired > 0


def test_probe_kernel_stages_match_the_plain_stages(cuda):
    """The probe's step at the full-width probe shape (side 8, D = 2048,
    B = 4) on its kernel stages (``bmu``, the merge, ``drive_cascade``)
    against the plain stages on the same card, on the same draw numbers,
    from counters one below threshold: GMUs within the tie bound; where
    they agree, counters, cascade size and waves bitwise and the weights
    within 8 ulp an adaptation; one ``bmu`` call and one ``drive_cascade``
    launch."""
    from repro_torch.core import afm, probe
    from repro_torch.draws import GeneratorDraws, ReplayDraws
    pcfg = probe.ProbeConfig(side=8, dim=2048, i_max=120, c_m=1.0)
    cfg = pcfg.afm_config()
    fired = 0
    for seed in range(3):
        st = probe.init(GeneratorDraws(seed, cuda), pcfg, device=cuda).afm
        st = st._replace(c=torch.full_like(st.c, pcfg.theta - 1), i=8)
        vecs = torch.randn(4, 2048, generator=torch.Generator(
            device=cuda).manual_seed(seed + 100), device=cuda)
        plain, kernel = _probe_draws(seed, 8)
        b0, d0 = bmu_ops.launches, cas_ops.drive_launches
        new_k, aux_k = probe.update(probe.ProbeState(st), vecs,
                                    ReplayDraws(kernel, device=cuda), pcfg)
        assert (bmu_ops.launches - b0, cas_ops.drive_launches - d0) == (1, 1)
        new_p, aux_p = afm.train_step_batch(st, vecs,
                                            ReplayDraws(plain, device=cuda),
                                            cfg, stages=afm.EXACT_STAGES)
        if not torch.equal(aux_k.gmu, aux_p.gmu):
            _assert_bmu(aux_k.gmu, aux_k.q2, st.w, vecs)
            continue
        assert (int(aux_k.cascade_size), int(aux_k.waves)) == (
            int(aux_p.cascade_size), int(aux_p.waves))
        assert torch.equal(new_k.afm.c, new_p.c)
        waves = int(aux_p.waves)
        bound = 8 * (1 + waves) * 1.2e-7 * float(new_p.w.abs().max())
        assert float((new_k.afm.w - new_p.w).abs().max()) <= bound
        fired += waves > 0
    assert fired > 0


def test_bf16_weights_checkpoint_round_trips_from_the_card(cuda, tmp_path):
    """A bf16 model on the card: its ``lm_params_tree`` saved and restored
    into a tree of CUDA tensors, every leaf bitwise."""
    import dataclasses
    from repro_torch import convert
    from repro_torch.training import checkpoint
    cfg = dataclasses.replace(configs.get_smoke("llama3.2-1b"),
                              dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16)
    model = transformer.init_params(cfg, seed=3, device=cuda)
    tree = convert.lm_params_tree(model)
    path = str(tmp_path / "w.msgpack")
    checkpoint.save(path, tree)
    like = {k: v for k, v in tree.items() if k != "blocks"}
    like = {**{k: torch.zeros_like(v, device=cuda) for k, v in like.items()},
            "blocks": {k: ({kk: torch.zeros_like(vv, device=cuda)
                            for kk, vv in v.items()} if isinstance(v, dict)
                           else torch.zeros_like(v, device=cuda))
                       for k, v in tree["blocks"].items()}}
    back = checkpoint.restore(path, like)
    assert back["embed"].device.type == "cuda"
    assert back["embed"].dtype == torch.bfloat16
    assert torch.equal(back["embed"].view(torch.int16),
                       model.embed.detach().view(torch.int16))
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] != "blocks":
            continue
        node = back["blocks"]
        for part in parts[2:]:
            node = node[part]
        assert torch.equal(node[int(parts[1])].view(torch.int16),
                           p.detach().view(torch.int16)), name


# ------------------------------------------------------------ the MoE family

MOE_ARCHS = ["granite-moe-1b-a400m", "deepseek-moe-16b"]


@pytest.mark.parametrize("impl", ["dense", "ragged", "ep"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_on_the_card_equals_the_cpu(cuda, arch, impl):
    """``moe`` at the f32 smoke width on the card and on the CPU from the
    same weights and tokens: the output within 1e-5 of its largest value
    and the router's aux within 1e-5 relative (the matrix products sum in
    another order on the card)."""
    import copy
    import dataclasses
    from repro_torch.models import mlp
    cfg = dataclasses.replace(configs.get_smoke(arch), moe_impl=impl)
    p = transformer.init_params(cfg, seed=0, device="cpu").blocks[0].moe
    x = torch.randn(2, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    y, aux = mlp.moe(p, x, cfg)
    yg, auxg = mlp.moe(copy.deepcopy(p).to(cuda), x.to(cuda), cfg)
    assert float((yg.cpu() - y).abs().max()) <= 1e-5 * float(y.abs().max())
    assert abs(float(auxg) - float(aux)) <= 1e-5 * abs(float(aux))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_step_on_the_card_equals_the_cpu(cuda, arch):
    """One decode step of each MoE smoke config (hd 32: the swa kernel's
    smallest head dim) from the same prefilled cache: logits within 2e-4
    (1 + max|logit|), one ``swa_decode`` launch a layer."""
    import copy
    cfg = configs.get_smoke(arch)
    model = transformer.init_params(cfg, seed=0, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(2))
    _, cache = transformer.prefill(model, {"tokens": prompt}, cfg,
                                   cache_len=16)
    tok = prompt[:, -1:]
    pos = torch.full((2,), 12, dtype=torch.int32)
    gcache = {name: {kv: c.to(cuda) for kv, c in stack.items()}
              for name, stack in cache.items()}
    want, _ = transformer.decode_step(model, tok, pos, cache, cfg)
    before = swa_ops.launches
    got, _ = transformer.decode_step(copy.deepcopy(model).to(cuda),
                                     tok.to(cuda), pos.to(cuda), gcache, cfg)
    assert swa_ops.launches == before + cfg.num_layers
    tol = 2e-4 * (1 + float(want.abs().max()))
    assert float((got.cpu() - want).abs().max()) <= tol


def test_span_reading_of_a_traced_moe_train_step(cuda):
    """A smoke MoE train step (ragged, remat, the 8x8 probe) profiled as the
    benchmark profiles, under ``set_sync_debug_mode("warn")``: the spans'
    self times add up to the device time, every layer's forward and
    backward holds some, the syncs in spans are the warnings' count, and
    no kernel launched while a ``moe.backward`` was open is left in
    ``train_step``."""
    import dataclasses
    import sys
    import warnings
    from pathlib import Path

    from repro_torch.core import probe
    from repro_torch.data import tokens
    from repro_torch.draws import GeneratorDraws
    from repro_torch.training import AdamWConfig, train_step
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from gpubench import spans as span_reading
    from gpubench import trace
    cfg = dataclasses.replace(configs.get_smoke("granite-moe-1b-a400m"),
                              moe_impl="ragged", remat=True)
    pcfg = probe.ProbeConfig(side=8, dim=cfg.d_model, i_max=1000)
    step = train_step.make_train_step(
        cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10), pcfg)
    state = train_step.init_train_state(cfg, pcfg, seed=0, device=cuda)
    batches = list(tokens.batches(torch.Generator().manual_seed(1),
                                  cfg.vocab_size, 4, 64, 2, device=cuda))
    state, _ = step(state, batches[0], GeneratorDraws.for_step(0, 0, cuda))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step(state, batches[1], GeneratorDraws.for_step(0, 1, cuda))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    warned = sum("synchronizing CUDA operation" in str(w.message)
                 for w in caught)
    events = prof.profiler.kineto_results.events()
    summary = trace.summarise(events, 1.0)
    read = span_reading.read(events)
    device = sum(sec for sec, _ in summary.by_name.values())
    assert sum(read.span_s.values()) == pytest.approx(device, rel=1e-9)
    for name in ("train_step", "attention", "attention.backward", "moe",
                 "moe.backward", "lm_head", "lm_head.backward",
                 "cross_entropy", "cross_entropy.backward", "optimizer",
                 "probe"):
        assert read.span_s.get(name, 0.0) > 0, name
    assert sum(read.span_syncs.values()) == warned >= 1
    found = sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                    e.name().removeprefix(span_reading.PREFIX))
                   for e in events
                   if e.device_type() == torch.autograd.DeviceType.CPU
                   and e.name().startswith(span_reading.PREFIX))
    t0 = min(e.start_ns() for e in events)
    t1 = max(e.start_ns() + e.duration_ns() for e in events)
    starts, ends, names = span_reading._pieces(found, t0, t1)
    backward = [(a, b) for a, b, n in found if n == "moe.backward"]
    launched = [e.start_ns() for e in events
                if e.name() in trace.LAUNCHES
                and any(a <= e.start_ns() < b for a, b in backward)]
    assert launched
    for t in launched:
        k = max(i for i, s in enumerate(starts) if s <= t)
        assert names[k] in ("moe.backward", "attention", "moe"), names[k]
