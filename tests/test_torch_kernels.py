"""The port's kernel wrappers against the JAX package's kernels, on the CPU.

On CPU tensors each wrapper runs its plain PyTorch version; the JAX side
runs the real Pallas kernel body in interpret mode (as ``tests/test_kernels.py``
does) for a few shapes and its jnp oracle for the rest. Tiers:

- ``bmu``: ULP-bounded q2 (relative to |s|^2 + |w|^2) and equal indices
  except within that bound of a tie; planted exact ties go to the lower
  index on both sides. bf16 tier: the same, since both round the inputs to
  bf16 and accumulate in f32.
- ``cascade_wave``: bitwise (all integer).

The CUDA kernels themselves run only on the card: ``tests/test_torch_gpu.py``
skips here, and ``chip_smoke.py`` holds each kernel against its plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.kernels.bmu import ops as jbmu_ops
from repro.kernels.cascade import ops as jcas_ops
from repro_torch.kernels.bmu import ops as bmu_ops
from repro_torch.kernels.bmu import ref as bmu_ref
from repro_torch.kernels.cascade import ops as cas_ops
from torch_parity import assert_bmu_tier, t

# (n, b, d, interpret): ragged shapes; interpret runs the Pallas kernel body
BMU_SHAPES = [(37, 5, 13, True), (64, 16, 36, False), (130, 33, 8, True),
              (9, 1, 20, False), (200, 70, 31, False)]


def _bmu_inputs(n, b, d, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, d)).astype(np.float32)
    s = rng.standard_normal((b, d)).astype(np.float32)
    return w, s


@pytest.mark.parametrize("precision", ["exact", "bf16"])
@pytest.mark.parametrize("n,b,d,interpret", BMU_SHAPES)
def test_bmu_matches_jax(n, b, d, interpret, precision):
    w, s = _bmu_inputs(n, b, d, seed=n * 31 + b)
    if interpret:
        ij, qj = jbmu_ops.bmu(jnp.asarray(w), jnp.asarray(s), use_pallas=True,
                              interpret=True, precision=precision)
    else:
        ij, qj = jbmu_ops.bmu(jnp.asarray(w), jnp.asarray(s), use_pallas=False,
                              precision=precision)
    it, qt = bmu_ops.bmu(t(w), t(s), precision=precision)
    assert it.dtype == torch.int32 and qt.dtype == torch.float32
    assert it.shape == (b,) and qt.shape == (b,)
    assert_bmu_tier(it, qt, ij, qj, w, s)


@pytest.mark.parametrize("precision", ["exact", "bf16"])
def test_bmu_planted_ties_take_lowest_index(precision):
    """Duplicated unit rows give bitwise-equal distances; both packages must
    return the lower of the two indices."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((37, 13)).astype(np.float32)
    pairs = rng.choice(37, (6, 2), replace=False)
    lo, hi = pairs.min(axis=1), pairs.max(axis=1)
    w[hi] = w[lo]
    s = w[hi] + np.float32(1e-3) * rng.standard_normal((6, 13)).astype(
        np.float32)
    ij, _ = jbmu_ops.bmu(jnp.asarray(w), jnp.asarray(s), use_pallas=False,
                         precision=precision)
    it, _ = bmu_ops.bmu(t(w), t(s), precision=precision)
    np.testing.assert_array_equal(np.asarray(ij), lo)
    np.testing.assert_array_equal(it.numpy(), lo)


def test_bmu_bf16_tier_polishes_q2_exactly():
    """The bf16 tier ranks with bf16 products, but its q2 is the exact-f32
    distance to the unit it picked."""
    w, s = _bmu_inputs(90, 40, 784, seed=3)
    idx, q2 = bmu_ops.bmu(t(w), t(s), precision="bf16")
    d = w[idx.numpy()] - s
    np.testing.assert_allclose(q2.numpy(), (d * d).sum(-1), rtol=1e-5)
    ie, _ = bmu_ops.bmu(t(w), t(s))
    assert (idx == ie).float().mean() >= 0.95


def test_bmu_wrapper_validates():
    w, s = _bmu_inputs(8, 3, 4, seed=0)
    with pytest.raises(ValueError, match="precision"):
        bmu_ops.bmu(t(w), t(s), precision="fp8")
    with pytest.raises(ValueError, match="float32"):
        bmu_ops.bmu(t(w).double(), t(s))
    with pytest.raises(ValueError, match=r"\(N, D\)"):
        bmu_ops.bmu(t(w), t(s)[:, :3])
    idx, q2 = bmu_ops.bmu(t(w), t(s)[:0])
    assert idx.shape == (0,) and q2.shape == (0,)


def _wave_inputs(side, theta, p, seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, theta + 2, (side, side)).astype(np.int32)
    fired = rng.random((side, side)) < 0.25
    bern = rng.random((4, side, side)) < p
    return c, fired, bern


@pytest.mark.parametrize("side,theta,p,interpret", [
    (7, 4, 0.7, True), (30, 4, 0.9, True), (5, 2, 1.0, False),
    (12, 6, 0.3, False), (1, 4, 0.5, False)])
def test_cascade_wave_matches_jax_bitwise(side, theta, p, interpret):
    c, fired, bern = _wave_inputs(side, theta, p, seed=side + theta)
    jout = jcas_ops.cascade_wave(jnp.asarray(c), jnp.asarray(fired),
                                 jnp.asarray(bern), theta,
                                 use_pallas=interpret, interpret=interpret)
    tout = cas_ops.cascade_wave(t(c), t(fired), t(bern), theta)
    assert [x.dtype for x in tout] == [torch.int32, torch.bool, torch.int32]
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_cascade_wave_wrapper_validates():
    c, fired, bern = _wave_inputs(5, 4, 0.5, seed=0)
    with pytest.raises(ValueError, match="int32"):
        cas_ops.cascade_wave(t(c).long(), t(fired), t(bern), 4)
    with pytest.raises(ValueError, match=r"\(4, n, n\)"):
        cas_ops.cascade_wave(t(c), t(fired), t(bern)[:3], 4)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the wrappers take their
    kernel route here, where no card exists."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_like(x):
    return t(x).as_subclass(_FakeCuda)


def test_wrappers_raise_when_the_library_cannot_be_built(monkeypatch):
    """On CUDA tensors a wrapper launches its kernel or raises; it never
    falls back to the plain version."""
    from repro_torch.kernels import _build

    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load", no_library)
    w, s = _bmu_inputs(8, 3, 4, seed=0)
    before = (bmu_ops.launches, cas_ops.launches)
    for precision in bmu_ops.PRECISIONS:
        with pytest.raises(RuntimeError, match="nvcc"):
            bmu_ops.bmu(_cuda_like(w), _cuda_like(s), precision=precision)
    c, fired, bern = _wave_inputs(5, 4, 0.5, seed=0)
    with pytest.raises(RuntimeError, match="nvcc"):
        cas_ops.cascade_wave(_cuda_like(c), _cuda_like(fired),
                             _cuda_like(bern), 4)
    assert (bmu_ops.launches, cas_ops.launches) == before


def test_wrappers_reject_mixed_devices():
    w, s = _bmu_inputs(8, 3, 4, seed=0)
    with pytest.raises(ValueError, match="device"):
        bmu_ops.bmu(t(w), _cuda_like(s))


def test_find_nvcc_raises_a_clear_message(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "nvcc").write_text("")
    assert _build.find_nvcc() == str(tmp_path / "bin" / "nvcc")


def test_library_name_follows_the_sources(tmp_path):
    """An edit to a kernel source renames (and so rebuilds) the library."""
    from repro_torch.kernels import _build
    srcs = _build.sources()
    assert {p.parent.name for p in srcs} >= {"bmu", "cascade"}
    copies = []
    for src in srcs:
        dst = tmp_path / src.parent.name / src.name
        dst.parent.mkdir()
        dst.write_bytes(src.read_bytes())
        copies.append(dst)
    name = _build.library_path(copies).name
    assert name == _build.library_path(srcs).name
    copies[0].write_bytes(copies[0].read_bytes() + b"\n// edit\n")
    assert _build.library_path(copies).name != name


def test_library_name_follows_the_shared_headers(tmp_path):
    """An edit to a header the kernels share renames the library too."""
    from repro_torch.kernels import _build
    srcs = _build.sources()
    headers = _build.headers()
    assert any(h.name == "search.cuh" for h in headers)
    copies = []
    for src in srcs + headers:
        dst = tmp_path / src.parent.name / src.name
        dst.parent.mkdir(exist_ok=True)
        dst.write_bytes(src.read_bytes())
        copies.append(dst)
    copied = ([c for c in copies if c.suffix == ".cu"],
              [c for c in copies if c.suffix == ".cuh"])
    name = _build.library_path(*copied).name
    assert name == _build.library_path(srcs).name
    header = next(c for c in copies if c.name == "search.cuh")
    header.write_bytes(header.read_bytes() + b"\n// edit\n")
    assert _build.library_path(*copied).name != name


@pytest.mark.parametrize("before", [True, False])
def test_exact_products_leave_the_tf32_switch_as_found(before):
    """The exact-f32 products turn TF32 off only for themselves."""
    from repro_torch.device import exact_f32_matmul
    from repro_torch.kernels.bmu import ref as bmu_ref
    w, s = _bmu_inputs(9, 4, 5, seed=2)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = before
        exact_f32_matmul(t(s), t(w).T)
        bmu_ref.bmu_ref(t(w), t(s))
        bmu_ref.bmu_bf16_ref(t(w), t(s))
        assert torch.backends.cuda.matmul.allow_tf32 is before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


#: (n, b, d, sms): the main path's shapes on an H100 SXM (132 SMs) and a
#: PCIe card (114); B past one sample tile of rows_kernel; B where the
#: tiles reach a third of the SMs (6 x 8 x 3 >= 132)
PLAN_SHAPES = [(900, 16, 784, 132), (900, 10000, 784, 132),
               (900, 16, 784, 114), (900, 10000, 784, 114),
               (900, 33, 784, 132), (900, 300, 784, 132),
               (900, 700, 784, 132)]


@pytest.mark.parametrize("n,b,d,sms", PLAN_SHAPES)
def test_bmu_plan_gives_every_sm_a_block(n, b, d, sms):
    p = bmu_ops.plan(n, b, d, sms)
    assert p.blocks >= (sms if p.kernel == "rows" else -(-sms // 3))
    assert p.kernel == ("tiles" if b in (700, 10000) else "rows")
    if b == 16:                    # one sample tile, ~7 units a split
        assert p.grid == (sms, 1)
        sizes = [hi - lo for lo, hi in map(p.unit_range, range(p.splits))]
        assert max(sizes) - min(sizes) <= 1 and max(sizes) <= 8


@pytest.mark.parametrize("n,b", [(900, 16), (900, 10000), (37, 5), (1, 3),
                                 (129, 65), (100_000, 10_000), (133, 16)])
def test_bmu_plan_splits_cover_the_units_once_in_order(n, b):
    p = bmu_ops.plan(n, b, 784, 132)
    edges = [p.unit_range(i) for i in range(p.splits)]
    assert edges[0][0] == 0 and edges[-1][1] == n
    assert all(a[1] == c[0] for a, c in zip(edges, edges[1:]))
    assert all(lo < hi for lo, hi in edges)      # the plan makes none empty
    assert all(lo % p.unit_step == 0 for lo, _ in edges)


def test_bmu_plan_rejects_empty_shapes():
    with pytest.raises(ValueError, match="plan"):
        bmu_ops.plan(0, 16, 784, 132)


def _split_plans(n, b):
    """The planner's plan at 132 SMs, and plans with empty splits."""
    p = bmu_ops.plan(n, b, 8, 132)
    steps = -(-n // p.unit_step)
    return [p, bmu_ops.Plan(p.kernel, n, b, p.sample_tile, 1),
            bmu_ops.Plan(p.kernel, n, b, p.sample_tile, steps + 3)]


@pytest.mark.parametrize("precision", ["exact", "bf16"])
@pytest.mark.parametrize("n,b,d", [(37, 5, 13), (130, 33, 8), (200, 70, 31)])
def test_bmu_split_merge_matches_the_pallas_kernel(n, b, d, precision):
    """The kernel's split-and-merge arithmetic (plain, ``ref.bmu_split_ref``)
    under the planner's plan, one split, and more splits than units (empty
    splits), against the Pallas kernel in interpret mode."""
    w, s = _bmu_inputs(n, b, d, seed=n + 7 * b)
    ij, qj = jbmu_ops.bmu(jnp.asarray(w), jnp.asarray(s), use_pallas=True,
                          interpret=True, precision=precision)
    for p in _split_plans(n, b):
        it, qt = bmu_ref.bmu_split_ref(t(w), t(s), p, precision=precision)
        assert it.dtype == torch.int32 and qt.shape == (b,)
        assert_bmu_tier(it, qt, ij, qj, w, s)


@pytest.mark.parametrize("precision", ["exact", "bf16"])
@pytest.mark.parametrize("b", [16, 40])
def test_bmu_split_merge_ties_across_splits_take_lowest_index(b, precision):
    """Duplicated units in different splits (rows and tiles plans) tie
    bitwise; the merge keeps the lower index, as JAX's oracle does."""
    rng = np.random.default_rng(b)
    w = rng.standard_normal((300, 20)).astype(np.float32)
    lo, hi = np.array([2, 7, 100]), np.array([290, 150, 257])
    w[hi] = w[lo]
    s = w[hi] + np.float32(1e-3) * rng.standard_normal((3, 20)).astype(
        np.float32)
    s = np.resize(s, (b, 20))
    for p in _split_plans(300, b):
        it, _ = bmu_ref.bmu_split_ref(t(w), t(s), p, precision=precision)
        np.testing.assert_array_equal(it.numpy(), np.resize(lo, b))
    ij, _ = jbmu_ops.bmu(jnp.asarray(w), jnp.asarray(s), use_pallas=False,
                         precision=precision)
    np.testing.assert_array_equal(np.asarray(ij), np.resize(lo, b))
