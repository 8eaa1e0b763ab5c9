"""The port's CUDA kernels and kernel path on the card.

Every test here needs an NVIDIA card and skips without one. The file
imports neither JAX nor ``tests/conftest.py``'s helpers, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` is the full check on the card; these are the quick ones.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro_torch.api import TopoMap
from repro_torch.core.afm import AFMConfig
from repro_torch.kernels.bmu import ops as bmu_ops
from repro_torch.kernels.bmu import ref as bmu_ref
from repro_torch.kernels.cascade import ops as cas_ops
from repro_torch.kernels.cascade import ref as cas_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("precision", ["exact", "bf16"])
@pytest.mark.parametrize("n,b,d", [(900, 300, 784), (37, 5, 13),
                                   (129, 65, 33), (1, 3, 1)])
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
    rng = np.random.default_rng(0)
    x = rng.random((500, 24), dtype=np.float32)
    before = (bmu_ops.launches, cas_ops.launches)
    tm = TopoMap(AFMConfig(side=8, dim=24, batch=8, i_max=800),
                 backend="kernel", device=cuda).fit(x, num_steps=40)
    assert bmu_ops.launches > before[0] and cas_ops.launches > before[1]
    assert tm.state_.w.is_cuda and bool(torch.isfinite(tm.state_.w).all())
    assert tm.transform(x).shape == (500,)
