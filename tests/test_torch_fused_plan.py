"""The fused kernel's launch plan and the plain version of its hit-unit
merge, on the CPU.

``kernels.fused.ops.plan`` is pure Python: the CUDA side (``fused.cu``'s
``repro_fused_plan``) only checks it on the card. Here it is held, at the
main path's shape and ragged ones, to what the kernel needs: every block
co-resident (one an SM), its shared memory within the card's opt-in limit,
every unit in exactly one search split and every feature in exactly one
block. ``ref.merge`` (the kernel's hit-unit form of Eq. 3) is held to the
dense form bitwise and to JAX's ``afm.adapt_merge``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.core import afm as jafm
from repro_torch.kernels.fused import ops as fused_ops
from repro_torch.kernels.fused import ref as fused_ref
from torch_parity import F32_EPS, jax_cfg, t

#: an H100's opt-in shared memory a block (232,448 bytes = 227 KB)
H100_SMEM = 232448
KERNELS = Path(fused_ops.__file__).resolve().parents[1]


def _check_plan(n, d, b, sms, smem):
    """Either the plan's properties hold, or it is refused because the
    shared memory of one block cannot fit."""
    ds = -(-d // sms)
    if fused_ops.shared_bytes(n, b, d, ds, 0, 0) > smem:
        with pytest.raises(ValueError, match="shared memory"):
            fused_ops.plan(n, d, b, sms, smem)
        return None
    p = fused_ops.plan(n, d, b, sms, smem)
    assert (p.n, p.d, p.b) == (n, d, b)
    assert p.blocks == p.splits == sms           # one block an SM: resident
    assert p.threads == fused_ops.THREADS
    assert p.smem == fused_ops.shared_bytes(n, b, d, p.ds, p.staged_waves,
                                            p.w_boxes)
    assert p.smem <= smem and p.smem % 16 == 0
    # TMA boxes of the W slice only where rows are whole 16-byte units; each
    # block's boxes start at a multiple of 4 features and cover its slice
    boxes = fused_ops.boxes_needed(d, p.ds, p.blocks)
    assert p.w_boxes == (boxes if d % 4 == 0 and fused_ops.shared_bytes(
        n, b, d, p.ds, 0, boxes) <= smem else 0)
    for i in range(p.feature_blocks):
        lo, hi = p.feature_range(i)
        start = lo - lo % 4
        assert start % 4 == 0 and hi <= start + 8 * max(boxes, 1)
    assert 0 <= p.staged_waves <= fused_ops.MAX_STAGED_WAVES
    if p.staged_waves < fused_ops.MAX_STAGED_WAVES:   # as many as fit
        assert fused_ops.shared_bytes(n, b, d, p.ds, p.staged_waves + 1,
                                      p.w_boxes) > smem
    units = [p.unit_range(i) for i in range(p.blocks)]
    assert units[0][0] == 0 and units[-1][1] == n
    assert all(lo <= hi for lo, hi in units)
    assert all(a[1] == b_[0] for a, b_ in zip(units, units[1:]))
    covered = [u for lo, hi in units for u in range(lo, hi)]
    assert covered == list(range(n))             # each unit once, in order
    feats = [f for i in range(p.blocks) for f in range(*p.feature_range(i))]
    assert feats == list(range(d))               # each feature once
    assert 1 <= p.feature_blocks <= p.blocks
    assert all(p.feature_range(i)[0] < p.feature_range(i)[1]
               for i in range(p.feature_blocks))
    assert all(p.feature_range(i)[0] == p.feature_range(i)[1]
               for i in range(p.feature_blocks, p.blocks))
    return p


@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("d", [3, 13, 784, 785])
@pytest.mark.parametrize("side", [1, 7, 30])
def test_fused_plan_fits_and_covers_every_unit_and_feature(side, d, sms):
    for b in (1, 5, 16, 40):
        _check_plan(side * side, d, b, sms, H100_SMEM)


def test_fused_plan_at_the_main_shape():
    """30x30x784, B = 16 on an H100: 132 blocks, 131 of them with 6
    features, the W slice by TMA boxes (4 of 256 units x 8 features), the
    draws of 8 waves staged, ~192 KB of shared memory a block."""
    p = _check_plan(900, 784, 16, 132, H100_SMEM)
    assert (p.blocks, p.ds, p.feature_blocks) == (132, 6, 131)
    assert p.w_boxes == 1 and p.staged_waves == fused_ops.MAX_STAGED_WAVES
    assert p.smem == 196480
    assert list(p.c_array()) == [132, 6, 512, 196480, 8, 16, 512, 1]
    # D = 785: no TMA boxes (rows are not whole 16-byte units)
    assert _check_plan(900, 785, 16, 132, H100_SMEM).w_boxes == 0
    # 7 features a block start 3 past a multiple of 4: two columns of boxes
    assert fused_ops.boxes_needed(924, 7, 132) == 2


def test_fused_plan_stages_fewer_waves_where_memory_is_short():
    p = _check_plan(900, 784, 16, 132, 180_000)
    assert p.w_boxes and 0 < p.staged_waves < fused_ops.MAX_STAGED_WAVES
    tight = fused_ops.shared_bytes(900, 16, 784, 6, 0, 1)
    assert _check_plan(900, 784, 16, 132, tight).staged_waves == 0
    # no room for the boxes: the slice comes in by 4-byte copies
    p = _check_plan(900, 784, 16, 132, tight - 16)
    assert not p.w_boxes and p.staged_waves > 0


def test_fused_plan_refuses_what_does_not_fit():
    """A slice of 50 features of 900 units (D = 785 on 16 SMs) needs more
    than 227 KB; 30 x 30 at D = 784 needs more than a 100 KB card gives."""
    with pytest.raises(ValueError, match="shared memory"):
        fused_ops.plan(900, 785, 16, 16, H100_SMEM)
    with pytest.raises(ValueError, match="shared memory"):
        fused_ops.plan(900, 784, 16, 132, 100_000)


def test_fused_plan_rejects_empty_shapes():
    with pytest.raises(ValueError, match="plan"):
        fused_ops.plan(0, 784, 16, 132, H100_SMEM)
    with pytest.raises(ValueError, match="plan"):
        fused_ops.plan(900, 784, 16, 0, H100_SMEM)


def test_fused_plan_constants_are_the_kernels():
    """The numbers ``ops.plan`` assumes are those the CUDA sources are built
    with (the card checks the rest: ``repro_fused_plan``)."""
    fused = (KERNELS / "fused" / "fused.cu").read_text()
    search = (KERNELS / "runtime" / "search.cuh").read_text()
    assert re.search(r"constexpr int THREADS = (\d+);", fused).group(1) == \
        str(fused_ops.THREADS)
    assert re.search(r"constexpr int ROW_SAMPLES = (\d+);", search).group(1) \
        == str(fused_ops.SAMPLE_TILE)
    assert re.search(r"constexpr int ROW_KC = (\d+);", search).group(1) == \
        str(fused_ops.CHUNK)
    # the layout's regions, in fused.cu's order and count
    assert len(re.findall(r"= take\(at, ", fused)) == 20
    assert re.search(r"constexpr int SEARCH_WARPS = (\d+);", fused).group(1) \
        == str(fused_ops.SEARCH_WARPS)
    assert re.search(r"constexpr int W_BOX_COLS = (\d+);", fused).group(1) \
        == str(fused_ops.W_BOX_COLS)
    assert re.search(r"constexpr int W_BOX_ROWS = (\d+);", fused).group(1) \
        == str(fused_ops.W_BOX_ROWS)


def _dense_merge(w, s, gmu, l_s):
    """Eq. 3 over every unit at once (the form before the hit-unit loop)."""
    n = w.shape[0]
    g = gmu.long()
    counts = torch.bincount(g, minlength=n).to(torch.int32)
    tsum = torch.zeros_like(w)
    for k in range(s.shape[0]):
        tsum.index_add_(0, g[k:k + 1], s[k:k + 1])
    mean = tsum / torch.clamp(counts, min=1).to(w.dtype)[:, None]
    return torch.where((counts > 0)[:, None], w + l_s * (mean - w), w), counts


@pytest.mark.parametrize("n,d,b", [(25, 7, 16), (900, 13, 40), (4, 3, 9),
                                   (49, 785, 5)])
def test_hit_unit_merge_matches_dense_form_and_jax(n, d, b):
    """The kernel's merge form: bitwise the dense form (same sums in the
    same order), counts exact, and within 2 f32 ULP of max(|w|, |s|) of
    JAX's ``adapt_merge`` (XLA may contract the update into an FMA); the
    units no sample chose keep their rows."""
    rng = np.random.default_rng(n + d + b)
    w = rng.standard_normal((n, d)).astype(np.float32)
    s = rng.standard_normal((b, d)).astype(np.float32)
    gmu = rng.integers(0, min(n, max(2, b // 3)), b).astype(np.int32)
    l_s = 0.05
    out, counts = fused_ref.merge(t(w), t(s), t(gmu), l_s)
    dense, dcounts = _dense_merge(t(w), t(s), t(gmu), l_s)
    assert torch.equal(out, dense) and torch.equal(counts, dcounts)
    cfg = jax_cfg(side=int(round(n ** 0.5)), dim=d, l_s=l_s)
    jw, jcounts = jafm.adapt_merge(jnp.asarray(w), jnp.asarray(s),
                                   jnp.asarray(gmu), cfg)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    err = np.abs(out.numpy() - np.asarray(jw)).max()
    assert err <= 2 * F32_EPS * max(np.abs(w).max(), np.abs(s).max()), err
    hit = np.bincount(gmu, minlength=n) > 0
    np.testing.assert_array_equal(out.numpy()[~hit], w[~hit])
