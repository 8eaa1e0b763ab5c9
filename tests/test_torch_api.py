"""The port's ``TopoMap`` surface, its backends and its metrics against the
JAX package's, on the CPU.

- quality tier: a full ``fit`` through the port's ``kernel`` backend
  (plain versions on the CPU) against JAX's ``pallas`` backend (its CPU
  oracle) on the same numpy data. The two draw different random numbers,
  so they agree within the seed-to-seed spread of JAX itself on this data
  (measured over 16 seeds: QE sd 0.4 %, TE sd 0.06, accuracy sd 0.02); each
  side averages two seeds and the tolerance is about 3 sd of the difference.
- bitwise: ``reference`` == ``batched`` at B = 1, and the ``kernel`` backend
  == exact-search ``batched`` on the CPU (same arithmetic, and the same
  numbers: ``batched`` draws one array a wave, the kernel backend the first
  16 waves' as one block, so its run replays ``batched``'s stacked).
- metrics and classifier from one JAX-trained state: ULP / bitwise tiers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.api import TopoMap as JTopoMap
from repro.core import classifier as jclf
from repro.core import links as jlinks
from repro.core import metrics as jmetrics
from repro_torch.api import TopoMap, available_backends, get_backend
from repro_torch.convert import state_from_numpy
from repro_torch.core import classifier as tclf
from repro_torch.core import metrics as tmetrics
from repro_torch.draws import GeneratorDraws, ReplayDraws
from repro_torch.kernels.cascade.ops import DEFAULT_WAVE_CAP
from torch_parity import (F32_EPS, jax_cfg, replay, search_draws, t,
                          torch_cfg)


def _data(n, d=16, seed=0, classes=6, modes=3, noise=0.9):
    """Class mixture: each class is ``modes`` Gaussian blobs."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((classes * modes, d))
    m = rng.integers(0, classes * modes, n)
    x = centres[m] + noise * rng.standard_normal((n, d))
    return x.astype(np.float32), (m // modes).astype(np.int32)


X, Y = _data(1600)
XTR, YTR, XTE, YTE = X[:1200], Y[:1200], X[1200:], Y[1200:]
FIT = dict(side=6, dim=16, batch=4, i_max=2400)
SMALL = dict(side=5, dim=16, batch=1, i_max=160, e_factor=0.5)


def _quality(tm, predict):
    return (tm.quantization_error(XTE), tm.topographic_error(XTE),
            float((np.asarray(predict(XTE)) == YTE).mean()))


def test_fit_quality_matches_jax_pallas():
    jq, tq = [], []
    for seed in (0, 1):
        j = JTopoMap(jax_cfg(**FIT), backend="pallas", seed=seed).fit(XTR, YTR)
        jq.append(_quality(j, j.predict))
        tm = TopoMap(torch_cfg(**FIT), backend="kernel", device="cpu",
                     seed=seed).fit(XTR, YTR)
        tq.append(_quality(tm, lambda x: tm.predict(x).numpy()))
    (jqe, jte, jacc), (tqe, tte, tacc) = np.mean(jq, 0), np.mean(tq, 0)
    assert abs(tqe - jqe) / jqe < 0.02, (tqe, jqe)
    assert abs(tte - jte) < 0.18, (tte, jte)
    assert abs(tacc - jacc) < 0.06, (tacc, jacc)
    assert tacc > 0.8           # six classes: chance is 0.17


def test_reference_matches_batched_b1_bitwise():
    w_ref = TopoMap(torch_cfg(**SMALL), backend="reference", device="cpu",
                    seed=7).fit(XTR).state_.w
    w_bat = TopoMap(torch_cfg(**SMALL), backend="batched", device="cpu",
                    seed=7).fit(XTR).state_.w
    assert torch.equal(w_ref, w_bat)


class _Recorder(GeneratorDraws):
    """A ``GeneratorDraws`` that keeps every array it hands out."""

    def __init__(self, seed):
        super().__init__(seed, device="cpu")
        self.log = []

    def _keep(self, x):
        self.log.append(x.numpy().copy())
        return x

    def randint(self, low, high, shape):
        return self._keep(super().randint(low, high, shape))

    def uniform(self, shape):
        return self._keep(super().uniform(shape))

    def normal(self, shape):
        return self._keep(super().normal(shape))

    def gumbel(self, shape):
        return self._keep(super().gumbel(shape))


def _as_blocks(log, waves, side, cap=DEFAULT_WAVE_CAP):
    """A per-wave draw log in the kernel backend's order: after each step's
    drive ``(8, side, side)``, its first ``cap`` wave draws stacked into one
    block (padded with draws no wave reads), then the rest one a wave."""
    out, it, steps = [], iter(log), iter(waves)
    for x in it:
        out.append(x)
        if x.shape != (8, side, side):
            continue
        per_wave = [next(it) for _ in range(int(next(steps)))]
        pad = [np.ones((4, side, side), np.float32)] * max(0, cap - len(
            per_wave))
        out += [np.stack((per_wave + pad)[:cap])] + per_wave[cap:]
    assert next(steps, None) is None
    return out


def test_kernel_backend_matches_exact_batched_bitwise():
    """``batched`` with exact search fits first on a recording draw source;
    the kernel backend then replays the same numbers, its wave draws
    stacked from the wave counts that fit recorded: the weights agree bit
    for bit, and the replay is used up."""
    cfg = torch_cfg(**dict(SMALL, batch=4))
    rec = _Recorder(3)
    tb = TopoMap(cfg, backend="batched", backend_options={"search": "exact"},
                 device="cpu").fit(XTR, draws=rec)
    waves = tb.fit_aux_.waves.numpy()
    assert waves.max() > 0
    replay_k = ReplayDraws(_as_blocks(rec.log, waves, cfg.side))
    tk = TopoMap(cfg, backend="kernel", device="cpu").fit(XTR, draws=replay_k)
    assert len(replay_k) == 0
    np.testing.assert_array_equal(tk.fit_aux_.waves.numpy(), waves)
    assert torch.equal(tk.state_.w, tb.state_.w)


@pytest.mark.parametrize("backend", ["batched", "reference", "kernel"])
def test_fit_zero_steps_matches_jax(backend):
    """``TopoMap.fit(num_steps=0)``: as JAX's, the initial map and a
    per-step aux with no steps, of the reference's shapes and dtypes."""
    cfg = dict(side=4, dim=16, batch=2)
    jaux = JTopoMap(jax_cfg(**cfg), backend="batched").fit(
        XTR[:50], num_steps=0).fit_aux_
    tm = TopoMap(torch_cfg(**cfg), backend=backend, device="cpu", seed=1)
    tm.fit(XTR[:50], YTR[:50], num_steps=0)
    init = tm.backend.init(GeneratorDraws(1, device="cpu"), tm._tensor(
        XTR[:50]))
    assert torch.equal(tm.state_.w, init.w) and tm.state_.i == 0
    b = 1 if backend == "reference" else 2
    assert tm.fit_aux_.gmu.shape == (0, b)
    for field in jaux._fields:
        got, want = getattr(tm.fit_aux_, field), np.asarray(
            getattr(jaux, field))
        assert got.shape[0] == want.shape[0] == 0, field
        assert got.shape[1:] == want.shape[1:] or backend == "reference"
        assert got.numpy().dtype == want.dtype, field
    assert tm.predict(XTE[:5]).shape == (5,)


def test_kernel_backend_options():
    cfg = torch_cfg(**SMALL)
    assert set(available_backends()) >= {"reference", "batched", "kernel"}
    fused = get_backend("kernel", cfg, kernel="fused", device="cpu")
    assert fused.kernel == "fused" and fused.stages.fused is not None
    assert get_backend("kernel", cfg, device="cpu").stages.fused is None
    with pytest.raises(ValueError, match="kernel"):
        get_backend("kernel", cfg, kernel="mega", device="cpu")
    with pytest.raises(ValueError, match="precision"):
        get_backend("kernel", cfg, precision="fp8", device="cpu")
    with pytest.raises(ValueError, match="search"):
        get_backend("kernel", cfg, search="psychic", device="cpu")
    with pytest.raises(KeyError, match="unknown backend"):
        get_backend("warp-drive", cfg, device="cpu")
    tm = TopoMap(cfg, backend="kernel", device="cpu",
                 backend_options={"search": "heuristic", "precision": "bf16"})
    assert not torch.isnan(tm.fit(XTR, num_steps=20).state_.w).any()


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine with no card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TopoMap(torch_cfg(**SMALL))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GeneratorDraws(0)


def test_transform_predict_and_surface():
    cfg = torch_cfg(**SMALL)
    tm = TopoMap(cfg, device="cpu").fit(XTR, YTR)
    idx = tm.transform(XTE[:17])
    assert idx.shape == (17,) and idx.dtype == torch.int32
    assert int(idx.max()) < cfg.n_units
    rc = tm.transform(XTE[:17], lattice=True)
    assert torch.equal(rc[:, 0] * cfg.side + rc[:, 1], idx)
    assert torch.equal(tm.transform(XTE, chunk=7), tm.transform(XTE))
    assert tm.predict(XTE).shape == (len(XTE),)
    assert tm.quantization_error(XTE) > 0.0
    assert 0.0 <= tm.topographic_error(XTE) <= 1.0
    assert tm.u_matrix().shape == (cfg.side, cfg.side)
    assert 0.0 <= tm.search_error(XTE[:20]) <= 1.0
    assert tm.fit_aux_.gmu.shape == (cfg.num_steps, 1)
    wrapped = TopoMap.from_state(tm.state_, cfg, device="cpu",
                                 unit_labels=tm.unit_labels_)
    assert torch.equal(wrapped.predict(XTE), tm.predict(XTE))
    majority = TopoMap(cfg, device="cpu", labeling="majority").fit(XTR, YTR)
    assert float((majority.predict(XTE).numpy() == YTE).mean()) > 0.3
    assert "fitted" in repr(tm)


def test_partial_fit_and_errors():
    cfg = torch_cfg(**SMALL)
    tm = TopoMap(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="not fitted"):
        tm.transform(XTE[:1])
    for lo in range(0, 32, 8):
        tm.partial_fit(XTR[lo:lo + 8])
    assert tm.state_.i == 32
    assert tm.fit_aux_.gmu.shape == (8,)         # one batched step of 8
    ref = TopoMap(cfg, backend="reference", device="cpu")
    ref.partial_fit(XTR[:8])
    assert ref.fit_aux_.gmu.shape == (8, 1)      # eight faithful steps
    with pytest.raises(RuntimeError, match="unit labels"):
        tm.predict(XTE[:4])
    with pytest.raises(ValueError, match="labeling"):
        TopoMap(cfg, device="cpu", labeling="vote")
    over = TopoMap(torch_cfg(**SMALL), batch=9, device="cpu")
    assert over.cfg.batch == 9


@pytest.fixture(scope="module")
def trained():
    """A JAX-trained map and its port copy."""
    j = JTopoMap(jax_cfg(**FIT), backend="batched", seed=2).fit(XTR, YTR)
    return j, state_from_numpy(j.state_, device="cpu")


def test_metrics_match_jax(trained):
    j, state = trained
    w, xte = state.w, t(XTE)
    jw = j.state_.w
    np.testing.assert_allclose(
        float(tmetrics.quantization_error(state.w, xte, chunk=150)),
        float(jmetrics.quantization_error(jw, jnp.asarray(XTE), chunk=150)),
        rtol=1e-4)
    assert float(tmetrics.topological_error(w, xte, FIT["side"])) == \
        float(jmetrics.topological_error(jw, jnp.asarray(XTE), FIT["side"]))
    np.testing.assert_allclose(tmetrics.u_matrix(w, FIT["side"]).numpy(),
                               jmetrics.u_matrix(jw, FIT["side"]),
                               rtol=16 * F32_EPS)


def test_search_error_matches_jax(trained):
    j, state = trained
    cfg = jax_cfg(**FIT)
    key = jax.random.PRNGKey(4)
    probe = XTE[:24]
    jf, jres = jmetrics.search_error(j.state_.w, j.state_.near, j.state_.far,
                                     jnp.asarray(probe), key, cfg.e)
    draws = replay(search_draws(key, cfg.n_units, cfg.phi, len(probe), cfg.e))
    tf, tres = tmetrics.search_error(state.w, state.near, state.far, t(probe),
                                     draws, cfg.e)
    np.testing.assert_array_equal(tres.gmu.numpy(), np.asarray(jres.gmu))
    assert float(tf) == float(jf)


def test_classifier_matches_jax(trained):
    j, state = trained
    w, jw = state.w, j.state_.w
    xtr, ytr = t(XTR), t(YTR)
    labels = tclf.label_units(w, xtr, ytr, chunk=500)
    np.testing.assert_array_equal(
        labels.numpy(), np.asarray(jclf.label_units(jw, jnp.asarray(XTR),
                                                    jnp.asarray(YTR), 500)))
    maj = tclf.label_units_majority(w, xtr, ytr, chunk=500)
    np.testing.assert_array_equal(
        maj.numpy(), np.asarray(jclf.label_units_majority(
            jw, jnp.asarray(XTR), jnp.asarray(YTR), chunk=500)))
    pred = tclf.predict(w, labels, t(XTE), chunk=150)
    jpred = jclf.predict(jw, jnp.asarray(labels.numpy()), jnp.asarray(XTE), 150)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    p, r = tclf.precision_recall(pred, t(YTE), 6)
    jp, jr = jclf.precision_recall(jpred, jnp.asarray(YTE), 6)
    np.testing.assert_allclose([float(p), float(r)], [float(jp), float(jr)],
                               rtol=4 * F32_EPS)
    absent = tclf.precision_recall(torch.tensor([0, 0]), torch.tensor([0, 0]),
                                   3)
    assert [float(v) for v in absent] == [1.0, 1.0]


def test_near_links_of_trained_state_are_carried(trained):
    _, state = trained
    np.testing.assert_array_equal(
        state.near.numpy(), np.asarray(jlinks.near_neighbor_table(FIT["side"])))
