"""The port's map persistence against the JAX package's, on the CPU.

- The port's own artifacts: save -> load round-trips bit for bit on
  ``transform`` and ``predict``, ``MapStore`` versioning, and the manifest
  and payload integrity checks, each with JAX's error messages.
- Across the packages: a JAX-written artifact loads in the port, and a
  port-written one loads in JAX (``load_artifact``, and ``TopoMap.load``
  with an explicit ``backend=``); payloads are byte-identical for the same
  numbers. ``transform`` / ``predict`` agree exactly; QE within the f32
  bound of the expanded distance (``tie_bound``, summed in another order
  by XLA and by PyTorch), which the measured gap sits far inside.
- Training checkpoints: both packages read each other's state, the
  latency stream is a ``torch.Generator`` state that a resumed
  exponential-latency run replays bitwise, and a JAX threefry key is
  refused.

At side 6, dim 12, as the JAX package's own tests size them.
"""
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.api import MapStore as JMapStore
from repro.api import TopoMap as JTopoMap
from repro.api import load_artifact as jload_artifact
from repro.training import checkpoint as jckpt
from repro_torch.api import MapStore, TopoMap, get_backend, load_artifact
from repro_torch.api import persistence
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.draws import GeneratorDraws
from repro_torch.kernels.bmu import ref as bmu_ref
from repro_torch.training import checkpoint as ckpt
from torch_parity import jax_cfg, t, torch_cfg

KW = dict(side=6, dim=12, i_max=48, batch=4, e_factor=0.5)
CFG = torch_cfg(**KW)


def _data(n=128, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, KW["dim"])).astype(np.float32),
            rng.integers(0, 4, n).astype(np.int32))


X, Y = _data()


def _fit(backend="batched", seed=7, labels=True, **kw):
    tm = TopoMap(CFG, backend=backend, device="cpu", **kw)
    return tm.fit(X, Y if labels else None, draws=GeneratorDraws(seed, "cpu"))


@pytest.fixture(scope="module")
def fitted():
    return _fit()


@pytest.fixture(scope="module")
def jfitted():
    return JTopoMap(jax_cfg(**KW)).fit(X, Y, key=jax.random.PRNGKey(7))


def _qe_tol(w, x, q2):
    """Bound on |QE_a - QE_b| when each per-sample q2 is within
    ``tie_bound`` of the other: |sqrt(a) - sqrt(b)| <= bound / sqrt(q2)."""
    bound = bmu_ref.tie_bound(t(w), t(x)).numpy()
    return float(np.mean(bound / np.sqrt(np.maximum(np.asarray(q2), 1e-6))))


# ------------------------------------------------------ port round-trips


@pytest.mark.parametrize("backend", ["reference", "batched", "kernel"])
def test_roundtrip_bit_identical(tmp_path, backend):
    tm = _fit(backend, seed=5)
    path = str(tmp_path / "art")
    tm.save(path)
    tm2 = TopoMap.load(path, device="cpu")
    assert tm2.backend.name == backend
    assert torch.equal(tm.transform(X), tm2.transform(X))
    assert torch.equal(tm.predict(X), tm2.predict(X))
    assert torch.equal(tm.state_.w, tm2.state_.w) and tm2.state_.i == 48


def test_load_backend_override(tmp_path, fitted):
    path = str(tmp_path / "art")
    fitted.save(path)
    tm2 = TopoMap.load(path, backend="reference", device="cpu")
    assert tm2.backend.name == "reference"
    assert torch.equal(fitted.transform(X[:33]), tm2.transform(X[:33]))


def test_artifact_preserves_labeling_and_meta(tmp_path):
    tm = _fit(labeling="majority")
    path = str(tmp_path / "art")
    tm.save(path, extra_meta={"dataset": "toy"})
    art = load_artifact(path, device="cpu")
    assert art.labeling == "majority"
    assert art.meta["extra"] == {"dataset": "toy"}
    assert art.cfg == CFG
    assert art.state.i == CFG.total_samples and isinstance(art.state.i, int)
    assert TopoMap.load(path, device="cpu").labeling == "majority"


def test_from_state_restores_unit_labels(fitted):
    wrapped = TopoMap.from_state(fitted.state_, CFG,
                                 unit_labels=fitted.unit_labels_,
                                 device="cpu")
    assert torch.equal(wrapped.predict(X[:21]), fitted.predict(X[:21]))


def test_save_unfitted_raises(tmp_path):
    with pytest.raises(RuntimeError, match="not fitted"):
        TopoMap(CFG, device="cpu").save(str(tmp_path / "art"))


def test_resave_unlabelled_drops_stale_labels(tmp_path, fitted):
    path = str(tmp_path / "art")
    fitted.save(path)
    TopoMap.from_state(fitted.state_, CFG, device="cpu").save(path)
    assert not os.path.exists(os.path.join(path, "unit_labels.msgpack"))
    assert TopoMap.load(path, device="cpu").unit_labels_ is None


def test_unlabelled_roundtrip(tmp_path):
    tm = _fit(labels=False)
    path = str(tmp_path / "art")
    tm.save(path)
    tm2 = TopoMap.load(path, device="cpu")
    assert tm2.unit_labels_ is None
    with pytest.raises(RuntimeError, match="unit labels"):
        tm2.predict(X[:4])


def test_load_defaults_to_cuda(tmp_path, fitted):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine with no card")
    path = str(tmp_path / "art")
    fitted.save(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TopoMap.load(path)


# ---------------------------------------------------------------- MapStore


def test_store_versioning(tmp_path, fitted):
    store = MapStore(str(tmp_path / "store"))
    assert store.save(fitted, "toy") == "toy@1"
    assert store.save(fitted, "toy") == "toy@2"
    assert store.versions("toy") == [1, 2]
    assert store.list() == ["toy@1", "toy@2"]
    pinned = store.load("toy@1", device="cpu")
    latest = store.load("toy", device="cpu")
    assert torch.equal(pinned.transform(X[:9]), latest.transform(X[:9]))


def test_store_resolution_errors(tmp_path, fitted):
    store = MapStore(str(tmp_path / "store"))
    with pytest.raises(KeyError, match="not in store"):
        store.path("nope")
    store.save(fitted, "toy")
    with pytest.raises(KeyError, match="versions"):
        store.path("toy@9")
    with pytest.raises(ValueError, match="bare name"):
        store.save(fitted, "toy@3")


def test_parse_spec():
    assert persistence.parse_spec("toy") == ("toy", None)
    assert persistence.parse_spec("toy@3") == ("toy", 3)
    with pytest.raises(ValueError, match="invalid map spec"):
        persistence.parse_spec("toy@latest")
    with pytest.raises(ValueError, match="invalid map name"):
        persistence.parse_spec("to/y")


# ------------------------------------------------------ manifest validation


def _patch_manifest(path, **patch):
    manifest_path = os.path.join(path, "manifest.json")
    with open(manifest_path) as f:
        manifest = json.load(f)
    manifest.update(patch)
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)


@pytest.mark.parametrize("patch,msg", [
    ({"format_version": 999}, "newer than this reader"),
    ({"config": {"side": 6, "hyperdrive": 1}}, "unknown AFMConfig fields"),
    ({"format": "something-else"}, "manifest format"),
], ids=["newer-version", "unknown-field", "wrong-marker"])
def test_bad_manifest_rejected(tmp_path, fitted, patch, msg):
    path = str(tmp_path / "art")
    fitted.save(path)
    _patch_manifest(path, **patch)
    with pytest.raises(ValueError, match=msg):
        load_artifact(path, device="cpu")


def test_not_an_artifact_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="not a map artifact"):
        load_artifact(str(tmp_path), device="cpu")


def test_save_over_regular_file_rejected(tmp_path, fitted):
    target = tmp_path / "occupied"
    target.write_text("not an artifact")
    with pytest.raises(ValueError, match="not a directory"):
        fitted.save(str(target))
    assert [p.name for p in tmp_path.iterdir()] == ["occupied"]


def test_manifest_records_payload_checksums(tmp_path, fitted):
    path = str(tmp_path / "art")
    fitted.save(path)
    with open(os.path.join(path, "manifest.json")) as f:
        sums = json.load(f)["checksums"]
    assert set(sums) == {"state.msgpack", "unit_labels.msgpack"}
    for fname, digest in sums.items():
        assert len(digest) == 64
        assert ckpt.file_sha256(os.path.join(path, fname)) == digest


def _flip_byte(path):
    p = os.path.join(path, "state.msgpack")
    raw = bytearray(open(p, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(p, "wb").write(bytes(raw))


def _truncate(path):
    p = os.path.join(path, "state.msgpack")
    raw = open(p, "rb").read()
    open(p, "wb").write(raw[:len(raw) // 2])


def _drop_labels(path):
    os.remove(os.path.join(path, "unit_labels.msgpack"))


def _cut_manifest(path):
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write('{"format": "topomap-art')


@pytest.mark.parametrize("damage,msg", [
    (_flip_byte, "corrupt or truncated"),
    (_truncate, "corrupt or truncated"),
    (_drop_labels, "missing"),
    (_cut_manifest, "corrupt or truncated"),
], ids=["bitflip", "truncated", "missing-payload", "corrupt-manifest"])
def test_damaged_artifact_rejected(tmp_path, fitted, damage, msg):
    path = str(tmp_path / "art")
    fitted.save(path)
    damage(path)
    with pytest.raises(ValueError, match=msg):
        load_artifact(path, device="cpu")


# -------------------------------------------------- across the two packages


def test_treedef_strings_are_jax_s():
    state = persistence._state_like(CFG)
    jstate = jax.tree.map(np.asarray, state_to_numpy(state))
    from repro.core.afm import AFMState as JState
    trees = [(state, JState(**jstate)),
             (torch.zeros(3), np.zeros(3)),
             ({"lat_key": torch.zeros(2)}, {"lat_key": np.zeros(2)}),
             ({"b": [1, (2, None), (3,)], "a": 3},
              {"b": [1, (2, None), (3,)], "a": 3})]
    for tree, jtree in trees:
        assert ckpt.treedef_str(tree) == str(jax.tree.structure(jtree))
        assert ckpt.describe_structure(tree) == \
            jckpt.describe_structure(jtree)


def test_payload_bytes_equal_jax_s(tmp_path, jfitted):
    """The same state written by both packages gives the same file."""
    jckpt.save(str(tmp_path / "j.msgpack"), jfitted.state_)
    ckpt.save(str(tmp_path / "t.msgpack"),
              state_from_numpy(jfitted.state_, device="cpu"))
    assert (tmp_path / "j.msgpack").read_bytes() == \
        (tmp_path / "t.msgpack").read_bytes()


@pytest.mark.parametrize("jbackend,tbackend", [
    ("batched", "batched"), ("reference", "reference"), ("pallas", "kernel")])
def test_jax_artifact_loads_in_port(tmp_path, jbackend, tbackend):
    j = JTopoMap(jax_cfg(**KW), backend=jbackend).fit(
        X, Y, key=jax.random.PRNGKey(3))
    path = str(tmp_path / "art")
    j.save(path, extra_meta={"by": "jax"})
    tm = TopoMap.load(path, device="cpu")
    assert tm.backend.name == tbackend and tm.cfg == CFG
    assert tm.state_.i == int(j.state_.i)
    np.testing.assert_array_equal(tm.state_.w.numpy(), np.asarray(j.state_.w))
    np.testing.assert_array_equal(tm.transform(X).numpy(),
                                  np.asarray(j.transform(X)))
    np.testing.assert_array_equal(tm.predict(X).numpy(),
                                  np.asarray(j.predict(X)))
    _, q2 = tm.engine.bmu(tm.state_.w, t(X))
    tol = _qe_tol(tm.state_.w, X, q2)
    assert abs(tm.quantization_error(X) - j.quantization_error(X)) <= tol


def test_port_artifact_loads_in_jax(tmp_path, fitted):
    path = str(tmp_path / "art")
    fitted.save(path, extra_meta={"by": "torch"})
    art = jload_artifact(path)
    assert art.backend == "batched" and art.meta["extra"] == {"by": "torch"}
    np.testing.assert_array_equal(np.asarray(art.state.w),
                                  fitted.state_.w.numpy())
    assert int(art.state.i) == fitted.state_.i
    j = JTopoMap.load(path, backend="batched")
    np.testing.assert_array_equal(np.asarray(j.transform(X)),
                                  fitted.transform(X).numpy())
    np.testing.assert_array_equal(np.asarray(j.predict(X)),
                                  fitted.predict(X).numpy())
    _, q2 = fitted.engine.bmu(fitted.state_.w, t(X))
    tol = _qe_tol(fitted.state_.w, X, q2)
    assert abs(j.quantization_error(X) - fitted.quantization_error(X)) <= tol


def test_kernel_artifact_loads_in_jax_with_a_backend(tmp_path):
    """The port writes its own backend name, which JAX's registry lacks:
    JAX loads it with an explicit ``backend=``."""
    tm = _fit("kernel")
    path = str(tmp_path / "art")
    tm.save(path)
    assert jload_artifact(path).backend == "kernel"
    with pytest.raises(KeyError, match="unknown backend"):
        JTopoMap.load(path)
    j = JTopoMap.load(path, backend="pallas")
    np.testing.assert_array_equal(np.asarray(j.transform(X)),
                                  tm.transform(X).numpy())


def test_sharded_artifact_names_the_roadmap_item(tmp_path, jfitted):
    from repro.api.persistence import save_artifact as jsave
    path = str(tmp_path / "art")
    jsave(path, cfg=jfitted.cfg, state=jfitted.state_, backend="sharded")
    # a 'sharded' map loads onto the port's 1 x 1 mesh, as JAX's does
    assert TopoMap.load(path, device="cpu").backend.name == "sharded"
    tm = TopoMap.load(path, backend="batched", device="cpu")
    np.testing.assert_array_equal(tm.transform(X).numpy(),
                                  np.asarray(jfitted.transform(X)))


def test_store_versions_cross_packages(tmp_path, jfitted, fitted):
    root = str(tmp_path / "store")
    assert JMapStore(root).save(jfitted, "toy") == "toy@1"
    store = MapStore(root)
    assert store.save_state("toy", cfg=fitted.cfg, state=fitted.state_,
                            unit_labels=fitted.unit_labels_) == "toy@2"
    assert store.list() == JMapStore(root).list() == ["toy@1", "toy@2"]
    v1 = store.load("toy@1", device="cpu")
    np.testing.assert_array_equal(v1.transform(X).numpy(),
                                  np.asarray(jfitted.transform(X)))
    v2 = JMapStore(root).load("toy")
    np.testing.assert_array_equal(np.asarray(v2.predict(X)),
                                  fitted.predict(X).numpy())


# ---------------------------------------------------------- train checkpoints


def test_train_checkpoint_crosses_packages(tmp_path, jfitted):
    from repro.api.persistence import _state_like as jstate_like
    cfg_dict = {"side": 6, "dim": 12}
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_train_checkpoint(jpath, config=cfg_dict, state=jfitted.state_,
                                cursor={"consumed": 48})
    got = ckpt.load_train_checkpoint(
        jpath, state_like=persistence._state_like(CFG),
        expect_config=cfg_dict)
    assert got.cursor == {"consumed": 48} and got.lat_state is None
    np.testing.assert_array_equal(got.state.w.numpy(),
                                  np.asarray(jfitted.state_.w))
    assert got.state.i == int(jfitted.state_.i)
    ckpt.save_train_checkpoint(tpath, config=cfg_dict, state=got.state,
                               cursor=got.cursor, meta={"run": 1})
    back = jckpt.load_train_checkpoint(
        tpath, state_like=jstate_like(jfitted.cfg), expect_config=cfg_dict)
    for f in ("w", "c", "far", "near", "i"):
        np.testing.assert_array_equal(np.asarray(getattr(back.state, f)),
                                      np.asarray(getattr(jfitted.state_, f)))
    assert back.meta == {"run": 1}
    with pytest.raises(ValueError, match="does not match"):
        ckpt.load_train_checkpoint(
            tpath, state_like=persistence._state_like(CFG),
            expect_config={"side": 7})


def test_jax_latency_key_is_refused(tmp_path, jfitted):
    path = str(tmp_path / "j")
    jckpt.save_train_checkpoint(path, config={}, state=jfitted.state_,
                                cursor={}, lat_key=jax.random.PRNGKey(4))
    with pytest.raises(ValueError, match="threefry"):
        ckpt.load_train_checkpoint(path,
                                   state_like=persistence._state_like(CFG))


def test_port_latency_state_is_refused_by_jax(tmp_path, fitted):
    from repro.api.persistence import _state_like as jstate_like
    path = str(tmp_path / "t")
    ckpt.save_train_checkpoint(
        path, config={}, state=fitted.state_, cursor={},
        lat_state=torch.Generator().manual_seed(1).get_state())
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["meta"]["lat_stream"] == ckpt.LAT_STREAM_TORCH
    with pytest.raises(ValueError, match="leaf shape"):
        jckpt.load_train_checkpoint(path, state_like=jstate_like(
            jax_cfg(**KW)))


def test_checkpoint_resume_replays_an_exponential_run(tmp_path):
    """Counterpart of ``test_latency_stream_position_replays_a_run``
    through the checkpoint files: an exponential-latency async run saved
    mid-run (state and latency-generator position) and resumed from disk
    equals the uninterrupted run bitwise."""
    cfg = torch_cfg(side=6, dim=12, theta=2, i_max=128, e_factor=0.5)
    opts = dict(latency="exponential", delay=1.0, lat_seed=5, device="cpu")
    x = t(X)
    a = get_backend("async", cfg, **opts)
    state = a.init(GeneratorDraws(0, "cpu"), x)
    mid, _ = a.run(state, x, GeneratorDraws(1, "cpu"), num_steps=30)
    path = str(tmp_path / "ckpt")
    ckpt.save_train_checkpoint(
        path, config={"side": 6}, state=mid, cursor={"step": 30},
        lat_state=a.lat_draws.generator.get_state())
    full, _ = a.run(mid, x, GeneratorDraws(2, "cpu"), num_steps=30)
    assert a.last_report.sent > 0

    got = ckpt.load_train_checkpoint(
        path, state_like=persistence._state_like(cfg),
        expect_config={"side": 6})
    assert got.cursor == {"step": 30} and got.state.i == mid.i
    b = get_backend("async", cfg, **opts)
    b.lat_draws.generator.set_state(got.lat_state)
    resumed, _ = b.run(got.state, x, GeneratorDraws(2, "cpu"), num_steps=30)
    for f in ("w", "c"):
        assert torch.equal(getattr(full, f), getattr(resumed, f))
    assert full.i == resumed.i
    assert a.last_report.rounds == b.last_report.rounds
    c = get_backend("async", cfg, **opts)               # stream not restored
    fresh, _ = c.run(got.state, x, GeneratorDraws(2, "cpu"), num_steps=30)
    assert not torch.equal(full.w, fresh.w)


def test_checkpoint_integrity_and_structure(tmp_path, fitted):
    path = str(tmp_path / "t")
    ckpt.save_train_checkpoint(path, config={}, state=fitted.state_,
                               cursor={})
    like = persistence._state_like(CFG)
    p = os.path.join(path, "state.msgpack")
    raw = bytearray(open(p, "rb").read())
    raw[-5] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="checksum mismatch"):
        ckpt.load_train_checkpoint(path, state_like=like)
    with pytest.raises(FileNotFoundError, match="no train checkpoint"):
        ckpt.load_train_checkpoint(str(tmp_path), state_like=like)
    single = str(tmp_path / "s.msgpack")
    ckpt.save(single, fitted.state_)
    with pytest.raises(ValueError, match="tree structure mismatch"):
        ckpt.restore(single, {"w": like.w})
    with pytest.raises(ValueError, match="leaf shape"):
        ckpt.restore(single, persistence._state_like(torch_cfg(side=5,
                                                               dim=12)))
    with pytest.raises(ValueError, match="lat_state"):
        ckpt.save_train_checkpoint(str(tmp_path / "u"), config={},
                                   state=fitted.state_, cursor={},
                                   lat_state=torch.zeros(2, dtype=torch.int32))
