"""The port's sharding rules and meshes (``repro_torch.sharding.rules``,
``repro_torch.launch.mesh``) against the JAX package's, on the CPU.

Every spec is compared leaf for leaf with JAX's on both production meshes
as abstract meshes (16 x 16 and 2 x 16 x 16): JAX's side on
``jax.eval_shape`` trees, the port's on ``Transformer(cfg, device="meta")``
and ``meta`` caches and batches. The port keeps one tensor a layer of a
stack, so its spec is JAX's spec of the stacked leaf without the layer
entry. JAX's own checks (``tests/test_sharding.py``) run on the port's
specs too. ``param_count`` and ``model_flops`` are compared with
``repro.launch.dryrun``'s for every arch x shape.
"""
import functools
import os
import types

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro.sharding import compat as jcompat
from repro.sharding import rules as jrules
from repro.training.adamw import adamw_init as jadamw_init
from repro.training.train_step import TrainState as JTrainState
from repro_torch import configs
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer
from repro_torch.models.transformer import layer_of
from repro_torch.sharding import (P, abstract_mesh, batch_specs, cache_specs,
                                  param_specs, placements, train_state_specs)
from repro_torch.training.adamw import adamw_init
from repro_torch.training.train_step import TrainState
from torch_parity import run_ranks
import torch_ranks

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHE_SHAPES = ("decode_32k", "long_500k")
RANK_TIMEOUT = 120.0


def _meshes(name):
    sizes, names = MESHES[name]
    return jcompat.abstract_mesh(sizes, names), abstract_mesh(sizes, names)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    cfg = jconfigs.get(arch)
    return jax.eval_shape(lambda k: jtransformer.init_params(k, cfg), key)


@functools.lru_cache(maxsize=None)
def _model(arch):
    return transformer.Transformer(configs.get(arch), device="meta")


def _at(tree, path):
    for part in path:
        tree = tree[part]
    return tree


def _jax_spec_of(tree, name):
    """JAX's spec of a port parameter name: the stacked leaf's without its
    layer entry, a tail's as it is."""
    where = layer_of(name)
    if where is None:
        return _at(tree, name.split("."))
    return JP(*_at(tree, (where[0],) + where[2])[1:])


def _same_param_specs(port: dict, jax_tree, model):
    assert set(port) == {n for n, _ in model.named_parameters()}
    for name, spec in port.items():
        assert isinstance(spec, P)
        assert spec == _jax_spec_of(jax_tree, name), name


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_specs_match_jax(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    jspecs = jrules.param_specs(_jax_params(arch), jmesh)
    model = _model(arch)
    _same_param_specs(param_specs(model, tmesh), jspecs, model)
    # a dict of name -> tensor gives the same
    assert param_specs(dict(model.named_parameters()), tmesh) == \
        param_specs(model, tmesh)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_train_state_specs_match_jax(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    params_abs = _jax_params(arch)
    jstate = JTrainState(params=params_abs,
                         opt=jax.eval_shape(jadamw_init, params_abs),
                         step=jax.ShapeDtypeStruct((), jnp.int32), probe=None)
    js = jrules.train_state_specs(jstate, jmesh)
    model = _model(arch)
    state = TrainState(model, adamw_init(dict(model.named_parameters())),
                       torch.zeros((), dtype=torch.int32, device="meta"))
    ts = train_state_specs(state, tmesh)
    assert isinstance(ts, TrainState)
    _same_param_specs(ts.params, js.params, model)
    _same_param_specs(ts.opt.mu, js.opt.mu, model)
    _same_param_specs(ts.opt.nu, js.opt.nu, model)
    assert ts.opt.step == js.opt.step == JP()
    assert ts.step == js.step == JP()
    assert ts.probe is None
    # the probe, when there is one, is replicated leaf by leaf
    probe = (torch.zeros(3), torch.zeros((2, 2), dtype=torch.int32))
    assert train_state_specs(state._replace(probe=probe), tmesh).probe == \
        (P(), P())


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_batch_specs_match_jax(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    daxes = mesh_lib.data_axes(tmesh)
    for shape in configs.SHAPES:
        jb = jconfigs.input_specs(
            jconfigs.for_shape(jconfigs.get(arch), shape), shape)
        tb = configs.input_specs(
            configs.for_shape(configs.get(arch), shape), shape)
        assert set(jb) == set(tb)
        js = jrules.batch_specs(jb, jmesh, data_axes=daxes)
        ts = batch_specs(tb, tmesh, data_axes=daxes)
        for key in jb:
            assert ts[key] == js[key], (shape, key)


def _same_tree(port, jax_tree, where=()):
    assert set(port) == set(jax_tree), where
    for key, value in port.items():
        if isinstance(value, dict):
            _same_tree(value, jax_tree[key], where + (key,))
        else:
            assert value == jax_tree[key], where + (key,)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_cache_specs_match_jax(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    daxes = mesh_lib.data_axes(tmesh)
    for shape in CACHE_SHAPES:
        bsz = configs.SHAPES[shape]["batch"]
        jcfg = jconfigs.for_shape(jconfigs.get(arch), shape)
        jcache = jax.eval_shape(lambda c=jcfg: jtransformer.init_cache(
            c, bsz, jconfigs.cache_len_for(c, shape)))
        tcfg = configs.for_shape(configs.get(arch), shape)
        tcache = transformer.init_cache(
            tcfg, bsz, configs.cache_len_for(tcfg, shape), device="meta")
        js = jrules.cache_specs(jcache, jmesh, data_axes=daxes)
        _same_tree(cache_specs(tcache, tmesh, data_axes=daxes), js)


# -------------------------------------------- JAX's own checks, on the port


def _divisible(shape, spec, mesh_shape):
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else axes
        size = 1
        for a in axes:
            size *= mesh_shape[a]
        assert shape[dim] % size == 0, (shape, spec)


@pytest.mark.parametrize("mesh_name", MESHES)
def test_param_and_cache_specs_divisible_all_archs(mesh_name):
    _, tmesh = _meshes(mesh_name)
    for arch in configs.ARCHS:
        model = _model(arch)
        specs = param_specs(model, tmesh)
        for name, p in model.named_parameters():
            _divisible(p.shape, specs[name], tmesh.shape)
    for arch, shape in [("llama3.2-1b", "decode_32k"),
                        ("mamba2-1.3b", "long_500k"),
                        ("recurrentgemma-2b", "decode_32k"),
                        ("yi-9b", "long_500k")]:
        cfg = configs.for_shape(configs.get(arch), shape)
        cache = transformer.init_cache(
            cfg, configs.SHAPES[shape]["batch"],
            configs.cache_len_for(cfg, shape), device="meta")
        specs = cache_specs(cache, tmesh)
        for stack, leaves in cache.items():
            for key, leaf in leaves.items():
                _divisible(leaf.shape, specs[stack][key], tmesh.shape)


def test_model_axis_actually_used():
    """Big projection weights are sharded, not silently replicated."""
    _, tmesh = _meshes("16x16")
    specs = param_specs(_model("llama3.2-1b"), tmesh)
    assert specs["blocks.0.attn.wq"] == P(None, "model")
    assert specs["blocks.5.attn.wo"] == P("model", None)
    assert specs["blocks.15.mlp.wg"] == P(None, "model")
    assert specs["embed"] == P("model", None)
    moe = param_specs(_model("deepseek-moe-16b"), tmesh)
    assert moe["blocks.0.moe.wg"] == P("model", None, None)
    assert moe["blocks.0.moe.shared.wg"] == P(None, "model")


def test_batch_specs_long500k_replicates_batch1():
    _, tmesh = _meshes("16x16")
    cfg = configs.for_shape(configs.get("yi-9b"), "long_500k")
    specs = batch_specs(configs.input_specs(cfg, "long_500k"), tmesh)
    assert specs["tokens"] == P()           # batch 1 cannot shard over 16
    _, pod = _meshes("2x16x16")
    specs = batch_specs(configs.input_specs(
        configs.get("qwen2-vl-72b"), "decode_32k"), pod,
        data_axes=mesh_lib.data_axes(pod))
    assert specs["tokens"] == P(("pod", "data"))
    assert specs["positions3"] == P(None, ("pod", "data"))


# ------------------------------------------------ placements and meshes


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    pod = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert placements(P(("pod", "data"), None, "model"), pod) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(P(None, "model"), pod) == (
        Replicate(), Replicate(), Shard(1))
    assert placements(P(), pod) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        placements(P(("data", "pod")), pod)


def test_mesh_shapes_and_data_axes():
    assert mesh_lib.production_shape() == ((16, 16), ("data", "model"))
    assert mesh_lib.production_shape(True) == ((2, 16, 16),
                                               ("pod", "data", "model"))
    _, tmesh = _meshes("2x16x16")
    assert mesh_lib.data_axes(tmesh) == ("pod", "data")
    dev = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                shape=(16, 16))
    assert mesh_lib.data_axes(dev) == ("data",)
    host = mesh_lib.make_host_mesh()
    assert host.shape == {"data": 1, "model": 1}
    assert mesh_lib.data_axes(host) == ("data",)
    assert host.psum(torch.ones(2), "model").tolist() == [1.0, 1.0]
    with pytest.raises(RuntimeError, match="256 ranks"):
        mesh_lib.make_production_mesh(device_type="cpu")


def test_host_mesh_on_two_gloo_ranks():
    out = run_ranks(torch_ranks.host_mesh, 2, RANK_TIMEOUT)
    for rank, r in enumerate(out):
        assert r["shape"] == {"data": 1, "model": 2}
        assert r["coords"] == (0, rank)
        assert r["data_axes"] == ("data",)
        assert r["psum"] == [1.0, 2.0]


# ------------------------------------------------ param_count, model_flops


@functools.lru_cache(maxsize=None)
def _jax_dryrun():
    """``repro.launch.dryrun``, imported after this process's JAX backend
    is up: its first line sets ``XLA_FLAGS`` to 512 placeholder devices,
    which is put back afterwards so that no later subprocess inherits it."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return dryrun


@pytest.mark.parametrize("arch", list(configs.ALIASES))
def test_param_count_and_model_flops_match_jax(arch):
    jd = _jax_dryrun()
    for shape in configs.SHAPES:
        jcfg = jconfigs.for_shape(jconfigs.get(arch), shape)
        tcfg = configs.for_shape(configs.get(arch), shape)
        for active in (False, True):
            assert tdryrun.param_count(tcfg, active) == \
                jd.param_count(jcfg, active), (shape, active)
        assert tdryrun.model_flops(tcfg, shape) == \
            jd.model_flops(jcfg, shape), shape
