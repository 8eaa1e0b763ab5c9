"""Multi-pod dry run: trace every (architecture x input shape) step on the
production meshes as DTensors over a fake process group, and derive
roofline terms for the NVIDIA H100 from what one rank would run.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch llama3.2-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all              # 16x16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod  # 2x16x16

The counterpart of ``repro.launch.dryrun``, which lowers and compiles each
step with XLA's SPMD partitioner on placeholder CPU devices. PyTorch has no
SPMD compiler; its counterpart of ``jit(in_shardings=...)`` is DTensor:
each parameter, optimizer moment, batch and cache leaf is a DTensor with
the placements of its ``repro_torch.sharding.rules`` spec on a
``DeviceMesh`` of 256 (512) ranks of a ``fake`` process group, under
``FakeTensorMode``: no weight is allocated and no collective runs. The step
(``train_step.make_train_step`` without the probe, ``prefill``, or
``decode_step`` with an argmax) runs once at full depth, as this process's
rank 0, and DTensor's sharding propagation inserts the collectives.

This is a planning tool and runs on the CPU on purpose: it never touches a
card. Its fake CPU tensors send ``swa_decode`` to its plain version, which
does the same work as the kernel.

Each run writes results/dryrun_torch/<arch>__<shape>__<mesh>.json with JAX's
keys, measured on the tensors rank 0 would hold (local shapes):

- ``memory``: ``argument_size_in_bytes`` (the local shards of every input),
  ``output_size_in_bytes``, ``temp_size_in_bytes`` (the peak of live local
  tensors the step made); ``generated_code_size_in_bytes`` and
  ``alias_size_in_bytes`` are null: there is no compiler to report them;
- ``flops_per_device`` (``torch.utils.flop_counter``'s formulas on local
  shapes) and ``bytes_per_device`` (each local op's input and output
  bytes, views excluded);
- ``collectives``: count and result bytes by kind in JAX's spelling, from
  the functional collectives DTensor runs (``CommDebugMode`` counts the
  same), and wire bytes under JAX's ring model (all-reduce twice);
- ``roofline`` terms against the H100 constants below, ``model_flops_*``,
  ``params_*``;
- ``replicated_ops``: ops DTensor has no sharding strategy for, which run
  here replicated (their inputs all-gathered, as XLA would replicate).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch

from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sharding import rules

# NVIDIA H100 SXM5 80GB at its 700 W limit. Rates from NVIDIA's "H100
# Tensor Core GPU" data sheet unless noted.
PEAK_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s (756e12 on PCIe)
HBM_BW = 3.35e12         # HBM3 bytes/s
# Each 16-wide mesh axis spans two 8-GPU HGX H100 nodes, so a collective
# crosses the nodes' network: 400 Gb/s NDR InfiniBand, one ConnectX-7 a GPU
# (HGX H100 reference design), 50e9 bytes/s a GPU.
LINK_BW = 50e9
# NVLink 4 inside a node: 900 GB/s a GPU both ways, 450e9 a direction
# (the data sheet); printed beside the collective term, not used in it.
NVLINK_BW = 450e9

CONSTANTS = {
    "card": "NVIDIA H100 SXM5 80GB, 700 W",
    "peak_flops": PEAK_FLOPS,
    "peak_flops_source": "NVIDIA H100 Tensor Core GPU data sheet, dense "
                         "BF16, SXM (PCIe: 756e12)",
    "hbm_bytes_per_s": HBM_BW,
    "hbm_source": "NVIDIA H100 Tensor Core GPU data sheet, SXM HBM3",
    "link_bytes_per_s": LINK_BW,
    "link_source": "400 Gb/s NDR InfiniBand, one ConnectX-7 a GPU (HGX H100 "
                   "8-GPU nodes); a 16-wide axis spans two nodes",
    "nvlink_bytes_per_s": NVLINK_BW,
    "nvlink_source": "NVLink 4, 900 GB/s a GPU both ways (data sheet); "
                     "in-node figure, not used in collective_s",
    "device_memory_bytes": 80e9,
}

#: JAX's names of the collective kinds, keyed by the functional collective
_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
#: bytes on the wire per result byte, JAX's ring model ((n-1)/n ~ 1)
_WIRE = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
         "all-to-all": 1.0, "collective-permute": 1.0}


def model_flops(cfg, shape_name: str) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) for training;
    2 N D per generated/processed token for inference shapes."""
    spec = configs.SHAPES[shape_name]
    n_params = param_count(cfg, active_only=True)
    tokens = spec["batch"] * (spec["seq"] if spec["kind"] != "decode" else 1)
    mult = 6.0 if spec["kind"] == "train" else 2.0
    return mult * n_params * tokens


def param_count(cfg, active_only: bool = False) -> float:
    """The parameters of a config by formula, JAX's ``param_count``: the
    embeddings (twice untied), attention, MLP or MoE (the router, all or the
    active experts, the shared ones), SSD and RG-LRU layers, and the audio
    decoder's cross-attention; norm scales are not counted."""
    d, l = cfg.d_model, cfg.num_layers
    n = cfg.vocab_size * d  # embed
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * d
    per_attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    if cfg.arch_type == "ssm":
        di, s, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        per = d * (2 * di + 2 * s + h) + cfg.conv_width * di + di * d
        return n + l * per
    if cfg.arch_type == "hybrid":
        w = cfg.rnn_width
        per_rec = 2 * d * w + 2 * w * w + cfg.conv_width * w + w * d
        pat = list(cfg.block_pattern) * (l // len(cfg.block_pattern)) \
            + list(cfg.pattern_tail)
        per_mlp = 3 * d * cfg.d_ff
        total = 0
        for kind in pat[:l]:
            total += (per_attn if kind == "attn" else per_rec) + per_mlp
        return n + total
    mlp_mult = 3 if cfg.mlp_kind == "swiglu" else 2
    if cfg.arch_type == "moe":
        fe = cfg.moe_d_ff or cfg.d_ff
        e_active = cfg.experts_per_token if active_only else cfg.num_experts
        per_moe = (d * cfg.num_experts                      # router
                   + e_active * 3 * d * fe
                   + cfg.num_shared_experts * 3 * d * fe)
        nd = cfg.first_dense_layers
        total = nd * (per_attn + mlp_mult * d * (cfg.first_dense_d_ff
                                                 or cfg.d_ff))
        total += (l - nd) * (per_attn + per_moe)
        return n + total
    per = per_attn + mlp_mult * d * cfg.d_ff
    if cfg.is_encoder_decoder:
        per_dec = per + per_attn  # + cross attention
        return n + cfg.encoder_layers * per + l * per_dec
    return n + l * per


# ---------------------------------------------------------------------------
# The fake group and the tally of what rank 0 runs


def init_fake_group(world_size: int) -> None:
    """A ``fake`` process group of ``world_size`` ranks, this process rank
    0: collectives are recorded by the modes above them and never run."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor leaf of ``tree``, a
    module's parameters included."""
    from torch.utils import _pytree as pytree
    total = 0
    for x in pytree.tree_leaves(tree):
        if isinstance(x, torch.nn.Module):
            total += sum(_nbytes(_local(p)) for p in x.parameters())
        elif isinstance(x, torch.Tensor):
            total += _nbytes(_local(x))
    return total


class _Tally:
    """The counters one step fills: local FLOPs, bytes, collectives and the
    live bytes of the tensors it made."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.coll: dict = {}
        self.live = 0
        self.peak = 0
        self._storages: dict = {}
        self.replicated: set = set()

    def known(self, tree) -> None:
        """Storages that exist before the step (its arguments): an op that
        writes into one in place allocates nothing."""
        from torch.utils import _pytree as pytree
        for x in pytree.tree_leaves(tree):
            tensors = (list(x.parameters()) if isinstance(x, torch.nn.Module)
                       else [x] if isinstance(x, torch.Tensor) else [])
            for t in tensors:
                self._storages.setdefault(
                    _local(t).untyped_storage()._cdata, 0)

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key) -> None:
        self.live -= self._storages.pop(key, 0)


def _make_mode(tally: _Tally):
    """A dispatch mode that lets DTensor desugar its ops (it answers
    ``NotImplemented`` to them, as ``CommDebugMode`` does) and counts the
    local ops that come out: FLOPs by ``flop_counter``'s formulas, the
    bytes of inputs and outputs (views excluded), collectives by kind, and
    each new storage's bytes while it lives."""
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Mode(TorchDispatchMode):
        counting = True

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                if func in _REPLICATED:
                    tally.replicated.add(str(func))
                return NotImplemented
            out = func(*args, **kwargs)
            if not Mode.counting or isinstance(
                    func, torch._ops.HigherOrderOperator):
                return out
            packet = func._overloadpacket
            ns = func.namespace
            if ns == "_c10d_functional":
                kind = _COLLECTIVE_KINDS.get(packet.__name__)
                if kind is not None:
                    c = tally.coll.setdefault(kind, {"count": 0,
                                                     "result_bytes": 0})
                    c["count"] += 1
                    c["result_bytes"] += sum(
                        _nbytes(x) for x in pytree.tree_leaves(out)
                        if isinstance(x, torch.Tensor))
            elif packet in flop_registry:
                tally.flops += flop_registry[packet](*args, **kwargs,
                                                     out_val=out)
            outs = [x for x in pytree.tree_leaves(out)
                    if isinstance(x, torch.Tensor)]
            if not func.is_view and ns != "_c10d_functional":
                ins = [x for x in pytree.tree_leaves((args, kwargs))
                       if isinstance(x, torch.Tensor)]
                tally.bytes += sum(_nbytes(x) for x in ins + outs)
            for x in outs:
                tally.track(x)
            return out

    return Mode


@contextlib.contextmanager
def _no_count_in_propagation(mode_cls):
    """DTensor's sharding propagator runs each new op once on global fake
    tensors to learn its output's shape; those runs are no work of rank 0,
    so the counting mode skips them."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    inner = prop._propagate_tensor_meta_non_cached

    def wrapped(*args, **kwargs):
        before, mode_cls.counting = mode_cls.counting, False
        try:
            return inner(*args, **kwargs)
        finally:
            mode_cls.counting = before

    prop._propagate_tensor_meta_non_cached = wrapped
    try:
        yield
    finally:
        del prop._propagate_tensor_meta_non_cached


# ---------------------------------------------------------------------------
# DTensor leaves


def _local_shape(shape, placements, mesh) -> tuple:
    from torch.distributed.tensor import Shard
    local = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    return tuple(local)


def fake_dtensor(shape, dtype, spec, mesh, *, zeros: bool = False):
    """A DTensor of global ``shape`` with ``spec``'s placements on
    ``mesh``, its local shard a fresh (fake, under ``FakeTensorMode``)
    tensor."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    pl = rules.placements(spec, mesh)
    make = torch.zeros if zeros else torch.empty
    local = make(_local_shape(shape, pl, mesh), dtype=dtype)
    stride = torch.empty(shape, device="meta").stride() if shape else ()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _dtensor_tree(tree, specs, mesh, **kw):
    if isinstance(tree, dict):
        return {k: _dtensor_tree(v, specs[k], mesh, **kw)
                for k, v in tree.items()}
    return fake_dtensor(tree.shape, tree.dtype, specs, mesh, **kw)


def dtensor_model(cfg, mesh, *, trainable: bool):
    """A ``Transformer`` whose every parameter is a DTensor with its
    ``param_specs`` placements (fake local shards)."""
    from torch import nn

    from repro_torch.models.transformer import Transformer
    model = Transformer(cfg, device="meta")
    specs = rules.param_specs(model, mesh)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        setattr(module, leaf, nn.Parameter(
            fake_dtensor(p.shape, p.dtype, specs[name], mesh),
            requires_grad=trainable))
    return model, specs


# ---------------------------------------------------------------------------
# The steps


def build_config(arch: str, shape: str, moe_impl: str | None = None,
                 remat: bool | None = None, overrides: dict | None = None):
    """``configs.for_shape`` of the arch, with JAX's ``build_lowerable``
    overrides applied (``--moe-impl``, ``--remat``, ``--set``)."""
    cfg = configs.for_shape(configs.get(arch), shape)
    if moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if overrides:
        typed = {}
        for k, v in overrides.items():
            cur = getattr(cfg, k)
            if isinstance(cur, bool):
                typed[k] = v in (True, "true", "True", "1", "on")
            elif isinstance(cur, int):
                typed[k] = int(v)
            elif isinstance(cur, float):
                typed[k] = float(v)
            else:
                typed[k] = v
        cfg = dataclasses.replace(cfg, **typed)
    return cfg


def build_step(cfg, shape: str, mesh, batch_shapes: dict | None = None,
               cache_len: int | None = None):
    """(fn, args): the step of ``shape``'s kind and its inputs as DTensors
    with their specs' placements, made under the caller's
    ``FakeTensorMode``. ``batch_shapes`` (name -> meta tensor) and
    ``cache_len`` override ``input_specs``' batch and ``cache_len_for``,
    for a smaller run of the same step."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models import transformer
    from repro_torch.serving import serve_step
    from repro_torch.training.adamw import AdamWConfig, AdamWState
    from repro_torch.training.train_step import TrainState, make_train_step

    kind = configs.SHAPES[shape]["kind"]
    daxes = mesh_lib.data_axes(mesh)
    batch_meta = batch_shapes or configs.input_specs(cfg, shape)
    b_specs = rules.batch_specs(batch_meta, mesh, data_axes=daxes)
    batch = _dtensor_tree(batch_meta, b_specs, mesh)
    model, p_specs = dtensor_model(cfg, mesh, trainable=kind == "train")
    if kind == "train":
        params = dict(model.named_parameters())
        mu, nu = ({k: fake_dtensor(p.shape, torch.float32, p_specs[k], mesh)
                   for k, p in params.items()} for _ in range(2))
        step_t, opt_step = (fake_dtensor((), torch.int32, rules.P(), mesh)
                            for _ in range(2))
        state = TrainState(model, AdamWState(mu, nu, opt_step), step_t, None)
        step = make_train_step(cfg, AdamWConfig(total_steps=10_000))
        return step, (state, batch)
    bsz = batch_meta["tokens"].shape[0]
    cache_len = cache_len or configs.cache_len_for(cfg, shape)
    if kind == "prefill":
        cache_meta = transformer.init_cache(cfg, bsz, cache_len,
                                            device="meta")
        c_specs = rules.cache_specs(cache_meta, mesh, data_axes=daxes)
        prefill = serve_step.make_prefill(cfg, cache_len=cache_len)

        def fn(model, batch):
            cache = _dtensor_tree(cache_meta, c_specs, mesh, zeros=True)
            return prefill(model, batch, cache=cache)

        return fn, (model, batch)
    cache_meta = transformer.init_cache(cfg, bsz, cache_len, device="meta")
    c_specs = rules.cache_specs(cache_meta, mesh, data_axes=daxes)
    cache = _dtensor_tree(cache_meta, c_specs, mesh)

    def fn(model, batch, cache):
        logits, cache = transformer.decode_step(
            model, batch["tokens"], batch["pos"], cache, cfg,
            positions3=batch.get("positions3"))
        # the argmax over a vocab-sharded row: the row gathered first
        logits = logits.redistribute(placements=[
            Replicate() if p == Shard(1) else p for p in logits.placements])
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return fn, (model, batch, cache)


def trace(fn, args):
    """Run ``fn(*args)`` once under the counting modes; returns (out,
    tally, CommDebugMode's counts by JAX's kind)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    tally = _Tally()
    tally.known(args)
    mode = _make_mode(tally)
    comm = CommDebugMode()
    with _no_count_in_propagation(mode), implicit_replication(), comm, \
            mode():
        out = fn(*args)
    counts: dict = {}
    for op, n in comm.get_comm_counts().items():
        kind = _COLLECTIVE_KINDS.get(op.__name__.split(".")[-1])
        if kind is not None:
            counts[kind] = counts.get(kind, 0) + n
    return out, tally, counts


#: ops this process registered replicated (``_replicate_all``): DTensor
#: keeps a registered strategy for the process's life
_REPLICATED: set = set()


def _replicate_all(op) -> None:
    """Register a strategy for ``op``, which DTensor has none for: every
    tensor input and output replicated (so its sharded inputs are
    all-gathered first)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor.experimental import register_sharding
    n_out = len(op._schema.returns)

    def strategy(*args, **kwargs):
        ins = [Replicate() if isinstance(a, DTensorSpec) else None
               for a in args]
        return [([Replicate()] * n_out, ins)]

    register_sharding(op)(strategy)
    _REPLICATED.add(op)


def _missing_strategy(err: Exception):
    """The op of DTensor's "does not have a sharding strategy registered"
    error, or None."""
    import re
    m = re.search(r"Operator (\S+) does not have a sharding strategy",
                  str(err))
    if m is None:
        return None
    ns, name, overload = m.group(1).split(".")
    return getattr(getattr(getattr(torch.ops, ns), name), overload)


def trace_step(cfg, shape: str, mesh, batch_shapes: dict | None = None,
               cache_len: int | None = None):
    """Build and trace the step of ``shape`` on ``mesh`` under
    ``FakeTensorMode``. An op DTensor has no strategy for is registered
    replicated (``_replicate_all``) and the step traced again; the tally
    names each such op the step ran (``tally.replicated``). Returns (args,
    out, tally, CommDebugMode's counts)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    while True:
        with FakeTensorMode():
            fn, args = build_step(cfg, shape, mesh, batch_shapes, cache_len)
            try:
                out, tally, counts = trace(fn, args)
            except NotImplementedError as e:
                op = _missing_strategy(e)
                if op is None or op in _REPLICATED:
                    raise
                _replicate_all(op)
                continue
        return args, out, tally, counts


def collectives(tally: _Tally, counts: dict) -> dict:
    """JAX's ``collectives`` entry from the tally; the counts must be
    ``CommDebugMode``'s."""
    by_kind = {k: dict(v) for k, v in sorted(tally.coll.items())}
    mine = {k: v["count"] for k, v in by_kind.items()}
    if mine != counts:
        raise RuntimeError(f"collective counts disagree: the tally has {mine},"
                           f" CommDebugMode {counts}")
    wire = sum(v["result_bytes"] * _WIRE[k] for k, v in by_kind.items())
    return {"by_kind": by_kind, "wire_bytes": wire}


def fake_mesh(sizes: tuple, names: tuple):
    """A ``DeviceMesh`` of ``sizes`` over a new fake group of as many ranks
    (a 1 x 1 or a small mesh for tests; ``make_production_mesh`` for the
    production ones)."""
    from torch.distributed.device_mesh import init_device_mesh
    init_fake_group(math.prod(sizes))
    return init_device_mesh("cpu", tuple(sizes), mesh_dim_names=tuple(names))


def measure(cfg, shape: str, mesh, batch_shapes: dict | None = None,
            cache_len: int | None = None) -> dict:
    """Trace the step once and return JAX's per-device entries: memory,
    FLOPs, bytes, collectives and the ops run replicated."""
    args, out, tally, counts = trace_step(cfg, shape, mesh, batch_shapes,
                                          cache_len)
    return {
        "memory": {
            "argument_size_in_bytes": local_bytes(args),
            "output_size_in_bytes": local_bytes(out),
            "temp_size_in_bytes": tally.peak,
            "generated_code_size_in_bytes": None,
            "alias_size_in_bytes": None,
        },
        "flops_per_device": tally.flops,
        "bytes_per_device": tally.bytes,
        "collectives": collectives(tally, counts),
        "replicated_ops": sorted(tally.replicated),
    }


def roofline(flops: float, bytes_acc: float, wire_bytes: float) -> dict:
    """The three per-device terms against the H100 constants and the
    largest of them."""
    terms = {"compute_s": flops / PEAK_FLOPS, "memory_s": bytes_acc / HBM_BW,
             "collective_s": wire_bytes / LINK_BW}
    return {**terms, "collective_s_nvlink": wire_bytes / NVLINK_BW,
            "bottleneck": max(terms, key=terms.get)[:-2]}


def run_one(arch: str, shape: str, multi_pod: bool = False,
            moe_impl: str | None = None, remat: bool | None = None,
            outdir: str = "results/dryrun_torch", tag: str = "",
            overrides: dict | None = None) -> dict:
    """Trace one arch x shape on a production mesh and write its JSON to
    ``outdir``; returns it."""
    sizes, _ = mesh_lib.production_shape(multi_pod)
    chips = math.prod(sizes)
    mesh_name = "x".join(map(str, sizes))
    init_fake_group(chips)
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                         device_type="cpu")
    cfg = build_config(arch, shape, moe_impl=moe_impl, remat=remat,
                       overrides=overrides)
    t0 = time.time()
    m = measure(cfg, shape, mesh)
    trace_s = time.time() - t0
    flops = m["flops_per_device"]
    mf = model_flops(cfg, shape)
    res = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "chips": chips,
        "tag": tag or None, "moe_impl": moe_impl, "remat": remat,
        "overrides": overrides or None,
        "ok": True, "extrapolated": False,
        "trace_s": round(trace_s, 1),
        "memory": m["memory"],
        "flops_per_device": flops,
        "bytes_per_device": m["bytes_per_device"],
        "collectives": m["collectives"],
        "roofline": roofline(flops, m["bytes_per_device"],
                             m["collectives"]["wire_bytes"]),
        "model_flops_total": mf,
        "model_flops_per_device": mf / chips,
        "useful_flops_ratio": (mf / chips) / flops if flops else None,
        "params_total": param_count(cfg),
        "params_active": param_count(cfg, active_only=True),
        "replicated_ops": m["replicated_ops"],
        "constants": CONSTANTS,
    }
    os.makedirs(outdir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(outdir, f"{arch}__{shape}__{mesh_name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return res


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--moe-impl", default=None)
    ap.add_argument("--remat", default=None, choices=[None, "on", "off"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--set", dest="overrides", default=None,
                    help="comma-separated cfg overrides, e.g. "
                         "attention_impl=chunked,chunked_ce=true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--outdir", default="results/dryrun_torch")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    remat = None if args.remat is None else (args.remat == "on")
    overrides = None
    if args.overrides:
        overrides = dict(kv.split("=", 1) for kv in args.overrides.split(","))
    combos = []
    if args.all:
        for arch in configs.ALIASES:
            for shape in configs.SHAPES:
                combos.append((arch, shape))
    else:
        if args.arch is None or args.shape is None:
            raise SystemExit("give --arch and --shape, or --all")
        combos.append((args.arch, args.shape))

    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    failures = []
    for arch, shape in combos:
        suffix = f"__{args.tag}" if args.tag else ""
        path = os.path.join(args.outdir,
                            f"{arch}__{shape}__{mesh_name}{suffix}.json")
        if args.skip_existing and os.path.exists(path):
            print(f"[skip] {arch} {shape} {mesh_name}")
            continue
        t0 = time.time()
        try:
            res = run_one(arch, shape, multi_pod=args.multi_pod,
                          moe_impl=args.moe_impl, remat=remat,
                          outdir=args.outdir, tag=args.tag,
                          overrides=overrides)
            r = res["roofline"]
            print(f"[ok]   {arch:22s} {shape:12s} {mesh_name}  "
                  f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
                  f"coll={r['collective_s']:.3e}s -> {r['bottleneck']}  "
                  f"({time.time()-t0:.0f}s)", flush=True)
        except Exception as e:
            failures.append((arch, shape, str(e)))
            print(f"[FAIL] {arch} {shape} {mesh_name}: {e}", flush=True)
            traceback.print_exc(limit=3)
    if failures:
        print(f"\n{len(failures)} failures")
        raise SystemExit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
