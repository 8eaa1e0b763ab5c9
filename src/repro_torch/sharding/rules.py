"""Parameter, batch, cache and train-state leaf -> partition spec rules for
the production meshes, a port of ``repro.sharding.rules``.

Megatron-style tensor parallelism over the ``model`` axis, batch parallelism
over ``data`` (and ``pod``): column-parallel in-projections, row-parallel
out-projections, expert-parallel MoE weights, vocab-sharded embeddings.
Rules are name-based on the last dims of each leaf; leading dims are padded
with None, so the same table covers the JAX package's stacked leaves and its
tails. Divisibility is checked against the mesh: a dim that does not divide
falls back to replication (never an invalid sharding).

The port keeps one tensor a layer of a stack (``blocks.3.attn.wq``), where
JAX's tree stacks the layers on a leading axis; the spec of a port leaf is
JAX's spec of the stacked leaf without its first (layer) entry, since the
rules read only the trailing dims. Caches keep JAX's layout (a stack's
leaves carry the layer axis), so their specs are JAX's.

A spec is a ``P``: a tuple with one entry per tensor dim, each None, an
axis name or a tuple of axis names, equal to JAX's ``PartitionSpec`` of the
same entries. A mesh is anything with a name -> size ``shape`` (a
``ShardMesh``, an ``AbstractMesh``) or a ``DeviceMesh`` with dim names;
``placements`` turns a spec into DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

# rule: leaf-name -> spec for its trailing dims (None entries replicate)
_PARAM_RULES = {
    # embeddings / heads
    "embed": ("model", None),          # (V, D) vocab-sharded
    "unembed": (None, "model"),        # (D, V)
    "pos_embed": (None, None),
    "enc_pos_embed": (None, None),
    # attention
    "wq": (None, "model"),
    "wk": (None, "model"),
    "wv": (None, "model"),
    "wo": ("model", None),
    # mlp
    "wg": (None, "model"),
    "wu": (None, "model"),
    "wd": ("model", None),
    # moe (expert-parallel; per-leaf 3D)
    "router": (None, None),
    # ssm
    "w_in": (None, "model"),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "a_log": (None,),
    "dt_bias": (None,),
    "d_skip": (None,),
    "norm_scale": ("model",),
    "w_out": ("model", None),
    # rglru
    "w_x": (None, "model"),
    "w_gate": (None, "model"),
    "w_a": (None, "model"),
    "b_a": ("model",),
    "w_i": (None, "model"),
    "b_i": ("model",),
    "lam": ("model",),
}

_MOE_EXPERT_LEAVES = {"wg", "wu", "wd"}  # 3D (E, ., .) under a "moe" subtree


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def mesh_shape(mesh) -> dict:
    """The mesh's axis name -> size: ``mesh.shape`` of a ``ShardMesh`` or an
    ``AbstractMesh``, the named dims of a ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _divides(total: int, shape: dict, axes) -> bool:
    if axes is None:
        return True
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= shape[a]
    return total % size == 0


def _spec_for(names, leaf_shape, shape: dict, model_axis: str) -> P:
    name = names[-1] if names else ""
    in_moe = "moe" in names and "shared" not in names
    if in_moe and name in _MOE_EXPERT_LEAVES and len(leaf_shape) >= 3:
        # (..., E, d_in, d_out): expert-parallel on E
        rule = (model_axis, None, None)
    elif name in _PARAM_RULES:
        rule = tuple(model_axis if r == "model" else r
                     for r in _PARAM_RULES[name])
    else:
        rule = ()
    # pad with leading None for leading dims
    pad = len(leaf_shape) - len(rule)
    if pad < 0:
        rule = rule[-len(leaf_shape):] if len(leaf_shape) else ()
        pad = 0
    full = (None,) * pad + rule
    # divisibility fallback
    return P(*(ax if (ax is None or _divides(leaf_shape[i], shape, ax))
               else None for i, ax in enumerate(full)))


def _named(model_or_named_params) -> dict:
    if isinstance(model_or_named_params, torch.nn.Module):
        return dict(model_or_named_params.named_parameters())
    return dict(model_or_named_params)


def param_specs(model_or_named_params, mesh,
                model_axis: str = "model") -> dict:
    """Parameter name -> ``P`` for a ``Transformer`` (its
    ``named_parameters()``, on any device, ``meta`` included) or a dict of
    name -> tensor of the same names."""
    shape = mesh_shape(mesh)
    return {name: _spec_for(name.split("."), tuple(t.shape), shape,
                            model_axis)
            for name, t in _named(model_or_named_params).items()}


def _replicated(tree):
    return pytree.tree_map(lambda _: P(), tree)


def train_state_specs(state, mesh, model_axis: str = "model"):
    """Specs of a ``training.train_step.TrainState``, in its shape: params
    and both Adam moments (name -> ``P``) share the parameters' specs, the
    steps are ``P()``, the probe's leaves are replicated."""
    p_specs = param_specs(state.params, mesh, model_axis)
    opt = type(state.opt)(mu={k: p_specs[k] for k in state.opt.mu},
                          nu={k: p_specs[k] for k in state.opt.nu},
                          step=P())
    probe = None if state.probe is None else _replicated(state.probe)
    return type(state)(params=p_specs, opt=opt, step=P(), probe=probe)


def _dp_spec(shape: dict, data_axes):
    dp = tuple(a for a in data_axes if a in shape)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def batch_specs(batch: dict, mesh, *, data_axes=("data",)) -> dict:
    """Input batch specs: leading batch dim over the data axes (replicated
    if it does not divide); ``positions3`` has its batch second."""
    shape = mesh_shape(mesh)
    dp_spec = _dp_spec(shape, data_axes)

    def one(name, leaf):
        if name == "positions3":
            if _divides(leaf.shape[1], shape, dp_spec):
                return P(None, dp_spec)
            return P()
        if leaf.dim() >= 1 and _divides(leaf.shape[0], shape, dp_spec):
            return P(dp_spec)
        return P()

    return {name: one(name, leaf) for name, leaf in batch.items()}


# unstacked (tail-block) cache ranks per leaf kind
_TAIL_NDIM = {"k": 4, "v": 4, "cross_k": 4, "cross_v": 4,
              "conv": 3, "state": 4, "h": 2}


def cache_specs(cache: dict, mesh, *, data_axes=("data",),
                model_axis: str = "model") -> dict:
    """KV / recurrent cache specs, the cache's nesting kept.

    Per-leaf preference order (first that divides): batch over data axes,
    then one more axis over ``model``: heads if divisible, else the
    sequence / state axis. Leaves that fit nothing replicate."""
    shape = mesh_shape(mesh)
    dp_spec = _dp_spec(shape, data_axes)

    def one(name, leaf_shape):
        spec = [None] * len(leaf_shape)
        # layer-stacked caches carry a leading L dim over the tail rank
        bdim = 1 if (name in _TAIL_NDIM
                     and len(leaf_shape) > _TAIL_NDIM[name]) else 0
        if len(leaf_shape) > bdim and _divides(leaf_shape[bdim], shape,
                                                dp_spec):
            spec[bdim] = dp_spec
        n = len(leaf_shape)
        if name in ("k", "v", "cross_k", "cross_v"):
            # (L, B, S, Hkv, hd) or (B, S, Hkv, hd)
            hdim, sdim = n - 2, n - 3
            if _divides(leaf_shape[hdim], shape, model_axis):
                spec[hdim] = model_axis
            elif _divides(leaf_shape[sdim], shape, model_axis):
                spec[sdim] = model_axis
        else:
            # conv (.., cw - 1, W): its width; state (.., H, P, N): its
            # heads; h (.., W): its width
            mdim = {"conv": n - 1, "state": n - 3, "h": n - 1}.get(name)
            if mdim is not None and _divides(leaf_shape[mdim], shape,
                                             model_axis):
                spec[mdim] = model_axis
        return P(*spec)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else one(k, tuple(v.shape)) for k, v in node.items()}

    return walk(cache)


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on a ``DeviceMesh`` with dim
    names: for each mesh dim, ``Shard(d)`` where the spec names that axis
    at tensor dim d, else ``Replicate()``. An entry of several axes
    (``("pod", "data")``) shards its dim over each of them; it must name
    them in the mesh's order, which is JAX's row-major order of the
    shards."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"spec entry {entry!r} names the mesh axes out "
                             f"of the mesh's order {tuple(names)}")
        for i in where:
            out[i] = Shard(d)
    return tuple(out)

