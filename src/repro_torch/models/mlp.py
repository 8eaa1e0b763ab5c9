"""Feed-forward layers: SwiGLU (or GELU without the up projection) and the
Mixture-of-Experts layer. A port of ``repro.models.mlp``.

The MoE layer follows DeepSeekMoE (arXiv:2401.06066): optional shared
experts (always active) and fine-grained routed experts with top-k softmax
gating and a Switch-style load-balance loss. Its weights live in an
``MoE`` module; the paths are plain functions on tensors, as in JAX:

- ``dense``: every expert runs on every token, the outputs combined by the
  gates (E/k times the active FLOPs; JAX's default);
- ``ragged``: the (token, k) assignments sorted by expert and three
  grouped products over the expert groups (``grouped_mm``), compute
  proportional to the active experts, dropless;
- ``ep``: the body of expert parallelism over a ``ShardMesh``'s ``model``
  axis (``moe_ep_path``): each rank runs the assignments routed to its
  ``E / K`` experts in capacity buffers and the ranks' outputs are summed;
  without a mesh with a ``model`` axis, JAX's single-shard semantics
  (routing, then the dense path).

Nothing here reads the card back: the routing, the sort, the group offsets
and the capacity slots stay on the device.
"""
from __future__ import annotations

import functools
import math
import types

import torch
from torch import nn

from repro_torch.analysis import spans
from repro_torch.device import no_tf32
from repro_torch.models.common import (ModelConfig, dense, init_dense,
                                       per_shard, trunc_normal)

#: the MoE execution paths (``ModelConfig.moe_impl``)
MOE_IMPLS = ("dense", "ragged", "ep")


class MLP(nn.Module):
    """wg and wd, plus wu for SwiGLU; (d_in, d_out) each."""

    def __init__(self, d_model: int, d_ff: int, dtype, kind: str = "swiglu",
                 device=None):
        super().__init__()
        if kind not in ("swiglu", "gelu"):
            raise ValueError(f"mlp kind must be 'swiglu' or 'gelu', got "
                             f"{kind!r}")

        def weight(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.wg = weight(d_model, d_ff)
        self.wu = weight(d_model, d_ff) if kind == "swiglu" else None
        self.wd = weight(d_ff, d_model)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         num_layers: int) -> None:
        (d_model, d_ff), dt = self.wg.shape, self.wg.dtype
        self.wg.copy_(init_dense(generator, d_model, d_ff, dt))
        if self.wu is not None:
            self.wu.copy_(init_dense(generator, d_model, d_ff, dt))
        self.wd.copy_(init_dense(generator, d_ff, d_model, dt,
                                 scale=1.0 / math.sqrt(d_ff * 2 * num_layers)))


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: wd(silu(x wg) * (x wu)); GELU (no wu): wd(gelu(x wg)), the
    tanh form in f32, as ``jax.nn.gelu`` computes it by default."""
    h = dense(x, p.wg)
    if p.wu is not None:
        h = torch.nn.functional.silu(h) * dense(x, p.wu)
    else:
        h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(x.dtype)
    return dense(h, p.wd)


# ---------------------------------------------------------------------------
# Mixture of Experts


class MoE(nn.Module):
    """The router (d_model, E), kept in f32; the expert stacks ``wg``,
    ``wu`` (E, d_model, Fe) and ``wd`` (E, Fe, d_model) in
    ``cfg.param_dtype``; and, with shared experts, ``shared``: one SwiGLU
    ``MLP`` of width ``Fe * num_shared_experts``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, fe, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts

        def weight(*shape, dtype=cfg.param_dtype):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.router = weight(d, e, dtype=torch.float32)
        self.wg = weight(e, d, fe)
        self.wu = weight(e, d, fe)
        self.wd = weight(e, fe, d)
        self.shared = (MLP(d, fe * cfg.num_shared_experts, cfg.param_dtype,
                           device=device)
                       if cfg.num_shared_experts else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         cfg: ModelConfig) -> None:
        """JAX's ``init_moe`` scales: the router as a dense layer in f32,
        the expert stacks truncated normal in ±2σ scaled by 1/√d_model
        (``wg``, ``wu``) and 1/√(2 L Fe) (``wd``)."""
        (e, d, fe), dt = self.wg.shape, self.wg.dtype
        self.router.copy_(init_dense(generator, d, e, torch.float32))
        scale_in = 1.0 / math.sqrt(d)
        scale_out = 1.0 / math.sqrt(fe * 2 * cfg.num_layers)
        self.wg.copy_((scale_in * trunc_normal(generator, (e, d, fe))).to(dt))
        self.wu.copy_((scale_in * trunc_normal(generator, (e, d, fe))).to(dt))
        self.wd.copy_((scale_out * trunc_normal(generator, (e, fe, d))).to(dt))
        if self.shared is not None:
            self.shared.reset_parameters(generator, cfg.num_layers)


def _routing(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """x: (T, D) -> (gates (T, E) f32, zero outside the top k; top_i (T, k)
    int64; top_p (T, k) f32, renormalised; aux, the 0-d f32 Switch loss
    ``E * sum_e f_e * P_e``).

    The router product runs in full f32 (a TF32 product flips top-k
    choices). The top k come from a stable descending sort, so that of
    tied probabilities the lower expert index wins, as ``jax.lax.top_k``
    orders them (``torch.topk`` promises no order on ties)."""
    with no_tf32():
        logits = x.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = vals[:, :k], idx[:, :k]
    # renormalise the selected gates (deepseek-moe style)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    gates = torch.zeros_like(probs).scatter(1, top_i, top_p)
    f = (gates > 0).float().mean(0)             # fraction routed
    aux = cfg.num_experts * torch.sum(f * probs.mean(0))
    return gates, top_i, top_p, aux


class _F32Product(torch.autograd.Function):
    """Batched ``a @ b`` of low-precision operands, accumulated and
    returned in f32: JAX's ``preferred_element_type=f32``. On the card
    cuBLAS writes the f32 sums itself (``torch.bmm(out_dtype=)``, which has
    no derivative); on the CPU the operands are widened, which is exact.
    The gradients are f32 products of the widened operands, cast to the
    operands' dtypes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with no_tf32():
            if ctx.needs_input_grad[0]:
                ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
            if ctx.needs_input_grad[1]:
                gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return ga, gb


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(G, M, K) @ (G, K, N) -> (G, M, N) f32, f32 accumulation."""
    if a.dtype == torch.float32:
        with no_tf32():
            return torch.bmm(a, b)
    return _F32Product.apply(a, b)


def _contiguous(g: torch.Tensor) -> torch.Tensor:
    return g.contiguous()


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               offs: torch.Tensor) -> torch.Tensor:
    """The grouped product of JAX's ``ragged_dot``: rows ``offs[e-1]:
    offs[e]`` of ``x`` (T, K) times ``w[e]`` (K, N), ``offs`` (E,) int32
    the groups' cumulative ends on ``x``'s device; (T, N) in x's dtype.

    ``torch._grouped_mm``: on the card in bf16 a CUTLASS grouped GEMM that
    reads the offsets on the device (no host read); otherwise (f32, as at
    the smoke widths, and on the CPU) PyTorch's loop over the groups,
    which reads them on the host. Its backward needs a contiguous incoming
    gradient, which the hook makes sure of."""
    y = torch._grouped_mm(x, w, offs=offs)
    if y.requires_grad:
        y.register_hook(_contiguous)
    return y


def grouped_mm_ref(x: torch.Tensor, w: torch.Tensor,
                   offs: torch.Tensor) -> torch.Tensor:
    """``grouped_mm``'s plain version: one ``dense`` product an expert over
    its rows. It reads the offsets on the host, so it is a reference for
    tests, not a path."""
    out, start = [], 0
    for e, end in enumerate(offs.tolist()):
        out.append(dense(x[start:end], w[e]))
        start = end
    return torch.cat(out)


def group_offsets(sorted_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """(E,) int32 cumulative ends of the expert groups of ascending expert
    ids, computed on their device (``bincount`` would read its maximum on
    the host)."""
    bounds = torch.arange(1, num_experts + 1, device=sorted_e.device)
    return torch.searchsorted(sorted_e, bounds).to(torch.int32)


def moe_dense_path(p: MoE, x2d: torch.Tensor, gates: torch.Tensor,
                   dtype) -> torch.Tensor:
    """Every expert on every token; outputs combined by the gates.
    x2d: (T, D); gates: (T, E). JAX's casts: the gate and up products
    accumulated in f32 and rounded to ``dtype``, ``silu`` in ``dtype``,
    the down product (E, T, D) kept in f32 and combined in f32."""
    h_g = dense(x2d, p.wg.to(dtype))                # (E, T, Fe)
    h_u = dense(x2d, p.wu.to(dtype))
    h = torch.nn.functional.silu(h_g) * h_u
    y = _bmm_f32(h, p.wd.to(dtype))                 # (E, T, D) f32
    return (y * gates.t().float()[:, :, None]).sum(0).to(dtype)


def moe_ragged_path(p: MoE, x2d: torch.Tensor, top_i: torch.Tensor,
                    top_p: torch.Tensor, cfg: ModelConfig,
                    dtype) -> torch.Tensor:
    """Sort the (token, k) assignments by expert (stable, as JAX's
    ``argsort``) and run the three grouped products over the groups, the
    group sizes kept on the device; ``silu`` in f32 here. Each assignment's
    output goes back to its (token, k) place and the k of a token are
    summed in f32, weighted by the gates (JAX's scatter-add, in a fixed
    order: no atomics). Dropless. x2d: (T, D)."""
    t, d = x2d.shape
    k = cfg.experts_per_token
    flat_e = top_i.reshape(-1)                                  # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    rows = torch.div(order, k, rounding_mode="floor")           # token ids
    offs = group_offsets(flat_e[order], cfg.num_experts)
    xs = x2d.to(dtype)[rows]                                    # (T*k, D)
    hg = grouped_mm(xs, p.wg.to(dtype), offs)
    hu = grouped_mm(xs, p.wu.to(dtype), offs)
    h = (torch.nn.functional.silu(hg.float()) * hu.float()).to(dtype)
    ys = grouped_mm(h, p.wd.to(dtype), offs)
    ys = ys[torch.argsort(order)].float().view(t, k, d)         # unsorted
    return (ys * top_p.float()[:, :, None]).sum(1).to(dtype)


def _ragged(x2d, top_i, top_p, wg, wu, wd, *, cfg: ModelConfig, dtype):
    return moe_ragged_path(types.SimpleNamespace(wg=wg, wu=wu, wd=wd), x2d,
                           top_i, top_p, cfg, dtype)


def moe_ep_path(w, x2d: torch.Tensor, top_i: torch.Tensor,
                top_p: torch.Tensor, cfg: ModelConfig, dtype, mesh=None,
                model_axis: str = "model",
                capacity_factor: float = 2.0) -> torch.Tensor:
    """The body of expert parallelism on one rank of ``mesh``'s
    ``model_axis``. ``w`` maps ``wg``, ``wu``, ``wd`` to this rank's
    experts, ``E_loc = E / K`` of them, the rank at coordinate ``r``
    owning experts ``r E_loc ..``; the tokens are every rank's.

    Each assignment routed to a local expert takes the next slot of its
    expert's capacity buffer, ``max(8, int(cf T k / E))`` slots, in flat
    (token, k) order (a cumulative sum); assignments past the capacity,
    and those of other ranks' experts, are dropped into a trash slot. The
    experts run as (E_loc, cap, .) batched products, the kept outputs are
    weighted by their gates and summed per token in f32, and the ranks'
    sums are added (``mesh.psum``). ``mesh=None`` is one rank owning every
    expert."""
    t, d = x2d.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    e_loc = w["wg"].shape[0]
    cap = max(8, int(capacity_factor * t * k / e))
    e0 = (mesh.axis_index(model_axis) if mesh is not None else 0) * e_loc
    dev = x2d.device

    flat_e = top_i.reshape(-1)                                  # (T*k,)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    local = (flat_e >= e0) & (flat_e < e0 + e_loc)
    el = torch.clamp(flat_e - e0, 0, e_loc - 1)
    # each assignment's slot in its expert's capacity buffer
    onehot = (torch.nn.functional.one_hot(el, e_loc).to(torch.int32)
              * local[:, None].to(torch.int32))                 # (T*k, E_loc)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    slot = torch.sum(pos * onehot, dim=1)                       # (T*k,)
    keep = local & (slot < cap)
    # dispatch into (E_loc, cap, D); dropped and other ranks' assignments
    # write the zero row into the trash slot (index cap)
    src = torch.where(keep, flat_t, t)
    xpad = torch.cat([x2d.to(dtype), x2d.new_zeros((1, d), dtype=dtype)])
    slot_w = torch.where(keep, slot, cap).long()
    buf = xpad.new_zeros((e_loc, cap + 1, d)).index_put(
        (el, slot_w), xpad[src])[:, :cap]
    hg = _bmm_f32(buf, w["wg"].to(dtype))                       # f32
    hu = _bmm_f32(buf, w["wu"].to(dtype))
    h = (torch.nn.functional.silu(hg) * hu).to(dtype)
    yb = _bmm_f32(h, w["wd"].to(dtype))             # (E_loc, cap, D) f32
    # combine: each kept assignment's row, weighted by its gate
    vals = yb[el, torch.clamp(slot, max=cap - 1).long()]
    vals = vals * (top_p.reshape(-1).float() * keep.float())[:, None]
    y = vals.view(t, k, d).sum(1)
    if mesh is not None:
        y = mesh.psum(y, model_axis)
    return y.to(dtype)


def _ep_body(router, local, x2d, cfg: ModelConfig, dtype, mesh):
    """One rank's expert parallelism: routing over all E, ``moe_ep_path``
    on its experts ``local`` (``wg``, ``wu``, ``wd``); the aux loss averaged
    over the ``model`` axis and the data axes, as JAX's ``shard_map`` body
    does."""
    _, top_i, top_p, aux = _routing(types.SimpleNamespace(router=router),
                                    x2d, cfg)
    y = moe_ep_path(local, x2d, top_i, top_p, cfg, dtype, mesh,
                    capacity_factor=cfg.moe_capacity_factor)
    for axis in ("model", "pod", "data"):
        if axis in mesh.shape:
            aux = mesh.psum(aux, axis) / mesh.shape[axis]
    return y, aux


def _moe_ep_mesh(p: MoE, x2d: torch.Tensor, cfg: ModelConfig, dtype, mesh):
    """``moe_ep_path`` on this rank's slice of the experts (the module
    holds all E on every rank)."""
    e_loc = cfg.num_experts // mesh.shape["model"]
    lo = mesh.axis_index("model") * e_loc
    local = {name: getattr(p, name)[lo:lo + e_loc]
             for name in ("wg", "wu", "wd")}
    return _ep_body(p.router, local, x2d, cfg, dtype, mesh)


def _moe_ep_dtensor(p: MoE, x2d, cfg: ModelConfig, dtype):
    """Expert parallelism on DTensor weights (the dry run), JAX's
    ``shard_map`` of the body: ``_ep_body`` under ``local_map`` with the
    expert stacks sharded over ``model`` on E, the router replicated, the
    tokens sharded over the data axes and replicated over ``model``, its
    collectives over the ``DeviceMesh``'s dims (``DeviceMeshAxes``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.compat import DeviceMeshAxes
    mesh = DeviceMeshAxes(p.wg.device_mesh)
    names = mesh.axis_names
    experts = [Shard(0) if a == "model" else Replicate() for a in names]
    tokens = [Shard(0) if a in ("pod", "data") else Replicate()
              for a in names]
    rep = [Replicate()] * len(names)
    # local gradients: the experts' sum over the data axes' tokens, the
    # tokens' over the model axis's experts, the router's over both
    experts_grad = [Shard(0) if a == "model" else Partial() for a in names]
    tokens_grad = [Shard(0) if a in ("pod", "data") else Partial()
                   for a in names]
    router_grad = [Partial()] * len(names)

    def body(router, wg, wu, wd, x_loc):
        return _ep_body(router, {"wg": wg, "wu": wu, "wd": wd}, x_loc, cfg,
                        dtype, mesh)

    return local_map(body, out_placements=(tokens, rep),
                     in_placements=(rep, experts, experts, experts, tokens),
                     in_grad_placements=(router_grad, experts_grad,
                                         experts_grad, experts_grad,
                                         tokens_grad),
                     device_mesh=mesh.mesh, redistribute_inputs=True)(
        p.router, p.wg, p.wu, p.wd, x2d)


def _on_model_axis(w) -> bool:
    """Whether ``w`` is a DTensor on a mesh with a ``model`` dim."""
    from torch.distributed.tensor import DTensor
    return (isinstance(w, DTensor)
            and "model" in (w.device_mesh.mesh_dim_names or ()))


def moe(p: MoE, x: torch.Tensor, cfg: ModelConfig, mesh=None):
    """x: (B, S, D) -> ((B, S, D), aux). ``cfg.moe_impl`` picks the path;
    ``ep`` runs over ``mesh``'s ``model`` axis, or over the ``model`` dim
    of DTensor weights' ``DeviceMesh`` (the dry run), and without either
    it is routing and the dense path (JAX's single-shard fallback).
    The shared experts, if any, run on every token (``mlp``)."""
    with spans.span("moe"):
        if cfg.moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl must be one of {MOE_IMPLS}, got "
                             f"{cfg.moe_impl!r}")
        b, s, d = x.shape
        x2d = x.reshape(b * s, d)
        if cfg.moe_impl == "ep" and mesh is not None and "model" in mesh.shape:
            y, aux = _moe_ep_mesh(p, x2d, cfg, x.dtype, mesh)
        elif cfg.moe_impl == "ep" and _on_model_axis(p.wg):
            y, aux = _moe_ep_dtensor(p, x2d, cfg, x.dtype)
        else:
            gates, top_i, top_p, aux = _routing(p, x2d, cfg)
            if cfg.moe_impl == "ragged":
                # tokens are independent: on DTensors each data shard runs the
                # sort and the grouped products on its own tokens, all experts
                y = per_shard(
                    functools.partial(_ragged, cfg=cfg, dtype=x.dtype),
                    (x2d, top_i, top_p, p.wg, p.wu, p.wd),
                    ((0,), (0,), (0,), (None,), (None,), (None,)), (0,))
            else:
                y = moe_dense_path(p, x2d, gates, x.dtype)
        if p.shared is not None:
            y = y + mlp(p.shared, x2d)
        return spans.mark_backward("moe", x, y.reshape(b, s, d)), aux
