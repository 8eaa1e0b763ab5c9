"""Shared model configuration and primitive layers, in PyTorch.

A copy of ``repro.models.common`` for the port. Conventions:

- Dense weights are stored (d_in, d_out), as in the JAX package, so that
  ``dense`` is ``x @ w`` and weights carry across without a transpose.
- Weights are stored in ``cfg.param_dtype`` (bf16 by default, the serving
  layout); products run in the activation dtype with f32 accumulation
  (cuBLAS accumulates bf16 products in f32; f32 products run in full f32,
  never TF32); norms and softmax run in f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.analysis import spans
from repro_torch.device import no_tf32

# ---------------------------------------------------------------------------
# Config


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_type: str = "dense"      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: int = 0             # 0 -> d_model // num_heads
    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0   # leading dense FFN layers (deepseek-moe)
    first_dense_d_ff: int = 0
    moe_impl: str = "dense"       # dense (all-experts einsum) | ragged
                                  # (ragged_dot) | ep (shard_map expert par.)
    moe_capacity_factor: float = 2.0
    router_aux_coef: float = 0.01
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # hybrid (recurrentgemma): pattern over a repeating block
    block_pattern: tuple = ()     # e.g. ("rglru", "rglru", "attn")
    pattern_tail: tuple = ()      # leftover layers after full pattern repeats
    lru_width: int = 0            # 0 -> d_model
    # attention windowing (local attention / long-context serving)
    window: int = 0               # 0 = full causal; >0 = sliding window
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500
    learned_positions: bool = False
    max_positions: int = 0        # learned-position table size (0 -> 8192)
    # vlm (qwen2-vl)
    mrope_sections: tuple = ()    # e.g. (16, 24, 24) halves of head_dim/2
    num_patches: int = 0          # vision token count fed by the stub frontend
    rope_theta: float = 10_000.0
    mlp_kind: str = "swiglu"      # swiglu | gelu (whisper-style)
    # naive: materialise (S, S) scores; chunked: flash-style online softmax
    # over KV blocks (no quadratic buffer)
    attention_impl: str = "naive"
    # Zero-pad the (post-GQA-repeat) head axis up to this count inside the
    # attention computation. Exact (padded heads have zero V and zero wo
    # rows); kept so that configs copy over verbatim.
    pad_heads_to: int = 0
    attention_chunk: int = 512
    # store attention probabilities in bf16 between softmax and the PV matmul
    # (max/denominator stay f32) — halves the largest attention intermediate
    attention_probs_bf16: bool = False
    # bf16 row-parallel partial sums (a tensor-parallel option of the JAX
    # package; one card has no partial sums, so the port ignores it)
    bf16_partials: bool = False
    # compute the LM cross-entropy over sequence chunks (training only)
    chunked_ce: bool = False
    ce_chunk: int = 512
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16   # activation/compute dtype
    param_dtype: Any = torch.bfloat16
    remat: bool = True            # checkpoint each block in training
    unroll_layers: bool = False   # JAX lowering option; the port always loops

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.hd

    @property
    def d_inner(self) -> int:          # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rnn_width(self) -> int:
        return self.lru_width or self.d_model


# ---------------------------------------------------------------------------
# Primitive ops


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm with a zero-centred scale: ``x / rms(x) * (1 + scale)``, in
    f32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with f32 accumulation, output in x's dtype. w: (d_in, d_out).

    A bf16 product goes to cuBLAS, which accumulates in f32 and rounds once
    to bf16, as the JAX package's ``preferred_element_type=f32`` followed by
    a cast does; an f32 product runs in full f32 (``no_tf32``). On
    DTensors a row-parallel product's partial sums are all-reduced here
    (``replicate_partial``), as Megatron does after ``wo`` and ``wd``."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        with no_tf32():
            return replicate_partial(x @ w)
    return replicate_partial(x @ w)


def replicate_partial(y: torch.Tensor) -> torch.Tensor:
    """``y``, with a DTensor's partial sums reduced to a replicated value;
    a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(y, DTensor) and any(p.is_partial() for p in y.placements):
        return y.redistribute(placements=[Replicate() if p.is_partial()
                                          else p for p in y.placements])
    return y


def placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` (a gradient) with ``p``'s (its parameter's) placements where
    both are DTensors: its partial sums over the data axes all-reduced, or
    reduce-scattered onto a sharded parameter, once; else ``g``."""
    from torch.distributed.tensor import DTensor
    if isinstance(g, DTensor) and isinstance(p, DTensor) \
            and g.placements != p.placements:
        return g.redistribute(placements=p.placements)
    return g


def shard_block(mesh, mesh_dims) -> int:
    """Which block of a tensor dim sharded over ``mesh_dims`` (in mesh
    order) this rank holds."""
    coord = mesh.get_coordinate()
    block = 0
    for m in mesh_dims:
        block = block * mesh.size(m) + coord[m]
    return block


def take_sharded(take, x: torch.Tensor, dim: int, idx: torch.Tensor):
    """``take(x, idx)`` (rows of ``x`` along ``dim`` at integer ``idx``) on
    the local shards of a DTensor ``x``; None for a plain tensor. Where
    ``x`` is sharded along ``dim`` (a vocab-sharded table or logits) each
    rank takes the rows it holds, zeros the others, and the ranks' results
    are all-reduced, as Megatron's vocab-parallel layers do. ``idx`` shards
    as the result does on the other mesh dims. DTensor's own indexing and
    gather would gather, or scatter in the backward pass, at the full
    global size."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(x, DTensor):
        return None
    mesh, dim = x.device_mesh, dim % x.dim()
    on = [m for m, p in enumerate(x.placements)
          if isinstance(p, Shard) and p.dim == dim]
    if not isinstance(idx, DTensor):        # a replicated value
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    idx = idx.redistribute(placements=[Replicate() if m in on else p
                                       for m, p in enumerate(idx.placements)])
    block = shard_block(mesh, on)

    def local(t, i):
        if not on:
            return take(t, i)
        j = i.long() - block * t.shape[dim]
        ok = (j >= 0) & (j < t.shape[dim])
        out = take(t, torch.where(ok, j, 0))
        return out * ok.reshape(ok.shape + (1,) * (out.dim() - ok.dim())
                                ).to(out.dtype)

    def summed(t, i):
        from repro_torch.sharding.compat import SumOver
        return SumOver.apply(local(t, i), mesh, tuple(on))

    from torch.distributed.tensor.experimental import local_map
    out_pl = [Replicate() if m in on else p
              for m, p in enumerate(idx.placements)]
    # x's local gradient sums over the mesh dims that split idx alone
    x_grad = [Partial() if m not in on and isinstance(q, Shard)
              and not isinstance(p, Shard) else p
              for m, (p, q) in enumerate(zip(x.placements, idx.placements))]
    return local_map(summed, out_placements=(out_pl,),
                     in_placements=(x.placements, idx.placements),
                     in_grad_placements=(x_grad, idx.placements),
                     device_mesh=mesh)(x, idx)


def whole_groups(x: torch.Tensor, dim: int, groups: int) -> torch.Tensor:
    """``x``, with a DTensor's ``dim`` gathered (replicated) where its
    shards would cut one of ``groups`` equal groups of that dim (heads of a
    projection about to be split); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    on = [m for m, p in enumerate(x.placements)
          if isinstance(p, Shard) and p.dim == dim]
    if groups % math.prod(x.device_mesh.size(m) for m in on) == 0:
        return x
    return replicate_dim(x, dim)


def replicate_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x``, with a DTensor's ``dim`` gathered (replicated on every mesh
    dim that shards it); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    return x.redistribute(placements=[
        Replicate() if isinstance(p, Shard) and p.dim == dim else p
        for p in x.placements])


def per_shard(fn, args: tuple, dims: tuple, out_dims):
    """``fn(*args)``; where ``args[0]`` is a DTensor (the dry run,
    ``repro_torch.launch.dryrun``), ``fn`` runs on each rank's local shards
    instead, under ``local_map``. ``dims[i]`` names, for argument i, its
    dims in a fixed order of roles (say (batch, head)), None for a role it
    lacks (replicated along it), or is None for an argument passed as it
    is; ``out_dims`` the same for the output, or a tuple of them for
    several. A mesh dim that shards ``args[0]`` on a role's dim shards
    every argument and output on theirs, so ``fn`` must be independent
    along those roles; other mesh dims, and a role some argument cannot
    split evenly, replicate. An argument that lacks a role gets a partial
    gradient over that role's mesh dims. On plain tensors it is exactly
    ``fn(*args)``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    x = args[0]
    if not isinstance(x, DTensor):
        return fn(*args)
    mesh = x.device_mesh
    # plain tensors among the sharded arguments are replicated values
    args = tuple(DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
                 if d is not None and not isinstance(a, DTensor) else a
                 for a, d in zip(args, dims))
    role_of = {d: r for r, d in enumerate(dims[0])}
    roles = [role_of.get(p.dim) if isinstance(p, Shard) else None
             for p in x.placements]
    for r in set(roles) - {None}:
        ways = math.prod(mesh.size(m) for m, q in enumerate(roles) if q == r)
        if any(d is not None and d[r] is not None and a.shape[d[r]] % ways
               for a, d in zip(args, dims)):
            roles = [None if q == r else q for q in roles]

    def placements(ds):
        return tuple(Replicate() if r is None or ds[r] is None
                     else Shard(ds[r]) for r in roles)

    def grad_placements(ds):
        # an argument the shards of a role all read: its local gradient is
        # a partial sum over that role's mesh dims
        return tuple(Partial() if r is not None and ds[r] is None
                     else Replicate() if r is None else Shard(ds[r])
                     for r in roles)

    in_pl = tuple(None if d is None else placements(d) for d in dims)
    grad_pl = tuple(None if d is None else grad_placements(d) for d in dims)
    many = isinstance(out_dims[0], tuple)
    out_pl = tuple(placements(d) for d in (out_dims if many else (out_dims,)))
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp`` over the last dim. On a DTensor sharded along it
    it is spelled out as max, shift, exp-sum and log, so that the sharded
    (vocab) dim reduces with two all-reduces of (..., 1), max then sum, as
    Megatron's vocab-parallel cross-entropy does, where DTensor's
    ``logsumexp`` would all-gather the logits."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor) or Shard(x.dim() - 1) not in x.placements:
        return torch.logsumexp(x, dim=-1)
    m = replicate_partial(x.amax(dim=-1, keepdim=True)).detach()
    s = replicate_partial(torch.exp(x - m).sum(dim=-1, keepdim=True))
    return (m + torch.log(s))[..., 0]


def _gather_last(logits, labels):
    return torch.gather(logits, -1, labels.long()[..., None])[..., 0]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE in f32. logits: (..., V); labels integers (...);
    ``mask`` (...) weights each position, the mean taken over its sum (at
    least 1)."""
    with spans.span("cross_entropy"):
        f32 = logits.float()
        logz = _logsumexp(f32)
        gold = take_sharded(_gather_last, f32, -1, labels)
        if gold is None:
            gold = _gather_last(f32, labels)
        nll = logz - gold
        if mask is not None:
            mask = mask.float()
            ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        else:
            ce = torch.mean(nll)
        return spans.mark_backward("cross_entropy", logits, ce)


def trunc_normal(generator: torch.Generator,
                 shape: tuple[int, ...]) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], f32, drawn on ``generator``'s
    device by inverting the CDF of a uniform draw."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.empty(shape, dtype=torch.float32, device=generator.device)
    u.uniform_(lo, hi, generator=generator)
    return u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


def init_dense(generator: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    """A (d_in, d_out) weight: truncated normal in ±2σ, scaled by 1/√d_in
    unless ``scale`` is given, cast to ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (scale * trunc_normal(generator, (d_in, d_out))).to(dtype)
