"""A plain MoE transformer in float32: the reference the benchmark holds
the program to. It imports nothing of the program and takes none of its
state: weights come in as a ``{name: tensor}`` dict made from the seed.

The architecture, as the configuration file states it (``model``):

- token embedding, tied to the output unless ``tie_embeddings`` is false;
- ``num_layers`` pre-norm blocks: RMS norm ``x / rms(x) * (1 + scale)``,
  grouped-query causal self-attention with RoPE (each head's two halves
  rotated by ``pos * theta^(-j / (hd/2))``; kv head ``j`` serves query
  heads ``j * rep ..``), softmax scaled by ``1/sqrt(hd)``, then RMS norm
  and the feed-forward sublayer;
- the first ``first_dense_layers`` feed-forward sublayers a SwiGLU MLP of
  ``first_dense_d_ff``, the others the MoE layer: a softmax router over
  ``num_experts`` in f32, the top ``experts_per_token`` (ties to the lower
  index), their probabilities renormalised to sum to 1, each a SwiGLU
  expert of ``moe_d_ff``; plus ``num_shared_experts`` shared experts, one
  SwiGLU of ``moe_d_ff * num_shared_experts`` on every token; and the
  Switch load-balance loss ``E * sum_e f_e P_e`` over the batch's tokens
  (``f_e`` the share of tokens routed to e, ``P_e`` the mean probability);
- a final RMS norm and the output head; the loss the mean next-token
  cross-entropy plus ``router_aux_coef`` times the layers' summed
  load-balance losses.

Every product is an f32 product with TF32 off, unless ``Precision`` asks
for a lower one (the control of the check: operands rounded to float8
e4m3 at a per-tensor scale before the product).

A configuration file names its family's module (``"reference":
"moe_lm"``), and the harness asks it, and nothing else, about the model:
its weights (``groups``, ``layer_leaves``, under the program's parameter
names), its loss and hidden states (``loss``), its last-position logits
layer by layer (``last_logits``) and its model FLOPs
(``train_step_flops``, ``prefill_flops``). Another family brings a module
of its own with these names.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from gpubench import flops
from gpubench.reference.common import F32, Precision
from gpubench.weights import DTYPES, Leaf


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x, positions, theta):
    """x (B, S, H, hd), positions (S,)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(w: dict, x, m: dict, prec: Precision):
    """Causal GQA self-attention of x (B, S, D)."""
    b, s, _ = x.shape
    h, hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    pos = torch.arange(s, device=x.device)
    q = rope(prec.mm(x, w["attn.wq"]).view(b, s, h, hd), pos, m["rope_theta"])
    k = rope(prec.mm(x, w["attn.wk"]).view(b, s, hkv, hd), pos,
             m["rope_theta"])
    v = prec.mm(x, w["attn.wv"]).view(b, s, hkv, hd)
    kr = torch.repeat_interleave(k, h // hkv, dim=2)
    vr = torch.repeat_interleave(v, h // hkv, dim=2)
    logits = prec.einsum("bqhd,bkhd->bhqk", q, kr) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    logits = logits.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = prec.einsum("bhqk,bkhd->bqhd", probs, vr).reshape(b, s, h * hd)
    return prec.mm(out, w["attn.wo"])


def swiglu(x, wg, wu, wd, prec: Precision):
    return prec.mm(torch.nn.functional.silu(prec.mm(x, wg))
                   * prec.mm(x, wu), wd)


def moe(w: dict, x2d, m: dict, prec: Precision):
    """The MoE sublayer on x2d (T, D): (y (T, D), the Switch loss)."""
    e, k = m["num_experts"], m["experts_per_token"]
    probs = torch.softmax(prec.mm(x2d, w["moe.router"]), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = vals[:, :k], idx[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    y = torch.zeros_like(x2d)
    for ex in range(e):
        tok, slot = torch.nonzero(top_i == ex, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = swiglu(x2d[tok], w["moe.wg"][ex], w["moe.wu"][ex],
                     w["moe.wd"][ex], prec)
        y = y.index_add(0, tok, out * top_p[tok, slot][:, None])
    if m["num_shared_experts"]:
        y = y + swiglu(x2d, w["moe.shared.wg"], w["moe.shared.wu"],
                       w["moe.shared.wd"], prec)
    routed = torch.zeros_like(probs).scatter(1, top_i, 1.0)
    aux = e * torch.sum(routed.mean(0) * probs.mean(0))
    return y, aux


def block(w: dict, x, m: dict, prec: Precision, dense_ffn: bool):
    """One block over x (B, S, D): (x, aux or a zero)."""
    x = x + attention(w, rms_norm(x, w["ln1"], m["norm_eps"]), m, prec)
    h2 = rms_norm(x, w["ln2"], m["norm_eps"])
    if dense_ffn:
        y = swiglu(h2, w["mlp.wg"], w["mlp.wu"], w["mlp.wd"], prec)
        aux = torch.zeros((), device=x.device)
    else:
        b, s, d = h2.shape
        y, aux = moe(w, h2.reshape(b * s, d), m, prec)
        y = y.view(b, s, d)
    return x + y, aux


def layer_names(m: dict) -> list[str]:
    nd = m["first_dense_layers"]
    return ([f"dense_blocks.{i}" for i in range(nd)]
            + [f"blocks.{i}" for i in range(m["num_layers"] - nd)])


def groups(m: dict) -> list[str]:
    """The weight groups in order: ``embed``, ``unembed`` (untied only),
    ``ln_f``, then each layer (``dense_blocks.i``, ``blocks.i``)."""
    return (["embed"] + ([] if m["tie_embeddings"] else ["unembed"])
            + ["ln_f"] + layer_names(m))


def layer_leaves(m: dict, group: str) -> list[Leaf]:
    """The leaves of one group under the program's parameter names
    (``blocks.3.moe.wg``), with the standard deviation each is drawn at:
    embeddings 0.02, a product's input-side weights 1/sqrt(d_in), its
    output projections (``wo``, ``wd``) 1/sqrt(2 L d_in), the router
    1/sqrt(d) in f32, norm scales zero."""
    d, v, L = m["d_model"], m["vocab_size"], m["num_layers"]
    dt = DTYPES[m["param_dtype"]]
    f32 = torch.float32
    if group == "embed":
        return [Leaf("embed", (v, d), dt, 0.02)]
    if group == "unembed":
        return [Leaf("unembed", (d, v), dt, 1.0 / math.sqrt(d))]
    if group == "ln_f":
        return [Leaf("ln_f", (d,), f32, 0.0)]
    hd = m["head_dim"]
    q, kv = m["num_heads"] * hd, m["num_kv_heads"] * hd

    def dense(name, d_in, d_out, out_proj=False, lead=()):
        std = (1.0 / math.sqrt(2 * L * d_in) if out_proj
               else 1.0 / math.sqrt(d_in))
        return Leaf(f"{group}.{name}", lead + (d_in, d_out), dt, std)

    leaves = [Leaf(f"{group}.ln1", (d,), f32, 0.0),
              dense("attn.wq", d, q), dense("attn.wk", d, kv),
              dense("attn.wv", d, kv), dense("attn.wo", q, d, True),
              Leaf(f"{group}.ln2", (d,), f32, 0.0)]
    if group.startswith("dense_blocks."):
        ff = m["first_dense_d_ff"]
        return leaves + [dense("mlp.wg", d, ff), dense("mlp.wu", d, ff),
                         dense("mlp.wd", ff, d, True)]
    e, fe = m["num_experts"], m["moe_d_ff"]
    leaves += [Leaf(f"{group}.moe.router", (d, e), f32, 1.0 / math.sqrt(d)),
               dense("moe.wg", d, fe, lead=(e,)),
               dense("moe.wu", d, fe, lead=(e,)),
               dense("moe.wd", fe, d, True, lead=(e,))]
    if m["num_shared_experts"]:
        fs = fe * m["num_shared_experts"]
        leaves += [dense("moe.shared.wg", d, fs), dense("moe.shared.wu", d, fs),
                   dense("moe.shared.wd", fs, d, True)]
    return leaves


def train_step_flops(m: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one train step (``gpubench.flops``)."""
    return flops.train_step_flops(m, batch, seq)


def prefill_flops(m: dict, seq: int) -> int:
    """Model FLOPs of one row's prefill of ``seq`` tokens."""
    return flops.prefill_flops(m, seq)


def layer_weights(params: dict, layer: str) -> dict:
    """The leaves of ``layer`` under their names within the layer."""
    pre = layer + "."
    return {n[len(pre):]: p for n, p in params.items() if n.startswith(pre)}


def head_weight(params: dict, m: dict):
    return params["embed"].T if m["tie_embeddings"] else params["unembed"]


def _block_ckpt(x, m, prec, dense_ffn, names, *leaves):
    return block(dict(zip(names, leaves)), x, m, prec, dense_ffn)


def hidden(params: dict, tokens, m: dict, prec: Precision = F32,
           remat: bool = False):
    """The pre-final-norm hidden states (B, S, D) and the summed Switch
    loss; with ``remat`` each block under a checkpoint (its inputs kept,
    the rest recomputed in the backward pass)."""
    x = params["embed"][tokens.long()]
    aux = torch.zeros((), device=x.device)
    for layer in layer_names(m):
        w = layer_weights(params, layer)
        dense_ffn = layer.startswith("dense_blocks.")
        if remat:
            names = list(w)
            x, a = checkpoint(_block_ckpt, x, m, prec, dense_ffn, names,
                              *w.values(), use_reentrant=False)
        else:
            x, a = block(w, x, m, prec, dense_ffn)
        aux = aux + a
    return x, aux


def loss(params: dict, tokens, m: dict, prec: Precision = F32):
    """(loss, ce, aux, hidden) of a (B, S) token batch: the mean CE of each
    token's prediction of the next, plus ``router_aux_coef`` times aux."""
    x, aux = hidden(params, tokens, m, prec, remat=True)
    h = rms_norm(x[:, :-1], params["ln_f"], m["norm_eps"])
    logits = prec.mm(h, head_weight(params, m))
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1).long())
    return ce + m["router_aux_coef"] * aux, ce, aux, x


@torch.no_grad()
def last_logits(weights_of, prompts: list, m: dict, prec: Precision = F32):
    """(R, V) logits at the last position of each of ``prompts`` ((S,)
    token rows of any lengths), run layer by layer: ``weights_of(group)``
    gives a group's weights (``embed``, ``unembed``, ``ln_f``, a layer) as
    ``{name: f32 tensor}``, so only one layer's weights are held at a
    time. Every prompt's positions go through every layer; the feed-forward
    sublayer runs on all prompts' tokens at once (each token is routed on
    its own)."""
    emb = weights_of("embed")["embed"]
    xs = [emb[p.long()] for p in prompts]
    head = (emb.T if m["tie_embeddings"]
            else weights_of("unembed")["unembed"])
    del emb
    eps = m["norm_eps"]
    for layer in layer_names(m):
        w = layer_weights(weights_of(layer), layer)
        for r, x in enumerate(xs):
            xs[r] = x + attention(w, rms_norm(x, w["ln1"], eps)[None], m,
                                  prec)[0]
        h2 = rms_norm(torch.cat(xs), w["ln2"], eps)
        if layer.startswith("dense_blocks."):
            y = swiglu(h2, w["mlp.wg"], w["mlp.wu"], w["mlp.wd"], prec)
        else:
            y, _ = moe(w, h2, m, prec)
        xs = [x + yy for x, yy in zip(xs, y.split([x.shape[0] for x in xs]))]
        del w, h2, y
    h = rms_norm(torch.stack([x[-1] for x in xs]),
                 weights_of("ln_f")["ln_f"], eps)
    return prec.mm(h, head)
