"""A plain MoE transformer with multi-head latent attention in float32: the
reference the benchmark holds DeepSeek-V2-Lite's program to. It imports
nothing of the program and takes none of its state: weights come in as a
``{name: tensor}`` dict made from the seed.

The architecture is ``moe_lm``'s (its RMS norm, SwiGLU MLP and MoE layer,
imported from there, with the same departures), except the attention
sublayer, multi-head latent attention with no query compression
(DeepSeek-V2, arXiv:2405.04434 §2.1), as the configuration file states it
(``model``; H heads, "nope" and "rope" the unrotated and rotated widths of
a query or key head, "v" a value head's, "rank" the latent's):

- q = x W_q, (S, H, nope + rope);
- [c_kv | k_pe] = x W_kva: c_kv (S, rank), k_pe (S, rope), one head that
  every query head shares; c_kv = RMS norm with the scale ``kv_norm``;
- [k_nope | v] = c_kv W_kvb, (S, H, nope + v);
- q's rope part and k_pe rotated by YaRN (arXiv:2309.00071): pair (2i,
  2i + 1) by pos x f_i, f_i = the plain frequency theta^(-2i / rope) where
  i lies below the correction range, divided by ``yarn_factor`` above it,
  a linear ramp between; the range is floor and ceil of rope ln(orig /
  (beta 2 pi)) / (2 ln theta) at beta ``yarn_beta_fast`` and
  ``yarn_beta_slow``; cos and sin times mscale(``yarn_mscale``) /
  mscale(``yarn_mscale_all_dim``), mscale(s) = 0.1 s ln(factor) + 1;
- k = [k_nope | k_pe]; causal softmax of q k^T at the scale (nope +
  rope)^-1/2 mscale(``yarn_mscale_all_dim``)^2; out = (P v) W_o.

Attention runs in blocks of ``QUERY_BLOCK`` query rows, each against the
keys up to its last row, so a 60k-token prompt fits the card. Every
product is an f32 product with TF32 off, unless ``Precision`` asks for
float8 (the control).

The harness asks it what it asks ``moe_lm``: ``groups`` and
``layer_leaves`` (the weights, under the program's parameter names),
``loss``, ``last_logits`` and ``prefill_flops``; ``attention_flops`` and
``attention_bytes`` count the causal products' operations and bytes
alone.
"""
from __future__ import annotations

import math

import torch

from gpubench.reference import moe_lm
from gpubench.reference.common import F32, Precision
from gpubench.reference.moe_lm import (head_weight, layer_names,
                                       layer_weights, moe, rms_norm, swiglu)
from gpubench.weights import DTYPES, Leaf

#: the weight groups: ``moe_lm``'s (embed, unembed, ln_f, each layer)
groups = moe_lm.groups

#: query rows an attention block takes (its f32 logits: 16 heads x 1,024
#: rows x the keys, 4 GB at 60k keys)
QUERY_BLOCK = 1024


def mscale(factor: float, s: float) -> float:
    return 1.0 if factor <= 1.0 else 0.1 * s * math.log(factor) + 1.0


def yarn_frequencies(m: dict, device) -> torch.Tensor:
    """(rope / 2,) f32: YaRN's frequency of each rotated pair."""
    dim, theta = m["qk_rope_head_dim"], m["rope_theta"]
    factor, orig = m["yarn_factor"], m["yarn_original_max_positions"]

    def correction(beta):
        return dim * math.log(orig / (beta * 2 * math.pi)) / (
            2 * math.log(theta))

    low = max(math.floor(correction(m["yarn_beta_fast"])), 0)
    high = min(math.ceil(correction(m["yarn_beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    plain = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim)
    ramp = torch.clamp((i - low) / (high - low), 0.0, 1.0)
    return plain / factor * ramp + plain * (1.0 - ramp)


def softmax_scale(m: dict) -> float:
    s = mscale(m["yarn_factor"], m["yarn_mscale_all_dim"])
    return (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5 * s * s


def rotate_pairs(x, positions, m: dict):
    """x (S, heads, rope): pair (2i, 2i + 1) rotated by pos x f_i, both
    scaled by YaRN's cos/sin factor."""
    ang = positions.float()[:, None] * yarn_frequencies(m, x.device)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x0, x1 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)
    f = m["yarn_factor"]
    return out.flatten(-2) * (mscale(f, m["yarn_mscale"])
                              / mscale(f, m["yarn_mscale_all_dim"]))


def attention(w: dict, x, m: dict, prec: Precision):
    """Causal latent attention of one sequence x (S, D)."""
    s = x.shape[0]
    h, r = m["num_heads"], m["kv_lora_rank"]
    nope, rope, dv = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    pos = torch.arange(s, device=x.device)
    q = prec.mm(x, w["attn.wq"]).view(s, h, nope + rope)
    q = torch.cat([q[..., :nope], rotate_pairs(q[..., nope:], pos, m)], -1)
    kva = prec.mm(x, w["attn.wkva"])
    ckv = rms_norm(kva[:, :r], w["attn.kv_norm"], m["norm_eps"])
    k_pe = rotate_pairs(kva[:, None, r:], pos, m)
    kv = prec.mm(ckv, w["attn.wkvb"]).view(s, h, nope + dv)
    k = torch.cat([kv[..., :nope], k_pe.expand(s, h, rope)], -1)
    v = kv[..., nope:]
    scale = softmax_scale(m)
    outs = []
    for lo in range(0, s, QUERY_BLOCK):
        hi = min(lo + QUERY_BLOCK, s)
        logits = prec.einsum("qhd,khd->hqk", q[lo:hi], k[:hi]) * scale
        past = (torch.arange(hi, device=x.device)[None]
                > torch.arange(lo, hi, device=x.device)[:, None])
        probs = torch.softmax(logits.masked_fill(past, float("-inf")), -1)
        del logits
        outs.append(prec.einsum("hqk,khd->qhd", probs, v[:hi]))
    return prec.mm(torch.cat(outs).reshape(s, h * dv), w["attn.wo"])


def _ffn(w: dict, h2, m: dict, prec: Precision, dense_ffn: bool):
    """The feed-forward sublayer of one sequence h2 (S, D): (y, aux)."""
    if dense_ffn:
        return (swiglu(h2, w["mlp.wg"], w["mlp.wu"], w["mlp.wd"], prec),
                torch.zeros((), device=h2.device))
    return moe(w, h2, m, prec)


def block(w: dict, x, m: dict, prec: Precision, dense_ffn: bool):
    """One block over one sequence x (S, D): (x, aux)."""
    x = x + attention(w, rms_norm(x, w["ln1"], m["norm_eps"]), m, prec)
    y, aux = _ffn(w, rms_norm(x, w["ln2"], m["norm_eps"]), m, prec,
                  dense_ffn)
    return x + y, aux


def layer_leaves(m: dict, group: str) -> list[Leaf]:
    """``moe_lm``'s leaves of the group (the same standard deviations),
    its attention projections replaced by the latent ones: ``attn.wq``,
    ``attn.wkva``, ``attn.wkvb`` (input side, 1/sqrt(d_in)), ``attn.wo``
    (1/sqrt(2 L d_in)) and the latent norm's scale ``attn.kv_norm`` (f32,
    zero)."""
    base = moe_lm.layer_leaves({**m, "head_dim": 1}, group)
    if not group.startswith(("blocks.", "dense_blocks.")):
        return base
    d, h, r, L = m["d_model"], m["num_heads"], m["kv_lora_rank"], \
        m["num_layers"]
    nope, rope, dv = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    dt = DTYPES[m["param_dtype"]]
    latent = [Leaf(f"{group}.attn.wq", (d, h * (nope + rope)), dt,
                   d ** -0.5),
              Leaf(f"{group}.attn.wkva", (d, r + rope), dt, d ** -0.5),
              Leaf(f"{group}.attn.kv_norm", (r,), torch.float32, 0.0),
              Leaf(f"{group}.attn.wkvb", (r, h * (nope + dv)), dt, r ** -0.5),
              Leaf(f"{group}.attn.wo", (h * dv, d), dt,
                   (2 * L * h * dv) ** -0.5)]
    rest = [leaf for leaf in base if ".attn." not in leaf.name]
    return rest[:1] + latent + rest[1:]


def loss(params: dict, tokens, m: dict, prec: Precision = F32):
    """(loss, ce, aux, hidden) of a (B, S) token batch, as ``moe_lm``'s,
    each row through the blocks on its own."""
    rows, aux = [], torch.zeros((), device=tokens.device)
    for row in tokens:
        x = params["embed"][row.long()]
        for layer in layer_names(m):
            x, a = block(layer_weights(params, layer), x, m, prec,
                         layer.startswith("dense_blocks."))
            aux = aux + a
        rows.append(x)
    x = torch.stack(rows)
    h = rms_norm(x[:, :-1], params["ln_f"], m["norm_eps"])
    logits = prec.mm(h, head_weight(params, m))
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1).long())
    return ce + m["router_aux_coef"] * aux, ce, aux, x


@torch.no_grad()
def last_logits(weights_of, prompts: list, m: dict, prec: Precision = F32):
    """(R, V) logits at the last position of each of ``prompts`` ((S,)
    token rows of any lengths), run layer by layer as ``moe_lm``'s, one
    layer's weights held at a time; each prompt's feed-forward sublayer on
    its own tokens (every token is routed on its own)."""
    emb = weights_of("embed")["embed"]
    xs = [emb[p.long()] for p in prompts]
    head = (emb.T if m["tie_embeddings"]
            else weights_of("unembed")["unembed"])
    del emb
    for layer in layer_names(m):
        w = layer_weights(weights_of(layer), layer)
        dense_ffn = layer.startswith("dense_blocks.")
        xs = [block(w, x, m, prec, dense_ffn)[0] for x in xs]
        del w
    h = rms_norm(torch.stack([x[-1] for x in xs]),
                 weights_of("ln_f")["ln_f"], m["norm_eps"])
    return prec.mm(h, head)


def attention_flops(m: dict, batch: int, seq: int) -> int:
    """The causal products of every layer's attention over ``batch`` rows
    of ``seq`` tokens: QK^T at nope + rope and PV at v, 2 FLOPs a
    multiply-add, over the S (S + 1) / 2 (query, key) pairs of each
    head."""
    width = m["qk_nope_head_dim"] + m["qk_rope_head_dim"] + m["v_head_dim"]
    return (2 * batch * m["num_heads"] * width * (seq * (seq + 1) // 2)
            * m["num_layers"])


def attention_bytes(m: dict, batch: int, seq: int) -> int:
    """The bytes the causal products must move, every layer: q and k
    (nope + rope) and v read once, the output (v) written once, in bf16,
    and the f32 log-sum-exp of each row and head."""
    h = m["num_heads"]
    qk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    return (batch * seq * h * (2 * (2 * qk + 2 * m["v_head_dim"]) + 4)
            * m["num_layers"])


def active_block_params(m: dict) -> int:
    """The block parameters one token's forward multiplies by: of the
    dense layers all, of an MoE layer the attention, the router, the
    shared experts and k of the E routed experts. The latent's expansion
    (W_kvb) runs on every token."""
    d, h, r = m["d_model"], m["num_heads"], m["kv_lora_rank"]
    nope, rope, dv = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    attn = d * h * (nope + rope) + d * (r + rope) + r * h * (nope + dv) \
        + h * dv * d
    nd = m["first_dense_layers"]
    moe_layer = attn + d * m["num_experts"] + 3 * d * m["moe_d_ff"] * (
        m["experts_per_token"] + m["num_shared_experts"])
    return nd * (attn + 3 * d * m["first_dense_d_ff"]) \
        + (m["num_layers"] - nd) * moe_layer


def prefill_flops(m: dict, seq: int) -> int:
    """Model FLOPs of one row's prefill of ``seq`` tokens: 2 T (active
    block params), the head on the last position, the causal attention
    (``attention_flops``)."""
    return (2 * seq * active_block_params(m) + 2 * m["vocab_size"]
            * m["d_model"] + attention_flops(m, 1, seq))
