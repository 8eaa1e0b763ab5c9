"""The arithmetic the benchmark's shares are taken against: model FLOPs
from shapes, the card's peaks by name, and the probe kernels' bytes and
operations.

Model FLOPs count the work the model needs once: each product 2 x its
multiply-adds, forward and backward (the backward twice the forward), no
recomputation under remat, and attention's two products (QK and PV) over
the causal triangle, S(S+1)/2 key positions a head, so a kernel that skips
the masked half does the same counted work. A copy of the port's
``chip_smoke._active_block_params`` and ``_train_flops``, with those two
changes.
"""
from __future__ import annotations

#: dense bf16 tensor-core peaks without sparsity (NVIDIA data sheets, at
#: the full power limit), by a part of the device's name
BF16_PEAKS = {"SXM": 989e12, "PCIe": 756e12}
#: H100 HBM3 bandwidth and f32 rate outside the tensor cores (SXM data
#: sheet), the probe kernels' roofline
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def bf16_peak(device_name: str) -> float:
    """The bf16 peak of an H100 by its name: the PCIe part's where the
    name says PCIe, else the SXM part's ("NVIDIA H100 80GB HBM3")."""
    return BF16_PEAKS["PCIe" if "PCIe" in device_name else "SXM"]


def active_block_params(m: dict) -> int:
    """The block parameters one token's forward multiplies by: of a dense
    layer all of them, of an MoE layer the attention, the router, the
    shared experts and k of the E routed experts."""
    d, hd = m["d_model"], m["head_dim"]
    q, kv = m["num_heads"] * hd, m["num_kv_heads"] * hd
    attn = 2 * d * q + 2 * d * kv
    nd = m["first_dense_layers"]
    moe = attn + d * m["num_experts"] + 3 * d * m["moe_d_ff"] * (
        m["experts_per_token"] + m["num_shared_experts"])
    return nd * (attn + 3 * d * m["first_dense_d_ff"]) \
        + (m["num_layers"] - nd) * moe


def head_params(m: dict) -> int:
    return m["vocab_size"] * m["d_model"]


def causal_attention_flops(m: dict, batch: int, seq: int) -> int:
    """QK and PV forward over the causal triangle, every layer."""
    return (2 * 2 * batch * m["num_heads"] * m["head_dim"]
            * (seq * (seq + 1) // 2) * m["num_layers"])


def train_step_flops(m: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one train step: 6 T (active block params + head) and
    3 x the causal attention's forward."""
    t = batch * seq
    return (6 * t * (active_block_params(m) + head_params(m))
            + 3 * causal_attention_flops(m, batch, seq))


def prefill_flops(m: dict, seq: int) -> int:
    """Model FLOPs of one B 1 prefill of ``seq`` tokens: 2 T (active block
    params), the head on the last position, the causal attention."""
    return (2 * seq * active_block_params(m) + 2 * head_params(m)
            + causal_attention_flops(m, 1, seq))


def bmu_cost(b: int, n: int, d: int) -> tuple[int, int]:
    """(bytes, operations) of the exact search of B vectors over an N x D
    f32 map: the map and the vectors read once, an index and a distance
    written a vector; 3 operations a coordinate of each pair."""
    return 4 * (n * d + b * d) + 8 * b, 3 * b * n * d


def drive_cascade_cost(n: int, d: int, waves: int) -> tuple[int, int]:
    """(bytes, operations) of the drive and ``waves`` cascade waves on an
    N x D f32 map: the map read once and written once, whatever the number
    of waves (the counters, the draws and the front are N-sized and
    counted too: int32 counters and counts in, counters, receive counts
    out, 8 + 4 x 16 bool draws); 6 operations a coordinate a wave."""
    lattice = n * (4 + 4 + 4 + 4 + 1 + 8 + 4 * 16)
    return 2 * 4 * n * d + lattice, 6 * n * d * waves


def cascade_wave_cost(n: int) -> tuple[int, int]:
    """(bytes, operations) of one tail wave on N sites: counters and the
    front in, counters, the front and receive counts out, 4 bool draws."""
    return n * (4 + 1 + 4 + 4 + 1 + 4), 10 * n


def bound_seconds(nbytes: int, ops: int) -> float:
    """The least time the card could take: bytes at HBM bandwidth or f32
    operations at the f32 rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)
