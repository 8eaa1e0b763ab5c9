"""``SinglePool``: one dense message pool on one device, port of
``repro.core.placement.single``.

The round selectors (packed and lexicographic pool-min), the pool-capacity
rule and the fire-candidate routing tables live here, and ``build_runner``
picks one of the engine's three runners (zero-latency fast path,
sample-scan engine, budgeted loop) as ``repro.core.events`` does.

Keys. JAX compares the f32 delivery times through their uint32 bit
pattern and packs ``gen · E + cid`` into a uint32 lane. Times are never
negative, so their int32 view orders them the same way; the packed lane is
carried as int64, which few uint32 rules constrain, with the free-slot
sentinel ``0xFFFFFFFF`` of the JAX lane.
"""
from __future__ import annotations

import dataclasses

import torch

#: Bit pattern of float32 +inf. ``msg_t`` is always >= 0, so its int32 view
#: orders like the times, and a free slot (t = +inf) carries the largest key.
INF_BITS = 0x7F800000
#: The packed key of a free slot (JAX's uint32 all-ones).
KEY_FREE = 0xFFFFFFFF
_IMAX = torch.iinfo(torch.int32).max


def wave_cap(cfg) -> int:
    """The engine's effective cascade wave bound (``None`` -> 8·side²)."""
    return 8 * cfg.side * cfg.side if cfg.max_waves is None else cfg.max_waves


def pool_capacity(cfg, ecfg) -> int:
    """Pool slots for one dense pool: ``capacity`` or 8·N, at least 4. An
    active fault plan's ``pool_reserve`` withholds slots: the drops it
    forces count as ``dropped_overflow``, never as fault drops."""
    m = ecfg.capacity if ecfg.capacity is not None else 8 * cfg.n_units
    if ecfg.fault_active:
        m = int(m) - ecfg.faults.pool_reserve
    return max(int(m), 4)


def key_scale(num_events: int, max_waves: int) -> int | None:
    """E if ``(gen, cid)`` packs losslessly into 32 bits (key = gen · E +
    cid, gen <= max_waves + 1, cid < E), else ``None``: the engine then
    takes the exact 3-field lexicographic min, correct for any int32
    gen and cid."""
    if num_events <= 0:
        return None
    if (max_waves + 2) * num_events <= 2 ** 32:
        return num_events
    return None


def pool_min_lex(msg_t, msg_gen, msg_cid):
    """Exact lexicographic min over active messages: (t, gen, cid) -> round.
    gen and cid use int32 max as the masked fill, which stays exact when a
    real gen or cid equals it. Returns ``(tmin, gmin, cmin, sel, have)``,
    0-d tensors and the (M,) bool selection, on the pool's device."""
    hi = msg_t.view(torch.int32)
    hi_min = hi.min()
    have = hi_min != INF_BITS
    m1 = hi == hi_min
    gmin = torch.where(m1, msg_gen, _IMAX).min()
    m2 = m1 & (msg_gen == gmin)
    cmin = torch.where(m2, msg_cid, _IMAX).min()
    sel = m2 & (msg_cid == cmin)
    return hi_min.view(torch.float32), gmin, cmin, sel, have


def pool_min_packed(msg_t, msg_key, scale: int):
    """Packed round-key min: 2 reduction passes instead of 3. ``msg_key``
    is the int64 lane ``gen · scale + cid`` (``scale`` == E, which
    ``key_scale`` guarantees fits 32 bits). Returns as ``pool_min_lex``."""
    hi = msg_t.view(torch.int32)
    hi_min = hi.min()
    have = hi_min != INF_BITS
    m1 = hi == hi_min
    lo_min = torch.where(m1, msg_key, KEY_FREE).min()
    sel = m1 & (msg_key == lo_min)
    gmin = torch.div(lo_min, scale, rounding_mode="floor").to(torch.int32)
    cmin = torch.remainder(lo_min, scale).to(torch.int32)
    return hi_min.view(torch.float32), gmin, cmin, sel, have


@dataclasses.dataclass(frozen=True)
class SinglePool:
    """One pool, one device: the default placement. A frozen dataclass
    without fields: every instance is equal and hashes alike."""

    name = "single"

    @property
    def shards(self) -> int:
        return 1

    def pool_capacity(self, cfg, ecfg) -> int:
        return pool_capacity(cfg, ecfg)

    def pack_scale(self, cfg, ecfg, num_events: int) -> int | None:
        return key_scale(num_events, wave_cap(cfg))

    def make_selector(self, cfg, ecfg, num_events: int):
        """Round selector over the pool's key lanes: the packed min when
        ``(gen, cid)`` fits 32 bits (``pack_scale``), else the exact
        lexicographic 3-field min."""
        scale = self.pack_scale(cfg, ecfg, num_events)
        if scale is not None:
            def select(msg_t, msg_key, msg_gen, msg_cid):
                del msg_gen, msg_cid
                return pool_min_packed(msg_t, msg_key, scale)
        else:
            def select(msg_t, msg_key, msg_gen, msg_cid):
                del msg_key
                return pool_min_lex(msg_t, msg_gen, msg_cid)
        return select

    def routing(self, near):
        """The r-th unit's 4 outgoing messages in ``near``-table order (up,
        down, left, right), which land on the receiver direction codes
        (from-below, from-above, from-right, from-left) in that same slot
        order. Returns int64 (src4, dst4, dirs4), each (4N,), on ``near``'s
        device; dst4 is -1 off the lattice."""
        n = near.shape[0]
        dev = near.device
        dirs4 = torch.arange(4, device=dev).repeat(n)
        src4 = torch.arange(n, device=dev).repeat_interleave(4)
        return src4, near.reshape(-1).long(), dirs4

    def build_runner(self, cfg, ecfg, num_events: int, search, p_fn, l_c_fn):
        """Pick the engine's runner: the zero-latency fast path, the
        sample-scan engine, or the budgeted loop (``max_rounds`` set)."""
        # late import: events imports this module for its selectors
        from repro_torch.core import events

        if ecfg.fault_active and ecfg.faults.shard_latency_mult:
            raise ValueError(
                "FaultPlan.shard_latency_mult injects per-shard stragglers "
                "and needs placement='mesh' with shards == len(mult) >= 2; "
                "the single-pool placement has no shards to slow down")
        if events._zero_fast_ok(cfg, ecfg, num_events):
            return events._make_fused_zero(cfg, ecfg, num_events,
                                           search, p_fn, l_c_fn)
        if ecfg.kernel != "staged":
            # EventConfig already pins latency/engine/max_rounds; only an
            # explicit undersized capacity lands here
            raise ValueError(
                "kernel='fused' needs the zero-latency fast path, but "
                "capacity < 4*N disqualifies it (a fire's 4N messages must "
                "fit the pool); raise capacity or drop the kernel override")
        if ecfg.max_rounds is None:
            return events._make_engine(cfg, ecfg, num_events,
                                       search, p_fn, l_c_fn, placement=self)
        return events._make_budgeted(cfg, ecfg, num_events,
                                     search, p_fn, l_c_fn, placement=self)
