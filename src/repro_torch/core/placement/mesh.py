"""``MeshPlacement``: the event engine partitioned over ranks, port of
``repro.core.placement.mesh``.

The paper's cascade is local in space (a firing unit talks to its 4 lattice
neighbours) and sparse in time, which makes the event engine partitionable:
the lattice is cut into contiguous row bands, one a shard, and every shard
keeps its *own* message pool, free ring, logical clocks and draw sources.
The only traffic that crosses a shard boundary is a weight broadcast from a
boundary-row unit, batched into one halo exchange a round.

One process is one shard (one rank of a ``torch.distributed`` group over
the ``("shards",)`` axis of a ``repro_torch.sharding.ShardMesh``), as under
``torchrun``. Execution model, as the reference's (DESIGN.md §10):

- **per-shard rounds**: each drain iteration, every shard with a due
  message pops *its own* minimal ``(time, generation, cascade-id)`` round
  and delivers it (the single pool's delivery math on the band, plain
  PyTorch); shards working on different cascades in one iteration is the
  intended semantics.
- **halo exchange**: a round's refires (and each sample round's threshold
  crossing) leave an *outbox*: the boundary rows' fire masks, stamped with
  the round's ``(t, gen, cid)``, and their weights. Every iteration each
  rank gathers every rank's outbox masks and its due flag in one host
  ``all_gather``; when no rank was due, the drain ends on every rank alike
  (JAX's ``psum`` loop predicate, read on the host); otherwise each rank
  enqueues what arrives from its neighbours, drawing the delays and loss
  from its own streams, whether or not anything arrived. The boundary rows'
  weights cross in a second (device) ``all_gather`` only in an iteration
  in which some outbox is not empty: skipping the rows of an all-zero mask
  gives the same pools.
- **collective search**: a sample round runs on all shards. The exact
  search is the ``bmu`` kernel on the shard's ``(L, D)`` band (its plain
  version on CPU tensors), then one min-reduce (``all_gather`` of each
  shard's (q, global index), argmin, lowest shard on a tie); the heuristic
  probes ``e / K`` local units, min-reduces, then walks the greedy descent
  one min-reduce a hop. Every loop ends on reduced values, so the ranks
  stay in lockstep. The GMU's Eq. 3 adaptation, counter drive, clock stamp
  and any fire happen on the owning shard only.
- **randomness**: each rank is handed its own sources, the counterparts of
  JAX's ``fold_in(key, shard)`` streams (``repro_torch.draws``): the run's
  source (per sample event the probes, heuristic only, then ``spawn()``: the
  cascade's child, which hands out the drive ``uniform(())`` and one
  ``uniform((4, rows, side))`` per delivery round on this shard), the
  latency source (exponential latency only: ``exponential((4 L,))`` at
  every fire and ``exponential((2 side,))`` at every exchange) and the
  fault source (broadcast loss only: ``uniform`` of the same shapes at the
  same sites).

Host counters as in the single pool: a delivery round reads the device for
its round key and for its counts (receivers, what fires, the boundary
masks), a sample round for its search and what fires.

``MeshPlacement(shards=1)`` is served by the ``SinglePool`` runner: a
1-shard mesh has no partition boundary, so "shards=1 == single" holds by
construction.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import afm as afm_lib
from repro_torch.core.afm import AFMState
from repro_torch.core.placement import single as single_mod
from repro_torch.draws import GeneratorDraws
from repro_torch.kernels.bmu import ops as bmu_ops
from repro_torch.sharding import compat

#: mesh axis name the event engine shards over
AXIS = "shards"

#: what the last mesh run of this process did: drain iterations, host
#: collectives, weight gathers, device reads and seconds in the exchange
stats = {"drain_iterations": 0, "collectives": 0, "weight_gathers": 0,
         "host_reads": 0, "exchange_s": 0.0}

#: Host reads that are part of the design (``repro_torch.analysis.syncs``):
#: the shards run in lockstep on host values, each read or gather counted
#: in ``stats``.
SYNCS_BY_DESIGN = {
    "_build_mesh_runner.go": "a drain iteration gathers every shard's "
                             "outbox and due flag on the host; a sample "
                             "round gathers the search's (q, index) and "
                             "reads what fires",
}


def shard_mesh(shards: int) -> compat.ShardMesh:
    """The event engine's ``("shards",)`` mesh over the process group,
    which must have ``shards`` ranks."""
    try:
        return compat.ShardMesh((shards,), (AXIS,))
    except (ValueError, RuntimeError) as err:
        raise ValueError(
            f"MeshPlacement(shards={shards}) runs one process a shard and "
            f"needs {shards} ranks of an initialised torch.distributed "
            f"process group (torchrun --nproc-per-node {shards}, or "
            f"repro_torch.sharding.spawn_ranks): {err}") from None


@dataclasses.dataclass(frozen=True)
class MeshPlacement:
    """Units and message pool partitioned over ``shards`` ranks.

    ``cfg.side`` must divide by ``shards`` (contiguous row bands); the pool
    ``capacity`` is split evenly per shard (default 8 · N/K slots each).
    ``max_rounds`` (the budgeted single-pool runner) is not supported:
    a global round budget has no per-shard meaning.
    """

    name = "mesh"
    shards: int = 1

    def __post_init__(self):
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")

    def pool_capacity(self, cfg, ecfg) -> int:
        """Per-shard pool slots: an even split of ``capacity``, or 8 · L.
        An active fault plan's ``pool_reserve`` withholds slots from every
        shard's pool (forced overflow pressure, counted as overflow)."""
        n_local = max(1, cfg.n_units // self.shards)
        m = (ecfg.capacity // self.shards if ecfg.capacity is not None
             else 8 * n_local)
        if ecfg.fault_active:
            m = int(m) - ecfg.plan.pool_reserve
        return max(int(m), 4)

    def pack_scale(self, cfg, ecfg, num_events: int) -> None:
        """Mesh pools always take the exact lexicographic min (per-shard
        gen and cid stay plain int32 lanes: halo metadata travels
        unpacked)."""
        return None

    def make_selector(self, cfg, ecfg, num_events: int):
        def select(msg_t, msg_key, msg_gen, msg_cid):
            del msg_key
            return single_mod.pool_min_lex(msg_t, msg_gen, msg_cid)
        return select

    def routing(self, near):
        """Global-lattice candidate tables (the mesh runner derives its
        shard-local ones itself)."""
        return single_mod.SinglePool().routing(near)

    def build_runner(self, cfg, ecfg, num_events: int, search, p_fn, l_c_fn):
        if self.shards == 1:
            # no partition boundary: the single-pool runner IS the 1-shard
            # mesh, which makes shards=1 == SinglePool bitwise
            return single_mod.SinglePool().build_runner(
                cfg, ecfg, num_events, search, p_fn, l_c_fn)
        if cfg.side % self.shards:
            raise ValueError(
                f"side={cfg.side} must divide into shards={self.shards} "
                f"contiguous row bands")
        if ecfg.max_rounds is not None:
            raise ValueError(
                "max_rounds (the budgeted runner) is single-pool only; a "
                "global round budget has no per-shard meaning under "
                "placement='mesh'")
        if ecfg.kernel != "staged":
            raise ValueError(
                "kernel='fused' is single-pool only (the fused kernel holds "
                "the whole lattice in one program); use shards=1")
        if ecfg.fault_active and ecfg.plan.shard_latency_mult \
                and len(ecfg.plan.shard_latency_mult) != self.shards:
            raise ValueError(
                f"FaultPlan.shard_latency_mult has "
                f"{len(ecfg.plan.shard_latency_mult)} entries but the mesh "
                f"has shards={self.shards}; one multiplier per shard")
        return _build_mesh_runner(self, cfg, ecfg, num_events, search,
                                  p_fn, l_c_fn)


@dataclasses.dataclass
class _Carry:
    """One shard's simulation state (the sharded ``events.EventState``;
    L local units, M pool slots). Tensors live on the run's device, the
    counters are host values."""
    w: torch.Tensor          # (L, D) f32 local unit weights
    c: torch.Tensor          # (L,) int32 cascading counters
    clock: torch.Tensor      # (L,) f32 per-unit logical clocks
    nevents: torch.Tensor    # (L,) int32 events processed per unit
    msg_t: torch.Tensor      # (M,) f32 delivery time (+inf = free slot)
    msg_gen: torch.Tensor    # (M,) int32 round key: generation
    msg_cid: torch.Tensor    # (M,) int32 round key: originating sample event
    msg_dst: torch.Tensor    # (M,) int64 receiving unit (local index)
    msg_dir: torch.Tensor    # (M,) int64 receiver-side direction code
    msg_w: torch.Tensor      # (M, D) f32 payload: sender weights at send
    free_ring: torch.Tensor  # (M,) int64 ring queue of free slot ids
    free_head: int
    free_n: int
    draws: object            # this shard's run source
    casc: list               # (E,) the cascade children on this shard
    wcount: np.ndarray       # (E,) int32 max generation delivered here
    sizes: np.ndarray        # (E,) int32 local firing incidents
    gmu: list                # (E,) aux, identical on every shard
    q2: list
    greedy: list
    t: np.float32            # last locally processed round time
    lat: object              # this shard's latency source
    faults: object           # this shard's fault source (loss on) or None
    drounds: int = 0         # local delivery rounds
    deliveries: int = 0      # local weight-message deliveries
    dropped: int = 0         # local pool-overflow drops
    # fault accounting is pool-owner-side: a halo message's sent, loss and
    # overflow count on the receiving shard, so per-shard identities hold
    sent: int = 0
    dropped_fault: int = 0
    samples_dead: int = 0


class _Outbox(NamedTuple):
    """One round's cross-shard traffic: the boundary rows' fire masks
    (host ints, zeroed at the global lattice boundary) and the round's
    stamp. The rows' weights are read from the band when they are
    shipped, which is before anything changes them."""
    up: list                 # (side,) top-row firings, for shard me - 1
    dn: list                 # (side,) bottom-row firings, for shard me + 1
    t: np.float32            # send time
    gen: int
    cid: int


def _build_mesh_runner(pl: MeshPlacement, cfg, ecfg, num_events: int,
                       search, p_fn, l_c_fn):
    """The per-rank runner ``go(state, samples, draws, lat_draws, donate,
    fault_draws=, dead=)``; see the module docstring."""
    from repro_torch.core import events as events_lib

    k_shards = pl.shards
    side, d, theta = cfg.side, cfg.dim, cfg.theta
    n = cfg.n_units
    rows = side // k_shards           # local lattice rows per shard
    length = rows * side              # L: local units per shard
    e = num_events
    spacing = np.float32(ecfg.sample_spacing)
    m = pl.pool_capacity(cfg, ecfg)
    # a round's delivery width: one local fire (<= 4L) plus one halo burst
    # (<= 2 side) at zero/constant latency; exponential ties span the pool
    k_round = m if ecfg.latency == "exponential" else min(4 * length
                                                          + 2 * side, m)
    max_waves = single_mod.wave_cap(cfg)
    iter_cap = min(e * (max_waves + 2) + 1, 2 ** 31 - 1)
    e_local = max(1, cfg.e // k_shards)
    exact = search in (afm_lib.search_exact, events_lib.search_exact)
    use_far = cfg.greedy_use_far
    expo = ecfg.latency == "exponential"
    delay = np.float32(ecfg.delay if ecfg.latency == "constant"
                       or expo else 0.0)
    plan = ecfg.plan
    loss_on = ecfg.fault_active and plan.p_loss > 0.0
    p_loss = float(np.float32(plan.p_loss))
    dead_on = ecfg.fault_active and plan.dropout_active
    straggle_on = ecfg.fault_active and bool(plan.shard_latency_mult)
    d_lo = np.float32(plan.dropout_start)
    d_hi = np.float32(plan.dropout_start + plan.dropout_len)

    def go(state: AFMState, samples, draws, lat_draws, donate=False,
           fault_draws=None, dead=None):
        del donate                       # the bands are the run's copies
        mesh = shard_mesh(k_shards)
        me = mesh.axis_index(AXIS)
        calls0 = mesh.calls
        dev = state.w.device
        lo = me * length
        i0 = int(state.i)
        near, far = state.near, state.far
        for key in stats:
            stats[key] = 0

        def host(x) -> list:
            stats["host_reads"] += 1
            return x.tolist()

        # --- static local tables: candidates in (up, down, left, right)
        # order == receiver direction codes (0 from-below, 1 from-above,
        # 2 from-right, 3 from-left), as core.events; boundary rows route
        # through the halo, off-lattice columns are dropped
        uu = torch.arange(length, device=dev)
        rr, ss = uu // side, uu % side
        neg = torch.full_like(uu, -1)
        dst4 = torch.stack([torch.where(rr > 0, uu - side, neg),
                            torch.where(rr < rows - 1, uu + side, neg),
                            torch.where(ss > 0, uu - 1, neg),
                            torch.where(ss < side - 1, uu + 1, neg)],
                           dim=1).reshape(-1)                      # (4L,)
        dst_ok = dst4 >= 0
        dirs4 = torch.arange(4, device=dev).repeat(length)
        src4 = uu.repeat_interleave(4)
        # halo arrivals: from-above lands on my row 0 (dir 1), from-below
        # on my last row (dir 0)
        halo_dst = torch.cat([torch.arange(side, device=dev),
                              length - side + torch.arange(side, device=dev)])
        halo_dir = torch.cat([torch.ones(side, dtype=torch.int64, device=dev),
                              torch.zeros(side, dtype=torch.int64,
                                          device=dev)])
        mult = (np.float32(plan.shard_latency_mult[me]) if straggle_on
                else np.float32(1.0))
        if dead_on:
            dead_g = (plan.dead_units(n) if dead is None
                      else torch.as_tensor(dead, dtype=torch.bool))
            dead_host = dead_g[lo:lo + length].numpy().copy()
            dead_band = torch.as_tensor(dead_host, device=dev)

        def dead_at(t):
            """The (L,) dead mask at simulated time ``t`` (a float32),
            ``None`` outside the window: decided on the host."""
            return dead_band if dead_on and d_lo <= t < d_hi else None

        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        es = _Carry(
            w=state.w[lo:lo + length].clone(),
            c=state.c[lo:lo + length].to(torch.int32).clone(),
            clock=z(length, dtype=torch.float32), nevents=z(length),
            msg_t=torch.full((m,), float("inf"), device=dev),
            msg_gen=z(m), msg_cid=z(m), msg_dst=z(m, dtype=torch.int64),
            msg_dir=z(m, dtype=torch.int64),
            msg_w=z(m, d, dtype=torch.float32),
            free_ring=torch.arange(m, device=dev), free_head=0, free_n=m,
            draws=draws, casc=[None] * e, wcount=np.zeros(e, np.int32),
            sizes=np.zeros(e, np.int32), gmu=[0] * e,
            q2=[np.float32(0)] * e, greedy=[0] * e, t=np.float32(0.0),
            lat=lat_draws,
            faults=((fault_draws if fault_draws is not None else
                     GeneratorDraws(plan.seed, dev).fold_in(me))
                    if loss_on else None))

        def site_delays(count: int):
            """One draw site's delays (f32, ``count``): drawn from the
            latency source at exponential latency, else ``None`` (the
            constant delay is a host value)."""
            if not expo:
                return None
            base = es.lat.exponential((count,)) * float(delay)
            return base * float(mult) if straggle_on else base

        def due_time(t):
            """A zero or constant latency message's delivery time."""
            dv = np.float32(delay * mult) if straggle_on else delay
            return np.float32(t + dv)

        def enqueue(valid, nvalid: int, count: int, fill):
            """Allocate pool slots off the free ring for the valid
            candidates: the r-th valid candidate takes the r-th free slot,
            candidates past the free count are dropped and counted.
            ``sent`` counts every valid candidate before the loss draw,
            which runs at every call, whatever is valid."""
            es.sent += nvalid
            if loss_on:
                keep = es.faults.uniform((count,)) >= p_loss
                if nvalid:
                    valid = valid & keep
                    nkept = host(valid.sum())
                    es.dropped_fault += nvalid - nkept
                    nvalid = nkept
            nalloc = min(nvalid, es.free_n)
            es.dropped += nvalid - nalloc
            if not nalloc:
                return
            cand = events_lib._compact(valid, nvalid)[:nalloc]
            slots = es.free_ring[(es.free_head + torch.arange(
                nalloc, device=dev)) % m]
            fill(slots, cand)
            es.free_head = (es.free_head + nalloc) % m
            es.free_n -= nalloc

        def fire_counts(fired, *extra):
            """[units firing, in-band messages, *extra, top-row mask,
            bottom-row mask] in one host read."""
            vals = host(torch.cat([
                torch.stack([fired.sum(), (fired[src4] & dst_ok).sum(),
                             *extra]),
                fired[:side].long(), fired[length - side:].long()]))
            k = 2 + len(extra)
            return vals[:k], vals[k:k + side], vals[k + side:]

        def fire(fired, cid: int, t, gen: int, nfired: int, nvalid: int,
                 up, dn) -> _Outbox:
            """Broadcast after theta on the band: reset the counters,
            enqueue the in-band neighbour messages, and leave the boundary
            rows' firings as the round's outbox."""
            es.sizes[cid] += nfired
            if nfired:
                es.c.masked_fill_(fired, 0)
            base = site_delays(4 * length)

            def fill(slots, cand):
                if base is not None:
                    es.msg_t.index_copy_(0, slots, base[cand] + float(t))
                else:
                    es.msg_t.index_fill_(0, slots, float(due_time(t)))
                es.msg_gen.index_fill_(0, slots, gen)
                es.msg_cid.index_fill_(0, slots, cid)
                es.msg_dst.index_copy_(0, slots, dst4[cand])
                es.msg_dir.index_copy_(0, slots, dirs4[cand])
                es.msg_w.index_copy_(0, slots, es.w[src4[cand]])

            valid = (fired[src4] & dst_ok) if nvalid else None
            enqueue(valid, nvalid, 4 * length, fill)
            return _Outbox(up if me > 0 else [0] * side,
                           dn if me < k_shards - 1 else [0] * side,
                           np.float32(t), gen, cid)

        empty = _Outbox([0] * side, [0] * side, np.float32(0), 0, 0)

        def exchange(out: _Outbox, flag: int = 1) -> bool:
            """The round's halo. One host ``all_gather`` of every rank's
            (flag, stamp, masks); returns False, with nothing exchanged,
            when no rank raised its flag (a drain's "nobody was due").
            Otherwise each rank takes the outboxes of its neighbours (the
            one above sends its bottom row down, the one below its top row
            up), draws its delays and loss for the 2 side arrivals and
            enqueues the valid ones; the boundary rows' weights cross in a
            device ``all_gather`` when some rank's outbox is not empty."""
            t0 = time.perf_counter()
            meta = torch.tensor(
                [flag, int(out.t.view(np.int32)), out.gen, out.cid,
                 *out.up, *out.dn], dtype=torch.int64)
            g = mesh.all_gather(meta, AXIS).numpy()    # (K, 4 + 2 side)
            if not g[:, 0].any():
                stats["exchange_s"] += time.perf_counter() - t0
                return False
            a = g[(me - 1) % k_shards]                 # from above: its dn
            b = g[(me + 1) % k_shards]                 # from below: its up
            a_mask, b_mask = a[4 + side:], b[4:4 + side]
            valid_h = np.concatenate([a_mask, b_mask]) != 0
            nvalid = int(valid_h.sum())
            base = site_delays(2 * side)
            rows_w = None
            if g[:, 4:].any():
                stats["weight_gathers"] += 1
                edge = torch.stack([es.w[:side], es.w[length - side:]])
                gw = mesh.all_gather(edge, AXIS)       # (K, 2, side, D)
                rows_w = torch.cat([gw[(me - 1) % k_shards, 1],
                                    gw[(me + 1) % k_shards, 0]])
            stamp = [(np.int32(a[1]).view(np.float32), int(a[2]), int(a[3])),
                     (np.int32(b[1]).view(np.float32), int(b[2]), int(b[3]))]

            def fill(slots, cand):
                if base is not None:
                    tv = base + torch.tensor(
                        [float(stamp[0][0])] * side + [float(stamp[1][0])]
                        * side, dtype=torch.float32, device=dev)
                else:
                    tv = torch.tensor(
                        [float(due_time(stamp[0][0]))] * side
                        + [float(due_time(stamp[1][0]))] * side,
                        dtype=torch.float32, device=dev)
                genv = torch.tensor([stamp[0][1]] * side + [stamp[1][1]]
                                    * side, dtype=torch.int32, device=dev)
                cidv = torch.tensor([stamp[0][2]] * side + [stamp[1][2]]
                                    * side, dtype=torch.int32, device=dev)
                es.msg_t.index_copy_(0, slots, tv[cand])
                es.msg_gen.index_copy_(0, slots, genv[cand])
                es.msg_cid.index_copy_(0, slots, cidv[cand])
                es.msg_dst.index_copy_(0, slots, halo_dst[cand])
                es.msg_dir.index_copy_(0, slots, halo_dir[cand])
                es.msg_w.index_copy_(0, slots, rows_w[cand])

            valid = torch.as_tensor(valid_h, device=dev) if nvalid else None
            enqueue(valid, nvalid, 2 * side, fill)
            stats["exchange_s"] += time.perf_counter() - t0
            return True

        def argmin_host(q, gidx: int):
            """(q, gidx) of the first shard holding the least q (a
            float32), the same on every rank."""
            mine = torch.tensor([int(np.float32(q).view(np.int32)), gidx],
                                dtype=torch.int64)
            g = mesh.all_gather(mine, AXIS).numpy()
            qs = g[:, 0].astype(np.int32).view(np.float32)
            k = int(np.argmin(qs))
            return qs[k], int(g[k, 1])

        def greedy(sample, jstar: int, qstar):
            """Min-reduce greedy descent at B = 1: each hop's candidates
            are evaluated by their owners and one argmin-reduce elects the
            global winner; the loop ends on the reduced value."""
            j, q, steps = jstar, qstar, 0
            while steps < n:
                cands = (torch.cat([near[j], far[j]]) if use_far
                         else near[j]).long()
                local = (cands >= lo) & (cands < lo + length)
                lidx = torch.clamp(cands - lo, 0, length - 1)
                dq = torch.sum((es.w[lidx] - sample[None, :]) ** 2, dim=-1)
                dq = torch.where(local, dq, torch.inf)
                kb = torch.argmin(dq)
                bits, cand = host(torch.stack([
                    dq[kb].view(torch.int32).long(), cands[kb]]))
                q_glob, j_glob = argmin_host(
                    np.int32(bits).view(np.float32), cand)
                steps += 1
                if not q_glob < q:
                    break
                j, q = j_glob, q_glob
            return j, q, steps

        def sample_round(sample, ev: int) -> _Outbox:
            """Deliver the next sample collectively: the search elects the
            GMU, the owning shard applies Eq. 3, draws the counter drive
            and fires on a threshold crossing."""
            t_s = np.float32(ev) * spacing
            p_i = p_fn(i0 + ev, cfg)
            if exact:
                idx, q2 = bmu_ops.bmu(es.w, sample[None, :])
                bits, jl = host(torch.stack([q2[0].view(torch.int32).long(),
                                             idx[0].long()]))
                q2v, gmu_g = argmin_host(np.int32(bits).view(np.float32),
                                         lo + jl)
                gsteps = 0
            else:
                probes = es.draws.randint(0, length, (e_local,))
                q = torch.sum((es.w[probes] - sample[None, :]) ** 2, dim=-1)
                kb = torch.argmin(q)
                bits, jl = host(torch.stack([q[kb].view(torch.int32).long(),
                                             probes[kb]]))
                qstar, jstar = argmin_host(np.int32(bits).view(np.float32),
                                           lo + jl)
                gmu_g, q2v, gsteps = greedy(sample, jstar, qstar)
            # Eq. (3) at the owner
            mine = lo <= gmu_g < lo + length
            lu = min(max(gmu_g - lo, 0), length - 1)
            dead_now = dead_at(t_s)
            alive = dead_now is None or not dead_host[lu]
            if mine and not alive:
                es.samples_dead += 1
            child = es.draws.spawn()
            hit = child.uniform(()) < p_i
            if mine and alive:
                g = torch.tensor([lu], device=dev)
                row = es.w[g]
                es.w.index_copy_(0, g, row + cfg.l_s * (sample[None, :]
                                                        - row))
                es.c.index_add_(0, g, hit.to(torch.int32).reshape(1))
                es.clock[lu] = float(t_s)
                es.nevents[lu] += 1
            es.t = max(es.t, t_s)
            es.casc[ev] = child
            es.gmu[ev], es.q2[ev], es.greedy[ev] = gmu_g, q2v, gsteps
            if max_waves < 1:
                return empty
            fired0 = es.c >= theta
            if dead_now is not None:
                fired0 &= ~dead_now
            (nfired, nvalid), up, dn = fire_counts(fired0)
            return fire(fired0, ev, t_s, 1, nfired, nvalid, up, dn)

        def read_round():
            tmin, gmin, cmin, sel, _ = single_mod.pool_min_lex(
                es.msg_t, es.msg_gen, es.msg_cid)
            bits, g, ci, nsel = host(torch.stack([
                tmin.view(torch.int32).long(), gmin.long(), cmin.long(),
                sel.sum()]))
            tmin = np.array(bits, np.int32).view(np.float32)[()]
            return tmin, g, ci, sel, nsel, bits != single_mod.INF_BITS

        def delivery_round(tmin, gmin: int, cid: int, sel, nsel: int
                           ) -> _Outbox:
            """Deliver one local round: its first ``k_round`` slots (in
            slot order) are summed per receiver in direction-slot order and
            applied as a row scatter, the single pool's delivery math on
            the band; every selected slot is freed. Refires are gated by
            the generation (``gmin < max_waves``), the globally consistent
            wave depth."""
            l_c = l_c_fn(i0 + cid, cfg)
            p_i = p_fn(i0 + cid, cfg)
            bern = (es.casc[cid].uniform((4, rows, side)) < p_i
                    ).reshape(4, length)
            idx_all = events_lib._compact(sel, nsel)
            napply = min(nsel, k_round)
            idx = idx_all[:napply]
            dsts, dirs, ws = es.msg_dst[idx], es.msg_dir[idx], es.msg_w[idx]
            dead_now = dead_at(tmin)
            if dead_now is None:
                ok, drive = None, bern[dirs, dsts]
                ones = torch.ones_like(dsts, dtype=torch.int32)
            else:
                ok = ~dead_now[dsts]
                drive, ones = bern[dirs, dsts] & ok, ok.to(torch.int32)
            es.c.index_add_(0, dsts, drive.to(torch.int32))
            n_recv = z(length).index_add_(0, dsts, ones)
            received = n_recv > 0
            allowed = (es.c >= theta) & received
            if not gmin < max_waves:
                allowed = torch.zeros_like(allowed)
            if dead_now is not None:
                allowed &= ~dead_now
            pair = dsts * 4 + dirs
            reps = z(4 * length).index_add_(0, pair, ones).max()
            extra = [received.sum(), reps.long(), ones.sum()]
            (nfired, nvalid, nrecv, reps, nok), up, dn = fire_counts(
                allowed, *extra)
            if dead_now is not None:
                ndeliv = nok
            else:
                ndeliv = napply if dead_on else nsel
            ridx = events_lib._compact(received, nrecv)
            pos = (torch.cumsum(received, 0) - 1)[dsts]
            rank = events_lib._group_rank(pair) if reps > 1 else None
            acc = torch.zeros((nrecv + 1, d), device=dev)
            for s4 in range(4):                  # direction-slot order
                for r in range(reps):
                    take = dirs == s4 if rank is None else (dirs == s4) & (
                        rank == r)
                    if ok is not None:
                        take &= ok
                    acc.index_add_(0, torch.where(take, pos, nrecv), ws)
            wr = es.w[ridx]
            nf = n_recv[ridx].to(wr.dtype)
            es.w.index_copy_(0, ridx, wr + l_c * (acc[:nrecv] - nf[:, None]
                                                  * wr))
            es.clock.masked_fill_(received, float(tmin))
            es.nevents += n_recv
            # free every selected slot: their ids go onto the ring's tail
            es.msg_t.index_fill_(0, idx_all, float("inf"))
            es.free_ring.index_copy_(0, (es.free_head + es.free_n
                                         + torch.arange(nsel, device=dev))
                                     % m, idx_all)
            es.free_n += nsel
            es.wcount[cid] = max(int(es.wcount[cid]), gmin)
            es.deliveries += ndeliv
            es.dropped_fault += nsel - ndeliv
            es.drounds += 1
            es.t = max(es.t, tmin)
            return fire(allowed, cid, tmin, gmin + 1, nfired, nvalid, up, dn)

        def drain(t_limit):
            """Delivery rounds until no shard holds a due message: each
            iteration the due shards deliver their round, then every shard
            exchanges halos (the exchange's gather also tells every rank
            whether any shard was due)."""
            it = 0
            while it < iter_cap:
                due = False
                if es.free_n < m:
                    tmin, g, ci, sel, nsel, have = read_round()
                    due = have and tmin <= t_limit
                out = delivery_round(tmin, g, ci, sel, nsel) if due \
                    else empty
                if not exchange(out, flag=int(due)):
                    return
                stats["drain_iterations"] += 1
                it += 1

        for ev in range(e):
            drain(np.float32(ev) * spacing)
            exchange(sample_round(samples[ev], ev))
        drain(np.float32(np.inf))

        # --- the report: psum / pmax of the host counters in one gather
        stranded = m - es.free_n
        row = [es.drounds, es.deliveries, es.dropped + stranded, es.sent,
               es.dropped_fault, stranded, es.samples_dead,
               int(es.t.view(np.int32)), es.dropped]
        g = mesh.all_gather(torch.as_tensor(np.concatenate([
            np.asarray(row, np.int64), es.sizes.astype(np.int64),
            es.wcount.astype(np.int64)])), AXIS).numpy()
        tot = g[:, :7].sum(axis=0)
        t_end = g[:, 7].astype(np.int32).view(np.float32).max()
        sizes = g[:, 9:9 + e].sum(axis=0)
        waves = g[:, 9 + e:].max(axis=0)
        shard_counts = tuple(
            (int(r[3]), int(r[1]), int(r[8]), int(r[4]), int(r[5]))
            for r in g)
        # the dense state on every rank: the bands in shard order
        w_full = mesh.all_gather(es.w, AXIS).reshape(n, d)
        ints = torch.stack([es.c, es.clock.view(torch.int32), es.nevents])
        gi = mesh.all_gather(ints, AXIS)                   # (K, 3, L)
        c_full = gi[:, 0].reshape(n)
        clock = gi[:, 1].reshape(n).view(torch.float32)
        nevents = gi[:, 2].reshape(n)
        stats["collectives"] = mesh.calls - calls0
        final = AFMState(w_full, c_full, far, near, i0 + e)
        aux = afm_lib.StepAux(
            gmu=torch.tensor(es.gmu, dtype=torch.int32, device=dev)[:, None],
            q2=torch.tensor(np.asarray(es.q2, np.float32),
                            device=dev)[:, None],
            cascade_size=torch.as_tensor(sizes.astype(np.int32), device=dev),
            waves=torch.as_tensor(waves.astype(np.int32), device=dev),
            greedy_steps=torch.tensor(es.greedy, dtype=torch.int32,
                                      device=dev)[:, None])
        report = events_lib.EventReport(
            rounds=e + int(tot[0]), samples=e, deliveries=int(tot[1]),
            dropped=int(tot[2]), t_end=float(t_end), clock=clock,
            nevents=nevents, sent=int(tot[3]), dropped_fault=int(tot[4]),
            stranded=int(tot[5]), samples_dead=int(tot[6]),
            shard_counts=shard_counts)
        return final, aux, report

    return go
