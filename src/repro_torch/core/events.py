"""Discrete-event asynchronous training (the paper's execution model), port
of ``repro.core.events``.

N autonomous units interact only through messages of two kinds:

- **sample delivery**: the search routes a sample to its GMU, which adapts
  by Eq. (3) and increments its counter with probability ``p_i`` (Eq. 6);
- **weight broadcast**: a unit whose counter reaches ``theta`` fires: it
  resets the counter and sends its current weights to its 4 lattice
  neighbours; a receiver adapts by ``w_j += l_c (w_k - w_j)`` and is driven
  with probability ``p_i``, possibly firing in turn.

Messages sit in a fixed-capacity pool with their payload (the sender's
weights at send time) and a delivery time from a latency model (``zero``,
``constant`` or ``exponential``). A *round* is every message that shares
the minimal ``(time, generation, cascade-id)`` key, or the next sample
arrival, messages first on a time tie. Three runners implement the same
round semantics (``placement.single.SinglePool.build_runner`` picks one):

- **zero-latency fast path** (``latency='zero'``, ``engine='auto'``): one
  training step per sample, plus an accounting sidecar that reproduces the
  engine's ``EventReport``. ``kernel='staged'``: the search (the ``bmu``
  kernel at B = 1 for ``search_exact``), the plain Eq. 3 merge, then one
  ``kernels.cascade.ops.drive_cascade`` launch, which returns the receive
  counts; ``kernel='fused'``: one ``kernels.fused.ops.fused_step`` launch
  (``fused_step_parts(recv0=)``), which searches in the kernel for
  ``search_exact`` and takes the relay race's GMU otherwise. Either way a
  cascade that outlives the 16-wave block finishes on ``cascade_wave``.
- **sample-scan engine** (the default otherwise): before each arrival, the
  due messages are drained round by round; then a final drain.
- **budgeted loop** (``EventConfig.max_rounds`` set): one loop under a
  global round budget, whose truncation accounting counts stranded
  messages as dropped.

Delivery rounds, the pool and its free ring are plain PyTorch, and they
update the run's own copy of the dense state in place: a round gathers and
scatters only its selected slots and their receiver rows. Counters of the
run (rounds, deliveries, drops, the free ring's head and count, per-cascade
wave counts and sizes) are host integers, so a delivery round reads the
device twice: its round key with its message count, then its receiver
count with what fires. A sample round reads it once (what fires). Times are
float32 throughout (numpy ``float32`` on the host), so rounds come in the
order JAX's float32 times give.

Faults (``EventConfig(faults=FaultPlan(...))``, ``repro_torch.faults``)
are a sidecar of the rounds; each axis is a plain Python branch, so a run
without an active plan runs the fault-free code. Broadcast loss takes one
``uniform((4N,))`` from the plan's own source at every fire that sends
(one more host read, to count the kept messages); a dead unit is masked on
the card, and whether the dropout window is open is decided on the host
from the round's time, so dropout adds no host read. An active plan always
runs the sample-scan engine (or the budgeted loop), never the fast path.

Randomness (``repro_torch.draws``): per sample event the search's draws
from the run's source, then ``spawn()``: a child source per cascade (JAX's
``k_cascade``) that hands out the drive, one block for the first
``WAVE_CAP`` delivery rounds and one draw per later round; exponential
delays come from a separate latency source. Every runner consumes each
cascade's numbers identically, so from one seed the three agree.

Under zero latency a round is one cascade wave and every runner reproduces
``reference``'s dynamics; avalanche sizes count firing incidents per
originating sample, as ``core.cascade`` and ``core.sandpile`` do (equal to
the sandpile's at p = 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import afm as afm_lib
from repro_torch.core import schedules
from repro_torch.core import search as search_lib
from repro_torch.core.afm import AFMConfig, AFMState
from repro_torch.core.placement import base as placement_base
from repro_torch.core.placement import mesh as placement_mesh
from repro_torch.core.placement import single as placement_single
from repro_torch.draws import GeneratorDraws
from repro_torch.faults import FaultPlan
from repro_torch.kernels.bmu import ops as bmu_ops
from repro_torch.kernels.cascade import ops as cascade_ops
from repro_torch.kernels.fused import ops as fused_ops

LATENCIES = ("zero", "constant", "exponential")
ENGINES = ("auto", "event")
KERNELS = ("staged", "fused")
#: delivery rounds of a cascade whose draws come in one block (the kernel
#: paths' wave block)
WAVE_CAP = cascade_ops.DEFAULT_WAVE_CAP

#: Host reads that are part of the design (``repro_torch.analysis.syncs``):
#: the engine's loops branch on the next round, which ``read_round`` reads
#: back to the host once a round.
SYNCS_BY_DESIGN = {
    "_make_engine.go": "the drain loop runs on the round read_round read",
    "_make_budgeted.go": "the loop runs on the round read_round read",
}

# Direction codes, from the receiver's side, match ``core.cascade._shift4``'s
# slot order: 0 = from row+1 (below), 1 = from row-1 (above), 2 = from col+1
# (right), 3 = from col-1 (left). A sender's 4 messages in ``near``-table
# order (up, down, left, right) land on exactly these receiver slots.


@dataclasses.dataclass(frozen=True)
class EventConfig:
    """Static configuration of the event engine.

    latency:        'zero' (cascades complete between sample arrivals),
                    'constant' (every message takes ``delay``) or
                    'exponential' (i.i.d. Exp(mean=``delay``) per message).
    delay:          the latency scale, in the units of ``sample_spacing``.
    sample_spacing: simulated time between consecutive sample arrivals.
    capacity:       message-pool slots; ``None`` -> 8·N. Overflowing
                    messages are dropped and counted.
    max_rounds:     ``None`` runs to quiescence (fast path or sample-scan
                    engine); a value selects the budgeted loop.
    engine:         'auto' sends eligible zero-latency runs to the fast
                    path; 'event' always simulates rounds.
    kernel:         the fast path's step: 'staged' or 'fused' (the fused
                    kernel needs latency='zero', engine='auto',
                    max_rounds=None).
    faults:         ``None``, ``FaultPlan.none()`` or a plan to inject
                    (broadcast loss, dropout windows, pool pressure); an
                    active plan leaves the fast path for the engine and
                    rejects ``kernel='fused'``. ``shard_latency_mult``
                    needs the mesh placement (one multiplier a shard).
    """
    latency: str = "zero"
    delay: float = 0.0
    sample_spacing: float = 1.0
    capacity: int | None = None
    max_rounds: int | None = None
    engine: str = "auto"
    kernel: str = "staged"
    faults: FaultPlan | None = None

    def __post_init__(self):
        if self.faults is not None and not isinstance(self.faults, FaultPlan):
            raise ValueError(
                "faults must be a repro_torch.faults.FaultPlan or None, got "
                f"{self.faults!r} (dict specs are resolved by the backend "
                "layer: backend_options={'faults': {...}})")
        if self.latency not in LATENCIES:
            raise ValueError(f"latency must be one of {LATENCIES}, got "
                             f"{self.latency!r}")
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got "
                             f"{self.engine!r}")
        if self.kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got "
                             f"{self.kernel!r}")
        if self.kernel != "staged" and (
                self.latency != "zero" or self.engine != "auto"
                or self.max_rounds is not None):
            raise ValueError(
                "kernel='fused' runs only in the zero-latency fast-path "
                "regime: latency='zero', engine='auto', max_rounds=None")
        if self.kernel != "staged" and self.fault_active:
            raise ValueError(
                "kernel='fused' runs only in the zero-latency fast-path "
                "regime, which an active FaultPlan disqualifies (faults are "
                "simulated by the discrete-event engine)")
        if self.delay < 0:
            raise ValueError(f"delay must be >= 0, got {self.delay}")
        if self.latency == "zero" and self.delay:
            raise ValueError("latency='zero' takes no delay; use 'constant'")
        if self.sample_spacing <= 0:
            raise ValueError("sample_spacing must be > 0")

    @property
    def fault_active(self) -> bool:
        """True when a fault plan with at least one active axis is set."""
        return self.faults is not None and not self.faults.is_none()

    @property
    def plan(self) -> FaultPlan:
        """The effective plan (``faults`` or the fault-free default)."""
        return self.faults if self.faults is not None else FaultPlan.none()


@dataclasses.dataclass
class EventState:
    """The simulation state of a run. The tensors live on the run's device
    and are updated in place; the counters are host values."""
    # the AFM core (the run's own copies, unless the caller donated them)
    w: torch.Tensor          # (N, D) f32
    c: torch.Tensor          # (N,) int32 cascading counters
    i: int                   # samples consumed (drives the schedules)
    # per-unit locality
    clock: torch.Tensor      # (N,) f32, each unit's last-event time
    nevents: torch.Tensor    # (N,) int32, events processed per unit
    # message pool of M slots (time +inf marks a free slot)
    msg_t: torch.Tensor      # (M,) f32 delivery time
    msg_key: torch.Tensor    # (M,) int64 packed gen·E + cid (packed mode)
    msg_gen: torch.Tensor    # (M,) int32 generation (lexicographic mode)
    msg_cid: torch.Tensor    # (M,) int32 originating sample event (lex)
    msg_dst: torch.Tensor    # (M,) int64 receiving unit
    msg_dir: torch.Tensor    # (M,) int64 receiver-side direction code
    msg_w: torch.Tensor      # (M, D) f32 payload: sender weights at send
    # ring queue of free slot ids: entries [free_head, free_head + free_n)
    # (mod M) are exactly the free slots
    free_ring: torch.Tensor  # (M,) int64
    free_head: int
    free_n: int
    # per cascade (one per sample event of the run)
    casc: list               # (E,) the cascade's child draw source
    blocks: dict             # cid -> (WAVE_CAP, 4, N) bool draws of its
    #                          first delivery rounds, once drawn
    inflight: np.ndarray     # (E,) messages in the pool, per cascade
    wcount: np.ndarray       # (E,) delivery rounds so far (== waves)
    sizes: np.ndarray        # (E,) firing incidents (a_i)
    gmu: torch.Tensor        # (E,) int32
    q2: torch.Tensor         # (E,) f32
    greedy: torch.Tensor     # (E,) int32
    # run counters
    ev: int                  # next sample event
    t: np.float32            # time of the last round
    rounds: int
    deliveries: int          # weight messages delivered
    dropped: int             # messages lost to pool overflow
    sent: int                # broadcast candidates attempted
    lat: object              # the exponential-latency draw source
    # the fault sidecar (0 and None without an active plan)
    dropped_fault: int = 0   # messages lost or addressed to a dead unit
    samples_dead: int = 0    # samples routed to a dead GMU
    faults: object = None    # the plan's draw source (message loss)


class EventReport(NamedTuple):
    """Per-run accounting, host values but ``clock`` and ``nevents``. The
    conservation identity is ``sent == deliveries + dropped_overflow +
    dropped_fault + stranded``, with ``dropped_overflow = dropped -
    stranded``."""
    rounds: int              # simulation rounds executed
    samples: int             # sample deliveries consumed
    deliveries: int          # weight-broadcast deliveries
    dropped: int             # pool-overflow drops + stranded messages
    t_end: float             # final simulated time (a float32 value)
    clock: torch.Tensor      # (N,) f32 per-unit logical clocks
    nevents: torch.Tensor    # (N,) int32 per-unit event counts
    sent: int = 0            # broadcast candidates attempted
    dropped_fault: int = 0   # injected losses + messages to dead units
    stranded: int = 0        # in flight at exit (also in ``dropped``)
    samples_dead: int = 0    # samples routed to a dead GMU
    shard_counts: tuple = ((0, 0, 0, 0, 0),)  # per shard [sent, delivered,
    #                          dropped_overflow, dropped_fault, stranded]

    @property
    def events(self):
        """Total events processed (samples + weight deliveries)."""
        return self.samples + self.deliveries

    @property
    def dropped_overflow(self):
        """Pool-overflow drops alone (``dropped`` minus the stranded tail)."""
        return self.dropped - self.stranded


def _resolve(cfg: AFMConfig, ecfg: EventConfig, num_events: int):
    """(pool size M, wave cap, round cap). The round cap is ``max_rounds``
    or, as a safety net, E (max_waves + 2) + 1, within int32 as in JAX."""
    m = placement_single.pool_capacity(cfg, ecfg)
    max_waves = placement_single.wave_cap(cfg)
    max_rounds = (ecfg.max_rounds if ecfg.max_rounds is not None
                  else num_events * (max_waves + 2) + 1)
    return m, max_waves, min(int(max_rounds), 2 ** 31 - 1)


def init_events(state: AFMState, cfg: AFMConfig, ecfg: EventConfig,
                num_events: int, lat_draws, donate: bool = False,
                fault_draws=None) -> EventState:
    """Fresh simulation state around an ``AFMState`` for ``num_events``
    sample arrivals. Simulated time restarts at 0; ``state.i`` keeps
    driving the schedules. The run updates its own copies of ``w`` and
    ``c``, or, with ``donate``, the caller's tensors in place. An active
    plan's draw source is ``fault_draws`` or a new
    ``GeneratorDraws(plan.seed)``: the fault stream restarts with every
    run, as JAX's ``PRNGKey(plan.seed)`` does."""
    n, d, e = cfg.n_units, cfg.dim, num_events
    m = _resolve(cfg, ecfg, num_events)[0]
    dev = state.w.device
    w, c = (state.w, state.c) if donate else (state.w.clone(),
                                               state.c.clone())

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return EventState(
        w=w, c=c, i=int(state.i),  # lint: sync-ok(i is a host int)
        clock=z(n, dtype=torch.float32), nevents=z(n),
        msg_t=torch.full((m,), float("inf"), device=dev),
        msg_key=torch.full((m,), placement_single.KEY_FREE,
                           dtype=torch.int64, device=dev),
        msg_gen=z(m), msg_cid=z(m),
        msg_dst=z(m, dtype=torch.int64), msg_dir=z(m, dtype=torch.int64),
        msg_w=z(m, d, dtype=torch.float32),
        free_ring=torch.arange(m, device=dev), free_head=0, free_n=m,
        casc=[None] * e, blocks={}, inflight=np.zeros(e, np.int64),
        wcount=np.zeros(e, np.int32), sizes=np.zeros(e, np.int32),
        gmu=z(e), q2=z(e, dtype=torch.float32), greedy=z(e),
        ev=0, t=np.float32(0.0), rounds=0, deliveries=0, dropped=0, sent=0,
        lat=lat_draws,
        faults=(fault_draws if fault_draws is not None
                else GeneratorDraws(ecfg.plan.seed, dev))
        if ecfg.fault_active else None)


def _default_p(i, cfg: AFMConfig) -> float:
    return float(schedules.cascade_probability(i, cfg.total_samples,
                                               cfg.n_units, cfg.c_m, cfg.c_d))


def _default_l_c(i, cfg: AFMConfig) -> float:
    return float(schedules.cascade_learning_rate(i, cfg.total_samples,
                                                 cfg.c_o, cfg.c_s))


def search_exact(state: AFMState, samples: torch.Tensor, draws,
                 cfg: AFMConfig) -> search_lib.SearchResult:
    """Exact search through the ``bmu`` kernel (its plain version on CPU
    tensors); draws unused. The fused fast path searches in its kernel
    instead, with the same arithmetic."""
    del draws, cfg
    idx, q2 = bmu_ops.bmu(state.w, samples)
    zeros = torch.zeros(samples.shape[:1], dtype=torch.int32,
                        device=samples.device)
    return search_lib.SearchResult(idx, q2, zeros, zeros)


def _compact(mask: torch.Tensor, count: int) -> torch.Tensor:
    """The (count,) int64 indices of ``mask``'s true entries in ascending
    order, ``count`` being their number, without reading the device (the
    extra last slot takes the writes of the false entries)."""
    rank = torch.cumsum(mask, 0) - 1
    out = torch.empty(count + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, torch.where(mask, rank, count),
                 torch.arange(mask.shape[0], device=mask.device))
    return out[:count]


def _group_rank(keys: torch.Tensor) -> torch.Tensor:
    """Each entry's rank among the earlier entries with its key."""
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    pos = torch.arange(keys.shape[0], device=keys.device)
    start = torch.ones_like(sk, dtype=torch.bool)
    start[1:] = sk[1:] != sk[:-1]
    first = torch.cummax(torch.where(start, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - first
    return rank


def _make_round_fns(cfg: AFMConfig, ecfg: EventConfig, num_events: int,
                    search: Callable, p_fn: Callable, l_c_fn: Callable,
                    i0: int, far, near, placement=None, dead=None):
    """(sample_round, delivery_round, pool_min, read_round) as closures.

    Cascade ``cid`` uses the schedules at ``i0 + cid`` throughout, the
    values its own sample round saw. ``read_round(es)`` is ``pool_min`` read
    back in one host sync: ``(tmin, gmin, cmin, sel, nsel, have)``.
    ``dead`` (N,) bool replaces the plan's ``dead_units`` (a test seam: the
    JAX package draws its set with another sampler).
    """
    placement = placement_base.resolve_placement(placement)
    n, side, theta = cfg.n_units, cfg.side, cfg.theta
    m, max_waves, _ = _resolve(cfg, ecfg, num_events)
    scale = placement.pack_scale(cfg, ecfg, num_events)
    selector = placement.make_selector(cfg, ecfg, num_events)
    src4, dst4, dirs4 = placement.routing(near)
    near_ok = near >= 0
    dev = near.device
    delay = np.float32(ecfg.delay)
    # the fault sidecar: each axis a plain branch, so an inactive plan runs
    # the fault-free code and consumes the fault-free draws
    plan = ecfg.plan
    loss_on = ecfg.fault_active and plan.p_loss > 0.0
    p_loss = float(np.float32(plan.p_loss))
    dead_on = ecfg.fault_active and plan.dropout_active
    if dead_on:
        dead_sel = (plan.dead_units(n) if dead is None
                    else torch.as_tensor(dead, dtype=torch.bool)).to(dev)
        d_lo = np.float32(plan.dropout_start)
        d_hi = np.float32(plan.dropout_start + plan.dropout_len)

    def dead_at(t):
        """The (N,) dead mask at simulated time ``t`` (a float32), ``None``
        outside the window: decided on the host, no device read."""
        return dead_sel if dead_on and d_lo <= t < d_hi else None

    def pool_min(es: EventState):
        return selector(es.msg_t, es.msg_key, es.msg_gen, es.msg_cid)

    def read_round(es: EventState):
        tmin, gmin, cmin, sel, have = pool_min(es)
        bits, g, ci, nsel = torch.stack([
            tmin.view(torch.int32).long(), gmin.long(), cmin.long(),
            sel.sum()]).tolist()
        tmin = np.array(bits, np.int32).view(np.float32)[()]
        return tmin, g, ci, sel, nsel, bits != placement_single.INF_BITS

    def fire_counts(fired, *extra):
        """[units firing, messages they send, *extra], one host sync."""
        return torch.stack([fired.sum(), (fired[:, None] & near_ok).sum(),
                            *extra]).tolist()

    def fire(es: EventState, fired, cid: int, t, gen: int, nfired: int,
             nvalid: int):
        """Broadcast after theta: ``fired`` units reset their counters and
        enqueue their weights to their near neighbours, timed by the latency
        model. The r-th message takes the r-th free slot of the ring;
        messages past the free count are dropped (counted). ``fired``
        excludes dead units (the callers mask it). Broadcast loss: every
        message counts in ``sent``, then one ``uniform((4N,))`` of the
        plan's source decides which are lost (``dropped_fault``), and the
        kept ones are counted in one more host read."""
        es.sizes[cid] += nfired
        if not nfired:
            return
        es.c.masked_fill_(fired, 0)
        valid = (fired[:, None] & near_ok).reshape(-1)          # (4N,)
        es.sent += nvalid
        if loss_on:
            valid &= es.faults.uniform((4 * n,)) >= p_loss
            nkept = int(valid.sum())
            es.dropped_fault += nvalid - nkept
            nvalid = nkept
        if ecfg.latency == "exponential":
            delays = es.lat.exponential((4 * n,)) * float(delay)
        cand = _compact(valid, nvalid)
        nalloc = min(nvalid, es.free_n)
        es.dropped += nvalid - nalloc
        if not nalloc:
            return
        cand = cand[:nalloc]
        slots = es.free_ring[(es.free_head
                              + torch.arange(nalloc, device=dev)) % m]
        if ecfg.latency == "exponential":
            es.msg_t.index_copy_(0, slots, delays[cand] + float(t))
        else:
            due = t + delay if ecfg.latency == "constant" else t
            es.msg_t.index_fill_(0, slots, float(due))
        if scale is not None:
            es.msg_key.index_fill_(0, slots, gen * scale + cid)
        else:
            es.msg_gen.index_fill_(0, slots, gen)
            es.msg_cid.index_fill_(0, slots, cid)
        es.msg_dst.index_copy_(0, slots, dst4[cand])
        es.msg_dir.index_copy_(0, slots, dirs4[cand])
        es.msg_w.index_copy_(0, slots, es.w[src4[cand]])
        es.free_head = (es.free_head + nalloc) % m
        es.free_n -= nalloc
        es.inflight[cid] += nalloc

    def release(es: EventState, cid: int):
        """A cascade with nothing in flight draws no more."""
        if not es.inflight[cid]:
            es.casc[cid] = None
            es.blocks.pop(cid, None)

    def sample_round(es: EventState, sample, draws):
        """Deliver the next sample: the search routes it, the GMU adapts
        (Eq. 3) and is driven w.p. p_i; a threshold crossing fires. Draws:
        the search's, then the cascade's child and its drive. A dead GMU is
        still searched and its drive drawn, but it neither adapts nor is
        driven nor stamped; the sample counts in ``samples_dead``."""
        ev = es.ev
        t_s = np.float32(ev) * np.float32(ecfg.sample_spacing)
        p_i = p_fn(es.i, cfg)
        st = AFMState(es.w, es.c, far, near, es.i)
        res = search(st, sample[None, :], draws, cfg)
        child = draws.spawn()
        drive = child.uniform((8, side, side)) < p_i
        g = res.gmu[:1].long()
        row = es.w[g]
        new = row + cfg.l_s * (sample[None, :] - row)
        # B = 1: the GMU made one adaptation, so only drive slot 0 counts
        inc = drive.reshape(8, n)[0][g].to(torch.int32)
        dead = dead_at(t_s)
        if dead is None:
            es.w.index_copy_(0, g, new)
            es.c.index_add_(0, g, inc)
            es.clock.index_fill_(0, g, float(t_s))
            es.nevents.index_add_(0, g, torch.ones_like(inc))
        else:
            alive = ~dead[g]
            es.w.index_copy_(0, g, torch.where(alive[:, None], new, row))
            es.c.index_add_(0, g, inc * alive)
            es.clock.index_copy_(0, g, torch.where(alive, float(t_s),
                                                   es.clock[g]))
            es.nevents.index_add_(0, g, alive.to(torch.int32))
        es.casc[ev] = child
        es.gmu[ev:ev + 1] = res.gmu[:1]
        es.q2[ev:ev + 1] = res.q2[:1]
        es.greedy[ev:ev + 1] = res.greedy_steps[:1]
        es.i += 1
        es.ev += 1
        es.t = t_s
        es.rounds += 1
        if dead is not None:
            # dead units do not fire; the dead count rides on the fire
            # counts' host read
            fired0 = (es.c >= theta) & ~dead
            nfired, nvalid, ndead = fire_counts(fired0, dead[g].sum())
            es.samples_dead += ndead
            if max_waves >= 1:
                fire(es, fired0, ev, t_s, 1, nfired, nvalid)
        elif max_waves >= 1:
            fired0 = es.c >= theta
            fire(es, fired0, ev, t_s, 1, *fire_counts(fired0))
        release(es, ev)

    def wave_draws(es: EventState, cid: int, k_wave: int, p_i: float):
        """(4, N) Bernoulli draws of cascade ``cid``'s ``k_wave``-th
        delivery round (1-based): from its block, drawn at its first round,
        for the first ``WAVE_CAP`` rounds, then one draw a round."""
        child = es.casc[cid]
        if k_wave > WAVE_CAP:
            return (child.uniform((4, side, side)) < p_i).reshape(4, n)
        block = es.blocks.get(cid)
        if block is None:
            block = (child.uniform((WAVE_CAP, 4, side, side)) < p_i
                     ).reshape(WAVE_CAP, 4, n)
            es.blocks[cid] = block
        return block[k_wave - 1]

    def delivery_round(es: EventState, tmin, gmin: int, cmin: int, sel,
                       nsel: int | None = None):
        """Deliver one round of weight broadcasts (one cascade wave): every
        receiver adapts by the merged rule, is driven once per received
        message, and newly super-threshold receivers fire.

        The round's ``nsel`` slots (read with the key; ``None`` reads it)
        are gathered, their payloads summed per receiver in direction-slot
        order, then slot order (JAX's scatter order; each pass of the sum
        has unique receivers, so it is deterministic on the card too), and
        the update is a row scatter over the receivers. A message to a dead
        unit is consumed and its slot freed, but not delivered (no drive,
        adapt or stamp): it counts in ``dropped_fault``, its count read
        with the round's other counts."""
        cid, tmin = int(cmin), np.float32(tmin)
        sched_i = i0 + cid
        l_c = l_c_fn(sched_i, cfg)
        p_i = p_fn(sched_i, cfg)
        k_wave = int(es.wcount[cid]) + 1
        bern = wave_draws(es, cid, k_wave, p_i)
        if nsel is None:
            nsel = int(sel.sum())
        idx = _compact(sel, nsel)
        dsts, dirs, ws = es.msg_dst[idx], es.msg_dir[idx], es.msg_w[idx]
        dead = dead_at(tmin)
        # counter drive: one Bernoulli per received message; ``ones`` marks
        # the delivered messages (those to a live unit)
        if dead is None:
            ok, drive = None, bern[dirs, dsts]
            ones = torch.ones_like(dsts, dtype=torch.int32)
        else:
            ok = ~dead[dsts]
            drive, ones = bern[dirs, dsts] & ok, ok.to(torch.int32)
        es.c.index_add_(0, dsts, drive.to(torch.int32))
        n_recv = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
            0, dsts, ones)
        received = n_recv > 0
        allowed = (es.c >= theta) & received
        if k_wave >= max_waves:
            allowed = torch.zeros_like(allowed)
        pair = dsts * 4 + dirs
        reps = torch.zeros(4 * n, dtype=torch.int32, device=dev).index_add_(
            0, pair, ones).max()
        counts = [received.sum(), reps.long(), allowed.sum(),
                  (allowed[:, None] & near_ok).sum()]
        if ok is not None:
            counts.append(ones.sum())
        nrecv, reps, nfired, nvalid, *ndeliv = torch.stack(counts).tolist()
        ndeliv = ndeliv[0] if ndeliv else nsel
        ridx = _compact(received, nrecv)
        pos = (torch.cumsum(received, 0) - 1)[dsts]
        rank = _group_rank(pair) if reps > 1 else None
        acc = torch.zeros((nrecv + 1, cfg.dim), device=dev)
        for s4 in range(4):
            for r in range(reps):
                take = dirs == s4 if rank is None else (dirs == s4) & (
                    rank == r)
                if ok is not None:
                    take &= ok
                acc.index_add_(0, torch.where(take, pos, nrecv), ws)
        wr = es.w[ridx]
        nf = n_recv[ridx].to(wr.dtype)
        es.w.index_copy_(0, ridx, wr + l_c * (acc[:nrecv] - nf[:, None] * wr))
        es.clock.masked_fill_(received, float(tmin))
        es.nevents += n_recv
        # free the delivered slots: their ids go onto the ring's tail
        es.msg_t.index_fill_(0, idx, float("inf"))
        es.free_ring.index_copy_(0, (es.free_head + es.free_n + torch.arange(
            nsel, device=dev)) % m, idx)
        es.free_n += nsel
        es.inflight[cid] -= nsel
        es.wcount[cid] = k_wave
        es.deliveries += ndeliv
        es.dropped_fault += nsel - ndeliv
        es.rounds += 1
        es.t = tmin
        fire(es, allowed, cid, tmin, int(gmin) + 1, nfired, nvalid)
        release(es, cid)

    return sample_round, delivery_round, pool_min, read_round


def _finish(es: EventState, far, near):
    """The end-of-run (state, aux, report). Messages stranded by a
    ``max_rounds`` exit count as dropped; unconsumed samples show in the
    report's sample count."""
    dev = es.w.device
    final = AFMState(es.w, es.c, far, near, es.i)
    aux = afm_lib.StepAux(
        gmu=es.gmu[:, None], q2=es.q2[:, None],
        cascade_size=torch.as_tensor(es.sizes, device=dev),
        waves=torch.as_tensor(es.wcount, device=dev),
        greedy_steps=es.greedy[:, None])
    stranded = es.msg_t.shape[0] - es.free_n
    report = EventReport(
        rounds=es.rounds, samples=es.ev, deliveries=es.deliveries,
        dropped=es.dropped + stranded, t_end=float(es.t), clock=es.clock,
        nevents=es.nevents, sent=es.sent, dropped_fault=es.dropped_fault,
        stranded=stranded, samples_dead=es.samples_dead,
        shard_counts=((es.sent, es.deliveries, es.dropped, es.dropped_fault,
                       stranded),))
    return final, aux, report


def _zero_fast_ok(cfg: AFMConfig, ecfg: EventConfig, num_events: int) -> bool:
    """True when the fast path is equivalent to simulating the rounds: zero
    latency, no round budget, auto engine, and a pool that cannot overflow
    (at zero latency it holds at most one fire's 4N messages)."""
    m = _resolve(cfg, ecfg, num_events)[0]
    return (ecfg.latency == "zero" and ecfg.engine == "auto"
            and ecfg.max_rounds is None and m >= 4 * cfg.n_units
            and not ecfg.fault_active)


def _make_fused_zero(cfg: AFMConfig, ecfg: EventConfig, num_events: int,
                     search: Callable, p_fn: Callable, l_c_fn: Callable):
    """Zero-latency fast path: one training step per sample, on the kernels
    (``body_fused``: ``fused_step``; ``body``: the search, the plain merge
    and ``drive_cascade``), plus an accounting sidecar that reproduces the
    engine's ``EventReport``: the steps' receive counts stamp the receivers'
    clocks, and the sample events fold in after the loop."""
    n, d, side, theta = cfg.n_units, cfg.dim, cfg.side, cfg.theta
    max_waves = _resolve(cfg, ecfg, num_events)[1]
    budget = min(WAVE_CAP, max_waves)
    e, spacing = num_events, ecfg.sample_spacing
    in_kernel = search is search_exact

    def body_fused(w, c, nev, clock, sample, draws, i, t_s, far, near):
        # search in the kernel (exact) or outside it (the relay race);
        # ``recv0=nev`` threads the receipts through the step
        st = AFMState(w, c, far, near, i)
        res = None if in_kernel else search(st, sample, draws, cfg)
        parts = fused_ops.fused_step_parts(
            w, c, sample, draws.spawn(), cfg, l_c=l_c_fn(i, cfg),
            p_i=p_fn(i, cfg), search_result=res, wave_cap=WAVE_CAP,
            recv0=nev)
        clock = torch.where(parts.recv != nev, t_s, clock)
        ys = (parts.gmu, parts.q2, parts.greedy, parts.size, parts.waves)
        return parts.w, parts.c, parts.recv, clock, ys

    def body(w, c, nev, clock, sample, draws, i, t_s, far, near):
        l_c, p_i = l_c_fn(i, cfg), p_fn(i, cfg)
        st = AFMState(w, c, far, near, i)
        res = search(st, sample, draws, cfg)
        w2, counts = afm_lib.adapt_gmu(st, sample, res.gmu, cfg)
        child = draws.spawn()
        drive, bern = cascade_ops.draw_block(child, side, p_i, WAVE_CAP)
        out = cascade_ops.drive_cascade(
            w2, c.reshape(side, side),
            counts.to(torch.int32).reshape(side, side), drive, bern,
            l_c=l_c, theta=theta, budget=budget)
        w, c2, size, waves, recv = cascade_ops.finish_tail(
            *out, child, l_c=l_c, p_i=p_i, theta=theta, budget=budget,
            max_waves=max_waves)
        recv = recv.reshape(-1)
        clock = torch.where(recv > 0, t_s, clock)
        ys = (res.gmu, res.q2, res.greedy_steps, size, waves)
        return w.reshape(n, d), c2.reshape(-1), nev + recv, clock, ys

    def go(state: AFMState, samples, draws, lat_draws, donate=False,
           fault_draws=None, dead=None):
        # no delays and no faults here; the kernels write out of place
        del lat_draws, donate, fault_draws, dead
        far, near, i0 = state.far, state.near, int(state.i)
        dev = state.w.device
        w, c = state.w, state.c.to(torch.int32)
        nev = torch.zeros(n, dtype=torch.int32, device=dev)
        clock = torch.zeros(n, dtype=torch.float32, device=dev)
        ys = []
        for ev in range(e):
            t_s = float(np.float32(ev) * np.float32(spacing))
            sample = samples[ev:ev + 1]
            step = body_fused if ecfg.kernel == "fused" else body
            w, c, nev, clock, y = step(w, c, nev, clock, sample, draws,
                                       i0 + ev, t_s, far, near)
            ys.append(y)
        cols = list(zip(*ys))
        gmu, q2, greedy = (torch.cat(col)[:, None] for col in cols[:3])
        sizes, waves = (torch.stack([x.reshape(()) for x in col]).to(
            torch.int32) for col in cols[3:])
        deliv, nwaves = torch.stack([nev.sum(), waves.sum()]).tolist()
        # fold in the sample events: one per step at its GMU, at time
        # ev * spacing (a unit's clock is its latest event, so an
        # elementwise max merges the two histories)
        g = gmu[:, 0].long()
        t_ev = torch.arange(e, dtype=torch.float32, device=dev) * spacing
        nev = nev.index_add(0, g, torch.ones(e, dtype=torch.int32,
                                             device=dev))
        clock = torch.maximum(clock, torch.zeros_like(clock).scatter_reduce(
            0, g, t_ev, reduce="amax"))
        final = AFMState(w, c, far, near, i0 + e)
        aux = afm_lib.StepAux(gmu=gmu.to(torch.int32), q2=q2,
                              cascade_size=sizes, waves=waves,
                              greedy_steps=greedy.to(torch.int32))
        # zero latency and a 4N pool never drop, lose or strand a message:
        # every attempted broadcast is delivered
        report = EventReport(
            rounds=e + nwaves, samples=e, deliveries=deliv, dropped=0,
            t_end=float(np.float32((e - 1) * spacing)), clock=clock,
            nevents=nev, sent=deliv, stranded=0,
            shard_counts=((deliv, deliv, 0, 0, 0),))
        return final, aux, report

    return go


def _make_engine(cfg: AFMConfig, ecfg: EventConfig, num_events: int,
                 search: Callable, p_fn: Callable, l_c_fn: Callable,
                 placement=None):
    """The default runner: before each of the E sample arrivals, drain the
    due messages round by round; then drain to quiescence. Pops min(message
    key, next arrival), messages first on a time tie."""
    e, spacing = num_events, np.float32(ecfg.sample_spacing)
    m, _, round_cap = _resolve(cfg, ecfg, num_events)

    def go(state: AFMState, samples, draws, lat_draws, donate=False,
           fault_draws=None, dead=None):
        es = init_events(state, cfg, ecfg, e, lat_draws, donate, fault_draws)
        sample_round, delivery_round, _, read_round = _make_round_fns(
            cfg, ecfg, e, search, p_fn, l_c_fn, i0=es.i, far=state.far,
            near=state.near, placement=placement, dead=dead)

        def drain(t_limit):
            # round_cap is a safety net against engine faults, not a
            # budget; a trip shows up as stranded messages
            while es.free_n < m and es.rounds < round_cap:
                tmin, g, ci, sel, nsel, have = read_round(es)
                if not (have and tmin <= t_limit):
                    return
                delivery_round(es, tmin, g, ci, sel, nsel)

        for ev in range(e):
            drain(np.float32(ev) * spacing)
            sample_round(es, samples[ev], draws)
        drain(np.float32(np.inf))
        return _finish(es, state.far, state.near)

    return go


def _make_budgeted(cfg: AFMConfig, ecfg: EventConfig, num_events: int,
                   search: Callable, p_fn: Callable, l_c_fn: Callable,
                   placement=None):
    """Budgeted runner (``max_rounds`` set): one loop popping a round per
    iteration under a global round budget, with exact truncation
    accounting."""
    e, spacing = num_events, np.float32(ecfg.sample_spacing)
    m, _, max_rounds = _resolve(cfg, ecfg, num_events)

    def go(state: AFMState, samples, draws, lat_draws, donate=False,
           fault_draws=None, dead=None):
        es = init_events(state, cfg, ecfg, e, lat_draws, donate, fault_draws)
        sample_round, delivery_round, _, read_round = _make_round_fns(
            cfg, ecfg, e, search, p_fn, l_c_fn, i0=es.i, far=state.far,
            near=state.near, placement=placement, dead=dead)
        while (es.ev < e or es.free_n < m) and es.rounds < max_rounds:
            have = False
            if es.free_n < m:
                tmin, g, ci, sel, nsel, have = read_round(es)
            t_next = (np.float32(es.ev) * spacing if es.ev < e
                      else np.float32(np.inf))
            # messages first on a time tie: an in-flight front is older
            # than a fresh arrival at the same instant
            if have and tmin <= t_next:
                delivery_round(es, tmin, g, ci, sel, nsel)
            else:
                sample_round(es, samples[es.ev], draws)
        return _finish(es, state.far, state.near)

    return go


def _empty_run(state: AFMState, cfg: AFMConfig):
    dev = state.w.device
    zeros = afm_lib._empty_aux(dataclasses.replace(cfg, batch=1), dev)
    n = cfg.n_units
    return state, zeros, EventReport(
        0, 0, 0, 0, 0.0, torch.zeros(n, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev))


def run_events(state: AFMState, samples: torch.Tensor, draws,
               cfg: AFMConfig, ecfg: EventConfig = EventConfig(), *,
               search: Callable = afm_lib.search_heuristic,
               p_fn: Callable = _default_p, l_c_fn: Callable = _default_l_c,
               lat_draws=None, lat_seed: int = 0, donate: bool = False,
               placement=None, shards: int | None = None, fault_draws=None,
               dead=None) -> tuple[AFMState, afm_lib.StepAux, EventReport]:
    """Simulate E sample-delivery events (and their cascades) to
    quiescence, so the result is a plain dense ``AFMState`` with nothing in
    flight; a ``max_rounds`` exit counts its stranded messages into
    ``report.dropped``.

    Args:
      state:     dense starting state, on the run's device.
      samples:   (E, D) float32, the per-event samples, on that device.
      draws:     the run's draw source (search draws and one child per
                 sample event, see the module docstring).
      cfg/ecfg:  AFM dynamics and event-engine configuration.
      search:    ``(state, samples, draws, cfg) -> SearchResult``:
                 ``afm.search_heuristic`` (the relay race) or
                 ``search_exact`` (the ``bmu`` kernel, which
                 ``afm.search_exact`` is mapped to; the fused fast path
                 searches in its kernel instead).
      p_fn/l_c_fn: schedule overrides ``(i, cfg) -> float``.
      lat_draws: the exponential latency's draw source (one
                 ``exponential((4N,))`` per broadcast that enqueues);
                 ``None`` makes ``GeneratorDraws(lat_seed)``, and on a
                 multi-shard mesh its ``fold_in(shard)``.
      donate:    let the run update ``state.w`` and ``state.c`` in place
                 (the engine runners; the fast path writes out of place).
      placement: ``None`` / ``'single'`` (one pool, one device),
                 ``'mesh'`` or a ``Placement`` (``core.placement``).
      shards:    shard count for ``placement='mesh'`` (``None`` -> 1).
      fault_draws: an active plan's draw source (one ``uniform((4N,))``
                 per broadcast that sends, under ``p_loss``); ``None``
                 makes ``GeneratorDraws(plan.seed)`` for this run (on a
                 multi-shard mesh its ``fold_in(shard)``).
      dead:      (N,) bool, the dead set in place of the plan's
                 ``dead_units`` (a test seam).

    On a multi-shard mesh every rank of the process group calls
    ``run_events`` with the same state and samples, and ``draws``,
    ``lat_draws`` and ``fault_draws`` are that rank's own sources (JAX's
    ``fold_in(key, shard)`` streams; see ``core.placement.mesh``); every
    rank gets the whole dense result. The shard count is part of the
    seeding contract: the same sources and shard count replay bitwise.
    """
    e = int(samples.shape[0])
    if e == 0:
        return _empty_run(state, cfg)
    if search is afm_lib.search_exact:      # exact search runs on the kernel
        search = search_exact
    pl = placement_base.resolve_placement(placement, shards=shards)
    if lat_draws is None:
        lat_draws = GeneratorDraws(lat_seed, state.w.device)
        if pl.shards > 1:
            lat_draws = lat_draws.fold_in(
                placement_mesh.shard_mesh(pl.shards).axis_index(
                    placement_mesh.AXIS))
    go = pl.build_runner(cfg, ecfg, e, search, p_fn, l_c_fn)
    out = go(state, samples.to(torch.float32), draws, lat_draws, donate,
             fault_draws=fault_draws, dead=dead)
    if ecfg.max_rounds is None and ecfg.latency != "zero":
        # quiescence watchdog: with no round budget the engine must drain
        # completely; its internal round cap is a safety net, and a run it
        # truncated would otherwise pass silently
        stranded = out[2].stranded
        if stranded > 0:
            raise RuntimeError(
                f"run_events round budget exhausted at quiescence drain: "
                f"{stranded} message(s) stranded after {out[2].rounds} rounds"
                f" (E={e}, latency={ecfg.latency!r}, delay={ecfg.delay}). The"
                f" per-run safety cap of ~E*(max_waves+2) rounds was hit "
                f"before the pool drained. Set EventConfig.max_rounds for "
                f"budgeted truncation with exact accounting, or reduce the "
                f"delay/sample_spacing ratio.")
    return out
