"""Sharded AFM training over a mesh of ranks, port of
``repro.core.distributed``.

Layout (mesh ``(data, model)``, ``repro_torch.sharding.ShardMesh``, one
process a rank):

- the unit lattice ``(side, side, D)`` is cut into bands of lattice rows
  over the ``model`` axis and replicated over ``data``;
- the sample batch is cut over ``data`` in contiguous blocks.

Communication a step, as in the reference, with each collective's result
read on the host where a loop must end alike on every rank:

- search: each model shard probes ``e / n_model`` of its own units per
  sample, then one (q, idx) min-reduce over ``model`` (an ``all_gather``
  and an argmin, so the lowest shard index wins a tie) elects the
  exploration winner; each greedy hop is one more min-reduce over the
  incumbent's near and far neighbours, evaluated by their owners. The hop
  loop ends on the reduced values, so every rank of a model group leaves
  it at the same hop.
- adaptation: the Eq. 3 merge of (count, sample sum) pairs, summed over the
  data axes (``psum``). The sums are formed per sample over a "same GMU"
  mask, not with ``index_add_``, whose CUDA atomics sum duplicates in no
  fixed order (``afm.adapt_merge``).
- cascade: each wave exchanges one boundary row of (fired, w * fired) with
  each lattice neighbour shard (the ``ppermute`` pair as one
  ``all_gather``), and one ``psum`` of (any fired, firing count) decides,
  on every rank alike, whether the next wave runs.

Randomness: a rank draws from two sources, the counterparts of JAX's
per-rank keys: ``search_draws`` (``fold_in(fold_in(key, data index),
model index)``: ``randint(0, L, (B_local, e // n_model))`` probes) and
``casc_draws`` (``fold_in(fold_in(key, 10_000_019), model index)``,
identical across data shards, since w and c are replicated there: the
drive ``uniform((8, rows, side))``, then one ``uniform((4, rows, side))``
a wave).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import afm
from repro_torch.core.afm import AFMConfig, AFMState

#: JAX's constant folded into the step key for the cascade stream
CASCADE_FOLD = 10_000_019

#: Host reads that are part of the design (``repro_torch.analysis.syncs``):
#: the ranks run in lockstep, so each loop ends on a value reduced over the
#: model axis and read back alike on every rank.
SYNCS_BY_DESIGN = {
    "sharded_cascade": "the wave loop ends on the firing count psum'd "
                       "over the model axis, one read a wave",
    "make_sharded_train_step.greedy": "the descent ends on the reduced "
                                      "`active`, one read a hop",
}


class ShardedAux(NamedTuple):
    cascade_size: torch.Tensor   # () int32, firing incidents over all shards
    waves: torch.Tensor          # () int32
    mean_q2: torch.Tensor        # () f32, over the whole batch


def _argmin_over_axis(q, idx, mesh, axis):
    """Global (min q, its idx) across a mesh axis. q, idx: (B,). One
    ``all_gather`` of both (their 4-byte words side by side), then an argmin
    over the shards: the first, lowest shard index, wins a tie."""
    both = torch.stack([q.to(torch.float32).view(torch.int32),
                        idx.to(torch.int32)])
    g = mesh.all_gather(both, axis)                       # (M, 2, B)
    qs, ids = g[:, 0].view(torch.float32), g[:, 1]
    k = torch.argmin(qs, dim=0)[None]
    return qs.gather(0, k)[0], ids.gather(0, k)[0]


def _halo_rows(x, mesh, axis):
    """Exchange boundary rows along the sharded lattice-row axis.

    x: (rows_local, side, ...) -> (row_above, row_below) each (side, ...),
    zeros at the global lattice boundary. One ``all_gather`` of every
    shard's first and last row stands for JAX's ``ppermute`` pair."""
    n, me = mesh.axis_size(axis), mesh.axis_index(axis)
    g = mesh.all_gather(torch.stack([x[0], x[-1]]), axis)  # (M, 2, side, ..)
    zero = torch.zeros_like(x[0])
    from_above = g[me - 1, 1] if me > 0 else zero
    from_below = g[me + 1, 0] if me < n - 1 else zero
    return from_above, from_below


def _shift4_halo(x, above, below):
    """(up, down, left, right) neighbour values with explicit halo rows.
    x: (R, S[, D])."""
    up = torch.cat([x[1:], below[None]], dim=0)
    dn = torch.cat([above[None], x[:-1]], dim=0)
    zc = torch.zeros_like(x[:, :1])
    lf = torch.cat([x[:, 1:], zc], dim=1)
    rt = torch.cat([zc, x[:, :-1]], dim=1)
    return up, dn, lf, rt


def _shift_sum_halo(x, above, below):
    """4-neighbour sum with explicit halo rows, summed in JAX's order."""
    up, dn, lf, rt = _shift4_halo(x, above, below)
    return up + dn + lf + rt


def sharded_cascade(w, c, fired0, *, l_c, p, theta, draws, mesh, axis,
                    max_waves):
    """Wave toppling with halo exchange. w: (R, S, D) local rows, c and
    fired0: (R, S). Returns (w, c, size, waves) with host ints: the
    firing incidents over all shards and the waves run."""
    rows, side = c.shape
    fired, size, waves = fired0, 0, 0
    while True:
        # the loop predicate and the wave's firing count, reduced over the
        # model axis: every rank reads the same values
        count = int(fired.sum())
        tot = mesh.psum(torch.tensor([count > 0, count]), axis).tolist()
        if not (tot[0] > 0 and waves < max_waves):
            return w, c, size, waves
        size += tot[1]
        bern = (draws.uniform((4, rows, side)) < p).to(torch.int32)
        firedf = fired.to(w.dtype)
        c = torch.where(fired, 0, c)
        wf = w * firedf[..., None]
        above, below = _halo_rows(torch.cat([firedf[..., None], wf], -1),
                                  mesh, axis)
        fa, fb, wa, wb = above[..., 0], below[..., 0], above[..., 1:], \
            below[..., 1:]
        n_recv = _shift_sum_halo(firedf, fa, fb)
        sum_wk = _shift_sum_halo(wf, wa, wb)
        w = w + l_c * (sum_wk - n_recv[..., None] * w)
        recv4 = torch.stack(_shift4_halo(fired.to(torch.int32),
                                         fa.to(torch.int32),
                                         fb.to(torch.int32)))
        c = c + torch.sum(bern * recv4, dim=0, dtype=torch.int32)
        fired = (c >= theta) & (n_recv > 0)
        waves += 1


def make_sharded_train_step(cfg: AFMConfig, mesh, *, data_axes=("data",),
                            model_axis: str = "model"):
    """The sharded train step of this rank:
    ``step(state, samples, search_draws, casc_draws) -> (state, aux)``,
    where ``state.w`` is the rank's band of lattice rows ``(rows, side,
    D)``, ``state.c`` its ``(rows * side,)`` counters (``far``, ``near``
    and ``i`` whole), and ``samples`` its block of the batch (``B / n_data``
    rows)."""
    n_model = mesh.axis_size(model_axis)
    side = cfg.side
    if side % n_model:
        raise ValueError(f"side {side} must divide over model={n_model}")
    rows = side // n_model
    length = rows * side
    e_local = max(1, cfg.e // n_model)
    me = mesh.axis_index(model_axis)
    lo = me * length                      # global flat index of row 0

    def local_search(w_flat, samples, search_draws):
        """Probe e_local random local units, then one min-reduce."""
        b = samples.shape[0]
        probes = search_draws.randint(0, length, (b, e_local))
        d = w_flat[probes] - samples[:, None, :]          # (B, e_local, D)
        q = torch.sum(d * d, dim=-1)
        k = torch.argmin(q, dim=-1)[:, None]
        q_best = q.gather(1, k)[:, 0]
        gidx = lo + probes.gather(1, k)[:, 0]
        return _argmin_over_axis(q_best, gidx, mesh, model_axis)

    def greedy(w_flat, samples, qstar, jstar, near, far):
        """Min-reduce greedy descent; candidates evaluated by their
        owner. Ends on the reduced ``active``, alike on every rank."""
        j, q = jstar.long(), qstar
        active = torch.ones_like(j, dtype=torch.bool)
        steps = 0
        while bool(active.any()) and steps < side * side:
            cands = torch.cat([near[j], far[j]], dim=-1).long()   # (B, C)
            local = (cands >= lo) & (cands < lo + length)
            lidx = torch.clamp(cands - lo, 0, length - 1)
            dq = torch.sum((w_flat[lidx] - samples[:, None, :]) ** 2, dim=-1)
            dq = torch.where(local, dq, torch.inf)
            k = torch.argmin(dq, dim=-1)[:, None]
            q_glob, j_glob = _argmin_over_axis(
                dq.gather(1, k)[:, 0], cands.gather(1, k)[:, 0], mesh,
                model_axis)
            improve = active & (q_glob < q)
            j = torch.where(improve, j_glob.long(), j)
            q = torch.where(improve, q_glob, q)
            active = improve
            steps += 1
        return j, q

    def step(state: AFMState, samples, search_draws, casc_draws):
        d = cfg.dim
        w_flat = state.w.reshape(length, d)
        samples = samples.to(torch.float32)
        i = int(state.i)
        l_c, p_i = afm.schedule_values(i, cfg)
        qstar, jstar = local_search(w_flat, samples, search_draws)
        gmu, q2 = greedy(w_flat, samples, qstar, jstar, state.near, state.far)

        # Eq. (3), merged over the data axes
        mine = (gmu >= lo) & (gmu < lo + length)
        loc = torch.clamp(gmu - lo, 0, length - 1)
        counts = torch.zeros(length, dtype=torch.float32,
                             device=w_flat.device)
        counts.index_add_(0, loc, mine.to(torch.float32))
        same = (gmu[:, None] == gmu[None, :]).to(samples.dtype)
        sums = (same[:, :, None] * samples[None]).sum(dim=1)
        tsum = torch.zeros((length + 1, d), dtype=torch.float32,
                           device=w_flat.device)
        tsum.index_copy_(0, torch.where(mine, loc, length), sums)
        tsum = tsum[:length]
        for a in data_axes:
            counts = mesh.psum(counts, a)
            tsum = mesh.psum(tsum, a)
        hit = counts > 0
        mean_target = torch.where(
            hit[:, None], tsum / torch.clamp(counts, min=1.0)[:, None],
            w_flat)
        w_flat = w_flat + cfg.l_s * (mean_target - w_flat)

        # the drive, identical across data shards by the source's making
        max_count = 8
        gmu_counts = counts.to(torch.int32).reshape(rows, side)
        drive = casc_draws.uniform((max_count, rows, side)) < p_i
        allow = (torch.arange(max_count, device=w_flat.device)[:, None, None]
                 < torch.clamp(gmu_counts, max=max_count))
        inc = torch.sum(drive.to(torch.int32) * allow, dim=0,
                        dtype=torch.int32)
        c_grid = state.c.to(torch.int32).reshape(rows, side) + inc
        fired0 = c_grid >= cfg.theta
        max_waves = cfg.max_waves or 8 * cfg.n_units
        w_local, c_grid, size, waves = sharded_cascade(
            w_flat.reshape(rows, side, d), c_grid, fired0, l_c=l_c, p=p_i,
            theta=cfg.theta, draws=casc_draws, mesh=mesh, axis=model_axis,
            max_waves=max_waves)

        new_state = AFMState(w=w_local, c=c_grid.reshape(length),
                             far=state.far, near=state.near,
                             i=i + cfg.batch)
        mean_q2 = q2.mean()
        for a in data_axes:
            mean_q2 = mesh.psum(mean_q2, a) / mesh.axis_size(a)
        aux = ShardedAux(torch.tensor(size, dtype=torch.int32),
                         torch.tensor(waves, dtype=torch.int32), mean_q2)
        return new_state, aux

    return step


def data_index(mesh, data_axes=("data",)) -> int:
    """This rank's flat index over the data axes (row-major)."""
    didx = 0
    for a in data_axes:
        didx = didx * mesh.axis_size(a) + mesh.axis_index(a)
    return didx


def shard_state_for_mesh(state: AFMState, cfg: AFMConfig, mesh,
                         model_axis: str = "model") -> AFMState:
    """This rank's view of a dense ``AFMState``: its band of lattice rows,
    ``w`` (rows, side, D) and ``c`` (rows * side,)."""
    rows = cfg.side // mesh.axis_size(model_axis)
    length = rows * cfg.side
    lo = mesh.axis_index(model_axis) * length
    return AFMState(
        w=state.w[lo:lo + length].reshape(rows, cfg.side, cfg.dim).clone(),
        c=state.c[lo:lo + length].clone(),
        far=state.far, near=state.near, i=int(state.i))


def gather_state(state: AFMState, cfg: AFMConfig, mesh,
                 model_axis: str = "model") -> AFMState:
    """The dense ``AFMState`` of the rank bands: w (N, D), c (N,), on
    every rank."""
    w = mesh.all_gather(state.w.contiguous(), model_axis)
    c = mesh.all_gather(state.c.contiguous(), model_axis)
    return AFMState(w=w.reshape(cfg.n_units, cfg.dim),
                    c=c.reshape(cfg.n_units), far=state.far,
                    near=state.near, i=int(state.i))
