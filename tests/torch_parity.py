"""Helpers shared by the port's parity tests (``tests/test_torch_*.py``).

The JAX package and the port run on the same numpy inputs in one process.
The port takes its random numbers from a ``ReplayDraws`` fed with the draws
that JAX's own key chain produces, built here from ``jax.random`` in the
test process (never from ``tests/golden``), in the order the port asks.
"""
import contextlib

import jax
import numpy as np
import torch

from repro_torch.draws import ReplayDraws
from repro_torch.kernels.bmu import ref as bmu_ref
from repro_torch.sharding import spawn_ranks

F32_EPS = float(np.finfo(np.float32).eps)

# the suite runs in parallel worker processes; one PyTorch thread each keeps
# them from oversubscribing the cores (the inputs here are small)
torch.set_num_threads(1)


def cascade_draws(key, side: int, waves: int) -> list:
    """``drive_and_cascade``'s draws: the 8-draw drive, then one
    ``split`` + ``uniform((4, side, side))`` per wave."""
    k0, key = jax.random.split(key)
    out = [jax.random.uniform(k0, (8, side, side))]
    for _ in range(waves):
        key, sub = jax.random.split(key)
        out.append(jax.random.uniform(sub, (4, side, side)))
    return out


def search_draws(key, n: int, phi: int, b: int, e: int) -> list:
    """``exploration_phase``'s draws: start units, then all e hop choices."""
    k0, k1 = jax.random.split(key)
    return [jax.random.randint(k0, (b,), 0, n),
            jax.vmap(lambda k: jax.random.randint(k, (b,), 0, phi + 1))(
                jax.random.split(k1, e))]


def step_draws(key, cfg, b: int, *, heuristic: bool, waves: int) -> list:
    """The draws one JAX ``afm._step`` consumes, in the port's order."""
    k_search, k_cascade = jax.random.split(key)
    out = search_draws(k_search, cfg.n_units, cfg.phi, b, cfg.e) \
        if heuristic else []
    return out + cascade_draws(k_cascade, cfg.side, waves)


def fused_step_draws(key, cfg, b: int, *, heuristic: bool, wave_cap: int,
                     waves: int) -> list:
    """The draws one fused step consumes, in the port's order, from the
    same chain positions as ``step_draws``: the search's (heuristic only),
    the drive, the first ``wave_cap`` waves' draws stacked into one
    ``(wave_cap, 4, side, side)`` block, then one per wave past the block
    (``waves`` is the step's total wave count)."""
    k_search, k_cascade = jax.random.split(key)
    out = search_draws(k_search, cfg.n_units, cfg.phi, b, cfg.e) \
        if heuristic else []
    chain = cascade_draws(k_cascade, cfg.side, max(waves, wave_cap))
    block = np.stack([np.asarray(x) for x in chain[1:1 + wave_cap]])
    return out + [chain[0], block] + chain[1 + wave_cap:1 + waves]


def train_draws(key, cfg, n_data: int, num_steps: int, waves, *,
                heuristic: bool) -> list:
    """``afm.train``'s draws: per step the sample indices, then the step's."""
    out = []
    for t, k in enumerate(jax.random.split(key, num_steps)):
        ks, kd = jax.random.split(k)
        out.append(jax.random.randint(kd, (cfg.batch,), 0, n_data))
        out += step_draws(ks, cfg, cfg.batch, heuristic=heuristic,
                          waves=int(waves[t]))
    return out


def replay(arrays) -> ReplayDraws:
    """A CPU ``ReplayDraws``; a nested list stays a child's draws."""
    return ReplayDraws([a if isinstance(a, list) else np.asarray(a)
                        for a in arrays], device="cpu")


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def assert_bmu_tier(idx, q2, idx_ref, q2_ref, w, s):
    """ULP tier of a BMU result against a reference on the same f32 inputs:
    q2 within ``tie_bound`` (relative to |s|^2 + |w|^2, as the expanded form
    cancels those terms), and the same index except where the exact top-two
    gap lies within that bound."""
    w, s = t(w), t(s)
    bound = bmu_ref.tie_bound(w, s).numpy()
    idx, idx_ref = np.asarray(idx), np.asarray(idx_ref)
    q2, q2_ref = np.asarray(q2), np.asarray(q2_ref)
    differ = idx != idx_ref
    if differ.any():
        gap = bmu_ref.top2_gap(w, s).numpy()
        assert np.all(gap[differ] <= bound[differ]), (
            np.flatnonzero(differ), gap[differ], bound[differ])
    assert np.all(np.abs(q2 - q2_ref) <= bound), np.max(np.abs(q2 - q2_ref))


def jax_cfg(**kw):
    from repro.core.afm import AFMConfig
    return AFMConfig(**kw)


def torch_cfg(**kw):
    from repro_torch.core.afm import AFMConfig
    return AFMConfig(**kw)


def event_draws(step_keys, cfg, waves, *, heuristic: bool,
                wave_cap: int) -> list:
    """``run_events``' draws for JAX's per-event ``step_keys``, in the
    port's order: per event the search's draws (heuristic only), then a
    nested list, the event's cascade child in the kernel paths' layout from
    JAX's ``k_cascade`` chain: the drive, the first ``wave_cap`` waves'
    draws stacked into one block, then one per delivery round past the
    block; ``waves`` are JAX's per-event delivery-round counts
    (``aux.waves``)."""
    out = []
    for key, w in zip(step_keys, np.asarray(waves).tolist()):
        k_search, k_cascade = jax.random.split(key)
        if heuristic:
            out += search_draws(k_search, cfg.n_units, cfg.phi, 1, cfg.e)
        chain = cascade_draws(k_cascade, cfg.side, max(w, wave_cap))
        block = np.stack([np.asarray(x) for x in chain[1:1 + wave_cap]])
        out.append([chain[0], block] + chain[1 + wave_cap:1 + w])
    return out


def select_run_draws(key, n_data: int, num_steps: int):
    """JAX ``AsyncBackend.run``'s sample selection
    (``_select_run_samples``): the (num_steps,) indices, which the port
    draws first, and the per-event step keys."""
    pairs = jax.vmap(jax.random.split)(jax.random.split(key, num_steps))
    idx = jax.vmap(lambda k: jax.random.randint(k, (1,), 0, n_data))(
        pairs[:, 1])[:, 0]
    return np.asarray(idx), pairs[:, 0]


@contextlib.contextmanager
def recorded_exponentials():
    """Records the exponential draws JAX's event engine makes, in the order
    it makes them: ``jax.random.exponential`` is wrapped with an ordered
    debug callback while the engine is traced anew (its jitted runners are
    cached per config, so the cache is cleared on the way in and out).
    JAX draws one ``exponential((4N,))`` per broadcast that enqueues, from
    its latency key chain; the list replays as the port's latency source."""
    from repro.core import events as jevents
    rec = []
    real = jax.random.exponential

    def wrapped(key, shape=(), dtype=float):
        out = real(key, shape, dtype)
        jax.debug.callback(lambda v: rec.append(np.array(v)), out,
                           ordered=True)
        return out

    jevents._compiled_runner.cache_clear()
    jax.random.exponential = wrapped
    try:
        yield rec
    finally:
        jax.random.exponential = real
        jevents._compiled_runner.cache_clear()


def assert_same_run(jout, tout, w0, data, w_ulps: int):
    """A port ``run_events`` result (state, aux, report) against JAX's:
    integers, accounting and the float32 times bitwise, the weights within
    ``w_ulps`` ulps of the largest weight, q2 within 4x the BMU tie bound of
    the starting weights ``w0`` (the runs are short, so the weights move
    little)."""
    (js, ja, jr), (ts, ta, tr) = jout, tout
    for name, a, b in (("c", js.c, ts.c), ("gmu", ja.gmu, ta.gmu),
                       ("cascade_size", ja.cascade_size, ta.cascade_size),
                       ("waves", ja.waves, ta.waves),
                       ("greedy", ja.greedy_steps, ta.greedy_steps),
                       ("nevents", jr.nevents, tr.nevents),
                       ("clock", jr.clock, tr.clock)):
        np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy(),
                                      err_msg=name)
    assert int(js.i) == ts.i
    for f in ("rounds", "samples", "deliveries", "dropped", "sent",
              "dropped_fault", "stranded", "samples_dead"):
        assert int(getattr(jr, f)) == getattr(tr, f), f
    assert np.float32(jr.t_end) == np.float32(tr.t_end)
    np.testing.assert_array_equal(np.asarray(jr.shard_counts),
                                  np.asarray(tr.shard_counts))
    wj, wt = np.asarray(js.w), ts.w.cpu().numpy()
    assert np.abs(wj - wt).max() <= w_ulps * F32_EPS * np.abs(wj).max()
    samples = np.asarray(data)[:ja.gmu.shape[0]]
    bound = bmu_ref.tie_bound(t(w0), t(samples)).numpy()
    assert np.all(np.abs(np.asarray(ja.q2)[:, 0] - ta.q2[:, 0].cpu().numpy())
                  <= 4 * bound)


def fault_draws(seed: int, n: int, count: int) -> ReplayDraws:
    """An active fault plan's loss draws in JAX's engine: from
    ``PRNGKey(seed)``, per broadcast that sends, ``split`` then
    ``uniform((4N,))``; ``count`` of them (any bound on the run's fires,
    such as its round count), as the port's fault source."""
    def body(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.uniform(sub, (4 * n,))
    _, u = jax.lax.scan(body, jax.random.PRNGKey(seed), None, length=count)
    return replay(list(np.asarray(u)))


class _ChainChild:
    """One cascade's draws from JAX's ``k_cascade`` chain, in the kernel
    paths' layout (``event_draws``), computed as they are asked for."""

    def __init__(self, key, side: int, wave_cap: int):
        self.device = torch.device("cpu")
        self._drive, self._key = jax.random.split(key)
        self._side, self._cap = side, wave_cap

    def _wave(self):
        self._key, sub = jax.random.split(self._key)
        return np.asarray(jax.random.uniform(sub, (4, self._side,
                                                   self._side)))

    def uniform(self, shape):
        s = self._side
        if tuple(shape) == (8, s, s) and self._drive is not None:
            out, self._drive = jax.random.uniform(self._drive, shape), None
        elif tuple(shape) == (self._cap, 4, s, s):
            out = np.stack([self._wave() for _ in range(self._cap)])
        elif tuple(shape) == (4, s, s):
            out = self._wave()
        else:
            raise ValueError(f"unexpected cascade draw {tuple(shape)}")
        return torch.from_numpy(np.array(out, np.float32))


class JaxStepDraws:
    """The draws of ``run_events`` for JAX's per-event ``step_keys``, as
    ``event_draws`` lays them out but computed as they are asked for, so
    no wave count has to be known first: per event the search's draws
    (heuristic only), then ``spawn()``, the event's cascade child."""

    def __init__(self, step_keys, cfg, wave_cap: int):
        self.device = torch.device("cpu")
        self._keys = list(step_keys)
        self._cfg, self._cap = cfg, wave_cap
        self._ev, self._search = 0, None

    def randint(self, low, high, shape):
        if self._search is None:
            k_search, _ = jax.random.split(self._keys[self._ev])
            self._search = search_draws(k_search, self._cfg.n_units,
                                        self._cfg.phi, 1, self._cfg.e)
        arr = np.asarray(self._search.pop(0))
        assert arr.shape == tuple(shape), (arr.shape, shape)
        return torch.from_numpy(arr.astype(np.int64))

    def spawn(self):
        _, k_cascade = jax.random.split(self._keys[self._ev])
        self._ev, self._search = self._ev + 1, None
        return _ChainChild(k_cascade, self._cfg.side, self._cap)


def run_ranks(fn, k: int, timeout: float, *args) -> list:
    """``fn(rank, *args)`` on ``k`` gloo ranks on the CPU (spawned
    processes, ``repro_torch.sharding.spawn_ranks``), each rank's result
    in rank order. Every rank is stopped and the call fails when one
    raises or the ranks outlast ``timeout`` seconds, so a deadlocked
    collective fails the test instead of hanging the suite. ``fn`` lives in
    ``torch_ranks``, which imports no JAX, so the ranks start quickly."""
    return spawn_ranks(fn, k, args, dist_backend="gloo", timeout=timeout)


def full_width_gradients_match_jax(jc, tc, *, seq: int, tol: float,
                                   batch: int = 1) -> None:
    """The loss (next-token CE + ``router_aux_coef`` * aux) and its
    gradient leaf by leaf, the port's ``lm_loss`` against
    ``jax.value_and_grad`` of JAX's same loss, from JAX's weights at seed
    0 on one seeded batch of (batch, seq) tokens: the loss within 1e-5
    relative, each leaf within ``tol`` of that leaf's max |g|. ``jc`` and
    ``tc`` are one config in each package (f32, to compare the math)."""
    import jax.numpy as jnp
    from repro.models import transformer as jtr
    from repro_torch import convert
    from repro_torch.training import train_step

    params = jtr.init_params(jax.random.PRNGKey(0), jc)
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, (batch, seq)).astype(np.int32)

    def jloss(p):
        logits, aux = jtr.forward_train(p, {"tokens": jnp.asarray(toks)}, jc)
        lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        gold = jnp.take_along_axis(lp, jnp.asarray(toks)[:, 1:, None], -1)
        return -jnp.mean(gold) + jc.router_aux_coef * aux

    want_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         tc, "cpu").requires_grad_(True)
    named = dict(model.named_parameters())
    loss = train_step.lm_loss(model, {"tokens": t(toks), "labels": t(toks)},
                              tc)[0]
    grads = torch.autograd.grad(loss, list(named.values()))
    got_loss = float(loss.detach())
    assert abs(got_loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want = jax.tree.map(np.asarray, jgrads)
    for name, g in zip(named, grads):
        w = convert._leaf(want, name)
        assert np.isfinite(w).all(), name
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol * scale, (name, err, scale)


def assert_close(got, want, rtol: float, atol: float) -> None:
    """A port tensor (or array) against a JAX array, as f32."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def assert_caches_close(cache, jcache, rtol: float, atol: float) -> None:
    """An LM cache of the port against JAX's: the same entries and leaves,
    each of JAX's shape and within the tolerance."""
    assert sorted(cache) == sorted(jcache)
    for name, entry in cache.items():
        assert sorted(entry) == sorted(jcache[name]), name
        for leaf, x in entry.items():
            assert tuple(x.shape) == tuple(jcache[name][leaf].shape)
            assert_close(x, jcache[name][leaf], rtol, atol)


def assert_greedy_agrees(got, want, logits, tol: float) -> None:
    """Greedy tokens (B, n) of the port equal JAX's ``want``, except from a
    step whose top-two logits (the port's ``logits`` (B, n, V)) lie within
    ``tol``: a near tie may break either way."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    for row in range(want.shape[0]):
        differ = np.flatnonzero(got[row].numpy() != want[row])
        if differ.size:
            top2 = np.sort(logits[row, differ[0]].numpy())[-2:]
            assert top2[1] - top2[0] <= tol, (row, differ[0], top2)
