"""Continuous train-and-serve loop, a map that learns online while serving;
port of ``repro.launch.stream_train``.

The trainer consumes a sample stream (any registered backend; the
event-driven ``async`` backend by default) and periodically publishes its
dense state into the serving stack, while client threads keep reading
through a ``MapGateway``. Publication reuses the serving tier's atomic swap
paths, so readers never observe a torn map:

- **in-memory** (default): ``MapService.swap`` on the attached service:
  in-flight requests finish on the old weights, no disk traffic;
- **store-backed** (``--store``): each publication saves a new artifact
  version and calls ``MapGateway.reload``, the hot reload a separate
  serving process would use.

Everything runs on CUDA unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.stream_train \\
        --dataset satimage --side 6 --events 1024 --swap-every 256

    # the plain PyTorch versions on the CPU, store-backed publication:
    PYTHONPATH=src python -m repro_torch.launch.stream_train --device cpu \\
        --dataset satimage --side 6 --events 1024 --store /tmp/stream-maps

The run reports training-event throughput, swaps, client reads and the
served map's final per-sample quantization error, as ``stream qe: ...
finite=True``.

**Crash resume**: with ``--checkpoint-dir`` the trainer writes a
``TrainCheckpoint`` (the dense state, the latency stream's generator state
and the sample cursor, under SHA-256 checksums) every
``--checkpoint-every`` samples; a SIGTERM checkpoints once more and stops
cleanly (``--die-after N`` raises that SIGTERM from inside the loop).
``--resume`` verifies the checksums (it logs "checkpoint checksum
verified"), restores state, latency stream and cursor, and continues.
Each step's draws come from ``GeneratorDraws.for_step(seed, step)``, which
depends on the step's index alone (JAX's ``fold_in(PRNGKey(seed),
step)``), and an active fault plan's draws restart with every step, so the
resumed run ends on the uninterrupted run's weights bitwise.

**On the mesh** (``--backend async --shards K``): the event engine's row
bands over K ``torch.distributed`` ranks, one process a shard, started by
``torchrun`` (or ranks a caller has joined, ``repro_torch.sharding.
spawn_ranks``). Every rank runs the same ``partial_fit`` chunks on the
same data and draws in lockstep, and each run leaves the dense state on
every rank, so publication needs no collective: rank 0 alone serves (the
gateway, its service or store, the client threads, the final QE) and
writes (artifacts and checkpoints). SIGTERM and ``--die-after`` set a
flag that the ranks reduce (max) at every chunk boundary, so every rank
stops after the same chunk. Rank 0's checkpoint is every rank's: the
dense state is the same on each, and the latency stream's one generator
state is every shard's position (``AsyncBackend``):

    PYTHONPATH=src torchrun --nproc-per-node 2 \\
        -m repro_torch.launch.stream_train --device cpu --dist-backend gloo \\
        --dataset satimage --side 6 --shards 2 --search exact
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import threading
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api import AFMConfig, MapStore, TopoMap
from repro_torch.api.backends import add_backend_argument
from repro_torch.api.persistence import _state_like
from repro_torch.core.afm import AFMState
from repro_torch.core.placement import mesh as mesh_lib
from repro_torch.data import DATASETS, make_dataset
from repro_torch.device import resolve_device
from repro_torch.draws import GeneratorDraws
from repro_torch.launch._ranks import join_ranks, ranks_needed
from repro_torch.serving import GatewayStats, MapGateway, MapService
from repro_torch.serving.maps import to_numpy
from repro_torch.sharding import DIST_BACKENDS, compat
from repro_torch.training.checkpoint import (load_train_checkpoint,
                                             save_train_checkpoint)


@dataclasses.dataclass
class StreamReport:
    """Outcome of one ``run_stream``, returned to callers and printed by the
    CLI. On a mesh every rank returns one, with the same ``events``,
    ``swaps``, ``seconds`` (the slowest rank's) and ``state``; a rank other
    than 0 serves nothing, so its ``client_requests`` is 0, its ``qe`` empty
    and its ``gateway`` a zero ``GatewayStats``."""
    events: int                 # training samples consumed
    seconds: float              # trainer wall time
    swaps: int                  # publications into the serving stack
    client_requests: int        # gateway reads served during training
    client_errors: list         # exceptions raised in client threads
    qe: np.ndarray              # final per-sample quantization errors
    gateway: GatewayStats
    interrupted: bool = False   # stopped early on SIGTERM / die_after
    checkpoint_path: str | None = None   # last checkpoint written (if any)
    resumed_from: dict | None = None     # resumed cursor (if resume hit)
    state: AFMState | None = None        # this rank's final dense state

    @property
    def events_per_sec(self) -> float:
        return self.events / self.seconds if self.seconds > 0 else 0.0

    @property
    def qe_finite(self) -> bool:
        return bool(np.isfinite(self.qe).all())


def _lat_state(tm):
    """The async backend's latency-stream position, or ``None``."""
    lat = getattr(tm.backend, "lat_draws", None)
    return None if lat is None else lat.generator.get_state()


def _rank_mesh(tm):
    """The ranks' mesh of a backend that trains over several processes
    (the async backend's multi-shard mesh placement), or ``None``."""
    shards = getattr(getattr(tm.backend, "placement", None), "shards", 1)
    return mesh_lib.shard_mesh(shards) if shards > 1 else None


def run_stream(cfg: AFMConfig, train_data, eval_data, *,
               backend: str = "async", backend_options: dict | None = None,
               events: int = 1024, chunk: int = 64, swap_every: int = 256,
               clients: int = 2, client_batch: int = 8,
               store_root: str | None = None, name: str = "stream",
               max_delay: float = 0.001, seed: int = 0,
               min_client_reads: int = 1,
               checkpoint_dir: str | None = None, checkpoint_every: int = 0,
               resume: bool = False, die_after: int | None = None,
               log=None, device: torch.device | str | None = None,
               draws_for_step: Callable | None = None) -> StreamReport:
    """Train on ``events`` samples while serving concurrent gateway reads.

    The stream is ``train_data`` cycled in ``chunk``-sized ``partial_fit``
    steps; every ``swap_every`` consumed samples the trainer publishes its
    state (see the module docstring). ``clients`` reader threads issue
    ``client_batch``-sized ``quantization_errors`` requests against the
    gateway for the whole run; the loop keeps serving until at least
    ``min_client_reads`` requests landed (a bounded wait), so the report
    reflects real train/serve overlap.

    ``checkpoint_dir`` turns on crash resume: a ``TrainCheckpoint`` every
    ``checkpoint_every`` consumed samples (default ``swap_every``) and once
    more on SIGTERM, cut at chunk boundaries, where the event engine has
    drained: the dense state, the latency stream's position and the cursor
    are the whole in-flight state. ``die_after=N`` raises SIGTERM from
    inside the loop once N samples are consumed.

    On a multi-shard mesh (``backend_options`` ``placement="mesh"``,
    ``shards=K``) every rank of the process group calls this with the same
    arguments; see the module docstring. Rank 0 alone serves and writes
    (the store, the checkpoints), the stop flag is reduced over the ranks
    at every chunk boundary, and the ranks meet after a checkpoint is
    written, so a rank that resumes reads it whole.

    ``device``: where the map trains and serves (CUDA unless the caller
    asks for the CPU). ``draws_for_step``: ``step -> Draws``, the draw
    source of step ``step`` (0 is the warm start); by default
    ``GeneratorDraws.for_step(seed, step, device)``. A test seam: a parity
    test feeds JAX's per-step draws through it.
    """
    log = log or (lambda *_: None)
    device = resolve_device(device)
    if draws_for_step is None:
        def draws_for_step(step):
            return GeneratorDraws.for_step(seed, step, device)
    train_data = torch.as_tensor(train_data, dtype=torch.float32,
                                 device=device)
    eval_data = to_numpy(eval_data).astype(np.float32, copy=False)
    n_train = train_data.shape[0]
    chunk = max(1, min(chunk, events))
    if checkpoint_dir and checkpoint_every <= 0:
        checkpoint_every = swap_every
    if (resume or die_after is not None) and not checkpoint_dir:
        raise ValueError("resume/die_after need checkpoint_dir set")

    resumed_from = None
    consumed = 0
    cursor = {"pos": 0, "step": 1, "since_swap": 0, "swaps": 0}
    opts = dict(backend_options or {})
    if resume:
        tc = load_train_checkpoint(
            checkpoint_dir, state_like=_state_like(cfg, device),
            expect_config=dataclasses.asdict(cfg))
        tm = TopoMap.from_state(tc.state, cfg, backend=backend,
                                backend_options=opts, seed=seed,
                                device=device)
        if tc.lat_state is not None and _lat_state(tm) is not None:
            tm.backend.lat_draws.generator.set_state(tc.lat_state)
        consumed = int(tc.cursor.get("consumed", 0))
        cursor = {k: int(tc.cursor.get(k, cursor[k])) for k in cursor}
        resumed_from = dict(tc.cursor)
        log(f"resume: checkpoint checksum verified — continuing at event "
            f"{consumed} (step {cursor['step']}, {len(tc.checksums)} "
            f"payload files)")
    else:
        tm = TopoMap(cfg, backend=backend, backend_options=opts, seed=seed,
                     device=device)
        # warm start: the serving stack opens with a fitted state
        first = train_data[:chunk]
        tm.partial_fit(first, draws=draws_for_step(0))
        consumed += len(first)

    mesh = _rank_mesh(tm)
    serving = mesh is None or mesh.rank == 0
    last_ckpt = consumed
    checkpoint_path = None

    def save_ckpt() -> None:
        nonlocal last_ckpt, checkpoint_path
        if serving:
            save_train_checkpoint(
                checkpoint_dir, config=dataclasses.asdict(cfg),
                state=tm.state_, cursor={"consumed": consumed, **cursor},
                lat_state=_lat_state(tm),
                meta={"name": name, "events_target": events, "seed": seed})
            log(f"  checkpoint at {consumed} events -> {checkpoint_dir}")
        last_ckpt = consumed
        checkpoint_path = checkpoint_dir

    def reduce_max(x):
        """The max of a host value over the ranks: one collective, which no
        rank leaves before every rank has reached it."""
        if mesh is None:
            return x
        t = torch.tensor([x], dtype=torch.float64)
        return type(x)(mesh.pmax(t, mesh_lib.AXIS).item())

    store = gw = svc = None
    if serving and store_root:
        store = MapStore(store_root)
        store.save(tm, name)
        gw = MapGateway(store=store, max_delay=max_delay, device=device)
        gw.open(name)
    elif serving:
        gw = MapGateway(max_delay=max_delay, device=device)
        svc = MapService.from_estimator(tm)
        gw.attach(name, svc)

    stop = threading.Event()
    requests = [0] * max(clients, 1)
    errors: list = []

    def client(worker: int):
        rng = np.random.default_rng(seed + 1 + worker)
        try:
            while not stop.is_set():
                lo = int(rng.integers(0, max(1, len(eval_data) - client_batch)))
                q = gw.quantization_errors(name, eval_data[lo:lo + client_batch])
                if not np.isfinite(q).all():
                    raise AssertionError(f"non-finite QE from client {worker}")
                requests[worker] += 1
        except Exception as e:  # noqa: BLE001 (reported to the caller)
            errors.append(e)

    threads = [threading.Thread(target=client, args=(w,), daemon=True)
               for w in range(clients if serving else 0)]

    def publish() -> None:
        if store is not None:
            store.save(tm, name)
            gw.reload(name)
        elif svc is not None:
            svc.swap(tm.state_)

    # SIGTERM sets a stop flag checked at chunk boundaries; the previous
    # handler is restored on exit. Off the main thread die_after sets the
    # flag directly.
    interrupt = threading.Event()
    prev_handler = None
    handler_installed = False
    if checkpoint_dir and threading.current_thread() is threading.main_thread():
        prev_handler = signal.signal(signal.SIGTERM,
                                     lambda *_: interrupt.set())
        handler_installed = True
    interrupted = False
    qe, stats = np.zeros((0,), np.float32), GatewayStats()
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        if not resume:
            cursor["pos"] = consumed % n_train
            cursor["since_swap"] = consumed
        while consumed < events:
            take = min(chunk, events - consumed)
            idx = (torch.arange(take, device=device) + cursor["pos"]) % n_train
            cursor["pos"] = (cursor["pos"] + take) % n_train
            tm.partial_fit(train_data[idx],
                           draws=draws_for_step(cursor["step"]))
            consumed += take
            cursor["since_swap"] += take
            cursor["step"] += 1
            if cursor["since_swap"] >= swap_every:
                publish()
                cursor["swaps"] += 1
                cursor["since_swap"] = 0
                if serving:
                    log(f"  published after {consumed} events (swap "
                        f"{cursor['swaps']}, {sum(requests)} reads served)")
            if checkpoint_dir and consumed - last_ckpt >= checkpoint_every:
                save_ckpt()
            if die_after is not None and consumed >= die_after:
                die_after = None        # deliver the kill exactly once
                if handler_installed:   # through the real signal handler
                    signal.raise_signal(signal.SIGTERM)
                else:
                    interrupt.set()
            # on a mesh every rank stops on the reduced flag, after the same
            # chunk; the reduction is also the ranks' meeting after a
            # checkpoint written in this chunk
            if reduce_max(int(interrupt.is_set())):
                interrupted = True
                save_ckpt()             # the state the resume picks up
                reduce_max(0)           # the ranks meet after the write
                log(f"  interrupted at {consumed} events — checkpoint "
                    f"saved, resume with --resume")
                break
        if not interrupted and cursor["since_swap"]:
            publish()                   # the final state reaches serving
            cursor["swaps"] += 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = reduce_max(time.perf_counter() - t0)
        if serving:
            if clients > 0 and not interrupted:
                deadline = time.perf_counter() + 30.0
                while (sum(requests) < min_client_reads and not errors
                       and time.perf_counter() < deadline):
                    time.sleep(0.002)
            stop.set()
            for t in threads:
                t.join(timeout=10)
            # the served map answers the final QE, through the clients'
            # gateway
            qe = np.asarray(gw.quantization_errors(name, eval_data))
            stats = dataclasses.replace(gw.stats)
    finally:
        stop.set()
        if gw is not None:
            gw.close()
        if handler_installed:
            signal.signal(signal.SIGTERM, prev_handler or signal.SIG_DFL)
    return StreamReport(events=consumed, seconds=seconds,
                        swaps=cursor["swaps"],
                        client_requests=sum(requests), client_errors=errors,
                        qe=qe, gateway=stats, interrupted=interrupted,
                        checkpoint_path=checkpoint_path,
                        resumed_from=resumed_from, state=tm.state_)


def build_backend_options(args) -> dict:
    """The backend options of the CLI's flags, with JAX's ``stream_train``'s
    refusals and messages; ``--shards K`` is the mesh placement over K
    ranks (``main`` joins them)."""
    faults = None
    if args.p_loss or (args.dropout_frac and args.dropout_len):
        faults = {"seed": args.fault_seed, "p_loss": args.p_loss,
                  "dropout_frac": args.dropout_frac,
                  "dropout_start": args.dropout_start,
                  "dropout_len": args.dropout_len}
    opts: dict = {}
    if args.backend == "async":
        opts.update(latency=args.latency, delay=args.delay,
                    engine=args.engine, lat_seed=args.lat_seed)
        if args.shards > 1:
            opts.update(placement="mesh", shards=args.shards)
        if faults:
            opts["faults"] = faults
    elif (args.latency != "zero" or args.delay or args.engine != "auto"
          or args.lat_seed or args.shards > 1 or faults):
        raise SystemExit("--latency/--delay/--engine/--lat-seed/--shards/"
                         "--p-loss/--dropout-* only apply to the async "
                         "backend")
    if args.search:
        if args.backend == "sharded":
            raise SystemExit("--search is not supported by the sharded "
                             "backend")
        opts["search"] = args.search
    return opts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="satimage", choices=sorted(DATASETS))
    add_backend_argument(ap, default="async")
    ap.add_argument("--side", type=int, default=6)
    ap.add_argument("--events", type=int, default=1024,
                    help="total training samples to stream")
    ap.add_argument("--chunk", type=int, default=64,
                    help="samples per partial_fit step")
    ap.add_argument("--swap-every", type=int, default=256,
                    help="publish the map into serving every N samples")
    ap.add_argument("--clients", type=int, default=2,
                    help="concurrent gateway reader threads")
    ap.add_argument("--client-batch", type=int, default=8)
    ap.add_argument("--store", default=None,
                    help="MapStore root: publish as artifact versions + "
                         "gateway reload (default: in-memory atomic swap)")
    ap.add_argument("--name", default=None,
                    help="served map name (default: DATASET-SIDExSIDE)")
    ap.add_argument("--latency", default="zero",
                    choices=("zero", "constant", "exponential"),
                    help="async backend: message latency model")
    ap.add_argument("--delay", type=float, default=0.0,
                    help="async backend: latency scale (sample periods)")
    ap.add_argument("--lat-seed", type=int, default=0,
                    help="async backend: seed of the exponential-latency "
                         "stream (independent of --seed)")
    ap.add_argument("--engine", default="auto", choices=("auto", "event"),
                    help="async backend: 'auto' sends zero-latency chunks "
                         "to the fast path, 'event' always runs the "
                         "discrete-event simulation")
    ap.add_argument("--shards", type=int, default=1,
                    help="async backend: partition the event engine over "
                         "this many ranks, one process each under torchrun "
                         "(placement='mesh'; must divide --side)")
    ap.add_argument("--dist-backend", default="gloo", choices=DIST_BACKENDS,
                    help="transport of a run of several ranks: gloo (any "
                         "number of ranks on one card or the CPU) or nccl "
                         "(one card a rank)")
    ap.add_argument("--search", default=None,
                    choices=(None, "heuristic", "exact"))
    ap.add_argument("--checkpoint-dir", default=None,
                    help="write crash-resume TrainCheckpoints here (every "
                         "--checkpoint-every samples and on SIGTERM)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="samples between checkpoints (default: "
                         "--swap-every)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint-dir (verifies checksums; "
                         "bitwise the uninterrupted run)")
    ap.add_argument("--die-after", type=int, default=None,
                    help="raise SIGTERM after consuming N samples "
                         "(a deterministic kill for resume tests)")
    ap.add_argument("--p-loss", type=float, default=0.0,
                    help="async backend: fault injection, broadcast loss "
                         "probability per message")
    ap.add_argument("--dropout-frac", type=float, default=0.0,
                    help="async backend: fault injection, fraction of "
                         "units dead during the dropout window")
    ap.add_argument("--dropout-start", type=float, default=0.0)
    ap.add_argument("--dropout-len", type=float, default=0.0)
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the fault plan's own draws")
    ap.add_argument("--e-factor", type=float, default=0.5)
    ap.add_argument("--train-size", type=int, default=2000)
    ap.add_argument("--eval-size", type=int, default=256)
    ap.add_argument("--coalesce-ms", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where to train and serve (default: cuda)")
    args = ap.parse_args(argv)
    opts = build_backend_options(args)
    world = ranks_needed(args)
    rank, device = join_ranks(args, world, "repro_torch.launch.stream_train")
    say = print if rank == 0 else (lambda *a, **k: None)

    spec = DATASETS[args.dataset]
    xtr, _, xte, _ = make_dataset(args.dataset,
                                  train_size=min(spec.train, args.train_size),
                                  test_size=min(spec.test, args.eval_size),
                                  device=device)
    cfg = AFMConfig(side=args.side, dim=spec.features,
                    e_factor=args.e_factor, i_max=args.events)
    name = args.name or f"{args.dataset}-{args.side}x{args.side}"
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    ranks = (f", {world} ranks over {compat.transport()} (rank 0 serves)"
             if dist.is_initialized() else "")
    say(f"streaming {args.events} events into a {args.side}x{args.side} "
        f"map (backend={args.backend}, latency={args.latency}), serving "
        f"{args.clients} clients, publish every {args.swap_every}, "
        f"device={device} ({card}){ranks}")
    rep = run_stream(cfg, xtr, xte, backend=args.backend,
                     backend_options=opts, events=args.events,
                     chunk=args.chunk, swap_every=args.swap_every,
                     clients=args.clients, client_batch=args.client_batch,
                     store_root=args.store, name=name,
                     max_delay=args.coalesce_ms / 1000.0, seed=args.seed,
                     checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=args.checkpoint_every,
                     resume=args.resume, die_after=args.die_after,
                     log=say, device=device)
    if rank:
        return rep
    if rep.interrupted:
        print(f"stream interrupted at {rep.events} events — checkpoint "
              f"saved to {rep.checkpoint_path}; rerun with --resume to "
              f"continue")
    print(f"stream: trained {rep.events} events in {rep.seconds:.2f}s "
          f"({rep.events_per_sec:.0f} events/s), {rep.swaps} swaps, "
          f"{rep.client_requests} client reads "
          f"({rep.gateway.dispatches} coalesced dispatches)")
    print(f"stream qe: mean={float(rep.qe.mean()):.4f} over {len(rep.qe)} "
          f"samples, finite={rep.qe_finite}")
    if rep.client_errors:
        raise SystemExit(f"client errors: {rep.client_errors!r}")
    return rep


if __name__ == "__main__":
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
