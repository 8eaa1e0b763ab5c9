"""Trained-map serving launcher, ``MapService`` / ``MapGateway`` /
``MapFleet`` as a CLI; port of ``repro.launch.serve_map`` (mirrors
``train_map``).

Loads a saved map from an artifact directory or a ``MapStore`` and runs
request batches through a serving endpoint on CUDA (``--device cpu`` for the
plain PyTorch versions), reporting throughput. Every dispatch is one
launch of the ``bmu`` kernel:

    # train + save, then serve a .npy batch through the transform endpoint
    PYTHONPATH=src python -m repro_torch.launch.train_map --dataset satimage \
        --side 10 --save-artifact /tmp/satimage-map
    PYTHONPATH=src python -m repro_torch.launch.serve_map \
        --artifact /tmp/satimage-map --requests queries.npy

    # store-resolved map, newline-delimited JSON requests from stdin
    PYTHONPATH=src python -m repro_torch.launch.serve_map --store /tmp/maps \
        --map satimage-10x10@2 --requests - --endpoint predict

    # 8 threaded clients streaming batch-1 requests through the coalescing
    # gateway (merged into bucket-sized dispatches under a 2 ms deadline)
    PYTHONPATH=src python -m repro_torch.launch.serve_map --artifact /tmp/m \
        --random 4096 --batch 1 --concurrency 8 --gateway

    # a 4-replica fleet with admission control, rolled to a new store
    # version mid-run (zero downtime), p50/p95/p99 in the summary
    PYTHONPATH=src python -m repro_torch.launch.serve_map --store /tmp/maps \
        --map satimage-10x10 --random 4096 --batch 8 --concurrency 8 \
        --replicas 4 --shed-deadline-ms 500 --reload-during-run

Request formats: ``.npy`` (B, D) arrays, or newline-delimited JSON — each
line one sample, either a bare array ``[0.1, ...]`` or ``{"x": [...]}``.
``--random N`` generates N Gaussian queries (numpy, from ``--seed``) for
smoke runs.

Throughput is reported on two clocks: **wall** (first request start to
last request end — honest under ``--concurrency``) and **busy** (summed
per-request engine spans, which overlap under concurrent load), plus
p50/p95/p99 request-latency percentiles from the streaming histograms.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import threading
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serving.fleet import MapFleet
from repro_torch.serving.gateway import MapGateway
from repro_torch.serving.maps import DEFAULT_BUCKETS, MapService, to_numpy

ENDPOINTS = ("transform", "predict", "quantization-error", "u-matrix")


def load_requests(path: str, dim: int) -> np.ndarray:
    """(B, D) float32 requests from .npy or newline-delimited JSON."""
    if path.endswith(".npy"):
        x = np.load(path)
    else:
        f = sys.stdin if path == "-" else open(path)
        try:
            rows = []
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                if isinstance(obj, dict):
                    obj = obj["x"]
                rows.append(obj)
        finally:
            if f is not sys.stdin:
                f.close()
        x = np.asarray(rows)
    x = np.atleast_2d(np.asarray(x, np.float32))
    if x.ndim != 2 or x.shape[1] != dim:
        raise SystemExit(f"requests have shape {x.shape}, want (B, {dim})")
    return x


def build_service(args):
    """The serving stack behind the CLI: a single ``MapService``, or a
    ``MapFleet`` of ``--replicas`` workers with admission control."""
    buckets = (tuple(int(b) for b in args.buckets.split(","))
               if args.buckets else DEFAULT_BUCKETS)
    opts = dict(buckets=buckets, update_backend=args.update_backend,
                device=args.device)
    if args.replicas:
        opts.update(replicas=args.replicas,
                    shed_deadline=(args.shed_deadline_ms or 500.0) / 1000.0)
        if args.max_outstanding:
            opts["max_outstanding"] = args.max_outstanding
        if args.artifact:
            return MapFleet.from_artifact(args.artifact, **opts)
        return MapFleet.from_store(args.store, args.map, **opts)
    if args.artifact:
        return MapService.from_artifact(args.artifact, **opts)
    return MapService.from_store(args.store, args.map, **opts)


def _rolling_reloader(args, fleet, n_blocks):
    """Background thread for ``--reload-during-run``: once the run is in
    flight, publish the fleet's current map as a new store version and
    roll every replica to it. Returns (thread, info dict)."""
    from repro_torch.api import persistence
    info = {}

    def roll():
        deadline = time.time() + 30.0
        while (fleet.stats.completed < max(1, n_blocks // 4)
               and time.time() < deadline):
            time.sleep(0.002)
        svc = fleet.services()[0]
        state, labels = svc.snapshot()
        map_name = persistence.parse_spec(args.map)[0]
        persistence.MapStore(args.store).save_state(
            map_name, cfg=fleet.cfg, state=state, unit_labels=labels,
            labeling=svc.labeling,
            extra_meta={"published_by": "serve_map --reload-during-run"})
        info["version"] = fleet.reload()

    thread = threading.Thread(target=roll, name="serve-map-reloader")
    thread.start()
    return thread, info


def _serve_blocks(args, svc, blocks):
    """Run request ``blocks`` through the chosen endpoint, optionally from
    ``--concurrency`` threads (and through the coalescing gateway). Returns
    per-block outputs in request order, plus the gateway (for stats)."""
    outs = [None] * len(blocks)
    method = {"transform": "transform", "predict": "predict",
              "quantization-error": "quantization_errors"}[args.endpoint]
    gw = None
    if args.gateway:
        # share the service's ladder so coalesce_max tracks its top bucket
        gw = MapGateway(max_delay=args.coalesce_ms / 1000.0,
                        buckets=svc.engine.buckets, device=svc.device)
        gw.attach("map", svc)
        call = functools.partial(getattr(gw, method), "map")
    else:
        call = getattr(svc, method)
    kwargs = {"lattice": args.lattice} if args.endpoint == "transform" else {}
    if getattr(args, "max_retries", 0):
        # Overloaded sheds become transient: each client retries with
        # bounded backoff honoring the fleet's retry_after hint, so a
        # burst past admission capacity drains instead of failing the run
        from repro_torch.serving.retry import call_with_retries
        call = functools.partial(call_with_retries, call,
                                 max_retries=args.max_retries)

    def one(i, block):
        outs[i] = to_numpy(call(block, **kwargs))

    workers = max(1, args.concurrency)
    errors = []
    try:
        if workers == 1:
            for i, block in enumerate(blocks):
                one(i, block)
        else:
            # round-robin the block stream over worker threads (each worker
            # is one serving client; the gateway merges their concurrent
            # requests)
            def client(worker):
                try:
                    for i in range(worker, len(blocks), workers):
                        one(i, blocks[i])
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(w,))
                       for w in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
    finally:
        if gw is not None:
            gw.close()
    return outs, gw


def main(argv=None):
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--artifact", default=None,
                     help="artifact directory (TopoMap.save output)")
    src.add_argument("--store", default=None, help="MapStore root directory")
    ap.add_argument("--map", default=None,
                    help="store key, 'name[@version]' (latest when omitted)")
    ap.add_argument("--requests", default=None,
                    help=".npy / newline-delimited JSON file, or '-' (stdin)")
    ap.add_argument("--random", type=int, default=0,
                    help="serve N random Gaussian queries instead of a file")
    ap.add_argument("--endpoint", default="transform", choices=ENDPOINTS)
    ap.add_argument("--batch", type=int, default=1024,
                    help="request batch size fed to the service per call")
    ap.add_argument("--concurrency", type=int, default=1,
                    help="number of threaded clients issuing requests")
    ap.add_argument("--gateway", action="store_true",
                    help="route requests through the coalescing MapGateway "
                         "(merges concurrent small requests per bucket)")
    ap.add_argument("--coalesce-ms", type=float, default=1.0,
                    help="gateway coalescing deadline in milliseconds")
    ap.add_argument("--replicas", type=int, default=0,
                    help="serve through a MapFleet of N replica workers "
                         "(least-outstanding routing, admission control, "
                         "rolling reload)")
    ap.add_argument("--max-retries", type=int, default=0,
                    help="retry Overloaded sheds per request this many "
                         "times with bounded exponential backoff honoring "
                         "the fleet's retry_after hint (default 0: a shed "
                         "fails the run)")
    ap.add_argument("--shed-deadline-ms", type=float, default=None,
                    help="fleet admission: max milliseconds a caller may "
                         "wait for a slot before an Overloaded shed "
                         "(default 500; needs --replicas)")
    ap.add_argument("--max-outstanding", type=int, default=0,
                    help="fleet admission queue bound (default 8/replica; "
                         "needs --replicas)")
    ap.add_argument("--reload-during-run", action="store_true",
                    help="mid-run, publish the map as a new store version "
                         "and roll every replica to it (needs --replicas "
                         "and --store)")
    ap.add_argument("--lattice", action="store_true",
                    help="transform endpoint: return (row, col) coordinates")
    ap.add_argument("--buckets", default=None,
                    help="comma-separated buckets; the top one caps a "
                         "dispatch (e.g. 64,512)")
    ap.add_argument("--update-backend", default="batched",
                    help="backend for online updates (unused by read paths)")
    ap.add_argument("--output", default=None,
                    help="write endpoint outputs to this .npy file "
                         "(quantization-error: (B,) per-sample Euclidean "
                         "BMU distances, one row per request sample)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where to serve (default: cuda)")
    args = ap.parse_args(argv)
    if args.store and not args.map:
        raise SystemExit("--store needs --map 'name[@version]'")
    if args.artifact and args.map:
        raise SystemExit("--map selects from a --store; it does nothing "
                         "with --artifact (remove one of them)")
    if args.concurrency < 1:
        raise SystemExit("--concurrency must be >= 1")
    if args.replicas < 0:
        raise SystemExit("--replicas must be >= 1 (or omitted)")
    if args.replicas and args.gateway:
        raise SystemExit("--gateway coalesces in front of one service; "
                         "--replicas routes a fleet directly — pick one "
                         "(gateway-fronted fleets are a library-level "
                         "composition, see repro_torch.serving.fleet)")
    if args.shed_deadline_ms is not None and not args.replicas:
        raise SystemExit("--shed-deadline-ms tunes fleet admission; it "
                         "does nothing without --replicas N")
    if args.max_outstanding and not args.replicas:
        raise SystemExit("--max-outstanding bounds the fleet admission "
                         "queue; it does nothing without --replicas N")
    if args.reload_during_run and not args.replicas:
        raise SystemExit("--reload-during-run rolls a fleet; it needs "
                         "--replicas N")
    if args.reload_during_run and not args.store:
        raise SystemExit("--reload-during-run publishes a new store "
                         "version; it needs --store/--map (not --artifact)")

    args.device = resolve_device(args.device)
    svc = build_service(args)
    fleet = svc if isinstance(svc, MapFleet) else None
    first = fleet.services()[0] if fleet is not None else svc
    cfg = svc.cfg
    extra = f" replicas={fleet.replicas}" if fleet is not None else ""
    card = (torch.cuda.get_device_name(args.device)
            if args.device.type == "cuda" else "cpu")
    print(f"serving map {cfg.side}x{cfg.side} dim={cfg.dim} "
          f"labeling={first.labeling} buckets={first.engine.buckets} "
          f"device={args.device} ({card}){extra}")

    if args.endpoint == "u-matrix":
        out = to_numpy(svc.u_matrix())
        print(f"u-matrix mean={out.mean():.4f} max={out.max():.4f}")
    else:
        if args.requests:
            reqs = load_requests(args.requests, cfg.dim)
        elif args.random:
            reqs = np.random.default_rng(args.seed).standard_normal(
                (args.random, cfg.dim)).astype(np.float32)
        else:
            raise SystemExit("give --requests FILE or --random N")
        blocks = [reqs[lo:lo + args.batch]
                  for lo in range(0, reqs.shape[0], args.batch)]
        reloader, reload_info = None, {}
        if args.reload_during_run:
            reloader, reload_info = _rolling_reloader(args, fleet,
                                                      len(blocks))
        t0 = time.time()
        outs, gw = _serve_blocks(args, svc, blocks)
        wall = time.time() - t0
        if reloader is not None:
            reloader.join(60)
        out = np.concatenate(outs, axis=0)
        if args.endpoint == "quantization-error":
            print(f"quantization error: mean={out.mean():.4f} over "
                  f"{out.shape[0]} samples")
        if fleet is not None:
            reps = fleet.services()
            samples = sum(r.stats.samples for r in reps)
            signatures = sum(r.engine.trace_count for r in reps)
            f = fleet.stats
            print(f"served {samples} samples in {wall:.3f}s wall "
                  f"({samples / wall:.0f} samples/s), "
                  f"{f.completed} completed, {f.sheds} shed, "
                  f"{args.concurrency} clients, {signatures} bucket signatures")
            print(f"fleet latency ms: {f.latency.summary()}; "
                  f"engine {fleet.merged_engine_latency().summary()}")
            for i, rep in enumerate(reps):
                print(f"  replica {i}: {rep.stats.requests} requests, "
                      f"latency ms {rep.stats.latency.summary()}")
            if reload_info.get("version") is not None:
                print(f"rolled to version {reload_info['version']} "
                      f"mid-run (reloads={f.reloads})")
        else:
            s = svc.stats
            # under the gateway, service-level "requests" are merged engine
            # dispatches — report the client-side request count instead
            n_requests = gw.stats.requests if gw is not None else s.requests
            print(f"served {s.samples} samples in {wall:.3f}s wall "
                  f"({s.throughput():.0f} samples/s wall-window, "
                  f"{s.busy_throughput():.0f} samples/s busy; "
                  f"busy {s.busy_seconds:.3f}s), {n_requests} requests, "
                  f"{args.concurrency} clients, {svc.compiles} bucket "
                  f"signatures")
            print(f"latency ms: {s.latency.summary()}")
            if gw is not None:
                g = gw.stats
                print(f"gateway: {g.dispatches} coalesced dispatches "
                      f"(mean {g.mean_coalesced_requests():.1f} requests / "
                      f"{g.mean_dispatch_size():.1f} samples per dispatch, "
                      f"max {g.max_dispatch}), {g.direct} direct")

    print(f"output shape: {tuple(out.shape)}")
    if args.output:
        np.save(args.output, out)
        print(f"wrote {args.output}")
    return out


if __name__ == "__main__":
    main()
