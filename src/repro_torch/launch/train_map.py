"""Topographic-map training launcher, the ``TopoMap`` estimator as a CLI;
port of ``repro.launch.train_map``.

Trains an AFM on any Table-1 dataset through any registered backend and
reports map quality + classification metrics, on CUDA unless ``--device
cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.train_map --dataset mnist \\
        --side 30 --backend kernel

    # the plain PyTorch versions on the CPU, at a small size:
    PYTHONPATH=src python -m repro_torch.launch.train_map --device cpu \\
        --dataset satimage --side 8 --train-size 800 --test-size 200

    # event-driven asynchronous training:
    PYTHONPATH=src python -m repro_torch.launch.train_map --dataset satimage \\
        --backend async --latency constant --delay 1.0

    # persist the fitted map for repro_torch.launch.serve_map:
    PYTHONPATH=src python -m repro_torch.launch.train_map --dataset satimage \\
        --save-artifact /tmp/satimage-map           # one artifact dir
    PYTHONPATH=src python -m repro_torch.launch.train_map --dataset satimage \\
        --store /tmp/maps                           # versioned MapStore entry

    # mesh training, one process a rank (rows over 'model', samples over
    # 'data'); gloo puts every rank on one card (or, with --device cpu, on
    # the CPU), nccl one rank on each card:
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train_map \\
        --dataset satimage --backend sharded --mesh 2x2 --dist-backend gloo
    # the event engine partitioned into row bands over 2 ranks:
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train_map \\
        --dataset satimage --backend async --shards 2 --dist-backend gloo

Under ``torchrun`` each rank joins the process group from its environment;
ranks that a caller has already joined (``repro_torch.sharding.spawn_ranks``)
train in their group, whose transport must be the one ``--dist-backend``
names. Every rank trains; rank 0 prints and saves.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.api import AFMConfig, TopoMap, precision_recall
from repro_torch.api.backends import add_backend_argument
from repro_torch.data import DATASETS, make_dataset
from repro_torch.draws import GeneratorDraws
from repro_torch.launch._ranks import join_ranks, ranks_needed
from repro_torch.sharding import DIST_BACKENDS, compat


def _mesh_shape(args) -> tuple[int, int]:
    try:
        n_data, n_model = (int(x) for x in args.mesh.split("x"))
    except ValueError:
        raise SystemExit(
            f"--mesh must be 'DATAxMODEL' (e.g. 2x4), got {args.mesh!r}")
    return n_data, n_model


def build_backend_options(args) -> dict:
    """The backend options of the CLI's flags (JAX's ``train_map``); the
    sharded backend's mesh comes from ``join_ranks``."""
    opts: dict = {}
    if args.backend == "sharded":
        if args.search:
            raise SystemExit("--search is not supported by the sharded "
                             "backend (it uses mesh probe-and-reduce search)")
        _mesh_shape(args)
    elif args.mesh != "1x1":
        raise SystemExit("--mesh only applies to the sharded backend "
                         "(async uses --shards)")
    if args.backend == "async":
        opts.update(latency=args.latency, delay=args.delay,
                    lat_seed=args.lat_seed)
        if args.shards > 1:
            opts.update(placement="mesh", shards=args.shards)
    elif args.latency != "zero" or args.delay or args.lat_seed:
        raise SystemExit("--latency/--delay/--lat-seed only apply to the "
                         "async backend")
    elif args.shards > 1:
        raise SystemExit("--shards only applies to the async backend "
                         "(sharded uses --mesh)")
    if args.search:
        opts["search"] = args.search
    return opts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="satimage", choices=sorted(DATASETS))
    add_backend_argument(ap, default="batched")
    ap.add_argument("--side", type=int, default=10)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--e-factor", type=float, default=1.0)
    ap.add_argument("--i-max", type=int, default=0,
                    help="total samples (0 -> 40N reduced budget; paper: 600N)")
    ap.add_argument("--c-d", type=float, default=100.0)
    ap.add_argument("--train-size", type=int, default=3000)
    ap.add_argument("--test-size", type=int, default=600)
    ap.add_argument("--mesh", default="1x1",
                    help="sharded backend mesh, 'DATAxMODEL' (e.g. 2x2): "
                         "DATA x MODEL ranks")
    ap.add_argument("--latency", default="zero",
                    choices=("zero", "constant", "exponential"),
                    help="async backend: message latency model")
    ap.add_argument("--delay", type=float, default=0.0,
                    help="async backend: latency scale in sample periods")
    ap.add_argument("--lat-seed", type=int, default=0,
                    help="async backend: seed of the exponential-latency "
                         "stream (independent of --seed)")
    ap.add_argument("--shards", type=int, default=1,
                    help="async backend: partition the event engine over "
                         "this many ranks (placement='mesh'; must divide "
                         "--side)")
    ap.add_argument("--dist-backend", default="gloo", choices=DIST_BACKENDS,
                    help="transport of a run of several ranks: gloo (any "
                         "number of ranks on one card or the CPU) or nccl "
                         "(one card a rank)")
    ap.add_argument("--search", default=None,
                    choices=(None, "heuristic", "exact"),
                    help="override the backend's search stage")
    ap.add_argument("--labeling", default="nearest",
                    choices=("nearest", "majority"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where to train and evaluate (default: cuda)")
    ap.add_argument("--save-artifact", default=None,
                    help="write the fitted map to this artifact directory")
    ap.add_argument("--store", default=None,
                    help="register the fitted map in this MapStore root")
    ap.add_argument("--name", default=None,
                    help="store key name (default: DATASET-SIDExSIDE)")
    args = ap.parse_args(argv)
    opts = build_backend_options(args)
    world = ranks_needed(args, _mesh_shape(args))
    rank, device = join_ranks(args, world, "repro_torch.launch.train_map")
    if args.backend == "sharded":
        opts["mesh"] = compat.ShardMesh(_mesh_shape(args), ("data", "model"))
    say = print if rank == 0 else (lambda *a, **k: None)

    spec = DATASETS[args.dataset]
    xtr, ytr, xte, yte = make_dataset(
        args.dataset, train_size=min(spec.train, args.train_size),
        test_size=min(spec.test, args.test_size), device=device)

    n = args.side * args.side
    cfg = AFMConfig(side=args.side, dim=spec.features, batch=args.batch,
                    e_factor=args.e_factor, c_d=args.c_d,
                    i_max=args.i_max or 40 * n)
    tm = TopoMap(cfg, backend=args.backend, backend_options=opts,
                 seed=args.seed, labeling=args.labeling, device=device)
    # the backend may rewrite the config (reference forces batch=1)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    ranks = (f" ranks={world} over {compat.transport()}"
             if dist.is_initialized() else "")
    say(f"dataset={args.dataset} map={args.side}x{args.side} "
        f"backend={tm.backend.name} steps={tm.backend.cfg.num_steps} "
        f"device={device} ({name}){ranks}")

    t0 = time.time()
    tm.fit(xtr, ytr)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    rate = cfg.total_samples / dt
    say(f"trained {cfg.total_samples} samples in {dt:.1f}s "
        f"({rate:.0f} samples/s); largest cascade "
        f"a_i = {int(tm.fit_aux_.cascade_size.max())}")
    if rank:
        return tm

    print(f"quantization error  Q: {tm.quantization_error(xte):.4f}")
    print(f"topological error   T: {tm.topographic_error(xte):.4f}")
    # an evaluation stream apart from (not equal to) the training seed's
    eval_draws = GeneratorDraws(args.seed + 1, device)
    print(f"search error        F: "
          f"{tm.search_error(xte[:256], draws=eval_draws):.4f}")
    pred = tm.predict(xte)
    acc = float((pred == yte).float().mean())
    prec, rec = precision_recall(pred, yte, spec.classes)
    print(f"classification: acc={acc:.3f} precision={float(prec):.3f} "
          f"recall={float(rec):.3f} (chance={1.0 / spec.classes:.3f})")

    meta = {"dataset": args.dataset, "accuracy": acc}
    if args.save_artifact:
        tm.save(args.save_artifact, extra_meta=meta)
        print(f"saved artifact -> {args.save_artifact}")
    if args.store:
        from repro_torch.api import MapStore
        key = args.name or f"{args.dataset}-{args.side}x{args.side}"
        spec_key = MapStore(args.store).save(tm, key, extra_meta=meta)
        print(f"saved to store {args.store} as {spec_key}")
    return tm


if __name__ == "__main__":
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
