"""Quickstart on the PyTorch port: train an asynchronously-trained feature
map (AFM) on a Table-1-shaped dataset, evaluate map quality, and classify,
all through the port's ``TopoMap`` estimator (``repro_torch.api``). The
same scenario as ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py                # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # plain versions

The map trains on the ``kernel`` backend with the paper's relay-race
search: on the card the staged step's cascade is the ``drive_cascade``
kernel and every query a ``bmu`` launch; on the CPU both run their plain
PyTorch versions.
"""
import argparse
import time

import torch

from repro_torch.api import AFMConfig, TopoMap, precision_recall
from repro_torch.data import make_dataset


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions)")
    ap.add_argument("--side", type=int, default=10)
    ap.add_argument("--train-size", type=int, default=3000)
    ap.add_argument("--test-size", type=int, default=600)
    ap.add_argument("--budget", type=int, default=40,
                    help="training samples per unit (the paper uses 600)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    # satimage-shaped synthetic data: 6 classes, 36 features (paper Table 1)
    xtr, ytr, xte, yte = make_dataset("satimage", train_size=args.train_size,
                                      test_size=args.test_size, device=device)
    n = args.side * args.side
    # paper §3 default configuration, budget-reduced
    cfg = AFMConfig(
        side=args.side,
        dim=36,
        phi=20,            # far links per unit
        l_s=0.05, c_o=0.5, c_s=0.5, c_m=0.1, c_d=100.0,
        e_factor=1.0,      # exploration iterations e = N
        i_max=args.budget * n,
        batch=16,          # bulk-asynchronous samples in flight
    )
    tm = TopoMap(cfg, backend="kernel",
                 backend_options={"search": "heuristic"}, device=device)
    print(f"map {cfg.side}x{cfg.side}, {cfg.e} exploration hops/sample, "
          f"{cfg.num_steps} steps, backend={tm.backend.name}, "
          f"device={device}")

    t0 = time.perf_counter()
    tm.fit(xtr, ytr)
    largest = int(tm.fit_aux_.cascade_size.max())
    print(f"trained in {time.perf_counter() - t0:.1f}s; largest cascade "
          f"a_i = {largest} units")

    print(f"quantization error  Q: {tm.quantization_error(xte):.4f}")
    print(f"topological error   T: {tm.topographic_error(xte):.4f}")
    f = tm.search_error(xte[:256])
    print(f"search error        F: {f:.4f}")

    pred = tm.predict(xte)
    acc = float((pred == yte).float().mean())
    prec, rec = precision_recall(pred, yte, 6)
    print(f"classification: acc={acc:.3f} precision={float(prec):.3f} "
          f"recall={float(rec):.3f} (chance = 0.167)")


if __name__ == "__main__":
    main()
