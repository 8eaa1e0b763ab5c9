"""Paper §3.4 scenario on the PyTorch port: AFM vs synchronous SOM on
multiple datasets (Table 2, reduced budgets), the counterpart of
``examples/classify_datasets.py``. Identical data feeds both algorithms;
the AFM side runs through the port's ``TopoMap`` estimator, the SOM
through ``repro_torch.core.som`` (its search the ``bmu`` kernel on the
card).

    PYTHONPATH=src python examples/classify_datasets_torch.py [--datasets a,b]
    PYTHONPATH=src python examples/classify_datasets_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.api import AFMConfig, TopoMap, precision_recall
from repro_torch.api.backends import add_backend_argument
from repro_torch.core import classifier, som
from repro_torch.data import DATASETS, make_dataset
from repro_torch.draws import GeneratorDraws


def evaluate_som(state, xtr, ytr, xte, yte, classes):
    labels = classifier.label_units(state.w, xtr, ytr)
    pred = som.predict(state, labels, xte)
    p, r = classifier.precision_recall(pred, yte, classes)
    return float(p), float(r)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--datasets", default="satimage,letters")
    ap.add_argument("--side", type=int, default=12)
    add_backend_argument(ap, default="kernel")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions)")
    ap.add_argument("--train-size", type=int, default=4000,
                    help="cap on each dataset's training samples")
    ap.add_argument("--test-size", type=int, default=800,
                    help="cap on each dataset's test samples")
    ap.add_argument("--budget", type=int, default=40,
                    help="training samples per unit (the paper uses 600)")
    args = ap.parse_args(argv)
    if args.backend == "sharded":
        # the AFM trains with the paper's relay race, which the sharded
        # backend's probe search does not take
        raise SystemExit("the sharded backend takes no search option")
    device = torch.device(args.device)
    i_max = args.budget * args.side ** 2

    print(f"{'dataset':12s} {'AFM prec':>9s} {'AFM rec':>9s} "
          f"{'SOM prec':>9s} {'SOM rec':>9s}")
    for name in args.datasets.split(","):
        spec = DATASETS[name]
        xtr, ytr, xte, yte = make_dataset(
            name, train_size=min(spec.train, args.train_size),
            test_size=min(spec.test, args.test_size), device=device)
        acfg = AFMConfig(side=args.side, dim=spec.features, i_max=i_max,
                         batch=16, e_factor=1.0, c_d=1000.0)
        tm = TopoMap(acfg, backend=args.backend,
                     backend_options={"search": "heuristic"},
                     device=device).fit(xtr, ytr)
        pred = tm.predict(xte)
        ap_, ar = (float(x) for x in precision_recall(pred, yte, spec.classes))

        scfg = som.SOMConfig(side=args.side, dim=spec.features, i_max=i_max,
                             batch=1, sigma_end=0.5)
        draws = GeneratorDraws(0, device)
        sstate = som.init(draws, scfg, xtr, device=device)
        sstate = som.train(sstate, xtr, draws, scfg, device=device)
        sp, sr = evaluate_som(sstate, xtr, ytr, xte, yte, spec.classes)
        print(f"{name:12s} {ap_:9.3f} {ar:9.3f} {sp:9.3f} {sr:9.3f}")


if __name__ == "__main__":
    main()
