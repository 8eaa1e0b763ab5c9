"""The AFM probe as an *activation atlas*, on the PyTorch port: the
paper's topographic map self-organising the hidden states of a
transformer while it trains. The same scenario as
``examples/activation_atlas.py``.

    PYTHONPATH=src python examples/activation_atlas_torch.py --arch smollm-360m
    PYTHONPATH=src python examples/activation_atlas_torch.py --device cpu

On the card each step's probe update searches on the ``bmu`` kernel and
cascades on the ``drive_cascade`` kernel; on the CPU both run their plain
versions.
"""
import argparse

import torch

from repro_torch import configs
from repro_torch.api import TopoMap
from repro_torch.core import probe
from repro_torch.data import tokens as tokens_lib
from repro_torch.draws import GeneratorDraws
from repro_torch.training import AdamWConfig, init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions)")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch)
    probe_cfg = probe.ProbeConfig(side=6, dim=cfg.d_model,
                                  i_max=args.steps * 8)
    opt = AdamWConfig(lr=1e-3, total_steps=args.steps)
    state = init_train_state(cfg, probe_cfg, seed=0, device=args.device)
    step = make_train_step(cfg, opt, probe_cfg)

    print(f"training {cfg.name} with a {probe_cfg.side}x{probe_cfg.side} "
          f"AFM probe on its hidden states, device={args.device}")
    for i, batch in enumerate(tokens_lib.batches(
            torch.Generator().manual_seed(0), cfg.vocab_size, 8, 64,
            args.steps, device=args.device)):
        state, m = step(state, batch,
                        GeneratorDraws.for_step(0, i, args.device))
        if i % 10 == 0:
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  f"probe_cascade={int(m['probe_cascade'])}")

    # the atlas: wrap the probe's trained map in the estimator surface and
    # render its U-matrix (per-unit mean distance to lattice neighbours)
    atlas = TopoMap.from_state(state.probe.afm, probe_cfg.afm_config(),
                               device=args.device)
    umat = atlas.u_matrix()
    print("\nactivation-atlas U-matrix (low = coherent region):")
    scale = float(umat.max()) or 1.0
    chars = " .:-=+*#%@"
    for row in umat.tolist():
        print("  " + "".join(chars[min(int(v / scale * 9.99), 9)] for v in row))


if __name__ == "__main__":
    main()
