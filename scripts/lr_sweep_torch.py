"""The loss of short full-width training runs at several learning rates,
on the card.

    PYTHONPATH=src python3 scripts/lr_sweep_torch.py --arch qwen2-vl-72b \
        --layers 2 --lrs 3e-4,1e-4,3e-5 --text-only 3e-4,1e-4 --dense-control

Trains ``--arch`` at its published width, cut to ``--layers`` layers,
through ``launch/train.py``'s ``run`` (B 4 x S 1,024, an 8x8 probe, seed 0,
``--steps`` steps) at each of ``--lrs`` with the launcher's stub inputs (a
VLM's zero patch embeddings over half of every sequence), then at each of
``--text-only`` without them, and with ``--dense-control`` once more as a
dense config of the same geometry (plain RoPE) at the first of
``--text-only``. Prints each run's losses and the means of its first and
last five.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch import train
from repro_torch.models import transformer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-vl-72b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lrs", default="3e-4,1e-4,3e-5")
    ap.add_argument("--text-only", default="")
    ap.add_argument("--dense-control", action="store_true")
    args = ap.parse_args(argv)
    print(torch.cuda.get_device_name(0))
    base = dataclasses.replace(configs.get(args.arch),
                               num_layers=args.layers)
    stub = transformer.stub_inputs
    runs = [(base, float(lr), True) for lr in args.lrs.split(",") if lr]
    text = [float(lr) for lr in args.text_only.split(",") if lr]
    runs += [(base, lr, False) for lr in text]
    if args.dense_control and text:
        runs.append((dataclasses.replace(base, arch_type="dense",
                                         mrope_sections=()), text[0], False))
    for cfg, lr, with_stub in runs:
        transformer.stub_inputs = (stub if with_stub else
                                   lambda cfg, b, device=None, seq=None: {})
        torch.cuda.empty_cache()
        losses = train.run(cfg, steps=args.steps, batch=4, seq=1024, lr=lr,
                           probe=True, probe_side=8, seed=0, device="cuda",
                           log_every=args.steps)
        print(f"RESULT {cfg.arch_type} {cfg.num_layers} layers, lr {lr:g}, "
              f"{'stub inputs' if with_stub else 'text only'}: first five "
              f"{np.mean(losses[:5]):.4f}, last five "
              f"{np.mean(losses[-5:]):.4f}; losses "
              f"{' '.join(f'{x:.4f}' for x in losses)}", flush=True)
    transformer.stub_inputs = stub


if __name__ == "__main__":
    main()
