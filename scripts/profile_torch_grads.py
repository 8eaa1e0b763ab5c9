#!/usr/bin/env python3
"""Where an LM's gradient norm comes from at init, on one NVIDIA card.

    PYTHONPATH=src python3 scripts/profile_torch_grads.py \
        [--arch mamba2-1.3b] [--batch 2] [--seq 1024] [--lr 1e-3] [--steps 20]

Builds ``--arch`` at full width (``configs.get``, seeded weights) twice,
in its bf16 layout and in f32, and on one batch of the synthetic corpus
prints the loss, the global gradient norm, the largest norms by leaf
(the layers' leaves of one name taken together) and the norm of every
sixth layer. Then ``launch/train.py``'s ``run`` of ``--steps`` steps at
``--lr`` (B 4, ``--seq``, no probe): the means of its first and last five
losses.
"""
import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", default="mamba2-1.3b")
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--seq", type=int, default=1024)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--steps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_grads.py needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.data import tokens
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.training import train_step
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    device = torch.device("cuda")
    base = configs.get(args.arch)
    batch = next(tokens.batches(torch.Generator().manual_seed(1),
                                base.vocab_size, args.batch, args.seq, 1,
                                device=device))
    f32 = dataclasses.replace(base, dtype=torch.float32,
                              param_dtype=torch.float32)
    for label, cfg in (("bf16", base), ("f32", f32)):
        model = transformer.init_params(cfg, seed=0, device=device)
        model.requires_grad_(True)
        loss = train_step.lm_loss(model, batch, cfg)[0]
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
        squares = [float(g.float().pow(2).sum()) for g in grads]
        by_leaf, by_layer = {}, {}
        for name, sq in zip(names, squares):
            where = transformer.layer_of(name)
            key = name if where is None else (
                f"{where[0]}.*." + ".".join(where[2]))
            by_leaf[key] = by_leaf.get(key, 0.0) + sq
            if where is not None:
                by_layer[where[:2]] = by_layer.get(where[:2], 0.0) + sq
        print(f"{cfg.name} {label}, B {args.batch} x S {args.seq}: loss "
              f"{float(loss.detach()):.4f}, gradient norm "
              f"{sum(squares) ** 0.5:.3f}")
        for key, sq in sorted(by_leaf.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {key:28s} {sq ** 0.5:12.3f}")
        layers = sorted(by_layer.items())[::6]
        print("  by layer: " + ", ".join(f"{stack}.{i} {sq ** 0.5:.1f}"
                                         for (stack, i), sq in layers))
        del model, grads
        torch.cuda.empty_cache()
    losses = train.run(base, steps=args.steps, batch=4, seq=args.seq,
                       lr=args.lr, seed=0, device=device,
                       log_every=max(args.steps // 4, 1))
    print(f"{base.name} at lr {args.lr}: mean of the first 5 losses "
          f"{sum(losses[:5]) / 5:.4f}, of the last 5 "
          f"{sum(losses[-5:]) / 5:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
