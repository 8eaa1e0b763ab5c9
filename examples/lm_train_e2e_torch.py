"""End-to-end example on the PyTorch port: train a ~100M-parameter dense LM
for a few hundred steps on the synthetic Markov corpus, then checkpoint
its weights. The same scenario as ``examples/lm_train_e2e.py``.

Default geometry: 12L x d768 x 12H (GQA 12/4), d_ff 3072, vocab 8192,
~106M parameters, f32. --tiny runs the same example at toy scale.

    PYTHONPATH=src python examples/lm_train_e2e_torch.py --steps 300
    PYTHONPATH=src python examples/lm_train_e2e_torch.py --tiny --steps 60 --device cpu

The checkpoint is the JAX package's format: ``repro.training.checkpoint.
restore`` reads it into an ``init_params`` tree of the same config.
"""
import argparse
import time

import torch

from repro_torch import convert
from repro_torch.data import tokens as tokens_lib
from repro_torch.models.common import ModelConfig
from repro_torch.training import AdamWConfig, init_train_state, make_train_step
from repro_torch.training import checkpoint as ckpt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--checkpoint", default="results/lm_e2e_torch.msgpack")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions)")
    args = ap.parse_args(argv)

    if args.tiny:
        cfg = ModelConfig(name="lm-tiny", num_layers=2, d_model=128,
                          num_heads=4, num_kv_heads=2, d_ff=512,
                          vocab_size=1024, dtype=torch.float32,
                          param_dtype=torch.float32)
        args.seq = min(args.seq, 128)
    else:
        cfg = ModelConfig(name="lm-100m", num_layers=12, d_model=768,
                          num_heads=12, num_kv_heads=4, d_ff=3072,
                          vocab_size=8192, dtype=torch.float32,
                          param_dtype=torch.float32)
    opt = AdamWConfig(lr=3e-4, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 5))
    state = init_train_state(cfg, seed=0, device=args.device)
    n = sum(p.numel() for p in state.params.parameters())
    print(f"{cfg.name}: {n / 1e6:.1f}M params, {args.steps} steps, "
          f"batch {args.batch} x seq {args.seq}, device={args.device}")
    step = make_train_step(cfg, opt)

    t0 = time.time()
    losses = []
    for i, batch in enumerate(tokens_lib.batches(
            torch.Generator().manual_seed(0), cfg.vocab_size, args.batch,
            args.seq, args.steps, device=args.device)):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i % 20 == 0 or i == args.steps - 1:
            tput = args.batch * args.seq * (i + 1) / (time.time() - t0)
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"({tput:.0f} tok/s)", flush=True)
    k = min(10, len(losses))
    print(f"loss: {sum(losses[:k]) / k:.4f} -> {sum(losses[-k:]) / k:.4f}")
    ckpt.save(args.checkpoint, convert.lm_params_tree(state.params))
    print(f"checkpoint -> {args.checkpoint}")


if __name__ == "__main__":
    main()
