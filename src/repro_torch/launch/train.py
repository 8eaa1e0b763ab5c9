"""Training launcher: end-to-end LM training of a dense architecture (full
or smoke config) on the card unless asked otherwise, with the optional AFM
probe and a checkpoint of the weights. The port of ``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --probe --probe-side 8 --batch 4 --seq 1024 --steps 30
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --smoke --probe --device cpu --steps 8

Weights come from the port's seeded init, tokens from the synthetic Markov
corpus (``data.tokens``) on a seeded CPU generator. With ``--probe`` every
step feeds the mean-pooled final hidden states to a ``probe-side`` squared
AFM whose search and cascade run on the ``bmu`` and ``drive_cascade``
kernels on CUDA (their plain versions on the CPU). The families the port
lacks (MoE, SSM, hybrid, audio, VLM) raise "not ported yet".
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs, convert
from repro_torch.core.probe import ProbeConfig
from repro_torch.data import tokens as tokens_lib
from repro_torch.device import resolve_device
from repro_torch.draws import GeneratorDraws
from repro_torch.models import transformer
from repro_torch.training import AdamWConfig, init_train_state, make_train_step
from repro_torch.training import checkpoint as ckpt_lib


def run(cfg, *, steps: int = 100, batch: int = 8, seq: int = 128,
        lr: float = 1e-3, probe: bool = False, probe_side: int = 8,
        checkpoint: str | None = None, log_every: int = 10, seed: int = 0,
        device: torch.device | str | None = "cuda", on_step=None
        ) -> list[float]:
    """Train ``cfg`` for ``steps`` steps of (batch, seq) tokens and print
    the JAX launcher's log lines. Returns the loss of every step.

    ``on_step(i, state, metrics, ms)``, when given, is called after each
    step with its time: on CUDA from events recorded around the step's
    launches (read after the loss, which waits for the step anyway), on the
    CPU from the host clock. The host makes the next batch while the card
    runs the step."""
    # the ssm family's ssm_chunk fix-up and the audio and vlm families'
    # extra inputs (frames; vision embeds and M-RoPE positions) come with
    # those families; the port trains the dense family
    transformer._layer_plan(cfg)
    device = resolve_device(device)
    cuda = device.type == "cuda"
    probe_cfg = (ProbeConfig(side=probe_side, dim=cfg.d_model,
                             i_max=steps * batch) if probe else None)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps,
                          warmup_steps=max(steps // 20, 5))
    state = init_train_state(cfg, probe_cfg, seed=seed, device=device)
    step_fn = make_train_step(cfg, opt_cfg, probe_cfg)

    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M device={device}")

    data = tokens_lib.batches(torch.Generator().manual_seed(seed + 1),
                              cfg.vocab_size, batch, seq, steps,
                              device=device)
    t0 = time.time()
    losses = []
    nxt = next(data, None)
    for i in range(steps):
        draws = (GeneratorDraws.for_step(seed, 1000 + i, device) if probe
                 else None)
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        else:
            t_step = time.perf_counter()
        state, metrics = step_fn(state, nxt, draws)
        if cuda:
            end.record()
        nxt = next(data, None)
        losses.append(float(metrics["loss"]))
        ms = (start.elapsed_time(end) if cuda
              else (time.perf_counter() - t_step) * 1e3)
        if on_step is not None:
            on_step(i, state, metrics, ms)
        if i % log_every == 0 or i == steps - 1:
            extra_s = ""
            if "probe_cascade" in metrics:
                extra_s = f" probe_cascade={int(metrics['probe_cascade'])}"
            print(f"step {i:5d}  loss {losses[-1]:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}"
                  f"{extra_s}  ({time.time() - t0:.1f}s)", flush=True)

    first = sum(losses[:5]) / max(len(losses[:5]), 1)
    last = sum(losses[-5:]) / max(len(losses[-5:]), 1)
    print(f"done: loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    if checkpoint:
        ckpt_lib.save(checkpoint, convert.lm_params_tree(state.params))
        print(f"saved params to {checkpoint}")
    return losses


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--probe", action="store_true",
                    help="attach the AFM topographic probe to hidden states")
    ap.add_argument("--probe-side", type=int, default=8)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions)")
    args = ap.parse_args(argv)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    return run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
               lr=args.lr, probe=args.probe, probe_side=args.probe_side,
               checkpoint=args.checkpoint, log_every=args.log_every,
               seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
