"""Serving launcher: batched prefill and a decode loop for an LM of the
dense, MoE, SSM, hybrid, audio or VLM family, on the card unless asked
otherwise. The port of ``repro.launch.serve``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --batch 4 --prompt-len 128 --max-new 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-moe-16b --batch 4 --prompt-len 128 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --batch 4 --prompt-len 128 --max-new 64
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-medium --batch 4 --prompt-len 128 --max-new 64
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen2-vl-72b --smoke --device cpu

Weights come from the port's seeded init (no checkpoint) and prompts from a
seeded ``torch.Generator``. Every decode step's attention (the hybrid's
local-attention layers; the SSM family has none) runs on the
``kernels.swa`` kernel on CUDA (its plain version on the CPU), whisper's
cross-attention over the encoder's 1,500 frames too. An audio model's
frames are zeros (``transformer.stub_inputs``), as in JAX's launcher; a
VLM is served text-only (no patch embeddings, text M-RoPE positions), as
JAX's launcher serves it. The full qwen2-vl-72b (~145 GB) does not fit one
card: ``chip_smoke.py`` serves it cut to 24 of its 80 layers. An SSM
config whose chunk does not divide the prompt is served at a chunk of
``min(ssm_chunk, 16)``, as JAX's launcher does (``config_for``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.draws import GeneratorDraws
from repro_torch.models import transformer
from repro_torch.serving import serve_step


def prompts_for(cfg, batch: int, prompt_len: int, seed: int,
                device) -> torch.Tensor:
    """(batch, prompt_len) int64 tokens from a seeded CPU generator, moved
    to ``device`` (the same prompts on every device)."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen).to(device)


def config_for(cfg, prompt_len: int):
    """JAX's launcher's chunk rule: an SSM config whose ``ssm_chunk`` does
    not divide the prompt takes ``min(ssm_chunk, 16)`` (the front padding
    of a ragged prompt stays under one short chunk)."""
    if cfg.arch_type == "ssm" and prompt_len % cfg.ssm_chunk:
        return dataclasses.replace(cfg, ssm_chunk=min(cfg.ssm_chunk, 16))
    return cfg


def run(model, cfg, prompts: torch.Tensor, *, max_new: int, cache_len: int,
        draws=None, temperature: float = 0.0, extra_batch: dict | None = None,
        return_logits: bool = False) -> dict:
    """One ``generate`` call, timed on the host clock with a device
    synchronise after the prefill and after the last step. Returns the
    tokens (and with ``return_logits`` the logits they came from),
    ``prefill_ms``, ``decode_ms_per_step``, ``decode_tok_s`` (tokens of the
    decode steps per second) and ``tok_s`` (all new tokens over the whole
    call, as the JAX launcher reports). ``cfg`` goes through
    ``config_for`` first. ``extra_batch`` joins the prompts in the
    prefill's batch (an audio model's ``frames``). A model with learned
    positions refuses a run past its table (``prompt_len + max_new >
    max_positions``): JAX's gather would clamp the index silently, the
    card's would fault."""
    cfg = config_for(cfg, prompts.shape[1])
    npos = cfg.max_positions or 8192
    if cfg.learned_positions and prompts.shape[1] + max_new > npos:
        raise ValueError(f"{cfg.name}: a {prompts.shape[1]}-token prompt and "
                         f"{max_new} new tokens pass its {npos} learned "
                         f"positions")
    timings = {}
    t0 = time.perf_counter()
    out = serve_step.generate(model, cfg, prompts, max_new, cache_len, draws,
                              temperature, extra_batch,
                              return_logits=return_logits, timings=timings)
    seconds = time.perf_counter() - t0
    tokens, logits = out if return_logits else (out, None)
    b, steps = prompts.shape[0], max_new - 1
    decode_s = timings["decode_s"]
    return {"tokens": tokens, "logits": logits, "seconds": seconds,
            "prefill_ms": timings["prefill_s"] * 1e3,
            "decode_ms_per_step": decode_s * 1e3 / max(steps, 1),
            "decode_tok_s": b * steps / decode_s if decode_s > 0 else 0.0,
            "tok_s": b * max_new / seconds}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    device = resolve_device(args.device)
    model = transformer.init_params(cfg, seed=args.seed, device=device)
    prompts = prompts_for(cfg, args.batch, args.prompt_len, args.seed, device)
    draws = (GeneratorDraws(args.seed, device) if args.temperature > 0
             else None)
    out = run(model, cfg, prompts, max_new=args.max_new,
              cache_len=args.prompt_len + args.max_new, draws=draws,
              temperature=args.temperature,
              extra_batch=transformer.stub_inputs(cfg, args.batch, device))
    tokens = out["tokens"]
    print(f"arch={cfg.name} device={device} generated {tuple(tokens.shape)} "
          f"in {out['seconds']:.3f}s ({out['tok_s']:.1f} tok/s); prefill "
          f"{out['prefill_ms']:.3f} ms, decode {out['decode_ms_per_step']:.3f}"
          f" ms/step ({out['decode_tok_s']:.1f} tok/s)")
    print("first row:", tokens[0][:16].tolist())


if __name__ == "__main__":
    main()
