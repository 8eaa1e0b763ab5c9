"""Serving steps: batched prefill and single-token decode over a KV cache.

A port of ``repro.serving.serve_step``. Greedy decoding takes the argmax;
temperature sampling takes argmax(logits / T + Gumbel noise), which is what
``jax.random.categorical`` computes, with the noise from a draw source
(``draws.gumbel``), so a ``ReplayDraws`` fed ``jax.random.gumbel`` bits
reproduces the JAX package's samples. The decode loop keeps the next token
and the positions on the device: it reads nothing back to the host.
"""
from __future__ import annotations

import time

import torch

from repro_torch.analysis import spans
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig


def init_serving_cache(cfg: ModelConfig, batch: int, cache_len: int,
                       device=None):
    return transformer.init_cache(cfg, batch, cache_len, device=device)


def make_prefill(cfg: ModelConfig, cache_len: int | None = None):
    def prefill(model, batch: dict, cache: dict | None = None):
        return transformer.prefill(model, batch, cfg, cache_len=cache_len,
                                   cache=cache)
    return prefill


def make_decode_step(cfg: ModelConfig, temperature: float = 0.0):
    """Returns step(model, batch, cache, draws=None) -> (next_token (B,)
    int64, logits (B, V) f32, cache). batch: {tokens (B, 1), pos (B,)
    int32[, positions3 (3, B, 1)]}. With ``temperature > 0`` and a draw
    source, it samples."""

    def step(model, batch: dict, cache, draws=None):
        logits, cache = transformer.decode_step(
            model, batch["tokens"], batch["pos"], cache, cfg,
            positions3=batch.get("positions3"))
        if temperature > 0.0 and draws is not None:
            noise = draws.gumbel(tuple(logits.shape))
            nxt = torch.argmax(logits / temperature + noise, dim=-1)
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt, logits, cache

    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, cfg: ModelConfig, prompt_tokens: torch.Tensor,
             max_new: int, cache_len: int, draws=None,
             temperature: float = 0.0, extra_batch: dict | None = None, *,
             return_logits: bool = False, timings: dict | None = None):
    """Prefill, then ``max_new - 1`` decode steps: returns the (B, max_new)
    int64 tokens (the first is the prefill's argmax), and with
    ``return_logits`` also the (B, max_new, V) f32 logits each token was
    chosen from. ``extra_batch`` joins the prompt in the prefill's batch
    (the audio family's ``frames``; the VLM's ``vision_embeds`` and
    ``positions3``). The decode steps take text positions from ``pos = S``
    on, as JAX's loop does, also after an image (Qwen2-VL would continue
    from the grid's largest coordinate + 1). ``timings``, when given, receives
    ``prefill_s`` and ``decode_s`` on the host clock, each ended by a
    device synchronise (the only syncs the loop makes)."""
    with spans.span("generate"):
        b, s = prompt_tokens.shape
        device = prompt_tokens.device
        batch = {"tokens": prompt_tokens, **(extra_batch or {})}
        if timings is not None:
            _sync(device)
            t0 = time.perf_counter()
        last_logits, cache = transformer.prefill(model, batch, cfg,
                                                 cache_len=cache_len)
        tok = torch.argmax(last_logits, dim=-1)
        if timings is not None:
            _sync(device)
            t1 = time.perf_counter()
            timings["prefill_s"] = t1 - t0
        step = make_decode_step(cfg, temperature)
        toks, logits = [tok], [last_logits]
        pos = torch.full((b,), s, dtype=torch.int32, device=device)
        for _ in range(max_new - 1):
            tok, step_logits, cache = step(
                model, {"tokens": tok[:, None], "pos": pos}, cache, draws)
            toks.append(tok)
            if return_logits:
                logits.append(step_logits)
            pos = pos + 1
        out = torch.stack(toks, dim=1)
        if timings is not None:
            _sync(device)
            timings["decode_s"] = time.perf_counter() - t1
        if return_logits:
            return out, torch.stack(logits, dim=1)
        return out
