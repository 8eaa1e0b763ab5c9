"""Train step: LM cross-entropy + auxiliary loss + AdamW, optionally with
an AFM probe (the paper's topographic map tapping pooled hidden states).
Port of ``repro.training.train_step``.

    state = init_train_state(cfg, probe_cfg, seed=0)        # on CUDA
    step = make_train_step(cfg, AdamWConfig(...), probe_cfg)
    state, metrics = step(state, {"tokens": t, "labels": t}, draws)

The model's weights are the state's ``Transformer`` (trainable);
``adamw_update`` runs over its ``named_parameters()`` and updates them in
place. ``draws`` feeds the probe (``core.probe.update``) and is unused
without one. Every metric is a device tensor: nothing in a step reads the
card back, except the probe's cascade tail decision (one read a step).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import probe as probe_lib
from repro_torch.draws import GeneratorDraws
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig, softmax_cross_entropy
from repro_torch.training.adamw import (AdamWConfig, AdamWState, adamw_init,
                                        adamw_update)


class TrainState(NamedTuple):
    params: transformer.Transformer
    opt: AdamWState
    step: torch.Tensor              # () int32
    probe: tuple | None = None      # ProbeState when the AFM probe is attached


def init_train_state(cfg: ModelConfig, probe_cfg=None, *, seed: int = 0,
                     device: torch.device | str | None = None) -> TrainState:
    """Seeded weights (``transformer.init_params``) made trainable, zero f32
    moments and, with ``probe_cfg``, a fresh probe map drawn from the seed
    with 1 folded in (JAX's ``fold_in(key, 1)``); on ``device``, CUDA
    unless asked otherwise."""
    model = transformer.init_params(cfg, seed=seed, device=device)
    model.requires_grad_(True)
    device = model.embed.device
    probe = None
    if probe_cfg is not None:
        probe = probe_lib.init(GeneratorDraws(seed, device).fold_in(1),
                               probe_cfg, device=device)
    return TrainState(model, adamw_init(dict(model.named_parameters())),
                      torch.zeros((), dtype=torch.int32, device=device),
                      probe)


def lm_loss(model: transformer.Transformer, batch: dict, cfg: ModelConfig,
            return_hidden: bool = False):
    """The step's loss, ``ce + router_aux_coef * aux``: the next-token CE
    over the full logits, or ``chunked_ce_loss`` under ``cfg.chunked_ce``.
    Returns (loss, ce, aux, the pre-ln_f hidden states or None); the hidden
    states come back when ``return_hidden`` or ``cfg.chunked_ce``."""
    labels = batch["labels"]
    if cfg.chunked_ce:
        hidden = transformer.forward_hidden(model, batch, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
        ce = transformer.chunked_ce_loss(model, hidden, labels, cfg)
    else:
        out = transformer.forward_train(model, batch, cfg,
                                        return_hidden=return_hidden)
        logits, aux = out[:2]
        hidden = out[2] if return_hidden else None
        ce = softmax_cross_entropy(logits[:, :-1], labels[:, 1:])
    return ce + cfg.router_aux_coef * aux, ce, aux, hidden


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, probe_cfg=None):
    """Returns ``step(state, batch, draws) -> (state, metrics)``; metrics
    ``loss``, ``ce``, ``moe_aux``, ``grad_norm``, ``lr`` and, with the
    probe, ``probe_cascade``, each a 0-d device tensor."""

    def step(state: TrainState, batch: dict, draws=None
             ) -> tuple[TrainState, dict]:
        model = state.params
        params = dict(model.named_parameters())
        loss, ce, aux, hidden = lm_loss(model, batch, cfg,
                                        return_hidden=probe_cfg is not None)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        _, opt, m = adamw_update(params, grads, state.opt, opt_cfg)
        del grads
        metrics = {"loss": loss.detach(), "ce": ce.detach(),
                   "moe_aux": aux.detach(), **m}
        probe = state.probe
        if probe is not None and probe_cfg is not None:
            # tap: the final hidden states, mean-pooled per sequence
            vecs = probe_lib.pool_hidden(hidden.detach().float())
            probe, paux = probe_lib.update(probe, vecs, draws, probe_cfg)
            metrics["probe_cascade"] = paux.cascade_size
        return TrainState(model, opt, state.step + 1, probe), metrics

    return step
