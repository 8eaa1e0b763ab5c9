"""AFMProbe: the paper's topographic map attached to a model's hidden
states, port of ``repro.core.probe``.

The probe consumes a stream of vectors (mean-pooled hidden states in LM
training) and self-organises them online with the paper's cascade
mechanics: one batched AFM step (``afm.train_step_batch``) a call.

Search mode:

- ``'exact'``: the full BMU pass;
- ``'heuristic'``: the paper's far-link relay race.

On CUDA tensors ``update`` runs the ``kernel`` backend's staged stages
(``api.backends.kernel_stages``): the exact search on the ``bmu`` kernel,
the plain Eq. 3 merge, then the drive and up to 16 waves in one
``drive_cascade`` launch, with a tail on ``cascade_wave``; the relay race
stays as it is. Its draws: the search's (heuristic only), the drive, one
block of 16 waves, one a tail wave. On CPU tensors it runs
``afm.EXACT_STAGES`` or ``afm.DEFAULT_STAGES``, as JAX does, drawing one
``uniform((4, side, side))`` a wave. The step reads the cascade's front
back once on the card (``finish_tail``'s tail decision), and only there.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.api import backends as backends_lib
from repro_torch.core import afm
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ProbeConfig:
    side: int = 16
    dim: int = 512                  # feature dim of the tapped activations
    i_max: int = 100_000            # expected total vectors over training
    search: str = "exact"           # 'exact' | 'heuristic'
    l_s: float = 0.05
    theta: int = 4
    c_o: float = 0.5
    c_s: float = 0.5
    c_m: float = 0.1
    c_d: float = 100.0
    phi: int = 8
    e_factor: float = 0.5
    max_waves: int = 4096

    def afm_config(self) -> afm.AFMConfig:
        return afm.AFMConfig(
            side=self.side, dim=self.dim, phi=self.phi, theta=self.theta,
            l_s=self.l_s, c_o=self.c_o, c_s=self.c_s, c_m=self.c_m,
            c_d=self.c_d, e_factor=self.e_factor, i_max=self.i_max,
            max_waves=self.max_waves,
        )


class ProbeState(NamedTuple):
    afm: afm.AFMState


def init(draws, cfg: ProbeConfig, *,
         device: torch.device | str | None = None) -> ProbeState:
    """A fresh map (weights N(0, 0.1), the link tables) from ``draws``, on
    ``device`` (CUDA unless asked otherwise)."""
    device = resolve_device(device)
    state = afm.init(draws, cfg.afm_config())
    return ProbeState(state._replace(
        w=state.w.to(device), c=state.c.to(device),
        far=state.far.to(device), near=state.near.to(device)))


def pool_hidden(h: torch.Tensor) -> torch.Tensor:
    """(B, S, D) token activations -> (B, D) mean-pooled probe vectors."""
    return h.mean(dim=1)


def stages_for(cfg: ProbeConfig, device: torch.device) -> afm.Stages:
    """The step's stages on ``device``: the kernel backend's staged stages
    on CUDA, the plain ones on the CPU."""
    if cfg.search not in ("exact", "heuristic"):
        raise ValueError(f"search must be 'exact' or 'heuristic', got "
                         f"{cfg.search!r}")
    if device.type == "cuda":
        return backends_lib.kernel_stages(cfg.search)
    return afm.EXACT_STAGES if cfg.search == "exact" else afm.DEFAULT_STAGES


def update(state: ProbeState, vectors: torch.Tensor, draws,
           cfg: ProbeConfig) -> tuple[ProbeState, afm.StepAux]:
    """Feed (B, dim) f32 vectors through one batched AFM step."""
    ns, aux = afm.train_step_batch(
        state.afm, vectors.contiguous(), draws, cfg.afm_config(),
        stages=stages_for(cfg, vectors.device))
    return ProbeState(ns), aux
