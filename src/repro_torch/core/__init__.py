"""Core AFM library of the port: the paper's dynamics as PyTorch functions."""
from repro_torch.core.afm import (AFMConfig, AFMState, init, train,
                                  train_step, train_step_batch)
from repro_torch.core.som import SOMConfig, SOMState

__all__ = ["AFMConfig", "AFMState", "init", "train", "train_step",
           "train_step_batch", "SOMConfig", "SOMState"]
