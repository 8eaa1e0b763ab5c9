"""Training code of the port: AdamW (``adamw``), the LM train step with
the optional AFM probe (``train_step``), checkpoints (``checkpoint``).

``repro_torch.training.async_trainer`` (the event-driven ``async``
backend) is not imported here: ``repro_torch.api.backends`` imports it to
register the backend, and importing it from the package root would close
an import cycle through ``repro_torch.api``.
"""
from repro_torch.training.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.training.train_step import (TrainState, init_train_state,
                                             make_train_step)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "TrainState", "make_train_step", "init_train_state"]
