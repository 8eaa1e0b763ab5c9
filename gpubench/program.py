"""What the harness takes from the program under test: its model
configuration, built from the configuration file and checked against it,
the model it builds, and the module attributes the traced run wraps in
ranges."""
from __future__ import annotations

import dataclasses
import importlib

import torch

from gpubench.weights import DTYPES


def model_config(conf: dict):
    """The port's ``ModelConfig`` of a configuration file: the
    architecture ``arch`` of ``repro_torch.configs`` with ``overrides``
    applied. Raises unless it equals the file's ``model`` block, key for
    key (``head_dim`` is the config's head width ``hd``)."""
    from repro_torch import configs
    over = {k: DTYPES[v] if k in ("dtype", "param_dtype") else v
            for k, v in conf["overrides"].items()}
    cfg = dataclasses.replace(configs.get(conf["arch"]), **over)
    for key, want in conf["model"].items():
        have = cfg.hd if key == "head_dim" else getattr(cfg, key)
        if isinstance(have, torch.dtype):
            have = str(have).removeprefix("torch.")
        if have != want:
            raise RuntimeError(f"{conf['arch']}: the program runs {key} = "
                               f"{have!r}, the configuration file states "
                               f"{want!r}")
    return cfg


def build_model(cfg, device):
    """The program's model of ``cfg`` on ``device``, its parameters
    uninitialised until the harness fills them."""
    from repro_torch.models import transformer
    return transformer.Transformer(cfg, device)


def layer_ranges(conf: dict) -> dict:
    """The (module, attribute) pairs of the configuration file's
    ``ranges`` (name -> ``"module:attribute"``): the layers whose device
    time the traced run reads. The blocks call them through the module
    attribute (``Attention`` and ``MoE`` only hold parameters, so a hook
    on them would never fire)."""
    out = {}
    for name, target in conf.get("ranges", {}).items():
        module, attr = target.split(":")
        out[name] = (importlib.import_module(module), attr)
    return out
