"""Moving AFM state and LM weights and caches between numpy arrays and the
port.

``state_from_numpy`` takes what ``np.asarray`` of each leaf of the JAX
package's ``AFMState`` gives (a mapping or a namedtuple of ``w``, ``c``,
``far``, ``near``, ``i``) and returns the port's ``AFMState`` on a device;
``state_to_numpy`` is its inverse.

``lm_params_from_numpy`` takes the JAX package's dense-LM ``init_params``
tree as numpy (``embed``, ``ln_f``, optional ``unembed``, and ``blocks``,
whose leaves carry a leading layer axis) and returns the port's
``Transformer``; dense weights are (d_in, d_out) in both packages, so
nothing is transposed. ``lm_cache_from_numpy`` does the same for a KV cache
(``{"blocks": {"k", "v"}}``). The ``*_to_numpy`` functions are their
inverses; bf16 leaves come back as float32 (exact). ``lm_params_tree``
keeps each leaf's own dtype, as CPU tensors: the tree a checkpoint of the
weights is written from.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.afm import AFMState
from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import Transformer

FIELDS = ("w", "c", "far", "near", "i")
_DTYPES = {"w": torch.float32, "c": torch.int32, "far": torch.int32,
           "near": torch.int32}


def state_from_numpy(arrays: Mapping[str, Any] | Any,
                     device: torch.device | str | None = None) -> AFMState:
    """An ``AFMState`` on ``device`` (CUDA unless asked otherwise)."""
    if not isinstance(arrays, Mapping):
        arrays = {f: getattr(arrays, f) for f in FIELDS}
    device = resolve_device(device)
    leaves = {f: torch.as_tensor(np.array(arrays[f]), dtype=dtype,
                                 device=device).contiguous()
              for f, dtype in _DTYPES.items()}
    return AFMState(**leaves, i=int(np.asarray(arrays["i"])))


def state_to_numpy(state: AFMState) -> dict[str, np.ndarray]:
    """Numpy copies of each leaf, with the JAX package's dtypes."""
    out = {f: getattr(state, f).detach().cpu().numpy() for f in _DTYPES}
    out["i"] = np.int32(state.i)
    return out


def _float_tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # via float32: numpy has no bfloat16, and JAX's bf16 arrays convert exactly
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype).contiguous()


def _leaf(tree: Mapping[str, Any], name: str):
    """The numpy leaf of a parameter name: ``blocks.3.attn.wq`` is layer 3
    of ``tree["blocks"]["attn"]["wq"]``."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return tree[name]
    node = tree["blocks"]
    for part in parts[2:]:
        node = node[part]
    return np.asarray(node)[int(parts[1])]


def lm_params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                         device: torch.device | str | None = None
                         ) -> Transformer:
    """A ``Transformer`` on ``device`` (CUDA unless asked otherwise) holding
    the weights of a JAX ``init_params`` tree, in the port's dtypes."""
    device = resolve_device(device)
    model = Transformer(cfg, device)
    with torch.no_grad():
        for name, param in model.named_parameters():
            src = _leaf(tree, name)
            if tuple(np.shape(src)) != tuple(param.shape):
                raise ValueError(f"{name}: shape {np.shape(src)} in the tree, "
                                 f"{tuple(param.shape)} in the model")
            param.copy_(_float_tensor(src, param.dtype, device))
    return model


def lm_params_tree(model: Transformer,
                   dtype: torch.dtype | None = None) -> dict:
    """The JAX ``init_params`` tree of a ``Transformer`` as CPU tensors:
    layer leaves stacked on a leading axis, each leaf in its own dtype
    (bf16 weights stay bf16) or in ``dtype``. ``training.checkpoint.save``
    writes it as JAX's ``save`` writes the ``init_params`` tree of the same
    config, byte for byte."""
    tree: dict = {"blocks": {}}
    layers: dict = {}
    for name, param in model.named_parameters():
        arr = param.detach().cpu()
        if dtype is not None:
            arr = arr.to(dtype)
        parts = name.split(".")
        if parts[0] != "blocks":
            tree[name] = arr
        else:
            layers.setdefault(tuple(parts[2:]), []).append(arr)
    for path, arrs in layers.items():
        node = tree["blocks"]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = torch.stack(arrs)
    return tree


def lm_params_to_numpy(model: Transformer) -> dict:
    """``lm_params_tree`` as float32 numpy arrays (numpy has no bfloat16;
    bf16 weights convert exactly)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node.numpy()
    return walk(lm_params_tree(model, torch.float32))


def lm_cache_from_numpy(tree: Mapping[str, Any], dtype: torch.dtype,
                        device: torch.device | str | None = None) -> dict:
    """A KV cache ``{"blocks": {"k", "v"}}`` of (L, B, S, Hkv, hd) tensors."""
    device = resolve_device(device)
    return {name: {kv: _float_tensor(arr, dtype, device)
                   for kv, arr in stack.items()}
            for name, stack in tree.items()}


def lm_cache_to_numpy(cache: Mapping[str, Any]) -> dict:
    return {name: {kv: t.detach().float().cpu().numpy()
                   for kv, t in stack.items()}
            for name, stack in cache.items()}
