"""Moving AFM state between numpy arrays and the port.

``state_from_numpy`` takes what ``np.asarray`` of each leaf of the JAX
package's ``AFMState`` gives (a mapping or a namedtuple of ``w``, ``c``,
``far``, ``near``, ``i``) and returns the port's ``AFMState`` on a device;
``state_to_numpy`` is its inverse.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.afm import AFMState
from repro_torch.device import resolve_device

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
