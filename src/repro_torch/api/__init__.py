"""Public surface of the port: the ``TopoMap`` estimator and the backend
registry."""
from repro_torch.api.backends import (BACKENDS, Backend, available_backends,
                                      get_backend, register_backend)
from repro_torch.api.topomap import TopoMap
from repro_torch.core.afm import AFMConfig, AFMState

__all__ = ["AFMConfig", "AFMState", "BACKENDS", "Backend", "TopoMap",
           "available_backends", "get_backend", "register_backend"]
