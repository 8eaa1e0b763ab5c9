"""Public surface of the port: the ``TopoMap`` estimator, the backend
registry, and map persistence (versioned artifacts, the ``MapStore``)."""
from repro_torch.api.backends import (BACKENDS, Backend, add_backend_argument,
                                      available_backends, get_backend,
                                      register_backend)
from repro_torch.api.persistence import (MapArtifact, MapStore,
                                         load_artifact, save_artifact)
from repro_torch.api.topomap import TopoMap
from repro_torch.core.afm import AFMConfig, AFMState
from repro_torch.core.classifier import precision_recall

__all__ = [
    "AFMConfig", "AFMState", "BACKENDS", "Backend", "MapArtifact",
    "MapStore", "TopoMap", "add_backend_argument", "available_backends",
    "get_backend", "load_artifact", "precision_recall", "register_backend",
    "save_artifact",
]
