"""``TopoMap``, the front door for training and using an AFM, port of
``repro.api.topomap``.

    from repro_torch.api import TopoMap
    tm = TopoMap(side=30, dim=784, batch=16, backend="kernel").fit(xtr, ytr)
    units = tm.transform(xte)          # BMU projection
    pred = tm.predict(xte)             # unit-label classification
    q = tm.quantization_error(xte)
    tm.save("artifacts/mnist-map")     # versioned artifact; TopoMap.load()

Everything runs on ``device`` (CUDA unless the caller asks for the CPU).
Randomness comes from a draw source (``repro_torch.draws``): a
``GeneratorDraws(seed)`` unless ``fit`` is handed one. Inference
(``transform`` / ``predict`` / ``quantization_error``) runs on the same
bucketed engine that backs ``repro_torch.serving.maps.MapService``:
requests are cut into chunks of at most the top bucket (4,096 samples),
each one launch of the ``bmu`` kernel on exactly its rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.api import backends as backends_lib
from repro_torch.core import classifier, metrics
from repro_torch.core.afm import AFMConfig, AFMState
from repro_torch.draws import GeneratorDraws

#: backend names of JAX-written artifacts, in the port's registry
_JAX_BACKENDS = {"pallas": "kernel"}


class TopoMap:
    """Topographic-map estimator over pluggable execution backends.

    Args:
      cfg: an ``AFMConfig``; omit to build one from ``**overrides``.
      backend: registry key ('reference', 'batched', 'kernel', 'sharded',
           'async').
      backend_options: forwarded to the backend constructor (e.g.
           ``{"search": "heuristic"}``, ``{"precision": "bf16"}``, for
           'sharded' ``{"mesh": ShardMesh((2, 2), ("data", "model"))}`` or,
           for 'async', ``{"latency": "constant", "delay": 1.0}`` and
           ``{"placement": "mesh", "shards": 2}``). A mesh runs one process
           a rank; every rank makes the same calls and holds the whole
           dense ``state_``, on which the queries run.
      seed: seed of the default draw source.
      labeling: unit-labelling rule for ``predict``: 'nearest' (Eq. 7) or
           'majority' (vote of the unit's basin, Eq.-7 fallback when empty).
      device: where the map lives and trains (default CUDA).

    Fitted attributes: ``state_`` (dense ``AFMState``), ``fit_aux_`` (stacked
    per-step aux), ``unit_labels_`` (when ``fit`` received labels).
    """

    def __init__(self, cfg: AFMConfig | None = None, *,
                 backend: str = "batched",
                 backend_options: dict[str, Any] | None = None,
                 seed: int = 0, labeling: str = "nearest",
                 device: torch.device | str | None = None, **overrides):
        if cfg is None:
            cfg = AFMConfig(**overrides)
        elif overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        if labeling not in ("nearest", "majority"):
            raise ValueError(f"labeling must be 'nearest' or 'majority', "
                             f"got {labeling!r}")
        self.cfg = cfg
        self.backend = backends_lib.get_backend(
            backend, cfg, device=device, **(backend_options or {}))
        self.device = self.backend.device
        self.seed = seed
        self.labeling = labeling
        self.state_: AFMState | None = None
        self.fit_aux_ = None
        self.unit_labels_: torch.Tensor | None = None
        self._backend_state = None
        self._draws = None
        self._engine = None

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device).contiguous()

    # ------------------------------------------------------------------ fit

    def fit(self, data, labels=None, *, draws=None,
            num_steps: int | None = None) -> "TopoMap":
        """Train on (num_samples, D) data (sampled with replacement).

        ``num_steps`` defaults to the config's full sample budget. Passing
        ``labels`` (num_samples,) also labels the units for ``predict``.
        Later ``partial_fit`` calls go on drawing from the same source.
        """
        data = self._tensor(data)
        self._draws = GeneratorDraws(self.seed, self.device) \
            if draws is None else draws
        state = self.backend.init(self._draws, data)
        state, aux = self.backend.run(state, data, self._draws, num_steps)
        self._backend_state = state
        self.fit_aux_ = aux
        self.state_ = self.backend.to_dense(state)
        if labels is not None:
            self.label(data, labels)
        return self

    def partial_fit(self, batch, *, draws=None) -> "TopoMap":
        """One training step on an explicit (B, D) batch (online usage)."""
        batch = self._tensor(batch)
        if draws is None:
            if self._draws is None:
                self._draws = GeneratorDraws(self.seed, self.device)
            draws = self._draws
        if self._backend_state is None:
            self._backend_state = self.backend.init(draws, batch)
        self._backend_state, aux = self.backend.step(self._backend_state,
                                                     batch, draws)
        self.fit_aux_ = aux
        self.state_ = self.backend.to_dense(self._backend_state)
        return self

    def label(self, data, labels, num_classes: int | None = None) -> "TopoMap":
        """(Re)label units from a labelled sample set (Eq. 7 / majority)."""
        self._check_fitted()
        data = self._tensor(data)
        labels = self._tensor(labels, torch.int32)
        if self.labeling == "majority":
            self.unit_labels_ = classifier.label_units_majority(
                self.state_.w, data, labels, num_classes)
        else:
            self.unit_labels_ = classifier.label_units(self.state_.w, data,
                                                       labels)
        return self

    @classmethod
    def from_state(cls, state: AFMState, cfg: AFMConfig, *,
                   unit_labels=None, **kwargs) -> "TopoMap":
        """Wrap an existing dense ``AFMState`` (e.g. one from
        ``repro_torch.convert.state_from_numpy``) in the estimator surface.
        Passing ``unit_labels`` (N,) restores a classifier map."""
        tm = cls(cfg, **kwargs)
        tm.state_ = state
        tm._backend_state = tm.backend.from_dense(state)
        if unit_labels is not None:
            tm.unit_labels_ = tm._tensor(unit_labels, torch.int32)
        return tm

    # ---------------------------------------------------------- persistence

    def save(self, path: str, *, extra_meta: dict | None = None) -> str:
        """Write the fitted map as a versioned artifact directory (config,
        dense state, unit labels, labeling/backend metadata), see
        ``repro_torch.api.persistence``. Returns ``path``."""
        self._check_fitted()
        from repro_torch.api import persistence
        return persistence.save_artifact(
            path, cfg=self.cfg, state=self.state_,
            unit_labels=self.unit_labels_, labeling=self.labeling,
            backend=self.backend.name, extra_meta=extra_meta)

    @classmethod
    def load(cls, path: str, *, backend: str | None = None,
             device: torch.device | str | None = None,
             **kwargs) -> "TopoMap":
        """Load a saved artifact back into an estimator on ``device`` (CUDA
        unless the caller asks for the CPU).

        The stored backend and labeling are used unless overridden; a JAX
        artifact's ``"pallas"`` becomes the port's ``"kernel"``, and a
        ``"sharded"`` map loads onto a 1 x 1 mesh, as JAX's does. The
        round-trip is bit-identical on ``transform`` and ``predict``.
        """
        from repro_torch.api import persistence
        art = persistence.load_artifact(path, device=device)
        if backend is None:
            backend = _JAX_BACKENDS.get(art.backend, art.backend)
        kwargs.setdefault("labeling", art.labeling)
        return cls.from_state(art.state, art.cfg,
                              unit_labels=art.unit_labels, backend=backend,
                              device=device, **kwargs)

    # ------------------------------------------------------------ inference

    @property
    def engine(self):
        """The bucketed BMU engine shared with ``MapService``, recording its
        (bucket, map shape) signatures in the process-wide
        ``repro_torch.serving.maps.CompileCache`` that every estimator,
        service and gateway shares. Always the exact tier: a backend's
        ``precision`` is its training search's."""
        if self._engine is None:
            from repro_torch.serving import maps as maps_lib
            self._engine = maps_lib.BmuEngine()
        return self._engine

    def transform(self, data, *, lattice: bool = False,
                  chunk: int | None = None) -> torch.Tensor:
        """BMU projection. Returns (B,) flat unit indices, or (B, 2) lattice
        (row, col) coordinates when ``lattice=True``. ``chunk`` optionally
        caps the engine's largest chunk (a memory ceiling); it is clamped
        to the bucket ladder, so no ``chunk`` value can add a signature or
        an oversized dispatch."""
        self._check_fitted()
        flat, _ = self.engine.bmu(self.state_.w, self._tensor(data),
                                  cap=chunk)
        if not lattice:
            return flat
        return torch.stack([flat // self.cfg.side, flat % self.cfg.side],
                           dim=-1)

    def predict(self, data, chunk: int | None = None) -> torch.Tensor:
        """Classify each sample with its BMU's unit label."""
        self._check_fitted()
        if self.unit_labels_ is None:
            raise RuntimeError("predict() needs unit labels: fit with "
                               "labels, or call label(data, labels) first")
        return self.unit_labels_[self.transform(data, chunk=chunk).long()]

    # -------------------------------------------------------------- metrics

    def quantization_error(self, data, chunk: int | None = None) -> float:
        """Q: mean Euclidean distance of samples to their BMU weight."""
        self._check_fitted()
        _, q2 = self.engine.bmu(self.state_.w, self._tensor(data), cap=chunk)
        return float(torch.mean(torch.sqrt(q2)))

    def topographic_error(self, data) -> float:
        """T: fraction of samples whose two best units are not adjacent."""
        self._check_fitted()
        return float(metrics.topological_error(
            self.state_.w, self._tensor(data), self.cfg.side))

    def search_error(self, data, *, draws=None) -> float:
        """F: heuristic-search GMU vs exact BMU disagreement rate."""
        self._check_fitted()
        draws = GeneratorDraws(self.seed, self.device) if draws is None \
            else draws
        s = self.state_
        f, _ = metrics.search_error(s.w, s.near, s.far, self._tensor(data),
                                    draws, self.cfg.e)
        return float(f)

    def u_matrix(self) -> torch.Tensor:
        """(side, side) mean distance of each unit to its lattice neighbours
        (low = coherent region), the classic U-matrix view of the map."""
        self._check_fitted()
        return metrics.u_matrix(self.state_.w, self.cfg.side)

    # ------------------------------------------------------------- plumbing

    @property
    def weights_(self) -> torch.Tensor:
        self._check_fitted()
        return self.state_.w

    def _check_fitted(self):
        if self.state_ is None:
            raise RuntimeError("TopoMap is not fitted yet: call fit() or "
                               "partial_fit() first")

    def __repr__(self):
        fitted = "fitted" if self.state_ is not None else "unfitted"
        return (f"TopoMap(side={self.cfg.side}, dim={self.cfg.dim}, "
                f"backend={self.backend.name!r}, device={self.device}, "
                f"{fitted})")
