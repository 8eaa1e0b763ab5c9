"""Trained-map persistence: versioned artifacts and the ``MapStore``
registry, port of ``repro.api.persistence``.

An **artifact** is a directory that fully describes one trained map:

    artifact/
      manifest.json         # format marker + version, AFMConfig, labeling,
                            # backend provenance, unit-label presence
      state.msgpack         # dense AFMState (training/checkpoint format)
      unit_labels.msgpack   # optional (N,) int32 unit labels

The format is the JAX package's: either package loads what the other
saves. The manifest's ``backend`` names the backend of the package that
wrote it. The port writes its own names (``"kernel"`` where JAX writes
``"pallas"``); ``TopoMap.load`` maps JAX's ``"pallas"`` to ``"kernel"``, and
JAX loads a port artifact through ``load_artifact``, or through
``TopoMap.load`` with an explicit ``backend=``.

A **MapStore** is a directory of artifacts keyed ``name@version``:

    store_root/
      satimage-10x10/v1/    # one artifact per version
      satimage-10x10/v2/

``store.save(tm, "satimage-10x10")`` auto-increments the version;
``store.load("satimage-10x10")`` resolves to the latest, or pin with
``"satimage-10x10@1"``.
"""
from __future__ import annotations

import dataclasses
import errno
import json
import os
import re
import shutil
from typing import Any

import torch

from repro_torch.core.afm import AFMConfig, AFMState
from repro_torch.device import resolve_device
from repro_torch.training import checkpoint as ckpt

ARTIFACT_FORMAT = "topomap-artifact"
ARTIFACT_VERSION = 1

_MANIFEST = "manifest.json"
_STATE = "state.msgpack"
_UNIT_LABELS = "unit_labels.msgpack"
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


@dataclasses.dataclass(frozen=True)
class MapArtifact:
    """A loaded artifact: everything ``TopoMap.load`` / ``MapService`` need."""
    cfg: AFMConfig
    state: AFMState
    unit_labels: torch.Tensor | None
    labeling: str
    backend: str
    meta: dict[str, Any]


def _state_like(cfg: AFMConfig, device: torch.device | str = "cpu"
                ) -> AFMState:
    n = cfg.n_units
    device = torch.device(device)
    return AFMState(
        w=torch.zeros((n, cfg.dim), dtype=torch.float32, device=device),
        c=torch.zeros((n,), dtype=torch.int32, device=device),
        far=torch.zeros((n, cfg.phi), dtype=torch.int32, device=device),
        near=torch.zeros((n, 4), dtype=torch.int32, device=device),
        i=0,
    )


def _config_from_dict(d: dict[str, Any]) -> AFMConfig:
    known = {f.name for f in dataclasses.fields(AFMConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(
            f"artifact config has unknown AFMConfig fields {unknown} — "
            f"written by a newer repro?")
    return AFMConfig(**d)


def save_artifact(path: str, *, cfg: AFMConfig, state: AFMState,
                  unit_labels=None, labeling: str = "nearest",
                  backend: str = "batched",
                  extra_meta: dict[str, Any] | None = None) -> str:
    """Write a trained map as a versioned artifact directory. Returns path.

    The artifact is assembled in a sibling temp directory and swapped in by
    rename, so a crash never leaves a *mixed* artifact: a reader sees the
    complete old version, the complete new version, or (in the brief
    overwrite window) a clean missing-manifest error.
    """
    path = os.path.abspath(path)
    if os.path.exists(path) and not os.path.isdir(path):
        raise ValueError(f"{path} exists and is not a directory — refusing "
                         f"to overwrite it with an artifact")
    manifest = {
        "format": ARTIFACT_FORMAT,
        "format_version": ARTIFACT_VERSION,
        "config": dataclasses.asdict(cfg),
        "labeling": labeling,
        "backend": backend,
        "has_unit_labels": unit_labels is not None,
        "samples_consumed": int(state.i),
    }
    if extra_meta:
        manifest["extra"] = extra_meta
    tmp_dir = f"{path}.tmp-{os.getpid()}"
    if os.path.isdir(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir)
    try:
        ckpt.save(os.path.join(tmp_dir, _STATE), state)
        payload_files = [_STATE]
        if unit_labels is not None:
            ckpt.save(os.path.join(tmp_dir, _UNIT_LABELS),
                      torch.as_tensor(unit_labels).to(torch.int32))
            payload_files.append(_UNIT_LABELS)
        # per-file SHA-256 over the payloads just written: load_artifact
        # re-hashes before trusting a byte
        manifest["checksums"] = {
            f: ckpt.file_sha256(os.path.join(tmp_dir, f))
            for f in payload_files
        }
        with open(os.path.join(tmp_dir, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
            f.write("\n")
        try:
            # atomic when the target is absent or an empty directory (a
            # fresh MapStore version reservation stays claimed throughout)
            os.replace(tmp_dir, path)
        except OSError as e:
            if e.errno not in (errno.ENOTEMPTY, errno.EEXIST):
                raise
            # overwriting a non-empty artifact: a reader in this brief
            # window sees a clean missing-manifest error, never mixed files
            shutil.rmtree(path)
            os.replace(tmp_dir, path)
    finally:
        if os.path.isdir(tmp_dir):
            shutil.rmtree(tmp_dir, ignore_errors=True)
    return path


def load_artifact(path: str, *, device: torch.device | str | None = None
                  ) -> MapArtifact:
    """Load an artifact directory back into config + dense state (+ labels),
    the tensors on ``device`` (CUDA unless the caller asks for the CPU)."""
    manifest_path = os.path.join(path, _MANIFEST)
    if not os.path.isfile(manifest_path):
        raise FileNotFoundError(f"{path}: no {_MANIFEST} — not a map artifact")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except json.JSONDecodeError as exc:
        raise ValueError(
            f"{manifest_path}: corrupt or truncated manifest: {exc}") from exc
    if manifest.get("format") != ARTIFACT_FORMAT:
        raise ValueError(f"{path}: manifest format is "
                         f"{manifest.get('format')!r}, not {ARTIFACT_FORMAT!r}")
    version = manifest.get("format_version", 0)
    if version > ARTIFACT_VERSION:
        raise ValueError(
            f"{path}: artifact format version {version} is newer than this "
            f"reader (understands <= {ARTIFACT_VERSION})")
    cfg = _config_from_dict(manifest["config"])
    device = resolve_device(device)
    # integrity gate: every payload named in the manifest is re-hashed
    # before any of its bytes is trusted (manifests without the field still
    # load: their payloads carry the embedded leaf checksum instead)
    for fname, want in sorted((manifest.get("checksums") or {}).items()):
        fpath = os.path.join(path, fname)
        if not os.path.isfile(fpath):
            raise ValueError(
                f"{path}: corrupt or truncated artifact — payload file "
                f"{fname!r} named in the manifest is missing")
        got = ckpt.file_sha256(fpath)
        if got != want:
            raise ValueError(
                f"{path}: corrupt or truncated artifact — {fname} checksum "
                f"mismatch (manifest {want[:12]}…, file {got[:12]}…)")
    state = ckpt.restore(os.path.join(path, _STATE),
                         _state_like(cfg, device))
    unit_labels = None
    if manifest.get("has_unit_labels"):
        unit_labels = ckpt.restore(
            os.path.join(path, _UNIT_LABELS),
            torch.zeros((cfg.n_units,), dtype=torch.int32, device=device))
    return MapArtifact(cfg=cfg, state=state, unit_labels=unit_labels,
                       labeling=manifest.get("labeling", "nearest"),
                       backend=manifest.get("backend", "batched"),
                       meta=manifest)


def parse_spec(spec: str) -> tuple[str, int | None]:
    """``'name'`` -> (name, None) = latest; ``'name@3'`` -> (name, 3)."""
    name, sep, version = spec.partition("@")
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid map name {name!r} (want [A-Za-z0-9._-]+)")
    if not sep:
        return name, None
    if not version.isdigit():
        raise ValueError(f"invalid map spec {spec!r} (want name@INTEGER)")
    return name, int(version)


class MapStore:
    """Directory registry of map artifacts keyed ``name@version``."""

    def __init__(self, root: str):
        self.root = root

    # ----------------------------------------------------------- resolution

    def versions(self, name: str) -> list[int]:
        """Sorted versions present for ``name`` (empty when unknown)."""
        d = os.path.join(self.root, name)
        if not os.path.isdir(d):
            return []
        out = []
        for entry in os.listdir(d):
            m = re.fullmatch(r"v(\d+)", entry)
            if m and os.path.isfile(os.path.join(d, entry, _MANIFEST)):
                out.append(int(m.group(1)))
        return sorted(out)

    def names(self) -> list[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(n for n in os.listdir(self.root) if self.versions(n))

    def list(self) -> list[str]:
        """Every ``name@version`` key in the store."""
        return [f"{n}@{v}" for n in self.names() for v in self.versions(n)]

    def path(self, spec: str) -> str:
        """Artifact directory for ``name[@version]`` (latest when omitted)."""
        name, version = parse_spec(spec)
        versions = self.versions(name)
        if not versions:
            raise KeyError(f"map {name!r} not in store {self.root!r}; "
                           f"have {self.names()}")
        if version is None:
            version = versions[-1]
        elif version not in versions:
            raise KeyError(f"map {name!r} has versions {versions}, "
                           f"not {version}")
        return os.path.join(self.root, name, f"v{version}")

    # ------------------------------------------------------------ save/load

    def _reserve(self, name: str) -> tuple[str, str, int]:
        """Claim the next version directory for ``name``.

        Reserves with an exclusive mkdir so two concurrent savers can never
        clobber the same version key; the artifact write renames over the
        still-reserved empty dir atomically. Returns (parsed name, path,
        version).
        """
        parsed, version = parse_spec(name)
        if version is not None:
            raise ValueError(f"store saves take a bare name, got {name!r} "
                             f"(versions auto-increment)")
        version = (self.versions(parsed) or [0])[-1]
        os.makedirs(os.path.join(self.root, parsed), exist_ok=True)
        while True:
            version += 1
            path = os.path.join(self.root, parsed, f"v{version}")
            try:
                os.mkdir(path)
                return parsed, path, version
            except FileExistsError:
                continue

    def save(self, tm, name: str, *, extra_meta=None) -> str:
        """Persist a fitted ``TopoMap`` under the next version of ``name``.

        Returns the ``name@version`` key of the new artifact.
        """
        parsed, path, version = self._reserve(name)
        tm.save(path, extra_meta=extra_meta)
        return f"{parsed}@{version}"

    def save_state(self, name: str, *, cfg: AFMConfig, state: AFMState,
                   unit_labels=None, labeling: str = "nearest",
                   backend: str = "batched", extra_meta=None) -> str:
        """Persist raw map state under the next version of ``name``, no
        estimator needed: the publish path for serving-side producers
        (``MapFleet`` rolling reloads, ``serve_map --reload-during-run``)
        that hold a ``(cfg, state)`` snapshot. Returns the
        ``name@version`` key.
        """
        parsed, path, version = self._reserve(name)
        save_artifact(path, cfg=cfg, state=state, unit_labels=unit_labels,
                      labeling=labeling, backend=backend,
                      extra_meta=extra_meta)
        return f"{parsed}@{version}"

    def load_artifact(self, spec: str, *, device=None) -> MapArtifact:
        return load_artifact(self.path(spec), device=device)

    def load(self, spec: str, **topomap_kwargs):
        """Load ``name[@version]`` back into a ``TopoMap`` estimator."""
        from repro_torch.api.topomap import TopoMap
        return TopoMap.load(self.path(spec), **topomap_kwargs)

    def __repr__(self):
        return f"MapStore({self.root!r}, maps={self.list()})"
