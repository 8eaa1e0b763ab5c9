"""Checkpointing: msgpack-serialised trees with a dtype/shape manifest, port
of ``repro.training.checkpoint``.

The format is the JAX package's, byte for byte: a msgpack payload holding a
format version, the tree structure, the dtype, shape and raw little-endian
bytes of every leaf, and a SHA-256 over those leaves. Either package reads
what the other writes. A tree is a NamedTuple, dict, list, tuple or None
over leaves that are tensors, numpy arrays or Python scalars, flattened in
JAX's order (a dict by sorted key, a NamedTuple by field) without
``jax.tree``. A Python ``int`` leaf (the port's ``AFMState.i``) is written
as a shape-``[]`` ``int32`` leaf, as JAX writes its ``jnp.int32`` step
count, and read back as an ``int``.

All structural checks raise ``ValueError`` so that callers (notably
``repro_torch.api.persistence``) can report corrupt or mismatched payloads
clearly.

``save_train_checkpoint`` / ``load_train_checkpoint`` persist a training
checkpoint directory: the drained dense ``AFMState``, the async backend's
latency-stream position, the sample cursor and free-form metadata, under a
manifest with a SHA-256 per payload file. The latency stream of the port is
a ``torch.Generator`` (``AsyncBackend.lat_draws.generator``), not a
threefry key: the checkpoint stores its ``get_state()`` bytes and names the
kind of stream in ``meta["lat_stream"]``. A JAX checkpoint's ``(2,)
uint32`` key is refused, not used as a seed. On a mesh of several ranks
that one state is every shard's latency position (``AsyncBackend`` splits
each run's shard streams off it) and every rank holds the same dense
state, so the one checkpoint that rank 0 writes restores every rank.
"""
from __future__ import annotations

import dataclasses
import errno
import hashlib
import json
import os
import shutil
from typing import Any

import msgpack
import numpy as np
import torch

# Bump when the payload layout changes incompatibly. Version 1 payloads
# (pre-dating the field) are identical except for the missing marker and
# load fine; readers reject versions *newer* than they understand.
FORMAT_VERSION = 2

TRAIN_CKPT_FORMAT = "train-checkpoint"
TRAIN_CKPT_VERSION = 1

#: ``meta["lat_stream"]`` of a port checkpoint: the latency field holds
#: ``torch.Generator.get_state()`` bytes
LAT_STREAM_TORCH = "torch.Generator.get_state"

_TC_MANIFEST = "manifest.json"
_TC_STATE = "state.msgpack"
_TC_ENGINE = "engine.msgpack"

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8,
    "bool": torch.bool,
}
_NUMPY_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _flatten(tree) -> list:
    """The leaves of ``tree`` in JAX's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [tree]


def _unflatten(like, leaves):
    """A tree of ``like``'s structure over ``leaves`` (consumed in order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def treedef_str(tree) -> str:
    """The string ``str(jax.tree.structure(tree))`` gives for the builtin
    containers, e.g. ``PyTreeDef(CustomNode(namedtuple[AFMState], [*, *, *,
    *, *]))`` for an ``AFMState``. Only a hint in the payload: ``restore``
    gates on ``describe_structure``."""
    def fmt(node):
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(node[k])}"
                                   for k in sorted(node)) + "}"
        if _is_namedtuple(node):
            inner = ", ".join(fmt(v) for v in node)
            return f"CustomNode(namedtuple[{type(node).__name__}], [{inner}])"
        if isinstance(node, list):
            return "[" + ", ".join(fmt(v) for v in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(fmt(v) for v in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({fmt(tree)})"


def describe_structure(tree):
    """A version-stable structure descriptor for the builtin container types
    (dict / list / tuple / namedtuple / None), in flatten order. Equal
    descriptors mean equal structure in either package; every other node is
    a leaf marker."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {"dict": {str(k): describe_structure(v)
                         for k, v in sorted(tree.items())}}
    if _is_namedtuple(tree):
        return {"namedtuple": [type(tree).__name__,
                               {f: describe_structure(v)
                                for f, v in zip(tree._fields, tree)}]}
    if isinstance(tree, (list, tuple)):
        return {type(tree).__name__: [describe_structure(v) for v in tree]}
    return "*"


def _leaf_array(leaf) -> np.ndarray:
    """A leaf as the numpy array the payload stores. Python ints and floats
    take JAX's default 32-bit dtypes, as ``jnp.asarray`` gives them."""
    if isinstance(leaf, torch.Tensor):
        # a save writes the state to disk: each leaf is read back once
        return leaf.detach().cpu().contiguous().numpy()  # lint: sync-ok(save)
    if isinstance(leaf, bool):
        return np.asarray(leaf)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float32)
    return np.asarray(leaf)


def _leaf_like(ref, arr: np.ndarray):
    """``arr`` in the type, dtype and device of the ``like`` leaf ``ref``."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(arr.astype(_NUMPY_NAMES[ref.dtype])).to(
            ref.device).contiguous()
    if isinstance(ref, bool):
        return bool(arr)
    if isinstance(ref, int):
        return int(arr)
    if isinstance(ref, float):
        return float(arr)
    return arr.astype(np.asarray(ref).dtype)


def _leaf_shape(ref) -> list:
    if isinstance(ref, torch.Tensor):
        return list(ref.shape)
    return list(np.shape(ref))


def _leaves_sha256(leaf_records) -> str:
    """SHA-256 over the leaf buffers *and* their dtype/shape headers, in
    flatten order: a content fingerprint of the numbers, immune to msgpack
    re-encoding details."""
    h = hashlib.sha256()
    for rec in leaf_records:
        h.update(str(rec["dtype"]).encode())
        h.update(repr(list(rec["shape"])).encode())
        h.update(rec["data"])
    return h.hexdigest()


def file_sha256(path: str) -> str:
    """SHA-256 of a file's raw bytes (streamed; artifacts can be large)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save(path: str, tree) -> None:
    """Write ``tree`` to ``path`` (atomically, through a ``.tmp`` file)."""
    arrays = [_leaf_array(leaf) for leaf in _flatten(tree)]
    leaf_records = [
        {"dtype": str(a.dtype), "shape": list(a.shape),
         "data": np.ascontiguousarray(a).tobytes()}
        for a in arrays
    ]
    payload = {
        "format_version": FORMAT_VERSION,
        "treedef": treedef_str(tree),
        "structure": describe_structure(tree),
        "checksum": _leaves_sha256(leaf_records),
        "leaves": leaf_records,
    }
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(payload, use_bin_type=True))
    os.replace(tmp, path)


def _read_payload(path: str) -> dict:
    """The decoded payload at ``path``, its version and leaf checksum
    verified."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        payload = msgpack.unpackb(raw, raw=False)
    except Exception as exc:
        raise ValueError(
            f"{path}: corrupt or truncated checkpoint "
            f"(msgpack decode failed: {exc})") from exc
    if not isinstance(payload, dict) or "leaves" not in payload:
        raise ValueError(f"{path}: not a repro checkpoint payload")
    version = payload.get("format_version", 1)
    if version > FORMAT_VERSION:
        raise ValueError(
            f"{path}: checkpoint format version {version} is newer than this "
            f"reader (understands <= {FORMAT_VERSION})")
    stored_sum = payload.get("checksum")
    if stored_sum is not None:
        try:
            actual = _leaves_sha256(payload["leaves"])
        except Exception as exc:
            raise ValueError(
                f"{path}: corrupt or truncated checkpoint "
                f"(malformed leaf records: {exc})") from exc
        if actual != stored_sum:
            raise ValueError(
                f"{path}: corrupt or truncated checkpoint — content "
                f"checksum mismatch (stored {stored_sum[:12]}…, "
                f"recomputed {actual[:12]}…)")
    return payload


def _record_array(rec) -> np.ndarray:
    return np.frombuffer(rec["data"], dtype=np.dtype(rec["dtype"])).reshape(
        rec["shape"])


def restore(path: str, like):
    """Restore into the structure of ``like`` (structure and shapes must
    match); each leaf comes back in the type, dtype and device of ``like``'s.

    Raises ``ValueError`` when the payload's format version is unknown, its
    tree structure differs from ``like``'s, or any leaf shape mismatches.
    Structure is validated against the stored descriptor
    (``describe_structure``); the stored treedef string is diagnostic only.
    """
    payload = _read_payload(path)
    leaves = _flatten(like)
    expected = treedef_str(like)
    stored_treedef = payload.get("treedef")
    treedef_differs = (stored_treedef is not None
                       and stored_treedef != expected)
    hint = (f"\n  stored treedef:   {stored_treedef}"
            f"\n  expected treedef: {expected}" if treedef_differs else "")
    stored_structure = payload.get("structure")
    if (stored_structure is not None
            and stored_structure != describe_structure(like)):
        raise ValueError(
            f"{path}: checkpoint tree structure mismatch\n"
            f"  stored:   {stored_structure}\n"
            f"  expected: {describe_structure(like)}{hint}")
    if len(leaves) != len(payload["leaves"]):
        raise ValueError(
            f"{path}: checkpoint tree structure mismatch — "
            f"{len(payload['leaves'])} stored leaves, expected "
            f"{len(leaves)}{hint}")
    out = []
    for pos, (ref, rec) in enumerate(zip(leaves, payload["leaves"])):
        if _leaf_shape(ref) != list(rec["shape"]):
            kind = "tree structure" if treedef_differs else "leaf shape"
            raise ValueError(
                f"{path}: checkpoint {kind} mismatch — leaf {pos} stored "
                f"{rec['shape']}, expected {_leaf_shape(ref)}{hint}")
        out.append(_leaf_like(ref, _record_array(rec)))
    return _unflatten(like, out)


# --------------------------------------------------------------------------
# Training checkpoints
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainCheckpoint:
    """A loaded training checkpoint (see ``load_train_checkpoint``).

    config:    the ``AFMConfig`` field dict the run was started with, for the
               caller to validate against its own.
    state:     the dense ``AFMState`` at the checkpointed boundary (the
               engine drained, so this is the full in-flight state).
    lat_state: the async backend's latency-stream position, a uint8 CPU
               tensor for ``torch.Generator.set_state`` (JAX's ``lat_key``),
               or ``None`` for backends without one. Restoring it makes an
               exponential-latency resume replay the uninterrupted run.
    cursor:    the sample cursor (whatever the trainer stashed).
    meta:      free-form metadata recorded at save time, with
               ``lat_stream`` naming the kind of latency stream saved.
    checksums: filename -> SHA-256 hexdigest, as stored in the manifest and
               re-verified against the payload files during load.
    """
    config: dict
    state: Any
    lat_state: Any
    cursor: dict
    meta: dict
    checksums: dict


def _replace_dir(tmp: str, path: str) -> None:
    """Atomically promote ``tmp`` to ``path``, displacing an existing
    checkpoint dir: a reader observes either the old complete checkpoint or
    the new one, never a partial write."""
    try:
        os.replace(tmp, path)
        return
    except OSError as exc:
        if exc.errno not in (errno.ENOTEMPTY, errno.EEXIST, errno.ENOTDIR):
            raise
    old = path + ".old"
    shutil.rmtree(old, ignore_errors=True)
    os.replace(path, old)
    os.replace(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def save_train_checkpoint(path: str, *, config: dict, state,
                          cursor: dict, lat_state=None,
                          meta: dict | None = None) -> dict:
    """Write a training checkpoint directory (atomic, overwrite-safe).

    Layout: ``manifest.json`` (format marker, config, cursor, meta, and a
    SHA-256 per payload file) + ``state.msgpack`` (the dense ``AFMState``)
    + ``engine.msgpack`` (``{"lat_key": lat_state}``, the latency
    generator's ``get_state()`` bytes, when given; ``meta["lat_stream"]``
    then says so). Returns the manifest's checksum dict.
    """
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent,
                       f".tmp-{os.path.basename(path)}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    meta = dict(meta or {})
    try:
        save(os.path.join(tmp, _TC_STATE), state)
        files = [_TC_STATE]
        if lat_state is not None:
            lat_state = torch.as_tensor(lat_state)
            if lat_state.dtype != torch.uint8 or lat_state.dim() != 1:
                raise ValueError(
                    f"lat_state must be torch.Generator.get_state() bytes "
                    f"(1-D uint8), got {lat_state.dtype} "
                    f"{tuple(lat_state.shape)}")
            save(os.path.join(tmp, _TC_ENGINE), {"lat_key": lat_state})
            files.append(_TC_ENGINE)
            meta["lat_stream"] = LAT_STREAM_TORCH
        checksums = {f: file_sha256(os.path.join(tmp, f)) for f in files}
        manifest = {
            "format": TRAIN_CKPT_FORMAT,
            "format_version": TRAIN_CKPT_VERSION,
            "config": dict(config),
            "cursor": dict(cursor),
            "meta": meta,
            "checksums": checksums,
        }
        with open(os.path.join(tmp, _TC_MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        _replace_dir(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return checksums


def _load_lat_state(path: str, meta: dict) -> torch.Tensor:
    """The generator state in ``engine.msgpack``; a JAX threefry key (or a
    checkpoint that does not name a generator stream) raises."""
    fpath = os.path.join(path, _TC_ENGINE)
    payload = _read_payload(fpath)
    if (payload.get("structure") != {"dict": {"lat_key": "*"}}
            or len(payload["leaves"]) != 1):
        raise ValueError(f"{fpath}: not a latency-stream payload")
    rec = payload["leaves"][0]
    if (meta.get("lat_stream") != LAT_STREAM_TORCH
            or rec["dtype"] != "uint8" or len(rec["shape"]) != 1):
        raise ValueError(
            f"{path}: the latency stream is a {rec['dtype']} "
            f"{list(rec['shape'])} key (meta lat_stream="
            f"{meta.get('lat_stream')!r}), not torch.Generator state; a JAX "
            f"threefry key cannot seed the port's latency generator — "
            f"resume the run in the package that wrote it")
    return torch.from_numpy(_record_array(rec).copy())


def load_train_checkpoint(path: str, *, state_like,
                          expect_config: dict | None = None
                          ) -> TrainCheckpoint:
    """Load and integrity-check a training checkpoint.

    Every payload file is re-hashed against the manifest's SHA-256 before
    its bytes are trusted; any mismatch (or a missing or undecodable file)
    raises ``ValueError`` naming the corrupt file. ``state_like`` supplies
    the expected ``AFMState`` structure, dtypes and device (e.g.
    ``repro_torch.api.persistence._state_like(cfg, device)``).
    ``expect_config``, when given, must equal the manifest's stored config,
    checked before any payload is decoded.
    """
    manifest_path = os.path.join(path, _TC_MANIFEST)
    if not os.path.isfile(manifest_path):
        raise FileNotFoundError(
            f"{path}: no train checkpoint here ({_TC_MANIFEST} missing)")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except json.JSONDecodeError as exc:
        raise ValueError(
            f"{manifest_path}: corrupt or truncated manifest: {exc}") from exc
    if manifest.get("format") != TRAIN_CKPT_FORMAT:
        raise ValueError(
            f"{path}: not a train checkpoint "
            f"(format={manifest.get('format')!r})")
    version = manifest.get("format_version", 0)
    if version > TRAIN_CKPT_VERSION:
        raise ValueError(
            f"{path}: train checkpoint version {version} is newer than "
            f"this reader (understands <= {TRAIN_CKPT_VERSION})")
    stored_config = dict(manifest.get("config") or {})
    if (expect_config is not None and stored_config
            and stored_config != dict(expect_config)):
        raise ValueError(
            f"{path}: checkpoint config {stored_config} does not match "
            f"the expected config {dict(expect_config)} — resume under "
            f"the same geometry/schedule or start fresh")
    checksums = dict(manifest.get("checksums") or {})
    for fname, want in sorted(checksums.items()):
        fpath = os.path.join(path, fname)
        if not os.path.isfile(fpath):
            raise ValueError(
                f"{path}: corrupt or truncated checkpoint — payload file "
                f"{fname!r} is missing")
        got = file_sha256(fpath)
        if got != want:
            raise ValueError(
                f"{path}: corrupt or truncated checkpoint — {fname} "
                f"checksum mismatch (manifest {want[:12]}…, "
                f"file {got[:12]}…)")
    meta = dict(manifest.get("meta") or {})
    state = restore(os.path.join(path, _TC_STATE), state_like)
    lat_state = (_load_lat_state(path, meta) if _TC_ENGINE in checksums
                 else None)
    return TrainCheckpoint(config=stored_config, state=state,
                           lat_state=lat_state,
                           cursor=dict(manifest.get("cursor") or {}),
                           meta=meta, checksums=checksums)
