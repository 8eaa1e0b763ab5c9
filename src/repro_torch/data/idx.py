"""IDX (MNIST-format) loader, port of ``repro.data.idx``: used automatically
by ``make_dataset`` when real data is present. It reads local files only;
nothing is downloaded.

Set ``REPRO_DATA_DIR`` to a directory containing the standard files, e.g.::

    $REPRO_DATA_DIR/mnist/train-images-idx3-ubyte[.gz]
    $REPRO_DATA_DIR/mnist/train-labels-idx1-ubyte[.gz]
    $REPRO_DATA_DIR/mnist/t10k-images-idx3-ubyte[.gz]
    $REPRO_DATA_DIR/mnist/t10k-labels-idx1-ubyte[.gz]

Letters/SatImage additionally accept simple CSV (label first column).
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dtype = np.dtype({0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                          0x0C: np.int32, 0x0D: np.float32,
                          0x0E: np.float64}[(magic >> 8) & 0xFF])
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        # a dtype instance: numpy 2 has no ``newbyteorder`` on scalar types
        return np.frombuffer(f.read(),
                             dtype=dtype.newbyteorder(">")).reshape(shape)


def _find(dirpath: str, stem: str) -> str | None:
    for suffix in ("", ".gz"):
        p = os.path.join(dirpath, stem + suffix)
        if os.path.exists(p):
            return p
    return None


def try_load(name: str):
    """Returns (x_train, y_train, x_test, y_test) float32/int32 or None."""
    root = os.environ.get("REPRO_DATA_DIR")
    if not root:
        return None
    d = os.path.join(root, name)
    if not os.path.isdir(d):
        return None
    tri = _find(d, "train-images-idx3-ubyte")
    trl = _find(d, "train-labels-idx1-ubyte")
    tei = _find(d, "t10k-images-idx3-ubyte")
    tel = _find(d, "t10k-labels-idx1-ubyte")
    if all([tri, trl, tei, tel]):
        xtr = _read_idx(tri).reshape(-1, 784).astype(np.float32) / 255.0
        xte = _read_idx(tei).reshape(-1, 784).astype(np.float32) / 255.0
        ytr = _read_idx(trl).astype(np.int32)
        yte = _read_idx(tel).astype(np.int32)
        return xtr, ytr, xte, yte
    # CSV fallback (letters / satimage style): label,feat0,feat1,...
    trc = _find(d, "train.csv")
    tec = _find(d, "test.csv")
    if trc and tec:
        tr = np.loadtxt(trc, delimiter=",", dtype=np.float32)
        te = np.loadtxt(tec, delimiter=",", dtype=np.float32)
        return (tr[:, 1:], tr[:, 0].astype(np.int32),
                te[:, 1:], te[:, 0].astype(np.int32))
    return None
