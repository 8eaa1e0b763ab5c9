"""Deterministic synthetic datasets with the paper's Table 1 shapes, a
PyTorch copy of ``repro.data.synthetic``'s class-mixture stand-in.

Each class is a mixture of ``modes_per_class`` anisotropic Gaussians on a
random low-dimensional manifold, squashed to [0, 1]. Nothing is downloaded.
The seed is ``zlib.crc32(name) + seed``, stable across processes (Python's
``hash`` of a string is salted per process). The numbers are not the JAX
package's: the two generators differ, so no test compares datasets across
the packages.

``repro_torch.data.idx`` overrides these with the real files where they
exist under ``$REPRO_DATA_DIR``.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.data import idx
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    classes: int
    features: int
    train: int
    test: int


# Paper Table 1.
DATASETS = {
    "mnist": DatasetSpec("mnist", 10, 784, 59_999, 10_000),
    "fmnist": DatasetSpec("fmnist", 10, 784, 59_999, 10_000),
    "letters": DatasetSpec("letters", 26, 16, 15_000, 5_000),
    "satimage": DatasetSpec("satimage", 6, 36, 4_435, 2_000),
}


def _class_mixture(gen: torch.Generator, n: int, spec: DatasetSpec,
                   modes_per_class: int = 3, manifold_dim: int | None = None):
    """Sample n points: pick class, pick mode, draw Gaussian on a manifold."""
    manifold_dim = manifold_dim or max(4, spec.features // 8)
    m = spec.classes * modes_per_class
    proj = (torch.randn(manifold_dim, spec.features, generator=gen)
            / manifold_dim ** 0.5)
    mu = 2.0 * torch.randn(m, manifold_dim, generator=gen)
    scale = 0.25 + 0.5 * torch.rand(m, manifold_dim, generator=gen)
    cls = torch.randint(0, spec.classes, (n,), generator=gen)
    mode = cls * modes_per_class + torch.randint(0, modes_per_class, (n,),
                                                 generator=gen)
    z = mu[mode] + scale[mode] * torch.randn(n, manifold_dim, generator=gen)
    return torch.sigmoid(z @ proj), cls.to(torch.int32)


def make_dataset(name: str, seed: int = 0, train_size: int | None = None,
                 test_size: int | None = None, real_data_ok: bool = True,
                 device: torch.device | str | None = None):
    """Returns (x_train, y_train, x_test, y_test) on ``device`` (CUDA unless
    asked otherwise): the real files when ``real_data_ok`` and
    ``repro_torch.data.idx`` finds them, else the stand-in, generated on
    the CPU so that every device gets the same numbers. Sizes may be cut
    with ``train_size`` / ``test_size``."""
    spec = DATASETS[name]
    device = resolve_device(device)
    if real_data_ok:
        real = idx.try_load(name)
        if real is not None:
            xtr, ytr, xte, yte = (torch.from_numpy(np.ascontiguousarray(a))
                                  .to(device) for a in real)
            if train_size:
                xtr, ytr = xtr[:train_size], ytr[:train_size]
            if test_size:
                xte, yte = xte[:test_size], yte[:test_size]
            return xtr, ytr, xte, yte
    n_tr = train_size or spec.train
    n_te = test_size or spec.test
    gen = torch.Generator().manual_seed(zlib.crc32(name.encode()) + seed)
    x, y = _class_mixture(gen, n_tr + n_te, spec)
    x, y = x.to(device), y.to(device)
    return x[:n_tr], y[:n_tr], x[n_tr:], y[n_tr:]
