"""The model's weights, made on the device from ``--seed``.

A model family's reference module (``gpubench/reference/<family>.py``,
named by the configuration file's ``reference``) names every weight of
its model: ``groups(model)`` the groups in order (the embedding, each
layer, ...), ``layer_leaves(model, group)`` each group's leaves under the
program's parameter names, with shape, dtype and the standard deviation
they are drawn at. The specs come from the configuration's sizes, not
from the program, and the harness checks them against the program's
parameters before it fills them.

The weights are drawn a group at a time: one ``randn`` a group and dtype,
on a generator of the card seeded from (seed, group), so any group can be
made again on its own. The reference makes them again, group by group,
from the same seed.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from gpubench.inputs import mix64

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple
    dtype: torch.dtype
    std: float            # 0: a zero-initialised norm scale


def leaf_specs(family, model: dict) -> list[Leaf]:
    return [leaf for g in family.groups(model)
            for leaf in family.layer_leaves(model, g)]


def make_group(family, model: dict, group: str, seed: int, device) -> dict:
    """``{name: tensor}`` of one group, drawn on ``device`` from ``seed``."""
    leaves = family.layer_leaves(model, group)
    g = torch.Generator(device=device)
    g.manual_seed(mix64(seed, 0x57454947, family.groups(model).index(group)))
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        drawn = [leaf for leaf in leaves if leaf.dtype == dt and leaf.std]
        total = sum(math.prod(leaf.shape) for leaf in drawn)
        if not total:
            continue
        flat = torch.randn(total, generator=g, device=device, dtype=dt)
        off = 0
        for leaf in drawn:
            n = math.prod(leaf.shape)
            out[leaf.name] = flat[off:off + n].view(leaf.shape).mul_(leaf.std)
            off += n
    for leaf in leaves:
        if not leaf.std:
            out[leaf.name] = torch.zeros(leaf.shape, dtype=leaf.dtype,
                                         device=device)
    return out


def all_groups(family, model: dict, seed: int, device):
    """Every group's ``{name: tensor}`` in turn, made anew from ``seed``."""
    for group in family.groups(model):
        yield make_group(family, model, group, seed, device)


def check_matches(family, model: dict, named_parameters: dict) -> None:
    """Raises unless the program's parameters are exactly ``leaf_specs``'
    names, shapes and dtypes."""
    specs = {leaf.name: leaf for leaf in leaf_specs(family, model)}
    if set(specs) != set(named_parameters):
        raise RuntimeError(
            f"the program's parameters differ from the benchmark's: only the "
            f"program has {sorted(set(named_parameters) - set(specs))[:8]}, "
            f"only the benchmark {sorted(set(specs) - set(named_parameters))[:8]}")
    for name, p in named_parameters.items():
        leaf = specs[name]
        if tuple(p.shape) != leaf.shape or p.dtype != leaf.dtype:
            raise RuntimeError(f"{name}: the program holds {tuple(p.shape)} "
                               f"{p.dtype}, the benchmark {leaf.shape} "
                               f"{leaf.dtype}")


@torch.no_grad()
def fill(family, model: dict, named_parameters: dict, seed: int) -> None:
    """Writes the seeded weights into the program's parameters by name."""
    check_matches(family, model, named_parameters)
    device = next(iter(named_parameters.values())).device
    for group in all_groups(family, model, seed, device):
        for name, t in group.items():
            named_parameters[name].copy_(t)
