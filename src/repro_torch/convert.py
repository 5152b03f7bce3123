"""Carry a store or parameters built elsewhere (e.g. by the JAX package)
into the port.

The arguments are numpy arrays: the ``TripleStore`` / ``RelaxTable``
fields (the sketch as uint32 words), or a two-tower parameter tree. The
results are the port's types on ``device``, so both packages then read the
very same data.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import kg
from repro_torch.core.types import TripleStore, RelaxTable, resolve_device
from repro_torch.models import recsys


def store_from_numpy(keys, scores, lengths, sorted_keys, stats, sketch,
                     device=None) -> TripleStore:
    sketch = np.asarray(sketch)
    if sketch.dtype != np.uint32:
        raise ValueError(f"sketch must be uint32 words, got {sketch.dtype}")
    return kg.store_from_arrays(
        dict(keys=np.asarray(keys), scores=np.asarray(scores),
             lengths=np.asarray(lengths), sorted_keys=np.asarray(sorted_keys),
             stats=np.asarray(stats), sketch=sketch),
        resolve_device(device))


def relax_from_numpy(ids, weights, device=None) -> RelaxTable:
    dev = resolve_device(device)
    return RelaxTable(
        ids=torch.from_numpy(np.array(ids, dtype=np.int32)).to(dev),
        weights=torch.from_numpy(np.array(weights, dtype=np.float32)).to(dev))


def two_tower_from_numpy(values, cfg: recsys.TwoTowerConfig,
                         device=None) -> recsys.TwoTower:
    """``values`` is ``{"user": {"table", "w0", …}, "item": {…}}`` of
    arrays (the reference's ``recsys.init(...)[0]``)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    def tower(v):
        n = len(cfg.tower_mlp)
        if set(v) != {"table"} | {f"w{i}" for i in range(n)}:
            raise ValueError(f"tower keys {sorted(v)} do not match a "
                             f"{n}-layer MLP")
        return recsys.Tower(f32(v["table"]), [f32(v[f"w{i}"])
                                              for i in range(n)])

    return recsys.TwoTower(cfg, tower(values["user"]), tower(values["item"]))
