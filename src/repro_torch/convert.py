"""Carry a store built elsewhere (e.g. by the JAX package) into the port.

The arguments are the ``TripleStore`` / ``RelaxTable`` fields as numpy
arrays, the sketch as uint32 words; the results are the port's types on
``device``. Both engines then read the very same store.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import kg
from repro_torch.core.types import TripleStore, RelaxTable, resolve_device


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

