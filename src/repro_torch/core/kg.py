"""Knowledge-graph ingest: build a TripleStore + RelaxTable from host data.

Host-side numpy, as in ``repro.core.kg`` (the "database load" phase); the
result is moved once to the device every entry point runs on. For the same
inputs every array is bit-equal to the JAX store.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import sketches as sketchlib
from repro_torch.core.types import (TripleStore, RelaxTable, PAD_KEY,
                                    KEY_SENTINEL, resolve_device)


def compute_pattern_stats(scores: np.ndarray, length: int) -> np.ndarray:
    """The paper's four statistics (m, sigma_r, S_r, S_m) for one pattern.

    ``scores`` must be sorted descending and normalized to [0, 1]; r is the
    smallest rank whose cumulative score mass reaches 80 % of the total.
    """
    m = float(length)
    if length == 0:
        return np.array([0.0, 0.5, 0.0, 0.0], dtype=np.float32)
    s = scores[:length].astype(np.float64)
    total = float(s.sum())
    if total <= 0.0:
        return np.array([m, 0.5, 0.0, 0.0], dtype=np.float32)
    cum = np.cumsum(s)
    r = int(np.searchsorted(cum, 0.8 * total, side="left"))
    r = min(r, length - 1)
    sigma_r = min(max(float(s[r]), 1e-4), 1.0 - 1e-4)
    S_r = float(cum[r])
    return np.array([m, sigma_r, S_r, total], dtype=np.float32)


def build_store_arrays(pattern_lists: list[tuple[np.ndarray, np.ndarray]],
                       list_len: int | None = None,
                       normalize: bool = True,
                       sketch_lanes: int = sketchlib.SKETCH_LANES,
                       sketch_words: int | None = None) -> dict:
    """The store's host arrays (numpy; sketch as uint32), keyed by field."""
    P = len(pattern_lists)
    if list_len is None:
        list_len = max((len(k) for k, _ in pattern_lists), default=1)
        list_len = max(list_len, 1)
    keys = np.full((P, list_len), PAD_KEY, dtype=np.int32)
    scores = np.zeros((P, list_len), dtype=np.float32)
    sorted_keys = np.full((P, list_len), KEY_SENTINEL, dtype=np.int32)
    lengths = np.zeros((P,), dtype=np.int32)
    stats = np.zeros((P, 4), dtype=np.float32)

    for p, (k, s) in enumerate(pattern_lists):
        k = np.asarray(k, dtype=np.int32)
        s = np.asarray(s, dtype=np.float64)
        if len(k) != len(s) or len(k) > list_len:
            raise ValueError(f"pattern {p}: {len(k)} keys, {len(s)} scores, "
                             f"list_len {list_len}")
        if len(np.unique(k)) != len(k):
            raise ValueError(f"pattern {p}: keys must be unique within a list")
        n = len(k)
        lengths[p] = n
        if n:
            mx = s.max() if normalize else 1.0
            sn = (s / mx if mx > 0 else s).astype(np.float32)
            order = np.argsort(-sn, kind="stable")
            keys[p, :n] = k[order]
            scores[p, :n] = sn[order]
            sorted_keys[p, :n] = np.sort(k)
        stats[p] = compute_pattern_stats(scores[p], n)

    if sketch_words is None:
        sketch_words = sketchlib.adaptive_words(
            max((len(k) for k, _ in pattern_lists), default=1))
    sketch = sketchlib.build_sketches([k for k, _ in pattern_lists],
                                      lanes=sketch_lanes, words=sketch_words)
    return dict(keys=keys, scores=scores, lengths=lengths,
                sorted_keys=sorted_keys, stats=stats, sketch=sketch)


def store_from_arrays(arrays: dict, device) -> TripleStore:
    """TripleStore on ``device`` from host arrays (sketch given as uint32).

    The arrays are copied, so read-only inputs are fine.
    """
    dev = torch.device(device)

    def t(name, dtype):
        return torch.from_numpy(np.array(arrays[name], dtype=dtype)).to(dev)

    sketch = np.array(arrays["sketch"], dtype=np.uint32).view(np.int32)
    return TripleStore(
        keys=t("keys", np.int32), scores=t("scores", np.float32),
        lengths=t("lengths", np.int32),
        sorted_keys=t("sorted_keys", np.int32),
        stats=t("stats", np.float32), sketch=torch.from_numpy(sketch).to(dev))


def build_store(pattern_lists: list[tuple[np.ndarray, np.ndarray]],
                list_len: int | None = None,
                normalize: bool = True,
                sketch_lanes: int = sketchlib.SKETCH_LANES,
                sketch_words: int | None = None,
                device=None) -> TripleStore:
    """Build a TripleStore from per-pattern (keys, raw_scores) host arrays.

    Scores are normalized per Definition 5 (divide by the list max) unless
    ``normalize=False``; lists are sorted by score desc and padded to a
    common length; bitmap signatures are built once here.
    """
    dev = resolve_device(device)
    return store_from_arrays(
        build_store_arrays(pattern_lists, list_len, normalize, sketch_lanes,
                           sketch_words), dev)


def build_relax_table(P: int,
                      rules: dict[int, list[tuple[int, float]]],
                      max_relax: int | None = None,
                      device=None) -> RelaxTable:
    """Build a RelaxTable from {pattern: [(relaxed_pattern, weight), ...]},
    relaxations sorted by weight descending."""
    dev = resolve_device(device)
    if max_relax is None:
        max_relax = max((len(v) for v in rules.values()), default=1)
        max_relax = max(max_relax, 1)
    ids = np.full((P, max_relax), PAD_KEY, dtype=np.int32)
    weights = np.zeros((P, max_relax), dtype=np.float32)
    for p, rl in rules.items():
        rl = sorted(rl, key=lambda t: -t[1])[:max_relax]
        for j, (q2, w) in enumerate(rl):
            if not 0.0 <= w <= 1.0:
                raise ValueError(f"relaxation weight {w} outside [0, 1]")
            ids[p, j] = q2
            weights[p, j] = w
    return RelaxTable(ids=torch.from_numpy(ids).to(dev),
                      weights=torch.from_numpy(weights).to(dev))
