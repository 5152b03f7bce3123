"""Bitmap key signatures: the host (ingest) half of ``repro.core.sketches``.

Every pattern gets ``LANES`` independent bitmap lanes of ``W`` uint32 words;
a key sets one bit per lane (a splitmix64 mix keyed by the lane seed). The
arithmetic is numpy on the host, bit for bit that of the JAX package, so a
store built here carries the very same signature words.

The device half (union/intersection estimates, ``cardinality_mode=
"sketch"``) is not ported yet.
"""
from __future__ import annotations

import numpy as np

SKETCH_LANES = 4
SKETCH_WORDS = 1024
MIN_WORDS = 128
MAX_WORDS = 16384


def adaptive_words(max_len: int) -> int:
    """Signature width (uint32 words per lane): 2·Lmax rounded up to a power
    of two, clamped to [MIN_WORDS, MAX_WORDS]."""
    words = 2 * max(int(max_len), 1)
    words = 1 << max(words - 1, 1).bit_length()    # round up to pow2
    return int(min(max(words, MIN_WORDS), MAX_WORDS))


def _mix64(x: np.ndarray, seed: int) -> np.ndarray:
    """splitmix64 finalizer (vectorized, uint64 wraparound)."""
    z = x.astype(np.uint64) + np.uint64(seed)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _lane_seed(lane: int) -> int:
    return (0x9E3779B97F4A7C15 * (lane + 1)) & 0xFFFFFFFFFFFFFFFF


def build_sketches(key_lists: list[np.ndarray],
                   lanes: int = SKETCH_LANES,
                   words: int = SKETCH_WORDS) -> np.ndarray:
    """Host-side ingest: (P, lanes, words) uint32 signatures of the key sets."""
    m = 32 * words
    out = np.zeros((len(key_lists), lanes, words), dtype=np.uint32)
    for p, keys in enumerate(key_lists):
        k = np.asarray(keys, np.uint64)
        if k.size == 0:
            continue
        for lane in range(lanes):
            bit = (_mix64(k, _lane_seed(lane)) % np.uint64(m)).astype(np.int64)
            word, off = bit >> 5, (bit & 31).astype(np.uint32)
            np.bitwise_or.at(out[p, lane], word, np.uint32(1) << off)
    return out
