"""Bitmap key signatures: counterpart of ``repro.core.sketches``.

Every pattern gets ``LANES`` independent bitmap lanes of ``W`` uint32 words;
a key sets one bit per lane (a splitmix64 mix keyed by the lane seed). The
ingest half is numpy on the host, bit for bit that of the JAX package, so a
store built here carries the very same signature words.

The device half answers the planner's cardinality questions in O(T·R·W)
bitwise work per query, independent of the list length L
(``cardinality_mode="sketch"``): AND the signatures and invert the AND-fill
occupancy model by bisection for intersections, linear counting over OR'd
signatures for source unions. An empty AND lane proves an intersection
empty, and the estimate is then exactly 0. Every function takes a batch of
queries, ``pattern_ids`` (Q, T), where the JAX functions take one query
and are vmapped. The store holds the words as an int32 view: ``&`` and
``|`` work on it directly, and popcounts go through an int64 view.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import TripleStore, RelaxTable, PAD_KEY, safe_ids

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


# ---------------------------------------------------------------------------
# Device half: estimates batched over (Q, T) queries.
# ---------------------------------------------------------------------------

# Signature words ANDed and counted at once: the popcount's int64
# temporaries (a few of 8 bytes a word) then stay near 1 GiB.
CHUNK_WORDS = 1 << 25


def _popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint32 word held as int32 → int64 (SWAR), on an
    int64 view masked to 32 bits: on int32, ``>>`` shifts the sign bit in."""
    v = words.long() & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _lane_popcounts(bitmaps: torch.Tensor) -> torch.Tensor:
    """(..., LANES, W) int32 words → (..., LANES) f32 set-bit counts."""
    return _popcount(bitmaps).sum(-1).float()


def _fold_rows(bitmaps: torch.Tensor, valid: torch.Tensor, op, empty: int):
    """``op`` (AND or OR) over the valid rows of (..., S, LANES, W); an
    invalid row counts as ``empty`` (all ones for AND, zeros for OR)."""
    out = None
    for s in range(bitmaps.shape[-3]):
        row = torch.where(valid[..., s, None, None], bitmaps[..., s, :, :],
                          empty)
        out = row if out is None else op(out, row)
    return out


def _linear_count(lane_pop: torch.Tensor, m: float) -> torch.Tensor:
    """Linear-counting size estimate from (..., LANES) OR fills → (...)
    f64 (see ``_invert_and_fill`` for why not f32)."""
    fill = (lane_pop.double() / m).clamp(0.0, 1.0 - 1.0 / m)
    return (-m * torch.log1p(-fill)).mean(-1)


def _invert_and_fill(lane_pop: torch.Tensor, sizes: torch.Tensor,
                     valid: torch.Tensor, m: float,
                     iters: int = 26) -> torch.Tensor:
    """Invert the AND-fill model by bisection, every estimate at once.

    lane_pop (..., LANES) popcounts of the AND; sizes, valid (..., T).
    A bit survives the AND of sets of sizes n_t sharing x keys with
    probability (1 - e^{-x/m}) + e^{-x/m} · Π_t (1 - e^{-(n_t - x)/m}).
    Exactly 0 where a lane's AND is empty (that proves the intersection
    empty); the exact size with one valid row, 0 with none. Returns f32,
    as the reference does, but computes in f64: in f32, ``1 - e^{-x/m}``
    resolves x only to about ulp(1)·m keys (0.03 at W = 16384), so two
    devices' ``exp`` could send the bisection apart by that much.
    """
    lane_pop, sizes = lane_pop.double(), sizes.double()
    y = lane_pop.mean(-1) / m
    provably_empty = (lane_pop == 0.0).any(-1)
    sizes = torch.where(valid, sizes, 0.0)
    n_valid = valid.sum(-1)
    hi = torch.where(valid, sizes, float("inf")).amin(-1)
    hi = torch.where(torch.isfinite(hi), hi, 0.0)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        u = torch.exp(-mid / m)
        a = 1.0 - torch.exp(-(sizes - mid[..., None]).clamp(min=0.0) / m)
        pred = (1.0 - u) + u * torch.where(valid, a, 1.0).prod(-1)
        below = pred < y
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    est = 0.5 * (lo + hi)
    est = torch.where(n_valid <= 1, sizes.sum(-1), est)
    return torch.where(provably_empty, 0.0, est.clamp(min=0.0)).float()


def union_size(bitmaps: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Linear-counting estimate of |∪_s S_s| from OR'd signatures:
    bitmaps (..., S, LANES, W) int32, valid (..., S) bool → (...) f32."""
    m = 32.0 * bitmaps.shape[-1]
    return _linear_count(
        _lane_popcounts(_fold_rows(bitmaps, valid, torch.bitwise_or, 0)),
        m).float()


def intersection_size(bitmaps: torch.Tensor, sizes: torch.Tensor,
                      valid: torch.Tensor, iters: int = 26) -> torch.Tensor:
    """Estimate |∩_t S_t| over the valid rows by inverting the AND-fill
    model: bitmaps (..., T, LANES, W) int32, sizes (..., T) (exact where
    known), valid (..., T) bool → (...) f32 ≥ 0."""
    m = 32.0 * bitmaps.shape[-1]
    anded = _fold_rows(bitmaps, valid, torch.bitwise_and, -1)
    return _invert_and_fill(_lane_popcounts(anded), sizes, valid, m, iters)


def _relaxed_estimates(rows: torch.Tensor, row_sizes: torch.Tensor,
                       active: torch.Tensor, store: TripleStore,
                       rid: torch.Tensor) -> torch.Tensor:
    """(Q, T, R) estimates of |S'_{t,r} ∩ ⋂_{u≠t active} rows_u|.

    ``rows`` (Q, T, LANES, W) and ``row_sizes`` (Q, T) are each pattern's
    side of the intersection; ``rid`` (Q, T, R) the relaxations, whose
    signatures replace row t. The AND of the other active rows is formed
    once per t (prefix and suffix ANDs), then ANDed with each relaxation's
    signature, in chunks of queries of at most ``CHUNK_WORDS`` words. 0
    where the slot is padding.
    """
    Q, T = active.shape
    R = rid.shape[-1]
    lanes, W = rows.shape[-2:]
    masked = torch.where(active[..., None, None], rows, -1)
    prefix = [torch.full_like(masked[:, 0], -1)]
    for t in range(T - 1):
        prefix.append(prefix[-1] & masked[:, t])
    suffix = [prefix[0]]
    for t in range(T - 1, 0, -1):
        suffix.append(suffix[-1] & masked[:, t])
    others = torch.stack([p & s for p, s in zip(prefix, suffix[::-1])], 1)

    srid = safe_ids(rid)
    step = max(1, CHUNK_WORDS // max(T * R * lanes * W, 1))
    pops = torch.cat([
        _lane_popcounts(store.sketch[srid[q:q + step]]
                        & others[q:q + step, :, None])
        for q in range(0, Q, step)])                      # (Q, T, R, LANES)

    onehot = torch.eye(T, dtype=torch.bool, device=rid.device)[:, None]
    valid = (active[:, None, None] | onehot).expand(Q, T, R, T)
    sizes = torch.where(onehot, store.lengths[srid].double()[..., None],
                        row_sizes[:, None, None].double())  # (Q, T, R, T)
    est = _invert_and_fill(pops, sizes, valid, 32.0 * W)
    return torch.where(rid != PAD_KEY, est, 0.0)


def sketch_cardinalities(store: TripleStore, relax: RelaxTable,
                         pattern_ids: torch.Tensor, active: torch.Tensor):
    """Sketched drop-in for ``estimator.exact_cardinalities``: (n (Q,),
    n_rel (Q, T, R)) join cardinality estimates of the queries and of each
    one-relaxation rewrite (0 where the slot is padding)."""
    safe = safe_ids(pattern_ids)
    sk = store.sketch[safe]                               # (Q, T, LANES, W)
    sizes = store.lengths[safe].float()
    n = intersection_size(sk, sizes, active)
    return n, _relaxed_estimates(sk, sizes, active, store,
                                 relax.ids[safe].long())


def sketch_joinable_counts(store: TripleStore, relax: RelaxTable,
                           pattern_ids: torch.Tensor,
                           active: torch.Tensor) -> torch.Tensor:
    """Sketched drop-in for ``estimator.joinable_counts`` — (Q, T, R) f32.

    Per relaxation, the estimated number of its keys that join every other
    active pattern's source union (original ∪ relaxations). Exactly 0 when
    the sketch proves the count 0; otherwise the raw estimate, which can
    carry a sub-key collision residue: planners gate through
    ``round_joinability``.
    """
    safe = safe_ids(pattern_ids)
    rid = relax.ids[safe].long()                          # (Q, T, R)
    union = store.sketch[safe]
    for r in range(rid.shape[-1]):
        union = union | torch.where((rid[..., r] != PAD_KEY)[..., None, None],
                                    store.sketch[safe_ids(rid[..., r])], 0)
    union_sz = _linear_count(_lane_popcounts(union),
                             32.0 * union.shape[-1])
    return _relaxed_estimates(union, union_sz, active, store, rid)


def round_joinability(est: torch.Tensor) -> torch.Tensor:
    """Zero sub-half-key joinability estimates (the planner gates on
    ``> 0``): a bounded approximation of the exact dead-relaxation prune,
    lossy only at the 0-vs-1-key knife edge."""
    return torch.where(est < 0.5, 0.0, est)
