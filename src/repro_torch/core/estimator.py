"""Expected-score estimator (§3.1): join cardinalities + order statistics.

Counterpart of ``repro.core.estimator``. Cardinalities come in two
flavours behind ``cardinality_mode``: ``"exact"`` join selectivities,
computed with batched binary searches (``torch.searchsorted``) over the
key-sorted copies in the store (cost grows with L), and ``"sketch"``
estimates from the bitmap signatures (``sketches``; O(W) per probe,
independent of L). Every function takes a batch of queries,
``pattern_ids`` (Q, T), where the JAX functions take one query and are
vmapped.
"""
from __future__ import annotations

import torch

from repro_torch.core import histogram, sketches
from repro_torch.core.types import (TripleStore, RelaxTable, PAD_KEY,
                                    KEY_SENTINEL)
from repro_torch.core.types import safe_ids as _safe


def member(sorted_keys: torch.Tensor, probes: torch.Tensor) -> torch.Tensor:
    """probes (Q, N) ∈ sorted_keys (Q, L) (ascending, KEY_SENTINEL padded)."""
    idx = torch.searchsorted(sorted_keys, probes, side="left")
    idx = idx.clamp(0, sorted_keys.shape[-1] - 1)
    found = sorted_keys.gather(-1, idx) == probes
    return found & (probes != PAD_KEY) & (probes != KEY_SENTINEL)


def star_join_cardinality(store: TripleStore, pattern_ids: torch.Tensor,
                          active: torch.Tensor) -> torch.Tensor:
    """|∩_t keys(q_t)| over the active patterns of (Q, T) star queries →
    (Q,) f32."""
    pids = _safe(pattern_ids)
    base = store.keys[pids[:, 0]]                         # (Q, L)
    mask = base != PAD_KEY
    for t in range(1, pids.shape[1]):
        m = member(store.sorted_keys[pids[:, t]], base)
        mask = torch.where(active[:, t, None], mask & m, mask)
    mask = mask & active[:, :1]
    return mask.float().sum(-1)


def _relax_bases(store, relax, safe_ids):
    """Each relaxation's key list: (Q, T, R, L), with its slot's PAD mask."""
    rid = relax.ids[safe_ids].long()                      # (Q, T, R)
    return rid, store.keys[_safe(rid)]


def exact_cardinalities(store: TripleStore, relax: RelaxTable,
                        pattern_ids: torch.Tensor, active: torch.Tensor):
    """(n (Q,), n_rel (Q, T, R)) — original and per-relaxation star-join
    cardinalities; ``n_rel[q, t, r]`` replaces pattern t by its r-th
    relaxation (0 where the slot is padding)."""
    safe_ids = _safe(pattern_ids)
    Q, T = safe_ids.shape
    n = star_join_cardinality(store, safe_ids, active)
    rid, base = _relax_bases(store, relax, safe_ids)
    flat = base.reshape(Q, -1)                            # (Q, T·R·L)
    mask = base != PAD_KEY
    t_idx = torch.arange(T, device=base.device)[None, :, None, None]
    for u in range(T):
        m = member(store.sorted_keys[safe_ids[:, u]], flat).view(base.shape)
        skip = (t_idx == u) | ~active[:, u, None, None, None]
        mask = torch.where(skip, mask, mask & m)
    n_rel = torch.where(rid != PAD_KEY, mask.float().sum(-1), 0.0)
    return n, n_rel


def joinable_counts(store: TripleStore, relax: RelaxTable,
                    pattern_ids: torch.Tensor,
                    active: torch.Tensor) -> torch.Tensor:
    """(Q, T, R) f32 — per relaxation, how many of its keys match every other
    active pattern on the union of that pattern's sources. Zero proves the
    relaxation cannot contribute to any answer."""
    safe_ids = _safe(pattern_ids)
    Q, T = safe_ids.shape
    rid, base = _relax_bases(store, relax, safe_ids)
    flat = base.reshape(Q, -1)
    srcs = torch.cat([safe_ids[..., None], _safe(rid)], -1)  # (Q, T, R+1)
    src_ok = torch.cat([torch.ones_like(rid[..., :1], dtype=torch.bool),
                        rid != PAD_KEY], -1)
    mask = base != PAD_KEY
    t_idx = torch.arange(T, device=base.device)[None, :, None, None]
    for u in range(T):
        in_union = torch.zeros_like(mask)
        for s in range(srcs.shape[-1]):
            m = member(store.sorted_keys[srcs[:, u, s]], flat).view(base.shape)
            in_union |= m & src_ok[:, u, s, None, None, None]
        skip = (t_idx == u) | ~active[:, u, None, None, None]
        mask = torch.where(skip, mask, mask & in_union)
    return torch.where(rid != PAD_KEY, mask.float().sum(-1), 0.0)


def cardinalities(store, relax, pattern_ids, active, mode: str = "exact"):
    """(n, n_rel) join cardinalities under ``mode`` ∈ {"exact", "sketch"}."""
    if mode == "exact":
        return exact_cardinalities(store, relax, pattern_ids, active)
    if mode == "sketch":
        return sketches.sketch_cardinalities(store, relax, pattern_ids,
                                             active)
    raise ValueError(f"unknown cardinality_mode: {mode!r}")


def joinability(store, relax, pattern_ids, active, mode: str = "exact"):
    """(Q, T, R) joinable-key counts under ``mode`` ∈ {"exact", "sketch"};
    the sketch flavour's positives are estimates (see
    ``sketches.round_joinability``)."""
    if mode == "exact":
        return joinable_counts(store, relax, pattern_ids, active)
    if mode == "sketch":
        return sketches.sketch_joinable_counts(store, relax, pattern_ids,
                                               active)
    raise ValueError(f"unknown cardinality_mode: {mode!r}")


def leave_one_out_pmfs(pmfs: torch.Tensor, active: torch.Tensor
                       ) -> torch.Tensor:
    """loo[..., t, :] = convolution of every active pattern pmf except t,
    from prefix/suffix convolutions. (..., T, G+1) → (..., T, T*G+1)."""
    T, G1 = pmfs.shape[-2:]
    out_len = T * (G1 - 1) + 1

    def scan(order):
        acc = histogram._delta(pmfs.shape[:-2], out_len, pmfs.device)
        before = {}
        for t in order:
            before[t] = acc      # acc BEFORE folding in pattern t
            acc = torch.where(active[..., t, None],
                              histogram.conv_truncate(acc, pmfs[..., t, :],
                                                      out_len), acc)
        return torch.stack([before[t] for t in range(T)], -2)

    prefix = scan(range(T))
    suffix = scan(reversed(range(T)))
    return histogram.conv_truncate(prefix, suffix, out_len)


def score_estimates_from_cards(stats_table: torch.Tensor, relax: RelaxTable,
                               pattern_ids: torch.Tensor,
                               active: torch.Tensor, n: torch.Tensor,
                               n_rel: torch.Tensor, k: int, G: int):
    """E_Q(k) (Q,) and per-relaxation E_Q'(1) (Q, T, R) from cardinalities;
    ``e_q1`` is -inf where the slot is padding or the pattern inactive."""
    safe_ids = _safe(pattern_ids)
    stats = stats_table[safe_ids]                          # (Q, T, 4)
    pmfs = histogram.pattern_pmf(stats, 1.0, G)            # (Q, T, G+1)
    pmf_q = histogram.convolve_pmfs(pmfs, active)
    e_qk = histogram.expected_order_statistic(pmf_q, n, float(k), G)

    loo = leave_one_out_pmfs(pmfs, active)                 # (Q, T, T*G+1)
    out_len = loo.shape[-1]
    rid = relax.ids[safe_ids].long()                       # (Q, T, R)
    w = relax.weights[safe_ids]
    relaxed_pmf = histogram.pattern_pmf(stats_table[_safe(rid)], w, G)
    pmf_qr = histogram.conv_truncate(loo[..., None, :], relaxed_pmf, out_len)
    pmf_qr = pmf_qr / pmf_qr.sum(-1, keepdim=True).clamp(min=1e-30)
    e1 = histogram.expected_order_statistic(pmf_qr, n_rel, 1.0, G)
    usable = (rid != PAD_KEY) & active[..., None]
    return e_qk, torch.where(usable, e1, float("-inf"))


def query_score_estimates(store: TripleStore, relax: RelaxTable,
                          pattern_ids: torch.Tensor, active: torch.Tensor,
                          k: int, G: int, cardinality_mode: str = "exact"):
    """(e_qk (Q,), e_q1 (Q, T, R)) — the quantities PLANGEN compares."""
    n, n_rel = cardinalities(store, relax, pattern_ids, active,
                             cardinality_mode)
    return score_estimates_from_cards(store.stats, relax, pattern_ids, active,
                                      n, n_rel, k, G)
