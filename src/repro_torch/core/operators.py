"""Vectorized TriniT operators: Incremental Merge and (n-ary) Rank Join.

Counterpart of ``repro.core.operators``. Where the JAX functions take one
query and are vmapped over lanes, these take a leading lane (or group) axis
written out, so one call serves every lane of an executor trip:

* Incremental Merge — a blockwise pull: the next ``B`` items of each merged
  (weight-scaled, score-desc) stream are the top-B of the union of every
  source list's next-B window (``kernels.ops.merge_topk``).
* Rank Join — each pulled block is equi-joined against the streams' seen
  rings (``kernels.ops.rank_join_lookup``).

Keys are unique within every source list and pulled blocks are deduplicated
against their own stream's history, so seen rings hold unique keys.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.types import PAD_KEY, NEG_INF
from repro_torch.kernels import ops as kops


def lookup_scores(seen_keys: torch.Tensor, seen_scores: torch.Tensor,
                  probe_keys: torch.Tensor, seen_cnt: torch.Tensor):
    """Probe (G, B) keys against G unique-key rings (G, N) in one launch.

    Returns (scores (G, B) f32 with 0 where missing, found (G, B) bool).
    """
    return kops.rank_join_lookup(seen_keys, seen_scores, probe_keys,
                                 seen_cnt)


class MergedStreams(NamedTuple):
    """Gathered source lists for every stream of a batch of queries.

    A stream = a triple pattern + its relaxations; scores are pre-scaled by
    the relaxation weights, so merge order is the paper's weighted order.
    """

    keys: torch.Tensor           # (Q, T, R1, L) int32
    scores: torch.Tensor         # (Q, T, R1, L) f32 (already weight-scaled)
    lengths: torch.Tensor        # (Q, T, R1) int64 (0 for masked-off sources)
    stream_active: torch.Tensor  # (Q, T) bool — padded query slots are False


def gather_streams(store, relax, pattern_ids: torch.Tensor,
                   relax_mask: torch.Tensor) -> MergedStreams:
    """Stream views for (Q, T) queries under their (Q, T, R) plans.

    Source r+1 of stream t is live iff relaxation slot r of pattern t is
    real (not padding) *and* the plan enabled it.
    """
    pattern_ids = pattern_ids.long()
    Q, T = pattern_ids.shape
    safe_pid = torch.where(pattern_ids == PAD_KEY, 0, pattern_ids)
    rel_ids = relax.ids[safe_pid].long()                 # (Q, T, R)
    rel_w = relax.weights[safe_pid]                      # (Q, T, R)
    src_ids = torch.cat([safe_pid[..., None],
                         torch.where(rel_ids == PAD_KEY, 0, rel_ids)], -1)
    src_valid = torch.cat([(pattern_ids != PAD_KEY)[..., None],
                           (rel_ids != PAD_KEY) & relax_mask], -1)
    weights = torch.cat([torch.ones_like(rel_w[..., :1]), rel_w], -1)
    keys = store.keys[src_ids]                           # (Q, T, R1, L)
    scores = store.scores[src_ids] * weights[..., None]
    lengths = torch.where(src_valid, store.lengths[src_ids].long(), 0)
    keys = torch.where(src_valid[..., None], keys, PAD_KEY)
    scores = torch.where(src_valid[..., None], scores, 0.0)
    return MergedStreams(keys=keys, scores=scores, lengths=lengths,
                         stream_active=pattern_ids != PAD_KEY)


def block_windows(keys: torch.Tensor, scores: torch.Tensor,
                  lengths: torch.Tensor, cursors: torch.Tensor, block: int):
    """Each source's next ``block`` items from its cursor: (Q, R1, B) keys
    and scores, PAD / -inf past the source's length. A source list is
    score-descending, so every row is too."""
    L = keys.shape[-1]
    pos = cursors[..., None] + torch.arange(block, device=keys.device)
    ok = pos < lengths[..., None]                        # (Q, R1, B)
    at = pos.clamp(max=L - 1)
    wk = torch.where(ok, keys.gather(-1, at), PAD_KEY).contiguous()
    ws = torch.where(ok, scores.gather(-1, at), NEG_INF).contiguous()
    return wk, ws


def pull_block(keys: torch.Tensor, scores: torch.Tensor,
               lengths: torch.Tensor, cursors: torch.Tensor, block: int):
    """Pull the next ``block`` items of Q merged streams, one launch.

    Args:
      keys/scores: (Q, R1, L); lengths/cursors: (Q, R1) int64.
    Returns (blk_keys (Q, B), blk_scores (Q, B) sorted desc,
    new_cursors (Q, R1)).
    """
    R1 = keys.shape[1]
    wk, ws = block_windows(keys, scores, lengths, cursors, block)
    top_k, top_s, top_i = kops.merge_topk(wk, ws, block)
    src_of = top_i.long() // block
    taken = top_s > NEG_INF
    # Advance each source cursor by the number of its items taken.
    adv = ((src_of[:, None, :] == torch.arange(R1, device=keys.device)[
        None, :, None]) & taken[:, None, :]).sum(-1)
    new_cursors = torch.minimum(cursors + adv, lengths)
    blk_keys = torch.where(taken, top_k, PAD_KEY)
    blk_scores = torch.where(taken, top_s, NEG_INF)
    return blk_keys, blk_scores, new_cursors


def dedup_block(blk_keys: torch.Tensor, blk_scores: torch.Tensor):
    """Mask duplicate keys inside (Q, B) desc-sorted blocks, keeping the
    first (= max) occurrence — the paper's S(A) = max over rewritings."""
    B = blk_keys.shape[-1]
    eq = blk_keys[..., None, :] == blk_keys[..., :, None]
    lower = torch.ones((B, B), dtype=torch.bool,
                       device=blk_keys.device).tril(-1)
    dup = (eq & lower).any(-1) & (blk_keys != PAD_KEY)
    return (torch.where(dup, PAD_KEY, blk_keys),
            torch.where(dup, NEG_INF, blk_scores))


def merged_head_score(keys, scores, lengths, cursors):
    """Score of the next item each merged stream would emit (-inf if dry).

    keys/scores (..., R1, L), lengths/cursors (..., R1) → (...).
    """
    L = keys.shape[-1]
    idx = cursors.clamp(max=L - 1)
    head = scores.gather(-1, idx[..., None])[..., 0]
    alive = cursors < lengths
    return torch.where(alive, head, NEG_INF).amax(-1)


def topk_insert(buf_keys, buf_scores, cand_keys, cand_scores, k: int):
    """Merge (Q, B) candidates into (Q, k) running top-k buffers, dedup-safe.

    A candidate key already in the buffer is dropped (the buffer copy holds
    the key's max). Ties keep the lower position, buffer first, as
    ``lax.top_k`` does; hence the stable sort.
    """
    dup = ((cand_keys[..., :, None] == buf_keys[..., None, :]) &
           (cand_keys != PAD_KEY)[..., None])
    drop = dup.any(-1)
    keys = torch.cat([buf_keys, torch.where(drop, PAD_KEY, cand_keys)], -1)
    scores = torch.cat([buf_scores, torch.where(drop, NEG_INF, cand_scores)],
                       -1)
    top_s, top_i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return keys.gather(-1, top_i[..., :k]), top_s[..., :k].contiguous()
