"""Plain PyTorch versions of the kernels (the correctness contracts).

Each mirrors its CUDA kernel's semantics exactly, batched over a leading
group axis G. The CPU path runs these, the CUDA kernels are held against
them on the card, and the tests hold them against ``repro.kernels.ref``.
"""
from __future__ import annotations

import torch

PAD_KEY = -1


def rank_join_lookup(seen_keys: torch.Tensor, seen_scores: torch.Tensor,
                     probe_keys: torch.Tensor, seen_cnt: torch.Tensor):
    """Probe keys against unique-key scored seen buffers, one per group.

    seen_keys (G, N) i32, seen_scores (G, N) f32, probe_keys (G, B) i32,
    seen_cnt (G,) i32. Slot n of group g is live iff n < seen_cnt[g] and
    its key is not PAD_KEY. Returns (scores (G, B) f32 — the sum of the
    live matches' scores, 0 where none — and found (G, B) bool; PAD probes
    are never found).
    """
    n = seen_keys.shape[-1]
    pos = torch.arange(n, device=seen_keys.device)
    valid = (seen_keys != PAD_KEY) & (pos[None, :] < seen_cnt[:, None])
    eq = (probe_keys[:, :, None] == seen_keys[:, None, :]) & valid[:, None, :]
    scores = torch.where(eq, seen_scores[:, None, :], 0.0).sum(-1)
    found = eq.any(-1) & (probe_keys != PAD_KEY)
    return torch.where(found, scores, 0.0), found


def merge_topk(window_keys: torch.Tensor, window_scores: torch.Tensor,
               block: int):
    """Top-``block`` of each group's R source windows by score, descending.

    window_keys (G, R, W) i32, window_scores (G, R, W) f32. Ties go to the
    lower flat index (r·W + w), as ``lax.top_k`` orders them. Returns
    (keys (G, block) i32, scores (G, block) f32, flat_idx (G, block) i32).
    """
    G = window_keys.shape[0]
    flat_k = window_keys.reshape(G, -1)
    flat_s = window_scores.reshape(G, -1)
    top_s, top_i = torch.sort(flat_s, dim=-1, descending=True, stable=True)
    top_s, top_i = top_s[:, :block], top_i[:, :block]
    return (flat_k.gather(1, top_i), top_s.contiguous(),
            top_i.to(torch.int32))
