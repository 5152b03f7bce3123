"""Dispatch between each kernel and its plain version, by device.

A CPU tensor goes to the plain version (``kernels.ref``); a CUDA tensor goes
to the hand-written CUDA kernel, or the call raises. ``impl="ref"`` forces
the plain version on any device: it exists for ``chip_smoke.py`` and the
tests, which hold the kernels against it; the engine never passes it.

Every kernel but ``neigh_softmax_agg`` is reached through its custom op
(``repro_torch::<name>``), whose CPU impl is the plain version and whose
CUDA impl the kernel's launch; on the meta device or under
``FakeTensorMode`` (the dry run's fake shards) the op gives its outputs'
shapes and runs neither.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rank_join as _rank_join
from repro_torch.kernels import merge_topk as _merge_topk
from repro_torch.kernels import topk_score as _topk_score
from repro_torch.kernels import embedding_bag as _embedding_bag
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import neigh_agg as _neigh_agg

KERNELS = {"rank_join_lookup": _rank_join.rank_join_lookup,
           "merge_topk": _merge_topk.merge_topk,
           "topk_score_pruned": _topk_score.topk_score_pruned,
           "embedding_bag": _embedding_bag.embedding_bag,
           "embedding_bag_backward": _embedding_bag.embedding_bag_backward,
           "flash_attention": _flash_attention.flash_attention,
           "flash_attention_backward":
               _flash_attention.flash_attention_backward,
           "neigh_softmax_agg": _neigh_agg.neigh_softmax_agg}


def _ref_impl(impl: str) -> bool:
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl must be 'auto' or 'ref', got {impl!r}")
    return impl == "ref"


def _plain(t: torch.Tensor, impl: str) -> bool:
    if _ref_impl(impl) or t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {t.device}")
    return False


def rank_join_lookup(seen_keys, seen_scores, probe_keys, seen_cnt,
                     impl: str = "auto"):
    """Batched probe: (G, N), (G, N), (G, B), (G,) → (G, B) scores, found;
    through ``repro_torch::rank_join_lookup``."""
    if _ref_impl(impl):
        return _ref.rank_join_lookup(seen_keys, seen_scores, probe_keys,
                                     seen_cnt)
    return _rank_join.lookup_op(seen_keys, seen_scores, probe_keys, seen_cnt)


def merge_topk(window_keys, window_scores, block: int, impl: str = "auto"):
    """Batched pull: (G, R, W) windows → (G, block) keys, scores, flat_idx;
    through ``repro_torch::merge_topk``."""
    if _ref_impl(impl):
        return _ref.merge_topk(window_keys, window_scores, block)
    return _merge_topk.merge_op(window_keys, window_scores, block)


def topk_score_pruned(query, cands, block_bounds, k: int, tile: int = 512,
                      impl: str = "auto"):
    """Speculative top-k: (D,), (N, D), (N/tile,) → (k,) scores, (k,) idx,
    () n_tiles_scored; through ``repro_torch::topk_score_pruned``."""
    if _ref_impl(impl):
        return _ref.topk_score_pruned(query, cands, block_bounds, k, tile)
    return _topk_score.pruned_op(query, cands, block_bounds, k, tile)


block_bounds_cauchy = _topk_score.block_bounds_cauchy


def embedding_bag(table, ids, weights, impl: str = "auto"):
    """Weighted bag: (V, D), (B, S), (B, S) → (B, D); through
    ``repro_torch::embedding_bag``, differentiable through
    ``repro_torch::embedding_bag_backward`` (on the card the backward
    kernel, on the CPU its plain version)."""
    if _ref_impl(impl):
        return _ref.embedding_bag(table, ids, weights)
    return _embedding_bag.bag_op(table, ids, weights)


def embedding_bag_backward(dout, ids, weights, table, *,
                           table_grad: bool = True,
                           weights_grad: bool = False, impl: str = "auto"):
    """The bag's gradients from dout (B, D) → (dtable (V, D) or None,
    dweights (B, S) or None); through
    ``repro_torch::embedding_bag_backward``."""
    if _ref_impl(impl):
        return _ref.embedding_bag_backward(dout, ids, weights, table,
                                           table_grad=table_grad,
                                           weights_grad=weights_grad)
    grads = iter(_embedding_bag.bag_backward_op(dout, ids, weights, table,
                                                table_grad, weights_grad))
    return (next(grads) if table_grad else None,
            next(grads) if weights_grad else None)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    softcap=None, scale=None, impl: str = "auto"):
    """Attention: (B, Hq, Sq, D), (B, Hkv, Sk, D) ×2 → (B, Hq, Sq, D);
    window 0 / None is global, softcap 0 / None is none. Through the
    custom op ``repro_torch::flash_attention`` (``kernels.flash_attention``):
    the kernel on the card, its plain twin on the CPU, the shapes on the
    meta device or under ``FakeTensorMode``, each rank's shard of a
    ``DTensor``; differentiable through the backward op (on the card the
    backward kernel, on the CPU its plain twin). ``impl="ref"`` is the
    plain version on any device."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if _ref_impl(impl):
        return _ref.flash_attention(q, k, v, **kw)
    return _flash_attention.attention(q, k, v, **kw)


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = True,
                             window=None, softcap=None, scale=None,
                             impl: str = "auto"):
    """The attention backward from the forward's o and lse (B, Hq, Sq) →
    (dq, dk, dv)."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if _plain(q, impl):
        return _ref.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    return _flash_attention.flash_attention_backward(q, k, v, o, lse, do,
                                                     **kw)


def neigh_softmax_agg(logits, feats, mask, impl: str = "auto"):
    """Masked softmax over each row's slots, then the weighted sum of its
    features: (R, MAXD) f32, (R, MAXD, D) f32, (R, MAXD) bool → (R, D)."""
    if _plain(logits, impl):
        return _ref.neigh_softmax_agg(logits, feats, mask)
    return _neigh_agg.neigh_softmax_agg(logits, feats, mask)


def launches() -> dict[str, int]:
    """Kernel launches per kernel since the last ``reset_launches``."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
