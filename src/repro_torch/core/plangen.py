"""PLANGEN (Algorithm 1): speculative selection of relaxations to process.

Counterpart of ``repro.core.plangen``. The plan is a ``(T, R)`` boolean
mask — one bit per (pattern, relaxation) pair: pattern t is relaxed when
any relaxation's expected best score E_Q'(1) beats the original query's
expected k-th score E_Q(k), and then every relaxation that can join at all
rides along (a provably lossless prune of the dead ones; in sketch mode
sub-half-key joinability estimates count as dead). ``plan`` takes one
query (T,) or a batch (Q, T) and returns (T, R) or (Q, T, R).
"""
from __future__ import annotations

import torch

from repro_torch.core import estimator, sketches
from repro_torch.core.types import TripleStore, RelaxTable, PAD_KEY


def plan_from_estimates(e_qk: torch.Tensor, e_q1: torch.Tensor,
                        n_joinable: torch.Tensor, rel_exists: torch.Tensor,
                        active: torch.Tensor,
                        sibling_slack: float | None = None) -> torch.Tensor:
    """(..., T, R) mask from planner estimates; e_qk has the leading axes
    only. ``sibling_slack`` s additionally requires
    E_Q'(1) ≥ E_Q(k) − s·(best_sibling − E_Q(k))."""
    e_qk = e_qk[..., None, None]
    promising = e_q1 > e_qk
    speculate = promising.any(-1, keepdim=True) & active[..., None]
    mask = speculate & (n_joinable > 0) & rel_exists
    if sibling_slack is not None:
        best = torch.where(torch.isfinite(e_q1), e_q1,
                           float("-inf")).amax(-1, keepdim=True)
        mask &= e_q1 >= e_qk - sibling_slack * (best - e_qk)
    return mask


def plan(store: TripleStore, relax: RelaxTable, pattern_ids: torch.Tensor,
         k: int, G: int = 512, sibling_slack: float | None = None,
         cardinality_mode: str = "exact") -> torch.Tensor:
    """Speculative plan for a star query (T,) or a batch (Q, T).

    ``cardinality_mode``: "exact" (binary-search selectivities, cost grows
    with L) or "sketch" (bitmap-signature estimates, L-independent). Rows of padded patterns and padded relaxation slots are always False.
    """
    single = pattern_ids.dim() == 1
    pids = pattern_ids.long()
    if single:
        pids = pids[None]
    active = pids != PAD_KEY
    e_qk, e_q1 = estimator.query_score_estimates(
        store, relax, pids, active, k, G, cardinality_mode)
    n_joinable = estimator.joinability(store, relax, pids, active,
                                       cardinality_mode)
    if cardinality_mode == "sketch":
        n_joinable = sketches.round_joinability(n_joinable)
    rel_exists = relax.ids[torch.where(active, pids, 0)] != PAD_KEY
    mask = plan_from_estimates(e_qk, e_q1, n_joinable, rel_exists, active,
                               sibling_slack)
    return mask[0] if single else mask


def per_pattern_plan(mask: torch.Tensor) -> torch.Tensor:
    """Coarsen (..., T, R) plans to per-pattern granularity (the paper's
    original speculation): a pattern with any relaxation processes all."""
    return mask.any(-1, keepdim=True).expand(mask.shape)


def trinit_plan(pattern_ids: torch.Tensor, n_relax: int) -> torch.Tensor:
    """The non-speculative baseline: all-True (..., T, R), False on padded
    patterns."""
    active = pattern_ids != PAD_KEY
    return active[..., None].expand(*pattern_ids.shape, n_relax)
