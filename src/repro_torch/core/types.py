"""Core tensor types for the Spec-QP engine (counterpart of ``repro.core.types``).

All tensors are dense and fixed-shape. Lists are sorted by score
(descending) and padded: keys with ``PAD_KEY`` (=-1), scores with 0.

Shapes use the following symbols:
  P  — number of triple patterns known to the store
  L  — max posting-list length (padded)
  R  — max relaxations per pattern
  T  — number of triple patterns in a query
"""
from __future__ import annotations

import dataclasses

import torch

PAD_KEY = -1
# Sentinel used in *key-sorted* arrays so padding sorts to the end.
KEY_SENTINEL = 2**31 - 1
NEG_INF = float("-inf")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With no device given and no CUDA device present this raises instead of
    falling back to the CPU; callers that want the CPU say so.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def safe_ids(ids: torch.Tensor) -> torch.Tensor:
    """Pattern ids as int64 with ``PAD_KEY`` mapped to 0, for gathers (the
    rows they fetch for padding are masked out by the caller)."""
    ids = ids.long()
    return torch.where(ids == PAD_KEY, 0, ids)


def check_on(device: torch.device, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on ``device``'s type of device."""
    for t in tensors:
        if t.device.type != device.type:
            raise ValueError(
                f"tensor on {t.device} but the call runs on {device}; move "
                "the store with TripleStore.to / RelaxTable.to")


def _to(obj, device):
    return type(obj)(**{f.name: getattr(obj, f.name).to(device)
                        for f in dataclasses.fields(obj)})


@dataclasses.dataclass(frozen=True)
class TripleStore:
    """Scored posting lists for every triple pattern in the KG.

    ``keys``/``scores`` are sorted by score desc per pattern; scores are
    normalized per Definition 5, so every non-empty pattern's top score is
    exactly 1.0. ``sorted_keys`` is the same key set sorted ascending
    (padding → KEY_SENTINEL) for O(log L) membership probes. ``stats`` holds
    the paper's four per-pattern statistics ``(m, sigma_r, S_r, S_m)``.
    ``sketch`` holds the bitmap key signatures as an int32 view of their
    uint32 words (torch's uint32 lacks ``~`` and ``>>`` on the CPU).
    """

    keys: torch.Tensor          # (P, L) int32, PAD_KEY padded
    scores: torch.Tensor        # (P, L) f32 in [0, 1], 0 padded
    lengths: torch.Tensor       # (P,)  int32
    sorted_keys: torch.Tensor   # (P, L) int32 ascending, KEY_SENTINEL padded
    stats: torch.Tensor         # (P, 4) f32: m, sigma_r, S_r, S_m
    sketch: torch.Tensor        # (P, LANES, W) int32 view of uint32 words

    def to(self, device) -> "TripleStore":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class RelaxTable:
    """Weighted relaxation rules r = (q, q', w), grouped by domain pattern,
    sorted by weight desc."""

    ids: torch.Tensor       # (P, R) int32 pattern ids, PAD_KEY padded
    weights: torch.Tensor   # (P, R) f32 in [0, 1], 0 padded

    def to(self, device) -> "RelaxTable":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class EngineResult:
    """Top-k answers plus the paper's efficiency counters.

    Batched entry points give every field a leading (M,) queue axis.
    """

    keys: torch.Tensor        # (k,) int32, PAD_KEY padded
    scores: torch.Tensor      # (k,) f32, -inf padded
    n_pulled: torch.Tensor    # () int32 — items materialized from input lists
    n_answers: torch.Tensor   # () int32 — (partial) answer objects created
    n_iters: torch.Tensor     # () int32 — loop trips doing real work
    n_wasted: torch.Tensor    # () int32 — lockstep trips idle after finishing
    relax_mask: torch.Tensor  # (T, R) bool — the plan


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine hyper-parameters.

    Unlike the JAX config there is no kernel knob: which path a kernel
    takes follows the device its tensors lie on (``kernels.ops``).
    """

    block: int = 64           # items pulled per merge step
    k: int = 10               # top-k
    grid_bins: int = 512      # histogram grid resolution per unit score
    # Sibling-pruning aggressiveness of the (T, R) planner (plangen.plan).
    plan_slack: float | None = None
    # Planner cardinalities: "exact" (binary searches, cost grows with L)
    # or "sketch" (bitmap signatures, L-independent; core/sketches.py).
    cardinality_mode: str = "exact"
    # Cap on the per-stream seen ring (None = worst-case R1·L sizing),
    # rounded up to whole blocks (engine._seen_size).
    seen_cap: int | None = None
