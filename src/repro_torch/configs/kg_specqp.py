"""kg-specqp — the paper's own engine as a production serving config.

Counterpart of ``repro.configs.kg_specqp``: one rank = one hash partition
of the KG (DESIGN.md §2/§5), with the store geometry of one partition and
the engine settings. ``serve_step`` answers a batch of star queries with
the full Spec-QP pipeline (statistics → PLANGEN → rank-join execution →
two-level top-k merge), as the reference's ``make_cell`` function does.
The TPU dry-run cell around it (``make_cell``'s ``CellSpec``,
``store_specs``) is not ported.
"""
from __future__ import annotations

from repro_torch.core import distributed as dist
from repro_torch.core.types import EngineConfig

ARCH = "kg-specqp"
FAMILY = "kg"

# Production store geometry (per shard): P patterns × L_SHARD items.
N_PATTERNS = 1024
L_SHARD = 8192
N_RELAX = 10
N_QUERIES = 32
T_MAX = 4
# seen_cap bounds the probe bytes per iteration (see the JAX config).
ENGINE = EngineConfig(block=256, k=100, grid_bins=512, seen_cap=16384)


def config() -> EngineConfig:
    return ENGINE


def serve_step(mesh, mode: str = "specqp"):
    """The batched sharded serve step on ``mesh`` (one shard a rank, over
    every axis): fn(store, relax, gstats, queries (N_QUERIES, T_MAX)) →
    EngineResult batch, ``store`` being this rank's partition of
    N_PATTERNS × L_SHARD items (``distributed.local_shard``)."""
    return dist.make_batched_sharded_fn(ENGINE, mode, mesh)


def smoke_config() -> EngineConfig:
    return EngineConfig(block=16, k=5, grid_bins=128)
