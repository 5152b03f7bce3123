"""kg-specqp — the paper's own engine as a production serving config.

Counterpart of ``repro.configs.kg_specqp``: the store geometry of one hash
partition and the engine settings. The sharded cell (``make_cell``,
``store_specs``) is not ported yet.
"""
from __future__ import annotations

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


def smoke_config() -> EngineConfig:
    return EngineConfig(block=16, k=5, grid_bins=128)
