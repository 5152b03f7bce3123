"""kg-specqp — the paper's own engine as a production serving config.

Counterpart of ``repro.configs.kg_specqp``: one rank = one hash partition
of the KG (DESIGN.md §2/§5), with the store geometry of one partition and
the engine settings. ``serve_step`` answers a batch of star queries with
the full Spec-QP pipeline (statistics → PLANGEN → rank-join execution →
two-level top-k merge), as the reference's ``make_cell`` function does.
``smoke`` is the TriniT-equals-full-scan check on the tiny workload.
The TPU dry-run cell around it (``make_cell``'s ``CellSpec``,
``store_specs``) is not ported.
"""
from __future__ import annotations

from repro_torch.core import distributed as dist
from repro_torch.core.types import EngineConfig

ARCH = "kg-specqp"
FAMILY = "kg"
# The reference's dry-run cells (not laid out over a mesh yet).
SHAPES = ["serve_batch", "serve_trinit"]

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


def smoke(device=None):
    """Single-device Spec-QP == TriniT-exactness smoke (tiny workload):
    per query, TriniT's scores equal ``naive_full_scan``'s (rtol 1e-5).
    Returns [(trinit result, specqp result)] per query."""
    import numpy as np
    from repro_torch.core import engine
    from repro_torch.data import kg_synth

    wl = kg_synth.tiny_workload(seed=0, n_queries=4, device=device)
    cfg = smoke_config()
    outs = []
    for i in range(len(wl.queries)):
        q = np.asarray(wl.queries[i])
        rt = engine.run_query(wl.store, wl.relax, q, cfg, "trinit",
                              device=device)
        rs = engine.run_query(wl.store, wl.relax, q, cfg, "specqp",
                              device=device)
        _, bs = engine.naive_full_scan(wl.store, wl.relax, q, cfg.k,
                                       wl.n_entities, device=device)
        if not np.allclose(bs.cpu().numpy(), rt.scores.cpu().numpy(),
                           rtol=1e-5):
            raise AssertionError(f"query {i}: TriniT differs from the "
                                 "full scan")
        outs.append((rt, rs))
    return outs
