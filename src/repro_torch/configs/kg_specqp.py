"""kg-specqp — the paper's own engine as a production serving config.

Counterpart of ``repro.configs.kg_specqp``: one rank = one hash partition
of the KG (DESIGN.md §2/§5), with the store geometry of one partition and
the engine settings. ``serve_step`` answers a batch of star queries with
the full Spec-QP pipeline (statistics → PLANGEN → rank-join execution →
two-level top-k merge), as the reference's ``make_cell`` function does.
``make_cell`` is the dry run's cell around it: one partition a card of
the mesh, as ``store_specs`` lays the stores out. ``smoke`` is the
TriniT-equals-full-scan check on the tiny workload.
"""
from __future__ import annotations

import math
from functools import partial

from repro_torch import sharding
from repro_torch.configs import base
from repro_torch.core import distributed as dist
from repro_torch.core import sketches
from repro_torch.core.types import EngineConfig, RelaxTable, TripleStore
from repro_torch.launch.mesh import Mesh

ARCH = "kg-specqp"
FAMILY = "kg"
SHAPES = ["serve_batch", "serve_trinit"]
SKIP_SHAPES: dict[str, str] = {}

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


# The executor trips a dry-run cell runs (``engine._execute_refill``): the
# reference's cost analysis counts its ``while_loop``'s body once, whose
# trip count it cannot know, and its refill ``lax.cond``'s costlier branch.
CELL_TRIPS = 1


def store_specs(n_shards: int):
    """(stores, relax, gstats, queries) of the cell as meta tensors by
    field: every store field with a leading (n_shards,) axis, one partition
    a card. The sketch is ``sketches.adaptive_words(L_SHARD)`` words a lane
    (an 8192-item shard gets 16,384), held as the int32 view of the
    reference's uint32 words."""
    i32, f32 = "int32", "float32"
    P, L = N_PATTERNS, L_SHARD
    stores = {
        "keys": base.spec((n_shards, P, L), i32),
        "scores": base.spec((n_shards, P, L), f32),
        "lengths": base.spec((n_shards, P), i32),
        "sorted_keys": base.spec((n_shards, P, L), i32),
        "stats": base.spec((n_shards, P, 4), f32),
        "sketch": base.spec((n_shards, P, sketches.SKETCH_LANES,
                             sketches.adaptive_words(L)), i32),
    }
    relax = {"ids": base.spec((P, N_RELAX), i32),
             "weights": base.spec((P, N_RELAX), f32)}
    return (stores, relax, base.spec((P, 4), f32),
            base.spec((N_QUERIES, T_MAX), i32))


def make_cell(shape: str) -> base.CellSpec:
    """The (kg-specqp × shape) cell on the installed mesh, the reference's:
    ``serve_batch`` (specqp) or ``serve_trinit``, the stores split over
    every mesh axis ("all_devices"), relax, gstats and the (N_QUERIES,
    T_MAX) queries replicated. Its function is ``serve_cell``, the dry run
    passing ``trips=CELL_TRIPS``."""
    if not sharding.active():
        raise RuntimeError("kg-specqp cells need an installed mesh")
    mode = "trinit" if shape == "serve_trinit" else "specqp"
    n_shards = math.prod(sharding.current_mesh().shape)
    stores, relax, gstats, queries = store_specs(n_shards)
    store_axes = {f: ("all_devices",) + (None,) * (t.dim() - 1)
                  for f, t in stores.items()}
    relax_axes = {"ids": (None, None), "weights": (None, None)}
    return base.CellSpec(ARCH, shape, "serve", partial(serve_cell, mode=mode),
                         (stores, relax, gstats, queries),
                         (store_axes, relax_axes, (None, None), (None, None)),
                         static_kwargs={"trips": CELL_TRIPS})


def serve_cell(stores: dict, relax: dict, gstats, queries, *, mode: str,
               trips: int | None = None) -> dict:
    """The cell's function, the reference's ``shard_map`` body: each store
    field (a DTensor split over every mesh axis) to this rank's shard, its
    unit shard axis indexed away, then the serve step's plan, local rank
    join (``trips`` bounded, or to the end with None) and merge on a
    ``Mesh`` over the fields' ``DeviceMesh``. Returns the merged
    ``EngineResult``'s fields by name, equal on every rank."""
    local = TripleStore(**{f: _local(t)[0] for f, t in stores.items()})
    mesh = Mesh.from_device_mesh(stores["keys"].device_mesh,
                                 local.keys.device)
    fn = dist.make_batched_sharded_fn(ENGINE, mode, mesh, trips=trips)
    res = fn(local, RelaxTable(**{f: _local(t) for f, t in relax.items()}),
             _local(gstats), _local(queries))
    return {f: getattr(res, f) for f in res.__dataclass_fields__}


def _local(t):
    """A DTensor's shard on this rank (a replicated one's whole value)."""
    return t.to_local() if hasattr(t, "to_local") else t


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
