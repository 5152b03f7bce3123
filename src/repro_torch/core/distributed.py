"""Distributed Spec-QP: hash-partitioned KG shards, one rank each.

Counterpart of ``repro.core.distributed`` (DESIGN.md §5). The KG is
partitioned by a mixing hash of the *join key*, so that a key's triples
for every pattern land on one shard, and star joins decompose exactly:

  global top-k  =  top-k( ∪_shards local top-k )
  global |∩ K_t| = Σ_shards local |∩ K_t|        (cardinalities psum)

Where the reference runs one ``shard_map`` body per device, here one
process per mesh position (``launch.mesh``) runs it on its own shard:
every rank plans from the summed cardinalities and the replicated global
stats, so the plan is the same on every rank, executes the rank join on
its shard alone, and a gather + top-k per mesh axis, in mesh order,
merges the ranks' (k,) buffers. The collectives run on ``Mesh``'s
subgroups: ``psum`` is an ``all_reduce`` sum, ``pmax`` one of max, and
the merge (``Mesh.merge_top_k``) gathers in rank order along the axis and
keeps ``lax.top_k``'s order among equal scores (the lower gathered
position first).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine, estimator, plangen, sketches
from repro_torch.core import kg as kglib
from repro_torch.core.types import (TripleStore, RelaxTable, EngineResult,
                                    EngineConfig, PAD_KEY, safe_ids)


def mix_hash(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Cheap multiplicative mixing hash → shard id (avoids range artifacts)."""
    h = (keys.astype(np.uint64) * np.uint64(2654435761)) % np.uint64(2**32)
    return (h % np.uint64(n_shards)).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class ShardedKG:
    """Host-built sharded store: leading axis = shard."""

    stores: TripleStore          # every field has a leading (S,) axis
    relax: RelaxTable            # replicated
    global_stats: torch.Tensor   # (P, 4) — stats of the *unsharded* lists
    n_shards: int


def shard_workload(pattern_lists, n_shards: int,
                   list_len: int | None = None):
    """Partition per-pattern (keys, raw_scores) lists into S shard stores.

    Scores are normalized by the GLOBAL per-pattern max before sharding
    (Definition 5 is a global property), and the global two-bucket stats
    are computed on the full lists; shard stores keep their local lists
    sorted. Returns (stores, global_stats): a ``TripleStore`` on the host
    whose fields carry a leading (S,) shard axis, and the (P, 4) stats.
    """
    P_n = len(pattern_lists)
    norm_lists = []
    g_stats = np.zeros((P_n, 4), np.float32)
    shard_ids = []
    for p, (k, s) in enumerate(pattern_lists):
        k = np.asarray(k, np.int64)
        s = np.asarray(s, np.float64)
        mx = s.max() if len(s) else 1.0
        sn = s / mx if mx > 0 else s
        order = np.argsort(-sn, kind="stable")
        g_stats[p] = kglib.compute_pattern_stats(
            sn[order].astype(np.float32), len(k))
        norm_lists.append((k, sn))
        shard_ids.append(mix_hash(k, n_shards) if len(k) else
                         np.zeros((0,), np.int64))

    if list_len is None:
        # The true per-shard maximum: under hash imbalance a hot shard can
        # exceed any mean-based margin.
        list_len = 1
        for sid in shard_ids:
            if len(sid):
                list_len = max(list_len,
                               int(np.bincount(sid,
                                               minlength=n_shards).max()))

    # One signature geometry for every shard, sized from the GLOBAL
    # longest list: the shards' sketch estimates are summed, so their
    # widths must agree.
    sketch_words = sketches.adaptive_words(
        max((len(k) for k, _ in pattern_lists), default=1))
    shard_arrays = []
    for s_id in range(n_shards):
        per_pattern = []
        for (k, sn), sid in zip(norm_lists, shard_ids):
            sel = sid == s_id
            per_pattern.append((k[sel].astype(np.int32), sn[sel]))
        shard_arrays.append(kglib.build_store_arrays(
            per_pattern, list_len=list_len, normalize=False,
            sketch_words=sketch_words))

    stacked = {f: np.stack([a[f] for a in shard_arrays])
               for f in shard_arrays[0]}
    return (kglib.store_from_arrays(stacked, "cpu"),
            torch.from_numpy(g_stats))


def build_sharded_kg(pattern_lists, relax: RelaxTable,
                     n_shards: int, list_len: int | None = None) -> ShardedKG:
    stores, g_stats = shard_workload(pattern_lists, n_shards, list_len)
    return ShardedKG(stores=stores, relax=relax, global_stats=g_stats,
                     n_shards=n_shards)


def _shard_axes(mesh, shard_axes) -> tuple[str, ...]:
    return tuple(shard_axes or mesh.axis_names)


def local_shard(stores: TripleStore, mesh, shard_axes=None) -> TripleStore:
    """This rank's shard of stacked (S, ...) stores, on the mesh's device:
    the block ``shard_map`` hands each device, its unit axis indexed away."""
    axes = _shard_axes(mesh, shard_axes)
    n_dev = int(np.prod([mesh.axis_size(a) for a in axes]))
    if stores.keys.shape[0] != n_dev:
        raise ValueError(f"{stores.keys.shape[0]} shards for {n_dev} ranks "
                         f"over {axes}")
    i = mesh.flat_index(axes)
    return TripleStore(**{f.name: getattr(stores, f.name)[i].to(mesh.device)
                          for f in dataclasses.fields(stores)})


def _plan(store: TripleStore, relax: RelaxTable, global_stats: torch.Tensor,
          pids: torch.Tensor, cfg: EngineConfig, mode: str, mesh,
          axes) -> torch.Tensor:
    """(Q, T, R) plans, the same on every rank: local cardinalities summed
    over the shards, estimates from the replicated global stats."""
    R = relax.ids.shape[1]
    active = pids != PAD_KEY
    if mode == "trinit":
        return plangen.trinit_plan(pids, R).contiguous()
    if mode == "join_only":
        return torch.zeros((*pids.shape, R), dtype=torch.bool,
                           device=pids.device)
    # Key sets partition across shards, so exact counts add up to the
    # global ones, and the sketch estimates (from shard-local signatures)
    # do in expectation.
    n, n_rel = estimator.cardinalities(store, relax, pids, active,
                                       cfg.cardinality_mode)
    n_join = estimator.joinability(store, relax, pids, active,
                                   cfg.cardinality_mode)
    for ax in axes:
        n, n_rel, n_join = (mesh.psum(x, ax) for x in (n, n_rel, n_join))
    if cfg.cardinality_mode == "sketch":
        # Round the GLOBAL estimate: joinable mass spread thinly across
        # shards must be summed before the sub-key cut.
        n_join = sketches.round_joinability(n_join)
    e_qk, e_q1 = estimator.score_estimates_from_cards(
        global_stats, relax, pids, active, n, n_rel, cfg.k, cfg.grid_bins)
    rel_exists = relax.ids[safe_ids(pids)] != PAD_KEY
    mask = plangen.plan_from_estimates(e_qk, e_q1, n_join, rel_exists,
                                       active, cfg.plan_slack)
    if mode == "specqp_pattern":
        mask = plangen.per_pattern_plan(mask).contiguous()
    return mask


def _shard_body(store: TripleStore, relax: RelaxTable,
                global_stats: torch.Tensor, pids: torch.Tensor,
                cfg: EngineConfig, mode: str, mesh, axes,
                trips: int | None = None) -> EngineResult:
    """Plan globally, execute locally, merge: a (Q, T) batch on this rank's
    shard → the merged ``EngineResult``, equal on every rank, with a
    leading (Q,) axis. ``trips``: the executor's bounded trip count
    (``engine._execute_refill``), None to run every query to its end."""
    if mode not in engine.MODES:
        raise ValueError(mode)
    mask = _plan(store, relax, global_stats, pids, cfg, mode, mesh, axes)
    # The local rank join: the batch as one fixed-batch queue (one lane a
    # query) through the one executor.
    local = engine.run_query_batch_with_masks(store, relax, pids, mask, cfg,
                                              device=mesh.device, trips=trips)
    scores, keys = mesh.merge_top_k(local.scores, local.keys, cfg.k, axes)
    n_pulled, n_answers, n_iters = local.n_pulled, local.n_answers, \
        local.n_iters
    for ax in axes:
        n_pulled = mesh.psum(n_pulled, ax)
        n_answers = mesh.psum(n_answers, ax)
        n_iters = mesh.pmax(n_iters, ax)
    # The reference runs each query alone on one lane (a vmapped lanes=1
    # loop freezes a finished query), so no query ever idles on a lane:
    # its n_wasted is 0, not the idle trips of this batch's shared queue.
    return EngineResult(keys=keys, scores=scores, n_pulled=n_pulled,
                        n_answers=n_answers, n_iters=n_iters,
                        n_wasted=torch.zeros_like(local.n_wasted),
                        relax_mask=mask)


def _replicated(relax: RelaxTable, global_stats, queries, device):
    return (relax.to(device), torch.as_tensor(global_stats).to(device),
            engine._as_pids(queries, device))


def run_query_sharded(skg: ShardedKG, pattern_ids, cfg: EngineConfig,
                      mode: str, mesh, shard_axes=None) -> EngineResult:
    """Answer one star query over a hash-partitioned KG on ``mesh``; every
    rank calls it and gets the same result.

    ``shard_axes`` — mesh axes the store is partitioned over (all, default).
    """
    axes = _shard_axes(mesh, shard_axes)
    n_dev = int(np.prod([mesh.axis_size(a) for a in axes]))
    if skg.n_shards != n_dev:
        raise ValueError(f"{skg.n_shards} shards for {n_dev} ranks")
    store = local_shard(skg.stores, mesh, axes)
    relax, gstats, pids = _replicated(skg.relax, skg.global_stats,
                                      pattern_ids, mesh.device)
    res = _shard_body(store, relax, gstats, pids[None], cfg, mode, mesh, axes)
    return EngineResult(**{f.name: getattr(res, f.name)[0]
                           for f in dataclasses.fields(res)})


def make_batched_sharded_fn(cfg: EngineConfig, mode: str, mesh,
                            shard_axes=None, trips: int | None = None):
    """Build fn(store, relax, gstats, queries (B, T)) → EngineResult batch.

    The production serve step: every rank runs the planner and executor
    on its KG partition for the whole query batch, then the per-axis
    gather/top-k tree merges results. ``store`` is this rank's shard on
    the mesh's device (``local_shard``); ``relax``, ``gstats`` and
    ``queries`` are replicated. ``trips``: the executor's bounded trip
    count (the dry run's 1), None to run every query to its end.
    """
    axes = _shard_axes(mesh, shard_axes)

    def fn(store: TripleStore, relax: RelaxTable, gstats, queries):
        relax, gstats, pids = _replicated(relax, gstats, queries,
                                          mesh.device)
        return _shard_body(store, relax, gstats, pids, cfg, mode, mesh, axes,
                           trips)

    return fn
