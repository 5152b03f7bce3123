"""Query engines: TriniT (non-speculative baseline), Spec-QP, and oracles.

Counterpart of ``repro.core.engine``. One mask-parameterized executor serves
every engine: the plan is a ``(T, R)`` boolean saying which relaxation
source lists join the merge (TriniT: all-True; Spec-QP: PLANGEN's mask).
The executor is an n-ary bound-driven rank join over blockwise incremental
merges.

There is exactly ONE executor loop (``_execute_refill``, reached through
``execute_queue``); single query, fixed batch and continuous-refill serving
are (queue depth M, lanes) settings of it. Where the JAX loop is a
``lax.while_loop`` over a vmapped body, this one is a Python loop over trips
whose body (``_step``) carries the lane axis written out: each trip makes one
``merge_topk`` launch for every lane's pull and one ``rank_join_lookup``
launch for every lane's 1 + T probes. The loop reads one small tensor back
to the host per trip, to decide whether to go on and whether to refill.

The seen rings, cursors and per-lane state are updated in place, which
saves copying the (lanes, T, N) rings every trip; nothing else holds them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import operators as ops
from repro_torch.core import plangen
from repro_torch.core.types import (TripleStore, RelaxTable, EngineResult,
                                    EngineConfig, PAD_KEY, NEG_INF,
                                    resolve_device, check_on)

MODES = ("trinit", "specqp", "specqp_pattern", "join_only")


@dataclasses.dataclass
class _LoopState:
    """Per-lane executor state; every field has a leading (lanes,) axis."""

    cursors: torch.Tensor      # (Q, T, R1) int64
    seen_keys: torch.Tensor    # (Q, T, N) int32
    seen_scores: torch.Tensor  # (Q, T, N) f32
    seen_cnt: torch.Tensor     # (Q, T) int32
    top_keys: torch.Tensor     # (Q, k) int32
    top_scores: torch.Tensor   # (Q, k) f32
    n_pulled: torch.Tensor     # (Q,) int64
    n_answers: torch.Tensor    # (Q,) int64
    n_iters: torch.Tensor      # (Q,) int64
    done: torch.Tensor         # (Q,) bool


def _seen_size(R1: int, L: int, cfg: EngineConfig) -> int:
    """Per-stream seen-ring length N (a whole number of B-item blocks, so
    wrapped appends overwrite exactly one stale block)."""
    B = cfg.block
    N = R1 * L + 2 * B
    if cfg.seen_cap:
        N = min(N, max(cfg.seen_cap, 2 * B))
    return -(-N // B) * B


def _max_iters(T: int, R1: int, L: int, cfg: EngineConfig) -> int:
    return T * (R1 * L // cfg.block + 2)


def _init_state(Q: int, T: int, R1: int, N: int, k: int,
                device) -> _LoopState:
    z = dict(dtype=torch.int64, device=device)
    return _LoopState(
        cursors=torch.zeros((Q, T, R1), **z),
        seen_keys=torch.full((Q, T, N), PAD_KEY, dtype=torch.int32,
                             device=device),
        seen_scores=torch.zeros((Q, T, N), dtype=torch.float32,
                                device=device),
        seen_cnt=torch.zeros((Q, T), dtype=torch.int32, device=device),
        top_keys=torch.full((Q, k), PAD_KEY, dtype=torch.int32,
                            device=device),
        top_scores=torch.full((Q, k), NEG_INF, dtype=torch.float32,
                              device=device),
        n_pulled=torch.zeros((Q,), **z), n_answers=torch.zeros((Q,), **z),
        n_iters=torch.zeros((Q,), **z),
        done=torch.zeros((Q,), dtype=torch.bool, device=device))


def _reset_lanes(st: _LoopState, idx: torch.Tensor) -> None:
    """Reset the lanes ``idx`` to their initial state, every field, so a
    spliced-in query can never see what the lane's last occupant left."""
    st.cursors[idx] = 0
    st.seen_keys[idx] = PAD_KEY
    st.seen_scores[idx] = 0.0
    st.seen_cnt[idx] = 0
    st.top_keys[idx] = PAD_KEY
    st.top_scores[idx] = NEG_INF
    st.n_pulled[idx] = 0
    st.n_answers[idx] = 0
    st.n_iters[idx] = 0
    st.done[idx] = False


def _sum_seq(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` left to right, the order the reference's reductions
    take (a tree or vectorized sum may differ in the last bit)."""
    acc = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def _step(streams: ops.MergedStreams, st: _LoopState, cfg: EngineConfig,
          N: int):
    """One pull-join-bound iteration of the rank join, for every lane.

    Updates the rings, ring counts and cursors of ``st`` in place and
    returns (top_keys, top_scores, n_taken, n_cand, done) for the caller's
    freeze discipline.
    """
    Q, T, R1, L = streams.keys.shape
    B, k = cfg.block, cfg.k
    dev = streams.keys.device
    lane = torch.arange(Q, device=dev)
    t_ar = torch.arange(T, device=dev)
    active = streams.stream_active                         # (Q, T)

    stream_max = torch.where(streams.lengths > 0, streams.scores[..., 0],
                             NEG_INF).amax(-1)
    stream_max = torch.where(active, stream_max, NEG_INF)
    own_max = torch.where(active, stream_max, 0.0)
    sum_max = _sum_seq(own_max)                            # (Q,)

    nxt = torch.where(active, ops.merged_head_score(
        streams.keys, streams.scores, streams.lengths, st.cursors), NEG_INF)
    t_star = nxt.argmax(-1)                                # first max

    blk_k, blk_s, new_cur = ops.pull_block(
        streams.keys[lane, t_star], streams.scores[lane, t_star],
        streams.lengths[lane, t_star], st.cursors[lane, t_star], B)
    n_taken = (blk_k != PAD_KEY).sum(-1)
    blk_k, blk_s = ops.dedup_block(blk_k, blk_s)

    # One probe launch for the whole trip: per lane, row 0 is t*'s own ring
    # (drop keys this stream already emitted), rows 1..T every stream's ring
    # (the join). The reference probes the join rows with the block after
    # the drop; a dropped key is a PAD probe there, which finds nothing.
    def with_own(x):
        return torch.cat([x[lane, t_star][:, None], x], 1)

    G = Q * (T + 1)
    s_all, f_all = ops.lookup_scores(
        with_own(st.seen_keys).view(G, N), with_own(st.seen_scores).view(G, N),
        blk_k.repeat_interleave(T + 1, dim=0),
        with_own(st.seen_cnt).view(G))
    s_all, f_all = s_all.view(Q, T + 1, B), f_all.view(Q, T + 1, B)
    seen_before = f_all[:, 0]
    blk_k = torch.where(seen_before, PAD_KEY, blk_k)
    blk_s = torch.where(seen_before, NEG_INF, blk_s)
    s_j = torch.where(seen_before[:, None], 0.0, s_all[:, 1:])
    f_j = f_all[:, 1:] & ~seen_before[:, None]

    others = active & (t_ar[None, :] != t_star[:, None])   # (Q, T)
    contrib = _sum_seq(torch.where(others[..., None], s_j, 0.0), 1)
    matched = torch.where(others[..., None], f_j, True).all(1)
    cand_ok = matched & (blk_k != PAD_KEY)
    cand_scores = torch.where(cand_ok, blk_s + contrib, NEG_INF)
    cand_keys = torch.where(cand_ok, blk_k, PAD_KEY)
    top_keys, top_scores = ops.topk_insert(st.top_keys, st.top_scores,
                                           cand_keys, cand_scores, k)

    # Append the block to t*'s ring: N is a multiple of B, so the slot
    # range is block-aligned and never straddles the ring's end.
    start = (st.seen_cnt[lane, t_star] % N).long()
    slot = start[:, None] + torch.arange(B, device=dev)
    st.seen_keys[lane[:, None], t_star[:, None], slot] = blk_k
    st.seen_scores[lane[:, None], t_star[:, None], slot] = torch.where(
        blk_s == NEG_INF, 0.0, blk_s)
    st.seen_cnt[lane, t_star] += B
    st.cursors[lane, t_star] = new_cur

    # HRJN-style n-ary corner bound for any undiscovered answer.
    nxt2 = torch.where(active, ops.merged_head_score(
        streams.keys, streams.scores, streams.lengths, st.cursors), NEG_INF)
    tau = (nxt2 + (sum_max[:, None] - own_max)).amax(-1)
    exhausted = (nxt2 == NEG_INF).all(-1)
    done = (top_scores[:, k - 1] >= tau) | exhausted
    return top_keys, top_scores, n_taken, cand_ok.sum(-1), done


def _reset_where(st: _LoopState, mask: torch.Tensor,
                 init: _LoopState) -> None:
    """``_reset_lanes`` of the lanes where ``mask`` (Q,) holds, to
    ``init``'s (``_init_state``'s) values, by selects: no value is read
    back to the host."""
    for f in dataclasses.fields(st):
        x = getattr(st, f.name)
        where = mask.view(-1, *(1,) * (x.dim() - 1))
        setattr(st, f.name, torch.where(where, getattr(init, f.name), x))


def _execute_refill(store: TripleStore, relax: RelaxTable,
                    queue_pids: torch.Tensor, queue_masks: torch.Tensor,
                    cfg: EngineConfig, lanes: int,
                    trips: int | None = None) -> dict:
    """The one executor: a continuous-refill lane loop.

    ``lanes`` lanes step in lockstep over an (M, T) queue. When a lane's
    HRJN bound closes (or its iteration budget runs out) its results are
    written at the lane's queue index and the next unadmitted query is
    spliced into the lane (streams re-gathered, state reset). Single query
    is M = lanes = 1, fixed batch is lanes = M, refill stream lanes < M.
    ``out_wasted`` counts the trips a lane sat idle after finishing,
    attributed to the last query it served. Output buffers have M + 1 rows:
    row M takes the writes of lanes with nothing to write and is dropped.

    ``trips=None`` runs trips until every lane is done, reading one small
    tensor back a trip. A number runs exactly that many trips and reads
    nothing back (the dry run's fake shards hold no values): each trip
    steps, emits, and refills every lane by selects, the streams of all
    ``lanes`` lanes gathered (``admit``) whether a lane finished or not.
    That is what the reference's traced ``while_loop`` costs a trip: its
    body, and the costlier branch of its refill ``lax.cond``. Its results
    equal the loop's where the count is the loop's own.
    """
    if lanes < 1:
        raise ValueError(f"lanes must be >= 1, got {lanes}")
    M, T = queue_pids.shape
    R1 = relax.ids.shape[1] + 1
    L = store.keys.shape[1]
    N = _seen_size(R1, L, cfg)
    max_iters = _max_iters(T, R1, L, cfg)
    Q = lanes
    trips_cap = M * max_iters + 2
    dev = store.keys.device

    def admit(idx):
        return ops.gather_streams(store, relax, queue_pids[idx],
                                  queue_masks[idx])

    ar = torch.arange(Q, device=dev)
    live0 = ar < M
    st = _init_state(Q, T, R1, N, cfg.k, dev)
    st.done = ~live0
    streams = admit(ar.clamp(max=max(M - 1, 0)))
    qidx = torch.where(live0, ar, M)
    next_idx = min(Q, M)
    out = dict(
        keys=torch.full((M + 1, cfg.k), PAD_KEY, dtype=torch.int32,
                        device=dev),
        scores=torch.full((M + 1, cfg.k), NEG_INF, dtype=torch.float32,
                          device=dev),
        **{f: torch.zeros((M + 1,), dtype=torch.int64, device=dev)
           for f in ("n_pulled", "n_answers", "n_iters", "n_wasted")})
    ones = torch.ones((Q,), dtype=torch.int64, device=dev)

    def trip(next_idx):
        """Step every lane, emit the lanes that finish, and return (the
        queue index each lane would take, whether it refills)."""
        live = ~st.done
        top_keys, top_scores, n_taken, n_cand, done = _step(streams, st,
                                                            cfg, N)
        # Freeze discipline: an idle lane's result-bearing fields stay put;
        # its merge state may move, nothing reads it.
        new_iters = st.n_iters + 1
        st.top_keys = torch.where(live[:, None], top_keys, st.top_keys)
        st.top_scores = torch.where(live[:, None], top_scores, st.top_scores)
        st.n_pulled = torch.where(live, st.n_pulled + n_taken, st.n_pulled)
        st.n_answers = torch.where(live, st.n_answers + n_cand,
                                   st.n_answers)
        st.n_iters = torch.where(live, new_iters, st.n_iters)
        st.done = st.done | done | (new_iters >= max_iters)

        # Emit the lanes that finished this trip at their queue index.
        finished = live & st.done
        tgt = torch.where(finished, qidx, M)
        out["keys"][tgt] = st.top_keys
        out["scores"][tgt] = st.top_scores
        out["n_pulled"][tgt] = st.n_pulled
        out["n_answers"][tgt] = st.n_answers
        out["n_iters"][tgt] = st.n_iters
        out["n_wasted"].index_add_(0, torch.where(live, M, qidx), ones)

        # Admit: the i-th finished lane (in lane order) takes queue entry
        # next_idx + i while entries remain; later finishers go idle.
        cand = next_idx + finished.long().cumsum(0) - 1
        return cand, finished & (cand < M)

    if trips is not None:
        init = _init_state(Q, T, R1, N, cfg.k, dev)
        for _ in range(trips):
            cand, refill = trip(next_idx)
            fresh = admit(cand.clamp(0, max(M - 1, 0)))
            for name in ops.MergedStreams._fields:
                cur = getattr(streams, name)
                where = refill.view(-1, *(1,) * (cur.dim() - 1))
                cur.copy_(torch.where(where, getattr(fresh, name), cur))
            _reset_where(st, refill, init)
            qidx = torch.where(refill, cand, qidx)
            next_idx = next_idx + refill.sum()
        return {name: t[:M] for name, t in out.items()}

    n_trips, go = 0, M > 0
    while go and n_trips < trips_cap:
        cand, refill = trip(next_idx)
        any_live, n_refill = torch.stack(
            [(~st.done).any().long(), refill.sum()]).tolist()
        if n_refill:
            idx = refill.nonzero()[:, 0]
            new_q = cand[idx]
            fresh = admit(new_q)
            for name in ops.MergedStreams._fields:
                getattr(streams, name)[idx] = getattr(fresh, name)
            _reset_lanes(st, idx)
            qidx[idx] = new_q
            next_idx += n_refill
        n_trips += 1
        go = bool(any_live) or n_refill > 0
    return {name: t[:M] for name, t in out.items()}


def _as_tensor(x, device) -> torch.Tensor:
    """A tensor on ``device`` from a tensor or (a copy of) array-like data."""
    if torch.is_tensor(x):
        return x.to(device)
    return torch.from_numpy(np.array(x)).to(device)


def _as_pids(x, device) -> torch.Tensor:
    return _as_tensor(x, device).long()


def execute_queue(store: TripleStore, relax: RelaxTable, queue_pids,
                  queue_masks, cfg: EngineConfig, lanes: int,
                  device=None, trips: int | None = None) -> EngineResult:
    """Execute an (M, T) query queue under precomputed (M, T, R) plans.

    The single funnel into ``_execute_refill`` (``trips``: its bounded
    count, None to run until every query is done). Returns an
    ``EngineResult`` whose fields carry a leading (M,) axis in queue order.
    """
    dev = resolve_device(device)
    check_on(dev, store.keys, relax.ids)
    pids = _as_pids(queue_pids, dev)
    masks = _as_tensor(queue_masks, dev).bool()
    out = _execute_refill(store, relax, pids, masks, cfg, lanes, trips)
    return EngineResult(
        keys=out["keys"], scores=out["scores"],
        n_pulled=out["n_pulled"].int(), n_answers=out["n_answers"].int(),
        n_iters=out["n_iters"].int(), n_wasted=out["n_wasted"].int(),
        relax_mask=masks)


def plan_for_mode(store: TripleStore, relax: RelaxTable,
                  pattern_ids: torch.Tensor, cfg: EngineConfig,
                  mode: str) -> torch.Tensor:
    """The (..., T, R) relaxation masks for (..., T) queries under ``mode``
    ∈ {"trinit", "specqp", "specqp_pattern", "join_only"}."""
    R = relax.ids.shape[1]
    if mode == "trinit":
        return plangen.trinit_plan(pattern_ids, R).contiguous()
    if mode in ("specqp", "specqp_pattern"):
        mask = plangen.plan(store, relax, pattern_ids, cfg.k, cfg.grid_bins,
                            cfg.plan_slack, cfg.cardinality_mode)
        if mode == "specqp_pattern":
            mask = plangen.per_pattern_plan(mask).contiguous()
        return mask
    if mode == "join_only":
        return torch.zeros((*pattern_ids.shape, R), dtype=torch.bool,
                           device=pattern_ids.device)
    raise ValueError(mode)


def run_query(store: TripleStore, relax: RelaxTable, pattern_ids,
              cfg: EngineConfig, mode: str = "specqp",
              device=None) -> EngineResult:
    """Answer one star query: a depth-1 queue on one lane (``n_wasted`` is
    0 — the loop ends the trip the query finishes)."""
    dev = resolve_device(device)
    check_on(dev, store.keys, relax.ids)
    pids = _as_pids(pattern_ids, dev)[None]
    mask = plan_for_mode(store, relax, pids, cfg, mode)
    res = execute_queue(store, relax, pids, mask, cfg, lanes=1, device=dev)
    return EngineResult(**{f.name: getattr(res, f.name)[0]
                           for f in dataclasses.fields(res)})


def plan_query_batch(store, relax, pattern_ids_batch, cfg: EngineConfig,
                     mode: str = "specqp", device=None) -> torch.Tensor:
    """(Q, T, R) plans for a (Q, T) query batch — the serving layer's plan
    phase, batched over queries."""
    dev = resolve_device(device)
    check_on(dev, store.keys, relax.ids)
    return plan_for_mode(store, relax, _as_pids(pattern_ids_batch, dev), cfg,
                         mode)


def run_query_batch_with_masks(store, relax, pattern_ids_batch, masks,
                               cfg: EngineConfig, device=None,
                               trips: int | None = None) -> EngineResult:
    """Fixed batch under precomputed plans: one lane per queue entry."""
    Q = len(pattern_ids_batch)
    return execute_queue(store, relax, pattern_ids_batch, masks, cfg,
                         lanes=Q, device=device, trips=trips)


def run_query_batch(store, relax, pattern_ids_batch, cfg: EngineConfig,
                    mode: str = "specqp", device=None) -> EngineResult:
    """Plan and answer a (Q, T) batch (fixed-batch configuration)."""
    masks = plan_query_batch(store, relax, pattern_ids_batch, cfg, mode,
                             device)
    return run_query_batch_with_masks(store, relax, pattern_ids_batch, masks,
                                      cfg, device)


def run_query_stream_with_masks(store, relax, pattern_ids_queue, masks,
                                cfg: EngineConfig, lanes: int = 8,
                                device=None) -> EngineResult:
    """Serve an (M, T) queue under precomputed plans through ``lanes``
    continuous-refill lanes."""
    return execute_queue(store, relax, pattern_ids_queue, masks, cfg, lanes,
                         device)


def run_query_stream(store, relax, pattern_ids_queue, cfg: EngineConfig,
                     mode: str = "specqp", lanes: int = 8,
                     device=None) -> EngineResult:
    """Plan and stream-execute an (M, T) query queue."""
    masks = plan_query_batch(store, relax, pattern_ids_queue, cfg, mode,
                             device)
    return run_query_stream_with_masks(store, relax, pattern_ids_queue,
                                       masks, cfg, lanes, device)


def naive_full_scan(store: TripleStore, relax: RelaxTable, pattern_ids,
                    k: int, n_entities: int, relax_mask=None, device=None):
    """Exact oracle: materialize every relaxed answer and sort.

    Per pattern, an answer key's contribution is the max weighted score over
    {original} ∪ relaxations. ``relax_mask`` optionally disables
    relaxations: (T, R) per relaxation or (T,) per pattern. Returns
    (keys (k,) int32, scores (k,) f32).
    """
    dev = resolve_device(device)
    check_on(dev, store.keys, relax.ids)
    pids = _as_pids(pattern_ids, dev)
    T = pids.shape[0]
    R = relax.ids.shape[1]
    active = pids != PAD_KEY
    safe = torch.where(active, pids, 0)
    if relax_mask is None:
        relax_mask = torch.ones((T, R), dtype=torch.bool, device=dev)
    else:
        relax_mask = _as_tensor(relax_mask, dev).bool()
        if relax_mask.dim() == 1:
            relax_mask = relax_mask[:, None].expand(T, R)
    best_t, present_t = [], []
    for t in range(T):
        rel_ids = torch.where(relax_mask[t], relax.ids[safe[t]].long(),
                              PAD_KEY)
        src_ids = torch.cat([safe[t, None],
                             torch.where(rel_ids == PAD_KEY, 0, rel_ids)])
        weights = torch.cat([torch.ones(1, device=dev),
                             relax.weights[safe[t]]])
        src_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                            rel_ids != PAD_KEY])
        best = torch.full((n_entities,), NEG_INF, device=dev)
        present = torch.zeros((n_entities,), device=dev)
        for r in range(R + 1):
            keys = store.keys[src_ids[r]].long()
            sc = store.scores[src_ids[r]] * weights[r]
            ok = (keys != PAD_KEY) & src_ok[r] & (keys < n_entities)
            idx = torch.where(ok, keys, 0)
            best.scatter_reduce_(0, idx, torch.where(ok, sc, NEG_INF), "amax")
            present.scatter_reduce_(0, idx, ok.float(), "amax")
        present = present > 0
        best_t.append(torch.where(present, best, NEG_INF))
        present_t.append(present)
    best_t, present_t = torch.stack(best_t), torch.stack(present_t)
    all_present = (present_t | ~active[:, None]).all(0)
    total = _sum_seq(torch.where(active[:, None], torch.where(
        present_t, best_t, 0.0), 0.0), 0)
    total = torch.where(all_present, total, NEG_INF)
    top_s, top_i = torch.sort(total, descending=True, stable=True)
    top_s, top_i = top_s[:k], top_i[:k]
    top_keys = torch.where(top_s > NEG_INF, top_i, PAD_KEY).int()
    return top_keys, top_s
