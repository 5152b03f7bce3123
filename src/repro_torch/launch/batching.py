"""Batched serving layer: shape buckets, the batch executor, the request
queue.

Counterpart of ``repro.launch.batching``. Requests' ``(T,)`` pattern
vectors are padded up to T buckets and batches up to Q buckets, as in the
JAX package; eager PyTorch compiles nothing per shape, but the same padding
keeps every per-request result — ``n_wasted`` drain accounting on pad queue
entries included — equal to the reference's. ``BatchExecutor`` plans a
group, composes execution groups by planned work, and runs them through the
engine's one executor loop: fixed micro-batches (lanes = Q) or the
continuous-refill stream (lanes < M) with ``BatchingConfig.refill``. With
``BatchingConfig.pipeline`` a planner thread plans group i+1 on a CUDA
stream of its own while group i executes. ``MicroBatcher`` is the threaded
request queue in front of an executor: it flushes a group when
``max_batch`` requests wait or the oldest has waited ``max_wait_s``.

Correctness contract: per-request results are element-wise identical to
``engine.run_query`` on the unpadded query.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.types import (EngineConfig, PAD_KEY, resolve_device,
                                    check_on)


def bucket_for(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket ≥ n (buckets sorted ascending)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds the largest bucket {buckets[-1]}")


def default_t_buckets(t_max: int) -> tuple[int, ...]:
    """Powers of two from 2 up to a power-of-two cover of t_max."""
    out, b = [], 2
    while b < max(t_max, 2):
        out.append(b)
        b *= 2
    out.append(b)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class BatchingConfig:
    """Serving-layer knobs (engine knobs live in EngineConfig)."""

    max_batch: int = 16            # flush threshold / largest micro-batch
    max_wait_s: float = 0.002      # oldest queued request's longest wait
    q_buckets: tuple[int, ...] = (1, 4, 16, 64)
    t_buckets: tuple[int, ...] | None = None
    refill: bool = False           # continuous-refill configuration
    lanes: int | None = None       # lanes for refill (None → max_batch)
    refill_depth: int = 64         # queue entries per streaming call
    # Plan group i+1 on a planner thread while group i executes.
    pipeline: bool = False

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_batch > max(self.q_buckets):
            raise ValueError(
                f"q_buckets {self.q_buckets} must cover max_batch "
                f"{self.max_batch}")
        if self.lanes is not None and self.lanes < 1:
            raise ValueError(f"lanes must be >= 1 (or None), got {self.lanes}")
        if self.refill_depth < 1:
            raise ValueError(
                f"refill_depth must be >= 1, got {self.refill_depth}")
        if self.refill and self.refill_depth < self.max_batch:
            raise ValueError(
                "refill_depth must cover max_batch: "
                f"{self.refill_depth} < {self.max_batch}")


@dataclasses.dataclass(frozen=True)
class ServedResult:
    """Per-request view of one lane of a batched EngineResult."""

    keys: np.ndarray       # (k,) int32
    scores: np.ndarray     # (k,) f32
    n_pulled: int
    n_answers: int
    n_iters: int
    n_wasted: int          # lockstep trips this lane sat idle
    relax_mask: np.ndarray  # (T, R) for the request's true T
    batch_size: int        # real requests in the group served with


@dataclasses.dataclass
class BatchStats:
    """One record per executed group."""

    n_requests: int
    q_bucket: int
    t_bucket: int
    exec_s: float          # execute-phase wall time (plan_s separate)
    n_iters: int           # lockstep trips
    useful_iters: int      # sum over real lanes of per-lane n_iters
    wasted_iters: int      # idle lane-trips
    plan_s: float = 0.0


class BatchExecutor:
    """Synchronous bucketed batch execution against one store on one
    device (CUDA unless ``device`` names another)."""

    def __init__(self, store, relax, cfg: EngineConfig, mode: str = "specqp",
                 bcfg: BatchingConfig = BatchingConfig(), device=None):
        if mode not in engine.MODES:
            raise ValueError(f"unknown mode {mode!r}")
        self.device = resolve_device(device)
        check_on(self.device, store.keys, relax.ids)
        self.store = store
        self.relax = relax
        self.cfg = cfg
        self.mode = mode
        self.bcfg = bcfg
        # Stats are guarded by _lock so callers on other threads may read
        # them while a batch is recorded.
        self._lock = threading.Lock()
        self.stats: list[BatchStats] = []
        self.stats_cap = 4096
        self._plan_total_s = 0.0
        self._useful_total = 0
        self._wasted_total = 0
        # Host-side copies for the work scheduler (batch composition).
        self._lengths = store.lengths.cpu().numpy()
        self._rel_ids = relax.ids.cpu().numpy()

    def reset_stats(self) -> None:
        with self._lock:
            self.stats.clear()
            self._plan_total_s = 0.0
            self._useful_total = 0
            self._wasted_total = 0

    @property
    def plan_total_s(self) -> float:
        with self._lock:
            return self._plan_total_s

    def _t_bucket(self, t: int) -> int:
        if self.bcfg.t_buckets is not None:
            return bucket_for(t, self.bcfg.t_buckets)
        return bucket_for(t, default_t_buckets(max(t, 2)))

    def _lanes_n(self) -> int:
        return self.bcfg.lanes or self.bcfg.max_batch

    def _m_buckets(self) -> tuple[int, ...]:
        """Queue-depth pads for the streaming executor: the q buckets that
        fit, topped by refill_depth itself."""
        return tuple(sorted({b for b in self.bcfg.q_buckets
                             if b <= self.bcfg.refill_depth}
                            | {self.bcfg.refill_depth}))

    def _m_bucket(self, n: int) -> int:
        return bucket_for(n, self._m_buckets())

    @staticmethod
    def _true_t(q) -> int:
        return int((np.asarray(q) != PAD_KEY).sum())

    def _pad_group(self, group, t_b: int, q_b: int) -> torch.Tensor:
        batch = np.full((q_b, t_b), PAD_KEY, np.int32)
        for i, q in enumerate(group):
            q = np.asarray(q, np.int32)
            q = q[q != PAD_KEY]
            batch[i, :len(q)] = q
        return torch.from_numpy(batch).to(self.device)

    def warmup(self, t_buckets: tuple[int, ...] | None = None) -> int:
        """Nothing to compile ahead in eager PyTorch: returns 0."""
        return 0

    def _sync(self) -> None:
        """Wait for this thread's stream only: under the pipeline the
        planner's stream runs on, and must not be timed as execution."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def plan_group(self, group, q_b: int | None = None
                   ) -> tuple[list[np.ndarray], float]:
        """Plan phase: (T, R) masks per request, batched at bucket shapes."""
        t_b = self._t_bucket(max(self._true_t(q) for q in group))
        if q_b is None:
            q_b = bucket_for(len(group), self.bcfg.q_buckets)
        batch = self._pad_group(group, t_b, q_b)
        t0 = time.perf_counter()
        masks = engine.plan_query_batch(self.store, self.relax, batch,
                                        self.cfg, self.mode, self.device)
        masks = masks.cpu().numpy()
        dt = time.perf_counter() - t0
        with self._lock:
            self._plan_total_s += dt
        return [masks[i] for i in range(len(group))], dt

    def planned_work(self, q, mask: np.ndarray) -> int:
        """Pullable items under the plan: lengths of the enabled sources."""
        t = np.asarray(q)
        t = t[t != PAD_KEY]
        rel = self._rel_ids[t]                          # (T, R)
        on = mask[:len(t)] & (rel >= 0)
        return int(self._lengths[t].sum() +
                   self._lengths[np.where(rel >= 0, rel, 0)][on].sum())

    def _mask_batch(self, masks, q_b: int, t_b: int) -> torch.Tensor:
        R = self._rel_ids.shape[1]
        mask_b = np.zeros((q_b, t_b, R), bool)
        for i, m in enumerate(masks):
            mask_b[i, :min(m.shape[0], t_b)] = m[:t_b]
        return torch.from_numpy(mask_b).to(self.device)

    def _finish_batch(self, res, group, q_b: int, t_b: int, dt: float,
                      plan_s: float, trips: int, wasted: int | None = None
                      ) -> list[ServedResult]:
        """Unpad per-request results and record stats. ``wasted`` overrides
        the waste total (the refill path counts pad entries' drain too)."""
        keys = res.keys.cpu().numpy()
        scores = res.scores.cpu().numpy()
        mask = res.relax_mask.cpu().numpy()
        n_pulled = res.n_pulled.cpu().numpy()
        n_answers = res.n_answers.cpu().numpy()
        n_iters = res.n_iters.cpu().numpy()
        n_wasted = res.n_wasted.cpu().numpy()
        out = [ServedResult(
            keys=keys[i], scores=scores[i],
            n_pulled=int(n_pulled[i]), n_answers=int(n_answers[i]),
            n_iters=int(n_iters[i]), n_wasted=int(n_wasted[i]),
            relax_mask=mask[i, :self._true_t(q)],
            batch_size=len(group)) for i, q in enumerate(group)]
        useful = int(n_iters[:len(group)].sum())
        if wasted is None:
            wasted = int(n_wasted[:len(group)].sum())
        with self._lock:
            self._useful_total += useful
            self._wasted_total += wasted
            self.stats.append(BatchStats(
                n_requests=len(group), q_bucket=q_b, t_bucket=t_b,
                exec_s=dt, n_iters=trips, useful_iters=useful,
                wasted_iters=wasted, plan_s=plan_s))
            if len(self.stats) > self.stats_cap:
                del self.stats[:-self.stats_cap]
        return out

    def _plan_or_pad(self, batch, masks, q_b, t_b):
        if masks is not None:
            return self._mask_batch(masks, q_b, t_b), 0.0
        t0 = time.perf_counter()
        mask_b = engine.plan_query_batch(self.store, self.relax, batch,
                                         self.cfg, self.mode, self.device)
        self._sync()
        return mask_b, time.perf_counter() - t0

    def run_batch(self, group, masks=None) -> list[ServedResult]:
        """Serve one micro-batch of queries (≤ max_batch) as a fixed batch,
        or as a refill stream when ``BatchingConfig.refill`` is set."""
        if self.bcfg.refill:
            return self.run_stream(group, masks)
        if not 0 < len(group) <= self.bcfg.max_batch:
            raise ValueError(
                f"group size {len(group)} not in [1, {self.bcfg.max_batch}]")
        t_b = self._t_bucket(max(self._true_t(q) for q in group))
        q_b = bucket_for(len(group), self.bcfg.q_buckets)
        batch = self._pad_group(group, t_b, q_b)
        mask_b, plan_s = self._plan_or_pad(batch, masks, q_b, t_b)
        t0 = time.perf_counter()
        res = engine.run_query_batch_with_masks(
            self.store, self.relax, batch, mask_b, self.cfg, self.device)
        self._sync()
        dt = time.perf_counter() - t0
        trips = int(res.n_iters.max())
        return self._finish_batch(res, group, q_b, t_b, dt, plan_s, trips)

    def run_stream(self, group, masks=None) -> list[ServedResult]:
        """Serve one admission queue (≤ refill_depth queries) through the
        continuous-refill configuration of the executor."""
        if not 0 < len(group) <= self.bcfg.refill_depth:
            raise ValueError(
                f"queue size {len(group)} not in "
                f"[1, {self.bcfg.refill_depth}]")
        t_b = self._t_bucket(max(self._true_t(q) for q in group))
        m_b = self._m_bucket(len(group))
        batch = self._pad_group(group, t_b, m_b)
        mask_b, plan_s = self._plan_or_pad(batch, masks, m_b, t_b)
        # A lane beyond the queue depth would idle from its first trip.
        lanes = min(self._lanes_n(), m_b)
        t0 = time.perf_counter()
        res = engine.run_query_stream_with_masks(
            self.store, self.relax, batch, mask_b, self.cfg, lanes,
            self.device)
        self._sync()
        dt = time.perf_counter() - t0
        it_all = res.n_iters.cpu().numpy()
        w_all = res.n_wasted.cpu().numpy()
        trips = int(-(-(int(it_all.sum()) + int(w_all.sum())) // lanes))
        return self._finish_batch(res, group, m_b, t_b, dt, plan_s, trips,
                                  wasted=int(w_all.sum()))

    def _exec_cap(self) -> int:
        return (self.bcfg.refill_depth if self.bcfg.refill
                else self.bcfg.max_batch)

    def by_t_bucket(self, queries) -> list[list[int]]:
        """Request indices grouped by T bucket, buckets ascending, each in
        arrival order."""
        by_bucket: dict[int, list[int]] = {}
        for i, q in enumerate(queries):
            by_bucket.setdefault(self._t_bucket(self._true_t(q)), []).append(i)
        return [idxs for _, idxs in sorted(by_bucket.items())]

    def run(self, queries) -> list[ServedResult]:
        """Serve a request list offline: plan → schedule → execute.

        Per T bucket, plan in arrival order, then compose execution groups
        by planned work: ascending for fixed batches (similar-cost lanes
        share a lockstep loop), descending for refill (longest processing
        time first shrinks the end-of-queue drain). With
        ``BatchingConfig.pipeline`` planning overlaps execution instead
        (``_run_pipelined``). Results follow ``queries``' order.
        """
        if self.bcfg.pipeline:
            return self._run_pipelined(queries)
        out: list[ServedResult | None] = [None] * len(queries)
        serve = self.run_stream if self.bcfg.refill else self.run_batch
        exec_cap = self._exec_cap()
        chunk_cap = (self.bcfg.refill_depth if self.bcfg.refill
                     else bucket_for(self.bcfg.max_batch, self.bcfg.q_buckets))
        for idxs in self.by_t_bucket(queries):
            masks: dict[int, np.ndarray] = {}
            for c in range(0, len(idxs), chunk_cap):
                chunk = idxs[c:c + chunk_cap]
                q_b = (self._m_bucket(len(chunk)) if self.bcfg.refill
                       else None)
                ms, _ = self.plan_group([queries[j] for j in chunk], q_b)
                masks.update(zip(chunk, ms))
            idxs = sorted(idxs, key=lambda j: self.planned_work(
                queries[j], masks[j]), reverse=self.bcfg.refill)
            for c in range(0, len(idxs), exec_cap):
                chunk = idxs[c:c + exec_cap]
                rs = serve([queries[j] for j in chunk],
                           masks=[masks[j] for j in chunk])
                for j, r in zip(chunk, rs):
                    out[j] = r
        return out  # type: ignore[return-value]

    def _run_pipelined(self, queries) -> list[ServedResult]:
        """Double-buffered plan/execute: a planner thread plans execution
        group i+1 while group i executes.

        Groups follow arrival order: the planned-work sort of ``run`` needs
        every plan before the first execute, the very barrier the pipeline
        removes. On a card the planner queues its work on a CUDA stream of
        its own, so the executor's per-trip read-back waits on its own
        stream and not on the planner's queued kernels.
        """
        out: list[ServedResult | None] = [None] * len(queries)
        serve = self.run_stream if self.bcfg.refill else self.run_batch
        exec_cap = self._exec_cap()
        chunks = [idxs[c:c + exec_cap] for idxs in self.by_t_bucket(queries)
                  for c in range(0, len(idxs), exec_cap)]
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)

        def plan_for(chunk):
            q_b = (self._m_bucket(len(chunk)) if self.bcfg.refill
                   else bucket_for(len(chunk), self.bcfg.q_buckets))
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                return self.plan_group([queries[j] for j in chunk], q_b)[0]

        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="planner") as pool:
            fut = pool.submit(plan_for, chunks[0]) if chunks else None
            for c, chunk in enumerate(chunks):
                ms = fut.result()
                if c + 1 < len(chunks):
                    fut = pool.submit(plan_for, chunks[c + 1])
                rs = serve([queries[j] for j in chunk], masks=ms)
                for j, r in zip(chunk, rs):
                    out[j] = r
        return out  # type: ignore[return-value]

    def wasted_fraction(self) -> float:
        """Share of real-lane lockstep trips spent idle since the last
        ``reset_stats()``."""
        with self._lock:
            return self._wasted_total / max(
                self._useful_total + self._wasted_total, 1)


class MicroBatcher:
    """Threaded request queue in front of a BatchExecutor.

    ``submit`` returns a Future resolving to a ServedResult. A worker
    thread flushes a micro-batch when ``max_batch`` requests are queued or
    the oldest has waited ``max_wait_s``. Flushed requests are grouped by
    T bucket, one executor call per group. Use as a context manager, or
    call ``close()``.
    """

    _STOP = object()

    def __init__(self, executor: BatchExecutor):
        self.executor = executor
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, query) -> Future:
        """Enqueue one request. After ``close()`` the future fails at once
        with RuntimeError: no request is enqueued behind the stop mark."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                fut.set_exception(RuntimeError(
                    "MicroBatcher is closed; request rejected"))
                return fut
            self._q.put((np.asarray(query, np.int32), fut))
        return fut

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        """Stop accepting requests, serve everything queued, join the
        worker. Every future submitted before close() has resolved when it
        returns. Idempotent."""
        with self._lock:
            already = self._closed
            self._closed = True
            if not already:
                self._q.put(self._STOP)
        if self._thread.is_alive():
            self._thread.join()

    def _loop(self) -> None:
        bcfg = self.executor.bcfg
        while True:
            item = self._q.get()
            if item is self._STOP:
                self._drain_and_exit([])
                return
            pending = [item]
            deadline = time.perf_counter() + bcfg.max_wait_s
            while len(pending) < bcfg.max_batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is self._STOP:
                    self._drain_and_exit(pending)
                    return
                pending.append(nxt)
            self._flush(pending)

    def _drain_and_exit(self, pending) -> None:
        """Serve everything still queued at shutdown, so no future is left
        unresolved."""
        pending = list(pending)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not self._STOP:
                pending.append(item)
        cap = self.executor.bcfg.max_batch
        for c in range(0, len(pending), cap):
            self._flush(pending[c:c + cap])

    def _flush(self, pending) -> None:
        """Serve one flush group. Never raises: an error, from bucketing a
        malformed query or from the executor, goes to the futures it
        affects, and the worker thread lives on."""
        by_bucket: dict[int, list[tuple[np.ndarray, Future]]] = {}
        for q, fut in pending:
            try:
                t_b = self.executor._t_bucket(self.executor._true_t(q))
            except Exception as e:  # noqa: BLE001 — fail the request only
                fut.set_exception(e)
                continue
            by_bucket.setdefault(t_b, []).append((q, fut))
        for _, items in sorted(by_bucket.items()):
            try:
                results = self.executor.run_batch([q for q, _ in items])
                for (_, fut), r in zip(items, results):
                    fut.set_result(r)
            except Exception as e:  # noqa: BLE001 — fail the batch only
                for _, fut in items:
                    if not fut.done():
                        fut.set_exception(e)
