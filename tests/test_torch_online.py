"""The port's online serving: the pipelined plan/execute path, the threaded
MicroBatcher and the Poisson replay of ``launch.serve``.

Serving is a pure throughput transform: every request's keys, scores,
``n_pulled``, ``n_answers`` and ``n_iters`` equal those of the port's
``engine.run_query`` on the same query, in both cardinality modes, and
every future resolves. The workload is the shared small geometry
(``conftest.small_workload``), built by the port's own generator, which is
bit-equal to the JAX one (``tests/test_torch_ingest.py``).
"""
import dataclasses
import functools
import sys
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from conftest import TEST_GRID_BINS, TEST_LIST_LEN, TEST_N_ENTITIES
from repro_torch.core import engine
from repro_torch.core.types import EngineConfig
from repro_torch.data import kg_synth
from repro_torch.launch import batching, serve

# Small tensors: one intra-op thread per test worker keeps the workers of
# a parallel test run from spinning on each other's cores.
torch.set_num_threads(1)

CFG = EngineConfig(block=16, k=5, grid_bins=TEST_GRID_BINS)
CARD_MODES = ("exact", "sketch")


@functools.lru_cache(maxsize=None)
def _workload(seed=0):
    return kg_synth.tiny_workload(seed=seed, n_queries=8,
                                  n_entities=TEST_N_ENTITIES,
                                  list_len=TEST_LIST_LEN, n_relax=3,
                                  device="cpu")


def _cfg(card="exact"):
    return dataclasses.replace(CFG, cardinality_mode=card)


def _executor(wl, mode="specqp", cfg=CFG, **kw):
    kw = dict(dict(max_batch=4, max_wait_s=0.01, q_buckets=(1, 4, 8),
                   t_buckets=(2, 3)), **kw)
    return batching.BatchExecutor(wl.store, wl.relax, cfg, mode,
                                  batching.BatchingConfig(**kw),
                                  device="cpu")


def _refill_executor(wl, mode="specqp", lanes=2, pipeline=False, cfg=CFG):
    return _executor(wl, mode, cfg, refill=True, lanes=lanes,
                     refill_depth=8, pipeline=pipeline)


def _assert_equal_single(wl, queries, served, mode="specqp", cfg=CFG):
    """Each served request equals run_query on its query."""
    assert len(served) == len(queries)
    for i, (q, r) in enumerate(zip(queries, served)):
        want = engine.run_query(wl.store, wl.relax, q, cfg, mode,
                                device="cpu")
        np.testing.assert_array_equal(r.keys, want.keys.numpy(),
                                      err_msg=f"request {i} keys")
        np.testing.assert_array_equal(r.scores, want.scores.numpy(),
                                      err_msg=f"request {i} scores")
        for f in ("n_pulled", "n_answers", "n_iters"):
            assert getattr(r, f) == int(getattr(want, f)), (i, f)
        np.testing.assert_array_equal(
            r.relax_mask, want.relax_mask.numpy()[:r.relax_mask.shape[0]])


@pytest.mark.parametrize("card", CARD_MODES)
def test_refill_pipe_equals_single_and_oracle(card):
    """The refill_pipe executor of tests/test_executor_equiv.py: a ragged
    queue of 8 (duplicates, mixed T) over 3 lanes, refill + pipeline,
    equals run_query and the full-scan oracle under each request's plan."""
    wl = _workload()
    idxs = np.random.default_rng(1).choice(len(wl.queries), 8)
    queries = [wl.queries[i] for i in idxs]
    t_set = tuple(sorted({int((q >= 0).sum()) for q in queries}))
    ex = _executor(wl, cfg=_cfg(card), t_buckets=t_set, refill=True,
                   lanes=3, refill_depth=8, pipeline=True)
    served = ex.run(queries)
    _assert_equal_single(wl, queries, served, cfg=_cfg(card))
    for i, (q, r) in enumerate(zip(queries, served)):
        mask = np.zeros((len(q), wl.relax.ids.shape[1]), bool)
        mask[:r.relax_mask.shape[0]] = r.relax_mask
        bk, bs = engine.naive_full_scan(wl.store, wl.relax, q, CFG.k,
                                        wl.n_entities, relax_mask=mask,
                                        device="cpu")
        np.testing.assert_array_equal(r.keys, bk.numpy(),
                                      err_msg=f"oracle keys {i}")
        np.testing.assert_allclose(r.scores, bs.numpy(), rtol=1e-5)


@pytest.mark.parametrize("card", CARD_MODES)
@pytest.mark.parametrize("refill", [False, True])
def test_pipeline_equals_unpipelined(refill, card):
    """test_refill.py's pipeline case, and the fixed-batch path: the
    double-buffered path serves what the unpipelined one serves."""
    wl = _workload(2)
    queries = list(wl.queries)
    make = (functools.partial(_refill_executor, wl, cfg=_cfg(card))
            if refill else functools.partial(_executor, wl, cfg=_cfg(card)))
    piped = make(pipeline=True).run(queries)
    plain = make(pipeline=False).run(queries)
    _assert_equal_single(wl, queries, piped, cfg=_cfg(card))
    for a, b in zip(piped, plain):
        np.testing.assert_array_equal(a.keys, b.keys)
        assert a.n_iters == b.n_iters


@pytest.mark.parametrize("refill", [False, True])
def test_microbatcher_threaded_equivalence(refill):
    """Futures from the threaded queue resolve to per-query results, over
    fixed micro-batches and over a refill executor."""
    wl = _workload()
    queries = list(wl.queries)
    ex = _refill_executor(wl) if refill else _executor(wl)
    with batching.MicroBatcher(ex) as mb:
        futs = [mb.submit(q) for q in queries]
        results = [f.result(timeout=120) for f in futs]
    _assert_equal_single(wl, queries, results)
    assert sum(s.n_requests for s in ex.stats) == len(queries)


def test_microbatcher_survives_bad_request():
    """A query past the largest T bucket fails its own future with the
    bucketing error; the worker lives on and later submits resolve."""
    wl = _workload()
    ex = _executor(wl, "join_only")       # t_buckets=(2, 3)
    good = wl.queries[0]
    with batching.MicroBatcher(ex) as mb:
        bad_fut = mb.submit(np.arange(5, dtype=np.int32))
        with pytest.raises(ValueError):
            bad_fut.result(timeout=120)
        r = mb.submit(good).result(timeout=120)
    _assert_equal_single(wl, [good], [r], "join_only")


def test_microbatcher_close_drains_pending():
    """close() resolves every future submitted before or racing with it —
    with a result or the closed-rejection — and is idempotent; a submit
    after close fails at once."""
    wl = _workload()
    ex = _executor(wl, "join_only")
    mb = batching.MicroBatcher(ex)
    q = wl.queries[0]
    futs, stop = [], threading.Event()

    def submitter():
        while not stop.is_set():
            futs.append(mb.submit(q))
            time.sleep(0.0005)     # a backlog, not thousands of requests

    th = threading.Thread(target=submitter)
    th.start()
    deadline = time.perf_counter() + 60
    while len(futs) < 8 and time.perf_counter() < deadline:
        time.sleep(0.001)          # let a backlog build behind the worker
    assert len(futs) >= 8
    mb.close()                     # races with in-flight submits
    stop.set()
    th.join(timeout=60)
    assert not th.is_alive()
    mb.close()                     # idempotent
    want = engine.run_query(wl.store, wl.relax, q, CFG, "join_only",
                            device="cpu").keys.numpy()
    n_served = 0
    for f in futs:
        assert f.done(), "future left unresolved after close()"
        if f.exception() is None:
            np.testing.assert_array_equal(f.result().keys, want)
            n_served += 1
        else:
            assert isinstance(f.exception(), RuntimeError)
    assert n_served >= 8           # the pre-close backlog was served
    late = mb.submit(q)
    assert late.done() and isinstance(late.exception(), RuntimeError)


def test_executor_stats_consistent_under_concurrency():
    """A pipelined run (the planner thread adds to plan_total_s while the
    main thread records groups) with a reader polling the totals, thread
    switches every 10 µs: the running totals equal the per-group records."""
    wl = _workload()
    queries = list(wl.queries) * 2
    ex = _executor(wl, q_buckets=(1, 4), pipeline=True)
    errs, stop = [], threading.Event()

    def poller():
        try:
            while not stop.is_set():
                assert 0.0 <= ex.wasted_fraction() <= 1.0
                assert ex.plan_total_s >= 0.0
        except Exception as e:  # noqa: BLE001 — surface on the main thread
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    th = threading.Thread(target=poller)
    th.start()
    try:
        results = ex.run(queries)
    finally:
        stop.set()
        th.join(timeout=60)
        sys.setswitchinterval(old)
    assert not th.is_alive() and not errs, errs
    _assert_equal_single(wl, queries, results)
    assert ex._useful_total == sum(s.useful_iters for s in ex.stats)
    assert ex._wasted_total == sum(s.wasted_iters for s in ex.stats)
    assert ex.plan_total_s > 0.0   # the planner thread's time was kept
    ex.reset_stats()
    assert ex.plan_total_s == 0.0 and ex.wasted_fraction() == 0.0


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(min_value=0, max_value=5),
       n=st.integers(min_value=1, max_value=10),
       lanes=st.sampled_from((1, 2, 4)),
       mode=st.sampled_from(("specqp", "trinit", "join_only")),
       pipeline=st.booleans())
def test_refill_executor_ragged_arrivals_property(seed, n, lanes, mode,
                                                  pipeline):
    """Random ragged arrival orders (duplicates, n not tied to the lane
    count) through the bucketed refill executor, pipelined or not, equal
    per-query run_query."""
    wl = _workload()
    idxs = np.random.default_rng(seed).choice(len(wl.queries), size=n)
    queries = [wl.queries[i] for i in idxs]
    ex = _refill_executor(wl, mode, lanes=lanes, pipeline=pipeline)
    _assert_equal_single(wl, queries, ex.run(queries), mode)


@pytest.mark.parametrize("card", CARD_MODES)
def test_poisson_replay_equals_single(card):
    """serve.serve_online: every future resolves to run_query's result,
    and each latency runs from submit to resolution."""
    wl = _workload(1)
    queries = list(wl.queries)
    ex = _refill_executor(wl, lanes=3, cfg=_cfg(card))
    results, wall, lat = serve.serve_online(ex, queries, 200.0, seed=0)
    _assert_equal_single(wl, queries, results, cfg=_cfg(card))
    assert lat.shape == (len(queries),) and (lat > 0).all()
    assert wall >= lat.max()


@pytest.mark.parametrize("flags", [["--arrival-qps", "40"], ["--pipeline"],
                                   ["--pipeline", "--no-refill"]])
def test_serve_cli_online_and_pipeline(flags, capsys):
    serve.main(["--device", "cpu", "--list-len", "48", "--n-queries", "5",
                "--block", "16", "--k", "5", "--grid-bins", "96",
                "--max-batch", "4", "--lanes", "2", "--refill-depth", "8"]
               + flags)
    out = capsys.readouterr().out
    assert "sequential" in out and "QPS" in out
    assert ("online λ=40/s" in out) == ("--arrival-qps" in flags)
    assert ("pipeline" in out.splitlines()[0]) == ("--pipeline" in flags)
