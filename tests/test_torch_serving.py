"""The port's serving layer: batched results equal sequential run_query."""
import numpy as np
import pytest
import torch

from conftest import small_workload, TEST_GRID_BINS
from repro.core.types import EngineConfig as JConfig
from repro.launch import batching as jbatching
from repro_torch import convert
from repro_torch.core import engine
from repro_torch.core.types import EngineConfig
from repro_torch.launch import batching, serve

# Small tensors: one intra-op thread per test worker keeps the workers of
# a parallel test run from spinning on each other's cores.
torch.set_num_threads(1)

CFG = EngineConfig(block=16, k=5, grid_bins=TEST_GRID_BINS)


@pytest.fixture(scope="module")
def workload():
    wl = small_workload(seed=0, n_queries=8)
    arrays = {f: np.asarray(getattr(wl.store, f)) for f in
              ("keys", "scores", "lengths", "sorted_keys", "stats",
               "sketch")}
    store = convert.store_from_numpy(**arrays, device="cpu")
    relax = convert.relax_from_numpy(np.asarray(wl.relax.ids),
                                     np.asarray(wl.relax.weights),
                                     device="cpu")
    # Ragged queue with repeats, as serving sees it.
    rng = np.random.default_rng(1)
    queries = [wl.queries[i] for i in rng.choice(len(wl.queries), 11)]
    return wl, store, relax, queries


def _bcfg(refill: bool) -> batching.BatchingConfig:
    return batching.BatchingConfig(max_batch=4, q_buckets=(1, 4, 8),
                                   t_buckets=(2, 3), refill=refill, lanes=3,
                                   refill_depth=8)


@pytest.mark.parametrize("refill", [True, False])
def test_batch_executor_equals_sequential(workload, refill):
    _, store, relax, queries = workload
    ex = batching.BatchExecutor(store, relax, CFG, "specqp", _bcfg(refill),
                                device="cpu")
    served = ex.run(queries)
    assert ex.warmup() == 0
    for i, (q, r) in enumerate(zip(queries, served)):
        want = engine.run_query(store, relax, q, CFG, "specqp", device="cpu")
        np.testing.assert_array_equal(r.keys, want.keys.numpy(),
                                      err_msg=f"request {i}")
        np.testing.assert_array_equal(r.scores, want.scores.numpy())
        for f in ("n_pulled", "n_answers", "n_iters"):
            assert getattr(r, f) == int(getattr(want, f)), (i, f)
        np.testing.assert_array_equal(
            r.relax_mask, want.relax_mask.numpy()[:r.relax_mask.shape[0]])
    assert sum(s.n_requests for s in ex.stats) == len(queries)
    assert 0.0 <= ex.wasted_fraction() < 1.0


def test_refill_executor_matches_jax_executor(workload):
    """Same groups, same LPT admission order, same drain accounting: the
    per-request n_wasted and the wasted fraction equal the JAX layer's."""
    wl, store, relax, queries = workload
    jcfg = JConfig(block=16, k=5, grid_bins=TEST_GRID_BINS)
    b = _bcfg(True)
    jex = jbatching.BatchExecutor(
        wl.store, wl.relax, jcfg, "specqp",
        jbatching.BatchingConfig(max_batch=b.max_batch, q_buckets=b.q_buckets,
                                 t_buckets=b.t_buckets, refill=True,
                                 lanes=b.lanes, refill_depth=b.refill_depth))
    ex = batching.BatchExecutor(store, relax, CFG, "specqp", b, device="cpu")
    want, got = jex.run(queries), ex.run(queries)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.keys, w.keys, err_msg=f"request {i}")
        np.testing.assert_allclose(g.scores, w.scores, rtol=1e-6)
        for f in ("n_pulled", "n_answers", "n_iters", "n_wasted",
                  "batch_size"):
            assert getattr(g, f) == getattr(w, f), (i, f)
    assert ex.wasted_fraction() == jex.wasted_fraction()


@pytest.mark.parametrize("kw", [
    dict(max_batch=0), dict(max_batch=128), dict(lanes=0),
    dict(refill_depth=0), dict(refill=True, max_batch=16, refill_depth=8)])
def test_bad_batching_config_raises(kw):
    with pytest.raises(ValueError):
        batching.BatchingConfig(**kw)


def test_unported_options_raise(workload, capsys):
    """The options once refused (pipeline, --arrival-qps) now serve; bad
    values still raise."""
    _, store, relax, queries = workload
    bcfg = batching.BatchingConfig(max_batch=4, q_buckets=(1, 4, 8),
                                   t_buckets=(2, 3), pipeline=True)
    ex = batching.BatchExecutor(store, relax, CFG, "specqp", bcfg,
                                device="cpu")
    for i, (q, r) in enumerate(zip(queries, ex.run(queries))):
        want = engine.run_query(store, relax, q, CFG, "specqp", device="cpu")
        np.testing.assert_array_equal(r.keys, want.keys.numpy(),
                                      err_msg=f"request {i}")
    with pytest.raises(ValueError):
        batching.BatchExecutor(store, relax, CFG, "bogus", device="cpu")
    serve.main(["--device", "cpu", "--arrival-qps", "50", "--list-len", "48",
                "--n-queries", "4", "--block", "16", "--k", "5",
                "--grid-bins", "96", "--max-batch", "4"])
    assert "online λ=50/s" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--arrival-qps", "0"])
    assert batching.bucket_for(3, (1, 4, 16)) == 4
    assert batching.default_t_buckets(3) == (2, 4)


def test_entry_points_without_cuda_raise(workload, monkeypatch):
    """No device given and no CUDA: every entry point raises."""
    wl, store, relax, queries = workload
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.run_query(store, relax, queries[0], CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.execute_queue(store, relax, wl.queries[:1],
                             np.ones((1, 3, 3), bool), CFG, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        batching.BatchExecutor(store, relax, CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--list-len", "48", "--n-queries", "2"])


def test_serve_cli_on_cpu(capsys):
    serve.main(["--device", "cpu", "--list-len", "48", "--n-queries", "6",
                "--block", "16", "--k", "5", "--grid-bins", "96",
                "--max-batch", "4", "--lanes", "2", "--refill-depth", "8"])
    out = capsys.readouterr().out
    assert "sequential" in out and "batched" in out and "QPS" in out
