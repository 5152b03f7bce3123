"""The port's executor vs the JAX engine, on the very same stores.

Keys and the counters n_pulled / n_answers / n_iters / n_wasted must be
exact; scores are held to rtol 1e-6. The JAX store is carried into the port
through ``repro_torch.convert``, so both engines read identical arrays.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import small_workload, TEST_GRID_BINS
from harness import ring_kg
from repro.core import engine as je, operators as jops
from repro.core.types import EngineConfig as JConfig
from repro_torch import convert
from repro_torch.core import engine, operators as ops
from repro_torch.core.types import EngineConfig

# Small tensors: one intra-op thread per test worker keeps the workers of
# a parallel test run from spinning on each other's cores.
torch.set_num_threads(1)

CFG = EngineConfig(block=16, k=5, grid_bins=TEST_GRID_BINS)
JCFG = JConfig(block=16, k=5, grid_bins=TEST_GRID_BINS)
COUNTERS = ("n_pulled", "n_answers", "n_iters", "n_wasted")


def _port(store, relax):
    arrays = {f: np.asarray(getattr(store, f)) for f in
              ("keys", "scores", "lengths", "sorted_keys", "stats",
               "sketch")}
    return (convert.store_from_numpy(**arrays, device="cpu"),
            convert.relax_from_numpy(np.asarray(relax.ids),
                                     np.asarray(relax.weights),
                                     device="cpu"))


def assert_same(got, want, ctx="", mask=True):
    np.testing.assert_array_equal(got.keys.numpy(), np.asarray(want.keys),
                                  err_msg=f"{ctx} keys")
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6, err_msg=f"{ctx} scores")
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{ctx} {f}")
    if mask:
        np.testing.assert_array_equal(got.relax_mask.numpy(),
                                      np.asarray(want.relax_mask),
                                      err_msg=f"{ctx} relax_mask")


@pytest.fixture(scope="module", params=[0, 1, 2])
def workload(request):
    wl = small_workload(seed=request.param, n_queries=8)
    return wl, *_port(wl.store, wl.relax)


@pytest.mark.parametrize("mode", ["trinit", "specqp", "specqp_pattern",
                                  "join_only"])
def test_run_query_matches_jax(workload, mode):
    wl, store, relax = workload
    for i, q in enumerate(wl.queries):
        got = engine.run_query(store, relax, q, CFG, mode, device="cpu")
        want = je.run_query(wl.store, wl.relax, jnp.asarray(q), JCFG, mode)
        assert_same(got, want, f"{mode} query {i}")


@pytest.mark.parametrize("lanes", [3, None])
def test_stream_and_fixed_batch_match_jax(workload, lanes):
    """Refill stream (lanes < M) and fixed batch (lanes = M) under the
    JAX planner's masks: every counter, n_wasted included, is exact."""
    wl, store, relax = workload
    queue = np.concatenate([wl.queries, wl.queries[::-1][:3]])
    jmasks = je.plan_query_batch(wl.store, wl.relax, jnp.asarray(queue),
                                 JCFG, "specqp")
    masks = np.asarray(jmasks)
    if lanes is None:
        got = engine.run_query_batch_with_masks(store, relax, queue, masks,
                                                CFG, device="cpu")
        want = je.run_query_batch_with_masks(wl.store, wl.relax,
                                             jnp.asarray(queue), jmasks,
                                             JCFG)
    else:
        got = engine.run_query_stream_with_masks(store, relax, queue, masks,
                                                 CFG, lanes, device="cpu")
        want = je.run_query_stream_with_masks(wl.store, wl.relax,
                                              jnp.asarray(queue), jmasks,
                                              JCFG, lanes)
    assert_same(got, want, f"lanes={lanes}")


def test_trinit_equals_naive_full_scan(workload):
    wl, store, relax = workload
    for i, q in enumerate(wl.queries):
        res = engine.run_query(store, relax, q, CFG, "trinit", device="cpu")
        bk, bs = engine.naive_full_scan(store, relax, q, CFG.k,
                                        wl.n_entities, device="cpu")
        jk, js = je.naive_full_scan(wl.store, wl.relax, jnp.asarray(q),
                                    CFG.k, wl.n_entities)
        np.testing.assert_array_equal(bk.numpy(), np.asarray(jk))
        np.testing.assert_allclose(bs.numpy(), np.asarray(js), rtol=1e-6)
        np.testing.assert_array_equal(res.keys.numpy(), bk.numpy(),
                                      err_msg=f"query {i}")
        np.testing.assert_allclose(res.scores.numpy(), bs.numpy(),
                                   rtol=1e-5, err_msg=f"query {i}")


@pytest.mark.parametrize("seen_cap", [16, 20])
def test_ring_wrap_matches_jax_and_oracle(seen_cap):
    """harness.ring_kg: stream 0 wraps a tiny seen ring ≥ 2×; the port
    equals the JAX engine and the full-scan oracle, single and refill."""
    jstore, jrelax = ring_kg()
    store, relax = _port(jstore, jrelax)
    cfg = EngineConfig(block=8, k=5, grid_bins=TEST_GRID_BINS,
                       seen_cap=seen_cap)
    jcfg = JConfig(block=8, k=5, grid_bins=TEST_GRID_BINS, seen_cap=seen_cap)
    q = np.array([0, 1], np.int32)
    got = engine.run_query(store, relax, q, cfg, "trinit", device="cpu")
    assert_same(got, je.run_query(jstore, jrelax, jnp.asarray(q), jcfg,
                                  "trinit"), "single")
    assert int(got.n_pulled) >= 3 * seen_cap
    bk, _ = engine.naive_full_scan(store, relax, q, 5, 6000, device="cpu")
    np.testing.assert_array_equal(got.keys.numpy(), bk.numpy())
    queue = np.array([[0, 1], [0, 1], [2, 1], [0, 1], [2, 1], [0, 1]],
                     np.int32)
    masks = np.ones((6, 2, 1), bool)
    got = engine.run_query_stream_with_masks(store, relax, queue, masks, cfg,
                                             2, device="cpu")
    want = je.run_query_stream_with_masks(jstore, jrelax, jnp.asarray(queue),
                                          jnp.asarray(masks), jcfg, 2)
    assert_same(got, want, "refill")


def test_operators_match_jax():
    """pull_block (cursor advance under ties), dedup_block, topk_insert and
    merged_head_score against the JAX operators, lane by lane."""
    rng = np.random.default_rng(7)
    Q, R1, L, B, k = 3, 4, 24, 8, 5
    keys = rng.integers(0, 30, (Q, R1, L)).astype(np.int32)
    scores = -np.sort(-(rng.integers(0, 6, (Q, R1, L)) / 6.0), -1)
    scores = scores.astype(np.float32)
    lengths = rng.integers(0, L + 1, (Q, R1))
    cursors = np.minimum(rng.integers(0, L, (Q, R1)), lengths)
    bk, bs, nc = ops.pull_block(torch.from_numpy(keys),
                                torch.from_numpy(scores),
                                torch.from_numpy(lengths),
                                torch.from_numpy(cursors), B)
    dk, ds = ops.dedup_block(bk, bs)
    buf_k = torch.from_numpy(rng.integers(0, 30, (Q, k)).astype(np.int32))
    buf_s = torch.from_numpy(np.full((Q, k), 0.5, np.float32))
    tk, ts = ops.topk_insert(buf_k, buf_s, dk, ds, k)
    head = ops.merged_head_score(torch.from_numpy(keys),
                                 torch.from_numpy(scores),
                                 torch.from_numpy(lengths),
                                 torch.from_numpy(cursors))
    for g in range(Q):
        jk, js, jc = jops.pull_block(jnp.asarray(keys[g]),
                                     jnp.asarray(scores[g]),
                                     jnp.asarray(lengths[g], jnp.int32),
                                     jnp.asarray(cursors[g], jnp.int32), B)
        np.testing.assert_array_equal(bk[g].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(bs[g].numpy(), np.asarray(js))
        np.testing.assert_array_equal(nc[g].numpy(), np.asarray(jc))
        jdk, jds = jops.dedup_block(jk, js)
        np.testing.assert_array_equal(dk[g].numpy(), np.asarray(jdk))
        jtk, jts = jops.topk_insert(jnp.asarray(buf_k[g].numpy()),
                                    jnp.asarray(buf_s[g].numpy()), jdk, jds,
                                    k)
        np.testing.assert_array_equal(tk[g].numpy(), np.asarray(jtk))
        np.testing.assert_array_equal(ts[g].numpy(), np.asarray(jts))
        assert float(head[g]) == float(jops.merged_head_score(
            jnp.asarray(keys[g]), jnp.asarray(scores[g]),
            jnp.asarray(lengths[g], jnp.int32),
            jnp.asarray(cursors[g], jnp.int32)))


def test_engine_passes_kernel_argument_checks(workload, monkeypatch):
    """Every launch the executor makes meets the CUDA wrappers' checks on
    dtype, shape and contiguity (run here on the plain versions), in the
    single-lane, refill and fixed-batch configurations."""
    from repro_torch.kernels import ops as kops, ref as kref
    from repro_torch.kernels import rank_join, merge_topk
    calls = {"rank_join_lookup": 0, "merge_topk": 0}

    def lookup(*args):
        rank_join.check_args(*args)
        calls["rank_join_lookup"] += 1
        return kref.rank_join_lookup(*args)

    def merge(wk, ws, block):
        merge_topk.check_args(wk, ws, block)
        calls["merge_topk"] += 1
        return kref.merge_topk(wk, ws, block)

    wl, store, relax = workload
    monkeypatch.setattr(kops, "rank_join_lookup", lookup)
    monkeypatch.setattr(kops, "merge_topk", merge)
    engine.run_query(store, relax, wl.queries[0], CFG, "trinit", device="cpu")
    engine.run_query_stream(store, relax, wl.queries, CFG, "specqp", lanes=3,
                            device="cpu")
    engine.run_query_batch(store, relax, wl.queries[:4], CFG, "trinit",
                           device="cpu")
    assert calls["rank_join_lookup"] > 0 and calls["merge_topk"] > 0


def test_argmax_tie_takes_first_stream():
    """Every pattern's top normalized score is 1.0, so the first trip of
    every query ties; t* must be the first maximum, as jnp.argmax gives."""
    nxt = torch.tensor([[0.5, 1.0, 1.0, 1.0], [-np.inf] * 4])
    assert nxt.argmax(-1).tolist() == [1, 0]
    assert int(jnp.argmax(jnp.asarray([0.5, 1.0, 1.0, 1.0]))) == 1


def test_execute_queue_rejects_bad_lanes_and_devices(workload):
    wl, store, relax = workload
    q = wl.queries[:2]
    masks = np.ones((2, q.shape[1], relax.ids.shape[1]), bool)
    with pytest.raises(ValueError):
        engine.execute_queue(store, relax, q, masks, CFG, 0, device="cpu")
    with pytest.raises(ValueError):
        engine.execute_queue(store, relax, q, masks, CFG, 1, device="meta")
