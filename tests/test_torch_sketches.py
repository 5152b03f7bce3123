"""The port's sketch planner against ``repro.core.sketches`` and PLANGEN.

Signature words and popcounts are integers and must match bit for bit.
The estimates invert ``exp`` by bisection, and ``torch.exp`` and XLA's
``exp`` round differently, so a bisection step near a branch may go the
other way: estimates are held within atol 4e-3 keys + rtol 1e-5. The
provably-empty zeros and the < 0.5 gate of ``round_joinability`` must be
exactly equal, and so must the sketch-mode (T, R) plans.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from conftest import small_workload, TEST_GRID_BINS
from repro.core import kg as jkg, plangen as jplan, sketches as jsk
from repro_torch import convert
from repro_torch.core import estimator, kg, plangen, sketches
from repro_torch.core.types import EngineConfig
from repro_torch.core import engine

# Small tensors: one intra-op thread per test worker keeps the workers of
# a parallel test run from spinning on each other's cores.
torch.set_num_threads(1)

ATOL, RTOL = 4e-3, 1e-5
K, G = 5, TEST_GRID_BINS
_j_cards = jax.jit(jax.vmap(jsk.sketch_cardinalities,
                            in_axes=(None, None, 0, 0)))
_j_joinable = jax.jit(jax.vmap(jsk.sketch_joinable_counts,
                               in_axes=(None, None, 0, 0)))
_j_inter = jax.jit(jax.vmap(jsk.intersection_size))
_j_union = jax.jit(jax.vmap(jsk.union_size))
_j_plan = jax.jit(jplan.plan, static_argnames=("k", "G", "sibling_slack",
                                               "cardinality_mode"))


def _port(jstore, jrelax):
    arrays = {f: np.asarray(getattr(jstore, f)) for f in
              ("keys", "scores", "lengths", "sorted_keys", "stats",
               "sketch")}
    return (convert.store_from_numpy(**arrays, device="cpu"),
            convert.relax_from_numpy(np.asarray(jrelax.ids),
                                     np.asarray(jrelax.weights),
                                     device="cpu"))


def _assert_estimates(got, want, ctx=""):
    """Estimates within tolerance; zeros and the < 0.5 gate exactly."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got == 0.0, want == 0.0,
                                  err_msg=f"{ctx} zeros")
    np.testing.assert_array_equal(got < 0.5, want < 0.5,
                                  err_msg=f"{ctx} round_joinability gate")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=f"{ctx} estimates")


@pytest.fixture(scope="module", params=[0, 1, 2])
def workload(request):
    wl = small_workload(seed=request.param, n_queries=8)
    return wl, *_port(wl.store, wl.relax)


def test_popcount_bit_equal():
    """SWAR popcount of int32-held words, sign bit set included."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=(3, 4, 257), dtype=np.uint64)
    words = words.astype(np.uint32)
    words[0, 0, :4] = (0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0)
    words[1, 2] |= np.uint32(0x80000000)
    t = torch.from_numpy(words.view(np.int32))
    np.testing.assert_array_equal(sketches._popcount(t).numpy(),
                                  np.bitwise_count(words))
    got = sketches._lane_popcounts(t).numpy()
    want = np.asarray(jsk._lane_popcounts(jnp.asarray(words)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _random_sets(rng, W, n_cases):
    """Per case 4 key lists, some sharing keys, some disjoint (keys moved
    past the others'), as a JAX store at width W, and per case the number
    of valid rows (1–4)."""
    lists = []
    for c in range(n_cases):
        common = rng.choice(4000, size=int(rng.integers(0, 80)),
                            replace=False)
        for _ in range(4):
            own = rng.choice(4000, size=int(rng.integers(5, 300)),
                             replace=False)
            keys = np.unique(np.concatenate([common, own]))
            if rng.random() < 0.2:
                keys = keys[:int(rng.integers(1, 40))] + 10_000
            lists.append((keys.astype(np.int32),
                          rng.random(len(keys)) + 0.1))
    store = jkg.build_store(lists, list_len=400, sketch_words=W)
    n_valid = rng.integers(1, 5, size=n_cases)
    return store, n_valid


@pytest.mark.parametrize("W", [128, 1024])
def test_intersection_and_union_sizes(W):
    rng = np.random.default_rng(W)
    n_cases = 48
    jstore, n_valid = _random_sets(rng, W, n_cases)
    sk = np.asarray(jstore.sketch).reshape(n_cases, 4, -1, W)
    sizes = np.asarray(jstore.lengths).reshape(n_cases, 4).astype(np.float32)
    valid = np.arange(4)[None] < n_valid[:, None]
    valid[::7, 0] = False                     # a hole in the valid rows
    valid[5] = False                          # no valid row
    t_sk = torch.from_numpy(sk.view(np.int32).copy())
    got = sketches.intersection_size(t_sk, torch.from_numpy(sizes),
                                     torch.from_numpy(valid))
    want = _j_inter(jnp.asarray(sk), jnp.asarray(sizes), jnp.asarray(valid))
    _assert_estimates(got, want, f"intersection W={W}")
    assert float(got[5]) == 0.0
    one = (valid.sum(1) == 1)
    np.testing.assert_array_equal(got.numpy()[one],
                                  (sizes * valid).sum(1)[one])
    got_u = sketches.union_size(t_sk, torch.from_numpy(valid))
    want_u = _j_union(jnp.asarray(sk), jnp.asarray(valid))
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u),
                               rtol=RTOL, atol=ATOL)


def test_sketch_cardinalities_and_joinable_counts(workload):
    wl, store, relax = workload
    q = torch.from_numpy(wl.queries).long()
    n, n_rel = sketches.sketch_cardinalities(store, relax, q, q != -1)
    jn, jn_rel = _j_cards(wl.store, wl.relax, jnp.asarray(wl.queries),
                          jnp.asarray(wl.queries != -1))
    _assert_estimates(n, jn, "n")
    _assert_estimates(n_rel, jn_rel, "n_rel")
    nj = sketches.sketch_joinable_counts(store, relax, q, q != -1)
    jnj = _j_joinable(wl.store, wl.relax, jnp.asarray(wl.queries),
                      jnp.asarray(wl.queries != -1))
    _assert_estimates(nj, jnj, "joinable")
    np.testing.assert_array_equal(
        sketches.round_joinability(nj).numpy(),
        np.where(nj.numpy() < 0.5, 0.0, nj.numpy()))
    # The estimator dispatches to the same functions.
    m_n, m_rel = estimator.cardinalities(store, relax, q, q != -1, "sketch")
    assert torch.equal(m_n, n) and torch.equal(m_rel, n_rel)
    assert torch.equal(
        estimator.joinability(store, relax, q, q != -1, "sketch"), nj)


def test_chunked_equals_unchunked(workload, monkeypatch):
    """Chunks of one query give bit-equal estimates."""
    wl, store, relax = workload
    q = torch.from_numpy(wl.queries).long()
    whole = sketches.sketch_joinable_counts(store, relax, q, q != -1)
    n, n_rel = sketches.sketch_cardinalities(store, relax, q, q != -1)
    monkeypatch.setattr(sketches, "CHUNK_WORDS", 1)
    assert torch.equal(
        sketches.sketch_joinable_counts(store, relax, q, q != -1), whole)
    assert torch.equal(
        sketches.sketch_cardinalities(store, relax, q, q != -1)[1], n_rel)


def test_sketch_plans_equal_jax(workload):
    wl, store, relax = workload
    q = torch.from_numpy(wl.queries).long()
    masks = plangen.plan(store, relax, q, K, G, None, "sketch")
    cfg = EngineConfig(block=16, k=K, grid_bins=G, cardinality_mode="sketch")
    assert torch.equal(engine.plan_for_mode(store, relax, q, cfg, "specqp"),
                       masks)
    agree = tot = 0
    for i, row in enumerate(wl.queries):
        jm = np.asarray(_j_plan(wl.store, wl.relax, jnp.asarray(row), K, G,
                                cardinality_mode="sketch"))
        np.testing.assert_array_equal(masks[i].numpy(), jm,
                                      err_msg=f"sketch plan of query {i}")
        exact = plangen.plan(store, relax, q[i], K, G).numpy()
        agree += int((exact == jm).sum())
        tot += jm.size
    # The reference's acceptance bar for sketch against exact plans.
    assert agree / tot >= 0.95, f"mask agreement {agree}/{tot}"


# ---------------------------------------------------------------------------
# Ports of tests/test_sketches.py's checks, on the port alone.
# ---------------------------------------------------------------------------

def _store_from(lists, list_len=None):
    return kg.build_store([(np.asarray(k, np.int32),
                            np.asarray(s, np.float64)) for k, s in lists],
                          list_len=list_len, device="cpu")


def _random_overlapping_lists(rng, n_sets, n_entities, shared, own_max):
    common = rng.choice(n_entities, size=shared, replace=False)
    lists = []
    for _ in range(n_sets):
        own = rng.choice(n_entities, size=int(rng.integers(5, own_max)),
                         replace=False)
        keys = np.unique(np.concatenate([common, own]))
        lists.append((keys, rng.random(len(keys)) + 0.1))
    return lists


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000),
       shared=st.integers(min_value=0, max_value=80),
       n_sets=st.integers(min_value=2, max_value=4))
def test_intersection_estimate_close_to_exact(seed, shared, n_sets):
    """|est − exact| within max(4, 25 % + sqrt noise) of the true size."""
    rng = np.random.default_rng(seed)
    lists = _random_overlapping_lists(rng, n_sets, 4000, shared, 400)
    store = _store_from(lists, list_len=512)
    pids = torch.arange(n_sets)[None]
    active = torch.ones((1, n_sets), dtype=torch.bool)
    exact = float(estimator.star_join_cardinality(store, pids, active)[0])
    est = float(sketches.intersection_size(
        store.sketch[pids], store.lengths[pids].float(), active)[0])
    tol = max(4.0, 0.25 * exact + np.sqrt(exact))
    assert abs(est - exact) <= tol, (exact, est)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_joinability_zero_is_truly_zero(seed):
    """A 0 joinable count from the raw sketch estimator is 0 exactly."""
    rng = np.random.default_rng(seed)
    base = rng.choice(1000, size=60, replace=False)
    lists = [(base, rng.random(60) + 0.1),
             (rng.choice(1000, size=40, replace=False), rng.random(40) + 0.1)]
    for _ in range(3):
        if rng.random() < 0.5:  # stray: disjoint from everything
            keys = 5000 + rng.choice(1000, size=30, replace=False)
        else:
            keys = rng.choice(1000, size=30, replace=False)
        lists.append((keys, rng.random(30) + 0.1))
    store = _store_from(lists)
    relax = kg.build_relax_table(5, {0: [(2, 0.9), (3, 0.5), (4, 0.3)]},
                                 device="cpu")
    pids = torch.tensor([[0, 1]])
    active = torch.ones((1, 2), dtype=torch.bool)
    sk = sketches.sketch_joinable_counts(store, relax, pids, active).numpy()
    ex = estimator.joinable_counts(store, relax, pids, active).numpy()
    assert np.all(ex[sk == 0.0] == 0.0), (sk, ex)


def test_empty_and_lane_proof_zero():
    rng = np.random.default_rng(0)
    store = _store_from([(np.arange(15), rng.random(15) + 0.1),
                         (np.arange(5000, 5015), rng.random(15) + 0.1)])
    both = torch.ones((1, 2), dtype=torch.bool)
    est = float(sketches.intersection_size(
        store.sketch[None, :2], store.lengths[None, :2].float(), both)[0])
    assert est == 0.0
    store2 = _store_from([(np.arange(100), rng.random(100) + 0.1),
                          (np.arange(5000, 5100), rng.random(100) + 0.1)])
    est2 = float(sketches.intersection_size(
        store2.sketch[None, :2], store2.lengths[None, :2].float(), both)[0])
    assert est2 <= 4.0


def test_single_set_and_empty_arity():
    rng = np.random.default_rng(0)
    store = _store_from([(np.arange(37), rng.random(37) + 0.1)])
    bm, sz = store.sketch[None, :1], store.lengths[None, :1].float()
    one = sketches.intersection_size(bm, sz, torch.tensor([[True]]))
    none = sketches.intersection_size(bm, sz, torch.tensor([[False]]))
    assert float(one[0]) == 37.0 and float(none[0]) == 0.0


def test_sketch_cardinalities_match_exact_on_crafted():
    store = _store_from([
        ([1, 2, 3, 4, 5], [5, 4, 3, 2, 1]),
        ([2, 3, 4, 9], [9, 5, 2, 1]),
        ([3, 4, 5, 6, 7], [7, 3, 2, 1.5, 1]),   # relaxation of 0
    ])
    relax = kg.build_relax_table(3, {0: [(2, 0.8)]}, device="cpu")
    pids = torch.tensor([[0, 1]])
    active = torch.ones((1, 2), dtype=torch.bool)
    n_e, nrel_e = estimator.exact_cardinalities(store, relax, pids, active)
    n_s, nrel_s = sketches.sketch_cardinalities(store, relax, pids, active)
    assert abs(float(n_s[0]) - float(n_e[0])) <= 1.0
    assert abs(float(nrel_s[0, 0, 0]) - float(nrel_e[0, 0, 0])) <= 1.0
    assert float(nrel_s[0, 1, 0]) == 0.0     # padded relaxation slot
