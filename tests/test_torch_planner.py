"""The port's planner (histogram, exact estimator, PLANGEN) vs the JAX one.

Cardinalities and joinable counts are integer counts and must match
exactly. ``torch.fft`` and ``jnp.fft`` round differently, so a quantile on
a bin edge may move one bin: estimates are held within 1/G. Plans must
agree on the shared workloads.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import small_workload, TEST_GRID_BINS
from repro.core import estimator as jest, histogram as jhist
from repro.core import plangen as jplan
from repro_torch import convert
from repro_torch.core import estimator, histogram, plangen, engine
from repro_torch.core.types import EngineConfig

# Small tensors: one intra-op thread per test worker keeps the workers of
# a parallel test run from spinning on each other's cores.
torch.set_num_threads(1)

G = TEST_GRID_BINS
K = 5
_j_cards = jax.jit(jest.exact_cardinalities)
_j_joinable = jax.jit(jest.joinable_counts)
_j_estimates = jax.jit(jest.query_score_estimates,
                       static_argnames=("k", "G", "cardinality_mode"))
_j_plan = jax.jit(jplan.plan, static_argnames=("k", "G", "sibling_slack",
                                               "cardinality_mode"))


def _port(wl):
    """The JAX workload's store carried into the port, on the CPU."""
    arrays = {f: np.asarray(getattr(wl.store, f)) for f in
              ("keys", "scores", "lengths", "sorted_keys", "stats",
               "sketch")}
    return (convert.store_from_numpy(**arrays, device="cpu"),
            convert.relax_from_numpy(np.asarray(wl.relax.ids),
                                     np.asarray(wl.relax.weights),
                                     device="cpu"))


@pytest.fixture(scope="module", params=[0, 1, 2])
def workload(request):
    wl = small_workload(seed=request.param, n_queries=8)
    return wl, *_port(wl)


def test_histogram_matches_jax():
    rng = np.random.default_rng(0)
    stats = np.stack([np.array([50, s, 0.8 * t, t], np.float32) for s, t in
                      zip(rng.uniform(0.05, 0.9, 6), rng.uniform(1, 9, 6))])
    stats[2, 3] = 0.0                       # empty pattern → all-zero pmf
    w = rng.uniform(0.1, 1.0, 6).astype(np.float32)
    jp = jax.vmap(lambda s, c: jhist.pattern_pmf(s, c, G))(
        jnp.asarray(stats), jnp.asarray(w))
    tp = histogram.pattern_pmf(torch.from_numpy(stats), torch.from_numpy(w),
                               G)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    active = np.array([True, True, False, True])
    jq = jhist.convolve_pmfs(jp[:4], jnp.asarray(active))
    tq = histogram.convolve_pmfs(tp[:4], torch.from_numpy(active))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    # The planner asks for q = (n - rank)/(n + 1) < 1; at q = 1 the answer
    # hangs on which empty tail bin the rounding of the cdf reaches 1.0 in.
    for q in (0.0, 0.3, 0.77, 0.95):
        a = float(jhist.pmf_quantile(jq, jnp.float32(q), G))
        b = float(histogram.pmf_quantile(tq, torch.tensor(q), G))
        assert abs(a - b) <= 1.0 / G + 1e-7, (q, a, b)
    for n in (0, 3, 40):
        a = float(jhist.expected_order_statistic(jq, n, 5, G))
        b = float(histogram.expected_order_statistic(tq, torch.tensor(n),
                                                     5, G))
        assert abs(a - b) <= 1.0 / G + 1e-7, (n, a, b)


def test_cardinalities_exact(workload):
    wl, store, relax = workload
    q = torch.from_numpy(wl.queries).long()
    active = q != -1
    n, n_rel = estimator.exact_cardinalities(store, relax, q, active)
    nj = estimator.joinable_counts(store, relax, q, active)
    for i, row in enumerate(wl.queries):
        jq = jnp.asarray(row)
        ja = jq != -1
        a, a_rel = _j_cards(wl.store, wl.relax, jq, ja)
        assert float(a) == float(n[i])
        np.testing.assert_array_equal(n_rel[i].numpy(), np.asarray(a_rel))
        np.testing.assert_array_equal(
            nj[i].numpy(),
            np.asarray(_j_joinable(wl.store, wl.relax, jq, ja)))


def test_estimates_within_a_bin_and_plans_equal(workload):
    wl, store, relax = workload
    q = torch.from_numpy(wl.queries).long()
    e_qk, e_q1 = estimator.query_score_estimates(store, relax, q, q != -1,
                                                 K, G)
    masks = plangen.plan(store, relax, q, K, G)
    for i, row in enumerate(wl.queries):
        jq = jnp.asarray(row)
        a_qk, a_q1 = _j_estimates(wl.store, wl.relax, jq, jq != -1, K, G)
        assert abs(float(a_qk) - float(e_qk[i])) <= 1.0 / G + 1e-7
        a_q1, b_q1 = np.asarray(a_q1), e_q1[i].numpy()
        np.testing.assert_array_equal(np.isfinite(a_q1), np.isfinite(b_q1))
        fin = np.isfinite(a_q1)
        assert np.all(np.abs(a_q1[fin] - b_q1[fin]) <= 1.0 / G + 1e-7)
        jm = np.asarray(_j_plan(wl.store, wl.relax, jq, K, G))
        np.testing.assert_array_equal(masks[i].numpy(), jm,
                                      err_msg=f"plan of query {i}")
        # One query alone plans as it does in the batch.
        np.testing.assert_array_equal(
            plangen.plan(store, relax, q[i], K, G).numpy(), jm)


def test_plan_modes_and_slack(workload):
    wl, store, relax = workload
    row = wl.queries[0]
    jq = jnp.asarray(row)
    q = torch.from_numpy(row)
    got = plangen.plan(store, relax, q, K, G, sibling_slack=0.0)
    want = _j_plan(wl.store, wl.relax, jq, K, G, sibling_slack=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        plangen.per_pattern_plan(got).numpy(),
        np.asarray(jplan.per_pattern_plan(want)))
    np.testing.assert_array_equal(
        plangen.trinit_plan(q, relax.ids.shape[1]).numpy(),
        np.asarray(jplan.trinit_plan(jq, relax.ids.shape[1])))
    cfg = EngineConfig(block=16, k=K, grid_bins=G)
    with pytest.raises(ValueError):
        engine.plan_for_mode(store, relax, q, cfg, "bogus")
    # Sketch mode, once refused, now plans as the JAX package does.
    got = engine.plan_for_mode(
        store, relax, q, dataclasses.replace(cfg, cardinality_mode="sketch"),
        "specqp")
    want = _j_plan(wl.store, wl.relax, jq, K, G, cardinality_mode="sketch")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        engine.plan_for_mode(
            store, relax, q,
            dataclasses.replace(cfg, cardinality_mode="bogus"), "specqp")
