"""The port's kernels: plain versions vs the JAX kernels and oracles.

On the CPU the port's wrappers run the plain versions (``kernels.ref``);
these are held bit for bit against the JAX package's Pallas kernels (in
interpret mode) and its jnp oracles. The CUDA kernels themselves run only
on a card: the ``gpu`` tests hold them against the plain versions there.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ref as jref, rank_join as jrank_join
from repro.kernels import merge_topk as jmerge_topk
from repro.kernels import topk_score as jtopk_score
from repro.kernels import embedding_bag as jembedding_bag
from repro.kernels import flash_attention as jflash_attention
from repro.kernels import neigh_agg as jneigh_agg
from repro_torch.kernels import ops, ref, _build
from repro_torch.kernels import rank_join, merge_topk
from repro_torch.kernels import topk_score, embedding_bag, flash_attention
from repro_torch.kernels import neigh_agg

# Small tensors: one intra-op thread per test worker keeps the workers of
# a parallel test run from spinning on each other's cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(0)


def _lookup_case(rng, N, B, cnt, dup=False):
    keys = rng.choice(100000, N, replace=False).astype(np.int32)
    scores = rng.random(N).astype(np.float32)
    live = min(cnt, N)
    keys[live:] = np.where(np.arange(N - live) % 3 == 0, -1, keys[live:])
    if dup:
        keys[min(300, N - 1)] = keys[3]
    probes = np.concatenate([
        rng.choice(keys[:max(live, 1)], B // 2),
        rng.choice(200000, B - B // 2 - 1), [-1]]).astype(np.int32)
    return keys, scores, probes, np.int32(cnt)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _retrieval_case(rng, name):
    """(query, cands, tile, k): the shapes of tests/test_kernels.py, its
    norm-sorted case, and one-hot rows whose scores tie exactly (dots with
    one non-zero term are exact in any summation order)."""
    if name == "norm_sorted":
        D, tile, k = 32, 256, 8
        mags = np.repeat([4.0, 2.0, 1.0, 0.5], tile)
        c = rng.standard_normal((4 * tile, D)) * mags[:, None] / np.sqrt(D)
    elif name == "ties":
        D, tile, k = 32, 256, 16
        r = np.arange(4 * tile)
        c = np.zeros((4 * tile, D))
        c[r, r % 8] = 2.0 ** -(r // tile)
    else:
        N, D, k, tile = name
        c = rng.standard_normal((N, D))
    q = rng.standard_normal(D).astype(np.float32)
    return q, c.astype(np.float32), tile, k


def _bag_case(rng, V, D, B, S):
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(-1, V, (B, S)).astype(np.int32)
    ids[::3, 0] = -1
    w = rng.random((B, S)).astype(np.float32)
    return table, ids, w


def _port_lookup(keys, scores, probes, cnt):
    s, f = ops.rank_join_lookup(torch.from_numpy(keys)[None],
                                torch.from_numpy(scores)[None],
                                torch.from_numpy(probes)[None],
                                torch.tensor([cnt], dtype=torch.int32))
    return s[0].numpy(), f[0].numpy()


@pytest.mark.parametrize("N,B,cnt", [(256, 16, 128), (1000, 64, 700),
                                     (513, 32, 513), (4096, 128, 1228),
                                     (512, 32, 5000)])
def test_rank_join_lookup_matches_jax(N, B, cnt):
    """Unique keys (as the engine's rings hold): bit-equal to the Pallas
    kernel (interpret) and the jnp oracle; cnt ≥ N is a wrapped ring."""
    keys, scores, probes, cnt = _lookup_case(RNG, N, B, cnt)
    s, f = _port_lookup(keys, scores, probes, cnt)
    args = (jnp.asarray(keys), jnp.asarray(scores), jnp.asarray(probes),
            jnp.int32(cnt))
    for js, jf in (jrank_join.rank_join_lookup(*args, interpret=True),
                   jref.rank_join_lookup_ref(*args)):
        np.testing.assert_array_equal(s, np.asarray(js))
        np.testing.assert_array_equal(f, np.asarray(jf))
    assert f.any() and not f[-1]


def test_rank_join_lookup_duplicates_and_straddler():
    """The N = 700 case of tests/test_kernels.py: N not a tile multiple,
    duplicates inside the live window (summed), a duplicate past seen_cnt
    (dead) and PAD probes/slots. Sums of several matches may be added in
    another order than the jnp dot, hence rtol 1e-6 on scores."""
    rng = np.random.default_rng(11)
    N, cnt = 700, np.int32(520)
    keys = rng.choice(50000, N, replace=False).astype(np.int32)
    scores = rng.random(N).astype(np.float32)
    keys[300] = keys[517] = keys[3]
    keys[600] = keys[40]
    keys[cnt:] = np.where(np.arange(N - cnt) % 3 == 0, -1, keys[cnt:])
    probes = np.concatenate([
        [keys[3], keys[40], -1], rng.choice(keys[:cnt], 16),
        rng.choice(np.arange(60000, 61000), 13)]).astype(np.int32)
    s, f = _port_lookup(keys, scores, probes, cnt)
    js, jf = jrank_join.rank_join_lookup(
        jnp.asarray(keys), jnp.asarray(scores), jnp.asarray(probes),
        jnp.int32(cnt), tile_n=256, interpret=True)
    np.testing.assert_array_equal(f, np.asarray(jf))
    np.testing.assert_allclose(s, np.asarray(js), rtol=1e-6)
    assert f[0] and f[1] and not f[2]
    np.testing.assert_allclose(s[0], scores[3] + scores[300] + scores[517],
                               rtol=1e-6)
    assert s[1] == scores[40]


def test_rank_join_lookup_batched_rows_are_independent():
    """G groups in one call equal G single-group calls (and JAX per row)."""
    rng = np.random.default_rng(3)
    cases = [_lookup_case(rng, 640, 48, c) for c in (0, 100, 640, 2000)]
    keys = torch.from_numpy(np.stack([c[0] for c in cases]))
    scores = torch.from_numpy(np.stack([c[1] for c in cases]))
    probes = torch.from_numpy(np.stack([c[2] for c in cases]))
    cnt = torch.tensor([c[3] for c in cases], dtype=torch.int32)
    s, f = ops.rank_join_lookup(keys, scores, probes, cnt)
    for g, (k, sc, p, c) in enumerate(cases):
        js, jf = jref.rank_join_lookup_ref(jnp.asarray(k), jnp.asarray(sc),
                                           jnp.asarray(p), jnp.int32(c))
        np.testing.assert_array_equal(s[g].numpy(), np.asarray(js))
        np.testing.assert_array_equal(f[g].numpy(), np.asarray(jf))
    assert not f[0].any(), "seen_cnt = 0: nothing is live"


def _windows_with_ties(rng, G, R, W):
    wk = rng.integers(0, 10000, (G, R, W)).astype(np.int32)
    # Scores on a coarse grid so many tie, plus -inf padding tails.
    ws = (rng.integers(0, 8, (G, R, W)) / 8.0).astype(np.float32)
    ws[:, 0, -2:] = -np.inf
    return wk, ws


@pytest.mark.parametrize("G,R,W,block", [(1, 4, 16, 16), (3, 11, 64, 64),
                                         (2, 3, 20, 32), (1, 1, 128, 64)])
def test_merge_topk_matches_lax_top_k(G, R, W, block):
    """Keys, scores and flat indices equal lax.top_k's, ties included."""
    wk, ws = _windows_with_ties(RNG, G, R, W)
    k, s, i = ops.merge_topk(torch.from_numpy(wk), torch.from_numpy(ws),
                             block)
    for g in range(G):
        js, ji = jax.lax.top_k(jnp.asarray(ws[g].reshape(-1)), block)
        jk, js2 = jref.merge_topk_ref(jnp.asarray(wk[g]), jnp.asarray(ws[g]),
                                      block)
        np.testing.assert_array_equal(i[g].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(s[g].numpy(), np.asarray(js))
        np.testing.assert_array_equal(k[g].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(s[g].numpy(), np.asarray(js2))
    assert k.dtype == torch.int32 and i.dtype == torch.int32


def test_merge_topk_scores_match_pallas_kernel():
    """Scores equal the Pallas kernel's (interpret); its bitonic network is
    not stable, so only scores are compared with it."""
    wk, ws = _windows_with_ties(RNG, 1, 11, 64)
    _, s, _ = ops.merge_topk(torch.from_numpy(wk), torch.from_numpy(ws), 64)
    _, js = jmerge_topk.merge_topk(jnp.asarray(wk[0]), jnp.asarray(ws[0]), 64)
    np.testing.assert_array_equal(s[0].numpy(), np.asarray(js))


@given(st.integers(1, 3), st.integers(1, 6), st.integers(1, 40),
       st.integers(0, 2**31 - 1))
@settings(max_examples=25, deadline=None)
def test_merge_topk_property(G, R, W, seed):
    rng = np.random.default_rng(seed)
    block = int(rng.integers(1, R * W + 1))
    wk, ws = _windows_with_ties(rng, G, R, W)
    k, s, i = ref.merge_topk(torch.from_numpy(wk), torch.from_numpy(ws),
                             block)
    for g in range(G):
        js, ji = jax.lax.top_k(jnp.asarray(ws[g].reshape(-1)), block)
        np.testing.assert_array_equal(i[g].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(s[g].numpy(), np.asarray(js))
        np.testing.assert_array_equal(k[g].numpy(),
                                      wk[g].reshape(-1)[np.asarray(ji)])


RETRIEVAL_CASES = [(2048, 64, 16, 512), (1024, 128, 8, 256), "norm_sorted",
                   "ties"]


@pytest.mark.parametrize("case", RETRIEVAL_CASES)
def test_block_bounds_cauchy_matches_jax(case):
    q, c, tile, _ = _retrieval_case(np.random.default_rng(7), case)
    got = ops.block_bounds_cauchy(*_t(q, c), tile)
    want = jtopk_score.block_bounds_cauchy(jnp.asarray(q), jnp.asarray(c),
                                           tile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("speculative", [True, False])
@pytest.mark.parametrize("case", RETRIEVAL_CASES)
def test_topk_score_pruned_matches_jax(case, speculative):
    """Scores rtol 1e-5 (dots summed in another order); indices and the
    scored-tile count exact against the jnp oracle, and against the Pallas
    kernel (interpret) where no scores tie: its bitonic network is not
    stable, so on ties only its scores and count are compared."""
    q, c, tile, k = _retrieval_case(np.random.default_rng(7), case)
    n_tiles = c.shape[0] // tile
    jq, jc = jnp.asarray(q), jnp.asarray(c)
    jb = (jtopk_score.block_bounds_cauchy(jq, jc, tile) if speculative
          else jnp.full((n_tiles,), jnp.inf, jnp.float32))
    s, i, n = ops.topk_score_pruned(*_t(q, c, np.asarray(jb)), k, tile)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    rs, ri, rn = jref.topk_score_pruned_ref(jq, jc, jb, k, tile)
    ps, pi, pn = jtopk_score.topk_score_pruned(jq, jc, jb, k, tile)
    for js, jn in ((rs, rn), (ps, pn)):
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
        assert int(n) == int(jn)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    if case != "ties":
        np.testing.assert_array_equal(i.numpy(), np.asarray(pi))
    if not speculative:
        assert int(n) == n_tiles
    elif case in ("norm_sorted", "ties"):
        assert int(n) < n_tiles, "no tile was pruned"
    # Sound bounds give the exact top-k (the full-scan oracle's).
    es, ei = ref.topk_score(*_t(q, c), k)
    np.testing.assert_allclose(s.numpy(), es.numpy(), rtol=1e-5)
    js, ji = jref.topk_score_ref(jq, jc, k)
    np.testing.assert_array_equal(ei.numpy(), np.asarray(ji))


def test_topk_score_pruned_fewer_candidates_than_k():
    """k above the candidate count: the tail keeps -inf and index -1, as
    the reference's initial buffer does. Every candidate is in the top-k,
    so some scores lie near 0: atol 1e-6 covers the rounding of a D = 8
    dot summed in another order."""
    q, c, tile, _ = _retrieval_case(np.random.default_rng(8),
                                    (64, 8, 1, 32))
    jb = jnp.full((2,), jnp.inf, jnp.float32)
    s, i, n = ops.topk_score_pruned(*_t(q, c, np.asarray(jb)), 80, tile)
    rs, ri, rn = jref.topk_score_pruned_ref(jnp.asarray(q), jnp.asarray(c),
                                            jb, 80, tile)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    assert int(n) == int(rn) == 2 and (i.numpy()[64:] == -1).all()


def test_topk_score_wrapper_checks():
    q, c = torch.zeros(8), torch.zeros((1024, 8))
    b = torch.zeros(2)
    assert topk_score.check_args(q, c, b, 100, 512) == (2, 8, 8192)
    assert topk_score.smem_slots(8, 256) == 8192
    assert topk_score.smem_slots(4000, 256) == 8192
    assert topk_score.smem_slots(8191, 8193) == 8191 + 16384
    with pytest.raises(ValueError, match="multiple of tile"):
        topk_score.check_args(q, c, b, 100, 300)
    with pytest.raises(ValueError, match="16-byte"):
        topk_score.check_args(torch.zeros(6), torch.zeros((1024, 6)), b,
                              100, 512)
    with pytest.raises(ValueError, match="exceeds"):
        topk_score.check_args(torch.zeros(260), torch.zeros((1024, 260)),
                              b, 100, 512)
    with pytest.raises(ValueError, match="shared memory"):
        topk_score.check_args(q, torch.zeros((65536, 8)),
                              torch.zeros(2), 10, 32768)
    with pytest.raises(TypeError):
        topk_score.check_args(q.double(), c, b, 100, 512)


SPECULATION_CASES = ["cauchy", "unsound", "permuted", "nan_inf", "ties",
                     "k>tile", "k>N"]


def _exact_corpus(rng, n_tiles, tile, D):
    """Norm-sorted rows and a query on coarse dyadic grids (eighths and
    quarters of a few bits), so every dot is exact in f32 in any summation
    order and JAX and PyTorch agree bit for bit; some scores tie."""
    mags = np.repeat(np.geomspace(4.0, 0.1, n_tiles), tile)
    c = np.round(rng.standard_normal((n_tiles * tile, D)) * mags[:, None]
                 * 8) / 8
    q = np.round(rng.standard_normal(D) * 4) / 4
    return q.astype(np.float32), c.astype(np.float32)


def _speculation_case(name):
    """(query, cands, bounds, k, tile), numpy f32: sound Cauchy bounds,
    unsound ones (Cauchy x 0.25; Cauchy permuted across tiles), bounds
    holding NaN, -inf and inf, exact ties, k > tile and k > N."""
    rng = np.random.default_rng(11)
    if name == "ties":
        q, c, tile, k = _retrieval_case(rng, "ties")
    elif name == "k>N":
        tile, k = 8, 64
        c = rng.integers(-3, 4, (48, 8)).astype(np.float32)
        q = rng.integers(-3, 4, 8).astype(np.float32)
    elif name == "k>tile":
        tile, k = 8, 20
        q, c = _exact_corpus(rng, 16, tile, 8)
    else:
        tile, k = 32, 8
        q, c = _exact_corpus(rng, 24, tile, 16)
    b = ops.block_bounds_cauchy(*_t(q, c), tile).numpy()
    if name == "unsound":
        b = b * np.float32(0.25)
    elif name == "permuted":
        b = b[rng.permutation(len(b))]
    elif name == "nan_inf":
        b[[1, 5, 9, 14]] = [np.nan, -np.inf, np.inf, np.nan]
    elif name == "k>N":
        b[2] = np.nan
    return q, c, b.astype(np.float32), k, tile


@functools.lru_cache(maxsize=None)
def _speculation_want(name):
    """The sequential plain version's and JAX's answers for a case."""
    q, c, b, k, tile = _speculation_case(name)
    rs, ri, rn = ref.topk_score_pruned(*_t(q, c, b), k, tile)
    js, ji, jn = jref.topk_score_pruned_ref(jnp.asarray(q), jnp.asarray(c),
                                            jnp.asarray(b), k, tile)
    return ((rs.numpy(), ri.numpy(), int(rn)),
            (np.asarray(js), np.asarray(ji), int(jn)))


@pytest.mark.parametrize("room,probe", [(None, None), (12, 3), (4000, 15)])
@pytest.mark.parametrize("wave", [1, 2, 3, 7, "all"])
@pytest.mark.parametrize("case", SPECULATION_CASES)
def test_topk_score_pruned_speculative_matches_sequential(case, wave, room,
                                                          probe):
    """The kernel's schedule (threshold a wave at a time, speculative reads,
    in-order replay, per-tile lists; one list a merge, or batches of lists
    of up to 12 or 4000 entries, with lists cut at a probe) gives the
    sequential answer: count and
    indices exact, scores rtol 1e-6, against the plain version and JAX's
    oracle. It reads every tile it counts, and with waves of one tile
    nothing more."""
    q, c, b, k, tile = _speculation_case(case)
    n_tiles = len(b)
    s, i, n, read = ref.topk_score_pruned_speculative(
        *_t(q, c, b), k, tile, n_tiles if wave == "all" else wave, room,
        probe)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    for ws, wi, wn in _speculation_want(case):
        assert int(n) == wn
        np.testing.assert_array_equal(i.numpy(), wi)
        np.testing.assert_allclose(s.numpy(), ws, rtol=1e-6)
    assert int(n) <= read <= n_tiles
    if wave == 1:
        assert read == int(n)
    if case == "cauchy":
        assert int(n) < n_tiles, "no tile was pruned"
    if case == "unsound" and wave == "all":
        assert read > int(n), "no tile was read speculatively"
    if case == "k>N":
        assert (i.numpy()[len(c):] == -1).all()
        assert np.isneginf(s.numpy()[len(c):]).all()


# (n_tiles, tile, k, wave, room, scale, permute, odd, seed)
SCHEDULE_EDGES = [(12, 7, 24, 6, 20, 0.25, True, True, 44331),
                  (12, 11, 24, 2, 20, 0.25, True, False, 12582),
                  (11, 12, 28, 13, 4000, 0.25, False, False, 10986),
                  (11, 5, 12, 7, 5, 0.25, True, True, 10775)]


def _check_schedule(n_tiles, tile, k, wave, room, scale, permute, odd,
                    seed, probe=None):
    rng = np.random.default_rng(seed)
    c = rng.integers(-3, 4, (n_tiles * tile, 4)).astype(np.float32)
    q = rng.integers(-3, 4, 4).astype(np.float32)
    b = ops.block_bounds_cauchy(*_t(q, c), tile).numpy() * np.float32(scale)
    if permute:
        b = b[rng.permutation(n_tiles)]
    if odd:
        b[rng.integers(0, n_tiles, 2)] = rng.choice([np.nan, np.inf,
                                                     -np.inf], 2)
    args = (*_t(q, c, b.astype(np.float32)), k, tile)
    s, i, n, read = ref.topk_score_pruned_speculative(*args, wave, room,
                                                      probe)
    rs, ri, rn = ref.topk_score_pruned(*args)
    assert torch.equal(s, rs) and torch.equal(i, ri) and int(n) == int(rn)
    assert int(n) <= read <= n_tiles


@given(st.integers(1, 12), st.integers(1, 16), st.integers(1, 40),
       st.integers(1, 13), st.sampled_from([None, 1, 5, 20, 4000]),
       st.sampled_from([1.0, 0.25, 2.0]), st.booleans(), st.booleans(),
       st.integers(0, 2**16), st.sampled_from([None, 1, 4, 15]))
@settings(max_examples=60, deadline=None)
def test_topk_score_pruned_speculative_property(n_tiles, tile, k, wave, room,
                                                scale, permute, odd, seed,
                                                probe):
    """Any sizes, wave, batch size, probe and bounds (scaled, permuted, with
    NaN / ±inf): the schedule equals the sequential plain version bit for
    bit. Integer rows tie often; ties go to the lower index in both."""
    _check_schedule(n_tiles, tile, k, wave, room, scale, permute, odd, seed,
                    probe)


@pytest.mark.parametrize("args", SCHEDULE_EDGES)
def test_topk_score_pruned_speculative_edges(args):
    """Fixed draws of the property test on which a batch's sure-to-hold
    bound (the buffer's (k - C)-th score) is tight: planned with the
    buffer's k-th instead, the batch would not hold."""
    _check_schedule(*args)


@pytest.mark.parametrize("V,D,B,S", [(100, 32, 8, 4), (500, 64, 16, 8)])
def test_embedding_bag_matches_jax(V, D, B, S):
    """Against the jnp oracle and the Pallas kernel (interpret), with
    inactive (-1) slots; rtol/atol 1e-6 as the sums run in another order."""
    table, ids, w = _bag_case(np.random.default_rng(9), V, D, B, S)
    out = ops.embedding_bag(*_t(table, ids, w))
    assert out.shape == (B, D) and out.dtype == torch.float32
    args = (jnp.asarray(table), jnp.asarray(ids), jnp.asarray(w))
    for want in (jref.embedding_bag_ref(*args),
                 jembedding_bag.embedding_bag(*args, interpret=True)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_embedding_bag_wrapper_checks():
    table, w = torch.zeros((10, 8)), torch.zeros((3, 2))
    ids = torch.zeros((3, 2), dtype=torch.int32)
    assert embedding_bag.check_args(table, ids, w) == (3, 2, 8)
    with pytest.raises(ValueError, match="16-byte"):
        embedding_bag.check_args(torch.zeros((10, 6)), ids, w)
    with pytest.raises(TypeError):
        embedding_bag.check_args(table, ids.long(), w)
    # A table that requires gradients is taken: the backward is a kernel.
    assert embedding_bag.check_args(table.requires_grad_(), ids, w) == (
        3, 2, 8)


def test_dispatch_and_wrapper_checks():
    """CPU tensors take the plain path without counting launches; the CUDA
    wrappers refuse CPU tensors; a bad impl raises."""
    ops.reset_launches()
    keys = torch.zeros((1, 8), dtype=torch.int32)
    scores = torch.zeros((1, 8))
    probes = torch.zeros((1, 4), dtype=torch.int32)
    cnt = torch.zeros((1,), dtype=torch.int32)
    cands = torch.ones((8, 4))
    bounds = torch.full((2,), float("inf"))
    ops.rank_join_lookup(keys, scores, probes, cnt)
    ops.merge_topk(keys.view(1, 2, 4), scores.view(1, 2, 4), 4)
    ops.topk_score_pruned(cands[0], cands, bounds, 2, 4)
    ops.embedding_bag(cands, keys.view(2, 4), scores.view(2, 4))
    ops.embedding_bag_backward(cands[:2], keys.view(2, 4), scores.view(2, 4),
                               cands, weights_grad=True)
    qkv = torch.zeros((1, 2, 4, 128), dtype=torch.bfloat16)
    ops.flash_attention(qkv, qkv, qkv)
    ops.flash_attention_backward(qkv, qkv, qkv, qkv,
                                 torch.zeros((1, 2, 4)), qkv)
    ops.neigh_softmax_agg(cands, cands[..., None], cands > 0)
    assert ops.launches() == {"rank_join_lookup": 0, "merge_topk": 0,
                              "topk_score_pruned": 0, "embedding_bag": 0,
                              "embedding_bag_backward": 0,
                              "flash_attention": 0,
                              "flash_attention_backward": 0,
                              "neigh_softmax_agg": 0}
    with pytest.raises(ValueError):
        rank_join.rank_join_lookup(keys, scores, probes, cnt)
    with pytest.raises(ValueError):
        merge_topk.merge_topk(keys.view(1, 2, 4), scores.view(1, 2, 4), 4)
    with pytest.raises(ValueError):
        topk_score.topk_score_pruned(cands[0], cands, bounds, 2, 4)
    with pytest.raises(ValueError):
        embedding_bag.embedding_bag(cands, keys.view(2, 4),
                                    scores.view(2, 4))
    with pytest.raises(ValueError):
        embedding_bag.embedding_bag_backward(cands[:2], keys.view(2, 4),
                                             scores.view(2, 4), cands)
    # The table gradient's refusals, before the device check: B * S past
    # its int32 slot index (meta tensors: shapes without memory), and an
    # ``out`` of the wrong shape or alignment.
    big = torch.empty((2**16, 2**15 + 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="int32"):
        embedding_bag.embedding_bag_backward(
            torch.empty((2**16, 4), device="meta"), big,
            big.float(), torch.empty((8, 4), device="meta"))
    bag_args = (cands[:2], keys.view(2, 4), scores.view(2, 4), cands)
    with pytest.raises(ValueError, match="out must have shape"):
        embedding_bag.embedding_bag_backward(*bag_args,
                                             out=torch.zeros((7, 4)))
    with pytest.raises(ValueError, match="out must be 16-byte aligned"):
        embedding_bag.embedding_bag_backward(
            *bag_args, out=torch.zeros(33)[1:].view(8, 4))
    assert embedding_bag.bwd_scratch_bytes(8) == 4 * (5 * 8 + 3 * 256 + 1)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(qkv, qkv, qkv)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_backward(
            qkv, qkv, qkv, qkv, torch.zeros((1, 2, 4)), qkv)
    with pytest.raises(ValueError):
        neigh_agg.neigh_softmax_agg(cands, cands[..., None], cands > 0)
    with pytest.raises(ValueError):
        ops.merge_topk(keys.view(1, 2, 4), scores.view(1, 2, 4), 4,
                       impl="cuda")
    assert merge_topk.padded_row(256) == 256
    assert merge_topk.padded_row(20) == 32 and merge_topk.padded_row(1) == 1
    big = torch.zeros((1, 65, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        merge_topk.check_args(big, big.float(), 256)
    probes = torch.zeros((1, rank_join.MAX_PROBES + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="probes"):
        rank_join.check_args(keys, scores, probes, cnt)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc, no kernels: the build raises instead of falling back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


FLASH_CASES = [  # tests/test_kernels.py's five cases
    (1, 4, 2, 128, 128, 64, True, None, None, np.float32),
    (2, 2, 2, 128, 256, 32, True, 64, None, np.float32),
    (1, 4, 1, 64, 64, 64, True, None, 30.0, np.float32),
    (1, 2, 2, 128, 128, 32, False, None, None, np.float32),
    (1, 2, 1, 128, 128, 32, True, None, None, np.dtype("bfloat16"))]


def _flash_case(rng, B, Hq, Hkv, Sq, Sk, D, dtype):
    q = (rng.standard_normal((B, Hq, Sq, D)) * 0.3).astype(dtype)
    k = (rng.standard_normal((B, Hkv, Sk, D)) * 0.3).astype(dtype)
    v = rng.standard_normal((B, Hkv, Sk, D)).astype(dtype)
    return q, k, v


def _torch_from(a):
    """numpy (bf16 through its int16 view) → torch, bit for bit."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,win,cap,dtype",
                         FLASH_CASES)
def test_flash_attention_matches_jax(B, Hq, Hkv, Sq, Sk, D, causal, win,
                                     cap, dtype):
    """The plain version against the Pallas kernel (interpret mode) and
    the jnp oracle, on the same inputs: GQA, Sq < Sk, window, softcap,
    non-causal, bf16. Tolerance 2e-4 in f32, 2e-2 in bf16 (as
    tests/test_kernels.py holds the Pallas kernel)."""
    q, k, v = _flash_case(np.random.default_rng(11), B, Hq, Hkv, Sq, Sk,
                          D, dtype)
    kw = dict(causal=causal, window=win, softcap=cap)
    pallas = jflash_attention.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), tile_q=64,
        tile_k=64, **kw)
    oracle = jref.flash_attention_ref(
        *(jnp.asarray(a, jnp.float32) for a in (q, k, v)), **kw)
    got = ops.flash_attention(*(_torch_from(a) for a in (q, k, v)), **kw)
    assert got.dtype == (torch.bfloat16 if dtype != np.float32
                         else torch.float32)
    tol = 2e-4 if dtype == np.float32 else 2e-2
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)


def test_flash_attention_edges():
    """Rows with no visible key give 0 (Sq > Sk, causal: the first rows
    sit before every key); window 0 and softcap 0 mean none."""
    rng = np.random.default_rng(12)
    q, k, v = (_torch_from(a) for a in _flash_case(rng, 1, 2, 1, 8, 4, 16,
                                                    np.float32))
    out = ops.flash_attention(q, k, v)
    assert torch.equal(out[:, :, :4], torch.zeros_like(out[:, :, :4]))
    assert out[:, :, 4:].abs().sum() > 0
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, window=0, softcap=0.0),
        ops.flash_attention(q, k, v, window=None, softcap=None),
        rtol=0, atol=0)


def test_flash_attention_wrapper_checks():
    """What the CUDA wrapper refuses, before it reaches the card."""
    bf = torch.bfloat16
    q = torch.zeros((2, 8, 40, 256), dtype=bf)
    k = torch.zeros((2, 4, 48, 256), dtype=bf)
    assert flash_attention.check_args(q, k, k) == (2, 8, 4, 40, 48, 256)
    # (B, S, H, D) activations seen as (B, H, S, D) are taken as they are.
    qs = torch.zeros((2, 40, 8, 128), dtype=bf).transpose(1, 2)
    ks = torch.zeros((2, 48, 4, 128), dtype=bf).transpose(1, 2)
    assert flash_attention.check_args(qs, ks, ks)[-1] == 128
    with pytest.raises(TypeError):
        flash_attention.check_args(q.float(), k.float(), k.float())
    assert flash_attention.check_args(q[..., :64], k[..., :64],
                                      k[..., :64])[-1] == 64
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.check_args(q[..., :96], k[..., :96], k[..., :96])
    with pytest.raises(ValueError, match="multiple"):
        flash_attention.check_args(q[:, :6], k[:, :4], k[:, :4])
    with pytest.raises(ValueError, match="strides"):
        flash_attention.check_args(q[..., ::2], k[..., ::2], k[..., ::2])
    with pytest.raises(ValueError):
        flash_attention.check_args(q, k, k[:, :, :40])


def _agg_case(rng, N, MAXD, D):
    """tests/test_kernels.py's draw, with row 0 and every 5th row empty."""
    lg = (rng.standard_normal((N, MAXD)) * 3).astype(np.float32)
    ft = rng.standard_normal((N, MAXD, D)).astype(np.float32)
    mk = rng.random((N, MAXD)) > 0.3
    mk[::5] = False
    return lg, ft, mk


@pytest.mark.parametrize("N,MAXD,D", [(64, 16, 32), (130, 8, 64),
                                      (257, 56, 47), (100, 8, 8)])
def test_neigh_softmax_agg_matches_jax(N, MAXD, D):
    """The plain version against the Pallas kernel (interpret, tile_n 64)
    and the jnp oracle on the same inputs, within rtol 1e-4 atol 1e-5 (the
    reference's own bar); rows with no live slot give exactly 0."""
    lg, ft, mk = _agg_case(np.random.default_rng(14), N, MAXD, D)
    got = ops.neigh_softmax_agg(*_t(lg, ft, mk))
    assert got.shape == (N, D) and got.dtype == torch.float32
    assert torch.equal(got[::5], torch.zeros_like(got[::5]))
    args = (jnp.asarray(lg), jnp.asarray(ft), jnp.asarray(mk))
    for want in (jneigh_agg.neigh_softmax_agg(*args, tile_n=64),
                 jref.neigh_softmax_agg_ref(*args)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


def test_neigh_softmax_agg_wrapper_checks():
    """What the CUDA wrapper refuses, before it reaches the card."""
    lg, ft = torch.zeros((6, 5)), torch.zeros((6, 5, 3))
    mk = torch.ones((6, 5), dtype=torch.bool)
    assert neigh_agg.check_args(lg, ft, mk) == (6, 5, 3)
    with pytest.raises(TypeError):
        neigh_agg.check_args(lg.double(), ft.double(), mk)
    with pytest.raises(TypeError):
        neigh_agg.check_args(lg, ft, mk.int())
    with pytest.raises(TypeError):
        neigh_agg.check_args(lg.half(), ft, mk)
    with pytest.raises(ValueError, match="shape"):
        neigh_agg.check_args(lg, ft[:5], mk)
    with pytest.raises(ValueError, match="shape"):
        neigh_agg.check_args(lg, ft, mk[:, :4])
    with pytest.raises(ValueError, match="contiguous"):
        neigh_agg.check_args(lg, ft.transpose(0, 1).contiguous().transpose(
            0, 1), mk)
    with pytest.raises(ValueError, match="MAXD"):
        neigh_agg.check_args(lg[:, :0], ft[:, :0], mk[:, :0])
    with pytest.raises(ValueError):
        neigh_agg.check_args(lg[0], ft, mk)
    with pytest.raises(NotImplementedError):
        neigh_agg.check_args(lg.requires_grad_(), ft, mk)
    with pytest.raises(ValueError, match="CUDA"):
        neigh_agg.neigh_softmax_agg(lg.detach(), ft, mk)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(cuda):
    """On the card: both kernels bit-equal to their plain versions, on
    empty, partial, full and wrapped rings (9000 > N), with duplicate and
    PAD probes, and on unsorted and engine-layout (sorted, -inf tails)
    windows."""
    rng = np.random.default_rng(5)
    cases = [_lookup_case(rng, 5000, 256, c) for c in (0, 1000, 5000, 9000)]
    args = [torch.from_numpy(np.stack([c[j] for c in cases])).to(cuda)
            for j in range(3)]
    cnt = torch.tensor([c[3] for c in cases], dtype=torch.int32,
                       device=cuda)
    dup = args[2].clone()
    dup[:, 128:192] = dup[:, :64]
    for probes in (args[2], dup):
        got = ops.rank_join_lookup(args[0], args[1], probes, cnt)
        want = ops.rank_join_lookup(args[0], args[1], probes, cnt,
                                    impl="ref")
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert got[1][1:].any()
    wk, ws = _windows_with_ties(rng, 8, 11, 256)
    engine = -np.sort(-rng.random((8, 11, 256)).astype(np.float32), -1)
    engine[np.arange(256) >= rng.integers(0, 257, (8, 11, 1))] = -np.inf
    for scores in (ws, engine):
        wk_c = torch.from_numpy(wk).to(cuda)
        ws_c = torch.from_numpy(scores).to(cuda)
        for a, b in zip(ops.merge_topk(wk_c, ws_c, 256),
                        ops.merge_topk(wk_c, ws_c, 256, impl="ref")):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_topk_score_matches_plain_version(cuda):
    """On the card, at a tile and k of the retrieval path: count and indices
    exact, scores rtol 1e-5; both bound modes; the tie case; the schedule
    tests' adversarial bounds; more tiles (4096 of 64 rows at D = 32) than
    the persistent grid has blocks; k in the thousands; no candidates. A
    second run is bit-equal to the first, and the kernel reads every tile
    it counts."""
    rng = np.random.default_rng(6)
    D, tile, k, n_tiles = 256, 512, 100, 64
    mags = np.repeat(np.geomspace(4.0, 0.1, n_tiles), tile)
    c = (rng.standard_normal((n_tiles * tile, D)) * mags[:, None]
         / np.sqrt(D)).astype(np.float32)
    q = rng.standard_normal(D).astype(np.float32)
    mags = np.repeat(np.geomspace(4.0, 0.1, 4096), 64)
    c_many = (rng.standard_normal((4096 * 64, 32)) * mags[:, None]
              / np.sqrt(32)).astype(np.float32)
    q_many = rng.standard_normal(32).astype(np.float32)
    cases = []
    for q, c, tile, k in [(q, c, tile, k), _retrieval_case(rng, "ties"),
                          (q_many, c_many, 64, 100)]:
        q, c = (t.to(cuda) for t in _t(q, c))
        cauchy = ops.block_bounds_cauchy(q, c, tile)
        perm = torch.randperm(len(cauchy), device="cpu").to(cuda)
        cases += [(q, c, b, k, tile) for b in (
            cauchy, torch.full_like(cauchy, float("inf")), cauchy * 0.25,
            cauchy[perm])]
    for name in SPECULATION_CASES:
        q, c, b, k, tile = _speculation_case(name)
        cases.append((*(t.to(cuda) for t in _t(q, c, b)), k, tile))
    # k in the thousands (batch merges of a few lists; none at k = 5000),
    # and no candidates at all.
    for k, tile in ((3000, 256), (5000, 512)):
        q, c = (t.to(cuda) for t in _t(*_exact_corpus(rng, 48, tile, 16)))
        cases.append((q, c, ops.block_bounds_cauchy(q, c, tile), k, tile))
    q = torch.zeros(16, device=cuda)
    cases.append((q, torch.zeros((0, 16), device=cuda),
                  torch.zeros(0, device=cuda), 10, 8))
    for q, c, b, k, tile in cases:
        s, i, n = ops.topk_score_pruned(q, c, b, k, tile)
        read = int(topk_score.topk_score_pruned.last_tiles_read)
        s2, i2, n2 = ops.topk_score_pruned(q, c, b, k, tile)
        rs, ri, rn = ops.topk_score_pruned(q, c, b, k, tile, impl="ref")
        torch.testing.assert_close(s, rs, rtol=1e-5, atol=0)
        assert torch.equal(i, ri) and int(n) == int(rn)
        assert torch.equal(s, s2) and torch.equal(i, i2) and int(n2) == int(n)
        assert int(n) <= read <= len(b)


@pytest.mark.gpu
def test_cuda_embedding_bag_matches_plain_version(cuda):
    """On the card, with -1 slots, S not a multiple of the kernel's unroll,
    bags of one slot and bags whose ids are all -1 (exactly 0), and rows
    past 2**23 of a table wider than 2**31 floats (64-bit offsets): rtol/
    atol 1e-6; two runs bit-equal."""
    rng = np.random.default_rng(10)
    for B, S in ((64, 7), (33, 1), (16, 32)):
        table, ids, w = (t.to(cuda) for t in _t(*_bag_case(rng, 1000, 256,
                                                             B, S)))
        ids[1] = -1
        got = ops.embedding_bag(table, ids, w)
        torch.testing.assert_close(got, ops.embedding_bag(
            table, ids, w, impl="ref"), rtol=1e-6, atol=1e-6)
        assert torch.equal(got, ops.embedding_bag(table, ids, w))
        assert torch.equal(got[1], torch.zeros_like(got[1]))
    V = 2**23 + 4096
    big = torch.empty((V, 256), device=cuda).normal_()
    ids = torch.from_numpy(rng.integers(2**23, V, (32, 8)).astype(
        np.int32)).to(cuda)
    w = torch.rand((32, 8), device=cuda)
    torch.testing.assert_close(ops.embedding_bag(big, ids, w),
                               ops.embedding_bag(big, ids, w, impl="ref"),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_cuda_flash_attention_matches_plain_version(cuda):
    """On the card, bf16: the kernel against its plain version (f32 math)
    within rtol / atol 2e-2 — GQA with window and softcap, Sq < Sk, a
    ragged length, non-causal, head_dim 64, 128, 192 and 256, and (B, S,
    H, D) activations passed through their strides; at the kernel's
    edges: Sq and Sk off its tiles, Sq of 1 and 17, Sq > Sk (rows with no
    visible key exactly 0), windows of 1 and a tile's keys ± 1, GQA groups
    of 1, 2 and 12; head_dim 64 at granite's layer and at these edges;
    head_dim 192 at MLA's layer (group 1) and at these edges; every case
    run twice and bit-equal."""
    rng = np.random.default_rng(13)
    bn = flash_attention.TILE_N
    cases = [(2, 8, 4, 300, 300, 256, True, 128, 50.0),
             (1, 8, 4, 70, 333, 256, True, None, None),
             (1, 4, 2, 200, 200, 128, False, None, 30.0),
             (1, 4, 1, 129, 129, 128, True, 64, None),
             (1, 8, 4, 1000, 1234, 256, True, 300, 50.0),
             (2, 8, 4, 1, 777, 256, True, None, 50.0),
             (1, 24, 2, 17, 300, 128, True, None, None),
             (1, 8, 4, 700, 300, 256, True, None, 50.0),
             (1, 4, 2, 500, 129, 128, True, None, None),
             (1, 4, 4, 700, 700, 256, True, None, 50.0),
             (1, 24, 2, 700, 700, 256, True, None, 50.0),
             (1, 24, 2, 700, 700, 128, True, None, None)]
    # head_dim 64: granite-moe-3b-a800m's layer (24 / 8 heads), a ragged
    # length, Sq < Sk, Sq > Sk, non-causal and softcap.
    cases += [(2, 24, 8, 300, 300, 64, True, None, None),
              (1, 24, 8, 1000, 1234, 64, True, 300, 50.0),
              (1, 3, 1, 17, 300, 64, True, None, None),
              (1, 3, 1, 700, 300, 64, True, None, 50.0),
              (1, 4, 2, 200, 200, 64, False, None, None)]
    # head_dim 192 (MLA: q.k 128 + 64, n_kv = n_heads): its layer's
    # heads, Sq and Sk off the 112-key tile, Sq < Sk, Sq > Sk, softcap.
    cases += [(1, 128, 128, 300, 300, 192, True, None, None),
              (1, 4, 4, 225, 225, 192, True, None, 50.0),
              (1, 4, 4, 70, 333, 192, True, 129, None),
              (1, 4, 4, 700, 300, 192, True, None, None),
              (1, 4, 4, 200, 200, 192, False, None, 50.0)]
    cases += [(1, 8, 4, 600, 600, D, True, w, 50.0)
              for D in (64, 128, 192, 256)
              for w in (1, bn[D] - 1, bn[D], bn[D] + 1)]
    for B, Hq, Hkv, Sq, Sk, D, causal, win, cap in cases:
        q, k, v = (t.to(cuda) for t in _t(*_flash_case(
            rng, B, Hq, Hkv, Sq, Sk, D, np.float32)))
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        kw = dict(causal=causal, window=win, softcap=cap)
        got = ops.flash_attention(q, k, v, **kw)
        torch.testing.assert_close(
            got.float(),
            ops.flash_attention(q, k, v, impl="ref", **kw).float(),
            rtol=2e-2, atol=2e-2)
        assert torch.equal(got, ops.flash_attention(q, k, v, **kw))
        if Sq > Sk:
            assert torch.equal(got[:, :, :Sq - Sk],
                               torch.zeros_like(got[:, :, :Sq - Sk]))
    for D in (256, 128):
        q = torch.randn((2, 96, 8, D), device=cuda, dtype=torch.bfloat16)
        kv = torch.randn((2, 96, 4, D), device=cuda, dtype=torch.bfloat16)
        out = ops.flash_attention(q.transpose(1, 2), kv.transpose(1, 2),
                                  kv.transpose(1, 2), softcap=50.0)
        assert out.transpose(1, 2).is_contiguous()
        torch.testing.assert_close(
            out.float(), ops.flash_attention(
                q.transpose(1, 2), kv.transpose(1, 2), kv.transpose(1, 2),
                softcap=50.0, impl="ref").float(), rtol=2e-2, atol=2e-2)
    # Logits of std 25 at D = 256, which the softcap of 50 bends hard: the
    # kernel agrees with the softcapped plain version, and the kernel
    # without softcap does not (so the check above can see the softcap).
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in (
        rng.standard_normal((1, 8, 512, 256), np.float32) * 25,
        rng.standard_normal((1, 4, 512, 256), np.float32),
        rng.standard_normal((1, 4, 512, 256), np.float32)))
    for win in (None, 128):
        want = ops.flash_attention(q, k, v, window=win, softcap=50.0,
                                   impl="ref").float()
        torch.testing.assert_close(
            ops.flash_attention(q, k, v, window=win, softcap=50.0).float(),
            want, rtol=2e-2, atol=2e-2)
        assert not torch.allclose(
            ops.flash_attention(q, k, v, window=win).float(), want,
            rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_cuda_neigh_softmax_agg_matches_plain_version(cuda):
    """On the card: the kernel against its plain version within rtol 1e-4
    atol 1e-5 at the reference's shapes, GAT's widths (D = 8 and 47, MAXD
    56), MAXD of 1, 64 and 65 and above (one pass of 64 slots, and several),
    D above 64 and above a row's 128 vectors (column tiles), D = 1, a D that
    32 does not divide, a ragged last row group, feature pointers that are
    not 16- or 8-byte aligned (narrower vectors), and no rows; empty rows
    give exactly 0, two runs are bit-equal, and NaN features in masked
    slots, which the kernel never reads, do not reach the output."""
    rng = np.random.default_rng(15)
    for N, MAXD, D, shift in [
            (64, 16, 32, 0), (130, 8, 64, 0), (257, 56, 47, 0),
            (100, 56, 8, 0), (300, 100, 130, 0), (65, 3, 1, 0),
            (99, 33, 10, 0), (0, 56, 47, 0), (101, 1, 8, 0), (77, 64, 8, 0),
            (77, 65, 47, 0), (31, 129, 8, 0), (45, 20, 1030, 0),
            (103, 56, 8, 1), (103, 56, 8, 2), (57, 56, 47, 1)]:
        lg, ft, mk = (t.to(cuda) for t in _t(*_agg_case(rng, N, MAXD, D)))

        def at_shift(x):  # the same values `shift` floats past an alignment
            buf = torch.empty(x.numel() + shift, device=cuda)
            buf[shift:] = x.reshape(-1)
            return buf[shift:].view(x.shape)

        ft = at_shift(ft)
        got = ops.neigh_softmax_agg(lg, ft, mk)
        torch.testing.assert_close(
            got, ops.neigh_softmax_agg(lg, ft, mk, impl="ref"), rtol=1e-4,
            atol=1e-5)
        assert torch.equal(got, ops.neigh_softmax_agg(lg, ft, mk))
        assert torch.equal(got[::5], torch.zeros_like(got[::5]))
        hidden = at_shift(ft.masked_fill(~mk[..., None], float("nan")))
        torch.testing.assert_close(ops.neigh_softmax_agg(lg, hidden, mk), got,
                                   rtol=0, atol=0)
