"""CPU models of the KG path's two CUDA schedules, against the plain
versions and JAX.

``kernels.ref.merge_topk_ranked`` is the schedule of ``csrc/merge_topk.cu``
(rows checked and, where out of order, sorted; then every item's rank in
its group by binary searches in the other rows) and
``kernels.ref.rank_join_lookup_split`` that of ``csrc/rank_join.cu`` (a
sorted probe table, the live ring cut into ``rank_join.CHUNKS`` chunks,
per-chunk sums combined in chunk order). Both are held here against the
plain versions the kernels are held to on the card, and against the JAX
package's Pallas kernels (interpret mode) and oracles.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ref as jref, rank_join as jrank_join
from repro.kernels import merge_topk as jmerge_topk
from repro_torch.kernels import ref, rank_join

torch.set_num_threads(1)

PAD = -1
NEG_INF = np.float32(-np.inf)


# ----------------------------------------------------------------- merge_topk
def _windows(rng, kind, G, R, W):
    """(G, R, W) keys and scores of one kind of window."""
    wk = rng.integers(0, 10000, (G, R, W)).astype(np.int32)
    if kind == "unsorted":  # a coarse grid, so rows tie within and across
        ws = (rng.integers(0, 8, (G, R, W)) / 8.0).astype(np.float32)
        ws[:, 0, -2:] = NEG_INF
        return wk, ws
    if kind == "equal":
        return wk, np.full((G, R, W), 0.5, np.float32)
    if kind == "cross_ties":  # sorted rows drawing from a few shared values
        ws = (rng.integers(0, 4, (G, R, W)) / 4.0).astype(np.float32)
    else:
        ws = rng.random((G, R, W)).astype(np.float32) * rng.random(
            (G, R, 1)).astype(np.float32)  # a relaxation weight in [0, 1]
    ws = -np.sort(-ws, axis=-1)
    # -inf tails of every length, as a source list's end or a masked
    # source gives them; "masked" leaves most rows with nothing.
    tail = rng.integers(0, W + 1, (G, R))
    if kind == "masked":
        tail = np.where(rng.random((G, R)) < 0.7, W, tail)
        tail[0] = W  # group 0: every row masked
    ws[np.arange(W)[None, None, :] >= (W - tail)[..., None]] = NEG_INF
    if kind == "mixed":  # some rows out of order
        for g in range(G):
            for r in rng.choice(R, max(1, R // 3), replace=False):
                ws[g, r] = rng.permutation(ws[g, r])
    return wk, ws


def _check_merge(wk, ws, block):
    """The model equals the plain version and lax.top_k bit for bit; →
    the number of rows it sorted."""
    tk, ts = torch.from_numpy(wk), torch.from_numpy(ws)
    mk, ms, mi, n_sorted = ref.merge_topk_ranked(tk, ts, block)
    pk, ps, pi = ref.merge_topk(tk, ts, block)
    for a, b in ((mk, pk), (ms, ps), (mi, pi)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for g in range(wk.shape[0]):
        js, ji = jax.lax.top_k(jnp.asarray(ws[g].reshape(-1)), block)
        np.testing.assert_array_equal(mi[g].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ms[g].numpy(), np.asarray(js))
        np.testing.assert_array_equal(mk[g].numpy(),
                                      wk[g].reshape(-1)[np.asarray(ji)])
    return n_sorted


MERGE_KINDS = ["sorted", "masked", "unsorted", "equal", "cross_ties",
               "mixed"]
# (G, R, W, block): the engine's layout cut down (W = block), block = R*W,
# W > block and W < block, one row, a W that is no power of two.
MERGE_SHAPES = [(2, 11, 16, 16), (2, 3, 8, 24), (1, 4, 32, 8),
                (2, 5, 6, 20), (1, 1, 33, 33)]


@pytest.mark.parametrize("G,R,W,block", MERGE_SHAPES)
@pytest.mark.parametrize("kind", MERGE_KINDS)
def test_merge_topk_ranked_matches_plain_and_jax(kind, G, R, W, block):
    wk, ws = _windows(np.random.default_rng(R * 100 + W), kind, G, R, W)
    n_sorted = _check_merge(wk, ws, block)
    unsorted_rows = sum(not (ws[g, r][:-1] >= ws[g, r][1:]).all()
                        for g in range(G) for r in range(R))
    assert n_sorted == unsorted_rows
    if kind in ("sorted", "masked", "cross_ties", "equal"):
        assert n_sorted == 0, "rows in order are taken as they are"


def test_merge_topk_ranked_matches_pallas_kernel():
    """Scores equal the Pallas kernel's (interpret) on the engine's layout
    with mixed rows; its network is not stable, so scores only."""
    wk, ws = _windows(np.random.default_rng(7), "mixed", 2, 11, 16)
    _, s, _, _ = ref.merge_topk_ranked(torch.from_numpy(wk),
                                       torch.from_numpy(ws), 16)
    for g in range(2):
        _, js = jmerge_topk.merge_topk(jnp.asarray(wk[g]), jnp.asarray(ws[g]),
                                       16)
        np.testing.assert_array_equal(s[g].numpy(), np.asarray(js))
        _, js2 = jref.merge_topk_ref(jnp.asarray(wk[g]), jnp.asarray(ws[g]),
                                     16)
        np.testing.assert_array_equal(s[g].numpy(), np.asarray(js2))


@given(st.integers(1, 3), st.integers(1, 6), st.integers(1, 24),
       st.sampled_from(MERGE_KINDS), st.integers(0, 2**31 - 1))
@settings(max_examples=30, deadline=None)
def test_merge_topk_ranked_property(G, R, W, kind, seed):
    rng = np.random.default_rng(seed)
    wk, ws = _windows(rng, kind, G, R, W)
    _check_merge(wk, ws, int(rng.integers(1, R * W + 1)))


# ----------------------------------------------------------- rank_join_lookup
def _ring(rng, N, cnt, dup_live=False):
    """A ring of unique keys with PAD slots; with ``dup_live`` some live
    keys repeat."""
    keys = rng.choice(10**6, N, replace=False).astype(np.int32)
    keys[rng.random(N) < 0.1] = PAD
    scores = rng.random(N).astype(np.float32)
    live = min(max(cnt, 0), N)
    if dup_live and live > 8:
        src = rng.choice(live, 4, replace=False)
        for s_ in src:
            for d in rng.choice(live, 2, replace=False):
                keys[d] = keys[s_] if keys[s_] != PAD else keys[d]
    return keys, scores


def _probes(rng, keys, cnt, B, kind):
    """Probes that hit live slots, the last live and the first dead slot
    (an off-by-one in the live prefix shows there), miss, or are PAD."""
    N = keys.shape[0]
    if kind == "all_pad":
        return np.full(B, PAD, np.int32)
    live = min(max(cnt, 0), N)
    edge = [keys[i] for i in (live - 1, live) if 0 <= i < N]
    pool = keys[:max(live, 1)]
    p = np.concatenate([edge, rng.choice(pool, B // 2),
                        rng.integers(2 * 10**6, 3 * 10**6, B)])[:B - 2]
    p = np.concatenate([p, [PAD, PAD]]).astype(np.int32)
    if kind == "dup_probes":
        p[B // 2:B // 2 + B // 4] = p[:B // 4]
    return rng.permutation(p)


def _lookup_case(seed, N, B, cnts, kind):
    rng = np.random.default_rng(seed)
    rings = [_ring(rng, N, c, dup_live=kind == "dup_live") for c in cnts]
    keys = np.stack([r[0] for r in rings])
    scores = np.stack([r[1] for r in rings])
    probes = np.stack([_probes(rng, keys[g], c, B, kind)
                       for g, c in enumerate(cnts)])
    return keys, scores, probes, np.array(cnts, np.int32)


def _check_lookup(keys, scores, probes, cnt, exact=True, pallas=False,
                  jax_too=True):
    t = [torch.from_numpy(a) for a in (keys, scores, probes, cnt)]
    ms, mf = ref.rank_join_lookup_split(*t, rank_join.CHUNKS)
    ps, pf = ref.rank_join_lookup(*t)
    np.testing.assert_array_equal(mf.numpy(), pf.numpy())
    cmp = (np.testing.assert_array_equal if exact else
           lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6))
    cmp(ms.numpy(), ps.numpy())
    for g in range(keys.shape[0] if jax_too else 0):
        args = (jnp.asarray(keys[g]), jnp.asarray(scores[g]),
                jnp.asarray(probes[g]), jnp.int32(cnt[g]))
        outs = [jref.rank_join_lookup_ref(*args)]
        if pallas:
            outs.append(jrank_join.rank_join_lookup(*args, interpret=True))
        for js, jf in outs:
            np.testing.assert_array_equal(mf[g].numpy(), np.asarray(jf))
            cmp(ms[g].numpy(), np.asarray(js))
    return mf


# seen_cnt: empty, one slot, partial, a chunk's edge, full, wrapped.
LOOKUP_CNTS = {
    1000: [0, 1, 37, 500, 1000, 1700],      # N not a multiple of a chunk
    4096: [0, 5, 2048, 2049, 4096, 9000],   # N a multiple of every chunk
    13: [0, 3, 13, 40],                     # fewer slots than chunks x 4
}


@pytest.mark.parametrize("kind", ["unique", "dup_probes", "all_pad"])
@pytest.mark.parametrize("N", sorted(LOOKUP_CNTS))
def test_rank_join_lookup_split_matches_plain_and_jax(N, kind):
    B = 16 if N == 13 else 64
    case = _lookup_case(N + len(kind), N, B, LOOKUP_CNTS[N], kind)
    found = _check_lookup(*case, pallas=N == 1000 and kind == "unique")
    if kind == "all_pad":
        assert not found.any()
    else:
        assert found[1:].any() and not found[0].any()


@pytest.mark.parametrize("N", [1000, 4096])
def test_rank_join_lookup_split_duplicate_live_keys(N):
    """Duplicate live ring keys: found exact, sums within rtol 1e-6 (the
    order of the adds differs from the plain version's and the jnp dot's)."""
    case = _lookup_case(N, N, 64, LOOKUP_CNTS[N], "dup_live")
    _check_lookup(*case, exact=False, pallas=N == 1000)


def test_rank_join_lookup_split_chunks_and_table():
    """The model's chunks cover the live prefix exactly and in multiples of
    4, and a duplicated probe reads the entry of its key's first place."""
    for live in (1, 3, 4, 5, 31, 32, 33, 1000, 16384):
        chunk = (-(-live // rank_join.CHUNKS) + 3) & ~3
        spans = [(min(live, c * chunk), min(live, (c + 1) * chunk))
                 for c in range(rank_join.CHUNKS)]
        assert spans[0][0] == 0 and spans[-1][1] == live
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert chunk % 4 == 0
    keys = np.array([[7, 3, PAD, 9, 7, 11]], np.int32)
    scores = np.array([[0.5, 0.25, 1.0, 0.125, 2.0, 4.0]], np.float32)
    probes = np.array([[7, 7, PAD, 3, 12, 7, 9]], np.int32)
    s, f = ref.rank_join_lookup_split(*(torch.from_numpy(a) for a in (
        keys, scores, probes, np.array([5], np.int32))), rank_join.CHUNKS)
    np.testing.assert_array_equal(
        f[0].numpy(), [True, True, False, True, False, True, True])
    np.testing.assert_array_equal(
        s[0].numpy(), np.float32([2.5, 2.5, 0.0, 0.25, 0.0, 2.5, 0.125]))


@given(st.integers(1, 3), st.integers(1, 300), st.integers(1, 40),
       st.sampled_from(["unique", "dup_probes", "all_pad"]),
       st.integers(0, 2**31 - 1))
@settings(max_examples=30, deadline=None)
def test_rank_join_lookup_split_property(G, N, B, kind, seed):
    """Random shapes against the plain version (which the tests above and
    tests/test_torch_kernels.py hold against JAX; a jnp oracle would
    compile anew for every shape drawn)."""
    rng = np.random.default_rng(seed)
    cnts = [int(c) for c in rng.integers(-2, 2 * N + 2, G)]
    _check_lookup(*_lookup_case(seed, N, max(B, 3), cnts, kind),
                  jax_too=False)
