"""CPU model of the ``neigh_softmax_agg`` CUDA schedule, and the gather
kernels' plain versions at their edges, against JAX.

``kernels.ref.neigh_softmax_agg_grouped`` is the schedule of
``csrc/neigh_agg.cu``: row groups of 32 / LPR rows (the last one ragged),
passes of 64 slots, each pass's live slots packed in slot order, slot groups
of LPS lanes that take every G-th list entry, and xor trees for the row's
sums. It is held here against the plain version the kernel is held to on
the card, and against the JAX package's Pallas kernel (interpret mode) and
oracle, within the reference's rtol 1e-4 atol 1e-5. ``embedding_bag`` keeps
its kernel (at half its bound or more by device time); its plain version is
held against JAX at the bag's edges, within rtol/atol 1e-6.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ref as jref
from repro.kernels import neigh_agg as jneigh_agg
from repro.kernels import embedding_bag as jembedding_bag
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)


def _agg_case(rng, N, MAXD, D, live=0.45):
    """Logits of std 3, normal features, slots live with probability
    ``live``; row 0 and every 5th row have no live slot."""
    lg = (rng.standard_normal((N, MAXD)) * 3).astype(np.float32)
    ft = rng.standard_normal((N, MAXD, D)).astype(np.float32)
    mk = rng.random((N, MAXD)) < live
    mk[::5] = False
    return lg, ft, mk


def _check_model(lg, ft, mk, vec=None, jax_ref=False, pallas=False):
    """The model: within rtol 1e-4 atol 1e-5 of the plain version (and of
    JAX's oracle and Pallas kernel where asked), empty rows exactly 0, every
    live slot read once and no other; → its output."""
    tl, tf, tm = (torch.from_numpy(a) for a in (lg, ft, mk))
    got, read = ref.neigh_softmax_agg_grouped(tl, tf, tm, vec=vec)
    assert got.shape == (lg.shape[0], ft.shape[-1])
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref.neigh_softmax_agg(tl, tf, tm),
                               rtol=1e-4, atol=1e-5)
    args = (jnp.asarray(lg), jnp.asarray(ft), jnp.asarray(mk))
    wants = [jref.neigh_softmax_agg_ref(*args)] if jax_ref else []
    if pallas:
        wants.append(jneigh_agg.neigh_softmax_agg(*args, tile_n=64))
    for want in wants:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    empty = ~mk.any(1)
    assert torch.equal(got[torch.from_numpy(empty)],
                       torch.zeros_like(got[torch.from_numpy(empty)]))
    assert sorted(read) == sorted(map(tuple, np.argwhere(mk).tolist()))
    return got


# MAXD: one slot, fewer than a lane group's, one pass's worth and GAT's;
# D: one float, GAT's two widths, float2 vectors, and the wide layout's
# four vectors a lane. 37 rows: a ragged last row group at every LPR.
@pytest.mark.parametrize("MAXD", [1, 3, 33, 56])
@pytest.mark.parametrize("D", [1, 8, 10, 47, 130])
def test_neigh_agg_model_matches_plain(MAXD, D):
    rng = np.random.default_rng(1000 * MAXD + D)
    _check_model(*_agg_case(rng, 37, MAXD, D))


@pytest.mark.parametrize("MAXD,D", [(1, 1), (3, 10), (33, 8), (56, 47),
                                    (56, 130)])
def test_neigh_agg_model_matches_jax(MAXD, D):
    """Against JAX's oracle at every MAXD and every D above."""
    rng = np.random.default_rng(1000 * MAXD + D)
    _check_model(*_agg_case(rng, 37, MAXD, D), jax_ref=True)


@pytest.mark.parametrize("MAXD,D", [(56, 8), (56, 47), (33, 10)])
def test_neigh_agg_model_matches_pallas_kernel(MAXD, D):
    """Against the Pallas kernel in interpret mode too (tile_n 64, so the
    130 rows are three of its tiles, the last one padded)."""
    rng = np.random.default_rng(7 + D)
    _check_model(*_agg_case(rng, 130, MAXD, D), jax_ref=True, pallas=True)


@pytest.mark.parametrize("MAXD,D", [(64, 8), (65, 8), (129, 47), (200, 3)])
def test_neigh_agg_model_passes(MAXD, D):
    """Rows of exactly one pass of 64 slots, of one slot more, and of three
    and four passes: the max and the sum run over every pass before any
    weight is made, and each pass's list is rebuilt."""
    rng = np.random.default_rng(MAXD)
    _check_model(*_agg_case(rng, 23, MAXD, D, live=0.3))


@pytest.mark.parametrize("D,vec", [(8, 1), (8, 2), (10, 1), (130, 1)])
def test_neigh_agg_model_narrower_vectors(D, vec):
    """A feature pointer that is not 16-byte aligned makes the kernel read
    narrower vectors (more lanes a slot, fewer slot groups): the sums
    change order, not value beyond the reference's bar."""
    rng = np.random.default_rng(D * vec)
    lg, ft, mk = _agg_case(rng, 29, 56, D)
    wide = _check_model(lg, ft, mk)
    narrow = _check_model(lg, ft, mk, vec=vec)
    torch.testing.assert_close(narrow, wide, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("MAXD,D", [(56, 8), (56, 47), (3, 1), (70, 130)])
def test_neigh_agg_model_never_reads_masked_slots(MAXD, D):
    """NaN and inf features in every masked slot: the model reads none of
    them, so its output is bit-equal to the one on clean features and
    finite; the plain version (as the reference) gives NaN rows."""
    rng = np.random.default_rng(3 + D)
    lg, ft, mk = _agg_case(rng, 41, MAXD, D)
    clean = _check_model(lg, ft, mk)
    dirty = ft.copy()
    dirty[~mk] = np.nan
    dirty[~mk & (np.arange(MAXD) % 2 == 0)] = np.inf
    got, _ = ref.neigh_softmax_agg_grouped(*(torch.from_numpy(a) for a in (
        lg, dirty, mk)))
    assert torch.equal(got, clean) and bool(torch.isfinite(got).all())
    plain = ops.neigh_softmax_agg(*(torch.from_numpy(a) for a in (
        lg, dirty, mk)))
    assert not bool(torch.isfinite(plain[torch.from_numpy(mk.any(1))]).all())


def test_neigh_agg_model_all_masked_and_all_live():
    """Every row empty gives exactly 0; every slot live reads every slot."""
    rng = np.random.default_rng(5)
    lg, ft, _ = _agg_case(rng, 18, 56, 8)
    got = _check_model(lg, ft, np.zeros((18, 56), bool))
    assert torch.equal(got, torch.zeros_like(got))
    _check_model(lg, ft, np.ones((18, 56), bool))


def test_agg_lanes_layout():
    """The lanes the kernel gives a slot and a row at GAT's widths and at
    the layout's edges: (LPS, KC, LPR, column tiles)."""
    assert ref.agg_lanes(8, 4) == (2, 1, 8, 1)      # 4 rows, 4 slots a step
    assert ref.agg_lanes(47, 1) == (16, 3, 32, 1)   # 2 slots a step
    assert ref.agg_lanes(1, 1) == (1, 1, 8, 1)
    assert ref.agg_lanes(64, 4) == (16, 1, 16, 1)
    assert ref.agg_lanes(100, 4) == (32, 1, 32, 1)
    assert ref.agg_lanes(130, 2) == (32, 4, 32, 1)
    assert ref.agg_lanes(1030, 2) == (32, 4, 32, 5)


@settings(max_examples=25, deadline=None)
@given(N=st.integers(1, 40), MAXD=st.integers(1, 80),
       D=st.sampled_from([1, 2, 3, 8, 12, 47, 64]),
       live=st.floats(0.0, 1.0), seed=st.integers(0, 2**16))
def test_neigh_agg_model_property(N, MAXD, D, live, seed):
    lg, ft, mk = _agg_case(np.random.default_rng(seed), N, MAXD, D, live)
    tl, tf, tm = (torch.from_numpy(a) for a in (lg, ft, mk))
    got, read = ref.neigh_softmax_agg_grouped(tl, tf, tm)
    torch.testing.assert_close(got, ref.neigh_softmax_agg(tl, tf, tm),
                               rtol=1e-4, atol=1e-5)
    assert len(read) == int(mk.sum())


# --------------------------------------------------------------- embedding_bag
def _bag(rng, V, D, B, S, dead=0.25, lo=0):
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(lo, V, (B, S)).astype(np.int32)
    ids[rng.random((B, S)) < dead] = -1
    w = rng.random((B, S)).astype(np.float32)
    return table, ids, w


def _check_bag(table, ids, w):
    out = ops.embedding_bag(*(torch.from_numpy(a) for a in (table, ids, w)))
    assert out.shape == (ids.shape[0], table.shape[1])
    args = (jnp.asarray(table), jnp.asarray(ids), jnp.asarray(w))
    for want in (jref.embedding_bag_ref(*args),
                 jembedding_bag.embedding_bag(*args, interpret=True)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    return out


@pytest.mark.parametrize("S", [1, 3, 7, 9])
def test_embedding_bag_bag_lengths(S):
    """Bags of one slot and of lengths no multiple of 4 (the kernel's
    slots a step), a quarter of the slots -1."""
    _check_bag(*_bag(np.random.default_rng(S), 300, 16, 6, S))


def test_embedding_bag_dead_bags_are_zero():
    """A bag whose ids are all -1 gives exactly 0, beside live bags."""
    table, ids, w = _bag(np.random.default_rng(11), 200, 8, 5, 6)
    ids[1] = -1
    ids[3] = -1
    out = _check_bag(table, ids, w)
    assert torch.equal(out[1], torch.zeros(8))
    assert torch.equal(out[3], torch.zeros(8))


def test_embedding_bag_ids_above_2_23():
    """Ids above 2**23 (whose row offsets pass 2**31 floats at D = 256):
    the plain version gathers the right rows."""
    V, D = 2**23 + 64, 4
    rng = np.random.default_rng(12)
    table = np.zeros((V, D), np.float32)
    ids = rng.integers(2**23, V, (8, 3)).astype(np.int32)
    table[ids.reshape(-1)] = rng.standard_normal((ids.size, D))
    w = rng.random((8, 3)).astype(np.float32)
    out = ops.embedding_bag(*(torch.from_numpy(a) for a in (table, ids, w)))
    want = np.einsum("bsd,bs->bd", table[ids], w)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)
