"""``kernels/ref.py``'s ``embedding_bag_backward_grouped``, the CPU model of
``csrc/embedding_bag.cu``'s table gradient, against the reference.

The model is the kernel pass by pass: a stable LSD radix sort of the live
slots by id (8-bit digits over ceil(log2 V) bits, tiles of 1,024 slots,
each slot placed by its (digit, tile) offset, its warp's and chunk's
earlier counts and its rank among its chunk's lanes), then each run of one
id summed from 0 in ascending slot order with the products rounded. Held
bit for bit: its permutation against numpy's stable argsort by id, its
gradient against ``jax.vjp`` of the JAX package's ``embedding_bag_ref``
and against the plain ``ref.embedding_bag_backward`` (``index_add_``). A
model with ranks reversed inside a tile, one with an FMA for the rounded
product, and one that sums each run backwards must fail those checks.
Inputs are numpy draws from fixed seeds.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ref as jref
from repro_torch.kernels import embedding_bag, ref

CU = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
      / "kernels" / "csrc" / "embedding_bag.cu")


def _inputs(seed, V, B, S, D, kind="quarter -1", lo=0):
    """ids (B, S) int32, weights (B, S) and dout (B, D) float32.
    ``quarter -1``: ids in [lo, V), a quarter of the slots −1; ``dead
    bag``: that and bag 0 all −1; ``hot``: every bag one id of three."""
    rng = np.random.default_rng(seed)
    if kind == "hot":
        hot = rng.integers(lo, V, 3)
        ids = np.repeat(hot[rng.integers(0, 3, B)][:, None], S, 1)
    else:
        ids = rng.integers(lo, V, (B, S))
        ids[rng.random((B, S)) < 0.25] = -1
        if kind == "dead bag":
            ids[0] = -1
    w = rng.random((B, S)) * 2 - 0.5
    dout = rng.standard_normal((B, D))
    return ids.astype(np.int32), w.astype(np.float32), dout.astype(np.float32)


def _jax_grad(ids, w, dout, V):
    table = jnp.zeros((V, dout.shape[1]), jnp.float32)
    _, vjp = jax.vjp(lambda t: jref.embedding_bag_ref(t, jnp.asarray(ids),
                                                      jnp.asarray(w)), table)
    return np.asarray(vjp(jnp.asarray(dout))[0])


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _stable_order(ids):
    flat = ids.reshape(-1)
    live = np.flatnonzero(flat >= 0)
    return live[np.argsort(flat[live], kind="stable")]


def _failures(ids, w, dout, V, with_jax=True):
    """The checks the model must pass, by name → whether each failed."""
    ids_t, w_t, d_t = map(torch.from_numpy, (ids, w, dout))
    table = torch.empty((V, dout.shape[1]))
    keys, slots = ref.embedding_bag_group(ids_t, V)
    order = _stable_order(ids)
    got = ref.embedding_bag_backward_grouped(d_t, ids_t, w_t, table).numpy()
    plain = ref.embedding_bag_backward(d_t, ids_t, w_t, table)[0].numpy()
    out = {"permutation": not (np.array_equal(slots.numpy(), order)
                               and np.array_equal(keys.numpy(),
                                                  ids.reshape(-1)[order])),
           "plain": not np.array_equal(_bits(got), _bits(plain))}
    if with_jax:
        out["jax"] = not np.array_equal(_bits(got),
                                        _bits(_jax_grad(ids, w, dout, V)))
    return out


CASES = [  # (V, B, S, D, kind, lo)
    (50, 300, 8, 8, "quarter -1", 0),
    (20_000, 400, 32, 16, "quarter -1", 0),
    (300, 64, 16, 8, "dead bag", 0),
    (1000, 512, 8, 8, "hot", 0),
    (2**23 + 4_000, 96, 16, 4, "quarter -1", 2**23),
    (2**8, 200, 9, 4, "quarter -1", 0),
    (2**8 + 1, 200, 9, 4, "quarter -1", 0),
    (2**12 + 1, 300, 11, 4, "quarter -1", 2**12 - 40),
    (2**16 + 1, 300, 11, 4, "quarter -1", 2**16 - 40),
    (2**24 + 1, 120, 8, 4, "quarter -1", 2**24 - 40),
    (1, 40, 5, 4, "quarter -1", 0),
    (97, 37, 7, 4, "quarter -1", 0),            # B·S = 259 < one tile
    (5_000, 301, 13, 4, "quarter -1", 0),       # B·S = 3,913: 4 tiles
]


@pytest.mark.parametrize("V,B,S,D,kind,lo", CASES)
def test_grouped_bit_equal_to_jax_and_plain(V, B, S, D, kind, lo):
    ids, w, dout = _inputs(V + B, V, B, S, D, kind, lo)
    assert _failures(ids, w, dout, V) == {"permutation": False,
                                         "plain": False, "jax": False}


def test_grouped_touched_rows_only():
    """Rows no live slot names stay exactly 0; a row whose terms cancel
    is written as +0, as in the reference."""
    ids = np.array([[3, 3, -1], [5, -1, -1]], np.int32)
    w = np.array([[1.0, -1.0, 7.0], [2.0, 0.0, 0.0]], np.float32)
    dout = np.array([[1.5, -2.0, 0.25, 4.0], [1.0, 1.0, 1.0, 1.0]],
                    np.float32)
    got = ref.embedding_bag_backward_grouped(
        *map(torch.from_numpy, (dout, ids, w)), torch.empty((8, 4))).numpy()
    assert not got[[0, 1, 2, 4, 6, 7]].any()
    assert np.array_equal(_bits(got[3]), np.zeros(4, np.uint32))
    assert np.array_equal(got[5], 2 * dout[1])
    assert np.array_equal(_bits(got), _bits(_jax_grad(ids, w, dout, 8)))


def test_grouped_empty_and_all_dead():
    for shape in ((0, 4), (3, 0), (4, 6)):
        ids = np.full(shape, -1, np.int32)
        w = np.ones(shape, np.float32)
        dout = np.ones((shape[0], 4), np.float32)
        keys, slots = ref.embedding_bag_group(torch.from_numpy(ids), 10)
        assert keys.numel() == slots.numel() == 0
        got = ref.embedding_bag_backward_grouped(
            *map(torch.from_numpy, (dout, ids, w)), torch.empty((10, 4)))
        assert not got.any() and got.shape == (10, 4)


def test_sort_passes_and_ranks():
    """Passes by V; the rank of a tile's slot is its count of earlier equal
    digits in slot order, its histogram the tile's counts."""
    assert [ref.bag_sort_shifts(v) for v in (1, 2, 256, 257, 2**16,
                                             2**16 + 1, 10_000_000,
                                             2**24 + 1)] == [
        [0], [0], [0], [0, 8], [0, 8], [0, 8, 16], [0, 8, 16],
        [0, 8, 16, 24]]
    assert ref.bag_id_bits(2**40) == 31
    rng = np.random.default_rng(3)
    dig = rng.integers(0, 6, (2, ref.BAG_TILE))
    dig[1, 100:300] = ref.BAG_BINS          # empty places
    rank, hist = ref._bag_ranks(torch.from_numpy(dig))
    for t in range(2):
        seen = {}
        for i, d in enumerate(dig[t]):
            if d < ref.BAG_BINS:
                assert rank[t, i] == seen.get(d, 0)
                seen[d] = seen.get(d, 0) + 1
        assert hist[t].tolist() == [seen.get(d, 0)
                                    for d in range(ref.BAG_BINS)]


@settings(deadline=None, max_examples=25)
@given(V=st.sampled_from([1, 2, 3, 255, 256, 257, 5_000, 70_000]),
       B=st.integers(1, 40), S=st.integers(1, 40),
       kind=st.sampled_from(["quarter -1", "dead bag", "hot"]),
       seed=st.integers(0, 2**16))
def test_grouped_property(V, B, S, kind, seed):
    ids, w, dout = _inputs(seed, V, B, S, 4, kind)
    assert not any(_failures(ids, w, dout, V).values())


def _reversed_ranks(dig):
    rank, hist = _ranks_of_model(dig)
    live = dig < ref.BAG_BINS
    count = torch.zeros_like(rank)
    count[live] = hist.gather(1, dig.clamp(max=ref.BAG_BINS - 1))[live]
    return torch.where(live, count - 1 - rank, rank), hist


def _fma(acc, w, g):
    return (acc.double() + w.double()[:, None] * g.double()).float()


def _backwards(w, g, starts, lens):
    acc = torch.zeros((starts.numel(), g.shape[1]), dtype=torch.float32)
    for j in range(int(lens.max()) - 1, -1, -1):
        on = (lens > j).nonzero().squeeze(1)
        at = starts[on] + j
        acc[on] = acc[on] + w[at][:, None] * g[at]
    return acc


_ranks_of_model = ref._bag_ranks


@pytest.mark.parametrize("name,fn,caught_by", [
    ("_bag_ranks", _reversed_ranks, {"permutation", "plain", "jax"}),
    ("_bag_term", _fma, {"plain", "jax"}),
    ("_bag_run_sums", _backwards, {"plain", "jax"}),
])
def test_mutants_fail(monkeypatch, name, fn, caught_by):
    """An unstable scatter (ranks reversed inside a tile), an FMA for the
    rounded product and a run summed backwards each fail the checks that
    the model passes, on repeated ids with non-dyadic values."""
    ids, w, dout = _inputs(7, 1000, 512, 8, 8, "hot")
    assert not any(_failures(ids, w, dout, 1000).values())
    monkeypatch.setattr(ref, name, fn)
    failed = _failures(ids, w, dout, 1000)
    assert {k for k, v in failed.items() if v} == caught_by


def test_kernel_constants_and_source():
    """The .cu's digit, warps and chunks equal the model's; its scratch
    count equals ``bwd_scratch_bytes``; the table gradient uses no float
    atomic (its only atomic adds integer histogram counts) and no library
    sort."""
    src = CU.read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", src)}
    assert consts["RADIX_BITS"] == ref.BAG_RADIX_BITS
    assert consts["SORT_WARPS"] == ref.BAG_WARPS
    assert consts["ITEMS"] == ref.BAG_ITEMS
    assert ("return 4ll * (5 * n + 2 * BINS * n_tiles_of(n) + BINS + 1);"
            in src)
    assert embedding_bag.bwd_scratch_bytes(0) == 4 * 257
    assert embedding_bag.bwd_scratch_bytes(2049) == 4 * (5 * 2049
                                                         + 256 * 7 + 1)
    # One atomic in the file: the sort's integer histogram counts.
    assert re.findall(r"atomic\w*\(([^,]+),", src) == ["hist_next + target"]
    assert "red." not in src
    for lib in ("cub::", "thrust::", "sort(", "argsort", "unique"):
        assert lib not in src
    for step in ("__fmul_rn(w, g.x)", "__fadd_rn(acc.x,"):
        assert step in src
