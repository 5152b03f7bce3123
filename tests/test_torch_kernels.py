"""The port's kernels: plain versions vs the JAX kernels and oracles.

On the CPU the port's wrappers run the plain versions (``kernels.ref``);
these are held bit for bit against the JAX package's Pallas kernels (in
interpret mode) and its jnp oracles. The CUDA kernels themselves run only
on a card: the ``gpu`` tests hold them against the plain versions there.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ref as jref, rank_join as jrank_join
from repro.kernels import merge_topk as jmerge_topk
from repro_torch.kernels import ops, ref, _build
from repro_torch.kernels import rank_join, merge_topk

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


def test_dispatch_and_wrapper_checks():
    """CPU tensors take the plain path without counting launches; the CUDA
    wrappers refuse CPU tensors; a bad impl raises."""
    ops.reset_launches()
    keys = torch.zeros((1, 8), dtype=torch.int32)
    scores = torch.zeros((1, 8))
    probes = torch.zeros((1, 4), dtype=torch.int32)
    cnt = torch.zeros((1,), dtype=torch.int32)
    ops.rank_join_lookup(keys, scores, probes, cnt)
    ops.merge_topk(keys.view(1, 2, 4), scores.view(1, 2, 4), 4)
    assert ops.launches() == {"rank_join_lookup": 0, "merge_topk": 0}
    with pytest.raises(ValueError):
        rank_join.rank_join_lookup(keys, scores, probes, cnt)
    with pytest.raises(ValueError):
        merge_topk.merge_topk(keys.view(1, 2, 4), scores.view(1, 2, 4), 4)
    with pytest.raises(ValueError):
        ops.merge_topk(keys.view(1, 2, 4), scores.view(1, 2, 4), 4,
                       impl="cuda")
    assert merge_topk.padded_len(2816, 256) == 4096
    assert merge_topk.padded_len(3, 2) == 8


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc, no kernels: the build raises instead of falling back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(cuda):
    """On the card: both kernels bit-equal to their plain versions."""
    rng = np.random.default_rng(5)
    cases = [_lookup_case(rng, 5000, 256, c) for c in (0, 1000, 5000, 9000)]
    args = [torch.from_numpy(np.stack([c[j] for c in cases])).to(cuda)
            for j in range(3)]
    cnt = torch.tensor([c[3] for c in cases], dtype=torch.int32,
                       device=cuda)
    got = ops.rank_join_lookup(*args, cnt)
    want = ops.rank_join_lookup(*args, cnt, impl="ref")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    wk, ws = _windows_with_ties(rng, 8, 11, 256)
    wk, ws = torch.from_numpy(wk).to(cuda), torch.from_numpy(ws).to(cuda)
    for a, b in zip(ops.merge_topk(wk, ws, 256),
                    ops.merge_topk(wk, ws, 256, impl="ref")):
        assert torch.equal(a, b)
