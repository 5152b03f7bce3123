"""CPU models of the CUDA ``flash_attention``'s tiling and arithmetic.

``kernels.ref.flash_attention_tiles`` lists the (q-tile, k-tile, masked)
triples the kernel visits; it is held against the dense causal / window
mask. ``kernels.ref.flash_attention_blocked`` repeats the kernel's
arithmetic (log2-domain softmax with the folded scale, per-tile online
rescale, p rounded to bf16 before p·v); it is held against the JAX
package's ``flash_attention_ref`` on bf16 inputs within rtol / atol 2e-2,
the tolerance the card checks hold the kernel to, with logits of std 25
that the softcap of 50 bends.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ref as jref
from repro_torch.kernels import ref

# Small tensors: one intra-op thread per test worker keeps the workers of
# a parallel test run from spinning on each other's cores.
torch.set_num_threads(1)

BM = 64                     # a consumer warpgroup's query rows
TILE_BN = (80, 112, 128)    # keys per tile at head_dim 256, 192, 64 / 128
WINDOWS = ("none", "1", "BN-1", "BN", "BN+1", "random")


def _window(kind: str, BN: int, drawn: int) -> int:
    return {"none": 0, "1": 1, "BN-1": BN - 1, "BN": BN, "BN+1": BN + 1,
            "random": drawn}[kind]


def _check_tiles(Sq, Sk, causal, window, BN):
    """Visited tiles are exactly those with a visible pair, and a tile
    marked unmasked has every pair visible."""
    qpos = Sk - Sq + np.arange(Sq)[:, None]
    key = np.arange(Sk)[None, :]
    vis = np.ones((Sq, Sk), bool)
    if causal:
        vis &= key <= qpos
    if window:
        vis &= key > qpos - window
    visits = ref.flash_attention_tiles(Sq, Sk, causal, window, BM, BN)
    assert len(set((qt, kt) for qt, kt, _ in visits)) == len(visits)
    seen = set()
    for qt, kt, masked in visits:
        block = vis[qt * BM:(qt + 1) * BM, kt * BN:(kt + 1) * BN]
        assert block.any(), (qt, kt)
        if not masked:
            assert block.shape[1] == BN and block.all(), (qt, kt)
        seen.add((qt, kt))
    for qt in range(-(-Sq // BM)):
        for kt in range(-(-Sk // BN)):
            if vis[qt * BM:(qt + 1) * BM, kt * BN:(kt + 1) * BN].any():
                assert (qt, kt) in seen, (qt, kt)
    # In order: q-tiles ascending, each one's k-tiles ascending.
    assert visits == sorted(visits)


@given(st.integers(1, 700), st.integers(1, 700), st.booleans(),
       st.sampled_from(WINDOWS), st.integers(1, 700),
       st.sampled_from(TILE_BN))
@settings(max_examples=150, deadline=None)
def test_flash_attention_tiles_cover_the_dense_mask(Sq, Sk, causal, wkind,
                                                     wdrawn, BN):
    _check_tiles(Sq, Sk, causal, _window(wkind, BN, wdrawn), BN)


@pytest.mark.parametrize("BN", TILE_BN)
@pytest.mark.parametrize("Sq,Sk,causal,wkind", [
    (300, 100, True, "none"),       # Sq > Sk: the first 200 rows see nothing
    (700, 1, True, "1"),
    (1, 700, True, "BN+1"),
    (17, 17, True, "BN-1"),
    (640, 640, True, "BN"),
    (129, 700, False, "BN+1"),
    (500, 300, False, "1")])
def test_flash_attention_tiles_edges(Sq, Sk, causal, wkind, BN):
    _check_tiles(Sq, Sk, causal, _window(wkind, BN, 0), BN)


def test_flash_attention_tiles_walk_the_band():
    """A window-W layer visits O(S · W) tiles, not O(S²)."""
    S, W, BN = 8192, 4096, 80
    local = ref.flash_attention_tiles(S, S, True, W, BM, BN)
    full = ref.flash_attention_tiles(S, S, True, 0, BM, BN)
    assert len(local) < 0.8 * len(full)
    per_tile = max(sum(1 for qt, _, _ in local if qt == t)
                   for t in range(S // BM))
    assert per_tile <= -(-(W + BM - 1) // BN) + 1


def _bf16_case(seed, B, Hq, Hkv, Sq, Sk, D):
    """q of std 25 (times D^-0.5 · |k| ≈ 1 gives logits of std 25), k and
    v normal, all rounded to bf16; returned as torch bf16 and f32 numpy."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, Hq, Sq, D), np.float32)
                         * 25).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, Sk, D),
                                                 np.float32)).bfloat16()
            for _ in range(2))
    return (q, k, v), tuple(t.float().numpy() for t in (q, k, v))


def _check_blocked(seed, B, Hq, Hkv, Sq, Sk, D, causal, window, cap, BN):
    (q, k, v), arrays = _bf16_case(seed, B, Hq, Hkv, Sq, Sk, D)
    kw = dict(causal=causal, window=window or None, softcap=cap)
    got = ref.flash_attention_blocked(q, k, v, BN=BN, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = np.asarray(jref.flash_attention_ref(
        *(jnp.asarray(a) for a in arrays), **kw), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)
    return got


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window,cap,BN", [
    (1, 4, 2, 300, 300, 256, True, 0, 50.0, 80),
    (1, 4, 2, 300, 300, 256, True, 129, 50.0, 80),
    (2, 2, 1, 100, 333, 256, True, 0, 50.0, 80),
    (1, 4, 4, 200, 200, 128, False, 0, None, 128),
    (1, 24, 2, 150, 150, 128, True, 64, None, 128),
    (1, 2, 1, 17, 17, 128, True, 1, 50.0, 128),
    (1, 2, 1, 16, 1, 64, True, 0, None, 80),        # one key, 15 rows see none
    (1, 24, 8, 200, 200, 64, True, 0, None, 128),   # granite-moe's layer
    (1, 3, 1, 129, 129, 64, True, 127, 50.0, 128),  # tile edges at D = 64
    (1, 3, 1, 100, 257, 64, True, 128, None, 128),
    (1, 4, 4, 300, 300, 192, True, 0, None, 112),   # MLA's layer, group 1
    (1, 3, 3, 225, 225, 192, True, 113, 50.0, 112),  # tile edges at D = 192
    (1, 2, 2, 100, 333, 192, True, 0, None, 112)])
def test_flash_attention_blocked_matches_jax(B, Hq, Hkv, Sq, Sk, D, causal,
                                             window, cap, BN):
    _check_blocked(5, B, Hq, Hkv, Sq, Sk, D, causal, window, cap, BN)


@given(st.integers(1, 200), st.integers(1, 200), st.booleans(),
       st.sampled_from(WINDOWS), st.integers(1, 200),
       st.sampled_from(TILE_BN), st.booleans(), st.integers(0, 2**31 - 1))
@settings(max_examples=6, deadline=None)
def test_flash_attention_blocked_property(Sq, Sk, causal, wkind, wdrawn, BN,
                                          cap, seed):
    _check_blocked(seed, 1, 2, 1, Sq, Sk, 64, causal,
                   _window(wkind, BN, wdrawn), 50.0 if cap else None, BN)


def test_flash_attention_blocked_empty_rows_are_zero():
    """Sq > Sk, causal: the rows before every key give exactly 0."""
    got = _check_blocked(6, 1, 2, 1, 300, 100, 128, True, 0, 50.0, 128)
    assert torch.equal(got[:, :, :200], torch.zeros_like(got[:, :, :200]))
    assert got[:, :, 200:].abs().sum() > 0


def test_tile_sizes_match_the_kernel_source():
    """``flash_attention.TILE_N`` and ``WARPGROUP_ROWS``, which the tests
    and chip_smoke.py place their edge cases with, are the kernel's."""
    import pathlib
    import re

    from repro_torch.kernels import flash_attention

    src = (pathlib.Path(flash_attention.__file__).parent / "csrc"
           / "flash_attention.cu").read_text()
    tiles = {int(d): int(n) for d, n in re.findall(
        r"struct Tile<(\d+)> \{\s*static constexpr int BN = (\d+);", src)}
    assert tiles == flash_attention.TILE_N
    assert set(tiles) == set(flash_attention.HEAD_DIMS) == {64, 128, 192,
                                                            256}
    cases = set(int(d) for d in re.findall(r"case (\d+):", src))
    assert cases == set(flash_attention.HEAD_DIMS)
    assert re.search(r"constexpr int WG_ROWS = (\d+);", src).group(1) == str(
        flash_attention.WARPGROUP_ROWS) == str(BM)


@pytest.mark.parametrize("D", [32, 64, 96, 128, 192, 256])
def test_check_args_takes_the_kernel_head_dims(D):
    """The wrapper takes head_dim 64, 128, 192 and 256 (the kernels'
    builds) and raises ValueError for any other, before it looks at the
    device: there is no plain fallback for a CUDA tensor."""
    from repro_torch.kernels import flash_attention

    q = torch.zeros((1, 4, 8, D), dtype=torch.bfloat16)
    k = torch.zeros((1, 2, 8, D), dtype=torch.bfloat16)
    if D in (64, 128, 192, 256):
        assert flash_attention.check_args(q, k, k) == (1, 4, 2, 8, 8, D)
    else:
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention.check_args(q, k, k)


@pytest.mark.parametrize("S", [111, 113, 224])
def test_flash_attention_blocked_mla_padded_v(S):
    """MLA's use of the D = 192 build: q·k over 192 columns, v padded from
    128 with zeros, n_kv = n_heads, at S one off and on the 112-key tile:
    the model's columns 128-191 exactly 0 and the rest within the card's
    bar of JAX's oracle on the unpadded v."""
    (q, k, v), (qa, ka, va) = _bf16_case(S, 1, 3, 3, S, S, 192)
    v[..., 128:] = 0
    got = ref.flash_attention_blocked(q, k, v, BN=112)
    assert not got[..., 128:].any()
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(qa), jnp.asarray(ka), jnp.asarray(va[..., :128]),
        scale=192 ** -0.5), np.float32)
    np.testing.assert_allclose(got[..., :128].float().numpy(), want,
                               rtol=2e-2, atol=2e-2)
