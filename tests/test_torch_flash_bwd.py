"""CPU models of the CUDA ``flash_attention_backward``'s schedule and
arithmetic (``csrc/flash_attention_bwd.cu``).

``kernels.ref.flash_attention_bwd_tiles`` lists the 64 x 64 tiles each
consumer warpgroup visits in the dK/dV pass and in the dQ pass, in the
kernel's order; every visible (q, k) pair of every query head must fall in
exactly one tile of each pass, and a tile marked unmasked must hold only
visible pairs. ``kernels.ref.flash_attention_bwd_blocked`` repeats the
kernel's arithmetic (p recomputed in the log2 domain from the forward's
lse, P and dS rounded to bf16 before their products, the passes' order of
adds). All bars are ``ref.flash_attention_bwd_errors``: each gradient's
largest error over its scale.

- Its rounding: fed f32 copies of the bf16 inputs, so that its outputs
  are not rounded, the model lands within ROUND_TOL of an f64 dense
  computation that rounds P and dS to bf16 at the same places (worst
  reading over CASES 2.1e-4). The control, the same computation with P
  and dS left unrounded, lies 1.5e-3 to 2.9e-3 off and must fail the bar
  (except at a window of 1, where P is 1 and dS cancels to ~0). No bar
  here sees the order of the f32 adds; ``_check_pass`` holds the order of
  the visits.
- Against the plain twin ``ref.flash_attention_bwd`` (f32 P and dS, the
  same bf16 o) and ``jax.vjp`` of the JAX package's
  ``flash_attention_ref`` (f32 o), in bf16: within TOL, the bar the card
  holds the kernel to (``chip_smoke.py`` FA_BWD_TOL). Worst readings over
  CASES: 5.5e-3 against the twin, 6.2e-3 against JAX.

Logits have std 25, so the softcap of 50 bends them.
"""
import pathlib
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

# Small tensors: one intra-op thread per test worker keeps the workers of
# a parallel test run from spinning on each other's cores.
torch.set_num_threads(1)

T = 64                      # q rows and keys of a consumer's tile
TOL = 2e-2                  # of each gradient's scale: the card's bar
ROUND_TOL = 6e-4            # the model's rounding against the f64 one's
WINDOWS = ("none", "1", "T-1", "T", "T+1", "2T-1", "2T+1", "random")


def _window(kind: str, drawn: int) -> int:
    return {"none": 0, "1": 1, "T-1": T - 1, "T": T, "T+1": T + 1,
            "2T-1": 2 * T - 1, "2T+1": 2 * T + 1, "random": drawn}[kind]


def _visible(Sq, Sk, causal, window):
    qpos = Sk - Sq + np.arange(Sq)[:, None]
    key = np.arange(Sk)[None, :]
    vis = np.ones((Sq, Sk), bool)
    if causal:
        vis &= key <= qpos
    if window:
        vis &= key > qpos - window
    return vis


def _check_pass(visits, vis, g, row_tile_first):
    """Each tile has a visible pair and its flag is exact; walked for each
    of the g heads, as the kernel does, the tiles cover every visible pair
    of every head exactly once."""
    Sq, Sk = vis.shape
    assert len(set((a, b) for a, b, _ in visits)) == len(visits)
    assert visits == sorted(visits)
    count = np.zeros((g, Sq, Sk), np.int32)
    for a, b, masked in visits:
        qt, kt = (a, b) if row_tile_first else (b, a)
        rows = slice(qt * T, qt * T + T)
        keys = slice(kt * T, kt * T + T)
        block = vis[rows, keys]
        assert block.any(), (qt, kt)
        full = block.shape == (T, T) and block.all()
        assert masked == (not full), (qt, kt, masked)
        for j in range(g):
            count[j, rows, keys] += block
    np.testing.assert_array_equal(count, np.broadcast_to(vis, count.shape))


def _check_tiles(Sq, Sk, causal, window, g=1):
    vis = _visible(Sq, Sk, causal, window)
    dkdv, dq = ref.flash_attention_bwd_tiles(Sq, Sk, causal, window)
    _check_pass(dkdv, vis, g, row_tile_first=False)
    _check_pass(dq, vis, g, row_tile_first=True)
    return dkdv, dq


@given(st.integers(1, 400), st.integers(1, 400), st.booleans(),
       st.sampled_from(WINDOWS), st.integers(1, 400), st.integers(1, 4))
@settings(max_examples=120, deadline=None)
def test_bwd_tiles_cover_each_pair_once(Sq, Sk, causal, wkind, wdrawn, g):
    _check_tiles(Sq, Sk, causal, _window(wkind, wdrawn), g)


@pytest.mark.parametrize("Sq,Sk,causal,wkind", [
    (300, 100, True, "none"),       # Sq > Sk: the first 200 rows see nothing
    (700, 1, True, "1"),
    (1, 700, True, "2T+1"),
    (127, 127, True, "none"),       # a dQ block of 128 rows, one short
    (129, 129, True, "T-1"),        # and one over
    (640, 640, True, "T"),
    (640, 640, True, "2T-1"),
    (129, 700, False, "T+1"),
    (500, 300, False, "1")])
def test_bwd_tiles_edges(Sq, Sk, causal, wkind):
    _check_tiles(Sq, Sk, causal, _window(wkind, 0), g=2)


def test_bwd_tiles_walk_the_band():
    """A window-W layer visits O(S · W) tiles in each pass, not O(S²)."""
    S, W = 8192, 4096
    local = ref.flash_attention_bwd_tiles(S, S, True, W)
    full = ref.flash_attention_bwd_tiles(S, S, True, 0)
    for lp, fp in zip(local, full):
        assert len(lp) < 0.8 * len(fp)
    per_tile = max(sum(1 for a, _, _ in local[1] if a == t)
                   for t in range(S // T))
    assert per_tile <= -(-(W + T - 1) // T) + 1


def _bf16_case(seed, B, Hq, Hkv, Sq, Sk, D):
    """q of std 25 (times D^-0.5 · |k| ≈ 1 gives logits of std 25), k, v
    and do normal, all bf16."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, Hq, Sq, D), np.float32)
                         * 25).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, Sk, D),
                                                 np.float32)).bfloat16()
            for _ in range(2))
    do = torch.from_numpy(rng.standard_normal((B, Hq, Sq, D),
                                              np.float32)).bfloat16()
    return q, k, v, do


def _close(got, want, q, k, v, do, label, tol=TOL):
    want = [torch.tensor(np.asarray(w, np.float32)) for w in want]
    errs = ref.flash_attention_bwd_errors(got, want, q.float(), k.float(),
                                          v.float(), do.float())
    assert max(errs) <= tol, (label, errs)
    return errs


def _blocked(q, k, v, do, causal, window, cap):
    """The blocked model from the plain forward's o (in bf16, as the
    forward kernel gives it) and lse → (its dq, dk, dv, o in f32, lse,
    kwargs)."""
    kw = dict(causal=causal, window=window or None, softcap=cap)
    o, lse = ref.flash_attention_fwd_stats(q.float(), k.float(), v.float(),
                                           **kw)
    got = ref.flash_attention_bwd_blocked(
        q, k, v, o.bfloat16(), lse, do,
        columns=fa.BWD_COLUMNS.get(q.shape[-1]), **kw)
    assert [t.dtype for t in got] == [torch.bfloat16] * 3
    assert [t.shape for t in got] == [q.shape, k.shape, v.shape]
    return got, o, lse, kw


CASES = [  # B, Hq, Hkv, Sq, Sk, D, causal, window, cap
    (1, 4, 2, 200, 200, 256, True, 0, 50.0),        # gemma2-2b global
    (1, 4, 2, 200, 200, 256, True, 129, 50.0),      # a window off the tiles
    (1, 2, 1, 100, 333, 256, True, 0, 50.0),        # Sq < Sk
    (1, 4, 4, 150, 150, 128, False, 0, None),       # non-causal
    (1, 24, 2, 130, 130, 128, True, 64, None),      # starcoder2-3b, GQA 12
    (1, 2, 1, 129, 129, 128, True, 1, 50.0),
    (2, 3, 1, 65, 65, 256, True, 63, None),
    (1, 24, 8, 130, 130, 64, True, 0, None),        # granite-moe's layer
    (1, 3, 1, 129, 129, 64, True, 127, None),       # tile edges at D = 64
    (1, 4, 4, 130, 130, 192, True, 0, None),        # MLA's layer, group 1
    (1, 3, 3, 129, 129, 192, True, 65, 50.0)]       # tile edges at D = 192
# head_dim 64 with the softcap, held to the plain twin and JAX only: the
# f64 control of test_bwd_blocked_rounds_p_and_ds rounds p in f64 where
# the model rounds its f32 value, and at D = 64 (a gradient's scale is
# the largest of 64 columns) the bf16 places that differ reach 9e-4 of
# dv's scale, above ROUND_TOL (the same shape at D = 256: 1.2e-3).
CAP_64 = (1, 4, 2, 200, 200, 64, True, 129, 50.0)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window,cap",
                         CASES + [CAP_64])
def test_bwd_blocked_matches_plain(B, Hq, Hkv, Sq, Sk, D, causal, window,
                                   cap):
    q, k, v, do = _bf16_case(7, B, Hq, Hkv, Sq, Sk, D)
    got, o, lse, kw = _blocked(q, k, v, do, causal, window, cap)
    want = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                   o.bfloat16(), lse, do.float(), **kw)
    _close(got, want, q, k, v, do, "plain")


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window,cap",
                         CASES[:3] + CASES[4:6] + CASES[7:8] + CASES[9:]
                         + [CAP_64])
def test_bwd_blocked_matches_jax_vjp(B, Hq, Hkv, Sq, Sk, D, causal, window,
                                     cap):
    """Against jax.vjp of the JAX package's attention oracle on the same
    bf16 values in f32 (no row without keys: the oracle's softmax of an
    all-masked row has no gradient)."""
    q, k, v, do = _bf16_case(8, B, Hq, Hkv, Sq, Sk, D)
    got, _, _, _ = _blocked(q, k, v, do, causal, window, cap)

    def attn(q_, k_, v_):
        return jref.flash_attention_ref(q_, k_, v_, causal=causal,
                                        window=window or None, softcap=cap)

    arrays = [jnp.asarray(t.float().numpy()) for t in (q, k, v, do)]
    _, vjp = jax.vjp(attn, *arrays[:3])
    _close(got, vjp(arrays[3]), q, k, v, do, "jax")


def _dense(q, k, v, o, lse, do, causal, window, cap, round_pds):
    """The backward in f64 over the whole (q, k) plane from the same bf16
    inputs, o and lse, with P and dS rounded to bf16 before their products
    or not; dk and dv summed over each group's heads; not rounded after."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g, sc = Hq // Hkv, D ** -0.5
    q, o, do = q.double(), o.double(), do.double()
    k, v = (t.double().repeat_interleave(g, 1) for t in (k, v))
    s = (q * sc) @ k.transpose(-1, -2)
    x = cap * torch.tanh(s / cap) if cap else s
    vis = torch.from_numpy(_visible(Sq, Sk, causal, window))
    p = torch.where(vis, torch.exp(x - lse.double()[..., None]), 0.0)
    ds = p * (do @ v.transpose(-1, -2) - (do * o).sum(-1)[..., None])
    if cap:
        ds = ds * (1 - (x / cap) ** 2)
    if round_pds:
        p, ds = (t.to(torch.bfloat16).double() for t in (p, ds))
    dv = (p.transpose(-1, -2) @ do).view(B, Hkv, g, Sk, D).sum(2)
    dk = (ds.transpose(-1, -2) @ q).view(B, Hkv, g, Sk, D).sum(2) * sc
    return ds @ k * sc, dk, dv


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window,cap", CASES)
def test_bwd_blocked_rounds_p_and_ds(B, Hq, Hkv, Sq, Sk, D, causal, window,
                                     cap):
    """The model's f32 outputs within ROUND_TOL of the f64 computation that
    rounds P and dS alike; the one that does not round them outside it."""
    q, k, v, do = _bf16_case(7, B, Hq, Hkv, Sq, Sk, D)
    kw = dict(causal=causal, window=window or None, softcap=cap)
    o, lse = ref.flash_attention_fwd_stats(q.float(), k.float(), v.float(),
                                           **kw)
    o = o.bfloat16()
    got = ref.flash_attention_bwd_blocked(q.float(), k.float(), v.float(),
                                          o.float(), lse, do.float(), **kw)
    assert [t.dtype for t in got] == [torch.float32] * 3
    dense = [_dense(q, k, v, o, lse, do, causal, window, cap, r)
             for r in (True, False)]
    _close(got, dense[0], q, k, v, do, "rounded", ROUND_TOL)
    if window != 1:
        errs = ref.flash_attention_bwd_errors(
            got, [t.float() for t in dense[1]], q.float(), k.float(),
            v.float(), do.float())
        assert max(errs) > ROUND_TOL, ("unrounded control", errs)


@given(st.integers(1, 160), st.integers(1, 160), st.booleans(),
       st.sampled_from(WINDOWS), st.integers(1, 160), st.integers(1, 3),
       st.booleans(), st.integers(0, 2**31 - 1))
@settings(max_examples=6, deadline=None)
def test_bwd_blocked_property(Sq, Sk, causal, wkind, wdrawn, g, cap, seed):
    q, k, v, do = _bf16_case(seed, 1, g, 1, Sq, Sk, 128)
    c = 50.0 if cap else None
    window = _window(wkind, wdrawn)
    got, o, lse, kw = _blocked(q, k, v, do, causal, window, c)
    want = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                   o.bfloat16(), lse, do.float(), **kw)
    _close(got, want, q, k, v, do, "plain")


def test_bwd_blocked_rows_without_keys_are_zero():
    """Sq > Sk, causal: the rows before every key get exactly 0 in dq and
    add nothing to dk and dv."""
    q, k, v, do = _bf16_case(9, 1, 2, 1, 300, 100, 128)
    got, o, lse, kw = _blocked(q, k, v, do, True, 0, None)
    assert not got[0][:, :, :200].any() and got[0][:, :, 200:].any()
    cut = _blocked(q[:, :, 200:], k, v, do[:, :, 200:], True, 0, None)[0]
    for a, b in zip(got[1:], cut[1:]):
        assert torch.equal(a, b)


def test_bwd_tile_sizes_match_the_kernel_source():
    """``flash_attention.BWD_TILE`` (keys a dK/dV block by head_dim),
    ``BWD_ROWS`` (a consumer's tile) and ``BWD_QROWS`` (q rows a dQ block,
    the stat padding), which the tests and chip_smoke.py place their edge
    cases with, are the backward kernel's; the models' tile is BWD_ROWS."""
    src = (pathlib.Path(fa.__file__).parent / "csrc"
           / "flash_attention_bwd.cu").read_text()
    tiles = {int(d): int(n) for d, n in re.findall(
        r"struct KvTile<(\d+)> \{\s*static constexpr int BN = (\d+);", src)}
    assert tiles == fa.BWD_TILE
    assert set(tiles) == set(fa.HEAD_DIMS)
    assert set(int(d) for d in re.findall(r"case (\d+):", src)) == set(
        fa.HEAD_DIMS)
    assert re.search(r"constexpr int BM = (\d+);", src).group(1) == str(
        fa.BWD_ROWS) == str(T)
    assert re.search(r"constexpr int QROWS = (\d+);", src).group(1) == str(
        fa.BWD_QROWS)
    # The dK/dV pass's columns by consumer: all of D below the split's
    # head_dim; from it consumer 0 the first 128, consumer 1 the rest.
    split = int(re.search(r"bool SPLIT = D >= (\d+);", src).group(1))
    assert re.search(r"c0 = SPLIT \? 128 \* w : 0;", src)
    assert "dkdv_consumer<D, CAP, 128>" in src
    assert "dkdv_consumer<D, CAP, D - 128>" in src
    assert fa.BWD_COLUMNS == {
        D: ((0, 128), (128, D - 128)) if D >= split else ((0, D),)
        for D in fa.HEAD_DIMS}


def test_bwd_blocked_mla_padded_v():
    """MLA's use of the D = 192 build: v padded from 128 with zeros and dO
    0 in those columns (the model cuts them off), q·k over 192, n_kv =
    n_heads, S off the tiles: dv's padded columns exactly 0, every
    gradient within TOL of jax.vjp of the oracle on the unpadded v, and
    the split model (``BWD_COLUMNS[192]``) bit-equal to the unsplit one."""
    q, k, v, do = _bf16_case(10, 1, 3, 3, 129, 129, 192)
    v[..., 128:] = 0
    do[..., 128:] = 0
    got, _, lse, kw = _blocked(q, k, v, do, True, 0, None)
    assert not got[2][..., 128:].any()
    o, _ = ref.flash_attention_fwd_stats(q.float(), k.float(), v.float())
    whole = ref.flash_attention_bwd_blocked(q, k, v, o.bfloat16(), lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, whole))

    def attn(q_, k_, v_):
        return jref.flash_attention_ref(q_, k_, v_, scale=192 ** -0.5)

    arrays = [jnp.asarray(t.float().numpy()) for t in (q, k, v, do)]
    _, vjp = jax.vjp(attn, arrays[0], arrays[1], arrays[2][..., :128])
    dq, dk, dv = vjp(arrays[3][..., :128])
    dv = jnp.pad(dv, ((0, 0), (0, 0), (0, 0), (0, 64)))
    _close(got, (dq, dk, dv), q, k, v, do, "jax")
