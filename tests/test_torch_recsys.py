"""The port's two-tower retrieval path against the JAX package.

Parameters come from the JAX package's ``recsys.init`` and are carried
across with ``convert.two_tower_from_numpy``; inputs are seeded numpy.
Indices and scored-tile counts must be exact, scores within rtol 1e-5.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import two_tower_retrieval as jconf
from repro.models import recsys as jrecsys
from repro_torch import convert
from repro_torch.configs import two_tower_retrieval as conf
from repro_torch.examples import speculative_retrieval
from repro_torch.models import recsys

# Small tensors: one intra-op thread per test worker keeps the workers of
# a parallel test run from spinning on each other's cores.
torch.set_num_threads(1)

CFG = conf.smoke_config()


@pytest.fixture(scope="module")
def params():
    values, _ = jrecsys.init(jax.random.PRNGKey(3), jconf.smoke_config())
    np_values = jax.tree_util.tree_map(np.asarray, values)
    return values, convert.two_tower_from_numpy(np_values, CFG,
                                                device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _user_batch(rng, B):
    ids = rng.integers(-1, CFG.user_vocab, (B, CFG.user_slots))
    return {"user_ids": ids.astype(np.int32),
            "user_w": rng.random((B, CFG.user_slots)).astype(np.float32),
            "user_dense": rng.standard_normal(
                (B, CFG.n_dense_feat)).astype(np.float32)}


def _serve_pair(params, batch, cand, k, **kw):
    values, model = params
    s, i = recsys.serve_batch(model, CFG, {n: _t(a) for n, a in
                                           batch.items()}, _t(cand), k, **kw)
    js, ji = jrecsys.serve_batch(values, jconf.smoke_config(),
                                 {n: jnp.asarray(a) for n, a in
                                  batch.items()}, jnp.asarray(cand), k, **kw)
    return s.numpy(), i.numpy(), np.asarray(js), np.asarray(ji)


def _one_hot_corpus(N, D):
    """Rows ±e_d: every dot product has one non-zero term, so it is exact
    in any summation order and duplicated rows tie exactly."""
    r = np.arange(N)
    c = np.zeros((N, D), np.float32)
    c[r, r % 5] = np.where((r // 5) % 2, -1.0, 1.0)
    return c


def test_configs_match_reference():
    for port, ref in ((conf.config(), jconf.config()),
                      (conf.smoke_config(), jconf.smoke_config())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for name in ("ARCH", "FAMILY", "CORPUS", "N_CAND", "N_CAND_PAD", "TOPK",
                 "TILE"):
        assert getattr(conf, name) == getattr(jconf, name), name


def test_convert_carries_every_parameter(params):
    values, model = params
    for side in ("user", "item"):
        for name, v in values[side].items():
            got = getattr(getattr(model, side), name)
            np.testing.assert_array_equal(got.detach().numpy(),
                                          np.asarray(v))
            assert got.requires_grad
    bad = {"user": {"table": np.zeros((4, 32))}, "item": {}}
    with pytest.raises(ValueError, match="tower keys"):
        convert.two_tower_from_numpy(bad, CFG, device="cpu")


def test_init_shapes_and_distributions():
    """Same shapes as the reference's init; tables normal × 0.01, MLP
    weights normal / √fan_in; the seed fixes the draw."""
    model = recsys.init(CFG, seed=0, device="cpu")
    ref_shapes = jax.eval_shape(
        lambda key: jrecsys.init(key, jconf.smoke_config())[0],
        jax.random.PRNGKey(0))
    for side in ("user", "item"):
        tower = getattr(model, side)
        for name, spec in ref_shapes[side].items():
            assert tuple(getattr(tower, name).shape) == spec.shape, name
        assert abs(float(tower.table.std()) - 0.01) < 0.0005
        for w in tower.mlp:
            assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1.0) < 0.1
    again = recsys.init(CFG, seed=0, device="cpu")
    other = recsys.init(CFG, seed=1, device="cpu")
    assert torch.equal(again.user.table, model.user.table)
    assert not torch.equal(other.user.table, model.user.table)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        recsys.init(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        speculative_retrieval.main([])


@pytest.mark.parametrize("side", ["user", "item"])
def test_tower_matches_jax(params, side):
    """rtol 1e-5 on the unit-norm embeddings; atol 1e-6 covers components
    near 0, where the MLP's sums in another order leave ~1e-7."""
    values, model = params
    rng = np.random.default_rng(2)
    slots = CFG.user_slots if side == "user" else CFG.item_slots
    vocab = CFG.user_vocab if side == "user" else CFG.item_vocab
    ids = rng.integers(-1, vocab, (16, slots)).astype(np.int32)
    w = rng.random((16, slots)).astype(np.float32)
    dense = rng.standard_normal((16, CFG.n_dense_feat)).astype(np.float32)
    with torch.no_grad():
        got = recsys.tower(getattr(model, side), CFG, _t(ids), _t(w),
                           _t(dense))
    want = jrecsys.tower(values[side], jconf.smoke_config(),
                         jnp.asarray(ids), jnp.asarray(w), jnp.asarray(dense))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("norm_sorted", [False, True])
@pytest.mark.parametrize("speculative", [True, False])
def test_score_candidates_matches_jax(params, speculative, norm_sorted):
    values, model = params
    rng = np.random.default_rng(4)
    N, k = 1024, 8
    mags = np.repeat([3.0, 1.5, 0.7, 0.3], N // 4) if norm_sorted else 1.0
    cand = (rng.standard_normal((N, CFG.embed_dim))
            * np.reshape(mags, (-1, 1))).astype(np.float32)
    q = rng.standard_normal(CFG.embed_dim).astype(np.float32)
    s, i, n = recsys.score_candidates(model, CFG, _t(q), _t(cand), k,
                                      speculative=speculative)
    js, ji, jn = jrecsys.score_candidates(values, jconf.smoke_config(),
                                          jnp.asarray(q), jnp.asarray(cand),
                                          k, speculative=speculative)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert int(n) == int(jn)
    if not speculative:
        assert int(n) == N // CFG.topk_tile
    elif norm_sorted:
        assert int(n) < N // CFG.topk_tile, "no tile was pruned"


@pytest.mark.parametrize("norm_sorted", [False, True])
def test_retrieve_matches_jax(norm_sorted):
    """The unsharded branch of the reference's ``_retrieve``."""
    rng = np.random.default_rng(5)
    N, D, k, tile = 4096, 64, 10, 512
    mags = (np.repeat(np.geomspace(4.0, 0.1, N // tile), tile)[:, None]
            if norm_sorted else 1.0)
    cand = (rng.standard_normal((N, D)) * mags / np.sqrt(D)).astype(
        np.float32)
    q = rng.standard_normal(D).astype(np.float32)
    s, i, n = conf.retrieve(_t(q), _t(cand), k, tile)
    js, ji, jn = jconf._retrieve(jnp.asarray(q), jnp.asarray(cand), k=k,
                                 tile=tile)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert int(n) == int(jn)
    assert (int(n) < N // tile) == norm_sorted


def test_serve_batch_matches_jax(params):
    """tests/test_recsys.py's hierarchical case: 4 blocks, chunks of 4."""
    values, model = params
    rng = np.random.default_rng(4)
    batch = _user_batch(rng, 8)
    cand = rng.standard_normal((512, CFG.embed_dim)).astype(np.float32)
    s, i, js, ji = _serve_pair(params, batch, cand, 5, n_blocks=4,
                               batch_chunk=4)
    np.testing.assert_allclose(s, js, rtol=1e-5)
    np.testing.assert_array_equal(i, ji)
    assert i.dtype == np.int32
    # == the full-matrix top-k
    with torch.no_grad():
        u = recsys.tower(model.user, CFG, _t(batch["user_ids"]),
                         _t(batch["user_w"]), _t(batch["user_dense"]))
    es, ei = torch.sort(u @ _t(cand).T, dim=-1, descending=True, stable=True)
    np.testing.assert_allclose(s, es[:, :5].numpy(), rtol=1e-5)
    np.testing.assert_array_equal(i, ei[:, :5].numpy())


@pytest.mark.parametrize("n_blocks,batch_chunk", [(4, 4), (16, 4096)])
def test_serve_batch_ties_keep_lax_order(params, n_blocks, batch_chunk):
    """Duplicated candidate rows: many exact ties inside the top-k and at
    its edge, inside blocks and across them. Indices equal the reference's
    (lax.top_k puts the lower index first; torch.topk does not)."""
    rng = np.random.default_rng(6)
    batch = _user_batch(rng, 8)
    cand = _one_hot_corpus(512, CFG.embed_dim)
    s, i, js, ji = _serve_pair(params, batch, cand, 5, n_blocks=n_blocks,
                               batch_chunk=batch_chunk)
    np.testing.assert_allclose(s, js, rtol=1e-5)
    np.testing.assert_array_equal(i, ji)
    assert (s[:, :1] == s).all(), "expected every row's top-5 to tie"


def test_serve_matches_jax(params):
    """The config's ``serve`` against the reference's ``_serve``."""
    values, model = params
    rng = np.random.default_rng(8)
    batch = _user_batch(rng, 8)
    cand = rng.standard_normal((512, CFG.embed_dim)).astype(np.float32)
    s, i = conf.serve(model, {n: _t(a) for n, a in batch.items()}, _t(cand),
                      5)
    js, ji = jconf._serve(values, {n: jnp.asarray(a) for n, a in
                                   batch.items()}, jnp.asarray(cand),
                          cfg=jconf.smoke_config(), k=5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_serve_batch_rejects_ragged_split(params):
    _, model = params
    batch = {n: _t(a) for n, a in _user_batch(np.random.default_rng(0),
                                              6).items()}
    with pytest.raises(ValueError, match="divide"):
        recsys.serve_batch(model, CFG, batch, torch.zeros((512, 32)), 5,
                           n_blocks=4, batch_chunk=4)


@pytest.mark.parametrize("shape,k", [((7, 40), 5), ((3, 4, 64), 10),
                                     ((5, 12), 12), ((2, 300), 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_top_k_matches_lax_top_k(shape, k, seed):
    """Values on a coarse grid (many ties, -inf included): values and
    indices equal lax.top_k's."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 6, shape) / 4.0).astype(np.float32)
    x[..., ::7] = -np.inf
    v, i = recsys._top_k(torch.from_numpy(x), k)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_example_runs_on_cpu(capsys):
    speculative_retrieval.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "speculative result == exact top-k" in out
    assert "scored  16/32 tiles" in out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_two_tower_serving_matches_cpu(cuda):
    """The smoke-size model served on the card and on the CPU: embeddings
    within rtol 1e-5 / atol 1e-6, and on a corpus of duplicated one-hot
    rows (exact ties) the same indices: lax.top_k's order on both."""
    cpu = recsys.init(CFG, seed=0, device="cpu")
    card = recsys.TwoTower(CFG, *(recsys.Tower(t.table.to(cuda),
                                               [w.to(cuda) for w in t.mlp])
                                  for t in (cpu.user, cpu.item)))
    on_cpu = {n: _t(a) for n, a in
              _user_batch(np.random.default_rng(12), 8).items()}
    on_card = {n: t.to(cuda) for n, t in on_cpu.items()}
    with torch.no_grad():
        u_cpu = recsys.tower(cpu.user, CFG, *on_cpu.values())
        u_card = recsys.tower(card.user, CFG, *on_card.values())
    torch.testing.assert_close(u_card.cpu(), u_cpu, rtol=1e-5, atol=1e-6)
    cand = _t(_one_hot_corpus(512, CFG.embed_dim))
    s_cpu, i_cpu = conf.serve(cpu, on_cpu, cand, 5)
    s_card, i_card = conf.serve(card, on_card, cand.to(cuda), 5)
    torch.testing.assert_close(s_card.cpu(), s_cpu, rtol=1e-5, atol=0)
    assert torch.equal(i_card.cpu(), i_cpu)
