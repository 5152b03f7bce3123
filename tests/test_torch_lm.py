"""The port's LM serving path (gemma2-2b, starcoder2-3b, gemma3-27b and the
MoE LM granite-moe-3b-a800m) against the JAX package, on the CPU.

Weights come from the JAX package's ``transformer.init`` and are carried
across with ``convert.lm_from_numpy``; inputs are seeded numpy. In f32 on
the smoke configs: numerics within 1e-6, attention within 1e-5, logits
within 1e-4 (the logits' std is about 8), cache positions exact. The
reference's ``blocked_causal`` needs S to be a multiple of its chunk (it
leaves the rows past the last whole chunk at 0), so ragged lengths are held
against its ``einsum`` impl.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import gemma2_2b as jgemma, starcoder2_3b as jstar
from repro.configs import gemma3_27b as jgemma3
from repro.configs import granite_moe_3b_a800m as jgranite
from repro.models import attention as jattn
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import gemma2_2b, get_arch, lm_common
from repro_torch.configs import starcoder2_3b
from repro_torch.configs import gemma3_27b, granite_moe_3b_a800m
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf

# Small tensors: one intra-op thread per test worker keeps the workers of
# a parallel test run from spinning on each other's cores.
torch.set_num_threads(1)

ARCHS = {"gemma2-2b": (jgemma, gemma2_2b),
         "starcoder2-3b": (jstar, starcoder2_3b),
         "gemma3-27b": (jgemma3, gemma3_27b),
         "granite-moe-3b-a800m": (jgranite, granite_moe_3b_a800m)}
RNG_SEED = 7


def _np(x):
    return np.asarray(x).astype(np.float32)


def _models(arch, **overrides):
    jmod, pmod = ARCHS[arch]
    jcfg = dataclasses.replace(jmod.smoke_config(), **overrides)
    cfg = dataclasses.replace(pmod.smoke_config(), **overrides)
    values, _ = jtf.init(jax.random.PRNGKey(0), jcfg)
    npv = jax.tree_util.tree_map(np.asarray, values)
    return jcfg, values, cfg, convert.lm_from_numpy(npv, cfg, device="cpu")


@pytest.fixture(scope="module", params=list(ARCHS))
def models(request):
    return _models(request.param)


@pytest.fixture(scope="module")
def gemma():
    return _models("gemma2-2b")


def _tokens(cfg, B, S, seed=RNG_SEED):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


# ------------------------------------------------------------- numerics

@pytest.mark.parametrize("fn", ["rms_norm", "rope", "softcap", "gelu"])
def test_numerics_match_jax(fn):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 8, 16)).astype(np.float32) * 3
    if fn == "rms_norm":
        g = rng.standard_normal(16).astype(np.float32)
        a = jcm.rms_norm(jnp.asarray(x), jnp.asarray(g))
        b = cm.rms_norm(torch.from_numpy(x), torch.from_numpy(g))
    elif fn == "rope":
        pos = rng.integers(0, 5000, (2, 3, 8)).astype(np.int32)
        a = jcm.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
        b = cm.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    elif fn == "softcap":
        a = jcm.softcap(jnp.asarray(x * 20), 50.0)
        b = cm.softcap(torch.from_numpy(x * 20), 50.0)
        t = torch.from_numpy(x)
        assert cm.softcap(t, None) is t
    else:
        a = jcm.gelu(jnp.asarray(x))
        b = cm.gelu(torch.from_numpy(x))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------------ attention

def _layer0(values, model):
    jp = jax.tree_util.tree_map(lambda a: a[0], values["stack_0"]["attn"])
    return jp, model.layers[0].attn


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("impl", ["blocked_causal", "einsum"])
def test_gqa_forward_matches_jax(gemma, impl, window):
    """The port's kernel path (its plain version on the CPU) against each
    JAX impl, at the gemma2 smoke widths with softcap 50."""
    jcfg, values, cfg, model = gemma
    jp, p = _layer0(values, model)
    acfg = cfg.attn_cfg()
    x = np.random.default_rng(2).standard_normal((2, 32, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    want = jattn.gqa_forward(jp, jcfg.attn_cfg(), jnp.asarray(x),
                             jnp.asarray(pos), jnp.int32(window), impl)
    got = attn.gqa_forward(p, acfg, torch.from_numpy(x),
                           torch.from_numpy(np.array(pos)), window,
                           "blocked_causal")
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    if impl == "einsum":
        mine = attn.gqa_forward(p, acfg, torch.from_numpy(x),
                                torch.from_numpy(np.array(pos)), window,
                                "einsum")
        np.testing.assert_allclose(mine.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-5)


def test_ragged_length_matches_einsum(gemma):
    """S = 24 is not a multiple of the smoke chunk (16): the port's kernel
    path computes every row and equals the reference's einsum impl."""
    jcfg, values, cfg, model = gemma
    jp, p = _layer0(values, model)
    x = np.random.default_rng(3).standard_normal((2, 24, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    for window in (0, 16):
        want = jattn.gqa_forward(jp, jcfg.attn_cfg(), jnp.asarray(x),
                                 jnp.asarray(pos), jnp.int32(window),
                                 "einsum")
        got = attn.gqa_forward(p, cfg.attn_cfg(), torch.from_numpy(x),
                               torch.from_numpy(np.array(pos)), window,
                               "blocked_causal")
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("S,W", [(12, 16), (40, 16), (32, 16)])
def test_gqa_prefill_cache_matches_jax(gemma, S, W):
    """S < W pads with pos = -1; S ≥ W keeps the last W rolled by S % W."""
    jcfg, values, cfg, model = gemma
    jp, p = _layer0(values, model)
    x = np.random.default_rng(4).standard_normal((2, S, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    want = jattn.gqa_prefill_cache(jp, jcfg.attn_cfg(), jnp.asarray(x),
                                   jnp.asarray(pos), W)
    got = attn.gqa_prefill_cache(p, cfg.attn_cfg(), torch.from_numpy(x),
                                 torch.from_numpy(np.array(pos)), W)
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    for key in ("k", "v"):
        assert tuple(got[key].shape) == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), _np(want[key]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("window", [0, 16])
def test_gqa_decode_matches_jax(gemma, window):
    """One decode step onto a ring (window 16, S = 20 wraps it) or a full
    cache: the output and the written cache."""
    jcfg, values, cfg, model = gemma
    jp, p = _layer0(values, model)
    rng = np.random.default_rng(5)
    S, W = 20, (16 if window else 32)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    xd = rng.standard_normal((2, 1, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    step = np.full((2,), S, np.int32)
    jc = jattn.gqa_prefill_cache(jp, jcfg.attn_cfg(), jnp.asarray(x),
                                 jnp.asarray(pos), W)
    want, jc2 = jattn.gqa_decode(jp, jcfg.attn_cfg(), jnp.asarray(xd),
                                 jnp.asarray(step), jnp.int32(window), jc,
                                 jnp.int32(S))
    pc = attn.gqa_prefill_cache(p, cfg.attn_cfg(), torch.from_numpy(x),
                                torch.from_numpy(np.array(pos)), W)
    got, pc2 = attn.gqa_decode(p, cfg.attn_cfg(), torch.from_numpy(xd),
                               torch.from_numpy(step), window, pc, S)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pc2["pos"].numpy(), np.asarray(jc2["pos"]))
    np.testing.assert_allclose(pc2["k"].numpy(), _np(jc2["k"]), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------------ the model

def test_prefill_and_decode_match_jax(models):
    """prefill's last logits and every cache, then 3 greedy decode steps,
    against the JAX package (``blocked_causal``) within 1e-4."""
    jcfg, values, cfg, model = models
    toks = _tokens(cfg, 2, 32)
    jl, jc = jtf.prefill(values, jcfg, jnp.asarray(toks), max_seq=40)
    pl, pc = tf.prefill(model, cfg, torch.from_numpy(toks), 40)
    np.testing.assert_allclose(pl.numpy(), _np(jl), rtol=1e-4, atol=1e-4)
    runs = tf.caches_by_run(cfg, pc)
    assert len(runs) == len(jc)
    for a, b in zip(jc, runs):
        np.testing.assert_array_equal(b["pos"].numpy(), np.asarray(a["pos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(b[key].numpy(), _np(a[key]),
                                       rtol=1e-5, atol=1e-5)
    nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    assert np.array_equal(nxt, pl[:, -1].argmax(-1).numpy())
    for st in range(32, 35):
        pos = np.full((2,), st, np.int32)
        jl, jc = jtf.decode_step(values, jcfg, jnp.asarray(nxt),
                                 jnp.asarray(pos), jc, jnp.int32(st))
        pl, pc = tf.decode_step(model, cfg, torch.from_numpy(nxt),
                                torch.from_numpy(pos), pc, st)
        np.testing.assert_allclose(pl.numpy(), _np(jl), rtol=1e-4,
                                   atol=1e-4)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)


def test_decode_matches_full_forward(models):
    """A decode step after the prefill equals the backbone over the prompt
    extended by the greedy token (f32: within 1e-4); the backbone's aux is
    0 for a dense FFN and the MoE's load-balance loss (> 0) otherwise."""
    _, _, cfg, model = models
    toks = torch.from_numpy(_tokens(cfg, 2, 24))
    logits_pf, caches = tf.prefill(model, cfg, toks, 32)
    nxt = logits_pf[:, -1].argmax(-1).to(torch.int32)
    logits_d, _ = tf.decode_step(model, cfg, nxt,
                                 torch.full((2,), 24, dtype=torch.int32),
                                 caches, 24)
    x, aux = tf.backbone(model, cfg, torch.cat([toks, nxt[:, None]], 1))
    assert (aux > 0.0) if cfg.moe else (aux == 0.0)
    full = tf.logits_from_hidden(model, cfg, x)[:, -1]
    np.testing.assert_allclose(logits_d.numpy(), full.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_bf16_prefill_matches_jax():
    """gemma2 smoke widths in bf16 (params and compute): the last logits
    within 0.05 × their std of the JAX package's (bf16 rounds at other
    places in the two frameworks; measured 0.19 of a std of 8.7), and the
    same greedy tokens."""
    jcfg, values, cfg, model = _models(
        "gemma2-2b", param_dtype="bfloat16", compute_dtype="bfloat16")
    assert model.embed.dtype == torch.bfloat16
    toks = _tokens(cfg, 2, 32)
    jl, _ = jtf.prefill(values, jcfg, jnp.asarray(toks), max_seq=40)
    pl, _ = tf.prefill(model, cfg, torch.from_numpy(toks), 40)
    want, got = _np(jl), pl.float().numpy()
    assert np.abs(got - want).max() <= 0.05 * want.std()
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_smoke_run_serves(models):
    """lm_common.smoke_run: one train step, then prefill → argmax → one
    decode step of the updated model; metrics and logits finite."""
    cfg = models[2]
    metrics, logits = lm_common.smoke_run(cfg, seq=20, batch=2,
                                          device="cpu")
    assert logits.shape == (2, cfg.vocab)
    assert torch.isfinite(logits).all()
    assert {"loss", "grad_norm"} <= set(metrics)
    assert all(torch.isfinite(v).all() for v in metrics.values())


def test_init_matches_reference_tree(models):
    """tf.init draws every array of the reference's tree, in its shape and
    dtype: normal × 1/√shape[0], the embedding normal × 1, norms zero."""
    jcfg, values, cfg, _ = models
    gen = torch.Generator().manual_seed(0)
    model = tf.init(cfg, gen, device="cpu")
    ref = convert.lm_from_numpy(
        jax.tree_util.tree_map(np.asarray, values), cfg, device="cpu")
    mine = dict(model.named_parameters())
    theirs = dict(ref.named_parameters())
    assert mine.keys() == theirs.keys()
    for name, t in theirs.items():
        assert mine[name].shape == t.shape and mine[name].dtype == t.dtype
        if name.endswith("norm") or name.endswith("post"):
            assert not mine[name].any()
    assert abs(float(model.embed.std()) - 1.0) < 0.05
    wq = model.layers[0].attn.wq
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1


def test_window_pattern_runs():
    """gemma3-27b's 5:1 pattern: the RLE decode runs cover every layer
    once, local runs at window 1024 and globals at 0, as the
    reference's."""
    cfg = gemma3_27b.config()
    runs = tf._runs(cfg, max_seq=2048)
    assert sum(r[2] for r in runs) == cfg.n_layers
    assert {r[3] for r in runs} == {1024, 0}
    assert runs == jtf._runs(jgemma3.config(), max_seq=2048)


def test_runs_and_caches_by_run():
    """_runs groups layers as the reference does; caches_by_run maps the
    per-layer caches onto those runs."""
    for jmod, pmod in ARCHS.values():
        for max_seq in (8, 40):
            assert tf._runs(pmod.config(), max_seq) == jtf._runs(
                jmod.config(), max_seq)
    cfg = dataclasses.replace(gemma2_2b.smoke_config(),
                              window_pattern=(16, 16, 0))
    caches = [{"k": torch.full((1, 2), float(i))} for i in range(4)]
    runs = tf.caches_by_run(cfg, caches)
    assert [r["k"].shape[0] for r in runs] == [2, 1, 1]
    assert runs[0]["k"][1, 0, 0] == 1.0 and runs[2]["k"][0, 0, 0] == 3.0


# ------------------------------------------------------ weights, devices

def test_lm_from_numpy_bf16_bit_exact_and_key_checks():
    jcfg = dataclasses.replace(jgemma.smoke_config(),
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(gemma2_2b.smoke_config(),
                              param_dtype="bfloat16")
    values, _ = jtf.init(jax.random.PRNGKey(1), jcfg)
    npv = jax.tree_util.tree_map(np.asarray, values)
    assert npv["embed"].dtype.name == "bfloat16"
    model = convert.lm_from_numpy(npv, cfg, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    assert np.array_equal(model.embed.view(torch.int16).numpy(),
                          npv["embed"].view(np.int16))
    wq = npv["stack_0"]["attn"]["wq"][2]
    assert np.array_equal(model.layers[2].attn.wq.view(torch.int16).numpy(),
                          wq.view(np.int16))
    bad = dict(npv, extra=npv["final_norm"])
    with pytest.raises(ValueError, match="keys"):
        convert.lm_from_numpy(bad, cfg, device="cpu")
    st = dict(npv["stack_0"])
    del st["attn_post"]
    with pytest.raises(ValueError, match="keys"):
        convert.lm_from_numpy(dict(npv, stack_0=st), cfg, device="cpu")
    star = starcoder2_3b.smoke_config()
    with pytest.raises(ValueError, match="keys"):
        convert.lm_from_numpy(npv, star, device="cpu")


def test_mla_mtp_configs_and_gnn_registry_entries():
    """MLA and MTP are ported: an MLA config and an MTP config build and
    run the backbone and prefill (an MTP model's prefill never reads its
    mtp module); the registry gives the port's own config modules for the
    equivariant GNNs."""
    gen = torch.Generator()
    base = granite_moe_3b_a800m.smoke_config()
    toks = torch.zeros((1, 4), dtype=torch.int32)
    mla = attn.MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                         qk_nope_head_dim=16, qk_rope_head_dim=8,
                         v_head_dim=16)
    for cfg in (dataclasses.replace(base, mla=mla),
                dataclasses.replace(base, mtp_depth=1)):
        model = tf.init(cfg, gen, device="cpu")
        assert isinstance(model.layers[0].attn,
                          attn.MLA if cfg.mla else attn.GQA)
        assert (model.mtp is not None) == bool(cfg.mtp_depth)
        with torch.no_grad():
            x, _ = tf.backbone(model, cfg, toks)
            logits, caches = tf.prefill(model, cfg, toks, 8)
        assert x.shape == (1, 4, cfg.d_model)
        assert logits.shape == (1, 1, cfg.vocab)
        assert set(caches[0]) == ({"c_kv", "k_rope", "pos"} if cfg.mla
                                  else {"k", "v", "pos"})
    for name in ("egnn", "nequip", "mace"):
        mod = get_arch(name)
        assert mod.__name__ == f"repro_torch.configs.{name}"
        assert mod.ARCH == name and mod.FAMILY == "gnn"


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no device named and no CUDA, init, lm_from_numpy and the
    smoke run (prefill + decode) raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gemma2_2b.smoke_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        gemma2_2b.smoke()
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.lm_from_numpy({}, cfg)
