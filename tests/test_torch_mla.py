"""The port's MLA attention (``models/attention.py``) and deepseek-v3-671b
(MLA, a dense prefix, routed and shared experts, MTP) against the JAX
package, on the CPU.

Weights come from the JAX package's ``init`` and are carried across bit
for bit (``convert.lm_from_numpy`` for the model); inputs are seeded
numpy; everything in f32 unless a case says otherwise. At deepseek's
smoke widths (d_model 64, 4 heads, ranks 32 / 16, q·k 16 + 8, v 16,
chunks of 16): MLA's pieces within 1e-6, its output within 1e-5, its
gradients within rtol 1e-5, atol 1e-7 + 1e-6 of each leaf's largest (PR
22's bar), logits within 1e-4, the model's gradients within 3e-5 of each
leaf's largest (the MoE models' bar, ``test_torch_moe.py``). The
reference's ``blocked_causal`` leaves the rows past the last whole q
chunk at 0, so a ragged length is held against the ``einsum`` impl.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import deepseek_v3_671b as jds
from repro.configs import lm_common as jlm_common
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import deepseek_v3_671b, get_arch, lm_common
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train as train_launch
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.train import loop as train_loop
from repro_torch.train import tree

# Small tensors: one intra-op thread per test worker keeps the workers of
# a parallel test run from spinning on each other's cores.
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(**overrides):
    jcfg = dataclasses.replace(jds.smoke_config(), **overrides)
    cfg = dataclasses.replace(deepseek_v3_671b.smoke_config(), **overrides)
    values, _ = jtf.init(jax.random.PRNGKey(0), jcfg)
    npv = jax.tree_util.tree_map(np.asarray, values)
    return jcfg, values, cfg, convert.lm_from_numpy(npv, cfg, device="cpu")


@pytest.fixture(scope="module")
def deepseek():
    return _models()


def _tokens(cfg, B, S, seed=7):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    return toks, np.roll(toks, -1, 1)


# ------------------------------------------------------------ MLA alone

@pytest.fixture(scope="module")
def mla():
    """JAX's MLA parameters at deepseek's smoke widths, the same arrays as
    the port's ``MLA``, and both AttnConfigs."""
    jcfg = jds.smoke_config().attn_cfg()
    jp, _ = jcm.split(jattn.init_mla(jax.random.PRNGKey(3), jcfg,
                                     jnp.float32))
    p = attn.MLA(*(_t(jp[n]) for n in attn.MLA.NAMES))
    return jcfg, jp, deepseek_v3_671b.smoke_config().attn_cfg(), p


def _x(B, S, seed, D=64):
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return x, pos


def test_mla_qkv_matches_jax(mla):
    """q_nope, the roped q_rope, the normed c_kv and the roped shared key
    (from the unnormed half), at positions off 0 and with q_norm /
    kv_norm not 0."""
    jcfg, jp, cfg, p = mla
    rng = np.random.default_rng(1)
    jp = dict(jp, q_norm=jnp.asarray(rng.standard_normal(32), jnp.float32),
              kv_norm=jnp.asarray(rng.standard_normal(16), jnp.float32))
    p = attn.MLA(*(_t(jp[n]) for n in attn.MLA.NAMES))
    x, pos = _x(2, 24, 2)
    pos += 1000
    want = jattn._mla_qkv(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = attn._mla_qkv(p, cfg, _t(x), _t(pos))
    for name, g, w in zip(("q_nope", "q_rope", "c_kv", "k_rope"), got,
                          want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("impl", ["einsum", "blocked_causal",
                                  "blocked_causal_ad"])
def test_mla_forward_matches_jax(mla, impl):
    """The direct form under each impl against JAX's same impl (the
    port's ``blocked_causal`` is the kernel path, its plain twin on the
    CPU), S = 32: two whole chunks of 16."""
    jcfg, jp, cfg, p = mla
    x, pos = _x(2, 32, 4)
    want = jattn.mla_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                             jnp.int32(0), impl)
    got = attn.mla_forward(p, cfg, _t(x), _t(pos), 0, impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["einsum", "blocked_causal"])
def test_mla_forward_v_narrower_than_its_pad_matches_jax(impl):
    """q·k at 128 + 64 with v at 16 (the launcher's widths in
    ``chip_smoke.py``): v's zero padding (176 columns) is wider than v."""
    import dataclasses
    m = dataclasses.replace(jds.smoke_config().mla, qk_nope_head_dim=128,
                            qk_rope_head_dim=64)
    jcfg = dataclasses.replace(jds.smoke_config(), mla=m).attn_cfg()
    jp, _ = jcm.split(jattn.init_mla(jax.random.PRNGKey(5), jcfg,
                                     jnp.float32))
    p = attn.MLA(*(_t(jp[n]) for n in attn.MLA.NAMES))
    cfg = dataclasses.replace(deepseek_v3_671b.smoke_config(),
                              mla=attn.MLAConfig(**dataclasses.asdict(m)))
    cfg = cfg.attn_cfg()
    x, pos = _x(2, 32, 6)
    want = jattn.mla_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                             jnp.int32(0), impl)
    got = attn.mla_forward(p, cfg, _t(x), _t(pos), 0, impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_mla_ragged_length_matches_einsum(mla):
    """S = 40 is not a multiple of the chunk (16): the port's kernel path
    computes every row and equals JAX's einsum impl and its own (JAX's
    ``blocked_causal`` leaves rows 32-39 at 0)."""
    jcfg, jp, cfg, p = mla
    x, pos = _x(1, 40, 5)
    want = np.asarray(jattn.mla_forward(jp, jcfg, jnp.asarray(x),
                                        jnp.asarray(pos), jnp.int32(0),
                                        "einsum"))
    for impl in ("blocked_causal", "einsum"):
        got = attn.mla_forward(p, cfg, _t(x), _t(pos), 0, impl)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=impl)


@pytest.mark.parametrize("impl", ["einsum", "blocked_causal",
                                  "blocked_causal_ad"])
def test_mla_grads_match_jax(mla, impl):
    """Gradients of Σ out · w by autograd (the kernel path's from the
    plain backward twin) against jax.grad of JAX's same impl: x and every
    parameter, the shared key's gradient summed over the heads."""
    jcfg, jp, cfg, p = mla
    x, pos = _x(2, 32, 6)
    w = np.random.default_rng(7).standard_normal((2, 32, 64)).astype(
        np.float32)

    def jloss(v, x_):
        out = jattn.mla_forward(v, jcfg, x_, jnp.asarray(pos), jnp.int32(0),
                                impl)
        return jnp.sum(out * w)

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = dict(p.named_parameters())
    for t in leaves.values():
        t.requires_grad_(True)
    tx = _t(x).requires_grad_(True)
    out = attn.mla_forward(p, cfg, tx, _t(pos), 0, impl)
    grads = torch.autograd.grad((out * _t(w)).sum(), [tx, *leaves.values()])
    for t in leaves.values():
        t.requires_grad_(False)
    want = dict(jg, x=jgx)
    for name, g in zip(["x", *leaves], grads):
        wv = np.asarray(want[name])
        np.testing.assert_allclose(g.numpy(), wv, rtol=1e-5,
                                   atol=1e-7 + 1e-6 * np.abs(wv).max(),
                                   err_msg=name)


@pytest.mark.parametrize("S,W", [(12, 16), (45, 16), (32, 16)])
def test_mla_prefill_cache_matches_jax(mla, S, W):
    """Only c_kv, k_rope and pos: S < W padded with pos −1; S ≥ W the last
    W rolled by S % W (45 % 16 = 13, 32 % 16 = 0)."""
    jcfg, jp, cfg, p = mla
    x, pos = _x(2, S, 8)
    want = jattn.mla_prefill_cache(jp, jcfg, jnp.asarray(x),
                                   jnp.asarray(pos), W)
    got = attn.mla_prefill_cache(p, cfg, _t(x), _t(pos), W)
    assert set(got) == {"c_kv", "k_rope", "pos"} == set(want)
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    for key in ("c_kv", "k_rope"):
        assert tuple(got[key].shape) == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("window,W", [(0, 40), (8, 16)])
def test_mla_decode_matches_jax(mla, window, W):
    """Two absorbed-form decode steps onto a full cache or a ring (S = 20
    wraps a ring of 16): each output within 1e-5 of JAX's, the port's cache
    written in place and equal to the one JAX returns."""
    jcfg, jp, cfg, p = mla
    x, pos = _x(2, 20, 9)
    jc = jattn.mla_prefill_cache(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                 W)
    pc = attn.mla_prefill_cache(p, cfg, _t(x), _t(pos), W)
    rng = np.random.default_rng(10)
    for st in (20, 21):
        xd = rng.standard_normal((2, 1, 64)).astype(np.float32)
        dpos = np.full((2,), st, np.int32)
        want, jc = jattn.mla_decode(jp, jcfg, jnp.asarray(xd),
                                    jnp.asarray(dpos), jnp.int32(window), jc,
                                    jnp.int32(st))
        buffers = {k: v.data_ptr() for k, v in pc.items()}
        got, pc2 = attn.mla_decode(p, cfg, _t(xd), _t(dpos), window, pc, st)
        assert pc2 is pc and {k: v.data_ptr()
                              for k, v in pc.items()} == buffers
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(pc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        for key in ("c_kv", "k_rope"):
            np.testing.assert_allclose(pc[key].numpy(), np.asarray(jc[key]),
                                       rtol=1e-6, atol=1e-6, err_msg=key)


def test_mla_prefill_is_forward_and_cache(mla):
    """``mla_prefill`` gives ``mla_forward``'s output and
    ``mla_prefill_cache``'s cache exactly, from one projection."""
    _, _, cfg, p = mla
    x, pos = _x(2, 32, 11)
    out, cache = attn.mla_prefill(p, cfg, _t(x), _t(pos), 0,
                                  "blocked_causal", 40)
    assert torch.equal(out, attn.mla_forward(p, cfg, _t(x), _t(pos), 0,
                                             "blocked_causal"))
    want = attn.mla_prefill_cache(p, cfg, _t(x), _t(pos), 40)
    assert cache.keys() == want.keys()
    for key in want:
        assert torch.equal(cache[key], want[key]), key


@pytest.mark.parametrize("window,cap", [(0, None), (20, 50.0)])
def test_plain_attention_at_d192_matches_jax(window, cap):
    """The port's kernel-path attention (its plain twin on the CPU) at
    head_dim 192 with v padded from 128, n_kv = n_heads and the scale
    192^-0.5, against JAX's ``_attend`` (``blocked_causal``, chunks of
    32): the output (its padded columns exactly 0) and the gradients of q,
    k and v."""
    rng = np.random.default_rng(12 + window)
    B, S, H = 1, 64, 3
    q, k = (rng.standard_normal((B, S, H, 192)).astype(np.float32)
            for _ in range(2))
    v = np.zeros((B, S, H, 192), np.float32)
    v[..., :128] = rng.standard_normal((B, S, H, 128))
    do = rng.standard_normal((B, S, H, 192)).astype(np.float32)
    scale = 192 ** -0.5
    jcfg = jattn.AttnConfig(d_model=64, n_heads=H, n_kv=H, head_dim=192,
                            softcap=cap, attn_chunk_q=32, attn_chunk_k=32)
    pos = jnp.arange(S, dtype=jnp.int32)
    out, vjp = jax.vjp(lambda a, b, c: jattn._attend(
        a, b, c, pos, pos, jnp.int32(window), jcfg, "blocked_causal",
        scale=scale), *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    cfg = attn.AttnConfig(**dataclasses.asdict(jcfg))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    tpos = torch.arange(S)
    got = attn._attend(tq, tk, tv, tpos, tpos, window, cfg,
                       "blocked_causal", scale=scale)
    assert not got[..., 128:].any()
    grads = torch.autograd.grad(got, (tq, tk, tv), _t(do))
    for name, g, w in zip(("out", "dq", "dk", "dv"), (got.detach(), *grads),
                          (out, *want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(w).max()),
                                   err_msg=name)


# ------------------------------------------------------------- the model

def test_registry_resolves_and_published_widths():
    """get_arch resolves deepseek-v3-671b; its configurations are the
    reference's; the card's two cuts keep every width and hold 15.11 B
    (serving) and 5.82 B (training) parameters."""
    mod = get_arch("deepseek-v3-671b")
    assert mod is deepseek_v3_671b and mod.FAMILY == "lm"
    assert mod.SKIP_SHAPES == jds.SKIP_SHAPES
    for name in ("config", "smoke_config"):
        got, want = getattr(mod, name)(), getattr(jds, name)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    full = mod.config()
    for name, n_layers, experts, mtp, billions in (
            ("serve_card_config", 4, 256, 0, 15.111),
            ("train_card_config", 2, 32, 1, 5.821)):
        cut = getattr(mod, name)()
        assert (cut.n_layers, cut.moe.n_experts, cut.mtp_depth) == (
            n_layers, experts, mtp)
        assert dataclasses.replace(
            cut, n_layers=full.n_layers, mtp_depth=full.mtp_depth,
            first_dense_layers=full.first_dense_layers,
            moe=full.moe) == full
        model = tf.init(cut, torch.Generator(), device="meta")
        n = sum(p.numel() for p in model.parameters())
        assert abs(n / 1e9 - billions) < 1e-3, (name, n)


def test_init_draws_the_reference_scales(deepseek):
    """tf.init of an MLA + MTP model: the reference's tree, names and
    dtypes (norms f32 zeros), w_uq at 1/√q_lora, wo at 1/√H, mtp.proj at
    1/√(2·d_model)."""
    _, _, cfg, ref = deepseek
    model = tf.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    mine, theirs = dict(model.named_parameters()), dict(
        ref.named_parameters())
    assert mine.keys() == theirs.keys()
    for name, t in theirs.items():
        assert mine[name].shape == t.shape and mine[name].dtype == t.dtype
        if name.endswith("norm"):
            assert not mine[name].any() and t.dtype == torch.float32
    a = model.layers[0].attn
    m = cfg.mla
    for w, fan in ((a.w_uq, m.q_lora_rank), (a.wo, cfg.n_heads),
                   (a.w_dkv, cfg.d_model), (model.mtp.proj, 2 * cfg.d_model)):
        assert abs(float(w.std()) * fan ** 0.5 - 1.0) < 0.1, w.shape
    assert isinstance(model.mtp.layer.ffn.shared, torch.nn.Module)


def test_prefill_and_decode_match_jax(deepseek):
    """prefill's last logits and every MLA cache (c_kv, k_rope, pos), then
    3 greedy decode steps (absorbed form), within 1e-4; the caches within
    1e-5 of their largest |value| (c_kv is normed to an rms of 1; its
    largest reaches about 4, where f32 rounds at 5e-7 and the residual
    stream's rounding through the layers before moves it by 1.1e-5)."""
    jcfg, values, cfg, model = deepseek
    toks, _ = _tokens(cfg, 2, 32)
    jl, jc = jtf.prefill(values, jcfg, jnp.asarray(toks), max_seq=40)
    pl, pc = tf.prefill(model, cfg, _t(toks), 40)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    runs = tf.caches_by_run(cfg, pc)
    assert len(runs) == len(jc)
    for a, b in zip(jc, runs):
        assert set(b) == {"c_kv", "k_rope", "pos"}
        np.testing.assert_array_equal(b["pos"].numpy(), np.asarray(a["pos"]))
        for key in ("c_kv", "k_rope"):
            w = np.asarray(a[key])
            np.testing.assert_allclose(b[key].numpy(), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())
    nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    for st in range(32, 35):
        pos = np.full((2,), st, np.int32)
        jl, jc = jtf.decode_step(values, jcfg, jnp.asarray(nxt),
                                 jnp.asarray(pos), jc, jnp.int32(st))
        pl, pc = tf.decode_step(model, cfg, _t(nxt), _t(pos), pc, st)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)


def test_backbone_matches_jax(deepseek):
    """The final hidden states (before final_norm) and the aux summed over
    the MoE layers, S = 48 (an MoE chunk with padded rows)."""
    jcfg, values, cfg, model = deepseek
    toks, _ = _tokens(cfg, 2, 48)
    jx, jaux = jtf.backbone(values, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        x, aux = tf.backbone(model, cfg, _t(toks))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jx)).max())
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_decode_matches_full_forward(deepseek):
    """A decode step after the prefill (absorbed form over the latent
    cache) equals the backbone over the prompt extended by the greedy
    token (direct form), within 1e-4."""
    _, _, cfg, model = deepseek
    toks = _t(_tokens(cfg, 2, 24)[0])
    with torch.no_grad():
        logits_pf, caches = tf.prefill(model, cfg, toks, 32)
        nxt = logits_pf[:, -1].argmax(-1).to(torch.int32)
        logits_d, _ = tf.decode_step(model, cfg, nxt,
                                     torch.full((2,), 24, dtype=torch.int32),
                                     caches, 24)
        x, aux = tf.backbone(model, cfg, torch.cat([toks, nxt[:, None]], 1))
        full = tf.logits_from_hidden(model, cfg, x)[:, -1]
    assert aux > 0.0
    np.testing.assert_allclose(logits_d.numpy(), full.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_loss_and_grads_match_jax(deepseek):
    """loss_fn at S = 48: loss, lm_loss, mtp_loss and aux_loss (the
    backbone's, as the reference reports it; the total weights the MTP
    layer's aux too) within rtol 1e-5, and every gradient leaf, the mtp
    leaves included, within rtol 1e-5, atol 1e-7 + 3e-5 of the leaf's
    largest (the MoE models' bar)."""
    jcfg, values, cfg, _ = deepseek
    toks, labels = _tokens(cfg, 2, 48)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, jnp.asarray(toks),
                              jnp.asarray(labels)), has_aux=True))(values)
    model = convert.lm_from_numpy(jax.tree_util.tree_map(np.asarray, values),
                                  cfg, device="cpu")
    params = tf.param_tree(model)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    loss, metrics, grads = train_loop.value_and_grad(
        lambda p, b: tf.loss_fn(p, cfg, *b), params, (_t(toks), _t(labels)))
    assert set(metrics) == set(jm) == {"lm_loss", "aux_loss", "mtp_loss",
                                       "loss"}
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for key in jm:
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    want = dict(tree.flatten(convert._lm_layer_tree(
        jax.tree_util.tree_map(np.asarray, jg), cfg)))
    got = dict(tree.flatten(grads))
    assert got.keys() == want.keys()
    assert {"mtp/proj", "mtp/layer/attn/w_uk", "mtp/layer/ffn/router",
            "layers/0/attn/kv_norm"} <= set(got)
    for name, g in got.items():
        w = np.asarray(want[name], dtype=np.float32)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-7 + 3e-5 * np.abs(w).max(),
                                   err_msg=name)


def test_train_steps_and_continuation_match_jax(deepseek):
    """Three TRAIN_CFG steps (bf16 moments) on the launcher's batches
    against the reference's jitted steps (loss, mtp_loss, aux_loss); then
    JAX's state after step 2, carried over by train_state_from_numpy (the
    MLA and mtp leaves and their moments bit for bit), one step on."""
    jcfg, values, cfg, _ = deepseek
    jstate = jloop.make_train_state(values, jlm_common.TRAIN_CFG)
    jstep = jax.jit(jloop.make_train_step(
        lambda p, b: jtf.loss_fn(p, jcfg, b["tokens"], b["labels"]),
        jlm_common.TRAIN_CFG))
    jstates, jmetrics = [], []
    for s in range(3):
        jstate, m = jstep(jstate, jtrain.synth_lm_batch(jcfg, 2, 32, s))
        jstates.append(jstate)
        jmetrics.append({k: float(v) for k, v in m.items()})
    model = convert.lm_from_numpy(jax.tree_util.tree_map(np.asarray, values),
                                  cfg, device="cpu")
    state = train_loop.make_train_state(tf.param_tree(model),
                                        lm_common.TRAIN_CFG)
    step = train_loop.make_train_step(
        lambda p, b: tf.loss_fn(p, cfg, b["tokens"], b["labels"]),
        lm_common.TRAIN_CFG)
    for s in range(3):
        state, m = step(state, train_launch.synth_lm_batch(cfg, 2, 32, s,
                                                           "cpu"))
        for key in ("loss", "mtp_loss", "aux_loss"):
            np.testing.assert_allclose(float(m[key]), jmetrics[s][key],
                                       rtol=1e-4, err_msg=key)
    cont = convert.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstates[1]), cfg, device="cpu")
    leaf = cont["opt"]["v"]["mtp"]["layer"]["attn"]["w_uq"]
    want = np.asarray(jstates[1]["opt"]["v"]["mtp"]["layer"]["attn"]["w_uq"])
    assert leaf.dtype == torch.bfloat16
    assert np.array_equal(leaf.view(torch.int16).numpy(),
                          want.view(np.int16))
    cont, m = step(cont, train_launch.synth_lm_batch(cfg, 2, 32, 2, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), jmetrics[2]["loss"],
                               rtol=1e-5)
    want = dict(tree.flatten(convert._lm_layer_tree(
        jax.tree_util.tree_map(np.asarray, jstates[2]["params"]), cfg)))
    for name, g in tree.flatten(cont["params"]):
        np.testing.assert_allclose(g.detach().numpy(), want[name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("layout", [
    dict(n_layers=1, first_dense_layers=0),
    dict(n_layers=4, first_dense_layers=0, moe=None)])
def test_bf16_prefill_matches_jax(layout):
    """deepseek's smoke widths in bf16 (params and compute; the router and
    the norms stay f32), 8 prompts: every row's last logits within 0.05 ×
    their std of JAX's (measured 0.019-0.036) and the same greedy tokens.
    Two layouts: one MLA layer with the MoE (routed and shared experts),
    and four MLA layers with dense FFNs. Not the dense layer before the
    MoE one: a token whose K-th and (K+1)-th probabilities lie within
    bf16's rounding of each other (gaps of 3e-4 here) may take another
    expert in the two frameworks, which moves its whole row (measured:
    one row of 8 at 0.078 std, its greedy token changed), as for granite
    (``test_torch_moe.py``)."""
    jcfg, values, cfg, model = _models(param_dtype="bfloat16",
                                       compute_dtype="bfloat16", **layout)
    assert model.layers[0].attn.w_uq.dtype == torch.bfloat16
    assert model.layers[0].attn.q_norm.dtype == torch.float32
    toks, _ = _tokens(cfg, 8, 32)
    jl, _ = jtf.prefill(values, jcfg, jnp.asarray(toks), max_seq=40)
    pl, _ = tf.prefill(model, cfg, _t(toks), 40)
    want, got = np.asarray(jl).astype(np.float32), pl.float().numpy()
    assert np.abs(got - want).max() <= 0.05 * want.std()
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_lm_from_numpy_keys_and_bf16_bit_exact():
    """An MLA + MTP tree carries over bit for bit in bf16, parameters and
    train state; a GQA key in an MLA layer, an MLA layer missing a key, an
    MTP tree without mtp_depth and mtp_depth without an MTP tree raise."""
    jcfg = dataclasses.replace(jds.smoke_config(), param_dtype="bfloat16")
    cfg = dataclasses.replace(deepseek_v3_671b.smoke_config(),
                              param_dtype="bfloat16")
    npv = jax.tree_util.tree_map(np.asarray,
                                 jtf.init(jax.random.PRNGKey(1), jcfg)[0])
    model = convert.lm_from_numpy(npv, cfg, device="cpu")

    def same(t, a):
        return np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))

    assert same(model.layers[2].attn.w_uk, npv["stack_1"]["attn"]["w_uk"][1])
    assert same(model.mtp.proj, npv["mtp"]["proj"])
    assert same(model.mtp.layer.ffn.shared.w_in,
                npv["mtp"]["layer"]["ffn"]["shared"]["w_in"])
    assert np.array_equal(model.mtp.layer.attn.kv_norm.numpy(),
                          npv["mtp"]["layer"]["attn"]["kv_norm"])
    params = tf.param_tree(model)
    assert set(params["layers"][0]["attn"]) == set(attn.MLA.NAMES)
    assert set(params["mtp"]) == {"proj", "layer"}
    jstate = jloop.make_train_state(jtf.init(jax.random.PRNGKey(1), jcfg)[0],
                                    jlm_common.TRAIN_CFG)
    jstate = jax.tree_util.tree_map(np.asarray, jstate)
    state = convert.train_state_from_numpy(jstate, cfg, device="cpu")
    assert same(state["params"]["mtp"]["layer"]["attn"]["wo"],
                jstate["params"]["mtp"]["layer"]["attn"]["wo"])
    assert state["opt"]["m"]["mtp"]["proj"].dtype == torch.bfloat16

    st = dict(npv["stack_0"])
    st["attn"] = dict(st["attn"], wq=st["attn"]["w_uq"])
    with pytest.raises(ValueError, match="keys"):
        convert.lm_from_numpy(dict(npv, stack_0=st), cfg, device="cpu")
    st["attn"] = {k: v for k, v in npv["stack_0"]["attn"].items()
                  if k != "kv_norm"}
    with pytest.raises(ValueError, match="keys"):
        convert.lm_from_numpy(dict(npv, stack_0=st), cfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.lm_from_numpy(npv, dataclasses.replace(cfg, mtp_depth=0),
                              device="cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.lm_from_numpy({k: v for k, v in npv.items() if k != "mtp"},
                              cfg, device="cpu")
    with pytest.raises(ValueError, match="mtp"):
        tf.loss_fn(tf.init(dataclasses.replace(cfg, mtp_depth=0),
                           torch.Generator(), device="cpu"), cfg,
                   torch.zeros((1, 8), dtype=torch.int32),
                   torch.zeros((1, 8), dtype=torch.int32))


def test_kernel_takes_d192():
    """head_dim 192 is a kernel build: the wrapper's checks take MLA's
    (B, H, S, 192) with n_kv = n_heads, and ``BWD_COLUMNS`` splits the
    dK/dV pass at whole 64-column chunks."""
    q = torch.zeros((1, 4, 8, 192), dtype=torch.bfloat16)
    assert fa.check_args(q, q, q) == (1, 4, 4, 8, 8, 192)
    assert fa.BWD_COLUMNS[192] == ((0, 128), (128, 64))
