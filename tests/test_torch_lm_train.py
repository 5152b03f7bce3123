"""LM training in the port (gemma2-2b, starcoder2-3b) against the JAX
package, on the CPU: the attention backward, the LM loss and its
gradients, remat, AdamW steps, the launcher and the example.

Parameters come from the JAX package's ``transformer.init`` and cross over
through ``convert``; inputs are seeded numpy. Tolerances:

* the plain attention backward (``ref.flash_attention_bwd``) against
  ``jax.vjp`` of the reference's ``_flash``: rtol 1e-5, atol 1e-6 + 1e-5
  of the leaf's largest sum of |terms| (computed in float64). Logits up to
  ±50 carry f32 rounding of about 3e-6 into each p = exp(x − lse), which
  the reference forms as exp(x − m) / den; where a window of 1 makes the
  exact gradient 0 the leaf is cancellation noise, so the terms, not the
  leaf, set the scale. The lse twin within rtol 1e-6 of the reference's
  mx + log(den);
* the CPU autograd Function against the plain backward: exactly; against
  autograd of the ``einsum`` attention: rtol 1e-3, atol 1e-4
  (``tests/test_models_lm.py``'s bar);
* ``blocked_causal_ad`` / ``blocked_ad`` outputs and gradients: rtol
  1e-5, atol 1e-7 + 1e-6 of the leaf's largest (1e-5 with logits at the
  softcap, as above); ``cross_entropy`` and ``chunked_cross_entropy``
  values and gradients: rtol 1e-5 (atol 1e-7 for elements near 0);
* ``loss_fn`` on both smoke configs: the loss rtol 1e-5, each gradient
  leaf rtol 1e-5, atol 1e-7 + 1e-6 of the leaf's largest (the sums run in
  another order);
* ``remat="full"`` and ``"dots"`` against ``"none"``: bit-equal;
* three ``TRAIN_CFG`` steps held by their losses (rtol 1e-4; after step 1
  AdamW moves each element by about ±lr whatever its gradient's size, so
  an element whose gradient is rounding noise may move either way); one
  step from JAX's state after step 2: the loss rtol 1e-5, parameters
  within 1e-6 + rtol 1e-5 (bf16 moments: an f32 difference of 1e-7 may
  round a moment one bf16 ulp apart, moving its element by lr · 2⁻⁸);
* the launcher's batches and the example's resumed run: exact.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import gemma2_2b as jgemma, starcoder2_3b as jstar
from repro.configs import gemma3_27b as jgemma3
from repro.configs import lm_common as jlm_common
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import gemma2_2b, lm_common, starcoder2_3b
from repro_torch.configs import gemma3_27b
from repro_torch.examples import train_lm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as train_launch
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.train import loop as train_loop
from repro_torch.train import tree

# Small tensors: one intra-op thread per test worker keeps the workers of
# a parallel test run from spinning on each other's cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = {"gemma2-2b": (jgemma, gemma2_2b),
         "starcoder2-3b": (jstar, starcoder2_3b),
         "gemma3-27b": (jgemma3, gemma3_27b)}


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(arch, **overrides):
    jmod, pmod = ARCHS[arch]
    jcfg = dataclasses.replace(jmod.smoke_config(), **overrides)
    cfg = dataclasses.replace(pmod.smoke_config(), **overrides)
    values, _ = jtf.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, values, cfg


def _tokens(cfg, B, S, seed=7):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    return toks, np.roll(toks, -1, 1)


def _port_grads(values, cfg, toks, labels):
    model = convert.lm_from_numpy(_np(values), cfg, device="cpu")
    params = tf.param_tree(model)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    loss, metrics, grads = train_loop.value_and_grad(
        lambda p, b: tf.loss_fn(p, cfg, *b), params, (_t(toks), _t(labels)))
    return loss, metrics, grads


def _close_leaves(got, want_ref_tree, cfg, rtol, atol, atol_of_scale):
    """The port's per-layer tree against the reference's stacked one,
    leaf by leaf, within rtol and atol + atol_of_scale · max|leaf|."""
    want = dict(tree.flatten(convert._lm_layer_tree(_np(want_ref_tree),
                                                    cfg)))
    got = dict(tree.flatten(got))
    assert got.keys() == want.keys()
    for name, g in got.items():
        w = np.asarray(want[name], dtype=np.float32)
        np.testing.assert_allclose(
            g.detach().float().numpy(), w, rtol=rtol,
            atol=atol + atol_of_scale * np.abs(w).max(), err_msg=name)


# ------------------------------------------------ the attention backward

def _attn_case(rng, Sq, Sk, cap, B=2, Hq=4, Hkv=2, D=16):
    """q, k, v, do in the reference's (B, S, H, D); with a softcap q is
    scaled so that the logits (std about 40 · 4 · 0.25 = 40) reach it."""
    mul = 40.0 if cap else 1.0
    q = (rng.standard_normal((B, Sq, Hq, D)) * mul).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    return q, k, v, do


def _bhsd(a):
    return _t(a).transpose(1, 2)


def _term_scales(q, k, v, do, o, lse, window, cap, scale):
    """Each leaf's largest sum of |terms| in float64: Σ_k p(|dp| + |delta|)
    |k| scale for dq, its transpose against |q| scale for dk, Σ_q p |do|
    for dv."""
    q, k, v, do = (_bhsd(a).double() for a in (q, k, v, do))
    g = q.shape[1] // k.shape[1]
    kk, vv = (t.repeat_interleave(g, 1) for t in (k, v))
    s = (q * scale) @ kk.transpose(-1, -2)
    sc = cap * torch.tanh(s / cap) if cap else s
    vis = ref._visible(q.shape[2], k.shape[2], True, window, "cpu")
    p = torch.where(vis, torch.exp(sc - lse.double()[..., None]), 0.0)
    dp = do @ vv.transpose(-1, -2)
    delta = (do * o.double()).sum(-1)
    t = p * (dp.abs() + delta.abs()[..., None])
    B, Hkv, Sk, D = k.shape
    return [float(((t @ kk.abs()) * scale).max()),
            float((t.transpose(-1, -2) @ (q.abs() * scale)).view(
                B, Hkv, g, Sk, D).sum(2).max()),
            float((p.transpose(-1, -2) @ do.abs()).view(
                B, Hkv, g, Sk, D).sum(2).max())]


_JAX_FLASH = {}


def _jax_flash(Sq, Sk, cap):
    """jit of the reference's _flash forward, lse and vjp, the window a
    traced argument (one compile serves every window)."""
    if (Sq, Sk, cap) not in _JAX_FLASH:
        qpos = jnp.arange(Sk - Sq, Sk, dtype=jnp.int32)
        kpos = jnp.arange(Sk, dtype=jnp.int32)

        def run(q, k, v, do, window):
            args = (qpos, kpos, window, q.shape[-1] ** -0.5, cap, 16, 16,
                    True)
            out, vjp = jax.vjp(
                lambda q_, k_, v_: jattn._flash(q_, k_, v_, *args), q, k, v)
            _, mx, den = jattn._flash_fwd_impl(q, k, v, *args)
            return out, mx + jnp.log(den), vjp(do)

        _JAX_FLASH[Sq, Sk, cap] = jax.jit(run)
    return _JAX_FLASH[Sq, Sk, cap]


@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("window", [0, 1, 8, 16])
@pytest.mark.parametrize("Sq,Sk", [(32, 32), (32, 48), (48, 48)])
def test_plain_backward_matches_jax_vjp(Sq, Sk, window, cap):
    """ref.flash_attention_bwd (chunks of 16) from the reference's own out
    and lse against jax.vjp of _flash; Sq < Sk puts query i at key
    Sk − Sq + i; and the lse twin against mx + log(den)."""
    rng = np.random.default_rng(100 * Sq + 10 * window + Sk + bool(cap))
    q, k, v, do = _attn_case(rng, Sq, Sk, cap)
    scale = q.shape[-1] ** -0.5
    out, jlse, want = _jax_flash(Sq, Sk, cap)(
        *(jnp.asarray(a) for a in (q, k, v, do)), jnp.int32(window))
    jlse = _t(jlse).transpose(1, 2).contiguous()
    o = _bhsd(out)
    got = ref.flash_attention_bwd(
        _bhsd(q), _bhsd(k), _bhsd(v), o, jlse, _bhsd(do),
        window=window, softcap=cap, chunk_q=16, chunk_k=16)
    scales = _term_scales(q, k, v, do, o, jlse, window, cap, scale)
    for name, g, w, sc in zip(("dq", "dk", "dv"), got, want, scales):
        np.testing.assert_allclose(
            g.transpose(1, 2).numpy(), np.asarray(w), rtol=1e-5,
            atol=1e-6 + 1e-5 * sc, err_msg=name)
    o2, lse = ref.flash_attention_fwd_stats(
        _bhsd(q), _bhsd(k), _bhsd(v), window=window, softcap=cap)
    np.testing.assert_allclose(lse.numpy(), jlse.numpy(), rtol=1e-6)
    assert torch.equal(o2, ref.flash_attention(
        _bhsd(q), _bhsd(k), _bhsd(v), window=window, softcap=cap))


def test_lse_of_a_row_with_no_key_is_minus_inf():
    """Sq > Sk: the first rows see no key: lse −inf, o 0, gradients 0."""
    rng = np.random.default_rng(3)
    q, k, v, do = (_bhsd(a) for a in _attn_case(rng, 20, 12, None))
    o, lse = ref.flash_attention_fwd_stats(q, k, v)
    assert torch.isneginf(lse[:, :, :8]).all() and torch.isfinite(
        lse[:, :, 8:]).all()
    assert not o[:, :, :8].any()
    dq, dk, dv = ref.flash_attention_bwd(q, k, v, o, lse, do)
    assert not dq[:, :, :8].any()
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))


@pytest.mark.parametrize("window,cap,Hkv", [(0, None, 2), (8, 50.0, 2),
                                            (0, 50.0, 4), (5, None, 1)])
def test_cpu_function_equals_plain_backward(window, cap, Hkv):
    """ops.flash_attention on CPU tensors that need gradients runs
    Attention with the plain twins: its gradients are
    ref.flash_attention_bwd's from the forward's own o and lse, exactly;
    and within the einsum bar of autograd through the dense einsum."""
    rng = np.random.default_rng(11 + Hkv)
    q, k, v, do = (_bhsd(a) for a in _attn_case(rng, 40, 40, cap, Hkv=Hkv))
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    kw = dict(window=window, softcap=cap)
    out = ops.flash_attention(q, k, v, **kw)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), do)
    o, lse = ref.flash_attention_fwd_stats(q.detach(), k.detach(),
                                           v.detach(), **kw)
    assert torch.equal(out.detach(), o)
    want = ref.flash_attention_bwd(q.detach(), k.detach(), v.detach(), o,
                                   lse, do, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    cfg = attn.AttnConfig(d_model=64, n_heads=4, n_kv=Hkv, head_dim=16,
                          softcap=cap)
    pos = torch.arange(40)
    dense = attn._attend(*(t.transpose(1, 2) for t in (q, k, v)), pos, pos,
                         window, cfg, "einsum").transpose(1, 2)
    auto = torch.autograd.grad(dense, (q, k, v), do)
    for g, w in zip(got, auto):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3,
                                   atol=1e-4)


def test_kernel_impls_need_no_grad_path_unchanged():
    """Without gradients the CPU path is the plain forward, as before."""
    rng = np.random.default_rng(5)
    q, k, v, _ = (_bhsd(a) for a in _attn_case(rng, 24, 24, None))
    with torch.no_grad():
        out = ops.flash_attention(q.requires_grad_(), k, v, window=4)
    assert out.grad_fn is None
    assert torch.equal(out, ref.flash_attention(q.detach(), k, v, window=4))


@pytest.mark.parametrize("impl", ["blocked_causal_ad", "blocked_ad"])
@pytest.mark.parametrize("window,cap", [(0, None), (8, 50.0)])
def test_blocked_ad_matches_jax(impl, window, cap):
    """The autograd ablation (_attend_blocked) and its gradients against
    the reference's, chunks of 16 over S = 32, then a ragged S = 40 whose
    rows past the last whole chunk stay 0 in both. rtol 1e-5, atol 1e-7 +
    1e-6 of the leaf's largest, 1e-5 with logits at the softcap of 50
    (their f32 rounding moves each p by about 3e-6)."""
    for S in (32, 40):
        rng = np.random.default_rng(S + window)
        q, k, v, do = _attn_case(rng, S, S, cap)
        scale = 16 ** -0.5
        pos = jnp.arange(S, dtype=jnp.int32)
        def run(q_, k_, v_, do_):
            out, vjp = jax.vjp(
                lambda a, b, c: jattn._attend_blocked(
                    a, b, c, pos, pos, jnp.int32(window), scale, cap, 16, 16,
                    impl == "blocked_causal_ad"), q_, k_, v_)
            return out, vjp(do_)

        out, want = jax.jit(run)(*(jnp.asarray(a) for a in (q, k, v, do)))
        tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
        cfg = attn.AttnConfig(d_model=64, n_heads=4, n_kv=2, head_dim=16,
                              softcap=cap, attn_chunk_q=16, attn_chunk_k=16)
        tpos = torch.arange(S)
        got_out = attn._attend(tq, tk, tv, tpos, tpos, window, cfg, impl)
        got = torch.autograd.grad(got_out, (tq, tk, tv), _t(do))
        for name, g, w in zip(("out", "dq", "dk", "dv"),
                              (got_out.detach(), *got), (out, *want)):
            w = np.asarray(w)
            np.testing.assert_allclose(
                g.numpy(), w, rtol=1e-5,
                atol=1e-7 + (1e-5 if cap else 1e-6) * np.abs(w).max(),
                err_msg=f"S={S} {name}")
        if S == 40:
            assert not got_out[:, 32:].any()


# ---------------------------------------------------------------- the loss

@pytest.mark.parametrize("S", [32, 30])
def test_cross_entropy_matches_jax(S):
    """cross_entropy and chunked_cross_entropy (chunk 8; S = 30 falls back
    to one chunk), softcap 30, a fifth of the labels ignored: values and
    gradients against JAX's."""
    rng = np.random.default_rng(S)
    B, D, V = 2, 12, 40
    x = rng.standard_normal((B, S, D)).astype(np.float32) * 3
    head = rng.standard_normal((D, V)).astype(np.float32) * 3
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.2] = -1
    logits = x @ head

    jl, jg = jax.jit(jax.value_and_grad(lambda lg: jcm.cross_entropy(
        lg, jnp.asarray(labels), softcap_val=30.0)))(jnp.asarray(logits))
    tl = _t(logits).requires_grad_()
    pl = cm.cross_entropy(tl, _t(labels), softcap_val=30.0)
    (pg,) = torch.autograd.grad(pl, tl)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)

    jl, (jgx, jgh) = jax.jit(jax.value_and_grad(
        lambda a, b: jcm.chunked_cross_entropy(
            a, b, jnp.asarray(labels), softcap_val=30.0, chunk=8),
        argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(head))
    tx, th = _t(x).requires_grad_(), _t(head).requires_grad_()
    pl = cm.chunked_cross_entropy(tx, th, _t(labels), softcap_val=30.0,
                                  chunk=8)
    pgx, pgh = torch.autograd.grad(pl, (tx, th))
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    for g, w in ((pgx, jgx), (pgh, jgh)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_fn_and_grads_match_jax(arch):
    """tf.loss_fn on the smoke config at S = 32 (a multiple of the chunk
    of 16), through the kernel impl's CPU Function: the loss, the metrics
    and every gradient leaf against jax.value_and_grad of the
    reference's."""
    jcfg, values, cfg = _models(arch)
    toks, labels = _tokens(cfg, 2, 32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, jnp.asarray(toks),
                              jnp.asarray(labels)), has_aux=True))(values)
    loss, metrics, grads = _port_grads(values, cfg, toks, labels)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for key in ("lm_loss", "aux_loss", "loss"):
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]),
                                   rtol=1e-5)
    _close_leaves(grads, jg, cfg, rtol=1e-5, atol=1e-7, atol_of_scale=1e-6)


def test_loss_fn_ragged_length_matches_einsum():
    """At S = 20 the reference's blocked_causal drops the rows past its
    last whole chunk (ROADMAP.md Queue 3), so the port's kernel impl is
    held against its own einsum impl: loss rtol 1e-5, gradients rtol 1e-4
    atol 1e-6 of the leaf's largest."""
    _, values, cfg = _models("gemma2-2b")
    toks, labels = _tokens(cfg, 2, 20)
    loss, _, grads = _port_grads(values, cfg, toks, labels)
    ecfg = dataclasses.replace(cfg, attn_impl="einsum")
    eloss, _, egrads = _port_grads(values, ecfg, toks, labels)
    np.testing.assert_allclose(float(loss), float(eloss), rtol=1e-5)
    for (name, g), e in zip(tree.flatten(grads), tree.leaves(egrads)):
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(e.abs().max()),
                                   err_msg=name)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_bit_equal_to_none(remat):
    """Each layer under torch.utils.checkpoint (full) or the selective
    checkpoint that keeps the matmuls (dots) recomputes the same
    operations: loss and gradients bit-equal to remat="none"."""
    _, values, cfg = _models("starcoder2-3b")
    toks, labels = _tokens(cfg, 2, 32)
    runs = [_port_grads(values, dataclasses.replace(cfg, remat=r), toks,
                        labels) for r in ("none", remat)]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(tree.leaves(runs[0][2]), tree.leaves(runs[1][2])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="remat"):
        _port_grads(values, dataclasses.replace(cfg, remat="some"), toks,
                    labels)


def test_param_tree_and_mtp():
    """param_tree holds the model's own parameters; loss_fn reads the
    model or its tree alike; a config with MTP on a model without the
    mtp module raises."""
    _, values, cfg = _models("gemma2-2b")
    model = convert.lm_from_numpy(_np(values), cfg, device="cpu")
    params = tf.param_tree(model)
    assert params["layers"][2]["attn"]["wq"] is model.layers[2].attn.wq
    assert params["layers"][0]["ffn"]["w_gate"] is model.layers[0].ffn.w_gate
    assert "lm_head" not in params and "attn_post" in params["layers"][0]
    assert len(tree.leaves(params)) == len(list(model.parameters()))
    toks, labels = _tokens(cfg, 1, 16)
    with torch.no_grad():
        a, _ = tf.loss_fn(model, cfg, _t(toks), _t(labels))
        b, _ = tf.loss_fn(params, cfg, _t(toks), _t(labels))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="mtp"):
        tf.loss_fn(params, dataclasses.replace(cfg, mtp_depth=1), _t(toks),
                   _t(labels))


# ----------------------------------------------------------------- steps

def _jax_steps(jcfg, values, n, B=2, S=32):
    state = jloop.make_train_state(values, jlm_common.TRAIN_CFG)
    step = jax.jit(jloop.make_train_step(
        lambda p, b: jtf.loss_fn(p, jcfg, b["tokens"], b["labels"]),
        jlm_common.TRAIN_CFG))
    states, losses = [], []
    for s in range(n):
        state, m = step(state, jtrain.synth_lm_batch(jcfg, B, S, s))
        states.append(state)
        losses.append(float(m["loss"]))
    return states, losses


def test_train_cfg_steps_and_continuation_match_jax():
    """Three TRAIN_CFG steps (bf16 moments) on the launcher's batches
    against the reference's jitted steps; then JAX's state after step 2,
    carried over by convert.train_state_from_numpy, one step on."""
    jcfg, values, cfg = _models("gemma2-2b")
    assert lm_common.TRAIN_CFG.opt == dataclasses.replace(
        lm_common.TRAIN_CFG.opt, lr=3e-4, moment_dtype="bfloat16")
    states, jlosses = _jax_steps(jcfg, values, 3)
    model = convert.lm_from_numpy(_np(values), cfg, device="cpu")
    state = train_loop.make_train_state(tf.param_tree(model),
                                        lm_common.TRAIN_CFG)
    step = train_loop.make_train_step(
        lambda p, b: tf.loss_fn(p, cfg, b["tokens"], b["labels"]),
        lm_common.TRAIN_CFG)
    losses = []
    for s in range(3):
        state, m = step(state, train_launch.synth_lm_batch(cfg, 2, 32, s,
                                                           "cpu"))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert model.embed is state["params"]["embed"]
    assert state["opt"]["m"]["embed"].dtype == torch.bfloat16

    cont = convert.train_state_from_numpy(_np(states[1]), cfg, device="cpu")
    assert int(cont["opt"]["step"]) == 2
    m_leaf = cont["opt"]["v"]["layers"][3]["attn"]["wk"]
    want = np.asarray(states[1]["opt"]["v"]["stack_0"]["attn"]["wk"][3])
    assert np.array_equal(m_leaf.view(torch.int16).numpy(),
                          want.view(np.int16))
    cont, m = step(cont, train_launch.synth_lm_batch(cfg, 2, 32, 2, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), jlosses[2], rtol=1e-5)
    assert int(cont["opt"]["step"]) == 3
    _close_leaves(cont["params"], states[2]["params"], cfg, rtol=1e-5,
                  atol=1e-6, atol_of_scale=0.0)


def test_train_state_from_numpy_checks_the_lm_tree():
    jcfg, values, cfg = _models("starcoder2-3b")
    jstate = _np(jloop.make_train_state(values, jlm_common.TRAIN_CFG))
    bad = dict(jstate, opt=dict(jstate["opt"], m={"embed": 0}))
    with pytest.raises(ValueError):
        convert.train_state_from_numpy(bad, cfg, device="cpu")
    state = convert.train_state_from_numpy(jstate, cfg, device="cpu")
    assert len(state["params"]["layers"]) == cfg.n_layers
    assert all(p.requires_grad for p in tree.leaves(state["params"]))


def test_smoke_run_takes_a_step_then_serves():
    """lm_common.smoke_run: one finite train step, then prefill and a
    decode step of the updated model, as the reference's."""
    metrics, logits = lm_common.smoke_run(gemma2_2b.smoke_config(), seq=16,
                                          device="cpu")
    assert set(metrics) >= {"loss", "lm_loss", "aux_loss", "grad_norm",
                            "lr"}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert logits.shape == (2, 512) and torch.isfinite(logits).all()


# ------------------------------------------------- launcher and example

def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "_jax_train_lm", ROOT / "examples" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["starcoder2-3b", "granite-moe-3b-a800m",
                                  "deepseek-v3-671b"])
def test_launcher_batches_equal_reference_and_main_runs(tmp_path, capsys,
                                                        arch):
    cfg = gemma2_2b.smoke_config()
    for step in (0, 5):
        want = jtrain.synth_lm_batch(cfg, 3, 24, step)
        got = train_launch.synth_lm_batch(cfg, 3, 24, step, "cpu")
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
    out = train_launch.main(["--arch", arch, "--device", "cpu",
                             "--steps", "3", "--batch", "2", "--seq", "32",
                             "--ckpt-dir", str(tmp_path)])
    assert len(out["history"]) == 3 and out["failures"] == 0
    assert int(out["state"]["opt"]["step"]) == 3
    assert "trained 3 steps" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train_launch.main(["--arch", "gat-cora", "--device", "cpu"])


class _Batches(Exception):
    pass


def test_example_batches_and_resumed_run(tmp_path, capsys, monkeypatch):
    """The example's batches equal the reference example's own (its batch
    function caught where it hands it to run_resilient); 110 steps at
    batch 4, length 32 (the defaults take 150 x 8 x 64) with a failure
    before the checkpoint at step 100 and one after it end bit-equal to an
    unbroken run, and the loss falls."""
    jex = _jax_example()
    caught = {}

    def catch(step, state, batch, *a, **kw):
        caught["batch"] = batch
        raise _Batches

    monkeypatch.setattr(jex.ft, "run_resilient", catch)
    monkeypatch.setattr("sys.argv", ["train_lm.py", "--batch", "4", "--seq",
                                     "32"])
    with pytest.raises(_Batches):
        jex.main()
    cfg = gemma2_2b.smoke_config()
    for step in (0, 4, 77):
        want = caught["batch"](step)
        got = train_lm.make_batch(cfg, 4, 32, step, "cpu")
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))

    seen = set()

    def hook(s):
        if s in (50, 105) and s not in seen:
            seen.add(s)
            raise RuntimeError("simulated node failure")

    argv = ["--device", "cpu", "--steps", "110", "--batch", "4", "--seq",
            "32"]
    broken = train_lm.main(argv + ["--ckpt-dir", str(tmp_path / "a")],
                           fail_hook=hook)
    whole = train_lm.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert broken["failures"] == 2 and whole["failures"] == 0
    for a, b in zip(tree.leaves(broken["state"]),
                    tree.leaves(whole["state"])):
        assert torch.equal(a, b)
    assert broken["history"][-1] == whole["history"][-1]
    assert whole["history"][-1]["loss"] < whole["history"][0]["loss"]
    assert "(2 restarts)" in capsys.readouterr().out


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gemma2_2b.smoke_config()
    for call in (lambda: train_launch.main(["--arch", "gemma2-2b"]),
                 lambda: train_lm.main([]),
                 lambda: train_launch.synth_lm_batch(cfg, 1, 4, 0),
                 lambda: lm_common.smoke_run(cfg),
                 lambda: convert.train_state_from_numpy({}, cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (D, Hq, Hkv, S, window, softcap) of the card's backward tests.
CUDA_BWD_CASES = [
    (256, 8, 4, 300, 0, 50.0), (256, 8, 4, 300, 81, None),
    (128, 24, 2, 257, 0, None), (128, 4, 4, 200, 1, None),
    # The backward's tile edges at each head_dim: S and the window one
    # off its 64-row tile (and, at D = 128, its 128-key dK/dV block) and
    # one off the dQ pass's 128-row block.
    (256, 8, 4, 63, 0, 50.0), (256, 8, 4, 65, 0, 50.0),
    (256, 8, 4, 127, 0, None), (256, 8, 4, 129, 0, 50.0),
    (256, 8, 4, 300, 63, 50.0), (256, 8, 4, 300, 65, None),
    (128, 24, 2, 63, 0, None), (128, 24, 2, 65, 0, None),
    (128, 24, 2, 127, 0, None), (128, 4, 2, 129, 0, 50.0),
    (128, 4, 2, 300, 127, None), (128, 4, 2, 300, 129, 50.0)]
# head_dim 64 (granite-moe-3b-a800m's layer: 24 / 8 heads) and its edges:
# S and the window one off the 64-row tile, the 128-key dK/dV block and
# the dQ pass's 128-row block, with and without softcap.
CUDA_BWD_CASES_64 = [
    (64, 24, 8, 300, 0, None), (64, 24, 8, 257, 0, 50.0),
    (64, 3, 1, 63, 0, None), (64, 3, 1, 65, 0, 50.0),
    (64, 3, 1, 127, 0, None), (64, 3, 1, 129, 0, None),
    (64, 4, 2, 300, 1, None), (64, 4, 2, 300, 127, None),
    (64, 4, 2, 300, 129, 50.0), (64, 4, 4, 200, 65, None)]
# head_dim 192 (MLA: q.k 128 + 64, n_kv = n_heads, the consumers' 128 / 64
# column split of the dK/dV pass) and its edges: S and the window one off
# the 64-row tile and the dQ pass's 128-row block, with and without
# softcap.
CUDA_BWD_CASES_192 = [
    (192, 16, 16, 300, 0, None), (192, 4, 4, 257, 0, 50.0),
    (192, 3, 3, 63, 0, None), (192, 3, 3, 65, 0, 50.0),
    (192, 3, 3, 127, 0, None), (192, 3, 3, 129, 0, None),
    (192, 4, 4, 300, 1, None), (192, 4, 4, 300, 63, 50.0),
    (192, 4, 4, 300, 129, None)]


def _cuda_backward(cuda, D, Hq, Hkv, S, window, cap):
    """The forward's o bit-equal with lse asked for or not, lse within 1e-3
    of the plain twin's; → the backward kernel twice, the plain twin (f32
    math on the same bf16 inputs and the kernel's own o and lse), and the
    inputs."""
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rnd(h, mul=1.0):
        return (torch.randn((1, h, S, D), generator=gen, device=cuda)
                * mul).to(torch.bfloat16)

    q, k, v, do = rnd(Hq, 4.0), rnd(Hkv), rnd(Hkv), rnd(Hq)
    kw = dict(window=window, softcap=cap)
    o, lse = fa.flash_attention_fwd_stats(q, k, v, **kw)
    assert torch.equal(o, fa.flash_attention_fwd_stats(q, k, v, stats=False,
                                                       **kw)[0])
    _, want_lse = ref.flash_attention_fwd_stats(q.float(), k.float(),
                                                v.float(), **kw)
    torch.testing.assert_close(lse, want_lse, rtol=1e-3, atol=1e-3)
    got = ops.flash_attention_backward(q, k, v, o, lse, do, **kw)
    again = ops.flash_attention_backward(q, k, v, o, lse, do, **kw)
    want = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                   o.float(), lse, do.float(), **kw)
    return got, again, want, (q, k, v, do)


@pytest.mark.gpu
@pytest.mark.parametrize("D,Hq,Hkv,S,window,cap", CUDA_BWD_CASES)
def test_cuda_backward_matches_plain(cuda, D, Hq, Hkv, S, window, cap):
    """On the card: the forward's o bit-equal with lse asked for or not,
    lse within 1e-3 of the plain twin's, and the backward kernel within
    rtol / atol 2e-2 of the plain twin (f32 math on the same bf16 inputs
    and the kernel's own o and lse), twice bit-equal."""
    got, again, want, _ = _cuda_backward(cuda, D, Hq, Hkv, S, window, cap)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g.float(), w, rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("D,Hq,Hkv,S,window,cap",
                         CUDA_BWD_CASES + CUDA_BWD_CASES_64
                         + CUDA_BWD_CASES_192)
def test_cuda_backward_within_its_scale(cuda, D, Hq, Hkv, S, window, cap):
    """On the card, the bar chip_smoke.py holds the kernel to (FA_BWD_TOL):
    each gradient's largest error within 2e-2 of its scale
    (``ref.flash_attention_bwd_errors``); twice bit-equal."""
    got, again, want, (q, k, v, do) = _cuda_backward(cuda, D, Hq, Hkv, S,
                                                     window, cap)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    errs = ref.flash_attention_bwd_errors(got, want, q, k, v, do)
    assert max(errs) <= 2e-2, errs
