"""The port's train stack (``repro_torch.train``) on the CPU: the nine
tests of ``tests/test_train_infra.py`` ported, a restart before the first
checkpoint, and parity with the JAX package on the same trees.

Tolerances: ``quantize_int8``, ``opt.step``, checkpoints both ways and a
resumed run against an unbroken one are exact. ``apply_updates`` fed the
same gradients and state: parameters within rtol 1e-6; float32 moments
within rtol 1e-6, and where the clip scale 1/‖g‖ is active also within
1e-6 of the leaf's largest moment (the norm's sum order moves the scale
by up to ~1e-6, and where m·b1 and (1 − b1)·g cancel that is relative to
the terms, not to their difference); bfloat16 moments at most 1 bf16 ulp
apart. ``global_norm`` within rtol 1e-6 (each leaf's square sum adds in
another order).
"""
import gc
import os
import weakref

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.train import checkpoint as jckpt
from repro.train import compression as jcompression
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import tree

# Small tensors: one intra-op thread per test worker keeps the workers of
# a parallel test run from spinning on each other's cores.
torch.set_num_threads(1)


def _quadratic_loss(p, batch):
    loss = torch.sum((p["w"] - 3.0) ** 2) + torch.sum((p["b"] + 1.0) ** 2)
    return loss, {"loss": loss}


# ----------------------------------------- tests/test_train_infra.py, ported

def test_adamw_decreases_quadratic():
    params = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}
    tc = train_loop.TrainConfig(opt=opt_lib.AdamWConfig(lr=0.1,
                                                        warmup_steps=1))
    state = train_loop.make_train_state(params, tc)
    step = train_loop.make_train_step(_quadratic_loss, tc)
    losses = []
    for _ in range(60):
        state, m = step(state, None)
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.1 * losses[0]
    assert int(state["opt"]["step"]) == 60


def _lsq(p, b):
    loss = torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)
    return loss, {"loss": loss}


def test_grad_accumulation_matches_big_batch():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
    tc1 = train_loop.TrainConfig(opt=opt_lib.AdamWConfig(lr=1e-2))
    tc4 = train_loop.TrainConfig(opt=opt_lib.AdamWConfig(lr=1e-2),
                                 accum_steps=4)
    s1 = train_loop.make_train_state({"w": w.clone()}, tc1)
    s4 = train_loop.make_train_state({"w": w.clone()}, tc4)
    s1, _ = train_loop.make_train_step(_lsq, tc1)(s1, {"x": x, "y": y})
    mb = {"x": x.reshape(4, 4, 8), "y": y.reshape(4, 4, 4)}
    s4, m4 = train_loop.make_train_step(_lsq, tc4)(s4, mb)
    torch.testing.assert_close(s1["params"]["w"], s4["params"]["w"],
                               rtol=1e-5, atol=0)
    assert m4["loss"].shape == ()


def test_train_step_frees_its_gradients_at_once(monkeypatch):
    """No reference cycle holds a step's gradients: they are freed when
    the step returns, without the cyclic collector (on the card a table's
    gradient is 10 GB, and two steps' worth left for the collector ran
    the card out of memory)."""
    refs = []
    orig = train_loop.value_and_grad

    def recording(*a):
        out = orig(*a)
        refs.extend(weakref.ref(g) for g in tree.leaves(out[2]))
        return out

    monkeypatch.setattr(train_loop, "value_and_grad", recording)
    tc = train_loop.TrainConfig(opt=opt_lib.AdamWConfig(lr=0.1),
                                compress_grads=True)
    state = train_loop.make_train_state(
        {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}, tc)
    step = train_loop.make_train_step(_quadratic_loss, tc)
    gc.collect()
    gc.disable()
    try:
        for _ in range(2):
            state, _ = step(state, None)
            assert refs and all(r() is None for r in refs)
    finally:
        gc.enable()


def test_checkpoint_roundtrip(tmp_path):
    state = {"a": torch.arange(6.0).reshape(2, 3),
             "nested": {"b": torch.tensor(7, dtype=torch.int32)}}
    ckpt.save(str(tmp_path), 3, state)
    assert ckpt.latest_step(str(tmp_path)) == 3
    restored = ckpt.restore(str(tmp_path), 3, state)
    assert torch.equal(restored["a"], state["a"])
    assert int(restored["nested"]["b"]) == 7
    assert restored["nested"]["b"].dtype == torch.int32


def test_checkpoint_atomicity(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(4)})
    # a stale tmp dir from a "crashed" writer must be ignored
    os.makedirs(tmp_path / "step_2.tmp", exist_ok=True)
    assert ckpt.latest_step(str(tmp_path)) == 1


def _restart_run(tmp_path, fail_at, n_steps=12, ckpt_every=5):
    """The reference test's run: ‖w − 3‖² from ones, one failure at each
    step of ``fail_at`` (at most once each). Returns (final w, history,
    failures, checkpoint dir)."""
    params = {"w": torch.ones((4,))}
    tc = train_loop.TrainConfig(opt=opt_lib.AdamWConfig(lr=0.05,
                                                        warmup_steps=1))
    state = train_loop.make_train_state(params, tc)

    def loss(p, batch):
        l = torch.sum((p["w"] - 3.0) ** 2)
        return l, {"loss": l}

    crashed = set()

    def fail_hook(s):
        if s in fail_at and s not in crashed:
            crashed.add(s)
            raise RuntimeError("simulated node failure")

    cfg = ft.ResilienceConfig(ckpt_dir=str(tmp_path), ckpt_every=ckpt_every,
                              max_failures=2)
    final, history, fails = ft.run_resilient(
        train_loop.make_train_step(loss, tc), state, lambda s: None,
        n_steps, cfg, fail_hook=fail_hook)
    return final["params"]["w"].detach().clone(), history, fails


def test_fault_tolerant_restart(tmp_path):
    w, history, fails = _restart_run(tmp_path / "a", {7})
    assert fails == 1
    assert len(history) >= 12
    assert ckpt.latest_step(str(tmp_path / "a")) == 12
    want, _, _ = _restart_run(tmp_path / "b", set())
    assert torch.equal(w, want)


def test_restart_before_first_checkpoint_equals_failure_free_run(tmp_path):
    """The steps update the state in place, so a failure before any
    checkpoint must restart from the true initial state, not from the
    half-trained tensors: the run must equal one without failures, bit for
    bit, its history's tail too."""
    w, history, fails = _restart_run(tmp_path / "a", {3, 9},
                                     ckpt_every=8)
    want, want_hist, _ = _restart_run(tmp_path / "b", set(), ckpt_every=8)
    assert fails == 2
    assert torch.equal(w, want)
    # Steps 0-2, the failure at 3; steps 0-8 from the initial state (the
    # checkpoint at 8), the failure at 9; steps 8-11 from the checkpoint.
    assert len(history) == 3 + 9 + 4
    assert history[:3] == want_hist[:3]
    assert history[3:12] == want_hist[:9]
    assert history[12:] == want_hist[8:]


def test_elastic_restore_changes_placement(tmp_path):
    """Restore works whatever wrote it and onto another dtype template."""
    state = {"w": torch.ones((8, 4), dtype=torch.bfloat16)}
    axes = {"w": ("mlp", None)}
    ckpt.save(str(tmp_path), 1, state, axes)
    restored = ckpt.restore(str(tmp_path), 1, state)
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"], state["w"])
    as_f32 = ckpt.restore(str(tmp_path), 1, {"w": torch.zeros((8, 4))})
    assert as_f32["w"].dtype == torch.float32
    assert torch.equal(as_f32["w"], torch.ones((8, 4)))
    with open(tmp_path / "step_1" / "manifest.json") as f:
        assert '"axes": {"w": ["mlp", null]}' in f.read()


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=15, deadline=None)
def test_int8_compression_error_bounded(seed):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy((rng.standard_normal((64,))
                          * rng.uniform(0.1, 10)).astype(np.float32))
    q, s = compression.quantize_int8(g)
    deq = compression.dequantize_int8(q, s)
    max_err = float(torch.max(torch.abs(deq - g)))
    assert max_err <= float(s) * 0.5 + 1e-6


def test_error_feedback_preserves_signal():
    """Repeated compression of a CONSTANT gradient with error feedback must
    converge so the time-averaged applied gradient equals the true one."""
    g = {"w": torch.tensor([0.3, -1.7, 0.001, 5.0])}
    err = {"w": torch.zeros(4)}
    applied = torch.zeros(4)
    n = 50
    for _ in range(n):
        deq, err = compression.compress_decompress(g, err)
        applied = applied + deq["w"]
    np.testing.assert_allclose((applied / n).numpy(), g["w"].numpy(),
                               rtol=1e-2, atol=1e-3)


def test_async_checkpointer(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    x = torch.zeros(3)
    for s in (1, 2):
        x.fill_(float(s))
        saver.save(s, {"x": x})      # the copy is taken before save returns
    x.fill_(-1.0)
    saver.close()
    assert ckpt.latest_step(str(tmp_path)) == 2
    for s in (1, 2):
        r = ckpt.restore(str(tmp_path), s, {"x": torch.zeros(3)})
        assert torch.equal(r["x"], torch.full((3,), float(s)))


# --------------------------------------------------- parity with JAX's trees

def test_tree_order_is_jax_order():
    t = {"user": {"w0": 1, "table": 2}, "item": {"w1": 3, "table": 4},
         "opt": [5, {"b": 6, "a": 7}], "none": None}
    names = [n for n, _ in tree.flatten(t)]
    jax_names = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(t)[0]]
    assert names == jax_names
    assert tree.leaves(t) == jax.tree_util.tree_leaves(t)
    assert tree.unflatten(t, tree.leaves(t)) == t


def _trees(rng, moment_dtype):
    """Params, grads and a mid-run optimizer state as numpy, in JAX's tree
    layout (two towers' worth of leaves, step 3)."""
    shapes = {"item": {"table": (50, 8), "w0": (8, 4)},
              "user": {"table": (40, 8), "w0": (8, 4)}}

    def draw(scale=1.0):
        return {s: {n: (rng.standard_normal(sh) * scale).astype(np.float32)
                    for n, sh in v.items()} for s, v in shapes.items()}

    params, grads = draw(0.1), draw(2.0)
    m = draw(0.01)
    v = {s: {n: np.abs(a) for n, a in t.items()} for s, t in
         draw(0.01).items()}
    if moment_dtype == "bfloat16":
        m, v = (jax.tree_util.tree_map(
            lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), t)
            for t in (m, v))
    return params, grads, {"m": m, "v": v, "step": np.int32(3)}


def _to_torch(t):
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree_util.tree_map(one, t)


def _bf16_ulps(got: torch.Tensor, want) -> np.ndarray:
    a = got.view(torch.int16).numpy().astype(np.int32)
    b = np.asarray(want).view(np.int16).astype(np.int32)
    return np.abs(a - b).ravel()


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip,wd", [(1.0, 0.0), (0.0, 0.1), (100.0, 0.01)])
def test_apply_updates_matches_jax(moment_dtype, clip, wd, capsys):
    cfg_kw = dict(lr=3e-3, warmup_steps=5, grad_clip=clip, weight_decay=wd,
                  moment_dtype=moment_dtype)
    params, grads, opt = _trees(np.random.default_rng(1), moment_dtype)
    jp, jo, jm = jopt.apply_updates(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, grads),
        jax.tree_util.tree_map(jnp.asarray, opt), jopt.AdamWConfig(**cfg_kw))
    tp, tg, to = _to_torch(params), _to_torch(grads), _to_torch(opt)
    tp2, to2, tm = opt_lib.apply_updates(tp, tg, to,
                                         opt_lib.AdamWConfig(**cfg_kw))
    assert tp2 is tp and to2 is to          # in place
    assert int(to["step"]) == int(jo["step"]) == 4
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    assert float(tm["lr"]) == float(jm["lr"])
    clipped = 0 < clip < float(jm["grad_norm"])
    for (name, got), want in zip(tree.flatten(tp),
                                 jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0, err_msg=name)
    ulps = []
    for key in ("m", "v"):
        for (name, got), want in zip(tree.flatten(to[key]),
                                     jax.tree_util.tree_leaves(jo[key])):
            if moment_dtype == "float32":
                want = np.asarray(want)
                atol = 1e-6 * np.abs(want).max() if clipped else 0.0
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           atol=atol, err_msg=f"{key}/{name}")
            else:
                ulps.append(_bf16_ulps(got, want))
    if ulps:
        ulps = np.concatenate(ulps)
        with capsys.disabled():
            print(f"\nbf16 moments: {int((ulps > 0).sum())} of {ulps.size} "
                  f"apart from JAX's, by at most {int(ulps.max())} ulp")
        assert ulps.max() <= 1


def test_chunked_update_equals_one_chunk(monkeypatch):
    """The row chunks change nothing: the same ops in the same order for
    each element (bit-equal); the norm within rtol 1e-6."""
    params, grads, opt = _trees(np.random.default_rng(2), "bfloat16")
    cfg = opt_lib.AdamWConfig(lr=1e-2, warmup_steps=2)
    whole = opt_lib.apply_updates(_to_torch(params), _to_torch(grads),
                                  _to_torch(opt), cfg)
    monkeypatch.setattr(opt_lib, "CHUNK", 7)
    parts = opt_lib.apply_updates(_to_torch(params), _to_torch(grads),
                                  _to_torch(opt), cfg)
    for a, b in zip(tree.leaves(whole[:2]), tree.leaves(parts[:2])):
        assert torch.equal(a, b)
    torch.testing.assert_close(parts[2]["grad_norm"],
                               whole[2]["grad_norm"], rtol=1e-6, atol=0)


def test_global_norm_and_schedule_match_jax():
    params, grads, _ = _trees(np.random.default_rng(3), "float32")
    np.testing.assert_allclose(
        float(opt_lib.global_norm(_to_torch(grads))),
        float(jopt.global_norm(jax.tree_util.tree_map(jnp.asarray, grads))),
        rtol=1e-6)
    cfg = opt_lib.AdamWConfig(lr=3e-4, warmup_steps=7)
    jcfg = jopt.AdamWConfig(lr=3e-4, warmup_steps=7)
    for s in (0, 1, 3, 7, 8, 100):
        assert float(opt_lib.schedule(cfg, torch.tensor(s, dtype=torch.int32))) \
            == float(jopt.schedule(jcfg, jnp.int32(s)))


def test_compress_decompress_matches_jax():
    """int8 codes bit-equal (round half to even in both); the dequantized
    gradient and the residual bit-equal too."""
    rng = np.random.default_rng(4)
    g = {"a": (rng.standard_normal((33, 5)) * 3).astype(np.float32),
         "b": rng.standard_normal(7).astype(np.float32)}
    e = {"a": (rng.standard_normal((33, 5)) * 0.01).astype(np.float32),
         "b": np.zeros(7, np.float32)}
    # Half-way codes: x / scale = k + 0.5 exactly.
    g["b"][:4] = np.array([127.0, 0.5, 1.5, -2.5], np.float32)
    q, s = compression.quantize_int8(torch.from_numpy(g["b"]))
    jq, js = jcompression.quantize_int8(jnp.asarray(g["b"]))
    assert float(s) == float(js) == 1.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8
    deq, err = compression.compress_decompress(_to_torch(g), _to_torch(e))
    jdeq, jerr = jcompression.compress_decompress(
        jax.tree_util.tree_map(jnp.asarray, g),
        jax.tree_util.tree_map(jnp.asarray, e))
    for got, want in zip(tree.leaves(deq) + tree.leaves(err),
                         jax.tree_util.tree_leaves(jdeq)
                         + jax.tree_util.tree_leaves(jerr)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_train_step_with_compression_matches_jax():
    """A whole step with int8 compression and error feedback: the loss,
    parameters (rtol 1e-6) and error feedback as JAX's. The feedback
    g − deq keeps the gradient's own rounding (its matmul sums in another
    order; |g| up to about 4, an ulp of 2.4e-7 there): atol 1e-6."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    y = rng.standard_normal((16, 4)).astype(np.float32)
    kw = dict(opt=dict(lr=1e-2, warmup_steps=1), compress_grads=True)

    def jloss(p, b):
        loss = jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)
        return loss, {"loss": loss}

    jtc = jloop.TrainConfig(opt=jopt.AdamWConfig(**kw["opt"]),
                            compress_grads=True)
    js = jloop.make_train_state({"w": jnp.asarray(w)}, jtc)
    jstep = jax.jit(jloop.make_train_step(jloss, jtc))
    tc = train_loop.TrainConfig(opt=opt_lib.AdamWConfig(**kw["opt"]),
                                compress_grads=True)
    ts = train_loop.make_train_state({"w": torch.from_numpy(w.copy())}, tc)
    tstep = train_loop.make_train_step(_lsq, tc)
    for _ in range(2):
        js, jm = jstep(js, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        ts, tm = tstep(ts, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-6)
    np.testing.assert_allclose(ts["params"]["w"].detach().numpy(),
                               np.asarray(js["params"]["w"]), rtol=1e-6)
    np.testing.assert_allclose(ts["err_fb"]["w"].numpy(),
                               np.asarray(js["err_fb"]["w"]), rtol=0,
                               atol=1e-6)


def _state_np(rng):
    return {"params": {"item": {"table": rng.standard_normal((6, 4)).astype(
                np.float32)}, "user": {"w0": rng.standard_normal(3).astype(
                    np.float32)}},
            "opt": {"m": {"item": {"table": np.asarray(jnp.asarray(
                rng.standard_normal((6, 4)), jnp.bfloat16))},
                "user": {"w0": np.zeros(3, np.float32)}},
                "step": np.int32(11)}}


def test_jax_checkpoint_restores_in_port_bit_equal(tmp_path):
    state = _state_np(np.random.default_rng(6))
    jckpt.save(str(tmp_path), 11, jax.tree_util.tree_map(jnp.asarray, state))
    template = _to_torch(jax.tree_util.tree_map(np.zeros_like, state))
    got = ckpt.restore(str(tmp_path), 11, template)
    assert ckpt.latest_step(str(tmp_path)) == 11
    for (name, g), want in zip(tree.flatten(got),
                               jax.tree_util.tree_leaves(state)):
        w = _to_torch(want)
        assert g.dtype == w.dtype, name
        assert torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16
                           else g, w.view(torch.int16)
                           if w.dtype == torch.bfloat16 else w), name


def test_port_checkpoint_restores_in_jax_bit_equal(tmp_path):
    state = _state_np(np.random.default_rng(7))
    ckpt.save(str(tmp_path), 11, _to_torch(state))
    got = jckpt.restore(str(tmp_path), 11,
                        jax.tree_util.tree_map(jnp.asarray, state))
    for g, want in zip(jax.tree_util.tree_leaves(got),
                       jax.tree_util.tree_leaves(state)):
        assert g.dtype == want.dtype
        assert np.asarray(g).tobytes() == np.asarray(want).tobytes()
    with open(tmp_path / "step_11" / "manifest.json") as f:
        names = list(__import__("json").load(f)["leaves"])
    assert names == ["opt/m/item/table", "opt/m/user/w0", "opt/step",
                     "params/item/table", "params/user/w0"]


def test_entry_points_make_state_on_the_params_device():
    tc = train_loop.TrainConfig(compress_grads=True)
    state = train_loop.make_train_state({"w": torch.ones(3)}, tc)
    for leaf in tree.leaves(state):
        assert leaf.device.type == "cpu"
    assert state["params"]["w"].requires_grad
    assert state["opt"]["step"].dtype == torch.int32
