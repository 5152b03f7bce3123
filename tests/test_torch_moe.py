"""The port's MoE FFN (``models/moe.py``) and the MoE LM granite-moe-3b-a800m
against the JAX package, on the CPU.

Weights come from the JAX package's ``init`` and are carried across bit
for bit (``convert.lm_from_numpy`` for the model); inputs are seeded numpy.
``moe_ffn`` in f32: outputs within rtol 1e-5 and atol 1e-6 of their
largest |value|, aux within 1e-6,
at granite's smoke ``MoEConfig`` (no shared expert) and deepseek's (one
shared expert), at a length that leaves zero-padded rows in the last
chunk (every one a tie of E equal probabilities, routed by ``lax.top_k``'s
rule to experts 0..K-1) and at a multiple of the chunk slice. One chunk
of more than 1024 tokens with skewed inputs overflows the capacity: the
dropped assignments, the outputs and aux equal JAX's. Gradients by
autograd against ``jax.grad`` within rtol 1e-5, atol 1e-7 + 1e-6 of each
leaf's largest (the model's: 3e-5 of it, see its test).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import deepseek_v3_671b as jdeepseek
from repro.configs import granite_moe_3b_a800m as jgranite
from repro.configs import lm_common as jlm_common
from repro.launch import train as jtrain
from repro.models import common as jcm
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import get_arch, granite_moe_3b_a800m, lm_common
from repro_torch.launch import train as train_launch
from repro_torch.models import common as cm
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.train import loop as train_loop
from repro_torch.train import tree

# Small tensors: one intra-op thread per test worker keeps the workers of
# a parallel test run from spinning on each other's cores.
torch.set_num_threads(1)

SMOKE = {"granite": jgranite.smoke_config().moe,
         "deepseek": jdeepseek.smoke_config().moe}


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(m: jmoe.MoEConfig, D: int, chunk: int):
    """The reference's FFNConfig and the port's, same fields."""
    jm = dataclasses.replace(m, chunk=chunk)
    jcfg = jmoe.FFNConfig(d_model=D, d_ff=m.d_ff_expert, moe=jm)
    pcfg = moe.FFNConfig(d_model=D, d_ff=m.d_ff_expert,
                         moe=moe.MoEConfig(**dataclasses.asdict(jm)))
    return jcfg, pcfg


def _params(jcfg, seed=0):
    """JAX's MoE parameters (values) and the same arrays as the port's
    ``MoEFFN``."""
    values, _ = jcm.split(jmoe.init_moe_ffn(jax.random.PRNGKey(seed), jcfg,
                                            jnp.float32))
    v = _np(values)
    shared = None
    if "shared" in v:
        s = v["shared"]
        shared = moe.DenseFFN(_t(s["w_in"]), _t(s["w_out"]),
                              _t(s["w_gate"]))
    return values, moe.MoEFFN(_t(v["router"]), _t(v["w_gate"]),
                              _t(v["w_in"]), _t(v["w_out"]), shared)


def _inputs(B, S, D, seed, skew=False):
    """Normal hidden states; with ``skew`` three quarters of the positions
    repeat one row, so that its experts overflow their capacity."""
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)
    if skew:
        x[:, :3 * S // 4] = x[0, 0]
    return x


def _jax_moe(values, jcfg, x):
    out, aux = jax.jit(lambda p, x: jmoe.moe_ffn(p, jcfg, x))(
        values, jnp.asarray(x))
    return np.asarray(out), float(aux)


def _close_out(got, want):
    """rtol 1e-5 and atol 1e-6 of the outputs' largest |value|: at the
    reference's init (experts at 1/√E) the outputs reach about 50, where
    f32 rounds at 4e-6, and the two frameworks sum in other orders."""
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def _close_aux(aux, jaux):
    """Within 1e-6, relative where aux exceeds 1 (skewed chunks reach 3;
    the mean of the probabilities sums n values in another order)."""
    assert abs(aux - jaux) <= 1e-6 * max(1.0, abs(jaux)), (aux, jaux)


def _jax_routing(values, jcfg, xc):
    """The reference's top-K and keep mask of one chunk (n, D), as
    the reference's ``_dispatch_chunk`` computes them."""
    m = jcfg.moe
    n = xc.shape[0]
    C = n if n <= 1024 else max(int(n * m.top_k * m.capacity_factor)
                                // m.n_experts, 1)
    probs = jax.nn.softmax(jnp.asarray(xc) @ values["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    assign = jax.nn.one_hot(idx.reshape(-1), m.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(assign, axis=0) - assign) * assign, axis=-1)
    return np.asarray(idx), np.asarray(pos.reshape(n, m.top_k) < C)


# ----------------------------------------------------------- moe_ffn

@pytest.mark.parametrize("S", [40, 64])
@pytest.mark.parametrize("name", list(SMOKE))
def test_moe_ffn_matches_jax(name, S):
    """B = 2 at chunk 64: sc = 32, so S = 40 leaves 24 zero rows a batch
    row in the second chunk and S = 64 none."""
    jcfg, pcfg = _cfgs(SMOKE[name], 64, 64)
    values, p = _params(jcfg)
    x = _inputs(2, S, 64, seed=S)
    want, jaux = _jax_moe(values, jcfg, x)
    with torch.no_grad():
        got, aux = moe.moe_ffn(p, pcfg, torch.from_numpy(x))
    assert got.shape == (2, S, 64)
    _close_out(got.numpy(), want)
    _close_aux(float(aux), jaux)
    if S % 32:
        # The padded rows: every probability equal, experts 0..K-1 taken.
        r = moe.route(p, pcfg, torch.zeros((3, 64)))
        K = pcfg.moe.top_k
        assert torch.equal(r.idx, torch.arange(K).expand(3, K))
        assert torch.equal(r.gate, torch.full((3, K), 1.0 / K))


@pytest.mark.parametrize("B,S", [(1, 1500), (2, 1000)])
def test_capacity_dropping_matches_jax(B, S):
    """One chunk of n = B·S > 1024 tokens at D 16, E 8, K 2, capacity
    factor 1.0 (C = n / 4), skewed so that the repeated row's two experts
    overflow: the port drops the assignments JAX drops (top-K and keep
    equal), and the outputs and aux equal JAX's."""
    m = jmoe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16,
                       capacity_factor=1.0)
    jcfg, pcfg = _cfgs(m, 16, 2048)
    values, p = _params(jcfg, seed=3)
    x = _inputs(B, S, 16, seed=B, skew=True)
    xc = x.reshape(B * S, 16)
    r = moe.route(p, pcfg, torch.from_numpy(xc))
    jidx, jkeep = _jax_routing(values, jcfg, xc)
    assert r.C == B * S * 2 // 8
    np.testing.assert_array_equal(r.idx.numpy(), jidx)
    np.testing.assert_array_equal(r.keep.numpy(), jkeep)
    assert (~r.keep).sum() > 100
    want, jaux = _jax_moe(values, jcfg, x)
    with torch.no_grad():
        got, aux = moe.moe_ffn(p, pcfg, torch.from_numpy(x))
    _close_out(got.numpy(), want)
    _close_aux(float(aux), jaux)


def test_moe_builds_no_dispatch_tensor():
    """The forward moves tokens by gathers: at n = 128 tokens a chunk
    (D 64, E 8, dropless C = 128) no operation makes a tensor of n·E·C
    elements, none is an index_add or an accumulating index_put (a
    scatter-add), in the forward or, with gradients, in the backward; two
    runs bit-equal."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.largest, self.scatter_adds = set(), 0, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = str(func)
            self.ops.add(name)
            if "index_add" in name or ("index_put" in name and (
                    args[3] if len(args) > 3
                    else kwargs.get("accumulate", False))):
                self.scatter_adds += 1
            for t in out if isinstance(out, (tuple, list)) else [out]:
                if isinstance(t, torch.Tensor):
                    self.largest = max(self.largest, t.numel())
            return out

    jcfg, pcfg = _cfgs(SMOKE["deepseek"], 64, 128)
    _, p = _params(jcfg)
    x = torch.from_numpy(_inputs(2, 64, 64, seed=1))
    rec = Record()
    with torch.no_grad(), rec:
        a, _ = moe.moe_ffn(p, pcfg, x)
    with torch.no_grad():
        b, _ = moe.moe_ffn(p, pcfg, x)
    n, E = 128, pcfg.moe.n_experts
    assert 0 < rec.largest < n * E * n
    assert rec.scatter_adds == 0, rec.ops
    assert torch.equal(a, b)
    for t in p.parameters():
        t.requires_grad_(True)
    tx = x.clone().requires_grad_(True)
    rec = Record()
    with rec:
        out, aux = moe.moe_ffn(p, pcfg, tx)
        torch.autograd.grad((out.square().sum() + aux), [tx, p.w_in,
                                                        p.router])
    assert "aten.bmm.default" in rec.ops
    assert rec.scatter_adds == 0, sorted(o for o in rec.ops
                                         if "index" in o)
    assert rec.largest < n * E * n


@pytest.mark.parametrize("case", ["granite", "deepseek", "dropping"])
def test_moe_grads_match_jax(case):
    """Gradients of Σ out · w + 0.3 · aux by autograd (each chunk under
    torch.utils.checkpoint) against jax.grad: every parameter and x."""
    if case == "dropping":
        m = jmoe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16,
                           capacity_factor=1.0)
        D, chunk, B, S, skew = 16, 2048, 1, 1200, True
    else:
        m, D, chunk, B, S, skew = SMOKE[case], 64, 64, 2, 40, False
    jcfg, pcfg = _cfgs(m, D, chunk)
    values, p = _params(jcfg, seed=5)
    x = _inputs(B, S, D, seed=6, skew=skew)
    w = np.random.default_rng(7).standard_normal((B, S, D)).astype(
        np.float32)

    def jloss(v, x):
        out, aux = jmoe.moe_ffn(v, jcfg, x)
        return jnp.sum(out * w) + 0.3 * aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(values,
                                                       jnp.asarray(x))
    leaves = dict(p.named_parameters())
    for t in leaves.values():
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_ffn(p, pcfg, tx)
    loss = (out * torch.from_numpy(w)).sum() + 0.3 * aux
    grads = torch.autograd.grad(loss, [tx, *leaves.values()])
    want = dict(tree.flatten(_np(jg)))
    want["x"] = np.asarray(jgx)
    got = dict(zip(["x", *(n.replace(".", "/") for n in leaves)], grads))
    assert got.keys() == want.keys()
    for name, g in got.items():
        wv = want[name]
        np.testing.assert_allclose(g.numpy(), wv, rtol=1e-5,
                                   atol=1e-7 + 1e-6 * np.abs(wv).max(),
                                   err_msg=name)


# -------------------------------------------------------- the model

def _granite(**overrides):
    jcfg = dataclasses.replace(jgranite.smoke_config(), **overrides)
    cfg = dataclasses.replace(granite_moe_3b_a800m.smoke_config(),
                              **overrides)
    values, _ = jtf.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, values, cfg, convert.lm_from_numpy(_np(values), cfg,
                                                    device="cpu")


@pytest.fixture(scope="module")
def granite():
    return _granite()


def _tokens(cfg, B, S, seed=7):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    return toks, np.roll(toks, -1, 1)


def test_granite_registry_and_published_widths():
    mod = get_arch("granite-moe-3b-a800m")
    assert mod is granite_moe_3b_a800m and mod.FAMILY == "lm"
    for name in ("config", "smoke_config"):
        got, want = getattr(mod, name)(), getattr(jgranite, name)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_granite_prefill_and_decode_match_jax(granite):
    """S = 48 at B = 2: the MoE's second chunk holds 16 positions and 16
    zero rows a batch row. prefill's last logits and every cache, then 3
    greedy decode steps (one token a row, dropless), within 1e-4."""
    jcfg, values, cfg, model = granite
    toks, _ = _tokens(cfg, 2, 48)
    jl, jc = jtf.prefill(values, jcfg, jnp.asarray(toks), max_seq=56)
    pl, pc = tf.prefill(model, cfg, torch.from_numpy(toks), 56)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(jc, tf.caches_by_run(cfg, pc)):
        np.testing.assert_array_equal(b["pos"].numpy(), np.asarray(a["pos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(b[key].numpy(), np.asarray(a[key]),
                                       rtol=1e-5, atol=1e-5)
    nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    for st in range(48, 51):
        pos = np.full((2,), st, np.int32)
        jl, jc = jtf.decode_step(values, jcfg, jnp.asarray(nxt),
                                 jnp.asarray(pos), jc, jnp.int32(st))
        pl, pc = tf.decode_step(model, cfg, torch.from_numpy(nxt),
                                torch.from_numpy(pos), pc, st)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)


def test_granite_loss_and_grads_match_jax(granite):
    """loss_fn at S = 48 (an MoE chunk with padded rows): loss, lm_loss,
    aux_loss within rtol 1e-5 and every gradient leaf within rtol 1e-5,
    atol 1e-7 + 3e-5 of the leaf's largest against jax.value_and_grad.
    The experts at the reference's 1/√E carry the residual stream to
    about 50 and the logits to about 100, where f32 rounds the peaked
    softmax's gradient at about 1e-5 of each leaf's largest in both
    frameworks (measured at most 1.1e-5; every leaf alike, attention's
    too); moe_ffn alone meets 1e-6 (test_moe_grads_match_jax)."""
    jcfg, values, cfg, _ = granite
    toks, labels = _tokens(cfg, 2, 48)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, jnp.asarray(toks),
                              jnp.asarray(labels)), has_aux=True))(values)
    model = convert.lm_from_numpy(_np(values), cfg, device="cpu")
    params = tf.param_tree(model)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    loss, metrics, grads = train_loop.value_and_grad(
        lambda p, b: tf.loss_fn(p, cfg, *b), params, (_t(toks), _t(labels)))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert float(metrics["aux_loss"]) > 0
    for key in ("lm_loss", "aux_loss", "loss"):
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]),
                                   rtol=1e-5)
    want = dict(tree.flatten(convert._lm_layer_tree(_np(jg), cfg)))
    got = dict(tree.flatten(grads))
    assert got.keys() == want.keys()
    assert "layers/1/ffn/router" in got
    for name, g in got.items():
        w = np.asarray(want[name], dtype=np.float32)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-7 + 3e-5 * np.abs(w).max(),
                                   err_msg=name)


def test_granite_train_steps_and_continuation_match_jax(granite):
    """Three TRAIN_CFG steps (bf16 moments) on the launcher's batches
    against the reference's jitted steps, aux_loss in the metrics; then
    JAX's state after step 2, carried over by train_state_from_numpy (the
    MoE leaves and their moments bit for bit), one step on."""
    jcfg, values, cfg, _ = granite
    jstate = jloop.make_train_state(values, jlm_common.TRAIN_CFG)
    jstep = jax.jit(jloop.make_train_step(
        lambda p, b: jtf.loss_fn(p, jcfg, b["tokens"], b["labels"]),
        jlm_common.TRAIN_CFG))
    jstates, jmetrics = [], []
    for s in range(3):
        jstate, m = jstep(jstate, jtrain.synth_lm_batch(jcfg, 2, 32, s))
        jstates.append(jstate)
        jmetrics.append({k: float(v) for k, v in m.items()})
    model = convert.lm_from_numpy(_np(values), cfg, device="cpu")
    state = train_loop.make_train_state(tf.param_tree(model),
                                        lm_common.TRAIN_CFG)
    step = train_loop.make_train_step(
        lambda p, b: tf.loss_fn(p, cfg, b["tokens"], b["labels"]),
        lm_common.TRAIN_CFG)
    for s in range(3):
        state, m = step(state, train_launch.synth_lm_batch(cfg, 2, 32, s,
                                                           "cpu"))
        for key in ("loss", "aux_loss"):
            np.testing.assert_allclose(float(m[key]), jmetrics[s][key],
                                       rtol=1e-4, err_msg=key)
    cont = convert.train_state_from_numpy(_np(jstates[1]), cfg,
                                          device="cpu")
    leaf = cont["opt"]["v"]["layers"][2]["ffn"]["w_out"]
    want = np.asarray(jstates[1]["opt"]["v"]["stack_0"]["ffn"]["w_out"][2])
    assert leaf.dtype == torch.bfloat16
    assert np.array_equal(leaf.view(torch.int16).numpy(),
                          want.view(np.int16))
    cont, m = step(cont, train_launch.synth_lm_batch(cfg, 2, 32, 2, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), jmetrics[2]["loss"],
                               rtol=1e-5)
    want = dict(tree.flatten(convert._lm_layer_tree(
        _np(jstates[2]["params"]), cfg)))
    for name, g in tree.flatten(cont["params"]):
        np.testing.assert_allclose(g.detach().numpy(), want[name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_granite_bf16_prefill_matches_jax():
    """granite's smoke widths in bf16 (params and compute; the router
    stays f32), one layer, 8 prompts: every row's last logits within 0.05
    × their std of JAX's (measured 0.018-0.035) and the same greedy
    tokens. One layer: a token whose K-th and (K+1)-th probabilities lie
    within bf16's rounding of each other may take another expert in the
    two frameworks, and from the second layer on that moves its whole
    row (measured at 3 layers: 2 of these 8 rows 1.7-2.4 std off, the
    other 6 within 0.062)."""
    jcfg, values, cfg, model = _granite(param_dtype="bfloat16",
                                        compute_dtype="bfloat16",
                                        n_layers=1)
    assert model.layers[0].ffn.w_in.dtype == torch.bfloat16
    assert model.layers[0].ffn.router.dtype == torch.float32
    toks, _ = _tokens(cfg, 8, 32)
    jl, _ = jtf.prefill(values, jcfg, jnp.asarray(toks), max_seq=40)
    pl, _ = tf.prefill(model, cfg, torch.from_numpy(toks), 40)
    want, got = np.asarray(jl).astype(np.float32), pl.float().numpy()
    assert np.abs(got - want).max() <= 0.05 * want.std()
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_moe_lm_from_numpy_keys_and_bf16_bit_exact():
    """An MoE tree carries over bit for bit in bf16 (deepseek's shared
    expert too, through a dense-prefix MoE LM without MLA); a missing or
    extra MoE key raises."""
    jcfg = dataclasses.replace(jgranite.smoke_config(),
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(granite_moe_3b_a800m.smoke_config(),
                              param_dtype="bfloat16")
    npv = _np(jtf.init(jax.random.PRNGKey(1), jcfg)[0])
    model = convert.lm_from_numpy(npv, cfg, device="cpu")
    want = npv["stack_0"]["ffn"]["w_gate"][1]
    assert np.array_equal(
        model.layers[1].ffn.w_gate.view(torch.int16).numpy(),
        want.view(np.int16))
    assert np.array_equal(model.layers[2].ffn.router.numpy(),
                          npv["stack_0"]["ffn"]["router"][2])
    params = tf.param_tree(model)
    assert set(params["layers"][0]["ffn"]) == {"router", "w_gate", "w_in",
                                               "w_out"}
    for bad in ({"router", "w_gate", "w_in"},
                {"router", "w_gate", "w_in", "w_out", "extra"}):
        st = dict(npv["stack_0"])
        ffn = dict(st["ffn"], extra=st["ffn"]["w_in"])
        st["ffn"] = {k: ffn[k] for k in bad}
        with pytest.raises(ValueError, match="keys"):
            convert.lm_from_numpy(dict(npv, stack_0=st), cfg, device="cpu")

    # A dense prefix and a shared expert: deepseek's MoE on a GQA model.
    dcfg_j = dataclasses.replace(jdeepseek.smoke_config(), mla=None,
                                 mtp_depth=0)
    dv = _np(jtf.init(jax.random.PRNGKey(2), dcfg_j)[0])
    dcfg = tf.LMConfig(**{f.name: getattr(dcfg_j, f.name)
                          for f in dataclasses.fields(tf.LMConfig)
                          if f.name not in ("moe", "mla")},
                       moe=moe.MoEConfig(**dataclasses.asdict(dcfg_j.moe)))
    dm = convert.lm_from_numpy(dv, dcfg, device="cpu")
    assert isinstance(dm.layers[0].ffn, moe.DenseFFN)
    assert isinstance(dm.layers[1].ffn.shared, moe.DenseFFN)
    assert np.array_equal(dm.layers[3].ffn.shared.w_out.numpy(),
                          dv["stack_1"]["ffn"]["shared"]["w_out"][2])
    st = dict(dv["stack_1"], ffn={k: v for k, v in dv["stack_1"][
        "ffn"].items() if k != "shared"})
    with pytest.raises(ValueError, match="keys"):
        convert.lm_from_numpy(dict(dv, stack_1=st), dcfg, device="cpu")
    toks, _ = _tokens(dcfg, 2, 32)
    jl, _ = jtf.prefill(jtf.init(jax.random.PRNGKey(2), dcfg_j)[0], dcfg_j,
                        jnp.asarray(toks), max_seq=40)
    pl, _ = tf.prefill(dm, dcfg, torch.from_numpy(toks), 40)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


def test_init_draws_the_reference_scales():
    """tf.init of an MoE LM: the router f32 at 1/√D, the experts'
    (E, ·, ·) weights at 1/√E (the reference's ``param`` scales by
    1/√shape[0]), the shared expert where n_shared > 0."""
    cfg = dataclasses.replace(granite_moe_3b_a800m.smoke_config(),
                              d_model=256, n_layers=1)
    gen = torch.Generator().manual_seed(0)
    ffn = tf.init(cfg, gen, device="cpu").layers[0].ffn
    E, D = cfg.moe.n_experts, cfg.d_model
    assert ffn.router.dtype == torch.float32 and ffn.shared is None
    assert abs(float(ffn.router.std()) * D ** 0.5 - 1.0) < 0.05
    for w in (ffn.w_gate, ffn.w_in, ffn.w_out):
        assert w.shape[0] == E
        assert abs(float(w.std()) * E ** 0.5 - 1.0) < 0.05
    shared = moe.init_moe_ffn(
        moe.FFNConfig(64, 32, moe=moe.MoEConfig(4, 2, 32, n_shared=2)),
        gen, "cpu", torch.float32).shared
    assert shared.w_in.shape == (64, 64) and shared.w_gate is not None


@pytest.mark.parametrize("n", [8, cm.TOP_K_SORT_MAX, cm.TOP_K_SORT_MAX + 1])
def test_top_k_is_one_rule_for_the_port(n):
    """common.top_k is the one tie rule, recsys's and the MoE router's:
    equal to lax.top_k on rows with ties, by a whole sort up to
    TOP_K_SORT_MAX and by torch.topk repaired above it (the rows redone
    counted)."""
    from repro_torch.models import recsys
    assert recsys._top_k is cm.top_k
    x = np.random.default_rng(n).integers(0, 4, (5, n)).astype(np.float32)
    x[0] = 0.25
    before = cm.top_k.full_sorts
    v, i = cm.top_k(torch.from_numpy(x), 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert (cm.top_k.full_sorts > before) == (n > cm.TOP_K_SORT_MAX)
