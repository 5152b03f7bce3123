"""Two-tower training in the port against the JAX package, on the CPU,
and the arch registry and the configs' smoke cells.

Parameters come from the JAX package's ``recsys.init`` and are carried
across with ``convert``; batches are the example's numpy draws.
Tolerances: ``in_batch_acc``, the registry's names and the resumed
example run are exact; loss rtol 1e-5; gradients rtol 1e-5, atol 1e-7 +
1e-6 of the leaf's largest gradient (the MLP's and the logits' sums run
in another order; gradients of scale ~1 carry ~1e-7 of rounding into
elements 500x smaller: both packages lie within 8.5e-7 of that scale from
a float64 oracle and within 5.3e-7 of each other); the plain
``embedding_bag`` backward rtol 1e-6 atol 1e-7 (repeated ids add in
another order). Several steps are held by their losses (rtol 1e-4), not
element-wise: after step 1 AdamW moves each parameter by about ±lr
whatever its gradient's size, so an element whose gradient is rounding
noise may move either way in either package. One step of the port from
JAX's state after step 4 is held against JAX's step 5.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import two_tower_retrieval as jconf
from repro.kernels import ref as jref
from repro.models import recsys as jrecsys
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch import configs, convert
from repro_torch.configs import kg_specqp
from repro_torch.configs import two_tower_retrieval as conf
from repro_torch.examples import train_retrieval
from repro_torch.kernels import ops, ref
from repro_torch.models import recsys
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import tree

# Small tensors: one intra-op thread per test worker keeps the workers of
# a parallel test run from spinning on each other's cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = conf.smoke_config()
JCFG = jconf.smoke_config()
# The example's optimizer (float32 moments).
OPT = dict(lr=3e-3, warmup_steps=20)


def _jax_example():
    """The reference's examples/train_retrieval.py as a module (it is not
    in a package)."""
    spec = importlib.util.spec_from_file_location(
        "_jax_train_retrieval", ROOT / "examples" / "train_retrieval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_params():
    values, _ = jrecsys.init(jax.random.PRNGKey(3), JCFG)
    return values


def _np(tree_):
    return jax.tree_util.tree_map(np.array, tree_)


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _close_trees(got, want, rtol, atol, atol_of_scale=0.0):
    """Leaf by leaf within rtol and atol + atol_of_scale · max|leaf|."""
    for (name, g), w in zip(tree.flatten(got),
                            jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.detach().numpy(), w, rtol=rtol,
            atol=atol + atol_of_scale * np.abs(w).max(), err_msg=name)


def test_make_batch_equals_reference():
    jex = _jax_example()
    for step in (0, 7):
        want = jex.make_batch(CFG, 16, step)
        got = train_retrieval.make_batch(CFG, 16, step, device="cpu")
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype


@pytest.mark.parametrize("logq", [False, True])
def test_loss_and_grads_match_jax(jax_params, logq):
    """recsys.loss_fn and its gradients against jax.value_and_grad, on the
    reference's own weights; ids with -1 slots and repeats."""
    batch = _np(_jax_example().make_batch(CFG, 32, 5))
    rng = np.random.default_rng(8)
    batch["user_ids"][rng.random(batch["user_ids"].shape) < 0.2] = -1
    batch["user_w"] = rng.random(batch["user_w"].shape).astype(np.float32)
    if logq:
        batch["item_logq"] = -rng.random(32).astype(np.float32)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jrecsys.loss_fn(p, JCFG, jax.tree_util.tree_map(
            jnp.asarray, batch)), has_aux=True)(jax_params)
    model = convert.two_tower_from_numpy(_np(jax_params), CFG, device="cpu")
    params = recsys.param_tree(model)
    loss, metrics, grads = train_loop.value_and_grad(
        lambda p, b: recsys.loss_fn(p, CFG, b), params, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert float(metrics["in_batch_acc"]) == float(jm["in_batch_acc"])
    _close_trees(grads, jg, rtol=1e-5, atol=1e-7, atol_of_scale=1e-6)
    # The table's gradient is the bag's scatter-add: only used rows.
    used = np.unique(batch["item_ids"])
    assert np.count_nonzero(np.abs(grads["item"]["table"].numpy()).sum(1)) \
        == len(used)


def _bag_case(rng, V=30, B=12, S=6, D=8):
    """-1 slots, ids repeated within a bag and across bags."""
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, 8, (B, S)).astype(np.int32)   # many repeats
    ids[:, 0] = ids[:, 1]                               # within a bag
    ids[rng.random((B, S)) < 0.25] = -1
    ids[3] = -1                                         # an empty bag
    w = rng.random((B, S)).astype(np.float32)
    dout = rng.standard_normal((B, D)).astype(np.float32)
    return table, ids, w, dout


def test_plain_embedding_bag_backward_matches_jax_grad():
    """The table's and the weights' gradients of the plain bag (autograd
    through ``ref.embedding_bag`` and the plain twin
    ``ref.embedding_bag_backward``) against jax.grad of
    ``embedding_bag_ref``; untouched rows exactly 0."""
    table, ids, w, dout = _bag_case(np.random.default_rng(9))
    jdt, jdw = jax.grad(
        lambda t, ww: jnp.sum(jref.embedding_bag_ref(t, jnp.asarray(ids), ww)
                              * dout), argnums=(0, 1))(jnp.asarray(table),
                                                        jnp.asarray(w))
    tt = torch.from_numpy(table).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = ops.embedding_bag(tt, torch.from_numpy(ids), tw)
    adt, adw = torch.autograd.grad(out, (tt, tw), torch.from_numpy(dout))
    pdt, pdw = ref.embedding_bag_backward(
        torch.from_numpy(dout), torch.from_numpy(ids), torch.from_numpy(w),
        torch.from_numpy(table), weights_grad=True)
    untouched = np.setdiff1d(np.arange(table.shape[0]), ids[ids >= 0])
    for dt, dw in ((adt, adw), (pdt, pdw)):
        np.testing.assert_allclose(dt.numpy(), np.asarray(jdt), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-6,
                                   atol=1e-7)
        assert not dt.numpy()[untouched].any()
        assert not dw.numpy()[ids < 0].any()
    none, only_w = ref.embedding_bag_backward(
        torch.from_numpy(dout), torch.from_numpy(ids), torch.from_numpy(w),
        torch.from_numpy(table), table_grad=False, weights_grad=True)
    assert none is None and torch.equal(only_w, pdw)


def _jax_run(jax_params, n_steps, B=64):
    jex = _jax_example()
    jtc = jloop.TrainConfig(opt=jopt.AdamWConfig(**OPT))
    state = jloop.make_train_state(jax_params, jtc)
    step = jax.jit(jloop.make_train_step(
        lambda p, b: jrecsys.loss_fn(p, JCFG, b), jtc))
    states, losses = [], []
    for s in range(n_steps):
        state, m = step(state, jex.make_batch(CFG, B, s))
        states.append(state)
        losses.append(float(m["loss"]))
    return states, losses


def test_five_steps_and_step5_continuation_match_jax(jax_params):
    states, jlosses = _jax_run(jax_params, 5)
    tc = train_loop.TrainConfig(opt=opt_lib.AdamWConfig(**OPT))
    step = train_loop.make_train_step(
        lambda p, b: recsys.loss_fn(p, CFG, b), tc)
    model = convert.two_tower_from_numpy(_np(jax_params), CFG, device="cpu")
    state = train_loop.make_train_state(recsys.param_tree(model), tc)
    losses = []
    for s in range(5):
        state, m = step(state, train_retrieval.make_batch(CFG, 64, s, "cpu"))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert model.user.table is state["params"]["user"]["table"]
    assert int(state["opt"]["step"]) == 5

    # JAX's state after step 4, continued one step in the port.
    cont = convert.train_state_from_numpy(_np(states[3]), CFG, device="cpu")
    assert int(cont["opt"]["step"]) == 4
    cont, m = step(cont, train_retrieval.make_batch(CFG, 64, 4, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), jlosses[4], rtol=1e-5)
    assert int(cont["opt"]["step"]) == 5
    _close_trees(cont["params"], states[4]["params"], rtol=1e-5, atol=1e-7)
    _close_trees(cont["opt"]["m"], states[4]["opt"]["m"], rtol=1e-4,
                 atol=1e-8)


def test_train_state_from_numpy_bf16_and_checks(jax_params):
    jtc = jloop.TrainConfig(opt=jopt.AdamWConfig(moment_dtype="bfloat16"))
    jstate = _np(jloop.make_train_state(jax_params, jtc))
    jstate["opt"]["m"]["user"]["w0"] = np.asarray(
        jnp.full((36, 64), 0.3, jnp.bfloat16))
    state = convert.train_state_from_numpy(jstate, CFG, device="cpu")
    got = state["opt"]["m"]["user"]["w0"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.full((36, 64), 0.3, dtype=torch.bfloat16))
    assert all(p.requires_grad for p in tree.leaves(state["params"]))
    bad = dict(jstate, opt=dict(jstate["opt"], m={"user": {}}))
    with pytest.raises(ValueError, match="moment"):
        convert.train_state_from_numpy(bad, CFG, device="cpu")


def test_example_resumed_run_equals_unbroken_run(tmp_path, capsys):
    """The example at its defaults (200 steps, batch 64) with a failure
    before the first checkpoint and one after it equals a run without
    failures, bit for bit; the loss falls; the retrieval is exact."""
    seen = set()

    def hook(s):
        if s in (50, 150) and s not in seen:
            seen.add(s)
            raise RuntimeError("simulated node failure")

    broken = train_retrieval.main(["--device", "cpu", "--ckpt-dir",
                                   str(tmp_path / "a")], fail_hook=hook)
    whole = train_retrieval.main(["--device", "cpu", "--ckpt-dir",
                                  str(tmp_path / "b")])
    assert broken["failures"] == 2 and whole["failures"] == 0
    for a, b in zip(tree.leaves(broken["state"]),
                    tree.leaves(whole["state"])):
        assert torch.equal(a, b)
    assert broken["history"][-1] == whole["history"][-1]
    assert whole["history"][-1]["loss"] < whole["history"][0]["loss"]
    out = capsys.readouterr().out
    assert out.count("speculative result == exact top-k") == 2
    assert "(2 restarts)" in out


def test_smoke_matches_reference_draws():
    """The smoke cell: one finite train step, and its speculative top-8
    over the reference's corpus and query draws equal to JAX's."""
    metrics, (s, i, n) = conf.smoke(device="cpu")
    assert np.isfinite(float(metrics["loss"]))
    assert 0.0 <= float(metrics["in_batch_acc"]) <= 1.0
    rng = np.random.default_rng(0)
    rng.integers(0, CFG.user_vocab, (32, CFG.user_slots))   # the batch's
    rng.standard_normal((32, CFG.n_dense_feat))             # draws come
    rng.integers(0, CFG.item_vocab, (32, CFG.item_slots))   # first
    rng.standard_normal((32, CFG.n_dense_feat))
    cand = rng.standard_normal((1024, CFG.embed_dim))
    q = rng.standard_normal((CFG.embed_dim,))
    js, ji, jn = jrecsys.score_candidates(None, JCFG,
                                          jnp.asarray(q, jnp.float32),
                                          jnp.asarray(cand, jnp.float32), 8)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert int(n) == int(jn)


def test_registry_matches_reference():
    assert configs.all_archs() == jconfigs.all_archs()
    assert configs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    for name in configs.all_archs():
        mod = configs.get_arch(name)
        assert mod.__name__.startswith("repro_torch.configs.")
        assert mod.ARCH == name == jconfigs.get_arch(name).ARCH
        if name in ("egnn", "nequip", "mace"):
            assert mod.FAMILY == jconfigs.get_arch(name).FAMILY == "gnn"
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("no-such-arch")


def test_kg_specqp_smoke():
    """TriniT equals the full scan on the tiny workload (checked inside);
    specqp answers every query with no more pulls than TriniT."""
    outs = kg_specqp.smoke(device="cpu")
    assert len(outs) == 4
    for rt, rs in outs:
        assert int(rs.n_pulled) <= int(rt.n_pulled)
        assert rt.keys.shape == rs.keys.shape == (kg_specqp.smoke_config().k,)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: conf.smoke(), lambda: kg_specqp.smoke(),
                 lambda: train_retrieval.main([]),
                 lambda: train_retrieval.make_batch(CFG, 2, 0),
                 lambda: convert.train_state_from_numpy({}, CFG)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _order_bound(dout, ids, w, table):
    """Two float32 sums of the same D terms, in any two orders, differ by
    at most 2 (D − 1) 2⁻²⁴ Σ|term|: the bound per element of the weights'
    gradient (the kernel's shuffle tree against the plain version's sum)."""
    mag = ref.embedding_bag_backward(dout.abs(), ids, w.abs(), table.abs(),
                                     table_grad=False, weights_grad=True)[1]
    return 2 * (dout.shape[1] - 1) * 2.0 ** -24 * mag


@pytest.mark.gpu
def test_cuda_embedding_bag_backward_matches_plain(cuda):
    """On the card: the table gradient bit-equal to the plain version on
    the CPU (the kernel sums each row in slot order, as index_add_ does),
    two runs bit-equal, untouched rows exactly 0, with −1 slots, repeats
    within and across bags (about 180 slots a row), ids above 2**23 and
    V above 2**24 (one more radix pass; D = 32, 2.1 GB); the weights'
    gradient within the float32 order bound; the autograd path equal to
    the kernel; and a train step's gradients on the card within rtol 1e-4
    atol 1e-6 of the CPU's."""
    rng = np.random.default_rng(10)
    # The large tables are 32 wide: chip_smoke.py holds ids above 2**23 at
    # D = 256 on its 10 M-row table.
    for V, D, lo in ((64, 256, 0), (2**23 + 300, 32, 2**23),
                     (2**24 + 300, 32, 2**24 - 20)):
        table = torch.randn((V, D), device=cuda)
        ids = rng.integers(lo, lo + 40, (300, 32)).astype(np.int32)
        ids[rng.random(ids.shape) < 0.25] = -1
        ids_t = torch.from_numpy(ids).to(cuda)
        w = torch.rand((300, 32), device=cuda)
        dout = torch.randn((300, D), device=cuda)
        runs = [ops.embedding_bag_backward(dout, ids_t, w, table,
                                           weights_grad=True)
                for _ in range(2)]
        want = ops.embedding_bag_backward(dout.cpu(), ids_t.cpu(), w.cpu(),
                                          table.cpu(), weights_grad=True)
        assert torch.equal(runs[0][0], runs[1][0])
        got = runs[0][0].cpu()
        assert torch.equal(got, want[0])
        untouched = torch.ones(V, dtype=torch.bool)
        untouched[ids_t[ids_t >= 0].long().cpu()] = False
        assert not got[untouched].any()
        assert bool(((runs[0][1].cpu() - want[1]).abs()
                     <= _order_bound(dout, ids_t, w, table).cpu()).all())
        tt = table.clone().requires_grad_()
        out = ops.embedding_bag(tt, ids_t, w)
        (auto,) = torch.autograd.grad(out, tt, dout)
        assert torch.equal(auto.cpu(), want[0])
        del table, runs, want, got, tt, out, auto
        torch.cuda.empty_cache()
    model = recsys.init(CFG, seed=0, device="cpu")
    batch = train_retrieval.make_batch(CFG, 64, 0, device="cpu")
    _, _, want = train_loop.value_and_grad(
        lambda p, b: recsys.loss_fn(p, CFG, b), recsys.param_tree(model),
        batch)
    card = {side: {n: p.detach().to(cuda).requires_grad_()
                   for n, p in sub.items()}
            for side, sub in recsys.param_tree(model).items()}
    ops.reset_launches()
    _, _, got = train_loop.value_and_grad(
        lambda p, b: recsys.loss_fn(p, CFG, b), card,
        {k: v.to(cuda) for k, v in batch.items()})
    assert ops.launches()["embedding_bag_backward"] == 2
    for g, e in zip(tree.leaves(got), tree.leaves(want)):
        torch.testing.assert_close(g.cpu(), e, rtol=1e-4, atol=1e-6)
