"""The port's EGNN (``models/gnn/egnn.py``) against the JAX package, on the
CPU.

Graphs come from both packages' ``graph_synth`` with the same seed
(bit-equal, ``tests/test_torch_gnn.py``); weights from the reference's
``egnn.init``, carried across by ``convert.egnn_from_numpy``. The JAX side
is jitted once a case and cached for the file.

The bar, unless a test's docstring says otherwise: rtol 1e-5 and atol
1e-6 × the block's largest |value| (h and x, the loss, each gradient leaf,
each leaf of the train state). Gradients and moments at the smoke config
are held at atol 1e-5 × the leaf's largest: on the node_class graph the
reference's gradient of ``layer_0/coord_mlp`` lies 4.8e-6 of that leaf's
largest from a float64 evaluation of the same function, where the port's
lies 2.1e-7 (every leaf of the port's within 7e-7), so the port is also
held to its own float64 gradient at the shared bar.

The one difference on purpose: at a zero-length edge (a self-loop) the
reference's ``jnp.sqrt(d2)`` has gradient 0 · ∞ = NaN
(``src/repro/models/gnn/egnn.py:75``), and from three layers on it reaches
the weights. The port's coordinate message has its true gradient there,
and its forward is bit-equal to the reference's formula.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import egnn as jegnn_c, gnn_common as jgnn_common
from repro.data import graph_synth as jgs
from repro.models.gnn import e3 as je3, egnn as jegnn
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import egnn as egnn_c, get_arch, gnn_common
from repro_torch.data import graph_synth as gs
from repro_torch.models.gnn import egnn
from repro_torch.train import loop as train_loop, tree

# Small tensors: one intra-op thread per test worker keeps the workers of
# a parallel test run from spinning on each other's cores.
torch.set_num_threads(1)

RTOL, ATOL_OF_MAX = 1e-5, 1e-6
GRAD_ATOL_OF_MAX = 1e-5
TASKS = ("node_class", "graph_reg")
# The reference's own molecule shape: 128 molecules of 30 atoms, 64 edges
# each, 16 features (configs/gnn_common.py GNN_SHAPES["molecule"]).
MOLECULE = dict(batch=128, n_nodes=30, n_edges=64, d_feat=16, seed=0)


def _close(got, want, what="", atol_of_max=ATOL_OF_MAX):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, what
    np.testing.assert_allclose(
        got, want, rtol=RTOL,
        atol=atol_of_max * max(float(np.abs(want).max(initial=0.0)), 1e-30),
        err_msg=what)


def _graphs(task):
    """(reference graph, port graph): the reference test's node_class
    graph or its smoke molecules."""
    if task == "node_class":
        gk = dict(n_nodes=80, n_edges=320, d_feat=8, seed=2)
        return jgs.random_graph(**gk), gs.random_graph(device="cpu", **gk)
    gk = dict(batch=4, n_nodes=12, n_edges=24, d_feat=8)
    return jgs.molecule_batch(**gk), gs.molecule_batch(device="cpu", **gk)


def _host(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _jax_grads(jcfg, values, jg):
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda v, g: jegnn.loss_fn(v, jcfg, g), has_aux=True))(values, jg)
    return float(loss), _host(grads)


def _port_grads(cfg, params, g):
    for p in tree.leaves(params):
        p.requires_grad_(True)
    loss, _, grads = train_loop.value_and_grad(
        lambda p, gg: egnn.loss_fn(p, cfg, gg), params, g)
    return float(loss), dict(tree.flatten(grads))


@functools.lru_cache(maxsize=None)
def _jax_case(task):
    """The reference's smoke config, weights (as numpy), apply outputs,
    loss, gradients and its state after one TRAIN_CFG step, jitted."""
    jcfg = dataclasses.replace(jegnn_c.smoke_config(), task=task)
    jg, _ = _graphs(task)
    values, _ = jegnn.init(jax.random.PRNGKey(1), jcfg)
    h, x = jax.jit(lambda v, g: jegnn.apply(v, jcfg, g))(values, jg)
    loss, grads = _jax_grads(jcfg, values, jg)
    tc = jgnn_common.TRAIN_CFG
    state = jloop.make_train_state(values, tc)
    after, metrics = jax.jit(jloop.make_train_step(
        lambda v, g: jegnn.loss_fn(v, jcfg, g), tc))(state, jg)
    return dict(values=_host(values), h=np.asarray(h), x=np.asarray(x),
                loss=loss, grads=grads, state=_host(state),
                after=_host(after), metrics={k: float(v) for k, v in
                                            metrics.items()})


def _port_case(task):
    cfg = dataclasses.replace(egnn_c.smoke_config(), task=task)
    _, g = _graphs(task)
    ref = _jax_case(task)
    return cfg, g, convert.egnn_from_numpy(ref["values"], cfg,
                                           device="cpu"), ref


@pytest.mark.parametrize("task", TASKS)
def test_apply_matches_jax(task):
    """apply at the smoke config: h and x at the shared bar."""
    cfg, g, params, ref = _port_case(task)
    h, x = egnn.apply(params, cfg, g)
    _close(h, ref["h"], "h")
    _close(x, ref["x"], "x")


def _float64(g, params):
    return (dataclasses.replace(g, node_feat=g.node_feat.double(),
                                positions=g.positions.double()),
            tree.tree_map(lambda t: t.detach().double(), params))


@pytest.mark.parametrize("task", TASKS)
def test_loss_and_grads_match_jax(task):
    """loss_fn (rtol 1e-6) and every gradient leaf against
    jax.value_and_grad at atol 1e-5 × the leaf's largest (see the module
    docstring); every leaf within the shared bar of the port's own float64
    gradient."""
    cfg, g, params, ref = _port_case(task)
    loss, grads = _port_grads(cfg, params, g)
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-6)
    want = dict(tree.flatten(ref["grads"]))
    assert list(grads) == list(want)
    g64, p64 = _float64(g, params)
    _, grads64 = _port_grads(cfg, p64, g64)
    for k, got in grads.items():
        _close(got, want[k], f"grad {k}", GRAD_ATOL_OF_MAX)
        _close(got, grads64[k].numpy(), f"float64 grad {k}")


@pytest.mark.parametrize("task", TASKS)
def test_train_step_matches_jax(task):
    """One TRAIN_CFG step from JAX's initial state, carried over by
    convert.train_state_from_numpy, against JAX's jitted step: the loss,
    grad_norm and every leaf of params at the shared bar, of m and v at
    the gradients' bar."""
    cfg, g, _, ref = _port_case(task)
    state = convert.train_state_from_numpy(ref["state"], cfg, device="cpu")
    step = train_loop.make_train_step(
        lambda p, gg: egnn.loss_fn(p, cfg, gg), gnn_common.TRAIN_CFG)
    state, metrics = step(state, g)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), ref["metrics"][k],
                                   rtol=1e-5, err_msg=k)
    for part, got_tree, want_tree in (
            ("params", state["params"], ref["after"]["params"]),
            ("m", state["opt"]["m"], ref["after"]["opt"]["m"]),
            ("v", state["opt"]["v"], ref["after"]["opt"]["v"])):
        want = dict(tree.flatten(want_tree))
        for k, got in tree.flatten(got_tree):
            _close(got, want[k], f"{part} {k}",
                   ATOL_OF_MAX if part == "params" else GRAD_ATOL_OF_MAX)


# ------------------------------------------------- zero-length edges

def _no_self_loops(jg, g):
    """Both graphs with every self-loop made a padding edge (src -1)."""
    loops = np.asarray(jg.edge_src) == np.asarray(jg.edge_dst)
    src = np.where(loops, -1, np.asarray(jg.edge_src)).astype(np.int32)
    return (dataclasses.replace(jg, edge_src=jnp.asarray(src)),
            dataclasses.replace(g, edge_src=torch.from_numpy(src)))


@functools.lru_cache(maxsize=None)
def _molecule_case(self_loops: bool):
    """config() (4 layers, d_hidden 64) on the molecule shape: the
    reference's weights and its loss and gradients, jitted."""
    jcfg = jegnn_c.config()
    jg = jgs.molecule_batch(**MOLECULE)
    g = gs.molecule_batch(device="cpu", **MOLECULE)
    if not self_loops:
        jg, g = _no_self_loops(jg, g)
    values, _ = jegnn.init(jax.random.PRNGKey(0), jcfg)
    loss, grads = _jax_grads(jcfg, values, jg)
    return g, _host(values), loss, dict(tree.flatten(grads))


def test_self_loops_give_finite_grads_equal_to_jax_where_finite():
    """config() at the molecule shape, whose 8,192 edges hold 261
    self-loops: the reference's gradient is NaN in 11 of its 27 leaves;
    the port's loss equals JAX's (rtol 1e-6), its gradient is finite in
    every leaf, and each leaf where JAX's is finite is at the shared
    bar."""
    g, npv, jloss, jgrads = _molecule_case(True)
    cfg = egnn_c.config()
    assert int(((g.edge_src == g.edge_dst) & (g.edge_src >= 0)).sum()) \
        == 261
    nan_leaves = [k for k, v in jgrads.items() if not np.isfinite(v).all()]
    assert len(jgrads) == 27 and len(nan_leaves) == 11
    loss, grads = _port_grads(cfg, convert.egnn_from_numpy(
        npv, cfg, device="cpu"), g)
    np.testing.assert_allclose(loss, jloss, rtol=1e-6)
    for k, got in grads.items():
        assert torch.isfinite(got).all(), k
        if k not in nan_leaves:
            _close(got, jgrads[k], f"grad {k}")


def test_without_self_loops_every_leaf_equals_jax():
    """The same molecules with each self-loop made a padding edge: no
    zero-length edge is left, the reference's gradient is finite, and
    every leaf of the port's is at the shared bar."""
    g, npv, jloss, jgrads = _molecule_case(False)
    cfg = egnn_c.config()
    assert all(np.isfinite(v).all() for v in jgrads.values())
    loss, grads = _port_grads(cfg, convert.egnn_from_numpy(
        npv, cfg, device="cpu"), g)
    np.testing.assert_allclose(loss, jloss, rtol=1e-6)
    for k, got in grads.items():
        _close(got, jgrads[k], f"grad {k}")


def test_self_loop_grads_match_central_difference():
    """With self-loops: the port's gradient along a random direction v
    against a float64 central difference (L(p + εv) − L(p − εv)) / 2ε, ε
    = 1e-6: the float64 gradient within rel 1e-6, the float32 one within
    rel 1e-4 (float32 rounding over 4 layers)."""
    g, npv, _, _ = _molecule_case(True)
    cfg = egnn_c.config()
    p32 = convert.egnn_from_numpy(npv, cfg, device="cpu")
    g64, p64 = _float64(g, p32)
    rng = np.random.default_rng(7)
    v = tree.tree_map(lambda t: torch.from_numpy(
        rng.standard_normal(tuple(t.shape))), p64)

    def loss_at(s):
        p = tree.tree_map(lambda a, b: a + s * b, p64, v)
        with torch.no_grad():
            return float(egnn.loss_fn(p, cfg, g64)[0])

    eps = 1e-6
    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    for params, graph, rel in ((p64, g64, 1e-6), (p32, g, 1e-4)):
        _, grads = _port_grads(cfg, params, graph)
        dot = sum(float((grads[k].double() * b).sum())
                  for (k, _), b in zip(tree.flatten(params), tree.leaves(v)))
        assert abs(dot - fd) <= rel * abs(fd), (dot, fd)


def test_edge_len_forward_bit_equal_and_grad_zero_at_zero():
    """_edge_len(d2) equals torch.sqrt(d2) bit for bit (0 at 0); its
    gradient is sqrt's away from 0 and 0, not inf, at d2 = 0."""
    d2 = torch.tensor([[0.0], [1e-30], [0.25], [3.0], [0.0]],
                      requires_grad=True)
    got = egnn._edge_len(d2)
    assert torch.equal(got, torch.sqrt(d2.detach()))
    (grad,) = torch.autograd.grad(got.sum(), d2)
    want = 0.5 / torch.sqrt(d2.detach())
    assert grad[0, 0] == 0 and grad[4, 0] == 0
    torch.testing.assert_close(grad[1:4], want[1:4], rtol=0, atol=0)


# ------------------------------------------------- equivariance, chunks

def test_equivariance():
    """The reference's ``test_egnn_equivariance`` on the port: positions
    rotated by R, h is invariant and x rotates with them, within 1e-4."""
    cfg = egnn.EGNNConfig(d_in=8, d_hidden=16, n_layers=2,
                          task="node_class")
    g = gs.random_graph(100, 400, 8, seed=1, device="cpu")
    params = egnn.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    R = torch.from_numpy(je3._rand_rotations(np.random.default_rng(3),
                                             1)[0].astype(np.float32))
    h1, x1 = egnn.apply(params, cfg, g)
    h2, x2 = egnn.apply(params, cfg, dataclasses.replace(
        g, positions=g.positions @ R.T))
    assert float((h1 - h2).abs().max()) < 1e-4
    assert float((x1 @ R.T - x2).abs().max()) < 1e-4


@pytest.mark.parametrize("chunk", [1, 7, 100])
def test_edge_chunks_match_one_chunk(chunk, monkeypatch):
    """Messages formed and scattered a few edges at a time give what one
    chunk gives: h, x, the loss and every gradient leaf at the shared bar
    (not bit-equal: a product over fewer rows may round in another order
    on the CPU)."""
    cfg = dataclasses.replace(egnn_c.smoke_config(), task="node_class")
    _, g = _graphs("node_class")
    params = egnn.init(cfg, torch.Generator().manual_seed(1), device="cpu")

    def run():
        return egnn.apply(params, cfg, g), _port_grads(cfg, params, g)

    (wh, wx), (wl, wg) = run()
    monkeypatch.setattr(egnn, "EDGE_CHUNK", chunk)
    (h, x), (loss, grads) = run()
    _close(h, wh.numpy(), "h")
    _close(x, wx.numpy(), "x")
    np.testing.assert_allclose(loss, wl, rtol=1e-6)
    for k, got in grads.items():
        _close(got, wg[k].numpy(), k)


# ------------------------------------------------- configs, init, convert

def test_configs_match_reference():
    assert (egnn_c.ARCH, egnn_c.FAMILY, egnn_c.SHAPES, egnn_c.GEOMETRIC) \
        == (jegnn_c.ARCH, jegnn_c.FAMILY, jegnn_c.SHAPES, jegnn_c.GEOMETRIC)
    for fn in ("config", "smoke_config"):
        assert dataclasses.asdict(getattr(egnn_c, fn)()) == \
            dataclasses.asdict(getattr(jegnn_c, fn)())
    assert get_arch("egnn") is egnn_c


@pytest.mark.parametrize("task", TASKS)
def test_init_matches_reference_tree(task):
    """init at config() widths: the reference's keys and shapes; normal ×
    1/√fan_in."""
    cfg = dataclasses.replace(egnn_c.config(), task=task)
    jcfg = dataclasses.replace(jegnn_c.config(), task=task)
    params = egnn.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.eval_shape(lambda k: jegnn.init(k, jcfg)[0],
                            jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in tree.flatten(params)} == {
        k: tuple(v.shape) for k, v in tree.flatten(shapes)}
    w = params["layer_0"]["edge_mlp"]["w0"]
    assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1.0) < 0.05


def test_from_numpy_checks():
    cfg = dataclasses.replace(egnn_c.smoke_config(), task="node_class")
    npv = _jax_case("node_class")["values"]
    params = convert.egnn_from_numpy(npv, cfg, device="cpu")
    np.testing.assert_array_equal(
        params["layer_1"]["coord_mlp"]["w1"].numpy(),
        npv["layer_1"]["coord_mlp"]["w1"])
    with pytest.raises(ValueError, match="keys"):
        convert.egnn_from_numpy({k: v for k, v in npv.items()
                                 if k != "layer_1"}, cfg, device="cpu")
    bad = {k: dict(v) for k, v in npv.items()}
    bad["layer_0"] = dict(bad["layer_0"], node_mlp={
        "w0": npv["layer_0"]["node_mlp"]["w0"]})
    with pytest.raises(ValueError, match="keys"):
        convert.egnn_from_numpy(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.egnn_from_numpy(npv, dataclasses.replace(cfg, d_hidden=8),
                                device="cpu")


def test_smoke_is_finite():
    """get_arch("egnn").smoke on the CPU: one finite train step of the
    smoke configuration on the reference's smoke molecules."""
    metrics = get_arch("egnn").smoke(device="cpu")
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0


def test_entry_points_raise_without_cuda(monkeypatch):
    npv = _jax_case("node_class")["values"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(egnn_c.smoke_config(), task="node_class")
    with pytest.raises(RuntimeError, match="CUDA"):
        egnn.init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.egnn_from_numpy(npv, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        egnn_c.smoke()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_apply_matches_cpu(cuda, monkeypatch):
    """On the card: apply at config() widths on a 2,000-node graph with
    positions, in one chunk and in chunks of 1,000 edges, within rtol 1e-4
    atol 1e-5 × the block's largest of the CPU (the card's index_add_ adds
    in another order). TF32 off."""
    cfg = dataclasses.replace(egnn_c.config(), task="node_class")
    g = gs.random_graph(2000, 16000, 16, seed=4, device="cpu")
    params = egnn.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    want = egnn.apply(params, cfg, g)
    gc = dataclasses.replace(g, **{f: getattr(g, f).to(cuda) for f in (
        "node_feat", "positions", "edge_src", "edge_dst", "node_mask",
        "labels")})
    pc = tree.tree_map(lambda t: t.to(cuda), params)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for chunk in (egnn.EDGE_CHUNK, 1000):
            monkeypatch.setattr(egnn, "EDGE_CHUNK", chunk)
            for got, w in zip(egnn.apply(pc, cfg, gc), want):
                torch.testing.assert_close(
                    got.cpu(), w, rtol=1e-4,
                    atol=1e-5 * float(w.abs().max()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
