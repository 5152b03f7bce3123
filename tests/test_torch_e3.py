"""The port's irrep algebra (``models/gnn/e3.py``), NequIP and MACE against
the JAX package, on the CPU.

Graphs come from both packages' ``graph_synth`` with the same seed
(bit-equal, ``tests/test_torch_gnn.py``); weights from the reference's
``init``, carried across by ``convert.nequip_from_numpy`` and
``convert.mace_from_numpy``. The JAX side is jitted once a case and
cached for the file.

The bar, unless a test's docstring says otherwise: rtol 1e-5 and atol
1e-6 × the block's largest |value| (each l block of the features, the
loss, each gradient leaf, each leaf of the train state). The port
contracts the reference's three-operand einsums in its own fixed order,
so sums round differently: on these inputs outputs lie within 4e-7 and
gradients within 2.5e-6 of the largest |value| (the elements that far off
are large enough for the rtol to hold them). The CG and Wigner tensors are
bit-equal: both packages run the same numpy code on the same machine.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import gnn_common as jgnn_common
from repro.configs import mace as jmace_c, nequip as jnequip_c
from repro.data import graph_synth as jgs
from repro.models.gnn import e3 as je3, mace as jmace, nequip as jnequip
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import get_arch, gnn_common
from repro_torch.configs import mace as mace_c, nequip as nequip_c
from repro_torch.data import graph_synth as gs
from repro_torch.models.gnn import e3, mace, nequip
from repro_torch.models.gnn import graph as G
from repro_torch.train import loop as train_loop, tree

# Small tensors: one intra-op thread per test worker keeps the workers of
# a parallel test run from spinning on each other's cores.
torch.set_num_threads(1)

RTOL, ATOL_OF_MAX = 1e-5, 1e-6

MODELS = {
    "nequip": (jnequip, jnequip_c, nequip, nequip_c,
               convert.nequip_from_numpy),
    "mace": (jmace, jmace_c, mace, mace_c, convert.mace_from_numpy),
}
CASES = [(m, t) for m in MODELS for t in ("node_class", "graph_reg")]


def _close(got, want, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, what
    np.testing.assert_allclose(
        got, want, rtol=RTOL,
        atol=ATOL_OF_MAX * max(float(np.abs(want).max(initial=0.0)), 1e-30),
        err_msg=what)


# ------------------------------------------------------------------- e3

@pytest.mark.parametrize("l", [0, 1, 2, 3])
def test_sh_matches_reference(l):
    """sh(l, ·) on 500 random unit vectors: on float32 tensors within rtol
    1e-6 atol 1e-6 of the reference's jnp path; on float64 numpy arrays
    bit-equal to its numpy path."""
    n = np.random.default_rng(l).standard_normal((500, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    got = e3.sh(l, torch.from_numpy(n.astype(np.float32)))
    want = je3.sh(l, jnp.asarray(n, jnp.float32))
    assert got.dtype == torch.float32 and got.shape == (500, e3.dim(l))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(e3.sh(l, n), je3.sh(l, n))


def test_wigner_and_cg_bit_equal():
    """Every (l1, l2, l3) with l ≤ 3: cg bit-equal to the reference's, or
    None where its is; wigner bit-equal at three random rotations."""
    n_cg = 0
    for l1 in range(4):
        for l2 in range(4):
            for l3 in range(4):
                want, got = je3.cg(l1, l2, l3), e3.cg(l1, l2, l3)
                assert (got is None) == (want is None), (l1, l2, l3)
                if want is not None:
                    n_cg += 1
                    assert got.dtype == np.float64
                    np.testing.assert_array_equal(got, want)
    assert n_cg == len(je3.paths(3))
    for R in e3._rand_rotations(np.random.default_rng(5), 3):
        for l in range(4):
            np.testing.assert_array_equal(e3.wigner(R, l), je3.wigner(R, l))


@pytest.mark.parametrize("l_max", [1, 2, 3])
def test_paths_equal(l_max):
    assert e3.paths(l_max) == je3.paths(l_max)
    if l_max == 2:
        assert len(e3.paths(2)) == 15


def test_cg_tensors_equivariant():
    """The port's own check (the reference's
    ``test_cg_tensors_equivariant``, over l ≤ 3): C[(D1 u) ⊗ (D2 v)] =
    D3 C[u ⊗ v] within 1e-9."""
    rng = np.random.default_rng(0)
    R = e3._rand_rotations(rng, 1)[0]
    for (l1, l2, l3) in e3.paths(3):
        C = e3.cg(l1, l2, l3)
        D1, D2, D3 = (e3.wigner(R, l) for l in (l1, l2, l3))
        u = rng.standard_normal(e3.dim(l1))
        v = rng.standard_normal(e3.dim(l2))
        lhs = np.einsum("abc,a,b->c", C, D1 @ u, D2 @ v)
        rhs = D3 @ np.einsum("abc,a,b->c", C, u, v)
        assert np.abs(lhs - rhs).max() < 1e-9, (l1, l2, l3)


def test_cg_torch_is_cached_per_device_and_dtype():
    """cg_torch: float32 by default, equal to cg rounded to float32 (the
    reference's cg_jnp), one tensor per (device, dtype); None where cg is
    None."""
    c = e3.cg_torch(1, 1, 2, "cpu")
    assert c.dtype == torch.float32
    np.testing.assert_array_equal(c.numpy(),
                                  np.asarray(je3.cg_jnp(1, 1, 2)))
    assert e3.cg_torch(1, 1, 2, torch.device("cpu")) is c
    c64 = e3.cg_torch(1, 1, 2, "cpu", torch.float64)
    np.testing.assert_array_equal(c64.numpy(), e3.cg(1, 1, 2))
    assert e3.cg_torch(0, 1, 2, "cpu") is None


def test_edge_basis_masks_zero_length_edges():
    """A self-loop's harmonics are 0 for every l (its l = 0 one too); its
    radial basis is that of r = 1e-6."""
    g = gs.molecule_batch(4, 12, 24, d_feat=8, seed=0, device="cpu")
    loops = (g.edge_src == g.edge_dst) & (g.edge_src >= 0)
    assert loops.any()
    rbf, sh_edges = e3.edge_basis(g, 2, 8, 5.0)
    for l, y in enumerate(sh_edges):
        assert y.shape == (g.edge_src.shape[0], e3.dim(l))
        assert torch.equal(y[loops], torch.zeros_like(y[loops]))
        assert (y[~loops].abs().sum(1) > 0).all()
    torch.testing.assert_close(
        rbf[loops], G.radial_basis(torch.full((int(loops.sum()),), 1e-6),
                                   8, 5.0), rtol=0, atol=0)


def test_positions_draw_changes_no_other_field():
    """random_graph draws positions last: with geometric=True every other
    field is bit-equal to the graph without positions (so chip_smoke.py
    draws the ogb_products graph once, with positions, for GAT and the
    equivariant GNNs)."""
    kw = dict(n_classes=5, seed=3)
    with_pos = gs.random_graph(300, 1200, 12, geometric=True, device="cpu",
                               **kw)
    without = gs.random_graph(300, 1200, 12, geometric=False, device="cpu",
                              **kw)
    assert without.positions is None and with_pos.positions.shape == (300, 3)
    for f in ("node_feat", "edge_src", "edge_dst", "node_mask", "labels"):
        assert torch.equal(getattr(with_pos, f), getattr(without, f)), f


# -------------------------------------------------------- NequIP and MACE

def _graphs(task):
    """(reference graph, port graph): the reference test's node_class
    graph or its smoke molecules."""
    if task == "node_class":
        gk = dict(n_nodes=80, n_edges=320, d_feat=8, seed=2)
        return jgs.random_graph(**gk), gs.random_graph(device="cpu", **gk)
    gk = dict(batch=4, n_nodes=12, n_edges=24, d_feat=8)
    return jgs.molecule_batch(**gk), gs.molecule_batch(device="cpu", **gk)


def _outputs(name, out):
    """Named blocks of an ``apply`` result: each l of the features, and
    MACE's node energies."""
    feats, energy = (out, None) if name == "nequip" else out
    blocks = {f"l={l}": feats[l] for l in sorted(feats)}
    if energy is not None:
        blocks["node_energy"] = energy
    return blocks


@functools.lru_cache(maxsize=None)
def _jax_case(name, task):
    """The reference's config, graph, weights (as numpy), apply outputs,
    loss, gradients and its state after one TRAIN_CFG step, jitted."""
    jm, jc, _, _, _ = MODELS[name]
    jcfg = dataclasses.replace(jc.smoke_config(), task=task)
    jg, _ = _graphs(task)
    values, _ = jm.init(jax.random.PRNGKey(1), jcfg)
    out = jax.jit(lambda v, g: jm.apply(v, jcfg, g))(values, jg)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda v, g: jm.loss_fn(v, jcfg, g), has_aux=True))(values, jg)
    tc = jgnn_common.TRAIN_CFG
    state = jloop.make_train_state(values, tc)
    step = jax.jit(jloop.make_train_step(
        lambda v, g: jm.loss_fn(v, jcfg, g), tc))
    after, metrics = step(state, jg)
    host = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(values=host(values), out=_outputs(name, host(out)),
                loss=float(loss), grads=host(grads), state=host(state),
                after=host(after), metrics={k: float(v) for k, v in
                                            metrics.items()})


def _port_case(name, task):
    _, _, m, c, conv = MODELS[name]
    cfg = dataclasses.replace(c.smoke_config(), task=task)
    _, g = _graphs(task)
    ref = _jax_case(name, task)
    return m, cfg, g, conv(ref["values"], cfg, device="cpu"), ref


@pytest.mark.parametrize("name,task", CASES)
def test_apply_matches_jax(name, task):
    """apply at the smoke config: every l block of the features (and
    MACE's node energies) at the shared bar."""
    m, cfg, g, params, ref = _port_case(name, task)
    got = _outputs(name, m.apply(params, cfg, g))
    assert set(got) == set(ref["out"])
    for k, want in ref["out"].items():
        _close(got[k], want, f"{name} {task} {k}")


@pytest.mark.parametrize("name,task", CASES)
def test_loss_and_grads_match_jax(name, task):
    """loss_fn and every gradient leaf against jax.value_and_grad at the
    shared bar; the loss also rtol 1e-6."""
    m, cfg, g, params, ref = _port_case(name, task)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    loss, metrics, grads = train_loop.value_and_grad(
        lambda p, gg: m.loss_fn(p, cfg, gg), params, g)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-6)
    assert float(metrics["loss"]) == float(loss)
    want = dict(tree.flatten(ref["grads"]))
    assert [k for k, _ in tree.flatten(grads)] == list(want)
    for k, got in tree.flatten(grads):
        _close(got, want[k], f"{name} {task} grad {k}")


@pytest.mark.parametrize("name,task", CASES)
def test_train_step_matches_jax(name, task):
    """One TRAIN_CFG step from JAX's initial state, carried over by
    convert.train_state_from_numpy, against JAX's jitted step: the loss,
    grad_norm and every leaf of params, m and v at the shared bar."""
    m, cfg, g, _, ref = _port_case(name, task)
    state = convert.train_state_from_numpy(ref["state"], cfg, device="cpu")
    step = train_loop.make_train_step(
        lambda p, gg: m.loss_fn(p, cfg, gg), gnn_common.TRAIN_CFG)
    state, metrics = step(state, g)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), ref["metrics"][k],
                                   rtol=1e-5, err_msg=k)
    assert int(state["opt"]["step"]) == int(ref["after"]["opt"]["step"])
    for part, got_tree, want_tree in (
            ("params", state["params"], ref["after"]["params"]),
            ("m", state["opt"]["m"], ref["after"]["opt"]["m"]),
            ("v", state["opt"]["v"], ref["after"]["opt"]["v"])):
        want = dict(tree.flatten(want_tree))
        for k, got in tree.flatten(got_tree):
            _close(got, want[k], f"{name} {task} {part} {k}")


def _rotated(g, R):
    return dataclasses.replace(
        g, positions=g.positions @ torch.from_numpy(R.T.astype(np.float32)))


@pytest.mark.parametrize("name", list(MODELS))
def test_equivariance(name):
    """The reference's ``test_e3_equivariance`` on the port: positions
    rotated by R, each l block of the features equals D_l(R) times the
    unrotated one, rel < 1e-4 of the block's largest; MACE's node energies
    are invariant at the same bar."""
    _, _, m, c, _ = MODELS[name]
    cfg = dataclasses.replace(c.smoke_config(), d_in=8, task="node_class")
    g = gs.random_graph(80, 320, 8, seed=2, device="cpu")
    params = m.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    R = e3._rand_rotations(np.random.default_rng(3), 1)[0]
    f1 = _outputs(name, m.apply(params, cfg, g))
    f2 = _outputs(name, m.apply(params, cfg, _rotated(g, R)))
    for l in range(cfg.l_max + 1):
        D = torch.from_numpy(e3.wigner(R, l).astype(np.float32))
        a, b = f1[f"l={l}"], f2[f"l={l}"]
        err = (torch.einsum("ncj,ij->nci", a, D) - b).abs().max()
        rel = float(err / (a.abs().max() + 1e-9))
        assert rel < 1e-4, f"l={l} rel err {rel}"
    if name == "mace":
        a, b = f1["node_energy"], f2["node_energy"]
        assert float((a - b).abs().max() / a.abs().max()) < 1e-4


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("chunk", [1, 7, 100])
def test_edge_chunks_match_one_chunk(name, chunk, monkeypatch):
    """Messages formed and scattered a few edges at a time, and MACE's
    B-basis a few nodes at a time, give what one chunk gives: apply, the
    loss and every gradient leaf at the shared bar (not bit-equal: a
    product over fewer rows may round in another order on the CPU)."""
    _, _, m, c, _ = MODELS[name]
    cfg = dataclasses.replace(c.smoke_config(), task="node_class")
    _, g = _graphs("node_class")
    params = m.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    for p in tree.leaves(params):
        p.requires_grad_(True)

    def run():
        out = _outputs(name, m.apply(params, cfg, g))
        return out, train_loop.value_and_grad(
            lambda p, gg: m.loss_fn(p, cfg, gg), params, g)

    want, (wl, _, wg) = run()
    monkeypatch.setattr(m, "EDGE_CHUNK", chunk)
    if name == "mace":
        monkeypatch.setattr(m, "NODE_CHUNK", chunk)
    got, (gl, _, gg_) = run()
    for k in want:
        _close(got[k], want[k].numpy(), k)
    _close(gl, wl.numpy(), "loss")
    for (k, a), b in zip(tree.flatten(gg_), tree.leaves(wg)):
        _close(a, b.numpy(), k)


# ------------------------------------------------- configs, init, convert

@pytest.mark.parametrize("name", list(MODELS))
def test_configs_match_reference(name):
    _, jc, _, c, _ = MODELS[name]
    assert (c.ARCH, c.FAMILY, c.SHAPES, c.GEOMETRIC) == (
        jc.ARCH, jc.FAMILY, jc.SHAPES, jc.GEOMETRIC)
    for fn in ("config", "smoke_config"):
        assert dataclasses.asdict(getattr(c, fn)()) == \
            dataclasses.asdict(getattr(jc, fn)())
    assert get_arch(name) is c


@pytest.mark.parametrize("name,task", CASES)
def test_init_matches_reference_tree(name, task):
    """init at config() widths: the reference's keys and shapes; normal ×
    the reference's scale (1/√fan_in, or the leaf's own)."""
    jm, jc, m, c, _ = MODELS[name]
    cfg = dataclasses.replace(c.config(), task=task)
    jcfg = dataclasses.replace(jc.config(), task=task)
    params = m.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.eval_shape(lambda k: jm.init(k, jcfg)[0],
                            jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in tree.flatten(shapes)}
    assert {k: tuple(v.shape) for k, v in tree.flatten(params)} == want
    lay = params["layer_0"]
    C = cfg.d_hidden
    checks = [(lay["rad_w1"], 1 / np.sqrt(32)), (lay["self_1"] if name ==
              "nequip" else lay["msg_1"], 1 / np.sqrt(C))]
    if name == "mace":
        checks += [(lay["b2_w"], 0.3), (lay["b3_w"], 0.1)]
    for w, scale in checks:
        assert abs(float(w.std()) / scale - 1.0) < 0.1


@pytest.mark.parametrize("name", list(MODELS))
def test_from_numpy_checks(name):
    _, _, m, c, conv = MODELS[name]
    cfg = dataclasses.replace(c.smoke_config(), task="node_class")
    npv = _jax_case(name, "node_class")["values"]
    params = conv(npv, cfg, device="cpu")
    np.testing.assert_array_equal(params["layer_1"]["rad_w0"].numpy(),
                                  npv["layer_1"]["rad_w0"])
    with pytest.raises(ValueError, match="keys"):
        conv({k: v for k, v in npv.items() if k != "head1"}, cfg,
             device="cpu")
    bad = {k: dict(v) if isinstance(v, dict) else v for k, v in npv.items()}
    del bad["layer_0"]["rad_w1"]
    with pytest.raises(ValueError, match="keys"):
        conv(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        conv(npv, dataclasses.replace(cfg, d_in=9), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        conv(npv, dataclasses.replace(cfg, task="graph_reg"), device="cpu")


@pytest.mark.parametrize("name", list(MODELS))
def test_smoke_is_finite(name):
    """get_arch(name).smoke on the CPU: one finite train step of the smoke
    configuration on the reference's smoke molecules."""
    metrics = get_arch(name).smoke(device="cpu")
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0


@pytest.mark.parametrize("name", list(MODELS))
def test_entry_points_raise_without_cuda(name, monkeypatch):
    _, _, m, c, conv = MODELS[name]
    npv = _jax_case(name, "node_class")["values"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(c.smoke_config(), task="node_class")
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        conv(npv, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        c.smoke()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(MODELS))
def test_cuda_apply_matches_cpu(name, cuda, monkeypatch):
    """On the card: apply at config() widths on a 2,000-node graph with
    positions, in one chunk and in chunks of 1,000 edges (and MACE's
    B-basis 300 nodes at a time), within rtol 1e-4 atol 1e-5 × the
    block's largest of the CPU (the card's index_add_ adds in another
    order). TF32 off."""
    _, _, m, c, _ = MODELS[name]
    cfg = gnn_common.shape_config(c.config(), "full_graph_sm")
    cfg = dataclasses.replace(cfg, d_in=16)
    g = gs.random_graph(2000, 16000, 16, n_classes=cfg.n_classes, seed=4,
                        device="cpu")
    params = m.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    want = _outputs(name, m.apply(params, cfg, g))
    gc = dataclasses.replace(g, **{f: getattr(g, f).to(cuda) for f in (
        "node_feat", "positions", "edge_src", "edge_dst", "node_mask",
        "labels")})
    pc = tree.tree_map(lambda t: t.to(cuda), params)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for chunk in (m.EDGE_CHUNK, 1000):
            monkeypatch.setattr(m, "EDGE_CHUNK", chunk)
            if name == "mace":
                monkeypatch.setattr(m, "NODE_CHUNK", 300 if chunk == 1000
                                    else mace.NODE_CHUNK)
            got = _outputs(name, m.apply(pc, cfg, gc))
            for k, w in want.items():
                torch.testing.assert_close(
                    got[k].cpu(), w, rtol=1e-4,
                    atol=1e-5 * float(w.abs().max()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
