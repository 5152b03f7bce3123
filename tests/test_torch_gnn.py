"""The port's GNN slice (graph data, message-passing primitives, GAT
inference) against the JAX package, on the CPU.

Graphs come from both packages' ``graph_synth`` with the same seed and
must be bit-equal; GAT weights come from the JAX package's ``gat.init``
and are carried across with ``convert.gat_from_numpy``. Tolerances: the
primitives within 1e-6, GAT outputs and the padded-layout aggregation
within rtol 1e-4 atol 1e-5 (the reference's bar for ``neigh_softmax_agg``).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import gat_cora as jgat_cora, gnn_common as jgnn_common
from repro.data import graph_synth as jgs
from repro.models.gnn import gat as jgat, graph as jG
from repro_torch import convert
from repro_torch.configs import gat_cora, gnn_common
from repro_torch.data import graph_synth as gs
from repro_torch.kernels import ops
from repro_torch.models.gnn import gat, graph as G, padded

# Small tensors: one intra-op thread per test worker keeps the workers of
# a parallel test run from spinning on each other's cores.
torch.set_num_threads(1)

FIELDS = ("node_feat", "positions", "edge_src", "edge_dst", "node_mask",
          "labels", "graph_ids")


def _assert_bit_equal(jg, g):
    for f in FIELDS:
        a, b = getattr(jg, f), getattr(g, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a = np.asarray(a)
            assert b.device.type == "cpu"
            assert b.numpy().dtype == a.dtype, f
            np.testing.assert_array_equal(b.numpy(), a, err_msg=f)


def _close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


# ------------------------------------------------------------- graph_synth

@pytest.mark.parametrize("power_law,geometric", [(True, True), (True, False),
                                                 (False, True)])
def test_random_graph_bit_equal(power_law, geometric):
    kw = dict(n_classes=5, seed=3, geometric=geometric, power_law=power_law)
    _assert_bit_equal(jgs.random_graph(300, 1200, 12, **kw),
                      gs.random_graph(300, 1200, 12, device="cpu", **kw))


def test_molecule_batch_bit_equal():
    _assert_bit_equal(jgs.molecule_batch(5, 12, 24, d_feat=8, seed=2),
                      gs.molecule_batch(5, 12, 24, d_feat=8, seed=2,
                                        device="cpu"))


@pytest.mark.parametrize("pad", [False, True])
def test_csr_sample_subgraph_bit_equal(pad):
    jc = jgs.CSRGraph.random(2000, 16000, 8, seed=4)
    c = gs.CSRGraph.random(2000, 16000, 8, seed=4)
    for f in ("src", "dst", "indptr", "feat", "labels", "pos"):
        np.testing.assert_array_equal(getattr(c, f), getattr(jc, f))
    kw = dict(n_pad=1024, e_pad=2048) if pad else {}
    seeds = np.arange(64)
    _assert_bit_equal(jc.sample_subgraph(seeds, (5, 3), seed=1, **kw),
                      c.sample_subgraph(seeds, (5, 3), seed=1, device="cpu",
                                        **kw))


# ------------------------------------------------------------- primitives

def _padded_graphs(n_nodes=40, n_pad=48, n_edges=150, e_pad=170, d=6,
                   seed=5):
    """Both packages' graph from the same arrays: padding edges (src -1,
    dst 0), padding nodes, and nodes 30.. with no in-edge."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, 30, n_edges).astype(np.int32)
    feat = rng.standard_normal((n_nodes, d)).astype(np.float32)
    labels = rng.integers(0, 3, n_pad).astype(np.int32)
    args = (src, dst, n_nodes, feat, None, labels)
    kw = dict(e_pad=e_pad, n_pad=n_pad)
    return (jgs._to_graph(*args, **kw),
            gs._to_graph(*args, device="cpu", **kw))


PRIMITIVES = ["edge_valid", "gather_src", "gather_dst", "scatter_sum",
              "scatter_max", "scatter_max_fill0", "scatter_mean",
              "edge_softmax", "radial_basis"]


@pytest.mark.parametrize("name", PRIMITIVES)
def test_primitives_match_jax(name):
    """Within 1e-6 of the reference on a graph with padding edges and
    nodes without in-edges, where the ghost row, the empty segments and
    gather_dst's mask on dst (a padding edge gathers node 0) all show."""
    jg, g = _padded_graphs()
    n = g.node_mask.shape[0]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    m = (rng.standard_normal((g.edge_src.shape[0], 3)) * 2).astype(
        np.float32)
    jx, jm, tx, tm = jnp.asarray(x), jnp.asarray(m), torch.from_numpy(x), \
        torch.from_numpy(m)
    if name == "edge_valid":
        np.testing.assert_array_equal(G.edge_valid(g).numpy(),
                                      np.asarray(jG.edge_valid(jg)))
        return
    if name in ("gather_src", "gather_dst"):
        got, want = getattr(G, name)(g, tx), getattr(jG, name)(jg, jx)
    elif name == "scatter_max_fill0":
        got = G.scatter_max(g, tm, n, fill=0.0)
        want = jG.scatter_max(jg, jm, n, fill=0.0)
    elif name == "radial_basis":
        r = np.abs(rng.standard_normal(50) * 3).astype(np.float32)
        got = G.radial_basis(torch.from_numpy(r), 8, 5.0)
        want = jG.radial_basis(jnp.asarray(r), 8, 5.0)
    else:
        got = getattr(G, name)(g, tm, n)
        want = getattr(jG, name)(jg, jm, n)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)
    if name == "gather_dst":     # padding edges gather node 0
        pad = g.edge_src < 0
        assert pad.any() and torch.equal(got[pad], tx[0].expand(
            int(pad.sum()), 3))
    if name == "scatter_max":    # empty segments give -inf (the fill)
        assert torch.isinf(got[30:]).all()


def test_edge_softmax_normalizes():
    g = gs.random_graph(50, 200, 4, seed=0, device="cpu")
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (200, 2)).astype(np.float32))
    alpha = G.edge_softmax(g, logits, 50)
    vals = G.scatter_sum(g, alpha, 50).numpy()
    nonzero = vals[vals > 1e-6]
    np.testing.assert_allclose(nonzero, 1.0, atol=1e-5)


# ---------------------------------------------------------------- GAT

def _jax_params(jcfg, seed=0):
    values, _ = jgat.init(jax.random.PRNGKey(seed), jcfg)
    return values, jax.tree_util.tree_map(np.asarray, values)


def _case(name):
    """(reference config, port config, reference graph, port graph)."""
    if name == "smoke":
        jcfg, cfg = jgat_cora.smoke_config(), gat_cora.smoke_config()
        gk = dict(n_nodes=64, n_edges=256, d_feat=8, n_classes=7, seed=0)
        return jcfg, cfg, jgs.random_graph(**gk), gs.random_graph(
            device="cpu", **gk)
    if name == "cora":
        sh = gnn_common.GNN_SHAPES["full_graph_sm"]
        jcfg = dataclasses.replace(jgat_cora.config(), d_in=sh["d_feat"],
                                   task=sh["task"],
                                   n_classes=sh["n_classes"])
        cfg = gnn_common.shape_config(gat_cora.config(), "full_graph_sm")
        gk = dict(n_nodes=sh["n_nodes"], n_edges=sh["n_edges"],
                  d_feat=sh["d_feat"], n_classes=sh["n_classes"], seed=0,
                  geometric=False)
        return jcfg, cfg, jgs.random_graph(**gk), gs.random_graph(
            device="cpu", **gk)
    jcfg = dataclasses.replace(jgat_cora.smoke_config(), task="graph_reg")
    cfg = dataclasses.replace(gat_cora.smoke_config(), task="graph_reg")
    gk = dict(batch=4, n_nodes=12, n_edges=24, d_feat=8, seed=0)
    return jcfg, cfg, jgs.molecule_batch(**gk), gs.molecule_batch(
        device="cpu", **gk)


@pytest.mark.parametrize("name", ["smoke", "cora", "graph_reg"])
def test_gat_apply_matches_jax(name):
    """apply within rtol 1e-4 atol 1e-5 of the reference; the argmax equal
    wherever the top-2 margin exceeds 1e-4. "cora" is gat-cora at full
    width on the full_graph_sm shape (2,708 nodes, 10,556 edges, 1,433
    features, 7 classes): the slice as a whole."""
    jcfg, cfg, jg, g = _case(name)
    values, npv = _jax_params(jcfg)
    want = np.asarray(jgat.apply(values, jcfg, jg))
    got = gat.apply(convert.gat_from_numpy(npv, cfg, device="cpu"), cfg, g)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    if cfg.task == "node_class":
        top2 = np.sort(want, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-4
        assert clear.sum() > 0.9 * len(clear)
        np.testing.assert_array_equal(got.numpy().argmax(1)[clear],
                                      want.argmax(1)[clear])


@pytest.mark.parametrize("name", ["smoke", "graph_reg"])
def test_gat_loss_and_grads_match_jax(name):
    """gat.loss_fn (node_class on the smoke graph, graph_reg on molecules)
    and its gradients against jax.value_and_grad on the reference's own
    weights: loss rtol 1e-5, gradients rtol 1e-5 atol 1e-7 + 1e-6 of the
    leaf's largest (sums over edges and nodes run in another order). The
    loss goes through the differentiable forward, the edge chunks and
    the segment max included, and equals ``apply``'s numbers."""
    from repro_torch.train import loop as train_loop, tree
    jcfg, cfg, jg, g = _case(name)
    values, npv = _jax_params(jcfg, seed=2)
    (jl, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jgat.loss_fn(p, jcfg, jg), has_aux=True))(values)
    params = convert.gat_from_numpy(npv, cfg, device="cpu")
    for p in tree.leaves(params):
        p.requires_grad_(True)
    loss, metrics, grads = train_loop.value_and_grad(
        lambda p, gg: gat.loss_fn(p, cfg, gg), params, g)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert float(metrics["loss"]) == float(loss)
    for (leaf, got), want in zip(tree.flatten(grads),
                                 jax.tree_util.tree_leaves(jgrads)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-7 + 1e-6 * np.abs(want).max(),
                                   err_msg=leaf)
    with torch.no_grad():
        torch.testing.assert_close(gat.forward(params, cfg, g),
                                   gat.apply(params, cfg, g), rtol=0, atol=0)


@pytest.mark.parametrize("task", ["node_class", "graph_reg"])
def test_smoke_run_takes_a_finite_step(task):
    """gnn_common.smoke_run (and gat_cora.smoke): one train step on the
    reference's tiny graphs; the loss is finite and the step counted."""
    cfg = dataclasses.replace(gat_cora.smoke_config(), task=task)
    m = gnn_common.smoke_run(gat, cfg, gat_cora.GEOMETRIC, device="cpu")
    assert set(m) == {"loss", "grad_norm", "lr"}
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    if task == "node_class":
        assert float(gat_cora.smoke(device="cpu")["loss"]) == float(
            m["loss"])
    assert gnn_common.TRAIN_CFG.opt.lr == jgnn_common.TRAIN_CFG.opt.lr


@pytest.mark.parametrize("chunk", [1, 7, 100])
def test_edge_chunks_match_one_chunk(chunk, monkeypatch):
    """Messages formed and scattered a few edges at a time give what the
    default EDGE_CHUNK (one chunk here) gives (the CPU adds in the same
    order: bit-equal)."""
    _, cfg, _, g = _case("smoke")
    params = gat.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    want = gat.apply(params, cfg, g)
    monkeypatch.setattr(gat, "EDGE_CHUNK", chunk)
    torch.testing.assert_close(gat.apply(params, cfg, g), want, rtol=0,
                               atol=0)


def _jax_layer_agg(lp, jcfg, jg, h, n):
    """The reference layer's segment-op aggregation, before ELU and the
    head mean: Σ over incoming edges of edge_softmax · hw[src]."""
    hw = jnp.einsum("nf,fhd->nhd", h, lp["w"])
    e_src = jnp.einsum("nhd,hd->nh", hw, lp["a_src"])
    e_dst = jnp.einsum("nhd,hd->nh", hw, lp["a_dst"])
    logits = jax.nn.leaky_relu(jG.gather_src(jg, e_src)
                               + jG.gather_dst(jg, e_dst),
                               jcfg.negative_slope)
    alpha = jG.edge_softmax(jg, logits, n)
    return jG.scatter_sum(jg, alpha[..., None] * jG.gather_src(jg, hw), n)


def test_padded_layout_aggregation_matches_jax_layer():
    """Per layer of the smoke GAT, on a graph with padding edges and nodes
    without in-edges: the plain neigh_softmax_agg over the padded-degree
    layout (rows = node × head) equals the reference layer's
    segment aggregation within rtol 1e-4 atol 1e-5."""
    jg, g = _padded_graphs(d=8)
    jcfg, cfg = jgat_cora.smoke_config(), gat_cora.smoke_config()
    values, npv = _jax_params(jcfg, seed=2)
    params = convert.gat_from_numpy(npv, cfg, device="cpu")
    n = g.node_mask.shape[0]
    slots = padded.padded_layout(g, n)
    assert slots.shape[1] == int(torch.bincount(
        g.edge_dst[g.edge_src >= 0].long()).max())
    h = np.array(jg.node_feat)
    for i in range(cfg.n_layers):
        want = _jax_layer_agg(values[f"layer_{i}"], jcfg, jg,
                              jnp.asarray(h), n)
        hw, logits = gat.layer_logits(params[f"layer_{i}"], cfg, g,
                                      torch.from_numpy(h))
        lg, ft, mk = padded.agg_rows(g, slots, logits, hw, 0, n)
        got = ops.neigh_softmax_agg(lg, ft, mk).reshape(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
        assert torch.equal(got[30:], torch.zeros_like(got[30:]))
        h = np.array(jax.nn.elu(want.reshape(n, -1)))


# ------------------------------------------------- configs, init, convert

def test_configs_match_reference():
    assert gnn_common.GNN_SHAPES == jgnn_common.GNN_SHAPES
    assert (gat_cora.ARCH, gat_cora.FAMILY, gat_cora.SHAPES,
            gat_cora.GEOMETRIC) == (jgat_cora.ARCH, jgat_cora.FAMILY,
                                    jgat_cora.SHAPES, jgat_cora.GEOMETRIC)
    for fn in ("config", "smoke_config"):
        assert dataclasses.asdict(getattr(gat_cora, fn)()) == \
            dataclasses.asdict(getattr(jgat_cora, fn)())
    for shape, sh in gnn_common.GNN_SHAPES.items():
        cfg = gnn_common.shape_config(gat_cora.config(), shape)
        assert (cfg.d_in, cfg.task, cfg.n_classes) == (
            sh["d_feat"], sh["task"], sh.get("n_classes", 1))


@pytest.mark.parametrize("task", ["node_class", "graph_reg"])
def test_init_matches_reference_tree(task):
    """The reference's keys and shapes; normal × 1/√shape[0]."""
    cfg = dataclasses.replace(gat_cora.config(), task=task)
    jcfg = dataclasses.replace(jgat_cora.config(), task=task)
    params = gat.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, npv = _jax_params(jcfg)
    assert set(params) == set(npv)
    for name, layer in npv.items():
        assert set(params[name]) == set(layer)
        for k, a in layer.items():
            assert tuple(params[name][k].shape) == a.shape
    w = params["layer_0"]["w"]
    assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1.0) < 0.05


def test_gat_from_numpy_checks():
    cfg, jcfg = gat_cora.smoke_config(), jgat_cora.smoke_config()
    _, npv = _jax_params(jcfg)
    params = convert.gat_from_numpy(npv, cfg, device="cpu")
    np.testing.assert_array_equal(params["layer_1"]["a_src"].numpy(),
                                  npv["layer_1"]["a_src"])
    with pytest.raises(ValueError, match="keys"):
        convert.gat_from_numpy({"layer_0": npv["layer_0"]}, cfg,
                               device="cpu")
    bad = {k: dict(v) for k, v in npv.items()}
    del bad["layer_0"]["a_dst"]
    with pytest.raises(ValueError, match="keys"):
        convert.gat_from_numpy(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.gat_from_numpy(npv, dataclasses.replace(cfg, d_in=9),
                               device="cpu")


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gat_cora.smoke_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        gat.init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        gs.random_graph(10, 20, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.gat_from_numpy(_jax_params(jgat_cora.smoke_config())[1],
                               cfg)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_gat_apply_matches_cpu(cuda, monkeypatch):
    """On the card: gat-cora at the Cora shape, in one chunk and in chunks
    of 1000 edges, within rtol 1e-4 atol 1e-5 of the CPU (the card's
    index_add_ adds in another order); the kernel over the padded layout
    against the layer's segment aggregation on the card."""
    _, cfg, _, g = _case("cora")
    params = gat.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    want = gat.apply(params, cfg, g)
    gc = dataclasses.replace(g, **{f: getattr(g, f).to(cuda) for f in (
        "node_feat", "edge_src", "edge_dst", "node_mask", "labels")})
    pc = {k: {n: t.to(cuda) for n, t in v.items()} for k, v in params.items()}
    for chunk in (gat.EDGE_CHUNK, 1000):
        monkeypatch.setattr(gat, "EDGE_CHUNK", chunk)
        torch.testing.assert_close(gat.apply(pc, cfg, gc).cpu(), want,
                                   rtol=1e-4, atol=1e-5)
    n = g.node_mask.shape[0]
    slots = padded.padded_layout(gc, n)
    hw, logits = gat.layer_logits(pc["layer_0"], cfg, gc, gc.node_feat)
    agg = gat.aggregate(gc, G.edge_softmax(gc, logits, n), hw, n)
    got = ops.neigh_softmax_agg(*padded.agg_rows(gc, slots, logits, hw, 0,
                                                 n))
    torch.testing.assert_close(got, agg.reshape(got.shape), rtol=1e-4,
                               atol=1e-5)
