"""The GNNs sharded: gat-cora, EGNN, NequIP and MACE at their smoke
widths, each run for real on a (2, 2) mesh of 4 gloo ranks and held to the
unsharded port (loss and every gradient leaf, within
``test_torch_sharding``'s bar) on three graphs: ``random_graph(64, 256)``
(nodes and edges split over ``data``), ``molecule_batch(4, 12, 24)`` (the
``graph_reg`` task, its energies summed per graph over the ranks' rows),
and ``random_graph(63, 256)``, whose 63 nodes the data axis does not
divide, so the nodes stay replicated and the edges' partial sums are
all-reduced. Each forward gathers nothing edge-sized: one all-gather of a
node array per gathered array per layer. The dry run's fake (2, 2) train
step asks for the real step's collectives, kind by kind. A checkpoint
saved unsharded (gemma2-2b's and EGNN's smoke train states) comes back
onto the mesh as ``sharding.distribute`` lays it out, bit-equal, and one
train step from it equals the unsharded step.

Every case runs in float32, as the models do. The sharded sums (each
rank's edges added into its own buffer, then the buffers reduce-scattered
or all-reduced) round apart from the single buffer's, but these smoke
models are well enough conditioned that float32 meets the bar on every
leaf; unlike the MoE LMs (``test_torch_sharding_moe``), no float64 run is
needed to tell a layout's fault from rounding.
"""
import copy
import dataclasses
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import sharding
from repro_torch.configs import egnn, gat_cora, gemma2_2b, gnn_common
from repro_torch.configs import lm_common, mace, nequip
from repro_torch.data import graph_synth
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tf
from repro_torch.models.gnn import graph as G
from repro_torch.train import checkpoint, tree
from repro_torch.train import loop as train_loop
from test_torch_sharding import _close, _full

ARCHS = {"gat-cora": gat_cora, "egnn": egnn, "nequip": nequip,
         "mace": mace}
# The graphs: (task, nodes, edges); "odd"'s 63 nodes do not split in two.
GRAPHS = {"random": ("node_class", 64, 256),
          "molecule": ("graph_reg", 48, 96),
          "odd": ("node_class", 63, 256)}
D_IN, N_CLASSES = 8, 5
# Node arrays each layer gathers from: GAT e_src, e_dst, the softmax's
# denominator and hw; EGNN h and x; NequIP the positions and l = 0, 1, 2;
# MACE the positions and the scalars.
GATHERED = {"gat-cora": 4, "egnn": 2, "nequip": 4, "mace": 2}


def _graph(name: str) -> G.Graph:
    task, n, e = GRAPHS[name]
    if task == "graph_reg":
        return graph_synth.molecule_batch(4, 12, 24, d_feat=D_IN, seed=0,
                                          device="cpu")
    return graph_synth.random_graph(n, e, D_IN, n_classes=N_CLASSES,
                                    seed=0, device="cpu")


def _shape(name: str) -> dict:
    task, n, e = GRAPHS[name]
    sh = dict(n_nodes=n, n_edges=e, d_feat=D_IN, task=task)
    if task == "graph_reg":
        sh["n_graphs"] = 4
    else:
        sh["n_classes"] = N_CLASSES
    return sh


def _cfg(arch: str, graph: str):
    gnn_common.GNN_SHAPES[graph] = _shape(graph)
    return gnn_common.shape_config(ARCHS[arch].smoke_config(), graph)


def _inputs(arch, graph):
    cfg = _cfg(arch, graph)
    params = ARCHS[arch].model.init(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    return cfg, params, _graph(graph)


def _axes(arch, graph):
    return (ARCHS[arch].model.param_axes(_cfg(arch, graph)),
            gnn_common.graph_axes(_shape(graph), True))


def _sharded(params, g, axes, dmesh):
    p_axes, g_axes = axes
    return (sharding.distribute(params, p_axes, dmesh),
            G.Graph(**sharding.distribute(G.as_dict(g), g_axes, dmesh)))


def _loss_grads(mod, cfg, params, g):
    for p in tree.leaves(params):
        p.requires_grad_(True)
    loss, _, grads = train_loop.value_and_grad(
        lambda p, gg: mod.model.loss_fn(p, cfg, gg), params, g)
    return {"loss": _full(loss).numpy(),
            "grads": [_full(t).numpy() for t in tree.leaves(grads)]}


class _Gathers(torch.utils._python_dispatch.TorchDispatchMode):
    """The shape of each all-gather's output on the shards."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if dryrun._is_dtensor(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if dryrun._kind(func) == "all-gather":
            self.shapes.append(tuple(out.shape))
        return out


def _forward_gathers(mod, cfg, params, g):
    """The all-gathers a forward asks for, with the weights plain (whole
    on every rank, so that no weight is gathered)."""
    log = _Gathers()
    with log, torch.no_grad():
        mod.model.loss_fn(params, cfg, g)
    return log.shapes


def _cell_counts(arch, graph, dmesh):
    """The collectives of the dry run's train step, run for real."""
    mod = ARCHS[arch]
    cfg = _cfg(arch, graph)
    cell = gnn_common.make_cell(arch, mod.model, mod.smoke_config(), graph,
                                True)
    params = mod.model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    state = train_loop.make_train_state(params, gnn_common.TRAIN_CFG)
    state = sharding.distribute(state, cell.arg_axes[0], dmesh)
    for p in tree.leaves(state["params"]):
        p.requires_grad_(True)
    g = G.as_dict(_graph(graph))
    g = sharding.distribute(g, cell.arg_axes[1], dmesh)
    log = dryrun.CollectiveLog(dmesh)
    with log:
        cell.fn(state, g)
    return log.counts()


def _restore_case(name, dmesh, state, axes, step_fn, batch, sharded_batch):
    """Save ``state`` unsharded, restore it under the rules; placements,
    values, and a step from it against the unsharded step."""
    from torch.distributed.tensor import DTensor
    with tempfile.TemporaryDirectory(prefix=f"ckpt-{name}-") as d:
        checkpoint.save(d, 3, state, axes)
        want = sharding.distribute(copy.deepcopy(state), axes, dmesh)
        with sharding.use_rules(dmesh):
            got = checkpoint.restore(d, 3, state)
        plain = checkpoint.restore(d, 3, state)
    out = {"placements": [], "bits": [], "plain_bits": []}
    for (_, w), (_, r), (_, s), (_, p) in zip(
            tree.flatten(want), tree.flatten(got), tree.flatten(state),
            tree.flatten(plain), strict=True):
        out["placements"].append(isinstance(r, DTensor) and
                                 tuple(r.placements) == tuple(w.placements)
                                 and r.requires_grad == s.requires_grad)
        out["bits"].append(torch.equal(r.full_tensor(), s.detach()))
        out["plain_bits"].append(not isinstance(p, DTensor)
                                 and torch.equal(p, s.detach())
                                 and p.requires_grad == s.requires_grad)
    ref_state = copy.deepcopy(state)
    step_fn(ref_state, batch)
    with sharding.use_rules(dmesh):
        step_fn(got, sharded_batch)
    out["step"] = {"ref": [t.detach().numpy() for t in
                           tree.leaves(ref_state["params"])],
                   "got": [_full(t).detach().numpy() for t in
                           tree.leaves(got["params"])]}
    return out


def _restores(dmesh):
    from torch.distributed.tensor.experimental import implicit_replication
    out = {}
    # gemma2-2b's smoke train state and a (4, 32) batch.
    cfg = gemma2_2b.smoke_config()
    gen = torch.Generator().manual_seed(0)
    model = tf.init(cfg, gen, "cpu")
    toks = torch.randint(0, cfg.vocab, (4, 32), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    p_axes = tf.param_axes(model)
    state = train_loop.make_train_state(tf.param_tree(model),
                                        lm_common.TRAIN_CFG)
    axes = {"params": p_axes, "opt": {"m": p_axes, "v": p_axes,
                                      "step": ()}}
    step = train_loop.make_train_step(
        lambda p, b: tf.loss_fn(p, cfg, b["tokens"], b["labels"]),
        lm_common.TRAIN_CFG)
    sb = {k: sharding.distribute(v, ("batch", "seq"), dmesh)
          for k, v in batch.items()}
    with implicit_replication():
        out["gemma2-2b"] = _restore_case("lm", dmesh, state, axes, step,
                                         batch, sb)
    # EGNN's smoke train state on the molecule graph.
    cfg, params, g = _inputs("egnn", "molecule")
    state = train_loop.make_train_state(params, gnn_common.TRAIN_CFG)
    p_axes = egnn.model.param_axes(cfg)
    axes = {"params": p_axes, "opt": {"m": p_axes, "v": p_axes,
                                      "step": ()}}
    step = train_loop.make_train_step(
        lambda p, gg: egnn.model.loss_fn(p, cfg, gg), gnn_common.TRAIN_CFG)
    _, sg = _sharded(params, g, _axes("egnn", "molecule"), dmesh)
    with implicit_replication():
        out["egnn"] = _restore_case("egnn", dmesh, state, axes, step, g, sg)
    return out


def gloo_rank(mesh):
    """Every GNN on every graph, unsharded and sharded; each forward's
    all-gathers; the train step's collectives; the sharded restores."""
    from torch.distributed.tensor.experimental import implicit_replication
    dmesh = mesh_lib.make_device_mesh((2, 2), device_type="cpu")
    out = {}
    for arch, mod in ARCHS.items():
        for graph in GRAPHS:
            cfg, params, g = _inputs(arch, graph)
            ref = _loss_grads(mod, cfg, copy.deepcopy(params), g)
            with sharding.use_rules(dmesh), implicit_replication():
                sp, sg = _sharded(params, g, _axes(arch, graph), dmesh)
                got = _loss_grads(mod, cfg, sp, sg)
                gathers = _forward_gathers(mod, cfg, params, sg)
            out[arch, graph] = {"ref": ref, "got": got, "gathers": gathers}
        with sharding.use_rules(dmesh), implicit_replication():
            out[arch, "counts"] = _cell_counts(arch, "random", dmesh)
    out["restore"] = _restores(dmesh)
    return out


# Threads a rank: four ranks of many threads each on a few cores spend
# most of their time waiting on one another (the smoke ops are tiny).
RANK_THREADS = {"OMP_NUM_THREADS": "2", "OPENBLAS_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def gloo():
    saved = dict(gnn_common.GNN_SHAPES)
    env = {k: os.environ.get(k) for k in RANK_THREADS}
    os.environ.update(RANK_THREADS)
    try:
        return mesh_lib.spawn(gloo_rank, (2, 2), backend="gloo",
                              device="cpu")
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
        gnn_common.GNN_SHAPES.clear()
        gnn_common.GNN_SHAPES.update(saved)


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_loss_and_grads_equal_unsharded(gloo, arch, graph):
    """On every rank: rtol 1e-5, atol 1e-6 of each leaf's largest."""
    for rank in gloo:
        case = rank[arch, graph]
        _close(case["got"]["loss"], case["ref"]["loss"], "loss")
        _close(case["got"]["grads"], case["ref"]["grads"], "grads")
        assert np.isfinite(case["ref"]["loss"])


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_gathers_nodes_once_a_layer(gloo, arch, graph):
    """Every all-gather of the forward is a node array's (N rows; none of
    the E edges'), one a gathered array a layer; where the nodes are not
    split, none."""
    n = GRAPHS[graph][1]
    cfg = ARCHS[arch].smoke_config()
    want = 0 if n % 2 else cfg.n_layers * GATHERED[arch]
    for rank in gloo:
        shapes = rank[arch, graph]["gathers"]
        assert all(s[0] == n for s in shapes), shapes
        assert len(shapes) == want


@pytest.mark.parametrize("arch", list(ARCHS))
def test_fake_run_asks_for_the_real_runs_collectives(gloo, arch,
                                                     monkeypatch):
    """The dry run's fake (2, 2) train step of the same cell asks for the
    same collectives, kind by kind, as the real gloo step did."""
    monkeypatch.setitem(gnn_common.GNN_SHAPES, "random", _shape("random"))
    mod = ARCHS[arch]
    with dryrun.fake_world(4):
        mesh = mesh_lib.make_device_mesh((2, 2))
        with sharding.use_rules(mesh):
            cell = gnn_common.make_cell(arch, mod.model, mod.smoke_config(),
                                        "random", True)
            m = dryrun.measure(cell, mesh)
    fake = dict.fromkeys(gloo[0][arch, "counts"], 0)
    for kind, *_ in m["records"]:
        fake[kind] += 1
    assert fake == gloo[0][arch, "counts"]
    assert fake["all-gather"] > 0 and fake["reduce-scatter"] > 0
    assert all(r[arch, "counts"] == gloo[0][arch, "counts"] for r in gloo)


@pytest.mark.parametrize("arch", ["gemma2-2b", "egnn"])
def test_sharded_restore(gloo, arch):
    """Each restored leaf a DTensor placed as ``distribute`` places it,
    requiring grad where the saved leaf did, its full tensor bit-equal to
    the saved one; with no rules installed, the plain leaves as before;
    one step from the restore equal to the unsharded step."""
    for rank in gloo:
        r = rank["restore"][arch]
        assert all(r["placements"]) and all(r["bits"])
        assert all(r["plain_bits"])
        _close(r["step"]["got"], r["step"]["ref"], f"{arch} step")


def test_in_degree_and_primitives_run_on_fake_tensors():
    """``in_degree`` (an ``index_add_`` of ones, not ``bincount``) and the
    message-passing primitives run under ``FakeTensorMode``, and
    ``in_degree`` equals ``bincount``'s count on real tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    g = graph_synth.random_graph(40, 200, 4, seed=1, device="cpu")
    src = g.edge_src.clone()
    src[::7] = -1
    g = dataclasses.replace(g, edge_src=src)
    want = torch.bincount(torch.where(src >= 0, g.edge_dst.long(), 40),
                          minlength=41)[:40, None].float()
    assert torch.equal(G.in_degree(g, 40), want)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fg = G.Graph(**{f: None if v is None else mode.from_tensor(v)
                        for f, v in G.as_dict(g).items()})
        x = torch.empty((40, 3, 2))
        logits = torch.empty((200, 3))
        outs = [G.in_degree(fg, 40), G.gather_src(fg, x),
                G.gather_dst(fg, x), G.scatter_sum(fg, logits, 40),
                G.scatter_max(fg, logits, 40), G.scatter_mean(fg, logits, 40),
                G.edge_softmax(fg, logits, 40),
                G.task_loss(torch.empty((40, 7)), fg, "node_class")[0]]
    assert [tuple(o.shape) for o in outs] == [
        (40, 1), (200, 3, 2), (200, 3, 2), (40, 3), (40, 3), (40, 3),
        (200, 3), ()]


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
