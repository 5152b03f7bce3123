"""Shapes shared by the GNN architectures (counterpart of
``repro.configs.gnn_common``): full_graph_sm (cora-scale full batch),
minibatch_lg (reddit-scale sampled subgraph, the padded output of the
fanout-15-10 neighbour sampler), ogb_products (ogbn-products-scale full
batch: Hu et al., arXiv:2005.00687) and molecule (128 batched 30-node
graphs), the training configuration ``TRAIN_CFG``, a graph's fields as meta
tensors and their logical axes (``graph_specs``, ``graph_axes``),
``make_cell`` (the dry run's cell: one train step over a graph of a shape)
and ``smoke_run`` (one train step on a tiny random graph).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import torch

from repro_torch.configs import base
from repro_torch.core.types import resolve_device
from repro_torch.models.gnn import graph as G
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt_lib

# minibatch_lg padded sizes: 1024 seeds × fanout (15, 10) ⇒
# ≤ 1024·(1+15+150) nodes, ≤ 1024·(15+150) edges.
GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                          task="node_class", n_classes=7),
    "minibatch_lg": dict(n_nodes=169_984, n_edges=168_960, d_feat=602,
                         task="node_class", n_classes=41),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                         task="node_class", n_classes=47),
    "molecule": dict(n_nodes=30 * 128, n_edges=64 * 128, d_feat=16,
                     task="graph_reg", n_graphs=128),
}


TRAIN_CFG = train_loop.TrainConfig(opt=opt_lib.AdamWConfig(lr=1e-3))


def shape_config(cfg, shape_name: str):
    """``cfg`` with the input width, task and classes of a shape (what the
    reference's ``make_cell`` does before it builds the train step)."""
    sh = GNN_SHAPES[shape_name]
    return dataclasses.replace(cfg, d_in=sh["d_feat"], task=sh["task"],
                               n_classes=sh.get("n_classes", 1))


def graph_specs(shape: dict, geometric: bool) -> dict:
    """The fields of a graph of ``shape`` (a ``GNN_SHAPES`` entry) as meta
    tensors, by field name (None for an absent field): the reference's
    dtypes, labels int32 or f32 targets for ``graph_reg``."""
    N, E = shape["n_nodes"], shape["n_edges"]
    graph_reg = shape["task"] == "graph_reg"
    return {
        "node_feat": base.spec((N, shape["d_feat"])),
        "positions": base.spec((N, 3)) if geometric else None,
        "edge_src": base.spec((E,), "int32"),
        "edge_dst": base.spec((E,), "int32"),
        "node_mask": base.spec((N,), torch.bool),
        "labels": base.spec((shape.get("n_graphs", N),),
                            "float32" if graph_reg else "int32"),
        "graph_ids": base.spec((N,), "int32") if graph_reg else None,
    }


def graph_axes(shape: dict, geometric: bool) -> dict:
    """The logical axes of each field of ``graph_specs``, the reference's:
    nodes over ``graph_nodes``, edges over ``graph_edges``, labels
    replicated."""
    graph_reg = shape["task"] == "graph_reg"
    return {
        "node_feat": ("graph_nodes", None),
        "positions": ("graph_nodes", None) if geometric else None,
        "edge_src": ("graph_edges",),
        "edge_dst": ("graph_edges",),
        "node_mask": ("graph_nodes",),
        "labels": (None,),
        "graph_ids": ("graph_nodes",) if graph_reg else None,
    }


def _loss(params, graph: dict, *, model_mod, cfg):
    return model_mod.loss_fn(params, cfg, G.Graph(**graph))


def make_cell(arch: str, model_mod, cfg, shape_name: str, geometric: bool,
              train_cfg: train_loop.TrainConfig = TRAIN_CFG) -> base.CellSpec:
    """The (arch × shape) cell, the reference's: one train step (loss,
    gradients, clip, AdamW) of ``cfg`` at the shape's widths over a graph
    of the shape. Arguments are meta tensors: the train state from
    ``model_mod.init`` on the meta device with ``model_mod.param_axes``,
    and the graph's fields (``graph_specs``, axes ``graph_axes``) as a
    dict, which the cell's function makes a ``Graph`` again."""
    sh = GNN_SHAPES[shape_name]
    cfg = shape_config(cfg, shape_name)

    def init(device):
        return (model_mod.init(cfg, torch.Generator(), device=device),
                model_mod.param_axes(cfg))

    state, state_axes = base.train_state_specs(init, train_cfg)
    step = train_loop.make_train_step(
        partial(_loss, model_mod=model_mod, cfg=cfg), train_cfg)
    return base.CellSpec(arch, shape_name, "train", step,
                         (state, graph_specs(sh, geometric)),
                         (state_axes, graph_axes(sh, geometric)))


def smoke_run(model_mod, cfg, geometric: bool, seed: int = 0, device=None):
    """One real train step on a tiny random graph (the reference's: 64
    nodes and 256 edges, or 4 molecules of 12 nodes for ``graph_reg``),
    with parameters from ``model_mod.init`` seeded by ``seed`` and
    ``TRAIN_CFG`` (the reference's smoke optimizer). Returns the step's
    metrics."""
    from repro_torch.data import graph_synth
    dev = resolve_device(device)
    if cfg.task == "graph_reg":
        g = graph_synth.molecule_batch(4, 12, 24, d_feat=cfg.d_in,
                                       seed=seed, device=dev)
    else:
        g = graph_synth.random_graph(64, 256, cfg.d_in,
                                     n_classes=cfg.n_classes, seed=seed,
                                     geometric=True, device=dev)
    params = model_mod.init(cfg, torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    state = train_loop.make_train_state(params, TRAIN_CFG)
    step = train_loop.make_train_step(
        lambda p, gg: model_mod.loss_fn(p, cfg, gg), TRAIN_CFG)
    state, metrics = step(state, g)
    return metrics
