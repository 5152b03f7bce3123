"""Shapes shared by the GNN architectures (counterpart of
``repro.configs.gnn_common``): full_graph_sm (cora-scale full batch),
minibatch_lg (reddit-scale sampled subgraph, the padded output of the
fanout-15-10 neighbour sampler), ogb_products (ogbn-products-scale full
batch: Hu et al., arXiv:2005.00687) and molecule (128 batched 30-node
graphs). Only the configuration half of ``make_cell`` is ported; the train
cells are not.
"""
from __future__ import annotations

import dataclasses

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


def shape_config(cfg, shape_name: str):
    """``cfg`` with the input width, task and classes of a shape (what the
    reference's ``make_cell`` does before it builds the train step)."""
    sh = GNN_SHAPES[shape_name]
    return dataclasses.replace(cfg, d_in=sh["d_feat"], task=sh["task"],
                               n_classes=sh.get("n_classes", 1))
