"""gat-cora [arXiv:1710.10903]: 2 layers, d_hidden 8, 8 heads, attn agg.

Counterpart of ``repro.configs.gat_cora``: the configuration and its
reduced smoke configuration. The train cell and ``smoke`` (one train step)
are not ported yet; ``gnn_common.shape_config`` gives a shape's widths.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import gnn_common
from repro_torch.models.gnn import gat as model

ARCH = "gat-cora"
FAMILY = "gnn"
SHAPES = list(gnn_common.GNN_SHAPES)
GEOMETRIC = False


def config() -> model.GATConfig:
    return model.GATConfig(name=ARCH, n_layers=2, d_hidden=8, n_heads=8)


def smoke_config() -> model.GATConfig:
    return dataclasses.replace(config(), d_hidden=4, n_heads=2, d_in=8)
