"""gat-cora [arXiv:1710.10903]: 2 layers, d_hidden 8, 8 heads, attn agg.

Counterpart of ``repro.configs.gat_cora``: the configuration and its
reduced smoke configuration; ``gnn_common.shape_config`` gives a shape's
widths and ``smoke`` takes one train step (``gnn_common.smoke_run``). The
TPU dry-run cell (``make_cell``) is not ported.
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


def smoke(device=None):
    """One train step of the smoke configuration (``gnn_common.smoke_run``)."""
    cfg = dataclasses.replace(smoke_config(), d_in=8, task="node_class")
    return gnn_common.smoke_run(model, cfg, GEOMETRIC, device=device)
