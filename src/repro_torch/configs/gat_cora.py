"""gat-cora [arXiv:1710.10903]: 2 layers, d_hidden 8, 8 heads, attn agg.

Counterpart of ``repro.configs.gat_cora``: the configuration and its
reduced smoke configuration, the dry run's cell of each shape
(``make_cell``, built by ``gnn_common.make_cell``) and ``smoke``, one
train step (``gnn_common.smoke_run``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import gnn_common
from repro_torch.models.gnn import gat as model

ARCH = "gat-cora"
FAMILY = "gnn"
SHAPES = list(gnn_common.GNN_SHAPES)
SKIP_SHAPES: dict[str, str] = {}
GEOMETRIC = False


def config() -> model.GATConfig:
    return model.GATConfig(name=ARCH, n_layers=2, d_hidden=8, n_heads=8)


def smoke_config() -> model.GATConfig:
    return dataclasses.replace(config(), d_hidden=4, n_heads=2, d_in=8)


def make_cell(shape: str):
    return gnn_common.make_cell(ARCH, model, config(), shape, GEOMETRIC)


def smoke(device=None):
    """One train step of the smoke configuration (``gnn_common.smoke_run``)."""
    cfg = dataclasses.replace(smoke_config(), d_in=8, task="node_class")
    return gnn_common.smoke_run(model, cfg, GEOMETRIC, device=device)
