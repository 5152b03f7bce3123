"""egnn [arXiv:2102.09844]: 4 layers, d_hidden 64, E(n)-equivariant.

Counterpart of ``repro.configs.egnn``: the configuration and its reduced
smoke configuration; ``gnn_common.shape_config`` gives a shape's widths
and ``smoke`` takes one train step (``gnn_common.smoke_run``). The TPU
dry-run cell (``make_cell``) is not ported.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import gnn_common
from repro_torch.models.gnn import egnn as model

ARCH = "egnn"
FAMILY = "gnn"
SHAPES = list(gnn_common.GNN_SHAPES)
GEOMETRIC = True


def config() -> model.EGNNConfig:
    return model.EGNNConfig(name=ARCH, n_layers=4, d_hidden=64)


def smoke_config() -> model.EGNNConfig:
    return dataclasses.replace(config(), d_hidden=16, d_in=8, n_layers=2)


def smoke(device=None):
    """One train step of the smoke configuration (``gnn_common.smoke_run``)."""
    cfg = dataclasses.replace(smoke_config(), d_in=8, task="graph_reg")
    return gnn_common.smoke_run(model, cfg, GEOMETRIC, device=device)
