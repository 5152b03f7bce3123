"""egnn [arXiv:2102.09844]: 4 layers, d_hidden 64, E(n)-equivariant.

Counterpart of ``repro.configs.egnn``: the configuration and its
reduced smoke configuration, the dry run's cell of each shape
(``make_cell``, built by ``gnn_common.make_cell``) and ``smoke``, one
train step (``gnn_common.smoke_run``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import gnn_common
from repro_torch.models.gnn import egnn as model

ARCH = "egnn"
FAMILY = "gnn"
SHAPES = list(gnn_common.GNN_SHAPES)
SKIP_SHAPES: dict[str, str] = {}
GEOMETRIC = True


def config() -> model.EGNNConfig:
    return model.EGNNConfig(name=ARCH, n_layers=4, d_hidden=64)


def smoke_config() -> model.EGNNConfig:
    return dataclasses.replace(config(), d_hidden=16, d_in=8, n_layers=2)


def make_cell(shape: str):
    return gnn_common.make_cell(ARCH, model, config(), shape, GEOMETRIC)


def smoke(device=None):
    """One train step of the smoke configuration (``gnn_common.smoke_run``)."""
    cfg = dataclasses.replace(smoke_config(), d_in=8, task="graph_reg")
    return gnn_common.smoke_run(model, cfg, GEOMETRIC, device=device)
