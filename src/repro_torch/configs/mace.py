"""mace [arXiv:2206.07697]: 2 layers, 128 channels, l_max 2,
correlation order 3, 8 RBF, cutoff 5 — E(3)-ACE message passing.

Counterpart of ``repro.configs.mace``: the configuration and its
reduced smoke configuration, the dry run's cell of each shape
(``make_cell``, built by ``gnn_common.make_cell``) and ``smoke``, one
train step (``gnn_common.smoke_run``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import gnn_common
from repro_torch.models.gnn import mace as model

ARCH = "mace"
FAMILY = "gnn"
SHAPES = list(gnn_common.GNN_SHAPES)
SKIP_SHAPES: dict[str, str] = {}
GEOMETRIC = True


def config() -> model.MACEConfig:
    return model.MACEConfig(name=ARCH, n_layers=2, d_hidden=128, l_max=2,
                            correlation=3, n_rbf=8, cutoff=5.0)


def smoke_config() -> model.MACEConfig:
    return dataclasses.replace(config(), d_hidden=16, d_in=8)


def make_cell(shape: str):
    return gnn_common.make_cell(ARCH, model, config(), shape, GEOMETRIC)


def smoke(device=None):
    """One train step of the smoke configuration (``gnn_common.smoke_run``)."""
    cfg = dataclasses.replace(smoke_config(), d_in=8, task="graph_reg")
    return gnn_common.smoke_run(model, cfg, GEOMETRIC, device=device)
