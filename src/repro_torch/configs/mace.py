"""mace [arXiv:2206.07697]: 2 layers, 128 channels, l_max 2,
correlation order 3, 8 RBF, cutoff 5 — E(3)-ACE message passing.

Counterpart of ``repro.configs.mace``: the configuration and its reduced
smoke configuration; ``gnn_common.shape_config`` gives a shape's widths
and ``smoke`` takes one train step (``gnn_common.smoke_run``). The TPU
dry-run cell (``make_cell``) is not ported.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import gnn_common
from repro_torch.models.gnn import mace as model

ARCH = "mace"
FAMILY = "gnn"
SHAPES = list(gnn_common.GNN_SHAPES)
GEOMETRIC = True


def config() -> model.MACEConfig:
    return model.MACEConfig(name=ARCH, n_layers=2, d_hidden=128, l_max=2,
                            correlation=3, n_rbf=8, cutoff=5.0)


def smoke_config() -> model.MACEConfig:
    return dataclasses.replace(config(), d_hidden=16, d_in=8)


def smoke(device=None):
    """One train step of the smoke configuration (``gnn_common.smoke_run``)."""
    cfg = dataclasses.replace(smoke_config(), d_in=8, task="graph_reg")
    return gnn_common.smoke_run(model, cfg, GEOMETRIC, device=device)
