"""nequip [arXiv:2101.03164]: 5 layers, 32 channels, l_max 2, 8 RBF,
cutoff 5, E(3) tensor-product message passing.

Counterpart of ``repro.configs.nequip``: the configuration and its
reduced smoke configuration, the dry run's cell of each shape
(``make_cell``, built by ``gnn_common.make_cell``) and ``smoke``, one
train step (``gnn_common.smoke_run``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import gnn_common
from repro_torch.models.gnn import nequip as model

ARCH = "nequip"
FAMILY = "gnn"
SHAPES = list(gnn_common.GNN_SHAPES)
SKIP_SHAPES: dict[str, str] = {}
GEOMETRIC = True


def config() -> model.NequIPConfig:
    return model.NequIPConfig(name=ARCH, n_layers=5, d_hidden=32, l_max=2,
                              n_rbf=8, cutoff=5.0)


def smoke_config() -> model.NequIPConfig:
    return dataclasses.replace(config(), d_hidden=8, n_layers=2, d_in=8)


def make_cell(shape: str):
    return gnn_common.make_cell(ARCH, model, config(), shape, GEOMETRIC)


def smoke(device=None):
    """One train step of the smoke configuration (``gnn_common.smoke_run``)."""
    cfg = dataclasses.replace(smoke_config(), d_in=8, task="graph_reg")
    return gnn_common.smoke_run(model, cfg, GEOMETRIC, device=device)
