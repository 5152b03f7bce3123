"""Architecture registry: ``--arch <id>`` resolution for every entry point
(counterpart of ``repro.configs``).

The same eleven names as the reference, each mapped to the port's config
module; an unknown name raises ``KeyError``, as in the reference.
"""
from __future__ import annotations

import importlib

_ARCHS = {
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "egnn": "repro_torch.configs.egnn",
    "gat-cora": "repro_torch.configs.gat_cora",
    "nequip": "repro_torch.configs.nequip",
    "mace": "repro_torch.configs.mace",
    "two-tower-retrieval": "repro_torch.configs.two_tower_retrieval",
    # The paper's own engine as a first-class serving config (bonus arch).
    "kg-specqp": "repro_torch.configs.kg_specqp",
}

ASSIGNED_ARCHS = [a for a in _ARCHS if a != "kg-specqp"]


def get_arch(name: str):
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {list(_ARCHS)}")
    return importlib.import_module(_ARCHS[name])


def all_archs():
    return list(_ARCHS)
