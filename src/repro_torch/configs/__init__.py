"""Architecture registry: ``--arch <id>`` resolution for every entry point
(counterpart of ``repro.configs``).

The same eleven names as the reference. An architecture the port does not
have yet raises ``NotImplementedError``; an unknown name raises
``KeyError``, as in the reference.
"""
from __future__ import annotations

import importlib

_ARCHS = {
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "gemma3-27b": None,
    "deepseek-v3-671b": None,
    "granite-moe-3b-a800m": None,
    "egnn": None,
    "gat-cora": "repro_torch.configs.gat_cora",
    "nequip": None,
    "mace": None,
    "two-tower-retrieval": "repro_torch.configs.two_tower_retrieval",
    # The paper's own engine as a first-class serving config (bonus arch).
    "kg-specqp": "repro_torch.configs.kg_specqp",
}

ASSIGNED_ARCHS = [a for a in _ARCHS if a != "kg-specqp"]


def get_arch(name: str):
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {list(_ARCHS)}")
    if _ARCHS[name] is None:
        raise NotImplementedError(
            f"arch {name!r} is not ported to PyTorch yet (ROADMAP.md, "
            "Queue 1)")
    return importlib.import_module(_ARCHS[name])


def all_archs():
    return list(_ARCHS)
