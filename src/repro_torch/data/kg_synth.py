"""Synthetic scored-KG workloads mirroring the paper's two datasets (§4.2).

Counterpart of ``repro.data.kg_synth``: the same numpy ``default_rng(seed)``
draws in the same order, so a workload built here is bit-equal to the JAX
package's for the same arguments. See that module for what the generator
models (power-law scores, relaxations with varying overlap, star queries
with non-empty answers).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import kg
from repro_torch.core.types import TripleStore, RelaxTable, resolve_device


@dataclasses.dataclass(frozen=True)
class KGWorkload:
    store: TripleStore
    relax: RelaxTable
    queries: np.ndarray        # (Q, T_max) int32 pattern ids, -1 padded
    n_entities: int
    name: str


def _powerlaw_scores(rng: np.random.Generator, n: int, alpha: float) -> np.ndarray:
    """Zipf-like raw scores: rank-r score ∝ (r+1)^-alpha with noise."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    base = ranks ** (-alpha)
    noise = rng.lognormal(0.0, 0.25, size=n)
    s = base * noise
    return np.sort(s)[::-1] * 1000.0


def _place_list(rng: np.random.Generator, core: np.ndarray, cover: float,
                front: float, n_extra: int, n_entities: int,
                list_len: int) -> np.ndarray:
    """One pattern's key list, best-score-first: ``cover`` of the core
    answer pool, placed towards the top as ``front`` → 0."""
    n_core = int(cover * len(core))
    if cover > 0:
        n_core = max(2, n_core)
    own_core = rng.choice(core, size=n_core, replace=False)
    extra = rng.choice(n_entities, size=n_extra, replace=False)
    extra = np.setdiff1d(extra, own_core)
    keys = np.concatenate([own_core, extra])
    pri = np.concatenate([
        rng.uniform(0.0, max(front, 1e-3), size=len(own_core)),
        rng.uniform(0.0, 1.0, size=len(extra)),
    ])
    order = np.argsort(pri, kind="stable")
    return keys[order][:list_len]


def make_workload(name: str = "xkg_mini", *, seed: int = 0,
                  n_entities: int = 20_000, list_len: int = 1024,
                  n_queries: int | None = None,
                  n_relax: int | None = None,
                  tp_range: tuple[int, int] | None = None,
                  device=None) -> KGWorkload:
    """Build a named synthetic workload on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if name.startswith("xkg"):
        n_queries = n_queries or 65
        n_relax = n_relax or 10
        tp_range = tp_range or (2, 4)
        base_fill = (0.5, 1.0)
    elif name.startswith("twitter"):
        n_queries = n_queries or 50
        n_relax = n_relax or 5
        tp_range = tp_range or (2, 3)
        base_fill = (0.10, 0.45)
    else:
        raise ValueError(name)

    patterns: list[tuple[np.ndarray, np.ndarray]] = []
    rules: dict[int, list[tuple[int, float]]] = {}
    queries = []
    t_max = tp_range[1]

    def add_pattern(keys: np.ndarray, alpha: float) -> int:
        scores = _powerlaw_scores(rng, len(keys), alpha)
        patterns.append((keys.astype(np.int32), scores))
        return len(patterns) - 1

    for _ in range(n_queries):
        T = int(rng.integers(tp_range[0], tp_range[1] + 1))
        alpha = float(rng.uniform(0.8, 1.4))
        core_size = int(rng.uniform(0.05, 0.25) * list_len)
        core = rng.choice(n_entities, size=max(core_size, 3 * 20),
                          replace=False)
        qids = []
        for _t in range(T):
            n_base = int(rng.uniform(*base_fill) * list_len)
            cover = float(rng.uniform(0.15, 1.0))
            front = float(rng.uniform(0.05, 1.0))
            keys = _place_list(rng, core, cover, front, n_base,
                               n_entities, list_len)
            pid = add_pattern(keys, alpha)
            qids.append(pid)
            w0 = float(rng.uniform(0.25, 0.95))
            rl = []
            for j in range(n_relax):
                w = float(np.clip(w0 * (0.9 ** j) * rng.uniform(0.85, 1.0),
                                  0.02, 0.95))
                # ~30% of relaxations are off-target strays.
                if rng.random() < 0.3:
                    rel_cover = 0.0
                else:
                    rel_cover = float(rng.uniform(0.3, 1.0))
                rel_front = float(rng.uniform(0.05, 0.8))
                n_rel = int(rng.uniform(0.3, 1.0) * list_len)
                rkeys = _place_list(rng, core, rel_cover, rel_front, n_rel,
                                    n_entities, list_len)
                rid = add_pattern(rkeys, alpha)
                rl.append((rid, w))
            rules[pid] = rl
        queries.append(qids + [-1] * (t_max - T))

    store = kg.build_store(patterns, list_len=list_len, device=dev)
    relax = kg.build_relax_table(len(patterns), rules, max_relax=n_relax,
                                 device=dev)
    return KGWorkload(store=store, relax=relax,
                      queries=np.asarray(queries, np.int32),
                      n_entities=n_entities, name=name)


def tiny_workload(seed: int = 0, n_entities: int = 512, list_len: int = 64,
                  n_queries: int = 8, n_relax: int = 3,
                  device=None) -> KGWorkload:
    """Small deterministic workload for unit/property tests."""
    return make_workload("xkg_mini", seed=seed, n_entities=n_entities,
                         list_len=list_len, n_queries=n_queries,
                         n_relax=n_relax, tp_range=(2, 3), device=device)
