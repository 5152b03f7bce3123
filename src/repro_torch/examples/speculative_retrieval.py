"""Spec-QP beyond the KG: speculative candidate-block pruning for dense
retrieval. Builds a norm-clustered corpus (the realistic ANN layout),
compares the speculative kernel against the score-everything baseline, and
checks that the speculative result is the exact top-k.

    PYTHONPATH=src python -m repro_torch.examples.speculative_retrieval
    PYTHONPATH=src python -m repro_torch.examples.speculative_retrieval \\
        --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.kernels import ops as kops


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    D, tile, k = 128, 512, 10
    n_tiles = 32
    # Block-clustered magnitudes: popular items (large norms) first — the
    # index-build-time analogue of the paper's score-sorted posting lists.
    mags = np.repeat(np.geomspace(4.0, 0.1, n_tiles), tile)
    cand = (rng.standard_normal((n_tiles * tile, D)) * mags[:, None]
            / np.sqrt(D)).astype(np.float32)
    q = rng.standard_normal(D).astype(np.float32)

    cand_t = torch.from_numpy(cand).to(dev)
    q_t = torch.from_numpy(q).to(dev)
    bounds = kops.block_bounds_cauchy(q_t, cand_t, tile)
    inf_bounds = torch.full_like(bounds, float("inf"))

    for name, b in (("speculative", bounds), ("baseline", inf_bounds)):
        kops.topk_score_pruned(q_t, cand_t, b, k, tile)
        _sync(dev)
        t0 = time.perf_counter()
        s, i, n = kops.topk_score_pruned(q_t, cand_t, b, k, tile)
        _sync(dev)
        dt = (time.perf_counter() - t0) * 1e3
        print(f"{name:12s}: scored {int(n):3d}/{n_tiles} tiles "
              f"in {dt:6.1f}ms on {dev}  top-3 {i[:3].tolist()}")

    exact_s, exact_i = torch.sort(cand_t @ q_t, descending=True,
                                  stable=True)
    s, i, n = kops.topk_score_pruned(q_t, cand_t, bounds, k, tile)
    if not torch.allclose(s, exact_s[:k], rtol=1e-5):
        raise AssertionError("speculative scores differ from the exact "
                             "top-k")
    print("speculative result == exact top-k ✓")


if __name__ == "__main__":
    main()
