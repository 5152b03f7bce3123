"""Quickstart: build a tiny scored KG, answer one star query with TriniT
(exact baseline) and Spec-QP (speculative), and inspect the plan.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import engine, estimator, plangen
from repro_torch.core.types import EngineConfig, resolve_device
from repro_torch.data import kg_synth


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    dev = resolve_device(ap.parse_args(argv).device)
    wl = kg_synth.tiny_workload(seed=1, n_queries=6, list_len=128,
                                device=dev)
    cfg = EngineConfig(block=16, k=5, grid_bins=128)
    row = wl.queries[4]
    T = int((row >= 0).sum())
    q = torch.from_numpy(row).to(dev)
    print(f"query patterns: {row[:T]} (k={cfg.k}, device={dev})")

    # What the planner estimates (§3.1–3.2). e_q1 is (T, R): one E_Q'(1)
    # per (pattern, relaxation) pair; the plan is the matching (T, R) mask.
    e_qk, e_q1 = estimator.query_score_estimates(
        wl.store, wl.relax, q[None].long(), (q != -1)[None], cfg.k,
        cfg.grid_bins)
    print(f"E_Q(k) = {float(e_qk[0]):.3f}   best E_Q'(1) per pattern = "
          f"{np.round(e_q1[0].amax(-1).cpu().numpy()[:T], 3)}")
    mask = plangen.plan(wl.store, wl.relax, q, cfg.k,
                        cfg.grid_bins).cpu().numpy()
    print(f"plan (T,R) relax mask:\n{mask.astype(int)[:T]}")
    print(f"patterns relaxed: {mask.any(axis=1)[:T]}")

    rt = engine.run_query(wl.store, wl.relax, q, cfg, "trinit", dev)
    rs = engine.run_query(wl.store, wl.relax, q, cfg, "specqp", dev)
    bk, bs = engine.naive_full_scan(wl.store, wl.relax, q, cfg.k,
                                    wl.n_entities, device=dev)
    print("\n  rank | oracle            | trinit            | specqp")
    for r in range(cfg.k):
        print(f"  {r+1:4d} | {int(bk[r]):6d} {float(bs[r]):8.3f} "
              f"| {int(rt.keys[r]):6d} {float(rt.scores[r]):8.3f} "
              f"| {int(rs.keys[r]):6d} {float(rs.scores[r]):8.3f}")
    print(f"\npulled: trinit={int(rt.n_pulled)} specqp={int(rs.n_pulled)}  "
          f"answer-objects: {int(rt.n_answers)} vs {int(rs.n_answers)}")


if __name__ == "__main__":
    main()
