"""End-to-end serving example (the paper's workload kind): generate the
XKG-like workload and serve it through the batching layer, comparing
Spec-QP against the TriniT baseline and, per mode, three serving
strategies: the sequential one-query-at-a-time loop, fixed micro-batches,
and the continuous-refill stream with pipelined planning (finished lanes
take queued queries instead of idling until the batch tail; the planner
plans the next group while this one executes).

    PYTHONPATH=src python -m repro_torch.examples.serve_kg
    PYTHONPATH=src python -m repro_torch.examples.serve_kg --device cpu \\
        --list-len 96 --n-queries 8
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.types import EngineConfig, resolve_device
from repro_torch.data import kg_synth
from repro_torch.launch import batching


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="xkg_mini")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--list-len", type=int, default=384)
    ap.add_argument("--n-queries", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    wl = kg_synth.make_workload(args.dataset, list_len=args.list_len,
                                n_queries=args.n_queries, device=dev)
    cfg = EngineConfig(block=32, k=args.k, grid_bins=256)
    queries = [np.asarray(q) for q in wl.queries]
    t_set = tuple(sorted({int((q >= 0).sum()) for q in queries}))
    q_buckets = tuple(sorted({b for b in (1, 4, 16, 64)
                              if b <= args.max_batch} | {args.max_batch}))
    bcfg = batching.BatchingConfig(max_batch=args.max_batch,
                                   q_buckets=q_buckets, t_buckets=t_set)
    rcfg = batching.BatchingConfig(
        max_batch=args.max_batch, q_buckets=q_buckets, t_buckets=t_set,
        refill=True, lanes=args.max_batch,
        refill_depth=max(len(queries), args.max_batch), pipeline=True)

    print(f"{args.dataset}: {len(queries)} queries, k={args.k}, "
          f"micro-batch ≤ {args.max_batch}, t_buckets={t_set}, "
          f"refill lanes={args.max_batch}, device={dev}")
    stats, results = {}, {}
    for mode in ("trinit", "specqp"):
        ex = batching.BatchExecutor(wl.store, wl.relax, cfg, mode, bcfg, dev)
        rex = batching.BatchExecutor(wl.store, wl.relax, cfg, mode, rcfg,
                                     dev)
        # Sequential baseline: one blocking run_query per request.
        engine.run_query(wl.store, wl.relax, queries[0], cfg, mode, dev)
        _sync(dev)
        t0 = time.perf_counter()
        seq = []
        for q in queries:
            seq.append(engine.run_query(wl.store, wl.relax, q, cfg, mode,
                                        dev))
            _sync(dev)
        seq_wall = time.perf_counter() - t0
        # Fixed micro-batches, then the pipelined refill stream.
        t0 = time.perf_counter()
        res = ex.run(queries)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        rres = rex.run(queries)
        rwall = time.perf_counter() - t0
        # The serving layer is a pure throughput transform: per-request
        # top-k equals the sequential loop's on every path.
        for i, (r, rr, s) in enumerate(zip(res, rres, seq)):
            keys, scores = s.keys.cpu().numpy(), s.scores.cpu().numpy()
            if not all(np.array_equal(a, b) for a, b in (
                    (r.keys, keys), (r.scores, scores), (rr.keys, keys),
                    (rr.scores, scores))):
                raise AssertionError(f"{mode} request {i}: served top-k "
                                     "differs from run_query")
        results[mode] = res
        stats[mode] = dict(seq_wall=seq_wall, wall=wall, rwall=rwall,
                           pulled=np.mean([r.n_pulled for r in res]),
                           ans=np.mean([r.n_answers for r in res]),
                           wasted=ex.wasted_fraction(),
                           rwasted=rex.wasted_fraction())

    for mode in ("trinit", "specqp"):
        s = stats[mode]
        n = len(queries)
        print(f"  {mode:8s}: sequential {n / s['seq_wall']:6.1f} QPS | "
              f"batched {n / s['wall']:6.1f} QPS "
              f"({s['seq_wall'] / s['wall']:.2f}x) "
              f"wasted {s['wasted']:.3f} | "
              f"refill+pipeline {n / s['rwall']:6.1f} QPS "
              f"({s['seq_wall'] / s['rwall']:.2f}x) "
              f"wasted {s['rwasted']:.3f} | top-k identical | "
              f"mean pulled {s['pulled']:7.0f} "
              f"answer-objects {s['ans']:6.0f}")
    precs = []
    for rt, rs in zip(results["trinit"], results["specqp"]):
        tk = {int(x) for x in rt.keys if x >= 0}
        sk = {int(x) for x in rs.keys if x >= 0}
        precs.append(len(tk & sk) / max(len(tk), 1))
    print(f"  specqp precision vs exact top-k: {np.mean(precs):.3f}")


if __name__ == "__main__":
    main()
