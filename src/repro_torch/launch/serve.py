"""Serving launcher: batched KG query serving (the paper's workload).

``python -m repro_torch.launch.serve --dataset xkg_mini --mode specqp``
generates a workload on the device, answers it one query at a time (the
sequential baseline), then serves it through ``launch.batching`` — the
continuous-refill configuration of the executor by default, fixed batches
with ``--no-refill`` — and reports QPS, p50/p99 latency and the
wasted-iteration fraction. ``--pipeline`` overlaps planning of group i+1
with execution of group i; ``--arrival-qps`` replays the workload as a
Poisson arrival process through the threaded ``MicroBatcher`` (latency
then includes queue wait). ``--device`` defaults to ``cuda``.
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sequential_baseline(wl, cfg, mode, queries, device):
    """One run_query per request; returns (wall s, per-request latency s)."""
    engine.run_query(wl.store, wl.relax, queries[0], cfg, mode, device)
    _sync(device)
    lat = []
    t_start = time.perf_counter()
    for q in queries:
        t0 = time.perf_counter()
        engine.run_query(wl.store, wl.relax, q, cfg, mode, device)
        _sync(device)
        lat.append(time.perf_counter() - t0)
    return time.perf_counter() - t_start, np.asarray(lat)


def serve_offline(ex: batching.BatchExecutor, queries):
    """Serve ``queries`` through the executor; returns (results, wall s,
    per-request latency s). A request's latency is its group's execute time
    plus its share of the plan phase, comparable to the sequential
    baseline's run_query, which plans too."""
    ex.reset_stats()
    t_start = time.perf_counter()
    results = ex.run(queries)
    wall = time.perf_counter() - t_start
    plan_amort = ex.plan_total_s / max(len(queries), 1)
    lat = np.asarray([s.exec_s + plan_amort for s in ex.stats
                      for _ in range(s.n_requests)])
    return results, wall, lat


def serve_online(ex: batching.BatchExecutor, queries, arrival_qps: float,
                 seed: int):
    """Replay ``queries`` as a Poisson process of rate ``arrival_qps``
    through a MicroBatcher; returns (results, wall s, per-request latency
    s). A request's latency runs from its submit to its future's
    resolution, stamped by a done callback in the worker thread."""
    gaps = np.random.default_rng(seed).exponential(1.0 / arrival_qps,
                                                   size=len(queries))
    done_t = np.zeros(len(queries))

    def _mark(i):
        return lambda _f: done_t.__setitem__(i, time.perf_counter())

    ex.reset_stats()
    with batching.MicroBatcher(ex) as mb:
        futs, t_sub = [], []
        t_start = time.perf_counter()
        for i, (q, gap) in enumerate(zip(queries, gaps)):
            time.sleep(gap)
            t_sub.append(time.perf_counter())
            f = mb.submit(q)
            f.add_done_callback(_mark(i))
            futs.append(f)
        results = [f.result() for f in futs]
        wall = time.perf_counter() - t_start
    return results, wall, done_t - np.asarray(t_sub)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="xkg_mini",
                    choices=["xkg_mini", "twitter_mini"])
    ap.add_argument("--mode", default="specqp", choices=list(engine.MODES))
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--block", type=int, default=64)
    ap.add_argument("--grid-bins", type=int, default=256)
    ap.add_argument("--list-len", type=int, default=512)
    ap.add_argument("--n-queries", type=int, default=None)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--refill", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="continuous-refill configuration (the default); "
                         "--no-refill serves fixed batches (lanes = batch)")
    ap.add_argument("--lanes", type=int, default=None,
                    help="lanes for --refill (default: max-batch)")
    ap.add_argument("--refill-depth", type=int, default=64,
                    help="admission-queue entries per streaming call")
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--pipeline", action="store_true",
                    help="overlap planning of group i+1 with execution of "
                         "group i (offline mode)")
    ap.add_argument("--arrival-qps", type=float, default=None,
                    help="replay as a Poisson arrival process through the "
                         "threaded MicroBatcher (default: offline batches)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.arrival_qps is not None and args.arrival_qps <= 0:
        ap.error(f"--arrival-qps must be > 0, got {args.arrival_qps}")
    if args.lanes is not None and args.lanes < 1:
        ap.error(f"--lanes must be >= 1, got {args.lanes}")
    if args.refill_depth < 1:
        ap.error(f"--refill-depth must be >= 1, got {args.refill_depth}")
    if args.max_batch < 1:
        ap.error(f"--max-batch must be >= 1, got {args.max_batch}")
    device = resolve_device(args.device)

    wl = kg_synth.make_workload(args.dataset, list_len=args.list_len,
                                n_queries=args.n_queries, seed=args.seed,
                                device=device)
    cfg = EngineConfig(block=args.block, k=args.k, grid_bins=args.grid_bins)
    queries = [np.asarray(q) for q in wl.queries]
    t_set = sorted({int((q >= 0).sum()) for q in queries})
    q_buckets = tuple(sorted({b for b in (1, 4, 16, 64)
                              if b <= args.max_batch} | {args.max_batch}))
    bcfg = batching.BatchingConfig(
        max_batch=args.max_batch, max_wait_s=args.max_wait_ms * 1e-3,
        q_buckets=q_buckets, t_buckets=tuple(t_set), refill=args.refill,
        lanes=args.lanes, refill_depth=args.refill_depth,
        pipeline=args.pipeline)
    ex = batching.BatchExecutor(wl.store, wl.relax, cfg, args.mode, bcfg,
                                device)
    extra = (f" refill(lanes={ex._lanes_n()}, depth={bcfg.refill_depth})"
             if args.refill else "")
    print(f"{args.dataset} mode={args.mode} k={args.k} device={device}: "
          f"{len(queries)} queries{extra}"
          f"{' pipeline' if args.pipeline else ''}")

    seq_wall, seq_lat = sequential_baseline(wl, cfg, args.mode, queries,
                                            device)
    print(f"  sequential: {len(queries) / seq_wall:7.1f} QPS | "
          f"p50 {np.percentile(seq_lat, 50) * 1e3:6.1f}ms "
          f"p99 {np.percentile(seq_lat, 99) * 1e3:6.1f}ms")
    if args.arrival_qps:
        _, wall, lat = serve_online(ex, queries, args.arrival_qps, args.seed)
        label = f"online λ={args.arrival_qps:g}/s"
    else:
        _, wall, lat = serve_offline(ex, queries)
        label = "batched    "
    mean_b = np.mean([s.n_requests for s in ex.stats]) if ex.stats else 0
    print(f"  {label}: {len(queries) / wall:7.1f} QPS | "
          f"p50 {np.percentile(lat, 50) * 1e3:6.1f}ms "
          f"p99 {np.percentile(lat, 99) * 1e3:6.1f}ms | "
          f"speedup {seq_wall / wall:4.2f}x | mean batch {mean_b:.1f} | "
          f"wasted-iter frac {ex.wasted_fraction():.3f}")


if __name__ == "__main__":
    main()
