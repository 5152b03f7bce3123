"""Serving soak: concurrent submitters hammer the threaded MicroBatcher
under a wall-clock budget, then shutdown is exercised mid-traffic.

N submitter threads (default 2) push randomized queries at the queue for
``--seconds``; ``close()`` then races the last in-flight submits. The soak
passes iff every future resolves (a served result or the clean
closed-rejection — nothing hangs), every served top-k equals the
sequential ``run_query`` reference, and some request was served. Every
request submitted before ``close()`` is served, so the run lasts as long as
the backlog takes (minutes on the CPU at ``--seconds 3``). With
``--refill`` the flush groups are served by the continuous-refill stream
instead of fixed micro-batches.

    PYTHONPATH=src python -m repro_torch.examples.serve_soak --refill
    PYTHONPATH=src python -m repro_torch.examples.serve_soak --device cpu \\
        --seconds 0.5
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from repro_torch.core import engine
from repro_torch.core.types import EngineConfig, resolve_device
from repro_torch.data import kg_synth
from repro_torch.launch import batching


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=15.0,
                    help="submit-phase wall-clock budget")
    ap.add_argument("--n-submitters", type=int, default=2)
    ap.add_argument("--list-len", type=int, default=64)
    ap.add_argument("--n-queries", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--refill", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    wl = kg_synth.make_workload("xkg_mini", list_len=args.list_len,
                                n_queries=args.n_queries, seed=args.seed,
                                n_relax=3, device=dev)
    cfg = EngineConfig(block=16, k=5, grid_bins=128)
    queries = [np.asarray(q) for q in wl.queries]
    t_set = tuple(sorted({int((q >= 0).sum()) for q in queries}))
    bcfg = batching.BatchingConfig(
        max_batch=args.max_batch, q_buckets=(1, 2, 4, args.max_batch),
        t_buckets=t_set, refill=args.refill,
        refill_depth=max(8, args.max_batch))
    ex = batching.BatchExecutor(wl.store, wl.relax, cfg, "specqp", bcfg, dev)
    refs = [engine.run_query(wl.store, wl.relax, q, cfg, "specqp", dev)
            for q in queries]
    refs = [(r.keys.cpu().numpy(), r.scores.cpu().numpy()) for r in refs]

    mb = batching.MicroBatcher(ex)
    futs: list[tuple[int, object]] = []
    lock = threading.Lock()
    deadline = time.perf_counter() + args.seconds

    def submitter(tid: int):
        rng = np.random.default_rng(args.seed + tid)
        while time.perf_counter() < deadline:
            i = int(rng.integers(len(queries)))
            f = mb.submit(queries[i])
            with lock:
                futs.append((i, f))
            # Uneven pacing so flush groups vary in size.
            time.sleep(float(rng.uniform(0.0, 0.004)))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(args.n_submitters)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    mb.close()        # drains every pending future before returning
    wall = time.perf_counter() - t0

    n_ok = n_rejected = 0
    for i, f in futs:
        if not f.done():
            raise AssertionError("soak FAILED: a future was left unresolved")
        if f.exception() is not None:
            if not isinstance(f.exception(), RuntimeError):
                raise f.exception()
            n_rejected += 1
            continue
        r = f.result()
        ref_k, ref_s = refs[i]
        if not (np.array_equal(r.keys, ref_k)
                and np.array_equal(r.scores, ref_s)):
            raise AssertionError(f"soak FAILED: top-k mismatch (query {i})")
        n_ok += 1
    if n_ok == 0:
        raise AssertionError("soak FAILED: no request was served")
    mean_b = np.mean([s.n_requests for s in ex.stats]) if ex.stats else 0
    print(f"soak OK ({'refill' if args.refill else 'fixed'}, {dev}): "
          f"{n_ok} served + {n_rejected} cleanly rejected at shutdown | "
          f"{n_ok / wall:.1f} QPS | mean flush {mean_b:.1f} | "
          f"wasted-iter frac {ex.wasted_fraction():.3f} | "
          f"{wall:.1f}s wall")


if __name__ == "__main__":
    main()
