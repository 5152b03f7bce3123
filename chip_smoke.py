#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails loudly (non-zero exit, no result line):

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (bit-equal), and time kernel, plain
   version and, where one exists, a single PyTorch call computing the same
   function (CUDA events, median);
4. drive the main path at the kg-specqp geometry (``configs/kg_specqp``):
   a 32-query xkg workload with lists of 8192 items, planned by PLANGEN
   and served through ``BatchExecutor`` (continuous refill, 8 lanes) in
   ``specqp`` and ``trinit`` modes, with the kernels' launch counters set to
   0 just before and read just after; check TriniT (rings uncapped)
   against the full-scan oracle on the card and two queries against the
   port on the CPU;
5. print the kernel table as one JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

It exits non-zero without CUDA and when ``src/repro_torch`` is not beside
it. It imports nothing of JAX. ``--profile`` adds a ``torch.profiler``
window over one specqp serving pass (device busy share, time by kernel).
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

T_START = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet) for the least-time bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12     # 32-bit operations outside the tensor cores
LANES = 8
N_QUERIES = 32
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, blocks: int = 15, per_block: int = 10) -> float:
    """Median time of one call in ms: CUDA events around blocks of calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(blocks):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_block):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_block)
    times.sort()
    return times[len(times) // 2]


def lookup_inputs(np, torch, rng, G, N, B, dev):
    """Seen rings of unique keys (some PAD slots), ring counts that are
    empty, partial, full and wrapped, and probes that hit, miss or are
    PAD — what the executor's probe launch sees."""
    keys = np.stack([rng.choice(10**8, N, replace=False) for _ in range(G)])
    keys = keys.astype(np.int32)
    keys[:, -B:][::3] = -1
    scores = rng.random((G, N)).astype(np.float32)
    cnt = np.array([(0, N // 3, N, N + 7 * B, 5 * N // 7)[g % 5]
                    for g in range(G)], np.int32)
    probes = np.empty((G, B), np.int32)
    for g in range(G):
        live = keys[g, :max(min(int(cnt[g]), N), 1)]
        probes[g] = np.concatenate([rng.choice(live, B // 2),
                                    rng.integers(10**8, 2 * 10**8,
                                                 B - B // 2 - 8),
                                    np.full(8, -1)])
    return [torch.from_numpy(a).to(dev) for a in (keys, scores, probes, cnt)]


def check_kernels(np, torch, ops, dev):
    """Phase 3: each kernel vs its plain version at main-path shapes."""
    rng = np.random.default_rng(SEED)
    rows = {}

    # rank_join_lookup: lanes × (1 + T) rings at T = 4, then a ring length
    # that is not a multiple of the kernel's 2048-slot tile.
    for G, N, B in ((LANES * 5, 16384, 256), (LANES, 5000, 256)):
        args = lookup_inputs(np, torch, rng, G, N, B, dev)
        ks, kf = ops.rank_join_lookup(*args)
        rs, rf = ops.rank_join_lookup(*args, impl="ref")
        torch.cuda.synchronize()
        if not (torch.equal(ks, rs) and torch.equal(kf, rf)):
            fail(f"rank_join_lookup differs from its plain version at "
                 f"G={G} N={N} B={B}")
        if not kf.any():
            fail("rank_join_lookup test data found nothing")
        err = float((ks - rs).abs().max())
        print(f"rank_join_lookup G={G} N={N} B={B}: bit-equal to plain")
        if N == 16384:
            keys, scores, probes, cnt = args
            live = cnt.clamp(max=N).long()
            nonpad = (probes != -1).sum(-1)
            compares = int((live * nonpad).sum())
            nbytes = int(live.sum()) * 8 + G * B * 4 + G * 4 + G * B * 5
            rows["rank_join_lookup"] = dict(
                name="rank_join_lookup", route="cuda",
                source="src/repro_torch/kernels/csrc/rank_join.cu",
                replaces="src/repro/kernels/rank_join.py:48",
                max_abs_err=err,
                ms=cuda_ms(torch, lambda: ops.rank_join_lookup(*args)),
                plain_ms=cuda_ms(torch, lambda: ops.rank_join_lookup(
                    *args, impl="ref"), blocks=5, per_block=2),
                bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S,
                                   compares / FP32_OPS_PER_S),
                bound_by=("bytes" if nbytes / HBM_BYTES_PER_S >
                          compares / FP32_OPS_PER_S else "operations"),
                library_ms=None, shape=f"G={G} N={N} B={B}")

    # merge_topk: one group per lane, R1 = 11 windows of W = block = 256,
    # scores on a coarse grid (many ties) with -inf tails.
    G, R, W, block = LANES, 11, 256, 256
    wk = torch.from_numpy(rng.integers(0, 20000, (G, R, W)).astype(
        np.int32)).to(dev)
    ws_np = (rng.integers(0, 64, (G, R, W)) / 64.0).astype(np.float32)
    ws_np[:, 3:, -40:] = -np.inf
    ws = torch.from_numpy(ws_np).to(dev)
    got = ops.merge_topk(wk, ws, block)
    want = ops.merge_topk(wk, ws, block, impl="ref")
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail("merge_topk differs from its plain version")
    flat_s = ws.view(G, -1)
    n = R * W
    nbytes = G * n * 8 + G * block * 12
    compares = G * n * math.ceil(math.log2(block))
    print(f"merge_topk G={G} R={R} W={W} block={block}: bit-equal to plain")
    rows["merge_topk"] = dict(
        name="merge_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/merge_topk.cu",
        replaces="src/repro/kernels/merge_topk.py:30", max_abs_err=float(
            (got[1] - want[1]).nan_to_num(0.0, 0.0, 0.0).abs().max()),
        ms=cuda_ms(torch, lambda: ops.merge_topk(wk, ws, block)),
        plain_ms=cuda_ms(torch, lambda: ops.merge_topk(wk, ws, block,
                                                       impl="ref")),
        bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S,
                           compares / FP32_OPS_PER_S),
        bound_by=("bytes" if nbytes / HBM_BYTES_PER_S >
                  compares / FP32_OPS_PER_S else "operations"),
        library_ms=cuda_ms(torch, lambda: torch.topk(flat_s, block, dim=-1)),
        shape=f"G={G} R={R} W={W} block={block}")
    return rows


def main_path(np, torch, dev):
    """Phase 4: plan and serve the kg-specqp workload on the card."""
    from repro_torch.configs import kg_specqp
    from repro_torch.core import engine
    from repro_torch.data import kg_synth
    from repro_torch.kernels import ops
    from repro_torch.launch import batching, serve

    cfg = kg_specqp.ENGINE
    t0 = time.perf_counter()
    wl = kg_synth.make_workload("xkg", list_len=kg_specqp.L_SHARD,
                                n_queries=N_QUERIES,
                                n_relax=kg_specqp.N_RELAX, seed=SEED,
                                device=dev)
    torch.cuda.synchronize()
    store_mb = sum(t.numel() * t.element_size() for t in (
        wl.store.keys, wl.store.scores, wl.store.lengths,
        wl.store.sorted_keys, wl.store.stats, wl.store.sketch)) / 2**20
    print(f"workload: {wl.store.keys.shape[0]} patterns x "
          f"{wl.store.keys.shape[1]} items, {len(wl.queries)} queries, "
          f"store {store_mb:.1f} MiB on the card, built in "
          f"{time.perf_counter() - t0:.1f} s")
    queries = [np.asarray(q) for q in wl.queries]
    t_set = tuple(sorted({int((q >= 0).sum()) for q in queries}))
    bcfg = batching.BatchingConfig(max_batch=LANES, q_buckets=(1, 4, 8, 32),
                                   t_buckets=t_set, refill=True,
                                   lanes=LANES, refill_depth=N_QUERIES)
    execs = {m: batching.BatchExecutor(wl.store, wl.relax, cfg, m, bcfg,
                                       device=dev)
             for m in ("specqp", "trinit")}
    # Warm-up (CUDA context, cuFFT plans, caching allocator) off the clock.
    for m in execs:
        engine.run_query(wl.store, wl.relax, queries[0], cfg, m, device=dev)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    served, report = {}, {}
    for m, ex in execs.items():
        res, wall, lat = serve.serve_offline(ex, queries)
        served[m] = res
        report[m] = dict(
            qps=len(queries) / wall, wall_s=wall,
            p50_ms=float(np.percentile(lat, 50)) * 1e3,
            p99_ms=float(np.percentile(lat, 99)) * 1e3,
            mean_pulled=float(np.mean([r.n_pulled for r in res])),
            mean_iters=float(np.mean([r.n_iters for r in res])),
            wasted_fraction=ex.wasted_fraction(),
            plan_s=ex.plan_total_s)
    torch.cuda.synchronize()
    launches = ops.launches()
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    for m, r in report.items():
        print(f"main path {m}: {r['qps']:.2f} QPS | p50 {r['p50_ms']:.1f} ms "
              f"p99 {r['p99_ms']:.1f} ms | mean n_pulled "
              f"{r['mean_pulled']:.1f} | mean n_iters {r['mean_iters']:.1f} "
              f"| wasted-iter frac {r['wasted_fraction']:.4f} | plan "
              f"{r['plan_s']:.3f} s")
    print(f"main path launches: {launches} | peak device memory "
          f"{peak_mb:.1f} MiB")
    if not all(v > 0 for v in launches.values()):
        fail(f"a kernel of the main path was never launched: {launches}")

    # Outputs are well formed.
    for m, res in served.items():
        for i, r in enumerate(res):
            if r.keys.shape != (cfg.k,) or r.scores.shape != (cfg.k,):
                fail(f"{m} query {i}: result shape {r.keys.shape}")
            ok = r.keys >= 0
            if not (np.isfinite(r.scores[ok]).all()
                    and np.isneginf(r.scores[~ok]).all()
                    and (r.keys[ok] < wl.n_entities).all()):
                fail(f"{m} query {i}: malformed top-k")

    # TriniT is exact: with rings that hold every pulled key it equals the
    # full-scan oracle, on the card. The production seen_cap (16384 slots
    # of a worst case of 11 × 8192) wraps rings on deep TriniT queries and
    # may then miss answers, as the JAX engine does; that count is reported.
    exact = engine.run_query_stream(
        wl.store, wl.relax, np.stack(queries),
        dataclasses.replace(cfg, seen_cap=None), "trinit", lanes=LANES,
        device=dev)
    key_match, capped_match = 0, 0
    for i, (q, r) in enumerate(zip(queries, served["trinit"])):
        bk, bs = engine.naive_full_scan(wl.store, wl.relax, q, cfg.k,
                                        wl.n_entities, device=dev)
        bk, bs = bk.cpu().numpy(), bs.cpu().numpy()
        if not np.allclose(bs, exact.scores[i].cpu().numpy(), rtol=1e-5):
            fail(f"trinit query {i} (no seen cap) differs from "
                 "naive_full_scan")
        key_match += int(np.array_equal(bk, exact.keys[i].cpu().numpy()))
        capped_match += int(np.allclose(bs, r.scores, rtol=1e-5))
    precision = np.mean([
        len(set(a.keys[a.keys >= 0]) & set(b.keys[b.keys >= 0]))
        / max(int((b.keys >= 0).sum()), 1)
        for a, b in zip(served["specqp"], served["trinit"])])
    print(f"trinit (no seen cap) == naive_full_scan on all {len(queries)} "
          f"queries (scores rtol 1e-5; keys identical on {key_match}); "
          f"with seen_cap={cfg.seen_cap} on {capped_match}; specqp "
          f"precision vs capped trinit {precision:.4f}")

    # The same executor on the CPU, under the card's plans, gives the same
    # answers and counters (the two cheapest queries: the CPU is slow here).
    store_c, relax_c = wl.store.to("cpu"), wl.relax.to("cpu")
    order = np.argsort([r.n_iters for r in served["specqp"]], kind="stable")
    plans_agree = 0
    for i in order[:2]:
        r = served["specqp"][i]
        mask = np.zeros((len(queries[i]), wl.relax.ids.shape[1]), bool)
        mask[:r.relax_mask.shape[0]] = r.relax_mask
        c = engine.execute_queue(store_c, relax_c, queries[i][None],
                                 mask[None], cfg, 1, device="cpu")
        same = (np.array_equal(c.keys[0].numpy(), r.keys)
                and np.allclose(c.scores[0].numpy(), r.scores, rtol=1e-6)
                and all(int(getattr(c, f)[0]) == getattr(r, f)
                        for f in ("n_pulled", "n_answers", "n_iters")))
        if not same:
            fail(f"query {i}: the port on the CPU differs from the card")
        cpu_plan = engine.plan_query_batch(store_c, relax_c, queries[i][None],
                                           cfg, "specqp", device="cpu")[0]
        plans_agree += int(np.array_equal(cpu_plan.numpy(), mask))
    print(f"card and CPU agree on keys and counters of queries "
          f"{order[:2].tolist()}; CPU plans equal the card's on "
          f"{plans_agree}/2")
    return launches, report, (wl, queries, bcfg)


def profile_main_path(np, torch, dev, wl, queries, bcfg) -> None:
    """One specqp serving pass under torch.profiler: the device's busy
    share of the wall time and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import kg_specqp
    from repro_torch.launch import batching

    ex = batching.BatchExecutor(wl.store, wl.relax, kg_specqp.ENGINE,
                                "specqp", bcfg, device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.run(queries)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e6
    if not events:
        print("profile: the trace holds no device time (not measured)")
        return
    print(f"profile (specqp pass, {wall:.3f} s wall under the profiler): "
          f"device busy {busy:.4f} s = {100 * busy / wall:.2f} % of wall")
    for e in sorted(events, key=dev_us, reverse=True)[:15]:
        print(f"  {dev_us(e) / 1e3:10.3f} ms  {e.count:7d} calls  "
              f"{e.key[:90]}")


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {pathlib.Path(__file__).name}: run "
             "it from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    dev = torch.device("cuda")
    # Full float32 in the plain versions (no TF32 anywhere).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    print(smi)
    print(f"imports, CUDA check and nvidia-smi took "
          f"{time.perf_counter() - T_START:.1f} s")
    from repro_torch.kernels import _build, ops

    t0 = time.perf_counter()
    _build.build_all()
    print(f"built {sorted(_build._libs)} with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    rows = check_kernels(np, torch, ops, dev)
    for k in rows.values():
        print(f"{k['name']} ({k['shape']}): kernel {k['ms']:.4f} ms, plain "
              f"{k['plain_ms']:.4f} ms, library {k['library_ms']} ms, bound "
              f"{k['bound_ms']:.5f} ms ({k['bound_by']})")
    print(f"phases 1-3 done at {time.perf_counter() - t0:.1f} s")
    launches, _, state = main_path(np, torch, dev)
    print(f"phase 4 done at {time.perf_counter() - t0:.1f} s")
    for name, row in rows.items():
        row["launches"] = launches[name]
    kernels = [rows[n] for n in ("rank_join_lookup", "merge_topk")]
    for k in kernels:
        print(f"{k['name']}: {k['launches']} launches on the main path")
    if "--profile" in sys.argv[1:]:
        profile_main_path(np, torch, dev, *state)
    print(f"chip_smoke took {time.perf_counter() - T_START:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
