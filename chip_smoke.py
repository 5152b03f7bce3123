#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails loudly (non-zero exit, no result line):

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
3. hold the KG kernels against their plain PyTorch versions on the card,
   at the shapes the KG path gives them, each case run twice (bit-equal
   to plain and between runs): ``rank_join_lookup`` on empty, partial,
   full and wrapped rings, with duplicate and all-PAD probes, and with
   duplicate live ring keys (found equal, scores within rtol 1e-6);
   ``merge_topk`` on unsorted coarse-grid windows, on the KG path's own
   windows (the kg-specqp lists through ``operators.block_windows``) and on
   those with a third of their rows shuffled. Time each kernel's device
   time (calls captured in a CUDA graph, replays timed with CUDA events,
   median) beside its per-call time (back-to-back calls), its plain
   version, its bound, an empty kernel's launch timed alike, and for
   ``merge_topk`` ``torch.topk`` timed both ways;
4. drive the KG path at the kg-specqp geometry (``configs/kg_specqp``):
   a 32-query xkg workload with lists of 8192 items, planned by PLANGEN
   and served through ``BatchExecutor`` (continuous refill, 8 lanes) in
   ``specqp`` and ``trinit`` modes, with the kernels' launch counters set to
   0 just before and read just after; check TriniT (rings uncapped)
   against the full-scan oracle on the card and two queries against the
   port on the CPU. Then, on the same store and each with the counters
   set to 0 just before and read just after: the sketch planner
   (``cardinality_mode="sketch"``) through the same executor, with plan
   seconds exact against sketch per plan group, the share of (T, R) mask
   bits and whole masks equal to the exact plans, precision against
   TriniT, QPS and p50/p99, and two queries' estimates held against the
   port on the CPU (zeros and the 0.5 gate equal, atol 4e-3 rtol 1e-5);
   the pipelined plan/execute path in both modes, every query's keys,
   scores and counters equal to the offline pass's, with the planner's
   seconds under execution; the 32 queries as Poisson arrivals through the
   ``MicroBatcher`` at 0.5x and 0.9x of the offline specqp QPS (p50/p99
   from submit to resolution), and all 32 at once drained by ``close()``,
   every future's result equal to the offline pass's;
5. retrieval at the ``retrieval_cand`` shape of
   ``configs/two_tower_retrieval``: ``topk_score_pruned`` held against its
   plain version on a 1,048,576 x 256 norm-clustered corpus (Cauchy,
   infinite and unsound bounds, and the corpus's tiles in shuffled norm
   order), run twice for bit-equality, its tiles read printed beside those
   counted, and timed beside ``block_bounds_cauchy`` alone; then 32 queries
   through ``retrieve`` and the score-everything baseline with the counters
   read around them, every top-100 checked against the exact full scan and
   every query's tiles scored against the plain version's;
6. two-tower serving at the ``serve_p99`` shape: the full-width model
   (two 20 M x 256 tables, about 41 GB) initialised on the card,
   ``embedding_bag`` held against its plain version on its tables at the
   user batch (512 x 32, a quarter of the slots -1), the corpus chunk
   (65,536 x 8) and ids above 2**23, each case twice and bit-equal, and
   timed at the two path shapes by device time (CUDA-graph replay) beside
   the per-call time, ids from the table's first GiB only, its bound, the
   plain version and ``F.embedding_bag``; then, with the counters read around
   them, the 1,048,576-item corpus built through the item tower and 16
   batches of 512 users served through ``serve``; one batch checked
   against a full-matrix top-k;
7. LM serving at the full width of gemma2-2b (``configs/gemma2_2b``, 26
   layers, bf16, random weights from a seed): ``flash_attention`` held
   against its plain version (f32 math) at the global- and local-layer
   shapes, Sq < Sk, non-causal, head_dim 128 and a ragged length, with
   logits large enough that the softcap of 50 bends them (a control shows
   the kernel without softcap fails the same check), and timed at B = 4
   beside its bound, the plain version and
   ``scaled_dot_product_attention``; then, with the counters read around
   them, 3 prefills of 4 x 8192-token prompts (26 kernel launches each) and
   32 greedy decode steps (none); at B = 1 the kernel path's last logits
   held against those of the ``einsum`` attention, and one decode step
   against the backbone over the extended prompt;
8. GNN inference at the ``ogb_products`` shape (ogbn-products: 2,449,029
   nodes, 61,859,140 edges, 100 features, 47 classes) with gat-cora's
   widths (2 layers, 8 heads, hidden 8): ``neigh_softmax_agg`` held
   against its plain version at the reference's test shapes, the GAT
   layer shapes, ragged and odd shapes, rows with no live slot, NaN
   features in masked slots (which it never reads) and more than 2**31
   feature floats, each case twice and bit-equal, and timed by device
   time (CUDA-graph replay) beside the per-call time, its bound (live
   slots' features only), the plain version and ``torch.softmax`` +
   ``torch.bmm``; the graph made by
   ``graph_synth.random_graph`` and 3 forwards through ``gat.apply`` timed
   with the counters read around them (0 launches: the reference's GAT
   never calls the kernel); then per layer the kernel driven over every
   node on the layer's own logits and features in the padded-degree
   layout, held against its plain version and the layer's segment-op
   aggregation, and the layer's output against a float64 oracle at 4,096
   sampled nodes;
9. the sharded paths (``core/distributed.py``, ``launch/mesh.py``): the
   xkg workload with lists of up to 4 x 8192 items over 80,000 entities,
   hash-sharded by ``distributed.shard_workload`` into 4 partitions of
   about 8192 items (about 0.4 GB each), one a rank of a (2, 2) mesh of 4
   gloo ranks spawned on the one card (NCCL refuses two ranks on one
   device); each rank runs kg-specqp's ``serve_step`` on the 32 queries
   in specqp and trinit modes, exact and then sketch, with the counters
   set to 0 just before each and read just after, then the step's plan,
   local rank join and merge apart, each timed. Checked: every rank's
   result equal; exact masks equal to the single-device plans over the
   unsharded store; the merged top-k equal to the reference's two-level
   stable top-k of the ranks' local results
   (``engine.run_query_batch_with_masks`` on each shard under the step's
   plans), n_pulled and n_answers their sums, n_iters their maximum;
   specqp with rings uncapped equal, on all 32 queries, to the one-device
   engine over the unsharded store under the same plans (scores rtol
   1e-5, keys wherever no near-tie); TriniT with rings uncapped equal to
   ``naive_full_scan`` on 4 queries. Then 32 retrieval
   queries through the sharded ``retrieve`` over phase 5's corpus split in
   4, each top-100 equal to the unsharded ``retrieve`` (indices exactly,
   scores rtol 1e-5); then the serve step under NCCL at world size 1 over
   phase 4's whole store, equal to ``engine.run_query_batch`` on it and to
   phase 4's offline pass. A failing rank fails the run;
10. training: the two-tower model at the published widths with the
   vocab cut to 10 M a table and the batch to 16,384 (the state of 20 M
   tables, 123 GB, does not fit the card), ``TRAIN_CFG`` (bf16 moments).
   Before the optimizer state exists, ``embedding_bag_backward`` is held
   against its plain version on the first batch's own ids and dout for
   each table, then on a quarter of the slots -1, hot ids (every bag
   repeating one of 64 ids, values on a dyadic grid so the sums are exact
   and the kernel must be bit-equal), ids above 2**23 and the weights'
   gradient, each case twice (touched rows within rtol 1e-5 atol 1e-6,
   every other row exactly 0), and timed by graph replay beside the
   (V, D) zero-fill, its bound, the plain version and F.embedding_bag's
   backward. Then 6 steps of ``make_train_step`` on the example's batches
   with the counters set to 0 just before and read just after (2
   ``embedding_bag`` and 2 ``embedding_bag_backward`` launches a step),
   each step timed, the last split into gradients, global norm and
   update, peak memory printed. Then ``examples/train_retrieval.py``'s
   ``main`` at its defaults with failures injected before and after the
   first checkpoint (restores read back bit for bit, the loss falls, the
   final loss within rtol 1e-3 of a run without failures, the speculative
   top-10 exact), and one gat-cora train step at the ``full_graph_sm``
   shape, its gradients held against the CPU's;
11. print the kernel table as one JSON line (``launches``: each kernel's
   count on its own path, so 0 for ``neigh_softmax_agg`` on
   ``gat.apply``, and phase 10's steps for ``embedding_bag_backward``;
   ``neigh_softmax_agg``'s ``check_launches`` are those of the drive over
   the layers' data; rows 1-3 add ``sharded_launches``, summed over phase
   9's ranks), then the result line ``{"ok": true, "device": {...}}``
   last.

It exits non-zero without CUDA and when ``src/repro_torch`` is not beside
it. It imports nothing of JAX. ``--attention-only`` runs phases 1-2 and
phase 7's ``flash_attention`` checks and timings, then stops without the
result line; ``--kg-only`` runs phases 1-3 and stops the same way;
``--gather-only`` runs phases 1-2 and the checks and timings of
``embedding_bag`` (phase 6's, on one table of the model's shape) and of
``neigh_softmax_agg`` (phase 8's, with the NaN check), without the towers
or the graph, and stops the same way; ``--shard-only`` runs phases 1-2
and phase 9 (the NCCL run then checked against ``run_query_batch``
alone), and stops the same way; ``--train-only`` runs phases 1-2 and
phase 10, and stops the same way.
``--profile`` adds ``torch.profiler``
windows (device busy share, time by kernel) over one retrieval query in
each mode, the serving batches, one LM prefill with 4 decode steps, one
GAT forward and one specqp pass of the KG path.
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
BF16_FLOP_PER_S = 989e12   # dense bf16 on the tensor cores
LANES = 8
N_QUERIES = 32
SEED = 0
# two-tower serving: the serve_p99 batch, batches timed, corpus build chunk
SERVE_BATCH = 512
SERVE_BATCHES = 16
CORPUS_CHUNK = 65536
# Sketch estimates of the card against the port on the CPU: the bar of
# tests/test_torch_sketches.py (zeros and the 0.5 gate exactly equal).
SKETCH_ATOL, SKETCH_RTOL = 4e-3, 1e-5
# LM serving: prompts, prompt length (cut from prefill_32k's 32 x 32768),
# decode steps (cut from decode_32k's 128 x 32768), timed prefills
LM_BATCH = 4
LM_SEQ = 8192
LM_DECODE = 32
LM_PREFILLS = 3
# Model-level checks: the logits may move this many of their std between
# the kernel and the einsum attention (bf16 through 26 layers).
LM_LOGIT_TOL_STD = 0.1
# flash_attention checks: q is drawn N(0, 1) times this, k N(0, 1), so the
# logits scale * q.k have this std and reach the softcap of 50.
ATTN_LOGIT_STD = 25.0
# GNN inference: gat-cora's widths at this shape, timed forwards, the node
# chunk of the kernel's drive over each layer's own data, and the
# destination nodes the float64 oracle recomputes per layer
GNN_SHAPE = "ogb_products"
GNN_FORWARDS = 3
GNN_NODE_CHUNK = 65536
GNN_ORACLE_NODES = 4096
# neigh_softmax_agg and GAT checks: the reference's bar for the Pallas
# kernel (tests/test_kernels.py)
AGG_RTOL, AGG_ATOL = 1e-4, 1e-5
# (name, R, MAXD, D): the reference's test shapes, the GAT layer shapes
# (a node chunk x 8 heads, MAXD 56 as the ogb_products graph gives it),
# ragged and odd shapes, the kernel's edges (one slot a row, a row of
# exactly one pass of 64 slots and of three, rows split over column
# tiles, features one float past a 16-byte boundary, which the kernel
# reads in single floats), and more than 2**31 feature floats (8.6 GB)
AGG_CASES = [("test", 64, 16, 32), ("test", 130, 8, 64),
             ("layer 0", GNN_NODE_CHUNK * 8, 56, 8),
             ("layer 1", GNN_NODE_CHUNK * 8, 56, 47),
             ("ragged", 100_003, 56, 47), ("ragged", 100_003, 56, 8),
             ("odd", 777, 33, 10), ("wide", 1000, 100, 100),
             ("D=1", 513, 3, 1), ("MAXD=1", 1001, 1, 8),
             ("MAXD=64", 4001, 64, 8), ("three passes", 5003, 129, 47),
             ("column tiles", 301, 20, 1030), ("D=130", 999, 56, 130),
             ("unaligned", 100_003, 56, 8),
             ("no rows", 0, 56, 47), ("2**31+", 820_000, 56, 47)]


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


def graph_ms(torch, fn, blocks: int = 15, per_block: int = 20) -> float:
    """Device time of one call in ms: ``per_block`` calls captured in a CUDA
    graph, its replays timed with CUDA events (median). The host's work per
    call (argument checks, allocation, the launch itself) is not in it, so
    a kernel of a few microseconds is timed, not the host's issue rate."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_block):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(blocks):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_block)
    times.sort()
    return times[len(times) // 2]


def empty_launch_ms(torch) -> float:
    """Device time of an empty kernel launched as ``graph_ms`` launches."""
    import ctypes
    from repro_torch.kernels import _build

    fn = _build.load("empty").empty_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return graph_ms(torch, lambda: fn(torch.cuda.current_stream().cuda_stream))


def engine_windows(np, torch, dev, rng, block: int):
    """(LANES, R1, block) windows as the KG path's pull gives them: the
    kg-specqp workload's source lists, weight-scaled, each lane's stream
    cut at random cursors by ``operators.block_windows``."""
    from repro_torch.configs import kg_specqp
    from repro_torch.core import operators
    from repro_torch.data import kg_synth

    wl = kg_synth.make_workload("xkg", list_len=kg_specqp.L_SHARD,
                                n_queries=N_QUERIES,
                                n_relax=kg_specqp.N_RELAX, seed=SEED,
                                device=dev)
    pids = torch.stack([torch.as_tensor(np.asarray(q)) for q in
                        wl.queries[:LANES]]).to(dev)
    mask = torch.ones(pids.shape + (wl.relax.ids.shape[1],), dtype=torch.bool,
                      device=dev)
    streams = operators.gather_streams(wl.store, wl.relax, pids, mask)
    lane = torch.arange(LANES, device=dev)
    keys, scores = streams.keys[lane, 0], streams.scores[lane, 0]
    lengths = streams.lengths[lane, 0]
    cursors = (torch.from_numpy(rng.random(lengths.shape)).to(dev)
               * lengths * 1.2).long().clamp(max=lengths)
    # Lane 0 near every list's end: fewer than `block` items are left, so
    # the pull takes -inf padding.
    cursors[0] = (lengths[0] - 20).clamp(min=0)
    return operators.block_windows(keys, scores, lengths, cursors, block)


def same(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_kernels(np, torch, ops, dev):
    """Phase 3: each KG kernel vs its plain version at main-path shapes,
    every case run twice; device times (CUDA graph), per-call times
    (back-to-back calls), bounds and the empty-launch floor."""
    rng = np.random.default_rng(SEED)
    rows = {}
    floor_ms = empty_launch_ms(torch)
    print(f"empty kernel launch: {floor_ms:.4f} ms of device time (graph "
          f"replay), the floor under every launch")

    def lookup_case(label, args, unique=True):
        got = ops.rank_join_lookup(*args)
        again = ops.rank_join_lookup(*args)
        want = ops.rank_join_lookup(*args, impl="ref")
        torch.cuda.synchronize()
        twice = same(torch, got, again)
        if unique:
            if not (same(torch, got, want) and twice):
                fail(f"rank_join_lookup {label}: differs from its plain "
                     f"version or between two runs")
            print(f"rank_join_lookup {label}: bit-equal to plain, twice")
            return got, want
        close = torch.allclose(got[0], want[0], rtol=1e-6, atol=0.0)
        if not (torch.equal(got[1], want[1]) and close):
            fail(f"rank_join_lookup {label}: found differs or scores beyond "
                 f"rtol 1e-6 of its plain version")
        print(f"rank_join_lookup {label}: found equal to plain, scores "
              f"within rtol 1e-6 (max abs err "
              f"{float((got[0] - want[0]).abs().max()):.3g}); two runs "
              f"bit-equal: {twice}")
        return got, want

    # rank_join_lookup: lanes × (1 + T) rings at T = 4, then ring lengths
    # that are not a multiple of the kernel's chunks (5000) and not even of
    # its 16-byte loads (5001: every load is a 4-byte one).
    for G, N, B in ((LANES * 5, 16384, 256), (LANES, 5000, 256),
                    (LANES, 5001, 256)):
        args = lookup_inputs(np, torch, rng, G, N, B, dev)
        shape = f"G={G} N={N} B={B}"
        (ks, kf), (rs, _) = lookup_case(shape, args)
        if not kf.any():
            fail("rank_join_lookup test data found nothing")
        keys, scores, probes, cnt = args
        dup = probes.clone()
        dup[:, B // 2:B // 2 + B // 4] = dup[:, :B // 4]
        lookup_case(f"{shape}, duplicate probe keys",
                    (keys, scores, dup, cnt))
        lookup_case(f"{shape}, every probe PAD",
                    (keys, scores, torch.full_like(probes, -1), cnt))
        # Four live slots of every ring take the key of another live one.
        dkeys = keys.clone()
        live = cnt.clamp(min=1, max=N).long()
        src = (torch.from_numpy(rng.random((G, 4))).to(dev) * live[:, None]
               ).long()
        dst = (torch.from_numpy(rng.random((G, 4))).to(dev) * live[:, None]
               ).long()
        dkeys.scatter_(1, dst, dkeys.gather(1, src))
        dprobes = probes.clone()
        dprobes[:, :4] = dkeys.gather(1, src)
        pos = torch.arange(N, device=dev)
        valid = (dkeys != -1) & (pos[None, :] < cnt[:, None])
        multi = int(((dprobes[:, :4, None] == dkeys[:, None, :])
                     & valid[:, None, :]).sum(-1).ge(2).sum())
        if not multi:
            fail("rank_join_lookup: no probe matches a duplicated live key")
        lookup_case(f"{shape}, duplicate live ring keys ({multi} probes "
                    f"match two or more live slots)",
                    (dkeys, scores, dprobes, cnt), unique=False)
        if N == 16384:
            live = cnt.clamp(min=0, max=N).long()
            nonpad = (probes != -1).sum(-1)
            compares = int((live * nonpad).sum())
            nbytes = int(live.sum()) * 8 + G * B * 4 + G * 4 + G * B * 5
            rows["rank_join_lookup"] = dict(
                name="rank_join_lookup", route="cuda",
                source="src/repro_torch/kernels/csrc/rank_join.cu",
                replaces="src/repro/kernels/rank_join.py:48",
                max_abs_err=float((ks - rs).abs().max()),
                ms=graph_ms(torch, lambda: ops.rank_join_lookup(*args)),
                call_ms=cuda_ms(torch, lambda: ops.rank_join_lookup(*args)),
                plain_ms=cuda_ms(torch, lambda: ops.rank_join_lookup(
                    *args, impl="ref"), blocks=5, per_block=2),
                bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes",
                compare_bound_ms=1e3 * compares / FP32_OPS_PER_S,
                floor_ms=floor_ms, library_ms=None, shape=shape)
            # Device time by ring fill: every ring empty (the clusters
            # leave at once), 4 live slots (table and barriers, no
            # stream), and every ring full.
            fills = {label: torch.full_like(cnt, fill) for label, fill in
                     (("empty", 0), ("4 slots", 4), ("full", N))}
            rows["rank_join_lookup"]["by_fill_ms"] = {
                label: graph_ms(torch, lambda: ops.rank_join_lookup(
                    keys, scores, probes, c_)) for label, c_ in fills.items()}

    # merge_topk: one group per lane, R1 = 11 windows of W = block = 256:
    # scores on a coarse grid (many ties, every row out of order) with
    # -inf tails; the KG path's own windows (sorted rows); and those with a
    # third of their rows shuffled.
    G, R, W, block = LANES, 11, 256, 256
    wk = torch.from_numpy(rng.integers(0, 20000, (G, R, W)).astype(
        np.int32)).to(dev)
    ws_np = (rng.integers(0, 64, (G, R, W)) / 64.0).astype(np.float32)
    ws_np[:, 3:, -40:] = -np.inf
    ws = torch.from_numpy(ws_np).to(dev)
    ek, es = engine_windows(np, torch, dev, rng, block)
    if tuple(ek.shape) != (G, R, W):
        fail(f"engine windows of shape {tuple(ek.shape)}, not {(G, R, W)}")
    mixed = es.clone()
    for g in range(G):
        for r in rng.choice(R, R // 3, replace=False):
            mixed[g, r] = mixed[g, r, torch.randperm(
                W, generator=torch.Generator().manual_seed(int(g * R + r)))]
    cases = {"unsorted": (wk, ws), "engine": (ek, es), "mixed": (ek, mixed)}
    for label, (k_, s_) in cases.items():
        rows_in_order = int((s_[..., :-1] >= s_[..., 1:]).all(-1).sum())
        got = ops.merge_topk(k_, s_, block)
        again = ops.merge_topk(k_, s_, block)
        want = ops.merge_topk(k_, s_, block, impl="ref")
        torch.cuda.synchronize()
        if not (same(torch, got, want) and same(torch, got, again)):
            fail(f"merge_topk {label} windows differ from the plain version "
                 f"or between two runs")
        print(f"merge_topk G={G} R={R} W={W} block={block}, {label} windows "
              f"({rows_in_order} of {G * R} rows in order, "
              f"{int(torch.isinf(got[1]).sum())} -inf taken): bit-equal to "
              f"plain, twice")
    n = R * W
    nbytes = G * n * 8 + G * block * 12
    compares = G * n * math.ceil(math.log2(block))
    t_unsorted = graph_ms(torch, lambda: ops.merge_topk(wk, ws, block))
    rows["merge_topk"] = dict(
        name="merge_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/merge_topk.cu",
        replaces="src/repro/kernels/merge_topk.py:30", max_abs_err=float(
            (got[1] - want[1]).nan_to_num(0.0, 0.0, 0.0).abs().max()),
        ms=graph_ms(torch, lambda: ops.merge_topk(ek, es, block)),
        unsorted_ms=t_unsorted,
        call_ms=cuda_ms(torch, lambda: ops.merge_topk(ek, es, block)),
        plain_ms=cuda_ms(torch, lambda: ops.merge_topk(ek, es, block,
                                                       impl="ref")),
        bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S,
                           compares / FP32_OPS_PER_S),
        bound_by=("bytes" if nbytes / HBM_BYTES_PER_S >
                  compares / FP32_OPS_PER_S else "operations"),
        library_ms=graph_ms(torch, lambda: torch.topk(es.view(G, -1), block,
                                                      dim=-1)),
        library_call_ms=cuda_ms(torch, lambda: torch.topk(es.view(G, -1),
                                                          block, dim=-1)),
        floor_ms=floor_ms, shape=f"G={G} R={R} W={W} block={block}")
    for k in rows.values():
        lib = ("" if k["library_ms"] is None else
               f", torch.topk {k['library_ms']:.4f} ms (per call "
               f"{k['library_call_ms']:.4f})")
        extra = (f", old compare bound {k['compare_bound_ms']:.5f} ms; "
                 f"by ring fill " + ", ".join(
                     f"{f} {t:.4f} ms" for f, t in k["by_fill_ms"].items())
                 if "compare_bound_ms" in k else
                 f", unsorted windows {k['unsorted_ms']:.4f} ms")
        print(f"{k['name']} ({k['shape']}): device {k['ms']:.4f} ms, per "
              f"call {k['call_ms']:.4f} ms, plain {k['plain_ms']:.4f} ms"
              f"{lib}, bound {k['bound_ms']:.5f} ms ({k['bound_by']}), "
              f"empty launch {k['floor_ms']:.4f} ms{extra}")
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

    plan_spans = record_spans(execs["specqp"], "plan_group")
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
    if not (launches["rank_join_lookup"] > 0 and launches["merge_topk"] > 0):
        fail(f"a kernel of the KG path was never launched: {launches}")

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
    precision = precision_vs(np, served["specqp"], served["trinit"])
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
    report["specqp"]["plan_groups_s"] = [b - a for a, b in plan_spans]
    return launches, report, dict(wl=wl, queries=queries, bcfg=bcfg,
                                  served=served, cpu=(store_c, relax_c),
                                  cpu_queries=order[:2].tolist())


def record_spans(obj, name: str) -> list:
    """Wrap the method ``name`` of ``obj`` so each call logs its (start,
    end) on the host clock; returns the log."""
    spans, fn = [], getattr(obj, name)

    def wrapped(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            spans.append((t0, time.perf_counter()))

    setattr(obj, name, wrapped)
    return spans


def overlap_s(spans_a, spans_b) -> float:
    """Seconds in which a span of one log and a span of the other overlap
    (spans within a log do not overlap each other)."""
    return sum(max(0.0, min(a1, b1) - max(a0, b0))
               for a0, a1 in spans_a for b0, b1 in spans_b)


def precision_vs(np, got, ref) -> float:
    """Mean share of each reference top-k found in the other's top-k."""
    return float(np.mean([
        len(set(a.keys[a.keys >= 0]) & set(b.keys[b.keys >= 0]))
        / max(int((b.keys >= 0).sum()), 1) for a, b in zip(got, ref)]))


def check_same_results(np, label: str, got, want) -> None:
    """Keys, scores and work counters equal query by query."""
    if len(got) != len(want):
        fail(f"{label}: {len(got)} results for {len(want)} queries")
    for i, (g, w) in enumerate(zip(got, want)):
        same = (np.array_equal(g.keys, w.keys)
                and np.array_equal(g.scores, w.scores)
                and all(getattr(g, f) == getattr(w, f)
                        for f in ("n_pulled", "n_answers", "n_iters")))
        if not same:
            fail(f"{label}: query {i} differs from the offline pass")


def path_launches(ops, label: str) -> dict:
    """The counts since the last reset; fails unless both KG kernels ran."""
    launches = ops.launches()
    if not (launches["rank_join_lookup"] > 0 and launches["merge_topk"] > 0):
        fail(f"{label}: a kernel of the KG path was never launched: "
             f"{launches}")
    return launches


def latency_line(np, lat) -> str:
    return (f"p50 {float(np.percentile(lat, 50)) * 1e3:.1f} ms p99 "
            f"{float(np.percentile(lat, 99)) * 1e3:.1f} ms")


def online_path(np, torch, dev, report, st) -> None:
    """Phase 4, continued, on the kg-specqp store already on the card: the
    sketch planner through the offline refill executor, the pipelined
    plan/execute path in both cardinality modes, and a Poisson replay
    through the MicroBatcher at 0.5x and 0.9x of the offline specqp QPS,
    each with the counters set to 0 just before and read just after."""
    from repro_torch.configs import kg_specqp
    from repro_torch.core import engine, sketches
    from repro_torch.kernels import ops
    from repro_torch.launch import batching, serve

    wl, queries, bcfg, served = st["wl"], st["queries"], st["bcfg"], \
        st["served"]
    exact_cfg = kg_specqp.ENGINE
    sketch_cfg = dataclasses.replace(exact_cfg, cardinality_mode="sketch")

    # --- the sketch planner, offline ---
    ex = batching.BatchExecutor(wl.store, wl.relax, sketch_cfg, "specqp",
                                bcfg, device=dev)
    engine.plan_query_batch(wl.store, wl.relax, queries[0][None], sketch_cfg,
                            "specqp", dev)         # warm-up, off the clock
    torch.cuda.synchronize()
    spans = record_spans(ex, "plan_group")
    ops.reset_launches()
    sk_res, wall, lat = serve.serve_offline(ex, queries)
    torch.cuda.synchronize()
    launches = path_launches(ops, "sketch pass")
    ex_groups = report["specqp"]["plan_groups_s"]
    sk_groups = [b - a for a, b in spans]
    bits = sum(int((a.relax_mask == b.relax_mask).sum())
               for a, b in zip(sk_res, served["specqp"]))
    n_bits = sum(b.relax_mask.size for b in served["specqp"])
    whole = sum(int(np.array_equal(a.relax_mask, b.relax_mask))
                for a, b in zip(sk_res, served["specqp"]))
    print(f"sketch pass: {len(queries) / wall:.2f} QPS | "
          f"{latency_line(np, lat)} | mean n_pulled "
          f"{np.mean([r.n_pulled for r in sk_res]):.1f} | launches "
          f"{launches}")
    print(f"plan seconds in the serving passes, exact against sketch (W = "
          f"{wl.store.sketch.shape[-1]}, L = {wl.store.keys.shape[1]}; a "
          f"shape's first call on the machine included): total "
          f"{sum(ex_groups):.4f} s against {sum(sk_groups):.4f} s; per plan "
          f"group " + ", ".join(
              f"{a:.4f}/{b:.4f}" for a, b in zip(ex_groups, sk_groups)))
    # Warm, in turns: each plan group of the passes, median of 3 a mode.
    planners = {c: batching.BatchExecutor(wl.store, wl.relax, cfg, "specqp",
                                          bcfg, device=dev)
                for c, cfg in (("exact", exact_cfg), ("sketch", sketch_cfg))}
    warm = []
    for idxs in ex.by_t_bucket(queries):
        g = [queries[j] for j in idxs]
        t_b = ex._t_bucket(max(ex._true_t(q) for q in g))
        times = {c: [] for c in planners}
        for rep in range(4):
            for c, p in planners.items():
                t0 = time.perf_counter()
                p.plan_group(g, ex._m_bucket(len(g)))
                if rep:
                    times[c].append(time.perf_counter() - t0)
        warm.append((t_b, len(g), *(float(np.median(times[c]))
                                    for c in planners)))
    print("plan seconds warm, exact against sketch, per plan group (T "
          "bucket x queries: median of 3, in turns): " + ", ".join(
              f"T{t} x {n}: {a:.4f}/{b:.4f}" for t, n, a, b in warm)
          + f"; total {sum(w[2] for w in warm):.4f}/"
          f"{sum(w[3] for w in warm):.4f} s")
    print(f"sketch masks equal the exact plans on {bits}/{n_bits} (T, R) "
          f"bits ({100 * bits / n_bits:.2f} %) and {whole}/{len(queries)} "
          f"whole masks; precision vs capped trinit: sketch "
          f"{precision_vs(np, sk_res, served['trinit']):.4f}, exact "
          f"{precision_vs(np, served['specqp'], served['trinit']):.4f}")

    # The port on the CPU estimates what the card estimates.
    store_c, relax_c = st["cpu"]
    for i in st["cpu_queries"]:
        q = torch.from_numpy(queries[i][None]).long()
        for name, fn in (("cardinalities", sketches.sketch_cardinalities),
                         ("joinable counts",
                          sketches.sketch_joinable_counts)):
            card = fn(wl.store, wl.relax, q.to(dev), (q != -1).to(dev))
            cpu = fn(store_c, relax_c, q, q != -1)
            card = card if isinstance(card, tuple) else (card,)
            cpu = cpu if isinstance(cpu, tuple) else (cpu,)
            for a, b in zip(card, cpu):
                a, b = a.cpu().numpy(), b.numpy()
                if not (np.array_equal(a == 0, b == 0)
                        and np.array_equal(a < 0.5, b < 0.5)
                        and np.allclose(a, b, rtol=SKETCH_RTOL,
                                        atol=SKETCH_ATOL)):
                    fail(f"query {i}: sketch {name} on the CPU differ from "
                         f"the card's (max gap {np.abs(a - b).max()})")
    print(f"card and CPU sketch estimates agree on queries "
          f"{st['cpu_queries']} (zeros and the 0.5 gate equal, atol "
          f"{SKETCH_ATOL} rtol {SKETCH_RTOL})")

    # --- pipelined plan/execute, both cardinality modes ---
    pipe = dataclasses.replace(bcfg, pipeline=True)
    for card, cfg, want in (("exact", exact_cfg, served["specqp"]),
                            ("sketch", sketch_cfg, sk_res)):
        ex = batching.BatchExecutor(wl.store, wl.relax, cfg, "specqp", pipe,
                                    device=dev)
        plans = record_spans(ex, "plan_group")
        runs = record_spans(ex, "run_stream")
        ops.reset_launches()
        res, wall, lat = serve.serve_offline(ex, queries)
        torch.cuda.synchronize()
        path_launches(ops, f"pipelined {card} pass")
        check_same_results(np, f"pipelined {card} pass", res, want)
        print(f"pipelined {card}: {len(queries) / wall:.2f} QPS | "
              f"{latency_line(np, lat)} | planner "
              f"{sum(b - a for a, b in plans):.4f} s in {len(plans)} "
              f"groups, {overlap_s(plans, runs):.4f} s of it under "
              f"execution | results equal the offline pass")

    # --- online: Poisson arrivals through the MicroBatcher ---
    base_qps = report["specqp"]["qps"]
    for frac in (0.5, 0.9):
        rate = frac * base_qps
        ex = batching.BatchExecutor(wl.store, wl.relax, exact_cfg, "specqp",
                                    bcfg, device=dev)
        ops.reset_launches()
        try:
            res, wall, lat = serve.serve_online(ex, queries, rate, SEED)
        except Exception as e:  # noqa: BLE001 — a future held an error
            fail(f"online replay at {rate:.3f}/s: {e!r}")
        launches = path_launches(ops, f"online replay at {rate:.3f}/s")
        check_same_results(np, f"online replay at {rate:.3f}/s", res,
                           served["specqp"])
        print(f"online {frac:g}x ({rate:.3f} arrivals/s): "
              f"{len(queries) / wall:.2f} QPS | {latency_line(np, lat)} | "
              f"{len(ex.stats)} executor calls, mean "
              f"{np.mean([s.n_requests for s in ex.stats]):.2f} requests | "
              f"launches {launches['rank_join_lookup']} + "
              f"{launches['merge_topk']} | results equal the offline pass")
    # close() serves what is still queued: submit all, close at once.
    ex = batching.BatchExecutor(wl.store, wl.relax, exact_cfg, "specqp",
                                bcfg, device=dev)
    ops.reset_launches()
    mb = batching.MicroBatcher(ex)
    futs = [mb.submit(q) for q in queries]
    t0 = time.perf_counter()
    mb.close()
    drained = time.perf_counter() - t0
    path_launches(ops, "drain on close")
    if mb._thread.is_alive() or not all(f.done() for f in futs):
        fail("MicroBatcher.close() returned with requests unresolved")
    errors = [f.exception() for f in futs if f.exception() is not None]
    if errors:
        fail(f"MicroBatcher.close(): a future holds {errors[0]!r}")
    check_same_results(np, "drain on close", [f.result() for f in futs],
                       served["specqp"])
    print(f"close() drained {len(futs)} queued requests in {drained:.2f} s "
          f"({len(ex.stats)} executor calls); results equal the offline "
          f"pass")


def profile_window(torch, label: str, fn) -> list:
    """``fn`` under torch.profiler: the device's busy share of the wall
    time and the device time by kernel. Only device-side events count: a
    CPU-side op's self device time is that of the kernels it launched,
    which the trace also holds as events of their own. Returns (name, ms,
    calls) of every device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e6
    if not events:
        print(f"profile ({label}): the trace holds no device time (not "
              "measured)")
        return []
    print(f"profile ({label}, {wall:.4f} s wall under the profiler): "
          f"device busy {busy:.4f} s = {100 * busy / wall:.2f} % of wall")
    for e in sorted(events, key=dev_us, reverse=True)[:15]:
        print(f"  {dev_us(e) / 1e3:10.3f} ms  {e.count:7d} calls  "
              f"{e.key[:90]}")
    return [(e.key, dev_us(e) / 1e3, e.count) for e in events]


def profile_main_path(np, torch, dev, wl, queries, bcfg) -> None:
    """One specqp serving pass of the KG path under torch.profiler."""
    from repro_torch.configs import kg_specqp
    from repro_torch.launch import batching

    ex = batching.BatchExecutor(wl.store, wl.relax, kg_specqp.ENGINE,
                                "specqp", bcfg, device=dev)
    events = profile_window(torch, "specqp pass", lambda: ex.run(queries))
    for kernel in ("rank_join_lookup_kernel", "merge_topk_kernel"):
        ms = sum(t for key, t, _ in events if kernel in key)
        calls = sum(n for key, _, n in events if kernel in key)
        print(f"profile (specqp pass): {kernel} {ms:.3f} ms of device time "
              f"over {calls} launches")


def bound(nbytes: float, ops_count: float) -> tuple[float, str]:
    """Least time in ms for the work, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_count / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def stable_topk(torch, scores, k: int):
    """lax.top_k over the last axis by a full stable sort (the oracle)."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k + 1], i[..., :k + 1]


def agrees_with_exact(torch, got_s, got_i, exact_s, exact_i, k: int):
    """(scores within rtol 1e-5, indices equal at every place whose exact
    score is more than 1e-5 relative from both neighbours, such places).
    exact_* hold k + 1 places so the k-th place's lower neighbour is
    known; a closer pair may swap when dots are summed in another order."""
    if not torch.allclose(got_s, exact_s[..., :k], rtol=1e-5, atol=0.0):
        return False, 0
    gap = (exact_s[..., :-1] - exact_s[..., 1:]).abs() > (
        1e-5 * exact_s[..., :-1].abs())
    clear = gap[..., :k].clone()
    clear[..., 1:] &= gap[..., :k - 1]
    same = got_i.long() == exact_i[..., :k]
    return bool((same | ~clear).all()), int(clear.sum())


def tiles_read(dev):
    """Tiles the last ``topk_score_pruned`` kernel launch read (None on the
    CPU, whose plain version reads every tile it counts)."""
    from repro_torch.kernels import topk_score

    if dev.type != "cuda":
        return None
    return int(topk_score.topk_score_pruned.last_tiles_read)


def clustered_corpus(np, torch, dev, gen, cfg):
    """The retrieval_cand corpus: N_CAND rows of normal(D)·mag/√D, mag
    geomspace(4.0, 0.1) over the full tiles and the remainder (blocks
    norm-sorted as an ANN index lays them out), zero rows to N_CAND_PAD."""
    from repro_torch.configs import two_tower_retrieval as tt

    d, tile = cfg.embed_dim, tt.TILE
    n_full, rem = divmod(tt.N_CAND, tile)
    mags = torch.from_numpy(np.geomspace(4.0, 0.1, n_full + 1).astype(
        np.float32)).to(dev)
    per_row = torch.cat([mags[:n_full].repeat_interleave(tile),
                         mags[n_full:].expand(rem)])
    cand = torch.zeros((tt.N_CAND_PAD, d), device=dev)
    cand[:tt.N_CAND] = torch.randn((tt.N_CAND, d), generator=gen,
                                   device=dev)
    cand[:tt.N_CAND] *= (per_row / math.sqrt(d))[:, None]
    return cand


def retrieval_path(np, torch, ops, dev, prof: bool = False):
    """Phase 5: topk_score_pruned against its plain version at the
    retrieval_cand shape (Cauchy, infinite, unsound and shuffled-tile
    cases), then 32 queries through ``retrieve`` (and the score-everything
    baseline) with the launch counters read around them; every top-100 is
    checked against the exact full scan."""
    from repro_torch.configs import two_tower_retrieval as tt
    from repro_torch.models import recsys

    cfg = tt.config()
    k, tile = tt.TOPK, tt.TILE
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    cand = clustered_corpus(np, torch, dev, gen, cfg)
    queries = torch.randn((N_QUERIES, cfg.embed_dim), generator=gen,
                          device=dev)
    torch.cuda.synchronize()
    n_tiles = cand.shape[0] // tile
    print(f"retrieval corpus: {cand.shape[0]} x {cand.shape[1]} f32 "
          f"({cand.numel() * 4 / 1e9:.3f} GB, {n_tiles} tiles of {tile}), "
          f"made on the card in {time.perf_counter() - t0:.2f} s")

    # Kernel vs plain version on query 0: Cauchy and infinite bounds,
    # unsound ones (Cauchy x 0.25) and the corpus's tiles in shuffled norm
    # order (Cauchy bounds of that corpus); then a second run, bit-equal.
    q = queries[0]
    cauchy = ops.block_bounds_cauchy(q, cand, tile)
    perm = torch.randperm(n_tiles, generator=gen, device=dev)
    shuffled = cand.view(n_tiles, tile, -1)[perm].reshape(cand.shape)
    modes = {"cauchy": (cand, cauchy),
             "inf": (cand, torch.full_like(cauchy, math.inf)),
             "unsound": (cand, cauchy * 0.25),
             "shuffled": (shuffled, ops.block_bounds_cauchy(q, shuffled,
                                                            tile))}
    err, timing = 0.0, {}
    for mode, (c, b) in modes.items():
        ks, ki, kn = ops.topk_score_pruned(q, c, b, k, tile)
        read = tiles_read(dev)
        ks2, ki2, kn2 = ops.topk_score_pruned(q, c, b, k, tile)
        rs, ri, rn = ops.topk_score_pruned(q, c, b, k, tile, impl="ref")
        torch.cuda.synchronize()
        if int(kn) != int(rn) or not torch.equal(ki, ri):
            fail(f"topk_score_pruned ({mode} bounds) differs from its plain "
                 f"version: {int(kn)} vs {int(rn)} tiles scored")
        if not torch.allclose(ks, rs, rtol=1e-5, atol=0.0):
            fail(f"topk_score_pruned ({mode} bounds) scores differ")
        if not (torch.equal(ks, ks2) and torch.equal(ki, ki2)
                and int(kn) == int(kn2)):
            fail(f"topk_score_pruned ({mode} bounds): two runs differ")
        err = max(err, float((ks - rs).abs().max()))
        scored = int(kn)
        nbytes = scored * tile * cfg.embed_dim * 4 + n_tiles * 4 + (
            cfg.embed_dim * 4 + k * 8 + 4)
        timing[mode] = dict(
            scored=scored, read=read,
            ms=cuda_ms(torch, lambda: ops.topk_score_pruned(q, c, b, k,
                                                            tile),
                       blocks=7, per_block=3),
            bound=bound(nbytes, scored * tile * 2 * cfg.embed_dim))
        if mode in ("cauchy", "inf"):
            timing[mode]["plain_ms"] = cuda_ms(
                torch, lambda: ops.topk_score_pruned(q, c, b, k, tile,
                                                     impl="ref"),
                blocks=3, per_block=1)
        print(f"topk_score_pruned N={cand.shape[0]} D={cfg.embed_dim} "
              f"tile={tile} k={k}, {mode} bounds: {scored}/{n_tiles} tiles "
              f"counted, {read} read; count and indices equal to plain, "
              f"scores rtol 1e-5; a second run bit-equal")
    del shuffled, modes
    library_ms = cuda_ms(torch, lambda: torch.topk(cand @ q, k))
    bounds_ms = cuda_ms(torch, lambda: ops.block_bounds_cauchy(q, cand,
                                                               tile))
    for mode, t in timing.items():
        plain = (f"plain {t['plain_ms']:.4f} ms, " if "plain_ms" in t
                 else "")
        print(f"  {mode}: kernel {t['ms']:.4f} ms, {plain}bound "
              f"{t['bound'][0]:.5f} ms ({t['bound'][1]}, "
              f"{100 * t['bound'][0] / t['ms']:.1f} % of it); library "
              f"(matmul + topk, all tiles) {library_ms:.4f} ms")
    print(f"  block_bounds_cauchy alone: {bounds_ms:.4f} ms")
    row = dict(name="topk_score_pruned", route="cuda",
               source="src/repro_torch/kernels/csrc/topk_score.cu",
               replaces="src/repro/kernels/topk_score.py:63",
               max_abs_err=err, ms=timing["cauchy"]["ms"],
               plain_ms=timing["cauchy"]["plain_ms"],
               bound_ms=timing["cauchy"]["bound"][0],
               bound_by=timing["cauchy"]["bound"][1], library_ms=library_ms,
               tiles_read=timing["cauchy"]["read"],
               inf_ms=timing["inf"]["ms"],
               inf_bound_ms=timing["inf"]["bound"][0],
               block_bounds_cauchy_ms=bounds_ms,
               shape=f"N={cand.shape[0]} D={cfg.embed_dim} tile={tile} "
                     f"k={k}, Cauchy bounds")

    # The path: 32 queries, speculative and score-everything.
    ops.reset_launches()
    res = {"speculative": [], "baseline": []}
    for qi in range(N_QUERIES):
        q = queries[qi]
        for mode in res:
            t0 = time.perf_counter()
            if mode == "speculative":
                out = tt.retrieve(q, cand, k, tile)
            else:
                out = recsys.score_candidates(None, cfg, q, cand, k,
                                              speculative=False)
            torch.cuda.synchronize()
            res[mode].append((*out, time.perf_counter() - t0))
    launches = ops.launches()
    print(f"retrieval path launches: {launches}")
    if launches["topk_score_pruned"] != 2 * N_QUERIES:
        fail(f"retrieval did not launch topk_score_pruned once a query "
             f"and mode: {launches}")

    clear_total = 0
    for qi in range(N_QUERIES):
        es, ei = stable_topk(torch, cand @ queries[qi], k)
        for mode, r in res.items():
            s, i, n, _ = r[qi]
            ok, clear = agrees_with_exact(torch, s, i, es, ei, k)
            if not ok:
                fail(f"retrieval query {qi} ({mode}) differs from the exact "
                     "top-100")
            clear_total += clear
        cnt = ops.topk_score_pruned(
            queries[qi], cand, ops.block_bounds_cauchy(queries[qi], cand,
                                                       tile),
            k, tile, impl="ref")[2]
        if int(cnt) != int(res["speculative"][qi][2]):
            fail(f"retrieval query {qi}: {int(res['speculative'][qi][2])} "
                 f"tiles scored, the plain version {int(cnt)}")
        spec, base = res["speculative"][qi], res["baseline"][qi]
        if not (torch.equal(spec[0], base[0]) and torch.equal(spec[1],
                                                               base[1])):
            fail(f"retrieval query {qi}: speculative and baseline differ")
    spec_lat = np.array([x[3] for x in res["speculative"]]) * 1e3
    for mode, r in res.items():
        lat = np.array([x[3] for x in r]) * 1e3
        tiles = np.array([int(x[2]) for x in r])
        print(f"retrieval {mode}: mean tiles scored {tiles.mean():.2f} of "
              f"{n_tiles} (min {tiles.min()}, max {tiles.max()}) | p50 "
              f"{np.percentile(lat, 50):.3f} ms p99 "
              f"{np.percentile(lat, 99):.3f} ms per query")
    print(f"retrieval: all {N_QUERIES} queries' top-{k} equal the exact "
          f"full scan in both modes (scores rtol 1e-5; indices equal at "
          f"{clear_total} of {2 * N_QUERIES * k} places with no near-tie, "
          f"the rest within rtol 1e-5); speculative == baseline bit for "
          f"bit; every query's tiles scored equal the plain version's")
    print(f"retrieval query p50 {np.percentile(spec_lat, 50):.3f} ms beside "
          f"the kernel's {row['ms']:.4f} ms and block_bounds_cauchy's "
          f"{bounds_ms:.4f} ms")
    if prof:
        profile_window(torch, "one speculative retrieval query",
                       lambda: tt.retrieve(queries[0], cand, k, tile))
        profile_window(torch, "one baseline retrieval query",
                       lambda: recsys.score_candidates(
                           None, cfg, queries[0], cand, k,
                           speculative=False))
    return row, launches


def user_batch(torch, cfg, B, gen, dev):
    """A serving batch: user ids uniform over the vocab, weights 1, dense
    features normal (as the reference's smoke batch draws them)."""
    return {"user_ids": torch.randint(0, cfg.user_vocab, (B, cfg.user_slots),
                                      generator=gen, device=dev,
                                      dtype=torch.int32),
            "user_w": torch.ones((B, cfg.user_slots), device=dev),
            "user_dense": torch.randn((B, cfg.n_dense_feat), generator=gen,
                                      device=dev)}


def check_embedding_bag(np, torch, ops, user_table, item_table, dev):
    """embedding_bag against its plain version (rtol/atol 1e-6) at the
    shapes the serving path launches it at, each case run twice and
    bit-equal: the user tower's (B=512, S=32) with a quarter of the slots
    -1, the corpus chunk (B=65,536, S=8, every slot live) on the item
    table, and (B=4096, S=8) with every id above 2**23 (64-bit row
    offsets). The two path shapes are timed by device time (CUDA-graph
    replay) beside the per-call time, an empty launch, the bound, the plain
    version and ``F.embedding_bag`` timed both ways, and once more with
    their ids drawn from the table's first GiB only, which tells the cost
    of the TLB's misses over the whole 20.5 GB table from DRAM latency."""
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED + 1)
    V, D = user_table.shape
    slice_rows = min(V, 2**30 // (4 * D))
    floor_ms = empty_launch_ms(torch)
    rows = {}
    for B, S, lo, tbl, dead in ((512, 32, 0, user_table, 0.25),
                                (CORPUS_CHUNK, 8, 0, item_table, 0.0),
                                (4096, 8, 2**23, item_table, 0.0)):
        ids_np = rng.integers(lo, V, (B, S)).astype(np.int32)
        ids_np[rng.random((B, S)) < dead] = -1
        ids = torch.from_numpy(ids_np).to(dev)
        w = torch.from_numpy(rng.random((B, S)).astype(np.float32)).to(dev)
        got = ops.embedding_bag(tbl, ids, w)
        again = ops.embedding_bag(tbl, ids, w)
        want = ops.embedding_bag(tbl, ids, w, impl="ref")
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-6, atol=1e-6):
            fail(f"embedding_bag differs from its plain version at B={B} "
                 f"S={S} (ids from {lo}): max abs err {e:.4g}")
        if not torch.equal(got, again):
            fail(f"embedding_bag B={B} S={S}: two runs differ")
        live = ids[ids >= 0]
        print(f"embedding_bag V={V} D={D} B={B} S={S} (ids from {lo}, "
              f"{int(live.numel())} live slots): within rtol/atol 1e-6 of "
              f"plain (max abs err {e:.3g}), two runs bit-equal")
        if lo:
            rows[(B, S)] = dict(max_abs_err=e)
            continue
        n_rows = int(torch.unique(live).numel())
        nbytes = n_rows * D * 4 + B * S * 8 + B * D * 4
        safe = torch.where(ids >= 0, ids, 0)
        w0 = torch.where(ids >= 0, w, 0.0)
        near = torch.from_numpy(np.where(ids_np >= 0, rng.integers(
            0, slice_rows, (B, S)), -1).astype(np.int32)).to(dev)
        rows[(B, S)] = dict(
            max_abs_err=e,
            ms=graph_ms(torch, lambda: ops.embedding_bag(tbl, ids, w)),
            call_ms=cuda_ms(torch, lambda: ops.embedding_bag(tbl, ids, w)),
            slice_ms=graph_ms(torch, lambda: ops.embedding_bag(tbl, near, w)),
            plain_ms=cuda_ms(torch, lambda: ops.embedding_bag(
                tbl, ids, w, impl="ref"), blocks=5, per_block=2),
            library_ms=graph_ms(torch, lambda: F.embedding_bag(
                safe, tbl, mode="sum", per_sample_weights=w0)),
            library_call_ms=cuda_ms(torch, lambda: F.embedding_bag(
                safe, tbl, mode="sum", per_sample_weights=w0)),
            bound=bound(nbytes, 2 * int(live.numel()) * D),
            shape=f"V={V} D={D} B={B} S={S}")
        del safe, w0, near
    for (B, S), r in rows.items():
        if "ms" not in r:
            continue
        b = r["bound"]
        print(f"embedding_bag {r['shape']}: device {r['ms']:.4f} ms "
              f"({100 * b[0] / r['ms']:.1f} % of the bound's rate), per call "
              f"{r['call_ms']:.4f} ms, ids in the first GiB "
              f"{r['slice_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"F.embedding_bag {r['library_ms']:.4f} ms (per call "
              f"{r['library_call_ms']:.4f}), bound {b[0]:.5f} ms ({b[1]}), "
              f"empty launch {floor_ms:.4f} ms")
    r, c = rows[(512, 32)], rows[(CORPUS_CHUNK, 8)]
    return dict(name="embedding_bag", route="cuda",
                source="src/repro_torch/kernels/csrc/embedding_bag.cu",
                replaces="src/repro/kernels/embedding_bag.py:33",
                max_abs_err=max(x["max_abs_err"] for x in rows.values()),
                ms=r["ms"], call_ms=r["call_ms"], slice_ms=r["slice_ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                bound_by=r["bound"][1], library_ms=r["library_ms"],
                library_call_ms=r["library_call_ms"], floor_ms=floor_ms,
                corpus_ms=c["ms"], corpus_call_ms=c["call_ms"],
                corpus_slice_ms=c["slice_ms"], corpus_plain_ms=c["plain_ms"],
                corpus_bound_ms=c["bound"][0],
                corpus_library_ms=c["library_ms"],
                corpus_library_call_ms=c["library_call_ms"],
                shape=f"{r['shape']}, a quarter of slots -1; corpus chunk "
                      f"{c['shape']}")


def serving_path(np, torch, ops, dev, prof: bool = False):
    """Phase 6: the full-width two-tower model on the card; embedding_bag
    checked on its tables; then, with the launch counters read around it,
    the 1,048,576-item corpus built through the item tower and 16 batches
    of 512 users served; one batch checked against a full-matrix top-k."""
    from repro_torch.configs import two_tower_retrieval as tt
    from repro_torch.models import recsys

    cfg = tt.config()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = recsys.init(cfg, seed=SEED, device=dev)
    model.requires_grad_(False)         # serving: no gradients
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"two-tower model {cfg.name}: {n_bytes / 1e9:.3f} GB of f32 "
          f"parameters initialised on the card in "
          f"{time.perf_counter() - t0:.2f} s (embed_dim {cfg.embed_dim}, "
          f"MLP {cfg.tower_mlp}, vocab {cfg.user_vocab} + {cfg.item_vocab})")
    row = check_embedding_bag(np, torch, ops, model.user.table,
                              model.item.table, dev)
    # The serving peak: the model and what serving allocates, not the
    # check's plain versions and timing graphs.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    batches = [user_batch(torch, cfg, SERVE_BATCH, gen, dev)
               for _ in range(SERVE_BATCHES + 1)]
    ops.reset_launches()
    t0 = time.perf_counter()
    cand = torch.empty((tt.CORPUS, cfg.embed_dim), device=dev)
    for c0 in range(0, tt.CORPUS, CORPUS_CHUNK):
        n = min(CORPUS_CHUNK, tt.CORPUS - c0)
        ids = torch.randint(0, cfg.item_vocab, (n, cfg.item_slots),
                            generator=gen, device=dev, dtype=torch.int32)
        dense = torch.randn((n, cfg.n_dense_feat), generator=gen,
                            device=dev)
        cand[c0:c0 + n] = recsys.tower(model.item, cfg, ids, torch.ones(
            (n, cfg.item_slots), device=dev), dense)
    torch.cuda.synchronize()
    corpus_s = time.perf_counter() - t0
    tt.serve(model, batches[0], cand, tt.TOPK)   # warm-up, off the clock
    torch.cuda.synchronize()
    # Per batch, what could make one slow: new device segments (cudaMalloc
    # calls by the caching allocator) and rows of _top_k's full-sort
    # fallback.
    lat, results, segs, sorts = [], [], [], []
    for b in batches[1:]:
        seg0 = torch.cuda.memory_stats(dev).get("segment.all.allocated", 0)
        sort0 = recsys._top_k.full_sorts
        t0 = time.perf_counter()
        results.append(tt.serve(model, b, cand, tt.TOPK))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        segs.append(torch.cuda.memory_stats(dev).get(
            "segment.all.allocated", 0) - seg0)
        sorts.append(recsys._top_k.full_sorts - sort0)
    launches = ops.launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    lat_ms = np.array(lat) * 1e3
    print(f"serving: corpus of {tt.CORPUS} items built through the item "
          f"tower in {corpus_s:.3f} s ({tt.CORPUS // CORPUS_CHUNK} chunks "
          f"of {CORPUS_CHUNK})")
    print(f"serving {SERVE_BATCHES} batches of {SERVE_BATCH} users, top-"
          f"{tt.TOPK} of {tt.CORPUS}: p50 {np.percentile(lat_ms, 50):.3f} ms "
          f"p99 {np.percentile(lat_ms, 99):.3f} ms per batch | "
          f"{SERVE_BATCHES * SERVE_BATCH / sum(lat):.1f} users/s | peak "
          f"allocated {peak_gb:.3f} GB")
    print(f"serving batch latencies (ms, in order): "
          f"{[round(x, 3) for x in lat_ms.tolist()]}")
    print(f"serving new device segments per batch: {segs}; rows of "
          f"_top_k's full-sort fallback per batch: {sorts}")
    print(f"serving path launches: {launches}")
    if launches["embedding_bag"] != tt.CORPUS // CORPUS_CHUNK + (
            SERVE_BATCHES + 1):
        fail(f"serving did not launch embedding_bag once a tower call: "
             f"{launches}")

    for (s, i) in results:
        if s.shape != (SERVE_BATCH, tt.TOPK) or not torch.isfinite(s).all():
            fail(f"serving result malformed: {tuple(s.shape)}")
        if not ((i >= 0) & (i < tt.CORPUS)).all():
            fail("serving returned an index outside the corpus")
    b, (s, i) = batches[1], results[0]
    u = recsys.tower(model.user, cfg, b["user_ids"], b["user_w"],
                     b["user_dense"])
    es, ei = stable_topk(torch, u @ cand.T, tt.TOPK)
    ok, clear = agrees_with_exact(torch, s, i, es, ei, tt.TOPK)
    if not ok:
        fail("the hierarchical top-k differs from the full-matrix top-k")
    print(f"serving: batch 0's hierarchical top-{tt.TOPK} equals the full "
          f"u @ cand.T top-{tt.TOPK} (scores rtol 1e-5; indices equal at "
          f"{clear} of {SERVE_BATCH * tt.TOPK} places with no near-tie; "
          f"bit-equal: {torch.equal(s, es[:, :tt.TOPK])} and "
          f"{torch.equal(i.long(), ei[:, :tt.TOPK])})")
    if prof:
        profile_window(torch, f"{SERVE_BATCHES} serving batches of "
                       f"{SERVE_BATCH} users",
                       lambda: [tt.serve(model, b, cand, tt.TOPK)
                                for b in batches[1:]])
    return row, launches


def live_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """Visible (query, key) pairs of one (batch, head): the work the
    kernel must do for these shapes."""
    import numpy as np

    qp = Sk - Sq + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qp, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attn_bound(B, Hq, Hkv, Sq, Sk, D, causal, window) -> tuple[float, str]:
    """Least time in ms: 4·D flops per visible pair and head at the bf16
    tensor-core peak, against q, k, v read once and o written once."""
    flops = 4 * D * B * Hq * live_pairs(Sq, Sk, causal, window)
    nbytes = 2 * D * B * (2 * Hq * Sq + 2 * Hkv * Sk)
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attn_inputs(torch, gen, dev, B, Hq, Hkv, Sq, Sk, D):
    """bf16 q, k, v, normal; q × ATTN_LOGIT_STD, so that at scale D^-0.5
    the logits have that std and the softcap bends them hard."""
    def rnd(h, s, mul):
        return (torch.randn((B, h, s, D), generator=gen, device=dev)
                * mul).to(torch.bfloat16)
    return rnd(Hq, Sq, ATTN_LOGIT_STD), rnd(Hkv, Sk, 1.0), rnd(Hkv, Sk, 1.0)


def check_flash_attention(np, torch, ops, dev, cfg):
    """flash_attention against its plain version (f32 math on the same
    bf16 inputs; rtol / atol 2e-2) at the model's layer shapes and at the
    kernel's edges, with logits of std ATTN_LOGIT_STD; every case run twice
    and bit-equal; a control shows that the kernel without its softcap lies
    outside that tolerance. Then timed at B = LM_BATCH beside its bound,
    the plain version and SDPA, and at starcoder2-3b's layer shape beside
    its bound and SDPA. Returns the kernel row (launches filled in
    later)."""
    import torch.nn.functional as F

    from repro_torch.configs import starcoder2_3b
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    Hq, Hkv, D, cap = cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.attn_softcap
    local = max(cfg.window_pattern)
    bn, bn128 = fa.TILE_N[D], fa.TILE_N[128]
    # (name, B, Hq, Hkv, Sq, Sk, D, causal, window, softcap, layout); the
    # layout "bshd" passes (B, S, H, D) activations as the model does.
    cases = [("global", 1, Hq, Hkv, LM_SEQ, LM_SEQ, D, True, 0, cap, ""),
             ("local", 1, Hq, Hkv, LM_SEQ, LM_SEQ, D, True, local, cap, ""),
             ("Sq<Sk", 2, Hq, Hkv, 100, 1000, D, True, 0, cap, ""),
             ("non-causal", 1, Hq, Hkv, 1024, 1024, D, False, 0, None, ""),
             ("D=128", 1, 24, 2, 2048, 2048, 128, True, 1024, None, ""),
             ("ragged", 1, Hq, Hkv, 8000, 8000, D, True, local, cap, ""),
             ("Sq, Sk off the tiles", 1, Hq, Hkv, 1000, 1234, D, True, 300,
              cap, ""),
             ("Sq=1", 2, Hq, Hkv, 1, 777, D, True, 0, cap, ""),
             ("Sq=17", 1, Hq, Hkv, 17, 500, D, True, 0, cap, ""),
             ("Sq=17, D=128", 1, 24, 2, 17, 300, 128, True, 0, None, ""),
             ("Sq>Sk", 1, Hq, Hkv, 700, 300, D, True, 0, cap, ""),
             ("Sq>Sk, D=128", 1, 4, 2, 500, 129, 128, True, 0, None, ""),
             *((f"window {w}", 1, Hq, Hkv, 600, 600, D, True, w, cap, "")
               for w in (1, bn - 1, bn, bn + 1)),
             *((f"window {w}, D=128", 1, 4, 2, 600, 600, 128, True, w, None,
                "") for w in (1, bn128 - 1, bn128, bn128 + 1)),
             ("GQA 1", 1, 4, 4, 700, 700, D, True, 0, cap, ""),
             ("GQA 12", 1, 24, 2, 700, 700, D, True, 0, cap, ""),
             ("GQA 12, D=128", 1, 24, 2, 700, 700, 128, True, 0, None, ""),
             ("(B, S, H, D)", 2, Hq, Hkv, 500, 500, D, True, 0, cap, "bshd"),
             ("(B, S, H, D), D=128", 2, 24, 2, 500, 500, 128, True, 64, None,
              "bshd")]
    err = 0.0
    for name, B, hq, hkv, Sq, Sk, d, causal, win, c, layout in cases:
        q, k, v = attn_inputs(torch, gen, dev, B, hq, hkv, Sq, Sk, d)
        if layout == "bshd":
            q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                       for t in (q, k, v))
        kw = dict(causal=causal, window=win, softcap=c)
        got = ops.flash_attention(q, k, v, **kw)
        again = ops.flash_attention(q, k, v, **kw)
        want = ops.flash_attention(q.float(), k.float(), v.float(),
                                   impl="ref", **kw)
        torch.cuda.synchronize()
        shape = (f"B={B} Hq={hq} Hkv={hkv} Sq={Sq} Sk={Sk} D={d} causal="
                 f"{causal} window={win} softcap={c} {layout}").strip()
        e = float((got.float() - want).abs().max())
        if not torch.allclose(got.float(), want, rtol=2e-2, atol=2e-2):
            fail(f"flash_attention ({name}: {shape}) differs from its plain "
                 f"version: max abs err {e:.4g}")
        if not torch.equal(got, again):
            fail(f"flash_attention ({name}: {shape}): two runs differ")
        if Sq > Sk and got[:, :, :Sq - Sk].abs().max() != 0:
            fail(f"flash_attention ({name}): a row with no visible key is "
                 f"not exactly 0")
        err = max(err, e)
        print(f"flash_attention {name} ({shape}): within rtol/atol 2e-2 of "
              f"plain (max abs err {e:.4g}), two runs bit-equal"
              + (", rows with no key exactly 0" if Sq > Sk else ""))
        if name == "global":
            # Control: a kernel that dropped the softcap would fail above.
            nocap = ops.flash_attention(q, k, v, causal=causal,
                                        window=win).float()
            torch.cuda.synchronize()
            e = float((nocap - want).abs().max())
            if torch.allclose(nocap, want, rtol=2e-2, atol=2e-2):
                fail(f"flash_attention without its softcap is within rtol/"
                     f"atol 2e-2 of the softcapped plain version (max abs "
                     f"err {e:.4g}): the checks cannot see the softcap")
            print(f"flash_attention control: the kernel without softcap is "
                  f"outside rtol/atol 2e-2 of the softcapped plain version "
                  f"(max abs err {e:.4g})")
            del nocap
        del q, k, v, got, again, want

    B, S = LM_BATCH, LM_SEQ
    q, k, v = attn_inputs(torch, gen, dev, B, Hq, Hkv, S, S, D)
    times = {}
    for name, win in (("global", 0), ("local", local)):
        kw = dict(window=win, softcap=cap)
        times[name] = dict(
            ms=cuda_ms(torch, lambda: ops.flash_attention(q, k, v, **kw),
                       blocks=5, per_block=2),
            plain_ms=cuda_ms(torch, lambda: ops.flash_attention(
                q, k, v, impl="ref", **kw), blocks=3, per_block=1),
            bound=attn_bound(B, Hq, Hkv, S, S, D, True, win))
        torch.cuda.empty_cache()
    nocap_ms = cuda_ms(torch, lambda: ops.flash_attention(q, k, v),
                       blocks=5, per_block=2)

    def sdpa(q, k, v):
        try:
            return cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), blocks=5,
                per_block=2)
        except RuntimeError as e:      # no SDPA backend for these inputs
            print(f"scaled_dot_product_attention refused the inputs: {e}")
            return None
    library_ms = sdpa(q, k, v)
    del q, k, v
    # starcoder2-3b's layer: 24 / 2 heads of 128, window 4096.
    sc = starcoder2_3b.config()
    sq, sk, sv = attn_inputs(torch, gen, dev, B, sc.n_heads, sc.n_kv, S, S,
                             sc.head_dim)
    swin = max(sc.window_pattern)
    d128 = dict(
        ms=cuda_ms(torch, lambda: ops.flash_attention(sq, sk, sv,
                                                      window=swin),
                   blocks=5, per_block=2),
        bound=attn_bound(B, sc.n_heads, sc.n_kv, S, S, sc.head_dim, True,
                         swin),
        global_ms=cuda_ms(torch, lambda: ops.flash_attention(sq, sk, sv),
                          blocks=5, per_block=2),
        global_bound=attn_bound(B, sc.n_heads, sc.n_kv, S, S, sc.head_dim,
                                True, 0),
        library_ms=sdpa(sq, sk, sv))
    del sq, sk, sv
    torch.cuda.empty_cache()
    # A masked slot's features are never read: NaN there must not reach
    # the output (the plain version, as the reference, gives NaN).
    logits = torch.randn((130, 56), generator=gen, device=dev) * 3.0
    feats = torch.randn((130, 56, 47), generator=gen, device=dev)
    mask = torch.rand((130, 56), generator=gen, device=dev) < 0.45
    got = ops.neigh_softmax_agg(
        logits, feats.masked_fill(~mask[..., None], float("nan")), mask)
    want = ops.neigh_softmax_agg(logits, feats, mask, impl="ref")
    if not torch.allclose(got, want, rtol=AGG_RTOL, atol=AGG_ATOL):
        fail("neigh_softmax_agg lets NaN features of masked slots through")
    print("neigh_softmax_agg: NaN features in masked slots do not reach the "
          "output")
    for name, t in times.items():
        b = t["bound"]
        print(f"flash_attention {name} layer (B={B} Hq={Hq} Hkv={Hkv} S={S} "
              f"D={D} softcap={cap}): kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), "
              f"{100 * b[0] / t['ms']:.1f} % of the bound's rate")
    print(f"flash_attention global layer without softcap: kernel "
          f"{nocap_ms:.4f} ms; scaled_dot_product_attention(is_causal, "
          f"enable_gqa) {library_ms} ms")
    b, gb = d128["bound"], d128["global_bound"]
    print(f"flash_attention {sc.name} layer (B={B} Hq={sc.n_heads} Hkv="
          f"{sc.n_kv} S={S} D={sc.head_dim} window={swin}): kernel "
          f"{d128['ms']:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), "
          f"{100 * b[0] / d128['ms']:.1f} % of the bound's rate; without "
          f"window: kernel {d128['global_ms']:.4f} ms, bound {gb[0]:.4f} ms, "
          f"{100 * gb[0] / d128['global_ms']:.1f} %, "
          f"scaled_dot_product_attention {d128['library_ms']} ms")
    g, lo = times["global"], times["local"]
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:90",
                max_abs_err=err, ms=g["ms"], plain_ms=g["plain_ms"],
                bound_ms=g["bound"][0], bound_by=g["bound"][1],
                library_ms=library_ms,
                library_vs="the kernel without softcap, nocap_ms",
                nocap_ms=nocap_ms, local_ms=lo["ms"],
                local_plain_ms=lo["plain_ms"], local_bound_ms=lo["bound"][0],
                d128_local_ms=d128["ms"], d128_local_bound_ms=b[0],
                d128_global_ms=d128["global_ms"],
                d128_global_bound_ms=gb[0],
                d128_library_ms=d128["library_ms"],
                shape=f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} softcap={cap}, "
                      f"global layer; d128_*: {sc.name}'s layer, B={B} "
                      f"Hq={sc.n_heads} Hkv={sc.n_kv} S={S} D={sc.head_dim}")


def lm_path(np, torch, ops, dev, prof: bool = False):
    """Phase 7: gemma2-2b at full width on the card; flash_attention
    checked and timed; then, with the launch counters read around them,
    LM_PREFILLS prefills of LM_BATCH x LM_SEQ tokens and LM_DECODE greedy
    decode steps; then the model-level checks at B = 1."""
    import dataclasses as dc

    from repro_torch.configs import gemma2_2b
    from repro_torch.models import transformer as tf

    cfg = gemma2_2b.config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    with torch.no_grad():
        model = tf.init(cfg, gen, dev)
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"LM {cfg.name}: {n_params / 1e9:.3f} B parameters, "
          f"{n_bytes / 1e9:.3f} GB, initialised on the card in "
          f"{time.perf_counter() - t0:.2f} s ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv} heads of "
          f"{cfg.head_dim}, windows {cfg.window_pattern}, softcap "
          f"{cfg.attn_softcap})")
    row = check_flash_attention(np, torch, ops, dev, cfg)
    torch.cuda.empty_cache()

    B, S, max_seq = LM_BATCH, LM_SEQ, LM_SEQ + LM_DECODE
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev,
                         dtype=torch.int32)

    def decode(caches, first, n, lat=None, host=None):
        nxt = first
        out = []
        for i in range(n):
            pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
            t = time.perf_counter()
            logits, caches = tf.decode_step(model, cfg, nxt, pos, caches,
                                            S + i)
            nxt = logits.argmax(-1).to(torch.int32)
            if lat is not None:
                # The host's time to issue the step, then the step's.
                host.append(time.perf_counter() - t)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t)
            out.append(logits)
        return out

    with torch.no_grad():
        # Warm-up (cuBLAS handles and plans, the allocator) off the clock.
        logits, caches = tf.prefill(model, cfg, toks, max_seq)
        decode(caches, logits[:, -1].argmax(-1).to(torch.int32), 2)
        del logits, caches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        pf = []
        for _ in range(LM_PREFILLS):
            caches = None
            t = time.perf_counter()
            logits, caches = tf.prefill(model, cfg, toks, max_seq)
            torch.cuda.synchronize()
            pf.append(time.perf_counter() - t)
        pf_launches = ops.launches()
        ops.reset_launches()
        lat, host = [], []
        first = logits[:, -1].argmax(-1).to(torch.int32)
        steps = decode(caches, first, LM_DECODE, lat, host)
        dec_launches = ops.launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    pf_ms, dec_ms, host_ms = (np.array(a) * 1e3 for a in (pf, lat, host))
    print(f"LM prefill of {B} x {S} tokens: {[round(x, 3) for x in pf_ms]} ms"
          f" | median {np.median(pf_ms):.3f} ms | "
          f"{B * S / np.median(pf) :.1f} tokens/s")
    print(f"LM decode, {LM_DECODE} greedy steps of {B}: p50 "
          f"{np.percentile(dec_ms, 50):.3f} ms p99 "
          f"{np.percentile(dec_ms, 99):.3f} ms per step | "
          f"{B * LM_DECODE / sum(lat):.1f} tokens/s | host issue time p50 "
          f"{np.percentile(host_ms, 50):.3f} ms p99 "
          f"{np.percentile(host_ms, 99):.3f} ms per step | peak allocated "
          f"{peak_gb:.3f} GB")
    print(f"LM launches: {LM_PREFILLS} prefills {pf_launches}; "
          f"{LM_DECODE} decode steps {dec_launches}")
    if pf_launches["flash_attention"] != LM_PREFILLS * cfg.n_layers:
        fail(f"prefill did not launch flash_attention once a layer: "
             f"{pf_launches}")
    if dec_launches["flash_attention"] != 0:
        fail(f"decode launched flash_attention: {dec_launches}")
    if logits.shape != (B, 1, cfg.vocab) or not torch.isfinite(logits).all():
        fail(f"prefill logits malformed: {tuple(logits.shape)}")
    for lg in steps:
        if lg.shape != (B, cfg.vocab) or not torch.isfinite(lg).all():
            fail(f"decode logits malformed: {tuple(lg.shape)}")
    del caches, steps, logits
    torch.cuda.empty_cache()

    # At B = 1: the kernel path against the plain einsum attention, and a
    # decode step against the backbone over the extended prompt.
    with torch.no_grad():
        one = toks[:1]
        lk, caches = tf.prefill(model, cfg, one, S + 1)
        lr, _ = tf.prefill(model, dc.replace(cfg, attn_impl="einsum"), one,
                           S + 1)
        lk, lr = lk[0, -1].float(), lr[0, -1].float()
        tol = LM_LOGIT_TOL_STD * float(lr.std())
        diff = float((lk - lr).abs().max())
        top2 = lr.topk(2).values
        margin = float(top2[0] - top2[1])
        same = int(lk.argmax()) == int(lr.argmax())
        print(f"LM B=1 prefill, kernel vs einsum attention: last logits max "
              f"abs diff {diff:.4g} = {diff / float(lr.std()):.4f} std "
              f"(tolerance {LM_LOGIT_TOL_STD} std = {tol:.4g}); greedy token "
              f"{'equal' if same else 'differs'}, top-2 margin {margin:.4g}")
        if diff > tol or (margin > tol and not same):
            fail("the kernel path's logits differ from the einsum "
                 "attention's")
        nxt = lk.argmax().view(1).to(torch.int32)
        ld, _ = tf.decode_step(model, cfg, nxt, torch.full(
            (1,), S, dtype=torch.int32, device=dev), caches, S)
        x, _ = tf.backbone(model, cfg, torch.cat([one, nxt[:, None]], 1))
        lf = tf.logits_from_hidden(model, cfg, x[:, -1])[0].float()
        ld = ld[0].float()
        tol = LM_LOGIT_TOL_STD * float(lf.std())
        diff = float((ld - lf).abs().max())
        print(f"LM B=1 decode step vs backbone over {S + 1} tokens: max abs "
              f"diff {diff:.4g} = {diff / float(lf.std()):.4f} std "
              f"(tolerance {LM_LOGIT_TOL_STD} std = {tol:.4g}); greedy token "
              f"{'equal' if int(ld.argmax()) == int(lf.argmax()) else 'differs'}")
        if diff > tol:
            fail("the decode step differs from the backbone")
        del caches, x
    torch.cuda.empty_cache()
    if prof:
        with torch.no_grad():
            out = []
            profile_window(torch, f"one LM prefill of {B} x {S}",
                           lambda: out.extend(tf.prefill(model, cfg, toks,
                                                         max_seq)))
            logits, caches = out
            profile_window(torch, f"4 LM decode steps of {B}",
                           lambda: decode(caches, logits[:, -1].argmax(
                               -1).to(torch.int32), 4))
    return row, pf_launches


def agg_bound(R: int, MAXD: int, D: int, live: int) -> tuple[float, str]:
    """Least time in ms: the logits and mask read once, the features of the
    ``live`` slots only (a masked slot has weight 0) and the output written
    once, against an exp and 2 · D flops a live slot."""
    nbytes = R * MAXD * (4 + 1) + live * D * 4 + R * D * 4
    return bound(nbytes, live * (2 * D + 4))


def agg_granule_bound(torch, r: int, maxd: int, d: int, mask) -> float:
    """Least time in ms if HBM moves whole 64-byte granules, as the card
    fetches them: the logits, mask and output once, and every granule that
    a live slot's features touch (a lone live 32-byte slot costs 64 B)."""
    flat = torch.nonzero(mask.reshape(-1)).squeeze(1) * (4 * d)
    first, last = flat // 64, (flat + 4 * d - 1) // 64
    span = -(-4 * d // 64) + 1
    ids = torch.cat([torch.where(first + k <= last, first + k, first)
                     for k in range(span)])
    nbytes = int(torch.unique(ids).numel()) * 64 + r * maxd * 5 + r * d * 4
    return 1e3 * nbytes / HBM_BYTES_PER_S


def check_neigh_agg(np, torch, ops, dev):
    """neigh_softmax_agg against its plain version (rtol AGG_RTOL, atol
    AGG_ATOL): the reference's test shapes, the GAT layer shapes at
    GNN_NODE_CHUNK nodes x 8 heads, ragged and odd shapes and one case of
    more than 2**31 feature floats, each case run twice and bit-equal;
    every 7th row has no live slot and must give exactly 0. Then timed at
    the layer shapes by device time (CUDA-graph replay) beside the per-call
    time, an empty launch, its bound, the plain version and torch.softmax +
    torch.bmm timed both ways."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    floor_ms = empty_launch_ms(torch)
    err, times = 0.0, {}
    for name, r, maxd, d in AGG_CASES:
        logits = torch.randn((r, maxd), generator=gen, device=dev) * 3.0
        feats = torch.randn((r, maxd, d), generator=gen, device=dev)
        if name == "unaligned":
            feats = torch.cat([feats.new_zeros(1), feats.view(-1)])[1:].view(
                r, maxd, d)
        mask = torch.rand((r, maxd), generator=gen, device=dev) < 0.45
        mask[::7] = False
        got = ops.neigh_softmax_agg(logits, feats, mask)
        again = ops.neigh_softmax_agg(logits, feats, mask)
        want = ops.neigh_softmax_agg(logits, feats, mask, impl="ref")
        torch.cuda.synchronize()
        e = float((got - want).abs().max()) if r else 0.0
        if got.shape != (r, d) or not torch.allclose(
                got, want, rtol=AGG_RTOL, atol=AGG_ATOL):
            fail(f"neigh_softmax_agg ({name}: R={r} MAXD={maxd} D={d}) "
                 f"differs from its plain version: max abs err {e:.4g}")
        if not torch.equal(got, again):
            fail(f"neigh_softmax_agg ({name}: R={r} MAXD={maxd} D={d}): two "
                 "runs differ")
        if not torch.equal(got[::7], torch.zeros_like(got[::7])):
            fail(f"neigh_softmax_agg ({name}) gives non-zero rows where no "
                 "slot is live")
        err = max(err, e)
        print(f"neigh_softmax_agg {name} (R={r} MAXD={maxd} D={d}, "
              f"{r * maxd * d} feature floats): within rtol {AGG_RTOL} atol "
              f"{AGG_ATOL} of plain (max abs err {e:.3g}); empty rows 0; "
              f"two runs bit-equal")
        del again, want
        if name.startswith("layer"):
            ml = logits.masked_fill(~mask, float("-inf"))

            def lib():
                return torch.bmm(torch.softmax(ml, dim=1)[:, None, :], feats)

            times[name] = dict(
                shape=f"R={r} MAXD={maxd} D={d}",
                ms=graph_ms(torch, lambda: ops.neigh_softmax_agg(
                    logits, feats, mask)),
                call_ms=cuda_ms(torch, lambda: ops.neigh_softmax_agg(
                    logits, feats, mask)),
                plain_ms=cuda_ms(torch, lambda: ops.neigh_softmax_agg(
                    logits, feats, mask, impl="ref"), blocks=5, per_block=2),
                library_ms=graph_ms(torch, lib, blocks=5, per_block=4),
                library_call_ms=cuda_ms(torch, lib, blocks=5, per_block=2),
                bound=agg_bound(r, maxd, d, int(mask.sum())))
            times[name]["granule_bound_ms"] = agg_granule_bound(
                torch, r, maxd, d, mask)
            # Every slot live: the kernel then reads whole rows, which
            # tells what reading only the live slots saves on this card.
            full = torch.ones_like(mask)
            times[name]["all_live_ms"] = graph_ms(
                torch, lambda: ops.neigh_softmax_agg(logits, feats, full))
            times[name]["all_live_bound"] = agg_bound(r, maxd, d, r * maxd)
            if d == 8:
                # Half the slots live at D = 8, every other one or in
                # adjacent pairs: the same live bytes, in 64-byte granules
                # all touched or half of them.
                j = torch.arange(maxd, device=dev)
                for label, m in (("every other slot", j % 2 == 0),
                                 ("slot pairs", j % 4 < 2)):
                    m = m.expand(r, maxd).contiguous()
                    times[name][label] = graph_ms(
                        torch, lambda: ops.neigh_softmax_agg(logits, feats,
                                                             m))
            del ml, full
        del logits, feats, mask, got
        torch.cuda.empty_cache()
    # A masked slot's features are never read: NaN there must not reach
    # the output (the plain version, as the reference, gives NaN).
    logits = torch.randn((130, 56), generator=gen, device=dev) * 3.0
    feats = torch.randn((130, 56, 47), generator=gen, device=dev)
    mask = torch.rand((130, 56), generator=gen, device=dev) < 0.45
    got = ops.neigh_softmax_agg(
        logits, feats.masked_fill(~mask[..., None], float("nan")), mask)
    want = ops.neigh_softmax_agg(logits, feats, mask, impl="ref")
    if not torch.allclose(got, want, rtol=AGG_RTOL, atol=AGG_ATOL):
        fail("neigh_softmax_agg lets NaN features of masked slots through")
    print("neigh_softmax_agg: NaN features in masked slots do not reach the "
          "output")
    for name, t in times.items():
        b = t["bound"]
        print(f"neigh_softmax_agg {name} shape ({t['shape']}): device "
              f"{t['ms']:.4f} ms ({100 * b[0] / t['ms']:.1f} % of the "
              f"bound's rate), per call {t['call_ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, softmax + bmm {t['library_ms']:.4f} "
              f"ms (per call {t['library_call_ms']:.4f}), bound {b[0]:.4f} "
              f"ms ({b[1]}), empty launch {floor_ms:.4f} ms; in 64-byte "
              f"granules the bound is {t['granule_bound_ms']:.4f} ms "
              f"({100 * t['granule_bound_ms'] / t['ms']:.1f} % of it); every "
              f"slot live (whole rows read) {t['all_live_ms']:.4f} ms, bound "
              f"{t['all_live_bound'][0]:.4f} ms")
        for label in ("every other slot", "slot pairs"):
            if label in t:
                print(f"neigh_softmax_agg {name}, half the slots live, "
                      f"{label}: device {t[label]:.4f} ms")
    t1, t0 = times["layer 1"], times["layer 0"]
    return dict(name="neigh_softmax_agg", route="cuda",
                source="src/repro_torch/kernels/csrc/neigh_agg.cu",
                replaces="src/repro/kernels/neigh_agg.py:41",
                max_abs_err=err, ms=t1["ms"], call_ms=t1["call_ms"],
                plain_ms=t1["plain_ms"], bound_ms=t1["bound"][0],
                bound_by=t1["bound"][1], library_ms=t1["library_ms"],
                library_call_ms=t1["library_call_ms"],
                library_vs="torch.softmax over the masked logits + "
                           "torch.bmm: two calls, no single one computes it",
                floor_ms=floor_ms, all_live_ms=t1["all_live_ms"],
                granule_bound_ms=t1["granule_bound_ms"],
                layer0_granule_bound_ms=t0["granule_bound_ms"],
                layer0_all_live_ms=t0["all_live_ms"], layer0_ms=t0["ms"],
                layer0_every_other_slot_ms=t0["every other slot"],
                layer0_slot_pairs_ms=t0["slot pairs"],
                layer0_call_ms=t0["call_ms"], layer0_plain_ms=t0["plain_ms"],
                layer0_bound_ms=t0["bound"][0],
                layer0_library_ms=t0["library_ms"],
                shape=f"{t1['shape']} (GAT layer 1, {GNN_NODE_CHUNK} nodes "
                      f"x 8 heads); layer 0 {t0['shape']}")


def gat_oracle(np, torch, g, h, lp, slope: float, nodes, concat: bool):
    """One GAT layer's output at ``nodes`` (sorted, unique), recomputed in
    float64 with numpy from their valid in-edges, given the layer input
    ``h`` from the card: logits, a softmax per node (reduceat over the
    edges sorted by dst) and the weighted sum."""
    n = h.shape[0]
    pick = torch.zeros(n, dtype=torch.bool, device=h.device)
    pick[nodes] = True
    e = torch.nonzero((g.edge_src >= 0) & pick[g.edge_dst.long()]).squeeze(1)
    ed = g.edge_dst[e].cpu().numpy().astype(np.int64)
    order = np.argsort(ed, kind="stable")
    ed, e = ed[order], e[torch.from_numpy(order).to(e.device)]
    hs = h[g.edge_src[e].long()].double().cpu().numpy()
    w, a_s, a_d = (lp[k].double().cpu().numpy()
                   for k in ("w", "a_src", "a_dst"))
    nodes_np = nodes.cpu().numpy()
    hv = h[nodes].double().cpu().numpy()
    hw_s = np.einsum("ef,fhd->ehd", hs, w)
    hw_v = np.einsum("nf,fhd->nhd", hv, w)
    pos = np.searchsorted(nodes_np, ed)
    lg = (hw_s * a_s).sum(-1) + (hw_v * a_d).sum(-1)[pos]
    lg = np.where(lg >= 0, lg, slope * lg)
    counts = np.bincount(pos, minlength=len(nodes_np))
    live = counts > 0
    starts = (np.cumsum(counts) - counts)[live]
    seg = np.repeat(np.arange(int(live.sum())), counts[live])
    mx = np.maximum.reduceat(lg, starts, axis=0)
    ex = np.exp(lg - mx[seg])
    alpha = ex / np.add.reduceat(ex, starts, axis=0)[seg]
    agg = np.zeros(hv.shape[:1] + hw_s.shape[1:])
    agg[live] = np.add.reduceat(alpha[..., None] * hw_s, starts, axis=0)
    if concat:
        flat = agg.reshape(len(nodes_np), -1)
        return np.where(flat > 0, flat, np.expm1(flat))
    return agg.mean(axis=1)


def gnn_path(np, torch, ops, dev, prof: bool = False):
    """Phase 8: neigh_softmax_agg checked and timed; gat-cora at the
    ogb_products shape on the card, GNN_FORWARDS timed forwards through
    gat.apply (which launches the kernel 0 times, as the reference's GAT
    never calls it); then per layer the kernel driven over every node on
    the layer's own data in the padded-degree layout, held against its
    plain version and the layer's segment-op aggregation, and the layer's
    output against a float64 oracle at GNN_ORACLE_NODES nodes."""
    from repro_torch.configs import gat_cora, gnn_common
    from repro_torch.data import graph_synth
    from repro_torch.models.gnn import gat, graph as G, padded

    row = check_neigh_agg(np, torch, ops, dev)
    sh = gnn_common.GNN_SHAPES[GNN_SHAPE]
    cfg = gnn_common.shape_config(gat_cora.config(), GNN_SHAPE)
    n = sh["n_nodes"]
    t0 = time.perf_counter()
    g = graph_synth.random_graph(n, sh["n_edges"], sh["d_feat"],
                                 n_classes=sh["n_classes"], seed=SEED,
                                 geometric=gat_cora.GEOMETRIC, device=dev)
    torch.cuda.synchronize()
    print(f"GNN graph {GNN_SHAPE}: {n} nodes, {sh['n_edges']} edges, "
          f"{sh['d_feat']} features, {sh['n_classes']} classes, made on "
          f"the host and moved to the card in {time.perf_counter() - t0:.2f}"
          f" s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = gat.init(cfg, gen, dev)
    print(f"GAT {cfg.name}: {cfg.n_layers} layers, {cfg.n_heads} heads, "
          f"hidden {cfg.d_hidden}, d_in {cfg.d_in}, {cfg.n_classes} classes,"
          f" edge chunk {gat.EDGE_CHUNK}")
    out = gat.apply(params, cfg, g)           # warm-up, off the clock
    torch.cuda.synchronize()
    del out
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    fwd = []
    for _ in range(GNN_FORWARDS):
        t = time.perf_counter()
        out = gat.apply(params, cfg, g)
        torch.cuda.synchronize()
        fwd.append(time.perf_counter() - t)
    apply_launches = ops.launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    fwd_ms = np.array(fwd) * 1e3
    print(f"GAT forward over {n} nodes: "
          f"{[round(x, 3) for x in fwd_ms.tolist()]} ms | median "
          f"{np.median(fwd_ms):.3f} ms | {n / np.median(fwd):.1f} nodes/s | "
          f"peak allocated {peak_gb:.3f} GB")
    print(f"GAT forward launches ({GNN_FORWARDS} forwards): "
          f"{apply_launches}")
    if any(apply_launches.values()):
        fail(f"gat.apply launched a kernel: {apply_launches}")
    if out.shape != (n, cfg.n_classes) or not torch.isfinite(out).all():
        fail(f"GAT output malformed: {tuple(out.shape)}")

    slots = padded.padded_layout(g, n)
    deg = (slots >= 0).sum(1)
    print(f"padded-degree layout: MAXD {slots.shape[1]}, in-degree mean "
          f"{float(deg.float().mean()):.2f}, min {int(deg.min())}")
    nodes = torch.from_numpy(np.sort(np.random.default_rng(SEED).choice(
        n, GNN_ORACLE_NODES, replace=False))).to(dev)
    ops.reset_launches()
    h = g.node_feat
    for i in range(cfg.n_layers):
        lp, concat = params[f"layer_{i}"], i < cfg.n_layers - 1
        with torch.no_grad():
            hw, logits = gat.layer_logits(lp, cfg, g, h)
            agg = gat.aggregate(g, G.edge_softmax(g, logits, n), hw, n)
            e_plain = e_seg = 0.0
            for lo in range(0, n, GNN_NODE_CHUNK):
                hi = min(n, lo + GNN_NODE_CHUNK)
                lg, ft, mk = padded.agg_rows(g, slots, logits, hw, lo, hi)
                got = ops.neigh_softmax_agg(lg, ft, mk)
                want = ops.neigh_softmax_agg(lg, ft, mk, impl="ref")
                seg = agg[lo:hi].reshape(got.shape)
                if not (torch.allclose(got, want, rtol=AGG_RTOL,
                                       atol=AGG_ATOL)
                        and torch.allclose(got, seg, rtol=AGG_RTOL,
                                           atol=AGG_ATOL)):
                    fail(f"neigh_softmax_agg on GAT layer {i}, nodes "
                         f"[{lo}, {hi}): off its plain version by "
                         f"{float((got - want).abs().max()):.4g}, off the "
                         f"segment aggregation by "
                         f"{float((got - seg).abs().max()):.4g}")
                e_plain = max(e_plain, float((got - want).abs().max()))
                e_seg = max(e_seg, float((got - seg).abs().max()))
                del lg, ft, mk, got, want
            h_next = gat.finish_layer(agg, concat)
            del hw, logits, agg
        ref = gat_oracle(np, torch, g, h, lp, cfg.negative_slope, nodes,
                         concat)
        mine = (h_next if concat else out)[nodes].double().cpu().numpy()
        e_or = float(np.abs(mine - ref).max())
        if not np.allclose(mine, ref, rtol=AGG_RTOL, atol=AGG_ATOL):
            fail(f"GAT layer {i} differs from the float64 oracle at "
                 f"{GNN_ORACLE_NODES} nodes: max abs err {e_or:.4g}")
        print(f"GAT layer {i}: neigh_softmax_agg over all {n} nodes x "
              f"{cfg.n_heads} heads in chunks of {GNN_NODE_CHUNK} nodes "
              f"within rtol {AGG_RTOL} atol {AGG_ATOL} of its plain version "
              f"(max abs err {e_plain:.3g}) and of the layer's segment-op "
              f"aggregation ({e_seg:.3g}); "
              f"{'the layer' if concat else 'apply'}'s output within the "
              f"same of the float64 oracle at {GNN_ORACLE_NODES} nodes "
              f"({e_or:.3g})")
        h = h_next
    e_out = float((h - out).abs().max())
    if not torch.allclose(h, out, rtol=AGG_RTOL, atol=AGG_ATOL):
        fail(f"the layer-by-layer GAT differs from gat.apply by {e_out:.4g}")
    launches = ops.launches()
    print(f"GAT kernel drive launches: {launches}")
    if launches["neigh_softmax_agg"] != cfg.n_layers * -(-n // GNN_NODE_CHUNK):
        fail(f"the kernel drive did not launch neigh_softmax_agg once a "
             f"chunk: {launches}")
    row["check_launches"] = launches["neigh_softmax_agg"]
    del h, slots, deg, nodes
    torch.cuda.empty_cache()
    if prof:
        profile_window(torch, f"one GAT forward over {n} nodes",
                       lambda: gat.apply(params, cfg, g))
    del g, params, out
    torch.cuda.empty_cache()
    return row, apply_launches


# Phase 9, the sharded paths: the mesh of gloo ranks that share the card
# (NCCL refuses two ranks on one device), the KG workload's lists at this
# many L_SHARD-item partitions (SHARD_RANKS x L_SHARD items and 20,000
# entities a partition), and the queries whose uncapped TriniT answers are
# held against the full scan.
SHARD_MESH = (2, 2)
SHARD_AXES = ("data", "model")
SHARD_RANKS = 4
SHARD_UNCAPPED = 4
# The KG serve steps of the sharded phase: (cardinality mode, engine mode).
SHARD_STEPS = (("exact", "specqp"), ("exact", "trinit"),
               ("sketch", "specqp"), ("sketch", "trinit"))
STEP_FIELDS = ("keys", "scores", "n_pulled", "n_answers", "n_iters",
               "n_wasted", "relax_mask")
STORE_FIELDS = ("keys", "scores", "lengths", "sorted_keys", "stats",
                "sketch")


def on_host(res) -> dict:
    """An EngineResult's fields as numpy arrays."""
    return {f: getattr(res, f).cpu().numpy() for f in STEP_FIELDS}


def shard_rank(mesh, shard_dir: str, relax_np, gstats_np, queries):
    """One rank of phase 9's (2, 2) mesh: load this rank's KG partition,
    run the sharded serve step per SHARD_STEPS (launch counters set to 0
    just before each and read just after), then the step's three parts
    apart, each timed: the plan, this rank's local rank join under the
    step's plans (kept for the parent's merge check) and the merge with
    the counters' collectives; then specqp with rings uncapped on every
    query and TriniT so on SHARD_UNCAPPED, and 32 sharded retrieval
    queries over this rank's rows of phase 5's corpus. Returns host data."""
    import os
    import numpy as np
    import torch
    import torch.distributed as tdist
    from repro_torch.configs import kg_specqp
    from repro_torch.configs import two_tower_retrieval as tt
    from repro_torch.core import distributed, engine, kg
    from repro_torch.core.types import RelaxTable
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, flat = mesh.device, mesh.flat_index()
    with np.load(os.path.join(shard_dir, f"shard{flat}.npz")) as f:
        store = kg.store_from_arrays(dict(f), dev)
    relax = RelaxTable(ids=torch.from_numpy(relax_np[0]).to(dev),
                       weights=torch.from_numpy(relax_np[1]).to(dev))
    gstats = torch.from_numpy(gstats_np).to(dev)
    pids = engine._as_pids(queries, dev)
    cfgs = {"exact": kg_specqp.ENGINE,
            "sketch": dataclasses.replace(kg_specqp.ENGINE,
                                          cardinality_mode="sketch")}
    fns = {(c, m): (kg_specqp.serve_step(mesh, m) if c == "exact" else
                    distributed.make_batched_sharded_fn(cfgs[c], m, mesh))
           for c, m in SHARD_STEPS}
    for fn in fns.values():        # warm-up (context, cuFFT plans) off the clock
        fn(store, relax, gstats, queries[:1])
    torch.cuda.synchronize()

    def timed(f, *args):
        """(f(*args), seconds), the card synchronised at both ends; the
        ranks meet first, so a part's time holds no other rank's lag."""
        tdist.barrier()
        t0 = time.perf_counter()
        r = f(*args)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    def merge(local, k):
        s, keys = mesh.merge_top_k(local.scores, local.keys, k)
        for ax in mesh.axis_names:
            mesh.psum(local.n_pulled, ax)
            mesh.psum(local.n_answers, ax)
            mesh.pmax(local.n_iters, ax)
        return s, keys

    out = {"kg": {}, "device": torch.cuda.get_device_name(dev)}
    for key, fn in fns.items():
        cfg = cfgs[key[0]]
        tdist.barrier()
        ops.reset_launches()
        res, wall = timed(fn, store, relax, gstats, queries)
        launches = ops.launches()
        _, plan_s = timed(distributed._plan, store, relax, gstats, pids, cfg,
                          key[1], mesh, mesh.axis_names)
        local, local_s = timed(engine.run_query_batch_with_masks, store,
                               relax, queries, res.relax_mask, cfg, dev)
        _, merge_s = timed(merge, local, cfg.k)
        out["kg"][key] = dict(wall=wall, plan_s=plan_s, local_s=local_s,
                              merge_s=merge_s, launches=launches,
                              merged=on_host(res), local=on_host(local))
    uncapped = dataclasses.replace(kg_specqp.ENGINE, seen_cap=None)
    out["uncapped"] = {
        mode: on_host(distributed.make_batched_sharded_fn(
            uncapped, mode, mesh)(store, relax, gstats, queries[:n]))
        for mode, n in (("specqp", N_QUERIES), ("trinit", SHARD_UNCAPPED))}
    del store
    torch.cuda.empty_cache()

    cfg = tt.config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cand = clustered_corpus(np, torch, dev, gen, cfg)
    qs = torch.randn((N_QUERIES, cfg.embed_dim), generator=gen, device=dev)
    rows = cand.shape[0] // math.prod(mesh.shape)
    block = cand[flat * rows:(flat + 1) * rows].clone()
    del cand
    torch.cuda.empty_cache()
    tt.retrieve(qs[0], block, tt.TOPK, tt.TILE, mesh=mesh)      # warm-up
    torch.cuda.synchronize()
    tdist.barrier()
    ops.reset_launches()
    res, lat = [], []
    for q in qs:
        t0 = time.perf_counter()
        s, i, n = tt.retrieve(q, block, tt.TOPK, tt.TILE, mesh=mesh)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        res.append((s.cpu().numpy(), i.cpu().numpy(), int(n)))
    out["retrieval"] = dict(res=res, lat=lat, launches=ops.launches())
    return out


def nccl_rank(mesh):
    """Phase 9's NCCL run at world size 1: the serve step over phase 4's
    whole kg-specqp store, in both modes (counters set to 0 just before and
    read just after), then ``engine.run_query_batch`` on the same store."""
    import torch
    from repro_torch.configs import kg_specqp
    from repro_torch.core import engine
    from repro_torch.data import kg_synth
    from repro_torch.kernels import ops

    dev = mesh.device
    wl = kg_synth.make_workload("xkg", list_len=kg_specqp.L_SHARD,
                                n_queries=N_QUERIES,
                                n_relax=kg_specqp.N_RELAX, seed=SEED,
                                device=dev)
    queries = wl.queries
    out = {}
    for mode in ("specqp", "trinit"):
        fn = kg_specqp.serve_step(mesh, mode)
        fn(wl.store, wl.relax, wl.store.stats, queries[:1])    # warm-up
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = fn(wl.store, wl.relax, wl.store.stats, queries)
        torch.cuda.synchronize()
        out[mode] = dict(wall=time.perf_counter() - t0,
                         launches=ops.launches(), merged=on_host(res),
                         batch=on_host(engine.run_query_batch(
                             wl.store, wl.relax, queries, kg_specqp.ENGINE,
                             mode, device=dev)))
    return out


def mesh_merge(np, shape, scores, payload, k: int):
    """The reference's merge of per-rank (Q, k) buffers (listed by flat
    rank of a row-major ``shape`` mesh): over the first axis, then the
    next, each a concatenation in axis order and a stable top-k."""
    s = np.stack(scores).reshape(*shape, *scores[0].shape)
    p = np.stack(payload).reshape(*shape, *payload[0].shape)
    for _ in shape:
        s, p = np.concatenate(list(s), -1), np.concatenate(list(p), -1)
        o = np.argsort(-s, axis=-1, kind="stable")[..., :k]
        s, p = (np.take_along_axis(s, o, -1), np.take_along_axis(p, o, -1))
    return s, p


def shard_path(np, torch, ops, dev, served=None):
    """Phase 9: the hash-sharded KG serve step on a (2, 2) mesh of 4 gloo
    ranks sharing the card, the same serve step under NCCL at world size 1
    over phase 4's store, and sharded retrieval over phase 5's corpus.
    ``served``: phase 4's offline results, held against the NCCL run too.
    Returns each kernel's launches on the sharded paths."""
    import tempfile
    from repro_torch.configs import kg_specqp
    from repro_torch.configs import two_tower_retrieval as tt
    from repro_torch.core import distributed, engine
    from repro_torch.data import kg_synth
    from repro_torch.launch import mesh as meshlib

    cfg = kg_specqp.ENGINE
    t0 = time.perf_counter()
    wl = kg_synth.make_workload(
        "xkg", list_len=SHARD_RANKS * kg_specqp.L_SHARD,
        n_entities=SHARD_RANKS * 20_000, n_queries=N_QUERIES,
        n_relax=kg_specqp.N_RELAX, seed=SEED, device=dev)
    queries = np.asarray(wl.queries)
    keys, scores, lengths = (wl.store.keys.cpu().numpy(),
                             wl.store.scores.cpu().numpy(),
                             wl.store.lengths.cpu().numpy())
    lists = [(keys[p, :n], scores[p, :n]) for p, n in enumerate(lengths)]
    t1 = time.perf_counter()
    stores, gstats = distributed.shard_workload(lists, SHARD_RANKS)
    shard_mb = sum(getattr(stores, f).numel() * 4
                   for f in STORE_FIELDS) / SHARD_RANKS / 2**20
    print(f"sharded workload: {len(lengths)} patterns x up to "
          f"{keys.shape[1]} items over {SHARD_RANKS} hash partitions of "
          f"{stores.keys.shape[-1]} items, {shard_mb:.1f} MiB a rank; "
          f"workload {t1 - t0:.1f} s, shard_workload "
          f"{time.perf_counter() - t1:.1f} s on the host")
    plans = {c: engine.plan_query_batch(
        wl.store, wl.relax, queries, dataclasses.replace(
            cfg, cardinality_mode=c), "specqp", dev).cpu().numpy()
        for c in ("exact", "sketch")}
    full_scan = [engine.naive_full_scan(wl.store, wl.relax, q, cfg.k,
                                        wl.n_entities, device=dev)
                 for q in queries[:SHARD_UNCAPPED]]
    full_scan = [(k.cpu().numpy(), s.cpu().numpy()) for k, s in full_scan]
    # The one-device engine over the unsharded store under the exact plans
    # (held equal to the sharded ones below), rings uncapped: the answer
    # the sharded specqp must give, its key sets partitioning.
    t1 = time.perf_counter()
    whole_kg = on_host(engine.run_query_batch_with_masks(
        wl.store, wl.relax, queries, torch.from_numpy(plans["exact"]).to(dev),
        dataclasses.replace(cfg, seen_cap=None), device=dev))
    print(f"one-device specqp over the unsharded store, rings uncapped: "
          f"{time.perf_counter() - t1:.3f} s for {N_QUERIES} queries")
    relax_np = (wl.relax.ids.cpu().numpy(), wl.relax.weights.cpu().numpy())
    del wl

    # Phase 5's corpus and queries, unsharded, for the sharded retrieval.
    rcfg = tt.config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cand = clustered_corpus(np, torch, dev, gen, rcfg)
    qs = torch.randn((N_QUERIES, rcfg.embed_dim), generator=gen, device=dev)
    whole = [tuple(x.cpu().numpy() for x in tt.retrieve(q, cand, tt.TOPK,
                                                         tt.TILE))
             for q in qs]
    del cand, qs
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="shards-") as tmp:
        for i in range(SHARD_RANKS):
            arrays = {f: getattr(stores, f)[i].numpy()
                      for f in STORE_FIELDS}
            arrays["sketch"] = arrays["sketch"].view(np.uint32)
            np.savez(f"{tmp}/shard{i}.npz", **arrays)
        del stores
        t2 = time.perf_counter()
        outs = meshlib.spawn(shard_rank, SHARD_MESH, SHARD_AXES,
                             backend="gloo", device="cuda",
                             args=(tmp, relax_np, gstats.numpy(), queries))
    print(f"{SHARD_RANKS} gloo ranks ({outs[0]['device']}, one card shared) "
          f"ran in {time.perf_counter() - t2:.1f} s, process start included")

    launches = {n: 0 for n in ("rank_join_lookup", "merge_topk",
                               "topk_score_pruned")}
    for key in SHARD_STEPS:
        runs = [o["kg"][key] for o in outs]
        label = f"sharded {key[0]} {key[1]}"
        merged = runs[0]["merged"]
        for r, run in enumerate(runs):
            if not all(np.array_equal(run["merged"][f], merged[f])
                       for f in STEP_FIELDS):
                fail(f"{label}: rank {r}'s result differs from rank 0's")
            if not (run["launches"]["rank_join_lookup"] > 0
                    and run["launches"]["merge_topk"] > 0):
                fail(f"{label}: rank {r} launched no KG kernel: "
                     f"{run['launches']}")
            for n in ("rank_join_lookup", "merge_topk"):
                launches[n] += run["launches"][n]
        locs = [run["local"] for run in runs]
        s, k = mesh_merge(np, SHARD_MESH, [x["scores"] for x in locs],
                          [x["keys"] for x in locs], cfg.k)
        if not (np.array_equal(s, merged["scores"])
                and np.array_equal(k, merged["keys"])):
            fail(f"{label}: merged top-k differs from the two-level stable "
                 "top-k of the ranks' local results")
        sums = {f: np.sum([x[f] for x in locs], 0)
                for f in ("n_pulled", "n_answers")}
        if not (all(np.array_equal(sums[f], merged[f]) for f in sums)
                and np.array_equal(np.max([x["n_iters"] for x in locs], 0),
                                   merged["n_iters"])
                and not merged["n_wasted"].any()):
            fail(f"{label}: counters are not the ranks' sums and maximum")
        masks = ""
        if key[1] == "specqp":
            agree = int((merged["relax_mask"] == plans[key[0]]).all(
                axis=(1, 2)).sum())
            if key[0] == "exact" and agree != N_QUERIES:
                fail(f"{label}: {N_QUERIES - agree} plans differ from the "
                     "single-device plans over the unsharded store")
            masks = (f" | masks equal to the single-device {key[0]} plans "
                     f"on {agree}/{N_QUERIES}")
        wall = max(run["wall"] for run in runs)
        print(f"{label}: {N_QUERIES / wall:.2f} QPS ({wall:.3f} s a batch "
              f"of {N_QUERIES}: every query's latency, p50 = p99) | mean "
              f"n_pulled {merged['n_pulled'].mean():.1f} | mean n_iters "
              f"{merged['n_iters'].mean():.1f}{masks} | launches by rank "
              f"{[r['launches']['rank_join_lookup'] for r in runs]} + "
              f"{[r['launches']['merge_topk'] for r in runs]}")
        print(f"{label}, the step's parts apart (slowest rank): plan "
              f"{max(r['plan_s'] for r in runs):.4f} s, local rank join "
              f"{max(r['local_s'] for r in runs):.3f} s, merge + counter "
              f"collectives {max(r['merge_s'] for r in runs):.4f} s a batch")
    print("every rank's merged result is equal; merged top-k = the "
          "two-level stable top-k of the ranks' local top-k (each "
          "run_query_batch_with_masks on its shard under the step's plans); "
          "n_pulled, n_answers = their sums, n_iters = their maximum")

    def same_top_k(got, want, label):
        """Scores within rtol 1e-5 and keys equal at every place whose
        score is more than 1e-5 relative from both neighbours (the k-th
        place's lower one unknown: never clear); returns how many queries
        have every key equal. Near-equal sums may swap: a key's score is
        summed in the order its patterns reached it, which the partition
        changes."""
        gs, ws = got["scores"], want["scores"]
        if not np.allclose(gs, ws, rtol=1e-5):
            fail(f"{label}: scores differ beyond rtol 1e-5")
        with np.errstate(invalid="ignore"):
            gap = np.abs(ws[:, :-1] - ws[:, 1:]) > 1e-5 * np.abs(ws[:, :-1])
        clear = np.zeros_like(ws, bool)
        clear[:, :-1] = gap
        clear[:, 1:-1] &= gap[:, :-1]
        if not ((got["keys"] == want["keys"]) | ~clear).all():
            fail(f"{label}: keys differ at a place with no near-tie")
        return int((got["keys"] == want["keys"]).all(1).sum())

    unc = outs[0]["uncapped"]
    if not np.array_equal(unc["specqp"]["relax_mask"], plans["exact"]):
        fail("sharded specqp (no seen cap): plans differ from the "
             "single-device exact plans")
    same_keys = same_top_k(unc["specqp"], whole_kg,
                           "sharded specqp (no seen cap)")
    print(f"sharded specqp (no seen cap) == the one-device engine over the "
          f"unsharded store under the same plans on all {N_QUERIES} "
          f"queries (scores rtol 1e-5, keys wherever no near-tie; keys "
          f"identical on {same_keys})")
    key_match = 0
    for i, (bk, bs) in enumerate(full_scan):
        if not np.allclose(unc["trinit"]["scores"][i], bs, rtol=1e-5):
            fail(f"sharded trinit (no seen cap) query {i} differs from "
                 "naive_full_scan over the unsharded store")
        key_match += int(np.array_equal(unc["trinit"]["keys"][i], bk))
    print(f"sharded trinit (no seen cap) == naive_full_scan on "
          f"{SHARD_UNCAPPED} queries (scores rtol 1e-5; keys identical on "
          f"{key_match})")

    rr = outs[0]["retrieval"]
    for r, o in enumerate(outs):
        if o["retrieval"]["launches"]["topk_score_pruned"] != N_QUERIES:
            fail(f"sharded retrieval: rank {r} launched topk_score_pruned "
                 f"{o['retrieval']['launches']['topk_score_pruned']} times "
                 f"for {N_QUERIES} queries")
        launches["topk_score_pruned"] += \
            o["retrieval"]["launches"]["topk_score_pruned"]
    tiles, tiles_whole = 0, 0
    for qi, ((s, i, n), (ws, wi, wn)) in enumerate(zip(rr["res"], whole)):
        if not (np.array_equal(i, wi) and np.allclose(s, ws, rtol=1e-5)):
            fail(f"sharded retrieval query {qi} differs from the unsharded "
                 "retrieve")
        tiles += n
        tiles_whole += int(wn)
    lat = np.array(rr["lat"]) * 1e3
    print(f"sharded retrieval: {N_QUERIES} queries' top-{tt.TOPK} equal the "
          f"unsharded retrieve (indices exactly, scores rtol 1e-5) | tiles "
          f"scored, summed over the ranks, {tiles} against {tiles_whole} "
          f"unsharded | {N_QUERIES / (lat.sum() / 1e3):.1f} QPS, p50 "
          f"{np.percentile(lat, 50):.3f} ms p99 {np.percentile(lat, 99):.3f} "
          f"ms a query")
    print(f"(4 gloo ranks share one card: these times are not a "
          f"deployment's)")

    t3 = time.perf_counter()
    one = meshlib.spawn(nccl_rank, (1, 1), SHARD_AXES, backend="nccl",
                        device="cuda")[0]
    nccl_launches = {}
    for mode, run in one.items():
        m, b = run["merged"], run["batch"]
        same = (np.array_equal(m["keys"], b["keys"])
                and np.array_equal(m["scores"], b["scores"])
                and all(np.array_equal(m[f], b[f]) for f in
                        ("n_pulled", "n_answers", "n_iters")))
        if not same:
            fail(f"NCCL world-1 {mode} serve step differs from "
                 "run_query_batch on the same store")
        if served is not None and not all(
                np.array_equal(m["keys"][i], r.keys)
                and np.array_equal(m["scores"][i], r.scores)
                and all(int(m[f][i]) == getattr(r, f)
                        for f in ("n_pulled", "n_answers", "n_iters"))
                for i, r in enumerate(served[mode])):
            fail(f"NCCL world-1 {mode} serve step differs from phase 4's "
                 "offline pass")
        if not (run["launches"]["rank_join_lookup"] > 0
                and run["launches"]["merge_topk"] > 0):
            fail(f"NCCL world-1 {mode}: a KG kernel was never launched")
        nccl_launches[mode] = run["launches"]
        print(f"NCCL world-1 {mode}: {N_QUERIES / run['wall']:.2f} QPS "
              f"({run['wall']:.3f} s a batch) | equal to run_query_batch"
              + (" and to phase 4's offline pass" if served is not None
                 else "") + f" | launches {run['launches']['rank_join_lookup']}"
              f" + {run['launches']['merge_topk']}")
    print(f"NCCL world-1 run took {time.perf_counter() - t3:.1f} s")
    print(f"sharded path launches (summed over ranks): {launches}")
    return launches, nccl_launches


# Phase 10: training. Two-tower at the published widths with two cuts
# (vocab 20 M -> 10 M a table: 2 x 20 M x 256 x (4 param + 4 grad + 2 m +
# 2 v) B is 123 GB, over the card's 80 GB, and 61.4 GB at 10 M;
# train_batch 65,536 -> 16,384: a (B, B) f32 logits buffer is 17.2 GB at
# 65,536 and the loss holds about three, 1.07 GB each at 16,384), steps
# timed; the example with injected failures; GAT at the Cora shape.
TRAIN_VOCAB = 10_000_000
TRAIN_BATCH = 16_384
TRAIN_STEPS = 6          # the last one split into grads, norm and update
# embedding_bag_backward against its plain version: the touched rows
# within this (float32 atomics add repeated ids in any order); untouched
# rows exactly 0.
BAG_BWD_RTOL, BAG_BWD_ATOL = 1e-5, 1e-6
# Hot-id case: every bag repeats one id from this many (contention).
HOT_IDS = 64
EXAMPLE_FAILS = (50, 150)      # before and after the first checkpoint
EXAMPLE_LOSS_RTOL = 1e-3
# GAT at the Cora shape: card gradients against the CPU's, rtol and an
# atol of this share of the leaf's largest gradient (the card's index_add_
# adds edges in another order).
GAT_GRAD_RTOL, GAT_GRAD_ATOL_OF_SCALE = 1e-4, 1e-5


def bag_backward_case(np, torch, table, dev, rng, B, S, kind):
    """Inputs of one embedding_bag_backward check: (ids, weights, dout).
    ``hot``: every bag repeats one id of HOT_IDS, with weights and dout on
    a dyadic grid, so every sum is exact in any order and the kernel must
    equal plain bit for bit whatever order the atomics land in."""
    V, D = table.shape
    if kind == "hot":
        ids = np.repeat(rng.integers(0, V, HOT_IDS)[rng.integers(
            0, HOT_IDS, B)][:, None], S, 1)
        w = rng.integers(1, 5, (B, S)) / 4.0
        dout = rng.integers(-8, 9, (B, D)) / 64.0
    else:
        lo = 2**23 if kind == "above 2**23" else 0
        ids = rng.integers(lo, V, (B, S))
        if kind == "quarter -1":
            ids[rng.random((B, S)) < 0.25] = -1
        w = rng.random((B, S))
        dout = rng.standard_normal((B, D))
    return [torch.from_numpy(np.asarray(a, dt)).to(dev) for a, dt in
            ((ids, np.int32), (w, np.float32), (dout, np.float32))]


def check_bag_grads(torch, label, got, want, ids, V):
    """(max abs err over touched rows, touched rows). Fails unless the
    touched rows agree within BAG_BWD_RTOL/ATOL and every other row of
    both is exactly 0."""
    live = ids[ids >= 0].long()
    touched = torch.zeros(V, dtype=torch.bool, device=ids.device)
    touched[live] = True
    rows = touched.nonzero().squeeze(1)
    for name, g in (("kernel", got), ("plain", want)):
        stray = g.ne(0).any(1) & ~touched
        if bool(stray.any()):
            fail(f"embedding_bag_backward {label}: {name} wrote "
                 f"{int(stray.sum())} untouched rows")
    a, b = got[rows], want[rows]
    err = float((a - b).abs().max()) if rows.numel() else 0.0
    if not torch.allclose(a, b, rtol=BAG_BWD_RTOL, atol=BAG_BWD_ATOL):
        fail(f"embedding_bag_backward {label}: touched rows differ from "
             f"plain (max abs err {err:.4g})")
    return err, int(rows.numel())


def check_embedding_bag_backward(np, torch, ops, model, real, dev):
    """embedding_bag_backward against its plain version before the
    optimizer state exists: on the first training batch's own ids and
    dout for each table (``real``: the calls recorded during a real
    backward), then on the user table at (TRAIN_BATCH, 32) with a quarter
    of the slots -1, hot ids, ids above 2**23 and the weights' gradient,
    each case run twice. Timed at the batch's two shapes by device time
    (graph replay into a zeroed buffer) and per call, beside the memset of
    the dense (V, D) gradient, the bound, the plain version and
    F.embedding_bag's backward through torch.autograd.grad."""
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ref

    errs, rows = [], {}
    for side, (dout, ids, w, table, got) in real.items():
        want = ref.embedding_bag_backward(dout, ids, w, table)[0]
        e, n = check_bag_grads(torch, f"{side} batch", got, want, ids,
                               table.shape[0])
        del want, got
        real[side][4] = None        # the gradient's 10 GB, no longer needed
        errs.append(e)
        print(f"embedding_bag_backward on training batch 0's {side} bags "
              f"{tuple(ids.shape)}: {n} touched rows within rtol "
              f"{BAG_BWD_RTOL} atol {BAG_BWD_ATOL} of plain (max abs err "
              f"{e:.3g}), every other row 0")
    table = model.user.table.detach()
    V, D = table.shape
    rng = np.random.default_rng(SEED + 10)
    for kind in ("quarter -1", "hot", "above 2**23", "weights"):
        ids, w, dout = bag_backward_case(np, torch, table, dev, rng,
                                         TRAIN_BATCH, 32, kind)
        runs = [ops.embedding_bag_backward(dout, ids, w, table,
                                           weights_grad=kind == "weights")
                for _ in range(2)]
        want = ops.embedding_bag_backward(dout, ids, w, table,
                                          weights_grad=kind == "weights",
                                          impl="ref")
        torch.cuda.synchronize()
        for got in runs:
            e, n = check_bag_grads(torch, kind, got[0], want[0], ids, V)
            errs.append(e)
            if kind == "weights":
                ew = float((got[1] - want[1]).abs().max())
                if not torch.allclose(got[1], want[1], rtol=BAG_BWD_RTOL,
                                      atol=BAG_BWD_ATOL):
                    fail(f"embedding_bag_backward's weights' gradient "
                         f"differs from plain (max abs err {ew:.4g})")
                errs.append(ew)
        if kind == "hot" and not all(torch.equal(g[0], want[0])
                                     for g in runs):
            fail("embedding_bag_backward, hot ids on a dyadic grid: not "
                 "bit-equal to plain")
        between = float((runs[0][0] - runs[1][0]).abs().max())
        print(f"embedding_bag_backward V={V} D={D} B={TRAIN_BATCH} S=32 "
              f"({kind}): {n} touched rows within rtol {BAG_BWD_RTOL} atol "
              f"{BAG_BWD_ATOL} of plain, every other row 0"
              + (", the weights' gradient too" if kind == "weights" else "")
              + (", bit-equal (exact sums)" if kind == "hot" else "")
              + f"; two runs differ by at most {between:.3g}")
        del runs, want
    # Timings at the batch's shapes, on its own ids and dout.
    floor_ms = empty_launch_ms(torch)
    for side, (dout, ids, w, table, _) in real.items():
        table = table.detach()
        buf = torch.zeros_like(table)
        live = ids[ids >= 0]
        n_rows = int(torch.unique(live).numel())
        B, S = ids.shape
        nbytes = B * D * 4 + B * S * 8 + 2 * n_rows * D * 4
        tl = table.detach().requires_grad_()
        lib_out = F.embedding_bag(torch.where(ids >= 0, ids, 0), tl,
                                  mode="sum", per_sample_weights=torch.where(
                                      ids >= 0, w, 0.0))
        rows[side] = dict(
            ms=graph_ms(torch, lambda: eb.embedding_bag_backward(
                dout, ids, w, table, out=buf)),
            call_ms=cuda_ms(torch, lambda: eb.embedding_bag_backward(
                dout, ids, w, table, out=buf)),
            alloc_call_ms=cuda_ms(torch, lambda: eb.embedding_bag_backward(
                dout, ids, w, table), blocks=5, per_block=2),
            memset_ms=graph_ms(torch, lambda: buf.zero_(), blocks=5,
                               per_block=4),
            memset_bound_ms=1e3 * V * D * 4 / HBM_BYTES_PER_S,
            plain_ms=cuda_ms(torch, lambda: ops.embedding_bag_backward(
                dout, ids, w, table, impl="ref"), blocks=5, per_block=2),
            library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                lib_out, tl, dout, retain_graph=True), blocks=5,
                per_block=2),
            bound=bound(nbytes, 2 * int(live.numel()) * D),
            shape=f"V={V} D={D} B={B} S={S}, {int(live.numel())} live "
                  f"slots, {n_rows} distinct rows")
        del buf, lib_out, tl
        r = rows[side]
        print(f"embedding_bag_backward {side} {r['shape']}: device "
              f"{r['ms']:.4f} ms ({100 * r['bound'][0] / r['ms']:.1f} % of "
              f"the bound's rate), per call {r['call_ms']:.4f} ms; with its "
              f"(V, D) zero-fill per call {r['alloc_call_ms']:.4f} ms (the "
              f"fill alone {r['memset_ms']:.4f} ms, bound "
              f"{r['memset_bound_ms']:.4f}); plain {r['plain_ms']:.4f} ms; "
              f"F.embedding_bag backward {r['library_ms']:.4f} ms; bound "
              f"{r['bound'][0]:.5f} ms ({r['bound'][1]}); empty launch "
              f"{floor_ms:.4f} ms")
    u, i = rows["user"], rows["item"]
    return dict(name="embedding_bag_backward", route="cuda",
                source="src/repro_torch/kernels/csrc/embedding_bag.cu",
                replaces="src/repro/kernels/ref.py:85",
                note="port kernel, no TPU counterpart: the reference "
                     "differentiates embedding_bag_ref with jax.grad",
                max_abs_err=max(errs), ms=u["ms"], call_ms=u["call_ms"],
                alloc_call_ms=u["alloc_call_ms"], memset_ms=u["memset_ms"],
                memset_bound_ms=u["memset_bound_ms"],
                plain_ms=u["plain_ms"], bound_ms=u["bound"][0],
                bound_by=u["bound"][1], library_ms=u["library_ms"],
                floor_ms=floor_ms, item_ms=i["ms"],
                item_call_ms=i["call_ms"], item_plain_ms=i["plain_ms"],
                item_bound_ms=i["bound"][0],
                item_library_ms=i["library_ms"],
                shape=f"user {u['shape']}; item {i['shape']}")


def train_two_tower(np, torch, ops, dev):
    """Phase 10 (a): the two-tower model at the published widths, vocab
    and batch cut (TRAIN_VOCAB, TRAIN_BATCH), TRAIN_CFG (bf16 moments).
    embedding_bag_backward checked before the optimizer state exists;
    then TRAIN_STEPS steps of make_train_step on the example's batches
    with the launch counters read around them, each step timed and its
    metrics printed, the last split into gradients, norm and update."""
    from repro_torch.configs import two_tower_retrieval as tt
    from repro_torch.examples import train_retrieval
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.models import recsys
    from repro_torch.train import loop, optimizer as opt_lib, tree

    cfg = dataclasses.replace(tt.config(), user_vocab=TRAIN_VOCAB,
                              item_vocab=TRAIN_VOCAB)
    torch.cuda.reset_peak_memory_stats(dev)
    model = recsys.init(cfg, seed=SEED, device=dev)
    params = recsys.param_tree(model)

    def loss(p, b):
        return recsys.loss_fn(p, cfg, b)

    batches = [train_retrieval.make_batch(cfg, TRAIN_BATCH, s, dev)
               for s in range(TRAIN_STEPS)]
    # The backward kernel's inputs during one real backward.
    recorded, orig = [], eb.embedding_bag_backward

    def record(dout, ids, weights, table, **kw):
        # The wrapper counts its launch on its own module-level name.
        eb.embedding_bag_backward = orig
        try:
            out = orig(dout, ids, weights, table, **kw)
        finally:
            eb.embedding_bag_backward = record
        recorded.append((dout.clone(), ids, weights, table, out[0]))
        return out

    eb.embedding_bag_backward = record
    try:
        _, _, grads = loop.value_and_grad(loss, params, batches[0])
    finally:
        eb.embedding_bag_backward = orig
    side_of = {id(model.user.table): "user", id(model.item.table): "item"}
    real = {side_of[id(r[3])]: list(r) for r in recorded}
    del recorded
    for side in ("user", "item"):
        if real[side][4] is not grads[side]["table"]:
            fail(f"the {side} table's gradient is not the backward "
                 f"kernel's output")
    del grads
    row = check_embedding_bag_backward(np, torch, ops, model, real, dev)
    del real
    torch.cuda.empty_cache()

    state = loop.make_train_state(params, tt.TRAIN_CFG)
    n_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(
        [state["params"], state["opt"]["m"], state["opt"]["v"]]))
    print(f"two-tower training: embed {cfg.embed_dim}, MLP "
          f"{cfg.tower_mlp}, vocab {cfg.user_vocab} + {cfg.item_vocab}, "
          f"batch {TRAIN_BATCH}, moments {tt.TRAIN_CFG.opt.moment_dtype}: "
          f"{n_bytes / 1e9:.3f} GB of parameters and moments "
          f"({torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated)")
    step = loop.make_train_step(loss, tt.TRAIN_CFG)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    step_ms, hist = [], []
    for s, b in enumerate(batches):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        if s < TRAIN_STEPS - 1:
            e[0].record()
            state, m = step(state, b)
            e[3].record()
        else:
            # The same step in its three parts.
            e[0].record()
            grads, m = loop.compute_grads(loss, state["params"], b)
            e[1].record()
            opt_lib.global_norm(grads)
            e[2].record()
            _, _, om = opt_lib.apply_updates(state["params"], grads,
                                             state["opt"], tt.TRAIN_CFG.opt)
            e[3].record()
            m = dict(m, **om)
            del grads
        e[3].synchronize()
        step_ms.append(e[0].elapsed_time(e[3]))
        hist.append({k: float(v) for k, v in m.items()})
        print(f"train step {s}: loss {hist[-1]['loss']:.6f} grad_norm "
              f"{hist[-1]['grad_norm']:.6f} lr {hist[-1]['lr']:.3g} "
              f"in_batch_acc {hist[-1]['in_batch_acc']:.4f} "
              f"({step_ms[-1]:.3f} ms)")
    launches = ops.launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    fwd_bwd, norm = e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2])
    update = e[2].elapsed_time(e[3]) - norm      # apply_updates norms too
    print(f"two-tower train step (median of {TRAIN_STEPS}): "
          f"{float(np.median(step_ms)):.3f} ms; the last split: forward + "
          f"backward {fwd_bwd:.3f} ms, global norm {norm:.3f} ms, update "
          f"{update:.3f} ms; peak allocated {peak_gb:.3f} GB")
    print(f"training launches: {launches}")
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist):
        fail(f"a training step's loss or norm is not finite: {hist}")
    if int(state["opt"]["step"]) != TRAIN_STEPS:
        fail(f"opt.step is {int(state['opt']['step'])} after "
             f"{TRAIN_STEPS} steps")
    for name in ("embedding_bag", "embedding_bag_backward"):
        if launches[name] != 2 * TRAIN_STEPS:
            fail(f"training launched {name} {launches[name]} times, not "
                 f"once a tower a step: {launches}")
    row.update(step_ms=float(np.median(step_ms)), fwd_bwd_ms=fwd_bwd,
               norm_ms=norm, update_ms=update, train_peak_gb=peak_gb)
    return row, launches


def train_example(np, torch, ops, dev):
    """Phase 10 (b): examples/train_retrieval.py's main at its defaults on
    the card, once with a failure injected before the first checkpoint
    and one after it, once without; every restore read back bit for bit
    against the state saved (or the initial snapshot), checkpoints in a
    temporary directory removed afterwards."""
    import tempfile
    from repro_torch.examples import train_retrieval
    from repro_torch.train import checkpoint, fault_tolerance as ft, tree

    saved, checked = {}, []
    orig_save, orig_restore = checkpoint.AsyncCheckpointer.save, \
        checkpoint.restore
    orig_copy = ft._copy_into

    def save(self, step, state):
        saved[step] = checkpoint.host_copy(state)
        return orig_save(self, step, state)

    def restore(ckpt_dir, step, template):
        out = orig_restore(ckpt_dir, step, template)
        if not all(torch.equal(a.detach().cpu(), b) for a, b in zip(
                tree.leaves(out), tree.leaves(saved[step]))):
            fail(f"the checkpoint of step {step} did not read back bit "
                 f"for bit")
        checked.append(f"checkpoint {step}")
        return out

    def copy_into(dst, src):
        out = orig_copy(dst, src)
        if not all(torch.equal(a.detach().cpu(), b.detach().cpu())
                   for a, b in zip(tree.leaves(out), tree.leaves(src))):
            fail("a restart's state is not the state restored")
        checked.append("restart")
        return out

    fails_left = set(EXAMPLE_FAILS)

    def hook(step):
        if step in fails_left:
            fails_left.discard(step)
            raise RuntimeError(f"injected failure at step {step}")

    checkpoint.AsyncCheckpointer.save = save
    checkpoint.restore, ft._copy_into = restore, copy_into
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as d:
            broken = train_retrieval.main(
                ["--ckpt-dir", f"{d}/a", "--device", str(dev)],
                fail_hook=hook)
            launches = ops.launches()
            broken_s = time.perf_counter() - t0
            whole = train_retrieval.main(
                ["--ckpt-dir", f"{d}/b", "--device", str(dev)])
    finally:
        checkpoint.AsyncCheckpointer.save = orig_save
        checkpoint.restore, ft._copy_into = orig_restore, orig_copy
    h, hw = broken["history"], whole["history"]
    first, last, ref_last = h[0]["loss"], h[-1]["loss"], hw[-1]["loss"]
    diff = max(float((a.detach() - b.detach()).abs().max()) for a, b in zip(
        tree.leaves(broken["state"]["params"]),
        tree.leaves(whole["state"]["params"])))
    print(f"train_retrieval example on the card: {len(h)} step records, "
          f"{broken['failures']} injected failures (steps {EXAMPLE_FAILS}), "
          f"{broken_s:.2f} s; loss {first:.6f} -> {last:.6f}; a run without "
          f"failures ends at {ref_last:.6f}; restores read back bit for "
          f"bit: {checked}; largest parameter difference between the two "
          f"runs {diff:.3g} (the backward's atomics add a row's terms from "
          f"different bags in varying order); launches {launches}")
    if broken["failures"] != len(EXAMPLE_FAILS) or fails_left:
        fail(f"the example saw {broken['failures']} failures")
    if sorted(checked) != ["checkpoint 100", "restart", "restart"]:
        fail(f"restores checked: {checked}")
    if not last < first:
        fail(f"the example's loss did not fall: {first} -> {last}")
    if abs(last - ref_last) > EXAMPLE_LOSS_RTOL * abs(ref_last):
        fail(f"final loss {last} is not within rtol {EXAMPLE_LOSS_RTOL} of "
             f"the failure-free run's {ref_last}")
    s, i, _ = broken["result"]
    exact_s, exact_i = stable_topk(torch, broken["cand"] @ broken["query"],
                                   10)
    ok, clear = agrees_with_exact(torch, s, i, exact_s, exact_i, 10)
    if not ok:
        fail("the example's speculative retrieval differs from the exact "
             "top-k")
    print(f"train_retrieval example: speculative top-10 equals the exact "
          f"top-10 (indices at {clear} places with no near-tie)")
    for name in ("embedding_bag", "embedding_bag_backward",
                 "topk_score_pruned"):
        if not launches[name]:
            fail(f"the example did not launch {name}: {launches}")
    return launches


def train_gat(np, torch, dev):
    """Phase 10 (c): one train step of gat-cora at the full_graph_sm shape
    (Cora's 2,708 nodes, 10,556 edges, 1,433 features, 7 classes) on the
    card, its gradients against the same step's on the CPU; and
    gnn_common.smoke_run on the card."""
    from repro_torch.configs import gat_cora, gnn_common
    from repro_torch.data import graph_synth
    from repro_torch.models.gnn import gat
    from repro_torch.train import loop, tree

    cfg = gnn_common.shape_config(gat_cora.config(), "full_graph_sm")
    sh = gnn_common.GNN_SHAPES["full_graph_sm"]
    gk = dict(n_nodes=sh["n_nodes"], n_edges=sh["n_edges"],
              d_feat=sh["d_feat"], n_classes=sh["n_classes"], seed=SEED,
              geometric=False)
    g_cpu = graph_synth.random_graph(device="cpu", **gk)
    g_dev = graph_synth.random_graph(device=dev, **gk)
    p_cpu = gat.init(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    p_dev = tree.tree_map(lambda t: t.to(dev), p_cpu)
    tc = gnn_common.TRAIN_CFG
    s_cpu = loop.make_train_state(p_cpu, tc)
    s_dev = loop.make_train_state(p_dev, tc)

    def loss(p, g):
        return gat.loss_fn(p, cfg, g)

    want, _ = loop.compute_grads(loss, s_cpu["params"], g_cpu)
    got, m = loop.compute_grads(loss, s_dev["params"], g_dev)
    worst = 0.0
    for (name, a), b in zip(tree.flatten(got), tree.leaves(want)):
        a = a.cpu()
        atol = GAT_GRAD_ATOL_OF_SCALE * float(b.abs().max())
        worst = max(worst, float(((a - b).abs() / (atol + GAT_GRAD_RTOL
                                                   * b.abs())).max()))
        if not torch.allclose(a, b, rtol=GAT_GRAD_RTOL, atol=atol):
            fail(f"gat-cora gradient {name} on the card differs from the "
                 f"CPU's: max abs err {float((a - b).abs().max()):.4g}")
    _, sm = loop.make_train_step(loss, tc)(s_dev, g_dev)
    smoke = gnn_common.smoke_run(gat, gat_cora.smoke_config(), False,
                                 device=dev)
    if not all(np.isfinite(float(x)) for x in (sm["loss"], smoke["loss"])):
        fail(f"a GAT train step's loss is not finite: {sm}, {smoke}")
    print(f"gat-cora at full_graph_sm ({sh['n_nodes']} nodes, "
          f"{sh['n_edges']} edges, {sh['d_feat']} features): one train "
          f"step on the card, loss {float(sm['loss']):.6f}, grad_norm "
          f"{float(sm['grad_norm']):.6f}; its gradients within rtol "
          f"{GAT_GRAD_RTOL} atol {GAT_GRAD_ATOL_OF_SCALE} x the leaf's "
          f"largest of the CPU's (worst at {worst:.3f} of the tolerance); "
          f"smoke_run on the card: loss {float(smoke['loss']):.6f}")


def train_path(np, torch, ops, dev):
    """Phase 10: training (a)-(c). Returns the embedding_bag_backward row
    and the launches of the full-width steps."""
    t0 = time.perf_counter()
    row, launches = train_two_tower(np, torch, ops, dev)
    torch.cuda.empty_cache()
    row["example_launches"] = train_example(np, torch, ops, dev)
    train_gat(np, torch, dev)
    print(f"phase 10 took {time.perf_counter() - t0:.1f} s")
    return row, launches


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
            if any(w in line for w in ("registers", "spill", "serialized")):
                print(f"  ptxas {name}: {line.strip()}")

    if "--attention-only" in sys.argv[1:]:
        # Phases 1-2 and phase 7's flash_attention checks and timings
        # alone, without the model: a quick run while the kernel changes.
        from repro_torch.configs import gemma2_2b
        row = check_flash_attention(np, torch, ops, dev, gemma2_2b.config())
        print(json.dumps(row))
        print(f"chip_smoke --attention-only took "
              f"{time.perf_counter() - T_START:.1f} s")
        return
    if "--gather-only" in sys.argv[1:]:
        # Phases 1-2, then the checks and timings of the two gather
        # kernels alone: embedding_bag on one table of the two-tower
        # model's shape (no towers), neigh_softmax_agg at its cases and the
        # GAT layer shapes (no graph), with the NaN check.
        from repro_torch.configs import two_tower_retrieval as tt
        cfg = tt.config()
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        table = torch.empty((cfg.user_vocab, cfg.embed_dim), device=dev)
        table.normal_(0.0, 0.01, generator=gen)
        rows = [check_embedding_bag(np, torch, ops, table, table, dev)]
        del table
        torch.cuda.empty_cache()
        rows.append(check_neigh_agg(np, torch, ops, dev))
        print(json.dumps(rows))
        print(f"chip_smoke --gather-only took "
              f"{time.perf_counter() - T_START:.1f} s")
        return
    if "--train-only" in sys.argv[1:]:
        # Phases 1-2 and phase 10 alone: the training paths.
        row, launches = train_path(np, torch, ops, dev)
        row["launches"] = launches["embedding_bag_backward"]
        print(json.dumps(row))
        print(f"chip_smoke --train-only took "
              f"{time.perf_counter() - T_START:.1f} s")
        return
    if "--shard-only" in sys.argv[1:]:
        # Phases 1-2 and phase 9 alone: the sharded paths.
        launches, nccl = shard_path(np, torch, ops, dev)
        print(json.dumps({"sharded_launches": launches,
                          "nccl_world1_launches": nccl}))
        print(f"chip_smoke --shard-only took "
              f"{time.perf_counter() - T_START:.1f} s")
        return
    rows = check_kernels(np, torch, ops, dev)
    print(f"phases 1-3 done at {time.perf_counter() - t0:.1f} s")
    if "--kg-only" in sys.argv[1:]:
        # Phases 1-3 alone: a quick run while the KG kernels change.
        print(json.dumps(list(rows.values())))
        print(f"chip_smoke --kg-only took "
              f"{time.perf_counter() - T_START:.1f} s")
        return
    launches, report, state = main_path(np, torch, dev)
    t4 = time.perf_counter()
    online_path(np, torch, dev, report, state)
    print(f"phase 4's sketch, pipelined and online passes took "
          f"{time.perf_counter() - t4:.1f} s")
    print(f"phase 4 done at {time.perf_counter() - t0:.1f} s")
    for name, row in rows.items():
        row["launches"] = launches[name]
    prof = "--profile" in sys.argv[1:]
    for path in (retrieval_path, serving_path, lm_path, gnn_path):
        row, path_launches = path(np, torch, ops, dev, prof)
        row["launches"] = path_launches[row["name"]]
        rows[row["name"]] = row
        torch.cuda.empty_cache()
        print(f"{path.__name__} done at {time.perf_counter() - t0:.1f} s")
    sharded, _ = shard_path(np, torch, ops, dev, state["served"])
    print(f"shard_path done at {time.perf_counter() - t0:.1f} s")
    for name, n in sharded.items():
        rows[name]["sharded_launches"] = n
    torch.cuda.empty_cache()
    row, train_launches = train_path(np, torch, ops, dev)
    row["launches"] = train_launches["embedding_bag_backward"]
    rows["embedding_bag_backward"] = row
    rows["embedding_bag"]["train_launches"] = train_launches["embedding_bag"]
    print(f"train_path done at {time.perf_counter() - t0:.1f} s")
    kernels = [rows[n] for n in ("rank_join_lookup", "merge_topk",
                                 "topk_score_pruned", "embedding_bag",
                                 "embedding_bag_backward",
                                 "flash_attention", "neigh_softmax_agg")]
    for k in kernels:
        print(f"{k['name']}: {k['launches']} launches on its path")
    if prof:
        profile_main_path(np, torch, dev, state["wl"], state["queries"],
                          state["bcfg"])
    print(f"chip_smoke took {time.perf_counter() - T_START:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
