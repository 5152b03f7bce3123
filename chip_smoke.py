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
   seconds under execution; the first 8 queries (ONLINE_QUERIES) as
   Poisson arrivals through the ``MicroBatcher`` at 0.5x and 0.9x of the
   offline specqp QPS (p50/p99 from submit to resolution), and all 8 at
   once drained by ``close()``, every future's result equal to the
   offline pass's (the pipelined passes serve the same 8);
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
   the kernel without softcap fails the same check) and gemma3-27b's
   local layer (32 / 16 heads of 128, window 1024), and timed at B = 4
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
   ``graph_synth.random_graph`` and GNN_FORWARDS forwards through
   ``gat.apply`` timed with the counters read around them (0 launches:
   the reference's GAT never calls the kernel); then per layer the kernel
   driven over every node on the layer's own logits and features in the
   padded-degree layout, held against its plain version and the layer's
   segment-op aggregation, and the layer's output against a float64
   oracle at 4,096 sampled nodes;
9. the sharded paths (``core/distributed.py``, ``launch/mesh.py``): the
   xkg workload with lists of up to 4 x 8192 items over 80,000 entities,
   hash-sharded by ``distributed.shard_workload`` into 4 partitions of
   about 8192 items (about 0.4 GB each), one a rank of a (2, 2) mesh of 4
   gloo ranks spawned on the one card (NCCL refuses two ranks on one
   device); each rank runs kg-specqp's ``serve_step`` on the 32 queries
   in specqp and trinit modes, exact and then sketch specqp (trinit plans
   nothing, so a sketch trinit step repeats the exact one), with the counters
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
   repeating one of 64 ids; values on a dyadic grid and not), ids above
   2**23 and the weights' gradient, each case twice: the touched rows
   bit-equal to the plain version run on the CPU over those rows alone
   (``bag_oracle``), every other row exactly 0, the two runs equal, the
   weights' gradient within rtol 1e-5 atol 1e-6. Timed by graph replay
   and per call at both sides of the batch and at the hot ids, beside the
   (V, D) zero-fill, the write-only bound and the old read-and-write one,
   the plain version and F.embedding_bag's backward. Then 6 steps of ``make_train_step`` on the example's batches
   with the counters set to 0 just before and read just after (2
   ``embedding_bag`` and 2 ``embedding_bag_backward`` launches a step),
   each step timed, the last split into gradients, global norm and
   update, peak memory printed. Then ``examples/train_retrieval.py``'s
   ``main`` at its defaults with failures injected before and after the
   first checkpoint (restores read back bit for bit, the loss falls, the
   final loss within rtol 1e-3 of a run without failures, the speculative
   top-10 exact), and one gat-cora train step at the ``full_graph_sm``
   shape, its gradients held against the CPU's;
11. LM training at the full width of gemma2-2b (``configs/gemma2_2b``,
   bf16, remat "full", ``TRAIN_CFG``): ``flash_attention_backward`` held
   against its plain twin (f32 math) at gemma2-2b's global and local layer
   and starcoder2-3b's layer, with a no-softcap case and a control that
   shows a backward without the softcap fails the check, and at its edges
   (S off the tiles, S one off the dQ pass's 128-row block, Sq < Sk, Sq >
   Sk, non-causal, windows of 1, of its 64 x 64 tile +- 1, of its dK/dV
   block's keys (128 at D = 128) +- 1 and of the forward's tile +- 1, GQA
   groups of 1, 2 and 12, (B, S, H, D) views),
   each case twice and bit-equal, the forward's o bit-equal with its lse
   output asked for and not, and lse against the twin's; timed at 4 x 4096
   beside its bound, the forward with lse, the plain twin and SDPA's
   backward. Then 4 steps at 4 x 4096 (cut from train_4k's 256 x 4096)
   on ``launch/train.py``'s batches with the counters set to 0 just before
   and read just after (52 ``flash_attention`` and 26
   ``flash_attention_backward`` launches a step), each timed, the last
   split into gradients, norm and update, peak memory printed; at B = 1,
   S = 1024 every parameter's gradient against the einsum attention's;
   then ``launch/train.py`` and ``examples/train_lm.py`` at smoke widths
   (head_dim 128, bf16 compute) with two injected failures each;
12. the MoE LM granite-moe-3b-a800m at its published widths
   (``configs/granite_moe_3b_a800m``, 32 layers, 40 experts top-8, 24 / 8
   heads of 64, bf16, random weights from a seed): ``flash_attention``
   and ``flash_attention_backward`` at head_dim 64 held against their
   plain versions at phase 7's and phase 11's bars (granite's layer, a
   softcap of 50 and a control without it, a window of 129, Sq < Sk,
   Sq > Sk, a ragged length, (B, S, H, D) views; each twice and
   bit-equal) and timed beside their bounds, the plain versions and SDPA;
   one MoE layer at full width in f32 through the card and through the
   port on the CPU on random hidden states, a forced-drop batch and a
   ragged length (the routing equal on 99.9 % of the tokens, zero rows
   routed to experts 0..K-1, the dropped slots equal and more than 0 in
   the forced-drop batch, the outputs within 1e-4 of each row's scale
   where the routing is equal, aux within 1e-5); then, served as in phase
   7 (32 ``flash_attention`` launches a prefill, none in decode; two
   prefills' logits bit-equal), trained as in phase 11 at 8 x 4096 (cut
   from train_4k's 256 x 4096; 64 forward and 32 backward launches a
   step, the aux loss printed), and ``launch/train.py --arch
   granite-moe-3b-a800m`` at smoke widths (head_dim 64, bf16 compute)
   with two injected failures, every restore read back bit for bit;
13. deepseek-v3-671b at its published widths, cut in depth
   (``configs/deepseek_v3_671b``: MLA with q.k 128 + 64 and v 128, 128
   heads, d_model 7168, bf16, random weights from a seed):
   ``flash_attention`` and ``flash_attention_backward`` at head_dim 192
   (v padded from 128, n_kv = n_heads) held against their plain twins at
   phase 7's and phase 11's bars at the serving layer (4 x 8192, the plain
   twin a batch row and a block of heads at a time), the training layer
   (4 x 4096), a softcap of 50 with its control, a window of 129, Sq < Sk,
   Sq > Sk, S one off the 112-key tile and the backward's tiles, a ragged
   length, (B, S, H, D) views and v not padded (o's and dv's padded
   columns exactly 0; each case twice and bit-equal), and timed beside
   MLA's bounds (640 and 1,664 flops a pair, the padded work's beside),
   the plain twins and SDPA by backend with v padded and at 128; then
   ``serve_card_config`` (4 layers, all 256 experts, 30.2 GB) served as
   phase 7 (4 ``flash_attention`` launches a prefill, none in decode; the
   latent caches' bytes beside a k / v cache's; the B = 1 checks over
   2048 tokens and all 4 layers on held experts), ``train_card_config`` (2
   layers and MTP, 32 experts, 46.6 GB of state) trained as phase 11 at 4
   x 4096 (6 forward and 3 backward launches a step: the MTP layer runs
   under remat like the others; lm_loss, mtp_loss and aux printed; the
   gradients at B = 1 against the einsum attention's over both layers and
   MTP on held experts), and ``launch/train.py --arch deepseek-v3-671b``
   at smoke widths with q.k at 128 + 64 in bf16 and two injected
   failures;
14. the equivariant GNNs (``configs/{egnn,nequip,mace}``) at their
   published widths: each CG tensor's sign and norm printed (a LAPACK that
   flips a path's sign shows); over phase 8's ogb_products graph (drawn
   there with positions, kept on the host), per model a warm-up and
   GNN_FORWARDS timed forwards through ``apply`` with the counters read
   around them (0 launches: the reference's models reach no Pallas
   kernel), ms, nodes/s and peak GB; one forward on rotated positions held
   to the equivariance bar; each layer driven on its own and held at
   GNN_ORACLE_NODES nodes against a float64 numpy oracle fed that layer's
   input; then at the molecule shape (128 molecules, 8,192 edges, 261
   self-loops) the card's gradients against the CPU's (EGNN's finite), 4
   ``TRAIN_CFG`` steps timed and ``smoke()`` on the card;
15. the dry run (``launch/dryrun.py``, ``sharding.py``, the sharded MoE
   ``models/moe.py`` ``_Layout``, the GNNs' ``graph.Partition``, the KG
   and retrieval kernels' custom ops, the executor's bounded trip, the
   vocab-parallel bag): (a) the
   20 LM cells (gemma2-2b, starcoder2-3b, gemma3-27b, granite-moe-3b-a800m
   and deepseek-v3-671b x train_4k, prefill_32k, decode_32k, long_500k; the
   MoE archs' long_500k must come out skipped with their configs'
   SKIP_SHAPES reasons), the 16 GNN cells (gat-cora, egnn, nequip and
   mace x full_graph_sm, minibatch_lg, ogb_products, molecule; one train
   step each), kg-specqp's serve_batch and serve_trinit (one executor trip)
   and the two-tower model's train_batch, serve_p99, serve_bulk and
   retrieval_cand, every other cell ok, laid over the 16 x 16 production
   mesh of a fake process group, fake CUDA tensors on this host, one process a
   cell, slowest first, in a thread that a whole run starts after phase 3
   (DRYRUN_JOBS_BESIDE processes at once, beside phases 4-14, at the
   lowest priority; they use the host's cores only) and ``--dryrun-only``
   at phase 15 (DRYRUN_JOBS): each
   cell's status, argument and peak GB a card, flops, collective bytes,
   roofline terms and the dominant one; (b) the dry run on a (1, 1) mesh
   of phases 7's, 11's, 12's and 13's cuts (gemma2-2b's prefill of 4 x
   8192 and step of 4 x 4096; granite's prefill of 4 x 8192 and step of 8
   x 4096; deepseek's serving cut's prefill of 4 x 8192 and training
   cut's step of 4 x 4096; bf16, remat "full") beside the peak and time
   of the same calls measured here, each predicted peak within
   DRYRUN_PEAK_BAND of the measured, and likewise each GNN's
   minibatch_lg cell (169,984 nodes, 168,960 edges, 602 features, at the
   published widths, not cut) beside one ``TRAIN_CFG`` step measured over
   ``graph_synth.random_graph`` of that shape, and kg-specqp's serve_batch
   at phase 4's store and queries, the two-tower serve_p99 and
   retrieval_cand cells and train_batch at phase 10's cut beside their
   runs in (c) (a measured peak there: the arguments plus what the call
   allocated); (c) gemma2-2b, granite and
   deepseek's serving cut, each laid by ``sharding.distribute`` onto a
   (1, 1) mesh of a 1-rank NCCL process group, a prefill of 4 x 8192
   through the constrain calls, the attention's custom op and the sharded
   MoE, its logits and caches bit-equal to the unsharded prefill's, one
   ``flash_attention`` launch a layer (26, 32, 4); then on the same mesh
   each GNN's minibatch_lg loss and gradients through the DTensor path
   (``graph.Partition``) against the unsharded ones (loss rtol 1e-5, each
   gradient leaf within 1e-5 of its largest |value|: the card's
   ``index_add_`` sums by atomics), and a train state saved after one step
   restored onto the mesh, every leaf bit-equal and placed as
   ``sharding.distribute`` places it; then kg-specqp's two cell functions
   (no trip bound) on phase 4's store and queries, their keys, scores,
   masks and four counters bit-equal to phase 9's NCCL serve step (n_wasted
   0), their launches equal to it, each mode's trips printed; the two-tower
   serve_p99 cell (the full-width model, a random 1,048,576-row corpus) and
   retrieval_cand cell (phase 5's corpus) bit-equal to the unsharded
   ``serve`` and ``retrieve``; at phase 10's cut the loss and gradients
   through the vocab-parallel bag within 1e-5 of the unsharded, then the
   train_batch cell's step; each with its launches equal to the unsharded
   path's;
16. print the kernel table as one JSON line (``launches``: each kernel's
   count on its own path, so 0 for ``neigh_softmax_agg`` on
   ``gat.apply``, phase 10's steps for ``embedding_bag_backward`` and
   phase 11's for ``flash_attention_backward``;
   ``neigh_softmax_agg``'s ``check_launches`` are those of the drive over
   the layers' data; rows 1-3 add ``sharded_launches``, summed over phase
   9's ranks; the two attention rows add phase 12's ``d64_*`` timings and
   ``granite_*`` launches and numbers and phase 13's ``d192_*`` and
   ``deepseek_*``, and ``flash_attention`` phase 15's
   ``sharded_prefill_launches``; rows 1-4b add phase 15 (c)'s
   ``sharded_cell_launches``), then the result line ``{"ok": true,
   "device": {...}}`` last.

It exits non-zero without CUDA and when ``src/repro_torch`` is not beside
it. It imports nothing of JAX. ``--attention-only`` runs phases 1-2 and
phase 7's ``flash_attention`` checks and timings, then stops without the
result line; ``--kg-only`` runs phases 1-3 and stops the same way;
``--kg-path-only`` runs phases 1-4 and stops the same way;
``--gather-only`` runs phases 1-2 and the checks and timings of
``embedding_bag`` (phase 6's, on one table of the model's shape) and of
``neigh_softmax_agg`` (phase 8's, with the NaN check), without the towers
or the graph, and stops the same way; ``--shard-only`` runs phases 1-2
and phase 9 (the NCCL run then checked against ``run_query_batch``
alone), and stops the same way; ``--train-only`` runs phases 1-2 and
phase 10, and stops the same way; ``--lm-train-only`` runs phases 1-2
and phase 11, and stops the same way; ``--attention-bwd-only`` runs phases
1-2 and phase 11's ``flash_attention_backward`` checks and timings, with
``--profile`` its time by kernel at the global and starcoder2-3b layers,
and stops the same way; ``--bag-bwd-only`` runs phases 1-2 and phase 10's
``embedding_bag_backward`` checks and timings without the steps, with
``--profile`` its time by kernel (the sort's passes, the segment pass),
and stops the same way; ``--moe-only`` runs phases 1-2 and phase 12, and
stops the same way; ``--mla-only`` runs phases 1-2 and phase 13, and
stops the same way; ``--e3gnn-only`` runs phases 1-2 and phase 14 (the
graph drawn there), and stops the same way; ``--dryrun-only`` runs
phases 1-2 and phase 15, and stops the same way.
``--profile`` adds ``torch.profiler``
windows (device busy share, time by kernel) over one retrieval query in
each mode, the serving batches, one LM prefill with 4 decode steps (of
gemma2-2b, granite-moe-3b-a800m and deepseek-v3-671b), one GAT forward,
one forward of each equivariant GNN, one full-width LM train step of each
and one specqp pass of the KG path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import threading
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
# Phase 4's pipelined, online and drain passes serve the first this many
# of the N_QUERIES queries.
ONLINE_QUERIES = 8
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
GNN_FORWARDS = 2
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
    # The pipelined, online and drain passes serve the first
    # ONLINE_QUERIES queries (the same checks, a quarter of the depth).
    qs = queries[:ONLINE_QUERIES]
    pipe = dataclasses.replace(bcfg, pipeline=True)
    for card, cfg, want in (("exact", exact_cfg, served["specqp"]),
                            ("sketch", sketch_cfg, sk_res)):
        ex = batching.BatchExecutor(wl.store, wl.relax, cfg, "specqp", pipe,
                                    device=dev)
        plans = record_spans(ex, "plan_group")
        runs = record_spans(ex, "run_stream")
        ops.reset_launches()
        res, wall, lat = serve.serve_offline(ex, qs)
        torch.cuda.synchronize()
        path_launches(ops, f"pipelined {card} pass")
        check_same_results(np, f"pipelined {card} pass", res,
                           want[:len(qs)])
        print(f"pipelined {card} ({len(qs)} queries): "
              f"{len(qs) / wall:.2f} QPS | "
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
            res, wall, lat = serve.serve_online(ex, qs, rate, SEED)
        except Exception as e:  # noqa: BLE001 — a future held an error
            fail(f"online replay at {rate:.3f}/s: {e!r}")
        launches = path_launches(ops, f"online replay at {rate:.3f}/s")
        check_same_results(np, f"online replay at {rate:.3f}/s", res,
                           served["specqp"][:len(qs)])
        print(f"online {frac:g}x ({rate:.3f} arrivals/s, {len(qs)} "
              f"queries): {len(qs) / wall:.2f} QPS | "
              f"{latency_line(np, lat)} | "
              f"{len(ex.stats)} executor calls, mean "
              f"{np.mean([s.n_requests for s in ex.stats]):.2f} requests | "
              f"launches {launches['rank_join_lookup']} + "
              f"{launches['merge_topk']} | results equal the offline pass")
    # close() serves what is still queued: submit all, close at once.
    ex = batching.BatchExecutor(wl.store, wl.relax, exact_cfg, "specqp",
                                bcfg, device=dev)
    ops.reset_launches()
    mb = batching.MicroBatcher(ex)
    futs = [mb.submit(q) for q in qs]
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
                       served["specqp"][:len(qs)])
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

    from repro_torch.configs import gemma3_27b, starcoder2_3b
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    g3 = gemma3_27b.config()
    g3win = max(g3.window_pattern)
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
              "bshd"),
             (f"{g3.name} local", 1, g3.n_heads, g3.n_kv, LM_SEQ, LM_SEQ,
              g3.head_dim, True, g3win, g3.attn_softcap, "")]
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
    # gemma3-27b's local layer at B = 1: 32 / 16 heads of 128, window 1024
    # (SDPA has no window: timed causal over the whole sequence).
    gq, gk, gv = attn_inputs(torch, gen, dev, 1, g3.n_heads, g3.n_kv, S, S,
                             g3.head_dim)
    g3t = dict(
        ms=cuda_ms(torch, lambda: ops.flash_attention(gq, gk, gv,
                                                      window=g3win),
                   blocks=5, per_block=2),
        bound=attn_bound(1, g3.n_heads, g3.n_kv, S, S, g3.head_dim, True,
                         g3win),
        library_ms=sdpa(gq, gk, gv))
    del gq, gk, gv
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
    b = g3t["bound"]
    print(f"flash_attention {g3.name} local layer (B=1 Hq={g3.n_heads} Hkv="
          f"{g3.n_kv} S={S} D={g3.head_dim} window={g3win}): kernel "
          f"{g3t['ms']:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), "
          f"{100 * b[0] / g3t['ms']:.1f} % of the bound's rate; "
          f"scaled_dot_product_attention (causal, no window) "
          f"{g3t['library_ms']} ms")
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
                gemma3_local_ms=g3t["ms"], gemma3_local_bound_ms=b[0],
                gemma3_library_ms=g3t["library_ms"],
                shape=f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} softcap={cap}, "
                      f"global layer; d128_*: {sc.name}'s layer, B={B} "
                      f"Hq={sc.n_heads} Hkv={sc.n_kv} S={S} D={sc.head_dim}; "
                      f"gemma3_*: {g3.name}'s local layer at B=1")


def lm_path(np, torch, ops, dev, prof: bool = False):
    """Phase 7: gemma2-2b at full width on the card; flash_attention
    checked and timed (``check_flash_attention``), then served
    (``serve_lm``)."""
    from repro_torch.configs import gemma2_2b

    cfg = gemma2_2b.config()
    return serve_lm(np, torch, ops, dev, cfg, prof, lambda: (
        check_flash_attention(np, torch, ops, dev, cfg)))


def serve_lm(np, torch, ops, dev, cfg, prof: bool, check,
             check_seq=None, check_layers=None):
    """An LM at full width on the card, random weights from SEED; then
    ``check()`` (the kernel checks, → the kernel row); then, with the
    launch counters read around them, LM_PREFILLS prefills of LM_BATCH x
    LM_SEQ tokens (the first's and the last's logits bit-equal) and
    LM_DECODE greedy decode steps; then the model-level checks at B = 1
    over ``check_seq`` tokens (LM_SEQ where None; an MoE model over its
    first ``check_layers`` layers, all of them where None). Returns the
    row and the prefills' launches."""
    import dataclasses as dc

    from repro_torch.models import transformer as tf

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
          f"{cfg.attn_softcap}"
          + (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k} of "
             f"{cfg.moe.d_ff_expert}" if cfg.moe else "") + ")")
    row = check()
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
        pf, first_logits = [], None
        for _ in range(LM_PREFILLS):
            caches = None
            t = time.perf_counter()
            logits, caches = tf.prefill(model, cfg, toks, max_seq)
            torch.cuda.synchronize()
            pf.append(time.perf_counter() - t)
            if first_logits is None:
                first_logits = logits.clone()
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
    cache_gb = sum(t.numel() * t.element_size() for c in caches
                   for t in c.values()) / 1e9
    line = (f"LM caches of {B} x {max_seq} positions: {cache_gb:.4f} GB "
            f"({', '.join(sorted(caches[0]))} a layer)")
    if cfg.mla:
        # What caching the direct form's k (q·k wide) and v would hold.
        m = cfg.mla
        kv_gb = (cfg.n_layers * B * max_seq * cfg.n_heads * 2
                 * (m.qk_nope_head_dim + m.qk_rope_head_dim + m.v_head_dim)
                 / 1e9)
        line += (f"; a k / v cache would hold {kv_gb:.4f} GB, "
                 f"{kv_gb / cache_gb:.1f}x")
    print(line)
    if not torch.equal(first_logits, logits):
        fail(f"two prefills of the same prompts give different logits: max "
             f"abs diff {float((first_logits - logits).abs().max()):.4g}")
    check_seq = check_seq or S
    batched_last = None if check_seq != S else logits[0, -1].float()
    print(f"LM prefill logits bit-equal between the first and the last of "
          f"the {LM_PREFILLS} prefills")
    del first_logits
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
    # decode step against the backbone over the extended prompt. An MoE
    # model's second computation takes the first's experts
    # (``held_routing``): a token whose K-th and (K+1)-th probabilities lie
    # within bf16's rounding of each other may pick another expert, and
    # that moves its whole row; the free-running differences are printed.
    ccfg, cs = cfg, check_seq
    if cfg.moe:
        with torch.no_grad():
            free_moe_diffs(torch, tf, model, cfg, toks[:, :cs], batched_last,
                           cs)
        if check_layers:
            ccfg = dc.replace(cfg, n_layers=check_layers)
        print(f"LM B=1 checks over {cs} tokens and the first "
              f"{ccfg.n_layers} layer(s), the einsum attention and the "
              f"decode step taking the kernel path's and the backbone's "
              f"experts")
    ecfg = dc.replace(ccfg, attn_impl="einsum")
    with torch.no_grad():
        one = toks[:1, :cs]
        routes = []
        with held_routing(record=routes):
            lk, caches = tf.prefill(model, ccfg, one, cs + 1)
        lk = lk[0, -1].float()
        with held_routing(replay=routes):
            lr, _ = tf.prefill(model, ecfg, one, cs + 1)
        lr = lr[0, -1].float()
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
        # The decode step against the backbone over the prompt extended by
        # the greedy token. An MoE chunk's capacity drops the assignments
        # of its last tokens first (slots fill token-major), where a
        # one-token decode step drops none: at a length that is a multiple
        # of the chunk the extended prompt's last token heads a chunk of
        # its own and keeps every expert, as in decode.
        ds = -(-cs // cfg.moe_chunk) * cfg.moe_chunk if cfg.moe else cs
        if ds != cs:
            one = toks[:1, :ds]
            lk, caches = tf.prefill(model, ccfg, one, ds + 1)
            nxt = lk[0, -1].argmax().view(1).to(torch.int32)
        routes = []
        with held_routing(record=routes):
            x, _ = tf.backbone(model, ccfg, torch.cat([one, nxt[:, None]],
                                                      1))
        lf = tf.logits_from_hidden(model, ccfg, x[:, -1])[0].float()
        pos = torch.full((1,), ds, dtype=torch.int32, device=dev)
        # The backbone's experts of position ds, one layer after another
        # (a layer's chunks may come in several calls: ``moe_ffn`` runs
        # them in batches of ``moe.chunks_at_once``).
        if routes:
            rows = torch.cat([r.reshape(-1, r.shape[-1]) for r in routes])
            rows = rows.view(sum(not d for d in ccfg.dense_layers()), -1,
                             rows.shape[-1])
            routes = [r[ds].view(1, 1, -1) for r in rows]
        with held_routing(replay=routes):
            ld, _ = tf.decode_step(model, ccfg, nxt, pos, caches, ds)
        ld = ld[0].float()
        tol = LM_LOGIT_TOL_STD * float(lf.std())
        diff = float((ld - lf).abs().max())
        print(f"LM B=1 decode step vs backbone over {ds + 1} tokens: max abs "
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
            profile_window(torch, f"one LM prefill of {B} x {LM_SEQ}",
                           lambda: out.extend(tf.prefill(model, cfg, toks,
                                                         max_seq)))
            logits, caches = out
            profile_window(torch, f"4 LM decode steps of {B}",
                           lambda: decode(caches, logits[:, -1].argmax(
                               -1).to(torch.int32), 4))
    row.update(prefill_ms=float(np.median(pf_ms)),
               decode_p50_ms=float(np.percentile(dec_ms, 50)),
               decode_p99_ms=float(np.percentile(dec_ms, 99)),
               serve_peak_gb=peak_gb, cache_gb=cache_gb)
    del model
    torch.cuda.empty_cache()
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


def gnn_path(np, torch, ops, dev, prof: bool = False, keep=None):
    """Phase 8: neigh_softmax_agg checked and timed; gat-cora at the
    ogb_products shape on the card, GNN_FORWARDS timed forwards through
    gat.apply (which launches the kernel 0 times, as the reference's GAT
    never calls it); then per layer the kernel driven over every node on
    the layer's own data in the padded-degree layout, held against its
    plain version and the layer's segment-op aggregation, and the layer's
    output against a float64 oracle at GNN_ORACLE_NODES nodes. The graph
    is drawn with positions (GAT ignores them; ``random_graph`` draws them
    last, so no other field changes); with ``keep`` a dict, it is left
    there on the host as ``keep["graph"]`` for phase 14."""
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
                                 geometric=True, device=dev)
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
    if keep is not None:
        keep["graph"] = graph_to(torch, g, "cpu")
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
# TriniT plans nothing: its sketch step would repeat its exact one.
SHARD_STEPS = (("exact", "specqp"), ("exact", "trinit"),
               ("sketch", "specqp"))
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
    # One warm-up (context, cuFFT plans, the allocator) off the clock: the
    # four steps share them.
    next(iter(fns.values()))(store, relax, gstats, queries[:1])
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
        if mode == "specqp":       # one warm-up: both modes share it
            fn(wl.store, wl.relax, wl.store.stats, queries[:1])
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
    Returns (each kernel's launches on the sharded paths, the NCCL runs by
    mode: their merged results and launches)."""
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
        print(f"NCCL world-1 {mode}: {N_QUERIES / run['wall']:.2f} QPS "
              f"({run['wall']:.3f} s a batch) | equal to run_query_batch"
              + (" and to phase 4's offline pass" if served is not None
                 else "") + f" | launches {run['launches']['rank_join_lookup']}"
              f" + {run['launches']['merge_topk']}")
    print(f"NCCL world-1 run took {time.perf_counter() - t3:.1f} s")
    print(f"sharded path launches (summed over ranks): {launches}")
    return launches, one


# Phase 10: training. Two-tower at the published widths with two cuts
# (vocab 20 M -> 10 M a table: 2 x 20 M x 256 x (4 param + 4 grad + 2 m +
# 2 v) B is 123 GB, over the card's 80 GB, and 61.4 GB at 10 M;
# train_batch 65,536 -> 16,384: a (B, B) f32 logits buffer is 17.2 GB at
# 65,536 and the loss holds about three, 1.07 GB each at 16,384), steps
# timed; the example with injected failures; GAT at the Cora shape.
TRAIN_VOCAB = 10_000_000
TRAIN_BATCH = 16_384
TRAIN_STEPS = 6          # the last one split into grads, norm and update
# embedding_bag_backward's table gradient is held bit for bit against the
# plain version on the CPU (the kernel sums each row in ascending slot
# order, as index_add_ on the CPU does; the card's index_add_ uses atomics);
# its weights' gradient (a shuffle tree) within this of the plain version.
BAG_BWD_RTOL, BAG_BWD_ATOL = 1e-5, 1e-6
# Hot-id cases: every bag repeats one id of this many (8,192 slots an id).
HOT_IDS = 64
EXAMPLE_FAILS = (50, 150)      # before and after the first checkpoint
EXAMPLE_LOSS_RTOL = 1e-3
# GAT at the Cora shape: card gradients against the CPU's, rtol and an
# atol of this share of the leaf's largest gradient (the card's index_add_
# adds edges in another order).
GAT_GRAD_RTOL, GAT_GRAD_ATOL_OF_SCALE = 1e-4, 1e-5
BAG_KERNELS = ("bag_sort_hist_kernel", "bag_sort_scan_kernel",
               "bag_sort_scatter_kernel", "bag_segment_kernel",
               "bag_long_run_kernel")


def bag_backward_case(np, torch, table, dev, rng, B, S, kind):
    """Inputs of one embedding_bag_backward check: (ids, weights, dout).
    ``hot``: every bag repeats one id of HOT_IDS; ``hot (dyadic)`` the same
    with weights and dout on a dyadic grid, so every sum is exact in any
    order."""
    V, D = table.shape
    if kind.startswith("hot"):
        ids = np.repeat(rng.integers(0, V, HOT_IDS)[rng.integers(
            0, HOT_IDS, B)][:, None], S, 1)
    else:
        lo = 2**23 if kind == "above 2**23" else 0
        ids = rng.integers(lo, V, (B, S))
        if kind in ("quarter -1", "weights"):
            ids[rng.random((B, S)) < 0.25] = -1
    if kind == "hot (dyadic)":
        w = rng.integers(1, 5, (B, S)) / 4.0
        dout = rng.integers(-8, 9, (B, D)) / 64.0
    else:
        w = rng.random((B, S))
        dout = rng.standard_normal((B, D))
    return [torch.from_numpy(np.asarray(a, dt)).to(dev) for a, dt in
            ((ids, np.int32), (w, np.float32), (dout, np.float32))]


def bag_oracle(torch, dout, ids, weights):
    """The plain version on the CPU over the touched rows only: (rows,
    grads), the distinct live ids ascending and their (n_rows, D) rows.
    The ids are remapped to their rows' places and index_add_ adds the
    same rounded products in the same slot order into (n_rows, D), so the
    rows equal a (V, D) run's without its host buffer."""
    from repro_torch.kernels import ref

    ids = ids.cpu()
    live = ids >= 0
    rows, local = torch.unique(ids[live].long(), return_inverse=True)
    remap = torch.full_like(ids, -1)
    remap[live] = local.to(ids.dtype)
    grads = ref.embedding_bag_backward(
        dout.cpu(), remap, weights.cpu(),
        torch.empty((rows.numel(), dout.shape[1])))[0]
    return rows, grads


def check_bag_grads(torch, label, got, ids, oracle):
    """(max abs err over touched rows, touched rows). Fails unless the
    touched rows equal the oracle's bit for bit and every other row is
    exactly 0."""
    rows, want = oracle
    touched = torch.zeros(got.shape[0], dtype=torch.bool, device=got.device)
    rows_dev = rows.to(got.device)
    touched[rows_dev] = True
    stray = got.ne(0).any(1) & ~touched
    if bool(stray.any()):
        fail(f"embedding_bag_backward {label}: wrote {int(stray.sum())} "
             f"untouched rows")
    a = got[rows_dev].cpu()
    err = float((a - want).abs().max()) if rows.numel() else 0.0
    if not torch.equal(a.view(torch.int32), want.view(torch.int32)):
        fail(f"embedding_bag_backward {label}: touched rows not bit-equal "
             f"to plain (max abs err {err:.4g}, "
             f"{int(a.ne(want).any(1).sum())} rows differ)")
    return err, int(rows.numel())


def profile_bag_backward(torch, cases) -> dict:
    """Five embedding_bag_backward calls on each of ``cases`` (name →
    (dout, ids, weights, table, _)) under torch.profiler: ms a call by
    kernel (the sort's histogram, scan and scatter over its passes, the
    segment pass)."""
    from repro_torch.kernels import embedding_bag as eb

    split = {}
    for side, (dout, ids, w, table, _) in cases.items():
        buf = torch.zeros_like(table)
        events = profile_window(torch, f"5 embedding_bag_backward calls, "
                                f"{side} bags", lambda: [
            eb.embedding_bag_backward(dout, ids, w, table, out=buf)
            for _ in range(5)])
        split[side] = {k: sum(t for key, t, _ in events if k in key) / 5
                       for k in BAG_KERNELS}
        print(f"embedding_bag_backward {side} by kernel, ms a call: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split[side].items()))
        del buf
    return split


def check_embedding_bag_backward(np, torch, ops, model, real, dev,
                                 prof: bool = False):
    """embedding_bag_backward before the optimizer state exists: on the
    first training batch's own ids and dout for each table (``real``: the
    calls recorded during a real backward), then on the user table at
    (TRAIN_BATCH, 32) with a quarter of the slots -1, hot ids (dyadic and
    not), ids above 2**23 and the weights' gradient. Each case: the table
    gradient bit-equal to ``bag_oracle``, every other row 0, a second run
    torch.equal. Timed at the batch's two shapes by device time (graph
    replay into a zeroed buffer) and per call, with the (V, D) zero-fill
    and the fill alone, at the hot ids, beside the write-only bound and
    the old read-and-write one, the plain version and F.embedding_bag's
    backward through torch.autograd.grad; ``prof``: ms by kernel."""
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as eb

    errs, rows = [], {}
    for side, (dout, ids, w, table, got) in real.items():
        e, n = check_bag_grads(torch, f"{side} batch", got,
                               ids, bag_oracle(torch, dout, ids, w))
        again = eb.embedding_bag_backward(dout, ids, w, table)[0]
        if not torch.equal(again, got):
            fail(f"embedding_bag_backward on the {side} batch: two runs "
                 f"differ")
        del again, got
        real[side][4] = None        # the gradient's 10 GB, no longer needed
        errs.append(e)
        print(f"embedding_bag_backward on training batch 0's {side} bags "
              f"{tuple(ids.shape)}: {n} touched rows bit-equal to plain on "
              f"the CPU, every other row 0, two runs equal")
    table = model.user.table.detach()
    V, D = table.shape
    rng = np.random.default_rng(SEED + 10)
    hot = None
    for kind in ("quarter -1", "hot (dyadic)", "hot", "above 2**23",
                 "weights"):
        ids, w, dout = bag_backward_case(np, torch, table, dev, rng,
                                         TRAIN_BATCH, 32, kind)
        runs = [ops.embedding_bag_backward(dout, ids, w, table,
                                           weights_grad=kind == "weights")
                for _ in range(2)]
        torch.cuda.synchronize()
        e, n = check_bag_grads(torch, kind, runs[0][0], ids,
                               bag_oracle(torch, dout, ids, w))
        errs.append(e)
        if not torch.equal(runs[0][0], runs[1][0]):
            fail(f"embedding_bag_backward ({kind}): two runs differ")
        if kind == "weights":
            want = ops.embedding_bag_backward(
                dout, ids, w, table, table_grad=False, weights_grad=True,
                impl="ref")[1]
            for got in runs:
                ew = float((got[1] - want).abs().max())
                if not torch.allclose(got[1], want, rtol=BAG_BWD_RTOL,
                                      atol=BAG_BWD_ATOL):
                    fail(f"embedding_bag_backward's weights' gradient "
                         f"differs from plain (max abs err {ew:.4g})")
                errs.append(ew)
        print(f"embedding_bag_backward V={V} D={D} B={TRAIN_BATCH} S=32 "
              f"({kind}): {n} touched rows bit-equal to plain on the CPU, "
              f"every other row 0, two runs equal"
              + (f"; the weights' gradient within rtol {BAG_BWD_RTOL} atol "
                 f"{BAG_BWD_ATOL}" if kind == "weights" else ""))
        if kind == "hot":
            hot = (ids, w, dout)
        del runs
    # Timings at the batch's shapes, on its own ids and dout.
    floor_ms = empty_launch_ms(torch)
    for side, (dout, ids, w, table, _) in real.items():
        table = table.detach()
        buf = torch.zeros_like(table)
        live = ids[ids >= 0]
        B, S = ids.shape
        touched = torch.unique(live.long())
        lib_ids = torch.where(ids >= 0, ids, 0)
        lib_w = torch.where(ids >= 0, w, 0.0)
        tl = table.detach().requires_grad_()
        lib_out = F.embedding_bag(lib_ids, tl, mode="sum",
                                  per_sample_weights=lib_w)
        reads = B * D * 4 + B * S * 8
        n_rows = int(touched.numel())
        rows[side] = dict(
            ms=graph_ms(torch, lambda: eb.embedding_bag_backward(
                dout, ids, w, table, out=buf)),
            call_ms=cuda_ms(torch, lambda: eb.embedding_bag_backward(
                dout, ids, w, table, out=buf)),
            alloc_call_ms=cuda_ms(torch, lambda: eb.embedding_bag_backward(
                dout, ids, w, table), blocks=5, per_block=2),
            memset_ms=graph_ms(torch, lambda: buf.zero_(), blocks=5,
                               per_block=4),
            rows_fill_ms=graph_ms(torch, lambda: buf.index_fill_(
                0, touched, 0.0)),
            memset_bound_ms=1e3 * V * D * 4 / HBM_BYTES_PER_S,
            plain_ms=cuda_ms(torch, lambda: ops.embedding_bag_backward(
                dout, ids, w, table, impl="ref"), blocks=5, per_block=2),
            library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                lib_out, tl, dout, retain_graph=True), blocks=5,
                per_block=2),
            bound=bound(reads + n_rows * D * 4, 2 * int(live.numel()) * D),
            rw_bound_ms=bound(reads + 2 * n_rows * D * 4,
                              2 * int(live.numel()) * D)[0],
            shape=f"V={V} D={D} B={B} S={S}, {int(live.numel())} live "
                  f"slots, {n_rows} distinct rows")
        del buf, lib_out, tl, touched
        r = rows[side]
        print(f"embedding_bag_backward {side} {r['shape']}: device "
              f"{r['ms']:.4f} ms ({100 * r['bound'][0] / r['ms']:.1f} % of "
              f"the write-only bound's rate), per call {r['call_ms']:.4f} "
              f"ms; with its (V, D) zero-fill per call "
              f"{r['alloc_call_ms']:.4f} ms (the fill alone "
              f"{r['memset_ms']:.4f} ms, bound {r['memset_bound_ms']:.4f}); "
              f"plain {r['plain_ms']:.4f} ms; F.embedding_bag backward "
              f"{r['library_ms']:.4f} ms; the touched rows zeroed by "
              f"index_fill_ {r['rows_fill_ms']:.4f} ms; bound "
              f"{r['bound'][0]:.5f} ms "
              f"({r['bound'][1]}; read and write {r['rw_bound_ms']:.5f}); "
              f"empty launch {floor_ms:.4f} ms")
    ids, w, dout = hot
    buf = torch.zeros_like(table)
    hot_ms = graph_ms(torch, lambda: eb.embedding_bag_backward(
        dout, ids, w, table, out=buf), blocks=5, per_block=5)
    del buf
    print(f"embedding_bag_backward hot ids ({HOT_IDS} ids, "
          f"{TRAIN_BATCH * 32 // HOT_IDS} slots an id): device "
          f"{hot_ms:.4f} ms")
    split = profile_bag_backward(torch, dict(
        real, hot=(dout, ids, w, table, None))) if prof else None
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
                bound_by=u["bound"][1], rw_bound_ms=u["rw_bound_ms"],
                library_ms=u["library_ms"], floor_ms=floor_ms,
                rows_fill_ms=u["rows_fill_ms"],
                item_rows_fill_ms=i["rows_fill_ms"],
                item_ms=i["ms"], item_call_ms=i["call_ms"],
                item_alloc_call_ms=i["alloc_call_ms"],
                item_plain_ms=i["plain_ms"], item_bound_ms=i["bound"][0],
                item_rw_bound_ms=i["rw_bound_ms"],
                item_library_ms=i["library_ms"], hot_ms=hot_ms,
                split_ms=split,
                shape=f"user {u['shape']}; item {i['shape']}")


def train_two_tower(np, torch, ops, dev, steps: bool = True,
                    prof: bool = False):
    """Phase 10 (a): the two-tower model at the published widths, vocab
    and batch cut (TRAIN_VOCAB, TRAIN_BATCH), TRAIN_CFG (bf16 moments).
    embedding_bag_backward checked and timed before the optimizer state
    exists (``prof``: by kernel); then, with ``steps``, TRAIN_STEPS steps
    of make_train_step on the example's batches with the launch counters
    read around them, each step timed and its metrics printed, the last
    split into gradients, norm and update. Returns (row, launches), the
    launches None without ``steps``."""
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
    row = check_embedding_bag_backward(np, torch, ops, model, real, dev,
                                       prof)
    del real
    torch.cuda.empty_cache()
    if not steps:
        return row, None

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


@contextlib.contextmanager
def checked_restores(torch):
    """While open, every checkpoint restored is held bit for bit against
    the state saved, and every restart's state against the state restored
    (or the initial snapshot); yields the list of what was checked."""
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

    checkpoint.AsyncCheckpointer.save = save
    checkpoint.restore, ft._copy_into = restore, copy_into
    try:
        yield checked
    finally:
        checkpoint.AsyncCheckpointer.save = orig_save
        checkpoint.restore, ft._copy_into = orig_restore, orig_copy


def train_example(np, torch, ops, dev):
    """Phase 10 (b): examples/train_retrieval.py's main at its defaults on
    the card, once with a failure injected before the first checkpoint
    and one after it, once without; every restore read back bit for bit
    against the state saved (or the initial snapshot), checkpoints in a
    temporary directory removed afterwards."""
    import tempfile
    from repro_torch.examples import train_retrieval
    from repro_torch.train import tree

    fails_left = set(EXAMPLE_FAILS)

    def hook(step):
        if step in fails_left:
            fails_left.discard(step)
            raise RuntimeError(f"injected failure at step {step}")

    ops.reset_launches()
    t0 = time.perf_counter()
    with checked_restores(torch) as checked, \
            tempfile.TemporaryDirectory() as d:
        broken = train_retrieval.main(
            ["--ckpt-dir", f"{d}/a", "--device", str(dev)], fail_hook=hook)
        launches = ops.launches()
        broken_s = time.perf_counter() - t0
        whole = train_retrieval.main(
            ["--ckpt-dir", f"{d}/b", "--device", str(dev)])
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
          f"runs {diff:.3g}; launches {launches}")
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


# Phase 11: LM training at the full width of gemma2-2b, bf16, remat
# "full", TRAIN_CFG. The batch is cut from train_4k's 256 x 4096 to
# LM_TRAIN_BATCH x 4096: under full remat the 26 layers' saved bf16 inputs
# alone take 256 x 4096 x 2304 x 2 B x 26 = 125.6 GB; at B = 4 they take
# 2.0 GB beside about 21 GB of bf16 parameters, gradients and moments.
LM_TRAIN_BATCH = 4
LM_TRAIN_SEQ = 4096
LM_TRAIN_STEPS = 4        # the last one split into grads, norm and update
# flash_attention_backward against its plain twin (f32 math on the same
# bf16 inputs, from its own f32 forward): each gradient's largest error
# within FA_BWD_TOL of that gradient's scale, its largest |value|, or,
# where the exact gradient cancels to 0 (a window of 1: dq = dk = 0), at
# least 2**-10 of the bound on one term (max|do| max|v| sqrt(D), times
# scale max|k| for dq and scale max|q| for dk).
FA_BWD_TOL = 2e-2
# The model-level check: at B = 1, S = LM_CHECK_SEQ each parameter's
# gradient through the kernels against the einsum attention's, relative
# L2 norm at most this (bf16 activations through 26 layers; a wrong
# attention gradient moves it by about 1).
LM_CHECK_SEQ = 1024
LM_GRAD_REL_L2 = 0.1
# The entry points on the card run the smoke configurations with
# head_dim 128 and bf16 compute, the shapes the kernels take (the smoke
# configurations' head_dim 16 in f32 is refused on CUDA tensors).
LM_EXAMPLE_FAILS = (50, 120)   # before and after the checkpoint at 100
LM_LAUNCH_FAILS = (2, 4)       # before and after the checkpoint at 3


def fa_bwd_bound(B, Hq, Hkv, Sq, Sk, D, causal, window) -> tuple[float, str]:
    """Least time in ms of the attention backward: 10·D flops per visible
    pair and head at the bf16 tensor-core peak, against q, o, do, k, v and
    lse read once and dq, dk, dv written once."""
    flops = 10 * D * B * Hq * live_pairs(Sq, Sk, causal, window)
    nbytes = 2 * D * B * (4 * Hq * Sq + 4 * Hkv * Sk) + 4 * B * Hq * Sq
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_flash_backward(np, torch, ops, dev, cfg):
    """flash_attention_backward against its plain twin at gemma2-2b's and
    starcoder2-3b's layers and at the kernel's edges, logits of std
    ATTN_LOGIT_STD; the forward's o bit-equal with lse asked for and not
    and its lse against the twin's; each case run twice and bit-equal; a
    control shows the backward without the softcap fails the check. Then
    timed at B = LM_TRAIN_BATCH, S = LM_TRAIN_SEQ beside its bound, the
    forward with lse, the plain twin and SDPA's backward. Returns the
    kernel row (launches filled in later)."""
    import torch.nn.functional as F

    from repro_torch.configs import starcoder2_3b
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    Hq, Hkv, D, cap = cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.attn_softcap
    local = max(cfg.window_pattern)
    sc = starcoder2_3b.config()
    S, bt = LM_TRAIN_SEQ, fa.BWD_ROWS

    def edge_windows(d):
        """1, the backward's 64 x 64 tile +- 1, its dK/dV block's keys
        (BWD_TILE[d]) +- 1, the forward's tile (its lse) +- 1."""
        return tuple(sorted({1, bt - 1, bt, bt + 1, fa.BWD_TILE[d] - 1,
                             fa.BWD_TILE[d] + 1, fa.TILE_N[d] - 1,
                             fa.TILE_N[d] + 1}))
    qr = fa.BWD_QROWS
    # (name, B, Hq, Hkv, Sq, Sk, D, causal, window, softcap, layout)
    cases = [("global", 1, Hq, Hkv, S, S, D, True, 0, cap, ""),
             ("local", 1, Hq, Hkv, S, S, D, True, local, cap, ""),
             ("global, no softcap", 1, Hq, Hkv, S, S, D, True, 0, None, ""),
             (sc.name, 1, sc.n_heads, sc.n_kv, 2048, 2048, sc.head_dim, True,
              max(sc.window_pattern), None, ""),
             ("S off the tiles", 1, Hq, Hkv, 1000, 1000, D, True, 300, cap,
              ""),
             *((f"S={n}", 1, Hq, Hkv, n, n, D, True, 0, cap, "")
               for n in (qr - 1, qr + 1)),
             *((f"S={n}, D=128", 1, 4, 2, n, n, 128, True, 0, None, "")
               for n in (qr - 1, qr + 1)),
             ("Sq<Sk", 2, Hq, Hkv, 100, 1000, D, True, 0, cap, ""),
             ("Sq<Sk, D=128", 1, 4, 2, 77, 300, 128, True, 0, None, ""),
             ("Sq>Sk", 1, Hq, Hkv, 300, 130, D, True, 0, cap, ""),
             ("non-causal", 1, Hq, Hkv, 500, 500, D, False, 0, None, ""),
             *((f"window {w}", 1, Hq, Hkv, 600, 600, D, True, w, cap, "")
               for w in edge_windows(D)),
             *((f"window {w}, D=128", 1, 4, 2, 600, 600, 128, True, w, None,
                "") for w in edge_windows(128)),
             ("GQA 1", 1, 4, 4, 700, 700, D, True, 0, cap, ""),
             ("GQA 12", 1, 24, 2, 700, 700, D, True, 0, cap, ""),
             ("GQA 12, D=128", 1, 24, 2, 700, 700, 128, True, 0, None, ""),
             ("(B, S, H, D)", 2, Hq, Hkv, 500, 500, D, True, 0, cap, "bshd"),
             ("(B, S, H, D), D=128", 2, 24, 2, 500, 500, 128, True, 64, None,
              "bshd")]
    worst = 0.0
    abs_err = 0.0
    for name, B, hq, hkv, Sq, Sk, d, causal, win, c, layout in cases:
        q, k, v = attn_inputs(torch, gen, dev, B, hq, hkv, Sq, Sk, d)
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        if layout == "bshd":
            q, k, v, do = (t.transpose(1, 2).contiguous().transpose(1, 2)
                           for t in (q, k, v, do))
        kw = dict(causal=causal, window=win, softcap=c)
        o, lse = fa.flash_attention_fwd_stats(q, k, v, **kw)
        o_plain_path = fa.flash_attention_fwd_stats(q, k, v, stats=False,
                                                    **kw)[0]
        got = ops.flash_attention_backward(q, k, v, o, lse, do, **kw)
        again = ops.flash_attention_backward(q, k, v, o, lse, do, **kw)
        po, plse = ref.flash_attention_fwd_stats(q.float(), k.float(),
                                                 v.float(), **kw)
        want = ref.flash_attention_bwd(q.float(), k.float(), v.float(), po,
                                       plse, do.float(), **kw)
        torch.cuda.synchronize()
        shape = (f"B={B} Hq={hq} Hkv={hkv} Sq={Sq} Sk={Sk} D={d} causal="
                 f"{causal} window={win} softcap={c} {layout}").strip()
        if not torch.equal(o, o_plain_path):
            fail(f"flash_attention ({name}: {shape}): o differs with lse "
                 f"asked for")
        live = torch.isfinite(plse)
        if not torch.equal(live, torch.isfinite(lse)) or (
                Sq > Sk and causal and live[:, :, :Sq - Sk].any()):
            fail(f"flash_attention ({name}): lse is not -inf exactly on "
                 f"the rows with no visible key")
        lse_err = float((lse - plse)[live].abs().max()) if live.any() else 0
        if lse_err > 1e-2:
            fail(f"flash_attention ({name}: {shape}): lse differs from the "
                 f"plain twin's by {lse_err:.4g}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"flash_attention_backward ({name}: {shape}): two runs "
                 f"differ")
        errs = ref.flash_attention_bwd_errors(got, want, q, k, v, do,
                                             d ** -0.5)
        e_abs = max(float((g.float() - w).abs().max())
                    for g, w in zip(got, want))
        if max(errs) > FA_BWD_TOL:
            fail(f"flash_attention_backward ({name}: {shape}) differs from "
                 f"its plain twin: dq, dk, dv errors {errs} of their scales "
                 f"(tolerance {FA_BWD_TOL})")
        worst, abs_err = max(worst, max(errs)), max(abs_err, e_abs)
        print(f"flash_attention_backward {name} ({shape}): dq, dk, dv "
              f"within {[round(x, 5) for x in errs]} of their scales of the "
              f"plain twin (tolerance {FA_BWD_TOL}, max abs err "
              f"{e_abs:.4g}), two runs bit-equal; the forward's o bit-equal "
              f"with lse asked for, lse within {lse_err:.3g} of the twin's")
        if name == "global":
            # Control: a backward that dropped the softcap fails the check.
            nocap = fa.flash_attention_backward(q, k, v, o, lse, do,
                                                causal=causal, window=win)
            e = ref.flash_attention_bwd_errors(nocap, want, q, k, v, do,
                                               d ** -0.5)
            if max(e) <= FA_BWD_TOL:
                fail(f"flash_attention_backward without its softcap is "
                     f"within the tolerance of the softcapped twin ({e}): "
                     f"the checks cannot see the softcap")
            print(f"flash_attention_backward control: without the softcap "
                  f"its errors are {[round(x, 4) for x in e]} of the "
                  f"softcapped twin's scales, outside {FA_BWD_TOL}")
            del nocap
        del q, k, v, do, o, lse, got, again, want, po, plse
    torch.cuda.empty_cache()

    B = LM_TRAIN_BATCH
    q, k, v = attn_inputs(torch, gen, dev, B, Hq, Hkv, S, S, D)
    do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)

    def sdpa_bwd(q, k, v, do):
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        try:
            out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                 enable_gqa=True)
            return cuda_ms(torch, lambda: torch.autograd.grad(
                out, (qs, ks, vs), do, retain_graph=True), blocks=5,
                per_block=2)
        except RuntimeError as e:     # no SDPA backend for these inputs
            print(f"scaled_dot_product_attention's backward refused the "
                  f"inputs: {e}")
            return None

    times = {}
    for name, win, c in (("global", 0, cap), ("local", local, cap),
                         ("no softcap", 0, None)):
        kw = dict(window=win, softcap=c)
        o, lse = fa.flash_attention_fwd_stats(q, k, v, **kw)
        times[name] = dict(
            ms=cuda_ms(torch, lambda: fa.flash_attention_backward(
                q, k, v, o, lse, do, **kw), blocks=5, per_block=2),
            fwd_ms=cuda_ms(torch, lambda: fa.flash_attention_fwd_stats(
                q, k, v, **kw), blocks=5, per_block=2),
            bound=fa_bwd_bound(B, Hq, Hkv, S, S, D, True, win))
        if name == "global":
            times[name]["plain_ms"] = cuda_ms(
                torch, lambda: ref.flash_attention_bwd(q, k, v, o, lse, do,
                                                       **kw),
                blocks=2, per_block=1)
        del o, lse
        torch.cuda.empty_cache()
    library_ms = sdpa_bwd(q, k, v, do)
    del q, k, v, do
    torch.cuda.empty_cache()
    sq, sk, sv = attn_inputs(torch, gen, dev, B, sc.n_heads, sc.n_kv, S, S,
                             sc.head_dim)
    sdo = torch.randn(sq.shape, generator=gen, device=dev).to(sq.dtype)
    swin = max(sc.window_pattern)
    so, slse = fa.flash_attention_fwd_stats(sq, sk, sv, window=swin)
    d128 = dict(
        ms=cuda_ms(torch, lambda: fa.flash_attention_backward(
            sq, sk, sv, so, slse, sdo, window=swin), blocks=5, per_block=2),
        bound=fa_bwd_bound(B, sc.n_heads, sc.n_kv, S, S, sc.head_dim, True,
                           swin),
        library_ms=sdpa_bwd(sq, sk, sv, sdo))
    del sq, sk, sv, sdo, so, slse
    torch.cuda.empty_cache()
    for name, t in times.items():
        b = t["bound"]
        print(f"flash_attention_backward {name} layer (B={B} Hq={Hq} "
              f"Hkv={Hkv} S={S} D={D}): kernel {t['ms']:.4f} ms, bound "
              f"{b[0]:.4f} ms ({b[1]}), {100 * b[0] / t['ms']:.1f} % of the "
              f"bound's rate; forward with lse {t['fwd_ms']:.4f} ms"
              + (f"; plain twin {t['plain_ms']:.4f} ms" if "plain_ms" in t
                 else ""))
    print(f"flash_attention_backward without softcap: kernel "
          f"{times['no softcap']['ms']:.4f} ms; scaled_dot_product_attention"
          f"'s backward (is_causal, enable_gqa) {library_ms} ms")
    b = d128["bound"]
    print(f"flash_attention_backward {sc.name} layer (B={B} Hq={sc.n_heads} "
          f"Hkv={sc.n_kv} S={S} D={sc.head_dim} window={swin}): kernel "
          f"{d128['ms']:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), "
          f"{100 * b[0] / d128['ms']:.1f} % of the bound's rate; "
          f"scaled_dot_product_attention's backward {d128['library_ms']} ms")
    g = times["global"]
    return dict(name="flash_attention_backward", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                replaces="src/repro/models/attention.py:299",
                note="port kernel, no TPU counterpart: the reference's "
                     "backward is XLA under jax.custom_vjp (_flash_bwd)",
                max_abs_err=abs_err, max_err_of_scale=worst, ms=g["ms"],
                plain_ms=g["plain_ms"], bound_ms=g["bound"][0],
                bound_by=g["bound"][1], library_ms=library_ms,
                library_vs="the kernel without softcap, nocap_ms",
                nocap_ms=times["no softcap"]["ms"],
                fwd_lse_ms=g["fwd_ms"], local_ms=times["local"]["ms"],
                local_bound_ms=times["local"]["bound"][0],
                d128_ms=d128["ms"], d128_bound_ms=b[0],
                d128_library_ms=d128["library_ms"],
                shape=f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} softcap={cap}, "
                      f"global layer; d128_*: {sc.name}'s layer, B={B} "
                      f"Hq={sc.n_heads} Hkv={sc.n_kv} S={S} D={sc.head_dim}")


def profile_flash_backward(torch, dev, cfg):
    """Five flash_attention_backward calls under torch.profiler (time by
    kernel) at gemma2-2b's global layer and at starcoder2-3b's, B =
    LM_TRAIN_BATCH, S = LM_TRAIN_SEQ."""
    from repro_torch.configs import starcoder2_3b
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 12)
    sc = starcoder2_3b.config()
    B, S = LM_TRAIN_BATCH, LM_TRAIN_SEQ
    for name, hq, hkv, d, win, c in (
            ("global", cfg.n_heads, cfg.n_kv, cfg.head_dim, 0,
             cfg.attn_softcap),
            (sc.name, sc.n_heads, sc.n_kv, sc.head_dim,
             max(sc.window_pattern), None)):
        q, k, v = attn_inputs(torch, gen, dev, B, hq, hkv, S, S, d)
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        kw = dict(window=win, softcap=c)
        o, lse = fa.flash_attention_fwd_stats(q, k, v, **kw)
        profile_window(torch, f"5 backward calls, {name}", lambda: [
            fa.flash_attention_backward(q, k, v, o, lse, do, **kw)
            for _ in range(5)])
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()


def train_lm_full(np, torch, ops, dev, prof: bool = False, cfg=None,
                  B: int = LM_TRAIN_BATCH, check_layers=None):
    """Phase 11 (b): gemma2-2b (or ``cfg``) at its published widths,
    LM_TRAIN_STEPS steps of make_train_step at B x LM_TRAIN_SEQ on the
    launcher's batches, the counters set to 0 just before and read just
    after (each layer, the MTP layer too: one forward launch, one in the
    remat recompute, one backward); each step timed, the last split into
    gradients, global norm and update; with ``prof`` one more step under
    torch.profiler. Then at B = 1, S = LM_CHECK_SEQ each parameter's
    gradient through the kernels against the einsum attention's (an MoE
    model's over its first ``check_layers`` layers, all where None, on
    held experts). Returns the launches."""
    import dataclasses as dc

    from repro_torch.configs import gemma2_2b, lm_common
    from repro_torch.launch import train as train_launch
    from repro_torch.models import transformer as tf
    from repro_torch.train import loop, optimizer as opt_lib, tree

    cfg = cfg or gemma2_2b.config()
    tc = lm_common.TRAIN_CFG
    S, n = LM_TRAIN_SEQ, LM_TRAIN_STEPS
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    model = tf.init(cfg, gen, dev)
    state = loop.make_train_state(tf.param_tree(model), tc)
    n_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(
        [state["params"], state["opt"]["m"], state["opt"]["v"]]))
    print(f"LM training {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.param_dtype} parameters, remat "
          f"{cfg.remat}, batch {B} x {S}, moments {tc.opt.moment_dtype}: "
          f"{n_bytes / 1e9:.3f} GB of parameters and moments")

    def loss(p, b):
        return tf.loss_fn(p, cfg, b["tokens"], b["labels"])

    step = loop.make_train_step(loss, tc)
    batches = [train_launch.synth_lm_batch(cfg, B, S, s, dev)
               for s in range(n)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    step_ms, hist = [], []
    for s, b in enumerate(batches):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        if s < n - 1:
            e[0].record()
            state, m = step(state, b)
            e[3].record()
        else:
            e[0].record()
            grads, m = loop.compute_grads(loss, state["params"], b)
            e[1].record()
            opt_lib.global_norm(grads)
            e[2].record()
            _, _, om = opt_lib.apply_updates(state["params"], grads,
                                             state["opt"], tc.opt)
            e[3].record()
            m = dict(m, **om)
            del grads
        e[3].synchronize()
        step_ms.append(e[0].elapsed_time(e[3]))
        hist.append({k: float(v) for k, v in m.items()})
        mtp = (f" lm_loss {hist[-1]['lm_loss']:.6f} mtp_loss "
               f"{hist[-1]['mtp_loss']:.6f}" if cfg.mtp_depth else "")
        print(f"LM train step {s}: loss {hist[-1]['loss']:.6f}{mtp} aux_loss "
              f"{hist[-1]['aux_loss']:.6f} grad_norm "
              f"{hist[-1]['grad_norm']:.6f} lr {hist[-1]['lr']:.3g} "
              f"({step_ms[-1]:.3f} ms)")
    launches = ops.launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    fwd_bwd, norm = e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2])
    update = e[2].elapsed_time(e[3]) - norm      # apply_updates norms too
    med = float(np.median(step_ms[1:]))
    print(f"LM train step (median of the last {n - 1}): {med:.3f} ms, "
          f"{B * S / med * 1e3:.1f} tokens/s; the last split: forward + "
          f"backward {fwd_bwd:.3f} ms, global norm {norm:.3f} ms, update "
          f"{update:.3f} ms; peak allocated {peak_gb:.3f} GB")
    print(f"LM training launches: {launches}")
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist):
        fail(f"an LM training step's loss or norm is not finite: {hist}")
    if int(state["opt"]["step"]) != n:
        fail(f"opt.step is {int(state['opt']['step'])} after {n} steps")
    # Each attention layer, the MTP layer's too (the port runs it under
    # remat like the others), launches the forward twice a step.
    n_attn = cfg.n_layers + (1 if cfg.mtp_depth else 0)
    want = {"flash_attention": 2 * n_attn * n,
            "flash_attention_backward": n_attn * n}
    for name, count in want.items():
        if launches[name] != count:
            fail(f"LM training launched {name} {launches[name]} times, not "
                 f"{count}: {launches}")
    if cfg.moe and not all(h["aux_loss"] > 0 for h in hist):
        fail(f"an MoE LM step's aux loss is not positive: {hist}")
    if prof:
        events = profile_window(torch, f"one {cfg.name} train step of {B} "
                                       f"x {S}",
                                lambda: step(state, batches[0]))
        for kernel in ("flash_attention_kernel", "delta_kernel",
                       "dkdv_kernel", "dq_kernel"):
            ms = sum(t for key, t, _ in events if kernel in key)
            calls = sum(n for key, _, n in events if kernel in key)
            print(f"profile (LM train step): {kernel} {ms:.3f} ms of "
                  f"device time over {calls} launches")
    del batches
    torch.cuda.empty_cache()

    # At B = 1: the kernels' gradients against the einsum attention's, an
    # MoE model's over its first MOE_CHECK_LAYERS layers, its einsum run
    # taking the kernel run's experts in the same order of calls (remat's
    # recomputations included).
    one = train_launch.synth_lm_batch(cfg, 1, LM_CHECK_SEQ, 99, dev)
    if cfg.moe and check_layers:
        gk = loop.value_and_grad(loss, state["params"], one)[2]
        ge = loop.value_and_grad(
            lambda p, b: tf.loss_fn(p, dc.replace(cfg, attn_impl="einsum"),
                                    b["tokens"], b["labels"]),
            state["params"], one)[2]
        free = max(float(torch.linalg.vector_norm(a.float() - b.float())
                         / torch.linalg.vector_norm(b.float()).clamp(
                             min=1e-30))
                   for a, b in zip(tree.leaves(gk), tree.leaves(ge)))
        print(f"LM B=1 S={LM_CHECK_SEQ} gradients over all {cfg.n_layers} "
              f"layers, routing freely: worst relative L2 {free:.4g} "
              f"(not held; see MOE_CHECK_LAYERS)")
        del gk, ge
        cfg = dc.replace(cfg, n_layers=check_layers)

        def loss(p, b):
            return tf.loss_fn(p, cfg, b["tokens"], b["labels"])
    ecfg = dc.replace(cfg, attn_impl="einsum")
    routes = []
    with held_routing(record=routes):
        _, _, gk = loop.value_and_grad(loss, state["params"], one)
    n_routes = len(routes)
    with held_routing(replay=routes) as flips:
        _, _, ge = loop.value_and_grad(
            lambda p, b: tf.loss_fn(p, ecfg, b["tokens"], b["labels"]),
            state["params"], one)
    if routes:
        fail(f"the einsum run routed {n_routes - len(routes)} times, the "
             f"kernel run {n_routes}")
    if cfg.moe:
        print(f"LM B=1 S={LM_CHECK_SEQ} gradients: the einsum run's own "
              f"experts differ for {flips[0]} tokens over {n_routes} router "
              f"calls; it takes the kernel run's")
    rel = {}
    for (name, a), b in zip(tree.flatten(gk), tree.leaves(ge)):
        if not (a.any() or b.any()):    # a layer past the check's depth
            continue
        a, b = a.float(), b.float()
        rel[name] = float(torch.linalg.vector_norm(a - b)
                          / torch.linalg.vector_norm(b).clamp(min=1e-30))
    worst = max(rel, key=rel.get)
    med_rel = float(np.median(list(rel.values())))
    first = next(f"layers/0/attn/{w}" for w in ("wq", "w_uq")
                 if f"layers/0/attn/{w}" in rel)
    print(f"LM B=1 S={LM_CHECK_SEQ} gradients, kernels vs einsum attention: "
          f"relative L2 error median {med_rel:.4g}, worst {rel[worst]:.4g} "
          f"({worst}; tolerance {LM_GRAD_REL_L2}); embed {rel['embed']:.4g}, "
          f"{first} {rel[first]:.4g}"
          + (f", mtp/proj {rel['mtp/proj']:.4g}" if "mtp/proj" in rel
             else ""))
    if rel[worst] > LM_GRAD_REL_L2:
        fail(f"the kernels' gradient of {worst} differs from the einsum "
             f"attention's by {rel[worst]:.4g} (relative L2)")
    del gk, ge, state, model
    torch.cuda.empty_cache()
    return launches, dict(step_ms=med, fwd_bwd_ms=fwd_bwd, norm_ms=norm,
                          update_ms=update, train_peak_gb=peak_gb,
                          train_losses=[h["loss"] for h in hist],
                          train_aux=[h["aux_loss"] for h in hist],
                          train_mtp=[h.get("mtp_loss") for h in hist],
                          grad_rel_l2_worst=rel[worst])


def train_lm_examples(np, torch, ops, dev):
    """Phase 11 (c): launch/train.py and examples/train_lm.py on the card
    at smoke widths (head_dim 128 and bf16 compute, which the kernels
    take), each with a failure injected before its first checkpoint and
    one after it; the example's loss falls and ends within
    EXAMPLE_LOSS_RTOL of a run without failures."""
    import dataclasses as dc
    import tempfile

    from repro_torch.configs import gemma2_2b
    from repro_torch.examples import train_lm
    from repro_torch.launch import train as train_launch

    orig = gemma2_2b.smoke_config

    def card_smoke():
        return dc.replace(orig(), head_dim=128, compute_dtype="bfloat16")

    def hook_for(steps):
        left = set(steps)

        def hook(s):
            if s in left:
                left.discard(s)
                raise RuntimeError(f"injected failure at step {s}")
        return hook, left

    gemma2_2b.smoke_config = card_smoke
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as d:
            hook, left = hook_for(LM_LAUNCH_FAILS)
            out = train_launch.main(
                ["--arch", "gemma2-2b", "--steps", "6", "--batch", "4",
                 "--seq", "256", "--ckpt-every", "3", "--ckpt-dir",
                 f"{d}/launch", "--device", str(dev)], fail_hook=hook)
            if out["failures"] != 2 or left or int(
                    out["state"]["opt"]["step"]) != 6:
                fail(f"launch/train.py saw {out['failures']} failures and "
                     f"ended at step {int(out['state']['opt']['step'])}")
            hook, left = hook_for(LM_EXAMPLE_FAILS)
            broken = train_lm.main(["--ckpt-dir", f"{d}/a", "--device",
                                    str(dev)], fail_hook=hook)
            launches = ops.launches()
            whole = train_lm.main(["--ckpt-dir", f"{d}/b", "--device",
                                   str(dev)])
    finally:
        gemma2_2b.smoke_config = orig
    h, hw = broken["history"], whole["history"]
    last, ref_last = h[-1]["loss"], hw[-1]["loss"]
    print(f"launch/train.py and examples/train_lm.py on the card "
          f"({time.perf_counter() - t0:.1f} s): launcher 6 steps with "
          f"failures at {LM_LAUNCH_FAILS}, loss "
          f"{out['history'][0]['loss']:.4f} -> "
          f"{out['history'][-1]['loss']:.4f}; example "
          f"{broken['failures']} failures at {LM_EXAMPLE_FAILS}, loss "
          f"{h[0]['loss']:.4f} -> {last:.4f}, without failures "
          f"{ref_last:.4f}; launches {launches}")
    if broken["failures"] != 2 or left:
        fail(f"the LM example saw {broken['failures']} failures")
    if abs(last - ref_last) > EXAMPLE_LOSS_RTOL * abs(ref_last):
        fail(f"the LM example's final loss {last} is not within rtol "
             f"{EXAMPLE_LOSS_RTOL} of the failure-free run's {ref_last}")
    for name in ("flash_attention", "flash_attention_backward"):
        if not launches[name]:
            fail(f"the LM example did not launch {name}: {launches}")
    return launches


def lm_train_path(np, torch, ops, dev, prof: bool = False):
    """Phase 11: the attention backward checked and timed, gemma2-2b
    trained at full width, the entry points on the card. Returns the
    flash_attention_backward row and the full-width steps' launches."""
    from repro_torch.configs import gemma2_2b

    t0 = time.perf_counter()
    row = check_flash_backward(np, torch, ops, dev, gemma2_2b.config())
    print(f"phase 11's kernel checks and timings took "
          f"{time.perf_counter() - t0:.1f} s")
    launches, train = train_lm_full(np, torch, ops, dev, prof)
    row.update(train)
    row["example_launches"] = train_lm_examples(np, torch, ops, dev)
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s")
    return row, launches


# Phase 12: the MoE LM granite-moe-3b-a800m at its published widths, bf16,
# random weights from SEED. Serving as phase 7 (LM_BATCH x LM_SEQ prefills
# cut from prefill_32k's 32 x 32768, LM_DECODE decode steps at LM_BATCH cut
# from decode_32k's 128 x 32768). Training at MOE_TRAIN_BATCH x 4096, cut
# from train_4k's 256 x 4096: under full remat the 32 saved bf16 layer
# inputs alone take 256 x 4096 x 1536 x 2 B x 32 = 103 GB; at 8 they take
# 3.2 GB beside about 26 GB of bf16 parameters, gradients and moments.
MOE_TRAIN_BATCH = 8
# The layer check, one MoE layer in f32 on the card and on the CPU: a full
# chunk of 4096 tokens (4 x 1024 at chunk 4096), the same with three in
# four tokens one row (its 8 experts overflow C = 1024), and 4 x 1500
# (sc = 1024: the second chunk holds 4 x 548 zero rows). The expert
# indices equal on this share of the tokens at least, the outputs within
# MOE_OUT_RTOL of each row's largest |value| where the routing is equal,
# aux within MOE_AUX_TOL.
MOE_LAYER_BATCH = 4
MOE_LAYER_SEQ = 1024
MOE_RAGGED_SEQ = 1500
MOE_ROUTE_AGREE = 0.999
MOE_OUT_RTOL = 1e-4
MOE_AUX_TOL = 1e-5
MOE_LAUNCH_FAILS = (2, 4)      # before and after the checkpoint at 3
# The model-level checks at B = 1 (kernels against the einsum attention,
# a decode step against the backbone, gradients) run an MoE model over its
# first MOE_CHECK_LAYERS layers, the second computation taking the first's
# experts. At the reference's init (experts at 1/sqrt(E)) each MoE layer
# multiplies a perturbation of its input, so through 32 layers bf16
# rounding alone moves a row by several std: the full-depth differences,
# and those between the same prompt served at B = 1 and at B = 4 by the
# same kernels, are printed beside.
MOE_CHECK_LAYERS = 1


# The plain twins hold (B, H, Sq, Sk) f32 logits; above this many bytes
# they run a batch row and a block of heads at a time (``plain_attention``).
PLAIN_LOGIT_BYTES = 4e9


def plain_attention(torch, q, k, v, do, kw):
    """The plain twins on the card in f32: (o, lse) of
    ``ref.flash_attention_fwd_stats`` and, with ``do``, (dq, dk, dv) of
    ``ref.flash_attention_bwd`` from that o and lse. Where the call's
    logits would take more than PLAIN_LOGIT_BYTES, one batch row and a
    block of whole GQA groups of heads at a time (each head's arithmetic
    is its own)."""
    from repro_torch.kernels import ref

    B, Hq, Sq, _ = q.shape
    Sk, g = k.shape[2], Hq // k.shape[1]
    if B * Hq * Sq * Sk * 4 <= PLAIN_LOGIT_BYTES:
        po, plse = ref.flash_attention_fwd_stats(q.float(), k.float(),
                                                 v.float(), **kw)
        want = None if do is None else ref.flash_attention_bwd(
            q.float(), k.float(), v.float(), po, plse, do.float(), **kw)
        return po, plse, want
    step = max(g, int(PLAIN_LOGIT_BYTES // (Sq * Sk * 4)) // g * g)
    po = torch.empty(q.shape, device=q.device)
    plse = torch.empty(q.shape[:3], device=q.device)
    want = None if do is None else [torch.empty(t.shape, device=q.device)
                                    for t in (q, k, v)]
    for b in range(B):
        for h0 in range(0, Hq, step):
            hq = slice(h0, min(h0 + step, Hq))
            hk = slice(hq.start // g, hq.stop // g)
            qs, ks, vs = (t[b:b + 1, hs].float()
                          for t, hs in ((q, hq), (k, hk), (v, hk)))
            o_, l_ = ref.flash_attention_fwd_stats(qs, ks, vs, **kw)
            po[b:b + 1, hq], plse[b:b + 1, hq] = o_, l_
            if do is not None:
                grads = ref.flash_attention_bwd(
                    qs, ks, vs, o_, l_, do[b:b + 1, hq].float(), **kw)
                for w, gr, hs in zip(want, grads, (hq, hk, hk)):
                    w[b:b + 1, hs] = gr
            del qs, ks, vs, o_, l_
    return po, plse, want


def check_flash_cases(np, torch, ops, dev, gen, D, cases, pad_v=None):
    """Both attention kernels at head_dim D against their plain twins at
    phase 7's bar (rtol / atol 2e-2) and phase 11's (FA_BWD_TOL of each
    gradient's scale), each case twice and bit-equal. ``cases``: (name,
    B, Hq, Hkv, Sq, Sk, causal, window, softcap, layout, backward too);
    layout "bshd" passes (B, S, H, D) views, "pad" zeroes v's and dO's
    columns from ``pad_v`` on, as MLA pads v (o's and dv's there must be
    exactly 0). A softcap case's control: the kernels without it fail the
    bars. Returns (forward max abs err, backward max abs err, backward
    worst error of scale)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    f_err = b_abs = b_worst = 0.0
    for name, B, Hq, Hkv, Sq, Sk, causal, win, c, layout, bwd in cases:
        q, k, v = attn_inputs(torch, gen, dev, B, Hq, Hkv, Sq, Sk, D)
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        if "pad" in layout:
            v[..., pad_v:] = 0
            do[..., pad_v:] = 0
        if "bshd" in layout:
            q, k, v, do = (t.transpose(1, 2).contiguous().transpose(1, 2)
                           for t in (q, k, v, do))
        kw = dict(causal=causal, window=win, softcap=c)
        shape = (f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Sk={Sk} D={D} window="
                 f"{win} softcap={c} {layout}").strip()
        label = f"D={D} ({name}: {shape})"
        got = ops.flash_attention(q, k, v, **kw)
        again = ops.flash_attention(q, k, v, **kw)
        po, plse, want = plain_attention(torch, q, k, v, do if bwd else None,
                                         kw)
        torch.cuda.synchronize()
        e = float((got.float() - po).abs().max())
        if not torch.allclose(got.float(), po, rtol=2e-2, atol=2e-2):
            fail(f"flash_attention {label} differs from its plain version: "
                 f"max abs err {e:.4g}")
        if not torch.equal(got, again):
            fail(f"flash_attention {label}: two runs differ")
        if Sq > Sk and got[:, :, :Sq - Sk].abs().max() != 0:
            fail(f"flash_attention {label}: a row with no visible key is "
                 f"not exactly 0")
        if "pad" in layout and got[..., pad_v:].any():
            fail(f"flash_attention {label}: o's padded columns are not 0")
        f_err = max(f_err, e)
        line = (f"flash_attention {label}: within rtol/atol 2e-2 of plain "
                f"(max abs err {e:.4g}), two runs bit-equal")
        if bwd:
            o, lse = fa.flash_attention_fwd_stats(q, k, v, **kw)
            if not torch.equal(o, got):
                fail(f"flash_attention {label}: o differs with lse asked "
                     f"for")
            live = torch.isfinite(plse)
            lse_err = float((lse - plse)[live].abs().max())
            if not torch.equal(live, torch.isfinite(lse)) or lse_err > 1e-2:
                fail(f"flash_attention {label}: lse differs from the plain "
                     f"twin's ({lse_err:.4g})")
            g = ops.flash_attention_backward(q, k, v, o, lse, do, **kw)
            g2 = ops.flash_attention_backward(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(g, g2)):
                fail(f"flash_attention_backward {label}: two runs differ")
            if "pad" in layout and g[2][..., pad_v:].any():
                fail(f"flash_attention_backward {label}: dv's padded "
                     f"columns are not 0")
            errs = ref.flash_attention_bwd_errors(g, want, q, k, v, do,
                                                 D ** -0.5)
            if max(errs) > FA_BWD_TOL:
                fail(f"flash_attention_backward {label} differs from its "
                     f"plain twin: {errs} of the gradients' scales "
                     f"(tolerance {FA_BWD_TOL})")
            b_worst = max(b_worst, max(errs))
            b_abs = max(b_abs, max(float((a.float() - w).abs().max())
                                   for a, w in zip(g, want)))
            line += (f"; backward within {[round(x, 5) for x in errs]} of "
                     f"the scales (tolerance {FA_BWD_TOL}), two runs "
                     f"bit-equal, lse within {lse_err:.3g}")
            if c:
                # Control: kernels that dropped the softcap fail the bars.
                nocap = ops.flash_attention(q, k, v, causal=causal,
                                            window=win).float()
                nb = fa.flash_attention_backward(q, k, v, o, lse, do,
                                                 causal=causal, window=win)
                ne = ref.flash_attention_bwd_errors(nb, want, q, k, v, do,
                                                    D ** -0.5)
                if torch.allclose(nocap, po, rtol=2e-2, atol=2e-2) or (
                        max(ne) <= FA_BWD_TOL):
                    fail(f"flash_attention {label}: the kernels without the "
                         f"softcap pass the checks")
                line += (f"; control: without the softcap forward max abs "
                         f"err {float((nocap - po).abs().max()):.4g}, "
                         f"backward {[round(x, 4) for x in ne]}")
                del nocap, nb
            del o, lse, g, g2
        print(line)
        del q, k, v, do, got, again, po, plse, want
        torch.cuda.empty_cache()
    return f_err, b_abs, b_worst


def check_flash_64(np, torch, ops, dev, cfg):
    """flash_attention and flash_attention_backward at head_dim 64 (the
    kernels' D = 64 builds) against their plain versions at phase 7's bar
    (rtol / atol 2e-2) and phase 11's (FA_BWD_TOL of each gradient's
    scale): granite's layer (the forward at 1 x LM_SEQ, whose plain
    (B, H, S, S) f32 logits take 6.4 GB; both at 1 x LM_TRAIN_SEQ), a
    softcap of 50 with logits of std ATTN_LOGIT_STD (and a control: the
    kernels without it fail), a window of 129, Sq < Sk, Sq > Sk, a ragged
    length and (B, S, H, D) views, each twice and bit-equal. Then timed at
    LM_BATCH x LM_SEQ (forward) and LM_BATCH x LM_TRAIN_SEQ (backward)
    beside their bounds, the plain versions and SDPA's forward and
    backward. Returns (forward entries, backward entries)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 25)
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv, cfg.head_dim
    S, St = LM_SEQ, LM_TRAIN_SEQ
    # (name, B, Sq, Sk, causal, window, softcap, layout, backward too)
    cases = [("granite layer", 1, S, S, True, 0, None, "", False),
             ("granite layer", 1, St, St, True, 0, None, "", True),
             ("softcap 50", 1, 2048, 2048, True, 0, 50.0, "", True),
             ("window 129", 1, 1500, 1500, True, 129, None, "", True),
             ("Sq<Sk", 2, 300, 1000, True, 0, None, "", True),
             ("Sq>Sk", 1, 700, 300, True, 0, None, "", True),
             ("ragged", 1, 3001, 3001, True, 0, 50.0, "", True),
             ("(B, S, H, D)", 2, 500, 500, True, 64, None, "bshd", True)]
    f_err, b_abs, b_worst = check_flash_cases(
        np, torch, ops, dev, gen, D,
        [(n, B, Hq, Hkv, *rest) for n, B, *rest in cases])

    def sdpa(q, k, v, do=None):
        try:
            if do is None:
                return cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), blocks=5,
                    per_block=2)
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                 enable_gqa=True)
            return cuda_ms(torch, lambda: torch.autograd.grad(
                out, (qs, ks, vs), do, retain_graph=True), blocks=5,
                per_block=2)
        except RuntimeError as e:     # no SDPA backend for these inputs
            print(f"scaled_dot_product_attention refused the inputs: {e}")
            return None

    B = LM_BATCH
    q, k, v = attn_inputs(torch, gen, dev, B, Hq, Hkv, S, S, D)
    fwd = dict(d64_ms=cuda_ms(torch, lambda: ops.flash_attention(q, k, v),
                              blocks=5, per_block=2),
               d64_bound_ms=attn_bound(B, Hq, Hkv, S, S, D, True, 0)[0],
               d64_library_ms=sdpa(q, k, v),
               d64_plain_b1_ms=cuda_ms(torch, lambda: ops.flash_attention(
                   q[:1], k[:1], v[:1], impl="ref"), blocks=2, per_block=1),
               d64_bound_b1_ms=attn_bound(1, Hq, Hkv, S, S, D, True, 0)[0],
               d64_max_abs_err=f_err,
               d64_shape=f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D}, "
                         f"{cfg.name}'s layer; plain_b1 at B=1")
    del q, k, v
    torch.cuda.empty_cache()
    q, k, v = attn_inputs(torch, gen, dev, B, Hq, Hkv, St, St, D)
    do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    o, lse = fa.flash_attention_fwd_stats(q, k, v)
    bwd = dict(d64_ms=cuda_ms(torch, lambda: fa.flash_attention_backward(
                   q, k, v, o, lse, do), blocks=5, per_block=2),
               d64_bound_ms=fa_bwd_bound(B, Hq, Hkv, St, St, D, True, 0)[0],
               d64_fwd_lse_ms=cuda_ms(
                   torch, lambda: fa.flash_attention_fwd_stats(q, k, v),
                   blocks=5, per_block=2),
               d64_plain_ms=cuda_ms(torch, lambda: ref.flash_attention_bwd(
                   q, k, v, o, lse, do), blocks=2, per_block=1),
               d64_library_ms=sdpa(q, k, v, do),
               d64_max_abs_err=b_abs, d64_max_err_of_scale=b_worst,
               d64_shape=f"B={B} Hq={Hq} Hkv={Hkv} S={St} D={D}, "
                         f"{cfg.name}'s layer")
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    for label, t, lib, plain in (
            ("flash_attention", fwd, "", f"{fwd['d64_plain_b1_ms']:.4f} ms "
             f"at B=1 (bound {fwd['d64_bound_b1_ms']:.4f} ms)"),
            ("flash_attention_backward", bwd, "'s backward",
             f"{bwd['d64_plain_ms']:.4f} ms; forward with lse "
             f"{bwd['d64_fwd_lse_ms']:.4f} ms")):
        print(f"{label} D=64 at {t['d64_shape']}: kernel {t['d64_ms']:.4f} "
              f"ms, bound {t['d64_bound_ms']:.4f} ms (operations), "
              f"{100 * t['d64_bound_ms'] / t['d64_ms']:.1f} % of the "
              f"bound's rate; scaled_dot_product_attention{lib} "
              f"{t['d64_library_ms']} ms; plain {plain}")
    return fwd, bwd


@contextlib.contextmanager
def held_routing(record=None, replay=None):
    """``moe.route`` patched while open: each call's experts (its idx)
    appended to ``record``, or taken in order from ``replay`` in place of
    the call's own top-K, so that two computations of an MoE model route
    alike. Yields a one-element list: how many tokens' own top-K differed
    from those taken."""
    from repro_torch.models import moe

    orig, flips = moe.route, [0]

    def route(p, cfg, xs, idx=None):
        r = orig(p, cfg, xs, idx)
        if record is not None:
            record.append(r.idx)
        elif replay is not None:
            want = replay.pop(0)
            flips[0] += int((r.idx != want).any(-1).sum())
            r = orig(p, cfg, xs, want)
        return r

    moe.route = route
    try:
        yield flips
    finally:
        moe.route = orig


def free_moe_diffs(torch, tf, model, cfg, toks, batched_last, S):
    """An MoE model at B = 1 over all its layers, each computation routing
    freely: the kernel path's last logits against the einsum attention's
    and against the same prompt's row of the B = LM_BATCH prefill (the same
    kernels; only the batch differs), and the tokens whose experts differ
    between the kernel and einsum paths. Printed, not held."""
    import dataclasses as dc

    one = toks[:1]
    rk, re = [], []
    with held_routing(record=rk):
        lk = tf.prefill(model, cfg, one, S + 1)[0][0, -1].float()
    with held_routing(record=re):
        le = tf.prefill(model, dc.replace(cfg, attn_impl="einsum"), one,
                        S + 1)[0][0, -1].float()
    flips = sum(int((a != b).any(-1).sum()) for a, b in zip(rk, re))
    std = float(lk.std())
    d_e = float((lk - le).abs().max()) / std
    d_b = (None if batched_last is None
           else float((lk - batched_last).abs().max()) / std)
    batched = ("" if d_b is None else f"kernel at B=1 vs its row at "
               f"B={LM_BATCH} {d_b:.4f} std; ")
    print(f"LM B=1 over all {cfg.n_layers} layers, routing freely: last "
          f"logits kernel vs einsum attention max abs diff {d_e:.4f} std; "
          f"{batched}the einsum path's top-{cfg.moe.top_k} differs from the "
          f"kernel path's for {flips} of {len(rk) * S} (token, MoE layer) "
          f"pairs")


def check_moe_layer(np, torch, dev, cfg):
    """One MoE layer of ``cfg`` at full width in f32, the same weights
    (from SEED) and inputs through the card and through the port on the
    CPU: random hidden states, one chunk of MOE_LAYER_BATCH x
    MOE_LAYER_SEQ; the same with three in four tokens one row, so that its
    experts overflow their capacity; MOE_LAYER_BATCH x MOE_RAGGED_SEQ,
    whose last chunk holds zero rows. Per chunk the routing (``moe.route``)
    of both sides: the expert indices and kept slots equal on
    MOE_ROUTE_AGREE of the tokens at least, the zero rows routed to
    experts 0..K-1 (``lax.top_k``'s tie rule), the dropped-slot counts
    equal; the outputs within MOE_OUT_RTOL of each row's largest |value|
    where the routing is equal; aux within MOE_AUX_TOL. Returns the
    forced-drop input's drop count."""
    from repro_torch.models import moe

    fcfg = cfg.ffn_cfg(dense=False)
    m, D = fcfg.moe, cfg.d_model
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 26)
    p = moe.init_moe_ffn(fcfg, gen, dev, torch.float32)
    pc = moe.MoEFFN(*(t.cpu() for t in (p.router, p.w_gate, p.w_in,
                                        p.w_out)))
    B = MOE_LAYER_BATCH
    xa = torch.randn((B, MOE_LAYER_SEQ, D), generator=gen, device=dev)
    xb = xa.clone()
    xb[:, :3 * MOE_LAYER_SEQ // 4] = xa[0, 0]
    xr = torch.randn((B, MOE_RAGGED_SEQ, D), generator=gen, device=dev)
    drops_b = 0
    t0 = time.perf_counter()
    for name, x in (("random", xa), ("forced drops", xb), ("ragged", xr)):
        S = x.shape[1]
        with torch.no_grad():
            got, aux = moe.moe_ffn(p, fcfg, x)
            want, waux = moe.moe_ffn(pc, fcfg, x.cpu())
            same, drops, caps, n_pad, pad_ok = [], [0, 0], [], 0, True
            for xg, xcpu in zip(moe.chunks(x, m), moe.chunks(x.cpu(), m)):
                rg, rc = moe.route(p, fcfg, xg), moe.route(pc, fcfg, xcpu)
                ig, kg = rg.idx.cpu(), rg.keep.cpu()
                sc = xg.shape[0] // B
                same.append(((ig == rc.idx).all(-1)
                             & (kg == rc.keep).all(-1)).view(B, sc))
                drops[0] += int((~kg).sum())
                drops[1] += int((~rc.keep).sum())
                caps.append(rg.C)
                lo = sc * (len(caps) - 1)
                pad = (torch.arange(lo, lo + sc) >= S).expand(B, sc)
                if pad.any():
                    n = int(pad.sum())
                    n_pad += n
                    pad_ok &= torch.equal(ig[pad.reshape(-1)],
                                          torch.arange(m.top_k).expand(n, -1))
        same = torch.cat(same, 1)[:, :S]
        agree = float(same.float().mean())
        got = got.cpu()
        scale = want.abs().amax(-1).clamp(min=1e-30)
        rel = ((got - want).abs().amax(-1) / scale)[same]
        worst = float(rel.max()) if rel.numel() else 0.0
        aux_d = abs(float(aux) - float(waux))
        print(f"MoE layer ({name}, {B} x {S}, chunk {m.chunk}, C {caps}): "
              f"routing equal on {100 * agree:.3f} % of the tokens; dropped "
              f"slots card {drops[0]}, CPU {drops[1]}; outputs within "
              f"{worst:.3g} of each row's scale where the routing is equal "
              f"(tolerance {MOE_OUT_RTOL}); aux {float(aux):.7f} vs CPU "
              f"{float(waux):.7f} (diff {aux_d:.3g}, tolerance {MOE_AUX_TOL})"
              + (f"; {n_pad} zero rows routed to experts 0..K-1" if n_pad
                 else ""))
        if not torch.isfinite(got).all() or got.shape != x.shape:
            fail(f"MoE layer ({name}): output malformed")
        if agree < MOE_ROUTE_AGREE:
            fail(f"MoE layer ({name}): routing equal on only {agree:.5f}")
        if drops[0] != drops[1]:
            fail(f"MoE layer ({name}): the card drops {drops[0]} slots, the "
                 f"CPU {drops[1]}")
        if not pad_ok:
            fail(f"MoE layer ({name}): zero rows not routed to experts "
                 f"0..K-1")
        if worst > MOE_OUT_RTOL or aux_d > MOE_AUX_TOL:
            fail(f"MoE layer ({name}) differs from the CPU's")
        if name == "forced drops":
            drops_b = drops[0]
    if drops_b <= 0:
        fail("the forced-drop batch dropped nothing")
    print(f"MoE layer check: {drops_b} slots dropped in the forced-drop "
          f"batch; took {time.perf_counter() - t0:.1f} s")
    del p, xa, xb, xr
    torch.cuda.empty_cache()
    return drops_b


def train_launcher(np, torch, ops, dev, mod, card_smoke, label):
    """launch/train.py --arch <mod.ARCH> on the card at the smoke widths
    ``card_smoke(mod.smoke_config())`` gives (a kernel head_dim, bf16
    compute), a failure injected before the checkpoint at step 3 and one
    after it; every restore read back bit for bit. Both attention kernels
    must have launched."""
    import tempfile

    from repro_torch.launch import train as train_launch

    orig = mod.smoke_config
    mod.smoke_config = lambda: card_smoke(orig())
    left = set(MOE_LAUNCH_FAILS)

    def hook(s):
        if s in left:
            left.discard(s)
            raise RuntimeError(f"injected failure at step {s}")

    ops.reset_launches()
    try:
        with checked_restores(torch) as checked, \
                tempfile.TemporaryDirectory() as d:
            out = train_launch.main(
                ["--arch", mod.ARCH, "--steps", "6", "--batch", "4",
                 "--seq", "256", "--ckpt-every", "3", "--ckpt-dir", d,
                 "--device", str(dev)], fail_hook=hook)
    finally:
        mod.smoke_config = orig
    launches = ops.launches()
    h = out["history"]
    print(f"launch/train.py --arch {mod.ARCH} on the card ({label}): 6 "
          f"steps, {out['failures']} failures at {MOE_LAUNCH_FAILS}, loss "
          f"{h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}, aux "
          f"{h[-1]['aux_loss']:.4f}"
          + (f", mtp_loss {h[-1]['mtp_loss']:.4f}" if "mtp_loss" in h[-1]
             else "")
          + f"; restores read back bit for bit: {checked}; launches "
          f"{launches}")
    if out["failures"] != 2 or left or int(out["state"]["opt"]["step"]) != 6:
        fail(f"launch/train.py saw {out['failures']} failures and ended at "
             f"step {int(out['state']['opt']['step'])}")
    if sorted(checked) != ["checkpoint 3", "restart", "restart"]:
        fail(f"restores checked: {checked}")
    for name in ("flash_attention", "flash_attention_backward"):
        if not launches[name]:
            fail(f"the launcher did not launch {name}: {launches}")
    return launches


def moe_path(np, torch, ops, dev, prof: bool = False):
    """Phase 12: granite-moe-3b-a800m. Serving (``serve_lm``, whose checks
    are the head_dim 64 kernels' and the MoE layer's), then full-width
    training (``train_lm_full`` at MOE_TRAIN_BATCH), then the launcher.
    Returns the D = 64 entries of the two attention rows and the launches
    of the prefills and the training steps."""
    from repro_torch.configs import granite_moe_3b_a800m as granite

    t0 = time.perf_counter()
    cfg = granite.config()
    checks = {}

    def check():
        checks["fwd"], checks["bwd"] = check_flash_64(np, torch, ops, dev,
                                                      cfg)
        checks["drops"] = check_moe_layer(np, torch, dev, cfg)
        print(f"phase 12's kernel and layer checks took "
              f"{time.perf_counter() - t0:.1f} s")
        return {}

    served, pf_launches = serve_lm(np, torch, ops, dev, cfg, prof, check,
                                   check_layers=MOE_CHECK_LAYERS)
    torch.cuda.empty_cache()
    train_launches, trained = train_lm_full(np, torch, ops, dev, prof, cfg,
                                            MOE_TRAIN_BATCH,
                                            MOE_CHECK_LAYERS)
    torch.cuda.empty_cache()
    launcher = train_launcher(
        np, torch, ops, dev, granite,
        lambda c: dataclasses.replace(c, head_dim=64,
                                      compute_dtype="bfloat16"),
        "head_dim 64, bf16 compute")
    fwd, bwd = checks["fwd"], checks["bwd"]
    fwd.update({f"granite_{k}": v for k, v in served.items()},
               granite_prefill_launches=pf_launches["flash_attention"],
               granite_train_launches=train_launches["flash_attention"],
               granite_forced_drops=checks["drops"])
    bwd.update({f"granite_{k}": v for k, v in trained.items()},
               granite_train_launches=train_launches[
                   "flash_attention_backward"],
               granite_launcher_launches=launcher[
                   "flash_attention_backward"])
    print(f"phase 12 took {time.perf_counter() - t0:.1f} s")
    return fwd, bwd


# Phase 13: deepseek-v3-671b at its published widths, cut in depth
# (configs/deepseek_v3_671b: serve_card_config, 4 layers with all 256
# experts, 30.2 GB in bf16; train_card_config, 2 layers and MTP with 32
# experts, 46.6 GB of state), bf16, random weights from SEED. Serving and
# training as phases 7 and 11 (LM_BATCH x LM_SEQ prefills, LM_DECODE
# decode steps, LM_TRAIN_STEPS steps at MLA_TRAIN_BATCH x LM_TRAIN_SEQ).
# The B = 1 model checks run over MLA_CHECK_SEQ tokens: the einsum
# attention's (1, 128, S, S) f32 logits take 2.1 GB there, 34 GB at 8192;
# all layers, the MoE layer on held experts. The decode step's check runs
# over a whole MoE chunk (4096 tokens; ``serve_lm`` says why).
MLA_TRAIN_BATCH = 4
MLA_CHECK_SEQ = 2048
MLA_EDGE_HEADS = 16        # heads of the D = 192 edge cases
# MLA's work a visible (q, k) pair and head: q.k over nope + rope = 192
# columns and p.v over v's 128, forward; the backward's five products
# (q.k, do.v, p^T.do, ds^T.q, ds.k) over the same widths. The padded
# kernel spends 4 * 192 and 14 * 192 (its dQ pass recomputes q.k, do.v).
MLA_QK, MLA_V = 192, 128
MLA_FWD_FLOPS = 2 * (MLA_QK + MLA_V)
MLA_BWD_FLOPS = 2 * (3 * MLA_QK + 2 * MLA_V)


def mla_attn_bound(B, H, S, backward: bool, flops_per_pair: int):
    """Least time in ms of MLA's causal attention at (B, H, S):
    ``flops_per_pair`` a visible pair and head at the bf16 tensor-core
    peak, against the bytes MLA needs moved (q and k at 192 columns, v, o
    and do at 128, lse; the backward's dq, dk at 192 and dv at 128
    written once)."""
    pairs = B * H * live_pairs(S, S, True, 0)
    rows = B * H * S
    cols = (2 * MLA_QK + 2 * MLA_V if not backward
            else 4 * MLA_QK + 4 * MLA_V)
    nbytes = 2 * rows * cols + (4 * rows if backward else 0)
    t_ops = flops_per_pair * pairs / BF16_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def sdpa_backends(torch, q, k, v, do=None):
    """``F.scaled_dot_product_attention(is_causal=True)`` (its backward by
    ``torch.autograd.grad`` with ``do``) by each backend that takes the
    inputs → {backend: ms}; a backend that refuses them is left out."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out = {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel(be):
                if do is None:
                    ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True), blocks=5, per_block=2)
                else:
                    qs, ks, vs = (t.detach().requires_grad_()
                                  for t in (q, k, v))
                    o = F.scaled_dot_product_attention(qs, ks, vs,
                                                       is_causal=True)
                    ms = cuda_ms(torch, lambda: torch.autograd.grad(
                        o, (qs, ks, vs), do[..., :v.shape[-1]],
                        retain_graph=True), blocks=5, per_block=2)
                    del o, qs, ks, vs
        except RuntimeError as e:   # this backend refuses these inputs
            print(f"scaled_dot_product_attention {be.name} refused "
                  f"q {tuple(q.shape)}, v {tuple(v.shape)}: "
                  f"{str(e).splitlines()[0][:160]}")
            continue
        out[be.name] = ms
        torch.cuda.empty_cache()
    return out


def check_flash_192(np, torch, ops, dev, cfg):
    """flash_attention and flash_attention_backward at head_dim 192 (MLA:
    q.k over 128 + 64 columns, v padded from 128, n_kv = n_heads) against
    their plain twins at phase 7's and phase 11's bars, each twice and
    bit-equal: the serving layer's forward (LM_BATCH x LM_SEQ, 128 heads),
    the training layer's backward (LM_BATCH x LM_TRAIN_SEQ), then at
    MLA_EDGE_HEADS heads a softcap of 50 with logits of std
    ATTN_LOGIT_STD (and its control), a window of 129, Sq < Sk, Sq > Sk,
    S one off the forward's key tile (TILE_N[192]) and the backward's
    tiles, a ragged length, (B, S, H, D) views and one case with v not
    padded. Then timed beside MLA's bounds (MLA_FWD_FLOPS / MLA_BWD_FLOPS
    a pair, and the padded work beside), the plain twins at B = 1 and
    MLA_EDGE_HEADS heads and SDPA by backend, with v padded and at 128.
    Returns (forward entries, backward entries)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 26)
    H, D, he = cfg.n_heads, MLA_QK, MLA_EDGE_HEADS
    S, St = LM_SEQ, LM_TRAIN_SEQ
    bn, bt = fa.TILE_N[D], fa.BWD_TILE[D]
    p = "pad"
    cases = [("serving layer", LM_BATCH, H, H, S, S, True, 0, None, p,
              False),
             ("training layer", LM_BATCH, H, H, St, St, True, 0, None, p,
              True),
             ("softcap 50", 1, he, he, 2048, 2048, True, 0, 50.0, p, True),
             ("window 129", 1, he, he, 1500, 1500, True, 129, None, p, True),
             ("Sq<Sk", 2, he, he, 300, 1000, True, 0, None, p, True),
             ("Sq>Sk", 1, he, he, 700, 300, True, 0, None, p, True),
             ("S = 3 key tiles - 1", 1, he, he, 3 * bn - 1, 3 * bn - 1, True,
              0, None, p, True),
             ("S = 3 key tiles + 1", 1, he, he, 3 * bn + 1, 3 * bn + 1, True,
              bn, None, p, True),
             ("S = the dQ block + 1", 1, he, he, fa.BWD_QROWS + 1,
              fa.BWD_QROWS + 1, True, bt - 1, 50.0, p, True),
             ("ragged", 1, he, he, 3001, 3001, True, 0, None, p, True),
             ("(B, S, H, D)", 2, he, he, 500, 500, True, 64, None,
              "pad bshd", True),
             ("v not padded", 1, he, he, 777, 777, True, 0, None, "", True)]
    f_err, b_abs, b_worst = check_flash_cases(np, torch, ops, dev, gen, D,
                                              cases, pad_v=MLA_V)

    def fastest(t):
        return min(t, key=t.get) if t else None

    B = LM_BATCH
    q, k, v = attn_inputs(torch, gen, dev, B, H, H, S, S, D)
    v[..., MLA_V:] = 0
    lib, lib128 = (sdpa_backends(torch, q, k, v),
                   sdpa_backends(torch, q, k, v[..., :MLA_V].contiguous()))
    fwd = dict(d192_ms=cuda_ms(torch, lambda: ops.flash_attention(q, k, v),
                               blocks=5, per_block=2),
               d192_bound_ms=mla_attn_bound(B, H, S, False,
                                            MLA_FWD_FLOPS)[0],
               d192_padded_bound_ms=mla_attn_bound(B, H, S, False,
                                                   4 * D)[0],
               d192_library_ms=lib.get(fastest(lib)),
               d192_library_backend=fastest(lib),
               d192_library_all_ms=lib,
               d192_library_v128_ms=lib128,
               d192_plain_b1_ms=cuda_ms(torch, lambda: ops.flash_attention(
                   q[:1, :he], k[:1, :he], v[:1, :he], impl="ref"), blocks=2,
                   per_block=1),
               d192_bound_b1_ms=mla_attn_bound(1, he, S, False,
                                               MLA_FWD_FLOPS)[0],
               d192_max_abs_err=f_err,
               d192_shape=f"B={B} Hq=Hkv={H} S={S} D={D} (v padded from "
                          f"{MLA_V}), {cfg.name}'s serving layer; plain_b1 "
                          f"at B=1 and {he} heads")
    del q, k, v
    torch.cuda.empty_cache()
    q, k, v = attn_inputs(torch, gen, dev, B, H, H, St, St, D)
    v[..., MLA_V:] = 0
    do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    do[..., MLA_V:] = 0
    o, lse = fa.flash_attention_fwd_stats(q, k, v)
    lib = sdpa_backends(torch, q, k, v, do)
    lib128 = sdpa_backends(torch, q, k, v[..., :MLA_V].contiguous(), do)
    bwd = dict(d192_ms=cuda_ms(torch, lambda: fa.flash_attention_backward(
                   q, k, v, o, lse, do), blocks=5, per_block=2),
               d192_bound_ms=mla_attn_bound(B, H, St, True,
                                            MLA_BWD_FLOPS)[0],
               d192_padded_bound_ms=mla_attn_bound(B, H, St, True,
                                                   10 * D)[0],
               d192_fwd_lse_ms=cuda_ms(
                   torch, lambda: fa.flash_attention_fwd_stats(q, k, v),
                   blocks=5, per_block=2),
               d192_fwd_bound_ms=mla_attn_bound(B, H, St, False,
                                                MLA_FWD_FLOPS)[0],
               d192_plain_b1_ms=cuda_ms(
                   torch, lambda: ref.flash_attention_bwd(
                       q[:1, :he], k[:1, :he], v[:1, :he], o[:1, :he],
                       lse[:1, :he].contiguous(), do[:1, :he]),
                   blocks=2, per_block=1),
               d192_library_ms=lib.get(fastest(lib)),
               d192_library_backend=fastest(lib),
               d192_library_all_ms=lib,
               d192_library_v128_ms=lib128,
               d192_max_abs_err=b_abs, d192_max_err_of_scale=b_worst,
               d192_shape=f"B={B} Hq=Hkv={H} S={St} D={D} (v padded from "
                          f"{MLA_V}), {cfg.name}'s training layer; "
                          f"plain_b1 at B=1 and {he} heads")
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    for label, t in (("flash_attention", fwd),
                     ("flash_attention_backward", bwd)):
        print(f"{label} D=192 at {t['d192_shape']}: kernel "
              f"{t['d192_ms']:.4f} ms; MLA's bound {t['d192_bound_ms']:.4f} "
              f"ms (operations), {100 * t['d192_bound_ms'] / t['d192_ms']:.1f}"
              f" % of its rate; the padded work's bound "
              f"{t['d192_padded_bound_ms']:.4f} ms "
              f"({100 * t['d192_padded_bound_ms'] / t['d192_ms']:.1f} %); "
              f"scaled_dot_product_attention by backend, v padded "
              f"{t['d192_library_all_ms']} ms, v at {MLA_V} "
              f"{t['d192_library_v128_ms']} ms; plain at B=1, {he} heads "
              f"{t['d192_plain_b1_ms']:.4f} ms")
    print(f"flash_attention with lse at the training layer "
          f"{bwd['d192_fwd_lse_ms']:.4f} ms (MLA's bound "
          f"{bwd['d192_fwd_bound_ms']:.4f} ms)")
    return fwd, bwd


def mla_path(np, torch, ops, dev, prof: bool = False):
    """Phase 13: deepseek-v3-671b. The D = 192 kernels checked and timed
    (``check_flash_192``), the serving cut served (``serve_lm``; the B = 1
    checks over MLA_CHECK_SEQ tokens and all 4 layers), the training cut
    trained (``train_lm_full`` at MLA_TRAIN_BATCH, its gradient check over
    both layers and MTP), then the launcher at smoke widths with q.k at
    128 + 64 in bf16. Returns the D = 192 entries of the two attention
    rows with the launches of the prefills and the steps."""
    from repro_torch.configs import deepseek_v3_671b as deepseek

    t0 = time.perf_counter()
    cfg = deepseek.serve_card_config()
    checks = {}

    def check():
        checks["fwd"], checks["bwd"] = check_flash_192(np, torch, ops, dev,
                                                       cfg)
        print(f"phase 13's kernel checks and timings took "
              f"{time.perf_counter() - t0:.1f} s")
        return {}

    served, pf_launches = serve_lm(np, torch, ops, dev, cfg, prof, check,
                                   check_seq=MLA_CHECK_SEQ)
    torch.cuda.empty_cache()
    train_launches, trained = train_lm_full(
        np, torch, ops, dev, prof, deepseek.train_card_config(),
        MLA_TRAIN_BATCH)
    torch.cuda.empty_cache()
    m = deepseek.smoke_config().mla
    launcher = train_launcher(
        np, torch, ops, dev, deepseek,
        lambda c: dataclasses.replace(
            c, compute_dtype="bfloat16",
            mla=dataclasses.replace(m, qk_nope_head_dim=128,
                                    qk_rope_head_dim=64)),
        "q.k 128 + 64, bf16 compute")
    fwd, bwd = checks["fwd"], checks["bwd"]
    fwd.update({f"deepseek_{k}": v for k, v in served.items()},
               deepseek_prefill_launches=pf_launches["flash_attention"],
               deepseek_train_launches=train_launches["flash_attention"])
    bwd.update({f"deepseek_{k}": v for k, v in trained.items()},
               deepseek_train_launches=train_launches[
                   "flash_attention_backward"],
               deepseek_launcher_launches=launcher[
                   "flash_attention_backward"])
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s")
    return fwd, bwd


# Phase 14: the equivariant GNNs (egnn, nequip, mace) at their published
# widths: inference over the ogb_products graph with positions (phase 8's
# graph, drawn with geometric=True), each layer held at GNN_ORACLE_NODES
# nodes against a float64 oracle fed the layer's own input, one forward
# on rotated positions held to the equivariance bar; training at the
# molecule shape (128 molecules x 30 atoms, 8,192 edges), the card's
# gradients against the CPU's. They reach no TPU kernel and launch none.
E3GNN_ARCHS = ("egnn", "nequip", "mace")
E3GNN_TRAIN_SHAPE = "molecule"
E3GNN_TRAIN_STEPS = 4
# Equivariance: the reference's bar (tests/test_models_gnn.py), the
# largest error over a block's largest |value|.
E3GNN_EQUI_TOL = 1e-4
# Each CG tensor's sign (its first entry of |value| > 1e-9 in C order) over
# e3.paths(2), as numpy 2.0.2's LAPACK gives them on an x86 host: a LAPACK
# that returns the other null vector of a path shows against this.
E3_CG_SIGNS = "+-+-+--++++-+--"


def graph_to(torch, g, dev):
    """The graph with every tensor field on ``dev``."""
    return dataclasses.replace(g, **{
        f.name: getattr(g, f.name).to(dev) for f in dataclasses.fields(g)
        if getattr(g, f.name) is not None})


def e3_blocks(arch: str, out) -> dict:
    """Named blocks of an ``apply`` result: EGNN's h and x; each l of
    NequIP's and MACE's features, and MACE's node energies."""
    if arch == "egnn":
        return {"h": out[0], "x": out[1]}
    feats, energy = (out, None) if arch == "nequip" else out
    blocks = {f"l={l}": feats[l] for l in sorted(feats)}
    if energy is not None:
        blocks["node_energy"] = energy
    return blocks


def print_cg_signs(np) -> None:
    """One line a CG path of e3.paths(2): its sign and Frobenius norm, so
    that a LAPACK that flips a path's sign on this host shows."""
    from repro_torch.models.gnn import e3

    signs = ""
    for p, want in zip(e3.paths(2), E3_CG_SIGNS):
        c = e3.cg(*p).ravel()
        k = int(np.flatnonzero(np.abs(c) > 1e-9)[0])
        sign = "+" if c[k] > 0 else "-"
        signs += sign
        print(f"CG {p}: entry {k} = {c[k]:+.6f}, sign {sign} "
              f"({'as' if sign == want else 'FLIPPED against'} the x86 "
              f"host's {want}), Frobenius norm {np.linalg.norm(c):.12f}")
    print(f"CG signs over e3.paths(2): {signs} "
          f"({'equal to' if signs == E3_CG_SIGNS else 'differ from'} the "
          f"x86 host's {E3_CG_SIGNS})")


def in_edges(np, torch, g, nodes):
    """The valid in-edges of ``nodes`` (sorted, unique): their ids on the
    card, each edge's position in ``nodes`` and its source ids (host)."""
    pick = torch.zeros(g.node_mask.shape[0], dtype=torch.bool,
                       device=nodes.device)
    pick[nodes] = True
    e = torch.nonzero((g.edge_src >= 0) & pick[g.edge_dst.long()]).squeeze(1)
    pos = np.searchsorted(nodes.cpu().numpy(),
                          g.edge_dst[e].cpu().numpy().astype(np.int64))
    return e, pos, g.edge_src[e].long()


def f64(t):
    return t.detach().double().cpu().numpy()


def np_seg_sum(np, x, pos, n: int):
    """Σ of the rows of ``x`` by segment ``pos`` → (n, ...) (reduceat over
    the rows sorted by segment; empty segments 0)."""
    order = np.argsort(pos, kind="stable")
    counts = np.bincount(pos, minlength=n)
    live = counts > 0
    out = np.zeros((n,) + x.shape[1:])
    out[live] = np.add.reduceat(x[order], (np.cumsum(counts) - counts)[live],
                                axis=0)
    return out


def np_mix(np, x, w):
    """(n, C, d) mixed over channels by (C, C') → (n, C', d)."""
    return (x.transpose(0, 2, 1) @ w).transpose(0, 2, 1)


def np_silu(np, z):
    with np.errstate(over="ignore"):
        return z / (1.0 + np.exp(-z))


def np_edge_basis(np, g, e, cfg):
    """float64 radial basis and harmonics of edges ``e`` (numpy, from the
    card's positions): the reference's formulas."""
    from repro_torch.models.gnn import e3

    src = g.edge_src[e].long()
    dst = g.edge_dst[e].long()
    diff = f64(g.positions[dst]) - f64(g.positions[src])
    r = np.sqrt((diff * diff).sum(-1) + 1e-12)
    rhat = diff / r[:, None]
    centers = np.linspace(0.0, cfg.cutoff, cfg.n_rbf)
    width = cfg.cutoff / cfg.n_rbf
    rbf = np.exp(-((r[:, None] - centers[None, :]) ** 2) / (2 * width**2))
    rbf *= 0.5 * (np.cos(np.pi * np.clip(r / cfg.cutoff, 0, 1)) + 1.0)[
        :, None]
    ok = (r > 1e-6)[:, None]
    return rbf, [e3.sh(l, rhat) * ok for l in range(cfg.l_max + 1)]


def egnn_oracle(np, torch, g, h, x, lp, nodes):
    """One EGNN layer's (h, x) at ``nodes`` in float64 from the card's
    float32 layer input."""
    e, pos, src = in_edges(np, torch, g, nodes)
    hv, xv = f64(h[nodes]), f64(x[nodes])
    hs, xs = f64(h[src]), f64(x[src])

    def mlp(p, z, act_last=False):
        for i in range(len(p)):
            z = z @ f64(p[f"w{i}"])
            if i < len(p) - 1 or act_last:
                z = np_silu(np, z)
        return z

    diff = xv[pos] - xs
    d2 = (diff * diff).sum(-1, keepdims=True)
    m = mlp(lp["edge_mlp"], np.concatenate([hv[pos], hs, d2], -1), True)
    w = np.tanh(mlp(lp["coord_mlp"], m))
    agg = np_seg_sum(np, m, pos, len(hv))
    dx = np_seg_sum(np, diff / (np.sqrt(d2) + 1.0) * w, pos, len(hv))
    deg = np.bincount(pos, minlength=len(hv))[:, None]
    return {"h": hv + mlp(lp["node_mlp"], np.concatenate([hv, agg], -1)),
            "x": xv + dx / np.maximum(deg, 1.0)}


def nequip_oracle(np, torch, cfg, g, feats, lp, nodes):
    """One NequIP interaction block's irreps at ``nodes`` in float64 from
    the card's float32 block input."""
    from repro_torch.models.gnn import e3

    e, pos, src = in_edges(np, torch, g, nodes)
    C, L = cfg.d_hidden, cfg.l_max
    rbf, sh_e = np_edge_basis(np, g, e, cfg)
    paths_ = e3.paths(L)
    rw = (np_silu(np, rbf @ f64(lp["rad_w0"])) @ f64(lp["rad_w1"])).reshape(
        len(rbf), len(paths_), C)
    fs = {l: f64(feats[l][src]) for l in feats}
    fv = {l: f64(feats[l][nodes]) for l in feats}
    msgs = {l: 0.0 for l in fv}
    for pi, (li, lf, lo) in enumerate(paths_):
        c = e3.cg(li, lf, lo)                   # (i, f, o)
        t = np.einsum("ef,ifo->eio", sh_e[lf], c, optimize=True)
        msgs[lo] = msgs[lo] + (fs[li] @ t) * rw[:, pi, :, None]
    out = {l: fv[l] + np_mix(np, np_seg_sum(np, msgs[l], pos, len(nodes))
                             / cfg.avg_neighbors ** 0.5,
                             f64(lp[f"self_{l}"])) for l in fv}
    scal = out[0][:, :, 0]
    gates = 1.0 / (1.0 + np.exp(-(scal @ f64(lp["gate_w"]))))
    gates = gates.reshape(len(scal), L, C)
    new = {"l=0": np_silu(np, scal)[:, :, None]}
    for l in range(1, L + 1):
        new[f"l={l}"] = out[l] * gates[:, l - 1][:, :, None]
    return new


def mace_oracle(np, torch, cfg, g, feats, lp, nodes):
    """One MACE layer's irreps at ``nodes`` in float64 from the card's
    float32 layer input (the node energies are their l = 0 scalars)."""
    from repro_torch.models.gnn import e3

    e, pos, src = in_edges(np, torch, g, nodes)
    C, L = cfg.d_hidden, cfg.l_max
    rbf, sh_e = np_edge_basis(np, g, e, cfg)
    rw = (np_silu(np, rbf @ f64(lp["rad_w0"])) @ f64(lp["rad_w1"])).reshape(
        len(rbf), L + 1, C)
    hj = f64(feats[0][src][:, :, 0])
    fv = {l: f64(feats[l][nodes]) for l in feats}
    A = {l: np_seg_sum(np, (rw[:, l] * hj)[:, :, None] * sh_e[l][:, None, :],
                       pos, len(nodes)) / cfg.avg_neighbors ** 0.5
         for l in range(L + 1)}

    def cg_product(u, v, c):                    # Σ_ij u_i v_j C[i, j, o]
        n_, ch = u.shape[:2]
        return ((u[:, :, :, None] * v[:, :, None, :]).reshape(n_ * ch, -1)
                @ c.reshape(-1, c.shape[2])).reshape(n_, ch, -1)

    b2_w, b3_w = f64(lp["b2_w"]), f64(lp["b3_w"])
    B2 = {l: 0.0 for l in range(L + 1)}
    for pi, p in enumerate(e3.paths(L)):
        B2[p[2]] = B2[p[2]] + cg_product(A[p[0]], A[p[1]], e3.cg(*p)) \
            * b2_w[pi][None, :, None]
    B = {l: A[l] + B2[l] for l in range(L + 1)}
    if cfg.correlation >= 3:
        for pi, p in enumerate(e3.paths(L)):
            B[p[2]] = B[p[2]] + cg_product(B2[p[0]], A[p[1]], e3.cg(*p)) \
                * b3_w[pi][None, :, None]
    return {f"l={l}": np_mix(np, B[l], f64(lp[f"msg_{l}"]))
            + np_mix(np, fv[l], f64(lp[f"res_{l}"])) for l in range(L + 1)}


def e3gnn_layer_checks(np, torch, arch, model, cfg, params, g, nodes, out):
    """Each layer driven on its own (the model's layer function) and held
    at ``nodes`` against the float64 oracle fed that layer's input; the
    last layer's output against ``apply``'s."""
    n = g.node_mask.shape[0]
    worst = []
    with torch.no_grad():
        if arch == "egnn":
            h, x, deg = model._embed(params, g)
            state = (h, x)
        else:
            state = model._embed(params, cfg, g)
        energy = None
        for i in range(cfg.n_layers):
            lp = params[f"layer_{i}"]
            if arch == "egnn":
                nxt = model._layer(lp, g, *state, deg, n)
                want = egnn_oracle(np, torch, g, *state, lp, nodes)
                got = {"h": nxt[0], "x": nxt[1]}
            elif arch == "nequip":
                nxt = model._interact(lp, cfg, g, state, n)
                want = nequip_oracle(np, torch, cfg, g, state, lp, nodes)
                got = e3_blocks(arch, nxt)
            else:
                nxt = model._layer(lp, cfg, g, state, n)
                want = mace_oracle(np, torch, cfg, g, state, lp, nodes)
                got = e3_blocks(arch, (nxt, None))
                scal = nxt[0][:, :, 0]
                energy = scal if energy is None else energy + scal
            errs = []
            for k, w in want.items():
                a = f64(got[k][nodes])
                atol = AGG_ATOL * float(np.abs(w).max())
                err = float(np.abs(a - w).max())
                if not np.allclose(a, w, rtol=AGG_RTOL, atol=atol):
                    fail(f"{arch} layer {i} block {k} differs from the "
                         f"float64 oracle at {len(nodes)} nodes: max abs "
                         f"err {err:.4g}, block's largest "
                         f"{float(np.abs(w).max()):.4g}")
                errs.append(f"{k} {err:.3g} of {float(np.abs(w).max()):.3g}")
            print(f"{arch} layer {i}: within rtol {AGG_RTOL} atol {AGG_ATOL}"
                  f" x the block's largest of the float64 oracle at "
                  f"{len(nodes)} nodes (max abs err: {', '.join(errs)})")
            worst.append(errs)
            state = nxt
        final = ({"h": state[0], "x": state[1]} if arch == "egnn" else
                 e3_blocks(arch, state if arch == "nequip"
                           else (state, energy)))
        for k, a in final.items():
            b = out[k]
            if not torch.allclose(a, b, rtol=AGG_RTOL,
                                  atol=AGG_ATOL * float(b.abs().max())):
                fail(f"{arch}: the layer-by-layer {k} differs from apply's "
                     f"by {float((a - b).abs().max()):.4g}")
    return worst


def e3gnn_equivariance(np, torch, arch, model, cfg, params, g, out):
    """One forward on positions rotated by a random R: EGNN's h invariant
    and x rotated, each irrep block l rotated by D_l(R) (MACE's node
    energies invariant), within E3GNN_EQUI_TOL of the block's largest."""
    from repro_torch.models.gnn import e3

    R = e3._rand_rotations(np.random.default_rng(SEED + 3), 1)[0]
    rt = torch.from_numpy(R.astype(np.float32)).to(g.positions.device)
    rot = e3_blocks(arch, model.apply(params, cfg, dataclasses.replace(
        g, positions=g.positions @ rt.T)))
    rels = []
    for k, b in rot.items():
        a = out[k]
        if k == "x":
            a = a @ rt.T
        elif k.startswith("l=") and k != "l=0":
            d = torch.from_numpy(e3.wigner(R, int(k[2:])).astype(
                np.float32)).to(a.device)
            a = torch.einsum("ncj,ij->nci", a, d)
        rel = float((a - b).abs().max() / (a.abs().max() + 1e-9))
        del a
        rels.append(f"{k} {rel:.3g}")
        if not rel < E3GNN_EQUI_TOL:
            fail(f"{arch} is not equivariant on the rotated graph: block "
                 f"{k} off by {rel:.4g} of its largest")
    del rot
    print(f"{arch} on positions rotated by R: every block within "
          f"{E3GNN_EQUI_TOL} of its largest of the rotated output "
          f"({', '.join(rels)})")


def e3gnn_infer(np, torch, ops, dev, arch, g, prof: bool) -> dict:
    """One model at config() widths over ``g`` (ogb_products with
    positions): a warm-up and GNN_FORWARDS timed forwards through
    ``apply`` with the counters read around them (0 launches), the
    equivariance check and the per-layer oracle."""
    from repro_torch.configs import get_arch, gnn_common

    mod = get_arch(arch)
    model = mod.model
    cfg = gnn_common.shape_config(mod.config(), GNN_SHAPE)
    n = g.node_mask.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = model.init(cfg, gen, dev)
    chunks = f"edge chunk {model.EDGE_CHUNK}" + (
        f", node chunk {model.NODE_CHUNK}" if arch == "mace" else "")
    print(f"{arch}: {cfg}; {chunks}")
    out = model.apply(params, cfg, g)          # warm-up, off the clock
    torch.cuda.synchronize()
    del out
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    fwd = []
    for _ in range(GNN_FORWARDS):
        out = None
        t = time.perf_counter()
        out = model.apply(params, cfg, g)
        torch.cuda.synchronize()
        fwd.append(time.perf_counter() - t)
    launches = ops.launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    fwd_ms = np.array(fwd) * 1e3
    print(f"{arch} forward over {n} nodes: "
          f"{[round(x, 3) for x in fwd_ms.tolist()]} ms | median "
          f"{np.median(fwd_ms):.3f} ms | {n / np.median(fwd):.1f} nodes/s | "
          f"peak allocated {peak_gb:.3f} GB")
    print(f"{arch} forward launches ({GNN_FORWARDS} forwards): {launches}")
    if any(launches.values()):
        fail(f"{arch}.apply launched a kernel: {launches}")
    out = e3_blocks(arch, out)
    for k, t in out.items():
        if t.shape[0] != n or not torch.isfinite(t).all():
            fail(f"{arch} output {k} malformed: {tuple(t.shape)}")
    t = time.perf_counter()
    e3gnn_equivariance(np, torch, arch, model, cfg, params, g, out)
    torch.cuda.empty_cache()
    t_equi, t = time.perf_counter() - t, time.perf_counter()
    nodes = torch.from_numpy(np.sort(np.random.default_rng(SEED).choice(
        n, GNN_ORACLE_NODES, replace=False))).to(dev)
    e3gnn_layer_checks(np, torch, arch, model, cfg, params, g, nodes, out)
    print(f"{arch} checks: the rotated forward {t_equi:.1f} s, the layer "
          f"by layer drive and its oracle {time.perf_counter() - t:.1f} s")
    del out
    torch.cuda.empty_cache()
    if prof:
        profile_window(torch, f"one {arch} forward over {n} nodes",
                       lambda: model.apply(params, cfg, g))
    return {"forward_ms": fwd_ms.tolist(), "peak_gb": peak_gb,
            "launches": launches}


def e3gnn_train(np, torch, ops, dev, arch) -> None:
    """One model at config() widths on the molecule shape: the card's
    gradients against the CPU's at the same weights (GAT_GRAD_RTOL and
    GAT_GRAD_ATOL_OF_SCALE, every leaf finite), E3GNN_TRAIN_STEPS
    TRAIN_CFG steps timed (median of the last 3), and ``smoke()`` on the
    card."""
    from repro_torch.configs import get_arch, gnn_common
    from repro_torch.data import graph_synth
    from repro_torch.train import loop, tree

    mod = get_arch(arch)
    model = mod.model
    cfg = gnn_common.shape_config(mod.config(), E3GNN_TRAIN_SHAPE)
    sh = gnn_common.GNN_SHAPES[E3GNN_TRAIN_SHAPE]
    b = sh["n_graphs"]
    gk = dict(batch=b, n_nodes=sh["n_nodes"] // b,
              n_edges=sh["n_edges"] // b, d_feat=sh["d_feat"], seed=SEED)
    g_cpu = graph_synth.molecule_batch(device="cpu", **gk)
    g_dev = graph_synth.molecule_batch(device=dev, **gk)
    loops = int(((g_cpu.edge_src == g_cpu.edge_dst)
                 & (g_cpu.edge_src >= 0)).sum())
    p_cpu = model.init(cfg, torch.Generator().manual_seed(SEED),
                       device="cpu")
    p_dev = tree.tree_map(lambda t: t.to(dev), p_cpu)
    tc = gnn_common.TRAIN_CFG
    s_cpu = loop.make_train_state(p_cpu, tc)
    s_dev = loop.make_train_state(p_dev, tc)

    def loss(p, gg):
        return model.loss_fn(p, cfg, gg)

    want, _ = loop.compute_grads(loss, s_cpu["params"], g_cpu)
    got, _ = loop.compute_grads(loss, s_dev["params"], g_dev)
    worst = 0.0
    for (name, a), w in zip(tree.flatten(got), tree.leaves(want)):
        a = a.cpu()
        if not (torch.isfinite(a).all() and torch.isfinite(w).all()):
            fail(f"{arch} gradient {name} is not finite")
        atol = GAT_GRAD_ATOL_OF_SCALE * float(w.abs().max())
        worst = max(worst, float(((a - w).abs() / (atol + GAT_GRAD_RTOL
                                                   * w.abs())).max()))
        if not torch.allclose(a, w, rtol=GAT_GRAD_RTOL, atol=atol):
            fail(f"{arch} gradient {name} on the card differs from the "
                 f"CPU's: max abs err {float((a - w).abs().max()):.4g}")
    del got, want
    step = loop.make_train_step(loss, tc)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    times, losses = [], []
    for _ in range(E3GNN_TRAIN_STEPS):
        t = time.perf_counter()
        s_dev, m = step(s_dev, g_dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
    launches = ops.launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if any(launches.values()) or not np.isfinite(losses).all():
        fail(f"{arch} train steps: launches {launches}, losses {losses}")
    smoke = mod.smoke(device=dev)
    if not np.isfinite(float(smoke["loss"])):
        fail(f"{arch} smoke() on the card: loss {smoke}")
    print(f"{arch} at {E3GNN_TRAIN_SHAPE} ({sh['n_graphs']} molecules, "
          f"{sh['n_nodes']} nodes, {sh['n_edges']} edges, {loops} "
          f"self-loops, {sh['d_feat']} features): gradients on the card "
          f"finite and within rtol {GAT_GRAD_RTOL} atol "
          f"{GAT_GRAD_ATOL_OF_SCALE} x the leaf's largest of the CPU's "
          f"(worst at {worst:.3f} of the tolerance); {E3GNN_TRAIN_STEPS} "
          f"steps {[round(t, 3) for t in times]} ms, median of the last 3 "
          f"{float(np.median(times[1:])):.3f} ms, loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}, peak allocated {peak_gb:.3f} GB, launches "
          f"{launches}; smoke() on the card: loss "
          f"{float(smoke['loss']):.6f}")


def e3gnn_path(np, torch, ops, dev, g=None, prof: bool = False) -> dict:
    """Phase 14: the CG signs; egnn, nequip and mace at config() widths
    over the ogb_products graph with positions (``g``, phase 8's graph on
    the host, or drawn here) and trained at the molecule shape."""
    from repro_torch.configs import gnn_common
    from repro_torch.data import graph_synth

    t0 = time.perf_counter()
    print_cg_signs(np)
    sh = gnn_common.GNN_SHAPES[GNN_SHAPE]
    if g is None:
        g = graph_synth.random_graph(sh["n_nodes"], sh["n_edges"],
                                     sh["d_feat"], n_classes=sh["n_classes"],
                                     seed=SEED, geometric=True, device=dev)
        how = "made on the host and moved to the card"
    else:
        g = graph_to(torch, g, dev)
        how = "phase 8's, moved back to the card"
    torch.cuda.synchronize()
    print(f"GNN graph {GNN_SHAPE} with positions: {sh['n_nodes']} nodes, "
          f"{sh['n_edges']} edges, {how} in "
          f"{time.perf_counter() - t0:.2f} s")
    rows = {}
    for arch in E3GNN_ARCHS:
        t = time.perf_counter()
        rows[arch] = e3gnn_infer(np, torch, ops, dev, arch, g, prof)
        torch.cuda.empty_cache()
        print(f"{arch} over {GNN_SHAPE} took {time.perf_counter() - t:.1f} s")
    del g
    torch.cuda.empty_cache()
    for arch in E3GNN_ARCHS:
        e3gnn_train(np, torch, ops, dev, arch)
        torch.cuda.empty_cache()
    print(f"phase 14 took {time.perf_counter() - t0:.1f} s")
    return rows


DRYRUN_JOBS = 6               # cells dry-run at once (one process each)
# In a whole run phase 15 (a) starts after phase 3 and runs beside phases
# 4-14 (the dry run uses only the host's cores), with fewer processes at
# once, so that phase 15 need not wait for it. Its processes run at the
# lowest priority (``nice`` DRYRUN_NICE): the host-bound card phases
# beside them (phase 4's KG trips, phase 9's four gloo ranks) keep the
# cores they need, and the dry run takes what is left. Three at once took
# 976.7 s for the 42 cells on a slow host, past the card's phases.
DRYRUN_JOBS_BESIDE = 5
DRYRUN_NICE = 19
# The cells of phase 15 (a), slowest first: each must come out as listed
# ("skipped" with its config's SKIP_SHAPES reason). The GNN cells take
# 5-66 s a process on a CPU (nequip's ogb_products the longest).
DRYRUN_MOE = ("granite-moe-3b-a800m", "deepseek-v3-671b")
DRYRUN_CELLS = ([("deepseek-v3-671b", "train_4k"),
                 ("granite-moe-3b-a800m", "train_4k"),
                 ("deepseek-v3-671b", "prefill_32k"),
                 ("nequip", "ogb_products"), ("mace", "ogb_products")]
                + [(a, s) for a in ("gemma2-2b", "starcoder2-3b", "gemma3-27b")
                   for s in ("train_4k", "prefill_32k", "decode_32k",
                             "long_500k")]
                + [("granite-moe-3b-a800m", "prefill_32k"),
                   ("deepseek-v3-671b", "decode_32k"),
                   ("granite-moe-3b-a800m", "decode_32k")]
                + [(a, s) for a in ("nequip", "mace")
                   for s in ("minibatch_lg", "full_graph_sm", "molecule")]
                + [(a, s) for a in ("egnn", "gat-cora")
                   for s in ("ogb_products", "minibatch_lg", "full_graph_sm",
                             "molecule")]
                + [("two-tower-retrieval", s) for s in
                   ("train_batch", "serve_bulk", "serve_p99",
                    "retrieval_cand")]
                + [("kg-specqp", s) for s in ("serve_batch", "serve_trinit")]
                + [(a, "long_500k") for a in DRYRUN_MOE])
DRYRUN_CELL_S = 900           # a cell's process is killed after this
# Phase 15 (b)'s bar: predicted peak within [1/2, 2] x the measured one.
DRYRUN_PEAK_BAND = (0.5, 2.0)


class DryrunCells(threading.Thread):
    """Phase 15 (a), in a thread of its own, so that the card's phases (b)
    and (c) run beside it: each cell through ``python -m
    repro_torch.launch.dryrun`` on the 16 x 16 mesh of a fake process
    group, DRYRUN_JOBS processes at a time (they use the host's cores, not
    the card). A cell of its config's SKIP_SHAPES must come out "skipped"
    with that reason, every other "ok". ``stop`` kills the processes
    still running; ``results`` and ``failed`` are read after ``join``."""

    def __init__(self, cells, out_dir: pathlib.Path,
                 jobs: int = DRYRUN_JOBS):
        super().__init__(daemon=True)
        self.todo, self.out_dir, self.jobs = list(cells), out_dir, jobs
        self.running, self.results, self.failed = [], [], []
        self.error = None
        self.t0 = time.perf_counter()
        self._lock = threading.Lock()    # starting against stopping
        self._stopped = False

    def start(self):
        import atexit
        atexit.register(self.stop)     # also when an earlier phase fails
        super().start()

    def run(self):
        try:
            self._run()
        except Exception as e:  # noqa: BLE001 - reported by the caller
            self.error = e

    def _run(self):
        import os

        env = dict(os.environ, PYTHONPATH=str(SRC))
        self.out_dir.mkdir(parents=True, exist_ok=True)
        while True:
            with self._lock:
                if self._stopped or not (self.todo or self.running):
                    return
                while self.todo and len(self.running) < self.jobs:
                    cell = self.todo.pop(0)
                    log = self.out_dir / f"{cell[0]}__{cell[1]}.log"
                    with open(log, "w") as f:
                        self.running.append((cell, log, time.perf_counter(),
                                             subprocess.Popen(
                            ["nice", "-n", str(DRYRUN_NICE),
                             sys.executable, "-m",
                             "repro_torch.launch.dryrun", "--arch", cell[0],
                             "--shape", cell[1], "--out", str(self.out_dir)],
                            cwd=ROOT, env=env, stdout=f,
                            stderr=subprocess.STDOUT)))
                for _, _, t0, proc in self.running:
                    if time.perf_counter() - t0 > DRYRUN_CELL_S:
                        proc.kill()
                done = [r for r in self.running if r[3].poll() is not None]
                for item in done:
                    self.running.remove(item)
            for item in done:
                self._collect(*item)
            if not done:
                time.sleep(0.5)

    def _collect(self, cell, log, t0, proc):
        from repro_torch.configs import get_arch

        path = self.out_dir / f"{cell[0]}__{cell[1]}__16x16.json"
        r = json.loads(path.read_text()) if path.exists() else {}
        reason = getattr(get_arch(cell[0]), "SKIP_SHAPES", {}).get(cell[1])
        want = "skipped" if reason else "ok"
        if proc.returncode != 0 or r.get("status") != want or (
                reason and r.get("reason") != reason):
            print(f"phase 15 (a) {cell}: {r.get('status')}, not {want} "
                  f"(rc {proc.returncode} after "
                  f"{time.perf_counter() - t0:.0f} s): {r.get('error')}\n"
                  f"{r.get('traceback', log.read_text())[-3000:]}",
                  file=sys.stderr)
            self.failed.append(cell)
        else:
            self.results.append(r)

    def stop(self):
        with self._lock:
            self._stopped = True
            self.todo = []
            for *_, proc in self.running:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def dryrun_cuts():
    """Phase 15 (b)'s cuts: (name, arch module, config, shape name, batch,
    seq), each a call phases 7 and 11-13 run."""
    from repro_torch.configs import deepseek_v3_671b as deepseek
    from repro_torch.configs import gemma2_2b, granite_moe_3b_a800m as granite

    return [("gemma2-2b prefill", gemma2_2b, gemma2_2b.config(),
             "prefill_32k", LM_BATCH, LM_SEQ),
            ("gemma2-2b train", gemma2_2b, gemma2_2b.config(), "train_4k",
             LM_TRAIN_BATCH, LM_TRAIN_SEQ),
            ("granite prefill", granite, granite.config(), "prefill_32k",
             LM_BATCH, LM_SEQ),
            ("granite train", granite, granite.config(), "train_4k",
             MOE_TRAIN_BATCH, LM_TRAIN_SEQ),
            ("deepseek serve-cut prefill", deepseek,
             deepseek.serve_card_config(), "prefill_32k", LM_BATCH, LM_SEQ),
            ("deepseek train-cut train", deepseek,
             deepseek.train_card_config(), "train_4k", MLA_TRAIN_BATCH,
             LM_TRAIN_SEQ)]


def dryrun_measured(np, torch, ops, dev, cuts) -> dict:
    """Phase 15 (b)'s measurements: each cut's call (a prefill, or one
    ``TRAIN_CFG`` step) timed after a warm-up, with the peak allocated
    bytes of the second call; one model on the card at a time. Returns
    {name: (seconds, peak bytes)}."""
    from repro_torch.configs import lm_common
    from repro_torch.launch import train as train_launch
    from repro_torch.models import transformer as tf
    from repro_torch.train import loop

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t,
                torch.cuda.max_memory_allocated(dev))

    out = {}
    for name, _, cfg, shape, B, S in cuts:
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        model = tf.init(cfg, gen, dev)
        if shape == "prefill_32k":
            toks = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                 device=dev, dtype=torch.int32)
            with torch.no_grad():
                out[name] = timed(lambda: tf.prefill(model, cfg, toks, S))
            del toks
        else:
            state = loop.make_train_state(tf.param_tree(model),
                                          lm_common.TRAIN_CFG)
            step = loop.make_train_step(
                lambda p, b, cfg=cfg: tf.loss_fn(p, cfg, b["tokens"],
                                                 b["labels"]),
                lm_common.TRAIN_CFG)
            batch = train_launch.synth_lm_batch(cfg, B, S, 0, dev)
            out[name] = timed(lambda: step(state, batch))
            del state, batch
        del model
        torch.cuda.empty_cache()
    return out


# Phase 15 (b) and (c)'s GNN step: each GNN's minibatch_lg cell, at its
# published widths and the shape's full size (not cut), one TRAIN_CFG step
# over ``graph_synth.random_graph`` of the shape (positions for the
# geometric models). (c) holds the sharded step's loss to the unsharded
# one's at GNN_LOSS_RTOL and each gradient leaf within GNN_GRAD_TOL of that
# leaf's largest |value|: ``index_add_`` on the card sums by atomics, so
# neither run is bit-equal to another.
GNN_ARCHS = ("gat-cora", "egnn", "nequip", "mace")
GNN_STEP_SHAPE = "minibatch_lg"
GNN_LOSS_RTOL = 1e-5
GNN_GRAD_TOL = 1e-5


def gnn_step_graphs(torch) -> dict:
    """{geometric: the GNN_STEP_SHAPE graph}, drawn on the host from SEED
    and kept there: each arch moves its own to the card (``graph_to``), so
    that a measured peak holds one graph."""
    from repro_torch.configs import gnn_common
    from repro_torch.data import graph_synth

    sh = gnn_common.GNN_SHAPES[GNN_STEP_SHAPE]
    return {geo: graph_synth.random_graph(
        sh["n_nodes"], sh["n_edges"], sh["d_feat"],
        n_classes=sh["n_classes"], seed=SEED, geometric=geo, device="cpu")
        for geo in (False, True)}


def gnn_step_model(torch, dev, arch: str):
    """(config module, config at the shape, parameters from SEED on
    ``dev``, loss function) of ``arch``'s GNN_STEP_SHAPE cell."""
    from repro_torch.configs import get_arch, gnn_common

    mod = get_arch(arch)
    cfg = gnn_common.shape_config(mod.config(), GNN_STEP_SHAPE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = mod.model.init(cfg, gen, dev)
    return mod, cfg, params, (lambda p, g: mod.model.loss_fn(p, cfg, g))


def dryrun_gnn_card(np, torch, dev, graphs) -> None:
    """Phase 15 (b) for the GNNs: each arch's GNN_STEP_SHAPE cell dry-run
    on a (1, 1) mesh of a fake process group of one rank beside one
    measured ``TRAIN_CFG`` step (after a warm-up) on the card, each
    predicted peak held to DRYRUN_PEAK_BAND."""
    from repro_torch.configs import gnn_common
    from repro_torch.launch import dryrun, mesh as mesh_lib
    from repro_torch.train import loop

    t0 = time.perf_counter()
    predicted = {}
    with dryrun.fake_world(1):
        mesh = mesh_lib.make_device_mesh((1, 1))
        for arch in GNN_ARCHS:
            predicted[arch] = dryrun.run_cell(
                arch, GNN_STEP_SHAPE, mesh,
                str(ROOT / "results" / "dryrun_torch_card_cuts"))
            if predicted[arch]["status"] != "ok":
                fail(f"dry run of the {arch} {GNN_STEP_SHAPE} cell failed: "
                     f"{predicted[arch].get('traceback')}")
    print(f"phase 15 (b): the (1, 1) GNN dry runs took "
          f"{time.perf_counter() - t0:.1f} s")
    lo, hi = DRYRUN_PEAK_BAND
    for arch in GNN_ARCHS:
        mod, cfg, params, loss_fn = gnn_step_model(torch, dev, arch)
        g = graph_to(torch, graphs[mod.GEOMETRIC], dev)
        state = loop.make_train_state(params, gnn_common.TRAIN_CFG)
        step = loop.make_train_step(loss_fn, gnn_common.TRAIN_CFG)
        step(state, g)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        step(state, g)
        torch.cuda.synchronize()
        secs, peak = (time.perf_counter() - t,
                      torch.cuda.max_memory_allocated(dev))
        del state, params, g
        torch.cuda.empty_cache()
        p = predicted[arch]
        want = p["memory"]["peak_bytes"]
        ratio = want / peak
        print(f"phase 15 (b) {arch} {GNN_STEP_SHAPE} train: predicted peak "
              f"{want / 1e9:.3f} GB, measured {peak / 1e9:.3f} GB (ratio "
              f"{ratio:.3f}); roofline bound "
              f"{p['roofline']['compute_s']:.4f} / "
              f"{p['roofline']['memory_s']:.4f} s (compute / memory: "
              f"{p['roofline']['dominant']}), measured {secs:.4f} s")
        if not lo <= ratio <= hi:
            fail(f"phase 15 (b): the {arch} {GNN_STEP_SHAPE} cell's "
                 f"predicted peak is {ratio:.3f} x the measured one, outside "
                 f"{lo}-{hi}")


def gnn_sharded_steps(np, torch, dev, mesh, graphs) -> None:
    """Phase 15 (c) for the GNNs, on the caller's (1, 1) mesh: each arch's
    GNN_STEP_SHAPE loss and gradients with its parameters and graph laid
    on the mesh by ``sharding.distribute`` (the DTensor path of
    ``graph.Partition``) against the unsharded ones; then a train state
    after one unsharded step, saved with its axes and restored onto the
    mesh, every leaf a DTensor placed as ``distribute`` places it and
    bit-equal to the saved leaf."""
    import tempfile

    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import sharding
    from repro_torch.configs import gnn_common
    from repro_torch.models.gnn import graph as G
    from repro_torch.train import checkpoint, loop, tree

    sh = gnn_common.GNN_SHAPES[GNN_STEP_SHAPE]
    for arch in GNN_ARCHS:
        t0 = time.perf_counter()
        mod, cfg, params, loss_fn = gnn_step_model(torch, dev, arch)
        g = graph_to(torch, graphs[mod.GEOMETRIC], dev)
        for p in tree.leaves(params):
            p.requires_grad_(True)
        want_loss, _, want = loop.value_and_grad(loss_fn, params, g)
        p_axes = mod.model.param_axes(cfg)
        with sharding.use_rules(mesh):
            dparams = sharding.distribute(params, p_axes, mesh)
            for p in tree.leaves(dparams):
                p.requires_grad_(True)
            dg = G.Graph(**sharding.distribute(
                G.as_dict(g), gnn_common.graph_axes(sh, mod.GEOMETRIC),
                mesh))
            with implicit_replication():
                loss, _, grads = loop.value_and_grad(loss_fn, dparams, dg)
        torch.cuda.synchronize()
        if not all(isinstance(t, DTensor) for t in tree.leaves(grads)):
            fail(f"phase 15 (c) {arch}: a sharded gradient is not a DTensor")
        loss_gap = abs(float(loss.full_tensor()) - float(want_loss)) / abs(
            float(want_loss))
        worst = 0.0
        for (name, w), gt in zip(tree.flatten(want), tree.leaves(grads),
                                 strict=True):
            scale = float(w.abs().max())
            gap = float((gt.full_tensor() - w).abs().max())
            worst = max(worst, gap / scale if scale else gap)
            if gap > GNN_GRAD_TOL * scale:
                fail(f"phase 15 (c) {arch}: gradient {name} lies {gap:.3e} "
                     f"from the unsharded, over {GNN_GRAD_TOL} x its "
                     f"largest {scale:.3e}")
        if not np.isfinite(loss_gap) or loss_gap > GNN_LOSS_RTOL:
            fail(f"phase 15 (c) {arch}: the sharded loss lies {loss_gap:.3e} "
                 f"(relative) from the unsharded")
        del grads, want, dparams, dg
        # The sharded restore of a train state saved after one step.
        state = loop.make_train_state(params, gnn_common.TRAIN_CFG)
        loop.make_train_step(loss_fn, gnn_common.TRAIN_CFG)(state, g)
        axes = {"params": p_axes, "opt": {"m": p_axes, "v": p_axes,
                                          "step": ()}}
        with tempfile.TemporaryDirectory(prefix="ckpt-") as d:
            checkpoint.save(d, 1, state, axes)
            with sharding.use_rules(mesh):
                got = checkpoint.restore(d, 1, state)
        placed = sharding.distribute(state, axes, mesh)
        n_leaves = 0
        for (name, saved), r, w in zip(tree.flatten(state), tree.leaves(got),
                                       tree.leaves(placed), strict=True):
            if not (isinstance(r, DTensor)
                    and tuple(r.placements) == tuple(w.placements)
                    and torch.equal(r.full_tensor(), saved.detach())
                    and r.requires_grad == saved.requires_grad):
                fail(f"phase 15 (c) {arch}: the restored leaf {name} is not "
                     "the saved one placed as distribute places it")
            n_leaves += 1
        del state, got, placed, params, g
        torch.cuda.empty_cache()
        print(f"phase 15 (c): the {arch} {GNN_STEP_SHAPE} loss and "
              f"gradients on a (1, 1) NCCL mesh through graph.Partition: "
              f"loss {float(want_loss):.6f}, {loss_gap:.3e} (relative) from "
              f"the unsharded; worst gradient leaf {worst:.3e} of its "
              f"largest |value| (bar {GNN_GRAD_TOL}); a train state of "
              f"{n_leaves} leaves restored onto the mesh bit-equal; "
              f"{time.perf_counter() - t0:.1f} s")


def dryrun_predicted(cuts) -> dict:
    """Phase 15 (b)'s predictions: the dry run of the same cuts on a (1, 1)
    mesh of a fake process group of one rank (each arch's ``config``
    replaced by the cut's while it runs)."""
    from repro_torch.configs import lm_common
    from repro_torch.launch import dryrun, mesh as mesh_lib

    shapes = dict(lm_common.LM_SHAPES)
    out = {}
    with dryrun.fake_world(1):
        mesh = mesh_lib.make_device_mesh((1, 1))
        for name, mod, cfg, shape, B, S in cuts:
            config = mod.config
            try:
                lm_common.LM_SHAPES[shape] = dict(shapes[shape], batch=B,
                                                  seq=S)
                mod.config = lambda cfg=cfg: cfg
                out[name] = dryrun.run_cell(
                    mod.ARCH, shape, mesh,
                    str(ROOT / "results" / "dryrun_torch_card_cuts"))
            finally:
                mod.config = config
                lm_common.LM_SHAPES.update(shapes)
            if out[name]["status"] != "ok":
                fail(f"dry run of the {name} cut failed: "
                     f"{out[name].get('traceback')}")
    return out


def dryrun_sharded_prefill(np, torch, ops, dev, graphs=None,
                           cells=None) -> dict:
    """Phase 15 (c): a 1-rank NCCL process group and (1, 1) mesh; gemma2-2b
    and granite-moe-3b-a800m at their published widths and deepseek's
    serving cut, each laid onto it by ``sharding.distribute`` and a prefill
    of LM_BATCH x LM_SEQ through the constrain calls, the attention's
    custom op and the MoE's sharded dispatch (``moe._Layout``); logits and
    caches bit-equal to the unsharded model's, its ``flash_attention``
    launches one a layer. Then, with ``graphs``, the GNNs' sharded steps
    and restores (``gnn_sharded_steps``); with ``cells`` (phase 4's
    workload, the (b) predictions, phase 9's NCCL runs or None), the
    kg-specqp and two-tower cells (``sharded_kg_cells``,
    ``sharded_two_tower``). Returns {arch: launches}."""
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import sharding
    from repro_torch.configs import deepseek_v3_671b as deepseek
    from repro_torch.configs import gemma2_2b, granite_moe_3b_a800m as granite
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as tf

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    out = {}
    try:
        mesh = mesh_lib.make_device_mesh((1, 1), device_type=dev.type)
        for arch, cfg in ((gemma2_2b.ARCH, gemma2_2b.config()),
                          (granite.ARCH, granite.config()),
                          (deepseek.ARCH, deepseek.serve_card_config())):
            t0 = time.perf_counter()
            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED)
            model = tf.init(cfg, gen, dev)
            toks = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ),
                                 generator=gen, device=dev,
                                 dtype=torch.int32)
            with torch.no_grad():
                want_logits, want_caches = tf.prefill(model, cfg, toks,
                                                      LM_SEQ)
            with sharding.use_rules(mesh):
                sharding.distribute(model, tf.param_axes(model), mesh)
                dtoks = sharding.distribute(toks, ("batch", "seq"), mesh)
                ops.reset_launches()
                with torch.no_grad(), implicit_replication():
                    logits, caches = tf.prefill(model, cfg, dtoks, LM_SEQ)
                torch.cuda.synchronize()
                launches = ops.launches()["flash_attention"]
            if not isinstance(logits, DTensor):
                fail(f"{arch}: the sharded prefill's logits are not a "
                     "DTensor")
            if not torch.equal(logits.to_local(), want_logits):
                fail(f"{arch}: the sharded prefill's logits differ from the "
                     "unsharded")
            for i, (got, want) in enumerate(zip(caches, want_caches,
                                                strict=True)):
                for key in want:
                    g = got[key]
                    g = g.to_local() if isinstance(g, DTensor) else g
                    if not torch.equal(g, want[key]):
                        fail(f"{arch}: the sharded prefill's layer {i} "
                             f"cache {key} differs from the unsharded")
            del model, caches, want_caches, logits, want_logits
            torch.cuda.empty_cache()
            if launches != cfg.n_layers:
                fail(f"{arch}: the sharded prefill launched "
                     f"flash_attention {launches} times, not "
                     f"{cfg.n_layers}")
            out[arch] = launches
            print(f"phase 15 (c): the {arch} prefill of {LM_BATCH} x "
                  f"{LM_SEQ} ({cfg.n_layers} layers) on a (1, 1) NCCL mesh "
                  "through the constrain calls, the custom op and the "
                  "sharded MoE: logits and every layer's caches bit-equal "
                  f"to the unsharded prefill's, {launches} flash_attention "
                  f"launches; {time.perf_counter() - t0:.1f} s")
        if graphs is not None:
            gnn_sharded_steps(np, torch, dev, mesh, graphs)
        if cells is not None:
            wl, predicted, phase9 = cells
            out["kg-specqp"] = sharded_kg_cells(np, torch, ops, dev, mesh,
                                                wl, predicted, phase9)
            out["two-tower-retrieval"] = sharded_two_tower(
                np, torch, ops, dev, mesh, predicted)
    finally:
        dist.destroy_process_group()
    return out


# Phase 15 (b) and (c) for kg-specqp's and the two-tower model's cells. The
# kg cells run phase 4's store and queries (their dry run is given that
# geometry), the two-tower cells the full-width serving model, phase 5's
# corpus and phase 10's training cut. A measured peak there is the
# arguments' bytes plus what the call allocated beyond what was live before
# it, so that what else is on the card does not count.
KG_CELLS = {"specqp": "serve_batch", "trinit": "serve_trinit"}


@contextlib.contextmanager
def patched(obj, **values):
    """``obj``'s attributes set to ``values`` while open."""
    old = {k: getattr(obj, k) for k in values}
    for k, v in values.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(obj, k, v)


def train_cut(tt):
    """Phase 10's training cut of the two-tower config and cells."""
    cut = dataclasses.replace(tt.config(), user_vocab=TRAIN_VOCAB,
                              item_vocab=TRAIN_VOCAB)
    return cut, dict(config=lambda: cut,
                     CELL_BATCH=dict(tt.CELL_BATCH, train_batch=TRAIN_BATCH))


def new_cells_predicted(np, wl) -> dict:
    """Phase 15 (b)'s predictions for kg-specqp's serve_batch at phase 4's
    store and queries, and the two-tower serve_p99 and retrieval_cand cells
    and train_batch at phase 10's cut: the dry run on a (1, 1) mesh of a
    fake process group of one rank."""
    from repro_torch.configs import kg_specqp
    from repro_torch.configs import two_tower_retrieval as tt
    from repro_torch.core import sketches
    from repro_torch.launch import dryrun, mesh as mesh_lib

    (Q, T), (P, L) = np.asarray(wl.queries).shape, wl.store.keys.shape
    if sketches.adaptive_words(L) != wl.store.sketch.shape[-1]:
        fail(f"phase 4's store has {wl.store.sketch.shape[-1]} sketch words "
             f"a lane, its dry run {sketches.adaptive_words(L)}")
    geometry = dict(N_PATTERNS=P, L_SHARD=L, N_RELAX=wl.relax.ids.shape[1],
                    N_QUERIES=Q, T_MAX=T)
    cells = [("kg-specqp serve_batch", kg_specqp, "serve_batch", geometry),
             ("two-tower serve_p99", tt, "serve_p99", {}),
             ("two-tower retrieval_cand", tt, "retrieval_cand", {}),
             ("two-tower train_batch cut", tt, "train_batch",
              train_cut(tt)[1])]
    t0, out = time.perf_counter(), {}
    with dryrun.fake_world(1):
        mesh = mesh_lib.make_device_mesh((1, 1))
        for name, mod, shape, values in cells:
            with patched(mod, **values):
                out[name] = dryrun.run_cell(
                    mod.ARCH, shape, mesh,
                    str(ROOT / "results" / "dryrun_torch_card_cuts"))
            if out[name]["status"] != "ok":
                fail(f"dry run of the {name} cell failed: "
                     f"{out[name].get('traceback')}")
    print(f"phase 15 (b): the (1, 1) kg-specqp and two-tower dry runs took "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def unit_mesh_args(args, axes, mesh) -> list:
    """A cell's arguments laid on a (1, 1) mesh by their axes
    (``on_unit_mesh`` of each)."""
    return [on_unit_mesh(a, ax, mesh) for a, ax in zip(args, axes)]


def on_unit_mesh(tree, axes, mesh):
    """``tree`` laid on a (1, 1) mesh by ``axes``: each leaf a DTensor of
    its placements whose one shard is the leaf itself, no copy
    (``sharding.distribute`` copies: 41 GB of tables)."""
    from torch.distributed.tensor import DTensor
    from repro_torch import sharding

    with sharding.use_rules(mesh):
        return sharding.tree_map_axes(
            lambda ax, t: DTensor.from_local(
                t.detach(), mesh, sharding.sharding(*ax, shape=tuple(t.shape)),
                run_check=False), axes, tree)


def arg_bytes(args) -> int:
    """Bytes of the storages under ``args`` (each counted once)."""
    from torch.distributed.tensor import DTensor

    seen, leaves = {}, []

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "untyped_storage"):
            leaves.append(x.to_local() if isinstance(x, DTensor) else x)

    walk(args)
    for t in leaves:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def measured_call(torch, dev, fn, *args):
    """(fn(*args), seconds, peak bytes), the card synchronised around the
    call; the peak is the arguments' bytes plus what the call allocated
    beyond what was live before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t,
            torch.cuda.max_memory_allocated(dev) - base + arg_bytes(args))


def peak_line(name: str, predicted: dict, secs: float, peak: int) -> None:
    """Phase 15 (b)'s line of one cell: predicted peak against measured,
    held to DRYRUN_PEAK_BAND, beside the roofline bound and the time."""
    lo, hi = DRYRUN_PEAK_BAND
    want = predicted["memory"]["peak_bytes"]
    ratio = want / peak
    rl = predicted["roofline"]
    print(f"phase 15 (b) {name}: predicted peak {want / 1e9:.3f} GB "
          f"(arguments {predicted['memory']['argument_bytes'] / 1e9:.3f}), "
          f"measured {peak / 1e9:.3f} GB (ratio {ratio:.3f}); roofline bound "
          f"{rl['compute_s']:.4f} / {rl['memory_s']:.4f} s (compute / memory: "
          f"{rl['dominant']}), measured {secs:.4f} s")
    if not lo <= ratio <= hi:
        fail(f"phase 15 (b): the {name} cell's predicted peak is {ratio:.3f} "
             f"x the measured one, outside {lo}-{hi}")


def sharded_kg_cells(np, torch, ops, dev, mesh, wl, predicted,
                     phase9=None) -> dict:
    """Phase 15 (c) for kg-specqp, on the caller's 1-rank NCCL (1, 1) mesh:
    each cell's function (``make_cell``'s, no trip bound) on phase 4's
    store and queries laid on the mesh, its keys, scores, masks and the four
    counters bit-equal to phase 9's NCCL serve step (``phase9``; without
    it the same serve step run here over the mesh's group), n_wasted 0, and
    its launches equal to that step's; the trips of each mode printed, and
    serve_batch's peak held against its (1, 1) dry run. Returns each
    mode's launches."""
    from repro_torch import sharding
    from repro_torch.configs import kg_specqp
    from repro_torch.launch.mesh import Mesh

    kernels = ("rank_join_lookup", "merge_topk")
    queries = torch.as_tensor(np.asarray(wl.queries), dtype=torch.int32,
                              device=dev)
    if phase9 is None:
        phase9 = {}
        for mode in KG_CELLS:
            step = kg_specqp.serve_step(Mesh.from_device_mesh(mesh, dev), mode)
            ops.reset_launches()
            res = step(wl.store, wl.relax, wl.store.stats, queries)
            torch.cuda.synchronize()
            phase9[mode] = dict(merged=on_host(res), launches=ops.launches())
    data = ({f: getattr(wl.store, f)[None] for f in STORE_FIELDS},
            {"ids": wl.relax.ids, "weights": wl.relax.weights},
            wl.store.stats, queries)
    out = {}
    for mode, shape in KG_CELLS.items():
        with sharding.use_rules(mesh):
            cell = kg_specqp.make_cell(shape)
        args = unit_mesh_args(data, cell.arg_axes, mesh)
        ops.reset_launches()
        res, secs, peak = measured_call(torch, dev, cell.fn, *args)
        got = {k: ops.launches()[k] for k in kernels}
        res = {f: res[f].cpu().numpy() for f in STEP_FIELDS}
        want = phase9[mode]
        if not all(np.array_equal(res[f], want["merged"][f])
                   for f in STEP_FIELDS) or res["n_wasted"].any():
            fail(f"phase 15 (c): the kg-specqp {shape} cell's function "
                 "differs from phase 9's NCCL serve step")
        if got != {k: want["launches"][k] for k in kernels}:
            fail(f"phase 15 (c): the kg-specqp {shape} cell launched {got}, "
                 f"phase 9's serve step {want['launches']}")
        trips = int(res["n_iters"].max())
        out[mode] = got
        print(f"phase 15 (c): kg-specqp {shape} ({mode}) through its cell "
              f"function on a (1, 1) NCCL mesh: keys, scores, masks and the "
              f"four counters bit-equal to phase 9's NCCL serve step "
              f"(n_wasted 0); {trips} trips in {secs:.3f} s "
              f"({secs / trips * 1e3:.3f} ms a trip: the dry run counts one); "
              f"launches {got}, equal to the serve step's")
        if shape == "serve_batch":
            peak_line("kg-specqp serve_batch", predicted[
                "kg-specqp serve_batch"], secs, peak)
    return out


def released(torch, dev, label: str) -> None:
    """Collect what the last part dropped, return the cache, and print what
    is still allocated (a part that leaves its tensors behind shows)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 15 (c): {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB "
          f"allocated {label}")


def sharded_two_tower(np, torch, ops, dev, mesh, predicted) -> dict:
    """Phase 15 (c) for the two-tower cells, on the caller's 1-rank NCCL
    (1, 1) mesh, each with its launches equal to the unsharded path's and
    its peak held against its (1, 1) dry run: at phase 10's cut the loss
    and gradients through the vocab-parallel bag within the sharding bar
    (GNN_LOSS_RTOL, GNN_GRAD_TOL) of the unsharded, then the train_batch
    cell's step; serve_p99's function (the full-width model, a random
    corpus) and retrieval_cand's (phase 5's corpus) bit-equal to the
    unsharded ``serve`` and ``retrieve``. The largest first: a part's
    tensors are gone before the next starts. Returns the cells'
    launches."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import sharding
    from repro_torch.configs import two_tower_retrieval as tt

    def cell_of(shape, **values):
        with sharding.use_rules(mesh), patched(tt, **values):
            return tt.make_cell(shape)

    def counted(fn, *args):
        ops.reset_launches()
        with implicit_replication():
            out = measured_call(torch, dev, fn, *args)
        return out, ops.launches()

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    released(torch, dev, "before the two-tower cells")
    out = {"train_batch": two_tower_train(torch, dev, mesh, predicted,
                                          cell_of, counted)}
    released(torch, dev, "after the train_batch cell")
    out["serve_p99"] = two_tower_serve(torch, dev, mesh, predicted, cell_of,
                                       counted, gen)
    released(torch, dev, "after the serve_p99 cell")
    out["retrieval_cand"] = two_tower_retrieve(np, torch, dev, mesh,
                                               predicted, cell_of, counted,
                                               gen)
    released(torch, dev, "after the retrieval_cand cell")
    return out


def two_tower_train(torch, dev, mesh, predicted, cell_of, counted):
    """``sharded_two_tower``'s train_batch part at phase 10's cut."""
    from functools import partial

    from repro_torch.configs import two_tower_retrieval as tt
    from repro_torch.examples import train_retrieval
    from repro_torch.models import recsys
    from repro_torch.train import loop, tree

    cut, values = train_cut(tt)
    bags = ("embedding_bag", "embedding_bag_backward")
    model = recsys.init(cut, seed=SEED, device=dev)
    params = recsys.param_tree(model)
    batch = train_retrieval.make_batch(cut, TRAIN_BATCH, 0, dev)
    loss_fn = partial(tt._loss, cfg=cut)
    (want, _, _), want_l = counted(loop.value_and_grad, loss_fn, params,
                                   batch)
    # The unsharded gradients wait on the host (two 10 M x 256 tables'):
    # the card holds the parameters and one set of gradients at a time.
    want_loss = float(want[0])
    want = [(name, w.cpu()) for name, w in tree.flatten(want[2])]
    torch.cuda.empty_cache()
    cell = cell_of("train_batch", **values)
    dparams = on_unit_mesh(params, recsys.param_axes(cut), mesh)
    for p in tree.leaves(dparams):
        p.requires_grad_(True)
    dbatch = on_unit_mesh(batch, cell.arg_axes[1], mesh)
    (got, _, _), got_l = counted(loop.value_and_grad, loss_fn, dparams,
                                 dbatch)
    loss_gap = abs(float(got[0].to_local()) - want_loss) / abs(want_loss)
    worst = 0.0
    for (name, w), g in zip(want, tree.leaves(got[2]), strict=True):
        w = w.to(dev)                  # then turned into |w - g| in place
        lo, hi = torch.aminmax(w)
        scale = max(-float(lo), float(hi))
        gap = float(w.sub_(g.to_local()).abs_().max())
        worst = max(worst, gap / scale if scale else gap)
        if gap > GNN_GRAD_TOL * scale:
            fail(f"phase 15 (c): the two-tower gradient {name} lies "
                 f"{gap:.3e} from the unsharded, over {GNN_GRAD_TOL} x its "
                 f"largest {scale:.3e}")
    if not loss_gap <= GNN_LOSS_RTOL:
        fail(f"phase 15 (c): the two-tower sharded loss lies {loss_gap:.3e} "
             "(relative) from the unsharded")
    if got_l != want_l:
        fail(f"phase 15 (c): the sharded two-tower gradients launched "
             f"{got_l}, the unsharded {want_l}")
    print(f"phase 15 (c): the two-tower loss and gradients at phase 10's cut "
          f"on a (1, 1) NCCL mesh (vocab-parallel bag, its backward on the "
          f"local rows): loss {want_loss:.6f}, {loss_gap:.3e} "
          f"(relative) from the unsharded; worst gradient leaf {worst:.3e} "
          f"of its largest |value| (bar {GNN_GRAD_TOL}); launches "
          f"{ {k: got_l[k] for k in bags} }, as unsharded")
    del got, want, dparams, w, g
    torch.cuda.empty_cache()
    state = on_unit_mesh(loop.make_train_state(params, tt.TRAIN_CFG),
                         cell.arg_axes[0], mesh)
    for p in tree.leaves(state["params"]):
        p.requires_grad_(True)
    counted(cell.fn, state, dbatch)                  # warm-up
    ((_, metrics), secs, peak), got_l = counted(cell.fn, state, dbatch)
    launches = {k: got_l[k] for k in bags}
    loss = metrics["loss"]
    print(f"phase 15 (c): the train_batch cell's step at the cut: loss "
          f"{float(getattr(loss, 'to_local', lambda: loss)()):.6f}, launches "
          f"{launches}")
    peak_line("two-tower train_batch cut",
              predicted["two-tower train_batch cut"], secs, peak)
    return launches


def two_tower_serve(torch, dev, mesh, predicted, cell_of, counted, gen):
    """``sharded_two_tower``'s serve_p99 part: the full-width model."""
    from repro_torch.configs import two_tower_retrieval as tt
    from repro_torch.examples import train_retrieval
    from repro_torch.models import recsys

    cfg = tt.config()
    model = recsys.init(cfg, seed=SEED, device=dev)
    corpus = torch.randn((tt.CORPUS, cfg.embed_dim), generator=gen,
                         device=dev)
    batch = train_retrieval.make_batch(cfg, tt.CELL_BATCH["serve_p99"], 0,
                                       dev)
    (want, _, _), want_l = counted(tt.serve, model, batch, corpus)
    cell = cell_of("serve_p99")
    args = unit_mesh_args((recsys.param_tree(model), batch, corpus),
                          cell.arg_axes, mesh)
    ((s, i), secs, peak), got_l = counted(cell.fn, *args)
    if not (torch.equal(s.to_local(), want[0])
            and torch.equal(i.to_local(), want[1])):
        fail("phase 15 (c): the two-tower serve_p99 cell differs from the "
             "unsharded serve")
    if got_l != want_l:
        fail(f"phase 15 (c): serve_p99 launched {got_l}, serve {want_l}")
    print(f"phase 15 (c): the two-tower serve_p99 cell on a (1, 1) NCCL mesh "
          f"(vocab-parallel bag, the corpus's blocks laid out as the "
          f"reference's): top-{tt.TOPK} of {s.shape[0]} users bit-equal to "
          f"the unsharded serve; {got_l['embedding_bag']} embedding_bag "
          "launch, as unsharded")
    peak_line("two-tower serve_p99", predicted["two-tower serve_p99"], secs,
              peak)
    return got_l["embedding_bag"]


def two_tower_retrieve(np, torch, dev, mesh, predicted, cell_of, counted,
                       gen):
    """``sharded_two_tower``'s retrieval_cand part: phase 5's corpus."""
    from repro_torch.configs import two_tower_retrieval as tt

    cfg = tt.config()
    cand = clustered_corpus(np, torch, dev, gen, cfg)
    q = torch.randn((cfg.embed_dim,), generator=gen, device=dev)
    (want, _, _), want_l = counted(tt.retrieve, q, cand, tt.TOPK, tt.TILE)
    cell = cell_of("retrieval_cand")
    args = unit_mesh_args((q, cand), cell.arg_axes, mesh)
    (got, secs, peak), got_l = counted(cell.fn, *args)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail("phase 15 (c): the retrieval_cand cell differs from the "
             "unsharded retrieve")
    if got_l != want_l:
        fail(f"phase 15 (c): retrieval_cand launched {got_l}, retrieve "
             f"{want_l}")
    print(f"phase 15 (c): the retrieval_cand cell on a (1, 1) NCCL mesh: "
          f"scores, ids and tiles scored ({int(got[2])}) bit-equal to the "
          f"unsharded retrieve; {got_l['topk_score_pruned']} "
          "topk_score_pruned launch, as unsharded")
    peak_line("two-tower retrieval_cand",
              predicted["two-tower retrieval_cand"], secs, peak)
    return got_l["topk_score_pruned"]


def dryrun_path(np, torch, ops, dev, cells=None, kg=None) -> dict:
    """Phase 15: the dry run (``launch/dryrun.py``). (a) Every cell on the
    16 x 16 production mesh of H100s (the dense LMs', granite's and
    deepseek's, their long_500k skipped; gat-cora's, EGNN's, NequIP's and
    MACE's; kg-specqp's and the two-tower model's), fake CUDA tensors on
    this card's host, each cell's status, argument and peak GB a card,
    flops, collective bytes and roofline terms printed; (b) the dry run of
    phases 7's, 11's, 12's and 13's cuts, of each GNN's minibatch_lg step,
    of kg-specqp's serve_batch at phase 4's store and of the two-tower
    serve_p99, retrieval_cand and (at phase 10's cut) train_batch cells on
    a (1, 1) mesh beside their measured peaks and times, each peak held to
    DRYRUN_PEAK_BAND; (c) the sharded prefills, the GNNs' sharded steps and
    the sharded restore, the kg-specqp cells and the two-tower cells on a
    1-rank NCCL mesh. ``cells``: (a) already started (a whole run starts it
    after phase 3). ``kg``: (phase 4's workload, phase 9's NCCL runs), or
    None to build the workload here and run the serve step alone. Returns
    {"launches": gemma2-2b's in (c), "cells": the kg-specqp and two-tower
    cells' launches in (c)}."""
    t0 = time.perf_counter()
    if cells is None:
        cells = DryrunCells(DRYRUN_CELLS, ROOT / "results" / "dryrun_torch")
        cells.start()
    try:
        launches = dryrun_card(np, torch, ops, dev, kg)
        cells.join()
    finally:
        cells.stop()
    if cells.error is not None:
        fail(f"phase 15 (a) raised {cells.error!r}")
    if cells.failed:
        fail(f"the dry run failed for {cells.failed}")
    for r in cells.results:
        if r["status"] == "skipped":
            print(f"phase 15 (a) {r['arch']} {r['shape']} 16x16: skipped "
                  f"({r['reason']})")
            continue
        rl, mem = r["roofline"], r["memory"]
        print(f"phase 15 (a) {r['arch']} {r['shape']} 16x16: {r['status']}, "
              f"{r['device']}, args {mem['argument_bytes'] / 1e9:.3f} GB, "
              f"peak {mem['peak_bytes'] / 1e9:.3f} GB a card, "
              f"{rl['flops']:.4e} flops, {rl['coll_bytes'] / 1e9:.3f} GB "
              f"collective, compute {rl['compute_s']:.4e} s, memory "
              f"{rl['memory_s']:.4e} s, collective {rl['collective_s']:.4e} "
              f"s: {rl['dominant']}; counts {r['collective_counts']}; "
              f"{r['run_s']} s")
    print(f"phase 15 (a): {len(cells.results)} cells in "
          f"{time.perf_counter() - cells.t0:.1f} s, {cells.jobs} at a time, "
          "beside the card's work")
    print(f"phase 15 took {time.perf_counter() - t0:.1f} s")
    return {"launches": launches["gemma2-2b"],
            "cells": {a: launches[a] for a in ("kg-specqp",
                                               "two-tower-retrieval")}}


def kg_workload(torch, dev):
    """Phase 4's kg-specqp workload, built on the card."""
    from repro_torch.configs import kg_specqp
    from repro_torch.data import kg_synth

    t0 = time.perf_counter()
    wl = kg_synth.make_workload("xkg", list_len=kg_specqp.L_SHARD,
                                n_queries=N_QUERIES,
                                n_relax=kg_specqp.N_RELAX, seed=SEED,
                                device=dev)
    torch.cuda.synchronize()
    print(f"phase 15: phase 4's workload built in "
          f"{time.perf_counter() - t0:.1f} s")
    return wl


def dryrun_card(np, torch, ops, dev, kg=None) -> dict:
    """Phase 15 (b) and (c), the parts that use the card (``kg`` as
    ``dryrun_path`` takes it). Returns (c)'s launches by arch."""
    wl, phase9 = kg if kg is not None else (kg_workload(torch, dev), None)
    t1 = time.perf_counter()
    cuts = dryrun_cuts()
    predicted = dryrun_predicted(cuts)
    print(f"phase 15 (b): the (1, 1) dry runs took "
          f"{time.perf_counter() - t1:.1f} s")
    measured = dryrun_measured(np, torch, ops, dev, cuts)
    lo, hi = DRYRUN_PEAK_BAND
    for name, *_ in cuts:
        p, (secs, peak) = predicted[name], measured[name]
        want = p["memory"]["peak_bytes"]
        ratio = want / peak
        print(f"phase 15 (b) {name}: predicted peak {want / 1e9:.3f} GB, "
              f"measured {peak / 1e9:.3f} GB (ratio {ratio:.3f}); roofline "
              f"bound {p['roofline']['compute_s']:.4f} / "
              f"{p['roofline']['memory_s']:.4f} s (compute / memory: "
              f"{p['roofline']['dominant']}), measured {secs:.4f} s")
        if not lo <= ratio <= hi:
            fail(f"phase 15 (b): the {name} cut's predicted peak is "
                 f"{ratio:.3f} x the measured one, outside {lo}-{hi}")
    predicted_cells = new_cells_predicted(np, wl)
    t2 = time.perf_counter()
    graphs = gnn_step_graphs(torch)
    print(f"phase 15: the {GNN_STEP_SHAPE} graphs drawn on the host in "
          f"{time.perf_counter() - t2:.1f} s")
    dryrun_gnn_card(np, torch, dev, graphs)
    print(f"phase 15 (b) took {time.perf_counter() - t1:.1f} s")
    return dryrun_sharded_prefill(np, torch, ops, dev, graphs,
                                  (wl, predicted_cells, phase9))


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
    if "--bag-bwd-only" in sys.argv[1:]:
        # Phases 1-2 and phase 10's embedding_bag_backward checks and
        # timings alone, without the steps; with --profile its time by
        # kernel.
        row, _ = train_two_tower(np, torch, ops, dev, steps=False,
                                 prof="--profile" in sys.argv[1:])
        print(json.dumps(row))
        print(f"chip_smoke --bag-bwd-only took "
              f"{time.perf_counter() - T_START:.1f} s")
        return
    if "--attention-bwd-only" in sys.argv[1:]:
        # Phases 1-2 and phase 11's flash_attention_backward checks and
        # timings alone; with --profile its time by kernel.
        from repro_torch.configs import gemma2_2b
        cfg = gemma2_2b.config()
        row = check_flash_backward(np, torch, ops, dev, cfg)
        if "--profile" in sys.argv[1:]:
            profile_flash_backward(torch, dev, cfg)
        print(json.dumps(row))
        print(f"chip_smoke --attention-bwd-only took "
              f"{time.perf_counter() - T_START:.1f} s")
        return
    if "--lm-train-only" in sys.argv[1:]:
        # Phases 1-2 and phase 11 alone: the LM training path.
        row, launches = lm_train_path(np, torch, ops, dev,
                                      "--profile" in sys.argv[1:])
        row["launches"] = launches["flash_attention_backward"]
        print(json.dumps(row))
        print(f"chip_smoke --lm-train-only took "
              f"{time.perf_counter() - T_START:.1f} s")
        return
    if "--moe-only" in sys.argv[1:]:
        # Phases 1-2 and phase 12 alone: the MoE LM, serving and training.
        fwd, bwd = moe_path(np, torch, ops, dev, "--profile" in sys.argv[1:])
        print(json.dumps({"flash_attention": fwd,
                          "flash_attention_backward": bwd}))
        print(f"chip_smoke --moe-only took "
              f"{time.perf_counter() - T_START:.1f} s")
        return
    if "--mla-only" in sys.argv[1:]:
        # Phases 1-2 and phase 13 alone: MLA and deepseek-v3-671b.
        fwd, bwd = mla_path(np, torch, ops, dev, "--profile" in sys.argv[1:])
        print(json.dumps({"flash_attention": fwd,
                          "flash_attention_backward": bwd}))
        print(f"chip_smoke --mla-only took "
              f"{time.perf_counter() - T_START:.1f} s")
        return
    if "--e3gnn-only" in sys.argv[1:]:
        # Phases 1-2 and phase 14 alone: the equivariant GNNs.
        rows = e3gnn_path(np, torch, ops, dev,
                          prof="--profile" in sys.argv[1:])
        print(json.dumps(rows))
        print(f"chip_smoke --e3gnn-only took "
              f"{time.perf_counter() - T_START:.1f} s")
        return
    if "--dryrun-only" in sys.argv[1:]:
        # Phases 1-2 and phase 15 alone: the dry run and the sharded
        # prefill.
        print(json.dumps(dryrun_path(np, torch, ops, dev)))
        print(f"chip_smoke --dryrun-only took "
              f"{time.perf_counter() - T_START:.1f} s")
        return
    if "--shard-only" in sys.argv[1:]:
        # Phases 1-2 and phase 9 alone: the sharded paths.
        launches, nccl = shard_path(np, torch, ops, dev)
        print(json.dumps({"sharded_launches": launches,
                          "nccl_world1_launches": {
                              m: r["launches"] for m, r in nccl.items()}}))
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
    if "--kg-path-only" in sys.argv[1:]:
        # Phases 1-4 alone: the KG kernels' checks and timings, then the KG
        # path's passes, each timed (its host-bound trips show what each
        # kernel call costs the host).
        launches, report, state = main_path(np, torch, dev)
        t4 = time.perf_counter()
        online_path(np, torch, dev, report, state)
        print(f"phase 4's sketch, pipelined and online passes took "
              f"{time.perf_counter() - t4:.1f} s")
        print(json.dumps({"launches": launches, "report": {
            m: {k: v for k, v in r.items() if k != "plan_groups_s"}
            for m, r in report.items()}}))
        print(f"chip_smoke --kg-path-only took "
              f"{time.perf_counter() - T_START:.1f} s")
        return
    cells = DryrunCells(DRYRUN_CELLS, ROOT / "results" / "dryrun_torch",
                        DRYRUN_JOBS_BESIDE)
    cells.start()
    launches, report, state = main_path(np, torch, dev)
    t4 = time.perf_counter()
    online_path(np, torch, dev, report, state)
    print(f"phase 4's sketch, pipelined and online passes took "
          f"{time.perf_counter() - t4:.1f} s")
    print(f"phase 4 done at {time.perf_counter() - t0:.1f} s")
    for name, row in rows.items():
        row["launches"] = launches[name]
    prof = "--profile" in sys.argv[1:]
    kept = {}
    for path in (retrieval_path, serving_path, lm_path, gnn_path):
        row, path_launches = path(np, torch, ops, dev, prof,
                                  **({"keep": kept} if path is gnn_path
                                     else {}))
        row["launches"] = path_launches[row["name"]]
        rows[row["name"]] = row
        torch.cuda.empty_cache()
        print(f"{path.__name__} done at {time.perf_counter() - t0:.1f} s")
    sharded, nccl = shard_path(np, torch, ops, dev, state["served"])
    print(f"shard_path done at {time.perf_counter() - t0:.1f} s")
    for name, n in sharded.items():
        rows[name]["sharded_launches"] = n
    torch.cuda.empty_cache()
    row, train_launches = train_path(np, torch, ops, dev)
    row["launches"] = train_launches["embedding_bag_backward"]
    rows["embedding_bag_backward"] = row
    rows["embedding_bag"]["train_launches"] = train_launches["embedding_bag"]
    print(f"train_path done at {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    row, lm_launches = lm_train_path(np, torch, ops, dev, prof)
    row["launches"] = lm_launches["flash_attention_backward"]
    rows["flash_attention_backward"] = row
    rows["flash_attention"]["train_launches"] = lm_launches["flash_attention"]
    print(f"lm_train_path done at {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    fwd, bwd = moe_path(np, torch, ops, dev, prof)
    rows["flash_attention"].update(fwd)
    rows["flash_attention_backward"].update(bwd)
    print(f"moe_path done at {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    fwd, bwd = mla_path(np, torch, ops, dev, prof)
    rows["flash_attention"].update(fwd)
    rows["flash_attention_backward"].update(bwd)
    print(f"mla_path done at {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    e3gnn_path(np, torch, ops, dev, kept.pop("graph"), prof)
    print(f"e3gnn_path done at {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    dry = dryrun_path(np, torch, ops, dev, cells, (state["wl"], nccl))
    rows["flash_attention"]["sharded_prefill_launches"] = dry["launches"]
    kg, tt = dry["cells"]["kg-specqp"], dry["cells"]["two-tower-retrieval"]
    for name in ("rank_join_lookup", "merge_topk"):
        rows[name]["sharded_cell_launches"] = sum(m[name] for m in kg.values())
    rows["topk_score_pruned"]["sharded_cell_launches"] = tt["retrieval_cand"]
    rows["embedding_bag"]["sharded_cell_launches"] = (
        tt["serve_p99"] + tt["train_batch"]["embedding_bag"])
    rows["embedding_bag_backward"]["sharded_cell_launches"] = \
        tt["train_batch"]["embedding_bag_backward"]
    print(f"dryrun_path done at {time.perf_counter() - t0:.1f} s")
    kernels = [rows[n] for n in ("rank_join_lookup", "merge_topk",
                                 "topk_score_pruned", "embedding_bag",
                                 "embedding_bag_backward",
                                 "flash_attention",
                                 "flash_attention_backward",
                                 "neigh_softmax_agg")]
    for k in kernels:
        print(f"{k['name']}: {k['launches']} launches on its path"
              + (f"; {k['granite_prefill_launches']} in phase 12's prefills"
                 if "granite_prefill_launches" in k else "")
              + (f"; {k['granite_train_launches']} in phase 12's train steps"
                 if "granite_train_launches" in k else "")
              + (f"; {k['deepseek_prefill_launches']} in phase 13's prefills"
                 if "deepseek_prefill_launches" in k else "")
              + (f"; {k['deepseek_train_launches']} in phase 13's train steps"
                 if "deepseek_train_launches" in k else ""))
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
