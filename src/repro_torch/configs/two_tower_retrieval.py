"""two-tower-retrieval [RecSys'19 (YouTube)]: embed_dim 256, tower MLP
1024-512-256, dot interaction. Two 20 M-row × 256 tables (41 GB in f32)
fit one 80 GB card whole.

Counterpart of ``repro.configs.two_tower_retrieval``: the configuration,
the serving constants, the training configuration (``TRAIN_CFG``, the
``train_batch`` shape's optimizer), the online serving function
(``serve``, the ``serve_p99`` / ``serve_bulk`` shapes), speculative
retrieval over a candidate corpus (``retrieve``, the ``retrieval_cand``
shape), unsharded or over the ranks of a ``launch.mesh.Mesh``, and
``smoke``: one train step and a small speculative retrieval.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import recsys as model
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt_lib

ARCH = "two-tower-retrieval"
FAMILY = "recsys"
# The reference's dry-run cells (not laid out over a mesh yet).
SHAPES = ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"]

CORPUS = 1_048_576          # cached item embeddings for the serve shapes
N_CAND = 1_000_000          # retrieval_cand logical size
N_CAND_PAD = 1_048_576      # padded with zero rows to whole tiles
TOPK = 100
TILE = 512                  # scoring tile

TRAIN_CFG = train_loop.TrainConfig(
    opt=opt_lib.AdamWConfig(lr=1e-3, moment_dtype="bfloat16"))


def config() -> model.TwoTowerConfig:
    return model.TwoTowerConfig(
        name=ARCH, embed_dim=256, tower_mlp=(1024, 512, 256),
        user_vocab=20_000_000, item_vocab=20_000_000,
        user_slots=32, item_slots=8, n_dense_feat=16, topk_tile=TILE)


def smoke_config() -> model.TwoTowerConfig:
    return dataclasses.replace(
        config(), embed_dim=32, tower_mlp=(64, 32), user_vocab=2000,
        item_vocab=2000, user_slots=4, item_slots=2, n_dense_feat=4,
        topk_tile=256)


def serve(params: model.TwoTower, batch, cand_emb, k: int = TOPK):
    """Top-k items of every user in ``batch`` against the cached corpus."""
    return model.serve_batch(params, params.cfg, batch, cand_emb, k)


def retrieve(query, cand_emb, k: int = TOPK, tile: int = TILE, mesh=None):
    """Speculative top-k of one query: Cauchy–Schwarz tile bounds, then the
    pruned scoring kernel. Returns (scores (k,), ids (k,), tiles scored).

    With ``mesh``, ``cand_emb`` is this rank's block of a corpus split in
    row-major rank order over every mesh axis: each rank scores its block
    with local bounds, its ids are made global, and a gather + top-k per
    axis merges the ranks' top-k (``Mesh.merge_top_k``, as the KG engine
    merges); the tiles scored are summed over the ranks.
    """
    bounds = kops.block_bounds_cauchy(query, cand_emb, tile)
    s, i, n = kops.topk_score_pruned(query, cand_emb, bounds, k, tile)
    if mesh is None:
        return s, i, n
    axes = mesh.axis_names
    i = torch.where(i >= 0, i + mesh.flat_index(axes) * cand_emb.shape[0],
                    -1)
    s, i = mesh.merge_top_k(s, i, k, axes)
    for ax in axes:
        n = mesh.psum(n, ax)
    return s, i, n


def smoke(device=None):
    """One train step of the smoke model on a seeded batch, then a
    speculative top-8 over a small random corpus: (metrics, (scores, ids,
    tiles scored)). The batch, corpus and query are the reference's numpy
    draws; the parameters are the port's ``init`` (seed 0)."""
    dev = resolve_device(device)
    cfg = smoke_config()
    params = model.init(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    B = 32

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    f32, i32 = torch.float32, torch.int32
    batch = {
        "user_ids": t(rng.integers(0, cfg.user_vocab, (B, cfg.user_slots)),
                      i32),
        "user_w": torch.ones((B, cfg.user_slots), device=dev),
        "user_dense": t(rng.standard_normal((B, cfg.n_dense_feat)), f32),
        "item_ids": t(rng.integers(0, cfg.item_vocab, (B, cfg.item_slots)),
                      i32),
        "item_w": torch.ones((B, cfg.item_slots), device=dev),
        "item_dense": t(rng.standard_normal((B, cfg.n_dense_feat)), f32),
        "item_logq": torch.zeros((B,), device=dev),
    }
    tc = train_loop.TrainConfig(opt=opt_lib.AdamWConfig(lr=1e-3))
    state = train_loop.make_train_state(model.param_tree(params), tc)
    step = train_loop.make_train_step(
        lambda p, b: model.loss_fn(p, cfg, b), tc)
    state, metrics = step(state, batch)
    # speculative retrieval exactness on a small corpus
    cand = t(rng.standard_normal((1024, cfg.embed_dim)), f32)
    q = t(rng.standard_normal((cfg.embed_dim,)), f32)
    s, i, n = model.score_candidates(params, cfg, q, cand, 8)
    return metrics, (s, i, n)
