"""two-tower-retrieval [RecSys'19 (YouTube)]: embed_dim 256, tower MLP
1024-512-256, dot interaction. Two 20 M-row × 256 tables (41 GB in f32)
fit one 80 GB card whole.

Counterpart of ``repro.configs.two_tower_retrieval``: the configuration,
the serving constants, the training configuration (``TRAIN_CFG``, the
``train_batch`` shape's optimizer), the online serving function
(``serve``, the ``serve_p99`` / ``serve_bulk`` shapes), speculative
retrieval over a candidate corpus (``retrieve``, the ``retrieval_cand``
shape), unsharded or over the ranks of a ``launch.mesh.Mesh``, the dry
run's cells (``make_cell``: the tables split by rows over the model axis,
the corpus over every axis), and ``smoke``: one train step and a small
speculative retrieval.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from repro_torch.configs import base
from repro_torch.core.types import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import Mesh
from repro_torch.models import recsys as model
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt_lib

ARCH = "two-tower-retrieval"
FAMILY = "recsys"
SHAPES = ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"]
SKIP_SHAPES: dict[str, str] = {}
# The batch of each cell that takes one.
CELL_BATCH = {"train_batch": 65_536, "serve_p99": 512, "serve_bulk": 262_144}

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


def _batch_specs(cfg: model.TwoTowerConfig, B: int) -> dict:
    """A batch of B users and their items as meta tensors, by field."""
    return {
        "user_ids": base.spec((B, cfg.user_slots), "int32"),
        "user_w": base.spec((B, cfg.user_slots)),
        "user_dense": base.spec((B, cfg.n_dense_feat)),
        "item_ids": base.spec((B, cfg.item_slots), "int32"),
        "item_w": base.spec((B, cfg.item_slots)),
        "item_dense": base.spec((B, cfg.n_dense_feat)),
        "item_logq": base.spec((B,)),
    }


def _batch_axes() -> dict:
    """The batch's logical axes: every field split over "batch"."""
    return {"user_ids": ("batch", None), "user_w": ("batch", None),
            "user_dense": ("batch", None), "item_ids": ("batch", None),
            "item_w": ("batch", None), "item_dense": ("batch", None),
            "item_logq": ("batch",)}


def _init(cfg: model.TwoTowerConfig):
    def init(device):
        return (model.param_tree(model.init(cfg, device=device)),
                model.param_axes(cfg))
    return init


def make_cell(shape: str) -> base.CellSpec:
    """The (two-tower × shape) cell, the reference's: ``train_batch`` one
    ``TRAIN_CFG`` step (bf16 moments) on 65,536 pairs; ``serve_p99`` and
    ``serve_bulk`` ``serve`` of 512 and 262,144 users against the
    ``CORPUS``-row cache; ``retrieval_cand`` the sharded ``retrieve`` of
    one query over the ``N_CAND_PAD``-row corpus. Parameters come from
    ``recsys.init`` on the meta device with ``recsys.param_axes``; the
    corpora are split by rows over "candidates"."""
    cfg = config()
    if shape == "train_batch":
        state, state_axes = base.train_state_specs(_init(cfg), TRAIN_CFG)
        step = train_loop.make_train_step(partial(_loss, cfg=cfg), TRAIN_CFG)
        return base.CellSpec(ARCH, shape, "train", step,
                             (state, _batch_specs(cfg, CELL_BATCH[shape])),
                             (state_axes, _batch_axes()))
    if shape in ("serve_p99", "serve_bulk"):
        params, p_axes = base.eval_shape_with_axes(_init(cfg))
        return base.CellSpec(
            ARCH, shape, "serve", partial(_serve, cfg=cfg, k=TOPK),
            (params, _batch_specs(cfg, CELL_BATCH[shape]),
             base.spec((CORPUS, cfg.embed_dim))),
            (p_axes, _batch_axes(), ("candidates", None)))
    if shape == "retrieval_cand":
        return base.CellSpec(
            ARCH, shape, "retrieval",
            partial(retrieve_cell, k=TOPK, tile=TILE),
            (base.spec((cfg.embed_dim,)),
             base.spec((N_CAND_PAD, cfg.embed_dim))),
            ((None,), ("candidates", None)))
    raise KeyError(shape)


def _loss(params, batch, *, cfg):
    return model.loss_fn(params, cfg, batch)


def _serve(params, batch, cand_emb, *, cfg, k):
    return model.serve_batch(params, cfg, batch, cand_emb, k)


def retrieve_cell(query, cand_emb, *, k: int, tile: int):
    """``retrieval_cand``'s function, the reference's ``shard_map`` body:
    ``retrieve`` of this rank's block of a corpus split by rows over every
    mesh axis, on a ``Mesh`` over its ``DeviceMesh``; (scores, ids, tiles
    scored), equal on every rank."""
    from torch.distributed.tensor import Shard
    if any(p != Shard(0) for p in cand_emb.placements):
        raise ValueError(f"the corpus must be split by rows over every mesh "
                         f"axis, got {cand_emb.placements}")
    block = cand_emb.to_local()
    mesh = Mesh.from_device_mesh(cand_emb.device_mesh, block.device)
    return retrieve(query.to_local(), block, k, tile, mesh=mesh)


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
