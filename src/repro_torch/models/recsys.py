"""Two-tower retrieval (counterpart of ``repro.models.recsys``).

Each tower reduces a multi-hot id bag through ``embedding_bag``, appends
dense features and runs an MLP to an L2-normalised embedding. Training
uses ``loss_fn``, the reference's in-batch sampled softmax with logQ
correction, differentiated by autograd (on the card the bag's backward is
the ``embedding_bag_backward`` kernel); ``param_tree`` gives the
module's parameters as the reference's tree, for ``train.loop``.
``score_candidates`` scores one query against a candidate matrix through
the Spec-QP speculative top-k kernel; ``serve_batch`` is the online path,
without gradients: user tower, then a hierarchical top-k against a cached
item corpus.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: tuple[int, ...] = (1024, 512, 256)
    user_vocab: int = 5_000_000
    item_vocab: int = 5_000_000
    user_slots: int = 32          # multi-hot ids per user bag
    item_slots: int = 8
    n_dense_feat: int = 16
    temperature: float = 0.05
    topk_tile: int = 4096         # Spec-QP retrieval tile


class Tower(nn.Module):
    """One tower's parameters: ``table`` (vocab, D) and MLP weights
    ``w0``, ``w1``, … of shape (d_in, d_out), named as in the reference;
    ``tower["w0"]`` reads one as the reference's dict does."""

    def __init__(self, table: torch.Tensor, mlp: list[torch.Tensor]):
        super().__init__()
        self.table = nn.Parameter(table)
        self.n_layers = len(mlp)
        for i, w in enumerate(mlp):
            setattr(self, f"w{i}", nn.Parameter(w))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    @property
    def mlp(self) -> list[torch.Tensor]:
        return [getattr(self, f"w{i}") for i in range(self.n_layers)]


class TwoTower(nn.Module):
    def __init__(self, cfg: TwoTowerConfig, user: Tower, item: Tower):
        super().__init__()
        self.cfg = cfg
        self.user = user
        self.item = item

    def __getitem__(self, name: str) -> Tower:
        return getattr(self, name)


def param_tree(model: TwoTower) -> dict:
    """The model's own parameters as the reference's tree, ``{"user":
    {"table", "w0", …}, "item": {…}}``: a train state built on it updates
    the model in place."""
    return {side: dict(model[side].named_parameters())
            for side in ("user", "item")}


def _tower_init(cfg: TwoTowerConfig, vocab: int, gen: torch.Generator,
                dev: torch.device) -> Tower:
    def normal(shape, scale):
        return torch.empty(shape, device=dev).normal_(generator=gen).mul_(
            scale)

    dims = (cfg.embed_dim + cfg.n_dense_feat,) + cfg.tower_mlp
    return Tower(normal((vocab, cfg.embed_dim), 0.01),
                 [normal((dims[i], dims[i + 1]), 1.0 / math.sqrt(dims[i]))
                  for i in range(len(cfg.tower_mlp))])


def init(cfg: TwoTowerConfig, seed: int = 0, device=None) -> TwoTower:
    """Random parameters drawn in place on ``device`` (CUDA by default):
    tables normal × 0.01, MLP weights normal / √fan_in, as the reference's
    ``_tower_init``. The numbers differ from ``jax.random``'s."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return TwoTower(cfg, _tower_init(cfg, cfg.user_vocab, gen, dev),
                    _tower_init(cfg, cfg.item_vocab, gen, dev))


def tower(p, cfg: TwoTowerConfig, ids, weights, dense):
    """ids: (B, S) int32 multi-hot; weights: (B, S); dense: (B, F). ``p``
    is a ``Tower`` or its parameter dict."""
    x = torch.cat([kops.embedding_bag(p["table"], ids, weights), dense],
                  dim=-1)
    for i in range(len(cfg.tower_mlp)):
        x = x @ p[f"w{i}"]
        if i < len(cfg.tower_mlp) - 1:
            x = F.silu(x)
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=1e-6)


def loss_fn(params, cfg: TwoTowerConfig, batch):
    """In-batch sampled softmax with logQ correction.

    ``params``: a ``TwoTower`` or its ``param_tree``. batch: dict(user_ids,
    user_w, user_dense, item_ids, item_w, item_dense, item_logq (B,)).
    Returns (loss, {"loss", "in_batch_acc"}).
    """
    u = tower(params["user"], cfg, batch["user_ids"], batch["user_w"],
              batch["user_dense"])
    v = tower(params["item"], cfg, batch["item_ids"], batch["item_w"],
              batch["item_dense"])
    logits = (u @ v.T) / cfg.temperature
    logits = logits - batch["item_logq"][None, :]   # logQ correction
    labels = torch.arange(u.shape[0], device=u.device)
    logp = F.log_softmax(logits.float(), dim=-1)
    loss = -torch.mean(logp.gather(1, labels[:, None]))
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return loss, {"loss": loss, "in_batch_acc": acc}


@torch.no_grad()
def score_candidates(params, cfg: TwoTowerConfig, query, cand_emb, k: int,
                     speculative: bool = True):
    """Top-k of one query against a candidate matrix (N, D).

    ``speculative=True`` prunes with per-tile Cauchy–Schwarz bounds; False
    scores every tile (the TriniT-analogue baseline). ``params`` is unused,
    as in the reference. Returns (scores (k,), idx (k,), n_tiles_scored).
    """
    n = cand_emb.shape[0]
    tile = min(cfg.topk_tile, n)
    if speculative:
        bounds = kops.block_bounds_cauchy(query, cand_emb, tile)
    else:
        bounds = torch.full((n // tile,), float("inf"),
                            device=cand_emb.device)
    return kops.topk_score_pruned(query, cand_emb, bounds, k, tile)


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: values descending, equal values
    in index order, the k-th place to the lowest index among its equals.

    ``torch.topk`` orders ties arbitrarily, so its pick is repaired: the k
    taken are re-sorted stably by value from index order, and a row whose
    k-th and (k+1)-th values are equal (where ``torch.topk`` may have taken
    other equal entries) is redone with a full stable sort;
    ``_top_k.full_sorts`` counts the rows so redone.
    """
    n = x.shape[-1]
    vals, idx = torch.topk(x, min(k + 1, n), dim=-1)
    edge = vals[..., k] == vals[..., k - 1] if n > k else None
    idx, perm = torch.sort(idx[..., :k], dim=-1)
    vals, perm = torch.sort(vals[..., :k].gather(-1, perm), dim=-1,
                            descending=True, stable=True)
    idx = idx.gather(-1, perm)
    if edge is not None and bool(edge.any()):
        rows = edge.nonzero(as_tuple=True)
        _top_k.full_sorts += len(rows[0])
        v, i = torch.sort(x[rows], dim=-1, descending=True, stable=True)
        vals[rows], idx[rows] = v[..., :k], i[..., :k]
    return vals, idx


_top_k.full_sorts = 0


@torch.no_grad()
def serve_batch(params: TwoTower, cfg: TwoTowerConfig, batch, cand_emb,
                k: int, n_blocks: int = 16, batch_chunk: int = 4096):
    """Online inference: user tower + dot top-k against a cached corpus.

    Hierarchical top-k: the corpus splits into ``n_blocks`` and the batch
    into chunks of ``batch_chunk``; a chunk's (chunk, blocks, N / blocks)
    scores live only while it is scored, never a full (B, N) matrix. The
    block-local top-k, then a top-k over the k·n_blocks survivors, gives
    ``lax.top_k``'s result over the whole row. Returns (scores (B, k),
    idx (B, k) int32).
    """
    u = tower(params.user, cfg, batch["user_ids"], batch["user_w"],
              batch["user_dense"])
    b = u.shape[0]
    n, _ = cand_emb.shape
    bc = min(batch_chunk, b)
    if n % n_blocks or b % bc:
        raise ValueError(f"N = {n} must divide into {n_blocks} blocks and "
                         f"B = {b} into chunks of {bc}")
    blk = n // n_blocks
    offs = torch.arange(n_blocks, device=u.device)[None, :, None] * blk
    top_s, top_i = [], []
    for u_chunk in u.split(bc):
        s = (u_chunk @ cand_emb.T).view(bc, n_blocks, blk)
        ls, li = _top_k(s, k)                        # block-local top-k
        fs, fi = _top_k(ls.reshape(bc, -1), k)
        top_s.append(fs)
        top_i.append((li + offs).reshape(bc, -1).gather(1, fi))
    return torch.cat(top_s), torch.cat(top_i).to(torch.int32)
