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

Laid over a mesh (``repro_torch.sharding``; ``param_axes`` are the
reference's), a table split by rows runs a vocab-parallel bag: each rank
bags the ids of its own rows through the kernel, and the partial sums add
up over the table's axes. ``serve_batch`` splits the corpus's blocks over
the model axis, takes each block's top-k on its own rank and merges the
k·blocks survivors, as the reference lays it out; the (chunk, corpus)
scores are never gathered.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import sharding
from repro_torch.core.types import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models.common import top_k as _top_k


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


def param_axes(cfg: TwoTowerConfig) -> dict:
    """The logical axes of ``param_tree``'s leaves, the reference's
    ``_tower_init``'s: each table ("table_vocab", None), each MLP weight
    ("embed_fsdp", "mlp")."""
    side = {"table": ("table_vocab", None),
            **{f"w{i}": ("embed_fsdp", "mlp")
               for i in range(len(cfg.tower_mlp))}}
    return {"user": dict(side), "item": dict(side)}


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
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    return TwoTower(cfg, _tower_init(cfg, cfg.user_vocab, gen, dev),
                    _tower_init(cfg, cfg.item_vocab, gen, dev))


def tower(p, cfg: TwoTowerConfig, ids, weights, dense):
    """ids: (B, S) int32 multi-hot; weights: (B, S); dense: (B, F). ``p``
    is a ``Tower`` or its parameter dict."""
    x = torch.cat([_bag(p["table"], ids, weights), dense], dim=-1)
    x = sharding.constrain(x, "batch", None)
    for i in range(len(cfg.tower_mlp)):
        x = x @ sharding.pin_weight(p[f"w{i}"], "embed_fsdp", "mlp")
        if i < len(cfg.tower_mlp) - 1:
            x = F.silu(x)
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=1e-6)


def _bag(table, ids, weights):
    """``embedding_bag``; on a ``DTensor`` table, the vocab-parallel bag."""
    from torch.distributed.tensor import DTensor
    if isinstance(table, DTensor):
        return _vocab_parallel_bag(table, ids, weights)
    return kops.embedding_bag(table, ids, weights)


def _vocab_parallel_bag(table, ids, weights):
    """The bag of a table split by rows over some mesh axes (its
    "table_vocab" ones): ids and weights whole over those axes (a batch
    split kept), each rank's ids shifted by its first row and set to -1
    outside its rows (the kernel skips them), the kernel run on its local
    rows, and the (B, D) result a ``Partial`` sum over the table's axes.
    The table's gradient is this rank's rows (``Shard(0)``, summed over a
    batch split: ``Partial`` there); the weights' is ``Partial`` over the
    table's axes, each rank's slots of its own rows. (Over a mesh
    dimension of one rank a partial sum is the whole: ``Replicate``, which
    spares an all-reduce of a (V, D) gradient.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    split = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    table = table.redistribute(mesh, [Shard(0) if s else Replicate()
                                      for s in split])

    def whole_over_table_axes(t):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, [
            p if not s and isinstance(p, Shard) and p.dim == 0
            else Replicate() for s, p in zip(split, t.placements)])

    ids, weights = whole_over_table_axes(ids), whole_over_table_axes(weights)
    first, n = _split_index(mesh, split)
    if table.shape[0] % n:
        raise ValueError(f"{table.shape[0]} rows do not split evenly over "
                         f"{n} shards")
    rows = table.shape[0] // n
    first *= rows
    batch = [isinstance(p, Shard) for p in ids.placements]

    def summed(i):
        return Partial() if mesh.size(i) > 1 else Replicate()

    local_table = table.to_local(grad_placements=[
        Shard(0) if s else summed(i) if b else Replicate()
        for i, (s, b) in enumerate(zip(split, batch))])
    local_w = weights.to_local(grad_placements=[
        summed(i) if s else p
        for i, (s, p) in enumerate(zip(split, weights.placements))])
    local_ids = ids.to_local()
    mine = (local_ids >= first) & (local_ids < first + rows)
    out = kops.embedding_bag(local_table,
                             torch.where(mine, local_ids - first, -1),
                             local_w)
    return DTensor.from_local(out, mesh, [
        summed(i) if s else p for i, (s, p) in enumerate(zip(split,
                                                             ids.placements))],
        run_check=False)


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
    loss = -torch.mean(_diagonal(logp))
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return loss, {"loss": loss, "in_batch_acc": acc}


def _split_index(mesh, dims) -> tuple[int, int]:
    """(this rank's index among the shards, the shard count) of a dimension
    split over the mesh dimensions where ``dims`` holds, major first."""
    coord, index, count = mesh.get_coordinate(), 0, 1
    for i, split in enumerate(dims):
        if split:
            index, count = index * mesh.size(i) + coord[i], count * mesh.size(i)
    return index, count


def _diagonal(logp: torch.Tensor) -> torch.Tensor:
    """(B, 1): each row's own column, row i's column i, by a gather. On a
    DTensor split by rows each rank gathers its own rows: DTensor's gather
    would have its backward fill a whole (B, B) tensor with zeros, 17 GB a
    card at the train cell's batch."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(logp, DTensor):
        labels = torch.arange(logp.shape[0], device=logp.device)
        return logp.gather(1, labels[:, None])
    mesh = logp.device_mesh
    rows = [isinstance(p, Shard) and p.dim == 0 for p in logp.placements]
    where = [Shard(0) if r else Replicate() for r in rows]
    local = logp.redistribute(mesh, where).to_local()
    first = _split_index(mesh, rows)[0] * local.shape[0]
    labels = torch.arange(first, first + local.shape[0], device=local.device)
    return DTensor.from_local(local.gather(1, labels[:, None]), mesh, where,
                              run_check=False)


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


@torch.no_grad()
def serve_batch(params, cfg: TwoTowerConfig, batch, cand_emb, k: int,
                n_blocks: int = 16, batch_chunk: int = 4096):
    """Online inference: user tower + dot top-k against a cached corpus.

    Hierarchical top-k: the corpus splits into ``n_blocks`` and the batch
    into chunks of ``batch_chunk``; a chunk's (chunk, blocks, N / blocks)
    scores live only while it is scored, never a full (B, N) matrix. The
    block-local top-k, then a top-k over the k·n_blocks survivors, gives
    ``lax.top_k``'s result over the whole row. ``params`` is a
    ``TwoTower`` or its ``param_tree``; a ``DTensor`` corpus runs
    ``_serve_sharded``. Returns (scores (B, k), idx (B, k) int32).
    """
    u = tower(params["user"], cfg, batch["user_ids"], batch["user_w"],
              batch["user_dense"])
    b = u.shape[0]
    n, _ = cand_emb.shape
    bc = min(batch_chunk, b)
    if n % n_blocks or b % bc:
        raise ValueError(f"N = {n} must divide into {n_blocks} blocks and "
                         f"B = {b} into chunks of {bc}")
    from torch.distributed.tensor import DTensor
    if isinstance(cand_emb, DTensor):
        return _serve_sharded(u, cand_emb, k, n_blocks, bc)
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


def _serve_sharded(u, cand_emb, k: int, n_blocks: int, bc: int):
    """``serve_batch``'s top-k laid out as the reference's: the corpus's
    blocks over the model axis (its "heads" rule), the users over the
    batch's axes. Each rank scores its share of a chunk of ``bc`` users
    against its own blocks and keeps each block's top-k; the (share, blocks,
    k) survivors are gathered over the blocks' axes, in block order, and
    the top-k of each row's k·n_blocks is the unsharded one. Returns
    (scores, idx) as DTensors split like the users."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    cand = sharding.constrain(cand_emb, "heads", None)
    u = sharding.constrain(u, "batch", None)
    mesh = cand.device_mesh
    rows = [isinstance(p, Shard) for p in cand.placements]
    users = [isinstance(p, Shard) and not r
             for p, r in zip(u.placements, rows)]
    u = u.redistribute(mesh, [Shard(0) if s else Replicate() for s in users])
    flat, n_split = _split_index(mesh, rows)
    if n_blocks % n_split:
        raise ValueError(f"{n_blocks} blocks do not split over {n_split} "
                         "ranks")
    u_l, c_l = u.to_local(), cand.to_local()
    nb, blk = n_blocks // n_split, cand.shape[0] // n_blocks
    share = bc * u_l.shape[0] // u.shape[0]
    offs = (flat * c_l.shape[0]
            + torch.arange(nb, device=u_l.device)[None, :, None] * blk)
    gathered = [Shard(0) if s else Replicate() for s in users]
    top_s, top_i = [], []
    for u_chunk in u_l.split(share):
        s = (u_chunk @ c_l.T).view(share, nb, blk)
        ls, li = _top_k(s, k)                        # block-local top-k
        both = [DTensor.from_local(x, mesh, [
            Shard(0) if us else Shard(1) if r else Replicate()
            for us, r in zip(users, rows)], run_check=False).redistribute(
                mesh, gathered).to_local()
            for x in (ls, li + offs)]
        fs, fi = _top_k(both[0].reshape(share, -1), k)
        top_s.append(fs)
        top_i.append(both[1].reshape(share, -1).gather(1, fi))
    return tuple(DTensor.from_local(x, mesh, gathered, run_check=False)
                 for x in (torch.cat(top_s), torch.cat(top_i).to(torch.int32)))
