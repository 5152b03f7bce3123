"""CUDA wrapper of ``csrc/topk_score.cu``: Spec-QP speculative retrieval,
and the custom op around it.

Counterpart of ``repro.kernels.topk_score.topk_score_pruned``; the plain
version is ``kernels.ref.topk_score_pruned``. ``topk_score_pruned`` takes
CUDA tensors only. ``pruned_op`` (``repro_torch::topk_score_pruned``) is
the retrieval as a PyTorch operator, which ``kernels.ops`` calls on any
device: this kernel for CUDA tensors, the plain version for CPU ones, the
output shapes only under ``FakeTensorMode`` or on the meta device, without
building or loading the library and without counting a launch. It runs on
a rank's own block of the corpus (``two_tower_retrieval.retrieve``), so it
has no DTensor rule; its FLOP formula counts every tile.
``block_bounds_cauchy`` is plain PyTorch on any device, as the reference's
is plain jnp.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._checks import check, check_cuda

_P = ctypes.c_void_p
_I = ctypes.c_int
# Shared memory a block may have on Hopper (bytes), less the kernel's static
# shared memory (the replay's window of 512 tiles' flags, bounds, first
# scores and batch plan).
MAX_SMEM = 232448 - 16384
# Widest row the kernel scores (its templates cover 1 and 2 vectors of four
# floats per lane).
MAX_D = 256


def _fn():
    fn = _build.load("topk_score").topk_score_pruned
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def _pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 1)


# The replay's batch merges gather up to this many entries (the buffer's
# and the batch's lists'), a power of two; behind the buffer they take
# twice that, less k (staged lists, gathered entries).
BATCH_GATHER = 4096


def smem_slots(k: int, tile: int) -> int:
    """(score, index) slots of the kernel's shared memory, the largest of:
    the replay's top-k buffer and a tile it scores itself (k + the tile's
    sort, padded to a power of two); the bitonic merge of the buffer with
    one tile's min(k, tile)-entry list; and, where a batch can gather the
    buffer and two lists, the batch merge's."""
    one = _pow2(k + min(k, tile))
    batch = (2 * BATCH_GATHER if BATCH_GATHER - k >= 2 * min(k, tile)
             else 0)
    return max(k + _pow2(tile), one, batch)


def check_args(query, cands, block_bounds, k: int, tile: int):
    """Dtype, shape, alignment and sizes the kernel takes →
    (n_tiles, D, smem slots)."""
    if cands.dim() != 2:
        raise ValueError("cands must be (N, D)")
    n, d = cands.shape
    check("query", query, torch.float32, (d,))
    check("cands", cands, torch.float32, (n, d))
    if tile <= 0 or n % tile:
        raise ValueError(f"N = {n} must be a positive multiple of "
                         f"tile = {tile}")
    check("block_bounds", block_bounds, torch.float32, (n // tile,))
    if k <= 0:
        raise ValueError(f"k = {k} must be positive")
    if d % 4 or query.data_ptr() % 16 or cands.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte vectors: D must be a "
                         "multiple of 4 and query, cands 16-byte aligned")
    if d > MAX_D:
        raise ValueError(f"D = {d} exceeds the kernel's {MAX_D}")
    if n >= 2**31 - 1:
        raise ValueError(f"N = {n} candidates exceed 32-bit indices")
    slots = smem_slots(k, tile)
    if slots * 8 > MAX_SMEM:
        raise ValueError(f"k = {k} and tile = {tile} exceed the kernel's "
                         "shared memory")
    return n // tile, d, slots


def topk_score_pruned(query: torch.Tensor, cands: torch.Tensor,
                      block_bounds: torch.Tensor, k: int, tile: int):
    """(D,) f32, (N, D) f32, (N/tile,) f32 → (scores (k,) f32, idx (k,)
    i32, n_tiles_scored () i32), on the card. One launch; its workspace
    (control words, one flag a tile, one list of min(k, tile) entries a
    tile) is allocated here. ``topk_score_pruned.last_tiles_read`` is then
    the tiles the launch read, counted or not (a () i32 on the card)."""
    n_tiles, d, slots = check_args(query, cands, block_bounds, k, tile)
    check_cuda(query, cands, block_bounds)
    fn = _fn()
    dev = cands.device
    scores = torch.empty((k,), dtype=torch.float32, device=dev)
    idx = torch.empty((k,), dtype=torch.int32, device=dev)
    cnt = torch.empty((), dtype=torch.int32, device=dev)
    work = torch.empty((4 + 2 * n_tiles + 2 * n_tiles * min(k, tile),),
                       dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(query.data_ptr(), cands.data_ptr(), block_bounds.data_ptr(),
             scores.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
             work.data_ptr(), n_tiles, tile, d, k, slots, stream)
    if err:
        raise RuntimeError(f"topk_score_pruned launch failed: CUDA error "
                           f"{err}")
    topk_score_pruned.launches += 1
    topk_score_pruned.last_tiles_read = work[2]
    return scores, idx, cnt


topk_score_pruned.launches = 0
topk_score_pruned.last_tiles_read = None


@torch.library.custom_op("repro_torch::topk_score_pruned", mutates_args=(),
                         device_types="cpu")
def pruned_op(query: torch.Tensor, cands: torch.Tensor,
              block_bounds: torch.Tensor, k: int,
              tile: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(D,) f32, (N, D) f32, (N/tile,) f32 → (scores (k,) f32, idx (k,)
    i32, n_tiles_scored () i32); CPU tensors: the plain version."""
    return _ref.topk_score_pruned(query, cands, block_bounds, k, tile)


@pruned_op.register_kernel("cuda")
def _pruned_cuda(query, cands, block_bounds, k, tile):
    return topk_score_pruned(query, cands, block_bounds, k, tile)


@pruned_op.register_fake
def _pruned_fake(query, cands, block_bounds, k, tile):
    return (cands.new_empty((k,)), cands.new_empty((k,), dtype=torch.int32),
            cands.new_empty((), dtype=torch.int32))


@register_flop_formula(torch.ops.repro_torch.topk_score_pruned)
def _pruned_flops(query_shape, cands_shape, bounds_shape, k, tile,
                  out_shape=None, **kwargs) -> int:
    """2·N·D: a multiply and an add a candidate and dimension, for every
    tile. Which tiles the bounds prune depends on the data, which the shapes
    do not show, so this counts the most the call can do."""
    n, d = cands_shape
    return 2 * n * d


def block_bounds_cauchy(query: torch.Tensor, cands: torch.Tensor,
                        tile: int) -> torch.Tensor:
    """Cauchy–Schwarz per-tile bounds: ‖q‖ · max_i ‖c_i‖ within the tile."""
    n = cands.shape[0]
    norms = torch.linalg.vector_norm(cands, dim=1).reshape(n // tile, tile)
    return norms.amax(dim=1) * torch.linalg.vector_norm(query)
