"""CUDA wrapper of ``csrc/merge_topk.cu``: the batched merged-stream pull,
and the custom op around it.

Counterpart of ``repro.kernels.merge_topk.merge_topk`` (which sorts with
``repro.kernels.sortnet.bitonic_topk_desc``); the plain version is
``kernels.ref.merge_topk``. ``merge_topk`` takes CUDA tensors only.
``merge_op`` (``repro_torch::merge_topk``) is the pull as a PyTorch
operator, which ``kernels.ops`` calls on any device: this kernel for CUDA
tensors, the plain version for CPU ones, the output shapes only under
``FakeTensorMode`` or on the meta device, without building or loading the
library and without counting a launch. Like ``rank_join``'s op it runs
only on a rank's local shards and has no DTensor rule, and its work is
compares, so it has no FLOP formula (``LocalCost`` counts its bytes).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._checks import check, check_cuda

_P = ctypes.c_void_p
_I = ctypes.c_int
# Shared memory holds (score, flat index) for every row padded to a power of
# two: 16384 slots use 128 KB of the 227 KB a block may have.
MAX_SLOTS = 16384


def _fn():
    fn = _build.load("merge_topk").merge_topk
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def padded_row(W: int) -> int:
    """Slots a row of W items takes in shared memory: the power of two ≥ W
    that a row's warp sorts over when the row is out of order."""
    return 1 << int(W - 1).bit_length()


def check_args(window_keys, window_scores, block: int):
    """Dtype, shape and sizes the kernel takes → (G, R, W, padded row)."""
    if window_keys.dim() != 3:
        raise ValueError("window_keys must be (G, R, W)")
    G, R, W = window_keys.shape
    check("window_keys", window_keys, torch.int32, (G, R, W))
    check("window_scores", window_scores, torch.float32, (G, R, W))
    if not 0 < block <= R * W:
        raise ValueError(f"block {block} must be in [1, R*W = {R * W}]")
    P = padded_row(W)
    if R * P > MAX_SLOTS:
        raise ValueError(f"{R} rows of {P} slots exceed the kernel's "
                         f"{MAX_SLOTS}-slot shared memory")
    if not 0 < G * R <= 2**31 - 1:
        raise ValueError(f"G * R = {G * R} blocks out of range")
    return G, R, W, P


def merge_topk(window_keys: torch.Tensor, window_scores: torch.Tensor,
               block: int):
    """(G, R, W) i32, (G, R, W) f32 → (keys (G, block) i32,
    scores (G, block) f32, flat_idx (G, block) i32), on the card."""
    G, R, W, P = check_args(window_keys, window_scores, block)
    check_cuda(window_keys, window_scores)
    fn = _fn()
    dev = window_keys.device
    keys = torch.empty((G, block), dtype=torch.int32, device=dev)
    scores = torch.empty((G, block), dtype=torch.float32, device=dev)
    idx = torch.empty((G, block), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(window_keys.data_ptr(), window_scores.data_ptr(),
             keys.data_ptr(), scores.data_ptr(), idx.data_ptr(), G, R, W, P,
             block, stream)
    if err:
        raise RuntimeError(f"merge_topk launch failed: CUDA error {err}")
    merge_topk.launches += 1
    return keys, scores, idx


merge_topk.launches = 0


@torch.library.custom_op("repro_torch::merge_topk", mutates_args=(),
                         device_types="cpu")
def merge_op(window_keys: torch.Tensor, window_scores: torch.Tensor,
             block: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(G, R, W) i32, (G, R, W) f32 → (keys (G, block) i32, scores (G,
    block) f32, flat_idx (G, block) i32); CPU tensors: the plain version."""
    return _ref.merge_topk(window_keys, window_scores, block)


@merge_op.register_kernel("cuda")
def _merge_cuda(window_keys, window_scores, block):
    return merge_topk(window_keys, window_scores, block)


@merge_op.register_fake
def _merge_fake(window_keys, window_scores, block):
    shape = (window_keys.shape[0], block)
    return (window_keys.new_empty(shape),
            window_keys.new_empty(shape, dtype=torch.float32),
            window_keys.new_empty(shape))
