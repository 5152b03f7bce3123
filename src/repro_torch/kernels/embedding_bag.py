"""CUDA wrapper of ``csrc/embedding_bag.cu``: the weighted embedding bag.

Counterpart of ``repro.kernels.embedding_bag.embedding_bag``; the plain
version is ``kernels.ref.embedding_bag`` and ``kernels.ops`` chooses
between them by device. This wrapper takes CUDA tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check, check_cuda

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = _build.load("embedding_bag").embedding_bag
    fn.argtypes = [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def check_args(table, ids, weights):
    """Dtype, shape, alignment and sizes the kernel takes → (B, S, D)."""
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError("table and ids must be (V, D) and (B, S)")
    v, d = table.shape
    b, s = ids.shape
    check("table", table, torch.float32, (v, d))
    check("ids", ids, torch.int32, (b, s))
    check("weights", weights, torch.float32, (b, s))
    if d % 4 or table.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte vectors: D must be a "
                         "multiple of 4 and the table 16-byte aligned")
    if table.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("embedding_bag has no backward kernel yet")
    return b, s, d


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """(V, D) f32, (B, S) i32, (B, S) f32 → (B, D) f32, on the card."""
    b, s, d = check_args(table, ids, weights)
    check_cuda(table, ids, weights)
    fn = _fn()
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = fn(table.data_ptr(), ids.data_ptr(), weights.data_ptr(),
             out.data_ptr(), b, s, d, stream)
    if err:
        raise RuntimeError(f"embedding_bag launch failed: CUDA error {err}")
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
