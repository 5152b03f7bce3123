"""CUDA wrappers of ``csrc/embedding_bag.cu``: the weighted embedding bag
and its backward.

``embedding_bag`` is the counterpart of
``repro.kernels.embedding_bag.embedding_bag``. Where gradients are wanted
it runs as a ``torch.autograd.Function`` whose backward is the hand-written
``embedding_bag_backward`` kernel (the table's dense gradient by float32
atomics, and the weights' gradient when asked for); the reference has no
VJP for its Pallas kernel and differentiates its plain version instead.
The plain versions are ``kernels.ref.embedding_bag`` and
``kernels.ref.embedding_bag_backward``; ``kernels.ops`` chooses by device.
These wrappers take CUDA tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check, check_cuda

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _fn():
    fn = _build.load("embedding_bag").embedding_bag
    fn.argtypes = [_P, _P, _P, _P, _LL, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    fn = _build.load("embedding_bag").embedding_bag_backward
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _P]
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
    return b, s, d


def _forward(table, ids, weights) -> torch.Tensor:
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


class _Bag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, weights):
        ctx.save_for_backward(table, ids, weights)
        return _forward(table, ids, weights)

    @staticmethod
    def backward(ctx, dout):
        table, ids, weights = ctx.saved_tensors
        dout = dout.contiguous()
        if dout.data_ptr() % 16:
            dout = dout.clone()
        dtable, dweights = embedding_bag_backward(
            dout, ids, weights, table,
            table_grad=ctx.needs_input_grad[0],
            weights_grad=ctx.needs_input_grad[2])
        return dtable, None, dweights


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """(V, D) f32, (B, S) i32, (B, S) f32 → (B, D) f32, on the card;
    differentiable in ``table`` and ``weights``."""
    if torch.is_grad_enabled() and (table.requires_grad
                                    or weights.requires_grad):
        return _Bag.apply(table, ids, weights)
    return _forward(table, ids, weights)


embedding_bag.launches = 0


def embedding_bag_backward(dout: torch.Tensor, ids: torch.Tensor,
                           weights: torch.Tensor, table: torch.Tensor, *,
                           table_grad: bool = True,
                           weights_grad: bool = False,
                           out: torch.Tensor | None = None):
    """The bag's gradients from ``dout`` (B, D) f32, on the card:
    (dtable (V, D) or None, dweights (B, S) or None). ``table`` gives V
    and D, and is read for ``dweights`` only. ``dtable`` is added into
    ``out`` where given (a (V, D) f32 the caller zero-filled), else into a
    new ``torch.zeros`` buffer: that fill is outside the kernel."""
    b, s, d = check_args(table, ids, weights)
    check("dout", dout, torch.float32, (b, d))
    check_cuda(dout, ids, weights, table)
    if dout.data_ptr() % 16:
        raise ValueError("dout must be 16-byte aligned")
    dtable = dweights = None
    if table_grad:
        if out is None:
            out = torch.zeros(table.shape, dtype=torch.float32,
                              device=table.device)
        check("out", out, torch.float32, tuple(table.shape))
        check_cuda(out, table)
        if out.data_ptr() % 16:
            raise ValueError("out must be 16-byte aligned")
        dtable = out
    if weights_grad:
        dweights = torch.empty((b, s), dtype=torch.float32,
                               device=table.device)
    if dtable is None and dweights is None:
        return None, None
    fn = _bwd_fn()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = fn(dout.data_ptr(), ids.data_ptr(), weights.data_ptr(),
             table.data_ptr(), None if dtable is None else dtable.data_ptr(),
             None if dweights is None else dweights.data_ptr(), b, s, d,
             stream)
    if err:
        raise RuntimeError(f"embedding_bag_backward launch failed: CUDA "
                           f"error {err}")
    embedding_bag_backward.launches += 1
    return dtable, dweights


embedding_bag_backward.launches = 0
