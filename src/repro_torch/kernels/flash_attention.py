"""CUDA wrappers of ``csrc/flash_attention.cu`` (the attention forward) and
``csrc/flash_attention_bwd.cu`` (its backward), and the autograd Function
that joins them.

Counterpart of ``repro.kernels.flash_attention.flash_attention``; the plain
versions are ``kernels.ref.flash_attention``, ``flash_attention_fwd_stats``
and ``flash_attention_bwd``, and ``kernels.ops`` chooses between them by
device. These wrappers take bf16 CUDA tensors of head_dim 64, 128, 192 or
256 only (192 is MLA's q·k width, with v padded to it). The inputs may be
strided views, e.g. the model's (B, S, H, D) activations seen as (B, H, S,
D): the kernels read them through their strides, and each output keeps its
input's stride order.

``flash_attention`` is differentiable: where q, k or v needs a gradient it
runs ``Attention``, whose forward is the forward kernel with its lse output
and whose backward is the backward kernel. ``flash_attention.launches``
counts forward launches, ``flash_attention_backward.launches`` backward
calls (each three kernels: the stat pass, dK/dV, dQ).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_cuda

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
HEAD_DIMS = (64, 128, 192, 256)
# Keys per tile by head_dim and query rows per consumer warpgroup, as
# csrc/flash_attention.cu sets them (Tile<D>, WG_ROWS): the tests and
# chip_smoke.py place their edge cases with them.
TILE_N = {64: 128, 128: 128, 192: 112, 256: 80}
WARPGROUP_ROWS = 64
# csrc/flash_attention_bwd.cu's tiles: keys a dK/dV block by head_dim
# (KvTile<D>::BN), and the q rows and keys of the 64 x 64 tile that each
# consumer warpgroup masks and multiplies (BM) in both passes.
BWD_TILE = {64: 128, 128: 128, 192: 64, 256: 64}
# The dK/dV pass's columns by consumer warpgroup, (first column, count):
# whole 64-column chunks, split where one consumer cannot hold 64 keys x D
# of both dK and dV (dkdv_consumer's c0 and DN).
BWD_COLUMNS = {64: ((0, 64),), 128: ((0, 128),),
               192: ((0, 128), (128, 64)), 256: ((0, 128), (128, 128))}
BWD_ROWS = 64
# q rows of a dQ block (QROWS); the stat scratch is padded to a multiple.
BWD_QROWS = 128


def _fn():
    fn = _build.load("flash_attention").flash_attention_bf16
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _F, _I,
                   _I, _F, _P]
    fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_bf16
    fn.argtypes = [_P] * 10 + [_I] * 6 + [_P, _F, _I, _I, _F, _P]
    fn.restype = ctypes.c_int
    return fn


def _layout_ok(t: torch.Tensor) -> bool:
    """TMA's and the kernels' rules: a contiguous last axis, the other
    strides multiples of 8, a 16-byte aligned start."""
    return (t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def check_args(q, k, v):
    """Dtype, shapes, strides and alignment the kernel takes →
    (B, Hq, Hkv, Sq, Sk, D)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, D)")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Sk, D) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, Hkv, Sk, D) = "
                         f"{(B, Hkv, Sk, D)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq = {Hq} is not a multiple of Hkv = {Hkv}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if not _layout_ok(t):
            raise ValueError(f"{name} must have a contiguous last axis, "
                             "strides that are multiples of 8 and a 16-byte "
                             "aligned start")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if B > 65535 or Hq > 65535:
        raise ValueError("B and Hq must be at most 65535")
    return B, Hq, Hkv, Sq, Sk, D


def _scale(scale, D):
    return D ** -0.5 if scale is None else scale


def flash_attention_fwd_stats(q, k, v, *, causal: bool = True, window=None,
                              softcap=None, scale=None, stats: bool = True):
    """The forward kernel → (o (B, Hq, Sq, D) bf16, lse (B, Hq, Sq) f32 or
    None). o is the same with lse asked for or not."""
    B, Hq, Hkv, Sq, Sk, D = check_args(q, k, v)
    check_cuda(q, k, v)
    fn = _fn()
    out = torch.empty_like(q)      # q's stride order, or contiguous
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if stats else None)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), B, Hq, Hkv, Sq, Sk, D,
             strides, _scale(scale, D), int(causal), int(window or 0),
             float(softcap or 0.0), stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out, lse


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = True,
                             window=None, softcap=None, scale=None):
    """The backward kernel → (dq, dk, dv) bf16 in q's, k's and v's stride
    order, from the forward's o and lse and the gradient do of o."""
    B, Hq, Hkv, Sq, Sk, D = check_args(q, k, v)
    check_cuda(q, k, v, o, lse, do)
    for name, t in (("o", o), ("do", do)):
        if t.dtype != torch.bfloat16 or t.shape != q.shape:
            raise ValueError(f"{name} must be bfloat16 of q's shape "
                             f"{tuple(q.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, Hq, Sq)
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 {(B, Hq, Sq)}")
    # o comes from the forward kernel; do is whatever autograd hands back.
    if not _layout_ok(o):
        raise ValueError("o must have the forward kernel's layout")
    if not _layout_ok(do):
        do = do.contiguous()
    fn = _bwd_fn()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # Each row's lse * log2 e and delta, rows padded to the dQ block.
    sqp = -(-Sq // BWD_QROWS) * BWD_QROWS
    stat = torch.empty((B, Hq, 2, sqp), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(s for t in (q, k, v, o, do, dq, dk,
                                                     dv)
                                         for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), stat.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, Sq, Sk, D, strides,
             _scale(scale, D), int(causal), int(window or 0),
             float(softcap or 0.0), stream)
    if err:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err}")
    flash_attention_backward.launches += 1
    return dq, dk, dv


class Attention(torch.autograd.Function):
    """o = attention(q, k, v), differentiable. ``fwd(q, k, v, **kw) → (o,
    lse)`` and ``bwd(q, k, v, o, lse, do, **kw) → (dq, dk, dv)``: the CUDA
    kernels, or their plain twins for CPU tensors (``kernels.ops``
    chooses). The backward keeps q, k, v, o and lse: no (Sq, Sk) matrix."""

    @staticmethod
    def forward(ctx, q, k, v, kw, fwd, bwd):
        o, lse = fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw, ctx.bwd = kw, bwd
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, o, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None


def needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), bf16 → (B, Hq, Sq, D) bf16,
    on the card; differentiable through ``Attention``."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if needs_grad(q, k, v):
        return Attention.apply(q, k, v, kw, flash_attention_fwd_stats,
                               flash_attention_backward)
    return flash_attention_fwd_stats(q, k, v, stats=False, **kw)[0]


flash_attention.launches = 0
flash_attention_backward.launches = 0
