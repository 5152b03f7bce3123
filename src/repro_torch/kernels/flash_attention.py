"""CUDA wrapper of ``csrc/flash_attention.cu``: the attention forward.

Counterpart of ``repro.kernels.flash_attention.flash_attention``; the plain
version is ``kernels.ref.flash_attention`` and ``kernels.ops`` chooses
between them by device. This wrapper takes bf16 CUDA tensors only. The
inputs may be strided views, e.g. the model's (B, S, H, D) activations
seen as (B, H, S, D): the kernel reads them through their strides, and the
output keeps q's stride order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_cuda

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
HEAD_DIMS = (128, 256)
# Keys per tile by head_dim and query rows per consumer warpgroup, as
# csrc/flash_attention.cu sets them (Tile<D>, WG_ROWS): the tests and
# chip_smoke.py place their edge cases with them.
TILE_N = {128: 128, 256: 80}
WARPGROUP_ROWS = 64


def _fn():
    fn = _build.load("flash_attention").flash_attention_bf16
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _F, _I, _I,
                   _F, _P]
    fn.restype = ctypes.c_int
    return fn


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
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or (
                t.data_ptr() % 16):
            raise ValueError(f"{name} must have a contiguous last axis, "
                             "strides that are multiples of 8 and a 16-byte "
                             "aligned start")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if B > 65535 or Hq > 65535:
        raise ValueError("B and Hq must be at most 65535")
    if any(t.requires_grad for t in (q, k, v)) and torch.is_grad_enabled():
        raise NotImplementedError("flash_attention has no backward kernel "
                                  "yet")
    return B, Hq, Hkv, Sq, Sk, D


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), bf16 → (B, Hq, Sq, D) bf16,
    on the card."""
    B, Hq, Hkv, Sq, Sk, D = check_args(q, k, v)
    check_cuda(q, k, v)
    fn = _fn()
    out = torch.empty_like(q)      # q's stride order, or contiguous
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
             Hkv, Sq, Sk, D, strides, D ** -0.5 if scale is None else scale,
             int(causal), int(window or 0), float(softcap or 0.0), stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
