"""CUDA wrapper of ``csrc/neigh_agg.cu``: the fused edge softmax and
neighbourhood aggregation on the padded-degree layout.

Counterpart of ``repro.kernels.neigh_agg.neigh_softmax_agg``; the plain
version is ``kernels.ref.neigh_softmax_agg`` and ``kernels.ops`` chooses
between them by device. This wrapper takes CUDA tensors only: f32 logits
and features and a bool mask (the TPU wrapper's int32 cast was for VMEM).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check, check_cuda

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = _build.load("neigh_agg").neigh_softmax_agg
    fn.argtypes = [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def check_args(logits, feats, mask):
    """Dtype, shape and contiguity the kernel takes → (R, MAXD, D)."""
    if logits.dim() != 2 or feats.dim() != 3:
        raise ValueError("logits and feats must be (R, MAXD) and "
                         "(R, MAXD, D)")
    r, maxd = logits.shape
    d = feats.shape[-1]
    if maxd < 1:
        raise ValueError("MAXD must be at least 1")
    check("logits", logits, torch.float32, (r, maxd))
    check("feats", feats, torch.float32, (r, maxd, d))
    check("mask", mask, torch.bool, (r, maxd))
    if (logits.requires_grad or feats.requires_grad) and \
            torch.is_grad_enabled():
        raise NotImplementedError("neigh_softmax_agg has no backward kernel")
    return r, maxd, d


def neigh_softmax_agg(logits: torch.Tensor, feats: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """(R, MAXD) f32, (R, MAXD, D) f32, (R, MAXD) bool → (R, D) f32, on
    the card. Only the live slots' features are read: a non-finite value in
    a masked slot does not reach the output, where the plain version (as the
    reference) multiplies it by 0 and gives NaN."""
    r, maxd, d = check_args(logits, feats, mask)
    check_cuda(logits, feats, mask)
    fn = _fn()
    out = torch.empty((r, d), dtype=torch.float32, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    err = fn(logits.data_ptr(), mask.data_ptr(), feats.data_ptr(),
             out.data_ptr(), r, maxd, d, stream)
    if err:
        raise RuntimeError(f"neigh_softmax_agg launch failed: CUDA error "
                           f"{err}")
    neigh_softmax_agg.launches += 1
    return out


neigh_softmax_agg.launches = 0
