"""Gradient compression: per-tensor int8 quantization with error feedback
(counterpart of ``repro.train.compression``).

``compress_decompress`` runs the wire format end to end (quantize →
dequantize), so the numbers are what a compressed all-reduce would
deliver; the quantization residual stays in the state and is added back
the next step. ``torch.round`` rounds half to even, as ``jnp.round`` does,
so the int8 codes are bit-equal to the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.train import tree


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8. Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compress_decompress(grads, err_fb):
    """int8 round trip with error feedback.

    Returns (decompressed_grads, new_err_fb); both trees mirror ``grads``.
    """
    def one(g, e):
        g32 = g.float() + e
        deq = dequantize_int8(*quantize_int8(g32))
        return deq, g32 - deq

    out = [one(g, e) for g, e in zip(tree.leaves(grads), tree.leaves(err_fb))]
    return (tree.unflatten(grads, [o[0] for o in out]),
            tree.unflatten(grads, [o[1] for o in out]))
