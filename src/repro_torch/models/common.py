"""Model numerics shared by the LM blocks (counterpart of
``repro.models.common``): RMSNorm, RoPE, softcap and GELU.

The reference's ``param`` / ``split`` / ``stack_layers`` machinery is
replaced by the port's own parameters (``nn.Module``s); the numerics are
the same: reductions in float32, results cast back to the input type.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x · rsqrt(mean(x²) + eps) · (1 + gamma), in f32, cast back."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, D_head); positions: (..., S), which
    broadcast against x's leading axes. The halves rotate as in the
    reference: [x1·cos − x2·sin, x2·cos + x1·sin]."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")
