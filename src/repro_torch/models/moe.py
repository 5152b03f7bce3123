"""FFN blocks (counterpart of ``repro.models.moe``): the dense half.

``dense_ffn`` is the gated (GeGLU / SwiGLU) or plain-activation MLP of the
dense LMs. ``MoEConfig`` is kept as a type so configurations carry over,
but the chunked MoE dispatch is not ported yet: an MoE FFN raises.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common as cm


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    chunk: int = 4096
    shard_experts: bool = True


@dataclasses.dataclass(frozen=True)
class FFNConfig:
    d_model: int
    d_ff: int
    gated: bool = True          # SwiGLU/GeGLU vs plain GELU
    act: str = "silu"
    moe: MoEConfig | None = None


def _act(x, kind):
    return F.silu(x) if kind == "silu" else cm.gelu(x)


class DenseFFN(nn.Module):
    """``w_in`` (D, F), ``w_out`` (F, D) and, when gated, ``w_gate``
    (D, F): the reference's layouts and names."""

    def __init__(self, w_in, w_out, w_gate=None):
        super().__init__()
        self.w_in = nn.Parameter(w_in, requires_grad=False)
        self.w_out = nn.Parameter(w_out, requires_grad=False)
        self.w_gate = (None if w_gate is None
                       else nn.Parameter(w_gate, requires_grad=False))


def normal_(shape, gen, device, dtype, scale=None):
    """normal × scale (default 1/√shape[0], the reference's ``param``
    init), drawn in place on ``device``."""
    if scale is None:
        scale = 1.0 / math.sqrt(max(shape[0], 1))
    return torch.empty(shape, dtype=dtype, device=device).normal_(
        generator=gen).mul_(scale)


def init_dense_ffn(cfg: FFNConfig, gen, device, dtype) -> DenseFFN:
    D, Fd = cfg.d_model, cfg.d_ff
    return DenseFFN(normal_((D, Fd), gen, device, dtype),
                    normal_((Fd, D), gen, device, dtype),
                    normal_((D, Fd), gen, device, dtype) if cfg.gated
                    else None)


def dense_ffn(p: DenseFFN, cfg: FFNConfig, x):
    dt = x.dtype
    h = x @ p.w_in.to(dt)
    if cfg.gated:
        h = _act(x @ p.w_gate.to(dt), cfg.act) * h
    else:
        h = _act(h, cfg.act)
    return h @ p.w_out.to(dt)


def init_ffn(cfg: FFNConfig, gen, device, dtype):
    if cfg.moe:
        raise NotImplementedError("MoE FFNs are not ported yet")
    return init_dense_ffn(cfg, gen, device, dtype)


def ffn(p, cfg: FFNConfig, x):
    """Unified FFN: returns (out, aux_loss); a dense FFN's aux is 0."""
    if cfg.moe:
        raise NotImplementedError("MoE FFNs are not ported yet")
    return dense_ffn(p, cfg, x), 0.0
