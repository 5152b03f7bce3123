"""Model numerics shared by the LM blocks (counterpart of
``repro.models.common``): RMSNorm, RoPE, softcap, GELU, the LM loss
(``cross_entropy``, ``chunked_cross_entropy``) and ``top_k``, the port's
one copy of ``lax.top_k``'s tie rule (the MoE router and the two-tower
serving top-k use it).

The reference's ``param`` / ``split`` / ``stack_layers`` machinery is
replaced by the port's own parameters (``nn.Module``s, or for the GNNs
nested dicts of tensors built by ``init_tree``); the numerics are the
same: reductions in float32, results cast back to the input type.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake
from torch.utils import checkpoint as ckpt

from repro_torch import sharding


def init_tree(specs: dict, generator: torch.Generator,
              device: torch.device) -> dict:
    """A nested dict of ``(shape, scale)`` or bare ``shape`` leaves → the
    same dict of float32 tensors drawn normal × scale on ``device``, the
    reference's ``param`` distribution (scale ``None`` or no scale:
    1/√shape[0])."""
    out = {}
    for k, spec in specs.items():
        if isinstance(spec, dict):
            out[k] = init_tree(spec, generator, device)
            continue
        shape, scale = spec if isinstance(spec[0], tuple) else (spec, None)
        if scale is None:
            scale = 1.0 / math.sqrt(max(shape[0], 1))
        out[k] = torch.randn(shape, generator=generator, device=device) \
            * scale
    return out


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x · rsqrt(mean(x²) + eps) · (1 + gamma), in f32 (f64 for an f64
    x), cast back."""
    dt = x.dtype
    up = torch.promote_types(dt, torch.float32)
    xf = x.to(up)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + gamma.to(up))).to(dt)


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


class _GatherLast(torch.autograd.Function):
    """``torch.gather(x, -1, idx)`` whose backward scatters into
    ``zeros_like(x)``, both run on each rank's shards for a DTensor x
    (``sharding.on_shards``; the caller keeps x's last dim whole).
    Autograd's own backward builds its zeros at x's full shape, the whole
    (global) tensor on every rank of a DTensor, and DTensor's gather may
    split the vocab into a masked partial that its later ops cannot
    reduce. The numbers are the same."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(x, idx)
        return sharding.on_shards(lambda a, i: torch.gather(a, -1, i), x, x,
                                  idx)

    @staticmethod
    def backward(ctx, grad):
        x, idx = ctx.saved_tensors
        return sharding.on_shards(
            lambda a, i, g: torch.zeros_like(a).scatter_add_(-1, i, g), x,
            x, idx, grad), None


def _nll(logits, labels, softcap_val, ignore_id: int):
    """Per-token negative log-likelihood in f32, 0 where ignored."""
    logits = softcap(logits.float(), softcap_val)
    mask = labels != ignore_id
    safe = torch.where(mask, labels, 0).long()
    # Over a vocab-sharded head the vocab is gathered first, as GSPMD
    # gathers an operand it cannot split: DTensor has no split rule for
    # the log-sum-exp, and its split gather has none for the backward.
    logits = sharding.constrain(logits, "batch",
                                *(None,) * (logits.dim() - 1))
    lse = torch.logsumexp(logits, dim=-1)
    gold = _GatherLast.apply(logits, safe[..., None])[..., 0]
    return (lse - gold) * mask


def cross_entropy(logits, labels, *, softcap_val: float | None = None,
                  ignore_id: int = -1):
    """Mean token cross-entropy in f32; labels == ignore_id are masked."""
    mask = labels != ignore_id
    return (_nll(logits, labels, softcap_val, ignore_id).sum()
            / torch.clamp(mask.sum(), min=1))


def _chunk_nll_sum(xb, head, lb, softcap_val, ignore_id: int):
    return _nll(xb @ head, lb, softcap_val, ignore_id).sum()


def chunked_cross_entropy(x, head, labels, *, softcap_val=None,
                          ignore_id: int = -1, chunk: int = 512):
    """The head's matmul and the softmax cross-entropy over sequence
    chunks. x (B, S, D), head (D, V), labels (B, S).

    Never holds the (B, S, V) logits: each chunk's logits (in x's dtype,
    then f32) are computed under ``torch.utils.checkpoint`` and computed
    again in the backward. When S is not a multiple of ``chunk`` the
    whole sequence is one chunk, as in the reference. The chunks' sums add
    in order.
    """
    B, S, _ = x.shape
    c = min(chunk, S)
    if S % c:
        c = S
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n_tok = torch.zeros((), dtype=torch.int64, device=x.device)
    for lo in range(0, S, c):
        xb, lb = x[:, lo:lo + c], labels[:, lo:lo + c]
        if torch.is_grad_enabled():
            part = ckpt.checkpoint(_chunk_nll_sum, xb, head, lb, softcap_val,
                                   ignore_id, use_reentrant=False)
        else:
            part = _chunk_nll_sum(xb, head, lb, softcap_val, ignore_id)
        nll_sum = nll_sum + part
        n_tok = n_tok + (lb != ignore_id).sum()
    return nll_sum / torch.clamp(n_tok, min=1)


# Rows up to this long are sorted whole (the MoE router's E experts).
TOP_K_SORT_MAX = 256


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: values descending, equal values
    in index order, the k-th place to the lowest index among its equals.

    A row of at most TOP_K_SORT_MAX values is sorted whole, stably: one
    call, and the host never waits on the card. A longer row goes through
    ``torch.topk``, which orders ties arbitrarily, so its pick is
    repaired: the k taken are re-sorted stably by value from index order,
    and a row whose k-th and (k+1)-th values are equal (where
    ``torch.topk`` may have taken other equal entries) is redone with a
    full stable sort; ``top_k.full_sorts`` counts the rows so redone.
    """
    n = x.shape[-1]
    if n <= TOP_K_SORT_MAX:
        vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
        return vals[..., :k], idx[..., :k]
    vals, idx = torch.topk(x, min(k + 1, n), dim=-1)
    edge = vals[..., k] == vals[..., k - 1] if n > k else None
    idx, perm = torch.sort(idx[..., :k], dim=-1)
    vals, perm = torch.sort(vals[..., :k].gather(-1, perm), dim=-1,
                            descending=True, stable=True)
    idx = idx.gather(-1, perm)
    # Fake tensors (the dry run's shards) hold no values to test: the
    # repair, which runs on tied rows only, is left out of their count.
    if edge is not None and not is_fake(x) and bool(edge.any()):
        rows = edge.nonzero(as_tuple=True)
        top_k.full_sorts += len(rows[0])
        v, i = torch.sort(x[rows], dim=-1, descending=True, stable=True)
        vals[rows], idx[rows] = v[..., :k], i[..., :k]
    return vals, idx


top_k.full_sorts = 0
