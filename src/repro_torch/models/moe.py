"""FFN blocks (counterpart of ``repro.models.moe``): dense (GELU / gated)
and the chunked GShard-style MoE.

``dense_ffn`` is the gated (GeGLU / SwiGLU) or plain-activation MLP.
``moe_ffn`` is the reference's capacity-factor MoE over token chunks:
softmax top-k routing (``lax.top_k``'s tie rule, ``common.top_k``) with
renormalised gates, the Switch load-balance aux, each expert's slots
filled in token-major assignment order up to the capacity C, an optional
shared expert (deepseek). The reference moves tokens with one-hot
(n, E, C) dispatch and combine einsums; here the same function is two
gathers: each kept (token, k) row is copied to its slot of its expert
(kept slots are unique, so the copy is exact), and each token sums its
kept experts' outputs times the gates rounded to the compute dtype (one
batched product, f32 accumulation). No (n, E, C) tensor is built, no
float scatter-add runs in the forward or the backward (each gather's
gradient is the inverse gather, ``_Gather``; the counts per expert are
integers), and the host waits on the card nowhere: the result is the
same on every run and the host runs ahead. The experts' products are
batched matmuls over (E, C, ·), as the reference's einsums are: no
Pallas kernel is on this path. Without gradients every chunk of a call
runs in one batch; with them, one chunk at a time under a checkpoint.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import sharding
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


def dense_axes(gated: bool) -> dict:
    """The logical axes of a ``DenseFFN``'s parameters, as the reference's
    ``init_dense_ffn`` gives them."""
    axes = {"w_in": ("embed_fsdp", "mlp"), "w_out": ("mlp", "embed_fsdp")}
    if gated:
        axes["w_gate"] = ("embed_fsdp", "mlp")
    return axes


def param_axes(p) -> dict:
    """The logical axes of an FFN block's parameters. Dense only: the MoE's
    (``expert``, ``expert_mlp``) come with its sharded slice."""
    if isinstance(p, MoEFFN):
        raise NotImplementedError("the MoE's parameter axes are not ported "
                                  "yet")
    return dense_axes(p.w_gate is not None)


def dense_ffn(p: DenseFFN, cfg: FFNConfig, x):
    """The MLP. Under installed rules the weights are pinned where they are
    used (the reference's use-site FSDP pins) and the hidden activation is
    laid out over ``mlp``: over ``moe_tokens`` for a 2-D input (the MoE's
    shared expert), over ``batch`` for the layer's (B, S, F)."""
    dt = x.dtype
    c, pin = sharding.constrain, sharding.pin_weight
    lead = (("moe_tokens",) if x.dim() == 2
            else ("batch",) + (None,) * (x.dim() - 2))
    # The sequence-parallel residual is gathered before the MLP (the
    # reference leaves this to GSPMD, around the sharded h below).
    x = c(x, *lead, None)
    h = x @ pin(p.w_in, "embed_fsdp", "mlp").to(dt)
    if cfg.gated:
        h = _act(x @ pin(p.w_gate, "embed_fsdp", "mlp").to(dt), cfg.act) * h
    else:
        h = _act(h, cfg.act)
    h = c(h, *lead, "mlp")
    out = h @ pin(p.w_out, "mlp", "embed_fsdp").to(dt)
    # Scattered back onto the sequence-parallel residual, as attention's.
    return out if out.dim() == 2 else c(out, "batch", "act_seq",
                                        *(None,) * (out.dim() - 2))


# ------------------------------------------------------------------ MoE

class MoEFFN(nn.Module):
    """``router`` (D, E) float32, ``w_gate`` and ``w_in`` (E, D, F),
    ``w_out`` (E, F, D) and, with shared experts, ``shared`` (a
    ``DenseFFN`` of width F · n_shared): the reference's layouts and
    names."""

    def __init__(self, router, w_gate, w_in, w_out, shared=None):
        super().__init__()
        for name, w in (("router", router), ("w_gate", w_gate),
                        ("w_in", w_in), ("w_out", w_out)):
            setattr(self, name, nn.Parameter(w, requires_grad=False))
        self.shared = shared


def shared_cfg(cfg: FFNConfig) -> FFNConfig:
    m = cfg.moe
    return dataclasses.replace(cfg, d_ff=m.d_ff_expert * m.n_shared)


def init_moe_ffn(cfg: FFNConfig, gen, device, dtype) -> MoEFFN:
    """The reference's draws: normal × 1/√shape[0], so the experts'
    (E, ·, ·) weights are scaled by 1/√E; the router in float32."""
    m = cfg.moe
    D, Fd, E = cfg.d_model, m.d_ff_expert, m.n_experts
    return MoEFFN(normal_((D, E), gen, device, torch.float32),
                  normal_((E, D, Fd), gen, device, dtype),
                  normal_((E, D, Fd), gen, device, dtype),
                  normal_((E, Fd, D), gen, device, dtype),
                  init_dense_ffn(shared_cfg(cfg), gen, device, dtype)
                  if m.n_shared else None)


def capacity(n: int, m: MoEConfig) -> int:
    """Slots an expert of a chunk of n tokens: n (dropless) up to 1024
    tokens, else ⌊n · K · capacity_factor⌋ // E, at least 1."""
    if n <= 1024:
        return n
    return max(int(n * m.top_k * m.capacity_factor) // m.n_experts, 1)


@dataclasses.dataclass
class Routing:
    """Routing of G chunks of n tokens: ``probs`` (G, n, E) f32, ``idx``
    (G, n, K) the experts in ``lax.top_k`` order, ``gate`` (G, n, K)
    renormalised, ``pos`` (G, n, K) the place in the expert's queue of
    its chunk, ``keep`` = pos < C, ``aux`` (G,) the load-balance loss,
    ``C`` the capacity. ``route`` of one chunk (n, D) drops the G axis."""
    probs: torch.Tensor
    idx: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor
    C: int


def _counts(bins: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of 0..n-1 occurs in ``bins``; unlike bincount, the
    host does not wait for the card to size the result."""
    return bins.new_zeros(n).scatter_add_(0, bins, torch.ones_like(bins))


def route(p, cfg: FFNConfig, xs, idx=None) -> Routing:
    """Router of G chunks xs (G, n, D), or of one chunk (n, D): softmax
    of the f32 logits, top-K by ``lax.top_k``'s rule, gates over
    max(sum, 1e-9), aux = E · Σ_e (share of top-1 picks)_e ·
    mean(probs)_e, and each assignment's place in its expert: how many
    assignments of its chunk before it, token-major, went to the same
    expert. ``idx`` takes given experts in place of the top-K (to hold
    two computations to one routing)."""
    one = xs.dim() == 2
    if one:
        xs, idx = xs[None], None if idx is None else idx[None]
    m = cfg.moe
    G, n, _ = xs.shape
    E, K = m.n_experts, m.top_k
    probs = torch.softmax(xs.float() @ p.router.float(), dim=-1)
    if idx is None:
        _, idx = cm.top_k(probs.detach(), K)
    gate = probs.gather(-1, idx)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # Bins g·E + e: each chunk's experts apart.
    base = torch.arange(G, device=xs.device)[:, None, None] * E
    frac = _counts((base[..., 0] + idx[..., 0]).view(-1), G * E).view(
        G, E).float() / n
    aux = E * torch.sum(frac * probs.mean(1), -1)
    key = (base + idx).view(-1)
    order = torch.argsort(key, stable=True)   # by bin, then token-major
    counts = _counts(key, G * E)
    first = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(key)
    pos[order] = torch.arange(key.numel(), device=key.device) - first[
        key[order]]
    pos = pos.view(G, n, K)
    C = capacity(n, m)
    r = Routing(probs, idx, gate, pos, pos < C, aux, C)
    if one:
        r = Routing(*(getattr(r, f.name)[0]
                      for f in dataclasses.fields(Routing)[:6]), C)
    return r


class _Gather(torch.autograd.Function):
    """y = x[idx], idx pointing at rows of x or at len(x), a zero row;
    the backward is a gather too: dx[i] = Σ_j dy[inv[i, j]], inv
    (len(x), r) pointing at rows of dy or at len(dy), a zero row. The
    MoE's routing is a partial one-to-one map between (token, k) pairs
    and slots, so each side's rows are the other's inverse gather: no
    scatter-add, in the forward or the backward."""

    @staticmethod
    def forward(ctx, x, idx, inv):
        ctx.save_for_backward(inv)
        return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])[idx]

    @staticmethod
    def backward(ctx, dy):
        inv, = ctx.saved_tensors
        dx = torch.cat([dy, dy.new_zeros((1,) + dy.shape[1:])])[inv]
        return dx.sum(1), None, None


def _dispatch(xs, p, cfg: FFNConfig):
    """G dispatch chunks at once. xs (G, n, D) → (out (G, n, D), aux
    (G,)). An expert's slots of every chunk form one batch row of its
    products: slot (e·G + g)·C + pos."""
    m = cfg.moe
    G, n, D = xs.shape
    E, K = m.n_experts, m.top_k
    r = route(p, cfg, xs)
    C, dt, dev = r.C, xs.dtype, xs.device
    N, A = E * G * C, G * n * K          # slots, (token, k) assignments
    chunk = torch.arange(G, device=dev)[:, None, None]
    # The slot of each kept assignment (N: dropped), and the assignment
    # that fills each slot (A: none).
    slot = torch.where(r.keep, (r.idx * G + chunk) * C + r.pos, N).view(-1)
    fill = torch.full((N + 1,), A, dtype=torch.long, device=dev)
    fill[slot] = torch.arange(A, device=dev)
    fill = fill[:N]
    # Dispatch: each slot takes its token's row (an empty one a zero row).
    expert_in = _Gather.apply(xs.reshape(G * n, D),
                              torch.where(fill < A, fill // K, G * n),
                              slot.view(G * n, K)).view(E, G * C, D)
    g = torch.bmm(expert_in, p.w_gate.to(dt))
    h = _act(g, cfg.act) * torch.bmm(expert_in, p.w_in.to(dt))
    out_e = torch.bmm(h, p.w_out.to(dt)).view(N, D)
    # Combine: each token's K experts' rows (a dropped one a zero row)
    # times the gates rounded to dt (the reference's combine.astype(dt)),
    # summed by one batched product with f32 accumulation.
    rows = _Gather.apply(out_e, slot, fill.view(N, 1)).view(G * n, K, D)
    w = torch.where(r.keep, r.gate, 0.0).to(dt).view(G * n, 1, K)
    out = torch.bmm(w, rows).view(G, n, D)
    if m.n_shared:
        out = out + dense_ffn(p.shared, shared_cfg(cfg), xs)
    return out, r.aux


def chunks(x, m: MoEConfig) -> torch.Tensor:
    """The reference's dispatch chunks of x (B, S, D) → (G, B · sc, D): a
    slice of sc = max(1, min(S, ⌈chunk / B⌉)) positions of every batch
    row, S zero-padded to a multiple of sc, chunk c holding positions
    [c·sc, (c+1)·sc) flattened b-major."""
    B, S, D = x.shape
    sc = max(1, min(S, -(-m.chunk // B)))
    pad = -S % sc
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    G = (S + pad) // sc
    return x.view(B, G, sc, D).transpose(0, 1).reshape(G, B * sc, D)


def moe_ffn(p, cfg: FFNConfig, x):
    """x (B, S, D) → ((B, S, D), aux ()) over the reference's chunks
    (``chunks``); aux the mean of the chunks'. Where a gradient is
    recorded each chunk runs alone under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` body); otherwise all chunks run at
    once, batched (the same function)."""
    B, S, D = x.shape
    xs = chunks(x, cfg.moe)
    G = xs.shape[0]
    if torch.is_grad_enabled():
        outs, auxs = zip(*(ckpt.checkpoint(_dispatch, xc[None], p, cfg,
                                           use_reentrant=False)
                           for xc in xs))
        out, aux = torch.cat(outs), torch.cat(auxs)
    else:
        out, aux = _dispatch(xs, p, cfg)
    out = out.view(G, B, -1, D).transpose(0, 1).reshape(B, -1, D)
    return out[:, :S], aux.mean()


def init_ffn(cfg: FFNConfig, gen, device, dtype):
    if cfg.moe:
        return init_moe_ffn(cfg, gen, device, dtype)
    return init_dense_ffn(cfg, gen, device, dtype)


def ffn(p, cfg: FFNConfig, x):
    """Unified FFN: returns (out, aux_loss); a dense FFN's aux is 0."""
    if cfg.moe:
        return moe_ffn(p, cfg, x)
    return dense_ffn(p, cfg, x), 0.0
