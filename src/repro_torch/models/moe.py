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
Pallas kernel is on this path. The chunks of a call run in batches of
at most ``GROUP_BYTES`` of slots and tokens (``CKPT_GROUP_BYTES``, each
batch under a checkpoint, where gradients are recorded). A sharded call
(``DTensor`` activations) routes each rank's own tokens and moves rows
between ranks with collectives (``_Layout``).
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
    """The logical axes of an FFN block's parameters, as the reference's
    ``init_dense_ffn`` and ``init_moe_ffn`` give them."""
    if isinstance(p, MoEFFN):
        return moe_axes(p)
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
    names. ``shard_experts`` is the config's layout choice (``MoEConfig``),
    kept for the parameters' axes."""

    def __init__(self, router, w_gate, w_in, w_out, shared=None,
                 shard_experts: bool = True):
        super().__init__()
        for name, w in (("router", router), ("w_gate", w_gate),
                        ("w_in", w_in), ("w_out", w_out)):
            setattr(self, name, nn.Parameter(w, requires_grad=False))
        self.shared = shared
        self.shard_experts = shard_experts


def expert_axes(shard_experts: bool) -> tuple[str | None, str | None]:
    """(the experts' axis, their FFN width's axis): the experts split over
    ``expert`` (EP, deepseek), or every card keeps every expert and their
    width splits over ``expert_mlp`` (granite)."""
    return ("expert", None) if shard_experts else (None, "expert_mlp")


def moe_axes(p: MoEFFN) -> dict:
    """The logical axes of an ``MoEFFN``'s parameters (the reference's
    ``init_moe_ffn``'s)."""
    e_ax, f_ax = expert_axes(p.shard_experts)
    axes = {"router": ("embed_fsdp", None),
            "w_gate": (e_ax, "embed_fsdp", f_ax),
            "w_in": (e_ax, "embed_fsdp", f_ax),
            "w_out": (e_ax, f_ax, "embed_fsdp")}
    if p.shared is not None:
        axes["shared"] = dense_axes(p.shared.w_gate is not None)
    return axes


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
                  if m.n_shared else None, m.shard_experts)


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


def _gates(router, xs, K: int, idx=None):
    """The router on tokens xs (..., D): softmax of the f32 logits, the
    top-K by ``lax.top_k``'s rule (or the given ``idx``), the K gates over
    max(their sum, 1e-9). → (probs, idx, gate)."""
    probs = torch.softmax(xs.float() @ router.float(), dim=-1)
    if idx is None:
        _, idx = cm.top_k(probs.detach(), K)
    gate = probs.gather(-1, idx)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, idx, gate


def _places(bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """bins (G, n, K), each in 0..n_bins-1 → (G, n, K): how many entries
    of the same chunk before each one, in token-major order, fell in the
    same bin (an assignment's place in its expert's queue)."""
    G = bins.shape[0]
    base = torch.arange(G, device=bins.device)[:, None, None] * n_bins
    key = (base + bins).view(-1)
    order = torch.argsort(key, stable=True)   # by bin, then token-major
    counts = _counts(key, G * n_bins)
    first = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(key)
    pos[order] = torch.arange(key.numel(), device=key.device) - first[
        key[order]]
    return pos.view(bins.shape)


def _aux(idx, probs_sum, n: int, E: int):
    """The Switch load-balance loss of G chunks of n tokens: E · Σ_e
    (share of top-1 picks)_e · (mean probability)_e, from the chunks'
    experts idx (G, n, K) and their probabilities' sums (G, E). → (G,)."""
    G = idx.shape[0]
    base = torch.arange(G, device=idx.device)[:, None] * E
    frac = _counts((base + idx[..., 0]).reshape(-1), G * E).view(
        G, E).float() / n
    return E * torch.sum(frac * (probs_sum / n), -1)


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
    n, E = xs.shape[1], m.n_experts
    probs, idx, gate = _gates(p.router, xs, m.top_k, idx)
    pos = _places(idx, E)
    C = capacity(n, m)
    r = Routing(probs, idx, gate, pos, pos < C, _aux(idx, probs.sum(1), n, E),
                C)
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


def _experts(xa, idx, slotted, place, wts, experts, e0: int, C: int, act):
    """The routed experts over G chunks of tokens xa (G, na, D): each
    slotted (token, k) assignment's row copied to slot ``place`` of its
    expert idx − e0 (the experts ``experts`` = (w_gate, w_in, w_out)
    hold, E_loc of them from e0, C slots each a chunk), the experts'
    products batched over (E_loc, G·C, ·), and each token's K rows (an
    unslotted one a zero row) summed with the weights ``wts`` (G, na, K)
    rounded to the compute dtype (the reference's combine.astype(dt)) by
    one batched product with f32 accumulation; with fewer than K experts
    here, only a token's min(K, E_loc) possible rows. An expert's slots of
    every chunk form one batch row of its products: slot (e·G + g)·C +
    place. → (G, na, D)."""
    w_gate, w_in, w_out = experts
    G, na, K = idx.shape
    D, dt, dev = xa.shape[-1], xa.dtype, xa.device
    N, A = w_gate.shape[0] * G * C, G * na * K   # slots, assignments
    chunk = torch.arange(G, device=dev)[:, None, None]
    e = idx - e0 if e0 else idx
    # The slot of each slotted assignment (N: none), and the assignment
    # that fills each slot (A: none).
    slot = torch.where(slotted, (e * G + chunk) * C + place, N).view(-1)
    fill = torch.full((N + 1,), A, dtype=torch.long, device=dev)
    fill[slot] = torch.arange(A, device=dev)
    fill = fill[:N]
    # Dispatch: each slot takes its token's row (an empty one a zero row).
    expert_in = _Gather.apply(xa.reshape(G * na, D),
                              torch.where(fill < A, fill // K, G * na),
                              slot.view(G * na, K)).view(-1, G * C, D)
    g = torch.bmm(expert_in, w_gate.to(dt))
    h = _act(g, act) * torch.bmm(expert_in, w_in.to(dt))
    out_e = torch.bmm(h, w_out.to(dt)).view(N, D)
    # Combine: each token's K rows times its weights, one batched product.
    R = min(K, w_gate.shape[0])
    if R == K:
        rows = _Gather.apply(out_e, slot, fill.view(N, 1)).view(G * na, K, D)
        return torch.bmm(wts.to(dt).view(G * na, 1, K), rows).view(G, na, D)
    # Fewer experts here than K (EP): a token has at most R of its slots
    # here, so its slotted assignments are packed, in k order, into R
    # columns (K: none) and only those rows are gathered.
    tok = torch.arange(G * na, device=dev)[:, None]
    sl = slotted.view(G * na, K)
    col = torch.where(sl, torch.cumsum(sl, -1) - 1, R)
    pick = torch.full((G * na, R + 1), K, dtype=torch.long, device=dev)
    pick[tok, col] = torch.arange(K, device=dev).expand(G * na, K)
    pick = pick[:, :R]
    slot_r = torch.cat([slot.view(G * na, K), slot.new_full((G * na, 1), N)],
                       1).gather(1, pick).view(-1)
    fill_r = torch.full((N + 1,), G * na * R, dtype=torch.long, device=dev)
    fill_r[slot_r] = torch.arange(G * na * R, device=dev)
    rows = _Gather.apply(out_e, slot_r, fill_r[:N].view(N, 1)).view(
        G * na, R, D)
    w_r = torch.cat([wts.reshape(G * na, K), wts.new_zeros((G * na, 1))],
                    1).gather(1, pick)
    return torch.bmm(w_r.to(dt).view(G * na, 1, R), rows).view(G, na, D)


def _dispatch(xs, p, cfg: FFNConfig, lay=None):
    """G dispatch chunks at once. xs (G, n, D) → (out (G, n, D), aux
    (G,)); sharded (``lay``: a ``_Layout``), this rank's tokens of each
    chunk (G, n_local, D) and its weights (``_Layout.weights``)."""
    m = cfg.moe
    if lay is not None:
        return lay.dispatch(xs, p, cfg)
    r = route(p, cfg, xs)
    out = _experts(xs, r.idx, r.keep, r.pos, torch.where(r.keep, r.gate, 0.0),
                   (p.w_gate, p.w_in, p.w_out), 0, r.C, cfg.act)
    if m.n_shared:
        out = out + dense_ffn(p.shared, shared_cfg(cfg), xs)
    return out, r.aux


def chunk_len(B: int, S: int, m: MoEConfig) -> int:
    """sc = max(1, min(S, ⌈chunk / B⌉)): the positions of every batch row a
    dispatch chunk holds."""
    return max(1, min(S, -(-m.chunk // B)))


def chunks(x, m: MoEConfig) -> torch.Tensor:
    """The reference's dispatch chunks of x (B, S, D) → (G, B · sc, D): a
    slice of sc (``chunk_len``) positions of every batch row, S
    zero-padded to a multiple of sc, chunk c holding positions [c·sc,
    (c+1)·sc) flattened b-major."""
    B, S, D = x.shape
    sc = chunk_len(B, S, m)
    pad = -S % sc
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    G = (S + pad) // sc
    return x.view(B, G, sc, D).transpose(0, 1).reshape(G, B * sc, D)


# Bytes of the slots, their products and the tokens of the chunks that one
# call dispatches at once (``chunks_at_once``): without gradients, and
# under one checkpoint, whose recompute keeps them for the backward.
GROUP_BYTES = 20 << 30
CKPT_GROUP_BYTES = 4 << 30


def chunks_at_once(na: int, E: int, C: int, K: int, D: int, Fd: int,
                   itemsize: int, budget: int) -> int:
    """How many chunks a call dispatches in one batch: as many as keep
    their slots (E · C rows of 2·D + 3·F values), their na tokens' rows in
    and out and the combine's K rows a token (min(K, E) with E experts
    here) under ``budget`` bytes."""
    per = itemsize * (E * C * (2 * D + 3 * Fd) + na * D * (2 + K))
    return max(1, budget // per)


def moe_ffn(p, cfg: FFNConfig, x):
    """x (B, S, D) → ((B, S, D), aux ()) over the reference's chunks
    (``chunks``); aux the mean of the chunks'. The chunks run in batches
    of ``chunks_at_once`` (the same function as one at a time: the
    reference scans them one by one); where a gradient is recorded (x or a
    weight requires one) in smaller batches, each under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` body),
    so that its dispatch is recomputed in the backward rather than kept.
    A ``DTensor`` x runs sharded (``_Layout``): each rank routes its own
    tokens, the experts run where their weights lie, and the result is
    the unsharded one's."""
    from torch.distributed.tensor import DTensor
    m = cfg.moe
    B, S, D = x.shape
    lay = _Layout(x, p, cfg) if isinstance(x, DTensor) else None
    if lay is None:
        xs, w = chunks(x, m), p
        n, E_loc, Fd = xs.shape[1], m.n_experts, m.d_ff_expert
        na, C = n, capacity(n, m)
    else:
        xs, w = lay.to_chunks(x), lay.weights(p, m)
        na, E_loc, C, Fd = lay.na, lay.E_loc, lay.C_loc, lay.F_loc
    G = xs.shape[0]
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (
        x, p.router, p.w_gate, p.w_in, p.w_out))
    step = chunks_at_once(na, E_loc, C, min(m.top_k, E_loc), D, Fd,
                          xs.element_size(),
                          CKPT_GROUP_BYTES if grad else GROUP_BYTES)
    if grad:
        parts = [ckpt.checkpoint(_dispatch, xs[g:g + step], w, cfg, lay,
                                 use_reentrant=False)
                 for g in range(0, G, step)]
    else:
        parts = [_dispatch(xs[g:g + step], w, cfg, lay)
                 for g in range(0, G, step)]
    out, aux = (torch.cat(t) if len(t) > 1 else t[0] for t in zip(*parts))
    if lay is not None:
        return lay.from_chunks(out), lay.replicated(aux.mean())
    out = out.view(G, B, -1, D).transpose(0, 1).reshape(B, -1, D)
    return out[:, :S], aux.mean()


class _Layout:
    """Where a sharded MoE call's tokens and experts lie, and the moves
    between them: the counterpart of the reference's GSPMD layouts.

    The chunks (G, B, sc, D) lie as the reference constrains them, over
    (None, "batch", "act_seq", None): the token axes split over the mesh
    dimensions ``T``. The experts' weights lie as their use-site pins say:
    over ``expert`` (deepseek: E_loc of them on each card, from e0) or
    with their width over ``expert_mlp`` (granite), split over the
    dimensions ``Wd``. Each chunk's token-major places depend on every
    token before, so each rank routes its own tokens, all-gathers the
    chunk's experts (integers) over ``T`` and places every assignment as
    the unsharded port does: the same experts, gates, places and drops.
    The tokens travel over ``A`` = T ∩ Wd, the dimensions where the
    weights they need lie elsewhere: each rank gathers its chunks' rows
    over ``A`` (every shape fixed by the config; a split read from the
    routing would need the host and breaks the fake run), runs its own
    experts on the assignments it holds, and the partial sums go back by
    a reduce-scatter over ``A`` (an all-reduce over Wd outside T, where the
    tokens are replicated). The routed experts' weights are never
    gathered. Gradients take the same moves back (``to_local``'s
    ``grad_placements``: Partial where a rank holds only a part)."""

    def __init__(self, x, p, cfg: FFNConfig):
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset as local_block
        m = cfg.moe
        self.mesh = mesh = x.device_mesh
        B, S, D = x.shape
        self.sc = sc = chunk_len(B, S, m)
        self.pad = -S % sc
        self.G = G = (S + self.pad) // sc
        self.S, self.n = S, B * sc
        self.shape = (G, B, sc, D)
        # The chunks' layout: the batch axes split B, act_seq splits sc.
        self.tok = sharding.sharding(None, "batch", "act_seq", None,
                                     shape=self.shape)
        self.T = {i for i, q in enumerate(self.tok) if isinstance(q, Shard)}
        _, self.Bl, self.scl, _ = local_block(self.shape, mesh, self.tok)[0]
        # The experts at their use site (``pin_weight``: the FSDP axis
        # gathered), and the dimensions their experts or width split over.
        e_ax, f_ax = expert_axes(m.shard_experts)
        E, Fd = m.n_experts, m.d_ff_expert
        self.w_pl = sharding.sharding(e_ax, None, f_ax, shape=(E, D, Fd))
        self.Wd = {i for i, q in enumerate(self.w_pl) if isinstance(q, Shard)}
        (self.E_loc, _, self.F_loc), (self.e0, _, _) = local_block(
            (E, D, Fd), mesh, self.w_pl)
        self.A = self.T & self.Wd
        # The shared expert's width splits over the mesh dimensions of
        # "mlp" that the tokens do not split (a decode step's); elsewhere
        # it is gathered whole once a call and runs on each rank's tokens
        # (the reference's (moe_tokens, mlp) layout, mlp deduplicated).
        Fs = Fd * m.n_shared
        self.shared_tp = {
            i for i, q in enumerate(sharding.sharding(None, "mlp",
                                                      shape=(D, Fs)))
            if isinstance(q, Shard) and i not in self.T} if Fs else set()
        # The block of each chunk this rank holds once the tokens have
        # travelled over A.
        self.avail = [Replicate() if i in self.A else q
                      for i, q in enumerate(self.tok)]
        (_, Ba, sca, _), (_, self.b0, self.s0, _) = local_block(
            self.shape, mesh, self.avail)
        self.Ba, self.sca, self.na = Ba, sca, Ba * sca
        C = capacity(self.n, m)
        self.C = C
        # Each token takes an expert once: na tokens fill at most na of
        # an expert's slots.
        self.C_loc = C if self.na == self.n else min(C, self.na)
        # x's layout before the chunks are cut: S stays split where the
        # ranks' blocks of S hold whole chunks (then one all-to-all lays
        # sc over the same axis), else it is gathered.
        self.x_pl = []
        for i, q in enumerate(self.tok):
            if q == Shard(1):
                self.x_pl.append(Shard(0))
            elif q == Shard(2) and not self.pad and G % mesh.size(i) == 0:
                self.x_pl.append(Shard(1))
            else:
                self.x_pl.append(Replicate())
        # The same on (B, G, sc, D): S's split is G's.
        self.view_pl = list(self.x_pl)
        self.tok_b = [Shard(0) if q == Shard(1) else q for q in self.tok]

    def _dt(self, local, placements):
        """This rank's ``local`` block as a ``DTensor`` of ``placements``
        (every split here is even)."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(local.contiguous(), self.mesh, placements,
                                  run_check=False)

    def replicated(self, t):
        """A value every rank holds whole (the aux) as a ``DTensor``, so
        that its gradient comes back a plain tensor."""
        from torch.distributed.tensor import Replicate
        return self._dt(t, [Replicate()] * self.mesh.ndim)

    def to_chunks(self, x):
        """x (B, S, D) → this rank's tokens of each chunk (G, Bl·scl, D)."""
        D = x.shape[-1]
        xl = x.redistribute(self.mesh, self.x_pl).to_local()
        if self.pad:
            xl = F.pad(xl, (0, 0, 0, self.pad))
        xl = xl.view(xl.shape[0], -1, self.sc, D)
        d = self._dt(xl, self.view_pl)
        xl = d.redistribute(self.mesh, self.tok_b).to_local()
        return xl.transpose(0, 1).reshape(self.G, -1, D)

    def from_chunks(self, out):
        """This rank's outputs (G, Bl·scl, D) → (B, S, D) on the
        sequence-parallel residual's layout."""
        G, D = self.G, out.shape[-1]
        yl = out.view(G, self.Bl, self.scl, D).transpose(0, 1)
        d = self._dt(yl, self.tok_b)
        yl = d.redistribute(self.mesh, self.view_pl).to_local()
        yl = yl.reshape(yl.shape[0], -1, D)[:, :self.S]
        y = self._dt(yl, self.x_pl)
        return sharding.constrain(y, "batch", "act_seq", None)

    def weights(self, p: MoEFFN, m: MoEConfig):
        """This rank's weights as plain tensors: the router and the shared
        expert whole (gathered once a call), its routed experts at their
        pins. Each gradient is Partial where the rank saw a part of the
        tokens."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        from types import SimpleNamespace
        part_T = [Partial() if i in self.T else Replicate()
                  for i in range(self.mesh.ndim)]

        def whole(w):
            w = sharding.constrain(w, *(None,) * w.dim())
            return w.to_local(grad_placements=part_T)

        def shared_w(w, f_dim):
            # Split by its width where the tokens are replicated (decode:
            # no token moves, and the rank's partial sums are reduced),
            # else whole.
            to = [Shard(f_dim) if i in self.shared_tp else Replicate()
                  for i in range(self.mesh.ndim)]
            w = w.redistribute(self.mesh, to)
            return w.to_local(grad_placements=[
                q if i in self.shared_tp else part_T[i]
                for i, q in enumerate(to)])

        def expert(w, axes):
            w = sharding.pin_weight(w, *axes)
            return w.to_local(grad_placements=[
                Partial() if i in self.T - self.Wd else q
                for i, q in enumerate(w.placements)])

        e_ax, f_ax = expert_axes(m.shard_experts)
        axes = {"w_gate": (e_ax, "embed_fsdp", f_ax),
                "w_in": (e_ax, "embed_fsdp", f_ax),
                "w_out": (e_ax, f_ax, "embed_fsdp")}
        shared = p.shared and SimpleNamespace(
            **{k: None if v is None else shared_w(v, f_dim) for k, v, f_dim in
               (("w_in", p.shared.w_in, 1), ("w_out", p.shared.w_out, 0),
                ("w_gate", p.shared.w_gate, 1))})
        return SimpleNamespace(
            router=whole(p.router),
            experts=tuple(expert(getattr(p, k), axes[k])
                          for k in ("w_gate", "w_in", "w_out")),
            shared=shared)

    def _move(self, t, to, grad=None):
        """t, this rank's (G, Bl·scl, X) block of a (G, B, sc, X) tensor
        laid out as the chunks, redistributed to placements ``to`` and
        returned as this rank's block, (G, rows, X)."""
        G, X = t.shape[0], t.shape[-1]
        d = self._dt(t.view(G, self.Bl, self.scl, X), self.tok)
        out = d.redistribute(self.mesh, to).to_local(grad_placements=grad)
        return out.reshape(G, -1, X)

    def _gather(self, t, dims):
        from torch.distributed.tensor import Partial, Replicate
        to = [Replicate() if i in dims else q for i, q in enumerate(self.tok)]
        grad = [Partial() if i in self.Wd else q for i, q in enumerate(to)]
        return self._move(t, to, grad)

    def _available(self, t):
        """This rank's block (G, na, X) of a whole chunk tensor (G, n,
        X)."""
        G, X = t.shape[0], t.shape[-1]
        t = t.view(G, *self.shape[1:3], X)
        return t[:, self.b0:self.b0 + self.Ba,
                 self.s0:self.s0 + self.sca].reshape(G, self.na, X)

    def dispatch(self, xs, w, cfg: FFNConfig):
        """The routed experts of this rank's tokens xs (G, n_local, D) →
        (its outputs (G, n_local, D), aux (G,))."""
        from torch.distributed.tensor import Partial, Replicate
        m = cfg.moe
        E, K, G = m.n_experts, m.top_k, xs.shape[0]
        probs, idx, gate = _gates(w.router, xs, K)
        # The chunk's experts, whole on every rank: the places, the drops
        # and the aux's shares.
        idx = self._move(idx, [Replicate()] * self.mesh.ndim)
        pos = _places(idx, E)
        aux = _aux(idx, self._sum(probs.sum(1), self.T), self.n, E)
        xa, gate = self._gather(xs, self.A), self._gather(gate, self.A)
        idx, pos = self._available(idx), self._available(pos)
        keep = pos < self.C
        slotted, C = keep, self.C_loc
        if self.na != self.n or self.E_loc != E:
            slotted = keep & (idx >= self.e0) & (idx < self.e0 + self.E_loc)
            pos = _places(torch.where(slotted, idx - self.e0, self.E_loc),
                          self.E_loc + 1)
        out = _experts(xa, idx, slotted, pos, torch.where(keep, gate, 0.0),
                       w.experts, self.e0, C, cfg.act)
        # Each rank's partial sums of its experts, back to the tokens'
        # ranks.
        part = [Partial() if i in self.Wd else q
                for i, q in enumerate(self.tok)]
        D = out.shape[-1]
        d = self._dt(out.view(G, self.Ba, self.sca, D), part)
        out = d.redistribute(self.mesh, self.tok).to_local().reshape(G, -1, D)
        if m.n_shared:
            out = out + self._sum(dense_ffn(w.shared, shared_cfg(cfg), xs),
                                  self.shared_tp)
        return out, aux

    def _sum(self, t, dims):
        """The sum over the ranks along mesh dimensions ``dims`` of each
        rank's ``t`` (an all-reduce; t itself with no dims)."""
        from torch.distributed.tensor import Partial, Replicate
        if not dims:
            return t
        d = self._dt(t, [Partial() if i in dims else Replicate()
                         for i in range(self.mesh.ndim)])
        return d.redistribute(self.mesh,
                              [Replicate()] * self.mesh.ndim).to_local()


def init_ffn(cfg: FFNConfig, gen, device, dtype):
    if cfg.moe:
        return init_moe_ffn(cfg, gen, device, dtype)
    return init_dense_ffn(cfg, gen, device, dtype)


def ffn(p, cfg: FFNConfig, x):
    """Unified FFN: returns (out, aux_loss); a dense FFN's aux is 0."""
    if cfg.moe:
        return moe_ffn(p, cfg, x)
    return dense_ffn(p, cfg, x), 0.0
