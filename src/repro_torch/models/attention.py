"""Attention blocks (counterpart of ``repro.models.attention``): GQA, with
RoPE, a per-layer sliding window and a logit softcap, and MLA (deepseek's
multi-head latent attention).

Implementations (``impl``):

* ``einsum`` — materialises the (B, H, Sq, Sk) logits; tests only.
* ``blocked_causal``, ``blocked``, ``pallas`` — the ``flash_attention``
  kernel through ``kernels.ops`` with the layer's window: the CUDA kernel
  for CUDA tensors, its plain version for CPU ones. Differentiable: the
  gradient comes from the backward kernel (or its plain twin), from the
  forward's o and lse, as the reference's ``_flash`` custom VJP does.
* ``blocked_ad``, ``blocked_causal_ad`` — the reference's ablation
  ``_attend_blocked``: a plain online-softmax recurrence over (q-chunk,
  k-chunk) pairs that autograd differentiates, each block under
  ``torch.utils.checkpoint``.

The reference's ``pallas`` branch passes ``window=None`` whatever the
layer's window; the port passes the window, as its ``blocked_causal``
does. ``prefill`` gives a layer's output and its KV cache from one
projection of k and v, where the reference's ``prefill_cache`` projects
them again beside ``forward``. Decode is a one-step product over the KV
cache, as in the reference, with the cache written in place.

MLA attends in the direct form for training and prefill: k is the
per-head ``k_nope`` from the latent ``c_kv`` beside one roped 64-wide key
shared by all heads, v is padded to q·k's width (192 at deepseek's
widths) so that one head_dim serves the whole product, the scale is that
width's ``** -0.5`` and the output is cut back to v's width. Its cache
holds only ``c_kv``, ``k_rope`` and ``pos``; decode is the reference's
absorbed form in float32 (q folded through ``w_uk``, the context through
``w_uv``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import sharding
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm
from repro_torch.models.moe import normal_

NEG_INF = -1e30
KERNEL_IMPLS = ("blocked_causal", "blocked", "pallas")
AD_IMPLS = ("blocked_ad", "blocked_causal_ad")


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10_000.0
    softcap: float | None = None
    mla: MLAConfig | None = None
    attn_chunk_q: int = 512
    attn_chunk_k: int = 1024


class GQA(nn.Module):
    """``wq`` (D, H, Dh), ``wk`` / ``wv`` (D, Hkv, Dh), ``wo`` (H, Dh, D):
    the reference's layouts and names."""

    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        for name, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
            setattr(self, name, nn.Parameter(w, requires_grad=False))


def init_gqa(cfg: AttnConfig, gen, device, dtype) -> GQA:
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    return GQA(normal_((D, H, Dh), gen, device, dtype),
               normal_((D, Hkv, Dh), gen, device, dtype),
               normal_((D, Hkv, Dh), gen, device, dtype),
               normal_((H, Dh, D), gen, device, dtype))


def gqa_axes() -> dict:
    """The logical axes of a ``GQA``'s parameters, as the reference's
    ``init_gqa`` gives them."""
    return {"wq": ("embed_fsdp", "heads", None),
            "wk": ("embed_fsdp", "kv_heads", None),
            "wv": ("embed_fsdp", "kv_heads", None),
            "wo": ("heads", None, "embed_fsdp")}


def mla_axes() -> dict:
    """The logical axes of an ``MLA``'s parameters, as the reference's
    ``init_mla`` gives them."""
    return {"w_dq": ("embed_fsdp", "q_lora"), "q_norm": ("q_lora",),
            "w_uq": ("q_lora", "heads", None),
            "w_dkv": ("embed_fsdp", "kv_lora"), "kv_norm": ("kv_lora",),
            "w_uk": ("kv_lora", "heads", None),
            "w_uv": ("kv_lora", "heads", None),
            "wo": ("heads", None, "embed_fsdp")}


def param_axes(p) -> dict:
    """The logical axes of an attention block's parameters."""
    return mla_axes() if isinstance(p, MLA) else gqa_axes()


class MLA(nn.Module):
    """``w_dq`` (D, q_lora), ``q_norm`` (q_lora,), ``w_uq`` (q_lora, H,
    nope + rope), ``w_dkv`` (D, kv_lora + rope), ``kv_norm`` (kv_lora,),
    ``w_uk`` (kv_lora, H, nope), ``w_uv`` (kv_lora, H, v), ``wo`` (H, v,
    D): the reference's layouts and names."""

    NAMES = ("w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_uk", "w_uv",
             "wo")

    def __init__(self, *weights):
        super().__init__()
        for name, w in zip(self.NAMES, weights, strict=True):
            setattr(self, name, nn.Parameter(w, requires_grad=False))


def init_mla(cfg: AttnConfig, gen, device, dtype) -> MLA:
    """The reference's ``init_mla``: normal × 1/√shape[0] (so ``w_uq`` at
    1/√q_lora and ``wo`` at 1/√H), the two norms f32 zeros."""
    m, D, H = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim

    def zeros(n):
        return torch.zeros((n,), device=device)

    return MLA(normal_((D, m.q_lora_rank), gen, device, dtype),
               zeros(m.q_lora_rank),
               normal_((m.q_lora_rank, H, qk), gen, device, dtype),
               normal_((D, m.kv_lora_rank + m.qk_rope_head_dim), gen, device,
                       dtype),
               zeros(m.kv_lora_rank),
               normal_((m.kv_lora_rank, H, m.qk_nope_head_dim), gen, device,
                       dtype),
               normal_((m.kv_lora_rank, H, m.v_head_dim), gen, device, dtype),
               normal_((H, m.v_head_dim, D), gen, device, dtype))


def init(cfg: AttnConfig, gen, device, dtype) -> GQA | MLA:
    if cfg.mla:
        return init_mla(cfg, gen, device, dtype)
    return init_gqa(cfg, gen, device, dtype)


def _band_mask(qpos, kpos, window: int):
    """Causal + sliding-window mask (Sq, Sk). window == 0 ⇒ global."""
    m = kpos[None, :] <= qpos[:, None]
    if window > 0:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def _attend_einsum(q, k, v, qpos, kpos, window, scale, cap):
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qg = (q.float() * scale).reshape(B, Sq, Hkv, g, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    s = cm.softcap(s, cap)
    s = s.masked_fill(~_band_mask(qpos, kpos, window), NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, Dh)


def _block_pairs(Sq: int, Sk: int, cq: int, ck: int,
                 causal_skip: bool) -> list[tuple[int, int]]:
    """The reference's (q-chunk, k-chunk) pairs: whole chunks only, those
    above the causal band skipped with ``causal_skip``."""
    pairs = []
    for qi in range(Sq // cq):
        for ki in range(Sk // ck):
            if causal_skip and ki * ck > (Sk - Sq) + (qi + 1) * cq - 1:
                continue
            pairs.append((qi, ki))
    return pairs


def _blocked_step(qc, kc, vc, qp, kp, acc, mx, den, *, window: int, cap,
                  g: int):
    """One block of the online softmax: (acc, mx, den) of the q chunk
    updated by one k chunk. acc (B, cq, H, Dh); mx, den (B, H, cq)."""
    B, cq, H, Dh = qc.shape
    ck = kc.shape[1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qc.reshape(B, cq, H // g, g, Dh),
                     kc.float()).reshape(B, H, cq, ck)
    s = cm.softcap(s, cap)
    mask = _band_mask(qp, kp, window)
    s = s.masked_fill(~mask, NEG_INF)
    m_new = torch.maximum(mx, s.amax(-1))
    p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
    alpha = torch.exp(mx - m_new)
    d_new = den * alpha + p.sum(-1)
    pv = torch.einsum("bhgqk,bkhd->bqhgd", p.reshape(B, H // g, g, cq, ck),
                      vc.float()).reshape(B, cq, H, Dh)
    return acc * alpha.transpose(1, 2)[..., None] + pv, m_new, d_new


def _attend_blocked(q, k, v, qpos, kpos, window: int, scale, cap,
                    chunk_q: int, chunk_k: int, causal_skip: bool):
    """The reference's ``_attend_blocked``: online softmax over the block
    pairs, differentiated by autograd, each block recomputed in the
    backward (``torch.utils.checkpoint``) instead of keeping its (B, H, cq,
    ck) residuals. Rows past the last whole q chunk stay 0, as there.
    q (B, Sq, H, Dh), k/v (B, Sk, Hkv, Dh) → (B, Sq, H, Dh) f32."""
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    qf = q.float() * scale
    dev = q.device
    acc = [torch.zeros((B, cq, H, Dh), device=dev) for _ in range(Sq // cq)]
    mx = [torch.full((B, H, cq), NEG_INF, device=dev)
          for _ in range(Sq // cq)]
    den = [torch.zeros((B, H, cq), device=dev) for _ in range(Sq // cq)]
    step = functools.partial(_blocked_step, window=window, cap=cap,
                             g=H // k.shape[2])
    for qi, ki in _block_pairs(Sq, Sk, cq, ck, causal_skip):
        qs, ks = slice(qi * cq, (qi + 1) * cq), slice(ki * ck, (ki + 1) * ck)
        args = (qf[:, qs], k[:, ks], v[:, ks], qpos[qs], kpos[ks], acc[qi],
                mx[qi], den[qi])
        if torch.is_grad_enabled():
            out = ckpt.checkpoint(step, *args, use_reentrant=False)
        else:
            out = step(*args)
        acc[qi], mx[qi], den[qi] = out
    out = torch.zeros((B, Sq, H, Dh), device=dev)
    if acc:
        a = torch.cat(acc, dim=1)
        d = torch.cat(den, dim=2).transpose(1, 2)
        out = torch.cat([a / torch.clamp(d, min=1e-30)[..., None],
                         out[:, a.shape[1]:]], dim=1)
    return out


def _attend(q, k, v, qpos, kpos, window: int, cfg: AttnConfig, impl,
            scale=None):
    """q (B, Sq, H, Dh), k/v (B, Sk, Hkv, Dh) → (B, Sq, H, Dh). The
    kernel path assumes the aligned positions of a prompt (query i at key
    Sk − Sq + i), as the reference's ``blocked_causal`` does."""
    scale = cfg.head_dim ** -0.5 if scale is None else scale
    if impl == "einsum":
        return _attend_einsum(q, k, v, qpos, kpos, window, scale,
                              cfg.softcap)
    if impl in AD_IMPLS:
        return _attend_blocked(q, k, v, qpos, kpos, window, scale,
                               cfg.softcap, cfg.attn_chunk_q,
                               cfg.attn_chunk_k, impl == "blocked_causal_ad")
    if impl not in KERNEL_IMPLS:
        raise ValueError(impl)
    out = kops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=window or None, softcap=cfg.softcap,
        scale=scale)
    # The kernel writes o in q's stride order, so this is a view of a
    # contiguous (B, S, H, D) tensor and ``contiguous`` copies nothing; a
    # plain twin's or a DTensor shard's (B, H, S, D) output is copied, so
    # that the next product can view it flat.
    return out.transpose(1, 2).contiguous()


def _weights(p: GQA, pin: bool) -> dict:
    """A ``GQA``'s weights by name; with ``pin``, under the use-site FSDP
    pins of the reference's ``_pin_gqa`` (under installed rules each layer
    gathers its own weights where it uses them: ``sharding.pin_weight``)."""
    if not pin:
        return {name: getattr(p, name) for name in gqa_axes()}
    return {name: sharding.pin_weight(getattr(p, name), *axes)
            for name, axes in gqa_axes().items()}


def _project(x, w, heads: str):
    """x (B, S, D) · w (D, H, Dh) → (B, S, H, Dh), one product over the
    flattened H·Dh columns (the same product ``einsum`` runs for
    "bsd,dhk->bshk"). A DTensor product may come out split by those
    columns; where the ``heads`` do not split over the mesh the (H, Dh)
    view cannot carry that split, so the columns are gathered first (the
    heads stay whole, as the reference's rules leave them)."""
    w2 = w.flatten(1)
    whole = sharding.active() and \
        sharding.spec(heads, shape=w.shape[1:2]) == (None,)
    if whole:
        # Also in the backward: the flattened weight's gradient is laid
        # out as the weight before it is viewed as (D, H, Dh) again.
        w2 = sharding.constrain(w2, "embed_fsdp", None)
    y = torch.einsum("bsd,dn->bsn", x, w2)
    if whole:
        y = sharding.constrain(y, "batch", "seq", None)
    return y.unflatten(-1, tuple(w.shape[1:]))


def _qkv(w: dict, cfg: AttnConfig, x, positions):
    """Roped q (B, S, H, Dh), roped k and v (B, S, Hkv, Dh) from the
    weights ``w`` (``_weights``)."""
    dt = x.dtype
    q = _project(x, w["wq"].to(dt), "heads")
    k = _project(x, w["wk"].to(dt), "kv_heads")
    v = _project(x, w["wv"].to(dt), "kv_heads")
    pos = positions[:, :, None]            # broadcast over heads
    return (cm.rope(q, pos, cfg.rope_theta), cm.rope(k, pos, cfg.rope_theta),
            v)


def _attend_gqa(w: dict, cfg: AttnConfig, x, positions, window: int, impl):
    """The forward's projections and attention → (out (B, S, D), k, v),
    q and k laid out as the reference's ``gqa_forward`` lays them."""
    # The sequence-parallel residual is gathered before the projections
    # (the reference leaves this to GSPMD).
    x = sharding.constrain(x, "batch", "seq", None)
    q, k, v = _qkv(w, cfg, x, positions)
    q = sharding.constrain(q, "batch", "seq", "heads", None)
    k = sharding.constrain(k, "batch", "seq", "kv_heads", None)
    out = _attend(q, k, v, positions[0], positions[0], window, cfg, impl)
    # Scattered back onto the sequence-parallel residual (a reduce-scatter
    # of the heads' partial sums); in the backward the residual's gradient
    # is gathered here, before the product flattens (B, S).
    out = sharding.constrain(_out(w["wo"], out, x.dtype), "batch", "act_seq",
                             None)
    return out, k, v


def _out(wo, out, dt):
    return torch.einsum("bshk,hkd->bsd", out.to(dt), wo.to(dt))


def gqa_forward(p: GQA, cfg: AttnConfig, x, positions, window: int, impl):
    """Training/prefill forward. x: (B, S, D) → (B, S, D)."""
    return _attend_gqa(_weights(p, pin=True), cfg, x, positions, window,
                       impl)[0]


def _ring_cache(arrays: dict, positions, cache_len: int) -> dict:
    """The (ring) cache of a prompt: each (B, S, ...) array of ``arrays``
    and the positions, W = ``cache_len`` slots. S ≥ W keeps the last W,
    rolled so that position p lives at slot p % W (decode writes at step
    % W); S < W pads with zeros and position −1."""
    S, W = positions.shape[1], cache_len
    arrays = dict(arrays, pos=positions)
    if S >= W:
        shift = S % W
        return {key: (torch.roll(t[:, S - W:], shift, dims=1) if shift
                      else t[:, S - W:]).contiguous()
                for key, t in arrays.items()}
    out = {}
    for key, t in arrays.items():
        out[key] = (t.new_full((t.shape[0], W), -1) if key == "pos"
                    else t.new_zeros((t.shape[0], W, *t.shape[2:])))
        out[key][:, :S] = t
    return out


def _gqa_cache(k, v, positions, cache_len: int) -> dict:
    cache = _ring_cache({"k": k, "v": v}, positions, cache_len)
    for key in ("k", "v"):
        cache[key] = sharding.constrain(cache[key], "batch", "kv_seq",
                                        "kv_heads", None)
    return cache


def gqa_prefill_cache(p: GQA, cfg: AttnConfig, x, positions,
                      cache_len: int):
    """Build the (ring) KV cache from a prompt. Returns the cache dict."""
    _, k, v = _qkv(_weights(p, pin=False), cfg, x, positions)
    return _gqa_cache(k, v, positions, cache_len)


def gqa_prefill(p: GQA, cfg: AttnConfig, x, positions, window: int, impl,
                cache_len: int):
    """``gqa_forward`` and ``gqa_prefill_cache`` from one projection of
    k and v → (out, cache)."""
    out, k, v = _attend_gqa(_weights(p, pin=True), cfg, x, positions,
                            window, impl)
    return out, _gqa_cache(k, v, positions, cache_len)


def gqa_decode(p: GQA, cfg: AttnConfig, x, pos, window: int, cache,
               step: int):
    """One decode step. x: (B, 1, D); pos: (B,) current absolute position;
    ``step`` — the ring write counter (slot = step % cache_len). The cache
    is written in place and returned. → (out (B, 1, D), cache)."""
    dt = x.dtype
    B = x.shape[0]
    w = _weights(p, pin=False)
    q, k, v = _qkv(w, cfg, x, pos[:, None])
    # Split-K over the cache's kv_seq split: each rank's slice of the cache
    # meets every head, so q's heads are gathered (the reference leaves
    # this to GSPMD).
    q = sharding.constrain(q, "batch", "seq", None, None)
    slot = step % cache["k"].shape[1]
    for key, new in (("k", k[:, 0]), ("v", v[:, 0]), ("pos", pos)):
        sharding.update_slice(cache[key], 1, slot, new)
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]

    Hkv, g, Dh = cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.head_dim
    qg = (q.float() * cfg.head_dim ** -0.5).reshape(B, 1, Hkv, g, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.float())
    s = cm.softcap(s, cfg.softcap)
    cp, ps = cpos[:, None, None, None, :], pos[:, None, None, None, None]
    ok = (cp <= ps) & (cp >= 0)
    if window > 0:
        ok &= cp > ps - window
    p_attn = torch.softmax(s.masked_fill(~ok, NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p_attn, cv.float())
    out = out.reshape(B, 1, cfg.n_heads, Dh)
    return _out(w["wo"], out, dt), cache


def _pin_mla(p: MLA) -> dict:
    """An ``MLA``'s weights by name under the reference's use-site pins
    (``_pin_mla``: each product's weight gathered over its FSDP axes where
    it is used, ``sharding.pin_weight``); the norms as they lie."""
    axes = mla_axes()
    return {name: getattr(p, name) if name.endswith("_norm")
            else sharding.pin_weight(getattr(p, name), *axes[name])
            for name in MLA.NAMES}


def _mla_qkv(p, cfg: AttnConfig, x, positions):
    """→ q_nope (B, S, H, nope), roped q_rope (B, S, H, rope), the normed
    latent c_kv (B, S, kv_lora) and the roped shared key k_rope (B, S,
    rope). Only c_kv's half of the down-projection is normed: k_rope comes
    from the unnormed rest, as in the reference. ``p`` is an ``MLA`` or
    its ``_pin_mla`` weights. Under installed rules ``cq`` is split over
    ``q_lora`` (its norm's mean is then a sum over the shards), q's
    up-projection leaves a partial sum over those shards, laid out over
    ``heads`` at once (a reduce-scatter)."""
    w = p if isinstance(p, dict) else _pin_mla(p)
    m, dt = cfg.mla, x.dtype
    # The sequence-parallel residual is gathered first, as for GQA.
    x = sharding.constrain(x, "batch", "seq", None)
    cq = cm.rms_norm(x @ w["w_dq"].to(dt), w["q_norm"])
    q = sharding.constrain(_project(cq, w["w_uq"].to(dt), "heads"), "batch",
                           "seq", "heads", None)
    nope = m.qk_nope_head_dim
    q_rope = cm.rope(q[..., nope:], positions[:, :, None], cfg.rope_theta)
    ckv = x @ w["w_dkv"].to(dt)
    c_kv = cm.rms_norm(ckv[..., :m.kv_lora_rank], w["kv_norm"])
    k_rope = cm.rope(ckv[..., m.kv_lora_rank:], positions, cfg.rope_theta)
    return q[..., :nope], q_rope, c_kv, k_rope


def _mla_attend(w: dict, cfg: AttnConfig, x, positions, window: int, impl,
                q_nope, q_rope, c_kv, k_rope):
    """The direct form: k = [k_nope ; k_rope broadcast over the heads], v
    padded to q·k's width, one attention of that head_dim at its scale
    with n_kv = n_heads, the output cut to v's width. → (B, S, D), laid
    out as the reference's ``mla_forward`` lays q, k and v (over
    ``heads``) and scattered onto the sequence-parallel residual as
    GQA's."""
    m, dt = cfg.mla, x.dtype
    B, S = x.shape[:2]
    H, qk = cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim
    c = sharding.constrain
    c_kv = c(c_kv, "batch", "seq", None)
    k_nope = c(_project(c_kv, w["w_uk"].to(dt), "heads"), "batch", "seq",
               "heads", None)
    v = c(_project(c_kv, w["w_uv"].to(dt), "heads"), "batch", "seq", "heads",
          None)
    k_rope = c(k_rope[:, :, None].expand(B, S, H, m.qk_rope_head_dim),
               "batch", "seq", "heads", None)
    q = c(torch.cat([q_nope, q_rope], -1), "batch", "seq", "heads", None)
    k = c(torch.cat([k_nope, k_rope], -1), "batch", "seq", "heads", None)
    pad = torch.zeros_like(v[..., :1]).expand(*v.shape[:-1],
                                              qk - m.v_head_dim)
    v = c(torch.cat([v, pad], -1), "batch", "seq", "heads", None)
    cfg_v = dataclasses.replace(cfg, n_kv=H, head_dim=qk)
    out = _attend(q, k, v, positions[0], positions[0], window, cfg_v, impl,
                  scale=qk ** -0.5)
    return c(_out(w["wo"], out[..., :m.v_head_dim], dt), "batch", "act_seq",
             None)


def mla_forward(p: MLA, cfg: AttnConfig, x, positions, window: int, impl):
    """Training/prefill MLA forward (direct form). x (B, S, D) → (B, S,
    D)."""
    w = _pin_mla(p)
    return _mla_attend(w, cfg, x, positions, window, impl,
                       *_mla_qkv(w, cfg, x, positions))


def _mla_cache(c_kv, k_rope, positions, cache_len: int) -> dict:
    cache = _ring_cache({"c_kv": c_kv, "k_rope": k_rope}, positions,
                        cache_len)
    for key in ("c_kv", "k_rope"):
        cache[key] = sharding.constrain(cache[key], "batch", "kv_seq", None)
    return cache


def mla_prefill_cache(p: MLA, cfg: AttnConfig, x, positions,
                      cache_len: int):
    """The (ring) MLA cache of a prompt: {"c_kv", "k_rope", "pos"}, the
    latents laid out over ``kv_seq``."""
    _, _, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    return _mla_cache(c_kv, k_rope, positions, cache_len)


def mla_prefill(p: MLA, cfg: AttnConfig, x, positions, window: int, impl,
                cache_len: int):
    """``mla_forward`` and ``mla_prefill_cache`` from one ``_mla_qkv`` →
    (out, cache)."""
    w = _pin_mla(p)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(w, cfg, x, positions)
    out = _mla_attend(w, cfg, x, positions, window, impl, q_nope, q_rope,
                      c_kv, k_rope)
    return out, _mla_cache(c_kv, k_rope, positions, cache_len)


def _softmax_split(s):
    """Softmax over the last axis as its max, exp and sum: on a DTensor
    split along that axis (a decode cache's ``kv_seq``) each rank keeps
    its slice of the scores, and the max and the sum are the only values
    reduced (two all-reduces of (..., 1)) where ``torch.softmax`` would
    gather every score."""
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def mla_decode(p: MLA, cfg: AttnConfig, x, pos, window: int, cache,
               step: int):
    """One absorbed-form decode step in float32: scores q_nope · W_uk ·
    c_kv + q_rope · k_rope, the context through W_uv; only c_kv and k_rope
    are cached. Writes the cache in place (slot = step % cache_len, on its
    own shard of a ``kv_seq``-split cache: ``sharding.update_slice``);
    → (out (B, 1, D), cache). Under installed rules q's heads are
    gathered (split-K: each rank's slice of the cache meets every head),
    and the f32 softmax runs over the cache axis, split or not
    (``_softmax_split``)."""
    m, dt = cfg.mla, x.dtype
    w = _pin_mla(p)
    q_nope, q_rope, c_new, kr_new = _mla_qkv(w, cfg, x, pos[:, None])
    c = sharding.constrain
    q_nope = c(q_nope, "batch", "seq", None, None)
    q_rope = c(q_rope, "batch", "seq", None, None)
    slot = step % cache["c_kv"].shape[1]
    for key, new in (("c_kv", c_new[:, 0]), ("k_rope", kr_new[:, 0]),
                     ("pos", pos)):
        sharding.update_slice(cache[key], 1, slot, new)
    c_kv, cpos = cache["c_kv"].float(), cache["pos"]
    q_abs = c(torch.einsum("bshk,rhk->bhr", q_nope.float(),
                           w["w_uk"].float()), "batch", None, None)
    s = (torch.einsum("bhr,bsr->bhs", q_abs, c_kv)
         + torch.einsum("bshk,bSk->bhS", q_rope.float(),
                        cache["k_rope"].float()))
    s = s * (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    cp, ps = cpos[:, None, :], pos[:, None, None]
    ok = (cp <= ps) & (cp >= 0)
    if window > 0:
        ok &= cp > ps - window
    pr = _softmax_split(s.masked_fill(~ok, NEG_INF))
    ctx = torch.einsum("bhs,bsr->bhr", pr, c_kv)
    out = torch.einsum("bhr,rhk->bhk", ctx, w["w_uv"].float())
    return _out(w["wo"], out[:, None], dt), cache


def forward(p, cfg: AttnConfig, x, positions, window: int,
            impl="blocked_causal"):
    if cfg.mla:
        return mla_forward(p, cfg, x, positions, window, impl)
    return gqa_forward(p, cfg, x, positions, window, impl)


def prefill(p, cfg: AttnConfig, x, positions, window: int, impl,
            cache_len: int):
    if cfg.mla:
        return mla_prefill(p, cfg, x, positions, window, impl, cache_len)
    return gqa_prefill(p, cfg, x, positions, window, impl, cache_len)


def decode(p, cfg: AttnConfig, x, pos, window: int, cache, step: int):
    if cfg.mla:
        return mla_decode(p, cfg, x, pos, window, cache, step)
    return gqa_decode(p, cfg, x, pos, window, cache, step)
