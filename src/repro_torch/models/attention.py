"""Attention blocks (counterpart of ``repro.models.attention``): the GQA
half, with RoPE, a per-layer sliding window and a logit softcap.

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
cache, as in the reference, with the cache written in place. MLA is not
ported yet.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

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


def init(cfg: AttnConfig, gen, device, dtype) -> GQA:
    _no_mla(cfg)
    return init_gqa(cfg, gen, device, dtype)


def _no_mla(cfg: AttnConfig):
    if cfg.mla:
        raise NotImplementedError("MLA attention is not ported yet")


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
    return out.transpose(1, 2)


def _qkv(p: GQA, cfg: AttnConfig, x, positions):
    """Roped q (B, S, H, Dh), roped k and v (B, S, Hkv, Dh)."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p.wk.to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p.wv.to(dt))
    pos = positions[:, :, None]            # broadcast over heads
    return (cm.rope(q, pos, cfg.rope_theta), cm.rope(k, pos, cfg.rope_theta),
            v)


def _out(p: GQA, out, dt):
    return torch.einsum("bshk,hkd->bsd", out.to(dt), p.wo.to(dt))


def gqa_forward(p: GQA, cfg: AttnConfig, x, positions, window: int, impl):
    """Training/prefill forward. x: (B, S, D) → (B, S, D)."""
    q, k, v = _qkv(p, cfg, x, positions)
    out = _attend(q, k, v, positions[0], positions[0], window, cfg, impl)
    return _out(p, out, x.dtype)


def _cache_from_kv(k, v, positions, cache_len: int):
    """The (ring) KV cache of a prompt's roped k and v."""
    S, W = k.shape[1], cache_len
    if S >= W:
        # Ring invariant: position p lives at slot p % W (decode writes at
        # step % W): roll the truncated window into place.
        ck, cv, cpos = k[:, S - W:], v[:, S - W:], positions[:, S - W:]
        shift = S % W
        if shift:
            ck, cv, cpos = (torch.roll(t, shift, dims=1)
                            for t in (ck, cv, cpos))
        return {"k": ck.contiguous(), "v": cv.contiguous(),
                "pos": cpos.contiguous()}
    B, _, Hkv, Dh = k.shape
    ck = k.new_zeros((B, W, Hkv, Dh))
    cv = v.new_zeros((B, W, Hkv, Dh))
    cpos = positions.new_full((B, W), -1)
    ck[:, :S], cv[:, :S], cpos[:, :S] = k, v, positions
    return {"k": ck, "v": cv, "pos": cpos}


def gqa_prefill_cache(p: GQA, cfg: AttnConfig, x, positions,
                      cache_len: int):
    """Build the (ring) KV cache from a prompt. Returns the cache dict."""
    _, k, v = _qkv(p, cfg, x, positions)
    return _cache_from_kv(k, v, positions, cache_len)


def gqa_prefill(p: GQA, cfg: AttnConfig, x, positions, window: int, impl,
                cache_len: int):
    """``gqa_forward`` and ``gqa_prefill_cache`` from one projection of
    k and v → (out, cache)."""
    q, k, v = _qkv(p, cfg, x, positions)
    out = _attend(q, k, v, positions[0], positions[0], window, cfg, impl)
    return _out(p, out, x.dtype), _cache_from_kv(k, v, positions, cache_len)


def gqa_decode(p: GQA, cfg: AttnConfig, x, pos, window: int, cache,
               step: int):
    """One decode step. x: (B, 1, D); pos: (B,) current absolute position;
    ``step`` — the ring write counter (slot = step % cache_len). The cache
    is written in place and returned. → (out (B, 1, D), cache)."""
    dt = x.dtype
    B = x.shape[0]
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    slot = step % cache["k"].shape[1]
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["pos"][:, slot] = pos
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
    return _out(p, out, dt), cache


def forward(p, cfg: AttnConfig, x, positions, window: int,
            impl="blocked_causal"):
    _no_mla(cfg)
    return gqa_forward(p, cfg, x, positions, window, impl)


def prefill(p, cfg: AttnConfig, x, positions, window: int, impl,
            cache_len: int):
    _no_mla(cfg)
    return gqa_prefill(p, cfg, x, positions, window, impl, cache_len)


def decode(p, cfg: AttnConfig, x, pos, window: int, cache, step: int):
    _no_mla(cfg)
    return gqa_decode(p, cfg, x, pos, window, cache, step)
