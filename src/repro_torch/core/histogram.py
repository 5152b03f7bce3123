"""Two-bucket score histograms and their join convolution (§3.1).

Counterpart of ``repro.core.histogram``; every function also takes leading
batch axes. Each pattern's score pdf is the paper's two-bucket histogram
rendered on ``G`` bins per unit score; the join pdf is the discrete
convolution of the constituents, through rfft as in the JAX package.
``torch.fft`` rounds differently from ``jnp.fft``, so a quantile that sits on
a bin edge may move by one bin (1/G) between the two.
"""
from __future__ import annotations

import torch


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


def conv_truncate(a: torch.Tensor, b: torch.Tensor, out_len: int
                  ) -> torch.Tensor:
    """Linear convolution of pmfs along the last axis, truncated to
    ``out_len`` bins; tiny negative FFT roundoff is clipped to 0."""
    n = a.shape[-1] + b.shape[-1] - 1
    nfft = _next_pow2(max(n, out_len))
    fa = torch.fft.rfft(a, nfft)
    fb = torch.fft.rfft(b, nfft)
    out = torch.fft.irfft(fa * fb, nfft)[..., :out_len]
    return out.clamp(min=0.0)


def pattern_pmf(stats: torch.Tensor, scale, G: int) -> torch.Tensor:
    """Two-bucket pdf of (optionally weight-scaled) patterns on a grid.

    stats (..., 4) f32 — (m, sigma_r, S_r, S_m); scale broadcastable to the
    leading axes (a relaxation weight w shrinks the support to [0, w]).
    Returns (..., G+1) pmfs summing to 1 (all-zero for empty patterns).
    """
    sigma, S_r, S_m = stats[..., 1:2], stats[..., 2:3], stats[..., 3:4]
    scale = torch.as_tensor(scale, dtype=torch.float32,
                            device=stats.device)
    scale = scale.expand(stats.shape[:-1])[..., None]
    sigma_s = sigma * scale
    top_s = scale
    centers = (torch.arange(G + 1, dtype=torch.float32, device=stats.device)
               + 0.5) / G
    p_head = torch.where(S_m > 0, S_r / S_m.clamp(min=1e-30), 0.0)
    p_tail = torch.where(S_m > 0, 1.0 - p_head, 0.0)
    in_tail = centers < sigma_s
    in_head = (centers >= sigma_s) & (centers <= top_s + 0.5 / G)
    n_tail = in_tail.float().sum(-1, keepdim=True).clamp(min=1.0)
    n_head = in_head.float().sum(-1, keepdim=True).clamp(min=1.0)
    pmf = in_tail * (p_tail / n_tail) + in_head * (p_head / n_head)
    tot = pmf.sum(-1, keepdim=True)
    return torch.where(tot > 0, pmf / tot.clamp(min=1e-30), pmf)


def _delta(shape, out_len: int, device) -> torch.Tensor:
    d = torch.zeros(tuple(shape) + (out_len,), dtype=torch.float32,
                    device=device)
    d[..., 0] = 1.0
    return d


def convolve_pmfs(pmfs: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """(..., T, G+1) pattern pmfs → (..., T*G+1) query pmf on [0, T];
    inactive patterns are skipped."""
    T, G1 = pmfs.shape[-2:]
    out_len = T * (G1 - 1) + 1
    acc = _delta(pmfs.shape[:-2], out_len, pmfs.device)
    for t in range(T):
        full = conv_truncate(acc, pmfs[..., t, :], out_len)
        acc = torch.where(active[..., t, None], full, acc)
    return acc / acc.sum(-1, keepdim=True).clamp(min=1e-30)


def pmf_quantile(pmf: torch.Tensor, q: torch.Tensor, unit_bins: int
                 ) -> torch.Tensor:
    """F^{-1}(q) for pmfs (..., n) on a grid of ``unit_bins`` bins per unit
    score; q (...)."""
    cdf = pmf.cumsum(-1)
    cdf = cdf / cdf[..., -1:].clamp(min=1e-30)
    q = q.clamp(0.0, 1.0)
    idx = torch.searchsorted(cdf.contiguous(), q[..., None].contiguous(),
                             side="left")[..., 0]
    idx = idx.clamp(0, pmf.shape[-1] - 1)
    return idx.float() / unit_bins


def expected_order_statistic(pmf: torch.Tensor, n: torch.Tensor, rank,
                             unit_bins: int) -> torch.Tensor:
    """E[score at rank ``rank``] (1 = best) among ``n`` i.i.d. answers,
    F^{-1}((n - rank)/(n + 1)); 0 where n < rank."""
    n = n.float()
    rank = torch.as_tensor(rank, dtype=torch.float32, device=n.device)
    q = (n - rank) / (n + 1.0)
    val = pmf_quantile(pmf, q, unit_bins)
    return torch.where(n >= rank, val, 0.0)
