"""Minimal real-E(3) irrep algebra for NequIP and MACE, l ≤ 3
(counterpart of ``repro.models.gnn.e3``).

Real spherical harmonics are explicit polynomials, normalised per
component over the unit sphere (so each irrep's rotation matrices are
orthogonal). Wigner-D matrices are fitted by least squares over sampled
directions, and the real Clebsch-Gordan tensors are the one-dimensional
null space of the rotation-equivariance constraint stacked over random
rotations.

Everything is computed on the host with numpy, draw for draw and call for
call as in the reference: the same seeds (``12345 + l`` for ``wigner``,
999 for ``cg``), the same ``lstsq`` and the same SVD. A CG tensor is only
fixed up to its sign, which is whatever LAPACK's SVD returns; the learned
path weights multiply these tensors, so weights carried over from the
reference mean the same thing only if the tensors are built this way.
``cg_torch`` keeps each tensor as a constant per (device, dtype), and
``edge_basis`` gives NequIP's and MACE's per-edge radial basis and
harmonics.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.models.gnn import graph as G


def dim(l: int) -> int:
    return 2 * l + 1


def _sh_raw(l: int, n, xp):
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    if l == 0:
        if xp is torch:
            return torch.ones(n.shape[:-1] + (1,), dtype=n.dtype,
                              device=n.device)
        return np.ones(n.shape[:-1] + (1,), n.dtype)
    if l == 1:
        return xp.stack([y, z, x], axis=-1)
    if l == 2:
        return xp.stack([
            x * y, y * z, 3 * z * z - 1.0, x * z, x * x - y * y,
        ], axis=-1)
    if l == 3:
        return xp.stack([
            y * (3 * x * x - y * y),
            x * y * z,
            y * (5 * z * z - 1.0),
            z * (5 * z * z - 3.0),
            x * (5 * z * z - 1.0),
            z * (x * x - y * y),
            x * (x * x - 3 * y * y),
        ], axis=-1)
    raise NotImplementedError(l)


#: exact E[Y_i^2] over the uniform unit sphere for each raw component
#: (moments: E[x^2]=1/3, E[x^4]=1/5, E[x^2 y^2]=1/15, E[x^6]=1/7,
#:  E[x^4 y^2]=1/35, E[x^2 y^2 z^2]=1/105).
_RMS2 = {
    0: [1.0],
    1: [1 / 3, 1 / 3, 1 / 3],
    2: [1 / 15, 1 / 15, 4 / 5, 1 / 15, 4 / 15],
    3: [8 / 35, 1 / 105, 8 / 21, 4 / 7, 8 / 21, 4 / 105, 8 / 35],
}


@functools.lru_cache(maxsize=None)
def _scales(l: int) -> np.ndarray:
    """Per-component 1/rms over the unit sphere → orthogonal Wigner-D."""
    return 1.0 / np.sqrt(np.asarray(_RMS2[l], np.float64))


def sh(l: int, n):
    """Real spherical harmonics, unit-rms components. n: (..., 3) unit
    vectors, a tensor (the result in its dtype, on its device) or a numpy
    array (float64 scales, as in the reference)."""
    if isinstance(n, torch.Tensor):
        return _sh_raw(l, n, torch) * torch.as_tensor(
            _scales(l), dtype=n.dtype, device=n.device)
    return _sh_raw(l, n, np) * _scales(l)


def _rand_rotations(rng, n):
    rs = []
    for _ in range(n):
        q, r = np.linalg.qr(rng.standard_normal((3, 3)))
        q = q * np.sign(np.diag(r))
        if np.linalg.det(q) < 0:
            q[:, [0, 1]] = q[:, [1, 0]]
        rs.append(q)
    return rs


def wigner(R: np.ndarray, l: int) -> np.ndarray:
    """Fit D_l(R) from sh(l, n @ R.T) = D_l(R) @ sh(l, n)."""
    rng = np.random.default_rng(12345 + l)
    n = rng.standard_normal((max(16 * dim(l), 64), 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    Y = sh(l, n)                    # (K, d)
    YR = sh(l, n @ R.T)             # (K, d)
    D, *_ = np.linalg.lstsq(Y, YR, rcond=None)
    return D.T                      # Y(Rn) = D @ Y(n)


@functools.lru_cache(maxsize=None)
def cg(l1: int, l2: int, l3: int) -> np.ndarray | None:
    """Real CG tensor C (d1, d2, d3): D3 out = C[(D1 u) ⊗ (D2 v)] ∀R.

    Normalised to unit Frobenius norm; None when no invariant coupling
    exists (|l1−l2| ≤ l3 ≤ l1+l2 selection rule, multiplicity ≤ 1 in SO(3)).
    """
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return None
    d1, d2, d3 = dim(l1), dim(l2), dim(l3)
    rng = np.random.default_rng(999)
    rows = []
    for R in _rand_rotations(rng, 6):
        D1, D2, D3 = (wigner(R, l) for l in (l1, l2, l3))
        # Constraint over vec(C) (C-order (m1, m2, m3)):
        #   Σ C[m1,m2,m3] D1[m1,a] D2[m2,b] = Σ D3[m3,m3'] C[a,b,m3']
        A = np.kron(np.kron(D1.T, D2.T), np.eye(d3)) - \
            np.kron(np.eye(d1 * d2), D3)
        rows.append(A)
    M = np.concatenate(rows, axis=0)
    _, s, vh = np.linalg.svd(M)
    if s[-1] > 1e-8:
        return None
    assert s.size == 1 or s[-2] > 1e-6, \
        f"CG({l1},{l2},{l3}) multiplicity > 1?"
    C = vh[-1].reshape(d1, d2, d3)
    C /= np.linalg.norm(C)
    return C.astype(np.float64)


_CG_TENSORS: dict = {}


def cg_torch(l1: int, l2: int, l3: int, device,
             dtype=torch.float32) -> torch.Tensor | None:
    """``cg(l1, l2, l3)`` rounded to ``dtype`` (float32 by default, as the
    reference's ``cg_jnp``) on ``device``, built once per (device, dtype);
    None where ``cg`` is None."""
    key = (l1, l2, l3, torch.device(device), dtype)
    if key not in _CG_TENSORS:
        c = cg(l1, l2, l3)
        _CG_TENSORS[key] = None if c is None else torch.from_numpy(c).to(
            device=device, dtype=dtype)
    return _CG_TENSORS[key]


@functools.lru_cache(maxsize=None)
def paths(l_max: int) -> tuple[tuple[int, int, int], ...]:
    """All (l1, l2, l3) couplings with every l ≤ l_max."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(l_max + 1):
                if cg(l1, l2, l3) is not None:
                    out.append((l1, l2, l3))
    return tuple(out)


def edge_basis(g: G.Graph, l_max: int, n_rbf: int, cutoff: float):
    """Per edge of ``g``, from its positions: the radial basis (E, n_rbf)
    of r = √(|dst − src|² + 1e-12) and the harmonics ``[sh(l, r̂)]`` for
    l ≤ l_max, each (E, 2l+1). A zero-length edge (a self-loop, padding)
    has no direction, so its harmonics are 0 where r ≤ 1e-6, as in the
    reference NequIP and MACE."""
    pos = g.positions
    diff = G.gather_dst(g, pos) - G.gather_src(g, pos)
    r = torch.sqrt(torch.sum(diff * diff, -1) + 1e-12)
    rhat = diff / r[:, None]
    ok = (r > 1e-6)[:, None]
    return (G.radial_basis(r, n_rbf, cutoff),
            [sh(l, rhat) * ok for l in range(l_max + 1)])
