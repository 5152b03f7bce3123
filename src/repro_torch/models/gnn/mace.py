"""MACE (Batatia et al., arXiv:2206.07697): higher-order equivariant
message passing via the Atomic Cluster Expansion (counterpart of
``repro.models.gnn.mace``).

Per layer: the A-basis is a radial × SH-weighted neighbour density (one
tensor-product aggregation per l), and the B-basis takes symmetric tensor
powers of A up to correlation order ν = 3: B² = CG(A ⊗ A), B³ = CG(B² ⊗ A)
(B² alone, not A + B², against A, as in the reference). Messages are
learned linear combinations of the B-basis; readouts add each layer's
scalar channels into per-node energies. The reference's simplifications
are kept (one channel group, generic-path CG contractions), and so are its
parameter tree and distribution.

Two chunkings keep the full ogbn-products graph on one card. The A-basis
is formed and scattered ``EDGE_CHUNK`` edges at a time: its radial weights
(E, 3, 128) alone would take 95 GB and its l = 2 messages 198 GB. The
B-basis is contracted ``NODE_CHUNK`` nodes at a time: a (2, 2) path's
outer product is (N, C, 5, 5), 31 GB over the whole graph. Each
three-operand einsum ``"nci,ncj,ijo->nco"`` is contracted in a fixed
order: the outer product u ⊗ v → (n·C, i·j), then one product with the CG
tensor as an (i·j, o) matrix. The sums equal the unchunked ones up to
float order.

Laid over a mesh (``param_axes``, ``graph.Partition``), each rank forms the
A-basis of its own edges from the positions and the scalars all-gathered
once a layer; the partial sums are reduce-scattered to the nodes' layout,
and the B-basis loop runs over the rank's own rows.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.types import resolve_device
from repro_torch.models import common as cm
from repro_torch.models.gnn import e3
from repro_torch.models.gnn import graph as G

EDGE_CHUNK = 1 << 21
NODE_CHUNK = 1 << 18


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    cutoff: float = 5.0
    d_in: int = 16
    n_classes: int = 7
    task: str = "graph_reg"
    avg_neighbors: float = 8.0


def param_specs(cfg: MACEConfig) -> dict:
    """The reference's tree: each leaf (shape, scale), scale None for
    1/√fan_in; ``b2_w`` at 0.3, ``b3_w`` at 0.1, ``msg_l`` and ``res_l`` at
    1/√C."""
    C, L = cfg.d_hidden, cfg.l_max
    n_paths = len(e3.paths(L))
    specs = {"embed": ((cfg.d_in, C), None)}
    for i in range(cfg.n_layers):
        layer = {"rad_w0": ((cfg.n_rbf, 32), None),
                 "rad_w1": ((32, (L + 1) * C), None),
                 "b2_w": ((n_paths, C), 0.3),
                 "b3_w": ((n_paths, C), 0.1)}
        for l in range(L + 1):
            layer[f"msg_{l}"] = ((C, C), 1.0 / C**0.5)
            layer[f"res_{l}"] = ((C, C), 1.0 / C**0.5)
        specs[f"layer_{i}"] = layer
    out_dim = cfg.n_classes if cfg.task == "node_class" else 1
    specs["head0"] = ((C, C), None)
    specs["head1"] = ((C, out_dim), None)
    return specs


def param_axes(cfg: MACEConfig) -> dict:
    """The logical axes of each parameter, the reference ``init``'s."""
    L = cfg.l_max
    layer = {"rad_w0": (None, None), "rad_w1": (None, "mlp"),
             "b2_w": (None, "mlp"), "b3_w": (None, "mlp"),
             **{f"msg_{l}": ("mlp", "mlp") for l in range(L + 1)},
             **{f"res_{l}": ("mlp", "mlp") for l in range(L + 1)}}
    return {"embed": ("embed_fsdp", "mlp"),
            **{f"layer_{i}": dict(layer) for i in range(cfg.n_layers)},
            "head0": ("mlp", "mlp"), "head1": ("mlp", None)}


def init(cfg: MACEConfig, generator: torch.Generator, device=None) -> dict:
    """Random parameters on ``device`` (CUDA by default) with the
    reference's distribution; ``convert.mace_from_numpy`` carries the
    reference's own numbers."""
    return cm.init_tree(param_specs(cfg), generator, resolve_device(device))


def _a_basis(lp, cfg: MACEConfig, g: G.Graph, scal, n: int):
    """A_i[l] = Σ_j R_l(r_ij) · Y_l(r̂_ij) ⊗ h_j → [(N, C, 2l+1)] per l,
    EDGE_CHUNK edges (of the rank's own) at a time."""
    C, L = cfg.d_hidden, cfg.l_max
    part = G.Partition(g, n, positions=True)
    rad0, rad1 = (part.weight(lp[k]) for k in ("rad_w0", "rad_w1"))
    src = part.nodes(scal)
    A = [src.new_zeros((n + 1, C, e3.dim(l))) for l in range(L + 1)]
    for _, gc in part.chunks(EDGE_CHUNK):
        rbf, sh_edges = e3.edge_basis(gc, L, cfg.n_rbf, cfg.cutoff)
        rw = (F.silu(rbf @ rad0) @ rad1).view(
            rbf.shape[0], L + 1, C)                     # (E, L+1, C)
        hj = G.gather_src(gc, src)                      # (E, C)
        for l in range(L + 1):
            m = (rw[:, l] * hj)[:, :, None] * sh_edges[l][:, None, :]
            G.scatter_add_(A[l], gc, m)
            del m
        del rbf, sh_edges, rw, hj
    norm = cfg.avg_neighbors**0.5
    if torch.is_grad_enabled():
        return [part.sum(a) / norm for a in A]
    return [part.sum(a).div_(norm) for a in A]  # one (N, C, 2l+1) buffer each


def _cg_product(u, v, cgt):
    """Σ_ij u[n,c,i] v[n,c,j] C[i,j,o] → (n, C, o): the outer product
    first, then one product with C as an (i·j, o) matrix."""
    n, c, i = u.shape
    j, o = v.shape[2], cgt.shape[2]
    outer = (u[:, :, :, None] * v[:, :, None, :]).view(n * c, i * j)
    return (outer @ cgt.reshape(i * j, o)).view(n, c, o)


def _b_basis(lp, cfg: MACEConfig, A):
    """Symmetric tensor powers of A via CG contraction (ν ≤ 3), over the
    nodes of ``A``'s blocks."""
    L = cfg.l_max
    paths_ = e3.paths(L)
    cgts = [e3.cg_torch(*p, A[0].device, A[0].dtype) for p in paths_]
    B2 = {}
    for pi, (l1, l2, l3) in enumerate(paths_):
        t = _cg_product(A[l1], A[l2], cgts[pi]) * lp["b2_w"][pi][None, :,
                                                                 None]
        B2[l3] = t if l3 not in B2 else B2[l3] + t
    out = [A[l] + B2[l] for l in range(L + 1)]
    if cfg.correlation >= 3:
        for pi, (l1, l2, l3) in enumerate(paths_):
            t = _cg_product(B2[l1], A[l2], cgts[pi])
            out[l3] = out[l3] + t * lp["b3_w"][pi][None, :, None]
    return out


def _layer(lp, cfg: MACEConfig, g: G.Graph, feats, n: int):
    """One MACE layer: the A-basis over the edges, then the B-basis,
    messages and residuals NODE_CHUNK nodes (of the rank's own rows) at a
    time."""
    part = G.Partition(g, n)
    A = [part.rows(a) for a in _a_basis(lp, cfg, g, feats[0][:, :, 0], n)]
    rows = {l: part.rows(f) for l, f in feats.items()}
    lp = {k: part.row_weight(w) for k, w in lp.items()
          if not k.startswith("rad_")}
    new = {l: torch.empty_like(f) for l, f in rows.items()}
    for lo in range(0, part.n_rows, NODE_CHUNK):
        hi = min(part.n_rows, lo + NODE_CHUNK)
        B = _b_basis(lp, cfg, [a[lo:hi] for a in A])
        for l in range(cfg.l_max + 1):
            msg = torch.einsum("nci,cd->ndi", B[l], lp[f"msg_{l}"])
            res = torch.einsum("nci,cd->ndi", rows[l][lo:hi], lp[f"res_{l}"])
            new[l][lo:hi] = msg + res
        del B
    return {l: part.from_rows(t) for l, t in new.items()}


def _embed(params, cfg, g: G.Graph):
    """The first layer's irrep dict: the embedded scalars, zeros for
    l ≥ 1."""
    feats = {0: (g.node_feat @ G.whole(params["embed"]))[:, :, None]}
    for l in range(1, cfg.l_max + 1):
        feats[l] = G.node_zeros(feats[0], feats[0].shape[1], e3.dim(l))
    return feats


def forward(params, cfg: MACEConfig, g: G.Graph):
    """(feats, node_energy): the irrep dict {l: (N, C, 2l+1)} after the
    layers and the (N, C) sum of every layer's scalar channels;
    differentiable in ``params``."""
    n = g.node_mask.shape[0]
    feats = _embed(params, cfg, g)
    node_energy = None
    for i in range(cfg.n_layers):
        feats = _layer(params[f"layer_{i}"], cfg, g, feats, n)
        scal = feats[0][:, :, 0]
        node_energy = scal if node_energy is None else node_energy + scal
    return feats, node_energy


@torch.no_grad()
def apply(params, cfg: MACEConfig, g: G.Graph):
    """Inference: ``forward`` without gradients."""
    return forward(params, cfg, g)


def loss_fn(params, cfg: MACEConfig, g: G.Graph):
    """``graph.task_loss`` of the readout silu(E·W0)·W1 of the node
    energies."""
    _, node_e = forward(params, cfg, g)
    out = F.silu(node_e @ G.whole(params["head0"])) @ G.whole(
        params["head1"])
    return G.task_loss(out, g, cfg.task)
