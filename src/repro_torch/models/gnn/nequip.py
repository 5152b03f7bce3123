"""NequIP (Batzner et al., arXiv:2101.03164): E(3)-equivariant interatomic
potential with tensor-product message passing (counterpart of
``repro.models.gnn.nequip``).

Features are irrep dicts {l: (N, C, 2l+1)}. Each interaction block: a
radial MLP on RBF(r) → per-(path, channel) weights; the message on an edge
is CG(l_in, l_f → l_out) · (feat_src[l_in] ⊗ Y_{l_f}(r̂)); a scatter-sum;
a per-l channel-mixing self-interaction; a gated nonlinearity. The
parameter tree and its distribution are the reference's.

The reference's three-operand einsum ``"eci,ef,ifo->eco"`` is contracted
in a fixed order here: Y ⊗ CG → (E, i, o), then a batched (C × i)·(i × o)
product, and every path out of one l_in at once: its source features are
gathered once a chunk, its (i, o) blocks side by side come from one
product of the harmonics with a constant matrix (``_filters``), and one
batched product gives all their messages, which are scaled by their
radial weights and summed into each l_out. Messages are formed and
scattered ``EDGE_CHUNK`` edges at a time: at ogbn-products scale the
radial weights alone, (E, 15 paths, 32), would take 118.8 GB. A chunk of
2**21 edges holds about 8 KB an edge at 32 channels, about 17 GB.

Laid over a mesh (``param_axes``, ``graph.Partition``), each rank forms the
messages of its own edges from the positions and each l-block
all-gathered once a layer, and the partial sums are reduce-scattered to
the nodes' layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.types import resolve_device
from repro_torch.models import common as cm
from repro_torch.models.gnn import e3
from repro_torch.models.gnn import graph as G

EDGE_CHUNK = 1 << 21


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    d_hidden: int = 32          # channels per irrep
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    d_in: int = 16              # input scalar features (species embed)
    n_classes: int = 7
    task: str = "graph_reg"
    avg_neighbors: float = 8.0  # aggregation normalizer (NequIP convention)


def param_specs(cfg: NequIPConfig) -> dict:
    """The reference's tree: each leaf (shape, scale), scale None for
    1/√fan_in; ``self_l`` at 1/√C."""
    C = cfg.d_hidden
    n_paths = len(e3.paths(cfg.l_max))
    specs = {"embed": ((cfg.d_in, C), None)}
    for i in range(cfg.n_layers):
        layer = {"rad_w0": ((cfg.n_rbf, 32), None),
                 "rad_w1": ((32, n_paths * C), None)}
        for l in range(cfg.l_max + 1):
            layer[f"self_{l}"] = ((C, C), 1.0 / C**0.5)
        layer["gate_w"] = ((C, cfg.l_max * C), None)
        specs[f"layer_{i}"] = layer
    out_dim = cfg.n_classes if cfg.task == "node_class" else 1
    specs["head0"] = ((C, C), None)
    specs["head1"] = ((C, out_dim), None)
    return specs


def param_axes(cfg: NequIPConfig) -> dict:
    """The logical axes of each parameter, the reference ``init``'s."""
    layer = {"rad_w0": (None, None), "rad_w1": (None, "mlp"),
             **{f"self_{l}": ("mlp", "mlp") for l in range(cfg.l_max + 1)},
             "gate_w": ("mlp", None)}
    return {"embed": ("embed_fsdp", "mlp"),
            **{f"layer_{i}": dict(layer) for i in range(cfg.n_layers)},
            "head0": ("mlp", "mlp"), "head1": ("mlp", None)}


def init(cfg: NequIPConfig, generator: torch.Generator,
         device=None) -> dict:
    """Random parameters on ``device`` (CUDA by default) with the
    reference's distribution; ``convert.nequip_from_numpy`` carries the
    reference's own numbers."""
    return cm.init_tree(param_specs(cfg), generator, resolve_device(device))


_FILTERS: dict = {}


def _filters(l_max: int, device, dtype):
    """Per l_in, the matrix that maps an edge's harmonics [Y_0, …, Y_lmax]
    (Σ_l (2l+1) values) to the (i, o) blocks Σ_f Y_f[f] C[i, f, o] of every
    path out of l_in side by side, as a (Σ_l (2l+1), (2l_in+1)·O) matrix (O
    those paths' output widths summed; the CG tensors rounded to ``dtype``
    as ``e3.cg_torch`` rounds them), and each path's (index in
    ``e3.paths(l_max)``, l_out, first column). Built once per (l_max,
    device, dtype)."""
    key = (l_max, torch.device(device), dtype)
    if key not in _FILTERS:
        f_off = np.cumsum([0] + [e3.dim(l) for l in range(l_max + 1)])
        tables = {}
        for l_in in range(l_max + 1):
            out = [(pi, p[1], p[2]) for pi, p in enumerate(e3.paths(l_max))
                   if p[0] == l_in]
            width = sum(e3.dim(l_out) for _, _, l_out in out)
            M = np.zeros((f_off[-1], e3.dim(l_in), width))
            cols, off = [], 0
            for pi, l_f, l_out in out:
                M[f_off[l_f]:f_off[l_f + 1], :, off:off + e3.dim(l_out)] = \
                    e3.cg(l_in, l_f, l_out).transpose(1, 0, 2)
                cols.append((pi, l_out, off))
                off += e3.dim(l_out)
            tables[l_in] = (torch.from_numpy(M.reshape(f_off[-1], -1)).to(
                device=device, dtype=dtype), cols)
        _FILTERS[key] = tables
    return _FILTERS[key]


def _messages(lp, cfg: NequIPConfig, gc: G.Graph, feats):
    """One chunk's messages {l_out: (E, 2l_out+1, C)}, summed over the
    paths into each l_out (channels last, so that each path's slice of the
    batched product and its radial scaling read whole rows of C)."""
    C = cfg.d_hidden
    rbf, sh_edges = e3.edge_basis(gc, cfg.l_max, cfg.n_rbf, cfg.cutoff)
    n_e = rbf.shape[0]
    rw = (F.silu(rbf @ lp["rad_w0"]) @ lp["rad_w1"]).view(
        n_e, len(e3.paths(cfg.l_max)), C)               # (E, paths, C)
    y = torch.cat(sh_edges, dim=1)                      # (E, Σ 2l+1)
    msgs = {}
    for l_in, (M, cols) in _filters(cfg.l_max, rw.device, rw.dtype).items():
        # Every path out of l_in at once: (O × i)·(i × C) an edge.
        t = (y @ M).view(n_e, e3.dim(l_in), -1)            # (E, i, O)
        u = torch.bmm(t.transpose(1, 2),
                      G.gather_src(gc, feats[l_in]).transpose(1, 2))
        for pi, l_out, off in cols:                        # u: (E, O, C)
            part, w = u[:, off:off + e3.dim(l_out)], rw[:, pi, None, :]
            msgs[l_out] = part * w if l_out not in msgs else torch.addcmul(
                msgs[l_out], part, w)
        del u
    return msgs


def _interact(lp, cfg: NequIPConfig, g: G.Graph, feats, n: int):
    C = cfg.d_hidden
    part = G.Partition(g, n, positions=True)
    rad = {k: part.weight(lp[k]) for k in ("rad_w0", "rad_w1")}
    src = {l: part.nodes(f) for l, f in feats.items()}
    agg = {l: f.new_zeros((n + 1, f.shape[2], C)) for l, f in src.items()}
    for _, gc in part.chunks(EDGE_CHUNK):
        msgs = _messages(rad, cfg, gc, src)
        for l, m in msgs.items():
            G.scatter_add_(agg[l], gc, m)
        del msgs
    out = {}
    for l in range(cfg.l_max + 1):
        # The reference's einsum("nci,cd->ndi") with the channels last.
        mixed = (part.sum(agg.pop(l)) / cfg.avg_neighbors**0.5) @ G.whole(
            lp[f"self_{l}"])
        out[l] = feats[l] + mixed.transpose(1, 2)
    # Gated nonlinearity: scalars → silu; higher l scaled by sigmoid gates.
    scal = out[0][:, :, 0]
    gates = torch.sigmoid(scal @ G.whole(lp["gate_w"])).view(n, cfg.l_max,
                                                             C)
    new = {0: F.silu(scal)[:, :, None]}
    for l in range(1, cfg.l_max + 1):
        new[l] = out[l] * gates[:, l - 1][:, :, None]
    return new


def _embed(params, cfg, g: G.Graph):
    """The first layer's irrep dict: the embedded scalars, zeros for
    l ≥ 1."""
    feats = {0: (g.node_feat @ G.whole(params["embed"]))[:, :, None]}
    for l in range(1, cfg.l_max + 1):
        feats[l] = G.node_zeros(feats[0], feats[0].shape[1], e3.dim(l))
    return feats


def forward(params, cfg: NequIPConfig, g: G.Graph):
    """The irrep dict {l: (N, C, 2l+1)} after the interaction blocks;
    differentiable in ``params``."""
    n = g.node_mask.shape[0]
    feats = _embed(params, cfg, g)
    for i in range(cfg.n_layers):
        feats = _interact(params[f"layer_{i}"], cfg, g, feats, n)
    return feats


@torch.no_grad()
def apply(params, cfg: NequIPConfig, g: G.Graph):
    """Inference: ``forward`` without gradients."""
    return forward(params, cfg, g)


def loss_fn(params, cfg: NequIPConfig, g: G.Graph):
    """``graph.task_loss`` of the scalar readout silu(s·W0)·W1."""
    scal = forward(params, cfg, g)[0][:, :, 0]
    out = F.silu(scal @ G.whole(params["head0"])) @ G.whole(params["head1"])
    return G.task_loss(out, g, cfg.task)
