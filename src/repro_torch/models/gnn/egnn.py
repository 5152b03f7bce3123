"""EGNN (Satorras et al., arXiv:2102.09844): E(n)-equivariant GNN
(counterpart of ``repro.models.gnn.egnn``).

Scalar messages from invariant distances, equivariant coordinate updates,
no spherical harmonics. The parameter tree and its distribution are the
reference's: ``embed``, ``layer_i.{edge_mlp, coord_mlp, node_mlp}.w{k}``
and ``head``, each weight normal × 1/√fan_in.

Messages are formed and scattered ``EDGE_CHUNK`` edges at a time: at
ogbn-products scale (61,859,140 edges) the edge MLP's input [h_i, h_j, d²]
alone would take 31.9 GB. A chunk of 2**22 edges holds under 2 KB an edge
at d_hidden 64, under 8.4 GB. The sums are the same up to float order.

One difference from the reference, on purpose: the coordinate message
diff / (|diff| + 1) is differentiable at a zero-length edge (a self-loop),
where its gradient is the identity; the reference's ``jnp.sqrt(d2)`` gives
0 · ∞ = NaN there (``src/repro/models/gnn/egnn.py:75``), and from three
layers on that NaN reaches the weights. ``_edge_len`` computes the same
forward, bit for bit, with the true gradient 0 for |diff| at d² = 0.

Laid over a mesh (``param_axes``, ``graph.Partition``), each rank runs the
edge and coordinate MLPs over its own edges from h and x all-gathered once
a layer, and the partial sums are reduce-scattered to the nodes' layout.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.types import resolve_device
from repro_torch.models import common as cm
from repro_torch.models.gnn import graph as G

EDGE_CHUNK = 1 << 22


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 16
    n_classes: int = 7
    task: str = "graph_reg"       # graph_reg | node_class


def _mlp_specs(dims) -> dict:
    return {f"w{i}": ((dims[i], dims[i + 1]), None)
            for i in range(len(dims) - 1)}


def param_specs(cfg: EGNNConfig) -> dict:
    """The reference's tree: each leaf (shape, scale), scale None for
    1/√fan_in."""
    D = cfg.d_hidden
    specs = {"embed": _mlp_specs((cfg.d_in, D))}
    for i in range(cfg.n_layers):
        specs[f"layer_{i}"] = {
            "edge_mlp": _mlp_specs((2 * D + 1, D, D)),
            "coord_mlp": _mlp_specs((D, D, 1)),
            "node_mlp": _mlp_specs((2 * D, D, D)),
        }
    out_dim = cfg.n_classes if cfg.task == "node_class" else 1
    specs["head"] = _mlp_specs((D, D, out_dim))
    return specs


def _mlp_axes(n: int) -> dict:
    """The reference's ``_mlp_init`` axes: ``embed_fsdp`` and ``mlp`` in
    turn."""
    names = ("embed_fsdp", "mlp")
    return {f"w{i}": (names[i % 2], names[(i + 1) % 2]) for i in range(n)}


def param_axes(cfg: EGNNConfig) -> dict:
    """The logical axes of each parameter, the reference ``init``'s."""
    return {k: (_mlp_axes(len(v)) if "w0" in v else
                {m: _mlp_axes(len(w)) for m, w in v.items()})
            for k, v in param_specs(cfg).items()}


def init(cfg: EGNNConfig, generator: torch.Generator, device=None) -> dict:
    """Random parameters on ``device`` (CUDA by default) with the
    reference's distribution; ``convert.egnn_from_numpy`` carries the
    reference's own numbers."""
    return cm.init_tree(param_specs(cfg), generator, resolve_device(device))


def _mlp(p, x, act_last=False):
    n = len(p)
    for i in range(n):
        x = x @ G.whole(p[f"w{i}"])
        if i < n - 1 or act_last:
            x = F.silu(x, inplace=not torch.is_grad_enabled())
    return x


def _edge_len(d2: torch.Tensor) -> torch.Tensor:
    """√d2, with gradient 0 (not NaN) where d2 = 0."""
    live = d2 > 0
    return torch.where(live, torch.sqrt(torch.where(live, d2, 1.0)), 0.0)


def _layer(lp, g: G.Graph, h, x, deg, n: int):
    """One EGNN layer: (h, x) → (h', x'), messages EDGE_CHUNK edges (of
    the rank's own) at a time."""
    part = G.Partition(g, n)
    hl, xl = part.nodes(h), part.nodes(x)
    edge_mlp, coord_mlp = ({k: part.weight(w) for k, w in lp[m].items()}
                           for m in ("edge_mlp", "coord_mlp"))
    agg = hl.new_zeros((n + 1, hl.shape[1]))
    dx = xl.new_zeros((n + 1, 3))
    for _, gc in part.chunks(EDGE_CHUNK):
        diff = G.gather_dst(gc, xl) - G.gather_src(gc, xl)
        d2 = torch.sum(diff * diff, dim=-1, keepdim=True)
        m = _mlp(edge_mlp, torch.cat(
            [G.gather_dst(gc, hl), G.gather_src(gc, hl), d2], -1),
            act_last=True)                                   # (E, D)
        w = torch.tanh(_mlp(coord_mlp, m))                   # (E, 1)
        # Distance-normalised, tanh-bounded coordinate messages (EGNN eq.
        # 4 with C = 1/(d + 1)), as in the reference.
        G.scatter_add_(dx, gc, diff / (_edge_len(d2) + 1.0) * w)
        G.scatter_add_(agg, gc, m)
        del diff, d2, m, w
    x = x + part.sum(dx) / torch.clamp(deg, min=1.0)
    h = h + _mlp(lp["node_mlp"], torch.cat([h, part.sum(agg)], -1))
    return h, x


def _embed(params, g: G.Graph):
    """The layers' first input: (h, x, in-degree)."""
    x = g.positions
    return (_mlp(params["embed"], g.node_feat, act_last=True), x,
            G.in_degree(g, x.shape[0], x.dtype))


def forward(params, cfg: EGNNConfig, g: G.Graph):
    """(h, x): node features (N, d_hidden) and positions (N, 3) after the
    layers; differentiable in ``params``."""
    n = g.node_mask.shape[0]
    h, x, deg = _embed(params, g)
    for i in range(cfg.n_layers):
        h, x = _layer(params[f"layer_{i}"], g, h, x, deg, n)
    return h, x


@torch.no_grad()
def apply(params, cfg: EGNNConfig, g: G.Graph):
    """Inference: ``forward`` without gradients."""
    return forward(params, cfg, g)


def loss_fn(params, cfg: EGNNConfig, g: G.Graph):
    """``graph.task_loss`` of the head's per-node outputs."""
    h, _ = forward(params, cfg, g)
    return G.task_loss(_mlp(params["head"], h), g, cfg.task)
