"""GAT (Velickovic et al., arXiv:1710.10903): attention message passing
(counterpart of ``repro.models.gnn.gat``).

Edge scores a_src·h_i + a_dst·h_j, a softmax over each node's incoming
edges, and the attention-weighted sum of the neighbours' features, all
with the segment ops of ``graph`` as in the reference (whose ``apply``
never calls the ``neigh_softmax_agg`` kernel; neither does this one).
``forward`` is differentiable and ``loss_fn`` trains through it;
``apply`` is the same forward for inference, without gradients.

Messages are formed and scattered in chunks of ``EDGE_CHUNK`` edges: at
ogbn-products scale (61,859,140 edges, 8 heads, 47 classes) the last
layer's (E, H, d) message tensor alone would take 93 GB in f32, more than
the card holds. A chunk of 2**23 edges takes 12.6 GB there. The sum is the
same up to float order. Without gradients a chunk's messages are scaled in
place (one chunk's buffer); with them, out of place, since autograd keeps
the gathered features for the backward.

Laid over a mesh (``param_axes``, ``graph.Partition``), each rank
aggregates its own edges, ``EDGE_CHUNK`` at a time, from the layer's
projected features all-gathered once, and the partial sums are
reduce-scattered to the nodes' layout; each weight is taken whole where it
is used (``graph.whole``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.types import resolve_device
from repro_torch.models import common as cm
from repro_torch.models.gnn import graph as G

EDGE_CHUNK = 1 << 23


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_in: int = 1433
    n_classes: int = 7
    negative_slope: float = 0.2
    task: str = "node_class"      # node_class | graph_reg (pooled)


def layer_shapes(cfg: GATConfig) -> dict[str, dict[str, tuple[int, ...]]]:
    """``{"layer_i": {"w", "a_src", "a_dst"}}`` → each parameter's shape."""
    shapes = {}
    d_prev = cfg.d_in
    out_units = 1 if cfg.task == "graph_reg" else cfg.n_classes
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        d_out = out_units if last else cfg.d_hidden
        shapes[f"layer_{i}"] = {"w": (d_prev, cfg.n_heads, d_out),
                                "a_src": (cfg.n_heads, d_out),
                                "a_dst": (cfg.n_heads, d_out)}
        d_prev = d_out if last else d_out * cfg.n_heads
    return shapes


def init(cfg: GATConfig, generator: torch.Generator,
         device=None) -> dict[str, dict[str, torch.Tensor]]:
    """Random parameters on ``device`` (CUDA by default) with the
    reference's distribution: normal × 1/√shape[0]. The numbers differ from
    ``jax.random``'s; ``convert.gat_from_numpy`` carries the reference's."""
    return cm.init_tree(layer_shapes(cfg), generator, resolve_device(device))


def param_axes(cfg: GATConfig) -> dict:
    """The logical axes of each parameter, the reference ``init``'s."""
    return {name: {"w": ("embed_fsdp", "heads", None),
                   "a_src": ("heads", None), "a_dst": ("heads", None)}
            for name in layer_shapes(cfg)}


def aggregate(g: G.Graph, alpha: torch.Tensor, hw: torch.Tensor,
              n_nodes: int) -> torch.Tensor:
    """Σ over incoming edges of alpha · hw[src]: (E, H), (N, H, d) →
    (N, H, d), EDGE_CHUNK edges (of the rank's own) at a time (without
    gradients the messages are scaled in place to keep one chunk's
    buffer)."""
    part = G.Partition(g, n_nodes)
    src, alpha = part.nodes(hw), part.edges(alpha)
    out = src.new_zeros((n_nodes + 1,) + src.shape[1:])
    in_place = not torch.is_grad_enabled()
    for lo, gc in part.chunks(EDGE_CHUNK):
        msgs = G.gather_src(gc, src)
        a = alpha[lo:lo + msgs.shape[0], :, None]
        msgs = msgs.mul_(a) if in_place else msgs * a
        G.scatter_add_(out, gc, msgs)
        del msgs
    return part.sum(out)


def layer_logits(lp, cfg: GATConfig, g: G.Graph, h: torch.Tensor):
    """A layer's projected features hw (N, H, d) and its per-edge attention
    logits after leaky_relu (E, H)."""
    hw = torch.einsum("nf,fhd->nhd", h, G.whole(lp["w"]))  # (N, H, d)
    e_src = torch.einsum("nhd,hd->nh", hw, G.whole(lp["a_src"]))  # (N, H)
    e_dst = torch.einsum("nhd,hd->nh", hw, G.whole(lp["a_dst"]))
    logits = G.gather_src(g, e_src) + G.gather_dst(g, e_dst)
    return hw, F.leaky_relu(logits, cfg.negative_slope)    # (E, H)


def finish_layer(out: torch.Tensor, concat: bool) -> torch.Tensor:
    """(N, H, d) aggregate → ELU of the heads side by side, or their mean
    (the last layer's logits)."""
    if concat:
        return F.elu(out.reshape(out.shape[0], -1))
    return out.mean(dim=1)


def _gat_layer(lp, cfg: GATConfig, g: G.Graph, h: torch.Tensor,
               n_nodes: int, concat: bool):
    hw, logits = layer_logits(lp, cfg, g, h)
    alpha = G.edge_softmax(g, logits, n_nodes)             # (E, H)
    del logits
    return finish_layer(aggregate(g, alpha, hw, n_nodes), concat)


def forward(params, cfg: GATConfig, g: G.Graph) -> torch.Tensor:
    """Full-batch forward: (N, n_classes) logits, or (N, 1) per node for
    ``task="graph_reg"``; differentiable in ``params``."""
    n = g.node_mask.shape[0]
    h = g.node_feat
    for i in range(cfg.n_layers):
        h = _gat_layer(params[f"layer_{i}"], cfg, g, h, n,
                       concat=i < cfg.n_layers - 1)
    return h


@torch.no_grad()
def apply(params, cfg: GATConfig, g: G.Graph) -> torch.Tensor:
    """Full-batch inference: ``forward`` without gradients."""
    return forward(params, cfg, g)


def loss_fn(params, cfg: GATConfig, g: G.Graph):
    """``graph.task_loss`` of the forward's outputs: ``graph_reg`` the
    mean squared error of each graph's summed node outputs, ``node_class``
    the mean cross-entropy over the live labelled nodes. Returns (loss,
    {"loss"})."""
    return G.task_loss(forward(params, cfg, g), g, cfg.task)
