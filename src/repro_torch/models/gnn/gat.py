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
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core.types import resolve_device
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
    dev = resolve_device(device)
    return {name: {k: torch.randn(shape, generator=generator, device=dev)
                   / math.sqrt(max(shape[0], 1))
                   for k, shape in layer.items()}
            for name, layer in layer_shapes(cfg).items()}


def aggregate(g: G.Graph, alpha: torch.Tensor, hw: torch.Tensor,
              n_nodes: int) -> torch.Tensor:
    """Σ over incoming edges of alpha · hw[src]: (E, H), (N, H, d) →
    (N, H, d), EDGE_CHUNK edges at a time (without gradients the messages
    are scaled in place to keep one chunk's buffer)."""
    n_edges, chunk = g.edge_src.shape[0], EDGE_CHUNK
    out = hw.new_zeros((n_nodes + 1,) + hw.shape[1:])
    in_place = not torch.is_grad_enabled()
    for lo in range(0, n_edges, chunk):
        gc = dataclasses.replace(g, edge_src=g.edge_src[lo:lo + chunk],
                                 edge_dst=g.edge_dst[lo:lo + chunk])
        msgs, a = G.gather_src(gc, hw), alpha[lo:lo + chunk, :, None]
        msgs = msgs.mul_(a) if in_place else msgs * a
        G.scatter_add_(out, gc, msgs)
        del msgs
    return out[:n_nodes]


def layer_logits(lp, cfg: GATConfig, g: G.Graph, h: torch.Tensor):
    """A layer's projected features hw (N, H, d) and its per-edge attention
    logits after leaky_relu (E, H)."""
    hw = torch.einsum("nf,fhd->nhd", h, lp["w"])           # (N, H, d)
    e_src = torch.einsum("nhd,hd->nh", hw, lp["a_src"])    # (N, H)
    e_dst = torch.einsum("nhd,hd->nh", hw, lp["a_dst"])
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
    """``graph_reg``: mean squared error of each graph's summed node
    outputs against its target. ``node_class``: mean cross-entropy over
    the live nodes with a label ≥ 0. Returns (loss, {"loss"})."""
    out = forward(params, cfg, g)
    if cfg.task == "graph_reg":
        n_graphs = int(g.labels.shape[0])
        ids = g.graph_ids if g.graph_ids is not None else torch.zeros(
            (out.shape[0],), dtype=torch.int32, device=out.device)
        energy = out.new_zeros((n_graphs,)).index_add(
            0, ids.long(), out[:, 0] * g.node_mask)
        loss = torch.mean((energy - g.labels.float()) ** 2)
        return loss, {"loss": loss}
    mask = g.node_mask & (g.labels >= 0)
    labels = torch.where(mask, g.labels, 0).long()
    logp = F.log_softmax(out.float(), dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return loss, {"loss": loss}
