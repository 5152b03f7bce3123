"""Graph container and message-passing primitives over an edge list
(counterpart of ``repro.models.gnn.graph``).

Graphs are padded and fixed-shape: an invalid edge has ``src == -1`` and
scatters into a ghost row ``n_nodes`` that is dropped. The reference's
TPU-mesh sharding pins (``_pin_edges``, ``_pin_nodes``, ``constrain_graph``)
have no counterpart here.

Two behaviours of the reference are kept on purpose:

- ``gather_dst`` masks on ``edge_dst >= 0``, not on ``src``, so a padding
  edge (``src = -1``, ``dst = 0``) gathers node 0's value; only
  ``edge_softmax``'s ``edge_valid`` mask removes it.
- ``scatter_max`` maps every non-finite result, an empty segment's
  ``-inf`` included, to ``fill``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Graph:
    """Padded graph batch; every field a tensor on one device."""

    node_feat: torch.Tensor | None   # (N, F) f32
    positions: torch.Tensor | None   # (N, 3) f32, geometric models only
    edge_src: torch.Tensor           # (E,) int32, -1 = padding
    edge_dst: torch.Tensor           # (E,) int32
    node_mask: torch.Tensor          # (N,) bool
    labels: torch.Tensor             # (N,) int32 node labels or (G,) targets
    graph_ids: torch.Tensor | None = None  # (N,) int32 for batched graphs


def edge_valid(g: Graph) -> torch.Tensor:
    return g.edge_src >= 0


def _per_edge(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.view((-1,) + (1,) * (ndim - 1))


def _gather(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    ok = idx >= 0
    out = x[torch.where(ok, idx, 0)]
    return out.masked_fill_(~_per_edge(ok, out.dim()), 0)


def gather_src(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """x[src], 0 on padding edges. x: (N, ...) → (E, ...)."""
    return _gather(g.edge_src, x)


def gather_dst(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """x[dst], 0 where ``dst < 0`` (masked on dst, as in the reference)."""
    return _gather(g.edge_dst, x)


def edge_chunks(g: Graph, size: int):
    """(lo, graph) for each run of ``size`` edges: the graph with only
    those edges (views of ``g``'s), every node field as it is."""
    for lo in range(0, g.edge_src.shape[0], size):
        yield lo, dataclasses.replace(g, edge_src=g.edge_src[lo:lo + size],
                                      edge_dst=g.edge_dst[lo:lo + size])


def _ghost_dst(g: Graph, n_nodes: int) -> torch.Tensor:
    """Each edge's segment: its dst, or the ghost row for padding edges."""
    return torch.where(g.edge_src >= 0, g.edge_dst.long(), n_nodes)


def scatter_add_(out: torch.Tensor, g: Graph,
                 messages: torch.Tensor) -> torch.Tensor:
    """Add each valid edge's message into ``out[dst]`` in place; ``out``
    has ``n_nodes + 1`` rows, the last the ghost row."""
    return out.index_add_(0, _ghost_dst(g, out.shape[0] - 1), messages)


def scatter_sum(g: Graph, messages: torch.Tensor,
                n_nodes: int) -> torch.Tensor:
    """Σ over incoming edges. messages: (E, ...) → (N, ...)."""
    out = messages.new_zeros((n_nodes + 1,) + messages.shape[1:])
    return scatter_add_(out, g, messages)[:n_nodes]


def scatter_max(g: Graph, messages: torch.Tensor, n_nodes: int,
                fill: float = -math.inf) -> torch.Tensor:
    """Max over incoming edges; ``fill`` where the result is not finite
    (an empty segment's -inf included)."""
    dst = _per_edge(_ghost_dst(g, n_nodes), messages.dim())
    out = messages.new_full((n_nodes + 1,) + messages.shape[1:], -math.inf)
    out.scatter_reduce_(0, dst.expand_as(messages), messages, "amax",
                        include_self=False)
    out = out[:n_nodes]
    return torch.where(torch.isfinite(out), out, fill)


def in_degree(g: Graph, n_nodes: int, dtype=torch.float32) -> torch.Tensor:
    """(N, 1) count of each node's valid in-edges, the denominator of
    ``scatter_mean`` (exact integers in ``dtype``, so any order of the
    count gives the same)."""
    deg = torch.bincount(_ghost_dst(g, n_nodes), minlength=n_nodes + 1)
    return deg[:n_nodes, None].to(dtype)


def scatter_mean(g: Graph, messages: torch.Tensor,
                 n_nodes: int) -> torch.Tensor:
    s = scatter_sum(g, messages, n_nodes)
    deg = scatter_sum(g, messages.new_ones((messages.shape[0], 1)), n_nodes)
    return s / torch.clamp(deg, min=1.0)


def edge_softmax(g: Graph, logits: torch.Tensor,
                 n_nodes: int) -> torch.Tensor:
    """Softmax of edge logits over each destination's incoming edges."""
    mx = scatter_max(g, logits, n_nodes, fill=0.0)
    # exp(-inf) = 0 on padding edges; the fill is on exp's input, which
    # autograd does not keep, so the softmax stays differentiable.
    shifted = logits - gather_dst(g, mx)
    ex = torch.exp(shifted.masked_fill_(
        ~_per_edge(edge_valid(g), shifted.dim()), -math.inf))
    den = scatter_sum(g, ex, n_nodes)
    return ex / torch.clamp(gather_dst(g, den), min=1e-30)


def radial_basis(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Gaussian RBF × smooth cosine cutoff envelope. r: (E,) → (E, n_rbf)."""
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=r.dtype,
                             device=r.device)
    width = cutoff / n_rbf
    rb = torch.exp(-((r[:, None] - centers[None, :]) ** 2) / (2 * width**2))
    env = 0.5 * (torch.cos(math.pi * torch.clamp(r / cutoff, 0, 1)) + 1.0)
    return rb * env[:, None]


def task_loss(out: torch.Tensor, g: Graph, task: str):
    """The reference models' readout loss of per-node outputs ``out``.
    ``graph_reg``: mean squared error of each graph's summed live-node
    outputs ``out[:, 0]`` against its target. ``node_class``: mean
    cross-entropy over the live nodes with a label ≥ 0. Returns (loss,
    {"loss"})."""
    if task == "graph_reg":
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
