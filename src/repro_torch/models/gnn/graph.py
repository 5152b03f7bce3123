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


def scatter_mean(g: Graph, messages: torch.Tensor,
                 n_nodes: int) -> torch.Tensor:
    s = scatter_sum(g, messages, n_nodes)
    deg = scatter_sum(g, messages.new_ones((messages.shape[0], 1)), n_nodes)
    return s / torch.clamp(deg, min=1.0)


def edge_softmax(g: Graph, logits: torch.Tensor,
                 n_nodes: int) -> torch.Tensor:
    """Softmax of edge logits over each destination's incoming edges."""
    mx = scatter_max(g, logits, n_nodes, fill=0.0)
    ex = torch.exp(logits - gather_dst(g, mx))
    ex = ex.masked_fill_(~_per_edge(edge_valid(g), ex.dim()), 0.0)
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
