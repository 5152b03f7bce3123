"""Graph container and message-passing primitives over an edge list
(counterpart of ``repro.models.gnn.graph``).

Graphs are padded and fixed-shape: an invalid edge has ``src == -1`` and
scatters into a ghost row ``n_nodes`` that is dropped.

Sharding. Under installed rules (``repro_torch.sharding``) a graph's
arrays are DTensors: nodes split over ``graph_nodes``, edges over
``graph_edges`` (both ``("pod", "data")``), each only where the axes
divide its length (the reference's divisibility rule). The reference pins
nothing (its ``_pin_edges`` and ``_pin_nodes`` are identities) and leaves
the plan to GSPMD; its docstrings name the plan this module runs by hand,
on each rank's local shards, with named collectives (``Partition``): the
node array that edges gather from is all-gathered once over the node axes;
each rank gathers for its own edges and adds their messages into a local
(N + 1, …) buffer; the partial buffers are reduce-scattered to the node
layout (all-reduced where the nodes are replicated and the edges are not).
A maximum is a local amax, then an all-reduce MAX. Node-level products
take each weight whole (``whole``): the GNNs' widths (8 heads, 32–128
channels) are too narrow to split a node's features over the model axis,
which would all-reduce every (N, C) product; so node arrays split over
their rows only, and the model axis repeats the node work. DTensor's own
rules for ``index``, ``index_add_`` and ``scatter_reduce`` are not used:
they differ between PyTorch releases and would replicate the messages.
With no rules installed, or on plain tensors, every primitive is today's
single-card code, bit for bit.

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

from repro_torch import sharding


@dataclasses.dataclass(frozen=True)
class Graph:
    """Padded graph batch; every field a tensor on one device (or, laid
    over a mesh, a DTensor)."""

    node_feat: torch.Tensor | None   # (N, F) f32
    positions: torch.Tensor | None   # (N, 3) f32, geometric models only
    edge_src: torch.Tensor           # (E,) int32, -1 = padding
    edge_dst: torch.Tensor           # (E,) int32
    node_mask: torch.Tensor          # (N,) bool
    labels: torch.Tensor             # (N,) int32 node labels or (G,) targets
    graph_ids: torch.Tensor | None = None  # (N,) int32 for batched graphs


def as_dict(g: Graph) -> dict:
    """The fields by name (a shallow copy: the same tensors)."""
    return {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}


def constrain_graph(g: Graph) -> Graph:
    """Lay a graph's fields out as ``gnn_common.graph_axes`` names them
    (the reference's production-mesh annotations, labels and graph ids
    left as they are); the identity with no rules installed."""
    c = sharding.constrain

    def nodes(x):
        return None if x is None else c(x, "graph_nodes", None)

    return Graph(node_feat=nodes(g.node_feat), positions=nodes(g.positions),
                 edge_src=c(g.edge_src, "graph_edges"),
                 edge_dst=c(g.edge_dst, "graph_edges"),
                 node_mask=c(g.node_mask, "graph_nodes"), labels=g.labels,
                 graph_ids=g.graph_ids)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _replicate(mesh) -> list:
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


def whole(w: torch.Tensor) -> torch.Tensor:
    """A weight at a node-level use: gathered whole over every mesh axis
    that splits it (its FSDP and model shards; see the module's
    docstring). A plain tensor as it is."""
    if not _is_dtensor(w):
        return w
    return w.redistribute(w.device_mesh, _replicate(w.device_mesh))


def node_zeros(like: torch.Tensor, *tail: int) -> torch.Tensor:
    """Zeros of (N, *tail) laid out as the node array ``like``."""
    if not _is_dtensor(like):
        return like.new_zeros((like.shape[0],) + tail)
    from torch.distributed.tensor import DTensor
    local = like.to_local()
    return DTensor.from_local(local.new_zeros((local.shape[0],) + tail),
                              like.device_mesh, like.placements,
                              run_check=False)


class _AllReduceMax(torch.autograd.Function):
    """Elementwise maximum over the ranks of ``groups``; the gradient of
    the (replicated) result goes to the ranks that hold the maximum,
    split evenly where several do."""

    @staticmethod
    def forward(ctx, x, groups):
        y = x
        for grp in groups:
            y = _all_reduce(y, "max", grp)
        ctx.groups = groups
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, y = ctx.saved_tensors
        hit = (x == y).to(gy.dtype)
        count = hit
        for grp in ctx.groups:
            count = _all_reduce(count, "sum", grp)
        return gy * hit / torch.clamp(count, min=1.0), None


def _all_reduce(x, op: str, group):
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(x, op, group))


class Partition:
    """A rank's share of the message passing over ``g`` and its
    ``n_nodes`` nodes.

    On a graph of plain tensors every method is the identity of the
    single-card code (``local`` is ``g``, ``chunks`` its
    ``edge_chunks``, ``sum`` a buffer's first ``n_nodes`` rows). On a
    graph of DTensors:

    * ``nodes(x)``: the node array all-gathered over the axes that split
      it, as the rank's local tensor (its gradient partial over the edge
      axes: each rank's edges add their part);
    * ``edges(e)``, ``local``: the rank's own edges, plain tensors
      (``local`` a ``Graph`` of its edge ids, and with ``positions`` the
      gathered positions);
    * ``weight(w)``: a weight whole, as a local tensor whose gradient is
      partial over the edge axes;
    * ``sum(buf)``: a local (N + 1, …) buffer of this rank's messages →
      the (N, …) node array: reduce-scattered over the edge axes that
      split the nodes too, all-reduced over those that do not, sliced
      over node axes the edges do not split;
    * ``max(buf, fill)``: the same for a local amax buffer, all-reduced
      MAX, the result replicated;
    * ``rows(x)``, ``from_rows(t)``, ``n_rows``, ``row_weight(w)``: a node
      array's local rows and back, for work that is row by row; ``total``
      sums a per-rank partial over the node axes.
    """

    def __init__(self, g: Graph, n_nodes: int, positions: bool = False):
        self.n = n_nodes
        self.sharded = _is_dtensor(g.edge_src)
        if not self.sharded:
            self.local = g
            self.n_rows = n_nodes
            self._partial_edges = self._partial_nodes = None
            return
        from torch.distributed.tensor import Partial, Replicate, Shard
        self.mesh = mesh = g.edge_src.device_mesh
        # 1-D arrays: each mesh axis splits them (Shard(0)) or not.
        self.edge_where = tuple(g.edge_src.placements)
        self.node_where = tuple(g.node_mask.placements)
        self._partial_edges = [Partial() if isinstance(p, Shard)
                               else Replicate() for p in self.edge_where]
        self._partial_nodes = [Partial() if isinstance(p, Shard)
                               else Replicate() for p in self.node_where]
        self._edge_groups = [mesh.get_group(m) for m, p in
                             enumerate(self.edge_where)
                             if isinstance(p, Shard)]
        self.n_rows = g.node_mask.to_local().shape[0]
        self.local = Graph(
            node_feat=None,
            positions=self.nodes(g.positions) if positions else None,
            edge_src=self.edges(g.edge_src), edge_dst=self.edges(g.edge_dst),
            node_mask=None, labels=None)

    # -- edges

    def nodes(self, x):
        if not self.sharded or not _is_dtensor(x):
            return x
        return x.redistribute(self.mesh, _replicate(self.mesh)).to_local(
            grad_placements=self._partial_edges)

    def edges(self, e):
        if not self.sharded or not _is_dtensor(e):
            return e
        return e.redistribute(self.mesh, self.edge_where).to_local()

    def weight(self, w):
        return self._whole_local(w, self._partial_edges)

    def _whole_local(self, w, grad_placements):
        if not self.sharded or not _is_dtensor(w):
            return w
        return w.redistribute(w.device_mesh, _replicate(w.device_mesh)) \
            .to_local(grad_placements=grad_placements)

    def chunks(self, size: int):
        """(lo, graph) for each run of ``size`` of the rank's edges."""
        return edge_chunks(self.local, size)

    def to_edges(self, t):
        """A local (E_rank, …) tensor → the edge array it is a shard of."""
        if not self.sharded:
            return t
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(t, self.mesh, self.edge_where,
                                  run_check=False)

    def sum(self, buf):
        if not self.sharded:
            return buf[:self.n]
        from torch.distributed.tensor import DTensor
        part = DTensor.from_local(buf[:self.n], self.mesh,
                                  self._partial_edges, run_check=False)
        return part.redistribute(self.mesh, self.node_where)

    def max(self, buf, fill: float):
        out = buf[:self.n]
        if self.sharded and self._edge_groups:
            out = _AllReduceMax.apply(out, tuple(self._edge_groups))
        out = torch.where(torch.isfinite(out), out, fill)
        if not self.sharded:
            return out
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(out, self.mesh, _replicate(self.mesh),
                                  run_check=False)

    # -- node rows

    def rows(self, x):
        if not self.sharded or not _is_dtensor(x):
            return x
        return x.redistribute(self.mesh, self.node_where).to_local()

    def from_rows(self, t):
        if not self.sharded:
            return t
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(t, self.mesh, self.node_where,
                                  run_check=False)

    def row_weight(self, w):
        return self._whole_local(w, self._partial_nodes)

    def total(self, t):
        """A per-rank partial (a sum over the rank's rows) → its total over
        the node axes, replicated."""
        if not self.sharded:
            return t
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(t, self.mesh, self._partial_nodes,
                                  run_check=False).redistribute(
            self.mesh, _replicate(self.mesh))


def edge_valid(g: Graph) -> torch.Tensor:
    return g.edge_src >= 0


def _per_edge(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.view((-1,) + (1,) * (ndim - 1))


def _gather(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    ok = idx >= 0
    out = x[torch.where(ok, idx, 0)]
    return out.masked_fill_(~_per_edge(ok, out.dim()), 0)


def _gather_by(g: Graph, field: str, x: torch.Tensor) -> torch.Tensor:
    if not _is_dtensor(g.edge_src):
        return _gather(getattr(g, field), x)
    part = Partition(g, x.shape[0])
    return part.to_edges(_gather(getattr(part.local, field), part.nodes(x)))


def gather_src(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """x[src], 0 on padding edges. x: (N, ...) → (E, ...)."""
    return _gather_by(g, "edge_src", x)


def gather_dst(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """x[dst], 0 where ``dst < 0`` (masked on dst, as in the reference)."""
    return _gather_by(g, "edge_dst", x)


def edge_chunks(g: Graph, size: int):
    """(lo, graph) for each run of ``size`` edges: the graph with only
    those edges (views of ``g``'s), every node field as it is. For a graph
    of plain tensors: a sharded graph's chunks are its ``Partition``'s,
    over the rank's own edges (slicing a split DTensor would gather it)."""
    for lo in range(0, g.edge_src.shape[0], size):
        yield lo, dataclasses.replace(g, edge_src=g.edge_src[lo:lo + size],
                                      edge_dst=g.edge_dst[lo:lo + size])


def _ghost_dst(g: Graph, n_nodes: int) -> torch.Tensor:
    """Each edge's segment: its dst, or the ghost row for padding edges."""
    return torch.where(g.edge_src >= 0, g.edge_dst.long(), n_nodes)


def scatter_add_(out: torch.Tensor, g: Graph,
                 messages: torch.Tensor) -> torch.Tensor:
    """Add each valid edge's message into ``out[dst]`` in place; ``out``
    has ``n_nodes + 1`` rows, the last the ghost row (plain tensors: a
    chunk loop's local buffer)."""
    return out.index_add_(0, _ghost_dst(g, out.shape[0] - 1), messages)


def scatter_sum(g: Graph, messages: torch.Tensor,
                n_nodes: int) -> torch.Tensor:
    """Σ over incoming edges. messages: (E, ...) → (N, ...)."""
    part = Partition(g, n_nodes)
    m = part.edges(messages)
    out = m.new_zeros((n_nodes + 1,) + m.shape[1:])
    return part.sum(scatter_add_(out, part.local, m))


def scatter_max(g: Graph, messages: torch.Tensor, n_nodes: int,
                fill: float = -math.inf) -> torch.Tensor:
    """Max over incoming edges; ``fill`` where the result is not finite
    (an empty segment's -inf included). Sharded: replicated."""
    part = Partition(g, n_nodes)
    m = part.edges(messages)
    dst = _per_edge(_ghost_dst(part.local, n_nodes), m.dim())
    out = m.new_full((n_nodes + 1,) + m.shape[1:], -math.inf)
    out.scatter_reduce_(0, dst.expand_as(m), m, "amax", include_self=False)
    return part.max(out, fill)


def in_degree(g: Graph, n_nodes: int, dtype=torch.float32) -> torch.Tensor:
    """(N, 1) count of each node's valid in-edges, the denominator of
    ``scatter_mean``: an ``index_add_`` of ones (exact integers in
    ``dtype``, so any order of the count gives the same; ``bincount``'s
    output shape depends on the data, which fake tensors refuse)."""
    part = Partition(g, n_nodes)
    gl = part.local
    deg = torch.zeros((n_nodes + 1, 1), dtype=dtype,
                      device=gl.edge_src.device)
    deg.index_add_(0, _ghost_dst(gl, n_nodes),
                   deg.new_ones((gl.edge_src.shape[0], 1)))
    return part.sum(deg)


def scatter_mean(g: Graph, messages: torch.Tensor,
                 n_nodes: int) -> torch.Tensor:
    s = scatter_sum(g, messages, n_nodes)
    deg = in_degree(g, n_nodes, messages.dtype)
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
    {"loss"}). Sharded, each rank sums over its own rows (the negative
    log-likelihoods and their count, or each graph's energy over
    ``graph_ids``) and the sums are all-reduced."""
    part = Partition(g, g.node_mask.shape[0])
    out, node_mask = part.rows(out), part.rows(g.node_mask)
    if task == "graph_reg":
        n_graphs = int(g.labels.shape[0])
        ids = part.rows(g.graph_ids) if g.graph_ids is not None else \
            torch.zeros((out.shape[0],), dtype=torch.int32,
                        device=out.device)
        energy = part.total(out.new_zeros((n_graphs,)).index_add(
            0, ids.long(), out[:, 0] * node_mask))
        loss = torch.mean((energy - g.labels.float()) ** 2)
        return loss, {"loss": loss}
    labels = part.rows(g.labels)
    mask = node_mask & (labels >= 0)
    labels = torch.where(mask, labels, 0).long()
    logp = F.log_softmax(out.float(), dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    loss = part.total(torch.sum(nll * mask)) / torch.clamp(
        part.total(torch.sum(mask)), min=1)
    return loss, {"loss": loss}
