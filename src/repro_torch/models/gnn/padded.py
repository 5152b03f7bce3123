"""The padded-degree layout that ``kernels.ops.neigh_softmax_agg`` takes:
each node's valid in-edges in edge order, one row a (node, head), MAXD
slots a row. ``gat.apply`` does not use it (it keeps the reference's
segment ops); the tests and ``chip_smoke.py`` feed the kernel a GAT
layer's own logits and features through it.
"""
from __future__ import annotations

import torch

from repro_torch.models.gnn.graph import Graph


def padded_layout(g: Graph, n_nodes: int) -> torch.Tensor:
    """Each node's valid in-edges in edge order (a stable sort by dst) as a
    (N, MAXD) table of edge ids, -1 past the node's in-degree."""
    eid = torch.nonzero(g.edge_src >= 0).squeeze(1)
    dst, order = torch.sort(g.edge_dst[eid].long(), stable=True)
    eid = eid[order]
    deg = torch.bincount(dst, minlength=n_nodes)
    start = torch.cumsum(deg, 0) - deg
    slot = torch.arange(eid.numel(), device=eid.device) - start[dst]
    slots = torch.full((n_nodes, max(int(deg.max()), 1) if n_nodes else 1),
                       -1, dtype=torch.long, device=eid.device)
    slots[dst, slot] = eid
    return slots


def agg_rows(g: Graph, slots: torch.Tensor, logits: torch.Tensor,
             hw: torch.Tensor, lo: int, hi: int):
    """neigh_softmax_agg's inputs for nodes [lo, hi) of one GAT layer, one
    row a (node, head): the in-edges' logits (n·H, MAXD), their sources'
    projected features (n·H, MAXD, d) and the live slots (n·H, MAXD)."""
    sl = slots[lo:hi]
    n, maxd = sl.shape
    H, d = hw.shape[1:]
    e = sl.clamp(min=0)
    lg = logits[e].permute(0, 2, 1).reshape(n * H, maxd)
    ft = hw[g.edge_src[e]].permute(0, 2, 1, 3).reshape(n * H, maxd, d)
    mk = (sl >= 0)[:, None, :].expand(n, H, maxd).reshape(n * H, maxd)
    return lg, ft, mk
