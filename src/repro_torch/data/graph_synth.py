"""Synthetic graph datasets and a neighbour sampler (counterpart of
``repro.data.graph_synth``).

Generation is the reference's host numpy, draw for draw, so for a seed
every array equals the JAX package's bit for bit; only the last step
differs: the arrays become the port's ``Graph`` of tensors on ``device``
(CUDA unless the caller names one). Shapes: cora-scale full graphs,
reddit-scale sampled subgraphs (CSR + fanout sampler), ogbn-products-scale
full-batch graphs and batched small molecules.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.models.gnn.graph import Graph


def _to_graph(src, dst, n_nodes, feat, pos, labels, graph_ids=None,
              e_pad=None, n_pad=None, device=None):
    dev = resolve_device(device)
    E = len(src)
    e_cap = e_pad or E
    n_cap = n_pad or n_nodes
    s = np.full(e_cap, -1, np.int32)
    d = np.zeros(e_cap, np.int32)
    s[:E] = src
    d[:E] = dst
    mask = np.zeros(n_cap, bool)
    mask[:n_nodes] = True

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def padn(x, fill=0.0):
        if x is None:
            return None
        out = np.full((n_cap,) + x.shape[1:], fill, x.dtype)
        out[:n_nodes] = x
        return t(out)

    return Graph(
        node_feat=padn(feat), positions=padn(pos),
        edge_src=t(s), edge_dst=t(d), node_mask=t(mask), labels=t(labels),
        graph_ids=None if graph_ids is None else t(
            np.pad(graph_ids, (0, n_cap - n_nodes))))


def random_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int = 7,
                 seed: int = 0, geometric: bool = True,
                 power_law: bool = True, device=None) -> Graph:
    """A cora-like graph: power-law degrees, features, labels, positions."""
    rng = np.random.default_rng(seed)
    if power_law:
        w = (np.arange(1, n_nodes + 1) ** -0.8)
        p = w / w.sum()
        src = rng.choice(n_nodes, n_edges, p=p).astype(np.int32)
    else:
        src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    feat = rng.standard_normal((n_nodes, d_feat)).astype(np.float32) * 0.2
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    # Make features weakly predictive of labels.
    feat[np.arange(n_nodes), labels % d_feat] += 1.0
    pos = rng.standard_normal((n_nodes, 3)).astype(np.float32) * 2.0 \
        if geometric else None
    return _to_graph(src, dst, n_nodes, feat, pos, labels, device=device)


def molecule_batch(batch: int, n_nodes: int, n_edges: int, d_feat: int = 16,
                   seed: int = 0, device=None) -> Graph:
    """Disjoint union of `batch` small molecules; graph-level targets."""
    rng = np.random.default_rng(seed)
    srcs, dsts, gids = [], [], []
    for b in range(batch):
        s = rng.integers(0, n_nodes, n_edges)
        d = rng.integers(0, n_nodes, n_edges)
        srcs.append(s + b * n_nodes)
        dsts.append(d + b * n_nodes)
        gids.append(np.full(n_nodes, b, np.int32))
    N = batch * n_nodes
    feat = rng.standard_normal((N, d_feat)).astype(np.float32) * 0.3
    pos = rng.standard_normal((N, 3)).astype(np.float32)
    labels = rng.standard_normal(batch).astype(np.float32)  # energies
    return _to_graph(np.concatenate(srcs), np.concatenate(dsts), N, feat,
                     pos, labels, graph_ids=np.concatenate(gids),
                     device=device)


class CSRGraph:
    """Host CSR adjacency for neighbour sampling (reddit-scale training)."""

    def __init__(self, n_nodes: int, src: np.ndarray, dst: np.ndarray,
                 feat: np.ndarray, labels: np.ndarray,
                 pos: np.ndarray | None = None):
        order = np.argsort(dst, kind="stable")
        self.src = src[order]
        self.dst = dst[order]
        self.indptr = np.searchsorted(self.dst, np.arange(n_nodes + 1))
        self.n_nodes = n_nodes
        self.feat = feat
        self.labels = labels
        self.pos = pos

    @classmethod
    def random(cls, n_nodes: int, n_edges: int, d_feat: int,
               n_classes: int = 41, seed: int = 0):
        rng = np.random.default_rng(seed)
        src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
        dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
        feat = rng.standard_normal((n_nodes, d_feat)).astype(np.float32) * 0.2
        labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
        pos = rng.standard_normal((n_nodes, 3)).astype(np.float32)
        return cls(n_nodes, src, dst, feat, labels, pos)

    def sample_subgraph(self, batch_nodes: np.ndarray,
                        fanouts: tuple[int, ...], seed: int = 0,
                        n_pad: int | None = None, e_pad: int | None = None,
                        device=None) -> Graph:
        """Uniform fanout sampling (GraphSAGE-style). Returns a padded Graph
        whose first len(batch_nodes) nodes are the seeds."""
        rng = np.random.default_rng(seed)
        nodes = {int(v): i for i, v in enumerate(batch_nodes)}
        order = list(batch_nodes)
        frontier = list(batch_nodes)
        srcs, dsts = [], []
        for f in fanouts:
            nxt = []
            for v in frontier:
                lo, hi = self.indptr[v], self.indptr[v + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = rng.integers(lo, hi, size=min(f, deg))
                for e in take:
                    u = int(self.src[e])
                    if u not in nodes:
                        nodes[u] = len(order)
                        order.append(u)
                        nxt.append(u)
                    srcs.append(nodes[u])
                    dsts.append(nodes[v])
            frontier = nxt
        order = np.asarray(order, np.int64)
        n_sub = len(order)
        labels = np.full(n_pad or n_sub, -1, np.int32)
        labels[: len(batch_nodes)] = self.labels[batch_nodes]
        feat = self.feat[order]
        pos = None if self.pos is None else self.pos[order]
        return _to_graph(np.asarray(srcs, np.int32),
                         np.asarray(dsts, np.int32), n_sub, feat, pos,
                         labels[: n_pad or n_sub], e_pad=e_pad, n_pad=n_pad,
                         device=device)
