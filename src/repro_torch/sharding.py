"""Logical-axis sharding (counterpart of ``repro.sharding``): MaxText-style
rules mapping logical names to mesh axes, over a ``DeviceMesh``.

Models name the axes of their parameters and activations ("batch",
"embed_fsdp", "heads", "kv_seq", ...). A launcher installs a rules table
and a mesh; ``constrain`` then lays a ``DTensor`` out as the names say, by
``redistribute``, as GSPMD's ``with_sharding_constraint`` does, and
``distribute`` places a parameter tree by its axes, as ``jax.device_put``
under ``in_shardings`` does. With no rules installed, or on a plain
tensor, every call is the identity: the models run unchanged on one card.

Where a DTensor program needs a layout that GSPMD finds by itself, the
port names it: ``pin_weight`` gathers an FSDP weight where it is used,
``update_slice`` writes a decode cache's ring slot on its own shard, and
``on_shards`` runs an op on each rank's shards where DTensor's own rule
would leave a layout its later ops cannot take. The installed mesh and
rules are the process's, not a thread's (autograd's CUDA thread reads them
in a remat recompute).

A spec is a tuple with one entry per dimension: None (replicated), a mesh
axis name, or a tuple of names (the dimension split over several axes,
major first), as a ``PartitionSpec`` holds them. ``placements`` turns it
into DTensor placements, one per mesh dimension: ``Shard(d)`` where the
mesh axis splits dimension d, else ``Replicate()``. A dimension split over
two axes takes them in the mesh's order, which is then the tuple's.
"""
from __future__ import annotations

import contextlib
import types
from typing import Any

import torch
from torch import nn

# The installed mesh and rules, for the whole process: autograd runs a
# CUDA backward (and a checkpointed layer's recompute) on a device thread
# of its own, which must lay out its activations as the caller's forward
# did. (The reference keeps them per thread: JAX traces in the caller's.)
_state = types.SimpleNamespace(mesh=None, rules=None)


# Default rules for the production (pod, data, model) / (data, model) mesh:
# the reference's table. "dp" axes shard over data (+ pod), "tp" axes over
# model; the KG engine and the MoE token axis over everything.
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "all_devices": ("pod", "data", "model"),
    "fsdp": ("pod", "data"),
    "embed": None,
    "embed_fsdp": ("pod", "data"),
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "q_lora": "model",
    "kv_lora": None,
    "mlp": "model",
    "expert": ("data", "model"),
    "expert_mlp": "model",
    "seq": None,
    "act_seq": "model",                # sequence-parallel residual stream
    "kv_seq": "model",                 # decode: split-K over cache length
    "moe_tokens": ("pod", "data", "model"),
    "graph_nodes": ("pod", "data"),
    "graph_edges": ("pod", "data"),
    "table_vocab": "model",
    "candidates": ("pod", "data", "model"),
    "stats": None,
}


def install(mesh, rules: dict[str, Any] | None = None):
    """Install ``mesh`` (a ``DeviceMesh`` with named dimensions) and a
    rules table (``DEFAULT_RULES`` by default) for the process."""
    _state.mesh = mesh
    _state.rules = dict(DEFAULT_RULES if rules is None else rules)


def clear():
    _state.mesh = None
    _state.rules = None


@contextlib.contextmanager
def use_rules(mesh, rules: dict[str, Any] | None = None):
    prev = (_state.mesh, _state.rules)
    install(mesh, rules)
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def active() -> bool:
    return _state.mesh is not None


def current_mesh():
    """The installed mesh (None with no rules installed)."""
    return _state.mesh


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_for(name: str | None):
    if name is None:
        return None
    ax = _state.rules.get(name)
    if ax is None:
        return None
    mesh_axes = _state.mesh.mesh_dim_names
    if isinstance(ax, tuple):
        avail = tuple(a for a in ax if a in mesh_axes)
        return avail if avail else None
    return ax if ax in mesh_axes else None


def spec(*names: str | None, shape: tuple[int, ...] | None = None) -> tuple:
    """The spec of the given logical names under the active rules: one
    entry a name (``()`` with no rules installed).

    A mesh axis is used once: a later name that maps to an axis already
    taken gets None. With ``shape``, mesh axes that do not divide their
    dimension are dropped (the maximal divisible prefix of a tuple rule):
    e.g. 8 attention heads on a 16-wide model axis stay replicated.
    """
    if not active():
        return ()
    size = _sizes(_state.mesh)
    used: set[str] = set()
    parts = []
    for i, n in enumerate(names):
        dim = None if shape is None else shape[i]
        ax = _axis_for(n)
        if isinstance(ax, tuple):
            ax = tuple(a for a in ax if a not in used)
            if dim is not None:
                pref, prod = [], 1
                for a in ax:
                    if dim % (prod * size[a]) == 0:
                        pref.append(a)
                        prod *= size[a]
                    else:
                        break
                ax = tuple(pref)
            used.update(ax)
            parts.append(ax if ax else None)
        else:
            if ax in used:
                ax = None
            if ax is not None and dim is not None and dim % size[ax] != 0:
                ax = None
            if ax is not None:
                used.add(ax)
            parts.append(ax)
    return tuple(parts)


def placements(spec_: tuple, mesh) -> list:
    """DTensor placements of ``spec_`` on ``mesh``: for each mesh dimension,
    ``Shard(d)`` where the spec splits tensor dimension d over it, else
    ``Replicate()``. A tuple entry must list its axes in the mesh's order
    (major first), which is the order DTensor shards one dimension in."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    for d, part in enumerate(spec_):
        axes = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in axes if a is not None]
        if idx != sorted(idx):
            raise ValueError(f"dimension {d} is split over {axes}, not in "
                             f"the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def sharding(*names: str | None, shape: tuple[int, ...] | None = None):
    """The placements of ``names`` on the installed mesh, or None with no
    rules installed."""
    if not active():
        return None
    return placements(spec(*names, shape=shape), _state.mesh)


def constrain(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """Lay out an activation as ``names`` say: ``x.redistribute`` to their
    placements (an all-gather, a reduce-scatter, an all-reduce or a local
    slice, as DTensor finds). The identity with no rules installed, on a
    plain tensor or with a name per dimension missing."""
    from torch.distributed.tensor import DTensor
    if not active() or not isinstance(x, DTensor) or len(names) != x.ndim:
        return x
    return x.redistribute(_state.mesh,
                          sharding(*names, shape=tuple(x.shape)))


def on_shards(fn, like: torch.Tensor, *tensors):
    """``fn(*tensors)`` run on each rank's shards, the tensors laid out as
    ``like`` first, the result a DTensor of ``like``'s placements; on plain
    tensors just ``fn(*tensors)``. For an op whose DTensor rule leaves a
    layout DTensor's later ops cannot take (its split gather's masked
    partial): ``like`` must keep whole every dimension ``fn`` works
    across, here its last."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(like, DTensor):
        return fn(*tensors)
    mesh, where = like.device_mesh, like.placements
    if any(isinstance(p, Shard) and p.dim in (-1, like.dim() - 1)
           for p in where):
        raise ValueError(f"on_shards needs the last dimension whole, got "
                         f"{where}")
    local = [t.redistribute(mesh, where).to_local()
             if isinstance(t, DTensor) else t for t in tensors]
    return DTensor.from_local(fn(*local), mesh, where, run_check=False)


# Logical names of an FSDP shard: a weight split over the batch's axes.
FSDP_NAMES = ("fsdp", "embed_fsdp")


def pin_weight(w: torch.Tensor, *names: str | None) -> torch.Tensor:
    """A weight at its use site: pinned to ``names`` as the reference pins
    it (``_pin_gqa``, ``dense_ffn``), then gathered over its FSDP axes
    (``FSDP_NAMES``). GSPMD gathers such a weight for a product whose
    other operand is split over the batch; DTensor, left to choose, moves
    the smaller operand (a chunk of activations), leaves the product
    partial over the batch's axes and all-reduces it."""
    w = constrain(w, *names)
    return constrain(w, *(None if n in FSDP_NAMES else n for n in names))


def update_slice(dst: torch.Tensor, dim: int, index: int,
                 src: torch.Tensor) -> torch.Tensor:
    """Set entry ``index`` of ``dst`` along ``dim`` to ``src`` (``dst``'s
    shape without ``dim``), in place, and return ``dst``: a ring slot of a
    decode cache (the reference's ``dynamic_update_slice_in_dim``). On a
    ``DTensor`` split along ``dim`` (the cache's ``kv_seq``) only the rank
    that holds the entry writes it, into its own shard, after ``src`` is
    laid out as ``dst``'s other dimensions are."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(dst, DTensor):
        dst.select(dim, index).copy_(src)
        return dst
    mesh, where = dst.device_mesh, dst.placements
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    src_where, mesh_dims = [], []
    for m, p in enumerate(where):
        if isinstance(p, Shard) and p.dim == dim:
            mesh_dims.append(m)
            src_where.append(Replicate())
        elif isinstance(p, Shard) and p.dim > dim:
            src_where.append(Shard(p.dim - 1))
        else:
            src_where.append(p)
    src = src.redistribute(mesh, src_where)
    coord, shard, shards = mesh.get_coordinate(), 0, 1
    for m in mesh_dims:
        shard = shard * mesh.size(m) + coord[m]
        shards *= mesh.size(m)
    n = dst.shape[dim]
    if n % shards:
        raise ValueError(f"{n} entries do not split evenly over {shards} "
                         "shards")
    lo = shard * (n // shards)
    if lo <= index < lo + n // shards:
        dst.to_local().select(dim, index - lo).copy_(src.to_local())
    return dst


def _is_axes(node) -> bool:
    return isinstance(node, tuple) or node is None


def tree_map_axes(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` over a tree of logical-axis tuples (dicts and
    lists are nodes, a tuple or None is a leaf) and trees of its shape."""
    if _is_axes(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: tree_map_axes(fn, a, *(t[k] for t in trees))
                for k, a in axes_tree.items()}
    return [tree_map_axes(fn, a, *(t[i] for t in trees))
            for i, a in enumerate(axes_tree)]


def tree_shardings(axes_tree, shape_tree=None):
    """Placements for each leaf of a tree of logical-axis tuples (None with
    no rules installed). With ``shape_tree`` (tensors of the same tree),
    each leaf's are divisibility-checked against its shape."""
    if not active():
        return None
    if shape_tree is None:
        return tree_map_axes(lambda ax: sharding(*(ax or ())), axes_tree)
    return tree_map_axes(
        lambda ax, t: sharding(*(ax or ()), shape=tuple(t.shape)),
        axes_tree, shape_tree)


def _leaf_placements(axes, t):
    if axes is None or len(axes) != t.dim():
        return sharding()
    return sharding(*axes, shape=tuple(t.shape))


def _distribute_tensor(t, axes, mesh):
    from torch.distributed.tensor import distribute_tensor
    # Every rank holds the same values: each keeps its own shard, with no
    # communication.
    return distribute_tensor(t.detach(), mesh, _leaf_placements(axes, t),
                             src_data_rank=None)


def _flat_axes(axes_tree, prefix=""):
    """{dotted path: axes} of an axes tree (dict keys and list indices
    joined by ".", as ``nn.Module.named_parameters`` names them)."""
    if _is_axes(axes_tree):
        return {prefix: axes_tree}
    items = (axes_tree.items() if isinstance(axes_tree, dict)
             else enumerate(axes_tree))
    out = {}
    for k, a in items:
        out.update(_flat_axes(a, f"{prefix}.{k}" if prefix else str(k)))
    return out


def distribute(model_or_tree, axes_tree, mesh):
    """Lay a parameter tree, or an ``nn.Module`` whose parameter names the
    axes tree mirrors (e.g. ``models.transformer.LM`` and its
    ``param_axes``), onto ``mesh`` by its axes under the installed rules
    (``DEFAULT_RULES`` if none): the counterpart of ``jax.device_put`` to
    ``tree_shardings``. Each rank passes the same full values and keeps
    its own shard. A module's parameters are replaced in place by
    ``DTensor`` parameters (the same ``requires_grad``) and the module is
    returned; a tree comes back as a new tree of DTensors (a None leaf,
    such as a graph's absent field, stays None)."""
    rules = _state.rules if active() else None
    with use_rules(mesh, rules):
        if not isinstance(model_or_tree, nn.Module):
            return tree_map_axes(
                lambda ax, t: None if t is None else _distribute_tensor(
                    t, ax, mesh), axes_tree, model_or_tree)
        axes = _flat_axes(axes_tree)
        for name, p in list(model_or_tree.named_parameters()):
            *path, leaf = name.split(".")
            mod = model_or_tree.get_submodule(".".join(path))
            setattr(mod, leaf, nn.Parameter(
                _distribute_tensor(p, axes[name], mesh),
                requires_grad=p.requires_grad))
        return model_or_tree
