"""Cells for the dry run and the launchers (counterpart of
``repro.configs.base``).

A *cell* is one (architecture × input shape) target: a function and its
abstract arguments, meta tensors (the counterpart of ``ShapeDtypeStruct``s)
in trees of dicts and lists, each with a mirror tree of logical axes. A
mesh and rules installed with ``repro_torch.sharding`` give each argument
its placements. ``lower`` allocates nothing: parameters come from the real
initialiser run on the meta device, inputs are meta tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.distributed.tensor import Shard

from repro_torch import sharding
from repro_torch.train import loop as train_loop

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32}


def fake_device() -> str:
    """The device of the dry run's fake tensors: ``cuda`` where PyTorch is
    built with CUDA, so that every op takes the path the card runs (the
    kernels' custom ops, not their plain twins). Elsewhere ``meta``, which
    takes the same path: a CPU-only build puts a CUDA device guard around
    ``copy_``, ``contiguous`` and indexing, which raises on a fake CUDA
    tensor."""
    return "cuda" if torch.backends.cuda.is_built() else "meta"


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


@dataclasses.dataclass
class CellSpec:
    arch: str
    shape: str
    kind: str                      # train | prefill | decode
    fn: Callable
    args: tuple                    # trees of meta tensors (or Python ints)
    arg_axes: tuple                # mirror trees of logical-axis tuples / None
    static_kwargs: dict | None = None

    def _map(self, fn) -> tuple:
        """``fn(axes, leaf)`` over every argument leaf and its axes."""
        return tuple(sharding.tree_map_axes(fn, axes, arg)
                     for axes, arg in zip(self.arg_axes, self.args))

    @staticmethod
    def _placements(ax, leaf):
        if isinstance(ax, tuple) and len(ax) == leaf.dim():
            return sharding.sharding(*ax, shape=tuple(leaf.shape))
        return sharding.sharding()

    def shardings(self):
        """The placements of every tensor leaf under the installed rules
        (None where no rules are installed)."""
        if not sharding.active():
            return None
        return self._map(lambda ax, leaf: self._placements(ax, leaf)
                         if isinstance(leaf, torch.Tensor) else None)

    def local_shape(self, ax, leaf) -> tuple[int, ...]:
        """A leaf's shard on one rank under the installed rules (the whole
        leaf with none)."""
        shape = list(leaf.shape)
        if sharding.active():
            mesh = sharding.current_mesh()
            for i, p in enumerate(self._placements(ax, leaf)):
                if isinstance(p, Shard):
                    shape[p.dim] //= mesh.size(i)
        return tuple(shape)

    def argument_bytes(self) -> int:
        """Bytes of one rank's shards of every argument."""
        total = 0

        def add(ax, leaf):
            nonlocal total
            if isinstance(leaf, torch.Tensor):
                total += (math.prod(self.local_shape(ax, leaf))
                          * leaf.element_size())

        self._map(add)
        return total

    def lower(self, device: str | None = None) -> tuple:
        """The arguments ``fn`` runs on: each meta leaf made a tensor of
        its shard's shape on ``device`` (``fake_device()`` by default)
        under the active fake mode, and with rules installed wrapped as a
        ``DTensor`` of its placements on the installed mesh
        (``DTensor.from_local``: no data moves). A leaf that requires grad
        (the train state's parameters) comes back a leaf that requires
        grad. Where XLA would lower and compile the cell, PyTorch has
        nothing to compile: the dry run runs ``fn`` eagerly on these fake
        shards, and every op it dispatches is the program."""
        from torch.distributed.tensor import DTensor
        dev = torch.device(device or fake_device())

        def make(ax, leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            out = torch.empty(self.local_shape(ax, leaf), dtype=leaf.dtype,
                              device=dev)
            if sharding.active():
                out = DTensor.from_local(
                    out, sharding.current_mesh(), self._placements(ax, leaf),
                    run_check=False, shape=leaf.shape,
                    stride=_contiguous_strides(leaf.shape))
            return out.requires_grad_(leaf.requires_grad)

        return self._map(make)


def _contiguous_strides(shape) -> tuple[int, ...]:
    strides, n = [], 1
    for s in reversed(shape):
        strides.append(n)
        n *= s
    return tuple(reversed(strides))


def eval_shape_with_axes(init_fn):
    """(parameter tree of meta tensors, axes tree) of an init:
    ``init_fn(device)`` returns (parameter tree, axes tree) of a model
    built on ``device``, here the meta device (no memory, no numbers)."""
    return init_fn(torch.device("meta"))


def train_state_specs(init_fn, train_cfg: train_loop.TrainConfig):
    """(state tree of meta tensors, state axes tree) for a model init: the
    parameters (marked to require grad, as ``make_train_state`` marks
    them), the AdamW moments at ``moment_dtype`` and the step counter,
    the error feedback with ``compress_grads``."""
    p_shapes, p_axes = eval_shape_with_axes(init_fn)
    for p in _leaves(p_shapes):
        p.requires_grad_(p.is_floating_point())
    mdt = getattr(torch, train_cfg.opt.moment_dtype)
    moments = lambda: _tree_map(  # noqa: E731
        lambda p: torch.empty(p.shape, dtype=mdt, device="meta"), p_shapes)
    state = {"params": p_shapes,
             "opt": {"m": moments(), "v": moments(),
                     "step": spec((), torch.int32)}}
    axes = {"params": p_axes, "opt": {"m": p_axes, "v": p_axes, "step": ()}}
    if train_cfg.compress_grads:
        state["err_fb"] = _tree_map(
            lambda p: torch.empty(p.shape, dtype=torch.float32,
                                  device="meta"), p_shapes)
        axes["err_fb"] = p_axes
    return state, axes


def spec(shape, dtype=torch.float32) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype`` (a name or a torch dtype)."""
    dtype = _DTYPES.get(dtype, dtype)
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def axes_like(tree, axes):
    """Broadcast one logical-axes tuple over a whole tree."""
    return _tree_map(lambda _: axes, tree)


def cache_axes(caches: list[dict]) -> list[dict]:
    """Logical axes of the LM decode caches, one dict a layer (the port
    keeps no stacked layers axis): k / v (B, W, Hkv, Dh), an MLA layer's
    c_kv / k_rope (B, W, R), pos (B, W)."""
    def leaf_axes(key: str, leaf) -> tuple:
        nd = leaf.dim()
        if key in ("k", "v"):
            return ("batch", "kv_seq", "kv_heads", None)[:nd]
        if key in ("c_kv", "k_rope"):
            return ("batch", "kv_seq", None)[:nd]
        if key == "pos":
            return ("batch", "kv_seq")[:nd]
        return (None,) * nd

    return [{k: leaf_axes(k, v) for k, v in c.items()} for c in caches]
