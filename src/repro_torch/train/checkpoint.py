"""Fault-tolerant checkpointing with elastic restore (counterpart of
``repro.train.checkpoint``), on the reference's on-disk layout.

Layout: ``<dir>/step_<n>/`` holding one ``.npy`` per leaf, named by its
tree path with ``/`` → ``__``, and ``manifest.json`` (step, each leaf's
file, dtype and shape, and optionally its logical sharding axes). Writes
go to ``step_<n>.tmp`` and are committed with an atomic rename, so a crash
mid-write never corrupts the latest checkpoint. bfloat16 is stored as its
16-bit pattern and read back through an ``int16`` view, so the two
packages read each other's checkpoints bit for bit.

Restore is elastic: each leaf goes onto its template leaf's device and
dtype, whatever wrote it. ``AsyncCheckpointer`` writes on a daemon thread
(a queue of 1: back-pressure instead of unbounded memory) from a host copy
taken before ``save`` returns: the train step updates its tensors in
place, so a copy taken later would race the next step.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading

import numpy as np
import torch

from repro_torch.train import tree


def _to_numpy(t) -> tuple[np.ndarray, str]:
    """A leaf as the array written to disk, and its dtype's name."""
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, state, axes_tree=None):
    """Synchronous atomic save of a tree of tensors."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}}
    for name, leaf in tree.flatten(state):
        arr, dtype_name = _to_numpy(leaf)
        fname = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][name] = {
            "file": fname, "dtype": dtype_name, "shape": list(arr.shape)}
    if axes_tree is not None:
        manifest["axes"] = {
            name: list(ax) if isinstance(ax, tuple) else ax
            for name, ax in _flatten_axes(axes_tree)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _flatten_axes(axes_tree) -> list[tuple[str, object]]:
    """(path, axes) pairs in JAX's order; a tuple of axis names is one
    leaf, ``None`` none."""
    out = []
    _walk_axes(axes_tree, [], out)
    return out


def _walk_axes(node, path, out):
    if isinstance(node, dict):
        for k in sorted(node):
            _walk_axes(node[k], path + [str(k)], out)
    elif isinstance(node, list):
        for i, v in enumerate(node):
            _walk_axes(v, path + [str(i)], out)
    elif node is not None:
        out.append(("/".join(path), node))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, template):
    """Restore into the structure of ``template``: each leaf on its template
    leaf's device and dtype, requiring gradients where the template leaf
    does (elastic: the writer's device and package do not matter)."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for name, leaf in tree.flatten(template):
        leaf = torch.as_tensor(leaf)
        meta = manifest["leaves"][name]
        t = _from_numpy(np.load(os.path.join(d, meta["file"])),
                        meta["dtype"])
        t = t.to(device=leaf.device, dtype=leaf.dtype)
        if leaf.requires_grad:
            t.requires_grad_(True)
        out.append(t)
    return tree.unflatten(template, out)


def host_copy(state):
    """A copy of every leaf in host memory, taken now (``.to`` the CPU
    blocks until the device's copy is done; a CPU leaf is cloned)."""
    return tree.tree_map(
        lambda t: torch.as_tensor(t).detach().to("cpu", copy=True), state)


class AsyncCheckpointer:
    """Bounded-queue background saver (off the training critical path)."""

    def __init__(self, ckpt_dir: str, axes_tree=None):
        self.ckpt_dir = ckpt_dir
        self.axes_tree = axes_tree
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self.errors: list[Exception] = []

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, state = item
            try:
                save(self.ckpt_dir, step, state, self.axes_tree)
            except Exception as e:  # surfaced on .close()
                self.errors.append(e)
            finally:
                self._q.task_done()

    def save(self, step: int, state):
        # The host copy is taken before this returns, so the step that
        # follows may update the state in place.
        self._q.put((step, host_copy(state)))

    def close(self):
        self._q.join()
        self._q.put(None)
        self._worker.join()
        if self.errors:
            raise self.errors[0]
