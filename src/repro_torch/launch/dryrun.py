"""Dry run: lay every (arch × shape) cell over the production mesh of H100s
and record what one card needs: memory, flops, bytes, collectives
(counterpart of ``repro.launch.dryrun``).

No card is used and nothing is allocated. A ``fake`` process group of the
mesh's size stands in for the cluster (this process is rank 0), and
``launch.mesh.make_production_mesh`` builds the 16 × 16 (or 2 × 16 × 16)
``DeviceMesh`` over it. Under ``sharding.use_rules`` the cell's arguments
become DTensors of fake shards (``CellSpec.lower``) and the cell's
function runs once, eagerly, while two dispatch modes watch each rank's
local ops (the modes step aside for the DTensor op itself and see what it
runs on the shards):

* ``LocalCost``: flops by ``torch.utils.flop_counter``'s formulas (the
  attention's custom ops included), bytes, each op's operands and outputs
  read and written once (view ops move none; XLA's "bytes accessed" has
  no other counterpart in eager PyTorch), and the peak of the live
  shards, arguments included. Per rank, from the local shards:
  ``FlopCounterMode`` around the DTensor ops would count their global
  shapes.
* ``CollectiveLog``: each collective the program asks for, its kind,
  bytes and whether its group spans nodes. A shard-to-shard change on one
  mesh axis is an all-to-all, counted once as such, even where DTensor
  runs it as an all-gather and a slice (its fallback on a CPU mesh).

Fake tensors are CUDA tensors where PyTorch has CUDA (``base.fake_device``)
and meta tensors elsewhere; both take the kernels' path (the custom ops'
fake impls), not the plain twins'. One JSON per cell is written to
``results/dryrun_torch/<arch>__<shape>__<mesh>.json`` with the
reference's keys. A cell in its architecture's ``SKIP_SHAPES`` is written
``skipped`` with the configuration's reason, as the reference writes it.
A cell that raises is written ``error``, and the run then exits non-zero.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
import weakref
from collections import Counter

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import sharding
from repro_torch.configs import all_archs, get_arch
from repro_torch.launch import analysis
from repro_torch.launch import mesh as mesh_lib

OUT_DIR = "results/dryrun_torch"

_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("reduce_scatter", "reduce-scatter"),
          ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
          ("broadcast", "collective-permute"),
          ("permute", "collective-permute"))


# Namespaces whose ops move no data of their own: ``prim.device`` reads a
# tensor's metadata; ``_c10d_functional``'s waits and autograd wrappers
# return their operand (its collectives are ``_kind``'s and
# ``CollectiveLog``'s).
_NO_DATA = ("prim", "_c10d_functional")


def _kind(func) -> str | None:
    """The reference's collective kind of a c10d op, or None."""
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d_functional", "c10d", "_dtensor"):
        return None
    name = func._opname
    for key, kind in _KINDS:
        if key in name:
            return kind
    return None


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _is_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _group_crosses_nodes(mesh) -> dict[str, bool]:
    """{group name: whether its ranks span nodes} of each mesh axis."""
    per_node = analysis.HW["cards_per_node"]
    out = {}
    for i in range(mesh.ndim):
        pg = mesh.get_group(i)
        ranks = dist.get_process_group_ranks(pg)
        out[pg.group_name] = len({r // per_node for r in ranks}) > 1
    return out


class CollectiveLog(TorchDispatchMode):
    """Each collective the program asks for on its shards: ``records`` of
    (kind, operand bytes, output bytes, crosses_nodes), and ``counts()`` by
    kind. Enter it around the run; like ``CommDebugMode`` it steps aside
    for DTensor ops and sees the collectives their redistributions issue,
    and it keeps each one's bytes, which ``CommDebugMode`` does not."""

    def __init__(self, mesh):
        super().__init__()
        self.records: list[tuple] = []
        self._crosses = _group_crosses_nodes(mesh)
        self._inside = 0

    def counts(self) -> dict[str, int]:
        out = dict.fromkeys(analysis.COLL_OPS, 0)
        for kind, *_ in self.records:
            out[kind] += 1
        return out

    @contextlib.contextmanager
    def _all_to_all(self):
        """Count DTensor's shard-to-shard change on one mesh axis as one
        all-to-all, whatever it runs: on a CPU mesh DTensor gathers and
        slices instead."""
        from torch.distributed.tensor import Shard
        orig = Shard._to_new_shard_dim
        log = self

        def to_new_shard_dim(self, local_tensor, mesh, mesh_dim, *args,
                             **kwargs):
            log._inside += 1
            try:
                out = orig(self, local_tensor, mesh, mesh_dim, *args,
                           **kwargs)
            finally:
                log._inside -= 1
            name = mesh.get_group(mesh_dim).group_name
            log.records.append(("all-to-all", _nbytes(local_tensor),
                                _nbytes(out), log._crosses.get(name, True)))
            return out

        Shard._to_new_shard_dim = to_new_shard_dim
        try:
            yield
        finally:
            Shard._to_new_shard_dim = orig

    def __enter__(self):
        self._patch = self._all_to_all()
        self._patch.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._patch.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = _kind(func)
        if kind is not None and not self._inside:
            group = next((a for a in reversed(args) if isinstance(a, str)),
                         None)
            self.records.append((kind, _nbytes(args[0]), _nbytes(out),
                                 self._crosses.get(group, True)))
        return out


class LocalCost(TorchDispatchMode):
    """Flops, bytes and live memory of the ops each rank runs on its own
    shards.

    ``flops``: ``torch.utils.flop_counter``'s formula of each op that has
    one (matmuls, the attention's custom ops); ``bytes``: each op's tensor
    operands and outputs, read and written once (view and collective ops
    excluded, and ops that read no data: ``prim.device`` and the
    functional collectives' waits and wrappers); ``peak_bytes``: the most
    bytes of storage alive at once,
    counting the storages passed to ``track`` and those the counted ops
    create, each until it is freed. Only ops on the fake shards count:
    DTensor's own shape propagation runs on global shapes, under a fake
    mode of its own or on meta tensors, and is not the program
    (``MemTracker`` was tried and counted some of it: 134 GB logits
    chunks in a two-layer gemma2-2b step). With ``real`` the ops on real
    tensors count too: a real run of a cell, to hold a fake one's flops
    against (its bytes also count ops among the tensors a fake run makes
    on the meta device without a fake mode, e.g. an ``arange``, which the
    fake run leaves out)."""

    def __init__(self, real: bool = False):
        super().__init__()
        self.real = real
        self.flops = 0
        self.bytes = 0
        self.flops_by_op: Counter = Counter()
        self.live = 0
        self.peak_bytes = 0
        self._storages: dict[int, int] = {}

    def track(self, tensors):
        """Count the storages of ``tensors`` (the arguments) as live."""
        from torch.distributed.tensor import DTensor
        for t in tensors:
            self._add(t.to_local() if isinstance(t, DTensor) else t)

    def _add(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        self._storages[key] = n = st.nbytes()
        weakref.finalize(st, self._free, key)
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)

    def _free(self, key: int):
        self.live -= self._storages.pop(key, 0)

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake = active_fake_mode()
        return super().__enter__()

    def _counts(self, t) -> bool:
        """Whether ``t`` is a shard the program runs on: a fake tensor, or
        with ``real`` any tensor holding values (not meta)."""
        from torch._subclasses.fake_tensor import FakeTensor
        if isinstance(t, FakeTensor):
            return True
        return (self.real and isinstance(t, torch.Tensor)
                and t.device.type != "meta")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.utils import _pytree as pytree
        from torch.utils.flop_counter import flop_registry
        if _is_dtensor(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake or not any(
                self._counts(t) for t in pytree.tree_leaves(
                    (args, kwargs, out))):
            return out
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            self.flops += n
            self.flops_by_op[str(func._overloadpacket)] += n
        if not (func.is_view or _kind(func) or func.namespace in _NO_DATA):
            self.bytes += (sum(_nbytes(a) for a in args)
                           + sum(_nbytes(v) for v in kwargs.values())
                           + _nbytes(out))
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if self._counts(t):
                self._add(t)
        return out


@contextlib.contextmanager
def fake_world(size: int):
    """A ``fake`` default process group of ``size`` ranks, this process rank
    0: collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _leaves(tree))


def measure(cell, mesh) -> dict:
    """Run ``cell`` once on fake shards over ``mesh`` (rules installed by
    the caller) → {"memory", "cost", "collectives", "counts", "run_s"}."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = cell.lower()
    cost, coll = LocalCost(), CollectiveLog(mesh)
    cost.track(_leaves(args))
    # The fake mode stays off while the cell runs: the fake shards carry
    # it into every op, and DTensor's index arithmetic stays on real ints.
    with coll, cost, implicit_replication():
        out = cell.fn(*args, **(cell.static_kwargs or {}))
    return {
        "memory": {"argument_bytes": cell.argument_bytes(),
                   "output_bytes": _local_bytes(out),
                   "peak_bytes": cost.peak_bytes},
        "cost": {"flops": cost.flops, "bytes accessed": cost.bytes,
                 "flops_by_op": dict(cost.flops_by_op)},
        "records": coll.records,
        "run_s": time.time() - t0,
    }


def _mesh_name(shape) -> str:
    return "x".join(str(n) for n in shape)


def run_cell(arch: str, shape: str, mesh, out_dir: str = OUT_DIR) -> dict:
    """Lay out and measure one cell on ``mesh`` (a ``DeviceMesh`` over the
    default process group) and write its JSON."""
    mod = get_arch(arch)
    result = {"arch": arch, "shape": shape,
              "mesh": _mesh_name(tuple(mesh.shape))}
    if shape in getattr(mod, "SKIP_SHAPES", {}):
        result.update(status="skipped", reason=mod.SKIP_SHAPES[shape])
        _write(out_dir, result)
        return result
    n_chips = math.prod(mesh.shape)
    try:
        with sharding.use_rules(mesh):
            cell = mod.make_cell(shape)
            m = measure(cell, mesh)
        coll = analysis.collective_bytes(m.pop("records"))
        rl = analysis.Roofline(
            flops=float(m["cost"]["flops"]),
            bytes_accessed=float(m["cost"]["bytes accessed"]),
            coll_bytes=float(coll["wire_total"]), n_chips=n_chips,
            model_flops=_model_flops(mod, shape),
            nvlink_bytes=float(coll["wire_nvlink"]))
        result.update({
            "status": "ok",
            "device": _device_name(),
            "run_s": round(m["run_s"], 1),
            "cost": m["cost"],
            "memory": m["memory"],
            "collectives": {k: v for k, v in coll.items() if k != "counts"},
            "collective_counts": coll["counts"],
            "roofline": rl.row(),
        })
    except Exception as e:  # noqa: BLE001 - recorded per cell
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    _write(out_dir, result)
    return result


def _model_flops(mod, shape: str) -> float:
    """The useful flops of an LM cell (``analysis.lm_model_flops``); 0 for
    any other family, as the reference's ``_model_flops`` gives."""
    if getattr(mod, "FAMILY", "") != "lm":
        return 0.0
    from repro_torch.configs.lm_common import LM_SHAPES
    sh = LM_SHAPES[shape]
    return analysis.lm_model_flops(mod.config(), sh["batch"], sh["seq"],
                                   sh["kind"])


def _device_name() -> str:
    from repro_torch.configs import base
    return f"fake {base.fake_device()}"


def _write(out_dir: str, result: dict):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{result['arch']}__{result['shape']}__{result['mesh']}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)


def line(r: dict) -> str:
    """One printed line of a cell's result."""
    extra = ""
    if r["status"] == "ok":
        rl, mem = r["roofline"], r["memory"]
        extra = (f" args {mem['argument_bytes'] / 1e9:.2f} GB peak "
                 f"{mem['peak_bytes'] / 1e9:.2f} GB | {rl['flops']:.3e} flops "
                 f"{rl['coll_bytes'] / 1e9:.3f} GB coll | dom="
                 f"{rl['dominant']} c/m/x = {rl['compute_s']:.2e}/"
                 f"{rl['memory_s']:.2e}/{rl['collective_s']:.2e} s")
    elif r["status"] == "error":
        extra = " " + r["error"][:200]
    elif r["status"] == "skipped":
        extra = " " + r["reason"]
    return (f"[{r['status']:7s}] {r['arch']:24s} {r['shape']:14s} "
            f"{r['mesh']}{extra}")


def run(cells, *, multi_pod: bool = False, out_dir: str = OUT_DIR,
        echo=print) -> list[dict]:
    """Every (arch, shape) of ``cells`` on the production mesh, inside one
    fake process group of its size."""
    results = []
    with fake_world(512 if multi_pod else 256):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        for arch, shape in cells:
            r = run_cell(arch, shape, mesh, out_dir)
            echo(line(r))
            results.append(r)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    if args.all:
        cells = [(a, s) for a in all_archs() for s in get_arch(a).SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    results = run(cells, multi_pod=args.multi_pod, out_dir=args.out,
                  echo=lambda s: print(s, flush=True))
    return 1 if any(r["status"] == "error" for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
