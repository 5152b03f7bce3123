"""Process meshes over ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

A JAX mesh names the axes of an array of devices, and ``shard_map`` runs
one body per device. Here one process runs per mesh position: ``Mesh``
holds the shape, the axis names, this rank's coordinates (row-major, the
order in which ``jax.lax.axis_index`` flattens them) and one process
subgroup per axis, the line of ranks along that axis through this rank.
Its collectives are the ``jax.lax`` ones over one axis: ``psum``,
``pmax`` and ``all_gather``, and ``merge_top_k``, the gather + top-k tree
that merges the ranks' top-k buffers. They are the functional
collectives (``_c10d_functional``: an output of their own, the group by
name), so that they also run on the fake shards of the dry run, whose
``CollectiveLog`` reads their bytes and their group.

The backend is always the caller's: ``"nccl"`` where each rank has a card
of its own, ``"gloo"`` for ranks on the CPU or for ranks that share one
card (NCCL refuses two ranks on one device). ``torch.distributed`` lists
gloo's ``all_gather`` for CPU tensors only, so a gloo mesh runs every
collective on a host copy of its buffer (``Mesh._staged``), whatever the
buffer's device: the planner's cardinalities, the (Q, k) result buffers
and the counters, a few KiB a batch.

``spawn`` starts one process per mesh position, each with its mesh, and
returns what each rank's function returned. ``Mesh.from_device_mesh``
gives the same view of an existing ``DeviceMesh`` (one group a dimension,
already built), on any backend, the dry run's ``fake`` one included: the
mesh of a cell whose function is a ``shard_map`` body in the reference.

``make_device_mesh`` and ``make_production_mesh`` build a
``torch.distributed`` ``DeviceMesh`` instead, the mesh of the models'
logical-axis sharding (``repro_torch.sharding``: DTensor layouts), over
the default process group, real or fake.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.types import resolve_device

BACKENDS = ("nccl", "gloo")
_C10D = torch.ops._c10d_functional
# A collective that waits longer than this fails its rank.
COLLECTIVE_TIMEOUT_S = 600


class Mesh:
    """This rank's view of a mesh of ``prod(shape)`` ranks.

    Needs the default process group, of world size ``prod(shape)``; every
    rank must build its mesh with the same arguments, since each builds
    every axis's subgroups in the same order.
    """

    def __init__(self, shape, axis_names, backend: str,
                 device: torch.device):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"shape {self.shape} and axes {self.axis_names} "
                             "differ in length")
        world = dist.get_world_size()
        if world != math.prod(self.shape):
            raise ValueError(f"a {self.shape} mesh needs "
                             f"{math.prod(self.shape)} ranks, the process "
                             f"group has {world}")
        self.backend = backend
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.coords = tuple(_unravel(self.rank, self.shape))
        self._groups = {}
        for a, name in enumerate(self.axis_names):
            rest = [range(n) for b, n in enumerate(self.shape) if b != a]
            for others in itertools.product(*rest):
                ranks = []
                for c in range(self.shape[a]):
                    pos = list(others)
                    pos.insert(a, c)
                    ranks.append(_ravel(pos, self.shape))
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[name] = group

    @classmethod
    def from_device_mesh(cls, device_mesh, device=None) -> "Mesh":
        """This rank's view of ``device_mesh``: its dimension names, shape
        and coordinates, and ``device_mesh.get_group(i)`` as dimension i's
        group (no new subgroup is built). The backend is the groups' own;
        ``device`` is where the collectives' results land (the mesh's
        device type by default)."""
        self = cls.__new__(cls)
        self.shape = tuple(int(n) for n in device_mesh.shape)
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.coords = tuple(device_mesh.get_coordinate())
        self._groups = {name: device_mesh.get_group(i)
                        for i, name in enumerate(self.axis_names)}
        self.backend = dist.get_backend(self._groups[self.axis_names[0]])
        self.device = torch.device(device or device_mesh.device_type)
        self.rank = dist.get_rank()
        return self

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along ``name`` (``jax.lax.axis_index``)."""
        return self.coords[self.axis_names.index(name)]

    def flat_index(self, axes=None) -> int:
        """Row-major index of this rank over ``axes`` (all by default)."""
        flat = 0
        for name in axes or self.axis_names:
            flat = flat * self.axis_size(name) + self.axis_index(name)
        return flat

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        """The buffer a collective runs on: a contiguous copy, on the host
        under gloo."""
        buf = x.detach().reshape(-1).clone()
        return buf.cpu() if self.backend == "gloo" else buf

    def _all_reduce(self, x: torch.Tensor, axis: str, op: str) -> torch.Tensor:
        out = _C10D.all_reduce(self._staged(x), op,
                               self._groups[axis].group_name)
        return _C10D.wait_tensor(out).to(x.device).view(x.shape)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of ``x`` over the ranks along ``axis``."""
        return self._all_reduce(x, axis, "sum")

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Maximum of ``x`` over the ranks along ``axis``."""
        return self._all_reduce(x, axis, "max")

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """(n, *x.shape): every rank's ``x`` along ``axis``, in axis order."""
        group = self._groups[axis]
        out = _C10D.all_gather_into_tensor(self._staged(x), group.size(),
                                           group.group_name)
        return _C10D.wait_tensor(out).to(x.device).view(-1, *x.shape)

    def merge_top_k(self, scores: torch.Tensor, payload: torch.Tensor,
                    k: int, axes=None):
        """Per axis of ``axes`` (all by default), in order: gather every
        rank's (..., n) buffers along it and keep the top-k, as
        ``lax.top_k`` orders them: equal scores to the lower gathered
        position (rank order along the axis, then place in the buffer),
        hence a stable sort. Returns (scores, payload), each (..., k)."""
        for ax in axes or self.axis_names:
            s_all = self.all_gather(scores, ax).movedim(0, -2).flatten(-2)
            p_all = self.all_gather(payload, ax).movedim(0, -2).flatten(-2)
            s_all, idx = torch.sort(s_all, dim=-1, descending=True,
                                    stable=True)
            scores, payload = s_all[..., :k], p_all.gather(-1, idx[..., :k])
        return scores, payload


def _ravel(pos, shape) -> int:
    flat = 0
    for c, n in zip(pos, shape):
        flat = flat * n + c
    return flat


def _unravel(flat: int, shape) -> list[int]:
    pos = []
    for n in reversed(shape):
        pos.append(flat % n)
        flat //= n
    return pos[::-1]


def make_host_mesh(shape=(1, 1), axes=("data", "model"), *, backend: str,
                   device=None) -> Mesh:
    """This rank's ``Mesh`` over the initialised default process group."""
    return Mesh(shape, axes, backend, resolve_device(device))


def _rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: the CPU, or card ``rank`` modulo the cards
    present (so ranks share a card only where there are fewer cards)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _rank_main(rank, fn, shape, axes, backend, device, args, tmp):
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{tmp}/rendezvous", rank=rank,
            world_size=math.prod(shape),
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        out = fn(make_host_mesh(shape, axes, backend=backend, device=dev),
                 *args)
        with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()
    except Exception as e:
        try:
            data = pickle.dumps(e)
        except (pickle.PicklingError, TypeError, AttributeError):
            raise e from None
        with open(os.path.join(tmp, f"error{rank}.pkl"), "wb") as f:
            f.write(data)
        raise


def _rank_error(tmp: str, rank: int):
    """The exception ``rank`` raised, or None where it could not be kept."""
    try:
        with open(os.path.join(tmp, f"error{rank}.pkl"), "rb") as f:
            return pickle.load(f)
    except (OSError, EOFError, pickle.UnpicklingError, TypeError,
            AttributeError):
        return None


def spawn(fn, shape, axes=("data", "model"), *, backend: str, device=None,
          args=()) -> list:
    """Run ``fn(mesh, *args)`` in one new process per position of a
    ``shape`` mesh; returns each rank's result, by rank.

    ``fn`` must be importable by name (a module-level function), and its
    arguments and result picklable; results travel through files, so keep
    them on the host. Ranks meet through a ``file://`` rendezvous in a
    fresh temporary directory, so concurrent calls do not collide. A
    collective that waits longer than ``COLLECTIVE_TIMEOUT_S`` fails its
    rank. If a rank raises, the others are stopped and its exception is raised here.
    """
    world = math.prod(shape)
    dev = resolve_device(device)
    if backend == "nccl" and (dev.type != "cuda"
                              or world > torch.cuda.device_count()):
        raise ValueError(f"NCCL needs a card a rank: {world} ranks, device "
                         f"{dev}")
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:
        try:
            mp.spawn(_rank_main, nprocs=world, join=True,
                     args=(fn, tuple(shape), tuple(axes), backend, str(dev),
                           tuple(args), tmp))
        except mp.ProcessRaisedException as err:
            exc = _rank_error(tmp, err.error_index)
            if exc is None:
                raise
            raise exc from err
        outs = []
        for r in range(world):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs


def make_device_mesh(shape=(1, 1), axes=("data", "model"), *,
                     device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with named dimensions ``axes`` over the
    default process group, which must hold ``prod(shape)`` ranks (row-major,
    as ``Mesh`` orders them): the mesh ``sharding.install`` takes."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized() or dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {tuple(shape)} mesh needs a default process "
                         f"group of {math.prod(shape)} ranks")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh: 16 × 16 ("data", "model"), 256 cards, or
    2 × 16 × 16 ("pod", "data", "model"), 512, over the default process
    group (a real one, or the dry run's fake one of that size).

    On Hopper these are 32 and 64 nodes of 8 H100s, each node's cards
    joined by NVLink, the nodes by InfiniBand. Ranks go row-major, so a
    16-wide ``model`` row spans two nodes: its collectives cross
    InfiniBand, as the ``data`` and ``pod`` axes' do (``launch.analysis``
    prices each axis by the slowest link it crosses). The reference's mesh
    is a TPU v5e pod slice of 256 chips on one ICI torus, and 2 of them
    over DCN."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_device_mesh(shape, axes, device_type=device_type)
