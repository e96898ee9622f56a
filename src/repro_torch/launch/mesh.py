"""Process groups and meshes: the port's counterpart of the reference's
JAX meshes.

The reference trains under a ``Mesh`` of named axes, ``(data, model)`` or
``(pod, data, model)``, and reads its data-parallel axes with
``data_axes_of(mesh)``.  The port has two counterparts:

* :class:`DataGroup` — the data-parallel workers of one program: a
  ``torch.distributed`` process group, this worker's rank, the world size
  and the device.  The paper's program, the flat programs and FSDP on one
  data axis need nothing more.
* :class:`MeshGroup` — a 2- or 3-axis mesh over the same ranks: its axes
  and shape, this rank's coordinates, and one subgroup per axis plus one
  over the data axes together (``torch.distributed``
  ``new_subgroups_by_enumeration``), each handed to the collectives as a
  :class:`DataGroup` view (``mesh.data``, ``mesh.model``,
  ``mesh.axis(name)``).  The per-parameter train program runs tensor,
  sequence and expert parallelism over ``model`` and FSDP over ``data``
  (``models.common.ShardRules.for_mesh``).

Ranks map to coordinates in row-major order, the last axis fastest
(:func:`mesh_coords`), so the ranks of one model group are consecutive:
on one host they are the cards NVLink joins.

* :func:`single_device_group` / :func:`single_mesh` — one worker, no
  process group; every collective is the identity.
* :func:`init_group` — over an explicit address
  (``tcp://127.0.0.1:<port>``); nothing is read from the environment;
  :func:`mesh_from_group` lays a mesh over it.
* :func:`local_group` / :func:`local_mesh` — the ranks ``torchrun``
  describes through ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
  ``MASTER_PORT``, NCCL on cuda and gloo on cpu; ``local_mesh()`` is
  ``(world, 1)``, as the reference's.
* :func:`make_production_mesh` — the reference's pods: ``(16, 16)`` over
  256 ranks or ``(2, 16, 16)`` over 512 (:func:`production_layout`).
"""
from __future__ import annotations

import dataclasses
import math
import os
from datetime import timedelta
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

DATA_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The data-parallel workers of one program.  ``pg`` is the process
    group (None for a single worker without one)."""
    pg: object | None
    rank: int
    world: int
    device: torch.device

    def close(self) -> None:
        """Destroy the process group this object initialised, if any."""
        if self.pg is not None and dist.is_initialized():
            dist.destroy_process_group()


def single_device_group(device=None) -> DataGroup:
    return DataGroup(None, 0, 1, resolve_device(device))


def init_group(backend: str, rank: int, world: int, address: str, device=None,
               timeout_s: float = 300.0) -> DataGroup:
    """Join a ``world``-rank group at ``address`` (``tcp://host:port``).

    ``device`` defaults to this rank's card (``cuda:<rank % cards>``, also
    for a bare ``"cuda"``) for NCCL and must be ``"cpu"`` for gloo."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r} not in ('nccl', 'gloo')")
    dev = resolve_device(device)
    if backend == "nccl" and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("NCCL groups run on cuda devices")
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError("gloo groups run on the cpu here")
    dist.init_process_group(backend, init_method=address, rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    return DataGroup(dist.group.WORLD, rank, world, dev)


def local_group(device=None) -> DataGroup:
    """The group ``torchrun`` set up in the environment, or one worker
    without a group when it did not."""
    if "RANK" not in os.environ:
        return single_device_group(device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    address = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        return init_group("nccl", rank, world, address,
                          device=torch.device("cuda", local))
    return init_group("gloo", rank, world, address, device="cpu")


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------


def default_axes(ndim: int) -> tuple[str, ...]:
    """The reference's axis names for a 2- or 3-axis mesh."""
    if ndim == 2:
        return ("data", "model")
    if ndim == 3:
        return ("pod", "data", "model")
    raise ValueError(f"a mesh has 2 or 3 axes, not {ndim}")


def mesh_coords(shape: Sequence[int], rank: int) -> tuple[int, ...]:
    """Rank ``rank``'s coordinates on a mesh of ``shape``: row-major, the
    last axis fastest."""
    if not 0 <= rank < math.prod(shape):
        raise ValueError(f"rank {rank} is not on a mesh of {tuple(shape)}")
    out = []
    for n in reversed(shape):
        rank, c = divmod(rank, n)
        out.append(c)
    return tuple(reversed(out))


def mesh_rank(shape: Sequence[int], coords: Sequence[int]) -> int:
    """The inverse of :func:`mesh_coords`."""
    r = 0
    for n, c in zip(shape, coords):
        r = r * n + c
    return r


def axis_members(shape: Sequence[int], dims: Sequence[int]) -> list[list[int]]:
    """The subgroups along mesh dimensions ``dims``: one list of ranks for
    each coordinate of the other dimensions, each list in row-major order
    of ``dims`` (so a member's index in its list is its coordinate along
    them)."""
    others = [d for d in range(len(shape)) if d not in dims]
    groups = []
    for fixed in _product([shape[d] for d in others]):
        ranks = []
        for moving in _product([shape[d] for d in dims]):
            coords = [0] * len(shape)
            for d, c in zip(others, fixed):
                coords[d] = c
            for d, c in zip(dims, moving):
                coords[d] = c
            ranks.append(mesh_rank(shape, coords))
        groups.append(ranks)
    return groups


def _product(sizes):
    """Row-major tuples over ``sizes`` (one empty tuple for none)."""
    out = [()]
    for n in sizes:
        out = [t + (i,) for t in out for i in range(n)]
    return out


def production_layout(multi_pod: bool = False) -> tuple[int, ...]:
    """The reference's production meshes: one pod of 16 x 16 = 256 chips
    (data x model), or two pods, 2 x 16 x 16 = 512 (pod x data x model;
    ``pod`` is the cross-pod data-parallel axis)."""
    return (2, 16, 16) if multi_pod else (16, 16)


@dataclasses.dataclass(frozen=True)
class MeshGroup:
    """A mesh of ranks with named axes, the counterpart of a JAX ``Mesh``.

    ``groups`` holds a :class:`DataGroup` view for each axis and one over
    the data axes together (``"dp"``); ``pg`` is the world group (None for
    one worker without a process group, where every view is one without a
    group too).  Only :meth:`close` tears anything down."""
    axes: tuple[str, ...]
    shape: tuple[int, ...]
    coords: tuple[int, ...]
    rank: int
    device: torch.device
    pg: object | None
    groups: dict = dataclasses.field(compare=False, repr=False)

    @property
    def world(self) -> int:
        return math.prod(self.shape)

    def size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)] if axis in self.axes else 1

    def coord(self, axis: str) -> int:
        return self.coords[self.axes.index(axis)] if axis in self.axes else 0

    def axis(self, name: str) -> DataGroup:
        """The group along one axis (a one-worker view for an absent one)."""
        if name not in self.groups:
            return DataGroup(None, 0, 1, self.device)
        return self.groups[name]

    @property
    def data_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.axes if a in DATA_AXES)

    @property
    def data(self) -> DataGroup:
        """The data axes together: the batch splits over this group."""
        return self.groups["dp"]

    @property
    def model(self) -> DataGroup:
        return self.axis("model")

    def describe(self) -> str:
        return "(" + ", ".join(f"{a} {n}" for a, n in zip(self.axes, self.shape)) + ")"

    def close(self) -> None:
        """Destroy the process groups (the world's and every subgroup)."""
        if self.pg is not None and dist.is_initialized():
            dist.destroy_process_group()


def mesh_from_group(group: DataGroup, shape: Sequence[int]) -> MeshGroup:
    """A mesh of ``shape`` over ``group``'s ranks, its axes the reference's
    (:func:`default_axes`).  Every rank of the group must call it (each
    subgroup is created on all of them)."""
    shape = tuple(int(n) for n in shape)
    axes = default_axes(len(shape))
    if math.prod(shape) != group.world:
        raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} ranks; "
                         f"the world is {group.world}")
    coords = mesh_coords(shape, group.rank)
    dp_dims = tuple(i for i, a in enumerate(axes) if a in DATA_AXES)
    plan = {a: (i,) for i, a in enumerate(axes)}
    if dp_dims and dp_dims != plan.get("data"):      # pod and data together
        plan["dp"] = dp_dims
    groups = {}
    for name, dims in plan.items():
        members = axis_members(shape, dims)
        mine = next(m for m in members if group.rank in m)
        pg = None
        if group.pg is not None:
            pg = dist.new_subgroups_by_enumeration(members)[0]
        groups[name] = DataGroup(pg, mine.index(group.rank), len(mine), group.device)
    if "dp" not in groups:
        groups["dp"] = groups["data"] if dp_dims else DataGroup(None, 0, 1, group.device)
    return MeshGroup(axes, shape, coords, group.rank, group.device, group.pg, groups)


def single_mesh(device=None) -> MeshGroup:
    """One worker as a ``(data 1, model 1)`` mesh without a process group."""
    return mesh_from_group(single_device_group(device), (1, 1))


def local_mesh(data: int | None = None, model: int = 1, device=None) -> MeshGroup:
    """The reference's development mesh over the ranks ``torchrun``
    describes (one worker without it): ``(data, model)``, ``data``
    defaulting to ``world // model``."""
    group = local_group(device)
    if data is None:
        data = group.world // model
    try:
        return mesh_from_group(group, (data, model))
    except ValueError:
        group.close()
        raise


def make_production_mesh(*, multi_pod: bool = False, device=None) -> MeshGroup:
    """The reference's production mesh over the ranks ``torchrun``
    describes: ``(16, 16)`` at a world of 256, ``(2, 16, 16)`` at 512
    (``multi_pod``); any other world raises ``ValueError`` before a group
    is made."""
    shape = production_layout(multi_pod)
    world = int(os.environ.get("WORLD_SIZE", 1)) if "RANK" in os.environ else 1
    if world != math.prod(shape):
        kind = "multipod" if multi_pod else "production"
        raise ValueError(f"the {kind} mesh {shape} needs {math.prod(shape)} ranks; "
                         f"the world is {world}")
    return mesh_from_group(local_group(device), shape)
