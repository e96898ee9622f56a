"""Synkhronos execution context: the data-parallel workers of one program.

The paper's ``synk.fork()`` spawned one Python process per GPU.  The port
follows it: one process per card, every rank running the same program
(SPMD) over a ``torch.distributed`` group, held in a
:class:`~repro_torch.launch.mesh.DataGroup`.  Where the reference builds a
JAX mesh whose data axes are the workers, ``fork`` here joins (or makes) a
group whose ranks are the workers:

* ``n_data`` — the world size (the paper's data-parallel workers);
* ``n_model`` — 1: tensor/expert/sequence-parallel axes arrive with the
  tensor-parallel slice of the port, and a mesh shape with a model axis
  raises, as ``launch/mesh.py`` does for the ``production`` mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.launch.mesh import DataGroup, init_group, local_group

_CURRENT: "SynkContext | None" = None

# Axes that scatter/reduce operate over, in nesting order (the reference's
# names; every one of them is a data-parallel axis).
DATA_AXIS_CANDIDATES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class SynkContext:
    """This rank's view of the workers: the group, its rank and device."""

    group: DataGroup

    @property
    def n_data(self) -> int:
        return self.group.world

    @property
    def n_model(self) -> int:
        return 1

    @property
    def n_devices(self) -> int:
        return self.group.world

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def device(self) -> torch.device:
        return self.group.device

    @property
    def pg(self):
        """The process group (None for one worker without a group)."""
        return self.group.pg

    @property
    def data_axes(self) -> tuple[str, ...]:
        return ("data",)

    @property
    def model_axes(self) -> tuple[str, ...]:
        return ()


def _check_axes(shape: Sequence[int], axes: Sequence[str], data_axes) -> int:
    """The data-parallel size of a mesh ``shape`` over ``axes``; raises for
    a model axis (the reference's data axes default to every axis when
    none of them is named like one)."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} does not match axes {tuple(axes)}")
    if data_axes is None:
        data_axes = tuple(a for a in axes if a in DATA_AXIS_CANDIDATES) or tuple(axes)
    model = [a for a, n in zip(axes, shape) if a not in data_axes and n > 1]
    if model:
        raise NotImplementedError(
            f"mesh axes {model} are model axes; tensor/expert/sequence parallelism "
            "arrives with the tensor-parallel slice of the port")
    return math.prod(n for a, n in zip(axes, shape) if a in data_axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, data_axes=None,
              device=None) -> DataGroup:
    """The port's counterpart of a data-parallel mesh: the group the
    environment describes (``local_group``), checked to have
    ``prod(shape)`` workers.  A model axis raises."""
    n = _check_axes(shape, axes, data_axes)
    group = local_group(device)
    if group.world != n:
        group.close()
        raise ValueError(f"mesh {tuple(shape)} over {tuple(axes)} needs {n} workers; "
                         f"this program has {group.world}")
    return group


def fork(
    mesh_shape: Sequence[int] | None = None,
    axes: Sequence[str] | None = None,
    *,
    data_axes: Sequence[str] | None = None,
    mesh: DataGroup | None = None,
    backend: str | None = None,
    rank: int | None = None,
    world: int | None = None,
    address: str | None = None,
    device=None,
) -> SynkContext:
    """Initialise the Synkhronos context (paper: ``synk.fork()``).

    * No arguments: the group ``torchrun`` describes in the environment,
      else one worker on ``device`` (default: the card, which raises
      without one; pass ``device="cpu"`` to run on the host).
    * ``backend=, rank=, world=, address=``: join ``world`` ranks at
      ``address`` (``tcp://host:port``), NCCL on cuda or gloo on cpu.
    * ``mesh_shape``/``axes``: as the reference's, data axes only; the
      shape must match the environment's world size.
    * ``mesh=``: an existing :class:`DataGroup`.
    """
    global _CURRENT
    explicit = (backend, rank, world, address)
    if mesh is None and any(v is not None for v in explicit):
        if any(v is None for v in explicit):
            raise ValueError("fork(backend=, rank=, world=, address=) needs all four")
        if mesh_shape is not None:
            _check_axes(mesh_shape, axes or ("data",) * len(mesh_shape), data_axes)
        mesh = init_group(backend, rank, world, address, device=device)
    elif mesh is None and mesh_shape is not None:
        if axes is None:
            raise ValueError("axes must be given when mesh_shape is")
        mesh = make_mesh(mesh_shape, axes, data_axes=data_axes, device=device)
    elif mesh is None:
        mesh = local_group(device)
    if mesh.device.type == "cuda" and mesh.device.index is None:
        # a tensor on the card reports its index: compare like with like
        mesh = dataclasses.replace(mesh, device=torch.device("cuda", torch.cuda.current_device()))
    ctx = SynkContext(group=mesh)
    _CURRENT = ctx
    return ctx


def current() -> SynkContext:
    if _CURRENT is None:
        return fork()
    return _CURRENT


def reset() -> None:
    """Drop the global context (tests); the group stays as it is."""
    global _CURRENT
    _CURRENT = None

