"""Data-parallel groups: the port's counterpart of the reference's meshes.

The reference trains under ``shard_map`` over a JAX ``Mesh`` and reads its
data-parallel axes with ``data_axes_of(mesh)``.  For pure data
parallelism (the paper's program) the port needs only a
``torch.distributed`` process group, this worker's rank, the world size
and the device: a :class:`DataGroup`.

* :func:`single_device_group` — one worker, no process group; every
  collective is the identity.
* :func:`init_group` — a group over an explicit address
  (``tcp://127.0.0.1:<port>``); nothing is read from the environment.
* :func:`local_group` — the group ``torchrun`` describes through
  ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``, NCCL on cuda
  and gloo on cpu.

The reference's ``production`` and ``multipod`` meshes are TPU pods with a
model axis; they raise until the tensor-parallel/FSDP slice.
"""
from __future__ import annotations

import dataclasses
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


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


def make_production_mesh(*, multi_pod: bool = False):
    kind = "multipod" if multi_pod else "production"
    raise NotImplementedError(
        f"the {kind} mesh is a TPU pod with a model axis; it arrives with the "
        "tensor-parallel and FSDP slice of the port")
