"""Synkhronos data objects (paper §4).

Two storage tiers, mirroring the paper:

* :class:`SynkData` — host-resident arrays (the paper's OS shared memory).
  Numpy-interfaced, over-allocatable so they can grow/shrink without
  reallocation (paper §4.1), excerptable by index lists with no extra
  copies beyond the excerpt itself.

* :class:`DeviceDataset` — device-resident datasets sharded along the
  leading axis across the data-parallel workers (paper §4.2 "scatter"),
  for programs whose inputs are re-used across many function calls.
  ``batch=`` indices are **global** rows of the pre-scatter array; each
  worker gathers on device from its local shard (paper §5.2's on-GPU
  input indexing), routing rows between workers when an index chunk
  crosses shard boundaries.

The port of the reference's ``core/data.py``.  ``SynkData`` is the
reference's numpy class as it is.  A ``DeviceDataset`` holds this rank's
shard on its device (one process per card), where the reference holds a
global array sharded over the mesh.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from . import context as ctx_mod


class SynkData:
    """Host array with over-allocation, the analogue of paper §4.1 objects.

    The outward-facing numpy view may be smaller than the underlying
    allocation, so growing within capacity never copies.
    """

    def __init__(self, values: np.ndarray, *, oversize: float = 1.0):
        values = np.asarray(values)
        if oversize < 1.0:
            raise ValueError("oversize must be >= 1.0")
        cap = int(math.ceil(values.shape[0] * oversize)) if values.ndim else 1
        self._buffer = np.empty((max(cap, values.shape[0]),) + values.shape[1:], values.dtype)
        self._length = values.shape[0]
        self._buffer[: self._length] = values

    # -- numpy interface -------------------------------------------------
    @property
    def array(self) -> np.ndarray:
        """The outward-facing numpy view (writable, zero-copy)."""
        return self._buffer[: self._length]

    def __array__(self, dtype=None, copy=None):
        a = self.array
        return a.astype(dtype) if dtype is not None else a

    def __getitem__(self, idx):
        return self.array[idx]

    def __setitem__(self, idx, value):
        self.array[idx] = value

    def __len__(self) -> int:
        return self._length

    @property
    def shape(self):
        return self.array.shape

    @property
    def dtype(self):
        return self.array.dtype

    @property
    def capacity(self) -> int:
        return self._buffer.shape[0]

    # -- paper §4.1 special methods ---------------------------------------
    def set_length(self, n: int) -> None:
        """Grow/shrink the outward array; no copy while ``n <= capacity``."""
        if n <= self._buffer.shape[0]:
            self._length = n
            return
        new = np.empty((n,) + self._buffer.shape[1:], self._buffer.dtype)
        new[: self._length] = self._buffer[: self._length]
        self._buffer = new
        self._length = n

    def free(self) -> None:
        """Release the underlying allocation (paper: freeing their memory)."""
        self._buffer = np.empty((0,) + self._buffer.shape[1:], self._buffer.dtype)
        self._length = 0

    def excerpt(self, idx) -> np.ndarray:
        """Materialize ``self[idx]`` — the single copy the paper permits for
        shuffling (each worker excerpts its share in parallel; here the
        excerpt feeds the copy of this rank's chunk to its device)."""
        return self.array[idx]


def data(values, *, oversize: float = 1.0) -> SynkData:
    """Paper's ``synk.data(...)`` constructor."""
    return SynkData(np.asarray(values), oversize=oversize)


class DeviceDataset:
    """Dataset scattered across device memories (paper §4.2).

    ``local`` is this rank's shard on its device, ``local_length`` rows of
    the global array's ``shape``.  Device-side indexing (``batch=``) takes
    **global** row ids in ``[0, len(self))``; workers rebase them to
    shard-local positions (and route rows across workers when a chunk
    references another worker's shard).
    """

    def __init__(self, local: torch.Tensor, n_shards: int, rank: int = 0):
        self.local = local
        self.n_shards = n_shards
        self.rank = rank
        self.local_length = local.shape[0]

    @property
    def shape(self):
        return (self.local_length * self.n_shards,) + tuple(self.local.shape[1:])

    @property
    def dtype(self):
        return self.local.dtype

    def __len__(self):
        return self.local_length * self.n_shards


def scatter_data(values, ctx: "ctx_mod.SynkContext | None" = None) -> DeviceDataset:
    """Paper §4.2 'scatter' collective: split an array by its first axis
    into device-resident storage across the data-parallel workers.  Every
    rank passes the same ``values`` (SPMD) and keeps its own chunk; a
    length that does not divide is padded by repeating the last row, as
    the reference does."""
    ctx = ctx or ctx_mod.current()
    values = values if torch.is_tensor(values) else torch.from_numpy(np.asarray(values))
    n = ctx.n_data
    if values.shape[0] % n != 0:
        pad = n - values.shape[0] % n  # paper scatters "equally (as possible)"
        values = torch.cat([values, values[-1:].expand(pad, *values.shape[1:])])
    k = values.shape[0] // n
    local = values[ctx.rank * k:(ctx.rank + 1) * k].to(ctx.device).contiguous()
    return DeviceDataset(local, n, ctx.rank)


def is_dataset(x: Any) -> bool:
    return isinstance(x, DeviceDataset)


def is_host_data(x: Any) -> bool:
    return isinstance(x, SynkData)
