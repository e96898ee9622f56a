"""Bucketed gradient-collective engine over the flat buffer (paper §3.3 +
comm/compute overlap), over ``torch.distributed``.

``optim/flat.py`` gives ONE flat buffer; this module partitions its
:class:`FlatLayout` into fixed-byte **buckets** (default ~4 MiB, boundaries
aligned to parameter boundaries so a tensor never straddles two
collectives) and reduces each bucket with its own collective.

Two reduction programs over a :class:`~repro_torch.launch.mesh.DataGroup`:

* ``bucketed_all_reduce``   — faithful mode: one ``all_reduce(SUM)`` per
  bucket, then ``/ world`` for the mean (gloo has no ``AVG``); every
  worker ends with the full reduced flat gradient (the paper's Appendix-A
  program, bucketed).
* ``bucketed_reduce_scatter`` / ``bucketed_all_gather`` — ZeRO mode: each
  bucket is reduce-scattered so each worker owns ``1/N`` of it, the fused
  flat-Adam update runs on the owned shard only (sharded optimizer
  state), and the updated parameter shard is all-gathered back.

The scattered layout is *bucket-major*: worker ``w`` owns piece ``w`` of
every bucket, concatenated in bucket order.  Buckets are padded (by at
most ``n_shards - 1`` elements) so each piece is equal-sized; treat
scattered buffers as opaque between ``bucketed_reduce_scatter`` and
``bucketed_all_gather``.  With one worker and no process group every
collective is the identity.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.flat_adam.ops import flat_adam
from repro_torch.kernels.flat_adam.ref import flat_adam_ref
from .flat import FlatLayout

DEFAULT_BUCKET_BYTES = 4 << 20  # ~4 MiB, the NCCL-era sweet spot


def resolve_bucket_bytes(bucket_mb, *, group_size: int = 1) -> int:
    """Resolve ``OptConfig.bucket_mb`` (a float MiB or ``"auto"``) to bytes.

    ``"auto"`` is the reference's branch for a roofline without
    interconnect numbers: the static ~4 MiB default.  The port carries no
    interconnect model yet (the reference's numbers are a TPU link's), so
    ``group_size`` does not enter."""
    del group_size
    if bucket_mb != "auto":
        return int(float(bucket_mb) * (1 << 20))
    return DEFAULT_BUCKET_BYTES


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """A partition of ``[0, total)`` of a FlatLayout into buckets.

    ``starts[i] + sizes[i] == starts[i+1]`` and the buckets cover the
    buffer exactly.  ``padded[i]`` is ``sizes[i]`` rounded up to a multiple
    of ``n_shards`` (used only by the scatter path).
    """

    starts: tuple[int, ...]
    sizes: tuple[int, ...]
    padded: tuple[int, ...]
    n_shards: int
    bucket_bytes: int

    @property
    def num_buckets(self) -> int:
        return len(self.sizes)

    @property
    def total(self) -> int:
        return (self.starts[-1] + self.sizes[-1]) if self.sizes else 0

    @property
    def scattered_total(self) -> int:
        """Global length of a scattered (bucket-major, per-bucket padded)
        buffer: sum of padded bucket sizes."""
        return sum(self.padded)

    @property
    def local_total(self) -> int:
        """Per-worker length of a scattered buffer."""
        return self.scattered_total // self.n_shards


def make_buckets(
    layout: FlatLayout,
    *,
    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
    itemsize: int = 4,
    n_shards: int = 1,
) -> BucketLayout:
    """Greedy partition at parameter boundaries.

    Walks the layout's parameter segments in offset order, closing a bucket
    once it reaches ``bucket_bytes`` worth of elements.  A single parameter
    larger than the target gets a bucket of its own (never split).  The
    alignment tail of the flat buffer (``layout.total - layout.unpadded``)
    rides in the last bucket.
    """
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    target = max(1, bucket_bytes // itemsize)

    starts: list[int] = []
    sizes: list[int] = []
    acc = 0  # elements accumulated in the open bucket
    for off, size in zip(layout.offsets, layout.sizes):
        if acc == 0:
            starts.append(off)
        acc += size
        if acc >= target:
            sizes.append(acc)
            acc = 0
    if acc:
        sizes.append(acc)
    tail = layout.total - layout.unpadded
    if tail:
        if sizes:
            sizes[-1] += tail
        else:
            starts.append(0)
            sizes.append(layout.total)
    padded = tuple(-(-s // n_shards) * n_shards for s in sizes)
    return BucketLayout(
        starts=tuple(starts), sizes=tuple(sizes), padded=padded,
        n_shards=n_shards, bucket_bytes=bucket_bytes,
    )


# ---------------------------------------------------------------------------
# Faithful mode: per-bucket all-reduce
# ---------------------------------------------------------------------------


def bucketed_all_reduce(buf, buckets: BucketLayout, group, op: str = "mean"):
    """Reduce ``buf`` over ``group`` (a ``DataGroup``) one bucket at a time,
    IN PLACE (each bucket is a view of ``buf``); returns ``buf``.

    Per element it is the same sum as one all-reduce of the whole buffer;
    structurally it issues ``num_buckets`` collectives, which NCCL runs on
    its own stream behind the backward's producers.
    """
    if group.pg is None:
        return buf
    for s, z in zip(buckets.starts, buckets.sizes):
        part = buf[s: s + z]
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=group.pg)
        if op == "mean":
            part.div_(group.world)
    return buf


# ---------------------------------------------------------------------------
# ZeRO mode: per-bucket reduce-scatter / all-gather
# ---------------------------------------------------------------------------


def bucketed_reduce_scatter(buf, buckets: BucketLayout, group, op: str = "mean"):
    """Reduce-scatter ``buf`` per bucket: returns the worker's scattered
    shard, a new buffer of length ``buckets.local_total`` (bucket-major)."""
    n = buckets.n_shards
    if group.pg is None:
        if n != 1:
            raise ValueError(f"no process group, but {n} shards")
        return buf.clone()
    local = torch.empty(buckets.local_total, dtype=buf.dtype, device=buf.device)
    off = 0
    for start, size, pad_to in zip(buckets.starts, buckets.sizes, buckets.padded):
        part = buf[start: start + size]
        if pad_to != size:
            part = torch.cat([part, part.new_zeros(pad_to - size)])
        k = pad_to // n
        piece = local[off: off + k]
        dist.reduce_scatter_tensor(piece, part, op=dist.ReduceOp.SUM, group=group.pg)
        if op == "mean":
            piece.div_(n)
        off += k
    return local


def bucketed_all_gather(local, buckets: BucketLayout, group):
    """Inverse of :func:`bucketed_reduce_scatter`'s layout: gather each
    bucket's pieces and reassemble the full flat buffer (length
    ``buckets.total``), dropping the per-bucket padding."""
    n = buckets.n_shards
    if group.pg is None:
        if n != 1:
            raise ValueError(f"no process group, but {n} shards")
        return local
    out = torch.empty(buckets.total, dtype=local.dtype, device=local.device)
    off = 0
    for start, size, pad_to in zip(buckets.starts, buckets.sizes, buckets.padded):
        k = pad_to // n
        piece = local[off: off + k]
        off += k
        full = out[start: start + size] if pad_to == size else \
            torch.empty(pad_to, dtype=local.dtype, device=local.device)
        dist.all_gather_into_tensor(full, piece, group=group.pg)
        if pad_to != size:
            out[start: start + size] = full[:size]
    return out


def scatter_flat(buf, buckets: BucketLayout, index: int):
    """Worker ``index``'s scattered shard of a replicated flat buffer —
    what :func:`bucketed_reduce_scatter` would hand that worker if every
    worker contributed ``buf / n``."""
    n = buckets.n_shards
    if n == 1:
        return buf
    pieces = []
    for start, size, pad_to in zip(buckets.starts, buckets.sizes, buckets.padded):
        k = pad_to // n
        lo, hi = index * k, (index + 1) * k
        part = buf[start + lo: start + min(hi, size)]
        if hi > size:
            part = torch.cat([part, buf.new_zeros(hi - max(lo, size))])
        pieces.append(part)
    return torch.cat(pieces)


# ---------------------------------------------------------------------------
# Elastic restore: host-side reshard of scattered buffers across dp sizes
# ---------------------------------------------------------------------------
# A checkpointed ZeRO m/v buffer is the GLOBAL scattered array: worker-
# major segments (each ``local_total`` long), every segment bucket-major
# with piece ``w`` of each padded bucket.  That layout bakes in ``(bucket
# boundaries, n_shards)``, so restoring a dp=8 checkpoint onto dp=4 must
# first undo the old scatter and re-apply the new one.  Pure host-numpy
# data movement — bitwise, no arithmetic.


def unscatter_flat(buf, buckets: BucketLayout) -> np.ndarray:
    """Global scattered buffer -> the canonical flat buffer (length
    ``buckets.total``), dropping per-bucket padding."""
    buf = np.asarray(buf)
    if buf.shape != (buckets.scattered_total,):
        raise ValueError(
            f"scattered buffer has shape {buf.shape}, layout wants "
            f"({buckets.scattered_total},)")
    n = buckets.n_shards
    workers = buf.reshape(n, buckets.local_total)
    parts, off = [], 0
    for size, pad_to in zip(buckets.sizes, buckets.padded):
        k = pad_to // n
        # worker-major concat of each worker's piece == the padded bucket
        parts.append(workers[:, off: off + k].reshape(-1)[:size])
        off += k
    return np.concatenate(parts) if parts else buf[:0]


def rescatter_flat(flat, buckets: BucketLayout) -> np.ndarray:
    """Canonical flat buffer -> the global scattered buffer (length
    ``buckets.scattered_total``), zero-filling per-bucket padding —
    the host inverse of :func:`unscatter_flat`."""
    flat = np.asarray(flat)
    if flat.shape != (buckets.total,):
        raise ValueError(
            f"flat buffer has shape {flat.shape}, layout wants "
            f"({buckets.total},)")
    n = buckets.n_shards
    segs: list[list[np.ndarray]] = [[] for _ in range(n)]
    for start, size, pad_to in zip(buckets.starts, buckets.sizes, buckets.padded):
        part = flat[start: start + size]
        if pad_to != size:
            part = np.concatenate(
                [part, np.zeros(pad_to - size, flat.dtype)])
        k = pad_to // n
        for w in range(n):
            segs[w].append(part[w * k: (w + 1) * k])
    if not segs[0]:
        return flat[:0]
    return np.concatenate([np.concatenate(s) for s in segs])


def reshard_scattered(buf, old: BucketLayout, new: BucketLayout) -> np.ndarray:
    """Re-lay a scattered buffer saved under ``old`` (its dp size and
    bucket boundaries) for a job running under ``new``.  Adam's moment
    padding lanes are identically zero (their gradient is always the
    scatter pad), so dropping and re-zero-filling them is bitwise."""
    if old.total != new.total:
        raise ValueError(
            f"bucket layouts cover different flat buffers: "
            f"{old.total} vs {new.total} elements")
    return rescatter_flat(unscatter_flat(buf, old), new)


# ---------------------------------------------------------------------------
# Fused flat-Adam dispatch (CUDA kernel on a card, plain version on the CPU)
# ---------------------------------------------------------------------------


def flat_adam_apply(p, g, m, v, step, *, lr, beta1, beta2, eps,
                    weight_decay: float = 0.0, use_kernel: bool | None = None):
    """One fused elementwise Adam pass over flat fp32 buffers; ``step`` is
    the 1-based step as a device int tensor.

    ``use_kernel=None`` launches the ``kernels/flat_adam`` CUDA kernel on a
    CUDA tensor and runs its plain version on a CPU tensor; ``False``
    forces the plain version.  Returns ``(p', m', v')``.
    """
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
    if use_kernel is False:
        return flat_adam_ref(p, g, m, v, step, **kw)
    return flat_adam(p, g, m, v, step.reshape(1).to(torch.int32), **kw)
