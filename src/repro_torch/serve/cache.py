"""Slotted cache for the continuous-batching serve engine.

The KV cache is a fixed tensor of ``max_slots`` lanes x ``max_len``
positions per layer.  Admission prefills a prompt into a free lane,
decode advances every active lane by one token per step, and eviction
clears the lane's ``active`` bit; the lane's stale KV is overwritten
lazily (positions are only attended at ``pos <= length``, and decode
rewrites each position before the sequence first attends it).

Per-slot scheduling state lives on the device in small vectors, so the
decode loop's only host sync is the sampled-token fetch:

    tokens   (N,) int32  last sampled token per slot (next decode input)
    lengths  (N,) int32  tokens currently in the lane's cache
    active   (N,) bool   lane is serving a live request
    limits   (N,) int32  cache length at which the final token is sampled
    temps    (N,) f32    per-slot sampling temperature (0 = greedy)
    top_ks   (N,) int32  per-slot top-k mask (0 = off)
    top_ps   (N,) f32    per-slot nucleus threshold (<=0 or >=1 = off)
    replay   (N,) bool   the lane's next decode input is a recorded token
                         the host forces (a preempted request's resume);
                         the recurrent freeze keeps such a lane's state
    generator            seeded torch.Generator on the device (sampling)

Every vector is a fixed buffer: the host copies into it (never rebinds
it), so a CUDA graph captured on the state stays valid.

Prompt lengths are bucketed (powers of two) as in the reference, so the
prefill shapes repeat across admissions.

Families with recurrent state (zamba's ``hybrid`` kind) carry per-lane
recurrent leaves beside the KV segment; :class:`RecurrentCache` manages
their lifecycle (hard reset at admission, zeroing at eviction).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import registry
from repro_torch.models.common import serve_split

DEFAULT_MIN_BUCKET = 16


def prompt_buckets(max_len: int, min_bucket: int = DEFAULT_MIN_BUCKET) -> tuple[int, ...]:
    """Power-of-two prompt-length buckets, capped at ``max_len``."""
    if max_len < 1:
        raise ValueError(f"max_len must be positive, got {max_len}")
    if min_bucket < 1:
        raise ValueError(f"min_bucket must be positive, got {min_bucket}")
    out: list[int] = []
    b = min(min_bucket, max_len)
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def bucket_for(plen: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket that fits a prompt of length ``plen``."""
    if plen < 1:
        raise ValueError(f"prompt length must be positive, got {plen}")
    if not buckets:
        raise ValueError("no prompt buckets configured")
    for b in buckets:
        if b >= plen:
            return b
    raise ValueError(
        f"prompt length {plen} exceeds the largest bucket {buckets[-1]}"
    )


def sched_state(max_slots: int, device, seed: int = 0) -> dict:
    """The per-slot scheduling vectors shared by both layouts (all lanes
    free) and the sampling generator."""
    z = lambda dt: torch.zeros(max_slots, dtype=dt, device=device)
    return {
        "tokens": z(torch.int32),
        "lengths": z(torch.int32),
        "active": z(torch.bool),
        "limits": z(torch.int32),
        "temps": z(torch.float32),
        "top_ks": z(torch.int32),
        "top_ps": z(torch.float32),
        "replay": z(torch.bool),
        "generator": torch.Generator(device=device).manual_seed(seed),
    }


def slot_state_specs(cfg: ArchConfig, max_slots: int, max_len: int, mesh=None) -> dict:
    """The slotted cache's leaves as meta tensors: on a ``mesh`` (a
    ``launch.mesh.MeshGroup``) this rank's part, as the reference's
    ``slot_state_specs`` places them (``lm.cache_pspec`` of
    ``DecodeSharding.choose(mesh, max_slots)``: the lanes over the data
    axes, each lane's positions over ``model``, or every lane with its
    positions over every rank).  The scheduling vectors are replicated
    (:func:`sched_state`)."""
    mod = registry.get_module(cfg)
    if mesh is None:
        return mod.make_cache_specs(cfg, max_slots, max_len)
    return mod.make_cache_specs(cfg, max_slots, max_len, mesh=mesh)


def make_slot_state(cfg: ArchConfig, max_slots: int, max_len: int, device,
                    seed: int = 0, mesh=None) -> dict:
    """Allocate the device-resident slot state (all lanes free); on a
    ``mesh``, this rank's part of the cache (:func:`slot_state_specs`)."""
    specs = slot_state_specs(cfg, max_slots, max_len, mesh)
    cache = {k: torch.zeros_like(s, device=device) for k, s in specs.items()}
    return {"cache": cache, **sched_state(max_slots, device, seed)}


class RecurrentCache:
    """Per-lane recurrent-state manager for the slotted serve engine.

    Wraps :func:`repro_torch.models.registry.recurrent_leaf_axes`:
    ``leaf_axes`` maps each recurrent cache leaf (zamba's ``ssm`` and
    ``conv``) to its lane axis.  Falsy for pure-KV families, so the engine
    and the program builders can gate on ``if rec:``.

    Lifecycle invariants (the reference's, held by the port's tests):

    * **admit-time reset** — ``prefill_slot`` overwrites the lane's
      recurrent leaves wholesale with the state snapshot at the prompt
      end; nothing of a previous occupant survives.
    * **evict-time zeroing** — every decode/prefill program passes its
      post-step ``active`` vector (or'ed with ``replay``: a resumed lane
      whose recorded token the host forces keeps its state even when the
      device reads it as done) through :meth:`freeze`, which zeroes the
      recurrent leaves of every inactive lane in the same step (a lane
      finishing on the device is zeroed in the step that finishes it).
      So after a decode step an inactive lane's recurrent state is
      exactly zero: no stale recurrence advances, and no inf/NaN can
      accumulate in dead lanes.

    Under a serving mesh program whose data axes split the lanes the leaves
    hold this rank's lanes: a per-lane vector (``(max_slots,)``) is
    narrowed to them (:func:`_local`).

    Speculative decoding rolls lanes back with :meth:`snapshot` and
    :meth:`rollback`.  The decode step writes the recurrent leaves in
    place, so a snapshot is a copy, never an alias of the live tensors:
    into fresh tensors, or into buffers allocated once (``out=``, as the
    spec program does, so a CUDA graph captured on them stays valid).
    """

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.leaf_axes: dict[str, int] = registry.recurrent_leaf_axes(cfg)

    def __bool__(self) -> bool:
        return bool(self.leaf_axes)

    def freeze(self, cache: dict, active) -> dict:
        """Zero, in place, the recurrent leaves of every lane whose
        ``active`` bit is False (``(max_slots,)`` bool on the cache's
        device).  Active lanes are untouched; a NaN in a dead lane is
        zeroed too (a fill, not a multiply)."""
        for name, axis in self.leaf_axes.items():
            leaf = cache[name]
            lanes = _local(active, leaf.shape[axis])
            shape = [1] * leaf.ndim
            shape[axis] = lanes.shape[0]
            leaf.masked_fill_(~lanes.reshape(shape), 0)
        return cache

    def snapshot(self, cache: dict, out: dict | None = None) -> dict:
        """A copy of the recurrent leaves of ``cache`` as a flat dict: into
        ``out``'s tensors (``copy_``, the same shapes) when given, else into
        new ones."""
        if out is None:
            return {name: cache[name].clone() for name in self.leaf_axes}
        for name in self.leaf_axes:
            out[name].copy_(cache[name])
        return out

    def rollback(self, cache: dict, snap: dict, keep) -> dict:
        """Per-lane select, in place into ``cache``: lanes whose ``keep``
        bit is True (``(max_slots,)`` bool) keep their values, the others
        take ``snap``'s (a :meth:`snapshot`, or any dict of the same
        leaves).  A select, not arithmetic: every bit of either side (NaN
        payloads, signed zeros) passes through, so a kept lane stays
        bitwise what it was and a rolled-back lane is bitwise the
        snapshot."""
        for name, axis in self.leaf_axes.items():
            leaf = cache[name]
            lanes = _local(keep, leaf.shape[axis])
            shape = [1] * leaf.ndim
            shape[axis] = lanes.shape[0]
            torch.where(lanes.reshape(shape), leaf, snap[name], out=leaf)
        return cache

    def lane_is_zero(self, cache: dict, slot: int) -> bool:
        """Lane ``slot``'s recurrent leaves are all exactly zero (the
        evict-time-zeroing invariant)."""
        return self.lanes_are_zero(cache, [slot])

    def lanes_are_zero(self, cache: dict, slots) -> bool:
        """:meth:`lane_is_zero` over several lanes, with one host fetch
        (a bool) per leaf: the lanes are compared on the device."""
        slots = list(slots)
        if not slots:
            return True
        for name, axis in self.leaf_axes.items():
            leaf = cache[name]
            idx = torch.tensor(slots, device=leaf.device)
            if bool((leaf.index_select(axis, idx) != 0).any()):
                return False
        return True


def _local(vec, lanes: int):
    """A per-lane vector ``(max_slots,)`` narrowed to the ``lanes`` lanes a
    cache leaf holds: itself where it holds every lane, else (a serving
    mesh program whose data axes split the lanes) this rank's run."""
    if vec.shape[0] == lanes:
        return vec
    lo, hi = serve_split().decode.local_lanes(vec.shape[0])
    return vec[lo:hi]
