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
    generator            seeded torch.Generator on the device (sampling)

Prompt lengths are bucketed (powers of two) as in the reference, so the
prefill shapes repeat across admissions.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import registry

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
        "generator": torch.Generator(device=device).manual_seed(seed),
    }


def make_slot_state(cfg: ArchConfig, max_slots: int, max_len: int, device,
                    seed: int = 0) -> dict:
    """Allocate the device-resident slot state (all lanes free)."""
    specs = registry.get_module(cfg).make_cache_specs(cfg, max_slots, max_len)
    cache = {k: torch.zeros_like(s, device=device) for k, s in specs.items()}
    return {"cache": cache, **sched_state(max_slots, device, seed)}
