"""Shared model machinery: parameter declaration and initialisation, norms.

The port of the reference's ``models/common.py`` for the pieces serving
needs.  Parameters are nested dicts of tensors with the reference's tree
structure (layers stacked on axis 0), so a converted JAX pytree and a
tree from :func:`init_tree` are interchangeable.  There is no sharding
here: the port runs on one device, so ``constrain``/``wuse`` have no
counterpart and weight casts are plain ``.to(dtype)``.
"""
from __future__ import annotations

import dataclasses
import math

import torch


def dtype_of(name) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (config strings) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Parameter declaration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init_scale: float | None = None   # None -> fan-in scaled normal


def init_param(gen: torch.Generator, spec: ParamSpec, device) -> torch.Tensor:
    """Zeros where ``init_scale == 0``; ``init_scale * N(0, 1)`` where it is
    set; else a fan-in normal (``1/sqrt(shape[-2])``), as the reference."""
    if spec.init_scale == 0.0:
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init_scale is not None:
        scale = spec.init_scale
    else:
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
        scale = 1.0 / math.sqrt(fan_in)
    x = torch.randn(spec.shape, generator=gen, device=device, dtype=torch.float32)
    return (x * scale).to(spec.dtype)


def _leaves(tree, prefix=()):
    """(path, leaf) pairs in sorted-key order (the reference's tree order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_tree(seed: int, tree, device) -> dict:
    """Initialise every :class:`ParamSpec` of ``tree`` from one seeded
    ``torch.Generator`` on ``device``, drawn in sorted-key leaf order.
    The numbers are not the reference's (``jax.random`` bits have no
    PyTorch twin); shapes and scales are."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out: dict = {}
    for path, spec in _leaves(tree):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = init_param(gen, spec, device)
    return out


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


def decode_positions(cur_index, batch: int, device=None) -> torch.Tensor:
    """``(B, 1)`` int32 RoPE position row per sequence for a decode step.

    ``cur_index`` is a scalar (every sequence at the same position) or a
    ``(B,)`` vector (the serve engine's lanes, each at its own length).
    """
    cur = torch.as_tensor(cur_index, dtype=torch.int32, device=device)
    return torch.broadcast_to(cur, (batch,))[:, None]


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    """fp32 mean-square, ``(1 + gamma)`` scale, output in ``x.dtype``."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + gamma.float())).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)
