"""Shared model machinery: parameter declaration and initialisation, norms,
the loss and rematerialisation.

The port of the reference's ``models/common.py`` for the pieces serving
and dense training need.  Parameters are nested dicts of tensors with the reference's tree
structure (layers stacked on axis 0), so a converted JAX pytree and a
tree from :func:`init_tree` are interchangeable.  There is no sharding
here: the port runs on one device, so ``constrain``/``wuse`` have no
counterpart and weight casts are plain ``.to(dtype)``.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.core.tree import map_tree, tree_leaves  # noqa: F401  (the port's one tree walker)


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


def tree_from_leaves(paths, leaves) -> dict:
    """Inverse of :func:`tree_leaves`: a nested dict from paths and leaves."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def cast_tree(tree: dict, dtype: torch.dtype, keep: frozenset, device=None) -> dict:
    """A copy of a parameter tree with every leaf in ``dtype`` on ``device``
    except the leaves named in ``keep`` (norm scales and other leaves read
    in fp32), which keep their stored dtype.  ``.to`` returns the leaf
    itself where nothing changes."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = cast_tree(leaf, dtype, keep, device)
        else:
            dt = leaf.dtype if name in keep else dtype
            out[name] = leaf.to(device=device or leaf.device, dtype=dt)
    return out


def init_tree(seed: int, tree, device) -> dict:
    """Initialise every :class:`ParamSpec` of ``tree`` from one seeded
    ``torch.Generator`` on ``device``, drawn in sorted-key leaf order.
    The numbers are not the reference's (``jax.random`` bits have no
    PyTorch twin); shapes and scales are."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    pairs = list(tree_leaves(tree))
    return tree_from_leaves([p for p, _ in pairs],
                            [init_param(gen, spec, device) for _, spec in pairs])


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


def norm(cfg, x, gamma):
    """RMSNorm of a model's blocks: the CUDA kernel's wrapper under
    ``attn_impl="kernel"`` (its plain version on a CPU tensor), else the
    plain :func:`rms_norm`."""
    if cfg.attn_impl == "kernel":
        from repro_torch.kernels.rmsnorm.ops import rmsnorm
        return rmsnorm(x, gamma, eps=cfg.norm_eps)
    return rms_norm(x, gamma, cfg.norm_eps)


def norm_add(cfg, x, residual, gamma):
    """``s = x + residual`` and ``rms_norm(s)``; returns ``(normed, s)``.
    The kernel normalises the fp32 sum before it rounds to ``x.dtype``; the
    plain path rounds first, as the reference does (``x = x + o`` then
    ``rms_norm(x)``).  ``s`` is the same in both."""
    if cfg.attn_impl == "kernel":
        from repro_torch.kernels.rmsnorm.ops import rmsnorm_add
        return rmsnorm_add(x, residual, gamma, eps=cfg.norm_eps)
    s = x + residual
    return rms_norm(s, gamma, cfg.norm_eps), s


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


def cross_entropy_loss(logits, labels, mask=None):
    """Mean token-level cross entropy; logits (..., V) promoted to fp32:
    logsumexp minus the gold logit, averaged (over ``mask`` when given)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Rematerialisation
# ---------------------------------------------------------------------------

_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep matmul outputs,
    recompute everything else (the reference's
    ``dots_with_no_batch_dims_saveable``)."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(body, remat):
    """Apply a rematerialisation policy to a block function.

    remat: False (keep every activation) | True (save the block's inputs
    only and recompute its forward in the backward) | "dots" (save matmul
    outputs, recompute the rest).  Both checkpointing forms are
    ``torch.utils.checkpoint`` without re-entry."""
    if not remat:
        return body
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    if remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
        return lambda *a: checkpoint(body, *a, use_reentrant=False, context_fn=ctx)
    return lambda *a: checkpoint(body, *a, use_reentrant=False)
