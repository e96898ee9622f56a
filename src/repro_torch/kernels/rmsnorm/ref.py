"""Plain PyTorch versions of the RMSNorm kernels, matching the reference's
``kernels/rmsnorm/ref.py`` (fp32 mean-square, ``(1 + gamma)`` scale).

``rmsnorm_ref`` is the model's own ``rms_norm``.  ``rmsnorm_add_ref``
returns the normed sum in ``x.dtype`` (the kernel's output type; the
reference's oracle returns it in fp32) and the sum rounded to ``x.dtype``.
``rmsnorm_gated_ref`` is the Mamba2 block's skip, gate and out-norm as the
reference writes them (``models/ssm.py``: ``y + D x``, then
``rms_norm(y * silu(z))``), each eager op rounding to the compute dtype;
``rmsnorm_gated_split_ref`` the same over a rank's columns of a row split
across ranks (its sum of squares, or its columns normalised by the whole
row's sum), the arithmetic of ``rms_norm`` with ``mean`` written as the
sum over the width.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import rms_norm as rmsnorm_ref


def rmsnorm_add_ref(x, residual, gamma, eps: float = 1e-6):
    """``s = x + residual`` in fp32; returns ``(rmsnorm(s), s)``, both in
    ``x.dtype``."""
    s = x.float() + residual.float()
    return rmsnorm_ref(s, gamma, eps).to(x.dtype), s.to(x.dtype)


def rmsnorm_gated_ref(y, z, gamma, x=None, d_skip=None, head_dim=None, eps: float = 1e-6):
    """``rms_norm(c(c(y + D x) * c(silu(z))))`` in ``z.dtype`` (the compute
    dtype; ``c`` rounds to it).  y, z, x: ``(..., D)``; ``y + D x`` is fp32,
    with ``D[h]`` scaling the columns of head ``h = col // head_dim``;
    without x it is y itself."""
    return rmsnorm_ref(gated_prologue(y, z, x, d_skip, head_dim), gamma, eps)


def gated_prologue(y, z, x=None, d_skip=None, head_dim=None):
    """The gated norm's input ``c(c(y + D x) * c(silu(z)))`` in ``z.dtype``."""
    if x is not None:
        heads = (d_skip.shape[0], head_dim)
        y = (y.float().unflatten(-1, heads)
             + d_skip.float()[:, None] * x.float().unflatten(-1, heads)).flatten(-2)
    return y.to(z.dtype) * F.silu(z)


def rmsnorm_gated_split_ref(y, z, gamma, x=None, d_skip=None, head_dim=None,
                            eps: float = 1e-6, row_sum=None, width=None):
    """Without ``row_sum``: the fp32 sum of squares of the gated prologue
    over these columns, shape ``z.shape[:-1]``.  With it (the whole row's
    sum) and ``width`` (the whole row's columns): these columns normalised
    by it, in ``z.dtype``.  Over one rank this is ``rmsnorm_gated_ref``
    bit for bit (``mean`` is the sum divided by the width)."""
    v = gated_prologue(y, z, x, d_skip, head_dim).float()
    if row_sum is None:
        return v.square().sum(dim=-1)
    var = row_sum[..., None] / width
    return (v * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(z.dtype)


__all__ = ["gated_prologue", "rmsnorm_add_ref", "rmsnorm_gated_ref", "rmsnorm_gated_split_ref",
           "rmsnorm_ref"]
