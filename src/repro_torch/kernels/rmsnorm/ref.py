"""Plain PyTorch versions of the RMSNorm kernels, matching the reference's
``kernels/rmsnorm/ref.py`` (fp32 mean-square, ``(1 + gamma)`` scale).

``rmsnorm_ref`` is the model's own ``rms_norm``.  ``rmsnorm_add_ref``
returns the normed sum in ``x.dtype`` (the kernel's output type; the
reference's oracle returns it in fp32) and the sum rounded to ``x.dtype``.
``rmsnorm_gated_ref`` is the Mamba2 block's skip, gate and out-norm as the
reference writes them (``models/ssm.py``: ``y + D x``, then
``rms_norm(y * silu(z))``), each eager op rounding to the compute dtype.
"""
from __future__ import annotations

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
    cdt = z.dtype
    if x is not None:
        heads = (d_skip.shape[0], head_dim)
        y = (y.float().unflatten(-1, heads)
             + d_skip.float()[:, None] * x.float().unflatten(-1, heads)).flatten(-2)
    return rmsnorm_ref(y.to(cdt) * F.silu(z), gamma, eps)


__all__ = ["rmsnorm_add_ref", "rmsnorm_gated_ref", "rmsnorm_ref"]
