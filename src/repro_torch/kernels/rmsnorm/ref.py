"""Plain PyTorch versions of the RMSNorm kernels, matching the reference's
``kernels/rmsnorm/ref.py`` (fp32 mean-square, ``(1 + gamma)`` scale).

``rmsnorm_ref`` is the model's own ``rms_norm``.  ``rmsnorm_add_ref``
returns the normed sum in ``x.dtype`` (the kernel's output type; the
reference's oracle returns it in fp32) and the sum rounded to ``x.dtype``.
"""
from __future__ import annotations

from repro_torch.models.common import rms_norm as rmsnorm_ref


def rmsnorm_add_ref(x, residual, gamma, eps: float = 1e-6):
    """``s = x + residual`` in fp32; returns ``(rmsnorm(s), s)``, both in
    ``x.dtype``."""
    s = x.float() + residual.float()
    return rmsnorm_ref(s, gamma, eps).to(x.dtype), s.to(x.dtype)


__all__ = ["rmsnorm_add_ref", "rmsnorm_ref"]
