"""Public wrappers for the RMSNorm kernels.

``rmsnorm(x, gamma)`` and ``rmsnorm_add(x, residual, gamma)`` take
``x`` of shape ``(..., D)`` and ``gamma`` of shape ``(D,)``.  On a CUDA
tensor each launches its hand-written sm_90a kernel
(``csrc/rmsnorm.cu``) on PyTorch's current stream and adds one to its
``.launches``; on a CPU tensor it runs the plain version (``ref.py``).
There is no fallback: a CUDA tensor the kernel does not take raises.

Bound: bytes.  ``rmsnorm`` moves ``2 * rows * D`` elements of x's type
plus gamma; ``rmsnorm_add`` moves ``4 * rows * D`` plus gamma.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from .ref import rmsnorm_add_ref, rmsnorm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TAIL = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
         ctypes.c_void_p]


def _check(name, gamma, *xs):
    x = xs[0]
    if x.dim() < 1 or gamma.dim() != 1 or gamma.shape[0] != x.shape[-1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and gamma "
                         f"{tuple(gamma.shape)} do not share the last dim")
    for t in xs[1:]:
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"{name}: residual {tuple(t.shape)} {t.dtype} != "
                             f"x {tuple(x.shape)} {x.dtype}")
    if x.dtype not in _DTYPES or gamma.dtype not in _DTYPES:
        raise TypeError(f"{name}: x and gamma must be one of {list(_DTYPES)}; "
                        f"got {x.dtype}, {gamma.dtype}")
    if any(t.device != x.device for t in (*xs, gamma)):
        raise ValueError(f"{name}: inputs on different devices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    if x.device.type == "cuda" and not all(t.is_contiguous() for t in (*xs, gamma)):
        raise ValueError(f"{name} kernel needs contiguous inputs")


def _entry(name, n_ptrs):
    return _build.entry("rmsnorm", name, [ctypes.c_void_p] * n_ptrs + _TAIL)


def rmsnorm(x, gamma, *, eps: float = 1e-6):
    """``x * rsqrt(mean(x**2) + eps) * (1 + gamma)``, fp32 inside, output
    in ``x.dtype``."""
    _check("rmsnorm", gamma, x)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, gamma, eps)
    D = x.shape[-1]
    out = torch.empty_like(x)
    rc = _entry("rmsnorm_fwd", 3)(
        x.data_ptr(), gamma.data_ptr(), out.data_ptr(), _DTYPES[x.dtype],
        _DTYPES[gamma.dtype], x.numel() // D, D, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "rmsnorm")
    rmsnorm.launches += 1
    return out


def rmsnorm_add(x, residual, gamma, *, eps: float = 1e-6):
    """Fused ``s = x + residual`` (fp32) and RMSNorm of ``s``.  Returns
    ``(normed, s)``, both in ``x.dtype``."""
    _check("rmsnorm_add", gamma, x, residual)
    if x.device.type == "cpu":
        return rmsnorm_add_ref(x, residual, gamma, eps)
    D = x.shape[-1]
    out, s = torch.empty_like(x), torch.empty_like(x)
    rc = _entry("rmsnorm_add_fwd", 5)(
        x.data_ptr(), residual.data_ptr(), gamma.data_ptr(), out.data_ptr(),
        s.data_ptr(), _DTYPES[x.dtype], _DTYPES[gamma.dtype], x.numel() // D, D,
        float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "rmsnorm_add")
    rmsnorm_add.launches += 1
    return out, s


rmsnorm.launches = 0
rmsnorm_add.launches = 0
