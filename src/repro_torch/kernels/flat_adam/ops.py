"""Public wrapper for the fused flat Adam kernel.

``flat_adam(p, g, m, v, step, ...)`` takes the flat fp32 buffers of the
paper's flattened gradient (§3.3) and the 1-based step as a ``(1,)`` int32
tensor on the same device.  On a CUDA tensor it launches the hand-written
sm_90a kernel (``csrc/flat_adam.cu``) on PyTorch's current stream, out of
place, and adds one to ``flat_adam.launches``; the kernel reads the step
on the device, so a launch makes no host sync.  On a CPU tensor it runs
the plain version (``ref.flat_adam_ref``).  There is no fallback: a CUDA
tensor the kernel does not take raises.

Bound: 28 bytes per element (16 read, 12 written).  At the full
``smollm-360m`` flat buffer, n = 361,821,184, that is 10.13 GB, ~3.02 ms
at the H100's 3.35 TB/s.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from .ref import flat_adam_ref

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_float] * 7
             + [ctypes.c_int, ctypes.c_void_p])


def _check(p, g, m, v, step):
    n = p.shape[0] if p.dim() == 1 else -1
    for name, x in (("p", p), ("g", g), ("m", m), ("v", v)):
        if x.dim() != 1 or x.shape[0] != n:
            raise ValueError(f"flat_adam: {name} has shape {tuple(x.shape)}, "
                             f"want ({n},) like p")
        if x.dtype != torch.float32:
            raise TypeError(f"flat_adam: {name} is {x.dtype}, want float32")
        if x.device != p.device:
            raise ValueError(f"flat_adam: {name} on {x.device}, p on {p.device}")
    if step.numel() != 1 or step.dtype != torch.int32 or step.device != p.device:
        raise ValueError(f"flat_adam: step must be one int32 on {p.device}; got "
                         f"{tuple(step.shape)} {step.dtype} on {step.device}")


def flat_adam(p, g, m, v, step, *, lr: float, beta1: float = 0.9,
              beta2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.0):
    """One fused Adam pass; returns new (p', m', v') buffers."""
    _check(p, g, m, v, step)
    if p.device.type == "cpu":
        return flat_adam_ref(p, g, m, v, step, lr=lr, beta1=beta1, beta2=beta2,
                             eps=eps, weight_decay=weight_decay)
    if p.device.type != "cuda":
        raise ValueError(f"flat_adam runs on cuda or cpu, not {p.device}")
    if not all(x.is_contiguous() for x in (p, g, m, v, step)):
        raise ValueError("flat_adam kernel needs contiguous buffers")
    fn = _build.entry("flat_adam", "flat_adam_fwd", _ARGTYPES)
    po, mo, vo = torch.empty_like(p), torch.empty_like(m), torch.empty_like(v)
    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    stream = torch.cuda.current_stream(p.device).cuda_stream
    rc = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), step.data_ptr(),
            po.data_ptr(), mo.data_ptr(), vo.data_ptr(), p.shape[0],
            float(lr), float(beta1), float(1 - beta1), float(beta2), float(1 - beta2),
            float(eps), float(lr * weight_decay), sms, stream)
    _build.check(rc, "flat_adam")
    flat_adam.launches += 1
    return po, mo, vo


flat_adam.launches = 0
