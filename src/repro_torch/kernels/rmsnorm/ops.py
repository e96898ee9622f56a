"""Public wrappers for the RMSNorm kernels.

``rmsnorm(x, gamma)``, ``rmsnorm_add(x, residual, gamma)`` and
``rmsnorm_gated(y, z, gamma, x=, d_skip=, head_dim=)`` take inputs of
shape ``(..., D)`` and ``gamma`` of shape ``(D,)``.  On a CUDA tensor each
launches the hand-written sm_90a kernel (``csrc/rmsnorm.cu``, one template
for the three) on PyTorch's current stream and adds one to its own
``.launches``; on a CPU tensor it runs the plain version (``ref.py``).
There is no fallback: a CUDA tensor the kernel does not take raises.  The
kernel reads each input through its row stride (inner stride 1), so a
view into a wider tensor costs no copy; outputs are contiguous.

Autograd: with grad mode on and an input that requires grad, a wrapper
goes through ``_Norm``, whose forward is the same call (the kernel, or
the plain version on a CPU tensor) and whose backward recomputes through
the plain version, as the flash wrapper does: gradients for every input,
gamma included (the norm scales are trained).  Otherwise the wrapper calls
the kernel directly, so serving pays no autograd cost.

Bound: bytes.  ``rmsnorm`` moves ``2 * rows * D`` elements plus gamma;
``rmsnorm_add`` ``4 * rows * D``; ``rmsnorm_gated`` y, z, x and the output.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from .ref import rmsnorm_add_ref, rmsnorm_gated_ref, rmsnorm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256                      # a block (csrc NTHREADS)
MAX_VALUES = 32                    # fp32 values a thread holds (csrc)
MAX_D = THREADS * MAX_VALUES       # the widest row the kernel takes
FILL_THREADS = 132 * THREADS       # eight warps on each of the H100's SMs
_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "rmsnorm_fwd": [_P, _L, _P, _P, _I, _I, _L, _I, _F, _I, _I, _P],
    "rmsnorm_add_fwd": [_P, _L, _P, _L, _P, _P, _P, _I, _I, _L, _I, _F, _I, _I, _P],
    "rmsnorm_gated_fwd": [_P, _L, _P, _L, _P, _L, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I,
                          _F, _I, _I, _P],
}


def _entry(symbol):
    """The C entry point, resolved once per process (``_build.entry``)."""
    return _build.entry("rmsnorm", symbol, _ARGTYPES[symbol])


def _stream(t):
    """PyTorch's current stream on ``t``'s card, as a raw pointer (the
    cheapest way there: the wrappers' host cost is the main paths' cost)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


@functools.lru_cache(maxsize=4096)
def plan(rows: int, D: int, dtype) -> tuple[int, int]:
    """The kernel's thread mapping from the shape alone, as
    ``(threads per row, vectors of 16 bytes per thread)``: the fewest
    threads per row (a power of two) that keep a thread at ``MAX_VALUES``
    values, doubled while the grid holds fewer than ``FILL_THREADS``
    threads and each thread still has a vector.  A block of ``THREADS``
    holds ``THREADS // tpr`` rows.  Cached per shape: it runs on every
    launch."""
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    nvec = -(-D // vec)
    if D <= 0 or nvec > THREADS * (MAX_VALUES // vec):
        raise ValueError(f"rmsnorm kernel takes 0 < D <= {MAX_D}; got D={D}")
    tpr = 1
    while -(-nvec // tpr) > MAX_VALUES // vec:
        tpr *= 2
    while tpr < THREADS and tpr < nvec and rows * tpr < FILL_THREADS:
        tpr *= 2
    nv = 1
    while nv < -(-nvec // tpr):
        nv *= 2
    return tpr, nv


def _check(name, gamma, x, *same):
    """What every wrapper takes on either device: ``x`` (..., D), gamma
    (D,), the tensors of ``same`` of x's shape and dtype, float32 or
    bfloat16, one device, cpu or cuda."""
    shape, dtype = x.shape, x.dtype
    if not shape or gamma.dim() != 1 or gamma.shape[0] != shape[-1]:
        raise ValueError(f"{name}: x {tuple(shape)} and gamma "
                         f"{tuple(gamma.shape)} do not share the last dim")
    for t in same:
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{name}: residual {tuple(t.shape)} {t.dtype} != "
                             f"x {tuple(shape)} {dtype}")
    if dtype not in _DTYPES or gamma.dtype not in _DTYPES:
        raise TypeError(f"{name}: x and gamma must be one of {list(_DTYPES)}; "
                        f"got {dtype}, {gamma.dtype}")
    if not (x.is_cuda or x.is_cpu):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    dev = x.device
    if gamma.device != dev or any(t.device != dev for t in same):
        raise ValueError(f"{name}: inputs on different devices")


def _row_stride(name, t, D):
    """``t``'s rows as the kernel reads them: one stride between rows
    (returned, in elements), inner stride 1.  Raises for anything else."""
    if t.is_contiguous():
        return D
    try:
        v = t.view(-1, D)
    except RuntimeError:
        v = None
    if v is None or (D > 1 and v.stride(1) != 1):
        raise ValueError(f"{name} kernel reads rows at one stride with inner stride 1; got "
                         f"shape {tuple(t.shape)}, strides {t.stride()}")
    return v.stride(0)


def _check_kernel(name, gamma, *rows, d_skip=None):
    """What the CUDA kernel takes beyond ``_check``: a row of at most
    ``MAX_D`` elements, contiguous gamma (and D), and every input of
    ``rows`` at one row stride with inner stride 1.  Returns the strides."""
    D = gamma.shape[0]
    if D > MAX_D:
        raise ValueError(f"{name} kernel takes rows of at most {MAX_D}; got {D}")
    if not gamma.is_contiguous() or (d_skip is not None and not d_skip.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous gamma and d_skip")
    return [_row_stride(name, t, D) for t in rows]


class _Norm(torch.autograd.Function):
    """A wrapper's forward (``fwd``: the kernel on a CUDA tensor, the plain
    version on a CPU one) with a backward through the plain version
    (``ref``).  Inputs may be None (the gated form without its skip)."""

    @staticmethod
    def forward(ctx, fwd, ref, kwargs, *inputs):
        ctx.ref, ctx.kwargs = ref, kwargs
        ctx.save_for_backward(*inputs)
        return fwd(*inputs, **kwargs)

    @staticmethod
    def backward(ctx, *douts):
        with torch.enable_grad():
            xs = [t if t is None else t.detach().requires_grad_() for t in ctx.saved_tensors]
            grads = iter(torch.autograd.grad(ctx.ref(*xs, **ctx.kwargs),
                                             [t for t in xs if t is not None], douts))
        return (None, None, None, *(t if t is None else next(grads) for t in xs))


def rmsnorm(x, gamma, *, eps: float = 1e-6):
    """``x * rsqrt(mean(x**2) + eps) * (1 + gamma)``, fp32 inside, output
    in ``x.dtype``."""
    _check("rmsnorm", gamma, x)
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad):
        return _Norm.apply(_rmsnorm, rmsnorm_ref, {"eps": eps}, x, gamma)
    return _rmsnorm(x, gamma, eps=eps)


def _rmsnorm(x, gamma, *, eps):
    if not x.is_cuda:
        return rmsnorm_ref(x, gamma, eps)
    (sx,) = _check_kernel("rmsnorm", gamma, x)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    D = gamma.shape[0]
    if out.numel():
        rows = out.numel() // D
        rc = _entry("rmsnorm_fwd")(
            x.data_ptr(), sx, gamma.data_ptr(), out.data_ptr(), _DTYPES[x.dtype],
            _DTYPES[gamma.dtype], rows, D, eps, *plan(rows, D, x.dtype), _stream(x))
        _build.check(rc, "rmsnorm")
        rmsnorm.launches += 1
    return out


def rmsnorm_add(x, residual, gamma, *, eps: float = 1e-6):
    """Fused ``s = x + residual`` (fp32) and RMSNorm of ``s``.  Returns
    ``(normed, s)``, both in ``x.dtype``; ``s`` is bitwise ``x + residual``
    in ``x.dtype``."""
    _check("rmsnorm_add", gamma, x, residual)
    if torch.is_grad_enabled() and (x.requires_grad or residual.requires_grad
                                    or gamma.requires_grad):
        return _Norm.apply(_rmsnorm_add, rmsnorm_add_ref, {"eps": eps}, x, residual, gamma)
    return _rmsnorm_add(x, residual, gamma, eps=eps)


def _rmsnorm_add(x, residual, gamma, *, eps):
    if not x.is_cuda:
        return rmsnorm_add_ref(x, residual, gamma, eps)
    sx, sr = _check_kernel("rmsnorm_add", gamma, x, residual)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    s = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    D = gamma.shape[0]
    if out.numel():
        rows = out.numel() // D
        rc = _entry("rmsnorm_add_fwd")(
            x.data_ptr(), sx, residual.data_ptr(), sr, gamma.data_ptr(), out.data_ptr(),
            s.data_ptr(), _DTYPES[x.dtype], _DTYPES[gamma.dtype], rows, D, eps,
            *plan(rows, D, x.dtype), _stream(x))
        _build.check(rc, "rmsnorm_add")
        rmsnorm_add.launches += 1
    return out, s


def _check_gated(y, z, gamma, x, d_skip, head_dim):
    _check("rmsnorm_gated", gamma, z)
    if y.shape != z.shape or y.dtype not in (torch.float32, z.dtype):
        raise ValueError(f"rmsnorm_gated: y {tuple(y.shape)} {y.dtype} must have z's shape "
                         f"{tuple(z.shape)} and be float32 or {z.dtype}")
    if x is not None and (x.shape != z.shape or x.dtype != z.dtype):
        raise ValueError(f"rmsnorm_gated: x {tuple(x.shape)} {x.dtype} != z "
                         f"{tuple(z.shape)} {z.dtype}")
    if y.device != z.device or (x is not None and x.device != z.device):
        raise ValueError("rmsnorm_gated: inputs on different devices")
    if x is None:
        if d_skip is not None:
            raise ValueError("rmsnorm_gated: d_skip without x")
        return
    D = z.shape[-1]
    if (head_dim is None or head_dim <= 0 or D % head_dim or d_skip is None
            or tuple(d_skip.shape) != (D // head_dim,)):
        raise ValueError(f"rmsnorm_gated: d_skip {None if d_skip is None else tuple(d_skip.shape)}"
                         f" must hold one value per head of {head_dim} columns of {D}")
    if d_skip.dtype not in _DTYPES or d_skip.device != z.device:
        raise TypeError(f"rmsnorm_gated: d_skip must be one of {list(_DTYPES)} on z's device")


def rmsnorm_gated(y, z, gamma, *, x=None, d_skip=None, head_dim=None, eps: float = 1e-6):
    """The Mamba2 out-norm with its skip and gate:
    ``rmsnorm(c(c(y + D x) * c(silu(z))))`` in ``z.dtype`` (the compute
    dtype; ``c`` rounds to it, as the plain path's eager ops do).  y
    (..., D) fp32 or z's dtype; z and x (..., D) of the compute dtype, any
    row stride; ``d_skip`` (D // head_dim,) scales head ``col //
    head_dim`` of x.  Without x (and d_skip) the skip is left out."""
    _check_gated(y, z, gamma, x, d_skip, head_dim)
    kwargs = {"head_dim": head_dim, "eps": eps}
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (y, z, gamma, x, d_skip)):
        return _Norm.apply(_rmsnorm_gated, rmsnorm_gated_ref, kwargs, y, z, gamma, x, d_skip)
    return _rmsnorm_gated(y, z, gamma, x, d_skip, **kwargs)


def _rmsnorm_gated(y, z, gamma, x, d_skip, *, head_dim, eps):
    if not z.is_cuda:
        return rmsnorm_gated_ref(y, z, gamma, x, d_skip, head_dim, eps)
    if x is None:
        (sy, sz), sx = _check_kernel("rmsnorm_gated", gamma, y, z), 0
    else:
        sy, sz, sx = _check_kernel("rmsnorm_gated", gamma, y, z, x, d_skip=d_skip)
    out = torch.empty(z.shape, dtype=z.dtype, device=z.device)
    D = gamma.shape[0]
    if out.numel():
        rows = out.numel() // D
        rc = _entry("rmsnorm_gated_fwd")(
            y.data_ptr(), sy, z.data_ptr(), sz, None if x is None else x.data_ptr(), sx,
            gamma.data_ptr(), None if d_skip is None else d_skip.data_ptr(), out.data_ptr(),
            _DTYPES[y.dtype], _DTYPES[z.dtype], _DTYPES[gamma.dtype],
            _DTYPES[d_skip.dtype] if d_skip is not None else 0, rows, D,
            head_dim or 0, eps, *plan(rows, D, z.dtype), _stream(z))
        _build.check(rc, "rmsnorm_gated")
        rmsnorm_gated.launches += 1
    return out


rmsnorm.launches = 0
rmsnorm_add.launches = 0
rmsnorm_gated.launches = 0
