"""Public wrappers for the SSD scan kernel.

``ssd(x, dt, A, Bm, Cm, chunk=...)`` takes the model layout of
``models/ssm.py`` — x ``(B, T, H, P)``, dt ``(B, T, H)`` fp32, A ``(H,)``
fp32, Bm/Cm ``(B, T, G, N)`` — and returns ``(y, state)``: y ``(B, T, H,
P)`` fp32 and the final state ``(B, H, N, P)`` fp32, the contract of
``ssd_chunked(..., return_state=True)``.  ``ssd_fwd`` takes the TPU
kernel's own layout — x ``(B, H, T, P)``, dt ``(B, H, T)``, Bm/Cm ``(B, G,
T, N)`` — and returns y in x's dtype, as the TPU kernel does.

``ssd`` is differentiable in x, dt, A, B and C: where grad is on and an
input requires it, it goes through :class:`_Ssd`, whose forward is the
launch below and whose backward recomputes through the plain
``ssd_chunked_ref`` under autograd (the pairing ``flash_attention`` and the
norms use; neither package has a backward kernel for the scan).  The final
state's gradient may be absent (training reads only y).  With grad off
(serving) it launches directly, with no autograd cost.  ``ssd_fwd`` has no
backward: on a CUDA tensor that requires grad it raises.

On a CUDA tensor both launch the hand-written sm_90a kernels
(``csrc/ssd.cu``) on PyTorch's current stream, reading every input through
its strides (the model's x, B and C are views into the conv output: no
copy), and add one to ``ssd.launches`` per call.  bf16 inputs run three
device kernels a call on the tensor cores (chunk states, the state pass
over chunks, the chunk scan: see :func:`ssd_plan`), through a scratch the
wrapper allocates; fp32 inputs run one FMA kernel.  On a CPU tensor they
run the plain chunked scan (``ref.ssd_chunked_ref``) at ``chunk``; the
kernels block by their own internal chunk of 64 (the result is the same up
to fp32 summation order).  There is no fallback: a CUDA tensor the kernel
does not take raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from .ref import ssd_chunked_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_NP = 64                      # N and P the kernel takes (csrc MAXD)
_MAX_GRID_YZ = 65535              # heads and batch are grid dims y and z
CHUNK = 64                        # the kernels' internal chunk (csrc QC)
STATE_FLOATS = 64 * 64            # a chunk state in the scratch (csrc STATE)
STATE_PASS_BLOCKS = 4             # state-pass blocks per head and batch (csrc)
_STRIDES = ctypes.c_longlong * 15
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
             + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])


def ssd_plan(B: int, T: int, H: int, N: int, P: int) -> dict:
    """The bf16 kernels' work split, from shapes alone: the chunk count, the
    scratch (fp32 chunk states, each 64 x 64 in the wgmma accumulator's
    fragment order whatever N and P, then every chunk's ``seg``: one
    allocation of ``scratch_floats``) and the blocks of each device kernel.
    (fp32 inputs run one FMA kernel, a block per head and batch, and need
    no scratch.)"""
    nc = math.ceil(T / CHUNK)
    return dict(n_chunks=nc, scratch={"states": (B, H, nc, STATE_FLOATS), "segs": (B, H, nc)},
                scratch_floats=B * H * nc * (STATE_FLOATS + 1),
                blocks={"chunk_state": nc * H * B, "state_pass": STATE_PASS_BLOCKS * H * B,
                        "chunk_scan": nc * H * B})


def _check(x, dt, A, Bm, Cm, *, seq_axis: int):
    """Shapes in either layout: ``seq_axis`` 1 (model) or 2 (TPU)."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4:
        raise ValueError("ssd expects 4-d x, 3-d dt, 1-d A and 4-d B/C")
    if Cm.shape != Bm.shape:
        raise ValueError(f"B {tuple(Bm.shape)} != C {tuple(Cm.shape)}")
    head_axis = 3 - seq_axis
    B, T, H = x.shape[0], x.shape[seq_axis], x.shape[head_axis]
    G = Bm.shape[head_axis]
    if tuple(dt.shape) != tuple(x.shape[:3]) or A.shape[0] != H:
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not match "
                         f"x {tuple(x.shape)}")
    if Bm.shape[0] != B or Bm.shape[seq_axis] != T or G < 1 or H % G:
        raise ValueError(f"B/C {tuple(Bm.shape)} do not match x {tuple(x.shape)} "
                         "(heads must be a multiple of groups)")
    if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in _DTYPES:
        raise TypeError(f"x, B and C must share one of {list(_DTYPES)}; got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32; got {dt.dtype}, {A.dtype}")
    if any(t.device != x.device for t in (dt, A, Bm, Cm)):
        raise ValueError("ssd inputs on different devices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd runs on cuda or cpu, not {x.device}")


def _check_kernel(x, A, Bm, Cm, y, state, *, seq_axis: int):
    """What the CUDA kernels take beyond ``_check``: N, P <= 64, the last
    dim of x, B, C and y contiguous, contiguous A and state, a supported
    (input, output) type pair and a grid that fits.  Alignment is not
    required: a row that is not 16-byte aligned is staged by scalar loads."""
    head_axis = 3 - seq_axis
    N, P = Bm.shape[3], x.shape[3]
    if N > _MAX_NP or P > _MAX_NP:
        raise ValueError(f"ssd kernel takes N, P <= {_MAX_NP}; got N={N}, P={P}")
    if any(t.stride(3) != 1 for t in (x, Bm, Cm, y)):
        raise ValueError("ssd kernel needs the last dim of x, B, C and y contiguous")
    if not A.is_contiguous() or (state is not None and not state.is_contiguous()):
        raise ValueError("ssd kernel needs contiguous A and state")
    if (x.dtype, y.dtype) not in ((torch.float32, torch.float32),
                                  (torch.bfloat16, torch.float32),
                                  (torch.bfloat16, torch.bfloat16)):
        raise TypeError(f"ssd kernel does not write {y.dtype} from {x.dtype}")
    if x.shape[0] > _MAX_GRID_YZ or x.shape[head_axis] > _MAX_GRID_YZ:
        raise ValueError(f"batch {x.shape[0]} or {x.shape[head_axis]} heads exceed the "
                         "kernel's grid")


def _launch(x, dt, A, Bm, Cm, y, state, *, seq_axis: int):
    """Launch the kernels on tensors in either layout (``seq_axis`` 1:
    model, 2: TPU); y is written in its own dtype, state (or None) in fp32.
    One C call launches every device kernel of the scan."""
    _check_kernel(x, A, Bm, Cm, y, state, seq_axis=seq_axis)
    head_axis = 3 - seq_axis
    B, T, H, N, P = x.shape[0], x.shape[seq_axis], x.shape[head_axis], Bm.shape[3], x.shape[3]
    scratch = None
    if x.dtype == torch.bfloat16:
        plan = ssd_plan(B, T, H, N, P)
        scratch = torch.empty(max(plan["scratch_floats"], 1), dtype=torch.float32,
                              device=x.device)
    st = [t.stride() for t in (x, dt, Bm, Cm, y)]
    strides = _STRIDES(*[v for s in st for v in (s[0], s[seq_axis], s[head_axis])])
    fn = _build.entry("ssd", "ssd_scan", _ARGTYPES)
    rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), None if state is None else state.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            _DTYPES[x.dtype], _DTYPES[y.dtype], B, H, Bm.shape[head_axis], T, N, P,
            strides, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "ssd")
    ssd.launches += 1


def _ssd(x, dt, A, Bm, Cm, *, chunk: int):
    """The forward of :func:`ssd`: the plain scan on a CPU tensor, the
    kernels on a CUDA one."""
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk, return_state=True)
    B, T, H, P = x.shape
    y = torch.empty(B, T, H, P, dtype=torch.float32, device=x.device)
    state = torch.empty(B, H, Bm.shape[3], P, dtype=torch.float32, device=x.device)
    _launch(x, dt, A, Bm, Cm, y, state, seq_axis=1)
    return y, state


class _Ssd(torch.autograd.Function):
    """:func:`_ssd` forward; backward through ``ssd_chunked_ref`` at the same
    ``chunk``, for the inputs that need a gradient.  Either output's
    gradient may be None (not materialised)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return _ssd(x, dt, A, Bm, Cm, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        need = ctx.needs_input_grad[:5]
        pairs = [(o, g) for o, g in zip((0, 1), (dy, dstate)) if g is not None]
        if not pairs:
            return (None,) * 6
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            outs = ssd_chunked_ref(*xs, chunk=ctx.chunk, return_state=True)
            grads = iter(torch.autograd.grad([outs[o] for o, _ in pairs],
                                             [t for t, n in zip(xs, need) if n],
                                             [g for _, g in pairs], allow_unused=True))
        return (*(next(grads) if n else None for n in need), None)


def ssd(x, dt, A, Bm, Cm, *, chunk: int):
    """Model layout; returns ``(y fp32 (B,T,H,P), final state fp32
    (B,H,N,P))``, differentiable in every input (see the module's note)."""
    _check(x, dt, A, Bm, Cm, seq_axis=1)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bm, Cm)):
        return _Ssd.apply(x, dt, A, Bm, Cm, chunk)
    return _ssd(x, dt, A, Bm, Cm, chunk=chunk)


def ssd_fwd(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """The TPU kernel's layout: x (B,H,T,P), dt (B,H,T), Bm/Cm (B,G,T,N).
    Returns y (B,H,T,P) in x.dtype.  Forward only: a CUDA input that
    requires grad raises (the model's path is :func:`ssd`)."""
    _check(x, dt, A, Bm, Cm, seq_axis=2)
    if x.device.type == "cuda" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm)):
        raise ValueError("ssd_fwd has no backward on a CUDA tensor; the model "
                         "layout's ssd(...) does")
    if x.device.type == "cpu":
        t = lambda a: a.transpose(1, 2)
        return t(ssd_chunked_ref(t(x), t(dt), A, t(Bm), t(Cm), chunk=chunk)).to(x.dtype)
    y = torch.empty_like(x)
    _launch(x, dt, A, Bm, Cm, y, None, seq_axis=2)
    return y


ssd.launches = 0
