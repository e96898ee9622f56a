"""Public wrapper for the flash attention kernel, in model layout.

``flash_attention(q, k, v)`` takes the layout used across ``models/``:
q ``(B, Sq, H, D)``, k/v ``(B, Sk, Hk, D)``.  On a CUDA tensor it launches
the hand-written sm_90a kernel (``csrc/flash_attention.cu``, which reads
the model layout directly, so no transpose is materialised; bf16 runs on
``wgmma`` tensor cores with ``cp.async`` K/V staging, fp32 on the FMA
pipes) on PyTorch's current stream and adds one to
``flash_attention.launches``; on a CPU tensor it runs the plain version
(``ref.attention_ref``).  There is no fallback: a CUDA tensor the kernel
does not take raises.  One call is one device kernel.

The gradient mirrors the reference's ``_flash_bwd``
(``repro/kernels/flash_attention/ops.py``), which has no backward kernel:
``flash_attention`` is a ``torch.autograd.Function`` whose forward saves
only q, k and v, and whose backward recomputes attention through the
port's ``chunked_attention`` (q and kv chunks of at most 128) under
``torch.enable_grad()`` and takes that function's vector-Jacobian product.
The backward launches no kernel, so a training step under rematerialisation
launches the forward twice per layer (forward, then the recompute) and
nothing more.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import chunked_attention
from .ref import attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64,)                # compiled head dims (csrc)
_BLOCK_Q = 64                     # query rows per CTA of the bf16 kernel
_MAX_GRID_YZ = 65535              # batch and q tiles are grid dims y and z
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention expects 4-d q/k/v in (B, S, H, D)")
    B, _, H, D = q.shape
    Bk, Sk, Hk, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Hk < 1 or H % Hk:
        raise ValueError(f"q heads {H} not a multiple of kv heads {Hk}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q/k/v must share one of {list(_DTYPES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v on different devices")


def _check_kernel(q, k, v):
    """What the CUDA kernel takes beyond ``_check``: head dim 64,
    contiguous tensors at 16-byte aligned addresses (its ``cp.async``
    copies move 16 bytes), and a grid that fits."""
    B, Sq, _, D = q.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q/k/v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs 16-byte aligned q/k/v")
    if B > _MAX_GRID_YZ or -(-Sq // _BLOCK_Q) > _MAX_GRID_YZ:
        raise ValueError(f"batch {B} or {Sq} query rows exceed the kernel's grid")


def _forward(q, k, v, causal, window, softcap):
    if q.device.type == "cpu":
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            softcap=softcap)
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check_kernel(q, k, v)
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    fn = _build.entry("flash_attention", "flash_attention_fwd", _ARGTYPES)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, H, Hk, Sq, Sk, D, int(bool(causal)),
            int(window), float(softcap), float(D ** -0.5), stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, softcap)
        return _forward(q, k, v, causal, window, softcap)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        causal, window, softcap = ctx.opts
        with torch.enable_grad():
            qd, kd, vd = (x.detach().requires_grad_() for x in (q, k, v))
            out = chunked_attention(qd, kd, vd, causal=causal, window=window,
                                    softcap=softcap, q_chunk=min(128, q.shape[1]),
                                    kv_chunk=min(128, k.shape[1]))
            dq, dk, dv = torch.autograd.grad(out, (qd, kd, vd), dout)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """Blocked attention with an fp32 online softmax and scale ``D**-0.5``.

    q: (B, Sq, H, D); k/v: (B, Sk, Hk, D), H % Hk == 0 (GQA maps q-head h
    to KV head h // (H // Hk)).  ``window > 0`` keeps keys with
    ``pos_k > pos_q - window``; ``softcap > 0`` caps the logits.  Returns
    (B, Sq, H, D) in q.dtype, differentiable in q, k and v.
    """
    _check(q, k, v)
    return _FlashAttention.apply(q, k, v, causal, window, softcap)


flash_attention.launches = 0
