"""Public wrapper for the paged decode-attention kernel.

On a CUDA tensor ``paged_attention`` launches the hand-written sm_90a
kernel (``csrc/paged_attention.cu``) on PyTorch's current stream and adds
one to ``paged_attention.launches``; on a CPU tensor it runs the plain
version (``ref.paged_attention_ref``).  There is no fallback: a CUDA
tensor the kernel does not take raises.  Decode-only: no backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from .ref import paged_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64,)                # compiled head dims (csrc)
MAX_REP = 8                     # query heads per KV head the kernel holds
MAX_BLOCK_SIZE = 32             # one key per lane of a warp
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])


def _check(q, k_pool, v_pool, lengths, tables):
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"expected q (B, Hk, rep, D) and pools (NB, bs, Hk, "
                         f"D); got {tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    B, Hk, _, D = q.shape
    if k_pool.shape[2] != Hk or k_pool.shape[3] != D:
        raise ValueError(f"pool {tuple(k_pool.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if lengths.shape != (B,) or tables.dim() != 2 or tables.shape[0] != B:
        raise ValueError(f"lengths {tuple(lengths.shape)} / tables "
                         f"{tuple(tables.shape)} do not match batch {B}")
    if not (q.dtype == k_pool.dtype == v_pool.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q and pools must share one of {list(_DTYPES)}")
    if lengths.dtype != torch.int32 or tables.dtype != torch.int32:
        raise TypeError("lengths and tables must be int32")
    devs = {t.device for t in (q, k_pool, v_pool, lengths, tables)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def paged_attention(q, k_pool, v_pool, lengths, tables, *, window: int = 0,
                    softcap: float = 0.0):
    """One decode step against the block-table KV cache.

    q: (B, Hk, rep, D); pools: (NB, bs, Hk, D); lengths: (B,) int32 —
    lane ``b`` attends positions ``[0, lengths[b]]``; tables: (B, nb)
    int32 block-table rows.  Returns (B, Hk, rep, D) in q.dtype.
    """
    _check(q, k_pool, v_pool, lengths, tables)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, lengths, tables,
                                   window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not {q.device}")
    B, Hk, rep, D = q.shape
    bs = k_pool.shape[1]
    nb = tables.shape[1]
    if D not in _HEAD_DIMS or not 1 <= rep <= MAX_REP \
            or not 1 <= bs <= MAX_BLOCK_SIZE or nb < 1:
        raise ValueError(f"unsupported shape: D={D} (of {_HEAD_DIMS}), rep="
                         f"{rep} (<= {MAX_REP}), bs={bs} (<= "
                         f"{MAX_BLOCK_SIZE}), nb={nb}")
    if not all(t.is_contiguous() for t in (q, k_pool, v_pool, lengths, tables)):
        raise ValueError("paged_attention kernel needs contiguous inputs")
    fn = _build.load("paged_attention").paged_attention_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            lengths.data_ptr(), tables.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, Hk, rep, D, bs, nb, int(window),
            float(softcap), float(D ** -0.5), stream)
    _build.check(rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
