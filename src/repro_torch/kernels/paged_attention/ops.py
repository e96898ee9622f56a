"""Public wrapper for the paged decode-attention kernel.

On a CUDA tensor ``paged_attention`` launches the hand-written sm_90a
kernel (``csrc/paged_attention.cu``) on PyTorch's current stream and adds
one to ``paged_attention.launches``; on a CPU tensor it runs the plain
version (``ref.paged_attention_ref``).  There is no fallback: a CUDA
tensor the kernel does not take raises.  Decode-only: no backward.

The kernel splits each lane's table into ``n_split`` pieces of
``blocks_per_split`` blocks (:func:`split_plan`, from the table's width
and the block size: shapes only, so the grid is the same every step and a
call makes no host sync), writes each live split's softmax partial to
fp32 scratch (:func:`scratch_shapes`, allocated here with
``torch.empty``) and merges a lane's splits in a second device kernel:
one call, one count in ``launches``, ``DEVICE_KERNELS`` device kernels.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from .ref import paged_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64,)                # compiled head dims (csrc)
MAX_REP = 8                     # query heads per KV head the kernel holds
MAX_BLOCK_SIZE = 32             # positions per table block the kernel takes
SPLIT_POSITIONS = 64            # positions one split holds at most (csrc)
DEVICE_KERNELS = 2              # per call: the splits, then their combine
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])


def split_plan(nb: int, bs: int) -> tuple[int, int]:
    """``(blocks_per_split, n_split)`` for a table of ``nb`` blocks of ``bs``
    positions: as many whole blocks as fit in ``SPLIT_POSITIONS``
    positions (at least one), and enough splits to cover the table."""
    bps = max(1, SPLIT_POSITIONS // bs)
    return bps, -(-nb // bps)


def scratch_shapes(B: int, Hk: int, rep: int, D: int, n_split: int) -> dict:
    """Shapes of the splits' fp32 partials (m, l, acc), which the kernel
    reads from one buffer in this order."""
    return {"m": (B, Hk, n_split, rep), "l": (B, Hk, n_split, rep),
            "acc": (B, Hk, n_split, rep, D)}


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


def _check_kernel(q, k_pool, v_pool, lengths, tables):
    """What the CUDA kernel takes beyond ``_check``: head dim 64, rep and
    block size within its limits, contiguous inputs, pools and q at
    16-byte aligned addresses (its ``cp.async`` copies move 16 bytes), and
    a grid that fits."""
    B, Hk, rep, D = q.shape
    bs, nb = k_pool.shape[1], tables.shape[1]
    if D not in _HEAD_DIMS or not 1 <= rep <= MAX_REP \
            or not 1 <= bs <= MAX_BLOCK_SIZE or nb < 1:
        raise ValueError(f"unsupported shape: D={D} (of {_HEAD_DIMS}), rep="
                         f"{rep} (<= {MAX_REP}), bs={bs} (<= "
                         f"{MAX_BLOCK_SIZE}), nb={nb}")
    if not all(t.is_contiguous() for t in (q, k_pool, v_pool, lengths, tables)):
        raise ValueError("paged_attention kernel needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_attention kernel needs 16-byte aligned q and pools")
    if Hk > 65535 or split_plan(nb, bs)[1] > 65535:
        raise ValueError(f"{Hk} KV heads or a table of {nb} blocks exceed the "
                         "kernel's grid")


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
    _check_kernel(q, k_pool, v_pool, lengths, tables)
    B, Hk, rep, D = q.shape
    bs = k_pool.shape[1]
    nb = tables.shape[1]
    bps, n_split = split_plan(nb, bs)
    shapes = scratch_shapes(B, Hk, rep, D, n_split)
    scratch = torch.empty(sum(math.prod(s) for s in shapes.values()),
                          dtype=torch.float32, device=q.device)
    fn = _build.entry("paged_attention", "paged_attention_fwd", _ARGTYPES)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            lengths.data_ptr(), tables.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), _DTYPES[q.dtype], B, Hk, rep, D, bs, nb, bps,
            n_split, int(window), float(softcap), float(D ** -0.5), stream)
    _build.check(rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
