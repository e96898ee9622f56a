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

A data rank of a serving mesh holds a share of the pool's blocks: the
block-range entry ``paged_attention_range`` (its own ``launches``) takes
the pools as the global blocks ``[block_lo, block_lo + NB_local)``
(``pool.narrow(0, lo, n)`` or the rank's own tensor), the tables keep
global ids, and an entry outside the range is neither loaded nor scored.
It also returns the merged fp32 ``(m, l)`` of each ``(lane, head, rep)``
(the combine kernel writes them beside ``out``; no further launch), the
partial a log-sum-exp merge across ranks needs
(``models.attention.combine_partials``), and ``out`` in fp32; a lane with
no local block gives ``m = NEG_INF``, ``l = 0`` and a zero output.  With
``block_lo = 0`` and the whole pool its output rounded to q's dtype is
:func:`paged_attention`'s bitwise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from .ref import paged_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 160)       # compiled head dims (csrc)
MAX_REP = 16                    # query heads per KV head the kernel holds
MAX_BLOCK_SIZE = 32             # positions per table block the kernel takes
SPLIT_POSITIONS = 64            # positions one split holds at most (csrc)
DEVICE_KERNELS = 2              # per call: the splits, then their combine
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 13
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
    """What the CUDA kernel takes beyond ``_check``: head dim 64, 128 or 160,
    rep and block size within its limits, contiguous inputs, pools and q
    at 16-byte aligned addresses (its ``cp.async`` copies move 16 bytes),
    and a grid that fits."""
    B, Hk, rep, D = q.shape
    bs, nb = k_pool.shape[1], tables.shape[1]
    if D not in _HEAD_DIMS or not 1 <= rep <= MAX_REP \
            or not 1 <= bs <= MAX_BLOCK_SIZE or nb < 1:
        raise ValueError(f"unsupported shape: D={D} (of {_HEAD_DIMS}), rep="
                         f"{rep} (<= {MAX_REP}), bs={bs} (<= "
                         f"{MAX_BLOCK_SIZE}), nb={nb}")
    if not all(t.is_contiguous() for t in (q, lengths, tables)) \
            or pool_heads(k_pool) is None or pool_heads(v_pool) != pool_heads(k_pool):
        raise ValueError("paged_attention kernel needs contiguous q, lengths and tables "
                         "and pools that are contiguous or one head run of contiguous "
                         "pools of one shape")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_attention kernel needs 16-byte aligned q and pools")
    if Hk > 65535 or split_plan(nb, bs)[1] > 65535:
        raise ValueError(f"{Hk} KV heads or a table of {nb} blocks exceed the "
                         "kernel's grid")


def pool_heads(pool) -> int | None:
    """The heads per row of the contiguous pool that ``pool`` (NB, bs, Hk,
    D) is, or is a run of heads of (``pool[:, :, lo:hi]``): its row stride
    over ``D``; None for any other layout."""
    NB, bs, Hk, D = pool.shape
    st = pool.stride()
    if st[3] != 1 or st[2] != D or st[1] % D or st[1] < Hk * D or st[0] != bs * st[1]:
        return None
    return st[1] // D


def paged_attention(q, k_pool, v_pool, lengths, tables, *, window: int = 0,
                    softcap: float = 0.0):
    """One decode step against the block-table KV cache.

    q: (B, Hk, rep, D); pools: (NB, bs, Hk, D), contiguous or a run of
    heads of a wider contiguous pool (``pool.narrow(2, lo, Hk)``: the
    kernel reads rows ``pool_heads`` heads apart from the view's first
    head); lengths: (B,) int32 — lane ``b`` attends positions ``[0,
    lengths[b]]``; tables: (B, nb) int32 block-table rows.  Returns (B,
    Hk, rep, D) in q.dtype.
    """
    out = _paged(q, k_pool, v_pool, lengths, tables, window, softcap, 0, False)
    if q.device.type == "cuda":
        paged_attention.launches += 1
    return out


def paged_attention_range(q, k_pool, v_pool, lengths, tables, *, block_lo: int,
                          window: int = 0, softcap: float = 0.0):
    """The block-range entry: :func:`paged_attention` on a data rank's share
    of the pool.  The pools (a contiguous pool, a run of its heads, or
    blocks of one: ``pool.narrow(0, lo, n)``) hold the global blocks
    ``[block_lo, block_lo + NB)``; the tables keep global ids and a lane
    attends only its entries in that range.  Returns ``(out, m, l)``: out
    (B, Hk, rep, D) fp32 (a partial: rounding it to q's dtype before the
    merge across ranks would round twice), the softmax's merged max and
    sum (B, Hk, rep) fp32, a lane with no local block ``m = NEG_INF``, ``l
    = 0`` and a zero output (``models.attention.combine_partials`` merges
    ranks).  Over the whole pool ``out.to(q.dtype)`` is
    :func:`paged_attention`'s output bitwise.  Counted in its own
    ``launches``."""
    out = _paged(q, k_pool, v_pool, lengths, tables, window, softcap, block_lo, True)
    if q.device.type == "cuda":
        paged_attention_range.launches += 1
    return out


def _paged(q, k_pool, v_pool, lengths, tables, window, softcap, block_lo, with_lse):
    """Both entries: the plain version on CPU tensors, else one launch of
    the kernel (``ml`` null without ``with_lse``)."""
    _check(q, k_pool, v_pool, lengths, tables)
    if block_lo < 0:
        raise ValueError(f"block_lo {block_lo} < 0")
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, lengths, tables, window=window,
                                   softcap=softcap, block_lo=block_lo, with_lse=with_lse)
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
    out = torch.empty(q.shape, dtype=torch.float32 if with_lse else q.dtype, device=q.device)
    ml = torch.empty((2, B, Hk, rep), dtype=torch.float32, device=q.device) \
        if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            lengths.data_ptr(), tables.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), None if ml is None else ml.data_ptr(), _DTYPES[q.dtype],
            B, Hk, pool_heads(k_pool), rep, D, bs, nb, bps, n_split, int(window),
            int(block_lo), k_pool.shape[0], float(softcap), float(D ** -0.5), stream)
    _build.check(rc, "paged_attention")
    return (out, ml[0], ml[1]) if with_lse else out


paged_attention.launches = 0
paged_attention_range.launches = 0
