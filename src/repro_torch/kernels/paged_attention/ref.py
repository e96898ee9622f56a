"""Plain PyTorch version of the paged decode-attention kernel.

Gathers each lane's blocks into logical order and runs the masked softmax
— the memory-expensive path the kernel avoids (the kernel walks the block
table and reads each mapped block once, straight from the pool).  The
softmax is the slotted decode path's own (``_masked_decode_lse``), so
paged "ref" decoding is bitwise equal to slotted decoding; with a block
range the entries outside it are masked like positions past the length.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import _masked_decode_lse, paged_gather


def paged_attention_ref(q, k_pool, v_pool, lengths, tables, *,
                        window: int = 0, softcap: float = 0.0, block_lo: int = 0,
                        with_lse: bool = False):
    """q: (B, Hk, rep, D); pools: (NB, bs, Hk, D), the global blocks
    ``[block_lo, block_lo + NB)``; lengths: (B,); tables: (B, nb) of
    global ids, an entry outside the pools' range masked.  Returns (B,
    Hk, rep, D) in q.dtype, or with ``with_lse`` ``(out, m, l)``, all
    fp32 (m and l (B, Hk, rep)), as the block-range entry returns them."""
    bs = k_pool.shape[1]
    local = tables.long() - block_lo
    held = (local >= 0) & (local < k_pool.shape[0])
    rows = torch.where(held, local, 0)
    k, v = paged_gather(k_pool, rows), paged_gather(v_pool, rows)
    lengths = lengths.long()
    pos = torch.arange(k.shape[1], device=q.device)
    valid = (pos[None, :] <= lengths[:, None]) & held.repeat_interleave(bs, dim=1)
    if window:
        valid &= pos[None, :] > lengths[:, None] - window
    o, m, l = _masked_decode_lse(q, k, v, valid, softcap)
    return (o, m, l) if with_lse else o.to(q.dtype)
