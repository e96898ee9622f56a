"""Plain PyTorch version of the paged decode-attention kernel.

Gathers each lane's blocks into logical order and runs the masked softmax
— the memory-expensive path the kernel avoids (the kernel walks the block
table and reads each mapped block once, straight from the pool).  The
softmax is the slotted decode path's own (``_masked_decode_softmax``), so
paged "ref" decoding is bitwise equal to slotted decoding.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import _masked_decode_softmax, paged_gather


def paged_attention_ref(q, k_pool, v_pool, lengths, tables, *,
                        window: int = 0, softcap: float = 0.0):
    """q: (B, Hk, rep, D); pools: (NB, bs, Hk, D); lengths: (B,);
    tables: (B, nb).  Returns (B, Hk, rep, D) in q.dtype."""
    k, v = paged_gather(k_pool, tables), paged_gather(v_pool, tables)
    lengths = lengths.long()
    pos = torch.arange(k.shape[1], device=q.device)
    valid = pos[None, :] <= lengths[:, None]
    if window:
        valid &= pos[None, :] > lengths[:, None] - window
    return _masked_decode_softmax(q, k, v, valid, softcap)
