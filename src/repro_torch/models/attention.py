"""Attention: RoPE, chunked (flash-style) attention, slotted and paged decode.

The port of the reference's ``models/attention.py`` for one device.
``chunked_attention`` is the plain prefill path: an online-softmax loop
over query/key chunks so the (S x S) score matrix is never materialised —
the same blocking the CUDA kernel (kernels/flash_attention) uses, and its
yardstick.  ``decode_attention`` is the slotted decode step without the
reference's sequence sharding (one device holds every lane).

Cache writes are in place: JAX returns updated caches, the port updates
the caller's cache tensors (a layer's slice of the stacked cache is a
view) and returns only the attention output.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int, theta: float = 10_000.0):
    """RoPE's ``(cos, sin)`` for ``positions`` (..., S), each (..., S, 1,
    head_dim // 2) fp32.  A forward computes them once and hands them to
    every layer's :func:`apply_rope` (q and k alike)."""
    half = head_dim // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=positions.device)
        * (math.log(theta) / half))
    angles = positions[..., :, None].float() * freqs        # (..., S, half)
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotary embedding of x (..., S, H, D) from :func:`rope_tables`, in
    fp32, cast back."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0):
    """Rotary embedding in fp32, cast back.  x: (..., S, H, D);
    positions: (..., S)."""
    return apply_rope(x, *rope_tables(positions.to(x.device), x.shape[-1], theta))


# ---------------------------------------------------------------------------
# Chunked attention (prefill)
# ---------------------------------------------------------------------------

def pick_chunk(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is <= target (attention chunk size)."""
    c = min(target, n)
    while n % c:
        c -= 1
    return max(c, 1)


def _mask_scores(s, pos_q, pos_k, causal, window, kv_len):
    """s: (..., Q, K) fp32; pos_q: (Q,), pos_k: (K,)."""
    ok = torch.ones((pos_q.shape[0], pos_k.shape[0]), dtype=torch.bool,
                    device=s.device)
    if causal:
        ok &= pos_k[None, :] <= pos_q[:, None]
    if window:
        ok &= pos_k[None, :] > pos_q[:, None] - window
    if kv_len is not None:
        ok &= pos_k[None, :] < kv_len
    return torch.where(ok, s, NEG_INF)


def chunked_attention(
    q, k, v, *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_chunk: int = 256,
    kv_chunk: int = 256,
    q_offset: int = 0,
    kv_len=None,
):
    """Memory-bounded attention.

    q: (B, Sq, H, D); k/v: (B, Sk, Hk, D) with H % Hk == 0 (GQA).
    Sliding-window causal attention visits only the static band of KV
    chunks that can hold unmasked keys; full attention visits every KV
    chunk with masking.  Returns (B, Sq, H, D) in q.dtype.
    """
    B, Sq, H, D = q.shape
    _, Sk, Hk, _ = k.shape
    rep = H // Hk
    scale = D ** -0.5
    dev = q.device

    q_chunk = pick_chunk(Sq, q_chunk)
    kv_chunk = pick_chunk(Sk, kv_chunk)
    nq, nk = Sq // q_chunk, Sk // kv_chunk

    qg = q.reshape(B, nq, q_chunk, Hk, rep, D).permute(1, 0, 3, 4, 2, 5)
    # qg: (nq, B, Hk, rep, qc, D)
    kg = k.reshape(B, nk, kv_chunk, Hk, D).permute(1, 0, 3, 2, 4)  # (nk,B,Hk,kc,D)
    vg = v.reshape(B, nk, kv_chunk, Hk, D).permute(1, 0, 3, 2, 4)

    band = bool(causal and window and window < Sk and q_chunk == kv_chunk
                and q_offset == 0)
    # q-chunk rows [iC, iC+C-1] may attend keys in [iC - window + 1, iC + C - 1]
    # -> ceil((window + C - 1) / C) KV chunks ending at chunk i.
    nb = int(math.ceil((window + kv_chunk - 1) / kv_chunk)) if band else nk

    outs = []
    for i in range(nq):
        qi = qg[i].float()
        pos_q = q_offset + i * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, Hk, rep, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hk, rep, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hk, rep, q_chunk, D), dtype=torch.float32,
                          device=dev)
        for jn in range(nb):
            if band:
                j = i - jn
                if j < 0:
                    # a band step before chunk 0 is fully masked: with a
                    # finite running max it changes nothing, so skip it
                    continue
            else:
                j = jn
            kj, vj = kg[j].float(), vg[j].float()
            pos_k = j * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bhrqd,bhkd->bhrqk", qi, kj) * scale
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            s = _mask_scores(s, pos_q, pos_k, causal, window, kv_len)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhrqk,bhkd->bhrqd", p, vj)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.to(q.dtype))
    out = torch.stack(outs)          # (nq, B, Hk, rep, qc, D) -> (B, Sq, H, D)
    return out.permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, H, D)


# ---------------------------------------------------------------------------
# Slotted decode (one device)
# ---------------------------------------------------------------------------


def _masked_decode_softmax(q, k, v, valid, softcap: float):
    """q (B, Hk, rep, D); k/v (B, S, Hk, D); valid (B, S).  One masked
    fp32 softmax — shared by the slotted path and the paged plain version,
    so the two layouts are bitwise equal on equal logical inputs."""
    s = torch.einsum("bhrd,bshd->bhrs", q.float(), k.float()) * (q.shape[-1] ** -0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhrs,bshd->bhrd", p, v.float())
    return (o / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def decode_attention(q, k_cache, v_cache, k_new, v_new, cur_index, *,
                     window: int = 0, softcap: float = 0.0):
    """One decoding step against a slotted KV cache.

    q:               (B, Hk, rep, D) — current-token queries (RoPE applied)
    k_cache/v_cache: (B, S, Hk, D) — written IN PLACE at ``cur_index``
    k_new/v_new:     (B, Hk, D) — the current token's K/V
    cur_index:       tokens already in the cache: a scalar (every row at
                     the same position) or a ``(B,)`` vector (each lane at
                     its own position); writes and masks are per row

    Returns out (B, Hk, rep, D).
    """
    B, S = k_cache.shape[:2]
    dev = q.device
    idx = torch.broadcast_to(
        torch.as_tensor(cur_index, dtype=torch.int64, device=dev), (B,))
    rows = torch.arange(B, device=dev)
    safe = idx.clamp(0, S - 1)
    in_range = ((idx >= 0) & (idx < S))[:, None, None]
    for c, new in ((k_cache, k_new), (v_cache, v_new)):
        c[rows, safe] = torch.where(in_range, new.to(c.dtype), c[rows, safe])
    pos = torch.arange(S, device=dev)
    valid = pos[None, :] <= idx[:, None]
    if window:
        valid &= pos[None, :] > idx[:, None] - window
    return _masked_decode_softmax(q, k_cache, v_cache, valid, softcap)


# ---------------------------------------------------------------------------
# Paged KV cache: block-table plumbing + paged decode
# ---------------------------------------------------------------------------
#
# The pool layout is (num_blocks, block_size, Hk, D): logical position ``p``
# of a lane lives at physical row ``table[p // bs] * bs + p % bs`` of the
# flattened pool.  Physical block 0 is a write sink (serve/paged.py reserves
# it): unmapped table entries and invalid positions route writes there, so
# garbage never lands in a live block and the sink is never read.


def paged_gather(pool, tables):
    """Lanes from the pool in logical position order.

    pool: (NB, bs, ...); tables: (B, nb) int32.  Returns (B, nb*bs, ...).
    """
    g = pool[tables.long()]                              # (B, nb, bs, ...)
    return g.reshape(tables.shape[0], -1, *pool.shape[2:])


def _physical_rows(table, positions, bs: int, nb: int):
    """Flat pool rows for logical ``positions`` under one table row;
    out-of-range positions clamp into the last block."""
    li = torch.clamp(positions // bs, 0, nb - 1)
    blk = table.long()[li]
    off = torch.clamp(positions - li * bs, 0, bs - 1)
    return blk * bs + off


def paged_write_token(pool, tables, lengths, new):
    """Write one new token's K or V per lane at logical ``lengths[b]``,
    in place.  pool: (NB, bs, Hk, D); tables: (B, nb); new: (B, Hk, D).
    Lanes whose block for that position is unmapped write into the sink.
    """
    NB, bs = pool.shape[:2]
    nb = tables.shape[1]
    lengths = lengths.long()
    li = torch.clamp(lengths // bs, 0, nb - 1)
    blk = torch.gather(tables.long(), 1, li[:, None])[:, 0]
    off = torch.clamp(lengths - li * bs, 0, bs - 1)
    flat = pool.view(NB * bs, *pool.shape[2:])
    flat[blk * bs + off] = new.to(pool.dtype)


def paged_write_positions(pool, table, positions, new, valid=None):
    """Scatter a chunk of positions of ONE lane into the pool, in place.

    pool: (NB, bs, Hk, D) or layer-stacked (L, NB, bs, Hk, D);
    table: (nb,) int32; positions: (P,); new matches pool's lead plus
    (P, Hk, D).  ``valid=False`` positions (prompt padding) go to the sink.
    """
    stacked = pool.dim() == 5
    NB, bs = (pool.shape[1], pool.shape[2]) if stacked else pool.shape[:2]
    rows = _physical_rows(table, positions.long(), bs, table.shape[0])
    if valid is not None:
        rows = torch.where(valid, rows, torch.zeros_like(rows))
    if stacked:
        flat = pool.view(pool.shape[0], NB * bs, *pool.shape[3:])
        flat[:, rows] = new.to(pool.dtype)
    else:
        flat = pool.view(NB * bs, *pool.shape[2:])
        flat[rows] = new.to(pool.dtype)


def paged_decode_attention(
    q, k_pool, v_pool, k_new, v_new, lengths, tables, *,
    window: int = 0,
    softcap: float = 0.0,
    impl: str = "ref",
):
    """One decoding step against the paged (block-table) KV cache.

    q:             (B, Hk, rep, D) — current-token queries (RoPE applied)
    k_pool/v_pool: (NB, bs, Hk, D) — the shared block pool, written in place
    k_new/v_new:   (B, Hk, D) — written at logical position ``lengths[b]``
                   before attention, so the attention reads it
    lengths:       (B,) int32 — tokens already in each lane
    tables:        (B, nb) int32 — the lanes' block-table rows
    impl:          "ref" gathers lanes and runs the masked softmax (bitwise
                   equal to the slotted ``decode_attention`` on equal
                   inputs); "kernel" launches the block-walking CUDA kernel
                   (kernels/paged_attention), which never gathers.

    Returns out (B, Hk, rep, D).
    """
    if impl not in ("ref", "kernel"):
        raise ValueError(f"unknown paged attention impl {impl!r}")
    paged_write_token(k_pool, tables, lengths, k_new)
    paged_write_token(v_pool, tables, lengths, v_new)
    if impl == "kernel":
        from repro_torch.kernels.paged_attention.ops import paged_attention
        return paged_attention(q, k_pool, v_pool, lengths, tables,
                               window=window, softcap=softcap)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    return paged_attention_ref(q, k_pool, v_pool, lengths, tables,
                               window=window, softcap=softcap)
