"""Attention: RoPE, chunked (flash-style) attention, slotted and paged decode.

The port of the reference's ``models/attention.py``.
``chunked_attention`` is the plain prefill path: an online-softmax loop
over query/key chunks so the (S x S) score matrix is never materialised —
the same blocking the CUDA kernel (kernels/flash_attention) uses, and its
yardstick.  ``decode_attention`` is the slotted decode step, on one
device or with each lane's positions split over a mesh's model axis (or,
under the batch fallback, over every rank) and the ranks' softmax
partials combined by log-sum-exp (``DecodeSharding``, the reference's
sequence-sharded ``shard_fn``).  The paged decode runs on a data rank's
share of the pool's blocks the same way: every lane attends the rank's
blocks and the ranks' normalised partials merge by log-sum-exp
(:func:`data_combine`).

Cache writes are in place: JAX returns updated caches, the port updates
the caller's cache tensors (a layer's slice of the stacked cache is a
view) and returns only the attention output.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

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


def _masked_decode_lse(q, k, v, valid, softcap: float):
    """q (B, Hk, rep, D); k/v (B, S, Hk, D); valid (B, S).  One masked
    fp32 softmax — shared by the slotted path and the paged plain version,
    so the two layouts are bitwise equal on equal logical inputs.  Returns
    ``(out, m, l)`` in fp32: the output before its rounding to q's dtype,
    the row maxima and sums of the softmax ((B, Hk, rep)); a row with no
    valid position gives ``m = NEG_INF``, ``l = 0`` and a zero output."""
    s = torch.einsum("bhrd,bshd->bhrs", q.float(), k.float()) * (q.shape[-1] ** -0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, NEG_INF)
    m = s.amax(dim=-1)
    # a masked position's exp(NEG_INF - m) is 0 wherever one is valid
    p = torch.where(vmask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhrs,bshd->bhrd", p, v.float())
    return o / torch.clamp_min(l, 1e-30)[..., None], m, l


def _masked_decode_softmax(q, k, v, valid, softcap: float):
    """:func:`_masked_decode_lse`'s output alone, in q's dtype."""
    return _masked_decode_lse(q, k, v, valid, softcap)[0].to(q.dtype)


def lse_weights(m, l):
    """Each rank's weight in a log-sum-exp merge of normalised partial
    outputs.  m, l: (R, ...) the ranks' softmax maxima and sums, in rank
    order.  ``a_r = l_r exp(m_r - M)``, ``M`` the largest ``m`` floored at
    -1e30 (a rank with nothing to attend has ``m = NEG_INF``, ``l = 0``
    and weight 0), and the weight ``a_r / sum(a)``: at one rank ``l / l``,
    exactly 1, so the merged output is the rank's own bitwise."""
    m_g = torch.clamp_min(m.amax(dim=0), -1e30)
    a = l * torch.exp(m - m_g)
    return a / torch.clamp_min(a.sum(dim=0), 1e-30)


def combine_partials(outs, ms, ls, dtype=None):
    """The ranks' normalised partials ``(o_r, m_r, l_r)`` (lists in rank
    order; o (B, Hk, rep, D), m and l (B, Hk, rep), all fp32) merged in
    one process: ``sum_r o_r w_r`` (:func:`lse_weights`) in fp32, summed
    in rank order, then rounded once to ``dtype`` (default o's).
    :func:`data_combine` is the same merge over a process group."""
    w = lse_weights(torch.stack(ms), torch.stack(ls))
    acc = outs[0].float() * w[0][..., None]
    for o, wr in zip(outs[1:], w[1:]):
        acc = acc + o.float() * wr[..., None]
    return acc.to(dtype or outs[0].dtype)


def data_combine(o, m, l, group, dtype=None):
    """:func:`combine_partials` over ``group`` (a ``DataGroup`` view: the
    data ranks, each holding a share of the pool's blocks): the ranks'
    ``(m, l)`` all-gathered, each rank's weight computed from them, then
    one ``all_reduce`` (SUM) of ``o w``.  Two collectives, counted in
    ``common.COUNTS["data_combine"]``; every rank ends with the same
    output, rounded once to ``dtype`` (default o's)."""
    from .common import COUNTS

    ml = torch.stack([m, l])
    every = torch.empty((group.world * 2,) + tuple(m.shape), dtype=ml.dtype, device=ml.device)
    dist.all_gather_into_tensor(every, ml, group=group.pg)
    every = every.view((group.world, 2) + tuple(m.shape))
    w = lse_weights(every[:, 0], every[:, 1])[group.rank]
    out = o.float() * w[..., None]
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group.pg)
    COUNTS["data_combine"] += 2
    return out.to(dtype or o.dtype)


@dataclasses.dataclass(frozen=True)
class DecodeSharding:
    """How the slotted KV cache lies on a mesh for decoding: the
    reference's ``DecodeSharding``, the axes that split the lanes and the
    axes that split each lane's positions.  :meth:`choose` makes the
    reference's choice and the port realises both halves: a rank holds
    the lanes :meth:`local_lanes` gives (contiguous, in the row-major order
    of ``("pod", "data")``, as ``P(("pod", "data"))`` lays them out), each
    with :meth:`local_len` of its positions, those of its rank in
    :attr:`seq_group`."""

    mesh: Any
    batch_axes: tuple[str, ...]
    seq_axes: tuple[str, ...]

    @classmethod
    def choose(cls, mesh, batch: int) -> "DecodeSharding":
        """Lanes over the data axes where ``batch`` divides over them,
        else (a batch too small: long context, batch 1) the positions
        over every axis; the positions over ``model`` either way."""
        dp = tuple(a for a in ("pod", "data") if a in mesh.axes)
        tp = ("model",) if "model" in mesh.axes else ()
        ndp = math.prod(mesh.size(a) for a in dp)
        if batch % ndp == 0 and batch >= ndp:
            return cls(mesh, dp, tp)
        return cls(mesh, (), dp + tp)

    @property
    def lane_ranks(self) -> int:
        """Ranks the lanes split over (1: every rank holds every lane)."""
        return math.prod(self.mesh.size(a) for a in self.batch_axes)

    @property
    def seq_ranks(self) -> int:
        """Ranks each lane's positions split over."""
        return math.prod(self.mesh.size(a) for a in self.seq_axes)

    def local_len(self, max_len: int) -> int:
        """Positions of a lane this rank holds: ``max_len`` over the
        product of the sequence axes (it must divide)."""
        n = self.seq_ranks
        if max_len % n:
            raise ValueError(f"max_len {max_len} does not divide over {n} ranks of "
                             f"{self.seq_axes} (the slotted cache splits each lane's "
                             f"positions over them; round it up to a multiple of {n})")
        return max_len // n

    def local_lanes(self, max_slots: int) -> tuple[int, int]:
        """``[lo, hi)``: the lanes of ``max_slots`` this rank holds, its
        rank over the data axes times ``max_slots / ndp`` on (every lane
        where the lanes do not split)."""
        n = self.lane_ranks
        if n == 1:
            return 0, max_slots
        per = max_slots // n
        r = self.mesh.data.rank
        return r * per, (r + 1) * per

    def local_slot(self, slot: int, held: int) -> int | None:
        """Global lane ``slot``'s index among the ``held`` lanes a cache
        leaf holds on this rank (:meth:`local_lanes` of ``held`` times
        :attr:`lane_ranks`), None where another data rank holds it."""
        lo = self.local_lanes(held * self.lane_ranks)[0]
        return slot - lo if lo <= slot < lo + held else None

    def holder(self, slot: int, held: int) -> int:
        """The data rank whose cache holds global lane ``slot``, each data
        rank holding ``held`` lanes (where the lanes split over the data
        axes)."""
        return slot // held

    @property
    def seq_group(self):
        """The group (a ``DataGroup`` view) each lane's positions split
        over, a rank's index in it its share: the model axis, or under the
        batch fallback every rank in the order of the reference's
        ``axis_index(("pod", "data", "model"))``, row-major, which is the
        world's rank order (``launch.mesh.mesh_coords``)."""
        if self.seq_axes == ("model",):
            return self.mesh.model
        from repro_torch.launch.mesh import DataGroup

        m = self.mesh
        return DataGroup(m.pg, m.rank, m.world, m.device)


def decode_attention(q, k_cache, v_cache, k_new, v_new, cur_index, *,
                     window: int = 0, softcap: float = 0.0, seq_group=None):
    """One decoding step against a slotted KV cache.

    q:               (B, Hk, rep, D) — current-token queries (RoPE applied)
    k_cache/v_cache: (B, S, Hk, D) — written IN PLACE at ``cur_index``
    k_new/v_new:     (B, Hk, D) — the current token's K/V
    cur_index:       tokens already in the cache: a scalar (every row at
                     the same position) or a ``(B,)`` vector (each lane at
                     its own position); writes and masks are per row
    seq_group:       the group (``DataGroup`` view) the positions split
                     over, or None.  With one, the cache holds this rank's
                     ``S`` positions from ``rank S`` on, as the reference's
                     ``shard_fn``: the write lands where the position is
                     this rank's (``rel``, ``in_range``), the softmax runs
                     over the local positions, and the ranks' partials
                     combine by log-sum-exp: MAX of the local maxima (floored
                     at -1e30), then one SUM of ``l * corr`` and ``o * corr``.
                     Over one rank that is this function without one,
                     bitwise, wherever a position is valid.

    Returns out (B, Hk, rep, D).
    """
    if seq_group is not None and seq_group.pg is not None:
        return _decode_attention_seq(q, k_cache, v_cache, k_new, v_new, cur_index,
                                     window=window, softcap=softcap, group=seq_group)
    valid = _write_slots(k_cache, v_cache, k_new, v_new, cur_index, 0, window)
    return _masked_decode_softmax(q, k_cache, v_cache, valid, softcap)


def _write_slots(k_cache, v_cache, k_new, v_new, cur_index, start: int, window: int):
    """Write each row's new k/v at position ``cur_index`` where it lies in
    the cache's positions ``[start, start + S)`` (the rest keep theirs:
    the reference's ``rel`` / ``in_range`` / clipped write), in place;
    returns the (B, S) mask of the positions each row attends."""
    B, S = k_cache.shape[:2]
    dev = k_cache.device
    idx = torch.broadcast_to(
        torch.as_tensor(cur_index, dtype=torch.int64, device=dev), (B,))
    rel = idx - start
    rows = torch.arange(B, device=dev)
    safe = rel.clamp(0, S - 1)
    in_range = ((rel >= 0) & (rel < S))[:, None, None]
    for c, new in ((k_cache, k_new), (v_cache, v_new)):
        c[rows, safe] = torch.where(in_range, new.to(c.dtype), c[rows, safe])
    pos = start + torch.arange(S, device=dev)
    valid = pos[None, :] <= idx[:, None]
    if window:
        valid &= pos[None, :] > idx[:, None] - window
    return valid


def _decode_attention_seq(q, k_cache, v_cache, k_new, v_new, cur_index, *,
                          window: int, softcap: float, group):
    """:func:`decode_attention` on this rank's positions of each lane,
    combined over ``group`` (two ``all_reduce`` calls, counted in
    ``common.COUNTS["decode_combine"]``)."""
    from .common import COUNTS

    valid = _write_slots(k_cache, v_cache, k_new, v_new, cur_index,
                         group.rank * k_cache.shape[1], window)
    s = torch.einsum("bhrd,bshd->bhrs", q.float(), k_cache.float()) * (q.shape[-1] ** -0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m_loc = s.amax(dim=-1)
    p = torch.exp(s - m_loc[..., None])
    l_loc = p.sum(dim=-1)
    o_loc = torch.einsum("bhrs,bshd->bhrd", p, v_cache.float())
    m_g = m_loc.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group.pg)
    corr = torch.exp(m_loc - torch.clamp_min(m_g, -1e30))
    both = torch.cat([(l_loc * corr)[..., None], o_loc * corr[..., None]], dim=-1)
    dist.all_reduce(both, op=dist.ReduceOp.SUM, group=group.pg)
    COUNTS["decode_combine"] += 2
    return (both[..., 1:] / torch.clamp_min(both[..., 0], 1e-30)[..., None]).to(q.dtype)


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


def _write_rows(flat, rows, new, blocks, bs: int):
    """``flat[..., rows, :, :] = new`` along the row axis (``flat.dim() -
    3``), in place, where ``rows`` are flat rows of the global pool.  With
    ``blocks = (lo, n)`` ``flat`` holds the global blocks ``[lo, lo + n)``:
    only the entries in them are written (at their local rows), and no
    host sync decides which: an entry of another rank's block rewrites the
    local row of this call's first local entry with that entry's value,
    or, when no entry is local, local row 0 with what it holds, so that
    rows written twice always receive one value."""
    ax = flat.dim() - 3
    lead = (slice(None),) * ax
    if blocks is None:
        flat[lead + (rows,)] = new.to(flat.dtype)
        return
    lo, n = blocks
    blk = rows // bs
    local = (blk >= lo) & (blk < lo + n)
    lrows = rows - lo * bs
    first = torch.argmax(local.to(torch.int32)).reshape(1)   # the first local entry, or 0
    any_local = local.any()
    target = torch.where(any_local, lrows.index_select(0, first), 0)
    fill = torch.where(any_local, new.index_select(ax, first).to(flat.dtype),
                       flat.index_select(ax, target))
    shape = (-1,) + (1,) * (new.dim() - ax - 1)
    vals = torch.where(local.view(shape), new.to(flat.dtype), fill)
    flat[lead + (torch.where(local, lrows, target),)] = vals


def paged_write_token(pool, tables, lengths, new, blocks=None):
    """Write one new token's K or V per lane at logical ``lengths[b]``,
    in place.  pool: (NB, bs, Hk, D); tables: (B, nb); new: (B, Hk, D).
    Lanes whose block for that position is unmapped write into the sink.
    ``blocks``: ``(lo, NB)``, the global blocks the pool holds (a data
    rank's share): only the lanes whose block is one of them write."""
    NB, bs = pool.shape[:2]
    nb = tables.shape[1]
    lengths = lengths.long()
    li = torch.clamp(lengths // bs, 0, nb - 1)
    blk = torch.gather(tables.long(), 1, li[:, None])[:, 0]
    off = torch.clamp(lengths - li * bs, 0, bs - 1)
    flat = pool.view(NB * bs, *pool.shape[2:])
    _write_rows(flat, blk * bs + off, new, blocks, bs)


def paged_write_positions(pool, table, positions, new, valid=None, blocks=None):
    """Scatter a chunk of positions of ONE lane into the pool, in place.

    pool: (NB, bs, Hk, D) or layer-stacked (L, NB, bs, Hk, D);
    table: (nb,) int32; positions: (P,); new matches pool's lead plus
    (P, Hk, D).  ``valid=False`` positions (prompt padding) go to the sink.
    ``blocks``: as :func:`paged_write_token`'s.
    """
    stacked = pool.dim() == 5
    NB, bs = (pool.shape[1], pool.shape[2]) if stacked else pool.shape[:2]
    rows = _physical_rows(table, positions.long(), bs, table.shape[0])
    if valid is not None:
        rows = torch.where(valid, rows, torch.zeros_like(rows))
    if stacked:
        flat = pool.view(pool.shape[0], NB * bs, *pool.shape[3:])
    else:
        flat = pool.view(NB * bs, *pool.shape[2:])
    _write_rows(flat, rows, new, blocks, bs)


def gather_lane(pool, table_row, group=None):
    """One lane's positions from the pool in logical order, ``(1, nb * bs,
    ...)`` (:func:`paged_gather` of one table row).  With ``group`` the
    pool is this rank's share of a pool whose blocks split over the
    group's ranks (the global blocks ``[rank NB, (rank + 1) NB)``): each
    rank gathers its blocks of the lane, zeros for the others', and one
    ``all_reduce`` (SUM) over ``group`` assembles the lane exactly (every
    position comes from one rank, the others add zeros), counted in
    ``common.COUNTS["block_gather"]``."""
    if group is None:
        return paged_gather(pool, table_row[None])
    from .common import COUNTS

    n = pool.shape[0]
    t = table_row.long() - group.rank * n
    local = (t >= 0) & (t < n)
    g = pool[torch.where(local, t, 0)]                       # (nb, bs, ...)
    g = torch.where(local.view((-1,) + (1,) * (g.dim() - 1)), g, 0.0)
    dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group.pg)
    COUNTS["block_gather"] += 1
    return g.reshape(1, -1, *pool.shape[2:])


def paged_decode_attention(
    q, k_pool, v_pool, k_new, v_new, lengths, tables, *,
    window: int = 0,
    softcap: float = 0.0,
    impl: str = "ref",
    kv_heads: tuple[int, int] | None = None,
    data_group=None,
):
    """One decoding step against the paged (block-table) KV cache.

    q:             (B, Hk, rep, D) — current-token queries (RoPE applied)
    k_pool/v_pool: (NB, bs, Hp, D) — the shared block pool, written in place
    k_new/v_new:   (B, Hp, D) — written at logical position ``lengths[b]``
                   before attention, so the attention reads it
    lengths:       (B,) int32 — tokens already in each lane
    tables:        (B, nb) int32 — the lanes' block-table rows
    impl:          "ref" gathers lanes and runs the masked softmax (bitwise
                   equal to the slotted ``decode_attention`` on equal
                   inputs); "kernel" launches the block-walking CUDA kernel
                   (kernels/paged_attention), which never gathers.
    kv_heads:      ``(lo, hi)``: q attends the pool's heads ``[lo, hi)``
                   (``Hk = hi - lo``; a view of the pool, no copy), else
                   every one (``Hk = Hp``)
    data_group:    with one, the pools are this rank's share of a pool
                   whose blocks split over the group (the global blocks
                   ``[rank NB, (rank + 1) NB)``): the new token is written
                   where its block is this rank's, every lane attends the
                   rank's blocks (the kernel's block-range entry
                   ``paged_attention_range`` or the plain version's, with
                   the softmax's ``(m, l)``), and the ranks' partials
                   merge by log-sum-exp (:func:`data_combine`).

    Returns out (B, Hk, rep, D).
    """
    if impl not in ("ref", "kernel"):
        raise ValueError(f"unknown paged attention impl {impl!r}")
    NB = k_pool.shape[0]
    blocks = None if data_group is None or data_group.world == 1 \
        else (data_group.rank * NB, NB)
    paged_write_token(k_pool, tables, lengths, k_new, blocks)
    paged_write_token(v_pool, tables, lengths, v_new, blocks)
    if kv_heads is not None:
        lo, hi = kv_heads
        k_pool, v_pool = k_pool.narrow(2, lo, hi - lo), v_pool.narrow(2, lo, hi - lo)
    from repro_torch.kernels.paged_attention import ops, ref

    lo = None if data_group is None else data_group.rank * NB
    if impl == "kernel":
        if lo is None:
            return ops.paged_attention(q, k_pool, v_pool, lengths, tables, window=window,
                                       softcap=softcap)
        o, m, l = ops.paged_attention_range(q, k_pool, v_pool, lengths, tables, block_lo=lo,
                                            window=window, softcap=softcap)
    else:
        if lo is None:
            return ref.paged_attention_ref(q, k_pool, v_pool, lengths, tables, window=window,
                                           softcap=softcap)
        o, m, l = ref.paged_attention_ref(q, k_pool, v_pool, lengths, tables, window=window,
                                          softcap=softcap, block_lo=lo, with_lse=True)
    return data_combine(o, m, l, data_group, q.dtype)
