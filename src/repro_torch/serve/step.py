"""Serving programs: prefill and decode steps of the continuous-batching
engine, with sampling fused on the device, and the host tier's transport.

The port of the reference's ``serve/step.py``: whole-prompt and chunked
prefill, the prefix cache's block copy, plain decode, speculative decoding
(draft and verify in one program, and the draft's prefill) and the four
spill/restore programs.  A "program" is a closure ``fn(params, state, ...)
-> (state, tok)`` that runs eagerly: it updates every tensor of the state
dict in place (no leaf is rebound, so a CUDA graph captured of the decode
program replays on the same buffers, ``core.aot``), and returns the
sampled tokens on the device — the host fetches one ``(max_slots,)``
int32 vector per decode step, never logits.  With ``fused=False`` (the
reference's host-sampling baseline) the prefill and decode programs
return the fp32 logits instead, and the host samples them and writes
``tokens``/``active`` back.

Under a mesh (``ServeEngine(mesh=)``) every program runs inside the
serving mesh program (``mesh_program``, a zero-argument callable that
makes the context: ``common.serve_program``), entered at each call, so a
captured decode graph holds the collectives it issues.

Where the reference branches on device values inside the program
(``lax.cond`` on "any lane samples" / "any lane masks"), an eager branch
would cost a host sync; the engine passes those two facts from its host
mirror (``stochastic``, ``masked``) instead, and they are derived from the
tensors only when left ``None``.  The engine always passes both, and keys
its captured decode graphs on them: a graph holds no host sync.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.models import registry
from repro_torch.models.attention import NEG_INF
from repro_torch.models.common import COUNTS, serve_split
from .cache import RecurrentCache
from .faults import NONFINITE_TOKEN, UNCOMMITTED
from .paged import Share


# ---------------------------------------------------------------------------
# Fused on-device sampling
# ---------------------------------------------------------------------------


def _nucleus_and_topk(z, ks, ps, safe_t):
    """Per-row top-k and top-p masks from ONE stable descending sort; the
    nucleus drops tokens whose exclusive cumulative probability (after
    temperature) already reaches p, so the top token always survives."""
    V = z.shape[-1]
    order = torch.argsort(-z, dim=-1, stable=True)
    z_sorted = torch.gather(z, -1, order)
    kth = torch.gather(z_sorted, -1, (ks.long() - 1).clamp(0, V - 1)[:, None])
    drop_k = (ks > 0)[:, None] & (z_sorted < kth)
    p_sorted = torch.softmax(
        torch.where(drop_k, NEG_INF, z_sorted) / safe_t, dim=-1)
    drop_p = ((ps > 0) & (ps < 1))[:, None] & (
        torch.cumsum(p_sorted, dim=-1) - p_sorted >= ps[:, None])
    drop = torch.empty_like(drop_k).scatter_(-1, order, drop_k | drop_p)
    return torch.where(drop, NEG_INF, z / safe_t)


def sampling_logits(logits, temps, top_k: int = 0, top_ks=None, top_ps=None,
                    *, masked=None):
    """The tempered, masked fp32 logits the stochastic rows sample from
    (masked entries are ``NEG_INF``).  ``top_k`` is one static k for every
    row; ``top_ks``/``top_ps`` are per-row (0 / outside (0, 1) = off)."""
    z = logits.float()
    if top_k:
        kth = torch.topk(z, top_k, dim=-1).values[..., -1:]
        z = torch.where(z < kth, NEG_INF, z)
    safe_t = torch.where(temps > 0, temps, 1.0)[:, None].float()
    if top_ks is None and top_ps is None:
        return z / safe_t
    B = z.shape[0]
    ks = torch.zeros(B, dtype=torch.int32, device=z.device) if top_ks is None else top_ks
    ps = torch.zeros(B, dtype=torch.float32, device=z.device) if top_ps is None else top_ps
    if masked is None:
        masked = bool(((ks > 0) | ((ps > 0) & (ps < 1))).any())
    return _nucleus_and_topk(z, ks, ps, safe_t) if masked else z / safe_t


def sample_tokens(logits, generator, temps, top_k: int = 0, top_ks=None,
                  top_ps=None, *, stochastic=None, masked=None):
    """Per-row sampling: rows with ``temp == 0`` take the argmax, rows with
    ``temp > 0`` draw from ``softmax(sampling_logits)`` (Gumbel-max with
    uniforms from ``generator``, a ``torch.Generator`` on the logits'
    device — the draws are not ``jax.random``'s bits).  Returns (B,)
    int32.  ``stochastic``/``masked`` are the host's knowledge of whether
    any row samples / any row masks (``None``: read from the tensors)."""
    greedy = logits.float().argmax(dim=-1).to(torch.int32)
    if stochastic is None:
        stochastic = bool((temps > 0).any())
    if not stochastic:
        return greedy
    zt = sampling_logits(logits, temps, top_k, top_ks, top_ps, masked=masked)
    u = torch.rand(zt.shape, generator=generator, device=zt.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    sampled = (zt + gumbel).argmax(dim=-1).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)


# ---------------------------------------------------------------------------
# Slot programs (continuous batching)
# ---------------------------------------------------------------------------


def _in_program(fn, mesh_program):
    """``fn`` run inside ``mesh_program()`` at every call (``fn`` itself
    without one)."""
    if mesh_program is None:
        return fn

    def run(*args, **kwargs):
        with mesh_program():
            return fn(*args, **kwargs)
    return run


def _decode_program(decode_fn, *, eos_id: int | None, freeze=None, fused: bool = True,
                    mesh_program=None):
    """Wrap a layout-specific ``decode_fn(params, state) -> (logits,
    cache)`` with the shared bookkeeping: fused sampling, non-finite
    detection (the :data:`NONFINITE_TOKEN` sentinel rides the token
    fetch), length advance and EOS/budget eviction, all on the device.
    ``fn(params, state, *, stochastic=None, masked=None) -> (state, tok)``.

    ``fused=False``: ``-> (state, logits (max_slots, V) fp32)``; only the
    lengths advance on the device, the host samples and writes ``tokens``
    and ``active`` back before the next step (so an evicted lane's
    recurrent leaves zero one program later).

    ``freeze(cache, active)`` (recurrent state kinds) zeroes the recurrent
    leaves of the lanes inactive after the step — evict-time zeroing in
    the same step (see :class:`~repro_torch.serve.cache.RecurrentCache`).
    A lane whose ``replay`` bit is set keeps its state: the host forces
    its recorded token next and may keep it alive though the device reads
    it as done (a spurious EOS resampled at another generator position).
    """

    def fn(params, state, *, stochastic=None, masked=None):
        logits, cache = decode_fn(params, state)
        active = state["active"]
        new_len = state["lengths"] + active.to(torch.int32)
        if not fused:
            if freeze is not None:
                freeze(cache, active | state["replay"])
            state["lengths"].copy_(new_len)
            return state, logits.float()
        tok = sample_tokens(logits, state["generator"], state["temps"],
                            top_ks=state["top_ks"], top_ps=state["top_ps"],
                            stochastic=stochastic, masked=masked)
        finite = torch.isfinite(logits).all(dim=-1)
        tok = torch.where(active, tok, 0).to(torch.int32)
        tok = torch.where(active & ~finite, NONFINITE_TOKEN, tok).to(torch.int32)
        done = active & finite & (new_len >= state["limits"])
        if eos_id is not None:
            done |= active & (tok == eos_id)
        act_new = active & ~done
        if freeze is not None:
            freeze(cache, act_new | state["replay"])
        state["tokens"].copy_(tok)
        state["lengths"].copy_(new_len)
        state["active"].copy_(act_new)
        return state, tok

    return _in_program(fn, mesh_program)


def slot_decode_program(cfg: ArchConfig, *, eos_id: int | None = None,
                        fused: bool = True, mesh_program=None):
    """One decode step over every lane of the slotted cache.

    Family-generic: ``mod.decode_step`` advances a KV cache (lm) or
    zamba's composed hybrid cache; recurrent leaves of inactive lanes are
    zeroed on the way out (:meth:`RecurrentCache.freeze`)."""
    mod = registry.get_module(cfg)
    rec = RecurrentCache(cfg)

    def decode_fn(params, state):
        return mod.decode_step(cfg, params, state["cache"], state["tokens"],
                               state["lengths"])

    return _decode_program(decode_fn, eos_id=eos_id,
                           freeze=rec.freeze if rec else None, fused=fused,
                           mesh_program=mesh_program)


def paged_decode_program(cfg: ArchConfig, *, eos_id: int | None = None,
                         impl: str = "ref", fused: bool = True, mesh_program=None):
    """One decode step over every lane of the paged cache: the same
    bookkeeping as :func:`slot_decode_program`, the cache walk through
    ``state["tables"]`` (``impl`` "ref" or "kernel")."""
    mod = registry.get_module(cfg)

    def decode_fn(params, state):
        return mod.decode_step_paged(
            cfg, params, state["cache"], state["tokens"], state["lengths"],
            state["tables"], impl=impl)

    return _decode_program(decode_fn, eos_id=eos_id, fused=fused, mesh_program=mesh_program)


def _seed_slot(state, slot, logits, *, length, limit, temp, top_k, top_p,
               is_last, eos_id, fused=True):
    """Shared tail of the prefill programs: write the lane's scheduling
    entries, sample its first token, and activate it unless it is already
    done.  Returns tok (1,) int32 (the sentinel on non-finite logits), or
    with ``fused=False`` the fp32 logits (the lane activates on the last
    chunk unless its budget is spent; the host samples and writes the
    token back)."""
    dev = logits.device
    state["lengths"][slot] = length
    state["limits"][slot] = limit
    state["temps"][slot] = temp
    state["top_ks"][slot] = top_k
    state["top_ps"][slot] = top_p
    if not fused:
        state["active"][slot] = bool(is_last and length < limit)
        return logits.float()
    tok = sample_tokens(
        logits, state["generator"],
        torch.tensor([temp], dtype=torch.float32, device=dev),
        top_ks=torch.tensor([top_k], dtype=torch.int32, device=dev),
        top_ps=torch.tensor([top_p], dtype=torch.float32, device=dev),
        stochastic=temp > 0, masked=top_k > 0 or 0 < top_p < 1)
    finite = torch.isfinite(logits).all()
    tok = torch.where(finite, tok, NONFINITE_TOKEN).to(torch.int32)
    alive = finite & (is_last and length < limit)
    if eos_id is not None:
        alive = alive & (tok[0] != eos_id)
    if is_last:
        state["tokens"][slot] = tok[0]
    state["active"][slot] = alive
    return tok


def slot_prefill_program(cfg: ArchConfig, *, eos_id: int | None = None,
                         fused: bool = True, mesh_program=None):
    """Admit one prompt into lane ``slot``: prefill its KV into the lane
    (prompt padded to a length bucket), sample the first token, and seed
    the slot's scheduling state.

    ``fn(params, state, prompt (1, bucket), slot, plen, limit, temp, top_k,
    top_p) -> (state, tok (1,))``, or ``(state, logits)`` with
    ``fused=False``; the scalars are host Python values.

    Family-generic like :func:`slot_decode_program`: ``mod.prefill_slot``
    writes a KV lane slice (lm) or, for zamba, the KV slice and the lane's
    recurrent snapshot at position ``plen``.  Recurrent leaves are zeroed
    on the way out for the inactive lanes other than ``slot``: the slot
    being prefilled keeps its fresh state even if its first token already
    ends it (a resumed lane's host forces its recorded token and keeps
    it), and the next step's freeze zeroes it then.  Lanes in ``replay``
    are kept as in the decode program: a mid-replay lane's device
    ``active`` bit can read False until the host's next push.
    """
    mod = registry.get_module(cfg)
    rec = RecurrentCache(cfg)

    def fn(params, state, prompt, slot, plen, limit, temp, top_k, top_p):
        _, logits = mod.prefill_slot(cfg, params, state["cache"], prompt, slot, plen)
        tok = _seed_slot(state, slot, logits, length=plen, limit=limit,
                         temp=temp, top_k=top_k, top_p=top_p, is_last=True,
                         eos_id=eos_id, fused=fused)
        if rec:
            keep_self = torch.arange(state["active"].shape[0],
                                     device=logits.device) == slot
            rec.freeze(state["cache"], state["active"] | state["replay"] | keep_self)
        return state, tok

    return _in_program(fn, mesh_program)


def paged_prefill_program(cfg: ArchConfig, *, eos_id: int | None = None,
                          first: bool = True, fused: bool = True, mesh_program=None):
    """Prefill ONE chunk of a request in lane ``slot`` of the paged cache:
    chunked prefill's unit of work, and the whole-prompt admission when
    the chunk is the full bucket.

    ``first=True``: the chunk starts at position 0 and runs the plain
    ``forward`` (bitwise the slotted prefill; flash on the kernel path);
    ``start`` is ignored.  ``first=False``: a continuation at ``start``
    through ``prefill_chunk_paged``.  One program per (chunk size,
    first) pair.

    ``fn(params, state, chunk (1, C), slot, start, plen, limit, temp,
    top_k, top_p) -> (state, tok (1,))`` (``(state, logits)`` with
    ``fused=False``); the scalars are host Python values.  The lane's
    scheduling entries advance every chunk (``lengths`` = positions
    prefilled); the lane activates, and the token means something, only
    on the chunk covering position ``plen - 1``.
    """
    mod = registry.get_module(cfg)

    def fn(params, state, chunk, slot, start, plen, limit, temp, top_k, top_p):
        table_row = state["tables"][slot]
        if first:
            start = 0
            _, logits = mod.prefill_slot_paged(
                cfg, params, state["cache"], chunk, table_row, plen)
        else:
            _, logits = mod.prefill_chunk_paged(
                cfg, params, state["cache"], chunk, table_row, start, plen)
        end = min(start + chunk.shape[1], plen)
        tok = _seed_slot(state, slot, logits, length=end, limit=limit,
                         temp=temp, top_k=top_k, top_p=top_p,
                         is_last=end >= plen, eos_id=eos_id, fused=fused)
        return state, tok

    return _in_program(fn, mesh_program)


def paged_copy_program(cfg: ArchConfig, *, mesh_program=None):
    """Copy one physical KV block of the paged pool, in place: the prefix
    cache's copy-on-write (:func:`repro_torch.models.lm.copy_paged_block`).
    ``fn(state, src, dst) -> state``; one program serves every copy."""
    mod = registry.get_module(cfg)

    def fn(state, src, dst):
        mod.copy_paged_block(cfg, state["cache"], src, dst)
        return state

    return _in_program(fn, mesh_program)


# ---------------------------------------------------------------------------
# Speculative decoding (draft and verify)
# ---------------------------------------------------------------------------


def spec_buffers(cfg: ArchConfig, dcfg: ArchConfig, cache: dict, draft: dict, *,
                 k: int, max_slots: int) -> dict:
    """The fixed buffers of :func:`spec_decode_program`, allocated once at
    engine build (``state["spec"]``), so a CUDA graph captured on them
    stays valid:

    rows     (max_slots, k + 1) int32  the round's output (the host fetch)
    keep     {leaf: like the target's recurrent leaf}  the state after each
             lane's last committed verify step (recurrent targets only)
    dstates  {leaf: (k, *draft leaf)}  the draft's recurrent leaves after
             each of its first ``k`` steps (recurrent drafts only; the
             live leaf is the state after step ``k``)

    For zamba2-1.2b at 8 lanes one copy of the recurrent leaves is 326.5
    MB (ssm 318.8, conv 7.7), so a zamba target and draft at ``k = 3``
    hold four copies, 1.31 GB (the reference keeps ``k + 2``)."""
    rec, drec = RecurrentCache(cfg), RecurrentCache(dcfg)
    dev = next(iter(cache.values())).device
    return {
        "rows": torch.zeros(max_slots, k + 1, dtype=torch.int32, device=dev),
        "keep": {n: torch.zeros_like(cache[n]) for n in rec.leaf_axes},
        "dstates": {n: torch.zeros((k,) + tuple(draft[n].shape), dtype=draft[n].dtype,
                                   device=dev) for n in drec.leaf_axes},
    }


def _entered(program):
    """The context of a serving mesh program (nothing without one)."""
    return contextlib.nullcontext() if program is None else program()


def spec_decode_program(cfg: ArchConfig, dcfg: ArchConfig, *, k: int,
                        eos_id: int | None = None, paged: bool = False,
                        impl: str = "ref", mesh_program=None, draft_program=None):
    """One speculative decode round over every lane: the draft model
    (``dcfg``, its cache ``state["draft"]``, always slotted) proposes
    ``k`` greedy tokens a lane, the target scores all ``k + 1`` positions,
    and each lane commits its accepted prefix: up to ``k + 1`` tokens a
    round instead of one.

    ``fn(params, dparams, state, *, stochastic=None, masked=None) ->
    (state, rows)``: ``rows`` is ``state["spec"]["rows"]`` (:func:`spec_buffers`),
    the round's one host fetch.  Entry ``(lane, i)`` is the ``i``-th
    committed token of the lane's round, :data:`UNCOMMITTED` past the
    accepted prefix, or :data:`NONFINITE_TOKEN` for a committed position
    whose logits were non-finite (the plain decode program's quarantine
    contract).

    Accept rule: target step ``i`` consumes ``u_i`` (``u_0`` the lane's
    pending token, then ``u_i = draft_i``) at position ``lengths + i`` and
    samples ``y_i``; the chain stays valid while ``y_{i-1} == draft_{i-1}``,
    so every committed ``y_i`` is computed from exactly the committed
    tokens: greedy, it is bitwise what the sequential engine samples,
    whatever the draft proposed.  ``valid`` drops at the first mismatch
    (that position's ``y`` still commits: the target's own sample), on
    done (budget or EOS), on non-finite logits, and after step 0 for a
    ``replay`` lane (the host forces its recorded tokens one a round).
    Stochastic lanes draw each position from ``state["generator"]``, as
    the reference draws ``fold_in(sub, i)``; only greedy is held bitwise.

    State, all in place:

    * KV (slotted or paged): write, then truncate.  Rejected positions
      leave junk past the commit point, rewritten before the lane attends
      them; on the paged layout the engine maps the whole horizon first,
      so the junk lands in the lane's own fresh blocks, never a shared one.
    * recurrent leaves: ``keep`` follows the state after each lane's last
      committed step (:meth:`RecurrentCache.rollback`) and replaces the
      live leaves at the end; the draft's leaves take its state after step
      ``c_len - 1`` (the committed tokens minus the new pending one).
    * both sides then freeze with ``act_new | replay``; ``lengths`` grows
      by the committed count, ``tokens`` takes each lane's last commit.

    On a mesh the draft and the target are two models with two layouts:
    the draft's steps run inside ``draft_program`` (its weights' gathers,
    its slotted lanes over the data axes) and the verify ladder inside
    ``mesh_program`` (the target's), each entered around its half of the
    round, so a graph captured of the round holds both halves'
    collectives.  Both return logits gathered over the data and model
    axes, so every rank proposes, verifies and commits the same rows.
    """
    if k < 1:
        raise ValueError(f"spec_k must be >= 1, got {k}")
    mod = registry.get_module(cfg)
    dmod = registry.get_module(dcfg)
    rec = RecurrentCache(cfg)
    drec = RecurrentCache(dcfg)

    def target_step(params, state, tok, pos):
        if paged:
            return mod.decode_step_paged(cfg, params, state["cache"], tok, pos,
                                         state["tables"], impl=impl)
        return mod.decode_step(cfg, params, state["cache"], tok, pos)

    def fn(params, dparams, state, *, stochastic=None, masked=None):
        active, replay, lengths = state["active"], state["replay"], state["lengths"]
        bufs = state["spec"]
        dcache = state["draft"]

        # the draft: k proposals and one step that consumes the last, so
        # its cache covers lengths .. lengths + k
        drafts = []
        z = state["tokens"]
        with _entered(draft_program):
            for i in range(k + 1):
                dlogits, _ = dmod.decode_step(dcfg, dparams, dcache, z, lengths + i)
                if i < k:
                    if drec:
                        drec.snapshot(dcache, {n: b[i] for n, b in bufs["dstates"].items()})
                    z = dlogits.float().argmax(dim=-1).to(torch.int32)
                    drafts.append(z)

        # the target's verify ladder
        cache = state["cache"]
        keep = bufs["keep"]
        if rec:
            rec.snapshot(cache, keep)
        rows = bufs["rows"]
        valid = active
        c_len = torch.zeros_like(lengths)
        last_tok = torch.zeros_like(lengths)
        any_done = torch.zeros_like(active)
        u = state["tokens"]
        for i in range(k + 1):
            with _entered(mesh_program):
                logits, _ = target_step(params, state, u, lengths + i)
            tok = sample_tokens(logits, state["generator"], state["temps"],
                                top_ks=state["top_ks"], top_ps=state["top_ps"],
                                stochastic=stochastic, masked=masked)
            finite = torch.isfinite(logits).all(dim=-1)
            y = torch.where(finite, tok, NONFINITE_TOKEN).to(torch.int32)
            done = finite & (lengths + (i + 1) >= state["limits"])
            if eos_id is not None:
                done |= finite & (y == eos_id)
            committed = valid & finite
            rows[:, i] = torch.where(valid, y, UNCOMMITTED)
            last_tok = torch.where(committed, y, last_tok)
            c_len = c_len + committed.to(torch.int32)
            any_done |= committed & done
            if rec:
                with _entered(mesh_program):              # the rank's lanes
                    rec.rollback(keep, cache, ~committed)     # keep <- cache where committed
            if i < k:
                valid = valid & finite & ~done & ~replay & (y == drafts[i])
                u = drafts[i]

        act_new = active & ~any_done
        if rec:
            with _entered(mesh_program):
                rec.snapshot(keep, cache)                    # the live leaves <- keep
                rec.freeze(cache, act_new | replay)
        if drec:
            # the draft's state after step c_len - 1 (step 0 for a lane
            # that committed nothing): select into dstates[0], then into
            # the live leaves, which hold the state after step k
            sel = {n: b[0] for n, b in bufs["dstates"].items()}
            with _entered(draft_program):
                for j in range(1, k):
                    drec.rollback(sel, {n: b[j] for n, b in bufs["dstates"].items()},
                                  c_len <= j)
                drec.rollback(dcache, sel, c_len > k)
                drec.freeze(dcache, act_new | replay)
        state["tokens"].copy_(torch.where(active, last_tok, 0))
        state["lengths"].add_(c_len)
        state["active"].copy_(act_new)
        return state, rows

    return fn


def spec_draft_prefill_program(dcfg: ArchConfig, *, draft_program=None):
    """Seed the draft's lane from a token history: prefill ``hist`` (the
    prompt and every committed token but the pending one, padded to a
    bucket) into draft lane ``slot``, in place.

    ``fn(dparams, state, hist (1, bucket), slot, plen) -> state``.  It runs
    when a lane starts decoding and on every restore (tier, prefix chain,
    a held lane's release): the draft is rebuilt from the committed
    history, never restored.  Its state is not bitwise a decode-built one,
    and need not be: committed tokens never depend on the draft's values,
    only how many commit a round does.

    No freeze: the device ``active`` vector can be stale mid-admission,
    so a freeze here could zero a lane another restore seeded earlier in
    the same engine step.  The spec decode program freezes the draft
    every round, which is when the invariant sweep checks it.

    On a mesh it runs inside ``draft_program``: every data rank runs the
    forward and the rank holding the lane writes it, as a slotted prefill
    does."""
    dmod = registry.get_module(dcfg)

    def fn(dparams, state, hist, slot, plen):
        dmod.prefill_slot(dcfg, dparams, state["draft"], hist, slot, plen)
        return state

    return _in_program(fn, draft_program)


# ---------------------------------------------------------------------------
# Host-tier spill and restore transport
# ---------------------------------------------------------------------------
#
# Four programs move lane state between the device cache and the host tier
# (serve/paged.py:HostTier), built once each through the engine's program
# cache.  On a serving mesh each rank reads and writes only the blocks or
# lanes it holds (a payload is its ``Share``), and a restore into a block
# or lane of another data rank moves the payload there from its holder.
# Reads land in host memory: pinned on a CUDA card, one stream-ordered copy
# per leaf and one synchronize before the payload is handed over, so the
# caller may reuse the source right after.  Writes copy in place into the
# existing cache tensors (``index_copy_``): no leaf is ever rebound, so the
# captured decode graph stays valid.  A non-blocking copy from pinned
# memory keeps its source alive through PyTorch's pinned allocator, which
# records the copy's stream before a freed block is reused.  A failed
# pinned allocation or copy raises.


def _fetch(tensors: dict) -> dict:
    """``{leaf: device tensor}`` -> ``{leaf: host tensor}``, contiguous.
    On a CUDA device each leaf lands in a pinned buffer by one
    non-blocking copy, then one synchronize; on the CPU each is cloned."""
    out, streams = {}, set()
    for name, t in tensors.items():
        if t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            streams.add(t.device)
        else:
            buf = t.clone(memory_format=torch.contiguous_format)
        out[name] = buf
    for dev in streams:
        torch.cuda.current_stream(dev).synchronize()
    return out


def _rows_of_one(ts: list):
    """The host tensor whose rows ``ts`` are, in order, when they are (a
    spill captured by one gather), else None."""
    base = ts[0]._base
    if base is None or base.dim() != ts[0].dim() + 1 or base.shape[0] != len(ts) \
            or not base.is_contiguous():
        return None
    step = base.stride(0) * base.element_size()
    p0 = base.data_ptr()
    if all(t._base is base and t.data_ptr() == p0 + j * step and t.is_contiguous()
           for j, t in enumerate(ts)):
        return base
    return None


def _stage(ts: list, device, dtype):
    """Stack host tensors ``ts`` into one (n, ...) device tensor: one copy
    when they are the rows of one buffer (a spill's payloads), else one
    copy per row.  The one copy restores 2-33 paged blocks 1.2-1.9x faster
    than a copy per block on an H100 (``chip_smoke.py`` 3f, 3g)."""
    ts = [torch.as_tensor(t) for t in ts]
    base = _rows_of_one(ts)
    if base is not None:
        return base.to(device=device, dtype=dtype, non_blocking=True)
    stage = torch.empty((len(ts),) + tuple(ts[0].shape), dtype=dtype, device=device)
    for j, t in enumerate(ts):
        stage[j].copy_(t, non_blocking=True)
    return stage


def _flat(leaves: list, device, dtype):
    """The tensors ``leaves`` flattened into one device buffer (a move's
    payload: every leaf of every block in one broadcast)."""
    return torch.cat([torch.as_tensor(t).reshape(-1).to(device=device, dtype=dtype)
                      for t in leaves])


def _move(buf, holder: int, group) -> None:
    """Broadcast ``buf`` from data rank ``holder`` over ``group``, in
    place: a tier payload restored on another data rank than the one that
    spilled it (counted in ``common.COUNTS["tier_move"]``)."""
    dist.broadcast(buf, src=dist.get_global_rank(group.pg, holder), group=group.pg)
    COUNTS["tier_move"] += 1


def paged_block_read_program(cfg: ArchConfig, *, mesh_program=None, nbytes: int = 0):
    """Read physical blocks out of every paged-cache leaf into host memory.

    ``fn(state, blocks) -> [{leaf: (L, bs, Hk, dh)} per block]``: the
    payloads of one :class:`~repro_torch.serve.paged.LaneSpill` (a lane's
    blocks in logical order) or of one spilled prefix block.  Leaves are
    (L, NB, bs, Hk, dh), the block axis ``ndim - 4``.  All the blocks are
    gathered by one indexed copy per leaf and fetched together (the
    reference fetches block by block); each payload is a row of the
    fetched buffer, so a spill keeps one payload per block.

    Under a serving mesh program (``mesh_program``) the pool holds this
    data rank's share of the blocks (and its kv heads): each payload is a
    :class:`~repro_torch.serve.paged.Share` of a block, this rank's part
    where it holds the block and empty where another data rank does, its
    ``nbytes`` the whole block's (``nbytes``).  Nothing crosses ranks."""

    def fn(state, blocks):
        cache = state["cache"]
        first = next(iter(cache.values()))
        split = serve_split()
        if split is None:
            own, lo = list(range(len(blocks))), 0
        else:
            n = first.shape[first.dim() - 4]
            lo = split.mesh.data.rank * n
            own = [j for j, b in enumerate(blocks) if lo <= b < lo + n]
        idx = torch.tensor([blocks[j] - lo for j in own], dtype=torch.long,
                           device=first.device)
        host = _fetch({name: c.index_select(c.dim() - 4, idx).movedim(c.dim() - 4, 0)
                       for name, c in cache.items()}) if own else {}
        rows = {j: {name: h[i] for name, h in host.items()} for i, j in enumerate(own)}
        if split is None:
            return [rows[j] for j in range(len(blocks))]
        return [Share(rows.get(j, {}), b, nbytes) for j, b in enumerate(blocks)]

    return _in_program(fn, mesh_program)


def paged_block_write_program(cfg: ArchConfig, *, mesh_program=None):
    """Write physical blocks of every paged-cache leaf from host payloads:
    the restore half of :func:`paged_block_read_program`.

    ``fn(state, payloads, blocks) -> state``: ``payloads[j]`` (a
    ``{leaf: block}`` dict) goes to block ``blocks[j]``, by one indexed
    copy per leaf into the existing pool.

    Under a serving mesh program each payload is a ``Share`` whose holder
    is the data rank of its ``src`` block.  Where that rank holds the new
    block too it writes its part in place; otherwise the holder broadcasts
    the blocks it holds for other ranks (every leaf in one buffer, one
    broadcast a holder, as ``lm.copy_paged_block`` moves a block) over the
    data group and each new owner writes its own.  Every rank calls this
    with the same blocks in the same order, as every rank runs the
    schedule."""

    def write(cache, rows: list, local: list):
        if not rows:
            return
        idx = torch.tensor(local, dtype=torch.long, device=next(iter(cache.values())).device)
        for name, c in cache.items():
            axis = c.dim() - 4
            src = _stage([r[name] for r in rows], c.device, c.dtype)
            c.index_copy_(axis, idx, src.movedim(0, axis))

    def fn(state, payloads, blocks):
        cache = state["cache"]
        split = serve_split()
        if split is None:
            write(cache, list(payloads), list(blocks))
            return state
        g = split.mesh.data
        first = next(iter(cache.values()))
        n = first.shape[first.dim() - 4]
        holder = [p.src // n for p in payloads]
        owner = [b // n for b in blocks]
        stay = [j for j in range(len(blocks)) if holder[j] == owner[j] == g.rank]
        write(cache, [payloads[j] for j in stay], [blocks[j] - g.rank * n for j in stay])
        block_shape = first.select(first.dim() - 4, 0).shape
        for h in sorted({holder[j] for j in range(len(blocks)) if holder[j] != owner[j]}):
            moved = [j for j in range(len(blocks)) if holder[j] == h != owner[j]]
            if g.rank == h:
                buf = _flat([payloads[j][name] for name in cache for j in moved],
                            first.device, first.dtype)
            else:
                buf = torch.empty(len(cache) * len(moved) * block_shape.numel(),
                                  dtype=first.dtype, device=first.device)
            _move(buf, h, g)
            parts = buf.view(len(cache), len(moved), *block_shape)
            mine = [i for i, j in enumerate(moved) if owner[j] == g.rank]
            if mine:
                idx = torch.tensor([blocks[moved[i]] - g.rank * n for i in mine],
                                   dtype=torch.long, device=first.device)
                sel = torch.tensor(mine, dtype=torch.long, device=first.device)
                for part, c in zip(parts, cache.values()):
                    axis = c.dim() - 4
                    c.index_copy_(axis, idx, part.index_select(0, sel).movedim(0, axis))
        return state

    return _in_program(fn, mesh_program)


def _lane_owner(cache: dict, axes: dict):
    """``(the DecodeSharding, lanes a rank holds)`` where the lanes split
    over the data axes under the running serving mesh program, else None
    (every lane here, or under the batch fallback every lane with this
    rank's positions)."""
    split = serve_split()
    dec = None if split is None else split.decode
    if dec is None or dec.lane_ranks == 1:
        return None
    name, axis = next(iter(axes.items()))
    return dec, cache[name].shape[axis]


def lane_read_program(cfg: ArchConfig, *, axes: dict, mesh_program=None, nbytes: int = 0):
    """Read one lane's slice of every slot-cache leaf in ``axes``
    (``registry.lane_leaf_axes``: KV segments and/or recurrent leaves)
    into host memory.  ``fn(state, slot) -> {leaf: lane slice}``, the
    payload of a ``kind == "lane"`` spill.

    Under a serving mesh program the payload is a
    :class:`~repro_torch.serve.paged.Share` of the lane (``nbytes`` its
    whole bytes): this rank's positions of it where this data rank holds
    the lane (or, under the batch fallback, holds every lane), empty
    where another does."""

    def fn(state, slot):
        cache = state["cache"]
        split = serve_split()
        owner = _lane_owner(cache, axes)
        local = slot
        if owner is not None:
            dec, per = owner
            local = dec.local_slot(slot, per)
        leaves = {} if local is None else _fetch(
            {name: cache[name].select(axis, local) for name, axis in axes.items()})
        return leaves if split is None else Share(leaves, slot, nbytes)

    return _in_program(fn, mesh_program)


def lane_write_program(cfg: ArchConfig, *, axes: dict, mesh_program=None):
    """Write one lane's slice of every slot-cache leaf in ``axes`` from a
    host payload: the restore half of :func:`lane_read_program`.

    ``fn(state, payload, slot) -> state``.  A recurrent lane must be
    active on the device before any later program runs: the prefill and
    decode programs' freeze zeroes inactive lanes, so the engine pushes
    its scheduling mirror right after such a restore.

    Under a serving mesh program whose data axes split the lanes, a lane
    re-admitted into a slot of another data rank than the one that
    spilled it moves: its holder (the data rank of the payload's ``src``
    lane) broadcasts its part over the data group and the new owner writes
    it."""

    def put(cache, payload, local):
        for name, axis in axes.items():
            c = cache[name]
            src = torch.as_tensor(payload[name]).to(device=c.device, dtype=c.dtype,
                                                     non_blocking=True)
            idx = torch.tensor([local], dtype=torch.long, device=c.device)
            c.index_copy_(axis, idx, src.unsqueeze(axis))

    def fn(state, payload, slot):
        cache = state["cache"]
        owner = _lane_owner(cache, axes)
        if owner is None:
            put(cache, payload, slot)
            return state
        dec, per = owner
        g, local = dec.mesh.data, dec.local_slot(slot, per)
        h = dec.holder(payload.src, per)
        if h != dec.holder(slot, per):
            # the leaves as bytes, one buffer: a hybrid lane's fp32 ssm
            # travels beside its compute-dtype k, v and conv
            like = [cache[name].select(axis, 0) for name, axis in axes.items()]
            dev = like[0].device
            sizes = [t.numel() * t.element_size() for t in like]
            if g.rank == h:
                buf = torch.cat([torch.as_tensor(payload[name]).contiguous().view(-1)
                                 .view(torch.uint8) for name in axes]).to(dev)
            else:
                buf = torch.empty(sum(sizes), dtype=torch.uint8, device=dev)
            _move(buf, h, g)
            payload = dict(zip(axes, (b.view(t.dtype).view(t.shape) for b, t in zip(
                buf.split(sizes), like))))
        if local is not None:
            put(cache, payload, local)
        return state

    return _in_program(fn, mesh_program)
