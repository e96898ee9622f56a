"""Serving programs: prefill and decode steps of the continuous-batching
engine, with sampling fused on the device.

The port of the reference's ``serve/step.py`` for whole-prompt prefill
and plain decode.  A "program" is a closure ``fn(params, state, ...) ->
(state, tok)`` that runs eagerly: it updates every tensor of the state
dict in place (no leaf is rebound, so a CUDA graph captured of the decode
program replays on the same buffers, ``core.aot``), and returns the
sampled tokens on the device — the host fetches one ``(max_slots,)``
int32 vector per decode step, never logits.

Where the reference branches on device values inside the program
(``lax.cond`` on "any lane samples" / "any lane masks"), an eager branch
would cost a host sync; the engine passes those two facts from its host
mirror (``stochastic``, ``masked``) instead, and they are derived from the
tensors only when left ``None``.  The engine always passes both, and keys
its captured decode graphs on them: a graph holds no host sync.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import registry
from repro_torch.models.attention import NEG_INF
from .cache import RecurrentCache
from .faults import NONFINITE_TOKEN


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


def _decode_program(decode_fn, *, eos_id: int | None, freeze=None):
    """Wrap a layout-specific ``decode_fn(params, state) -> (logits,
    cache)`` with the shared bookkeeping: fused sampling, non-finite
    detection (the :data:`NONFINITE_TOKEN` sentinel rides the token
    fetch), length advance and EOS/budget eviction, all on the device.
    ``fn(params, state, *, stochastic=None, masked=None) -> (state, tok)``.

    ``freeze(cache, active)`` (recurrent state kinds) zeroes the recurrent
    leaves of the lanes inactive after the step — evict-time zeroing in
    the same step (see :class:`~repro_torch.serve.cache.RecurrentCache`).
    """

    def fn(params, state, *, stochastic=None, masked=None):
        logits, cache = decode_fn(params, state)
        active = state["active"]
        new_len = state["lengths"] + active.to(torch.int32)
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
            freeze(cache, act_new)
        state["tokens"].copy_(tok)
        state["lengths"].copy_(new_len)
        state["active"].copy_(act_new)
        return state, tok

    return fn


def slot_decode_program(cfg: ArchConfig, *, eos_id: int | None = None):
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
                           freeze=rec.freeze if rec else None)


def paged_decode_program(cfg: ArchConfig, *, eos_id: int | None = None,
                         impl: str = "ref"):
    """One decode step over every lane of the paged cache: the same
    bookkeeping as :func:`slot_decode_program`, the cache walk through
    ``state["tables"]`` (``impl`` "ref" or "kernel")."""
    mod = registry.get_module(cfg)

    def decode_fn(params, state):
        return mod.decode_step_paged(
            cfg, params, state["cache"], state["tokens"], state["lengths"],
            state["tables"], impl=impl)

    return _decode_program(decode_fn, eos_id=eos_id)


def _seed_slot(state, slot, logits, *, length, limit, temp, top_k, top_p,
               is_last, eos_id):
    """Shared tail of the prefill programs: write the lane's scheduling
    entries, sample its first token, and activate it unless it is already
    done.  Returns tok (1,) int32 (the sentinel on non-finite logits)."""
    dev = logits.device
    state["lengths"][slot] = length
    state["limits"][slot] = limit
    state["temps"][slot] = temp
    state["top_ks"][slot] = top_k
    state["top_ps"][slot] = top_p
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


def slot_prefill_program(cfg: ArchConfig, *, eos_id: int | None = None):
    """Admit one prompt into lane ``slot``: prefill its KV into the lane
    (prompt padded to a length bucket), sample the first token, and seed
    the slot's scheduling state.

    ``fn(params, state, prompt (1, bucket), slot, plen, limit, temp, top_k,
    top_p) -> (state, tok (1,))``; the scalars are host Python values.

    Family-generic like :func:`slot_decode_program`: ``mod.prefill_slot``
    writes a KV lane slice (lm) or, for zamba, the KV slice and the lane's
    recurrent snapshot at position ``plen``.  Recurrent leaves are zeroed
    on the way out for the inactive lanes other than ``slot``: the slot
    being prefilled keeps its fresh state even if its first token already
    ends it, and the next step's freeze zeroes it then.
    """
    mod = registry.get_module(cfg)
    rec = RecurrentCache(cfg)

    def fn(params, state, prompt, slot, plen, limit, temp, top_k, top_p):
        _, logits = mod.prefill_slot(cfg, params, state["cache"], prompt, slot, plen)
        tok = _seed_slot(state, slot, logits, length=plen, limit=limit,
                         temp=temp, top_k=top_k, top_p=top_p, is_last=True,
                         eos_id=eos_id)
        if rec:
            keep_self = torch.arange(state["active"].shape[0],
                                     device=logits.device) == slot
            rec.freeze(state["cache"], state["active"] | keep_self)
        return state, tok

    return fn


def paged_prefill_program(cfg: ArchConfig, *, eos_id: int | None = None,
                          first: bool = True):
    """Prefill one chunk of a request in lane ``slot`` of the paged cache.
    Only ``first=True`` (the chunk starts at position 0 — here always the
    whole bucketed prompt) is ported; continuation chunks arrive with
    chunked prefill.

    ``fn(params, state, chunk (1, C), slot, start, plen, limit, temp,
    top_k, top_p) -> (state, tok (1,))``; ``start`` is ignored (0).
    """
    if not first:
        raise NotImplementedError(
            "chunked-prefill continuations arrive with a later slice")
    mod = registry.get_module(cfg)

    def fn(params, state, chunk, slot, start, plen, limit, temp, top_k, top_p):
        table_row = state["tables"][slot]
        _, logits = mod.prefill_slot_paged(
            cfg, params, state["cache"], chunk, table_row, plen)
        end = min(chunk.shape[1], plen)
        tok = _seed_slot(state, slot, logits, length=end, limit=limit,
                         temp=temp, top_k=top_k, top_p=top_p,
                         is_last=end >= plen, eos_id=eos_id)
        return state, tok

    return fn
