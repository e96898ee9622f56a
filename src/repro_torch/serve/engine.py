"""Continuous-batching serve engine over a slotted or paged KV cache.

The port of the reference's ``serve/engine.py`` for the main serving
path of the dense LM and of the hybrid family (zamba).  The engine runs one decode step over ``max_slots`` cache
lanes at a time.  Requests are admitted into free lanes at any step
(whole-prompt prefill, padded to a power-of-two bucket), finished
sequences are evicted at once (EOS or token budget), and sampling is fused
into the decode program — the per-step host sync is one ``(max_slots,)``
int32 token fetch.

Two cache layouts (``EngineConfig.kv_layout``):

``slotted``  fixed ``max_slots x max_len`` lanes.
``paged``    a shared pool of fixed-size KV blocks with per-lane block
             tables (serve/paged.py): prompt blocks at admission, one more
             each time decode crosses a block boundary, all freed on
             eviction.  Admission is gated on worst-case block commitments
             (``deficit``), so decode growth never finds the pool empty.
             Greedy decoding is token-for-token identical to the slotted
             layout.  Only for state kind ``"kv"``: a hybrid lane's
             recurrent state has no sequence axis to page.

A lane of a hybrid family (``registry.state_kind == "hybrid"``) holds a
slotted KV segment and per-lane recurrent leaves; :class:`RecurrentCache`
(``self.rec``) resets them at admission and the step programs zero them
at eviction, which :meth:`ServeEngine.check_invariants` sweeps.

The host keeps a mirror of the scheduling state (lengths, budgets, block
tables, which request owns which lane), advanced by the same rules the
device applies, so it never reads device state back except the sampled
tokens.

Programs come from an :class:`~repro_torch.core.aot.AotCache` (the
reference's ``aot=``, shareable between engines), whose ``builds``,
``cache_hits`` and entry count (``executables``) feed :attr:`stats`:

* the decode program, keyed on (layout, ``stochastic``, ``masked``);
* one eager prefill program per prompt bucket, counted so the
  reference's build contract holds: one decode plus one per bucket, flat
  in steady state.

On a CUDA device each decode step runs as a CUDA graph of the decode
program captured on this engine's state buffers
(:func:`~repro_torch.core.aot.device_program`: one eager step, then the
capture; every later step is one replay and the token fetch).  The
graphs are bound to those buffers, so they live in the engine's own
``AotCache`` (:attr:`graphs`, counted in :attr:`stats` as ``graphs``)
and go with the engine, never in a shared one.  On the CPU the decode
program runs eagerly.  Nothing falls back to eager on the card: a
capture that fails raises.
Between steps the host pushes its block-table and ``active`` mirrors by
copying into the captured buffers.

Not ported yet — each raises ``NotImplementedError`` when set to a
non-default value: chunked prefill, the prefix cache, preempt admission,
the host tier and hold/park, speculative decoding, retries, host-side
sampling (``fused_sampling=False``), deadlines.

    engine = ServeEngine(cfg, params, EngineConfig(max_slots=8, max_len=256,
                                                   kv_layout="paged"))
    rid = engine.submit(prompt_ids, max_new_tokens=32)
    engine.drain()
    out = engine.completions[rid].tokens
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.aot import AotCache, device_program
from repro_torch.device import resolve_device
from repro_torch.models import registry
from .cache import RecurrentCache, bucket_for, make_slot_state, prompt_buckets
from .faults import NONFINITE_TOKEN
from .paged import BlockAllocator, SlotTables, blocks_for, cache_nbytes, make_paged_state
from .step import (
    paged_decode_program,
    paged_prefill_program,
    slot_decode_program,
    slot_prefill_program,
)

PAGED_ATTN_IMPLS = ("ref", "kernel")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration (the reference's field names)."""

    max_slots: int = 8            # cache lanes decoded per step
    max_len: int = 256            # max per-lane sequence length
    eos_id: int | None = None     # None: budget-only eviction
    top_k: int = 0                # default per-request top-k (0 = off)
    top_p: float = 0.0            # default per-request nucleus p (off)
    seed: int = 0
    # prompt-length buckets; None -> powers of two up to max_len
    prefill_buckets: tuple[int, ...] | None = None
    fused_sampling: bool = True
    # --- KV layout -----------------------------------------------------
    kv_layout: str = "slotted"    # "slotted" | "paged"
    page_size: int = 16           # KV block size (paged)
    # pool size in blocks incl. the null block; None -> worst case
    # (max_slots * max_len/page_size + 1)
    num_blocks: int | None = None
    prefill_chunk: int = 0
    paged_attn: str = "ref"       # paged decode backend: "ref" | "kernel"
    prefix_cache: bool = False
    admission: str = "deficit"
    max_retries: int = 2
    host_tier: bool = False
    host_tier_blocks: int | None = None
    park_idle_s: float | None = None
    spec_draft: Any = None
    spec_k: int = 0


# fields this slice does not port: each must keep its default
_NOT_PORTED = {
    "fused_sampling": "host-side sampling",
    "prefill_chunk": "chunked prefill",
    "prefix_cache": "the prefix cache",
    "admission": "preempt admission",
    "max_retries": "fault retries",
    "host_tier": "the host-RAM tier",
    "host_tier_blocks": "the host-RAM tier",
    "park_idle_s": "hold/park",
    "spec_draft": "speculative decoding",
    "spec_k": "speculative decoding",
}


@dataclasses.dataclass
class _Slot:
    rid: int
    plen: int
    limit: int                    # cache length at which the last token samples
    temperature: float
    top_k: int
    top_p: float
    prompt: np.ndarray
    prefilled: int = 0            # prompt positions prefilled so far
    generated: int = 0

# Terminal per-request statuses (Completion.status), the reference's set.
STATUSES = ("ok", "timeout", "cancelled", "failed", "shed")


@dataclasses.dataclass
class Completion:
    rid: int
    prompt_len: int
    max_new_tokens: int
    tokens: list[int]
    token_times: list[float]      # clock() when each token reached the host
    submit_time: float
    finish_time: float
    status: str = "ok"
    error: str | None = None


@dataclasses.dataclass
class _Pending:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float
    top_k: int
    top_p: float
    submit_time: float


class ServeEngine:
    """Continuous-batching serve engine (see the module docstring).

    Invariants (swept by :meth:`check_invariants`): slot conservation
    (``admitted - evicted`` = occupied lanes, each owned by one request),
    paged block conservation (``free + live + cached == capacity``, every
    lane's written KV inside its mapped blocks, deficit admission never
    over-commits), status counters matching completions, and, for
    recurrent state kinds, all-zero recurrent leaves in every free lane
    after a decode step.
    """

    def __init__(self, cfg: ArchConfig, params, engine: EngineConfig = EngineConfig(),  # noqa: B008 - frozen
                 *, device=None, clock: Callable[[], float] = time.perf_counter,
                 aot: AotCache | None = None):
        if not registry.supports_slot_serving(cfg):
            raise ValueError(f"family {cfg.family!r} does not support slot serving")
        if engine.kv_layout not in ("slotted", "paged"):
            raise ValueError(f"unknown kv_layout {engine.kv_layout!r}")
        if engine.paged_attn not in PAGED_ATTN_IMPLS:
            raise ValueError(f"paged_attn {engine.paged_attn!r} not in "
                             f"{PAGED_ATTN_IMPLS}")
        defaults = EngineConfig()
        for field, what in _NOT_PORTED.items():
            if getattr(engine, field) != getattr(defaults, field):
                raise NotImplementedError(
                    f"EngineConfig.{field}={getattr(engine, field)!r}: {what} "
                    "is not ported yet")
        self.kind = registry.state_kind(cfg)
        self.rec = RecurrentCache(cfg)
        self.paged = engine.kv_layout == "paged"
        if self.paged and not registry.supports_paged_serving(cfg):
            if self.kind != "kv":
                raise ValueError(
                    f"family {cfg.family!r} has state kind {self.kind!r}: "
                    "per-lane recurrent state is O(1) in sequence length — "
                    "there is no seq axis to page; use kv_layout='slotted'")
            raise ValueError(f"family {cfg.family!r} does not support paged serving")
        self.cfg, self.econ, self.clock = cfg, engine, clock
        self.device = resolve_device(device)
        self.buckets = tuple(engine.prefill_buckets or prompt_buckets(engine.max_len))
        if max(self.buckets) > engine.max_len:
            raise ValueError("prefill bucket exceeds max_len")
        mod = registry.get_module(cfg)
        self.params = mod.cast_for_compute(cfg, params, self.device)
        if self.paged:
            bs = engine.page_size
            if engine.max_len % bs:
                raise ValueError(f"max_len ({engine.max_len}) must be a "
                                 f"multiple of page_size ({bs})")
            blocks_per_slot = engine.max_len // bs
            self._num_blocks = engine.num_blocks or engine.max_slots * blocks_per_slot + 1
            self.alloc = BlockAllocator(self._num_blocks, bs)
            self.tables = SlotTables(engine.max_slots, blocks_per_slot)
            self._deficit = 0           # committed-but-unallocated blocks
            self._slot_wc = [0] * engine.max_slots
            self._tables_dirty = False
            self.state = make_paged_state(cfg, engine.max_slots, engine.max_len,
                                          self._num_blocks, bs, self.device,
                                          engine.seed)
            self._decode_fn = paged_decode_program(cfg, eos_id=engine.eos_id,
                                                   impl=engine.paged_attn)
            self._prefill = paged_prefill_program(cfg, eos_id=engine.eos_id)
        else:
            self._num_blocks = 0
            self.state = make_slot_state(cfg, engine.max_slots, engine.max_len,
                                         self.device, engine.seed)
            self._decode_fn = slot_decode_program(cfg, eos_id=engine.eos_id)
            self._prefill = slot_prefill_program(cfg, eos_id=engine.eos_id)
        self.kv_reserved_bytes = cache_nbytes(self.state["cache"])
        # NOT ``aot or ...``: AotCache defines __len__, so a fresh (empty)
        # shared cache is falsy
        self.aot = aot if aot is not None else AotCache("serve")
        # this engine's decode graphs, on its own buffers (CUDA only)
        self.graphs = AotCache("decode_graphs")
        # every static option that changes a program (the reference's
        # _sampler_key); the cfg carries attn_impl and the dtypes
        e = engine
        self._program_key = (cfg, e.max_slots, e.max_len, e.eos_id, e.kv_layout,
                             e.page_size, self._num_blocks, e.paged_attn)

        self.queue: deque[_Pending] = deque()
        self.slots: list[_Slot | None] = [None] * engine.max_slots
        self.live: dict[int, Completion] = {}
        self.completions: dict[int, Completion] = {}
        self.counters = dict.fromkeys((
            "prefills", "prefill_chunks", "decode_steps", "admitted",
            "evicted", "dead_slot_steps", "kv_peak_used_bytes",
            "prefill_tokens", *(f"status_{s}" for s in STATUSES),
            "faults_detected"), 0)
        self._next_rid = 0
        self._active_mirror = np.zeros(engine.max_slots, bool)
        self._active_dirty = False
        self._last_op: str | None = None     # "prefill" | "decode"

    # ------------------------------------------------------------------
    # Request lifecycle
    # ------------------------------------------------------------------
    def validate(self, prompt, max_new_tokens: int) -> np.ndarray:
        """Admissibility checks against this engine's config; returns the
        normalized prompt."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        bucket_for(prompt.size, self.buckets)  # raises if it can't fit
        if prompt.size + max_new_tokens - 1 > self.econ.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_len {self.econ.max_len}")
        if self.paged:
            wc = blocks_for(prompt.size + max_new_tokens - 1, self.econ.page_size)
            if wc > self.alloc.capacity:
                raise ValueError(f"request needs up to {wc} KV blocks but the "
                                 f"pool only has {self.alloc.capacity}")
        return prompt

    def submit(self, prompt, *, max_new_tokens: int = 16,
               temperature: float = 0.0, top_k: int | None = None,
               top_p: float | None = None, rid: int | None = None,
               deadline_s: float | None = None) -> int:
        """Queue a request; returns its request id.  ``top_k``/``top_p``
        default to the engine-wide ``EngineConfig`` values."""
        if deadline_s is not None:
            raise NotImplementedError("request deadlines are not ported yet")
        prompt = self.validate(prompt, max_new_tokens)
        eff_k = int(self.econ.top_k if top_k is None else top_k)
        eff_p = float(self.econ.top_p if top_p is None else top_p)
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        self.queue.append(_Pending(rid, prompt, max_new_tokens,
                                   float(temperature), eff_k, eff_p,
                                   self.clock()))
        return rid

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    # -- paged block bookkeeping ---------------------------------------
    def _can_admit(self, req: _Pending) -> bool:
        """Deficit admission: admit only while the pool can still cover
        every live lane's worst case plus this one, so decode growth never
        finds the pool empty."""
        if not self.paged:
            return True
        wc = blocks_for(req.prompt.size + req.max_new_tokens - 1,
                        self.econ.page_size)
        return self.alloc.available - self._deficit >= wc

    def _alloc_block(self, slot: int) -> int:
        """One block for ``slot`` (deficit admission guarantees one)."""
        return self.alloc.alloc()

    def _map_blocks(self, slot: int, need: int) -> None:
        """Grow ``slot``'s table to ``need`` blocks."""
        while self.tables.mapped(slot) < need:
            self.tables.append(slot, self._alloc_block(slot))
            self._deficit -= 1
            self._tables_dirty = True

    def _push_tables(self) -> None:
        """Re-push the host block-table mirror before the next program —
        in particular after an eviction, so stale lanes' sink-routed
        writes can't land in re-allocated blocks."""
        if self._tables_dirty:
            self.state["tables"].copy_(torch.from_numpy(self.tables.table))
            self._tables_dirty = False

    def _push_active(self) -> None:
        """A host-side eviction (a non-finite lane) clears the lane's
        ``active`` bit on the host; push the mirror before the next decode."""
        if self._active_dirty:
            self.state["active"].copy_(torch.from_numpy(self._active_mirror))
            self._active_dirty = False

    def _admit(self, req: _Pending, slot: int) -> None:
        plen = int(req.prompt.size)
        limit = plen + req.max_new_tokens - 1
        self.live[req.rid] = Completion(
            rid=req.rid, prompt_len=plen, max_new_tokens=req.max_new_tokens,
            tokens=[], token_times=[], submit_time=req.submit_time,
            finish_time=0.0)
        self.counters["admitted"] += 1
        self.slots[slot] = _Slot(req.rid, plen, limit, req.temperature,
                                 req.top_k, req.top_p, req.prompt)
        if self.paged:
            wc = blocks_for(limit, self.econ.page_size)
            self._slot_wc[slot] = wc
            self._deficit += wc
        self._prefill_slot(slot)

    def _prefill_slot(self, slot: int) -> None:
        """Prefill the lane's whole prompt (padded to its bucket), sample
        the first token and activate the lane — one host fetch."""
        s = self.slots[slot]
        C = bucket_for(s.plen, self.buckets)
        padded = np.zeros((1, C), np.int32)
        padded[0, : s.plen] = s.prompt
        chunk = torch.tensor(padded, device=self.device)
        prefill = self._prefill_entry(C)
        if self.paged:
            self._map_blocks(slot, blocks_for(s.plen, self.econ.page_size))
            self._push_tables()
            _, out = prefill(self.params, self.state, chunk, slot, 0, s.plen, s.limit,
                             s.temperature, s.top_k, s.top_p)
        else:
            _, out = prefill(self.params, self.state, chunk, slot, s.plen, s.limit,
                             s.temperature, s.top_k, s.top_p)
        tok = int(out[0])                       # the prefill's host sync
        self._last_op = "prefill"
        s.prefilled = s.plen
        self.counters["prefill_chunks"] += 1
        self.counters["prefill_tokens"] += s.plen
        self.counters["prefills"] += 1
        now = self.clock()
        if tok == NONFINITE_TOKEN:
            self._fail_nonfinite(slot, "non-finite logits at prefill")
            return
        comp = self.live[s.rid]
        s.generated = 1
        comp.tokens.append(tok)
        comp.token_times.append(now)
        done = (s.plen >= s.limit) or (
            self.econ.eos_id is not None and tok == self.econ.eos_id)
        self._active_mirror[slot] = not done
        if done:
            self._finish(slot, now)

    def _finish(self, slot: int, now: float) -> None:
        # natural EOS/budget eviction: the device already deactivated the
        # lane itself, so no active-mirror push is owed
        self._terminate(slot, "ok", now=now, push_active=False)

    def _fail_nonfinite(self, slot: int, reason: str) -> None:
        """A lane whose logits went non-finite terminates ``failed`` (the
        reference's quarantine-and-retry arrives with the robustness
        slice)."""
        self.counters["faults_detected"] += 1
        self._terminate(slot, "failed", error=reason)

    def _terminate(self, slot: int, status: str, *, error: str | None = None,
                   now: float | None = None, push_active: bool = True) -> None:
        """Evict lane ``slot`` with a terminal ``status``: block refs drop
        and the deficit commitment refunds."""
        s = self.slots[slot]
        comp = self.live.pop(s.rid)
        comp.finish_time = self.clock() if now is None else now
        comp.status = status
        comp.error = error
        self.completions[s.rid] = comp
        self.slots[slot] = None
        self._active_mirror[slot] = False
        if push_active:
            self._active_dirty = True
        if self.paged:
            self._deficit -= self._slot_wc[slot] - self.tables.mapped(slot)
            self._slot_wc[slot] = 0
            for b in self.tables.release(slot):
                self.alloc.free(b)
            self._tables_dirty = True
        self.counters["evicted"] += 1
        self.counters[f"status_{status}"] += 1

    def _note_kv_usage(self, decoding: frozenset = frozenset()) -> None:
        """Cache-usage high-water mark: paged reads the allocator's peak;
        slotted KV counts written positions right after the decode write;
        a hybrid lane costs a fixed share (its recurrent state is O(1) in
        sequence length; the KV segment is folded into that share)."""
        if self.paged:
            used = self.kv_reserved_bytes * self.alloc.peak_in_use // self._num_blocks
        elif self.kind != "kv":
            used = self.kv_reserved_bytes * sum(s is not None for s in self.slots) // (
                self.econ.max_slots)
        else:
            ntok = sum(s.prefilled + max(0, s.generated - 1) + (i in decoding)
                       for i, s in enumerate(self.slots) if s is not None)
            used = self.kv_reserved_bytes * ntok // (
                self.econ.max_slots * self.econ.max_len)
        self.counters["kv_peak_used_bytes"] = max(
            self.counters["kv_peak_used_bytes"], used)

    def _advance_lane(self, i: int, tok: int, now: float) -> str:
        """Commit ONE fetched token for lane ``i``.  Returns ``"fault"``
        (non-finite sentinel: lane failed), ``"done"`` (emitted and
        finished) or ``"ok"``."""
        s = self.slots[i]
        if tok == NONFINITE_TOKEN:
            self._fail_nonfinite(i, "non-finite logits at decode")
            return "fault"
        s.generated += 1
        comp = self.live[s.rid]
        comp.tokens.append(tok)
        comp.token_times.append(now)
        done = (s.plen + s.generated - 1 >= s.limit) or (
            self.econ.eos_id is not None and tok == self.econ.eos_id)
        if done:
            self._finish(i, now)
            return "done"
        return "ok"

    # ------------------------------------------------------------------
    # The serving loop
    # ------------------------------------------------------------------
    def step(self) -> bool:
        """Admit every queued request a free slot (and, paged, the block
        budget) can take, then advance all active lanes by one token.
        Returns False when idle."""
        progressed = False
        for slot in self.free_slots():
            if not self.queue or not self._can_admit(self.queue[0]):
                break
            self._admit(self.queue.popleft(), slot)
            progressed = True

        active_slots = [i for i, s in enumerate(self.slots) if s is not None]
        if not active_slots:
            self._note_kv_usage()
            return progressed
        if self.paged:
            # map the block each lane's next token lands in BEFORE the step
            # — the device never allocates
            for i in active_slots:
                s = self.slots[i]
                next_pos = min(s.plen + s.generated - 1, s.limit - 1)
                self._map_blocks(i, next_pos // self.econ.page_size + 1)
            self._push_tables()
        self._push_active()
        lanes = [self.slots[i] for i in active_slots]
        sampled = [s for s in lanes if s.temperature > 0]
        decode = self._decode_entry(
            stochastic=bool(sampled),
            masked=any(s.top_k > 0 or 0 < s.top_p < 1 for s in sampled))
        toks = decode(self.params, self.state).cpu().numpy()   # the one host sync
        self._last_op = "decode"
        self._note_kv_usage(frozenset(active_slots))
        self.counters["decode_steps"] += 1
        self.counters["dead_slot_steps"] += self.econ.max_slots - len(active_slots)
        now = self.clock()
        for i in active_slots:
            self._advance_lane(i, int(toks[i]), now)
        self._note_kv_usage()
        return True

    # ------------------------------------------------------------------
    # Programs (through the shared AotCache)
    # ------------------------------------------------------------------
    def decode_program(self, *, stochastic: bool, masked: bool) -> Callable:
        """The eager decode program: ``fn(params, state) -> tok``, one step
        in place (what the captured graph replays)."""
        decode_fn = self._decode_fn

        def fn(params, state):
            return decode_fn(params, state, stochastic=stochastic, masked=masked)[1]
        return fn

    def _decode_entry(self, *, stochastic: bool, masked: bool) -> Callable:
        """The decode program for these sampling flags: ``entry(params,
        state) -> tok``.  On the card, a graph of it captured on this
        engine's buffers (its first call is the step that warmed it)."""
        key = ("slot_decode", stochastic, masked) + self._program_key
        fn = self.aot.get(key, lambda: self.decode_program(stochastic=stochastic,
                                                           masked=masked))
        if self.device.type != "cuda":
            return fn
        gens = (self.state["generator"],) if stochastic else ()
        return self.graphs.get(key, lambda: device_program(fn, (self.params, self.state),
                                                           generators=gens))

    def _prefill_entry(self, bucket: int) -> Callable:
        """The prefill program of a prompt bucket (eager; counted)."""
        return self.aot.get(("slot_prefill", bucket) + self._program_key,
                            lambda: self._prefill)

    def drain(self) -> None:
        while self.step():
            pass

    def run(self, prompts: Sequence[Any], *, max_new_tokens: int = 16,
            temperature: float = 0.0, top_k: int | None = None,
            top_p: float | None = None) -> list[np.ndarray]:
        """Batch convenience: submit all, drain, return tokens in order."""
        rids = [self.submit(p, max_new_tokens=max_new_tokens,
                            temperature=temperature, top_k=top_k, top_p=top_p)
                for p in prompts]
        self.drain()
        return [np.asarray(self.completions[r].tokens, np.int32) for r in rids]

    # ------------------------------------------------------------------
    # Invariants and stats
    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        """Conservation sweep.  Raises ``AssertionError`` on a breach."""
        occupied = [s.rid for s in self.slots if s is not None]
        if sorted(occupied) != sorted(self.live):
            raise AssertionError(f"live rids {sorted(self.live)} != lane rids "
                                 f"{sorted(occupied)}")
        if len(set(occupied)) != len(occupied):
            raise AssertionError(f"a request owns two lanes: {occupied}")
        if self.counters["admitted"] - self.counters["evicted"] != len(occupied):
            raise AssertionError("admitted - evicted != occupied lanes")
        for comp in self.completions.values():
            if comp.status not in STATUSES:
                raise AssertionError(f"rid {comp.rid}: unknown status {comp.status!r}")
        if sum(self.counters[f"status_{st}"] for st in STATUSES) != len(self.completions):
            raise AssertionError("status counters != completions")
        if self.rec and self._last_op == "decode":
            # evict-time zeroing: after a decode step every free lane's
            # recurrent state is exactly zero (after an admission-only step
            # a lane that finished at its prefill is zeroed one step later)
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not self.rec.lanes_are_zero(self.state["cache"], free):
                raise AssertionError(
                    f"an evicted lane in {free} holds non-zero recurrent state")
        if not self.paged:
            return
        self.alloc.check()
        self.tables.check()
        bs = self.econ.page_size
        for i, s in enumerate(self.slots):
            if s is None:
                if self.tables.mapped(i):
                    raise AssertionError(f"freed slot {i} maps blocks")
                continue
            kv_len = s.prefilled if s.generated == 0 else s.plen + s.generated - 1
            if kv_len > self.tables.mapped(i) * bs:
                raise AssertionError(
                    f"slot {i}: {kv_len} KV positions written but only "
                    f"{self.tables.mapped(i)} blocks mapped")
        if not self.alloc.available >= self._deficit >= 0:
            raise AssertionError(f"deficit {self._deficit} exceeds available "
                                 f"{self.alloc.available}")

    @property
    def stats(self) -> dict:
        return {
            **self.counters, **self.aot.stats,
            "executables": len(self.aot),
            "graphs": len(self.graphs),
            "kv_layout": self.econ.kv_layout,
            "state_kind": self.kind,
            "kv_reserved_bytes": self.kv_reserved_bytes,
        }
