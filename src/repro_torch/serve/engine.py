"""Continuous-batching serve engine over a slotted or paged KV cache.

The port of the reference's ``serve/engine.py`` for the dense LM and the
hybrid family (zamba).  The engine runs one decode step over
``max_slots`` cache lanes at a time.  Requests are admitted into free
lanes at any step (prefill through a length-bucketed program), finished
sequences are evicted at once (EOS or token budget), and sampling is fused
into the decode program — the per-step host sync is one ``(max_slots,)``
int32 token fetch.

Two cache layouts (``EngineConfig.kv_layout``):

``slotted``  fixed ``max_slots x max_len`` lanes.
``paged``    a shared pool of fixed-size KV blocks with per-lane block
             tables (serve/paged.py): blocks are mapped on demand and
             freed on eviction.  Greedy decoding is token-for-token the
             slotted layout's.  Only for state kind ``"kv"``: a hybrid
             lane's recurrent state has no sequence axis to page.

On the paged layout, the scheduling features of the reference:

* **chunked prefill** (``prefill_chunk``): prompts are admitted in
  fixed-size chunks, one per engine step, interleaved with decode; one
  program per chunk size (first chunk, continuation) serves every prompt.
* **prefix cache** (``prefix_cache``): every fully written block is
  published under a chain key of the tokens it holds
  (:func:`~repro_torch.serve.paged.prefix_keys`); an admission shares the
  longest cached chain (refcounted) and prefills only the rest, copying
  the tail block (copy-on-write) when the chain covers the whole prompt,
  since the last position is always recomputed.
* **admission** ``"deficit"`` admits only while the pool covers every
  lane's worst case; ``"preempt"`` admits on immediate need, and when
  growth finds the pool empty evicts the lowest-priority lane back to the
  queue front.  A resumed request re-prefills its prompt and replays its
  emitted tokens through decode, force-fed and not re-emitted (the
  ``replay`` leaf), so its stream is the unpreempted one; a prefix-cache
  chain covering the prompt restores it mid-decode instead.

On every layout and state kind: host-initiated :meth:`ServeEngine.preempt`,
:meth:`~ServeEngine.cancel`, per-request deadlines (``submit(...,
deadline_s=)`` against the ``clock``), and a seeded
:class:`~repro_torch.serve.faults.FaultPlan` (``faults=``) whose faults,
like genuine non-finite logits, quarantine the lane and retry the request
through the preempt path up to ``max_retries`` times, then end it
``"failed"``.  Failures are statuses (:data:`STATUSES`), never exceptions
out of :meth:`~ServeEngine.step`.

A lane of a hybrid family (``registry.state_kind == "hybrid"``) holds a
slotted KV segment and per-lane recurrent leaves; :class:`RecurrentCache`
(``self.rec``) resets them at admission and the step programs zero them
at eviction, which :meth:`ServeEngine.check_invariants` sweeps.

The host keeps a mirror of the scheduling state (tokens, lengths,
budgets, block tables, which request owns which lane), advanced by the
same rules the device applies, so it never reads device state back except
the sampled tokens.  It copies the mirror into the device's buffers
before the program that needs it (tables before every program after a
table change; the whole scheduling mirror after a resume or a forced
replay token); it never rebinds a buffer.

Programs come from an :class:`~repro_torch.core.aot.AotCache` (the
reference's ``aot=``, shareable between engines), whose ``builds``,
``cache_hits`` and entry count (``executables``) feed :attr:`stats`:

* the decode program, keyed on (layout, ``stochastic``, ``masked``);
* one eager prefill program per (bucket or chunk size, first chunk or
  continuation), and the paged block copy, counted so the reference's
  build contract holds: flat in steady state (:meth:`prebuild` covers
  every program a schedule can dispatch).

On a CUDA device each decode step runs as a CUDA graph of the decode
program captured on this engine's state buffers
(:func:`~repro_torch.core.aot.device_program`: one eager step, then the
capture; every later step is one replay and the token fetch).  The
graphs are bound to those buffers, so they live in the engine's own
``AotCache`` (:attr:`graphs`, counted in :attr:`stats` as ``graphs``)
and go with the engine, never in a shared one.  On the CPU the decode
program runs eagerly.  Nothing falls back to eager on the card: a
capture that fails raises.  A preemption, a cancel or a copy-on-write
never rebuilds a graph.

Not ported yet — each raises ``NotImplementedError`` when set to a
non-default value: the host-RAM tier (``host_tier``,
``host_tier_blocks``) and hold/park (``park_idle_s``), speculative
decoding (``spec_draft``, ``spec_k``) and host-side sampling
(``fused_sampling=False``); snapshot/restore and request export/import
arrive with the tier.

    engine = ServeEngine(cfg, params, EngineConfig(max_slots=8, max_len=256,
                                                   kv_layout="paged",
                                                   prefill_chunk=64))
    rid = engine.submit(prompt_ids, max_new_tokens=32)
    engine.drain()
    out = engine.completions[rid].tokens
"""
from __future__ import annotations

import dataclasses
import hashlib
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
from .faults import NONFINITE_TOKEN, FaultPlan
from .paged import (
    BlockAllocator,
    SlotTables,
    blocks_for,
    cache_nbytes,
    make_paged_state,
    prefix_keys,
)
from .step import (
    paged_copy_program,
    paged_decode_program,
    paged_prefill_program,
    slot_decode_program,
    slot_prefill_program,
)

PAGED_ATTN_IMPLS = ("ref", "kernel")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration (the reference's field names).  Layout
    fields (``kv_layout`` and below) apply to state kind ``"kv"``; the
    paged-only options raise ``ValueError`` on the slotted layout."""

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
    # >0: admit prompts in chunks of this many tokens, one chunk per
    # engine step, interleaved with decode (paged only)
    prefill_chunk: int = 0
    paged_attn: str = "ref"       # paged decode backend: "ref" | "kernel"
    # paged only: refcounted shared-prefix block reuse (COW tail)
    prefix_cache: bool = False
    # "deficit": admit on worst-case block commitments; "preempt": admit
    # on immediate need, evict-and-requeue the lowest-priority lane when
    # growth finds the pool empty (paged only)
    admission: str = "deficit"
    # faulted-lane retries (through preempt-and-requeue) before "failed"
    max_retries: int = 2
    host_tier: bool = False
    host_tier_blocks: int | None = None
    park_idle_s: float | None = None
    spec_draft: Any = None
    spec_k: int = 0


# fields this slice does not port: each must keep its default
_NOT_PORTED = {
    "fused_sampling": "host-side sampling",
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
    chunk: int                    # prefill chunk size (== bucket when whole)
    prefilled: int = 0            # prompt positions prefilled so far
    generated: int = 0
    pub_upto: int = 0             # leading blocks already published/matched
    emit_from: int = 0            # the first k generated tokens replay
    #                               already-emitted output: not re-appended
    hasher: Any = None            # incremental chain hash (prefix_keys
    hashed: int = 0               # equivalent); blocks digested so far
    deadline: float | None = None # absolute clock() time the request expires


# Terminal per-request statuses (Completion.status), the reference's set.
# "shed" is produced only by the router front-end.
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
    # non-ok completions hold the tokens emitted before termination
    status: str = "ok"
    error: str | None = None      # terminal failure reason (status "failed")
    retries: int = 0              # fault retries consumed


@dataclasses.dataclass
class _Pending:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float
    top_k: int
    top_p: float
    submit_time: float
    deadline: float | None = None # absolute expiry (submit_time + deadline_s)
    # preempt-and-requeue: a preempted lane requeues with its ORIGINAL
    # prompt and the tokens already emitted (``replay``).  On re-admission
    # the prompt prefills as before and the emitted tokens regenerate
    # through decode, force-fed (decode-origin positions are only ever
    # recomputed by decode), so the resumed stream is the original;
    # replayed tokens are not re-emitted, and ``limit`` pins the original
    # budget (the live Completion is kept).
    resume: bool = False
    limit: int = 0
    replay: tuple[int, ...] = ()
    # set when a lane is preempted holding this many blocks: no
    # re-admission until the pool can plausibly cover one more
    min_free: int = 0


class ServeEngine:
    """Continuous-batching serve engine (see the module docstring).

    Invariants (swept by :meth:`check_invariants`): every in-flight
    request is owned by exactly one lane or one queued resume; paged
    block conservation (``free + live + cached == capacity``, refcounts
    covering every mapping, every lane's written KV inside its mapped
    blocks, no shared block past a lane's written KV, deficit admission
    never over-committing); status counters matching completions; for
    recurrent state kinds, all-zero recurrent leaves in every free lane
    after a decode step.
    """

    def __init__(self, cfg: ArchConfig, params, engine: EngineConfig = EngineConfig(),  # noqa: B008 - frozen
                 *, device=None, clock: Callable[[], float] = time.perf_counter,
                 faults: FaultPlan | None = None, aot: AotCache | None = None):
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
        if not self.paged and engine.prefill_chunk:
            raise ValueError("prefill_chunk requires kv_layout='paged'")
        if engine.admission not in ("deficit", "preempt"):
            raise ValueError(f"unknown admission {engine.admission!r}")
        if not self.paged and engine.prefix_cache:
            raise ValueError("prefix_cache requires kv_layout='paged'")
        if not self.paged and engine.admission != "deficit":
            raise ValueError("admission='preempt' requires kv_layout='paged'")
        if self.paged and not registry.supports_paged_serving(cfg):
            if self.kind != "kv":
                raise ValueError(
                    f"family {cfg.family!r} has state kind {self.kind!r}: "
                    "per-lane recurrent state is O(1) in sequence length — "
                    "there is no seq axis to page; use kv_layout='slotted'")
            raise ValueError(f"family {cfg.family!r} does not support paged serving")
        self.cfg, self.econ, self.clock = cfg, engine, clock
        # deterministic fault injection (serve/faults.py); None = off
        self.faults = faults
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
        else:
            self._num_blocks = 0
            self.state = make_slot_state(cfg, engine.max_slots, engine.max_len,
                                         self.device, engine.seed)
            self._decode_fn = slot_decode_program(cfg, eos_id=engine.eos_id)
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
        # the reference's counters, plus ``prefill_first_chunks`` (chunks
        # that start at position 0: the ones the flash kernel computes)
        self.counters = dict.fromkeys((
            "prefills", "prefill_chunks", "prefill_first_chunks", "decode_steps",
            "admitted", "evicted", "dead_slot_steps", "kv_peak_used_bytes",
            "prefill_tokens", "prefix_lookup_tokens", "prefix_hit_tokens",
            "cow_copies", "preemptions", "resumed", "replayed_tokens",
            *(f"status_{s}" for s in STATUSES), "retries", "faults_injected",
            "faults_detected"), 0)
        self._next_rid = 0
        # lanes barred from admission for one more step after a fault
        # (quarantine): one cooldown step keeps a hot fault site from
        # re-admitting into the same lane within the same engine step
        self._quarantine = [0] * engine.max_slots
        # the deadline sweep runs once some request carries a deadline
        self._has_deadlines = False
        self._tok_mirror = np.zeros(engine.max_slots, np.int32)
        self._active_mirror = np.zeros(engine.max_slots, bool)
        self._active_dirty = False
        self._sched_dirty = False
        # lanes whose NEXT decode input is a host-forced replay token
        self._replay_mirror = np.zeros(engine.max_slots, bool)
        # last engine operation ("prefill" | "decode" | "preempt"): the
        # recurrent zeroing invariant is checkable right after a decode
        self._last_op: str | None = None

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

    def _decode_key(self, stochastic: bool, masked: bool) -> tuple:
        return ("slot_decode", stochastic, masked) + self._program_key

    def _decode_entry(self, *, stochastic: bool, masked: bool) -> Callable:
        """The decode program for these sampling flags: ``entry(params,
        state) -> tok``.  On the card, a graph of it captured on this
        engine's buffers (its first call is the step that warmed it)."""
        key = self._decode_key(stochastic, masked)
        fn = self.aot.get(key, lambda: self.decode_program(stochastic=stochastic,
                                                           masked=masked))
        if self.device.type != "cuda":
            return fn
        gens = (self.state["generator"],) if stochastic else ()
        return self.graphs.get(key, lambda: device_program(fn, (self.params, self.state),
                                                           generators=gens))

    def _prefill_entry(self, chunk: int, first: bool = True) -> Callable:
        """The prefill program of a bucket or chunk size (eager; counted):
        the first chunk, or (paged) a continuation from ``start > 0``."""
        def build():
            eos = self.econ.eos_id
            if self.paged:
                return paged_prefill_program(self.cfg, eos_id=eos, first=first)
            return slot_prefill_program(self.cfg, eos_id=eos)
        return self.aot.get(("slot_prefill", chunk, first) + self._program_key, build)

    def _copy_entry(self) -> Callable:
        """The block copy of the prefix cache's copy-on-write tail."""
        return self.aot.get(("paged_copy",) + self._program_key,
                            lambda: paged_copy_program(self.cfg))

    def prebuild(self) -> None:
        """Build every program this engine can dispatch: the decode
        program for each sampling form, the prefill of each bucket or
        chunk size (and its continuation, under chunked prefill or the
        prefix cache: a hit prefills a suffix), and the block copy.  Prefix
        hits and preemption resumes make the prefill schedule
        timing-dependent, so a warm-up trace does not guarantee coverage;
        after this ``builds`` stays flat.  The decode graph is captured at
        the first decode step (it needs the engine's live buffers)."""
        e = self.econ
        for stochastic, masked in ((False, False), (True, False), (True, True)):
            self.aot.get(self._decode_key(stochastic, masked),
                         lambda: self.decode_program(stochastic=stochastic,
                                                     masked=masked))
        chunks = (e.prefill_chunk,) if (self.paged and e.prefill_chunk) else self.buckets
        for C in chunks:
            self._prefill_entry(C, first=True)
            if self.paged and (e.prefill_chunk or e.prefix_cache):
                self._prefill_entry(C, first=False)
        if self.paged and e.prefix_cache:
            self._copy_entry()

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
        default to the engine-wide ``EngineConfig`` values.  ``deadline_s``
        is a time to live from submission (on ``clock``): a request still
        queued or decoding when it passes ends ``"timeout"``, keeping the
        tokens it emitted."""
        prompt = self.validate(prompt, max_new_tokens)
        eff_k = int(self.econ.top_k if top_k is None else top_k)
        eff_p = float(self.econ.top_p if top_p is None else top_p)
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be positive")
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        now = self.clock()
        deadline = None if deadline_s is None else now + float(deadline_s)
        if deadline is not None:
            self._has_deadlines = True
        self.queue.append(_Pending(rid, prompt, max_new_tokens, float(temperature),
                                   eff_k, eff_p, now, deadline=deadline))
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a request wherever it is: queued (removed), or on a lane
        mid-prefill or mid-decode (evicted: block refs drop, the deficit
        commitment refunds).  It completes ``"cancelled"`` with the tokens
        it emitted.  False if it already completed; ``KeyError`` for an
        unknown rid."""
        if rid in self.completions:
            return False
        for idx, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[idx]
                self._terminate_queued(req, "cancelled")
                return True
        for slot, s in enumerate(self.slots):
            if s is not None and s.rid == rid:
                self._terminate(slot, "cancelled")
                return True
        raise KeyError(f"unknown rid {rid}")

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    # -- paged block bookkeeping ---------------------------------------
    def _can_admit(self, req: _Pending) -> bool:
        if not self.paged:
            return True
        bs = self.econ.page_size
        if self.econ.admission == "preempt":
            # immediate need only: blocks for the first prefill chunk (a
            # prefix hit can only shrink it); growth past that preempts
            C = self.econ.prefill_chunk or bucket_for(req.prompt.size, self.buckets)
            need = max(blocks_for(min(C, int(req.prompt.size)), bs), req.min_free)
            return self.alloc.available >= need
        limit = req.limit if req.resume else req.prompt.size + req.max_new_tokens - 1
        # admit only while the pool covers every live lane's worst case plus
        # this one (cached blocks count: alloc reclaims them)
        return self.alloc.available - self._deficit >= blocks_for(limit, bs)

    def _pick_victim(self) -> int | None:
        """Lowest-priority occupied lane: the highest rid (last arrived)."""
        best = None
        for i, s in enumerate(self.slots):
            if s is not None and (best is None or s.rid > self.slots[best].rid):
                best = i
        return best

    def _alloc_block(self, slot: int) -> int | None:
        """One block for ``slot``; under ``admission='preempt'`` an empty
        pool evicts the lowest-priority lane (possibly ``slot`` itself:
        then returns None and the caller abandons the lane's step)."""
        if self.faults is not None and self.faults.fire("alloc"):
            # injected transient pool exhaustion: the lane retries through
            # the preempt-and-requeue path a real fault takes
            self.counters["faults_injected"] += 1
            self._retry_lane(slot, "injected block-alloc fault")
            return None
        while True:
            try:
                return self.alloc.alloc()
            except RuntimeError:
                if self.econ.admission != "preempt":
                    raise
                victim = self._pick_victim()
                if victim is None:
                    raise
                self._preempt(victim)
                if victim == slot:
                    return None

    def _map_blocks(self, slot: int, need: int) -> bool:
        """Grow ``slot``'s table to ``need`` blocks.  False iff the lane
        itself was preempted to find room (it no longer exists)."""
        while self.tables.mapped(slot) < need:
            b = self._alloc_block(slot)
            if b is None:
                return False
            self.tables.append(slot, b)
            if self.econ.admission == "deficit":
                self._deficit -= 1
            self._tables_dirty = True
        return True

    def preempt(self, slot: int) -> None:
        """Host-initiated preempt-and-requeue of the live lane ``slot`` (any
        layout or state kind): the request requeues at the queue front with
        its prompt, emitted tokens and sampling state; its resume
        re-prefills only the prompt (the same bucket program, so the same
        state, KV or recurrent) and replays the emitted tokens through
        decode, so the resumed stream is the unpreempted one."""
        if self.slots[slot] is None:
            raise ValueError(f"slot {slot} is not serving a request")
        self._preempt(slot)

    def _preempt(self, slot: int) -> None:
        """Evict a live lane back to the queue front: its emitted tokens
        and sampling state requeue as a resume request, the table row
        nulls (paged) and every block reference drops.  The resume replays
        (the reference's ``spill=False`` path; the host tier that restores
        a spilled lane arrives with a later slice)."""
        s = self.slots[slot]
        comp = self.live[s.rid]
        if self.paged:
            # min_free damps re-admission until the pool can cover one
            # block more than the lane held, capped at its worst case
            wc = blocks_for(s.limit, self.econ.page_size)
            min_free = min(self.tables.mapped(slot) + 1, wc)
        else:
            min_free = 0
        # resumes go to the FRONT: successive victims within a step have
        # decreasing rids, so rid order (FCFS priority) is kept
        self.queue.appendleft(_Pending(
            s.rid, s.prompt, comp.max_new_tokens, s.temperature, s.top_k, s.top_p,
            comp.submit_time, deadline=s.deadline, resume=True, limit=s.limit,
            replay=tuple(comp.tokens), min_free=min_free))
        self._vacate(slot)
        if self.paged:
            self._release_blocks(slot)
        self._last_op = "preempt"
        self.counters["preemptions"] += 1

    def _vacate(self, slot: int, *, push_active: bool = True) -> None:
        """Free lane ``slot`` on the host: its ``active`` and ``replay``
        bits clear, pushed before the next decode (a lane the device
        finished itself owes no push, unless it still reads as replaying
        there)."""
        self.slots[slot] = None
        self._active_mirror[slot] = False
        if push_active or self._replay_mirror[slot]:
            self._active_dirty = True
        self._replay_mirror[slot] = False

    def _release_blocks(self, slot: int) -> None:
        """Drop a vacated lane's block references and refund its deficit
        commitment (deficit admission)."""
        if self.econ.admission == "deficit":
            self._deficit -= self._slot_wc[slot] - self.tables.mapped(slot)
        self._slot_wc[slot] = 0
        for b in self.tables.release(slot):
            self.alloc.free(b)
        self._tables_dirty = True

    def _push_tables(self) -> None:
        """Copy the host block-table mirror into the device's ``tables``.
        Must run before any program that follows a table change — in
        particular before the decode after an eviction, so a stale lane's
        sink-routed writes cannot land in re-allocated blocks."""
        if self._tables_dirty:
            self.state["tables"].copy_(torch.from_numpy(self.tables.table))
            self._tables_dirty = False

    def _push_active(self) -> None:
        """A host-side eviction clears a lane's ``active`` (and ``replay``)
        bit on the host; copy the mirrors into the device's before the
        next decode, so the freeze zeroes the vacated lane."""
        if self._active_dirty:
            self.state["active"].copy_(torch.from_numpy(self._active_mirror))
            self.state["replay"].copy_(torch.from_numpy(self._replay_mirror))
            self._active_dirty = False

    def _push_sched(self) -> None:
        """Copy the whole host scheduling mirror into the device's vectors
        (a lane restored mid-decode, or a replay token to force).  Values
        of free and mid-prefill lanes are don't-cares, so rebuilding every
        vector from ``self.slots`` is exact."""
        n = self.econ.max_slots
        lengths = np.zeros(n, np.int32)
        limits = np.zeros(n, np.int32)
        temps = np.zeros(n, np.float32)
        tks = np.zeros(n, np.int32)
        tps = np.zeros(n, np.float32)
        for i, s in enumerate(self.slots):
            if s is None:
                self._replay_mirror[i] = False
                continue
            lengths[i] = s.prefilled if s.generated == 0 else s.plen + s.generated - 1
            limits[i] = s.limit
            temps[i] = s.temperature
            tks[i] = s.top_k
            tps[i] = s.top_p
            # the NEXT decode of this lane forces a recorded replay token
            self._replay_mirror[i] = s.generated < s.emit_from
        pushes = 1
        if self.faults is not None and self.faults.fire("sched_push"):
            # injected lost push: the host mirror is the truth, so recovery
            # is the same push again
            self.counters["faults_injected"] += 1
            pushes = 2
        st = self.state
        for _ in range(pushes):
            for name, arr in (("tokens", self._tok_mirror), ("lengths", lengths),
                              ("limits", limits), ("temps", temps), ("top_ks", tks),
                              ("top_ps", tps), ("replay", self._replay_mirror),
                              ("active", self._active_mirror)):
                st[name].copy_(torch.from_numpy(arr))
        self._active_dirty = False

    def _try_restore(self, slot: int, req: _Pending) -> bool:
        """Resume fast path: if the prefix cache still holds a block chain
        covering the whole prompt (typically the lane's own published
        blocks), share it and restore the lane mid-decode — no prefill, and
        the original KV of every covered position.  The device sees the
        restored lane through a scheduling push."""
        k = len(req.replay)
        plen = int(req.prompt.size)
        bs = self.econ.page_size
        seq = np.concatenate([req.prompt, np.asarray(req.replay, np.int32)])
        written = seq[: plen + k - 1]        # positions whose KV existed
        chain = self.alloc.lookup(prefix_keys(written, bs))
        matched = len(chain) * bs
        if matched < plen:
            # prefill + decode replay; _match_prefix counts this lookup
            return False
        for b in chain:
            self.tables.append(slot, self.alloc.share(b))
            if self.econ.admission == "deficit":
                self._deficit -= 1
            self._tables_dirty = True
        s = self.slots[slot]
        s.prefilled = plen
        s.generated = matched - plen + 1     # pending input at pos ``matched``
        s.pub_upto = len(chain)
        self.counters["prefix_lookup_tokens"] += int(written.size)
        self.counters["prefix_hit_tokens"] += matched
        self._tok_mirror[slot] = int(seq[matched])
        self._active_mirror[slot] = True
        self._sched_dirty = True             # pushed before the next decode
        return True

    # -- admission ------------------------------------------------------
    def _match_prefix(self, slot: int, prompt: np.ndarray) -> int:
        """Prefix-cache lookup for a lane: share the longest cached block
        chain, copy the tail block (COW) when the chain covers the whole
        prompt (the sampling position is always recomputed), and map
        everything into the lane's table.  Returns the prefill start (the
        prompt positions the cache holds), or -1 if the lane was preempted
        finding the copy a block."""
        bs = self.econ.page_size
        plen = int(prompt.size)
        self.counters["prefix_lookup_tokens"] += plen
        chain = self.alloc.lookup(prefix_keys(prompt, bs))
        if not chain:
            return 0
        cow = len(chain) * bs >= plen
        shared = chain[:-1] if cow else chain
        for b in shared:
            self.tables.append(slot, self.alloc.share(b))
            self._tables_dirty = True
            if self.econ.admission == "deficit":
                self._deficit -= 1
        if cow:
            src = chain[-1]
            dst = self._alloc_block(slot)
            if dst is None:       # preempt mode evicted the lane itself
                return -1
            # on the current stream: ordered before the chunk that
            # rewrites the copy's tail
            self._copy_entry()(self.state, src, dst)
            self.tables.append(slot, dst)
            if self.econ.admission == "deficit":
                self._deficit -= 1
            self._tables_dirty = True
            self.counters["cow_copies"] += 1
        start = plen - 1 if cow else len(shared) * bs
        self.counters["prefix_hit_tokens"] += start
        self.slots[slot].pub_upto = len(chain)
        return start

    def _admit(self, req: _Pending, slot: int) -> None:
        plen = int(req.prompt.size)
        limit = req.limit if req.resume else plen + req.max_new_tokens - 1
        if not req.resume:
            self.live[req.rid] = Completion(
                rid=req.rid, prompt_len=plen, max_new_tokens=req.max_new_tokens,
                tokens=[], token_times=[], submit_time=req.submit_time,
                finish_time=0.0)
            self.counters["admitted"] += 1
        else:
            self.counters["resumed"] += 1
        self.slots[slot] = _Slot(req.rid, plen, limit, req.temperature, req.top_k,
                                 req.top_p, req.prompt, 0, emit_from=len(req.replay),
                                 deadline=req.deadline)
        if self.paged and self.econ.admission == "deficit":
            wc = blocks_for(limit, self.econ.page_size)
            self._slot_wc[slot] = wc
            self._deficit += wc
        if self.paged and self.econ.prefix_cache:
            if req.resume and req.replay and self._try_restore(slot, req):
                return                        # restored mid-decode
            start = self._match_prefix(slot, req.prompt)
            if start < 0:
                return                        # the lane preempted itself mapping COW
            self.slots[slot].prefilled = start
        s = self.slots[slot]
        if self.paged and self.econ.prefill_chunk:
            s.chunk = self.econ.prefill_chunk
        else:
            # a prefix hit prefills only the suffix: bucket THAT length
            s.chunk = bucket_for(plen - s.prefilled, self.buckets)
        self._prefill_next_chunk(slot)

    def _publish(self, slot: int) -> None:
        """Index every newly full block of the lane under its chain key.
        Keys digest the lane's whole token sequence (prompt + generated),
        so decode-boundary blocks are shareable too (a resume rides its
        own published chain)."""
        if not self.econ.prefix_cache:
            return
        s = self.slots[slot]
        bs = self.econ.page_size
        kv_len = s.prefilled if s.generated == 0 else s.plen + s.generated - 1
        full = kv_len // bs
        if full <= s.pub_upto:
            return
        comp = self.live[s.rid]

        def block_tokens(j: int) -> bytes:
            # tokens of positions [j*bs, (j+1)*bs); comp.tokens is the rid's
            # whole emitted history, so position p >= plen holds tokens[p - plen]
            a, b = j * bs, (j + 1) * bs
            parts = []
            if a < s.plen:
                parts.append(s.prompt[a: min(b, s.plen)])
            if b > s.plen:
                parts.append(np.asarray(comp.tokens[max(a - s.plen, 0): b - s.plen],
                                        np.int32))
            chunk = np.concatenate(parts) if len(parts) > 1 else parts[0]
            return np.ascontiguousarray(chunk, np.int32).tobytes()

        # incremental rolling hash, byte for byte ``prefix_keys``
        if s.hasher is None:
            s.hasher = hashlib.sha256()
        blocks = self.tables.blocks(slot)
        for j in range(s.pub_upto, full):
            while s.hashed <= j:
                s.hasher.update(block_tokens(s.hashed))
                s.hashed += 1
            self.alloc.publish(blocks[j], s.hasher.digest())
        s.pub_upto = full

    def _prefill_next_chunk(self, slot: int) -> None:
        """Run one prefill chunk for the lane (the whole bucketed prompt
        when chunking is off; the unmatched suffix after a prefix hit).
        The chunk covering the prompt's last position samples the first
        token and activates the lane."""
        if self.faults is not None and self.faults.fire("prefill"):
            # injected dispatch failure before the program runs: nothing
            # advanced on the device, the lane requeues and retries
            self.counters["faults_injected"] += 1
            self._retry_lane(slot, "injected prefill-dispatch fault")
            return
        s = self.slots[slot]
        start = s.prefilled
        C = s.chunk
        end = min(start + C, s.plen)
        padded = np.zeros((1, C), np.int32)
        padded[0, : end - start] = s.prompt[start:end]
        chunk = torch.tensor(padded, device=self.device)
        sampling = (s.temperature, s.top_k, s.top_p)
        if self.paged:
            if not self._map_blocks(slot, blocks_for(end, self.econ.page_size)):
                return                          # the lane preempted itself
            self._push_tables()
            prefill = self._prefill_entry(C, first=start == 0)
            _, out = prefill(self.params, self.state, chunk, slot, start, s.plen,
                             s.limit, *sampling)
        else:
            _, out = self._prefill_entry(C)(self.params, self.state, chunk, slot,
                                            s.plen, s.limit, *sampling)
        s.prefilled = end
        self._last_op = "prefill"
        self.counters["prefill_chunks"] += 1
        self.counters["prefill_first_chunks"] += start == 0
        self.counters["prefill_tokens"] += end - start
        self._publish(slot)
        if end < s.plen:
            return                              # more chunks to come
        self.counters["prefills"] += 1
        tok = int(out[0])                       # the prefill's host sync
        if tok == NONFINITE_TOKEN:
            # the prompt's sampling position saw non-finite logits
            self.counters["faults_detected"] += 1
            self._retry_lane(slot, "non-finite logits at prefill")
            return
        now = self.clock()
        comp = self.live[s.rid]
        s.generated = 1
        if s.emit_from >= 1:
            # replaying a preempted lane: force the RECORDED first token as
            # the next decode input (a temperature > 0 resample drawn at
            # another generator position must not fork the stream); the
            # original run continued past here, so the lane stays active
            self._tok_mirror[slot] = int(comp.tokens[0])
            self._active_mirror[slot] = True
            self._sched_dirty = True
            self.counters["replayed_tokens"] += 1
        else:
            comp.tokens.append(tok)
            comp.token_times.append(now)
            self._tok_mirror[slot] = tok
            done = (s.plen >= s.limit) or (
                self.econ.eos_id is not None and tok == self.econ.eos_id)
            self._active_mirror[slot] = not done
            if done:
                self._finish(slot, now)

    def _finish(self, slot: int, now: float) -> None:
        # natural EOS/budget eviction: the device already deactivated the
        # lane itself, so no active-mirror push is owed
        self._terminate(slot, "ok", now=now, push_active=False)

    def _terminate(self, slot: int, status: str, *, error: str | None = None,
                   now: float | None = None, push_active: bool = True) -> None:
        """Evict lane ``slot`` with a terminal ``status``: the one eviction
        path of EOS/budget finishes ("ok"), deadline expiry ("timeout"),
        :meth:`cancel` ("cancelled") and retry exhaustion ("failed").
        Block refs drop and the deficit commitment refunds; host-initiated
        terminations also owe the device an active-bit push."""
        s = self.slots[slot]
        comp = self.live.pop(s.rid)
        comp.finish_time = self.clock() if now is None else now
        comp.status = status
        comp.error = error
        self.completions[s.rid] = comp
        self._vacate(slot, push_active=push_active)
        if self.paged:
            self._release_blocks(slot)
        self.counters["evicted"] += 1
        self.counters[f"status_{status}"] += 1

    def _terminate_queued(self, req: _Pending, status: str,
                          error: str | None = None) -> None:
        """Terminal status for a request that is not on a lane (it holds no
        device resources).  A queued resume keeps the tokens its lane
        emitted before preemption."""
        if req.resume:
            comp = self.live.pop(req.rid)
        else:
            comp = Completion(rid=req.rid, prompt_len=int(req.prompt.size),
                              max_new_tokens=req.max_new_tokens, tokens=[],
                              token_times=[], submit_time=req.submit_time,
                              finish_time=0.0)
        comp.finish_time = self.clock()
        comp.status = status
        comp.error = error
        self.completions[req.rid] = comp
        self.counters[f"status_{status}"] += 1

    def _retry_lane(self, slot: int, reason: str) -> None:
        """Quarantine and bounded retry for a faulted lane (non-finite
        logits, a failed prefill dispatch or block alloc): the request
        requeues through the preempt path (its resume recomputes and
        replays through the programs already built) until its
        ``max_retries`` are spent, then ends ``"failed"``."""
        s = self.slots[slot]
        comp = self.live[s.rid]
        comp.retries += 1
        self.counters["retries"] += 1
        self._quarantine[slot] = 1
        if comp.retries > self.econ.max_retries:
            self._terminate(slot, "failed", error=reason)
        else:
            self._preempt(slot)

    def _expire_deadlines(self) -> None:
        """Terminate every queued or live request whose deadline passed
        (live lanes evict with the full resource refund)."""
        now = self.clock()
        expired = [r for r in self.queue if r.deadline is not None and now >= r.deadline]
        if expired:
            dead = {r.rid for r in expired}
            self.queue = deque(r for r in self.queue if r.rid not in dead)
            for req in expired:
                self._terminate_queued(req, "timeout")
        for slot, s in enumerate(self.slots):
            if s is not None and s.deadline is not None and now >= s.deadline:
                self._terminate(slot, "timeout", now=now)

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
        (non-finite sentinel: quarantined and requeued, nothing
        committed), ``"replay"`` (a recorded token force-fed, nothing
        emitted), ``"done"`` (emitted and finished) or ``"ok"``."""
        s = self.slots[i]
        if tok == NONFINITE_TOKEN:
            self.counters["faults_detected"] += 1
            self._retry_lane(i, "non-finite logits at decode")
            return "fault"
        s.generated += 1
        comp = self.live[s.rid]
        replaying = s.generated <= s.emit_from
        if replaying:
            # force the RECORDED token as the next input (the regenerated
            # one under greedy); no re-emission, no done
            self._tok_mirror[i] = int(comp.tokens[s.generated - 1])
            self._sched_dirty = True
            self.counters["replayed_tokens"] += 1
        else:
            comp.tokens.append(tok)
            comp.token_times.append(now)
            self._tok_mirror[i] = tok
        if self.paged and (s.plen + s.generated - 1) % self.econ.page_size == 0:
            self._publish(i)
        if replaying:
            return "replay"
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
        """Expire deadlines, advance in-flight chunked prefills (one chunk
        per lane), admit every queued request a free lane (and, paged, the
        block budget) can take, then advance every fully prefilled lane by
        one token.  Returns False when idle."""
        progressed = False
        if self._has_deadlines:
            self._expire_deadlines()
        for slot in range(self.econ.max_slots):
            s = self.slots[slot]
            if s is not None and s.prefilled < s.plen:
                self._prefill_next_chunk(slot)
                progressed = True

        for slot in self.free_slots():
            if self.slots[slot] is not None:    # refilled by a resume
                continue
            if self._quarantine[slot]:
                # fault cooldown: the lane sits out one admission round
                # (progress, so drain() does not read the step as idle)
                self._quarantine[slot] -= 1
                progressed = True
                continue
            if not self.queue or not self._can_admit(self.queue[0]):
                break
            self._admit(self.queue.popleft(), slot)
            progressed = True

        def active():
            return [i for i, s in enumerate(self.slots)
                    if s is not None and s.prefilled >= s.plen]

        active_slots = active()
        if active_slots and self.paged:
            # map the block each lane's next token lands in BEFORE the step
            # (the device never allocates); the highest-priority lanes map
            # first, so a preemption evicts strictly later arrivals
            for i in sorted(active_slots, key=lambda i: self.slots[i].rid):
                s = self.slots[i]
                if s is None:
                    continue                    # preempted by an earlier map
                next_pos = min(s.plen + s.generated - 1, s.limit - 1)
                self._map_blocks(i, next_pos // self.econ.page_size + 1)
            self._push_tables()
            active_slots = active()
        if active_slots:
            if self._sched_dirty:
                self._push_sched()
                self._sched_dirty = False
            else:
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
            if self.faults is not None:
                lane = self.faults.pick("decode_logits", active_slots)
                if lane is not None:
                    # as if the device had found non-finite logits there
                    self.counters["faults_injected"] += 1
                    toks = toks.copy()
                    toks[lane] = NONFINITE_TOKEN
            now = self.clock()
            for i in active_slots:
                self._advance_lane(i, int(toks[i]), now)
            progressed = True
        self._note_kv_usage()
        return progressed

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
        for comp in self.completions.values():
            if comp.status not in STATUSES:
                raise AssertionError(f"rid {comp.rid}: unknown status {comp.status!r}")
        if sum(self.counters[f"status_{st}"] for st in STATUSES) != len(self.completions):
            raise AssertionError("status counters != completions")
        lanes = [s.rid for s in self.slots if s is not None]
        if len(set(lanes)) != len(lanes):
            raise AssertionError(f"a request owns two lanes: {lanes}")
        inflight = sorted(lanes + [r.rid for r in self.queue if r.resume])
        if inflight != sorted(self.live):
            raise AssertionError(f"live rids {sorted(self.live)} != lane/resume "
                                 f"rids {inflight}")
        if not all(0 <= q <= 1 for q in self._quarantine):
            raise AssertionError(f"quarantine out of range: {self._quarantine}")
        if self.rec and self._last_op == "decode":
            # evict-time zeroing: after a decode step every free lane's
            # recurrent state is exactly zero (host-side evictions zero one
            # program later)
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not self.rec.lanes_are_zero(self.state["cache"], free):
                raise AssertionError(
                    f"an evicted lane in {free} holds non-zero recurrent state")
        if not self.paged:
            return
        self.alloc.check()
        self.tables.check(refcount=self.alloc.refcount if self.econ.prefix_cache else None)
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
            for j, b in enumerate(self.tables.blocks(i)):
                if self.alloc.refcount(b) < 1:
                    raise AssertionError(f"slot {i} maps non-live block {b}")
                # publication indexes FULL blocks only, so a block past the
                # lane's written KV (where its next writes land) is its own
                if (j + 1) * bs > kv_len and self.alloc.refcount(b) != 1:
                    raise AssertionError(
                        f"slot {i}: block {b} covers positions past kv_len "
                        f"{kv_len} but is shared (refcount {self.alloc.refcount(b)})")
            if s.pub_upto > self.tables.mapped(i):
                raise AssertionError(f"slot {i}: {s.pub_upto} blocks published "
                                     f"of {self.tables.mapped(i)} mapped")
        if self.econ.admission == "deficit" and not (
                self.alloc.available >= self._deficit >= 0):
            raise AssertionError(f"deficit {self._deficit} exceeds available "
                                 f"{self.alloc.available}")

    @property
    def stats(self) -> dict:
        out = {
            **self.counters, **self.aot.stats,
            "executables": len(self.aot),
            "graphs": len(self.graphs),
            "kv_layout": self.econ.kv_layout,
            "state_kind": self.kind,
            "kv_reserved_bytes": self.kv_reserved_bytes,
        }
        if self.paged:
            out["prefix_cached_blocks"] = self.alloc.num_cached
            out["prefix_cache_evictions"] = self.alloc.cache_evictions
            looked = self.counters["prefix_lookup_tokens"]
            out["prefix_hit_rate"] = (
                self.counters["prefix_hit_tokens"] / looked if looked else 0.0)
        if self.faults is not None:
            out["faults"] = self.faults.stats()
        return out
