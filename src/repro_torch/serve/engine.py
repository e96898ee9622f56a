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

On every layout and state kind:

* the **host-RAM tier** (``host_tier``, :class:`~repro_torch.serve.paged.HostTier`):
  a preempted lane's decode state (its KV blocks, or its whole lane slice
  per ``registry.lane_leaf_axes``) spills to host memory and its resume
  restores it by copy, without prefill or replay; LRU-reclaimed prefix
  blocks spill too, and admission promotes them back (a second-level
  prefix cache);
* **hold/park**: :meth:`~ServeEngine.hold` pauses a decoding lane in place
  (a recurrent or hybrid lane spills at once, since the decode freeze
  zeroes inactive lanes), :meth:`~ServeEngine.release` resumes it, and a
  lane held past ``park_idle_s`` parks off the card (its lane frees, its
  state stays in the tier);
* **snapshots and migration**: :meth:`~ServeEngine.snapshot` /
  :meth:`~ServeEngine.restore` (and ``save_snapshot``/``restore_snapshot``
  through a ``CheckpointManager``) serialize the engine's host truth as
  JSON; :meth:`~ServeEngine.export_request` /
  :meth:`~ServeEngine.import_request` move one request to another engine
  (of either package: the JSON shape is the reference's);
* ``fused_sampling=False``: the programs return the logits and the host
  samples them with the same sampler and a host generator seeded from
  ``EngineConfig.seed`` (the reference's baseline); greedy streams are the
  fused path's, and on the CPU stochastic ones too;
* **speculative decoding** (``spec_draft``, ``spec_k``): each step a draft
  model proposes ``spec_k`` greedy tokens a lane and the target verifies
  all ``spec_k + 1`` positions in the same program
  (:func:`~repro_torch.serve.step.spec_decode_program`), one
  ``(max_slots, spec_k + 1)`` fetch a round; greedy streams are the
  sequential engine's bitwise.  The draft's cache is one more (slotted)
  leaf of the state, ``state["draft"]``, rebuilt by a draft prefill over
  the committed history whenever a lane starts decoding or is restored.

Host-initiated :meth:`ServeEngine.preempt`,
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

Observability (:class:`~repro_torch.obs.Observer`, ``obs=``): the
counters are typed metrics (``kv_peak_used_bytes`` a gauge, every other
key a monotone counter), each terminal status feeds ``ttft_ms_<status>``
and ``tpot_ms_<status>`` histograms, and with a tracer every lifecycle
site of the reference emits its mark, instant or span (``decode``,
``prefill_chunk``); a failed :meth:`~ServeEngine.check_invariants` dumps
the flight recorder.  No emit synchronizes the device or changes a
program key.

On a mesh (``mesh=``, a :class:`~repro_torch.launch.mesh.MeshGroup` over
a process group) every rank runs this engine, the same schedule on the
same inputs, and the ``lm`` family (dense, gemma2, MoE) and the hybrid
family (zamba2) serve under the reference's layout: the weights this
rank's shards under ``ShardRules.for_mesh`` (:func:`serve_shard_layout`;
the model slices of heads, FFN, experts, vocabulary and zamba2's Mamba2
projections, gathered over ``data`` a layer at a time), the KV cache
this rank's part (``lm.cache_pspec`` of ``DecodeSharding.choose(mesh,
max_slots)``: ``max_slots / ndp`` lanes over the data axes, each lane's
positions over ``model``, or where ``max_slots`` does not divide every
lane with its positions over every rank; ``lm.paged_cache_pspec``: the
pool's blocks over the data axes, the pool rounded up to the data size
as the reference's, kv heads over ``model`` where they divide;
``zamba.cache_pspec``: k and v as ``lm.cache_pspec``, the recurrent
leaves the rank's lanes and whole over ``model``), every program inside the serving mesh
program (``common.serve_program``), and the logits gathered so every
rank samples the same tokens.  The block table, the allocator and the
schedule vectors stay global and replicated, so block ids, prefix hits
and copies are the reference's.  A slotted decode walks the rank's lanes;
a prefill runs its forward on every data rank (the weights' gathers are
collectives) and the lane's owner writes it; a paged decode attends every
lane over the rank's blocks and merges the data ranks' partials.  One
schedule needs one clock: the engine reads
:class:`MeshClock`, rank 0's clock broadcast at each reading, so
deadlines and every decision that reads the time agree on every rank.
``kv_reserved_bytes`` is what a rank holds, the reference's bytes a
device.  The features run on the mesh too, each rank holding and moving
its share: speculation's draft is a second model under its own mesh
program (its weights' shards, its slotted lanes over the data axes, even
under a paged target) entered around its half of each round; the host
tier's payloads are each rank's share of a block or lane
(:class:`~repro_torch.serve.paged.Share`), counted as whole payloads so
the ranks' tiers take the same decisions, and a restore into a block or
lane of another data rank moves the payload from its holder; hold/park
reads the mesh's clock; snapshots and migration carry host state, the
same on every rank (rank 0 writes a saved snapshot).  The other
slot-served families raise at a live model axis; ``mesh=None`` (or a
one-worker mesh without a process group) is the one-device engine.

Programs come from an :class:`~repro_torch.core.aot.AotCache` (the
reference's ``aot=``, shareable between engines), whose ``builds``,
``cache_hits`` and entry count (``executables``) feed :attr:`stats`:

* the decode program (or, speculating, the spec program), keyed on
  (layout, ``stochastic``, ``masked``);
* one eager prefill program per (bucket or chunk size, first chunk or
  continuation), the draft's prefill per bucket, and the paged block
  copy, counted so the reference's
  build contract holds: flat in steady state (:meth:`prebuild` covers
  every program a schedule can dispatch).

On a CUDA device each decode step (or spec round) runs as a CUDA graph of
its program captured on this engine's state buffers
(:func:`~repro_torch.core.aot.device_program`: one eager step, then the
capture; every later step is one replay and the token fetch).  The
graphs are bound to those buffers, so they live in the engine's own
``AotCache`` (:attr:`graphs`, counted in :attr:`stats` as ``graphs``)
and go with the engine, never in a shared one.  On the CPU the decode
program runs eagerly.  Nothing falls back to eager on the card: a
capture that fails raises.  A preemption, a cancel or a copy-on-write
never rebuilds a graph.

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
import json
import time
from collections import deque
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.core.aot import AotCache, device_program
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.models.attention import DecodeSharding
from repro_torch.models.common import ShardRules, serve_program
from repro_torch.obs import MetricMap, Observer
from .cache import RecurrentCache, bucket_for, make_slot_state, prompt_buckets, slot_state_specs
from .faults import NONFINITE_TOKEN, UNCOMMITTED, FaultPlan
from .paged import (
    BlockAllocator,
    HostTier,
    LaneSpill,
    SlotTables,
    blocks_for,
    cache_nbytes,
    check_tiered,
    make_paged_state,
    paged_state_specs,
    payload_nbytes,
    prefix_keys,
)
from .step import (
    lane_read_program,
    lane_write_program,
    paged_block_read_program,
    paged_block_write_program,
    paged_copy_program,
    paged_decode_program,
    paged_prefill_program,
    sample_tokens,
    slot_decode_program,
    slot_prefill_program,
    spec_buffers,
    spec_decode_program,
    spec_draft_prefill_program,
)

PAGED_ATTN_IMPLS = ("ref", "kernel")


class MeshClock:
    """One clock for every rank of a mesh: each reading is rank 0's
    ``clock()``, broadcast over the mesh's world group, so every rank
    takes the same decisions from it (deadlines, park thresholds, the
    router's shed estimate, a launcher's arrivals).  A reading is a
    collective: every rank reads at the same points of the same schedule
    (each does, since every decision it feeds agrees)."""

    def __init__(self, clock: Callable[[], float], mesh):
        self.base, self.mesh = clock, mesh
        self._buf = torch.zeros(1, dtype=torch.float64, device=mesh.device)

    def __call__(self) -> float:
        self._buf.fill_(self.base() if self.mesh.rank == 0 else 0.0)
        dist.broadcast(self._buf, src=0, group=self.mesh.pg)
        return float(self._buf.item())


def serve_shard_layout(cfg: ArchConfig, mesh):
    """The shard layout of the weights a rank of ``mesh`` serves
    (``ShardRules.for_mesh``: model slices over ``model``, FSDP shards over
    ``data``), or None where no mesh program runs: no mesh or one without
    a process group, or a family outside ``registry.MESH_SERVE_FAMILIES``
    (the others run at a model axis of 1 with the whole model on every
    rank)."""
    from repro_torch.optim.fsdp import make_shard_layout

    if mesh is None or mesh.pg is None or cfg.family not in registry.MESH_SERVE_FAMILIES:
        return None
    return make_shard_layout(cfg, ShardRules.for_mesh(mesh), mesh.size("data"),
                             mesh.coord("data"), model=mesh.size("model"),
                             model_rank=mesh.coord("model"))


def check_mesh(cfg: ArchConfig, mesh, engine: "EngineConfig") -> None:
    """Raise for what a mesh does not serve: the slot-served families
    other than the ``lm`` and hybrid families at a live model axis (a
    speculation draft's too); and a slotted ``max_len`` that does not
    divide over the ranks each lane's positions split over
    (``DecodeSharding.local_len``: the target's slotted cache, and a
    draft's, which is always slotted)."""
    if mesh is None:
        return
    live = mesh.size("model") > 1
    # (model, whether its cache is slotted)
    models = [(cfg, engine.kv_layout == "slotted")]
    if engine.spec_draft is not None:
        models.append((engine.spec_draft, True))
    for m, slotted in models:
        if mesh.pg is not None and m.family in registry.MESH_SERVE_FAMILIES and slotted:
            DecodeSharding.choose(mesh, engine.max_slots).local_len(engine.max_len)
        if live and m.family not in registry.MESH_SERVE_FAMILIES:
            raise NotImplementedError(
                f"{m.name}: serving on a live model axis is ported for the lm family "
                f"(dense, gemma2, moe) and the hybrid family (zamba2), not the "
                f"{m.family!r} family; the mesh {mesh.describe()} has one (ROADMAP.md "
                f"{registry.MESH_FAMILY_ITEM})")
    if mesh.pg is None and mesh.world > 1:
        raise ValueError(f"a mesh of {mesh.world} ranks needs a process group")


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
    # False: the programs return logits and the host samples them
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
    # --- host-RAM tier (any layout and state kind) ---------------------
    # spill a preempted lane's state to host RAM and restore it by copy at
    # resume; reclaimed prefix blocks spill too; held lanes may park
    host_tier: bool = False
    # the tier's budget in KV-block units (paged payloads); None =
    # unbounded; ignored when the caller passes a shared HostTier
    host_tier_blocks: int | None = None
    # a held lane parks off the card after this many clock seconds; None
    # = held lanes stay until release()
    park_idle_s: float | None = None
    # --- speculative decoding (any layout and state kind) --------------
    # the draft model's ArchConfig: each step it proposes ``spec_k``
    # greedy tokens a lane and the target verifies all ``spec_k + 1``
    # positions in one program; greedy output is the sequential engine's
    # bitwise.  Requires fused_sampling; both fields set together
    spec_draft: Any = None
    spec_k: int = 0


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
    held: bool = False            # hold(): paused between user turns
    held_since: float | None = None  # clock() of the hold (park threshold)


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
    request is owned by exactly one lane, one queued resume or one parked
    request; with a tier, four-state block conservation across the pool
    and the tier and one owner per chain key (:func:`check_tiered`); paged
    block conservation (``free + live + cached == capacity``, refcounts
    covering every mapping, every lane's written KV inside its mapped
    blocks, no shared block past a lane's written KV, deficit admission
    never over-committing); status counters matching completions; for
    recurrent state kinds, all-zero recurrent leaves in every free lane
    after a decode step.
    """

    def __init__(self, cfg: ArchConfig, params, engine: EngineConfig = EngineConfig(),  # noqa: B008 - frozen
                 *, device=None, clock: Callable[[], float] = time.perf_counter,
                 faults: FaultPlan | None = None, aot: AotCache | None = None,
                 obs: Observer | None = None, host_tier: HostTier | None = None,
                 draft_params=None, mesh=None):
        if not registry.supports_slot_serving(cfg):
            raise ValueError(f"family {cfg.family!r} does not support slot serving")
        if engine.kv_layout not in ("slotted", "paged"):
            raise ValueError(f"unknown kv_layout {engine.kv_layout!r}")
        if engine.paged_attn not in PAGED_ATTN_IMPLS:
            raise ValueError(f"paged_attn {engine.paged_attn!r} not in "
                             f"{PAGED_ATTN_IMPLS}")
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
        self.spec = engine.spec_draft is not None
        if self.spec != (engine.spec_k > 0):
            raise ValueError("spec_draft and spec_k must be set together "
                             f"(spec_draft={engine.spec_draft!r}, spec_k={engine.spec_k})")
        if self.spec:
            if not engine.fused_sampling:
                raise ValueError("speculative decoding requires fused_sampling=True "
                                 "(the verify rows ride the fused int32 fetch)")
            if not registry.supports_slot_serving(engine.spec_draft):
                raise ValueError(f"draft family {engine.spec_draft.family!r} does not "
                                 "support slot serving")
            if engine.spec_draft.vocab != cfg.vocab:
                raise ValueError(f"draft vocab {engine.spec_draft.vocab} != target vocab "
                                 f"{cfg.vocab}: verify compares token ids")
        elif draft_params is not None:
            raise ValueError("draft_params passed but EngineConfig.spec_draft is None")
        check_mesh(cfg, mesh, engine)
        if mesh is not None and mesh.pg is None:
            mesh = None                 # one worker without a group: no mesh
        self.mesh = mesh
        if mesh is not None and not isinstance(clock, MeshClock):
            clock = MeshClock(clock, mesh)
        self.cfg, self.econ, self.clock = cfg, engine, clock
        # deterministic fault injection (serve/faults.py); None = off
        self.faults = faults
        self.device = resolve_device(device if mesh is None else mesh.device)
        # the weights' layout and the serving mesh program (None: one device)
        self.shards = serve_shard_layout(cfg, mesh)
        self._mesh_program = None
        if self.shards is not None:
            dims = self.shards.gather_dims
            # the slotted cache's lanes (or positions) on the mesh; a paged
            # pool's blocks split over the data axes
            dec = None if self.paged else DecodeSharding.choose(mesh, engine.max_slots)
            self._mesh_program = lambda: serve_program(mesh, dims, dec)
        self.buckets = tuple(engine.prefill_buckets or prompt_buckets(engine.max_len))
        if max(self.buckets) > engine.max_len:
            raise ValueError("prefill bucket exceeds max_len")
        mod = registry.get_module(cfg)
        self.params = mod.cast_for_compute(cfg, self._local_params(params), self.device)
        prog = self._mesh_program
        cache_mesh = mesh if self.shards is not None else None     # None: whole here
        if self.paged:
            bs = engine.page_size
            if engine.max_len % bs:
                raise ValueError(f"max_len ({engine.max_len}) must be a "
                                 f"multiple of page_size ({bs})")
            blocks_per_slot = engine.max_len // bs
            self._num_blocks = engine.num_blocks or engine.max_slots * blocks_per_slot + 1
            if mesh is not None:
                # the reference's engine rounds the pool up to the data
                # size (its blocks split over the data axes)
                ndp = mesh.data.world
                self._num_blocks = -(-self._num_blocks // ndp) * ndp
            self.alloc = BlockAllocator(self._num_blocks, bs)
            self.tables = SlotTables(engine.max_slots, blocks_per_slot)
            self._deficit = 0           # committed-but-unallocated blocks
            self._slot_wc = [0] * engine.max_slots
            self._tables_dirty = False
            self.state = make_paged_state(cfg, engine.max_slots, engine.max_len,
                                          self._num_blocks, bs, self.device,
                                          engine.seed, mesh=cache_mesh)
            self._decode_fn = paged_decode_program(cfg, eos_id=engine.eos_id,
                                                   impl=engine.paged_attn,
                                                   fused=engine.fused_sampling,
                                                   mesh_program=prog)
        else:
            self._num_blocks = 0
            self.state = make_slot_state(cfg, engine.max_slots, engine.max_len,
                                         self.device, engine.seed, mesh=cache_mesh)
            self._decode_fn = slot_decode_program(cfg, eos_id=engine.eos_id,
                                                  fused=engine.fused_sampling,
                                                  mesh_program=prog)
        self.kv_reserved_bytes = cache_nbytes(self.state["cache"])

        # --- speculative decoding: the draft's lanes and the round's buffers
        # the draft cache is always slotted (a paged target too) and never
        # spills: committed tokens determine it, so every restore rebuilds
        # it by one draft prefill over the history (greedy output does not
        # depend on the draft's values, only how many tokens a round commits)
        self.draft_params = None
        self._draft_rec = None
        self._draft_program = None
        if self.spec:
            dcfg = engine.spec_draft
            dmod = registry.get_module(dcfg)
            # on a mesh the draft is a second model with its own layout
            # and mesh program: its weights' shards, its (always slotted)
            # lanes over the data axes
            dshards = serve_shard_layout(dcfg, mesh)
            if dshards is not None:
                ddims = dshards.gather_dims
                ddec = DecodeSharding.choose(mesh, engine.max_slots)
                self._draft_program = lambda: serve_program(mesh, ddims, ddec)
            # without draft_params, a deterministic draft from the engine
            # seed (real deployments pass trained draft weights); on a mesh
            # this rank's shards of the draft, or of that same init
            if dshards is None:
                if draft_params is None:
                    draft_params = dmod.init(dcfg, seed=engine.seed, device=self.device)
            else:
                from repro_torch.optim.fsdp import init_shards, local_shards

                draft_params = init_shards(dcfg, dshards, engine.seed, self.device) \
                    if draft_params is None else local_shards(dshards, draft_params)
            self.draft_params = dmod.cast_for_compute(dcfg, draft_params, self.device)
            self.state["draft"] = make_slot_state(
                dcfg, engine.max_slots, engine.max_len, self.device,
                mesh=mesh if dshards is not None else None)["cache"]
            self.state["spec"] = spec_buffers(cfg, dcfg, self.state["cache"],
                                              self.state["draft"], k=engine.spec_k,
                                              max_slots=engine.max_slots)
            self._draft_rec = RecurrentCache(dcfg)
            # draft rebuilds cover committed histories (prompt + emitted
            # tokens), which can outgrow the largest prompt bucket
            self._spec_buckets = self.buckets if max(self.buckets) >= engine.max_len \
                else self.buckets + (engine.max_len,)

        # --- host-RAM tier ---------------------------------------------
        # paged engines spill block by block; slotted engines spill the
        # whole-lane slice the family declares
        self._lane_axes = {} if self.paged else registry.lane_leaf_axes(cfg)
        # on a mesh a payload is this rank's share; the tier counts the
        # whole block's or lane's bytes, from the mesh-less shapes
        self._unit_nbytes = 0
        if self._mesh_program is not None and engine.host_tier:
            if self.paged:
                whole = paged_state_specs(cfg, engine.max_len, self._num_blocks,
                                          engine.page_size)
                self._unit_nbytes = cache_nbytes(whole) // self._num_blocks
            else:
                whole = slot_state_specs(cfg, engine.max_slots, engine.max_len)
                self._unit_nbytes = sum(
                    whole[n].numel() // whole[n].shape[a] * whole[n].element_size()
                    for n, a in self._lane_axes.items())
        if engine.park_idle_s is not None and not engine.host_tier:
            raise ValueError("park_idle_s requires host_tier=True")
        if engine.host_tier_blocks is not None and not engine.host_tier:
            raise ValueError("host_tier_blocks requires host_tier=True")
        if engine.host_tier:
            if not self.paged and not self._lane_axes:
                raise ValueError(
                    f"family {cfg.family!r} declares no lane_leaf_axes: the host "
                    "tier has nothing to spill on the slotted layout")
            # a caller's tier is shared (spills outlive this engine)
            self.tier = host_tier if host_tier is not None else HostTier(
                engine.host_tier_blocks)
            if self.paged and engine.prefix_cache:
                self.alloc.on_evict = self._spill_block
        else:
            if host_tier is not None:
                raise ValueError("host_tier instance passed but EngineConfig.host_tier "
                                 "is False")
            self.tier = None
        # rid -> pending resume of a lane parked off the card by hold() and
        # park_idle_s; it re-enters the queue on release()
        self.parked: dict[int, _Pending] = {}
        # observability (repro_torch.obs): metrics are always live (typed
        # counters behind the ``self.counters`` mapping); tracing and the
        # flight recorder run only when the caller's Observer carries them,
        # every emit behind an ``is not None``: a default engine pays one
        # attribute check a site, no device synchronize, no program-key change
        self.obs = obs if obs is not None else Observer(name="engine")
        self._track = self.obs.name
        # NOT ``aot or ...``: AotCache defines __len__, so a fresh (empty)
        # shared cache is falsy
        self.aot = aot if aot is not None else AotCache("serve", obs=self.obs)
        # this engine's decode graphs, on its own buffers (CUDA only)
        self.graphs = AotCache("decode_graphs", obs=self.obs)
        # every static option that changes a program (the reference's
        # _sampler_key); the cfg carries attn_impl and the dtypes.  Spec
        # changes the state (the draft's leaves), so every program keys on
        # the draft's config and spec_k
        e = engine
        self._program_key = (cfg, e.max_slots, e.max_len, e.eos_id, e.fused_sampling,
                             e.kv_layout, e.page_size, self._num_blocks, e.paged_attn,
                             e.spec_draft, e.spec_k)
        if mesh is not None:
            self._program_key += (mesh.describe(), mesh.coords, id(mesh.pg))

        self.queue: deque[_Pending] = deque()
        self.slots: list[_Slot | None] = [None] * engine.max_slots
        self.live: dict[int, Completion] = {}
        self.completions: dict[int, Completion] = {}
        # the reference's counters, plus ``prefill_first_chunks`` (chunks
        # that start at position 0: the ones the flash kernel computes) and
        # ``spec_draft_prefills`` (the draft's rebuilds, flash's other user),
        # backed by typed metrics: ``kv_peak_used_bytes`` is a Gauge (a peak,
        # see _note_kv_usage), every other key a monotone Counter
        self.counters = MetricMap(self.obs.metrics, (
            "prefills", "prefill_chunks", "prefill_first_chunks", "decode_steps",
            "admitted", "evicted", "dead_slot_steps", "kv_peak_used_bytes",
            "prefill_tokens", "prefix_lookup_tokens", "prefix_hit_tokens",
            "cow_copies", "preemptions", "resumed", "replayed_tokens",
            *(f"status_{s}" for s in STATUSES), "retries", "faults_injected",
            "faults_detected", "snapshot_restores",
            # per-request migration
            "exported", "imported",
            # host-RAM tier: lane spills and restores, bytes each way,
            # spilled prefix blocks and their promotions, payloads the tier
            # refused (the resume replays), hold/park
            "spills", "restores", "spilled_bytes", "restored_bytes", "spill_drops",
            "prefix_spills", "host_prefix_hits", "holds", "releases", "parked",
            # speculative decoding: verify rounds (spec_steps), lane-rounds
            # (an active lane in a round), draft tokens proposed, accepted
            # and chains ended by a mismatch, tokens committed
            "spec_steps", "spec_rounds", "spec_drafted", "spec_accepted",
            "spec_rejected", "spec_committed", "spec_draft_prefills"),
            gauges=("kv_peak_used_bytes",))
        self._kv_gauge = self.obs.metrics.gauge("kv_peak_used_bytes")
        self._next_rid = 0
        # lanes barred from admission for one more step after a fault
        # (quarantine): one cooldown step keeps a hot fault site from
        # re-admitting into the same lane within the same engine step
        self._quarantine = [0] * engine.max_slots
        # the deadline sweep runs once some request carries a deadline
        self._has_deadlines = False
        # fused_sampling=False: the host sampler's generator, seeded as the
        # device's, so on the CPU it draws what the fused programs draw
        self._host_gen = torch.Generator().manual_seed(engine.seed)
        self._tok_mirror = np.zeros(engine.max_slots, np.int32)
        self._active_mirror = np.zeros(engine.max_slots, bool)
        self._active_dirty = False
        self._sched_dirty = False
        # lanes whose NEXT decode input is a host-forced replay token
        self._replay_mirror = np.zeros(engine.max_slots, bool)
        # last engine operation ("prefill" | "decode" | "preempt"): the
        # recurrent zeroing invariant is checkable right after a decode
        self._last_op: str | None = None

    def _held_here(self, slots, rec: RecurrentCache, cache: dict) -> list:
        """The lanes of ``slots`` that ``cache`` holds on this rank, as
        indices into its lanes: every one, or where a mesh splits the
        lanes over the data axes this rank's run."""
        name, axis = next(iter(rec.leaf_axes.items()))
        n, N = cache[name].shape[axis], self.econ.max_slots
        if n == N:
            return list(slots)
        dec = DecodeSharding.choose(self.mesh, N)
        return [j for j in (dec.local_slot(i, n) for i in slots) if j is not None]

    def _local_params(self, params):
        """This rank's shards of ``params`` under a mesh program
        (``optim.fsdp.local_shards``), else ``params``."""
        if self.shards is None:
            return params
        from repro_torch.optim.fsdp import local_shards

        return local_shards(self.shards, params)

    # ------------------------------------------------------------------
    # Programs (through the shared AotCache)
    # ------------------------------------------------------------------
    def decode_program(self, *, stochastic: bool, masked: bool) -> Callable:
        """The eager decode program: ``fn(params, state) -> tok`` (the
        logits with ``fused_sampling=False``), one step in place (what the
        captured graph replays)."""
        decode_fn = self._decode_fn

        def fn(params, state):
            return decode_fn(params, state, stochastic=stochastic, masked=masked)[1]
        return fn

    def _decode_key(self, stochastic: bool, masked: bool) -> tuple:
        return ("slot_decode", stochastic, masked) + self._program_key

    def _decode_entry(self, *, stochastic: bool, masked: bool) -> Callable:
        """The decode program for these sampling flags: ``entry(params,
        state) -> tok``.  On the card, a graph of it captured on this
        engine's buffers (its first call is the step that warmed it).
        Without fused sampling the device program does not sample, so one
        program (and graph) serves every sampling form."""
        if not self.econ.fused_sampling:
            stochastic = masked = False
        key = self._decode_key(stochastic, masked)
        fn = self.aot.get(key, lambda: self.decode_program(stochastic=stochastic,
                                                           masked=masked))
        if self.device.type != "cuda":
            return fn
        gens = (self.state["generator"],) if stochastic else ()
        return self.graphs.get(key, lambda: device_program(fn, (self.params, self.state),
                                                           generators=gens))

    def spec_program(self, *, stochastic: bool, masked: bool) -> Callable:
        """The eager spec program: ``fn(params, dparams, state) -> rows``,
        one draft-and-verify round in place (what the captured graph
        replays)."""
        e = self.econ
        spec_fn = spec_decode_program(self.cfg, e.spec_draft, k=e.spec_k, eos_id=e.eos_id,
                                      paged=self.paged, impl=e.paged_attn,
                                      mesh_program=self._mesh_program,
                                      draft_program=self._draft_program)

        def fn(params, dparams, state):
            return spec_fn(params, dparams, state, stochastic=stochastic, masked=masked)[1]
        return fn

    def _spec_key(self, stochastic: bool, masked: bool) -> tuple:
        return ("spec_decode", stochastic, masked) + self._program_key

    def _spec_entry(self, *, stochastic: bool, masked: bool) -> Callable:
        """The spec program for these sampling flags: ``entry(params,
        dparams, state) -> rows``.  On the card, a graph of it captured on
        this engine's buffers, the generator registered when it samples
        (its first call is the round that warmed it)."""
        key = self._spec_key(stochastic, masked)
        fn = self.aot.get(key, lambda: self.spec_program(stochastic=stochastic,
                                                         masked=masked))
        if self.device.type != "cuda":
            return fn
        gens = (self.state["generator"],) if stochastic else ()
        return self.graphs.get(key, lambda: device_program(
            fn, (self.params, self.draft_params, self.state), generators=gens))

    def _spec_prefill_entry(self, bucket: int) -> Callable:
        """The draft's prefill of a history bucket (eager; counted)."""
        return self.aot.get(("spec_draft_prefill", bucket) + self._program_key,
                            lambda: spec_draft_prefill_program(
                                self.econ.spec_draft, draft_program=self._draft_program))

    def _spec_draft_prefill(self, slot: int, hist: np.ndarray) -> None:
        """Seed lane ``slot``'s draft cache with the committed history
        ``hist`` (the prompt, or the prompt and the committed tokens up to
        the pending decode input, not including it), bucketed like the
        target's prefill."""
        hist = np.asarray(hist, np.int32).reshape(-1)
        bucket = bucket_for(int(hist.size), self._spec_buckets)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, : hist.size] = hist
        self._spec_prefill_entry(bucket)(self.draft_params, self.state,
                                         torch.tensor(padded, device=self.device), slot,
                                         int(hist.size))
        self.counters["spec_draft_prefills"] += 1

    def _prefill_entry(self, chunk: int, first: bool = True) -> Callable:
        """The prefill program of a bucket or chunk size (eager; counted):
        the first chunk, or (paged) a continuation from ``start > 0``."""
        def build():
            eos, fused, prog = self.econ.eos_id, self.econ.fused_sampling, self._mesh_program
            if self.paged:
                return paged_prefill_program(self.cfg, eos_id=eos, first=first, fused=fused,
                                             mesh_program=prog)
            return slot_prefill_program(self.cfg, eos_id=eos, fused=fused, mesh_program=prog)
        return self.aot.get(("slot_prefill", chunk, first) + self._program_key, build)

    def _copy_entry(self) -> Callable:
        """The block copy of the prefix cache's copy-on-write tail."""
        return self.aot.get(("paged_copy",) + self._program_key,
                            lambda: paged_copy_program(self.cfg,
                                                       mesh_program=self._mesh_program))

    # -- host-tier transport (built once each, like every program) ------
    # on a mesh each reads and writes this rank's share (serve/step.py)
    def _block_read_entry(self) -> Callable:
        """Read blocks to host memory (a lane spill, a prefix spill)."""
        return self.aot.get(("tier_block_read",) + self._program_key,
                            lambda: paged_block_read_program(
                                self.cfg, mesh_program=self._mesh_program,
                                nbytes=self._unit_nbytes))

    def _block_write_entry(self) -> Callable:
        """Write blocks from host payloads (a restore, a promotion)."""
        return self.aot.get(("tier_block_write",) + self._program_key,
                            lambda: paged_block_write_program(
                                self.cfg, mesh_program=self._mesh_program))

    def _lane_read_entry(self) -> Callable:
        """Read one lane's whole cache slice (a slotted spill)."""
        return self.aot.get(("tier_lane_read",) + self._program_key,
                            lambda: lane_read_program(self.cfg, axes=self._lane_axes,
                                                      mesh_program=self._mesh_program,
                                                      nbytes=self._unit_nbytes))

    def _lane_write_entry(self) -> Callable:
        """Write one lane's whole cache slice (a slotted restore)."""
        return self.aot.get(("tier_lane_write",) + self._program_key,
                            lambda: lane_write_program(self.cfg, axes=self._lane_axes,
                                                       mesh_program=self._mesh_program))

    def prebuild(self) -> None:
        """Build every program this engine can dispatch: the decode
        program for each sampling form, the prefill of each bucket or
        chunk size (and its continuation, under chunked prefill or the
        prefix cache: a hit prefills a suffix), the block copy, and the
        tier's transport; speculating, the spec program for each sampling
        form in place of the decode program, and the draft's prefill of
        each history bucket.  Prefix hits and preemption resumes make the
        prefill schedule timing-dependent, so a warm-up trace does not
        guarantee coverage; after this ``builds`` stays flat.  The decode
        (or spec) graph is captured at the first decode step (it needs the
        engine's live buffers)."""
        e = self.econ
        forms = ((False, False), (True, False), (True, True)) if e.fused_sampling \
            else ((False, False),)
        for stochastic, masked in forms:
            if self.spec:
                self.aot.get(self._spec_key(stochastic, masked),
                             lambda: self.spec_program(stochastic=stochastic, masked=masked))
            else:
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
        if self.tier is not None:
            # the first eviction under load must not build
            if self.paged:
                self._block_read_entry()
                self._block_write_entry()
            else:
                self._lane_read_entry()
                self._lane_write_entry()
        if self.spec:
            for C in self._spec_buckets:
                self._spec_prefill_entry(C)

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
        if self.obs.tracer is not None:
            self.obs.mark("submit", rid, track=self._track, plen=int(prompt.size),
                          max_new=max_new_tokens)
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a request wherever it is: queued or parked (removed), or
        on a lane mid-prefill or mid-decode (evicted: block refs drop, the
        deficit commitment refunds).  It completes ``"cancelled"`` with the
        tokens it emitted.  False if it already completed; ``KeyError`` for
        an unknown rid."""
        if rid in self.completions:
            return False
        for idx, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[idx]
                self._terminate_queued(req, "cancelled")
                return True
        if rid in self.parked:
            self._terminate_queued(self.parked.pop(rid), "cancelled")
            return True
        slot = self._find_lane(rid)
        if slot is not None:
            self._terminate(slot, "cancelled")
            return True
        raise KeyError(f"unknown rid {rid}")

    def _find_lane(self, rid: int) -> int | None:
        for i, s in enumerate(self.slots):
            if s is not None and s.rid == rid:
                return i
        return None

    def hold(self, rid: int) -> bool:
        """Pause a decoding lane in place (an agent turn waiting on a tool,
        say): the lane keeps its slot and, for KV state, its device state,
        but its ``active`` bit clears so decode skips it.  Held lanes are
        first in line for preemption and park off the card after
        ``park_idle_s``.  A recurrent or hybrid lane spills to the tier at
        once, since the decode freeze zeroes inactive lanes' recurrent
        leaves: holding one needs a host tier.  Returns False if the tier
        refuses the spill (the lane keeps decoding); True for a lane
        already held.  ``KeyError`` for a rid not on a lane."""
        slot = self._find_lane(rid)
        if slot is None:
            raise KeyError(f"rid {rid} is not on a lane")
        s = self.slots[slot]
        if s.held:
            return True
        if s.prefilled < s.plen or s.generated < 1:
            raise ValueError(f"rid {rid} is mid-prefill; cannot hold")
        if self.rec:
            if not self._lane_spillable(s):
                raise ValueError(
                    "holding a recurrent/hybrid lane requires a host tier "
                    "(the freeze zeroes inactive lanes' recurrent state)")
            if not self._spill_lane(slot):
                return False
        s.held = True
        s.held_since = self.clock()
        self._active_mirror[slot] = False
        self._active_dirty = True
        self.counters["holds"] += 1
        if self.obs.tracer is not None:
            self.obs.mark("hold", rid, track=self._track, slot=slot)
        return True

    def release(self, rid: int) -> None:
        """Resume a held or parked request.  A held lane's ``active`` bit
        comes back (a recurrent lane first restores its hold-time spill:
        the device copy was zeroed); a parked request re-enters the queue
        at the front and resumes through admission, by copy if its spill
        survived.  ``KeyError`` if the rid is neither held nor parked."""
        if rid in self.parked:
            self.queue.appendleft(self.parked.pop(rid))
            self.counters["releases"] += 1
            if self.obs.tracer is not None:
                self.obs.mark("release", rid, track=self._track, parked=True)
            return
        slot = self._find_lane(rid)
        if slot is None or not self.slots[slot].held:
            raise KeyError(f"rid {rid} is not held or parked")
        s = self.slots[slot]
        s.held = False
        s.held_since = None
        self._active_mirror[slot] = True
        if self.rec:
            sp = self.tier.pop_lane(rid)
            assert sp is not None and sp.kind == "lane", \
                "held recurrent lane lost its hold-time spill"
            self._lane_write_entry()(self.state, sp.leaves, slot)
            self.counters["restores"] += 1
            self.counters["restored_bytes"] += sp.nbytes
            # push the whole mirror now: a program before the push would
            # freeze-zero the restored leaves, and the fused sampler zeroed
            # the held lane's ``tokens`` entry
            self._push_sched()
            self._sched_dirty = False
        else:
            # the fused sampler wrote 0 into the inactive lane's ``tokens``:
            # its decode input goes back with the active bit
            self._sched_dirty = True
        if self.spec:
            # a held recurrent draft lane was zeroed while inactive (a KV
            # draft survives, but one path rebuilds both): the committed
            # history determines the draft state
            comp = self.live[rid]
            self._spec_draft_prefill(slot, np.concatenate([
                s.prompt, np.asarray(comp.tokens[: s.generated - 1], np.int32)]))
        self.counters["releases"] += 1
        if self.obs.tracer is not None:
            self.obs.mark("release", rid, track=self._track, slot=slot)

    def _park(self, slot: int) -> None:
        """Move a long-held lane off the card: spill (unless its hold-time
        spill covers it), then preempt; a held lane's pending goes to
        ``self.parked``.  If the tier refuses the spill the lane parks
        anyway and its release replays."""
        s = self.slots[slot]
        if not self.tier.has_lane(s.rid) and self._lane_spillable(s):
            self._spill_lane(slot)
        self._preempt(slot, spill=False)

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def has_work(self) -> bool:
        # parked requests are unfinished work off the card: drain() callers
        # must release() them
        return bool(self.queue) or bool(self.parked) or any(
            s is not None for s in self.slots)

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
        """Lowest-priority occupied lane: held (idle) lanes first, then the
        highest rid (last arrived)."""
        best = None
        for i, s in enumerate(self.slots):
            if s is not None and (best is None or (s.held, s.rid) > (
                    self.slots[best].held, self.slots[best].rid)):
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
            if self.obs.tracer is not None:
                self.obs.instant("fault", track=self._track, site="alloc",
                                 rid=self.slots[slot].rid)
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
        its prompt, emitted tokens and sampling state.  With a host tier
        the lane spills and its resume restores it by copy; otherwise the
        resume re-prefills only the prompt (the same bucket program, so the
        same state, KV or recurrent) and replays the emitted tokens through
        decode, so the resumed stream is the unpreempted one."""
        if self.slots[slot] is None:
            raise ValueError(f"slot {slot} is not serving a request")
        self._preempt(slot)

    def _lane_spillable(self, s: _Slot) -> bool:
        """Whether a lane's decode state can move to the tier: fully
        prefilled and mid-decode (a mid-prefill lane holds nothing a replay
        rebuilds dearer), on a layout with a transport."""
        if self.tier is None or s.generated < 1 or s.prefilled < s.plen:
            return False
        return self.paged or bool(self._lane_axes)

    def _capture_spill(self, slot: int) -> LaneSpill:
        """Copy a lane's decode state to host memory as a LaneSpill (not yet
        in the tier: the caller admits it, and replays when refused).  A
        paged lane's blocks come in one gather, one payload per block."""
        s = self.slots[slot]
        if self.paged:
            payloads = self._block_read_entry()(self.state, self.tables.blocks(slot))
            return LaneSpill(s.rid, "paged", s.prefilled, s.generated, blocks=payloads)
        leaves = self._lane_read_entry()(self.state, slot)
        return LaneSpill(s.rid, "lane", s.prefilled, s.generated, leaves=leaves)

    def _spill_lane(self, slot: int) -> bool:
        """Capture and admit a lane spill; counted either way."""
        sp = self._capture_spill(slot)
        if self.tier.put_lane(sp):
            self.counters["spills"] += 1
            self.counters["spilled_bytes"] += sp.nbytes
            if self.obs.tracer is not None:
                self.obs.mark("spill", sp.rid, track=self._track, slot=slot, kind=sp.kind,
                              nbytes=sp.nbytes)
            return True
        self.counters["spill_drops"] += 1
        return False

    def _spill_block(self, block: int, key: bytes | None) -> None:
        """``BlockAllocator.on_evict``: an LRU-reclaimed prefix block's KV
        moves to the tier before its block is reused, so the cached chain
        spills instead of dying and a later admission promotes it.  The
        read is enqueued before the new owner's writes and synchronized
        before the payload is kept."""
        if key is None:
            return
        payload = self._block_read_entry()(self.state, [block])[0]
        nb = payload_nbytes(payload)
        if self.tier.put_block(key, payload):
            self.counters["prefix_spills"] += 1
            self.counters["spilled_bytes"] += nb
            if self.obs.tracer is not None:
                self.obs.instant("prefix_spill", track=self._track, nbytes=nb)
        else:
            self.counters["spill_drops"] += 1

    def _preempt(self, slot: int, *, spill: bool = True) -> None:
        """Evict a live lane back to the queue front: its emitted tokens
        and sampling state requeue as a resume request, the table row
        nulls (paged) and every block reference drops.  With a tier the
        lane spills first and its resume is a copy; without one, when the
        tier refuses, or with ``spill=False`` (a fault retry recomputes
        rather than restore suspect state) the resume replays.  A held
        lane's pending goes to ``self.parked`` instead of the queue:
        preempting idle work parks it early."""
        s = self.slots[slot]
        comp = self.live[s.rid]
        if spill and self._lane_spillable(s) and not (s.held and self.tier.has_lane(s.rid)):
            # a held recurrent lane spilled at hold() and its device copy
            # has been zeroed since: that spill is the truth
            self._spill_lane(slot)
        if self.paged:
            # min_free damps re-admission until the pool can cover one
            # block more than the lane held, capped at its worst case
            wc = blocks_for(s.limit, self.econ.page_size)
            min_free = min(self.tables.mapped(slot) + 1, wc)
        else:
            min_free = 0
        pending = _Pending(
            s.rid, s.prompt, comp.max_new_tokens, s.temperature, s.top_k, s.top_p,
            comp.submit_time, deadline=s.deadline, resume=True, limit=s.limit,
            replay=tuple(comp.tokens), min_free=0 if s.held else min_free)
        if s.held:
            # parked until release(); min_free resets, the pool pressure it
            # damped will be long gone
            self.parked[s.rid] = pending
            self.counters["parked"] += 1
            if self.obs.tracer is not None:
                self.obs.mark("park", s.rid, track=self._track, slot=slot)
        else:
            # resumes go to the FRONT: successive victims within a step
            # have decreasing rids, so rid order (FCFS priority) is kept
            self.queue.appendleft(pending)
            self.counters["preemptions"] += 1
        self._vacate(slot)
        if self.paged:
            self._release_blocks(slot)
        self._last_op = "preempt"
        if not s.held and self.obs.tracer is not None:
            self.obs.mark("preempt", s.rid, track=self._track, slot=slot,
                          emitted=len(comp.tokens))

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
            self.obs.instant("fault", track=self._track, site="sched_push")
            pushes = 2
        st = self.state
        for _ in range(pushes):
            for name, arr in (("tokens", self._tok_mirror), ("lengths", lengths),
                              ("limits", limits), ("temps", temps), ("top_ks", tks),
                              ("top_ps", tps), ("replay", self._replay_mirror),
                              ("active", self._active_mirror)):
                st[name].copy_(torch.from_numpy(arr))
        self._active_dirty = False

    def _promote_host_chain(self, keys: list[bytes], have: int) -> int:
        """Extend a device chain match with the tier's prefix blocks: each
        gets a free block, its payload written there (one write for all),
        published under its key and parked cached, so the ordinary
        lookup, share and COW treat it like any cached chain.  Promotion
        only takes free blocks; it never evicts cached ones (the two tiers
        would thrash).  Returns the number promoted."""
        if self.tier is None:
            return 0
        payloads, blocks = [], []
        for key in keys[have:]:
            if not self.tier.has_block(key) or self.alloc.num_free == 0:
                break
            payload = self.tier.pop_block(key)
            b = self.alloc.alloc()          # the free list is not empty: no eviction
            self.alloc.publish(b, key)
            self.alloc.free(b)              # parks in the cached set, indexed
            payloads.append(payload)
            blocks.append(b)
            self.counters["host_prefix_hits"] += 1
            self.counters["restored_bytes"] += payload_nbytes(payload)
        if blocks:
            self._block_write_entry()(self.state, payloads, blocks)
            if self.obs.tracer is not None:
                self.obs.instant("host_promote", track=self._track, blocks=len(blocks))
        return len(blocks)

    def _chain_lookup(self, keys: list[bytes]) -> list[int]:
        """Device chain lookup, extended through the tier: where the device
        match ends and the tier holds the next chain blocks, promote them
        first (the counter-free ``indexed`` probe sizes the device match,
        so hit and miss count once per admission)."""
        if self.tier is not None:
            have = 0
            for k in keys:
                if not self.alloc.indexed(k):
                    break
                have += 1
            if have < len(keys):
                self._promote_host_chain(keys, have)
        return self.alloc.lookup(keys)

    def _try_tier_restore(self, slot: int, req: _Pending) -> bool:
        """Resume's fastest path: the tier holds the lane's spill, so copy
        it back and continue mid-decode: no prefill, no replay of the
        covered tokens, and the continuation bitwise the never-evicted one
        (the payload is the evicted state).  A stale spill (older than the
        replay record, as after a restore refused for pool room) restores
        as a partial resume whose uncovered tokens replay through decode.
        The spill stays, and the resume replays, when the pool is short; a
        spill of another prompt or layout is dropped."""
        sp = self.tier.peek_lane(req.rid) if self.tier is not None else None
        if sp is None:
            return False
        s = self.slots[slot]
        plen = int(req.prompt.size)
        k_cov = sp.generated
        if sp.prefilled != plen or not (1 <= k_cov <= len(req.replay)) \
                or sp.kind != ("paged" if self.paged else "lane"):
            self.tier.drop_lane(req.rid)
            return False
        if sp.kind == "paged":
            if self.alloc.available < len(sp.blocks):
                return False            # leave the spill; this resume replays
            blocks = []
            for _ in sp.blocks:
                b = self._alloc_block(slot)
                if b is None:
                    # an injected alloc fault retried the lane itself (its
                    # partial table released, its spill dropped)
                    return False
                blocks.append(b)
                self.tables.append(slot, b)
                if self.econ.admission == "deficit":
                    self._deficit -= 1
                self._tables_dirty = True
            self._block_write_entry()(self.state, sp.blocks, blocks)
            # fresh private blocks: publication restarts (publish() dedups
            # against the original blocks if their keys are still indexed)
            s.pub_upto = 0
            s.hasher = None
            s.hashed = 0
        else:
            self._lane_write_entry()(self.state, sp.leaves, slot)
        self.tier.pop_lane(req.rid)
        seq = np.concatenate([req.prompt, np.asarray(req.replay, np.int32)])
        s.prefilled = plen
        s.generated = k_cov                 # next decode input is seq[plen + k_cov - 1]
        self._tok_mirror[slot] = int(seq[plen + k_cov - 1])
        self._active_mirror[slot] = True
        self.counters["restores"] += 1
        self.counters["restored_bytes"] += sp.nbytes
        if sp.kind == "lane" and self.rec:
            # restored recurrent leaves: the device must see the lane active
            # before any later program of this step, or its freeze zeroes them
            self._push_sched()
            self._sched_dirty = False
        else:
            self._sched_dirty = True
        if self.spec:
            # a spill carries the target's state only: rebuild the draft
            # over the history the spill covers (up to the pending input
            # seq[plen + k_cov - 1], not including it)
            self._spec_draft_prefill(slot, seq[: plen + k_cov - 1])
        if self.obs.tracer is not None:
            self.obs.mark("restore", req.rid, track=self._track, slot=slot,
                          source="host_tier", kind=sp.kind, nbytes=sp.nbytes)
        return True

    def _try_restore(self, slot: int, req: _Pending) -> bool:
        """Resume fast path: if the prefix cache still holds a block chain
        covering the whole prompt (typically the lane's own published
        blocks), share it and restore the lane mid-decode — no prefill, and
        the original KV of every covered position.  The device sees the
        restored lane through a scheduling push.  A chain the pool lost
        re-extends from the tier (:meth:`_promote_host_chain`)."""
        k = len(req.replay)
        plen = int(req.prompt.size)
        bs = self.econ.page_size
        seq = np.concatenate([req.prompt, np.asarray(req.replay, np.int32)])
        written = seq[: plen + k - 1]        # positions whose KV existed
        chain = self._chain_lookup(prefix_keys(written, bs))
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
        if self.spec:
            # the chain restores the target's KV only: rebuild the draft
            # over the restored history (before the pending input seq[matched])
            self._spec_draft_prefill(slot, seq[:matched])
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
        chain = self._chain_lookup(prefix_keys(prompt, bs))
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
        if self.obs.tracer is not None:
            self.obs.mark("admit", req.rid, track=self._track, slot=slot,
                          resume=req.resume)
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
        # the resume ladder: the tier's lane spill first (everything the
        # lane had written), then the device/host prefix chains, then
        # prefill and decode replay
        if req.resume and req.replay and self.tier is not None \
                and self.tier.has_lane(req.rid):
            if self._try_tier_restore(slot, req):
                return
            if self.slots[slot] is None:
                return                        # the lane faulted mid-restore
        if self.paged and self.econ.prefix_cache:
            if req.resume and req.replay and self._try_restore(slot, req):
                # restored mid-decode: nothing to prefill
                if self.obs.tracer is not None:
                    self.obs.mark("restore", req.rid, track=self._track, slot=slot)
                return
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
            digest = s.hasher.digest()
            self.alloc.publish(blocks[j], digest)
            if self.tier is not None and self.alloc.indexed(digest):
                # the key is device-indexed again: drop any host copy, so
                # every key has one owner (check_tiered)
                self.tier.discard_block(digest)
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
            if self.obs.tracer is not None:
                self.obs.instant("fault", track=self._track, site="prefill",
                                 rid=self.slots[slot].rid)
            self._retry_lane(slot, "injected prefill-dispatch fault")
            return
        s = self.slots[slot]
        if self.obs.tracer is None:
            self._prefill_chunk_run(slot)
        else:
            # host time: the chunk's dispatch (and, where it samples, its
            # token fetch), never a synchronize of its own
            with self.obs.span("prefill_chunk", track=self._track, rid=s.rid,
                               start=s.prefilled, chunk=s.chunk):
                self._prefill_chunk_run(slot)

    def _prefill_chunk_run(self, slot: int) -> None:
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
        fused = self.econ.fused_sampling
        if not fused and (end >= s.plen or s.temperature > 0):
            # host sampling: the fused program samples every chunk, so a
            # stochastic lane draws here on every chunk too
            tok = self._host_sample_prefill(out, s)
        s.prefilled = end
        self._last_op = "prefill"
        self.counters["prefill_chunks"] += 1
        self.counters["prefill_first_chunks"] += start == 0
        self.counters["prefill_tokens"] += end - start
        self._publish(slot)
        if end < s.plen:
            return                              # more chunks to come
        self.counters["prefills"] += 1
        if self.spec:
            # the lane decodes from here: seed its draft with the prompt
            self._spec_draft_prefill(slot, s.prompt)
        if fused:
            tok = int(out[0])                   # the prefill's host sync
        if tok == NONFINITE_TOKEN:
            # the prompt's sampling position saw non-finite logits
            self.counters["faults_detected"] += 1
            self._retry_lane(slot, "non-finite logits at prefill")
            if not fused:
                self._writeback_sampled()
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
            if self.obs.tracer is not None:
                self.obs.mark("replay", s.rid, track=self._track, pending=s.emit_from)
        else:
            comp.tokens.append(tok)
            comp.token_times.append(now)
            if self.obs.tracer is not None:
                self.obs.mark("first_token", s.rid, track=self._track)
            self._tok_mirror[slot] = tok
            done = (s.plen >= s.limit) or (
                self.econ.eos_id is not None and tok == self.econ.eos_id)
            self._active_mirror[slot] = not done
            if done:
                self._finish(slot, now)
        if not fused:
            self._writeback_sampled()

    def _host_sample(self, logits, temps, top_ks, top_ps, *, stochastic: bool,
                     masked: bool) -> np.ndarray:
        """``fused_sampling=False``: sample host logits (fp32 CPU tensor, one
        row a lane) with the fused sampler's own arithmetic and the host
        generator (``EngineConfig.seed``); the flags are the ones the fused
        program would get.  Non-finite rows give :data:`NONFINITE_TOKEN`."""
        tok = sample_tokens(
            logits, self._host_gen, torch.as_tensor(temps, dtype=torch.float32),
            top_ks=torch.as_tensor(top_ks, dtype=torch.int32),
            top_ps=torch.as_tensor(top_ps, dtype=torch.float32),
            stochastic=stochastic, masked=masked).numpy()
        finite = torch.isfinite(logits).all(dim=-1).numpy()
        return np.where(finite, tok, np.int32(NONFINITE_TOKEN)).astype(np.int32)

    def _host_sample_prefill(self, out, s: _Slot) -> int:
        """The host-sampled first token of a prefill chunk's logits."""
        logits = out.cpu()                      # the prefill's host sync
        return int(self._host_sample(
            logits, [s.temperature], [s.top_k], [s.top_p], stochastic=s.temperature > 0,
            masked=s.top_k > 0 or 0 < s.top_p < 1)[0])

    def _writeback_sampled(self) -> None:
        """Host sampling: copy the host's tokens and active bits into the
        device's vectors (in place) before the next program."""
        self.state["tokens"].copy_(torch.from_numpy(self._tok_mirror))
        self.state["active"].copy_(torch.from_numpy(self._active_mirror))

    def _observe_terminal(self, comp: Completion) -> None:
        """Latency histograms and the request's terminal trace mark: the
        one exit point every termination path funnels through.  TTFT is
        the first token's host arrival minus submission, the per-token
        latency the total latency over the emitted tokens (a request that
        emitted nothing records no latency)."""
        st = comp.status
        if comp.tokens:
            self.obs.metrics.histogram(f"ttft_ms_{st}").observe(
                max(0.0, (comp.token_times[0] - comp.submit_time) * 1e3))
            self.obs.metrics.histogram(f"tpot_ms_{st}").observe(
                max(0.0, (comp.finish_time - comp.submit_time) * 1e3 / len(comp.tokens)))
        if self.obs.tracer is not None:
            self.obs.mark("terminal", comp.rid, track=self._track, status=st,
                          tokens=len(comp.tokens), retries=comp.retries)

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
        if self.tier is not None:
            self.tier.drop_lane(s.rid)
        self.counters["evicted"] += 1
        self.counters[f"status_{status}"] += 1
        self._observe_terminal(comp)

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
        if self.tier is not None:
            self.tier.drop_lane(req.rid)
        self.counters[f"status_{status}"] += 1
        self._observe_terminal(comp)

    def _retry_lane(self, slot: int, reason: str) -> None:
        """Quarantine and bounded retry for a faulted lane (non-finite
        logits, a failed prefill dispatch or block alloc): the request
        requeues through the preempt path (its resume recomputes and
        replays through the programs already built) until its
        ``max_retries`` are spent, then ends ``"failed"``.  A faulted
        lane's state is suspect: it never spills, and an earlier spill
        drops."""
        s = self.slots[slot]
        comp = self.live[s.rid]
        comp.retries += 1
        self.counters["retries"] += 1
        self._quarantine[slot] = 1
        if self.obs.tracer is not None:
            self.obs.mark("retry", s.rid, track=self._track, reason=reason,
                          retries=comp.retries)
        if comp.retries > self.econ.max_retries:
            self._terminate(slot, "failed", error=reason)
        else:
            if self.tier is not None:
                self.tier.drop_lane(s.rid)
            self._preempt(slot, spill=False)

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
        for rid in [r for r, req in self.parked.items()
                    if req.deadline is not None and now >= req.deadline]:
            self._terminate_queued(self.parked.pop(rid), "timeout")
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
        self._kv_gauge.set_max(used)

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
        """Expire deadlines, park lanes held past ``park_idle_s``, advance
        in-flight chunked prefills (one chunk per lane), admit every queued
        request a free lane (and, paged, the block budget) can take, then
        advance every fully prefilled, unheld lane by one token.  Returns
        False when idle."""
        progressed = False
        if self._has_deadlines:
            self._expire_deadlines()
        if self.tier is not None and self.econ.park_idle_s is not None:
            now = self.clock()
            for slot, s in enumerate(self.slots):
                if s is not None and s.held and s.held_since is not None \
                        and now - s.held_since >= self.econ.park_idle_s:
                    self._park(slot)
                    progressed = True
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
                    if s is not None and s.prefilled >= s.plen and not s.held]

        active_slots = active()
        if active_slots and self.paged:
            # map the block each lane's next token lands in BEFORE the step
            # (the device never allocates); the highest-priority lanes map
            # first, so a preemption evicts strictly later arrivals
            for i in sorted(active_slots, key=lambda i: self.slots[i].rid):
                s = self.slots[i]
                if s is None:
                    continue                    # preempted by an earlier map
                # speculating, a round writes up to spec_k positions past the
                # next one: map that horizon (capped at the budget) so a
                # rejected step's overshoot lands in the lane's own fresh
                # blocks, never in a shared one
                horizon = s.plen + s.generated - 1 + (self.econ.spec_k if self.spec else 0)
                self._map_blocks(i, min(horizon, s.limit - 1) // self.econ.page_size + 1)
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
            flags = dict(stochastic=bool(sampled),
                         masked=any(s.top_k > 0 or 0 < s.top_p < 1 for s in sampled))
            # the decode span covers dispatch (a graph replay on the card)
            # and the token fetch, the step's one host sync: host time of
            # the step's critical path, on the engine's clock
            sid = None if self.obs.tracer is None else self.obs.begin(
                "decode", track=self._track, lanes=len(active_slots))
            if self.spec:
                rows = self._spec_entry(**flags)(self.params, self.draft_params, self.state)
                self._spec_round(active_slots, rows.cpu().numpy(), sid)  # the one host sync
            else:
                self._decode_round(active_slots, flags, sid)
            progressed = True
        self._note_kv_usage()
        return progressed

    def _decode_round(self, active_slots: list[int], flags: dict, sid=None) -> None:
        """One decode step over the active lanes and its host side: the
        token fetch (or the host sampler's), then each lane's commit.
        ``sid`` is the open ``decode`` span, ended after the fetch."""
        out = self._decode_entry(**flags)(self.params, self.state)
        if self.econ.fused_sampling:
            toks = out.cpu().numpy()            # the one host sync
        else:
            def per_lane(f, dt):
                return np.array([0 if s is None else f(s) for s in self.slots], dt)

            toks = self._host_sample(           # the logits fetch is the sync
                out.cpu(), per_lane(lambda s: s.temperature, np.float32),
                per_lane(lambda s: s.top_k, np.int32),
                per_lane(lambda s: s.top_p, np.float32), **flags)
        self._last_op = "decode"
        self._note_kv_usage(frozenset(active_slots))
        self.counters["decode_steps"] += 1
        self.counters["dead_slot_steps"] += self.econ.max_slots - len(active_slots)
        self.obs.end(sid)
        if self.faults is not None:
            lane = self.faults.pick("decode_logits", active_slots)
            if lane is not None:
                # as if the device had found non-finite logits there
                self.counters["faults_injected"] += 1
                if self.obs.tracer is not None:
                    self.obs.instant("fault", track=self._track, site="decode_logits",
                                     rid=self.slots[lane].rid)
                toks = toks.copy()
                toks[lane] = NONFINITE_TOKEN
        now = self.clock()
        for i in active_slots:
            self._advance_lane(i, int(toks[i]), now)
        if not self.econ.fused_sampling:
            self._writeback_sampled()

    def _spec_round(self, active_slots: list[int], rows: np.ndarray, sid=None) -> None:
        """The host side of a spec round: commit each active lane's row in
        order through :meth:`_advance_lane` up to its first
        :data:`UNCOMMITTED` entry, a fault or its finish, and count the
        speculation (replay rounds force one recorded token and speculate
        nothing)."""
        self._last_op = "decode"
        self._note_kv_usage(frozenset(active_slots))
        self.counters["decode_steps"] += 1
        self.counters["dead_slot_steps"] += self.econ.max_slots - len(active_slots)
        self.counters["spec_steps"] += 1
        self.counters["spec_rounds"] += len(active_slots)
        self.obs.end(sid)
        if self.faults is not None:
            lane = self.faults.pick("decode_logits", active_slots)
            if lane is not None:
                # as if the device had found non-finite logits at the
                # lane's first position
                self.counters["faults_injected"] += 1
                if self.obs.tracer is not None:
                    self.obs.instant("fault", track=self._track, site="decode_logits",
                                     rid=self.slots[lane].rid)
                rows = rows.copy()
                rows[lane, 0] = NONFINITE_TOKEN
        now = self.clock()
        k = self.econ.spec_k
        for i in active_slots:
            s = self.slots[i]
            replaying = s.generated < s.emit_from
            c, outcome = 0, "ok"
            for tok in rows[i]:
                tok = int(tok)
                if tok == UNCOMMITTED:
                    break                       # the first rejected position
                outcome = self._advance_lane(i, tok, now)
                if outcome == "fault":
                    break
                c += 1
                if outcome == "done":
                    break
            self.counters["spec_committed"] += c
            if not replaying:
                self.counters["spec_drafted"] += k
                # the first commit scores the pending token, each later one
                # accepts a draft proposal
                self.counters["spec_accepted"] += max(c - 1, 0)
                if outcome == "ok" and c <= k:
                    # the chain ended on a mismatch (not a finish, a fault
                    # or the row's end)
                    self.counters["spec_rejected"] += 1

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
    # Snapshots and per-request migration
    # ------------------------------------------------------------------
    # The engine's durable truth is on the host: the queue, the parked
    # requests, the Completions and their token streams.  Device state (the
    # KV pool, block tables, the prefix index, the tier's payloads) is a
    # cache of it: a lane's state is recomputable from its prompt and
    # recorded tokens through the resume path.  A snapshot therefore
    # serializes every live lane as a front-of-queue resume and drops the
    # device side; a fresh engine restored from it re-prefills and replays,
    # bitwise the uninterrupted streams under greedy decoding.  It is plain
    # JSON in the reference's shape (format 1), so it rides a
    # CheckpointManager's meta.json, and one package's export imports into
    # the other.

    _SNAP_FORMAT = 1

    @staticmethod
    def _snap_pending(req: _Pending) -> dict:
        return {
            "rid": req.rid,
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": req.max_new_tokens,
            "temperature": req.temperature,
            "top_k": req.top_k,
            "top_p": req.top_p,
            "submit_time": req.submit_time,
            "deadline": req.deadline,
            "resume": req.resume,
            "limit": req.limit,
            "replay": [int(t) for t in req.replay],
        }

    @staticmethod
    def _snap_completion(comp: Completion) -> dict:
        return {
            "rid": comp.rid,
            "prompt_len": comp.prompt_len,
            "max_new_tokens": comp.max_new_tokens,
            "tokens": [int(t) for t in comp.tokens],
            "token_times": [float(t) for t in comp.token_times],
            "submit_time": comp.submit_time,
            "finish_time": comp.finish_time,
            "status": comp.status,
            "error": comp.error,
            "retries": comp.retries,
        }

    @staticmethod
    def _load_completion(d: dict) -> Completion:
        return Completion(
            rid=int(d["rid"]), prompt_len=int(d["prompt_len"]),
            max_new_tokens=int(d["max_new_tokens"]),
            tokens=[int(t) for t in d["tokens"]],
            token_times=[float(t) for t in d["token_times"]],
            submit_time=float(d["submit_time"]), finish_time=float(d["finish_time"]),
            status=d["status"], error=d["error"], retries=int(d["retries"]))

    @staticmethod
    def _load_pending(d: dict, prompt: np.ndarray) -> _Pending:
        # min_free resets to 0: it damped re-admission against the old
        # engine's pool pressure, which stayed behind
        return _Pending(
            int(d["rid"]), prompt, int(d["max_new_tokens"]), float(d["temperature"]),
            int(d["top_k"]), float(d["top_p"]), float(d["submit_time"]),
            deadline=d["deadline"], resume=bool(d["resume"]), limit=int(d["limit"]),
            replay=tuple(int(t) for t in d["replay"]))

    def _econ_json(self) -> dict:
        # a JSON round trip (tuples -> lists), so a snapshot read back from
        # disk compares equal to a live config
        return json.loads(json.dumps(dataclasses.asdict(self.econ)))

    def snapshot(self) -> dict:
        """The engine's host truth as a JSON-able dict: live lanes become
        front-of-queue resumes in rid order (as :meth:`preempt` would
        requeue them), then the queue, then the parked requests (a hold is
        scheduling state: they resume decoding after a restart).  Device
        caches are dropped.  Consistent at any step boundary."""
        on_lane = sorted((i for i, s in enumerate(self.slots) if s is not None),
                         key=lambda i: self.slots[i].rid)
        pend = []
        for slot in on_lane:
            s = self.slots[slot]
            comp = self.live[s.rid]
            pend.append(self._snap_pending(_Pending(
                s.rid, s.prompt, comp.max_new_tokens, s.temperature, s.top_k, s.top_p,
                comp.submit_time, deadline=s.deadline, resume=True, limit=s.limit,
                replay=tuple(comp.tokens))))
        pend.extend(self._snap_pending(req) for req in self.queue)
        pend.extend(self._snap_pending(self.parked[r]) for r in sorted(self.parked))
        return {
            "format": self._SNAP_FORMAT,
            "arch": self.cfg.name,
            "engine": self._econ_json(),
            "queue": pend,
            # every in-flight rid's Completion (lane occupants, queued
            # resumes, parked): restore re-links them, so replay forcing and
            # the streams carry across the restart
            "live": {str(r): self._snap_completion(c) for r, c in self.live.items()},
            "completions": {str(r): self._snap_completion(c)
                            for r, c in self.completions.items()},
            "counters": dict(self.counters),
            "next_rid": self._next_rid,
        }

    def restore(self, snap: dict) -> None:
        """Rebuild serving state from :meth:`snapshot` into this engine,
        which must be fresh (the same arch and ``EngineConfig``, no request
        served).  The device caches are rebuilt by re-prefilling prompts
        and replaying recorded tokens; drive with :meth:`step` as usual."""
        if int(snap.get("format", -1)) != self._SNAP_FORMAT:
            raise ValueError(f"unsupported snapshot format {snap.get('format')!r}")
        if snap["arch"] != self.cfg.name:
            raise ValueError(f"snapshot is for arch {snap['arch']!r}, engine is "
                             f"{self.cfg.name!r}")
        if snap["engine"] != self._econ_json():
            raise ValueError("snapshot EngineConfig does not match this engine's")
        if self.has_work() or self.live or self.completions or self.counters["admitted"]:
            raise ValueError("restore() requires a fresh engine")
        for req in snap["queue"]:
            if req["deadline"] is not None:
                self._has_deadlines = True
            self.queue.append(self._load_pending(req, np.asarray(req["prompt"], np.int32)))
        self.live = {int(r): self._load_completion(c) for r, c in snap["live"].items()}
        self.completions = {int(r): self._load_completion(c)
                            for r, c in snap["completions"].items()}
        self.counters.update(snap["counters"])
        self._next_rid = int(snap["next_rid"])
        self.counters["snapshot_restores"] += 1
        self.obs.instant("snapshot_restore", track=self._track, queued=len(self.queue),
                         live=len(self.live))

    def export_request(self, rid: int) -> dict:
        """Remove one in-flight request from this engine and serialize it
        for another (a drain, a failover).  A lane occupant is preempted
        first (its blocks free, its deficit refunds; with a tier its spill
        stays there, so an engine sharing the tier restores it by copy).
        Returns ``{"pending": ..., "completion": ... | None}``, JSON-able,
        shaped like one entry of :meth:`snapshot`.  ``KeyError`` for an
        unknown rid, ``ValueError`` for a terminal one."""
        if rid in self.completions:
            raise ValueError(f"rid {rid} is already terminal")
        slot = self._find_lane(rid)
        if slot is not None:
            self._preempt(slot)         # now front-of-queue (or parked, if held)
        if rid in self.parked:
            req = self.parked.pop(rid)
        else:
            idx = next((i for i, r in enumerate(self.queue) if r.rid == rid), None)
            if idx is None:
                raise KeyError(f"unknown rid {rid}")
            req = self.queue[idx]
            del self.queue[idx]
        comp = self.live.pop(rid, None) if req.resume else None
        self.counters["exported"] += 1
        if self.obs.tracer is not None:
            self.obs.mark("export", rid, track=self._track, resume=req.resume)
        return {"pending": self._snap_pending(req),
                "completion": None if comp is None else self._snap_completion(comp)}

    def import_request(self, snap: dict, *, front: bool = False) -> int:
        """Install a request another engine exported.  ``front=True`` keeps
        the queue-front priority a preemption would have had.  It then
        admits and resumes through the ordinary path (a copy from a shared
        tier, or re-prefill and replay): bitwise the uninterrupted stream
        under greedy decoding.  Unlike :meth:`restore` this works on a busy
        engine; the rid must be new to it."""
        req = snap["pending"]
        rid = int(req["rid"])
        if (rid in self.live or rid in self.completions or rid in self.parked
                or any(r.rid == rid for r in self.queue)):
            raise ValueError(f"rid {rid} already known to this engine")
        resume = bool(req["resume"])
        comp = snap.get("completion")
        if resume and comp is None:
            raise ValueError(f"resume import of rid {rid} without its live Completion")
        prompt = self.validate(np.asarray(req["prompt"], np.int32), int(req["max_new_tokens"]))
        if req["deadline"] is not None:
            self._has_deadlines = True
        pending = self._load_pending(req, prompt)
        if resume:
            self.live[rid] = self._load_completion(comp)
        (self.queue.appendleft if front else self.queue.append)(pending)
        self._next_rid = max(self._next_rid, rid + 1)
        self.counters["imported"] += 1
        if self.obs.tracer is not None:
            self.obs.mark("import", rid, track=self._track, resume=resume, front=front)
        return rid

    def save_snapshot(self, mgr, step: int) -> None:
        """Persist :meth:`snapshot` through a
        :class:`~repro_torch.checkpoint.manager.CheckpointManager` (atomic:
        a crash mid-save leaves the previous checkpoint restorable).  On a
        mesh every rank builds the snapshot (the same host state), rank 0
        writes it and every rank passes a barrier, so a restore that
        follows reads the written checkpoint on every rank."""
        snap = self.snapshot()
        if self.mesh is None or self.mesh.rank == 0:
            mgr.save(step, {}, extra_meta={"engine_snapshot": snap})
        if self.mesh is not None:
            dist.barrier(group=self.mesh.pg)

    def restore_snapshot(self, mgr, step: int | None = None) -> int:
        """Restore from the checkpoint :meth:`save_snapshot` wrote (the
        latest when ``step`` is None); on a mesh every rank reads it.
        Returns its step."""
        step, meta = mgr.load_meta(step)
        if "engine_snapshot" not in meta:
            raise KeyError(f"checkpoint step {step} has no engine snapshot")
        self.restore(meta["engine_snapshot"])
        return step

    # ------------------------------------------------------------------
    # Invariants and stats
    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        """Conservation sweep.  Raises ``AssertionError`` on a breach; a
        failed sweep first records it and dumps the flight recorder (when
        one is attached), so the events before the breach land on disk
        with the message."""
        try:
            self._check_invariants()
        except AssertionError as e:
            self.obs.record("invariant_failure", engine=self._track, error=str(e))
            self.obs.dump("engine_invariant_failure", context={
                "engine": self._track,
                "error": str(e),
                "live_rids": sorted(self.live),
                "queued_rids": [r.rid for r in self.queue],
                "counters": dict(self.counters),
            })
            raise

    def _check_invariants(self) -> None:
        # metric-kind hygiene: the peak gauge never became a counter (or
        # the reverse) behind the MetricMap facade
        self.obs.metrics.check()
        kind = self.obs.metrics.kind
        if kind("kv_peak_used_bytes") != "gauge":
            raise AssertionError("kv_peak_used_bytes must be a gauge (peak set, not a sum)")
        for k in ("decode_steps", "admitted", "evicted", "preemptions"):
            if kind(k) != "counter":
                raise AssertionError(f"{k} must be a counter")
        for comp in self.completions.values():
            if comp.status not in STATUSES:
                raise AssertionError(f"rid {comp.rid}: unknown status {comp.status!r}")
        if sum(self.counters[f"status_{st}"] for st in STATUSES) != len(self.completions):
            raise AssertionError("status counters != completions")
        lanes = [s.rid for s in self.slots if s is not None]
        if len(set(lanes)) != len(lanes):
            raise AssertionError(f"a request owns two lanes: {lanes}")
        inflight = sorted(lanes + [r.rid for r in self.queue if r.resume]
                          + list(self.parked))
        if inflight != sorted(self.live):
            raise AssertionError(f"live rids {sorted(self.live)} != lane/resume/parked "
                                 f"rids {inflight}")
        for rid, req in self.parked.items():
            if not (req.resume and req.rid == rid):
                raise AssertionError(f"parked rid {rid} is not a resume pending")
        if not all(0 <= q <= 1 for q in self._quarantine):
            raise AssertionError(f"quarantine out of range: {self._quarantine}")
        if self.rec and self.econ.fused_sampling and self._last_op == "decode":
            # evict-time zeroing: after a decode step every free lane's
            # recurrent state is exactly zero (host-side evictions zero one
            # program later)
            free = self._held_here([i for i, s in enumerate(self.slots) if s is None],
                                   self.rec, self.state["cache"])
            if not self.rec.lanes_are_zero(self.state["cache"], free):
                raise AssertionError(
                    f"an evicted lane in {free} holds non-zero recurrent state")
        if self.spec and self._draft_rec and self._last_op == "decode":
            # the spec program's draft-side freeze is the only thing that
            # zeroes dead draft lanes: swept like the target's
            free = self._held_here([i for i, s in enumerate(self.slots) if s is None],
                                   self._draft_rec, self.state["draft"])
            if not self._draft_rec.lanes_are_zero(self.state["draft"], free):
                raise AssertionError(
                    f"an evicted lane in {free} holds non-zero draft recurrent state")
        if not self.paged:
            if self.tier is not None:
                self.tier.check()
            return
        check_tiered(self.alloc, self.tier)
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
        if self.mesh is not None:
            out["mesh"] = self.mesh.describe()
        if self.spec:
            drafted = self.counters["spec_drafted"]
            out["spec_acceptance_rate"] = (
                self.counters["spec_accepted"] / drafted if drafted else 0.0)
            # committed tokens a lane a round: the sequential engine's is
            # 1.0, so above 1.0 speculation pays for its round
            rounds = self.counters["spec_rounds"]
            out["tokens_per_decode_dispatch"] = (
                self.counters["spec_committed"] / rounds if rounds else 0.0)
        if self.paged:
            out["prefix_cached_blocks"] = self.alloc.num_cached
            out["prefix_cache_evictions"] = self.alloc.cache_evictions
            looked = self.counters["prefix_lookup_tokens"]
            out["prefix_hit_rate"] = (
                self.counters["prefix_hit_tokens"] / looked if looked else 0.0)
        if self.tier is not None:
            t = self.tier
            out["host_tier"] = {
                "spilled_lanes": t.spilled_lanes, "spilled_blocks": t.spilled_blocks,
                "used_bytes": t.used_bytes, "capacity_blocks": t.capacity_blocks,
                "lane_spills": t.lane_spills, "lane_restores": t.lane_restores,
                "prefix_spills": t.prefix_spills, "prefix_hits": t.prefix_hits,
                "drops": t.drops,
            }
        if self.faults is not None:
            out["faults"] = self.faults.stats()
        return out
