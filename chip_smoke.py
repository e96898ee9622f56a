#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Build the hand-written CUDA kernels from ``src/repro_torch`` with nvcc
   (into ``build/kernels/``) and print ptxas's register/spill report.
2. Hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes, in bf16 (atol 1e-3 plus rtol 1e-2: kernel and
   plain version both compute in fp32 from the same bf16 inputs and round
   once, so they differ by at most one bf16 ulp, under 2**-7 of the value)
   and fp32 (3e-5: the same fp32 arithmetic in another summation order).
   Time both in bf16 by device time per call from ``torch.profiler``
   (``device_ms``; back-to-back CUDA events beside it as ``*_events``):
   flash, causal, at a smollm-360m prefill (1, 512, 15, 64), the training
   shape (4, 1024, 15, 64) and a zamba2-1.2b prefill (1, 512, 32, 64, rep
   1), beside SDPA (the yardstick the port never calls; its kernels'
   names are printed); paged at random lengths 1..1023 and at phase 3's
   own lengths, with its split count and device kernels per call.  Print
   each wrapper's host microseconds per call (1,000 calls, one
   synchronize).  Head dim 128 (gemma2-27b's 32/16 heads and deepseek-67b's
   64/8): flash causal, window 4096 at S 4608 (the window's edge), softcap
   50 and both, bf16 and fp32; paged at rep 2 (Hk 16) and rep 8 (Hk 8) on
   lanes both sides of 4096, plain, softcap 50, and window 4096 with
   softcap 50.  Timed: flash at gemma2's bucket-512 prefill (1, 512, 32,
   16, 128), causal, and at (1, 8192, 32, 16, 128) with window 4096, each
   also at softcap 50 (``ms_softcap``), SDPA beside (with a band mask for
   the window); paged at phase 7's lengths (six short lanes and the two
   long ones), the local layer's call (window 4096, softcap 50) and the
   global layer's (softcap 50).  Head dim 160 (stablelm-12b's 32/8 heads:
   the flash kernel's 32-column tail panel): flash causal at S 512 and 300,
   window 4096 at S 4608, softcap 50 and both, bf16 and fp32, timed at
   (1, 512, 32, 8, 160) and (1, 4096, 32, 8, 160) beside SDPA; ptxas's
   spill bytes of the bf16 D-160 instantiation printed.  Paged at D 160 rep
   4 (Hk 8), D 128 rep 16 (Hk 4: qwen3-moe-235b-a22b's 64/4 heads) and D
   160 rep 16 (the combine kernel's 2 and 4 elements a thread), at random
   lengths and at phase 8's, plain, softcap 50 and window 4096 with
   softcap 50, bf16 and fp32; timed at phase 8's call (D 160 rep 4),
   phase 9's (D 128 rep 8) and the two rep-16 shapes, with bound, split
   count and device kernels per call.  The paged kernel's block-range
   entry (``paged_attention_range``, a data rank's share of the pool's
   blocks): at phase 3's D-64 shape and qwen3-moe-30b-a3b's D 128 rep 8,
   phase 3's lengths, plain and window 100 with softcap 30, bf16 and
   fp32, the pool's two halves (views) launched with their ``block_lo``
   and merged by the port's LSE combine, held against the whole pool's
   launch and ``ref.py`` (``TOL``), and the entry over the full range
   bitwise ``paged_attention``; each half timed, its bound the bytes it
   reads.
2b. Hold the ``flat_adam`` kernel against its plain version (fp32, atol
   and rtol 1e-6: the same fp32 formula, differing only in ``powf``,
   ``sqrtf``, division and FMA contraction by an ulp or two) for n in
   {512, 65,537, 361,821,184}, t in {1, 1000}, wd in {0, 0.1}, and time
   it at the full flat buffer beside the plain version and
   ``torch.optim.Adam(fused=True)``.
2c. Hold the flash Function's gradient (the reference's recompute through
   ``chunked_attention``) against autograd through ``attention_ref`` at
   q (4, 1024, 15, 64), k/v (4, 1024, 5, 64), causal, bf16 and fp32.
2d. Hold the ``ssd`` scan kernel against its plain version
   (``ssd_chunked`` at the config's chunk 256) at the full-width prefill
   shape x (1, 512, 64, 64), N = 64, G = 1, and at ragged T (300, 37), from
   fp32 and bf16 inputs, x/B/C as strided views of one buffer as the
   Mamba2 block passes them: y and the final state (fp32) within 1e-4 of
   the tensor's largest entry plus 1e-4 of each entry (the same fp32
   products, blocked by 64 positions in the kernel and 256 in the plain
   version); plus the TPU layout's bf16 output (bf16 tolerance).  Time
   kernel and plain version at (1, 512, 64, 64) and (1, 2048, 64, 64)
   from bf16 inputs, beside both bounds (the fp32 FMA pipes', the first
   design's, and the bf16 tensor cores', the row's own), the blocks of each
   of the kernel's passes and its device kernels per call; print the
   wrapper's host microseconds per call.  Then the gradient: under grad the
   wrapper's outputs carry one (the kernel's forward, a backward that
   recomputes through ``ssd_chunked``), held against autograd through the
   plain scan at (1, 512) and (2, 1,024) positions of 64 heads, fp32 and
   bf16: y and the state within ``SSD_TOL``, the gradients bitwise, with
   the train slice's backward device ms beside its forward's; and the
   kernel timed at the train slice (2, 1024, 64, 64).
2e. Hold the RMSNorm kernel's three entries against their plain versions
   at the main paths' (rows, width) (``RMSNORM_PATHS``): smollm-360m's
   (8, 960), (512, 960) and (4096, 960), zamba2's and xlstm-1.3b's (8,
   2048) and (512, 2048), and (8, 4096) and (512, 4096), whisper-tiny's
   (8, 384) and (12000, 384), internvl2-76b's (8, 8192) and (1536, 8192)
   (the kernel's widest row), phases 13-14's train slices (2048, 2048),
   (2048, 4096) gated and (32768, 128), bf16 and fp32 (``TOL``; the
   new residual of ``rmsnorm_add`` bitwise); the gated form (skip and gate
   folded into the out-norm) at the 4096-wide shapes, on views into
   zamba2's projections.  Time them in bf16 beside their plain versions
   (the gated form's plain version is the eager chain it replaces) and
   ``torch.nn.functional.rms_norm`` with weight ``1 + gamma``: L2-cold
   (each call on its own copy of the inputs, ``COLD_BYTES`` of copies
   between two reads of one), and warm beside it (``*_warm``: one set of
   inputs, resident in the 50 MB L2 across calls).  Print each wrapper's
   host microseconds per call beside its plain chain's.  The times of 2d
   and 2e are device time per call from ``torch.profiler``
   (``device_ms``); 2d keeps back-to-back CUDA events, host-bound for
   calls of a few microseconds, beside them as ``*_events``.  Then the
   split entry (``rmsnorm_gated_split``: the gated form over a rank's
   columns of a row split across model ranks) at (2048, 4096) and (8,
   4096), bf16 and fp32: the row cut into 1, 2 and 4 column shards of
   whole heads, the shards' sums of squares added on the card, each shard
   normalised by the total, against its plain version (``TOL``) and the
   whole-row gated kernel (one shard bitwise, more ``TOL``); timed at one
   shard (two launches a call) beside its plain chain.
2f. Flash at the frontend families' shapes (``FLASH_FRONTEND``):
   whisper-tiny's encoder self-attention (8, 1500, 6, 64) and its prefill
   cross-attention (32 queries over 1,500 keys), non-causal, the last key
   tile ragged (1,500 = 23 x 64 + 28); an internvl2-76b prefill (1, 768,
   64/8 heads of 128), causal; bf16 and fp32 against the plain version,
   timed in bf16 beside it and SDPA, with the bound.
3. Drive the port's main path at full ``smollm-360m`` width with random
   weights from seed 0: a paged ``ServeEngine`` with both kernels serves
   16 greedy requests (prompts 16-512, budgets 32-64), every decode step a
   replay of the CUDA graph its engine captured (``core.aot``).  First a
   graph check: 8 decode steps of 8 busy lanes two ways, the eager program
   on a deep clone of the state and the graph on the state itself; the
   tokens and every state leaf must be bitwise equal.  It runs twice:
   greedy, and sampled with a temperature, top-k and top-p (the
   stochastic, masked graph, drawing from its registered generator).  After the measured
   run the engine's program cache must hold one decode program and one
   prefill per prompt bucket, the engine one decode graph, and both stay
   flat while it serves four of the requests again (``builds``,
   ``cache_hits``, ``executables``, ``graphs`` printed).
   The launch counts
   must equal 32 x prefills (flash), 32 x decode steps (paged), 33 x
   (prefills + decode steps) (rmsnorm: ``ln1`` of each layer, ``ln_f``)
   and 32 x (prefills + decode steps) (rmsnorm_add: ``ln2`` with the
   residual add before it); the
   kernel path's prefill and first decode-step logits must agree with the
   ``chunked``/``ref`` path's (fp32 with TF32 off, and bf16); a few
   requests also run on the slotted layout.  The profiled decode step
   (a replay and the token fetch) gives launches, device ms and idle
   share, beside the host ms of one replay and the launches and device ms
   of the eager program it replays; the port's kernels in the profiled
   replays must equal, wrapper by wrapper, the launches the graph adds to
   the wrappers' counters on each replay (the counters the launch-count
   gates read).
3b. The paged engine's scheduling features on phase 3's engine
   (``feature_requests``: eight prompts share a 320-token prefix, seven
   with 16-192 tokens of their own and one the bare prefix; eight random
   prompts of 16-512 tokens; budgets 32-64): ``prefill_chunk`` 128, the
   prefix cache and ``admission="preempt"`` on 96 usable blocks, every
   program built first (``prebuild``).  Every request must end ``ok`` with
   its budget; ``check_invariants`` after every step; more chunks than
   prefills, and prefix hits, COW copies, preemptions, resumes and
   replayed tokens; one decode graph and builds flat; launches as the
   engine's counters predict (flash 32 per chunk that starts at 0, paged
   32 per decode step, the norms per chunk and step).  Prints tokens/s,
   the decode step's median and p90, a first and a continuation chunk's
   host and device ms and idle share (``profile_chunk``), a prefix-hit
   admission against the same prompt's miss (``prefix_hit_ms``), peak
   memory.
3c. Preempt admission alone (no chunks, no prefix cache, 96 blocks) on
   phase 3's requests: preemptions fire and every stream equals phase
   3's bitwise (the resumes re-prefill through the same bucket program and
   replay through decode).
3d. One 512-token prompt's last-position logits on the kernel path, four
   chunks of 128 and a 320-position prefix plus one continuation, within
   ``LOGIT_TOL`` of the plain path's whole-bucket prefill's largest logit
   in fp32 (TF32 off); bf16 printed.
3e. Phase 3b's engine under a seeded ``FaultPlan`` (seed 0, rate 0.05 at
   the four engine sites), ``max_retries`` 2 and a deadline of 60 engine
   steps (a ``StepClock``) on four requests: every request ends in a
   status, invariants after every step, faults injected, builds flat, and
   every ``ok`` stream equals phase 3b's bitwise (retries recompute).
3f. Phase 3c's engine with the host-RAM tier (``host_tier=True``) on phase
   3's requests: every stream phase 3's bitwise; lanes spill and restore
   (the counters ``TIER_3F``, a smoke-width CPU rehearsal's, exactly); a
   resume the tier restores is not prefilled again: flash launches 32 x
   prefills, prefills 16 plus the resumes the tier could not restore,
   replayed tokens only theirs; one decode graph, builds flat (the
   transport is prebuilt).  The tier logs each lane spill's and restore's
   blocks; after the run the transport alone is timed at each of those
   sizes (host ms, bytes and GB/s each way, a read and a write from rows
   of one buffer and one block a copy) beside a plain pinned ``copy_`` of
   the same bytes; tokens/s beside 3c's, measured the same way.
3g. Phase 3b's engine with a tier of ``TIER_3G_BLOCKS`` block units:
   reclaimed prefix blocks spill, later admissions promote them back, lanes
   restore (``TIER_3G`` exactly).  After every step each block promoted in
   it must hold, bitwise, the payload the tier kept for it.  The requests
   that re-admit on a promoted chain (``TIER_3G_PROMOTED``) restart their
   prefill where it ends, inside the first chunk, where 3b restarted at 0:
   each stream must equal, bitwise, a tierless engine's whose device cache
   holds the same chain (``prefix_witness``); every other stream is 3b's
   bitwise.  Tokens/s beside 3b's.
3h. Phase 3's engine with a tier and ``park_idle_s`` on a StepClock: a
   lane held and released in place (no restore, no spill), a lane held
   past the threshold (it parks, its lane refills, its release restores
   with no replay), ``save_snapshot`` mid-run and ``restore_snapshot``
   into a fresh engine sharing the program cache (drained there: every
   stream phase 3's), two requests exported to a third engine sharing
   cache and tier (the moved lane restores by copy there); every stream
   phase 3's bitwise, launches as the three engines' counters predict,
   builds flat, one graph each.
3i. Phase 3's engine with ``fused_sampling=False`` (the programs return the
   logits, the host samples): greedy streams phase 3's bitwise, one decode
   graph, launches as the counters predict; tokens/s and the decode step
   beside phase 3's, and the logits bytes fetched per step.
3j. Phase 3's engine with speculative decoding (``SPEC_K`` 3; the draft
   is the same config, its weights moved ``DRAFT_ALPHA`` 0.15 toward an
   init from seed 1): every round is one replay of the spec graph (k + 1
   draft steps and the k + 1 verify steps); 8 rounds run the eager spec
   program on a deep clone beside the replay on the state, rows and every
   leaf bitwise equal; every stream equals phase 3's bitwise; builds 1 spec
   program and a prefill and a draft prefill per bucket, flat on a second
   serve, one spec graph; launches and counter identities as predicted
   (``spec_launches``, ``spec_identities``). Prints tokens/s beside phase
   3's, the acceptance rate and tokens a lane a round, a profiled round
   (launches, device ms, idle share, one replay's host ms) and its
   breakdown (a draft step, a verify step, rollback; ``spec_breakdown``).
3k. 3f's engine with speculation: preemptions land mid-round and each
   resume restores by copy and rebuilds the draft by one draft prefill; 0
   replayed tokens; streams phase 3's bitwise.
3l. 3b's engine with speculation, invariants after every step (rejected
   writes never land in a shared block): every request ``ok``; a request
   whose prefills start where they started in 3b gives 3b's stream, one
   whose start moved its ``prefix_witness``'s.
3m. The router front-end: ``ROUTER_REPLICAS`` (3) replicas of phase 3's
   engine behind ``serve.Router`` (one program cache, one weight copy:
   the replicas beyond the first add their KV pools and no weight bytes,
   against a router of one), phase 3's requests driven tick by tick on a
   step clock under ``ROUTER_SCRIPT``: replica 1 drained at tick 4 and
   reinstated at 6, replica 2 killed at 8, replica 1 stalled at 12 until
   the health check (``stall_budget`` 3) declares it dead; replica 0
   finishes alone.  Every request ``ok`` with its budget and every stream
   phase 3's bitwise; ``check_invariants`` after every tick; the router's
   and each replica's counters exactly ``ROUTER_3M`` and
   ``ROUTER_3M_REPLICAS`` (a smoke-width CPU rehearsal's); builds flat
   after ``prebuild`` plus one graph capture per replica that decoded,
   counted on both caches; launches as the replicas' counters predict.
   Prints tokens/s beside phase 3's.
3n. Phase 3's engine and traffic again with the full observer (tracer and
   flight recorder): streams bitwise phase 3's, phase 3's launches, builds
   flat, one graph; ``validate`` passes on the trace with one ``submit``
   and one ``terminal`` a request, written as a Chrome trace and JSONL
   under ``build/chip_smoke/``; the profiled decode step (traced) launches
   the port's kernels phase 3's did.  Then the launcher's ``main`` in
   process (``--replicas 2 --drain-at 4 --requests 8 --trace-out``):
   every request ``ok``, a valid trace.  Prints the traced and untraced
   decode-step host medians (not gated).
3o. Phase 3's model and requests through ``ServeEngine(mesh=)`` on a
   ``(1, 1)`` mesh of one-rank NCCL groups, both layouts: streams bitwise
   the mesh-less engine's, launches by phase 3's formulas (the paged
   decode's through the block-range entry), the collectives of a decode
   step, a prefill and the run by ``serve_collectives`` (the data axis's
   logit gather and partial merge included), KV bytes a rank; the paged
   decode step profiled; the launcher's ``--mesh single``.
3p. The engine's features on 3o's ``(1, 1)`` mesh of one-rank NCCL groups
   (``mesh_features_path``), phase 3's model and requests: 3f's tier
   engine (``TIER_3F`` exactly), 3h's hold, park, ``save_snapshot``/
   ``restore_snapshot`` (rank 0 writes, a barrier, every rank reads) and
   two exports into a second mesh engine sharing the tier, 3j's spec
   engine on both layouts (the first 8 requests; the round one graph
   holding the draft's and
   the target's mesh programs, 8 replays bitwise the eager round on a deep
   clone, the round's collectives by ``spec_collectives``,
   ``spec_identities``) and 3k's spec-plus-tier run; every stream bitwise
   the mesh-less phase's (phase 3's; 3o's mesh-less slotted run's for the
   slotted spec engine), launches by ``mesh_feature_launches`` (the paged
   decode through ``paged_attention_range``).  Prints tokens/s beside 3f's
   and 3j's and a profiled spec round beside 3j's.
4. Train full-width ``smollm-360m`` (seed 0, bf16 compute, both kernels)
   over a 1-rank NCCL group at seq 1024, global batch 8, 2 slices, remat:
   the faithful program for 3 steps and ZeRO for 2 (6 and 3 until phases
   13-15 joined the script's time limit), through
   ``train.loop.train``.  Losses must be finite, and batch 0's loss after
   the faithful run below step 1's (on the same batch); the launch
   counts must equal ``steps`` (flat_adam), ``2 x 32 x 2 x steps``
   (flash: forward and remat's recompute, per slice), ``(2 x 32 + 1) x 2
   x steps`` (rmsnorm: ``ln1`` twice a layer, ``ln_f``) and ``2 x 32 x 2 x
   steps`` (rmsnorm_add); step 1's loss and
   grad norm on the kernel path must agree with the plain path's (fp32
   with TF32 off, and bf16); a step on inf-poisoned parameters must be a
   bitwise no-op in both programs; a checkpoint must round-trip bitwise.
   Prints step time (median, p90), tokens/s, peak memory and a profiled
   step's device-busy time and idle share (every profile also lists the
   port's own kernels with their device time).
5. Serve full-width ``zamba2-1.2b`` (seed-0 weights, bf16, slotted, 8
   lanes, max_len 1024, ``attn_impl="kernel"``): 16 greedy requests with
   phase 3's prompt lengths and budgets, ``check_invariants`` (recurrent
   zeroing of free lanes included) after every step, decode steps as
   graph replays with phase 3's graph check and build counts before and
   after the run.  Every request must
   end ``ok`` with its full budget; the launch counts must equal 38 x
   prefills (ssd), 7 x prefills (flash), 7 x (prefills + decode steps)
   (rmsnorm_add), 46 x (prefills + decode steps) (rmsnorm: 7 shared
   ``ln1``, 38 Mamba2 ``ln``, ``ln_f``) and 38 x (prefills + decode
   steps) (rmsnorm_gated: each Mamba2 out-norm with its skip and gate).
   At full width, from the same
   inputs, the kernel path's shared block and Mamba2 block (prefill at
   bucket 512 and decode) must agree with the ``chunked`` path's within
   ``BLOCK_TOL`` (fp32 with TF32 off, and bf16), and the whole model's
   prefill and first decode-step logits within ``LOGIT_TOL`` in fp32; in
   bf16 the whole model's logit error is printed and not gated (see
   ``zamba_logit_agreement``: with random weights one bf16 rounding moves
   this model's logits by O(1)), so bf16 is gated block by block only.
   Prints tokens/s (wall time without the invariant sweeps), decode step
   median and p90, prefill ms at bucket 512, peak memory, a profiled
   decode step's idle share, and a profiled kernel-path prefill at bucket
   512: device ms, idle share, launches, the top device kernels and the
   SSD kernels' share of the device time.
5b. Phase 5's engine and requests again; after 8 decode steps the host
   ``preempt()``s the last two occupied lanes.  Their resumes re-prefill
   (flash, ssd, the norms) and replay; every stream must equal phase 5's
   bitwise, with invariants after every step and the launches 18
   prefills and the decode steps predict.
5c. Phase 5's engine with a host tier: a lane held after 4 decode steps
   (a hybrid lane spills at once: its KV segment and recurrent leaves,
   ~99.5 MB) and released 3 steps later (restored by copy), then 5b's two
   preemptions, whose resumes restore by copy: 16 prefills (ssd 38 x 16),
   no replayed token, every stream phase 5's bitwise, the recurrent-zero
   sweep after every step.  Prints the release's host ms, and the lane
   transport alone after the run (a read and a write, host ms and GB/s)
   beside a plain pinned ``copy_`` of the same bytes.
5d. Phase 5's engine with speculation (a zamba draft moved
   ``ZAMBA_DRAFT_ALPHA`` 0.02) and 5b's two preemptions mid-round: both
   sides roll recurrent state back through snapshot buffers allocated once
   (their bytes printed); the spec graph check; streams phase 5's bitwise;
   the draft's dead recurrent lanes zero after every round; builds flat;
   launches as predicted; the profiled round and its breakdown.
5m. Phase 5's model, requests and engine on a ``(1, 1)`` mesh of
   one-rank NCCL groups (``ServeEngine(mesh=)``, ``zamba_mesh_serve``):
   the weights' shards, the shared block's heads and the Mamba2
   projections on the serving mesh program, every head of each Mamba2
   block on the rank, the cache ``zamba.cache_pspec``'s.  Gates: streams
   bitwise phase 5's, the invariants after every step, the launches
   phase 5's formulas (no split entry: serving keeps the whole-row gated
   norm), the collectives by ``zamba_serve_collectives``, the KV bytes
   phase 5's, one decode graph.  Prints tokens/s, the decode step's host
   median and a profiled decode step's device ms, idle share and
   launches.
6. The function API (``repro_torch.core``) on the card, one worker
   (``fork()``): (a) the paper's Appendix A program (``examples/
   synk_sgd.py`` in the port's API: a CNN trained by ``synk.function`` on
   ``synk.data`` with ``batch=`` indices and ``all_reduce(..., "avg")``,
   10 epochs) must reach a train accuracy above 0.4; (b) full-width
   ``smollm-360m`` (fp32, TF32 off, ``attn_impl="kernel"``) loss and
   gradients through ``synk.function(loss_and_grads, [Scatter,
   Broadcast], (Reduce("mean"), Reduce("mean")))`` on 8 rows of 256
   tokens read by ``batch=`` global ids from a ``scatter_data`` corpus on
   the card: ``num_slices`` 1 and 2 against a direct ``lm.loss_fn`` and
   autograd on the same rows, loss within 1e-5 and gradient norm within
   1e-4 (relative); the flash and RMSNorm launches per call equal their
   formulas; one build per signature and resident parameters skipped.
7. Full-width ``gemma2-27b`` (46 layers, bf16 weights from seed 0 made
   in bf16, ``attn_impl="kernel"``) through the paged engine (page 16,
   ``max_len`` 8192, 8 lanes, ``GEMMA_BLOCKS`` 1,025 blocks: 6.18 GB of
   KV) on phase 3's 16 requests plus two prompts of 4,500-5,000 tokens
   (budget 64), longer than the local layers' window of 4,096.  Memory
   from earlier phases is freed first (``memory_allocated`` printed).
   Gates: every request ``ok`` with its full budget; 8 graph replays
   bitwise the eager program; after ``prebuild`` the builds are the three
   decode forms and a prefill per bucket, flat through the run, one decode
   graph; launches flash 46 a prefill, paged 46 and ``rmsnorm`` 139 /
   ``rmsnorm_add`` 46 a decode step and a prefill (ln1, the post-norms
   ln1b and ln2b, ln_f; ln2 with its residual add); a profiled decode
   step's port kernels equal the graph's counts; kernel-path logits
   within 1e-1 of the largest |logit| of the plain path's (chunked, paged
   ref) on one long prompt's prefill and 4 decode steps, and within 1e-3
   in fp32 (TF32 off) at full width and 4 layers (the full-depth fp32
   model does not fit one card).  Prints tokens/s, decode step median and
   p90 host ms, the profiled decode step's launches, device ms and idle
   share beside its bound (the weights and the attended KV over 3.35
   TB/s), the long prefill's device ms beside its bound, and peak memory
   beside the weights and pool.  Then the same traffic on a fresh engine:
   the same streams.
8. Full-width ``stablelm-12b`` (40 layers, head dim 160 at rep 4, 24.3 GB
   of bf16 weights from seed 0) through phase 7's engine settings
   (``STABLELM_BLOCKS`` 1,025 blocks: 3.36 GB of KV) and traffic: phase
   7's gates (graph, builds, launches flash 40 a prefill, paged 40 a
   decode step, ``rmsnorm`` 41 and ``rmsnorm_add`` 40 a prefill and a
   decode step, logits in bf16 at full depth and in fp32 at 4 layers, a
   second run's streams), the same prints.
9. Full-width ``qwen3-moe-30b-a3b`` (48 layers, 128 experts top-8, head
   dim 128 at rep 8, ~61 GB of bf16 weights) through the paged engine at
   phase 3's settings and traffic (the pool cut to 8 lanes of 1,024: 513
   blocks), after the earlier models are freed: phase 8's gates, with
   ``rmsnorm`` 145 (``ln1``, the q and k norms, ``ln_f``) a prefill and a
   decode step; prints each prefill's ``drop_frac`` (the largest of its
   layers, recomputed at its bucket) and the decode step's bound, which
   reads every expert (the (E, C) layout computes all 128 experts' slots).
10. ``xlstm-1.3b`` at full width, 8 of its 48 layers (``XLSTM_LAYERS``:
   its first segment, 7 mLSTM blocks and the sLSTM block, d_model 2,048, 4
   heads; bf16 weights from seed 0 made in bf16; 48 layers until phase 3p
   joined the script's time limit) through the slotted engine (8 lanes,
   max_len 1,024) on phase 3's traffic, every decode step a
   graph replay: phase 7's gates (``serve_phase``: full budgets, 8 replays
   bitwise the eager program, builds flat after ``prebuild``,
   ``check_invariants`` with the recurrent-zero sweep after every step, a
   second run's streams, the launches: ``rmsnorm`` 2 x 8 + 1 a prefill
   and a decode step, each block's ``ln`` and ``out_ln`` and ``ln_f``, and
   no other kernel); logits, kernel path against plain, on a prefill and 4
   decode steps: fp32 (TF32 off) within ``LOGIT_TOL`` on the first segment
   (``XLSTM_FP32_LAYERS``, 8), bf16 and fp32 at the phase's depth printed
   and not gated (``xlstm_logits``: random weights amplify the norms' last-bit
   differences), and the first mLSTM and sLSTM blocks (prefill and 8
   decode lanes) within ``BLOCK_TOL`` in both dtypes.  Prints tokens/s, the
   profiled decode step's launches, device ms and idle share beside its
   bytes bound (the weights, the state read and written), a bucket-512
   prefill's host and device ms (the sLSTM's Python loop makes it
   host-bound), peak memory.
11. ``whisper-tiny`` uncut (4 + 4 layers, d_model 384, 1,500 frames) on
   ``generate_static``: batch 8, prompts of 32 tokens, frames (8, 1500,
   384) from seed 0, 64 new tokens.  Gates: flash 12 (3 x 4: encoder,
   decoder self, cross) and the norms per prefill and decode step
   (``whisper_launches``), a second run's streams, logits kernel against
   plain on the prefill and 4 decode steps within ``LOGIT_TOL`` (bf16;
   fp32 with TF32 off).  Prints tokens/s and the prefill's device ms
   beside its bound.
12. ``internvl2-76b`` at full width, 16 of its 80 layers (~31.6 GB of bf16
   weights; 80 layers, ~141 GB, fit no card), on ``generate_static``:
   batch 4, patch embeddings (4, 256, 3200) and 128-token prompts from seed
   0, 32 new tokens from position 384.  Gates: flash 16 a prefill, the
   norms (``vlm_launches``), a second run's streams, logits within
   ``LOGIT_TOL`` in bf16 at 16 layers and fp32 at 2.  Prints tokens/s, the
   prefill's device ms beside its bound (operations), peak memory.
13. Train full-width ``zamba2-1.2b`` uncut (38 layers, ~1.2 x 10^9 fp32
   parameters, bf16 compute, ``attn_impl="kernel"``) over a 1-rank NCCL
   group through the faithful flat program: seq 1024, global batch 4 in 2
   slices, remat, Adam, 4 steps.  Gates: finite losses and no skipped
   step; batch 0's loss after the run below step 1's; the launches
   ``ZT_STEPS`` (flat_adam), ``2 x 38 x 2 x steps`` (ssd and rmsnorm_gated:
   forward and remat's recompute; the backward recomputes through the
   plain versions), ``7 x 2 x steps`` (flash and rmsnorm_add: the shared
   block, not rematted) and ``(2 x 38 + 7 + 1) x 2 x steps`` (rmsnorm); a
   step on inf-poisoned parameters a bitwise no-op; a checkpoint round
   trip; step 1 against the plain path (``attn_impl="chunked"``: plain
   scan, norms and attention, plain Adam) in fp32 with TF32 off, loss
   within 1e-4 and the gradient's norm within 1e-3 relative, on the first
   segment (6 layers; the full depth printed).  Prints the step's host ms
   (median, p90), tokens/s, peak memory, and a profiled step's device ms,
   idle share and launches beside its bound; then times ``flat_adam`` at
   the model's flat buffer beside its plain version and
   ``torch.optim.Adam(fused=True)`` on buffers of that size.
14. Train ``qwen3-moe-30b-a3b`` at full width and 2 of its 48 layers (~1.9 x
   10^9 fp32 parameters) on the per-parameter path (the moe family's, as
   the reference's) under FSDP, the launcher's default rules, over the
   1-rank NCCL group (every layer's weights gathered in bf16, again in
   remat's recompute, every gradient reduce-scattered), with its
   load-balance term: seq 512, global batch 4 in 2 slices, 3 steps, after
   every earlier model is freed.  First step 1 of the replicated rules and
   then of FSDP from the same init and batch (each freed before the next):
   loss and gradient norm bitwise equal (the parameters' bit digests
   printed).  Gates: finite losses, batch 0's loss falling, no flat_adam
   launch, flash ``2 x 2 x 2 x steps`` and the norms by formula, the
   gathers and reduce-scatters by formula (``fsdp_collectives``),
   ``lb_loss`` finite and ``drop_frac`` in [0, 1] each step (printed), step
   1 against the plain path in fp32 (loss 1e-4, gradient norm 1e-3
   relative).  Prints phase 13's figures and ``bytes_per_rank`` of the
   48-layer model at 1, 4 and 8 ranks.  Then a third run, the trainer's
   model axis: the same init under ``ShardRules.for_mesh`` of a ``(data 1,
   model 1)`` mesh over 1-rank NCCL subgroups, phase 14's 3 steps (the
   tensor-, sequence- and expert-parallel program: local heads, the
   sequence-sharded residual stream, the rank's experts, the
   vocab-parallel loss), freed before 14b.  Gates: step 1's loss, gradient
   norm and parameter digests bitwise the FSDP rules'; finite losses,
   batch 0's loss falling; flash, ``rmsnorm`` and ``rmsnorm_add`` by phase
   14's formulas and no flat_adam; the FSDP gathers and the model-axis
   collectives by formula (``mesh_collectives``).  Prints its host median
   and a profiled step's device ms and idle share beside phase 14's, and
   ``bytes_per_rank`` of the 48-layer model at ``(8, 1)``, ``(4, 2)`` and
   ``(2, 4)`` and of ``qwen3-moe-235b-a22b`` on the production ``(16,
   16)`` mesh (meta tensors).
14b. ``zamba2-1.2b`` at full width, its first segment (6 layers, one
   shared-block invocation), 2 steps of the default settings (the
   per-parameter path under FSDP, 1-rank NCCL group), phase 13's shape:
   the ``ssd`` kernel and its autograd Function under gathered weights.
   Gates: step 1 of the replicated rules and of FSDP bitwise equal, as in
   phase 14; finite losses, batch 0's loss falling; the launches by phase
   13's formulas at 6 layers (``ssd`` ``2 x 6 x 2 x steps``) and no
   flat_adam; the collectives by formula.  Then (14m) the same init under
   ``ShardRules.for_mesh`` of a ``(1, 1)`` mesh (``sp`` off, as the
   reference's launcher sets it for the hybrid family: the Mamba2 heads
   split over ``model``, the gated out-norm through the split entry and
   its row sums all-reduced), phase 14b's 2 steps: step 1's loss,
   gradient norm and parameter digests bitwise FSDP's; the launches
   (``rmsnorm_gated_split`` 2 x 2 x 6 x 2 x steps, no ``rmsnorm_gated``)
   and the collectives by formula (``mesh_collectives``); a profiled
   step.
15. Train ``whisper-tiny`` uncut (frames from ``SyntheticEmbeds``) and
   ``xlstm-1.3b`` at full width and 8 of 48 layers (7 mLSTM, 1 sLSTM)
   through the faithful program, seq 256, global batch 4 in 2 slices, 2
   steps each.  Gates: finite losses, batch 0's loss falling, one flat_adam
   launch a step.  Prints step times.
16. Print the launches, device ms and idle share of the profiled dense,
   zamba, gemma2, stablelm, qwen3-moe and xlstm decode steps and zamba and
   xlstm prefills
   (the spec rounds' print with their phases), the seconds of each phase, the
   card's name and power limit, one
   ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
   {...}}``.  Details go to ``results.json`` in ``OUT_DIR``.

It imports nothing of JAX or of the reference package, and exits non-zero
without a CUDA card or outside the repository.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import re
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
OUT_DIR = HERE / "chiprun_out" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet, dense): bytes and operations per second
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": dict(atol=1e-3, rtol=1e-2), "float32": dict(atol=3e-5, rtol=3e-5)}
# full-width logits, kernel path vs chunked/ref path, as a share of the
# largest |logit|: fp32 differs only in attention's summation order (~1e-7
# per op, grown through 32 layers); bf16 in where attention outputs round
LOGIT_TOL = {"float32": 1e-3, "bfloat16": 1e-1}

# flat Adam: kernel vs plain version, fp32 (see the docstring)
ADAM_TOL = dict(atol=1e-6, rtol=1e-6)
ADAM_N_FULL = 361_821_184      # the full smollm-360m flat buffer (padded to 512)
# flash gradient (recompute through chunked_attention) vs autograd through
# attention_ref.  fp32: the same sums in another order, over up to 1024
# keys.  bf16: the recompute casts each 128-row chunk of k and v to fp32
# on its own, so dk and dv arrive as 8 bf16-rounded partial sums added in
# bf16, where attention_ref rounds one fp32 sum once: up to ~8 half-ulps
# (2**-9 each) of the partial sums' size, taken as 2% of the tensor's
# largest entry ("scale") plus 1% of each entry
GRAD_TOL = {"bfloat16": dict(scale=2e-2, rtol=1e-2), "float32": dict(atol=1e-5, rtol=1e-4)}
# step 1, kernel path vs plain path (flash + flat_adam vs chunked + plain
# Adam), relative: fp32 differs only in attention's summation order through
# 32 layers; bf16 in where attention outputs round
STEP_TOL = {"float32": dict(loss=1e-5, grad_norm=1e-3),
            "bfloat16": dict(loss=1e-2, grad_norm=5e-2)}
TRAIN_SEQ, TRAIN_BATCH, TRAIN_SLICES = 1024, 8, 2
# phase 4 trains smollm-360m at full width and half its depth (16 of 32
# layers): its step is some 14 full steps of host dispatch, the script's
# longest phase, cut to pay for phase 3o
TRAIN_LAYERS = 16
# flash timing shapes (name, B, S, H, Hk, D, window), bf16, causal: a
# smollm-360m prefill at bucket 512, the training step's (batch 4 a slice,
# seq 1024), a zamba2-1.2b shared-block prefill at bucket 512 (rep 1), a
# gemma2-27b prefill at bucket 512 and its long local-layer prefill at
# bucket 8192 (window 4096), a stablelm-12b prefill (head dim 160) at
# bucket 512 and at S 4096, and the train slices of phases 13 (zamba2-1.2b's
# shared block, 2 x 1024) and 14 (qwen3-moe-30b-a3b, 2 x 512, rep 8)
FLASH_TIMING = (("serve", 1, 512, 15, 5, 64, 0), ("train", 4, 1024, 15, 5, 64, 0),
                ("zamba", 1, 512, 32, 32, 64, 0), ("gemma2 serve", 1, 512, 32, 16, 128, 0),
                ("gemma2 long", 1, 8192, 32, 16, 128, 4096),
                ("stablelm serve", 1, 512, 32, 8, 160, 0),
                ("stablelm long", 1, 4096, 32, 8, 160, 0),
                ("zamba train", 2, 1024, 32, 32, 64, 0),
                ("qwen3-moe train", 2, 512, 32, 4, 128, 0))
SMOLLM_VOCAB = 49152

N_LAYERS = 32
PAGE = 16
MAX_LEN = 1024
MAX_SLOTS = 8

# the SSD scan's fp32 outputs, kernel vs plain: a share of the tensor's
# largest entry plus a share of each entry (see the docstring, 2d)
SSD_TOL = dict(scale=1e-4, rtol=1e-4)
SSD_SHAPE = (1, 512, 64, 64, 1, 64)        # B, T, H, P, G, N: a zamba2 prefill
# the scan under grad (kernel forward, plain recompute backward) vs autograd
# through the plain scan: y and the state within SSD_TOL, the gradients
# bitwise (the backward is the plain scan's autograd on the same inputs)
SSD_GRAD_SHAPES = ((1, 512), (2, 1024))    # (B, T): a zamba2 prefill, a train slice
# one full-width block, kernel path vs plain path, as a share of the
# output's largest entry (see zamba_block_agreement)
BLOCK_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ZAMBA_LAYERS, ZAMBA_SHARED = 38, 7
# phase 7: full-width gemma2-27b on the paged engine
GEMMA_LAYERS = 46
GEMMA_MAX_LEN = 8192
GEMMA_BLOCKS = 1025           # 1,024 usable blocks of 16: 6.18 GB of bf16 KV
GEMMA_LONG = (4500, 5001)     # the two long prompts' lengths are drawn from [lo, hi)
GEMMA_LONG_BUDGET = 64
GEMMA_WINDOW = 4096
GEMMA_SOFTCAP = 50.0
GEMMA_FP32_LAYERS = 4         # the fp32 logit check's depth: two (local, global) pairs
GEMMA_LOGIT_STEPS = 4         # decode steps of phase 7's logit check
# phase 2's head-dim-128 cases: gemma2-27b's (q heads, KV heads) and
# deepseek-67b's; flash at S 1024 and at S 4608, past the window; paged
# lanes on both sides of the window (the last stale) in tables of 8192
D128_HEADS = ((32, 16), (64, 8))
FLASH_D128_S = (1024, 4608)
PAGED_D128_LENGTHS = (4000, 4095, 4096, 4097, 4700, 6000, 8191, 100)
# phase 2's head-dim-160 and rep-16 cases: stablelm-12b's (q heads, KV
# heads); flash at a bucket-512 prefill, a ragged S, and S 4608 past a
# window of 4096; paged (rep, D, KV heads): stablelm-12b's decode,
# qwen3-moe-235b-a22b's (64 q heads over 4 KV heads) and the largest
# instantiation
D160_HEADS = (32, 8)
FLASH_D160_S = (512, 300, 4608)
PAGED_WIDE = ((4, 160, 8), (16, 128, 4), (16, 160, 4))
# phase 8: full-width stablelm-12b on the paged engine, phase 7's traffic
STABLELM_LAYERS = 40
STABLELM_MAX_LEN = 8192
STABLELM_BLOCKS = 1025        # 1,024 usable blocks of 16: 3.36 GB of bf16 KV
STABLELM_FP32_LAYERS = 4
# phase 9: full-width qwen3-moe-30b-a3b on the paged engine, phase 3's
# traffic
MOE_LAYERS = 48
MOE_FP32_LAYERS = 4
# phase 10: xlstm-1.3b at full width and 8 of its 48 layers (its first
# segment: 7 mLSTM, 1 sLSTM) on the slotted engine
XLSTM_LAYERS = 8
XLSTM_PREFILL = 512           # the profiled prefill's prompt (bucket 512)
# the fp32 logit gate's depth: one segment of slstm_every = 8 (7 mLSTM
# blocks, then the sLSTM block); at full depth random weights amplify fp32
# summation order past LOGIT_TOL (see xlstm_logits)
XLSTM_FP32_LAYERS = 8
# phase 11: whisper-tiny (uncut: 4 encoder and 4 decoder layers) on the
# static loop
WHISPER_LAYERS = 4
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW = 8, 32, 64
# phase 12: internvl2-76b at full width on the static loop, 16 of its 80
# layers (80 layers are ~141 GB of bf16 weights: no card holds them)
VLM_LAYERS = 16
VLM_FP32_LAYERS = 2
VLM_BATCH, VLM_PROMPT, VLM_NEW = 4, 128, 32
FRONTEND_LOGIT_STEPS = 4      # decode steps of phases 10-12's logit checks
# phase 2f's flash cases (name, B, Sq, Sk, H, Hk, D, causal): whisper-tiny's
# encoder self-attention over 1,500 frames (a ragged last key tile of 28
# rows) and its prefill cross-attention (32 prompt tokens over the frames),
# both non-causal, batch 8; an internvl2-76b prefill (256 image and 512 text
# positions, 64/8 heads of 128), causal
FLASH_FRONTEND = (("whisper encoder", 8, 1500, 1500, 6, 6, 64, False),
                  ("whisper cross", 8, 32, 1500, 6, 6, 64, False),
                  ("vlm prefill", 1, 768, 768, 64, 8, 128, True))
ZAMBA_D_INNER, ZAMBA_HEAD_DIM = 4096, 64
# the RMSNorm shapes (rows, width) of the main paths and the path that
# gives each: smollm-360m's d_model (960) in a decode step of 8 lanes, a
# prefill at bucket 512 and a training slice (4 x 1024 tokens); zamba2's
# and xlstm-1.3b's d_model (2048) in a decode step and a bucket-512
# prefill; 4096 at the same rows, zamba2's d_inner (the gated out-norm's)
# and xlstm's mLSTM out-norm (rmsnorm; no path calls rmsnorm_add that
# wide); gemma2-27b's d_model (4608) in a decode step and a bucket-512
# prefill; stablelm-12b's d_model (5120) in the same two; qwen3-moe-30b-a3b's
# q-norm (head dim 128, 32 heads a row of d_model) in a decode step (8 x 32
# rows) and a bucket-512 prefill (its d_model, 2048, is zamba2's);
# whisper-tiny's d_model (384) in a decode step of 8 rows and its encoder
# prefill (8 x 1,500 frames); internvl2-76b's d_model (8192, the kernel's
# widest) in a decode step and phase 12's prefill (4 x 384 positions); the
# train slices of phases 13 and 14 (2 x 1,024 and 2 x 512 x 32 heads of 128)
RMSNORM_PATHS = {(8, 960): "dense decode", (512, 960): "dense prefill",
                 (4096, 960): "dense train", (8, 4608): "gemma2 decode",
                 (512, 4608): "gemma2 prefill", (8, 2048): "zamba and xlstm decode",
                 (512, 2048): "zamba and xlstm prefill",
                 (8, 4096): "zamba decode (gated), xlstm decode (mLSTM out-norm)",
                 (512, 4096): "zamba prefill (gated), xlstm prefill (mLSTM out-norm)",
                 (8, 5120): "stablelm decode",
                 (512, 5120): "stablelm prefill", (256, 128): "qwen3-moe decode q-norm",
                 (16384, 128): "qwen3-moe prefill q-norm", (8, 384): "whisper decode",
                 (12000, 384): "whisper encoder prefill", (8, 8192): "internvl2 decode",
                 (1536, 8192): "internvl2 prefill",
                 (2048, 2048): "zamba and qwen3-moe train slice",
                 (2048, 4096): "zamba train slice (gated)",
                 (32768, 128): "qwen3-moe train slice q-norm"}
RMSNORM_SHAPES = tuple(RMSNORM_PATHS)
# 2e times each call on inputs that are not in the card's 50 MB L2: the
# timed calls rotate through copies of the inputs that hold at least this
# many bytes together
COLD_BYTES = 128 << 20


def log(*a):
    print(*a, flush=True)


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(torch, fn, iters: int = 50) -> tuple[float | None, dict]:
    """Device time per call -- every kernel ``fn`` launches, summed over
    ``iters`` calls by ``torch.profiler``, over ``iters`` -- and {kernel
    name: {calls, ms} per call}.  For calls of a few microseconds back-to-back
    CUDA events measure the host's launch path instead; None where the
    profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        # the record of a window of a few hundred microseconds has come
        # back empty (once, a window of 50 calls of a 2-microsecond kernel)
        # or short (once, 33 of 200 launches of one): the window is
        # measured again, up to twice, while a kernel's launches are not a
        # whole number per call to within the first launches the record
        # can miss (see kernels_per_call)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        if evs and all(abs(e.count - iters * max(1, round(e.count / iters)))
                       <= max(1, iters // 50) for e in evs):
            break
    names = {e.key[:100]: dict(calls=e.count / iters, ms=e.self_device_time_total / 1e3 / iters)
             for e in evs}
    return (sum(e.self_device_time_total for e in evs) / 1e3 / iters if evs else None), names


def kernels_per_call(kernels: dict) -> int:
    """Device kernels one call launches, from ``device_profile``'s {name:
    {calls}}: each kernel's calls per call rounded to a whole launch, since
    the profiler's record can miss the first launches of its window (seen:
    one call of 50-200, 0.98-0.99 calls a call)."""
    return sum(round(v["calls"]) for v in kernels.values())


def device_ms(torch, fn, iters: int = 50) -> float | None:
    return device_profile(torch, fn, iters)[0]


def host_us(torch, fn, calls: int = 1000) -> float:
    """Host microseconds per call: ``calls`` back-to-back calls timed by
    ``perf_counter`` with one synchronize at the end (the device keeps up,
    so this is the wrapper's share of a host-bound step)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / calls * 1e6


def max_err(torch, got, want, dt: str, tol: dict | None = None) -> float:
    """Max |got - want|; raises unless |got - want| <= atol + rtol |want|
    (``tol``, default ``TOL[dt]``)."""
    tol = tol or TOL[dt]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    lim = tol["atol"] + tol["rtol"] * w.abs()
    if not bool(torch.isfinite(g).all()) or bool((err > lim).any()):
        raise AssertionError(f"max error {err.max().item():.3e} over tolerance {tol}")
    return err.max().item()


def bound(flops: float, nbytes: float, dt: str) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_flash(torch, dev, results):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    H, Hk, D = 15, 5, 64
    cases = [(S, dict(causal=True)) for S in (16, 128, 512, 1024)]
    cases += [(128, dict(causal=False)), (512, dict(causal=True, window=256)),
              (1024, dict(causal=True, window=256)), (512, dict(causal=True, softcap=30.0)),
              (1024, dict(causal=True, window=100, softcap=30.0))]
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for S, kw in cases:
        for dt in ("bfloat16", "float32"):
            q, k, v = (torch.randn(1, S, h, D, generator=gen, device=dev).to(getattr(torch, dt))
                       for h in (H, Hk, Hk))
            out = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 **kw).transpose(1, 2)
            err = max_err(torch, out, want, dt)
            row = dict(S=S, dtype=dt, **kw, max_abs_err=err)
            rows.append(row)
            log(f"flash {json.dumps(row)}")
    # head dim 128: gemma2-27b's heads (32/16) and deepseek-67b's (64/8),
    # causal, gemma2's local window at its edge, its softcap, and both
    short, long = FLASH_D128_S
    w, cap = dict(window=GEMMA_WINDOW), dict(softcap=GEMMA_SOFTCAP)
    for H, Hk in D128_HEADS:
        for S, kw in ((short, dict(causal=True)), (long, dict(causal=True, **w)),
                      (short, dict(causal=True, **cap)), (long, dict(causal=True, **w, **cap))):
            for dt in ("bfloat16", "float32"):
                q, k, v = (torch.randn(1, S, h, 128, generator=gen, device=dev)
                           .to(getattr(torch, dt)) for h in (H, Hk, Hk))
                out = flash_attention(q, k, v, **kw)
                torch.cuda.synchronize()
                want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                     **kw).transpose(1, 2)
                row = dict(S=S, D=128, H=H, Hk=Hk, dtype=dt, **kw,
                           max_abs_err=max_err(torch, out, want, dt))
                rows.append(row)
                log(f"flash {json.dumps(row)}")
                del q, k, v, out, want
    # head dim 160 (the tail panel): stablelm-12b's heads (32/8), causal at a
    # bucket-512 prefill and a ragged S, a window of 4096 at its edge, a
    # softcap of 50, and both
    H, Hk = D160_HEADS
    s512, ragged, long = FLASH_D160_S
    for S, kw in ((s512, dict(causal=True)), (ragged, dict(causal=True)),
                  (long, dict(causal=True, **w)), (s512, dict(causal=True, **cap)),
                  (long, dict(causal=True, **w, **cap))):
        for dt in ("bfloat16", "float32"):
            q, k, v = (torch.randn(1, S, h, 160, generator=gen, device=dev)
                       .to(getattr(torch, dt)) for h in (H, Hk, Hk))
            out = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 **kw).transpose(1, 2)
            row = dict(S=S, D=160, H=H, Hk=Hk, dtype=dt, **kw,
                       max_abs_err=max_err(torch, out, want, dt))
            rows.append(row)
            log(f"flash {json.dumps(row)}")
            del q, k, v, out, want
    results["flash_cases"] = rows

    # timing, bf16, causal, at the main paths' shapes: device time per call
    # from the profiler (ms), back-to-back CUDA events beside it
    # (ms_events); SDPA, which the port never calls, as the yardstick (with
    # a boolean band mask where the row has a window)
    timings = []
    for name, B, S, H, Hk, D, window in FLASH_TIMING:
        dt = "bfloat16"
        q, k, v = (torch.randn(B, S, h, D, generator=gen, device=dev).to(torch.bfloat16)
                   for h in (H, Hk, Hk))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        qc, kc, vc = (x.contiguous() for x in (qt, kt, vt))
        kernel = lambda: flash_attention(q, k, v, causal=True, window=window)
        plain = lambda: attention_ref(qt, kt, vt, causal=True, window=window)
        if window:
            # a band mask with GQA: the KV heads expanded outside the timed
            # call, so SDPA's memory-efficient kernel (which takes a mask)
            # can run it
            i = torch.arange(S, device=dev)
            band = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
            ke, ve = (x.repeat_interleave(H // Hk, dim=1) for x in (kc, vc))
            lib = lambda: F.scaled_dot_product_attention(qc, ke, ve, attn_mask=band)
        else:
            lib = lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                                         enable_gqa=True)
        out = kernel()
        torch.cuda.synchronize()
        want = plain().transpose(1, 2)
        # causal (query, key) pairs, within the window where there is one
        w = window or S
        pairs = B * sum(min(i + 1, w) for i in range(S))
        row = dict(shape=name, q=[B, S, H, D], kv=[B, S, Hk, D], dtype=dt, causal=True,
                   window=window, max_abs_err=max_err(torch, out, want, dt),
                   library_max_abs_err=(lib().transpose(1, 2).float() - want.float()).abs().max().item())
        row["bound_ms"], row["bound_by"] = bound(4 * D * H * pairs,
                                                 2 * B * S * D * (2 * H + 2 * Hk), dt)
        iters = 200 if B * S <= 512 else 50
        row["ms"], kernels = device_profile(torch, kernel, 50 if S <= 1024 else 10)
        row["device_kernels_per_call"] = kernels_per_call(kernels)
        row["plain_ms"] = device_ms(torch, plain, 20 if S <= 1024 else 3)
        row["library_ms"], row["library_kernels"] = device_profile(
            torch, lib, 50 if S <= 1024 else 10)
        row["vs_library"] = row["ms"] / row["library_ms"] if row["ms"] and row["library_ms"] else None
        row["ms_events"] = time_ms(torch, kernel, iters if S <= 1024 else 10)
        row["plain_ms_events"] = time_ms(torch, plain, 20 if S <= 1024 else 3)
        row["library_ms_events"] = time_ms(torch, lib, iters if S <= 1024 else 10)
        if name.startswith("gemma2") or name.startswith("stablelm"):
            # gemma2's own setting, the attention softcap (SDPA has none);
            # stablelm has none, and its row carries it for the kernel's cost
            row["ms_softcap"] = device_ms(torch, lambda: flash_attention(
                q, k, v, causal=True, window=window, softcap=GEMMA_SOFTCAP),
                50 if S <= 1024 else 10)
        if name == "serve":
            row["host_us_per_call"] = host_us(torch, kernel)
        timings.append(row)
        log(f"flash timing {json.dumps(row)}")
        del q, k, v, qc, kc, vc, out, want
    results["flash_timing"] = timings


def paged_inputs(torch, dev, dt, *, layers=1, B=MAX_SLOTS, Hk=5, rep=3, D=64, nb=MAX_LEN // PAGE,
                 nulled=(6, 7), seed=2, lengths=None):
    """Pools for ``layers`` layers, ragged lengths 1..1023 (or ``lengths``)
    and a random block mapping; lanes in ``nulled`` are stale (table rows
    all sink)."""
    rng = np.random.default_rng(seed)
    NB = B * nb + 1
    if lengths is None:
        lengths = rng.integers(1, nb * PAGE, B).astype(np.int32)
        lengths[0], lengths[1] = 1, nb * PAGE - 1
    lengths = np.asarray(lengths, np.int32)
    tables = np.zeros((B, nb), np.int32)
    free = list(rng.permutation(np.arange(1, NB)))
    for b in range(B):
        if b not in nulled:
            for j in range(int(lengths[b]) // PAGE + 1):
                tables[b, j] = free.pop()
    gen = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(getattr(torch, dt))
    q = mk(B, Hk, rep, D)
    kp, vp = mk(layers, NB, PAGE, Hk, D), mk(layers, NB, PAGE, Hk, D)
    return (q, kp, vp, torch.tensor(lengths, device=dev), torch.tensor(tables, device=dev))


def attended(lengths, window: int = 0) -> np.ndarray:
    """Positions each lane attends: [0, length], or the last ``window`` of
    them."""
    n = np.asarray(lengths, np.int64) + 1
    return np.minimum(n, window) if window else n


def pool_positions_read(lengths, tables, bs: int, window: int = 0) -> int:
    """Distinct pool positions (block, offset) a decode step must read: each
    lane's positions [0, length] (with a window, those above length -
    window) through its table row.  A position mapped by several lanes, as
    the sink block 0 is by every stale lane, counts once."""
    need = np.zeros((int(tables.max()) + 1, bs), bool)
    for length, row in zip(lengths, tables):
        length = int(length)
        first = length - window + 1 if window else 0
        for p in range(max(first, 0), min(length + 1, row.size * bs)):
            need[row[p // bs], p % bs] = True
    return int(need.sum())


def check_paged(torch, dev, results):
    from repro_torch.kernels.paged_attention.ops import (DEVICE_KERNELS, paged_attention,
                                                         split_plan)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    rows = []
    for kw in (dict(), dict(window=256), dict(softcap=30.0), dict(window=100, softcap=30.0)):
        for dt in ("bfloat16", "float32"):
            q, kp, vp, lengths, tables = paged_inputs(torch, dev, dt)
            out = paged_attention(q, kp[0], vp[0], lengths, tables, **kw)
            torch.cuda.synchronize()
            want = paged_attention_ref(q, kp[0], vp[0], lengths, tables, **kw)
            row = dict(dtype=dt, **kw, max_abs_err=max_err(torch, out, want, dt))
            rows.append(row)
            log(f"paged {json.dumps(row)}")
    # head dim 128 at gemma2's rep 2 (16 KV heads) and deepseek's rep 8 (8),
    # tables of max_len 8192, lanes on both sides of gemma2's window
    lens = PAGED_D128_LENGTHS
    for H, Hk in D128_HEADS:
        rep = H // Hk
        for kw in (dict(), dict(softcap=GEMMA_SOFTCAP),
                   dict(window=GEMMA_WINDOW, softcap=GEMMA_SOFTCAP)):
            for dt in ("bfloat16", "float32"):
                q, kp, vp, lengths, tables = paged_inputs(
                    torch, dev, dt, Hk=Hk, rep=rep, D=128, nb=GEMMA_MAX_LEN // PAGE,
                    lengths=lens, nulled=(7,))
                out = paged_attention(q, kp[0], vp[0], lengths, tables, **kw)
                torch.cuda.synchronize()
                want = paged_attention_ref(q, kp[0], vp[0], lengths, tables, **kw)
                row = dict(dtype=dt, D=128, Hk=Hk, rep=rep, lengths=lens, **kw,
                           max_abs_err=max_err(torch, out, want, dt))
                rows.append(row)
                log(f"paged {json.dumps(row)}")
                del q, kp, vp, out, want
    # head dim 160 and rep 16 (``PAGED_WIDE``), tables of 8192, at random
    # lengths and at phase 8's (phase 7's traffic, ~10 tokens in)
    phase8 = [int(p.size) + 10 for p, _ in gemma2_requests(SMOLLM_VOCAB)[:MAX_SLOTS]]
    for rep, D, Hk in PAGED_WIDE:
        for lens in (None, phase8):
            for kw in (dict(), dict(softcap=GEMMA_SOFTCAP),
                       dict(window=GEMMA_WINDOW, softcap=GEMMA_SOFTCAP)):
                for dt in ("bfloat16", "float32"):
                    q, kp, vp, lengths, tables = paged_inputs(
                        torch, dev, dt, Hk=Hk, rep=rep, D=D, nb=STABLELM_MAX_LEN // PAGE,
                        lengths=lens, nulled=() if lens else (6, 7), seed=5)
                    out = paged_attention(q, kp[0], vp[0], lengths, tables, **kw)
                    torch.cuda.synchronize()
                    want = paged_attention_ref(q, kp[0], vp[0], lengths, tables, **kw)
                    row = dict(dtype=dt, D=D, Hk=Hk, rep=rep, lengths=lengths.tolist(), **kw,
                               max_abs_err=max_err(torch, out, want, dt))
                    rows.append(row)
                    log(f"paged {json.dumps(row)}")
                    del q, kp, vp, out, want
    # a head run of a wider pool (``paged_heads``): a rank of a model axis
    # whose q heads read one run of a replicated pool's kv heads, as
    # qwen3-moe-30b-a3b's 2 local q heads read 1 of its 4 at a model axis
    # of 16; the pool's views, rows 4 heads apart
    phase3 = [int(p.size) + 10 for p, _ in requests(SMOLLM_VOCAB)[:MAX_SLOTS]]
    for h in (0, 3):
        for kw in (dict(), dict(window=100, softcap=30.0)):
            for dt in ("bfloat16", "float32"):
                q, kp, vp, lengths, tables = paged_inputs(
                    torch, dev, dt, Hk=4, rep=2, D=128, nb=MAX_LEN // PAGE, lengths=phase3)
                q, kr, vr = q[:, h:h + 1].contiguous(), kp[0].narrow(2, h, 1), vp[0].narrow(2, h, 1)
                out = paged_attention(q, kr, vr, lengths, tables, **kw)
                torch.cuda.synchronize()
                want = paged_attention_ref(q, kr.contiguous(), vr.contiguous(), lengths, tables,
                                           **kw)
                row = dict(dtype=dt, D=128, Hk=1, pool_heads=4, head=h, rep=2,
                           lengths=lengths.tolist(), **kw,
                           max_abs_err=max_err(torch, out, want, dt))
                rows.append(row)
                log(f"paged head run {json.dumps(row)}")
                del q, kp, vp, kr, vr, out, want
    results["paged_cases"] = rows
    # timing at the decode step's shape: 8 lanes, 5 KV heads x 3 queries,
    # bs 16, bf16; 8 layers of pools (84 MB, over the 50 MB L2) walked in
    # turn, so each launch finds its pool cold, as a layer's does in
    # decode.  Lengths: random 1..1023 (two lanes stale), and phase 3's own
    # (its profiled decode steps: the first 8 prompts, ~10 tokens in).
    # Phase 7's rows: gemma2-27b's decode (16 KV heads x 2 queries, D 128,
    # tables of 512 blocks) at the lengths of phase 7's profiled steps (its
    # first 8 requests: the two long prompts and six short ones, ~10 tokens
    # in), as a local layer calls it (window 4096, softcap 50) and a global
    # one (softcap 50); 8 layers of pools (4.3 GB) walked in turn.
    dt = "bfloat16"
    L = 8
    phase3 = [int(p.size) + 10 for p, _ in requests(SMOLLM_VOCAB)[:MAX_SLOTS]]
    phase7 = [int(p.size) + 10 for p, _ in gemma2_requests(SMOLLM_VOCAB)[:MAX_SLOTS]]
    gemma = dict(Hk=16, rep=2, D=128, nb=GEMMA_MAX_LEN // PAGE)
    wide = {f"rep {rep} D {D}": dict(Hk=Hk, rep=rep, D=D, nb=STABLELM_MAX_LEN // PAGE)
            for rep, D, Hk in PAGED_WIDE}
    timings = []
    # phase 8 calls the D-160 rep-4 shape at phase 7's lengths (its
    # traffic); phase 9 the D-128 rep-8 shape (qwen3-moe-30b-a3b's 32/4
    # heads) at phase 3's; the rep-16 shapes at phase 3's lengths
    for name, lens, nulled, shape, kw in (
            ("random", None, (6, 7), {}, {}), ("phase 3", phase3, (), {}, {}),
            ("phase 7 local", phase7, (), gemma,
             dict(window=GEMMA_WINDOW, softcap=GEMMA_SOFTCAP)),
            ("phase 7 global", phase7, (), gemma, dict(softcap=GEMMA_SOFTCAP)),
            ("phase 8", phase7, (), wide["rep 4 D 160"], {}),
            ("phase 9", phase3, (), dict(Hk=4, rep=8, D=128, nb=MAX_LEN // PAGE), {}),
            ("rep 16 D 128", phase3, (), wide["rep 16 D 128"], {}),
            ("rep 16 D 160", phase3, (), wide["rep 16 D 160"], {}),
            ("head run", phase3, (), dict(Hk=4, rep=2, D=128, nb=MAX_LEN // PAGE), {})):
        q, kp, vp, lengths, tables = paged_inputs(torch, dev, dt, layers=L, lengths=lens,
                                                  nulled=nulled, **shape)
        if name == "head run":
            # head 1 of 4: the kernel reads one kv head's rows of each block
            q, kp, vp = q[:, 1:2].contiguous(), kp.narrow(3, 1, 1), vp.narrow(3, 1, 1)
        B, Hk, rep, D = q.shape
        window = kw.get("window", 0)
        n = attended(lengths.cpu().numpy(), window)   # positions attended per lane
        esize = q.element_size()
        read = pool_positions_read(lengths.cpu().numpy(), tables.cpu().numpy(), PAGE, window)
        nbytes = (read * Hk * D * 2 + 2 * q.numel()) * esize \
            + 4 * (lengths.numel() + tables.numel())
        bps, n_split = split_plan(tables.shape[1], PAGE)
        row = dict(lengths_from=name, dtype=dt, lanes=B, q=list(q.shape), lengths=lengths.tolist(),
                   **kw, nulled_lanes=list(nulled), pool_positions_read=read,
                   positions_attended=int(n.sum()), blocks_per_split=bps, n_split=n_split,
                   split_ctas=B * Hk * n_split)
        row["bound_ms"], row["bound_by"] = bound(4 * D * rep * Hk * int(n.sum()), nbytes, dt)
        out = paged_attention(q, kp[0], vp[0], lengths, tables, **kw)
        torch.cuda.synchronize()
        row["max_abs_err"] = max_err(torch, out, paged_attention_ref(q, kp[0], vp[0], lengths,
                                                                     tables, **kw), dt)
        i = [0]

        def step(fn):
            def go():
                layer = i[0] % L
                i[0] += 1
                return fn(q, kp[layer], vp[layer], lengths, tables, **kw)
            return go

        row["ms"], kernels = device_profile(torch, step(paged_attention), 200)
        row["device_kernels"] = kernels
        row["device_kernels_per_call"] = kernels_per_call(kernels)
        assert row["device_kernels_per_call"] == DEVICE_KERNELS, kernels
        row["plain_ms"] = device_ms(torch, step(paged_attention_ref), 20)
        row["ms_events"] = time_ms(torch, step(paged_attention), 400)
        row["plain_ms_events"] = time_ms(torch, step(paged_attention_ref), 100)
        row["library_ms"] = None
        if name == "random":
            row["host_us_per_call"] = host_us(torch, step(paged_attention))
        timings.append(row)
        log(f"paged timing {json.dumps(row)}")
        del q, kp, vp, out
    results["paged_timing"] = timings
    check_paged_block_range(torch, dev, results)


# the block-range gate's shapes: phase 3's decode (D 64, 5 kv heads x 3) and
# qwen3-moe-30b-a3b's (D 128, 4 x 8), at phase 3's lengths, tables of 64
BLOCK_RANGE_SHAPES = (("D 64", dict(Hk=5, rep=3, D=64)), ("D 128 rep 8", dict(Hk=4, rep=8, D=128)))


def halves(NB: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """Two data ranks' shares ``(lo, n)`` of a pool of ``NB`` blocks."""
    return (0, NB // 2), (NB // 2, NB - NB // 2)


def positions_in(lengths, tables, bs: int, lo: int, n: int) -> tuple[int, int]:
    """``(distinct pool positions read, positions attended)`` of a decode
    step whose lanes attend only the entries of blocks ``[lo, lo + n)``."""
    need = np.zeros((int(tables.max()) + 1, bs), bool)
    attended = 0
    for length, row in zip(lengths, tables):
        for p in range(min(int(length) + 1, row.size * bs)):
            blk = row[p // bs]
            if lo <= blk < lo + n:
                need[blk, p % bs] = True
                attended += 1
    return int(need.sum()), attended


def check_paged_block_range(torch, dev, results):
    """Phase 2's gate of the paged kernel's block-range entry (a data rank's
    share of the pool): the pool's blocks split into two halves
    (``pool.narrow(0, lo, n)``, views), the kernel launched on each with
    its ``block_lo`` and the ``(m, l)`` output, the halves merged by the
    port's LSE combine (``attention.combine_partials``, fp32 partials
    rounded once), held against the whole pool's launch and against
    ``ref.py`` within ``TOL``; the entry over the full range, rounded to
    q's dtype, bitwise the plain entry.  Then each half's call
    timed (profiler and events, 8 layers of pools walked in turn), its
    bound the bytes the half reads."""
    from repro_torch.kernels.paged_attention.ops import (DEVICE_KERNELS, paged_attention,
                                                         paged_attention_range)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models.attention import combine_partials

    phase3 = [int(p.size) + 10 for p, _ in requests(SMOLLM_VOCAB)[:MAX_SLOTS]]
    rows, timings = [], []
    for name, shape in BLOCK_RANGE_SHAPES:
        for kw in (dict(), dict(window=100, softcap=30.0)):
            for dt in ("bfloat16", "float32"):
                q, kp, vp, lengths, tables = paged_inputs(torch, dev, dt, lengths=phase3,
                                                          nulled=(), **shape)
                k0, v0 = kp[0], vp[0]
                whole = paged_attention(q, k0, v0, lengths, tables, **kw)
                full = paged_attention_range(q, k0, v0, lengths, tables, block_lo=0, **kw)
                parts = [paged_attention_range(q, k0.narrow(0, lo, n), v0.narrow(0, lo, n),
                                               lengths, tables, block_lo=lo, **kw)
                         for lo, n in halves(k0.shape[0])]
                merged = combine_partials(*(list(x) for x in zip(*parts)), q.dtype)
                torch.cuda.synchronize()
                row = dict(shape=name, dtype=dt, q=list(q.shape), **kw,
                           halves=[list(h) for h in halves(k0.shape[0])],
                           full_range_bitwise=bool(torch.equal(full[0].to(q.dtype), whole)),
                           max_abs_err_vs_whole=max_err(torch, merged, whole, dt),
                           max_abs_err=max_err(torch, merged, paged_attention_ref(
                               q, k0, v0, lengths, tables, **kw), dt))
                rows.append(row)
                log(f"paged block range {json.dumps(row)}")
                assert row["full_range_bitwise"], row
                del q, kp, vp, whole, full, parts, merged
    results["paged_block_range_cases"] = rows
    dt, L = "bfloat16", 8
    for name, shape in BLOCK_RANGE_SHAPES:
        q, kp, vp, lengths, tables = paged_inputs(torch, dev, dt, layers=L, lengths=phase3,
                                                  nulled=(), **shape)
        B, Hk, rep, D = q.shape
        NB = kp.shape[1]
        esize = q.element_size()
        for half, (lo, n) in enumerate(halves(NB)):
            read, attended = positions_in(lengths.cpu().numpy(), tables.cpu().numpy(), PAGE,
                                          lo, n)
            # the half's K and V rows and q read, the fp32 partial and its
            # (m, l) written, the lengths and tables read
            nbytes = (read * Hk * D * 2 + q.numel()) * esize + 4 * (
                q.numel() + lengths.numel() + tables.numel() + 2 * B * Hk * rep)
            row = dict(shape=name, dtype=dt, q=list(q.shape), half=half, blocks=[lo, n],
                       lengths=lengths.tolist(), pool_positions_read=read,
                       positions_attended=attended)
            row["bound_ms"], row["bound_by"] = bound(4 * D * rep * Hk * attended, nbytes, dt)
            i = [0]

            def step(fn, lo=lo, n=n, **extra):
                def go():
                    layer = i[0] % L
                    i[0] += 1
                    return fn(q, kp[layer].narrow(0, lo, n), vp[layer].narrow(0, lo, n),
                              lengths, tables, block_lo=lo, **extra)
                return go

            row["ms"], kernels = device_profile(torch, step(paged_attention_range), 200)
            row["device_kernels_per_call"] = kernels_per_call(kernels)
            assert row["device_kernels_per_call"] == DEVICE_KERNELS, kernels
            plain = step(paged_attention_ref, with_lse=True)
            row["plain_ms"] = device_ms(torch, plain, 20)
            row["ms_events"] = time_ms(torch, step(paged_attention_range), 400)
            row["plain_ms_events"] = time_ms(torch, plain, 100)
            row["library_ms"] = None
            timings.append(row)
            log(f"paged block range timing {json.dumps(row)}")
        del q, kp, vp
    results["paged_block_range_timing"] = timings


ADAM_HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8)


def adam_inputs(torch, gen, n):
    """Flat fp32 p, g, m and v of n elements on the generator's device."""
    dev = gen.device
    p = torch.randn(n, generator=gen, device=dev) * 0.05
    g = torch.randn(n, generator=gen, device=dev) * 1e-2
    m = torch.randn(n, generator=gen, device=dev) * 1e-3
    v = torch.rand(n, generator=gen, device=dev) * 1e-4
    return p, g, m, v


def adam_timing(torch, bufs) -> dict:
    """The flat_adam kernel, its plain version and torch's fused Adam (a
    yardstick the port never calls) on the same flat buffers, at step 1000
    and wd 0, by CUDA events, beside the bytes bound."""
    from repro_torch.kernels.flat_adam.ops import flat_adam
    from repro_torch.kernels.flat_adam.ref import flat_adam_ref

    n = bufs[0].numel()
    dev = bufs[0].device
    step = torch.tensor([1000], dtype=torch.int32, device=dev)
    timing = dict(n=n, t=1000, wd=0.0, dtype="float32")
    timing["bound_ms"], timing["bound_by"] = bound(14.0 * n, 28.0 * n, "float32")   # 14 flops, 28 bytes an element
    timing["kernel_ms"] = time_ms(torch, lambda: flat_adam(*bufs, step, **ADAM_HYPER), 20)
    timing["plain_ms"] = time_ms(torch, lambda: flat_adam_ref(*bufs, step, **ADAM_HYPER), 5)
    # torch's fused Adam (its L2 weight decay differs from the decoupled
    # form; with wd = 0 it is the same function), in place
    p, g, m, v = bufs
    w = torch.nn.Parameter(p.clone())
    w.grad = g
    lib = torch.optim.Adam([w], lr=ADAM_HYPER["lr"], betas=(0.9, 0.95), eps=1e-8,
                           weight_decay=0.0, fused=True)
    timing["library_ms"] = time_ms(torch, lib.step, 20)
    timing["library"] = "torch.optim.Adam(fused=True), wd 0: the same function"
    log(f"flat_adam timing {json.dumps(timing)}")
    return timing


def check_flat_adam(torch, dev, results):
    """flat_adam kernel vs its plain version over n, t, wd; times at the
    full flat buffer (kernel, plain, and torch's fused Adam as yardstick)."""
    from repro_torch.kernels.flat_adam.ops import flat_adam
    from repro_torch.kernels.flat_adam.ref import flat_adam_ref

    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for n in (512, 65_537, ADAM_N_FULL):
        bufs = adam_inputs(torch, gen, n)
        for t in (1, 1000):
            step = torch.tensor([t], dtype=torch.int32, device=dev)
            for wd in (0.0, 0.1):
                got = flat_adam(*bufs, step, weight_decay=wd, **ADAM_HYPER)
                torch.cuda.synchronize()
                want = flat_adam_ref(*bufs, step, weight_decay=wd, **ADAM_HYPER)
                err = max(max_err(torch, a, b, "float32", ADAM_TOL) for a, b in zip(got, want))
                rows.append(dict(n=n, t=t, wd=wd, max_abs_err=err))
                log(f"flat_adam {json.dumps(rows[-1])}")
                del got, want
        if n == ADAM_N_FULL:
            results["flat_adam_timing"] = adam_timing(torch, bufs)
    results["flat_adam_cases"] = rows


def check_flash_grad(torch, dev, results):
    """The flash Function's dq, dk, dv (recompute through chunked_attention)
    against autograd through attention_ref."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    B, S, H, Hk, D = 4, 1024, 15, 5, 64
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for dt in ("bfloat16", "float32"):
        q, k, v = (torch.randn(B, S, h, D, generator=gen, device=dev).to(getattr(torch, dt))
                   for h in (H, Hk, Hk))
        dout = torch.randn(B, S, H, D, generator=gen, device=dev).to(q.dtype)
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        flash_attention(*xs, causal=True).backward(dout)
        ys = [x.clone().requires_grad_() for x in (q, k, v)]
        ref = attention_ref(*(y.transpose(1, 2) for y in ys), causal=True).transpose(1, 2)
        ref.backward(dout)
        torch.cuda.synchronize()
        row = dict(dtype=dt, q=[B, S, H, D], kv=[B, S, Hk, D], tol=GRAD_TOL[dt])
        tols = {}
        for name, x, y in zip(("dq", "dk", "dv"), xs, ys):
            tol = dict(GRAD_TOL[dt])
            if "scale" in tol:
                tol["atol"] = tol.pop("scale") * y.grad.float().abs().max().item()
            row[name + "_max_abs"] = y.grad.float().abs().max().item()
            row[name + "_max_abs_err"] = (x.grad.float() - y.grad.float()).abs().max().item()
            tols[name] = tol
        rows.append(row)
        log(f"flash grad {json.dumps(row)}")
        for name, x, y in zip(("dq", "dk", "dv"), xs, ys):
            max_err(torch, x.grad, y.grad, dt, tols[name])
        del xs, ys, ref
    results["flash_grad"] = rows


def ssd_inputs(torch, dev, dt, B, T, H, P, G, N, seed):
    """x, B and C as views into one (B, T, H*P + 2*G*N) buffer, as the
    Mamba2 block passes them (strided, not contiguous), plus dt and A."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randn(B, T, H * P + 2 * G * N, generator=gen, device=dev).to(getattr(torch, dt))
    x, bm, cm = torch.split(buf, [H * P, G * N, G * N], dim=-1)
    d = torch.rand(B, T, H, generator=gen, device=dev) * 0.19 + 0.01
    A = -(torch.rand(H, generator=gen, device=dev) * 1.5 + 0.5)
    return x.reshape(B, T, H, P), d, A, bm.reshape(B, T, G, N), cm.reshape(B, T, G, N)


def ssd_bound(B, T, H, P, G, N, esize):
    """(flops, bytes) of the scan as a function, not as any blocking of it:
    each input read once and y (fp32) and the state written once; per
    position and head the recurrence needs N*P FMAs to read C.S and N*P
    to inject B x (dt.x), 2 flops an FMA."""
    fma = 2 * N * P * B * T * H
    nbytes = (B * T * H * P * esize + B * T * H * 4 + H * 4 + 2 * B * T * G * N * esize
              + B * T * H * P * 4 + B * H * N * P * 4)
    return 2.0 * fma, nbytes


def check_ssd(torch, dev, results):
    """The SSD scan kernel vs its plain version (``ssd_chunked``)."""
    from repro_torch.kernels.ssd.ops import ssd, ssd_fwd
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    def tol_for(want):
        return dict(atol=SSD_TOL["scale"] * want.abs().max().item(), rtol=SSD_TOL["rtol"])

    B, T, H, P, G, N = SSD_SHAPE
    rows = []
    for T_ in (T, 300, 37):
        for dt in ("float32", "bfloat16"):
            args = ssd_inputs(torch, dev, dt, B, T_, H, P, G, N, seed=T_)
            y, st = ssd(*args, chunk=256)
            torch.cuda.synchronize()
            wy, ws = ssd_chunked_ref(*args, chunk=256, return_state=True)
            row = dict(x=[B, T_, H, P], N=N, G=G, input_dtype=dt, tol=SSD_TOL,
                       max_abs_err=max(max_err(torch, y, wy, "float32", tol_for(wy)),
                                       max_err(torch, st, ws, "float32", tol_for(ws))),
                       y_max_abs=wy.abs().max().item(), state_max_abs=ws.abs().max().item())
            rows.append(row)
            log(f"ssd {json.dumps(row)}")
    # the TPU kernel's layout and output type
    t = lambda a: a.transpose(1, 2).contiguous()
    x, d, A, bm, cm = (t(a) if a.dim() > 1 else a
                       for a in ssd_inputs(torch, dev, "bfloat16", B, T, H, P, G, N, seed=9))
    y = ssd_fwd(x, d, A, bm, cm)
    torch.cuda.synchronize()
    tt = lambda a: a.transpose(1, 2)
    want = tt(ssd_chunked_ref(tt(x), tt(d), A, tt(bm), tt(cm), chunk=256)).to(torch.bfloat16)
    rows.append(dict(layout="(B, H, T, P) -> bf16", x=[B, H, T, P],
                     max_abs_err=max_err(torch, y, want, "bfloat16")))
    log(f"ssd {json.dumps(rows[-1])}")

    results["ssd_cases"] = rows
    results["ssd_timing"] = ssd_timing(torch, dev, T, plain_iters=20, host=True)
    results["ssd_timing_2048"] = ssd_timing(torch, dev, 2048, plain_iters=5)
    # the zamba2 train step's call: a slice of 2 sequences of 1,024
    results["ssd_timing_train"] = ssd_timing(torch, dev, ZT_SEQ, B=ZT_BATCH // ZT_SLICES,
                                             plain_iters=10)
    results["ssd_grad"] = ssd_grad(torch, dev)


def ssd_leaves(torch, dev, dt, B, T, H, P, G, N, seed):
    """Leaves that require grad: one (B, T, H*P + 2*G*N) buffer whose views
    are x, B and C (as the Mamba2 block hands them over), dt and A."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randn(B, T, H * P + 2 * G * N, generator=gen, device=dev).to(getattr(torch, dt))
    d = torch.rand(B, T, H, generator=gen, device=dev) * 0.19 + 0.01
    A = -(torch.rand(H, generator=gen, device=dev) * 1.5 + 0.5)
    return [t.requires_grad_() for t in (buf, d, A)]


def ssd_views(torch, leaves, H, P, G, N):
    buf, d, A = leaves
    B, T = buf.shape[:2]
    x, bm, cm = torch.split(buf, [H * P, G * N, G * N], dim=-1)
    return x.reshape(B, T, H, P), d, A, bm.reshape(B, T, G, N), cm.reshape(B, T, G, N)


def ssd_grad(torch, dev) -> dict:
    """The ``ssd`` wrapper under grad (the kernel's forward; the backward
    recomputes through ``ssd_chunked``) against autograd through
    ``ssd_chunked_ref``, at zamba2's heads and chunk, fp32 and bf16, at a
    prefill and at the train step's slice (``SSD_GRAD_SHAPES``): y and the
    final state within ``SSD_TOL`` (the kernel's forward at the train
    step's shape), and the gradients for x, B and C (through the buffer
    they are views of), dt and A bitwise, since the backward is the plain
    scan's own.  Then the device ms of the zamba2 train call's backward
    beside its forward's, and the plain forward's and backward's."""
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    _, _, H, P, G, N = SSD_SHAPE
    kernel = lambda *a: ssd(*a, chunk=256)
    plain = lambda *a: ssd_chunked_ref(*a, chunk=256, return_state=True)
    rows = []
    for B, T in SSD_GRAD_SHAPES:
        for dt in ("float32", "bfloat16"):
            dy = torch.randn(B, T, H, P, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(T))
            outs, grads = [], []
            for fn in (kernel, plain):
                leaves = ssd_leaves(torch, dev, dt, B, T, H, P, G, N, seed=B * T)
                y, state = fn(*ssd_views(torch, leaves, H, P, G, N))
                assert y.grad_fn is not None and state.grad_fn is not None
                outs.append((y.detach(), state.detach()))
                grads.append(torch.autograd.grad([y], leaves, [dy]))
            torch.cuda.synchronize()
            row = dict(x=[B, T, H, P], N=N, G=G, input_dtype=dt, tol=SSD_TOL, grad_tol=0.0)
            for name, got, want in zip(("y", "state"), *outs):
                row[name + "_max_abs"] = want.abs().max().item()
                row[name + "_max_abs_err"] = max_err(
                    torch, got, want, "float32",
                    dict(atol=SSD_TOL["scale"] * row[name + "_max_abs"], rtol=SSD_TOL["rtol"]))
            for name, got, want in zip(("d_xbc", "d_dt", "d_A"), *grads):
                row[name + "_max_abs"] = want.float().abs().max().item()
                row[name + "_max_abs_err"] = max_err(torch, got, want, dt,
                                                     dict(atol=0.0, rtol=0.0))
            rows.append(row)
            log(f"ssd grad {json.dumps(row)}")
            del outs, grads, dy
    B, T = ZT_BATCH // ZT_SLICES, ZT_SEQ
    leaves = ssd_leaves(torch, dev, "bfloat16", B, T, H, P, G, N, seed=1)
    args = ssd_views(torch, leaves, H, P, G, N)
    dy = torch.randn(B, T, H, P, device=dev)
    y, _ = kernel(*args)
    yp, _ = plain(*args)
    with torch.no_grad():
        fwd = lambda: kernel(*args)
        plain_fwd = lambda: plain(*args)
        timing = dict(x=[B, T, H, P], input_dtype="bfloat16", forward_ms=device_ms(torch, fwd),
                      plain_forward_ms=device_ms(torch, plain_fwd, 10))
    timing["backward_ms"] = device_ms(
        torch, lambda: torch.autograd.grad([y], leaves, [dy], retain_graph=True), 10)
    timing["plain_backward_ms"] = device_ms(
        torch, lambda: torch.autograd.grad([yp], leaves, [dy], retain_graph=True), 10)
    log(f"ssd grad timing {json.dumps(timing)}")
    return dict(cases=rows, timing=timing)


def ssd_timing(torch, dev, T, *, B: int = SSD_SHAPE[0], plain_iters: int,
               host: bool = False) -> dict:
    """Kernel and plain version at x (B, T, 64, 64) bf16 by device time per
    call, the kernel's device kernels by name, the blocks of each of its
    passes, and both bounds: the fp32 FMA pipes' (the first design's) and the
    bf16 tensor cores' (bytes at these shapes), the row's own."""
    from repro_torch.kernels.ssd.ops import ssd, ssd_plan
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    _, _, H, P, G, N = SSD_SHAPE
    args = ssd_inputs(torch, dev, "bfloat16", B, T, H, P, G, N, seed=1)
    timing = dict(x=[B, T, H, P], N=N, G=G, input_dtype="bfloat16", output="y, state fp32",
                  blocks=ssd_plan(B, T, H, N, P)["blocks"])
    flops, nbytes = ssd_bound(B, T, H, P, G, N, 2)
    timing.update(flops=flops, bytes=nbytes)
    timing["bound_fma_ms"], timing["bound_fma_by"] = bound(flops, nbytes, "float32")
    timing["bound_ms"], timing["bound_by"] = bound(flops, nbytes, "bfloat16")
    kernel = lambda: ssd(*args, chunk=256)
    plain = lambda: ssd_chunked_ref(*args, chunk=256, return_state=True)
    timing["ms"], names = device_profile(torch, kernel)
    timing["device_kernels"] = {k: v for k, v in names.items() if PORT_KERNEL.match(k)}
    timing["device_kernels_per_call"] = kernels_per_call(timing["device_kernels"])
    assert timing["device_kernels_per_call"] == 3, timing["device_kernels"]   # the three passes
    timing["plain_ms"] = device_ms(torch, plain, plain_iters)
    timing["ms_events"] = time_ms(torch, kernel, 100)
    timing["plain_ms_events"] = time_ms(torch, plain, plain_iters)
    timing["library_ms"] = None
    if host:
        timing["host_us_per_call"] = host_us(torch, kernel)
    log(f"ssd timing {json.dumps(timing)}")
    return timing


def check_rmsnorm(torch, dev, results):
    """The RMSNorm kernel's three entries vs their plain versions, bf16 and
    fp32 (``TOL``; the new residual of ``rmsnorm_add`` bitwise), at the
    main paths' shapes (``RMSNORM_PATHS``); the gated form on views into
    zamba2's projections as the Mamba2 block passes them.  Timed in bf16
    beside the plain versions and ``F.rms_norm`` (weight ``1 + gamma`` in
    x's dtype: the same function up to that weight's rounding), L2-cold
    (``COLD_BYTES``) and warm (one set of inputs, resident in L2 across
    calls), with each wrapper's host microseconds beside its plain
    chain's."""
    import itertools

    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.ops import plan, rmsnorm, rmsnorm_add, rmsnorm_gated
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_add_ref, rmsnorm_gated_ref, rmsnorm_ref

    def rotating(fn, sets):
        """``fn`` on the next set of inputs from the iterator ``sets`` at
        each call.  One iterator serves every cold timing of a shape, so
        that at least ``COLD_BYTES`` lie between two reads of a copy."""
        return lambda: fn(*next(sets))

    gen = torch.Generator(device=dev).manual_seed(5)
    rows, timings = [], []
    for shape in RMSNORM_SHAPES:
        n, D = shape
        for dt in ("bfloat16", "float32"):
            tdt = getattr(torch, dt)
            # copies of x, r and gamma: copy 0 is checked, all are timed
            k = -(-COLD_BYTES // (n * D * tdt.itemsize)) if dt == "bfloat16" else 1
            X, R = ((torch.randn(k, *shape, generator=gen, device=dev) * 3).to(tdt)
                    for _ in range(2))
            G = torch.randn(k, D, generator=gen, device=dev) * 0.1
            x, r, g = X[0], R[0], G[0]
            out = rmsnorm(x, g)
            normed, summed = rmsnorm_add(x, r, g)
            torch.cuda.synchronize()
            want_n, want_s = rmsnorm_add_ref(x, r, g)
            tpr, nv = plan(n, D, tdt)
            row = dict(shape=list(shape), dtype=dt, threads_per_row=tpr, vectors_per_thread=nv,
                       rmsnorm_max_abs_err=max_err(torch, out, rmsnorm_ref(x, g), dt),
                       rmsnorm_add_max_abs_err=max_err(torch, normed, want_n, dt),
                       rmsnorm_add_sum_bitwise=bool(torch.equal(summed, want_s)))
            assert row["rmsnorm_add_sum_bitwise"], row
            gated = D == ZAMBA_D_INNER
            if gated:
                kg = -(-COLD_BYTES // (n * D * 10)) if dt == "bfloat16" else 1
                gas = [gated_inputs(torch, dev, n, dt, gen) for _ in range(kg)]
                row["rmsnorm_gated_max_abs_err"] = max_err(
                    torch, rmsnorm_gated(**gas[0]), rmsnorm_gated_ref(**gas[0]), dt)
            rows.append(row)
            log(f"rmsnorm {json.dumps(row)}")
            if dt != "bfloat16":
                continue
            sets = list(zip(X, R, G, (1.0 + G).to(tdt)))
            cold = itertools.cycle(sets)
            cases = [("rmsnorm", lambda x, r, g, w: rmsnorm(x, g),
                      lambda x, r, g, w: rmsnorm_ref(x, g),
                      lambda x, r, g, w: F.rms_norm(x, (D,), weight=w, eps=1e-6), sets, cold,
                      4 * n * D, 2 * n * D * x.element_size() + 4 * D),
                     ("rmsnorm_add", lambda x, r, g, w: rmsnorm_add(x, r, g),
                      lambda x, r, g, w: rmsnorm_add_ref(x, r, g), None, sets, cold,
                      5 * n * D, 4 * n * D * x.element_size() + 4 * D)]
            if gated:
                # y fp32 from the scan, x and z bf16 views, out bf16; D fp32
                cases.append(("rmsnorm_gated", lambda ga: rmsnorm_gated(**ga),
                              lambda ga: rmsnorm_gated_ref(**ga), None, [(ga,) for ga in gas],
                              itertools.cycle([(ga,) for ga in gas]),
                              10 * n * D, n * D * (4 + 3 * x.element_size()) + 4 * D
                              + 4 * (D // ZAMBA_HEAD_DIM)))
            for name, fn, plain, lib, args, cold, flops, nbytes in cases:
                # ms, plain_ms, library_ms: device time per call (profiler)
                # over the rotated copies; *_warm: the same on copy 0 alone;
                # host_us: the wrapper's (and the plain chain's) host
                # microseconds per call
                tm = dict(kernel=name, shape=list(shape), dtype=dt, path=RMSNORM_PATHS[shape],
                          input_copies=len(args))
                tm["bound_ms"], tm["bound_by"] = bound(flops, nbytes, "float32")
                tm["ms"], kernels = device_profile(torch, rotating(fn, cold), 200)
                tm["device_kernels_per_call"] = kernels_per_call(kernels)
                assert tm["device_kernels_per_call"] == 1, kernels
                tm["ms_warm"] = device_ms(torch, lambda: fn(*args[0]), 200)
                tm["plain_ms"] = device_ms(torch, rotating(plain, cold))
                tm["plain_ms_warm"] = device_ms(torch, lambda: plain(*args[0]))
                tm["library_ms"] = device_ms(torch, rotating(lib, cold), 200) if lib else None
                tm["library_ms_warm"] = (device_ms(torch, lambda: lib(*args[0]), 200)
                                         if lib else None)
                tm["host_us"] = host_us(torch, lambda: fn(*args[0]))
                tm["plain_host_us"] = host_us(torch, lambda: plain(*args[0]), 300)
                timings.append(tm)
                log(f"rmsnorm timing {json.dumps(tm)}")
    results["rmsnorm_cases"] = rows
    results["rmsnorm_timing"] = timings
    check_rmsnorm_split(torch, dev, results)


# the split entry's shapes (rows, d_inner): a zamba2 train slice (2 x
# 1,024 tokens) and a decode step of 8 lanes; its row split into these
# many column shards of whole heads (1: the (1, 1) mesh's call)
RMSNORM_SPLIT_SHAPES = ((2048, ZAMBA_D_INNER), (8, ZAMBA_D_INNER))
RMSNORM_SPLIT_SHARDS = (1, 2, 4)


def split_gated(torch, fn, ga: dict, shards: int):
    """The gated norm of ``ga`` (:func:`gated_inputs`) over its row split
    into ``shards`` column shards of whole heads: each shard's sum of
    squares by ``fn`` (``rmsnorm_gated_split`` or its plain version), the
    sums added on the device, each shard normalised by the total; returns
    the shards' outputs side by side and the total."""
    H, P = ga["d_skip"].shape[0], ga["head_dim"]
    h = H // shards
    c = h * P
    parts = [dict(y=ga["y"][:, m * c:(m + 1) * c], z=ga["z"][:, m * c:(m + 1) * c],
                  gamma=ga["gamma"][m * c:(m + 1) * c],
                  x=ga["x"][:, m * c:(m + 1) * c], d_skip=ga["d_skip"][m * h:(m + 1) * h],
                  head_dim=P) for m in range(shards)]
    total = sum(fn(**q) for q in parts)
    return torch.cat([fn(**q, row_sum=total, width=H * P) for q in parts], dim=-1), total


def check_rmsnorm_split(torch, dev, results):
    """Phase 2e's split entry (``rmsnorm_gated_split``: the gated out-norm
    over a rank's columns of a row split across model ranks, its sum of
    squares then its columns normalised by the whole row's sum) at
    ``RMSNORM_SPLIT_SHAPES``, bf16 and fp32: the row split into 1, 2 and 4
    column shards, the shards' sums added on the device, against its plain
    version (``TOL``) and against the whole-row gated kernel (one shard:
    bitwise, the same plan and reduction; more: ``TOL``).  Timed in bf16 at
    one shard (the (1, 1) mesh's call: two launches), L2-cold as 2e's
    gated row, beside the plain chain; bound: the bytes the function needs
    (y, z and x read once, the sums written and read, the output
    written), not the second launch's re-read of y, z and x."""
    import itertools

    from repro_torch.kernels.rmsnorm.ops import rmsnorm_gated, rmsnorm_gated_split
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_gated_split_ref

    def plain(y, z, gamma, x, d_skip, head_dim, row_sum=None, width=None):
        return rmsnorm_gated_split_ref(y, z, gamma, x, d_skip, head_dim, 1e-6, row_sum, width)

    gen = torch.Generator(device=dev).manual_seed(9)
    cases, timings = [], []
    for n, D in RMSNORM_SPLIT_SHAPES:
        for dt in ("bfloat16", "float32"):
            k = -(-COLD_BYTES // (n * D * 10)) if dt == "bfloat16" else 1
            gas = [gated_inputs(torch, dev, n, dt, gen) for _ in range(k)]
            whole = rmsnorm_gated(**gas[0])
            for shards in RMSNORM_SPLIT_SHARDS:
                got, total = split_gated(torch, rmsnorm_gated_split, gas[0], shards)
                want, want_total = split_gated(torch, plain, gas[0], shards)
                torch.cuda.synchronize()
                row = dict(shape=[n, D], dtype=dt, shards=shards,
                           max_abs_err=max_err(torch, got, want, dt),
                           row_sum_max_rel_err=float(((total - want_total).abs()
                                                      / want_total.abs()).max()),
                           max_abs_err_vs_whole=max_err(torch, got, whole, dt),
                           bitwise_whole=bool(torch.equal(got, whole)))
                log(f"rmsnorm split {json.dumps(row)}")
                assert shards > 1 or row["bitwise_whole"], row
                assert row["row_sum_max_rel_err"] < 1e-5, row
                cases.append(row)
            if dt != "bfloat16":
                continue

            def call(ga):
                s_ = rmsnorm_gated_split(**ga)
                return rmsnorm_gated_split(**ga, row_sum=s_, width=D)

            def plain_call(ga):
                s_ = plain(**ga)
                return plain(**ga, row_sum=s_, width=D)

            cold = itertools.cycle(gas)
            H = D // ZAMBA_HEAD_DIM
            # what the function needs: y (fp32), z and x (bf16), D and gamma
            # read once, the sums written and read, the output written (this
            # design's second pass over y, z and x is not counted)
            nbytes = n * D * 8 + 4 * H + 4 * D + 2 * 4 * n + 2 * n * D
            tm = dict(kernel="rmsnorm_gated_split", shape=[n, D], dtype=dt, shards=1,
                      path=("zamba train slice (mesh, split)" if n > 8
                            else "zamba decode rows (split)"), input_copies=len(gas))
            tm["bound_ms"], tm["bound_by"] = bound(10 * n * D, nbytes, "float32")
            tm["ms"], kernels = device_profile(torch, lambda: call(next(cold)), 200)
            tm["device_kernels_per_call"] = kernels_per_call(kernels)
            assert tm["device_kernels_per_call"] == 2, kernels
            tm["ms_warm"] = device_ms(torch, lambda: call(gas[0]), 200)
            tm["ms_events"] = time_ms(torch, lambda: call(next(cold)), 200)
            tm["plain_ms"] = device_ms(torch, lambda: plain_call(next(cold)))
            tm["library_ms"] = None
            tm["host_us"] = host_us(torch, lambda: call(gas[0]))
            log(f"rmsnorm split timing {json.dumps(tm)}")
            timings.append(tm)
    results["rmsnorm_split_cases"] = cases
    results["rmsnorm_split_timing"] = timings


def gated_inputs(torch, dev, n, dt, gen) -> dict:
    """The gated form's arguments as a zamba2 Mamba2 block hands them over
    for ``n`` rows: y fp32 (the scan's output), z and x the first
    ``d_inner`` columns of the in-projection (8,384 wide) and of the conv
    output (4,224 wide) in ``dt``, ``out_ln`` and ``D_skip`` fp32."""
    tdt = getattr(torch, dt)
    H = ZAMBA_D_INNER // ZAMBA_HEAD_DIM
    proj = torch.randn(n, 2 * ZAMBA_D_INNER + 2 * 64 + H, generator=gen, device=dev).to(tdt)
    conv = torch.randn(n, ZAMBA_D_INNER + 2 * 64, generator=gen, device=dev).to(tdt)
    return dict(y=torch.randn(n, ZAMBA_D_INNER, generator=gen, device=dev) * 2,
                z=proj[:, :ZAMBA_D_INNER], x=conv[:, :ZAMBA_D_INNER],
                gamma=torch.randn(ZAMBA_D_INNER, generator=gen, device=dev) * 0.1,
                d_skip=torch.rand(H, generator=gen, device=dev) + 0.5,
                head_dim=ZAMBA_HEAD_DIM)


def check_flash_frontend(torch, dev, results):
    """Phase 2f: flash at the frontend families' shapes (``FLASH_FRONTEND``):
    whisper's non-causal encoder and cross-attention over 1,500 keys (the
    last key tile ragged) and an internvl2 prefill at head dim 128, causal;
    each against the plain version in bf16 and fp32 (``TOL``), then timed
    in bf16 beside the plain version and SDPA, with the bound (the pairs'
    operations, or q, k, v and the output once)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device=dev).manual_seed(11)
    for name, B, Sq, Sk, H, Hk, D, causal in FLASH_FRONTEND:
        for dt in ("bfloat16", "float32"):
            q = torch.randn(B, Sq, H, D, generator=gen, device=dev).to(getattr(torch, dt))
            k, v = (torch.randn(B, Sk, Hk, D, generator=gen, device=dev).to(getattr(torch, dt))
                    for _ in range(2))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            out = flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            want = attention_ref(qt, kt, vt, causal=causal).transpose(1, 2)
            row = dict(shape=name, Sq=Sq, S=Sk, D=D, H=H, Hk=Hk, dtype=dt, causal=causal,
                       max_abs_err=max_err(torch, out, want, dt))
            results["flash_cases"].append(row)
            log(f"flash {json.dumps(row)}")
            if dt != "bfloat16":
                continue
            qc, kc, vc = (x.contiguous() for x in (qt, kt, vt))
            kernel = lambda: flash_attention(q, k, v, causal=causal)
            plain = lambda: attention_ref(qt, kt, vt, causal=causal)
            lib = lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=causal,
                                                         enable_gqa=True)
            pairs = B * (Sq * (Sq + 1) // 2 if causal else Sq * Sk)
            tm = dict(shape=name, q=[B, Sq, H, D], kv=[B, Sk, Hk, D], dtype=dt, causal=causal,
                      window=0, max_abs_err=row["max_abs_err"],
                      library_max_abs_err=(lib().transpose(1, 2).float() - want.float())
                      .abs().max().item())
            tm["bound_ms"], tm["bound_by"] = bound(4 * D * H * pairs,
                                                   2 * D * (2 * B * Sq * H + 2 * B * Sk * Hk), dt)
            tm["ms"], kernels = device_profile(torch, kernel, 50)
            tm["device_kernels_per_call"] = kernels_per_call(kernels)
            tm["plain_ms"] = device_ms(torch, plain, 10)
            tm["library_ms"], tm["library_kernels"] = device_profile(torch, lib, 50)
            tm["vs_library"] = tm["ms"] / tm["library_ms"] if tm["ms"] and tm["library_ms"] \
                else None
            tm["ms_events"] = time_ms(torch, kernel, 50)
            tm["library_ms_events"] = time_ms(torch, lib, 50)
            results["flash_timing"].append(tm)
            log(f"flash timing {json.dumps(tm)}")
            del qc, kc, vc
        del q, k, v, out, want


# ---------------------------------------------------------------------------
# Phase 3: the main path at full width
# ---------------------------------------------------------------------------


def requests(vocab: int, n: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    plens = rng.integers(16, 513, n)
    budgets = rng.integers(32, 65, n)
    return [(rng.integers(0, vocab, int(p)).astype(np.int32), int(b))
            for p, b in zip(plens, budgets)]


def gemma2_requests(vocab: int, seed: int = 7):
    """Phase 7's traffic: two prompts of ``GEMMA_LONG`` tokens (budget
    ``GEMMA_LONG_BUDGET``), longer than gemma2's local window, first, so
    that the graph check and the profiled decode steps hold them; then
    phase 3's 16 requests (their prompt lengths and budgets)."""
    rng = np.random.default_rng(seed)
    longs = [(rng.integers(0, vocab, int(n)).astype(np.int32), GEMMA_LONG_BUDGET)
             for n in rng.integers(*GEMMA_LONG, 2)]
    return longs + requests(vocab)


class StepClock:
    """An engine clock that advances one unit per engine step (``serve``
    ticks it): deadlines become a property of the schedule, not of the
    host's speed, so a run with deadlines is reproducible."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def serve(torch, cfg, params, reqs, engine_cfg, dev, *, check: bool = False,
          prebuild: bool = False, faults=None, deadlines: dict | None = None,
          host_tier=None, after_step=None, draft_params=None, engine_cls=None, obs=None,
          mesh=None):
    """Submit every request at once and drain; returns (engine, rids,
    per-step host times in ms, whether each step ran a prefill chunk, wall
    seconds): one synchronized span over the whole drain loop. ``check``
    sweeps ``check_invariants`` after every step, and ``after_step(engine)``
    runs after it; the sweep (from a synchronize after the step to its
    end) is taken out of the wall time.  ``prebuild`` builds every program
    first; ``faults`` is the engine's ``FaultPlan``; ``deadlines`` maps a
    request's index to its ``deadline_s``, on a ``StepClock``;
    ``host_tier`` is the engine's ``HostTier`` instance; ``draft_params``
    the spec engine's draft weights; ``engine_cls`` a ``ServeEngine``
    subclass to build; ``obs`` its ``Observer``; ``mesh`` its mesh."""
    from repro_torch.serve import ServeEngine

    clock = StepClock()
    extra = dict(clock=clock) if deadlines else {}
    if mesh is not None:
        extra["mesh"] = mesh
    eng = (engine_cls or ServeEngine)(cfg, params, engine_cfg, device=dev, faults=faults,
                                      host_tier=host_tier, draft_params=draft_params,
                                      obs=obs, **extra)
    if prebuild:
        eng.prebuild()
        built = eng.stats["builds"]
    deadlines = deadlines or {}
    rids = [eng.submit(p, max_new_tokens=b, deadline_s=deadlines.get(i))
            for i, (p, b) in enumerate(reqs)]
    steps, prefilled = [], []
    swept = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.has_work():
        before = eng.counters["prefill_chunks"]
        t = time.perf_counter()
        eng.step()
        steps.append((time.perf_counter() - t) * 1e3)
        prefilled.append(eng.counters["prefill_chunks"] != before)
        clock.t += 1.0
        if check or after_step is not None:
            torch.cuda.synchronize()
            t = time.perf_counter()
            if check:
                eng.check_invariants()
            if after_step is not None:
                after_step(eng)
            swept += time.perf_counter() - t
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - swept
    if prebuild:
        # prebuild() covered every program the schedule dispatched
        assert eng.stats["builds"] == built, (built, eng.stats)
    return eng, rids, steps, prefilled, wall


def clone_state(torch, tree):
    """A deep copy of an engine's state: every tensor cloned, the sampling
    generator's state copied into a new generator."""
    if isinstance(tree, dict):
        return {k: clone_state(torch, v) for k, v in tree.items()}
    if isinstance(tree, torch.Generator):
        gen = torch.Generator(device=tree.device)
        gen.set_state(tree.get_state())
        return gen
    return tree.clone()


def state_leaves(torch, state, prefix=""):
    """(name, tensor) of every tensor leaf of an engine's state."""
    for k in sorted(state):
        v = state[k]
        if isinstance(v, dict):
            yield from state_leaves(torch, v, f"{prefix}{k}/")
        elif torch.is_tensor(v):
            yield prefix + k, v


def bitwise_equal(torch, a, b) -> bool:
    """Same shape, dtype and bits (a float's sign of zero and NaN payload
    included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(ints), b.contiguous().view(ints)
    return bool(torch.equal(a, b))


# the sampling of graph_check's sampled pass: a temperature (the
# stochastic program, drawing from the registered generator) with top-k
# and top-p (its masked form)
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95)


def graph_check(torch, cfg, params, reqs, ec, dev, steps: int = 8,
                sampling: dict | None = None, mesh=None) -> dict:
    """The captured decode graph against the eager program it captured: an
    engine admits the first ``MAX_SLOTS`` requests (greedy, or with
    ``sampling``'s temperature, top-k and top-p) and takes its first
    decode step (which builds the graph); then it takes ``steps`` more
    steps, each of which (after the engine has mapped blocks and pushed
    its mirrors) runs the eager program on a deep clone of the state (the
    sampling generator's state copied) and replays the graph on the state
    itself.  The sampled tokens must be equal and every state leaf bitwise
    equal: the two launch the same kernels in the same order on the same
    inputs, and draw the same uniforms from the same generator state.  On a
    ``mesh`` the eager program issues the collectives the graph captured."""
    from repro_torch.core.aot import CudaGraphProgram
    from repro_torch.serve import ServeEngine

    sampling = sampling or {}
    flags = dict(stochastic=sampling.get("temperature", 0) > 0,
                 masked=bool(sampling.get("top_k")) or 0 < sampling.get("top_p", 1) < 1)
    eng = ServeEngine(cfg, params, ec, device=dev, mesh=mesh)
    for p, b in reqs[:MAX_SLOTS]:
        eng.submit(p, max_new_tokens=b, **sampling)
    while eng.counters["decode_steps"] < 1:
        eng.step()
    graph = eng._decode_entry(**flags)
    assert isinstance(graph, CudaGraphProgram), type(graph)
    assert eng.stats["graphs"] == 1, eng.stats
    eager = eng.decode_program(**flags)
    bad = []

    def checked(params, state):
        step = graph.replays
        clone = clone_state(torch, state)
        want = eager(params, clone)
        got = graph(params, state)
        torch.cuda.synchronize()
        if not bitwise_equal(torch, got, want):
            bad.append((step, "tokens"))
        bad.extend((step, name) for (name, a), (_, b) in zip(state_leaves(torch, state),
                                                            state_leaves(torch, clone))
                   if not bitwise_equal(torch, a, b))
        return got

    eng._decode_entry = lambda **flags: checked
    try:
        for _ in range(steps):
            eng.step()
    finally:
        del eng._decode_entry       # the engine's own method again: no cycle keeps it alive
    assert eng.counters["decode_steps"] == steps + 1 and not eng.completions
    build_s = list(eng.graphs.build_seconds.values())
    out = dict(**flags, steps=steps, lanes=MAX_SLOTS, replays=graph.replays, mismatches=bad,
               leaves=len(list(state_leaves(torch, eng.state))),
               graph_build_s=build_s[0], launches_counted_per_replay=[
                   (c.__name__, n) for c, n in graph.launches])
    log(f"graph check: {json.dumps(out)}")
    assert not bad and graph.replays == steps, out
    return out


def steady_builds(eng, reqs) -> dict:
    """The engine serves ``reqs`` again: its program cache must build
    nothing more (builds flat after warm-up) and only hit, and it captures
    no new graph."""
    keys = ("builds", "cache_hits", "executables", "graphs")
    before = {k: eng.stats[k] for k in keys}
    for p, b in reqs:
        eng.submit(p, max_new_tokens=b)
    eng.drain()
    after = {k: eng.stats[k] for k in keys}
    out = dict(before=before, after=after, requests=len(reqs))
    assert (after["builds"], after["graphs"]) == (before["builds"], before["graphs"]) \
        and after["cache_hits"] > before["cache_hits"], out
    return out


def dense_norms(pre: int, dec: int) -> dict:
    """RMSNorm launches of a dense smollm-360m serving run: per prefill and
    decode step ``ln1`` in each layer and ``ln_f`` (rmsnorm), ``ln2`` with
    its residual add in each layer (rmsnorm_add)."""
    return {"rmsnorm": (N_LAYERS + 1) * (pre + dec), "rmsnorm_add": N_LAYERS * (pre + dec)}


def main_path(torch, dev, results):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add
    from repro_torch.models import lm
    from repro_torch.serve import EngineConfig

    base = get_config("smollm-360m")
    assert base.n_layers == N_LAYERS
    cfg = dataclasses.replace(base, attn_impl="kernel")
    params = lm.init(cfg, seed=0, device=dev)
    reqs = requests(cfg.vocab)
    ec = EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN, kv_layout="paged",
                      page_size=PAGE, paged_attn="kernel")
    # warm-up (cuBLAS handles, allocator) on two short requests, the graph
    # check, then the measured run with the launch counts set to 0 just
    # before it
    serve(torch, cfg, params, [(reqs[0][0][:16], 4), (reqs[1][0][:32], 4)], ec, dev)
    results["graph_check"] = {
        "greedy": graph_check(torch, cfg, params, reqs, ec, dev),
        "sampled": graph_check(torch, cfg, params, reqs, ec, dev, sampling=SAMPLED)}
    kernels = (flash_attention, paged_attention, rmsnorm, rmsnorm_add)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    eng, rids, steps, prefilled, wall = serve(torch, cfg, params, reqs, ec, dev)
    launches = {k.__name__: k.launches for k in kernels}
    st = eng.stats
    eng.check_invariants()
    programs = program_builds(eng, reqs)
    comps = [eng.completions[r] for r in rids]
    bad = [(c.rid, c.status, len(c.tokens), b) for c, (_, b) in zip(comps, reqs)
           if c.status != "ok" or len(c.tokens) != b]
    assert not bad, f"requests not served in full: {bad}"
    results["phase3_streams"] = [list(c.tokens) for c in comps]
    assert launches["flash_attention"] == N_LAYERS * st["prefills"] > 0, (launches, st)
    assert launches["paged_attention"] == N_LAYERS * st["decode_steps"] > 0, (launches, st)
    norms = dense_norms(st["prefills"], st["decode_steps"])
    assert all(launches[k] == v for k, v in norms.items()), (launches, norms, st)
    tokens = sum(len(c.tokens) for c in comps)
    decode_only = [t for t, p in zip(steps, prefilled) if not p]
    e2e = dict(requests=len(comps), tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
               prefills=st["prefills"], decode_steps=st["decode_steps"],
               prompt_tokens=st["prefill_tokens"],
               decode_step_ms_median=float(np.median(decode_only)),
               prefill_step_ms_median=float(np.median([t for t, p in zip(steps, prefilled)
                                                       if p])),
               decode_step_ms_p90=float(np.percentile(decode_only, 90)),
               decode_only_steps=len(decode_only), step_ms_mean=wall * 1e3 / len(steps),
               kv_reserved_bytes=st["kv_reserved_bytes"],
               kv_peak_used_bytes=st["kv_peak_used_bytes"],
               max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
               programs=programs)
    log(f"main path (paged, kernels, decode graph): {tokens} tokens in {wall:.3f} s = "
        f"{tokens / wall:.1f} tok/s; decode step median {e2e['decode_step_ms_median']:.2f} ms "
        f"over {len(decode_only)} decode-only steps; launches {launches}; "
        f"programs {json.dumps(programs)}")

    # the same requests through the plain paths: greedy agreement, printed
    # and not gated (random weights leave near-ties that bf16 rounding
    # flips); in fp32 compute both paths run, kernel and plain
    ref_cfg = dataclasses.replace(base, attn_impl="chunked")
    ref_ec = dataclasses.replace(ec, paged_attn="ref")
    ref_eng, ref_rids, _, _, ref_wall = serve(torch, ref_cfg, params, reqs, ref_ec, dev)
    e2e.update(plain_wall_s=ref_wall, plain_tokens_per_s=tokens / ref_wall,
               greedy_bf16=agreement([c.tokens for c in comps],
                                     [ref_eng.completions[r].tokens for r in ref_rids]))
    log(f"plain path (chunked/ref): {ref_wall:.3f} s = {tokens / ref_wall:.1f} tok/s; bf16 "
        f"greedy agreement with the kernel path {e2e['greedy_bf16']} (not gated)")
    streams = []
    for c, e in ((cfg, ec), (ref_cfg, ref_ec)):
        c32 = dataclasses.replace(c, compute_dtype="float32")
        eng32, rids32, _, _, _ = serve(torch, c32, params, reqs, e, dev)
        streams.append([eng32.completions[r].tokens for r in rids32])
    e2e["greedy_fp32"] = agreement(*streams)
    log(f"fp32 compute, kernel vs plain path: greedy agreement {e2e['greedy_fp32']} "
        "(not gated)")
    del ref_eng, eng32
    results["profile"] = profile_decode(torch, cfg, params, reqs, ec, dev)

    # a few requests on the slotted layout: flash and the norms still run
    for k in (flash_attention, rmsnorm, rmsnorm_add):
        k.launches = 0
    sl_eng, sl_rids, _, _, _ = serve(
        torch, cfg, params, [(p[:64], 8) for p, _ in reqs[:4]],
        dataclasses.replace(ec, kv_layout="slotted", max_slots=4, max_len=128), dev)
    sl_eng.check_invariants()
    assert all(sl_eng.completions[r].status == "ok" and len(sl_eng.completions[r].tokens) == 8
               for r in sl_rids)
    assert flash_attention.launches == N_LAYERS * sl_eng.stats["prefills"] == 4 * N_LAYERS
    sl_norms = dense_norms(sl_eng.stats["prefills"], sl_eng.stats["decode_steps"])
    assert (rmsnorm.launches, rmsnorm_add.launches) == tuple(sl_norms.values()), sl_norms
    e2e["slotted"] = dict(requests=4, launches_flash=flash_attention.launches,
                          launches_rmsnorm=rmsnorm.launches,
                          launches_rmsnorm_add=rmsnorm_add.launches)
    results["main_path"] = e2e
    cfgs = [dataclasses.replace(base, compute_dtype=dt) for dt in ("float32", "bfloat16")]
    results["logits"] = logit_agreement(
        torch, dev, ((c, lm.cast_for_compute(c, params, dev)) for c in cfgs), reqs[2][0])
    return launches


def program_builds(eng, reqs, per_bucket: int = 1) -> dict:
    """The engine's program cache after a run without restores: one decode
    (or spec) program and ``per_bucket`` programs per prompt bucket the run
    used (a prefill; speculating, also a draft prefill), one graph, then
    flat while the engine serves four of the requests again
    (``steady_builds``)."""
    from repro_torch.serve import bucket_for

    st = eng.stats
    buckets = sorted({bucket_for(int(p.size), eng.buckets) for p, _ in reqs})
    out = dict(builds=st["builds"], cache_hits=st["cache_hits"],
               executables=st["executables"], graphs=st["graphs"], buckets=buckets,
               decode_build_s=list(eng.graphs.build_seconds.values()))
    assert st["builds"] == st["executables"] == 1 + per_bucket * len(buckets) \
        and st["graphs"] == 1, out
    out["steady"] = steady_builds(eng, reqs[:4])
    return out


def agreement(a, b) -> dict:
    """Greedy streams a vs b: requests identical, share of equal tokens."""
    pos = [np.mean(np.array(x) == np.array(y)) for x, y in zip(a, b)]
    return dict(identical_requests=sum(x == y for x, y in zip(a, b)), requests=len(a),
                token_agreement=float(np.mean(pos)))


# the port's CUDA kernels, by the names they carry in a profile
PORT_KERNEL = re.compile(r"^(void )?\(anonymous namespace\)::(tc::|simt::)?(flash_fwd_kernel|"
                         r"paged_split_kernel|paged_combine_kernel|ssd_kernel|"
                         r"ssd_chunk_state_kernel|ssd_state_pass_kernel|ssd_chunk_scan_kernel|"
                         r"rmsnorm_kernel|flat_adam_kernel)\b")
SSD_KERNEL = re.compile(r"^(void )?\(anonymous namespace\)::(tc::|simt::)?ssd_")


# the wrapper that launches a port kernel of a decode step, by the kernel's
# name in a profile: rmsnorm_kernel's second template argument is its mode
# (plain, add, gated; the split entry's sumsq and scaled);
# paged_combine_kernel, the second kernel of a paged_attention call, is
# counted with its split kernel
DECODE_WRAPPER = ((re.compile(r"::rmsnorm_kernel<[^,]+, 0,"), "rmsnorm"),
                  (re.compile(r"::rmsnorm_kernel<[^,]+, 1,"), "rmsnorm_add"),
                  (re.compile(r"::rmsnorm_kernel<[^,]+, 2,"), "rmsnorm_gated"),
                  (re.compile(r"::rmsnorm_kernel<[^,]+, [34],"), "rmsnorm_gated_split"),
                  (re.compile(r"::paged_split_kernel<"), "paged_attention"))


def replay_launches(windows, steps: int, paged: str = "paged_attention") -> dict:
    """{wrapper name: launches per step} of the port's kernels in profile
    windows of ``steps`` graph replays each: what the replays really
    launched, to hold against the counts the graph adds to the wrappers'
    counters.  Each kernel's calls per step are rounded to a whole launch,
    and each wrapper's count is its largest over the windows: the card's
    profiler loses records (the first of a window, and now and then some
    inside a large one), never adds any.  ``paged``: the paged kernels'
    wrapper (``paged_attention_range`` where the pool's blocks split over a
    mesh's data axes)."""
    best = {}
    for kernels in windows:
        per = {}
        for e in kernels:
            if not PORT_KERNEL.match(e.key):
                continue
            if "::paged_combine_kernel<" in e.key:
                name = "paged_combine_kernel"
            else:
                name = next((w for rx, w in DECODE_WRAPPER if rx.search(e.key)), None)
                assert name is not None, f"a decode replay launched {e.key[:100]}"
                name = paged if name == "paged_attention" else name
            per[name] = per.get(name, 0) + round(e.count / steps)
        for name, n in per.items():
            best[name] = max(best.get(name, 0), n)
    combine = best.pop("paged_combine_kernel", 0)
    assert combine == best.get(paged, 0), (combine, best)
    return best


def port_kernels(kernels, per: float) -> list[dict]:
    """The port's own kernels in a profile: name, calls and device ms per
    ``per``."""
    return [dict(name=e.key[:100], calls=e.count / per, ms=e.self_device_time_total / 1e3 / per)
            for e in kernels if PORT_KERNEL.match(e.key)]


# spin kernels that open and close each profiled decode window
# (``profile_decode``): the card's profiler misses a window's first records,
# more once it has recorded many windows (on an H100 80GB HBM3 at 700 W, a
# qwen3-moe window recorded ~28 fewer after phases 2-8 than alone)
LEAD_IN = 256
LEAD_IN_CYCLES = 2_000_000    # the first spin's length, ~1 ms


def profile_decode(torch, cfg, params, reqs, ec, dev, steps: int = 5, obs=None,
                   windows: int = 1, mesh=None):
    """Device time of a few decode steps with all 8 lanes busy, by kernel,
    from ``torch.profiler``; the idle share is taken against the step
    time of the same steps run again unprofiled.  The steps are the
    engine's: one replay of the captured decode graph and the token fetch.
    The port's kernels in the profiled replays must be, wrapper by wrapper,
    the launches the graph adds to the wrappers' counters per replay.
    Then the host ms of one replay alone (no fetch, a synchronize after
    it), and the eager program the graph captured, run and profiled on
    the same state: its launches and device ms per step.  ``obs`` is the
    engine's ``Observer``.  The card's profiler can miss the first records
    of a window and now and then drops records inside one, the more the
    larger the window (a qwen3-moe step launches ~6,200 kernels): each
    window opens with a spin of ``LEAD_IN_CYCLES`` and ``LEAD_IN`` short
    spin kernels and closes with ``LEAD_IN`` more, all left out of the
    figures, and ``windows`` windows of ``steps`` steps are
    recorded: the device time comes from the most complete (the most
    records), the port's launches from each wrapper's largest count
    (``replay_launches``).  ``mesh``: the engine's."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, ec, device=dev, obs=obs, mesh=mesh)
    for p, b in reqs[:MAX_SLOTS]:
        eng.submit(p, max_new_tokens=b)
    for _ in range(3):                                # admissions, then warm decode
        eng.step()
    assert eng.counters["prefills"] == MAX_SLOTS and not eng.queue
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / steps
    recorded = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(LEAD_IN_CYCLES)
            for _ in range(LEAD_IN):
                torch.cuda._sleep(1)
            for _ in range(steps):
                eng.step()
            for _ in range(LEAD_IN):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        recorded.append([e for e in prof.key_averages() if e.device_type.name == "CUDA"
                         and "spin_kernel" not in e.key])
    kernels = max(recorded, key=lambda w: sum(e.count for e in w))
    # the engine's host mirror stops here: the calls below advance the
    # device state directly
    replay = eng._decode_entry(stochastic=False, masked=False)
    counted = {c.__name__: n for c, n in replay.launches}
    replay_ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        replay(eng.params, eng.state)
        replay_ms.append((time.perf_counter() - t) * 1e3)
    eager = eng.decode_program(stochastic=False, masked=False)
    eager(eng.params, eng.state)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        eager(eng.params, eng.state)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CUDA]) as eprof:
        for _ in range(steps):
            eager(eng.params, eng.state)
        torch.cuda.synchronize()
    ekernels = [e for e in eprof.key_averages() if e.device_type.name == "CUDA"]
    if not kernels or not ekernels:
        log("profile: torch.profiler recorded no device activity (not measured)")
        return None
    # the launch counts the graph adds on every replay, held against what
    # the profiled replays launched
    measured = replay_launches(recorded, steps, paged=next(
        (n for n in ("paged_attention_range", "paged_attention") if n in counted),
        "paged_attention"))
    assert measured == counted, (measured, counted, [
        (sum(e.count for e in w), {e.key[:60]: e.count for e in w if PORT_KERNEL.match(e.key)})
        for w in recorded])
    total_us = sum(e.self_device_time_total for e in kernels)
    eager_us = sum(e.self_device_time_total for e in ekernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    out = dict(steps=steps, lanes=MAX_SLOTS, step_ms_unprofiled=step_ms,
               launches_per_window=[sum(e.count for e in w) for w in recorded],
               device_ms_per_step=total_us / 1e3 / steps,
               device_idle_share=1 - total_us / 1e3 / steps / step_ms,
               kernel_launches_per_step=sum(e.count for e in kernels) / steps,
               replay_host_ms=replay_ms, replay_host_ms_median=float(np.median(replay_ms)),
               eager_step_ms=eager_ms, eager_device_ms_per_step=eager_us / 1e3 / steps,
               eager_kernel_launches_per_step=sum(e.count for e in ekernels) / steps,
               eager_device_idle_share=1 - eager_us / 1e3 / steps / eager_ms,
               top=[dict(name=e.key[:80], calls_per_step=e.count / steps,
                         ms_per_step=e.self_device_time_total / 1e3 / steps)
                    for e in top],
               port_kernels_per_step=port_kernels(kernels, steps),
               replay_launches_per_step=measured, counted_launches_per_replay=counted)
    log(f"profile: {json.dumps(out)}")
    return out


def logit_agreement(torch, dev, models, prompt, steps: int = 1) -> dict:
    """One prompt through the lm entry points, for each ``(cfg, params)``
    of ``models`` (params already in ``cfg``'s compute dtype; fp32 runs
    with TF32 off), on the kernel path (flash, paged kernel, norm kernels)
    and the plain path (chunked attention, the paged gather, plain norms):
    the prefill at the prompt's bucket (the next power of two, as the
    engine's), then ``steps`` decode steps, each path on its own cache and
    fed the plain path's greedy token.  The largest logit difference of
    each, as a share of the plain path's largest |logit|, within
    ``LOGIT_TOL``.  Keyed by compute dtype."""
    from repro_torch.models import lm

    plen = int(prompt.size)
    C = 1 << (plen - 1).bit_length()
    nb = (C + steps) // PAGE + 1
    table = torch.arange(1, nb + 1, dtype=torch.int32, device=dev)
    chunk = torch.zeros(1, C, dtype=torch.int32, device=dev)
    chunk[0, :plen] = torch.tensor(prompt, device=dev)
    out = {}
    for cfg, params in models:
        paths = {"kernel": (dataclasses.replace(cfg, attn_impl="kernel"), "kernel"),
                 "plain": (dataclasses.replace(cfg, attn_impl="chunked"), "ref")}
        caches, logits = {}, {}
        for name, (c, _) in paths.items():
            caches[name] = {k: torch.zeros_like(s, device=dev)
                            for k, s in lm.make_paged_cache_specs(c, nb + 1, PAGE).items()}
            _, lg = lm.prefill_slot_paged(c, params, caches[name], chunk, table, plen)
            logits[name] = [lg]
        lengths = torch.tensor([plen], dtype=torch.int32, device=dev)
        for _ in range(steps):
            tok = logits["plain"][-1].float().argmax(-1).to(torch.int32)
            for name, (c, impl) in paths.items():
                lg, _ = lm.decode_step_paged(c, params, caches[name], tok, lengths, table[None],
                                             impl=impl)
                logits[name].append(lg)
            lengths = lengths + 1
        del caches
        errs = [rel_err(torch, a, b) for a, b in zip(logits["kernel"], logits["plain"])]
        dt = cfg.compute_dtype
        out[dt] = dict(layers=cfg.n_layers, prompt_len=plen, bucket=C, decode_steps=steps,
                       prefill_rel_err=errs[0], decode_rel_err=errs[1:],
                       tolerance=LOGIT_TOL[dt],
                       argmax_equal=[bool(a.argmax() == b.argmax())
                                     for a, b in zip(logits["kernel"], logits["plain"])])
        log(f"logits {dt} ({cfg.n_layers} layers): {json.dumps(out[dt])}")
        assert max(errs) <= LOGIT_TOL[dt], out[dt]
    return out


def rel_err(torch, a, b) -> float:
    a, b = a.float(), b.float()
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())
    return ((a - b).abs().max() / b.abs().max()).item()


# ---------------------------------------------------------------------------
# Phases 3b-3e: the paged engine's scheduling features at full width
# ---------------------------------------------------------------------------

FEATURE_CHUNK = 128           # prefill_chunk of phases 3b and 3e
FEATURE_BLOCKS = 97           # 96 usable blocks: about half of 8 lanes' worst case
SHARED_PREFIX = 320           # 20 full blocks
CHAOS_RATE = 0.05             # per consult, at each of the four engine sites
CHAOS_DEADLINE_STEPS = 60.0   # deadline_s of four requests in phase 3e, on a StepClock
CHAOS_DEADLINED = (3, 7, 11, 15)


def feature_requests(vocab: int, seed: int = 1):
    """Phase 3b's 16 greedy requests.  Eight share one 320-token prefix (20
    full blocks): seven add 16-192 tokens of their own, in whole blocks,
    and the eighth is the prefix alone (its match covers the whole prompt,
    so its tail block is copied and its last position recomputed).  Eight
    more have random prompts of 16-512 tokens.  Budgets 32-64.  Shared and
    random prompts alternate; the bare prefix comes last, when other lanes
    hold the whole prefix."""
    rng = np.random.default_rng(seed)
    # lengths and budgets first, so they do not depend on the vocabulary
    own, plens, budgets = rng.integers(1, 13, 7), rng.integers(16, 513, 8), rng.integers(32, 65, 16)
    prefix = rng.integers(0, vocab, SHARED_PREFIX).astype(np.int32)
    shared = [np.concatenate([prefix, rng.integers(0, vocab, 16 * int(k))]).astype(np.int32)
              for k in own]
    rand = [rng.integers(0, vocab, int(n)).astype(np.int32) for n in plens]
    prompts = [p for pair in zip(shared, rand) for p in pair] + [rand[7], prefix.copy()]
    return [(p, int(b)) for p, b in zip(prompts, budgets)]


def feature_engine(**kw):
    """Phase 3's engine settings with the features of phase 3b (or ``kw``)."""
    from repro_torch.serve import EngineConfig

    fields = dict(prefill_chunk=FEATURE_CHUNK, prefix_cache=True, admission="preempt",
                  num_blocks=FEATURE_BLOCKS)
    fields.update(kw)
    return EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN, kv_layout="paged",
                        page_size=PAGE, paged_attn="kernel", **fields)


def feature_launches(st) -> dict:
    """What the engine's counters predict of a paged run's launches: flash
    on each chunk that starts at 0 (32 layers), paged attention on each
    decode step (32), and the norms of each chunk (first or continuation)
    and decode step (``dense_norms``)."""
    return {"flash_attention": N_LAYERS * st["prefill_first_chunks"],
            "paged_attention": N_LAYERS * st["decode_steps"],
            **dense_norms(st["prefill_chunks"], st["decode_steps"])}


def feature_run(torch, cfg, params, reqs, ec, dev, predict=feature_launches, **kw) -> dict:
    """One full-width paged run with the invariants swept after every step
    and every program built first: the launch counts (set to 0 just
    before) must equal what the engine's counters predict (``predict``),
    the program cache stay flat, and the engine capture one decode (or
    spec) graph.  Returns (figures, streams, statuses, engine)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add

    kernels = (flash_attention, paged_attention, rmsnorm, rmsnorm_add)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    eng, rids, steps, prefilled, wall = serve(torch, cfg, params, reqs, ec, dev, check=True,
                                              prebuild=True, **kw)
    launches = {k.__name__: k.launches for k in kernels}
    st = eng.stats
    want = predict(st)
    assert launches == want and st["decode_steps"] > 0, (launches, want, st)
    # builds flat after prebuild() (``serve`` checks), one decode graph
    assert st["graphs"] == 1, st
    comps = [eng.completions[r] for r in rids]
    tokens = sum(len(c.tokens) for c in comps)
    decode_only = [t for t, p in zip(steps, prefilled) if not p]
    keys = ("prefills", "prefill_chunks", "prefill_first_chunks", "decode_steps",
            "prefill_tokens", "prefix_lookup_tokens", "prefix_hit_tokens", "cow_copies",
            "preemptions", "resumed", "replayed_tokens", "retries", "faults_injected",
            "faults_detected", "admitted", "evicted", "builds", "graphs",
            "kv_peak_used_bytes", *(f"status_{x}" for x in ("ok", "timeout", "cancelled",
                                                            "failed")),
            *(SPEC_KEYS if eng.spec else ()))
    out = dict(requests=len(comps), tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
               steps=len(steps), decode_only_steps=len(decode_only),
               decode_step_ms_median=float(np.median(decode_only)) if decode_only else None,
               decode_step_ms_p90=float(np.percentile(decode_only, 90)) if decode_only else None,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               counters={k: st[k] for k in keys}, launches=launches,
               invariants_checked_steps=len(steps))
    if "faults" in st:
        out["faults"] = st["faults"]
    return out, [list(c.tokens) for c in comps], [c.status for c in comps], eng


def profile_chunk(torch, cfg, params, dev, iters: int = 5) -> dict | None:
    """One lane's prefill chunks at full width, kernel path: a first chunk
    (positions [0, 128): flash) and a continuation (positions [384, 512)
    against the lane's 384 earlier positions: ``chunked_attention``), each
    timed on the host after a synchronize (median of ``iters``) and
    profiled once: device ms, launches, idle share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm

    p = lm.cast_for_compute(cfg, params, dev)
    nb = MAX_LEN // PAGE
    cache = {k: torch.zeros_like(s, device=dev)
             for k, s in lm.make_paged_cache_specs(cfg, nb + 1, PAGE).items()}
    table = torch.arange(1, nb + 1, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    prompt = torch.randint(0, cfg.vocab, (1, 512), dtype=torch.int32, device=dev, generator=gen)
    C = FEATURE_CHUNK

    def run(start):
        chunk = prompt[:, start:start + C]
        if start == 0:
            return lm.prefill_slot_paged(cfg, p, cache, chunk, table, 512)
        return lm.prefill_chunk_paged(cfg, p, cache, chunk, table, start, 512)

    for start in range(0, 512, C):                # writes the lane, warms both programs
        run(start)
    out = {}
    for name, start in (("first", 0), ("continuation", 384)):
        times = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run(start)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(start)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        if not kernels:
            log("chunk profile: torch.profiler recorded no device activity (not measured)")
            return None
        host = float(np.median(times))
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        out[name] = dict(start=start, chunk=C, host_ms_median=host, host_ms=times,
                         device_ms=dev_ms, device_idle_share=1 - dev_ms / host,
                         launches=sum(e.count for e in kernels),
                         top=[dict(name=e.key[:80], calls=e.count,
                                   ms=e.self_device_time_total / 1e3) for e in top])
    log(f"prefill chunks (kernel path, 128 positions): {json.dumps(out)}")
    del p, cache
    return out


def prefix_hit_ms(torch, cfg, params, reqs, dev) -> dict:
    """Admission to first token of a shared-prefix prompt, host ms after a
    synchronize, with the 320-token prefix cached (another request with
    the prefix was served before) and without; on phase 3b's engine
    settings, each engine warmed (its decode graph captured) by one short
    request first.  Both include the step's one decode."""
    from repro_torch.serve import Completion, ServeEngine

    out = {"hit": [], "miss": []}
    others = [p for p, _ in reqs[:14:2]]                # shared-prefix prompts
    for i in range(3):
        for case in ("miss", "hit"):
            eng = ServeEngine(cfg, params, feature_engine(), device=dev)
            eng.prebuild()
            eng.submit(reqs[1][0][:16], max_new_tokens=3)
            if case == "hit":
                eng.submit(others[i], max_new_tokens=1)
            eng.drain()
            prompt = others[i + 3]
            before = dict(eng.counters)
            torch.cuda.synchronize()
            t = time.perf_counter()
            rid = eng.submit(prompt, max_new_tokens=2)
            while not (eng.live.get(rid) or eng.completions.get(rid) or
                       Completion(0, 0, 0, [], [], 0, 0)).tokens:
                eng.step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            delta = {k: eng.counters[k] - before[k]
                     for k in ("prefix_hit_tokens", "prefill_chunks", "decode_steps")}
            out[case].append(dict(ms=ms, plen=int(prompt.size), hit_tokens=delta[
                "prefix_hit_tokens"], chunks=delta["prefill_chunks"],
                decode_steps=delta["decode_steps"]))
            del eng
    assert all(r["hit_tokens"] == SHARED_PREFIX for r in out["hit"]), out
    assert all(r["hit_tokens"] == 0 for r in out["miss"]), out
    out["hit_ms_median"] = float(np.median([r["ms"] for r in out["hit"]]))
    out["miss_ms_median"] = float(np.median([r["ms"] for r in out["miss"]]))
    log(f"prefix-hit admission to first token: {json.dumps(out)}")
    return out


def continuation_logits(torch, dev, base, params, prompt) -> dict:
    """Phase 3d: one 512-token prompt's last-position logits on the kernel
    path, (1) prefilled in four chunks of 128 and (2) after a 320-position
    prefix (as a prefix hit finds it) by one continuation of 192, against
    the plain path's whole-bucket prefill.  fp32 (TF32 off) is gated at
    ``LOGIT_TOL`` (of the largest logit, phase 3's kernel-against-plain
    gate); bf16 is printed."""
    from repro_torch.models import lm

    out = {}
    plen = int(prompt.size)
    assert plen == 512
    nb = MAX_LEN // PAGE
    table = torch.zeros(nb, dtype=torch.int32, device=dev)
    table[: plen // PAGE] = torch.arange(1, plen // PAGE + 1, dtype=torch.int32)
    tokens = torch.tensor(prompt[None], device=dev)
    for dt in ("float32", "bfloat16"):
        res = {}

        def fresh(c):
            return {k: torch.zeros_like(s, device=dev)
                    for k, s in lm.make_paged_cache_specs(c, nb + 1, PAGE).items()}

        plain = dataclasses.replace(base, compute_dtype=dt, attn_impl="chunked")
        pp = lm.cast_for_compute(plain, params, dev)
        _, want = lm.prefill_slot_paged(plain, pp, fresh(plain), tokens, table, plen)
        cfg = dataclasses.replace(base, compute_dtype=dt, attn_impl="kernel")
        p = lm.cast_for_compute(cfg, params, dev)
        cases = {"chunks_4x128": (0, 128, 256, 384), "prefix_320_then_192": (0, 320)}
        for name, starts in cases.items():
            cache = fresh(cfg)
            ends = starts[1:] + (plen,)
            for a, b in zip(starts, ends):
                if a == 0:
                    _, got = lm.prefill_slot_paged(cfg, p, cache, tokens[:, :b], table, plen)
                else:
                    _, got = lm.prefill_chunk_paged(cfg, p, cache, tokens[:, a:b], table, a,
                                                    plen)
            res[name] = dict(rel_err=rel_err(torch, got, want),
                             argmax_equal=bool(got.argmax() == want.argmax()))
        _, whole = lm.prefill_slot_paged(cfg, p, fresh(cfg), tokens, table, plen)
        res["kernel_whole_bucket_rel_err"] = rel_err(torch, whole, want)
        res["tolerance"] = LOGIT_TOL[dt]
        out[dt] = res
        log(f"continuation logits {dt}: {json.dumps(res)}")
        del pp, p
    assert all(out["float32"][n]["rel_err"] <= LOGIT_TOL["float32"]
               for n in ("chunks_4x128", "prefix_320_then_192")), out
    return out


def feature_path(torch, dev, results):
    """Phases 3b-3e on full-width smollm-360m (seed-0 weights, bf16, the
    kernel path, phase 3's engine).  Returns phase 3b's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import ENGINE_FAULT_SITES, STATUSES, FaultPlan

    base = get_config("smollm-360m")
    cfg = dataclasses.replace(base, attn_impl="kernel")
    params = lm.init(cfg, seed=0, device=dev)
    reqs = feature_requests(cfg.vocab)
    out = {}

    # 3b: chunked prefill, the prefix cache and preempt admission together
    # (the engine logs where each prefill starts, for phase 3l)
    b, streams_b, status_b, eng_b = feature_run(torch, cfg, params, reqs, feature_engine(), dev,
                                                engine_cls=start_log_engine())
    results["phase3b_starts"] = eng_b.prefill_starts(len(reqs))
    del eng_b
    c = b["counters"]
    short = [(i, len(t), bud) for i, (t, (_, bud)) in enumerate(zip(streams_b, reqs))
             if len(t) != bud]
    assert status_b == ["ok"] * len(reqs) and not short, (status_b, short)
    assert c["prefill_chunks"] > c["prefills"], c
    for k in ("prefix_hit_tokens", "cow_copies", "preemptions", "resumed", "replayed_tokens"):
        assert c[k] > 0, (k, c)
    log(f"3b features (chunk {FEATURE_CHUNK}, prefix cache, preempt, {FEATURE_BLOCKS} "
        f"blocks): {b['tokens']} tokens in {b['wall_s']:.3f} s = {b['tokens_per_s']:.1f} "
        f"tok/s; decode step median {b['decode_step_ms_median']:.2f} ms p90 "
        f"{b['decode_step_ms_p90']:.2f} ms; {json.dumps(b)}")
    b["chunk_profile"] = profile_chunk(torch, cfg, params, dev)
    b["prefix_hit_admission"] = prefix_hit_ms(torch, cfg, params, reqs, dev)
    out["3b"] = b
    results["phase3b_streams"] = streams_b

    # 3c: preempt admission alone on phase 3's traffic: the replayed
    # streams are phase 3's bitwise
    phase3 = requests(cfg.vocab)
    cc, streams_c, _, _ = feature_run(torch, cfg, params, phase3,
                                   feature_engine(prefill_chunk=0, prefix_cache=False), dev)
    same = [i for i, (x, y) in enumerate(zip(streams_c, results["phase3_streams"])) if x == y]
    cc["identical_to_phase3"] = len(same)
    log(f"3c preempt only: {json.dumps(cc)}")
    assert cc["counters"]["preemptions"] > 0, cc
    assert len(same) == len(phase3), (same, cc)
    out["3c"] = cc

    # 3d: continuation logits against the whole-bucket prefill
    prompt = np.random.default_rng(8).integers(0, cfg.vocab, 512).astype(np.int32)
    out["3d"] = continuation_logits(torch, dev, base, params, prompt)

    # 3e: chaos on phase 3b's engine; retries recompute, so every request
    # that ends ok is phase 3b's stream
    plan = FaultPlan(0, {site: CHAOS_RATE for site in ENGINE_FAULT_SITES})
    e, streams_e, status_e, _ = feature_run(
        torch, cfg, params, reqs, feature_engine(max_retries=2), dev, faults=plan,
        deadlines={i: CHAOS_DEADLINE_STEPS for i in CHAOS_DEADLINED})
    assert all(st in STATUSES for st in status_e), status_e
    ok = [i for i, st in enumerate(status_e) if st == "ok"]
    diverged = [i for i in ok if streams_e[i] != streams_b[i]]
    not_prefix = [i for i, st in enumerate(status_e)
                  if st != "ok" and streams_e[i] != streams_b[i][: len(streams_e[i])]]
    e.update(statuses=status_e, ok=len(ok), ok_diverged=diverged, non_ok_not_prefix=not_prefix)
    log(f"3e chaos (rate {CHAOS_RATE}, seed 0): {json.dumps(e)}")
    assert e["counters"]["faults_injected"] > 0, e
    assert not diverged, e
    out["3e"] = e
    results["features"] = out
    del params
    return b["launches"]


# ---------------------------------------------------------------------------
# Phases 3f-3i: the host-RAM tier, hold/park, snapshots, migration and host
# sampling on the dense engine
# ---------------------------------------------------------------------------

# The counters phases 3f and 3g must show: what a smoke-width CPU rehearsal
# of the same engine settings and traffic gives (the schedule does not
# depend on the values computed: greedy, no EOS, chain keys of 16 tokens;
# ``tests/test_torch_host_tier.py::test_chip_smoke_tier_schedules`` runs
# it).  ``spilled_blocks`` is spilled_bytes over one block's bytes.
TIER_KEYS = ("prefills", "prefill_chunks", "prefill_first_chunks", "decode_steps",
             "preemptions", "resumed", "replayed_tokens", "spills", "restores",
             "spill_drops", "prefix_spills", "host_prefix_hits", "prefix_hit_tokens",
             "cow_copies", "spilled_blocks", "restored_blocks")
TIER_3F = dict(prefills=16, prefill_chunks=16, prefill_first_chunks=16, decode_steps=190,
               preemptions=6, resumed=6, replayed_tokens=0, spills=6, restores=6,
               spill_drops=0, prefix_spills=0, host_prefix_hits=0, prefix_hit_tokens=0,
               cow_copies=0, spilled_blocks=69, restored_blocks=69)
TIER_3G = dict(prefills=16, prefill_chunks=48, prefill_first_chunks=14, decode_steps=207,
               preemptions=15, resumed=15, replayed_tokens=0, spills=5, restores=5,
               spill_drops=0, prefix_spills=308, host_prefix_hits=2, prefix_hit_tokens=2271,
               cow_copies=1, spilled_blocks=414, restored_blocks=108)
TIER_3G_BLOCKS = 128          # host_tier_blocks of phase 3g
# the requests of 3g that re-admit on a chain promoted from the tier, and
# where their prefill restarts (the end of the promoted chain), by the same
# rehearsal: each promotion stopped when the free list ran out, inside the
# prompt's first chunk
TIER_3G_PROMOTED = {9: 16, 14: 16}
PARK_STEPS = 3.0              # park_idle_s of phase 3h, on a StepClock
COPY_ITERS = 5


def block_bytes(cfg) -> int:
    """Bytes of one paged KV block: K and V of every layer."""
    itemsize = {"bfloat16": 2, "float32": 4}[cfg.compute_dtype]
    return 2 * cfg.n_layers * PAGE * cfg.n_kv * cfg.head_dim * itemsize


def logging_tier(capacity: int | None = None):
    """A ``HostTier`` (the engine takes it as ``host_tier=``) that records
    what moves through it: the blocks of each lane spill it admits
    (``lanes_in``) and restores (``lanes_out``), and each prefix block it
    hands back for promotion, with its payload (``promoted``)."""
    from repro_torch.serve import HostTier

    class LoggingTier(HostTier):
        def __init__(self):
            super().__init__(capacity)
            self.lanes_in, self.lanes_out, self.promoted = [], [], []

        def put_lane(self, sp):
            ok = super().put_lane(sp)
            if ok:
                self.lanes_in.append(len(sp.blocks or ()))
            return ok

        def pop_lane(self, rid):
            sp = super().pop_lane(rid)
            if sp is not None:
                self.lanes_out.append(len(sp.blocks or ()))
            return sp

        def pop_block(self, key):
            payload = super().pop_block(key)
            if payload is not None:
                self.promoted.append((key, payload))
            return payload

    return LoggingTier()


def promotion_check(torch, tier, checked: list):
    """A ``serve(after_step=)`` hook: each prefix block ``tier`` promoted
    in the step must be indexed on the card and hold, bitwise, the payload
    the tier kept for it (the bytes read when the block was reclaimed);
    its key goes to ``checked``."""
    def after(eng):
        for key, payload in tier.promoted[len(checked):]:
            b = eng.alloc.block_of(key)
            assert b is not None, "a promoted block left the card within its step"
            for name, c in eng.state["cache"].items():
                assert bitwise_equal(torch, c.select(c.dim() - 4, b).cpu(),
                                     payload[name].cpu()), (name, b)
            checked.append(key)
    return after


def promoted_starts(tier, reqs) -> dict:
    """{request index: prefill restart} for each request whose prompt's
    chain holds a key ``tier`` promoted: the end of its last promoted
    block."""
    from repro_torch.serve.paged import prefix_keys

    keys = {k for k, _ in tier.promoted}
    out = {}
    for i, (p, _) in enumerate(reqs):
        ends = [j + 1 for j, k in enumerate(prefix_keys(p, PAGE)) if k in keys]
        if ends:
            out[i] = max(ends) * PAGE
    return out


def prefix_witness(cfg, params, reqs, starts: dict, ec, dev) -> dict:
    """The streams of the requests in ``starts`` on a tierless engine
    (``ec``) whose device prefix cache holds exactly each prompt's first
    ``start`` positions.  A primer of the same length that shares only
    those tokens runs first with a budget of 1: its first chunk writes
    them as the request's own first chunk did (the same chunk program;
    rows up to ``start`` see only those tokens).  Then the request matches
    ``start`` positions on the card, prefills the rest through the
    continuation chunks a promoted chain leads to, and decodes.  Returns
    {index: stream}."""
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, ec, device=dev)

    def drain():
        while eng.has_work():
            eng.step()
            eng.check_invariants()

    for i, s in starts.items():
        primer = reqs[i][0].copy()
        primer[s:] = (primer[s:] + 1) % cfg.vocab
        eng.submit(primer, max_new_tokens=1)
    drain()
    hits = eng.counters["prefix_hit_tokens"]
    rids = {i: eng.submit(reqs[i][0], max_new_tokens=reqs[i][1]) for i in starts}
    drain()
    assert eng.counters["prefix_hit_tokens"] - hits == sum(starts.values()), eng.counters
    assert eng.counters["preemptions"] == 0, eng.counters
    return {i: list(eng.completions[r].tokens) for i, r in rids.items()}


def plain_copy_rates(torch, dev, nbytes: int) -> dict:
    """GB/s of one plain ``copy_`` of ``nbytes`` between a pinned host buffer
    and the card, each way (median of ``COPY_ITERS``, synchronized)."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out = {}
    for name, dst, src in (("d2h", host, card), ("h2d", card, host)):
        ms = []
        for _ in range(COPY_ITERS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            dst.copy_(src, non_blocking=True)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        out[name] = dict(ms=float(np.median(ms)), gb_per_s=nbytes / float(np.median(ms)) / 1e6)
    return out


def timed(torch, fn, iters: int = COPY_ITERS) -> tuple[dict, object]:
    """Host ms of ``fn()``, synchronized before and after: the first call
    (new pinned buffers, for a read) and the median of ``iters`` more."""
    ms, out = [], None
    for _ in range(iters + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return dict(first_ms=ms[0], ms=float(np.median(ms[1:]))), out


def transport_rates(torch, cfg, state, blocks: int, *, per_block: bool = False) -> dict:
    """The tier's paged transport alone, on a drained engine's pool:
    ``blocks`` blocks read to pinned host memory (one gather a leaf, one
    synchronize: a lane spill) and written back (one copy a leaf: a
    restore), and written back from the same payloads one block a copy
    (``write_rows``: payloads that are not rows of one buffer), host ms
    and GB/s; the plain pinned ``copy_`` of the same bytes each way; with
    ``per_block``, the read one block a call (a synchronize each: the
    reference's fetch, and each reclaimed prefix block's)."""
    from repro_torch.serve import paged_block_read_program, paged_block_write_program

    read, write = paged_block_read_program(cfg), paged_block_write_program(cfg)
    ids = list(range(1, blocks + 1))
    out = {}
    out["read"], payloads = timed(torch, lambda: read(state, ids))
    out["write"], _ = timed(torch, lambda: write(state, payloads, ids))
    out["write_rows"], _ = timed(torch, lambda: write(state, payloads[::-1], ids[::-1]))
    if per_block:
        out["read_per_block"], _ = timed(torch, lambda: [read(state, [b]) for b in ids])
    nbytes = sum(int(a.nbytes) for p in payloads for a in p.values())
    for r in out.values():
        r["gb_per_s"] = nbytes / r["ms"] / 1e6
    dev = next(iter(state["cache"].values())).device
    out.update(blocks=blocks, bytes=nbytes, plain=plain_copy_rates(torch, dev, nbytes))
    return out


def lane_copies(torch, cfg, state, tier, bb: int) -> dict:
    """Each lane spill's and restore's blocks and bytes (``tier``'s log),
    and the transport alone at every size among them (``transport_rates``:
    a spill is a read, a restore a write); the read one block a call at
    the largest."""
    sizes = sorted(set(tier.lanes_in) | set(tier.lanes_out))
    rates = {n: transport_rates(torch, cfg, state, n, per_block=n == sizes[-1]) for n in sizes}
    return dict(spill_blocks=tier.lanes_in, restore_blocks=tier.lanes_out, block_bytes=bb,
                transport={str(n): r for n, r in rates.items()})


def tier_counters(eng, bb: int) -> dict:
    c = dict(eng.counters)
    c["spilled_blocks"], c["restored_blocks"] = c["spilled_bytes"] // bb, c["restored_bytes"] // bb
    assert c["spilled_bytes"] % bb == 0 == c["restored_bytes"] % bb, (c, bb)
    return {k: c[k] for k in TIER_KEYS}


def dense_launch_kernels():
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add

    return (flash_attention, paged_attention, rmsnorm, rmsnorm_add)


def hold_park_snapshot(torch, cfg, params, reqs, dev, want, mesh=None) -> dict:
    """Phase 3h on phase 3's engine with a tier and ``park_idle_s`` on a
    StepClock: a lane held and released in place (no restore), a lane held
    past the threshold (it parks, its lane refills, its release restores
    with no replay), ``save_snapshot`` mid-run and ``restore_snapshot`` into
    a fresh engine sharing the program cache (drained there), and two
    requests exported to a third engine sharing cache and tier (drained
    there).  Every stream, wherever it finishes, is phase 3's bitwise.  On
    a ``mesh`` (phase 3p) every engine is a mesh engine, reading the
    StepClock through its ``MeshClock``, and the paged decode launches the
    block-range entry."""
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.kernels.paged_attention.ops import paged_attention_range
    from repro_torch.serve import EngineConfig, HostTier, ServeEngine

    kernels = dense_launch_kernels() + ((paged_attention_range,) if mesh is not None else ())
    ec = EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN, kv_layout="paged", page_size=PAGE,
                      paged_attn="kernel", host_tier=True, park_idle_s=PARK_STEPS)
    tier = HostTier()
    work = ("prefill_chunks", "prefill_first_chunks", "decode_steps")

    def engine(**kw):
        return ServeEngine(cfg, params, ec, device=dev, clock=StepClock(), mesh=mesh, **kw)

    def tick(eng):
        getattr(eng.clock, "base", eng.clock).t += 1.0     # a mesh engine's MeshClock

    def decoding(eng):
        return [s.rid for s in eng.slots if s is not None and s.generated >= 1 and not s.held]

    def drain(eng):
        while eng.has_work():
            eng.step()
            eng.check_invariants()
            tick(eng)
        return {r: list(c.tokens) for r, c in eng.completions.items() if c.status == "ok"}

    a = engine(host_tier=tier)
    a.prebuild()
    built = a.stats["builds"]
    for k in kernels:
        k.launches = 0
    rids = [a.submit(p, max_new_tokens=b) for p, b in reqs]
    out, done, other_work = dict(events=[]), {}, dict.fromkeys(work, 0)
    kept = parked = park_release = None
    step = 0
    t0 = time.perf_counter()
    while a.has_work():
        if step == 4:
            kept = decoding(a)[0]
            before = (a.counters["restores"], a.counters["spills"])
            assert a.hold(kept)
        if step == 6:                   # held 2 steps: under the park threshold
            a.release(kept)
            assert (a.counters["restores"], a.counters["spills"]) == before, a.counters
            out["events"].append(dict(step=step, held_in_place=kept))
        if step == 10:
            parked = decoding(a)[-1]
            lane = a._find_lane(parked)
            assert a.hold(parked)
        if parked is not None and parked in a.parked and a.slots[lane] is not None:
            # parked, and its lane refilled from the queue
            park_release = (a.counters["restores"], a.counters["replayed_tokens"])
            out["events"].append(dict(step=step, parked=parked, refilled_by=a.slots[lane].rid))
            a.release(parked)
            parked = None
        if step == 20:
            with tempfile.TemporaryDirectory() as tmp:
                mgr = CheckpointManager(tmp)
                a.save_snapshot(mgr, step)
                b = engine(aot=a.aot)
                assert b.restore_snapshot(mgr) == step
            start = {k: b.counters[k] for k in work}
            restored = drain(b)
            for k in work:
                other_work[k] += b.counters[k] - start[k]
            out["snapshot"] = dict(step=step, graphs=b.stats["graphs"], counters={
                k: b.counters[k] for k in ("prefills", "decode_steps", "replayed_tokens",
                                           "snapshot_restores")})
            assert b.stats["graphs"] == 1, b.stats
            assert all(restored.get(r) == want[r] for r in rids), "restored streams diverged"
            del b
        if step == 24:
            c = engine(aot=a.aot, host_tier=tier)
            moved = [decoding(a)[0], next(r.rid for r in a.queue if not r.resume)]
            for r in moved:
                snap = json.loads(json.dumps(a.export_request(r)))
                c.import_request(snap, front=snap["pending"]["resume"])
            done.update(drain(c))
            for k in work:
                other_work[k] += c.counters[k]
            out["migration"] = dict(step=step, moved=moved, graphs=c.stats["graphs"], counters={
                k: c.counters[k] for k in ("imported", "restores", "prefills",
                                           "replayed_tokens")})
            assert sorted(done) == sorted(moved) and c.counters["restores"] == 1, out
            assert c.stats["graphs"] == 1, c.stats
            del c
        a.step()
        a.check_invariants()
        tick(a)
        step += 1
        assert step < 2000
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    done.update(drain(a))
    launches = {k.__name__: k.launches for k in kernels}
    total = {k: a.counters[k] + other_work[k] for k in work}
    want_launches = {"flash_attention": N_LAYERS * total["prefill_first_chunks"],
                     "paged_attention": N_LAYERS * total["decode_steps"],
                     **dense_norms(total["prefill_chunks"], total["decode_steps"])}
    if mesh is not None:
        want_launches.update(paged_attention=0,
                             paged_attention_range=N_LAYERS * total["decode_steps"])
    bad = [r for r in rids if done.get(r) != want[r]]
    out.update(launches=launches, work=total, builds=a.aot.stats["builds"], diverged=bad,
               park_release=park_release, counters={k: a.counters[k] for k in (
                   "holds", "releases", "parked", "spills", "restores", "replayed_tokens",
                   "exported", "prefills", "decode_steps")})
    log(f"3h hold/park/snapshot/migration: {json.dumps(out)}")
    assert not bad and park_release is not None, out
    assert launches == want_launches, (launches, want_launches)
    assert a.aot.stats["builds"] == built and a.stats["graphs"] == 1, out
    assert a.counters["holds"] == 2 == a.counters["releases"] and a.counters["parked"] == 1
    assert a.counters["restores"] == park_release[0] + 1, out
    assert a.counters["replayed_tokens"] == park_release[1] == 0, out
    assert a.counters["exported"] == 2, out
    return out


def tier_path(torch, dev, results):
    """Phases 3f-3i on full-width smollm-360m (seed-0 weights, bf16, the
    kernel path).  Returns each phase's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import EngineConfig

    base = get_config("smollm-360m")
    cfg = dataclasses.replace(base, attn_impl="kernel")
    params = lm.init(cfg, seed=0, device=dev)
    bb = block_bytes(cfg)
    phase3, want3 = requests(cfg.vocab), results["phase3_streams"]
    out, launches = {}, {}

    # 3f: preempt admission (phase 3c) with the tier: resumes restore by copy
    tier = logging_tier()
    f, streams_f, _, eng = feature_run(
        torch, cfg, params, phase3, feature_engine(prefill_chunk=0, prefix_cache=False,
                                                   host_tier=True), dev, host_tier=tier)
    f["tier_counters"] = tc = tier_counters(eng, bb)
    f["host_tier"] = eng.stats["host_tier"]
    f["copies"] = lane_copies(torch, cfg, eng.state, tier, bb)
    f["tokens_per_s_3c"] = results["features"]["3c"]["tokens_per_s"]
    del eng
    same = [i for i, (x, y) in enumerate(zip(streams_f, want3)) if x == y]
    f["identical_to_phase3"] = len(same)
    log(f"3f tier on preempt admission: {f['tokens']} tokens in {f['wall_s']:.3f} s = "
        f"{f['tokens_per_s']:.1f} tok/s (3c {f['tokens_per_s_3c']:.1f}); {json.dumps(f)}")
    assert len(same) == len(phase3), f
    assert tc["spills"] >= 1 and tc["restores"] >= 1, tc
    assert tc["prefills"] == len(phase3) + tc["resumed"] - tc["restores"], tc
    assert f["launches"]["flash_attention"] == N_LAYERS * tc["prefills"], f
    if tc["resumed"] == tc["restores"]:
        assert tc["replayed_tokens"] == 0, tc
    assert tc == TIER_3F, (tc, TIER_3F)
    assert sum(tier.lanes_in) == tc["spilled_blocks"], (tier.lanes_in, tc)
    out["3f"], launches["3f"] = f, f["launches"]

    # 3g: phase 3b's engine with a bounded tier: prefix spills and promotions
    reqs_b = feature_requests(cfg.vocab)
    tier, checked = logging_tier(TIER_3G_BLOCKS), []
    ec_b = feature_engine(host_tier=True, host_tier_blocks=TIER_3G_BLOCKS)
    g, streams_g, _, eng = feature_run(torch, cfg, params, reqs_b, ec_b, dev, host_tier=tier,
                                  after_step=promotion_check(torch, tier, checked))
    g["tier_counters"] = tc = tier_counters(eng, bb)
    g["host_tier"] = eng.stats["host_tier"]
    g["copies"] = lane_copies(torch, cfg, eng.state, tier, bb)
    g["tokens_per_s_3b"] = results["features"]["3b"]["tokens_per_s"]
    del eng
    # every promoted block held its spilled payload bitwise (promotion_check)
    g["promotions_checked"] = len(checked)
    # a request that re-admits on a promoted chain restarts its prefill
    # where the chain ends, where 3b restarted at 0: its first chunk's
    # remaining positions come from a continuation (chunked_attention) in
    # place of flash.  Its witness is a tierless engine whose device cache
    # holds the same chain (prefix_witness); every other stream is 3b's
    starts = promoted_starts(tier, reqs_b)
    witness = prefix_witness(cfg, params, reqs_b, starts, feature_engine(), dev)
    want_b = results["phase3b_streams"]
    want_g = [witness.get(i, w) for i, w in enumerate(want_b)]
    bad = [i for i, (x, y) in enumerate(zip(streams_g, want_g)) if x != y]
    g.update(promoted_starts={str(i): s for i, s in starts.items()}, diverged=bad,
             identical_to_phase3b=sum(x == y for x, y in zip(streams_g, want_b)),
             promoted_against_3b={str(i): agreement([streams_g[i]], [want_b[i]])
                                  for i in starts})
    log(f"3g tier on phase 3b's engine ({TIER_3G_BLOCKS} host blocks): {g['tokens']} tokens in "
        f"{g['wall_s']:.3f} s = {g['tokens_per_s']:.1f} tok/s (3b {g['tokens_per_s_3b']:.1f}); "
        f"{json.dumps(g)}")
    assert not bad, g
    assert len(checked) == tc["host_prefix_hits"], (len(checked), tc)
    assert starts == TIER_3G_PROMOTED, (starts, TIER_3G_PROMOTED)
    for k in ("prefix_spills", "host_prefix_hits", "restores"):
        assert tc[k] > 0, (k, tc)
    assert tc == TIER_3G, (tc, TIER_3G)
    out["3g"], launches["3g"] = g, g["launches"]

    # 3h: hold, park, snapshot and migration on phase 3's engine
    t = time.perf_counter()
    out["3h"] = hold_park_snapshot(torch, cfg, params, phase3, dev, want3)
    out["3h"]["seconds"] = time.perf_counter() - t
    launches["3h"] = out["3h"]["launches"]

    # 3i: phase 3's engine with host sampling
    kernels = dense_launch_kernels()
    for k in kernels:
        k.launches = 0
    ec = EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN, kv_layout="paged", page_size=PAGE,
                      paged_attn="kernel", fused_sampling=False)
    eng, rids, steps, prefilled, wall = serve(torch, cfg, params, phase3, ec, dev, check=True,
                                              prebuild=True)
    st = eng.stats
    li = {k.__name__: k.launches for k in kernels}
    streams_i = [list(eng.completions[r].tokens) for r in rids]
    tokens = sum(len(s) for s in streams_i)
    decode_only = [t for t, p in zip(steps, prefilled) if not p]
    i = dict(tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
             tokens_per_s_phase3=results["main_path"]["tokens_per_s"],
             decode_step_ms_median=float(np.median(decode_only)),
             decode_step_ms_median_phase3=results["main_path"]["decode_step_ms_median"],
             logits_bytes_per_step=MAX_SLOTS * cfg.vocab * 4, prefills=st["prefills"],
             decode_steps=st["decode_steps"], graphs=st["graphs"], builds=st["builds"],
             launches=li, identical_to_phase3=sum(x == y for x, y in zip(streams_i, want3)))
    log(f"3i host sampling: {tokens} tokens in {wall:.3f} s = {i['tokens_per_s']:.1f} tok/s "
        f"(phase 3 {i['tokens_per_s_phase3']:.1f}); {json.dumps(i)}")
    assert i["identical_to_phase3"] == len(phase3), i
    assert st["graphs"] == 1, st
    assert li == feature_launches(st), (li, st)
    del eng
    out["3i"], launches["3i"] = i, li
    results["tier"] = out
    del params
    return launches


# ---------------------------------------------------------------------------
# Phases 3j-3l and 5d: speculative decoding
# ---------------------------------------------------------------------------

SPEC_K = 3                    # draft proposals a lane a round
DRAFT_SEED = 1                # the drafts' fresh init
DRAFT_ALPHA = 0.15            # the dense draft: (1 - a) x phase 3's weights + a x that init
ZAMBA_DRAFT_ALPHA = 0.02      # the zamba draft's mix (the reference's for recurrent state)
SPEC_KEYS = ("spec_steps", "spec_rounds", "spec_drafted", "spec_accepted", "spec_rejected",
             "spec_committed", "spec_draft_prefills", "releases")
SPEC_PROFILE_ROUNDS = 3
SPEC_PROFILE_WINDOWS = 2      # profiler windows of SPEC_PROFILE_ROUNDS rounds each


def laps():
    """``lap(name)`` records the seconds since the previous lap (or since
    ``laps()``) under ``name`` and returns the dict of laps so far."""
    last, out = [time.perf_counter()], {}

    def lap(name):
        now = time.perf_counter()
        out[name], last[0] = now - last[0], now
        return out
    return lap


def start_log_engine():
    """A ``ServeEngine`` that logs where each prefill of a request starts
    (the prompt positions its prefix-cache match covered) and counts the
    resumes a prefix chain restores without a prefill (``chain_restores``).
    It changes nothing the engine computes."""
    from repro_torch.serve import ServeEngine

    class StartLog(ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.starts, self.chain_restores = [], 0

        def _match_prefix(self, slot, prompt):
            start = super()._match_prefix(slot, prompt)
            self.starts.append((self.slots[slot].rid if self.slots[slot] else None, start))
            return start

        def _try_restore(self, slot, req):
            ok = super()._try_restore(slot, req)
            self.chain_restores += ok
            return ok

        def prefill_starts(self, n: int) -> list:
            """[the starts of request i's prefills, in order] for rids 0..n-1."""
            out = [[] for _ in range(n)]
            for rid, start in self.starts:
                out[rid].append(start)
            return out

    return StartLog


def draft_params_for(cfg, params, alpha: float, dev):
    """The phases' draft: the target's config, its weights moved ``alpha``
    toward an init from ``DRAFT_SEED`` (the launcher's ``draft_mix``)."""
    from repro_torch.launch.serve import draft_mix

    return draft_mix(cfg, params, alpha, DRAFT_SEED, dev)


def spec_launches(st) -> dict:
    """What a dense spec run's counters predict of its launches: flash on
    each chunk that starts at 0 and each draft prefill (32 layers each),
    paged attention on each of a round's ``SPEC_K + 1`` verify steps, the
    norms on each chunk and draft prefill and on each of a round's
    ``2 (SPEC_K + 1)`` decode steps (the draft's and the verify ladder's)."""
    steps = (SPEC_K + 1) * st["spec_steps"]
    return {"flash_attention": N_LAYERS * (st["prefill_first_chunks"] + st["spec_draft_prefills"]),
            "paged_attention": N_LAYERS * steps,
            **dense_norms(st["prefill_chunks"] + st["spec_draft_prefills"], 2 * steps)}


def spec_identities(eng) -> dict:
    """The counter identities of a spec run whatever the draft accepts:
    one round a decode step; one draft prefill for each completed prefill,
    tier restore, prefix-chain restore and release (``start_log_engine``
    counts the chain restores); ``SPEC_K`` drafted a lane-round when no
    lane replays; at least one token committed a lane-round."""
    st = eng.stats
    chain = getattr(eng, "chain_restores", 0)
    out = dict(spec_steps=st["spec_steps"], decode_steps=st["decode_steps"],
               draft_prefills=st["spec_draft_prefills"], prefills=st["prefills"],
               restores=st["restores"], chain_restores=chain, releases=st["releases"])
    assert st["spec_steps"] == st["decode_steps"] > 0, out
    assert st["spec_draft_prefills"] == st["prefills"] + st["restores"] + chain \
        + st["releases"], out
    assert 0 <= st["spec_accepted"] <= st["spec_drafted"], st
    assert st["spec_committed"] >= st["spec_rounds"], st
    if st["replayed_tokens"] == 0:
        assert st["spec_drafted"] == SPEC_K * st["spec_rounds"], st
    return out


def spec_figures(st) -> dict:
    return dict(spec_acceptance_rate=st["spec_acceptance_rate"],
                tokens_per_decode_dispatch=st["tokens_per_decode_dispatch"],
                **{k: st[k] for k in SPEC_KEYS})


def round_summary(profile: dict) -> dict:
    """A profiled round's headline figures (``profile_spec``)."""
    b = profile["breakdown"]
    return {k: profile.get(k) for k in ("kernel_launches_per_round", "device_ms_per_round",
                                        "replay_host_ms_median", "device_idle_share")} | {
        k: b[k] for k in ("draft_ms", "verify_ms", "rollback_ms")}


def spec_graph_check(torch, cfg, params, dparams, reqs, ec, dev, steps: int = 8, mesh=None):
    """The captured spec graph against the eager spec program, as
    ``graph_check`` holds the decode graph: 8 lanes admitted, the first
    round builds the graph, then ``steps`` rounds each run the eager
    program on a deep clone of the state and replay the graph on the state
    itself.  The rows and every leaf (the draft's cache, its snapshots and
    ``keep`` included) must be bitwise equal.  On a ``mesh`` the graph
    holds both mesh programs' collectives (the draft's and the target's).
    Returns (figures, the engine, its lanes still decoding, for
    ``profile_spec``)."""
    from repro_torch.core.aot import CudaGraphProgram
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, ec, device=dev, draft_params=dparams, mesh=mesh)
    for p, b in reqs[:MAX_SLOTS]:
        eng.submit(p, max_new_tokens=b)
    while eng.counters["decode_steps"] < 1:
        eng.step()
    flags = dict(stochastic=False, masked=False)
    graph = eng._spec_entry(**flags)
    assert isinstance(graph, CudaGraphProgram), type(graph)
    assert eng.stats["graphs"] == 1, eng.stats
    eager = eng.spec_program(**flags)
    bad = []

    def checked(params, dparams, state):
        step = graph.replays
        clone = clone_state(torch, state)
        want = eager(params, dparams, clone)
        got = graph(params, dparams, state)
        torch.cuda.synchronize()
        if not bitwise_equal(torch, got, want):
            bad.append((step, "rows"))
        bad.extend((step, name) for (name, a), (_, b) in zip(state_leaves(torch, state),
                                                            state_leaves(torch, clone))
                   if not bitwise_equal(torch, a, b))
        return got

    eng._spec_entry = lambda **flags: checked
    try:
        for _ in range(steps):
            eng.step()
    finally:
        del eng._spec_entry         # the engine's own method again
    out = dict(steps=steps, lanes=MAX_SLOTS, replays=graph.replays, mismatches=bad,
               leaves=len(list(state_leaves(torch, eng.state))),
               graph_build_s=list(eng.graphs.build_seconds.values())[0],
               launches_counted_per_replay=[(c.__name__, n) for c, n in graph.launches])
    log(f"spec graph check: {json.dumps(out)}")
    assert not bad and graph.replays == steps, out
    return out, eng


def spec_breakdown(torch, eng, iters: int = 3) -> dict:
    """Where a round's device time goes, each part timed alone
    (``device_profile``) on a deep clone of the engine's state: one draft
    decode step and one verify step, each times the round's ``SPEC_K + 1``,
    and the recurrent snapshots and rollbacks of both sides (none for a KV
    model: rejected positions are truncated, no work).  Also the draft
    step's largest device kernels (its attention runs plain over
    ``max_len`` positions a lane: no kernel)."""
    from repro_torch.models import registry

    e = eng.econ
    cfg, dcfg = eng.cfg, e.spec_draft
    mod, dmod = registry.get_module(cfg), registry.get_module(dcfg)
    st = clone_state(torch, eng.state)
    tok, lengths, mask = st["tokens"], st["lengths"], st["active"]
    bufs = st["spec"]

    def draft():
        dmod.decode_step(dcfg, eng.draft_params, st["draft"], tok, lengths)

    def verify():
        if eng.paged:
            mod.decode_step_paged(cfg, eng.params, st["cache"], tok, lengths, st["tables"],
                                  impl=e.paged_attn)
        else:
            mod.decode_step(cfg, eng.params, st["cache"], tok, lengths)

    def rollback():
        # the spec program's snapshot, select and freeze traffic, both sides
        rec, drec, cache, dcache = eng.rec, eng._draft_rec, st["cache"], st["draft"]
        if rec:
            rec.snapshot(cache, bufs["keep"])
            for _ in range(SPEC_K + 1):
                rec.rollback(bufs["keep"], cache, mask)
            rec.snapshot(bufs["keep"], cache)
            rec.freeze(cache, mask)
        if drec:
            dst = bufs["dstates"]
            for i in range(SPEC_K):
                drec.snapshot(dcache, {n: b[i] for n, b in dst.items()})
            sel = {n: b[0] for n, b in dst.items()}
            for j in range(1, SPEC_K):
                drec.rollback(sel, {n: b[j] for n, b in dst.items()}, mask)
            drec.rollback(dcache, sel, mask)
            drec.freeze(dcache, mask)

    draft_ms, draft_kernels = device_profile(torch, draft, iters)
    verify_ms = device_ms(torch, verify, iters)
    per_round = lambda ms: None if ms is None else ms * (SPEC_K + 1)
    out = dict(draft_step_ms=draft_ms, verify_step_ms=verify_ms,
               draft_ms=per_round(draft_ms), verify_ms=per_round(verify_ms),
               rollback_ms=device_ms(torch, rollback, iters) if (eng.rec or eng._draft_rec)
               else 0.0,
               draft_step_top=sorted(({"name": k[:80], "ms_per_step": v["ms"],
                                       "calls_per_step": v["calls"]}
                                      for k, v in draft_kernels.items()),
                                     key=lambda d: -d["ms_per_step"])[:6])
    del st
    return out


def profiled(torch, run) -> list:
    """The device kernels (``key_averages`` entries) ``run()`` launched,
    recorded by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type.name == "CUDA"]


def profile_spec(torch, eng, steps: int = SPEC_PROFILE_ROUNDS, breakdown: bool = True):
    """Profiled spec rounds on ``eng`` (``spec_graph_check``'s engine, its
    lanes mid-decode), as ``profile_decode`` profiles a decode step: rounds
    timed unprofiled, then profiled (``torch.profiler``: launches, device
    ms, idle share against the unprofiled time); the port's kernels in the
    profiled replays equal, wrapper by wrapper, the launches the graph adds
    on each replay; the host ms of one replay alone; and the round's
    breakdown (``spec_breakdown``).  The card's profiler now and then drops
    a chunk of a window's records, the more the larger the window
    (``scripts/profiler_window_study.py``), so ``SPEC_PROFILE_WINDOWS``
    windows of ``steps`` rounds each are recorded; a replay launches the
    same kernels every round, so the launches and device time come from
    the most complete window (the most records).  ``breakdown=False``
    leaves the breakdown out (None)."""
    lap = laps()
    lanes = sum(s is not None for s in eng.slots)
    rounds0 = eng.counters["decode_steps"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t) * 1e3 / steps
    windows = [profiled(torch, lambda: [eng.step() for _ in range(steps)])
               for _ in range(SPEC_PROFILE_WINDOWS)]
    kernels = max(windows, key=lambda w: sum(e.count for e in w))
    assert eng.counters["decode_steps"] == rounds0 + (1 + SPEC_PROFILE_WINDOWS) * steps \
        and not eng.queue, eng.counters
    replay = eng._spec_entry(stochastic=False, masked=False)
    counted = {c.__name__: n for c, n in replay.launches}
    replay_ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        replay(eng.params, eng.draft_params, eng.state)
        replay_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    lap("rounds")
    out = dict(rounds=steps, lanes=lanes, round_ms_unprofiled=round_ms,
               replay_host_ms=replay_ms, replay_host_ms_median=float(np.median(replay_ms)),
               counted_launches_per_replay=counted,
               breakdown=spec_breakdown(torch, eng) if breakdown else None)
    out["seconds"] = lap("breakdown")
    if kernels:
        # on a mesh the paged verify steps launch the block-range entry
        measured = replay_launches(windows, steps, paged=next(
            (n for n in counted if n.startswith("paged_attention")), "paged_attention"))
        assert measured == counted, (measured, counted)
        total_us = sum(e.self_device_time_total for e in kernels)
        out.update(device_ms_per_round=total_us / 1e3 / steps,
                   launches_per_window=[sum(e.count for e in w) for w in windows],
                   device_idle_share=1 - total_us / 1e3 / steps / round_ms,
                   kernel_launches_per_round=sum(e.count for e in kernels) / steps,
                   replay_launches_per_round=measured,
                   top=[dict(name=e.key[:80], calls_per_round=e.count / steps,
                             ms_per_round=e.self_device_time_total / 1e3 / steps)
                        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]])
    else:
        log("spec profile: torch.profiler recorded no device activity (not measured)")
    log(f"spec round profile: {json.dumps(out)}")
    return out


def spec_path(torch, dev, results):
    """Phases 3j-3l on full-width smollm-360m (seed-0 weights, bf16, the
    kernel path) with speculative decoding, ``SPEC_K`` 3 and a draft of
    the same config moved ``DRAFT_ALPHA`` toward an init from seed 1.
    Returns each phase's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import EngineConfig

    lap = laps()
    base = get_config("smollm-360m")
    cfg = dataclasses.replace(base, attn_impl="kernel")
    params = lm.init(cfg, seed=0, device=dev)
    dparams = draft_params_for(cfg, params, DRAFT_ALPHA, dev)
    lap("weights")
    phase3, want3 = requests(cfg.vocab), results["phase3_streams"]
    spec = dict(spec_draft=cfg, spec_k=SPEC_K)
    out, launches = {}, {}

    # 3j: phase 3's engine with speculation
    ec = EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN, kv_layout="paged", page_size=PAGE,
                      paged_attn="kernel", **spec)
    graph, checked = spec_graph_check(torch, cfg, params, dparams, phase3, ec, dev)
    lap("3j graph check")
    profile = profile_spec(torch, checked)
    del checked
    lap("3j profile")
    kernels = dense_launch_kernels()
    for k in kernels:
        k.launches = 0
    eng, rids, steps, prefilled, wall = serve(torch, cfg, params, phase3, ec, dev, check=True,
                                              draft_params=dparams)
    st = eng.stats
    lj = {k.__name__: k.launches for k in kernels}
    streams = [list(eng.completions[r].tokens) for r in rids]
    tokens = sum(len(x) for x in streams)
    decode_only = [t for t, p in zip(steps, prefilled) if not p]
    j = dict(tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
             tokens_per_s_phase3=results["main_path"]["tokens_per_s"],
             round_ms_median=float(np.median(decode_only)),
             decode_step_ms_median_phase3=results["main_path"]["decode_step_ms_median"],
             identical_to_phase3=sum(x == y for x, y in zip(streams, want3)),
             launches=lj, identities=spec_identities(eng), **spec_figures(st),
             graph_check=graph)
    assert lj == spec_launches(st), (lj, spec_launches(st), st)
    j["programs"] = program_builds(eng, phase3, per_bucket=2)
    j["profile"] = profile
    del eng
    lap("3j run")
    card = results["nvidia_smi"]
    rounds = round_summary(profile)
    log(f"3j spec on phase 3's engine (k {SPEC_K}, alpha {DRAFT_ALPHA}) [{card}]: {tokens} "
        f"tokens in {wall:.3f} s = {j['tokens_per_s']:.1f} tok/s (phase 3 "
        f"{j['tokens_per_s_phase3']:.1f}); acceptance {j['spec_acceptance_rate']:.4f}, tokens a "
        f"lane a round {j['tokens_per_decode_dispatch']:.4f}; a round {json.dumps(rounds)}; "
        f"{json.dumps(j)}")
    assert j["identical_to_phase3"] == len(phase3), j
    out["3j"], launches["3j"] = j, lj

    # 3k: 3f's engine (3c's tight pool, preempt admission, the host tier)
    # with speculation: preemptions land mid-round, resumes restore by copy
    # and rebuild the draft by one draft prefill
    ec_k = feature_engine(prefill_chunk=0, prefix_cache=False, host_tier=True, **spec)
    k, streams_k, _, eng = feature_run(torch, cfg, params, phase3, ec_k, dev,
                                       predict=spec_launches, draft_params=dparams)
    k["identities"] = spec_identities(eng)
    k.update(spec_figures(eng.stats), tokens_per_s_3f=results["tier"]["3f"]["tokens_per_s"],
             identical_to_phase3=sum(x == y for x, y in zip(streams_k, want3)))
    del eng
    c = k["counters"]
    log(f"3k spec on 3f's engine [{card}]: {k['tokens']} tokens in {k['wall_s']:.3f} s = "
        f"{k['tokens_per_s']:.1f} tok/s (3f {k['tokens_per_s_3f']:.1f}); acceptance "
        f"{k['spec_acceptance_rate']:.4f}, tokens a lane a round "
        f"{k['tokens_per_decode_dispatch']:.4f}; a round (3j's program and shapes) "
        f"{json.dumps(rounds)}; {json.dumps(k)}")
    assert k["identical_to_phase3"] == len(phase3), k
    assert c["preemptions"] > 0 and c["replayed_tokens"] == 0, c
    assert c["prefills"] == len(phase3) and c["resumed"] == k["identities"]["restores"], k
    out["3k"], launches["3k"] = k, k["launches"]
    lap("3k")

    # 3l: 3b's engine (chunked prefill, the prefix cache, preemption) with
    # speculation, the invariants (no overshoot in a shared block) after
    # every step.  A request whose prefills start where they started in 3b
    # (the same set of starts; a resume may re-prefill from the same start
    # once more or less) must give 3b's stream; one whose start moved
    # (speculation changes when prefix hits happen) its prefix witness's at
    # its first start
    reqs_b = feature_requests(cfg.vocab)
    l_, streams_l, status_l, eng = feature_run(
        torch, cfg, params, reqs_b, feature_engine(**spec), dev, predict=spec_launches,
        draft_params=dparams, engine_cls=start_log_engine())
    lap("3l run")
    l_["identities"] = spec_identities(eng)
    l_.update(spec_figures(eng.stats))
    starts_l, starts_b = eng.prefill_starts(len(reqs_b)), results["phase3b_starts"]
    del eng
    moved = {i: s[0] for i, (s, sb) in enumerate(zip(starts_l, starts_b)) if set(s) != set(sb)}
    witness = prefix_witness(cfg, params, reqs_b, moved, feature_engine(), dev) if moved else {}
    want_l = [witness.get(i, w) for i, w in enumerate(results["phase3b_streams"])]
    bad = [i for i, (x, y) in enumerate(zip(streams_l, want_l)) if x != y]
    l_.update(tokens_per_s_3b=results["features"]["3b"]["tokens_per_s"],
              moved_starts={str(i): [starts_b[i], starts_l[i]] for i in moved}, diverged=bad,
              statuses=status_l)
    log(f"3l spec on 3b's engine [{card}]: {l_['tokens']} tokens in {l_['wall_s']:.3f} s = "
        f"{l_['tokens_per_s']:.1f} tok/s (3b {l_['tokens_per_s_3b']:.1f}); acceptance "
        f"{l_['spec_acceptance_rate']:.4f}, tokens a lane a round "
        f"{l_['tokens_per_decode_dispatch']:.4f}; a round (3j's program and shapes) "
        f"{json.dumps(rounds)}; {json.dumps(l_)}")
    assert status_l == ["ok"] * len(reqs_b), status_l
    assert not bad, l_
    out["3l"], launches["3l"] = l_, l_["launches"]
    out["seconds"] = lap("3l witness")
    results["spec"] = out
    del params, dparams
    return launches


def zamba_spec(torch, cfg, params, reqs, ec, dev, want, tokens_per_s: float,
               card: str = "") -> dict:
    """Phase 5d: phase 5's engine with speculative decoding (``SPEC_K`` 3, a
    zamba draft moved ``ZAMBA_DRAFT_ALPHA`` toward an init from seed 1):
    both sides roll their recurrent leaves back through the snapshot
    buffers.  After ``ZAMBA_PREEMPT_AFTER`` rounds the host preempts the
    last two occupied lanes, as 5b does, mid-speculation; their resumes
    re-prefill, rebuild the draft and replay.  Every stream must equal
    phase 5's (``want``) bitwise, with the invariants after every step
    (the draft's dead recurrent lanes zero after every round included),
    the graph check, builds flat after ``prebuild`` and the launches the
    counters predict.  Prints the snapshot buffers' bytes."""
    from repro_torch.core.tree import leaves
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add, rmsnorm_gated
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.serve import ServeEngine

    kernels = (flash_attention, ssd, rmsnorm, rmsnorm_add, rmsnorm_gated)
    lap = laps()
    dparams = draft_params_for(cfg, params, ZAMBA_DRAFT_ALPHA, dev)
    sec = dataclasses.replace(ec, spec_draft=cfg, spec_k=SPEC_K)
    lap("weights")
    graph, checked = spec_graph_check(torch, cfg, params, dparams, reqs, sec, dev)
    lap("graph check")
    profile = profile_spec(torch, checked)
    del checked
    lap("profile")
    eng = ServeEngine(cfg, params, sec, device=dev, draft_params=dparams)
    eng.prebuild()
    lap("engine")
    built = eng.stats["builds"]
    bufs = eng.state["spec"]
    snapshot_bytes = sum(t.numel() * t.element_size()
                         for t in leaves({"keep": bufs["keep"], "dstates": bufs["dstates"]}))
    rids = [eng.submit(p, max_new_tokens=b) for p, b in reqs]
    for k in kernels:
        k.launches = 0
    victims, swept = None, 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.has_work():
        eng.step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.check_invariants()
        if victims is None and eng.counters["decode_steps"] >= ZAMBA_PREEMPT_AFTER:
            lanes = [i for i, s in enumerate(eng.slots) if s is not None][-2:]
            victims = [eng.slots[i].rid for i in lanes]
            for i in lanes:
                eng.preempt(i)
            eng.check_invariants()
        swept += time.perf_counter() - t
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - swept
    launches = {k.__name__: k.launches for k in kernels}
    st = eng.stats
    got = [list(eng.completions[r].tokens) for r in rids]
    predicted = zamba_launches(st["prefills"] + st["spec_draft_prefills"],
                               2 * (SPEC_K + 1) * st["spec_steps"])
    out = dict(victims=victims, identical_to_phase5=sum(x == y for x, y in zip(got, want)),
               tokens=sum(len(x) for x in got), wall_s=wall,
               tokens_per_s=sum(len(x) for x in got) / wall, tokens_per_s_phase5=tokens_per_s,
               snapshot_buffer_bytes=snapshot_bytes, launches=launches,
               identities=spec_identities(eng), **spec_figures(st), graph_check=graph,
               graphs=st["graphs"], builds=st["builds"],
               counters={k: st[k] for k in ("prefills", "decode_steps", "preemptions",
                                            "resumed", "replayed_tokens")})
    draft_zero = eng._draft_rec.lanes_are_zero(eng.state["draft"], range(MAX_SLOTS))
    del eng
    out["profile"] = profile
    out["seconds_by_part"] = lap("run")
    log(f"5d zamba2 spec (k {SPEC_K}, alpha {ZAMBA_DRAFT_ALPHA}, two preemptions) [{card}]: "
        f"{out['tokens']} tokens in {wall:.3f} s = {out['tokens_per_s']:.1f} tok/s (phase 5 "
        f"{tokens_per_s:.1f}); acceptance {out['spec_acceptance_rate']:.4f}, tokens a lane a "
        f"round {out['tokens_per_decode_dispatch']:.4f}; snapshot buffers {snapshot_bytes} B; "
        f"a round {json.dumps(round_summary(profile))}; {json.dumps(out)}")
    assert out["identical_to_phase5"] == len(reqs), out
    assert st["preemptions"] == st["resumed"] == 2 and draft_zero, out
    assert st["graphs"] == 1 and st["builds"] == built, out
    assert launches == predicted, (launches, predicted)
    return out


# ---------------------------------------------------------------------------
# Phases 3m-3n: the router front-end and the observability layer
# ---------------------------------------------------------------------------

ROUTER_REPLICAS = 3
# phase 3m's script, by router tick (after that tick's step): drain replica
# 1 and reinstate it, kill replica 2 (its requests fail over, onto replica
# 1), then stall replica 1 (the health check declares it dead after
# ``stall_budget`` ticks); replica 0 finishes alone
ROUTER_SCRIPT = {4: ("drain", 1), 6: ("reinstate", 1), 8: ("kill", 2), 12: ("stall", 1)}
ROUTER_STALL_BUDGET = 3
# the counters phase 3m must show: what a smoke-width CPU rehearsal of the
# same engine settings, traffic and script gives (the schedule does not
# depend on the values computed: greedy, no EOS, a step clock;
# ``tests/test_torch_router_rehearsal.py`` runs it)
ROUTER_KEYS = ("submitted", "dispatched", "migrated", "failovers", "replicas_dead",
               "stalls_injected", "stalls_detected", "status_ok", "status_timeout",
               "status_cancelled", "status_failed", "status_shed")
REPLICA_KEYS = ("prefills", "decode_steps", "preemptions", "resumed", "replayed_tokens",
                "exported", "imported")
ROUTER_3M = dict(submitted=16, dispatched=37, migrated=5, failovers=16, replicas_dead=2,
                 stalls_injected=0, stalls_detected=1, status_ok=16, status_timeout=0,
                 status_cancelled=0, status_failed=0, status_shed=0)
ROUTER_3M_REPLICAS = [
    dict(prefills=16, decode_steps=119, preemptions=0, resumed=10, replayed_tokens=70,
         exported=0, imported=16),
    dict(prefills=13, decode_steps=8, preemptions=5, resumed=8, replayed_tokens=40,
         exported=5, imported=13),
    dict(prefills=8, decode_steps=8, preemptions=0, resumed=3, replayed_tokens=15,
         exported=0, imported=8)]
TRACE_DIR = HERE / "build" / "chip_smoke"


def param_bytes(tree) -> int:
    """Device bytes of a parameter tree."""
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def param_ptrs(tree) -> list:
    """Every leaf's ``data_ptr()``, in key order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in param_ptrs(tree[k])]
    return [tree.data_ptr()]


def router_memory(torch, cfg, params, ec, dev) -> dict:
    """Device bytes one router of 1 replica and one of ``ROUTER_REPLICAS``
    add: the replicas beyond the first must add their KV pools and no
    weights (they hold replica 0's cast tensors)."""
    import gc

    from repro_torch.serve import Router, RouterConfig

    grown = {}
    for n in (1, ROUTER_REPLICAS):
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        router = Router(cfg, params, ec, RouterConfig(replicas=n), device=dev)
        torch.cuda.synchronize()
        grown[n] = torch.cuda.memory_allocated() - before
        first = router.replicas[0].engine
        weights, kv = param_bytes(first.params), first.kv_reserved_bytes
        shared = all(param_ptrs(h.engine.params) == param_ptrs(first.params)
                     for h in router.replicas)
        del router, first
    extra = grown[ROUTER_REPLICAS] - grown[1]
    out = dict(bytes_one_replica=grown[1], bytes_replicas=grown[ROUTER_REPLICAS],
               bytes_replicas_2_to_n=extra, weight_copy_bytes=weights,
               kv_reserved_bytes_per_replica=kv, params_shared=shared)
    # less than one weight copy from replica 1 to replica n, and within
    # 16 MiB of their KV pools (the scheduling vectors are a few KiB)
    assert shared and extra < weights, out
    assert abs(extra - (ROUTER_REPLICAS - 1) * kv) <= 16 << 20, out
    return out


def router_drive(torch, router, reqs, clock, script: dict) -> tuple:
    """Submit every request at tick 0 and drive the router tick by tick on
    a step clock, applying ``script`` after its ticks and sweeping
    ``check_invariants`` after every tick (taken out of the wall time, as
    in ``serve``).  Returns (rids, wall seconds, ticks)."""
    rids = [router.submit(p, max_new_tokens=b) for p, b in reqs]
    swept = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while router.has_work():
        router.step()
        clock.t += 1.0
        op, idx = script.get(router.tick, (None, None))
        if op == "stall":
            router.replicas[idx].stalled = True
        elif op is not None:
            getattr(router, op)(idx)
        torch.cuda.synchronize()
        t = time.perf_counter()
        router.check_invariants()
        swept += time.perf_counter() - t
        assert router.tick < 5000, "the router failed to drain"
    torch.cuda.synchronize()
    return rids, time.perf_counter() - t0 - swept, router.tick


def router_path(torch, dev, results):
    """Phase 3m: full-width smollm-360m (seed-0 weights, bf16, the kernel
    path) on ``ROUTER_REPLICAS`` replicas of phase 3's engine behind the
    router; phase 3's requests under ``ROUTER_SCRIPT``.  Returns the launch
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import EngineConfig, Router, RouterConfig

    cfg = dataclasses.replace(get_config("smollm-360m"), attn_impl="kernel")
    params = lm.init(cfg, seed=0, device=dev)
    reqs, want = requests(cfg.vocab), results["phase3_streams"]
    ec = EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN, kv_layout="paged",
                      page_size=PAGE, paged_attn="kernel")
    memory = router_memory(torch, cfg, params, ec, dev)
    clock = StepClock()
    router = Router(cfg, params, ec, RouterConfig(replicas=ROUTER_REPLICAS,
                                                  stall_budget=ROUTER_STALL_BUDGET),
                    device=dev, clock=clock)
    router.prebuild()
    built = router.stats["builds"]
    kernels = dense_launch_kernels()
    for k in kernels:
        k.launches = 0
    rids, wall, ticks = router_drive(torch, router, reqs, clock, ROUTER_SCRIPT)
    launches = {k.__name__: k.launches for k in kernels}
    st = router.stats
    comps = [router.completions[r] for r in rids]
    streams = [list(c.tokens) for c in comps]
    engines = [h.engine.stats for h in router.replicas]
    pre = sum(s["prefills"] for s in engines)
    dec = sum(s["decode_steps"] for s in engines)
    tokens = sum(len(s) for s in streams)
    counters = {k: st[k] for k in ROUTER_KEYS}
    replicas = [{k: s[k] for k in REPLICA_KEYS} for s in engines]
    out = dict(replicas=ROUTER_REPLICAS, ticks=ticks, tokens=tokens, wall_s=wall,
               tokens_per_s=tokens / wall,
               tokens_per_s_phase3=results["main_path"]["tokens_per_s"],
               counters=counters, replica_counters=replicas,
               replica_states=st["replica_states"], builds=st["builds"],
               builds_after_prebuild=built, graph_builds=st["graph_builds"],
               graphs=st["graphs"], placements=[router.placements[r] for r in rids],
               launches=launches, memory=memory,
               identical_to_phase3=sum(x == y for x, y in zip(streams, want)))
    log(f"3m router ({ROUTER_REPLICAS} replicas, drain/reinstate/kill/stall): {tokens} tokens "
        f"in {wall:.3f} s = {out['tokens_per_s']:.1f} tok/s (phase 3 "
        f"{out['tokens_per_s_phase3']:.1f}); {json.dumps(out)}")
    bad = [(c.rid, c.status, len(c.tokens), b) for c, (_, b) in zip(comps, reqs)
           if c.status != "ok" or len(c.tokens) != b]
    assert not bad, f"requests not served in full: {bad}"
    assert out["identical_to_phase3"] == len(reqs), out
    assert st["replica_states"] == ["live", "dead", "dead"], out
    assert counters == ROUTER_3M and replicas == ROUTER_3M_REPLICAS, \
        (counters, ROUTER_3M, replicas, ROUTER_3M_REPLICAS)
    # builds flat after prebuild, plus one graph capture per replica that
    # decoded, counted on both caches
    decoded = sum(s["decode_steps"] > 0 for s in engines)
    assert st["builds"] == built and st["graph_builds"] == st["graphs"] == decoded, out
    assert router.fleet_builds() == built + decoded, out
    assert launches == dict(flash_attention=N_LAYERS * pre, paged_attention=N_LAYERS * dec,
                            **dense_norms(pre, dec)), (launches, pre, dec)
    results["router"] = out
    del router, params
    return launches


def trace_events_check(validate, events, rids) -> dict:
    """``validate`` the events, then one ``submit`` and exactly one
    ``terminal`` for every request."""
    info = validate(events)
    per = {r: [e["name"] for e in events if e.get("cat") == "request" and e.get("rid") == r]
           for r in rids}
    bad = {r: (n.count("submit"), n.count("terminal")) for r, n in per.items()
           if (n.count("submit"), n.count("terminal")) != (1, 1)}
    assert not bad and info["requests"] == info["terminals"] == len(rids), (bad, info)
    return info


def traced_path(torch, dev, results):
    """Phase 3n: phase 3's engine and traffic again with the full observer
    (tracer and flight recorder): streams bitwise phase 3's, the same
    launches, builds flat, a valid trace (one submit and one terminal a
    request) written as a Chrome trace; the profiled decode step launches
    what phase 3's did.  Then the launcher's ``run_stream`` in process
    with two replicas, a drain and ``--trace-out``.  Returns the launch
    counts."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import lm
    from repro_torch.obs import Observer, to_chrome_trace, to_jsonl, validate
    from repro_torch.serve import EngineConfig

    cfg = dataclasses.replace(get_config("smollm-360m"), attn_impl="kernel")
    params = lm.init(cfg, seed=0, device=dev)
    reqs, want = requests(cfg.vocab), results["phase3_streams"]
    ec = EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN, kv_layout="paged",
                      page_size=PAGE, paged_attn="kernel")
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    obs = Observer.full(dump_dir=str(TRACE_DIR), name="engine")
    kernels = dense_launch_kernels()
    for k in kernels:
        k.launches = 0
    eng, rids, steps, prefilled, wall = serve(torch, cfg, params, reqs, ec, dev,
                                              prebuild=True, obs=obs)
    eng.check_invariants()
    launches = {k.__name__: k.launches for k in kernels}
    st = eng.stats
    streams = [list(eng.completions[r].tokens) for r in rids]
    events = obs.tracer.events
    info = trace_events_check(validate, events, rids)
    chrome = TRACE_DIR / "phase3n_trace.json"
    to_chrome_trace(events, str(chrome))
    to_jsonl(events, str(TRACE_DIR / "phase3n_trace.jsonl"))
    decode_only = [t for t, p in zip(steps, prefilled) if not p]
    tokens = sum(len(s) for s in streams)
    del eng
    profile = profile_decode(torch, cfg, params, reqs, ec, dev,
                             obs=Observer.full(dump_dir=str(TRACE_DIR), name="engine"))
    base = results["profile"]
    out = dict(tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
               tokens_per_s_phase3=results["main_path"]["tokens_per_s"],
               decode_step_ms_median=float(np.median(decode_only)),
               decode_step_ms_median_phase3=results["main_path"]["decode_step_ms_median"],
               trace=info, trace_file=str(chrome.relative_to(HERE)),
               recorder_events=len(obs.recorder.events()), builds=st["builds"],
               graphs=st["graphs"], launches=launches,
               identical_to_phase3=sum(x == y for x, y in zip(streams, want)))
    if profile is not None and base is not None:
        out.update({f"profile_{k}": profile[k] for k in (
            "kernel_launches_per_step", "device_ms_per_step", "replay_host_ms_median")})
        out.update({f"profile_{k}_phase3": base[k] for k in (
            "kernel_launches_per_step", "device_ms_per_step", "replay_host_ms_median")})
    log(f"3n traced: decode step median {out['decode_step_ms_median']:.3f} ms traced, "
        f"{out['decode_step_ms_median_phase3']:.3f} untraced (phase 3; not gated); "
        f"{json.dumps(out)}")
    assert out["identical_to_phase3"] == len(reqs), out
    assert launches == results["main_path"]["launches"], (launches, results["main_path"])
    assert st["graphs"] == 1, st
    if profile is not None and base is not None:
        # the port's kernels a replay (per wrapper, from the profiler) and
        # the launches the graph counts: phase 3's exactly.  Every device
        # kernel a step is printed beside phase 3's, not gated: the card's
        # profiler loses a few records of a window now and then (non-port
        # kernels of a dense step), so that total moves between windows
        assert profile["replay_launches_per_step"] == base["replay_launches_per_step"], \
            (profile["replay_launches_per_step"], base["replay_launches_per_step"])
        assert profile["counted_launches_per_replay"] == base["counted_launches_per_replay"]

    # the launcher's router path in process, stdout kept out of the report
    launcher_trace = TRACE_DIR / "phase3n_launcher_trace.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        router = launcher.main(["--arch", "smollm-360m", "--device", str(dev),
                                "--kv-layout", "paged", "--replicas", "2", "--drain-at", "4",
                                "--requests", "8", "--rate", "1000",
                                "--trace-out", str(launcher_trace)])
    printed = buf.getvalue().splitlines()
    rs = router.stats
    linfo = trace_events_check(validate, router.obs.tracer.events, range(8))
    out["launcher"] = dict(status_ok=rs["status_ok"], migrated=rs["migrated"],
                           replica_states=rs["replica_states"], trace=linfo,
                           trace_file=str(launcher_trace.relative_to(HERE)),
                           summary=[ln for ln in printed if ln.startswith("--")])
    log(f"3n launcher --replicas 2 --drain-at 4: {json.dumps(out['launcher'])}")
    assert rs["status_ok"] == 8 and rs["replica_states"] == ["live", "drained"], out["launcher"]
    assert any(ln.startswith("-- drained replica 1") for ln in printed), printed
    assert launcher_trace.is_file()
    results["traced"] = out
    del router, params
    return launches


# ---------------------------------------------------------------------------
# Phase 3o: serving on a (data, model) mesh of one-rank NCCL groups
# ---------------------------------------------------------------------------


def serve_collectives(L: int, slotted: bool, *, prefill: bool) -> dict:
    """The collectives of one decode step or one prefill of a dense (or
    MoE) model of ``L`` layers on a ``(1, 1)`` mesh of one-rank groups,
    by kind (``models.common.COUNTS``): each layer's seven sharded weights
    and the embedding read twice, gathered over ``data``; the embedding's
    and each layer's two row-parallel sums over ``model``; the logits'
    gather over ``model``; the slotted layout's every-head q, k, v gathers
    and LSE combine over ``model`` a decode layer and its lanes' logits
    gathered over the data axis a step, or its two every-head k, v gathers
    a prefill; the paged layout's merge of the data ranks' partials (an
    all-gather of ``(m, l)`` and a sum) a decode layer."""
    out = {"all_gather": 7 * L + 2, "reduce_from_model": 2 * L + 1}
    if prefill:
        out["model_all_gather"] = 1 + (2 if slotted else 0)
    else:
        out["model_all_gather"] = 1 + (3 * L if slotted else 0)
        out["decode_combine"] = 2 * L if slotted else 0
        out["data_all_gather"] = 1 if slotted else 0
        out["data_combine"] = 0 if slotted else 2 * L
    return out


def mesh_serve_path(torch, dev, results):
    """Phase 3o: phase 3's model (full-width smollm-360m, bf16, seed 0) and
    16 requests through ``ServeEngine(mesh=)`` on a ``(1, 1)`` mesh of
    one-rank NCCL groups, on both KV layouts: every program inside the
    serving mesh program, every collective issued (each one a copy), the
    decode step a graph replay holding them.  At one rank the LSE combines
    (the model axis's and the data axis's) and every collective are
    identities, so the streams are bitwise the mesh-less engine's (phase
    3's, paged; a mesh-less run's, slotted), the kernels launch by phase
    3's formulas (the paged decode through the block-range entry
    ``paged_attention_range``: the pool's blocks split over the data
    axis), the collectives by ``serve_collectives``, and the KV bytes a
    rank are phase 3's.  Then the launcher's ``--mesh single`` on the card.
    Returns the paged run's launch counts."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.core.aot import CudaGraphProgram
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention, paged_attention_range
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add
    from repro_torch.launch import serve as launcher
    from repro_torch.launch.mesh import init_group, mesh_from_group
    from repro_torch.models import common, lm
    from repro_torch.serve import EngineConfig
    from repro_torch.serve.engine import MeshClock

    cfg = dataclasses.replace(get_config("smollm-360m"), attn_impl="kernel")
    params = lm.init(cfg, seed=0, device=dev)
    reqs = requests(cfg.vocab)
    paged = EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN, kv_layout="paged",
                         page_size=PAGE, paged_attn="kernel")
    slotted = dataclasses.replace(paged, kv_layout="slotted")
    kernels = (flash_attention, paged_attention, paged_attention_range, rmsnorm, rmsnorm_add)
    L = cfg.n_layers
    group = init_group("nccl", 0, 1, f"tcp://127.0.0.1:{free_port()}", device=dev)
    out = {}
    try:
        mesh = mesh_from_group(group, (1, 1))
        out["graph_check"] = graph_check(torch, cfg, params, reqs, paged, dev, mesh=mesh)
        want_slotted = None
        for name, ec in (("paged", paged), ("slotted", slotted)):
            if name == "slotted":
                ref, ref_rids, ref_steps, ref_pre, ref_wall = serve(torch, cfg, params, reqs,
                                                                    ec, dev)
                want_slotted = [list(ref.completions[r].tokens) for r in ref_rids]
                results["phase3_slotted_streams"] = want_slotted
                want_bytes, ref_tps = ref.kv_reserved_bytes, \
                    sum(len(s) for s in want_slotted) / ref_wall
                ref_median = float(np.median([t for t, p in zip(ref_steps, ref_pre) if not p]))
                ref_pre_median = float(np.median([t for t, p in zip(ref_steps, ref_pre) if p]))
                del ref
            for k in kernels:
                k.launches = 0
            common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
            eng, rids, steps, prefilled, wall = serve(torch, cfg, params, reqs, ec, dev,
                                                      mesh=mesh)
            counts = dict(common.COUNTS)
            launches = {k.__name__: k.launches for k in kernels}
            st = eng.stats
            eng.check_invariants()
            streams = [list(eng.completions[r].tokens) for r in rids]
            want = results["phase3_streams"] if name == "paged" else want_slotted
            pre, dec = st["prefills"], st["decode_steps"]
            # one eager decode step on a deep clone of the state: its
            # collectives alone
            common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
            for p, b in reqs[:MAX_SLOTS]:
                eng.submit(p, max_new_tokens=b)
            while eng.counters["decode_steps"] == dec:
                eng.step()
            common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
            eng.decode_program(stochastic=False, masked=False)(eng.params,
                                                               clone_state(torch, eng.state))
            step_counts = dict(common.COUNTS)
            eng.drain()
            graph = eng._decode_entry(stochastic=False, masked=False)
            tokens = sum(len(s) for s in streams)
            decode_only = [t for t, p in zip(steps, prefilled) if not p]
            one_dec = serve_collectives(L, name == "slotted", prefill=False)
            one_pre = serve_collectives(L, name == "slotted", prefill=True)
            # the run's collectives: every prefill (eager) and the decode
            # program's two Python runs (its warm step and its capture);
            # the graph's replays issue theirs on the card without Python
            run_want = {k: pre * one_pre.get(k, 0) + 2 * one_dec.get(k, 0) for k in counts}
            row = dict(layout=name, mesh=st["mesh"], tokens=tokens, wall_s=wall,
                       tokens_per_s=tokens / wall,
                       decode_step_ms_median=float(np.median(decode_only)),
                       prefill_step_ms_median=float(np.median([t for t, p in zip(steps, prefilled)
                                                               if p])),
                       prefills=pre, decode_steps=dec, launches=launches,
                       collectives_run=counts, collectives_run_formula=run_want,
                       collectives_decode_step=step_counts,
                       collectives_decode_step_formula=one_dec,
                       collectives_prefill_formula=one_pre,
                       kv_reserved_bytes=st["kv_reserved_bytes"],
                       identical=sum(x == y for x, y in zip(streams, want)),
                       graph_replays=graph.replays, graphs=st["graphs"])
            if name == "paged":
                base = results["main_path"]
                row.update(tokens_per_s_phase3=base["tokens_per_s"],
                           decode_step_ms_median_phase3=base["decode_step_ms_median"],
                           prefill_step_ms_median_phase3=base["prefill_step_ms_median"],
                           kv_reserved_bytes_phase3=base["kv_reserved_bytes"])
                want_bytes = base["kv_reserved_bytes"]
                # every paged decode launch is the block-range entry (the
                # pool's blocks split over the data axis, here one rank)
                want_launches = dict(flash_attention=L * pre, paged_attention=0,
                                     paged_attention_range=L * dec, **dense_norms(pre, dec))
            else:
                row.update(tokens_per_s_mesh_none=ref_tps, kv_reserved_bytes_mesh_none=want_bytes,
                           decode_step_ms_median_mesh_none=ref_median,
                           prefill_step_ms_median_mesh_none=ref_pre_median)
                want_launches = dict(flash_attention=L * pre, paged_attention=0,
                                     paged_attention_range=0, **dense_norms(pre, dec))
            log(f"3o mesh (1, 1) {name}: {json.dumps(row)}")
            assert row["identical"] == len(reqs) and all(
                c.status == "ok" for c in eng.completions.values()), row
            assert launches == want_launches, (launches, want_launches)
            assert step_counts == {**dict.fromkeys(common.COUNTS, 0), **one_dec}, row
            assert counts == {**dict.fromkeys(common.COUNTS, 0), **run_want}, row
            assert row["kv_reserved_bytes"] == want_bytes, row
            assert isinstance(graph, CudaGraphProgram) and graph.replays > 0 \
                and st["graphs"] == 1, row
            out[name] = row
            del eng
            free(torch)
        # one reading of the mesh's clock (rank 0's, broadcast): host us
        clock = MeshClock(time.perf_counter, mesh)
        clock()
        t = time.perf_counter()
        for _ in range(200):
            clock()
        out["clock_reading_us"] = (time.perf_counter() - t) / 200 * 1e6
        # the paged decode step's device time, beside phase 3's
        prof = profile_decode(torch, cfg, params, reqs, paged, dev, mesh=mesh)
        keys = ("device_ms_per_step", "device_idle_share", "kernel_launches_per_step",
                "step_ms_unprofiled", "replay_host_ms_median")
        base = results.get("profile")
        out["profile"] = prof and {**{k: prof[k] for k in keys},
                                   **{f"{k}_phase3": base and base[k] for k in keys},
                                   "top": prof["top"][:6]}
        log(f"3o mesh (1, 1) paged decode step profile: {json.dumps(out['profile'])}; "
            f"one clock reading {out['clock_reading_us']:.1f} us of host")
        # the launcher on the card, the one-device engine
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            router = launcher.main(["--arch", "smollm-360m", "--device", str(dev),
                                    "--mesh", "single", "--kv-layout", "paged",
                                    "--requests", "4", "--rate", "1000"])
        printed = buf.getvalue()
        out["launcher"] = dict(status_ok=router.stats["status_ok"],
                               tokens=sum(len(c.tokens) for c in router.completions.values()),
                               summary=[ln for ln in printed.splitlines() if ln.startswith("--")])
        log(f"3o launcher --mesh single: {json.dumps(out['launcher'])}")
        assert router.stats["status_ok"] == 4 and "status: ok 4" in printed, printed[-2000:]
        del router
    finally:
        group.close()
    results["mesh_serve"] = out
    return out["paged"]["launches"]


# ---------------------------------------------------------------------------
# Phase 3p: the engine's features on the (1, 1) mesh
# ---------------------------------------------------------------------------


def mesh_feature_launches(st, *, paged: bool, spec: bool) -> dict:
    """What a mesh engine's counters predict of its launches: flash on each
    chunk that starts at 0 and each draft prefill, the paged decode (each
    of a round's ``SPEC_K + 1`` verify steps, speculating) through the
    block-range entry, the norms on each chunk and draft prefill and each
    decode step (a round's draft and verify steps, speculating)."""
    steps = (SPEC_K + 1) * st["spec_steps"] if spec else st["decode_steps"]
    return {"flash_attention": N_LAYERS * (st["prefill_first_chunks"]
                                           + st["spec_draft_prefills"]),
            "paged_attention": 0, "paged_attention_range": N_LAYERS * steps if paged else 0,
            **dense_norms(st["prefill_chunks"] + st["spec_draft_prefills"],
                          2 * steps if spec else steps)}


def spec_collectives(L: int, slotted: bool) -> dict:
    """The collectives of one spec round on a ``(1, 1)`` mesh of one-rank
    groups (``serve_collectives``): ``SPEC_K + 1`` decode steps of the
    draft, whose cache is always slotted, and ``SPEC_K + 1`` verify steps
    of the target on its layout."""
    draft = serve_collectives(L, True, prefill=False)
    target = serve_collectives(L, slotted, prefill=False)
    return {k: (SPEC_K + 1) * (draft.get(k, 0) + target.get(k, 0))
            for k in sorted(set(draft) | set(target))}


def mesh_features_path(torch, dev, results):
    """Phase 3p: the engine's features on phase 3o's ``(1, 1)`` mesh of
    one-rank NCCL groups, full-width smollm-360m (bf16, seed 0), every
    collective issued: 3f's tier engine (streams phase 3's, ``TIER_3F``
    exactly), 3h's hold, park, snapshot and migration (``save_snapshot``:
    rank 0 writes, a barrier; the export into a second mesh engine sharing
    the tier), 3j's spec engine on both layouts (its graph holding both
    mesh programs, 8 replays bitwise the eager round on a deep clone; the
    round's collectives by ``spec_collectives``; streams phase 3's paged,
    phase 3o's mesh-less slotted run's slotted; ``spec_identities``) and
    3k's spec-plus-tier run (preemptions restored by copy, no replay).
    Launches by ``mesh_feature_launches``: the paged decode through the
    block-range entry.  Prints tokens/s beside 3f's and 3j's and a
    profiled spec round beside 3j's.  Returns the launch counts of each
    run, by sub-phase."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention, paged_attention_range
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add
    from repro_torch.launch.mesh import init_group, mesh_from_group
    from repro_torch.models import common, lm
    from repro_torch.serve import EngineConfig

    lap = laps()
    cfg = dataclasses.replace(get_config("smollm-360m"), attn_impl="kernel")
    params = lm.init(cfg, seed=0, device=dev)
    dparams = draft_params_for(cfg, params, DRAFT_ALPHA, dev)
    phase3, want3 = requests(cfg.vocab), results["phase3_streams"]
    want_slotted = results["phase3_slotted_streams"]
    bb = block_bytes(cfg)
    kernels = (flash_attention, paged_attention, paged_attention_range, rmsnorm, rmsnorm_add)
    spec = dict(spec_draft=cfg, spec_k=SPEC_K)
    card = results["nvidia_smi"]
    group = init_group("nccl", 0, 1, f"tcp://127.0.0.1:{free_port()}", device=dev)
    out, launches = {}, {}
    try:
        mesh = mesh_from_group(group, (1, 1))

        def run(name, ec, want, reqs=phase3, **kw):
            for k in kernels:
                k.launches = 0
            eng, rids, steps, prefilled, wall = serve(torch, cfg, params, reqs, ec, dev,
                                                      check=True, prebuild=True, mesh=mesh,
                                                      **kw)
            st = eng.stats
            got = {k.__name__: k.launches for k in kernels}
            want_l = mesh_feature_launches(st, paged=eng.paged, spec=eng.spec)
            streams = [list(eng.completions[r].tokens) for r in rids]
            tokens = sum(len(x) for x in streams)
            row = dict(mesh=st["mesh"], tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
                       launches=got, graphs=st["graphs"],
                       identical=sum(x == y for x, y in zip(streams, want)))
            assert row["identical"] == len(reqs), (name, row)
            assert got == want_l, (name, got, want_l)
            assert st["graphs"] == 1, (name, st)
            launches[name] = got
            return eng, row

        # 3f's tier engine
        tier = logging_tier()
        eng, f = run("3f", feature_engine(prefill_chunk=0, prefix_cache=False, host_tier=True),
                     want3, host_tier=tier)
        f["tier_counters"] = tc = tier_counters(eng, bb)
        f["tokens_per_s_3f"] = results["tier"]["3f"]["tokens_per_s"]
        del eng
        log(f"3p tier on the mesh [{card}]: {f['tokens_per_s']:.1f} tok/s (3f "
            f"{f['tokens_per_s_3f']:.1f}); {json.dumps(f)}")
        assert tc == TIER_3F, (tc, TIER_3F)
        out["3f"] = f
        lap("3f")

        # 3h's hold, park, snapshot and migration
        out["3h"] = hold_park_snapshot(torch, cfg, params, phase3, dev, want3, mesh=mesh)
        launches["3h"] = out["3h"]["launches"]
        lap("3h")

        # 3j's spec engine: the graph, a round's collectives, a profiled round
        ec_j = EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN, kv_layout="paged",
                            page_size=PAGE, paged_attn="kernel", **spec)
        graph, checked = spec_graph_check(torch, cfg, params, dparams, phase3, ec_j, dev,
                                          mesh=mesh)
        common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
        checked.spec_program(stochastic=False, masked=False)(
            checked.params, checked.draft_params, clone_state(torch, checked.state))
        round_counts = dict(common.COUNTS)
        want_counts = {**dict.fromkeys(common.COUNTS, 0),
                       **spec_collectives(N_LAYERS, slotted=False)}
        profile = profile_spec(torch, checked, steps=2, breakdown=False)
        del checked
        assert round_counts == want_counts, (round_counts, want_counts)
        lap("3j graph and profile")
        keys = ("kernel_launches_per_round", "device_ms_per_round", "device_idle_share",
                "round_ms_unprofiled", "replay_host_ms_median")
        base = results["spec"]["3j"]["profile"]
        out["3j"] = dict(graph_check=graph, collectives_round=round_counts,
                         profile={**{k: profile.get(k) for k in keys},
                                  **{f"{k}_3j": base.get(k) for k in keys},
                                  "top": profile.get("top", [])[:6]})
        # each layout on the first MAX_SLOTS requests (a lane's greedy
        # stream does not depend on the others': every decode step runs
        # every lane, every prefill one), their streams the mesh-less ones
        for layout, want in (("paged", want3), ("slotted", want_slotted)):
            eng, j = run(f"3j {layout}", dataclasses.replace(ec_j, kv_layout=layout), want,
                         reqs=phase3[:MAX_SLOTS], draft_params=dparams)
            j["identities"] = spec_identities(eng)
            j.update(spec_figures(eng.stats))
            del eng
            out["3j"][layout] = j
        out["3j"]["paged"]["tokens_per_s_3j"] = results["spec"]["3j"]["tokens_per_s"]
        log(f"3p spec on the mesh [{card}]: paged {out['3j']['paged']['tokens_per_s']:.1f} "
            f"tok/s (3j {out['3j']['paged']['tokens_per_s_3j']:.1f}), slotted "
            f"{out['3j']['slotted']['tokens_per_s']:.1f}; a round on the mesh "
            f"{json.dumps(out['3j']['profile'])}; {json.dumps(out['3j'])}")
        lap("3j runs")

        # 3k's spec-plus-tier run
        eng, k = run("3k", feature_engine(prefill_chunk=0, prefix_cache=False,
                                          host_tier=True, **spec), want3,
                     draft_params=dparams)
        k["identities"] = spec_identities(eng)
        k.update(spec_figures(eng.stats), counters={c: eng.counters[c] for c in (
            "preemptions", "resumed", "restores", "replayed_tokens", "prefills")})
        del eng
        log(f"3p spec and tier on the mesh [{card}]: {k['tokens_per_s']:.1f} tok/s (3k "
            f"{results['spec']['3k']['tokens_per_s']:.1f}); {json.dumps(k)}")
        c = k["counters"]
        assert c["preemptions"] > 0 and c["replayed_tokens"] == 0, c
        assert c["prefills"] == len(phase3) and c["resumed"] == c["restores"], c
        out["3k"] = k
        out["seconds"] = lap("3k")
    finally:
        group.close()
    results["mesh_features"] = out
    del params, dparams
    return launches


# ---------------------------------------------------------------------------
# Phase 5: Zamba2 hybrid serving at full width
# ---------------------------------------------------------------------------


def zamba_path(torch, dev, results):
    """Full-width zamba2-1.2b through the slotted engine on the kernel path
    (flash, ssd, rmsnorm, rmsnorm_add, rmsnorm_gated).  Returns the launch
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add, rmsnorm_gated
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.models import zamba
    from repro_torch.serve import EngineConfig

    base = get_config("zamba2-1.2b")
    assert base.n_layers == ZAMBA_LAYERS and zamba.n_shared_invocations(base) == ZAMBA_SHARED
    assert base.compute_dtype == "bfloat16"
    cfg = dataclasses.replace(base, attn_impl="kernel")
    params = zamba.init(cfg, seed=0, device=dev)
    reqs = requests(cfg.vocab)
    ec = EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN, kv_layout="slotted")
    kernels = (flash_attention, ssd, rmsnorm, rmsnorm_add, rmsnorm_gated)
    serve(torch, cfg, params, [(reqs[0][0][:16], 4), (reqs[1][0][:32], 4)], ec, dev)
    results["zamba_graph_check"] = {
        "greedy": graph_check(torch, cfg, params, reqs, ec, dev),
        "sampled": graph_check(torch, cfg, params, reqs, ec, dev, sampling=SAMPLED)}
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    eng, rids, steps, prefilled, wall = serve(torch, cfg, params, reqs, ec, dev, check=True)
    launches = {k.__name__: k.launches for k in kernels}
    st = eng.stats
    programs = program_builds(eng, reqs)
    comps = [eng.completions[r] for r in rids]
    bad = [(c.rid, c.status, len(c.tokens), b) for c, (_, b) in zip(comps, reqs)
           if c.status != "ok" or len(c.tokens) != b]
    assert not bad, f"requests not served in full: {bad}"
    pre, dec = st["prefills"], st["decode_steps"]
    want = zamba_launches(pre, dec)
    assert launches == want and pre > 0 and dec > 0, (launches, want, st)
    tokens = sum(len(c.tokens) for c in comps)
    decode_only = [t for t, p in zip(steps, prefilled) if not p]
    e2e = dict(requests=len(comps), tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
               prefills=pre, decode_steps=dec, prompt_tokens=st["prefill_tokens"],
               decode_step_ms_median=float(np.median(decode_only)),
               decode_step_ms_p90=float(np.percentile(decode_only, 90)),
               decode_only_steps=len(decode_only), state_kind=st["state_kind"],
               kv_reserved_bytes=st["kv_reserved_bytes"],
               max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
               invariants_checked_steps=len(steps), programs=programs)
    log(f"zamba2 (slotted, kernels, decode graph): {tokens} tokens in {wall:.3f} s = "
        f"{tokens / wall:.1f} tok/s; decode step median {e2e['decode_step_ms_median']:.2f} ms "
        f"over {len(decode_only)} decode-only steps; launches {launches}; "
        f"programs {json.dumps(programs)}")
    t = time.perf_counter()
    results["zamba_preempt"] = zamba_preempt(torch, cfg, params, reqs, ec, dev,
                                             [list(c.tokens) for c in comps])
    results["zamba_preempt"]["seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    results["zamba_tier"] = zamba_tier(torch, cfg, params, reqs, ec, dev,
                                       [list(c.tokens) for c in comps])
    results["zamba_tier"]["seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    results["zamba_spec"] = zamba_spec(torch, cfg, params, reqs, ec, dev,
                                       [list(c.tokens) for c in comps], e2e["tokens_per_s"],
                                       results["nvidia_smi"])
    results["zamba_spec"]["seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    results["zamba_mesh"] = zamba_mesh_serve(torch, cfg, params, reqs, ec, dev,
                                             [list(c.tokens) for c in comps], e2e)
    results["zamba_mesh"]["seconds"] = time.perf_counter() - t

    ref_cfg = dataclasses.replace(base, attn_impl="chunked")
    ref_eng, ref_rids, _, _, ref_wall = serve(torch, ref_cfg, params, reqs, ec, dev)
    e2e.update(plain_wall_s=ref_wall, plain_tokens_per_s=tokens / ref_wall,
               greedy_bf16=agreement([c.tokens for c in comps],
                                     [ref_eng.completions[r].tokens for r in ref_rids]))
    log(f"zamba2 plain path (chunked): {ref_wall:.3f} s = {tokens / ref_wall:.1f} tok/s; bf16 "
        f"greedy agreement with the kernel path {e2e['greedy_bf16']} (not gated)")
    del ref_eng, eng
    e2e["prefill_512"] = prefill_ms(torch, dev, base, params)
    results["zamba_prefill_profile"] = profile_prefill(
        torch, dev, base, params, e2e["prefill_512"]["kernel"]["ms_median"])
    results["zamba_profile"] = profile_decode(torch, cfg, params, reqs, ec, dev)
    results["zamba"] = e2e
    results["zamba_blocks"] = zamba_block_agreement(torch, dev, base, params, reqs[2][0])
    results["zamba_logits"] = zamba_logit_agreement(torch, dev, base, params, reqs[2][0])
    return launches


ZAMBA_PREEMPT_AFTER = 8       # decode steps before phase 5b preempts two lanes


def zamba_serve_collectives(cfg, *, prefill: bool) -> dict:
    """The collectives of one zamba2 decode step or prefill on a ``(1, 1)``
    mesh of one-rank groups (``models.common.COUNTS``): each shared-block
    invocation's eight sharded weights, each Mamba2 layer's ``in_proj`` and
    ``out_proj``, the embedding and the unembedding gathered over ``data``;
    the embedding's, each invocation's two and each Mamba2 layer's
    row-parallel sums over ``model``; each Mamba2 layer's projection and
    conv weight and bias gathered over ``model`` and the logits' gather; a
    decode step's every-head q, k, v gathers and LSE combine an invocation
    and its lanes' logits over ``data``, a prefill's k and v gathered to
    every kv head for the slotted cache."""
    from repro_torch.models import zamba

    L, sh = cfg.n_layers, zamba.n_shared_invocations(cfg)
    out = {"all_gather": 8 * sh + 2 * L + 2, "reduce_from_model": 2 * sh + L + 1}
    if prefill:
        out["model_all_gather"] = 3 * L + 1 + 2
    else:
        out.update(model_all_gather=3 * sh + 3 * L + 1, decode_combine=2 * sh,
                   data_all_gather=1)
    return out


def zamba_mesh_serve(torch, cfg, params, reqs, ec, dev, want, base: dict) -> dict:
    """Phase 5m: phase 5's model (full-width zamba2-1.2b, 38 layers),
    requests and engine settings through ``ServeEngine(mesh=)`` on a ``(1,
    1)`` mesh of one-rank NCCL groups: every program inside the serving
    mesh program (the weights' shards gathered over ``data``, the shared
    block's heads and the Mamba2 projections over ``model``, every head of
    each Mamba2 block on the rank, the cache laid out by
    ``zamba.cache_pspec``), every collective issued (each one a copy), the
    decode step a graph replay holding them.  Gates: the streams bitwise
    phase 5's (``want``), every request ``ok``, the invariants after every
    step; the launches phase 5's formulas (the whole-row gated norm: no
    split entry in serving); the collectives by
    :func:`zamba_serve_collectives` (each prefill eager, the decode
    program's two Python runs); the KV bytes phase 5's.  Prints tokens/s,
    the decode step's median host ms and a profiled decode step's device
    ms, idle share and launches, beside phase 5's (``base``)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import (rmsnorm, rmsnorm_add, rmsnorm_gated,
                                                 rmsnorm_gated_split)
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.launch.mesh import init_group, mesh_from_group
    from repro_torch.models import common

    kernels = (flash_attention, ssd, rmsnorm, rmsnorm_add, rmsnorm_gated, rmsnorm_gated_split)
    group = init_group("nccl", 0, 1, f"tcp://127.0.0.1:{free_port()}", device=dev)
    try:
        mesh = mesh_from_group(group, (1, 1))
        for k in kernels:
            k.launches = 0
        common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
        eng, rids, steps, prefilled, wall = serve(torch, cfg, params, reqs, ec, dev,
                                                  check=True, mesh=mesh)
        counts = dict(common.COUNTS)
        launches = {k.__name__: k.launches for k in kernels}
        st = eng.stats
        comps = [eng.completions[r] for r in rids]
        streams = [list(c.tokens) for c in comps]
        pre, dec = st["prefills"], st["decode_steps"]
        # one eager decode step on a deep clone of the state: its
        # collectives alone
        for p, b in reqs[:MAX_SLOTS]:
            eng.submit(p, max_new_tokens=b)
        while eng.counters["decode_steps"] == dec:
            eng.step()
        common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
        eng.decode_program(stochastic=False, masked=False)(eng.params,
                                                           clone_state(torch, eng.state))
        step_counts = dict(common.COUNTS)
        eng.drain()
        one_dec = zamba_serve_collectives(cfg, prefill=False)
        one_pre = zamba_serve_collectives(cfg, prefill=True)
        run_want = {k: pre * one_pre.get(k, 0) + 2 * one_dec.get(k, 0) for k in counts}
        tokens = sum(len(x) for x in streams)
        decode_only = [t for t, p in zip(steps, prefilled) if not p]
        want_launches = dict(zamba_launches(pre, dec), rmsnorm_gated_split=0)
        row = dict(mesh=st["mesh"], tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
                   tokens_per_s_phase5=base["tokens_per_s"],
                   decode_step_ms_median=float(np.median(decode_only)),
                   decode_step_ms_median_phase5=base["decode_step_ms_median"],
                   prefills=pre, decode_steps=dec, launches=launches,
                   launches_expected=want_launches, collectives_run=counts,
                   collectives_run_formula=run_want, collectives_decode_step=step_counts,
                   collectives_decode_step_formula=one_dec,
                   collectives_prefill_formula=one_pre,
                   kv_reserved_bytes=st["kv_reserved_bytes"],
                   kv_reserved_bytes_phase5=base["kv_reserved_bytes"],
                   identical=sum(x == y for x, y in zip(streams, want)), graphs=st["graphs"])
        log(f"5m zamba2 mesh (1, 1): {json.dumps(row)}")
        assert row["identical"] == len(reqs) and all(c.status == "ok" for c in comps), row
        assert launches == want_launches, (launches, want_launches)
        assert step_counts == {**dict.fromkeys(common.COUNTS, 0), **one_dec}, row
        assert counts == {**dict.fromkeys(common.COUNTS, 0), **run_want}, row
        assert row["kv_reserved_bytes"] == base["kv_reserved_bytes"], row
        assert st["graphs"] == 1, row
        del eng
        prof = profile_decode(torch, cfg, params, reqs, ec, dev, mesh=mesh)
        keys = ("device_ms_per_step", "device_idle_share", "kernel_launches_per_step",
                "step_ms_unprofiled", "replay_host_ms_median")
        row["profile"] = prof and {**{k: prof[k] for k in keys}, "top": prof["top"][:6]}
        log(f"5m zamba2 mesh (1, 1): {tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} "
            f"tok/s (phase 5 {base['tokens_per_s']:.1f}); decode step median "
            f"{row['decode_step_ms_median']:.2f} ms host; profile {json.dumps(row['profile'])}")
    finally:
        group.close()
    return row


def zamba_launches(pre: int, dec: int) -> dict:
    """Launches of a zamba2 serving run with ``pre`` prefills and ``dec``
    decode steps: per prefill and decode step rmsnorm for the shared
    block's ln1, each Mamba2 layer's ln and ln_f; the gated form for each
    Mamba2 out-norm (with its skip and gate); rmsnorm_add for the shared
    block's ln2; flash and ssd per prefill."""
    return {"flash_attention": ZAMBA_SHARED * pre, "ssd": ZAMBA_LAYERS * pre,
            "rmsnorm": (ZAMBA_SHARED + ZAMBA_LAYERS + 1) * (pre + dec),
            "rmsnorm_add": ZAMBA_SHARED * (pre + dec),
            "rmsnorm_gated": ZAMBA_LAYERS * (pre + dec)}


def zamba_preempt(torch, cfg, params, reqs, ec, dev, want) -> dict:
    """Phase 5b: phase 5's engine and requests; after ``ZAMBA_PREEMPT_AFTER``
    decode steps the host preempts the two busiest lanes' requests (the
    last two occupied lanes).  Their resumes re-prefill the prompt through
    the same bucket program (flash, ssd and the norms) and replay the
    emitted tokens through decode, so every stream must equal phase 5's
    (``want``) bitwise; invariants (recurrent zeroing included) after
    every step, and the launches those 18 prefills and the decode steps
    predict."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add, rmsnorm_gated
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.serve import ServeEngine

    kernels = (flash_attention, ssd, rmsnorm, rmsnorm_add, rmsnorm_gated)
    eng = ServeEngine(cfg, params, ec, device=dev)
    rids = [eng.submit(p, max_new_tokens=b) for p, b in reqs]
    for k in kernels:
        k.launches = 0
    victims = None
    while eng.has_work():
        eng.step()
        eng.check_invariants()
        if victims is None and eng.counters["decode_steps"] >= ZAMBA_PREEMPT_AFTER:
            lanes = [i for i, s in enumerate(eng.slots) if s is not None][-2:]
            victims = [eng.slots[i].rid for i in lanes]
            emitted = [len(eng.live[r].tokens) for r in victims]
            for i in lanes:
                eng.preempt(i)
            eng.check_invariants()
    launches = {k.__name__: k.launches for k in kernels}
    st = eng.stats
    got = [list(eng.completions[r].tokens) for r in rids]
    same = [i for i, (x, y) in enumerate(zip(got, want)) if x == y]
    out = dict(victims=victims, emitted_before=emitted, identical_to_phase5=len(same),
               launches=launches, prefills=st["prefills"], decode_steps=st["decode_steps"],
               preemptions=st["preemptions"], resumed=st["resumed"],
               replayed_tokens=st["replayed_tokens"], graphs=st["graphs"])
    log(f"5b zamba2 host preemption: {json.dumps(out)}")
    assert st["preemptions"] == st["resumed"] == 2 and st["replayed_tokens"] > 0, out
    assert st["prefills"] == len(reqs) + 2 and st["graphs"] == 1, out
    assert launches == zamba_launches(st["prefills"], st["decode_steps"]), out
    assert len(same) == len(reqs), out
    return out


ZAMBA_HOLD_AT, ZAMBA_HOLD_STEPS = 4, 3   # phase 5c: hold after 4 decode steps, for 3


def zamba_tier(torch, cfg, params, reqs, ec, dev, want) -> dict:
    """Phase 5c: phase 5's engine with a host tier.  After
    ``ZAMBA_HOLD_AT`` decode steps the host holds the first lane (a hybrid
    lane spills at once: its KV segment and recurrent leaves) and releases
    it ``ZAMBA_HOLD_STEPS`` steps later (restored by copy); after
    ``ZAMBA_PREEMPT_AFTER`` it preempts the last two occupied lanes as 5b
    does, and their resumes restore by copy instead of re-prefilling (ssd
    38 x 16, not 5b's 38 x 18).  Every stream must equal phase 5's bitwise,
    with invariants (the recurrent-zero sweep included) after every step."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add, rmsnorm_gated
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.models import registry
    from repro_torch.serve import ServeEngine

    kernels = (flash_attention, ssd, rmsnorm, rmsnorm_add, rmsnorm_gated)
    eng = ServeEngine(cfg, params, dataclasses.replace(ec, host_tier=True), device=dev)
    eng.prebuild()
    built = eng.stats["builds"]
    axes = registry.lane_leaf_axes(cfg)
    lane_bytes = sum(c.numel() // MAX_SLOTS * c.element_size()
                     for n, c in eng.state["cache"].items() if n in axes)
    rids = [eng.submit(p, max_new_tokens=b) for p, b in reqs]
    for k in kernels:
        k.launches = 0
    held = victims = release_ms = None
    held_at = 0
    t0 = time.perf_counter()
    while eng.has_work():
        eng.step()
        eng.check_invariants()
        dec = eng.counters["decode_steps"]
        if held is None and dec >= ZAMBA_HOLD_AT:
            held = next(s.rid for s in eng.slots if s is not None and s.generated >= 1)
            assert eng.hold(held) and eng.counters["spills"] == 1, eng.counters
            held_at = dec
        elif release_ms is None and held is not None and dec >= held_at + ZAMBA_HOLD_STEPS:
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.release(held)
            torch.cuda.synchronize()
            release_ms = (time.perf_counter() - t) * 1e3
            eng.check_invariants()
        elif victims is None and release_ms is not None and dec >= ZAMBA_PREEMPT_AFTER:
            lanes = [i for i, s in enumerate(eng.slots) if s is not None][-2:]
            victims = [eng.slots[i].rid for i in lanes]
            for i in lanes:
                eng.preempt(i)
            eng.check_invariants()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    st = eng.stats
    got = [list(eng.completions[r].tokens) for r in rids]
    same = sum(x == y for x, y in zip(got, want))
    copies = lane_transport(torch, cfg, eng.state)
    assert copies["bytes"] == lane_bytes, (copies, lane_bytes)
    copies["release"] = dict(ms=release_ms, gb_per_s=lane_bytes / release_ms / 1e6)
    out = dict(held=held, victims=victims, identical_to_phase5=same, launches=launches,
               lane_bytes=lane_bytes, copies=copies, wall_s=wall, tokens_per_s=sum(
                   len(t) for t in got) / wall, graphs=st["graphs"], builds=st["builds"],
               host_tier=st["host_tier"], counters={k: st[k] for k in (
                   "prefills", "decode_steps", "holds", "releases", "preemptions", "resumed",
                   "spills", "restores", "replayed_tokens", "spilled_bytes",
                   "restored_bytes")})
    log(f"5c zamba2 host tier: {json.dumps(out)}")
    assert same == len(reqs), out
    assert st["holds"] == st["releases"] == 1 and st["preemptions"] == st["resumed"] == 2, out
    assert st["spills"] == st["restores"] == 3 and st["replayed_tokens"] == 0, out
    assert st["spilled_bytes"] == st["restored_bytes"] == 3 * lane_bytes, out
    assert st["prefills"] == len(reqs) and st["graphs"] == 1 and st["builds"] == built, out
    assert launches == zamba_launches(st["prefills"], st["decode_steps"]), out
    return out


def lane_transport(torch, cfg, state, slot: int = 0) -> dict:
    """The tier's lane transport alone on a drained engine's slot cache:
    lane ``slot`` read to pinned host memory (a spill: one copy a leaf, one
    synchronize) and written back (a restore), host ms and GB/s, beside a
    plain pinned ``copy_`` of the same bytes each way."""
    from repro_torch.models import registry
    from repro_torch.serve import lane_read_program, lane_write_program

    axes = registry.lane_leaf_axes(cfg)
    read, write = lane_read_program(cfg, axes=axes), lane_write_program(cfg, axes=axes)
    out = {}
    out["read"], payload = timed(torch, lambda: read(state, slot))
    out["write"], _ = timed(torch, lambda: write(state, payload, slot))
    nbytes = sum(int(a.nbytes) for a in payload.values())
    for r in out.values():
        r["gb_per_s"] = nbytes / r["ms"] / 1e6
    dev = next(iter(state["cache"].values())).device
    out.update(bytes=nbytes, plain=plain_copy_rates(torch, dev, nbytes))
    return out


def prefill_ms(torch, dev, base, params, iters: int = 5) -> dict:
    """Host ms of one lane's prefill (``prefill_slot``) of a 512-token
    prompt at bucket 512, kernel and plain path, after a synchronize."""
    from repro_torch.models import zamba

    tokens = prefill_tokens(torch, dev, base)
    out = {}
    for impl in ("kernel", "chunked"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        p = zamba.cast_for_compute(cfg, params, dev)
        cache = {k: torch.zeros_like(s, device=dev)
                 for k, s in zamba.make_cache_specs(cfg, 1, 512).items()}
        for _ in range(2):
            zamba.prefill_slot(cfg, p, cache, tokens, 0, 512)
        times = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t = time.perf_counter()
            zamba.prefill_slot(cfg, p, cache, tokens, 0, 512)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        out[impl] = dict(ms_median=float(np.median(times)), ms=times)
        del p, cache
    log(f"zamba2 prefill at bucket 512: {json.dumps(out)}")
    return out


def prefill_tokens(torch, dev, base):
    return torch.randint(0, base.vocab, (1, 512), dtype=torch.int32, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(6))


def profile_prefill(torch, dev, base, params, host_ms: float) -> dict | None:
    """One kernel-path ``prefill_slot`` of a 512-token prompt at bucket 512
    under ``torch.profiler``: device time, launches, the top device kernels
    and the SSD kernels' share of the device time; the idle share is taken
    against ``host_ms``, the same prefill's unprofiled host time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import zamba

    cfg = dataclasses.replace(base, attn_impl="kernel")
    p = zamba.cast_for_compute(cfg, params, dev)
    cache = {k: torch.zeros_like(s, device=dev)
             for k, s in zamba.make_cache_specs(cfg, 1, 512).items()}
    tokens = prefill_tokens(torch, dev, base)
    zamba.prefill_slot(cfg, p, cache, tokens, 0, 512)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        zamba.prefill_slot(cfg, p, cache, tokens, 0, 512)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    if not kernels:
        log("prefill profile: torch.profiler recorded no device activity (not measured)")
        return None
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ssd_ms = sum(e.self_device_time_total for e in kernels if SSD_KERNEL.match(e.key)) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    out = dict(bucket=512, host_ms_unprofiled=host_ms, device_ms=total_ms,
               device_idle_share=1 - total_ms / host_ms,
               launches=sum(e.count for e in kernels), ssd_device_ms=ssd_ms,
               ssd_share_of_device=ssd_ms / total_ms,
               top=[dict(name=e.key[:80], calls=e.count, ms=e.self_device_time_total / 1e3)
                    for e in top],
               port_kernels=port_kernels(kernels, 1))
    log(f"zamba2 prefill profile: {json.dumps(out)}")
    del p, cache
    return out


def zamba_logit_agreement(torch, dev, base, params, prompt):
    """Prefill (``prefill_slot`` at the prompt's bucket: flash, ssd and the
    norm kernels vs chunked) and the first decode step (the norm kernels vs
    plain, from the chunked path's cache), fp32 with TF32 off and bf16.

    fp32 is gated at ``LOGIT_TOL``.  bf16 is printed and not gated: at full
    width with random weights the model amplifies a relative perturbation
    ~10**2-fold over a 512-position prefill, so one bf16 rounding (2**-8)
    anywhere moves the logits by O(1) on any path, and a whole-model bf16
    tolerance says nothing about the kernels.  The kernels' bf16 agreement
    is gated block by block instead (:func:`zamba_block_agreement`)."""
    from repro_torch.models import zamba

    out = {}
    plen = int(prompt.size)
    C = 1 << (plen - 1).bit_length()
    chunk = torch.zeros(1, C, dtype=torch.int32, device=dev)
    chunk[0, :plen] = torch.tensor(prompt, device=dev)
    lengths = torch.tensor([plen], dtype=torch.int32, device=dev)
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, compute_dtype=dt)
        p = zamba.cast_for_compute(cfg, params, dev)
        caches, logits = {}, {}
        for impl in ("kernel", "chunked"):
            c = {k: torch.zeros_like(s, device=dev)
                 for k, s in zamba.make_cache_specs(cfg, 1, MAX_LEN).items()}
            caches[impl], logits[impl] = zamba.prefill_slot(
                dataclasses.replace(cfg, attn_impl=impl), p, c, chunk, 0, plen)
        pre = rel_err(torch, logits["kernel"], logits["chunked"])
        tok = logits["chunked"].float().argmax(-1).to(torch.int32)
        dec = {}
        for impl in ("kernel", "chunked"):
            c = {k: v.clone() for k, v in caches["chunked"].items()}
            dec[impl], _ = zamba.decode_step(dataclasses.replace(cfg, attn_impl=impl), p, c,
                                             tok, lengths)
        d = rel_err(torch, dec["kernel"], dec["chunked"])
        row = dict(prefill_rel_err=pre, decode_rel_err=d, prompt_len=plen, bucket=C,
                   prefill_argmax_equal=bool(logits["kernel"].argmax() == logits["chunked"].argmax()),
                   decode_argmax_equal=bool(dec["kernel"].argmax() == dec["chunked"].argmax()),
                   tolerance=LOGIT_TOL[dt] if dt == "float32" else None)
        out[dt] = row
        log(f"zamba2 logits {dt}: {json.dumps(row)}" + ("" if row["tolerance"] else " (not gated)"))
        if row["tolerance"]:
            assert pre <= row["tolerance"] and d <= row["tolerance"], row
        del p, caches
    return out


def zamba_block_agreement(torch, dev, base, params, prompt):
    """At full width, from the same inputs, the kernel path's blocks
    against the plain path's: the shared block (flash + rmsnorm +
    rmsnorm_add) on the prompt's embedding, then Mamba2 layer 0 (rmsnorm +
    ssd) on its output, prefill at the prompt's bucket and one decode token
    per lane, bf16 and fp32 (TF32 off).  Each output within ``BLOCK_TOL``
    of its largest entry: bf16, a bf16 rounding or two (2**-8 relative
    each) where the paths round differently; fp32, summation order."""
    from repro_torch.models import ssm, zamba

    plen = int(prompt.size)
    C = 1 << (plen - 1).bit_length()
    tokens = torch.zeros(1, C, dtype=torch.int32, device=dev)
    tokens[0, :plen] = torch.tensor(prompt, device=dev)
    out = {}
    for dt in ("bfloat16", "float32"):
        cfg = dataclasses.replace(base, compute_dtype=dt)
        p = zamba.cast_for_compute(cfg, params, dev)
        x0 = zamba._embed(cfg, p, tokens)
        res = {}
        for impl in ("kernel", "chunked"):
            c = dataclasses.replace(cfg, attn_impl=impl)
            xs, (k, v) = zamba._shared_fwd(c, x0, x0, p["shared"])
            res[impl] = dict(shared=xs, k=k)
        xs = res["chunked"]["shared"]
        for impl in ("kernel", "chunked"):
            c = dataclasses.replace(cfg, attn_impl=impl)
            xm, (S, conv) = ssm.mamba_block_fwd(c, xs, zamba._layer(p, 0), return_state=True)
            res[impl].update(mamba=xm, ssm_state=S)
            xd = xm[0, :MAX_SLOTS]                       # 8 decode lanes
            res[impl]["shared_decode"] = zamba._shared_decode(
                c, xd, x0[0, :MAX_SLOTS], p["shared"],
                torch.zeros(MAX_SLOTS, C, cfg.n_kv, cfg.head_dim, dtype=xd.dtype, device=dev),
                torch.zeros(MAX_SLOTS, C, cfg.n_kv, cfg.head_dim, dtype=xd.dtype, device=dev),
                torch.arange(MAX_SLOTS, device=dev))
            res[impl]["mamba_decode"] = ssm.mamba_block_decode(
                c, xd, zamba._layer(p, 1), S[:1].expand(MAX_SLOTS, -1, -1, -1).contiguous(),
                conv[:1].expand(MAX_SLOTS, -1, -1).contiguous())[0]
        errs = {name: rel_err(torch, res["kernel"][name], res["chunked"][name])
                for name in res["kernel"]}
        out[dt] = dict(rel_err=errs, tolerance=BLOCK_TOL[dt], bucket=C)
        log(f"zamba2 blocks {dt}: {json.dumps(out[dt])}")
        assert all(e <= BLOCK_TOL[dt] for e in errs.values()), out[dt]
        del p, res
    return out


# ---------------------------------------------------------------------------
# Phase 4: the trainer at full width
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def bits(torch, x):
    """A float tensor's bits, for bitwise comparison (NaN/inf included)."""
    return x.contiguous().view(torch.int32)


def same_bits(torch, a, b) -> bool:
    from repro_torch.optim.flat import tree_leaves

    if isinstance(a, dict):
        la, lb = list(tree_leaves(a)), list(tree_leaves(b))
        return [p for p, _ in la] == [p for p, _ in lb] and all(
            same_bits(torch, x, y) for (_, x), (_, y) in zip(la, lb))
    if a.dtype == torch.float32:
        return a.shape == b.shape and bool(torch.equal(bits(torch, a), bits(torch, b)))
    return bool(torch.equal(a, b))


def train_run(torch, cfg, shape, group, opt, settings, steps):
    """``train.loop.train`` for ``steps`` steps; returns (result, per-step
    wall ms, per-step loss, per-step metrics).  The step times come from a
    synchronize in ``on_step``: the program itself makes no host sync."""
    from repro_torch.train import LoopConfig, train

    times, history = [], []
    torch.cuda.synchronize()
    t = [time.perf_counter()]

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append((now - t[0]) * 1e3)
        t[0] = now
        history.append(metrics)

    res = train(cfg, shape, group, opt, settings,
                LoopConfig(steps=steps, ckpt_every=0, log_every=0, seed=0), on_step=on_step)
    history = [{k: float(v) for k, v in m.items()} for m in history]
    return res, times, [m["loss"] for m in history], history


def eval_loss(torch, cfg, params, shape, group, slices: int = TRAIN_SLICES) -> float:
    """The loss of the stream's batch 0 (with its frontend extra) under
    ``params``, in the train step's slices (the mean of the slices' means,
    as the step reports)."""
    from repro_torch.data import make_batch_fn
    from repro_torch.models import registry
    from repro_torch.train.step import to_device

    batch = to_device(make_batch_fn(cfg, shape, 0)(0), group.device)
    parts = [{k: v.chunk(slices)[i] for k, v in batch.items()} for i in range(slices)]
    loss_fn = registry.get_module(cfg).loss_fn
    with torch.no_grad():
        return float(sum(loss_fn(cfg, params, mb, remat=False)[0] for mb in parts) / slices)


def step_agreement(torch, base, group, opt, shape, settings, dtypes=("float32", "bfloat16"),
                   tol=STEP_TOL, label: str = "", gate: bool = True):
    """Step 1 from the same weights and batch through the kernel path
    (every kernel wrapper and, on the flat programs, the flat_adam kernel)
    and the plain path (``attn_impl="chunked"``: chunked attention, the
    plain scan and norms, plain Adam), in fp32 compute with TF32 off (and
    in bf16 where ``dtypes`` has it); relative errors gated at ``tol`` (printed
    only, without ``gate``)."""
    from repro_torch.data import make_batch_fn
    from repro_torch.models import registry
    from repro_torch.train.step import build_train_step, opt_state_template

    batch = make_batch_fn(base, shape, 0)(0)
    out = {}
    for dt in dtypes:
        runs = {}
        for path, impl, kern in (("kernel", "kernel", None), ("plain", "chunked", False)):
            cfg = dataclasses.replace(base, attn_impl=impl, compute_dtype=dt)
            st = dataclasses.replace(settings, flat_kernel=kern)
            params = registry.get_module(cfg).init(cfg, seed=0, device=group.device)
            step_fn = build_train_step(cfg, group, opt, st)
            # the step's new state is dropped at once: only its metrics stay
            m = step_fn(params, opt_state_template(cfg, group, opt, st)(params), batch)[2]
            runs[path] = {k: float(m[k]) for k in ("loss", "grad_norm")}
            del params, m, step_fn
            free(torch)
        rel = {k: abs(runs["kernel"][k] - runs["plain"][k]) / abs(runs["plain"][k])
               for k in ("loss", "grad_norm")}
        out[dt] = dict(kernel=runs["kernel"], plain=runs["plain"], rel_err=rel,
                       tolerance=tol[dt], layers=base.n_layers)
        log(f"step 1 agreement {label}{dt}: {json.dumps(out[dt])}")
        assert not gate or all(rel[k] <= tol[dt][k] for k in rel), out[dt]
    return out


def skip_is_noop(torch, cfg, group, opt, settings, params, opt_state, batch) -> dict:
    """One step on inf-poisoned parameters: skipped == 1 and p, m, v and the
    step counter bitwise as they were."""
    from repro_torch.optim.flat import flatten, unflatten
    from repro_torch.train.step import build_train_step, flat_layout_for

    layout = flat_layout_for(cfg)
    flat = flatten(layout, params).clone()
    # ln_f's first element: every family reads it at every position
    flat[layout.offsets[layout.paths.index(("ln_f",))]] = float("inf")
    bad = unflatten(layout, flat)
    before = {k: (v.clone() if torch.is_tensor(v) else
                  unflatten(layout, flatten(layout, v).clone())) for k, v in opt_state.items()}
    step_fn = build_train_step(cfg, group, opt, settings)
    p2, o2, m = step_fn(bad, opt_state, batch)
    torch.cuda.synchronize()
    out = dict(skipped=float(m["skipped"]), params_bitwise=same_bits(torch, p2, bad),
               state_bitwise=same_bits(torch, o2, before))
    assert out["skipped"] == 1.0 and out["params_bitwise"] and out["state_bitwise"], out
    return out


def checkpoint_roundtrip(torch, params, opt_state, tmp: Path) -> dict:
    """Save the trainer's state and restore it: every leaf bitwise, each
    restored leaf compared on the card with the one it was saved from."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim.flat import tree_leaves

    shutil.rmtree(tmp, ignore_errors=True)
    t = time.perf_counter()
    mgr = CheckpointManager(str(tmp), keep_k=1)
    tree = {"params": params, "opt": opt_state}
    mgr.save(6, tree)
    saved = time.perf_counter() - t
    step, state = mgr.restore(tree)
    restored = dict(tree_leaves(state))
    ok = step == 6 and all(
        same_bits(torch, torch.as_tensor(restored.pop(path)).to(leaf.device), leaf)
        for path, leaf in tree_leaves(tree)) and not restored
    shutil.rmtree(tmp, ignore_errors=True)
    out = dict(step=step, bitwise=ok, save_s=saved, total_s=time.perf_counter() - t)
    assert ok, out
    return out


def profile_train_step(torch, cfg, group, opt, settings, run: dict, batch):
    """Device time of one train step by kernel, from ``torch.profiler``
    (device activity only: the step dispatches some 10^5 ops, and
    host-side events would multiply the trace); the idle share is taken
    against the same step run unprofiled.  ``run`` (the loop's result) gives
    up its ``params`` and ``opt_state``, so that the two steps hold no
    third copy of the state."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.step import build_train_step

    step_fn = build_train_step(cfg, group, opt, settings)
    torch.cuda.synchronize()
    t = time.perf_counter()
    p, o, _ = step_fn(run.pop("params"), run.pop("opt_state"), batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step_fn(p, o, batch)
        torch.cuda.synchronize()
    t = time.perf_counter()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    log(f"train profile: {len(kernels)} kernel names, read in {time.perf_counter() - t:.1f} s")
    if not kernels:
        log("train profile: torch.profiler recorded no device activity (not measured)")
        return None
    total_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    out = dict(step_ms_unprofiled=step_ms, device_busy_ms=total_us / 1e3,
               device_idle_share=1 - total_us / 1e3 / step_ms,
               kernel_launches=sum(e.count for e in kernels),
               top=[dict(name=e.key[:80], calls=e.count,
                         ms=e.self_device_time_total / 1e3) for e in top],
               port_kernels=port_kernels(kernels, 1))
    log(f"train profile: {json.dumps(out)}")
    return out


def train_path(torch, dev, results):
    """Phase 4: the faithful and ZeRO programs at full width and
    ``TRAIN_LAYERS`` layers over a 1-rank NCCL group.  Returns the launch
    counts of the faithful run."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch_fn
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flat_adam.ops import flat_adam
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add
    from repro_torch.launch.mesh import init_group
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainSettings

    full = get_config("smollm-360m")
    assert full.n_layers == N_LAYERS and full.compute_dtype == "bfloat16"
    base = dataclasses.replace(full, attn_impl="kernel", n_layers=TRAIN_LAYERS)
    shape = ShapeConfig("chip-smoke", "train", TRAIN_SEQ, TRAIN_BATCH)
    opt = OptConfig(kind="adam")
    group = init_group("nccl", 0, 1, f"tcp://127.0.0.1:{free_port()}", device=dev)
    out = {}
    try:
        programs = (("faithful", TrainSettings(num_slices=TRAIN_SLICES, faithful=True), 3),
                    ("zero", TrainSettings(num_slices=TRAIN_SLICES, flat_engine="zero"), 2))
        launches = {}
        for name, settings, steps in programs:
            torch.cuda.reset_peak_memory_stats()
            kernels = (flat_adam, flash_attention, rmsnorm, rmsnorm_add)
            for k in kernels:
                k.launches = 0
            res, times, losses, _ = train_run(torch, base, shape, group, opt, settings,
                                              steps)
            launches[name] = {k.__name__: k.launches for k in kernels}
            warm = times[1:]
            row = dict(steps=steps, losses=losses, step_ms=times,
                       step_ms_median=float(np.median(warm)),
                       step_ms_p90=float(np.percentile(warm, 90)),
                       tokens_per_s=TRAIN_SEQ * TRAIN_BATCH / (np.median(warm) / 1e3),
                       max_memory_allocated=torch.cuda.max_memory_allocated(),
                       skipped_steps=res["skipped_steps"], launches=launches[name])
            log(f"train {name}: {json.dumps(row)}")
            assert all(np.isfinite(losses)) and res["skipped_steps"] == 0, row
            assert launches[name]["flat_adam"] == steps, row
            assert launches[name]["flash_attention"] == \
                2 * TRAIN_LAYERS * TRAIN_SLICES * steps, row
            # per slice: ln1 and ln2 (with its add) in each layer, forward
            # and remat's recompute, and ln_f once
            assert launches[name]["rmsnorm"] == (2 * TRAIN_LAYERS + 1) * TRAIN_SLICES * steps, \
                row
            assert launches[name]["rmsnorm_add"] == 2 * TRAIN_LAYERS * TRAIN_SLICES * steps, row
            if name == "faithful":
                # each step's batch is new, and the stream's map has to be
                # learned token by token, so the per-step loss stays near
                # ln(vocab) for many steps; the loss falls where training
                # has been: on batch 0, re-evaluated after the run
                row["batch0_loss_after"] = eval_loss(torch, base, res["params"], shape, group)
                log(f"train faithful: batch 0 loss {losses[0]:.4f} at step 1, "
                    f"{row['batch0_loss_after']:.4f} after {steps} steps")
                assert row["batch0_loss_after"] < losses[0], row
            batch = make_batch_fn(base, shape, 0)(steps)
            row["skip"] = skip_is_noop(torch, base, group, opt, settings, res["params"],
                                       res["opt_state"], batch)
            log(f"train {name} skip step: {json.dumps(row['skip'])}")
            if name == "faithful":
                row["checkpoint"] = checkpoint_roundtrip(
                    torch, res["params"], res["opt_state"], HERE / "build" / "ckpt_smoke")
                log(f"train checkpoint: {json.dumps(row['checkpoint'])}")
                results["train_profile"] = profile_train_step(
                    torch, base, group, opt, settings, res, batch)
            out[name] = row
            del res
        out["step1"] = step_agreement(torch, base, group, opt, shape, programs[0][1])
    finally:
        group.close()
    results["train"] = out
    return launches["faithful"]


# ---------------------------------------------------------------------------
# Phase 6: the function API (core) at full width
# ---------------------------------------------------------------------------

APPENDIX_LR = 0.05
# the full-width loss through synk.function, fp32 with TF32 off: the
# sliced and direct losses are the same fp32 sums in another grouping
FUNCTION_TOL = dict(loss=1e-5, grad_norm=1e-4)
FUNCTION_ROWS, FUNCTION_SEQ, FUNCTION_CORPUS = 8, 256, 64


def appendix_a(torch, synk) -> dict:
    """The paper's Appendix A program in the port's API, as the reference's
    ``examples/synk_sgd.py`` runs it: a small CNN on 2048 class-shifted
    16 x 16 images, per-worker SGD steps through ``synk.function`` on
    ``synk.data`` with ``batch=`` indices, then ``all_reduce(..., "avg")``
    of the workers' parameters; 10 epochs of batch 256.  The weights come
    from numpy (seed 0), not ``jax.random``."""
    import torch.nn.functional as F

    def forward(p, x):
        x = F.max_pool2d(F.relu(F.conv2d(x, p["conv"], padding=1)), 2)
        return F.relu(x.reshape(x.shape[0], -1) @ p["w1"]) @ p["w2"]

    def train_fn(x, y, params):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = F.cross_entropy(forward(p, x), y.long())
        grads = torch.autograd.grad(loss, list(p.values()))
        return loss, {k: v - APPENDIX_LR * g for (k, v), g in zip(p.items(), grads)}

    ctx = synk.current()
    train = synk.function(train_fn, inputs=[synk.Scatter(), synk.Scatter(), synk.Broadcast()],
                          outputs=(synk.Reduce("mean"), synk.Reduce(None)))
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2048, 1, 16, 16)).astype(np.float32)
    labels = rng.integers(0, 10, size=(2048,)).astype(np.int32)
    X += labels[:, None, None, None] * 0.6
    X_train, y_train = synk.data(X), synk.data(labels)
    init = np.random.default_rng(0)
    params_local = synk.distribute({
        "conv": (init.normal(size=(8, 1, 3, 3)) * 0.3).astype(np.float32),
        "w1": (init.normal(size=(8 * 8 * 8, 64)) * 0.05).astype(np.float32),
        "w2": (init.normal(size=(64, 10)) * 0.1).astype(np.float32)})
    t = time.perf_counter()
    losses = []
    for _ in range(10):
        order = rng.permutation(len(X_train))
        for i in range(0, len(order), 256):
            host_params = synk.get_value(params_local, 0)
            loss, new = train(X_train, y_train, host_params, batch=order[i:i + 256])
            # Reduce(None) is the workers' stack: this rank keeps its row
            mine = {k: v[ctx.rank] for k, v in new.items()}
            params_local = synk.all_reduce(synk.LocalValues(mine), "avg")
        losses.append(float(loss))
    seconds = time.perf_counter() - t
    final = synk.as_replicated(params_local, check=False)
    with torch.no_grad():
        pred = forward(final, torch.from_numpy(X[:256]).to(ctx.device)).argmax(-1).cpu().numpy()
    out = dict(epochs=10, steps=train.stats["calls"], epoch_losses=losses, seconds=seconds,
               train_accuracy=float((pred == labels[:256]).mean()), stats=train.stats)
    log(f"appendix A (synk SGD, 1 worker on the card): {json.dumps(out)}")
    assert out["train_accuracy"] > 0.4, out
    return out


def function_path(torch, dev, results):
    """Phase 6: ``repro_torch.core`` on the card, one worker (``fork()``
    without a torchrun environment): the Appendix A program, then the
    full-width smollm-360m loss and gradients through ``synk.function``
    (flash and RMSNorm kernels inside), sliced and not, against a direct
    ``lm.loss_fn`` and autograd on the same rows."""
    import repro_torch.core as synk
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves, map_tree, unflatten
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add
    from repro_torch.models import lm

    synk.reset()
    ctx = synk.fork()
    assert (ctx.n_data, ctx.device.type) == (1, dev.type), ctx      # the card
    out = {"appendix_a": appendix_a(torch, synk)}

    cfg = dataclasses.replace(get_config("smollm-360m"), attn_impl="kernel",
                              compute_dtype="float32")
    assert cfg.n_layers == N_LAYERS
    params = lm.init(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    corpus = rng.integers(0, cfg.vocab, (FUNCTION_CORPUS, FUNCTION_SEQ + 1)).astype(np.int32)
    ds = synk.scatter_data(corpus)
    ids = rng.permutation(FUNCTION_CORPUS)[:FUNCTION_ROWS]

    def loss_and_grads(tokens, params):
        p = map_tree(lambda t: t.detach().requires_grad_(), params)
        loss, _ = lm.loss_fn(cfg, p, {"tokens": tokens})
        return loss, unflatten(p, torch.autograd.grad(loss, leaves(p)))

    def norm(grads):
        return float(torch.sqrt(sum((g.double() ** 2).sum() for g in leaves(grads))))

    f = synk.function(loss_and_grads, [synk.Scatter(), synk.Broadcast()],
                      (synk.Reduce("mean"), synk.Reduce("mean")))
    runs = {}
    for name, slices in (("warm", 1), ("slices_1", 1), ("slices_2", 2)):
        for k in (flash_attention, rmsnorm, rmsnorm_add):
            k.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, grads = f(ds, params, batch=ids, num_slices=slices)
        torch.cuda.synchronize()
        runs[name] = dict(host_ms=(time.perf_counter() - t) * 1e3, loss=float(loss),
                          grad_norm=norm(grads),
                          launches={k.__name__: k.launches
                                    for k in (flash_attention, rmsnorm, rmsnorm_add)})
        del grads
    rows = torch.from_numpy(corpus[ids]).to(dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss, grads = loss_and_grads(rows, params)
    torch.cuda.synchronize()
    runs["direct"] = dict(host_ms=(time.perf_counter() - t) * 1e3, loss=float(loss.detach()),
                          grad_norm=norm(grads))
    del grads
    rel = {name: {k: abs(runs[name][k] - runs["direct"][k]) / abs(runs["direct"][k])
                  for k in ("loss", "grad_norm")} for name in ("slices_1", "slices_2")}
    rel["slices_2_vs_1"] = {k: abs(runs["slices_2"][k] - runs["slices_1"][k])
                            / abs(runs["slices_1"][k]) for k in ("loss", "grad_norm")}
    out["loss"] = dict(rows=FUNCTION_ROWS, seq=FUNCTION_SEQ, dtype="float32", runs=runs,
                       rel_err=rel, tolerance=FUNCTION_TOL, stats=f.stats)
    log(f"synk.function loss (smollm-360m, full width, fp32): {json.dumps(out['loss'])}")
    for r in rel.values():
        assert all(r[k] <= FUNCTION_TOL[k] for k in r), rel
    for name, slices in (("slices_1", 1), ("slices_2", 2)):
        # per slice: forward and remat's recompute of each layer
        n = runs[name]["launches"]
        assert n["flash_attention"] == 2 * N_LAYERS * slices, runs
        assert n["rmsnorm"] == (2 * N_LAYERS + 1) * slices, runs
        assert n["rmsnorm_add"] == 2 * N_LAYERS * slices, runs
    st = f.stats
    assert st["builds"] == 2 and st["calls"] == 3 and st["device_put_skips"] > 0, st
    results["function_api"] = out
    synk.reset()
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 7: full-width gemma2-27b on the paged engine
# ---------------------------------------------------------------------------


def free(torch):
    """Drop what the earlier work left unreferenced, cycles included, and
    return the allocator's cached blocks to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def gemma2_launches(pre: int, dec: int) -> dict:
    """Launches of a gemma2-27b serving run: per prefill flash in each
    layer; per decode step paged in each layer; per prefill and decode
    step ``ln1`` and the post-norms ``ln1b``/``ln2b`` in each layer and
    ``ln_f`` (rmsnorm), ``ln2`` with its residual add in each layer
    (rmsnorm_add)."""
    L = GEMMA_LAYERS
    return {"flash_attention": L * pre, "paged_attention": L * dec,
            "rmsnorm": (3 * L + 1) * (pre + dec), "rmsnorm_add": L * (pre + dec)}


def stablelm_launches(pre: int, dec: int) -> dict:
    """Launches of a stablelm-12b serving run (a plain llama stack): flash
    in each layer a prefill, paged in each layer a decode step, ``ln1`` in
    each layer and ``ln_f`` (rmsnorm) and ``ln2`` with its residual add
    (rmsnorm_add) a prefill and a decode step."""
    L = STABLELM_LAYERS
    return {"flash_attention": L * pre, "paged_attention": L * dec,
            "rmsnorm": (L + 1) * (pre + dec), "rmsnorm_add": L * (pre + dec)}


def moe_launches(pre: int, dec: int) -> dict:
    """Launches of a qwen3-moe-30b-a3b serving run: flash and paged as
    stablelm's; rmsnorm also on the q and k heads (``qk_norm``: ``ln1``,
    ``qnorm`` and ``knorm`` in each layer, ``ln_f``).  The MoE layer
    launches no kernel of the port."""
    L = MOE_LAYERS
    return {"flash_attention": L * pre, "paged_attention": L * dec,
            "rmsnorm": (3 * L + 1) * (pre + dec), "rmsnorm_add": L * (pre + dec)}


def layer_windows(cfg) -> list[int]:
    """Each layer's attention window (0: full causal): gemma2's pairs are
    (local, global)."""
    return [cfg.window if not cfg.alt_local_global or i % 2 == 0 else 0
            for i in range(cfg.n_layers)]


def kv_read_bytes(cfg, lens) -> int:
    """bf16 K and V bytes a decode step reads for lanes of ``lens``
    positions, each layer within its window."""
    pos = sum(min(n, w) if w else n for w in layer_windows(cfg) for n in lens)
    return pos * 2 * cfg.n_kv * cfg.head_dim * 2


def prefill_work(cfg, n: int) -> tuple[int, int]:
    """(attention, matmul) operations of a dense prefill over ``n``
    positions: causal pairs in each layer (within the window in gemma2's
    local ones), and every block matmul once a position."""
    H, dh = cfg.n_heads, cfg.head_dim
    pairs = sum(sum(min(i + 1, w) for i in range(n)) if w else n * (n + 1) // 2
                for w in layer_windows(cfg))
    emb = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return 4 * dh * H * pairs, 2 * n * (cfg.n_params_dense - emb)


def profile_long_prefill(torch, dev, cfg, params, prompt, bucket: int, label: str) -> dict | None:
    """Device time of one long prompt's prefill as the engine runs it
    (``prefill_slot_paged`` at the prompt's bucket, kernel path), beside
    its bound: the weights read once and the operations the prompt needs
    (its own positions, not the bucket's padding, and the last row's
    logits) at 989 TFLOP/s.  The bucket's figure, the work the engine
    chose to do, is printed beside it as ``padded_bound_ms``."""
    from repro_torch.models import lm

    plen = int(prompt.size)
    nb = bucket // PAGE
    table = torch.zeros(nb, dtype=torch.int32, device=dev)
    table[: plen // PAGE + 1] = torch.arange(1, plen // PAGE + 2, dtype=torch.int32)
    chunk = torch.zeros(1, bucket, dtype=torch.int32, device=dev)
    chunk[0, :plen] = torch.tensor(prompt, device=dev)
    cache = {k: torch.zeros_like(s, device=dev)
             for k, s in lm.make_paged_cache_specs(cfg, plen // PAGE + 2, PAGE).items()}
    run = lambda: lm.prefill_slot_paged(cfg, params, cache, chunk, table, plen)
    t = time.perf_counter()
    run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    ms, kernels = device_profile(torch, run, 2)
    if ms is None:
        log(f"{label} long prefill: torch.profiler recorded no device activity (not measured)")
        return None
    logits = 2 * cfg.d_model * cfg.vocab
    weights = param_bytes(params)
    attn, matmul = prefill_work(cfg, plen)
    padded_attn, padded_matmul = prefill_work(cfg, bucket)
    out = dict(bucket=bucket, prompt_len=plen, device_ms=ms, host_ms=host_ms,
               launches=sum(v["calls"] for v in kernels.values()),
               attention_tflop=attn / 1e12, matmul_tflop=matmul / 1e12,
               padded_attention_tflop=padded_attn / 1e12,
               padded_matmul_tflop=padded_matmul / 1e12,
               flash_ms=sum(v["ms"] for k, v in kernels.items() if "flash_fwd_kernel" in k),
               top=sorted(({"name": k, **v} for k, v in kernels.items()),
                          key=lambda e: -e["ms"])[:6])
    out["bound_ms"], out["bound_by"] = bound(attn + matmul + logits, weights, "bfloat16")
    out["padded_bound_ms"], _ = bound(padded_attn + padded_matmul + logits, weights,
                                      "bfloat16")
    log(f"{label} long prefill: {json.dumps(out)}")
    return out


def serve_phase(torch, dev, results, key: str, label: str, cfg, params, reqs, ec,
                predict) -> tuple[dict, dict]:
    """A full-width model through the engine (``ec``'s layout) on the
    kernel path (flash, paged, rmsnorm, rmsnorm_add): a warm-up, the graph check (8
    replays against the eager program, ``results[key + "_graph_check"]``),
    then the measured run with the counts set to 0 just before it.  Gates:
    every request ``ok`` with its budget; the launches ``predict(prefills,
    decode steps)``; after ``prebuild`` the three decode forms and a
    prefill per bucket, flat through the run and a second serve, one
    decode graph.  Returns (the run's figures, the launches)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add

    serve(torch, cfg, params, [(reqs[2][0][:16], 4), (reqs[3][0][:32], 4)], ec, dev)
    free(torch)
    results[f"{key}_graph_check"] = graph_check(torch, cfg, params, reqs, ec, dev)
    free(torch)
    kernels = (flash_attention, paged_attention, rmsnorm, rmsnorm_add)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    eng, rids, steps, prefilled, wall = serve(torch, cfg, params, reqs, ec, dev, check=True,
                                              prebuild=True)
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    st = eng.stats
    comps = [eng.completions[r] for r in rids]
    bad = [(c.rid, c.status, len(c.tokens), b) for c, (_, b) in zip(comps, reqs)
           if c.status != "ok" or len(c.tokens) != b]
    assert not bad, f"requests not served in full: {bad}"
    pre, dec = st["prefills"], st["decode_steps"]
    want = predict(pre, dec)
    assert launches == want and pre == len(reqs) and dec > 0, (launches, want, st)
    # prebuild: the decode program of each sampling form and the prefill of
    # each bucket, nothing more through the run (``serve`` checks it), and
    # the one decode graph captured at the first decode step
    programs = dict(builds=st["builds"], buckets=list(eng.buckets), graphs=st["graphs"],
                    decode_graph_build_s=list(eng.graphs.build_seconds.values()))
    assert st["builds"] == 3 + len(eng.buckets) and st["graphs"] == 1, programs
    streams = [list(c.tokens) for c in comps]
    programs["steady"] = steady_builds(eng, reqs[2:6])
    tokens = sum(len(c.tokens) for c in comps)
    decode_only = [t for t, p in zip(steps, prefilled) if not p]
    e2e = dict(requests=len(comps), tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
               prefills=pre, decode_steps=dec, prompt_tokens=st["prefill_tokens"],
               decode_step_ms_median=float(np.median(decode_only)),
               decode_step_ms_p90=float(np.percentile(decode_only, 90)),
               decode_only_steps=len(decode_only), step_ms_mean=wall * 1e3 / len(steps),
               kv_reserved_bytes=st["kv_reserved_bytes"],
               kv_peak_used_bytes=st["kv_peak_used_bytes"], weights_bytes=param_bytes(params),
               max_memory_allocated=peak, launches=launches, launches_expected=want,
               programs=programs)
    log(f"{label} ({ec.kv_layout}, kernels, decode graph) [{results['nvidia_smi']}]: "
        f"{tokens} tokens "
        f"in {wall:.3f} s = {tokens / wall:.1f} tok/s; decode step median "
        f"{e2e['decode_step_ms_median']:.2f} ms, p90 {e2e['decode_step_ms_p90']:.2f} ms over "
        f"{len(decode_only)} decode-only steps; launches {launches}; peak memory "
        f"{peak / 1e9:.2f} GB (weights {e2e['weights_bytes'] / 1e9:.2f}); "
        f"programs {json.dumps(programs)}")
    del eng
    free(torch)
    # the same traffic again on a fresh engine: the same streams
    eng, rids, *_ = serve(torch, cfg, params, reqs, ec, dev)
    again = [list(eng.completions[r].tokens) for r in rids]
    e2e["second_run_streams_equal"] = again == streams
    assert again == streams, "a second run's streams differ"
    del eng
    free(torch)
    return e2e, launches


def decode_profile(torch, dev, results, label, cfg, params, reqs, ec, flops: float,
                   steps: int = 5, windows: int = 1):
    """``profile_decode`` of the first 8 requests, beside the step's bound:
    the weights and the KV the lanes read (~10 tokens past their prompts,
    as the profiled steps are) over 3.35 TB/s, or ``flops`` at 989
    TFLOP/s."""
    prof = profile_decode(torch, cfg, params, reqs, ec, dev, steps=steps, windows=windows)
    if prof is not None:
        lens = [int(p.size) + 8 for p, _ in reqs[:MAX_SLOTS]]   # ~ the profiled steps'
        nbytes = param_bytes(params) + kv_read_bytes(cfg, lens)
        prof["bound_ms"], prof["bound_by"] = bound(flops, nbytes, "bfloat16")
        prof["bound_bytes"] = nbytes
        log(f"{label} decode step: {prof['kernel_launches_per_step']:.0f} launches, "
            f"{prof['device_ms_per_step']:.3f} device ms, idle share "
            f"{prof['device_idle_share']:.3f}, bound {prof['bound_ms']:.3f} ms "
            f"({prof['bound_by']}) [{results['nvidia_smi']}]")
    free(torch)
    return prof


def fp32_logits(torch, dev, base, layers: int, prompt, steps: int) -> dict:
    """``logit_agreement`` in fp32 (TF32 off) at full width and ``layers``
    layers: the full-depth fp32 model does not fit the card."""
    from repro_torch.models import lm

    c32 = dataclasses.replace(base, n_layers=layers, compute_dtype="float32")
    p32 = lm.init(c32, seed=0, device=dev)
    log(f"{base.name} fp32 logit check cut to {layers} layers "
        f"({param_bytes(p32) / 1e9:.2f} GB of fp32 weights)")
    out = logit_agreement(torch, dev, [(c32, p32)], prompt, steps=steps)
    del p32
    free(torch)
    return out


def gemma2_path(torch, dev, results):
    """Full-width gemma2-27b (46 layers, bf16) through the paged engine on
    the kernel path (flash, paged, rmsnorm, rmsnorm_add).  Returns the
    launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import EngineConfig, bucket_for, prompt_buckets

    free(torch)
    at_entry = torch.cuda.memory_allocated()
    log(f"phase 7: {at_entry / 1e9:.3f} GB allocated at entry")
    base = get_config("gemma2-27b")
    assert base.n_layers == GEMMA_LAYERS and base.window == GEMMA_WINDOW
    assert base.attn_softcap == GEMMA_SOFTCAP and base.alt_local_global
    cfg = dataclasses.replace(base, attn_impl="kernel", param_dtype="bfloat16")
    t = time.perf_counter()
    params = lm.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    weights = param_bytes(params)
    reqs = gemma2_requests(cfg.vocab)
    ec = EngineConfig(max_slots=MAX_SLOTS, max_len=GEMMA_MAX_LEN, kv_layout="paged",
                      page_size=PAGE, paged_attn="kernel", num_blocks=GEMMA_BLOCKS)
    pool = GEMMA_BLOCKS * PAGE * 2 * GEMMA_LAYERS * cfg.n_kv * cfg.head_dim * 2
    long_buckets = [bucket_for(int(p.size), prompt_buckets(GEMMA_MAX_LEN)) for p, _ in reqs[:2]]
    log(f"gemma2-27b: {weights / 1e9:.2f} GB of bf16 weights made in {init_s:.1f} s; pool "
        f"{GEMMA_BLOCKS} blocks = {pool / 1e9:.2f} GB; long prompts "
        f"{[int(p.size) for p, _ in reqs[:2]]} at bucket {long_buckets}")
    e2e, launches = serve_phase(torch, dev, results, "gemma2", "gemma2-27b", cfg, params, reqs,
                                ec, gemma2_launches)
    e2e.update(long_prompts=[int(p.size) for p, _ in reqs[:2]], long_buckets=long_buckets,
               pool_bytes=pool, memory_allocated_at_entry=at_entry, init_s=init_s)
    results["gemma2_profile"] = decode_profile(torch, dev, results, "gemma2", cfg, params,
                                               reqs, ec, 2 * MAX_SLOTS * cfg.n_params_dense)
    e2e["long_prefill"] = profile_long_prefill(torch, dev, cfg, params, reqs[0][0],
                                               long_buckets[0], "gemma2")
    free(torch)
    results["gemma2_logits"] = logit_agreement(torch, dev, [(cfg, params)], reqs[0][0],
                                               steps=GEMMA_LOGIT_STEPS)
    del params
    free(torch)
    results["gemma2_logits"].update(fp32_logits(torch, dev, base, GEMMA_FP32_LAYERS,
                                                reqs[0][0], GEMMA_LOGIT_STEPS))
    results["gemma2"] = e2e
    return launches


# ---------------------------------------------------------------------------
# Phase 8: full-width stablelm-12b on the paged engine
# ---------------------------------------------------------------------------


def stablelm_path(torch, dev, results):
    """Full-width stablelm-12b (40 layers, head dim 160, bf16) through the
    paged engine on the kernel path, on phase 7's traffic.  Returns the
    launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import EngineConfig, bucket_for, prompt_buckets

    free(torch)
    at_entry = torch.cuda.memory_allocated()
    log(f"phase 8: {at_entry / 1e9:.3f} GB allocated at entry")
    base = get_config("stablelm-12b")
    assert base.n_layers == STABLELM_LAYERS and base.head_dim == 160 and not base.window
    cfg = dataclasses.replace(base, attn_impl="kernel", param_dtype="bfloat16")
    t = time.perf_counter()
    params = lm.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    weights = param_bytes(params)
    reqs = gemma2_requests(cfg.vocab)
    ec = EngineConfig(max_slots=MAX_SLOTS, max_len=STABLELM_MAX_LEN, kv_layout="paged",
                      page_size=PAGE, paged_attn="kernel", num_blocks=STABLELM_BLOCKS)
    pool = STABLELM_BLOCKS * PAGE * 2 * STABLELM_LAYERS * cfg.n_kv * cfg.head_dim * 2
    long_buckets = [bucket_for(int(p.size), prompt_buckets(STABLELM_MAX_LEN))
                    for p, _ in reqs[:2]]
    log(f"stablelm-12b: {weights / 1e9:.2f} GB of bf16 weights made in {init_s:.1f} s; pool "
        f"{STABLELM_BLOCKS} blocks = {pool / 1e9:.2f} GB; long prompts "
        f"{[int(p.size) for p, _ in reqs[:2]]} at bucket {long_buckets}")
    e2e, launches = serve_phase(torch, dev, results, "stablelm", "stablelm-12b", cfg, params,
                                reqs, ec, stablelm_launches)
    e2e.update(long_prompts=[int(p.size) for p, _ in reqs[:2]], long_buckets=long_buckets,
               pool_bytes=pool, memory_allocated_at_entry=at_entry, init_s=init_s)
    results["stablelm_profile"] = decode_profile(torch, dev, results, "stablelm", cfg, params,
                                                 reqs, ec, 2 * MAX_SLOTS * cfg.n_params_dense)
    e2e["long_prefill"] = profile_long_prefill(torch, dev, cfg, params, reqs[0][0],
                                               long_buckets[0], "stablelm")
    free(torch)
    results["stablelm_logits"] = logit_agreement(torch, dev, [(cfg, params)], reqs[0][0],
                                                 steps=GEMMA_LOGIT_STEPS)
    del params
    free(torch)
    results["stablelm_logits"].update(fp32_logits(torch, dev, base, STABLELM_FP32_LAYERS,
                                                  reqs[0][0], GEMMA_LOGIT_STEPS))
    results["stablelm"] = e2e
    return launches


# ---------------------------------------------------------------------------
# Phase 9: full-width qwen3-moe-30b-a3b on the paged engine
# ---------------------------------------------------------------------------


def moe_drop_fracs(torch, dev, cfg, params, reqs, max_len: int) -> dict:
    """Each request's prefill recomputed as the engine runs it (the prompt
    right-padded with zeros to its bucket): the largest ``drop_frac`` of
    its layers (the reference forward's aux) and their mean, and each
    layer's mean over the requests."""
    from repro_torch.models import lm
    from repro_torch.serve import bucket_for, prompt_buckets

    layers = []
    for p, _ in reqs:
        chunk = torch.zeros(1, bucket_for(int(p.size), prompt_buckets(max_len)),
                            dtype=torch.int32, device=dev)
        chunk[0, : p.size] = torch.tensor(p, device=dev)
        aux = {}
        lm.forward(cfg, params, chunk, remat=False, aux=aux)
        layers.append(aux["drop_frac_layers"].tolist())
    by_layer = np.asarray(layers)
    return dict(max=by_layer.max(1).tolist(), mean=by_layer.mean(1).tolist(),
                layer_mean=by_layer.mean(0).tolist())


def moe_path(torch, dev, results):
    """Full-width qwen3-moe-30b-a3b (48 layers, 128 experts top-8, bf16)
    through the paged engine on the kernel path, on phase 3's traffic.
    Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.moe import expert_capacity
    from repro_torch.serve import EngineConfig

    free(torch)
    at_entry = torch.cuda.memory_allocated()
    log(f"phase 9: {at_entry / 1e9:.3f} GB allocated at entry")
    base = get_config("qwen3-moe-30b-a3b")
    assert base.n_layers == MOE_LAYERS and base.family == "moe" and base.qk_norm
    cfg = dataclasses.replace(base, attn_impl="kernel", param_dtype="bfloat16")
    t = time.perf_counter()
    params = lm.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    weights = param_bytes(params)
    reqs = requests(cfg.vocab)
    # the pool cut to the traffic: 8 lanes of max_len 1024, the engine's
    # default (max_slots * max_len / page + 1 blocks)
    ec = EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN, kv_layout="paged",
                      page_size=PAGE, paged_attn="kernel")
    blocks = MAX_SLOTS * MAX_LEN // PAGE + 1
    pool = blocks * PAGE * 2 * MOE_LAYERS * cfg.n_kv * cfg.head_dim * 2
    log(f"qwen3-moe-30b-a3b: {weights / 1e9:.2f} GB of bf16 weights made in {init_s:.1f} s; "
        f"pool {blocks} blocks = {pool / 1e9:.2f} GB; decode capacity "
        f"{expert_capacity(MAX_SLOTS, cfg)} slots an expert")
    e2e, launches = serve_phase(torch, dev, results, "moe", "qwen3-moe-30b-a3b", cfg, params,
                                reqs, ec, moe_launches)
    e2e.update(pool_bytes=pool, pool_blocks=blocks, memory_allocated_at_entry=at_entry,
               init_s=init_s, decode_capacity=expert_capacity(MAX_SLOTS, cfg))
    e2e["prefill_drop_frac"] = moe_drop_fracs(torch, dev, cfg, params, reqs, MAX_LEN)
    log(f"qwen3-moe prefill drop_frac (per request: the largest layer's, the "
        f"layers' mean; each layer's mean): {json.dumps(e2e['prefill_drop_frac'])}")
    free(torch)
    # the (E, C) layout's products read every expert a step: the operations
    # are those of E x C slots, the bytes all the weights
    E, F_, D = cfg.moe.num_experts, cfg.moe.d_expert, cfg.d_model
    expert_ops = 2 * MOE_LAYERS * E * expert_capacity(MAX_SLOTS, cfg) * 3 * D * F_
    dense_ops = 2 * MAX_SLOTS * (cfg.n_params_dense - MOE_LAYERS * 3 * D * F_ * E)
    results["moe_profile"] = decode_profile(torch, dev, results, "qwen3-moe", cfg, params,
                                            reqs, ec, expert_ops + dense_ops, steps=3,
                                            windows=4)
    results["moe_logits"] = logit_agreement(torch, dev, [(cfg, params)], reqs[0][0],
                                            steps=GEMMA_LOGIT_STEPS)
    del params
    free(torch)
    results["moe_logits"].update(fp32_logits(torch, dev, base, MOE_FP32_LAYERS, reqs[0][0],
                                             GEMMA_LOGIT_STEPS))
    results["moe"] = e2e
    return launches


# ---------------------------------------------------------------------------
# Phase 10: full-width xlstm-1.3b on the slotted engine
# ---------------------------------------------------------------------------


def xlstm_launches(pre: int, dec: int) -> dict:
    """Launches of an xlstm-1.3b serving run: each block's ``ln`` and
    ``out_ln`` and ``ln_f`` (rmsnorm) a prefill and a decode step.  The
    cells are plain PyTorch (plain jnp in the reference), and no norm of
    the family takes a residual."""
    return {"flash_attention": 0, "paged_attention": 0,
            "rmsnorm": (2 * XLSTM_LAYERS + 1) * (pre + dec), "rmsnorm_add": 0}


def xlstm_prefill(torch, dev, cfg, params, iters: int = 3) -> dict:
    """One lane's prefill (``prefill_slot``) of a ``XLSTM_PREFILL``-token
    prompt on the kernel path: host ms (median of ``iters``, synchronized),
    then device ms, launches and the top kernels from the profiler, the idle
    share against the host time, and the bound: the weights read once, or
    the prompt's products (every weight twice a position) at 989 TFLOP/s."""
    from repro_torch.models import xlstm_lm

    T = XLSTM_PREFILL
    tokens = torch.randint(0, cfg.vocab, (1, T), dtype=torch.int32, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(6))
    cache = {k: torch.zeros_like(s, device=dev)
             for k, s in xlstm_lm.make_cache_specs(cfg, 1, T).items()}
    run = lambda: xlstm_lm.prefill_slot(cfg, params, cache, tokens, 0, T)
    run()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    host_ms = float(np.median(times))
    ms, kernels = device_profile(torch, run, 1)
    n_params = param_bytes(params) // 2
    out = dict(prompt_len=T, host_ms=times, host_ms_median=host_ms, device_ms=ms,
               device_idle_share=None if ms is None else 1 - ms / host_ms,
               launches=sum(v["calls"] for v in kernels.values()),
               top=sorted(({"name": k, **v} for k, v in kernels.items()),
                          key=lambda e: -e["ms"])[:6])
    out["bound_ms"], out["bound_by"] = bound(2 * T * n_params, param_bytes(params), "bfloat16")
    log(f"xlstm prefill at {T}: {json.dumps(out)}")
    return out


def xlstm_logits(torch, dev, cfg, params, prompt, steps: int, gate: bool) -> dict:
    """The kernel path (the RMSNorm kernel) against the plain path on one
    prompt through ``prefill_slot`` and ``steps`` decode steps, each path on
    its own one-lane cache and fed the plain path's greedy token: the
    largest logit difference, as a share of the plain path's largest
    |logit|, within ``LOGIT_TOL`` where ``gate``.

    At full depth with random weights the model amplifies a difference in
    the last bits of a norm (the kernel sums a row in another order; in
    bf16 it also rounds once where the plain chain rounds after each op)
    by orders of magnitude over its 48 layers, in fp32 too (``PERF.md`` has
    the figures), as zamba's does in bf16 (``zamba_logit_agreement``).  So
    the full-depth figures are printed and not gated; fp32 is gated on the
    first segment (``XLSTM_FP32_LAYERS``), and bf16 block by block
    (:func:`xlstm_block_agreement`)."""
    from repro_torch.models import xlstm_lm

    toks = torch.tensor(prompt[None], device=dev)
    caches, logits = {}, {}
    for impl in ("kernel", "chunked"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        caches[impl] = {k: torch.zeros_like(s, device=dev)
                        for k, s in xlstm_lm.make_cache_specs(c, 1, 1).items()}
        logits[impl] = [xlstm_lm.prefill_slot(c, params, caches[impl], toks, 0,
                                              int(prompt.size))[1]]
    for _ in range(steps):
        tok = logits["chunked"][-1].float().argmax(-1).to(torch.int32)
        for impl in ("kernel", "chunked"):
            c = dataclasses.replace(cfg, attn_impl=impl)
            logits[impl].append(xlstm_lm.decode_step(c, params, caches[impl], tok, 0)[0])
    errs = [rel_err(torch, a, b) for a, b in zip(logits["kernel"], logits["chunked"])]
    dt = cfg.compute_dtype
    out = dict(layers=cfg.n_layers, prompt_len=int(prompt.size), decode_steps=steps,
               prefill_rel_err=errs[0], decode_rel_err=errs[1:],
               tolerance=LOGIT_TOL[dt] if gate else None,
               argmax_equal=[bool(a.argmax() == b.argmax())
                             for a, b in zip(logits["kernel"], logits["chunked"])])
    log(f"xlstm logits {dt} ({cfg.n_layers} layers): {json.dumps(out)}"
        + ("" if gate else " (not gated)"))
    if gate:
        assert max(errs) <= LOGIT_TOL[dt], out
    return out


def xlstm_block_agreement(torch, dev, cfg, params, prompt) -> dict:
    """At full width, from the same inputs, the kernel path's first mLSTM
    and first sLSTM block against the plain path's: the prompt's embedding
    through each (prefill), then one decode token for each of 8 lanes from
    the prefill's state.  Each output within ``BLOCK_TOL`` of its largest
    entry (bf16: a rounding or two where the RMSNorm kernel rounds its
    fp32 result once; fp32: summation order)."""
    from repro_torch.models import xlstm, xlstm_lm

    x0 = xlstm_lm._embed(cfg, params, torch.tensor(prompt[None], device=dev))
    res = {}
    for impl in ("kernel", "chunked"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        r = {}
        for kind, fwd in (("mlstm", xlstm.mlstm_block_fwd), ("slstm", xlstm.slstm_block_fwd)):
            bp = xlstm_lm._layer(params[kind], 0)
            y, (conv, cell) = fwd(c, x0, bp)
            lanes = lambda t: t[:1].expand(MAX_SLOTS, *t.shape[1:]).contiguous()
            xd = y[0, :MAX_SLOTS, None]
            d, _ = fwd(c, xd, bp, conv_state=lanes(conv),
                       cell_state=tuple(lanes(t) for t in cell), decode=True)
            r[kind], r[kind + "_decode"] = y, d
        res[impl] = r
    dt = cfg.compute_dtype
    errs = {k: rel_err(torch, res["kernel"][k], res["chunked"][k]) for k in res["kernel"]}
    out = dict(rel_err=errs, tolerance=BLOCK_TOL[dt], prompt_len=int(prompt.size))
    log(f"xlstm blocks {dt}: {json.dumps(out)}")
    assert all(e <= BLOCK_TOL[dt] for e in errs.values()), out
    return out


def xlstm_path(torch, dev, results):
    """xlstm-1.3b at full width and ``XLSTM_LAYERS`` of its 48 layers (8:
    7 mLSTM, 1 sLSTM; bf16 weights from seed 0 made in bf16) through the
    slotted engine (8 lanes) on the
    kernel path, phase 3's traffic: ``serve_phase``'s gates; a profiled
    decode step beside its bytes bound (the weights, and every lane's
    recurrent state read and written); a bucket-512 prefill's host and
    device ms; logits, kernel path against plain, at the phase's depth in
    bf16 and fp32 (TF32 off), printed and not gated (see
    :func:`xlstm_logits`), fp32 gated on the first segment, and the first
    mLSTM and sLSTM blocks alone, gated in both dtypes.  Returns the
    launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import xlstm_lm
    from repro_torch.serve import EngineConfig
    from repro_torch.serve.paged import cache_nbytes

    free(torch)
    at_entry = torch.cuda.memory_allocated()
    log(f"phase 10: {at_entry / 1e9:.3f} GB allocated at entry")
    base = get_config("xlstm-1.3b")
    assert base.family == "ssm" and base.n_layers % XLSTM_LAYERS == 0
    base = dataclasses.replace(base, n_layers=XLSTM_LAYERS)
    cfg = dataclasses.replace(base, attn_impl="kernel", param_dtype="bfloat16")
    t = time.perf_counter()
    params = xlstm_lm.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    weights = param_bytes(params)
    state = cache_nbytes(xlstm_lm.make_cache_specs(cfg, MAX_SLOTS, MAX_LEN))
    reqs = requests(cfg.vocab)
    ec = EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN, kv_layout="slotted")
    log(f"xlstm-1.3b: {weights / 1e9:.2f} GB of bf16 weights made in {init_s:.1f} s; "
        f"recurrent state of {MAX_SLOTS} lanes {state / 1e9:.2f} GB")
    e2e, launches = serve_phase(torch, dev, results, "xlstm", "xlstm-1.3b", cfg, params, reqs,
                                ec, xlstm_launches)
    e2e.update(state_bytes=state, memory_allocated_at_entry=at_entry, init_s=init_s)
    prof = profile_decode(torch, cfg, params, reqs, ec, dev)
    if prof is not None:
        # the products' operations (every weight twice a lane) and the mLSTM
        # state's update and read (4 a C entry a lane), against the weights
        # and the state read and written once
        nbytes = weights + 2 * state
        C = xlstm_lm.make_cache_specs(cfg, MAX_SLOTS, 1)["m_C"].numel()
        n_params = weights // 2
        prof["bound_ms"], prof["bound_by"] = bound(2 * MAX_SLOTS * n_params + 4 * C, nbytes,
                                                   "bfloat16")
        prof["bound_bytes"] = nbytes
        log(f"xlstm decode step: {prof['kernel_launches_per_step']:.0f} launches, "
            f"{prof['device_ms_per_step']:.3f} device ms, idle share "
            f"{prof['device_idle_share']:.3f}, bound {prof['bound_ms']:.3f} ms "
            f"({prof['bound_by']}) [{results['nvidia_smi']}]")
    results["xlstm_profile"] = prof
    free(torch)
    e2e["prefill_512"] = results["xlstm_prefill_profile"] = xlstm_prefill(torch, dev, cfg, params)
    prompt = reqs[2][0]
    results["xlstm_logits"] = {"bfloat16": xlstm_logits(torch, dev, cfg, params, prompt,
                                                        FRONTEND_LOGIT_STEPS, gate=False)}
    results["xlstm_blocks"] = {"bfloat16": xlstm_block_agreement(torch, dev, cfg, params,
                                                                 prompt)}
    del params
    free(torch)
    c32 = dataclasses.replace(base, compute_dtype="float32")
    p32 = xlstm_lm.init(c32, seed=0, device=dev)
    log(f"xlstm-1.3b fp32 checks ({param_bytes(p32) / 1e9:.2f} GB of fp32 weights)")
    results["xlstm_logits"]["float32_full_depth"] = xlstm_logits(
        torch, dev, c32, p32, prompt, FRONTEND_LOGIT_STEPS, gate=False)
    results["xlstm_blocks"]["float32"] = xlstm_block_agreement(torch, dev, c32, p32, prompt)
    # the first segment (7 mLSTM blocks, the sLSTM block) with the same
    # weights: the stacked leaves' leading rows, views
    n = XLSTM_FP32_LAYERS
    c8 = dataclasses.replace(c32, n_layers=n)
    p8 = {**p32, "mlstm": {k: v[:n - n // c32.slstm_every] for k, v in p32["mlstm"].items()},
          "slstm": {k: v[:n // c32.slstm_every] for k, v in p32["slstm"].items()}}
    results["xlstm_logits"]["float32"] = xlstm_logits(torch, dev, c8, p8, prompt,
                                                      FRONTEND_LOGIT_STEPS, gate=True)
    del p32, p8
    free(torch)
    results["xlstm"] = e2e
    return launches


# ---------------------------------------------------------------------------
# Phases 11-12: the frontend families on the static loop
# ---------------------------------------------------------------------------


def static_logits(torch, dev, mod, cfg, params, tokens, extra, steps: int) -> dict:
    """A static-loop family's prefill (with its frontend input) and
    ``steps`` decode steps on the kernel path (flash, the norm kernels) and
    the plain path (chunked attention, plain norms), each on its own cache
    and fed the plain path's greedy tokens: the largest logit difference of
    each, as a share of the plain path's largest |logit|, within
    ``LOGIT_TOL``."""
    B, S = tokens.shape
    n_ctx = S + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    run = {}
    for impl in ("kernel", "chunked"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        p = mod.cast_for_compute(c, params, dev)
        cache, lg = mod.prefill(c, p, tokens, extra, max_len=n_ctx + steps)
        run[impl] = (c, p, cache, [lg])
    for i in range(steps):
        tok = run["chunked"][3][-1].float().argmax(-1).to(torch.int32)
        for c, p, cache, lgs in run.values():
            lgs.append(mod.decode_step(c, p, cache, tok, n_ctx + i)[0])
    a, b = run["kernel"][3], run["chunked"][3]
    errs = [rel_err(torch, x, y) for x, y in zip(a, b)]
    dt = cfg.compute_dtype
    out = dict(layers=cfg.n_layers, batch=B, prompt_len=S, n_ctx=n_ctx, decode_steps=steps,
               prefill_rel_err=errs[0], decode_rel_err=errs[1:], tolerance=LOGIT_TOL[dt],
               argmax_equal_rows=[int((x.argmax(-1) == y.argmax(-1)).sum()) for x, y in zip(a, b)])
    log(f"{cfg.name} logits {dt} ({cfg.n_layers} layers): {json.dumps(out)}")
    assert max(errs) <= LOGIT_TOL[dt], out
    return out


def static_run(torch, dev, cfg, params, prompts, extra, new: int, predict) -> tuple[dict, dict]:
    """``generate_static`` of the batch with its frontend input: a short
    warm-up, then the measured run with the kernel counts set to 0 just
    before it (gated against ``predict(decode steps)``), then a second run,
    whose streams must equal the first's.  Returns (figures, launches)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add
    from repro_torch.serve import ServeConfig, generate_static

    generate_static(cfg, params, prompts[:2], ServeConfig(max_new_tokens=2),
                    extra=extra[:2], device=dev)
    kernels = (flash_attention, paged_attention, rmsnorm, rmsnorm_add)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = generate_static(cfg, params, prompts, ServeConfig(max_new_tokens=new), extra=extra,
                          device=dev)
    wall = time.perf_counter() - t
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    want = predict(new)
    assert launches == want and out.shape == (len(prompts), new), (launches, want, out.shape)
    again = generate_static(cfg, params, prompts, ServeConfig(max_new_tokens=new), extra=extra,
                            device=dev)
    e2e = dict(batch=len(prompts), prompt_len=prompts.shape[1], new_tokens=new,
               tokens=out.size, wall_s=wall, tokens_per_s=out.size / wall,
               max_memory_allocated=peak, weights_bytes=param_bytes(params),
               launches=launches, launches_expected=want,
               second_run_streams_equal=bool((again == out).all()))
    assert e2e["second_run_streams_equal"], "a second run's streams differ"
    return e2e, launches


def prefill_profile(torch, dev, mod, cfg, params, tokens, extra, flops: float,
                    nbytes: float) -> dict:
    """One kernel-path prefill of the batch (``mod.prefill`` with its
    frontend input): host ms (synchronized), device ms and launches from the
    profiler, and the bound of ``flops`` and ``nbytes``."""
    p = mod.cast_for_compute(cfg, params, dev)
    run = lambda: mod.prefill(cfg, p, tokens, extra)
    run()
    torch.cuda.synchronize()
    t = time.perf_counter()
    run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    ms, kernels = device_profile(torch, run, 3)
    out = dict(host_ms=host_ms, device_ms=ms, launches=sum(v["calls"] for v in kernels.values()),
               flash_ms=sum(v["ms"] for k, v in kernels.items() if "flash_fwd_kernel" in k),
               tflop=flops / 1e12,
               top=sorted(({"name": k, **v} for k, v in kernels.items()),
                          key=lambda e: -e["ms"])[:6])
    out["bound_ms"], out["bound_by"] = bound(flops, nbytes, "bfloat16")
    return out


def whisper_launches(dec: int) -> dict:
    """Launches of a whisper-tiny static run (one prefill, ``dec`` decode
    steps): flash in each encoder layer and twice in each decoder layer
    (self and cross) a prefill; rmsnorm ``ln1`` in each layer and the two
    final norms a prefill, the decoder's ``ln1`` and ``ln_f`` a decode
    step; rmsnorm_add the encoder's ``ln2`` and the decoder's ``lnx`` and
    ``ln2`` a prefill, the decoder's two a decode step."""
    E = L = WHISPER_LAYERS
    return {"flash_attention": E + 2 * L, "paged_attention": 0,
            "rmsnorm": E + L + 2 + (L + 1) * dec, "rmsnorm_add": E + 2 * L + 2 * L * dec}


def whisper_prefill_work(cfg, B: int, S: int) -> int:
    """Operations of a whisper prefill: every product once a row (the
    encoder's over the frames, the decoder's over the prompt, the cross K/V
    over the frames), the attention pairs (bidirectional encoder, causal
    decoder, prompt x frames cross) and the last position's logits."""
    D, F_, T, H, dh = cfg.d_model, cfg.d_ff, cfg.enc_seq, cfg.n_heads, cfg.head_dim
    enc = 2 * B * T * cfg.enc_layers * (4 * D * D + 2 * D * F_) \
        + 4 * dh * H * B * T * T * cfg.enc_layers
    dec = 2 * B * S * cfg.n_layers * (6 * D * D + 2 * D * F_) \
        + 2 * B * T * cfg.n_layers * 2 * D * D \
        + 4 * dh * H * B * cfg.n_layers * (S * (S + 1) // 2 + S * T)
    from repro_torch.models.whisper import padded_vocab
    return enc + dec + 2 * B * D * padded_vocab(cfg)


def whisper_path(torch, dev, results):
    """whisper-tiny, uncut (4 + 4 layers, d_model 384, 1,500 frames; weights
    from seed 0), on ``generate_static``: batch 8, prompts of 32 tokens,
    frames (8, 1500, 384) drawn from seed 0, 64 new tokens.  Gates: the
    launches (flash 3 x 4 a prefill, the norms per prefill and step), a
    second run's streams, logits on the kernel path within ``LOGIT_TOL``
    of the plain path's on the prefill and 4 decode steps (bf16, and fp32
    with TF32 off).  Prints tokens/s and a prefill's device ms.  Returns
    the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import whisper

    free(torch)
    base = get_config("whisper-tiny")
    assert base.family == "audio" and base.n_layers == base.enc_layers == WHISPER_LAYERS
    cfg = dataclasses.replace(base, attn_impl="kernel")
    params = whisper.init(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (WHISPER_BATCH, WHISPER_PROMPT)).astype(np.int32)
    frames = rng.normal(size=(WHISPER_BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    e2e, launches = static_run(torch, dev, cfg, params, prompts, frames, WHISPER_NEW,
                               whisper_launches)
    tokens = torch.tensor(prompts, device=dev)
    xt = torch.tensor(frames, device=dev)
    e2e["prefill"] = prefill_profile(
        torch, dev, whisper, cfg, params, tokens, xt,
        whisper_prefill_work(cfg, WHISPER_BATCH, WHISPER_PROMPT),
        param_bytes(whisper.cast_for_compute(cfg, params, dev)) + xt.numel() * 4)
    log(f"whisper-tiny (static loop, kernels) [{results['nvidia_smi']}]: "
        f"{e2e['tokens']} tokens in {e2e['wall_s']:.3f} s = {e2e['tokens_per_s']:.1f} tok/s; "
        f"prefill {json.dumps(e2e['prefill'])}; launches {launches}; peak memory "
        f"{e2e['max_memory_allocated'] / 1e9:.2f} GB")
    results["whisper_logits"] = {
        dt: static_logits(torch, dev, whisper, dataclasses.replace(cfg, compute_dtype=dt),
                          params, tokens, xt, FRONTEND_LOGIT_STEPS)
        for dt in ("bfloat16", "float32")}
    results["whisper"] = e2e
    del params
    free(torch)
    return launches


def vlm_launches(dec: int) -> dict:
    """Launches of an internvl2-76b static run at ``VLM_LAYERS`` layers
    (one prefill, ``dec`` decode steps): flash in each layer a prefill;
    ``ln1`` in each layer and ``ln_f`` (rmsnorm) and ``ln2`` with its
    residual add (rmsnorm_add) a prefill and a decode step.  The decode
    attention is the plain slotted one, as in the reference."""
    L = VLM_LAYERS
    return {"flash_attention": L, "paged_attention": 0, "rmsnorm": (L + 1) * (1 + dec),
            "rmsnorm_add": L * (1 + dec)}


def vlm_path(torch, dev, results):
    """internvl2-76b at full width, 16 of its 80 layers (bf16 weights from
    seed 0 made in bf16, ~31.6 GB), on ``generate_static``: batch 4, patch
    embeddings (4, 256, 3200) and prompts of 128 tokens drawn from seed 0,
    32 new tokens, decoding from position 384.  Gates: the launches, a
    second run's streams, logits kernel path against plain within
    ``LOGIT_TOL`` in bf16 at 16 layers and in fp32 (TF32 off) at 2 layers.
    Prints tokens/s, the prefill's device ms beside its bound, peak memory.
    Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    free(torch)
    at_entry = torch.cuda.memory_allocated()
    base = get_config("internvl2-76b")
    assert base.family == "vlm" and VLM_LAYERS <= base.n_layers
    cfg = dataclasses.replace(base, n_layers=VLM_LAYERS, attn_impl="kernel",
                              param_dtype="bfloat16")
    t = time.perf_counter()
    params = lm.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    weights = param_bytes(params)
    log(f"phase 12: {at_entry / 1e9:.3f} GB allocated at entry; internvl2-76b at "
        f"{VLM_LAYERS} of {base.n_layers} layers: {weights / 1e9:.2f} GB of bf16 weights made "
        f"in {init_s:.1f} s")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (VLM_BATCH, VLM_PROMPT)).astype(np.int32)
    patches = rng.normal(size=(VLM_BATCH, cfg.frontend_tokens,
                               cfg.frontend_dim)).astype(np.float32)
    e2e, launches = static_run(torch, dev, cfg, params, prompts, patches, VLM_NEW, vlm_launches)
    tokens = torch.tensor(prompts, device=dev)
    img = torch.tensor(patches, device=dev)
    n = cfg.frontend_tokens + VLM_PROMPT
    attn, matmul = prefill_work(cfg, n)
    flops = VLM_BATCH * (attn + matmul) + 2 * VLM_BATCH * cfg.frontend_tokens \
        * cfg.frontend_dim * cfg.d_model + 2 * VLM_BATCH * cfg.d_model * cfg.vocab
    e2e["prefill"] = prefill_profile(torch, dev, lm, cfg, params, tokens, img, flops,
                                     weights + img.numel() * 4)
    e2e.update(init_s=init_s, memory_allocated_at_entry=at_entry, layers=VLM_LAYERS,
               n_ctx=n)
    log(f"internvl2-76b (static loop, kernels, {VLM_LAYERS} layers) "
        f"[{results['nvidia_smi']}]: {e2e['tokens']} tokens in {e2e['wall_s']:.3f} s = "
        f"{e2e['tokens_per_s']:.1f} tok/s; prefill {json.dumps(e2e['prefill'])}; launches "
        f"{launches}; peak memory {e2e['max_memory_allocated'] / 1e9:.2f} GB (weights "
        f"{weights / 1e9:.2f})")
    results["vlm_logits"] = {"bfloat16": static_logits(torch, dev, lm, cfg, params, tokens, img,
                                                       FRONTEND_LOGIT_STEPS)}
    del params
    free(torch)
    c32 = dataclasses.replace(base, n_layers=VLM_FP32_LAYERS, compute_dtype="float32")
    p32 = lm.init(c32, seed=0, device=dev)
    log(f"internvl2-76b fp32 logit check cut to {VLM_FP32_LAYERS} layers "
        f"({param_bytes(p32) / 1e9:.2f} GB of fp32 weights)")
    results["vlm_logits"]["float32"] = static_logits(torch, dev, lm, c32, p32, tokens, img,
                                                     FRONTEND_LOGIT_STEPS)
    del p32
    free(torch)
    results["vlm"] = e2e
    return launches


# ---------------------------------------------------------------------------
# Phases 13-15: the trainer on every family
# ---------------------------------------------------------------------------

# phase 13: zamba2-1.2b uncut, the faithful program, seq 1024, global batch
# 4 in 2 slices, 4 steps
ZT_SEQ, ZT_BATCH, ZT_SLICES, ZT_STEPS = 1024, 4, 2, 4
ZT_FIRST_SEGMENT = 6          # the first segment's layers (one shared invocation)
# phases 13-14: step 1, kernel path vs plain path, fp32 with TF32 off,
# relative (the same fp32 arithmetic in another summation order)
TRAIN_FP32_TOL = {"float32": dict(loss=1e-4, grad_norm=1e-3)}
# phase 14: qwen3-moe-30b-a3b at full width and 2 of its 48 layers, the
# per-parameter path under FSDP, seq 512, global batch 4 in 2 slices, 3 steps
MT_LAYERS, MT_SEQ, MT_BATCH, MT_SLICES, MT_STEPS = 2, 512, 4, 2, 3
# phase 14's bytes_per_rank meshes of the 48-layer model, (data, model)
MESH_SHAPES = ((8, 1), (4, 2), (2, 4))
# phase 14b: zamba2-1.2b's first segment under FSDP, phase 13's shape, 2 steps
ZF_STEPS = 2
# phase 15: whisper-tiny uncut and xlstm-1.3b at 8 of 48 layers (7 mLSTM,
# 1 sLSTM), the faithful program, seq 256, global batch 4 in 2 slices, 2
# steps each
FT_SEQ, FT_BATCH, FT_SLICES, FT_STEPS = 256, 4, 2, 2
XT_LAYERS = 8


def train_kernels():
    """Every kernel wrapper a train step can launch."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flat_adam.ops import flat_adam
    from repro_torch.kernels.rmsnorm.ops import (rmsnorm, rmsnorm_add, rmsnorm_gated,
                                                 rmsnorm_gated_split)
    from repro_torch.kernels.ssd.ops import ssd

    return (flat_adam, flash_attention, ssd, rmsnorm, rmsnorm_add, rmsnorm_gated,
            rmsnorm_gated_split)


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def zamba_train_work(cfg, tokens: int, seqs: int, n_flat: int) -> tuple[float, float]:
    """(flops, bytes) of one zamba2 train step: 6 flops a matmul weight a
    token (forward and backward), 2 more for each Mamba2 weight (remat's
    recomputed forward), the shared block's causal attention 3 times its
    forward; bytes: the flat Adam pass (p, g, m, v read, p, m, v written).
    The scan's own work (~2% of the products) is left out."""
    D, V, F_ = cfg.d_model, cfg.vocab, cfg.d_ff
    d_inner = cfg.ssm.expand * D
    H = d_inner // cfg.ssm.head_dim
    d_proj = 2 * d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.state + H
    mamba = cfg.n_layers * (D * d_proj + d_inner * D)
    shared = ZAMBA_SHARED * (2 * D * D + 4 * D * D + 3 * D * F_)
    attn = ZAMBA_SHARED * 4 * cfg.head_dim * cfg.n_heads * causal_pairs(tokens // seqs) * seqs
    flops = 6.0 * tokens * (mamba + shared + D * V) + 2.0 * tokens * mamba + 3.0 * attn
    return flops, 28.0 * n_flat


def moe_train_work(cfg, tokens: int, seqs: int, kept: float, n_params: int) -> tuple[float, float]:
    """(flops, bytes) of one qwen3-moe train step: 8 flops a weight a token
    read (forward, backward and remat's recomputed forward) for the
    attention projections and the router, each kept choice's expert SwiGLU
    (``kept``: the share of the step's choices capacity kept), 6 for the
    unembedding, causal attention 4 times its forward; bytes: Adam over every
    parameter (28 a parameter)."""
    D, V, dh = cfg.d_model, cfg.vocab, cfg.head_dim
    H, Hk, E, F_, K = cfg.n_heads, cfg.n_kv, cfg.moe.num_experts, cfg.moe.d_expert, cfg.moe.top_k
    dense = cfg.n_layers * (2 * D * H * dh + 2 * D * Hk * dh + D * E)
    experts = cfg.n_layers * K * kept * 3 * D * F_
    attn = cfg.n_layers * 4 * dh * H * causal_pairs(tokens // seqs) * seqs
    flops = 8.0 * tokens * (dense + experts) + 6.0 * tokens * D * V + 4.0 * attn
    return flops, 28.0 * n_params


def family_train(torch, group, cfg, shape, opt, settings, steps: int, want: dict, label: str):
    """``train.loop.train`` of ``cfg`` for ``steps`` steps on ``group``.
    Gates: finite losses, no skipped step, the launches ``want`` ({wrapper:
    count}), and batch 0's loss after the run below step 1's.  Returns
    (row, the loop's result)."""
    kernels = train_kernels()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    res, times, losses, history = train_run(torch, cfg, shape, group, opt, settings, steps)
    launches = {k.__name__: k.launches for k in kernels}
    warm = times[1:] or times
    row = dict(arch=label, layers=cfg.n_layers, seq=shape.seq_len, batch=shape.global_batch,
               slices=settings.num_slices, steps=steps, losses=losses, metrics=history,
               step_ms=times, step_ms_median=float(np.median(warm)),
               step_ms_p90=float(np.percentile(warm, 90)),
               tokens_per_s=shape.seq_len * shape.global_batch / (np.median(warm) / 1e3),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               skipped_steps=res["skipped_steps"], launches=launches, launches_expected=want)
    row["batch0_loss_after"] = eval_loss(torch, cfg, res["params"], shape, group,
                                         settings.num_slices)
    log(f"train {label}: {json.dumps(row)}")
    log(f"train {label}: batch 0 loss {losses[0]:.4f} at step 1, "
        f"{row['batch0_loss_after']:.4f} after {steps} steps")
    assert all(np.isfinite(losses)) and res["skipped_steps"] == 0, row
    assert all(launches[k] == n for k, n in want.items()), row
    assert row["batch0_loss_after"] < losses[0], row
    return row, res


def n_params(tree) -> int:
    from repro_torch.optim.flat import tree_leaves

    return sum(t.numel() for _, t in tree_leaves(tree))


def zamba_train_path(torch, dev, results):
    """Phase 13: full-width zamba2-1.2b (38 layers, uncut) trained through
    the faithful flat program over a 1-rank NCCL group.  Returns the
    launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch_fn
    from repro_torch.launch.mesh import init_group
    from repro_torch.models import zamba
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainSettings
    from repro_torch.train.step import flat_layout_for

    free(torch)
    base = dataclasses.replace(get_config("zamba2-1.2b"), attn_impl="kernel")
    L, Sh = base.n_layers, zamba.n_shared_invocations(base)
    assert (L, Sh) == (ZAMBA_LAYERS, ZAMBA_SHARED) and base.compute_dtype == "bfloat16"
    shape = ShapeConfig("chip-smoke-zamba", "train", ZT_SEQ, ZT_BATCH)
    settings = TrainSettings(num_slices=ZT_SLICES, faithful=True)
    opt = OptConfig(kind="adam")
    per = ZT_SLICES * ZT_STEPS
    # per slice: each Mamba2 layer's scan, ln and gated out-norm in the
    # forward and remat's recomputed forward (the backward recomputes
    # through the plain versions); the shared block's flash, ln1 and ln2
    # once an invocation (not rematted); ln_f once
    want = dict(flat_adam=ZT_STEPS, ssd=2 * L * per, flash_attention=Sh * per,
                rmsnorm=(2 * L + Sh + 1) * per, rmsnorm_add=Sh * per,
                rmsnorm_gated=2 * L * per)
    group = init_group("nccl", 0, 1, f"tcp://127.0.0.1:{free_port()}", device=dev)
    try:
        row, res = family_train(torch, group, base, shape, opt, settings, ZT_STEPS, want,
                                "zamba2-1.2b")
        n_flat = flat_layout_for(base).total
        row["params"] = n_params(res["params"])
        row["flat_total"] = n_flat
        batch = make_batch_fn(base, shape, 0)(ZT_STEPS)
        row["skip"] = skip_is_noop(torch, base, group, opt, settings, res["params"],
                                   res["opt_state"], batch)
        log(f"train zamba2-1.2b skip step: {json.dumps(row['skip'])}")
        row["checkpoint"] = checkpoint_roundtrip(torch, res["params"], res["opt_state"],
                                                 HERE / "build" / "ckpt_smoke")
        log(f"train zamba2-1.2b checkpoint: {json.dumps(row['checkpoint'])}")
        prof = profile_train_step(torch, base, group, opt, settings, res, batch)
        del res
        free(torch)
        # flat_adam at this flat buffer beside its plain version and fused
        # Adam, on buffers of its size (the trainer's are freed)
        bufs = adam_inputs(torch, torch.Generator(device=dev).manual_seed(3), n_flat)
        row["adam_timing"] = adam_timing(torch, bufs)
        del bufs
        free(torch)
        flops, nbytes = zamba_train_work(base, ZT_SEQ * ZT_BATCH, ZT_BATCH, n_flat)
        bound_ms, bound_by = bound(flops, nbytes, "bfloat16")
        row["bound"] = dict(flops=flops, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by)
        row["profile"] = prof
        log(f"train zamba2-1.2b step bound: {json.dumps(row['bound'])}")
        # step 1, kernel path vs plain path in fp32: the first segment
        # gated, the whole depth printed
        row["step1_first_segment"] = step_agreement(
            torch, dataclasses.replace(base, n_layers=ZT_FIRST_SEGMENT), group, opt, shape,
            settings, dtypes=("float32",), tol=TRAIN_FP32_TOL, label="zamba2 first segment ")
        row["step1_full_depth"] = step_agreement(
            torch, base, group, opt, shape, settings, dtypes=("float32",), tol=TRAIN_FP32_TOL,
            label="zamba2 full depth ", gate=False)
    finally:
        group.close()
    results["zamba_train"] = row
    return row["launches"]


def fsdp_collectives(cfg, per: int) -> dict:
    """The all-gathers and reduce-scatters of ``per`` slices under FSDP.
    Gathers: each rematted layer's sharded leaves twice (the forward and
    remat's recompute); outside the remat, the embedding lookup once, the
    unembedding and each of zamba's shared-block invocations twice (the
    forward, and the backward's gather of the weight its product saved:
    no full copy outlives the forward).  Each gather of the forward has
    one reduce-scatter; the recompute's and the backward's have none."""
    from repro_torch.models import zamba
    from repro_torch.models.common import COUNTS, ShardRules
    from repro_torch.optim.fsdp import make_shard_layout

    shards = make_shard_layout(cfg, ShardRules.for_group(None), 1)
    count = lambda top: sum(1 for p in shards.sharded if p[0] == top)
    remat, plain = cfg.n_layers * count("blocks"), 2
    if cfg.family == "hybrid":
        remat = cfg.n_layers * count("mamba")
        plain += zamba.n_shared_invocations(cfg) * count("shared")
    return {**dict.fromkeys(COUNTS, 0), "all_gather": (2 * plain - 1 + 2 * remat) * per,
            "reduce_scatter": (plain + remat) * per}


def mesh_collectives(cfg, per: int) -> dict:
    """Every collective of ``per`` slices on a ``(1, 1)`` mesh
    (``models.common.COUNTS``): the FSDP gathers and reduce-scatters as
    :func:`fsdp_collectives`, and the model axis' (each Function's forward
    and backward collective under its name).  A slice: the embedding's
    reduce-scatter onto the sequence shard, the loss's gather of the
    sequence and its two all-reduces; each rematted layer's gathers of the
    normed stream before attention and before the FFN and the
    reduce-scatters of their outputs, in the forward, the recompute and
    the backward (the dense FFN's last reduce-scatter is not recomputed:
    nothing after it in the block saves a tensor).  The heads divide at
    model size 1: no head gathers.  zamba2 (the hybrid family, no ``sp``):
    copy-to-model into, and reduce-from-model out of, each shared block's
    attention and MLP, each Mamba2 block and the embedding (the loss's
    copy too); each Mamba2 block's projection and conv weights gathered
    over ``model`` in the forward, remat's recompute and the backward, and
    its out-norm's row sums (the same three, and the backward's recomputed
    sum)."""
    L = cfg.n_layers
    if cfg.family == "hybrid":
        from repro_torch.models import zamba

        tp = (2 * zamba.n_shared_invocations(cfg) + L + 1) * per
        return dict(fsdp_collectives(cfg, per), copy_to_model=tp, reduce_from_model=tp,
                    model_all_gather=9 * L * per, model_reduce_scatter=0, vocab_ce=2 * per,
                    norm_sum=4 * L * per)
    rs = 6 * L + 2 if (cfg.moe.num_experts or cfg.alt_local_global) else 5 * L + 2
    return dict(fsdp_collectives(cfg, per), copy_to_model=0, reduce_from_model=0,
                model_all_gather=(6 * L + 2) * per, model_reduce_scatter=rs * per,
                vocab_ce=2 * per)


def reset_counts(torch) -> None:
    """Every launch count of the train kernels and every collective count
    to 0."""
    from repro_torch.models import common

    for k in train_kernels():
        k.launches = 0
    common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))


def tree_digest(torch, tree) -> list:
    """Each fp32 leaf's bits summed as int64 (in slices: no leaf-sized
    copy), a fingerprint to compare two trees that cannot be held at once."""
    from repro_torch.optim.flat import tree_leaves

    out = []
    for _, x in tree_leaves(tree):
        bits32 = x.detach().reshape(-1).view(torch.int32)
        out.append(sum(int(c.to(torch.int64).sum()) for c in bits32.split(1 << 26)))
    return out


def rules_step1(torch, cfg, group, opt, shape, settings, label: str, mesh_want=None,
                mesh_steps: int = MT_STEPS) -> dict:
    """Step 1 from the seed-0 init on batch 0 under the replicated rules,
    then under FSDP (the gathers and reduce-scatters over ``group``), each
    run freed before the next.  Gates loss, gradient norm and the updated
    parameters (their digests) bitwise equal: at one rank a shard is its
    whole leaf, the gather and the reduce-scatter move bytes without
    arithmetic, and every sum keeps its order.  With ``mesh_want`` (the
    launches by formula), a third run on a ``(1, 1)`` mesh over ``group``
    (:func:`mesh_run`, ``mesh_steps`` steps), its step 1 held bitwise to
    FSDP's."""
    from repro_torch.data import make_batch_fn
    from repro_torch.models import common
    from repro_torch.models.common import ShardRules
    from repro_torch.train import build_train_step, init_sharded

    batch = make_batch_fn(cfg, shape, 0)(0)
    out = {}
    for name, faithful in (("replicated", True), ("fsdp", False)):
        rules = ShardRules.for_group(group, faithful=faithful)
        params, state = init_sharded(cfg, group, opt, 0, settings, rules)
        step_fn = build_train_step(cfg, group, opt, settings, rules)
        common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
        torch.cuda.synchronize()
        t = time.perf_counter()
        p, o, m = step_fn(params, state, batch)
        torch.cuda.synchronize()
        out[name] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                         step_ms=(time.perf_counter() - t) * 1e3,
                         collectives=dict(common.COUNTS), sharded=len(step_fn._shard_layout.sharded),
                         digest=tree_digest(torch, p))
        # the new Adam state too: nothing of a run outlives it
        del params, state, p, o, m, step_fn
        free(torch)
    rep, fs = out["replicated"], out["fsdp"]
    out["bitwise"] = {k: rep[k] == fs[k] for k in ("loss", "grad_norm")}
    out["params_digest_equal"] = rep["digest"] == fs["digest"]
    out["max_abs_diff"] = {k: abs(rep[k] - fs[k]) for k in ("loss", "grad_norm")}
    if mesh_want is not None:
        out["mesh"] = mesh_run(torch, cfg, group, opt, shape, settings, mesh_want, fs,
                               steps=mesh_steps, label=label)
    for r in (rep, fs):
        r["digest"] = sum(r["digest"])
    log(f"step 1 {label}, replicated rules against FSDP: {json.dumps(out)}")
    assert rep["collectives"] == dict.fromkeys(common.COUNTS, 0) and fs["sharded"], out
    assert all(out["bitwise"].values()), out
    assert out["params_digest_equal"], out
    return out


def mesh_run(torch, cfg, group, opt, shape, settings, want: dict, fsdp: dict, *,
             steps: int = MT_STEPS, label: str = "qwen3-moe") -> dict:
    """Phase 14's third run and phase 14b's (zamba2's, ``sp`` off as the
    reference's launcher sets it for the hybrid family: the Mamba2 heads
    split over ``model`` and the gated out-norm through the split entry
    and its all-reduced row sum): ``ShardRules.for_mesh`` of a ``(1, 1)``
    mesh laid over ``group`` (1-rank NCCL subgroups for ``data`` and
    ``model``), the seed-0 init, ``steps`` steps on batches 0, 1, ... of
    the stream.
    Gates: step 1's loss, gradient norm and parameter digests bitwise
    ``fsdp``'s (phase 14's FSDP step 1: at one rank every model-axis
    collective moves bytes without arithmetic and the vocab-parallel loss
    is ``logsumexp``'s arithmetic); finite losses and batch 0's loss below
    step 1's after the steps; the launches ``want`` and the collectives
    by formula.  Then a profiled step (``profile_train_step``) on the
    mesh.  Everything is freed before it returns."""
    from repro_torch.data import make_batch_fn
    from repro_torch.launch.mesh import mesh_from_group
    from repro_torch.models import common
    from repro_torch.models.common import ShardRules
    from repro_torch.train import build_train_step, init_sharded

    mesh = mesh_from_group(group, (1, 1))
    batch_fn = make_batch_fn(cfg, shape, 0)
    params, state = init_sharded(cfg, mesh, opt, 0, settings)
    step_fn = build_train_step(cfg, mesh, opt, settings)
    rules = step_fn._rules
    assert rules == ShardRules(dp=("data",), tp="model", fsdp="data",
                               sp=cfg.family != "hybrid"), rules
    reset_counts(torch)
    torch.cuda.reset_peak_memory_stats()
    times, history, digest = [], [], None
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = step_fn(params, state, batch_fn(i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        history.append({k: float(v) for k, v in m.items()})
        if i == 0:
            digest = tree_digest(torch, params)
    kernels = train_kernels()
    launches = {k.__name__: k.launches for k in kernels}
    collectives = dict(common.COUNTS)
    warm = times[1:]
    row = dict(mesh=list(mesh.shape), rules=dataclasses.asdict(rules),
               split_over_model=len(step_fn._shard_layout.model_sharded),
               sharded=len(step_fn._shard_layout.sharded),
               model_partial=len(step_fn._model_partial), steps=steps,
               losses=[h["loss"] for h in history], metrics=history, step_ms=times,
               step_ms_median=float(np.median(warm)),
               max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
               launches_expected=want, collectives=collectives,
               collectives_expected=mesh_collectives(cfg, settings.num_slices * steps))
    row["step1_bitwise"] = {k: history[0][k] == fsdp[k] for k in ("loss", "grad_norm")}
    row["step1_max_abs_diff"] = {k: abs(history[0][k] - fsdp[k]) for k in ("loss", "grad_norm")}
    row["params_digest_equal"] = digest == fsdp["digest"]
    row["batch0_loss_after"] = eval_loss(torch, cfg, params, shape, group, settings.num_slices)
    log(f"train {label} mesh (1, 1): {json.dumps(row)}")
    log(f"train {label} mesh (1, 1): host median {row['step_ms_median']:.1f} ms; batch 0 "
        f"loss {row['losses'][0]:.4f} at step 1, {row['batch0_loss_after']:.4f} after "
        f"{steps} steps")
    assert all(np.isfinite(row["losses"])), row
    assert row["batch0_loss_after"] < row["losses"][0], row
    assert all(row["step1_bitwise"].values()) and row["params_digest_equal"], row
    assert all(launches[k] == n for k, n in want.items()), row
    assert collectives == row["collectives_expected"], row
    assert row["split_over_model"] and row["model_partial"], row
    # the profile takes the state over: no third copy of it is held
    run = {"params": params, "opt_state": state}
    del params, state, step_fn
    row["profile"] = profile_train_step(torch, cfg, mesh, opt, settings, run,
                                        batch_fn(steps))
    del run
    free(torch)
    return row


def moe_train_path(torch, dev, results):
    """Phase 14: qwen3-moe-30b-a3b at full width, 2 of its 48 layers,
    trained on the per-parameter path under FSDP with its load-balance
    term.  Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch_fn
    from repro_torch.launch.mesh import init_group
    from repro_torch.models import common
    from repro_torch.optim import OptConfig, fsdp
    from repro_torch.train import TrainSettings
    from repro_torch.train.step import flat_engine_mode

    free(torch)
    log(f"phase 14: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated at entry")
    base = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), n_layers=MT_LAYERS,
                               attn_impl="kernel")
    assert base.family == "moe" and base.qk_norm
    shape = ShapeConfig("chip-smoke-moe", "train", MT_SEQ, MT_BATCH)
    settings = TrainSettings(num_slices=MT_SLICES)
    opt = OptConfig(kind="adam")
    L, per = base.n_layers, MT_SLICES * MT_STEPS
    # per slice: each block's flash, ln1, q- and k-norm and ln2 (with its
    # add) in the forward and remat's recomputed forward; ln_f once
    want = dict(flat_adam=0, ssd=0, rmsnorm_gated=0, flash_attention=2 * L * per,
                rmsnorm=(2 * 3 * L + 1) * per, rmsnorm_add=2 * L * per)
    full = get_config("qwen3-moe-30b-a3b")
    per_rank = {w: fsdp.bytes_per_rank(full, opt, w) for w in (1, 4, 8)}
    log(f"qwen3-moe-30b-a3b, {full.n_layers} layers, bytes a rank on the per-parameter "
        f"path under FSDP (params, grads, Adam m and v): {json.dumps(per_rank)}")
    per_mesh = {f"{d}x{m}": fsdp.bytes_per_rank(full, opt, d, m) for d, m in MESH_SHAPES}
    big = get_config("qwen3-moe-235b-a22b")
    per_mesh["qwen3-moe-235b-a22b 16x16"] = fsdp.bytes_per_rank(big, opt, 16, 16)
    log(f"bytes a rank on a (data, model) mesh, qwen3-moe-30b-a3b at {full.n_layers} "
        f"layers and qwen3-moe-235b-a22b at {big.n_layers} on the production mesh (params, "
        f"grads, Adam m and v): {json.dumps(per_mesh)}")
    group = init_group("nccl", 0, 1, f"tcp://127.0.0.1:{free_port()}", device=dev)
    try:
        assert flat_engine_mode(base, group, opt, settings) is None
        step1_rules = rules_step1(torch, base, group, opt, shape, settings, "qwen3-moe",
                                  mesh_want=want)
        common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
        row, res = family_train(torch, group, base, shape, opt, settings, MT_STEPS, want,
                                "qwen3-moe-30b-a3b")
        row["collectives"] = dict(common.COUNTS)
        row["collectives_expected"] = fsdp_collectives(base, per)
        log(f"train qwen3-moe collectives: {json.dumps(row['collectives'])}")
        assert row["collectives"] == row["collectives_expected"], row["collectives"]
        row["step1_rules"] = step1_rules
        row["bytes_per_rank_48_layers"] = per_rank
        row["bytes_per_rank_mesh"] = per_mesh
        row["params"] = n_params(res["params"])
        for i, m in enumerate(row["metrics"]):
            log(f"train qwen3-moe step {i + 1}: loss {m['loss']:.4f} ce {m['ce_loss']:.4f} "
                f"lb_loss {m['lb_loss']:.4f} drop_frac {m['drop_frac']:.4f}")
            assert 0.0 <= m["drop_frac"] <= 1.0 and np.isfinite(m["lb_loss"]), m
        batch = make_batch_fn(base, shape, 0)(MT_STEPS)
        prof = profile_train_step(torch, base, group, opt, settings, res, batch)
        del res
        free(torch)
        kept = 1.0 - float(np.mean([m["drop_frac"] for m in row["metrics"]]))
        flops, nbytes = moe_train_work(base, MT_SEQ * MT_BATCH, MT_BATCH, kept, row["params"])
        bound_ms, bound_by = bound(flops, nbytes, "bfloat16")
        row["bound"] = dict(flops=flops, bytes=nbytes, kept=kept, bound_ms=bound_ms,
                            bound_by=bound_by)
        row["profile"] = prof
        log(f"train qwen3-moe step bound: {json.dumps(row['bound'])}")
        row["step1"] = step_agreement(torch, base, group, opt, shape, settings,
                                      dtypes=("float32",), tol=TRAIN_FP32_TOL,
                                      label="qwen3-moe ")
    finally:
        group.close()
    results["moe_train"] = row
    return row["launches"]


def zamba_fsdp_path(torch, dev, results):
    """Phase 14b: full-width zamba2-1.2b's first segment (6 layers, one
    shared-block invocation) trained with the default settings, the
    per-parameter path under FSDP: the ssd kernel and its autograd
    Function under gathered weights.  Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import init_group
    from repro_torch.models import common, zamba
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainSettings
    from repro_torch.train.step import flat_engine_mode

    free(torch)
    base = dataclasses.replace(get_config("zamba2-1.2b"), n_layers=ZT_FIRST_SEGMENT,
                               attn_impl="kernel")
    L, Sh = base.n_layers, zamba.n_shared_invocations(base)
    assert (L, Sh) == (ZT_FIRST_SEGMENT, 1)
    shape = ShapeConfig("chip-smoke-zamba-fsdp", "train", ZT_SEQ, ZT_BATCH)
    settings = TrainSettings(num_slices=ZT_SLICES)
    opt = OptConfig(kind="adam")
    per = ZT_SLICES * ZF_STEPS
    want = dict(flat_adam=0, ssd=2 * L * per, flash_attention=Sh * per,
                rmsnorm=(2 * L + Sh + 1) * per, rmsnorm_add=Sh * per,
                rmsnorm_gated=2 * L * per, rmsnorm_gated_split=0)
    # the mesh run (14m): the gated out-norm through the split entry, two
    # launches a call, in the forward and remat's recompute
    mesh_want = dict(want, rmsnorm_gated=0, rmsnorm_gated_split=2 * 2 * L * per)
    group = init_group("nccl", 0, 1, f"tcp://127.0.0.1:{free_port()}", device=dev)
    try:
        assert flat_engine_mode(base, group, opt, settings) is None
        step1_rules = rules_step1(torch, base, group, opt, shape, settings, "zamba2 segment",
                                  mesh_want=mesh_want, mesh_steps=ZF_STEPS)
        common.COUNTS.update(dict.fromkeys(common.COUNTS, 0))
        row, res = family_train(torch, group, base, shape, opt, settings, ZF_STEPS, want,
                                "zamba2-1.2b first segment, FSDP")
        row["collectives"] = dict(common.COUNTS)
        row["collectives_expected"] = fsdp_collectives(base, per)
        log(f"train zamba2 segment collectives: {json.dumps(row['collectives'])}")
        assert row["collectives"] == row["collectives_expected"], row["collectives"]
        row["step1_rules"] = step1_rules
        row["params"] = n_params(res["params"])
        del res
        free(torch)
    finally:
        group.close()
    results["zamba_fsdp_train"] = row
    return row["launches"]


def frontier_train_path(torch, dev, results):
    """Phase 15: whisper-tiny uncut and xlstm-1.3b at full width and 8 of
    48 layers through the faithful program.  Returns {family: launch
    counts}."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import init_group
    from repro_torch.models import xlstm_lm
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainSettings

    free(torch)
    whisper = dataclasses.replace(get_config("whisper-tiny"), attn_impl="kernel")
    assert whisper.n_layers == whisper.enc_layers == WHISPER_LAYERS
    xlstm = dataclasses.replace(get_config("xlstm-1.3b"), n_layers=XT_LAYERS, attn_impl="kernel")
    assert xlstm_lm._layout(xlstm) == (1, 7, 1)            # 7 mLSTM blocks, then 1 sLSTM
    settings = TrainSettings(num_slices=FT_SLICES, faithful=True)
    opt = OptConfig(kind="adam")
    out, launches = {}, {}
    group = init_group("nccl", 0, 1, f"tcp://127.0.0.1:{free_port()}", device=dev)
    try:
        for label, cfg in (("whisper-tiny", whisper), ("xlstm-1.3b", xlstm)):
            shape = ShapeConfig(f"chip-smoke-{label}", "train", FT_SEQ, FT_BATCH)
            row, res = family_train(torch, group, cfg, shape, opt, settings, FT_STEPS,
                                    dict(flat_adam=FT_STEPS), label)
            row["params"] = n_params(res["params"])
            del res
            free(torch)
            out[label], launches[label] = row, row["launches"]
    finally:
        group.close()
    results["frontier_train"] = out
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    if not (HERE / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from the "
              "repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    results = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
               "torch": torch.__version__, "cuda": torch.version.cuda}

    from repro_torch.kernels import _build
    phase_s = {}
    t = time.perf_counter()
    logs = _build.build_all()
    for name in _build.sources():
        _build.load(name)
    results["build_s"] = phase_s["1 build"] = time.perf_counter() - t
    spills = {}
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas[{name}]: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills[name] = spills.get(name, 0) + int(m.group(1)) + int(m.group(2))
    results["ptxas_spill_bytes"] = spills
    # the bf16 head-dim-160 flash kernel's own line (the tail panel's 80
    # accumulators a thread sit at the register limit)
    results["ptxas_flash_d160_spill_bytes"] = None
    fn = None
    for line in logs.get("flash_attention", "").splitlines():
        if "Function properties for" in line or "Compiling entry function" in line:
            fn = line
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn and "tc16flash_fwd_kernelILi160E" in fn:
            results["ptxas_flash_d160_spill_bytes"] = int(m.group(1)) + int(m.group(2))
    log(f"ptxas: bf16 flash at head dim 160 spills "
        f"{results['ptxas_flash_d160_spill_bytes']} bytes")
    log(f"built {sorted(_build.sources())} in {results['build_s']:.1f} s")

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(torch, dev, results, *args)
        phase_s[name] = time.perf_counter() - t
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    phase("2 flash", check_flash)
    phase("2 paged", check_paged)
    phase("2b flat_adam", check_flat_adam)
    phase("2c flash grad", check_flash_grad)
    phase("2d ssd", check_ssd)
    phase("2e rmsnorm", check_rmsnorm)
    phase("2f flash frontends", check_flash_frontend)
    launches = phase("3 serve", main_path)
    features_launches = phase("3b-3e serve features", feature_path)
    tier_launches = phase("3f-3i host tier, snapshots, host sampling", tier_path)
    spec_launch = phase("3j-3l speculative decoding", spec_path)
    router_launches = phase("3m router", router_path)
    traced_launches = phase("3n traced", traced_path)
    mesh_launches = phase("3o mesh serve", mesh_serve_path)
    mesh_feature_counts = phase("3p mesh features", mesh_features_path)
    train_launches = phase("4 train", train_path)
    zamba_launches = phase("5 zamba serve", zamba_path)
    phase("6 function API", function_path)
    gemma2_counts = phase("7 gemma2 serve", gemma2_path)
    stablelm_counts = phase("8 stablelm serve", stablelm_path)
    moe_counts = phase("9 qwen3-moe serve", moe_path)
    xlstm_counts = phase("10 xlstm serve", xlstm_path)
    whisper_counts = phase("11 whisper static", whisper_path)
    vlm_counts = phase("12 internvl2 static", vlm_path)
    zamba_train_counts = phase("13 zamba train", zamba_train_path)
    moe_train_counts = phase("14 qwen3-moe train", moe_train_path)
    zamba_fsdp_counts = phase("14b zamba2 FSDP train", zamba_fsdp_path)
    frontier_train_counts = phase("15 whisper and xlstm train", frontier_train_path)
    results["phase_s"] = phase_s
    results["seconds"] = time.perf_counter() - t_start

    zp = results["zamba_preempt"]["launches"]
    zt = results["zamba_tier"]["launches"]
    phase_s["5b zamba preempt (inside 5)"] = results["zamba_preempt"]["seconds"]
    phase_s["5c zamba host tier (inside 5)"] = results["zamba_tier"]["seconds"]
    phase_s["5d zamba speculative decoding (inside 5)"] = results["zamba_spec"]["seconds"]
    phase_s["5m zamba mesh serve (inside 5)"] = results["zamba_mesh"]["seconds"]
    zs = results["zamba_spec"]["launches"]

    def tier_rows(name):
        """A kernel's launches on phases 3f-3i and 5c (where it runs)."""
        out = {ph: n[name] for ph, n in tier_launches.items() if name in n}
        if name in zt:
            out["5c"] = zt[name]
        return out

    def mesh_feature_rows(name):
        """A kernel's launches on phase 3p's runs."""
        return {ph: n[name] for ph, n in mesh_feature_counts.items()}

    def spec_rows(name):
        """A kernel's launches on phases 3j-3l and 5d (where it runs)."""
        out = {ph: n[name] for ph, n in spec_launch.items() if name in n}
        if name in zs:
            out["5d"] = zs[name]
        return out

    fl = {t["shape"]: t for t in results["flash_timing"]}
    pg = {t["lengths_from"]: t for t in results["paged_timing"]}
    names = ("flash_attention", "paged_attention", "flat_adam", "ssd", "rmsnorm", "rmsnorm_add",
             "rmsnorm_gated", "rmsnorm_gated_split")
    g7 = {name: gemma2_counts.get(name, 0) for name in names}
    s8 = {name: stablelm_counts.get(name, 0) for name in names}
    m9 = {name: moe_counts.get(name, 0) for name in names}
    # phases 10-12: each kernel row's launches on the three frontier paths
    moe_mesh_counts = results["moe_train"]["step1_rules"]["mesh"]["launches"]
    later = {name: dict(xlstm_launches=xlstm_counts.get(name, 0),
                        whisper_launches=whisper_counts.get(name, 0),
                        vlm_launches=vlm_counts.get(name, 0),
                        zamba_train_launches=zamba_train_counts.get(name, 0),
                        moe_train_launches=moe_train_counts.get(name, 0),
                        moe_mesh_train_launches=moe_mesh_counts.get(name, 0),
                        zamba_fsdp_train_launches=zamba_fsdp_counts.get(name, 0),
                        whisper_train_launches=frontier_train_counts["whisper-tiny"].get(name, 0),
                        xlstm_train_launches=frontier_train_counts["xlstm-1.3b"].get(name, 0))
             for name in names}
    wide_keys = ("q", "lengths", "ms", "ms_events", "plain_ms", "bound_ms", "bound_by",
                 "n_split", "device_kernels_per_call")
    fa = results["flat_adam_timing"]
    sd = results["ssd_timing"]
    # flat_adam at zamba2-1.2b's flat buffer: its device time from phase
    # 13's profiled step (one launch a step), and by CUDA events beside its
    # plain version's, fused Adam's and its bytes bound
    zt = results["zamba_train"]
    adam_n = zt["flat_total"]
    at = zt["adam_timing"]
    adam_zamba = dict(n=adam_n, ms=None, kernel_ms_events=at["kernel_ms"],
                      plain_ms=at["plain_ms"], library_ms=at["library_ms"],
                      bound_ms=at["bound_ms"], bound_by=at["bound_by"])
    if zt["profile"]:
        adam_zamba["ms"] = sum(k["ms"] for k in zt["profile"]["port_kernels"]
                               if "flat_adam_kernel" in k["name"]) or None
    # each row carries its time as kernel_ms and, for the chip check's
    # reader, as ms (the same number)
    br = {(r["shape"], r["half"]): r for r in results["paged_block_range_timing"]}
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:27",
             jax_function="repro.kernels.flash_attention.kernel.flash_attention_fwd",
             shape="q (1, 512, 15, 64), k/v (1, 512, 5, 64), bf16, causal",
             launches=launches["flash_attention"],
             features_launches=features_launches["flash_attention"],
             train_launches=train_launches["flash_attention"],
             zamba_launches=zamba_launches["flash_attention"],
             zamba_preempt_launches=zp["flash_attention"],
             tier_launches=tier_rows("flash_attention"),
             spec_launches=spec_rows("flash_attention"),
             router_launches=router_launches["flash_attention"],
             traced_launches=traced_launches["flash_attention"],
             mesh_launches=mesh_launches["flash_attention"],
             mesh_features_launches=mesh_feature_rows("flash_attention"),
             gemma2_launches=g7["flash_attention"],
             stablelm_launches=s8["flash_attention"], moe_launches=m9["flash_attention"],
             max_abs_err=max(r["max_abs_err"] for r in results["flash_cases"]
                             if r["dtype"] == "bfloat16"),
             kernel_ms=fl["serve"]["ms"], ms=fl["serve"]["ms"],
             ms_events=fl["serve"]["ms_events"], plain_ms=fl["serve"]["plain_ms"],
             bound_ms=fl["serve"]["bound_ms"], bound_by=fl["serve"]["bound_by"],
             library_ms=fl["serve"]["library_ms"],
             library_ms_events=fl["serve"]["library_ms_events"],
             library="torch.nn.functional.scaled_dot_product_attention (device time)",
             host_us_per_call=fl["serve"]["host_us_per_call"],
             other_shapes={n: {k: fl[n][k] for k in ("q", "ms", "ms_events", "library_ms",
                                                      "bound_ms")} for n in ("train", "zamba")},
             d128={n: {k: fl[n][k] for k in ("q", "window", "ms", "ms_softcap", "ms_events",
                                             "plain_ms", "library_ms", "bound_ms", "bound_by")}
                   for n in ("gemma2 serve", "gemma2 long")},
             d128_max_abs_err={dt: max(r["max_abs_err"] for r in results["flash_cases"]
                                       if r.get("D") == 128 and r["dtype"] == dt)
                               for dt in ("bfloat16", "float32")},
             d160={n: {k: fl[n][k] for k in ("q", "ms", "ms_softcap", "ms_events", "plain_ms",
                                             "library_ms", "bound_ms", "bound_by")}
                   for n in ("stablelm serve", "stablelm long")},
             d160_max_abs_err={dt: max(r["max_abs_err"] for r in results["flash_cases"]
                                       if r.get("D") == 160 and r["dtype"] == dt)
                               for dt in ("bfloat16", "float32")},
             d160_ptxas_spill_bytes=results["ptxas_flash_d160_spill_bytes"],
             frontend={n: {k: fl[n][k] for k in ("q", "kv", "causal", "ms", "ms_events",
                                                  "plain_ms", "library_ms", "bound_ms",
                                                  "bound_by")}
                       for n, *_ in FLASH_FRONTEND},
             frontend_max_abs_err={dt: max(r["max_abs_err"] for r in results["flash_cases"]
                                           if "Sq" in r and r["dtype"] == dt)
                                   for dt in ("bfloat16", "float32")},
             train_shapes={n: {k: fl[n][k] for k in ("q", "kv", "ms", "ms_events", "plain_ms",
                                                     "library_ms", "bound_ms", "bound_by",
                                                     "max_abs_err")}
                           for n in ("zamba train", "qwen3-moe train")},
             **later["flash_attention"]),
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention/kernel.py:30",
             jax_function="repro.kernels.paged_attention.kernel.paged_attention_fwd",
             shape="q (8, 5, 3, 64), pools (513, 16, 5, 64), bf16, lengths 1..1023",
             launches=launches["paged_attention"],
             features_launches=features_launches["paged_attention"],
             tier_launches=tier_rows("paged_attention"),
             spec_launches=spec_rows("paged_attention"),
             router_launches=router_launches["paged_attention"],
             traced_launches=traced_launches["paged_attention"],
             mesh_launches=mesh_launches["paged_attention"],
             gemma2_launches=g7["paged_attention"],
             stablelm_launches=s8["paged_attention"], moe_launches=m9["paged_attention"],
             max_abs_err=max(r["max_abs_err"] for r in results["paged_cases"]
                             if r["dtype"] == "bfloat16"),
             kernel_ms=pg["random"]["ms"], ms=pg["random"]["ms"],
             ms_events=pg["random"]["ms_events"], plain_ms=pg["random"]["plain_ms"],
             bound_ms=pg["random"]["bound_ms"], bound_by=pg["random"]["bound_by"],
             library_ms=None, n_split=pg["random"]["n_split"],
             device_kernels_per_call=pg["random"]["device_kernels_per_call"],
             host_us_per_call=pg["random"]["host_us_per_call"],
             phase3_lengths={k: pg["phase 3"][k] for k in ("ms", "ms_events", "bound_ms")},
             d128={n: {k: pg[n][k] for k in ("q", "lengths", "ms", "ms_events", "plain_ms",
                                             "bound_ms", "bound_by", "n_split")}
                   for n in ("phase 7 local", "phase 7 global")},
             d128_max_abs_err={dt: max(r["max_abs_err"] for r in results["paged_cases"]
                                       if r.get("D") == 128 and r["dtype"] == dt)
                               for dt in ("bfloat16", "float32")},
             wide={n: {k: pg[n][k] for k in wide_keys}
                   for n in ("phase 8", "phase 9", "rep 16 D 128", "rep 16 D 160")},
             head_run={**{k: pg["head run"][k] for k in wide_keys},
                       "pool_heads": 4, "max_abs_err": {
                           dt: max(r["max_abs_err"] for r in results["paged_cases"]
                                   if r.get("pool_heads") and r["dtype"] == dt)
                           for dt in ("bfloat16", "float32")}},
             wide_max_abs_err={f"rep {rep} D {D}": {
                 dt: max(r["max_abs_err"] for r in results["paged_cases"]
                         if (r.get("rep"), r.get("D"), r["dtype"]) == (rep, D, dt))
                 for dt in ("bfloat16", "float32")} for rep, D, _ in PAGED_WIDE},
             **later["paged_attention"]),
        dict(name="paged_attention_range", route="cuda",
             source="src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention/kernel.py:30",
             jax_function=("repro.kernels.paged_attention.kernel.paged_attention_fwd on a data "
                           "rank's blocks (repro.models.lm.paged_cache_pspec)"),
             shape=("q (8, 5, 3, 64) bf16, blocks [0, 256) of a pool of 513 x 16 x 5 x 64, "
                    "phase 3's lengths, (m, l) out"),
             launches=mesh_launches["paged_attention_range"],
             mesh_features_launches=mesh_feature_rows("paged_attention_range"),
             max_abs_err=max(r["max_abs_err"] for r in results["paged_block_range_cases"]
                             if r["dtype"] == "bfloat16"),
             max_abs_err_vs_whole=max(r["max_abs_err_vs_whole"]
                                      for r in results["paged_block_range_cases"]
                                      if r["dtype"] == "bfloat16"),
             full_range_bitwise=all(r["full_range_bitwise"]
                                    for r in results["paged_block_range_cases"]),
             kernel_ms=br[("D 64", 0)]["ms"], ms=br[("D 64", 0)]["ms"],
             ms_events=br[("D 64", 0)]["ms_events"], plain_ms=br[("D 64", 0)]["plain_ms"],
             bound_ms=br[("D 64", 0)]["bound_ms"], bound_by=br[("D 64", 0)]["bound_by"],
             library_ms=None, device_kernels_per_call=br[("D 64", 0)]["device_kernels_per_call"],
             halves={f"{name} half {h}": {k: r[k] for k in (
                 "blocks", "pool_positions_read", "ms", "ms_events", "plain_ms", "bound_ms",
                 "bound_by")} for (name, h), r in br.items()}),
        dict(name="flat_adam", route="cuda",
             source="src/repro_torch/kernels/flat_adam/csrc/flat_adam.cu",
             replaces="src/repro/kernels/flat_adam/kernel.py:18",
             jax_function="repro.kernels.flat_adam.kernel.flat_adam",
             shape=f"p, g, m, v ({fa['n']},) fp32, t 1000, wd 0",
             launches=train_launches["flat_adam"], gemma2_launches=g7["flat_adam"],
             stablelm_launches=s8["flat_adam"], moe_launches=m9["flat_adam"],
             max_abs_err=max(r["max_abs_err"] for r in results["flat_adam_cases"]),
             kernel_ms=fa["kernel_ms"], ms=fa["kernel_ms"], plain_ms=fa["plain_ms"],
             bound_ms=fa["bound_ms"], bound_by=fa["bound_by"], library_ms=fa["library_ms"],
             train_shapes={"zamba train": adam_zamba},
             **later["flat_adam"]),
        dict(name="ssd", route="cuda", source="src/repro_torch/kernels/ssd/csrc/ssd.cu",
             replaces="src/repro/kernels/ssd/kernel.py:23",
             jax_function="repro.kernels.ssd.kernel.ssd_fwd",
             shape="x (1, 512, 64, 64) bf16, dt (1, 512, 64), B/C (1, 512, 1, 64); "
                   "y and state fp32",
             launches=zamba_launches["ssd"], zamba_preempt_launches=zp["ssd"],
             gemma2_launches=g7["ssd"], stablelm_launches=s8["ssd"], moe_launches=m9["ssd"],
             tier_launches=tier_rows("ssd"), spec_launches=spec_rows("ssd"),
             max_abs_err=max(r["max_abs_err"] for r in results["ssd_cases"]),
             kernel_ms=sd["ms"], ms=sd["ms"], ms_events=sd["ms_events"],
             plain_ms=sd["plain_ms"], bound_ms=sd["bound_ms"], bound_by=sd["bound_by"],
             bound_fma_ms=sd["bound_fma_ms"], library_ms=None, blocks=sd["blocks"],
             device_kernels_per_call=sd["device_kernels_per_call"],
             host_us_per_call=sd["host_us_per_call"],
             t2048={k: results["ssd_timing_2048"][k]
                    for k in ("ms", "plain_ms", "bound_ms", "bound_fma_ms", "blocks")},
             train_shapes={"zamba train": {
                 **{k: results["ssd_timing_train"][k]
                    for k in ("x", "ms", "ms_events", "plain_ms", "bound_ms", "bound_by")},
                 "max_abs_err": {r["input_dtype"]: max(r["y_max_abs_err"], r["state_max_abs_err"])
                                 for r in results["ssd_grad"]["cases"]
                                 if r["x"][:2] == [ZT_BATCH // ZT_SLICES, ZT_SEQ]},
                 "backward_ms": results["ssd_grad"]["timing"]["backward_ms"],
                 "plain_backward_ms": results["ssd_grad"]["timing"]["plain_backward_ms"]}},
             grad_max_abs_err={dt: max(r[g + "_max_abs_err"] for r in results["ssd_grad"]["cases"]
                                       if r["input_dtype"] == dt for g in ("d_xbc", "d_dt", "d_A"))
                               for dt in ("float32", "bfloat16")},
             **later["ssd"]),
    ]
    rn = {(t["kernel"], *t["shape"]): t for t in results["rmsnorm_timing"]}
    # each row at a shape of the path whose launches it reports: rmsnorm
    # and rmsnorm_add at the dense decode step's (phase 3), the gated form
    # at the zamba prefill's (phase 5); the paths' other shapes beside,
    # with the launches of zamba (2048 wide) and of the train step
    # (4096, 960).  The gated form has no TPU kernel of its own: it is
    # _rmsnorm_kernel's port with the reference's jnp skip and gate
    # (models/ssm.py:244-246) folded into its load.
    for name, line, shape, x_desc in (
            ("rmsnorm", 18, (8, 960), "x (8, 960) bf16, gamma (960,) fp32"),
            ("rmsnorm_add", 26, (8, 960), "x, r (8, 960) bf16, gamma (960,) fp32"),
            ("rmsnorm_gated", 18, (512, 4096), "y (512, 4096) fp32, z, x (512, 4096) bf16 "
             "views, gamma (4096,), D (64,) fp32")):
        t = rn[(name, *shape)]
        per_path = dict(zamba_preempt_launches=zp[name]) if name == "rmsnorm_gated" else dict(
            features_launches=features_launches[name],
            router_launches=router_launches[name], traced_launches=traced_launches[name],
            mesh_launches=mesh_launches[name], mesh_features_launches=mesh_feature_rows(name),
            train_launches=train_launches[name], train_shape="(4096, 960)",
            zamba_launches=zamba_launches[name], zamba_preempt_launches=zp[name],
            zamba_shapes="(8, 2048), (512, 2048)")
        kernels.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
            replaces=f"src/repro/kernels/rmsnorm/kernel.py:{line}",
            jax_function=("repro.models.ssm.mamba_block_fwd (skip, gate, rms_norm)"
                          if name == "rmsnorm_gated" else f"repro.kernels.rmsnorm.kernel.{name}"),
            shape=x_desc, path=t["path"],
            launches=(zamba_launches if name == "rmsnorm_gated" else launches)[name],
            gemma2_launches=g7[name], stablelm_launches=s8[name], moe_launches=m9[name],
            **later[name], **per_path, tier_launches=tier_rows(name),
            spec_launches=spec_rows(name),
            max_abs_err=max(r[f"{name}_max_abs_err"] for r in results["rmsnorm_cases"]
                            if f"{name}_max_abs_err" in r),
            kernel_ms=t["ms"], ms=t["ms"], ms_warm=t["ms_warm"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"],
            host_us_per_call=t["host_us"], plain_host_us_per_call=t["plain_host_us"],
            other_shapes={f"{n}x{d}": {k: u[k] for k in ("path", "ms", "ms_warm", "bound_ms",
                                                          "library_ms", "host_us")}
                          for (k_, n, d), u in rn.items() if k_ == name and (n, d) != shape}))
    # the split entry: its time at a zamba2 train slice (one shard: the
    # (1, 1) mesh's call, two launches), its launches on phase 14b's mesh
    # run (14m) and on phase 5m (none: serving runs every head and the
    # whole-row gated norm)
    sp = {t["shape"][0]: t for t in results["rmsnorm_split_timing"]}
    zm = results["zamba_fsdp_train"]["step1_rules"]["mesh"]
    split_cases = results["rmsnorm_split_cases"]
    kernels.append(dict(
        name="rmsnorm_gated_split", route="cuda",
        source="src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm/kernel.py:18",
        jax_function=("repro.models.ssm.mamba_block_fwd (skip, gate, rms_norm over the "
                      "whole d_inner row) under the model axis"),
        shape=("y (2048, 4096) fp32, z, x (2048, 4096) bf16 views, gamma (4096,), D (64,) "
               "fp32; a call = the sum-of-squares launch and the scaled launch"),
        path=sp[2048]["path"], launches=zm["launches"]["rmsnorm_gated_split"],
        zamba_mesh_serve_launches=results["zamba_mesh"]["launches"]["rmsnorm_gated_split"],
        max_abs_err=max(r["max_abs_err"] for r in split_cases if r["dtype"] == "bfloat16"),
        max_abs_err_vs_whole={f"{r['dtype']} {r['shards']} shards {r['shape'][0]} rows":
                              r["max_abs_err_vs_whole"] for r in split_cases},
        one_shard_bitwise_whole=all(r["bitwise_whole"] for r in split_cases if r["shards"] == 1),
        kernel_ms=sp[2048]["ms"], ms=sp[2048]["ms"], ms_events=sp[2048]["ms_events"],
        ms_warm=sp[2048]["ms_warm"], plain_ms=sp[2048]["plain_ms"],
        bound_ms=sp[2048]["bound_ms"], bound_by=sp[2048]["bound_by"], library_ms=None,
        device_kernels_per_call=sp[2048]["device_kernels_per_call"],
        host_us_per_call=sp[2048]["host_us"],
        other_shapes={"8x4096": {k: sp[8][k] for k in ("path", "ms", "ms_events", "ms_warm",
                                                       "plain_ms", "bound_ms", "host_us")}}))
    decode_keys = ("kernel_launches_per_step", "device_ms_per_step", "device_idle_share",
                   "step_ms_unprofiled", "replay_host_ms_median",
                   "eager_kernel_launches_per_step", "eager_device_ms_per_step", "eager_step_ms")
    steps = {name: results[key] and {k: results[key][k] for k in keys}
             for name, key, keys in (
                 ("dense decode step", "profile", decode_keys),
                 ("zamba decode step", "zamba_profile", decode_keys),
                 ("gemma2 decode step", "gemma2_profile", decode_keys + ("bound_ms",)),
                 ("stablelm decode step", "stablelm_profile", decode_keys + ("bound_ms",)),
                 ("qwen3-moe decode step", "moe_profile", decode_keys + ("bound_ms",)),
                 ("xlstm decode step", "xlstm_profile", decode_keys + ("bound_ms",)),
                 ("zamba prefill 512", "zamba_prefill_profile", ("launches", "device_ms",
                                                                 "device_idle_share")),
                 ("xlstm prefill 512", "xlstm_prefill_profile", ("launches", "device_ms",
                                                                 "device_idle_share",
                                                                 "host_ms_median",
                                                                 "bound_ms")))}
    results["step_profiles"] = steps
    log(f"profiled steps: {json.dumps(steps)}")
    train_keys = ("step_ms_unprofiled", "device_busy_ms", "device_idle_share", "kernel_launches")
    train_steps = {name: prof and {k: prof[k] for k in train_keys}
                   for name, prof in (("dense train step (4)", results["train_profile"]),
                                      ("zamba train step (13)", zt["profile"]),
                                      ("qwen3-moe train step (14, FSDP)",
                                       results["moe_train"]["profile"]),
                                      ("qwen3-moe train step (14, mesh (1, 1))",
                                       results["moe_train"]["step1_rules"]["mesh"]["profile"]),
                                      ("zamba2 segment train step (14m, mesh (1, 1))",
                                       zm["profile"]))}
    for name, ms in (("qwen3-moe train step (14, FSDP)", results["moe_train"]["step_ms_median"]),
                     ("qwen3-moe train step (14, mesh (1, 1))",
                      results["moe_train"]["step1_rules"]["mesh"]["step_ms_median"]),
                     ("zamba2 segment train step (14m, mesh (1, 1))", zm["step_ms_median"])):
        train_steps[name] = {"host_ms_median": ms, **(train_steps[name] or {})}
    log(f"profiled train steps: {json.dumps(train_steps)}")
    results["kernels"] = kernels
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "results.json").write_text(json.dumps(results, indent=1))
    log(f"chip_smoke: all phases passed in {results['seconds']:.1f} s; phases "
        f"{json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
