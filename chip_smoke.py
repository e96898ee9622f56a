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
   synchronize).
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
   wrapper's host microseconds per call.
2e. Hold the RMSNorm kernel's three entries against their plain versions
   at the main paths' (rows, width) (``RMSNORM_PATHS``): smollm-360m's
   (8, 960), (512, 960) and (4096, 960), zamba2's (8, 2048) and
   (512, 2048), and (8, 4096) and (512, 4096), bf16 and fp32 (``TOL``; the
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
   calls of a few microseconds, beside them as ``*_events``.
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
4. Train full-width ``smollm-360m`` (seed 0, bf16 compute, both kernels)
   over a 1-rank NCCL group at seq 1024, global batch 8, 2 slices, remat:
   the faithful program for 6 steps and ZeRO for 3, through
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
7. Print the launches, device ms and idle share of the profiled dense and
   zamba decode steps and zamba prefill, the seconds of each phase, the
   card's name and power limit, one
   ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
   {...}}``.  Details go to ``results.json`` in ``OUT_DIR``.

It imports nothing of JAX or of the reference package, and exits non-zero
without a CUDA card or outside the repository.
"""
from __future__ import annotations

import dataclasses
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
# flash timing shapes (name, B, S, H, Hk), bf16, causal: a smollm-360m
# prefill at bucket 512, the training step's (batch 4 a slice, seq 1024),
# a zamba2-1.2b shared-block prefill at bucket 512 (rep 1)
FLASH_TIMING = (("serve", 1, 512, 15, 5), ("train", 4, 1024, 15, 5), ("zamba", 1, 512, 32, 32))
SMOLLM_VOCAB = 49152

N_LAYERS = 32
PAGE = 16
MAX_LEN = 1024
MAX_SLOTS = 8

# the SSD scan's fp32 outputs, kernel vs plain: a share of the tensor's
# largest entry plus a share of each entry (see the docstring, 2d)
SSD_TOL = dict(scale=1e-4, rtol=1e-4)
SSD_SHAPE = (1, 512, 64, 64, 1, 64)        # B, T, H, P, G, N: a zamba2 prefill
# one full-width block, kernel path vs plain path, as a share of the
# output's largest entry (see zamba_block_agreement)
BLOCK_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ZAMBA_LAYERS, ZAMBA_SHARED = 38, 7
ZAMBA_D_INNER, ZAMBA_HEAD_DIM = 4096, 64
# the RMSNorm shapes (rows, width) of the main paths and the path that
# gives each: smollm-360m's d_model (960) in a decode step of 8 lanes, a
# prefill at bucket 512 and a training slice (4 x 1024 tokens); zamba2's
# d_model (2048) in a decode step and a bucket-512 prefill; its d_inner
# (4096) at the same rows, the gated out-norm's (no path calls rmsnorm or
# rmsnorm_add that wide)
RMSNORM_PATHS = {(8, 960): "dense decode", (512, 960): "dense prefill",
                 (4096, 960): "dense train", (8, 2048): "zamba decode",
                 (512, 2048): "zamba prefill", (8, 4096): "zamba decode (gated only)",
                 (512, 4096): "zamba prefill (gated only)"}
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
        # back empty (once, a window of 50 calls of a 2-microsecond kernel):
        # the window is measured again, up to twice
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        if evs:
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
    results["flash_cases"] = rows

    # timing, bf16, causal, at the main paths' shapes: device time per call
    # from the profiler (ms), back-to-back CUDA events beside it
    # (ms_events); SDPA, which the port never calls, as the yardstick
    timings = []
    for name, B, S, H, Hk in FLASH_TIMING:
        dt = "bfloat16"
        q, k, v = (torch.randn(B, S, h, D, generator=gen, device=dev).to(torch.bfloat16)
                   for h in (H, Hk, Hk))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        qc, kc, vc = (x.contiguous() for x in (qt, kt, vt))
        kernel = lambda: flash_attention(q, k, v, causal=True)
        plain = lambda: attention_ref(qt, kt, vt, causal=True)
        lib = lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                                     enable_gqa=True)
        out = kernel()
        torch.cuda.synchronize()
        want = plain().transpose(1, 2)
        pairs = B * S * (S + 1) // 2                 # causal (query, key) pairs
        row = dict(shape=name, q=[B, S, H, D], kv=[B, S, Hk, D], dtype=dt, causal=True,
                   max_abs_err=max_err(torch, out, want, dt),
                   library_max_abs_err=(lib().transpose(1, 2).float() - want.float()).abs().max().item())
        row["bound_ms"], row["bound_by"] = bound(4 * D * H * pairs,
                                                 2 * B * S * D * (2 * H + 2 * Hk), dt)
        iters = 200 if B * S <= 512 else 50
        row["ms"], kernels = device_profile(torch, kernel)
        row["device_kernels_per_call"] = kernels_per_call(kernels)
        row["plain_ms"] = device_ms(torch, plain, 20)
        row["library_ms"], row["library_kernels"] = device_profile(torch, lib)
        row["vs_library"] = row["ms"] / row["library_ms"] if row["ms"] and row["library_ms"] else None
        row["ms_events"] = time_ms(torch, kernel, iters)
        row["plain_ms_events"] = time_ms(torch, plain, 20)
        row["library_ms_events"] = time_ms(torch, lib, iters)
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


def pool_positions_read(lengths, tables, bs: int) -> int:
    """Distinct pool positions (block, offset) a decode step must read: each
    lane's positions [0, length] through its table row.  A position mapped by
    several lanes, as the sink block 0 is by every stale lane, counts once."""
    need = np.zeros((int(tables.max()) + 1, bs), bool)
    for length, row in zip(lengths, tables):
        for j in range(min(int(length) // bs + 1, row.size)):
            need[row[j], : min(bs, int(length) - j * bs + 1)] = True
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
    results["paged_cases"] = rows
    # timing at the decode step's shape: 8 lanes, 5 KV heads x 3 queries,
    # bs 16, bf16; 8 layers of pools (84 MB, over the 50 MB L2) walked in
    # turn, so each launch finds its pool cold, as a layer's does in
    # decode.  Lengths: random 1..1023 (two lanes stale), and phase 3's own
    # (its profiled decode steps: the first 8 prompts, ~10 tokens in).
    dt = "bfloat16"
    L = 8
    phase3 = [int(p.size) + 10 for p, _ in requests(SMOLLM_VOCAB)[:MAX_SLOTS]]
    timings = []
    for name, lens, nulled in (("random", None, (6, 7)), ("phase 3", phase3, ())):
        q, kp, vp, lengths, tables = paged_inputs(torch, dev, dt, layers=L, lengths=lens,
                                                  nulled=nulled)
        B, Hk, rep, D = q.shape
        n = lengths.long() + 1                   # positions [0, length] per lane
        esize = q.element_size()
        read = pool_positions_read(lengths.cpu().numpy(), tables.cpu().numpy(), PAGE)
        nbytes = (read * Hk * D * 2 + 2 * q.numel()) * esize \
            + 4 * (lengths.numel() + tables.numel())
        bps, n_split = split_plan(tables.shape[1], PAGE)
        row = dict(lengths_from=name, dtype=dt, lanes=B, lengths=lengths.tolist(),
                   nulled_lanes=list(nulled), pool_positions_read=read,
                   positions_attended=int(n.sum()), blocks_per_split=bps, n_split=n_split,
                   split_ctas=B * Hk * n_split)
        row["bound_ms"], row["bound_by"] = bound(4 * D * rep * Hk * int(n.sum()), nbytes, dt)
        out = paged_attention(q, kp[0], vp[0], lengths, tables)
        torch.cuda.synchronize()
        row["max_abs_err"] = max_err(torch, out, paged_attention_ref(q, kp[0], vp[0], lengths,
                                                                     tables), dt)
        i = [0]

        def step(fn):
            def go():
                layer = i[0] % L
                i[0] += 1
                return fn(q, kp[layer], vp[layer], lengths, tables)
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
    results["paged_timing"] = timings


def check_flat_adam(torch, dev, results):
    """flat_adam kernel vs its plain version over n, t, wd; times at the
    full flat buffer (kernel, plain, and torch's fused Adam as yardstick)."""
    from repro_torch.kernels.flat_adam.ops import flat_adam
    from repro_torch.kernels.flat_adam.ref import flat_adam_ref

    gen = torch.Generator(device=dev).manual_seed(3)
    hyper = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8)
    rows = []

    def inputs(n):
        p = torch.randn(n, generator=gen, device=dev) * 0.05
        g = torch.randn(n, generator=gen, device=dev) * 1e-2
        m = torch.randn(n, generator=gen, device=dev) * 1e-3
        v = torch.rand(n, generator=gen, device=dev) * 1e-4
        return p, g, m, v

    for n in (512, 65_537, ADAM_N_FULL):
        bufs = inputs(n)
        for t in (1, 1000):
            step = torch.tensor([t], dtype=torch.int32, device=dev)
            for wd in (0.0, 0.1):
                got = flat_adam(*bufs, step, weight_decay=wd, **hyper)
                torch.cuda.synchronize()
                want = flat_adam_ref(*bufs, step, weight_decay=wd, **hyper)
                err = max(max_err(torch, a, b, "float32", ADAM_TOL) for a, b in zip(got, want))
                rows.append(dict(n=n, t=t, wd=wd, max_abs_err=err))
                log(f"flat_adam {json.dumps(rows[-1])}")
                del got, want
        if n != ADAM_N_FULL:
            continue
        step = torch.tensor([1000], dtype=torch.int32, device=dev)
        timing = dict(n=n, t=1000, wd=0.0, dtype="float32")
        timing["bound_ms"], timing["bound_by"] = bound(14.0 * n, 28.0 * n, "float32")   # 14 flops, 28 bytes an element
        timing["kernel_ms"] = time_ms(torch, lambda: flat_adam(*bufs, step, **hyper), 20)
        timing["plain_ms"] = time_ms(torch, lambda: flat_adam_ref(*bufs, step, **hyper), 5)
        # yardstick the port never calls: torch's fused Adam on the same
        # buffer (its L2 weight decay differs from the decoupled form;
        # with wd = 0 it is the same function), in place
        p, g, m, v = bufs
        w = torch.nn.Parameter(p.clone())
        w.grad = g
        lib = torch.optim.Adam([w], lr=hyper["lr"], betas=(0.9, 0.95), eps=1e-8,
                               weight_decay=0.0, fused=True)
        timing["library_ms"] = time_ms(torch, lib.step, 20)
        timing["library"] = "torch.optim.Adam(fused=True), wd 0: the same function"
        results["flat_adam_timing"] = timing
        log(f"flat_adam timing {json.dumps(timing)}")
        del w, lib
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


def ssd_timing(torch, dev, T, *, plain_iters: int, host: bool = False) -> dict:
    """Kernel and plain version at x (1, T, 64, 64) bf16 by device time per
    call, the kernel's device kernels by name, the blocks of each of its
    passes, and both bounds: the fp32 FMA pipes' (the first design's) and the
    bf16 tensor cores' (bytes at these shapes), the row's own."""
    from repro_torch.kernels.ssd.ops import ssd, ssd_plan
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    B, _, H, P, G, N = SSD_SHAPE
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


# ---------------------------------------------------------------------------
# Phase 3: the main path at full width
# ---------------------------------------------------------------------------


def requests(vocab: int, n: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    plens = rng.integers(16, 513, n)
    budgets = rng.integers(32, 65, n)
    return [(rng.integers(0, vocab, int(p)).astype(np.int32), int(b))
            for p, b in zip(plens, budgets)]


def serve(torch, cfg, params, reqs, engine_cfg, dev, *, check: bool = False):
    """Submit every request at once and drain; returns (engine, per-step
    host times in ms, whether each step ran a prefill, wall seconds): one
    synchronized span over the whole drain loop. ``check`` sweeps
    ``check_invariants`` after every step; the sweep (from a synchronize
    after the step to its end) is taken out of the wall time."""
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, engine_cfg, device=dev)
    rids = [eng.submit(p, max_new_tokens=b) for p, b in reqs]
    steps, prefilled = [], []
    swept = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.has_work():
        before = eng.counters["prefills"]
        t = time.perf_counter()
        eng.step()
        steps.append((time.perf_counter() - t) * 1e3)
        prefilled.append(eng.counters["prefills"] != before)
        if check:
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.check_invariants()
            swept += time.perf_counter() - t
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - swept
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
                sampling: dict | None = None) -> dict:
    """The captured decode graph against the eager program it captured: an
    engine admits the first ``MAX_SLOTS`` requests (greedy, or with
    ``sampling``'s temperature, top-k and top-p) and takes its first
    decode step (which builds the graph); then it takes ``steps`` more
    steps, each of which (after the engine has mapped blocks and pushed
    its mirrors) runs the eager program on a deep clone of the state (the
    sampling generator's state copied) and replays the graph on the state
    itself.  The sampled tokens must be equal and every state leaf bitwise
    equal: the two launch the same kernels in the same order on the same
    inputs, and draw the same uniforms from the same generator state."""
    from repro_torch.core.aot import CudaGraphProgram
    from repro_torch.serve import ServeEngine

    sampling = sampling or {}
    flags = dict(stochastic=sampling.get("temperature", 0) > 0,
                 masked=bool(sampling.get("top_k")) or 0 < sampling.get("top_p", 1) < 1)
    eng = ServeEngine(cfg, params, ec, device=dev)
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
    results["logits"] = logit_agreement(torch, dev, base, params, reqs[2][0])
    return launches


def program_builds(eng, reqs) -> dict:
    """The engine's program cache after a run: one decode program and one
    prefill per prompt bucket the run used, one decode graph, then flat
    while the engine serves four of the requests again (``steady_builds``)."""
    from repro_torch.serve import bucket_for

    st = eng.stats
    buckets = sorted({bucket_for(int(p.size), eng.buckets) for p, _ in reqs})
    out = dict(builds=st["builds"], cache_hits=st["cache_hits"],
               executables=st["executables"], graphs=st["graphs"], buckets=buckets,
               decode_build_s=list(eng.graphs.build_seconds.values()))
    assert st["builds"] == st["executables"] == 1 + len(buckets) and st["graphs"] == 1, out
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
# (plain, add, gated); paged_combine_kernel, the second kernel of a
# paged_attention call, is counted with its split kernel
DECODE_WRAPPER = ((re.compile(r"::rmsnorm_kernel<[^,]+, 0,"), "rmsnorm"),
                  (re.compile(r"::rmsnorm_kernel<[^,]+, 1,"), "rmsnorm_add"),
                  (re.compile(r"::rmsnorm_kernel<[^,]+, 2,"), "rmsnorm_gated"),
                  (re.compile(r"::paged_split_kernel<"), "paged_attention"))


def replay_launches(kernels, steps: int) -> dict:
    """{wrapper name: launches per step} of the port's kernels in a profile
    of ``steps`` decode-graph replays: what the replays really launched,
    to hold against the counts the graph adds to the wrappers' counters.
    Each kernel's calls per step are rounded to a whole launch (the
    profiler can miss the first launches of its window)."""
    per, combine = {}, 0
    for e in kernels:
        if not PORT_KERNEL.match(e.key):
            continue
        n = round(e.count / steps)
        if "::paged_combine_kernel<" in e.key:
            combine += n
            continue
        name = next((w for rx, w in DECODE_WRAPPER if rx.search(e.key)), None)
        assert name is not None, f"a decode replay launched {e.key[:100]}"
        per[name] = per.get(name, 0) + n
    assert combine == per.get("paged_attention", 0), (combine, per)
    return per


def port_kernels(kernels, per: float) -> list[dict]:
    """The port's own kernels in a profile: name, calls and device ms per
    ``per``."""
    return [dict(name=e.key[:100], calls=e.count / per, ms=e.self_device_time_total / 1e3 / per)
            for e in kernels if PORT_KERNEL.match(e.key)]


def profile_decode(torch, cfg, params, reqs, ec, dev, steps: int = 5):
    """Device time of a few decode steps with all 8 lanes busy, by kernel,
    from ``torch.profiler``; the idle share is taken against the step
    time of the same steps run again unprofiled.  The steps are the
    engine's: one replay of the captured decode graph and the token fetch.
    The port's kernels in the profiled replays must be, wrapper by wrapper,
    the launches the graph adds to the wrappers' counters per replay.
    Then the host ms of one replay alone (no fetch, a synchronize after
    it), and the eager program the graph captured, run and profiled on
    the same state: its launches and device ms per step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, ec, device=dev)
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
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
    measured = replay_launches(kernels, steps)
    assert measured == counted, (measured, counted)
    total_us = sum(e.self_device_time_total for e in kernels)
    eager_us = sum(e.self_device_time_total for e in ekernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    out = dict(steps=steps, lanes=MAX_SLOTS, step_ms_unprofiled=step_ms,
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


def logit_agreement(torch, dev, base, params, prompt):
    """Prefill (flash kernel vs chunked) and the first decode step (paged
    kernel vs ref, from the same cache) through the lm entry points, in
    fp32 compute with TF32 off and in bf16."""
    from repro_torch.models import lm

    out = {}
    plen = int(prompt.size)
    C = 1 << (plen - 1).bit_length()                  # the prompt's bucket
    nb = MAX_LEN // PAGE
    table = torch.zeros(nb, dtype=torch.int32, device=dev)
    table[: plen // PAGE + 1] = torch.arange(1, plen // PAGE + 2, dtype=torch.int32)
    chunk = torch.zeros(1, C, dtype=torch.int32, device=dev)
    chunk[0, :plen] = torch.tensor(prompt, device=dev)
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, compute_dtype=dt)
        p = lm.cast_for_compute(cfg, params, dev)
        caches, logits = {}, {}
        for impl in ("kernel", "chunked"):
            c = {k: torch.zeros_like(s, device=dev)
                 for k, s in lm.make_paged_cache_specs(cfg, nb + 1, PAGE).items()}
            caches[impl], logits[impl] = lm.prefill_slot_paged(
                dataclasses.replace(cfg, attn_impl=impl), p, c, chunk, table, plen)
        pre = rel_err(torch, logits["kernel"], logits["chunked"])
        tok = logits["chunked"].float().argmax(-1).to(torch.int32)
        lengths = torch.tensor([plen], dtype=torch.int32, device=dev)
        dec = {}
        for impl in ("kernel", "ref"):
            c = {k: v.clone() for k, v in caches["chunked"].items()}
            dec[impl], _ = lm.decode_step_paged(cfg, p, c, tok, lengths, table[None], impl=impl)
        d = rel_err(torch, dec["kernel"], dec["ref"])
        out[dt] = dict(prefill_rel_err=pre, decode_rel_err=d, tolerance=LOGIT_TOL[dt],
                       prompt_len=plen, bucket=C,
                       prefill_argmax_equal=bool(logits["kernel"].argmax() == logits["chunked"].argmax()),
                       decode_argmax_equal=bool(dec["kernel"].argmax() == dec["ref"].argmax()))
        log(f"logits {dt}: {json.dumps(out[dt])}")
        assert pre <= LOGIT_TOL[dt] and d <= LOGIT_TOL[dt], out[dt]
    return out


def rel_err(torch, a, b) -> float:
    a, b = a.float(), b.float()
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())
    return ((a - b).abs().max() / b.abs().max()).item()


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
    # per prefill and decode step: rmsnorm for the shared block's ln1, each
    # Mamba2 layer's ln and ln_f; the gated form for each Mamba2 out-norm
    # (with its skip and gate); rmsnorm_add for the shared block's ln2
    want = {"flash_attention": ZAMBA_SHARED * pre, "ssd": ZAMBA_LAYERS * pre,
            "rmsnorm": (ZAMBA_SHARED + ZAMBA_LAYERS + 1) * (pre + dec),
            "rmsnorm_add": ZAMBA_SHARED * (pre + dec),
            "rmsnorm_gated": ZAMBA_LAYERS * (pre + dec)}
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
    wall ms, per-step loss).  The step times come from a synchronize in
    ``on_step``: the program itself makes no host sync."""
    from repro_torch.train import LoopConfig, train

    times, losses = [], []
    torch.cuda.synchronize()
    t = [time.perf_counter()]

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append((now - t[0]) * 1e3)
        t[0] = now
        losses.append(metrics["loss"])

    res = train(cfg, shape, group, opt, settings,
                LoopConfig(steps=steps, ckpt_every=0, log_every=0, seed=0), on_step=on_step)
    return res, times, [float(x) for x in losses]


def eval_loss(torch, cfg, params, shape, group) -> float:
    """The loss of the stream's batch 0 under ``params``, in the train
    step's slices (the mean of the slices' means, as the step reports)."""
    from repro_torch.data import make_batch_fn
    from repro_torch.models import lm

    toks = torch.as_tensor(make_batch_fn(cfg, shape, 0)(0)["tokens"], device=group.device)
    with torch.no_grad():
        return float(sum(lm.loss_fn(cfg, params, {"tokens": t}, remat=False)[0]
                         for t in toks.chunk(TRAIN_SLICES)) / TRAIN_SLICES)


def step_agreement(torch, base, group, opt, shape, settings):
    """Step 1 from the same weights and batch through the kernel path
    (flash + flat_adam kernel) and the plain path (chunked + plain Adam),
    in fp32 compute with TF32 off and in bf16."""
    from repro_torch.data import make_batch_fn
    from repro_torch.models import lm
    from repro_torch.train.step import build_train_step, opt_state_template

    batch = make_batch_fn(base, shape, 0)(0)
    out = {}
    for dt in ("float32", "bfloat16"):
        runs = {}
        for path, impl, kern in (("kernel", "kernel", None), ("plain", "chunked", False)):
            cfg = dataclasses.replace(base, attn_impl=impl, compute_dtype=dt)
            st = dataclasses.replace(settings, flat_kernel=kern)
            params = lm.init(cfg, seed=0, device=group.device)
            step_fn = build_train_step(cfg, group, opt, st)
            _, _, m = step_fn(params, opt_state_template(cfg, group, opt, st)(params), batch)
            runs[path] = {k: float(m[k]) for k in ("loss", "grad_norm")}
            del params, m
        rel = {k: abs(runs["kernel"][k] - runs["plain"][k]) / abs(runs["plain"][k])
               for k in ("loss", "grad_norm")}
        out[dt] = dict(kernel=runs["kernel"], plain=runs["plain"], rel_err=rel,
                       tolerance=STEP_TOL[dt])
        log(f"step 1 agreement {dt}: {json.dumps(out[dt])}")
        assert all(rel[k] <= STEP_TOL[dt][k] for k in rel), out[dt]
    return out


def skip_is_noop(torch, cfg, group, opt, settings, params, opt_state, batch) -> dict:
    """One step on inf-poisoned parameters: skipped == 1 and p, m, v and the
    step counter bitwise as they were."""
    from repro_torch.optim.flat import flatten, unflatten
    from repro_torch.train.step import build_train_step, flat_layout_for

    layout = flat_layout_for(cfg)
    flat = flatten(layout, params).clone()
    flat[0] = float("inf")                         # blocks/ln1[0, 0]
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
    from repro_torch.checkpoint import CheckpointManager

    shutil.rmtree(tmp, ignore_errors=True)
    t = time.perf_counter()
    mgr = CheckpointManager(str(tmp), keep_k=1)
    mgr.save(6, {"params": params, "opt": opt_state})
    saved = time.perf_counter() - t
    step, state = mgr.restore({"params": params, "opt": opt_state})
    restored = {g: _to_torch(torch, tree) for g, tree in state.items()}
    ok = step == 6 and same_bits(torch, _to_torch(torch, {"params": params, "opt": opt_state}),
                                 restored)
    shutil.rmtree(tmp, ignore_errors=True)
    out = dict(step=step, bitwise=ok, save_s=saved, total_s=time.perf_counter() - t)
    assert ok, out
    return out


def _to_torch(torch, tree):
    if isinstance(tree, dict):
        return {k: _to_torch(torch, v) for k, v in tree.items()}
    return tree.detach().cpu() if torch.is_tensor(tree) else torch.from_numpy(np.array(tree))


def profile_train_step(torch, cfg, group, opt, settings, params, opt_state, batch):
    """Device time of one faithful train step by kernel, from
    ``torch.profiler`` (device activity only: the step dispatches some
    10^5 ops, and host-side events would multiply the trace); the idle
    share is taken against the same step run unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.step import build_train_step

    step_fn = build_train_step(cfg, group, opt, settings)
    torch.cuda.synchronize()
    t = time.perf_counter()
    p, o, _ = step_fn(params, opt_state, batch)
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
    """Phase 4: the faithful and ZeRO programs at full width over a 1-rank
    NCCL group.  Returns the launch counts of the faithful run."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch_fn
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flat_adam.ops import flat_adam
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add
    from repro_torch.launch.mesh import init_group
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainSettings

    base = dataclasses.replace(get_config("smollm-360m"), attn_impl="kernel")
    assert base.n_layers == N_LAYERS and base.compute_dtype == "bfloat16"
    shape = ShapeConfig("chip-smoke", "train", TRAIN_SEQ, TRAIN_BATCH)
    opt = OptConfig(kind="adam")
    group = init_group("nccl", 0, 1, f"tcp://127.0.0.1:{free_port()}", device=dev)
    out = {}
    try:
        programs = (("faithful", TrainSettings(num_slices=TRAIN_SLICES, faithful=True), 6),
                    ("zero", TrainSettings(num_slices=TRAIN_SLICES, flat_engine="zero"), 3))
        launches = {}
        for name, settings, steps in programs:
            torch.cuda.reset_peak_memory_stats()
            kernels = (flat_adam, flash_attention, rmsnorm, rmsnorm_add)
            for k in kernels:
                k.launches = 0
            res, times, losses = train_run(torch, base, shape, group, opt, settings, steps)
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
            assert launches[name]["flash_attention"] == 2 * N_LAYERS * TRAIN_SLICES * steps, row
            # per slice: ln1 and ln2 (with its add) in each layer, forward
            # and remat's recompute, and ln_f once
            assert launches[name]["rmsnorm"] == (2 * N_LAYERS + 1) * TRAIN_SLICES * steps, row
            assert launches[name]["rmsnorm_add"] == 2 * N_LAYERS * TRAIN_SLICES * steps, row
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
                    torch, base, group, opt, settings, res["params"], res["opt_state"], batch)
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
    launches = phase("3 serve", main_path)
    train_launches = phase("4 train", train_path)
    zamba_launches = phase("5 zamba serve", zamba_path)
    phase("6 function API", function_path)
    results["phase_s"] = phase_s
    results["seconds"] = time.perf_counter() - t_start

    fl = {t["shape"]: t for t in results["flash_timing"]}
    pg = {t["lengths_from"]: t for t in results["paged_timing"]}
    fa = results["flat_adam_timing"]
    sd = results["ssd_timing"]
    # each row carries its time as kernel_ms and, for the chip check's
    # reader, as ms (the same number)
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:27",
             jax_function="repro.kernels.flash_attention.kernel.flash_attention_fwd",
             shape="q (1, 512, 15, 64), k/v (1, 512, 5, 64), bf16, causal",
             launches=launches["flash_attention"],
             train_launches=train_launches["flash_attention"],
             zamba_launches=zamba_launches["flash_attention"],
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
                                                      "bound_ms")} for n in ("train", "zamba")}),
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention/kernel.py:30",
             jax_function="repro.kernels.paged_attention.kernel.paged_attention_fwd",
             shape="q (8, 5, 3, 64), pools (513, 16, 5, 64), bf16, lengths 1..1023",
             launches=launches["paged_attention"],
             max_abs_err=max(r["max_abs_err"] for r in results["paged_cases"]
                             if r["dtype"] == "bfloat16"),
             kernel_ms=pg["random"]["ms"], ms=pg["random"]["ms"],
             ms_events=pg["random"]["ms_events"], plain_ms=pg["random"]["plain_ms"],
             bound_ms=pg["random"]["bound_ms"], bound_by=pg["random"]["bound_by"],
             library_ms=None, n_split=pg["random"]["n_split"],
             device_kernels_per_call=pg["random"]["device_kernels_per_call"],
             host_us_per_call=pg["random"]["host_us_per_call"],
             phase3_lengths={k: pg["phase 3"][k] for k in ("ms", "ms_events", "bound_ms")}),
        dict(name="flat_adam", route="cuda",
             source="src/repro_torch/kernels/flat_adam/csrc/flat_adam.cu",
             replaces="src/repro/kernels/flat_adam/kernel.py:18",
             jax_function="repro.kernels.flat_adam.kernel.flat_adam",
             shape=f"p, g, m, v ({fa['n']},) fp32, t 1000, wd 0",
             launches=train_launches["flat_adam"],
             max_abs_err=max(r["max_abs_err"] for r in results["flat_adam_cases"]),
             kernel_ms=fa["kernel_ms"], ms=fa["kernel_ms"], plain_ms=fa["plain_ms"],
             bound_ms=fa["bound_ms"], bound_by=fa["bound_by"], library_ms=fa["library_ms"]),
        dict(name="ssd", route="cuda", source="src/repro_torch/kernels/ssd/csrc/ssd.cu",
             replaces="src/repro/kernels/ssd/kernel.py:23",
             jax_function="repro.kernels.ssd.kernel.ssd_fwd",
             shape="x (1, 512, 64, 64) bf16, dt (1, 512, 64), B/C (1, 512, 1, 64); "
                   "y and state fp32",
             launches=zamba_launches["ssd"],
             max_abs_err=max(r["max_abs_err"] for r in results["ssd_cases"]),
             kernel_ms=sd["ms"], ms=sd["ms"], ms_events=sd["ms_events"],
             plain_ms=sd["plain_ms"], bound_ms=sd["bound_ms"], bound_by=sd["bound_by"],
             bound_fma_ms=sd["bound_fma_ms"], library_ms=None, blocks=sd["blocks"],
             device_kernels_per_call=sd["device_kernels_per_call"],
             host_us_per_call=sd["host_us_per_call"],
             t2048={k: results["ssd_timing_2048"][k]
                    for k in ("ms", "plain_ms", "bound_ms", "bound_fma_ms", "blocks")}),
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
        per_path = {} if name == "rmsnorm_gated" else dict(
            train_launches=train_launches[name], train_shape="(4096, 960)",
            zamba_launches=zamba_launches[name], zamba_shapes="(8, 2048), (512, 2048)")
        kernels.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
            replaces=f"src/repro/kernels/rmsnorm/kernel.py:{line}",
            jax_function=("repro.models.ssm.mamba_block_fwd (skip, gate, rms_norm)"
                          if name == "rmsnorm_gated" else f"repro.kernels.rmsnorm.kernel.{name}"),
            shape=x_desc, path=t["path"],
            launches=(zamba_launches if name == "rmsnorm_gated" else launches)[name],
            **per_path,
            max_abs_err=max(r[f"{name}_max_abs_err"] for r in results["rmsnorm_cases"]
                            if f"{name}_max_abs_err" in r),
            kernel_ms=t["ms"], ms=t["ms"], ms_warm=t["ms_warm"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"],
            host_us_per_call=t["host_us"], plain_host_us_per_call=t["plain_host_us"],
            other_shapes={f"{n}x{d}": {k: u[k] for k in ("path", "ms", "ms_warm", "bound_ms",
                                                          "library_ms", "host_us")}
                          for (k_, n, d), u in rn.items() if k_ == name and (n, d) != shape}))
    decode_keys = ("kernel_launches_per_step", "device_ms_per_step", "device_idle_share",
                   "step_ms_unprofiled", "replay_host_ms_median",
                   "eager_kernel_launches_per_step", "eager_device_ms_per_step", "eager_step_ms")
    steps = {name: results[key] and {k: results[key][k] for k in keys}
             for name, key, keys in (
                 ("dense decode step", "profile", decode_keys),
                 ("zamba decode step", "zamba_profile", decode_keys),
                 ("zamba prefill 512", "zamba_prefill_profile", ("launches", "device_ms",
                                                                 "device_idle_share")))}
    results["step_profiles"] = steps
    log(f"profiled steps: {json.dumps(steps)}")
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
