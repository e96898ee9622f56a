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
   and fp32 (3e-5: the same fp32 arithmetic in another summation order),
   and time both with CUDA events (plus SDPA as the flash yardstick).
3. Drive the port's main path at full ``smollm-360m`` width with random
   weights from seed 0: a paged ``ServeEngine`` with both kernels serves
   16 greedy requests (prompts 16-512, budgets 32-64).  The launch counts
   must equal 32 x prefills (flash) and 32 x decode steps (paged); the
   kernel path's prefill and first decode-step logits must agree with the
   ``chunked``/``ref`` path's (fp32 with TF32 off, and bf16); a few
   requests also run on the slotted layout.
4. Print the card's name and power limit, one ``{"kernels": [...]}`` line
   and, last, ``{"ok": true, "device": {...}}``.  Details go to
   ``chiprun_out/chip_smoke/results.json``.

It imports nothing of JAX or of the reference package, and exits non-zero
without a CUDA card or outside the repository.
"""
from __future__ import annotations

import dataclasses
import json
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

N_LAYERS = 32
PAGE = 16
MAX_LEN = 1024
MAX_SLOTS = 8


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


def max_err(torch, got, want, dt: str) -> float:
    """Max |got - want|; raises unless |got - want| <= atol + rtol |want|."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    tol = TOL[dt]["atol"] + TOL[dt]["rtol"] * w.abs()
    if not bool(torch.isfinite(g).all()) or bool((err > tol).any()):
        raise AssertionError(f"max error {err.max().item():.3e} over tolerance {TOL[dt]}")
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
            if dt == "bfloat16" and set(kw) == {"causal"}:
                pos = torch.arange(S)
                ok = pos[None, :] <= pos[:, None] if kw["causal"] else torch.ones(S, S, dtype=torch.bool)
                pairs = int(ok.sum())
                esize = q.element_size()
                nbytes = esize * (2 * S * H * D + 2 * S * Hk * D)
                row["bound_ms"], row["bound_by"] = bound(4 * D * H * pairs, nbytes, dt)
                iters = 200 if S <= 512 else 50
                row["ms"] = time_ms(torch, lambda: flash_attention(q, k, v, **kw), iters)
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                row["plain_ms"] = time_ms(torch, lambda: attention_ref(qt, kt, vt, **kw), iters)
                qc, kc, vc = (x.contiguous() for x in (qt, kt, vt))
                row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qc, kc, vc, is_causal=kw["causal"], enable_gqa=True), iters)
            rows.append(row)
            log(f"flash {json.dumps(row)}")
    results["flash_cases"] = rows


def paged_inputs(torch, dev, dt, *, layers=1, B=MAX_SLOTS, Hk=5, rep=3, D=64, nb=MAX_LEN // PAGE,
                 nulled=(6, 7), seed=2):
    """Pools for ``layers`` layers, ragged lengths 1..1023 and a random
    block mapping; lanes in ``nulled`` are stale (table rows all sink)."""
    rng = np.random.default_rng(seed)
    NB = B * nb + 1
    lengths = rng.integers(1, nb * PAGE, B).astype(np.int32)
    lengths[0], lengths[1] = 1, nb * PAGE - 1
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
    from repro_torch.kernels.paged_attention.ops import paged_attention
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
    # timing at the decode step's shape: 8 lanes, 5 KV heads x 3 queries,
    # bs 16, bf16; 8 layers of pools (84 MB, over the 50 MB L2) walked in
    # turn, so each launch finds its pool cold, as a layer's does in decode
    dt = "bfloat16"
    L = 8
    q, kp, vp, lengths, tables = paged_inputs(torch, dev, dt, layers=L)
    B, Hk, rep, D = q.shape
    n = lengths.long() + 1                       # positions [0, length] per lane
    esize = q.element_size()
    read = pool_positions_read(lengths.cpu().numpy(), tables.cpu().numpy(), PAGE)
    nbytes = (read * Hk * D * 2 + 2 * q.numel()) * esize \
        + 4 * (lengths.numel() + tables.numel())
    row = dict(dtype=dt, lanes=B, lengths=lengths.tolist(), nulled_lanes=[6, 7],
               pool_positions_read=read, positions_attended=int(n.sum()))
    row["bound_ms"], row["bound_by"] = bound(4 * D * rep * Hk * int(n.sum()), nbytes, dt)
    i = [0]

    def step(fn):
        def go():
            layer = i[0] % L
            i[0] += 1
            return fn(q, kp[layer], vp[layer], lengths, tables)
        return go

    row["ms"] = time_ms(torch, step(paged_attention), 400)
    row["plain_ms"] = time_ms(torch, step(paged_attention_ref), 100)
    row["library_ms"] = None
    log(f"paged timing {json.dumps(row)}")
    results["paged_cases"] = rows
    results["paged_timing"] = row


# ---------------------------------------------------------------------------
# Phase 3: the main path at full width
# ---------------------------------------------------------------------------


def requests(vocab: int, n: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    plens = rng.integers(16, 513, n)
    budgets = rng.integers(32, 65, n)
    return [(rng.integers(0, vocab, int(p)).astype(np.int32), int(b))
            for p, b in zip(plens, budgets)]


def serve(torch, cfg, params, reqs, engine_cfg, dev):
    """Submit every request at once and drain; returns (engine, per-step
    host times in ms, whether each step ran a prefill, wall seconds)."""
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, engine_cfg, device=dev)
    rids = [eng.submit(p, max_new_tokens=b) for p, b in reqs]
    steps, prefilled = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.has_work():
        before = eng.counters["prefills"]
        t = time.perf_counter()
        eng.step()
        steps.append((time.perf_counter() - t) * 1e3)
        prefilled.append(eng.counters["prefills"] != before)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, rids, steps, prefilled, wall


def main_path(torch, dev, results):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.models import lm
    from repro_torch.serve import EngineConfig

    base = get_config("smollm-360m")
    assert base.n_layers == N_LAYERS
    cfg = dataclasses.replace(base, attn_impl="kernel")
    params = lm.init(cfg, seed=0, device=dev)
    reqs = requests(cfg.vocab)
    ec = EngineConfig(max_slots=MAX_SLOTS, max_len=MAX_LEN, kv_layout="paged",
                      page_size=PAGE, paged_attn="kernel")
    # warm-up (cuBLAS handles, allocator) on two short requests, then the
    # measured run with the launch counts set to 0 just before it
    serve(torch, cfg, params, [(reqs[0][0][:16], 4), (reqs[1][0][:32], 4)], ec, dev)
    flash_attention.launches = 0
    paged_attention.launches = 0
    eng, rids, steps, prefilled, wall = serve(torch, cfg, params, reqs, ec, dev)
    launches = {"flash_attention": flash_attention.launches,
                "paged_attention": paged_attention.launches}
    st = eng.stats
    eng.check_invariants()
    comps = [eng.completions[r] for r in rids]
    bad = [(c.rid, c.status, len(c.tokens), b) for c, (_, b) in zip(comps, reqs)
           if c.status != "ok" or len(c.tokens) != b]
    assert not bad, f"requests not served in full: {bad}"
    assert launches["flash_attention"] == N_LAYERS * st["prefills"] > 0, (launches, st)
    assert launches["paged_attention"] == N_LAYERS * st["decode_steps"] > 0, (launches, st)
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
               max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches)
    log(f"main path (paged, kernels): {tokens} tokens in {wall:.3f} s = "
        f"{tokens / wall:.1f} tok/s; decode step median {e2e['decode_step_ms_median']:.2f} ms "
        f"over {len(decode_only)} decode-only steps; launches {launches}")

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

    # a few requests on the slotted layout: the flash kernel still runs
    flash_attention.launches = 0
    sl_eng, sl_rids, _, _, _ = serve(
        torch, cfg, params, [(p[:64], 8) for p, _ in reqs[:4]],
        dataclasses.replace(ec, kv_layout="slotted", max_slots=4, max_len=128), dev)
    sl_eng.check_invariants()
    assert all(sl_eng.completions[r].status == "ok" and len(sl_eng.completions[r].tokens) == 8
               for r in sl_rids)
    assert flash_attention.launches == N_LAYERS * sl_eng.stats["prefills"] == 4 * N_LAYERS
    e2e["slotted"] = dict(requests=4, launches_flash=flash_attention.launches)
    results["main_path"] = e2e
    results["logits"] = logit_agreement(torch, dev, base, params, reqs[2][0])
    return launches


def agreement(a, b) -> dict:
    """Greedy streams a vs b: requests identical, share of equal tokens."""
    pos = [np.mean(np.array(x) == np.array(y)) for x, y in zip(a, b)]
    return dict(identical_requests=sum(x == y for x, y in zip(a, b)), requests=len(a),
                token_agreement=float(np.mean(pos)))


def profile_decode(torch, cfg, params, reqs, ec, dev, steps: int = 5):
    """Device time of a few decode steps with all 8 lanes busy, by kernel,
    from ``torch.profiler``; the idle share is taken against the step
    time of the same steps run again unprofiled."""
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
    if not kernels:
        log("profile: torch.profiler recorded no device activity (not measured)")
        return None
    total_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    out = dict(steps=steps, lanes=MAX_SLOTS, step_ms_unprofiled=step_ms,
               device_ms_per_step=total_us / 1e3 / steps,
               device_idle_share=1 - total_us / 1e3 / steps / step_ms,
               kernel_launches_per_step=sum(e.count for e in kernels) / steps,
               top=[dict(name=e.key[:80], calls_per_step=e.count / steps,
                         ms_per_step=e.self_device_time_total / 1e3 / steps)
                    for e in top])
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
    t = time.perf_counter()
    logs = _build.build_all()
    for name in _build.sources():
        _build.load(name)
    results["build_s"] = time.perf_counter() - t
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line:
                log(f"ptxas[{name}]: {line.strip()}")
    log(f"built {sorted(_build.sources())} in {results['build_s']:.1f} s")

    check_flash(torch, dev, results)
    check_paged(torch, dev, results)
    launches = main_path(torch, dev, results)
    results["seconds"] = time.perf_counter() - t_start

    fl = next(r for r in results["flash_cases"] if r["S"] == 512 and "ms" in r)
    pg = results["paged_timing"]
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:27",
             jax_function="repro.kernels.flash_attention.kernel.flash_attention_fwd",
             shape="q (1, 512, 15, 64), k/v (1, 512, 5, 64), bf16, causal",
             launches=launches["flash_attention"], max_abs_err=fl["max_abs_err"],
             ms=fl["ms"], plain_ms=fl["plain_ms"],
             bound_ms=fl["bound_ms"], bound_by=fl["bound_by"], library_ms=fl["library_ms"]),
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention/kernel.py:30",
             jax_function="repro.kernels.paged_attention.kernel.paged_attention_fwd",
             shape="q (8, 5, 3, 64), pools (513, 16, 5, 64), bf16, lengths 1..1023",
             launches=launches["paged_attention"],
             max_abs_err=results["paged_cases"][0]["max_abs_err"],   # bf16, no mask
             ms=pg["ms"], plain_ms=pg["plain_ms"],
             bound_ms=pg["bound_ms"], bound_by=pg["bound_by"], library_ms=None),
    ]
    results["kernels"] = kernels
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "results.json").write_text(json.dumps(results, indent=1))
    log(f"chip_smoke: all phases passed in {results['seconds']:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
