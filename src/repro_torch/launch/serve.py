"""Serving launcher: one continuous-batching engine under a Poisson request
stream, on the card unless ``--device cpu``:

    python -m repro_torch.launch.serve --arch smollm-360m \\
        --requests 16 --rate 20 --max-slots 8 --kv-layout paged

    python -m repro_torch.launch.serve --arch zamba2-1.2b --requests 16

The weights are random, from ``--seed``.  ``--attn-impl`` picks the
family's kernels ("kernel": the flash CUDA kernel for prefill attention
and, for zamba2, the SSD scan and RMSNorm kernels; "chunked": plain
PyTorch) and ``--paged-attn`` the paged decode attention ("kernel" or
"ref").  zamba2 serves on the slotted layout only: ``--kv-layout paged``
is refused, and so are the paged-only scheduling flags.  On a CPU device
the kernel settings run the kernels' plain versions.

The paged engine's scheduling features, and the robustness knobs:

    python -m repro_torch.launch.serve --arch smollm-360m --smoke \
        --device cpu --kv-layout paged --prefill-chunk 8 --prefix-cache \
        --admission preempt --chaos-rate 0.05 --deadline-s 30

``--chaos-rate`` injects seeded faults (``--chaos-seed``) at every engine
fault site; faulted requests retry up to ``--max-retries`` times.

Speculative decoding, on any layout and family:

    python -m repro_torch.launch.serve --arch smollm-360m --smoke \
        --device cpu --spec-k 3 --spec-draft-alpha 0.15

The draft is the target's config with its weights mixed ``alpha`` toward
an init from ``--seed + 1`` (a stand-in for a trained draft); the summary
prints the acceptance rate and the tokens committed a lane a round.  The
router front-end arrives with a later slice.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.tree import map_tree
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.serve import (
    ENGINE_FAULT_SITES,
    EngineConfig,
    FaultPlan,
    ServeEngine,
)


def draft_mix(cfg, params, alpha: float, seed: int, device):
    """A same-architecture draft: ``(1 - alpha) * params + alpha *`` a fresh
    init from ``seed``.  Cheap to stand up, and it accepts often enough to
    show multi-token rounds; smaller ``alpha``, higher acceptance."""
    noise = registry.get_module(cfg).init(cfg, seed=seed, device=device)
    return map_tree(lambda p, n: (1 - alpha) * p + alpha * n, params, noise)


def run_stream(cfg, params, args, rng, device) -> ServeEngine:
    """Drive one engine with a Poisson arrival trace; print each request
    and a summary.  Returns the drained engine."""
    max_len = args.prompt_len + args.new_tokens + 8
    if args.kv_layout == "paged":
        max_len = -(-max_len // args.page_size) * args.page_size
    faults = None
    if args.chaos_rate > 0:
        faults = FaultPlan(args.chaos_seed + 1,
                           {site: args.chaos_rate for site in ENGINE_FAULT_SITES})
    spec = args.spec_k > 0
    draft_params = draft_mix(cfg, params, args.spec_draft_alpha, args.seed + 1,
                             device) if spec else None
    engine = ServeEngine(cfg, params, EngineConfig(
        max_slots=args.max_slots, max_len=max_len, seed=args.seed,
        kv_layout=args.kv_layout, page_size=args.page_size,
        num_blocks=args.num_blocks, paged_attn=args.paged_attn,
        prefill_chunk=args.prefill_chunk, prefix_cache=args.prefix_cache,
        admission=args.admission, max_retries=args.max_retries,
        spec_draft=cfg if spec else None, spec_k=args.spec_k),
        device=device, faults=faults, draft_params=draft_params)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    prompts = [rng.integers(0, cfg.vocab, rng.integers(2, args.prompt_len + 1))
               .astype(np.int32) for _ in range(args.requests)]
    budgets = rng.integers(1, args.new_tokens + 1, args.requests)

    t0 = time.perf_counter()
    i = 0
    while i < len(prompts) or engine.has_work():
        now = time.perf_counter() - t0
        while i < len(prompts) and arrivals[i] <= now:
            engine.submit(prompts[i], max_new_tokens=int(budgets[i]),
                          temperature=args.temperature, rid=i,
                          deadline_s=args.deadline_s)
            i += 1
        if not engine.step() and i < len(prompts):
            time.sleep(max(0.0, t0 + arrivals[i] - time.perf_counter()))
    wall = time.perf_counter() - t0

    tokens = 0
    for rid in range(len(prompts)):
        c = engine.completions[rid]
        tokens += len(c.tokens)
        lat = (f"{(c.finish_time - c.submit_time) / len(c.tokens) * 1e3:.1f}"
               " ms/tok" if c.tokens else "-")
        note = f"  [{c.error}]" if c.error else ""
        print(f"req{rid}: {c.status:9s} plen={c.prompt_len} "
              f"new={len(c.tokens)} {lat}  {c.tokens}{note}")
    s = engine.stats
    print(f"-- {tokens} tokens in {wall:.2f}s = {tokens / wall:.1f} tok/s on "
          f"{device} ({args.kv_layout}, attn {cfg.attn_impl}, paged_attn "
          f"{args.paged_attn})")
    print(f"-- prefills {s['prefills']} decode_steps {s['decode_steps']} "
          f"kv {s['kv_peak_used_bytes'] / 2**20:.2f} MiB peak used / "
          f"{s['kv_reserved_bytes'] / 2**20:.2f} MiB reserved  "
          f"status ok {s['status_ok']} failed {s['status_failed']} "
          f"timeout {s['status_timeout']} cancelled {s['status_cancelled']}")
    if args.kv_layout == "paged":
        print(f"-- prefill chunks {s['prefill_chunks']}  prefix hit_rate "
              f"{s['prefix_hit_rate']:.2f} cow {s['cow_copies']}  preempt "
              f"{s['preemptions']} resume {s['resumed']} replayed "
              f"{s['replayed_tokens']}")
    if spec:
        print(f"-- spec k={args.spec_k} alpha={args.spec_draft_alpha}: accept "
              f"{s['spec_acceptance_rate']:.2f} tok/round "
              f"{s['tokens_per_decode_dispatch']:.2f} rounds {s['spec_steps']}")
    if faults is not None:
        print(f"-- chaos[seed {args.chaos_seed}]: faults injected "
              f"{s['faults_injected']} detected {s['faults_detected']} retries "
              f"{s['retries']}")
    return engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=20.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-layout", choices=("slotted", "paged"),
                    default="slotted")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV block size (paged layout)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV pool size in blocks (paged; default worst case)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help=">0: admit prompts in chunks of this many tokens "
                         "interleaved with decode (paged only)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="refcounted shared-prefix block reuse (paged)")
    ap.add_argument("--admission", choices=("deficit", "preempt"),
                    default="deficit",
                    help="deficit: gate admission on worst-case block "
                         "commitments; preempt: run the pool near full and "
                         "evict-and-requeue the lowest-priority lane (paged)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request time to live from submission")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="retries of a faulted request before it ends 'failed'")
    ap.add_argument("--chaos-rate", type=float, default=0.0,
                    help=">0: seeded faults at every engine fault site with "
                         "this per-consult probability")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="FaultPlan seed (reproducible fault schedules)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help=">0: speculative decoding; a draft proposes this many "
                         "tokens a lane, verified in one target program; greedy "
                         "output is unchanged")
    ap.add_argument("--spec-draft-alpha", type=float, default=0.1,
                    help="draft weights = (1-a)*target + a*fresh init; smaller a, "
                         "higher acceptance")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without one)")
    ap.add_argument("--attn-impl", choices=("chunked", "kernel"),
                    default="kernel", help="prefill attention (and zamba2's "
                    "SSD scan and norms)")
    ap.add_argument("--paged-attn", choices=("ref", "kernel"),
                    default="kernel", help="paged decode attention")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    params = registry.get_module(cfg).init(cfg, seed=0, device=device)
    rng = np.random.default_rng(args.seed)
    return run_stream(cfg, params, args, rng, device)


if __name__ == "__main__":
    main()
