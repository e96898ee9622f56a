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
is refused.  On a CPU device the kernel settings run the kernels' plain
versions.  The router front-end arrives with a later slice.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.serve import EngineConfig, ServeEngine


def run_stream(cfg, params, args, rng, device) -> ServeEngine:
    """Drive one engine with a Poisson arrival trace; print each request
    and a summary.  Returns the drained engine."""
    max_len = args.prompt_len + args.new_tokens + 8
    if args.kv_layout == "paged":
        max_len = -(-max_len // args.page_size) * args.page_size
    engine = ServeEngine(cfg, params, EngineConfig(
        max_slots=args.max_slots, max_len=max_len, seed=args.seed,
        kv_layout=args.kv_layout, page_size=args.page_size,
        num_blocks=args.num_blocks, paged_attn=args.paged_attn), device=device)
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
                          temperature=args.temperature, rid=i)
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
          f"status ok {s['status_ok']} failed {s['status_failed']}")
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
