"""Serving launcher: continuous-batching engine replicas behind the router
front-end (``serve/router.py``) under a Poisson request stream, on the card
unless ``--device cpu``.  ``--replicas 1`` (the default) is one engine
behind the router's admission queue:

    python -m repro_torch.launch.serve --arch smollm-360m \\
        --requests 16 --rate 20 --max-slots 8 --kv-layout paged

    python -m repro_torch.launch.serve --arch zamba2-1.2b --requests 16

    python -m repro_torch.launch.serve --arch xlstm-1.3b --smoke --device cpu

    python -m repro_torch.launch.serve --arch whisper-tiny --smoke \
        --device cpu --engine static

Several replicas with crash failover, load shedding and a zero-downtime
drain (the last replica, after ``--drain-at`` completions); seeded replica
crashes and stalls with ``--replica-chaos-rate``:

    python -m repro_torch.launch.serve --arch smollm-360m --smoke \
        --device cpu --requests 32 --replicas 3 --drain-at 8 \
        --shed-queue-depth 16

``--trace-out PATH`` writes the request and engine timeline as a Chrome
trace (``chrome://tracing``, ``ui.perfetto.dev``); ``--flightrec-dir DIR``
arms the flight recorder (a failed invariant sweep dumps the last events
there).  The summary prints each replica's line, the statuses, failovers
and migrations, and the latency by status from the merged histograms.

The weights are random, from ``--seed``.  ``--attn-impl`` picks the
family's kernels ("kernel": the flash CUDA kernel for prefill attention,
the RMSNorm kernels and, for zamba2, the SSD scan; "chunked": plain
PyTorch) and ``--paged-attn`` the paged decode attention ("kernel" or
"ref").  zamba2 and xlstm-1.3b serve on the slotted layout only:
``--kv-layout paged`` is refused, and so are the paged-only scheduling
flags.  whisper-tiny and internvl2-76b feed per-request frontend inputs
the engine does not carry: they serve on the static loop (``--engine
static``; the continuous default falls back to it, as the reference's
launcher does), with frames or patch embeddings drawn from ``--seed``.
On a CPU device the kernel settings run the kernels' plain versions.

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
prints the acceptance rate and the tokens committed a lane a round.

The static batch loop (one fixed batch to the full budget):

    python -m repro_torch.launch.serve --arch smollm-360m --smoke \
        --device cpu --engine static --batch 4

``--mesh`` takes the reference's choices: ``single`` (the default; one
worker, no process group: the one-device engine), ``local`` (the ranks
``torchrun`` describes as ``(world, 1)``, a data axis only; NCCL on the
card, gloo with ``--device cpu``) and ``production`` (``(16, 16)`` over
256 ranks).  Every rank runs the same schedule on rank 0's clock and
rank 0 prints; the weights are each rank's shards, drawn directly
(``optim.fsdp.init_shards``), and the summary names the mesh and the KV
bytes a rank holds: its share of the lanes (slotted, ``--max-slots`` over
the data axes where it divides) or of the pool's blocks (paged, over the
data axes).  On a mesh the slotted layout's ``max_len`` is rounded up to
a multiple of the ranks each lane's positions split over (the model
size, or every rank where the lanes do not divide).  ``--spec-k`` (the
draft mixed from this rank's shards, the same weights as the one-device
launcher's), ``--replicas`` and ``--drain-at`` (the drain migrates each
request through the engines' export and import) run there too:

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch gemma2-27b --smoke --device cpu --mesh local

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch gemma2-27b --smoke --device cpu --mesh local --kv-layout paged \
        --replicas 2 --drain-at 2 --spec-k 2
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.tree import map_tree
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import local_mesh, make_production_mesh, single_mesh
from repro_torch.models import registry
from repro_torch.obs import Observer, merged_histogram, to_chrome_trace, validate
from repro_torch.serve import (
    ENGINE_FAULT_SITES,
    REPLICA_FAULT_SITES,
    STATUSES,
    EngineConfig,
    FaultPlan,
    Router,
    RouterConfig,
    ServeConfig,
    generate_static,
)
from repro_torch.serve.engine import serve_shard_layout

MESHES = ("single", "local", "production")


def draft_mix(cfg, params, alpha: float, seed: int, device, layout=None):
    """A same-architecture draft: ``(1 - alpha) * params + alpha *`` a fresh
    init from ``seed``.  Cheap to stand up, and it accepts often enough to
    show multi-token rounds; smaller ``alpha``, higher acceptance.  On a
    mesh (``layout`` the weights' shard layout, ``params`` this rank's
    shards) the init is this rank's shards of that same whole init
    (``optim.fsdp.init_shards``), so the mix is this rank's shards of the
    whole weights' mix, element for element."""
    if layout is None:
        noise = registry.get_module(cfg).init(cfg, seed=seed, device=device)
    else:
        from repro_torch.optim.fsdp import init_shards

        noise = init_shards(cfg, layout, seed, device)
    return map_tree(lambda p, n: (1 - alpha) * p + alpha * n, params, noise)


def run_static(cfg, params, args, rng, device, mesh=None) -> np.ndarray:
    """One fixed batch of random prompts to the full budget through
    ``generate_static``, with the family's frontend input drawn from
    ``rng`` after the prompts (vlm patch embeddings, audio frames) as the
    reference's launcher draws them; prints each row and returns them."""
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    extra = None
    if cfg.family == "vlm":
        extra = rng.normal(size=(args.batch, cfg.frontend_tokens,
                                 cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "audio":
        extra = rng.normal(size=(args.batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    out = generate_static(cfg, params, prompts,
                          ServeConfig(max_new_tokens=args.new_tokens,
                                      temperature=args.temperature, seed=args.seed),
                          extra=extra, device=device, mesh=mesh)
    for i, row in enumerate(out):
        print(f"seq{i}: {row.tolist()}")
    return out


def print_latency_summary(router) -> None:
    """Per-status latency table: p50/p99 time to first token and
    per-token latency, one row per terminal status that occurred, from the
    ``ttft_ms_<status>``/``tpot_ms_<status>`` histograms merged across the
    router's registry and every replica's."""
    regs = [router.obs.metrics] + [h.engine.obs.metrics for h in router.replicas]
    rs = router.stats
    print("-- latency by status (p50/p99 ms):")
    for status in STATUSES:
        n = rs.get(f"status_{status}", 0)
        if not n:
            continue
        ttft = merged_histogram(f"ttft_ms_{status}", regs)
        tpot = merged_histogram(f"tpot_ms_{status}", regs)
        fmt = lambda h: (f"{h.quantile(0.50):8.1f}/{h.quantile(0.99):8.1f}"
                         if h.count else "       -/       -")
        print(f"   {status:9s} n={n:4d}  ttft {fmt(ttft)}  per-token {fmt(tpot)}")


def kv_share(engine) -> str:
    """On a mesh, the rank's part of the KV cache: its bytes and its lanes
    (slotted) or blocks (paged) beside the whole."""
    if engine.mesh is None:
        return ""
    if engine.shards is None:               # a family served whole on every rank
        return f" ({engine.kv_reserved_bytes} bytes: the whole cache)"
    k = engine.state["cache"]["k"]
    if engine.paged:
        part = f"{k.shape[-4]} of {engine._num_blocks} blocks"
    else:
        part = f"{k.shape[-4]} of {engine.econ.max_slots} lanes x {k.shape[-3]} positions"
    return f" ({engine.kv_reserved_bytes} bytes: {part})"


def run_stream(cfg, params, args, rng, device, mesh=None) -> Router:
    """Drive ``--replicas`` engines behind the router with a Poisson
    arrival trace; print each request and a summary.  Returns the drained
    router.  On a ``mesh`` the arrivals read the router's clock (rank 0's
    on every rank)."""
    if args.drain_at is not None and args.replicas < 2:
        raise SystemExit("--drain-at needs --replicas >= 2 (draining the only "
                         "replica leaves nothing to migrate onto)")
    max_len = args.prompt_len + args.new_tokens + 8
    if args.kv_layout == "paged":
        max_len = -(-max_len // args.page_size) * args.page_size
    elif mesh is not None:
        from repro_torch.models.attention import DecodeSharding

        m = DecodeSharding.choose(mesh, args.max_slots).seq_ranks
        max_len = -(-max_len // m) * m
    faults = None
    if args.replica_chaos_rate > 0:
        faults = FaultPlan(args.chaos_seed,
                           {site: args.replica_chaos_rate for site in REPLICA_FAULT_SITES})
    engine_faults = None
    if args.chaos_rate > 0:
        engine_faults = [FaultPlan(args.chaos_seed + 1 + i,
                                   {site: args.chaos_rate for site in ENGINE_FAULT_SITES})
                         for i in range(args.replicas)]
    spec = args.spec_k > 0
    draft_params = draft_mix(cfg, params, args.spec_draft_alpha, args.seed + 1, device,
                             serve_shard_layout(cfg, mesh)) if spec else None
    obs = None
    if args.trace_out or args.flightrec_dir:
        # the tracer and the recorder's ring (a failed invariant sweep
        # dumps to --flightrec-dir); the metrics are on either way
        obs = Observer.full(dump_dir=args.flightrec_dir or ".", name="router")
    router = Router(cfg, params, EngineConfig(
        max_slots=args.max_slots, max_len=max_len, seed=args.seed,
        kv_layout=args.kv_layout, page_size=args.page_size,
        num_blocks=args.num_blocks, paged_attn=args.paged_attn,
        prefill_chunk=args.prefill_chunk, prefix_cache=args.prefix_cache,
        admission=args.admission, max_retries=args.max_retries,
        spec_draft=cfg if spec else None, spec_k=args.spec_k),
        RouterConfig(replicas=args.replicas, shed_queue_depth=args.shed_queue_depth),
        device=device, faults=faults, engine_faults=engine_faults, obs=obs,
        draft_params=draft_params, mesh=mesh)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    prompts = [rng.integers(0, cfg.vocab, rng.integers(2, args.prompt_len + 1))
               .astype(np.int32) for _ in range(args.requests)]
    budgets = rng.integers(1, args.new_tokens + 1, args.requests)

    clock = router.clock
    t0 = clock()
    i = 0
    drained = False
    while i < len(prompts) or router.has_work():
        now = clock() - t0
        while i < len(prompts) and arrivals[i] <= now:
            router.submit(prompts[i], max_new_tokens=int(budgets[i]),
                          temperature=args.temperature, rid=i,
                          deadline_s=args.deadline_s)
            i += 1
        if args.drain_at is not None and not drained \
                and len(router.completions) >= args.drain_at:
            idx = args.replicas - 1
            moved = router.drain(idx)
            print(f"-- drained replica {idx}: migrated {moved} in-flight requests "
                  "to survivors")
            drained = True
        if not router.step() and i < len(prompts):
            time.sleep(max(0.0, t0 + arrivals[i] - clock()))
    wall = clock() - t0

    tokens = 0
    for rid in range(len(prompts)):
        c = router.completions[rid]
        tokens += len(c.tokens)
        lat = (f"{(c.finish_time - c.submit_time) / len(c.tokens) * 1e3:.1f}"
               " ms/tok" if c.tokens else "-")
        note = f"  [{c.error}]" if c.error else ""
        where = router.placements.get(rid)
        place = f"r{where}" if where is not None else "--"
        print(f"req{rid}: {c.status:9s} {place} plen={c.prompt_len} "
              f"new={len(c.tokens)} {lat}  {c.tokens}{note}")
    where = "" if mesh is None else f" of mesh {mesh.describe()}"
    print(f"-- {tokens} tokens in {wall:.2f}s = {tokens / wall:.1f} tok/s across "
          f"{args.replicas} replica(s) on {device}{where} ({args.kv_layout}, attn "
          f"{cfg.attn_impl}, paged_attn {args.paged_attn})")
    for h in router.replicas:
        s = h.engine.stats
        line = (f"-- replica {h.idx} [{h.state}] state[{s['state_kind']}/{args.kv_layout}]: "
                f"{s['kv_peak_used_bytes'] / 2**20:.2f} MiB peak used / "
                f"{h.engine.kv_reserved_bytes / 2**20:.2f} MiB reserved"
                f"{'' if mesh is None else ' a rank'}{kv_share(h.engine)}  "
                f"prefills {s['prefills']} decode_steps {s['decode_steps']}")
        if args.kv_layout == "paged":
            line += (f"  chunks {s['prefill_chunks']} prefix hit_rate "
                     f"{s['prefix_hit_rate']:.2f} cow {s['cow_copies']} preempt "
                     f"{s['preemptions']} resume {s['resumed']} replayed "
                     f"{s['replayed_tokens']}")
        if spec:
            line += (f"  spec k={args.spec_k} alpha={args.spec_draft_alpha}: accept "
                     f"{s['spec_acceptance_rate']:.2f} tok/round "
                     f"{s['tokens_per_decode_dispatch']:.2f} rounds {s['spec_steps']}")
        print(line)
    rs = router.stats
    print(f"-- status: ok {rs['status_ok']} timeout {rs['status_timeout']} "
          f"cancelled {rs['status_cancelled']} failed {rs['status_failed']} "
          f"shed {rs['status_shed']}  failovers {rs['failovers']} "
          f"migrated {rs['migrated']}")
    if faults is not None or engine_faults is not None:
        eng = [h.engine.stats for h in router.replicas]
        print(f"-- chaos[seed {args.chaos_seed}]: engine faults injected "
              f"{sum(s['faults_injected'] for s in eng)} detected "
              f"{sum(s['faults_detected'] for s in eng)} retries "
              f"{sum(s['retries'] for s in eng)}  replicas dead {rs['replicas_dead']} "
              f"stalls {rs['stalls_injected']}/{rs['stalls_detected']} "
              "(injected/detected)")
    print_latency_summary(router)
    if args.trace_out:
        ev = router.obs.tracer.events
        info = validate(ev)
        to_chrome_trace(ev, args.trace_out)
        print(f"-- trace: {info['events']} events / {info['spans']} spans / "
              f"{info['requests']} requests -> {args.trace_out} "
              "(load in chrome://tracing or ui.perfetto.dev)")
    return router


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", choices=("continuous", "static"), default="continuous")
    ap.add_argument("--batch", type=int, default=4,
                    help="rows of the static loop's batch (--engine static)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=20.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    # the router front-end
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the router (one program cache "
                         "and one weight copy; crash failover between them)")
    ap.add_argument("--shed-queue-depth", type=int, default=64,
                    help="bounded admission queue: a submission beyond this "
                         "depth ends with status 'shed'")
    ap.add_argument("--drain-at", type=int, default=None,
                    help="after this many completions, drain the last replica "
                         "(zero-downtime migration); needs --replicas >= 2")
    ap.add_argument("--replica-chaos-rate", type=float, default=0.0,
                    help=">0: seeded replica crashes and stalls at this per-tick "
                         "probability (router failover; use --replicas >= 2)")
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
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the request and engine timeline as a Chrome trace "
                         "(chrome://tracing, ui.perfetto.dev)")
    ap.add_argument("--flightrec-dir", default=None, metavar="DIR",
                    help="arm the flight recorder: a failed invariant sweep dumps "
                         "the last events as flightrec_*.json here")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without one)")
    ap.add_argument("--mesh", choices=MESHES, default="single",
                    help="single: one worker; local: the torchrun ranks as (world, 1); "
                         "production: (16, 16) over 256 ranks")
    ap.add_argument("--attn-impl", choices=("chunked", "kernel"),
                    default="kernel", help="prefill attention and the norms "
                    "(and zamba2's SSD scan)")
    ap.add_argument("--paged-attn", choices=("ref", "kernel"),
                    default="kernel", help="paged decode attention")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    mesh = {"single": single_mesh, "local": local_mesh,
            "production": make_production_mesh}[args.mesh](device=device)
    try:
        if mesh.pg is None:
            mesh = None                     # one worker: the one-device engine
        else:
            device = mesh.device
        with contextlib.redirect_stdout(io.StringIO()) if mesh is not None and mesh.rank \
                else contextlib.nullcontext():
            return _serve(cfg, args, device, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _serve(cfg, args, device, mesh):
    """Draw the weights (this rank's shards on a mesh) and run the stream
    or the static loop."""
    from repro_torch.optim.fsdp import init_shards

    lay = serve_shard_layout(cfg, mesh)
    if lay is not None:
        params = init_shards(cfg, lay, 0, device)
    else:
        params = registry.get_module(cfg).init(cfg, seed=0, device=device)
    rng = np.random.default_rng(args.seed)
    if args.engine == "continuous" and registry.supports_slot_serving(cfg):
        return run_stream(cfg, params, args, rng, device, mesh)
    if args.engine == "continuous":
        print(f"# family {cfg.family!r} has no slot-serving support; falling back to "
              "the static loop")
    return run_static(cfg, params, args, rng, device, mesh)


if __name__ == "__main__":
    main()
