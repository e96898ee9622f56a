#!/usr/bin/env python3
"""How ``torch.profiler`` records the dense decode graph on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/profiler_window_study.py

A full-width ``smollm-360m`` engine (paged, both attention kernels, bf16,
seed-0 weights, 8 busy lanes, the decode step a CUDA-graph replay) takes
4 profiler windows of 1, 5 and 25 decode steps (~1,700, ~8,500 and
~42,500 launches) in each of five ways of opening the window, and phase
3j's spec engine (``chip_smoke.SPEC_K`` 3, the same draft) takes 10
windows of one round (~14,440 launches) in the first two:

* ``old``: one window around the steps (``chip_smoke.profiled``);
* ``old_sleep``: a 2M-cycle ``torch.cuda._sleep`` first (filtered out);
* ``old_sync_first``: a synchronize and 50 ms of host sleep first;
* ``cuda_only``: device activity alone;
* ``sched``: a ``schedule(wait=0, warmup=1, active=1)`` with one small
  device op as the warm-up step (last: windows opened after it can
  record nothing).

For each window it prints the launches a step, the port's kernels a step
(129 on every complete decode window: 32 paged split kernels, 32
combines, 33 ``rmsnorm``, 32 ``rmsnorm_add``) and the device ms a step,
beside the card's name and power limit, and writes them to
``chiprun_out/profiler_window_study.json``.  A window that records fewer port
kernels dropped records; one that records more device time than the
unprofiled step takes instruments each kernel.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    if not torch.cuda.is_available():
        print("profiler_window_study: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import lm
    from repro_torch.serve import EngineConfig, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    _build.build_all()
    for name in _build.sources():
        _build.load(name)
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("smollm-360m"), attn_impl="kernel")
    params = lm.init(cfg, seed=0, device=dev)
    ec = EngineConfig(max_slots=8, max_len=1024, kv_layout="paged", page_size=16,
                      paged_attn="kernel")

    def busy(ec, **kw):
        eng = ServeEngine(cfg, params, ec, device=dev, **kw)
        for p, _ in cs.requests(cfg.vocab)[:8]:
            eng.submit(p[:64], max_new_tokens=900)
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        return eng

    def old(run):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        return [e for e in prof.key_averages() if e.device_type.name == "CUDA"]

    def old_sleep(run):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(2_000_000)
            run()
            torch.cuda.synchronize()
        return [e for e in prof.key_averages() if e.device_type.name == "CUDA"
                and "spin" not in e.key and "sleep" not in e.key.lower()]

    def old_sync_first(run):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(0.05)
            run()
            torch.cuda.synchronize()
        return [e for e in prof.key_averages() if e.device_type.name == "CUDA"]

    def cuda_only(run):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        return [e for e in prof.key_averages() if e.device_type.name == "CUDA"]

    def sched(run):
        ev = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda prof: ev.extend(prof.key_averages())) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            prof.step()
            run()
            torch.cuda.synchronize()
            prof.step()
        return [e for e in ev if e.device_type.name == "CUDA"]

    def windows(eng, fn, steps, n):
        rows = []
        for _ in range(n):
            kernels = fn(lambda: [eng.step() for _ in range(steps)])
            port = sum(e.count for e in kernels if cs.PORT_KERNEL.match(e.key))
            rows.append(dict(launches=sum(e.count for e in kernels) / steps,
                             port=port / steps,
                             device_ms=sum(e.self_device_time_total for e in kernels)
                             / 1e3 / steps))
        return rows

    out = {}
    eng = busy(ec)
    spec = busy(dataclasses.replace(ec, spec_draft=cfg, spec_k=cs.SPEC_K),
                draft_params=cs.draft_params_for(cfg, params, cs.DRAFT_ALPHA, dev))
    for name, fn in (("old", old), ("cuda_only", cuda_only), ("old_sleep", old_sleep),
                     ("old_sync_first", old_sync_first)):
        for steps in (1, 5, 25):
            out[f"{name}_{steps}"] = windows(eng, fn, steps, 4)
            print(name, steps, json.dumps(out[f"{name}_{steps}"]), flush=True)
        if name in ("old", "cuda_only"):
            out[f"{name}_spec_round"] = windows(spec, fn, 1, 10)
            print(name, "spec round", json.dumps(out[f"{name}_spec_round"]), flush=True)
    # last: a window opened after these can record nothing
    for steps in (5, 25):
        out[f"sched_{steps}"] = windows(eng, sched, steps, 4)
        print("sched", steps, json.dumps(out[f"sched_{steps}"]), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "profiler_window_study.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
