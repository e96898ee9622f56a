"""Phase 14 (qwen3-moe-30b-a3b trained at full width, 2 layers) and, where
a tree has it, phase 14b (zamba2-1.2b's first segment under FSDP) of
``chip_smoke.py``, run from several checkouts in one call to the card, each
in a process of its own and in the order given, so that two trees are
compared on the same card (parent, change, change, parent):

    python3 scripts/fsdp_step_study.py parent=build/parent change=. \\
        change=. parent=build/parent

Each tree builds its own kernels and runs its own ``chip_smoke`` phase
functions with their gates.  Per run the script prints the card's name and
power limit and one JSON line: the step's host times (median, p90),
tokens/s, the profiled step's device-busy ms and idle share, kernel
launches, the collectives counted, peak memory and, under FSDP, step 1's
agreement with the replicated rules; where the tree's phase 14 has it, the
same figures of its third run on a ``(1, 1)`` mesh.  The runs' logs and the summary go to
``chiprun_out/fsdp_step_study/``.  Needs one card.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]
OUT = HERE / "chiprun_out" / "fsdp_step_study"
PHASES = (("14", "moe_train_path", "moe_train"), ("14b", "zamba_fsdp_path", "zamba_fsdp_train"))


def one(tree: pathlib.Path) -> dict:
    """Run the tree's phases in this process; returns the summary."""
    os.chdir(tree)
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    _build.build_all()
    for name in _build.sources():
        _build.load(name)
    out = {"build_s": time.perf_counter() - t}
    dev, res = torch.device("cuda"), {}
    for phase, fn, key in PHASES:
        if not hasattr(cs, fn):
            continue
        t = time.perf_counter()
        getattr(cs, fn)(torch, dev, res)
        r, prof = res[key], res[key].get("profile") or {}
        s1 = r.get("step1_rules") or {}
        out[phase] = dict(
            seconds=time.perf_counter() - t, step_ms=r.get("step_ms"),
            step_ms_median=r.get("step_ms_median"), step_ms_p90=r.get("step_ms_p90"),
            tokens_per_s=r.get("tokens_per_s"),
            max_memory_allocated=r.get("max_memory_allocated"),
            collectives=r.get("collectives"),
            step_ms_unprofiled=prof.get("step_ms_unprofiled"),
            device_busy_ms=prof.get("device_busy_ms"),
            device_idle_share=prof.get("device_idle_share"),
            kernel_launches=prof.get("kernel_launches"),
            step1_rules={k: s1.get(k) for k in ("bitwise", "params_digest_equal",
                                                 "max_abs_diff")} if s1 else None)
        mesh = s1.get("mesh")
        if mesh:
            mp = mesh.get("profile") or {}
            out[phase]["mesh"] = dict(
                step_ms=mesh["step_ms"], step_ms_median=mesh["step_ms_median"],
                collectives=mesh["collectives"], step1_bitwise=mesh["step1_bitwise"],
                params_digest_equal=mesh["params_digest_equal"],
                **{k: mp.get(k) for k in ("step_ms_unprofiled", "device_busy_ms",
                                          "device_idle_share", "kernel_launches")})
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print("STUDY " + json.dumps(one(pathlib.Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    runs, failed = [], False
    for i, arg in enumerate(argv):
        label, _, path = arg.rpartition("=")
        label = label or path
        log = OUT / f"{i}-{label.replace('/', '_')}.log"
        with open(log, "w") as f:
            p = subprocess.run([sys.executable, __file__, "--one", path], stdout=f,
                               stderr=subprocess.STDOUT, text=True)
        lines = [l for l in log.read_text().splitlines() if l.startswith("STUDY ")]
        if p.returncode or not lines:
            failed = True
            print(f"{label}: failed (exit {p.returncode}), see {log}", flush=True)
            continue
        run = dict(label=label, tree=path, **json.loads(lines[-1][6:]))
        runs.append(run)
        print(json.dumps(run), flush=True)
    (OUT / "summary.json").write_text(json.dumps(dict(card=smi, runs=runs), indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
