#!/usr/bin/env python3
"""Device-time study of the port's RMSNorm kernels on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/rmsnorm_kernel_study.py --parent DIR

``DIR`` is an unpacked older checkout of this repository (``git archive
<commit>`` under the git-ignored ``build/``) whose ``rmsnorm.cu`` has the
first design's entries (contiguous rows, one block a row, two passes).
The study

1. builds that source with this checkout's nvcc flags and times its
   ``rmsnorm`` and ``rmsnorm_add`` beside this checkout's at
   ``chip_smoke.RMSNORM_SHAPES`` in bf16, by device time per call
   (``torch.profiler``), L2-cold and warm, in turns parent, change,
   change, parent, each checked against the plain version at
   ``chip_smoke.TOL`` first;
2. profiles, in a fresh process per tree (parent, change, change,
   parent), a full-width dense ``smollm-360m`` decode step with 8 busy
   lanes (paged, both attention kernels), a full-width ``zamba2-1.2b``
   decode step (slotted, 8 lanes) and one zamba prefill of a 512-token
   prompt at bucket 512, all bf16 from seed-0 weights, through that
   tree's own ``chip_smoke.profile_decode`` and ``profile_prefill``:
   launches, device ms, host ms and idle share of each.

``--parts`` picks among ``kernels`` and ``steps`` (both by
default).  Prints one JSON line per measurement, the card's name and power limit, and
writes everything to ``chiprun_out/rmsnorm_kernel_study.json``.  Exits
non-zero without a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
STUDY_DIR = HERE / "build" / "study"
OUT = HERE / "chiprun_out" / "rmsnorm_kernel_study.json"


def log(*a):
    print(*a, flush=True)


def parent_kernels(torch, src: Path) -> dict:
    """The parent's ``rmsnorm`` and ``rmsnorm_add`` on contiguous bf16 or
    fp32 rows, built from ``src`` with this checkout's nvcc flags."""
    from repro_torch.kernels import _build

    STUDY_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = STUDY_DIR / "rmsnorm_parent.so"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed for the parent's rmsnorm.cu:\n{out.stdout[-4000:]}"
                           f"{out.stderr[-4000:]}")
    lib = ctypes.CDLL(str(lib_path))
    tail = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
    lib.rmsnorm_fwd.argtypes = [ctypes.c_void_p] * 3 + tail
    lib.rmsnorm_add_fwd.argtypes = [ctypes.c_void_p] * 5 + tail
    codes = {torch.float32: 0, torch.bfloat16: 1}

    def check(rc):
        if rc:
            raise RuntimeError(f"parent rmsnorm launch failed: CUDA error {rc}")

    def rmsnorm(x, g):
        out = torch.empty_like(x)
        check(lib.rmsnorm_fwd(x.data_ptr(), g.data_ptr(), out.data_ptr(), codes[x.dtype],
                              codes[g.dtype], x.shape[0], x.shape[1], 1e-6,
                              torch.cuda.current_stream().cuda_stream))
        return out

    def rmsnorm_add(x, r, g):
        out, s = torch.empty_like(x), torch.empty_like(x)
        check(lib.rmsnorm_add_fwd(x.data_ptr(), r.data_ptr(), g.data_ptr(), out.data_ptr(),
                                  s.data_ptr(), codes[x.dtype], codes[g.dtype], x.shape[0],
                                  x.shape[1], 1e-6, torch.cuda.current_stream().cuda_stream))
        return out, s

    return {"rmsnorm": rmsnorm, "rmsnorm_add": rmsnorm_add}


def kernel_times(torch, cs, dev, parent: dict) -> list[dict]:
    """The parent's and this checkout's ``rmsnorm`` and ``rmsnorm_add`` at
    ``chip_smoke.RMSNORM_SHAPES`` in bf16, device ms per call in turns
    parent, change, change, parent: L2-cold (the calls rotate through
    copies of the inputs, ``chip_smoke.COLD_BYTES`` of them, one iterator
    for every cold timing of a shape) and warm (copy 0 alone)."""
    import itertools

    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_add_ref, rmsnorm_ref

    change = {"rmsnorm": ops.rmsnorm, "rmsnorm_add": ops.rmsnorm_add}
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for n, D in cs.RMSNORM_SHAPES:
        k = -(-cs.COLD_BYTES // (n * D * 2))
        X, R = ((torch.randn(k, n, D, generator=gen, device=dev) * 3).bfloat16()
                for _ in range(2))
        G = torch.randn(k, D, generator=gen, device=dev) * 0.1
        cold = itertools.cycle(list(zip(X, R, G)))
        for name, pick, ref in (("rmsnorm", lambda x, r, g: (x, g), rmsnorm_ref),
                                ("rmsnorm_add", lambda x, r, g: (x, r, g), rmsnorm_add_ref)):
            args = pick(X[0], R[0], G[0])
            want = ref(*args)
            for fn in (parent[name], change[name]):
                got = fn(*args)
                torch.cuda.synchronize()
                for a, b in zip(got if name == "rmsnorm_add" else (got,),
                                want if name == "rmsnorm_add" else (want,)):
                    cs.max_err(torch, a, b, "bfloat16")
            times = {"parent": {"cold": [], "warm": []}, "change": {"cold": [], "warm": []}}
            for tree in ("parent", "change", "change", "parent"):
                fn = (parent if tree == "parent" else change)[name]
                times[tree]["cold"].append(
                    cs.device_ms(torch, lambda: fn(*pick(*next(cold))), 200))
                times[tree]["warm"].append(cs.device_ms(torch, lambda: fn(*args), 200))
            row = dict(kernel=name, shape=[n, D], dtype="bfloat16", input_copies=k, ms=times)
            log(f"rmsnorm study {json.dumps(row)}")
            rows.append(row)
    return rows


def worker(tree: Path) -> dict:
    """Runs in its own process: ``tree``'s kernels, models and chip_smoke
    profiles (see the module docstring, 2)."""
    sys.path[:0] = [str(tree), str(tree / "src")]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import lm, zamba
    from repro_torch.serve import EngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    out = {"tree": str(tree)}
    base = dataclasses.replace(get_config("smollm-360m"), attn_impl="kernel")
    params = lm.init(base, seed=0, device=dev)
    ec = EngineConfig(max_slots=cs.MAX_SLOTS, max_len=cs.MAX_LEN, kv_layout="paged",
                      page_size=cs.PAGE, paged_attn="kernel")
    out["dense_decode"] = cs.profile_decode(torch, base, params, cs.requests(base.vocab), ec, dev)
    del params
    zbase = get_config("zamba2-1.2b")
    zcfg = dataclasses.replace(zbase, attn_impl="kernel")
    zparams = zamba.init(zcfg, seed=0, device=dev)
    zec = EngineConfig(max_slots=cs.MAX_SLOTS, max_len=cs.MAX_LEN, kv_layout="slotted")
    out["zamba_decode"] = cs.profile_decode(torch, zcfg, zparams, cs.requests(zcfg.vocab), zec,
                                            dev)
    host = cs.prefill_ms(torch, dev, zbase, zparams)["kernel"]
    out["zamba_prefill_host_ms"] = host["ms"]
    out["zamba_prefill"] = cs.profile_prefill(torch, dev, zbase, zparams,
                                              float(np.median(host["ms"])))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="an unpacked older checkout")
    ap.add_argument("--parts", default="kernels,steps", help="comma-separated: kernels, steps")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("WORKER " + json.dumps(worker(args.worker.resolve())), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("rmsnorm study: no CUDA device", file=sys.stderr)
        return 2
    parts = set(args.parts.split(","))
    if parts - {"kernels", "steps"} or not args.parent:
        ap.error("--parts takes kernels, steps; both need --parent")
    sys.path[:0] = [str(HERE), str(HERE / "src")]
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    res = {"nvidia_smi": smi, "parent": str(args.parent)}
    if "kernels" in parts:
        src = args.parent.resolve() / "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu"
        res["kernels"] = kernel_times(torch, cs, dev, parent_kernels(torch, src))
    res["steps"] = []
    trees = (args.parent.resolve(), HERE, HERE, args.parent.resolve()) if "steps" in parts else ()
    for tree in trees:
        run = subprocess.run([sys.executable, __file__, "--worker", str(tree)],
                             capture_output=True, text=True)
        line = [ln for ln in run.stdout.splitlines() if ln.startswith("WORKER ")]
        if run.returncode or not line:
            raise RuntimeError(f"worker for {tree} failed:\n{run.stdout[-3000:]}"
                               f"{run.stderr[-3000:]}")
        row = json.loads(line[0][len("WORKER "):])
        keep = ("kernel_launches_per_step", "device_ms_per_step", "step_ms_unprofiled",
                "device_idle_share", "launches", "device_ms", "host_ms_unprofiled")
        log("rmsnorm study steps " + json.dumps(
            {"tree": row["tree"], **{k: {f: v[f] for f in keep if f in v}
                                      for k, v in row.items() if isinstance(v, dict)}}))
        res["steps"].append(row)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(res, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
