#!/usr/bin/env python3
"""Device-time study of the port's attention kernels on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/attention_kernel_study.py [--parent DIR]

1. ``--parent DIR`` (an unpacked older checkout of this repository, such as
   ``git archive <commit>`` under the git-ignored ``build/``): builds that
   checkout's ``flash_attention.cu`` and ``paged_attention.cu`` with this
   checkout's nvcc flags and times them against this checkout's kernels at
   ``chip_smoke.py``'s shapes by device time per call (``torch.profiler``),
   in turns parent, change, change, parent, with SDPA beside flash.  A
   parent's paged kernel is called with the signature it has: with the
   split scratch, or (before the split design) without.
2. Where the paged split kernel's time goes: a copy of this checkout's
   source in which thread 0 of every CTA stamps ``clock64`` and
   ``%globaltimer`` at entry and after each phase (the lane's length, the
   K/V gather, the scores, the per-split softmax, P.V and its stores), run
   once at random lengths and at phase 3's lengths.  Prints, over the live
   CTAs, each phase's SM cycles (median and max), when the CTAs started
   and ended against the first start, and the split and combine kernels'
   device time from the profiler (the copy beside the unstamped kernel).

Prints one JSON line per measurement, the card's name and power limit, and
writes everything to ``chiprun_out/attention_kernel_study.json``.  Exits
non-zero without a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
PAGED_SRC = HERE / "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
STUDY_DIR = HERE / "build" / "study"
# (phase, the source text its stamp follows) in the split kernel; a stamp
# goes before an anchor that is a comment and after one that is code
STAMPS = (
    ("entry", "  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z;\n"),
    ("length", "  if (j0 >= j1) return;                // nothing of this lane in the split\n"),
    ("gather", '  asm volatile("cp.async.wait_all;\\n" ::: "memory");\n  __syncthreads();\n'),
    ("scores", "  // softmax partial per rep: warp w takes reps w, w + 4\n"),
    ("softmax", "  // P.V: thread (dim pair 2dp, 2dp + 1; rep group g) takes reps g, g + 4\n"),
    ("pv", "  }\n}\n\n// One thread per output element"),
)
MAX_CTAS = 1 << 16


def log(*a):
    print(*a, flush=True)


def build(sources: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    """nvcc every source in parallel into ``STUDY_DIR``; {name: library}."""
    from repro_torch.kernels import _build

    STUDY_DIR.mkdir(parents=True, exist_ok=True)
    procs = {n: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(STUDY_DIR / f"{n}.so"),
                                  str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n, src in sources.items()}
    libs = {}
    for n, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {n}:\n{out[-4000:]}")
        libs[n] = ctypes.CDLL(str(STUDY_DIR / f"{n}.so"))
    return libs


def stamped_source() -> Path:
    """The paged source with a ``clock64`` / ``%globaltimer`` stamp by
    thread 0 of every split CTA at each of ``STAMPS``, into device arrays
    read back by ``paged_stamps``."""
    src = PAGED_SRC.read_text()
    n = len(STAMPS)
    head = f"""#include <cuda_runtime.h>
__device__ unsigned long long g_clk[{MAX_CTAS} * {n}], g_time[{MAX_CTAS} * {n}];
__device__ __forceinline__ void stamp(int k) {{
  if (threadIdx.x) return;
  const long cta = blockIdx.x + (long)gridDim.x * (blockIdx.y + (long)gridDim.y * blockIdx.z);
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_time[cta * {n} + k] = t;
  g_clk[cta * {n} + k] = clock64();
}}
"""
    for k, (name, anchor) in enumerate(STAMPS):
        if src.count(anchor) != 1:
            raise RuntimeError(f"stamp anchor {name!r} not found once in {PAGED_SRC}")
        call = f"  stamp({k});\n"
        comment = anchor.lstrip().startswith("//") or anchor.startswith("  }\n}")
        src = src.replace(anchor, anchor[:4] + call + anchor[4:] if name == "pv"
                          else (call + anchor if comment else anchor + call))
    tail = f"""
extern "C" int paged_stamps(unsigned long long* clk, unsigned long long* time, int reset) {{
  const size_t bytes = sizeof(unsigned long long) * {MAX_CTAS} * {n};
  if (reset) {{
    void* p;
    cudaGetSymbolAddress(&p, g_clk); cudaMemset(p, 0, bytes);
    cudaGetSymbolAddress(&p, g_time); cudaMemset(p, 0, bytes);
    return (int)cudaDeviceSynchronize();
  }}
  cudaMemcpyFromSymbol(clk, g_clk, bytes);
  cudaMemcpyFromSymbol(time, g_time, bytes);
  return (int)cudaGetLastError();
}}
"""
    path = STUDY_DIR / "paged_stamped.cu"
    STUDY_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(head + src + tail)
    return path


def stamp_summary(clk, gtime, ctas: int, sm_hz: float) -> dict:
    """Per phase over the live CTAs (those past the length check): SM
    microseconds at ``sm_hz`` (median, max); CTA start and end against
    the first start (globaltimer ns)."""
    n = len(STAMPS)
    clk = clk[: ctas * n].reshape(ctas, n).astype(np.int64)
    gt = gtime[: ctas * n].reshape(ctas, n).astype(np.int64)
    live = clk[:, 1] > 0
    out = dict(ctas=ctas, live_ctas=int(live.sum()))
    for k in range(1, n):
        d = (clk[live, k] - clk[live, k - 1]) / sm_hz * 1e6
        out[STAMPS[k][0]] = dict(median_us=float(np.median(d)), max_us=float(d.max()))
    t0 = gt[:, 0].min()
    out["start_us"] = dict(median=float(np.median(gt[:, 0] - t0) / 1e3),
                           max=float((gt[:, 0] - t0).max() / 1e3))
    out["live_end_us"] = dict(median=float(np.median(gt[live, -1] - t0) / 1e3),
                              max=float((gt[live, -1] - t0).max() / 1e3))
    return out


def paged_entry(lib, with_scratch: bool):
    fn = lib.paged_attention_fwd
    if with_scratch:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def paged_caller(torch, fn, with_scratch: bool):
    from repro_torch.kernels.paged_attention.ops import scratch_shapes, split_plan

    def call(q, kp, vp, lengths, tables):
        B, Hk, rep, D = q.shape
        bs, nb = kp.shape[1], tables.shape[1]
        o = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [q.data_ptr(), kp.data_ptr(), vp.data_ptr(), lengths.data_ptr(), tables.data_ptr(),
                o.data_ptr()]
        if with_scratch:
            bps, n_split = split_plan(nb, bs)
            n = sum(math.prod(s) for s in scratch_shapes(B, Hk, rep, D, n_split).values())
            scratch = torch.empty(n, device=q.device)
            rc = fn(*ptrs, scratch.data_ptr(), 1, B, Hk, rep, D, bs, nb, bps, n_split, 0, 0.0,
                    D ** -0.5, stream)
        else:
            rc = fn(*ptrs, 1, B, Hk, rep, D, bs, nb, 0, 0.0, D ** -0.5, stream)
        if rc:
            raise RuntimeError(f"paged launch failed: {rc}")
        return o
    return call


def main() -> int:
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="an unpacked older checkout to time against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_kernel_study: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention, split_plan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    results = {"nvidia_smi": smi, "parent": str(args.parent) if args.parent else None}
    sources = {"paged_stamped": stamped_source()}
    parent_paged_scratch = False
    if args.parent:
        pk = args.parent / "src/repro_torch/kernels"
        sources["parent_flash"] = pk / "flash_attention/csrc/flash_attention.cu"
        sources["parent_paged"] = pk / "paged_attention/csrc/paged_attention.cu"
        parent_paged_scratch = "float* scratch" in sources["parent_paged"].read_text()
    libs = build(sources)

    def turns(fns: dict, order, iters: int) -> dict:
        row = {}
        for name in order:
            ms, kernels = cs.device_profile(torch, fns[name], iters)
            row.setdefault(name, []).append(
                dict(ms=ms, kernels={k[:60]: v["ms"] for k, v in kernels.items()}))
        return row

    gen = torch.Generator(device=dev).manual_seed(0)
    if args.parent:
        pf = libs["parent_flash"].flash_attention_fwd
        pf.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        pf.restype = ctypes.c_int
        flash_rows = {}
        for name, B, S, H, Hk in cs.FLASH_TIMING:
            q, k, v = (torch.randn(B, S, h, 64, generator=gen, device=dev).bfloat16()
                       for h in (H, Hk, Hk))
            qc, kc, vc = (x.transpose(1, 2).contiguous() for x in (q, k, v))

            def parent(q=q, k=k, v=v, B=B, S=S, H=H, Hk=Hk):
                o = torch.empty_like(q)
                if pf(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, B, H, Hk, S, S, 64,
                      1, 0, 0.0, 64 ** -0.5, torch.cuda.current_stream().cuda_stream):
                    raise RuntimeError("parent flash launch failed")
                return o
            fns = {"parent": parent, "change": lambda q=q, k=k, v=v: flash_attention(q, k, v),
                   "sdpa": lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                                                  enable_gqa=True)}
            flash_rows[name] = turns(fns, ("parent", "change", "sdpa", "change", "parent", "sdpa"), 100)
            log(f"flash {name} q {[B, S, H, 64]}: {json.dumps(flash_rows[name])}")
        results["flash"] = flash_rows

    stamps = libs["paged_stamped"].paged_stamps
    stamps.argtypes, stamps.restype = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    stamped = paged_caller(torch, paged_entry(libs["paged_stamped"], True), True)
    phase3 = [int(p.size) + 10 for p, _ in cs.requests(cs.SMOLLM_VOCAB)[:cs.MAX_SLOTS]]
    paged_rows = {}
    for label, lens, nulled in (("random", None, (6, 7)), ("phase 3", phase3, ())):
        q, kp, vp, lengths, tables = cs.paged_inputs(torch, dev, "bfloat16", layers=8,
                                                     lengths=lens, nulled=nulled)
        i = [0]

        def rotate(fn):
            def go():
                layer = i[0] % 8
                i[0] += 1
                return fn(q, kp[layer], vp[layer], lengths, tables)
            return go
        fns = {"change": rotate(paged_attention), "stamped": rotate(stamped)}
        order = ["change", "stamped"]
        if args.parent:
            fns["parent"] = rotate(paged_caller(torch, paged_entry(libs["parent_paged"],
                                                                   parent_paged_scratch),
                                                parent_paged_scratch))
            order = ["parent"] + order
        row = turns(fns, order + order[::-1], 200)
        # one stamped call on a pool the last seven calls did not touch
        for _ in range(7):
            fns["stamped"]()
        torch.cuda.synchronize()
        assert stamps(None, None, 1) == 0
        fns["stamped"]()
        torch.cuda.synchronize()
        n = len(STAMPS)
        clk = np.zeros(MAX_CTAS * n, np.uint64)
        gt = np.zeros(MAX_CTAS * n, np.uint64)
        assert stamps(clk.ctypes.data, gt.ctypes.data, 0) == 0
        sm_mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
        ctas = q.shape[0] * q.shape[1] * split_plan(tables.shape[1], kp.shape[2])[1]
        row["stamps"] = stamp_summary(clk, gt, ctas, sm_mhz * 1e6)
        row["stamps"]["sm_mhz"] = sm_mhz
        paged_rows[label] = row
        log(f"paged {label} lengths {lengths.tolist()}: {json.dumps(row)}")
    results["paged"] = paged_rows
    out = HERE / "chiprun_out" / "attention_kernel_study.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
