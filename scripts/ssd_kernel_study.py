#!/usr/bin/env python3
"""Device-time study of the port's SSD scan kernel on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/ssd_kernel_study.py --parent DIR

``DIR`` is an unpacked older checkout of this repository (``git archive
<commit>`` under the git-ignored ``build/``) whose ``ssd.cu`` has the
one-kernel entry of the first SSD design (five stride arrays, no scratch).  The study
builds that source with this checkout's nvcc flags and

1. times the parent's kernel and this checkout's (``ops.ssd``) at
   ``chip_smoke.py``'s shape x (1, T, 64, 64) bf16, N = 64, G = 1, for T
   512 and 2048, by device time per call (``torch.profiler``), in turns
   parent, change, change, parent, each checked against ``ssd_chunked``
   at ``chip_smoke.SSD_TOL`` first;
2. profiles one full-width ``zamba2-1.2b`` kernel-path prefill of a
   512-token prompt at bucket 512 (seed-0 weights, bf16) with each kernel
   (``chip_smoke.profile_prefill``: device ms, idle share against the
   prefill's unprofiled host time, launches, top kernels, SSD's share),
   parent's first, the prefill's host time the median of 5;
3. stamps where this checkout's chunk-state and chunk-scan kernels spend
   their time: a copy of the source in which thread 0 of every block
   records ``clock64``, ``%globaltimer`` and ``%smid`` at entry and after
   each phase (``STAMPS``), run once at T 512 and 2048.  Prints each
   phase's SM cycles over the blocks (median, p90, max), when the blocks
   started and ended against the first start, the most blocks one SM ran,
   and each kernel's resident blocks per SM.

Prints one JSON line per measurement, the card's name and power limit, and
writes everything to ``chiprun_out/ssd_kernel_study.json``.  Exits
non-zero without a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
STUDY_DIR = HERE / "build" / "study"
SSD_SRC = HERE / "src/repro_torch/kernels/ssd/csrc/ssd.cu"
# (kernel, phase, the source text its stamp goes before); each kernel's
# first stamp is its entry, each later one ends the phase it names
STAMPS = (
    (0, "entry", "  load_tile(sm, s0, Bm"),
    (0, "loads, cum", "  // Bw = B w_k as hi + lo terms"),
    (0, "Bw terms", "  // D[n][p] = sum_k Bw"),
    (0, "wgmma", "  // rows n >= N and columns p >= P are 0"),
    (0, "stores", "}\n\n// Pass 2:"),
    (1, "entry", "  load_tile(sm, sC,"),
    (1, "loads, S terms, cum", "  // acc = C.S_prev"),
    (1, "C.S, C.B^T wgmma", "  // this thread's rows row0 and row0 + 8"),
    (1, "decay terms, wgmma", "  O* yb = y + b * a.y.b"),
    (1, "y stores", "}\n\nbool aligned("),
)
MAX_BLOCKS = 1 << 14


def log(*a):
    print(*a, flush=True)


def parent_ssd(torch, src: Path):
    """The parent's model-layout ``ssd`` (bf16 in, fp32 y and state out),
    built from ``src`` with this checkout's nvcc flags."""
    from repro_torch.kernels import _build

    STUDY_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = STUDY_DIR / "ssd_parent.so"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed for the parent's ssd.cu:\n{out.stdout[-4000:]}"
                           f"{out.stderr[-4000:]}")
    fn = ctypes.CDLL(str(lib_path)).ssd_scan
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.POINTER(ctypes.c_longlong)] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    s3 = ctypes.c_longlong * 3

    def ssd(x, dt, A, Bm, Cm, *, chunk):
        B, T, H, P = x.shape
        G, N = Bm.shape[2], Bm.shape[3]
        y = torch.empty(B, T, H, P, dtype=torch.float32, device=x.device)
        state = torch.empty(B, H, N, P, dtype=torch.float32, device=x.device)
        st = lambda t: s3(t.stride(0), t.stride(1), t.stride(2))
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                y.data_ptr(), state.data_ptr(), 1, 0, B, H, G, T, N, P, st(x), st(dt),
                st(Bm), st(Cm), st(y), torch.cuda.current_stream(x.device).cuda_stream)
        if rc:
            raise RuntimeError(f"parent ssd launch failed: CUDA error {rc}")
        return y, state

    return ssd


def kernel_times(torch, cs, dev, kernels: dict) -> list[dict]:
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    B, _, H, P, G, N = cs.SSD_SHAPE
    rows = []
    for T in (512, 2048):
        args = cs.ssd_inputs(torch, dev, "bfloat16", B, T, H, P, G, N, seed=1)
        wy, ws = ssd_chunked_ref(*args, chunk=256, return_state=True)
        for name, fn in kernels.items():
            y, st = fn(*args, chunk=256)
            torch.cuda.synchronize()
            for got, want in ((y, wy), (st, ws)):
                cs.max_err(torch, got, want, "float32",
                           dict(atol=cs.SSD_TOL["scale"] * want.abs().max().item(),
                                rtol=cs.SSD_TOL["rtol"]))
        times = {n: [] for n in kernels}
        for name in ("parent", "change", "change", "parent"):
            times[name].append(cs.device_ms(torch, lambda: kernels[name](*args, chunk=256)))
        flops, nbytes = cs.ssd_bound(B, T, H, P, G, N, 2)
        row = dict(x=[B, T, H, P], N=N, G=G, ms=times,
                   bound_ms=cs.bound(flops, nbytes, "bfloat16")[0],
                   bound_fma_ms=cs.bound(flops, nbytes, "float32")[0])
        log(f"ssd study {json.dumps(row)}")
        rows.append(row)
    return rows


def prefill_profiles(torch, cs, dev, kernels: dict) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ops
    from repro_torch.models import zamba

    base = get_config("zamba2-1.2b")
    params = zamba.init(dataclasses.replace(base, attn_impl="kernel"), seed=0, device=dev)
    cfg = dataclasses.replace(base, attn_impl="kernel")
    p = zamba.cast_for_compute(cfg, params, dev)
    cache = {k: torch.zeros_like(s, device=dev)
             for k, s in zamba.make_cache_specs(cfg, 1, 512).items()}
    tokens = cs.prefill_tokens(torch, dev, base)
    own = ops.ssd
    out = {}
    try:
        for name in ("parent", "change"):
            ops.ssd = kernels[name]
            for _ in range(2):
                zamba.prefill_slot(cfg, p, cache, tokens, 0, 512)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                zamba.prefill_slot(cfg, p, cache, tokens, 0, 512)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            prof = cs.profile_prefill(torch, dev, base, params, float(np.median(times)))
            out[name] = dict(host_ms=times, profile=prof)
            log(f"ssd study prefill {name}: {json.dumps(out[name])}")
    finally:
        ops.ssd = own
    return out


def stamped_library() -> ctypes.CDLL:
    """This checkout's ``ssd.cu`` with a stamp at each of ``STAMPS``, plus
    entries that reset and read the stamps and report occupancy."""
    from repro_torch.kernels import _build

    src = SSD_SRC.read_text()
    head = f"""#include <cuda_runtime.h>
__device__ unsigned long long g_clk[2][{MAX_BLOCKS} * 5], g_time[2][{MAX_BLOCKS} * 5];
__device__ int g_sm[2][{MAX_BLOCKS}];
__device__ __forceinline__ void stamp(int kern, int k) {{
  if (threadIdx.x) return;
  const long b = blockIdx.x + (long)gridDim.x * (blockIdx.y + (long)gridDim.y * blockIdx.z);
  if (b >= {MAX_BLOCKS}) return;
  unsigned long long t;
  unsigned s;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  g_time[kern][b * 5 + k] = t;
  g_clk[kern][b * 5 + k] = clock64();
  g_sm[kern][b] = (int)s;
}}
"""
    counts = [0, 0]
    for kern, name, anchor in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"stamp anchor {name!r} not found once in {SSD_SRC}")
        at = src.index(anchor)
        src = src[:at] + f"  stamp({kern}, {counts[kern]});\n" + src[at:]
        counts[kern] += 1
    tail = f"""
extern "C" int ssd_stamps(unsigned long long* clk, unsigned long long* time, int* sm, int reset) {{
  const size_t bytes = sizeof(unsigned long long) * 2 * {MAX_BLOCKS} * 5;
  void* p;
  if (reset) {{
    cudaGetSymbolAddress(&p, g_clk); cudaMemset(p, 0, bytes);
    cudaGetSymbolAddress(&p, g_time); cudaMemset(p, 0, bytes);
    return (int)cudaDeviceSynchronize();
  }}
  cudaMemcpyFromSymbol(clk, g_clk, bytes);
  cudaMemcpyFromSymbol(time, g_time, bytes);
  cudaMemcpyFromSymbol(sm, g_sm, sizeof(int) * 2 * {MAX_BLOCKS});
  return (int)cudaGetLastError();
}}
extern "C" int ssd_occupancy(int* out) {{
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], tc::ssd_chunk_state_kernel,
                                                tc::NTHREADS, tc::SMEM_STATE);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], tc::ssd_state_pass_kernel,
                                                tc::PASS_THREADS, 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], tc::ssd_chunk_scan_kernel<float>,
                                                tc::NTHREADS, tc::SMEM_SCAN);
  return (int)cudaGetLastError();
}}
"""
    STUDY_DIR.mkdir(parents=True, exist_ok=True)
    path, lib_path = STUDY_DIR / "ssd_stamped.cu", STUDY_DIR / "ssd_stamped.so"
    path.write_text(head + src + tail)
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(path)],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed for the stamped ssd.cu:\n{out.stdout[-4000:]}")
    return ctypes.CDLL(str(lib_path))


def stamped_phases(torch, cs, dev) -> dict:
    from repro_torch.kernels.ssd import ops

    lib = stamped_library()
    occ = (ctypes.c_int * 3)()
    if lib.ssd_occupancy(occ):
        raise RuntimeError("occupancy query failed")
    fn = lib.ssd_scan
    fn.argtypes, fn.restype = ops._ARGTYPES, ctypes.c_int
    sm_hz = torch.cuda.get_device_properties(0).clock_rate * 1e3 \
        if hasattr(torch.cuda.get_device_properties(0), "clock_rate") else None
    out = dict(blocks_per_sm_resident=dict(chunk_state=occ[0], state_pass=occ[1],
                                           chunk_scan=occ[2]), sm_clock_hz=sm_hz)
    u64 = ctypes.POINTER(ctypes.c_ulonglong)
    B, _, H, P, G, N = cs.SSD_SHAPE
    for T in (512, 2048):
        x, dt, A, bm, cm = cs.ssd_inputs(torch, dev, "bfloat16", B, T, H, P, G, N, seed=1)
        y = torch.empty(B, T, H, P, device=dev)
        state = torch.empty(B, H, N, P, device=dev)
        plan = ops.ssd_plan(B, T, H, N, P)
        scratch = torch.empty(plan["scratch_floats"], device=dev)
        strides = ops._STRIDES(*[v for t in (x, dt, bm, cm, y) for v in t.stride()[:3]])
        call = lambda: fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), bm.data_ptr(),
                          cm.data_ptr(), y.data_ptr(), state.data_ptr(), scratch.data_ptr(),
                          1, 0, B, H, G, T, N, P, strides,
                          torch.cuda.current_stream().cuda_stream)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        lib.ssd_stamps(None, None, None, 1)
        if call():
            raise RuntimeError("stamped ssd launch failed")
        torch.cuda.synchronize()
        n = 2 * MAX_BLOCKS * 5
        clk, gt = np.zeros(n, np.uint64), np.zeros(n, np.uint64)
        sm = np.zeros(2 * MAX_BLOCKS, np.int32)
        lib.ssd_stamps(clk.ctypes.data_as(u64), gt.ctypes.data_as(u64),
                       sm.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), 0)
        nb = plan["blocks"]["chunk_scan"]
        row = dict(x=[B, T, H, P], blocks=nb)
        for kern, kname in ((0, "chunk_state"), (1, "chunk_scan")):
            names = [name for k, name, _ in STAMPS if k == kern]
            c = clk.reshape(2, MAX_BLOCKS, 5)[kern, :nb].astype(np.int64)
            t = gt.reshape(2, MAX_BLOCKS, 5)[kern, :nb].astype(np.int64)
            k_out = {}
            for j in range(1, len(names)):
                d = c[:, j] - c[:, j - 1]
                k_out[names[j] + " cycles"] = [float(np.median(d)), float(np.percentile(d, 90)),
                                                float(d.max())]
            t0 = t[:, 0].min()
            k_out["start_us"] = [float(np.median(t[:, 0] - t0) / 1e3), float((t[:, 0] - t0).max() / 1e3)]
            k_out["end_us"] = [float(np.median(t[:, -1] - t0) / 1e3), float((t[:, -1] - t0).max() / 1e3)]
            k_out["most_blocks_on_one_sm"] = int(np.bincount(sm.reshape(2, MAX_BLOCKS)[kern, :nb]).max())
            row[kname] = k_out
        log(f"ssd study stamps {json.dumps(row)}")
        out[f"T{T}"] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="an unpacked older checkout with the one-kernel ssd.cu")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ssd_kernel_study: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from repro_torch.kernels.ssd.ops import ssd

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    src = args.parent / "src/repro_torch/kernels/ssd/csrc/ssd.cu"
    kernels = {"parent": parent_ssd(torch, src), "change": ssd}
    results = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                   parent=str(args.parent))
    results["kernel"] = kernel_times(torch, cs, dev, kernels)
    results["prefill"] = prefill_profiles(torch, cs, dev, kernels)
    results["stamps"] = stamped_phases(torch, cs, dev)
    out = HERE / "chiprun_out" / "ssd_kernel_study.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
