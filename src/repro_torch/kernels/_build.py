"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel's sources live beside its wrapper (``kernels/<name>/csrc/``).
On first use every source whose content hash has no library yet is
compiled — one ``nvcc`` per source, all started together — into
``build/kernels/`` at the repository root (git-ignored):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

The libraries have a plain C interface: pointers, ints, floats and the
stream go through ``ctypes`` with explicit ``argtypes``, and each entry
point returns ``cudaGetLastError()`` for the wrapper to check.  No
PyTorch header is compiled, so a build takes seconds, not minutes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}     # loaded once per process
_ENTRIES: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def sources() -> dict[str, Path]:
    """{kernel name: its .cu source} for every kernel of the package."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def library_path(src: Path) -> Path:
    """Where ``src``'s library lives: keyed by the hash of every file in its
    csrc directory and the flags, so an edit triggers a rebuild."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(src.parent.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every source without a current library, in parallel.
    Returns {name: compiler output} for the sources it built (ptxas's
    register/shared-memory report); raises if any build fails."""
    todo = {n: s for n, s in sources().items() if not library_path(s).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, src in todo.items():
        out = library_path(src)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)       # atomic: concurrent builds agree
    if failed:
        detail = "\n".join(f"--- {n}:\n{logs[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{detail}")
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        srcs = sources()
        if name not in srcs:
            raise KeyError(f"no CUDA source for kernel {name!r}")
        build_all()
        lib = ctypes.CDLL(str(library_path(srcs[name])))
        _LIBS[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of kernel ``name``'s library, its ``argtypes``
    set (and ``restype`` int) once per process, on first use."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        _ENTRIES[(name, symbol)] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
