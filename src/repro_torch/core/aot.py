"""Cache of compiled programs shared by the function and serve dispatch paths.

``SynkFunction`` (core/function.py) keeps one entry per call signature
(its output Reduce ops; eager PyTorch compiles nothing there).  The serve engine
keys its prefill/decode programs on (layout, bucket, sampling flags)
instead of argument signatures, through the same class.

The cache is deliberately dumb: a dict from a hashable key to whatever
``build()`` returned, plus hit/miss counters.  Callers own key hygiene
(include every static option that changes the program) and eviction
(none — programs are meant to live for the process; an unbounded
signature space is a caller bug, surfaced by ``builds`` growing without
bound).

The port of the reference's ``core/aot.py``.  Eager PyTorch has no
``.lower().compile()``; its compiled program is a captured CUDA graph
(:class:`CudaGraphProgram`): :func:`device_program` captures one on a
CUDA device and hands back the eager program itself on the CPU, where
graphs do not exist.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Iterator

import torch

from .tree import leaves


class AotCache:
    """Keyed store of compiled programs with hit/miss counters.

    ``stats["builds"]`` counts cache misses (one build each: a staging
    plan, an eager program, or a warm step and a graph capture);
    ``stats["cache_hits"]`` counts steady-state dispatches.  A warmed-up
    caller must show a flat ``builds`` counter (``chip_smoke.py`` asserts
    this for the serve engine).

    Every miss also records its build wall seconds in
    ``build_seconds`` (always wall time, even when the owning engine runs
    on a fake clock — compile cost is a real-world budget); ``top_builds``
    reports the slowest.

    Invariants: ``builds == len(self)`` (every miss stores exactly one
    entry, nothing is ever evicted); ``builds + cache_hits`` == total
    ``get`` calls; a key's entry is immutable once stored (``get`` never
    re-runs ``build`` for a present key, so sharing one cache across
    engines/benches can never recompile behind a caller's back).
    """

    def __init__(self, name: str = "aot"):
        self.name = name
        self._entries: dict[Any, Any] = {}
        self.stats = {"builds": 0, "cache_hits": 0}
        self.build_seconds: dict[Any, float] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def keys(self) -> Iterator[Any]:
        return iter(self._entries)

    def get(self, key, build: Callable[[], Any]):
        """Return the cached entry for ``key``, building it on first use."""
        entry = self._entries.get(key)
        if entry is None:
            self.stats["builds"] += 1
            t0 = time.perf_counter()
            entry = build()
            self.build_seconds[key] = time.perf_counter() - t0
            self._entries[key] = entry
        else:
            self.stats["cache_hits"] += 1
        return entry

    @property
    def build_s_total(self) -> float:
        return sum(self.build_seconds.values())

    def top_builds(self, n: int = 5) -> list[tuple[str, float]]:
        """The ``n`` slowest builds as (str(key), seconds), slowest first."""
        ranked = sorted(self.build_seconds.items(),
                        key=lambda kv: kv[1], reverse=True)
        return [(str(k), round(s, 4)) for k, s in ranked[:n]]


# ---------------------------------------------------------------------------
# CUDA graphs: the port's compiled programs
# ---------------------------------------------------------------------------


def _addresses(args) -> tuple:
    """Where each leaf of ``args`` lives: a tensor's ``data_ptr()``, any
    other leaf (a generator) by identity."""
    return tuple(x.data_ptr() if torch.is_tensor(x) else id(x) for x in leaves(args))


class CudaGraphProgram:
    """``fn(*args)`` captured as one CUDA graph on ``args``' buffers.

    ``fn`` reads and writes the tensors of ``args`` in place, allocates
    only through PyTorch (its scratch comes from the graph's own memory
    pool, kept alive with this object) and makes no host sync.  Building
    runs ``fn(*args)`` once eagerly, as a real call that also warms every
    kernel it launches (nvcc builds, library loads, attribute calls), then
    captures ``fn(*args)`` on the same buffers; capture executes nothing,
    so the state advances once.  The first call returns the eager call's
    output; every later call is one ``replay()`` whose output tensor is
    overwritten by the next.

    Before each call the leaves of ``args`` must sit at the addresses they
    had at capture: a rebound tensor raises, since replaying would read
    and write freed memory.  ``generators`` (``torch.Generator``s on the
    card that ``fn`` draws from) are registered with the graph, so each
    replay draws new numbers and advances them as an eager call would.
    The kernel wrappers' Python launch counters (``kernels.launch_counters``)
    do not run on replay: the increase each showed during capture is added
    on every replay instead.
    """

    def __init__(self, fn: Callable, args: tuple, *, generators=()):
        from repro_torch.kernels import launch_counters

        self._addresses = _addresses(args)
        self._first = fn(*args)
        self._replay_next = False
        counters = launch_counters()
        before = [c.launches for c in counters]
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        self.pool = torch.cuda.graph_pool_handle()
        with torch.cuda.graph(self.graph, pool=self.pool):
            self._out = fn(*args)
        self.launches = [(c, c.launches - b) for c, b in zip(counters, before) if c.launches != b]
        for c, b in zip(counters, before):
            c.launches = b
        self.replays = 0

    def __call__(self, *args):
        if _addresses(args) != self._addresses:
            raise RuntimeError(
                "a buffer of the captured program moved since capture (a tensor "
                "was rebound); replaying would touch freed memory")
        if not self._replay_next:
            out, self._first, self._replay_next = self._first, None, True
            return out
        self.graph.replay()
        self.replays += 1
        for c, n in self.launches:
            c.launches += n
        return self._out


def device_program(fn: Callable, args: tuple, *, generators=()) -> Callable:
    """The compiled form of ``fn`` over ``args``: a :class:`CudaGraphProgram`
    when ``args`` live on a CUDA device, else ``fn`` itself (eager).  Called
    as ``program(*args)`` either way.  Capture failures raise; there is no
    eager fallback on the card."""
    tensors = [x for x in leaves(args) if torch.is_tensor(x)]
    if tensors and tensors[0].is_cuda:
        return CudaGraphProgram(fn, args, generators=generators)
    return fn
