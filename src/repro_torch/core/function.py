"""``synk.function`` — data-parallel execution of a serial function.

The user writes a serial ``fn`` over its batch of inputs; calling the
Synkhronos function induces the paper's §3.2 sequence:

  1) data inputs are scattered equally across workers,
  2) each worker calls the same function on its assigned data,
  3) results are reduced or gathered back and returned.

The port of the reference's ``core/function.py``.  The reference runs one
controller over a JAX mesh (``shard_map``); the port follows the paper's
one process per card: every rank calls ``f(*args)`` with the same host
arguments (SPMD over the context's ``torch.distributed`` group) and gets
back what the reference's ``f(*args)`` returns:

* ``Scatter`` inputs: rank ``r`` takes chunk ``r`` of the leading axis;
  ``Broadcast`` inputs are used as they are.
* ``Reduce("mean"|"sum"|"max"|"min")`` outputs: an all-reduce after the
  per-worker call; ``concat`` and ``last``: an all-gather along axis 0
  (``last`` keeps worker 0's value); ``None``: the ``(n_data, ...)``
  stack of the workers' values, gathered.  Outputs are detached tensors
  on this rank's device.

``fn`` is arbitrary eager PyTorch (it may use autograd and sync with the
host), so there is no program to compile: each call works out its
staging plan from the raw arguments and stages every leaf by it.  The
function's ``AotCache`` is a signature counter: one entry per call
signature, holding only the output Reduce ops flattened against the
first call's outputs, so ``builds`` counts signatures and ``cache_hits``
repeated ones, as the reference's counters do.  A tensor already on the worker's device is
not copied (``device_put_skips``); anything else is copied there
(``device_puts``).  ``donate=True`` consumes scattered inputs as
``jax.jit``'s ``donate_argnums`` does: host inputs are staged into fresh
buffers each call, and a caller's device tensor passed to a donating
function has its storage released after the call (the counterpart of a
deleted JAX buffer), unless an output shares it.

Both §5 extensions are supported: ``num_slices=`` (automated input
slicing with aggregation) and ``batch=`` (input indexing, host- or
device-resident).  ``batch=`` indices into a :class:`DeviceDataset` are
**global** row ids (the dataset's pre-scatter leading axis).  When each
scattered index chunk lands in its own worker's shard, workers take rows
locally after rebasing to shard-local positions; otherwise rows are
routed between workers with a masked all-reduce(sum) gather (correct for
any permutation, at the cost of one collective over the indexed batch).

The reference's second backend, ``gspmd`` (XLA's automatic partitioning
of a global program), has no eager counterpart and raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import context as ctx_mod
from . import tree
from .aot import AotCache
from .data import is_dataset, is_host_data
from .slicing import flatten_ops, sliced_call
from .specs import Reduce, Scatter, canonicalize_in_spec, canonicalize_out_tree

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
               "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


@dataclasses.dataclass(frozen=True)
class _CallPlan:
    """Static description of one call signature (cache key companion)."""

    num_slices: int
    indexed: bool                    # batch= indices present
    routed: bool                     # device-resident indices cross shards
    dataset_arg: tuple[bool, ...]    # which args are DeviceDatasets
    ds_local_len: tuple[int | None, ...]  # per-arg local shard length


@dataclasses.dataclass
class _CacheEntry:
    """One call signature's output Reduce ops, one per output leaf
    (filled on the first call)."""

    op_leaves: list | None = None


class SynkFunction:
    def __init__(
        self,
        fn: Callable,
        in_specs: Sequence[Any],
        out_specs: Any = Reduce("mean"),
        *,
        ctx: ctx_mod.SynkContext | None = None,
        backend: str = "shard_map",
        name: str | None = None,
        donate: bool = False,
    ):
        self.fn = fn
        self.in_specs = tuple(canonicalize_in_spec(s) for s in in_specs)
        self.out_specs = canonicalize_out_tree(out_specs)
        if backend == "gspmd":
            raise NotImplementedError(
                "backend='gspmd' is XLA's automatic partitioning of a global program "
                "(its tensor-parallel placements included), which eager PyTorch has no "
                "counterpart of; it is not ported")
        if backend != "shard_map":
            raise ValueError(backend)
        self.ctx = ctx or ctx_mod.current()
        self.backend = backend
        self.name = name or getattr(fn, "__name__", "synk_fn")
        self.donate = donate
        # a worker slices the args it scattered (incl. gathered dataset rows)
        self._sliceable = [isinstance(s, Scatter) for s in self.in_specs]
        # one entry per call signature (the serve engine's cache class;
        # its builds/cache_hits counters feed self.stats)
        self.aot = AotCache(self.name)
        self._counters = {"calls": 0, "device_puts": 0, "device_put_skips": 0}

    @property
    def stats(self) -> dict:
        """Dispatch counters (calls/builds/cache_hits/device_puts/...)."""
        return {**self._counters, **self.aot.stats}

    # ------------------------------------------------------------------
    def __call__(self, *args, num_slices: int = 1, batch=None):
        if len(args) != len(self.in_specs):
            raise TypeError(
                f"{self.name} takes {len(self.in_specs)} inputs, got {len(args)}"
            )
        self._counters["calls"] += 1
        n = self.ctx.n_data
        dataset_arg = tuple(is_dataset(a) for a in args)
        indexed = batch is not None

        idx_global = None
        orig_len = None
        if indexed:
            idx_global = np.asarray(batch)
            if idx_global.ndim != 1:
                raise ValueError("batch= must be a 1-D index array")
            orig_len = idx_global.shape[0]
            if orig_len == 0:
                raise ValueError("batch= may not be empty")
            if orig_len % n != 0:
                idx_global = _pad_indices(idx_global, n)

        routed = False
        ds_local_len: list[int | None] = [None] * len(args)
        if indexed and any(dataset_arg):
            k = idx_global.shape[0] // n
            owners = np.repeat(np.arange(n), k)
            lo, hi = int(idx_global.min()), int(idx_global.max())
            for i, (a, is_ds) in enumerate(zip(args, dataset_arg)):
                if is_ds:
                    if lo < 0 or hi >= len(a):
                        raise IndexError(
                            f"batch= ids must be global dataset rows in "
                            f"[0, {len(a)}); got range [{lo}, {hi}]"
                        )
                    ds_local_len[i] = a.local_length
                    if not routed:
                        routed = bool(np.any(idx_global // a.local_length != owners))

        plan = _CallPlan(
            num_slices=num_slices, indexed=indexed, routed=routed,
            dataset_arg=dataset_arg, ds_local_len=tuple(ds_local_len),
        )
        key = self._signature(args, idx_global, plan)
        entry = self.aot.get(key, _CacheEntry)
        staged, owned = self._stage_args(args, idx_global, plan)
        if plan.num_slices > 1:
            out = sliced_call(self.fn, staged, self._sliceable, self.out_specs,
                              plan.num_slices)
        else:
            out = self.fn(*staged)
        if entry.op_leaves is None:
            entry.op_leaves = flatten_ops(self.out_specs, out)
        out = self._apply_reduces(out, entry.op_leaves)
        if self.donate:
            self._release(owned, out)
        return self._postprocess(entry, out, orig_len)

    # ------------------------------------------------------------------
    # Signature & staging
    # ------------------------------------------------------------------
    def _signature(self, args, idx_global, plan: _CallPlan):
        """Cache key from the RAW args — no staging required first."""
        sig = []
        for a, is_ds in zip(args, plan.dataset_arg):
            if is_ds:
                sig.append(("ds", a.shape, str(a.dtype)))
            elif is_host_data(a):
                sig.append(("host", a.shape, str(a.dtype)))
            else:
                sig.append(("tree", tree.structure(a), tuple(_leaf_sig(l) for l in tree.leaves(a))))
        idx_len = idx_global.shape[0] if plan.indexed else None
        return (
            tuple(sig), plan.num_slices, plan.indexed, plan.routed,
            plan.dataset_arg, idx_len,
        )

    def _put(self, arr, spec, owned: list):
        """Stage one leaf: this rank's chunk of a scattered leaf, on this
        rank's device; no copy when it is already there.  Returns the
        staged tensor; a caller's device tensor is noted in ``owned``."""
        ctx = self.ctx
        if isinstance(spec, Scatter):
            b = np.shape(arr)[0] if np.ndim(arr) else None
            if b is None or b % ctx.n_data != 0:
                raise ValueError(
                    f"scattered input batch {b} must divide the "
                    f"data-parallel worker count {ctx.n_data}"
                )
            k = b // ctx.n_data
            arr = arr[ctx.rank * k:(ctx.rank + 1) * k]
        if torch.is_tensor(arr) and arr.device == ctx.device:
            self._counters["device_put_skips"] += 1
            if isinstance(spec, Scatter):
                owned.append(arr)
            return arr
        self._counters["device_puts"] += 1
        if not torch.is_tensor(arr):
            arr = torch.from_numpy(np.array(arr, copy=True))
        return arr.to(ctx.device)

    def _stage_args(self, args, idx_global, plan: _CallPlan):
        """The per-worker arguments: staged leaves and, for datasets, the
        rows of ``batch=`` gathered on the device.  Returns (args, the
        caller's device tensors among the scattered inputs)."""
        staged, owned = [], []
        for a, spec, is_ds in zip(args, self.in_specs, plan.dataset_arg):
            scatter = isinstance(spec, Scatter)
            if is_ds:
                if not scatter:
                    raise ValueError("DeviceDataset inputs must use Scatter spec")
                staged.append(a.local)  # already this rank's shard on device
            elif is_host_data(a):
                arr = a.excerpt(idx_global) if (plan.indexed and scatter) else a.array
                staged.append(self._put(arr, spec, owned))
            else:
                def prep(leaf):
                    if plan.indexed and scatter:
                        leaf = leaf[torch.as_tensor(idx_global, device=leaf.device)] \
                            if torch.is_tensor(leaf) else np.asarray(leaf)[idx_global]
                    return self._put(leaf, spec, owned)
                staged.append(tree.map_tree(prep, a))
        if plan.indexed and any(plan.dataset_arg):
            # device-resident indexing (paper §5.2): global row ids, either
            # this rank's chunk (aligned fast path) or all of them (routed)
            idx = torch.from_numpy(idx_global.astype(np.int64))
            self._counters["device_puts"] += 1
            staged = self._take_dataset_rows(plan, staged, idx.to(self.ctx.device))
        return staged, owned

    def _take_dataset_rows(self, plan: _CallPlan, dev_args: list, idx):
        """Per-worker gather of dataset rows for global ``batch=`` indices."""
        n, w = self.ctx.n_data, self.ctx.rank
        k = idx.shape[0] // n
        for i, is_ds in enumerate(plan.dataset_arg):
            if not is_ds:
                continue
            L = plan.ds_local_len[i]
            arr = dev_args[i]
            if not plan.routed:
                # aligned: this worker's index chunk lies in its own shard
                dev_args[i] = arr.index_select(0, idx[w * k:(w + 1) * k] - w * L)
            else:
                # routed: every worker sees all B indices; each contributes
                # the rows it owns, an all-reduce(sum) assembles the full
                # gathered batch, and the worker keeps its chunk.
                rel = idx - w * L
                own = (rel >= 0) & (rel < L)
                rows = arr.index_select(0, rel.clamp(0, L - 1))
                mask = own.reshape(own.shape + (1,) * (rows.dim() - 1))
                rows = torch.where(mask, rows, torch.zeros((), dtype=rows.dtype,
                                                           device=rows.device))
                dist.all_reduce(rows, group=self.ctx.pg)
                dev_args[i] = rows[w * k:(w + 1) * k]
        return dev_args

    # ------------------------------------------------------------------
    # Reductions across workers
    # ------------------------------------------------------------------
    def _apply_reduces(self, out, op_leaves):
        ctx = self.ctx
        dev = ctx.device
        red = []
        for val, op in zip(tree.leaves(out), op_leaves):
            val = (val.detach() if torch.is_tensor(val)
                   else torch.as_tensor(np.asarray(val), device=dev))
            if ctx.n_data == 1:
                red.append(val[None] if op.op is None else val)
            elif op.op in _REDUCE_OPS:
                val = val.clone()
                dist.all_reduce(val, op=_REDUCE_OPS[op.op], group=ctx.pg)
                red.append(val / ctx.n_data if op.op == "mean" else val)
            elif op.op == "last":
                # identical-by-construction state: worker 0's copy
                val = val.contiguous().clone()
                dist.broadcast(val, src=0, group=ctx.pg)
                red.append(val)
            else:  # concat: workers' rows in order; None: stacked per worker
                parts = [torch.empty_like(val) for _ in range(ctx.n_data)]
                dist.all_gather(parts, val.contiguous(), group=ctx.pg)
                red.append(torch.cat(parts) if op.op == "concat" else torch.stack(parts))
        return tree.unflatten(out, red)

    def _postprocess(self, entry: _CacheEntry, out, orig_len):
        """Slice padded ``concat`` outputs back to the request length."""
        if orig_len is None or not any(op.op == "concat" for op in entry.op_leaves):
            return out
        cut = [
            (leaf[:orig_len] if op.op == "concat" and leaf.dim()
             and leaf.shape[0] >= orig_len else leaf)
            for leaf, op in zip(tree.leaves(out), entry.op_leaves)
        ]
        return tree.unflatten(out, cut)

    @staticmethod
    def _release(owned: list, out) -> None:
        """Donation: release the storage of the caller's device tensors
        that were scattered inputs, unless an output shares it (or PyTorch
        does not own it: a tensor over a numpy array)."""
        kept = {x.untyped_storage().data_ptr() for x in tree.leaves(out)}
        for t in owned:
            st = t.untyped_storage()
            if st.data_ptr() not in kept and st.resizable():
                st.resize_(0)


def _leaf_sig(leaf) -> tuple:
    """(shape, dtype) of a leaf without touching its data (``np.asarray``
    of a tensor would pin its storage, or copy it from the card)."""
    if not hasattr(leaf, "dtype"):
        leaf = np.asarray(leaf)
    return tuple(leaf.shape), str(leaf.dtype)


def function(
    fn: Callable,
    inputs: Sequence[Any],
    outputs: Any = "mean",
    *,
    ctx: ctx_mod.SynkContext | None = None,
    backend: str = "shard_map",
    name: str | None = None,
    donate: bool = False,
) -> SynkFunction:
    """Paper's ``synk.function`` (replacing ``theano.function``)."""
    return SynkFunction(
        fn, inputs, outputs, ctx=ctx, backend=backend, name=name, donate=donate,
    )


def _pad_indices(idx: np.ndarray, n: int) -> np.ndarray:
    """Pad an index list so it scatters evenly (paper: 'as equal as
    possible' — we repeat trailing indices, cycling when the pad exceeds
    the list; reductions stay approximately correct and ``concat`` outputs
    are sliced back to the original request length)."""
    pad = (-len(idx)) % n
    if not pad:
        return idx
    if len(idx) == 0:
        raise ValueError("batch= may not be empty")
    tail = np.resize(idx[::-1], pad)[::-1]
    return np.concatenate([idx, tail])
