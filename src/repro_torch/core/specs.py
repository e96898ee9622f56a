"""Input/output specifications for Synkhronos functions.

Mirrors the paper's interface: inputs are either *scattered* (split along
the leading axis across data-parallel workers — paper §4.1 "the lowest
tensor dimension is taken to represent independent data points") or
*broadcast* (used as-is on every worker).  Outputs carry a reduce/gather
operation (paper §3.1 "the ability to specify a reduce/gather operation to
use for each output").

The port of the reference's ``core/specs.py``: the same classes and
canonicalisers, plus :func:`canonicalize_out_tree` for a tree of output
specs (the reference maps ``jax.tree`` over it).
"""
from __future__ import annotations

import dataclasses
from typing import Any

REDUCE_OPS = ("mean", "sum", "max", "min", "concat", "last", None)


@dataclasses.dataclass(frozen=True)
class Scatter:
    """Split this input along ``axis`` across the data-parallel workers."""

    axis: int = 0

    def __post_init__(self):
        if self.axis != 0:
            raise NotImplementedError(
                "Synkhronos scatters along the leading axis (paper §4.1); "
                "move the batch dimension to axis 0."
            )


@dataclasses.dataclass(frozen=True)
class Broadcast:
    """Replicate this input on every worker (paper: 'inputs designated for
    broadcast are simply used as is')."""


@dataclasses.dataclass(frozen=True)
class Reduce:
    """Reduce this output across workers with ``op``.

    ``mean``/``sum``/``max``/``min`` — elementwise reduction (paper: NCCL
    reduce back to master; here: an all-reduce over the process group).
    ``concat`` — gather along the leading axis (paper: gather).
    ``last``  — slicing aggregation only: keep the final slice's value
                (e.g. carried state); across workers behaves like concat.
    ``None``  — leave per-worker values stacked on a leading axis.
    """

    op: str | None = "mean"

    def __post_init__(self):
        if self.op not in REDUCE_OPS:
            raise ValueError(f"unknown reduce op {self.op!r}; choose from {REDUCE_OPS}")


def canonicalize_in_spec(spec: Any) -> Scatter | Broadcast:
    if isinstance(spec, (Scatter, Broadcast)):
        return spec
    if spec == "scatter":
        return Scatter()
    if spec == "broadcast" or spec == "bcast":
        return Broadcast()
    raise ValueError(f"bad input spec {spec!r}")


def canonicalize_out_spec(spec: Any) -> Reduce:
    if isinstance(spec, Reduce):
        return spec
    if spec in REDUCE_OPS:
        return Reduce(spec)
    if spec == "avg":  # paper spells it 'avg'
        return Reduce("mean")
    raise ValueError(f"bad output spec {spec!r}")


def canonicalize_out_tree(spec: Any):
    """:func:`canonicalize_out_spec` at every leaf of a (dict, list, tuple)
    tree of output specs; a ``Reduce``, a string or ``None`` is a leaf."""
    if isinstance(spec, (Reduce, str)) or spec is None:
        return canonicalize_out_spec(spec)
    if isinstance(spec, dict):
        return {k: canonicalize_out_tree(v) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        return type(spec)(canonicalize_out_tree(v) for v in spec)
    raise ValueError(f"bad output spec {spec!r}")
