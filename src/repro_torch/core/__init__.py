"""Synkhronos core on PyTorch: data parallelism at the level of individual
functions.

The port of the reference's ``core`` package, with its public API name for
name (paper, Appendix A), one process per card:

    import repro_torch.core as synk

    ctx = synk.fork()                       # join the workers' group
    f = synk.function(fn, inputs=[synk.Scatter(), synk.Scatter()],
                      outputs=synk.Reduce("mean"))
    params = synk.distribute(params)        # replicate shared state
    out = f(x, y)                           # scatter -> compute -> reduce
    out = f(x, y, num_slices=4)             # §5.1 input slicing
    out = f(dx, dy, batch=idxs)             # §5.2 input indexing
    params = synk.all_reduce(params, "avg") # NCCL-style collective

Every rank runs the same program with the same host arguments.
``AotCache`` is shared with the serve engine, whose decode step it holds
as a captured CUDA graph on the card.
"""
from .aot import AotCache
from .context import SynkContext, current, fork, make_mesh, reset
from .specs import Broadcast, Reduce, Scatter
from .function import SynkFunction, function
from .data import DeviceDataset, SynkData, data, scatter_data
from .collectives import (
    LocalValues,
    all_reduce,
    as_replicated,
    broadcast,
    distribute,
    gather,
    get_value,
    reduce_to,
    replicate,
    scatter_shared,
    set_value,
)

__all__ = [
    "AotCache",
    "SynkContext", "current", "fork", "make_mesh", "reset",
    "Broadcast", "Reduce", "Scatter",
    "SynkFunction", "function",
    "DeviceDataset", "SynkData", "data", "scatter_data",
    "LocalValues", "all_reduce", "as_replicated", "broadcast", "distribute",
    "gather", "get_value", "reduce_to", "replicate", "scatter_shared",
    "set_value",
]
