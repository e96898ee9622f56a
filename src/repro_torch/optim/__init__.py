"""Optimizers: flat buffers (paper §3.3), update rules, and the bucketed
collective engine over ``torch.distributed``."""
from .flat import FlatLayout, flat_adam_update, flatten, make_layout, unflatten
from .rules import (
    OptConfig, apply_update, clip_by_global_norm, global_norm, init_state,
)

__all__ = [
    "FlatLayout", "flat_adam_update", "flatten", "make_layout", "unflatten",
    "OptConfig", "apply_update", "clip_by_global_norm", "global_norm",
    "init_state",
]
