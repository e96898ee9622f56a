"""Family registry: which module serves a config, and how.

The port of the reference's ``models/registry.py`` for the families
ported so far (dense, hybrid).  Every other family raises
``NotImplementedError`` naming the slice of the port it arrives with.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from . import lm, zamba
from .common import map_tree

_FAMILIES = {"dense": lm, "hybrid": zamba}
_LATER = {
    "moe": "the MoE/VLM/audio slice",
    "vlm": "the MoE/VLM/audio slice",
    "audio": "the MoE/VLM/audio slice",
    "ssm": "the xLSTM slice",
}


def get_module(cfg: ArchConfig):
    mod = _FAMILIES.get(cfg.family)
    if mod is None:
        later = _LATER.get(cfg.family, "a later slice")
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; it arrives with {later}")
    return mod


def abstract_params(cfg: ArchConfig) -> dict:
    """The parameter tree as meta tensors (shape and dtype, no storage):
    what ``optim.flat.make_layout`` needs."""
    return map_tree(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                    get_module(cfg).param_specs(cfg))


def supports_slot_serving(cfg: ArchConfig) -> bool:
    """Whether the family works with the continuous-batching engine: it
    exposes ``prefill_slot`` and a ``decode_step`` taking a (B,) position
    vector."""
    return cfg.family in _FAMILIES and hasattr(get_module(cfg), "prefill_slot")


def supports_paged_serving(cfg: ArchConfig) -> bool:
    """Whether the family also has the paged (block-table) entry points."""
    return supports_slot_serving(cfg) and hasattr(
        get_module(cfg), "decode_step_paged")


def state_kind(cfg: ArchConfig) -> str:
    """Per-lane decode-state kind the engine manages: ``"kv"`` (a seq-axis
    KV cache, pageable and lazily overwritten) or ``"hybrid"`` (zamba: a
    slotted KV segment plus per-lane recurrent leaves)."""
    return getattr(get_module(cfg), "STATE_KIND", "kv")


def recurrent_leaf_axes(cfg: ArchConfig) -> dict:
    """``{leaf name: lane axis}`` of the cache leaves that are per-lane
    recurrent state (hard-reset at admission, zeroed at eviction); empty
    for pure-KV families."""
    fn = getattr(get_module(cfg), "recurrent_leaf_axes", None)
    return fn(cfg) if fn else {}


def lane_leaf_axes(cfg: ArchConfig) -> dict:
    """``{leaf name: lane axis}`` of every slot-cache leaf a lane owns (KV
    segments and recurrent leaves alike); empty for families that do not
    declare it.  The host tier's spill unit, when it is ported."""
    fn = getattr(get_module(cfg), "lane_leaf_axes", None)
    return fn(cfg) if fn else {}
