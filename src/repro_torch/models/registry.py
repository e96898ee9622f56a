"""Family registry: which module serves a config, and how.

The port of the reference's ``models/registry.py``: every family of the
reference maps to its module (dense, moe and vlm to ``lm``, hybrid to
``zamba``, ssm to ``xlstm_lm``, audio to ``whisper``), and the serving
questions get the reference's answers.  :func:`param_shard_dims` is the
counterpart of the reference's ``param_pspecs``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from . import lm, whisper, xlstm_lm, zamba
from .common import ShardRules, map_tree, tree_leaves

_FAMILIES = {"dense": lm, "moe": lm, "vlm": lm, "hybrid": zamba, "ssm": xlstm_lm,
             "audio": whisper}

# the families whose train step runs the mesh program on a live model axis
# (tensor parallelism; sequence and expert parallelism where the family
# has them) and those that serve on one; the others run at a model axis of
# 1 and raise at a live one (ROADMAP.md queue 1, item 1)
MESH_TRAIN_FAMILIES = lm.TP_FAMILIES + ("hybrid",)
MESH_SERVE_FAMILIES = lm.SERVE_TP_FAMILIES + ("hybrid",)
# what a live model axis refuses names this item
MESH_FAMILY_ITEM = "queue 1, item 1: the model axis for the other families"


def sequence_parallel(cfg: ArchConfig) -> bool:
    """Whether the family's residual stream is sequence-sharded over the
    model axis under the reference's rules (the reference's launcher turns
    ``sp`` off for the hybrid and ssm families)."""
    return getattr(get_module(cfg), "SEQUENCE_PARALLEL", True)


def tp_region_leaves(cfg: ArchConfig) -> frozenset:
    """The leaf names replicated over the model axis but read inside the
    tensor-parallel region (each model rank holds a partial gradient)."""
    return getattr(get_module(cfg), "TP_REGION_LEAVES", frozenset())


def get_module(cfg: ArchConfig):
    return _FAMILIES[cfg.family]


def abstract_params(cfg: ArchConfig) -> dict:
    """The parameter tree as meta tensors (shape and dtype, no storage):
    what ``optim.flat.make_layout`` needs."""
    return map_tree(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                    get_module(cfg).param_specs(cfg))


def param_shard_dims(cfg: ArchConfig, rules: ShardRules, data: int = 1,
                     model: int = 1) -> dict:
    """``{leaf path: (the dimension rules split over the model axis, the
    dimension they shard over the data axis)}``, each None where there is
    none: where the reference's ``param_pspecs(cfg, rules)`` names
    ``rules.tp`` and ``rules.fsdp``.  Every such dimension is a weight's own
    (the stacked layer axes' logical axes are None), never a layer axis.
    A dimension that ``model`` (the tensor-parallel one) or ``data`` ranks
    (the FSDP one, of the model slice) do not divide raises
    ``ValueError``, as the reference's ``jax.device_put`` of such a
    sharding does."""
    out = {}
    for path, spec in tree_leaves(get_module(cfg).param_specs(cfg)):
        tp, fs = spec.tp_dim(rules), spec.shard_dim(rules)
        for d, n, what in ((tp, model, "tensor-parallel"), (fs, data, "FSDP")):
            if d is not None and spec.shape[d] % n:
                raise ValueError(
                    f"{'/'.join(path)}: its {what} dimension {d} ({spec.shape[d]} of shape "
                    f"{spec.shape}) does not divide over {n} ranks")
        if tp is not None and fs is not None and tp == fs:
            raise ValueError(f"{'/'.join(path)}: one dimension on both axes")
        out[path] = (tp, fs)
    return out


def supports_slot_serving(cfg: ArchConfig) -> bool:
    """Whether the family works with the continuous-batching engine: it
    exposes ``prefill_slot`` and a ``decode_step`` taking a (B,) position
    vector.  The modality families (vlm, audio) are left out, as in the
    reference: they feed per-request frontend inputs the slot path does not
    carry, and serve on ``serve.loop.generate_static``."""
    return cfg.family in ("dense", "moe", "ssm", "hybrid") and hasattr(
        get_module(cfg), "prefill_slot")


def supports_paged_serving(cfg: ArchConfig) -> bool:
    """Whether the family also has the paged (block-table) entry points."""
    return supports_slot_serving(cfg) and hasattr(
        get_module(cfg), "decode_step_paged")


def state_kind(cfg: ArchConfig) -> str:
    """Per-lane decode-state kind the engine manages: ``"kv"`` (a seq-axis
    KV cache, pageable and lazily overwritten), ``"recurrent"`` (xLSTM:
    O(1)-in-sequence per-lane state, slotted only, hard-reset at admission
    and zeroed at eviction) or ``"hybrid"`` (zamba: a slotted KV segment
    plus per-lane recurrent leaves)."""
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
    declare it.  The host tier's unit of a slotted lane spill."""
    fn = getattr(get_module(cfg), "lane_leaf_axes", None)
    return fn(cfg) if fn else {}
