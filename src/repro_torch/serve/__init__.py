"""Continuous-batching serving: engine, router front-end, programs, slotted
and paged caches, fault injection and the batch entry points."""
from .cache import bucket_for, make_slot_state, prompt_buckets
from .engine import STATUSES, Completion, EngineConfig, ServeEngine
from .faults import (
    ENGINE_FAULT_SITES,
    FAULT_SITES,
    NONFINITE_TOKEN,
    REPLICA_FAULT_SITES,
    UNCOMMITTED,
    FaultPlan,
)
from .loop import ServeConfig, generate, generate_static
from .router import ReplicaHandle, Router, RouterConfig
from .paged import (
    BlockAllocator,
    HostTier,
    LaneSpill,
    SlotTables,
    blocks_for,
    cache_nbytes,
    check_tiered,
    make_paged_state,
    prefix_keys,
)
from .step import (
    lane_read_program,
    lane_write_program,
    paged_block_read_program,
    paged_block_write_program,
    paged_copy_program,
    paged_decode_program,
    paged_prefill_program,
    sample_tokens,
    slot_decode_program,
    slot_prefill_program,
)

__all__ = [
    "BlockAllocator", "Completion", "ENGINE_FAULT_SITES", "EngineConfig",
    "FAULT_SITES", "FaultPlan", "HostTier", "LaneSpill", "NONFINITE_TOKEN",
    "REPLICA_FAULT_SITES", "ReplicaHandle", "Router", "RouterConfig", "STATUSES",
    "ServeConfig", "ServeEngine", "SlotTables",
    "UNCOMMITTED", "blocks_for", "bucket_for", "cache_nbytes", "check_tiered",
    "generate", "generate_static", "lane_read_program", "lane_write_program",
    "make_paged_state", "make_slot_state", "paged_block_read_program",
    "paged_block_write_program", "paged_copy_program", "paged_decode_program",
    "paged_prefill_program", "prefix_keys", "prompt_buckets", "sample_tokens",
    "slot_decode_program", "slot_prefill_program",
]
