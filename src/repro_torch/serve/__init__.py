"""Continuous-batching serving: engine, programs, slotted and paged caches."""
from .cache import bucket_for, make_slot_state, prompt_buckets
from .engine import STATUSES, Completion, EngineConfig, ServeEngine
from .faults import NONFINITE_TOKEN, UNCOMMITTED
from .paged import BlockAllocator, SlotTables, blocks_for, cache_nbytes, make_paged_state
from .step import (
    paged_decode_program,
    paged_prefill_program,
    sample_tokens,
    slot_decode_program,
    slot_prefill_program,
)

__all__ = [
    "BlockAllocator", "Completion", "EngineConfig", "NONFINITE_TOKEN",
    "STATUSES", "ServeEngine", "SlotTables", "UNCOMMITTED", "blocks_for",
    "bucket_for", "cache_nbytes", "make_paged_state", "make_slot_state",
    "paged_decode_program", "paged_prefill_program", "prompt_buckets",
    "sample_tokens", "slot_decode_program", "slot_prefill_program",
]
