"""InternVL2-76B — VLM: InternViT frontend + LLM backbone [arXiv:2404.16821].

Backbone: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The vision frontend is a STUB per the task spec: ``input_specs()`` provides
precomputed patch embeddings (frontend_tokens x frontend_dim) which the
model projects into d_model and prepends to the token sequence.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=28_672,
    vocab=128_256,
    frontend_tokens=256,
    frontend_dim=3200,       # InternViT-6B hidden size
)

SMOKE = ArchConfig(
    name="internvl2-76b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=192,
    vocab=256,
    frontend_tokens=4,
    frontend_dim=24,
)
