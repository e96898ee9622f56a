"""Qwen3-235B-A22B — MoE, 128 experts top-8 [hf:Qwen/Qwen3-235B-A22B].

94L d_model=4096 64H (GQA kv=4, head_dim=128, QK-norm) d_expert=1536
vocab=151936, MoE 128e top-8.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv=4,
    d_head=128,
    d_ff=0,
    vocab=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536, capacity_factor=1.25),
    # bf16 storage, as the reference's config (its sharded trainer keeps
    # the fp32 Adam moments as the master copy)
    param_dtype="bfloat16",
)

SMOKE = ArchConfig(
    name="qwen3-moe-235b-a22b-smoke",
    family="moe",
    n_layers=2,
    d_model=48,
    n_heads=3,
    n_kv=1,
    d_head=16,
    d_ff=0,
    vocab=256,
    qk_norm=True,
    moe=MoEConfig(num_experts=4, top_k=2, d_expert=24, capacity_factor=1.5),
)
