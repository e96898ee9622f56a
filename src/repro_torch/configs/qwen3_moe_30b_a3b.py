"""Qwen3-30B-A3B — MoE, 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4, head_dim=128, QK-norm) d_expert=768
vocab=151936, MoE 128e top-8.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv=4,
    d_head=128,
    d_ff=0,
    vocab=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=768, capacity_factor=1.25),
)

SMOKE = ArchConfig(
    name="qwen3-moe-30b-a3b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_head=16,
    d_ff=0,
    vocab=256,
    qk_norm=True,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, capacity_factor=1.5),
)
