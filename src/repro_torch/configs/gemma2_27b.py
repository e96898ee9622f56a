"""Gemma-2-27B — dense with local/global alternating attention and logit
softcapping [arXiv:2408.00118; hf].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000, head_dim=128,
window 4096 on local layers, attn softcap 50, final-logit softcap 30.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv=16,
    d_head=128,
    d_ff=36_864,
    vocab=256_000,
    window=4096,
    alt_local_global=True,
    attn_softcap=50.0,
    logit_softcap=30.0,
    query_scale=(4608 / 32) ** -0.5,   # query_pre_attn_scalar = d_model/n_heads
    gate_act="gelu",                   # GeGLU
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="gemma2-27b-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_head=16,
    d_ff=192,
    vocab=256,
    window=16,
    alt_local_global=True,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
)
