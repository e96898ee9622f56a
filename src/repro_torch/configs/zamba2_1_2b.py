"""Zamba2-1.2B — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242].

38L d_model=2048 32H (kv=32, MHA shared block) d_ff=8192 vocab=32000,
ssm_state=64.  A single shared transformer (attn+MLP) block is applied
every ``attn_every`` Mamba2 layers, taking concat(hidden, embedding) as
input (Zamba's global skip).  Sub-quadratic: eligible for long_500k.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=32_000,
    ssm=SSMConfig(state=64, head_dim=64, expand=2, n_groups=1, conv_kernel=4, chunk=256),
    attn_every=6,
    subquadratic=True,
)

SMOKE = ArchConfig(
    name="zamba2-1.2b-smoke",
    family="hybrid",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    vocab=256,
    ssm=SSMConfig(state=16, head_dim=16, expand=2, n_groups=1, conv_kernel=4, chunk=8),
    attn_every=2,
    subquadratic=True,
)
