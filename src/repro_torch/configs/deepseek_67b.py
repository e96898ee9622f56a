"""DeepSeek-67B — dense llama-arch [arXiv:2401.02954; hf].

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=22016,
    vocab=102_400,
    rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    name="deepseek-67b-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=160,
    vocab=256,
)
