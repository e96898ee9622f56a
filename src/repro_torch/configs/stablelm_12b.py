"""StableLM-2-12B — dense [hf:stabilityai/stablelm-2-12b].

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv=8,
    d_ff=13_824,
    vocab=100_352,
)

SMOKE = ArchConfig(
    name="stablelm-12b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=192,
    vocab=256,
)
