"""SmolLM-360M — small dense llama-arch [hf:HuggingFaceTB/SmolLM].

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.  Tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv=5,
    d_ff=2560,
    vocab=49_152,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="smollm-360m-smoke",
    family="dense",
    n_layers=3,
    d_model=48,
    n_heads=3,
    n_kv=1,
    d_ff=128,
    vocab=256,
    tie_embeddings=True,
)
