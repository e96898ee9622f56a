"""Whisper-tiny — encoder-decoder audio transformer [arXiv:2212.04356].

4L enc + 4L dec, d_model=384 6H (kv=6) d_ff=1536 vocab=51865.  The conv
frontend is a STUB per the task spec: ``input_specs()`` provides
precomputed frame embeddings (enc_seq x d_model, i.e. post-conv features).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,          # decoder layers
    enc_layers=4,
    enc_seq=1500,
    d_model=384,
    n_heads=6,
    n_kv=6,
    d_ff=1536,
    vocab=51_865,
    frontend_dim=384,    # frame embeddings arrive at model width (post-conv stub)
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="whisper-tiny-smoke",
    family="audio",
    n_layers=2,
    enc_layers=2,
    enc_seq=16,
    d_model=48,
    n_heads=3,
    n_kv=3,
    d_ff=96,
    vocab=256,
    frontend_dim=48,
    tie_embeddings=True,
)
