"""xLSTM-1.3B — sLSTM + mLSTM blocks [arXiv:2405.04517].

48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304.  Block ratio mLSTM:sLSTM =
7:1 (one sLSTM per ``slstm_every`` blocks).  d_ff=0: xLSTM blocks carry
their own up/down projections instead of a separate FFN.  Linear
recurrence: eligible for long_500k.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv=4,
    d_ff=0,
    vocab=50_304,
    slstm_every=8,
    subquadratic=True,
)

SMOKE = ArchConfig(
    name="xlstm-1.3b-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=2,
    n_kv=2,
    d_ff=0,
    vocab=256,
    slstm_every=2,
    subquadratic=True,
)
