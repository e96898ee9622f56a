"""Deterministic synthetic data pipeline.

Batches are a pure function of (seed, step): resume-after-failure replays
the exact same stream with no stored iterator state — the data-side half of
fault tolerance.  The code is the reference's numpy, so the token stream is
bitwise the reference's.  The VLM and audio frontends arrive with their
families.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.data import SynkData


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticTokens:
    """Deterministic LM token stream: batch(step) -> (B, S+1) int32."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> np.ndarray:
        c = self.cfg
        rng = np.random.default_rng([c.seed, step])
        # Markov-ish stream so a model can actually reduce loss on it:
        # token_{t+1} = (a * token_t + b + noise) % vocab
        B, S = c.global_batch, c.seq_len
        a = 31
        start = rng.integers(0, c.vocab, size=(B, 1))
        noise = (rng.random(size=(B, S)) < 0.1).astype(np.int64)
        toks = [start[:, 0]]
        for t in range(S):
            toks.append((a * toks[-1] + 7 + noise[:, t]) % c.vocab)
        return np.stack(toks, axis=1).astype(np.int32)


def make_batch_fn(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0):
    """Returns batch(step) -> {"tokens": (global_batch, seq_len + 1) int32}."""
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.family} batches (frontend embeddings) arrive with the "
            "MoE/VLM/audio slice of the port")
    toks = SyntheticTokens(DataConfig(cfg.vocab, shape.seq_len, shape.global_batch, seed))

    def fn(step: int) -> dict:
        return {"tokens": toks.batch(step)}

    return fn


def host_corpus(cfg: ArchConfig, n_examples: int, seq_len: int, seed: int = 0) -> SynkData:
    """A shared-memory-style corpus for the input-indexing path."""
    stream = SyntheticTokens(DataConfig(cfg.vocab, seq_len, n_examples, seed))
    return SynkData(stream.batch(0))
