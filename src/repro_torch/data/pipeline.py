"""Deterministic synthetic data pipeline.

Batches are a pure function of (seed, step): resume-after-failure replays
the exact same stream with no stored iterator state — the data-side half of
fault tolerance.  The code is the reference's numpy, so the token stream and
the frontend stubs (VLM patch embeddings, audio frames) are bitwise the
reference's.
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


class SyntheticEmbeds:
    """Deterministic float frontend stubs (VLM patches / audio frames)."""

    def __init__(self, shape: tuple[int, ...], seed: int = 0):
        self.shape = shape
        self.seed = seed

    def batch(self, step: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 1_000_003, step])
        return rng.standard_normal(self.shape, dtype=np.float32)


def make_batch_fn(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0):
    """Returns batch(step) -> {"tokens": (global_batch, S_text + 1) int32}
    plus the family's frontend stub: ``patch_embeds`` (global_batch,
    frontend_tokens, frontend_dim) for vlm, whose text is ``seq_len -
    frontend_tokens`` long, and ``frames`` (global_batch, enc_seq,
    d_model) for audio, both fp32."""
    s_text = shape.seq_len - (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    toks = SyntheticTokens(DataConfig(cfg.vocab, s_text, shape.global_batch, seed))
    extras = {}
    if cfg.family == "vlm":
        extras["patch_embeds"] = SyntheticEmbeds(
            (shape.global_batch, cfg.frontend_tokens, cfg.frontend_dim), seed)
    if cfg.family == "audio":
        extras["frames"] = SyntheticEmbeds((shape.global_batch, cfg.enc_seq, cfg.d_model),
                                           seed)

    def fn(step: int) -> dict:
        b = {"tokens": toks.batch(step)}
        for k, gen in extras.items():
            b[k] = gen.batch(step)
        return b

    return fn


def host_corpus(cfg: ArchConfig, n_examples: int, seq_len: int, seed: int = 0) -> SynkData:
    """A shared-memory-style corpus for the input-indexing path."""
    stream = SyntheticTokens(DataConfig(cfg.vocab, seq_len, n_examples, seed))
    return SynkData(stream.batch(0))
