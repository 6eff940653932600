"""Deterministic synthetic token stream, as ``repro.training.data``.

Batches are a pure function of (seed, cursor), drawn with numpy exactly
as the JAX package draws them, so the two frameworks see byte-equal
batches: codebook tokens ``(B, S, K)`` and phi-3-vision's f32 patches
``(B, num_patches, d_model)`` included.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

__all__ = ["SyntheticLM"]


class SyntheticLM:
    """Tokens follow ``t_{i+1} = (t_i + 7·noise) mod V`` from a random
    start, so a model can lower its loss on them while every batch stays
    reproducible from its cursor."""

    def __init__(self, cfg, batch: int, seq: int, seed: int = 0,
                 noise_levels: int = 16):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.noise = noise_levels
        self.cursor = 0

    def batch_at(self, cursor: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 32) ^ cursor)
        V = self.cfg.vocab_size
        books = (self.cfg.num_codebooks,) if self.cfg.num_codebooks else ()
        start = rng.integers(0, V, (self.batch,) + books)
        steps = rng.integers(0, self.noise, (self.batch, self.seq) + books)
        seqs = (start[:, None] * 1 + np.cumsum(steps, axis=1) * 7) % V
        seqs = np.concatenate([start[:, None], seqs], axis=1).astype(np.int32)
        out = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
        if self.cfg.num_patches:
            out["patches"] = rng.standard_normal(
                (self.batch, self.cfg.num_patches, self.cfg.d_model)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            b = self.batch_at(self.cursor)
            self.cursor += 1
            yield b

    def seek(self, cursor: int) -> None:
        self.cursor = cursor
