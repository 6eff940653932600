"""Modality frontend stubs, as ``repro.models.stubs``.

phi-3-vision and musicgen specify the transformer backbone; the CLIP
vision tower and the EnCodec audio codec are stubs that produce the
tensors the backbone consumes, with the JAX package's shapes and dtypes,
drawn from an explicit ``torch.Generator`` (the two frameworks' draws
differ; carry values across as numpy where the same ones are needed).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ArchConfig

__all__ = ["vision_patches_stub", "encodec_tokens_stub", "apply_delay_pattern"]


def vision_patches_stub(gen: torch.Generator, batch: int,
                        cfg: ArchConfig) -> torch.Tensor:
    """Precomputed CLIP-tile patch embeddings, already projected to
    d_model: unit gaussians ``(batch, num_patches, d_model)`` in the
    compute dtype, on the generator's device."""
    x = torch.randn((batch, cfg.num_patches, cfg.d_model), generator=gen,
                    dtype=torch.float32, device=gen.device)
    return x.to(cfg.compute_dtype)


def encodec_tokens_stub(gen: torch.Generator, batch: int, seq: int,
                        cfg: ArchConfig) -> torch.Tensor:
    """EnCodec RVQ codes: ``(batch, seq, num_codebooks)`` int32 in
    [0, vocab_size)."""
    return torch.randint(0, cfg.vocab_size,
                         (batch, seq, cfg.num_codebooks), generator=gen,
                         dtype=torch.int32, device=gen.device)


def apply_delay_pattern(tokens: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """MusicGen's delay pattern: codebook k shifted right by k steps
    (``pad_id`` in front), so the model predicts every codebook of step t
    from strictly earlier codes. ``tokens (B, S, K)``."""
    B, S, K = tokens.shape
    out = torch.full_like(tokens, pad_id)
    for k in range(K):
        out[:, k:, k] = tokens[:, :S - k, k]
    return out
