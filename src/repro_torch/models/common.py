"""The architecture config of the port (the dense decoder family)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["ArchConfig"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Shapes and options of one decoder, named as in
    ``repro.models.common.ArchConfig``, with its defaults. Ported: the
    dense family, a gated or ungated MLP (``mlp_gated``, ``act_fn``),
    tied or untied embeddings, every attention GEMM quantized."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act_fn: str = "silu"
    mlp_gated: bool = True
    attn_logit_softcap: Optional[float] = None
    # store the KV cache as packed LNS words (+ a per-position, per-head
    # scale) at this many bits; None keeps it in the compute dtype
    kv_cache_bits: Optional[int] = None
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.family != "dense":
            raise NotImplementedError(
                f"family {self.family!r}: only the dense decoder is ported")

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def q_heads_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def layer_pattern(self) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
        """(prefix kinds, number of periods, period kinds)."""
        return (), self.num_layers, ("dense",)
