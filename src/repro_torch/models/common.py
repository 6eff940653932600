"""The architecture config of the port: the dense decoder family and the
two modality stubs whose trunks are dense (``vlm``, ``audio``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["ArchConfig"]

# families whose trunk is the dense decoder (JAX's ``layer_pattern`` gives
# them all ``dense`` layers, or gemma3's local/global pattern)
_FAMILIES = ("dense", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Shapes and options of one decoder, named as in
    ``repro.models.common.ArchConfig``, with its defaults. Ported: the
    dense family, a gated or ungated MLP (``mlp_gated``, ``act_fn``),
    tied or untied embeddings, QKV bias, qk-norm, a local:global layer
    pattern with sliding-window local layers and a second rope theta on
    the global ones, the embedding scale and a final logit softcap; and
    the modality stubs: ``vlm`` (phi-3-vision: ``num_patches``
    precomputed patch embeddings in front of the text) and ``audio``
    (musicgen: ``num_codebooks`` token streams, one embedding and head
    block of ``vocab_size`` rows each). Both lay their trunks out as
    ``dense``."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention ---
    qkv_bias: bool = False            # qwen2.5
    qk_norm: bool = False             # gemma3
    rope_theta: float = 1e4
    rope_theta_global: Optional[float] = None  # gemma3 global layers
    sliding_window: Optional[int] = None
    local_global_ratio: int = 0       # gemma3: N local layers per global
    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act_fn: str = "silu"
    mlp_gated: bool = True
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    embed_scale: bool = False         # gemma: scale embeddings by sqrt(d)
    # --- modality stubs ---
    num_patches: int = 0              # phi-3-vision prefix
    num_codebooks: int = 0            # musicgen
    # store the KV cache as packed LNS words (+ a per-position, per-head
    # scale) at this many bits; None keeps it in the compute dtype
    kv_cache_bits: Optional[int] = None
    quantize_attention: bool = True   # Q_A on the attention operands
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.family not in _FAMILIES:
            raise NotImplementedError(
                f"family {self.family!r}: the port has the "
                f"{', '.join(_FAMILIES)} families")

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def q_heads_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def layer_pattern(self) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
        """(prefix kinds, number of periods, period kinds): ``prefix``
        unrolled layers, then ``n_periods`` repetitions of the period.
        gemma3's period is ``local_global_ratio`` local layers and one
        global one; the layers that do not fill a period are local and
        come first."""
        if self.local_global_ratio > 0:
            period = ("local",) * self.local_global_ratio + ("global",)
            n_periods = self.num_layers // len(period)
            prefix = ("local",) * (self.num_layers - n_periods * len(period))
            return prefix, n_periods, period
        return (), self.num_layers, ("dense",)

    def params_count(self) -> int:
        """Trainable parameters, counted as the JAX package counts them."""
        d, hd = self.d_model, self.head_dim
        attn = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d)
        if self.qkv_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * hd
        if self.qk_norm:
            attn += 2 * hd
        block = attn + d * self.d_ff * (3 if self.mlp_gated else 2) + 2 * d
        rows = self.vocab_size * (self.num_codebooks or 1)
        head = 0 if self.tie_embeddings else d * rows
        return rows * d + head + d + self.num_layers * block
