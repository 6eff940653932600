"""The architecture config of the port: the dense decoder family, the
two modality stubs whose trunks are dense (``vlm``, ``audio``), the
recurrent families (``ssm``: RWKV6; ``hybrid``: zamba2's Mamba2 trunk
with a shared attention block) and the mixture of experts (``moe``:
deepseek-v3's MLA, routed and shared experts and MTP; kimi-k2's GQA
experts)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["ArchConfig"]

# the ported families: the dense decoder's (JAX's ``layer_pattern`` gives
# them all ``dense`` layers, or gemma3's local/global pattern), the
# recurrent ones (``rwkv`` layers; ``mamba`` periods with ``shared_attn``)
# and the mixture of experts (``dense`` layers, then ``moe`` ones)
_FAMILIES = ("dense", "vlm", "audio", "ssm", "hybrid", "moe")
_DECAY_LORA = 64        # RWKV6's decay LoRA rank (``models.rwkv``)


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
    ``dense``. The recurrent families: ``ssm`` (rwkv6: ``rwkv`` layers of
    ``ssm_head_dim``-wide WKV heads) and ``hybrid`` (zamba2: Mamba2 layers
    with one attention block shared by every ``shared_attn_every``-th
    layer, each occurrence with its own norms and a rank
    ``shared_block_lora_rank`` LoRA on the fused QKV). The mixture of
    experts: ``moe`` (``num_dense_layers`` dense layers, then layers whose
    MLP is ``num_experts`` routed experts of width ``moe_d_ff``, top
    ``experts_per_token`` a token, beside ``num_shared_experts`` shared
    ones), with multi-head latent attention (``use_mla``: low-rank query
    and KV projections, a cache of the KV latent and the rope key) and a
    depth-``mtp_depth`` multi-token-prediction loss."""

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
    # --- MLA (deepseek-v3) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    num_dense_layers: int = 0
    moe_dispatch: str = "dense_ref"   # dense_ref | sort (a2a: a mesh)
    capacity_factor: float = 1.25
    mtp_depth: int = 0                # deepseek multi-token prediction
    # --- SSM / RWKV ---
    ssm_state_dim: int = 0
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64            # mamba2 / rwkv6 head width
    shared_attn_every: int = 0        # zamba2: shared block period
    shared_block_lora_rank: int = 0   # zamba2 per-occurrence LoRA
    rwkv_chunk: int = 16
    ssm_chunk: int = 64
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

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k (recurrent, or mostly local attention),
        as the JAX package decides."""
        return self.family in ("ssm", "hybrid") or self.local_global_ratio > 0

    def layer_pattern(self) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
        """(prefix kinds, number of periods, period kinds): ``prefix``
        unrolled layers, then ``n_periods`` repetitions of the period.
        gemma3's period is ``local_global_ratio`` local layers and one
        global one; the layers that do not fill a period are local and
        come first. rwkv6 is ``rwkv`` layers; zamba2's period is
        ``shared_attn_every - 1`` mamba layers and the shared block, the
        layers that do not fill a period mamba ones in front. The mixture
        of experts: ``num_dense_layers`` dense layers, then ``moe``
        ones."""
        if self.family == "ssm":
            return (), self.num_layers, ("rwkv",)
        if self.family == "hybrid":
            k = self.shared_attn_every
            n_periods = self.num_layers // k
            prefix = ("mamba",) * (self.num_layers - n_periods * k)
            return prefix, n_periods, ("mamba",) * (k - 1) + ("shared_attn",)
        if self.family == "moe":
            prefix = ("dense",) * self.num_dense_layers
            return prefix, self.num_layers - self.num_dense_layers, ("moe",)
        if self.local_global_ratio > 0:
            period = ("local",) * self.local_global_ratio + ("global",)
            n_periods = self.num_layers // len(period)
            prefix = ("local",) * (self.num_layers - n_periods * len(period))
            return prefix, n_periods, period
        return (), self.num_layers, ("dense",)

    def params_count(self, active_only: bool = False) -> int:
        """Trainable parameters, counted as the JAX package counts them:
        the shared block once, its norms and LoRA once an occurrence; the
        MTP module (a dense block, a norm and the 2d -> d projection).
        ``active_only`` counts a token's experts only: the routed top-k and
        the shared ones."""
        d = self.d_model
        rows = self.vocab_size * (self.num_codebooks or 1)
        head = 0 if self.tie_embeddings else d * rows
        prefix, n_periods, period = self.layer_pattern()
        total = rows * d + head + d
        for kind in set(prefix) | set(period):
            n = prefix.count(kind) + n_periods * period.count(kind)
            total += n * self._layer_params(kind, active_only)
        if "shared_attn" in period or "shared_attn" in prefix:
            total += self._attn_params() + self._mlp_params()
        if self.mtp_depth:
            total += (self._attn_params() + self._mlp_params() + 3 * d
                      + 2 * d * d)
        return total

    def active_params_count(self) -> int:
        """Parameters a token runs through (``MODEL_FLOPS``' N)."""
        return self.params_count(active_only=True)

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        if self.use_mla:
            h, nope, rpe = self.num_heads, self.qk_nope_dim, self.qk_rope_dim
            qr, kvr = self.q_lora_rank, self.kv_lora_rank
            return (d * qr + qr * h * (nope + rpe) + d * (kvr + rpe)
                    + kvr * h * (nope + self.v_head_dim)
                    + h * self.v_head_dim * d + qr + kvr)
        n = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
             + self.num_heads * hd * d)
        if self.qkv_bias:
            n += (self.num_heads + 2 * self.num_kv_heads) * hd
        if self.qk_norm:
            n += 2 * hd
        return n

    def _mlp_params(self) -> int:
        return self.d_model * self.d_ff * (3 if self.mlp_gated else 2)

    def _layer_params(self, kind: str, active_only: bool = False) -> int:
        """One layer of ``kind`` (a shared block's occurrence: its norms
        and LoRA only; an MoE layer's routed top-k experts only with
        ``active_only``)."""
        d = self.d_model
        if kind == "rwkv":       # rwkv_init's leaves, two norms
            return (6 * d + 2 * d * _DECAY_LORA + d + 5 * d * d + d + 2 * d
                    + 2 * d * self.d_ff + d * d + 2 * d)
        if kind == "mamba":      # mamba_init's leaves, one norm
            d_in = self.ssm_expand * d
            h = d_in // self.ssm_head_dim
            conv = d_in + 2 * self.ssm_state_dim
            return (d * (2 * d_in + 2 * self.ssm_state_dim + h)
                    + self.ssm_conv_width * conv + conv + 3 * h + d_in
                    + d_in * d + d)
        if kind == "shared_attn":
            r = self.shared_block_lora_rank
            qkv = (self.num_heads + 2 * self.num_kv_heads) * self.head_dim
            return 2 * d + (d * r + r * qkv if r else 0)
        if kind == "moe":        # attention, norms, experts, router
            expert = d * self.moe_d_ff * (3 if self.mlp_gated else 2)
            routed = (self.experts_per_token if active_only
                      else self.num_experts)
            return (self._attn_params() + 2 * d
                    + (routed + self.num_shared_experts) * expert
                    + d * self.num_experts)
        return self._attn_params() + self._mlp_params() + 2 * d
