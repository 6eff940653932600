"""musicgen-medium: decoder-only over EnCodec RVQ tokens.

[arXiv:2306.05284] 48L d_model=1536 24H (kv=24, head_dim=64) d_ff=6144
vocab=2048 per codebook, 4 codebooks with the delay interleaving pattern
(applied by the data-pipeline stub, ``models.stubs``). Non-gated GELU
FFN. The same shapes as ``repro.configs.musicgen_medium``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    num_codebooks=4,
    mlp_gated=False,
    act_fn="gelu",
    rope_theta=1e4,
)

SMOKE = ArchConfig(
    name="musicgen-smoke", family="audio", num_layers=3, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=160, vocab_size=64,
    num_codebooks=4, mlp_gated=False, act_fn="gelu", dtype="float32",
)
