"""gemma3-12b: 5:1 local:global attention, 128k context.

[hf:google/gemma-3-*-pt] 48L d_model=3840 16H (GQA kv=8, head_dim=256)
d_ff=15360 vocab=262144; sliding window 1024 on local layers; qk-norm;
rope theta 10k local / 1M global; embeddings scaled by sqrt(d). The same
shapes as ``repro.configs.gemma3_12b``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    local_global_ratio=5,
    sliding_window=1024,
    qk_norm=True,
    rope_theta=1e4,
    rope_theta_global=1e6,
    embed_scale=True,
    act_fn="gelu",
)

SMOKE = ArchConfig(
    name="gemma3-smoke", family="dense", num_layers=6, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=160, vocab_size=512,
    local_global_ratio=5, sliding_window=8, qk_norm=True,
    rope_theta_global=1e6, embed_scale=True, act_fn="gelu", dtype="float32",
)
