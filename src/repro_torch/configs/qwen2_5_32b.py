"""qwen2.5-32b: GQA with QKV bias.

[hf:Qwen/Qwen2.5-*] 64L d_model=5120 40H (GQA kv=8, head_dim=128)
d_ff=27648 vocab=152064, untied head. The same shapes as
``repro.configs.qwen2_5_32b``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="qwen2.5-smoke", family="dense", num_layers=3, d_model=64,
    num_heads=5, num_kv_heads=1, head_dim=16, d_ff=160, vocab_size=512,
    qkv_bias=True, rope_theta=1e6, dtype="float32",
)
