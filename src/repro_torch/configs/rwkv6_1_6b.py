"""rwkv6-1.6b: Finch, attention-free, data-dependent decay.

[arXiv:2404.05892] 24L d_model=2048 d_ff=7168 vocab=65536; 64-wide WKV
heads. The same shapes as ``repro.configs.rwkv6_1_6b``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,          # d_model / ssm_head_dim (WKV heads)
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    ssm_head_dim=64,
    rwkv_chunk=16,
)

SMOKE = ArchConfig(
    name="rwkv6-smoke", family="ssm", num_layers=3, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=160, vocab_size=512,
    ssm_head_dim=16, rwkv_chunk=8, dtype="float32",
)
