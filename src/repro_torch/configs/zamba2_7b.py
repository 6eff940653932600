"""zamba2-7b: Mamba2 trunk + one shared attention block (hybrid).

[arXiv:2411.15242] 81L d_model=3584 32H (kv=32, head_dim=112) d_ff=14336
vocab=32000, ssm_state=64; the shared transformer block recurs every 6
layers with a per-occurrence LoRA on its fused QKV projection. The same
shapes as ``repro.configs.zamba2_7b``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state_dim=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,
    shared_block_lora_rank=128,
    ssm_chunk=64,
    rope_theta=1e4,
)

SMOKE = ArchConfig(
    name="zamba2-smoke", family="hybrid", num_layers=6, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=160, vocab_size=512,
    ssm_state_dim=16, ssm_head_dim=16, shared_attn_every=3,
    shared_block_lora_rank=8, ssm_chunk=8, dtype="float32",
)
