"""kimi-k2-1t-a32b: a trillion-parameter mixture of experts.

[Kimi K2] 61 layers, d_model 7168, 64 heads over 8 KV heads (GQA,
head_dim 128), expert d_ff 2048, vocab 163,840; 384 routed experts, top
8, and 1 shared; the first layer dense. 1.03e12 parameters, ~32e9
active a token. The JAX package's config, field for field.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,             # the dense layer's and the shared expert's width
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    num_dense_layers=1,
    moe_dispatch="sort",
    rope_theta=5e4,
)

SMOKE = ArchConfig(
    name="kimi-smoke", family="moe", num_layers=3, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=96, vocab_size=512,
    num_experts=8, experts_per_token=2, num_shared_experts=1, moe_d_ff=96,
    num_dense_layers=1, moe_dispatch="sort", dtype="float32",
)

RULES = {"moe_ff": "data"}   # FSDP the expert d_ff axis
