"""deepseek-v3-671b: MLA, 256 routed experts with a shared one, MTP.

[arXiv:2412.19437] 61 layers, d_model 7168, 128 heads; MLA with q_lora
1536, kv_lora 512, nope 128, rope 64, v 128; expert d_ff 2048, vocab
129,280; 1 shared + 256 routed experts, top 8; the first 3 layers dense
(d_ff 18,432, the hf config); MTP depth 1. The JAX package's config,
field for field.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,      # MLA: every head reads the one latent cache
    head_dim=128,
    d_ff=18432,            # the dense layers' width (the first 3)
    vocab_size=129280,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    num_experts=256,
    experts_per_token=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    num_dense_layers=3,
    mtp_depth=1,
    moe_dispatch="sort",
    rope_theta=1e4,
)

SMOKE = ArchConfig(
    name="deepseek-smoke", family="moe", num_layers=3, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=192, vocab_size=512,
    use_mla=True, q_lora_rank=32, kv_lora_rank=24, qk_nope_dim=16,
    qk_rope_dim=8, v_head_dim=16, num_experts=8, experts_per_token=2,
    num_shared_experts=1, moe_d_ff=96, num_dense_layers=1, mtp_depth=1,
    moe_dispatch="sort", dtype="float32",
)

RULES = {"moe_ff": "data"}   # FSDP the expert d_ff axis
