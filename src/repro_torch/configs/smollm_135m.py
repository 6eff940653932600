"""smollm-135m: a small llama-architecture model.

[hf:HuggingFaceTB/SmolLM-135M] 30 layers, d_model 576, 9 heads (GQA kv=3,
head_dim 64), d_ff 1536, vocab 49152, tied embeddings. The same shapes as
``repro.configs.smollm_135m``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    rope_theta=1e4,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="smollm-smoke", family="dense", num_layers=3, d_model=48,
    num_heads=3, num_kv_heads=1, head_dim=16, d_ff=128, vocab_size=512,
    tie_embeddings=True, dtype="float32",
)
