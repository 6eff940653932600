"""granite-8b: llama-architecture code model, tied embeddings.

[arXiv:2405.04324] 36L d_model=4096 32H (GQA kv=8, head_dim=128)
d_ff=14336 vocab=49152. The same shapes as ``repro.configs.granite_8b``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    tie_embeddings=True,
    rope_theta=1e4,
)

SMOKE = ArchConfig(
    name="granite-smoke", family="dense", num_layers=3, d_model=64,
    num_heads=4, num_kv_heads=1, head_dim=16, d_ff=160, vocab_size=512,
    tie_embeddings=True, dtype="float32",
)
