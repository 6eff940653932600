"""phi-3-vision-4.2b: phi3-mini backbone + CLIP frontend (stubbed).

[hf:microsoft/Phi-3-vision-128k-instruct] 32L d_model=3072 32H (kv=32,
head_dim=96) d_ff=8192 vocab=32064. The vision tower is a stub providing
576 precomputed patch embeddings per image (``models.stubs``). The same
shapes as ``repro.configs.phi3_vision_4_2b``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    num_patches=576,
    rope_theta=1e4,
)

SMOKE = ArchConfig(
    name="phi3v-smoke", family="vlm", num_layers=3, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=160, vocab_size=512,
    num_patches=8, dtype="float32",
)
