"""The paper's benchmark model shapes, as ``repro.configs.paper_models``
(not in the architecture registry).

``BERT_BASE`` and ``BERT_LARGE`` carry the shapes of the paper's NLP rows
(Tables 4 and 8): an ungated GELU MLP and an untied LM head, on the
port's decoder trunk. ``TINY_LM`` is the few-M-parameter LM of the
accuracy-trend benchmarks (Tables 4-6, Fig. 7).
"""
from repro_torch.models.common import ArchConfig

BERT_BASE = ArchConfig(
    name="bert_base", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, head_dim=64, d_ff=3072, vocab_size=30522,
    mlp_gated=False, act_fn="gelu",
)

BERT_LARGE = ArchConfig(
    name="bert_large", family="dense", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=16, head_dim=64, d_ff=4096, vocab_size=30522,
    mlp_gated=False, act_fn="gelu",
)

TINY_LM = ArchConfig(
    name="tiny_lm", family="dense", num_layers=4, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=384, vocab_size=512,
    tie_embeddings=True, dtype="float32",
)
