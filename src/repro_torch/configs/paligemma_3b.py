"""paligemma-3b [vlm] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216 — SigLIP vision frontend is a stub (precomputed patch
embeddings); gemma text backbone.  [arXiv:2407.07726; hf]

Port of ``repro/configs/paligemma_3b.py``, a copy."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm", num_layers=18, d_model=2048,
    num_heads=8, num_kv_heads=1, head_dim=256, d_ff=16384,
    vocab_size=257216, mlp_variant="geglu", frontend="vision",
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
    head_dim=16, d_ff=128, vocab_size=512)
