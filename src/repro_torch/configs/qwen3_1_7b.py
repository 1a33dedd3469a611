"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, qk_norm, GQA.  Port of ``repro/configs/qwen3_1_7b.py``."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense", num_layers=28, d_model=2048,
    num_heads=16, num_kv_heads=8, head_dim=128, d_ff=6144,
    vocab_size=151936, qk_norm=True, mlp_variant="swiglu",
    rope_theta=1_000_000.0, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=128, vocab_size=512)
