"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned nemotron (squared-ReLU MLP).  [arXiv:2407.14679; hf]

Port of ``repro/configs/minitron_4b.py``, a copy."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense", num_layers=32, d_model=3072,
    num_heads=24, num_kv_heads=8, head_dim=128, d_ff=9216,
    vocab_size=256000, mlp_variant="relu2", tie_embeddings=False,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=96, num_heads=6, num_kv_heads=2,
    head_dim=16, d_ff=192, vocab_size=512)
