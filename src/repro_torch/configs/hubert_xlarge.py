"""hubert-xlarge [audio] — 48L d_model=1280 16H (kv=16, MHA) d_ff=5120
vocab=504 (cluster units) — encoder-only; conv frame frontend is a stub
(input_specs provides precomputed frame embeddings).  [arXiv:2106.07447]

Port of ``repro/configs/hubert_xlarge.py``, a copy."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder", num_layers=48, d_model=1280,
    num_heads=16, num_kv_heads=16, head_dim=80, d_ff=5120, vocab_size=504,
    mlp_variant="gelu", causal=False, frontend="audio",
    tie_embeddings=False,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=32)
