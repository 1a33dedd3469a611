"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — Griffin: RG-LRU recurrent blocks + local attention 1:2
(pattern recurrent,recurrent,local), window 2048.  [arXiv:2402.19427]

Port of ``repro/configs/recurrentgemma_9b.py``, a copy.  38 layers = 2
leading recurrent layers (unscanned prefix) + 12 cycles of (recurrent,
recurrent, local)."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", num_layers=38,
    d_model=4096, num_heads=16, num_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000, mlp_variant="geglu",
    block_pattern=("recurrent", "recurrent", "local"),
    prefix_pattern=("recurrent", "recurrent"),
    window_size=2048, lru_width=4096, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=5, d_model=64, num_heads=4, num_kv_heads=1,
    head_dim=16, d_ff=128, vocab_size=512, lru_width=64, window_size=32)
