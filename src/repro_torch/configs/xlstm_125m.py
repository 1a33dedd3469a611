"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304 — alternating
mLSTM/sLSTM blocks (xLSTM[1:1]).  Port of ``repro/configs/xlstm_125m.py``."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="xlstm", num_layers=12, d_model=768,
    num_heads=4, num_kv_heads=4, head_dim=192, d_ff=0, vocab_size=50304,
    block_pattern=("mlstm", "slstm"), tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=16, vocab_size=512)
