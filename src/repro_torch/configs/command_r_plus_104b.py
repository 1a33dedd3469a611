"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias, parallel attn||mlp blocks.
[hf:CohereForAI/c4ai-command-r-v01; unverified]

Port of ``repro/configs/command_r_plus_104b.py``, a copy."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense", num_layers=64,
    d_model=12288, num_heads=96, num_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256000, mlp_variant="swiglu",
    parallel_block=True, tie_embeddings=True, param_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    head_dim=16, d_ff=256, vocab_size=512, param_dtype="float32")
