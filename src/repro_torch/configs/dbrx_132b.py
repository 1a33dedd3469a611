"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) vocab=100352,
MoE 16 experts top-4 fine-grained, expert d_ff=10752.
[hf:databricks/dbrx-base; unverified]

Port of ``repro/configs/dbrx_132b.py``, a copy."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe", num_layers=40, d_model=6144,
    num_heads=48, num_kv_heads=8, head_dim=128, d_ff=0,
    vocab_size=100352, mlp_variant="swiglu", num_experts=16,
    num_experts_per_tok=4, moe_d_ff=10752, tie_embeddings=False,
    param_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, num_experts=4, num_experts_per_tok=2, moe_d_ff=64,
    vocab_size=512, param_dtype="float32")
