"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) vocab=163840,
MoE 384 experts top-8 + 1 shared, expert d_ff=2048, first layer dense
(d_ff=18432) — trillion-param MoE.  [arXiv:2501.kimi2; unverified]

Note: the assignment table specifies GQA kv=8 (the released model uses
MLA); we follow the assignment.

Port of ``repro/configs/kimi_k2_1t_a32b.py``, a copy."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe", num_layers=61, d_model=7168,
    num_heads=64, num_kv_heads=8, head_dim=112, d_ff=18432,
    vocab_size=163840, mlp_variant="swiglu", num_experts=384,
    num_experts_per_tok=8, moe_d_ff=2048, n_shared_experts=1,
    prefix_pattern=("global",), tie_embeddings=False, param_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=128, num_experts=8, num_experts_per_tok=2,
    moe_d_ff=32, n_shared_experts=1, prefix_pattern=("global",), vocab_size=512,
    param_dtype="float32")
