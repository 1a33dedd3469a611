"""Model configuration for all supported architecture families.

Port of ``repro/models/config.py`` (``ModelConfig`` :16), a copy: the port
imports nothing of the JAX package."""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "encoder", "vlm", "moe", "xlstm", "hybrid"]

# Global chunk size for all time-axis loops (attention q-chunks, mLSTM /
# sLSTM chunkwise scans).  Keeping it uniform makes every depth-1 while loop
# in the lowered HLO have trip count S/CHUNK — the roofline accounting
# relies on this convention (see launch/roofline.py).
CHUNK = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention
    qk_norm: bool = False
    # per-layer block pattern, cycled: "global" | "local" | "recurrent"
    # | "mlstm" | "slstm"
    block_pattern: tuple[str, ...] = ("global",)
    # unscanned leading layers (kimi's dense-FFN first layer, griffin's
    # leading recurrent pair); for MoE families prefix blocks use the dense
    # d_ff MLP instead of the MoE.
    prefix_pattern: tuple[str, ...] = ()
    window_size: int = 4096
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0
    parallel_block: bool = False          # command-r style attn ∥ mlp

    # mlp
    mlp_variant: str = "swiglu"           # swiglu | geglu | gelu | relu2

    # moe
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0                     # per-expert hidden dim
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # hybrid (RG-LRU)
    lru_width: int = 0

    # xlstm
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0

    # embeddings / output
    tie_embeddings: bool = True
    frontend: str | None = None           # None | "vision" | "audio"
    causal: bool = True

    # numerics
    param_dtype: str = "float32"          # float32 | bfloat16
    # bfloat16 | int8 (per-token-head scales) | apack-int8 (int8 compute
    # view + paged APack-compressed off-chip storage, serve-layer only)
    kv_cache_dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    @property
    def is_encoder(self) -> bool:
        return self.family == "encoder"

    @property
    def kv_int8(self) -> bool:
        """int8 KV compute path (both the raw and the APack-paged modes —
        the compressed storage layer is transparent to the block math)."""
        return self.kv_cache_dtype in ("int8", "apack-int8")

    @property
    def cycle(self) -> tuple[str, ...]:
        return self.block_pattern

    @property
    def n_cycles(self) -> int:
        layers = self.num_layers - len(self.prefix_pattern)
        assert layers % len(self.cycle) == 0, (
            f"{self.name}: {layers} scanned layers not divisible by "
            f"pattern {self.cycle}")
        return layers // len(self.cycle)

    def _layer_params(self, kind: str, *, moe: bool) -> int:
        d, dh = self.d_model, self.head_dim
        p = 2 * d                                      # two norms
        if kind in ("global", "local"):
            p += d * self.num_heads * dh + 2 * d * self.num_kv_heads * dh
            p += self.num_heads * dh * d
            if self.qk_norm:
                p += 2 * dh
        elif kind == "recurrent":
            w = self.lru_width or d
            p += 2 * d * w + w * d + 4 * w + 3 * w     # proj + conv + gates
        elif kind == "mlstm":
            f = int(self.mlstm_proj_factor * d)
            h = max(self.num_heads, 1)
            p += 2 * d * f + f * d + 3 * f * (f // h) + 2 * f + f
        elif kind == "slstm":
            h = max(self.num_heads, 1)
            f = int(self.slstm_proj_factor * d)
            p += 4 * d * d + 4 * h * (d // h) ** 2 + 2 * d * f + f * d + d
        if kind in ("global", "local", "recurrent"):
            if moe:
                p += d * self.num_experts              # router
                p += self.num_experts * 3 * d * self.moe_d_ff
                p += self.n_shared_experts * 3 * d * self.moe_d_ff
            elif self.d_ff > 0:
                mult = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
                p += mult * d * self.d_ff
        return p

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS in the roofline)."""
        n = self.vocab_size * self.d_model             # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        moe = self.num_experts > 0
        for kind in self.prefix_pattern:               # prefix uses dense ffn
            n += self._layer_params(kind, moe=False)
        for kind in self.cycle:
            n += self._layer_params(kind, moe=moe) * self.n_cycles
        return n + self.d_model                        # final norm

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared experts only)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        moe_layers = self.num_layers - len(self.prefix_pattern)
        inactive = (self.num_experts - self.num_experts_per_tok)
        per_expert = 3 * self.d_model * self.moe_d_ff
        return full - moe_layers * inactive * per_expert


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the dry run (``ShapeConfig`` :145)."""
    name: str
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
