"""Architecture registry of the port: ``get_config(name)`` /
``get_smoke_config(name)`` / ``all_arch_ids()``.  Port of
``repro/configs/__init__.py``; it holds every architecture of the JAX
package, plus the synthetic ``hetero-serve-smoke`` stack
(``get_hetero_smoke_config``, :48)."""
from __future__ import annotations

import dataclasses
import importlib

# assignment ids -> module names (``ALIASES`` :13), the JAX registry's order
ALIASES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "minitron-4b": "minitron_4b",
    "minitron-8b": "minitron_8b",
    "command-r-plus-104b": "command_r_plus_104b",
    "hubert-xlarge": "hubert_xlarge",
    "paligemma-3b": "paligemma_3b",
    "dbrx-132b": "dbrx_132b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "xlstm-125m": "xlstm_125m",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def _module(name: str):
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod not in ALIASES.values():
        raise ValueError(f"unknown architecture {name!r}; expected one of "
                         f"{all_arch_ids()} or hetero-serve-smoke")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str):
    if name == "hetero-serve-smoke":        # synthetic, smoke-sized only
        return get_hetero_smoke_config()
    return _module(name).CONFIG


def get_smoke_config(name: str):
    if name == "hetero-serve-smoke":
        return get_hetero_smoke_config()
    return _module(name).SMOKE


def all_arch_ids() -> list[str]:
    """Every architecture id of the JAX registry (``all_arch_ids`` :42)."""
    return list(ALIASES)


def get_hetero_smoke_config():
    """Synthetic heterogeneous serving smoke: one cycle of global +
    rolling-window + recurrent blocks after a recurrent prefix layer, with
    a window small enough that rolling-page eviction triggers within a few
    dozen decode steps."""
    return dataclasses.replace(
        get_smoke_config("qwen3-1.7b"), name="hetero-serve-smoke",
        family="hybrid", num_layers=4,
        block_pattern=("global", "local", "recurrent"),
        prefix_pattern=("recurrent",), window_size=8, lru_width=64)
