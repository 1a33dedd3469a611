"""Architecture registry of the port: ``get_config(name)`` /
``get_smoke_config(name)``.  Port of ``repro/configs/__init__.py``; it holds
only the architectures the port serves so far, plus the synthetic
``hetero-serve-smoke`` stack (``get_hetero_smoke_config``, :48)."""
from __future__ import annotations

import dataclasses

from . import qwen3_1_7b, recurrentgemma_9b

_ARCHS = {"qwen3-1.7b": qwen3_1_7b, "qwen3_1_7b": qwen3_1_7b,
          "recurrentgemma-9b": recurrentgemma_9b,
          "recurrentgemma_9b": recurrentgemma_9b}


def _module(name: str):
    if name not in _ARCHS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (ROADMAP open item "
            "1.9, remaining architectures); the port serves "
            "qwen3-1.7b, recurrentgemma-9b and hetero-serve-smoke")
    return _ARCHS[name]


def get_config(name: str):
    if name == "hetero-serve-smoke":        # synthetic, smoke-sized only
        return get_hetero_smoke_config()
    return _module(name).CONFIG


def get_smoke_config(name: str):
    if name == "hetero-serve-smoke":
        return get_hetero_smoke_config()
    return _module(name).SMOKE


def get_hetero_smoke_config():
    """Synthetic heterogeneous serving smoke: one cycle of global +
    rolling-window + recurrent blocks after a recurrent prefix layer, with
    a window small enough that rolling-page eviction triggers within a few
    dozen decode steps."""
    return dataclasses.replace(
        qwen3_1_7b.SMOKE, name="hetero-serve-smoke", family="hybrid",
        num_layers=4, block_pattern=("global", "local", "recurrent"),
        prefix_pattern=("recurrent",), window_size=8, lru_width=64)
