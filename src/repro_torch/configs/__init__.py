"""Architecture registry of the port: ``get_config(name)`` /
``get_smoke_config(name)``.  Port of ``repro/configs/__init__.py``; it holds
only the architectures the port serves so far."""
from __future__ import annotations

from . import qwen3_1_7b

_ARCHS = {"qwen3-1.7b": qwen3_1_7b, "qwen3_1_7b": qwen3_1_7b}


def _module(name: str):
    if name not in _ARCHS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (ROADMAP open item "
            "1.9, remaining architectures); the port serves qwen3-1.7b")
    return _ARCHS[name]


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).SMOKE
