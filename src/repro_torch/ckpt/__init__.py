"""Checkpoints of the port (port of ``repro/ckpt``)."""
from .checkpoint import AsyncCheckpointer, latest_step, restore, save

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
