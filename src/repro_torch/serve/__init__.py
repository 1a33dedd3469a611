"""Serving layer of the port."""
from .engine import Request, ServeEngine, prefill_bucket

__all__ = ["Request", "ServeEngine", "prefill_bucket"]
