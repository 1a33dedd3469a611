"""Data pipeline of the port (port of ``repro/data``)."""
from .pipeline import (BinTokenDataset, DataConfig, Prefetcher, SyntheticLM,
                       write_bin)

__all__ = ["BinTokenDataset", "DataConfig", "Prefetcher", "SyntheticLM",
           "write_bin"]
