"""Serving layer of the port."""
from repro_torch.kernels.decompress_matmul import DEFAULT_WEIGHT_MIN_SIZE

from .engine import (CompressedParams, Request, ServeEngine, compress_params,
                     decompress_params, prefill_bucket)

__all__ = ["CompressedParams", "DEFAULT_WEIGHT_MIN_SIZE", "Request",
           "ServeEngine", "compress_params", "decompress_params",
           "prefill_bucket"]
