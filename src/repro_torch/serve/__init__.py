"""Serving layer of the port."""
from repro_torch.kernels.decompress_matmul import DEFAULT_WEIGHT_MIN_SIZE
from repro_torch.models.modules import PageIntegrityError, TransferDropped

from .engine import (AdmissionImpossible, CompressedParams, Request,
                     ServeEngine, compress_params, decompress_params,
                     prefill_bucket)
from .faults import FaultInjector

__all__ = ["AdmissionImpossible", "CompressedParams",
           "DEFAULT_WEIGHT_MIN_SIZE", "FaultInjector", "PageIntegrityError",
           "Request", "ServeEngine", "TransferDropped", "compress_params",
           "decompress_params", "prefill_bucket"]
