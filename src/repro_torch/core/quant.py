"""Symmetric and affine quantization and the two's-complement views between
signed int8/int16 and the APack value space.

Port of ``repro/core/quant.py`` (``QuantParams`` :29, ``quantize_symmetric``
:49, ``dequantize_symmetric`` :60, ``quantize_affine`` :64,
``dequantize_affine`` :81, ``to_unsigned`` :85, ``from_unsigned`` :98) on
torch tensors and numpy arrays.  APack codes values in
``[0, 2^B)``; a signed int8 ``v`` maps to ``v & 0xFF`` so small positives
stay near 0 and small negatives land near 255 (paper Fig. 2's bimodal
shape).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QuantParams:
    """Metadata needed to invert a quantization."""

    scale: torch.Tensor       # broadcastable against the tensor
    zero_point: torch.Tensor  # same; 0 for symmetric
    bits: int = 8
    signed: bool = True
    axis: int | None = None   # per-channel axis, None = per-tensor


def true_divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, as numpy and an eager JAX call round it.  On
    CUDA, PyTorch turns a division by a Python number into a multiply by
    its reciprocal (``div_true_kernel_cuda``), which can differ in the last
    bit; a tensor divisor keeps the division on every device."""
    return x / torch.full_like(x, d)


def _absmax(x: torch.Tensor, axis: int | None) -> torch.Tensor:
    if axis is None:
        return x.abs().amax()
    red = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    return x.abs().amax(dim=red, keepdim=True)


def quantize_symmetric(x: torch.Tensor, bits: int = 8,
                       axis: int | None = None):
    """Symmetric signed quantization to ``bits`` (stored in int8/int16).

    ``scale = max(amax, 1e-12) / qmax`` is a true division
    (:func:`true_divide`, on every device): the JAX package calls this
    eagerly (``model._pack_quantize``, ``serve.compress_params``), and the
    eager call is not rewritten into a reciprocal multiply as the compiled
    KV quantizer is.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    qmax = 2 ** (bits - 1) - 1
    amax = _absmax(x, axis)
    scale = true_divide(torch.clamp_min(amax, 1e-12), qmax)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    dtype = torch.int8 if bits <= 8 else torch.int16
    return q.to(dtype), QuantParams(scale=scale,
                                    zero_point=torch.zeros_like(scale),
                                    bits=bits, signed=True, axis=axis)


def dequantize_symmetric(q: torch.Tensor, params: QuantParams) -> torch.Tensor:
    return q.to(torch.float32) * params.scale


def quantize_affine(x: torch.Tensor, bits: int = 8, axis: int | None = None):
    """Affine (asymmetric) quantization to unsigned ``bits`` (uint8, or
    ``torch.uint16`` above 8 bits).  True divisions, as the eager JAX call
    makes them."""
    qmax = 2 ** bits - 1
    if axis is None:
        lo, hi = x.amin(), x.amax()
    else:
        red = tuple(i for i in range(x.dim()) if i != axis % x.dim())
        lo = x.amin(dim=red, keepdim=True)
        hi = x.amax(dim=red, keepdim=True)
    scale = true_divide(torch.clamp_min(hi - lo, 1e-12), qmax)
    zp = torch.round(-lo / scale)
    q = torch.clamp(torch.round(x / scale) + zp, 0, qmax)
    dtype = torch.uint8 if bits <= 8 else torch.uint16
    return q.to(dtype), QuantParams(scale=scale, zero_point=zp, bits=bits,
                                    signed=False, axis=axis)


def dequantize_affine(q: torch.Tensor, params: QuantParams) -> torch.Tensor:
    return (q.to(torch.float32) - params.zero_point) * params.scale


def to_unsigned(q, bits: int = 8):
    """Signed ``q`` -> uint value space (numpy in, numpy out; torch in,
    torch ``int32`` out, since torch has no uint16)."""
    mask = (1 << bits) - 1
    if isinstance(q, np.ndarray):
        return (q.astype(np.int64) & mask).astype(
            np.uint16 if bits > 8 else np.uint8)
    return q.to(torch.int32) & mask


def from_unsigned(u, bits: int = 8, signed: bool = True):
    """Inverse of :func:`to_unsigned`."""
    if isinstance(u, np.ndarray):
        v = u.astype(np.int64)
        if signed:
            half = 1 << (bits - 1)
            v = np.where(v >= half, v - (1 << bits), v)
        return v.astype(np.int8 if bits <= 8 else np.int16) if signed else u
    if not signed:
        return u
    v = u.to(torch.int32)
    v = torch.where(v >= (1 << (bits - 1)), v - (1 << bits), v)
    return v.to(torch.int8 if bits <= 8 else torch.int16)
