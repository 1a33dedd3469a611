"""Two's-complement views between signed int8/int16 and the APack value space.

Port of ``repro/core/quant.py`` (``to_unsigned`` :85, ``from_unsigned`` :98)
on torch tensors and numpy arrays.  APack codes values in ``[0, 2^B)``; a
signed int8 ``v`` maps to ``v & 0xFF`` so small positives stay near 0 and
small negatives land near 255 (paper Fig. 2's bimodal shape).
"""
from __future__ import annotations

import numpy as np
import torch


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
