"""Block-wise int8 gradient quantization with error feedback.

Port of ``repro/train/compress_grads.py``: ``quantize_blockwise`` :41,
``dequantize_blockwise`` :53 and ``init_error_feedback`` :98.  The
mean-all-reduce that ships the int8 payload between devices,
``compressed_psum_mean`` :58, needs a mesh, which the port does not have
yet: it raises naming its ROADMAP item.  The arithmetic follows the
compiled reference (``/ 127`` as a multiply by its f32 reciprocal).
"""
from __future__ import annotations

import torch

from repro_torch import tree

from .optimizer import _recip

F32 = torch.float32
BLOCK = 512


def quantize_blockwise(g: torch.Tensor):
    """``(q int8 [n_blocks, 512], scale f32 [n_blocks], n)`` of the
    flattened ``g``, zero-padded to whole blocks."""
    flat = g.reshape(-1).to(F32)
    n = flat.shape[0]
    pad = (-n) % BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.clamp_min(blocks.abs().amax(1, keepdim=True),
                            1e-20) * _recip(127.0)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0], n


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, n: int,
                         shape) -> torch.Tensor:
    return (q.to(F32) * scale[:, None]).reshape(-1)[:n].reshape(shape)


def compressed_psum_mean(grads, *args, **kwargs):
    """The int8 mean-all-reduce across devices needs a mesh (ROADMAP open
    item 1.10, multi-device serving and training)."""
    raise NotImplementedError(
        "compressed_psum_mean needs a device mesh, which is not ported yet "
        "(ROADMAP open item 1.10, multi-device)")


def init_error_feedback(grads):
    """Zero f32 error-feedback tensors shaped like ``grads``."""
    return tree.map(lambda g: torch.zeros(g.shape, dtype=F32,
                                          device=g.device), grads)
