"""Block-wise int8 gradient quantization with error feedback.

Port of ``repro/train/compress_grads.py``: ``quantize_blockwise`` :41,
``dequantize_blockwise`` :53, the int8 mean-all-reduce with error
feedback ``compressed_psum_mean`` :58 and ``init_error_feedback`` :98.
The arithmetic follows the reference as ``compressed_psum_mean`` runs it,
eagerly: a block's scale divides its absmax by 127.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.core import quant
from repro_torch.models import sharding as shd

F32 = torch.float32
BLOCK = 512


def quantize_blockwise(g: torch.Tensor):
    """``(q int8 [n_blocks, 512], scale f32 [n_blocks], n)`` of the
    flattened ``g``, zero-padded to whole blocks."""
    flat = g.reshape(-1).to(F32)
    n = flat.shape[0]
    pad = (-n) % BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = quant.true_divide(
        torch.clamp_min(blocks.abs().amax(1, keepdim=True), 1e-20), 127.0)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0], n


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, n: int,
                         shape) -> torch.Tensor:
    return (q.to(F32) * scale[:, None]).reshape(-1)[:n].reshape(shape)


def compressed_psum_mean(grads: list, mesh, axes: tuple, error=None):
    """Mean-all-reduce gradient trees across the replicas of ``axes``, int8
    on the wire (``compressed_psum_mean`` :58-92).

    ``grads`` holds one gradient tree a replica, ``error`` (or None) one
    error-feedback tree a replica, in the order of the mesh's devices over
    ``axes``.  For each leaf each replica adds its error feedback,
    quantizes blockwise and keeps what the quantization lost as its new
    feedback; the replicas' block scales are unified by a ``pmax``, each
    payload requantized to the common scale, the int8 payloads summed in
    int32 (``psum``), dequantized and divided by the replica count.
    Returns ``(means, new_errors)``, a tree each a replica; each replica's
    mean is on its device."""
    n_dev = 1
    for a in axes:
        n_dev *= dict(mesh.shape)[a]
    if len(grads) != n_dev:
        raise ValueError(f"{len(grads)} gradient trees for {n_dev} "
                         f"replicas over {tuple(axes)}")
    errors = error if error is not None else [None] * n_dev
    flat = [tree.flatten(g) for g in grads]
    flat_e = [tree.flatten(e)[0] if e is not None else None for e in errors]
    treedef = flat[0][1]
    means = [[] for _ in range(n_dev)]
    new_err = [[] for _ in range(n_dev)]
    for i in range(len(flat[0][0])):
        qs, scales = [], []
        for r in range(n_dev):
            g = flat[r][0][i].to(F32)
            if flat_e[r] is not None:
                g = g + flat_e[r][i]
            q, scale, n = quantize_blockwise(g)
            new_err[r].append(g - dequantize_blockwise(q, scale, n, g.shape))
            qs.append(q)
            scales.append(scale)
        dev = scales[0].device
        smax = shd.pmax(scales, dev)
        req = [torch.clamp(torch.round(q.to(F32) * (s.to(dev) / smax)[:, None]
                                       .to(q.device)), -127, 127)
               .to(torch.int8) for q, s in zip(qs, scales)]
        tot = shd.psum([x.to(torch.int32) for x in req], dev)
        mean = quant.true_divide(dequantize_blockwise(tot, smax, n, g.shape),
                                 float(n_dev))
        for r in range(n_dev):
            means[r].append(mean.to(flat[r][0][i].device))
    return ([tree.unflatten(treedef, m) for m in means],
            [tree.unflatten(treedef, e) for e in new_err])


def init_error_feedback(grads):
    """Zero f32 error-feedback tensors shaped like ``grads``."""
    return tree.map(lambda g: torch.zeros(g.shape, dtype=F32,
                                          device=g.device), grads)
