"""AdamW with optional block-wise 8-bit moments, over the port's param
trees.

Port of ``repro/train/optimizer.py``: ``AdamWConfig`` :26, ``Q8`` :40,
``_block_of`` :53, ``_q8_encode``/``_q8_decode`` :57/:67, ``lr_schedule``
:74, ``init_state`` :82, ``global_norm`` :95 and ``apply_updates`` :100.
The moments of a parameter are a ``Q8`` of the parameter's own shape, int8
with one f32 absmax scale per block of 32 along the last axis, so they
equal the JAX package's once its layer stacks are unstacked.

The arithmetic follows the compiled reference (``jax.jit`` of the train
step): XLA turns a division by a constant into a multiply by its f32
reciprocal (``/ 127``, ``/ warmup``), and keeps a division by a computed
value (the bias corrections, the clip).  A Python number over a tensor is
written as a tensor quotient: PyTorch's ``1.0 / t`` is a reciprocal then a
multiply.  Every update builds new tensors and writes none in place, so a
checkpoint's snapshot of the state before a step stays as it was.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import tree

F32 = torch.float32
BLOCK = 32             # elements per quantization block (``BLOCK`` :21)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"       # float32 | int8


class Q8(NamedTuple):
    """Block-quantized tensor: the int8 payload ``q`` in the source's shape
    (blocks along the last axis) and the f32 absmax ``scale`` per block."""
    q: torch.Tensor
    scale: torch.Tensor


def _recip(d: float) -> float:
    """The f32 reciprocal XLA multiplies by where the reference divides by
    the constant ``d``."""
    return float(np.float32(1.0) / np.float32(d))


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once (``addcmul``), where the compiled
    reference's ``a * b + c`` is contracted into a fused multiply-add; a
    Python number among ``a``, ``c`` is taken as f32."""
    t = b if isinstance(b, torch.Tensor) else a
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(t, a)
    if not isinstance(c, torch.Tensor):
        c = torch.full_like(t, c)
    return torch.addcmul(c, a, b)


def _block_of(last: int) -> int:
    return BLOCK if last >= BLOCK and last % BLOCK == 0 else max(last, 1)


def _q8_encode(x: torch.Tensor) -> Q8:
    xf = x.to(F32)
    last = xf.shape[-1] if xf.dim() else 1
    blk = _block_of(last)
    blocks = xf.reshape(*xf.shape[:-1], max(last // blk, 1), blk)
    scale = torch.clamp_min(blocks.abs().amax(-1) * _recip(127.0), 1e-20)
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    return Q8(q=q.reshape(xf.shape).to(torch.int8), scale=scale)


def _q8_decode(s: Q8, shape) -> torch.Tensor:
    last = s.q.shape[-1] if s.q.dim() else 1
    blk = _block_of(last)
    blocks = s.q.to(F32).reshape(*s.q.shape[:-1], max(last // blk, 1), blk)
    return (blocks * s.scale[..., None]).reshape(shape)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio``, in f32."""
    s = step.to(F32)
    warm = torch.clamp_max(s * _recip(max(cfg.warmup_steps, 1)), 1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    * _recip(max(cfg.total_steps - cfg.warmup_steps, 1)),
                    0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(float(np.float32(math.pi)) * t))
    # XLA's CPU backend contracts ``min + (1 - min) * cos`` into an FMA
    return cfg.lr * warm * _fma(1.0 - cfg.min_lr_ratio, cos,
                                cfg.min_lr_ratio)


def init_state(cfg: AdamWConfig, params) -> dict:
    """Zero moments (``Q8`` of zeros with ``state_dtype="int8"``) and a
    step counter, on the params' device."""
    def zeros_like_state(p):
        z = torch.zeros(p.shape, dtype=F32, device=p.device)
        return _q8_encode(z) if cfg.state_dtype == "int8" else z

    dev = tree.leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree.map(zeros_like_state, params),
            "v": tree.map(zeros_like_state, params)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, summed leaf by leaf in
    the tree's order (the reference sums its stacked leaves in its own
    order, so the last bits can part)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in tree.leaves(grads)))


def apply_updates(cfg: AdamWConfig, params, grads, state: dict):
    """One AdamW step (decoupled weight decay on matrices only, the
    gradient clipped to ``grad_clip`` by its global norm).  Returns
    ``(params, state, metrics)``, all new tensors."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp_max(torch.full_like(gnorm, cfg.grad_clip)
                           / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = lr_schedule(cfg, step)
    sf = step.to(F32)
    b1c = 1.0 - torch.pow(torch.full_like(sf, cfg.b1), sf)
    b2c = 1.0 - torch.pow(torch.full_like(sf, cfg.b2), sf)
    q8 = cfg.state_dtype == "int8"

    def upd(p, g, m, v):
        g = g.to(F32) * clip
        mf = _q8_decode(m, p.shape) if q8 else m
        vf = _q8_decode(v, p.shape) if q8 else v
        # the compiled reference contracts these into FMAs (``_fma``)
        mf = _fma(cfg.b1, mf, (1.0 - cfg.b1) * g)
        vf = _fma(cfg.b2, vf, (1.0 - cfg.b2) * torch.square(g))
        delta = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
        if p.dim() >= 2:                  # decoupled decay, matrices only
            delta = delta + cfg.weight_decay * p.to(F32)
        new_p = _fma(-lr, delta, p.to(F32)).to(p.dtype)
        if q8:
            return new_p, _q8_encode(mf), _q8_encode(vf)
        return new_p, mf, vf

    flat_p, spec = tree.flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, tree.leaves(grads), _moments(state["m"]),
        _moments(state["v"]))]
    new_p, new_m, new_v = (tree.unflatten(spec, [o[i] for o in out])
                           for i in range(3))
    return new_p, {"step": step, "m": new_m, "v": new_v}, \
        {"grad_norm": gnorm, "lr": lr}


def _moments(t) -> list:
    """The moment of every param leaf, in the params' order (a ``Q8`` as
    one leaf)."""
    return tree.leaves(t, is_leaf=lambda x: isinstance(x, Q8))
