"""AdamW with optional block-wise 8-bit moments, over the port's param
trees.

Port of ``repro/train/optimizer.py``: ``AdamWConfig`` :26, ``Q8`` :40,
``_block_of`` :53, ``_q8_encode``/``_q8_decode`` :57/:67, ``lr_schedule``
:74, ``init_state`` :82, ``global_norm`` :95 and ``apply_updates`` :100.
The moments of a parameter are a ``Q8`` of the parameter's own shape, int8
with one f32 absmax scale per block of 32 along the last axis, so they
equal the JAX package's once its layer stacks are unstacked.

On a mesh (params of ``sharding.Sharded`` leaves, placed by
``param_shardings``) the state is ZeRO-sharded as the reference's moments
inherit the param shardings (:1-10): each moment lies as its param, and
each device updates its own blocks.  A ``Q8`` block must not straddle
two shards (``BLOCK`` :21): where a shard of the last axis is not a
whole number of blocks, that leaf's scales are held whole over the last
axis and its update runs on the gathered leaf, as GSPMD's resharding
would.  The clipping norm sums each block's squares in a fixed order.

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
from repro_torch.models.sharding import NamedSharding, Sharded, fit_spec

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
    step counter, on the params' device; for params on a mesh, moments
    laid out as their params and the counter replicated."""
    def zeros_like_state(p):
        if isinstance(p, Sharded):
            return _sharded_zeros(cfg, p)
        z = torch.zeros(p.shape, dtype=F32, device=p.device)
        return _q8_encode(z) if cfg.state_dtype == "int8" else z

    first = tree.leaves(params)[0]
    if isinstance(first, Sharded):
        step = Sharded.place(torch.zeros((), dtype=torch.int32),
                             NamedSharding(first.mesh, ()))
    else:
        step = torch.zeros((), dtype=torch.int32, device=first.device)
    return {"step": step,
            "m": tree.map(zeros_like_state, params),
            "v": tree.map(zeros_like_state, params)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, summed leaf by leaf in
    the tree's order (the reference sums its stacked leaves in its own
    order, so the last bits can part); a ``Sharded`` leaf's blocks summed
    in mesh order onto its mesh's first device (``psum``)."""
    def sq(x):
        if isinstance(x, Sharded):
            lead = x.mesh.devices.flat[0]
            return sum(torch.sum(torch.square(x.blocks[i].to(F32))).to(lead)
                       for i in x.owners)
        return torch.sum(torch.square(x.to(F32)))
    return torch.sqrt(sum(sq(x) for x in tree.leaves(grads)))


def _adamw(cfg: AdamWConfig, p, g, m, v, clip, lr, b1c, b2c):
    """One leaf's (or block's) AdamW update; the step's scalars on its
    device.  Returns ``(p, m, v)``, new tensors."""
    q8 = cfg.state_dtype == "int8"
    g = g.to(F32) * clip
    mf = _q8_decode(m, p.shape) if q8 else m
    vf = _q8_decode(v, p.shape) if q8 else v
    # the compiled reference contracts these into FMAs (``_fma``)
    mf = _fma(cfg.b1, mf, (1.0 - cfg.b1) * g)
    vf = _fma(cfg.b2, vf, (1.0 - cfg.b2) * torch.square(g))
    delta = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
    if p.dim() >= 2:                      # decoupled decay, matrices only
        delta = delta + cfg.weight_decay * p.to(F32)
    new_p = _fma(-lr, delta, p.to(F32)).to(p.dtype)
    if q8:
        return new_p, _q8_encode(mf), _q8_encode(vf)
    return new_p, mf, vf


def apply_updates(cfg: AdamWConfig, params, grads, state: dict):
    """One AdamW step (decoupled weight decay on matrices only, the
    gradient clipped to ``grad_clip`` by its global norm).  Returns
    ``(params, state, metrics)``, all new tensors; on a mesh, in the
    params' and state's layout (``_apply_sharded``)."""
    flat_p, spec = tree.flatten(params)
    sharded = isinstance(flat_p[0], Sharded)
    step = (state["step"].gather() if sharded else state["step"]) + 1
    gnorm = global_norm(grads)
    clip = torch.clamp_max(torch.full_like(gnorm, cfg.grad_clip)
                           / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = lr_schedule(cfg, step)
    sf = step.to(F32)
    b1c = 1.0 - torch.pow(torch.full_like(sf, cfg.b1), sf)
    b2c = 1.0 - torch.pow(torch.full_like(sf, cfg.b2), sf)
    scalars = (clip, lr, b1c, b2c)
    one = _apply_sharded if sharded else _adamw
    out = [one(cfg, p, g, m, v, *scalars) for p, g, m, v in zip(
        flat_p, tree.leaves(grads), _moments(state["m"]),
        _moments(state["v"]))]
    new_p, new_m, new_v = (tree.unflatten(spec, [o[i] for o in out])
                           for i in range(3))
    if sharded:
        step = Sharded.place(step, state["step"].sharding)
    return new_p, {"step": step, "m": new_m, "v": new_v}, \
        {"grad_norm": gnorm, "lr": lr}


def _q8_aligned(p: Sharded) -> bool:
    """Whether every ``Q8`` block of ``p`` lies within one shard: the last
    axis whole, or each shard of it a whole number of blocks."""
    entry = p.spec[-1] if p.ndim else None
    if entry in (None, ()):
        return True
    names = entry if isinstance(entry, tuple) else (entry,)
    n = int(np.prod([p.mesh.shape[a] for a in names if a in p.mesh.shape]))
    last = p.shape[-1]
    return _block_of(last) == BLOCK and (last // n) % BLOCK == 0


def _scale_sharding(p: Sharded, scale_shape: tuple) -> NamedSharding:
    """The layout of ``p``'s ``Q8`` scales: ``p``'s spec on the scales'
    shape, the last axis whole where blocks straddle shards."""
    spec = p.spec if _q8_aligned(p) else p.spec[:-1] + (None,)
    return NamedSharding(p.mesh, fit_spec(spec, scale_shape, p.mesh))


def _sharded_zeros(cfg: AdamWConfig, p: Sharded):
    """A zero moment of ``p`` in its layout (``_scale_sharding`` for the
    ``Q8`` scales)."""
    z = torch.zeros(p.shape, dtype=F32, device=p.mesh.devices.flat[0])
    if cfg.state_dtype != "int8":
        return Sharded.place(z, p.sharding)
    e = _q8_encode(z)
    return Q8(q=Sharded.place(e.q, p.sharding),
              scale=Sharded.place(e.scale,
                                  _scale_sharding(p, tuple(e.scale.shape))))


def _q8_sharded(p: Sharded, q: dict, scale: dict) -> Q8:
    """A ``Q8`` of per-block payloads and scales (by owner coordinate) in
    ``p``'s layout."""
    last = p.shape[-1] if p.ndim else 1
    shape = (*p.shape[:-1], max(last // _block_of(last), 1))
    return Q8(q=Sharded.from_owners(Sharded(p.sharding, p.shape, {}), q),
              scale=Sharded.from_owners(
                  Sharded(_scale_sharding(p, shape), shape, {}), scale))


def _apply_sharded(cfg: AdamWConfig, p: Sharded, g: Sharded, m, v, *scalars):
    """``_adamw`` on a leaf of a mesh: block by block on each block's
    device, or on the gathered leaf where ``Q8`` blocks straddle shards
    (the new leaf and moments placed back in their layout)."""
    q8 = cfg.state_dtype == "int8"

    def on(dev):
        return [s.to(dev) for s in scalars]

    if q8 and not _q8_aligned(p):
        lead = p.mesh.devices.flat[0]
        new_p, nm, nv = _adamw(
            cfg, p.gather(lead), g.gather(lead),
            Q8(m.q.gather(lead), m.scale.gather(lead)),
            Q8(v.q.gather(lead), v.scale.gather(lead)), *on(lead))
        return (Sharded.place(new_p, p.sharding),
                *(Q8(Sharded.place(x.q, p.sharding),
                     Sharded.place(x.scale, m.scale.sharding))
                  for x in (nm, nv)))
    out = {}
    for i in p.owners:
        blk = p.blocks[i]
        mi = Q8(m.q.blocks[i], m.scale.blocks[i]) if q8 else m.blocks[i]
        vi = Q8(v.q.blocks[i], v.scale.blocks[i]) if q8 else v.blocks[i]
        out[i] = _adamw(cfg, blk, g.blocks[i], mi, vi, *on(blk.device))
    new_p = Sharded.from_owners(p, {i: o[0] for i, o in out.items()})
    if not q8:
        return (new_p, *(Sharded.from_owners(p, {i: o[k] for i, o in
                                                  out.items()})
                         for k in (1, 2)))
    return (new_p, *(_q8_sharded(p, {i: o[k].q for i, o in out.items()},
                                 {i: o[k].scale for i, o in out.items()})
                     for k in (1, 2)))


def _moments(t) -> list:
    """The moment of every param leaf, in the params' order (a ``Q8`` as
    one leaf)."""
    return tree.leaves(t, is_leaf=lambda x: isinstance(x, Q8))
