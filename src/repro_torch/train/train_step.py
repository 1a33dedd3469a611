"""Train-step factory: loss, gradients (with microbatch accumulation) and
AdamW, over the port's param trees.

Port of ``repro/train/train_step.py``: ``make_loss_fn`` :23,
``make_train_step`` :30 and ``make_eval_step`` :66.  Gradients come from
``torch.autograd`` through ``model.forward_train``, each layer cycle
recomputed in the backward pass (``remat``), where the reference takes
``jax.value_and_grad`` of its scanned, ``jax.checkpoint``-ed forward.

The step also takes sharded inputs, as the reference's ``jax.jit(step,
in_shardings=...)`` does under ``mesh_context`` (``tests/
test_distributed.py:45-56``): params and optimizer state of
``sharding.Sharded`` leaves placed by ``param_shardings`` (``init_state``
lays the moments out as their params), the batch placed by
``batch_shardings``.  One controller drives every shard
(``model.sharded_loss``): each read of an owner block (a data group's or
a model shard's gather of it) is an autograd leaf of its own, and the
block's gradient is the sum of its reads' gradients in read order
(``sharding.psum``): the data-parallel sum and the reduce-scatter, in
shard order as the reference's ``psum`` is, and never left to
autograd's accumulation, which on several cards adds in the order the
cards finish.  AdamW then updates each device's blocks.  Params and
state come back in the same layout.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree
from repro_torch.launch.mesh import train_grid
from repro_torch.models import model as M
from repro_torch.models.sharding import Sharded, _assemble, books, psum
from repro_torch.models.config import ModelConfig

from . import optimizer as opt

F32 = torch.float32


def make_loss_fn(cfg: ModelConfig) -> Callable:
    """``loss_fn(params, batch)``: the training forward and ``model.
    loss_fn`` on a batch dict (``tokens``, and ``loss_mask``,
    ``patch_embeds``, ``frame_embeds``, ``labels`` where the config takes
    them)."""
    def loss_fn(params, batch):
        logits, aux = M.forward_train(
            cfg, params, batch.get("tokens"),
            patch_embeds=batch.get("patch_embeds"),
            frame_embeds=batch.get("frame_embeds"))
        return M.loss_fn(cfg, logits, batch, aux)
    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)``, the grads a tree
    of the params' structure (zeros where a param took no part)."""
    flat, spec = tree.flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    loss = loss_fn(tree.unflatten(spec, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree.unflatten(spec, grads)


class _Reads(Sharded):
    """A param's owner blocks, read as autograd leaves: every ``assemble``
    (and so every ``gather``) hands out a fresh leaf a block, the block
    itself on its own device or its copy on the reader's, and keeps
    ``(owner, leaf)`` in read order."""

    def __init__(self, like: Sharded):
        super().__init__(like.sharding, like.shape,
                         {i: like.blocks[i].detach() for i in like.owners})
        self.reads: list = []

    @books("all-gather")
    def assemble(self, device, owners: list) -> torch.Tensor:
        pieces = {}
        for idx in owners:
            leaf = self.blocks[idx].to(device).detach().requires_grad_(True)
            self.reads.append((idx, leaf))
            pieces[tuple(s for s, _ in self.slices(idx))] = leaf
        return _assemble(pieces, device)


def sharded_value_and_grad(cfg: ModelConfig, params, rows: list,
                           grid: list):
    """``(loss, grads)`` of ``model.sharded_loss`` over ``params`` (a tree
    of ``Sharded``), ``rows[k]`` data group ``k``'s batch on its lead
    device, ``grid[k]`` its devices by model shard.  The grads are a tree
    of ``Sharded`` holding the owner blocks only (zeros where a block
    took no part): each the shard-order sum (``psum``, on the block's
    device) of its reads' gradients."""
    flat, spec = tree.flatten(params)
    taps = [_Reads(x) for x in flat]
    loss = M.sharded_loss(cfg, tree.unflatten(spec, taps), rows, grid)
    reads = [(k, i, leaf) for k, t in enumerate(taps) for i, leaf in t.reads]
    gs = torch.autograd.grad(loss, [leaf for *_, leaf in reads],
                             allow_unused=True)
    parts = [{i: [] for i in t.blocks} for t in taps]
    for (k, i, _), g in zip(reads, gs):
        if g is not None:
            parts[k][i].append(g)
    grads = [{i: psum(ps, t.blocks[i].device) if ps
              else torch.zeros_like(t.blocks[i]) for i, ps in p.items()}
             for t, p in zip(taps, parts)]
    return loss.detach(), tree.unflatten(spec, [
        Sharded(x.sharding, x.shape, g) for x, g in zip(flat, grads)])


def _rows(batch: dict, grid: list) -> list:
    """The batch's rows a data group of ``grid``, each on its lead device
    (contiguous equal blocks in group order, as ``batch_shardings`` splits
    them)."""
    lead = grid[0][0]
    whole = {k: v.gather(lead) if isinstance(v, Sharded) else v.to(lead)
             for k, v in batch.items()}
    n_rows = next(iter(whole.values())).shape[0]
    groups = len(grid)
    if n_rows % groups:
        raise ValueError(f"{n_rows} rows do not split over {groups} data "
                         "shards")
    n = n_rows // groups
    return [{k: v[g * n:(g + 1) * n].to(grid[g][0])
             for k, v in whole.items()} for g in range(groups)]


def grads(cfg: ModelConfig, params, batch: dict):
    """``(loss, grads)`` of the training loss over one batch: on one
    device, or on a mesh when ``params`` holds ``Sharded`` leaves, each
    data group taking its rows (``batch_shardings``' split) and the grads
    in the params' layout."""
    first = tree.leaves(params)[0]
    if not isinstance(first, Sharded):
        return value_and_grad(make_loss_fn(cfg), params, batch)
    grid = [[first.mesh.devices[i] for i in row]
            for row in train_grid(first.mesh)]
    if cfg.num_experts:
        # every row in one data group: the reference's dispatch groups,
        # capacity and aux losses (item 1.10c)
        grid = grid[:1]
    return sharded_value_and_grad(cfg, params, _rows(batch, grid), grid)


def make_train_step(cfg: ModelConfig, ocfg: opt.AdamWConfig,
                    grad_accum: int = 1, accum_dtype=F32) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.
    ``grad_accum > 1`` takes the gradients of that many microbatches
    (slices of the batch's leading axis) one after another, summed in
    ``accum_dtype`` (bf16 halves the accumulator), then their mean.
    Params on a mesh (``Sharded`` leaves) take the sharded path: each
    microbatch is cut from the global batch in the reference's order and
    split over the data shards."""
    def step(params, opt_state, batch):
        if grad_accum == 1:
            loss, g_all = grads(cfg, params, batch)
        else:
            first = tree.leaves(params)[0]
            if isinstance(first, Sharded):
                batch = {k: v.gather() if isinstance(v, Sharded) else v
                         for k, v in batch.items()}
            n = next(iter(batch.values())).shape[0] // grad_accum
            loss, g_all = 0.0, None
            for i in range(grad_accum):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                lval, g = grads(cfg, params, mb)
                loss = loss + lval
                g_all = _accumulate(g_all, g, accum_dtype)
            inv = opt._recip(grad_accum)       # XLA's f32 reciprocal
            loss = loss * inv
            g_all = _scaled(g_all, inv)
        params, opt_state, metrics = opt.apply_updates(ocfg, params, g_all,
                                                       opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def _blockwise(fn, *trees):
    """``fn`` over the leaves of trees of one structure, a ``Sharded``
    leaf block by block (its owner blocks)."""
    def one(*xs):
        if isinstance(xs[0], Sharded):
            return Sharded(xs[0].sharding, xs[0].shape,
                           {i: fn(*(x.blocks[i] for x in xs))
                            for i in xs[0].blocks})
        return fn(*xs)
    return tree.map(one, *trees)


def _accumulate(acc, g, accum_dtype):
    """``acc + g`` in ``accum_dtype`` (``acc`` None: zeros)."""
    if acc is None:
        acc = _blockwise(lambda x: torch.zeros(x.shape, dtype=accum_dtype,
                                               device=x.device), g)
    return _blockwise(lambda a, b: a + b.to(accum_dtype), acc, g)


def _scaled(grads, inv: float):
    return _blockwise(lambda x: x * inv, grads)


def make_eval_step(cfg: ModelConfig) -> Callable:
    """``step(params, batch) -> loss``, no gradients recorded."""
    loss_fn = make_loss_fn(cfg)

    def step(params, batch):
        with torch.no_grad():
            return loss_fn(params, batch)

    return step
