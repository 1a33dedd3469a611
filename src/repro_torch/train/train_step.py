"""Train-step factory: loss, gradients (with microbatch accumulation) and
AdamW, over the port's param trees.

Port of ``repro/train/train_step.py``: ``make_loss_fn`` :23,
``make_train_step`` :30 and ``make_eval_step`` :66.  Gradients come from
``torch.autograd`` through ``model.forward_train``, each layer cycle
recomputed in the backward pass (``remat``), where the reference takes
``jax.value_and_grad`` of its scanned, ``jax.checkpoint``-ed forward.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree
from repro_torch.models import model as M
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


def make_train_step(cfg: ModelConfig, ocfg: opt.AdamWConfig,
                    grad_accum: int = 1, accum_dtype=F32) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.
    ``grad_accum > 1`` takes the gradients of that many microbatches
    (slices of the batch's leading axis) one after another, summed in
    ``accum_dtype`` (bf16 halves the accumulator), then their mean."""
    loss_fn = make_loss_fn(cfg)

    def step(params, opt_state, batch):
        if grad_accum == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            n = next(iter(batch.values())).shape[0] // grad_accum
            loss = 0.0
            grads = tree.map(lambda p: torch.zeros(
                p.shape, dtype=accum_dtype, device=p.device), params)
            for i in range(grad_accum):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                lval, g = value_and_grad(loss_fn, params, mb)
                loss = loss + lval
                grads = tree.map(lambda a, b: a + b.to(accum_dtype), grads,
                                 g)
            inv = opt._recip(grad_accum)       # XLA's f32 reciprocal
            loss = loss * inv
            grads = tree.map(lambda g: g * inv, grads)
        params, opt_state, metrics = opt.apply_updates(ocfg, params, grads,
                                                       opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def make_eval_step(cfg: ModelConfig) -> Callable:
    """``step(params, batch) -> loss``, no gradients recorded."""
    loss_fn = make_loss_fn(cfg)

    def step(params, batch):
        with torch.no_grad():
            return loss_fn(params, batch)

    return step
