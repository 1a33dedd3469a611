"""Per-(arch x shape) dry-run cells: input specs, applicability (skips),
what a cell runs (train step, prefill or decode) and its placement.

Port of ``repro/launch/specs.py``.  The reference builds abstract
``ShapeDtypeStruct`` trees and their shardings for ``jax.jit(...).lower``;
the port builds the placed trees themselves, each block made by
``torch.empty`` on its device (``sharding.Sharded.empty``): under the dry
run's ``FakeTensorMode`` on a fake mesh they allocate nothing, and on a
mesh of cards (``chip_smoke.py`` (r)) they are real and ``fill`` gives
them values.  A cell's ``fn`` then runs the port's own code on them:
``train_step.make_train_step`` on the placed params and optimizer state,
``model.sharded_prefill`` or ``model.sharded_decode_step``.  The
reference's ``trips_by_depth`` has no counterpart: the port's layer and
chunk loops run in Python, so the counter sees every trip.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch import configs, tree
from repro_torch.launch import costs
from repro_torch.models import model as M
from repro_torch.models import sharding as sh
from repro_torch.models.config import ALL_SHAPES, ModelConfig, ShapeConfig
from repro_torch.train import AdamWConfig, init_state
from repro_torch.train.train_step import make_train_step

N_PATCH = 256          # vlm image-token prefix inside the sequence budget

# archs whose parameter volume needs int8 optimizer state to fit (DESIGN §4)
INT8_OPT = {"command-r-plus-104b", "dbrx-132b", "kimi-k2-1t-a32b"}

# microbatch counts for train_4k (bounds the remat residual stack to one
# microbatch; production config per arch) and grad-accumulator dtypes
GRAD_ACCUM = {"command-r-plus-104b": 16, "kimi-k2-1t-a32b": 8,
              "dbrx-132b": 8, "minitron-8b": 4, "minitron-4b": 4,
              "recurrentgemma-9b": 4, "paligemma-3b": 2, "qwen3-1.7b": 2}
BF16_ACCUM = {"command-r-plus-104b", "kimi-k2-1t-a32b"}

FULL_ATTENTION_ARCHS = {
    "qwen3-1.7b", "minitron-4b", "minitron-8b", "command-r-plus-104b",
    "paligemma-3b", "dbrx-132b", "kimi-k2-1t-a32b",
}


def skip_reason(arch: str, shape: ShapeConfig) -> str | None:
    cfg = configs.get_config(arch)
    if cfg.is_encoder and shape.kind == "decode":
        return "encoder-only: no decode step"
    if shape.name == "long_500k" and arch in FULL_ATTENTION_ARCHS:
        return "pure full attention: 500k decode needs sub-quadratic arch"
    if shape.name == "long_500k" and cfg.is_encoder:
        return "encoder-only"
    return None


def opt_config(arch: str) -> AdamWConfig:
    return AdamWConfig(state_dtype="int8" if arch in INT8_OPT else "float32")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                global_batch: int | None = None) -> dict:
    """The model inputs of a cell as ``{name: (shape, dtype)}``, the
    reference's ``ShapeDtypeStruct``s (``global_batch`` in place of the
    shape's where given)."""
    gb = shape.global_batch if global_batch is None else global_batch
    s = shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        return {"tokens": ((gb, 1), i32)}
    if cfg.frontend == "audio":
        return {"frame_embeds": ((gb, s, cfg.d_model), torch.bfloat16),
                "labels": ((gb, s), i32)}
    batch = {"tokens": ((gb, s - (N_PATCH if cfg.frontend == "vision"
                                  else 0)), i32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = ((gb, N_PATCH, cfg.d_model), torch.bfloat16)
    return batch


def _placed(template, shardings):
    """``template``'s leaves (anything with a shape and dtype) as
    ``Sharded.empty`` by their shardings."""
    return tree.map(lambda t, s: sh.Sharded.empty(tuple(t.shape), t.dtype, s),
                    template, shardings)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    cfg: ModelConfig
    fn: Callable[[], Any]      # runs the cell once
    args: dict                 # the placed trees fn reads, by name
    kind: str
    grad_accum: int = 1


def build_cell(arch: str, shape: ShapeConfig, mesh, *, kv_int8: bool = False,
               ga: int | None = None, cycles: int | None = None,
               global_batch: int | None = None) -> Cell:
    """The cell's placed trees on ``mesh`` and the call that runs it.
    ``cycles``: that many cycles of the layer pattern (after the prefix)
    in place of the config's; ``global_batch``: rows in place of the
    shape's.  ``moe_ep`` is read from the installed ``mesh_context``, as
    the reference's rules read it."""
    cfg = configs.get_config(arch)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if cycles is not None:
        cfg = dataclasses.replace(cfg, num_layers=len(cfg.prefix_pattern)
                                  + cycles * len(cfg.cycle))
    template = M.init_params(cfg, torch.Generator(), "meta")
    params = _placed(template, sh.param_shardings(mesh, template))
    del template
    specs = batch_specs(cfg, shape, global_batch)
    b_tmpl = {k: torch.empty(s, dtype=d, device="meta")
              for k, (s, d) in specs.items()}
    batch = _placed(b_tmpl, sh.batch_shardings(mesh, b_tmpl))
    gb = next(iter(specs.values()))[0][0]

    if shape.kind == "train":
        ocfg = opt_config(arch)
        opt_state = init_state(ocfg, params)
        ga = ga if ga is not None else GRAD_ACCUM.get(arch, 1)
        step = make_train_step(
            cfg, ocfg, grad_accum=ga,
            accum_dtype=torch.bfloat16 if arch in BF16_ACCUM
            else torch.float32)
        args = {"params": params, "opt_state": opt_state, "batch": batch}
        return Cell(arch, shape, cfg,
                    functools.partial(step, params, opt_state, batch),
                    args, "train", ga)

    if shape.kind == "prefill":
        return Cell(arch, shape, cfg, functools.partial(
            _no_grad, M.sharded_prefill, cfg, params, batch, mesh),
            {"params": params, "batch": batch}, "prefill")

    # decode: one new token against a seq_len-deep cache
    c_tmpl = M.init_cache(cfg, gb, shape.seq_len, device="meta")
    cache = _placed(c_tmpl, sh.cache_shardings(mesh, c_tmpl))
    del c_tmpl
    pos = sh.Sharded.empty((), torch.int32, sh.NamedSharding(mesh, ()))
    return Cell(arch, shape, cfg, functools.partial(
        _no_grad, M.sharded_decode_step, cfg, params, cache,
        batch["tokens"], pos, mesh),
        {"params": params, "cache": cache, "batch": batch, "pos": pos},
        "decode")


def _no_grad(fn, *args):
    with torch.no_grad():
        return fn(*args)


def fill(cell: Cell, generator: torch.Generator) -> None:
    """Values for a cell built on real devices: weights normal at 0.02,
    norm scales and caches zero, tokens uniform over the vocabulary, the
    decode position the cache's last (every position read)."""
    a = cell.args
    with torch.no_grad():
        for x in tree.leaves(a["params"]):
            for blk in {id(b): b for b in x.blocks.values()}.values():
                if blk.dim() >= 2:
                    blk.copy_(torch.randn(blk.shape, generator=generator,
                                          device=blk.device) * 0.02)
                else:
                    blk.zero_()
        for x in tree.leaves(a.get("cache", [])):
            for blk in x.blocks.values():
                blk.zero_()
        for k, x in a["batch"].items():
            for blk in x.blocks.values():
                if blk.dtype == torch.int32:
                    hi = cell.cfg.vocab_size if k == "tokens" else 2
                    blk.copy_(torch.randint(0, hi, blk.shape,
                                            generator=generator,
                                            device=blk.device))
                else:
                    blk.copy_(torch.randn(blk.shape, generator=generator,
                                          device=blk.device))
        if "pos" in a:
            for blk in a["pos"].blocks.values():
                blk.fill_(cell.shape.seq_len - 1)


def arg_bytes(cell: Cell) -> dict:
    """Bytes each device holds of the cell's placed trees, by device index
    as ``costs.CostCounter`` books them: ``sharding.device_bytes`` where
    every mesh coordinate has a device of its own, a block shared by
    coordinates on one device counted once."""
    out: dict = {}
    seen: set = set()
    for x in tree.leaves(list(cell.args.values())):
        for blk in x.blocks.values():
            if id(blk) in seen:
                continue
            seen.add(id(blk))
            dev = costs.dev_of(blk)
            out[dev] = out.get(dev, 0) + blk.numel() * blk.element_size()
    return out


def all_cells() -> list[tuple[str, ShapeConfig]]:
    out = []
    for arch in configs.all_arch_ids():
        for shape in ALL_SHAPES:
            out.append((arch, shape))
    return out
