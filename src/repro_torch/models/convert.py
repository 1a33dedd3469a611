"""Parameter conversion between the port's trees and the JAX package's.

``params_from_numpy(cfg, tree, device)`` takes the JAX package's params as
a numpy pytree (the caller runs ``jax.tree.map(np.asarray, params)``; this
module imports no JAX) and returns the port's layout: the unscanned
``params["prefix"]`` layers come first, then the scanned
``params["blocks"]`` stacks, one per cycle position with a leading
``n_cycles`` axis, become one param dict per layer, in layer order
``n_prefix + j * len(cycle) + c``.  Each layer's tree is carried as it
is, whatever its kind: attention, recurrent, mLSTM or sLSTM ``inner``, a
dense ``ffn`` or an MoE one (the f32 ``router``, the expert stacks
``wi``/``wg``/``wo`` [E, ...], a ``shared`` expert) or none; so is the
untied head ``unembed``.  Both packages then compute with the same
numbers.

``params_to_numpy(cfg, params)`` is the inverse: the port's tree (trained
params, a restored checkpoint) in the JAX package's layout, the layers of
each cycle position re-stacked on a leading ``n_cycles`` axis, as numpy
arrays (a bf16 leaf as exact f32 values: numpy has no bf16), so that it
can be held against the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve

from .config import ModelConfig
from .model import check_supported


def _to_torch(x, device):
    if isinstance(x, dict):
        return {k: _to_torch(v, device) for k, v in x.items()}
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _index(x, j: int):
    if isinstance(x, dict):
        return {k: _index(v, j) for k, v in x.items()}
    return x[j]


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> dict:
    check_supported(cfg)
    dev = resolve(device)
    n_cycle = len(cfg.cycle)
    blocks = [_to_torch(p, dev) for p in tree.get("prefix", [])]
    blocks += [_to_torch(_index(tree["blocks"][c], j), dev)
               for j in range(cfg.n_cycles) for c in range(n_cycle)]
    out = {"embed": _to_torch(tree["embed"], dev),
           "final_norm": _to_torch(tree["final_norm"], dev),
           "blocks": blocks}
    if "unembed" in tree:
        out["unembed"] = _to_torch(tree["unembed"], dev)
    return out


def _to_numpy(x):
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _stack(layers: list):
    if isinstance(layers[0], dict):
        return {k: _stack([x[k] for x in layers]) for k in layers[0]}
    return np.stack(layers)


def params_to_numpy(cfg: ModelConfig, params: dict) -> dict:
    check_supported(cfg)
    n_prefix, n_cycle = len(cfg.prefix_pattern), len(cfg.cycle)
    blocks = [_to_numpy(b) for b in params["blocks"]]
    out = {"embed": _to_numpy(params["embed"]),
           "final_norm": _to_numpy(params["final_norm"]),
           "blocks": tuple(_stack(blocks[n_prefix + c::n_cycle])
                           for c in range(n_cycle))}
    if n_prefix:
        out["prefix"] = blocks[:n_prefix]
    if "unembed" in params:
        out["unembed"] = _to_numpy(params["unembed"])
    return out
