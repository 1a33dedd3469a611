"""Parameter conversion from the JAX package's trees.

``params_from_numpy(cfg, tree, device)`` takes the JAX package's params as
a numpy pytree (the caller runs ``jax.tree.map(np.asarray, params)``; this
module imports no JAX) and returns the port's layout: the unscanned
``params["prefix"]`` layers come first, then the scanned
``params["blocks"]`` stacks, one per cycle position with a leading
``n_cycles`` axis, become one param dict per layer, in layer order
``n_prefix + j * len(cycle) + c``.  Each layer's tree is carried as it
is, whatever its kind: attention or recurrent ``inner``, a dense ``ffn``
or an MoE one (the f32 ``router``, the expert stacks ``wi``/``wg``/``wo``
[E, ...], a ``shared`` expert); so is the untied head ``unembed``.  Both
packages then compute with the same numbers.
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
