"""Meshes: a named grid of ``torch.device``s.

Port of ``repro/launch/mesh.py``.  A JAX mesh is a grid of devices with
named axes that ``shard_map`` partitions over; the port's mesh is the same
grid, which one controller process drives: each shard's tensors live on
its device, and the collectives (``models.sharding``) are explicit
functions over the per-shard tensors.  ``make_debug_mesh`` puts every
shard on one device (the one-card mesh the tests and ``chip_smoke.py``
use); ``Mesh`` over a device list is a mesh of several cards.  The
serving engine reads ``.shape`` (axis sizes by name) and ``.axis_names``
only, plus ``device_grid`` where it places tensors; a training mesh has
axes ``("data", "model")`` or ``("pod", "data", "model")``, and the
sharded train step reads it through ``train_grid``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import fake_device, resolve


class Mesh:
    """``devices``: a nested list (or array) of ``torch.device``s shaped
    like ``axis_names``, e.g. ``[[cuda:0, cuda:1], [cuda:2, cuda:3]]`` for
    axes ``("data", "model")``; each is ``device.resolve``d (a CUDA device
    with its index)."""

    def __init__(self, devices, axis_names=("data", "model")):
        grid = np.empty(np.shape(np.asarray(devices, dtype=object)),
                        dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[idx] = resolve(d)
        if grid.ndim != len(axis_names):
            raise ValueError(f"devices of shape {grid.shape} for axes "
                             f"{tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def describe(self) -> str:
        """The mapping of shard coordinates to devices, one entry a shard:
        ``data=0,model=1 -> cuda:0``."""
        return "; ".join(
            ",".join(f"{a}={i}" for a, i in zip(self.axis_names, idx))
            + f" -> {d}" for idx, d in np.ndenumerate(self.devices))


def device_grid(mesh) -> list[list[torch.device]]:
    """A serving mesh's devices as ``[n_data][n_model]``.  A serving mesh
    names a ``data`` axis and may name a ``model`` axis; an absent model
    axis counts as 1."""
    extra = set(mesh.axis_names) - {"data", "model"}
    if extra or "data" not in mesh.axis_names:
        raise ValueError(f"a serving mesh has axes ('data', 'model'), not "
                         f"{tuple(mesh.axis_names)}")
    order = [mesh.axis_names.index("data")]
    grid = mesh.devices
    if "model" in mesh.axis_names:
        order.append(mesh.axis_names.index("model"))
        grid = grid.transpose(order)
    else:
        grid = grid[:, None]
    return [list(row) for row in grid]


def train_grid(mesh) -> list[list[tuple]]:
    """A training mesh's coordinates as ``[dp shard][model shard]``: the
    dp shards over the ``pod`` and ``data`` axes the mesh names, pod-major
    (the row order of a batch split over ``("pod", "data")``), the model
    shards over ``model`` (one where the mesh has no model axis)."""
    names = mesh.axis_names
    if set(names) - {"pod", "data", "model"}:
        raise ValueError(f"a training mesh has axes ('pod', 'data', "
                         f"'model'), not {tuple(names)}")
    dp = [a for a in ("pod", "data") if a in names]
    sizes = [mesh.shape[a] for a in dp]
    n_model = mesh.shape.get("model", 1)
    grid = []
    for k in np.ndindex(*sizes):
        row = []
        for j in range(n_model):
            coord = dict(zip(dp, k), model=j)
            row.append(tuple(coord.get(a, 0) for a in names))
        grid.append(row)
    return grid


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    multi_pod: bool = False, device=None) -> Mesh:
    """A ``(n_data, n_model)`` mesh (``(2, n_data, n_model)`` over
    ``("pod", "data", "model")`` with ``multi_pod``) with every shard on
    one device (``device``, the card unless the caller asks for the CPU;
    without a card, CUDA raises).  It runs the sharded program, its
    collectives included, on one device, as the JAX package's forced host
    devices do."""
    if multi_pod:
        return Mesh(np.full((2, n_data, n_model), resolve(device),
                            dtype=object), ("pod", "data", "model"))
    return Mesh(np.full((n_data, n_model), resolve(device), dtype=object))


def make_production_mesh(*, multi_pod: bool = False,
                         fake: bool = False) -> Mesh:
    """The production mesh, 16 x 16 (2 x 16 x 16 with ``multi_pod``) over
    as many CUDA devices; raises where the host has fewer.  It never folds
    shards onto fewer cards.  ``fake``: the dry run's mesh over as many
    fake devices (``device.fake_device``), on any host: tensors made on
    them under the dry run's fake tensor mode allocate nothing and keep
    their device's index."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    if fake:
        return Mesh(np.array([fake_device(i) for i in range(need)],
                             dtype=object).reshape(shape), axes)
    have = torch.cuda.device_count()
    if have < need:
        raise RuntimeError(f"the production mesh {shape} needs {need} CUDA "
                           f"devices; this host has {have}")
    devs = np.array([torch.device("cuda", i) for i in range(need)],
                    dtype=object).reshape(shape)
    return Mesh(devs, axes)
