"""Serving mesh rules and collectives.

Port of the serving part of ``repro/models/sharding.py``: ``fit_spec``
:31, the pool plane rules ``_PLANE_RULES``/``plane_pspec``/
``plane_pspecs`` :209-253, the packed-weight leaf rules
``PACKED_LEAF_KINDS``/``packed_leaf_pspecs`` :256-272 and the placement
that ``plane_shardings`` :275 makes.  A spec is a plain tuple with one
entry a dimension: a mesh axis name, or None for a dimension every shard
holds whole (the empty tuple replicates everything, as ``P()`` does).

The port's mesh is driven by one controller (``launch.mesh``), so the
collectives that ``shard_map`` inserts are explicit functions over the
per-shard tensors, in shard-index order: ``all_gather`` (concatenation),
``psum`` (a sum) and ``pmax``, each onto one device.  The training rules
(``param_shardings``, ``cache_shardings``, ``batch_shardings``,
``activation_constraint``, ``constrain``, ``moe_ep``) are not ported
(ROADMAP item 1.10b).
"""
from __future__ import annotations

import torch


def _axes_size(mesh, entry) -> int:
    if entry is None:
        return 1
    axes = entry if isinstance(entry, tuple) else (entry,)
    n = 1
    for a in axes:
        n *= dict(mesh.shape).get(a, 1)
    return n


def fit_spec(spec: tuple, shape: tuple, mesh) -> tuple:
    """Drop the axis of any dimension whose size its axes' product does
    not divide (``fit_spec`` :31): e.g. 8 KV heads on a 16-way model axis
    replicate."""
    return tuple(entry if dim % _axes_size(mesh, entry) == 0 else None
                 for dim, entry in zip(shape, spec))


# The page pool's planes under a serving mesh (axes ("data", "model")),
# as the reference holds them: pages over "data" (each data shard owns a
# contiguous page range, its free list's), the dense HOT/COLD payloads and
# page scales' KV heads over "model"; PACKED planes cannot split by head
# (the APack streams interleave heads), so every model shard keeps a page's
# whole planes; the table planes replicate.
_PLANE_RULES: dict[str, tuple] = {
    "tok_k": ("data", None, "model", None),
    "tok_v": ("data", None, "model", None),
    "cold_k": ("data", None, "model", None),
    "cold_v": ("data", None, "model", None),
    "tok_sk": ("data", None, "model"),
    "tok_sv": ("data", None, "model"),
    "pscale_k": ("data", "model"),
    "pscale_v": ("data", "model"),
    "sym_k": ("data", None, None),
    "sym_v": ("data", None, None),
    "ofs_k": ("data", None, None),
    "ofs_v": ("data", None, None),
    "stored_k": ("data", None),
    "stored_v": ("data", None),
    "vm": (None, None),
    "ol": (None, None),
    "cum": (None, None),
}

# The port's pool keeps K and V stacked on a leading kind axis, and keeps
# each PACKED page's stream bit counts on the device beside its planes;
# each of its tensors takes the rule of its K plane (the bit counts that of
# ``stored``: one entry a stream of a page).
POOL_PLANES = {"tok_q": "tok_k", "tok_scale": "tok_sk", "cold_q": "cold_k",
               "page_scale": "pscale_k", "sym": "sym_k", "ofs": "ofs_k",
               "sym_bits": "stored_k", "ofs_bits": "stored_k",
               "stored": "stored_k"}


def plane_pspec(name: str) -> tuple:
    """The spec of one pool plane by name (``plane_pspec`` :235)."""
    try:
        return _PLANE_RULES[name]
    except KeyError:
        raise KeyError(f"no plane partition rule for {name!r}") from None


def plane_pspecs(planes: dict | None = None) -> dict:
    """Specs of a planes dict's keys, or of every rule without one
    (``plane_pspecs`` :243)."""
    return {k: plane_pspec(k) for k in (_PLANE_RULES if planes is None
                                        else planes)}


def pool_spec(attr: str) -> tuple:
    """The spec of a ``modules.KVPagePool`` tensor [2, pages, ...]: its K
    plane's rule behind the kind axis."""
    return (None,) + plane_pspec(POOL_PLANES[attr])


# Packed-weight leaves (``modules.PackedWeight``'s ``CompressedLinear``,
# in the reference's flatten order).  The stream axis is kt-major, so
# splitting sym/ofs/stored over "model" splits K into whole-tile ranges
# (row parallelism; the partial products are summed with ``psum``); the
# column scale and the tables replicate.  Weights never split over
# "data": every decode job reads every weight.
PACKED_LEAF_KINDS = ("sym", "ofs", "stored", "v_min", "ol", "cum", "scale")
_PACKED_SPLIT_KINDS = frozenset({"sym", "ofs", "stored"})


def packed_leaf_pspecs(leaves, *, splittable: bool) -> list[tuple]:
    """Specs of one ``CompressedLinear``'s leaves in ``PACKED_LEAF_KINDS``
    order (``packed_leaf_pspecs`` :261): the stream (last) axis of the
    split kinds over "model" when ``splittable``, else every leaf
    replicated."""
    return [(*([None] * (leaf.dim() - 1)), "model")
            if splittable and kind in _PACKED_SPLIT_KINDS else ()
            for kind, leaf in zip(PACKED_LEAF_KINDS, leaves)]


def local_shape(spec: tuple, shape: tuple, mesh) -> tuple:
    """A shard's block shape of a tensor of ``shape`` under ``spec``
    (fitted first, as ``plane_shardings`` :275 fits)."""
    spec = fit_spec(spec, shape, mesh)
    return tuple(dim // _axes_size(mesh, entry)
                 for dim, entry in zip(shape, spec))


# ------------------------------------------------------------ collectives
def all_gather(parts: list, dim: int, device) -> torch.Tensor:
    """The shards' tensors concatenated along ``dim`` in shard order, on
    ``device`` (``all_gather(..., tiled=True)``)."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts], dim=dim)


def psum(parts: list, device) -> torch.Tensor:
    """The shards' tensors summed in shard order, on ``device``."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def pmax(parts: list, device) -> torch.Tensor:
    """The shards' tensors' elementwise maximum, on ``device``."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = torch.maximum(out, p.to(device))
    return out
