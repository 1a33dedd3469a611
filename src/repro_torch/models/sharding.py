"""Sharding rules and collectives of the port's meshes.

Port of ``repro/models/sharding.py``.  Training: ``fsdp_axes`` :17,
``dp_axes`` :41, ``_param_spec`` :45 (with its ``moe_ep`` variant),
``_path_str`` :110, ``param_shardings`` :122, ``cache_shardings`` :138,
``batch_shardings`` :172, ``activation_constraint`` :185,
``logits_sharding`` :194 and the model-code context ``_CTX``/
``set_mesh_context``/``mesh_context``/``constrain`` :289-344.  Serving:
``fit_spec`` :31, the pool plane rules ``_PLANE_RULES``/``plane_pspec``/
``plane_pspecs`` :209-253, the packed-weight leaf rules
``PACKED_LEAF_KINDS``/``packed_leaf_pspecs`` :256-272 and the placement
that ``plane_shardings`` :275 makes.  A spec is a plain tuple with one
entry a dimension: a mesh axis name, a tuple of names, or None for a
dimension every shard holds whole (the empty tuple replicates everything,
as ``P()`` does).  ``NamedSharding`` pairs a spec with its mesh, as the
reference's does.

The port's mesh is driven by one controller (``launch.mesh``), so the
collectives that GSPMD and ``shard_map`` insert are explicit functions
over the per-shard tensors, in shard-index order: ``all_gather``
(concatenation), ``psum`` (a sum) and ``pmax``, each onto one device.  A
tensor placed on a mesh is a ``Sharded``: its blocks by mesh coordinate,
each on its device, a replicated block once a device.
"""
from __future__ import annotations

import numpy as np
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


class _Broadcast(torch.autograd.Function):
    """``x``'s copies on ``devices``, one output a consumer; the backward
    gets every consumer's gradient in one call and sums them in shard
    order (``psum``) on ``x``'s device.  Autograd's own accumulation of
    several uses adds them as they arrive, and on several cards they
    arrive in an order that varies from run to run."""

    @staticmethod
    def forward(ctx, x, *devices):
        ctx.device = x.device
        return tuple(x.to(d, copy=True) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        got = [g for g in grads if g is not None]
        return (psum(got, ctx.device) if got else None,
                *([None] * len(grads)))


def broadcast(x: torch.Tensor, devices: list) -> list:
    """``x`` on each of ``devices`` (a copy each, also on ``x``'s own),
    its gradient the shard-order sum of the copies' (``psum``)."""
    if not x.requires_grad:
        return [x.to(d) for d in devices]
    return list(_Broadcast.apply(x, *devices))


def pmax(parts: list, device) -> torch.Tensor:
    """The shards' tensors' elementwise maximum, on ``device``."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = torch.maximum(out, p.to(device))
    return out


# ------------------------------------------------------------ training
def fsdp_axes(mesh) -> tuple[str, ...]:
    """The axes a weight's FSDP dimension splits over (``fsdp_axes`` :17):
    ``pod`` and ``data``, those the mesh names."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_axes(mesh) -> tuple[str, ...]:
    """The batch's axes (``dp_axes`` :41): the FSDP axes."""
    return fsdp_axes(mesh)


def _param_spec(path: str, leaf, fsdp) -> tuple:
    """A param's spec by its path (``_param_spec`` :45): FSDP over
    ``fsdp`` on one weight dimension, TP over ``model`` on the heads, FFN
    hidden, recurrent width or vocabulary; the rules index dimensions from
    the right, so a port leaf (one layer) takes the spec of the JAX
    package's stacked leaf without its leading layer dimension."""
    nd = len(leaf.shape)
    f = fsdp
    if "unembed" in path:          # before the "embed" substring test
        return ("model", f)
    if "embed" in path:
        return ("model", f)
    if "norm" in path or "a_param" in path or "gate_vec" in path:
        return (None,) * nd
    if "inner" in path:
        if path.endswith(("wq", "wk", "wv")) and nd >= 3:
            return (None,) * (nd - 3) + (f, "model", None)
        if path.endswith("wo") and nd >= 3:
            return (None,) * (nd - 3) + ("model", None, f)
        if path.endswith(("w_x", "w_gate", "w_up")):
            return (None,) * (nd - 2) + (f, "model")
        if path.endswith(("w_out", "w_down")):
            return (None,) * (nd - 2) + ("model", f)
        if path.endswith("conv_w"):
            return (None,) * (nd - 1) + ("model",)
        if path.endswith(("w_input_gate", "w_a_gate")):
            return (None,) * (nd - 1) + ("model",)
        if path.endswith("w_if"):
            return (None,) * (nd - 3) + ("model", None, None)
        if path.endswith("w_in"):                      # slstm [D, 4, D]
            return (None,) * (nd - 3) + (f, None, "model")
        if path.endswith("/r"):
            return (None,) * nd
    if "ffn" in path:
        if path.endswith("router"):
            return (None,) * (nd - 2) + (f, None)
        if path.endswith(("wi", "wg")):                # [E, D, F]
            if _CTX.get("moe_ep"):
                # resident experts: E over the dp axes, D/F over model
                return (None,) * (nd - 3) + (f, "model", None)
            return (None,) * (nd - 3) + ("model", f, None)
        if path.endswith("wo") and nd >= 3:            # [E, F, D]
            if _CTX.get("moe_ep"):
                return (None,) * (nd - 3) + (f, None, "model")
            return (None,) * (nd - 3) + ("model", None, f)
        if path.endswith(("w_up", "w_gate")):
            return (None,) * (nd - 2) + (f, "model")
        if path.endswith("w_down"):
            return (None,) * (nd - 2) + ("model", f)
        if path.endswith("w_in"):
            return (None,) * (nd - 3) + (f, None, "model")
    return (None,) * nd                                # replicate


def _path_str(path) -> str:
    """A leaf's path as ``/``-joined keys and indices (``_path_str``
    :110): ``blocks/3/inner/wq`` for a port leaf."""
    return "/".join(str(p) for p in path)


def canonical(spec: tuple) -> tuple:
    """``spec`` as ``PartitionSpec`` keeps it: an entry of one axis as the
    axis name, an empty tuple of axes as None."""
    return tuple(None if e == () else e[0] if isinstance(e, tuple)
                 and len(e) == 1 else e for e in spec)


class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``), its entries
    ``canonical``."""

    def __init__(self, mesh, spec: tuple):
        self.mesh, self.spec = mesh, canonical(spec)

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __repr__(self):
        return f"NamedSharding({self.spec})"


def _map_with_path(fn, node, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples (the
    port's param, cache and batch trees), in a tree of its structure."""
    if isinstance(node, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in
                node.items()}
    if isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
        return type(node)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(node))
    return fn(path, node)


def param_shardings(mesh, params):
    """A ``NamedSharding`` a param leaf (``param_shardings`` :122), each
    spec fitted to its leaf's shape.  ``params`` may hold tensors on the
    ``meta`` device, or anything with a ``.shape``."""
    f = fsdp_axes(mesh)

    def one(path, leaf):
        spec = _param_spec(_path_str(path), leaf, f)
        nd = len(leaf.shape)
        if len(spec) < nd:                   # pad the leading dimensions
            spec = (None,) * (nd - len(spec)) + spec
        return NamedSharding(mesh, fit_spec(spec, tuple(leaf.shape), mesh))

    return _map_with_path(one, params)


def cache_shardings(mesh, caches):
    """Decode caches (``cache_shardings`` :138): the batch over the dp axes;
    KV heads over ``model`` where they divide, else the sequence over
    ``model`` (split-K decode attention), else neither."""
    dp = dp_axes(mesh)

    def one(path, leaf):
        p = _path_str(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        if p.endswith("/k") or p.endswith("/v") or p in ("k", "v"):
            lead = (None,) * (nd - 4)        # [(layers,) B, S, Hkv, dh]
            for cand in (lead + (dp, None, "model", None),
                         lead + (dp, "model", None, None),
                         lead + (dp, None, None, None)):
                if cand == fit_spec(cand, shape, mesh):
                    return NamedSharding(mesh, cand)
        if p.endswith("_scale"):
            lead = (None,) * (nd - 3)        # [(layers,) B, S, Hkv]
            for cand in (lead + (dp, None, "model"),
                         lead + (dp, "model", None),
                         lead + (dp, None, None)):
                if cand == fit_spec(cand, shape, mesh):
                    return NamedSharding(mesh, cand)
        spec = ((None,) * (nd - 2) + (dp, "model") if nd >= 2
                else (None,) * nd)
        return NamedSharding(mesh, fit_spec(spec, shape, mesh))

    return _map_with_path(one, caches)


def batch_shardings(mesh, batch):
    """Every batch leaf's rows over the dp axes (``batch_shardings`` :172),
    fitted."""
    dp = dp_axes(mesh)

    def one(path, leaf):
        nd = len(leaf.shape)
        spec = (dp,) + (None,) * (nd - 1) if nd >= 1 else ()
        return NamedSharding(mesh, fit_spec(spec, tuple(leaf.shape), mesh))

    return _map_with_path(one, batch)


def activation_constraint(mesh, h, *, seq_shard: bool = False) -> tuple:
    """The residual stream's spec between blocks (``activation_constraint``
    :185): the batch over dp and, with ``seq_shard``, the sequence over
    ``model``.  The port places activations explicitly (one controller),
    so this gives the spec and leaves ``h`` where it is."""
    dp = dp_axes(mesh)
    return canonical((dp, "model", None) if seq_shard else (dp, None, None))


def logits_sharding(mesh) -> NamedSharding:
    """Logits [B, S, V]: batch over dp, vocabulary over ``model``
    (``logits_sharding`` :194)."""
    return NamedSharding(mesh, (dp_axes(mesh), None, "model"))


# ------------------------------------------------ model-code context
# The reference's model code calls ``constrain(x, kind)``, a no-op unless
# the launcher installed a mesh (``_CTX`` :289).  The port's sharded step
# (``model.sharded_loss``) splits its sites explicitly, so ``constrain``
# leaves a tensor as it is and ``constraint_spec`` says what the
# reference constrains it to.
_CTX: dict = {"mesh": None, "seq_shard": False, "moe_ep": False}


def set_mesh_context(mesh, *, seq_shard: bool = False,
                     moe_ep: bool = False) -> None:
    _CTX["mesh"] = mesh
    _CTX["seq_shard"] = seq_shard
    _CTX["moe_ep"] = moe_ep


class mesh_context:
    """``with mesh_context(mesh):`` installs ``mesh`` (and the
    ``seq_shard``/``moe_ep`` options) for the code inside, as
    ``mesh_context`` :305 does."""

    def __init__(self, mesh, *, seq_shard: bool = False,
                 moe_ep: bool = False):
        self.mesh, self.seq_shard, self.moe_ep = mesh, seq_shard, moe_ep

    def __enter__(self):
        self.prev = dict(_CTX)
        set_mesh_context(self.mesh, seq_shard=self.seq_shard,
                         moe_ep=self.moe_ep)
        return self

    def __exit__(self, *exc):
        _CTX.update(self.prev)


def constraint_spec(shape: tuple, kind: str) -> tuple | None:
    """The spec ``constrain`` :319 gives a tensor of ``shape`` under the
    installed mesh (None without one): kind ``residual`` [B, S, D],
    ``logits`` [B, S, V], ``heads`` [B, S, H, dh], ``ffn_hidden``
    [B, S, F], ``experts`` [E, C, ...], ``kv_cache`` [B, S, Hkv, dh], any
    other the batch over dp.  Only the batch dimension is fitted."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return None
    dp = dp_axes(mesh)
    nd = len(shape)
    if kind == "residual":
        spec = (dp, "model", None) if _CTX["seq_shard"] else (dp, None, None)
    elif kind == "logits":
        spec = (dp, None, "model")
    elif kind == "heads":
        spec = (dp, None, "model", None)
    elif kind == "ffn_hidden":
        spec = (dp, None, "model")
    elif kind == "experts":
        spec = (dp if _CTX.get("moe_ep") else "model",) + (None,) * (nd - 1)
    elif kind == "kv_cache":
        spec = ((dp, None, "model", None)
                if shape[2] % _axes_size(mesh, "model") == 0
                else (dp, "model", None, None))
    else:
        spec = (dp,) + (None,) * (nd - 1)
    if shape[0] % _axes_size(mesh, spec[0]) != 0:
        spec = (None,) + spec[1:]
    return canonical(spec)


def constrain(x, kind: str):
    """``x`` itself (``constrain`` :319): without a mesh as in the
    reference; with one, because the port's sharded step places each
    site's blocks explicitly (``constraint_spec`` gives the layout)."""
    return x


# ------------------------------------------------- tensors on a mesh
def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def block_slices(spec: tuple, shape: tuple, mesh, idx: tuple) -> tuple:
    """``(start, length)`` of each dimension of the block that the device
    at mesh coordinate ``idx`` holds of a tensor of ``shape`` under
    ``spec`` (fitted): a dimension over axes ``(a, b)`` splits into
    ``|a| |b|`` blocks, the block of ``(i_a, i_b)`` at ``i_a |b| + i_b``."""
    coord = dict(zip(mesh.axis_names, idx))
    out = []
    for dim, entry in zip(shape, spec):
        k, n = 0, 1
        for a in _entry_axes(entry):
            if a in coord:                   # an axis the mesh lacks is 1
                k = k * mesh.shape[a] + coord[a]
                n *= mesh.shape[a]
        out.append((k * (dim // n), dim // n))
    return tuple(out)


class Sharded:
    """A tensor of ``shape`` on a mesh under ``sharding``: ``blocks[idx]``
    is the block of the device at mesh coordinate ``idx``, on that device;
    devices that hold the same block on the same card share one tensor.
    ``owners`` are the coordinates of the distinct blocks (index 0 on
    every axis the spec does not name), in mesh order."""

    def __init__(self, sharding: NamedSharding, shape: tuple, blocks: dict):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.blocks = blocks

    @property
    def mesh(self):
        return self.sharding.mesh

    @property
    def spec(self) -> tuple:
        return self.sharding.spec

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def owners(self) -> list[tuple]:
        return [idx for idx in np.ndindex(*self.mesh.devices.shape)
                if self.owner_of(idx) == idx]

    def slices(self, idx: tuple) -> tuple:
        return block_slices(self.spec, self.shape, self.mesh, idx)

    def owner_of(self, idx: tuple) -> tuple:
        """The owner coordinate holding the same block as ``idx``."""
        used = {a for e in self.spec for a in _entry_axes(e)}
        return tuple(i if a in used else 0
                     for a, i in zip(self.mesh.axis_names, idx))

    @classmethod
    def place(cls, x: torch.Tensor, sharding: NamedSharding) -> "Sharded":
        """``x`` split by ``sharding`` (``jax.device_put``): each device
        its block, a copy (a block of ``x`` on its own device shares no
        storage with ``x``)."""
        mesh = sharding.mesh
        spec = fit_spec(sharding.spec, tuple(x.shape), mesh)
        sharding = NamedSharding(mesh, spec)
        blocks, made = {}, {}
        for idx in np.ndindex(*mesh.devices.shape):
            sl = block_slices(spec, tuple(x.shape), mesh, idx)
            dev = mesh.devices[idx]
            key = (sl, dev)
            if key not in made:
                blk = x
                for d, (s, n) in enumerate(sl):
                    if n != x.shape[d]:
                        blk = blk.narrow(d, s, n)
                made[key] = blk.detach().to(dev, copy=True).contiguous()
            blocks[idx] = made[key]
        return cls(sharding, tuple(x.shape), blocks)

    @classmethod
    def from_owners(cls, like: "Sharded", owned: dict) -> "Sharded":
        """A tensor of ``like``'s layout from new owner blocks ``owned``
        (by owner coordinate): each replica takes its owner's block on its
        own device (the same tensor on the same card)."""
        blocks = {}
        for idx in np.ndindex(*like.mesh.devices.shape):
            blocks[idx] = owned[like.owner_of(idx)].to(like.mesh.devices[idx])
        return cls(like.sharding, like.shape, blocks)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the first device when None),
        concatenated from the owner blocks: ``all_gather`` over every
        split dimension."""
        return self.assemble(self.mesh.devices.flat[0] if device is None
                             else device, self.owners)

    def assemble(self, device, owners: list) -> torch.Tensor:
        """The blocks of ``owners`` (owner coordinates forming a box of
        blocks, e.g. one model shard's) concatenated on ``device``."""
        return _assemble({tuple(s for s, _ in self.slices(idx)):
                          self.blocks[idx] for idx in owners}, device)

    def block_bytes(self, idx: tuple) -> int:
        b = self.blocks[idx]
        return b.numel() * b.element_size()


def _assemble(pieces: dict, device) -> torch.Tensor:
    """Blocks keyed by their start offsets as one tensor on ``device``:
    concatenated along the first dimension where the starts differ, each
    group assembled the same way."""
    if len(pieces) == 1:
        return next(iter(pieces.values())).to(device)
    starts = list(pieces)
    d = next(i for i in range(len(starts[0]))
             if len({s[i] for s in starts}) > 1)
    groups: dict = {}
    for s, t in pieces.items():
        groups.setdefault(s[d], {})[s] = t
    return torch.cat([_assemble(groups[k], device) for k in sorted(groups)],
                     dim=d)


def place_tree(tree, shardings):
    """Every tensor of ``tree`` placed by its ``NamedSharding`` of
    ``shardings`` (a tree of the same structure) as a ``Sharded``."""
    from repro_torch import tree as T
    leaves, spec = T.flatten(tree)
    return T.unflatten(spec, [Sharded.place(x, s) for x, s in
                              zip(leaves, T.leaves(shardings))])


def gather_tree(tree, device=None):
    """Every ``Sharded`` leaf of ``tree`` as its whole tensor on ``device``
    (its mesh's first device when None)."""
    from repro_torch import tree as T
    return T.map(lambda x: x.gather(device) if isinstance(x, Sharded)
                 else x, tree)


def device_bytes(tree) -> dict:
    """Bytes each device coordinate holds of a tree's ``Sharded`` leaves,
    ``{idx: bytes}`` (a replicated block counts on every device)."""
    from repro_torch import tree as T
    out: dict = {}
    for x in T.leaves(tree):
        if isinstance(x, Sharded):
            for idx in x.blocks:
                out[idx] = out.get(idx, 0) + x.block_bytes(idx)
    return out
