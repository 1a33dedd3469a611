"""Lossless APack compression of floating-point tensors via byte planes.

Port of ``repro/core/byteplane.py``.  Beyond-paper extension used for
checkpoint and recurrent-state compression: bf16/fp32 tensors split into
byte planes; the exponent-carrying plane of trained weights is highly
skewed (few distinct exponents), so APack's 16-range coder compresses it
well, while mantissa planes are near-uniform and are stored verbatim.
Exactly lossless: bits in, bits out.

It takes torch tensors of any float dtype (numpy float arrays too) and
returns torch tensors: the byte planes come from ``.view(torch.uint8)``,
and a ``"bfloat16"`` dtype name comes back as ``torch.bfloat16`` (the JAX
package goes through ``ml_dtypes``, which the port does not use).  The
planes are profiled and held on the host, as ``core.format`` containers.
``backend="golden"`` codes them with the pure-Python ``core.format``
codec, ``"fastpath"`` with ``kernels.fastpath`` on a device: a tensor's
own, else ``device.resolve(device)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve

from . import format as fmt
from .tables import table_for, uniform_table

BACKENDS = ("golden", "fastpath")


@dataclasses.dataclass
class CompressedPlanes:
    shape: tuple[int, ...]
    dtype: str
    planes: list[fmt.CompressedTensor]

    @property
    def total_bits(self) -> int:
        return sum(p.total_bits for p in self.planes)

    @property
    def original_bits(self) -> int:
        return sum(p.original_bits for p in self.planes)

    def ratio(self) -> float:
        return self.original_bits / max(self.total_bits, 1)


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


def _plane_entropy(plane: np.ndarray) -> float:
    h = np.bincount(plane[:2 ** 20], minlength=256).astype(np.float64)
    p = h[h > 0] / h[h > 0].sum()
    return float(-(p * np.log2(p)).sum())


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def compress_float(x, elems_per_stream: int = fmt.DEFAULT_ELEMS_PER_STREAM,
                   backend: str = "fastpath", table_mode: str = "activation",
                   device=None) -> CompressedPlanes:
    """``table_mode="activation"`` (default) profiles a bounded sample per
    plane and keeps the §VI empty-range slack — right for large tensors
    where profiling everything is too slow.  ``table_mode="weight"``
    profiles the *full* plane and uses the paper's weight-mode heuristic
    (no slack needed: every byte that will ever be encoded is in the
    histogram) — right for small, fully-known tensors such as recurrent
    decode-state snapshots."""
    if table_mode not in ("activation", "weight"):
        raise ValueError(f"table_mode must be activation|weight, "
                         f"got {table_mode!r}")
    _check_backend(backend)
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    if not t.is_floating_point():
        raise TypeError(f"compress_float: dtype {t.dtype} is not a float")
    dev = t.device if isinstance(x, torch.Tensor) else resolve(device)
    size = t.element_size()
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8).reshape(
        -1, size).cpu().numpy()
    planes = []
    for b in range(size):
        plane = np.ascontiguousarray(raw[:, b])
        if _plane_entropy(plane) > 7.5:
            # near-uniform (mantissa) plane: skip the coder, store verbatim
            planes.append(_stored_plane(plane, elems_per_stream, dev))
            continue
        if table_mode == "weight":
            table = table_for(plane, bits=8, is_activation=False)
        else:
            # bounded sample; stealing keeps unseen bytes encodable
            table = table_for(plane[:2 ** 20], bits=8, is_activation=True)
        if backend == "golden":
            planes.append(fmt.compress(plane, table, bits=8,
                                       elems_per_stream=elems_per_stream))
        else:
            from repro_torch.kernels import fastpath   # no core->kernels cycle
            planes.append(fastpath.compress_np(
                plane, table, bits=8, elems_per_stream=elems_per_stream,
                device=dev))
    return CompressedPlanes(shape=tuple(t.shape), dtype=_dtype_name(t.dtype),
                            planes=planes)


def _stored_plane(plane: np.ndarray, elems_per_stream: int,
                  device=None) -> fmt.CompressedTensor:
    """All-streams-stored container (verbatim bit-pack, no AC), packed by
    ``ref.pack_raw`` on ``device``."""
    from repro_torch.kernels import ref as _ref
    flat = plane.reshape(-1).astype(np.int64)
    streams, n_valid = fmt.split_streams(flat, elems_per_stream)
    s, e = streams.shape
    packed = _ref.pack_raw(torch.from_numpy(streams).to(resolve(device)), e, 8)
    return fmt.CompressedTensor(
        shape=tuple(plane.shape), bits=8, table=uniform_table(),
        elems_per_stream=elems_per_stream, n_valid=n_valid,
        sym_plane=np.zeros((0, s), np.uint32),
        ofs_plane=packed.cpu().numpy().astype(np.uint32),
        sym_bits=np.zeros(s, np.int32), ofs_bits=np.full(s, e * 8, np.int32),
        stored=np.ones(s, bool))


def decompress_float(cp: CompressedPlanes, backend: str = "fastpath",
                     device=None) -> torch.Tensor:
    """The tensor back, bit for bit, on ``device.resolve(device)``."""
    _check_backend(backend)
    dev = resolve(device)
    if backend == "golden":
        cols = [torch.from_numpy(fmt.decompress(p).reshape(-1)).to(dev)
                for p in cp.planes]
    else:
        from repro_torch.kernels import fastpath
        cols = [fastpath.decompress_tensor(p, dev).reshape(-1)
                for p in cp.planes]
    raw = torch.stack(cols, dim=1)
    return raw.view(getattr(torch, cp.dtype)).reshape(cp.shape)
