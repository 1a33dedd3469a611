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
codec, ``"fastpath"`` with ``kernels.fastpath`` on a device: ``device``
where the caller names one, else a tensor's own, else ``device.resolve()``
(the card).  ``timings``, where a caller passes a dict, gets the seconds
of the fast path's parts (``kernels.fastpath``: ``encode``, ``pull``,
``upload``, ``decode``) added up over the planes.
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


def plane_samples(x, table_mode: str = "activation") -> list:
    """The host bytes each byte plane's table is fitted to, per plane:
    the first 2^20 bytes of the plane (``"activation"``) or the whole
    plane (``"weight"``); None for a near-uniform (mantissa) plane, which
    is stored verbatim.  Only those bytes leave the tensor's device."""
    if table_mode not in ("activation", "weight"):
        raise ValueError(f"table_mode must be activation|weight, "
                         f"got {table_mode!r}")
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    if not t.is_floating_point():
        raise TypeError(f"compress_float: dtype {t.dtype} is not a float")
    flat = t.detach().reshape(-1)
    if table_mode == "activation":
        flat = flat[:2 ** 20]
    raw = flat.contiguous().view(torch.uint8).reshape(
        -1, t.element_size()).cpu().numpy()
    out = []
    for b in range(raw.shape[1]):
        plane = np.ascontiguousarray(raw[:, b])
        out.append(None if _plane_entropy(plane) > 7.5 else plane)
    return out


def fit_table(sample: np.ndarray, table_mode: str = "activation"):
    """The table of a plane from its ``plane_samples`` bytes: the paper's
    weight-mode heuristic, or activation mode with the empty-range slack
    that keeps bytes outside the sample encodable.  A pure function of
    the sample's histogram (a caller may run many in other processes)."""
    return table_for(sample, bits=8, is_activation=table_mode == "activation")


def compress_float(x, elems_per_stream: int = fmt.DEFAULT_ELEMS_PER_STREAM,
                   backend: str = "fastpath", table_mode: str = "activation",
                   device=None, timings: dict | None = None,
                   tables: list | None = None) -> CompressedPlanes:
    """``table_mode="activation"`` (default) profiles a bounded sample per
    plane and keeps the §VI empty-range slack — right for large tensors
    where profiling everything is too slow.  ``table_mode="weight"``
    profiles the *full* plane and uses the paper's weight-mode heuristic
    (no slack needed: every byte that will ever be encoded is in the
    histogram) — right for small, fully-known tensors such as recurrent
    decode-state snapshots.  ``tables``: each plane's table (None: stored
    verbatim) as ``fit_table`` of ``plane_samples`` gives them, fitted by
    the caller; else fitted here."""
    _check_backend(backend)
    if tables is None:
        tables = [None if smp is None else fit_table(smp, table_mode)
                  for smp in plane_samples(x, table_mode)]
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    dev = (t.device if isinstance(x, torch.Tensor) and device is None
           else resolve(device))
    # the byte planes stay on the device
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8).reshape(
        -1, t.element_size()).to(dev)
    planes = []
    for b, table in enumerate(tables):
        col = raw[:, b]
        if table is None:
            planes.append(_stored_plane(col, elems_per_stream))
        elif backend == "golden":
            planes.append(fmt.compress(col.cpu().numpy(), table, bits=8,
                                       elems_per_stream=elems_per_stream))
        else:
            from repro_torch.kernels import fastpath   # no core->kernels cycle
            planes.append(fastpath.compress_tensor(
                col.to(torch.int32), table, bits=8,
                elems_per_stream=elems_per_stream, timings=timings))
    return CompressedPlanes(shape=tuple(t.shape), dtype=_dtype_name(t.dtype),
                            planes=planes)


def _stored_plane(col: torch.Tensor,
                  elems_per_stream: int) -> fmt.CompressedTensor:
    """All-streams-stored container (verbatim bit-pack, no AC) of a uint8
    plane, packed by ``ref.pack_raw`` on the plane's device, the streams
    zero-padded as ``format.split_streams`` pads them."""
    from repro_torch.kernels import ref as _ref
    n, e = col.numel(), elems_per_stream
    s = max(1, -(-n // e))
    streams = torch.zeros(s * e, dtype=torch.uint8, device=col.device)
    streams[:n] = col
    packed = _ref.pack_raw(streams.reshape(s, e), e, 8)
    return fmt.CompressedTensor(
        shape=(n,), bits=8, table=uniform_table(),
        elems_per_stream=elems_per_stream, n_valid=n,
        sym_plane=np.zeros((0, s), np.uint32),
        # the u32 words' bits through int32 (a wrap, then the same view)
        ofs_plane=packed.to(torch.int32).cpu().numpy().view(np.uint32),
        sym_bits=np.zeros(s, np.int32), ofs_bits=np.full(s, e * 8, np.int32),
        stored=np.ones(s, bool))


def decompress_float(cp: CompressedPlanes, backend: str = "fastpath",
                     device=None, timings: dict | None = None
                     ) -> torch.Tensor:
    """The tensor back, bit for bit, on ``device.resolve(device)``."""
    _check_backend(backend)
    dev = resolve(device)
    if backend == "golden":
        cols = [torch.from_numpy(fmt.decompress(p).reshape(-1)).to(dev)
                for p in cp.planes]
    else:
        from repro_torch.kernels import fastpath
        cols = [fastpath.decompress_tensor(p, dev, timings).reshape(-1)
                for p in cp.planes]
    raw = torch.stack(cols, dim=1)
    return raw.view(getattr(torch, cp.dtype)).reshape(cp.shape)
