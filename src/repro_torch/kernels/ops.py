"""The APack codec on whole tensors: ``CompressedArrays``, ``apack_encode``
and ``apack_decode``.

Port of ``repro/kernels/ops.py``.  ``apack_encode`` pads a tensor's
values to whole streams with the table's most probable value
(``ops.py:94-96``) and codes the streams with the stored-mode choice
folded in; ``apack_decode`` inverts it.  The values' device decides the
path, there is no backend switch: a CPU tensor takes the plain versions
(``ref.encode``/``ref.decode``), a CUDA tensor launches the encode or the
decode kernel (``apack_encode.encode``/``apack_decode.decode``) or raises.
Array-likes that are not tensors go to ``device.resolve(device)``, the
card unless the caller asks for the CPU.  The table reaches either kernel
as one shared row.

Unlike the JAX package, the stream count is not padded to a multiple of
128: that is the TPU kernels' block size (``ops.py:101-106, 139-146``),
and the CUDA kernels take any count (their last block of streams runs
short).  u32 plane words travel as int32 bit patterns.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.format import DEFAULT_ELEMS_PER_STREAM, _pad_value
from repro_torch.core.tables import ApackTable
from repro_torch.device import resolve

from . import apack_decode as _decode
from . import apack_encode as _encode
from . import ref as _ref

I32 = torch.int32
# The encode kernel addresses a plane's words with 32-bit offsets, so a
# plane of capacity W words a stream holds at most 2^32 - 1 words; the
# decode kernel's grid has one row of blocks per 128 streams, at most
# 65535 rows.
MAX_PLANE_WORDS = (1 << 32) - 1
MAX_DECODE_STREAMS = 65535 * 128


@dataclasses.dataclass
class CompressedArrays:
    """Tensor container for one APack-compressed tensor, on one device."""

    sym_plane: torch.Tensor      # int32 [Ws, S], u32 words
    ofs_plane: torch.Tensor      # int32 [Wo, S]
    sym_bits: torch.Tensor       # int32 [S]
    ofs_bits: torch.Tensor       # int32 [S]
    stored: torch.Tensor         # bool [S]
    v_min: torch.Tensor          # int32 [17]
    ol: torch.Tensor             # int32 [16]
    cum: torch.Tensor            # int32 [17]
    shape: tuple[int, ...]
    bits: int
    elems_per_stream: int
    n_valid: int

    @property
    def payload_bits(self) -> int:
        return int(self.sym_bits.sum(dtype=torch.int64)
                   + self.ofs_bits.sum(dtype=torch.int64))

    @classmethod
    def from_compressed_tensor(cls, ct, device=None) -> "CompressedArrays":
        """Upload a ``core.format.CompressedTensor`` to ``device``."""
        dev = resolve(device)

        # apack: allow-transfer(resume event and the codec's host API: a host
        # container's planes go up once, before its decode)
        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)
        v_min, ol, cum = _ref.table_tensors(ct.table, dev)
        return cls(sym_plane=up(ct.sym_plane.astype(np.uint32).view(np.int32),
                                np.int32),
                   ofs_plane=up(ct.ofs_plane.astype(np.uint32).view(np.int32),
                                np.int32),
                   sym_bits=up(ct.sym_bits, np.int32),
                   ofs_bits=up(ct.ofs_bits, np.int32),
                   stored=up(ct.stored, np.bool_), v_min=v_min, ol=ol,
                   cum=cum, shape=tuple(ct.shape), bits=ct.bits,
                   elems_per_stream=ct.elems_per_stream, n_valid=ct.n_valid)


# apack: allow-transfer(host inputs only: a tensor returns above unchanged; a
# numpy array handed to the ops codec's host API goes up once, never on the
# serving path)
def _as_tensor(values, device) -> torch.Tensor:
    if isinstance(values, torch.Tensor):
        return values
    return torch.as_tensor(np.asarray(values)).to(resolve(device))


def check_size(n_streams: int, elems_per_stream: int | None = None,
               bits: int = 8) -> None:
    """Refuse, before any work, a tensor that the kernels cannot address:
    more streams than the decode kernel's grid holds, or (given
    ``elems_per_stream``, for the encode) planes past the encode kernel's
    32-bit word offsets.  Every device refuses them alike."""
    if n_streams > MAX_DECODE_STREAMS:
        raise ValueError(f"{n_streams} streams: the decode kernel takes at "
                         f"most {MAX_DECODE_STREAMS}; split the tensor")
    if elems_per_stream is None:
        return
    cap = max(_ref.sym_capacity_words(elems_per_stream),
              _ref.ofs_capacity_words(elems_per_stream, bits))
    if cap * n_streams > MAX_PLANE_WORDS:
        raise ValueError(
            f"{n_streams} streams of {elems_per_stream} values need planes "
            f"of {cap} x {n_streams} words, past the encode kernel's "
            f"{MAX_PLANE_WORDS}; split the tensor")


def apack_encode(values, table: ApackTable,
                 elems_per_stream: int = DEFAULT_ELEMS_PER_STREAM,
                 device=None) -> CompressedArrays:
    """Compress a tensor of unsigned values in ``[0, 2^table.bits)`` with
    ``table``.  The planes keep their capacity widths."""
    arr = _as_tensor(values, device)
    shape = tuple(arr.shape)
    flat = arr.reshape(-1).to(I32)
    n = flat.shape[0]
    e = elems_per_stream
    s = max(1, -(-n // e))
    check_size(s, e, table.bits)
    streams = torch.full((s * e,), _pad_value(table), dtype=I32,
                         device=arr.device)
    streams[:n] = flat
    streams = streams.reshape(s, e)
    v_min, ol, cum = _ref.table_tensors(table, arr.device)
    sp, op, sb, ob, stored = _encode.encode(streams, v_min, ol, cum,
                                            n_steps=e, bits=table.bits)
    return CompressedArrays(sym_plane=sp, ofs_plane=op, sym_bits=sb,
                            ofs_bits=ob, stored=stored, v_min=v_min, ol=ol,
                            cum=cum, shape=shape, bits=table.bits,
                            elems_per_stream=e, n_valid=n)


def apack_decode(ca: CompressedArrays, dtype=None) -> torch.Tensor:
    """Decompress back to the original unsigned values: uint8 for
    ``bits <= 8``, else ``torch.uint16``, unless ``dtype`` says otherwise.
    A plane of no rows (every stream stored leaves the symbol plane empty
    once trimmed) is read as one row of zeros."""
    e = ca.elems_per_stream
    s = ca.sym_bits.shape[0]
    check_size(s)

    def plane(p):
        return p if p.shape[0] > 0 else torch.zeros(1, s, dtype=I32,
                                                   device=p.device)
    vals = _decode.decode(plane(ca.sym_plane), plane(ca.ofs_plane), ca.stored,
                          ca.v_min, ca.ol, ca.cum, n_steps=e, bits=ca.bits)
    flat = vals.reshape(-1)[:ca.n_valid]
    if dtype is None:
        dtype = torch.uint8 if ca.bits <= 8 else torch.uint16
    return flat.to(dtype).reshape(ca.shape)


def apack_roundtrip_check(values, table: ApackTable,
                          elems_per_stream: int = DEFAULT_ELEMS_PER_STREAM,
                          device=None) -> bool:
    arr = _as_tensor(values, device)
    out = apack_decode(apack_encode(arr, table, elems_per_stream))
    return bool(torch.equal(out.to(I32), arr.to(I32)))
