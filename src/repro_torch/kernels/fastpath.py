"""numpy-in/numpy-out fast codec path: ``core.format.CompressedTensor``
containers made and read through ``kernels.ops``.

Port of ``repro/kernels/fastpath.py``.  ``compress_np`` is bit-identical
to the golden ``core.format.compress``, down to the planes' widths (trimmed
to the longest stream's words); checkpoints and the weight round trip use
it where the pure-Python golden coder would be too slow.

A deliberate difference from the JAX package, whose fast path runs its
plain jnp codec on every backend, a TPU included: here the codec computes
on ``device.resolve(device)`` through ``ops``, so on the card the encode
and decode kernels code the streams, and on the CPU (``device="cpu"``)
their plain versions.  ``compress_tensor``/``decompress_tensor`` are the
same on a tensor that already lies on its device, with the decoded values
left there.

``timings``, where a caller passes a dict, gets the wall seconds of each
part added under its name, each part closed by a wait for the device:
``encode``, ``pull`` (the trimmed planes to the host), ``upload`` and
``decode``.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from repro_torch.core import format as fmt
from repro_torch.core.tables import ApackTable, table_for
from repro_torch.device import resolve

from . import ops


# apack: allow-transfer(only with timings= (the weight round trip's and a
# checkpoint's part times): it waits for the card to time a part; the serving
# path passes none)
@contextlib.contextmanager
def timed(timings: dict | None, part: str, device):
    """Add the wall seconds of the block to ``timings[part]``, waiting for
    ``device`` before and after it; nothing at all when ``timings`` is
    None."""
    if timings is None:
        yield
        return
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        timings[part] = timings.get(part, 0.0) + time.perf_counter() - t0


# apack: allow-transfer(preempt event and the weight round trip: one pull of
# the trimmed plane widths, then the planes, into the host container)
def compress_tensor(values: torch.Tensor, table: ApackTable,
                    bits: int = 8,
                    elems_per_stream: int = fmt.DEFAULT_ELEMS_PER_STREAM,
                    timings: dict | None = None) -> fmt.CompressedTensor:
    """Compress unsigned values lying on their device with ``table``."""
    if bits != table.bits:
        raise ValueError(f"bits={bits} but the table codes {table.bits}")
    dev = values.device
    with timed(timings, "encode", dev):
        ca = ops.apack_encode(values, table, elems_per_stream)
    with timed(timings, "pull", dev):
        # trim the planes to the golden container's widths (the most words
        # any stream holds; a stored stream's sym words are none)
        ws, wo = (int(w) for w in torch.stack([
            torch.where(ca.stored, 0, (ca.sym_bits + 31) // 32).amax(),
            ((ca.ofs_bits + 31) // 32).amax()]).tolist())

        # apack: allow-transfer(the container's planes, pulled once they are
        # trimmed: see compress_tensor)
        def host(t):
            return t.cpu().numpy()
        ct = fmt.CompressedTensor(
            shape=tuple(values.shape), bits=bits, table=table,
            elems_per_stream=elems_per_stream, n_valid=ca.n_valid,
            sym_plane=host(ca.sym_plane[:ws]).view(np.uint32),
            ofs_plane=host(ca.ofs_plane[:wo]).view(np.uint32),
            sym_bits=host(ca.sym_bits), ofs_bits=host(ca.ofs_bits),
            stored=host(ca.stored))
    return ct


def compress_np(values: np.ndarray, table: ApackTable | None = None,
                bits: int = 8, is_activation: bool = False,
                elems_per_stream: int = fmt.DEFAULT_ELEMS_PER_STREAM,
                device=None) -> fmt.CompressedTensor:
    arr = np.asarray(values)
    if table is None:
        table = table_for(arr.reshape(-1).astype(np.int64), bits,
                          is_activation)
    vals = torch.from_numpy(np.ascontiguousarray(arr, np.int32))
    return compress_tensor(vals.to(resolve(device)), table, bits,
                           elems_per_stream)


def decompress_tensor(ct: fmt.CompressedTensor, device=None,
                      timings: dict | None = None) -> torch.Tensor:
    """The container's values on ``device`` (uint8, or ``torch.uint16``
    above 8 bits)."""
    dev = resolve(device)
    with timed(timings, "upload", dev):
        ca = ops.CompressedArrays.from_compressed_tensor(ct, dev)
    with timed(timings, "decode", dev):
        return ops.apack_decode(ca)


def decompress_np(ct: fmt.CompressedTensor, device=None) -> np.ndarray:
    return decompress_tensor(ct, device).cpu().numpy()
