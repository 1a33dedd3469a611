"""APack on-memory container format.

Port of ``repro/core/format.py`` (a numpy copy over the port's golden
coder ``core/ac_golden.py``: the port imports nothing of the JAX package).
The container is a host object: numpy planes ``uint32 [W, S]``, as in the
JAX package; ``kernels/fastpath.py`` fills it through the CUDA kernels.

A tensor is flattened and split into ``S`` independent substreams of ``E``
values each (paper §V-B: replication requires independent streams).  Each
substream encodes into a *symbol* bitstream (arithmetically coded) and an
*offset* bitstream (verbatim), exactly as the paper's two output streams.

Streams are **word-interleaved** — word ``w`` of stream ``s`` lives at
``plane[w, s]`` — so a decoder reading word ``w`` of neighbouring streams
touches contiguous words.  A per-stream directory records actual bit
lengths; fixed-capacity planes are the slotted view, the directory gives
the dynamic view.

Beyond the paper: per-stream **stored mode** — if arithmetic coding would
inflate a stream (or the encoder's pending-bit cap trips), the stream is
stored verbatim in the offset plane.  This bounds worst-case footprint at
``orig_bits + S`` bits + metadata, a guarantee the paper lacks.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import ac_golden
from .tables import ApackTable, TABLE_OVERHEAD_BITS, table_for

DEFAULT_ELEMS_PER_STREAM = 512
# Directory cost per stream: sym_bits(32) + ofs_bits(32) + stored flag(1).
DIR_BITS_PER_STREAM = 65


@dataclasses.dataclass
class CompressedTensor:
    """APack-compressed tensor + everything needed to invert it."""

    shape: tuple[int, ...]
    bits: int
    table: ApackTable
    elems_per_stream: int
    n_valid: int                 # flattened element count (excludes padding)
    sym_plane: np.ndarray        # [W_sym, S] uint32, word-interleaved
    ofs_plane: np.ndarray        # [W_ofs, S] uint32
    sym_bits: np.ndarray         # [S] int32, actual bits in each symbol stream
    ofs_bits: np.ndarray         # [S] int32
    stored: np.ndarray           # [S] bool, verbatim-mode streams

    @property
    def n_streams(self) -> int:
        return int(self.sym_bits.shape[0])

    @property
    def payload_bits(self) -> int:
        """Actual payload (paper-comparable footprint)."""
        return int(self.sym_bits.sum() + self.ofs_bits.sum())

    @property
    def total_bits(self) -> int:
        """Payload + table + directory (what a real store would hold)."""
        return (self.payload_bits + TABLE_OVERHEAD_BITS
                + DIR_BITS_PER_STREAM * self.n_streams)

    @property
    def slotted_bits(self) -> int:
        """Fixed-slot (padded-plane) footprint."""
        return 32 * (self.sym_plane.size + self.ofs_plane.size)

    @property
    def original_bits(self) -> int:
        return self.n_valid * self.bits

    def ratio(self, include_metadata: bool = True) -> float:
        denom = self.total_bits if include_metadata else self.payload_bits
        return self.original_bits / max(denom, 1)


# apack: allow-transfer(preempt event: the golden coder reads its table's host
# lists, a table that rides beside a snapshot's device planes)
def _pad_value(table: ApackTable) -> int:
    """A value with maximal probability — cheapest legal padding."""
    counts = np.diff(np.asarray(table.cum))
    s = int(np.argmax(counts))
    return table.v_min[s]


def split_streams(flat: np.ndarray, elems_per_stream: int) -> tuple[np.ndarray, int]:
    """Pad + reshape to [S, E]; returns (streams, n_valid)."""
    n = flat.shape[0]
    e = elems_per_stream
    s = max(1, -(-n // e))
    padded = np.zeros(s * e, dtype=flat.dtype)
    padded[:n] = flat
    return padded.reshape(s, e), n


def compress(values: np.ndarray, table: ApackTable | None = None,
             bits: int = 8, is_activation: bool = False,
             elems_per_stream: int = DEFAULT_ELEMS_PER_STREAM) -> CompressedTensor:
    """Reference (golden-codec) compressor.  Exact but Python-speed; the
    production path is ``kernels.fastpath.compress_np`` (``kernels.ops``
    underneath), which is bit-identical."""
    arr = np.asarray(values)
    shape = arr.shape
    flat = arr.reshape(-1).astype(np.int64)
    if table is None:
        table = table_for(flat, bits, is_activation)
    streams, n_valid = split_streams(flat, elems_per_stream)
    pad = _pad_value(table)
    if n_valid < streams.size:
        streams.reshape(-1)[n_valid:] = pad
    S, E = streams.shape
    sym_words_l, ofs_words_l = [], []
    sym_bits = np.zeros(S, np.int32)
    ofs_bits = np.zeros(S, np.int32)
    stored = np.zeros(S, bool)
    for si in range(S):
        try:
            sw, sb, ow, ob = ac_golden.encode_stream(streams[si], table)
        except OverflowError:
            sw, sb, ow, ob = [], 0, None, 0
        if sb + ob >= E * bits or ow is None:
            # stored mode: verbatim values in the offset plane
            stored[si] = True
            wr = ac_golden.BitWriter()
            for v in streams[si]:
                wr.put_bits(int(v), bits)
            sw, sb, ow, ob = [], 0, wr.to_words(), len(wr)
        sym_words_l.append(sw)
        ofs_words_l.append(ow)
        sym_bits[si], ofs_bits[si] = sb, ob
    w_sym = max((len(w) for w in sym_words_l), default=0)
    w_ofs = max((len(w) for w in ofs_words_l), default=0)
    sym_plane = np.zeros((w_sym, S), np.uint32)
    ofs_plane = np.zeros((w_ofs, S), np.uint32)
    for si in range(S):
        for wi, w in enumerate(sym_words_l[si]):
            sym_plane[wi, si] = w
        for wi, w in enumerate(ofs_words_l[si]):
            ofs_plane[wi, si] = w
    return CompressedTensor(shape=tuple(shape), bits=bits, table=table,
                            elems_per_stream=elems_per_stream, n_valid=n_valid,
                            sym_plane=sym_plane, ofs_plane=ofs_plane,
                            sym_bits=sym_bits, ofs_bits=ofs_bits, stored=stored)


# apack: allow-transfer(resume event (PagedKVCache.restore_state): the golden
# backend's host decoder over a host container)
def decompress(ct: CompressedTensor) -> np.ndarray:
    """Reference (golden-codec) decompressor."""
    S = ct.n_streams
    E = ct.elems_per_stream
    out = np.zeros((S, E), np.int64)
    for si in range(S):
        sym = [int(w) for w in ct.sym_plane[:, si]]
        ofs = [int(w) for w in ct.ofs_plane[:, si]]
        if ct.stored[si]:
            rd = ac_golden.BitReader(ofs, int(ct.ofs_bits[si]))
            out[si] = [rd.get_bits(ct.bits) for _ in range(E)]
        else:
            out[si] = ac_golden.decode_stream(sym, ofs, E, ct.table,
                                              int(ct.sym_bits[si]),
                                              int(ct.ofs_bits[si]))
    flat = out.reshape(-1)[:ct.n_valid]
    dtype = np.uint8 if ct.bits <= 8 else np.uint16
    return flat.astype(dtype).reshape(ct.shape)


def estimate_bits(hist: np.ndarray, table: ApackTable) -> float:
    """Exact-in-expectation footprint with the *quantized* counts: per value
    of symbol s, -log2(count_s/1024) AC bits + OL_s offset bits.  Used by
    large-tensor benchmarks where running the codec on every element would
    be wasteful; accurate to O(termination bits) per stream."""
    counts = np.diff(np.asarray(table.cum)).astype(np.float64)
    bounds = np.asarray(table.v_min)
    csum = np.concatenate([[0], np.cumsum(hist)])
    per_range = (csum[bounds[1:]] - csum[bounds[:-1]]).astype(np.float64)
    nz = per_range > 0
    bits = per_range[nz] * (-np.log2(counts[nz] / 1024.0)
                            + np.asarray(table.ol)[nz])
    return float(bits.sum())
