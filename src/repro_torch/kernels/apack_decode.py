"""APack decode: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/apack_decode.py`` (``decode_block`` :34,
``decode_pallas`` :87).  The kernel (``csrc/apack_decode.cu``) decodes one
page a block, one stream a thread, with the page body it shares with the
gather decode (``csrc/decode_page.cuh``) and the stream decoder every
decoding kernel shares (``csrc/apack_decode.cuh``).  It takes a leading
page axis: ``B`` pages of ``S`` streams, each page with its own table row
or all with one.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
# stored flags the kernel reads as they are, by their width in bytes
_STORED_BYTES = {torch.bool: 1, torch.uint8: 1, torch.int32: 4}


def decode_plain(sym, ofs, stored, v_min, ol, cum, *, n_steps: int,
                 bits: int = 8) -> torch.Tensor:
    """Plain PyTorch decode (``ref.decode``): same arguments and result as
    :func:`decode`."""
    return ref.decode(sym, ofs, stored, v_min, ol, cum, n_steps, bits)


def staged_rows(n_steps: int, bits: int, ws: int, wo: int) -> tuple[int, int]:
    """Rows of the sym and ofs planes that the decoding kernels stage in
    shared memory per stream.  A stream coded in fewer than ``n_steps *
    bits`` bits (else the encoder stores it verbatim, its ofs plane holding
    those bits) reads at most that many bits from either plane, plus the
    words its 16-bit CODE window reaches past the end: ``ceil(n_steps *
    bits / 32)`` words and a margin.  Where that covers a whole plane of
    ``W`` words, ``W + 1`` rows: the plane and a row of zeros, which reads
    past the plane's end then find.  Rows past these are read from device
    memory, so the choice changes speed, never values."""
    words = -(-n_steps * bits // 32)

    def rows(margin: int, n_words: int) -> int:
        return n_words + 1 if words + margin >= n_words else words + margin
    return rows(4, ws), rows(2, wo)


def page_staged(n_steps: int, bits: int, ws: int, wo: int, s: int) -> bool:
    """Whether :func:`decode` stages the rows of :func:`staged_rows` of
    [ws | wo, s] planes in shared memory, or reads the planes from device
    memory throughout: the built kernel's own decision (``page_staged`` of
    ``csrc/decode_page.cuh``), so it needs the kernel library."""
    fn = _build.load("apack_decode").apack_decode_page_staged
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    return bool(fn(*staged_rows(n_steps, bits, ws, wo), s))


def decode(sym: torch.Tensor, ofs: torch.Tensor, stored: torch.Tensor,
           v_min: torch.Tensor, ol: torch.Tensor, cum: torch.Tensor, *,
           n_steps: int, bits: int = 8) -> torch.Tensor:
    """Decode streams of APack planes into int32 values.

    sym int32 [..., Ws, S] and ofs int32 [..., Wo, S] hold the u32 words;
    stored [..., S]; tables [17]/[16]/[17], or one row per leading index.
    Returns int32 [..., S, n_steps].  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel or raises.  The launch is the call's
    only device work: a shared table row and int32 rows are read where they
    lie, and bool, uint8 or int32 stored flags as they are."""
    if not 1 <= bits <= 16:
        raise ValueError(f"decode: bits={bits} outside [1, 16]")
    if sym.device.type == "cpu":
        return decode_plain(sym, ofs, stored, v_min, ol, cum,
                            n_steps=n_steps, bits=bits)
    if sym.device.type != "cuda":
        raise ValueError(f"decode: unsupported device {sym.device}")
    lead = tuple(sym.shape[:-2])
    ws, s = sym.shape[-2:]
    wo = ofs.shape[-2]
    b = 1
    for n in lead:
        b *= n
    dev = sym.device
    st = stored if stored.dtype in _STORED_BYTES else stored.to(torch.int32)
    tabs = [_build.require_table(t, b, n, name, dev) for t, n, name in
            ((v_min, 17, "v_min"), (ol, 16, "ol"), (cum, 17, "cum"))]
    out = torch.empty(*lead, s, n_steps, dtype=torch.int32, device=dev)
    ptrs = [_build.require(sym, torch.int32, (*lead, ws, s), "sym", dev),
            _build.require(ofs, torch.int32, (*lead, wo, s), "ofs", dev),
            _build.require(st, st.dtype, (*lead, s), "stored", dev),
            *(rows.data_ptr() for rows, _ in tabs), out.data_ptr()]
    rs, ro = staged_rows(n_steps, bits, ws, wo)
    fn = _build.load("apack_decode").apack_decode_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(*ptrs, b, ws, wo, s, n_steps, bits, _STORED_BYTES[st.dtype],
            *(stride for _, stride in tabs), rs, ro, _build.stream_of(sym))
    _build.check(rc, "apack_decode")
    _build.LAUNCHES["apack_decode"] += 1
    return out
