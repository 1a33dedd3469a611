"""APack decode: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/apack_decode.py`` (``decode_block`` :34,
``decode_pallas`` :87).  The kernel (``csrc/apack_decode.cu``) decodes one
stream per thread with the device function in ``csrc/apack_decode.cuh``,
which the fused attention kernel shares.  It takes a leading page axis:
``B`` pages of ``S`` streams, each page with its own table row.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def decode_plain(sym, ofs, stored, v_min, ol, cum, *, n_steps: int,
                 bits: int = 8) -> torch.Tensor:
    """Plain PyTorch decode (``ref.decode``): same arguments and result as
    :func:`decode`."""
    return ref.decode(sym, ofs, stored, v_min, ol, cum, n_steps, bits)


def staged_rows(n_steps: int, bits: int, ws: int, wo: int) -> tuple[int, int]:
    """Rows of the sym and ofs planes that the kernels decoding from shared
    memory (decompress-matmul, fused attention) stage per stream.  A stream
    coded in fewer than ``n_steps * bits`` bits (else the encoder stores it
    verbatim, its ofs plane holding those bits) reads at most that many
    bits from either plane, plus the words its 16-bit CODE window reaches
    past the end: ``ceil(n_steps * bits / 32)`` words and a margin.  Where
    that covers a whole plane of ``W`` words, ``W + 1`` rows: the plane and
    a row of zeros, which reads past the plane's end then find.  Rows past
    these are read from device memory, so the choice changes speed, never
    values."""
    words = -(-n_steps * bits // 32)

    def rows(margin: int, n_words: int) -> int:
        return n_words + 1 if words + margin >= n_words else words + margin
    return rows(4, ws), rows(2, wo)


def _rows(t: torch.Tensor, b: int, n: int) -> torch.Tensor:
    return t.to(torch.int32).expand(b, n).contiguous() if t.dim() == 1 \
        else t.to(torch.int32).reshape(b, n).contiguous()


def decode(sym: torch.Tensor, ofs: torch.Tensor, stored: torch.Tensor,
           v_min: torch.Tensor, ol: torch.Tensor, cum: torch.Tensor, *,
           n_steps: int, bits: int = 8) -> torch.Tensor:
    """Decode streams of APack planes into int32 values.

    sym int32 [..., Ws, S] and ofs int32 [..., Wo, S] hold the u32 words;
    stored [..., S]; tables [17]/[16]/[17], or one row per leading index.
    Returns int32 [..., S, n_steps].  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel or raises."""
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
    st = stored.to(torch.int32)
    vm, olr, cm = _rows(v_min, b, 17), _rows(ol, b, 16), _rows(cum, b, 17)
    out = torch.empty(*lead, s, n_steps, dtype=torch.int32, device=dev)
    ptrs = [_build.require(sym, torch.int32, (*lead, ws, s), "sym", dev),
            _build.require(ofs, torch.int32, (*lead, wo, s), "ofs", dev),
            _build.require(st, torch.int32, (*lead, s), "stored", dev),
            _build.require(vm, torch.int32, (b, 17), "v_min", dev),
            _build.require(olr, torch.int32, (b, 16), "ol", dev),
            _build.require(cm, torch.int32, (b, 17), "cum", dev),
            out.data_ptr()]
    if not 1 <= bits <= 16:
        raise ValueError(f"decode: bits={bits} outside [1, 16]")
    fn = _build.load("apack_decode").apack_decode_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(*ptrs, b, ws, wo, s, n_steps, bits, _build.stream_of(sym))
    _build.check(rc, "apack_decode")
    _build.LAUNCHES["apack_decode"] += 1
    return out
