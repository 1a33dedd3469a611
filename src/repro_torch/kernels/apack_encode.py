"""APack encode: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/apack_encode.py`` (``_encode_kernel`` :52,
``encode_pallas`` :144) together with the stored-mode selection the JAX
package runs around it (``ops.py:109-120``), so the result equals
``ref.encode`` (``repro/kernels/ref.py:387``).  The kernel
(``csrc/apack_encode.cu``) encodes one stream per thread and takes a
leading page axis, each page with its own table row or all with one; the
launch is a call's only device work.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def encode_plain(values, v_min, ol, cum, *, n_steps: int, bits: int = 8):
    """Plain PyTorch encode (``ref.encode``): same arguments and result as
    :func:`encode`."""
    return ref.encode(values, v_min, ol, cum, n_steps, bits)


def encode(values: torch.Tensor, v_min: torch.Tensor, ol: torch.Tensor,
           cum: torch.Tensor, *, n_steps: int, bits: int = 8):
    """Encode streams of unsigned values int32 [..., S, n_steps].

    Returns ``(sym int32 [..., Ws, S], ofs int32 [..., Wo, S], sym_bits
    int32 [..., S], ofs_bits int32 [..., S], stored bool [..., S])`` with
    the u32 words in int32 tensors; ``Ws``/``Wo`` are
    ``ref.sym_capacity_words``/``ref.ofs_capacity_words``.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises."""
    _build.refuse_fake("encode", values, v_min, ol, cum)
    if values.device.type == "cpu":
        return encode_plain(values, v_min, ol, cum, n_steps=n_steps,
                            bits=bits)
    if values.device.type != "cuda":
        raise ValueError(f"encode: unsupported device {values.device}")
    if not 1 <= bits <= 16:
        raise ValueError(f"encode: bits={bits} outside [1, 16]")
    lead = tuple(values.shape[:-2])
    s = values.shape[-2]
    b = 1
    for n in lead:
        b *= n
    dev = values.device
    ws = ref.sym_capacity_words(n_steps)
    wo = ref.ofs_capacity_words(n_steps, bits)
    tabs = [_build.require_table(t, b, n, name, dev) for t, n, name in
            ((v_min, 17, "v_min"), (ol, 16, "ol"), (cum, 17, "cum"))]
    sym = torch.empty(*lead, ws, s, dtype=torch.int32, device=dev)
    ofs = torch.empty(*lead, wo, s, dtype=torch.int32, device=dev)
    sym_bits = torch.empty(*lead, s, dtype=torch.int32, device=dev)
    ofs_bits = torch.empty(*lead, s, dtype=torch.int32, device=dev)
    stored = torch.empty(*lead, s, dtype=torch.bool, device=dev)
    ptrs = [_build.require(values, torch.int32, (*lead, s, n_steps),
                           "values", dev),
            *(rows.data_ptr() for rows, _ in tabs),
            sym.data_ptr(), ofs.data_ptr(), sym_bits.data_ptr(),
            ofs_bits.data_ptr(), stored.data_ptr()]
    fn = _build.load("apack_encode").apack_encode_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = _build.launch(fn, *ptrs, b, s, n_steps, bits, ws, wo,
                       *(stride for _, stride in tabs), on=values)
    _build.check(rc, "apack_encode")
    _build.LAUNCHES["apack_encode"] += 1
    return sym, ofs, sym_bits, ofs_bits, stored
