"""Paged APack KV read helpers and the gather-decode kernel's wrapper.

Port of ``repro/kernels/paged_decode.py``: ``GATHER_BUCKETS`` :57,
``table_row`` :68, ``gather_bucket`` :80, ``page_bucket`` :113,
``_as_table_stack`` :136, ``gather_decode_pallas`` :162 (the CUDA kernel
``csrc/gather_decode.cu``) and ``gather_decode_ref`` :215 (the plain
version).

The gather decode turns an arbitrary list of pool pages, duplicates
allowed, each with its own row of the stacked table pool, into decoded
values in one launch; ``PagedKVCache.materialize`` (the ``kv_fused=False``
oracle) issues one per K/V kind and step, across every layer, with the ids
as host arrays: the wrapper checks them there and uploads them without a
synchronize, so the oracle's step does not wait for the card on their
account.  The JAX
package pads the page list to a bucket to bound its jit compiles and warns
when the set of buckets keeps growing; a CUDA launch compiles nothing per
size, so the port keeps the buckets (both packages then decode the same
padded list) and has no recompile-storm warning.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, apack_decode, ref

# Bucket sizes for the gathered page count: the page-index vector is padded
# up to the next bucket by repeating its last entry; past the table the
# bucket keeps doubling.
GATHER_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

# Per-job page-count buckets for the fused attention call: the engine sizes
# the page axis to the next power of two above the busiest active slot's
# occupied page count instead of the per-slot maximum.  Masked (FREE) page
# slots leave the online-softmax state exactly unchanged, so any bucket at
# or above the true count gives the same result.
PAGE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def table_row(gen: int, layer: int, kind: int, n_layers: int) -> int:
    """Flat row of table ``(generation, layer, kind)`` in the stacked
    ``[(G+1) * 2 * n_layers, ...]`` table pool.  ``kind`` (0 = K, 1 = V)
    varies fastest: the fused kernel receives only the K row per page and
    reads the V table at ``row + 1``."""
    return (gen * n_layers + layer) * 2 + kind


def _bucket(n: int, buckets: tuple) -> int:
    for b in buckets:
        if n <= b:
            return b
    bucket = buckets[-1]
    while bucket < n:
        bucket *= 2
    return bucket


def gather_bucket(n: int) -> int:
    return _bucket(n, GATHER_BUCKETS)


def page_bucket(n: int) -> int:
    return _bucket(max(int(n), 1), PAGE_BUCKETS)


def _as_table_stack(v_min, ol, cum, page_idx, table_idx):
    """Table arrays in stacked ``[T, ...]`` form plus a per-page row id:
    1-D tables (the single-table call) become a one-row stack with every
    page at row 0."""
    if v_min.dim() == 1:
        v_min, ol, cum = v_min[None], ol[None], cum[None]
    if table_idx is None:
        table_idx = torch.zeros_like(page_idx)
    return v_min, ol, cum, table_idx


def gather_decode_plain(sym, ofs, stored, page_idx, v_min, ol, cum, *,
                        n_steps: int, bits: int = 8,
                        table_idx=None) -> torch.Tensor:
    """Plain PyTorch gather decode (``gather_decode_ref``): gather the pages
    and their table rows, then ``ref.decode``.  Same arguments and result
    as :func:`gather_decode`."""
    page_idx = torch.as_tensor(page_idx, device=sym.device)
    if table_idx is not None:
        table_idx = torch.as_tensor(table_idx, device=sym.device)
    v_min, ol, cum, table_idx = _as_table_stack(v_min, ol, cum, page_idx,
                                                table_idx)
    p, t = page_idx.long(), table_idx.long()
    return ref.decode(sym[p], ofs[p], stored[p], v_min[t], ol[t], cum[t],
                      n_steps, bits)


def _check_spans(spans, n_pages: int, n_tables: int) -> None:
    """Raise unless the page ids' span ``(lo, hi)`` lies in [0, n_pages)
    and the table ids' in [0, n_tables)."""
    for name, (lo, hi), n in zip(("page", "table"), spans,
                                 (n_pages, n_tables)):
        if lo < 0 or hi >= n:
            raise IndexError(f"gather_decode: {name} ids span [{lo}, {hi}],"
                             f" outside [0, {n})")


def _host_ids(x):
    """``x`` as a numpy array if it lies on the host (a numpy array, a
    sequence or a CPU tensor), else None."""
    if torch.is_tensor(x):
        return x.numpy() if x.device.type == "cpu" else None
    return np.asarray(x)


def gather_decode(sym: torch.Tensor, ofs: torch.Tensor, stored: torch.Tensor,
                  page_idx, v_min: torch.Tensor, ol: torch.Tensor,
                  cum: torch.Tensor, *, n_steps: int, bits: int = 8,
                  table_idx=None) -> torch.Tensor:
    """Decode pages ``page_idx`` out of a pooled plane stack.

    sym int32 [P, Ws, S] and ofs int32 [P, Wo, S] hold the u32 words,
    stored [P, S]; page_idx int [G] (duplicates allowed); tables either
    one table ([17]/[16]/[17]) or a stack ([T, 17]/[T, 16]/[T, 17]) indexed
    per page by table_idx int [G].  Returns int32 [G, S, n_steps] in
    gather order.  Page and table ids outside the pool or the stack raise
    ``IndexError`` before any decode.

    The ids' place decides how they are checked.  Ids on the host (numpy
    arrays or CPU tensors, as ``PagedKVCache.materialize`` passes them) are
    checked there and uploaded without a synchronize; ids on the card are
    checked with one pull of their ranges, which waits for the card.  A CPU
    plane tensor takes the plain version; a CUDA one launches the kernel or
    raises."""
    _build.refuse_fake("gather_decode", sym, ofs, stored, page_idx,
                       table_idx, v_min, ol, cum)
    if not 1 <= bits <= 16:
        raise ValueError(f"gather_decode: bits={bits} outside [1, 16]")
    if v_min.dim() == 1:
        v_min, ol, cum = v_min[None], ol[None], cum[None]
    n_pages, n_tables = sym.shape[0], v_min.shape[0]
    pid = _host_ids(page_idx)
    if pid is not None:
        tid = (np.zeros_like(pid) if table_idx is None
               else _host_ids(table_idx))
        if tid is None:
            raise ValueError("gather_decode: page ids on the host but table "
                             "ids on the card")
        if pid.size:
            _check_spans(((int(pid.min()), int(pid.max())),
                          (int(tid.min()), int(tid.max()))), n_pages,
                         n_tables)
        ids = torch.from_numpy(np.stack([pid, tid]).astype(np.int32))
        if sym.device.type == "cpu":
            return gather_decode_plain(sym, ofs, stored, ids[0], v_min, ol,
                                       cum, n_steps=n_steps, bits=bits,
                                       table_idx=ids[1])
        if sym.device.type != "cuda":
            raise ValueError(f"gather_decode: unsupported device "
                             f"{sym.device}")
        # one asynchronous copy from pinned memory: no wait for the card
        ids = ids.pin_memory().to(sym.device, non_blocking=True)
        page_idx, table_idx = ids[0], ids[1]
    else:
        if table_idx is None:
            table_idx = torch.zeros_like(page_idx)
        if page_idx.numel():
            spans = torch.stack([x.long() for x in (
                page_idx.min(), page_idx.max(), table_idx.min(),
                table_idx.max())]).cpu().tolist()
            _check_spans((spans[:2], spans[2:]), n_pages, n_tables)
        if sym.device.type == "cpu":
            return gather_decode_plain(sym, ofs, stored, page_idx, v_min, ol,
                                       cum, n_steps=n_steps, bits=bits,
                                       table_idx=table_idx)
    return launch_gather_decode(sym, ofs, stored, page_idx, table_idx,
                                v_min, ol, cum, n_steps=n_steps, bits=bits)


def launch_gather_decode(sym: torch.Tensor, ofs: torch.Tensor,
                         stored: torch.Tensor, page_idx: torch.Tensor,
                         table_idx: torch.Tensor, v_min: torch.Tensor,
                         ol: torch.Tensor, cum: torch.Tensor, *,
                         n_steps: int, bits: int = 8) -> torch.Tensor:
    """Launch the gather-decode kernel: :func:`gather_decode` after its
    checks, on CUDA tensors only, with the ids already on the card and in
    range and the tables stacked [T, ...].  It issues no host sync, so a
    CUDA graph can capture it (``chip_smoke.py`` times it so)."""
    _build.refuse_fake("launch_gather_decode", sym, ofs, stored,
                       page_idx, table_idx, v_min, ol, cum)
    if sym.device.type != "cuda":
        raise ValueError(f"gather_decode: unsupported device {sym.device}")
    p, ws, s = sym.shape
    wo = ofs.shape[1]
    g = page_idx.shape[0]
    t = v_min.shape[0]
    dev = sym.device
    idx = page_idx.to(torch.int32).contiguous()
    tid = table_idx.to(torch.int32).contiguous()
    st = stored.to(torch.int32).contiguous()
    vm, olt, cm = (x.to(torch.int32).contiguous() for x in (v_min, ol, cum))
    out = torch.empty(g, s, n_steps, dtype=torch.int32, device=dev)
    ptrs = [_build.require(sym, torch.int32, (p, ws, s), "sym", dev),
            _build.require(ofs, torch.int32, (p, wo, s), "ofs", dev),
            _build.require(st, torch.int32, (p, s), "stored", dev),
            _build.require(idx, torch.int32, (g,), "page_idx", dev),
            _build.require(tid, torch.int32, (g,), "table_idx", dev),
            _build.require(vm, torch.int32, (t, 17), "v_min", dev),
            _build.require(olt, torch.int32, (t, 16), "ol", dev),
            _build.require(cm, torch.int32, (t, 17), "cum", dev),
            out.data_ptr()]
    rs, ro = apack_decode.staged_rows(n_steps, bits, ws, wo)
    fn = _build.load("gather_decode").gather_decode_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = _build.launch(fn, *ptrs, g, ws, wo, s, n_steps, bits, rs, ro,
                       on=sym)
    _build.check(rc, "gather_decode")
    _build.LAUNCHES["gather_decode"] += 1
    return out
