#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card's name and power limit, and the host CPU's model and
   clock; build the five CUDA kernels from ``src/repro_torch/kernels/csrc``
   with nvcc (one process each, all started together);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the paths give it: APack decode and encode bit-exact (bits
   4/8/16, stored streams included; both also at the serve's pack shapes
   [2, 28 | 560, 128, 128] and decode at one page; decode with bool and
   int32 stored flags and with a shared and a per-page table row, and one
   decode call a single device kernel in a profiler window), fused paged
   attention within an f32 tolerance on a mixed HOT/COLD/PACKED/FREE pool
   at the full-width page shape (page tables of 16, 7 and 1 slots, a job
   all FREE), the
   decompress-matmul at qwen3-1.7b's w_up and w_down shapes (plus a tensor
   of stored streams) at M = 1, 4, 8, 9 and a prefill M, there also
   bit-exact on integer inputs and against an f64 product, and the gather
   decode bit-exact at G = 1024, 1 and 3 gathered pages (ids on the host
   and on the card); time kernel, plain version, bound and the PyTorch
   library yardstick where one exists (kernel and yardstick as device time
   per call over a CUDA graph of 20 calls; the gather decode and the
   decompress-matmul also eagerly), and the decompress-matmul's staging of
   its planes alone; encode and decode also at the weight round trip's
   shape, [688128 streams, 512 values] at 8 bits under one shared table
   row, and at 16 bits (the decode kernel's unstaged path), bit-exact on
   the whole tensor and against the plain versions on sampled streams,
   and through ``ops``/``fastpath`` (uint8 and ``torch.uint16`` values);
3. serve qwen3-1.7b from dense weights through the fused paged APack KV
   path at full width and depth (28 layers, seeded random weights; 8
   requests, prompts of 64-96 tokens, 48 new tokens each), launch counts
   reset just before and read just after;
4. serve the same requests from APack-packed weights
   (``weights="apack-int8"``) and the paged APack KV cache, the main path,
   with its own launch counts; after the serve, build the oracle stores
   from a host copy of the f32 weights; check every packed site of two
   layers against f32 and f64 products; re-score the packed engine's
   sequences teacher-forced under the packed store, its f32 and f64
   oracles and the dense store dequantized from the same int8 codes;
   profile steady steps of both engines;
5. serve the same requests through the materialize oracle
   (``kv_fused=False``), whose launch counts give the gather decode's;
   between steps, while the pages are HOT and COLD and again while they
   are HOT and PACKED, hold ``materialize`` through the kernel bit-exact
   against the plain decode and the fused attention kernel at the first
   and last layer against dense attention over the materialized cache;
   print token agreement with the fused serve; profile steady steps;
6. serve them on the fused path with slot 0 preempted after ten decode
   steps and resumed: the tokens must equal phase 3's;
7. serve them from a dense int8 KV cache, the uncompressed baseline, and
   profile steady steps;
8. the JAX CLI's default weight path at full width: ``compress_params``
   (quantize, histogram, table search, the encode kernel, the pull of the
   trimmed planes) then ``decompress_params`` (upload, the decode kernel,
   dequantization), timed in parts with its own launch counts; every
   decompressed leaf must equal the codec-free dequantization of the same
   int8 codes bit for bit, and the plain encoder and decoder on the card
   must give the kernels' columns on 1,024 streams from each end of every
   distinct container shape; then serve the 8 requests from the
   round-tripped weights on the fused paged APack KV path, with the token
   agreement against phase 3 printed;
9. check SMOKE-width engines (fused, packed, oracle, dense int8 and bf16
   caches, and the fused one on round-tripped weights, whose
   ``compress_params`` containers must match too) on the card against the
   same engines on the CPU, and the oracle's tokens against the fused
   engine's on the card;
10. after each paged serve, decode every PACKED KV page captured mid-serve
    with the decode kernel and with the plain decoder, and re-encode a
    sample with the plain encoder;
11. print the ``kernels`` JSON line, then the result line.

It exits non-zero without a result when CUDA is unavailable or when it is
not run from a checkout of the repository.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
F32_FLOPS = 67e12                 # H100 SXM f32 outside the tensor cores
PAGE = dict(ps=16, h=8, dh=128, hq=16)   # qwen3-1.7b page [16, 8, 128]
AGREEMENT_GATE = 0.98             # the reference's teacher-forced gate
F64_ERR_RATIO = 4.0               # kernel vs f64 <= this x cuBLAS f32 vs f64
RMS_DRIFT_RATIO = 1.5             # packed drift <= this x f32 oracle's drift
# (bits, streams) of the codec at the weight round trip's shape: a stacked
# w_up of qwen3-1.7b, 28 x 2048 x 6144 values in streams of 512, and a
# 16-bit case
FASTPATH_CASES = ((8, 688128), (16, 32768))
PORT_KERNELS = ("apack_decode_kernel", "apack_encode_kernel",   # csrc/*.cu
                "fused_page_attention_kernel",
                "fused_page_attention_combine_kernel",
                "decompress_tile_kernel", "ktile_sum_kernel",
                "gather_decode_kernel")


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed and timed with CUDA events, so the host's cost of a
    call (Python, ctypes, allocation) is not counted.  For kernels whose
    device time is below that cost, where back-to-back eager calls would
    time the host (``cuda_ms``).  Every capture uses the one default
    capture stream: a new stream per call would leave a cuBLAS workspace
    cached for each, which the serves' peak memory would then count."""
    import torch
    fn()                    # warm up (builds, caches) outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    graph.reset()           # free the graph's memory pool now
    return start.elapsed_time(end) / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def coded_words(sym_bits, ofs_bits, ws: int, wo: int):
    """u32 words of the sym and ofs planes that a decoder of these streams
    must read, per stream: the coded bits rounded up to words, plus the one
    word past the end that its 16-bit CODE window reaches, within the
    planes' capacity (``ws``/``wo``).  The rest of each plane is padding."""
    import torch

    def words(b, cap):
        w = torch.clamp((b.long() + 31) // 32 + 1, max=cap)
        return torch.where(b > 0, w, 0)
    return words(sym_bits, ws) + words(ofs_bits, wo)


def host_line() -> str:
    """The host CPU: its model (``model name`` in /proc/cpuinfo, else
    ``lscpu``'s) with its vendor, family, model and stepping, its logical
    CPU count, the current clock of its cores (``cpu MHz``: least, median,
    most) and the rated maximum that ``lscpu`` gives.  Serve step times
    are host-bound and move between calls with the host."""
    try:
        with open("/proc/cpuinfo") as f:
            info = f.read().splitlines()
    except OSError:
        info = []
    try:
        lscpu = subprocess.run(["lscpu"], capture_output=True, text=True,
                               timeout=30).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        lscpu = []

    def field(lines, key):
        return [ln.split(":", 1)[1].strip() for ln in lines
                if ":" in ln and ln.split(":", 1)[0].strip() == key]
    known = [m for m in field(info, "model name") + field(lscpu, "Model name")
             if m.lower() not in ("", "unknown")]
    ident = ", ".join(f"{k} {(field(info, k) or ['?'])[0]}" for k in
                      ("vendor_id", "cpu family", "model", "stepping"))
    model = f"{known[0] if known else 'model name unknown'} ({ident})"
    mhz = sorted(float(x) for x in field(info, "cpu MHz"))
    clock = (f"cpu MHz {mhz[0]:.0f} / {mhz[len(mhz) // 2]:.0f} / "
             f"{mhz[-1]:.0f} (least / median / most)" if mhz
             else "cpu MHz not reported")
    rated = field(lscpu, "CPU max MHz") or ["not reported"]
    return (f"host: {model}, {os.cpu_count()} logical CPUs, {clock}, "
            f"CPU max MHz {rated[0]}")


# ----------------------------------------------------------------- phase 2
def kv_like_values(n_pages, s, e, device):
    """u8 values shaped like int8 KV: a Laplace body around 0 in two's
    complement, one page per row."""
    import torch
    x = torch.distributions.Laplace(0.0, 18.0).sample((n_pages, s, e))
    q = torch.clamp(torch.round(x), -127, 127).to(torch.int32)
    return (q & 0xFF).to(device)


def codec_inputs(device):
    """Cases for the codec check: the KV page shape (8-bit, 64 pages) with
    an activation table, plus 4- and 16-bit cases, a stored (uniform
    table) case and streams forced into stored mode by random data."""
    import torch
    from repro_torch.core.tables import find_table, histogram, uniform_table
    from repro_torch.kernels import ref
    torch.manual_seed(0)
    cases = []
    vals = kv_like_values(64, 128, 128, device)
    # a few streams of uniform noise: AC would inflate them -> stored
    vals[:, :8] = torch.randint(0, 256, (64, 8, 128), device=device,
                                dtype=torch.int32)
    t = find_table(histogram(vals.cpu().numpy(), 8), 8, is_activation=True)
    cases.append(("kv8", vals, t, 8))
    v4 = torch.clamp(torch.round(torch.randn(4, 37, 33) * 2) + 8, 0,
                     15).to(torch.int32).to(device)
    cases.append(("b4", v4, find_table(histogram(v4.cpu().numpy(), 4), 4,
                                       is_activation=True), 4))
    v16 = torch.clamp(torch.round(torch.randn(2, 130, 7) * 900) + 32768, 0,
                      65535).to(torch.int32).to(device)
    cases.append(("b16", v16, find_table(histogram(v16.cpu().numpy(), 16),
                                         16, is_activation=True), 16))
    cases.append(("stored", vals[:4], uniform_table(8), 8))
    return [(name, v, ref.table_tensors(t, device), bits)
            for name, v, t, bits in cases]


def table_rows(vals, n_rows, bits=8):
    """``n_rows`` activation tables, row r fitted to the pages p with
    p % n_rows == r of ``vals`` [pages, S, E], as stacked int32 tensors
    (v_min [n_rows, 17], ol [n_rows, 16], cum [n_rows, 17]), and each
    page's row."""
    import numpy as np
    import torch
    from repro_torch.core.tables import find_table, histogram
    rows = torch.arange(vals.shape[0], device=vals.device) % n_rows
    tabs = [find_table(histogram(vals[rows == r].cpu().numpy(), bits), bits,
                       is_activation=True).as_arrays() for r in range(n_rows)]
    return tuple(torch.as_tensor(np.stack([t[i] for t in tabs]),
                                 dtype=torch.int32, device=vals.device)
                 for i in range(3)), rows


def check_encode(name, vals, tabs, bits):
    """The encode kernel bit-exact against the plain encoder; returns the
    kernel's result."""
    import torch
    from repro_torch.kernels import apack_encode
    e = vals.shape[-1]
    got = apack_encode.encode(vals, *tabs, n_steps=e, bits=bits)
    want = apack_encode.encode_plain(vals, *tabs, n_steps=e, bits=bits)
    for g, w, what in zip(got, want, ("sym", "ofs", "sym_bits", "ofs_bits",
                                      "stored")):
        if not torch.equal(g, w):
            raise AssertionError(f"encode {name}: {what} differs")
    return got


def encode_timing(vals, tabs, bits, got, iters=20, sample=None):
    """Device ms of the encode kernel and of the plain version, and the
    bound: the values and table rows read once, the whole planes, bit
    counts and flags written once.  ``sample`` (stream indices) times the
    plain version on those streams only, for shapes whose plain encode
    would not fit the card."""
    from repro_torch.kernels import apack_encode
    e = vals.shape[-1]
    ms = graph_ms(lambda: apack_encode.encode(vals, *tabs, n_steps=e,
                                              bits=bits), iters)
    pv = vals if sample is None else vals[sample]
    plain = cuda_ms(lambda: apack_encode.encode_plain(
        pv, *tabs, n_steps=e, bits=bits), 1)
    return dict(ms=ms, plain_ms=plain, max_abs_err=0,
                bound_ms=nbytes(vals, *tabs, *got) / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", library_ms=None, shape=list(vals.shape),
                plain_shape=list(pv.shape))


def check_decode(name, planes, tabs, bits, vals):
    """The decode kernel on encoded planes, bit-exact against the plain
    decoder and the encoded values; bool and int32 stored flags give
    identical outputs, and so do one shared 1-D table row and the same row
    copied out to every page.  Returns the kernel's output."""
    import torch
    from repro_torch.kernels import apack_decode
    sym, ofs, st = planes[0], planes[1], planes[4]
    kw = dict(n_steps=vals.shape[-1], bits=bits)
    got = apack_decode.decode(sym, ofs, st, *tabs, **kw)
    want = apack_decode.decode_plain(sym, ofs, st, *tabs, **kw)
    if not torch.equal(got, want) or not torch.equal(got, vals):
        raise AssertionError(f"decode {name}: not bit-exact")
    variants = {"int32 stored": apack_decode.decode(
        sym, ofs, st.to(torch.int32), *tabs, **kw)}
    if tabs[0].dim() == 1:
        lead = tuple(sym.shape[:-2])
        variants["row per page"] = apack_decode.decode(
            sym, ofs, st, *(t.expand(*lead, t.shape[-1]).contiguous()
                            for t in tabs), **kw)
    for what, out in variants.items():
        if not torch.equal(out, got):
            raise AssertionError(f"decode {name}: {what} differs")
    return got


def decode_timing(planes, tabs, bits, out, iters=20, sample=None):
    """Device ms of the decode kernel and of the plain version, and the
    bound: the coded words of each stream (+1 word) read once, the stored
    flags and table rows as given, the int32 output written once.
    ``sample`` (stream indices of a [W, S] plane) times the plain version
    on those streams only."""
    from repro_torch.kernels import apack_decode
    sym, ofs, sb, ob, st = planes
    kw = dict(n_steps=out.shape[-1], bits=bits)
    ms = graph_ms(lambda: apack_decode.decode(sym, ofs, st, *tabs, **kw),
                  iters)
    ps, po, pst = ((sym, ofs, st) if sample is None else
                   (sym[:, sample], ofs[:, sample], st[sample]))
    plain = cuda_ms(lambda: apack_decode.decode_plain(ps, po, pst, *tabs,
                                                      **kw), 1)
    read = 4 * int(coded_words(sb, ob, sym.shape[-2], ofs.shape[-2]).sum())
    read += nbytes(st, *tabs, out)
    return dict(ms=ms, plain_ms=plain, max_abs_err=0,
                bound_ms=read / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                library_ms=None, shape=list(out.shape),
                plain_shape=list(out.shape) if sample is None
                else [len(sample), out.shape[-1]],
                staged=apack_decode.page_staged(out.shape[-1], bits,
                                                sym.shape[-2], ofs.shape[-2],
                                                sym.shape[-1]))


def device_kernels(fn) -> list:
    """Names of the device kernels that one call of ``fn`` runs: a
    torch.profiler window over the call, after a call outside it."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if "CUDA" in str(getattr(e, "device_type", ""))]


def check_codec(device, records):
    """Encode and decode kernels bit-exact at the codec cases, the serve's
    pack shapes and one page; timed at the codec shape, the pack shapes
    and (decode) one page; then one decode call at the codec shape must
    run one device kernel, the decode kernel."""
    import torch
    from repro_torch.kernels import apack_decode
    for name, vals, tabs, bits in codec_inputs(device):
        e = vals.shape[-1]
        got = check_encode(name, vals, tabs, bits)
        dec = check_decode(name, got, tabs, bits, vals)
        n_stored = int(got[4].sum())
        print(f"codec {name}: shape {tuple(vals.shape)} bits {bits} "
              f"stored {n_stored} bit-exact (decode: bool and int32 stored, "
              "shared and per-page table rows)")
        if name != "kv8":
            continue
        assert 0 < n_stored < got[4].numel(), "kv8 must mix stored and AC"
        # timing at the KV page shape (64 pages x 128 streams x 128 values)
        records["apack_encode"] = encode_timing(vals, tabs, bits, got)
        records["apack_decode"] = decode_timing(got, tabs, bits, dec)
        for k in ("apack_encode", "apack_decode"):
            print(f"{k}: " + json.dumps(records[k]))
        codec = (got, tabs, e, bits)
        # one page: a single block, so its time is one stream's chain
        page = tuple(p[:1] for p in got)
        one = check_decode("one page", page, tabs, bits, vals[:1])
        print("apack_decode one page (chain floor): bit-exact; "
              + json.dumps(decode_timing(page, tabs, bits, one)))
    # the serve's pack shapes: [2 kinds, n pages, 128 streams, 128 values],
    # a decode step's seal of one slot (28 layers) and a prefill's seal of
    # four slots of 5 pages each; each page with its layer's table row
    for n in (28, 560):
        vals = kv_like_values(2 * n, 128, 128, device)
        vals[:, :4] = torch.randint(0, 256, (2 * n, 4, 128), device=device,
                                    dtype=torch.int32)
        (vm, ol, cm), rows = table_rows(vals, 4)
        shape = (2, n, 128, 128)
        vals = vals.reshape(shape)
        tabs = tuple(t[rows].reshape(2, n, -1) for t in (vm, ol, cm))
        got = check_encode(f"pack n={n}", vals, tabs, 8)
        row = encode_timing(vals, tabs, 8, got)
        row["stored"] = int(got[4].sum())
        print(f"apack_encode pack n={n}: bit-exact; " + json.dumps(row))
        dec = check_decode(f"pack n={n}", got, tabs, 8, vals)
        print(f"apack_decode pack n={n}: bit-exact (bool and int32 stored); "
              + json.dumps(decode_timing(got, tabs, 8, dec)))
    got, tabs, e, bits = codec
    names = device_kernels(lambda: apack_decode.decode(
        got[0], got[1], got[4], *tabs, n_steps=e, bits=bits))
    print(f"apack_decode: one call at the codec shape runs {len(names)} "
          f"device kernel(s): {names}")
    if len(names) != 1 or "apack_decode_kernel" not in names[0]:
        raise AssertionError("apack_decode: one call must run the decode "
                             "kernel alone")


def end_streams(n_streams: int, k: int = 1024, device="cuda"):
    """Indices of the first and the last ``k`` streams (every stream when
    there are no more than 2k), on the card."""
    import torch
    idx = torch.arange(n_streams, device=device)
    return idx if n_streams <= 2 * k else torch.cat([idx[:k], idx[-k:]])


def weight_codes(n_streams, e, bits, device, seed=7):
    """Unsigned codes of normal weights quantized per column
    (``quantize_symmetric(axis=-1)``, 6144 columns at 8 bits as in a
    stacked w_up, 512 at 16), as [n_streams, e] int32 streams."""
    import torch
    from repro_torch.core import quant
    g = torch.Generator(device=device).manual_seed(seed)
    cols = 6144 if bits == 8 else 512
    w = torch.randn(n_streams * e // cols, cols, generator=g, device=device)
    q, _ = quant.quantize_symmetric(w, bits=bits, axis=-1)
    del w
    return quant.to_unsigned(q, bits).reshape(n_streams, e)


def check_fastpath_shapes(device, records):
    """Encode and decode kernels at the shape the weight round trip gives
    them: one table row shared by every stream, no page axis, 512-value
    streams, [688128, 512] at 8 bits (a stacked w_up, w_gate or w_down of
    qwen3-1.7b) and [32768, 512] at 16 bits, whose capacity planes take
    the decode kernel's unstaged path.  The kernels' planes, bit counts and
    flags equal the plain encoder's on the first and last 1,024 streams,
    the decode kernel gives back every value and equals the plain decoder
    on those streams; both are timed (graph of 3 calls; the plain versions
    on the sampled streams).  Then ``fastpath`` round-trips the same
    values through the trimmed host container, uint8 or ``torch.uint16``
    out."""
    import numpy as np
    import torch
    from repro_torch.core.tables import find_table
    from repro_torch.kernels import apack_decode, apack_encode, fastpath, ref
    e = 512
    for bits, n in FASTPATH_CASES:
        vals = weight_codes(n, e, bits, device)
        hist = torch.bincount(vals.reshape(-1), minlength=1 << bits)
        table = find_table(hist.cpu().numpy().astype(np.int64), bits,
                           is_activation=False)
        tabs = ref.table_tensors(table, device)
        kw = dict(n_steps=e, bits=bits)
        got = apack_encode.encode(vals, *tabs, **kw)
        idx = end_streams(n)
        want = apack_encode.encode_plain(vals[idx], *tabs, **kw)
        for g, w, what in zip(got, want, ("sym", "ofs", "sym_bits",
                                          "ofs_bits", "stored")):
            if not torch.equal(g[..., idx], w):
                raise AssertionError(f"encode fastpath bits={bits}: {what} "
                                     "differs from the plain encoder")
        dec = apack_decode.decode(got[0], got[1], got[4], *tabs, **kw)
        plain = apack_decode.decode_plain(got[0][:, idx], got[1][:, idx],
                                          got[4][idx], *tabs, **kw)
        if not torch.equal(dec, vals) or not torch.equal(dec[idx], plain):
            raise AssertionError(f"decode fastpath bits={bits}: not "
                                 "bit-exact")
        enc = encode_timing(vals, tabs, bits, got, iters=3, sample=idx)
        enc["stored"] = int(got[4].sum())
        dct = decode_timing(got, tabs, bits, dec, iters=3, sample=idx)
        if dct["staged"] != (bits == 8):
            raise AssertionError(f"decode fastpath bits={bits}: staged="
                                 f"{dct['staged']}, the case is chosen for "
                                 "the other path")
        del dec, plain, want
        ct = fastpath.compress_tensor(vals, table, bits)
        back = fastpath.decompress_tensor(ct, device)
        want_dtype = torch.uint8 if bits == 8 else torch.uint16
        if back.dtype != want_dtype or not torch.equal(back.to(torch.int32),
                                                       vals):
            raise AssertionError(f"fastpath bits={bits}: {back.dtype} out, "
                                 "or not the values")
        trimmed = dict(ws=int(ct.sym_plane.shape[0]),
                       wo=int(ct.ofs_plane.shape[0]),
                       staged=apack_decode.page_staged(
                           e, bits, ct.sym_plane.shape[0] or 1,
                           ct.ofs_plane.shape[0] or 1, n),
                       ratio=ct.ratio())
        records[f"fastpath{bits}"] = dict(encode=enc, decode=dct,
                                          trimmed=trimmed)
        print(f"codec fastpath bits={bits}: [{n}, {e}] one table row, "
              f"planes [{got[0].shape[0]} | {got[1].shape[0]}, {n}] "
              f"bit-exact (plain on {len(idx)} streams), fastpath "
              f"{back.dtype} round trip exact; "
              + json.dumps(records[f"fastpath{bits}"]))
        del vals, got, back, ct
        torch.cuda.empty_cache()


def mixed_pool(device, jobs=4, p_slots=16, pool_pages=96):
    """A pool in every lifecycle state at the full-width page shape, and
    page tables whose slots mix HOT, COLD, PACKED and FREE pages (three
    FREE padding slots when there are more than four, else a PACKED first
    slot), the last job's slots all FREE."""
    import torch
    from repro_torch.core.tables import find_table, histogram
    from repro_torch.kernels import apack_encode, ref
    ps, h, dh, hq = PAGE["ps"], PAGE["h"], PAGE["dh"], PAGE["hq"]
    s = e = 128
    g = torch.Generator(device="cpu").manual_seed(1)

    def i8(*shape):
        x = torch.distributions.Laplace(0.0, 18.0).sample(shape)
        return torch.clamp(torch.round(x), -127, 127).to(torch.int8)

    planes = {
        "tok_k": i8(pool_pages, ps, h, dh), "tok_v": i8(pool_pages, ps, h, dh),
        "tok_sk": torch.rand(pool_pages, ps, h, generator=g) * 0.02 + 0.01,
        "tok_sv": torch.rand(pool_pages, ps, h, generator=g) * 0.02 + 0.01,
        "cold_k": i8(pool_pages, ps, h, dh),
        "cold_v": i8(pool_pages, ps, h, dh),
        "pscale_k": torch.rand(pool_pages, h, generator=g) * 0.02 + 0.01,
        "pscale_v": torch.rand(pool_pages, h, generator=g) * 0.02 + 0.01,
    }
    planes = {k: v.to(device) for k, v in planes.items()}
    rows = []
    packed_bytes = 0                 # coded bytes of each PACKED page, K+V
    for kind in "kv":
        u = (planes[f"cold_{kind}"].to(torch.int32) & 0xFF).reshape(
            pool_pages, s, e)
        t = find_table(histogram(u.cpu().numpy(), 8), 8, is_activation=True)
        tabs = ref.table_tensors(t, device)
        rows.append(tabs)
        sym, ofs, sb, ob, st = apack_encode.encode_plain(u, *tabs,
                                                         n_steps=e, bits=8)
        planes[f"sym_{kind}"] = sym
        planes[f"ofs_{kind}"] = ofs
        planes[f"stored_{kind}"] = st.to(torch.int32)
        packed_bytes = packed_bytes + 4 * coded_words(
            sb, ob, sym.shape[-2], ofs.shape[-2]).sum(-1).cpu() + 4 * s
    planes["vm"] = torch.stack([rows[0][0], rows[1][0]])
    planes["ol"] = torch.stack([rows[0][1], rows[1][1]])
    planes["cum"] = torch.stack([rows[0][2], rows[1][2]])
    pid = torch.randint(0, pool_pages, (jobs, p_slots), generator=g)
    state = torch.randint(1, 4, (jobs, p_slots), generator=g)
    pad = 3 if p_slots > 4 else 0
    if pad:
        state[:, -pad:] = 0                             # FREE padding
    else:
        state[:, 0] = 3                                 # a PACKED page each
    state[-1] = 0                                       # a fully masked job
    t0 = torch.arange(p_slots)[None, :].expand(jobs, p_slots) * ps
    qpos = torch.full((jobs,), (p_slots - pad) * ps - 5)
    window = torch.tensor([0, 0, 3 * ps, 0])[:jobs]
    meta = torch.stack([state, t0], -1).to(torch.int32)
    jobmeta = torch.stack([qpos, window], -1).to(torch.int32)
    q = torch.randn(jobs, hq, dh, generator=g)
    return (q.to(device), pid.to(torch.int32).to(device),
            torch.zeros(jobs, p_slots, dtype=torch.int32, device=device),
            meta.to(device), jobmeta.to(device), planes, packed_bytes)


def attention_bound(q, pid, tid, meta, jobmeta, planes, packed_bytes, acc, m,
                    l):
    """Least bytes and flops for the call's data: q, the metadata, the
    table rows, each distinct (page, state) that a slot names, read once in
    the form its state stores (a PACKED page as its coded words and stored
    flags, from ``packed_bytes``), and the outputs; flops of QK and PV over
    the tokens that pass the mask."""
    import torch
    ps, h, dh, hq = PAGE["ps"], PAGE["h"], PAGE["dh"], PAGE["hq"]
    st = meta[..., 0].cpu()
    read = 0
    for p, s in set(zip(pid.cpu().reshape(-1).tolist(),
                        st.reshape(-1).tolist())):
        read += {0: 0, 1: 2 * (ps * h * dh + ps * h * 4),
                 2: 2 * (ps * h * dh + h * 4),
                 3: int(packed_bytes[p]) + 2 * h * 4}[s]
    total = read + nbytes(q, pid, tid, meta, jobmeta, planes["vm"],
                          planes["ol"], planes["cum"], acc, m, l)
    pos = meta[..., 1:2].cpu() + torch.arange(ps)
    qpos = jobmeta[:, 0, None, None].cpu()
    win = jobmeta[:, 1, None, None].cpu()
    valid = (pos < qpos) & (st[..., None] != 0)
    valid &= torch.where(win > 0, pos > qpos - win, True)
    flops = 4 * hq * dh * int(valid.sum())
    return max(total / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3, (
        "bytes" if total / HBM_BYTES_PER_S >= flops / F32_FLOPS
        else "operations")


def check_attention(device, records):
    """The fused attention kernel (split pages and combine pass) against
    its plain version on the card: page tables of 16, 7 (odd) and 1 slots,
    each with a job whose slots are all FREE, with and without the
    softcap; timed at J = 4, P = 16."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_page_attention as fpa
    from repro_torch.kernels.fused_page_attention import _page_tiles
    err = 0.0
    for p_slots in (1, 7, 16):
        q, pid, tid, meta, jobmeta, planes, packed_bytes = mixed_pool(
            device, p_slots=p_slots)
        for softcap in (0.0, 30.0):
            kw = dict(n_steps=128, softcap=softcap)
            got = fpa.fused_page_attention(q, pid, tid, meta, jobmeta,
                                           planes, **kw)
            want = fpa.fused_page_attention_plain(q, pid, tid, meta, jobmeta,
                                                  planes, **kw)
            torch.cuda.synchronize()
            # f32 throughout; the kernel sums each page's dot products in
            # another order than the plain einsum and merges the pages'
            # partials once, hence rtol 1e-5 / atol 1e-6 on acc and l (m
            # is a max of the same scores)
            case_err = 0.0
            for g_, w_, what in zip(got, want, ("acc", "m", "l")):
                if not torch.allclose(g_, w_, rtol=1e-5, atol=1e-6):
                    raise AssertionError(
                        f"fused attention P={p_slots} softcap={softcap}: "
                        f"{what} off by {(g_ - w_).abs().max().item()}")
                case_err = max(case_err, (g_ - w_).abs().max().item())
            if not bool((got[2][-1] == 0).all()):
                raise AssertionError("fused attention: the all-FREE job "
                                     "accumulated weight")
            err = max(err, case_err)
            print(f"fused_page_attention softcap={softcap}: "
                  f"J={q.shape[0]} P={pid.shape[1]} (last job all FREE) "
                  f"max_abs_err={case_err:.3g}")
    kw = dict(n_steps=128, softcap=0.0)
    acc, m, l = fpa.fused_page_attention(q, pid, tid, meta, jobmeta, planes,
                                         **kw)
    ms = graph_ms(lambda: fpa.fused_page_attention(
        q, pid, tid, meta, jobmeta, planes, **kw), 20)
    eager = cuda_ms(lambda: fpa.fused_page_attention(
        q, pid, tid, meta, jobmeta, planes, **kw), 20)
    plain = cuda_ms(lambda: fpa.fused_page_attention_plain(
        q, pid, tid, meta, jobmeta, planes, **kw), 2)
    bound, by = attention_bound(q, pid, tid, meta, jobmeta, planes,
                                packed_bytes, acc, m, l)
    # yardstick: SDPA over the equivalent dense dequantized cache
    kt, vt = _page_tiles(planes, pid, tid, meta[..., 0], 128, 8)
    j, p = pid.shape
    ps, h, dh, hq = PAGE["ps"], PAGE["h"], PAGE["dh"], PAGE["hq"]
    kd = kt.reshape(j, p * ps, h, dh).transpose(1, 2).repeat_interleave(
        hq // h, dim=1).contiguous()
    vd = vt.reshape(j, p * ps, h, dh).transpose(1, 2).repeat_interleave(
        hq // h, dim=1).contiguous()
    pos = meta[..., 1:2] + torch.arange(ps, device=device)
    valid = (pos < jobmeta[:, 0, None, None]) & (meta[..., 0:1] != 0)
    mask = valid.reshape(j, 1, 1, p * ps)
    qd = q[:, :, None, :]
    lib = graph_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask), 20)
    records["fused_page_attention"] = dict(
        ms=ms, plain_ms=plain, max_abs_err=err, bound_ms=bound, bound_by=by,
        library_ms=lib, shape=[j, p, ps, h, dh])
    print("fused_page_attention: " + json.dumps(dict(
        records["fused_page_attention"], eager_ms=eager)))


def check_gather(device, records):
    """The gather-decode kernel against its plain version on the card at a
    materialize step's full-width shape: pages of 128 streams x 128 values
    out of a pool of 1024 KV-like pages coded under four table rows (stored
    streams included).  Bit-exact with the ids given on the host (as
    ``materialize`` gives them) and on the card, and through the kernel's
    launch alone (``launch_gather_decode``), at G = 1024 (1000 random ids
    with duplicates, edge-padded to the bucket), 1 and 3 (padded to 4 by a
    duplicate).  Timed at G = 1024 as device time per call over a CUDA
    graph of the kernel's launch, and eagerly through the wrapper with
    either kind of ids (the ids on the card cost a pull that waits for the
    card).  The bound counts the bytes a gather must move: the coded words
    of each distinct page read once, its stored flags, the table rows and
    ids, and the int32 output."""
    import torch
    from repro_torch.kernels import apack_encode, paged_decode as pd
    torch.manual_seed(5)
    n_pages, s, e = 1024, 128, 128
    vals = kv_like_values(n_pages, s, e, device)
    vals[:, :8] = torch.randint(0, 256, (n_pages, 8, e), device=device,
                                dtype=torch.int32)
    (vm, ol, cm), rows = table_rows(vals, 4)
    sym, ofs, sb, ob, st = apack_encode.encode(vals, vm[rows], ol[rows],
                                               cm[rows], n_steps=e, bits=8)
    kw = dict(n_steps=e, bits=8)
    cases = {}
    for n_ids in (1000, 1, 3):
        g = pd.gather_bucket(n_ids)
        idx = torch.randint(0, n_pages, (n_ids,), device=device)
        idx = torch.cat([idx, idx[-1:].expand(g - n_ids)]).to(torch.int32)
        tid = rows[idx.long()].to(torch.int32)
        want = pd.gather_decode_plain(sym, ofs, st, idx, vm, ol, cm,
                                      table_idx=tid, **kw)
        got = {"host ids": pd.gather_decode(
                   sym, ofs, st, idx.cpu().numpy(), vm, ol, cm,
                   table_idx=tid.cpu().numpy(), **kw),
               "card ids": pd.gather_decode(sym, ofs, st, idx, vm, ol, cm,
                                            table_idx=tid, **kw),
               "launch": pd.launch_gather_decode(sym, ofs, st, idx, tid, vm,
                                                 ol, cm, **kw)}
        torch.cuda.synchronize()
        if not torch.equal(want, vals[idx.long()]):
            raise AssertionError("gather_decode_plain: not the pages' values")
        for what, out in got.items():
            if not torch.equal(out, want):
                raise AssertionError(f"gather_decode G={g} ({what}): not "
                                     "bit-exact")
        print(f"gather_decode: G={g} ({n_ids} ids) bit-exact: "
              + ", ".join(got))
        cases[n_ids] = (idx, tid)
    idx, tid = cases[1000]
    g = idx.numel()
    n_stored = int(st[idx.long()].sum())
    if not 0 < n_stored < st[idx.long()].numel():
        raise AssertionError("gather_decode: the pages must mix stored and "
                             "coded streams")
    ms = graph_ms(lambda: pd.launch_gather_decode(
        sym, ofs, st, idx, tid, vm, ol, cm, **kw), 20)
    idx_h, tid_h = idx.cpu().numpy(), tid.cpu().numpy()
    eager_host = cuda_ms(lambda: pd.gather_decode(
        sym, ofs, st, idx_h, vm, ol, cm, table_idx=tid_h, **kw), 20)
    eager_card = cuda_ms(lambda: pd.gather_decode(
        sym, ofs, st, idx, vm, ol, cm, table_idx=tid, **kw), 20)
    plain = cuda_ms(lambda: pd.gather_decode_plain(
        sym, ofs, st, idx, vm, ol, cm, table_idx=tid, **kw), 1)
    distinct = torch.unique(idx.long())
    read = 4 * int(coded_words(sb[distinct], ob[distinct], sym.shape[1],
                               ofs.shape[1]).sum())
    read += nbytes(st[distinct], vm, ol, cm, idx, tid) + g * s * e * 4
    records["gather_decode"] = dict(
        ms=ms, plain_ms=plain, max_abs_err=0,
        bound_ms=read / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, shape=[g, s, e])
    print("gather_decode: " + json.dumps(dict(
        records["gather_decode"], eager_ms_host_ids=eager_host,
        eager_ms_card_ids=eager_card, distinct_pages=distinct.numel(),
        stored_streams=n_stored)))


def weight_cases(device):
    """int8 codes and scales at the main path's largest matmul shapes
    (qwen3-1.7b w_up [2048, 6144] and w_down [6144, 2048], quantized from
    normal weights as ``pack_weights`` does), plus a [2048, 1024] tensor of
    uniform int8 values, whose streams the coder stores verbatim."""
    import torch
    from repro_torch.core import quant
    g = torch.Generator(device=device).manual_seed(2)
    cases = []
    for name, k, n in (("w_up", 2048, 6144), ("w_down", 6144, 2048)):
        w = torch.randn(k, n, generator=g, device=device) * k ** -0.5
        q, qp = quant.quantize_symmetric(w, axis=-1)
        cases.append((name, q, qp.scale.reshape(-1)))
    q = torch.randint(-128, 128, (2048, 1024), generator=g, device=device,
                      dtype=torch.int32).to(torch.int8)
    cases.append(("stored", q, torch.rand(1024, generator=g, device=device)
                  * 0.01 + 0.001))
    return cases


def f64_err_ratio(y, x, w):
    """Largest error of the f32 product ``y`` against the f64 product of
    ``x`` and ``w``, over that of one cuBLAS f32 GEMM (TF32 off) on the
    same inputs: about 1 for f32 arithmetic that sums in another order,
    thousands for TF32 or bf16 weights."""
    import torch
    want = x.double() @ w.double()
    lib = torch.matmul(x, w).double()
    return ((y.double() - want).abs().max()
            / (lib - want).abs().max()).item()


def exact_matmul_check(name, q, cw, m, g):
    """Unit scales and x of small integers: every product and partial sum
    is an integer below 2^24, exact in f32, so the kernel must equal the
    plain version and the integer product bit for bit, whatever order
    either sums in.  A kernel that rounds x or W below f32 (TF32, bf16)
    fails here."""
    import dataclasses
    import torch
    from repro_torch.kernels import decompress_matmul as dm
    cw1 = dataclasses.replace(cw, scale=torch.ones_like(cw.scale))
    x = torch.randint(-4, 5, (m, cw.k), generator=g, device=q.device,
                      dtype=torch.int32).to(torch.float32)
    y = dm.compressed_matmul(x, cw1)
    exact = (x.double() @ q.double()).to(torch.float32)
    if not (torch.equal(y, dm.compressed_matmul_plain(x, cw1))
            and torch.equal(y, exact)):
        raise AssertionError(f"decompress_matmul {name} M={m}: not exact on "
                             "integer inputs with unit scales")


def check_decompress_matmul(device, records):
    """The decompress-matmul kernel against its plain version on the card,
    at M = 4 (a decode step's batch), M = 1 and 8 (the ends of the
    kernel's register path), 9 (the first on its shared-memory tile) and 77
    (a prefill).  Three checks, TF32 off:

    - bit-exact on integer inputs with unit scales (``exact_matmul_check``);
    - the worst-case rounding bound of a K-term f32 sum,
      K * 2^-24 * (|x| @ |W|) per output, against the plain version, since
      the two sum inside a K tile in different orders (sequential fused
      multiply-adds against a cuBLAS f32 GEMM) and across K tiles in the
      same kt order;
    - its largest error against an f64 product at most ``F64_ERR_RATIO``
      times that of cuBLAS f32 on the same inputs.

    The encode kernel's planes for the same streams are held bit-exact
    against the plain encoder."""
    import torch
    from repro_torch.kernels import apack_encode, decompress_matmul as dm
    g = torch.Generator(device=device).manual_seed(3)
    rows = []
    for name, q, scale in weight_cases(device):
        cw = dm.compress_quantized(q, scale,
                                   min(dm.DEFAULT_TILE_K, q.shape[0]))
        streams = dm.tile_streams(q, cw.tile_k)
        tabs = (cw.v_min, cw.ol, cw.cum)
        sym, ofs, sb, ob, st = apack_encode.encode_plain(
            streams, *tabs, n_steps=cw.tile_k, bits=8)
        if not (torch.equal(sym, cw.sym_plane) and torch.equal(ofs, cw.ofs_plane)
                and torch.equal(st.to(torch.int32), cw.stored)):
            raise AssertionError(f"decompress_matmul {name}: encode kernel "
                                 "planes differ from the plain encoder")
        n_stored = int(st.sum())
        if (name == "stored") != (n_stored == st.numel()):
            raise AssertionError(f"{name}: {n_stored} of {st.numel()} "
                                 "streams stored")
        wf = (q.to(torch.float32) * scale[None, :])
        coded = 4 * int(coded_words(sb, ob, sym.shape[0], ofs.shape[0]).sum())
        for m in (1, 4, 8, 9, 77):
            exact_matmul_check(name, q, cw, m, g)
            x = torch.randn(m, cw.k, generator=g, device=device)
            y = dm.compressed_matmul(x, cw)
            y_plain = dm.compressed_matmul_plain(x, cw)
            torch.cuda.synchronize()
            bound = cw.k * 2.0 ** -24 * (x.abs().double() @ wf.abs().double())
            err = (y.double() - y_plain.double()).abs()
            if not bool((err <= bound).all()) or not torch.isfinite(y).all():
                raise AssertionError(
                    f"decompress_matmul {name} M={m}: off by "
                    f"{err.max().item():.3g} (bound {bound.min().item():.3g})")
            ratio = f64_err_ratio(y, x, wf)
            if not ratio <= F64_ERR_RATIO:
                raise AssertionError(
                    f"decompress_matmul {name} M={m}: error against f64 is "
                    f"{ratio:.3g}x cuBLAS f32's (limit {F64_ERR_RATIO})")
            ms = graph_ms(lambda: dm.compressed_matmul(x, cw), 20)
            eager = cuda_ms(lambda: dm.compressed_matmul(x, cw), 20)
            # the kernel up to its staging of the planes: the rest of ms is
            # the decode chain (and, past 8 rows, the tile product)
            stage_ms = graph_ms(lambda: dm.compressed_matmul(
                x, cw, stage_only=True), 20)
            plain = cuda_ms(lambda: dm.compressed_matmul_plain(x, cw), 1)
            lib = graph_ms(lambda: torch.matmul(x, wf), 20)
            # coded words of every stream (+1 word its window reaches), the
            # stored flags, table, scales, x and the output, each once
            nbytes_ = coded + nbytes(cw.stored, *tabs, cw.scale, x, y)
            flops = 2 * m * cw.k * cw.n
            t_b, t_f = nbytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS
            row = dict(name=name, shape=[m, cw.k, cw.n], ms=ms,
                       eager_ms=eager, stage_ms=stage_ms, plain_ms=plain,
                       library_ms=lib,
                       bound_ms=max(t_b, t_f) * 1e3,
                       bound_by="bytes" if t_b >= t_f else "operations",
                       max_abs_err=err.max().item(), f64_err_ratio=ratio,
                       exact_on_integers=True, stored=n_stored,
                       payload_bits=cw.payload_bits)
            rows.append(row)
            print("decompress_matmul: " + json.dumps(row))
    main_row = next(r for r in rows         # w_up at M = 4, a decode step
                    if r["name"] == "w_up" and r["shape"][0] == 4)
    records["decompress_matmul"] = dict(
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        max_abs_err=max(r["max_abs_err"] for r in rows),
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"], shape=main_row["shape"])


# ----------------------------------------------------------------- phase 3
def serve_requests(cfg, rng):
    """The 8 requests of a serve phase: prompts of 64-96 tokens, 48 new
    tokens each."""
    import numpy as np
    from repro_torch.serve import Request
    return [Request(i, rng.integers(0, cfg.vocab_size,
                                    int(rng.integers(64, 97))).astype(np.int64),
                    max_new_tokens=48) for i in range(8)]


def packed_sites(params):
    """(block index, group, name, PackedWeight) of every packed site."""
    from repro_torch.models.modules import PackedWeight
    return [(i, grp, name, pw) for i, b in enumerate(params["blocks"])
            for grp in ("inner", "ffn")
            for name, pw in b[grp].items() if isinstance(pw, PackedWeight)]


def oracle_stores(packed_params, host_weights):
    """The stores the packed path is checked against, built from a host
    copy of the original f32 weights of every packed site: each quantized
    again with the same convention and multiplied back, as the JAX
    package's parity oracle does (``tests/test_packed_weights.py::
    _packed_and_dense``).  Returns param trees keyed by store:

    - ``oracle32`` / ``oracle64``: every packed site an ``OracleWeight``
      on the dequantized weight, its product one cuBLAS GEMM (TF32 off) in
      f32 / f64, rounded to f32 (``reference_matmul``'s math);
    - ``dense``: the dequantized weight in bf16, as the dense path holds
      it (``serving_params``).

    Every other leaf is the packed engine's own."""
    import torch
    from repro_torch.core import quant
    from repro_torch.models.modules import PackedWeight

    class OracleWeight(PackedWeight):
        def __init__(self, pw, w, compute):
            super().__init__(pw.cw, pw.shape, pw.n_contract, pw.dtype)
            self.w, self.compute = w, compute

        def matmul(self, x):
            return (x.to(self.compute) @ self.w.to(self.compute)).to(
                torch.float32)

    stores = {k: {**packed_params,
                  "blocks": [{g: dict(v) if isinstance(v, dict) else v
                              for g, v in b.items()}
                             for b in packed_params["blocks"]]}
              for k in ("oracle32", "oracle64", "dense")}
    for i, grp, name, pw in packed_sites(packed_params):
        w = host_weights[i, grp, name].to(pw.cw.scale.device)
        q, qp = quant.quantize_symmetric(w, axis=-1)
        wd = quant.dequantize_symmetric(q, qp)
        w2 = wd.reshape(pw.cw.k, pw.cw.n)
        stores["oracle32"]["blocks"][i][grp][name] = OracleWeight(
            pw, w2, torch.float32)
        stores["oracle64"]["blocks"][i][grp][name] = OracleWeight(
            pw, w2, torch.float64)
        stores["dense"]["blocks"][i][grp][name] = wd.to(torch.bfloat16)
    return stores


def serve_full_width(device, *, layers, weights=None, kv="apack-int8",
                     fused=True, calib_pages=4, hook=None, params=None,
                     label=None):
    """Serve the 8 requests at qwen3-1.7b's published widths and ``layers``
    layers, from dense or packed weights (the seed-0 draw, or ``params``,
    named ``label``), through the fused paged KV path,
    the materialize oracle (``fused=False``) or a dense cache (``kv`` of
    "int8"), with the launch counts reset just before the serve and read
    just after.  ``hook(eng, i)``, when given, runs after step ``i``; its
    time is not serving time, its kernel launches (checks) are taken out
    of the counts and its memory out of the peak.  Returns a dict with the summary, the counts, a snapshot
    of the PACKED KV pages, the first step's logits, the engine, the
    requests and (packed weights only) a host copy of the original f32
    weight of every packed site, from which the checks after the serve
    build their oracle stores; nothing but the engine is on the card while
    it serves, so ``max_memory_gb`` is the engine's."""
    import dataclasses
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine
    mode = ("fused" if fused else "oracle") if kv == "apack-int8" else kv
    label = label or weights or "dense"
    tag = f"serve[{mode} KV, {label} weights, {layers} layers]"
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=layers,
                              kv_cache_dtype=kv)
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    if params is None:
        params = M.init_params(cfg, gen, device)
    eng = ServeEngine(cfg, params, max_batch=4, max_len=160,
                      kv_page_size=16, kv_calib_pages=calib_pages,
                      kv_fused=fused, weights=weights, device=device)
    host_weights = {(i, grp, name): params["blocks"][i][grp][name].cpu()
                    for i, grp, name, _ in packed_sites(eng.params)}
    del params
    torch.cuda.synchronize()
    print(f"{tag}: qwen3-1.7b d_model {cfg.d_model} built in "
          f"{time.perf_counter() - t0:.1f} s (weight packing "
          f"{eng.weight_pack_s:.1f} s)")
    rng = np.random.default_rng(0)
    reqs = serve_requests(cfg, rng)
    for r in reqs:
        eng.submit(r)
    repro_torch.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    snapshot = first_logits = None
    checks = dict.fromkeys(repro_torch.launch_counts(), 0)
    peak = 0                        # the engine's, checks left out
    step_s = []
    paused = 0.0                    # snapshot copies and checks
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        n = eng.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - ts)
        if n == 0 and not eng.queue:
            break
        tc = time.perf_counter()
        if first_logits is None:
            first_logits = eng.last_logits.float().cpu()
        if eng.paged and snapshot is None and not eng.queue:
            snapshot = capture_packed(eng)
        if hook is not None:
            peak = max(peak, torch.cuda.max_memory_allocated())
            before = repro_torch.launch_counts()
            hook(eng, len(step_s) - 1)
            for k, v in repro_torch.launch_counts().items():
                checks[k] += v - before[k]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        paused += time.perf_counter() - tc
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - paused
    launches = {k: v - checks[k]
                for k, v in repro_torch.launch_counts().items()}
    gen_tokens = sum(len(r.tokens) for r in reqs)
    if not all(r.done and len(r.tokens) == 48 for r in reqs):
        raise AssertionError(f"{tag}: not every request completed")
    path = ["decompress_matmul"] if weights else []
    if eng.paged:
        path += ["apack_decode", "apack_encode",
                 "fused_page_attention" if fused else "gather_decode"]
    if any(launches[k] <= 0 for k in path):
        raise AssertionError(f"{tag}: a kernel was not launched: {launches}")
    if not torch.isfinite(eng.last_logits).all():
        raise AssertionError(f"{tag}: non-finite logits")
    decode_steps = step_s[1:]                     # step 0 admits + calibrates
    summary = {"layers": layers, "weights": label,
               "kv": mode, "requests": len(reqs),
               "generated_tokens": gen_tokens,
               "wall_s": wall, "tokens_per_s": gen_tokens / wall,
               "steps": eng.stats["steps"],
               "median_step_ms": float(np.median(decode_steps) * 1e3),
               "first_step_s": step_s[0],
               "weight_pack_s": eng.weight_pack_s, "launches": launches,
               "launches_per_step": {k: v / eng.stats["steps"]
                                     for k, v in launches.items()},
               "check_launches": checks,
               "max_memory_gb": max(peak, torch.cuda.max_memory_allocated())
               / 1e9}
    if eng.paged:
        stats = eng.kv_stats()
        if stats["kv_pages_packed"] <= 0:
            raise AssertionError(f"{tag}: no PACKED pages")
        if not stats["kv_ratio"] or stats["kv_ratio"] >= 1:
            raise AssertionError(f"{tag}: kv_ratio {stats['kv_ratio']} "
                                 "not < 1")
        summary.update({k: stats[k] for k in (
            "kv_ratio", "kv_pages_packed", "kv_pages_high_water",
            "transfers")})
    if weights is not None:
        ws = eng.weight_stats()
        summary["weight_stats"] = {k: ws[k] for k in (
            "packed_tensors", "weight_ratio", "native_ratio",
            "payload_bytes", "slotted_bytes", "scale_bytes", "int8_bytes",
            "native_bytes")}
        if not ws["weight_ratio"] < 1:
            raise AssertionError(f"{tag}: weight_ratio {ws['weight_ratio']}"
                                 " not < 1")
    print(f"{tag}: " + json.dumps(summary))
    return dict(cfg=cfg, eng=eng, reqs=reqs, rng=rng, launches=launches,
                snapshot=snapshot, host_weights=host_weights,
                first_logits=first_logits, summary=summary)


def check_packed_sites(eng, stores):
    """Every packed site of the first and the last layer of the served
    model, through the kernel, against one f32 product on the same
    dequantized weight (``stores["oracle32"]``), at M = 4 and a prefill M:
    within the K-term f32 rounding bound of ``check_decompress_matmul``,
    and with an error against the f64 product at most ``F64_ERR_RATIO``
    times cuBLAS f32's."""
    import torch
    blocks = eng.params["blocks"]
    g = torch.Generator(device=eng.device).manual_seed(4)
    last = len(blocks) - 1
    worst = worst_ratio = 0.0
    for i, grp, name, pw in packed_sites(eng.params):
        if i not in (0, last):
            continue
        w = stores["oracle32"]["blocks"][i][grp][name].w
        for m in (4, 77):
            x = torch.randn(m, pw.cw.k, generator=g, device=w.device)
            y = pw.matmul(x)
            err = (y.double() - (x @ w).double()).abs()
            bound = pw.cw.k * 2.0 ** -24 * (x.abs().double()
                                            @ w.abs().double())
            ratio = f64_err_ratio(y, x, w)
            if not bool((err <= bound).all()) or not ratio <= F64_ERR_RATIO:
                raise AssertionError(
                    f"packed {name} layer {i} M={m}: off by {err.max()}, "
                    f"{ratio:.3g}x cuBLAS f32's error against f64")
            worst = max(worst, (err / bound).max().item())
            worst_ratio = max(worst_ratio, ratio)
    print(f"packed sites: layers 0 and {last}, every site, M = 4 and 77, "
          f"within the f32 bound (worst {worst:.3g} of it); error against "
          f"f64 at most {worst_ratio:.3g}x cuBLAS f32's "
          f"(limit {F64_ERR_RATIO})")


def teacher_forced(run, stores):
    """Re-score the packed engine's sequences teacher-forced, one forward
    per store, as the JAX package scores packed-weight parity
    (``tests/test_packed_weights.py::_parity``), over the positions that
    predicted generated tokens.  The stores: ``packed`` (the engine's, the
    kernel), ``oracle32``/``oracle64`` and ``dense`` (``oracle_stores``).

    The gate: the RMS logit drift of ``packed~oracle64`` at most
    ``RMS_DRIFT_RATIO`` times that of ``oracle32~oracle64``, the drift of
    plain f32 arithmetic from the exact product in the same run.  A kernel
    below f32 (TF32, bf16 weights) or a wrong site drifts far more.

    ``packed~dense`` argmax agreement is the JAX package's metric and gate
    (0.98); it is printed as the reference metric.  At published widths on
    random normal weights it does not discriminate: the top-2 logit gap
    over 151,936 tokens is often below the drift that bf16 activations
    accumulate from any difference in f32 rounding, and
    ``oracle32~oracle64`` (two implementations of the same exact math)
    agree no better."""
    import torch
    from repro_torch.models import model as M
    cfg, eng = run["cfg"], run["eng"]
    stores = {"packed": eng.params, **stores}
    pairs = ("packed~oracle64", "oracle32~oracle64", "packed~dense")
    agree = dict.fromkeys(pairs, 0)
    sq = dict.fromkeys(pairs, 0.0)
    total = 0
    t0 = time.perf_counter()
    for r in run["reqs"]:
        seq = list(r.prompt) + r.tokens
        toks = torch.as_tensor([seq], device=eng.device)
        pred = slice(len(r.prompt) - 1, len(seq) - 1)
        out = {k: M.forward(cfg, p, toks)[0][0, pred].double()
               for k, p in stores.items()}
        for pair in pairs:
            a, b = (out[k] for k in pair.split("~"))
            agree[pair] += int((a.argmax(-1) == b.argmax(-1)).sum())
            sq[pair] += float(((a - b) ** 2).sum())
        total += pred.stop - pred.start
    torch.cuda.synchronize()
    rates = {k: v / total for k, v in agree.items()}
    rms = {k: (v / (total * cfg.vocab_size)) ** 0.5 for k, v in sq.items()}
    drift = rms["packed~oracle64"] / rms["oracle32~oracle64"]
    print("teacher-forced: " + json.dumps(
        {"positions": total, "agreement": rates, "rms_logit_diff": rms,
         "reference_metric": {"packed~dense": rates["packed~dense"],
                              "reference_gate": AGREEMENT_GATE,
                              "met": rates["packed~dense"] >= AGREEMENT_GATE},
         "gate": {"rms_drift_ratio": drift, "limit": RMS_DRIFT_RATIO},
         "seconds": time.perf_counter() - t0}))
    if not drift <= RMS_DRIFT_RATIO:
        raise AssertionError(f"teacher-forced: the packed path drifts "
                             f"{drift:.3g}x as far from its f64 oracle as "
                             f"f32 does (limit {RMS_DRIFT_RATIO})")
    return rates


def profile_steady_steps(eng, cfg, rng, tag):
    """Where a steady decode step's time goes: torch.profiler over ten
    steps of a fresh full batch (tables already calibrated), device time by
    kernel name (the top twelve and every kernel of the port) and the
    device's idle share of the window."""
    import numpy as np
    import torch
    from repro_torch.serve import Request
    for i in range(4):
        eng.submit(Request(100 + i, rng.integers(0, cfg.vocab_size, 80),
                           max_new_tokens=24))
    for _ in range(3):                      # admit + warm
        eng.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        # kernel events only (CPU ops carry their kernels' time too)
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"profile {tag}: 10 steady steps, wall {wall * 1e3:.1f} ms, "
          f"device busy {busy * 1e3:.1f} ms, idle share "
          f"{1 - busy / wall:.3f}")
    # the top twelve, and every kernel of the port below them
    for dev_us, key, count in (rows[:12] + [r for r in rows[12:] if any(
            f"::{k}" in r[1] for k in PORT_KERNELS)]):
        print(f"profile {tag}:   {dev_us / 1e3:9.2f} ms  {count:6d}x  "
              f"{key[:90]}")
    eng.run_until_drained()


def capture_packed(eng):
    """Copies of every PACKED page's planes and table rows, mid-serve."""
    import numpy as np
    import torch
    kv = eng.kv
    pids = [pid for layer in range(kv.n_layers)
            for pid in sorted(kv._packed[layer])]
    layers = [layer for layer in range(kv.n_layers)
              for _ in sorted(kv._packed[layer])]
    if not pids:
        return None
    idx = torch.as_tensor(pids, device=kv.device)
    vm, ol, cm = kv._tables_stacked()
    rows = np.array([[2 * l + kind for l in layers] for kind in (0, 1)])
    dev = kv.device
    return {"sym": kv.pool.sym[:, idx].clone(),
            "ofs": kv.pool.ofs[:, idx].clone(),
            "stored": kv.pool.stored[:, idx].clone(),
            "vm": torch.as_tensor(vm[rows], device=dev),
            "ol": torch.as_tensor(ol[rows], device=dev),
            "cum": torch.as_tensor(cm[rows], device=dev)}


def smoke_vs_cpu(device, weights=None, kv="apack-int8", fused=True,
                 roundtrip=False):
    """A SMOKE-width engine on the card against the same engine on the CPU
    (plain versions): greedy tokens must be identical, and the prefill
    logits of the first request may differ by at most one bf16 step at
    their largest magnitude (cuBLAS and the CPU may round a bf16 GEMM
    differently, and the decompress-matmul kernel sums inside a K tile in
    another order than the CPU's f32 GEMM).  ``weights="apack-int8"`` packs
    every projection (``weight_min_size=1024``: SMOKE's matrices are under
    the default); ``fused=False`` serves the paged cache through the
    materialize oracle; ``kv`` "int8" or "bfloat16" serves a dense cache.
    ``roundtrip=True`` serves the weights after ``compress_params`` (every
    stacked matrix of 64 elements or more, the norm scales included) and
    ``decompress_params`` on each device, and the two devices'
    ``CompressedParams`` must be identical (containers, scales, byte
    counts) and so must the decompressed weights.  Returns the card's
    tokens."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import (Request, ServeEngine, compress_params,
                                   decompress_params)
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              kv_cache_dtype=kv)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n) for n in (20, 33, 9)]
    out = {}
    cps = {}
    for dev in ("cpu", device):
        p = {"embed": params["embed"].to(dev),
             "final_norm": params["final_norm"].to(dev),
             "blocks": [{k: ({kk: vv.to(dev) for kk, vv in v.items()}
                             if isinstance(v, dict) else v.to(dev))
                         for k, v in b.items()} for b in params["blocks"]]}
        if roundtrip:
            cps[dev] = compress_params(p, min_size=64)
            p = decompress_params(cps[dev], dev)
            cps[dev] = (cps[dev], p)
        eng = ServeEngine(cfg, p, max_batch=2, max_len=64, kv_page_size=4,
                          kv_calib_pages=2, kv_fused=fused, weights=weights,
                          weight_min_size=1024, device=dev)
        reqs = [Request(i, x, max_new_tokens=12) for i, x in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        logits0, _ = eng._prefill_forward(prompts[0])
        eng.run_until_drained()
        out[dev] = ([r.tokens for r in reqs], logits0.float().cpu(),
                    eng.weight_stats())
    diff = (out["cpu"][1] - out[device][1]).abs().max().item()
    step = (torch.finfo(torch.bfloat16).eps
            * out["cpu"][1].abs().max().item())
    same = out["cpu"][0] == out[device][0]
    same_ws = out["cpu"][2] == out[device][2]
    tag = (f"{weights or ('round-trip' if roundtrip else 'dense')} "
           "weights, "
           + (("fused" if fused else "oracle") if kv == "apack-int8" else kv)
           + " KV")
    if roundtrip:
        (cp_c, w_c), (cp_d, w_d) = cps["cpu"], cps[device]
        cp_diff = compressed_params_diff(cp_c, cp_d)
        same_w = all(torch.equal(a.cpu(), b) for a, b in
                     zip(param_leaves(w_d), param_leaves(w_c)))
        print(f"smoke round trip card vs cpu: {len(cp_c.containers)} "
              f"containers, {cp_d.original_bytes} -> {cp_d.compressed_bytes}"
              f" bytes ({cp_d.ratio:.4f}x), containers identical "
              f"{not cp_diff} {cp_diff[:8]}, decompressed weights identical "
              f"{same_w}")
        if cp_diff or not same_w:
            raise AssertionError("SMOKE compress_params on the card differs "
                                 "from the CPU's")
    print(f"smoke engine [{tag}] card vs cpu: prefill logit "
          f"max diff {diff:.3g} (bound {step:.3g}), greedy tokens identical "
          f"{same}, weight_stats equal {same_ws}")
    if diff > step or not same or not same_ws:
        raise AssertionError(f"SMOKE engine [{tag}] on the card disagrees "
                             "with the CPU")
    return out[device][0]


def param_leaves(tree):
    """The tensors of a param tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in param_leaves(tree[k])]
    if isinstance(tree, list):
        return [t for x in tree for t in param_leaves(x)]
    return [tree]


def compressed_params_diff(a, b) -> list:
    """Where two ``CompressedParams`` differ: byte counts, paths, and per
    leaf its containers (every plane, bit count, flag and table), scale
    and passthrough value.  Empty when they are identical."""
    import numpy as np
    import torch
    diff = [what for what, x, y in (
        ("paths", a.paths, b.paths),
        ("original_bytes", a.original_bytes, b.original_bytes),
        ("compressed_bytes", a.compressed_bytes, b.compressed_bytes),
        ("containers", sorted(a.containers), sorted(b.containers)),
        ("passthrough", sorted(a.passthrough), sorted(b.passthrough)))
        if x != y]
    for path in set(a.containers) & set(b.containers):
        (ct, scale, dtype), (ct2, scale2, dtype2) = (a.containers[path],
                                                     b.containers[path])
        if dtype != dtype2 or ct.shape != ct2.shape:
            diff.append(f"{path}: dtype or shape")
        if not np.array_equal(scale, scale2):
            diff.append(f"{path}: scale ({int((scale != scale2).sum())} "
                        f"of {scale.size})")
        if ct.table != ct2.table:
            diff.append(f"{path}: table")
        diff += [f"{path}: {f}" for f in ("sym_plane", "ofs_plane",
                                          "sym_bits", "ofs_bits", "stored")
                 if not np.array_equal(getattr(ct, f), getattr(ct2, f))]
    diff += [f"{k}: passthrough value" for k in
             set(a.passthrough) & set(b.passthrough)
             if not torch.equal(a.passthrough[k], b.passthrough[k])]
    return sorted(diff)


# ----------------------------------------------------------------- phase 8
def weight_round_trip(device):
    """The JAX CLI's default weight path at full width: qwen3-1.7b's seed-0
    params (28 layers) through ``compress_params`` and
    ``decompress_params`` on the card, launch counts reset just before and
    read just after, each part timed.  Gates:

    - every compressed leaf comes back equal, bit for bit, to the
      codec-free ``from_unsigned(to_unsigned(q)) * scale`` of the same int8
      codes ``q`` (quantized again from the original leaf), and every
      passthrough leaf to itself;
    - for each distinct container shape, the plain encoder on the card,
      on the first and the last 1,024 streams, gives the container's
      trimmed columns (zeros past them), bit counts and flags, and the
      plain decoder on those columns gives the decode kernel's values.

    Returns the decompressed params, the ``CompressedParams`` summary and
    the round trip's launch counts."""
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.core import quant
    from repro_torch.core.format import _pad_value
    from repro_torch.kernels import apack_decode, apack_encode, ref
    from repro_torch.models import model as M
    from repro_torch.serve import compress_params, decompress_params
    from repro_torch.serve.engine import _stacked_leaves
    cfg = get_config("qwen3-1.7b")
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    torch.cuda.synchronize()
    repro_torch.reset_launch_counts()
    tc: dict = {}
    t0 = time.perf_counter()
    cp = compress_params(params, timings=tc)
    t_comp = time.perf_counter() - t0
    td: dict = {}
    t0 = time.perf_counter()
    back = decompress_params(cp, device, timings=td)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = repro_torch.launch_counts()
    if launches["apack_encode"] != len(cp.containers) or \
            launches["apack_decode"] != len(cp.containers):
        raise AssertionError(f"weight round trip: launches {launches} for "
                             f"{len(cp.containers)} containers")
    summary = {
        "containers": {k: {"shape": list(ct.shape), "streams": ct.n_streams,
                           "planes": [int(ct.sym_plane.shape[0]),
                                      int(ct.ofs_plane.shape[0])],
                           "stored": int(ct.stored.sum()),
                           "ratio": ct.ratio()}
                       for k, (ct, _, _) in cp.containers.items()},
        "passthrough": sorted(cp.passthrough),
        "values": sum(int(np.prod(ct.shape))
                      for ct, _, _ in cp.containers.values()),
        "original_mb": cp.original_bytes / 1e6,
        "compressed_mb": cp.compressed_bytes / 1e6, "ratio": cp.ratio,
        "compress_s": t_comp, "decompress_s": t_dec,
        "parts_s": {**tc, **td}, "launches": launches}
    print(f"APack weight compression: {cp.original_bytes/1e6:.1f} MB -> "
          f"{cp.compressed_bytes/1e6:.1f} MB ({cp.ratio:.2f}x, "
          f"{t_comp:.1f}s)")
    print("weight round trip: " + json.dumps(summary))
    # the gates: every leaf, and the sampled streams of each shape
    t0 = time.perf_counter()
    seen = set()
    for (path, orig_fn), (path2, back_fn) in zip(
            _stacked_leaves(params), _stacked_leaves(back)):
        assert path == path2
        got = back_fn()
        if path in cp.passthrough:
            if not torch.equal(got, orig_fn()):
                raise AssertionError(f"round trip {path}: passthrough "
                                     "changed")
            continue
        ct, _, _ = cp.containers[path]
        q, qp = quant.quantize_symmetric(orig_fn().float(), axis=-1)
        u = quant.to_unsigned(q)
        want = (quant.from_unsigned(u).float() * qp.scale).to(got.dtype)
        if not torch.equal(got.reshape(-1).view(torch.uint8),
                           want.reshape(-1).view(torch.uint8)):
            raise AssertionError(f"round trip {path}: not bit-exact")
        del got, want, q
        if ct.shape in seen:
            continue
        seen.add(ct.shape)
        e, n = ct.elems_per_stream, ct.n_valid
        streams = torch.full((ct.n_streams * e,), _pad_value(ct.table),
                             dtype=torch.int32, device=device)
        streams[:n] = u.reshape(-1)
        streams = streams.reshape(ct.n_streams, e)
        idx = end_streams(ct.n_streams)
        tabs = ref.table_tensors(ct.table, device)
        kw = dict(n_steps=e, bits=ct.bits)
        sym, ofs, sb, ob, st = apack_encode.encode_plain(streams[idx], *tabs,
                                                         **kw)
        ih = idx.cpu().numpy()
        planes = []
        for plain, trimmed in ((sym, ct.sym_plane), (ofs, ct.ofs_plane)):
            w = trimmed.shape[0]
            cols = torch.from_numpy(trimmed[:, ih].view(np.int32)).to(device)
            if not (torch.equal(plain[:w], cols) and not plain[w:].any()):
                raise AssertionError(f"round trip {path}: plain encoder's "
                                     "planes differ from the container's")
            planes.append(torch.from_numpy(trimmed.view(np.int32)).to(device)
                          if w else torch.zeros(1, ct.n_streams,
                                                dtype=torch.int32,
                                                device=device))
        for plain, kept in ((sb, ct.sym_bits), (ob, ct.ofs_bits),
                            (st, ct.stored)):
            if not np.array_equal(plain.cpu().numpy(), kept[ih]):
                raise AssertionError(f"round trip {path}: bit counts or "
                                     "flags differ from the plain encoder")
        stored = torch.from_numpy(ct.stored).to(device)
        kernel = apack_decode.decode(*planes, stored, *tabs, **kw)[idx]
        plain = apack_decode.decode_plain(planes[0][:, idx],
                                          planes[1][:, idx], stored[idx],
                                          *tabs, **kw)
        if not (torch.equal(kernel, plain) and torch.equal(plain,
                                                           streams[idx])):
            raise AssertionError(f"round trip {path}: decode kernel != "
                                 "plain decoder on the sampled streams")
        print(f"round trip {path}: shape {list(ct.shape)}, "
              f"{ct.n_streams} streams, planes [{planes[0].shape[0]} | "
              f"{planes[1].shape[0]}]: plain encoder and decoder on "
              f"{len(idx)} end streams equal the kernels'")
        del streams, planes, u
    torch.cuda.synchronize()
    print(f"round trip gates: {len(cp.containers)} leaves bit-exact against "
          f"from_unsigned(to_unsigned(q)) * scale, {len(seen)} container "
          f"shapes sampled, {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    return back, summary, launches


# ----------------------------------------------------------------- phase 5
def live_page_states(eng) -> set:
    """Lifecycle states of every page of the active requests."""
    kv = eng.kv
    return {int(kv.pool.state[pid]) for r in eng.active if r is not None
            for pids in kv.page_tables[r.rid] for pid in pids}


def oracle_gates(eng, what: str) -> dict:
    """Gates on the oracle engine's pool as it stands between two steps:

    (a) ``materialize`` through the gather-decode kernel equals, bit for
        bit, a ``materialize`` whose PACKED pages the plain version decodes;
    (b) at the first and the last layer, the fused attention kernel's
        normalized output over the same pages equals dense attention over
        the materialized cache (computed in f64) within the existing
        attention check's tolerance, rtol 1e-5 and atol 1e-6, the relative
        part taken against sum(w |v|), the magnitude at which the f32 sums
        of the online softmax run (the reference's
        ``test_mixed_page_states_match_materialize_oracle`` at full width).

    The checks' reads are not serving traffic: the KV counters are put
    back as they were."""
    import torch
    from repro_torch.kernels.fused_page_attention import fused_page_attention
    from repro_torch.kernels.paged_decode import gather_decode_plain
    from repro_torch.models.modules import kv_dequantize
    kv, cfg = eng.kv, eng.cfg
    saved = dict(kv.traffic), dict(kv.transfers)
    rids = [r.rid if r is not None else None for r in eng.active]
    got = kv.materialize(rids, eng.max_len)
    want = kv.materialize(rids, eng.max_len, decode=gather_decode_plain)
    if not all(torch.equal(a[f], b[f]) for a, b in zip(got, want)
               for f in a):
        raise AssertionError(f"oracle [{what}]: materialize through the "
                             "kernel != through the plain version")
    meta = kv.step_meta(rids, eng.max_len)
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    act = [s for s, r in enumerate(rids) if r is not None]
    qpos = torch.tensor([kv.seq_len[rids[s]] for s in act],
                        device=eng.device)
    g = torch.Generator(device=eng.device).manual_seed(6)
    worst = 0.0
    for layer in (0, cfg.num_layers - 1):
        q = torch.randn(len(rids), h, dh, generator=g, device=eng.device)
        acc, _, l = fused_page_attention(
            q, meta["pid"][layer], meta["tid"][layer], meta["kmeta"][layer],
            meta["qw"][layer], kv.dev.planes,
            n_steps=kv.pool.elems_per_stream,
            softcap=float(cfg.logit_softcap))
        out = (acc / l[..., None])[act].double()
        c = got[layer]
        kd = kv_dequantize(c["k"], c["k_scale"])[act].double()
        vd = kv_dequantize(c["v"], c["v_scale"])[act].double()
        q3 = q[act].double().reshape(len(act), hkv, h // hkv, dh)
        sc = torch.einsum("akgd,askd->akgs", q3, kd) * dh ** -0.5
        if cfg.logit_softcap > 0:
            sc = cfg.logit_softcap * torch.tanh(sc / cfg.logit_softcap)
        valid = torch.arange(sc.shape[-1], device=eng.device) < qpos[:, None]
        w = torch.softmax(torch.where(valid[:, None, None], sc,
                                      -float("inf")), dim=-1)
        dense = torch.einsum("akgs,askd->akgd", w, vd).reshape(out.shape)
        mag = torch.einsum("akgs,askd->akgd", w, vd.abs()).reshape(out.shape)
        ratio = ((out - dense).abs() / (1e-5 * mag + 1e-6)).max().item()
        if not ratio <= 1.0:
            raise AssertionError(f"oracle [{what}] layer {layer}: fused "
                                 f"attention off dense attention over the "
                                 f"materialized cache ({ratio:.3g}x the "
                                 "tolerance)")
        worst = max(worst, ratio)
    kv.traffic.clear()
    kv.traffic.update(saved[0])
    kv.transfers.clear()
    kv.transfers.update(saved[1])
    res = {"states": what, "step": eng.stats["steps"],
           "materialize_bit_exact": True,
           "attention_worst_of_tolerance": worst,
           "packed_pages": int(sum(len(p) for p in kv._packed))}
    print("oracle gates: " + json.dumps(res))
    return res


def oracle_hook(done: dict):
    """Run ``oracle_gates`` once while the active requests' pages are HOT
    and COLD (before calibration), and once after ten decode steps while
    they are HOT and PACKED.  A calibrated global-only stack packs every
    page at its seal, so COLD and PACKED never coexist between steps."""
    from repro_torch.models.modules import PAGE_COLD, PAGE_HOT, PAGE_PACKED

    def hook(eng, i):
        st = live_page_states(eng)
        if "cold" not in done and st == {PAGE_HOT, PAGE_COLD}:
            done["cold"] = oracle_gates(eng, "HOT+COLD")
        elif "packed" not in done and i >= 10 and st == {PAGE_HOT,
                                                          PAGE_PACKED}:
            done["packed"] = oracle_gates(eng, "HOT+PACKED")
    return hook


def preempt_hook(eng, i):
    """Preempt slot 0 after ten decode steps (step 0 admits and decodes
    the first), requeued at the head: it resumes in the next step."""
    if i == 9:
        eng.preempt(0, requeue="head")


def token_agreement(a: list, b: list) -> float:
    """Share of generated positions where two serves chose the same
    token."""
    pairs = [(x, y) for ta, tb in zip(a, b) for x, y in zip(ta, tb)]
    return sum(x == y for x, y in pairs) / len(pairs)


# ----------------------------------------------------------------- checks
def verify_packed(snapshot):
    import torch
    from repro_torch.kernels import apack_decode, apack_encode
    if snapshot is None:
        raise AssertionError("no PACKED pages captured mid-serve")
    sym = snapshot["sym"].reshape(-1, *snapshot["sym"].shape[2:])
    ofs = snapshot["ofs"].reshape(-1, *snapshot["ofs"].shape[2:])
    st = snapshot["stored"].reshape(-1, snapshot["stored"].shape[-1])
    tabs = [snapshot[k].reshape(-1, snapshot[k].shape[-1]).contiguous()
            for k in ("vm", "ol", "cum")]
    got = apack_decode.decode(sym, ofs, st, *tabs, n_steps=128, bits=8)
    want = apack_decode.decode_plain(sym, ofs, st, *tabs, n_steps=128,
                                     bits=8)
    if not torch.equal(got, want):
        raise AssertionError("decode kernel != plain decoder on served pages")
    n = min(16, got.shape[0])
    sample = torch.linspace(0, got.shape[0] - 1, n).long().to(got.device)
    re = apack_encode.encode_plain(got[sample].contiguous(),
                                   *[t[sample] for t in tabs],
                                   n_steps=128, bits=8)
    if not (torch.equal(re[0], sym[sample]) and torch.equal(re[1], ofs[sample])
            and torch.equal(re[4].to(torch.int32), st[sample])):
        raise AssertionError("plain re-encode != kernel planes")
    print(f"verify: {got.shape[0]} served page-kinds decode bit-exact; "
          f"{n} re-encoded identically")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False")
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        return fail(f"{src}/repro_torch not found: run from a checkout")
    sys.path.insert(0, src)
    import repro_torch  # noqa: F401
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}")
    print(host_line())
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {json.dumps({k: round(v, 2) for k, v in built.items()})}"
          f" total {time.perf_counter() - t0:.1f} s")
    for name in _build.KERNELS:
        log = _build._target(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")
    records: dict = {}
    check_codec(device, records)
    check_fastpath_shapes(device, records)
    check_attention(device, records)
    check_decompress_matmul(device, records)
    check_gather(device, records)
    # phase 3: dense weights, the fused KV path's three kernels
    dense = serve_full_width(device, layers=28)
    fused_tokens = [r.tokens for r in dense["reqs"]]
    fused_first = dense["first_logits"]
    profile_steady_steps(dense["eng"], dense["cfg"], dense["rng"], "dense")
    verify_packed(dense["snapshot"])
    del dense
    torch.cuda.empty_cache()
    # phase 4: the main path, packed weights at full depth
    packed = serve_full_width(device, layers=28, weights="apack-int8")
    stores = oracle_stores(packed["eng"].params, packed.pop("host_weights"))
    check_packed_sites(packed["eng"], stores)
    teacher_forced(packed, stores)
    del stores
    torch.cuda.empty_cache()
    profile_steady_steps(packed["eng"], packed["cfg"], packed["rng"],
                         "packed")
    verify_packed(packed["snapshot"])
    launches = packed["launches"]
    del packed
    torch.cuda.empty_cache()
    # phase 5: the materialize oracle, calibrated from 20 pages so that
    # its first decode steps read HOT and COLD pages, its later ones HOT
    # and PACKED pages through the gather-decode kernel
    done: dict = {}
    oracle = serve_full_width(device, layers=28, fused=False, calib_pages=20,
                              hook=oracle_hook(done))
    if set(done) != {"cold", "packed"}:
        raise AssertionError(f"oracle gates ran only at {sorted(done)}")
    print("oracle vs fused serve: " + json.dumps({
        "token_agreement": token_agreement(
            [r.tokens for r in oracle["reqs"]], fused_tokens),
        "requests_identical": sum(r.tokens == t for r, t in
                                  zip(oracle["reqs"], fused_tokens)),
        "first_step_max_logit_diff": (oracle["first_logits"]
                                      - fused_first).abs().max().item()}))
    profile_steady_steps(oracle["eng"], oracle["cfg"], oracle["rng"],
                         "oracle")
    verify_packed(oracle["snapshot"])
    launches["gather_decode"] = oracle["launches"]["gather_decode"]
    del oracle
    torch.cuda.empty_cache()
    # phase 6: preempt and resume on the fused path
    pre = serve_full_width(device, layers=28, hook=preempt_hook)
    st = pre["eng"].stats
    print(f"preempt serve: preempted {st['preempted']} resumed "
          f"{st['resumed']}")
    if st["preempted"] != 1 or st["resumed"] != 1:
        raise AssertionError("preempt serve: slot 0 was not preempted and "
                             "resumed once")
    if [r.tokens for r in pre["reqs"]] != fused_tokens:
        raise AssertionError("preempt serve: tokens differ from the "
                             "uninterrupted fused serve")
    del pre
    torch.cuda.empty_cache()
    # phase 7: the uncompressed baseline, a dense int8 KV cache
    dense8 = serve_full_width(device, layers=28, kv="int8")
    profile_steady_steps(dense8["eng"], dense8["cfg"], dense8["rng"],
                         "int8 KV")
    del dense8
    torch.cuda.empty_cache()
    # phase 8: the JAX CLI's default weight path, compress_params ->
    # decompress_params, then a fused serve from the round-tripped weights
    rt = serve_full_width(device, layers=28,
                          params=weight_round_trip(device)[0],
                          label="round-trip")
    print("round-trip vs fused serve: " + json.dumps({
        "token_agreement": token_agreement([r.tokens for r in rt["reqs"]],
                                           fused_tokens),
        "requests_identical": sum(r.tokens == t for r, t in
                                  zip(rt["reqs"], fused_tokens))}))
    verify_packed(rt["snapshot"])
    del rt
    torch.cuda.empty_cache()
    fused_smoke = smoke_vs_cpu(device)
    smoke_vs_cpu(device, roundtrip=True)
    smoke_vs_cpu(device, weights="apack-int8")
    if smoke_vs_cpu(device, fused=False) != fused_smoke:
        raise AssertionError("SMOKE oracle engine on the card disagrees with "
                             "the fused engine on the card")
    smoke_vs_cpu(device, kv="int8")
    smoke_vs_cpu(device, kv="bfloat16")
    sources = {"apack_decode": ("src/repro_torch/kernels/csrc/apack_decode.cu",
                                "src/repro/kernels/apack_decode.py:34"),
               "apack_encode": ("src/repro_torch/kernels/csrc/apack_encode.cu",
                                "src/repro/kernels/apack_encode.py:52"),
               "fused_page_attention": (
                   "src/repro_torch/kernels/csrc/fused_page_attention.cu",
                   "src/repro/kernels/fused_page_attention.py:101"),
               "decompress_matmul": (
                   "src/repro_torch/kernels/csrc/decompress_matmul.cu",
                   "src/repro/kernels/decompress_matmul.py:170"),
               "gather_decode": (
                   "src/repro_torch/kernels/csrc/gather_decode.cu",
                   "src/repro/kernels/paged_decode.py:150")}
    kernels = []
    for name in _build.KERNELS:
        r = records[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": sources[name][0],
                        "replaces": sources[name][1],
                        "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
