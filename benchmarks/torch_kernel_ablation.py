#!/usr/bin/env python3
"""Ablation of the port's encode and gather-decode CUDA kernels on one GPU.

    python3 benchmarks/torch_kernel_ablation.py

Each variant is a kernel's source (``src/repro_torch/kernels/csrc``) with
one design choice undone by a text patch, built into ``build/ablation/``
with the port's nvcc flags, launched through its C entry point on the
inputs ``chip_smoke.py`` times, and timed as device time per call over a
CUDA graph of 20 calls (``chip_smoke.graph_ms``).  Each variant's output is
held against the unpatched kernel's: ``exact`` must hold for every variant
that keeps the result; ``floor`` variants drop work to show what it costs
and are not checked.  A patch that no longer applies to the source is
reported as stale and skipped.  One JSON line per kernel and shape.

Inputs: encode at [pages, 128 streams, 128 values] for 64 pages (the codec
shape), 56 (a decode step's seal: 28 layers x K/V) and 1120 (a prefill's
seal), 8-bit KV-like values, one of four table rows a page; gather decode
at G = 1024 pages of that kind (1000 ids with duplicates, edge-padded).
It needs a CUDA card and imports no JAX.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, what it undoes, text patches, result kept?)
ENCODE = [
    ("kernel", "", [], True),
    ("bisection_at_8_bits", "per-value row table (kLut) at bits <= 8",
     [("  if (bits <= LUT_BITS)\n", "  if (bits <= 0)\n")], True),
    ("branching_stores", "predicated stores in the sinks",
     [('  asm volatile(\n      "{\\n .reg .pred q;\\n setp.ne.b32 q, %2, 0;\\n"\n'
       '      " @q st.global.u32 [%0], %1;\\n}\\n" ::"l"(p),\n'
       '      "r"(v), "r"((int)pred));\n', "  if (pred) *p = v;\n")], True),
    ("unpinned_columns", "the opaque column pointers",
     [('  asm("" : "+l"(sym_col));\n  asm("" : "+l"(ofs_col));\n', "")], True),
    ("block_32", "128-thread blocks",
     [("constexpr int BLOCK = 128;", "constexpr int BLOCK = 32;")], True),
    ("block_64", "128-thread blocks",
     [("constexpr int BLOCK = 128;", "constexpr int BLOCK = 64;")], True),
    ("floor_no_symbol_sink", "(drops the symbol plane's bit sink)",
     [("    sk.append(has ? b1 | (inv_run << 1) : 0u, k1);\n    sk.flush();\n"
       "    sk.append(prefix >> 1, k2);\n    sk.flush();\n",
       "    sk.len += k1 + k2;\n    sk.lo ^= prefix;\n")], False),
]
_SINK_STORE = ("    if (k == 7) {\n"
               "      int4* dst = reinterpret_cast<int4*>(row + i - 7);\n"
               "      dst[0] = lo;\n      dst[1] = hi;\n    }\n")
GATHER = [
    ("kernel", "", [], True),
    ("four_byte_stores", "eight values to two 16-byte stores",
     [("  const bool vec = n_steps % 8 == 0;", "  const bool vec = false;")],
     True),
    ("block_64", "one page a block",
     [("constexpr int BLOCK = 128;", "constexpr int BLOCK = 64;")], True),
    ("floor_no_stores", "(drops the output stores)",
     [(_SINK_STORE, "    if (k == 7) acc ^= lo.x ^ lo.y ^ lo.z ^ lo.w ^ "
                    "hi.x ^ hi.y ^ hi.z ^ hi.w;\n"),
      ("  int4 lo = make_int4(0, 0, 0, 0), hi = lo;\n",
       "  int4 lo = make_int4(0, 0, 0, 0), hi = lo;\n  int acc = 0;\n"),
      ("                           stored, tab, a.n_steps, a.bits, sink))\n"
       "    return;\n",
       "                           stored, tab, a.n_steps, a.bits, sink)) {\n"
       "    if (acc == 0x12345678) row[0] = acc;\n    return;\n  }\n")],
     False),
]


def build(kernel: str, variants):
    """Start one nvcc per variant that applies; returns {name: (proc, so)}
    and the names whose patches are stale."""
    from repro_torch.kernels import _build
    procs, stale = {}, []
    for name, _, patches, _ in variants:
        src = (_build.CSRC / f"{kernel}.cu").read_text()
        if any(old not in src for old, _ in patches):
            stale.append(name)
            continue
        for old, new in patches:
            src = src.replace(old, new)
        d = os.path.join(ROOT, "build", "ablation", kernel, name)
        os.makedirs(d, exist_ok=True)
        for f in _build.CSRC.iterdir():
            shutil.copy(f, d)
        with open(os.path.join(d, f"{kernel}.cu"), "w") as f:
            f.write(src)
        so = os.path.join(d, "lib.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
             os.path.join(d, f"{kernel}.cu")], stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT), so)
    return procs, stale


def load(procs):
    libs = {}
    for name, (proc, so) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for variant {name}")
        libs[name] = ctypes.CDLL(so)
    return libs


def kv_pages(pages, device):
    """8-bit KV-like pages [pages, 128, 128] with eight noisy streams each,
    and table rows (four, page p on row p % 4) as [pages, ...] tensors."""
    import torch
    import chip_smoke as cs
    vals = cs.kv_like_values(pages, 128, 128, device)
    vals[:, :8] = torch.randint(0, 256, (pages, 8, 128), device=device,
                                dtype=torch.int32)
    (vm, ol, cm), rows = cs.table_rows(vals, 4)
    return vals, (vm, ol, cm), rows


def run_encode(libs, stale, device):
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ref
    argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    ws, wo = ref.sym_capacity_words(128), ref.ofs_capacity_words(128, 8)
    for pages in (64, 56, 1120):
        vals, tabs, rows = kv_pages(pages, device)
        vm, ol, cm = (t[rows].contiguous() for t in tabs)
        outs = {}
        row = {"source": "apack_encode.cu", "shape": [pages, 128, 128],
               "stale": stale}

        def launch(fn, out):
            rc = fn(*(t.data_ptr() for t in (vals, vm, ol, cm, *out)), pages,
                    128, 128, 8, ws, wo,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"apack_encode launch failed: {rc}")
        for name, what, _, kept in ENCODE:
            if name not in libs:
                continue
            fn = libs[name].apack_encode_launch
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            out = [torch.empty(pages, w, 128, dtype=torch.int32,
                               device=device) for w in (ws, wo)]
            out += [torch.empty(pages, 128, dtype=torch.int32,
                                device=device) for _ in range(3)]
            ms = cs.graph_ms(lambda: launch(fn, out), 20)
            outs[name] = out
            exact = all(torch.equal(a, b) for a, b in zip(out, outs["kernel"]))
            if kept and not exact:
                raise AssertionError(f"encode variant {name} changed the "
                                     "planes")
            row[name] = {"ms": ms, "undoes": what or None,
                         "exact": exact if kept else "floor"}
        print(json.dumps(row))


def run_gather(libs, stale, device):
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import apack_encode
    from repro_torch.kernels.apack_decode import staged_rows
    argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    torch.manual_seed(5)
    vals, (vm, ol, cm), rows = kv_pages(1024, device)
    sym, ofs, _, _, st = apack_encode.encode(vals, vm[rows], ol[rows],
                                             cm[rows], n_steps=128, bits=8)
    st = st.to(torch.int32)
    idx = torch.randint(0, 1024, (1000,), device=device)
    idx = torch.cat([idx, idx[-1:].expand(24)]).to(torch.int32)
    tid = rows[idx.long()].to(torch.int32)
    ws, wo = sym.shape[1], ofs.shape[1]
    rs, ro = staged_rows(128, 8, ws, wo)
    row = {"source": "gather_decode.cu", "shape": [1024, 128, 128],
           "stale": stale}
    ref_out = None
    for name, what, _, kept in GATHER:
        if name not in libs:
            continue
        fn = libs[name].gather_decode_launch
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        for staged in ((1, 0) if name == "kernel" else (1,)):
            out = torch.empty(1024, 128, 128, dtype=torch.int32,
                              device=device)

            def launch():
                rc = fn(*(t.data_ptr() for t in (sym, ofs, st, idx, tid, vm,
                                                   ol, cm, out)),
                        1024, ws, wo, 128, 128, 8, rs * staged, ro * staged,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"gather_decode launch failed: {rc}")
            key = name + ("" if staged else "/device_memory_planes")
            ms = cs.graph_ms(launch, 20)
            if ref_out is None:
                ref_out = out
            exact = bool(torch.equal(out, ref_out))
            if kept and not exact:
                raise AssertionError(f"gather variant {key} changed the "
                                     "values")
            row[key] = {"ms": ms, "undoes": what or None,
                        "exact": exact if kept else "floor"}
    print(json.dumps(row))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    device = torch.device("cuda", 0)
    enc_procs, enc_stale = build("apack_encode", ENCODE)
    gat_procs, gat_stale = build("gather_decode", GATHER)
    run_encode(load(enc_procs), enc_stale, device)
    run_gather(load(gat_procs), gat_stale, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
