#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card's name and power limit; build the three CUDA kernels
   from ``src/repro_torch/kernels/csrc`` with nvcc (one process each);
2. hold each kernel against its plain PyTorch version on the card at the
   full-width page shape of qwen3-1.7b: APack decode and encode bit-exact
   (bits 4/8/16, stored streams included), fused paged attention within an
   f32 tolerance on a mixed HOT/COLD/PACKED/FREE pool; time kernel, plain
   version, bound and (attention only) the PyTorch library yardstick;
3. serve qwen3-1.7b at full width (28 layers, seeded random weights) from
   the paged APack KV cache: 8 requests, prompts of 64-96 tokens, 48 new
   tokens each, with launch counts reset just before and read just after;
   a SMOKE-width engine on the card is checked against the CPU engine;
4. decode every PACKED page captured mid-serve with the decode kernel and
   with the plain decoder, and re-encode a sample with the plain encoder;
5. print the ``kernels`` JSON line, then the result line.

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


def check_codec(device, records):
    import torch
    from repro_torch.kernels import apack_decode, apack_encode
    for name, vals, tabs, bits in codec_inputs(device):
        e = vals.shape[-1]
        got = apack_encode.encode(vals, *tabs, n_steps=e, bits=bits)
        want = apack_encode.encode_plain(vals, *tabs, n_steps=e, bits=bits)
        for g, w, what in zip(got, want, ("sym", "ofs", "sym_bits",
                                          "ofs_bits", "stored")):
            if not torch.equal(g, w):
                raise AssertionError(f"encode {name}: {what} differs")
        dec = apack_decode.decode(got[0], got[1], got[4], *tabs, n_steps=e,
                                  bits=bits)
        dec_plain = apack_decode.decode_plain(got[0], got[1], got[4], *tabs,
                                              n_steps=e, bits=bits)
        if not torch.equal(dec, dec_plain) or not torch.equal(dec, vals):
            raise AssertionError(f"decode {name}: not bit-exact")
        n_stored = int(got[4].sum())
        print(f"codec {name}: shape {tuple(vals.shape)} bits {bits} "
              f"stored {n_stored} bit-exact")
        if name != "kv8":
            continue
        assert 0 < n_stored < got[4].numel(), "kv8 must mix stored and AC"
        # timing at the KV page shape (64 pages x 128 streams x 128 values)
        enc_ms = cuda_ms(lambda: apack_encode.encode(
            vals, *tabs, n_steps=e, bits=bits), 20)
        enc_plain = cuda_ms(lambda: apack_encode.encode_plain(
            vals, *tabs, n_steps=e, bits=bits), 1)
        dec_ms = cuda_ms(lambda: apack_decode.decode(
            got[0], got[1], got[4], *tabs, n_steps=e, bits=bits), 20)
        dec_plain_ms = cuda_ms(lambda: apack_decode.decode_plain(
            got[0], got[1], got[4], *tabs, n_steps=e, bits=bits), 1)
        # encode writes whole planes; decode reads only the coded words
        enc_bytes = nbytes(vals, *tabs, *got)
        dec_bytes = 4 * int(coded_words(got[2], got[3], got[0].shape[-2],
                                        got[1].shape[-2]).sum())
        dec_bytes += nbytes(got[4], *tabs, dec)
        records["apack_encode"] = dict(
            ms=enc_ms, plain_ms=enc_plain, max_abs_err=0,
            bound_ms=enc_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None, shape=list(vals.shape))
        records["apack_decode"] = dict(
            ms=dec_ms, plain_ms=dec_plain_ms, max_abs_err=0,
            bound_ms=dec_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None, shape=list(vals.shape))


def mixed_pool(device, jobs=4, p_slots=16, pool_pages=96):
    """A pool in every lifecycle state at the full-width page shape, and
    page tables whose slots mix HOT, COLD, PACKED and FREE pages."""
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
    state[:, -3:] = 0                                   # FREE padding
    state[-1] = 0                                       # a fully masked job
    t0 = torch.arange(p_slots)[None, :].expand(jobs, p_slots) * ps
    qpos = torch.full((jobs,), (p_slots - 3) * ps - 5)
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
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_page_attention as fpa
    from repro_torch.kernels.fused_page_attention import _page_tiles
    q, pid, tid, meta, jobmeta, planes, packed_bytes = mixed_pool(device)
    kw = dict(n_steps=128, softcap=0.0)
    for softcap in (0.0, 30.0):
        kw["softcap"] = softcap
        got = fpa.fused_page_attention(q, pid, tid, meta, jobmeta, planes,
                                       **kw)
        want = fpa.fused_page_attention_plain(q, pid, tid, meta, jobmeta,
                                              planes, **kw)
        torch.cuda.synchronize()
        # f32 throughout; the kernel sums each page's dot products in
        # another order than the plain einsum, hence rtol 1e-5 / atol 1e-6
        # on acc and l (m is a max of the same scores)
        err = 0.0
        for g_, w_, what in zip(got, want, ("acc", "m", "l")):
            if not torch.allclose(g_, w_, rtol=1e-5, atol=1e-6):
                raise AssertionError(
                    f"fused attention softcap={softcap}: {what} off by "
                    f"{(g_ - w_).abs().max().item()}")
            err = max(err, (g_ - w_).abs().max().item())
        print(f"fused_page_attention softcap={softcap}: "
              f"J={q.shape[0]} P={pid.shape[1]} max_abs_err={err:.3g}")
    kw["softcap"] = 0.0
    acc, m, l = fpa.fused_page_attention(q, pid, tid, meta, jobmeta, planes,
                                         **kw)
    ms = cuda_ms(lambda: fpa.fused_page_attention(
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
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask), 20)
    records["fused_page_attention"] = dict(
        ms=ms, plain_ms=plain, max_abs_err=err, bound_ms=bound, bound_by=by,
        library_ms=lib, shape=[j, p, ps, h, dh])


# ----------------------------------------------------------------- phase 3
def serve_full_width(device):
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import Request, ServeEngine
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              kv_cache_dtype="apack-int8")
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device)
    eng = ServeEngine(cfg, params, max_batch=4, max_len=160,
                      kv_page_size=16, kv_calib_pages=4, device=device)
    del params
    torch.cuda.synchronize()
    print(f"serve: qwen3-1.7b {cfg.num_layers} layers d_model "
          f"{cfg.d_model} built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    int(rng.integers(64, 97))).astype(np.int64),
                    max_new_tokens=48) for i in range(8)]
    for r in reqs:
        eng.submit(r)
    repro_torch.reset_launch_counts()
    snapshot = None
    step_s = []
    paused = 0.0                    # the snapshot copy is not serving time
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        n = eng.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - ts)
        if n == 0 and not eng.queue:
            break
        if snapshot is None and not eng.queue:
            tc = time.perf_counter()
            snapshot = capture_packed(eng)
            torch.cuda.synchronize()
            paused += time.perf_counter() - tc
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - paused
    launches = repro_torch.launch_counts()
    stats = eng.kv_stats()
    gen_tokens = sum(len(r.tokens) for r in reqs)
    if not all(r.done and len(r.tokens) == 48 for r in reqs):
        raise AssertionError("not every request completed")
    if stats["kv_pages_packed"] <= 0:
        raise AssertionError("no PACKED pages")
    if any(v <= 0 for v in launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")
    if not stats["kv_ratio"] or stats["kv_ratio"] >= 1:
        raise AssertionError(f"kv_ratio {stats['kv_ratio']} not < 1")
    if not torch.isfinite(eng.last_logits).all():
        raise AssertionError("non-finite logits")
    decode_steps = step_s[1:]                     # step 0 admits + calibrates
    summary = {"requests": len(reqs), "generated_tokens": gen_tokens,
               "wall_s": wall, "tokens_per_s": gen_tokens / wall,
               "steps": eng.stats["steps"],
               "median_step_ms": float(np.median(decode_steps) * 1e3),
               "first_step_s": step_s[0],
               "kv_ratio": stats["kv_ratio"],
               "kv_pages_packed": stats["kv_pages_packed"],
               "kv_pages_high_water": stats["kv_pages_high_water"],
               "transfers": stats["transfers"], "launches": launches,
               "launches_per_step": {k: v / eng.stats["steps"]
                                     for k, v in launches.items()},
               "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("serve: " + json.dumps(summary))
    profile_steady_steps(eng, cfg, rng)
    return launches, snapshot


def profile_steady_steps(eng, cfg, rng):
    """Where a steady decode step's time goes: torch.profiler over ten
    steps of a fresh full batch (tables already calibrated), device time by
    kernel name and the device's idle share of the window."""
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
    print(f"profile: 10 steady steps, wall {wall * 1e3:.1f} ms, device busy "
          f"{busy * 1e3:.1f} ms, idle share {1 - busy / wall:.3f}")
    for dev_us, key, count in rows[:12]:
        print(f"profile:   {dev_us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")
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


def smoke_vs_cpu(device):
    """The SMOKE-width engine on the card against the same engine on the
    CPU (plain versions): greedy tokens must be identical, and the prefill
    logits of the first request may differ by at most one bf16 step at
    their largest magnitude (cuBLAS and the CPU may round a bf16 GEMM
    differently; at this width they have agreed exactly)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import Request, ServeEngine
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              kv_cache_dtype="apack-int8")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n) for n in (20, 33, 9)]
    out = {}
    for dev in ("cpu", device):
        p = {"embed": params["embed"].to(dev),
             "final_norm": params["final_norm"].to(dev),
             "blocks": [{k: ({kk: vv.to(dev) for kk, vv in v.items()}
                             if isinstance(v, dict) else v.to(dev))
                         for k, v in b.items()} for b in params["blocks"]]}
        eng = ServeEngine(cfg, p, max_batch=2, max_len=64, kv_page_size=4,
                          kv_calib_pages=2, device=dev)
        reqs = [Request(i, x, max_new_tokens=12) for i, x in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        logits0, _ = eng._prefill_forward(prompts[0])
        eng.run_until_drained()
        out[dev] = ([r.tokens for r in reqs], logits0.float().cpu())
    diff = (out["cpu"][1] - out[device][1]).abs().max().item()
    step = (torch.finfo(torch.bfloat16).eps
            * out["cpu"][1].abs().max().item())
    same = out["cpu"][0] == out[device][0]
    print(f"smoke engine card vs cpu: prefill logit max diff {diff:.3g} "
          f"(bound {step:.3g}), greedy tokens identical {same}")
    if diff > step or not same:
        raise AssertionError("SMOKE engine on the card disagrees with CPU")


# ----------------------------------------------------------------- phase 4
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
    check_attention(device, records)
    launches, snapshot = serve_full_width(device)
    smoke_vs_cpu(device)
    verify_packed(snapshot)
    sources = {"apack_decode": ("src/repro_torch/kernels/csrc/apack_decode.cu",
                                "src/repro/kernels/apack_decode.py:34"),
               "apack_encode": ("src/repro_torch/kernels/csrc/apack_encode.cu",
                                "src/repro/kernels/apack_encode.py:52"),
               "fused_page_attention": (
                   "src/repro_torch/kernels/csrc/fused_page_attention.cu",
                   "src/repro/kernels/fused_page_attention.py:101")}
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
