#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card's name and power limit, and the host CPU's model, clock
   and core count; build the five
   CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc (one
   process each, all started together);
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
   then at recurrentgemma-9b's page [16, 1, 256] (32 streams of 128
   values): encode and decode at [2, 12 | 1548, 32, 128], the gather at
   G = 1024, 1 and 3, and fused attention with 16 query heads over one
   KV head, J = 4, 130 page slots and window 2048 (a job whose oldest
   page is partly rolled out, one whose ``qpos - window`` sits on a page
   boundary), each timed with its bound and yardstick; kernels 1 and 2 at
   a re-pack batch of 32 qwen3 pages with per-page table rows and at a
   data shard's batch of 48 (slice 14's mesh re-pack), and kernel
   5 at recurrentgemma-9b's packed sites (wq, wk, w_up, w_down at M = 4,
   w_up at M = 77) against the plain version, f64 and ``torch.matmul``;
   fused attention at the new architectures' pages: minitron-8b's
   [16, 8, 128] with 32 query heads (4096 values, one head block), and,
   past 4096 query-head values a page, where the kernel splits the KV
   heads over blocks, dbrx-132b's [16, 8, 128] with 48 and kimi-k2's
   [16, 8, 112] with 64, J = 4, P = 16, each timed with its bound and
   SDPA yardstick; kernel 5 at minitron-8b's
   untied head [4096, 256000] and squared-ReLU w_up/w_down [4096, 16384]
   / [16384, 4096] (M = 4, w_up also M = 77); kernel 3 on a mesh's two
   model shards (slice 13) at qwen3-1.7b's and dbrx-132b's pages, each
   launch over 4 of the 8 KV heads (jobmeta ``h0``, PACKED pages decoded
   whole) against its plain version, the two gathered bit-equal to the
   full-head launch; kernel 5 on a K half of qwen3's w_up (4 x 1024 x
   6144) against its plain version, the halves' sum against f64 and the
   full launch; each timed with its bound and yardstick;
3. serve qwen3-1.7b from dense weights through the fused paged APack KV
   path at full width and depth (28 layers, seeded random weights; 8
   requests, prompts of 64-96 tokens, 48 new tokens each), launch counts
   reset just before and read just after; (e) then on the async scheduler
   (``scheduler="async"``, chunks of 64 tokens) with slot 0 preempted with
   spill after ten decode steps: tokens equal to the sync serve's, at
   least 8 chunks and one readahead staged in the overlap window, the
   window (while a step is in flight), the dispatch and the pump start
   under ``torch.cuda.set_sync_debug_mode("error")``, and every steady
   step one device-to-host call besides its seal batches'; both
   schedulers' median and longest step printed; (l) then on a 2x2
   serving mesh (``make_debug_mesh(2, 2)``, every shard on the card,
   ``max_batch=8``: 4 rows a data shard, as phase 3 decodes): tokens equal
   to phase 3's, pages in their slot's data-shard range at steps 3 and
   30, every shard's free list whole after the drain, one ``.cpu()`` a
   step without seal pulls, kernel 3 launched 28 x 2 x 2 times a step;
   both serves' ``kv_ratio``, median and longest step printed (phase
   3's profiler window only: (l)'s and (e)'s, and (e)'s second sync
   serve, were cut for the script's time); (q) before them, on phase 3's
   engine: the static
   analyzer (``python -m repro_torch.analysis`` over the checkout, exit
   0, findings and suppressions by pass printed) and a window of
   ``SYNC_STEPS`` steady decode steps of a fresh batch under
   ``torch.cuda.set_sync_debug_mode("warn")``: the syncs a step, each
   sync's site (the innermost frame in ``src/repro_torch``, file:line)
   and the seals, re-packs and pulls in the window printed; every site
   must be one the boundary pass sanctions (a finding its suppression
   took); then start the CPU
   sides of phase 10 and (d) in a background process (``--cpu-twins``: at
   a quarter of the host's cores, no card visible to it, results to
   ``build/smoke_cpu_twins.pt``);
4. serve the same requests from APack-packed weights
   (``weights="apack-int8"``) and the paged APack KV cache, the main path,
   with its own launch counts; after the serve, build the oracle stores
   from a host copy of the f32 weights; check every packed site of two
   layers against f32 and f64 products; re-score the packed engine's
   sequences teacher-forced through their first ``CUT_LAYERS`` layers
   under the packed store, its f32 and f64 oracles and the dense store
   dequantized from the same int8 codes (the checks hold copies of those
   layers' weights only);
   profile steady steps of both engines; then serve them on the async
   scheduler from the same packed planes (not packed again), with (e)'s
   gates; (m) then the first ``CUT_LAYERS`` layers from packed weights on
   a 1x2 mesh, every site K-split over the two model shards: phase 4's
   teacher-forced RMS drift gate, the largest logit difference against
   the single-device packed store and kernel 5's launches a step
   printed;
5. serve the same requests through the materialize oracle
   (``kv_fused=False``) at ``CUT_LAYERS`` (4) layers, whose launch counts
   give the gather decode's;
   between steps, while the pages are HOT and COLD and again while they
   are HOT and PACKED, hold ``materialize`` through the kernel bit-exact
   against the plain decode and the fused attention kernel at the first
   and last layer against dense attention over the materialized cache;
   print token agreement with a fused serve at the same depth; profile
   steady steps;
   phase 3's engine then serves phase B of the refresh serve (8 requests
   of one hot prompt), the frozen control of (a);
6. serve them on the fused path at ``CUT_LAYERS`` layers with slot 0
   preempted after ten decode steps and resumed: the tokens must equal
   phase 5's fused serve at that depth;
7. serve them from a dense int8 KV cache, the uncompressed baseline, at
   ``CUT_LAYERS`` layers, and profile steady steps;
8. the JAX CLI's default weight path at full width: ``compress_params``
   (quantize, histogram, table search, the encode kernel, the pull of the
   trimmed planes) then ``decompress_params`` (upload, the decode kernel,
   dequantization), timed in parts with its own launch counts; every
   decompressed leaf must equal the codec-free dequantization of the same
   int8 codes bit for bit, and the plain encoder and decoder on the card
   must give the kernels' columns on 1,024 streams from each end of every
   distinct container shape; then serve the 8 requests from the first
   ``CUT_LAYERS`` layers of the round-tripped weights on the fused paged
   APack KV path;
   (a) table refresh at 28 layers: phase 3's requests then phase B on one
   engine with ``REFRESH_KW``; tokens equal to phase 3's and to the frozen
   control's, refresh fired and re-packed (kernels 1 and 2 once each a
   batch, as their wrappers count them, per-page table rows), every step
   that re-packs in one batch and seals nothing one device-to-host call
   (a step of more batches one a batch, counted apart), and
   ``oracle_gates`` at a step where PACKED pages of two generations
   coexist; the phase-B KV ratios and both engines' median steps printed;
   (b) pool pressure at 28 layers: 560 pages (two requests fit),
   ``kv_pressure`` and a 16-step slot deadline; tokens equal to phase 3's,
   pages spilled and every one read back, none quarantined, none failed,
   the pool free at the end; the spill ratio and seconds printed;
   (p) the serving mesh's robustness options at ``CUT_LAYERS`` layers on
   ``make_debug_mesh(2, 2)`` against one device at that depth: (a)'s
   two-phase refresh serve (every queued page re-packed in its step) with
   equal tokens, refreshes, re-packed pages and generation rows, and
   ``kv_ratio`` and re-pack bytes within ``MESH_BYTES_REL``, each re-pack
   batch launching kernels 1 and 2 once a data shard holding its pages; a pressure serve whose pool holds 1.5
   requests a data shard (level 2 preempts, every request resumes, equal
   tokens); ``kv_verify_on_repack`` with one ``corrupt_packed_page`` on a
   page of data shard 1 before its layer's refresh (its request fails
   with ``PageIntegrityError``, the others keep the single device's
   tokens);
9. serve recurrentgemma-9b at published widths, cut to ``RG_LAYERS``
   (14 of its 38 layers: 2 recurrent prefix layers + 4 of its 12
   (recurrent, recurrent, local) cycles; window
   2048, seed-0 random f32 weights served from their bf16 copy; the
   qwen3 engines freed first; page 16, 4 slots, ``max_len`` 2176; 8
   requests of 2001-2112-token prompts, half below the window and half
   above it, 48 new tokens each): the fused path (pages roll out at
   ingest and while decoding: ``kv_pages_evicted`` > 0) with a profiler
   window of steady steps, the materialize oracle (``materialize``
   through the gather kernel bit-exact against the plain decode at a
   step with PACKED pages, fused attention against dense attention over
   the ring), and the fused path with slot 0 preempted and resumed (its
   recurrent states through a byte-plane snapshot, kernels 2 and 1,
   restored bit for bit; tokens equal to the fused serve's); (c) then
   from packed weights (the f32 draw again, packed by layer kind): one
   local layer's attention sites and one recurrent layer's FFN against
   f32 and f64 products at M = 4 and 77, ``weight_stats()``, packing
   seconds and the token agreement with the fused serve printed; (f) the
   fused serve again on the async scheduler, chunks of 64 tokens (about
   32 a prompt): tokens equal to the sync serve's, pages evicted, (e)'s
   sync gates; both schedulers' median and longest step printed;
   (g) minitron-8b at published widths and depth (32 layers, d_model
   4096, GQA 32/8, squared-ReLU d_ff 16384, untied head, vocab 256000;
   7.7 G params, 30.9 GB f32 drawn from seed 0): the fused serve of phase
   3's requests from a bf16 copy cut to ``MINITRON_FUSED_LAYERS`` (8)
   layers, with a profiler window, then from packed weights at 32 layers
   (the head through kernel 5): layer 0's
   sites and the head against f32 and f64 products, ``weight_stats()``,
   packing seconds, and phase 4's teacher-forced re-score through the
   first ``CUT_LAYERS`` layers and the head (its RMS drift gate, and the
   agreement with the dense store printed against ``AGREEMENT_GATE``);
   (h) dbrx-132b at published widths (d_model 6144, GQA 48/8: kernel 3's
   head blocks; 16 experts top-4 of d_ff 10752, vocab 100352), cut to
   ``DBRX_LAYERS`` (2) layers, seed-0 bf16 weights: the fused serve with a
   profiler window and a serve with the attention sites and the head
   packed, its sites and re-score checked as (g)'s; both with
   ``kv_ratio`` < 1; then hubert-xlarge at published widths and depth:
   one forward of [2, 400] frames, finite logits, the first frame's
   logits moved by a change to the last frame (bidirectional), the engine
   refusing an encoder;
   (i) xlstm-125m at published widths and depth (12 layers, d_model 768,
   mLSTM and sLSTM alternating, seed-0 f32 weights), phase 3's requests:
   the engine with ``kv_cache_dtype="apack-int8"`` (no attention layer:
   0 pool pages, ``kv_ratio`` None, the states in the device state store)
   with its median and longest step, a dense bf16 cache (``decode_step``)
   whose tokens must be equal, and the apack-int8 engine with slot 0
   preempted after ten steps and resumed through the byte-plane snapshot
   (kernels 2 and 1 in the serve's counts), its states back bit for bit
   and its tokens equal; an empty state's -1e30 stabilizers through a
   snapshot on the card, bit for bit;
   (j) qwen3-1.7b training at published widths and depth (28 layers, f32
   params drawn on the card from seed 0, ``AdamWConfig(state_dtype=
   "int8")``, ``SyntheticLM`` batches of 8 x 256): the step's median ms,
   tokens/s, peak memory and a profiler window over two steady steps;
   then at ``CUT_LAYERS`` layers through ``Supervisor`` with
   ``compress_ckpt=True`` and ``save_every=3``, a ``RuntimeError``
   injected once into step 6 after the step-3 save, steps 4 and 5
   replayed and the run ended before its second save, under deterministic
   algorithms: the restored state equal to the saved one bit for bit (a
   per-leaf hash of the bytes on the card: params, ``Q8`` payloads and
   scales, the step; and the data cursor), the replayed steps' losses
   equal to the first pass's, every loss and grad norm finite; the
   checkpoint's stored/raw ratio, its save and restore seconds by part
   (host and kernel) and kernels 2 and 1's launches a save and a restore;
   (n), between them: (j)'s first step again on a 2x2 training mesh on
   the card (``param_shardings``, ``batch_shardings``, ``mesh_context``;
   ZeRO-sharded 8-bit moments, heads, FFN hidden and vocabulary over the
   model axis): every gradient leaf within ``SHARDED_GRAD_REL`` of one
   device's, the loss and grad norm within ``SHARDED_LOSS_REL`` of
   (j)'s, every param within ``SHARDED_PARAM_LR`` lr and the share within
   lr / 100 near a one-device control's (the batch in two microbatches),
   the step's ms, each device's bytes of params and moments and the peak
   memory printed;
   (k) xlstm-125m training at published widths and depth, 2 steps of 8 x
   256: finite losses and grads, the step's ms; (o) xlstm-125m's params
   saved compressed from a 2x2 mesh and from one device (files byte-equal)
   and restored onto 1x4, 4x1 and one device, bit-equal, with the save
   and restore seconds and kernels 2 and 1's launches; (r) the dry run
   on the card: qwen3-1.7b at published widths and depth, a decode cell
   (32,768 positions, 8 rows) and a prefill cell (32,768 tokens, one row)
   on a 1x1 mesh of the card, each built by ``launch.specs.build_cell``
   twice, counted once with fake tensors and once run on the card under
   the same ``launch.costs.CostCounter``: the counts equal op by op, the
   argument bytes within ``ARG_REL`` of the allocator's after placement,
   the counted peak within ``PEAK_BAND`` of ``max_memory_allocated``; the
   median call's ms printed beside the estimate (``DRYRUN_CELLS``);
10. check SMOKE-width engines (fused, packed, oracle, dense int8 and bf16
    caches, and the fused one on round-tripped weights, whose
    ``compress_params`` containers must match too; and fused, oracle and
    dense int8 engines on ``hetero-serve-smoke`` and recurrentgemma-9b
    SMOKE with window 8, whose KV stats must match too, and packed weights
    on both; fused engines on minitron-8b, command-r-plus-104b,
    paligemma-3b, dbrx-132b and kimi-k2-1t-a32b SMOKE, packed ones on
    minitron-8b and kimi-k2, whose ``kv_ratio`` must match too, and the
    xlstm-125m SMOKE engine, whose state stats must match) on the card
    against the same engines on the CPU, 3 training steps of qwen3 and
    xlstm SMOKE card against CPU (losses within ``TRAIN_SMOKE_RTOL``),
    and the
    oracle's tokens against the fused engine's on the card; (d) SMOKE
    refresh, pressure and fault engines (a flipped bit of a spilled record
    fails only its owner) card against CPU: tokens, ``kv_ratio``, refresh
    and spill counters; and the async engine on qwen3 and
    ``hetero-serve-smoke`` (chunks of 3 tokens, a preempt with spill,
    ``kv_refresh``, one request with ``slo_ms``) card against CPU:
    tokens, admission order, ``kv_ratio`` and the chunk, readahead,
    refresh and spill counters, its tokens equal to the sync engine's; the
    CPU sides of phase 10 come from the background process;
11. after each paged serve, decode every PACKED KV page captured mid-serve
    with the decode kernel and with the plain decoder, and re-encode a
    sample with the plain encoder;
12. print the phase-2 records at recurrentgemma-9b's page, at the re-pack
    batch, at recurrentgemma-9b's packed sites, at dbrx's and kimi's pages
    and at minitron-8b's packed sites, the script's seconds,
    the ``kernels`` JSON line (kernels 1 and 2 with their re-pack launches
    a step of (a), kernel 5 with its launches a step of (c), kernels 1,
    2, 3 and 5 with their launches a step of the async serves (e), kernels
    1, 2 and 3 a step of the mesh serve (l), kernel 5 a step of (m), kernel
    3 with its launches a step of (g)'s and (h)'s fused serves and kernel
    5 of their packed ones, kernels 2 and 1 with their launches a save
    and a restore of (j)'s checkpoint and in (i)'s preempt, and a data
    shard's re-pack batch and a step of (p), a save and a restore of
    (o)), then the result line.

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
# recurrentgemma-9b's page [16, 1, 256] (MQA: 16 query heads over one KV
# head), 32 streams of 128 values, and its local layers' window
RG_PAGE = dict(ps=16, h=1, dh=256, hq=16)
RG_WINDOW = 2048
AGREEMENT_GATE = 0.98             # the reference's teacher-forced gate
# minitron-8b's page: 32 query heads over 8 KV heads, the 4096 query-head
# values one block of kernel 3 accumulates; dbrx-132b's and kimi-k2's: 48
# and 64, past them (head blocks)
MINITRON_PAGE = dict(ps=16, h=8, dh=128, hq=32)
DBRX_PAGE = dict(ps=16, h=8, dh=128, hq=48)
KIMI_PAGE = dict(ps=16, h=8, dh=112, hq=64)
# dbrx-132b's depth on one card: 2 of its 40 layers (3.26 G params each)
DBRX_LAYERS = 2
# depth of the oracle (phase 5), int8-KV (phase 7) and round-trip (phase
# 8, its serve; the round trip itself stays at 28 layers) serves, cut from
# 28 so that the script stays within its time on the slower chip hosts
CUT_LAYERS = 4
XLSTM = "xlstm-125m"              # mLSTM/sLSTM layers: no KV pages
# recurrentgemma-9b's depth here: 2 recurrent prefix layers + 4 of its 12
# (recurrent, recurrent, local) cycles, and the depth of minitron-8b's
# fused serve in (g), cut so that the script stays within its time with
# the training phases
RG_LAYERS = 14
MINITRON_FUSED_LAYERS = 8
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


def timed_call(fn):
    """``fn()`` once, with its time in ms on the card's clock (CUDA events
    around the call, the card idle before it).  A plain version is timed
    on the one call that its check makes: it launches many small kernels
    and its time is the host's, so a second call would only repeat it."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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
    kernel's result and the plain encoder's ms (``timed_call``)."""
    import torch
    from repro_torch.kernels import apack_encode
    e = vals.shape[-1]
    got = apack_encode.encode(vals, *tabs, n_steps=e, bits=bits)
    want, plain_ms = timed_call(lambda: apack_encode.encode_plain(
        vals, *tabs, n_steps=e, bits=bits))
    for g, w, what in zip(got, want, ("sym", "ofs", "sym_bits", "ofs_bits",
                                      "stored")):
        if not torch.equal(g, w):
            raise AssertionError(f"encode {name}: {what} differs")
    return got, plain_ms


def encode_timing(vals, tabs, bits, got, plain_ms, iters=20,
                  plain_shape=None):
    """Device ms of the encode kernel beside the plain version's
    (``plain_ms``, from its check, on ``plain_shape`` where that sampled
    fewer streams than the shape's), and the bound: the values and table
    rows read once, the whole planes, bit counts and flags written once."""
    from repro_torch.kernels import apack_encode
    e = vals.shape[-1]
    ms = graph_ms(lambda: apack_encode.encode(vals, *tabs, n_steps=e,
                                              bits=bits), iters)
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=0,
                bound_ms=nbytes(vals, *tabs, *got) / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", library_ms=None, shape=list(vals.shape),
                plain_shape=plain_shape or list(vals.shape))


def check_decode(name, planes, tabs, bits, vals):
    """The decode kernel on encoded planes, bit-exact against the plain
    decoder and the encoded values; bool and int32 stored flags give
    identical outputs, and so do one shared 1-D table row and the same row
    copied out to every page.  Returns the kernel's output and the plain
    decoder's ms (``timed_call``)."""
    import torch
    from repro_torch.kernels import apack_decode
    sym, ofs, st = planes[0], planes[1], planes[4]
    kw = dict(n_steps=vals.shape[-1], bits=bits)
    got = apack_decode.decode(sym, ofs, st, *tabs, **kw)
    want, plain_ms = timed_call(lambda: apack_decode.decode_plain(
        sym, ofs, st, *tabs, **kw))
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
    return got, plain_ms


def decode_timing(planes, tabs, bits, out, plain_ms, iters=20,
                  plain_shape=None):
    """Device ms of the decode kernel beside the plain version's
    (``plain_ms``, from its check, on ``plain_shape`` where that sampled
    fewer streams), and the bound: the coded words of each stream (+1
    word) read once, the stored flags and table rows as given, the int32
    output written once."""
    from repro_torch.kernels import apack_decode
    sym, ofs, sb, ob, st = planes
    kw = dict(n_steps=out.shape[-1], bits=bits)
    ms = graph_ms(lambda: apack_decode.decode(sym, ofs, st, *tabs, **kw),
                  iters)
    read = 4 * int(coded_words(sb, ob, sym.shape[-2], ofs.shape[-2]).sum())
    read += nbytes(st, *tabs, out)
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=0,
                bound_ms=read / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                library_ms=None, shape=list(out.shape),
                plain_shape=plain_shape or list(out.shape),
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
        got, enc_plain = check_encode(name, vals, tabs, bits)
        dec, dec_plain = check_decode(name, got, tabs, bits, vals)
        n_stored = int(got[4].sum())
        print(f"codec {name}: shape {tuple(vals.shape)} bits {bits} "
              f"stored {n_stored} bit-exact (decode: bool and int32 stored, "
              "shared and per-page table rows)")
        if name != "kv8":
            continue
        assert 0 < n_stored < got[4].numel(), "kv8 must mix stored and AC"
        # timing at the KV page shape (64 pages x 128 streams x 128 values)
        records["apack_encode"] = encode_timing(vals, tabs, bits, got,
                                                enc_plain)
        records["apack_decode"] = decode_timing(got, tabs, bits, dec,
                                                dec_plain)
        for k in ("apack_encode", "apack_decode"):
            print(f"{k}: " + json.dumps(records[k]))
        codec = (got, tabs, e, bits)
        # one page: a single block, so its time is one stream's chain
        page = tuple(p[:1] for p in got)
        one, one_plain = check_decode("one page", page, tabs, bits, vals[:1])
        print("apack_decode one page (chain floor): bit-exact; "
              + json.dumps(decode_timing(page, tabs, bits, one, one_plain)))
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
        got, enc_plain = check_encode(f"pack n={n}", vals, tabs, 8)
        row = encode_timing(vals, tabs, 8, got, enc_plain)
        row["stored"] = int(got[4].sum())
        print(f"apack_encode pack n={n}: bit-exact; " + json.dumps(row))
        dec, dec_plain = check_decode(f"pack n={n}", got, tabs, 8, vals)
        print(f"apack_decode pack n={n}: bit-exact (bool and int32 stored); "
              + json.dumps(decode_timing(got, tabs, 8, dec, dec_plain)))
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
        want, enc_plain = timed_call(lambda: apack_encode.encode_plain(
            vals[idx], *tabs, **kw))
        for g, w, what in zip(got, want, ("sym", "ofs", "sym_bits",
                                          "ofs_bits", "stored")):
            if not torch.equal(g[..., idx], w):
                raise AssertionError(f"encode fastpath bits={bits}: {what} "
                                     "differs from the plain encoder")
        dec = apack_decode.decode(got[0], got[1], got[4], *tabs, **kw)
        plain, dec_plain = timed_call(lambda: apack_decode.decode_plain(
            got[0][:, idx], got[1][:, idx], got[4][idx], *tabs, **kw))
        if not torch.equal(dec, vals) or not torch.equal(dec[idx], plain):
            raise AssertionError(f"decode fastpath bits={bits}: not "
                                 "bit-exact")
        sampled = [len(idx), e]
        enc = encode_timing(vals, tabs, bits, got, enc_plain, iters=3,
                            plain_shape=sampled)
        enc["stored"] = int(got[4].sum())
        dct = decode_timing(got, tabs, bits, dec, dec_plain, iters=3,
                            plain_shape=sampled)
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


def check_ckpt_plane(device, records, vocab=151936):
    """Kernels 2 and 1 at the shape (j)'s checkpoint gives them most: the
    exponent byte plane (byte 3) of qwen3-1.7b's f32 embedding [151936,
    2048] as drawn from seed 0, 607,744 streams of 512 under the one
    activation-mode table the checkpoint fits to its first 2^20 bytes
    (``byteplane.fit_table``); the kernels' planes against the plain
    encoder's on the first and last 1,024 streams, the decode kernel's
    values against every value and the plain decoder's on those streams;
    both timed as ``check_fastpath_shapes`` times them.  Then the decode
    kernel on a mantissa plane (byte 0), stored verbatim (0 sym rows), as
    the restore decodes it."""
    import torch
    from repro_torch.core import byteplane
    from repro_torch.kernels import apack_decode, apack_encode, ops, ref
    e, n = 512, vocab * 2048 // 512
    g = torch.Generator(device=device).manual_seed(0)
    w = torch.randn(vocab * 2048, generator=g, device=device) * 2048 ** -0.5
    cols = w.view(torch.uint8).reshape(-1, 4)
    vals = cols[:, 3].to(torch.int32).reshape(n, e)
    table = byteplane.fit_table(cols[:2 ** 20, 3].cpu().numpy())
    tabs = ref.table_tensors(table, device)
    kw = dict(n_steps=e, bits=8)
    got = apack_encode.encode(vals, *tabs, **kw)
    idx = end_streams(n, device=device)
    want, enc_plain = timed_call(lambda: apack_encode.encode_plain(
        vals[idx], *tabs, **kw))
    if not all(torch.equal(a[..., idx], b) for a, b in zip(got, want)):
        raise AssertionError("encode at the checkpoint plane differs from "
                             "the plain encoder")
    dec = apack_decode.decode(got[0], got[1], got[4], *tabs, **kw)
    plain, dec_plain = timed_call(lambda: apack_decode.decode_plain(
        got[0][:, idx], got[1][:, idx], got[4][idx], *tabs, **kw))
    if not torch.equal(dec, vals) or not torch.equal(dec[idx], plain):
        raise AssertionError("decode at the checkpoint plane: not "
                             "bit-exact")
    sampled = [len(idx), e]
    out = {"shape": [n, e], "coded_over_raw": (
        int((got[2] + got[3]).sum()) / (8 * n * e)),
        "encode": encode_timing(vals, tabs, 8, got, enc_plain, iters=3,
                                plain_shape=sampled),
        "decode": decode_timing(got, tabs, 8, dec, dec_plain, iters=3,
                                plain_shape=sampled)}
    del got, dec, plain, want
    # a mantissa plane, stored: what the restore's decode gets from it
    ct = byteplane.compress_float(w[:n * e // 4].reshape(-1),
                                  device=device).planes[0]
    ca = ops.CompressedArrays.from_compressed_tensor(ct, device)
    back = ops.apack_decode(ca)
    mant = cols[:n * e // 4, 0]
    if not bool(ct.stored.all()) or not torch.equal(back.reshape(-1), mant):
        raise AssertionError("the stored mantissa plane is not decoded "
                             "bit for bit")
    out["decode_stored_ms"] = graph_ms(lambda: ops.apack_decode(ca), 3)
    out["decode_stored_shape"] = [n // 4, e]
    records["checkpoint plane"] = out
    print("codec at (j)'s checkpoint plane: " + json.dumps(out))
    del w, cols, vals, back, ca
    torch.cuda.empty_cache()


def mixed_pool(device, jobs=4, p_slots=16, pool_pages=96, page=PAGE):
    """A pool in every lifecycle state at a full-width page shape (``page``;
    streams of 128 values), and page tables whose slots mix HOT, COLD,
    PACKED and FREE pages (three FREE padding slots when there are more
    than four, else a PACKED first slot), the last job's slots all FREE."""
    import torch
    from repro_torch.core.tables import find_table, histogram
    from repro_torch.kernels import apack_encode, ref
    ps, h, dh, hq = page["ps"], page["h"], page["dh"], page["hq"]
    e = 128
    s = ps * h * dh // e
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
                    l, page=PAGE):
    """Least bytes and flops for the call's data: q, the metadata, the
    table rows, each distinct (page, state) that a slot names, read once in
    the form its state stores (a PACKED page as its coded words and stored
    flags, from ``packed_bytes``), and the outputs; flops of QK and PV over
    the tokens that pass the mask."""
    import torch
    ps, h, dh, hq = page["ps"], page["h"], page["dh"], page["hq"]
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
    from repro_torch.kernels import fused_page_attention as fpa
    err = 0.0
    plain_ms = {}
    for p_slots in (1, 7, 16):
        q, pid, tid, meta, jobmeta, planes, packed_bytes = mixed_pool(
            device, p_slots=p_slots)
        for softcap in (0.0, 30.0):
            kw = dict(n_steps=128, softcap=softcap)
            got = fpa.fused_page_attention(q, pid, tid, meta, jobmeta,
                                           planes, **kw)
            want, plain_ms[p_slots, softcap] = timed_call(
                lambda: fpa.fused_page_attention_plain(
                    q, pid, tid, meta, jobmeta, planes, **kw))
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
    plain = plain_ms[16, 0.0]
    bound, by = attention_bound(q, pid, tid, meta, jobmeta, planes,
                                packed_bytes, acc, m, l)
    ps, h, dh = PAGE["ps"], PAGE["h"], PAGE["dh"]
    records["fused_page_attention"] = dict(
        ms=ms, plain_ms=plain, max_abs_err=err, bound_ms=bound, bound_by=by,
        library_ms=attention_yardstick_ms(q, pid, tid, meta, jobmeta, planes,
                                          PAGE, 128),
        shape=[*pid.shape, ps, h, dh])
    print("fused_page_attention: " + json.dumps(dict(
        records["fused_page_attention"], eager_ms=eager)))


def check_gather(device, records, s=128, key="gather_decode"):
    """The gather-decode kernel against its plain version on the card at a
    materialize step's full-width shape: pages of ``s`` streams x 128
    values (128 at qwen3-1.7b's page, 32 at recurrentgemma-9b's) out of a
    pool of 1024 KV-like pages coded under four table rows (stored streams
    included), the record stored under ``key``.  Bit-exact with the ids given on the host (as
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
    n_pages, e = 1024, 128
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
        want, plain = timed_call(lambda: pd.gather_decode_plain(
            sym, ofs, st, idx, vm, ol, cm, table_idx=tid, **kw))
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
        print(f"{key}: G={g} ({n_ids} ids) S={s} bit-exact: "
              + ", ".join(got))
        cases[n_ids] = (idx, tid, plain)
    idx, tid, plain = cases[1000]
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
    distinct = torch.unique(idx.long())
    read = 4 * int(coded_words(sb[distinct], ob[distinct], sym.shape[1],
                               ofs.shape[1]).sum())
    read += nbytes(st[distinct], vm, ol, cm, idx, tid) + g * s * e * 4
    records[key] = dict(
        ms=ms, plain_ms=plain, max_abs_err=0,
        bound_ms=read / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, shape=[g, s, e])
    print(f"{key}: " + json.dumps(dict(
        records[key], eager_ms_host_ids=eager_host,
        eager_ms_card_ids=eager_card, distinct_pages=distinct.numel(),
        stored_streams=n_stored)))


def check_rg_codec(device, records):
    """Encode and decode kernels at recurrentgemma-9b's page [16, 1, 256]:
    [2 kinds, n pages, 32 streams, 128 values], a decode step's seal of
    one slot's 12 rolling layers (n = 12) and a prefill's ingest of one
    request, 12 layers x 129 pages (n = 1548), each page with one of four
    table rows; bit-exact against the plain versions and timed as device
    time per call over a CUDA graph of 20."""
    import torch
    for n in (12, 1548):
        vals = kv_like_values(2 * n, 32, 128, device)
        vals[:, :2] = torch.randint(0, 256, (2 * n, 2, 128), device=device,
                                    dtype=torch.int32)
        (vm, ol, cm), rows = table_rows(vals, 4)
        shape = (2, n, 32, 128)
        vals = vals.reshape(shape)
        tabs = tuple(t[rows].reshape(2, n, -1) for t in (vm, ol, cm))
        got, enc_plain = check_encode(f"[16, 1, 256] n={n}", vals, tabs, 8)
        records[f"apack_encode n={n}"] = encode_timing(vals, tabs, 8, got,
                                                       enc_plain)
        dec, dec_plain = check_decode(f"[16, 1, 256] n={n}", got, tabs, 8,
                                      vals)
        records[f"apack_decode n={n}"] = decode_timing(got, tabs, 8, dec,
                                                       dec_plain)
        for k in ("apack_encode", "apack_decode"):
            print(f"{k} [16, 1, 256] n={n}: bit-exact; "
                  + json.dumps(records[f"{k} n={n}"]))


def check_attention_rolling(device, records):
    """The fused attention kernel on recurrentgemma-9b's local layers: page
    [16, 1, 256], 16 query heads over one KV head (g = 16, Hq*dh = 4096,
    the wrapper's limit), J = 4 jobs over 130 page slots past three
    evicted pages (COLD and PACKED pages, the last one HOT), window 2048.
    Job 0's ``qpos - window`` falls inside its oldest page (partly rolled
    out), job 1's exactly on a page boundary, job 2 is a decode step over
    a HOT last page with its oldest page and a half rolled out, job 3 reads
    the same table as a global layer (window 0).  Against the plain
    version at f32 rtol 1e-5 / atol 1e-6; timed as device time per call
    over a CUDA graph of 20, with its bound and SDPA over the same pages
    dequantized into a dense f32 cache (masked alike) as its yardstick."""
    import torch
    from repro_torch.kernels import fused_page_attention as fpa
    page = RG_PAGE
    ps, h, dh, hq = page["ps"], page["h"], page["dh"], page["hq"]
    jobs, slots, base = 4, 130, 3
    q, pid, tid, meta, jobmeta, planes, packed_bytes = mixed_pool(
        device, jobs=jobs, p_slots=slots, pool_pages=96, page=page)
    g = torch.Generator(device="cpu").manual_seed(2)
    state = torch.randint(2, 4, (jobs, slots), generator=g)
    state[:, -1] = 1
    t0 = (base + torch.arange(slots))[None, :].expand(jobs, slots) * ps
    meta = torch.stack([state, t0], -1).to(torch.int32).to(device)
    first = base * ps
    qpos = torch.tensor([first + RG_WINDOW + 7, first + RG_WINDOW + 16,
                         (base + slots) * ps - 3, (base + slots) * ps - 3])
    window = torch.tensor([RG_WINDOW, RG_WINDOW, RG_WINDOW, 0])
    jobmeta = torch.stack([qpos, window], -1).to(torch.int32).to(device)
    n_steps = 128
    got = fpa.fused_page_attention(q, pid, tid, meta, jobmeta, planes,
                                   n_steps=n_steps)
    want, plain = timed_call(lambda: fpa.fused_page_attention_plain(
        q, pid, tid, meta, jobmeta, planes, n_steps=n_steps))
    mag = fpa.fused_page_attention_f64(q, pid, tid, meta, jobmeta, planes,
                                       n_steps=n_steps)[3]
    torch.cuda.synchronize()
    # f32 tolerance rtol 1e-5 / atol 1e-6, as the other attention checks;
    # over ~2000 keys acc cancels toward zero, so its relative part is
    # taken against sum(w |v|), the magnitude of its f32 sums (as the
    # oracle gates take it)
    err = (got[0] - want[0]).abs()
    worst = (err / (1e-5 * mag.float() + 1e-6)).max().item()
    if not worst <= 1.0:
        raise AssertionError(
            f"fused attention [16, 1, 256] window {RG_WINDOW}: acc off by "
            f"{err.max().item()} ({worst:.3g}x the tolerance)")
    err = err.max().item()
    for g_, w_, what in zip(got[1:], want[1:], ("m", "l")):
        if not torch.allclose(g_, w_, rtol=1e-5, atol=1e-6):
            raise AssertionError(
                f"fused attention [16, 1, 256] window {RG_WINDOW}: {what} "
                f"off by {(g_ - w_).abs().max().item()}")
        err = max(err, (g_ - w_).abs().max().item())
    if not bool((got[2] > 0).all()):
        raise AssertionError("fused attention [16, 1, 256]: a job read no "
                             "key")
    kw = dict(n_steps=n_steps)
    ms = graph_ms(lambda: fpa.fused_page_attention(
        q, pid, tid, meta, jobmeta, planes, **kw), 20)
    bound, by = attention_bound(q, pid, tid, meta, jobmeta, planes,
                                packed_bytes, *got, page=page)
    pos = meta[..., 1:2] + torch.arange(ps, device=device)
    qp, win = jobmeta[:, 0, None, None], jobmeta[:, 1, None, None]
    valid = (pos < qp) & (meta[..., 0:1] != 0)
    valid &= torch.where(win > 0, pos > qp - win, True)
    records["fused_page_attention [16, 1, 256]"] = dict(
        ms=ms, plain_ms=plain, max_abs_err=err, bound_ms=bound, bound_by=by,
        library_ms=attention_yardstick_ms(q, pid, tid, meta, jobmeta, planes,
                                          page, n_steps),
        shape=[*pid.shape, ps, h, dh], window=RG_WINDOW,
        acc_worst_of_tolerance=worst,
        keys_per_job=valid.reshape(len(pid), -1).sum(-1).tolist())
    print("fused_page_attention [16, 1, 256]: " + json.dumps(
        records["fused_page_attention [16, 1, 256]"]))


def check_repack_batch(device, records, n=32):
    """Kernels 1 and 2 at a table refresh's re-pack batch: ``n`` qwen3-1.7b
    pages [2 kinds, n, 128 streams, 128 values], each page with its own
    table rows, packed under old rows (one of four fitted to a Laplace
    body) and re-packed under new ones (fitted to a narrower body): one
    decode launch with the old rows, one encode launch with the new,
    ``PagedKVCache.launch_repack``'s two launches.  Bit-exact against the
    plain versions and the original values, timed as device time per call
    over a CUDA graph of 20."""
    import torch
    vals = kv_like_values(2 * n, 128, 128, device)
    (vm, ol, cm), rows = table_rows(vals, 4)
    narrow = (kv_like_values(2 * n, 128, 128, device) // 4) & 0xFF
    (nvm, nol, ncm), _ = table_rows(narrow, 4)
    shape = (2, n, 128, 128)
    vals = vals.reshape(shape)
    old = tuple(t[rows].reshape(2, n, -1) for t in (vm, ol, cm))
    new = tuple(t[rows].reshape(2, n, -1) for t in (nvm, nol, ncm))
    packed = check_encode(f"re-pack n={n} (old rows)", vals, old, 8)[0]
    dec, dec_plain = check_decode(f"re-pack n={n}", packed, old, 8, vals)
    repacked, enc_plain = check_encode(f"re-pack n={n} (new rows)", dec, new,
                                       8)
    back = check_decode(f"re-pack n={n} (new rows)", repacked, new, 8,
                        vals)[0]
    if not torch.equal(back, vals):
        raise AssertionError("re-pack: the re-packed planes do not decode "
                             "to the original values")
    records[f"apack_decode repack n={n}"] = decode_timing(packed, old, 8, dec,
                                                          dec_plain)
    records[f"apack_encode repack n={n}"] = encode_timing(dec, new, 8,
                                                          repacked, enc_plain)
    for k in ("apack_decode", "apack_encode"):
        print(f"{k} re-pack batch n={n} (per-page rows): bit-exact; "
              + json.dumps(records[f"{k} repack n={n}"]))


def check_rg_matmul(device, records):
    """Kernel 5 at recurrentgemma-9b's packed sites (``matmul_rows``),
    quantized from normal weights as ``pack_weights`` does: wq [4096,
    4096], wk/wv [4096, 256], w_up/w_gate [4096, 12288] and w_down [12288,
    4096] at M = 4 (a decode step), and w_up at M = 77 (a prefill)."""
    import torch
    from repro_torch.core import quant
    g = torch.Generator(device=device).manual_seed(8)
    for name, k, n, ms_ in (("wq", 4096, 4096, (4,)),
                            ("wk", 4096, 256, (4,)),
                            ("w_up", 4096, 12288, (4, 77)),
                            ("w_down", 12288, 4096, (4,))):
        w = torch.randn(k, n, generator=g, device=device) * k ** -0.5
        q, qp = quant.quantize_symmetric(w, axis=-1)
        del w
        _, rows = matmul_rows(name, q, qp.scale.reshape(-1), ms_, g)
        for row in rows:
            records[f"decompress_matmul {name} M={row['shape'][0]}"] = row
            print("decompress_matmul recurrentgemma-9b: " + json.dumps(row))
        del q, rows
        torch.cuda.empty_cache()


def attention_yardstick_ms(q, pid, tid, meta, jobmeta, planes, page,
                           n_steps, h_full=None):
    """SDPA over the pages of a fused attention call dequantized into a
    dense f32 cache, masked alike (causal, window): device time per call
    over a CUDA graph of 20.  ``h_full``: a model shard's call, whose
    PACKED pages hold that many heads (jobmeta's third column its first)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fused_page_attention import (_head_offsets,
                                                          _page_tiles)
    ps, h, dh, hq = page["ps"], page["h"], page["dh"], page["hq"]
    kt, vt = _page_tiles(planes, pid, tid, meta[..., 0], n_steps, 8,
                         _head_offsets(jobmeta), h_full)
    j, p = pid.shape
    kd = kt.reshape(j, p * ps, h, dh).transpose(1, 2).repeat_interleave(
        hq // h, dim=1).contiguous()
    vd = vt.reshape(j, p * ps, h, dh).transpose(1, 2).repeat_interleave(
        hq // h, dim=1).contiguous()
    pos = meta[..., 1:2] + torch.arange(ps, device=q.device)
    qp, win = jobmeta[:, 0, None, None], jobmeta[:, 1, None, None]
    valid = (pos < qp) & (meta[..., 0:1] != 0)
    valid &= torch.where(win > 0, pos > qp - win, True)
    mask = valid.reshape(j, 1, 1, p * ps)
    return graph_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kd, vd, attn_mask=mask), 20)


def check_attention_heads(device, records):
    """The fused attention kernel at the new architectures' pages:
    minitron-8b's [16, 8, 128] with Hq 32 (4096 query-head values, one
    head block: 16 accumulators a thread over 4 query heads a KV head)
    and, past 4096 values, where it splits the KV heads over blocks
    (``heads_per_block``), dbrx-132b's [16, 8, 128] with Hq 48 and
    kimi-k2's [16, 8, 112] with Hq 64 (2 head blocks each; kimi's
    128-value streams straddle heads), on the mixed HOT/COLD/PACKED/FREE
    pool at J = 4, P = 16, with and without the softcap, against the
    plain version at f32 rtol 1e-5 / atol 1e-6 (``acc``'s relative part
    against sum(w |v|), ``fused_page_attention_f64``; each case's worst
    error as a share of that tolerance is recorded); timed as device time
    per call over a CUDA graph of 20, with its bound and SDPA over the
    same pages dequantized as its yardstick."""
    import torch
    from repro_torch.kernels import fused_page_attention as fpa
    for name, page in (("minitron-8b", MINITRON_PAGE),
                       ("dbrx-132b", DBRX_PAGE),
                       ("kimi-k2-1t-a32b", KIMI_PAGE)):
        q, pid, tid, meta, jobmeta, planes, packed_bytes = mixed_pool(
            device, page=page)
        err = 0.0
        share = {}
        for softcap in (0.0, 30.0):
            kw = dict(n_steps=128, softcap=softcap)
            got = fpa.fused_page_attention(q, pid, tid, meta, jobmeta,
                                           planes, **kw)
            want, plain = timed_call(lambda: fpa.fused_page_attention_plain(
                q, pid, tid, meta, jobmeta, planes, **kw))
            # acc's relative part against sum(w |v|), the magnitude of its
            # f32 sums, where acc cancels toward zero (as the rolling check)
            mag = fpa.fused_page_attention_f64(q, pid, tid, meta, jobmeta,
                                               planes, **kw)[3].float()
            worst = ((got[0] - want[0]).abs()
                     / (1e-5 * mag + 1e-6)).max().item()
            share[f"softcap {softcap:g}"] = worst
            if not worst <= 1.0:
                raise AssertionError(
                    f"fused attention {name} softcap={softcap}: acc off by "
                    f"{(got[0] - want[0]).abs().max().item()} ({worst:.3g}x "
                    "the tolerance)")
            for g_, w_, what in zip(got[1:], want[1:], ("m", "l")):
                if not torch.allclose(g_, w_, rtol=1e-5, atol=1e-6):
                    raise AssertionError(
                        f"fused attention {name} softcap={softcap}: {what} "
                        f"off by {(g_ - w_).abs().max().item()}")
            err = max(err, *((g_ - w_).abs().max().item()
                             for g_, w_ in zip(got, want)))
            if softcap == 0.0:
                plain_ms, acc = plain, got
        kw = dict(n_steps=128)
        ms = graph_ms(lambda: fpa.fused_page_attention(
            q, pid, tid, meta, jobmeta, planes, **kw), 20)
        bound, by = attention_bound(q, pid, tid, meta, jobmeta, planes,
                                    packed_bytes, *acc, page=page)
        ps, h, dh, hq = page["ps"], page["h"], page["dh"], page["hq"]
        key = f"fused_page_attention [{ps}, {h}, {dh}] Hq {hq}"
        records[key] = dict(
            ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bound,
            bound_by=by, library_ms=attention_yardstick_ms(
                q, pid, tid, meta, jobmeta, planes, page, 128),
            shape=[*pid.shape, ps, h, dh], hq=hq,
            head_blocks=h // fpa.heads_per_block(hq, h, dh),
            acc_err_share_of_tolerance=share)
        print(f"{key} ({name}): " + json.dumps(records[key]))
        del q, planes
        torch.cuda.empty_cache()


def head_shard(planes, j, n):
    """Model shard ``j`` of ``n``'s planes of a pool (``sharding.
    plane_pspecs``): its KV-head block of the dense planes and page scales
    (contiguous copies), the PACKED planes and tables whole."""
    out = dict(planes)
    for key, ax in (("tok_k", 2), ("tok_v", 2), ("cold_k", 2),
                    ("cold_v", 2), ("tok_sk", 2), ("tok_sv", 2),
                    ("pscale_k", 1), ("pscale_v", 1)):
        hl = planes[key].shape[ax] // n
        out[key] = planes[key].narrow(ax, j * hl, hl).contiguous()
    return out


def check_attention_head_shards(device, records):
    """Kernel 3 on a mesh's model shards (slice 13): at qwen3-1.7b's page
    [16, 8, 128] (Hq 16) and dbrx-132b's (Hq 48: a shard's 24 query heads
    fit one head block), on the mixed HOT/COLD/PACKED/FREE pool at J = 4,
    P = 16, two launches, each over one shard's 4 KV heads (jobmeta
    ``(qpos, window, h0)``, dense planes of those heads, PACKED planes of
    all 8, ``h_full`` 8).  Each launch against its plain version (``m``,
    ``l`` at f32 rtol 1e-5 / atol 1e-6, ``acc`` within 1e-5 of sum(w |v|)
    + 1e-6, as ``check_attention_heads``), and the two side by side
    bit-equal to the full-head launch.  Timed: one launch and the two
    (device time per call over a CUDA graph of 20), the bound and SDPA over
    a shard's heads."""
    import torch
    from repro_torch.kernels import fused_page_attention as fpa
    for name, page in (("qwen3-1.7b", PAGE), ("dbrx-132b", DBRX_PAGE)):
        q, pid, tid, meta, jobmeta, planes, packed_bytes = mixed_pool(
            device, page=page)
        h, hq = page["h"], page["hq"]
        kw = dict(n_steps=128)
        full = fpa.fused_page_attention(q, pid, tid, meta, jobmeta, planes,
                                        **kw)
        shards, outs, err, plain_ms = [], [], 0.0, None
        for j in range(2):
            jm = torch.cat([jobmeta, torch.full_like(jobmeta[:, :1],
                                                     j * h // 2)], dim=1)
            qj = q[:, j * hq // 2:(j + 1) * hq // 2].contiguous()
            pl = head_shard(planes, j, 2)
            args = (qj, pid, tid, meta, jm, pl)
            got = fpa.fused_page_attention(*args, h_full=h, **kw)
            want, t = timed_call(lambda: fpa.fused_page_attention_plain(
                *args, h_full=h, **kw))
            mag = fpa.fused_page_attention_f64(*args, h_full=h,
                                               **kw)[3].float()
            if not bool(((got[0] - want[0]).abs()
                         <= 1e-5 * mag + 1e-6).all()):
                raise AssertionError(f"fused attention head shard {j} "
                                     f"({name}): acc off")
            for g_, w_, what in zip(got[1:], want[1:], ("m", "l")):
                if not torch.allclose(g_, w_, rtol=1e-5, atol=1e-6):
                    raise AssertionError(
                        f"fused attention head shard {j} ({name}): {what} "
                        f"off by {(g_ - w_).abs().max().item()}")
            err = max(err, *((g_ - w_).abs().max().item()
                             for g_, w_ in zip(got, want)))
            plain_ms = plain_ms or t
            shards.append(args)
            outs.append(got)
        for i, what in enumerate(("acc", "m", "l")):
            if not torch.equal(torch.cat([o[i] for o in outs], dim=1),
                               full[i]):
                raise AssertionError(f"fused attention ({name}): the head "
                                     f"shards' gathered {what} is not the "
                                     "full-head launch's bit for bit")
        ms = graph_ms(lambda: fpa.fused_page_attention(
            *shards[0], h_full=h, **kw), 20)
        both = graph_ms(lambda: [fpa.fused_page_attention(
            *a, h_full=h, **kw) for a in shards], 20)
        shard_page = dict(page, h=h // 2, hq=hq // 2)
        bound, by = attention_bound(*shards[0][:5], shards[0][5],
                                    packed_bytes, *outs[0], page=shard_page)
        ps, dh = page["ps"], page["dh"]
        key = f"fused_page_attention head shard [{ps}, {h}, {dh}] Hq {hq}"
        records[key] = dict(
            ms=ms, two_shards_ms=both, plain_ms=plain_ms, max_abs_err=err,
            bound_ms=bound, bound_by=by,
            library_ms=attention_yardstick_ms(*shards[0], shard_page, 128,
                                              h_full=h),
            shape=[*pid.shape, ps, h // 2, dh], hq=hq // 2, h_full=h,
            gathered_bit_equal=True)
        print(f"{key} ({name}, 2 model shards): " + json.dumps(records[key]))
        del q, planes, shards
        torch.cuda.empty_cache()


def check_matmul_k_split(device, records):
    """Kernel 5 on a mesh's model shard (slice 13): qwen3-1.7b's w_up
    [2048, 6144] quantized as ``pack_weights`` does, cut in its two K
    halves (``split_k``: 2 of its 4 K tiles each); each half at M = 4
    against its plain version within the K-term f32 bound and with its
    error against f64 at most ``F64_ERR_RATIO`` times cuBLAS f32's; the
    halves summed (``psum``) against the f64 product under the same ratio
    and against the full launch within the bound of a 2048-term f32 sum.
    Timed: a half (device time per call over a CUDA graph of 20), its
    bound and ``torch.matmul`` on the half's dequantized weight."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import apack_encode, decompress_matmul as dm
    from repro_torch.models import sharding as shd
    g = torch.Generator(device=device).manual_seed(2)
    k, n = 2048, 6144
    w = torch.randn(k, n, generator=g, device=device) * k ** -0.5
    q, qp = quant.quantize_symmetric(w, axis=-1)
    del w
    scale = qp.scale.reshape(-1)
    cw = dm.compress_quantized(q, scale, dm.DEFAULT_TILE_K)
    halves = dm.split_k(cw, 2)
    wf = q.to(torch.float32) * scale[None, :]
    x = torch.randn(4, k, generator=g, device=device)
    _, _, sb, ob, _ = apack_encode.encode(
        dm.tile_streams(q, cw.tile_k), cw.v_min, cw.ol, cw.cum,
        n_steps=cw.tile_k, bits=8)
    per = sb.shape[0] // 2
    row, ys = None, []
    for j, half in enumerate(halves):
        xj = x[:, j * 1024:(j + 1) * 1024]
        wj = wf[j * 1024:(j + 1) * 1024]
        y = dm.compressed_matmul(xj, half)
        y_plain, plain_ms = timed_call(
            lambda: dm.compressed_matmul_plain(xj, half))
        bound = 1024 * 2.0 ** -24 * (xj.abs().double() @ wj.abs().double())
        err = (y.double() - y_plain.double()).abs()
        ratio = f64_err_ratio(y, xj, wj)
        if not (bool((err <= bound).all()) and ratio <= F64_ERR_RATIO):
            raise AssertionError(f"decompress_matmul K half {j}: off by "
                                 f"{err.max().item():.3g}, {ratio:.3g}x "
                                 "cuBLAS f32's error against f64")
        ys.append(y)
        if j:
            continue
        xc = xj.contiguous()
        coded = 4 * int(coded_words(sb[:per], ob[:per], cw.sym_plane.shape[0],
                                    cw.ofs_plane.shape[0]).sum())
        nb = coded + nbytes(half.stored, half.v_min, half.ol, half.cum,
                            half.scale, xc, y)
        t_b, t_f = nb / HBM_BYTES_PER_S, 2 * 4 * 1024 * n / F32_FLOPS
        row = dict(shape=[4, 1024, n], ms=graph_ms(
            lambda: dm.compressed_matmul(xc, half), 20),
            plain_ms=plain_ms,
            library_ms=graph_ms(lambda: torch.matmul(xc, wj), 20),
            bound_ms=max(t_b, t_f) * 1e3,
            bound_by="bytes" if t_b >= t_f else "operations",
            max_abs_err=err.max().item(), f64_err_ratio=ratio)
    summed = shd.psum(ys, device)
    full = dm.compressed_matmul(x, cw)
    ratio = f64_err_ratio(summed, x, wf)
    full_ratio = f64_err_ratio(full, x, wf)
    bound = k * 2.0 ** -24 * (x.abs().double() @ wf.abs().double())
    diff = (summed.double() - full.double()).abs()
    if not (ratio <= F64_ERR_RATIO and bool((diff <= bound).all())):
        raise AssertionError(f"decompress_matmul K halves: the psum is "
                             f"{ratio:.3g}x cuBLAS f32's error against f64 "
                             f"(limit {F64_ERR_RATIO}), off the full launch "
                             f"by {diff.max().item():.3g}")
    row.update(psum_f64_err_ratio=ratio, full_f64_err_ratio=full_ratio,
               psum_vs_full_max_abs=diff.max().item(),
               psum_vs_full_bound_min=bound.min().item())
    records["decompress_matmul K half [4, 1024, 6144]"] = row
    print("decompress_matmul K half (qwen3-1.7b w_up, 2 model shards): "
          + json.dumps(row))
    del q, wf, cw, halves
    torch.cuda.empty_cache()


def check_minitron_matmul(device, records):
    """Kernel 5 at minitron-8b's new packed sites (``matmul_rows``),
    quantized from normal weights as ``pack_weights`` does: the untied
    head ``unembed`` [4096, 256000] and the squared-ReLU FFN's w_up
    [4096, 16384] and w_down [16384, 4096] at M = 4 (a decode step), and
    w_up at M = 77 (a prefill)."""
    import torch
    from repro_torch.core import quant
    g = torch.Generator(device=device).manual_seed(9)
    for name, k, n, ms_ in (("unembed", 4096, 256000, (4,)),
                            ("w_up", 4096, 16384, (4, 77)),
                            ("w_down", 16384, 4096, (4,))):
        w = torch.randn(k, n, generator=g, device=device) * k ** -0.5
        q, qp = quant.quantize_symmetric(w, axis=-1)
        del w
        _, rows = matmul_rows(name, q, qp.scale.reshape(-1), ms_, g)
        for row in rows:
            records[f"decompress_matmul minitron-8b {name} "
                    f"M={row['shape'][0]}"] = row
            print("decompress_matmul minitron-8b: " + json.dumps(row))
        del q, rows
        torch.cuda.empty_cache()


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


def matmul_rows(name, q, scale, ms_, g, detail=False):
    """Kernel 5 on the int8 weight ``q`` [K, N] with per-column ``scale``
    against its plain version on the card, at each M of ``ms_``, TF32 off:

    - within the worst-case rounding bound of a K-term f32 sum,
      K * 2^-24 * (|x| @ |W|) per output, since the two sum inside a K tile
      in different orders (sequential fused multiply-adds against a cuBLAS
      f32 GEMM) and across K tiles in the same kt order;
    - with its largest error against an f64 product at most
      ``F64_ERR_RATIO`` times that of cuBLAS f32 on the same inputs.

    Timed as device time per call over a CUDA graph of 20, with its bound
    and ``torch.matmul`` on the dequantized weight.  ``detail`` adds the
    integer-exact check (``exact_matmul_check``) and the eager and
    staging-only times.  Returns the packed weight and a row for each M."""
    import torch
    from repro_torch.kernels import apack_encode, decompress_matmul as dm
    cw = dm.compress_quantized(q, scale, min(dm.DEFAULT_TILE_K, q.shape[0]))
    # the coded words that every stream's decoder reads, from the encode
    # kernel's bit counts
    _, _, sb, ob, _ = apack_encode.encode(
        dm.tile_streams(q, cw.tile_k), cw.v_min, cw.ol, cw.cum,
        n_steps=cw.tile_k, bits=8)
    coded = 4 * int(coded_words(sb, ob, cw.sym_plane.shape[0],
                                cw.ofs_plane.shape[0]).sum())
    del sb, ob
    wf = q.to(torch.float32) * scale[None, :]
    rows = []
    for m in ms_:
        if detail:
            exact_matmul_check(name, q, cw, m, g)
        x = torch.randn(m, cw.k, generator=g, device=q.device)
        y = dm.compressed_matmul(x, cw)
        y_plain, plain_ms = timed_call(
            lambda: dm.compressed_matmul_plain(x, cw))
        bound = cw.k * 2.0 ** -24 * (x.abs().double() @ wf.abs().double())
        err = (y.double() - y_plain.double()).abs()
        ratio = f64_err_ratio(y, x, wf)
        if not (bool((err <= bound).all()) and bool(torch.isfinite(y).all())
                and ratio <= F64_ERR_RATIO):
            raise AssertionError(
                f"decompress_matmul {name} [{m}, {cw.k}, {cw.n}]: off by "
                f"{err.max().item():.3g} (bound {bound.min().item():.3g}), "
                f"error against f64 {ratio:.3g}x cuBLAS f32's (limit "
                f"{F64_ERR_RATIO})")
        row = dict(name=name, shape=[m, cw.k, cw.n],
                   ms=graph_ms(lambda: dm.compressed_matmul(x, cw), 20))
        if detail:
            row["eager_ms"] = cuda_ms(lambda: dm.compressed_matmul(x, cw), 20)
            # the kernel up to its staging of the planes: the rest of ms is
            # the decode chain (and, past 8 rows, the tile product)
            row["stage_ms"] = graph_ms(lambda: dm.compressed_matmul(
                x, cw, stage_only=True), 20)
        # the coded words, the stored flags, tables, scales, x and the
        # output, each once
        nb = coded + nbytes(cw.stored, cw.v_min, cw.ol, cw.cum, cw.scale, x,
                            y)
        t_b, t_f = nb / HBM_BYTES_PER_S, 2 * m * cw.k * cw.n / F32_FLOPS
        row.update(
            plain_ms=plain_ms,
            library_ms=graph_ms(lambda: torch.matmul(x, wf), 20),
            bound_ms=max(t_b, t_f) * 1e3,
            bound_by="bytes" if t_b >= t_f else "operations",
            max_abs_err=err.max().item(), f64_err_ratio=ratio,
            payload_bits=cw.payload_bits)
        rows.append(row)
    return cw, rows


def check_decompress_matmul(device, records):
    """The decompress-matmul kernel against its plain version on the card
    (``matmul_rows`` with ``detail``), at M = 4 (a decode step's batch),
    M = 1 and 8 (the ends of the kernel's register path), 9 (the first on
    its shared-memory tile) and 77 (a prefill).  The encode kernel's planes
    for the same streams are held bit-exact against the plain encoder."""
    import torch
    from repro_torch.kernels import apack_encode, decompress_matmul as dm
    g = torch.Generator(device=device).manual_seed(3)
    rows = []
    for name, q, scale in weight_cases(device):
        cw, got = matmul_rows(name, q, scale, (1, 4, 8, 9, 77), g,
                              detail=True)
        sym, ofs, _, _, st = apack_encode.encode_plain(
            dm.tile_streams(q, cw.tile_k), cw.v_min, cw.ol, cw.cum,
            n_steps=cw.tile_k, bits=8)
        if not (torch.equal(sym, cw.sym_plane) and torch.equal(ofs, cw.ofs_plane)
                and torch.equal(st.to(torch.int32), cw.stored)):
            raise AssertionError(f"decompress_matmul {name}: encode kernel "
                                 "planes differ from the plain encoder")
        n_stored = int(st.sum())
        if (name == "stored") != (n_stored == st.numel()):
            raise AssertionError(f"{name}: {n_stored} of {st.numel()} "
                                 "streams stored")
        for row in got:
            row.update(exact_on_integers=True, stored=n_stored)
            print("decompress_matmul: " + json.dumps(row))
        rows += got
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


def with_head(params):
    """``packed_sites`` of a packed tree, and its untied head when that is
    packed, as (None, "head", "unembed", PackedWeight)."""
    from repro_torch.models.modules import PackedWeight
    head = params.get("unembed")
    return packed_sites(params) + ([(None, "head", "unembed", head)]
                                   if isinstance(head, PackedWeight) else [])


def site(params, i, grp, name):
    """The leaf of ``params`` at a site as ``with_head`` names it."""
    return params["unembed"] if i is None else params["blocks"][i][grp][name]


def cut_sites(layers: int) -> set:
    """(layer, group, name) of every site a packed engine may pack in the
    first ``layers`` layers, and the untied head: the sites whose
    originals a packed serve keeps for the checks after it."""
    return {(i, grp, n) for i in range(layers)
            for grp, names in (("inner", ("wq", "wk", "wv", "wo")),
                               ("ffn", ("w_up", "w_gate", "w_down")))
            for n in names} | {(None, "head", "unembed")}


def oracle_stores(packed_params, host_weights):
    """The stores the packed path is checked against, built from a host
    copy of the original weights of every packed site (``with_head``: the
    untied head too), in f32 as ``pack_weights`` reads them: each quantized
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
    for i, grp, name, pw in with_head(packed_params):
        w = host_weights[i, grp, name].to(pw.device).float()
        q, qp = quant.quantize_symmetric(w, axis=-1)
        del w
        wd = quant.dequantize_symmetric(q, qp)
        w2 = wd.reshape(pw.cw.k, pw.cw.n)
        for k, leaf in (("oracle32", OracleWeight(pw, w2, torch.float32)),
                        ("oracle64", OracleWeight(pw, w2, torch.float64)),
                        ("dense", wd.to(torch.bfloat16))):
            if i is None:
                stores[k]["unembed"] = leaf
            else:
                stores[k]["blocks"][i][grp][name] = leaf
    return stores


def serve_full_width(device, *, layers=None, weights=None, kv="apack-int8",
                     fused=True, calib_pages=4, hook=None, params=None,
                     label=None, arch="qwen3-1.7b", max_len=160,
                     requests=None, engine_kw=None, setup=None,
                     keep_sites=None, max_batch=4, allow_failed=False):
    """Serve the 8 requests (``serve_requests``, or ``requests(cfg, rng)``)
    at ``arch``'s published widths and ``layers`` layers (its own depth
    when None), from dense or packed weights (the seed-0 draw, or
    ``params``, named ``label``), through the fused paged KV path,
    the materialize oracle (``fused=False``) or a dense cache (``kv`` of
    "int8"), with the launch counts reset just before the serve and read
    just after.  ``hook(eng, i)``, when given, runs after step ``i``; its
    time is not serving time, its kernel launches (checks) are taken out
    of the counts and its memory out of the peak (``drive`` times the
    steps).  Returns a dict with the summary, the counts, a snapshot of
    the PACKED KV pages, the first step's logits, the engine, the
    requests and (packed weights only) a host copy of the original f32
    weight of every packed site, the untied head included (of
    ``keep_sites``, (layer, group, name) triples as ``with_head`` names
    them, when given), from which the checks after the serve build
    their oracle stores; nothing but the engine is on the card while it
    serves, so ``max_memory_gb`` is the engine's.  ``engine_kw`` adds
    engine options (refresh, pressure, a mesh); ``setup(eng)`` runs once
    the engine is built; ``max_batch`` slots (4); ``allow_failed`` as
    ``drive`` takes it."""
    import dataclasses
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine
    mode = ("fused" if fused else "oracle") if kv == "apack-int8" else kv
    label = label or weights or "dense"
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=layers or cfg.num_layers,
                              kv_cache_dtype=kv)
    layers = cfg.num_layers
    sched = (engine_kw or {}).get("scheduler", "sync")
    mesh = (engine_kw or {}).get("mesh")
    tag = (f"serve[{arch}, {mode} KV, {label} weights, {layers} layers"
           + (f", {sched} scheduler" if sched != "sync" else "")
           + (f", mesh {mesh.shape['data']}x{mesh.shape['model']}"
              if mesh is not None else "") + "]")
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    if params is None:
        params = M.init_params(cfg, gen, device)
    eng = ServeEngine(cfg, params, max_batch=max_batch, max_len=max_len,
                      kv_page_size=16, kv_calib_pages=calib_pages,
                      kv_fused=fused, weights=weights, device=device,
                      **(engine_kw or {}))
    host_weights = {(i, grp, name): site(params, i, grp, name).cpu()
                    for i, grp, name, _ in with_head(eng.params)
                    if keep_sites is None or (i, grp, name) in keep_sites}
    del params
    if setup is not None:
        setup(eng)
    torch.cuda.synchronize()
    print(f"{tag}: d_model {cfg.d_model} built in "
          f"{time.perf_counter() - t0:.1f} s (weight packing "
          f"{eng.weight_pack_s:.1f} s)")
    rng = np.random.default_rng(0)
    reqs = (requests or serve_requests)(cfg, rng)
    seen: dict = {}

    def after(e, i):
        # (an async engine has logits once its first step is collected)
        if "first_logits" not in seen and e.last_logits is not None:
            seen["first_logits"] = e.last_logits.float().cpu()
        if e.paged and "snapshot" not in seen and not e.queue:
            seen["snapshot"] = capture_packed(e)
        if hook is not None:
            hook(e, i)
    repro_torch.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    d = drive(eng, reqs, after, tag, allow_failed)
    launches = {k: v - d["check_launches"][k]
                for k, v in repro_torch.launch_counts().items()}
    snapshot, first_logits = seen.get("snapshot"), seen["first_logits"]
    wall = d["wall_s"]
    gen_tokens = sum(len(r.tokens) for r in reqs)
    path = ["decompress_matmul"] if weights else []
    if eng.paged:
        path += ["apack_decode", "apack_encode",
                 "fused_page_attention" if fused else "gather_decode"]
    if any(launches[k] <= 0 for k in path):
        raise AssertionError(f"{tag}: a kernel was not launched: {launches}")
    if not torch.isfinite(eng.last_logits).all():
        raise AssertionError(f"{tag}: non-finite logits")
    summary = {"layers": layers, "weights": label,
               "kv": mode, "requests": len(reqs),
               "generated_tokens": gen_tokens,
               "wall_s": wall, "tokens_per_s": gen_tokens / wall,
               "steps": eng.stats["steps"],
               "median_step_ms": d["median_step_ms"],
               "max_step_ms": d["max_step_ms"],
               "longest_step": d["longest_step"],
               "first_step_s": d["first_step_s"],
               "weight_pack_s": eng.weight_pack_s, "launches": launches,
               "launches_per_step": {k: v / eng.stats["steps"]
                                     for k, v in launches.items()},
               "check_launches": d["check_launches"],
               "max_memory_gb": d["max_memory_gb"]}
    if eng.paged:
        stats = eng.kv_stats()
        if stats["kv_pages_packed"] <= 0:
            raise AssertionError(f"{tag}: no PACKED pages")
        if not stats["kv_ratio"] or stats["kv_ratio"] >= 1:
            raise AssertionError(f"{tag}: kv_ratio {stats['kv_ratio']} "
                                 "not < 1")
        summary.update({k: stats[k] for k in (
            "kv_ratio", "kv_pages_packed", "kv_pages_high_water",
            "kv_pages_evicted", "kv_streams", "transfers")})
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


# ------------------------------------------------- robustness (slice 9)
# the refresh serve's settings: refresh fires on the every-M-pages trigger
# (32 sealed pages a layer); the regression threshold is set out of reach
# so that the serve's cost of table searches stays bounded
REFRESH_KW = dict(kv_refresh=True, kv_refresh_min_pages=8,
                  kv_repack_budget=32, kv_refresh_every_pages=32,
                  kv_refresh_threshold=1.0)
# the pressure serve: half the pages of 4 slots at full context, 560 at
# page 16 (a request reserves 196-252), a slot deadline of 16 steps
PRESSURE_KW = dict(kv_pressure=True, slot_deadline_steps=16)


def hot_requests(cfg, rng):
    """Phase B of the refresh serve: 8 requests of one hot prompt, a single
    token id repeated 64-96 times, 48 new tokens each (the traffic narrows
    to a hot workload, ``tests/test_table_refresh.py``'s drift)."""
    import numpy as np
    from repro_torch.serve import Request
    tok = int(rng.integers(0, cfg.vocab_size))
    return [Request(100 + i, np.full(int(rng.integers(64, 97)), tok,
                                     np.int64), max_new_tokens=48)
            for i in range(8)]


def drive(eng, reqs, hook=None, tag="drive", allow_failed=False) -> dict:
    """Submit ``reqs`` to ``eng`` and step it until drained, each step timed
    to the card's end (an async engine's step only to its return: the
    step it dispatched is still on the card, and its own collect waits
    for it in the next step); ``hook(eng, i)`` after step ``i``, outside
    the timing, its kernel launches (checks) counted apart and its memory
    left out of the peak; ``allow_failed``: a request may end with an
    error (a fault drill).  Returns the tokens, the wall, median and
    longest step time (step 0 admits and calibrates, so they leave it
    out), the hooks' launches, the peak memory, where the longest step's
    time went (``longest_step``: its index, the host's time to return from
    ``step()``, the process's CPU time over it, all threads, and the
    allocator's retries over the serve, each a cudaFree of the cache and
    a cudaMalloc again) and (paged KV) this serve's KV read ratio, tables
    included (None where no attention layer read a page)."""
    import numpy as np
    import torch
    import repro_torch
    t_kv = dict(eng.kv.traffic) if eng.paged else None
    for r in reqs:
        eng.submit(r)
    checks = dict.fromkeys(repro_torch.launch_counts(), 0)
    peak = 0
    step_s = []
    parts = []
    paused = 0.0
    sync_each = getattr(eng, "scheduler", "sync") == "sync"
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    t0 = time.perf_counter()
    while True:
        ts, cs = time.perf_counter(), time.process_time()
        n = eng.step()
        th = time.perf_counter()
        if sync_each:
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - ts)
        parts.append((th - ts, time.process_time() - cs))
        if n == 0 and not eng.queue:
            break
        if hook is not None:
            tc = time.perf_counter()
            peak = max(peak, torch.cuda.max_memory_allocated())
            before = repro_torch.launch_counts()
            hook(eng, len(step_s) - 1)
            for k, v in repro_torch.launch_counts().items():
                checks[k] += v - before[k]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            paused += time.perf_counter() - tc
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - paused
    if not all(r.done and (len(r.tokens) == r.max_new_tokens
                           or allow_failed and r.error) for r in reqs):
        raise AssertionError(f"{tag}: not every request completed")
    i = int(np.argmax(step_s[1:])) + 1
    out = {"tokens": [r.tokens for r in reqs], "wall_s": wall,
           "longest_step": {
               "index": i, "ms": step_s[i] * 1e3,
               "host_ms": parts[i][0] * 1e3, "cpu_ms": parts[i][1] * 1e3,
               "alloc_retries": torch.cuda.memory_stats().get(
                   "num_alloc_retries", 0) - retries},
           "median_step_ms": float(np.median(step_s[1:]) * 1e3),
           "max_step_ms": float(np.max(step_s[1:]) * 1e3),
           "first_step_s": step_s[0], "check_launches": checks,
           "max_memory_gb": max(peak, torch.cuda.max_memory_allocated())
           / 1e9}
    if eng.paged:
        d = {k: eng.kv.traffic[k] - t_kv[k] for k in t_kv}
        out["kv_ratio"] = ((d["kv_read_bytes"] + d["kv_table_bytes"])
                           / d["kv_raw_bytes"] if d["kv_raw_bytes"] else None)
    return out


def count_repack_launches(rec: dict):
    """``setup(eng)`` for the refresh serve: wrap its cache's
    ``launch_repack`` so that each re-pack batch it queues records the
    launches that kernel 1's and kernel 2's wrappers counted meanwhile, a
    (decode, encode) pair in ``rec["batches"]``."""
    import repro_torch
    kernels = ("apack_decode", "apack_encode")

    def setup(eng):
        launch = eng.kv.launch_repack

        def counted(*a, **k):
            before = repro_torch.launch_counts()
            job = launch(*a, **k)
            after = repro_torch.launch_counts()
            d = tuple(after[n] - before[n] for n in kernels)
            if job is not None:
                rec.setdefault("batches", []).append(d)
            elif any(d):
                raise AssertionError(f"re-pack: launches {d} and no batch")
            return job
        eng.kv.launch_repack = counted
    return setup


def refresh_hook(rec: dict):
    """After each step of the refresh serve: record, for a step that
    re-packed and sealed nothing, its device-to-host calls and its re-pack
    batches (``rec["repack_only_steps"]``); and once, at a step where the
    active requests' PACKED pages span two table generations,
    ``oracle_gates``: ``materialize`` through the gather kernel (per-page
    rows of both generations) bit-exact against the plain decode, and the
    fused attention kernel against f64 dense attention."""
    from repro_torch.models.modules import PAGE_PACKED

    def state(eng):
        kv = eng.kv
        return (kv.transfers["d2h_calls"], len(rec.get("batches", ())),
                kv.traffic["kv_pages_packed"], int(kv.hist_pages.sum()))

    def hook(eng, i):
        cur = state(eng)
        prev = rec.get("prev")
        rec["prev"] = cur
        if prev is not None:
            d2h, batches, packed, hist = (a - b for a, b in zip(cur, prev))
            if batches and not packed and not hist:
                rec.setdefault("repack_only_steps", []).append(
                    (d2h, batches))
        kv = eng.kv
        gens = {int(kv.page_gen[p]) for r in eng.active if r is not None
                for pids in kv.page_tables[r.rid] for p in pids
                if kv.pool.state[p] == PAGE_PACKED}
        if "gates" not in rec and len(gens) >= 2:
            rec["gates"] = oracle_gates(eng, f"PACKED generations "
                                             f"{sorted(gens)}")
            rec["prev"] = state(eng)
    return hook


def refresh_phase(device, frozen: dict, fused_tokens: list) -> dict:
    """(a) qwen3-1.7b at 28 layers with table refresh: phase A the 8
    requests of the fused serve, phase B 8 requests of one hot prompt, on
    one engine (``REFRESH_KW``).  Gates: tokens equal to the frozen
    control's (phase 3's engine, refresh off, extended by phase B); refresh
    fired and re-packed (``generation`` >= 1); each re-pack batch launched
    kernels 1 and 2 once each, as their wrappers counted them
    (``count_repack_launches``); a step that re-packed and sealed nothing
    in one batch made one device-to-host call, and one that took more
    batches (a page queued twice ends a batch) one call a batch, counted
    and printed apart; ``refresh_hook``'s oracle gates.  Prints the
    phase-B KV ratio against the frozen one's and both engines' median
    step.  Returns the re-pack launches a step of kernels 1 and 2."""
    import numpy as np
    rec: dict = {}
    run = serve_full_width(device, layers=28, engine_kw=REFRESH_KW,
                           setup=count_repack_launches(rec),
                           hook=refresh_hook(rec), label="dense, refresh")
    eng = run["eng"]
    if [r.tokens for r in run["reqs"]] != fused_tokens:
        raise AssertionError("refresh serve phase A: tokens differ from the "
                             "frozen fused serve")
    b = drive(eng, hot_requests(run["cfg"], np.random.default_rng(5)),
              refresh_hook(rec), "refresh serve phase B")
    if b["tokens"] != frozen["tokens"]:
        raise AssertionError("refresh serve phase B: tokens differ from the "
                             "frozen control")
    st, kv = eng.stats, eng.kv
    batches = rec.get("batches", [])
    steps = rec.get("repack_only_steps", [])
    one = [d for d, n in steps if n == 1]
    more = [(d, n) for d, n in steps if n > 1]
    per_step = {k: sum(bt[i] for bt in batches) / st["steps"]
                for i, k in enumerate(("apack_decode", "apack_encode"))}
    res = {"settings": REFRESH_KW, "kv_refreshes": st["kv_refreshes"],
           "kv_pages_repacked": st["kv_pages_repacked"],
           "generation": kv.generation, "gen_rows": kv.gen_rows,
           "kv_repack": eng.kv_stats()["kv_repack"],
           "repack_batches": len(batches),
           "repack_batch_launches": sorted(set(batches)),
           "repack_launches_per_step": per_step, "steps": st["steps"],
           "repack_only_steps": len(steps),
           "one_batch_steps_d2h": sorted(set(one)),
           "multi_batch_steps": len(more),
           "multi_batch_steps_d2h_batches": more,
           "phase_b_kv_ratio": {"refresh": b["kv_ratio"],
                                "frozen": frozen["kv_ratio"]},
           "median_step_ms": {
               "refresh": {"A": run["summary"]["median_step_ms"],
                           "B": b["median_step_ms"]},
               "frozen": {"A": frozen["a_median_step_ms"],
                          "B": frozen["median_step_ms"]}},
           "oracle_gates": rec.get("gates")}
    print("refresh serve [qwen3-1.7b, 28 layers]: " + json.dumps(res))
    if not (st["kv_refreshes"] > 0 and st["kv_pages_repacked"] > 0
            and kv.generation >= 1):
        raise AssertionError("refresh serve: no refresh or re-pack")
    if not batches or set(batches) != {(1, 1)}:
        raise AssertionError(f"refresh serve: re-pack batches launched "
                             f"{sorted(set(batches))} (decode, encode), "
                             "expected one of each")
    if "gates" not in rec:
        raise AssertionError("refresh serve: PACKED pages of two "
                             "generations never coexisted")
    if not one or set(one) != {1}:
        raise AssertionError(f"refresh serve: one-batch re-pack-only steps "
                             f"made {sorted(set(one))} d2h calls, expected 1")
    if any(d != n for d, n in more):
        raise AssertionError(f"refresh serve: multi-batch re-pack-only steps "
                             f"(d2h, batches) {more[:8]}: expected one pull "
                             "a batch")
    return per_step


def pressure_phase(device, fused_tokens: list, layers: int = 28) -> None:
    """(b) qwen3-1.7b at 28 layers under pool pressure: 560 pages (half of
    4 slots at full context), so two requests fit at once,
    ``kv_pressure`` and a 16-step slot deadline: requests rotate through
    the host spill tier.  Gates: tokens equal to phase 3's (the
    uncontended control), pages spilled, every one read back, none
    quarantined, no request failed, the pool free at the end.  Prints the
    spill ratio and the spill and readahead seconds."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import PagedKVCache
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=layers)
    pages = 4 * PagedKVCache.pages_for_config(cfg, 160, 16) // 2
    timing = {"spill_s": 0.0, "readahead_s": 0.0}

    def timed(fn, key):
        def f(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            timing[key] += time.perf_counter() - t0
            return out
        return f

    def setup(eng):
        eng.kv.spill_request = timed(eng.kv.spill_request, "spill_s")
        eng.kv.unspill_request = timed(eng.kv.unspill_request,
                                       "readahead_s")

    run = serve_full_width(device, layers=layers, setup=setup,
                           engine_kw=dict(kv_pages=pages, **PRESSURE_KW),
                           label="dense, pressure")
    eng = run["eng"]
    ks, st = eng.kv_stats(), eng.stats
    sp = ks["kv_spill"]
    res = {"kv_pages": pages, **PRESSURE_KW,
           **{k: st[k] for k in ("preempted", "resumed", "spilled_requests",
                                 "pressure_preempted", "deadline_preempted",
                                 "failed", "kv_admission_blocked")},
           "kv_pages_spilled": ks["kv_pages_spilled"],
           "kv_pages_unspilled": ks["kv_pages_unspilled"],
           "spill": sp, **timing,
           "median_step_ms": run["summary"]["median_step_ms"],
           "tokens_per_s": run["summary"]["tokens_per_s"]}
    print("pressure serve [qwen3-1.7b, 28 layers]: " + json.dumps(res))
    if [r.tokens for r in run["reqs"]] != fused_tokens:
        raise AssertionError("pressure serve: tokens differ from the "
                             "uncontended fused serve")
    if not (sp["pages"] > 0 and sp["readahead_pages"] == sp["pages"]
            and sp["quarantined"] == 0 and st["failed"] == 0
            and eng.kv.pool.free_count == eng.kv.pool.num_pages):
        raise AssertionError("pressure serve: spill/readahead gates failed")


ROBUSTNESS_RUNS = ("refresh two-phase", "pressure", "fault")


def _on(base, dev):
    """A copy of a CPU param tree (dicts, lists, tensors) on ``dev``."""
    if isinstance(base, dict):
        return {k: _on(v, dev) for k, v in base.items()}
    if isinstance(base, list):
        return [_on(v, dev) for v in base]
    return base.to(dev)


def robustness_run(name: str, dev) -> dict:
    """One (d) serve, SMOKE qwen3-1.7b on ``dev``: the two-phase refresh
    serve (``tests/test_torch_refresh_engine.py``'s workload, 12 new
    tokens a request), the pressure rotation through an undersized pool,
    or a fault run where one flipped bit of a spilled record fails only
    its owner (the other request's tokens equal its control's, on the same
    device).  Returns the tokens, errors, counters and KV stats that the
    card must give as the CPU does."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import PagedKVCache, init_params
    from repro_torch.serve import FaultInjector, Request, ServeEngine
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              kv_cache_dtype="apack-int8")
    base = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    per_req = PagedKVCache.pages_for_config(cfg, 12, 4)

    def two_phase():
        eng = ServeEngine(cfg, _on(base, dev), device=dev, max_batch=4,
                          max_len=96, kv_page_size=4, kv_calib_pages=1,
                          kv_refresh=True, kv_refresh_every_pages=16,
                          kv_refresh_min_pages=8, kv_repack_budget=32)
        rng = np.random.default_rng(11)
        phases = ([rng.integers(0, cfg.vocab_size, 9) for _ in range(4)],
                  [np.full(9, 7) for _ in range(4)])
        reqs = []
        for p, prompts in enumerate(phases):
            batch = [Request(100 * p + i, x, max_new_tokens=12)
                     for i, x in enumerate(prompts)]
            for r in batch:
                eng.submit(r)
            eng.run_until_drained()
            reqs += batch
        return eng, reqs

    def pressure():
        eng = ServeEngine(cfg, _on(base, dev), device=dev, max_batch=3,
                          max_len=16, kv_page_size=4, kv_calib_pages=2,
                          kv_pages=max(per_req, 3 * per_req // 2),
                          kv_pressure=True, slot_deadline_steps=4)
        rng = np.random.default_rng(11)
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, 8),
                        max_new_tokens=4) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained(max_steps=400)
        return eng, reqs

    def fault(corrupt=True):
        eng = ServeEngine(cfg, _on(base, dev), device=dev, max_batch=2,
                          max_len=40, kv_page_size=4, kv_calib_pages=2)
        rng = np.random.default_rng(9)
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, 8),
                        max_new_tokens=8) for i in range(2)]
        for r in reqs:
            eng.submit(r)
        for _ in range(4):
            eng.step()
        eng.preempt(0, spill=True)
        if corrupt:
            handle = next(-e - 1 for pids in eng.kv.page_tables[0]
                          for e in pids if e < 0)
            FaultInjector().flip_bit(eng.kv.spill_tier, handle)
        eng.run_until_drained(max_steps=200)
        return eng, reqs

    keys = ("kv_refreshes", "kv_pages_repacked", "spilled_requests",
            "preempted", "resumed", "failed", "pressure_preempted",
            "deadline_preempted")
    eng, reqs = {"refresh two-phase": two_phase, "pressure": pressure,
                 "fault": fault}[name]()
    ks = eng.kv_stats()
    out = {"tokens": [r.tokens for r in reqs],
           "errors": [r.error for r in reqs],
           "stats": {k: eng.stats[k] for k in keys},
           "generation": eng.kv.generation,
           **{k: ks[k] for k in ("kv_ratio", "kv_repack", "kv_spill",
                                 "kv_pages_evicted", "kv_pages_spilled",
                                 "kv_pages_unspilled")}}
    if name == "fault":
        ctrl = fault(corrupt=False)[1]
        out["fault_only_owner"] = bool(
            reqs[0].error and "checksum" in reqs[0].error
            and reqs[1].error is None and reqs[1].tokens == ctrl[1].tokens)
    return out


def smoke_robustness_vs_cpu(device, twins: dict) -> None:
    """(d) SMOKE qwen3-1.7b robustness engines (``robustness_run``) on the
    card against the same engines on the CPU (``twins``, from the
    background process): tokens, ``kv_ratio`` and the refresh, spill and
    eviction counters must be equal, and the fault run must fail only the
    owner of the flipped record on each device."""
    for name in ROBUSTNESS_RUNS:
        out = {"cpu": twins[("robust", name)],
               device: robustness_run(name, device)}
        same = out["cpu"] == out[device]
        c = out[device]
        print(f"smoke robustness [{name}] card vs cpu: equal {same}; "
              + json.dumps({k: c[k] for k in ("stats", "generation",
                                              "kv_ratio", "kv_repack",
                                              "kv_spill")}))
        if name == "fault" and not c["fault_only_owner"]:
            raise AssertionError("SMOKE fault run on the card: the flip did "
                                 "not fail only its owner")
        if not same:
            raise AssertionError(f"SMOKE {name} on the card disagrees with "
                                 "the CPU")
        if name == "refresh two-phase" and not (
                c["generation"] >= 1 and c["stats"]["kv_pages_repacked"] > 0):
            raise AssertionError("SMOKE refresh serve: no refresh")
        if name == "pressure" and not c["kv_spill"]["pages"] > 0:
            raise AssertionError("SMOKE pressure serve: nothing spilled")


# the async SMOKE serves of phase 10 and (d): chunks of 3 tokens, a
# preempt with spill after 3 decode steps, table refresh every 4 sealed
# pages a layer, and the third request with a 1 ms SLO
ASYNC_SMOKE_ARCHS = ("qwen3-1.7b", "hetero-serve-smoke")
ASYNC_SMOKE_KEYS = ("steps", "generated", "completed", "preempted",
                    "resumed", "spilled_requests", "prefill_chunks",
                    "staged_readahead", "kv_refreshes", "kv_pages_repacked")


def async_smoke_run(arch: str, dev) -> dict:
    """The async engine at SMOKE width on ``dev`` (``ASYNC_SMOKE_ARCHS``):
    4 requests (11, 9, 20 and 6 tokens, 8 new each) through 2 slots with
    ``prefill_chunk_tokens=3``, ``kv_refresh`` and slot 0 preempted with
    spill after 3 decode steps; the third request carries a 1 ms SLO.
    Also the sync engine on the same requests, uninterrupted, whose tokens
    the async ones must equal.  Returns the tokens, admission order,
    counters, generation and KV stats."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import Request, ServeEngine
    cfg = dataclasses.replace(get_smoke_config(arch),
                              kv_cache_dtype="apack-int8")
    base = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def serve(scheduler):
        eng = ServeEngine(cfg, _on(base, dev), device=dev, max_batch=2,
                          max_len=48, kv_page_size=4, kv_calib_pages=2,
                          scheduler=scheduler, prefill_chunk_tokens=3,
                          kv_refresh=True, kv_refresh_every_pages=4,
                          kv_refresh_min_pages=2, kv_repack_budget=8)
        rng = np.random.default_rng(3)
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, n),
                        max_new_tokens=8, slo_ms=1.0 if i == 2 else None)
                for i, n in enumerate((11, 9, 20, 6))]
        for r in reqs:
            eng.submit(r)
        if scheduler == "async":
            while eng.stats["steps"] < 3:
                eng.step()
            eng.preempt(0, spill=True, requeue="tail")
        eng.run_until_drained(max_steps=400)
        return eng, reqs
    eng, reqs = serve("async")
    ks = eng.kv_stats()
    seng, sreqs = serve("sync")
    return {"tokens": [r.tokens for r in reqs],
            "sync_tokens": [r.tokens for r in sreqs],
            "sync_kv": {k: seng.kv_stats()[k] for k in ("kv_ratio",
                                                        "kv_repack")},
            "order": [r.rid for r in sorted(reqs, key=lambda r: r.t_admit)],
            "stats": {k: eng.stats[k] for k in ASYNC_SMOKE_KEYS},
            "generation": eng.kv.generation,
            **{k: ks[k] for k in ("kv_ratio", "kv_repack", "kv_spill",
                                  "kv_pages_evicted", "kv_pages_packed")}}


def async_smoke_vs_cpu(device, twins: dict, arch: str) -> None:
    """An async SMOKE serve (``async_smoke_run``) on the card against the
    CPU's: tokens, admission order and the chunk, readahead, refresh and
    spill counters equal; ``kv_ratio`` and the re-pack bytes equal too
    unless the sync engine's, on the same requests, already differ
    between the card and the CPU (a recurrent layer's ``exp`` or
    ``sigmoid`` rounds its last f32 bit differently on the card, which
    can move one int8 KV value: ``benchmarks/torch_rg_smoke_bisect.py``),
    and then both are printed; on each device the async tokens equal the
    sync engine's, the SLO request is admitted first, and chunks,
    readahead, a refresh and a spill happened."""
    out = {"cpu": twins[("async", arch)],
           device: async_smoke_run(arch, device)}
    c, h = out[device], out["cpu"]
    kv_keys = ("kv_ratio", "kv_repack")
    sync_kv_same = c["sync_kv"] == h["sync_kv"]
    same = ({k: v for k, v in c.items() if k not in kv_keys + ("sync_kv",)}
            == {k: v for k, v in h.items() if k not in kv_keys
                + ("sync_kv",)})
    same_kv = all(c[k] == h[k] for k in kv_keys)
    print(f"smoke async [{arch}] card vs cpu: tokens, order and counters "
          f"equal {same}, KV equal {same_kv} (sync engine's KV equal "
          f"{sync_kv_same}); "
          + json.dumps({k: c[k] for k in ("order", "stats", "generation",
                                          "kv_ratio", "kv_pages_evicted")})
          + ("" if same_kv else " cpu: " + json.dumps(
              {k: h[k] for k in kv_keys + ("sync_kv",)}) + " card: "
              + json.dumps({k: c[k] for k in kv_keys + ("sync_kv",)})))
    for dev, o in out.items():
        st = o["stats"]
        if o["tokens"] != o["sync_tokens"]:
            raise AssertionError(f"SMOKE async [{arch}] on {dev}: tokens "
                                 "differ from the sync engine's")
        if o["order"][0] != 2 or not (
                st["prefill_chunks"] > 0 and st["staged_readahead"] >= 1
                and st["kv_refreshes"] > 0 and st["spilled_requests"] >= 1):
            raise AssertionError(f"SMOKE async [{arch}] on {dev}: no SLO "
                                 "admission, chunk, readahead, refresh or "
                                 f"spill: {o['order']} {st}")
    if not same or (sync_kv_same and not same_kv):
        raise AssertionError(f"SMOKE async [{arch}] on the card disagrees "
                             "with the CPU")


def check_packed_sites(eng, weight_of, tag, sites=None):
    """Each packed site (``sites``, by default ``packed_sites`` of the
    engine's params) of the served model for which
    ``weight_of(layer, group, name, packed)`` gives a weight (the f32
    dequantized weight on the card, else None), through the kernel,
    against one f32 product on that weight, at M = 4 and a prefill M (77):
    within the K-term f32 rounding bound of ``matmul_rows``, and with an
    error against the f64 product at most ``F64_ERR_RATIO`` times cuBLAS
    f32's.  Returns the sites checked."""
    import torch
    g = torch.Generator(device=eng.device).manual_seed(4)
    worst = worst_ratio = 0.0
    checked = []
    for i, grp, name, pw in (packed_sites(eng.params) if sites is None
                             else sites):
        w = weight_of(i, grp, name, pw)
        if w is None:
            continue
        for m in (4, 77):
            x = torch.randn(m, pw.cw.k, generator=g, device=w.device)
            y = pw.matmul(x)
            err = (y.double() - (x @ w).double()).abs()
            bound = pw.cw.k * 2.0 ** -24 * (x.abs().double()
                                            @ w.abs().double())
            ratio = f64_err_ratio(y, x, w)
            if not bool((err <= bound).all()) or not ratio <= F64_ERR_RATIO:
                raise AssertionError(
                    f"{tag}: packed {name} layer {i} M={m}: off by "
                    f"{err.max()}, {ratio:.3g}x cuBLAS f32's error against "
                    "f64")
            worst = max(worst, (err / bound).max().item())
            worst_ratio = max(worst_ratio, ratio)
        checked.append(name if i is None else f"{i}/{grp}/{name}")
    print(f"{tag} packed sites {checked}: M = 4 and 77 within the f32 bound"
          f" (worst {worst:.3g} of it); error against f64 at most "
          f"{worst_ratio:.3g}x cuBLAS f32's (limit {F64_ERR_RATIO})")
    return checked


def teacher_forced(run, stores, layers=None):
    """Re-score the packed engine's sequences teacher-forced, one forward
    per store, as the JAX package scores packed-weight parity
    (``tests/test_packed_weights.py::_parity``), over the positions that
    predicted generated tokens; through the first ``layers`` layers of
    every store when given (the stores may hold only those) and its head.
    The stores: ``packed`` (the engine's, the kernel),
    ``oracle32``/``oracle64`` and ``dense`` (``oracle_stores``).

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
    import dataclasses
    import torch
    from repro_torch.models import model as M
    cfg, eng = run["cfg"], run["eng"]
    stores = {"packed": eng.params, **stores}
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        stores = {k: {**p, "blocks": p["blocks"][:layers]}
                  for k, p in stores.items()}
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
        {"layers": cfg.num_layers, "positions": total, "agreement": rates,
         "rms_logit_diff": rms,
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


SYNC_STEPS = 18      # (q): a window long enough to hold a seal batch


def analyzer_run() -> dict:
    """``python -m repro_torch.analysis --json`` over the checkout, in a
    process of its own (the analyzer imports neither torch nor the code it
    reads); raises unless it exits 0.  Returns its JSON report."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--json"], cwd=HERE, env=env, capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"analyzer exit {out.returncode}: "
                             f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
    rep = json.loads(out.stdout)
    rep["seconds"] = time.perf_counter() - t0
    return rep


def sync_count_phase(eng, cfg, rng) -> dict:
    """(q): the analyzer, then the syncs the card reports over a window of
    ``SYNC_STEPS`` steady decode steps of a fresh batch of 4 (phase 3's
    engine, tables calibrated; prompts of 80 tokens, so each request seals
    its sixth page inside the window), under
    ``torch.cuda.set_sync_debug_mode("warn")``.  Each warning's site is
    the innermost frame of its stack in ``src/repro_torch``; every site
    must lie on a finding the boundary pass sanctions (one its
    suppression took).  Prints the counts and returns them."""
    import traceback
    import warnings
    import torch
    from repro_torch.serve import Request
    rep = analyzer_run()
    passes = list(rep["pass_seconds"])
    sanctioned_by = dict.fromkeys(passes, 0)
    for f in rep["sanctioned"]:
        sanctioned_by[f["pass_id"]] += 1
    print("analyzer (q): " + json.dumps({
        "exit": 0, "findings": {p: rep["counts"].get(p, 0) for p in passes},
        "new": len(rep["new"]), "suppressions": rep["suppressions"],
        "sanctioned": sanctioned_by, "seconds": round(rep["seconds"], 2)}))
    sanctioned = [(f["path"], f["line"], f["end_line"], f["code"])
                  for f in rep["sanctioned"] if f["pass_id"] == "boundary"]
    root = os.path.join(HERE, "src", "repro_torch") + os.sep
    for i in range(4):
        eng.submit(Request(200 + i, rng.integers(0, cfg.vocab_size, 80),
                           max_new_tokens=SYNC_STEPS + 6))
    for _ in range(3):                      # admit + warm
        eng.step()
    torch.cuda.synchronize()
    kv = eng.kv
    before = (dict(kv.traffic), dict(kv.transfers), dict(eng.stats))
    sites: list = []
    stacks: dict = {}           # each site's first stack, innermost last

    def seen(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        site = None
        stack = traceback.extract_stack()[:-1]
        for fr in reversed(stack):
            if fr.filename.startswith(root):
                site = (fr.filename[len(root):].replace(os.sep, "/"),
                        fr.lineno)
                break
        sites.append(site)
        stacks.setdefault(site, [f"{os.path.basename(fr.filename)}:"
                                 f"{fr.lineno} {fr.name}"
                                 for fr in stack[-4:]])
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(SYNC_STEPS):
                eng.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    after = (kv.traffic, kv.transfers, eng.stats)
    events = {
        "pages_sealed_and_packed": after[0]["kv_pages_packed"]
        - before[0]["kv_pages_packed"],
        "pages_repacked": after[0]["kv_repack_pages"]
        - before[0]["kv_repack_pages"],
        "d2h_calls": after[1]["d2h_calls"] - before[1]["d2h_calls"],
        "steps": after[2]["steps"] - before[2]["steps"],
        "completed": after[2]["completed"] - before[2]["completed"]}
    def name(site):
        return "outside src/repro_torch" if site is None \
            else f"{site[0]}:{site[1]}"

    def known(site):
        return site is not None and any(p == site[0] and lo <= site[1] <= hi
                                        for p, lo, hi, _ in sanctioned)
    counts: dict = {}
    for site in sites:
        counts[name(site)] = counts.get(name(site), 0) + 1
    unknown = sorted({name(x) for x in sites if not known(x)})
    # from the code: the step's token pull, and one pull a seal batch
    # (``_fetch``, the transfers' d2h calls)
    out = {"steps": SYNC_STEPS, "syncs": len(sites),
           "syncs_per_step": len(sites) / SYNC_STEPS,
           "expected_syncs": SYNC_STEPS + events["d2h_calls"],
           "sites": counts, "events": events, "unsanctioned": unknown,
           "stacks": {name(k): v for k, v in stacks.items()}}
    print("syncs (q): " + json.dumps(out))
    eng.run_until_drained()
    if unknown:
        raise AssertionError(f"(q): the card reports syncs at sites the "
                             f"boundary pass does not sanction: {unknown}")
    return out


def profile_steady_steps(eng, cfg, rng, tag, prompt_len=80, n=4,
                         drain=True):
    """Where a steady decode step's time goes: torch.profiler over ten
    steps of a fresh full batch of ``n`` requests (tables already
    calibrated; prompts of ``prompt_len`` tokens), device time by kernel
    name (the top twelve and every kernel of the port), the device's idle
    share of the window and the fused attention kernel's launches a step;
    then the requests finish (``drain``), for an engine that serves on.
    Returns the window's wall and busy ms a step and its idle share."""
    import numpy as np
    import torch
    from repro_torch.serve import Request
    for i in range(n):
        eng.submit(Request(100 + i, rng.integers(0, cfg.vocab_size,
                                                 prompt_len),
                           max_new_tokens=24))
    for _ in range(3):                      # admit + warm
        eng.step()
    out = profile_window(eng.step, 10, tag, top=12, also=PORT_KERNELS)
    attn = sum(r[2] for r in out.pop("rows")
               if "fused_page_attention_kernel" in r[1]) / 10
    print(f"profile {tag}: fused attention launches a step {attn}")
    if drain:
        eng.run_until_drained()
    return out


# ---------------------------------------------------- async (slice 10)
ASYNC_KW = {"scheduler": "async"}


def async_gates(rec: dict):
    """``setup(eng)`` for an async serve.  ``_overlap_host_work`` (while a
    step is in flight), ``_dispatch`` and ``_start_pump`` run under
    ``torch.cuda.set_sync_debug_mode("error")``: any stream or device
    synchronize in them, a blocking copy or a read of a device value,
    raises and fails the run.  Each steady step (one in flight when it
    starts) records its device-to-host calls (``kv.transfers``) and those
    its page events made (seal batches; a re-pack past its first batch):
    ``rec["steady"]``, (calls, page-event calls) a step; and the host
    seconds of its window, collect (the wait for the step in flight
    included) and dispatch: ``rec["phase_s"]``."""
    import torch
    rec.setdefault("steady", [])
    rec["page_pulls"] = 0
    rec["phase_s"] = {"window": [], "collect": [], "dispatch": []}

    def setup(eng):
        kv = eng.kv

        def gated(fn, flying_only):
            def f(*a, **k):
                on = not flying_only or eng._inflight is not None
                if on:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    return fn(*a, **k)
                finally:
                    if on:
                        torch.cuda.set_sync_debug_mode("default")
            return f
        def timed(fn, phase):
            def f(*a, **k):
                flying = eng._inflight is not None
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    if flying or phase == "dispatch":
                        rec["phase_s"][phase].append(time.perf_counter()
                                                     - t0)
            return f
        eng._overlap_host_work = timed(gated(eng._overlap_host_work, True),
                                       "window")
        eng._dispatch = timed(gated(eng._dispatch, False), "dispatch")
        eng._start_pump = gated(eng._start_pump, False)
        eng._collect = timed(eng._collect, "collect")

        def page_event(fn):
            def f(*a, **k):
                d0 = kv.transfers["d2h_calls"]
                try:
                    return fn(*a, **k)
                finally:
                    rec["page_pulls"] += kv.transfers["d2h_calls"] - d0
            return f
        kv._seal = page_event(kv._seal)
        kv.repack_pending = page_event(kv.repack_pending)
        step = eng.step

        def counted_step():
            steady = eng._inflight is not None
            d0, p0 = kv.transfers["d2h_calls"], rec["page_pulls"]
            n = step()
            if steady:
                rec["steady"].append((kv.transfers["d2h_calls"] - d0,
                                      rec["page_pulls"] - p0))
            return n
        eng.step = counted_step
    return setup


def host_parts(rec: dict, then=None):
    """``setup(eng)``: time the host part of every call to the engine's
    fused step launch (``_launch_fused``: step meta, the model's launches,
    the append) and to the cache's ``step_meta``, ``claim_append_targets``
    and ``note_appended`` (seals included), for both schedulers alike;
    ``rec["host_s"]`` lists the seconds of each.  ``then(eng)`` runs after
    (another setup)."""
    names = (("eng", "_launch_fused"), ("kv", "step_meta"),
             ("kv", "claim_append_targets"), ("kv", "note_appended"))

    def setup(eng):
        rec["host_s"] = {n: [] for _, n in names}
        for owner, name in names:
            obj = eng if owner == "eng" else eng.kv
            fn = getattr(obj, name)

            def f(*a, _fn=fn, _n=name, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    rec["host_s"][_n].append(time.perf_counter() - t0)
            setattr(obj, name, f)
        if then is not None:
            then(eng)
    return setup


def host_medians(rec: dict) -> dict:
    """Median ms and calls of each ``host_parts`` entry."""
    import numpy as np
    return {k: {"median_ms": float(np.median(v) * 1e3), "calls": len(v)}
            for k, v in rec.get("host_s", {}).items() if v}


def host_alloc_stats() -> dict:
    """The pinned host allocator's counters (``torch.cuda.
    host_memory_stats``): allocations made through ``cudaHostAlloc``, frees
    and bytes in use."""
    import torch
    st = torch.cuda.host_memory_stats()
    return {k: st.get(k) for k in ("num_host_alloc", "num_host_free",
                                   "allocated_bytes.current")}


def async_preempt_hook(eng, i):
    """Preempt slot 0 with spill after ten decode steps, to the queue's
    head: the async engine lands its step in flight first, and the next
    step's window stages the spilled pages' readahead (the head of the
    queue claims the free headroom first), before admission resumes it."""
    if i == 9:
        eng.preempt(0, spill=True, requeue="head")


def check_async(run: dict, rec: dict, tokens: list, tag: str) -> dict:
    """The gates of an async serve against its sync control: tokens equal
    the control's, chunks went in, and every steady step made one
    device-to-host call (its collect) besides its page events.  Returns
    the facts printed."""
    eng = run["eng"]
    st = eng.stats
    extra = sorted({d - pe for d, pe in rec["steady"]})
    import numpy as np
    res = {"prefill_chunks": st["prefill_chunks"],
           "staged_readahead": st["staged_readahead"],
           "median_phase_ms": {k: float(np.median(v) * 1e3) if v else None
                               for k, v in rec["phase_s"].items()},
           "preempted": st["preempted"], "resumed": st["resumed"],
           "spilled_requests": st["spilled_requests"],
           "steady_steps": len(rec["steady"]),
           "steady_d2h_besides_page_events": extra,
           "steady_steps_with_page_events": sum(
               pe > 0 for _, pe in rec["steady"]),
           "chunk_tokens": eng.prefill_chunk_tokens}
    if [r.tokens for r in run["reqs"]] != tokens:
        raise AssertionError(f"{tag}: tokens differ from the sync serve's")
    if not rec["steady"] or extra != [1]:
        raise AssertionError(f"{tag}: steady steps made {extra} "
                             "device-to-host calls besides their page "
                             "events, expected 1")
    return res


# --------------------------------------------------- the mesh (slice 13)
MESH_STEADY_MIN = 10        # seal-free steps (l) must see, at least


def mesh_hook(rec: dict):
    """``hook(eng, i)`` for (l): each step's ``.cpu()`` calls (counted by
    the wrapper that ``mesh_phase`` installs), accounted device-to-host
    pulls (seal batches) and kernel 3 launches; at steps 3 and 30 every
    active request's pages must lie in its slot's data-shard range."""
    import repro_torch

    def hook(eng, i):
        kv = eng.kv
        now = (rec["cpu_calls"], kv.transfers["d2h_calls"],
               repro_torch.launch_counts()["fused_page_attention"])
        if "last" in rec:
            rec["steps"].append(tuple(a - b for a, b in
                                      zip(now, rec["last"])) + (i,))
        rec["last"] = now
        if i in (3, 30):
            pps = kv.pool.pages_per_shard
            spb = eng.max_batch // eng._n_data
            for slot, r in enumerate(eng.active):
                if r is None:
                    continue
                bad = [p for pids in kv.page_tables[r.rid] for p in pids
                       if p // pps != slot // spb]
                if bad:
                    raise AssertionError(
                        f"mesh serve: request {r.rid} in slot {slot} holds "
                        f"pages {bad[:4]} outside data shard {slot // spb}")
            rec["range_checked"].append(i)
    return hook


def mesh_phase(device, fused_tokens: list, sync_run: dict) -> dict:
    """(l) the mesh serve: qwen3-1.7b at published widths and depth (28
    layers, phase 3's seed-0 weights) on ``make_debug_mesh(2, 2)``, every
    shard on the one card, ``max_batch=8`` (each data shard decodes 4
    rows, as phase 3's engine does: a cuBLAS GEMM may pick another
    algorithm at another M), phase 3's 8 requests.  Gates: tokens equal
    phase 3's; at steps 3 and 30 every request's pages in its slot's
    data-shard range; after the drain every shard's free list whole; every
    step without a seal pull reads back one ``.cpu()`` (its tokens), as
    the single-device step; kernel 3 launched 28 x 2 x 2 times a step.
    Printed: both serves' ``kv_ratio``, median and longest step (no
    profiler window: the script's time, PERF.md §5 keeps the last)."""
    import torch
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(2, 2, device=device)
    print(f"serving mesh: {mesh.shape} over {mesh.size} devices "
          f"({mesh.describe()})")
    rec = {"cpu_calls": 0, "steps": [], "range_checked": []}
    orig = torch.Tensor.cpu

    def counting(self, *a, **k):
        rec["cpu_calls"] += 1
        return orig(self, *a, **k)
    torch.Tensor.cpu = counting
    try:
        run = serve_full_width(device, layers=28, max_batch=8,
                               engine_kw={"mesh": mesh},
                               hook=mesh_hook(rec))
    finally:
        torch.Tensor.cpu = orig
    eng, cfg = run["eng"], run["cfg"]
    tokens = [r.tokens for r in run["reqs"]]
    if tokens != fused_tokens:
        raise AssertionError("mesh serve: tokens differ from phase 3's "
                             f"({token_agreement(tokens, fused_tokens):.4f} "
                             "agree)")
    pool = eng.kv.pool
    free = [pool.free_count_shard(s) for s in range(pool.n_shards)]
    if free != [pool.pages_per_shard] * pool.n_shards:
        raise AssertionError(f"mesh serve: free lists {free} not whole")
    if rec["range_checked"] != [3, 30]:
        raise AssertionError("mesh serve: the page-range check ran at "
                             f"{rec['range_checked']}")
    want_k3 = cfg.num_layers * 2 * 2
    k3 = sorted({s[2] for s in rec["steps"]})
    steady = [s for s in rec["steps"] if s[1] == 0]
    if k3 != [want_k3]:
        raise AssertionError(f"mesh serve: kernel 3 launches a step {k3}, "
                             f"not {want_k3}")
    if len(steady) < MESH_STEADY_MIN or any(s[0] != 1 for s in steady):
        raise AssertionError("mesh serve: a step without seals read back "
                             f"{sorted({s[0] for s in steady})} times "
                             f"({len(steady)} such steps)")
    summary = run["summary"]
    out = {"tokens_equal_phase_3": True, "free_lists_whole": free,
           "kernel_3_launches_per_step": want_k3,
           "seal_free_steps": len(steady),
           "pulls_per_seal_free_step": 1,
           "kv_ratio": summary["kv_ratio"],
           "phase_3_kv_ratio": sync_run["kv_ratio"],
           "median_step_ms": summary["median_step_ms"],
           "max_step_ms": summary["max_step_ms"],
           "phase_3_median_step_ms": sync_run["median_step_ms"],
           "phase_3_max_step_ms": sync_run["max_step_ms"],
           "launches_per_step": summary["launches_per_step"]}
    print("mesh serve (l) [qwen3-1.7b, 28 layers, 2x2] vs phase 3: "
          + json.dumps(out))
    return out


def packed_mesh_phase(device) -> dict:
    """(m) the packed mesh check: qwen3-1.7b at published widths, its first
    ``CUT_LAYERS`` layers, from packed weights on ``make_debug_mesh(1,
    2)``: every packed site K-split (``ShardedPackedWeight``, kernel 5 a
    model shard on its K half, the halves summed), phase 3's requests at
    phase 3's batch.  Gate: phase 4's, the teacher-forced RMS logit drift
    against the f64 oracle at most ``RMS_DRIFT_RATIO`` times f32's
    (``teacher_forced`` over ``oracle_stores``).  Printed: the largest
    logit difference against the single-device packed store on the same
    sequences, and kernel 5's launches a step."""
    import dataclasses
    import torch
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.models import modules as mm
    run = serve_full_width(device, layers=CUT_LAYERS, weights="apack-int8",
                           engine_kw={"mesh": make_debug_mesh(1, 2,
                                                              device=device)})
    eng = run["eng"]
    sites = [pw for *_, pw in with_head(eng.params)]
    if not sites or not all(isinstance(pw, mm.ShardedPackedWeight)
                            for pw in sites):
        raise AssertionError("packed mesh: a packed site is not K-split")
    stores = oracle_stores(eng.params, run.pop("host_weights"))
    rates = teacher_forced(run, stores, layers=CUT_LAYERS)
    del stores
    # the single-device store: each site's whole weight (its K halves'
    # planes joined again) through one launch
    def whole(w):
        p = w.parts
        return mm.PackedWeight(dataclasses.replace(
            p[0], **{f: torch.cat([getattr(x, f) for x in p], dim=-1)
                     for f in ("sym_plane", "ofs_plane", "stored")},
            k=w.cw.k, payload_bits=w.cw.payload_bits),
            w.shape, w.n_contract, w.dtype)
    single = {**eng.params, "blocks": [
        {g: ({n: (whole(w) if isinstance(w, mm.ShardedPackedWeight) else w)
              for n, w in v.items()} if isinstance(v, dict) else v)
         for g, v in b.items()} for b in eng.params["blocks"]]}
    worst = 0.0
    for r in run["reqs"]:
        toks = torch.as_tensor([list(r.prompt) + r.tokens[:-1]],
                               device=eng.device)
        a = M.forward(run["cfg"], eng.params, toks)[0]
        b = M.forward(run["cfg"], single, toks)[0]
        worst = max(worst, (a.float() - b.float()).abs().max().item())
    out = {"sites_k_split": len(sites),
           "max_abs_logit_diff_vs_single_device": worst,
           "decompress_matmul_launches_per_step":
               run["summary"]["launches_per_step"]["decompress_matmul"],
           "agreement": rates}
    print(f"packed mesh (m) [qwen3-1.7b, {CUT_LAYERS} layers, 1x2]: "
          + json.dumps(out))
    del run, eng, single
    return out


def async_qwen_phase(device, sync_run: dict) -> dict:
    """(e) qwen3-1.7b at 28 layers on the async scheduler: phase 3's 8
    requests at the default chunk (64 tokens), slot 0 preempted with spill
    after ten decode steps.  Gates: tokens equal to phase 3's sync fused
    serve; ``prefill_chunks`` >= 8 and ``staged_readahead`` >= 1; the
    window, dispatch and pump start never synchronize (``async_gates``);
    each steady step one device-to-host call besides its seal batches'.
    Prints both schedulers' median and longest step (no profiler window
    and no second sync serve: the script's time).  Returns the launches
    a step of each kernel."""
    rec: dict = {}
    alloc0 = host_alloc_stats()
    run = serve_full_width(device, layers=28, engine_kw=ASYNC_KW,
                           setup=host_parts(rec, async_gates(rec)),
                           hook=async_preempt_hook)
    res = check_async(run, rec, sync_run["tokens"], "async serve (e)")
    res["host_parts"] = {"async": host_medians(rec),
                         "sync": sync_run["host_parts"]}
    res["pinned_host_allocs"] = {"before": alloc0,
                                 "after": host_alloc_stats()}
    st = run["eng"].stats
    if not (st["prefill_chunks"] >= 8 and st["staged_readahead"] >= 1
            and st["preempted"] == 1 and st["resumed"] == 1):
        raise AssertionError(f"async serve (e): chunks, readahead or the "
                             f"preempt missing: {res}")
    s = run["summary"]
    del run
    res.update({
        "median_step_ms": {"async": s["median_step_ms"],
                           "sync": sync_run["median_step_ms"]},
        "max_step_ms": {"async": s["max_step_ms"],
                        "sync": sync_run["max_step_ms"]},
        "tokens_per_s": {"async": s["tokens_per_s"],
                         "sync": sync_run["tokens_per_s"]},
        "launches_per_step": s["launches_per_step"]})
    print("async serve (e) [qwen3-1.7b, 28 layers] vs phase 3's sync: "
          + json.dumps(res))
    return s["launches_per_step"]


def async_packed(device, packed: dict) -> float:
    """Phase 4's main path on the async scheduler, on phase 4's packed
    params (its engine's planes, not packed again): tokens equal to the
    packed sync serve's, under ``async_gates``.  Returns kernel 5's
    launches a step."""
    rec: dict = {}
    sync_tokens = [r.tokens for r in packed["reqs"]]
    run = serve_full_width(device, layers=packed["cfg"].num_layers,
                           params=packed["eng"].params,
                           label="apack-int8 (phase 4's planes)",
                           engine_kw=ASYNC_KW, setup=async_gates(rec),
                           keep_sites=set())
    res = check_async(run, rec, sync_tokens, "async packed serve")
    s = run["summary"]
    k5 = s["launches_per_step"]["decompress_matmul"]
    if not k5 > 0:
        raise AssertionError("async packed serve: kernel 5 never launched")
    res.update({"median_step_ms": {"async": s["median_step_ms"],
                                   "sync": packed["summary"]
                                   ["median_step_ms"]},
                "decompress_matmul_launches_per_step": k5})
    print("async serve [qwen3-1.7b packed, 28 layers] vs phase 4's sync: "
          + json.dumps(res))
    return k5


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
    ix = kv.pool.index(pids)
    vm, ol, cm = kv._tables_stacked()
    rows = np.array([[2 * l + kind for l in layers] for kind in (0, 1)])
    dev = kv.device
    return {"sym": kv.pool.read("sym", ix).clone(),
            "ofs": kv.pool.read("ofs", ix).clone(),
            "stored": kv.pool.read("stored", ix).clone(),
            "vm": torch.as_tensor(vm[rows], device=dev),
            "ol": torch.as_tensor(ol[rows], device=dev),
            "cum": torch.as_tensor(cm[rows], device=dev)}


# the SMOKE engines of phase 10, each run on the card and, in the
# background process, on the CPU: (key, options)
SMOKE_CASES = (
    (("qwen3-1.7b", "dense", "fused"), {}),
    (("qwen3-1.7b", "round-trip", "fused"), {"roundtrip": True}),
    (("qwen3-1.7b", "apack-int8", "fused"), {"weights": "apack-int8"}),
    (("qwen3-1.7b", "dense", "oracle"), {"fused": False}),
    (("qwen3-1.7b", "dense", "int8"), {"kv": "int8"}),
    (("qwen3-1.7b", "dense", "bfloat16"), {"kv": "bfloat16"}),
) + tuple(
    ((arch, w, mode), {"arch": arch, **kw})
    for arch in ("hetero-serve-smoke", "recurrentgemma-9b")
    for w, mode, kw in (("dense", "fused", {}),
                        ("dense", "oracle", {"fused": False}),
                        ("dense", "int8", {"kv": "int8"}),
                        ("apack-int8", "fused", {"weights": "apack-int8"}))
) + tuple(
    ((arch, w, "fused"), {"arch": arch, **kw})
    for arch, packed in (("minitron-8b", True), ("command-r-plus-104b", False),
                         ("paligemma-3b", False), ("dbrx-132b", False),
                         ("kimi-k2-1t-a32b", True), (XLSTM, False))
    for w, kw in (("dense", {}),) + ((("apack-int8", {"weights":
                                                      "apack-int8"}),)
                                     if packed else ()))
# the stacks with rolling layers, whose SMOKE engines must evict pages
ROLLING_SMOKE = ("hetero-serve-smoke", "recurrentgemma-9b")
# the SMOKE stacks trained 3 steps on the card and on the CPU
TRAIN_SMOKE_ARCHS = ("qwen3-1.7b", XLSTM)


def smoke_engine_run(dev, weights=None, kv="apack-int8", fused=True,
                     roundtrip=False, arch="qwen3-1.7b") -> dict:
    """A SMOKE-width engine on ``dev``: 3 requests of 20, 33 and 9 tokens,
    12 new each, through 2 slots.  ``weights="apack-int8"`` packs every
    projection (``weight_min_size=1024``: SMOKE's matrices are under the
    default); ``fused=False`` serves the paged cache through the
    materialize oracle; ``kv`` "int8" or "bfloat16" serves a dense cache.
    ``roundtrip=True`` serves the weights after ``compress_params`` (every
    stacked matrix of 64 elements or more, the norm scales included) and
    ``decompress_params``.  ``arch`` "hetero-serve-smoke" or
    "recurrentgemma-9b" (window 8) serves a heterogeneous stack; another
    decoder of the registry (minitron-8b, command-r-plus-104b,
    paligemma-3b, dbrx-132b, kimi-k2-1t-a32b) its own SMOKE stack.  Returns
    the tokens, the first request's prefill logits, ``weight_stats()``,
    the KV stats and (round trip) the ``CompressedParams`` and the
    decompressed weights on the CPU."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import (Request, ServeEngine, compress_params,
                                   decompress_params)
    cfg = dataclasses.replace(get_smoke_config(arch), kv_cache_dtype=kv)
    if arch == "recurrentgemma-9b":
        cfg = dataclasses.replace(cfg, window_size=8)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n) for n in (20, 33, 9)]
    p = _on(params, dev)
    cp = None
    if roundtrip:
        cp = compress_params(cfg, p, min_size=64)
        p = decompress_params(cp, dev)
        cp = (cp, [t.cpu() for t in param_leaves(p)])
    eng = ServeEngine(cfg, p, max_batch=2, max_len=64, kv_page_size=4,
                      kv_calib_pages=2, kv_fused=fused, weights=weights,
                      weight_min_size=1024, device=dev)
    reqs = [Request(i, x, max_new_tokens=12) for i, x in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    logits0, _ = eng._prefill_forward(prompts[0])
    eng.run_until_drained()
    ks = eng.kv_stats()
    return {"tokens": [r.tokens for r in reqs],
            "logits0": logits0.float().cpu(), "ws": eng.weight_stats(),
            "kv": {k: ks[k] for k in ("kv_ratio", "kv_streams",
                                      "kv_pages_evicted", "kv_pages_packed")
                   if k in ks},
            "paged": eng.paged, "cp": cp}


def smoke_vs_cpu(device, twins: dict, key) -> list:
    """A SMOKE engine (``smoke_engine_run`` with ``SMOKE_CASES``' options
    for ``key``) on the card against the same engine on the CPU
    (``twins``, from the background process, the kernels' plain
    versions): greedy tokens must be identical, and the prefill logits of
    the first request may differ by at most one bf16 step at their largest
    magnitude (cuBLAS and the CPU may round a bf16 GEMM differently, and
    the decompress-matmul kernel sums inside a K tile in another order
    than the CPU's f32 GEMM).  With the round trip, the two devices'
    ``CompressedParams`` must be identical (containers, scales, byte
    counts) and so must the decompressed weights.  The paged engines of
    every stack but qwen3-1.7b must also give equal ``kv_ratio``, stream
    stats and page counts, and those of a stack with rolling layers
    (``ROLLING_SMOKE``) ``kv_pages_evicted`` > 0.  Returns the card's
    tokens."""
    import torch
    arch = key[0]
    case = dict(SMOKE_CASES)[key]
    out = {"cpu": twins[("smoke", key)],
           device: smoke_engine_run(device, **case)}
    c, d = out["cpu"], out[device]
    diff = (c["logits0"] - d["logits0"]).abs().max().item()
    step = (torch.finfo(torch.bfloat16).eps
            * c["logits0"].abs().max().item())
    same = c["tokens"] == d["tokens"]
    same_ws = c["ws"] == d["ws"]
    same_kv = c["kv"] == d["kv"]
    hetero = arch != "qwen3-1.7b"
    if arch in ROLLING_SMOKE and d["paged"] \
            and not d["kv"]["kv_pages_evicted"] > 0:
        raise AssertionError(f"SMOKE {arch}: no page rolled out")
    tag = f"{arch}, {key[1]} weights, {key[2]} KV"
    if d["cp"] is not None:
        (cp_c, w_c), (cp_d, w_d) = c["cp"], d["cp"]
        cp_diff = compressed_params_diff(cp_c, cp_d)
        same_w = all(torch.equal(a, b) for a, b in zip(w_d, w_c))
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
          f"{same}, weight_stats equal {same_ws}, kv stats equal {same_kv}"
          + (f" {json.dumps(d['kv'])}" if arch in ROLLING_SMOKE
             else f" kv_ratio {d['kv'].get('kv_ratio')}" if hetero else ""))
    if diff > step or not same or not same_ws or (
            hetero and d["paged"] and not same_kv):
        raise AssertionError(f"SMOKE engine [{tag}] on the card disagrees "
                             "with the CPU")
    return d["tokens"]


def cpu_twins(path: str) -> int:
    """The background process (``chip_smoke.py --cpu-twins PATH``): every
    CPU side of phase 10 and (d), at a quarter of the host's cores, saved
    to ``path`` for the card phases to compare against."""
    import torch
    sys.path.insert(0, os.path.join(HERE, "src"))
    torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))
    t0 = time.perf_counter()
    out: dict = {}
    for key, case in SMOKE_CASES:
        out[("smoke", key)] = smoke_engine_run(torch.device("cpu"), **case)
    for arch in ASYNC_SMOKE_ARCHS:
        out[("async", arch)] = async_smoke_run(arch, torch.device("cpu"))
    for arch in TRAIN_SMOKE_ARCHS:
        out[("train", arch)] = train_smoke_run(arch, torch.device("cpu"))
    for name in ROBUSTNESS_RUNS:
        out[("robust", name)] = robustness_run(name, torch.device("cpu"))
    out["seconds"] = time.perf_counter() - t0
    out["threads"] = torch.get_num_threads()
    torch.save(out, path)
    return 0


def start_cpu_twins():
    """Start ``cpu_twins`` as a background process (no card visible to
    it), writing ``build/smoke_cpu_twins.pt``.  Returns (process, path)."""
    path = os.path.join(HERE, "build", "smoke_cpu_twins.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--cpu-twins", path], env=env)
    return proc, path


def wait_cpu_twins(proc, path: str) -> dict:
    """The background process's results, once it has ended."""
    import torch
    t0 = time.perf_counter()
    rc = proc.wait(timeout=900)
    if rc != 0 or not os.path.exists(path):
        raise AssertionError(f"the SMOKE CPU twins process failed (rc {rc})")
    twins = torch.load(path, weights_only=False)
    print(f"SMOKE CPU twins: {twins['seconds']:.1f} s in the background on "
          f"{twins['threads']} threads; waited "
          f"{time.perf_counter() - t0:.1f} s for them")
    return twins


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
    cp = compress_params(cfg, params, timings=tc)
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
            _stacked_leaves(cfg, params), _stacked_leaves(cfg, back)):
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


# ----------------------------------------------------------------- phase 9
def rg_requests(cfg, rng):
    """The 8 requests of the recurrentgemma-9b serve, 48 new tokens each:
    prompts of 2001-2047 tokens (below the 2048 window; they cross it while
    decoding) alternating with prompts of 2049-2112 (above it: pages roll
    out at ingest and then every 16 tokens)."""
    import numpy as np
    from repro_torch.serve import Request
    lens = [int(rng.integers(2001, 2048) if i % 2 == 0
                else rng.integers(2049, 2113)) for i in range(8)]
    return [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int64),
                    max_new_tokens=48) for i, n in enumerate(lens)]


def rg_oracle_hook(done: dict):
    """Run ``oracle_gates`` once, after ten decode steps, while the pages
    are HOT and PACKED (the rolling layers calibrate at the first ingest,
    so a COLD page never waits between steps)."""
    from repro_torch.models.modules import PAGE_PACKED

    def hook(eng, i):
        if "packed" not in done and i >= 10 and \
                PAGE_PACKED in live_page_states(eng):
            done["packed"] = oracle_gates(eng, "HOT+PACKED")
    return hook


def rg_preempt_hook(res: dict):
    """Preempt slot 0 after ten decode steps, keeping a copy of its
    recurrent states from the device store; after the next step, which
    resumes it (``restore_state`` through the decode kernel), its restored
    states must equal the copy bit for bit."""
    import torch

    def hook(eng, i):
        if i == 9:
            res["rid"] = eng.active[0].rid
            res["live"] = eng.kv.read_state_slot(0)
            t0 = time.perf_counter()
            planes = eng.preempt(0, requeue="head")["planes"]
            torch.cuda.synchronize()
            res["snapshot"] = {
                "s": time.perf_counter() - t0,
                "raw_bytes": planes.original_bits // 8,
                "bytes": planes.total_bits // 8,
                "ratio": planes.total_bits / planes.original_bits,
                "planes_stored": [bool(p.stored.all())
                                  for p in planes.planes]}
        elif i == 10:
            st = eng.kv.states[res["rid"]]
            res["restored_bit_exact"] = all(
                torch.equal(st[layer][f], v)
                for layer, d in res.pop("live").items()
                for f, v in d.items())
    return hook


def recurrentgemma_phase(device):
    """recurrentgemma-9b at published widths (window 2048), cut to
    ``RG_LAYERS`` (14) of its 38 layers: 2 recurrent prefix layers + 4 x
    (recurrent, recurrent, local), seed-0 random f32 weights, served from
    their bf16 serving copy:
    the fused paged APack KV path, the materialize oracle (gated at one
    step with PACKED pages) and the fused path with slot 0 preempted and
    resumed (tokens equal to the fused serve's, states restored bit for
    bit).  Then (c) serves them from APack-packed weights (packed by layer
    kind from the f32 draw), checks the packed sites of one local layer's
    attention and one recurrent layer's FFN against f32 and f64 products,
    and prints ``weight_stats()``, the packing seconds and the token
    agreement with the dense fused serve.  Returns the fused serve's launch
    counts and kernel 5's launches a step of the packed serve."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                              num_layers=RG_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    n_params = sum(t.numel() for t in param_leaves(params))
    params = M.serving_params(params)
    torch.cuda.synchronize()
    print("recurrentgemma-9b: " + json.dumps({
        "layers": cfg.num_layers, "kinds": M.layer_kinds(cfg),
        "params": n_params, "init_s": time.perf_counter() - t0,
        "serving_copy_gb": sum(nbytes(t) for t in param_leaves(params))
        / 1e9,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}))
    kw = dict(arch="recurrentgemma-9b", params=params, max_len=2176,
              requests=rg_requests, layers=RG_LAYERS)
    sync_parts: dict = {}
    fused = serve_full_width(device, setup=host_parts(sync_parts), **kw)
    fused_tokens = [r.tokens for r in fused["reqs"]]
    s = fused["summary"]
    if not s["kv_pages_evicted"] > 0:
        raise AssertionError("recurrentgemma-9b: no page rolled out")
    print("recurrentgemma-9b fused: " + json.dumps({
        "tokens_per_s": s["tokens_per_s"],
        "median_step_ms": s["median_step_ms"], "kv_ratio": s["kv_ratio"],
        "stream_ratios": {k: v["ratio"] for k, v in s["kv_streams"].items()
                          if "ratio" in v and k != "spill"},
        "kv_pages_evicted": s["kv_pages_evicted"],
        "max_memory_gb": s["max_memory_gb"]}))
    verify_packed(fused["snapshot"])
    profile_steady_steps(fused["eng"], fused["cfg"], fused["rng"],
                         "recurrentgemma-9b fused", prompt_len=2100)
    launches = fused["launches"]
    del fused
    torch.cuda.empty_cache()
    # (f) the async scheduler with chunked prefill: 2001-2112-token
    # prompts at the default chunk, 64 tokens, so about 32 chunks a prompt
    rec: dict = {}
    arun = serve_full_width(device, engine_kw=ASYNC_KW,
                            setup=host_parts(rec, async_gates(rec)), **kw)
    res = check_async(arun, rec, fused_tokens,
                      "recurrentgemma-9b async serve (f)")
    res["host_parts"] = {"async": host_medians(rec),
                         "sync": host_medians(sync_parts)}
    a = arun["summary"]
    res.update({"median_step_ms": {"async": a["median_step_ms"],
                                   "sync": s["median_step_ms"]},
                "max_step_ms": {"async": a["max_step_ms"],
                                "sync": s["max_step_ms"]},
                "tokens_per_s": {"async": a["tokens_per_s"],
                                 "sync": s["tokens_per_s"]},
                "chunks_per_prompt": res["prefill_chunks"] / len(
                    arun["reqs"]),
                "kv_pages_evicted": a["kv_pages_evicted"],
                "kv_ratio": {"async": a["kv_ratio"], "sync": s["kv_ratio"]}})
    print("recurrentgemma-9b async serve (f) vs the fused sync serve: "
          + json.dumps(res))
    if not a["kv_pages_evicted"] > 0:
        raise AssertionError("recurrentgemma-9b async serve: no page rolled "
                             "out")
    del arun
    torch.cuda.empty_cache()
    done: dict = {}
    oracle = serve_full_width(device, fused=False, hook=rg_oracle_hook(done),
                              **kw)
    if "packed" not in done:
        raise AssertionError("recurrentgemma-9b oracle: the gates never ran")
    print("recurrentgemma-9b oracle vs fused serve: " + json.dumps({
        "token_agreement": token_agreement(
            [r.tokens for r in oracle["reqs"]], fused_tokens),
        "requests_identical": sum(r.tokens == t for r, t in
                                  zip(oracle["reqs"], fused_tokens)),
        "launches": oracle["launches"]}))
    verify_packed(oracle["snapshot"])
    del oracle
    torch.cuda.empty_cache()
    res: dict = {}
    pre = serve_full_width(device, hook=rg_preempt_hook(res), **kw)
    st = pre["eng"].stats
    print("recurrentgemma-9b preempt serve: " + json.dumps({
        "preempted": st["preempted"], "resumed": st["resumed"],
        "snapshot": res.get("snapshot"),
        "restored_bit_exact": res.get("restored_bit_exact"),
        "state_stream": pre["summary"]["kv_streams"]["state"]}))
    if st["preempted"] != 1 or st["resumed"] != 1:
        raise AssertionError("recurrentgemma-9b preempt serve: slot 0 was "
                             "not preempted and resumed once")
    if not res.get("restored_bit_exact"):
        raise AssertionError("recurrentgemma-9b preempt serve: the state "
                             "snapshot did not restore bit-exactly")
    if [r.tokens for r in pre["reqs"]] != fused_tokens:
        raise AssertionError("recurrentgemma-9b preempt serve: tokens "
                             "differ from the uninterrupted fused serve")
    del pre, params, kw
    torch.cuda.empty_cache()
    # (c) from packed weights: the f32 draw again, packed by layer kind
    # before anything else holds the card (the bf16 copy is gone)
    kinds = M.layer_kinds(cfg)
    local = kinds.index("local")
    rec = next(i for i, k in enumerate(kinds)
               if k == "recurrent" and i >= len(cfg.prefix_pattern))
    sites = {(local, "inner", n) for n in ("wq", "wk", "wv", "wo")} | \
        {(rec, "ffn", n) for n in ("w_up", "w_gate", "w_down")}
    torch.cuda.reset_peak_memory_stats()
    packed = serve_full_width(
        device, arch="recurrentgemma-9b", max_len=2176, requests=rg_requests,
        layers=RG_LAYERS, weights="apack-int8", keep_sites=sites,
        params=M.init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0), device))
    eng, s = packed["eng"], packed["summary"]
    host = packed.pop("host_weights")
    if len(check_packed_sites(eng, dequantized_site(host, eng.device),
                              "recurrentgemma-9b")) != len(host):
        raise AssertionError(f"recurrentgemma-9b: a site of {sorted(host)} "
                             "was not checked")
    ws = s["weight_stats"]
    print("recurrentgemma-9b packed: " + json.dumps({
        **{k: ws[k] for k in ("weight_ratio", "native_ratio",
                              "packed_tensors", "payload_bytes",
                              "int8_bytes", "native_bytes")},
        "weight_pack_s": eng.weight_pack_s,
        "median_step_ms": s["median_step_ms"],
        "tokens_per_s": s["tokens_per_s"], "kv_ratio": s["kv_ratio"],
        "kv_pages_evicted": s["kv_pages_evicted"],
        "max_memory_gb": s["max_memory_gb"],
        "decompress_matmul_launches_per_step":
            s["launches_per_step"]["decompress_matmul"],
        "token_agreement_with_dense": token_agreement(
            [r.tokens for r in packed["reqs"]], fused_tokens)}))
    rg_k5 = s["launches_per_step"]["decompress_matmul"]
    verify_packed(packed["snapshot"])
    del packed, eng
    torch.cuda.empty_cache()
    print(f"recurrentgemma-9b phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, rg_k5


# ------------------------------------------------------ new architectures
def arch_params(device, arch, layers=None, serving=True):
    """Seed-0 random params of ``arch`` at published widths (``layers``
    layers, its own depth when None) on the card, in ``param_dtype``, and
    their bf16 serving copy when ``serving``; prints the count, the init
    seconds and the peak memory.  Returns (cfg, params)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=layers or cfg.num_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    n_params = sum(t.numel() for t in param_leaves(params))
    if serving:
        params = M.serving_params(params)
    torch.cuda.synchronize()
    print(f"{arch}: " + json.dumps({
        "layers": cfg.num_layers, "params": n_params,
        "param_dtype": cfg.param_dtype, "init_s": time.perf_counter() - t0,
        "weights_gb": sum(nbytes(t) for t in param_leaves(params)) / 1e9,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}))
    return cfg, params


def dequantized_site(host, device):
    """``weight_of`` for ``check_packed_sites``: the f32 weight of a site
    whose original is in ``host`` (keyed as ``packed_sites`` names it, the
    head as (None, "head", "unembed")), quantized and dequantized again on
    the card as ``pack_weights`` does, as the [K, N] matrix."""
    from repro_torch.core import quant

    def weight_of(i, grp, name, pw):
        if (i, grp, name) not in host:
            return None
        q, qp = quant.quantize_symmetric(
            host[i, grp, name].to(device).float(), axis=-1)
        return quant.dequantize_symmetric(q, qp).reshape(pw.cw.k, pw.cw.n)
    return weight_of


def new_arch_summary(fused, packed, prof) -> dict:
    """The numbers (g) and (h) print of their fused and packed serves."""
    s, p = fused["summary"], packed["summary"]
    ws = p["weight_stats"]
    same_depth = s["layers"] == p["layers"]
    return {"layers": {"fused": s["layers"], "packed": p["layers"]},
            "kv_ratio": {"fused": s["kv_ratio"], "packed": p["kv_ratio"]},
            "weight_ratio": ws["weight_ratio"],
            "native_ratio": ws["native_ratio"],
            "packed_tensors": ws["packed_tensors"],
            "weight_pack_s": p["weight_pack_s"],
            "median_step_ms": {"fused": s["median_step_ms"],
                               "packed": p["median_step_ms"]},
            "max_step_ms": {"fused": s["max_step_ms"],
                            "packed": p["max_step_ms"]},
            "tokens_per_s": {"fused": s["tokens_per_s"],
                             "packed": p["tokens_per_s"]},
            "idle_share_fused": prof["idle_share"],
            "max_memory_gb": {"fused": s["max_memory_gb"],
                              "packed": p["max_memory_gb"]},
            "token_agreement_packed_vs_fused": token_agreement(
                [r.tokens for r in packed["reqs"]], fused["tokens"])
            if same_depth else None,
            "launches_per_step": {
                "fused_page_attention":
                    s["launches_per_step"]["fused_page_attention"],
                "decompress_matmul":
                    p["launches_per_step"]["decompress_matmul"]}}


def new_arch_phase(device, arch, tag, layers=None, sites=(),
                   fused_layers=None):
    """(g) and (h): ``arch`` at published widths (``layers`` layers, its
    own depth when None), seed-0 random weights: the fused paged APack KV
    serve of phase 3's requests from the bf16 serving copy (at
    ``fused_layers`` layers when given), with a profiler window; then a
    serve from packed weights (the draw again in
    ``param_dtype``, packed with its untied head: the head's product
    through kernel 5), checked as phase 4's: layer 0's packed sites (which
    must be ``sites``, (group, name) pairs) and the head against f32 and
    f64 products, and ``teacher_forced`` through the first ``CUT_LAYERS``
    layers (all of a shallower cut) and the head against ``oracle_stores``
    (its RMS drift gate); ``weight_stats()`` and the packing seconds
    printed.  Returns the summary (``new_arch_summary``)."""
    import gc
    import torch
    t_phase = time.perf_counter()
    gc.collect()                # the previous phase's engines, before the
    torch.cuda.empty_cache()    # draw: its peak memory is this phase's
    cfg, params = arch_params(device, arch, fused_layers or layers)
    fused = serve_full_width(device, params=params, arch=arch,
                             layers=cfg.num_layers)
    del params
    prof = profile_steady_steps(fused["eng"], fused["cfg"], fused["rng"],
                                f"{arch} fused")
    verify_packed(fused["snapshot"])
    fused = {"summary": fused["summary"],
             "tokens": [r.tokens for r in fused["reqs"]]}
    torch.cuda.empty_cache()
    cfg, packed_params = arch_params(device, arch, layers, serving=False)
    box = [packed_params]
    del packed_params
    kw = dict(arch=arch, layers=cfg.num_layers)
    cut = min(CUT_LAYERS, cfg.num_layers)
    packed = serve_full_width(device, weights="apack-int8",
                              keep_sites=cut_sites(cut), params=box.pop(),
                              **kw)
    eng = packed["eng"]
    stores = oracle_stores({**eng.params,
                            "blocks": eng.params["blocks"][:cut]},
                           packed.pop("host_weights"))
    checked = check_packed_sites(eng, lambda i, grp, name, pw: (
        site(stores["oracle32"], i, grp, name).w if i in (0, None)
        else None), arch, sites=with_head(eng.params))
    want = [f"0/{g}/{n}" for g, n in sites] + ["unembed"]
    if sorted(checked) != sorted(want):
        raise AssertionError(f"{arch}: checked the packed sites {checked}, "
                             f"expected {want}")
    out = new_arch_summary(fused, packed, prof)
    out["teacher_forced"] = teacher_forced(packed, stores, layers=cut)
    del stores
    print(f"{arch} ({tag}): " + json.dumps(out))
    verify_packed(packed["snapshot"])
    del packed, eng
    torch.cuda.empty_cache()
    print(f"{arch} phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def hubert_phase(device) -> dict:
    """hubert-xlarge at published widths and depth (48 encoder layers,
    d_model 1280, 16 heads of 80, gelu d_ff 5120, 504 cluster units),
    seed-0 random weights from their bf16 serving copy: one forward of
    [2, 400] frame embeddings (the audio stub frontend), finite logits of
    shape [2, 400, 504], and the encoder's bidirectionality
    (``test_encoder_is_bidirectional``): a change to the last frame of
    sequence 0 moves its first frame's logits.  The engine refuses an
    encoder (no decode path)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine
    cfg, params = arch_params(device, "hubert-xlarge")
    g = torch.Generator(device=device).manual_seed(3)
    fe = torch.randn(2, 400, cfg.d_model, generator=g, device=device)
    M.forward(cfg, params, frame_embeds=fe)             # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = M.forward(cfg, params, frame_embeds=fe)[0]
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    fe2 = fe.clone()
    fe2[0, -1] += 10.0
    logits2 = M.forward(cfg, params, frame_embeds=fe2)[0]
    moved = (logits2[0, 0] - logits[0, 0]).abs().max().item()
    finite = bool(torch.isfinite(logits).all())
    if tuple(logits.shape) != (2, 400, cfg.vocab_size) or not finite \
            or not moved > 0:
        raise AssertionError(f"hubert-xlarge: logits {tuple(logits.shape)},"
                             f" finite {finite}, first frame moved by "
                             f"{moved}")
    try:
        ServeEngine(cfg, params, device=device)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("hubert-xlarge: the engine served an encoder")
    out = {"layers": cfg.num_layers, "frames": [2, 400],
           "forward_ms": fwd_ms, "first_frame_moved_by": moved,
           "engine_refusal": refused}
    print("hubert-xlarge: " + json.dumps(out))
    del params, logits, logits2
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------- xLSTM and training (slice 12)
TRAIN_BATCH, TRAIN_SEQ = 8, 256     # tokens of a full-width training step
# card vs CPU losses of the SMOKE training steps: the reference's bound for
# the same loss through another summation order (grad accumulation)
TRAIN_SMOKE_RTOL = 1e-3


def bits_equal(a, b) -> bool:
    """Two f32 tensors equal bit for bit (-0.0 is not 0.0)."""
    import torch
    return a.dtype == b.dtype == torch.float32 and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


def xlstm_phase(device) -> dict:
    """(i) xlstm-125m at published widths and depth (12 layers, d_model
    768, mLSTM and sLSTM alternating, seed-0 random f32 weights), phase
    3's 8 requests through 4 slots: the engine with
    ``kv_cache_dtype="apack-int8"`` (no attention layer: no pool page, the
    states in the device state store, ``kv_ratio`` None), then a dense
    bf16 cache (``decode_step``), whose greedy tokens must be equal, then
    the apack-int8 engine with slot 0 preempted after ten steps and
    resumed, its states through the byte-plane snapshot (kernels 2 and 1,
    which the serve's counts must show), restored bit for bit, the tokens
    equal.  Then an empty state (the -1e30 stabilizers) through a
    snapshot on the card, bit for bit.  Returns the first serve's summary
    and the preempt serve's launches."""
    import dataclasses
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine
    t_phase = time.perf_counter()
    base = get_config(XLSTM)
    params = M.init_params(base, torch.Generator(device=device)
                           .manual_seed(0), device)
    out: dict = {"layers": base.num_layers, "d_model": base.d_model}
    tokens = {}
    for name, kv in (("fused", "apack-int8"), ("dense cache", "bfloat16")):
        cfg = dataclasses.replace(base, kv_cache_dtype=kv)
        eng = ServeEngine(cfg, params, max_batch=4, max_len=160,
                          kv_page_size=16, device=device)
        reqs = serve_requests(cfg, np.random.default_rng(0))
        d = drive(eng, reqs, tag=f"{XLSTM} {name}")
        tokens[name] = d["tokens"]
        if name == "fused":
            ks = eng.kv_stats()
            if ks["kv_pool_pages"] != 0 or ks["kv_ratio"] is not None:
                raise AssertionError(f"{XLSTM}: {ks['kv_pool_pages']} pool "
                                     f"pages, kv_ratio {ks['kv_ratio']}")
            out.update({k: d[k] for k in (
                "median_step_ms", "max_step_ms", "longest_step",
                "first_step_s", "max_memory_gb")},
                kv_pool_pages=0, kv_ratio=None,
                tokens_per_s=sum(map(len, d["tokens"])) / d["wall_s"])
        del eng
    if tokens["fused"] != tokens["dense cache"]:
        raise AssertionError(f"{XLSTM}: the state-store engine's tokens "
                             "differ from the dense-cache decode_step's")
    cfg = dataclasses.replace(base, kv_cache_dtype="apack-int8")
    eng = ServeEngine(cfg, params, max_batch=4, max_len=160,
                      kv_page_size=16, device=device)
    reqs = serve_requests(cfg, np.random.default_rng(0))
    for r in reqs:
        eng.submit(r)
    repro_torch.reset_launch_counts()
    res: dict = {}
    i = 0
    while eng.step() or eng.queue:
        i += 1
        if i == 10:                        # preempt slot 0, requeued first
            res["rid"], res["live"] = (eng.active[0].rid,
                                       eng.kv.read_state_slot(0))
            t0 = time.perf_counter()
            planes = eng.preempt(0, requeue="head")["planes"]
            torch.cuda.synchronize()
            res["snapshot"] = {"s": time.perf_counter() - t0,
                               "raw_bytes": planes.original_bits // 8,
                               "ratio": planes.total_bits
                               / planes.original_bits}
        elif i == 11:                      # resumed by that step
            st = eng.kv.states[res["rid"]]
            res["restored_bit_exact"] = all(
                bits_equal(st[layer][f], v)
                for layer, dd in res.pop("live").items()
                for f, v in dd.items())
    torch.cuda.synchronize()
    launches = repro_torch.launch_counts()
    if not res.get("restored_bit_exact") or eng.stats["resumed"] != 1:
        raise AssertionError(f"{XLSTM}: preempted states not restored bit "
                             f"for bit ({res.get('restored_bit_exact')})")
    if [r.tokens for r in reqs] != tokens["fused"]:
        raise AssertionError(f"{XLSTM}: the preempted serve's tokens differ")
    if launches["apack_encode"] < 1 or launches["apack_decode"] < 1:
        raise AssertionError(f"{XLSTM}: the snapshot ran no kernel "
                             f"({launches})")
    # an empty state, its stabilizers at -1e30, through the card's codec
    kv = eng.kv
    kv.add_request(-1)
    kv.add_request(-2)
    kv.states[-1] = {layer: {f: v.clone() for f, v in kv._state_template(
        kv.layer_kinds[layer]).items()} for layer in kv.state_layers}
    kv.restore_state(-2, kv.snapshot_state(-1))
    empty_ok = all(bits_equal(kv.states[-2][layer][f], v)
                   for layer, dd in kv.states[-1].items()
                   for f, v in dd.items())
    if not empty_ok:
        raise AssertionError(f"{XLSTM}: an empty state's snapshot is not "
                             "restored bit for bit")
    out.update(dense_cache_tokens_equal=True, preempt_tokens_equal=True,
               restored_bit_exact=True, empty_state_bit_exact=True,
               snapshot=res["snapshot"],
               preempt_launches={k: launches[k] for k in (
                   "apack_encode", "apack_decode")})
    print(f"{XLSTM} (i): " + json.dumps(out))
    del eng, kv, params
    torch.cuda.empty_cache()
    print(f"{XLSTM} phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def leaf_digest(t) -> tuple:
    """A hash of a tensor's bytes computed on its device: (bytes, the sum
    of its int32 words, their position-weighted sum mod 2^64), so that a
    state can be held against another without a second host copy."""
    import torch
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if b.numel() % 4:
        b = torch.cat([b, b.new_zeros((-b.numel()) % 4)])
    w = b.view(torch.int32)
    s1 = s2 = 0
    for i in range(0, w.numel(), 1 << 25):
        c = w[i:i + (1 << 25)].to(torch.int64)
        pos = torch.arange(i, i + c.numel(), device=c.device)
        s1 += int(c.sum())
        s2 += int((c * (pos * 2654435761 + 1)).sum())
    return b.numel(), s1, s2 % (1 << 64)


def profile_window(fn, n: int, tag: str, top: int = 8, also=()) -> dict:
    """torch.profiler over ``n`` calls of ``fn`` (steps): device time by
    kernel name, printed for the ``top`` largest and every kernel below
    them whose name holds ``::k`` for a ``k`` of ``also``, and the
    device's idle share of the window.  Returns the window's wall and busy
    ms a step, its idle share, the top four and every row (device us,
    name, count)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
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
    print(f"profile {tag}: {n} steady steps, wall {wall * 1e3:.1f} ms, "
          f"device busy {busy * 1e3:.1f} ms, idle share "
          f"{1 - busy / wall:.3f}")
    for dev_us, key, count in rows[:top] + [r for r in rows[top:] if any(
            f"::{k}" in r[1] for k in also)]:
        print(f"profile {tag}:   {dev_us / 1e3:9.2f} ms  {count:6d}x  "
              f"{key[:90]}")
    return {"wall_ms_per_step": wall * 1e3 / n,
            "busy_ms_per_step": busy * 1e3 / n, "idle_share": 1 - busy / wall,
            "top": [(k[:60], round(us / 1e3 / n, 3)) for us, k, _ in
                    rows[:4]], "rows": rows}


def train_steps(device, arch, steps, tag, layers=None, profile=0,
                keep_first=None) -> dict:
    """``steps`` training steps of ``arch`` at published widths (``layers``
    layers, its own depth when None), seed-0 f32 params drawn on the card,
    8-bit AdamW moments, ``SyntheticLM`` batches of 8 x 256, each step
    timed to the card's end; the loss, grad norm and params must stay
    finite.  ``profile``: a profiler window over that many more steps.
    ``keep_first``, a dict, gets the first step's batch, metrics and new
    params (the next step builds new tensors: nothing is copied).
    Returns the median step, tokens/s and peak memory."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=layers or cfg.num_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(0), device)
    ocfg = AdamWConfig(state_dtype="int8")
    box = {"params": params, "opt": init_state(ocfg, params)}
    del params
    data = SyntheticLM(DataConfig(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                  vocab_size=cfg.vocab_size))
    step = make_train_step(cfg, ocfg)
    metrics = []

    def one():
        b = {"tokens": torch.from_numpy(data.next_batch()["tokens"])
             .to(device)}
        box["params"], box["opt"], m = step(box["params"], box["opt"], b)
        if keep_first is not None and not metrics:
            keep_first.update(tokens=b["tokens"], params=box["params"],
                              metrics={k: float(v) for k, v in m.items()})
        metrics.append(m)

    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    prof = profile_window(one, profile, tag) if profile else None
    if prof:
        del prof["rows"]
    loss = [float(m["loss"]) for m in metrics]
    gnorm = [float(m["grad_norm"]) for m in metrics]
    finite = all(np.isfinite(loss + gnorm)) and all(
        bool(torch.isfinite(x).all()) for x in tree.leaves(box["params"]))
    if not finite:
        raise AssertionError(f"{tag}: non-finite loss, grad norm or params "
                             f"(loss {loss}, grad norm {gnorm})")
    med = float(np.median(times[1:])) if steps > 1 else times[0]
    out = {"layers": cfg.num_layers, "batch": [TRAIN_BATCH, TRAIN_SEQ],
           "first_step_s": times[0], "median_step_ms": med * 1e3,
           "step_ms": [t * 1e3 for t in times],
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss": loss, "grad_norm": gnorm, "profile": prof}
    print(f"{tag}: " + json.dumps(out))
    del box, metrics
    torch.cuda.empty_cache()
    return out


class EndRun(Exception):
    """Stops (j)'s restart after its replayed step 5: not an exception the
    supervisor restarts on, so it makes no save at ``max_steps``."""


def train_restart(device, layers: int) -> dict:
    """(j)'s restart: qwen3-1.7b at published widths, ``layers`` layers,
    through ``Supervisor`` (``compress_ckpt=True``, ``save_every=3``,
    ``max_steps=6``, the async saver, 8-bit moments, batches of 8 x 256),
    with a ``RuntimeError`` injected once into the sixth step, after the
    step-3 save: the supervisor restores step 3 from the compressed
    checkpoint (the decode kernel) and replays steps 4 and 5, and the
    sixth step then ends the run (``EndRun``) before the supervisor's
    second save (cut to keep the script's time: it checked that a
    restored run saves again, 22.45 s).  Deterministic algorithms
    (and ``CUBLAS_WORKSPACE_CONFIG``) in this phase only: the embedding's
    backward otherwise accumulates with atomics.  Gates: the restored
    state equals the saved one bit for bit (``leaf_digest`` of every leaf:
    params, ``Q8`` payloads and scales, the step counter) and so does the
    data cursor; the replayed steps 4 and 5 give the first pass's losses
    bit for bit; every loss and grad norm finite.  Returns the save and
    restore seconds by part, the kernels' launches per save and per
    restore and the stored/raw ratio of the last checkpoint."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.runtime import Supervisor, SupervisorConfig
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=layers)
    ckdir = os.path.join(HERE, "build", "ckpt_train")
    shutil.rmtree(ckdir, ignore_errors=True)
    ocfg = AdamWConfig(state_dtype="int8")
    data = SyntheticLM(DataConfig(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                  vocab_size=cfg.vocab_size))
    step = make_train_step(cfg, ocfg)
    rec: dict = {"loss": {}, "grad_norm": {}, "steps": []}

    def digests(state):
        return [leaf_digest(x) for x in tree.leaves(state)]

    def make_state():
        p = M.init_params(cfg, torch.Generator(device=device)
                          .manual_seed(0), device)
        return {"params": p, "opt": init_state(ocfg, p)}, {}

    def step_fn(state, idx):
        if idx == 5 and "failed" not in rec:
            rec["failed"] = True
            raise RuntimeError("injected failure in step 6")
        if idx == 5:
            raise EndRun
        if "failed" in rec and idx == 3 and "restored" not in rec:
            rec["restored"] = digests(state)
            rec["cursor_restored"] = data.state_dict()
        b = {"tokens": torch.from_numpy(data.next_batch()["tokens"])
             .to(device)}
        p, o, m = step(state["params"], state["opt"], b)
        new = {"params": p, "opt": o}
        if idx == 2:
            rec["saved"] = digests(new)
            rec["cursor_saved"] = data.state_dict()
        m = {k: float(v) for k, v in m.items()}
        rec["steps"].append(idx + 1)
        rec["loss"].setdefault(idx, []).append(m["loss"])
        rec["grad_norm"].setdefault(idx, []).append(m["grad_norm"])
        return new, m

    timings = {"save": {}, "restore": {}}
    prev = torch.are_deterministic_algorithms_enabled()
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.cuda.empty_cache()
    try:
        repro_torch.reset_launch_counts()
        t0 = time.perf_counter()
        sup = Supervisor(SupervisorConfig(ckpt_dir=ckdir, save_every=3,
                                          max_steps=6, keep=1,
                                          compress_ckpt=True),
                         make_state=make_state, step_fn=step_fn,
                         data_state=data.state_dict,
                         restore_data=data.load_state_dict, device=device,
                         ckpt_timings=timings)
        try:
            sup.run()
        except EndRun:
            pass
        wall = time.perf_counter() - t0
        launches = repro_torch.launch_counts()
    finally:
        torch.use_deterministic_algorithms(prev)
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    with open(os.path.join(ckdir, "step_00000003", "manifest.json")) as f:
        man = json.load(f)
    stored = sum(leaf["stored_bits"] for leaf in man["leaves"])
    raw = sum(int(np.prod(leaf["shape"])) * (
        2 if leaf["dtype"] == "bfloat16" else np.dtype(leaf["dtype"])
        .itemsize) * 8 for leaf in man["leaves"])
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    n_saves, n_restores = 1, sup.restarts
    sv, rs = timings["save"], timings["restore"]
    out = {"layers": layers, "restarts": sup.restarts,
           "steps_logged": rec["steps"], "wall_s": wall,
           "restored_bit_exact": rec.get("restored") == rec.get("saved"),
           "leaves": len(rec.get("saved") or []),
           "cursor": [rec.get("cursor_saved"), rec.get("cursor_restored")],
           "replayed_losses_equal": all(
               len(set(rec["loss"][i])) == 1 and len(rec["loss"][i]) == 2
               for i in (3, 4)),
           "loss": {i: v for i, v in rec["loss"].items()},
           "ckpt_stored_over_raw": stored / raw, "ckpt_raw_bytes": raw // 8,
           "compressed_leaves": sum(leaf["codec"] == "apack_byteplane"
                                    for leaf in man["leaves"]),
           "save_s": {k: v / n_saves for k, v in sv.items()},
           "save_host_s": (sv.get("snapshot", 0) + sv.get("total", 0)
                           - sv.get("encode", 0)) / n_saves,
           "save_kernel_s": sv.get("encode", 0) / n_saves,
           "restore_s": rs, "restore_host_s": rs.get("total", 0)
           - rs.get("decode", 0), "restore_kernel_s": rs.get("decode", 0),
           "launches_per_save": launches["apack_encode"] / n_saves,
           "launches_per_restore": launches["apack_decode"]
           / max(n_restores, 1)}
    print("train restart (j): " + json.dumps(out))
    finite = all(np.isfinite(v) for d in (rec["loss"], rec["grad_norm"])
                 for vs in d.values() for v in vs)
    if sup.restarts != 1 or out["steps_logged"] != [1, 2, 3, 4, 5, 4, 5]:
        raise AssertionError(f"train restart: restarts {sup.restarts}, "
                             f"steps {out['steps_logged']}")
    if not out["restored_bit_exact"] or out["cursor"] != [{"step": 3}] * 2:
        raise AssertionError("train restart: the restored state or data "
                             "cursor differs from the saved one")
    if not out["replayed_losses_equal"] or not finite:
        raise AssertionError(f"train restart: replayed losses differ or are "
                             f"not finite: {rec['loss']}")
    if launches["apack_encode"] < 1 or launches["apack_decode"] < 1:
        raise AssertionError(f"train restart: the checkpoint ran no kernel "
                             f"({launches})")
    return out


def train_smoke_run(arch: str, dev) -> dict:
    """Three training steps of ``arch`` SMOKE on ``dev`` (phase 10: card
    against the CPU): seed-0 params drawn on the CPU, 8-bit moments at the
    default schedule (its warmup keeps the first steps small, so the two
    devices' trajectories stay within their bf16 roundings), ``SyntheticLM``
    batches of 4 x 64.  Returns the losses and grad norms."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models.model import init_params
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    cfg = get_smoke_config(arch)
    params = _on(init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                 dev)
    ocfg = AdamWConfig(state_dtype="int8")
    state = init_state(ocfg, params)
    data = SyntheticLM(DataConfig(batch_size=4, seq_len=64,
                                  vocab_size=cfg.vocab_size))
    step = make_train_step(cfg, ocfg)
    out = {"loss": [], "grad_norm": []}
    for _ in range(3):
        b = {"tokens": torch.from_numpy(data.next_batch()["tokens"]).to(dev)}
        params, state, m = step(params, state, b)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    return out


def train_smoke_vs_cpu(device, twins: dict, arch: str) -> None:
    c, d = twins[("train", arch)], train_smoke_run(arch, device)
    rel = max(abs(a - b) / abs(b) for a, b in zip(d["loss"], c["loss"]))
    print(f"smoke training [{arch}] card vs cpu: losses {d['loss']} vs "
          f"{c['loss']} (largest relative difference {rel:.3g}, bound "
          f"{TRAIN_SMOKE_RTOL}), grad norms {d['grad_norm']} vs "
          f"{c['grad_norm']}")
    if not rel <= TRAIN_SMOKE_RTOL:
        raise AssertionError(f"SMOKE training [{arch}] on the card "
                             "disagrees with the CPU")


# ------------------------- sharded training, the mesh's robustness (slice 14)
TRAIN_MESH = (2, 2)
# (n)'s bounds on the sharded step against (j)'s single-device one: the
# loss and the global grad norm relative; every gradient leaf within
# SHARDED_GRAD_REL of its own norm against the single-device gradient of
# the same batch (a model shard's gradient lost or doubled parts a leaf
# by 30% or more); the params in units of the step's learning rate, under
# the reference test's 5e-2: the first AdamW step moves a param by about
# lr times the sign of its gradient, so SHARDED_PARAM_LR (a gradient near
# 0 can part by 2 lr) holds any first step and cannot fail by itself; the
# share of params within lr / 100 no lower than the control's (one
# device, the batch in two microbatches: the same sums in another order)
# by more than SHARDED_SHARE_SLACK.  On the card (NVIDIA H100 80GB HBM3,
# 700.00 W) the share was 0.9572 against the control's 0.9838 (the
# deepest layers' wq lowest) while the row-parallel partials were summed
# over the shards, 0.9837 with one product on the lead
# (``modules.tp_site``), and the largest gradient leaf's distance 0.0311
# of its norm (the deepest q_norm, a sum over every token and head)
SHARDED_LOSS_REL = 1e-3
SHARDED_GRAD_REL = 5e-2
SHARDED_PARAM_LR = 2.02
SHARDED_SHARE_SLACK = 0.05
CEILING = 5e-2
# (p)'s refresh: (a)'s settings with every queued page re-packed in the
# step that queues it (the mesh queues pages in another id order, so a
# budget would re-pack them in another order and move kv_ratio)
MESH_REFRESH_KW = dict(REFRESH_KW, kv_repack_budget=None)
# the mesh decodes 2 rows a data shard where one device decodes 4, and
# cuBLAS may round a bf16 GEMM otherwise at another M: an int8 KV value
# can part (not a token), and so can a page's coded bits.  Counts are
# held equal, coded bytes and kv_ratio within this share (32 bytes of 313
# MB parted on the card)
MESH_BYTES_REL = 1e-5


def param_agreement(got, ref, lr: float, names=None) -> dict:
    """How far the params ``got`` (tensors or ``Sharded``) lie from
    ``ref`` after one step of learning rate ``lr``: the largest
    difference, the shares within lr / 100 and lr / 10, and the five
    leaves with the lowest share within lr / 100."""
    from repro_torch import tree
    from repro_torch.models.sharding import Sharded
    worst, near, near10, total, leaves = 0.0, 0, 0, 0, []
    for i, (g, r) in enumerate(zip(tree.leaves(got), tree.leaves(ref))):
        g = g.gather() if isinstance(g, Sharded) else g
        d = (g.float() - r.float()).abs()
        worst = max(worst, float(d.max()))
        k = int((d <= lr / 100).sum())
        near += k
        near10 += int((d <= lr / 10).sum())
        total += d.numel()
        leaves.append((k / d.numel(), names[i] if names else i))
        del d
    return {"max_param_diff": worst, "max_param_diff_over_lr": worst / lr,
            "share_within_lr_over_100": near / total,
            "share_within_lr_over_10": near10 / total,
            "lowest_leaves": sorted(leaves)[:5]}


def sharded_train_phase(device, first: dict) -> dict:
    """(n) one training step of qwen3-1.7b at published widths and depth
    (28 layers, 8-bit AdamW) on ``make_debug_mesh(2, 2)``, every shard on
    the card: the seed-0 params drawn again (the draw (j) took), placed by
    ``param_shardings``, the moments laid out as their params, (j)'s first
    batch placed by ``batch_shardings``, under ``mesh_context``.  First a
    control on one device: the same step with the batch in two
    microbatches (``grad_accum=2``: the same sums in another order).
    The batch's gradients on one device (kept on the host) and on the
    mesh (``train_step.grads``): every leaf within ``SHARDED_GRAD_REL``
    of its norm.  Gates against (j)'s first step (``first``): the loss
    and the global grad norm within ``SHARDED_LOSS_REL``, every param
    within
    ``SHARDED_PARAM_LR`` lr, the share of params within lr / 100 no more
    than ``SHARDED_SHARE_SLACK`` below the control's, all under
    ``CEILING``; params and state back in their layout; each device
    holding less than the whole.  Prints the step's ms (and a second
    step's on the same batch), each device's bytes of params and moments
    against the single device's, the peak memory over the first step and
    both first steps' agreement with (j)'s."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharding as sh
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    from repro_torch.train.optimizer import Q8
    from repro_torch.train.train_step import grads
    cfg = get_config("qwen3-1.7b")
    mesh = make_debug_mesh(*TRAIN_MESH, device=device)
    ocfg = AdamWConfig(state_dtype="int8")
    want = first["metrics"]
    lr = want["lr"]
    torch.cuda.empty_cache()
    params = M.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(0), device)
    names = ["/".join(map(str, p)) for p, _ in _tree_paths(params)]
    batch = {"tokens": first["tokens"]}

    def nbytes_of(t):
        return sum(x.numel() * x.element_size() for x in tree.leaves(t))
    single = {"params": nbytes_of(params)}
    _, g = grads(cfg, params, batch)
    ref_grads = [x.to("cpu") for x in tree.leaves(g)]
    del g
    st1 = init_state(ocfg, params)
    single["moments"] = nbytes_of(st1["m"]) + nbytes_of(st1["v"])
    p2, _, m2 = make_train_step(cfg, ocfg, grad_accum=2)(params, st1, batch)
    control = {"loss": float(m2["loss"]), "grad_norm": float(m2["grad_norm"]),
               **param_agreement(p2, first["params"], lr, names)}
    del st1, p2
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ps = sh.place_tree(params, sh.param_shardings(mesh, params))
    del params
    bs = sh.place_tree(batch, sh.batch_shardings(mesh, batch))
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    with sh.mesh_context(mesh):
        _, g = grads(cfg, ps, bs)
    grad_rel = []
    for name, x, r in zip(names, tree.leaves(g), ref_grads):
        r = r.to(device)
        grad_rel.append((float((x.gather() - r).norm() / r.norm()), name))
    del g, ref_grads, r
    grad_rel.sort(reverse=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, ocfg)
    with sh.mesh_context(mesh):
        st = init_state(ocfg, ps)
        t0 = time.perf_counter()
        p1, s1, m1 = step(ps, st, bs)
        torch.cuda.synchronize()
        step_ms = [(time.perf_counter() - t0) * 1e3]
    peak = torch.cuda.max_memory_allocated()
    per_p = sh.device_bytes(ps)
    per_m = {k: sh.device_bytes(st["m"]).get(k, 0)
             + sh.device_bytes(st["v"]).get(k, 0) for k in per_p}
    del ps, st
    agree = param_agreement(p1, first.pop("params"), lr, names)
    layout = all(isinstance(x, sh.Sharded) for x in tree.leaves(p1)) and \
        all(isinstance(x, Q8) and isinstance(x.q, sh.Sharded)
            for x in tree.leaves(s1["m"], is_leaf=lambda x: isinstance(
                x, Q8)))
    # a second step on the same batch, timed: the first pays the
    # allocator's growth
    with sh.mesh_context(mesh):
        t0 = time.perf_counter()
        out2 = step(p1, s1, bs)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    del out2
    out = {"mesh": list(TRAIN_MESH), "layers": cfg.num_layers,
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "step_ms": step_ms,
           "place_s": place_s, "loss": [float(m1["loss"]), want["loss"]],
           "grad_norm": [float(m1["grad_norm"]), want["grad_norm"]],
           "lr": [float(m1["lr"]), lr],
           "max_grad_rel": grad_rel[0][0], "highest_grad_rel": grad_rel[:5],
           **agree,
           "control_grad_accum_2": control,
           "device_param_bytes": {",".join(map(str, k)): v
                                  for k, v in per_p.items()},
           "device_moment_bytes": {",".join(map(str, k)): v
                                   for k, v in per_m.items()},
           "single_device_bytes": single,
           "max_memory_gb": peak / 1e9, "layout_kept": layout}
    print(f"sharded train (n) [qwen3-1.7b, {cfg.num_layers} layers, 2x2 on "
          "one card]: " + json.dumps(out))
    del p1, s1
    torch.cuda.empty_cache()
    if not np.isfinite(out["loss"] + out["grad_norm"]).all():
        raise AssertionError("sharded train: non-finite loss or grad norm")
    for k in ("loss", "grad_norm"):
        a, b = out[k]
        if abs(a - b) > SHARDED_LOSS_REL * abs(b) or abs(a - b) >= CEILING:
            raise AssertionError(f"sharded train: {k} {a} vs (j)'s {b}")
    if out["lr"][0] != lr:
        raise AssertionError(f"sharded train: lr {out['lr']}")
    if not grad_rel[0][0] <= SHARDED_GRAD_REL:
        raise AssertionError(f"sharded train: gradients {grad_rel[:5]} "
                             "part from one device's")
    share = agree["share_within_lr_over_100"]
    if agree["max_param_diff"] > min(SHARDED_PARAM_LR * lr, CEILING) or \
            share < control["share_within_lr_over_100"] \
            - SHARDED_SHARE_SLACK:
        raise AssertionError(f"sharded train: params {agree} (control "
                             f"{control})")
    if not layout:
        raise AssertionError("sharded train: params or moments left their "
                             "layout")
    if max(per_p.values()) >= single["params"] or \
            max(per_m.values()) >= single["moments"]:
        raise AssertionError("sharded train: a device holds the whole tree")
    return out


# (r): qwen3-1.7b at published widths and depth on a 1x1 mesh of the
# card, each cell through ``specs.build_cell`` twice: counted with fake
# tensors (``launch.dryrun``'s mode, a 1x1 mesh of ``meta:0``) and run on
# the card under the same counter.  A decode cell of ``decode_32k``'s
# depth at 8 of its 128 rows (a 30 GB bf16 cache) and a prefill cell of
# ``prefill_32k``'s length at one row.  Gates: the counts equal op by op
# (calls, FLOPs, bytes); the placed trees' bytes within ARG_REL of what
# the allocator holds after placement; the counted peak within PEAK_BAND
# of ``max_memory_allocated`` over the call: on the card (NVIDIA H100
# 80GB HBM3, 700.00 W) the counted peak lay 0.09% (decode) and 0.008%
# (prefill) under the allocator's, which rounds each block up to 512 bytes
# and holds cuBLAS's workspace, neither of which the counter sees, and the
# argument bytes 0.003% and 0.015% under it.  The median of a cell's timed
# calls (the last entry of DRYRUN_CELLS; none for the 16 s prefill, whose
# counted call is timed instead, the counter's host work over its 151,194
# ops included) is printed beside ``max(compute_s, memory_s)`` at the
# H100's peaks, not gated.
DRYRUN_CELLS = (("decode", 32_768, 8, 3), ("prefill", 32_768, 1, 0))
ARG_REL = 0.01
PEAK_BAND = (0.98, 1.01)


def dryrun_phase(device) -> dict:
    """(r) the dry run held against the card (``DRYRUN_CELLS``)."""
    import numpy as np
    import torch
    from repro_torch.device import fake_device
    from repro_torch.launch import costs, dryrun, specs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models.config import ShapeConfig
    out = {}
    for kind, seq, rows, calls in DRYRUN_CELLS:
        shape = ShapeConfig(f"{kind}_32k", kind, seq, rows)
        t0 = time.perf_counter()
        fmesh = Mesh(np.array([[fake_device(0)]], dtype=object))
        with dryrun.fake_mode(), sh.mesh_context(fmesh):
            frec, _ = dryrun.count_cell("qwen3-1.7b", shape, fmesh, {},
                                        global_batch=rows)
        count_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        mesh = Mesh(np.array([[device]], dtype=object))
        with sh.mesh_context(mesh):
            cell = specs.build_cell("qwen3-1.7b", shape, mesh,
                                    global_batch=rows)
            specs.fill(cell, torch.Generator(device=device).manual_seed(0))
            torch.cuda.synchronize()
            args = specs.arg_bytes(cell)
            placed = torch.cuda.memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            counter = costs.CostCounter(args)
            with counter:
                t1 = time.perf_counter()
                res = cell.fn()
                torch.cuda.synchronize()
                counted_ms = (time.perf_counter() - t1) * 1e3
            peak = torch.cuda.max_memory_allocated() - base
            logits = res[0]
            finite = bool(torch.isfinite(logits).all())
            shape_ok = tuple(logits.shape) == (rows, 1, cell.cfg.vocab_size)
            del res, logits
            ms = []
            for _ in range(calls):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                res = cell.fn()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
                del res
        rrec = counter.record()
        fops, rops = costs.by_op(frec), costs.by_op(rrec)
        parted = {k: (fops.get(k), rops.get(k))
                  for k in set(fops) | set(rops) if fops.get(k) != rops.get(k)}
        roof = costs.roofline(frec, dryrun.H100)
        est_peak = max(frec["peak"].values())
        r = {"rows": rows, "seq": seq, "count_s": count_s,
             "ops": sum(v[0] for v in fops.values()),
             "flops": sum(v[1] for v in fops.values()),
             "bytes": sum(v[2] for v in fops.values()),
             "ops_parted": parted,
             "argument_bytes": sum(args.values()), "placed_bytes": placed,
             "estimated_peak_bytes": est_peak, "card_peak_bytes": peak,
             "peak_ratio": est_peak / max(peak, 1),
             "median_ms": float(np.median(ms)) if ms else counted_ms,
             "ms": ms, "counted_ms": counted_ms,
             "estimate_ms": max(roof["compute_s"], roof["memory_s"]) * 1e3,
             "compute_ms": roof["compute_s"] * 1e3,
             "memory_ms": roof["memory_s"] * 1e3, "finite": finite}
        print(f"dry run (r) [qwen3-1.7b {kind}, 28 layers, {rows} x {seq}, "
              "1x1 on the card]: " + json.dumps(r))
        del cell, counter
        torch.cuda.empty_cache()
        if parted:
            raise AssertionError(f"dry run (r) {kind}: the fake and the "
                                 f"card's counts part: {parted}")
        if abs(r["argument_bytes"] - placed) > ARG_REL * placed:
            raise AssertionError(f"dry run (r) {kind}: argument bytes "
                                 f"{r['argument_bytes']} vs {placed} placed")
        if not PEAK_BAND[0] <= r["peak_ratio"] <= PEAK_BAND[1]:
            raise AssertionError(f"dry run (r) {kind}: estimated peak "
                                 f"{est_peak} vs the card's {peak}")
        if not (finite and shape_ok):
            raise AssertionError(f"dry run (r) {kind}: logits not finite "
                                 "or of the wrong shape")
        out[kind] = r
    return out


def _tree_paths(t, path=()):
    """``(path, leaf)`` of a param tree in ``tree.leaves`` order."""
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _tree_paths(t[k], path + (k,))
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            yield from _tree_paths(v, path + (i,))
    else:
        yield path, t


def elastic_restore_phase(device) -> dict:
    """(o) elastic restore: xlstm-125m at published widths and depth (12
    layers, seed-0 f32 params on the card; the reference test's arch)
    placed on ``make_debug_mesh(2, 2)`` and saved compressed (its planes
    coded on the card through kernel 2), then the unsharded params saved
    compressed beside it; the checkpoint restored onto 1x4, 4x1 (``restore
    (shardings=)``, kernel 1) and onto the single device.  Gates: the two
    saves' files byte-equal, every restored leaf bit-equal in its
    placement, kernels 2 and 1 launched.  Prints the save and restore
    seconds and the kernels' launches a save and a restore."""
    import filecmp
    import shutil
    import torch
    import repro_torch
    from repro_torch import tree
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharding as sh
    cfg = get_config(XLSTM)
    params = M.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(0), device)
    root = os.path.join(HERE, "build", "ckpt_elastic")
    shutil.rmtree(root, ignore_errors=True)
    dirs = {k: os.path.join(root, k) for k in ("mesh", "single")}
    m22 = make_debug_mesh(2, 2, device=device)
    ps = sh.place_tree(params, sh.param_shardings(m22, params))
    out = {"arch": XLSTM, "layers": cfg.num_layers,
           "params": sum(x.numel() for x in tree.leaves(params)),
           "save_s": {}, "restore_s": {}, "launches": {}}
    for key, t in (("mesh", ps), ("single", params)):
        repro_torch.reset_launch_counts()
        t0 = time.perf_counter()
        ckpt.save(dirs[key], 1, t, compress=True, device=device)
        out["save_s"][key] = time.perf_counter() - t0
        out["launches"][f"save {key}"] = repro_torch.launch_counts()[
            "apack_encode"]
    a, b = (os.path.join(dirs[k], "step_00000001") for k in ("mesh",
                                                             "single"))
    names = sorted(os.listdir(b))
    equal = sorted(os.listdir(a)) == names and all(
        filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False)
        for n in names)
    bit_equal = {}
    for shape in ((1, 4), (4, 1), None):
        key = "single" if shape is None else f"{shape[0]}x{shape[1]}"
        repro_torch.reset_launch_counts()
        t0 = time.perf_counter()
        if shape is None:
            back, _, _ = ckpt.restore(dirs["mesh"], device=device)
            leaves = tree.leaves(back)
        else:
            shs = sh.param_shardings(make_debug_mesh(*shape, device=device),
                                     params)
            back, _, _ = ckpt.restore(dirs["mesh"], shardings=shs)
            leaves = [x.gather() for x in tree.leaves(back)]
            if [x.spec for x in tree.leaves(back)] != \
                    [s.spec for s in tree.leaves(shs)]:
                raise AssertionError(f"elastic restore {key}: placement")
        torch.cuda.synchronize()
        out["restore_s"][key] = time.perf_counter() - t0
        out["launches"][f"restore {key}"] = repro_torch.launch_counts()[
            "apack_decode"]
        bit_equal[key] = all(torch.equal(x, y) for x, y in
                             zip(leaves, tree.leaves(params)))
        del back, leaves
    with open(os.path.join(a, "manifest.json")) as f:
        man = json.load(f)
    out.update(files=len(names), files_byte_equal=equal,
               bit_equal=bit_equal, compressed_leaves=sum(
                   leaf["codec"] == "apack_byteplane"
                   for leaf in man["leaves"]))
    shutil.rmtree(root, ignore_errors=True)
    print("elastic restore (o) [xlstm-125m, 2x2 -> 1x4, 4x1, one device]: "
          + json.dumps(out))
    if not equal:
        raise AssertionError("elastic restore: the mesh's save differs from "
                             "the single device's")
    if not all(bit_equal.values()):
        raise AssertionError(f"elastic restore: leaves differ {bit_equal}")
    if min(out["launches"].values()) < 1:
        raise AssertionError(f"elastic restore: a save or restore ran no "
                             f"kernel ({out['launches']})")
    return out


def count_shard_repacks(rec: dict):
    """``setup(eng)`` for (p)'s refresh serve: each re-pack batch records
    the data shards holding its pages, its pages, and the launches that
    kernel 1's and kernel 2's wrappers counted meanwhile."""
    import repro_torch

    def setup(eng):
        kv = eng.kv
        launch = kv._launch_repack

        def counted(items, force):
            shards = sorted({kv.pool.shard_of(p) for _, p in items})
            before = repro_torch.launch_counts()
            job = launch(items, force)
            after = repro_torch.launch_counts()
            rec.setdefault("batches", []).append(
                {"shards": shards, "pages": len(items),
                 **{k: after[k] - before[k]
                    for k in ("apack_decode", "apack_encode")}})
            return job
        kv._launch_repack = counted
    return setup


def mesh_fault_hook(rec: dict):
    """``hook(eng, i)`` for (p)'s fault serve: once attention layer 0's
    drift sketch holds its minimum pages, flip a bit of a PACKED page of
    that layer held by a request on data shard 1 with at least 24 tokens
    still to decode (every model shard's copy), and lower the refresh
    trigger to the pages the sketch holds, so that the layer's next seal
    refreshes it and the re-pack verifies the page (when a refresh fires
    moves coded sizes, never tokens)."""
    from repro_torch.models.modules import PAGE_PACKED

    def hook(eng, i):
        kv = eng.kv
        layer = kv.attn_layers[0]
        drift = int(kv.drift_pages[layer])
        if "rid" in rec or kv.tables[layer][0] is None or \
                drift < kv.refresh_min_pages:
            return
        for r in eng.active:
            if (r is None or kv.request_shard.get(r.rid) != 1
                    or r.max_new_tokens - len(r.tokens) < 24):
                continue
            pids = [p for p in kv.page_tables[r.rid][layer]
                    if p >= 0 and kv.pool.state[p] == PAGE_PACKED]
            if pids:
                eng.faults.corrupt_packed_page(kv, pids[0])
                kv.refresh_every_pages = drift
                rec.update(rid=r.rid, pid=pids[0], step=i)
                return
    return hook


def mesh_robustness_phase(device) -> dict:
    """(p) the serving mesh's robustness options: qwen3-1.7b at published
    widths, ``CUT_LAYERS`` layers, on ``make_debug_mesh(2, 2)`` (4 slots, 2
    a data shard), against the single-device engine at the same depth.

    Refresh: phase 3's requests then (a)'s phase B (one hot prompt) on one
    engine with ``MESH_REFRESH_KW``, on one device and on the mesh: tokens,
    refreshes, pages re-packed and kept, the generation and its rows
    equal, ``kv_ratio`` and the re-pack bytes within ``MESH_BYTES_REL``;
    each re-pack batch launched kernels 1
    and 2 once a data shard holding its pages (``count_shard_repacks``),
    and some batch held pages of both shards.  Pressure: phase 3's
    requests with ``kv_pressure`` and a 16-step slot deadline, the pool cut
    to 1.5 requests' pages a data shard: level 2 preempts, every preempted
    request resumes, tokens equal the single device's.  Verify and faults:
    ``kv_verify_on_repack``, refresh, and one ``corrupt_packed_page`` on a
    page of data shard 1 (``mesh_fault_hook``): that request fails with
    ``PageIntegrityError``, every other one finishes with the single
    device's tokens.  Returns the mesh's re-pack launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import PagedKVCache
    from repro_torch.serve import FaultInjector
    mesh = make_debug_mesh(2, 2, device=device)
    runs = {}
    rec: dict = {}
    for key, kw in (("single", {}), ("mesh", {"mesh": mesh})):
        run = serve_full_width(
            device, layers=CUT_LAYERS, engine_kw=dict(MESH_REFRESH_KW, **kw),
            setup=count_shard_repacks(rec) if kw else None,
            label="dense, refresh")
        eng = run["eng"]
        b = drive(eng, hot_requests(run["cfg"], np.random.default_rng(5)),
                  tag=f"(p) refresh phase B, {key}")
        st, kv = eng.stats, eng.kv
        runs[key] = {
            "tokens": [r.tokens for r in run["reqs"]] + b["tokens"],
            "a_tokens": [r.tokens for r in run["reqs"]],
            **{k: st[k] for k in ("kv_refreshes", "kv_pages_repacked",
                                  "steps")},
            "generation": kv.generation, "gen_rows": kv.gen_rows,
            "kv_ratio": eng.kv_stats()["kv_ratio"],
            "kv_repack": eng.kv_stats()["kv_repack"],
            "median_step_ms": [run["summary"]["median_step_ms"],
                               b["median_step_ms"]]}
        del run, eng, kv
        torch.cuda.empty_cache()
    single, meshed = runs["single"], runs["mesh"]
    batches = rec.get("batches", [])
    res = {"layers": CUT_LAYERS, "settings": MESH_REFRESH_KW,
           "refresh": {k: {key: runs[key][k] for key in runs}
                       for k in ("kv_refreshes", "kv_pages_repacked",
                                 "generation", "kv_ratio", "kv_repack",
                                 "median_step_ms")},
           "repack_batches": batches,
           "repack_launches_per_shard_batch": {
               k: sum(bt[k] for bt in batches)
               / max(sum(len(bt["shards"]) for bt in batches), 1)
               for k in ("apack_decode", "apack_encode")},
           "repack_launches_per_step": {
               k: sum(bt[k] for bt in batches) / meshed["steps"]
               for k in ("apack_decode", "apack_encode")}}
    if meshed["tokens"] != single["tokens"]:
        raise AssertionError("(p) refresh: the mesh's tokens differ from the "
                             "single device's")
    exact = [(k, meshed[k], single[k]) for k in (
        "kv_refreshes", "kv_pages_repacked", "generation", "gen_rows")]
    exact += [(f"kv_repack {k}", meshed["kv_repack"][k],
               single["kv_repack"][k]) for k in single["kv_repack"]
              if not k.endswith("_bytes")]
    close = [("kv_ratio", meshed["kv_ratio"], single["kv_ratio"])]
    close += [(f"kv_repack {k}", meshed["kv_repack"][k],
               single["kv_repack"][k]) for k in single["kv_repack"]
              if k.endswith("_bytes")]
    for k, a, b in exact:
        if a != b:
            raise AssertionError(f"(p) refresh: {k} {a} on the mesh, {b} on "
                                 "one device")
    for k, a, b in close:
        if abs(a - b) > MESH_BYTES_REL * abs(b):
            raise AssertionError(f"(p) refresh: {k} {a} on the mesh, {b} on "
                                 "one device")
    if not (single["kv_refreshes"] > 0 and batches):
        raise AssertionError("(p) refresh: no refresh or re-pack")
    if any(bt["apack_decode"] != len(bt["shards"])
           or bt["apack_encode"] != len(bt["shards"]) for bt in batches):
        raise AssertionError("(p) refresh: a re-pack batch did not launch "
                             "kernels 1 and 2 once a shard")
    if not any(len(bt["shards"]) == 2 for bt in batches):
        raise AssertionError("(p) refresh: no re-pack batch held pages of "
                             "both data shards")
    # pressure: 1.5 requests' worst-case pages a data shard
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              num_layers=CUT_LAYERS)
    per_req = PagedKVCache.pages_for_config(cfg, 160, 16)
    pages = 2 * (3 * per_req // 2)
    run = serve_full_width(device, layers=CUT_LAYERS, engine_kw=dict(
        PRESSURE_KW, mesh=mesh, kv_pages=pages), label="dense, pressure")
    eng = run["eng"]
    st = eng.stats
    res["pressure"] = {"kv_pages": pages, "per_request_pages": per_req,
                       **{k: st[k] for k in (
                           "preempted", "resumed", "spilled_requests",
                           "pressure_preempted", "deadline_preempted",
                           "failed")},
                       "spill": eng.kv_stats()["kv_spill"],
                       "median_step_ms": run["summary"]["median_step_ms"]}
    if [r.tokens for r in run["reqs"]] != single["a_tokens"]:
        raise AssertionError("(p) pressure: tokens differ from the single "
                             "device's")
    if not (st["pressure_preempted"] > 0
            and st["resumed"] == st["preempted"] and st["failed"] == 0
            and eng.kv.pool.free_count == eng.kv.pool.num_pages):
        raise AssertionError(f"(p) pressure: {res['pressure']}")
    del run, eng
    torch.cuda.empty_cache()
    # verify and faults
    frec: dict = {}
    inj = FaultInjector()
    run = serve_full_width(
        device, layers=CUT_LAYERS, hook=mesh_fault_hook(frec),
        engine_kw=dict(MESH_REFRESH_KW, mesh=mesh, faults=inj,
                       kv_verify_on_repack=True),
        label="dense, verify and a fault", allow_failed=True)
    reqs, eng = run["reqs"], run["eng"]
    failed = [r.rid for r in reqs if r.error]
    others = all(r.tokens == t for r, t in zip(reqs, single["a_tokens"])
                 if r.rid != frec.get("rid"))
    res["fault"] = {**frec, "failed": failed,
                    "error": next((r.error for r in reqs if r.error), None),
                    "others_equal": others,
                    "integrity_failures":
                        eng.kv_stats()["kv_integrity_failures"],
                    "bits_flipped": inj.stats["bits_flipped"]}
    del run, eng
    torch.cuda.empty_cache()
    print(f"mesh robustness (p) [qwen3-1.7b, {CUT_LAYERS} layers, 2x2]: "
          + json.dumps(res))
    if "rid" not in frec or failed != [frec["rid"]] or \
            "checksum" not in (res["fault"]["error"] or "") or not others:
        raise AssertionError(f"(p) fault: {res['fault']}")
    return res


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
    (b) at the first and the last attention layer, the fused attention
        kernel's normalized output over the same pages equals dense
        attention over the materialized cache (a global layer's positions,
        a rolling layer's ring slots; computed in f64) within the existing
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
    ends = (0, len(kv.attn_layers) - 1)
    for i, layer in ((i, kv.attn_layers[i]) for i in ends):
        q = torch.randn(len(rids), h, dh, generator=g, device=eng.device)
        acc, _, l = fused_page_attention(
            q, meta["pid"][i], meta["tid"][i], meta["kmeta"][i],
            meta["qw"][i], kv.dev.planes,
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
        slot = torch.arange(sc.shape[-1], device=eng.device)
        if kv.layer_kinds[layer] == "local":
            # ring slot j holds the latest position p < qpos with
            # p % ring == j; the kernel reads p > qpos - ring
            ring = sc.shape[-1]
            p = qpos[:, None] - 1 - torch.remainder(
                qpos[:, None] - 1 - slot, ring)
            valid = (p >= 0) & (p > qpos[:, None] - ring)
        else:
            valid = slot < qpos[:, None]
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
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False")
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        return fail(f"{src}/repro_torch not found: run from a checkout")
    sys.path.insert(0, src)
    import repro_torch  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}")
    print(host_line())
    print(f"host cores: {os.cpu_count()}")
    twins: dict = {}            # the background process, once started
    try:
        return card_phases(t_script, twins)
    finally:
        proc = twins.get("proc")
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()


def card_phases(t_script: float, twins_run: dict) -> int:
    """Phases 1-12 (the module docstring) on the card; ``twins_run`` gets
    the background process of the CPU sides (``start_cpu_twins``)."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    device = torch.device("cuda", 0)
    laps: dict = {}
    t_lap = [t_script]

    def lap(name):                  # seconds of each phase, printed at the end
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now
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
    lap("1 build")
    records: dict = {}
    check_codec(device, records)
    check_fastpath_shapes(device, records)
    check_attention(device, records)
    check_decompress_matmul(device, records)
    check_gather(device, records)
    # phase 2 at recurrentgemma-9b's page [16, 1, 256]
    rg_records: dict = {}
    check_rg_codec(device, rg_records)
    check_gather(device, rg_records, s=32, key="gather_decode [16, 1, 256]")
    check_attention_rolling(device, rg_records)
    # kernels 1 and 2 at a re-pack batch, kernel 5 at recurrentgemma-9b's
    # packed sites
    new_records: dict = {}
    check_repack_batch(device, new_records)
    # and at a data shard's batch of (p)'s mesh re-pack (76-96 pages a
    # batch over 2 data shards)
    check_repack_batch(device, new_records, n=48)
    check_rg_matmul(device, new_records)
    # kernel 3 at minitron's, dbrx's and kimi's pages (head blocks past
    # 4096 values), kernel 5 at
    # minitron-8b's head and squared-ReLU FFN
    check_attention_heads(device, new_records)
    check_minitron_matmul(device, new_records)
    # kernel 3 on a mesh's model shards' head blocks, kernel 5 on a K half
    check_attention_head_shards(device, new_records)
    check_matmul_k_split(device, new_records)
    # kernels 2 and 1 at (j)'s checkpoint plane
    check_ckpt_plane(device, new_records)
    lap("2 kernel checks")
    # phase 3: dense weights, the fused KV path's three kernels
    sync_parts: dict = {}
    dense = serve_full_width(device, layers=28,
                             setup=host_parts(sync_parts))
    fused_tokens = [r.tokens for r in dense["reqs"]]
    # the refresh serve's frozen control: phase B on the same engine
    frozen = drive(dense["eng"], hot_requests(dense["cfg"],
                                              np.random.default_rng(5)))
    frozen["a_median_step_ms"] = dense["summary"]["median_step_ms"]
    profile_steady_steps(dense["eng"], dense["cfg"], dense["rng"], "dense")
    lap("3 fused serve, frozen phase B")
    # (q) the static analyzer, and the syncs the card reports in steady
    # decode steps of phase 3's engine against the boundary pass's sites
    sync_count_phase(dense["eng"], dense["cfg"], dense["rng"])
    lap("(q) analyzer, syncs")
    verify_packed(dense["snapshot"])
    sync_run = {"tokens": fused_tokens, **dense["summary"],
                "host_parts": host_medians(sync_parts)}
    del dense
    torch.cuda.empty_cache()
    # (e) the same requests on the async scheduler, slot 0 preempted with
    # spill
    async_per_step = async_qwen_phase(device, sync_run)
    torch.cuda.empty_cache()
    lap("(e) async serve")
    # (l) the same requests on a 2x2 mesh, every shard on the card
    mesh_run = mesh_phase(device, fused_tokens, sync_run)
    torch.cuda.empty_cache()
    lap("(l) mesh serve")
    # the CPU sides of phase 10 and (d) run from here on, in the
    # background: after the kernel checks, whose plain versions use every
    # core, and after the step times that (e) compares
    twins_run["proc"], twins_path = start_cpu_twins()
    # phase 4: the main path, packed weights at full depth; its checks
    # after the serve (sites, teacher-forced re-score) at the first
    # CUT_LAYERS layers
    packed = serve_full_width(device, layers=28, weights="apack-int8",
                              keep_sites=cut_sites(CUT_LAYERS))
    eng4 = packed["eng"]
    stores = oracle_stores({**eng4.params,
                            "blocks": eng4.params["blocks"][:CUT_LAYERS]},
                           packed.pop("host_weights"))
    ends = (0, CUT_LAYERS - 1)
    check_packed_sites(eng4, lambda i, grp, name, pw: (
        stores["oracle32"]["blocks"][i][grp][name].w if i in ends else None),
        f"qwen3-1.7b, layers 0 and {CUT_LAYERS - 1},")
    del eng4
    teacher_forced(packed, stores, layers=CUT_LAYERS)
    del stores
    torch.cuda.empty_cache()
    profile_steady_steps(packed["eng"], packed["cfg"], packed["rng"],
                         "packed")
    verify_packed(packed["snapshot"])
    launches = packed["launches"]
    lap("4 packed serve")
    # (m) packed weights K-split over a 1x2 mesh
    packed_mesh = packed_mesh_phase(device)
    torch.cuda.empty_cache()
    lap("(m) packed mesh")
    # (e) the main path on the async scheduler, from phase 4's planes
    async_k5 = async_packed(device, packed)
    del packed
    torch.cuda.empty_cache()
    lap("(e) async packed serve")
    # phase 5: the materialize oracle, calibrated from 20 pages so that
    # its first decode steps read HOT and COLD pages, its later ones HOT
    # and PACKED pages through the gather-decode kernel
    done: dict = {}
    oracle = serve_full_width(device, layers=CUT_LAYERS, fused=False,
                              calib_pages=20, hook=oracle_hook(done))
    if set(done) != {"cold", "packed"}:
        raise AssertionError(f"oracle gates ran only at {sorted(done)}")
    # its fused twin at the same depth, for the comparison
    cut = serve_full_width(device, layers=CUT_LAYERS, calib_pages=20)
    print(f"oracle vs fused serve ({CUT_LAYERS} layers): " + json.dumps({
        "token_agreement": token_agreement(
            [r.tokens for r in oracle["reqs"]],
            [r.tokens for r in cut["reqs"]]),
        "requests_identical": sum(r.tokens == t.tokens for r, t in
                                  zip(oracle["reqs"], cut["reqs"])),
        "first_step_max_logit_diff": (oracle["first_logits"]
                                      - cut["first_logits"]).abs().max()
        .item()}))
    cut_tokens = [r.tokens for r in cut["reqs"]]
    del cut
    profile_steady_steps(oracle["eng"], oracle["cfg"], oracle["rng"],
                         "oracle")
    verify_packed(oracle["snapshot"])
    launches["gather_decode"] = oracle["launches"]["gather_decode"]
    del oracle
    torch.cuda.empty_cache()
    lap("5 oracle serve")
    # phase 6: preempt and resume on the fused path, at phase 5's fused
    # twin's depth (tables differ, tokens cannot: the coder is lossless)
    pre = serve_full_width(device, layers=CUT_LAYERS, hook=preempt_hook)
    st = pre["eng"].stats
    print(f"preempt serve: preempted {st['preempted']} resumed "
          f"{st['resumed']}")
    if st["preempted"] != 1 or st["resumed"] != 1:
        raise AssertionError("preempt serve: slot 0 was not preempted and "
                             "resumed once")
    if [r.tokens for r in pre["reqs"]] != cut_tokens:
        raise AssertionError("preempt serve: tokens differ from the "
                             "uninterrupted fused serve")
    del pre
    torch.cuda.empty_cache()
    lap("6 preempt serve")
    # phase 7: the uncompressed baseline, a dense int8 KV cache
    dense8 = serve_full_width(device, layers=CUT_LAYERS, kv="int8")
    profile_steady_steps(dense8["eng"], dense8["cfg"], dense8["rng"],
                         "int8 KV")
    del dense8
    torch.cuda.empty_cache()
    lap("7 int8 KV serve")
    # phase 8: the JAX CLI's default weight path, compress_params ->
    # decompress_params, then a fused serve from the round-tripped weights
    rt_params = weight_round_trip(device)[0]
    rt_params["blocks"] = rt_params["blocks"][:CUT_LAYERS]
    rt = serve_full_width(device, layers=CUT_LAYERS, params=rt_params,
                          label="round-trip")
    del rt_params
    verify_packed(rt["snapshot"])
    del rt
    torch.cuda.empty_cache()
    lap("8 round trip")
    # (a) table refresh and re-pack, (b) pool pressure and the spill tier
    refresh = refresh_phase(device, frozen, fused_tokens)
    torch.cuda.empty_cache()
    lap("(a) refresh serve")
    pressure_phase(device, fused_tokens)
    torch.cuda.empty_cache()
    lap("(b) pressure serve")
    # (p) refresh, pressure, verify and a fault on a 2x2 serving mesh
    mesh_rob = mesh_robustness_phase(device)
    lap("(p) mesh robustness")
    # recurrentgemma-9b at full width: rolling attention, RG-LRU layers,
    # page eviction and state snapshots; (c) from packed weights
    rg_launches, rg_k5 = recurrentgemma_phase(device)
    lap("9 recurrentgemma-9b, (c)")
    # (g) minitron-8b at published widths and depth, (h) dbrx-132b at
    # published widths, 2 layers, and hubert-xlarge's forward
    attn = tuple(("inner", n) for n in ("wq", "wk", "wv", "wo"))
    mini = new_arch_phase(device, "minitron-8b", "g", sites=attn + (
        ("ffn", "w_up"), ("ffn", "w_down")),
        fused_layers=MINITRON_FUSED_LAYERS)
    lap("(g) minitron-8b")
    dbrx = new_arch_phase(device, "dbrx-132b", "h", layers=DBRX_LAYERS,
                          sites=attn)
    lap("(h) dbrx-132b")
    hubert_phase(device)
    lap("hubert-xlarge")
    # (i) xlstm-125m served, (j) qwen3-1.7b trained and restarted from its
    # compressed checkpoint, (k) xlstm-125m trained
    xl = xlstm_phase(device)
    lap("(i) xlstm-125m")
    first: dict = {}
    train_steps(device, "qwen3-1.7b", 4, "train (j) [qwen3-1.7b, 28 layers]",
                profile=2, keep_first=first)
    lap("(j) qwen3-1.7b training")
    # (n) (j)'s first step on a 2x2 training mesh
    sharded_train_phase(device, first)
    del first
    torch.cuda.empty_cache()
    lap("(n) sharded training")
    restart = train_restart(device, CUT_LAYERS)
    lap("(j) restart")
    train_steps(device, XLSTM, 2, f"train (k) [{XLSTM}, 12 layers]")
    lap("(k) xlstm-125m training")
    # (o) a checkpoint saved from a 2x2 mesh restored onto other meshes
    elastic = elastic_restore_phase(device)
    lap("(o) elastic restore")
    # (r) the dry run's counts against the card's memory and time
    dryrun_phase(device)
    lap("(r) dry run on the card")
    twins = wait_cpu_twins(twins_run["proc"], twins_path)
    lap("10 wait for the CPU twins")
    tokens = {key: smoke_vs_cpu(device, twins, key)
              for key, _ in SMOKE_CASES if key[0] == "qwen3-1.7b"}
    if tokens["qwen3-1.7b", "dense", "oracle"] != \
            tokens["qwen3-1.7b", "dense", "fused"]:
        raise AssertionError("SMOKE oracle engine on the card disagrees with "
                             "the fused engine on the card")
    async_smoke_vs_cpu(device, twins, "qwen3-1.7b")
    for arch in TRAIN_SMOKE_ARCHS:
        train_smoke_vs_cpu(device, twins, arch)
    lap("10 SMOKE qwen3, training")
    for key, _ in SMOKE_CASES:
        if key[0] != "qwen3-1.7b":
            smoke_vs_cpu(device, twins, key)
    lap("10 SMOKE other stacks")
    # (d) refresh, pressure and a fault run, and the async engine on the
    # heterogeneous stack, card against CPU
    smoke_robustness_vs_cpu(device, twins)
    async_smoke_vs_cpu(device, twins, "hetero-serve-smoke")
    lap("(d) SMOKE robustness")
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
    # launches a step of this slice's paths: the re-pack batches of the
    # refresh serve (one launch of kernels 1 and 2 each), kernel 5 in the
    # packed recurrentgemma-9b serve
    extra = {"apack_decode": {"repack_launches_per_step":
                              refresh["apack_decode"]},
             "apack_encode": {"repack_launches_per_step":
                              refresh["apack_encode"]},
             "decompress_matmul": {"recurrentgemma_launches_per_step":
                                   rg_k5,
                                   "async_launches_per_step": async_k5}}
    # kernels 1 and 2 in (j)'s compressed checkpoint and (i)'s snapshot
    extra["apack_encode"].update(
        checkpoint_launches_per_save=restart["launches_per_save"],
        xlstm_preempt_launches=xl["preempt_launches"]["apack_encode"])
    extra["apack_decode"].update(
        checkpoint_launches_per_restore=restart["launches_per_restore"],
        xlstm_preempt_launches=xl["preempt_launches"]["apack_decode"])
    # launches a step of the async serve (e)
    for name in ("apack_decode", "apack_encode", "fused_page_attention"):
        extra.setdefault(name, {})["async_launches_per_step"] = \
            async_per_step[name]
    # kernels 1, 2 and 3 a step of the mesh serve (l), kernel 5 a step of
    # the packed mesh check (m)
    for name in ("apack_decode", "apack_encode", "fused_page_attention"):
        extra[name]["mesh_launches_per_step"] = \
            mesh_run["launches_per_step"][name]
    extra["decompress_matmul"]["mesh_launches_per_step"] = \
        packed_mesh["decompress_matmul_launches_per_step"]
    # kernels 1 and 2 in (p)'s re-pack batches on the mesh (a launch each
    # a data shard a batch) and in (o)'s saves and restores
    for name in ("apack_decode", "apack_encode"):
        extra[name]["mesh_repack_launches_per_shard_batch"] = \
            mesh_rob["repack_launches_per_shard_batch"][name]
        extra[name]["mesh_repack_launches_per_step"] = \
            mesh_rob["repack_launches_per_step"][name]
    extra["apack_encode"]["elastic_launches_per_save"] = \
        elastic["launches"]["save mesh"]
    extra["apack_decode"]["elastic_launches_per_restore"] = \
        elastic["launches"]["restore 1x4"]
    # kernels 3 and 5 a step of (g) (fused, packed) and (h)
    for tag, run in (("minitron", mini), ("dbrx", dbrx)):
        for name, n in run["launches_per_step"].items():
            extra[name][f"{tag}_launches_per_step"] = n
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
                        "library_ms": r["library_ms"],
                        **extra.get(name, {})})
    print("kernels at recurrentgemma-9b's page [16, 1, 256]: " + json.dumps(
        {"records": rg_records, "serve_launches": rg_launches}))
    print("kernels at the re-pack batch, recurrentgemma-9b's packed sites, "
          "minitron-8b's, dbrx's and kimi's pages, minitron-8b's packed "
          "sites and (j)'s checkpoint plane: "
          + json.dumps(new_records))
    print(f"phase seconds: {json.dumps(laps)}")
    print(f"script: {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-twins"]:
        sys.exit(cpu_twins(sys.argv[2]))
    sys.exit(main())
