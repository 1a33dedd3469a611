"""Serving CLI: batched requests against APack-compressed weights and
(optionally) a paged APack-compressed KV cache.

Port of ``repro/launch/serve.py``.  On the card (the default):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --smoke --requests 16 --prompt-len 32 --max-new 16 --kv apack-int8

``--arch`` takes every decoder of ``configs.all_arch_ids()``:
qwen3-1.7b, minitron-4b and minitron-8b (squared-ReLU MLP, untied head),
command-r-plus-104b (parallel blocks), paligemma-3b (served on text, the
gemma-scaled embeddings), dbrx-132b and kimi-k2-1t-a32b (top-k MoE),
recurrentgemma-9b (rolling attention and RG-LRU recurrent layers),
xlstm-125m (mLSTM and sLSTM layers, no pages: its states ride the state
store) or hetero-serve-smoke (a global + rolling + recurrent cycle after
a recurrent prefix layer).  hubert-xlarge, an encoder, has no decode path
and is refused.  ``--window-size`` sets the rolling layers' window, so a
small one shows page eviction.

By default (neither ``--weights`` nor ``--no-compress``) the weights make
the checkpoint-style round trip first, as in the JAX CLI:
``compress_params`` int8-quantizes and APack-codes every large matrix
(the encode kernel), prints the compression line, and
``decompress_params`` decodes them back to dense (the decode kernel).
``--weights apack-int8`` serves from APack-packed weights instead, every
matmul on them through the decompress-matmul kernel, on any served
stack; ``--no-compress`` serves the dense weights as they are.  ``--kv-materialize`` serves the
paged cache through the materialize oracle (a dense int8 cache rebuilt
from the pool every step) instead of the fused path; ``--kv int8`` or
``--kv bfloat16`` serves a dense cache, the raw-KV baseline.  ``--device
cpu`` runs the same paths through the kernels' plain versions.
``--kv-refresh`` (with ``--kv-refresh-every``, ``--kv-refresh-threshold``
and ``--kv-repack-budget``) re-fits the KV tables to drifting traffic and
re-packs pages under them; ``--kv-pages`` below the worst case with
``--kv-pressure`` and ``--slot-deadline`` serves under pool pressure
through the host spill tier.  ``--scheduler async`` serves through the
event loop (host work overlapped with the step in flight, prefills
ingested ``--prefill-chunk`` tokens a step), and ``--slo-ms`` gives every
request a latency SLO, which orders admission by earliest deadline.
``--mesh DATAxMODEL`` serves on a mesh of that shape with every shard on
``--device`` (``launch.mesh.make_debug_mesh``; the fused paged apack-int8
KV on the sync scheduler): the page pool and the slots split over the
data shards, KV heads and packed weights' K ranges over the model shards;
it prints the mesh and its devices, as the JAX CLI does (``serve.py``
:94-131).  On the CPU:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --smoke --kv apack-int8 --no-compress --mesh 2x2 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve
from repro_torch.kernels.decompress_matmul import DEFAULT_WEIGHT_MIN_SIZE
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as M
from repro_torch.serve import (Request, ServeEngine, compress_params,
                               decompress_params)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--no-compress", action="store_true",
                    help="serve the dense weights as they are")
    ap.add_argument("--weights", default=None, choices=["apack-int8"],
                    help="serve from APack-packed weights: large "
                         "projection/FFN matrices live on the device as "
                         "compressed planes and every matmul on them runs "
                         "through the decompress-matmul kernel")
    ap.add_argument("--weight-min-size", type=int,
                    default=DEFAULT_WEIGHT_MIN_SIZE,
                    help="smallest element count compressed by either "
                         "weight path (--weights and the checkpoint "
                         "round-trip share this one default)")
    ap.add_argument("--kv", default=None,
                    choices=["bfloat16", "int8", "apack-int8"],
                    help="KV-cache mode (apack-int8 = paged + compressed)")
    ap.add_argument("--kv-materialize", action="store_true",
                    help="use the materialize decode path (dense cache "
                         "rebuilt from the pool every step) instead of the "
                         "default device-resident fused path")
    ap.add_argument("--kv-page-size", type=int, default=16)
    ap.add_argument("--window-size", type=int, default=None,
                    help="override the rolling-attention window (small "
                         "values show page eviction on hybrid archs)")
    ap.add_argument("--kv-refresh", action="store_true",
                    help="adaptive table refresh: re-calibrate activation "
                         "tables from drift sketches and re-pack pages "
                         "when serving traffic drifts")
    ap.add_argument("--kv-refresh-every", type=int, default=None,
                    metavar="PAGES",
                    help="also refresh unconditionally every PAGES sealed "
                         "pages per layer (default: regression trigger "
                         "only)")
    ap.add_argument("--kv-refresh-threshold", type=float, default=0.15,
                    help="refresh when the drift sketch's expected coded "
                         "size regresses this fraction past the "
                         "calibration-time expectation")
    ap.add_argument("--kv-repack-budget", type=int, default=4,
                    help="most pages re-packed per decode step")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="page-pool size (default: worst case for "
                         "max_batch x max_len; smaller values exercise the "
                         "pressure/spill path)")
    ap.add_argument("--kv-pressure", action="store_true",
                    help="pressure escalation: blocked admission may "
                         "preempt active slots with spill (compressed host "
                         "spill tier, exponential backoff)")
    ap.add_argument("--slot-deadline", type=int, default=None,
                    metavar="STEPS",
                    help="preempt with spill any slot that decodes this "
                         "many steps while other requests queue")
    ap.add_argument("--scheduler", default="sync",
                    choices=["sync", "async"],
                    help="engine core: 'async' runs the event loop (host "
                         "work overlaps the step in flight, chunked "
                         "prefill, continuous admission); requires the "
                         "fused apack-int8 KV")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    metavar="TOKENS",
                    help="async scheduler: prompt tokens ingested per "
                         "overlapped step (default: 4 pages' worth)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request end-to-end latency SLO; admission "
                         "orders by earliest deadline instead of FIFO")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions (without a card, cuda raises)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="mesh-sharded serving, e.g. '2x2' (decode jobs "
                         "data-parallel, KV heads and packed weights' K "
                         "ranges tensor-parallel), every shard on --device; "
                         "requires the fused apack-int8 KV and the sync "
                         "scheduler")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if args.kv:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=args.kv)
    if args.window_size is not None:
        cfg = dataclasses.replace(cfg, window_size=args.window_size)
    M.check_decoder(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, device)
    if not args.no_compress and not args.weights:
        # checkpoint-style round trip: compress, report, decompress back to
        # dense.  --weights apack-int8 supersedes it: the packed planes are
        # the weight store, no decompressed copy exists.
        t0 = time.time()
        cp = compress_params(cfg, params, min_size=args.weight_min_size)
        print(f"APack weight compression: {cp.original_bytes/1e6:.1f} MB -> "
              f"{cp.compressed_bytes/1e6:.1f} MB "
              f"({cp.ratio:.2f}x, {time.time()-t0:.1f}s)")
        params = decompress_params(cp, device)
    mesh = None
    if args.mesh:
        n_data, _, n_model = args.mesh.partition("x")
        mesh = make_debug_mesh(int(n_data), int(n_model or 1), device=device)
        print(f"serving mesh: {mesh.shape} over {mesh.size} devices "
              f"({mesh.describe()})")
    engine = ServeEngine(cfg, params, max_batch=args.max_batch,
                         max_len=args.prompt_len + args.max_new + 8,
                         mesh=mesh,
                         weights=args.weights,
                         weight_min_size=args.weight_min_size,
                         kv_page_size=args.kv_page_size,
                         kv_pages=args.kv_pages,
                         kv_fused=not args.kv_materialize,
                         kv_refresh=args.kv_refresh,
                         kv_refresh_every_pages=args.kv_refresh_every,
                         kv_refresh_threshold=args.kv_refresh_threshold,
                         kv_repack_budget=args.kv_repack_budget,
                         kv_pressure=args.kv_pressure,
                         slot_deadline_steps=args.slot_deadline,
                         scheduler=args.scheduler,
                         prefill_chunk_tokens=args.prefill_chunk,
                         device=device)
    del params
    if args.weights:
        print(f"packed the weights in {engine.weight_pack_s:.1f}s")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        args.prompt_len).astype(np.int64),
                    max_new_tokens=args.max_new, slo_ms=args.slo_ms)
            for i in range(args.requests)]
    for r in reqs:
        engine.submit(r)
    t0 = time.time()
    engine.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    assert all(r.done for r in reqs)
    print(f"{engine.stats} in {dt:.1f}s "
          f"({engine.stats['generated']/max(dt, 1e-9):.1f} tok/s on "
          f"{device})")
    if args.weights:
        ws = engine.weight_stats()
        print(f"packed weight store: {ws['packed_tensors']} tensors, "
              f"{ws['native_bytes']/1e6:.1f} MB native -> "
              f"{(ws['payload_bytes'] + ws['scale_bytes'])/1e6:.1f} MB "
              f"compressed (payload {ws['payload_bytes']/1e6:.1f} MB + "
              f"scale {ws['scale_bytes']/1e6:.2f} MB); "
              f"per-step weight reads x{ws['weight_ratio']:.3f} vs int8 "
              f"dense, x{ws['native_ratio']:.3f} vs native")
    lat = engine.latency_stats()
    if lat["n"]:
        print(f"latency ({args.scheduler} scheduler, n={lat['n']}): "
              f"queue-wait p50={lat['queue_wait_p50']*1e3:.1f}ms "
              f"p99={lat['queue_wait_p99']*1e3:.1f}ms; "
              f"e2e p50={lat['e2e_p50']*1e3:.1f}ms "
              f"p99={lat['e2e_p99']*1e3:.1f}ms")
    if engine.paged:
        ks = engine.kv_stats()
        ratio = ("n/a (no KV reads)" if ks["kv_ratio"] is None
                 else f"{ks['kv_ratio']:.3f}")
        print(f"paged KV traffic: raw={ks['kv_raw_bytes']/1e3:.1f} kB -> "
              f"read={ks['kv_read_bytes']/1e3:.1f} kB "
              f"(+{ks['kv_table_bytes']} B tables) "
              f"ratio={ratio} "
              f"packed_pages={ks['kv_pages_packed']} "
              f"evicted_pages={ks['kv_pages_evicted']} "
              f"pool={ks['kv_pages_high_water']}/{ks['kv_pool_pages']} "
              "pages")
        for kind, st in ks["kv_streams"].items():
            if kind in ("repack", "spill"):          # their lines below
                continue
            r = st.get("ratio")
            print(f"  stream {kind:7s}: "
                  + " ".join(f"{k}={v}" for k, v in st.items()
                             if k != "ratio")
                  + (f" ratio={r:.3f}" if r is not None else " ratio=n/a"))
        rp = ks["kv_repack"]
        print(f"table refresh: {'on' if args.kv_refresh else 'off'}; "
              f"generation={rp['generation']} "
              f"refreshes={rp['refreshes']} "
              f"repacked={rp['pages']} pages "
              f"({rp['read_bytes']/1e3:.1f} kB read + "
              f"{rp['write_bytes']/1e3:.1f} kB written, "
              f"{rp['pending']} pending)")
        sp = ks["kv_spill"]
        spr = sp.get("ratio")
        print(f"spill tier: {sp['pages']} pages spilled "
              f"({sp['spill_bytes']/1e3:.1f} kB compressed vs "
              f"{sp['raw_bytes']/1e3:.1f} kB dense, "
              + (f"ratio={spr:.3f}" if spr is not None else "ratio=n/a")
              + f"); readahead {sp['readahead_pages']} pages "
              f"{sp['readahead_bytes']/1e3:.1f} kB; "
              f"parked={sp['live_records']} "
              f"quarantined={sp['quarantined']}; "
              f"spill_preempt={engine.stats['pressure_preempted']}"
              f"+{engine.stats['deadline_preempted']}ddl "
              f"failed={engine.stats['failed']}")
        tr = ks["transfers"]
        mode = ("fused (device-resident)" if ks["kv_fused"]
                else "materialize")
        print(f"decode path: {mode}; host<->device "
              f"h2d={tr['h2d_bytes']/1e3:.1f} kB "
              f"d2h={tr['d2h_bytes']/1e3:.1f} kB "
              f"({tr['h2d_calls']}/{tr['d2h_calls']} calls)")
    else:
        print(f"decode path: dense {cfg.kv_cache_dtype} KV cache")
    print("sample output:", reqs[0].tokens[:16])


if __name__ == "__main__":
    main()
