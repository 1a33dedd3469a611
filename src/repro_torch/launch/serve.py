"""Serving CLI: batched requests against APack-compressed weights and
(optionally) a paged APack-compressed KV cache.

Port of ``repro/launch/serve.py``.  On the card (the default):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --smoke --requests 16 --prompt-len 32 --max-new 16 --kv apack-int8

By default (neither ``--weights`` nor ``--no-compress``) the weights make
the checkpoint-style round trip first, as in the JAX CLI:
``compress_params`` int8-quantizes and APack-codes every large matrix
(the encode kernel), prints the compression line, and
``decompress_params`` decodes them back to dense (the decode kernel).
``--weights apack-int8`` serves from APack-packed weights instead, every
matmul on them through the decompress-matmul kernel; ``--no-compress``
serves the dense weights as they are.  ``--kv-materialize`` serves the
paged cache through the materialize oracle (a dense int8 cache rebuilt
from the pool every step) instead of the fused path; ``--kv int8`` or
``--kv bfloat16`` serves a dense cache, the raw-KV baseline.  ``--device
cpu`` runs the same paths through the kernels' plain versions.  The JAX
CLI's other flags are accepted and refused with ``NotImplementedError``
naming their ROADMAP item.
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
from repro_torch.models import model as M
from repro_torch.serve import (Request, ServeEngine, compress_params,
                               decompress_params)

# flags of the JAX CLI that the port does not serve yet: (flag, value
# that means "not asked for", ROADMAP item)
UNPORTED = (
    ("--window-size", None, "open item 1.7, heterogeneous stacks"),
    ("--kv-refresh", False, "open item 1.8, serving robustness"),
    ("--kv-refresh-every", None, "open item 1.8, serving robustness"),
    ("--kv-refresh-threshold", None, "open item 1.8, serving robustness"),
    ("--kv-repack-budget", None, "open item 1.8, serving robustness"),
    ("--kv-pressure", False, "open item 1.8, serving robustness"),
    ("--slot-deadline", None, "open item 1.8, serving robustness"),
    ("--scheduler", "sync", "open item 1.8, serving robustness (async "
     "scheduler)"),
    ("--prefill-chunk", None, "open item 1.8, serving robustness (async "
     "scheduler)"),
    ("--slo-ms", None, "open item 1.8, serving robustness (SLO admission)"),
    ("--mesh", None, "open item 1.10, multi-device serving"),
)
_FLAG_ARGS = {"--kv-refresh": dict(action="store_true"),
              "--kv-pressure": dict(action="store_true"),
              "--scheduler": dict(default="sync"),
              "--kv-refresh-every": dict(type=int),
              "--kv-repack-budget": dict(type=int),
              "--slot-deadline": dict(type=int),
              "--prefill-chunk": dict(type=int),
              "--window-size": dict(type=int),
              "--kv-refresh-threshold": dict(type=float),
              "--slo-ms": dict(type=float)}


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
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="page-pool size (default: worst case for "
                         "max_batch x max_len)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions (without a card, cuda raises)")
    for flag, _, item in UNPORTED:
        ap.add_argument(flag, help=f"not ported yet (ROADMAP {item})",
                        **_FLAG_ARGS.get(flag, {}))
    return ap.parse_args(argv)


def refuse_unported(args: argparse.Namespace) -> None:
    for flag, unset, item in UNPORTED:
        if getattr(args, flag[2:].replace("-", "_")) != unset:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP {item})")


def main(argv=None) -> None:
    args = parse_args(argv)
    refuse_unported(args)
    device = resolve(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if args.kv:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=args.kv)
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, device)
    if not args.no_compress and not args.weights:
        # checkpoint-style round trip: compress, report, decompress back to
        # dense.  --weights apack-int8 supersedes it: the packed planes are
        # the weight store, no decompressed copy exists.
        t0 = time.time()
        cp = compress_params(params, min_size=args.weight_min_size)
        print(f"APack weight compression: {cp.original_bytes/1e6:.1f} MB -> "
              f"{cp.compressed_bytes/1e6:.1f} MB "
              f"({cp.ratio:.2f}x, {time.time()-t0:.1f}s)")
        params = decompress_params(cp, device)
    engine = ServeEngine(cfg, params, max_batch=args.max_batch,
                         max_len=args.prompt_len + args.max_new + 8,
                         weights=args.weights,
                         weight_min_size=args.weight_min_size,
                         kv_page_size=args.kv_page_size,
                         kv_pages=args.kv_pages,
                         kv_fused=not args.kv_materialize, device=device)
    del params
    if args.weights:
        print(f"packed the weights in {engine.weight_pack_s:.1f}s")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        args.prompt_len).astype(np.int64),
                    max_new_tokens=args.max_new)
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
        print(f"latency (sync scheduler, n={lat['n']}): "
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
              f"pool={ks['kv_pages_high_water']}/{ks['kv_pool_pages']} "
              "pages")
        for kind, st in ks["kv_streams"].items():
            r = st.get("ratio")
            print(f"  stream {kind:7s}: "
                  + " ".join(f"{k}={v}" for k, v in st.items()
                             if k != "ratio")
                  + (f" ratio={r:.3f}" if r is not None else " ratio=n/a"))
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
