#!/usr/bin/env python3
"""The port's serving mesh over four cards against the same mesh on one.

    python3 benchmarks/torch_mesh_cards.py [--layers 28]

Serves ``chip_smoke.py``'s (l): qwen3-1.7b at published widths (``--layers``
of its 28 layers), seed-0 weights, the fused paged APack KV, 8 requests of
64-96-token prompts and 48 new tokens, ``max_batch=8``, on a 2 x 2 serving
mesh (``launch.mesh.Mesh``) three ways, in this order: every shard on
``cuda:0``; each shard on its own card (data shard 0 on cards 0-1, 1 on
2-3); every shard on ``cuda:0`` again (the first serve warms the host and
the card).  Each serve goes through ``chip_smoke.serve_full_width`` (its
launch counts, KV and step summary; a step is timed to the tokens'
pull, which waits for every data shard) and ``profile_steady_steps`` (a
profiler window of 10 steady steps of 8 fresh requests: wall ms a step,
device busy ms a step summed over the cards, and the idle share against
that sum).  Gate: every serve's tokens equal the first's.  Prints the cards' name and power limit
and one JSON line of the serves' medians, longest steps and profiles.  It
needs four CUDA cards and imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=28)
    args = ap.parse_args()
    import torch
    if torch.cuda.device_count() < 4:
        print(f"needs 4 CUDA devices, has {torch.cuda.device_count()}")
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.launch.mesh import Mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print(cs.host_line())
    dev = torch.device("cuda", 0)
    cards = [torch.device("cuda", i) for i in range(4)]
    layouts = (("one card", [[dev, dev], [dev, dev]]),
               ("four cards", [cards[:2], cards[2:]]),
               ("one card again", [[dev, dev], [dev, dev]]))
    out, tokens = {}, None
    for name, grid in layouts:
        mesh = Mesh(grid)
        print(f"serving mesh ({name}): {mesh.shape} ({mesh.describe()})")
        run = cs.serve_full_width(dev, layers=args.layers, max_batch=8,
                                  engine_kw={"mesh": mesh})
        got = [r.tokens for r in run["reqs"]]
        if tokens is None:
            tokens = got
        elif got != tokens:
            print(f"{name}: tokens differ from the first serve's")
            return 1
        prof = cs.profile_steady_steps(run["eng"], run["cfg"], run["rng"],
                                       f"mesh 2x2, {name}", n=8, drain=False)
        s = run["summary"]
        out[name] = {
            "median_step_ms": s["median_step_ms"],
            "max_step_ms": s["max_step_ms"], "wall_s": s["wall_s"],
            "tokens_per_s": s["tokens_per_s"], "kv_ratio": s["kv_ratio"],
            "launches_per_step": s["launches_per_step"],
            "profile": {k: prof[k] for k in ("wall_ms_per_step",
                                              "busy_ms_per_step",
                                              "idle_share")}}
        del run
        torch.cuda.empty_cache()
    print("mesh over cards: " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
