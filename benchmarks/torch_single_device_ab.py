#!/usr/bin/env python3
"""The single-device serve of two checkouts of the port, on one card.

    python3 benchmarks/torch_single_device_ab.py --roots A B B A

Each root (a checkout of this repo, e.g. a parent commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists) runs in a
process of its own, in the order given, with that root's ``src`` and
``chip_smoke.py``: its kernels built from its sources, then
``chip_smoke.py``'s phase 3 and phase 4 serves of qwen3-1.7b at published
widths (``--layers`` of its 28 layers), seed-0 weights, the fused paged
APack KV, 8 requests of 64-96-token prompts and 48 new tokens,
``max_batch=4``, no mesh (``--serves``, both by default): from dense
weights (``serve_full_width``, then ``profile_steady_steps``: wall and
busy ms a step over a profiler window of 10 steady steps, and the idle
share), and from packed weights (``weights="apack-int8"``).  Gate: every run's tokens, ``kv_ratio`` and
kernel launch counts equal the first run's.  Prints the card's name and
power limit, each run's host, and an ``ab:`` line with every run's
median and longest step (``--log-dir``: each run's whole output there).
It needs one CUDA card and imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


SERVES = {"dense": {}, "packed": {"weights": "apack-int8"}}


def one(root: str, layers: int, serves: list) -> dict:
    """The serves of one root, in this process."""
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.host_line(), flush=True)
    _build.build_all()
    dev = torch.device("cuda", 0)
    out = {"root": root}
    for label in serves:
        run = cs.serve_full_width(dev, layers=layers, **SERVES[label])
        s = run["summary"]
        out[label] = {"median_step_ms": s["median_step_ms"],
                      "max_step_ms": s["max_step_ms"],
                      "tokens_per_s": s["tokens_per_s"],
                      "kv_ratio": s["kv_ratio"],
                      "launches": s["launches"],
                      "tokens": [r.tokens for r in run["reqs"]]}
        if label == "dense":
            prof = cs.profile_steady_steps(run["eng"], run["cfg"], run["rng"],
                                           f"ab {label}")
            out[label]["profile"] = {k: prof[k] for k in (
                "wall_ms_per_step", "busy_ms_per_step", "idle_share")}
        del run
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", required=True)
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--serves", nargs="+", choices=SERVES,
                    default=list(SERVES))
    ap.add_argument("--log-dir", help="write each run's output there")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print("ab run: " + json.dumps(one(args.one, args.layers,
                                          args.serves)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    runs = []
    for i, root in enumerate(args.roots):
        root = os.path.abspath(root)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--roots", root,
             "--layers", str(args.layers), "--serves", *args.serves,
             "--one", root],
            capture_output=True, text=True, timeout=1800)
        if args.log_dir:
            os.makedirs(args.log_dir, exist_ok=True)
            with open(os.path.join(args.log_dir, f"ab_run{i}.log"), "w") as f:
                f.write(proc.stdout + proc.stderr)
        lines = proc.stdout.splitlines()
        host = [ln for ln in lines if ln.startswith("host:")]
        got = [ln for ln in lines if ln.startswith("ab run: ")]
        if proc.returncode != 0 or not got:
            print(proc.stdout[-4000:], proc.stderr[-4000:])
            print(f"{root}: failed (rc {proc.returncode})")
            return 1
        runs.append(json.loads(got[0][len("ab run: "):]))
        print(f"run {i} ({root}): " + (host[0] if host else ""))
    first = runs[0]
    for r in runs[1:]:
        for label in args.serves:
            for key in ("tokens", "kv_ratio", "launches"):
                if r[label][key] != first[label][key]:
                    print(f"{r['root']} {label}: {key} differ from "
                          f"{first['root']}'s")
                    return 1
    print("ab: " + json.dumps([
        {"root": r["root"],
         **{label: {k: v for k, v in r[label].items()
                    if k not in ("tokens", "launches")}
            for label in args.serves}} for r in runs]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
