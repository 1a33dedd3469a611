#!/usr/bin/env python3
"""The sharded train step of several checkouts of the port, on one card.

    python3 benchmarks/torch_mesh_train_ab.py --roots A B B A

Each root (a checkout of this repo, e.g. a parent commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists) runs in a
process of its own, in the order given, with that root's ``src`` and
``chip_smoke.py``: ``chip_smoke.py``'s (n), qwen3-1.7b at published widths
(``--layers`` of its 28 layers), seed-0 f32 params drawn on ``cuda:0``,
8-bit AdamW, ``SyntheticLM`` batches of 8 x 256 tokens, on a 2 x 2
training mesh with every shard on the card (``make_debug_mesh(2, 2)``),
``--steps`` steps each timed to the card's end.  Gate: every run's first
loss equals the first run's (the forward does not depend on how the
backward sums).  Prints the card's name and power limit, each run's
host, and an ``ab:`` line with every run's step ms, loss, grad norm and
peak memory.  It needs one CUDA card and imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def one(root: str, layers: int, steps: int) -> dict:
    """The steps of one root, in this process."""
    sys.path[:0] = [os.path.join(root, "src"), root]
    import dataclasses
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharding as sh
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.host_line(), flush=True)
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=layers)
    ocfg = AdamWConfig(state_dtype="int8")
    data = SyntheticLM(DataConfig(batch_size=cs.TRAIN_BATCH,
                                  seq_len=cs.TRAIN_SEQ,
                                  vocab_size=cfg.vocab_size))
    mesh = make_debug_mesh(2, 2, device=dev)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    ps = sh.place_tree(params, sh.param_shardings(mesh, params))
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, ocfg)
    out = {"root": root, "step_ms": [], "loss": [], "grad_norm": []}
    with sh.mesh_context(mesh):
        st = init_state(ocfg, ps)
        for _ in range(steps):
            bd = {"tokens": torch.from_numpy(data.next_batch()["tokens"])
                  .to(dev)}
            bs = sh.place_tree(bd, sh.batch_shardings(mesh, bd))
            t0 = time.perf_counter()
            ps, st, m = step(ps, st, bs)
            torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", required=True)
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print("ab-run: " + json.dumps(one(args.one, args.layers,
                                          args.steps)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    runs = []
    for root in args.roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--roots", root,
             "--layers", str(args.layers), "--steps", str(args.steps),
             "--one", os.path.abspath(root)],
            capture_output=True, text=True, timeout=1800)
        got = [line for line in proc.stdout.splitlines()
               if line.startswith("ab-run: ")]
        if proc.returncode != 0 or not got:
            print(proc.stdout[-3000:] + proc.stderr[-3000:])
            print(f"{root}: exit {proc.returncode}")
            return 1
        print(next(line for line in proc.stdout.splitlines()
                   if line.startswith("host:")))
        runs.append(json.loads(got[0][len("ab-run: "):]))
        if runs[-1]["loss"][0] != runs[0]["loss"][0]:
            print(f"{root}: first loss {runs[-1]['loss'][0]} differs from "
                  f"{runs[0]['loss'][0]}")
            return 1
    print("ab: " + json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
