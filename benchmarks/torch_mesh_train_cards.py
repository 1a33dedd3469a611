#!/usr/bin/env python3
"""The port's sharded train step over four cards against the same mesh on
one.

    python3 benchmarks/torch_mesh_train_cards.py [--layers 28] [--steps 2]

Trains ``chip_smoke.py``'s (n): qwen3-1.7b at published widths (``--layers``
of its 28 layers), seed-0 f32 params drawn on ``cuda:0``, 8-bit AdamW,
``SyntheticLM`` batches of 8 x 256 tokens, on a 2 x 2 training mesh
(``launch.mesh.Mesh``, axes ``("data", "model")``) three ways, in this
order: every shard on ``cuda:0``; each shard on its own card (data shard 0
on cards 0-1, 1 on 2-3); every shard on ``cuda:0`` again.  Each layout
places the params by ``param_shardings`` and the batch by
``batch_shardings`` and takes ``--steps`` steps from the same state, each
timed to the end of every card's work.  Gates: every layout's losses and
grad norms within ``chip_smoke.SHARDED_LOSS_REL`` of the first's and its
params after the first step within ``chip_smoke.SHARDED_PARAM_LR``
learning rates.  Later steps are reported, not gated: four cards sum a
gradient's contributions from several cards in the order they arrive,
and 8-bit second moments that round to 0 on one side and not on the
other turn that last-bit difference into a large step (``v`` 0 leaves
``m / eps``).  Prints the cards' name and power limit and one JSON line:
each layout's step ms, every card's peak memory over the steps, and its
largest param difference from the first layout after each step (and
whether it is bit-equal).  It needs four CUDA cards and imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    import dataclasses
    import torch
    if torch.cuda.device_count() < 4:
        print(f"needs 4 CUDA devices, has {torch.cuda.device_count()}")
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharding as sh
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print(cs.host_line())
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              num_layers=args.layers)
    ocfg = AdamWConfig(state_dtype="int8")
    dev = torch.device("cuda", 0)
    cards = [torch.device("cuda", i) for i in range(4)]
    data = SyntheticLM(DataConfig(batch_size=cs.TRAIN_BATCH,
                                  seq_len=cs.TRAIN_SEQ,
                                  vocab_size=cfg.vocab_size))
    batches = [torch.from_numpy(data.next_batch()["tokens"])
               for _ in range(args.steps)]
    layouts = (("one card", [[dev, dev], [dev, dev]]),
               ("four cards", [cards[:2], cards[2:]]),
               ("one card again", [[dev, dev], [dev, dev]]))
    out, ref = {}, None
    for name, grid in layouts:
        mesh = Mesh(grid)
        print(f"training mesh ({name}): {mesh.shape} ({mesh.describe()})")
        params = M.init_params(cfg, torch.Generator(device=dev)
                               .manual_seed(0), dev)
        ps = sh.place_tree(params, sh.param_shardings(mesh, params))
        del params
        for c in cards:
            torch.cuda.synchronize(c)
            torch.cuda.reset_peak_memory_stats(c)
        step = make_train_step(cfg, ocfg)
        ms, metrics, wholes = [], [], []
        with sh.mesh_context(mesh):
            st = init_state(ocfg, ps)
            for b in batches:
                bd = {"tokens": b.to(dev)}
                bs = sh.place_tree(bd, sh.batch_shardings(mesh, bd))
                t0 = time.perf_counter()
                ps, st, m = step(ps, st, bs)
                for c in cards:
                    torch.cuda.synchronize(c)
                ms.append((time.perf_counter() - t0) * 1e3)
                metrics.append({k: float(v) for k, v in m.items()})
                # the params after the first and the last step, on the host
                if len(wholes) < 2:
                    wholes.append(None)
                wholes[-1] = [x.gather(dev).cpu() for x in tree.leaves(ps)]
        peak = [torch.cuda.max_memory_allocated(c) / 1e9 for c in cards]
        del ps, st
        torch.cuda.empty_cache()
        res = {"step_ms": ms, "peak_memory_gb": peak, "metrics": metrics}
        if ref is None:
            ref = (wholes, metrics)
        else:
            diffs = [max(float((a - b).abs().max()) for a, b in zip(w, r))
                     for w, r in zip(wholes, ref[0])]
            res["max_param_diff"] = {"first step": diffs[0],
                                     "last step": diffs[-1]}
            res["bit_equal"] = all(torch.equal(a, b) for w, r in
                                   zip(wholes, ref[0])
                                   for a, b in zip(w, r))
            for m, r in zip(metrics, ref[1]):
                for k in ("loss", "grad_norm"):
                    if abs(m[k] - r[k]) > cs.SHARDED_LOSS_REL * abs(r[k]):
                        print(f"{name}: {k} {m[k]} vs {r[k]}")
                        return 1
            if diffs[0] > cs.SHARDED_PARAM_LR * metrics[0]["lr"]:
                print(f"{name}: params {diffs[0]} apart after one step")
                return 1
        del wholes
        out[name] = res
    print("train mesh over cards: " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
