#!/usr/bin/env python3
"""The port's sharded train step over four cards against the same mesh on
one.

    python3 benchmarks/torch_mesh_train_cards.py [--layers 28] [--steps 2]
        [--breakdown]

Trains ``chip_smoke.py``'s (n): qwen3-1.7b at published widths (``--layers``
of its 28 layers), seed-0 f32 params drawn on ``cuda:0``, 8-bit AdamW,
``SyntheticLM`` batches of 8 x 256 tokens, on a 2 x 2 training mesh
(``launch.mesh.Mesh``, axes ``("data", "model")``) three ways, in this
order: every shard on ``cuda:0``; each shard on its own card (data shard 0
on cards 0-1, 1 on 2-3); every shard on ``cuda:0`` again.  Each layout
places the params by ``param_shardings`` and the batch by
``batch_shardings`` and takes ``--steps`` steps from the same state, each
timed to the end of every card's work.  Gates: every layout's params
after the first and the last step, and its moments after the last, are
bit-equal to the first layout's.  The sharded step sums every gradient
that crosses devices in shard order (``sharding.psum`` of a block's
reads, ``sharding.broadcast`` of a site's input), never in the order the
cards finish; the gate holds it to that, since 8-bit second moments that
round to 0 on one side and not on the other would turn a last-bit
difference into a large step (``v`` 0 leaves ``m / eps``).  Prints the
cards' name and power limit and one JSON line: each layout's step ms,
every card's peak memory over the steps, its losses and grad norms, and
its largest param and moment differences from the first layout (and
whether they are bit-equal).  With ``--breakdown`` it then runs the four-
card and the one-card layouts once more under the allocator's history
(``torch.cuda.memory._record_memory_history``) and prints, for each card,
what was live at its peak: the allocations of the window grouped by
their innermost frame in ``repro_torch`` (or, with no Python frame, as
in autograd's own backward ops, by size), and what was live before the
window, over their first step.  Those runs' times are not reported.  It needs four CUDA cards
and imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _where(frames: list) -> str | None:
    """The innermost frame of an allocation's stack in the port."""
    for f in frames:
        name = f["filename"].replace(os.sep, "/")
        if "/repro_torch/" in name:
            return (f"{name[name.index('repro_torch/'):]}:{f['line']} "
                    f"{f['name']}")
    return None


def peak_breakdown(trace: list, base: int, top: int = 10) -> dict:
    """What was live at the peak of one card's allocator ``trace`` (the
    ``device_traces`` entry of a memory snapshot), ``base`` bytes being
    allocated when the recording began: the peak in GB, the bytes still
    live from before the window, and the window's live allocations
    grouped by ``_where`` (or by size where no port frame is on the
    stack), the ``top`` largest groups with their counts."""
    live, cur, peak, at = {}, 0, 0, -1
    for n, e in enumerate(trace):
        if e["action"] == "alloc":
            live[e["addr"]] = e["size"]
            cur += e["size"]
            if cur > peak:
                peak, at = cur, n
        elif e["action"] == "free_completed":
            cur -= live.pop(e["addr"], e["size"])
    live, before = {}, base
    for e in trace[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_completed":
            if live.pop(e["addr"], None) is None:
                before -= e["size"]
    groups: dict = {}
    for e in live.values():
        key = _where(e.get("frames", [])) or \
            f"no port frame, {e['size'] / 1e6:.1f} MB blocks"
        got = groups.setdefault(key, [0, 0])
        got[0] += e["size"]
        got[1] += 1
    order = sorted(groups.items(), key=lambda kv: -kv[1][0])[:top]
    return {"peak_gb": (base + peak) / 1e9, "before_window_gb": before / 1e9,
            "groups": [{"where": k, "gb": b / 1e9, "count": c}
                       for k, (b, c) in order]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--breakdown", action="store_true")
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
    layouts = [("one card", [[dev, dev], [dev, dev]]),
               ("four cards", [cards[:2], cards[2:]]),
               ("one card again", [[dev, dev], [dev, dev]])]
    if args.breakdown:
        layouts += [("four cards, recorded", [cards[:2], cards[2:]]),
                    ("one card, recorded", [[dev, dev], [dev, dev]])]
    out, ref = {}, None
    for name, grid in layouts:
        record = name.endswith("recorded")
        mesh = Mesh(grid)
        print(f"training mesh ({name}): {mesh.shape} ({mesh.describe()})")
        params = M.init_params(cfg, torch.Generator(device=dev)
                               .manual_seed(0), dev)
        ps = sh.place_tree(params, sh.param_shardings(mesh, params))
        del params
        for c in cards:
            torch.cuda.synchronize(c)
            torch.cuda.reset_peak_memory_stats(c)
        base = [torch.cuda.memory_allocated(c) for c in cards]
        if record:
            torch.cuda.memory._record_memory_history(
                enabled="all", context="all", stacks="python",
                max_entries=4_000_000)
        step = make_train_step(cfg, ocfg)
        ms, metrics, wholes = [], [], []
        with sh.mesh_context(mesh):
            st = init_state(ocfg, ps)
            for b in batches[:1] if record else batches:
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
            moments = [x.gather(dev).cpu() if isinstance(x, sh.Sharded)
                       else x.cpu() for x in tree.leaves(st)]
        peak = [torch.cuda.max_memory_allocated(c) / 1e9 for c in cards]
        if record:
            traces = torch.cuda.memory._snapshot()["device_traces"]
            torch.cuda.memory._record_memory_history(enabled=None)
            used = sorted({d.index for row in grid for d in row})
            print(f"peak breakdown ({name}): " + json.dumps(
                {f"cuda:{i}": {"max_memory_allocated_gb": peak[i],
                               **peak_breakdown(traces[i], base[i])}
                 for i in used}))
            del ps, st, traces, wholes, moments
            torch.cuda.empty_cache()
            continue
        del ps, st
        torch.cuda.empty_cache()
        res = {"step_ms": ms, "peak_memory_gb": peak, "metrics": metrics}
        if ref is None:
            ref = (wholes, moments)
        else:
            def diff(a, b):
                return float((a.double() - b.double()).abs().max())
            diffs = [max(diff(a, b) for a, b in zip(w, r))
                     for w, r in zip(wholes, ref[0])]
            res["max_param_diff"] = {"first step": diffs[0],
                                     "last step": diffs[-1]}
            res["max_moment_diff"] = max(diff(a, b) for a, b in
                                         zip(moments, ref[1]))
            res["bit_equal"] = {
                "params": all(torch.equal(a, b) for w, r in
                              zip(wholes, ref[0]) for a, b in zip(w, r)),
                "moments": all(torch.equal(a, b)
                               for a, b in zip(moments, ref[1]))}
        del wholes, moments
        out[name] = res
        if not all(res.get("bit_equal", {"": True}).values()):
            print("train mesh over cards: " + json.dumps(out))
            print(f"{name}: not bit-equal to the one-card mesh")
            return 1
        if len(out) == 3:
            print("train mesh over cards: " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
