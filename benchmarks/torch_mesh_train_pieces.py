#!/usr/bin/env python3
"""Which piece of the sharded train step parts it from one device's step.

    python3 benchmarks/torch_mesh_train_pieces.py [--layers 28]
        [--pieces base row loss moments all]

``chip_smoke.py``'s (n) on one card: qwen3-1.7b at published widths
(``--layers`` of its 28 layers), seed-0 f32 params drawn on ``cuda:0``,
8-bit AdamW, the first ``SyntheticLM`` batch of 8 x 256 tokens.  The
reference is one device's first step; the control is one device's step
with the batch in two microbatches (the same sums in another order).
Each piece then takes the first step on a 2 x 2 training mesh with every
shard on the card (``make_debug_mesh(2, 2)``) with one part of the mesh's
step run whole, as one device runs it:

- ``base``: the mesh's step as it is;
- ``row``: every tensor-parallel site (attention, dense FFN, RG-LRU) run
  whole on its data group's lead device, so the row-parallel partials
  are one device's product (``model._site`` returns the whole params);
- ``loss``: the vocabulary-parallel head and loss computed whole on the
  lead device (``model._head_parts`` over one model shard);
- ``moments``: every 8-bit moment updated on the gathered leaf
  (``optimizer._q8_aligned`` false, as where blocks straddle shards);
- ``all``: the three together.

The pieces are swapped in this process only, for the one step each.
Prints the card's name and power limit, the host, and a ``pieces:``
line with each run's share of params within lr / 100 of the reference's
(``chip_smoke.param_agreement``), the control's beside them.  It needs
one CUDA card and imports no JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

PIECES = ("base", "row", "loss", "moments", "all")


@contextlib.contextmanager
def whole(piece: str):
    """The mesh step with ``piece`` run whole (see the module docstring)."""
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt
    saved = (M._site, M._head_parts, opt._q8_aligned)
    if piece in ("row", "all"):
        M._site = lambda cfg, site, p, devs, lead: M._whole(p, lead)
    if piece in ("loss", "all"):
        head = saved[1]
        M._head_parts = lambda params, h, devs: head(params, h, devs[:1])
    if piece in ("moments", "all"):
        opt._q8_aligned = lambda p: False
    try:
        yield
    finally:
        M._site, M._head_parts, opt._q8_aligned = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--pieces", nargs="+", default=list(PIECES),
                    choices=PIECES)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharding as sh
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    if not torch.cuda.is_available():
        print("torch_mesh_train_pieces: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    print(cs.host_line(), flush=True)
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              num_layers=args.layers)
    ocfg = AdamWConfig(state_dtype="int8")
    data = SyntheticLM(DataConfig(batch_size=cs.TRAIN_BATCH,
                                  seq_len=cs.TRAIN_SEQ,
                                  vocab_size=cfg.vocab_size))
    batch = {"tokens": torch.from_numpy(data.next_batch()["tokens"])
             .to(dev)}
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    names = ["/".join(map(str, p)) for p, _ in cs._tree_paths(params)]
    out = {"layers": cfg.num_layers, "mesh": [2, 2]}
    t0 = time.perf_counter()
    ref, _, m = make_train_step(cfg, ocfg)(params, init_state(ocfg, params),
                                           batch)
    lr = float(m["lr"])
    p2, _, _ = make_train_step(cfg, ocfg, grad_accum=2)(
        params, init_state(ocfg, params), batch)
    out["control_grad_accum_2"] = cs.param_agreement(p2, ref, lr, names)
    del p2
    out["reference_s"] = time.perf_counter() - t0
    mesh = make_debug_mesh(2, 2, device=dev)
    for piece in args.pieces:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with whole(piece), sh.mesh_context(mesh):
            ps = sh.place_tree(params, sh.param_shardings(mesh, params))
            bs = sh.place_tree(batch, sh.batch_shardings(mesh, batch))
            p1, _, m1 = make_train_step(cfg, ocfg)(ps, init_state(ocfg, ps),
                                                   bs)
            del ps, bs
        agree = cs.param_agreement(p1, ref, lr, names)
        del p1
        out[piece] = {"loss": float(m1["loss"]),
                      "grad_norm": float(m1["grad_norm"]),
                      "seconds": time.perf_counter() - t0, **agree}
        print(f"piece {piece}: share within lr / 100 "
              f"{agree['share_within_lr_over_100']:.4f} (control "
              f"{out['control_grad_accum_2']['share_within_lr_over_100']:.4f})",
              flush=True)
    out["lr"] = lr
    out["loss_one_device"] = float(m["loss"])
    print("pieces: " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
