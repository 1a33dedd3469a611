"""Training CLI of the port: AdamW (8-bit moments on request), the
synthetic data stream, APack-compressed checkpoints and the restarting
supervisor.

Port of ``repro/launch/train.py`` (its flags, plus ``--device`` and
``--state-dtype``).  On the card (the default):

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --smoke --steps 50 --batch 8 --seq 256 --ckpt-dir runs/train

``--device cpu`` trains through the kernels' plain versions (the codec of
``--compress-ckpt`` too).  A rerun with the same ``--ckpt-dir`` resumes
from its latest checkpoint, the data cursor included.  The params are
drawn from seed 0 with the JAX init's distributions (not its numbers).
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve
from repro_torch.models import model as M
from repro_torch.runtime import Supervisor, SupervisorConfig
from repro_torch.train import AdamWConfig, init_state, make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default="runs/train")
    ap.add_argument("--compress-ckpt", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--state-dtype", default="float32",
                    choices=["float32", "int8"],
                    help="AdamW moments: f32, or int8 in blocks of 32")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    device = resolve(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(10, args.steps // 20),
                       total_steps=args.steps, state_dtype=args.state_dtype)
    data = SyntheticLM(DataConfig(batch_size=args.batch, seq_len=args.seq,
                                  vocab_size=cfg.vocab_size))
    step_fn = make_train_step(cfg, ocfg, grad_accum=args.grad_accum)

    def make_state():
        gen = torch.Generator(device=device).manual_seed(0)
        params = M.init_params(cfg, gen, device)
        return {"params": params, "opt": init_state(ocfg, params)}, {}

    def train_one(state, step_idx):
        batch = data.next_batch()
        b = {"tokens": torch.from_numpy(batch["tokens"]).to(device)}
        params, opt, metrics = step_fn(state["params"], state["opt"], b)
        metrics = {k: float(v) for k, v in metrics.items()}
        return {"params": params, "opt": opt}, metrics

    sup = Supervisor(
        SupervisorConfig(ckpt_dir=args.ckpt_dir, save_every=args.save_every,
                         max_steps=args.steps,
                         compress_ckpt=args.compress_ckpt),
        make_state=make_state, step_fn=train_one,
        data_state=data.state_dict, restore_data=data.load_state_dict,
        device=device)
    _, history = sup.run()
    for h in history[::max(1, args.log_every)]:
        print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                          for k, v in h.items()}))
    if history:
        print(f"final loss: {history[-1]['loss']:.4f} "
              f"(first: {history[0]['loss']:.4f})")
    return history


if __name__ == "__main__":
    main()
