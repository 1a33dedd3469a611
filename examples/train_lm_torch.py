"""End-to-end training example on the PyTorch/CUDA port: an xLSTM LM with
the full substrate (AdamW, synthetic data, async APack-compressed
checkpoints, the restarting supervisor).

Port of ``examples/train_lm.py``: the same arguments through
``repro_torch.launch.train``.  Defaults are small (the xlstm SMOKE
config); ``--full`` trains the 125M-parameter xlstm-125m config.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
    # on the CPU, through the kernels' plain versions:
    PYTHONPATH=src python examples/train_lm_torch.py --steps 20 --device cpu
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="full 125M config instead of the reduced one")
    ap.add_argument("--ckpt-dir", default="runs/example_train_torch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", "xlstm-125m",
           "--steps", str(args.steps), "--batch", "8", "--seq", "256",
           "--ckpt-dir", args.ckpt_dir, "--save-every", "50",
           "--compress-ckpt", "--device", args.device]
    if not args.full:
        cmd.append("--smoke")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    raise SystemExit(subprocess.run(cmd, env=env).returncode)


if __name__ == "__main__":
    main()
