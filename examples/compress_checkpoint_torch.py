"""Lossless APack byte-plane compression of a training checkpoint on the
PyTorch/CUDA port (bit-exact; each byte plane through the APack encode
kernel, and the decode kernel at restore).

Port of ``examples/compress_checkpoint.py``.

    PYTHONPATH=src python examples/compress_checkpoint_torch.py
    # on the CPU, through the kernels' plain versions:
    PYTHONPATH=src python examples/compress_checkpoint_torch.py --device cpu
"""
import argparse
import tempfile
import time
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch import tree
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.device import resolve
from repro_torch.models import model as M


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve(ap.parse_args().device)
    cfg = configs.get_smoke_config("qwen3-1.7b")
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    # make the weights trained-like (small magnitudes, skewed exponents)
    params = tree.map(lambda x: (x * 0.02).to(x.dtype) if x.dim() >= 2
                      else x, params)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        ckpt.save(Path(d) / "raw", 1, params, compress=False, device=device)
        t_raw = time.time() - t0
        t0 = time.time()
        ckpt.save(Path(d) / "apack", 1, params, compress=True, device=device)
        t_comp = time.time() - t0

        def dir_bytes(p):
            return sum(f.stat().st_size for f in Path(p).rglob("*")
                       if f.is_file())

        raw = dir_bytes(Path(d) / "raw")
        comp = dir_bytes(Path(d) / "apack")
        print(f"raw checkpoint:    {raw / 1e6:8.2f} MB ({t_raw:.1f}s)")
        print(f"apack checkpoint:  {comp / 1e6:8.2f} MB ({t_comp:.1f}s) "
              f"-> {raw / comp:.2f}x smaller")
        restored, _, _ = ckpt.restore(Path(d) / "apack", device=device)
        for a, b in zip(tree.leaves(params), tree.leaves(restored)):
            assert torch.equal(a.reshape(-1).view(torch.uint8),
                               b.reshape(-1).view(torch.uint8))
        print("restore: bit-exact OK")


if __name__ == "__main__":
    main()
