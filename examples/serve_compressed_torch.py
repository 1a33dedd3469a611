"""Serve a small model with batched requests from APack-compressed weights
AND a paged, APack-compressed int8 KV cache, on the PyTorch/CUDA port.

Port of ``examples/serve_compressed.py``: the same arguments through
``repro_torch.launch.serve``, so the weights make the checkpoint-style
round trip (``compress_params`` through the encode kernel, then
``decompress_params`` through the decode kernel) and decode KV reads go
through the fused paged APack attention kernel; the run prints the weight
compression line and the measured raw-vs-compressed KV traffic ratio.

    PYTHONPATH=src python examples/serve_compressed_torch.py
    # on the CPU, through the kernels' plain versions:
    PYTHONPATH=src python examples/serve_compressed_torch.py --device cpu
    # raw-KV baseline for comparison:
    PYTHONPATH=src python examples/serve_compressed_torch.py --kv int8
    # heterogeneous stack (global + rolling + recurrent cycle): rolling
    # layers evict whole pages as tokens leave the window, recurrent
    # states stay dense on the hot path; per-stream ratios are printed
    PYTHONPATH=src python examples/serve_compressed_torch.py --hetero
"""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv: list[str]) -> int:
    argv = list(argv)
    if "--hetero" in argv:
        argv.remove("--hetero")
        args = ["--arch", "hetero-serve-smoke", "--smoke", "--requests", "8",
                "--prompt-len", "12", "--max-new", "16", "--max-batch", "4",
                "--kv-page-size", "4"]
    else:
        args = ["--arch", "qwen3-1.7b", "--smoke", "--requests", "12",
                "--prompt-len", "16", "--max-new", "12", "--max-batch", "4"]
    if not any(a == "--kv" or a.startswith("--kv=") for a in argv):
        args += ["--kv", "apack-int8"]
        if "--kv-page-size" not in args:
            args += ["--kv-page-size", "8"]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve"] + args + argv,
        env=env).returncode


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
