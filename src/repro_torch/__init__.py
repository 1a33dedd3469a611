"""PyTorch + CUDA port of the APack reproduction (``repro``), for an NVIDIA
H100.

It serves every architecture of the registry (attention, RG-LRU,
mLSTM and sLSTM layers) from the paged APack-compressed KV cache, with
table refresh, a host spill tier and pressure handling, and, with
``weights="apack-int8"``, from APack-packed weights
(``serve.ServeEngine``, ``launch/serve.py``); it trains them with 8-bit
AdamW and APack-compressed checkpoints (``train``, ``ckpt``,
``runtime.Supervisor``, ``launch/train.py``), on one device or a mesh
(FSDP and tensor parallelism, ``models.sharding``), with
five hand-written CUDA kernels for sm_90a: APack decode, APack encode,
the fused paged gather-decode attention, the fused decompress-matmul and
the gather decode (``kernels/``).  The JAX package ``repro`` is the reference it is held
against; this package imports neither it nor JAX.
"""
from __future__ import annotations

from repro_torch.kernels import _build


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, per kernel (each wrapper counts where it
    launches its kernel; CPU tensors take the plain versions and count
    nothing)."""
    return dict(_build.LAUNCHES)


def reset_launch_counts() -> None:
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0
