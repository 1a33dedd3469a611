"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface, ``build/kernels/<name>-<hash>.so`` under the
repository root, named by the hash of its sources and flags so an edited
source rebuilds and an unchanged one is reused.  ``build_all`` starts one
``nvcc`` per source at once.  There is no fallback: a missing ``nvcc`` or a
failed compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("apack_decode", "apack_encode", "fused_page_attention",
           "decompress_matmul", "gather_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

# Launch counts per kernel: each wrapper adds one where it launches its
# kernel and nowhere else, so a run can show that its path went through the
# kernels (``repro_torch.launch_counts``).
LAUNCHES = {name: 0 for name in KERNELS}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda)")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> dict[str, float]:
    """Compile every kernel that is not built yet, one ``nvcc`` process per
    source, all started together.  Returns seconds per kernel compiled
    (0.0 for one already built).  The ``-Xptxas -v`` report of each build
    is kept beside its library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out = {}
    t0 = time.perf_counter()
    for name in names:
        so = _target(name)
        if so.exists():
            out[name] = 0.0
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        log = open(so.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       tmp, so, log)
    failed = []
    for name, (proc, tmp, so, log) in procs.items():
        rc = proc.wait()
        log.close()
        out[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (rc={rc}): "
                          f"{so.with_suffix('.log').read_text()[-2000:]}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def stream_of(t) -> int:
    """The raw ``cudaStream_t`` of the current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(fn, *args, on) -> int:
    """Call launcher ``fn`` with ``args`` and the current stream of
    tensor ``on``'s device, that device current: a kernel launches on the
    current device, so a tensor on another card than the current one
    (a mesh's shard) gets its kernel there.  Returns the launcher's
    ``cudaError_t``."""
    import torch
    with torch.cuda.device(on.device):
        return fn(*args, stream_of(on))


def refuse_fake(what: str, *tensors) -> None:
    """Raise where a fake tensor (the dry run's ``FakeTensorMode``)
    reaches a kernel wrapper: the dry run launches no kernel, and the
    plain version's route is for CPU tensors only."""
    from torch._subclasses.fake_tensor import FakeTensor
    if any(isinstance(t, FakeTensor) for t in tensors):
        raise RuntimeError(f"{what}: a fake tensor reached the kernel "
                           "wrapper; the dry run runs no kernel")


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def require(t, dtype, shape, name: str, device) -> int:
    """Check a tensor a kernel reads or writes; returns its data pointer."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t.data_ptr()


def require_table(t, b: int, n: int, name: str, device):
    """Check a table array of ``n`` entries that a kernel reads for ``b``
    pages: one row for every page (``[n]``, or a row expanded to the pages
    with stride 0) or a row per page (``[..., n]`` with ``b`` rows).
    Returns the rows as a tensor to keep alive while the kernel runs and
    the elements between two pages' rows, 0 for one shared row.  An int32
    table whose rows are contiguous is read where it lies, not copied."""
    import torch
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dim() == 0 or t.shape[-1] != n:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"[{n}] or [..., {n}]")
    rows = t.to(torch.int32).reshape(-1, n)
    if rows.shape[0] not in (1, b):
        raise ValueError(f"{name}: {rows.shape[0]} rows for {b} pages")
    if rows.stride(-1) != 1:
        rows = rows.contiguous()
    return rows, (rows.stride(0) if rows.shape[0] > 1 else 0)
