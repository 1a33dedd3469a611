"""Checkpointing: per-leaf files, atomic commit, async save and optional
lossless APack compression of the float leaves.

Port of ``repro/ckpt/checkpoint.py``: ``_save_leaf``/``_load_leaf``
:43/:65, ``save`` :78 (atomic, ``LATEST``, ``_gc`` :115), ``latest_step``
:122, ``restore`` :134 and ``AsyncCheckpointer`` :163.  Layout::

    <dir>/step_0000123/
        manifest.json      # tree structure, dtypes, shapes, codec per leaf
        leaf_00000.bin     # raw bytes (np.save) or APack byte planes
        ...
        extra.json         # user state (data-pipeline cursors, ...)
    <dir>/LATEST           # atomically updated pointer

A leaf is compressed under the reference's rule: a numpy float leaf
(``dtype.kind == "f"``) of at least 4096 elements, coded by
``core.byteplane`` (each byte plane through the APack encode kernel on
the card; the decode kernel at restore), kept only where the coded size
is under 0.98 of the raw bits.  bf16 leaves are stored raw as their
uint16 bits: the reference's bf16 arrays (``ml_dtypes``) are not of kind
"f", so its rule never compresses them either.  The tree's
structure (nested dicts, lists, tuples and ``Q8`` moments) goes into the
manifest (``repro_torch.tree``) where the reference pickles its treedef.
``restore`` puts every leaf on the device it is given, or with
``shardings`` places it on a mesh (``restore(shardings=)`` :134-151, the
elastic path: a checkpoint restores onto any mesh shape).  A tree of
``sharding.Sharded`` leaves saves its global leaves, so its files and
manifest are those of the unsharded tree's save.

A save fits the byte planes' tables (the host's table search, one per
coded plane, each a pure function of the plane's sampled histogram) for
all leaves first, one process a core, then codes the leaves one by one
on the device.

``timings``, where a caller passes a dict, gets the seconds of each part
added under its name: ``snapshot`` (the device-to-host copy), ``tables``
(sampling and the table search), ``encode`` and ``pull`` (the codec's
kernel and its planes' pull), ``write`` and ``total`` at save; ``read``,
``upload``, ``decode`` (the decode kernel) and ``total`` at restore.  The
codec's parts are closed by a wait for the device.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import pickle
import shutil
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import byteplane
from repro_torch.device import resolve
from repro_torch.models.sharding import Sharded, place_tree

_BF16 = "bfloat16"
MIN_COMPRESS = 4096          # elements (``_save_leaf`` :45)
PAYS = 0.98                  # stored bits under this share of the raw


def _add(timings: dict | None, part: str, t0: float) -> None:
    if timings is not None:
        timings[part] = timings.get(part, 0.0) + time.perf_counter() - t0


def _dtype_name(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _host_copies(tree, timings: dict | None = None):
    """Every tensor leaf copied to the host (pinned memory, one wait for
    the card at the end), numpy leaves copied: a snapshot that a later
    in-place update of the tree cannot reach."""
    t0 = time.perf_counter()
    leaves, spec = T.flatten(tree)
    out, cuda = [], False
    for x in leaves:
        if isinstance(x, Sharded):
            x = x.gather()
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.device.type == "cuda":
                cuda = True
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                out.append(h.copy_(x, non_blocking=True))
            else:
                out.append(x.clone())
        else:
            out.append(np.array(x))
    if cuda:
        torch.cuda.synchronize()
    _add(timings, "snapshot", t0)
    return T.unflatten(spec, out)


def _raw_numpy(x) -> tuple[np.ndarray, str]:
    """(numpy array of the leaf's bits, dtype name): a bf16 tensor as its
    uint16 view."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), _BF16
        return x.numpy(), _dtype_name(x)
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def _compressible(x) -> bool:
    """The reference's rule: a numpy float leaf (bf16 is not one) of at
    least ``MIN_COMPRESS`` elements."""
    if isinstance(x, torch.Tensor):
        return x.is_floating_point() and x.dtype != torch.bfloat16 \
            and x.numel() >= MIN_COMPRESS
    a = np.asarray(x)
    return a.dtype.kind == "f" and a.size >= MIN_COMPRESS


def _fit_tables(leaves: list, timings: dict | None = None) -> dict:
    """{leaf index: its planes' tables} of the compressible leaves (None
    entries are skipped): every plane's sample first, then the table
    searches, in a spawned process a core where there are 8 or more (the
    searches are pure Python), else here."""
    t0 = time.perf_counter()
    samples = {i: byteplane.plane_samples(x) for i, x in enumerate(leaves)
               if x is not None}
    flat = [smp for ss in samples.values() for smp in ss if smp is not None]
    workers = min(os.cpu_count() or 1, len(flat))
    if len(flat) >= 8 and workers > 1:
        with ProcessPoolExecutor(workers,
                                 mp_context=multiprocessing.get_context(
                                     "spawn")) as ex:
            fitted = iter(list(ex.map(byteplane.fit_table, flat)))
    else:
        fitted = iter([byteplane.fit_table(smp) for smp in flat])
    out = {i: [None if smp is None else next(fitted) for smp in ss]
           for i, ss in samples.items()}
    _add(timings, "tables", t0)
    return out


def _save_leaf(path: Path, x, compress: bool, device=None,
               timings: dict | None = None, tables: list | None = None
               ) -> dict:
    """Write one leaf; returns its manifest entry (shape, dtype, codec,
    stored bits), the reference's ``_save_leaf`` decision and bits.
    ``tables``: its planes' tables, fitted by the caller."""
    arr, dtype = _raw_numpy(x)
    info = {"shape": list(arr.shape), "dtype": dtype}
    if compress and _compressible(x):
        # a tensor leaf goes to the codec's device as it is (a pinned
        # snapshot uploads without staging)
        vals = x if isinstance(x, torch.Tensor) else torch.from_numpy(arr)
        cp = byteplane.compress_float(vals, device=resolve(device),
                                      timings=timings, tables=tables)
        if cp.total_bits < arr.nbytes * 8 * PAYS:
            t0 = time.perf_counter()
            with open(path, "wb") as f:
                pickle.dump(cp, f)
            _add(timings, "write", t0)
            info["codec"] = "apack_byteplane"
            info["stored_bits"] = cp.total_bits
            return info
        # compression would not pay (container overhead): store raw
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        np.save(f, arr, allow_pickle=False)
    _add(timings, "write", t0)
    info["codec"] = "raw"
    info["stored_bits"] = int(arr.nbytes * 8)
    return info


def _load_leaf(path: Path, info: dict, device,
               timings: dict | None = None) -> torch.Tensor:
    t0 = time.perf_counter()
    if info["codec"] == "apack_byteplane":
        with open(path, "rb") as f:
            cp = pickle.load(f)
        _add(timings, "read", t0)
        return byteplane.decompress_float(cp, device=device,
                                          timings=timings).reshape(
            info["shape"])
    with open(path, "rb") as f:
        raw = np.load(f, allow_pickle=False)
    _add(timings, "read", t0)
    t = torch.from_numpy(raw)
    if info["dtype"] == _BF16:
        t = t.view(torch.int16).view(torch.bfloat16)
    t0 = time.perf_counter()
    out = t.reshape(info["shape"]).to(device)
    _add(timings, "upload", t0)
    return out


def save(ckpt_dir, step: int, tree, extra: dict | None = None,
         compress: bool = False, keep: int = 3, device=None,
         timings: dict | None = None) -> Path:
    """Atomic checkpoint write of ``tree`` (tensors, numpy arrays or
    ``Sharded`` tensors, each written whole, in nested dicts, lists, tuples
    and ``Q8``s).  ``device``: where the codec runs (the card unless the
    caller asks for the CPU)."""
    t_all = time.perf_counter()
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves, spec = T.flatten(tree)
    leaves = [x.gather() if isinstance(x, Sharded) else x for x in leaves]
    tables = _fit_tables([x if compress and _compressible(x) else None
                          for x in leaves], timings)
    manifest = {"step": step, "tree": spec, "leaves": []}
    for i, leaf in enumerate(leaves):
        name = f"leaf_{i:05d}"
        info = _save_leaf(tmp / name, leaf, compress, device, timings,
                          tables.get(i))
        info["name"] = name
        manifest["leaves"].append(info)
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=1)
    with open(tmp / "extra.json", "w") as f:
        json.dump(extra or {}, f)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                               # atomic commit
    latest = ckpt_dir / "LATEST"
    tmp_latest = ckpt_dir / ".LATEST.tmp"
    tmp_latest.write_text(final.name)
    tmp_latest.rename(latest)
    _gc(ckpt_dir, keep)
    _add(timings, "total", t_all)
    return final


def _gc(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(p for p in ckpt_dir.iterdir()
                   if p.is_dir() and p.name.startswith("step_"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    pointer = ckpt_dir / "LATEST"
    if not pointer.exists():
        return None
    name = pointer.read_text().strip()
    if not (ckpt_dir / name / "manifest.json").exists():
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir, step: int | None = None, device=None,
            timings: dict | None = None, shardings=None):
    """Load a checkpoint (the latest unless ``step``), every leaf a tensor
    on ``device.resolve(device)``, or, with ``shardings`` (a tree of
    ``sharding.NamedSharding`` of the checkpoint's structure, as
    ``param_shardings`` gives), a ``Sharded`` placed by its sharding: a
    coded leaf decodes on its mesh's first device, then each device takes
    its block.  Returns ``(tree, extra, step)``."""
    t_all = time.perf_counter()
    if shardings is not None and device is None:
        device = T.leaves(shardings)[0].mesh.devices.flat[0]
    dev = resolve(device)
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)
    leaves = [_load_leaf(d / info["name"], info, dev, timings)
              for info in manifest["leaves"]]
    with open(d / "extra.json") as f:
        extra = json.load(f)
    tree = T.unflatten(manifest["tree"], leaves)
    if shardings is not None:
        tree = place_tree(tree, shardings)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _add(timings, "total", t_all)
    return tree, extra, step


class AsyncCheckpointer:
    """Snapshot on the caller's thread, write in the background: ``save``
    copies every leaf to the host (one wait for the card) before it
    returns, so a step that follows at once cannot change what is written;
    the codec and the files run on a thread of their own."""

    def __init__(self, ckpt_dir, compress: bool = False, keep: int = 3,
                 device=None, timings: dict | None = None):
        self.ckpt_dir = Path(ckpt_dir)
        self.compress = compress
        self.keep = keep
        self.device = device
        self.timings = timings
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, step: int, tree, extra: dict | None = None) -> None:
        self.wait()
        snapshot = _host_copies(tree, self.timings)

        def work():
            try:
                save(self.ckpt_dir, step, snapshot, extra,
                     compress=self.compress, keep=self.keep,
                     device=self.device, timings=self.timings)
            except Exception as e:                        # pragma: no cover
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
