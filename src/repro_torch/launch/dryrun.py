"""Multi-pod dry run: count every (arch x shape) cell on the production
meshes and estimate, for the NVIDIA H100, whether its step fits a card and
what bounds it (compute, memory or collectives).

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell for 256 or 512 forced host devices and walks the HLO
(``hlo_costs``).  The port has no compiled module: it builds the cell
(``specs.build_cell``) on a mesh of 256 fake devices (512 for
``2x16x16``; ``device.fake_device``, ``launch.mesh.
make_production_mesh(fake=True)``) inside a ``FakeTensorMode`` that this
module owns, runs it once under ``costs.CostCounter`` and books each op
on its device.  Nothing real runs: the dry run touches no card, runs on
any host with or without one, and allocates no tensor memory; it is the
one entry point of the port that does not run on the card.

A cell's figure is its busiest device's (``costs.roofline``), with each
device's spread kept in the JSON.  A full-width cell on 256 fake devices
runs every shard's ops in Python (about 0.2 ms an op), so the counter
runs a cell in parts and extrapolates (``costs.combine``; the reference's
``trips_by_depth`` multiplies a scanned body the same way): with two
counts of its layer pattern's cycles after the prefix layers where it has
more than two (``a + (n - 1) (b - a)`` of every count, the argument
bytes and the peak; none and one cycle for a train cell, whose peak holds
every cycle's saved tensors, one and two for a prefill or decode cell,
whose peak falls inside its last layer); a train cell with two and three
microbatches where it has more than three (the peak is the two's: a
microbatch's saved tensors are freed before the next); a train or
prefill cell of a config without attention (xLSTM, whose sLSTM steps a
position at a time) with one and two chunks of ``CHUNK`` positions where
it has more than two.  The counts come out exact
(``tests/test_torch_dryrun.py`` holds them against whole counts).  The
JSON says which cells took the shortcut, and what the port runs
otherwise than the reference (``runs_otherwise``); ``--jobs`` counts the
runs in processes of their own.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out runs/dryrun_torch
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import sys
import time
import traceback
from pathlib import Path

from repro_torch.launch import costs, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import sharding as sh
from repro_torch.models.config import ALL_SHAPES, CHUNK

# NVIDIA H100 SXM5 80GB at 700 W (NVIDIA H100 Tensor Core GPU data sheet):
# dense BF16 tensor-core peak (1979 TFLOP/s is with sparsity), HBM3
# bandwidth, NVLink 4 (900 GB/s a card over both directions, 450 each
# way, between the 8 cards of an HGX/DGX H100 host); between hosts one
# 400 Gb/s ConnectX-7 port a card (DGX H100 data sheet: 8 x 400 Gb/s),
# 50 GB/s each way.  Device indices go 8 to a host in mesh order, so a
# 16-wide model axis spans two hosts.
H100 = {"peak_flops": 989e12, "hbm_bw": 3.35e12, "nvlink_bw": 450e9,
        "network_bw": 50e9, "cards_per_host": 8}
HBM_BYTES = 80e9

# configs whose layers run otherwise than the reference's sharded step on
# a mesh (ROADMAP 1.10c): the MoE layers and the mLSTM/sLSTM layers whole
# on a data group's lead device, and every train step without remat
OTHERWISE_KINDS = ("mlstm", "slstm")


def shape_by_name(name: str):
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


@contextlib.contextmanager
def fake_mode():
    """The dry run's ``FakeTensorMode``: tensors made inside it are fake
    (no memory), and keep the fake device's index."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        yield


def count_cell(arch: str, shape, mesh, variant: dict, *, cycles=None,
                global_batch=None) -> tuple[dict, specs.Cell]:
    """Build the cell on ``mesh`` and run it once under the counter;
    returns its ``costs`` record and the cell."""
    cell = specs.build_cell(arch, shape, mesh,
                            kv_int8=variant.get("kv_int8", False),
                            ga=variant.get("ga"), cycles=cycles,
                            global_batch=global_batch)
    counter = costs.CostCounter(specs.arg_bytes(cell))
    with counter:
        out = cell.fn()
        del out
    return counter.record(), cell


def runs_otherwise(cfg, kind: str) -> list[str]:
    why = []
    if cfg.num_experts:
        why.append("MoE layers whole on data group 0's lead device, every "
                   "row in that group")
    if any(k in OTHERWISE_KINDS for k in (*cfg.prefix_pattern, *cfg.cycle)):
        why.append("mLSTM/sLSTM layers whole on each data group's lead "
                   "device")
    if kind == "train":
        why.append("no remat of the layer cycles on a mesh")
    return why


def plan(arch: str, shape_name: str, variant: dict) -> dict:
    """A cell's counting runs: one entry a dimension of the shortcut
    (cycles, microbatches, sequence chunks; ``[None]`` where the cell runs
    whole in it) and the counts each extrapolates to."""
    shape = shape_by_name(shape_name)
    cfg = specs.configs.get_config(arch)
    ga = variant.get("ga") or specs.GRAD_ACCUM.get(arch, 1)
    n_chunks = shape.seq_len // CHUNK
    recurrent = not any(k in ("global", "local") for k in
                        (*cfg.prefix_pattern, *cfg.cycle))
    # a train step peaks as its backward starts, holding every cycle's
    # saved tensors: no and one cycle give a cycle's growth; a prefill or
    # decode peaks inside its last layer, whose transients one cycle's
    # count would take n times: one and two cycles give the growth
    first = 0 if shape.kind == "train" else 1
    return {"cycles": ([None] if cfg.n_cycles <= 2
                       else [first, first + 1]),
            "mbs": [None] if shape.kind != "train" or ga <= 3 else [2, 3],
            "chunks": ([None] if shape.kind == "decode" or not recurrent
                       or n_chunks <= 2 else [1, 2]),
            "n_cycles": cfg.n_cycles, "ga": ga, "n_chunks": n_chunks}


def count_run(arch: str, shape_name: str, multi_pod: bool, variant: dict,
              ga: int, key: tuple) -> tuple:
    """One counting run of a cell on the production mesh of fake devices:
    ``key`` = (cycles, microbatches, chunks), None for the cell's own.
    Returns ``(key, record, seconds)``."""
    t0 = time.time()
    shape = shape_by_name(shape_name)
    c, g, k = key
    mesh = make_production_mesh(multi_pod=multi_pod, fake=True)
    with fake_mode(), sh.mesh_context(mesh,
                                      moe_ep=variant.get("moe_ep", False)):
        v = dict(variant, ga=g or variant.get("ga"))
        gb = None if g is None else shape.global_batch // ga * g
        if k is not None:
            shape = dataclasses.replace(shape, seq_len=k * CHUNK)
        record, _ = count_cell(arch, shape, mesh, v, cycles=c,
                               global_batch=gb)
    return key, record, time.time() - t0


def run_keys(p: dict) -> list:
    return [(c, g, k) for c in p["cycles"] for g in p["mbs"]
            for k in p["chunks"]]


def finish(arch: str, shape_name: str, multi_pod: bool, variant: dict,
           p: dict, runs: dict, count_s: float, out_dir: Path | None,
           save_ops: bool = True) -> dict:
    """A counted cell's JSON (and its per-op record) from its runs."""
    shape = shape_by_name(shape_name)
    cfg = specs.configs.get_config(arch)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cyc = p["cycles"]
    n_cyc = p["n_cycles"] + 1 - (cyc[0] or 0)
    record = _extrapolate(runs, [(cyc, n_cyc, False),
                                 (p["mbs"], p["ga"] - 1, True),
                                 (p["chunks"], p["n_chunks"], False)])
    shortcut = None if runs.keys() == {(None, None, None)} else {
        "cycles_run": [c for c in p["cycles"] if c is not None],
        "n_cycles": p["n_cycles"],
        "microbatches_run": [g for g in p["mbs"] if g],
        "grad_accum": p["ga"],
        "chunks_run": [k for k in p["chunks"] if k],
        "n_chunks": p["n_chunks"]}
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "variant": {k: v for k, v in variant.items() if v}}
    result.update(summarize(record, cfg, shape, 512 if multi_pod else 256))
    result.update(count_s=count_s, shortcut=shortcut,
                  grad_accum=p["ga"] if shape.kind == "train" else None)
    why = runs_otherwise(cfg, shape.kind)
    if why:
        result["runs_otherwise"] = "ROADMAP 1.10c"
        result["runs_otherwise_why"] = why
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        stem = f"{arch}__{shape_name}__{mesh_name}"
        with open(out_dir / f"{stem}.json", "w") as f:
            json.dump(result, f, indent=1)
        if save_ops:
            (out_dir / f"{stem}.ops.json.gz").write_bytes(
                gzip.compress(json.dumps(record).encode(), 6))
    return result


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Path | None, save_ops: bool = True,
             variant: dict | None = None) -> dict:
    variant = variant or {}
    reason = specs.skip_reason(arch, shape_by_name(shape_name))
    if reason:
        return {"arch": arch, "shape": shape_name,
                "mesh": "2x16x16" if multi_pod else "16x16",
                "status": "skip", "reason": reason}
    p = plan(arch, shape_name, variant)
    done = [count_run(arch, shape_name, multi_pod, variant, p["ga"], key)
            for key in run_keys(p)]
    return finish(arch, shape_name, multi_pod, variant, p,
                  {key: rec for key, rec, _ in done},
                  sum(t for *_, t in done), out_dir, save_ops)


def _extrapolate(runs: dict, dims: list) -> dict:
    """The whole cell's record from the shortcut's runs, keyed by one
    entry a dimension of ``dims`` (cycles, microbatches, sequence chunks):
    ``(points, n, peak_first)`` each, points ``[None]`` where the cell ran
    whole in it, else two counts extrapolated to ``n`` (``costs.combine``:
    exact, each count is linear in each dimension); ``peak_first``: the
    peak is the first point's (microbatches free their saved tensors
    before the next)."""
    if not dims:
        return runs[()]
    (points, n, peak_first), rest = dims[-1], dims[:-1]
    sub = [_extrapolate({k[:-1]: v for k, v in runs.items()
                         if k[-1] == p}, rest) for p in points]
    if points == [None]:
        return sub[0]
    out = costs.combine(sub[0], sub[1], n)
    if peak_first:
        out["peak"] = sub[0]["peak"]
    return out


def summarize(record: dict, cfg, shape, n_chips: int,
              consts: dict = H100) -> dict:
    """The JSON fields a cell's record gives: memory, the parsed costs,
    model FLOPs and the roofline (``reanalyze`` calls it again)."""
    roof = costs.roofline(record, consts)
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        model_flops = 6 * n_active * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        model_flops = 2 * n_active * shape.global_batch * shape.seq_len
    else:
        model_flops = 2 * n_active * shape.global_batch          # 1 token
    args = {int(k): v for k, v in record["args"].items()}
    peak = {int(k): v for k, v in record["peak"].items()}
    kinds = costs.collectives(record)

    def spread(d):
        v = sorted(d.values()) or [0]
        return [v[0], v[len(v) // 2], v[-1]]

    busiest = roof.get("busiest_device", 0)
    return {
        "status": "ok",
        "n_chips": n_chips,
        "memory": {
            "argument_bytes": args.get(busiest, 0),
            "peak_bytes": max(peak.values(), default=0),
            "peak_device": max(peak, key=peak.get) if peak else None,
            "argument_bytes_spread": spread(args),
            "peak_bytes_spread": spread(peak),
            "over_hbm": max(peak.values(), default=0) > HBM_BYTES,
        },
        "parsed": {
            "flops": roof.get("flops", 0), "bytes": roof.get("bytes", 0),
            "collective_operand_bytes": sum(
                k["operand_bytes"] for k in kinds.values()) / n_chips,
            "collective_wire_bytes": sum(
                k["wire_bytes"] for k in kinds.values()) / n_chips,
            "collective_by_kind": kinds,
            "total_flops": sum(d["flops"] for d in
                               costs.per_device(record).values()),
        },
        "model_flops_total": model_flops,
        "model_flops_per_chip": model_flops / n_chips,
        "roofline": {**{k: roof.get(k) for k in (
            "compute_s", "memory_s", "collective_s", "dominant",
            "busiest_device", "spread", "n_devices")},
            "useful_flops_ratio": (model_flops / n_chips)
            / max(roof.get("flops", 0), 1.0),
            "constants": consts},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "pod", "both"],
                    default="single",
                    help="production mesh to count on: single (16x16), pod "
                         "(2x16x16) or both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="runs/dryrun_torch")
    ap.add_argument("--no-ops", action="store_true",
                    help="do not save the per-op record")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--moe-ep", action="store_true")
    ap.add_argument("--seq-shard", action="store_true",
                    help="refused: the port's sharded step has no "
                         "sequence-parallel residual")
    ap.add_argument("--ga", type=int, default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once, a process each")
    args = ap.parse_args()
    if args.seq_shard:
        ap.error("--seq-shard: the port's sharded step keeps each data "
                 "group's residual whole on its lead device (no "
                 "activation_constraint); it has no sequence-parallel "
                 "layout to count")
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    variant = {"kv_int8": args.kv_int8, "moe_ep": args.moe_ep,
               "ga": args.ga}
    out = Path(args.out)
    meshes = {"single": [False], "pod": [True], "both": [False, True]}[
        args.mesh]
    cells = (specs.all_cells() if args.all
             else [(args.arch, shape_by_name(args.shape))])
    todo = [(arch, shape.name, mp) for arch, shape in cells
            for mp in meshes]
    if args.jobs <= 1:
        failures = sum(not _one(arch, s, mp, out, not args.no_ops, variant)
                       for arch, s, mp in todo)
    else:
        failures = _pooled(todo, args.jobs, out, not args.no_ops, variant)
    return 1 if failures else 0


def _pooled(todo: list, jobs: int, out, save_ops: bool,
            variant: dict) -> int:
    """Count the cells of ``todo`` with every counting run a task of a
    pool of ``jobs`` processes, the longest runs first; returns the
    failures."""
    import concurrent.futures as cf
    import multiprocessing as mp_
    plans, tasks, failures = {}, [], 0
    for arch, s, mp in todo:
        if specs.skip_reason(arch, shape_by_name(s)):
            _one(arch, s, mp, out, save_ops, variant)
            continue
        p = plans[arch, s, mp] = plan(arch, s, variant)
        tasks += [(arch, s, mp, key, p["ga"]) for key in run_keys(p)]
    order = {"train": 0, "prefill": 1, "decode": 2}
    tasks.sort(key=lambda t: (order[shape_by_name(t[1]).kind], not t[2],
                              -max(x or 0 for x in t[3])))
    runs: dict = {cell: {} for cell in plans}
    with cf.ProcessPoolExecutor(jobs, mp_context=mp_.get_context(
            "spawn")) as pool:
        futs = {pool.submit(count_run, a, s, mp, variant, ga, key):
                (a, s, mp) for a, s, mp, key, ga in tasks}
        for fut in cf.as_completed(futs):
            cell = futs[fut]
            try:
                key, rec, sec = fut.result()
            except Exception:
                print(f"[{cell[0]} x {cell[1]} x "
                      f"{'2x16x16' if cell[2] else '16x16'}] a run failed",
                      flush=True)
                traceback.print_exc()
                failures += 1
                plans.pop(cell, None)
                continue
            runs[cell][key] = (rec, sec)
            p = plans.get(cell)
            if p is not None and len(runs[cell]) == len(run_keys(p)):
                r = finish(*cell, variant, p,
                           {k: v[0] for k, v in runs[cell].items()},
                           sum(v[1] for v in runs[cell].values()), out,
                           save_ops)
                print(f"[{cell[0]} x {cell[1]} x {r['mesh']}] ok dominant="
                      f"{r['roofline']['dominant']} count_s="
                      f"{r['count_s']:.1f}", flush=True)
    return failures


def _one(arch, shape_name, multi_pod, out, save_ops, variant) -> bool:
    """Count one cell and print its line; False where it failed."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    try:
        r = run_cell(arch, shape_name, multi_pod, out, save_ops=save_ops,
                     variant=variant)
    except Exception:
        print(f"[{arch} x {shape_name} x {mesh_name}] failed", flush=True)
        traceback.print_exc()
        return False
    extra = (f" dominant={r['roofline']['dominant']} "
             f"count_s={r['count_s']:.1f}"
             if r["status"] == "ok" else f" ({r['reason']})")
    print(f"[{arch} x {shape_name} x {mesh_name}] {r['status']}{extra}",
          flush=True)
    return True


if __name__ == "__main__":
    sys.exit(main())
