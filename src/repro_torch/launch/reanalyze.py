"""Recompute the dry run's rooflines from its saved per-op records with
the current constants, without counting the cells again.

Port of ``repro/launch/reanalyze.py``: where the reference re-walks its
saved ``.hlo.zst``, the port re-reads each cell's ``.ops.json.gz``
(``costs.CostCounter.record``) and calls ``dryrun.summarize`` again.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze --dir runs/dryrun_torch
"""
from __future__ import annotations

import argparse
import gzip
import json
from pathlib import Path

from repro_torch import configs
from repro_torch.launch import dryrun


def reanalyze(dir_: Path, consts: dict = dryrun.H100) -> int:
    """Rewrite each counted cell's JSON under ``dir_``; returns how many."""
    done = 0
    for jpath in sorted(dir_.glob("*.json")):
        cell = json.loads(jpath.read_text())
        if cell.get("status") != "ok":
            continue
        opath = dir_ / (jpath.stem + ".ops.json.gz")
        if not opath.exists():
            continue
        record = json.loads(gzip.decompress(opath.read_bytes()))
        cell.update(dryrun.summarize(
            record, configs.get_config(cell["arch"]),
            dryrun.shape_by_name(cell["shape"]), cell["n_chips"], consts))
        jpath.write_text(json.dumps(cell, indent=1))
        r = cell["roofline"]
        print(f"{jpath.stem}: dominant={r['dominant']} "
              f"mem={r['memory_s'] * 1e3:.1f}ms "
              f"comp={r['compute_s'] * 1e3:.1f}ms "
              f"coll={r['collective_s'] * 1e3:.1f}ms")
        done += 1
    return done


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default="runs/dryrun_torch")
    args = ap.parse_args()
    reanalyze(Path(args.dir))
