"""The dry run's table from its JSONs, in H100 milliseconds.

Port of ``repro/launch/report.py``: one row a cell, its dominant term,
the busiest device's compute, memory and collective milliseconds
(estimates for the NVIDIA H100 80GB HBM3 at 700 W, ``dryrun.H100``), the
useful-FLOPs ratio, the peak GB a device (marked where it is over the
card's 80 GB), the seconds the count took and whether it took the
shortcut (``dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.report --dir runs/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch import configs
from repro_torch.models.config import ALL_SHAPES

HEADER = ("| arch | shape | mesh | dominant | compute_ms | memory_ms | "
          "collective_ms | useful_flops | peak_GB | count_s | note |\n"
          "|---|---|---|---|---|---|---|---|---|---|---|")


def rows(dir_: Path, mesh: str | None = None) -> list[str]:
    out = []
    order = {s.name: i for i, s in enumerate(ALL_SHAPES)}
    arch_order = {a: i for i, a in enumerate(configs.all_arch_ids())}
    cells = [json.loads(p.read_text()) for p in sorted(dir_.glob("*.json"))]
    cells.sort(key=lambda c: (arch_order.get(c["arch"], 99),
                              order.get(c["shape"], 9), c["mesh"]))
    for c in cells:
        if mesh and c["mesh"] != mesh:
            continue
        if c["status"] != "ok":
            out.append(f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
                       f"SKIP: {c['reason']} | | | | | | | |")
            continue
        r, mem = c["roofline"], c["memory"]
        note = []
        if mem["over_hbm"]:
            note.append("over 80 GB")
        if c.get("shortcut"):
            note.append("shortcut")
        if c.get("runs_otherwise"):
            note.append(c["runs_otherwise"])
        out.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | {r['dominant']} | "
            f"{r['compute_s'] * 1e3:.2f} | {r['memory_s'] * 1e3:.2f} | "
            f"{r['collective_s'] * 1e3:.2f} | "
            f"{r['useful_flops_ratio']:.3f} | "
            f"{mem['peak_bytes'] / 1e9:.1f} | {c['count_s']:.0f} | "
            f"{'; '.join(note)} |")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default="runs/dryrun_torch")
    ap.add_argument("--out", default="DRYRUN_TABLE.md")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args()
    lines = [
        "# Dry-run table: every (arch x shape x mesh) cell, H100 estimates",
        "",
        "Generated from the dry run's JSONs by `repro_torch.launch.report`.",
        "Terms are the busiest device's seconds (ms shown) at the NVIDIA",
        "H100 80GB HBM3's peaks (700 W data sheet, `dryrun.H100`).",
        "", HEADER,
    ]
    lines += rows(Path(args.dir), args.mesh)
    Path(args.out).write_text("\n".join(lines) + "\n")
    print(f"wrote {args.out} ({len(lines)} lines)")


if __name__ == "__main__":
    main()
