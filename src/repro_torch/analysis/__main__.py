"""CLI: ``python -m repro_torch.analysis`` — run the invariant passes
over ``src/repro_torch`` and exit non-zero on any finding not in the
committed baseline (port of ``repro/analysis/__main__.py``).

    python -m repro_torch.analysis                  # full tree, all passes
    python -m repro_torch.analysis --pass launch    # one pass
    python -m repro_torch.analysis --changed        # report only files in
                                                    # the working diff
                                                    # (analysis is still
                                                    # whole-program)
    python -m repro_torch.analysis --json out.json  # machine-readable
    python -m repro_torch.analysis --write-baseline # grandfather findings
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from .framework import DEFAULT_BASELINE, PASS_IDS, write_baseline
from .runner import DEFAULT_ROOT, run_passes


def _changed_files(root: Path) -> set[str] | None:
    """Files changed against HEAD under ``root``, relative to it (None
    where ``root`` is not in a git checkout)."""
    try:
        out = subprocess.run(
            ["git", "diff", "--name-only", "--relative", "HEAD"], cwd=root,
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return {line.strip() for line in out.splitlines() if line.strip()}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="hot-path invariant analyzer of the PyTorch port (the "
                    "grammar of DESIGN.md §10)")
    ap.add_argument("--root", type=Path, default=DEFAULT_ROOT,
                    help="source tree to analyze (default: src/repro_torch)")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=PASS_IDS, help="run only this pass (repeat ok)")
    ap.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE)
    ap.add_argument("--json", type=Path, nargs="?", const=Path("-"),
                    help="emit findings as JSON (to PATH, or stdout if "
                         "no path given)")
    ap.add_argument("--changed", action="store_true",
                    help="only *report* findings in files changed vs HEAD")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline to the current findings")
    args = ap.parse_args(argv)

    report = run_passes(args.root, passes=args.passes,
                        baseline=args.baseline)

    if args.write_baseline:
        write_baseline(args.baseline, report.findings)
        print(f"baseline: wrote {len(report.findings)} finding(s) to "
              f"{args.baseline}")
        return 0

    shown = report.new
    if args.changed:
        changed = _changed_files(args.root.resolve())
        if changed is not None:
            shown = [f for f in shown if f.path in changed]

    counts = report.counts()
    json_to_stdout = args.json is not None and str(args.json) == "-"
    if not json_to_stdout:
        for f in shown:
            print(f.render())
        per_pass = ", ".join(f"{p}={counts.get(p, 0)}" for p in PASS_IDS)
        print(f"analysis: {len(report.findings)} finding(s) [{per_pass}], "
              f"{len(report.new)} new vs baseline, "
              f"{report.suppressions_used}/{report.suppressions_total} "
              "suppressions used")
        if report.stale:
            print(f"analysis: {len(report.stale)} baseline entr"
                  f"{'y is' if len(report.stale) == 1 else 'ies are'} stale "
                  "(fixed findings) — run --write-baseline to shrink it")

    if args.json is not None:
        payload = json.dumps({
            "findings": [f.to_json() for f in report.findings],
            "new": [f.to_json() for f in report.new],
            "counts": counts,
            "stale_baseline": sorted(report.stale),
            "suppressions": {"used": report.suppressions_used,
                             "total": report.suppressions_total},
            # the findings a suppression with a reason took, with the lines
            # their construct spans (a run on the card holds the syncs it
            # observes against the boundary pass's)
            "sanctioned": [{**f.to_json(), "end_line": end}
                           for f, end in report.sanctioned],
            "pass_seconds": report.pass_seconds,
        }, indent=2) + "\n"
        if json_to_stdout:
            sys.stdout.write(payload)
        else:
            args.json.write_text(payload)

    if shown or (not args.changed and report.new):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
