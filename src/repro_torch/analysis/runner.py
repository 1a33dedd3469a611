"""Pass orchestration: build one SourceTree, run the requested passes,
compare against the committed baseline (port of
``repro/analysis/runner.py``)."""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

from . import boundary, cache_keys, launch_lint, lifecycle, phases
from .framework import (DEFAULT_BASELINE, Finding, Reporter, SourceTree,
                        load_baseline)

PASSES = {
    "boundary": boundary.run,
    "lifecycle": lifecycle.run,
    "phase": phases.run,
    "launch": launch_lint.run,
    "cache-key": cache_keys.run,
}

DEFAULT_ROOT = Path(__file__).resolve().parents[1]    # src/repro_torch


@dataclasses.dataclass
class Report:
    findings: list[Finding]
    new: list[Finding]             # not in baseline
    stale: set[str]                # baseline entries no longer firing
    sanctioned: list[tuple[Finding, int]]   # suppressed, with a reason
    suppressions_used: int
    suppressions_total: int
    pass_seconds: dict[str, float]

    @property
    def ok(self) -> bool:
        return not self.new

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.pass_id] = out.get(f.pass_id, 0) + 1
        return out


def run_passes(root: Path | None = None, *,
               passes: list[str] | None = None,
               baseline: Path | None = None) -> Report:
    tree = SourceTree(root or DEFAULT_ROOT)
    reporter = Reporter(tree)
    timings: dict[str, float] = {}
    for name in (passes or list(PASSES)):
        t0 = time.perf_counter()
        PASSES[name](tree, reporter)
        timings[name] = time.perf_counter() - t0
    reporter.check_suppression_keys()

    base = load_baseline(baseline if baseline is not None
                         else DEFAULT_BASELINE)
    fired = {f.fingerprint for f in reporter.findings}
    new = [f for f in reporter.findings if f.fingerprint not in base]
    supps = [s for m in tree.modules for s in m.suppressions]
    return Report(
        findings=sorted(reporter.findings,
                        key=lambda f: (f.path, f.line, f.code)),
        new=sorted(new, key=lambda f: (f.path, f.line, f.code)),
        stale=base - fired,
        sanctioned=reporter.sanctioned,
        suppressions_used=sum(1 for s in supps if s.used),
        suppressions_total=len(supps),
        pass_seconds=timings,
    )
