"""Hot-path invariant analyzer of the PyTorch port: static AST and
call-graph passes over ``src/repro_torch``.

Port of ``repro/analysis`` (DESIGN.md §10's grammar).  The serving
engine's load-bearing invariants — one sanctioned pull per steady decode
step and no other wait for the card, the declared page-lifecycle state
machine, post-collect-only slot mutation in the async scheduler, ``ctypes``
bindings that match their CUDA entry points, and bucketed keys for caches
of compiled work — are held dynamically by the tests and ``chip_smoke.py``,
which catch a violating edit long after it lands.  These passes catch it
at the diff: ``python -m repro_torch.analysis`` runs all five over
``src/repro_torch`` and fails on any finding not in the committed
baseline.  The package imports only the standard library.

Passes (ids used in findings, suppressions, and ``--pass``):

* ``boundary``  — host syncs (``.item()``, ``.cpu()``, number conversions,
  ``torch.cuda.synchronize``, data-dependent shapes, pageable uploads)
  reachable from annotated hot-path roots (``# apack: hot-path-root``),
  see :mod:`.boundary`;
* ``lifecycle`` — ``self.state[pid] = PAGE_*`` sites vs the canonical
  ``PAGE_TRANSITIONS`` table in ``models/modules.py``, see
  :mod:`.lifecycle`;
* ``phase``     — slot-binding / page-table mutations reachable from the
  async engine's overlap window, see :mod:`.phases`;
* ``launch``    — ``ctypes`` ``argtypes``/``restype`` against the
  ``extern "C"`` entry points of ``kernels/csrc/*.cu``, call arities,
  unbound and missing entries, one ``_build.LAUNCHES`` count a launch,
  see :mod:`.launch_lint`;
* ``cache-key`` — unbucketed, float or tensor keys of ``*cache*`` dicts
  and ``lru_cache`` on tensor or float arguments, see :mod:`.cache_keys`.

Suppression grammar (one per line, trailing or the line above; a
suppression on the ``def`` line covers the whole function):

    # apack: allow-transfer(<reason>)      boundary
    # apack: allow-transition(<reason>)    lifecycle
    # apack: allow-phase(<reason>)         phase
    # apack: allow-launch(<reason>)        launch
    # apack: allow-cache-key(<reason>)     cache-key

A suppression with an empty reason is itself a finding.
"""

from .framework import (Finding, SourceTree, Reporter, load_baseline,
                        write_baseline, DEFAULT_BASELINE, PASS_IDS)
from .runner import run_passes

__all__ = ["Finding", "SourceTree", "Reporter", "load_baseline",
           "write_baseline", "DEFAULT_BASELINE", "PASS_IDS", "run_passes"]
