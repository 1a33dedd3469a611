"""Page-table helpers of the paged APack KV read path.

Port of two helpers of ``repro/kernels/paged_decode.py``: ``table_row``
(:68) and ``page_bucket`` (:113).  The gather-decode kernel of that module
(``gather_decode_pallas``) serves only the materialize oracle and preempt,
which this package does not port yet.
"""
from __future__ import annotations

# Per-job page-count buckets for the fused attention call: the engine sizes
# the page axis to the next power of two above the busiest active slot's
# occupied page count instead of the per-slot maximum.  Masked (FREE) page
# slots leave the online-softmax state exactly unchanged, so any bucket at
# or above the true count gives the same result.
PAGE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def table_row(gen: int, layer: int, kind: int, n_layers: int) -> int:
    """Flat row of table ``(generation, layer, kind)`` in the stacked
    ``[(G+1) * 2 * n_layers, ...]`` table pool.  ``kind`` (0 = K, 1 = V)
    varies fastest: the fused kernel receives only the K row per page and
    reads the V table at ``row + 1``."""
    return (gen * n_layers + layer) * 2 + kind


def page_bucket(n: int) -> int:
    n = max(int(n), 1)
    for b in PAGE_BUCKETS:
        if n <= b:
            return b
    bucket = PAGE_BUCKETS[-1]
    while bucket < n:
        bucket *= 2
    return bucket
