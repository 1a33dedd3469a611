"""APack symbol/probability-count table generation (paper Section VI).

Port of ``repro/core/tables.py`` (a numpy copy: the port imports nothing
of the JAX package, and tables are built on the host).

``find_table`` is the faithful reproduction of the paper's Listing 1:
initialize the 16 value ranges uniformly over ``[0, 2^bits)``, then a
recursive local search slides range boundaries (``v_min``) one step at a
time, scoring candidates with the entropy-estimated footprint
(``encoded_size``), recursing (DEPTH_MAX=2) on the neighbours (distance 1) of
a moved entry, and repeating whole rounds until the improvement over a round
drops below 1% (THRESHOLD=0.99).

After the boundaries are fixed, the 10-bit probability-count budget (1024)
is distributed proportionally to range frequencies.  For activations, a
post-pass "steals" one count for every empty range so values never seen
during profiling remain encodable (paper §VI "Final Adjustment for
Activations").
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .ac_golden import PCOUNT_TOTAL

N_SYMBOLS = 16
DEPTH_MAX = 2
THRESHOLD = 0.99
TABLE_OVERHEAD_BITS = 298 * 8   # paper §IV: range+probability tables = 298 bytes


@dataclasses.dataclass(frozen=True)
class ApackTable:
    """Symbol + probability count table (paper Table I).

    Attributes:
      v_min: ascending starts of the 16 ranges, with a sentinel
        ``v_min[16] == 2^bits`` (so ``v_max[i] = v_min[i+1] - 1``).
      ol:   offset bit-length per range, ``ceil(log2(range_size))``.
      cum:  cumulative probability counts, ``cum[0] == 0``,
        ``cum[16] == 1024``; symbol ``s`` owns ``[cum[s], cum[s+1])``.
      bits: input value bit-width.
      mode: which partitioning heuristic produced the table — "weight"
        (paper §IV: exact histogram, empty ranges get zero counts) or
        "activation" (§VI final adjustment: empty ranges keep one stolen
        count so unprofiled values stay encodable).
    """

    v_min: tuple[int, ...]
    ol: tuple[int, ...]
    cum: tuple[int, ...]
    bits: int = 8
    mode: str = "weight"

    def symbol_of(self, v: int) -> int:
        """Largest s with v_min[s] <= v (ranges are contiguous + exhaustive)."""
        # 16 entries: linear scan is what the HW comparator array does.
        s = 0
        for i in range(N_SYMBOLS):
            if self.v_min[i] <= v:
                s = i
        return s

    def symbol_of_cum(self, cum_val: int) -> int:
        s = 0
        for i in range(N_SYMBOLS):
            if self.cum[i] <= cum_val:
                s = i
        return s

    def as_arrays(self):
        return (np.asarray(self.v_min, np.int32), np.asarray(self.ol, np.int32),
                np.asarray(self.cum, np.int32))


def _ol_bits(size: int) -> int:
    return max(0, math.ceil(math.log2(size))) if size > 1 else 0


def histogram(values: np.ndarray, bits: int = 8) -> np.ndarray:
    """Value histogram h[0 .. 2^bits - 1] (paper: 2^8 buckets)."""
    return np.bincount(np.asarray(values).reshape(-1).astype(np.int64),
                       minlength=1 << bits).astype(np.int64)


_OL_LUT = np.array([_ol_bits(s) for s in range(0, (1 << 16) + 1)], np.float64)


def _encoded_size_csum(csum: np.ndarray, total: int, v_min: list[int],
                       bits: int) -> float:
    """O(16) scoring given a precomputed histogram cumsum."""
    if total == 0:
        return 0.0
    bounds = np.asarray(list(v_min) + [1 << bits])
    cnt = (csum[bounds[1:]] - csum[bounds[:-1]]).astype(np.float64)
    ol = _OL_LUT[bounds[1:] - bounds[:-1]]
    nz = cnt > 0
    p = cnt[nz] / total
    return float(np.sum(cnt[nz] * (-np.log2(p) + ol[nz])))


def encoded_size(hist: np.ndarray, v_min: list[int], bits: int = 8) -> float:
    """Entropy-estimated footprint in bits for a boundary configuration.

    Per range r: count_r * (-log2 p_r) symbol bits (ideal AC) plus
    count_r * OL_r verbatim offset bits.  This is the paper's
    ``encoded_size`` scoring function ("calculating the entropy of each
    range").
    """
    csum = np.concatenate([[0], np.cumsum(hist)])
    return _encoded_size_csum(csum, int(hist.sum()), v_min, bits)


def _valid(v_min: list[int], bits: int) -> bool:
    if v_min[0] != 0:
        return False
    for i in range(1, N_SYMBOLS):
        if v_min[i] <= v_min[i - 1]:
            return False
    return v_min[-1] < (1 << bits)


def _range_terms(csum: np.ndarray, total: int, bits: int) -> list:
    """``terms[lo][hi]``: the term that range ``[lo, hi)`` adds to
    ``_encoded_size_csum``, computed elementwise with the same numpy
    operations, or -1.0 where the range holds no value (the terms are never
    negative).  Built once per search, it turns each candidate's score into
    16 lookups and a sum."""
    n = (1 << bits) + 1
    idx = np.arange(n)
    width = np.clip(idx[None, :] - idx[:, None], 0, None)
    cnt = (csum[None, :n] - csum[:n, None]).astype(np.float64)
    nz = (cnt > 0) & (width > 0)
    t = np.full((n, n), -1.0)
    c = cnt[nz]
    t[nz] = c * (-np.log2(c / total) + _OL_LUT[width[nz]])
    return t.tolist()


def _np_sum(xs: list) -> float:
    """``np.sum`` of up to 16 float64 values, in numpy's own order: a plain
    loop below 8 values, else eight strided partial sums combined pairwise
    and the rest added one by one."""
    n = len(xs)
    if n < 8:
        r = 0.0
        for x in xs:
            r += x
        return r
    if n < 16:
        res = (((xs[0] + xs[1]) + (xs[2] + xs[3]))
               + ((xs[4] + xs[5]) + (xs[6] + xs[7])))
        for x in xs[8:]:
            res += x
        return res
    return ((((xs[0] + xs[8]) + (xs[1] + xs[9]))
             + ((xs[2] + xs[10]) + (xs[3] + xs[11])))
            + (((xs[4] + xs[12]) + (xs[5] + xs[13]))
               + ((xs[6] + xs[14]) + (xs[7] + xs[15]))))


def _search(score, v_min: list[int], minsize: float, depth: int,
            around: int, nvals: int):
    """Paper Listing 1 ``search()``: slide each eligible v_min in both
    directions, evaluating every position; recurse on neighbours while
    depth < DEPTH_MAX.  ``v_min`` is valid, so a slide of entry ``i``
    stays valid while it lies strictly between its neighbours."""
    best_v, best_size = list(v_min), minsize
    for i in range(1, N_SYMBOLS):
        if around >= 1 and abs(i - around) != 1:
            continue
        lo = v_min[i - 1]
        hi = v_min[i + 1] if i + 1 < N_SYMBOLS else nvals
        for delta in (-1, +1):
            cand = list(v_min)
            while True:
                cand = list(cand)
                cand[i] += delta
                if not lo < cand[i] < hi:
                    break
                if depth < DEPTH_MAX:
                    sub_v, sub_size = _search(score, cand, best_size,
                                              depth + 1, i, nvals)
                    if sub_size < best_size:
                        best_v, best_size = sub_v, sub_size
                size = score(cand)
                if size < best_size:
                    best_v, best_size = list(cand), size
    return best_v, best_size


def _assign_counts(hist: np.ndarray, v_min: list[int], bits: int,
                   steal_for_empty: bool) -> list[int]:
    """Distribute the 1024-count budget proportionally to range frequencies.

    Largest-remainder rounding; every non-empty range gets >= 1 count; with
    ``steal_for_empty`` every empty range also gets 1 (stolen from the
    largest entry) so unseen values stay encodable.
    """
    csum = np.concatenate([[0], np.cumsum(hist)])
    bounds = list(v_min) + [1 << bits]
    counts = np.array([int(csum[bounds[r + 1]] - csum[bounds[r]])
                       for r in range(N_SYMBOLS)], dtype=np.float64)
    total = counts.sum()
    if total == 0:
        counts[:] = 1.0
        total = counts.sum()
    raw = counts * PCOUNT_TOTAL / total
    alloc = np.floor(raw).astype(np.int64)
    # every non-empty range needs >= 1
    alloc = np.where((counts > 0) & (alloc == 0), 1, alloc)
    if steal_for_empty:
        alloc = np.where(alloc == 0, 1, alloc)
    # fix the sum to exactly PCOUNT_TOTAL via largest remainders
    diff = PCOUNT_TOTAL - int(alloc.sum())
    order = np.argsort(-(raw - np.floor(raw)))
    i = 0
    while diff != 0:
        idx = order[i % N_SYMBOLS]
        if diff > 0:
            alloc[idx] += 1
            diff -= 1
        else:
            floor_ = 1 if (counts[idx] > 0 or steal_for_empty) else 0
            if alloc[idx] > floor_:
                alloc[idx] -= 1
                diff += 1
        i += 1
        if i > 16 * PCOUNT_TOTAL:   # pragma: no cover - safety valve
            raise RuntimeError("count assignment failed to converge")
    return [int(c) for c in alloc]


def _search_rounds(csum: np.ndarray, total: int, v_min: list[int],
                   bits: int, max_rounds: int) -> list[int]:
    nvals = 1 << bits
    terms = _range_terms(csum, total, bits)
    memo: dict = {}

    def score(cfg: list[int]) -> float:
        # ``_encoded_size_csum(csum, total, cfg, bits)``, bit for bit
        key = tuple(cfg)
        s = memo.get(key)
        if s is None:
            xs = [terms[a][b] for a, b in zip(key, key[1:] + (nvals,))]
            s = _np_sum([x for x in xs if x >= 0.0])
            memo[key] = s
        return s

    size = score(v_min)
    for _ in range(max_rounds):
        v_min, newsize = _search(score, v_min, size, 1, -1, nvals)
        if size <= 0 or newsize / max(size, 1e-9) >= THRESHOLD:
            break
        size = newsize
    return v_min


def find_table(hist: np.ndarray, bits: int = 8, is_activation: bool = False,
               max_rounds: int = 64) -> ApackTable:
    """Paper Listing 1 ``findPT()``: uniform init, search rounds until <1% gain.

    For bits > 8 the exhaustive boundary slide over a 2^bits value space is
    intractable; we run the same search at 256-bucket granularity (each
    bucket = 2^(bits-8) values) and then refine each boundary locally at
    full resolution — the paper notes "the same process can be applied to
    input of any bit length" without prescribing the 16-bit search schedule.
    """
    hist = np.asarray(hist, np.int64)
    nvals = 1 << bits
    csum = np.concatenate([[0], np.cumsum(hist)])
    total = int(hist.sum())
    if bits <= 8:
        step = nvals // N_SYMBOLS
        v_min = [i * step for i in range(N_SYMBOLS)]
        v_min = _search_rounds(csum, total, v_min, bits, max_rounds)
    else:
        shift = bits - 8
        coarse_hist = hist.reshape(256, -1).sum(axis=1)
        ccsum = np.concatenate([[0], np.cumsum(coarse_hist)])
        cv = _search_rounds(ccsum, total, [i * 16 for i in range(N_SYMBOLS)],
                            8, max_rounds)
        v_min = [b << shift for b in cv]
        # local refinement: each boundary hill-climbs within its bucket
        size = _encoded_size_csum(csum, total, v_min, bits)
        for i in range(1, N_SYMBOLS):
            for delta in (-1, +1):
                while True:
                    cand = list(v_min)
                    cand[i] += delta
                    if not _valid(cand, bits):
                        break
                    s = _encoded_size_csum(csum, total, cand, bits)
                    if s >= size:
                        break
                    v_min, size = cand, s
    counts = _assign_counts(hist, v_min, bits, steal_for_empty=is_activation)
    cum = [0]
    for c in counts:
        cum.append(cum[-1] + c)
    bounds = v_min + [nvals]
    ol = [_ol_bits(bounds[i + 1] - bounds[i]) for i in range(N_SYMBOLS)]
    return ApackTable(v_min=tuple(v_min + [nvals]), ol=tuple(ol),
                      cum=tuple(cum), bits=bits,
                      mode="activation" if is_activation else "weight")


def expected_bits_per_value(hist: np.ndarray, table: ApackTable) -> float:
    """Entropy-model estimate of coded bits/value for data distributed as
    ``hist`` when coded with ``table``.

    Per value ``v`` in symbol range ``s``: ``-log2(pcount[s] / 1024)``
    ideal-AC symbol bits plus ``ol[s]`` verbatim offset bits.  Values whose
    range holds zero probability counts are unencodable in AC; the encoder
    falls back to stored mode for such streams, so the estimate clamps at
    ``bits`` (the stored-mode width) — this is exactly the "degrade toward
    stored-mode widths" failure mode of a drifted table, which makes the
    clamped estimate the drift-monitor cost function: the ratio of this
    number on a *recent* histogram vs. the histogram the table was built
    from is the compression-ratio regression a refresh trigger watches.

    O(2^bits) numpy; cheap enough to run per drift check."""
    hist = np.asarray(hist, np.float64)
    total = hist.sum()
    if total == 0:
        return 0.0
    nvals = hist.shape[0]
    v_min = np.asarray(table.v_min[:N_SYMBOLS])
    # symbol_of(v): largest s with v_min[s] <= v
    sym = np.searchsorted(v_min, np.arange(nvals), side="right") - 1
    pcount = np.diff(np.asarray(table.cum, np.float64))
    ol = np.asarray(table.ol, np.float64)
    per_sym = np.where(pcount > 0,
                       -np.log2(np.maximum(pcount, 1) / PCOUNT_TOTAL)
                       + ol, np.inf)
    per_val = np.minimum(per_sym[sym], float(table.bits))
    return float(np.sum(hist * per_val) / total)


def uniform_table(bits: int = 8) -> ApackTable:
    """The search's starting point — also the worst-case/fallback table."""
    nvals = 1 << bits
    step = nvals // N_SYMBOLS
    v_min = [i * step for i in range(N_SYMBOLS)]
    counts = [PCOUNT_TOTAL // N_SYMBOLS] * N_SYMBOLS
    cum = [0]
    for c in counts:
        cum.append(cum[-1] + c)
    bounds = v_min + [nvals]
    ol = [_ol_bits(bounds[i + 1] - bounds[i]) for i in range(N_SYMBOLS)]
    return ApackTable(v_min=tuple(v_min + [nvals]), ol=tuple(ol), cum=tuple(cum),
                      bits=bits)


def table_for(values: np.ndarray, bits: int = 8, is_activation: bool = False) -> ApackTable:
    return find_table(histogram(values, bits), bits, is_activation)
