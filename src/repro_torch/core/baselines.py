"""The paper's comparison compressors (§VII "Compression Methods").

Port of ``repro/core/baselines.py`` (a numpy copy: the port imports
nothing of the JAX package).

All return footprints in bits for a uint value array; ratios are
``orig_bits / footprint``.  These are size models (the paper evaluates them
for traffic, not as hardware): RLE/RLEZ tuples and ShapeShifter group
encoding are deterministic given the value stream, so exact footprints need
no bitstream materialization.
"""
from __future__ import annotations

import numpy as np

RLE_DIST_BITS = 4           # paper: distance limited to 15 -> 4-bit overhead
SS_GROUP = 8                # paper: group of 8 values, as in ShapeShifter
SS_PREC_FIELD = 3           # log2(Pmax=8) bits to encode the group precision


def rle_bits(values: np.ndarray, bits: int = 8) -> int:
    """(value, distance) tuples; distance = following run of equal values,
    capped at 2^4 - 1."""
    v = np.asarray(values).reshape(-1)
    if v.size == 0:
        return 0
    # run-length encode
    change = np.nonzero(np.diff(v))[0]
    run_starts = np.concatenate([[0], change + 1])
    run_ends = np.concatenate([change + 1, [v.size]])
    run_lens = run_ends - run_starts
    max_run = 1 << RLE_DIST_BITS
    n_tuples = int(np.sum(-(-run_lens // max_run)))
    return n_tuples * (bits + RLE_DIST_BITS)


def rlez_bits(values: np.ndarray, bits: int = 8) -> int:
    """(value, zero-distance) tuples; each tuple stores one value and the
    count of zeros following it (capped at 15)."""
    v = np.asarray(values).reshape(-1)
    if v.size == 0:
        return 0
    nz_idx = np.nonzero(v)[0]
    # zeros before the first nonzero need carrier tuples too
    n_tuples = 0
    prev_end = 0
    max_run = (1 << RLE_DIST_BITS) - 1
    # leading zeros: emit (0, run) tuples
    first_nz = nz_idx[0] if nz_idx.size else v.size
    lead = first_nz
    n_tuples += -(-lead // (max_run + 1)) if lead else 0
    # each nonzero emits one tuple covering itself + up to 15 zeros after;
    # longer zero runs need (0, run) filler tuples
    if nz_idx.size:
        gaps = np.diff(np.concatenate([nz_idx, [v.size]])) - 1
        n_tuples += nz_idx.size
        over = np.maximum(gaps - max_run, 0)
        n_tuples += int(np.sum(-(-over // (max_run + 1))))
    return n_tuples * (bits + RLE_DIST_BITS)


def shapeshifter_bits(values: np.ndarray, bits: int = 8,
                      group: int = SS_GROUP, zero_vector: bool = True) -> int:
    """ShapeShifter [36]: per group of G values, the minimal precision P
    covering the group, costing G*P + log2(Pmax) bits.  The 8-bit-optimized
    variant adds a per-value zero bit-vector and packs only nonzeros.

    Returns the better of the two encodings per tensor (the paper evaluates
    its tuned variant; we give it the benefit of both)."""
    v = np.asarray(values).reshape(-1).astype(np.int64)
    n = v.size
    if n == 0:
        return 0
    pad = (-n) % group
    if pad:
        v = np.concatenate([v, np.zeros(pad, np.int64)])
    g = v.reshape(-1, group)
    # ShapeShifter drops prefixes of 0s (near zero) *or* 1s (near 2^bits, i.e.
    # small negatives in two's complement): precision P(v) = smallest p such
    # that sign-extending the low p bits reproduces v.
    half = 1 << (bits - 1)
    signed = np.where(g >= half, g - (1 << bits), g)
    mag = np.where(signed >= 0, signed + 1, -signed)   # needs ceil(log2(mag))+1
    nbits = np.ceil(np.log2(np.maximum(mag, 1))).astype(np.int64) + 1
    nbits = np.clip(nbits, 1, bits)
    p_plain = nbits.max(axis=1)
    plain = int(np.sum(group * p_plain + SS_PREC_FIELD))
    # zero-vector variant: G mask bits + count(nonzero)*P + precision field
    nz_mask = g != 0
    nbits_nz = np.where(nz_mask, nbits, 0)
    p_zv = nbits_nz.max(axis=1)
    p_zv = np.maximum(p_zv, 1)
    zv = int(np.sum(group + nz_mask.sum(axis=1) * p_zv + SS_PREC_FIELD))
    return min(plain, zv)


def baseline_bits(values: np.ndarray, bits: int = 8) -> int:
    return int(np.asarray(values).size) * bits
