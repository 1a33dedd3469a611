"""Bit-exact pure-Python reference of the APack arithmetic codec.

Port of ``repro/core/ac_golden.py`` (a verbatim copy: the port imports
nothing of the JAX package).

This is the *contract*: ``kernels/ref.py`` (vectorized torch) and the CUDA
kernels must produce byte-identical streams.  It implements the paper's
finite-precision arithmetic coder (Section V): 16-bit HI/LO windows, 10-bit
probability counts, common-prefix emission and underflow (UBC) handling —
i.e. the classic Witten–Neal–Cleary / Nelson integer coder the paper says it
is "inspired by", with the (symbol, offset) split of Section IV: only the
symbol index is arithmetically coded, the offset is stored verbatim.

Bitstream convention (fixed across the whole codebase):
  * a stream is a sequence of bits; bit ``i`` lives in 32-bit word ``i // 32``
    at bit position ``i % 32`` (LSB-first within a word);
  * multi-bit fields are appended LSB-first.

The paper emits offsets MSB-first into its hardware shift registers; the
order within the offset field is an internal convention with no effect on
size — we pick LSB-first so that a k-bit read returns the field directly.
"""
from __future__ import annotations

from typing import Sequence

CODE_BITS = 16
TOP = (1 << CODE_BITS) - 1          # 0xFFFF
HALF = 1 << (CODE_BITS - 1)        # 0x8000
QUARTER = 1 << (CODE_BITS - 2)     # 0x4000
THREEQ = HALF + QUARTER            # 0xC000
PCOUNT_BITS = 10
PCOUNT_TOTAL = 1 << PCOUNT_BITS    # 1024
# Max renormalization shifts after one symbol: post-renorm range > QUARTER,
# a min-probability (1/1024) symbol shrinks it to >= 16, and 16 << k > QUARTER
# needs k = 11.  We use 12 everywhere (golden asserts the bound holds).
MAX_RENORM = 12
# Pending-underflow-bit cap; exceeding it trips stored-mode (prob ~2^-24 per
# stream on real data — the golden encoder raises so tests would catch it).
MAX_PENDING = 24


class BitWriter:
    def __init__(self) -> None:
        self.bits: list[int] = []

    def put_bit(self, b: int) -> None:
        self.bits.append(b & 1)

    def put_bits(self, value: int, n: int) -> None:
        for i in range(n):                      # LSB-first
            self.bits.append((value >> i) & 1)

    def __len__(self) -> int:
        return len(self.bits)

    def to_words(self) -> list[int]:
        words = [0] * ((len(self.bits) + 31) // 32)
        for i, b in enumerate(self.bits):
            if b:
                words[i // 32] |= 1 << (i % 32)
        return words


class BitReader:
    def __init__(self, words: Sequence[int], nbits: int | None = None) -> None:
        self.words = list(words)
        self.pos = 0
        self.nbits = nbits if nbits is not None else 32 * len(self.words)

    def get_bit(self) -> int:
        # Past-the-end reads return 0 (decoder may over-read its CODE window
        # near stream end; the encoder's termination guarantees correctness).
        if self.pos >= self.nbits:
            self.pos += 1
            return 0
        b = (self.words[self.pos // 32] >> (self.pos % 32)) & 1
        self.pos += 1
        return b

    def get_bits(self, n: int) -> int:
        v = 0
        for i in range(n):                      # LSB-first
            v |= self.get_bit() << i
        return v


def encode_stream(values: Sequence[int], table) -> tuple[list[int], int, list[int], int]:
    """Encode one stream of uint values.

    Args:
      values: uint values, each in ``[0, 2^table.bits)``.
      table: an ``ApackTable`` (see core/tables.py) with fields
        ``v_min[17]`` (sentinel-terminated ascending), ``ol[16]``,
        ``cum[17]`` (cumulative probability counts, cum[16] == 1024).

    Returns:
      (sym_words, sym_bits, ofs_words, ofs_bits)
    """
    sym = BitWriter()
    ofs = BitWriter()
    low, high, pending = 0, TOP, 0

    def emit(bit: int) -> None:
        nonlocal pending
        sym.put_bit(bit)
        inv = bit ^ 1
        for _ in range(pending):
            sym.put_bit(inv)
        pending = 0

    for v in values:
        s = table.symbol_of(int(v))
        if table.cum[s + 1] <= table.cum[s]:
            raise ValueError(f"value {v} maps to zero-probability symbol {s}")
        ofs.put_bits(int(v) - table.v_min[s], table.ol[s])
        rng = high - low + 1
        high = low + (rng * table.cum[s + 1]) // PCOUNT_TOTAL - 1
        low = low + (rng * table.cum[s]) // PCOUNT_TOTAL
        shifts = 0
        while True:
            if high < HALF:
                emit(0)
            elif low >= HALF:
                emit(1)
                low -= HALF
                high -= HALF
            elif low >= QUARTER and high < THREEQ:
                pending += 1
                if pending > MAX_PENDING:
                    raise OverflowError("pending underflow bits exceeded cap")
                low -= QUARTER
                high -= QUARTER
            else:
                break
            low = low * 2
            high = high * 2 + 1
            shifts += 1
            assert shifts <= MAX_RENORM, "renormalization bound violated"

    # Termination (WNC): disambiguate the final quarter.
    pending += 1
    if low < QUARTER:
        emit(0)
    else:
        emit(1)
    return sym.to_words(), len(sym), ofs.to_words(), len(ofs)


def decode_stream(sym_words: Sequence[int], ofs_words: Sequence[int],
                  n: int, table, sym_bits: int | None = None,
                  ofs_bits: int | None = None) -> list[int]:
    """Decode ``n`` values from a (symbol, offset) stream pair."""
    sr = BitReader(sym_words, sym_bits)
    orr = BitReader(ofs_words, ofs_bits)
    low, high = 0, TOP
    code = 0
    for _ in range(CODE_BITS):                  # stream order = MSB of CODE first
        code = (code << 1) | sr.get_bit()
    out: list[int] = []
    for _ in range(n):
        rng = high - low + 1
        cum = ((code - low + 1) * PCOUNT_TOTAL - 1) // rng
        s = table.symbol_of_cum(cum)
        out.append(table.v_min[s] + orr.get_bits(table.ol[s]))
        high = low + (rng * table.cum[s + 1]) // PCOUNT_TOTAL - 1
        low = low + (rng * table.cum[s]) // PCOUNT_TOTAL
        while True:
            if high < HALF:
                pass
            elif low >= HALF:
                low -= HALF
                high -= HALF
                code -= HALF
            elif low >= QUARTER and high < THREEQ:
                low -= QUARTER
                high -= QUARTER
                code -= QUARTER
            else:
                break
            low = low * 2
            high = high * 2 + 1
            code = (code << 1) | sr.get_bit()
    return out
