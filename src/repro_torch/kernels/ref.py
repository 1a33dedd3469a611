"""Vectorized plain-PyTorch multi-stream APack codec — the kernels' oracle.

Port of ``repro/kernels/ref.py``.  S independent substreams are coded in
lockstep, one stream per tensor lane, with a Python loop in place of
``lax.scan``.  The arithmetic is the finite-precision coder of
``core/ac_golden.py`` (16-bit HI/LO windows, 10-bit counts, multi-bit WNC
renormalization) and is bit-exact against it and against the JAX package.

torch has no general uint32 arithmetic and ``>>`` on int32 is arithmetic,
so every u32 quantity here is held in ``int64`` and masked to 32 bits;
``shr32``/``shl32`` stay logical and give 0 for shifts of 32.  Planes cross
the module boundary as ``int32`` tensors holding the u32 bits, the layout
the CUDA kernels reinterpret as ``uint32_t``.

Every function takes an optional leading batch axis (one batch row per
page, each with its own table row), the written-out form of ``vmap``.
"""
from __future__ import annotations

import torch

from repro_torch.core.ac_golden import (HALF, MAX_PENDING, MAX_RENORM,
                                        PCOUNT_BITS, QUARTER, TOP)

I64 = torch.int64
I32 = torch.int32
M32 = 0xFFFFFFFF


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """u32 bits held in any int tensor -> int64 values in [0, 2^32)."""
    return x.to(I64) & M32


def as_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> int32 tensor with the same 32 bits."""
    return (((x & M32) ^ 0x80000000) - 0x80000000).to(I32)


def table_tensors(table, device="cpu"):
    """``(v_min i32[17], ol i32[16], cum i32[17])`` of an ``ApackTable``."""
    return (torch.tensor(table.v_min, dtype=I32, device=device),
            torch.tensor(table.ol, dtype=I32, device=device),
            torch.tensor(table.cum, dtype=I32, device=device))


# --------------------------------------------------------------- bit helpers
def shr32(x: torch.Tensor, k) -> torch.Tensor:
    """Logical right shift of u32 values, correct for k in [0, 32]."""
    k = torch.as_tensor(k, dtype=I64, device=x.device)
    return torch.where(k >= 32, torch.zeros_like(x),
                       (x & M32) >> k.clamp(0, 31))


def shl32(x: torch.Tensor, k) -> torch.Tensor:
    """Left shift of u32 values (result masked to 32 bits), k in [0, 32]."""
    k = torch.as_tensor(k, dtype=I64, device=x.device)
    return torch.where(k >= 32, torch.zeros_like(x),
                       ((x & M32) << k.clamp(0, 31)) & M32)


def _bitlen16_ref(x: torch.Tensor) -> torch.Tensor:
    b = torch.zeros_like(x)
    for s in (8, 4, 2, 1):
        big = x >= (1 << s)
        b = b + torch.where(big, s, 0)
        x = torch.where(big, x >> s, x)
    return b + (x > 0).to(x.dtype)


def _rev16_ref(w: torch.Tensor) -> torch.Tensor:
    w = w & M32
    w = ((w & 0x5555) << 1) | ((w >> 1) & 0x5555)
    w = ((w & 0x3333) << 2) | ((w >> 2) & 0x3333)
    w = ((w & 0x0F0F) << 4) | ((w >> 4) & 0x0F0F)
    w = ((w & 0x00FF) << 8) | ((w >> 8) & 0x00FF)
    return w & 0xFFFF


# 64K-entry lookup tables per device, filled from the reference bit tricks
# above: one gather per call instead of a dozen elementwise ops.
_BITLEN16: dict = {}
_REV16: dict = {}


def _table(cache: dict, fn, device) -> torch.Tensor:
    key = str(device)
    if key not in cache:
        cache[key] = fn(torch.arange(1 << 16, dtype=I64)).to(device)
    return cache[key]


def bitlen16(x: torch.Tensor) -> torch.Tensor:
    """Bit length of x in [0, 0xFFFF] (0 -> 0); like the reference's binary
    search, negatives give 0 and values past 0xFFFF give 16."""
    return _table(_BITLEN16, _bitlen16_ref, x.device)[x.clamp(0, 0xFFFF)]


def rev16(w: torch.Tensor) -> torch.Tensor:
    """Reverse the low 16 bits (bit 0 <-> bit 15)."""
    return _table(_REV16, _rev16_ref, w.device)[w & 0xFFFF]


def renorm_counts(low: torch.Tensor, high: torch.Tensor):
    """Closed-form WNC renormalization: ``(m, u, low', high')`` — ``m``
    matched leading bits, then ``u`` underflow shifts (``ref.py:77``).
    Both counts lie in [0, 16], so the shifts below need no 32-bit guard."""
    m = 16 - bitlen16(low ^ high)
    low_m = (low << m) & 0xFFFF
    high_m = ((high << m) | ((1 << m) - 1)) & 0xFFFF
    t = (low_m & ~high_m) & 0xFFFF
    u = 16 - bitlen16(~(t << 1) & 0xFFFF)
    low_f = (low_m << u) & 0x7FFF
    high_f = ((high_m << u) & 0x7FFF) | HALF | ((1 << u) - 1)
    return m, u, low_f, high_f


def read_bits(plane: torch.Tensor, pos: torch.Tensor,
              k: torch.Tensor) -> torch.Tensor:
    """Read k (<= 16) bits LSB-first at bit ``pos`` of each stream of a
    u32 plane [..., W, S]; words past the plane end read as zero (the
    decoder over-reads its CODE window by up to 16 bits near a stream's
    end).  Shifts: ``off`` < 32, and ``32 - off`` = 32 clears r1 through
    the 32-bit mask, as the reference's guarded shift does."""
    n_words = plane.shape[-2]
    w = (pos >> 5).unsqueeze(-2) + torch.arange(2, device=pos.device)[:, None]
    r = torch.gather(plane, -2, w.clamp(0, n_words - 1))
    r = torch.where(w < n_words, r, 0)
    off = pos & 31
    window = (r[..., 0, :] >> off) | ((r[..., 1, :] << (32 - off)) & M32)
    return window & ((1 << k) - 1)


def decode_renorm(low, high, code, spos, low2, high2, sym_plane, stored):
    """Decoder side of the multi-bit renormalization (``ref.py:104``):
    consume all m+u stream bits in one read; stored lanes keep their AC
    state frozen.  ``code`` follows the JAX package's i32 wrap.  Every
    shift here is by at most 16."""
    m, u, low3, high3 = renorm_counts(low2, high2)
    k = torch.clamp(m + u, max=16)
    u = torch.minimum(u, k - torch.minimum(m, k))
    r = rev16(read_bits(sym_plane, spos, k)) >> (16 - k)
    ufill = (1 << u) - 1
    code_m = ((code << m) & 0xFFFF) | (r >> u)
    code3 = as_i32_bits((code_m << u) - HALF * ufill + (r & ufill)).to(I64)
    low3 = torch.where(stored, low, low3)
    high3 = torch.where(stored, high, high3)
    code3 = torch.where(stored, code, code3)
    spos3 = spos + torch.where(stored, 0, k)
    return low3, high3, code3, spos3


def encode_renorm(low2, high2, pending):
    """Encoder side of the multi-bit renormalization (``ref.py:133``):
    ``(low, high, pending', pat1, k1, pat2, k2)``."""
    m, u, low, high = renorm_counts(low2, high2)
    has = m > 0
    ones = torch.ones_like(low2)
    prefix = rev16(low2) & (shl32(ones, m) - 1)
    b1 = prefix & 1
    inv_run = ((shl32(ones, pending) - 1) * (1 - b1)) & M32
    k1 = torch.where(has, 1 + pending, 0)
    pat1 = torch.where(has, (b1 | (inv_run << 1)) & M32, 0)
    k2 = torch.where(has, m - 1, 0)
    pending = torch.where(has, u, pending + u)
    return low, high, pending, pat1, k1, prefix >> 1, k2


# ------------------------------------------------------------------- decode
def _tables(v_min, ol, cum, lead):
    """Table arrays as int64 with the batch axes ``lead`` (broadcast)."""
    def one(t, n):
        t = t.to(I64)
        return t.expand(*lead, n) if t.dim() == 1 else t.reshape(*lead, n)
    return one(v_min, 17), one(ol, 16), one(cum, 17)


def decode(sym_plane: torch.Tensor, ofs_plane: torch.Tensor,
           stored: torch.Tensor, v_min: torch.Tensor, ol: torch.Tensor,
           cum: torch.Tensor, n_steps: int, bits: int = 8) -> torch.Tensor:
    """Decode S streams of ``n_steps`` values (``ref.py:184``).

    sym_plane [..., Ws, S] / ofs_plane [..., Wo, S] hold u32 bits (any int
    dtype); stored [..., S]; table arrays [17]/[16]/[17] or one row per
    leading index.  Returns int32 [..., S, n_steps]."""
    lead = tuple(sym_plane.shape[:-2])
    s = sym_plane.shape[-1]
    sym = as_u32(sym_plane)
    ofs = as_u32(ofs_plane)
    stored = stored.to(torch.bool)
    vm, olt, cm = _tables(v_min, ol, cum, lead)
    cum_lo = cm[..., :-1].unsqueeze(-2)                  # [..., 1, 16]
    # per-symbol (ol, cum[s], cum[s+1], v_min[s]): one gather per step
    tab = torch.stack([olt, cm[..., :-1], cm[..., 1:], vm[..., :-1]], -1)
    zeros = torch.zeros(*lead, s, dtype=I64, device=sym.device)
    code = rev16(read_bits(sym, zeros, zeros + 16))
    low, high = zeros, zeros + TOP
    spos, opos = zeros + 16, zeros
    out = torch.empty(*lead, s, n_steps, dtype=I32, device=sym.device)
    for i in range(n_steps):
        rng = high - low + 1
        cum_val = torch.div((code - low + 1) * (1 << PCOUNT_BITS) - 1, rng,
                            rounding_mode="floor")
        s_idx = ((cum_val.unsqueeze(-1) >= cum_lo).sum(-1) - 1).clamp(min=0)
        ol_s, clo, chi, vmin = torch.gather(
            tab, -2, s_idx.unsqueeze(-1).expand(*s_idx.shape, 4)).unbind(-1)
        # stored lanes read raw `bits`-wide values at the same cursor
        k = torch.where(stored, bits, ol_s)
        raw = read_bits(ofs, opos, k)
        out[..., i] = torch.where(stored, raw, vmin + raw).to(I32)
        opos = opos + k
        high2 = low + ((rng * chi) >> PCOUNT_BITS) - 1
        low2 = low + ((rng * clo) >> PCOUNT_BITS)
        low, high, code, spos = decode_renorm(low, high, code, spos, low2,
                                              high2, sym, stored)
    return out


# ------------------------------------------------------------------- encode
def sym_capacity_words(n_steps: int) -> int:
    # <= MAX_RENORM bits/step sustained + termination & slack
    return (n_steps * (MAX_RENORM + 2) + MAX_PENDING + 64 + 31) // 32


def ofs_capacity_words(n_steps: int, bits: int) -> int:
    return (n_steps * bits + 63) // 32


class _BitSink:
    """Per-stream 64-bit bit buffer (two u32 halves) retiring full words
    into a word-interleaved plane [..., W, S] (``ref.py:239-256``)."""

    def __init__(self, lead, n_words, s, device):
        self.plane = torch.zeros(*lead, n_words, s, dtype=I64, device=device)
        z = torch.zeros(*lead, s, dtype=I64, device=device)
        self.widx, self.lo, self.hi, self.len = z, z, z, z

    def append(self, val, k):
        self.lo = self.lo | shl32(val, self.len)
        self.hi = self.hi | shr32(val, 32 - self.len)
        self.len = self.len + k

    def _put(self, do, word):
        w = self.widx.clamp(0, self.plane.shape[-2] - 1).unsqueeze(-2)
        cur = torch.gather(self.plane, -2, w).squeeze(-2)
        self.plane = self.plane.scatter(
            -2, w, torch.where(do, word, cur).unsqueeze(-2))

    def flush(self):
        do = self.len >= 32
        self._put(do, self.lo)
        self.lo = torch.where(do, self.hi, self.lo)
        self.hi = torch.where(do, 0, self.hi)
        self.len = torch.where(do, self.len - 32, self.len)
        self.widx = self.widx + do.to(I64)

    def drain(self):
        self._put(self.len > 0, self.lo)


def encode_ac(values: torch.Tensor, v_min, ol, cum, n_steps: int,
              bits: int = 8):
    """Arithmetic-encode streams [..., S, n_steps] (``ref.py:269``), no
    stored-mode selection.  Returns int64 u32 planes [..., Ws, S] and
    [..., Wo, S], sym_bits / ofs_bits int64 [..., S], overflow bool."""
    lead = tuple(values.shape[:-2])
    s = values.shape[-2]
    dev = values.device
    vals = values.to(I64)
    vm, olt, cm = _tables(v_min, ol, cum, lead)
    # hoisted symbol search + table gathers over the whole block
    s_idx = (vals.unsqueeze(-1) >= vm[..., :-1].unsqueeze(-2).unsqueeze(-2)
             ).sum(-1) - 1                               # [..., S, E]
    flat = s_idx.reshape(*lead, -1)
    ol_all = torch.gather(olt, -1, flat).reshape(s_idx.shape)
    off_all = (vals - torch.gather(vm, -1, flat).reshape(s_idx.shape)) & M32
    clo_all = torch.gather(cm, -1, flat).reshape(s_idx.shape)
    chi_all = torch.gather(cm, -1, flat + 1).reshape(s_idx.shape)

    symb = _BitSink(lead, sym_capacity_words(n_steps), s, dev)
    ofsb = _BitSink(lead, ofs_capacity_words(n_steps, bits), s, dev)
    z = torch.zeros(*lead, s, dtype=I64, device=dev)
    low, high, pending = z, z + TOP, z
    overflow = torch.zeros(*lead, s, dtype=torch.bool, device=dev)
    s_bits, o_bits = z, z
    for i in range(n_steps):
        ol_s = ol_all[..., i]
        ofsb.append(off_all[..., i], ol_s)
        o_bits = o_bits + ol_s
        ofsb.flush()
        rng = high - low + 1
        high2 = low + ((rng * chi_all[..., i]) >> PCOUNT_BITS) - 1
        low2 = low + ((rng * clo_all[..., i]) >> PCOUNT_BITS)
        low, high, pending, pat1, k1, pat2, k2 = encode_renorm(
            low2, high2, pending)
        symb.append(pat1, k1)
        s_bits = s_bits + k1
        symb.flush()
        symb.append(pat2, k2)
        s_bits = s_bits + k2
        symb.flush()
        overflow = overflow | (pending > MAX_PENDING)
    # termination: disambiguate the final quarter (golden encode_stream)
    pending = pending + 1
    b = (low >= QUARTER).to(I64)
    inv_run = ((shl32(torch.ones_like(b), pending) - 1) * (1 - b)) & M32
    symb.append((b | (inv_run << 1)) & M32, 1 + pending)
    s_bits = s_bits + 1 + pending
    for _ in range(3):
        symb.flush()
    symb.drain()
    ofsb.drain()
    return symb.plane, ofsb.plane, s_bits, o_bits, overflow


def pack_raw(values: torch.Tensor, n_steps: int, bits: int = 8):
    """Verbatim bit-pack (stored mode): [..., S, E] -> int64 u32
    [..., Wo, S] (``ref.py:362``): value ``i`` of a stream at bit ``i *
    bits`` of its bit string, words filled from their low bits.  Where
    ``bits`` divides 32 and whole words hold the stream, the words are
    built in one pass (each the sum of its values' shifted bits, which
    cannot overlap for values below ``2^bits``, as the codec's are);
    otherwise the bit sink packs one value a step."""
    lead = tuple(values.shape[:-2])
    per = 32 // bits
    if 32 % bits == 0 and n_steps % per == 0:
        s = values.shape[-2]
        v = values[..., :n_steps].to(I64) & M32
        shifts = torch.arange(per, device=values.device, dtype=I64) * bits
        words = (v.reshape(*lead, s, n_steps // per, per) << shifts).sum(-1)
        plane = torch.zeros(*lead, ofs_capacity_words(n_steps, bits), s,
                            dtype=I64, device=values.device)
        plane[..., :n_steps // per, :] = words.transpose(-1, -2)
        return plane
    sink = _BitSink(lead, ofs_capacity_words(n_steps, bits),
                    values.shape[-2], values.device)
    vals = values.to(I64) & M32
    for i in range(n_steps):
        sink.append(vals[..., i], bits)
        sink.flush()
    sink.drain()
    return sink.plane


def encode(values: torch.Tensor, v_min, ol, cum, n_steps: int,
           bits: int = 8):
    """Full encoder: AC encode + per-stream stored-mode selection
    (``ref.py:387``).  Returns ``(sym i32[..., Ws, S], ofs i32[..., Wo, S],
    sym_bits i32[..., S], ofs_bits i32[..., S], stored bool[..., S])`` —
    planes as int32 tensors holding the u32 bits."""
    sp, op, sb, ob, ovf = encode_ac(values, v_min, ol, cum, n_steps, bits)
    raw = pack_raw(values, n_steps, bits)
    stored = ovf | ((sb + ob) >= n_steps * bits)
    st = stored.unsqueeze(-2)
    op = torch.where(st, raw, op)
    sp = torch.where(st, 0, sp)
    sb = torch.where(stored, 0, sb)
    ob = torch.where(stored, n_steps * bits, ob)
    return (as_i32_bits(sp), as_i32_bits(op), sb.to(I32), ob.to(I32),
            stored)
