// APack stream decoder as a device function, shared by the standalone
// decode kernel (apack_decode.cu) and the fused paged attention kernel
// (fused_page_attention.cu).
//
// Replaces the body of the Pallas kernel repro/kernels/apack_decode.py
// (`decode_block`, :34), itself a lane-parallel copy of repro/kernels/ref.py
// `decode` (:184).  One CUDA thread decodes one stream; the loop over values
// is the TPU kernel's `fori_loop`.  Output is bit-exact with ref.decode,
// including streams in stored (verbatim) mode and the zero-fill of reads
// past the end of a plane.
//
// Layout: planes are word-interleaved [W, S] u32, word w of stream s at
// w*S + s, so the 32 threads of a warp that decode neighbouring streams
// read neighbouring words.
//
// What bounds it: the coder is a serial, data-dependent state machine (each
// step's bit position depends on the previous symbol), so one stream cannot
// be split across threads.  Throughput comes only from decoding many
// streams at once; a step is ~60 integer instructions plus up to four word
// loads that hit L1 after the first touch of a 128-byte line.
#pragma once
#include <stdint.h>

namespace apack {

constexpr int CODE_BITS = 16;
constexpr int TOP = (1 << CODE_BITS) - 1;   // 0xFFFF
constexpr int HALF = 1 << (CODE_BITS - 1);  // 0x8000
constexpr int QUARTER = 1 << (CODE_BITS - 2);
constexpr int PCOUNT_BITS = 10;
constexpr int MAX_PENDING = 24;
constexpr int N_SYMBOLS = 16;

// Logical shifts that give 0 for a shift of 32 or more (ref.shr32/shl32);
// a plain `x >> 32` on uint32_t is undefined in C++.
__device__ __forceinline__ uint32_t shr32(uint32_t x, int k) {
  return k >= 32 ? 0u : (x >> k);
}
__device__ __forceinline__ uint32_t shl32(uint32_t x, int k) {
  return k >= 32 ? 0u : (x << k);
}

// ref.bitlen16: the same branch-free binary search, so out-of-range inputs
// (never produced by a valid stream) give the reference's answer too.
__device__ __forceinline__ int bitlen16(int x) {
  int b = 0;
#pragma unroll
  for (int s = 8; s >= 1; s >>= 1) {
    if (x >= (1 << s)) { b += s; x >>= s; }
  }
  return b + (x > 0 ? 1 : 0);
}

// ref.rev16: reverse the low 16 bits.  The reference's swap network only
// ever moves bits 0..15, so __brev of the low half is bit-exact.
__device__ __forceinline__ uint32_t rev16(uint32_t w) {
  return __brev(w & 0xFFFFu) >> 16;
}

// ref.read_bits: k <= 16 bits, LSB-first, at bit `pos` of the stream whose
// word 0 is plane[0] (stride S between words); words at or past n_words
// read as zero.
__device__ __forceinline__ uint32_t read_bits(const uint32_t* __restrict__ plane,
                                              int n_words, int stride, int pos,
                                              int k) {
  int w = pos >> 5;
  int off = pos & 31;
  uint32_t r0 = (w < n_words) ? __ldg(plane + (size_t)w * stride) : 0u;
  uint32_t r1 = (w + 1 < n_words) ? __ldg(plane + (size_t)(w + 1) * stride) : 0u;
  uint32_t window = shr32(r0, off) | shl32(r1, 32 - off);
  return window & (shl32(1u, k) - 1u);
}

// ref.renorm_counts: m matched leading bits, then u underflow shifts.
__device__ __forceinline__ void renorm_counts(int low, int high, int& m, int& u,
                                              int& low_f, int& high_f) {
  m = 16 - bitlen16(low ^ high);
  int low_m = (int)(shl32((uint32_t)low, m) & 0xFFFFu);
  int high_m = (int)((shl32((uint32_t)high, m) | (shl32(1u, m) - 1u)) & 0xFFFFu);
  int t = (low_m & ~high_m) & 0xFFFF;
  u = 16 - bitlen16(~(t << 1) & 0xFFFF);
  int ufill = (int)(shl32(1u, u) - 1u);
  low_f = (int)(shl32((uint32_t)low_m, u) & 0x7FFFu);
  high_f = (int)(shl32((uint32_t)high_m, u) & 0x7FFFu) | HALF | ufill;
}

// Python's `//` is a floor; C's `/` truncates.  Valid streams only divide
// non-negative numerators, but the result must not depend on that.
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// Decode one stream of n_steps values; sink(i, value) receives them in
// order.  sym/ofs point at word 0 of this stream; tables are the 17/16/17
// entry rows (v_min, ol, cum).
template <class Sink>
__device__ __forceinline__ void decode_stream(
    const uint32_t* __restrict__ sym, int ws, const uint32_t* __restrict__ ofs,
    int wo, int stride, bool stored, const int* __restrict__ vm,
    const int* __restrict__ ol, const int* __restrict__ cum, int n_steps,
    int bits, Sink sink) {
  int low = 0, high = TOP;
  int code = (int)rev16(read_bits(sym, ws, stride, 0, 16));
  int spos = 16, opos = 0;
  for (int i = 0; i < n_steps; ++i) {
    if (stored) {
      // verbatim lane: raw `bits`-wide values, AC state frozen
      sink(i, (int)read_bits(ofs, wo, stride, opos, bits));
      opos += bits;
      continue;
    }
    int rng = high - low + 1;
    int cum_val = floordiv((code - low + 1) * (1 << PCOUNT_BITS) - 1,
                           rng > 0 ? rng : 1);
    int s_idx = -1;
#pragma unroll
    for (int j = 0; j < N_SYMBOLS; ++j) s_idx += (cum_val >= cum[j]) ? 1 : 0;
    s_idx = s_idx < 0 ? 0 : s_idx;
    int ol_s = ol[s_idx];
    int clo = cum[s_idx];
    int chi = cum[s_idx + 1];
    sink(i, vm[s_idx] + (int)read_bits(ofs, wo, stride, opos, ol_s));
    opos += ol_s;
    int high2 = low + ((rng * chi) >> PCOUNT_BITS) - 1;
    int low2 = low + ((rng * clo) >> PCOUNT_BITS);
    // ref.decode_renorm: all m+u bits in one read, CODE in closed form
    int m, u, low3, high3;
    renorm_counts(low2, high2, m, u, low3, high3);
    int k = min(m + u, 16);                      // the reference's k-clamp
    u = min(u, k - min(m, k));
    uint32_t w = read_bits(sym, ws, stride, spos, k);
    int r = (int)shr32(rev16(w), 16 - k);
    int r_m = (int)shr32((uint32_t)r, u);
    int ufill = (int)(shl32(1u, u) - 1u);
    int code_m = (int)(shl32((uint32_t)code, m) & 0xFFFFu) | r_m;
    code = (int)(shl32((uint32_t)code_m, u) - (uint32_t)HALF * (uint32_t)ufill
                 + (uint32_t)(r & ufill));
    low = low3;
    high = high3;
    spos += k;
  }
}

}  // namespace apack
