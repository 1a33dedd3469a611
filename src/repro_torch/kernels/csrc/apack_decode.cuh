// APack stream decoder as a device function, shared by every decoding
// kernel: the standalone decode (apack_decode.cu) and the gather decode
// (gather_decode.cu) through their page body (decode_page.cuh), the fused
// paged attention (fused_page_attention.cu) and the decompress-matmul
// (decompress_matmul.cu); the encoder (apack_encode.cu) shares the
// renormalization.
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
// read neighbouring words.  The decoder reaches its planes and its table
// through small accessor types.  Every decoding kernel stages its table
// row in shared memory (SmemTable).  Planes come in two placements:
//   - SmemPlane reads rows that the block staged in shared memory: word w
//     of stream c at smem[w*ncols + c], so a warp's 32 threads read 32
//     different banks whatever word each is at;
//   - GlobalPlane reads device memory: the redo of a stream that read past
//     the staged rows (none that the encoder produces), so the result is
//     the reference's for any input, and kernels 1 and 4 for planes whose
//     rows would not fit a block (decode_page.cuh).
//
// What bounds it: the coder is a serial, data-dependent state machine (each
// step's bit position depends on the previous symbol), so one stream cannot
// be split across threads.  A step is ~80 integer instructions, and the
// H100 issues 32-bit integer work at half the rate of f32 work (64 lanes an
// SM), so a card full of streams is bound by the integer pipe: the step is
// kept to as few instructions as exactness allows (decode_stream): a
// four-level bisection of the symbol over products computed up front (no
// division, no table load on the chain), bit lengths from __clz, the
// renormalization in closed form, and plane words loaded before the step
// needs them.
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

// A logical left shift that gives 0 for a shift of 32 or more (ref.shl32);
// a plain `x << 32` on uint32_t is undefined in C++.
__device__ __forceinline__ uint32_t shl32(uint32_t x, int k) {
  return k >= 32 ? 0u : (x << k);
}

// ref.bitlen16 for x in [0, 0xFFFF]: 32 - clz (0 -> 0).
__device__ __forceinline__ int bitlen16_masked(int x) {
  return 32 - __clz(x);
}

// ref.bitlen16 for any int: the reference's binary search gives 0 for
// x <= 0 and 16 for x > 0xFFFF (never reached by a valid stream).
__device__ __forceinline__ int bitlen16(int x) {
  return x <= 0 ? 0 : min(32 - __clz(x), 16);
}

// ref.rev16: reverse the low 16 bits.  The reference's swap network only
// ever moves bits 0..15, so __brev of the low half is bit-exact.
__device__ __forceinline__ uint32_t rev16(uint32_t w) {
  return __brev(w & 0xFFFFu) >> 16;
}

// Plane words in device memory: word w of a stream whose word 0 is p[0],
// stride words apart; words at or past n_words read as zero.
struct GlobalPlane {
  const uint32_t* __restrict__ p;
  int n_words;
  int stride;
  __device__ __forceinline__ uint32_t word(int w) const {
    return w < n_words ? __ldg(p + (size_t)w * stride) : 0u;
  }
  // did reads up to word w see what the reference reads?  Always.
  __device__ __forceinline__ bool covers(int) const { return true; }
};

// Plane words staged in shared memory: rows [0, rows) at s[w * ncols].
// Either rows < n_words (a prefix of the plane), or rows = n_words + 1: the
// whole plane and one row of zeros after it.  A read clamps its row to the
// last staged one, with no branch: past a whole plane that is the zero row,
// the reference's value; past a prefix it is not, so covers(w) tells
// whether reads up to word w were exact, and the caller decodes a stream
// whose reads were not once more from device memory (a stream the encoder
// produced always fits the rows staged).
struct SmemPlane {
  const uint32_t* s;
  int rows;
  int ncols;
  int n_words;
  __device__ __forceinline__ uint32_t word(int w) const {
    return s[min(w, rows - 1) * ncols];
  }
  __device__ __forceinline__ bool covers(int w) const {
    return w < rows || rows > n_words;
  }
};

// ref.read_bits: the 32 bits at bit `pos` (LSB-first), words past the end
// zero; callers mask to the k <= 16 bits they consume.
template <class Plane>
__device__ __forceinline__ uint32_t window(const Plane& pl, int pos) {
  const int w = pos >> 5;
  return __funnelshift_r(pl.word(w), pl.word(w + 1), pos & 31);
}

// Table row of symbol s packed as (ol[s], 2^ol[s] - 1, 0, v_min[s]): the
// offset length and its mask; the bisection brings the cum entries.
struct SmemTable {
  const int4* rows;     // [16]
  const int* cum;       // [17]
  __device__ __forceinline__ int4 row(int s) const { return rows[s]; }
  __device__ __forceinline__ int cum_at(int j) const { return cum[j]; }
};

// Fill a SmemTable's storage (rows int4[16], cum int[17]) from the 17/16/17
// entry table arrays; threads tid, tid + nthreads, ... each take entries.
__device__ __forceinline__ void stage_table(int4* rows, int* cum,
                                            const int* vm, const int* ol,
                                            const int* cm, int tid,
                                            int nthreads) {
  for (int s = tid; s < N_SYMBOLS + 1; s += nthreads) {
    cum[s] = cm[s];
    if (s < N_SYMBOLS)
      rows[s] = make_int4(ol[s], (int)((1u << ol[s]) - 1u), 0, vm[s]);
  }
}

// ref.renorm_counts: m matched leading bits, then u underflow shifts.  m
// and u lie in [0, 16], so no shift below reaches 32.  The reference's
// t = low_m & ~high_m (both shifted by m, high_m with m ones shifted in) is
// ((low & ~high) << m) & 0xFFFF: the shift commutes with the bit operations
// and the ones shifted into high_m clear t's low m bits either way.  So t's
// operand is ready as soon as low and high are, and only one shift by m
// lies between the two bit lengths.
__device__ __forceinline__ void renorm_counts(int low, int high, int& m, int& u,
                                              int& low_f, int& high_f) {
  m = 16 - bitlen16(low ^ high);
  const uint32_t y = (uint32_t)(low & ~high);
  u = 16 - bitlen16_masked((int)(~(y << (m + 1)) & 0xFFFFu));
  int low_m = (int)(((uint32_t)low << m) & 0xFFFFu);
  int high_m = (int)((((uint32_t)high << m) | ((1u << m) - 1u)) & 0xFFFFu);
  int ufill = (int)((1u << u) - 1u);
  low_f = (int)(((uint32_t)low_m << u) & 0x7FFFu);
  high_f = (int)(((uint32_t)high_m << u) & 0x7FFFu) | HALF | ufill;
}

// Decode one stream of n_steps values; sink(i, value) receives them in
// order.  Returns whether every plane word it read was the reference's
// (SmemPlane::covers); if not, the caller resets what the sink built and
// decodes the stream again from GlobalPlanes.
//
// The step is the reference's, rewritten with fewer operations; each
// rewrite is exact for every input:
//   - range = high - low + 1 >= 2: low < 0x8000 <= high after every step.
//   - Symbol: the reference takes s = count - 1, clamped at 0, where count
//     is the number of j in 0..15 with floor(num / range) >= cum[j] and
//     num = (code - low + 1) * 2^10 - 1.  floor(num / range) >= c holds
//     exactly when num >= c * range (c * range <= 2^26 fits an int), and
//     cum is non-decreasing (a cumulative count), so s is the last j with
//     num >= cum[j] * range, or 0: a four-level bisection, no division,
//     whose bracket ends are the reference's range * cum[s] and
//     range * cum[s + 1].
//   - Renormalization: m + u <= 16 always (t has zeros below bit m, so u
//     <= 15 - m), so the reference's k = min(m + u, 16) is m + u and its
//     clamp of u changes nothing; then low' = (low2 << k) & 0x7FFF, high'
//     = (((high2 + 1) << k) - 1) & 0x7FFF | 0x8000 (the ones shifted in
//     by m and by u together are k ones), and code' = ((code << m) &
//     0xFFFF) << u + r - HALF * (2^u - 1), r the k stream bits (the bits
//     of r below u and above it never overlap what they are added to).
//   - The loop runs in chunks of eight steps, unrolled, so a sink that
//     keys on i & 7 sees a constant.
// on_sync() runs once, before step sync_step (a multiple of 8; -1 for
// never), in whichever loop the stream takes: a caller that stages planes
// in two parts waits there for the second.
constexpr int DECODE_UNROLL = 8;

template <class SymPlane, class OfsPlane, class Table, class Sink,
          class OnSync>
__device__ __forceinline__ bool decode_stream(const SymPlane& sym,
                                              const OfsPlane& ofs,
                                              bool stored, const Table& tab,
                                              int n_steps, int bits,
                                              Sink sink, int sync_step,
                                              OnSync on_sync) {
  constexpr int UNROLL = DECODE_UNROLL;
  int opos = 0;
  if (stored) {
    // verbatim stream: raw `bits`-wide values, AC state frozen
    const uint32_t mask = (1u << bits) - 1u;
    int i = 0;
    for (; i + UNROLL <= n_steps; i += UNROLL) {
      if (i == sync_step) on_sync();
#pragma unroll
      for (int jj = 0; jj < UNROLL; ++jj) {
        sink(i + jj, (int)(window(ofs, opos) & mask));
        opos += bits;
      }
    }
    for (; i < n_steps; ++i) {
      if (i == sync_step) on_sync();
      sink(i, (int)(window(ofs, opos) & mask));
      opos += bits;
    }
    return ofs.covers((opos >> 5) + 1);
  }
  int cum[N_SYMBOLS + 1];
#pragma unroll
  for (int j = 0; j <= N_SYMBOLS; ++j) cum[j] = tab.cum_at(j);
  int low = 0, high = TOP;
  int code = (int)rev16(window(sym, 0));
  int spos = 16;
  auto step = [&](int i) {
    // the words this step reads depend only on the cursors
    const uint32_t ow = window(ofs, opos);
    const uint32_t sw = __brev(window(sym, spos));    // bit 0 at bit 31
    const int rng = high - low + 1;
    // the reference's i32 arithmetic, wrapping as it does
    const int num = (int)((uint32_t)(code - low + 1) * (1u << PCOUNT_BITS)
                          - 1u);
    // bisection over the products cd[j] = cum[j] * rng for the last j
    // with num >= cd[j], tracking the bracketing products cd[s] and
    // cd[s + 1], so the table row (ol, v_min) is off the chain; constant
    // indices only, so cum and cd stay in registers
    int cd[N_SYMBOLS + 1];
#pragma unroll
    for (int j = 0; j <= N_SYMBOLS; ++j) cd[j] = cum[j] * rng;
    const bool b8 = num >= cd[8];
    int lo = b8 ? cd[8] : cd[0], hi = b8 ? cd[16] : cd[8];
    const int t4 = b8 ? cd[12] : cd[4];
    const bool b4 = num >= t4;
    lo = b4 ? t4 : lo; hi = b4 ? hi : t4;
    const int t2 = b8 ? (b4 ? cd[14] : cd[10]) : (b4 ? cd[6] : cd[2]);
    const bool b2 = num >= t2;
    lo = b2 ? t2 : lo; hi = b2 ? hi : t2;
    const int t1_0 = b8 ? (b4 ? cd[13] : cd[9]) : (b4 ? cd[5] : cd[1]);
    const int t1_1 = b8 ? (b4 ? cd[15] : cd[11]) : (b4 ? cd[7] : cd[3]);
    const int t1 = b2 ? t1_1 : t1_0;
    const bool b1 = num >= t1;
    lo = b1 ? t1 : lo; hi = b1 ? hi : t1;
    const int s_idx = (b8 ? 8 : 0) + (b4 ? 4 : 0) + (b2 ? 2 : 0) + (b1 ? 1 : 0);
    const int4 e = tab.row(s_idx);                // ol, mask, -, v_min
    sink(i, e.w + (int)(ow & (uint32_t)e.y));
    opos += e.x;
    const int high2p1 = low + (hi >> PCOUNT_BITS);
    const int high2 = high2p1 - 1;
    const int low2 = low + (lo >> PCOUNT_BITS);
    // ref.renorm_counts + ref.decode_renorm (see renorm_counts); m is
    // 16 - bitlen16(low2 ^ high2) for any int: 16 for x <= 0, 0 past 0xFFFF
    const int m = max(__clz(max(low2 ^ high2, 0)) - 16, 0);
    const uint32_t y = (uint32_t)(low2 & ~high2);
    const int u = 16 - bitlen16_masked((int)(~(y << (m + 1)) & 0xFFFFu));
    const int k = m + u;
    // rev16(read_bits(sym, spos, k)) >> (16 - k): the top k bits of sw,
    // 0 for k = 0 (the funnel shift clamps at 32)
    const uint32_t r = __funnelshift_rc(sw, 0u, 32 - k);
    code = (int)(((((uint32_t)code << m) & 0xFFFFu) << u) + r -
                 (uint32_t)HALF * ((1u << u) - 1u));
    low = (int)(((uint32_t)low2 << k) & 0x7FFFu);
    high = (int)(((((uint32_t)high2p1 << k) - 1u) & 0x7FFFu) | (uint32_t)HALF);
    spos += k;
  };
  int i = 0;
  for (; i + UNROLL <= n_steps; i += UNROLL) {
    if (i == sync_step) on_sync();
#pragma unroll
    for (int jj = 0; jj < UNROLL; ++jj) step(i + jj);
  }
  for (; i < n_steps; ++i) {
    if (i == sync_step) on_sync();
    step(i);
  }
  // cursors only grow: the last words read are at most these
  return sym.covers((spos >> 5) + 1) && ofs.covers((opos >> 5) + 1);
}

template <class SymPlane, class OfsPlane, class Table, class Sink>
__device__ __forceinline__ bool decode_stream(const SymPlane& sym,
                                              const OfsPlane& ofs,
                                              bool stored, const Table& tab,
                                              int n_steps, int bits,
                                              Sink sink) {
  return decode_stream(sym, ofs, stored, tab, n_steps, bits, sink, -1,
                       [] {});
}

}  // namespace apack
