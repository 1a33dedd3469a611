// APack encode kernel with per-stream stored-mode selection.
//
// Replaces the Pallas kernel repro/kernels/apack_encode.py (`_encode_kernel`
// :52 -> `encode_pallas` :144) and folds in what the JAX package does
// around it (stored-mode selection, repro/kernels/ops.py:109-120 and
// ref.py:387-409), so the output equals ref.encode: AC-inflated or
// overflowed streams get a zeroed symbol column, verbatim values in the
// offset column and n_steps*bits offset bits.
//
// One thread encodes one stream of one page; every page (batch row) has its
// own table row, or all share one (a row stride of 0, so the wrapper copies
// no row out per page).
//
// What bounds it on the card: the coder's serial chain and a warp's issue of
// its instructions, not memory (a 128-stream page reads 64 KB of values and
// writes at most 47 KB of planes).  At the codec shape (64 pages) and at a
// decode step's seal (56 page-kinds) there are one or two warps on an SM, so
// a stream's time is its 128 steps' latency, and every instruction of a step
// counts.  A step's chain is low/high -> rng * cum -> renorm_counts ->
// low/high, with the sinks' bit lengths beside it; the design keeps the rest
// off it and short:
//   - each block stages its page's table in shared memory once, so that a
//     value's symbol s and its row (ol[s], cum[s], cum[s+1], v_min[s])
//     are one 16-byte shared load away: at bits <= 8 a row for every
//     value (kLut, 4 KB), each found with the reference's 16 compares;
//     past 8 bits a row per symbol and v_min for a four-level bisection
//     (the last s with v_min[s] <= v, the reference's count of compares
//     less one, since v_min ascends: ApackTable's invariant, which also
//     puts every value past the table's last entry on its last symbol);
//   - values arrive whole sectors at a time: two 16-byte loads of the
//     thread's own row a chunk of eight ahead of the coder (a block-wide
//     copy of the rows through shared memory measured slower);
//   - the step loop is unrolled by eight and has no branch (the sinks use
//     selects and predicated stores), so the eight steps are one basic
//     block in which the compiler computes a value's row while the chain
//     of an earlier one runs;
//   - each plane word is written once: the coded words as the sinks fill
//     them, then zeros past the stream's end.  A stored stream clears its
//     symbol column and rewrites its offset column;
//   - 128-thread blocks, each within one page.  Smaller blocks spread the
//     serve's decode-step seal (28 layers x 2 kinds = 56 pages of 128
//     streams) over more SMs, but each stream's chain sets the time
//     whatever the number of warps an SM holds, so 32- and 64-thread blocks
//     measured no faster there and slower at a prefill's seal
//     (benchmarks/torch_kernel_ablation.py, PERF.md).
// Streams that overflow (pending > MAX_PENDING) or that AC would inflate
// are stored: their columns are rewritten at the end, so the coder's shifts
// need no guard for what only such streams reach.
#include <cuda_runtime.h>
#include <stdint.h>

#include "apack_decode.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int CHUNK = 8;                 // values a thread holds ahead

struct Args {
  const int32_t* values;   // [B, S, n_steps]
  const int32_t* vm;       // row b at vm + b * vm_stride, [17]
  const int32_t* ol;       // [16]
  const int32_t* cum;      // [17]
  uint32_t* sym;           // [B, Ws, S]
  uint32_t* ofs;           // [B, Wo, S]
  int32_t* sym_bits;       // [B, S]
  int32_t* ofs_bits;       // [B, S]
  uint8_t* stored;         // [B, S], bool
  int S, n_steps, bits, ws, wo;
  int vm_stride, ol_stride, cum_stride;   // 0: one row for every page
  bool vec;                // rows of whole, aligned 16-byte pieces
};

// *p = v where pred holds, as one predicated store: written as C++, the
// store's condition becomes a branch (BSSY/BSYNC), which ends the basic
// block and keeps the compiler from scheduling one step's loads under an
// earlier step's chain.
__device__ __forceinline__ void store_if(uint32_t* p, uint32_t v, bool pred) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q st.global.u32 [%0], %1;\n}\n" ::"l"(p),
      "r"(v), "r"((int)pred));
#else
  if (pred) *p = v;
#endif
}

// A stream's bit buffer: whole 32-bit words leave for the plane, word w of
// the stream at plane[w * stride] (the running offset off), none at or past
// end = capacity * stride.  Two 32-bit halves, as the TPU kernel keeps it;
// every append finds len < 32 in a stream whose planes are kept (k <= 26
// bits an append, a flush after each), so the shifts take len & 31: in a
// stream that overflowed, which is rewritten, they only scramble bits.
struct BitSink {
  uint32_t* plane;     // word 0 of this stream
  uint32_t stride;
  uint32_t end;
  uint32_t off = 0;
  uint32_t lo = 0, hi = 0;
  int len = 0;

  __device__ __forceinline__ void append(uint32_t val, int k) {
    const int s = len & 31;
    lo |= val << s;
    hi |= __funnelshift_l(val, 0u, s);    // val >> (32 - s), 0 for s = 0
    len += k;
  }
  // Selects and one predicated store, no branch: the threads of a warp
  // fill their words at different steps, and a divergent branch here would
  // serialize them on every step.
  __device__ __forceinline__ void flush() {
    const bool full = len >= 32;
    store_if(plane + off, lo, full && off < end);
    lo = full ? hi : lo;
    hi = full ? 0u : hi;
    len -= full ? 32 : 0;
    off += full ? stride : 0u;
  }
  __device__ __forceinline__ void drain() {
    store_if(plane + off, lo, len > 0 && off < end);
  }
  // zeros in every word past what the sink wrote
  __device__ __forceinline__ void zero_tail() const {
    for (uint32_t o = off + (len > 0 ? stride : 0u); o < end; o += stride)
      plane[o] = 0u;
  }
};

// A value's row (ol[s], cum[s], cum[s+1], v_min[s]) from the block's
// staged table: the row of value v (kLut), or a bisection of v_min and
// the row of symbol s.
template <bool kLut>
struct Lookup {
  const int4* rows;    // [n_lut] by value (kLut), else [16] by symbol
  const int* vmin;     // v_min[0..15]
  int n_lut;
  __device__ __forceinline__ int4 operator()(int v) const {
    if (kLut) return rows[min(max(v, 0), n_lut - 1)];
    int s = v >= vmin[8] ? 8 : 0;
    s += v >= vmin[s + 4] ? 4 : 0;
    s += v >= vmin[s + 2] ? 2 : 0;
    s += v >= vmin[s + 1] ? 1 : 0;
    return rows[s];
  }
};

template <bool kLut>
struct Coder {
  BitSink sk, ok;
  Lookup<kLut> lookup;
  int low = 0, high = apack::TOP, pending = 0;
  int s_bits = 0, o_bits = 0;
  bool overflow = false;

  __device__ __forceinline__ void step(int v) {
    using namespace apack;
    const int4 e = lookup(v);             // depends on the value alone
    ok.append((uint32_t)(v - e.w), e.x);
    o_bits += e.x;
    ok.flush();
    const int rng = high - low + 1;
    const int high2 = low + ((rng * e.z) >> PCOUNT_BITS) - 1;
    const int low2 = low + ((rng * e.y) >> PCOUNT_BITS);
    // ref.encode_renorm: the first matched bit + pending inverse run, then
    // the remaining matched leading bits of low2.  m <= 16, and pending <=
    // MAX_PENDING in a stream that did not overflow, so no shift below
    // reaches 32 where it counts.  Without a matched bit both appends are
    // of 0 bits, and prefix is 0.
    int m, u;
    renorm_counts(low2, high2, m, u, low, high);
    const bool has = m > 0;
    const uint32_t prefix = rev16((uint32_t)low2) & ((1u << m) - 1u);
    const uint32_t b1 = prefix & 1u;
    const uint32_t inv_run = ((1u << (pending & 31)) - 1u) & (b1 - 1u);
    const int k1 = has ? 1 + pending : 0;
    const int k2 = has ? m - 1 : 0;
    sk.append(has ? b1 | (inv_run << 1) : 0u, k1);
    sk.flush();
    sk.append(prefix >> 1, k2);
    sk.flush();
    s_bits += k1 + k2;
    pending = has ? u : pending + u;
    overflow = overflow || pending > MAX_PENDING;
  }

  __device__ __forceinline__ void step8(int4 a, int4 b) {
    step(a.x); step(a.y); step(a.z); step(a.w);
    step(b.x); step(b.y); step(b.z); step(b.w);
  }

  // termination: disambiguate the final quarter (golden encode_stream)
  __device__ __forceinline__ void finish() {
    using namespace apack;
    pending += 1;
    const uint32_t tb = low >= QUARTER ? 1u : 0u;
    const uint32_t inv_run = ((1u << (pending & 31)) - 1u) & (tb - 1u);
    sk.append(tb | (inv_run << 1), 1 + pending);
    s_bits += 1 + pending;
    sk.flush();
    sk.flush();
    sk.flush();
    sk.drain();
    ok.drain();
  }
};

constexpr int LUT_BITS = 8;

template <bool kLut>
__global__ void __launch_bounds__(BLOCK) apack_encode_kernel(Args a) {
  __shared__ __align__(16) int4 rows[kLut ? 1 << LUT_BITS : apack::N_SYMBOLS];
  __shared__ int vmin[apack::N_SYMBOLS];
  const int per_page = (a.S + BLOCK - 1) / BLOCK;
  const int b = blockIdx.x / per_page;
  const int st = (blockIdx.x - b * per_page) * BLOCK + threadIdx.x;
  const int* vm = a.vm + b * a.vm_stride;
  const int* ol = a.ol + b * a.ol_stride;
  const int* cm = a.cum + b * a.cum_stride;
  const int n_lut = kLut ? 1 << a.bits : apack::N_SYMBOLS;
  for (int j = threadIdx.x; j < n_lut; j += BLOCK) {
    int s = j;
    if (kLut) {            // ref.encode's symbol search for value j
      s = -1;
#pragma unroll
      for (int k = 0; k < apack::N_SYMBOLS; ++k) s += j >= vm[k] ? 1 : 0;
      s = max(s, 0);
    }
    rows[j] = make_int4(ol[s], cm[s], cm[s + 1], vm[s]);
  }
  if (threadIdx.x < apack::N_SYMBOLS) vmin[threadIdx.x] = vm[threadIdx.x];
  __syncthreads();
  if (st >= a.S) return;
  const size_t gid = (size_t)b * a.S + st;
  uint32_t* sym_col = a.sym + (size_t)b * a.ws * a.S + st;
  uint32_t* ofs_col = a.ofs + (size_t)b * a.wo * a.S + st;
  const uint32_t S = a.S;
  // opaque to the optimizer, so that a store's address is one multiply-add
  // of the word offset onto the column (not a 64-bit add and a shift)
  asm("" : "+l"(sym_col));
  asm("" : "+l"(ofs_col));
  Coder<kLut> coder{BitSink{sym_col, S, a.ws * S},
                    BitSink{ofs_col, S, a.wo * S},
                    Lookup<kLut>{rows, vmin, n_lut}};
  const int32_t* vals = a.values + gid * a.n_steps;
  // two 16-byte loads a chunk, a chunk ahead
  const int n_vec = a.vec ? (a.n_steps & ~(CHUNK - 1)) : 0;
  int i = 0;
  if (n_vec > 0) {
    const int4* v4 = reinterpret_cast<const int4*>(vals);
    int4 p0 = __ldg(v4), p1 = __ldg(v4 + 1);
    for (; i < n_vec; i += CHUNK) {
      const int4 x0 = p0, x1 = p1;
      if (i + CHUNK < n_vec) {
        p0 = __ldg(v4 + (i + CHUNK) / 4);
        p1 = __ldg(v4 + (i + CHUNK) / 4 + 1);
      }
      coder.step8(x0, x1);
    }
  }
  for (; i < a.n_steps; ++i) coder.step(__ldg(vals + i));
  coder.finish();

  const bool is_stored =
      coder.overflow || (coder.s_bits + coder.o_bits >= a.n_steps * a.bits);
  if (!is_stored) {
    coder.sk.zero_tail();
    coder.ok.zero_tail();
  } else {
    // ref.pack_raw: verbatim `bits`-wide values in the offset column
    for (uint32_t o = 0; o < coder.sk.end; o += S) sym_col[o] = 0u;
    BitSink raw{ofs_col, S, a.wo * S};
#pragma unroll 8
    for (int k = 0; k < a.n_steps; ++k) {
      raw.append((uint32_t)__ldg(vals + k), a.bits);
      raw.flush();
    }
    raw.drain();
    raw.zero_tail();
    coder.s_bits = 0;
    coder.o_bits = a.n_steps * a.bits;
  }
  a.sym_bits[gid] = coder.s_bits;
  a.ofs_bits[gid] = coder.o_bits;
  a.stored[gid] = is_stored ? 1 : 0;
}

}  // namespace

// Rows of values that are not whole, aligned 16-byte pieces take 4-byte
// loads.  *_stride: elements between two pages' table rows, 0 for one row
// shared by every page.
extern "C" int apack_encode_launch(const void* values, const void* vm,
                                   const void* ol, const void* cum, void* sym,
                                   void* ofs, void* sym_bits, void* ofs_bits,
                                   void* stored, int n_pages, int s,
                                   int n_steps, int bits, int ws, int wo,
                                   int vm_stride, int ol_stride,
                                   int cum_stride, void* stream) {
  if ((long)n_pages * s == 0) return 0;
  // the sinks' 32-bit word offsets reach capacity * s
  if ((long)(ws > wo ? ws : wo) * s > 0xFFFFFFFFL)
    return (int)cudaErrorInvalidValue;
  const Args a{(const int32_t*)values, (const int32_t*)vm, (const int32_t*)ol,
               (const int32_t*)cum, (uint32_t*)sym, (uint32_t*)ofs,
               (int32_t*)sym_bits, (int32_t*)ofs_bits, (uint8_t*)stored,
               s, n_steps, bits, ws, wo, vm_stride, ol_stride, cum_stride,
               n_steps % 4 == 0 && ((uintptr_t)values & 15) == 0};
  const long grid = (long)n_pages * ((s + BLOCK - 1) / BLOCK);
  const cudaStream_t st = (cudaStream_t)stream;
  if (bits <= LUT_BITS)
    apack_encode_kernel<true><<<grid, BLOCK, 0, st>>>(a);
  else
    apack_encode_kernel<false><<<grid, BLOCK, 0, st>>>(a);
  return (int)cudaGetLastError();
}
