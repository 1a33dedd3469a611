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
// own table row.  The TPU kernel's 64-bit bit buffer held in two u32
// vectors is one uint64_t here (the same bits whenever the buffer holds
// fewer than 32 pending bits before an append, which every stream that is
// not stored satisfies; stored streams are rewritten at the end).
//
// What bounds it on the card: the serial coder loop (a dependent chain of
// integer ops per value), not memory: a 128-stream page reads 64 KB of
// values and writes at most 47 KB of planes.  As for the decoder, the
// design relies on many independent streams per SM to hide the chain's
// latency; each thread reads its own strided row of values.
#include <cuda_runtime.h>
#include <stdint.h>

#include "apack_decode.cuh"

namespace {

constexpr int BLOCK = 128;

struct BitSink {
  uint32_t* plane;   // word 0 of this stream
  int n_words;
  int stride;
  uint64_t buf = 0;
  int len = 0;
  int widx = 0;

  __device__ void append(uint32_t val, int k) {
    if (len < 64) buf |= (uint64_t)val << len;
    len += k;
  }
  __device__ void flush() {
    if (len >= 32) {
      if (widx < n_words) plane[(size_t)widx * stride] = (uint32_t)buf;
      buf >>= 32;
      len -= 32;
      ++widx;
    }
  }
  __device__ void drain() {
    if (len > 0 && widx < n_words) plane[(size_t)widx * stride] = (uint32_t)buf;
  }
};

__device__ void zero_column(uint32_t* plane, int n_words, int stride) {
  for (int w = 0; w < n_words; ++w) plane[(size_t)w * stride] = 0u;
}

__global__ void __launch_bounds__(BLOCK)
apack_encode_kernel(const int32_t* __restrict__ values,
                    const int32_t* __restrict__ vm_all,
                    const int32_t* __restrict__ ol_all,
                    const int32_t* __restrict__ cum_all,
                    uint32_t* __restrict__ sym, uint32_t* __restrict__ ofs,
                    int32_t* __restrict__ sym_bits,
                    int32_t* __restrict__ ofs_bits,
                    int32_t* __restrict__ stored_out, int n_pages, int s,
                    int n_steps, int bits, int ws, int wo) {
  using namespace apack;
  long gid = (long)blockIdx.x * BLOCK + threadIdx.x;
  if (gid >= (long)n_pages * s) return;
  int b = (int)(gid / s);
  int st = (int)(gid % s);
  const int32_t* vals = values + gid * n_steps;
  const int32_t* vm = vm_all + b * 17;
  const int32_t* ol = ol_all + b * 16;
  const int32_t* cum = cum_all + b * 17;
  uint32_t* sym_col = sym + (size_t)b * ws * s + st;
  uint32_t* ofs_col = ofs + (size_t)b * wo * s + st;
  zero_column(sym_col, ws, s);
  zero_column(ofs_col, wo, s);
  BitSink sk{sym_col, ws, s};
  BitSink ok{ofs_col, wo, s};

  int low = 0, high = TOP, pending = 0;
  bool overflow = false;
  int s_bits = 0, o_bits = 0;
  for (int i = 0; i < n_steps; ++i) {
    int v = vals[i];
    int s_idx = -1;
#pragma unroll
    for (int j = 0; j < N_SYMBOLS; ++j) s_idx += (v >= vm[j]) ? 1 : 0;
    s_idx = s_idx < 0 ? 0 : s_idx;
    int ol_s = ol[s_idx];
    ok.append((uint32_t)(v - vm[s_idx]), ol_s);
    o_bits += ol_s;
    ok.flush();
    int rng = high - low + 1;
    int high2 = low + ((rng * cum[s_idx + 1]) >> PCOUNT_BITS) - 1;
    int low2 = low + ((rng * cum[s_idx]) >> PCOUNT_BITS);
    // ref.encode_renorm: the first matched bit + pending inverse run, then
    // the remaining matched leading bits of low2
    int m, u;
    renorm_counts(low2, high2, m, u, low, high);
    bool has = m > 0;
    uint32_t prefix = rev16((uint32_t)low2) & (shl32(1u, m) - 1u);
    uint32_t b1 = prefix & 1u;
    uint32_t inv_run = (shl32(1u, pending) - 1u) * (1u - b1);
    if (has) {
      sk.append(b1 | (inv_run << 1), 1 + pending);
      s_bits += 1 + pending;
    }
    sk.flush();
    if (has) {
      sk.append(prefix >> 1, m - 1);
      s_bits += m - 1;
    }
    sk.flush();
    pending = has ? u : pending + u;
    overflow = overflow || pending > MAX_PENDING;
  }
  // termination: disambiguate the final quarter (golden encode_stream)
  pending += 1;
  uint32_t tb = low >= QUARTER ? 1u : 0u;
  uint32_t inv_run = (shl32(1u, pending) - 1u) * (1u - tb);
  sk.append(tb | (inv_run << 1), 1 + pending);
  s_bits += 1 + pending;
  sk.flush();
  sk.flush();
  sk.flush();
  sk.drain();
  ok.drain();

  bool is_stored = overflow || (s_bits + o_bits >= n_steps * bits);
  if (is_stored) {
    // ref.pack_raw: verbatim `bits`-wide values in the offset column
    zero_column(sym_col, ws, s);
    zero_column(ofs_col, wo, s);
    BitSink raw{ofs_col, wo, s};
    for (int i = 0; i < n_steps; ++i) {
      raw.append((uint32_t)vals[i], bits);
      raw.flush();
    }
    raw.drain();
    s_bits = 0;
    o_bits = n_steps * bits;
  }
  sym_bits[gid] = s_bits;
  ofs_bits[gid] = o_bits;
  stored_out[gid] = is_stored ? 1 : 0;
}

}  // namespace

extern "C" int apack_encode_launch(const void* values, const void* vm,
                                   const void* ol, const void* cum, void* sym,
                                   void* ofs, void* sym_bits, void* ofs_bits,
                                   void* stored, int n_pages, int s,
                                   int n_steps, int bits, int ws, int wo,
                                   void* stream) {
  long n = (long)n_pages * s;
  if (n == 0) return 0;
  int grid = (int)((n + BLOCK - 1) / BLOCK);
  apack_encode_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)values, (const int32_t*)vm, (const int32_t*)ol,
      (const int32_t*)cum, (uint32_t*)sym, (uint32_t*)ofs,
      (int32_t*)sym_bits, (int32_t*)ofs_bits, (int32_t*)stored, n_pages, s,
      n_steps, bits, ws, wo);
  return (int)cudaGetLastError();
}
