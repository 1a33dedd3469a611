// Standalone APack decode kernel: B pages (or tensors) of S streams each,
// every page with its own table row.
//
// Replaces the Pallas kernel repro/kernels/apack_decode.py (`_decode_kernel`
// :76 -> `decode_pallas` :87).  The TPU kernel decodes a block of 128
// streams per grid program, one stream per vector lane; here one thread
// decodes one stream (apack_decode.cuh), 128 threads to a block, and the
// grid covers every (page, stream) pair.
//
// What bounds it on the card: the serial per-stream loop (latency of a
// dependent chain of integer ops and L1 hits), not device memory: a page of
// 128 streams x 128 values reads ~47 KB of planes at most and writes 64 KB.
// Its design answers that with occupancy only: each SM holds 16 blocks of
// 128 independent streams, and the step latency of one hides behind the
// others.  Each thread writes its own row of the output (strided stores);
// staging through shared memory is left for a later pass.
#include <cuda_runtime.h>
#include <stdint.h>

#include "apack_decode.cuh"

namespace {

constexpr int BLOCK = 128;

__global__ void __launch_bounds__(BLOCK)
apack_decode_kernel(const uint32_t* __restrict__ sym,
                    const uint32_t* __restrict__ ofs,
                    const int32_t* __restrict__ stored,
                    const int32_t* __restrict__ vm,
                    const int32_t* __restrict__ ol,
                    const int32_t* __restrict__ cum,
                    int32_t* __restrict__ out, int n_pages, int ws, int wo,
                    int s, int n_steps, int bits) {
  long gid = (long)blockIdx.x * BLOCK + threadIdx.x;
  if (gid >= (long)n_pages * s) return;
  int b = (int)(gid / s);
  int st = (int)(gid % s);
  int32_t* row = out + gid * n_steps;
  const apack::GlobalPlane sp{sym + (size_t)b * ws * s + st, ws, s};
  const apack::GlobalPlane op{ofs + (size_t)b * wo * s + st, wo, s};
  const apack::GlobalTable tab{vm + b * 17, ol + b * 16, cum + b * 17};
  apack::decode_stream(sp, op, stored[(size_t)b * s + st] != 0, tab, n_steps,
                       bits, [&](int i, int v) { row[i] = v; });
}

}  // namespace

extern "C" int apack_decode_launch(const void* sym, const void* ofs,
                                   const void* stored, const void* vm,
                                   const void* ol, const void* cum, void* out,
                                   int n_pages, int ws, int wo, int s,
                                   int n_steps, int bits, void* stream) {
  long n = (long)n_pages * s;
  if (n == 0) return 0;
  int grid = (int)((n + BLOCK - 1) / BLOCK);
  apack_decode_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)sym, (const uint32_t*)ofs, (const int32_t*)stored,
      (const int32_t*)vm, (const int32_t*)ol, (const int32_t*)cum,
      (int32_t*)out, n_pages, ws, wo, s, n_steps, bits);
  return (int)cudaGetLastError();
}
