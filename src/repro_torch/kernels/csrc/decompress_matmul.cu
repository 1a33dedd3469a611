// Fused APack decompress + matmul: y[M, N] = x[M, K] @ W, with W held as
// word-interleaved APack planes and dequantized only on chip.
//
// Replaces the Pallas kernel repro/kernels/decompress_matmul.py
// (`_fused_kernel` :170, launched by `compressed_matmul` :216).  Same
// contract: W[K, N] is tiled into (K_pad / tile_k) x (N_pad / 128) tiles,
// stream c of tile (kt, j) holds column j*128 + c over rows
// kt*tile_k .. (kt+1)*tile_k, and the stream axis of the planes is
// kt-major: stream (kt*nn + j)*128 + c.  One weight-mode table per tensor,
// one f32 scale per output column.  Each tile is decoded once, its values
// reinterpreted as two's complement and dequantized as f32(q) * scale[col]
// before the product; f32 partial products of the K tiles are summed in kt
// order and written once.
//
// Mapping.  The TPU grid (N tiles, K tiles, M blocks) runs in order on one
// core, keeps the decoded tile in VMEM across its M blocks and carries the
// running sum across K tiles in a scratch strip.  Blocks on the card run in
// no order, so:
//   - pass 1: one block per tile (j, kt), 128 threads, thread c decodes
//     stream c (apack_decode.cuh) into column c of an int8 [tile_k][128]
//     tile in dynamic shared memory, then computes the dot products of that
//     column with every row of x, rows in chunks of MB held in registers,
//     and writes them to partial[kt, m, j*128 + c].  A thread reads back
//     only the column it wrote, so the block needs no barrier; the tile's
//     byte layout makes the 128 threads' reads and writes conflict-free.
//   - pass 2: out[m, n] = partial[0, m, n] + partial[1, m, n] + ... in kt
//     order, the JAX kernel's summation order across tiles.  Only the order
//     inside one tile's dot (sequential fmaf here) differs from the
//     reference.
//
// What bounds it on the card: at decode batch (M = 4) the work is the
// serial per-stream decode (a dependent chain of integer ops and L1 hits
// per value, apack_decode.cuh); the bytes the planes hold are a few MB per
// tensor and the products are negligible.  The design answers with one
// block per tile, so every K tile of a tensor is decoded in parallel
// (192 blocks for a 2048 x 6144 tensor at tile_k 512), and with decoding
// each tile exactly once whatever M is.  At prefill M the products dominate:
// each x value is an L1 broadcast load feeding MB fused multiply-adds, far
// from the f32 peak; tensor cores (wgmma) are for a later version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "apack_decode.cuh"

namespace {

constexpr int TILE_N = 128;   // streams per tile == threads per block
constexpr int MB = 8;         // rows of x per register chunk
constexpr int SUM_BLOCK = 256;

__global__ void __launch_bounds__(TILE_N)
decompress_tile_kernel(const float* __restrict__ x,
                       const uint32_t* __restrict__ sym,
                       const uint32_t* __restrict__ ofs,
                       const int32_t* __restrict__ stored,
                       const int32_t* __restrict__ vm,
                       const int32_t* __restrict__ ol,
                       const int32_t* __restrict__ cum,
                       const float* __restrict__ scale,
                       float* __restrict__ partial, int m, int k, int n_pad,
                       int tile_k, int ws, int wo, int n_streams) {
  extern __shared__ int8_t w_tile[];       // [tile_k][TILE_N]
  const int j = blockIdx.x;
  const int kt = blockIdx.y;
  const int c = threadIdx.x;
  const int nn = gridDim.x;
  const int s = (kt * nn + j) * TILE_N + c;
  apack::decode_stream(sym + s, ws, ofs + s, wo, n_streams, stored[s] != 0,
                       vm, ol, cum, tile_k, 8, [&](int i, int v) {
                         w_tile[i * TILE_N + c] = (int8_t)(uint8_t)v;
                       });
  const int col = j * TILE_N + c;
  const float sc = scale[col];
  const int k0 = kt * tile_k;
  const int kn = min(tile_k, k - k0);      // rows past K are zero padding
  float* part = partial + (size_t)kt * m * n_pad + col;
  for (int m0 = 0; m0 < m; m0 += MB) {
    const int mb = min(MB, m - m0);
    const float* xr = x + (size_t)m0 * k + k0;
    float acc[MB];
#pragma unroll
    for (int r = 0; r < MB; ++r) acc[r] = 0.f;
    for (int i = 0; i < kn; ++i) {
      const float w = (float)w_tile[i * TILE_N + c] * sc;
#pragma unroll
      for (int r = 0; r < MB; ++r) {
        if (r < mb) acc[r] = fmaf(__ldg(xr + (size_t)r * k + i), w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < MB; ++r) {
      if (r < mb) part[(size_t)(m0 + r) * n_pad] = acc[r];
    }
  }
}

__global__ void __launch_bounds__(SUM_BLOCK)
ktile_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
                 int m, int n, int n_pad, int nk) {
  long idx = (long)blockIdx.x * SUM_BLOCK + threadIdx.x;
  if (idx >= (long)m * n) return;
  const int row = (int)(idx / n);
  const int col = (int)(idx % n);
  const float* p = partial + (size_t)row * n_pad + col;
  float acc = p[0];
  for (int t = 1; t < nk; ++t) acc += p[(size_t)t * m * n_pad];
  out[idx] = acc;
}

}  // namespace

// x f32 [m, k]; planes u32 [ws, S] / [wo, S] with S = nk * nn * 128; stored
// i32 [S]; tables i32 [17] / [16] / [17]; scale f32 [nn * 128]; partial f32
// scratch [nk, m, nn * 128]; out f32 [m, n].
extern "C" int decompress_matmul_launch(const void* x, const void* sym,
                                        const void* ofs, const void* stored,
                                        const void* vm, const void* ol,
                                        const void* cum, const void* scale,
                                        void* partial, void* out, int m, int k,
                                        int n, int tile_k, int nk, int nn,
                                        int ws, int wo, void* stream) {
  if (m == 0 || n == 0) return 0;
  const int n_pad = nn * TILE_N;
  const int smem = tile_k * TILE_N;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decompress_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nn, nk);
  decompress_tile_kernel<<<grid, TILE_N, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const uint32_t*)sym, (const uint32_t*)ofs,
      (const int32_t*)stored, (const int32_t*)vm, (const int32_t*)ol,
      (const int32_t*)cum, (const float*)scale, (float*)partial, m, k, n_pad,
      tile_k, ws, wo, nk * nn * TILE_N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  long total = (long)m * n;
  int blocks = (int)((total + SUM_BLOCK - 1) / SUM_BLOCK);
  ktile_sum_kernel<<<blocks, SUM_BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)partial, (float*)out, m, n, n_pad, nk);
  return (int)cudaGetLastError();
}
