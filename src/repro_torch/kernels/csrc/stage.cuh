// Staging of APack planes into shared memory with cp.async, shared by the
// kernels that decode from shared memory (decompress_matmul.cu,
// fused_page_attention.cu), and the launch attribute they need for it.
//
// Threads copy rows of ncols consecutive u32 words, rows `stride` words
// apart in device memory, into a [rows][pitch] array in shared memory:
// 16-byte copies where both ends allow it, 4-byte copies otherwise.  The
// copies bypass registers; a wait for their group (cp_async_wait) and a
// barrier over the threads that read them make them visible.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace apack {

// Let kernel K use up to the 227 KB of shared memory a block can have, and
// prefer shared memory over L1 in the SM's split, once per device.
template <auto K>
cudaError_t allow_max_smem() {
  static unsigned long long done = 0;     // one bit per device
  const auto kernel = K;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (done >> dev & 1ull)) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           232448);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) done |= 1ull << dev;
  return e;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}

// Copy rows [r0, r1) of ncols consecutive words, src_pitch words apart in
// device memory, to dst[r * dst_pitch + c].
__device__ __forceinline__ void stage_block(uint32_t* dst, int dst_pitch,
                                            const uint32_t* src,
                                            size_t src_pitch, int r0, int r1,
                                            int ncols, int tid,
                                            int nthreads) {
  const int rows = r1 - r0;
  dst += (size_t)r0 * dst_pitch;
  src += r0 * src_pitch;
  const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(dst) | (src_pitch * 4) |
                     ((size_t)dst_pitch * 4) | ((size_t)ncols * 4)) & 15) == 0;
  if (vec) {
    const int per_row = ncols / 4;
    for (int q = tid; q < rows * per_row; q += nthreads) {
      const int r = q / per_row, p = (q - r * per_row) * 4;
      cp_async16(dst + (size_t)r * dst_pitch + p, src + r * src_pitch + p);
    }
  } else {
    for (int q = tid; q < rows * ncols; q += nthreads) {
      const int r = q / ncols, c = q - r * ncols;
      cp_async4(dst + (size_t)r * dst_pitch + c, src + r * src_pitch + c);
    }
  }
}

// Stage rows [0, rows) of a plane of n_words rows (SmemPlane): the plane's
// own rows, and zeros for a row past its end.
__device__ __forceinline__ void stage_plane(uint32_t* dst, int dst_pitch,
                                            const uint32_t* src,
                                            size_t src_pitch, int r0, int r1,
                                            int n_words, int ncols, int tid,
                                            int nthreads) {
  stage_block(dst, dst_pitch, src, src_pitch, r0, min(r1, n_words), ncols,
              tid, nthreads);
  for (int r = max(r0, n_words); r < r1; ++r)
    for (int c = tid; c < ncols; c += nthreads)
      dst[(size_t)r * dst_pitch + c] = 0u;
}

}  // namespace apack
