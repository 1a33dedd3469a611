// Gather decode: G pages picked out of a pooled plane stack by a page-id
// vector (duplicates allowed), each decoded with its own row of a stacked
// table pool picked by a table-id vector.
//
// Replaces the Pallas kernel repro/kernels/paged_decode.py
// (`_gather_decode_kernel` :150 -> `gather_decode_pallas` :162).  There a
// scalar-prefetched page-id vector drives the BlockSpec index maps, so grid
// program g copies page page_idx[g]'s planes into VMEM and decodes its 128
// streams one per vector lane.  Here the index maps become pointer
// arithmetic: one thread decodes one stream of one gathered page, reading
// page_idx[g] and table_idx[g] itself and offsetting into the pooled planes
// and the table stack in place, with no gathered copy of the planes.  The
// decoder is the device function shared by every decoding kernel
// (apack_decode.cuh), bit-exact with ref.decode.
//
// What bounds it on the card: the serial per-stream decode chain, as in
// apack_decode.cu, not device memory: each stream reads at most its coded
// words and writes n_steps int32 values.  The grid covers every (gathered
// page, stream) pair, 128 threads to a block, so a materialize step's 1024
// gathered pages give 131,072 independent streams to hide the chain's
// latency.  Duplicated (bucket-padding) pages are decoded again, as on the
// TPU; their planes hit in L2.  Each thread writes its own output row
// (strided stores), as the standalone decode kernel does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "apack_decode.cuh"

namespace {

constexpr int BLOCK = 128;

__global__ void __launch_bounds__(BLOCK)
gather_decode_kernel(const uint32_t* __restrict__ sym,
                     const uint32_t* __restrict__ ofs,
                     const int32_t* __restrict__ stored,
                     const int32_t* __restrict__ page_idx,
                     const int32_t* __restrict__ table_idx,
                     const int32_t* __restrict__ vm,
                     const int32_t* __restrict__ ol,
                     const int32_t* __restrict__ cum,
                     int32_t* __restrict__ out, int g, int ws, int wo, int s,
                     int n_steps, int bits) {
  long gid = (long)blockIdx.x * BLOCK + threadIdx.x;
  if (gid >= (long)g * s) return;
  int gi = (int)(gid / s);
  int st = (int)(gid % s);
  size_t p = (size_t)page_idx[gi];
  int t = table_idx[gi];
  int32_t* row = out + gid * n_steps;
  const apack::GlobalPlane sp{sym + p * ws * s + st, ws, s};
  const apack::GlobalPlane op{ofs + p * wo * s + st, wo, s};
  const apack::GlobalTable tab{vm + t * 17, ol + t * 16, cum + t * 17};
  apack::decode_stream(sp, op, stored[p * s + st] != 0, tab, n_steps, bits,
                       [&](int i, int v) { row[i] = v; });
}

}  // namespace

// Page and table ids are range-checked by the Python wrapper before the
// launch (gather_decode in kernels/paged_decode.py).
extern "C" int gather_decode_launch(const void* sym, const void* ofs,
                                    const void* stored, const void* page_idx,
                                    const void* table_idx, const void* vm,
                                    const void* ol, const void* cum,
                                    void* out, int g, int ws, int wo, int s,
                                    int n_steps, int bits, void* stream) {
  long n = (long)g * s;
  if (n == 0) return 0;
  int grid = (int)((n + BLOCK - 1) / BLOCK);
  gather_decode_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)sym, (const uint32_t*)ofs, (const int32_t*)stored,
      (const int32_t*)page_idx, (const int32_t*)table_idx,
      (const int32_t*)vm, (const int32_t*)ol, (const int32_t*)cum,
      (int32_t*)out, g, ws, wo, s, n_steps, bits);
  return (int)cudaGetLastError();
}
