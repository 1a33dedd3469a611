// Gather decode: G pages picked out of a pooled plane stack by a page-id
// vector (duplicates allowed), each decoded with its own row of a stacked
// table pool picked by a table-id vector.
//
// Replaces the Pallas kernel repro/kernels/paged_decode.py
// (`_gather_decode_kernel` :150 -> `gather_decode_pallas` :162).  There a
// scalar-prefetched page-id vector drives the BlockSpec index maps, so grid
// program g copies page page_idx[g]'s planes into VMEM and decodes its 128
// streams one per vector lane.  Here block (g, c) reads page_idx[g] and
// table_idx[g] itself and decodes streams c*128 .. c*128 + 127 of that page,
// one stream a thread, with the decoder every decoding kernel shares
// (apack_decode.cuh), bit-exact with ref.decode.  The ids were range-checked
// by the wrapper (kernels/paged_decode.py) before the launch.
//
// What bounds it on the card: the serial decode chain of 131,072 streams
// at a materialize step's G = 1024 (about 80 integer instructions a step,
// 128 steps: some 0.09 ms of the integer pipe's issue), not bytes (64 MB of
// int32 output, 0.02 ms).  The block body it shares with the standalone
// decode (decode_page.cuh) keeps the memory system off that chain: the
// page's table row and the plane rows its streams reach staged in shared
// memory, eight values to two 16-byte stores.  One page a block: a block
// does not take two pages that share a row, since the row costs 336 bytes
// and 33 loads, while one page a block keeps the grid fine-grained for the
// waves (G blocks, at most six of 36 KB to an SM).
// Duplicated (bucket-padding) pages are decoded again, as on the TPU.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_page.cuh"

namespace {

struct Args {
  const uint32_t* sym;        // [P, Ws, S]
  const uint32_t* ofs;        // [P, Wo, S]
  const int32_t* stored;      // [P, S]
  const int32_t* page_idx;    // [G]
  const int32_t* table_idx;   // [G]
  const int32_t* vm;          // [T, 17]
  const int32_t* ol;          // [T, 16]
  const int32_t* cum;         // [T, 17]
  int32_t* out;               // [G, S, n_steps]
  int S, Ws, Wo, n_steps, bits;
  int rs, ro;                 // staged sym / ofs rows (kStaged)
};

template <bool kStaged, bool kVec>
__global__ void __launch_bounds__(apack::PAGE_BLOCK)
gather_decode_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x;
  const int c0 = blockIdx.y * apack::PAGE_BLOCK;
  const int ncols = min(apack::PAGE_BLOCK, a.S - c0);
  const size_t p = (size_t)a.page_idx[g];
  const int t = a.table_idx[g];
  const int c = threadIdx.x;
  const bool stored = c < ncols && a.stored[p * a.S + c0 + c] != 0;
  const apack::PageRef pg{a.sym + p * a.Ws * a.S + c0,
                          a.ofs + p * a.Wo * a.S + c0,
                          a.vm + t * 17, a.ol + t * 16, a.cum + t * 17,
                          a.out + ((size_t)g * a.S + c0) * a.n_steps};
  apack::decode_page<kStaged, kVec>(smem, pg, stored, a.S, a.Ws, a.Wo, ncols,
                                    a.n_steps, a.bits, a.rs, a.ro);
}

template <bool kStaged, bool kVec>
cudaError_t launch(const Args& a, int g, cudaStream_t stream) {
  const size_t smem = apack::page_smem_bytes(kStaged, a.rs, a.ro, a.S);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        apack::allow_max_smem<gather_decode_kernel<kStaged, kVec>>();
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(g, (a.S + apack::PAGE_BLOCK - 1) / apack::PAGE_BLOCK);
  gather_decode_kernel<kStaged, kVec>
      <<<grid, apack::PAGE_BLOCK, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// rs, ro: the plane rows to stage (apack_decode.staged_rows), or rs = 0 to
// decode from device memory; so do rows that would not fit a block.
extern "C" int gather_decode_launch(const void* sym, const void* ofs,
                                    const void* stored, const void* page_idx,
                                    const void* table_idx, const void* vm,
                                    const void* ol, const void* cum,
                                    void* out, int g, int ws, int wo, int s,
                                    int n_steps, int bits, int rs, int ro,
                                    void* stream) {
  if ((long)g * s == 0 || n_steps == 0) return 0;
  Args a{(const uint32_t*)sym, (const uint32_t*)ofs, (const int32_t*)stored,
         (const int32_t*)page_idx, (const int32_t*)table_idx,
         (const int32_t*)vm, (const int32_t*)ol, (const int32_t*)cum,
         (int32_t*)out, s, ws, wo, n_steps, bits, rs, ro};
  const bool staged = apack::page_staged(rs, ro, s);
  const bool vec = n_steps % 8 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!staged) a.rs = a.ro = 0;
  return (int)(staged ? (vec ? launch<true, true>(a, g, st)
                             : launch<true, false>(a, g, st))
                      : (vec ? launch<false, true>(a, g, st)
                             : launch<false, false>(a, g, st)));
}
