// Standalone APack decode kernel: B pages (or tensors) of S streams each,
// every page with its own table row or all with one shared row.
//
// Replaces the Pallas kernel repro/kernels/apack_decode.py (`_decode_kernel`
// :76 -> `decode_pallas` :87).  The TPU kernel decodes a block of 128
// streams per grid program, one stream per vector lane; here block (b, c)
// decodes streams c*128 .. c*128 + 127 of page b, one stream a thread, with
// the page body it shares with the gather decode (decode_page.cuh) and the
// decoder every decoding kernel shares (apack_decode.cuh), bit-exact with
// ref.decode.
//
// What bounds it on the card: at the codec shape (64 pages) and at a
// decode step's pack check (56 page-kinds) the grid is one block on each
// of fewer SMs than the card has, so the time is one stream's dependent
// chain of 128 steps, not bytes (a page of 128 streams x 128 values reads
// at most 47 KB of planes and writes 64 KB); at a prefill's pack check
// (1,120 page-kinds) it is the integer issue of those chains, as for the
// gather decode.  The design keeps the chain's reads in shared memory (the
// table row and the plane rows, staged once a block) and a warp's stores to
// whole sectors (decode_page.cuh).  The wrapper (kernels/apack_decode.py)
// launches this kernel alone: a table reaches it as a pointer and a row
// stride per array (0 for one row shared by every page, so no row is
// copied out per page) and the stored flags in the caller's dtype (one
// byte for bool and uint8, four for int32).
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_page.cuh"

namespace {

struct Args {
  const uint32_t* sym;        // [B, Ws, S]
  const uint32_t* ofs;        // [B, Wo, S]
  const void* stored;         // [B, S], stored_bytes wide
  const int32_t* vm;          // row b at vm + b * vm_stride, [17]
  const int32_t* ol;          // [16]
  const int32_t* cum;         // [17]
  int32_t* out;               // [B, S, n_steps]
  int S, Ws, Wo, n_steps, bits;
  int stored_bytes;           // 1 or 4
  int vm_stride, ol_stride, cum_stride;
  int rs, ro;                 // staged sym / ofs rows (kStaged)
};

template <bool kStaged, bool kVec>
__global__ void __launch_bounds__(apack::PAGE_BLOCK)
apack_decode_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t b = blockIdx.x;
  const int c0 = blockIdx.y * apack::PAGE_BLOCK;
  const int ncols = min(apack::PAGE_BLOCK, a.S - c0);
  const int c = threadIdx.x;
  const size_t i = b * a.S + c0 + c;
  const bool stored =
      c < ncols &&
      (a.stored_bytes == 1 ? static_cast<const uint8_t*>(a.stored)[i] != 0
                           : static_cast<const int32_t*>(a.stored)[i] != 0);
  const apack::PageRef pg{a.sym + b * a.Ws * a.S + c0,
                          a.ofs + b * a.Wo * a.S + c0,
                          a.vm + b * a.vm_stride, a.ol + b * a.ol_stride,
                          a.cum + b * a.cum_stride,
                          a.out + (b * a.S + c0) * a.n_steps};
  apack::decode_page<kStaged, kVec>(smem, pg, stored, a.S, a.Ws, a.Wo, ncols,
                                    a.n_steps, a.bits, a.rs, a.ro);
}

template <bool kStaged, bool kVec>
cudaError_t launch(const Args& a, int n_pages, cudaStream_t stream) {
  const size_t smem = apack::page_smem_bytes(kStaged, a.rs, a.ro, a.S);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        apack::allow_max_smem<apack_decode_kernel<kStaged, kVec>>();
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(n_pages, (a.S + apack::PAGE_BLOCK - 1) / apack::PAGE_BLOCK);
  apack_decode_kernel<kStaged, kVec>
      <<<grid, apack::PAGE_BLOCK, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// stored_bytes: 1 (bool, uint8) or 4 (int32); *_stride: elements between
// two pages' table rows, 0 for one row shared by every page; rs, ro: the
// plane rows to stage (apack_decode.staged_rows), or rs = 0 to decode from
// device memory; so do rows that would not fit a block.
extern "C" int apack_decode_launch(const void* sym, const void* ofs,
                                   const void* stored, const void* vm,
                                   const void* ol, const void* cum, void* out,
                                   int n_pages, int ws, int wo, int s,
                                   int n_steps, int bits, int stored_bytes,
                                   int vm_stride, int ol_stride,
                                   int cum_stride, int rs, int ro,
                                   void* stream) {
  if ((long)n_pages * s == 0 || n_steps == 0) return 0;
  if (stored_bytes != 1 && stored_bytes != 4)
    return (int)cudaErrorInvalidValue;
  Args a{(const uint32_t*)sym, (const uint32_t*)ofs, stored,
         (const int32_t*)vm, (const int32_t*)ol, (const int32_t*)cum,
         (int32_t*)out, s, ws, wo, n_steps, bits, stored_bytes,
         vm_stride, ol_stride, cum_stride, rs, ro};
  const bool staged = apack::page_staged(rs, ro, s);
  const bool vec = n_steps % 8 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!staged) a.rs = a.ro = 0;
  return (int)(staged ? (vec ? launch<true, true>(a, n_pages, st)
                             : launch<true, false>(a, n_pages, st))
                      : (vec ? launch<false, true>(a, n_pages, st)
                             : launch<false, false>(a, n_pages, st)));
}
