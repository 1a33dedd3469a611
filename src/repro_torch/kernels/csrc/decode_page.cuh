// One block decodes up to 128 streams of one APack page with that page's
// table row: the block body of the standalone decode (apack_decode.cu,
// kernel 1) and of the gather decode (gather_decode.cu, kernel 4), which
// differ only in how a block finds its page and its table row.
//
// What bounds it: each stream's serial decode chain (about 80 integer
// instructions a step, apack_decode.cuh), not bytes.  The body keeps the
// memory system off that chain:
//   - the page's table row is staged once into shared memory (SmemTable),
//     so a step's row lookup is one 16-byte shared load;
//   - the plane rows a coded stream can reach (rs sym and ro ofs rows,
//     apack_decode.staged_rows: 36 and 34 at n_steps 128, bits 8, 35.8 KB
//     a page) are staged with cp.async and read through SmemPlane: word w
//     of stream c at smem[w * ncols + c], so a warp's 32 reads hit 32
//     banks wherever each stream's cursor is.  A stream whose reads left
//     the staged rows (none that the encoder produces) is decoded again
//     from device memory.  Rows that would not fit a block (page_staged
//     is false; rs = 0 asks for it too) are read from device memory
//     throughout (GlobalPlane);
//   - eight decoded values wait in registers (the decode loop is unrolled
//     by eight, so the sink sees i & 7 as a constant) and leave as two
//     16-byte stores when n_steps % 8 == 0 (kVec): one whole 32-byte
//     sector a thread, in place of eight 4-byte stores into eight lines.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "apack_decode.cuh"
#include "stage.cuh"

namespace apack {

constexpr int PAGE_BLOCK = 128;
// SmemTable storage: int4 rows[16] and int cum[17], padded to 16 bytes so
// that the staged planes after it stay aligned for 16-byte copies
constexpr int PAGE_TAB_BYTES = 16 * 16 + 80;
constexpr int PAGE_SMEM_MAX = 232448;

// Dynamic shared memory of a block: the table row, and the staged rows of
// ncols = min(128, s) streams.
inline size_t page_smem_bytes(bool staged, int rs, int ro, int s) {
  return PAGE_TAB_BYTES +
         (staged ? (size_t)(rs + ro) * (s < PAGE_BLOCK ? s : PAGE_BLOCK) * 4
                 : 0);
}

// Whether rs and ro staged rows fit one block.
inline bool page_staged(int rs, int ro, int s) {
  return rs > 0 && ro > 0 && page_smem_bytes(true, rs, ro, s) <= PAGE_SMEM_MAX;
}

// One page as a block reads it: the planes from the block's first stream
// c0 on ([W, S] words, stream c0 + c at word c), the table row, and the
// output row of stream c0 ([S, n_steps] int32, stream c0 + c at row c).
struct PageRef {
  const uint32_t* sym;
  const uint32_t* ofs;
  const int32_t* vm;    // [17]
  const int32_t* ol;    // [16]
  const int32_t* cum;   // [17]
  int32_t* out;
};

// Decode streams c0 .. c0 + ncols - 1 of a page, thread c taking stream
// c0 + c; `stored` is thread c's flag (read by the caller, which knows its
// dtype).  Every thread of the block must call it: it stages and waits at
// a block barrier before the threads past ncols leave.
template <bool kStaged, bool kVec>
__device__ __forceinline__ void decode_page(unsigned char* smem,
                                            const PageRef& pg, bool stored,
                                            int S, int Ws, int Wo, int ncols,
                                            int n_steps, int bits, int rs,
                                            int ro) {
  int4* tab_rows = reinterpret_cast<int4*>(smem);
  int* tab_cum = reinterpret_cast<int*>(tab_rows + N_SYMBOLS);
  uint32_t* ssym = reinterpret_cast<uint32_t*>(smem + PAGE_TAB_BYTES);
  uint32_t* sofs = ssym + (size_t)rs * ncols;
  if (kStaged) {
    stage_plane(ssym, ncols, pg.sym, S, 0, rs, Ws, ncols, threadIdx.x,
                PAGE_BLOCK);
    stage_plane(sofs, ncols, pg.ofs, S, 0, ro, Wo, ncols, threadIdx.x,
                PAGE_BLOCK);
  }
  stage_table(tab_rows, tab_cum, pg.vm, pg.ol, pg.cum, threadIdx.x,
              PAGE_BLOCK);
  if (kStaged) cp_async_wait_all();
  __syncthreads();
  const int c = threadIdx.x;
  if (c >= ncols) return;
  int32_t* row = pg.out + (size_t)c * n_steps;
  int4 lo = make_int4(0, 0, 0, 0), hi = lo;
  auto sink = [&](int i, int v) {
    if (!kVec) {
      row[i] = v;
      return;
    }
    // selects, not an indexed array: a constant i & 7 folds them away,
    // and the array would otherwise live in local memory
    const int k = i & 7;
    lo.x = k == 0 ? v : lo.x;
    lo.y = k == 1 ? v : lo.y;
    lo.z = k == 2 ? v : lo.z;
    lo.w = k == 3 ? v : lo.w;
    hi.x = k == 4 ? v : hi.x;
    hi.y = k == 5 ? v : hi.y;
    hi.z = k == 6 ? v : hi.z;
    hi.w = k == 7 ? v : hi.w;
    if (k == 7) {
      int4* dst = reinterpret_cast<int4*>(row + i - 7);
      dst[0] = lo;
      dst[1] = hi;
    }
  };
  const SmemTable tab{tab_rows, tab_cum};
  if (kStaged && decode_stream(SmemPlane{ssym + c, rs, ncols, Ws},
                               SmemPlane{sofs + c, ro, ncols, Wo}, stored,
                               tab, n_steps, bits, sink))
    return;
  decode_stream(GlobalPlane{pg.sym + c, Ws, S}, GlobalPlane{pg.ofs + c, Wo, S},
                stored, tab, n_steps, bits, sink);
}

}  // namespace apack
