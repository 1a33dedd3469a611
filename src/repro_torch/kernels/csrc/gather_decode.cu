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
// int32 output, 0.02 ms).  The design keeps the memory system off that
// chain:
//   - one page a block: the block stages its page's table row once into
//     shared memory (SmemTable), so a step's row lookup is one 16-byte
//     shared load.  A block does not take two pages that share a row: the
//     row costs 336 bytes and 33 loads, while one page a block keeps the
//     grid fine-grained for the waves (G blocks, at most six of 36 KB to an
//     SM);
//   - the block stages the plane rows a coded stream can reach (rs sym and
//     ro ofs rows, apack_decode.staged_rows: 36 and 34 at n_steps 128,
//     bits 8, 35.8 KB a page) with cp.async, and decodes through SmemPlane:
//     word w of stream c at smem[w * ncols + c], so a warp's 32 reads hit
//     32 banks wherever each stream's cursor is.  A stream whose reads left
//     the staged rows (none that the encoder produces) is decoded again
//     from device memory.  Planes whose rows would not fit a block are
//     decoded from device memory throughout (GlobalPlane; rs = 0 asks for
//     that placement, which measured slower at G = 1024: PERF.md);
//   - eight decoded values wait in registers (the decode loop is unrolled
//     by eight, so the sink sees i & 7 as a constant) and leave as two
//     16-byte stores: one whole 32-byte sector a thread, in place of eight
//     4-byte stores into eight different lines' sectors.
// Duplicated (bucket-padding) pages are decoded again, as on the TPU.
#include <cuda_runtime.h>
#include <stdint.h>

#include "apack_decode.cuh"
#include "stage.cuh"

namespace {

constexpr int BLOCK = 128;
// SmemTable storage: int4 rows[16] and int cum[17], padded to 16 bytes so
// that the staged planes after it stay aligned for 16-byte copies
constexpr int TAB_BYTES = 16 * 16 + 80;
constexpr int SMEM_MAX = 232448;

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
__global__ void __launch_bounds__(BLOCK) gather_decode_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x;
  const int c0 = blockIdx.y * BLOCK;
  const int ncols = min(BLOCK, a.S - c0);
  const size_t p = (size_t)a.page_idx[g];
  const int t = a.table_idx[g];
  int4* tab_rows = reinterpret_cast<int4*>(smem);
  int* tab_cum = reinterpret_cast<int*>(tab_rows + apack::N_SYMBOLS);
  uint32_t* ssym = reinterpret_cast<uint32_t*>(smem + TAB_BYTES);
  uint32_t* sofs = ssym + (size_t)a.rs * ncols;
  const uint32_t* gsym = a.sym + p * a.Ws * a.S + c0;
  const uint32_t* gofs = a.ofs + p * a.Wo * a.S + c0;
  if (kStaged) {
    apack::stage_plane(ssym, ncols, gsym, a.S, 0, a.rs, a.Ws, ncols,
                       threadIdx.x, BLOCK);
    apack::stage_plane(sofs, ncols, gofs, a.S, 0, a.ro, a.Wo, ncols,
                       threadIdx.x, BLOCK);
  }
  apack::stage_table(tab_rows, tab_cum, a.vm + t * 17, a.ol + t * 16,
                     a.cum + t * 17, threadIdx.x, BLOCK);
  if (kStaged) apack::cp_async_wait_all();
  __syncthreads();
  const int c = threadIdx.x;
  if (c >= ncols) return;
  const bool stored = a.stored[p * a.S + c0 + c] != 0;
  int32_t* row = a.out + ((size_t)g * a.S + c0 + c) * a.n_steps;
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
  const apack::SmemTable tab{tab_rows, tab_cum};
  if (kStaged &&
      apack::decode_stream(apack::SmemPlane{ssym + c, a.rs, ncols, a.Ws},
                           apack::SmemPlane{sofs + c, a.ro, ncols, a.Wo},
                           stored, tab, a.n_steps, a.bits, sink))
    return;
  apack::decode_stream(apack::GlobalPlane{gsym + c, a.Ws, a.S},
                       apack::GlobalPlane{gofs + c, a.Wo, a.S}, stored, tab,
                       a.n_steps, a.bits, sink);
}

template <bool kStaged, bool kVec>
cudaError_t launch(const Args& a, int g, cudaStream_t stream) {
  const int ncols = min(BLOCK, a.S);
  const size_t smem =
      TAB_BYTES + (kStaged ? (size_t)(a.rs + a.ro) * ncols * 4 : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        apack::allow_max_smem<gather_decode_kernel<kStaged, kVec>>();
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(g, (a.S + BLOCK - 1) / BLOCK);
  gather_decode_kernel<kStaged, kVec><<<grid, BLOCK, smem, stream>>>(a);
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
  const bool staged =
      rs > 0 && ro > 0 &&
      TAB_BYTES + (size_t)(rs + ro) * (s < BLOCK ? s : BLOCK) * 4 <= SMEM_MAX;
  const bool vec = n_steps % 8 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!staged) a.rs = a.ro = 0;
  return (int)(staged ? (vec ? launch<true, true>(a, g, st)
                             : launch<true, false>(a, g, st))
                      : (vec ? launch<false, true>(a, g, st)
                             : launch<false, false>(a, g, st)));
}
