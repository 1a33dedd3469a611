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
//   - pass 1: one block per half tile (64 streams of tile (j, kt), two
//     warps).  Each warp copies its 32 streams' sym and ofs rows into
//     shared memory with cp.async (word w of stream c at [w*64 + c], so a
//     warp's reads hit 32 banks whatever word each lane is at; stage.cuh):
//     first the rows any stream can reach in its first 64 steps, then the
//     rest, which the warp waits for only at step 64.  Thread c then
//     decodes stream c from there (apack_decode.cuh).
//       M <= 8 (decode steps): each value goes straight from the decoder
//       into M f32 accumulators in registers, acc[r] = fma(x[r][i],
//       q_i * scale, acc[r]); x reaches registers eight columns ahead, two
//       16-byte loads a row, off the decode chain.
//       M > 8 (prefill): the values go to an int8 [tile_k][64] tile in
//       shared memory; then the block's 128 threads multiply it by x in
//       chunks of 32 rows, staged transposed where the planes were, each
//       thread 16 rows of one column.
//     Either way each (row, column) sums its K tile sequentially in i with
//     fused multiply-adds, and writes partial[kt, m, col].
//   - pass 2: out[m, n] = partial[0, m, n] + partial[1, m, n] + ... in kt
//     order, the JAX kernel's summation order across tiles.  Only the order
//     inside one tile's dot differs from the reference.
//
// What bounds it on the card: the serial per-stream decode.  A stream's
// tile_k steps are one dependent chain, so a launch lasts at least tile_k
// step latencies however few streams it has (~230 cycles a step alone on a
// scheduler), and a launch with every SM full is bound by the issue of the
// steps' ~80 integer instructions (64 integer lanes an SM): a 2048 x 6144
// tensor is 384 blocks, three to an SM (~67 KB of staged planes each), all
// in one wave, two warps on some of an SM's four schedulers.  The planes
// are bytes read once (a few MB a tensor) and the products are negligible.
// At prefill M the f32 products on CUDA cores add to that, and the 99 KB
// blocks run in two waves; TF32 or bf16 tensor cores would round x or W
// below f32.
//
// Times on NVIDIA H100 80GB HBM3, 700.00 W: PERF.md, kernel table.
#include <cuda_runtime.h>
#include <stdint.h>

#include "apack_decode.cuh"
#include "stage.cuh"

namespace {

constexpr int TILE_N = 128;   // streams per tile
constexpr int NS = 64;        // streams per block (half a tile)
constexpr int HALVES = TILE_N / NS;
constexpr int MAX_REG_M = 8;  // rows of x kept in registers (decode path)
constexpr int XC = 8;         // x columns a register chunk holds
constexpr int SYNC_STEP = 64; // decode step that waits for the rest of the
                              // staged planes
static_assert(XC == apack::DECODE_UNROLL && SYNC_STEP % XC == 0,
              "the sink and the staging wait key on the decode's unrolling");
constexpr int XR = 32;        // rows of x per staged chunk (prefill path)
constexpr int XRP = XR + 4;   // padded row pitch of the staged x chunk
constexpr int PROD_THREADS = 128;
constexpr int SUM_BLOCK = 256;
constexpr int TAB_BYTES = 16 * 16 + 80;   // int4 rows[16], int cum[17] + pad

struct Args {
  const float* x;
  const uint32_t* sym;
  const uint32_t* ofs;
  const int32_t* stored;
  const int32_t* vm;
  const int32_t* ol;
  const int32_t* cum;
  const float* scale;
  float* partial;
  int m, k, n_pad, tile_k, ws, wo, rs, ro, n_streams;
  int stage_only;     // timing variant: stop after the staging
  int ldx, xkt;       // x row stride and K-tile stride, in floats
};

// Bytes of the region that holds the staged planes and, on the prefill
// path, later the staged x chunk.
__host__ __device__ inline int plane_region_bytes(int rs, int ro, int tile_k,
                                                  bool tile) {
  const int planes = (rs + ro) * NS * 4;
  const int xs = tile_k * XRP * 4;
  return tile && xs > planes ? xs : planes;
}

// TILE = false: M <= MB <= MAX_REG_M rows in registers; TILE = true: the
// int8 tile and the block-wide product.
template <bool TILE, int MB>
__global__ void __launch_bounds__(TILE ? PROD_THREADS : NS)
decompress_tile_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* tab_rows = reinterpret_cast<int4*>(smem);
  int* tab_cum = reinterpret_cast<int*>(smem + 16 * 16);
  uint32_t* ps = reinterpret_cast<uint32_t*>(smem + TAB_BYTES);
  uint32_t* po = ps + a.rs * NS;
  int8_t* w_tile = reinterpret_cast<int8_t*>(
      smem + TAB_BYTES + plane_region_bytes(a.rs, a.ro, a.tile_k, TILE));
  const int tid = threadIdx.x;
  const int j = blockIdx.x / HALVES, half = blockIdx.x % HALVES;
  const int nn = gridDim.x / HALVES;
  const int kt = blockIdx.y;
  const size_t s0 = (size_t)(kt * nn + j) * TILE_N + half * NS;
  const int col0 = j * TILE_N + half * NS;
  const int k0 = kt * a.tile_k;
  const int kn = min(a.tile_k, a.k - k0);     // rows past K are zero padding

  // Each decoding warp stages its own 32 columns in two parts: the rows any
  // stream can read before step SYNC_STEP (a step reads at most 16 sym and
  // 8 ofs bits), waited for here, and the rest, waited for by the warp
  // alone at that step (on_sync), so most of the copy overlaps the decode.
  const int warp = tid / 32, lane = tid % 32;
  const bool split = a.tile_k > SYNC_STEP;
  const int rs0 = split ? min(a.rs, (16 + 16 * SYNC_STEP) / 32 + 2) : a.rs;
  const int ro0 = split ? min(a.ro, 8 * SYNC_STEP / 32 + 2) : a.ro;
  if (warp < NS / 32) {
    const int col = warp * 32;
    const uint32_t* sym = a.sym + s0 + col;
    const uint32_t* ofs = a.ofs + s0 + col;
    apack::stage_plane(ps + col, NS, sym, a.n_streams, 0, rs0, a.ws, 32, lane,
                       32);
    apack::stage_plane(po + col, NS, ofs, a.n_streams, 0, ro0, a.wo, 32, lane,
                       32);
    apack::cp_async_commit();
    apack::stage_plane(ps + col, NS, sym, a.n_streams, rs0, a.rs, a.ws, 32,
                       lane, 32);
    apack::stage_plane(po + col, NS, ofs, a.n_streams, ro0, a.ro, a.wo, 32,
                       lane, 32);
    apack::cp_async_commit();
  }
  apack::stage_table(tab_rows, tab_cum, a.vm, a.ol, a.cum, tid, blockDim.x);
  apack::cp_async_wait<1>();
  __syncthreads();
  if (a.stage_only) {
    apack::cp_async_wait<0>();
    return;
  }
  const int sync_step = split ? SYNC_STEP : -1;
  auto on_sync = [] {
    apack::cp_async_wait<0>();
    __syncwarp();
  };

  const apack::SmemTable tab{tab_rows, tab_cum};
  if (!TILE) {
    const int c = tid;
    const size_t s = s0 + c;
    const float sc = a.scale[col0 + c];
    const float* xr = a.x + (size_t)kt * a.xkt;
    // x[:, i0 .. i0 + XC) waits in registers: the chunk is loaded when the
    // previous one is used up, XC decode steps before its first use.  The
    // decode loop is unrolled by XC, so i % XC is a constant at every call
    // of the sink, xc is indexed by constants only and the sink has no
    // branch.  The wrapper lays x out so that every chunk is two aligned
    // 16-byte loads a row, zero past K (where the weights are zero too).
    float acc[MB], xc[MB][XC];
    auto load_chunk = [&](int i0) {
      const bool in = i0 < a.tile_k;
#pragma unroll
      for (int r = 0; r < MB; ++r) {
        const float4* p =
            reinterpret_cast<const float4*>(xr + (size_t)r * a.ldx + i0);
        const bool ld = in && r < a.m;
        const float4 lo = ld ? __ldg(p) : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 hi = ld ? __ldg(p + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
        xc[r][0] = lo.x; xc[r][1] = lo.y; xc[r][2] = lo.z; xc[r][3] = lo.w;
        xc[r][4] = hi.x; xc[r][5] = hi.y; xc[r][6] = hi.z; xc[r][7] = hi.w;
      }
    };
    auto sink = [&](int i, int v) {
      const int jj = i % XC;
      const float w = (float)(int8_t)(uint8_t)v * sc;
#pragma unroll
      for (int t = 0; t < XC; ++t) {
        if (t == jj) {
#pragma unroll
          for (int r = 0; r < MB; ++r) {
            if (r < a.m) acc[r] = fmaf(xc[r][t], w, acc[r]);
          }
        }
      }
      if (jj == XC - 1) load_chunk(i + 1);
    };
    auto run = [&](const auto& sp, const auto& op, int sync) {
#pragma unroll
      for (int r = 0; r < MB; ++r) acc[r] = 0.f;
      load_chunk(0);
      return apack::decode_stream(sp, op, a.stored[s] != 0, tab, a.tile_k,
                                  8, sink, sync, on_sync);
    };
    if (!run(apack::SmemPlane{ps + c, a.rs, NS, a.ws},
             apack::SmemPlane{po + c, a.ro, NS, a.wo}, sync_step))
      run(apack::GlobalPlane{a.sym + s, a.ws, a.n_streams},
          apack::GlobalPlane{a.ofs + s, a.wo, a.n_streams}, -1);
    float* part = a.partial + (size_t)kt * a.m * a.n_pad + col0 + c;
#pragma unroll
    for (int r = 0; r < MB; ++r) {
      if (r < a.m) part[(size_t)r * a.n_pad] = acc[r];
    }
    return;
  }

  if (tid < NS) {
    const int c = tid;
    const size_t s = s0 + c;
    auto sink = [&](int i, int v) { w_tile[i * NS + c] = (int8_t)(uint8_t)v; };
    if (!apack::decode_stream(apack::SmemPlane{ps + c, a.rs, NS, a.ws},
                              apack::SmemPlane{po + c, a.ro, NS, a.wo},
                              a.stored[s] != 0, tab, a.tile_k, 8, sink,
                              sync_step, on_sync))
      apack::decode_stream(apack::GlobalPlane{a.sym + s, a.ws, a.n_streams},
                           apack::GlobalPlane{a.ofs + s, a.wo, a.n_streams},
                           a.stored[s] != 0, tab, a.tile_k, 8, sink);
  }
  // product: thread -> column c, rows g*16 .. g*16+15 of each x chunk
  float* xs = reinterpret_cast<float*>(ps);    // [kn][XRP], planes are done
  const int c = tid % NS, g = tid / NS;
  const float sc = a.scale[col0 + c];
  for (int r0 = 0; r0 < a.m; r0 += XR) {
    const int rows = min(XR, a.m - r0);
    __syncthreads();              // the decode, or the previous chunk, is done
    for (int q = tid; q < XR * kn; q += PROD_THREADS) {
      const int r = q / kn, i = q - r * kn;
      xs[i * XRP + r] =
          r < rows ? a.x[(size_t)(r0 + r) * a.ldx + (size_t)kt * a.xkt + i]
                   : 0.f;
    }
    __syncthreads();
    float acc[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r] = 0.f;
    for (int i = 0; i < kn; ++i) {
      const float w = (float)w_tile[i * NS + c] * sc;
      const float4* xv = reinterpret_cast<const float4*>(xs + i * XRP + g * 16);
#pragma unroll
      for (int v4 = 0; v4 < 4; ++v4) {
        const float4 xx = xv[v4];
        acc[4 * v4 + 0] = fmaf(xx.x, w, acc[4 * v4 + 0]);
        acc[4 * v4 + 1] = fmaf(xx.y, w, acc[4 * v4 + 1]);
        acc[4 * v4 + 2] = fmaf(xx.z, w, acc[4 * v4 + 2]);
        acc[4 * v4 + 3] = fmaf(xx.w, w, acc[4 * v4 + 3]);
      }
    }
    float* part = a.partial + (size_t)kt * a.m * a.n_pad + col0 + c;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + g * 16 + r;
      if (g * 16 + r < rows) part[(size_t)row * a.n_pad] = acc[r];
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

template <bool TILE, int MB>
int launch_tiles(const Args& a, dim3 grid, int smem, cudaStream_t stream) {
  constexpr auto kernel = decompress_tile_kernel<TILE, MB>;
  const cudaError_t e = apack::allow_max_smem<kernel>();
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, TILE ? PROD_THREADS : NS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of pass 1 for m rows of x, tile_k values a stream
// and rs / ro staged sym / ofs rows.
extern "C" int decompress_matmul_smem_bytes(int m, int tile_k, int rs,
                                            int ro) {
  const bool tile = m > MAX_REG_M;
  return TAB_BYTES + plane_region_bytes(rs, ro, tile_k, tile) +
         (tile ? tile_k * NS : 0);
}

// rs / ro staged rows as apack_decode.staged_rows gives them (at most
// ws + 1 / wo + 1); x f32: element (r, kt, i) of row r, K tile kt, column
// i < tile_k at
// x[r * ldx + kt * xkt + i], 16-byte aligned at every 8th column, readable
// up to the next multiple of 8 past tile_k and zero past K; planes u32
// [ws, S] / [wo, S] with S = nk * nn * 128; stored i32 [S]; tables i32 [17] / [16] / [17]; scale f32
// [nn * 128]; partial f32 scratch [nk, m, nn * 128]; out f32 [m, n].
// stage_only != 0 runs pass 1 up to its staging and nothing else (a timing
// variant; out is not written).
extern "C" int decompress_matmul_launch(const void* x, const void* sym,
                                        const void* ofs, const void* stored,
                                        const void* vm, const void* ol,
                                        const void* cum, const void* scale,
                                        void* partial, void* out, int m, int k,
                                        int n, int tile_k, int nk, int nn,
                                        int ws, int wo, int rs, int ro,
                                        int ldx, int xkt, int stage_only,
                                        void* stream) {
  if (m == 0 || n == 0) return 0;
  if (rs < 1 || ro < 1 || rs > ws + 1 || ro > wo + 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const float*)x;
  a.sym = (const uint32_t*)sym;
  a.ofs = (const uint32_t*)ofs;
  a.stored = (const int32_t*)stored;
  a.vm = (const int32_t*)vm;
  a.ol = (const int32_t*)ol;
  a.cum = (const int32_t*)cum;
  a.scale = (const float*)scale;
  a.partial = (float*)partial;
  a.m = m; a.k = k; a.n_pad = nn * TILE_N; a.tile_k = tile_k;
  a.ws = ws; a.wo = wo; a.rs = rs; a.ro = ro;
  a.n_streams = nk * nn * TILE_N;
  a.stage_only = stage_only;
  a.ldx = ldx; a.xkt = xkt;
  const int smem = decompress_matmul_smem_bytes(m, tile_k, rs, ro);
  const dim3 grid(nn * HALVES, nk);
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (m > MAX_REG_M) rc = launch_tiles<true, 1>(a, grid, smem, st);
  else if (m > 4) rc = launch_tiles<false, 8>(a, grid, smem, st);
  else if (m > 2) rc = launch_tiles<false, 4>(a, grid, smem, st);
  else if (m > 1) rc = launch_tiles<false, 2>(a, grid, smem, st);
  else rc = launch_tiles<false, 1>(a, grid, smem, st);
  if (rc != 0 || stage_only) return rc;
  long total = (long)m * n;
  int blocks = (int)((total + SUM_BLOCK - 1) / SUM_BLOCK);
  ktile_sum_kernel<<<blocks, SUM_BLOCK, 0, st>>>(
      (const float*)partial, (float*)out, m, n, a.n_pad, nk);
  return (int)cudaGetLastError();
}
