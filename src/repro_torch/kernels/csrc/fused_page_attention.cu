// Fused paged gather-decode + attention over the APack-compressed KV pool.
//
// Replaces the Pallas kernel repro/kernels/fused_page_attention.py
// (`_fused_kernel` :101 with `_page_tile` :67, launched by
// `fused_page_attention_pallas` :169).  Same contract: for each job (one
// batch slot of one attention layer) walk its page table, build each page's
// K and V tiles by lifecycle state (HOT: int8 x per-token scale; COLD: int8 x
// per-(page, head) scale; PACKED: APack-decoded, sign-converted, x
// per-(page, head) scale), score all Hq query heads against the page with
// the causal mask on absolute position, the optional rolling window and
// softcap, and fold the page into an online softmax.  It returns the
// unnormalized (acc, m, l) written once per job.
//
// Mapping: the TPU grid (jobs, pages) runs its page axis in order on one
// core and carries (acc, m, l) in VMEM scratch across grid steps.  Blocks
// on the card run in no order, so the page axis is split over blocks and
// merged by a second pass:
//   - pass 1, grid (J, ceil(P / pages_per_block)): block (j, b) folds pages
//     b*ppb .. (b+1)*ppb - 1 of job j into its own online-softmax state,
//     starting from (acc 0, m NEG_INF, l 0), and writes that partial to
//     scratch.  Tiles live in shared memory as int8 with their scales
//     beside them (2 x 16 KB at qwen3-1.7b's [16, 8, 128] page); each value
//     is dequantized as float(q) * scale where it is used, the same single
//     rounding as the reference's tile.  A PACKED page first copies its K
//     and V planes' rows and its two table rows into shared memory
//     (cp.async, stage.cuh), then the block's 256 threads decode its K and
//     V streams from there, one stream each (apack_decode.cuh), four values
//     to a 32-bit store.  A block none of whose pages any query position can
//     see (FREE padding slots, pages masked by qpos or the window) writes
//     the partial such pages fold to, without building tiles: acc 0, l 0, m
//     the masked score (NEG_INF, or -softcap after the softcap).
//   - pass 2, one block per (job, query head): m = max_b m_b,
//     acc = sum_b acc_b * exp(m_b - m), l = sum_b l_b * exp(m_b - m), summed
//     in page order: the same (acc, m, l) as the sequential fold, up to f32
//     rounding, and deterministic (no atomics).  With one pass-1 block per
//     job it is exact.
//
// Head blocks: a thread keeps MAX_ACC accumulators, so one block holds the
// acc of at most MAX_ACC * THREADS = 4096 query-head values.  Past that
// (dbrx-132b's 48 x 128, kimi-k2's 64 x 112, command-r-plus's 96 x 128) a
// third grid axis splits the KV heads into blocks of `hpb` heads, each
// within the limit (the wrapper picks the largest divisor of H that fits):
// block (j, b, z) scores and folds only query heads [z hpb g, (z+1) hpb g)
// and writes their slice of the partials; the combine pass is unchanged.
// A PACKED page's K/V streams interleave heads (each stream is a run of
// n_steps values of the [ps, H, dh] page), so a head block decodes only the
// streams whose run touches its heads: with runs aligned to a head's dh
// values (dbrx) each stream is decoded once over all head blocks, and where
// a run straddles two heads (kimi's 128-value runs over dh 112) it is
// decoded by both head blocks.  With one head block (every page at most
// 4096 query-head values) the kernel is the single-block design above.
//
// Head tensor-parallelism (a serving mesh's model axis): a job may carry a
// third jobmeta word h0, the first of the Hf KV heads of a PACKED page that
// this launch's dense planes hold, H of them (`_page_tile` :67-97).  The
// HOT and COLD planes and the page scales then hold only heads
// [h0, h0 + H); a PACKED page's streams interleave all Hf heads, so its
// planes stay whole, the page decodes into a tile of Hf heads and the
// block reads its heads at h0 + kh.  A query head's scores, softmax and PV
// sum read only its own KV head, in the same order whatever heads share its
// block, so the head blocks of two launches, side by side, are bit-equal to
// one launch over every head.
//
// What bounds it on the card: the serial decode of a PACKED page (128
// dependent steps a stream at full width), not bytes: a page is ~24 KB of
// planes and the job's scores are a few MFLOP.  One page a block puts all
// pages of all jobs in flight at once (J x P blocks instead of J), so a call
// lasts about one page's decode plus the combine pass.
#include <cuda_runtime.h>
#include <stdint.h>

#include "apack_decode.cuh"
#include "stage.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int COMBINE_THREADS = 128;
constexpr int MAX_ACC = 16;         // hpb * g * dh <= MAX_ACC * THREADS
constexpr float NEG_INF = -1e30f;   // the reference's mask value
constexpr int PAGE_FREE = 0, PAGE_HOT = 1, PAGE_COLD = 2, PAGE_PACKED = 3;

struct Args {
  const float* q;                  // [J, Hq, dh]
  const int32_t* page_idx;         // [J, P]
  const int32_t* table_idx;        // [J, P]  K row; V row = K row + 1
  const int32_t* meta;             // [J, P, 2] (state, t0)
  const int32_t* jobmeta;          // [J, jw] (qpos, window[, h0])
  const int8_t* tok[2];            // [Pp, ps, H, dh]
  const float* tok_s[2];           // [Pp, ps, H]
  const int8_t* cold[2];           // [Pp, ps, H, dh]
  const float* pscale[2];          // [Pp, H]
  const uint32_t* sym[2];          // [Pp, Ws, S]
  const uint32_t* ofs[2];          // [Pp, Wo, S]
  const int32_t* stored[2];        // [Pp, S]
  const int32_t* vm;               // [T, 17]
  const int32_t* ol;               // [T, 16]
  const int32_t* cum;              // [T, 17]
  float* acc;                      // [J, NB, Hq, dh] partials
  float* m_out;                    // [J, NB, Hq]
  float* l_out;                    // [J, NB, Hq]
  int P, Pp, T, Hq, H, dh, ps, S, Ws, Wo, n_steps, bits;
  int Hf;                          // KV heads of a PACKED page (H unsplit)
  int jw;                          // jobmeta words a job: 2, or 3 with h0
  int ppb, rs, ro;                 // pages a block; staged plane rows
  int hpb;                         // KV heads a block (blockIdx.z's)
  float scale, softcap;
};

constexpr int TAB_BYTES = 16 * 16 + 80;   // int4 rows[16], int cum[17] + pad

// Does the run of values of stream s (n_steps values of the [ps, H, dh]
// page, flattened) hold a value of KV heads [kh0, kh0 + hpb)?
__device__ __forceinline__ bool stream_in_heads(int s, int n_steps, int dh,
                                                int H, int kh0, int hpb) {
  const int r0 = s * n_steps / dh;                 // first (token, head) row
  const int r1 = ((s + 1) * n_steps - 1) / dh;     // last
  if (r1 - r0 + 1 >= H) return true;
  for (int r = r0; r <= r1; ++r) {
    const int kh = r % H;
    if (kh >= kh0 && kh < kh0 + hpb) return true;
  }
  return false;
}

// Shared memory of pass 1: the int8 K and V tiles (each with room for a
// PACKED page's Hf heads), two staged table rows, the staged K and V
// planes, then the f32 scratch.
__host__ __device__ inline int plane_offset(int tile) {
  return 2 * tile + 2 * TAB_BYTES;
}
__host__ __device__ inline int float_offset(int tile, int S, int rs, int ro) {
  return plane_offset(tile) + 2 * (rs + ro) * S * 4;
}

__device__ __forceinline__ void copy_bytes(int8_t* dst, const int8_t* src,
                                           int n) {
  // n is a multiple of 16 and both ends are 16-byte aligned (wrapper check)
  const int4* s4 = reinterpret_cast<const int4*>(src);
  int4* d4 = reinterpret_cast<int4*>(dst);
  for (int i = threadIdx.x; i < n / 16; i += THREADS) d4[i] = __ldg(s4 + i);
}

__global__ void __launch_bounds__(THREADS) fused_page_attention_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int nb = gridDim.y;
  const int tile = a.ps * a.Hf * a.dh;     // a tile's room
  const int dtile = a.ps * a.H * a.dh;     // a dense (HOT, COLD) page
  const int g = a.Hq / a.H;
  const size_t part = (size_t)j * nb + b;
  // this block's KV heads [kh0, kh0 + hpb): query heads [hq0, hq0 + Hb)
  const int kh0 = blockIdx.z * a.hpb;
  const int Hb = a.hpb * g;
  const int hq0 = kh0 * g;
  const int qpos = a.jobmeta[j * a.jw + 0];
  const int window = a.jobmeta[j * a.jw + 1];
  // the dense planes' first head among a PACKED page's Hf (the wrapper
  // cannot check a device value: clamped into range, as page ids are)
  const int h0 = a.jw > 2 ? min(max(a.jobmeta[j * a.jw + 2], 0), a.Hf - a.H)
                          : 0;
  const bool all_heads = a.hpb == a.Hf;
  float* acc_out = a.acc + part * a.Hq * a.dh + (size_t)hq0 * a.dh;
  float* m_part = a.m_out + part * a.Hq + hq0;
  float* l_part = a.l_out + part * a.Hq + hq0;
  const int p0 = b * a.ppb;
  const int p1 = min(a.P, p0 + a.ppb);
  // the score every masked position takes (after the softcap)
  const float masked = a.softcap > 0.f ? a.softcap * tanhf(NEG_INF / a.softcap)
                                       : NEG_INF;
  // can any token of page slot p pass the mask?
  auto live_at = [&](int p) {
    const int slot = j * a.P + p;
    const int t0 = a.meta[slot * 2 + 1];
    return a.meta[slot * 2 + 0] != PAGE_FREE && t0 < qpos &&
           (window <= 0 || t0 + a.ps - 1 > qpos - window);
  };
  bool any_live = false;
  for (int p = p0; p < p1; ++p) any_live = any_live || live_at(p);
  if (!any_live) {
    for (int e = threadIdx.x; e < Hb * a.dh; e += THREADS) acc_out[e] = 0.f;
    for (int h = threadIdx.x; h < Hb; h += THREADS) {
      m_part[h] = masked;
      l_part[h] = 0.f;
    }
    return;
  }

  // per kind (0 = K, 1 = V): int8 tile, table row, staged sym / ofs rows
  int8_t* kv_t[2] = {reinterpret_cast<int8_t*>(smem),
                     reinterpret_cast<int8_t*>(smem) + tile};
  auto tab_rows = [&](int kind) {
    return reinterpret_cast<int4*>(smem + 2 * tile + kind * TAB_BYTES);
  };
  auto tab_cum = [&](int kind) {
    return reinterpret_cast<int*>(tab_rows(kind) + 16);
  };
  auto pl_sym = [&](int kind) {
    return reinterpret_cast<uint32_t*>(smem + plane_offset(tile)) +
           kind * (a.rs + a.ro) * a.S;
  };
  auto pl_ofs = [&](int kind) { return pl_sym(kind) + a.rs * a.S; };
  float* f = reinterpret_cast<float*>(
      smem + float_offset(tile, a.S, a.rs, a.ro));
  float* sc_t[2] = {f, f + a.ps * a.H};                  // per (token, head)
  float* qs = f + 2 * a.ps * a.H;                        // [Hb, dh]
  float* w_s = qs + Hb * a.dh;                           // [Hb, ps]
  float* m_s = w_s + Hb * a.ps;
  float* l_s = m_s + Hb;
  float* alpha_s = l_s + Hb;

  for (int i = threadIdx.x; i < Hb * a.dh; i += THREADS)
    qs[i] = a.q[((size_t)j * a.Hq + hq0) * a.dh + i];
  for (int h = threadIdx.x; h < Hb; h += THREADS) {
    m_s[h] = NEG_INF;
    l_s[h] = 0.f;
  }
  float acc[MAX_ACC];
#pragma unroll
  for (int k = 0; k < MAX_ACC; ++k) acc[k] = 0.f;
  // four decoded values to a 32-bit store where a stream's row allows it
  const bool word_stores = (a.n_steps & 3) == 0;

  for (int p = p0; p < p1; ++p) {
    const int slot = j * a.P + p;
    const int state = a.meta[slot * 2 + 0];
    const int t0 = a.meta[slot * 2 + 1];
    const int pid = min(max(a.page_idx[slot], 0), a.Pp - 1);
    const int tid = min(max(a.table_idx[slot], 0), a.T - 2);
    const bool live = live_at(p);
    __syncthreads();            // previous page's tiles and weights are done
    if (live) {
      if (state == PAGE_PACKED) {
        const size_t sym0 = (size_t)pid * a.Ws * a.S;
        const size_t ofs0 = (size_t)pid * a.Wo * a.S;
#pragma unroll
        for (int kind = 0; kind < 2; ++kind) {
          apack::stage_plane(pl_sym(kind), a.S, a.sym[kind] + sym0, a.S, 0,
                             a.rs, a.Ws, a.S, threadIdx.x, THREADS);
          apack::stage_plane(pl_ofs(kind), a.S, a.ofs[kind] + ofs0, a.S, 0,
                             a.ro, a.Wo, a.S, threadIdx.x, THREADS);
          const int row = tid + kind;
          apack::stage_table(tab_rows(kind), tab_cum(kind), a.vm + row * 17,
                             a.ol + row * 16, a.cum + row * 17, threadIdx.x,
                             THREADS);
        }
        apack::cp_async_wait_all();
        __syncthreads();
        for (int st = threadIdx.x; st < 2 * a.S; st += THREADS) {
          const int kind = st / a.S, s = st % a.S;
          if (!all_heads &&
              !stream_in_heads(s, a.n_steps, a.dh, a.Hf, h0 + kh0, a.hpb))
            continue;
          const apack::SmemTable tb{tab_rows(kind), tab_cum(kind)};
          const bool stored = (kind ? a.stored[1] : a.stored[0])
                                  [(size_t)pid * a.S + s] != 0;
          int8_t* out = reinterpret_cast<int8_t*>(smem) + kind * tile +
                        (size_t)s * a.n_steps;
          uint32_t buf = 0;
          // the two's complement byte of the u8 value (u >= 128 -> u - 256)
          auto sink = [&](int i, int v) {
            const uint32_t byte = (uint32_t)v & 0xFFu;
            if (!word_stores) {
              out[i] = (int8_t)byte;
              return;
            }
            buf = (i & 3 ? buf : 0u) | byte << (8 * (i & 3));
            if ((i & 3) == 3)
              *reinterpret_cast<uint32_t*>(out + i - 3) = buf;
          };
          if (!apack::decode_stream(
                  apack::SmemPlane{pl_sym(kind) + s, a.rs, a.S, a.Ws},
                  apack::SmemPlane{pl_ofs(kind) + s, a.ro, a.S, a.Wo}, stored,
                  tb, a.n_steps, a.bits, sink))
            apack::decode_stream(
                apack::GlobalPlane{(kind ? a.sym[1] : a.sym[0]) + sym0 + s,
                                   a.Ws, a.S},
                apack::GlobalPlane{(kind ? a.ofs[1] : a.ofs[0]) + ofs0 + s,
                                   a.Wo, a.S},
                stored, tb, a.n_steps, a.bits, sink);
        }
      } else {
        const int8_t* src0 = state == PAGE_HOT ? a.tok[0] : a.cold[0];
        const int8_t* src1 = state == PAGE_HOT ? a.tok[1] : a.cold[1];
        copy_bytes(kv_t[0], src0 + (size_t)pid * dtile, dtile);
        copy_bytes(kv_t[1], src1 + (size_t)pid * dtile, dtile);
      }
      for (int i = threadIdx.x; i < 2 * a.ps * a.H; i += THREADS) {
        const int kind = i / (a.ps * a.H), r = i % (a.ps * a.H);
        sc_t[kind][r] = state == PAGE_HOT
            ? a.tok_s[kind][(size_t)pid * a.ps * a.H + r]
            : a.pscale[kind][(size_t)pid * a.H + r % a.H];
      }
    }
    // a tile row's KV heads and this block's first among them: a PACKED
    // tile holds all Hf heads of the page, a dense one the planes' H
    const int tH = state == PAGE_PACKED ? a.Hf : a.H;
    const int th0 = state == PAGE_PACKED ? h0 : 0;
    __syncthreads();
    // scores [Hb, ps]: QK^T * dh^-0.5, mask, softcap
    for (int i = threadIdx.x; i < Hb * a.ps; i += THREADS) {
      const int h = i / a.ps, t = i % a.ps, kh = kh0 + h / g;
      const int pos = t0 + t;
      const bool valid = live && pos < qpos &&
                         (window <= 0 || pos > qpos - window);
      float s = NEG_INF;
      if (valid) {
        const int8_t* kr = kv_t[0] + (size_t)(t * tH + th0 + kh) * a.dh;
        const float ksc = sc_t[0][t * a.H + kh];
        const float* qr = qs + h * a.dh;
        float dot = 0.f;
        for (int d = 0; d < a.dh; ++d) dot += qr[d] * ((float)kr[d] * ksc);
        s = dot * a.scale;
      }
      if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
      w_s[i] = s;
    }
    __syncthreads();
    // online-softmax update, one thread per query head
    for (int h = threadIdx.x; h < Hb; h += THREADS) {
      float mx = NEG_INF;
      for (int t = 0; t < a.ps; ++t) mx = fmaxf(mx, w_s[h * a.ps + t]);
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      float lsum = 0.f;
      for (int t = 0; t < a.ps; ++t) {
        const int pos = t0 + t;
        const bool valid = live && pos < qpos &&
                           (window <= 0 || pos > qpos - window);
        // the explicit mask: a fully masked page keeps m at NEG_INF and
        // exp(0) would otherwise pollute l
        const float w = valid ? expf(w_s[h * a.ps + t] - m_new) : 0.f;
        w_s[h * a.ps + t] = w;
        lsum += w;
      }
      const float alpha = expf(m_old - m_new);
      alpha_s[h] = alpha;
      l_s[h] = l_s[h] * alpha + lsum;
      m_s[h] = m_new;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MAX_ACC; ++k) {
      const int e = threadIdx.x + k * THREADS;
      if (e < Hb * a.dh) {
        const int h = e / a.dh, d = e % a.dh, kh = kh0 + h / g;
        float pv = 0.f;
        if (live) {
          for (int t = 0; t < a.ps; ++t)
            pv += w_s[h * a.ps + t] *
                  ((float)kv_t[1][(size_t)(t * tH + th0 + kh) * a.dh + d] *
                   sc_t[1][t * a.H + kh]);
        }
        acc[k] = acc[k] * alpha_s[h] + pv;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < MAX_ACC; ++k) {
    const int e = threadIdx.x + k * THREADS;
    if (e < Hb * a.dh) acc_out[e] = acc[k];
  }
  for (int h = threadIdx.x; h < Hb; h += THREADS) {
    m_part[h] = m_s[h];
    l_part[h] = l_s[h];
  }
}

// Pass 2: merge job j's nb partials of query head h in page order; block
// (j, h), one thread per element of the head.
__global__ void __launch_bounds__(COMBINE_THREADS)
fused_page_attention_combine_kernel(const float* __restrict__ acc_p,
                                    const float* __restrict__ m_p,
                                    const float* __restrict__ l_p,
                                    float* __restrict__ acc,
                                    float* __restrict__ m_out,
                                    float* __restrict__ l_out, int nb, int Hq,
                                    int dh) {
  const int j = blockIdx.x, h = blockIdx.y;
  const size_t first = (size_t)j * nb * Hq + h;    // partial b at + b * Hq
  float m = NEG_INF;
  for (int b = 0; b < nb; ++b) m = fmaxf(m, m_p[first + (size_t)b * Hq]);
  for (int d = threadIdx.x; d < dh; d += COMBINE_THREADS) {
    float s = 0.f;
    for (int b = 0; b < nb; ++b) {
      const size_t pb = first + (size_t)b * Hq;
      s += acc_p[pb * dh + d] * expf(m_p[pb] - m);
    }
    acc[((size_t)j * Hq + h) * dh + d] = s;
  }
  if (threadIdx.x == 0) {
    float l = 0.f;
    for (int b = 0; b < nb; ++b) {
      const size_t pb = first + (size_t)b * Hq;
      l += l_p[pb] * expf(m_p[pb] - m);
    }
    m_out[j * Hq + h] = m;
    l_out[j * Hq + h] = l;
  }
}

}  // namespace

// Hb: the query heads of one head block (Hq with one block); Hf: the KV
// heads of a PACKED page (H without head tensor-parallelism)
extern "C" int fused_page_attention_smem_bytes(int Hb, int H, int Hf, int dh,
                                               int ps, int S, int rs,
                                               int ro) {
  const int tile = ps * Hf * dh;
  return float_offset(tile, S, rs, ro) +
         4 * (2 * ps * H + Hb * dh + Hb * ps + 3 * Hb);
}

// q f32 [J, Hq, dh]; the page table, metadata and pool planes as listed in
// Args; acc_p / m_p / l_p f32 scratch [J, NB, Hq, dh] / [J, NB, Hq] with
// NB = ceil(P / ppb); acc / m_out / l_out f32 [J, Hq, dh] / [J, Hq]; hpb
// KV heads a pass-1 block (a divisor of H), H / hpb blocks a (job, page
// chunk); Hf the KV heads of a PACKED page and jw the jobmeta words a job
// (2: (qpos, window), h0 = 0; 3: (qpos, window, h0)).
extern "C" int fused_page_attention_launch(
    const void* q, const void* page_idx, const void* table_idx,
    const void* meta, const void* jobmeta, const void* tok_k,
    const void* tok_sk, const void* tok_v, const void* tok_sv,
    const void* cold_k, const void* cold_v, const void* pscale_k,
    const void* pscale_v, const void* sym_k, const void* ofs_k,
    const void* stored_k, const void* sym_v, const void* ofs_v,
    const void* stored_v, const void* vm, const void* ol, const void* cum,
    void* acc_p, void* m_p, void* l_p, void* acc, void* m_out, void* l_out,
    int J, int P, int Pp, int T, int Hq, int H, int Hf, int dh, int ps, int S,
    int Ws, int Wo, int n_steps, int bits, int ppb, int rs, int ro, int hpb,
    int jw, float scale, float softcap, void* stream) {
  if (J == 0) return 0;
  if (hpb < 1 || H % hpb || hpb * (Hq / H) * dh > MAX_ACC * THREADS ||
      H > Hf || (jw != 2 && jw != 3) ||
      ppb < 1 || rs < 1 || rs > Ws + 1 || ro < 1 || ro > Wo + 1)
    return (int)cudaErrorInvalidValue;
  const int nb = (P + ppb - 1) / ppb;
  cudaStream_t st = (cudaStream_t)stream;
  if (nb > 0) {
    Args a;
    a.q = (const float*)q;
    a.page_idx = (const int32_t*)page_idx;
    a.table_idx = (const int32_t*)table_idx;
    a.meta = (const int32_t*)meta;
    a.jobmeta = (const int32_t*)jobmeta;
    a.tok[0] = (const int8_t*)tok_k;
    a.tok[1] = (const int8_t*)tok_v;
    a.tok_s[0] = (const float*)tok_sk;
    a.tok_s[1] = (const float*)tok_sv;
    a.cold[0] = (const int8_t*)cold_k;
    a.cold[1] = (const int8_t*)cold_v;
    a.pscale[0] = (const float*)pscale_k;
    a.pscale[1] = (const float*)pscale_v;
    a.sym[0] = (const uint32_t*)sym_k;
    a.sym[1] = (const uint32_t*)sym_v;
    a.ofs[0] = (const uint32_t*)ofs_k;
    a.ofs[1] = (const uint32_t*)ofs_v;
    a.stored[0] = (const int32_t*)stored_k;
    a.stored[1] = (const int32_t*)stored_v;
    a.vm = (const int32_t*)vm;
    a.ol = (const int32_t*)ol;
    a.cum = (const int32_t*)cum;
    a.acc = (float*)acc_p;
    a.m_out = (float*)m_p;
    a.l_out = (float*)l_p;
    a.P = P; a.Pp = Pp; a.T = T; a.Hq = Hq; a.H = H; a.dh = dh; a.ps = ps;
    a.S = S; a.Ws = Ws; a.Wo = Wo; a.n_steps = n_steps; a.bits = bits;
    a.ppb = ppb; a.rs = rs; a.ro = ro; a.hpb = hpb; a.Hf = Hf; a.jw = jw;
    a.scale = scale;
    a.softcap = softcap;
    const int smem = fused_page_attention_smem_bytes(hpb * (Hq / H), H, Hf,
                                                     dh, ps, S, rs, ro);
    cudaError_t e = apack::allow_max_smem<fused_page_attention_kernel>();
    if (e != cudaSuccess) return (int)e;
    fused_page_attention_kernel<<<dim3(J, nb, H / hpb), THREADS, smem, st>>>(
        a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  fused_page_attention_combine_kernel<<<dim3(J, Hq), COMBINE_THREADS, 0,
                                        st>>>(
      (const float*)acc_p, (const float*)m_p, (const float*)l_p, (float*)acc,
      (float*)m_out, (float*)l_out, nb, Hq, dh);
  return (int)cudaGetLastError();
}
