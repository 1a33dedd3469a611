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
// on the card run in no order, so one block owns one job and a loop inside
// the block walks the pages.  Tiles live in shared memory as int8 with
// their scales beside them (2 x 16 KB at qwen3-1.7b's [16, 8, 128] page);
// each value is dequantized as float(q) * scale where it is used, the same
// single rounding as the reference's tile.  A PACKED page is decoded by the
// block's threads, one stream each (apack_decode.cuh): K streams and V
// streams together are 256 at full width, one per thread.  Pages that no
// query position can see (FREE padding slots) skip the tile build and fold
// in as fully masked, which leaves (acc, m, l) exactly as the reference
// leaves them.
//
// What bounds it on the card: at J = max_batch jobs the grid has only a few
// blocks, and each spends most of its time in the serial per-stream decode
// of its PACKED pages, page after page.  It is latency-bound, far from both
// the memory and the arithmetic roofline.  The known next step is to split
// a job's pages over several blocks with a combine pass.
#include <cuda_runtime.h>
#include <stdint.h>

#include "apack_decode.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ACC = 16;         // Hq * dh <= MAX_ACC * THREADS
constexpr float NEG_INF = -1e30f;   // the reference's mask value
constexpr int PAGE_FREE = 0, PAGE_HOT = 1, PAGE_COLD = 2, PAGE_PACKED = 3;

struct Args {
  const float* q;                  // [J, Hq, dh]
  const int32_t* page_idx;         // [J, P]
  const int32_t* table_idx;        // [J, P]  K row; V row = K row + 1
  const int32_t* meta;             // [J, P, 2] (state, t0)
  const int32_t* jobmeta;          // [J, 2] (qpos, window)
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
  float* acc;                      // [J, Hq, dh]
  float* m_out;                    // [J, Hq]
  float* l_out;                    // [J, Hq]
  int P, Pp, T, Hq, H, dh, ps, S, Ws, Wo, n_steps, bits;
  float scale, softcap;
};

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
  const int tile = a.ps * a.H * a.dh;
  const int g = a.Hq / a.H;
  int8_t* kv_t[2] = {reinterpret_cast<int8_t*>(smem),
                     reinterpret_cast<int8_t*>(smem) + tile};
  float* f = reinterpret_cast<float*>(smem + 2 * tile);
  float* sc_t[2] = {f, f + a.ps * a.H};                  // per (token, head)
  float* qs = f + 2 * a.ps * a.H;                        // [Hq, dh]
  float* w_s = qs + a.Hq * a.dh;                         // [Hq, ps]
  float* m_s = w_s + a.Hq * a.ps;
  float* l_s = m_s + a.Hq;
  float* alpha_s = l_s + a.Hq;
  int* tabs = reinterpret_cast<int*>(alpha_s + a.Hq);    // 2 x (17+16+17)

  for (int i = threadIdx.x; i < a.Hq * a.dh; i += THREADS)
    qs[i] = a.q[(size_t)j * a.Hq * a.dh + i];
  for (int h = threadIdx.x; h < a.Hq; h += THREADS) {
    m_s[h] = NEG_INF;
    l_s[h] = 0.f;
  }
  float acc[MAX_ACC];
#pragma unroll
  for (int k = 0; k < MAX_ACC; ++k) acc[k] = 0.f;

  const int qpos = a.jobmeta[j * 2 + 0];
  const int window = a.jobmeta[j * 2 + 1];

  for (int p = 0; p < a.P; ++p) {
    const int slot = j * a.P + p;
    const int state = a.meta[slot * 2 + 0];
    const int t0 = a.meta[slot * 2 + 1];
    const int pid = min(max(a.page_idx[slot], 0), a.Pp - 1);
    const int tid = min(max(a.table_idx[slot], 0), a.T - 2);
    // can any token of this page pass the mask?
    const bool live = state != PAGE_FREE && t0 < qpos &&
                      (window <= 0 || t0 + a.ps - 1 > qpos - window);
    __syncthreads();            // previous page's tiles and weights are done
    if (live) {
      if (state == PAGE_PACKED) {
        for (int i = threadIdx.x; i < 100; i += THREADS) {
          int kind = i / 50, r = i % 50, row = tid + kind;
          tabs[i] = r < 17 ? a.vm[row * 17 + r]
                  : r < 33 ? a.ol[row * 16 + r - 17]
                           : a.cum[row * 17 + r - 33];
        }
        __syncthreads();
        for (int st = threadIdx.x; st < 2 * a.S; st += THREADS) {
          const int kind = st / a.S, s = st % a.S;
          const int* tb = tabs + 50 * kind;
          int8_t* out = kv_t[kind] + (size_t)s * a.n_steps;
          apack::decode_stream(
              a.sym[kind] + (size_t)pid * a.Ws * a.S + s, a.Ws,
              a.ofs[kind] + (size_t)pid * a.Wo * a.S + s, a.Wo, a.S,
              a.stored[kind][(size_t)pid * a.S + s] != 0, tb, tb + 17,
              tb + 33, a.n_steps, a.bits,
              // two's complement of the u8 value (u >= 128 -> u - 256)
              [&](int i, int v) { out[i] = (int8_t)(v >= 128 ? v - 256 : v); });
        }
      } else {
        const int8_t* src0 = state == PAGE_HOT ? a.tok[0] : a.cold[0];
        const int8_t* src1 = state == PAGE_HOT ? a.tok[1] : a.cold[1];
        copy_bytes(kv_t[0], src0 + (size_t)pid * tile, tile);
        copy_bytes(kv_t[1], src1 + (size_t)pid * tile, tile);
      }
      for (int i = threadIdx.x; i < 2 * a.ps * a.H; i += THREADS) {
        const int kind = i / (a.ps * a.H), r = i % (a.ps * a.H);
        sc_t[kind][r] = state == PAGE_HOT
            ? a.tok_s[kind][(size_t)pid * a.ps * a.H + r]
            : a.pscale[kind][(size_t)pid * a.H + r % a.H];
      }
    }
    __syncthreads();
    // scores [Hq, ps]: QK^T * dh^-0.5, mask, softcap
    for (int i = threadIdx.x; i < a.Hq * a.ps; i += THREADS) {
      const int h = i / a.ps, t = i % a.ps, kh = h / g;
      const int pos = t0 + t;
      const bool valid = live && pos < qpos &&
                         (window <= 0 || pos > qpos - window);
      float s = NEG_INF;
      if (valid) {
        const int8_t* kr = kv_t[0] + (size_t)(t * a.H + kh) * a.dh;
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
    for (int h = threadIdx.x; h < a.Hq; h += THREADS) {
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
      if (e < a.Hq * a.dh) {
        const int h = e / a.dh, d = e % a.dh, kh = h / g;
        float pv = 0.f;
        if (live) {
          for (int t = 0; t < a.ps; ++t)
            pv += w_s[h * a.ps + t] *
                  ((float)kv_t[1][(size_t)(t * a.H + kh) * a.dh + d] *
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
    if (e < a.Hq * a.dh) a.acc[(size_t)j * a.Hq * a.dh + e] = acc[k];
  }
  for (int h = threadIdx.x; h < a.Hq; h += THREADS) {
    a.m_out[j * a.Hq + h] = m_s[h];
    a.l_out[j * a.Hq + h] = l_s[h];
  }
}

}  // namespace

extern "C" int fused_page_attention_smem_bytes(int Hq, int H, int dh, int ps) {
  return 2 * ps * H * dh +
         4 * (2 * ps * H + Hq * dh + Hq * ps + 3 * Hq) + 4 * 100;
}

extern "C" int fused_page_attention_launch(
    const void* q, const void* page_idx, const void* table_idx,
    const void* meta, const void* jobmeta, const void* tok_k,
    const void* tok_sk, const void* tok_v, const void* tok_sv,
    const void* cold_k, const void* cold_v, const void* pscale_k,
    const void* pscale_v, const void* sym_k, const void* ofs_k,
    const void* stored_k, const void* sym_v, const void* ofs_v,
    const void* stored_v, const void* vm, const void* ol, const void* cum,
    void* acc, void* m_out, void* l_out, int J, int P, int Pp, int T, int Hq,
    int H, int dh, int ps, int S, int Ws, int Wo, int n_steps, int bits,
    float scale, float softcap, void* stream) {
  if (J == 0) return 0;
  if (Hq * dh > MAX_ACC * THREADS) return (int)cudaErrorInvalidValue;
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
  a.acc = (float*)acc;
  a.m_out = (float*)m_out;
  a.l_out = (float*)l_out;
  a.P = P; a.Pp = Pp; a.T = T; a.Hq = Hq; a.H = H; a.dh = dh; a.ps = ps;
  a.S = S; a.Ws = Ws; a.Wo = Wo; a.n_steps = n_steps; a.bits = bits;
  a.scale = scale;
  a.softcap = softcap;
  int smem = fused_page_attention_smem_bytes(Hq, H, dh, ps);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_page_attention_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_page_attention_kernel<<<J, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
