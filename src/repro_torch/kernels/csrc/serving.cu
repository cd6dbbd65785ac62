// Serving-path kernels of the tiered paged KV cache, written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of the reference:
//   pool_attention_partial <- repro/kernels/tiered_attention/kernel.py
//                             pool_attention_partial_tpu
//   migrate_pages          <- repro/kernels/migrate/kernel.py
//                             migrate_pages_tpu
//
// pool_attention_partial: single-query decode attention over one tier's
// paged pool, returning the online-softmax partial (acc, m, l) and the
// per-page attention mass (the tiering policy's hotness signal). A decode
// step reads every valid K/V row once and does about one multiply-add per
// element, so device-memory bytes bound it on this card. One block per
// (sequence, kv head) holds the G = H/K query heads that share the kv head,
// so each K/V row is loaded once for all G heads (no KV expansion). The
// block walks the pool page by page: a free slot (page id < 0) or a page
// wholly outside [seq - window, seq] is skipped before any load. A page's
// scores go to shared memory (one warp per token, the kv row held in
// registers across the G heads), then each head folds the page into its
// running (m, l, acc) and records the page's mass together with the max it
// was summed under; at the end every page mass is rescaled once to the
// head's final max. The TPU kernel's per-block stabiliser output is not
// needed: the mass leaves this kernel relative to the final m, as in the
// plain version. Scores and sums are float32 (K/V loaded from bf16 or f32).
//
// migrate_pages: for every selected sequence, copy one [pt, K, D] page from
// the source pool into a slot of the destination pool, in every layer, in
// place. Pure data movement, bound by device-memory bytes: one block per
// (layer, sequence) moves the page with 16-byte vector loads/stores and an
// unselected sequence's block returns at once.
//
// Plain C interface: each launcher returns cudaGetLastError() right after
// its launch (0 on success), and the caller raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAttnThreads = 128;
constexpr int kMaxDPerLane = 4;        // head dim <= 128
constexpr int kCopyThreads = 256;
constexpr float kNegInf = -1e30f;      // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum_f32(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max_f32(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ----------------------------------------------------- pool attention
// Shared memory (floats): q_s[G*D] (scaled query), acc_s[G*D], p_s[G*pt]
// (the page's scores, then its probabilities), mass_s[G*Mp], stab_s[G*Mp],
// m_s[G], l_s[G], corr_s[G].
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
pool_attention_partial_kernel(const float* __restrict__ q,
                              const T* __restrict__ pool_k,
                              const T* __restrict__ pool_v,
                              const int* __restrict__ slot_page,
                              const int* __restrict__ seq_len, int Mp, int pt,
                              int K, int G, int D, int use_window, int window,
                              float scale, float* __restrict__ acc_out,
                              float* __restrict__ m_out,
                              float* __restrict__ l_out,
                              float* __restrict__ mass_out) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / K, kk = blockIdx.x % K;
  const int H = K * G;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;
  float* q_s = smem;
  float* acc_s = q_s + G * D;
  float* p_s = acc_s + G * D;
  float* mass_s = p_s + G * pt;
  float* stab_s = mass_s + G * Mp;
  float* m_s = stab_s + G * Mp;
  float* l_s = m_s + G;
  float* corr_s = l_s + G;

  const float* qb = q + ((size_t)b * H + (size_t)kk * G) * D;
  for (int i = tid; i < G * D; i += nthr) {
    q_s[i] = qb[i] * scale;
    acc_s[i] = 0.f;
  }
  for (int i = tid; i < G * Mp; i += nthr) {
    mass_s[i] = 0.f;
    stab_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += nthr) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int seq = seq_len[b];
  const size_t tok_stride = (size_t)K * D;
  const size_t page_stride = (size_t)pt * tok_stride;
  const T* kbase = pool_k + (size_t)b * Mp * page_stride + (size_t)kk * D;
  const T* vbase = pool_v + (size_t)b * Mp * page_stride + (size_t)kk * D;

  for (int p = 0; p < Mp; ++p) {
    // block-uniform: the page id and its valid token range [lo, hi)
    const int page = slot_page[(size_t)b * Mp + p];
    if (page < 0) continue;
    const long long base = (long long)page * pt;
    long long hi_ll = (long long)seq - base + 1;            // tok <= seq
    long long lo_ll = use_window ? (long long)seq - window - base + 1 : 0;
    const int hi = (int)(hi_ll < pt ? hi_ll : pt);
    const int lo = (int)(lo_ll > 0 ? lo_ll : 0);
    if (hi <= lo) continue;

    // scores: one warp per token, the kv row in registers for all G heads
    const T* kp = kbase + (size_t)p * page_stride;
    for (int j = lo + warp; j < hi; j += nwarp) {
      const T* kt = kp + (size_t)j * tok_stride;
      float kr[kMaxDPerLane];
#pragma unroll
      for (int i = 0; i < kMaxDPerLane; ++i) {
        const int d = lane + 32 * i;
        kr[i] = d < D ? to_f32(kt[d]) : 0.f;
      }
      for (int g = 0; g < G; ++g) {
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxDPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < D) a += q_s[g * D + d] * kr[i];
        }
        a = warp_sum_f32(a);
        if (lane == 0) p_s[g * pt + j] = a;
      }
    }
    __syncthreads();

    // per head: fold the page into (m, l); probabilities replace scores
    for (int g = warp; g < G; g += nwarp) {
      float mx = kNegInf;
      for (int j = lo + lane; j < hi; j += 32) mx = fmaxf(mx, p_s[g * pt + j]);
      mx = warp_max_f32(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lo + lane; j < hi; j += 32) {
        const float e = expf(p_s[g * pt + j] - m_new);
        p_s[g * pt + j] = e;
        sum += e;
      }
      sum = warp_sum_f32(sum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        corr_s[g] = c;
        l_s[g] = l_s[g] * c + sum;
        m_s[g] = m_new;
        mass_s[g * Mp + p] = sum;
        stab_s[g * Mp + p] = m_new;
      }
    }
    __syncthreads();

    // acc[g, d] = acc * corr + sum_j p[g, j] * v[j, d]; each thread owns
    // fixed (g, d) entries, neighbouring threads read neighbouring d
    const T* vp = vbase + (size_t)p * page_stride;
    for (int i = tid; i < G * D; i += nthr) {
      const int g = i / D, d = i - g * D;
      float a = acc_s[i] * corr_s[g];
      for (int j = lo; j < hi; ++j)
        a += p_s[g * pt + j] * to_f32(vp[(size_t)j * tok_stride + d]);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  float* acc_b = acc_out + ((size_t)b * H + (size_t)kk * G) * D;
  for (int i = tid; i < G * D; i += nthr) acc_b[i] = acc_s[i];
  for (int g = tid; g < G; g += nthr) {
    m_out[(size_t)b * H + kk * G + g] = m_s[g];
    l_out[(size_t)b * H + kk * G + g] = l_s[g];
  }
  float* mass_b = mass_out + ((size_t)b * H + (size_t)kk * G) * Mp;
  for (int i = tid; i < G * Mp; i += nthr) {
    const int g = i / Mp;
    // a skipped page has no mass (and no stabiliser to rescale by)
    mass_b[i] = mass_s[i] > 0.f ? mass_s[i] * expf(stab_s[i] - m_s[g]) : 0.f;
  }
}

// ------------------------------------------------------- migrate pages
__global__ void __launch_bounds__(kCopyThreads)
migrate_pages_kernel(const unsigned char* src, unsigned char* dst,
                     const int* __restrict__ src_idx,
                     const int* __restrict__ dst_idx,
                     const int* __restrict__ sel, int B, int Ms, int Md,
                     long long page_bytes) {
  const int b = blockIdx.x, l = blockIdx.y;
  if (sel[b] == 0) return;
  int si = src_idx[b], di = dst_idx[b];
  si = si < 0 ? 0 : (si >= Ms ? Ms - 1 : si);   // clamp, as the TPU kernel
  di = di < 0 ? 0 : (di >= Md ? Md - 1 : di);
  const unsigned char* s =
      src + (((size_t)l * B + b) * Ms + si) * (size_t)page_bytes;
  unsigned char* d = dst + (((size_t)l * B + b) * Md + di) * (size_t)page_bytes;
  if ((page_bytes & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* d4 = reinterpret_cast<uint4*>(d);
    const long long n = page_bytes >> 4;
    for (long long i = threadIdx.x; i < n; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (long long i = threadIdx.x; i < page_bytes; i += blockDim.x)
      d[i] = s[i];
  }
}

}  // namespace

extern "C" {

const char* serving_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int pool_attention_partial_launch(const float* q, const void* pool_k,
                                  const void* pool_v, const int* slot_page,
                                  const int* seq_len, int B, int Mp, int pt,
                                  int K, int G, int D, int use_window,
                                  int window, float scale, int is_bf16,
                                  float* acc, float* m, float* l, float* mass,
                                  cudaStream_t stream) {
  if (B <= 0 || K <= 0 || G <= 0) return (int)cudaGetLastError();
  const size_t smem =
      sizeof(float) * ((size_t)2 * G * D + (size_t)G * pt +
                       (size_t)2 * G * Mp + (size_t)3 * G);
  const dim3 grid((unsigned)(B * K));
  if (is_bf16) {
    auto kern = pool_attention_partial_kernel<__nv_bfloat16>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kern<<<grid, kAttnThreads, smem, stream>>>(
        q, (const __nv_bfloat16*)pool_k, (const __nv_bfloat16*)pool_v,
        slot_page, seq_len, Mp, pt, K, G, D, use_window, window, scale, acc,
        m, l, mass);
  } else {
    auto kern = pool_attention_partial_kernel<float>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kern<<<grid, kAttnThreads, smem, stream>>>(
        q, (const float*)pool_k, (const float*)pool_v, slot_page, seq_len, Mp,
        pt, K, G, D, use_window, window, scale, acc, m, l, mass);
  }
  return (int)cudaGetLastError();
}

int migrate_pages_launch(const void* src, void* dst, const int* src_idx,
                         const int* dst_idx, const int* sel, int L, int B,
                         int Ms, int Md, long long page_bytes,
                         cudaStream_t stream) {
  if (L > 0 && B > 0 && page_bytes > 0) {
    const dim3 grid((unsigned)B, (unsigned)L);
    migrate_pages_kernel<<<grid, kCopyThreads, 0, stream>>>(
        (const unsigned char*)src, (unsigned char*)dst, src_idx, dst_idx, sel,
        B, Ms, Md, page_bytes);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
