// Prefill-path kernels of the full-sequence forward, written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of the reference:
//   flash_attention <- repro/kernels/flash_attention/kernel.py
//                      flash_attention_tpu
//   ssd_scan        <- repro/kernels/ssd_scan/kernel.py ssd_scan_tpu
//
// flash_attention: causal / sliding-window / full attention with GQA and
// right-aligned queries (q_offset = Skv - Sq), float32 online softmax.
// Long prefills are bound by operations (two products of 64 x 64 x D per
// pair of tiles). One block of 128 threads per (batch, head, 64-query
// tile) keeps the scaled query tile, one 64-key K tile and V tile and the
// tile's scores in shared memory (float32, converted on load from bf16 or
// f32) and (m, l, acc) in float32: acc in registers, 4 rows x D/8 columns a
// thread. It walks only the key tiles inside the band, as the TPU kernel's
// `visible` check does; masked scores inside a visible tile take the
// reference's finite NEG_INF = -1e30, so a row wholly masked in one tile
// gets p = exp(0) = 1 there and the first real key erases it through
// corr = exp(-1e30 - m) = 0 (with -inf that step would be NaN). Keys past
// Skv get p = 0. The KV head is h / (H / K): no expansion. Any Sq <= Skv
// and any head dim up to 128; strided [B, H, S, D] views (last dimension
// contiguous) are read in place. bf16 inputs with a head dim that is a
// multiple of 16 run the products on the tensor cores (mma.sync, below);
// f32 inputs, and other head dims, run them on the CUDA cores in float32,
// so f32 inputs keep f32 accuracy.
//
// ssd_scan: the Mamba2 SSD chunked scan. Each (batch, head) carries its
// state h [P, N] from chunk to chunk, the TPU kernel's sequential chunk
// axis: one block of 256 threads per (batch, head) walks its chunks in
// order with h in shared memory (float32). Inside a chunk of Q steps it
// works in 64-row tiles, so the Q x Q decay-weighted scores never exist
// whole (at Q = 256 they alone would take 256 KiB): for each tile of
// output rows i, y_i = exp(a_cum_i) * (C_i h^T) + sum over key tiles
// j <= i of ((C_i B_j^T) o L_ij) X_j, with L = exp(a_cum_i - a_cum_j)
// selected to 0 above the diagonal (never multiplied by a mask: exp
// overflows there, and inf * 0 is NaN); then h = exp(a_cum_last) h +
// X^T (B o exp(a_cum_last - a_cum)). a_cum and its differences are kept in
// float64 and rounded once before exp: in float32, a_cum_i - a_cum_j
// cancels to about one ulp of |a_cum| (1.2e-4 at a chunk's -1,600 under
// strong decays), and two float32 sums taken in different orders then
// disagree by ~1e-3 in y. B and C come per group ([B, S, G, N],
// head h reads group h / (H / G)) and x, a, b, c are read through their
// strides, so the caller neither repeats groups nor transposes. Bound by
// operations (about Q^2 (N + P) + 4 Q P N flops per chunk and head).
//
// Plain C interface: each launcher returns cudaGetLastError() right after
// its launch (0 on success), and the caller raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;      // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// ------------------------------------------------------ flash attention
constexpr int kFaThreads = 128;
constexpr int kFaBQ = 64;              // query rows per block
constexpr int kFaBK = 64;              // keys per tile
constexpr int kFaMaxD = 128;
constexpr int kFaDCols = kFaMaxD / 8;  // acc columns per thread

// Shared memory (floats): q_s[BQ][D+1] (scaled), k_s[BK][D+1],
// v_s[BK][D], p_s[BQ][BK+1], m_s[BQ], l_s[BQ], corr_s[BQ].
template <typename T>
__global__ void __launch_bounds__(kFaThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int G, int Sq, int Skv, int D, long long qsb,
                       long long qsh, long long qss, long long ksb,
                       long long ksh, long long kss, long long vsb,
                       long long vsh, long long vss, long long osb,
                       long long osh, long long oss, int causal,
                       int use_window, int window, float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* q_s = smem;
  float* k_s = q_s + kFaBQ * DP;
  float* v_s = k_s + kFaBK * DP;
  float* p_s = v_s + kFaBK * D;
  float* m_s = p_s + kFaBQ * (kFaBK + 1);
  float* l_s = m_s + kFaBQ;
  float* corr_s = l_s + kFaBQ;

  const int iq = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kh = h / G;
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;      // 16 x 8 thread grid
  const int q_offset = Skv - Sq;
  const int q0 = iq * kFaBQ;
  const int nq = min(kFaBQ, Sq - q0);         // valid rows of this tile
  const int q_lo = q_offset + q0, q_hi = q_offset + q0 + nq - 1;

  const T* qb = q + b * qsb + h * qsh + (long long)q0 * qss;
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;
  for (int i = tid; i < kFaBQ * D; i += kFaThreads) {
    const int r = i / D, d = i - r * D;
    q_s[r * DP + d] = r < nq ? to_f32(qb[r * qss + d]) * scale : 0.f;
  }
  for (int r = tid; r < kFaBQ; r += kFaThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  float acc[4][kFaDCols];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < kFaDCols; ++jj) acc[ii][jj] = 0.f;

  // key tiles inside the band: causal ends at the last row's position, the
  // window starts at the first row's oldest visible key
  const int nk = (Skv + kFaBK - 1) / kFaBK;
  int kt_hi = nk - 1;
  if (causal) kt_hi = min(kt_hi, q_hi / kFaBK);
  int kt_lo = 0;
  if (use_window) {
    const int lo_key = q_lo - window + 1;
    kt_lo = lo_key > 0 ? lo_key / kFaBK : 0;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kFaBK;
    const int nkv = min(kFaBK, Skv - k0);
    __syncthreads();   // previous tile's k_s / v_s / p_s reads are done
    for (int i = tid; i < kFaBK * D; i += kFaThreads) {
      const int r = i / D, d = i - r * D;
      const bool ok = r < nkv;
      const long long row = (long long)(k0 + r);
      k_s[r * DP + d] = ok ? to_f32(kb[row * kss + d]) : 0.f;
      v_s[r * D + d] = ok ? to_f32(vb[row * vss + d]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16 ii, keys tx + 8 jj
    float s[4][8];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) s[ii][jj] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qr[4], kr[8];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) qr[ii] = q_s[(ty + 16 * ii) * DP + d];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) kr[jj] = k_s[(tx + 8 * jj) * DP + d];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) s[ii][jj] += qr[ii] * kr[jj];
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = ty + 16 * ii;
      const int qpos = q_lo + r;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = tx + 8 * jj;
        const int kpos = k0 + c;
        bool ok = true;
        if (causal) ok = ok && kpos <= qpos;
        if (use_window) ok = ok && kpos > qpos - window;
        p_s[r * (kFaBK + 1) + c] = ok ? s[ii][jj] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: two threads per row, 32 keys each
    {
      const int r = tid >> 1, half = tid & 1;
      float* pr = p_s + r * (kFaBK + 1) + half * 32;
      const int cmax = min(32, nkv - half * 32);    // keys < Skv
      float mx = kNegInf;
      for (int c = 0; c < cmax; ++c) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = 0; c < 32; ++c) {
        const float e = c < cmax ? expf(pr[c] - m_new) : 0.f;
        pr[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();
      if (half == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p v: rows ty + 16 ii, columns tx + 8 jj
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const float c = corr_s[ty + 16 * ii];
#pragma unroll
      for (int jj = 0; jj < kFaDCols; ++jj) acc[ii][jj] *= c;
    }
    for (int c = 0; c < kFaBK; ++c) {
      float pr[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) pr[ii] = p_s[(ty + 16 * ii) * (kFaBK + 1) + c];
#pragma unroll
      for (int jj = 0; jj < kFaDCols; ++jj) {
        const int d = tx + 8 * jj;
        if (d < D) {
          const float vv = v_s[c * D + d];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) acc[ii][jj] += pr[ii] * vv;
        }
      }
    }
  }
  __syncthreads();

  T* ob = o + b * osb + h * osh + (long long)q0 * oss;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = ty + 16 * ii;
    if (r >= nq) continue;
    const float inv_l = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < kFaDCols; ++jj) {
      const int d = tx + 8 * jj;
      if (d < D) store(ob + r * oss + d, acc[ii][jj] * inv_l);
    }
  }
}

// bf16 flash attention on the tensor cores (mma.sync m16n8k16, bf16
// products, float32 accumulation), for a head dim that is a multiple of 16
// and 16-byte aligned rows. One block of 4 warps per (batch, head,
// 64-query tile); each warp owns 16 query rows and keeps its Q fragments,
// its 16 x 64 scores and its 16 x D output in registers (the
// FlashAttention-2 layout: the score accumulator of two 8-key tiles is the
// A fragment of the next product). The TPU kernel takes P V in float32 (v
// is widened before the product), so p is not rounded to one bf16: a bf16
// p carries 2^-9 of relative error into every output, which on an H100
// put layer 0 of Llama 3.2 1B's prefill 0.25 from the plain version, past
// the 2e-2 bound. p is split into a bf16 high part and the bf16 of its
// remainder, two products into the same float32 accumulator, which keeps p
// to about 2^-17 (bf16 v times a bf16 part is exact in float32). K and V
// tiles stream into shared memory with cp.async,
// two stages deep, so the next tile's loads overlap this tile's products;
// V's B fragments come transposed through ldmatrix. Rows are padded by 8
// elements so fragment loads hit distinct banks. The online softmax, the
// band skip and the masking are the float32 kernel's.
constexpr int kMmaThreads = 128;
constexpr int kMmaPad = 8;             // bf16 elements of row padding

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (lo, hi) as a bf16 pair and the bf16 pair of what that rounding left
__device__ __forceinline__ void split_bf16(float lo, float hi, uint32_t& top,
                                           uint32_t& rest) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  top = *reinterpret_cast<const uint32_t*>(&t);
  rest = pack_bf16(lo - __low2float(t), hi - __high2float(t));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16-byte global -> shared copy; src_bytes = 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// B fragments (b0, b1) of a 16 x 8 tile of a row-major [k][n] matrix in
// shared memory; lanes 0-15 address the 16 rows
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

// copy rows [0, 64) of a [rows][D] bf16 tile (row stride `stride`
// elements) into shared memory with row stride DS; rows >= n are zeros
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long stride, int n, int D,
                                                int DS, int tid) {
  const int D8 = D / 8;
  for (int i = tid; i < kFaBK * D8; i += kMmaThreads) {
    const int r = i / D8, c = 8 * (i - r * D8);
    const bool ok = r < n;
    cp_async16(dst + r * DS + c, ok ? src + r * stride + c : src, ok ? 16 : 0);
  }
}

// Shared memory (bf16): q_s[BQ][D+8], then two stages of k_s[BK][D+8] and
// v_s[BK][D+8].
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, int H, int G,
                           int Sq, int Skv, int D, long long qsb,
                           long long qsh, long long qss, long long ksb,
                           long long ksh, long long kss, long long vsb,
                           long long vsh, long long vss, long long osb,
                           long long osh, long long oss, int causal,
                           int use_window, int window, float scale) {
  extern __shared__ float smem[];
  const int DS = D + kMmaPad;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kv_s = q_s + kFaBQ * DS;    // stage s: k at 2s, v at 2s+1

  const int iq = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kh = h / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q_offset = Skv - Sq;
  const int q0 = iq * kFaBQ;
  const int nq = min(kFaBQ, Sq - q0);
  const int q_lo = q_offset + q0, q_hi = q_offset + q0 + nq - 1;
  const int nkk = D / 16, nd8 = D / 8;

  const __nv_bfloat16* qb = q + b * qsb + h * qsh + (long long)q0 * qss;
  const __nv_bfloat16* kb = k + b * ksb + kh * ksh;
  const __nv_bfloat16* vb = v + b * vsb + kh * vsh;
  load_tile_async(q_s, qb, qss, nq, D, DS, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int wr = warp * 16;                  // this warp's first row
  uint32_t qf[kFaMaxD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kFaMaxD / 16; ++kk) {
    if (kk < nkk) {
      const __nv_bfloat16* base = q_s + (wr + g) * DS + kk * 16 + t4 * 2;
      qf[kk][0] = ld32(base);
      qf[kk][1] = ld32(base + 8 * DS);
      qf[kk][2] = ld32(base + 8);
      qf[kk][3] = ld32(base + 8 * DS + 8);
    }
  }
  float oacc[kFaMaxD / 8][4];
#pragma unroll
  for (int t = 0; t < kFaMaxD / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[t][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const int qpos0 = q_lo + wr + g;           // rows g and g + 8

  const int nk = (Skv + kFaBK - 1) / kFaBK;
  int kt_hi = nk - 1;
  if (causal) kt_hi = min(kt_hi, q_hi / kFaBK);
  int kt_lo = 0;
  if (use_window) {
    const int lo_key = q_lo - window + 1;
    kt_lo = lo_key > 0 ? lo_key / kFaBK : 0;
  }

  auto prefetch = [&](int kt, int stage) {
    const int k0 = kt * kFaBK;
    const int n = min(kFaBK, Skv - k0);
    __nv_bfloat16* ks = kv_s + (2 * stage) * kFaBK * DS;
    load_tile_async(ks, kb + (long long)k0 * kss, kss, n, D, DS, tid);
    load_tile_async(ks + kFaBK * DS, vb + (long long)k0 * vss, vss, n, D, DS,
                    tid);
  };
  prefetch(kt_lo, 0);
  cp_async_commit();
  int stage = 0;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kFaBK;
    const int nkv = min(kFaBK, Skv - k0);
    if (kt < kt_hi) prefetch(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                      // this tile has landed
    __syncthreads();
    const __nv_bfloat16* k_s = kv_s + (2 * stage) * kFaBK * DS;
    const __nv_bfloat16* v_s = k_s + kFaBK * DS;

    // S = Q K^T for this warp's 16 rows x 64 keys (8 tiles of 8 keys)
    float sacc[kFaBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kFaBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kFaMaxD / 16; ++kk) {
      if (kk < nkk) {
#pragma unroll
        for (int nt = 0; nt < kFaBK / 8; ++nt) {
          const __nv_bfloat16* kp = k_s + (nt * 8 + g) * DS + kk * 16 + t4 * 2;
          mma_16816(sacc[nt], qf[kk], ld32(kp), ld32(kp + 8));
        }
      }
    }

    // scale, mask, online softmax; rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kFaBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + nt * 8 + t4 * 2 + (e & 1);
        const int qpos = qpos0 + 8 * (e >> 1);
        float sv = sacc[nt][e] * scale;
        if (kpos - k0 >= nkv) {
          sv = -__uint_as_float(0x7f800000u);   // past Skv: p = 0
        } else {
          bool ok = true;
          if (causal) ok = ok && kpos <= qpos;
          if (use_window) ok = ok && kpos > qpos - window;
          if (!ok) sv = kNegInf;
        }
        sacc[nt][e] = sv;
        mx[e >> 1] = fmaxf(mx[e >> 1], sv);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m_r[rr], mx[rr]);
      corr[rr] = expf(m_r[rr] - m_new);
      m_r[rr] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kFaBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(sacc[nt][e] - m_r[e >> 1]);
        sacc[nt][e] = pe;
        sum[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 1);
      sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 2);
      l_r[rr] = l_r[rr] * corr[rr] + sum[rr];
    }
#pragma unroll
    for (int t = 0; t < kFaMaxD / 8; ++t) {
      oacc[t][0] *= corr[0];
      oacc[t][1] *= corr[0];
      oacc[t][2] *= corr[1];
      oacc[t][3] *= corr[1];
    }

    // acc += P V: P (a bf16 high part and remainder) from the score
    // accumulators, V's fragments transposed out of its row-major tile
#pragma unroll
    for (int kk = 0; kk < kFaBK / 16; ++kk) {
      uint32_t pa[4], pr[4];
      split_bf16(sacc[2 * kk][0], sacc[2 * kk][1], pa[0], pr[0]);
      split_bf16(sacc[2 * kk][2], sacc[2 * kk][3], pa[1], pr[1]);
      split_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1], pa[2], pr[2]);
      split_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3], pa[3], pr[3]);
      const __nv_bfloat16* vrow = v_s + (kk * 16 + (lane & 15)) * DS;
#pragma unroll
      for (int t = 0; t < kFaMaxD / 8; ++t) {
        if (t < nd8) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, vrow + t * 8);
          mma_16816(oacc[t], pa, b0, b1);
          mma_16816(oacc[t], pr, b0, b1);
        }
      }
    }
    __syncthreads();   // all warps are done with this stage before reuse
    stage ^= 1;
  }

  __nv_bfloat16* ob = o + b * osb + h * osh + (long long)q0 * oss;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = wr + g + 8 * rr;
    if (r >= nq) continue;
    const float inv_l = 1.f / fmaxf(l_r[rr], 1e-30f);
#pragma unroll
    for (int t = 0; t < kFaMaxD / 8; ++t) {
      if (t < nd8)
        *reinterpret_cast<uint32_t*>(ob + r * oss + t * 8 + t4 * 2) =
            pack_bf16(oacc[t][2 * rr] * inv_l, oacc[t][2 * rr + 1] * inv_l);
    }
  }
}

// ------------------------------------------------------------ ssd scan
constexpr int kSsdThreads = 256;
constexpr int kSsdT = 64;              // rows of a tile inside a chunk
constexpr int kSsdMaxP = 128;
constexpr int kSsdMaxN = 128;
constexpr int kSsdPCols = kSsdMaxP / 16;
constexpr int kSsdHRegs = kSsdMaxP * kSsdMaxN / kSsdThreads;

// Shared memory: acum_s[Q] (doubles), then floats h_s[P][N+1],
// c_s[T][N+1], b_s[T][N+1], x_s[T][P], s_s[T][T+1].
template <typename TBC>
__global__ void __launch_bounds__(kSsdThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const TBC* __restrict__ bm, const TBC* __restrict__ cm,
                float* __restrict__ y, float* __restrict__ h_out, int S,
                int H, int HG, int P, int N, int Q, long long xsb,
                long long xss, long long xsh, long long asb, long long ass,
                long long ash, long long bsb, long long bss, long long bsg,
                long long csb, long long css, long long csg) {
  extern __shared__ float smem[];
  const int NP = N + 1;
  double* acum_s = reinterpret_cast<double*>(smem);
  float* h_s = smem + 2 * Q;
  float* c_s = h_s + P * NP;
  float* b_s = c_s + kSsdT * NP;
  float* x_s = b_s + kSsdT * NP;
  float* s_s = x_s + kSsdT * P;

  const int bidx = blockIdx.x / H, hh = blockIdx.x % H, g = hh / HG;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;     // 16 x 16 thread grid
  const float* xb = x + bidx * xsb + hh * xsh;
  const float* ab = a + bidx * asb + hh * ash;
  const TBC* bb = bm + bidx * bsb + g * bsg;
  const TBC* cb = cm + bidx * csb + g * csg;
  float* yb = y + ((long long)bidx * S * H + hh) * P;   // [B,S,H,P]
  const int PN = P * N;

  for (int i = tid; i < P * NP; i += kSsdThreads) h_s[i] = 0.f;
  const int ntile = (Q + kSsdT - 1) / kSsdT;

  for (int c0 = 0; c0 < S; c0 += Q) {
    // a_cum of this chunk in float64: warp 0, a run of consecutive steps
    // per lane, then a scan of the lanes' totals
    __syncthreads();
    if (warp == 0) {
      const int per = (Q + 31) / 32;
      const int lo = lane * per, hi = min(lo + per, Q);
      double run = 0.0;
      for (int t = lo; t < hi; ++t) {
        run += (double)ab[(long long)(c0 + t) * ass];
        acum_s[t] = run;
      }
      double incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      const double off = incl - run;
      for (int t = lo; t < hi; ++t) acum_s[t] += off;
    }
    __syncthreads();

    for (int it = 0; it < ntile; ++it) {
      const int i0 = it * kSsdT;
      const int ni = min(kSsdT, Q - i0);
      __syncthreads();
      for (int e = tid; e < kSsdT * N; e += kSsdThreads) {
        const int r = e / N, n = e - r * N;
        c_s[r * NP + n] =
            r < ni ? to_f32(cb[(long long)(c0 + i0 + r) * css + n]) : 0.f;
      }
      __syncthreads();

      // y_i = exp(a_cum_i) * (C_i h^T): rows ty + 16 ii, columns tx + 16 jj
      float yacc[4][kSsdPCols];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int r = ty + 16 * ii;
        const float w = r < ni ? expf((float)acum_s[i0 + r]) : 0.f;
#pragma unroll
        for (int jj = 0; jj < kSsdPCols; ++jj) {
          const int p = tx + 16 * jj;
          float t = 0.f;
          if (p < P)
            for (int n = 0; n < N; ++n) t += c_s[r * NP + n] * h_s[p * NP + n];
          yacc[ii][jj] = t * w;
        }
      }

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kSsdT;
        const int nj = min(kSsdT, Q - j0);
        __syncthreads();
        for (int e = tid; e < kSsdT * N; e += kSsdThreads) {
          const int r = e / N, n = e - r * N;
          b_s[r * NP + n] =
              r < nj ? to_f32(bb[(long long)(c0 + j0 + r) * bss + n]) : 0.f;
        }
        for (int e = tid; e < kSsdT * P; e += kSsdThreads) {
          const int r = e / P, p = e - r * P;
          x_s[e] = r < nj ? xb[(long long)(c0 + j0 + r) * xss + p] : 0.f;
        }
        __syncthreads();
        // scores (C_i B_j^T) o L: rows ty + 16 ii, keys tx + 16 jj
        float s[4][4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cr[4], br[4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) cr[ii] = c_s[(ty + 16 * ii) * NP + n];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) br[jj] = b_s[(tx + 16 * jj) * NP + n];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) s[ii][jj] += cr[ii] * br[jj];
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int r = ty + 16 * ii, gi = i0 + r;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int cidx = tx + 16 * jj, gj = j0 + cidx;
            const bool ok = gi >= gj && r < ni && cidx < nj;
            s_s[r * (kSsdT + 1) + cidx] =
                ok ? s[ii][jj] * expf((float)(acum_s[gi] - acum_s[gj]))
                   : 0.f;
          }
        }
        __syncthreads();
        for (int cidx = 0; cidx < nj; ++cidx) {
          float sr[4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
            sr[ii] = s_s[(ty + 16 * ii) * (kSsdT + 1) + cidx];
#pragma unroll
          for (int jj = 0; jj < kSsdPCols; ++jj) {
            const int p = tx + 16 * jj;
            if (p < P) {
              const float xv = x_s[cidx * P + p];
#pragma unroll
              for (int ii = 0; ii < 4; ++ii) yacc[ii][jj] += sr[ii] * xv;
            }
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int r = ty + 16 * ii;
        if (r >= ni) continue;
        float* yr = yb + (long long)(c0 + i0 + r) * H * P;
#pragma unroll
        for (int jj = 0; jj < kSsdPCols; ++jj) {
          const int p = tx + 16 * jj;
          if (p < P) yr[p] = yacc[ii][jj];
        }
      }
    }

    // h = exp(a_cum_last) h + X^T (B o exp(a_cum_last - a_cum))
    const double a_last = acum_s[Q - 1];
    float hacc[kSsdHRegs];
#pragma unroll
    for (int k2 = 0; k2 < kSsdHRegs; ++k2) hacc[k2] = 0.f;
    for (int jt = 0; jt < ntile; ++jt) {
      const int j0 = jt * kSsdT;
      const int nj = min(kSsdT, Q - j0);
      __syncthreads();
      for (int e = tid; e < kSsdT * N; e += kSsdThreads) {
        const int r = e / N, n = e - r * N;
        b_s[r * NP + n] =
            r < nj ? to_f32(bb[(long long)(c0 + j0 + r) * bss + n]) *
                         expf((float)(a_last - acum_s[j0 + r]))
                   : 0.f;
      }
      for (int e = tid; e < kSsdT * P; e += kSsdThreads) {
        const int r = e / P, p = e - r * P;
        x_s[e] = r < nj ? xb[(long long)(c0 + j0 + r) * xss + p] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k2 = 0; k2 < kSsdHRegs; ++k2) {
        const int e = tid + k2 * kSsdThreads;
        if (e < PN) {
          const int p = e / N, n = e - p * N;
          float t = hacc[k2];
          for (int r = 0; r < nj; ++r) t += x_s[r * P + p] * b_s[r * NP + n];
          hacc[k2] = t;
        }
      }
    }
    __syncthreads();
    const float decay = expf((float)a_last);
#pragma unroll
    for (int k2 = 0; k2 < kSsdHRegs; ++k2) {
      const int e = tid + k2 * kSsdThreads;
      if (e < PN) {
        const int p = e / N, n = e - p * N;
        h_s[p * NP + n] = decay * h_s[p * NP + n] + hacc[k2];
      }
    }
  }
  __syncthreads();
  float* hb = h_out + (long long)blockIdx.x * PN;
  for (int e = tid; e < PN; e += kSsdThreads) {
    const int p = e / N, n = e - p * N;
    hb[e] = h_s[p * NP + n];
  }
}

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" {

const char* prefill_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q [B,H,Sq,D], k/v [B,K,Skv,D], o [B,H,Sq,D], each through its (batch,
// head, sequence) strides in elements; the last dimension is contiguous.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int K, int Sq, int Skv,
                           int D, long long qsb, long long qsh, long long qss,
                           long long ksb, long long ksh, long long kss,
                           long long vsb, long long vsh, long long vss,
                           long long osb, long long osh, long long oss,
                           int causal, int use_window, int window, float scale,
                           int is_bf16, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || K <= 0 || H % K != 0 || D <= 0 ||
      D > kFaMaxD || Sq > Skv)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)kFaBQ * (D + 1) + (size_t)kFaBK * (D + 1) +
                       (size_t)kFaBK * D + (size_t)kFaBQ * (kFaBK + 1) +
                       3 * (size_t)kFaBQ);
  const dim3 grid((unsigned)((Sq + kFaBQ - 1) / kFaBQ), (unsigned)(B * H));
  const int G = H / K;
  cudaError_t e;
  // the tensor-core kernel copies 16-byte row pieces: it needs D % 16 == 0,
  // strides that are multiples of 8 elements and 16-byte aligned bases
  const long long strides = qsb | qsh | qss | ksb | ksh | kss | vsb | vsh |
                            vss | osb | osh | oss;
  const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                          (uintptr_t)o;
  if (is_bf16 && D % 16 == 0 && (strides & 7) == 0 && (bases & 15) == 0) {
    const size_t smem_mma = sizeof(__nv_bfloat16) *
                            (size_t)(kFaBQ + 4 * kFaBK) * (D + kMmaPad);
    auto kern = flash_attention_mma_kernel;
    if ((e = set_smem(kern, smem_mma)) != cudaSuccess) return (int)e;
    kern<<<grid, kMmaThreads, smem_mma, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)o, H, G, Sq, Skv, D, qsb,
        qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, causal,
        use_window, window, scale);
  } else if (is_bf16) {
    auto kern = flash_attention_kernel<__nv_bfloat16>;
    if ((e = set_smem(kern, smem)) != cudaSuccess) return (int)e;
    kern<<<grid, kFaThreads, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)o, H, G, Sq, Skv, D, qsb,
        qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, causal,
        use_window, window, scale);
  } else {
    auto kern = flash_attention_kernel<float>;
    if ((e = set_smem(kern, smem)) != cudaSuccess) return (int)e;
    kern<<<grid, kFaThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, H, G,
        Sq, Skv, D, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh,
        oss, causal, use_window, window, scale);
  }
  return (int)cudaGetLastError();
}

// x [B,S,H,P] f32, a [B,S,H] f32, b/c [B,S,G,N] (bf16 or f32), each
// through its (batch, step, head-or-group) strides; y [B,S,H,P] f32 and
// h_out [B,H,P,N] f32 contiguous. S is a multiple of the chunk Q.
int ssd_scan_launch(const float* x, const float* a, const void* b,
                    const void* c, float* y, float* h_out, int B, int S,
                    int H, int G, int P, int N, int Q, long long xsb,
                    long long xss, long long xsh, long long asb,
                    long long ass, long long ash, long long bsb,
                    long long bss, long long bsg, long long csb,
                    long long css, long long csg, int is_bf16,
                    cudaStream_t stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P > kSsdMaxP ||
      N <= 0 || N > kSsdMaxN || Q <= 0 || S <= 0 || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)P * (N + 1) + 2 * (size_t)Q +
                       2 * (size_t)kSsdT * (N + 1) + (size_t)kSsdT * P +
                       (size_t)kSsdT * (kSsdT + 1));
  const dim3 grid((unsigned)(B * H));
  const int HG = H / G;
  cudaError_t e;
  if (is_bf16) {
    auto kern = ssd_scan_kernel<__nv_bfloat16>;
    if ((e = set_smem(kern, smem)) != cudaSuccess) return (int)e;
    kern<<<grid, kSsdThreads, smem, stream>>>(
        x, a, (const __nv_bfloat16*)b, (const __nv_bfloat16*)c, y, h_out, S,
        H, HG, P, N, Q, xsb, xss, xsh, asb, ass, ash, bsb, bss, bsg, csb,
        css, csg);
  } else {
    auto kern = ssd_scan_kernel<float>;
    if ((e = set_smem(kern, smem)) != cudaSuccess) return (int)e;
    kern<<<grid, kSsdThreads, smem, stream>>>(
        x, a, (const float*)b, (const float*)c, y, h_out, S, H, HG, P, N, Q,
        xsb, xss, xsh, asb, ass, ash, bsb, bss, bsg, csb, css, csg);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
