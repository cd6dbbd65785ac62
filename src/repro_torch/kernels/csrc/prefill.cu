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
// Long prefills are bound by operations (the products Q K^T and P V). Two
// kernels, by input:
//   * bf16 with a head dim that is a multiple of 16 and 16-byte strides
//     (the prefill's case): `flash_attention_wgmma_kernel`, Hopper's
//     warpgroup products fed by TMA (below);
//   * f32 inputs, and other head dims: `flash_attention_kernel`, on the
//     CUDA cores in float32, so f32 inputs keep f32 accuracy. One block of
//     128 threads per (batch, head, 64-query tile) keeps the scaled query
//     tile, one 64-key K tile and V tile and the tile's scores in shared
//     memory (float32, converted on load from bf16 or f32) and (m, l, acc)
//     in float32: acc in registers, 4 rows x D/8 columns a thread.
// Both walk only the key tiles inside the band, as the TPU kernel's
// `visible` check does; masked scores inside a visible tile take the
// reference's finite NEG_INF = -1e30, so a row wholly masked in one tile
// gets p = exp(0) = 1 there and the first real key erases it through
// corr = exp(-1e30 - m) = 0 (with -inf that step would be NaN). Keys past
// Skv get p = 0. The KV head is h / (H / K): no expansion. Any Sq <= Skv
// and any head dim up to 128; strided [B, H, S, D] views (last dimension
// contiguous) are read in place.
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

#include <cuda.h>
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

// bf16 flash attention on Hopper's tensor cores: `wgmma` fed by TMA, for a
// head dim D that is a multiple of 16 (up to 128), strides that are
// multiples of 8 elements and 16-byte aligned bases. One block of 384
// threads per (batch, head, 128-query tile): two consumer warpgroups of 64
// query rows each, and a producer warpgroup that hands most of its registers
// to them (`setmaxnreg`) and whose first thread starts the TMA loads of the
// block's Q tile and of each 128-key K and V tile into a ring of two stages,
// with a full barrier per tile (K and V apart, so Q K^T can start before V
// lands) and an empty barrier per stage that all 256 consumer threads arrive
// on. Tiles sit in shared memory in the 128-byte swizzle, as boxes of 64
// head-dim columns (128 bytes) by 128 rows; a head dim above 64 takes a
// second box, whose columns past D the TMA zero-fills (as it does rows past
// Sq or Skv), so zamba2's D = 112 runs Q K^T over 7 k-steps and P V at N =
// 112. S = Q K^T is `wgmma` m64n128k16 with Q and K from shared memory, both
// K-major. P stays in registers: the S accumulator's layout is the A
// operand's (two column blocks of 8 make one k-step of 16). V is [keys][D],
// MN-major for the B operand, read through the transpose bit. The TPU kernel
// takes P V in float32 (v widened), so p goes in as a bf16 high part and the
// bf16 of its remainder, two `wgmma`s into one float32 accumulator (p to
// about 2^-17; bf16 v times a bf16 part is exact in float32). The softmax
// works in the log2 domain: on a tile that no causal diagonal, window edge
// or Skv end crosses (for this warpgroup's rows) p = exp2(s * scale *
// log2(e) - m) is one FMA and an exp2; only the other tiles build the mask,
// with the reference's finite NEG_INF for masked keys (a row wholly masked
// so far gets p = 1, which the first real key erases through corr = 0) and
// -inf past Skv. The two warpgroups take turns on the tensor cores (named
// barriers), so one's softmax runs under the other's products. The query
// tiles run heaviest first: the grid's y index walks them from the end, so
// the longest causal rows are not left for a tail.
constexpr int kFwBM = 128;             // query rows per block
constexpr int kFwBN = 128;             // keys per tile
constexpr int kFwBox = 64;             // head-dim columns per TMA box
constexpr int kFwStages = 2;
constexpr int kFwConsumers = 256;      // two warpgroups
constexpr int kFwThreads = kFwConsumers + 128;   // + a producer warpgroup
constexpr uint32_t kFwBoxBytes = 128 * kFwBox * 2;   // 128 rows x 128 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// box (c0, c1, c2, c3) of a 4-d tensor map into shared memory; completion
// counts its bytes on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled tile: start address, leading and
// stride byte offsets (16-byte units), layout 1 = 128-byte swizzle. The
// swizzle repeats every 8 rows of 128 bytes (1,024 bytes, the stride byte
// offset); K-major operands step 16 columns (32 bytes) inside the row.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}
// named barriers (id 0 is __syncthreads'): sync waits for n threads,
// counting those that arrive without waiting
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FW_D8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64] (+)= A[64 x 16] B[16 x 128]: A and B from shared memory, both
// K-major; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FW_D8(0), FW_D8(8), FW_D8(16), FW_D8(24), FW_D8(32), FW_D8(40),
        FW_D8(48), FW_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FW_D8(0), FW_D8(8), FW_D8(16), FW_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n112(float (&d)[56],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : FW_D8(0), FW_D8(8), FW_D8(16), FW_D8(24), FW_D8(32), FW_D8(40),
        FW_D8(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FW_D8(0), FW_D8(8), FW_D8(16), FW_D8(24), FW_D8(32), FW_D8(40),
        FW_D8(48), FW_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[DP/2] += P[64 x 16] V[16 x DP], V MN-major from shared memory
template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&d)[DP / 2],
                                        const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (DP == 112) wgmma_rs_n112(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// Shared memory, from a 1,024-byte aligned base: Q (NB boxes), the K ring
// (stages x NB boxes), the V ring, then the barriers. DP is the width of
// P V: 64 (D <= 64), 112 or 128.
template <int DP>
__global__ void __launch_bounds__(kFwThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, int H, int G,
                             int Sq, int Skv, int D, long long osb,
                             long long osh, long long oss, int causal,
                             int use_window, int window, float scale_log2,
                             int mask_all) {
  constexpr int NB = (DP + kFwBox - 1) / kFwBox;
  extern __shared__ uint8_t fw_raw[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(fw_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* k_s = q_s + NB * kFwBoxBytes;
  uint8_t* v_s = k_s + kFwStages * NB * kFwBoxBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      v_s + kFwStages * NB * kFwBoxBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kFwStages;
  uint64_t* kv_empty = v_full + kFwStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kh = h / G;
  const int iq = gridDim.y - 1 - blockIdx.y;     // heaviest tiles first
  const int q0 = iq * kFwBM;
  const int q_offset = Skv - Sq;
  const int nq = min(kFwBM, Sq - q0);
  const int q_lo = q_offset + q0, q_hi = q_lo + nq - 1;
  // key tiles inside the band of this block's rows
  const int nk = (Skv + kFwBN - 1) / kFwBN;
  int kt_hi = nk - 1;
  if (causal) kt_hi = min(kt_hi, q_hi / kFwBN);
  int kt_lo = 0;
  if (use_window) {
    const int lo_key = q_lo - window + 1;
    kt_lo = lo_key > 0 ? lo_key / kFwBN : 0;
  }
  const int n_tiles = kt_hi - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], kFwConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= kFwConsumers / 32) {
    // ---- producer warpgroup: hands its registers to the consumers; one
    // thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kFwConsumers) {
      mbar_expect_tx(q_full, NB * kFwBoxBytes);
      for (int x = 0; x < NB; ++x)
        tma_load_4d(q_s + x * kFwBoxBytes, &tq, q_full, x * kFwBox, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kFwStages;
        mbar_wait(&kv_empty[s], ((it / kFwStages) & 1) ^ 1);
        const int k0 = (kt_lo + it) * kFwBN;
        mbar_expect_tx(&k_full[s], NB * kFwBoxBytes);
        for (int x = 0; x < NB; ++x)
          tma_load_4d(k_s + (s * NB + x) * kFwBoxBytes, &tk, &k_full[s],
                      x * kFwBox, k0, kh, b);
        mbar_expect_tx(&v_full[s], NB * kFwBoxBytes);
        for (int x = 0; x < NB; ++x)
          tma_load_4d(v_s + (s * NB + x) * kFwBoxBytes, &tv, &v_full[s],
                      x * kFwBox, k0, kh, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    // ---- consumers: warpgroup wg owns block rows [64 wg, 64 wg + 64); this
    // thread rows r0 and r0 + 8, key columns 8 j + 2 t4 + {0, 1} of a tile
    const int wg = warp >> 2;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = wg * 64 + (warp & 3) * 16 + g;
    const int qpos0 = q_lo + r0;
    const int wq_lo = q_lo + wg * 64, wq_hi = wq_lo + 63;
    const int nks = D / 16;
    float oacc[DP / 2], sacc[kFwBN / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kFwBN / 2; ++i) sacc[i] = 0.f;
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
    const uint8_t* q_wg = q_s + wg * 64 * 128;

    // S = Q K^T of tile j into sacc, started and not waited for
    auto start_qk = [&](int j) {
      const int sj = j % kFwStages;
      mbar_wait(&k_full[sj], (j / kFwStages) & 1);
      const uint8_t* kt = k_s + sj * NB * kFwBoxBytes;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        if (kk < nks) {
          const int off = (kk / 4) * kFwBoxBytes + (kk % 4) * 32;
          wgmma_ss_n128(sacc, sw128_desc(q_wg + off, 16, 1024),
                        sw128_desc(kt + off, 16, 1024), kk > 0);
        }
      }
    };
    // The two warpgroups take turns issuing their products: warpgroup wg
    // waits on named barrier 1 + wg for the other's arrival, starts P V of
    // tile it and Q K^T of tile it + 1 back to back, and lets the other go
    // (2 - wg) before it waits for them. One's softmax then runs while the
    // other's products hold the tensor cores. Warpgroup 0 goes first.
    mbar_wait(q_full, 0);
    if (wg == 1) named_bar_arrive(1, kFwConsumers);
    named_bar_sync(1 + wg, kFwConsumers);
    fence_regs(sacc);
    wgmma_fence();
    start_qk(0);
    wgmma_commit();
    named_bar_arrive(2 - wg, kFwConsumers);
    wgmma_wait_all();
    fence_regs(sacc);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kFwStages;
      const unsigned parity = (it / kFwStages) & 1;
      const int k0 = (kt_lo + it) * kFwBN;
      const uint8_t* vt = v_s + s * NB * kFwBoxBytes;

      // online softmax in the log2 domain; rows r0 (e = 0, 1) and r0 + 8
      const bool edge = mask_all || (causal && k0 + kFwBN - 1 > wq_lo) ||
                        (use_window && k0 <= wq_hi - window) ||
                        k0 + kFwBN > Skv;
      const float neg_inf = -__uint_as_float(0x7f800000u);
      float mx[2] = {neg_inf, neg_inf};
      if (edge) {
#pragma unroll
        for (int j = 0; j < kFwBN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
            const int qpos = qpos0 + 8 * (e >> 1);
            float t = sacc[4 * j + e] * scale_log2;
            if (kpos >= Skv)
              t = neg_inf;                            // past Skv: p = 0
            else if ((causal && kpos > qpos) ||
                     (use_window && kpos <= qpos - window))
              t = kNegInf;
            sacc[4 * j + e] = t;
            mx[e >> 1] = fmaxf(mx[e >> 1], t);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kFwBN / 2; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
      }
      float m_new[2], corr[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        // the scaled max is the max of the scaled scores (scale > 0 here)
        m_new[rr] = fmaxf(m_r[rr], edge ? mx[rr] : mx[rr] * scale_log2);
        corr[rr] = exp2f(m_r[rr] - m_new[rr]);
        m_r[rr] = m_new[rr];
      }
      float sum[2] = {0.f, 0.f};
      if (edge) {
#pragma unroll
        for (int i = 0; i < kFwBN / 2; ++i) {
          const int rr = (i >> 1) & 1;
          sacc[i] = exp2f(sacc[i] - m_new[rr]);
          sum[rr] += sacc[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < kFwBN / 2; ++i) {
          const int rr = (i >> 1) & 1;
          sacc[i] = exp2f(fmaf(sacc[i], scale_log2, -m_new[rr]));
          sum[rr] += sacc[i];
        }
      }
      // l is this thread's share of the row sum; the four shares of a row are
      // added once, at the end
      l_r[0] = l_r[0] * corr[0] + sum[0];
      l_r[1] = l_r[1] * corr[1] + sum[1];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) oacc[i] *= corr[(i >> 1) & 1];

      // O += P V, p as a bf16 high part and its remainder. All fragments are
      // built before the products: a product reads its A registers until the
      // wait, so they must not be reused in between.
      uint32_t pa[kFwBN / 16][4], pr[kFwBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kFwBN / 16; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          split_bf16(sacc[8 * kk + 2 * x], sacc[8 * kk + 2 * x + 1], pa[kk][x],
                     pr[kk][x]);
      }
      mbar_wait(&v_full[s], parity);
      named_bar_sync(1 + wg, kFwConsumers);
      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwBN / 16; ++kk) {
        // 16 keys of 128 bytes; the next 64 head-dim columns a box further
        const uint64_t db = sw128_desc(vt + kk * 16 * 128, kFwBoxBytes, 1024);
        wgmma_pv<DP>(oacc, pa[kk], db);
        wgmma_pv<DP>(oacc, pr[kk], db);
      }
      wgmma_commit();
      if (it + 1 < n_tiles) {
        start_qk(it + 1);
        wgmma_commit();
      }
      // warpgroup 1's last turn is the last: nothing waits for its arrival
      if (wg == 0 || it + 1 < n_tiles)
        named_bar_arrive(2 - wg, kFwConsumers);
      wgmma_wait_all();
      fence_regs(oacc);
      fence_regs(sacc);
      mbar_arrive(&kv_empty[s]);
    }

    __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float l = l_r[rr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = q0 + r0 + 8 * rr;
      if (row >= Sq) continue;
      const float inv_l = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (col < D)
          *reinterpret_cast<uint32_t*>(ob + row * oss + col) =
              pack_bf16(oacc[4 * j + 2 * rr] * inv_l,
                        oacc[4 * j + 2 * rr + 1] * inv_l);
      }
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

// cuTensorMapEncodeTiled through cudaGetDriverEntryPoint(ByVersion), so
// the library needs no link to libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// 4-d tensor map of a bf16 [B, N, S, D] tensor read through its (batch,
// head, sequence) strides in elements: dims (D, S, N, B), boxes of 64
// columns x 128 rows in the 128-byte swizzle, zeros outside. A dim of size
// 1 is never stepped, so its stride is replaced by a valid one.
cudaError_t tensor_map_bhsd(CUtensorMap* map, const void* base, int B, int N,
                            int S, int D, long long sb, long long sn,
                            long long ss) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const long long row = (long long)D * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)N,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {
      (cuuint64_t)(S > 1 ? ss * 2 : (row + 15) / 16 * 16),
      (cuuint64_t)(N > 1 ? sn * 2 : 16),
      (cuuint64_t)(B > 1 ? sb * 2 : 16)};
  const cuuint32_t box[4] = {kFwBox, kFwBM, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DP>
cudaError_t launch_fw(dim3 grid, cudaStream_t stream, const CUtensorMap& tq,
                      const CUtensorMap& tk, const CUtensorMap& tv, void* o,
                      int H, int G, int Sq, int Skv, int D, long long osb,
                      long long osh, long long oss, int causal,
                      int use_window, int window, float scale_log2,
                      int mask_all) {
  constexpr int NB = (DP + kFwBox - 1) / kFwBox;
  const size_t smem = 1024 + (size_t)NB * kFwBoxBytes * (1 + 2 * kFwStages) +
                      sizeof(uint64_t) * (1 + 3 * kFwStages);
  auto kern = flash_attention_wgmma_kernel<DP>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kFwThreads, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, H, G, Sq, Skv, D, osb, osh, oss, causal,
      use_window, window, scale_log2, mask_all);
  return cudaGetLastError();
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
  // the wgmma kernel loads through TMA: D % 16 == 0, strides that are
  // multiples of 8 elements (16 bytes) and 16-byte aligned bases
  const long long strides = qsb | qsh | qss | ksb | ksh | kss | vsb | vsh |
                            vss | osb | osh | oss;
  const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                          (uintptr_t)o;
  if (is_bf16 && D % 16 == 0 && (strides & 7) == 0 && (bases & 15) == 0) {
    CUtensorMap tq, tk, tv;
    if ((e = tensor_map_bhsd(&tq, q, B, H, Sq, D, qsb, qsh, qss)) !=
            cudaSuccess ||
        (e = tensor_map_bhsd(&tk, k, B, K, Skv, D, ksb, ksh, kss)) !=
            cudaSuccess ||
        (e = tensor_map_bhsd(&tv, v, B, K, Skv, D, vsb, vsh, vss)) !=
            cudaSuccess)
      return (int)e;
    const dim3 fgrid((unsigned)(B * H), (unsigned)((Sq + kFwBM - 1) / kFwBM));
    const float scale_log2 = scale * 1.4426950408889634f;
    const int mask_all = !(scale > 0.f);
    if (D <= 64)
      e = launch_fw<64>(fgrid, stream, tq, tk, tv, o, H, G, Sq, Skv, D, osb,
                        osh, oss, causal, use_window, window, scale_log2,
                        mask_all);
    else if (D == 112)
      e = launch_fw<112>(fgrid, stream, tq, tk, tv, o, H, G, Sq, Skv, D, osb,
                         osh, oss, causal, use_window, window, scale_log2,
                         mask_all);
    else
      e = launch_fw<128>(fgrid, stream, tq, tk, tv, o, H, G, Sq, Skv, D, osb,
                         osh, oss, causal, use_window, window, scale_log2,
                         mask_all);
    if (e != cudaSuccess) return (int)e;
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
