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
// kernels, by input, both on Hopper's warpgroup products (`wgmma`):
//   * bf16 with any head dim up to 128, strides that are multiples of 8
//     elements and 16-byte aligned bases (the prefill's case):
//     `flash_attention_wgmma_kernel`, bf16 products fed by TMA (below);
//   * f32 inputs, and bf16 whose strides or bases TMA cannot take:
//     `flash_attention_tf32x3_kernel`, TF32 products with every float32
//     operand split in a TF32 high part and the TF32 of its remainder, three
//     products per product (3xTF32), so f32 inputs keep f32 accuracy. Its
//     tiles are staged by a producer warpgroup through their strides (split,
//     and V transposed, as TF32 products take K-major operands only) for a
//     consumer warpgroup of 64 query rows (below).
// Both walk only the key tiles inside the band, as the TPU kernel's
// `visible` check does; masked scores inside a visible tile take the
// reference's finite NEG_INF = -1e30, so a row wholly masked in one tile
// gets p = exp(0) = 1 there and the first real key erases it through
// corr = exp(-1e30 - m) = 0 (with -inf that step would be NaN). Keys past
// Skv get p = 0. The KV head is h / (H / K): no expansion. Any Sq <= Skv
// (Sq > Skv for full attention) and any head dim up to 128; strided
// [B, H, S, D] views (last dimension contiguous) are read in place.
//
// ssd_scan: the Mamba2 SSD chunked scan. The TPU kernel carries each
// (batch, head)'s state h [P, N] from chunk to chunk in order; on this
// card that chain left SMs idle and stalled on latency, so the scan is
// split as Mamba2's chunk-parallel form splits it, three launches behind
// one call:
//   1. chunk states (ssd_chunk_state_kernel), a block per (batch, head,
//      chunk, 64 x 64 block of [N, P]): a_cum of the chunk in float64
//      (into scratch, for launches 2 and 3; its last entry is the chunk's
//      total A_c) and s_c = (B o exp(a_cum_last - a_cum))^T X, into
//      scratch;
//   2. state pass (ssd_state_pass_kernel), a thread per (batch, head, n,
//      p), sequential over chunks: h_in[c] = h, h = exp(A_c) h + s_c
//      (h_in overwrites s_c in the scratch), then the final h. The plain
//      version rounds exp of a sum of chunk totals once per chunk pair;
//      this pass multiplies one chunk's decay at a time, within about nc
//      ulps (~1e-5 relative at 128 chunks);
//   3. chunk outputs (ssd_chunk_out_kernel), a block per (batch, head,
//      chunk, 64-row tile i, 64 columns of P), the heaviest tiles (largest
//      i) first: y_i = exp(a_cum_i) (C_i h_in^T) + sum over key tiles
//      j <= i of ((C_i B_j^T) o L_ij) X_j, y written once. L = exp(a_cum_i
//      - a_cum_j) is selected to 0 above the diagonal (never multiplied by
//      a mask: exp overflows there, and inf * 0 is NaN).
// a_cum and its differences are kept in float64 and rounded once before
// exp: in float32, a_cum_i - a_cum_j cancels to about one ulp of |a_cum|
// (1.2e-4 at a chunk's -1,600 under strong decays), and two float32 sums
// taken in different orders then disagree by ~1e-3 in y. B, C and X tiles
// are staged in shared memory with 16-byte cp.async, B and X double-
// buffered (bf16 B and C converted to float32 in shared memory once per
// tile); the products are register-tiled float32 on the CUDA cores, 4 x 4
// outputs a thread. B and C come per group ([B, S, G, N], head h reads
// group h / (H / G)) and x, a, b, c are read through their strides, so the
// caller neither repeats groups nor transposes (rows that are not 16-byte
// aligned are staged with element loads). Bound by operations (about
// Q^2 (N + P) + 4 Q P N flops per chunk and head).
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

// ------------------------------------------------------ flash attention
constexpr int kFaMaxD = 128;

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

// bf16 flash attention on Hopper's tensor cores: `wgmma` fed by TMA, for any
// head dim D up to 128, strides that are multiples of 8 elements and
// 16-byte aligned bases. One block of 384
// threads per (batch, head, 128-query tile): two consumer warpgroups of 64
// query rows each, and a producer warpgroup that hands most of its registers
// to them (`setmaxnreg`) and whose first thread starts the TMA loads of the
// block's Q tile and of each 128-key K and V tile into a ring of two stages,
// with a full barrier per tile (K and V apart, so Q K^T can start before V
// lands) and an empty barrier per stage that all 256 consumer threads arrive
// on. Tiles sit in shared memory in the 128-byte swizzle, as boxes of 64
// head-dim columns (128 bytes) by 128 rows; a head dim above 64 takes a
// second box, and the TMA zero-fills every column past D (as it does rows
// past Sq or Skv). Q K^T runs ceil(D / 16) k-steps: a last k-step that
// reaches past D reads zeros in both Q and K and adds exactly 0 to every
// score, as the TPU wrapper's padding of D to 128 lanes does. P V runs at
// N = DP, the width of the template: 64 (D <= 64), 112 (zamba2), 120
// (h2o-danube) or 128; output columns past D are not written. So zamba2's
// D = 112 runs 7 k-steps and N = 112, danube's D = 120 8 k-steps (columns
// 120-127 zero) and N = 120, and a D of 40 3 k-steps and N = 64. S = Q K^T
// is `wgmma` m64n128k16 with Q and K from shared memory, both
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

#define FW_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FW_D8(i) FW_D4(i), FW_D4(i + 4)

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

__device__ __forceinline__ void wgmma_rs_n120(float (&d)[60],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59"
      "}, {%60, %61, %62, %63}, %64, p, 1, 1, 1;\n}\n"
      : FW_D8(0), FW_D8(8), FW_D8(16), FW_D8(24), FW_D8(32), FW_D8(40),
        FW_D8(48), FW_D4(56)
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
  else if constexpr (DP == 120) wgmma_rs_n120(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// Shared memory, from a 1,024-byte aligned base: Q (NB boxes), the K ring
// (stages x NB boxes), the V ring, then the barriers. DP is the width of
// P V: 64 (D <= 64), 112 (D <= 112), 120 (D <= 120) or 128.
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
    const int nks = (D + 15) / 16;    // k-steps of Q K^T; past D, zeros
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
      for (int kk = 0; kk < (DP + 15) / 16; ++kk) {
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
        __nv_bfloat16* dst = ob + row * oss + col;
        if (col + 1 < D)
          *reinterpret_cast<uint32_t*>(dst) =
              pack_bf16(oacc[4 * j + 2 * rr] * inv_l,
                        oacc[4 * j + 2 * rr + 1] * inv_l);
        else if (col < D)              // an odd D's last column
          *dst = __float2bfloat16(oacc[4 * j + 2 * rr] * inv_l);
      }
    }
  }
}

// float32 flash attention on Hopper's tensor cores, 3xTF32. Replaces the
// TPU kernel's float32 path (repro/kernels/flash_attention/kernel.py
// flash_attention_tpu) for f32 inputs and for bf16 views the TMA refuses.
// Bound by operations: the products Q K^T and P V, here three TF32
// products each at 495 TFLOP/s (against 67 TFLOP/s of float32 on the CUDA
// cores).
//
// Products. Every float32 operand is split as x = hi + lo, hi = TF32(x),
// lo = TF32(x - hi) (TF32 rounding to nearest, ties away, as cvt.rna rounds
// finite x, done with two integer operations), and a b ~ lo_a hi_b +
// hi_a lo_b + hi_a hi_b (CUTLASS's OpMultiplyAddFastF32 split), the small
// terms issued first: `wgmma` m64nNk8 TF32 products into float32
// accumulators. The dropped lo_a lo_b is ~2^-22 of a b (one TF32 product
// keeps ~2^-11 and misses the 2e-5 tolerance). Both products are split:
// S = (scale Q) K^T, and P V with p split as well (the TPU kernel takes
// P V in float32). bf16 inputs are exact in TF32: their lo parts are 0, so
// Q K^T is one product and P V two (p's split is kept), and q is not
// pre-scaled (the scale goes onto the scores) so that it stays exact.
//
// Accumulation. The tensor cores truncate as they add into an accumulator,
// ~2^-23 of its size at every product, and the loss is one-signed: O
// carried across all tiles in one accumulator read 1.6e-4 from the plain
// version at v x 64 over 1,600 keys (tolerance 2e-5 + 2e-5 |o|). So P V of
// each tile goes into a fresh accumulator that is added to O in float32
// (o = o corr + pv, one FMA per element), and Q K^T into two accumulators
// (k-step kk into kk % 2) added in float32. The softmax takes p =
// exp(s - m) on the scores as the reference scales them: in the log2 domain
// the rounding of s log2(e) alone costs ~1 ulp of |s| in every p.
//
// Layout. TF32 `wgmma` takes K-major operands only (no transpose bit for
// 32-bit types), so every tile is written to shared memory by threads
// rather than copied by the TMA: Q and K as [rows][D] (D is the
// contraction), V transposed as V^T [D][keys], all in the 128-byte swizzle
// (boxes of 32 floats by the tile's rows) that the descriptors name. P
// comes from registers as operand A: the S accumulator gives this thread
// keys 2 t4 and 2 t4 + 1 of each 8-key column block, where TF32's A fragment
// holds columns t4 and t4 + 4 (PTX ISA, wgmma .m64nNk8 fragments; CUTLASS's
// ALayout_64x8). Instead of shuffling p, V^T's keys are stored permuted in
// each group of 8: key kappa at position (kappa & 1) * 4 + (kappa >> 1), so
// that position c holds key 2 c (c < 4) or 2 (c - 4) + 1 and the S
// registers feed A as they are.
//
// Blocks. One block of 256 threads per (batch, head, 64-query tile): a
// consumer warpgroup (the 64 rows: products, online softmax) and a producer
// warpgroup that loads each 64-key K and V tile through its strides (16-byte
// loads for aligned f32, 8-byte for aligned bf16, element loads otherwise;
// zeros past D and Skv), splits it, transposes V and writes hi and lo to
// shared memory, with the next tile's loads in flight in its registers
// while it waits. K and V have one buffer each, handed over through named
// barriers (full and empty per buffer), so K of tile j + 1 is written under
// the softmax and P V of tile j, and V of tile j + 1 under Q K^T of tile
// j + 1. Budget at D = 128: Q hi + lo 64 KiB, K hi + lo 64 KiB, V^T hi + lo
// 64 KiB, 192 KiB of the 227 KiB a block may have: one stage, and one
// consumer warpgroup of 64 rows per block (a second warpgroup of rows would
// need Q at 128 KiB; 32-key tiles would halve the width of Q K^T, whose A
// operand is read from shared memory by every product). Q K^T runs
// ceil(D / 8) k-steps over columns zero-filled past D; P V runs at N = DP,
// the template width (64, 112, 120 or 128, those of the wgmma kernel) over
// V^T rows that are zero past D, and only columns < D are stored.
constexpr int kTxBM = 64;              // query rows per block
constexpr int kTxBN = 64;              // keys per tile
constexpr int kTxThreads = 256;        // consumer + producer warpgroup
constexpr int kTxBoxBytes = 64 * 128;  // 64 rows x 32 floats
constexpr int kTxSAcc = 2;             // accumulators of Q K^T
// named barriers of the K and V buffers (id 0 is __syncthreads')
constexpr int kBarKFull = 1, kBarKEmpty = 2, kBarVFull = 3, kBarVEmpty = 4;

// x rounded to TF32 (10 fraction bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds finite x, in two integer operations
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// writes made by threads become visible to the products' (async proxy)
// reads of shared memory
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// byte offset of 16-byte chunk `ch` (4 floats) of row `r` in a box of
// 128-byte rows in the 128-byte swizzle
__device__ __forceinline__ uint32_t sw128_off(int r, int ch) {
  return (uint32_t)(r * 128 + ((ch ^ (r & 7)) << 4));
}
// hi and (if `split`) lo of x, as TF32, to chunk `off` of two tiles
__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo,
                                            uint32_t off, float4 x,
                                            bool split) {
  const uint4 h = make_uint4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                             tf32_rna(x.w));
  *reinterpret_cast<uint4*>(hi + off) = h;
  if (split)
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(
        tf32_rna(x.x - __uint_as_float(h.x)),
        tf32_rna(x.y - __uint_as_float(h.y)),
        tf32_rna(x.z - __uint_as_float(h.z)),
        tf32_rna(x.w - __uint_as_float(h.w)));
}
// elements d0 .. d0 + 3 of a row of D elements (zeros past D) as float: one
// 16-byte (f32) or 8-byte (bf16) load where `vec` (row and d0 aligned, D a
// multiple of 4), element loads otherwise
__device__ __forceinline__ float4 load4(const void* row, int d0, int D,
                                        bool bf16, bool vec) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (d0 >= D) return r;
  if (bf16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(row) + d0;
    if (vec) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
      r = make_float4(__low2float(a), __high2float(a), __low2float(b),
                      __high2float(b));
    } else {
      r.x = __bfloat162float(p[0]);
      if (d0 + 1 < D) r.y = __bfloat162float(p[1]);
      if (d0 + 2 < D) r.z = __bfloat162float(p[2]);
      if (d0 + 3 < D) r.w = __bfloat162float(p[3]);
    }
  } else {
    const float* p = static_cast<const float*>(row) + d0;
    if (vec) {
      r = *reinterpret_cast<const float4*>(p);
    } else {
      r.x = p[0];
      if (d0 + 1 < D) r.y = p[1];
      if (d0 + 2 < D) r.z = p[2];
      if (d0 + 3 < D) r.w = p[3];
    }
  }
  return r;
}
__device__ __forceinline__ const void* row_at(const void* base, long long off,
                                              bool bf16) {
  return static_cast<const char*>(base) + off * (bf16 ? 2 : 4);
}

// d[32] (+)= A[64 x 8] B[8 x 64], TF32, both from shared memory, K-major
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : FW_D8(0), FW_D8(8), FW_D8(16), FW_D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[N/2] (+)= A[64 x 8] B[8 x N], TF32, A from registers, B K-major;
// scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : FW_D8(0), FW_D8(8), FW_D8(16), FW_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_rs_n112(float (&d)[56],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : FW_D8(0), FW_D8(8), FW_D8(16), FW_D8(24), FW_D8(32), FW_D8(40),
        FW_D8(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_rs_n120(float (&d)[60],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59"
      "}, {%60, %61, %62, %63}, %64, p, 1, 1;\n}\n"
      : FW_D8(0), FW_D8(8), FW_D8(16), FW_D8(24), FW_D8(32), FW_D8(40),
        FW_D8(48), FW_D4(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : FW_D8(0), FW_D8(8), FW_D8(16), FW_D8(24), FW_D8(32), FW_D8(40),
        FW_D8(48), FW_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[DP/2] (+)= P[64 x 8] V[8 x DP], TF32, V^T K-major from shared memory
template <int DP>
__device__ __forceinline__ void wgmma_tf32_pv(float (&d)[DP / 2],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  if constexpr (DP == 64) wgmma_tf32_rs_n64(d, a, db, scale_d);
  else if constexpr (DP == 112) wgmma_tf32_rs_n112(d, a, db, scale_d);
  else if constexpr (DP == 120) wgmma_tf32_rs_n120(d, a, db, scale_d);
  else wgmma_tf32_rs_n128(d, a, db, scale_d);
}

// Shared memory, from a 1,024-byte aligned base: Q hi, Q lo, K hi, K lo
// (NB boxes of 64 rows each), then V^T hi and V^T lo (two boxes of 32 keys
// by DP rows each). q, k, v and o are bf16 or f32 (`bf16`), read and
// written through their (batch, head, sequence) strides in elements;
// vecq / veck / vecv allow vector loads of that tensor's rows.
template <int DP>
__global__ void __launch_bounds__(kTxThreads, 1)
flash_attention_tf32x3_kernel(const void* __restrict__ q,
                              const void* __restrict__ k,
                              const void* __restrict__ v,
                              void* __restrict__ o, int H, int G, int Sq,
                              int Skv, int D, long long qsb, long long qsh,
                              long long qss, long long ksb, long long ksh,
                              long long kss, long long vsb, long long vsh,
                              long long vss, long long osb, long long osh,
                              long long oss, int causal, int use_window,
                              int window, float scale, int bf16, int vecq,
                              int veck, int vecv) {
  constexpr int NB = (DP + 31) / 32;
  constexpr int kVtBox = DP * 128;           // 32 keys x DP rows
  extern __shared__ uint8_t tx_raw[];
  uint8_t* qs_hi = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tx_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* qs_lo = qs_hi + NB * kTxBoxBytes;
  uint8_t* ks_hi = qs_lo + NB * kTxBoxBytes;
  uint8_t* ks_lo = ks_hi + NB * kTxBoxBytes;
  uint8_t* vs_hi = ks_lo + NB * kTxBoxBytes;
  uint8_t* vs_lo = vs_hi + 2 * kVtBox;

  const bool split = !bf16;                  // lo parts are 0 for bf16
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kh = h / G;
  const int iq = gridDim.y - 1 - blockIdx.y;     // heaviest tiles first
  const int q0 = iq * kTxBM;
  const int q_offset = Skv - Sq;
  const int nq = min(kTxBM, Sq - q0);
  const int q_lo = q_offset + q0, q_hi = q_lo + nq - 1;
  // key tiles inside the band of this block's rows
  const int nk = (Skv + kTxBN - 1) / kTxBN;
  int kt_hi = nk - 1;
  if (causal) kt_hi = min(kt_hi, q_hi / kTxBN);
  int kt_lo = 0;
  if (use_window) {
    const int lo_key = q_lo - window + 1;
    kt_lo = lo_key > 0 ? lo_key / kTxBN : 0;
  }
  const int n_tiles = kt_hi - kt_lo + 1;
  // Q K^T runs nks k-steps of 8 columns: Q and K are staged in 2 nks chunks
  // of 4 columns a row (zeros past D), in slots of 1 << sh chunks a row
  const int nks = (D + 7) / 8;
  const int nc4 = 2 * nks;
  const int sh = nc4 <= 8 ? 3 : nc4 <= 16 ? 4 : 5;
  const int n_slots = kTxBM << sh;
  // f32: q pre-scaled as the reference scales it; bf16: q kept exact and the
  // scale applied to the scores
  const float qscale = split ? scale : 1.f;
  const float sscale = split ? 1.f : scale;

  // ---- Q tile, hi and lo, by all threads
  {
    const void* qb = row_at(q, b * qsb + h * qsh + (long long)q0 * qss, bf16);
    for (int item = threadIdx.x; item < n_slots; item += kTxThreads) {
      const int r = item >> sh, c4 = item & ((1 << sh) - 1);
      if (c4 >= nc4) continue;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nq)
        x = load4(row_at(qb, (long long)r * qss, bf16), 4 * c4, D, bf16,
                  vecq);
      x.x *= qscale;
      x.y *= qscale;
      x.z *= qscale;
      x.w *= qscale;
      store_split(qs_hi, qs_lo, (c4 >> 3) * kTxBoxBytes + sw128_off(r, c4 & 7),
                  x, split);
    }
  }
  fence_proxy_async();
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warpgroup: K and V^T of each tile, hi and lo. The loads
    // of tile it + 1 are issued as soon as tile it's registers are written
    // to shared memory, so they are in flight while the producer waits for
    // the consumer to free each buffer.
    const int pt = threadIdx.x - 128;
    const void* kb = row_at(k, b * ksb + kh * ksh, bf16);
    const void* vb = row_at(v, b * vsb + kh * vsh, bf16);
    // K [keys][D]: slot pt + 128 i is (key r, chunk c4); a warp takes one
    // key row, 8 threads 8 chunks of one box (no bank conflicts)
    float4 kr[16];
    auto load_k = [&](int it) {
      const int k0 = (kt_lo + it) * kTxBN;
      const int nkv = min(kTxBN, Skv - k0);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int item = pt + 128 * i;
        const int r = item >> sh, c4 = item & ((1 << sh) - 1);
        kr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (item < n_slots && c4 < nc4 && r < nkv)
          kr[i] = load4(row_at(kb, (long long)(k0 + r) * kss, bf16), 4 * c4,
                        D, bf16, veck);
      }
    };
    // V^T [D][keys]: item pt + 128 i is (key group gk of 8, head-dim chunk
    // dc of 4); it writes 4 rows x (even keys, odd keys). Threads gk and
    // gk + 4 (other box) write the two halves in the opposite order, so the
    // 8 threads of a store hit 8 distinct 16-byte banks.
    float4 vr[2][8];
    auto load_v = [&](int it) {
      const int k0 = (kt_lo + it) * kTxBN;
      const int nkv = min(kTxBN, Skv - k0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int item = pt + 128 * i;
        const int gk = item & 7, dc = item >> 3;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int key = 8 * gk + u;
          vr[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (dc < DP / 4 && key < nkv)
            vr[i][u] = load4(row_at(vb, (long long)(k0 + key) * vss, bf16),
                             4 * dc, D, bf16, vecv);
        }
      }
    };
    load_k(0);
    load_v(0);
    for (int it = 0; it < n_tiles; ++it) {
      if (it > 0) named_bar_sync(kBarKEmpty, kTxThreads);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int item = pt + 128 * i;
        const int r = item >> sh, c4 = item & ((1 << sh) - 1);
        if (item < n_slots && c4 < nc4)
          store_split(ks_hi, ks_lo,
                      (c4 >> 3) * kTxBoxBytes + sw128_off(r, c4 & 7), kr[i],
                      split);
      }
      fence_proxy_async();
      named_bar_arrive(kBarKFull, kTxThreads);
      if (it + 1 < n_tiles) load_k(it + 1);

      if (it > 0) named_bar_sync(kBarVEmpty, kTxThreads);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int item = pt + 128 * i;
        const int gk = item & 7, dc = item >> 3;
        if (dc >= DP / 4) continue;
        const int box = gk >> 2, chb = 2 * (gk & 3);
        const bool odd_first = box == 1;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 4 * dc + e;
          float ev[4], od[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 x0 = vr[i][2 * u], x1 = vr[i][2 * u + 1];
            ev[u] = e == 0 ? x0.x : e == 1 ? x0.y : e == 2 ? x0.z : x0.w;
            od[u] = e == 0 ? x1.x : e == 1 ? x1.y : e == 2 ? x1.z : x1.w;
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const bool odd = (half == 1) != odd_first;
            const float4 x = odd ? make_float4(od[0], od[1], od[2], od[3])
                                 : make_float4(ev[0], ev[1], ev[2], ev[3]);
            store_split(vs_hi, vs_lo,
                        box * kVtBox + sw128_off(d, chb + (odd ? 1 : 0)), x,
                        split);
          }
        }
      }
      fence_proxy_async();
      named_bar_arrive(kBarVFull, kTxThreads);
      if (it + 1 < n_tiles) load_v(it + 1);
    }
  } else {
    // ---- consumer warpgroup: this thread rows r0 and r0 + 8, key columns
    // 8 j + 2 t4 + {0, 1} of a tile
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = warp * 16 + g;
    const int qpos0 = q_lo + r0;
    float oacc[DP / 2], pv[DP / 2];
    float sacc[kTxBN / 2], s_acc[kTxSAcc][kTxBN / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
    const float neg_inf = -__uint_as_float(0x7f800000u);

    for (int it = 0; it < n_tiles; ++it) {
      const int k0 = (kt_lo + it) * kTxBN;
      // S = Q K^T into kTxSAcc accumulators, k-step kk into kk % kTxSAcc
      // (the lo hi and hi lo terms of every k-step first, then the hi hi
      // terms; hi hi alone for bf16), issued back to back and added in
      // float32: each accumulator sums half the k-steps, and consecutive
      // products go to different accumulators.
      named_bar_sync(kBarKFull, kTxThreads);
#pragma unroll
      for (int a = 0; a < kTxSAcc; ++a) fence_regs(s_acc[a]);
      wgmma_fence();
      if (split) {
#pragma unroll
        for (int kk = 0; kk < 16; ++kk) {
          if (kk < nks) {
            const int off = (kk >> 2) * kTxBoxBytes + (kk & 3) * 32;
            wgmma_tf32_ss_n64(s_acc[kk % kTxSAcc],
                              sw128_desc(qs_lo + off, 16, 1024),
                              sw128_desc(ks_hi + off, 16, 1024),
                              kk >= kTxSAcc);
            wgmma_tf32_ss_n64(s_acc[kk % kTxSAcc],
                              sw128_desc(qs_hi + off, 16, 1024),
                              sw128_desc(ks_lo + off, 16, 1024), 1);
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        if (kk < nks) {
          const int off = (kk >> 2) * kTxBoxBytes + (kk & 3) * 32;
          wgmma_tf32_ss_n64(s_acc[kk % kTxSAcc],
                            sw128_desc(qs_hi + off, 16, 1024),
                            sw128_desc(ks_hi + off, 16, 1024),
                            split || kk >= kTxSAcc);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int a = 0; a < kTxSAcc; ++a) fence_regs(s_acc[a]);
      // accumulators past the nks-th were not written this tile
#pragma unroll
      for (int i = 0; i < kTxBN / 2; ++i) {
        float t = s_acc[0][i];
#pragma unroll
        for (int a = 1; a < kTxSAcc; ++a)
          if (a < nks) t += s_acc[a][i];
        sacc[i] = t;
      }
      if (it + 1 < n_tiles) named_bar_arrive(kBarKEmpty, kTxThreads);

      // online softmax as the reference takes it, p = exp(s - m) (in the log2
      // domain the rounding of s log2(e) alone would cost ~1 ulp of |s|
      // in every p); rows r0 (e = 0, 1), r0 + 8
      const bool edge = (causal && k0 + kTxBN - 1 > q_lo) ||
                        (use_window && k0 <= q_hi - window) ||
                        k0 + kTxBN > Skv;
      float mx[2] = {neg_inf, neg_inf};
#pragma unroll
      for (int j = 0; j < kTxBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float t = sacc[4 * j + e] * sscale;
          if (edge) {
            const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
            const int qpos = qpos0 + 8 * (e >> 1);
            if (kpos >= Skv)
              t = neg_inf;                            // past Skv: p = 0
            else if ((causal && kpos > qpos) ||
                     (use_window && kpos <= qpos - window))
              t = kNegInf;
          }
          sacc[4 * j + e] = t;
          mx[e >> 1] = fmaxf(mx[e >> 1], t);
        }
      }
      float m_new[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        m_new[rr] = fmaxf(m_r[rr], mx[rr]);
        corr[rr] = expf(m_r[rr] - m_new[rr]);
        m_r[rr] = m_new[rr];
      }
#pragma unroll
      for (int i = 0; i < kTxBN / 2; ++i) {
        const int rr = (i >> 1) & 1;
        sacc[i] = expf(sacc[i] - m_new[rr]);
        sum[rr] += sacc[i];
      }
      // l is this thread's share of the row sum; the four shares of a row
      // are added once, at the end
      l_r[0] = l_r[0] * corr[0] + sum[0];
      l_r[1] = l_r[1] * corr[1] + sum[1];

      // p's A fragments, hi and lo: k-step kk is the column block kk of S;
      // A's (row g, column t4) is key 2 t4, (g, t4 + 4) key 2 t4 + 1 (V^T
      // permuted to match), rows g + 8 likewise. All are built before the
      // products, which read them until the wait.
      uint32_t ph[kTxBN / 8][4], pl[kTxBN / 8][4];
#pragma unroll
      for (int kk = 0; kk < kTxBN / 8; ++kk) {
        const float pr[4] = {sacc[4 * kk], sacc[4 * kk + 2],
                             sacc[4 * kk + 1], sacc[4 * kk + 3]};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          ph[kk][x] = tf32_rna(pr[x]);
          pl[kk][x] = tf32_rna(pr[x] - __uint_as_float(ph[kk][x]));
        }
      }
      // P V of this tile into a fresh accumulator (the lo hi terms, the hi
      // lo terms (f32), then the hi hi terms), added to O in float32
      named_bar_sync(kBarVFull, kTxThreads);
      fence_regs(pv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTxBN / 8; ++kk) {
        const int off = (kk >> 2) * kVtBox + (kk & 3) * 32;
        wgmma_tf32_pv<DP>(pv, pl[kk], sw128_desc(vs_hi + off, 16, 1024),
                          kk > 0);
      }
      if (split) {
#pragma unroll
        for (int kk = 0; kk < kTxBN / 8; ++kk) {
          const int off = (kk >> 2) * kVtBox + (kk & 3) * 32;
          wgmma_tf32_pv<DP>(pv, ph[kk], sw128_desc(vs_lo + off, 16, 1024), 1);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kTxBN / 8; ++kk) {
        const int off = (kk >> 2) * kVtBox + (kk & 3) * 32;
        wgmma_tf32_pv<DP>(pv, ph[kk], sw128_desc(vs_hi + off, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(pv);
      if (it + 1 < n_tiles) named_bar_arrive(kBarVEmpty, kTxThreads);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i)
        oacc[i] = fmaf(oacc[i], corr[(i >> 1) & 1], pv[i]);
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float l = l_r[rr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = q0 + r0 + 8 * rr;
      if (row >= Sq) continue;
      const float inv_l = 1.f / fmaxf(l, 1e-30f);
      const long long base = b * osb + h * osh + (long long)row * oss;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t4 + e;
          if (col >= D) continue;
          const float val = oacc[4 * j + 2 * rr + e] * inv_l;
          if (bf16)
            static_cast<__nv_bfloat16*>(o)[base + col] = __float2bfloat16(val);
          else
            static_cast<float*>(o)[base + col] = val;
        }
      }
    }
  }
}

// ------------------------------------------------------------ ssd scan
// Three launches behind one call, each parallel over chunks:
//   1. ssd_chunk_state_kernel, block (b, h, chunk, 64 x 64 block of [N, P]):
//      A_c = a_cum_last and s_c = (B o exp(a_cum_last - a_cum))^T X;
//   2. ssd_state_pass_kernel, a thread per (b, h, n, p): h_in[c] = h,
//      h = exp(A_c) h + s_c over the chunks in order (h_in replaces s_c in
//      the scratch), then the final h;
//   3. ssd_chunk_out_kernel, block (b, h, chunk, 64-row tile i, 64 columns
//      of P), the heaviest tiles (largest i) first:
//      y_i = exp(a_cum_i) (C_i h_in^T) + sum_{j <= i} ((C_i B_j^T) o L_ij) X_j.
// The products are register-tiled on the CUDA cores in float32: 256
// threads as 16 x 16, each owning 4 x 4 outputs of a 64 x 64 block (rows
// ty + 16 ii, columns tx * 4 + jj), operands read from shared memory as
// float4 along the contraction, rows padded by 4 floats against bank
// conflicts.
constexpr int kSsThreads = 256;
constexpr int kSsT = 64;               // rows of a tile, columns of a block
constexpr int kSsP = kSsT + 4;         // padded f32 row of a 64-column tile
constexpr int kSsdMaxP = 128;
constexpr int kSsdMaxN = 128;          // C_i and B_j rows whole in shared memory

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T zero_of() {
  return T(0.f);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Stage an nrows x ncols_pad tile into shared memory (row pitch dpitch
// elements): tile row r is src + r * row_stride; rows >= valid_rows and
// columns >= ncols are zero. vec: 16-byte cp.async per chunk (needs
// 16-byte aligned rows and ncols a multiple of the chunk); else element
// loads and stores.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int dpitch, const T* src,
                                           long long row_stride, int nrows,
                                           int valid_rows, int ncols,
                                           int ncols_pad, bool vec) {
  constexpr int EPC = 16 / sizeof(T);
  if (vec) {
    const int nch = ncols_pad / EPC;
    for (int i = threadIdx.x; i < nrows * nch; i += kSsThreads) {
      const int r = i / nch, ch = i - r * nch;
      const bool ok = r < valid_rows && ch * EPC < ncols;
      cp_async16(dst + r * dpitch + ch * EPC,
                 ok ? src + r * row_stride + ch * EPC : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * ncols_pad; i += kSsThreads) {
      const int r = i / ncols_pad, cc = i - r * ncols_pad;
      dst[r * dpitch + cc] = r < valid_rows && cc < ncols
                                 ? src[r * row_stride + cc]
                                 : zero_of<T>();
    }
  }
}

// a_cum of one chunk of Q steps in float64, by warp 0: a run of
// consecutive steps per lane (loads issued eight at a time), then a scan
// of the lanes' totals. Launch 1 computes it once per chunk and keeps it
// in scratch for launches 2 and 3.
__device__ __forceinline__ void chunk_cumsum(const float* ab, long long ass,
                                             int Q, double* acum_s) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  const int per = (Q + 31) / 32;
  const int lo = lane * per, hi = min(lo + per, Q);
  double run = 0.0;
  for (int t0 = lo; t0 < hi; t0 += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = t0 + u < hi ? ab[(long long)(t0 + u) * ass] : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (t0 + u < hi) {
        run += (double)v[u];
        acum_s[t0 + u] = run;
      }
  }
  double incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  const double off = incl - run;
  for (int t = lo; t < hi; ++t) acum_s[t] += off;
}

// acc[ii][jj] += sum over the contraction k0 .. k0 + 3 of
// a[(ty + 16 ii) * ap + k] * b[k * bp + tx * 4 + jj] (a's rows float4
// along k, b's rows float4 along the output columns)
__device__ __forceinline__ void fma_rows_cols(float (&acc)[4][4],
                                              const float* a, int ap,
                                              const float* b, int bp, int k0,
                                              int ty, int tx) {
  float4 av[4], bv[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
    av[ii] = *reinterpret_cast<const float4*>(a + (ty + 16 * ii) * ap + k0);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    bv[k] = *reinterpret_cast<const float4*>(b + (k0 + k) * bp + tx * 4);
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const float a4[4] = {av[ii].x, av[ii].y, av[ii].z, av[ii].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[ii][0] = fmaf(a4[k], bv[k].x, acc[ii][0]);
      acc[ii][1] = fmaf(a4[k], bv[k].y, acc[ii][1]);
      acc[ii][2] = fmaf(a4[k], bv[k].z, acc[ii][2]);
      acc[ii][3] = fmaf(a4[k], bv[k].w, acc[ii][3]);
    }
  }
}

// Launch 1. Shared memory: x_s 2 x [64][kSsP] f32, bt_s [64][kSsP] f32
// (B o w transposed: [n][row]), braw 2 x [64][64 + EPC] raw B, acum_s[Q]
// doubles, w_s[Q] floats. The chunk's a_cum goes to scratch acum [B, H, S]
// (its last entry is A_c).
template <typename TBC>
__global__ void __launch_bounds__(kSsThreads)
ssd_chunk_state_kernel(const float* __restrict__ x, const float* __restrict__ a,
                       const TBC* __restrict__ bm, float* __restrict__ states,
                       double* __restrict__ acum, int H, int HG, int P,
                       int N, int Q, int nc, int vecx, int vecb,
                       long long xsb, long long xss, long long xsh,
                       long long asb, long long ass, long long ash,
                       long long bsb, long long bss, long long bsg) {
  constexpr int EPC = 16 / sizeof(TBC);
  constexpr int kRaw = kSsT + EPC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* x_s = reinterpret_cast<float*>(smem_raw);
  float* bt_s = x_s + 2 * kSsT * kSsP;
  TBC* braw = reinterpret_cast<TBC*>(bt_s + kSsT * kSsP);
  double* acum_s = reinterpret_cast<double*>(braw + 2 * kSsT * kRaw);
  float* w_s = reinterpret_cast<float*>(acum_s + Q);

  const int npb = (P + kSsT - 1) / kSsT, nnb = (N + kSsT - 1) / kSsT;
  long long rem = blockIdx.x;
  const int pb = (int)(rem % npb);
  rem /= npb;
  const int nb = (int)(rem % nnb);
  rem /= nnb;
  const int c = (int)(rem % nc);
  rem /= nc;
  const int hh = (int)(rem % H), bidx = (int)(rem / H), g = hh / HG;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int c0 = c * Q;
  const int pw = min(kSsT, P - pb * kSsT), nw = min(kSsT, N - nb * kSsT);
  const float* xb = x + bidx * xsb + hh * xsh + (long long)c0 * xss + pb * kSsT;
  const TBC* bb = bm + bidx * bsb + g * bsg + (long long)c0 * bss + nb * kSsT;

  chunk_cumsum(a + bidx * asb + hh * ash + (long long)c0 * ass, ass, Q,
               acum_s);
  __syncthreads();
  const double a_last = acum_s[Q - 1];
  for (int t = tid; t < Q; t += kSsThreads)
    w_s[t] = expf((float)(a_last - acum_s[t]));
  if (nb == 0 && pb == 0) {
    double* ac = acum + ((long long)bidx * H + hh) * nc * Q + c0;
    for (int t = tid; t < Q; t += kSsThreads) ac[t] = acum_s[t];
  }

  const int nrt = (Q + kSsT - 1) / kSsT;
  auto issue = [&](int rt, int st) {
    const int r0 = rt * kSsT, nr = min(kSsT, Q - r0);
    stage_tile<float>(x_s + st * kSsT * kSsP, kSsP, xb + (long long)r0 * xss,
                      xss, kSsT, nr, pw, kSsT, vecx);
    stage_tile<TBC>(braw + st * kSsT * kRaw, kRaw, bb + (long long)r0 * bss,
                    bss, kSsT, nr, nw, kSsT, vecb);
    cp_async_commit();
  };

  float acc[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.f;
  issue(0, 0);
  for (int rt = 0; rt < nrt; ++rt) {
    const int st = rt & 1;
    cp_async_wait_all();
    __syncthreads();          // tile rt landed; tile rt - 1 consumed
    if (rt + 1 < nrt) issue(rt + 1, st ^ 1);
    const int r0 = rt * kSsT;
    const TBC* br = braw + st * kSsT * kRaw;
    for (int i = tid; i < kSsT * kSsT; i += kSsThreads) {
      const int r = i & (kSsT - 1), n = i >> 6;
      const float w = r0 + r < Q ? w_s[r0 + r] : 0.f;
      bt_s[n * kSsP + r] = to_f32(br[r * kRaw + n]) * w;
    }
    __syncthreads();
    const float* xs = x_s + st * kSsT * kSsP;
    for (int k0 = 0; k0 < kSsT; k0 += 4)
      fma_rows_cols(acc, bt_s, kSsP, xs, kSsP, k0, ty, tx);
  }
  float* sb = states + (((long long)bidx * H + hh) * nc + c) * (long long)N * P;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int n = nb * kSsT + ty + 16 * ii;
    if (n >= N) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int p = tx * 4 + jj;
      if (p < pw) sb[(long long)n * P + pb * kSsT + p] = acc[ii][jj];
    }
  }
}

// Launch 2: the sequential pass over chunks, parallel over (b, h, n, p).
// states holds s_c on entry and h_in[c] on exit ([B, H, nc, N, P]);
// A_c = a_cum at the chunk's last step.
__global__ void __launch_bounds__(kSsThreads)
ssd_state_pass_kernel(float* __restrict__ states,
                      const double* __restrict__ acum,
                      float* __restrict__ h_out, int N, int P, int nc,
                      int Q) {
  const int NP = N * P;
  const int e = blockIdx.y * kSsThreads + threadIdx.x;
  const long long bh = blockIdx.x;
  if (e >= NP) return;
  float* st = states + bh * nc * NP + e;
  const double* ac = acum + bh * nc * Q + (Q - 1);
  float h = 0.f;
  int c = 0;
  for (; c + 8 <= nc; c += 8) {
    float s[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) s[u] = st[(long long)(c + u) * NP];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      st[(long long)(c + u) * NP] = h;
      h = expf((float)ac[(long long)(c + u) * Q]) * h + s[u];
    }
  }
  for (; c < nc; ++c) {
    const float s = st[(long long)c * NP];
    st[(long long)c * NP] = h;
    h = expf((float)ac[(long long)c * Q]) * h + s;
  }
  const int n = e / P, p = e - n * P;
  h_out[bh * NP + (long long)p * N + n] = h;
}

// Launch 3. Shared memory: cf_s [64][Nf] (C_i, f32), hs_s
// [max(Nr, 64)][kSsP] (h_in^T [n][p], then the tile's scores), x_s 2 x
// [64][kSsP], braw 2 x [64][Nraw] (raw B; for f32 B the operand itself),
// bf_s [64][Nf] (bf16 B converted; C's raw rows before that), acum_s[Q]
// doubles (the chunk's a_cum from launch 1's scratch). Nr = N rounded up
// to 4, Nf = Nr + 4.
template <typename TBC>
__global__ void __launch_bounds__(kSsThreads)
ssd_chunk_out_kernel(const float* __restrict__ x,
                     const double* __restrict__ acum,
                     const TBC* __restrict__ bm, const TBC* __restrict__ cm,
                     const float* __restrict__ states, float* __restrict__ y,
                     int Bn, int S, int H, int HG, int P, int N, int Q,
                     int nc, int vecx, int vecb, int vecc, int vech,
                     long long xsb, long long xss, long long xsh,
                     long long bsb, long long bss, long long bsg,
                     long long csb, long long css, long long csg) {
  constexpr bool kConv = sizeof(TBC) != sizeof(float);
  constexpr int EPC = 16 / sizeof(TBC);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Nr = (N + 3) & ~3, Nf = Nr + 4;
  const int Ne = (N + EPC - 1) / EPC * EPC;     // raw columns staged
  const int Nraw = kConv ? Ne + EPC : Nf;
  float* cf_s = reinterpret_cast<float*>(smem_raw);
  float* hs_s = cf_s + kSsT * Nf;
  float* x_s = hs_s + max(Nr, kSsT) * kSsP;
  TBC* braw = reinterpret_cast<TBC*>(x_s + 2 * kSsT * kSsP);
  float* bf_s = reinterpret_cast<float*>(braw + 2 * kSsT * Nraw);
  double* acum_s = reinterpret_cast<double*>(bf_s + (kConv ? kSsT * Nf : 0));

  // heaviest tiles first: blocks of the last row tile come first
  const int ntile = (Q + kSsT - 1) / kSsT, npb = (P + kSsT - 1) / kSsT;
  const long long per = (long long)Bn * H * nc * npb;
  const int it = ntile - 1 - (int)(blockIdx.x / per);
  long long rem = blockIdx.x % per;
  const int pb = (int)(rem % npb);
  rem /= npb;
  const int c = (int)(rem % nc);
  rem /= nc;
  const int hh = (int)(rem % H), bidx = (int)(rem / H);
  const int g = hh / HG, c0 = c * Q, i0 = it * kSsT;
  const int ni = min(kSsT, Q - i0), pw = min(kSsT, P - pb * kSsT);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* xb = x + bidx * xsb + hh * xsh + (long long)c0 * xss + pb * kSsT;
  const TBC* bb = bm + bidx * bsb + g * bsg + (long long)c0 * bss;
  const TBC* cb = cm + bidx * csb + g * csg + (long long)(c0 + i0) * css;
  const float* hb = states + (((long long)bidx * H + hh) * nc + c) *
                                 (long long)N * P + pb * kSsT;

  const double* ac = acum + ((long long)bidx * H + hh) * nc * Q + c0;
  for (int t = tid; t < min(Q, i0 + kSsT); t += kSsThreads) acum_s[t] = ac[t];
  // group 0: C_i, h_in^T, B_0, X_0
  stage_tile<TBC>(kConv ? reinterpret_cast<TBC*>(bf_s)
                        : reinterpret_cast<TBC*>(cf_s),
                  kConv ? Nraw : Nf, cb, css, kSsT, ni, N, Ne, vecc);
  stage_tile<float>(hs_s, kSsP, hb, P, Nr, N, pw, kSsT, vech);
  auto issue = [&](int jt, int st) {
    const int j0 = jt * kSsT, nj = min(kSsT, Q - j0);
    stage_tile<TBC>(braw + st * kSsT * Nraw, Nraw, bb + (long long)j0 * bss,
                    bss, kSsT, nj, N, Ne, vecb);
    stage_tile<float>(x_s + st * kSsT * kSsP, kSsP,
                      xb + (long long)j0 * xss, xss, kSsT, nj, pw, kSsT, vecx);
    cp_async_commit();
  };
  // raw bf16 rows (pitch Nraw) to float32 rows (pitch Nf), 8 at a time
  auto convert = [&](const TBC* src, float* dst) {
    const int nch = Ne / EPC;
    for (int i = tid; i < kSsT * nch; i += kSsThreads) {
      const int r = i / nch, ch = i - r * nch;
      const TBC* sp = src + r * Nraw + ch * EPC;
      float* dp = dst + r * Nf + ch * EPC;
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        if (ch * EPC + e < Nr) dp[e] = to_f32(sp[e]);
    }
  };

  float yacc[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) yacc[ii][jj] = 0.f;
  issue(0, 0);
  for (int jt = 0; jt <= it; ++jt) {
    const int st = jt & 1;
    cp_async_wait_all();
    __syncthreads();          // tile jt landed; tile jt - 1 consumed
    if (jt == 0) {
      if (kConv) {
        convert(reinterpret_cast<const TBC*>(bf_s), cf_s);
        __syncthreads();
      }
      // y_i = exp(a_cum_i) (C_i h_in^T)
      for (int k0 = 0; k0 < Nr; k0 += 4)
        fma_rows_cols(yacc, cf_s, Nf, hs_s, kSsP, k0, ty, tx);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int r = ty + 16 * ii;
        const float w = r < ni ? expf((float)acum_s[i0 + r]) : 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) yacc[ii][jj] *= w;
      }
    }
    if (jt < it) issue(jt + 1, st ^ 1);
    const float* bop;
    if (kConv) {
      convert(braw + st * kSsT * Nraw, bf_s);
      bop = bf_s;
    } else {
      bop = reinterpret_cast<const float*>(braw + st * kSsT * Nraw);
    }
    __syncthreads();          // B_j ready; h_in^T no longer read
    // scores (C_i B_j^T) o L_ij, L selected to 0 above the diagonal:
    // rows ty + 16 ii, keys tx + 16 jj
    float s[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
    for (int k0 = 0; k0 < Nr; k0 += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        av[ii] = *reinterpret_cast<const float4*>(cf_s + (ty + 16 * ii) * Nf + k0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        bv[jj] = *reinterpret_cast<const float4*>(bop + (tx + 16 * jj) * Nf + k0);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float t = s[ii][jj];
          t = fmaf(av[ii].x, bv[jj].x, t);
          t = fmaf(av[ii].y, bv[jj].y, t);
          t = fmaf(av[ii].z, bv[jj].z, t);
          t = fmaf(av[ii].w, bv[jj].w, t);
          s[ii][jj] = t;
        }
    }
    const int j0 = jt * kSsT, nj = min(kSsT, Q - j0);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = ty + 16 * ii, gi = i0 + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int cc = tx + 16 * jj, gj = j0 + cc;
        float v = 0.f;
        if (gi >= gj && r < ni && cc < nj)
          v = s[ii][jj] * expf((float)(acum_s[gi] - acum_s[gj]));
        hs_s[r * kSsP + cc] = v;
      }
    }
    __syncthreads();
    const float* xs = x_s + st * kSsT * kSsP;
    for (int k0 = 0; k0 < kSsT; k0 += 4)
      fma_rows_cols(yacc, hs_s, kSsP, xs, kSsP, k0, ty, tx);
  }
  float* yb = y + ((long long)bidx * S + c0 + i0) * H * P + (long long)hh * P +
              pb * kSsT;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = ty + 16 * ii;
    if (r >= ni) continue;
    float* yr = yb + (long long)r * H * P;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (tx * 4 + jj < pw) yr[tx * 4 + jj] = yacc[ii][jj];
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

template <int DP>
cudaError_t launch_tx(dim3 grid, cudaStream_t stream, const void* q,
                      const void* k, const void* v, void* o, int H, int G,
                      int Sq, int Skv, int D, long long qsb, long long qsh,
                      long long qss, long long ksb, long long ksh,
                      long long kss, long long vsb, long long vsh,
                      long long vss, long long osb, long long osh,
                      long long oss, int causal, int use_window, int window,
                      float scale, int bf16, int vecq, int veck, int vecv) {
  constexpr int NB = (DP + 31) / 32;
  // Q hi, lo and K hi, lo (NB boxes each), V^T hi and lo (DP x 64 floats)
  const size_t smem =
      1024 + (size_t)4 * NB * kTxBoxBytes + (size_t)4 * DP * 128;
  auto kern = flash_attention_tf32x3_kernel<DP>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kTxThreads, smem, stream>>>(
      q, k, v, o, H, G, Sq, Skv, D, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh,
      vss, osb, osh, oss, causal, use_window, window, scale, bf16, vecq, veck,
      vecv);
  return cudaGetLastError();
}

// each kernel's launcher at the template widths 64, 112, 120 and 128, by
// the index of the least one >= D
constexpr decltype(&launch_fw<64>) kLaunchFw[] = {
    launch_fw<64>, launch_fw<112>, launch_fw<120>, launch_fw<128>};
constexpr decltype(&launch_tx<64>) kLaunchTx[] = {
    launch_tx<64>, launch_tx<112>, launch_tx<120>, launch_tx<128>};

}  // namespace

extern "C" {

const char* prefill_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q [B,H,Sq,D], k/v [B,K,Skv,D], o [B,H,Sq,D], each through its (batch,
// head, sequence) strides in elements; the last dimension is contiguous.
// *route is set to the kernel taken: 1 the wgmma kernel, 2 the tf32x3
// kernel (-1 if the arguments are refused).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int K, int Sq, int Skv,
                           int D, long long qsb, long long qsh, long long qss,
                           long long ksb, long long ksh, long long kss,
                           long long vsb, long long vsh, long long vss,
                           long long osb, long long osh, long long oss,
                           int causal, int use_window, int window, float scale,
                           int is_bf16, int* route,
                           cudaStream_t stream) {
  *route = -1;
  // Sq > Skv only for full attention (cross-attention): q_offset = Skv - Sq
  // is read by the causal and window masks alone
  if (B <= 0 || H <= 0 || Sq <= 0 || K <= 0 || Skv <= 0 || H % K != 0 ||
      D <= 0 || D > kFaMaxD || (Sq > Skv && (causal || use_window)))
    return (int)cudaErrorInvalidValue;
  const int G = H / K;
  cudaError_t e;
  // the wgmma kernel loads through TMA: strides that are multiples of 8
  // elements (16 bytes) and 16-byte aligned bases, any D (the TMA fills the
  // columns past D with zeros). Each kernel returns its own errors: no
  // fallback.
  const long long strides = qsb | qsh | qss | ksb | ksh | kss | vsb | vsh |
                            vss | osb | osh | oss;
  const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                          (uintptr_t)o;
  const int dp = D <= 64 ? 0 : D <= 112 ? 1 : D <= 120 ? 2 : 3;
  if (is_bf16 && (strides & 7) == 0 && (bases & 15) == 0) {
    *route = 1;
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
    e = kLaunchFw[dp](fgrid, stream, tq, tk, tv, o, H, G, Sq, Skv, D, osb,
                      osh, oss, causal, use_window, window, scale_log2,
                      mask_all);
    return (int)e;
  }
  // f32, and bf16 views the TMA refuses: the tf32x3 kernel, which stages
  // every tile by threads. Vector loads need an aligned base, strides that
  // keep rows aligned (a dimension of size 1 is never stepped) and D a
  // multiple of 4; each tensor is judged on its own.
  *route = 2;
  const int esize = is_bf16 ? 2 : 4, align = is_bf16 ? 8 : 16;
  auto vec = [&](const void* p, int n0, long long s0, int n1, long long s1,
                 int n2, long long s2) {
    const int per = align / esize;
    return (int)(((uintptr_t)p % align) == 0 && D % 4 == 0 &&
                 (n0 == 1 || s0 % per == 0) && (n1 == 1 || s1 % per == 0) &&
                 (n2 == 1 || s2 % per == 0));
  };
  const int vecq = vec(q, B, qsb, H, qsh, Sq, qss);
  const int veck = vec(k, B, ksb, K, ksh, Skv, kss);
  const int vecv = vec(v, B, vsb, K, vsh, Skv, vss);
  const dim3 tgrid((unsigned)(B * H), (unsigned)((Sq + kTxBM - 1) / kTxBM));
  e = kLaunchTx[dp](tgrid, stream, q, k, v, o, H, G, Sq, Skv, D, qsb, qsh,
                    qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, causal,
                    use_window, window, scale, is_bf16, vecq, veck, vecv);
  return (int)e;
}

// x [B,S,H,P] f32, a [B,S,H] f32, b/c [B,S,G,N] (bf16 or f32), each
// through its (batch, step, head-or-group) strides; y [B,S,H,P] f32 and
// h_out [B,H,P,N] f32 contiguous; scratch states [B,H,nc,N,P] f32 and
// acum [B,H,S] f64. S is a multiple of the chunk Q.
int ssd_scan_launch(const float* x, const float* a, const void* b,
                    const void* c, float* y, float* h_out, float* states,
                    double* acum, int B, int S, int H, int G, int P, int N,
                    int Q, long long xsb, long long xss, long long xsh,
                    long long asb, long long ass, long long ash,
                    long long bsb, long long bss, long long bsg,
                    long long csb, long long css, long long csg, int is_bf16,
                    cudaStream_t stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P > kSsdMaxP ||
      N <= 0 || N > kSsdMaxN || Q <= 0 || S <= 0 || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  const int nc = S / Q, HG = H / G;
  const int nnb = (N + kSsT - 1) / kSsT, npb = (P + kSsT - 1) / kSsT;
  const int ntile = (Q + kSsT - 1) / kSsT;
  const int elem = is_bf16 ? 2 : 4, epc = 16 / elem;
  // 16-byte loads: rows a multiple of 16 bytes at 16-byte aligned addresses
  // (a stride of a dimension of size 1 is never stepped)
  auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vecx = al(x) && P % 4 == 0 && (S == 1 || xss % 4 == 0) &&
                   (B == 1 || xsb % 4 == 0) && (H == 1 || xsh % 4 == 0);
  const int vecb = al(b) && N % epc == 0 && (S == 1 || bss % epc == 0) &&
                   (B == 1 || bsb % epc == 0) && (G == 1 || bsg % epc == 0);
  const int vecc = al(c) && N % epc == 0 && (S == 1 || css % epc == 0) &&
                   (B == 1 || csb % epc == 0) && (G == 1 || csg % epc == 0);
  const int vech = P % 4 == 0;
  const int Nr = (N + 3) & ~3, Nf = Nr + 4;
  const int Ne = (N + epc - 1) / epc * epc;
  const int Nraw = is_bf16 ? Ne + epc : Nf;
  const size_t smem1 = sizeof(float) * 3 * kSsT * kSsP +
                       (size_t)2 * kSsT * (kSsT + epc) * elem +
                       (sizeof(double) + sizeof(float)) * Q;
  const size_t smem3 =
      sizeof(float) * ((size_t)kSsT * Nf + (size_t)(Nr > kSsT ? Nr : kSsT) * kSsP +
                       (size_t)2 * kSsT * kSsP + (is_bf16 ? (size_t)kSsT * Nf : 0)) +
      (size_t)2 * kSsT * Nraw * elem + sizeof(double) * Q;
  const unsigned long long n1 = (unsigned long long)B * H * nc * nnb * npb;
  const unsigned long long n3 = (unsigned long long)ntile * B * H * nc * npb;
  if (n1 >= (1ull << 31) || n3 >= (1ull << 31) || (long long)B * H >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const dim3 g1((unsigned)n1);
  const dim3 g2((unsigned)(B * H),
                (unsigned)((N * P + kSsThreads - 1) / kSsThreads));
  cudaError_t e;
  if (is_bf16) {
    auto k1 = ssd_chunk_state_kernel<__nv_bfloat16>;
    auto k3 = ssd_chunk_out_kernel<__nv_bfloat16>;
    if ((e = set_smem(k1, smem1)) != cudaSuccess ||
        (e = set_smem(k3, smem3)) != cudaSuccess)
      return (int)e;
    k1<<<g1, kSsThreads, smem1, stream>>>(
        x, a, (const __nv_bfloat16*)b, states, acum, H, HG, P, N, Q, nc,
        vecx, vecb, xsb, xss, xsh, asb, ass, ash, bsb, bss, bsg);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    ssd_state_pass_kernel<<<g2, kSsThreads, 0, stream>>>(states, acum, h_out,
                                                         N, P, nc, Q);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    k3<<<(unsigned)n3, kSsThreads, smem3, stream>>>(
        x, acum, (const __nv_bfloat16*)b, (const __nv_bfloat16*)c, states, y,
        B, S, H, HG, P, N, Q, nc, vecx, vecb, vecc, vech, xsb, xss, xsh, bsb,
        bss, bsg, csb, css, csg);
  } else {
    auto k1 = ssd_chunk_state_kernel<float>;
    auto k3 = ssd_chunk_out_kernel<float>;
    if ((e = set_smem(k1, smem1)) != cudaSuccess ||
        (e = set_smem(k3, smem3)) != cudaSuccess)
      return (int)e;
    k1<<<g1, kSsThreads, smem1, stream>>>(
        x, a, (const float*)b, states, acum, H, HG, P, N, Q, nc, vecx,
        vecb, xsb, xss, xsh, asb, ass, ash, bsb, bss, bsg);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    ssd_state_pass_kernel<<<g2, kSsThreads, 0, stream>>>(states, acum, h_out,
                                                         N, P, nc, Q);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    k3<<<(unsigned)n3, kSsThreads, smem3, stream>>>(
        x, acum, (const float*)b, (const float*)c, states, y, B, S, H, HG, P,
        N, Q, nc, vecx, vecb, vecc, vech, xsb, xss, xsh, bsb, bss, bsg, csb,
        css, csg);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
