// Serving-path kernels of the tiered paged KV cache, written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of the reference:
//   pool_attention_partial <- repro/kernels/tiered_attention/kernel.py
//                             pool_attention_partial_tpu
//   migrate_pages          <- repro/kernels/migrate/kernel.py
//                             migrate_pages_tpu
// and adds one that replaces none:
//   ssd_decode_state       (the reference's Mamba2 decode step,
//                           repro/models/ssm.py mamba_decode_step, is plain
//                           jnp with no Pallas kernel)
//
// pool_attention_partial: single-query decode attention over one tier's
// paged pool, returning the online-softmax partial (acc, m, l) and the
// per-page attention mass (the tiering policy's hotness signal). A decode
// step reads every valid K/V row once and does about one multiply-add per
// element, so device-memory bytes bound it on this card; the design keeps
// loads in flight and few barriers. It is a flash-decode split in two
// launches:
//   * pool_attention_split_kernel, one block of 4 warps per (sequence,
//     kv head, head group, split): a split is a contiguous range of pool
//     slots, a head group up to 4 of the G = H/K query heads that share
//     the kv head, so each K/V row is loaded once for all of them (no KV
//     expansion). Warp 0 first lists the range's slots that hold a valid
//     token: a free slot (page id < 0) or a page wholly outside
//     [seq - window, seq] is dropped before any load. Then each warp walks
//     its own pages (list entries w, w + 4, ...) in units of up to 16
//     tokens of one page, with its own online softmax and a private ring
//     of 16-byte cp.async copies (three stages in bf16 where four blocks
//     still fit an SM, else two): the next units load while one is
//     computed, and the loop has no block barrier. A lane holds 16-byte
//     chunks of four rows (a bf16 row of 64 is 8 chunks, of 112 is 14),
//     copies exactly those chunks, and keeps its query chunks in
//     registers. Scores: each lane dots its chunks with every head's
//     query, then a reduce-scatter over the row's 8 lanes leaves each lane
//     one head's score (4 shuffles for 4 heads instead of 12); the lane
//     runs that head's softmax and page mass (the max and sum over the
//     warp's four row groups, 2 shuffles each), and P V takes each head's
//     p from its lanes by shuffle and accumulates in registers. A page's
//     mass follows the warp's running max; at the end the warps' partials
//     merge in the block (m = their max, each rescaled), and each page's
//     mass is rescaled to the split's max. The kernel is a programmatic
//     dependent launch: it waits (griddepcontrol.wait) for the kernel
//     before it to complete before reading anything, so the other tier's
//     call can have its blocks resident when this one ends.
//   * pool_attention_merge_kernel (only with more than one split), a warp
//     per (sequence, head): m = the max of the splits' m, and each split's
//     (acc, l) and its pages' masses are rescaled by exp(m_split - m). A
//     split with no valid token (m = -1e30, l = 0) adds nothing and no NaN.
// The launcher (kernels/tiered_attention/kernel.py num_splits) picks the
// splits so that about 2 x 132 blocks are in flight, no split shorter than
// a tile: one split at the serving paths' B x K of 512 and 1,024. The mass
// leaves relative to each head's final m, as in the plain version (the TPU
// kernel's per-block stabiliser output is not needed). Scores and sums are
// float32 (K/V loaded from bf16 or f32). Rows that are not 16-byte aligned
// are staged with element loads instead of cp.async.
//
// migrate_pages: for every selected sequence, copy one [pt, K, D] page from
// the source pool into a slot of the destination pool, in every layer, in
// place, for one pool pair or for two that share the indices (K and V).
// Pure data movement, bound by device-memory bytes (each page read once
// and written once); what the design cuts is latency and wasted blocks:
//   * a fixed grid of two blocks per SM, whatever the batch: each block
//     compacts the selected sequences (a ballot and a scan over `sel`,
//     with their clamped slots) into shared memory, then walks the work
//     items (pool, layer, selected sequence, 16 KiB chunk of the page) in
//     a grid-stride loop, so an unselected sequence costs no block and
//     a large page spreads over many SMs;
//   * each thread issues all eight of its 16-byte loads of a chunk before
//     its first store (`__restrict__` pools), so a chunk is one memory
//     round trip, not eight in a row.
// A page whose size is not a multiple of 16 bytes, or a pool not 16-byte
// aligned, is copied byte by byte in the same walk.
//
// ssd_decode_state: one Mamba2 layer's decode step from the conv outputs
// to y, for every (batch, head): with g = h / (H / G),
//   c[p, n]  = x[p] * (B[g, n] * dt)          (float32, rounded twice)
//   h'[p, n] = (float)((double)h[p, n] * da + (double)c[p, n])
//   y[p]     = sum_n C[g, n] h'[p, n] + D * x[p]
// h' is stored over h in place. It is the plain version's float64
// multiply-add (numerics.fused_mul_add, the reference's single rounding of
// h * da + c: h * da is exact in float64) done in registers with explicit
// _rn intrinsics, so h' equals the plain version bit for bit; only y's sum
// order differs. Bound by device-memory bytes: h is read once and written
// once, 2 x B*H*P*N*4 bytes a layer (0.94 GB at Zamba2-7B's B=256, H=112,
// P=N=64: 0.280 ms at 3.35 TB/s); the float64 work (three conversions, a
// multiply and an add an element) hides under that byte rate (a float32
// multiply-add in its place timed the same). The design is one streaming
// pass: a warp per (batch, head) tile of P x N floats, each lane owning one
// 16-byte column of N (N / 4 lanes a row, rounded up to a power of two, so
// a warp covers 32 / that rows at once); the tile streams through a
// three-stage cp.async ring in shared memory, two groups of rows in flight
// while one is computed, with no registers held for the loads
// (evict-first loads and streaming stores: the state does not fit in L2
// and is not read again in the step); B, C and b * dt of the lane's four
// columns, dt, da and D are loaded once a tile; y's sum over N is a
// shuffle reduction over the row's lanes. x, B and C are read in their own
// dtype (bf16 or float32; widening bf16 is exact) through their strides.
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
// Block (sequence, kv head, head group of GT heads, split) of kPaWarps
// warps; each warp walks its own units (16 tokens of one page). In a unit,
// lane (grp = lane / 8, li = lane % 8) holds rows grp, grp + 4, grp + 8,
// grp + 12 and the 16-byte chunks li + 8 u (u < CPL) of each row; it
// copies exactly those chunks, so its own cp.async.wait_group makes them
// visible to it. Shared memory, in order: the rings (warps x NST stages x
// {K, V} x 16 rows x Dp elements), then floats q_s[GT][Dp] (scaled query),
// accw_s[warps][GT][Dp], mw_s[warps][GT], lw_s[warps][GT], mfin_s[GT],
// mass_s[GT][ns], stab_s[GT][ns], then ints ent_slot[ns], ent_lo[ns],
// ent_hi[ns], nent (ns = the split's slot count).
constexpr int kPaWarps = 4;
constexpr int kPaThreads = 32 * kPaWarps;
constexpr int kPaUnit = 16;            // token rows of a unit
constexpr int kPaMaxSplits = 32;       // the merge keeps one per lane
constexpr size_t kPaSmem3 = 56 * 1024; // most shared memory for 3 stages

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// 16-byte asynchronous copy into shared memory; with valid false nothing
// is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of shared memory as floats: 4 f32 or 8 bf16
__device__ __forceinline__ void load_chunk(const float* s, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* s, float* o) {
  const uint4 v = *reinterpret_cast<const uint4*>(s);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int GT, int CPL, int NST>
__global__ void __launch_bounds__(kPaThreads)
pool_attention_split_kernel(const void* __restrict__ q, int q_bf16,
                            const T* __restrict__ pool_k,
                            const T* __restrict__ pool_v,
                            const int* __restrict__ slot_page,
                            const int* __restrict__ seq_len, int Bn, int Mp,
                            int pt, int K, int G, int D, int use_window,
                            int window, float scale, int pages_per_split,
                            int vec, float* __restrict__ acc_out,
                            float* __restrict__ m_out,
                            float* __restrict__ l_out,
                            float* __restrict__ mass_out) {
  constexpr int EPC = 16 / sizeof(T);  // elements of a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NHG = (G + GT - 1) / GT;
  const int hg = blockIdx.x % NHG;
  const int kk = (blockIdx.x / NHG) % K, b = blockIdx.x / (NHG * K);
  const int split = blockIdx.y;
  const int H = K * G, g0 = hg * GT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 3, li = lane & 7;
  const int NC = (D + EPC - 1) / EPC;  // chunks of a row
  const int Dp = NC * EPC;
  const int p0 = split * pages_per_split;
  const int p1 = min(Mp, p0 + pages_per_split);
  const int ns = p1 - p0;
  const size_t stage_elems = (size_t)2 * kPaUnit * Dp;    // K and V rows
  T* ring = reinterpret_cast<T*>(smem_raw) + (size_t)warp * NST * stage_elems;
  float* q_s = reinterpret_cast<float*>(reinterpret_cast<T*>(smem_raw) +
                                        (size_t)kPaWarps * NST * stage_elems);
  float* accw_s = q_s + GT * Dp;
  float* mw_s = accw_s + kPaWarps * GT * Dp;
  float* lw_s = mw_s + kPaWarps * GT;
  float* mfin_s = lw_s + kPaWarps * GT;
  float* mass_s = mfin_s + GT;
  float* stab_s = mass_s + GT * ns;
  int* ent_slot = reinterpret_cast<int*>(stab_s + GT * ns);
  int* ent_lo = ent_slot + ns;
  int* ent_hi = ent_lo + ns;
  int* nent_s = ent_hi + ns;

  // launched as a programmatic dependent of the kernel before it: wait
  // for that kernel to complete before reading anything, then let the
  // next one (the other tier's call) get its blocks resident early
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n");

  for (int i = tid; i < GT * Dp; i += kPaThreads) {
    const int g = i / Dp, d = i - g * Dp;
    float v = 0.f;
    if (d < D && g0 + g < G) {
      const size_t at = ((size_t)b * H + (size_t)kk * G + g0 + g) * D + d;
      v = q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[at])
                 : static_cast<const float*>(q)[at];
    }
    q_s[i] = v * scale;
  }
  for (int i = tid; i < GT * ns; i += kPaThreads) {
    mass_s[i] = 0.f;
    stab_s[i] = kNegInf;
  }
  // the split's slots that hold a valid token, with their token range
  // [lo, hi): free slots and pages outside [seq - window, seq] drop out
  // here, before any load
  if (warp == 0) {
    const long long seq = seq_len[b];
    int n = 0;
    for (int base = p0; base < p1; base += 32) {
      const int p = base + lane;
      int lo = 0, hi = 0;
      if (p < p1) {
        const int page = slot_page[(size_t)b * Mp + p];
        if (page >= 0) {
          const long long first = (long long)page * pt;
          const long long h_ll = seq - first + 1;           // tok <= seq
          const long long l_ll = use_window ? seq - window - first + 1 : 0;
          hi = h_ll <= 0 ? 0 : (h_ll < pt ? (int)h_ll : pt);
          lo = l_ll <= 0 ? 0 : (l_ll < pt ? (int)l_ll : pt);
        }
      }
      const bool ok = hi > lo;
      const unsigned mask = __ballot_sync(0xffffffffu, ok);
      if (ok) {
        const int e = n + __popc(mask & ((1u << lane) - 1u));
        ent_slot[e] = p;
        ent_lo[e] = lo;
        ent_hi[e] = hi;
      }
      n += __popc(mask);
    }
    if (lane == 0) *nent_s = n;
  }
  __syncthreads();
  const int nent = *nent_s;

  // unit (e, k): tokens [16 k, 16 k + 16) of entry e's page, within its
  // valid range; issue copies this lane's chunks of its four rows
  auto issue = [&](int e, int k, int st) {
    T* ks = ring + (size_t)st * stage_elems;
    T* vs = ks + (size_t)kPaUnit * Dp;
    const int lo = ent_lo[e], hi = ent_hi[e];
    const size_t base = ((((size_t)b * Mp + ent_slot[e]) * pt) * K + kk) * D;
    const size_t row = (size_t)K * D;           // elements between tokens
#pragma unroll
    for (int i = 0; i < kPaUnit / 4; ++i) {
      const int r = 4 * i + grp, j = kPaUnit * k + r;
      const bool ok = j >= lo && j < hi;
      const size_t off = ok ? base + (size_t)j * row : 0;
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        const int c = li + 8 * u;
        if (c < NC) {
          if (vec) {
            cp_async16(ks + r * Dp + c * EPC, pool_k + off + c * EPC, ok);
            cp_async16(vs + r * Dp + c * EPC, pool_v + off + c * EPC, ok);
          } else {
#pragma unroll
            for (int x = 0; x < EPC; ++x) {
              const int d = c * EPC + x;
              ks[r * Dp + d] = ok && d < D ? pool_k[off + d] : zero_of<T>();
              vs[r * Dp + d] = ok && d < D ? pool_v[off + d] : zero_of<T>();
            }
          }
        }
      }
    }
  };

  // After the score reduction lane li of a row group holds head
  // hl = li >> (3 - LG) (a reduce-scatter over the 8 lanes: LG halvings,
  // then plain sums); it keeps that head's running (m, l) and page mass.
  // The lanes li = g << (3 - LG) of each group hold head g.
  constexpr int LG = GT == 4 ? 2 : (GT == 2 ? 1 : 0);
  const int hl = (li >> (3 - LG)) & (GT - 1);
  float m = kNegInf, l = 0.f, mpage = 0.f;
  float qr[GT][CPL][EPC];              // this lane's chunks of the query
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int u = 0; u < CPL; ++u)
#pragma unroll
      for (int x = 0; x < EPC; ++x)
        qr[g][u][x] = li + 8 * u < NC ? q_s[g * Dp + (li + 8 * u) * EPC + x]
                                      : 0.f;
  float acc[GT][CPL][EPC];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int u = 0; u < CPL; ++u)
#pragma unroll
      for (int x = 0; x < EPC; ++x) acc[g][u][x] = 0.f;

  // the warp's units in order: unit (e, k) is computed from ring stage st
  // while the next NST - 1 are in flight; (ne, nk) is the next to issue
  auto next_unit = [&](int& ue, int& uk) {
    if (uk < (ent_hi[ue] - 1) / kPaUnit) {
      ++uk;
    } else {
      ue += kPaWarps;
      uk = ue < nent ? ent_lo[ue] / kPaUnit : 0;
    }
  };
  const int e_first = warp;
  const int k_first = e_first < nent ? ent_lo[e_first] / kPaUnit : 0;
  int e = e_first, k = k_first, ne = e_first, nk = k_first;
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (ne < nent) {
      issue(ne, nk, i);
      next_unit(ne, nk);
    }
    cp_async_commit();
  }
  int st = 0;
  while (e < nent) {
    cp_async_wait<NST - 2>();        // this lane's chunks of unit (e, k)
    if (ne < nent) {
      issue(ne, nk, st == 0 ? NST - 1 : st - 1);
      next_unit(ne, nk);
    }
    cp_async_commit();
    const T* ks = ring + (size_t)st * stage_elems;
    const T* vs = ks + (size_t)kPaUnit * Dp;
    const int lo = ent_lo[e], hi = ent_hi[e];
    // scores: this lane's head hl, rows 4 i + grp
    float sv[kPaUnit / 4];
#pragma unroll
    for (int i = 0; i < kPaUnit / 4; ++i) {
      const int r = 4 * i + grp;
      float v[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) v[g] = 0.f;
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        const int c = li + 8 * u;
        if (c < NC) {
          float kf[EPC];
          load_chunk(ks + r * Dp + c * EPC, kf);
#pragma unroll
          for (int g = 0; g < GT; ++g)
#pragma unroll
            for (int x = 0; x < EPC; ++x) v[g] = fmaf(kf[x], qr[g][u][x], v[g]);
        }
      }
#pragma unroll
      for (int lv = 0; lv < LG; ++lv) {     // keep half, send half
        const int off = 4 >> lv, half = GT >> (lv + 1);
        const bool up = li & off;
#pragma unroll
        for (int j = 0; j < half; ++j) {
          const float keep = up ? v[j + half] : v[j];
          const float send = up ? v[j] : v[j + half];
          v[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
#pragma unroll
      for (int off = 4 >> LG; off >= 1; off >>= 1)
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
      sv[i] = v[0];
    }
    // online softmax of head hl over the unit's valid rows (max and sum
    // over the four row groups); the page's mass follows the running max
    bool ok[kPaUnit / 4];
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kPaUnit / 4; ++i) {
      const int j = kPaUnit * k + 4 * i + grp;
      ok[i] = j >= lo && j < hi;
      if (ok[i]) mx = fmaxf(mx, sv[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPaUnit / 4; ++i) {
      sv[i] = ok[i] ? __expf(sv[i] - m_new) : 0.f;
      sum += sv[i];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 8);
    sum += __shfl_xor_sync(0xffffffffu, sum, 16);
    const float corr = __expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
    mpage = k == lo / kPaUnit ? sum : mpage * corr + sum;
    if (k == (hi - 1) / kPaUnit && grp == 0 && (li & ((8 >> LG) - 1)) == 0) {
      const int sl = ent_slot[e] - p0;
      mass_s[hl * ns + sl] = mpage;
      stab_s[hl * ns + sl] = m_new;
    }
    // acc = acc * corr + P V, each head's p and corr from its lanes
    if (!__all_sync(0xffffffffu, corr == 1.f)) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float cg =
            __shfl_sync(0xffffffffu, corr, (grp << 3) | (g << (3 - LG)));
#pragma unroll
        for (int u = 0; u < CPL; ++u)
#pragma unroll
          for (int x = 0; x < EPC; ++x) acc[g][u][x] *= cg;
      }
    }
#pragma unroll
    for (int i = 0; i < kPaUnit / 4; ++i) {
      const int r = 4 * i + grp;
      float pg[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g)
        pg[g] = GT == 1 ? sv[i]
                        : __shfl_sync(0xffffffffu, sv[i],
                                      (grp << 3) | (g << (3 - LG)));
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        const int c = li + 8 * u;
        if (c < NC) {
          float vf[EPC];
          load_chunk(vs + r * Dp + c * EPC, vf);
#pragma unroll
          for (int g = 0; g < GT; ++g)
#pragma unroll
            for (int x = 0; x < EPC; ++x)
              acc[g][u][x] = fmaf(pg[g], vf[x], acc[g][u][x]);
        }
      }
    }
    st = st + 1 == NST ? 0 : st + 1;
    next_unit(e, k);
  }
  cp_async_wait<0>();

  // the warp's partial: acc summed over its four row groups; head g's
  // (m, l) from lane g << (3 - LG)
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int u = 0; u < CPL; ++u)
#pragma unroll
      for (int x = 0; x < EPC; ++x) {
        float t = acc[g][u][x];
        t += __shfl_xor_sync(0xffffffffu, t, 8);
        t += __shfl_xor_sync(0xffffffffu, t, 16);
        const int c = li + 8 * u;
        if (grp == 0 && c < NC) accw_s[(warp * GT + g) * Dp + c * EPC + x] = t;
      }
  if (grp == 0 && (li & ((8 >> LG) - 1)) == 0) {
    mw_s[warp * GT + hl] = m;
    lw_s[warp * GT + hl] = l;
  }
  __syncthreads();
  // merge the warps: m = the max of theirs, each rescaled by exp(m_w - m)
  const size_t bh0 = ((size_t)split * Bn + b) * H + (size_t)kk * G + g0;
  for (int g = tid; g < GT; g += kPaThreads) {
    float mx = kNegInf;
    for (int w = 0; w < kPaWarps; ++w) mx = fmaxf(mx, mw_s[w * GT + g]);
    float ls = 0.f;
    for (int w = 0; w < kPaWarps; ++w) {
      const float c = expf(mw_s[w * GT + g] - mx);
      mw_s[w * GT + g] = c;            // from here on, warp w's factor
      ls += lw_s[w * GT + g] * c;
    }
    mfin_s[g] = mx;
    if (g0 + g < G) {
      m_out[bh0 + g] = mx;
      l_out[bh0 + g] = ls;
    }
  }
  __syncthreads();
  for (int i = tid; i < GT * D; i += kPaThreads) {
    const int g = i / D, d = i - g * D;
    if (g0 + g >= G) continue;
    float a = 0.f;
    for (int w = 0; w < kPaWarps; ++w)
      a += accw_s[(w * GT + g) * Dp + d] * mw_s[w * GT + g];
    acc_out[(bh0 + g) * D + d] = a;
  }
  float* mb = mass_out + ((size_t)b * H + (size_t)kk * G + g0) * Mp + p0;
  for (int i = tid; i < GT * ns; i += kPaThreads) {
    const int g = i / ns, sl = i - g * ns;
    // a slot with no valid token keeps mass 0 (0 * exp(<= 0))
    if (g0 + g < G)
      mb[(size_t)g * Mp + sl] = mass_s[i] * expf(stab_s[i] - mfin_s[g]);
  }
}

// Merge of the splits: one warp per (sequence, head). m = max of the
// splits' m; each split's (acc, l) and its pages' masses are rescaled by
// exp(m_split - m). A split with no valid token (m = -1e30, l = 0) adds 0.
__global__ void __launch_bounds__(128)
pool_attention_merge_kernel(const float* __restrict__ acc_part,
                            const float* __restrict__ m_part,
                            const float* __restrict__ l_part, int nsplit,
                            int BH, int D, int Mp, int pages_per_split,
                            float* __restrict__ acc, float* __restrict__ m,
                            float* __restrict__ l, float* __restrict__ mass) {
  __shared__ float c_s[4][32];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 4 + w;
  if (row >= BH) return;
  const float ms = lane < nsplit ? m_part[(size_t)lane * BH + row] : kNegInf;
  const float mx = warp_max_f32(ms);
  const float c = lane < nsplit ? expf(ms - mx) : 0.f;
  const float lsum =
      warp_sum_f32(lane < nsplit ? l_part[(size_t)lane * BH + row] * c : 0.f);
  c_s[w][lane] = c;
  __syncwarp();
  if (lane == 0) {
    m[row] = mx;
    l[row] = lsum;
  }
  for (int d = lane; d < D; d += 32) {
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s)
      a += acc_part[((size_t)s * BH + row) * D + d] * c_s[w][s];
    acc[(size_t)row * D + d] = a;
  }
  for (int p = lane; p < Mp; p += 32)
    mass[(size_t)row * Mp + p] *= c_s[w][p / pages_per_split];
}

// ------------------------------------------------------- migrate pages
constexpr int kCopyThreads = 128;
constexpr int kCopyUnroll = 8;       // 16-byte loads in flight a thread
constexpr long long kCopyChunk = 16LL * kCopyThreads * kCopyUnroll;  // 16 KiB
constexpr int kCopyBlocksPerSM = 2;

struct PagePools {
  const unsigned char* src[2];
  unsigned char* dst[2];
};

// Compacts the selected sequences of [w0, w0 + blockDim.x) into rows[]:
// (b * Ms + source slot, b * Md + destination slot), slots clamped into
// the pools as the TPU kernel clamps them, in sequence order. Returns
// their count. Every thread of the block calls it.
__device__ __forceinline__ int compact_selected(
    const long long* __restrict__ src_idx,
    const long long* __restrict__ dst_idx,
    const unsigned char* __restrict__ sel, int B, int Ms, int Md, int w0,
    int2* rows, int* warp_cnt) {
  const int b = w0 + (int)threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char on = 0;
  long long si = 0, di = 0;
  if (b < B) {                        // three independent loads
    on = sel[b];
    si = __ldg(src_idx + b);
    di = __ldg(dst_idx + b);
  }
  si = si < 0 ? 0 : (si >= Ms ? Ms - 1 : si);
  di = di < 0 ? 0 : (di >= Md ? Md - 1 : di);
  const unsigned m = __ballot_sync(0xffffffffu, on != 0);
  __syncthreads();                    // rows[] of the last window is read
  if (lane == 0) warp_cnt[warp] = __popc(m);
  __syncthreads();
  int base = 0, total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int c = warp_cnt[w];
    base += w < warp ? c : 0;
    total += c;
  }
  if (on) rows[base + __popc(m & ((1u << lane) - 1u))] =
      make_int2(b * Ms + (int)si, b * Md + (int)di);
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kCopyThreads)
migrate_pages_kernel(PagePools pools, int npools,
                     const long long* __restrict__ src_idx,
                     const long long* __restrict__ dst_idx,
                     const unsigned char* __restrict__ sel, int L, int B,
                     int Ms, int Md, long long page_bytes, int vec) {
  __shared__ int2 rows[kCopyThreads];
  __shared__ int warp_cnt[kCopyThreads / 32];
  // 32-bit item arithmetic: the launcher keeps npools * L * B * nch in
  // range (a 64-bit division is a long software sequence)
  const unsigned nch = (unsigned)((page_bytes + kCopyChunk - 1) / kCopyChunk);
  for (int w0 = 0; w0 < B; w0 += kCopyThreads) {
    const unsigned nsel = (unsigned)compact_selected(
        src_idx, dst_idx, sel, B, Ms, Md, w0, rows, warp_cnt);
    const unsigned items = (unsigned)npools * L * nsel * nch;
    for (unsigned it = blockIdx.x; it < items; it += gridDim.x) {
      const unsigned c = it % nch, q = it / nch;
      const unsigned j = q % nsel, lp = q / nsel;
      const unsigned l = lp % (unsigned)L, p = lp / (unsigned)L;
      const int2 r = rows[j];
      const long long off = (long long)c * kCopyChunk;
      const unsigned char* __restrict__ s =
          pools.src[p] + ((long long)l * B * Ms + r.x) * page_bytes + off;
      unsigned char* __restrict__ d =
          pools.dst[p] + ((long long)l * B * Md + r.y) * page_bytes + off;
      const long long n = min(kCopyChunk, page_bytes - off);
      if (vec) {
        const uint4* s4 = reinterpret_cast<const uint4*>(s);
        uint4* d4 = reinterpret_cast<uint4*>(d);
        const int n4 = (int)(n >> 4);
        uint4 v[kCopyUnroll];
#pragma unroll
        for (int i = 0; i < kCopyUnroll; ++i) {
          const int k = threadIdx.x + i * kCopyThreads;
          if (k < n4) v[i] = __ldg(s4 + k);
        }
#pragma unroll
        for (int i = 0; i < kCopyUnroll; ++i) {
          const int k = threadIdx.x + i * kCopyThreads;
          if (k < n4) d4[k] = v[i];
        }
      } else {
        for (int k = threadIdx.x; k < n; k += kCopyThreads) d[k] = s[k];
      }
    }
  }
}

template <typename T, int GT, int CPL, int NST>
cudaError_t launch_split(dim3 grid, size_t smem, cudaStream_t stream,
                         const void* q, int q_bf16, const void* pool_k,
                         const void* pool_v, const int* slot_page,
                         const int* seq_len, int B, int Mp, int pt, int K,
                         int G, int D, int use_window, int window, float scale,
                         int pages_per_split, int vec, float* acc, float* m,
                         float* l, float* mass) {
  auto kern = pool_attention_split_kernel<T, GT, CPL, NST>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  // a programmatic dependent launch: the blocks may become resident while
  // the kernel before finishes (they wait for it in griddepcontrol.wait)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kPaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, q, q_bf16, (const T*)pool_k, (const T*)pool_v, slot_page,
      seq_len, B, Mp, pt, K, G, D, use_window, window, scale,
      pages_per_split, vec, acc, m, l, mass);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, int GT>
cudaError_t launch_split_cpl(int cpl, int nst, dim3 grid, size_t smem,
                             cudaStream_t stream, const void* q, int q_bf16,
                             const void* pool_k, const void* pool_v,
                             const int* slot_page, const int* seq_len, int B,
                             int Mp, int pt, int K, int G, int D,
                             int use_window, int window, float scale,
                             int pages_per_split, int vec, float* acc,
                             float* m, float* l, float* mass) {
#define PA_ARGS grid, smem, stream, q, q_bf16, pool_k, pool_v, slot_page, \
                seq_len, B, Mp, pt, K, G, D, use_window, window, scale,     \
                pages_per_split, vec, acc, m, l, mass
  if constexpr (sizeof(T) == 2) {     // bf16: rows of <= 16 chunks
    if (cpl == 1)
      return nst == 3 ? launch_split<T, GT, 1, 3>(PA_ARGS)
                      : launch_split<T, GT, 1, 2>(PA_ARGS);
    return nst == 3 ? launch_split<T, GT, 2, 3>(PA_ARGS)
                    : launch_split<T, GT, 2, 2>(PA_ARGS);
  } else {                            // f32: two stages
    if (cpl == 1) return launch_split<T, GT, 1, 2>(PA_ARGS);
    if (cpl == 2) return launch_split<T, GT, 2, 2>(PA_ARGS);
    return launch_split<T, GT, 4, 2>(PA_ARGS);
  }
#undef PA_ARGS
}

// ------------------------------------------------- Mamba2 decode state
constexpr int kSdWarps = 8;            // (batch, head) tiles a block
constexpr int kSdUnroll = 4;           // rows of a lane in a group
constexpr int kSdStages = 3;           // groups in a warp's ring

struct SdStrides {                     // element strides of x, b and c
  long long x[3], b[3], c[3];
};

// 16-byte asynchronous copy into shared memory, marked evict-first in L2;
// with valid false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16_ef(void* smem, const void* gmem,
                                              bool valid,
                                              unsigned long long pol) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
      ::"r"(s), "l"(gmem), "r"(valid ? 16 : 0), "l"(pol));
}

// A warp per (batch, head) tile h [P, N] (row-major, N contiguous); tiles
// run batch-fastest, so the warps of a block read neighbouring entries of
// x, B and C in the conv step's transposed layout (batch stride 1). Lane
// (row = lane / TPR, q = lane % TPR) owns 16-byte column q of its rows: a
// group of the tile is RPW x kSdUnroll rows, copied with cp.async into the
// warp's ring of kSdStages groups in shared memory (the lane's own chunks,
// so its own wait_group makes them visible to it), kSdStages - 1 groups in
// flight while one is computed and stored; a lane with 4 q >= N owns
// nothing and adds 0 to the row's sum.
template <typename T, int TPR>
__global__ void __launch_bounds__(32 * kSdWarps)
ssd_decode_state_kernel(float* __restrict__ h, const T* __restrict__ x,
                        const T* __restrict__ b, const T* __restrict__ c,
                        const float* __restrict__ dt,
                        const float* __restrict__ da,
                        const float* __restrict__ D, float* __restrict__ y,
                        int B, int H, int G, int P, int N, SdStrides st) {
  constexpr int RPW = 32 / TPR;        // rows a warp covers at once
  constexpr int GROUP = RPW * kSdUnroll;
  // 48 KiB: four blocks fit an SM
  __shared__ float4 ring_all[kSdWarps][kSdStages][kSdUnroll][32];
  const int wid = (int)(threadIdx.x >> 5);
  const int w = blockIdx.x * kSdWarps + wid;
  if (w >= B * H) return;              // whole warps: the shuffles below
  float4 (*ring)[kSdUnroll][32] = ring_all[wid];
  const int lane = threadIdx.x & 31;
  const int q = lane % TPR, row = lane / TPR;
  const int hi = w / B, bi = w - hi * B, g = hi / (H / G);
  const int tile = bi * H + hi;        // [B, H] index
  const bool col = 4 * q < N;
  unsigned long long pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  float* __restrict__ ht = h + (long long)tile * P * N;
  const int ngroups = (P + GROUP - 1) / GROUP;
  auto issue = [&](int k) {
    if (k < ngroups) {
#pragma unroll
      for (int u = 0; u < kSdUnroll; ++u) {
        const int p = k * GROUP + u * RPW + row;
        const bool ok = p < P && col;
        cp_async16_ef(&ring[k % kSdStages][u][lane],
                      ok ? (const void*)(ht + (long long)p * N + 4 * q)
                         : (const void*)ht, ok, pol);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kSdStages - 1; ++k) issue(k);
  const float dtv = dt[tile];
  const double da64 = (double)da[tile];
  const float dh = D[hi];
  float bdt[4], cg[4];
  const T* __restrict__ bt = b + bi * st.b[0] + g * st.b[1];
  const T* __restrict__ ct = c + bi * st.c[0] + g * st.c[1];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bdt[j] = col ? __fmul_rn(to_f32(bt[(4 * q + j) * st.b[2]]), dtv) : 0.f;
    cg[j] = col ? to_f32(ct[(4 * q + j) * st.c[2]]) : 0.f;
  }
  const T* __restrict__ xt = x + bi * st.x[0] + hi * st.x[1];
  float* __restrict__ yt = y + (long long)tile * P;
  for (int k = 0; k < ngroups; ++k) {
    float xv[kSdUnroll];
#pragma unroll
    for (int u = 0; u < kSdUnroll; ++u) {
      const int p = k * GROUP + u * RPW + row;
      xv[u] = p < P ? to_f32(xt[p * st.x[2]]) : 0.f;
    }
    issue(k + kSdStages - 1);
    cp_async_wait<kSdStages - 1>();
#pragma unroll
    for (int u = 0; u < kSdUnroll; ++u) {
      const int p = k * GROUP + u * RPW + row;
      const float4 hv = ring[k % kSdStages][u][lane];
      float hn[4] = {hv.x, hv.y, hv.z, hv.w};
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float cj = __fmul_rn(xv[u], bdt[j]);
        hn[j] = __double2float_rn(
            __dadd_rn(__dmul_rn((double)hn[j], da64), (double)cj));
        acc = __fmaf_rn(cg[j], hn[j], acc);
      }
      if (p < P && col)
        __stcs(reinterpret_cast<float4*>(ht + (long long)p * N) + q,
               make_float4(hn[0], hn[1], hn[2], hn[3]));
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (q == 0 && p < P) yt[p] = __fadd_rn(acc, __fmul_rn(dh, xv[u]));
    }
  }
}

template <typename T>
cudaError_t launch_ssd_decode_state(int tpr, unsigned blocks,
                                    cudaStream_t stream, void* h,
                                    const void* x, const void* b,
                                    const void* c, const float* dt,
                                    const float* da, const float* D,
                                    float* y, int B, int H, int G, int P,
                                    int N, SdStrides st) {
#define SD_LAUNCH(TPR)                                                     \
  ssd_decode_state_kernel<T, TPR><<<blocks, 32 * kSdWarps, 0, stream>>>(   \
      (float*)h, (const T*)x, (const T*)b, (const T*)c, dt, da, D, y, B, H,  \
      G, P, N, st)
  switch (tpr) {
    case 1: SD_LAUNCH(1); break;
    case 2: SD_LAUNCH(2); break;
    case 4: SD_LAUNCH(4); break;
    case 8: SD_LAUNCH(8); break;
    case 16: SD_LAUNCH(16); break;
    default: SD_LAUNCH(32); break;
  }
#undef SD_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* serving_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// acc_part/m_part/l_part: [nsplit, B, H, (D)] scratch, or acc/m/l
// themselves when nsplit == 1 (then the merge is not launched);
// q [B, H, D] f32 or bf16 (q_bf16); pools [B, Mp, pt, K, D] f32 or bf16
// (is_bf16)
int pool_attention_partial_launch(const void* q, int q_bf16,
                                  const void* pool_k, const void* pool_v,
                                  const int* slot_page,
                                  const int* seq_len, int B, int Mp, int pt,
                                  int K, int G, int D, int use_window,
                                  int window, float scale, int is_bf16,
                                  int nsplit, int pages_per_split,
                                  float* acc_part, float* m_part,
                                  float* l_part, float* acc, float* m,
                                  float* l, float* mass,
                                  cudaStream_t stream) {
  if (B <= 0 || K <= 0 || G <= 0) return (int)cudaGetLastError();
  const int elem = is_bf16 ? 2 : 4, epc = 16 / elem;
  const int NC = (D + epc - 1) / epc, Dp = NC * epc;
  const int cpl = (NC + 7) / 8;
  if (Mp <= 0 || pt <= 0 || D <= 0 || nsplit < 1 || nsplit > kPaMaxSplits ||
      pages_per_split < 1 || (long long)nsplit * pages_per_split < Mp ||
      cpl > 4 || (is_bf16 && cpl > 2))
    return (int)cudaErrorInvalidValue;
  const int GT = G == 1 ? 1 : (G == 2 ? 2 : 4);
  const int NHG = (G + GT - 1) / GT;
  const int ns = pages_per_split;
  const size_t rest =
      sizeof(float) * ((size_t)GT * Dp + (size_t)kPaWarps * GT * Dp +
                       2 * (size_t)kPaWarps * GT + GT + 2 * (size_t)GT * ns) +
      sizeof(int) * (3 * (size_t)ns + 1);
  const size_t ring2 = (size_t)kPaWarps * 2 * 2 * kPaUnit * Dp * elem;
  // bf16: a third ring stage (two units in flight a warp) where the block
  // still fits four to an SM
  const int nst = is_bf16 && rest + ring2 * 3 / 2 <= kPaSmem3 ? 3 : 2;
  const size_t smem = rest + ring2 / 2 * nst;
  // 16-byte loads need 16-byte rows at 16-byte aligned addresses
  const int vec = (D * elem) % 16 == 0 && ((uintptr_t)pool_k & 15) == 0 &&
                  ((uintptr_t)pool_v & 15) == 0;
  const dim3 grid((unsigned)(B * K * NHG), (unsigned)nsplit);
#define PA_ARGS cpl, nst, grid, smem, stream, q, q_bf16, pool_k, pool_v,   \
                slot_page, seq_len, B, Mp, pt, K, G, D, use_window, window, \
                scale, pages_per_split, vec, acc_part, m_part, l_part, mass
  cudaError_t e;
  if (is_bf16) {
    e = GT == 1   ? launch_split_cpl<__nv_bfloat16, 1>(PA_ARGS)
        : GT == 2 ? launch_split_cpl<__nv_bfloat16, 2>(PA_ARGS)
                  : launch_split_cpl<__nv_bfloat16, 4>(PA_ARGS);
  } else {
    e = GT == 1   ? launch_split_cpl<float, 1>(PA_ARGS)
        : GT == 2 ? launch_split_cpl<float, 2>(PA_ARGS)
                  : launch_split_cpl<float, 4>(PA_ARGS);
  }
#undef PA_ARGS
  if (e != cudaSuccess) return (int)e;
  if (nsplit > 1) {
    const int BH = B * K * G;
    pool_attention_merge_kernel<<<(BH + 3) / 4, 128, 0, stream>>>(
        acc_part, m_part, l_part, nsplit, BH, D, Mp, pages_per_split, acc, m,
        l, mass);
  }
  return (int)cudaGetLastError();
}

// Copies the selected pages of one pool pair (npools 1) or of two that
// share the indices (npools 2: K and V); src1/dst1 are unused with one.
// Pools [L, B, Ms | Md, page_bytes] of one element type; src_idx/dst_idx
// int64 [B] and sel bool [B], as the tiering step makes them (argmin and
// argmax indices, selection masks), so no cast runs before the launch.
int migrate_pages_launch(const void* src0, void* dst0, const void* src1,
                         void* dst1, int npools, const long long* src_idx,
                         const long long* dst_idx, const unsigned char* sel,
                         int L, int B, int Ms, int Md, long long page_bytes,
                         cudaStream_t stream) {
  if (L <= 0 || B <= 0 || page_bytes <= 0) return (int)cudaGetLastError();
  const long long nch = (page_bytes + kCopyChunk - 1) / kCopyChunk;
  const long long most = (long long)npools * L * B * nch;
  if (npools < 1 || npools > 2 || Ms <= 0 || Md <= 0 ||
      (long long)B * Ms > INT32_MAX || (long long)B * Md > INT32_MAX ||
      most > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const PagePools pools = {
      {(const unsigned char*)src0,
       (const unsigned char*)(npools > 1 ? src1 : src0)},
      {(unsigned char*)dst0, (unsigned char*)(npools > 1 ? dst1 : dst0)}};
  uintptr_t addr = (uintptr_t)src0 | (uintptr_t)dst0;
  if (npools > 1) addr |= (uintptr_t)src1 | (uintptr_t)dst1;
  const int vec = (page_bytes & 15) == 0 && (addr & 15) == 0;
  // a fixed grid, capped by the most work the arguments could hold
  const long long grid = (long long)sms * kCopyBlocksPerSM;
  const long long blocks = grid < most ? grid : most;
  migrate_pages_kernel<<<(unsigned)blocks, kCopyThreads, 0, stream>>>(
      pools, npools, src_idx, dst_idx, sel, L, B, Ms, Md, page_bytes, vec);
  return (int)cudaGetLastError();
}

// One Mamba2 layer's decode state for every (batch, head), in place:
// h [B, H, P, N] float32, contiguous and 16-byte aligned; x [B, H, P], b
// and c [B, G, N] of one element type (is_bf16), read through their three
// element strides each (x's, b's, c's); dt and da [B, H] and D
// [H] float32, contiguous; y [B, H, P] float32 out. N a multiple of 4 up
// to 128.
int ssd_decode_state_launch(void* h, const void* x, const void* b,
                            const void* c, const float* dt, const float* da,
                            const float* D, float* y, int B, int H, int G,
                            int P, int N, long long xs0, long long xs1,
                            long long xs2, long long bs0, long long bs1,
                            long long bs2, long long cs0, long long cs1,
                            long long cs2, int is_bf16, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || P <= 0) return (int)cudaGetLastError();
  if (G <= 0 || H % G || N <= 0 || N % 4 || N > 128 ||
      ((uintptr_t)h & 15) || (long long)B * H > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  int tpr = 1;
  while (tpr < N / 4) tpr <<= 1;
  const SdStrides st = {{xs0, xs1, xs2}, {bs0, bs1, bs2}, {cs0, cs1, cs2}};
  const unsigned blocks = (unsigned)((B * H + kSdWarps - 1) / kSdWarps);
  return is_bf16
             ? (int)launch_ssd_decode_state<__nv_bfloat16>(
                   tpr, blocks, stream, h, x, b, c, dt, da, D, y, B, H, G,
                   P, N, st)
             : (int)launch_ssd_decode_state<float>(tpr, blocks, stream, h, x,
                                                   b, c, dt, da, D, y, B, H,
                                                   G, P, N, st);
}

}  // extern "C"
