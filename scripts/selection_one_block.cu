// K1's earlier design, kept to time the long route against (chip_smoke.py
// phase 22 builds it with kernels/build.py build_variant): the selection
// kernels as they stood before seg_topk's long route, where a row past the
// 24,576 lanes staged in shared memory runs through one block that reads
// the row from device memory again on every pass. Not built or loaded by
// the port.
//
// Selection-core kernels of the tiering tick, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the reference:
//   seg_topk     <- repro/kernels/select/kernel.py  seg_topk_tpu
//   seg_reduce   <- repro/kernels/select/kernel.py  seg_reduce_tpu
//   seg_sums     <- repro/kernels/select/kernel.py  seg_sums_tpu
//   commit_moves <- repro/kernels/migrate/kernel.py commit_moves_tpu
//
// All four move a few hundred kilobytes to a few megabytes and do a handful
// of integer operations per byte, so device-memory bytes bound them on this
// card, and at the tick's widths that bound is under a launch's fixed
// cost. The TPU versions carried a row block through VMEM; here one thread
// block owns one tenant row (blocks run in parallel, in no order), and every
// reduction across the row is a warp-shuffle tree plus one shared-memory
// hop across warps; commit_moves spreads its one stream over a cluster of
// blocks. Integer adds are done in unsigned arithmetic so that overflow
// wraps exactly as int32 does in the reference.
//
// Plain C interface: each launcher returns cudaGetLastError() right after
// its launch (0 on success), and the caller raises on anything else.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTopkThreads = 512;

// ------------------------------------------------------------ warp helpers
__device__ __forceinline__ unsigned warp_sum_u32(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned warp_incl_scan_u32(unsigned v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    unsigned n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Block-wide sum, result valid in every thread. Ends with a barrier.
__device__ unsigned block_sum_u32(unsigned v, unsigned* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum_u32(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < nw ? scratch[lane] : 0u;
    w = warp_sum_u32(w);
    if (lane == 0) scratch[32] = w;
  }
  __syncthreads();
  unsigned s = scratch[32];
  __syncthreads();
  return s;
}

// ---------------------------------------------------------------- seg_topk
// A 64-bit key whose unsigned order is (score desc, column asc): the high
// word is the float's bits mapped to an order-preserving unsigned, the low
// word the complemented column. -0.0 is folded into +0.0 so that equal
// floats tie on the column, as a float compare (and the reference) does.
__device__ __forceinline__ unsigned long long topk_key(float s, int col) {
  unsigned b = __float_as_uint(s == 0.0f ? 0.0f : s);
  unsigned ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)ord << 32) |
         (unsigned long long)(0xFFFFFFFFu - (unsigned)col);
}

// One block per tenant row, in three steps over the row's keys (staged in
// shared memory when 8 S bytes fit, else rebuilt from the row, which stays
// in L1/L2, on each pass):
//   1. count the eligible keys: r = min(max(quota, 0), k, eligible);
//   2. find the threshold key: keys are unique (the low word is the
//      column), so exactly r keys are >= the r-th largest. MSB-first 8-bit
//      digits: each pass builds a 256-bin histogram of the keys that still
//      match the chosen prefix, and a scan from the top bin picks the digit
//      that holds the r-th key. It stops as soon as every key under the
//      prefix is a winner, so distinct scores settle in the high (score)
//      word and ties go on into the low (column) word;
//   3. compact the winners into shared memory, bitonic-sort them by key,
//      descending, and write them out.
// Step 3 holds at most kTopkSortCap winners, so winners are taken in
// chunks of that many by rank: chunk c's threshold is the
// min(r, (c + 1) cap)-th key and its winners lie in [threshold, previous
// threshold). The tick's r <= 256 is one chunk. Integer counts only.
constexpr int kTopkSortCap = 2048;      // winners sorted at once (16 KiB)
constexpr int kTopkStageMax = 24576;    // S staged in shared memory (192 KiB)

__device__ __forceinline__ unsigned long long row_key(const float* srow,
                                                      const unsigned char* vrow,
                                                      int c) {
  const float s = srow[c];
  return (vrow[c] && isfinite(s)) ? topk_key(s, c) : 0ull;   // 0: not eligible
}

__global__ void __launch_bounds__(kTopkThreads)
seg_topk_kernel(const float* __restrict__ score,
                const unsigned char* __restrict__ valid,
                const int* __restrict__ quotas, int S, int k, int staged,
                int* __restrict__ cols, unsigned char* __restrict__ take,
                int* __restrict__ counts) {
  extern __shared__ unsigned long long topk_smem[];
  unsigned long long* sorted = topk_smem;                // [kTopkSortCap]
  unsigned long long* keys = topk_smem + kTopkSortCap;   // [S] when staged
  __shared__ unsigned hist[256];
  __shared__ unsigned scratch[33];
  __shared__ unsigned sel_digit, sel_above, sel_count, sel_fill;
  const int row = blockIdx.x;
  const float* srow = score + (size_t)row * S;
  const unsigned char* vrow = valid + (size_t)row * S;
  int* crow = cols + (size_t)row * k;
  unsigned char* trow = take + (size_t)row * k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  unsigned n_elig = 0u;
  for (int c = tid; c < S; c += blockDim.x) {
    const unsigned long long key = row_key(srow, vrow, c);
    if (staged) keys[c] = key;
    n_elig += key != 0ull;
  }
  n_elig = block_sum_u32(n_elig, scratch);   // its barriers publish keys[]
  const int q = quotas[row];
  int r = q < 0 ? 0 : (q < k ? q : k);
  if ((unsigned)r > n_elig) r = (int)n_elig;

  unsigned long long upper = ~0ull;   // keys of earlier chunks are >= upper
  for (int done = 0; done < r; done += kTopkSortCap) {
    const int m = min(kTopkSortCap, r - done);   // this chunk's winners
    // threshold of the (done + m)-th key: `need` keys still to place under
    // `prefix`, the digits chosen above bit `sh`
    unsigned need = (unsigned)(done + m);
    unsigned long long prefix = 0ull;
    int sh = 56;
    for (;; sh -= 8) {
      for (int i = tid; i < 256; i += blockDim.x) hist[i] = 0u;
      __syncthreads();
      for (int base = 0; base < S; base += blockDim.x) {
        const int c = base + tid;
        unsigned d = 256u;                                // no bin
        if (c < S) {
          const unsigned long long key =
              staged ? keys[c] : row_key(srow, vrow, c);
          if (key != 0ull && (sh == 56 || (key >> (sh + 8)) == prefix))
            d = (unsigned)(key >> sh) & 255u;
        }
        // one shared atomic per distinct bin of the warp: the high digits
        // of nearby scores collide
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        if (d != 256u && lane == __ffs(peers) - 1)
          atomicAdd(&hist[d], (unsigned)__popc(peers));
      }
      __syncthreads();
      if (warp == 0) {
        // lane l scans bins 255 - 8l down to 248 - 8l; a warp scan of the
        // lanes' sums gives the count of candidates above each lane
        unsigned h[8], sum = 0u;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          h[j] = hist[255 - 8 * lane - j];
          sum += h[j];
        }
        unsigned above = warp_incl_scan_u32(sum) - sum;
        if (above < need && need <= above + sum) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (above + h[j] >= need) {
              sel_digit = 255u - 8u * lane - j;
              sel_above = above;
              sel_count = h[j];
              break;
            }
            above += h[j];
          }
        }
      }
      __syncthreads();
      prefix = (prefix << 8) | sel_digit;
      need -= sel_above;
      // every key under prefix is a winner (at sh == 0 the prefix is one key)
      if (sel_count == need || sh == 0) break;
    }
    const unsigned long long thr = prefix << sh;

    // compact this chunk's winners: keys in [thr, upper)
    if (tid == 0) sel_fill = 0u;
    __syncthreads();
    for (int base = 0; base < S; base += blockDim.x) {
      const int c = base + tid;
      unsigned long long key = 0ull;
      if (c < S) key = staged ? keys[c] : row_key(srow, vrow, c);
      const bool win = key != 0ull && key >= thr && key < upper;
      const unsigned ballot = __ballot_sync(0xffffffffu, win);
      unsigned slot = 0u;
      if (lane == 0 && ballot) slot = atomicAdd(&sel_fill, __popc(ballot));
      slot = __shfl_sync(0xffffffffu, slot, 0);
      if (win) sorted[slot + __popc(ballot & ((1u << lane) - 1u))] = key;
    }
    int P = 1;
    while (P < m) P <<= 1;
    __syncthreads();
    for (int i = m + tid; i < P; i += blockDim.x) sorted[i] = 0ull;
    __syncthreads();
    // bitonic sort of P keys, descending (the zero pads sink to the end)
    for (int size = 2; size <= P; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < P / 2; i += blockDim.x) {
          const int lo = 2 * i - (i & (stride - 1));
          const unsigned long long a = sorted[lo], b = sorted[lo + stride];
          if (((lo & size) == 0) ? a < b : a > b) {
            sorted[lo] = b;
            sorted[lo + stride] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int i = tid; i < m; i += blockDim.x) {
      crow[done + i] =
          (int)(0xFFFFFFFFu - (unsigned)(sorted[i] & 0xFFFFFFFFull));
      trow[done + i] = 1;
    }
    upper = thr;
    __syncthreads();   // sorted[] is read before the next chunk refills it
  }
  for (int j = r + tid; j < k; j += blockDim.x) {
    crow[j] = S;
    trow[j] = 0;
  }
  if (tid == 0) counts[row] = r;
}

// ---------------------------------------------------------------- seg_sums
// Replaces repro/kernels/select/kernel.py seg_sums_tpu: masked int32 row
// sums. At C1's widths (T=64, S=4,096) the row data are 1.3 MB, a bound of
// 0.4 us at 3.35 TB/s, far below one launch's fixed cost, so what bounds it
// is latency: how many loads each thread has in flight before its first
// add, and how few barriers follow. Each thread takes units of four lanes,
// one 16-byte load of x and one 4-byte load of the matching valid bytes,
// kSumInflight units issued before any is added. A row whose start is not
// 16-byte aligned (S % 4 != 0) takes up to three lanes before the first
// aligned unit and the ragged tail one lane a thread; rows whose x and valid
// are out of phase (views at odd offsets) go one lane at a time.
constexpr int kSumInflight = 4;

__device__ __forceinline__ unsigned masked4(int4 x, unsigned v) {
  return ((v & 0xffu) ? (unsigned)x.x : 0u) +
         ((v & 0xff00u) ? (unsigned)x.y : 0u) +
         ((v & 0xff0000u) ? (unsigned)x.z : 0u) +
         ((v & 0xff000000u) ? (unsigned)x.w : 0u);
}

// This thread's share of one row's masked sum, for thread r of n.
__device__ __forceinline__ unsigned masked_row_sum(
    const int* __restrict__ xrow, const unsigned char* __restrict__ vrow,
    int S, int r, int n) {
  const unsigned px = (unsigned)((uintptr_t)xrow >> 2) & 3u;
  const unsigned pv = (unsigned)(uintptr_t)vrow & 3u;
  const int head = px == pv ? min((int)((4u - px) & 3u), S) : S;
  const int units = (S - head) >> 2;
  const int tail = head + 4 * units;
  unsigned acc = 0u;
  for (int c = r; c < head; c += n) {
    const unsigned xv = (unsigned)xrow[c];
    acc += vrow[c] ? xv : 0u;
  }
  for (int c = tail + r; c < S; c += n) {
    const unsigned xv = (unsigned)xrow[c];
    acc += vrow[c] ? xv : 0u;
  }
  const int4* x4 = reinterpret_cast<const int4*>(xrow + head);
  const unsigned* v4 = reinterpret_cast<const unsigned*>(vrow + head);
  for (int u = r; u < units; u += kSumInflight * n) {
    int4 xs[kSumInflight];
    unsigned vs[kSumInflight];
#pragma unroll
    for (int i = 0; i < kSumInflight; ++i) {
      const int w = u + i * n;
      xs[i] = w < units ? __ldg(x4 + w) : make_int4(0, 0, 0, 0);
      vs[i] = w < units ? __ldg(v4 + w) : 0u;
    }
#pragma unroll
    for (int i = 0; i < kSumInflight; ++i) acc += masked4(xs[i], vs[i]);
  }
  return acc;
}

// Block sum of one value per thread, valid in thread 0 only: one barrier.
__device__ __forceinline__ unsigned block_sum_to_first(unsigned v,
                                                       unsigned* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum_u32(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? scratch[lane] : 0u;
    v = warp_sum_u32(v);
  }
  return v;
}

// One block of 1,024 threads per row: at S=4,096 one unit a thread, all
// of the row's loads in flight at once, and one barrier. (A cluster per
// row meeting in distributed shared memory, which covers the card at
// T=64, took 0.0073 ms as 4 blocks of 256 threads and as 8 of 128 against
// this design's 0.0062 at C1's widths on an H100: the row is
// latency-bound either way, and the cluster barriers cost more than the
// extra SMs gain.)
constexpr int kSumThreads = 1024;

__global__ void __launch_bounds__(kSumThreads)
seg_sums_kernel(const int* __restrict__ x,
                const unsigned char* __restrict__ valid, int S,
                int* __restrict__ sums) {
  __shared__ unsigned scratch[32];
  const size_t row = blockIdx.x;
  unsigned acc = masked_row_sum(x + row * S, valid + row * S, S,
                                threadIdx.x, blockDim.x);
  acc = block_sum_to_first(acc, scratch);
  if (threadIdx.x == 0) sums[row] = (int)acc;
}

// -------------------------------------------------------------- seg_reduce
// Replaces repro/kernels/select/kernel.py seg_reduce_tpu: the masked int32
// row sums and each row's exclusive prefix. At C1's widths (T=64,
// S=4,096) it reads 1.3 MB and writes 1 MB, a bound of 0.7 us at 3.35
// TB/s, under one launch's fixed cost, so latency bounds it: loads in
// flight before the first add, and barriers. One block of 1,024 threads
// per row, one scan: thread r owns a run of consecutive 4-lane units (one
// at S=4,096; longer rows get longer runs), issues all of a run's loads
// (16-byte loads of x, 4-byte loads of the matching valid bytes; up to
// kReduceInflight units at once, held in registers) before its first
// add, and one block exclusive scan of the run totals gives every run its
// first prefix. The thread then writes its lanes' prefixes, as 16-byte
// stores where the prefix row is aligned alike. The lanes before x's
// first 16-byte boundary go to thread 0, ahead of its run, and the ragged
// tail to the last thread, after its run; rows whose x and valid are out
// of phase go lane by lane in run order. Runs longer than the registers
// hold read their units again for the stores.
constexpr int kReduceThreads = 1024;
constexpr int kReduceInflight = 4;

// The exclusive prefixes of a unit from *run on, as one int4; advances
// *run past it.
__device__ __forceinline__ int4 unit_prefix(int4 x, unsigned v,
                                            unsigned* run) {
  int4 o;
  o.x = (int)*run;
  *run += (v & 0xffu) ? (unsigned)x.x : 0u;
  o.y = (int)*run;
  *run += (v & 0xff00u) ? (unsigned)x.y : 0u;
  o.z = (int)*run;
  *run += (v & 0xff0000u) ? (unsigned)x.z : 0u;
  o.w = (int)*run;
  *run += (v & 0xff000000u) ? (unsigned)x.w : 0u;
  return o;
}

__global__ void __launch_bounds__(kReduceThreads)
seg_reduce_kernel(const int* __restrict__ x,
                  const unsigned char* __restrict__ valid, int S,
                  int* __restrict__ sums, int* __restrict__ prefix) {
  __shared__ unsigned scratch[32];
  const int n = blockDim.x, r = threadIdx.x;
  const int lane = r & 31, warp = r >> 5, nw = n >> 5;
  const size_t row = blockIdx.x;
  const int* xrow = x + row * S;
  const unsigned char* vrow = valid + row * S;
  int* prow = prefix + row * S;
  const unsigned px = (unsigned)((uintptr_t)xrow >> 2) & 3u;
  const unsigned pv = (unsigned)(uintptr_t)vrow & 3u;
  // this thread's lanes: [a0, a1) one at a time, units [u0, u1), then
  // [b0, b1) one at a time
  int head = 0, a0, a1, u0 = 0, u1 = 0, b0 = 0, b1 = 0;
  if (px == pv) {
    head = min((int)((4u - px) & 3u), S);
    const int units = (S - head) >> 2;
    const int run = (units + n - 1) / n;
    a0 = 0;
    a1 = r == 0 ? head : 0;
    u0 = min(r * run, units);
    u1 = min(u0 + run, units);
    b0 = head + 4 * units;
    b1 = r == n - 1 ? S : b0;
  } else {
    const int run = (S + n - 1) / n;
    a0 = min(r * run, S);
    a1 = min(a0 + run, S);
  }
  const int4* x4 = reinterpret_cast<const int4*>(xrow + head);
  const unsigned* v4 = reinterpret_cast<const unsigned*>(vrow + head);
  const int nu = u1 - u0;
  const bool held = nu <= kReduceInflight;

  // 1. the run's total, every load issued before the first add
  int4 xs[kReduceInflight];
  unsigned vs[kReduceInflight];
  unsigned tot = 0u;
  for (int c = a0; c < a1; ++c) tot += vrow[c] ? (unsigned)xrow[c] : 0u;
  for (int u = u0; u < u1; u += kReduceInflight) {
#pragma unroll
    for (int i = 0; i < kReduceInflight; ++i) {
      const bool in = u + i < u1;
      xs[i] = in ? __ldg(x4 + u + i) : make_int4(0, 0, 0, 0);
      vs[i] = in ? __ldg(v4 + u + i) : 0u;
    }
#pragma unroll
    for (int i = 0; i < kReduceInflight; ++i) tot += masked4(xs[i], vs[i]);
  }
  for (int c = b0; c < b1; ++c) tot += vrow[c] ? (unsigned)xrow[c] : 0u;

  // 2. one exclusive scan of the run totals: a warp scan, then every warp
  // scans the warp totals itself (one barrier)
  const unsigned inc = warp_incl_scan_u32(tot);
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  const unsigned wsc = warp_incl_scan_u32(lane < nw ? scratch[lane] : 0u);
  const unsigned total = __shfl_sync(0xffffffffu, wsc, nw - 1);
  const unsigned wbase = __shfl_sync(0xffffffffu, wsc, warp > 0 ? warp - 1
                                                                : 0);
  unsigned run = (warp > 0 ? wbase : 0u) + inc - tot;
  if (r == 0) sums[row] = (int)total;

  // 3. the prefixes, in lane order
  for (int c = a0; c < a1; ++c) {
    prow[c] = (int)run;
    run += vrow[c] ? (unsigned)xrow[c] : 0u;
  }
  const bool pvec = (((uintptr_t)(prow + head)) & 15u) == 0;
  int4* p4 = reinterpret_cast<int4*>(prow + head);
  for (int u = u0; u < u1; u += kReduceInflight) {
    if (!held) {
#pragma unroll
      for (int i = 0; i < kReduceInflight; ++i) {
        const bool in = u + i < u1;
        xs[i] = in ? __ldg(x4 + u + i) : make_int4(0, 0, 0, 0);
        vs[i] = in ? __ldg(v4 + u + i) : 0u;
      }
    }
#pragma unroll
    for (int i = 0; i < kReduceInflight; ++i) {
      if (u + i >= u1) break;
      const int4 o = unit_prefix(xs[i], vs[i], &run);
      if (pvec) {
        p4[u + i] = o;
      } else {
        int* q = prow + head + 4 * (u + i);
        q[0] = o.x;
        q[1] = o.y;
        q[2] = o.z;
        q[3] = o.w;
      }
    }
  }
  for (int c = b0; c < b1; ++c) {
    prow[c] = (int)run;
    run += vrow[c] ? (unsigned)xrow[c] : 0u;
  }
}

// ------------------------------------------------------------ commit_moves
// Replaces repro/kernels/migrate/kernel.py commit_moves_tpu: the tier
// scatter of the taken lanes of a compact move stream and the newest-C-wins
// ring append at floor_mod(head + offset, C). At C1's widths (N = 16,384
// lanes, C = 4,096) it moves about 0.3 MB, a bound of 0.1 us, under one
// launch's fixed cost. What bounds it is latency (the loads on the way to
// each lane's offset, the barriers of the scan that hands them out) and
// the scattered stores, a tier word and a 20-byte ring row per taken lane,
// which one SM issues at about one 32-byte sector a cycle: from one block
// they take 0.0366 ms at half the lanes taken on an H100.
//
// One pass of the stream by one thread-block cluster of up to 16 blocks of
// 64 threads, so that C1's stores spread over 16 SMs. Each thread owns a
// run of `run` consecutive lanes (a multiple of 16; 16 at C1, one 16-byte
// load of take), counts its taken lanes with __popc and, when it has any,
// loads its first 16 lanes' pages, tenants and hot bits (16-byte loads)
// before the scan. One exclusive scan of the run counts gives each run its
// first offset and the total, so keep_from = total - C is known before any
// store: a block scan (one barrier: every warp scans the warp totals
// itself), then the blocks' totals, read from each block's shared memory
// through distributed shared memory after one cluster barrier; a release
// arrive after those reads, waited on at the end, keeps each block
// resident until no other block's load of its shared memory is in
// flight. The thread
// then commits its taken lanes in order: tier[page], and for
// off >= keep_from the ring row (one floor mod a run; the kept lanes'
// slots then step by one). Longer streams (N > 16,384) lengthen the runs,
// so the pass stays one scan for any N. Slots of the kept window are
// distinct and pages of taken lanes are distinct, so no two lanes store to
// one address. Unaligned pointers and a run cut by N go lane by lane.
// `head` stays on the device.
constexpr int kMoveGroup = 16;      // lanes per 16-byte load of take
constexpr int kMoveThreads = 64;
constexpr int kMoveCluster = 16;    // above 8: a non-portable cluster size

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Bit k set where byte k of w is non-zero.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  const unsigned m = __vcmpne4(w, 0u) & 0x01010101u;
  return (m | m >> 7 | m >> 14 | m >> 21) & 0xfu;
}

// The taken lanes of [j, min(j + 16, hi)) as a mask, bit i for lane j + i.
__device__ __forceinline__ unsigned take_mask(
    const unsigned char* __restrict__ take, int j, int hi, bool vec) {
  if (vec && j + kMoveGroup <= hi) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(take + j));
    return nonzero_bytes(w.x) | nonzero_bytes(w.y) << 4 |
           nonzero_bytes(w.z) << 8 | nonzero_bytes(w.w) << 12;
  }
  unsigned m = 0u;
  for (int i = 0; i < kMoveGroup && j + i < hi; ++i)
    m |= (take[j + i] ? 1u : 0u) << i;
  return m;
}

// Lanes [j, j + 16) of p (0 past hi).
__device__ __forceinline__ void load_group(const int* __restrict__ p, int j,
                                           int hi, bool vec,
                                           int (&out)[kMoveGroup]) {
  if (vec && j + kMoveGroup <= hi) {
    const int4* q = reinterpret_cast<const int4*>(p + j);
#pragma unroll
    for (int g = 0; g < kMoveGroup / 4; ++g) {
      const int4 v = __ldg(q + g);
      out[4 * g] = v.x;
      out[4 * g + 1] = v.y;
      out[4 * g + 2] = v.z;
      out[4 * g + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kMoveGroup; ++i)
      out[i] = j + i < hi ? __ldg(p + j + i) : 0;
  }
}

struct MoveArgs {
  int* tier;
  int L;
  int* ring;
  int C;
  int head;
  int keep_from;
  int t, direction, to_tier;
};

// Commit the taken lanes of one group (mask m) from offset *off on. *slot
// is the ring slot of the thread's last kept lane (-1 before its first):
// the kept lanes of a run have consecutive offsets, so only the first
// takes a floor mod and the rest step by one.
__device__ __forceinline__ void commit_group(
    const MoveArgs& a, unsigned m, unsigned* off, int* slot,
    const int (&pg)[kMoveGroup], const int (&tn)[kMoveGroup],
    const int (&hb)[kMoveGroup]) {
#pragma unroll
  for (int i = 0; i < kMoveGroup; ++i) {
    if (!((m >> i) & 1u)) continue;
    const int page = pg[i];
    if (page >= 0 && page < a.L) a.tier[page] = a.to_tier;
    if ((int)*off >= a.keep_from) {
      if (*slot < 0) {
        const int s = (int)((unsigned)a.head + *off);     // int32 wrap
        *slot = s % a.C;
        if (*slot < 0) *slot += a.C;                       // floor mod
      } else if (++*slot == a.C) {
        *slot = 0;
      }
      int* r = a.ring + (size_t)*slot * 5;
      r[0] = a.t;
      r[1] = tn[i];
      r[2] = page;
      r[3] = a.direction;
      r[4] = hb[i];
    }
    *off += 1u;
  }
}

__global__ void __launch_bounds__(kMoveThreads)
commit_moves_kernel(int* __restrict__ tier, int L, int* __restrict__ ring,
                    int C, const int* __restrict__ head_in,
                    int* __restrict__ head_out,
                    const int* __restrict__ pages,
                    const unsigned char* __restrict__ take,
                    const int* __restrict__ tenants,
                    const int* __restrict__ hot_bits, int N, int run, int t,
                    int direction, int to_tier) {
  __shared__ unsigned scratch[32];
  __shared__ unsigned block_total;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned cs = cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const bool vec = ((((uintptr_t)take) | ((uintptr_t)pages) |
                     ((uintptr_t)tenants) | ((uintptr_t)hot_bits)) & 15u) == 0;
  const long long first =
      ((long long)rank * blockDim.x + threadIdx.x) * (long long)run;
  const int lo = (int)min(first, (long long)N);
  const int hi = (int)min((long long)lo + run, (long long)N);
  const int head = __ldg(head_in);

  // 1. count the run; hold its first group's lanes in registers
  const unsigned m0 = lo < hi ? take_mask(take, lo, hi, vec) : 0u;
  unsigned cnt = __popc(m0);
  for (int j = lo + kMoveGroup; j < hi; j += kMoveGroup)
    cnt += __popc(take_mask(take, j, hi, vec));
  int pg[kMoveGroup], tn[kMoveGroup], hb[kMoveGroup];
  if (m0) {
    load_group(pages, lo, hi, vec, pg);
    load_group(tenants, lo, hi, vec, tn);
    load_group(hot_bits, lo, hi, vec, hb);
  }

  // 2. one exclusive scan of the run counts: within the block, then over
  // the cluster's block totals
  const unsigned inc = warp_incl_scan_u32(cnt);
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  const unsigned wsc = warp_incl_scan_u32(lane < nw ? scratch[lane] : 0u);
  const unsigned btot = __shfl_sync(0xffffffffu, wsc, nw - 1);
  if (threadIdx.x == 0) block_total = btot;
  const unsigned wbase = warp > 0 ? __shfl_sync(0xffffffffu, wsc, warp - 1)
                                  : 0u;
  cluster_arrive();
  cluster_wait();                       // every block's total is published
  const unsigned bt = lane < (int)cs
      ? *cluster.map_shared_rank(&block_total, (unsigned)lane) : 0u;
  const unsigned bsc = warp_incl_scan_u32(bt);
  const unsigned total = __shfl_sync(0xffffffffu, bsc, cs - 1);
  const unsigned bbase = rank > 0 ? __shfl_sync(0xffffffffu, bsc, rank - 1)
                                  : 0u;
  // done reading the other blocks: a release arrive orders the remote loads
  // before it, so no block passes the final wait (and exits) while a load
  // of its shared memory is still in flight
  cluster_arrive();
  unsigned off = bbase + wbase + inc - cnt;
  int slot = -1;
  const MoveArgs a{tier, L, ring, C, head, (int)total - C, t, direction,
                   to_tier};

  // 3. commit the run's taken lanes in order
  if (m0) commit_group(a, m0, &off, &slot, pg, tn, hb);
  for (int j = lo + kMoveGroup; j < hi; j += kMoveGroup) {
    const unsigned m = take_mask(take, j, hi, vec);
    if (!m) continue;
    load_group(pages, j, hi, vec, pg);
    load_group(tenants, j, hi, vec, tn);
    load_group(hot_bits, j, hi, vec, hb);
    commit_group(a, m, &off, &slot, pg, tn, hb);
  }
  if (rank == 0 && threadIdx.x == 0)
    *head_out = (int)((unsigned)head + total);
  cluster_wait();        // no block leaves while another reads its total
}

// -------------------------------------------------------------- launch floor
// Does nothing: its time is the fixed cost of one launch, the floor under
// the tick kernels' sub-microsecond bounds.
__global__ void empty_kernel() {}

}  // namespace

extern "C" {

const char* selection_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int seg_topk_launch(const float* score, const unsigned char* valid,
                    const int* quotas, int T, int S, int k, int* cols,
                    unsigned char* take, int* counts, cudaStream_t stream) {
  if (T <= 0) return (int)cudaGetLastError();
  const int staged = S <= kTopkStageMax;
  const size_t smem = sizeof(unsigned long long) *
                      ((size_t)kTopkSortCap + (staged ? (size_t)S : 0));
  // the default cap on dynamic shared memory is 48 KiB less the static
  // part, which a staged row of 4,096 already exceeds
  const cudaError_t e = cudaFuncSetAttribute(
      seg_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  seg_topk_kernel<<<T, kTopkThreads, smem, stream>>>(
      score, valid, quotas, S, k, staged, cols, take, counts);
  return (int)cudaGetLastError();
}

int seg_reduce_launch(const int* x, const unsigned char* valid, int T, int S,
                      int* sums, int* prefix, cudaStream_t stream) {
  if (T > 0)
    seg_reduce_kernel<<<T, kReduceThreads, 0, stream>>>(x, valid, S, sums,
                                                        prefix);
  return (int)cudaGetLastError();
}

int seg_sums_launch(const int* x, const unsigned char* valid, int T, int S,
                    int* sums, cudaStream_t stream) {
  if (T > 0) seg_sums_kernel<<<T, kSumThreads, 0, stream>>>(x, valid, S, sums);
  return (int)cudaGetLastError();
}

int commit_moves_launch(int* tier, int L, int* ring, int C,
                        const int* head_in, int* head_out, const int* pages,
                        const unsigned char* take, const int* tenants,
                        const int* hot_bits, int N, int t, int direction,
                        int to_tier, cudaStream_t stream) {
  // one thread per 16 lanes on up to kMoveCluster blocks, then longer runs
  const int groups = (int)(((long long)N + kMoveGroup - 1) / kMoveGroup);
  int blocks = (groups + kMoveThreads - 1) / kMoveThreads;
  blocks = blocks < 1 ? 1 : blocks > kMoveCluster ? kMoveCluster : blocks;
  const int runs = (groups + blocks * kMoveThreads - 1) /
                   (blocks * kMoveThreads);
  const int run = kMoveGroup * (runs < 1 ? 1 : runs);
  if (kMoveCluster > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        commit_moves_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kMoveThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, commit_moves_kernel, tier, L, ring, C, head_in, head_out, pages,
      take, tenants, hot_bits, N, run, t, direction, to_tier);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

int empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
