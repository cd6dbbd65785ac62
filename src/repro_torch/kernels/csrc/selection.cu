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
// card. The TPU versions carried a row block through VMEM; here one thread
// block owns one tenant row (blocks run in parallel, in no order), and every
// reduction across the row is a warp-shuffle tree plus one shared-memory
// hop across warps. Integer adds are done in unsigned arithmetic so that
// overflow wraps exactly as int32 does in the reference.
//
// Plain C interface: each launcher returns cudaGetLastError() right after
// its launch (0 on success), and the caller raises on anything else.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTopkThreads = 512;
constexpr int kScanThreads = 1024;
constexpr int kSumThreads = 256;

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

// Block-wide inclusive scan of one value per thread (blockDim.x a multiple
// of 32). Returns this thread's inclusive prefix; *total gets the block sum.
// Ends with a barrier, so `scratch` may be reused right after.
__device__ unsigned block_incl_scan_u32(unsigned v, unsigned* scratch,
                                        unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  unsigned inc = warp_incl_scan_u32(v);
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < nw ? scratch[lane] : 0u;
    scratch[lane] = warp_incl_scan_u32(w);
  }
  __syncthreads();
  unsigned base = warp > 0 ? scratch[warp - 1] : 0u;
  *total = scratch[31];
  __syncthreads();
  return base + inc;
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

// -------------------------------------------------------------- seg_reduce
// One block per row: chunked block scan with a running carry. Writes the
// exclusive prefix of the masked row and the row total.
__global__ void __launch_bounds__(kScanThreads)
seg_reduce_kernel(const int* __restrict__ x,
                  const unsigned char* __restrict__ valid, int S,
                  int* __restrict__ sums, int* __restrict__ prefix) {
  __shared__ unsigned scratch[32];
  const int row = blockIdx.x;
  const int* xrow = x + (size_t)row * S;
  const unsigned char* vrow = valid + (size_t)row * S;
  int* prow = prefix + (size_t)row * S;
  unsigned carry = 0u;
  for (int base = 0; base < S; base += blockDim.x) {
    const int c = base + threadIdx.x;
    unsigned v = (c < S && vrow[c]) ? (unsigned)xrow[c] : 0u;
    unsigned chunk_total;
    unsigned inc = block_incl_scan_u32(v, scratch, &chunk_total);
    if (c < S) prow[c] = (int)(carry + inc - v);
    carry += chunk_total;
  }
  if (threadIdx.x == 0) sums[row] = (int)carry;
}

// ---------------------------------------------------------------- seg_sums
__global__ void __launch_bounds__(kSumThreads)
seg_sums_kernel(const int* __restrict__ x,
                const unsigned char* __restrict__ valid, int S,
                int* __restrict__ sums) {
  __shared__ unsigned scratch[33];
  const int row = blockIdx.x;
  const int* xrow = x + (size_t)row * S;
  const unsigned char* vrow = valid + (size_t)row * S;
  unsigned acc = 0u;
  for (int c = threadIdx.x; c < S; c += blockDim.x)
    if (vrow[c]) acc += (unsigned)xrow[c];
  acc = block_sum_u32(acc, scratch);
  if (threadIdx.x == 0) sums[row] = (int)acc;
}

// ------------------------------------------------------------ commit_moves
// One block walks the N-lane move stream twice: first to count the taken
// lanes (total), then with a chunked exclusive scan that gives each taken
// lane its offset; the lane writes tier[page] and, when it is among the
// newest C, its ring row at slot floor_mod(head + off, C). Slots of the
// kept window are distinct, pages of taken lanes are distinct, so no two
// lanes store to one address. `head` stays on the device.
__global__ void __launch_bounds__(kScanThreads)
commit_moves_kernel(int* __restrict__ tier, int L, int* __restrict__ ring,
                    int C, const int* __restrict__ head_in,
                    int* __restrict__ head_out,
                    const int* __restrict__ pages,
                    const unsigned char* __restrict__ take,
                    const int* __restrict__ tenants,
                    const int* __restrict__ hot_bits, int N, int t,
                    int direction, int to_tier) {
  __shared__ unsigned scratch[33];
  unsigned cnt = 0u;
  for (int i = threadIdx.x; i < N; i += blockDim.x) cnt += take[i] ? 1u : 0u;
  const unsigned total = block_sum_u32(cnt, scratch);
  const int head = *head_in;
  const int keep_from = (int)total - C;
  unsigned carry = 0u;
  for (int base = 0; base < N; base += blockDim.x) {
    const int i = base + threadIdx.x;
    unsigned v = (i < N && take[i]) ? 1u : 0u;
    unsigned chunk_total;
    unsigned inc = block_incl_scan_u32(v, scratch, &chunk_total);
    if (v) {
      const int off = (int)(carry + inc - 1u);
      const int page = pages[i];
      if (page >= 0 && page < L) tier[page] = to_tier;
      if (off >= keep_from) {
        int s = (int)((unsigned)head + (unsigned)off);   // int32 wrap
        int slot = s % C;
        if (slot < 0) slot += C;                         // floor mod
        int* r = ring + (size_t)slot * 5;
        r[0] = t;
        r[1] = tenants[i];
        r[2] = page;
        r[3] = direction;
        r[4] = hot_bits[i];
      }
    }
    carry += chunk_total;
  }
  if (threadIdx.x == 0) *head_out = (int)((unsigned)head + total);
}

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
    seg_reduce_kernel<<<T, kScanThreads, 0, stream>>>(x, valid, S, sums,
                                                      prefix);
  return (int)cudaGetLastError();
}

int seg_sums_launch(const int* x, const unsigned char* valid, int T, int S,
                    int* sums, cudaStream_t stream) {
  if (T > 0)
    seg_sums_kernel<<<T, kSumThreads, 0, stream>>>(x, valid, S, sums);
  return (int)cudaGetLastError();
}

int commit_moves_launch(int* tier, int L, int* ring, int C,
                        const int* head_in, int* head_out, const int* pages,
                        const unsigned char* take, const int* tenants,
                        const int* hot_bits, int N, int t, int direction,
                        int to_tier, cudaStream_t stream) {
  commit_moves_kernel<<<1, kScanThreads, 0, stream>>>(
      tier, L, ring, C, head_in, head_out, pages, take, tenants, hot_bits, N,
      t, direction, to_tier);
  return (int)cudaGetLastError();
}

}  // extern "C"
