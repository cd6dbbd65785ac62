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
__device__ __forceinline__ unsigned long long warp_max_u64(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

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

// One block per tenant row. Round j takes the best eligible column strictly
// after round j-1's winner in key order, so the row is never rewritten and
// any S works without shared-memory limits. Rounds = min(max(quota, 0), k);
// the loop stops early when the row runs out of eligible columns. The row
// (S floats + S flags) stays in L1 across rounds.
__global__ void __launch_bounds__(kTopkThreads)
seg_topk_kernel(const float* __restrict__ score,
                const unsigned char* __restrict__ valid,
                const int* __restrict__ quotas, int S, int k,
                int* __restrict__ cols, unsigned char* __restrict__ take,
                int* __restrict__ counts) {
  __shared__ unsigned long long warp_best[32];
  __shared__ unsigned long long round_best;
  const int row = blockIdx.x;
  const float* srow = score + (size_t)row * S;
  const unsigned char* vrow = valid + (size_t)row * S;
  int* crow = cols + (size_t)row * k;
  unsigned char* trow = take + (size_t)row * k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;

  const int q = quotas[row];
  const int rounds = q < 0 ? 0 : (q < k ? q : k);
  unsigned long long prev = ~0ull;
  int taken = 0;
  for (int j = 0; j < rounds; ++j) {
    unsigned long long best = 0ull;   // 0 = nothing eligible left
    for (int c = threadIdx.x; c < S; c += blockDim.x) {
      float s = srow[c];
      if (vrow[c] && isfinite(s)) {
        unsigned long long key = topk_key(s, c);
        if (key < prev && key > best) best = key;
      }
    }
    best = warp_max_u64(best);
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    if (warp == 0) {
      unsigned long long v = lane < nw ? warp_best[lane] : 0ull;
      v = warp_max_u64(v);
      if (lane == 0) round_best = v;
    }
    __syncthreads();
    best = round_best;   // read by all before warp 0 can write it again
    if (best == 0ull) break;
    if (threadIdx.x == 0) {
      crow[j] = (int)(0xFFFFFFFFu - (unsigned)(best & 0xFFFFFFFFull));
      trow[j] = 1;
    }
    prev = best;
    ++taken;
  }
  for (int j = taken + threadIdx.x; j < k; j += blockDim.x) {
    crow[j] = S;
    trow[j] = 0;
  }
  if (threadIdx.x == 0) counts[row] = taken;
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
  if (T > 0)
    seg_topk_kernel<<<T, kTopkThreads, 0, stream>>>(score, valid, quotas, S,
                                                    k, cols, take, counts);
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
