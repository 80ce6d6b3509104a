// The epsilon-auction's round (Bertsekas 1988, with block bidding) as one
// kernel, for B instances at once, on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's round (adaptive_mcmc_tpu/
// metrics/assignment.py) is gather- and scatter-free XLA.  The port's plain
// PyTorch round, auction_round_reference in
// adaptive_mcmc_tpu_torch/ops/cuda/auction.py, is some 60 small kernels; a
// round's data sits in L2 at the grading shapes, so that round was bound by
// its launches.  This kernel gives the same bits after every round.
//
// One round, per instance b (benefit (B, n, m), n <= m, all float32):
//   - the bidders are the first K = min(block, n) unassigned rows
//     (row_to_col[b, i] < 0), in ascending order;
//   - a bidder i takes v = benefit[b, i, :] - prices[b, :], the lowest
//     column j1 among the maxima of v, v1 = v[j1], v2 the maximum over the
//     other columns (-inf where m = 1), and bids
//     (prices[b, j1] + (v1 - v2)) + eps;
//   - a column goes to its highest bid, the lowest row among equal bids; a
//     column whose highest bid is +inf takes nothing;
//   - the column's previous owner returns to the pool, the winner takes the
//     column and the column's price becomes the bid;
//   - live[b] counts the rounds in which b had an unassigned row.
// The arithmetic is the plain round's: two float subtractions and two
// additions, in that order, and comparisons (build with -fmad=false; there
// is no product to contract anyway).  The sign of a zero never reaches a
// result: eps > 0, so a bid is never -0, and v1 - v2 enters only through a
// sum with eps.
//
// Layout: grid (T, B), blocks of kWarps warps.  A block serves kWarps / G
// consecutive bidder slots of one instance, G warps per bidder; T covers
// the K slots.  G follows what the caller sees (the wrapper's rule: more
// warps per bidder when the bidders are few and the rows long), so the
// endgame's 16 bidders of a 10000-column row do not wait on one warp.
//  1. Rank.  Each block ranks its instance's unassigned rows in passes of
//     kThreads * kScanRows rows (a ballot per 32 rows, a prefix over the
//     warps in shared memory) until it has seen its own slots, and keeps
//     the rows of its slots.  Every block of the instance repeats the scan
//     of the rows before its slots; at n = 10000 that is at most five
//     passes over 80 KB of L2.
//  2. Bid.  The warps of a bidder read its benefit row and the prices,
//     coalesced (float4 where m % 4 == 0 and the rows are 16-byte aligned),
//     each lane keeping the top two of its columns in ascending order, and
//     merge them: by the warp's shuffles, then across the bidder's warps in
//     shared memory.  The bid goes to a per-slot record (row, j1, bid) and,
//     as one 64-bit atomicMax, into the key of column j1: the bid's
//     order-preserving bits high, 0xFFFFFFFF - row low, so the largest key
//     is the highest bid of the lowest row among equal ones, in any order
//     of the atomics.  Keys start at 0, below every bid's key.
//  3. Apply.  Each block counts itself done on a per-instance counter after
//     a fence; the last block of the instance reads every slot record and
//     key, and the slot whose row holds its column's key (with a finite
//     bid) displaces the column's owner, takes the column and sets its
//     price.  A column has one winner and a displaced owner bids on
//     nothing (it was assigned), so no two threads write one entry.  It
//     then zeroes the keys it read and the counter for the next round, and
//     bumps live[b].
//
// Bound: memory.  A round reads K benefit rows, the prices and the
// assignment once: 4 K m + 4 m + 8 (n + 1) bytes per instance, against
// about 2 K m float operations.  At the grading shapes (B = 8, n = m = 625)
// those bytes are in L2 and a round is a launch and three dependent steps;
// at n = 10000 the wide tier reads 40 KB rows from device memory
// (PERF.md section 6 has both).

#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kScanRows = 8;          // rows a lane ranks per pass
constexpr unsigned kFull = 0xffffffffu;

// order-preserving bits: a < b as floats <=> bits(a) < bits(b) as unsigned;
// -0 and +0 share one
__device__ __forceinline__ unsigned order_bits(float x) {
  const unsigned u = x == 0.0f ? 0u : __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

struct Top2 {
  float v1;   // the best value
  float v2;   // the best over the other columns
  int j1;     // the lowest column holding v1
};

// one column more; a lane's columns arrive in ascending order, so an equal
// value never displaces j1 and goes to v2
__device__ __forceinline__ void take(Top2& t, float v, int j) {
  if (v > t.v1) {
    t.v2 = t.v1;
    t.v1 = v;
    t.j1 = j;
  } else if (v > t.v2) {
    t.v2 = v;
  }
}

// the top two of two disjoint sets of columns
__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  const bool a_first = a.v1 > b.v1 || (a.v1 == b.v1 && a.j1 < b.j1);
  Top2 w = a_first ? a : b;
  const float other = a_first ? b.v1 : a.v1;
  if (other > w.v2) w.v2 = other;
  return w;
}

__device__ __forceinline__ Top2 warp_merge(Top2 t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top2 o;
    o.v1 = __shfl_xor_sync(kFull, t.v1, off);
    o.v2 = __shfl_xor_sync(kFull, t.v2, off);
    o.j1 = __shfl_xor_sync(kFull, t.j1, off);
    t = merge(t, o);
  }
  return t;
}

__global__ void __launch_bounds__(kThreads)
auction_round_kernel(const float* __restrict__ benefit, float* prices,
                     int64_t* row_to_col, int64_t* col_owner,
                     const float* __restrict__ eps_ptr, int64_t* live,
                     unsigned long long* keys, int* slots, unsigned* done,
                     int n, int m, int K, int G, int vec) {
  __shared__ int s_row[kWarps];
  __shared__ int s_count[kWarps];
  __shared__ Top2 s_top[kWarps];
  __shared__ int s_last;

  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per_block = kWarps / G;
  const int s0 = blockIdx.x * per_block;
  const int s1 = min(s0 + per_block, K);
  int64_t* r2c = row_to_col + (size_t)b * (n + 1);
  float* price = prices + (size_t)b * m;
  int64_t* owner = col_owner + (size_t)b * m;
  unsigned long long* key = keys + (size_t)b * m;
  int* slot = slots + (size_t)b * n * 3;        // (row, j1, bid bits)

  // 1. the rows of slots [s0, s1): rank the unassigned rows in order
  if (tid < kWarps) s_row[tid] = -1;
  __syncthreads();
  int seen = 0;                                  // the same in every thread
  for (int base = 0; base < n && seen < s1; base += kThreads * kScanRows) {
    const int first = base + warp * 32 * kScanRows;
    unsigned mask[kScanRows];
    int in_warp = 0;
#pragma unroll
    for (int k = 0; k < kScanRows; ++k) {
      const int r = first + k * 32 + lane;
      mask[k] = __ballot_sync(kFull, r < n && r2c[r] < 0);
      in_warp += __popc(mask[k]);
    }
    if (lane == 0) s_count[warp] = in_warp;
    __syncthreads();
    int rank = seen, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_count[w];
      rank += w < warp ? c : 0;
      total += c;
    }
#pragma unroll
    for (int k = 0; k < kScanRows; ++k) {
      const int mine = rank + __popc(mask[k] & ((1u << lane) - 1u));
      if (((mask[k] >> lane) & 1u) && mine >= s0 && mine < s1)
        s_row[mine - s0] = first + k * 32 + lane;
      rank += __popc(mask[k]);
    }
    seen += total;
    __syncthreads();
  }

  // 2. bid: G warps per bidder
  const int bidder = warp / G, part = warp % G;
  const int k = s0 + bidder;
  const int row = k < s1 ? s_row[bidder] : -1;
  Top2 t{-INFINITY, -INFINITY, INT_MAX};
  if (row >= 0) {
    const float* br = benefit + ((size_t)b * n + row) * m;
    if (vec) {
      const float4* b4 = reinterpret_cast<const float4*>(br);
      const float4* p4 = reinterpret_cast<const float4*>(price);
#pragma unroll 4
      for (int q = part * 32 + lane; q < m / 4; q += 32 * G) {
        const float4 x = b4[q], y = p4[q];
        take(t, x.x - y.x, 4 * q);
        take(t, x.y - y.y, 4 * q + 1);
        take(t, x.z - y.z, 4 * q + 2);
        take(t, x.w - y.w, 4 * q + 3);
      }
    } else {
#pragma unroll 4
      for (int j = part * 32 + lane; j < m; j += 32 * G)
        take(t, br[j] - price[j], j);
    }
    t = warp_merge(t);
  }
  if (lane == 0) s_top[warp] = t;
  __syncthreads();
  if (part == 0 && lane == 0 && k < s1) {
    if (row >= 0) {
      for (int g = 1; g < G; ++g) t = merge(t, s_top[warp + g]);
      // a row with no value above -inf (all NaN or -inf; the host refuses
      // such costs) keeps j1 past the last column and bids on nothing
      int c = -1;
      float bid = NAN;
      if (t.j1 < m) {
        c = t.j1;
        bid = (price[c] + (t.v1 - t.v2)) + *eps_ptr;
        atomicMax(&key[c], ((unsigned long long)order_bits(bid) << 32)
                               | (0xffffffffu - (unsigned)row));
      }
      slot[3 * k + 1] = c;
      slot[3 * k + 2] = __float_as_int(bid);
    }
    slot[3 * k] = row;
  }

  // 3. the instance's last block applies the round
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&done[b], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  volatile int* vslot = slot;
  volatile unsigned long long* vkey = key;
  for (int i = tid; i < K; i += kThreads) {
    const int r = vslot[3 * i];
    const int c = vslot[3 * i + 1];
    if (r < 0 || c < 0) continue;
    const float bid = __int_as_float(vslot[3 * i + 2]);
    // the owner is read beside the key, not after it: one wait, not two
    const int64_t prev = owner[c];
    const unsigned low = (unsigned)(vkey[c] & 0xffffffffull);
    if (0xffffffffu - low == (unsigned)r && isfinite(bid)) {
      if (prev >= 0) r2c[prev] = -1;
      r2c[r] = c;
      owner[c] = r;
      price[c] = bid;
    }
  }
  __syncthreads();
  for (int i = tid; i < K; i += kThreads) {
    if (vslot[3 * i] >= 0 && vslot[3 * i + 1] >= 0)
      vkey[vslot[3 * i + 1]] = 0ull;
  }
  if (tid == 0) {
    live[b] += vslot[0] >= 0 ? 1 : 0;
    done[b] = 0u;
  }
}

}  // namespace

extern "C" {

// One round of every instance; returns cudaGetLastError().  keys (B, m)
// and done (B,) are zero between rounds; slots (B, n, 3) need no values.
// K = min(block, n) bidder slots, G warps per bidder (1, 2, 4 or 8).
int auction_round(const float* benefit, float* prices, int64_t* row_to_col,
                  int64_t* col_owner, const float* eps, int64_t* live,
                  unsigned long long* keys, int* slots, unsigned* done,
                  int B, int n, int m, int K, int G, cudaStream_t stream) {
  if (B <= 0 || n <= 0 || n > m || K <= 0 || K > n || G <= 0
      || G > kWarps || kWarps % G != 0)
    return (int)cudaErrorInvalidValue;
  const int vec = m % 4 == 0
      && reinterpret_cast<uintptr_t>(benefit) % 16 == 0
      && reinterpret_cast<uintptr_t>(prices) % 16 == 0;
  const int per_block = kWarps / G;
  const dim3 grid((K + per_block - 1) / per_block, B);
  auction_round_kernel<<<grid, kThreads, 0, stream>>>(
      benefit, prices, row_to_col, col_owner, eps, live, keys, slots, done,
      n, m, K, G, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
