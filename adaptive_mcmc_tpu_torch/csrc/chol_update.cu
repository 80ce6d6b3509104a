// Kernel K1: batched rank-1 Cholesky update, chol(L L^T + coef v v^T), for
// every chain, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel(d)` of
// adaptive_mcmc_tpu/ops/pallas/chol_update.py (launched by
// chol_update_pallas_cl / chol_update_pallas).  Plain PyTorch versions:
// chol_update_reference and chol_update_cl_reference in
// adaptive_mcmc_tpu_torch/ops/cuda/chol_update.py.
//
// Algorithm: the GGMS74-C1 column recursion (Gill, Golub, Murray and
// Saunders 1974, method C1) with the Pallas kernel's reassociation:
//     a <- coef ; w <- v
//     for j in 0..d-1:
//         inv_diag = 1/L[j,j]; Dj = L[j,j]^2; p = w[j]
//         Dj' = Dj + a p^2;  s_w = p inv_diag;  s_col = sqrt(Dj') inv_diag
//         s_new = (p a)(1/Dj') sqrt(Dj');  a <- a Dj (1/Dj')
//         w <- w - s_w L[:,j];  L'[:,j] = s_col L[:,j] + s_new w
// Entries above the diagonal are written as zero and never read.  Every
// output element is its own ordered chain of operations (there is no sum),
// so both kernels below, at any lanes per chain, give the same bits.  An
// indefinite downdate yields NaN (sqrt of a negative), which the caller's
// per-chain guard catches; build without --use_fast_math to keep it so.
//
// Two entry points, one per layout of the caller's state, all float32:
//   chol_update     chains first: L (C, d, d), v (C, d), coef (C,), out
//                   (C, d, d).  The samplers' lockstep steps hold their state
//                   so; a chain's factor is one record of 4 d^2 bytes.
//   chol_update_cl  chains last: L (d, d, C), v (d, C), out (d, d, C): the
//                   layout of the pipelined ASSS machine.
//
// Chains first, the staged kernel: a block takes kThreads / kLanes
// neighbouring chains, whose factors and v are each one contiguous stretch
// of global memory.  Its warps copy the lower triangles and v into shared
// memory, a warp one chain at a time and 32 neighbouring floats per step,
// with cp.async, so that a thread starts all its copies before it waits
// once.  A chain's record there is packed (d(d+1)/2 + d floats) and padded
// to an odd length, so that the records of neighbouring chains start on
// different banks.  The column recursion runs out of shared memory, in place: with
// one lane per chain a thread runs its chain with w in registers; with G
// lanes per chain the lanes share the rows of a column (row j + l,
// j + l + G, ... on lane l), every lane computes the column's scalars from
// the shared record, and a warp barrier stands on either side of a column's
// row updates.  The block writes the result back with coalesced stores, the
// zeros of the upper triangle among them.  The ragged last block is masked.
//
// Two layouts of it, chosen per call from C (trials on the card, PERF.md
// section 6).  While the card can hold every chain's group of lanes at once
// the time is one wave's latency, and many threads per chain shorten the
// staging and the columns: G = the power of two at or above d (at most 32)
// in blocks of 128 threads, 512 blocks at (4096, 10).  Past that the time is
// the memory's and every repeated scalar takes a scheduler's slot: one
// thread per chain in blocks of 32.
//
// Chains last, the direct kernel: chains are the fastest-moving axis, so one
// thread per chain reads and writes coalesced without staging, streaming
// the columns from global memory with w in registers.  The staged kernel
// was slower there at every shape but one.
//
// Bound: memory.  Per chain a kernel reads d(d+1)/2 + d + 1 floats and
// writes d^2, against about 3d^2 flops, far below the H100's flop-per-byte
// balance.  At a few thousand chains the whole batch is one wave and the
// time is the launch plus one chain's latency; at hundreds of thousands of
// chains it is the memory rate (PERF.md section 6 has both).

#include <cuda_runtime.h>

namespace {

__host__ __device__ constexpr int tri(int d) { return d * (d + 1) / 2; }

// floats of a chain's record in shared memory: the packed lower triangle of
// its factor (row i at tri(i)), then w; odd
__host__ __device__ constexpr int record(int d) { return (tri(d) + d) | 1; }

// lanes per chain of the wide layout: the power of two at or above d, at
// most a warp
constexpr int wide_lanes(int d) {
  int g = 1;
  while (g < d && g < 32) g *= 2;
  return g;
}

constexpr int kWideThreads = 128, kNarrowThreads = 32;
constexpr int kDirectThreads = 128;   // of the chains-last kernel

// The scalars of one column from its diagonal entry, p = w[j] and the
// running coefficient a, which it advances.
__device__ __forceinline__ void column_scalars(float diag, float p, float& a,
                                               float& s_w, float& s_col,
                                               float& s_new) {
  const float inv_diag = 1.0f / diag;
  const float Dj = diag * diag;
  const float Dj_new = Dj + a * p * p;
  const float inv_Dj_new = 1.0f / Dj_new;
  const float sqrt_Dj_new = sqrtf(Dj_new);
  s_w = p * inv_diag;
  s_col = sqrt_Dj_new * inv_diag;
  s_new = (p * a) * inv_Dj_new * sqrt_Dj_new;
  a = a * Dj * inv_Dj_new;
}

// One float from global to shared memory without a register or a wait in
// between (cp.async): a thread starts all its copies back to back, so a
// block pays the memory's latency once.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The staged kernel, chains first: G lanes per chain, T threads per block.
template <int D, int G, int T>
__global__ void __launch_bounds__(T)
chol_update_kernel(const float* __restrict__ L, const float* __restrict__ v,
                   const float* __restrict__ coef, float* __restrict__ out,
                   int C) {
  static_assert(T % 32 == 0 && 32 % G == 0, "whole warps of whole groups");
  extern __shared__ float smem[];
  constexpr int kChains = T / G, kRec = record(D), DD = D * D, kW = tri(D);
  const int c0 = blockIdx.x * kChains;
  const int n = min(kChains, C - c0);      // chains of this block
  const int t = threadIdx.x;

  // A warp copies one chain's factor at a time, 32 neighbouring floats per
  // step: slot m of a lane is entry r = lane + 32 m of the (d, d) factor,
  // and place[m] where that entry (row i, column j <= i) lies in the
  // chain's record, or -1 above the diagonal and past the factor.
  constexpr int kWarps = T / 32, kSlots = (DD + 31) / 32;
  const int lane = t % 32, warp = t / 32;
  int place[kSlots];
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    const int r = lane + 32 * m, i = r / D, j = r % D;
    place[m] = r < DD && j <= i ? tri(i) + j : -1;
  }

  // stage in: the lower triangle and v of each chain
  const float* Lb = L + static_cast<size_t>(c0) * DD;
#pragma unroll 4
  for (int cc = warp; cc < n; cc += kWarps) {
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      if (place[m] >= 0) {
        copy_async(smem + cc * kRec + place[m], Lb + cc * DD + lane + 32 * m);
      }
    }
  }
  const float* vb = v + static_cast<size_t>(c0) * D;
#pragma unroll 8
  for (int e = t; e < n * D; e += T) {
    copy_async(smem + (e / D) * kRec + kW + e % D, vb + e);
  }
  const int c = t / G, l = t % G;
  float a = c < n ? coef[c0 + c] : 0.0f;
  copy_wait();
  __syncthreads();

  // the column recursion, in place; the lanes of a chain past the block's
  // last one run on an unused record
  float* s = smem + c * kRec;
  float s_w, s_col, s_new;
  if constexpr (G == 1) {
    float w[D];
#pragma unroll
    for (int i = 0; i < D; ++i) w[i] = s[kW + i];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      column_scalars(s[tri(j) + j], w[j], a, s_w, s_col, s_new);
#pragma unroll
      for (int i = j; i < D; ++i) {
        const float col = s[tri(i) + j];
        w[i] = w[i] - s_w * col;
        s[tri(i) + j] = s_col * col + s_new * w[i];
      }
    }
  } else {
    float* w = s + kW;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      column_scalars(s[tri(j) + j], w[j], a, s_w, s_col, s_new);
      __syncwarp();    // every lane has read the diagonal entry and w[j]
      for (int i = j + l; i < D; i += G) {
        const float col = s[tri(i) + j];
        const float wi = w[i] - s_w * col;
        w[i] = wi;
        s[tri(i) + j] = s_col * col + s_new * wi;
      }
      __syncwarp();    // the column and w are written
    }
  }
  __syncthreads();

  // stage out: the whole factor, zeros above the diagonal
  float* ob = out + static_cast<size_t>(c0) * DD;
#pragma unroll 4
  for (int cc = warp; cc < n; cc += kWarps) {
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      if (lane + 32 * m < DD) {
        ob[cc * DD + lane + 32 * m] =
            place[m] >= 0 ? smem[cc * kRec + place[m]] : 0.0f;
      }
    }
  }
}

// The direct kernel, chains last: chains are the fastest-moving axis of L, v
// and out, so with one thread per chain the 32 threads of a warp touch 32
// neighbouring floats on every load and store and nothing needs staging.
// Columns stream from global memory one at a time; only w[d], a and the
// current entry live in registers.
template <int D>
__global__ void chol_update_cl_kernel(const float* __restrict__ L,
                                      const float* __restrict__ v,
                                      const float* __restrict__ coef,
                                      float* __restrict__ out, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const size_t sC = static_cast<size_t>(C);
  float w[D];
#pragma unroll
  for (int i = 0; i < D; ++i) w[i] = v[i * sC + c];
  float a = coef[c];
  float s_w, s_col, s_new;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    column_scalars(L[(static_cast<size_t>(j) * D + j) * sC + c], w[j], a,
                   s_w, s_col, s_new);
#pragma unroll
    for (int i = 0; i < j; ++i) {
      out[(static_cast<size_t>(i) * D + j) * sC + c] = 0.0f;
    }
#pragma unroll
    for (int i = j; i < D; ++i) {
      const size_t idx = (static_cast<size_t>(i) * D + j) * sC + c;
      const float col = L[idx];
      w[i] = w[i] - s_w * col;
      out[idx] = s_col * col + s_new * w[i];
    }
  }
}

// The resident threads of the current card.
int card_threads() {
  static const int n = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor,
                           dev);
    return sms * per_sm;
  }();
  return n;
}

// One layout of the staged kernel at d = D: its launch, and its lanes per
// chain, threads per block and blocks one SM holds at once (the occupancy
// calculator).
template <int D, int G, int T>
struct Staged {
  static constexpr int kChains = T / G;
  static constexpr int kBytes = kChains * record(D) * sizeof(float);

  // once per instantiation: the kernel may take its shared memory (above 48
  // KB at large d only by this request), and the SM gives its L1 to it
  static cudaError_t prepare() {
    static const cudaError_t err = [] {
      cudaError_t e = cudaFuncSetAttribute(
          chol_update_kernel<D, G, T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
      if (e != cudaSuccess) return e;
      return cudaFuncSetAttribute(
          chol_update_kernel<D, G, T>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          static_cast<int>(cudaSharedmemCarveoutMaxShared));
    }();
    return err;
  }

  static cudaError_t run(const float* L, const float* v, const float* coef,
                         float* out, int C, cudaStream_t stream) {
    const cudaError_t err = prepare();
    if (err != cudaSuccess) return err;
    const int blocks = (C + kChains - 1) / kChains;
    chol_update_kernel<D, G, T>
        <<<blocks, T, kBytes, stream>>>(L, v, coef, out, C);
    return cudaGetLastError();
  }

  static cudaError_t layout(int* lanes, int* threads, int* blocks_per_sm) {
    *lanes = G;
    *threads = T;
    const cudaError_t err = prepare();
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, chol_update_kernel<D, G, T>, T, kBytes);
  }
};

// The chains-first entry at d = D: the wide layout while the card holds the
// lanes of all C chains at once, the narrow one past that.
template <int D>
struct First {
  using Wide = Staged<D, wide_lanes(D), kWideThreads>;
  using Narrow = Staged<D, 1, kNarrowThreads>;

  static bool wide(int C) {
    return static_cast<long long>(C) * wide_lanes(D) <= card_threads();
  }

  static cudaError_t run(const float* L, const float* v, const float* coef,
                         float* out, int C, cudaStream_t stream) {
    return wide(C) ? Wide::run(L, v, coef, out, C, stream)
                   : Narrow::run(L, v, coef, out, C, stream);
  }

  static cudaError_t layout(int C, int* lanes, int* threads,
                            int* blocks_per_sm) {
    return wide(C) ? Wide::layout(lanes, threads, blocks_per_sm)
                   : Narrow::layout(lanes, threads, blocks_per_sm);
  }
};

// The chains-last entry at d = D: the direct kernel at every C.
template <int D>
struct Last {
  static cudaError_t run(const float* L, const float* v, const float* coef,
                         float* out, int C, cudaStream_t stream) {
    const int blocks = (C + kDirectThreads - 1) / kDirectThreads;
    chol_update_cl_kernel<D>
        <<<blocks, kDirectThreads, 0, stream>>>(L, v, coef, out, C);
    return cudaGetLastError();
  }

  static cudaError_t layout(int, int* lanes, int* threads,
                            int* blocks_per_sm) {
    *lanes = 1;
    *threads = kDirectThreads;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, chol_update_cl_kernel<D>, kDirectThreads, 0);
  }
};

}  // namespace

#define AMT_EVERY_D(X)                                                       \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) \
  X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24) X(25) X(26)    \
  X(27) X(28) X(29) X(30) X(31) X(32)

#define AMT_CASE(n) \
  case n:           \
    return static_cast<int>(Entry<n>::run(L, v, coef, out, C, stream));

template <template <int> class Entry>
static int dispatch(const float* L, const float* v, const float* coef,
                    float* out, int d, int C, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (d) {
    AMT_EVERY_D(AMT_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef AMT_CASE

// Both return cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unsupported d.
extern "C" int chol_update(const float* L, const float* v, const float* coef,
                           float* out, int d, int C, void* stream_ptr) {
  return dispatch<First>(L, v, coef, out, d, C, stream_ptr);
}

extern "C" int chol_update_cl(const float* L, const float* v,
                              const float* coef, float* out, int d, int C,
                              void* stream_ptr) {
  return dispatch<Last>(L, v, coef, out, d, C, stream_ptr);
}

// chol_update_layout_d<n> and chol_update_layout_cl_d<n>: the layout of the
// kernel that chol_update and chol_update_cl launch for C chains at d = n.
#define AMT_LAYOUT(n)                                                        \
  extern "C" int chol_update_layout_d##n(int C, int* lanes, int* threads,    \
                                         int* blocks_per_sm) {               \
    return static_cast<int>(                                                 \
        First<n>::layout(C, lanes, threads, blocks_per_sm));                 \
  }                                                                          \
  extern "C" int chol_update_layout_cl_d##n(int C, int* lanes, int* threads, \
                                            int* blocks_per_sm) {            \
    return static_cast<int>(                                                 \
        Last<n>::layout(C, lanes, threads, blocks_per_sm));                  \
  }

AMT_EVERY_D(AMT_LAYOUT)

#undef AMT_LAYOUT
#undef AMT_EVERY_D
