// Kernel K1: batched rank-1 Cholesky update, chol(L L^T + coef v v^T), for
// every chain, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel(d)` of
// adaptive_mcmc_tpu/ops/pallas/chol_update.py (launched by
// chol_update_pallas_cl / chol_update_pallas).  Plain PyTorch version:
// chol_update_cl_reference in adaptive_mcmc_tpu_torch/ops/cuda/chol_update.py.
//
// Algorithm: the GGMS74-C1 column recursion (Gill, Golub, Murray and
// Saunders 1974, method C1) with the Pallas kernel's reassociation:
//     a <- coef ; w <- v
//     for j in 0..d-1:
//         inv_diag = 1/L[j,j]; Dj = L[j,j]^2; p = w[j]
//         Dj' = Dj + a p^2;  s_w = p inv_diag;  s_col = sqrt(Dj') inv_diag
//         s_new = (p a)(1/Dj') sqrt(Dj');  a <- a Dj (1/Dj')
//         w <- w - s_w L[:,j];  L'[:,j] = s_col L[:,j] + s_new w
// Entries above the diagonal are written as zero.  Row i of column j only
// depends on row i of w and of L[:,j], and rows above j are masked, so the
// kernel computes rows j..d-1 only and never reads the upper triangle.  An
// indefinite downdate yields NaN (sqrt of a negative), which the caller's
// per-chain guard catches; build without --use_fast_math to keep it so.
//
// Layout and design: chains-last, L (d, d, C), v (d, C), coef (C,), out
// (d, d, C), all float32.  One thread per chain; chains are the
// fastest-moving axis, so the 32 threads of a warp touch 32 neighbouring
// floats on every load and store.  Columns stream from global memory one at
// a time; only w[d], a and the current entry live in registers (about 2d
// floats), so d = 26 does not spill where a register-resident factor of 351
// floats would.  The ragged last block is masked (c < C); there is no
// padding with identity factors, which was a TPU lane-tile need.
//
// Bound: memory.  Per chain the kernel reads d(d+1)/2 + d + 1 floats and
// writes d^2, against about 3d^2 flops, far below the H100's
// flop-per-byte balance; the design's only lever is coalesced traffic.
// On an H100 it takes several times that byte bound at (4096, 10) (PERF.md
// section 6): one thread per chain runs the d columns in sequence.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 1;   // threads per chain: thread c runs chain c

template <int D>
__global__ void chol_update_kernel(const float* __restrict__ L,
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

#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float diag = L[(static_cast<size_t>(j) * D + j) * sC + c];
    const float inv_diag = 1.0f / diag;
    const float Dj = diag * diag;
    const float p = w[j];
    const float Dj_new = Dj + a * p * p;
    const float inv_Dj_new = 1.0f / Dj_new;
    const float sqrt_Dj_new = sqrtf(Dj_new);
    const float s_w = p * inv_diag;
    const float s_col = sqrt_Dj_new * inv_diag;
    const float s_new = (p * a) * inv_Dj_new * sqrt_Dj_new;
    a = a * Dj * inv_Dj_new;
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

template <int D>
cudaError_t launch(const float* L, const float* v, const float* coef,
                   float* out, int C, cudaStream_t stream) {
  const int blocks = (C * kLanes + kThreads - 1) / kThreads;
  chol_update_kernel<D><<<blocks, kThreads, 0, stream>>>(L, v, coef, out, C);
  return cudaGetLastError();
}

// The kernel's lanes per chain and threads per block, and how many of its
// blocks one SM holds at once, by the occupancy calculator.
template <int D>
cudaError_t layout(int* lanes, int* threads, int* blocks_per_sm) {
  *lanes = kLanes;
  *threads = kThreads;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, chol_update_kernel<D>, kThreads, 0);
}

}  // namespace

#define AMT_CASE(n) \
  case n:           \
    return static_cast<int>(launch<n>(L, v, coef, out, C, stream));

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unsupported d.
extern "C" int chol_update_cl(const float* L, const float* v,
                              const float* coef, float* out, int d, int C,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (d) {
    AMT_CASE(1) AMT_CASE(2) AMT_CASE(3) AMT_CASE(4) AMT_CASE(5) AMT_CASE(6)
    AMT_CASE(7) AMT_CASE(8) AMT_CASE(9) AMT_CASE(10) AMT_CASE(11)
    AMT_CASE(12) AMT_CASE(13) AMT_CASE(14) AMT_CASE(15) AMT_CASE(16)
    AMT_CASE(17) AMT_CASE(18) AMT_CASE(19) AMT_CASE(20) AMT_CASE(21)
    AMT_CASE(22) AMT_CASE(23) AMT_CASE(24) AMT_CASE(25) AMT_CASE(26)
    AMT_CASE(27) AMT_CASE(28) AMT_CASE(29) AMT_CASE(30) AMT_CASE(31)
    AMT_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef AMT_CASE

// chol_update_layout_d<n>: the layout of the kernel at d = n (see layout).
#define AMT_LAYOUT(n)                                                     \
  extern "C" int chol_update_layout_d##n(int* lanes, int* threads,        \
                                         int* blocks_per_sm) {            \
    return static_cast<int>(layout<n>(lanes, threads, blocks_per_sm));    \
  }

AMT_LAYOUT(1) AMT_LAYOUT(2) AMT_LAYOUT(3) AMT_LAYOUT(4) AMT_LAYOUT(5)
AMT_LAYOUT(6) AMT_LAYOUT(7) AMT_LAYOUT(8) AMT_LAYOUT(9) AMT_LAYOUT(10)
AMT_LAYOUT(11) AMT_LAYOUT(12) AMT_LAYOUT(13) AMT_LAYOUT(14) AMT_LAYOUT(15)
AMT_LAYOUT(16) AMT_LAYOUT(17) AMT_LAYOUT(18) AMT_LAYOUT(19) AMT_LAYOUT(20)
AMT_LAYOUT(21) AMT_LAYOUT(22) AMT_LAYOUT(23) AMT_LAYOUT(24) AMT_LAYOUT(25)
AMT_LAYOUT(26) AMT_LAYOUT(27) AMT_LAYOUT(28) AMT_LAYOUT(29) AMT_LAYOUT(30)
AMT_LAYOUT(31) AMT_LAYOUT(32)

#undef AMT_LAYOUT
