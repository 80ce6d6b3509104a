// The ARWMH lockstep step's own arithmetic around the target's potential, in
// three kernels, on Hopper (sm_90a).  A step on the card is
//
//   draws -> arwmh_propose_kernel -> potential_fn (the target's PyTorch
//   operators) -> arwmh_accept_kernel -> chol_update_kernel (K1,
//   csrc/chol_update.cu) -> arwmh_settle_kernel
//
// in place of some fifty PyTorch launches of a few microseconds each.  They
// replace no TPU kernel: the JAX package's step (kernels/arwmh.py) is one
// jitted program, which XLA fuses.  Plain versions: propose_plain,
// accept_plain and settle_plain in adaptive_mcmc_tpu_torch/kernels/arwmh.py,
// whose operations these kernels repeat one for one.
//
// Numbers.  Built without FMA contraction and with IEEE division and square
// root (ops/cuda/_build.py), with the expf, powf, rsqrtf and sqrtf of
// PyTorch's CUDA kernels, so that every elementwise result rounds as the
// plain operator does on the card.  Two results are sums, and their order
// is this file's own:
//   * the proposal's (L e^lam + eps I) z sums j = 0 .. d-1 left to right
//     from 0 (the plain version is a cuBLAS gemv);
//   * as_change's sum of squares runs over the factor's entries lane by
//     lane, entry e on lane e % 32 in increasing e, then across the warp by
//     a butterfly (xor 16, 8, 4, 2, 1) before the square root (the plain
//     version is PyTorch's norm reduction).
//
// Layouts, all chains first and float32: x, z (C, d); L (C, d, d); one
// float per chain for the potentials, uniforms and adaptation scalars; the
// clock i a single int32.  Every output is a fresh array; no thread reads
// what another writes.
//
// Bound: memory, and at the samplers' sizes the launch.  At (4096, 10) the
// three kernels read and write 2.1, 4.4 and 5.0 MB once (0.6-1.5 us at
// 3.35 TB/s; PERF.md section 6), with a few operations per byte.  So each
// kernel is one wave: the propose kernel a thread per coordinate, the
// other two a warp per chain, whose lanes share the chain's scalars
// (computed once per warp instruction) and stride its factor 32 floats at
// a time, coalesced.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// gamma = n^-lr_decay as adaptation_lr computes it on CUDA: 1 / n at
// lr_decay 1 (its own division), rsqrtf at 0.5 (PyTorch's pow(Tensor,
// Scalar) takes rsqrt for the exponent -0.5), else powf.  The mode comes
// from ops/cuda/arwmh_step.py pow_mode.
enum PowMode : int { kPowf = 0, kReciprocal, kRsqrt };

__device__ __forceinline__ float power(float n, int mode, float e) {
  switch (mode) {
    case kReciprocal: return 1.0f / n;
    case kRsqrt: return rsqrtf(n);
    default: return powf(n, e);
  }
}

// x' = x + (L e^lam + eps I) z, a thread per coordinate (c, i).
__global__ void __launch_bounds__(kThreads)
arwmh_propose_kernel(const float* __restrict__ x, const float* __restrict__ L,
                     const float* __restrict__ log_lam,
                     const float* __restrict__ z, float eps,
                     float* __restrict__ out, int C, int d) {
  const size_t t = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<size_t>(C) * d) return;
  const size_t c = t / d;
  const int i = static_cast<int>(t % d);
  const float s = expf(log_lam[c]);
  const float* row = L + t * d;          // row i of chain c's factor
  const float* zc = z + c * d;
  float acc = 0.0f;
  for (int j = 0; j < d; ++j) {
    const float p = row[j] * s + (j == i ? eps : 0.0f);
    acc = acc + p * zc[j];
  }
  out[t] = x[t] + acc;
}

// Everything from the proposal's potential to K1's inputs, a warp per chain:
// the MH select, the clock n and gamma = n^-lr_decay, the running mean of
// acceptance and, when adapting, delta = x_new - mu, mu', log lam' and the
// factor sqrt(1 - gamma) L and coefficient gamma that K1 takes.
__global__ void __launch_bounds__(kThreads)
arwmh_accept_kernel(const float* __restrict__ x, const float* __restrict__ pe,
                    const float* __restrict__ x_prop,
                    const float* __restrict__ pe_prop,
                    const float* __restrict__ u,
                    const float* __restrict__ mean_ap,
                    const int* __restrict__ clock,
                    const float* __restrict__ loc,
                    const float* __restrict__ L,
                    const float* __restrict__ log_lam,
                    float* __restrict__ x_new, float* __restrict__ pe_new,
                    float* __restrict__ mean_new, float* __restrict__ loc_new,
                    float* __restrict__ log_lam_new,
                    float* __restrict__ delta, float* __restrict__ scaled,
                    float* __restrict__ coef, int C, int d, int num_warmup,
                    int pow_mode, float exponent, float target, int adapt) {
  const size_t c =
      (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  if (c >= static_cast<size_t>(C)) return;
  const int lane = threadIdx.x % kWarp;

  // nan_to_inf, then min(1, exp(pe - pe')) with clamp_max's NaN passed on
  float pp = pe_prop[c];
  if (isnan(pp)) pp = INFINITY;
  const float pc = pe[c];
  float a = expf(pc - pp);
  if (!isnan(a)) a = fminf(a, 1.0f);
  const bool accepted = u[c] < a;

  // adaptation_lr: the clock restarts after warmup (int32, wrapping)
  const unsigned i = static_cast<unsigned>(*clock);
  const unsigned itr = i + 1u;
  const int n = static_cast<int>(
      static_cast<int>(i) < num_warmup ? itr
                                       : itr - static_cast<unsigned>(num_warmup));
  const float nf = static_cast<float>(n);
  const float gamma = power(nf, pow_mode, exponent);

  const size_t v0 = c * d;
  for (int k = lane; k < d; k += kWarp) {
    const float xn = accepted ? x_prop[v0 + k] : x[v0 + k];
    x_new[v0 + k] = xn;
    if (adapt) {
      const float dl = xn - loc[v0 + k];
      delta[v0 + k] = dl;
      loc_new[v0 + k] = loc[v0 + k] + gamma * dl;
    }
  }
  if (lane == 0) {
    pe_new[c] = accepted ? pp : pc;
    const float m = mean_ap[c];
    mean_new[c] = m + (a - m) / nf;
    if (adapt) {
      log_lam_new[c] = log_lam[c] + gamma * (a - target);
      coef[c] = gamma;
    }
  }
  if (adapt) {
    const float r = sqrtf(1.0f - gamma);
    const size_t f0 = c * d * d;
    for (int e = lane; e < d * d; e += kWarp) {
      scaled[f0 + e] = r * L[f0 + e];
    }
  }
}

// After K1, a warp per chain: the per-chain NaN guard (the old factor where
// the update holds a NaN), as_change = |L' e^lam' - L e^lam|_F, and i + 1.
__global__ void __launch_bounds__(kThreads)
arwmh_settle_kernel(const float* __restrict__ L,
                    const float* __restrict__ updated,
                    const float* __restrict__ log_lam,
                    const float* __restrict__ log_lam_new,
                    const int* __restrict__ clock,
                    float* __restrict__ L_new, float* __restrict__ as_change,
                    int* __restrict__ clock_new, int C, int d) {
  const size_t c =
      (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  if (c >= static_cast<size_t>(C)) return;
  const int lane = threadIdx.x % kWarp;
  const int dd = d * d;
  const float* Lc = L + c * dd;
  const float* Uc = updated + c * dd;

  bool bad = false;
  for (int e = lane; e < dd; e += kWarp) bad = bad || isnan(Uc[e]);
  bad = __any_sync(kFull, bad);

  const float s = expf(log_lam[c]);
  const float s_new = expf(log_lam_new[c]);
  float acc = 0.0f;
  for (int e = lane; e < dd; e += kWarp) {
    const float v = bad ? Lc[e] : Uc[e];
    L_new[c * dd + e] = v;
    const float diff = v * s_new - Lc[e] * s;
    acc = acc + diff * diff;
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    acc = acc + __shfl_xor_sync(kFull, acc, off);
  }
  if (lane == 0) as_change[c] = sqrtf(acc);
  if (c == 0 && lane == 0) *clock_new = static_cast<int>(
      static_cast<unsigned>(*clock) + 1u);
}

unsigned warp_blocks(int C) {
  return static_cast<unsigned>((static_cast<size_t>(C) * kWarp + kThreads - 1)
                               / kThreads);
}

}  // namespace

extern "C" {

int arwmh_propose(const float* x, const float* L, const float* log_lam,
                  const float* z, float eps, float* out, int C, int d,
                  cudaStream_t stream) {
  const size_t n = static_cast<size_t>(C) * d;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  arwmh_propose_kernel<<<blocks, kThreads, 0, stream>>>(x, L, log_lam, z, eps,
                                                       out, C, d);
  return static_cast<int>(cudaGetLastError());
}

int arwmh_accept(const float* x, const float* pe, const float* x_prop,
                 const float* pe_prop, const float* u, const float* mean_ap,
                 const int* clock, const float* loc, const float* L,
                 const float* log_lam, float* x_new, float* pe_new,
                 float* mean_new, float* loc_new, float* log_lam_new,
                 float* delta, float* scaled, float* coef, int C, int d,
                 int num_warmup, int pow_mode, float exponent, float target,
                 int adapt, cudaStream_t stream) {
  arwmh_accept_kernel<<<warp_blocks(C), kThreads, 0, stream>>>(
      x, pe, x_prop, pe_prop, u, mean_ap, clock, loc, L, log_lam, x_new,
      pe_new, mean_new, loc_new, log_lam_new, delta, scaled, coef, C, d,
      num_warmup, pow_mode, exponent, target, adapt);
  return static_cast<int>(cudaGetLastError());
}

int arwmh_settle(const float* L, const float* updated, const float* log_lam,
                 const float* log_lam_new, const int* clock, float* L_new,
                 float* as_change, int* clock_new, int C, int d,
                 cudaStream_t stream) {
  arwmh_settle_kernel<<<warp_blocks(C), kThreads, 0, stream>>>(
      L, updated, log_lam, log_lam_new, clock, L_new, as_change, clock_new, C,
      d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
