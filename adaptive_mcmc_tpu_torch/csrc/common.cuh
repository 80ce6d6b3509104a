// Device helpers shared by the fused sweeps K2 (arwmh_fused.cu) and K3
// (asss_fused.cu): the counter-based Philox4x32-10 generator, its uniform
// and Box-Muller normal transforms, and the eight-schools noncentered
// potential.  One copy, so that both kernels draw and round alike.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace amt {

constexpr float kTwoPi = 6.2831853071795864769f;
constexpr float kLog2Pi = 1.8378770664093453f;
// log 5, and log 2 - log pi - log 5 of the half-Cauchy(5), folded in double
// as the plain version folds its Python constants.
constexpr float kLog5 = 1.6094379124341003f;
constexpr float kHalfCauchy5 =
    static_cast<float>(0.6931471805599453 - 1.1447298858494002 -
                       1.6094379124341003);

// ---- Philox4x32-10 (Salmon et al. 2011) ---------------------------------
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      key.x += kW0;
      key.y += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
  }
  return ctr;
}

// uniform [0, 1) from the top 24 bits
__device__ __forceinline__ float bits01(uint32_t b) {
  return static_cast<float>(b >> 8) * (1.0f / 16777216.0f);
}

// two N(0, 1) by Box-Muller over u1 in (0, 1] (log stays finite)
__device__ __forceinline__ void box_muller(uint32_t b1, uint32_t b2,
                                           float* z0, float* z1) {
  const float u1 = 1.0f - bits01(b1);
  const float u2 = bits01(b2);
  const float r = sqrtf(-2.0f * logf(u1));
  float sn, cs;
  sincosf(kTwoPi * u2, &sn, &cs);
  *z0 = r * cs;
  *z1 = r * sn;
}

// N normals from Philox blocks first_block, first_block + 1, ... at
// counter (ctr, block, seed_hi, 0): four normals per block.
template <int N>
__device__ __forceinline__ void philox_normals(uint32_t ctr,
                                               uint32_t first_block,
                                               uint32_t seed_hi, uint2 key,
                                               float (&z)[N]) {
#pragma unroll
  for (int b = 0; b < (N + 3) / 4; ++b) {
    const uint4 r = philox4x32_10(
        make_uint4(ctr, first_block + b, seed_hi, 0u), key);
    float n0, n1, n2, n3;
    box_muller(r.x, r.y, &n0, &n1);
    box_muller(r.z, r.w, &n2, &n3);
    if (4 * b + 0 < N) z[4 * b + 0] = n0;
    if (4 * b + 1 < N) z[4 * b + 1] = n1;
    if (4 * b + 2 < N) z[4 * b + 2] = n2;
    if (4 * b + 3 < N) z[4 * b + 3] = n3;
  }
}

// ---- eight-schools noncentered potential ---------------------------------
// Same operation order as models/targets.py (and models/base.py):
//   lp  = normal_logpdf(mu, 0, 5)
//   lp += half_cauchy_logpdf(tau, 5) + log_tau
//   lp += sum normal_logpdf(theta_base)
//   lp += sum normal_logpdf(y, mu + tau theta_base, sigma)
template <int J>
__device__ __forceinline__ float eight_schools_potential(
    const float (&x)[J + 2], const float (&y)[J], const float (&sigma)[J],
    const float (&log_sigma)[J]) {
  const float mu = x[0], log_tau = x[1];
  const float tau = expf(log_tau);
  // PyTorch on the card divides by a Python scalar as a multiply by its
  // float reciprocal; the plain version's (x - loc) / 5.0 does so.
  const float zm = (mu - 0.0f) * (1.0f / 5.0f);
  float lp = -0.5f * (zm * zm + kLog2Pi) - kLog5;
  const float zc = tau * (1.0f / 5.0f);
  lp = lp + ((kHalfCauchy5 - log1pf(zc * zc)) + log_tau);
  // the J-sums run left to right, as sum_in_order does
  float s1 = -0.5f * (x[2] * x[2] + kLog2Pi) - 0.0f;
#pragma unroll
  for (int k = 1; k < J; ++k) {
    s1 = s1 + (-0.5f * (x[2 + k] * x[2 + k] + kLog2Pi) - 0.0f);
  }
  lp = lp + s1;
  float s2 = 0.0f;
#pragma unroll
  for (int k = 0; k < J; ++k) {
    const float theta = mu + tau * x[2 + k];
    const float zy = (y[k] - theta) / sigma[k];
    const float term = -0.5f * (zy * zy + kLog2Pi) - log_sigma[k];
    s2 = k == 0 ? term : s2 + term;
  }
  lp = lp + s2;
  return -lp;
}

// packed lower-triangular index (i >= j), row-major
__host__ __device__ constexpr int tri(int i, int j) {
  return i * (i + 1) / 2 + j;
}

}  // namespace amt
