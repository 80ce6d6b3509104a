// Kernel K2: the fused ARWMH sweep on Hopper (sm_90a), for the targets
// with a device potential at d <= 16: eight schools noncentered and
// centered (d = 10) and kidiq (d = 4).
//
// Replaces the Pallas TPU kernel built by build_fused_arwmh in
// adaptive_mcmc_tpu/ops/pallas/arwmh_fused.py (_make_kernel / _one_step),
// which traces a target's potential into the kernel; here the potential is
// a policy P of csrc/common.cuh and the kernel a template on it.  Plain
// PyTorch version: fused_arwmh_reference in
// adaptive_mcmc_tpu_torch/ops/cuda/arwmh_fused.py, whose operation order
// this kernel follows.
//
// One launch runs n_steps whole ARWMH transitions.  One thread owns one
// chain and keeps its whole state in registers for the launch: x and loc
// (d each), the lower half of L (d(d+1)/2 = 55 floats at d = 10), pe, the
// running mean acceptance and log step size.  d = P::D is a template
// parameter, so every loop over d unrolls and all indexing is static.  At
// d = 26 (diamonds) the factor and the guard's second copy (2 x 351 floats)
// do not fit in registers; K2 has no instantiation there (the JAX package
// keeps d > 16 off its fused ARWMH kernel too).  Per step:
//   1. draws: Box-Muller normals over u1 in (0, 1] and 24-bit uniforms from
//      a counter-based Philox4x32-10 keyed by (seed, chain) with the step
//      index as counter, or injected noise (S, d, C) / unif (S, C) (the
//      generator and the potential live in common.cuh, shared with K3);
//   2. proposal x' = x + (L e^lam + eps I) z, unrolled over columns;
//   3. the target's potential, in the operation order of
//      models/targets.py, NaN -> +inf;
//   4. MH accept with alpha = min(1, exp(U - U')), NaN propagating;
//   5. adaptation clock (gamma = n^-r as exp(-r log n), clock restarted
//      after warmup), running means, loc update;
//   6. the GGMS74-C1 rank-1 update of sqrt(1 - gamma) L with the per-chain
//      NaN guard (keep the old factor), Robbins-Monro log step update;
//   7. as_change = ||L' e^lam' - L e^lam||_F, only on a recorded or final
//      step; thinned frames are written chains-last to (F, d, C), (F, C).
//
// Bound: arithmetic latency and register pressure, not bytes.  The state is
// read and written once per launch and frames are a small thinned stream;
// each step is a dependent chain of a few thousand instructions per thread
// (divisions and square roots of the column recursion, exp/log/log1p of the
// potential, Philox rounds).  The design keeps every operand in registers
// and puts one warp per block so the 4096 chains of the main path spread
// over the card's SMs.  Build without fast math: IEEE division and sqrt keep
// the NaN of an indefinite update, and no FMA contraction keeps rounding
// close to the plain version.

#include "common.cuh"

namespace {

using amt::bits01;
using amt::tri;

constexpr int kThreads = 32;

struct Params {
  float* x;      // (D, C)
  float* pe;     // (C,)
  float* map;    // (C,)
  float* loc;    // (D, C)
  float* L;      // (D, D, C)
  float* lam;    // (C,)
  float* as;     // (C,)
  const float* data;   // the target's kernel_data (n_data floats)
  int n_data;
  const float* noise;  // (S, D, C) or null
  const float* unif;   // (S, C) or null
  float* fx;           // (F, D, C) or null
  float* fpe;          // (F, C) or null
  float* fas;          // (F, C) or null
  int C;
  int n_steps;
  int n_frames;
  int thinning;
  int i0;
  int num_warmup;
  float lr_decay;
  float target_ap;
  float eps;
  unsigned long long seed;
};

template <class P>
__global__ void __launch_bounds__(kThreads)
    arwmh_fused_kernel(const Params p) {
  constexpr int D = P::D;
  static_assert(D <= 16, "K2 keeps the factor in registers: d <= 16");
  constexpr int NL = D * (D + 1) / 2;
  constexpr int kNormalBlocks = (D + 3) / 4;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= p.C) return;
  const size_t C = static_cast<size_t>(p.C);

  typename P::Data data;
  P::load(p.data, p.n_data, &data);

  float x[D], loc[D], L[NL];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    x[i] = p.x[i * C + c];
    loc[i] = p.loc[i * C + c];
#pragma unroll
    for (int j = 0; j <= i; ++j) L[tri(i, j)] = p.L[(i * D + j) * C + c];
  }
  float pe = p.pe[c], map = p.map[c], lam = p.lam[c], as_chg = 0.0f;
  const uint2 key = make_uint2(static_cast<uint32_t>(p.seed),
                               static_cast<uint32_t>(c));
  const uint32_t seed_hi = static_cast<uint32_t>(p.seed >> 32);

  for (int s = 0; s < p.n_steps; ++s) {
    const int i_glob = p.i0 + s;
    // 1. draws
    float z[D];
    float u;
    if (p.noise != nullptr) {
#pragma unroll
      for (int i = 0; i < D; ++i) z[i] = p.noise[(s * D + i) * C + c];
      u = p.unif[s * C + c];
    } else {
      amt::philox_normals<D>(static_cast<uint32_t>(i_glob), 0u, seed_hi, key,
                             z);
      const uint4 r = amt::philox4x32_10(
          make_uint4(static_cast<uint32_t>(i_glob), kNormalBlocks, seed_hi,
                     0u),
          key);
      u = bits01(r.x);
    }

    // 2. proposal: y = eps z + sum_j (L[:, j] e^lam) z_j
    const float ss = expf(lam);
    float xp[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float yi = p.eps * z[i];
#pragma unroll
      for (int j = 0; j <= i; ++j) yi = yi + (L[tri(i, j)] * ss) * z[j];
      xp[i] = x[i] + yi;
    }

    // 3.-4. potential and MH accept
    float pe_prop = P::potential(xp, data);
    if (isnan(pe_prop)) pe_prop = CUDART_INF_F;
    const float e = expf(pe - pe_prop);
    const float ap = isnan(e) ? e : fminf(e, 1.0f);
    const bool acc = u < ap;
    if (acc) {
#pragma unroll
      for (int i = 0; i < D; ++i) x[i] = xp[i];
      pe = pe_prop;
    }

    // 5. adaptation clock and running means
    const int itr = i_glob + 1;
    const int n = i_glob < p.num_warmup ? itr : itr - p.num_warmup;
    const float nf = static_cast<float>(n);
    const float gamma =
        p.lr_decay == 1.0f ? 1.0f / nf : expf(-p.lr_decay * logf(nf));
    map = map + (ap - map) / nf;
    float w[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      w[i] = x[i] - loc[i];
      loc[i] = loc[i] + gamma * w[i];
    }

    // 6. rank-1 update of sqrt(1 - gamma) L by delta with coefficient gamma
    const float sq = sqrtf(1.0f - gamma);
    float Ln[NL];
    float a = gamma;
    bool bad = false;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float diag = sq * L[tri(j, j)];
      const float inv_diag = 1.0f / diag;
      const float Dj = diag * diag;
      const float pj = w[j];
      const float Dj_new = Dj + a * pj * pj;
      const float inv_Dj_new = 1.0f / Dj_new;
      const float sqrt_Dj_new = sqrtf(Dj_new);
      const float s_w = pj * inv_diag;
      const float s_col = sqrt_Dj_new * inv_diag;
      const float s_new = (pj * a) * inv_Dj_new * sqrt_Dj_new;
      a = a * Dj * inv_Dj_new;
#pragma unroll
      for (int i = j; i < D; ++i) {
        const float col = sq * L[tri(i, j)];
        w[i] = w[i] - s_w * col;
        const float v = s_col * col + s_new * w[i];
        bad = bad || isnan(v);
        Ln[tri(i, j)] = v;
      }
    }
    const float lam_new = lam + gamma * (ap - p.target_ap);

    // 7. as_change on recorded / final steps, then commit
    const int f = (s + 1) / p.thinning - 1;
    const bool is_frame =
        p.n_frames > 0 && (s + 1) % p.thinning == 0 && f < p.n_frames;
    if (is_frame || s == p.n_steps - 1) {
      const float e1 = expf(lam_new), e0 = expf(lam);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const float dv = (bad ? L[i] : Ln[i]) * e1 - L[i] * e0;
        sum = sum + dv * dv;
      }
      // the zero upper triangle: 0 unless e^lam overflowed (NaN then)
      const float zu = 0.0f * e1 - 0.0f * e0;
      sum = sum + static_cast<float>(D * (D - 1) / 2) * (zu * zu);
      as_chg = sqrtf(sum);
    }
    if (!bad) {
#pragma unroll
      for (int i = 0; i < NL; ++i) L[i] = Ln[i];
    }
    lam = lam_new;
    if (is_frame) {
#pragma unroll
      for (int i = 0; i < D; ++i) p.fx[(f * D + i) * C + c] = x[i];
      p.fpe[f * C + c] = pe;
      p.fas[f * C + c] = as_chg;
    }
  }

#pragma unroll
  for (int i = 0; i < D; ++i) {
    p.x[i * C + c] = x[i];
    p.loc[i * C + c] = loc[i];
#pragma unroll
    for (int j = 0; j < D; ++j)
      p.L[(i * D + j) * C + c] = j <= i ? L[tri(i, j)] : 0.0f;
  }
  p.pe[c] = pe;
  p.map[c] = map;
  p.lam[c] = lam;
  p.as[c] = as_chg;
}

template <class P>
int launch(float* x, float* pe, float* map, float* loc, float* L, float* lam,
           float* as_change, const float* data, int n_data,
           const float* noise, const float* unif, float* fx, float* fpe,
           float* fas, int C, int D, int n_steps, int n_frames, int thinning,
           int i0, int num_warmup, float lr_decay, float target_ap, float eps,
           unsigned long long seed, void* stream_ptr) {
  if (D != P::D || !P::data_ok(n_data) || data == nullptr || C < 0 ||
      n_steps < 0 || thinning < 1 || n_frames < 0 ||
      (n_frames > 0 && (fx == nullptr || fpe == nullptr || fas == nullptr)) ||
      ((noise == nullptr) != (unif == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0 || n_steps == 0) return static_cast<int>(cudaGetLastError());
  const Params p{x,        pe,        map,      loc,      L,     lam,
                 as_change, data,     n_data,   noise,    unif,  fx,
                 fpe,      fas,       C,        n_steps,  n_frames,
                 thinning, i0,        num_warmup, lr_decay, target_ap,
                 eps,      seed};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = (C + kThreads - 1) / kThreads;
  arwmh_fused_kernel<P><<<blocks, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry point per device potential, arwmh_fused_<tag> (the tag of
// Target.device_potential).  Each returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a D or data length
// that is not the potential's, or bad arguments.
#define AMT_ARWMH_FUSED_ENTRY(TAG, POLICY)                                    \
  extern "C" int arwmh_fused_##TAG(                                           \
      float* x, float* pe, float* map, float* loc, float* L, float* lam,      \
      float* as_change, const float* data, int n_data, const float* noise,    \
      const float* unif, float* fx, float* fpe, float* fas, int C, int D,     \
      int n_steps, int n_frames, int thinning, int i0, int num_warmup,        \
      float lr_decay, float target_ap, float eps, unsigned long long seed,    \
      void* stream_ptr) {                                                     \
    return launch<POLICY>(x, pe, map, loc, L, lam, as_change, data, n_data,   \
                          noise, unif, fx, fpe, fas, C, D, n_steps, n_frames, \
                          thinning, i0, num_warmup, lr_decay, target_ap, eps, \
                          seed, stream_ptr);                                  \
  }

AMT_ARWMH_FUSED_ENTRY(eight_schools_noncentered, amt::EightSchoolsNoncentered)
AMT_ARWMH_FUSED_ENTRY(eight_schools_centered, amt::EightSchoolsCentered)
AMT_ARWMH_FUSED_ENTRY(kidiq, amt::Kidiq)
