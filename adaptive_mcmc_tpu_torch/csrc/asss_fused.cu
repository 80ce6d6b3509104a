// Kernel K3: the fused ASSS sweep on Hopper (sm_90a), eight-schools
// noncentered target.
//
// Replaces the Pallas TPU kernel built by build_fused_asss in
// adaptive_mcmc_tpu/ops/pallas/asss_fused.py (_make_kernel).  Plain PyTorch
// version: fused_asss_reference in
// adaptive_mcmc_tpu_torch/ops/cuda/asss_fused.py, whose operation order
// this kernel follows.
//
// One launch advances every chain by n_steps ASSS transitions.  One thread
// owns one chain and runs its own state machine until it has landed n_steps
// times: no barrier between chains, so a chain's iteration index is its own
// loop count.  Chain state in registers: x and loc (d each), the lower half
// of the scale factor S (d(d+1)/2 = 55 floats at d = 10), pe, as_change;
// and the open transition: the sphere point z and the great-circle velocity
// v (d + 1 each), the slice level t, theta and its bracket, the trip count.
// d = J + 2 is a template parameter, so every loop over d unrolls and all
// indexing is static.
//
// Iteration 0 opens the first transition (begin) and does nothing else.
// Every later iteration:
//   1. draws (u_shrink, u_level, u_theta): row min(it, R - 1) of the
//      injected unif3 (R, 3, C), or Philox4x32-10 block 0 keyed by
//      (seed, chain) at counter it (u_level = 1 - bits, in (0, 1]);
//   2. one potential evaluation at x(z cos(theta) + v sin(theta)): the
//      inverse map through the factor (S + eps I) sqrt(d);
//   3. lands if U(x') + d log(pole) <= t and pole >= eps, or, staying put,
//      if trips >= max_shrinkage_iters (the bail-out to theta = 0);
//   4. on landing: adaptation (gamma from the per-chain clock i0 + done,
//      restarted after warmup; loc; the GGMS74-C1 rank-1 update of
//      sqrt(1 - gamma) S with the NaN guard; as_change = ||dloc||_2 +
//      ||dS||_F), a thinned frame to (F, D, C) / (F, C), and begin of the
//      next transition with the d + 1 normals of this iteration (row of the
//      injected n01 (R, D + 1, C), or Philox blocks 1..3);
//   5. otherwise: shrink the bracket toward 0 and redraw theta in it.
// begin projects x to the sphere (forward substitution, then the
// stereographic map), sets the level t = pe + d log(1 - z_d) - log u_level
// from the stored potential, the tangent velocity, and theta = 2 pi u_theta
// with the bracket [theta - 2 pi, theta].
//
// Bound: arithmetic latency and divergence, not bytes.  Each iteration is a
// dependent chain of a few thousand instructions per thread (the potential's
// transcendentals, the d(d+1)/2 inverse map; on landing the column
// recursion's divisions and square roots, the projection and three Philox
// blocks of normals), and the state is read and written once per launch.
// A warp's threads land on different iterations, so a warp runs both the
// landing and the shrinking branch on most iterations; over a long call the
// iteration counts of a warp's threads differ only by a short tail.  One
// warp per block spreads the 4096 chains of the main path over the SMs.
// Build without fast math: IEEE division and sqrt keep the NaN of an
// indefinite update, and no FMA contraction keeps rounding equal to the
// plain version, so that near-ties of the slice test fall the same way.

#include "common.cuh"

namespace {

using amt::tri;

constexpr int kThreads = 32;

struct Params {
  float* x;      // (D, C)
  float* pe;     // (C,)
  float* loc;    // (D, C)
  float* S;      // (D, D, C)
  float* as;     // (C,)
  int* iters;    // (C,) iterations each chain ran, iteration 0 included
  const float* y;      // (J,)
  const float* sigma;  // (J,)
  const float* unif3;  // (R, 3, C) or null
  const float* n01;    // (R, D + 1, C) or null
  float* fx;           // (F, D, C) or null
  float* fpe;          // (F, C) or null
  float* fas;          // (F, C) or null
  int C;
  int n_rows;
  int n_steps;
  int n_frames;
  int thinning;
  int i0;
  int num_warmup;
  int max_trips;
  int adapt;
  float lr_decay;
  float eps;
  float sqrt_d;
  unsigned long long seed;
};

struct Stream {
  uint2 key;
  uint32_t seed_hi;
};

// (u_shrink, u_level, u_theta) of iteration it
__device__ __forceinline__ void uniforms(const Params& p, int it, int c,
                                         const Stream& st, float* us,
                                         float* ul, float* ut) {
  if (p.unif3 != nullptr) {
    const size_t C = static_cast<size_t>(p.C);
    const size_t base =
        static_cast<size_t>(min(it, p.n_rows - 1)) * 3 * C + c;
    *us = p.unif3[base];
    *ul = p.unif3[base + C];
    *ut = p.unif3[base + 2 * C];
  } else {
    const uint4 r = amt::philox4x32_10(
        make_uint4(static_cast<uint32_t>(it), 0u, st.seed_hi, 0u), st.key);
    *us = amt::bits01(r.x);
    *ul = 1.0f - amt::bits01(r.y);
    *ut = amt::bits01(r.z);
  }
}

// the d + 1 velocity normals of iteration it
template <int N>
__device__ __forceinline__ void normals(const Params& p, int it, int c,
                                        const Stream& st, float (&n)[N]) {
  if (p.n01 != nullptr) {
    const size_t C = static_cast<size_t>(p.C);
    const size_t row = static_cast<size_t>(min(it, p.n_rows - 1));
#pragma unroll
    for (int i = 0; i < N; ++i) n[i] = p.n01[(row * N + i) * C + c];
  } else {
    amt::philox_normals<N>(static_cast<uint32_t>(it), 1u, st.seed_hi, st.key,
                           n);
  }
}

// entry (i, j) of the whitening factor (S + eps I) sqrt(d)
template <int NL>
__device__ __forceinline__ float sig(const float (&S)[NL], int i, int j,
                                     float eps, float sqrt_d) {
  return (i == j ? S[tri(i, j)] + eps : S[tri(i, j)]) * sqrt_d;
}

struct Slice {
  float t;      // slice level of the transformed potential
  float theta;  // angle on the great circle
  float tmin;   // bracket
  float tmax;
};

// Open a transition at (x, pe) under (loc, S): sphere point z, tangent
// velocity v, slice level and bracket.
template <int D, int NL>
__device__ __forceinline__ Slice begin(const float (&n01)[D + 1], float ul,
                                       float ut, const float (&x)[D],
                                       float pe, const float (&loc)[D],
                                       const float (&S)[NL], float eps,
                                       float sqrt_d, float (&z)[D + 1],
                                       float (&v)[D + 1]) {
  // whitening by forward substitution, as the plain version's project_cl
  float ys[D], xr[D];
#pragma unroll
  for (int i = 0; i < D; ++i) ys[i] = x[i] - loc[i];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    xr[k] = ys[k] / sig(S, k, k, eps, sqrt_d);
#pragma unroll
    for (int i = k + 1; i < D; ++i)
      ys[i] = ys[i] - sig(S, i, k, eps, sqrt_d) * xr[k];
  }
  // the d-length sums run left to right in both versions
  float nsq = xr[0] * xr[0];
#pragma unroll
  for (int k = 1; k < D; ++k) nsq = nsq + xr[k] * xr[k];
  const float np1 = nsq + 1.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) z[k] = (2.0f * xr[k]) / np1;
  z[D] = (nsq - 1.0f) / np1;
  const float pe_t = pe + static_cast<float>(D) * logf(1.0f - z[D]);
  float dot = n01[0] * z[0];
#pragma unroll
  for (int i = 1; i <= D; ++i) dot = dot + n01[i] * z[i];
#pragma unroll
  for (int i = 0; i <= D; ++i) v[i] = n01[i] - dot * z[i];
  float vv = v[0] * v[0];
#pragma unroll
  for (int i = 1; i <= D; ++i) vv = vv + v[i] * v[i];
  const float nrm = sqrtf(vv);
#pragma unroll
  for (int i = 0; i <= D; ++i) v[i] = v[i] / nrm;
  Slice s;
  s.t = pe_t - logf(ul);
  s.theta = ut * amt::kTwoPi;
  s.tmin = s.theta - amt::kTwoPi;
  s.tmax = s.theta;
  return s;
}

template <int J>
__global__ void __launch_bounds__(kThreads) asss_fused_kernel(const Params p) {
  constexpr int D = J + 2;
  constexpr int NL = D * (D + 1) / 2;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= p.C) return;
  const size_t C = static_cast<size_t>(p.C);
  const float eps = p.eps, sqrt_d = p.sqrt_d;

  float yv[J], sg[J], lsg[J];
#pragma unroll
  for (int k = 0; k < J; ++k) {
    yv[k] = p.y[k];
    sg[k] = p.sigma[k];
    lsg[k] = logf(sg[k]);
  }

  float x[D], loc[D], S[NL];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    x[i] = p.x[i * C + c];
    loc[i] = p.loc[i * C + c];
#pragma unroll
    for (int j = 0; j <= i; ++j) S[tri(i, j)] = p.S[(i * D + j) * C + c];
  }
  float pe = p.pe[c], as_chg = p.as[c];
  const Stream st{make_uint2(static_cast<uint32_t>(p.seed),
                             static_cast<uint32_t>(c)),
                  static_cast<uint32_t>(p.seed >> 32)};

  float z[D + 1], v[D + 1];
  Slice sl{};
  int it = 0, trips = 0, done = 0;
  if (p.n_steps > 0) {
    float us, ul, ut, n[D + 1];
    uniforms(p, 0, c, st, &us, &ul, &ut);
    normals(p, 0, c, st, n);
    sl = begin<D, NL>(n, ul, ut, x, pe, loc, S, eps, sqrt_d, z, v);
    it = 1;
  }

  while (done < p.n_steps) {
    float us, ul, ut;
    uniforms(p, it, c, st, &us, &ul, &ut);

    // 2. the one potential evaluation of this iteration
    const float cs = cosf(sl.theta), sn = sinf(sl.theta);
    float zt[D + 1];
#pragma unroll
    for (int i = 0; i <= D; ++i) zt[i] = z[i] * cs + v[i] * sn;
    const float pole = 1.0f - zt[D];
    float xb[D], xp[D];
#pragma unroll
    for (int j = 0; j < D; ++j) xb[j] = zt[j] / pole;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      // the plain version also adds 0 * xb[j] for j > i: no change while
      // pole >= eps keeps xb finite, and below eps the point is rejected
      float acc = loc[i];
#pragma unroll
      for (int j = 0; j <= i; ++j)
        acc = acc + sig(S, i, j, eps, sqrt_d) * xb[j];
      xp[i] = acc;
    }
    float u_prop = amt::eight_schools_potential<J>(xp, yv, sg, lsg);
    if (isnan(u_prop)) u_prop = CUDART_INF_F;

    // 3. slice test and bail-out
    const bool good =
        (u_prop + static_cast<float>(D) * logf(pole) <= sl.t) && (pole >= eps);
    const bool bail = trips >= p.max_trips;
    if (good || bail) {
      if (!bail) {
#pragma unroll
        for (int i = 0; i < D; ++i) x[i] = xp[i];
        pe = u_prop;
      }
      // 4. adaptation on landing
      if (p.adapt) {
        const int ig = p.i0 + done;
        const int itr = ig + 1;
        const float nf =
            static_cast<float>(ig < p.num_warmup ? itr : itr - p.num_warmup);
        const float gamma = p.lr_decay == 1.0f
                                ? 1.0f / nf
                                : expf(-p.lr_decay * logf(nf));
        float w[D], loc_new[D];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          w[i] = x[i] - loc[i];
          loc_new[i] = loc[i] + gamma * w[i];
        }
        // rank-1 update of sqrt(1 - gamma) S by delta with coefficient gamma
        const float sq = sqrtf(1.0f - gamma);
        float Sn[NL];
        float a = gamma;
        bool bad = false;
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const float diag = sq * S[tri(j, j)];
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
            const float col = sq * S[tri(i, j)];
            w[i] = w[i] - s_w * col;
            const float val = s_col * col + s_new * w[i];
            bad = bad || isnan(val);
            Sn[tri(i, j)] = val;
          }
        }
        float dl = 0.0f, ds = 0.0f;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const float dd = loc_new[i] - loc[i];
          dl = dl + dd * dd;
          loc[i] = loc_new[i];
        }
        if (!bad) {
#pragma unroll
          for (int k = 0; k < NL; ++k) {
            const float dd = Sn[k] - S[k];
            ds = ds + dd * dd;
            S[k] = Sn[k];
          }
        }
        as_chg = sqrtf(dl) + sqrtf(ds);
      }
      ++done;
      if (p.n_frames > 0 && done % p.thinning == 0) {
        const int f = done / p.thinning - 1;
        if (f < p.n_frames) {
#pragma unroll
          for (int i = 0; i < D; ++i) p.fx[(f * D + i) * C + c] = x[i];
          p.fpe[f * C + c] = pe;
          p.fas[f * C + c] = as_chg;
        }
      }
      if (done < p.n_steps) {
        float n[D + 1];
        normals(p, it, c, st, n);
        sl = begin<D, NL>(n, ul, ut, x, pe, loc, S, eps, sqrt_d, z, v);
      }
      trips = 0;
    } else {
      // 5. shrink the bracket toward theta = 0 and redraw
      if (sl.theta < 0.0f) sl.tmin = sl.theta;
      if (sl.theta >= 0.0f) sl.tmax = sl.theta;
      sl.theta = sl.tmin + us * (sl.tmax - sl.tmin);
      ++trips;
    }
    ++it;
  }

#pragma unroll
  for (int i = 0; i < D; ++i) {
    p.x[i * C + c] = x[i];
    p.loc[i * C + c] = loc[i];
#pragma unroll
    for (int j = 0; j < D; ++j)
      p.S[(i * D + j) * C + c] = j <= i ? S[tri(i, j)] : 0.0f;
  }
  p.pe[c] = pe;
  p.as[c] = as_chg;
  p.iters[c] = it;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unsupported J or bad arguments.
extern "C" int asss_fused_eight_schools(
    float* x, float* pe, float* loc, float* S, float* as_change, int* iters,
    const float* y, const float* sigma, const float* unif3, const float* n01,
    float* fx, float* fpe, float* fas, int C, int J, int n_rows, int n_steps,
    int n_frames, int thinning, int i0, int num_warmup, int max_trips,
    int adapt, float lr_decay, float eps, float sqrt_d,
    unsigned long long seed, void* stream_ptr) {
  if (C < 0 || n_steps < 0 || thinning < 1 || n_frames < 0 ||
      (n_frames > 0 && (fx == nullptr || fpe == nullptr || fas == nullptr)) ||
      ((unif3 == nullptr) != (n01 == nullptr)) ||
      (unif3 != nullptr && n_rows < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0 || n_steps == 0) return static_cast<int>(cudaGetLastError());
  const Params p{x,         pe,       loc,      S,        as_change,
                 iters,     y,        sigma,    unif3,    n01,
                 fx,        fpe,      fas,      C,        n_rows,
                 n_steps,   n_frames, thinning, i0,       num_warmup,
                 max_trips, adapt,    lr_decay, eps,      sqrt_d,
                 seed};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = (C + kThreads - 1) / kThreads;
  switch (J) {
    case 8:
      asss_fused_kernel<8><<<blocks, kThreads, 0, stream>>>(p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
