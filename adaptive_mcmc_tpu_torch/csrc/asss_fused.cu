// Kernel K3: the fused ASSS sweep on Hopper (sm_90a), for every target
// with a device potential: eight schools noncentered and centered (d = 10),
// kidiq (d = 4) and diamonds in its sufficient-statistic form (d = 26).
//
// Replaces the Pallas TPU kernel built by build_fused_asss in
// adaptive_mcmc_tpu/ops/pallas/asss_fused.py (_make_kernel), which traces a
// target's potential into the kernel; here the potential is a policy P of
// csrc/common.cuh and the kernel a template on it.  Plain PyTorch version:
// fused_asss_reference in adaptive_mcmc_tpu_torch/ops/cuda/asss_fused.py,
// whose operation order this kernel follows.
//
// One launch advances every chain by n_steps ASSS transitions.  One thread
// owns one chain and runs its own state machine until it has landed n_steps
// times: no barrier between chains, so a chain's iteration index is its own
// loop count.  Chain state: x and loc (d each), the lower half of the scale
// factor S (d(d+1)/2 floats), pe, as_change; and the open transition: the
// sphere point z and the great-circle velocity v (d + 1 each), the slice
// level t, theta and its bracket, the trip count.  d = P::D is a template
// parameter, so every loop over d unrolls and all indexing is static.
//
// Where the factor lives.  At d <= 16 everything is in registers (d = 10:
// the 55-float factor, and in the landing branch the new factor for the NaN
// guard; 235 registers and no spills at d = 10).  At d = 26 the factor is
// 351 floats and the guard needs a second copy, which no thread's 255
// registers hold, so both copies live in dynamic shared memory, chains
// last: entry k of thread t's factor at [k][t], so a block's threads read
// consecutive words, one per bank.  The landing writes the new factor
// into the spare copy and, if it has no NaN, swaps the two pointers, so the
// guard copies nothing.  x, loc, z and v stay in registers, and ptxas spills
// what does not fit (PERF.md has its report).  A block holds 8 chains there,
// not 32: 2 x 351 x 8 x 4 = 22,464 bytes of shared memory per block, and
// 1024 chains spread over 128 SMs rather than 32.
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
//      injected n01 (R, D + 1, C), or Philox blocks 1, 2, ...);
//   5. otherwise: shrink the bracket toward 0 and redraw theta in it.
// begin projects x to the sphere (forward substitution, then the
// stereographic map), sets the level t = pe + d log(1 - z_d) - log u_level
// from the stored potential, the tangent velocity, and theta = 2 pi u_theta
// with the bracket [theta - 2 pi, theta].
//
// Bound: arithmetic latency and divergence, not bytes.  Each iteration is a
// dependent chain of a few thousand instructions per thread (the potential,
// the d(d+1)/2 inverse map; on landing the column recursion's divisions and
// square roots, the projection and the Philox blocks of normals), and the
// state is read and written once per launch.  A warp's threads land on
// different iterations, so a warp runs both the landing and the shrinking
// branch on most iterations; over a long call the iteration counts of a
// warp's threads differ only by a short tail.  One warp per block (a
// quarter warp at d = 26) spreads the chains over the SMs.  Build without
// fast math: IEEE division and sqrt keep the NaN of an indefinite update,
// and no FMA contraction keeps rounding equal to the plain version, so that
// near-ties of the slice test fall the same way.

#include "common.cuh"

#include <type_traits>

namespace {

using amt::tri;

constexpr int kThreads = 32;
// largest d whose factor stays in registers
constexpr int kMaxRegisterD = 16;
// chains per block where the factor lives in shared memory: a quarter
// warp, so that the slice's 1024 chains make 128 blocks and reach 128 of
// the 132 SMs instead of 32
constexpr int kSmemThreads = 8;

struct Params {
  float* x;      // (D, C)
  float* pe;     // (C,)
  float* loc;    // (D, C)
  float* S;      // (D, D, C)
  float* as;     // (C,)
  int* iters;    // (C,) iterations each chain ran, iteration 0 included
  const float* data;   // the target's kernel_data (n_data floats)
  int n_data;
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

// The packed lower half of a chain's factor: in registers ...
template <int NL>
struct RegFactor {
  float e[NL];
  __device__ __forceinline__ float get(int k) const { return e[k]; }
  __device__ __forceinline__ void set(int k, float v) { e[k] = v; }
};

// ... or in shared memory, entry k of this thread's factor at
// e[k * kSmemThreads]
struct SmemFactor {
  float* e;
  __device__ __forceinline__ float get(int k) const {
    return e[k * kSmemThreads];
  }
  __device__ __forceinline__ void set(int k, float v) {
    e[k * kSmemThreads] = v;
  }
};

template <int D>
using FactorOf = std::conditional_t<(D <= kMaxRegisterD),
                                    RegFactor<D*(D + 1) / 2>, SmemFactor>;

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return D <= kMaxRegisterD
             ? 0
             : 2 * sizeof(float) * (D * (D + 1) / 2) * kSmemThreads;
}

// chains per block
template <int D>
constexpr int block_threads() {
  return D <= kMaxRegisterD ? kThreads : kSmemThreads;
}

// entry (i, j) of the whitening factor (S + eps I) sqrt(d)
template <class F>
__device__ __forceinline__ float sig(const F& S, int i, int j, float eps,
                                     float sqrt_d) {
  return (i == j ? S.get(tri(i, j)) + eps : S.get(tri(i, j))) * sqrt_d;
}

struct Slice {
  float t;      // slice level of the transformed potential
  float theta;  // angle on the great circle
  float tmin;   // bracket
  float tmax;
};

// Open a transition at (x, pe) under (loc, S): sphere point z, tangent
// velocity v, slice level and bracket.
template <int D, class F>
__device__ __forceinline__ Slice begin(const float (&n01)[D + 1], float ul,
                                       float ut, const float (&x)[D],
                                       float pe, const float (&loc)[D],
                                       const F& S, float eps,
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

template <class P>
__global__ void __launch_bounds__(kThreads) asss_fused_kernel(const Params p) {
  constexpr int D = P::D;
  constexpr int NL = D * (D + 1) / 2;
  using Factor = FactorOf<D>;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= p.C) return;
  const size_t C = static_cast<size_t>(p.C);
  const float eps = p.eps, sqrt_d = p.sqrt_d;

  typename P::Data data;
  P::load(p.data, p.n_data, &data);

  // S and, for the shared-memory factor, the spare copy the guard writes
  Factor S;
  float* spare = nullptr;
  if constexpr (smem_bytes<D>() > 0) {
    extern __shared__ float smem[];
    S.e = smem + threadIdx.x;
    spare = smem + NL * kSmemThreads + threadIdx.x;
  }
  float x[D], loc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    x[i] = p.x[i * C + c];
    loc[i] = p.loc[i * C + c];
#pragma unroll
    for (int j = 0; j <= i; ++j) S.set(tri(i, j), p.S[(i * D + j) * C + c]);
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
    sl = begin<D>(n, ul, ut, x, pe, loc, S, eps, sqrt_d, z, v);
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
    float u_prop = P::potential(xp, data);
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
        Factor Sn;
        if constexpr (smem_bytes<D>() > 0) Sn.e = spare;
        float a = gamma;
        bool bad = false;
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const float diag = sq * S.get(tri(j, j));
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
            const float col = sq * S.get(tri(i, j));
            w[i] = w[i] - s_w * col;
            const float val = s_col * col + s_new * w[i];
            bad = bad || isnan(val);
            Sn.set(tri(i, j), val);
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
            const float dd = Sn.get(k) - S.get(k);
            ds = ds + dd * dd;
          }
          if constexpr (smem_bytes<D>() > 0) {
            spare = S.e;
            S.e = Sn.e;
          } else {
            S = Sn;
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
        sl = begin<D>(n, ul, ut, x, pe, loc, S, eps, sqrt_d, z, v);
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
      p.S[(i * D + j) * C + c] = j <= i ? S.get(tri(i, j)) : 0.0f;
  }
  p.pe[c] = pe;
  p.as[c] = as_chg;
  p.iters[c] = it;
}

// the device potential alone at x (D, C) into out (C,): holds each policy
// against its plain PyTorch version on the card
template <class P>
__global__ void __launch_bounds__(kThreads)
    potential_kernel(const float* x, float* out, const float* raw, int n_data,
                     int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  typename P::Data data;
  P::load(raw, n_data, &data);
  float xc[P::D];
#pragma unroll
  for (int i = 0; i < P::D; ++i) xc[i] = x[static_cast<size_t>(i) * C + c];
  out[c] = P::potential(xc, data);
}

template <class P>
int launch(float* x, float* pe, float* loc, float* S, float* as_change,
           int* iters, const float* data, int n_data, const float* unif3,
           const float* n01, float* fx, float* fpe, float* fas, int C, int D,
           int n_rows, int n_steps, int n_frames, int thinning, int i0,
           int num_warmup, int max_trips, int adapt, float lr_decay,
           float eps, float sqrt_d, unsigned long long seed,
           void* stream_ptr) {
  if (D != P::D || !P::data_ok(n_data) || data == nullptr || C < 0 ||
      n_steps < 0 || thinning < 1 || n_frames < 0 ||
      (n_frames > 0 && (fx == nullptr || fpe == nullptr || fas == nullptr)) ||
      ((unif3 == nullptr) != (n01 == nullptr)) ||
      (unif3 != nullptr && n_rows < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0 || n_steps == 0) return static_cast<int>(cudaGetLastError());
  constexpr size_t kSmem = smem_bytes<P::D>();
  static_assert(kSmem <= 48 * 1024,
                "above 48 KB the launch must raise the kernel's dynamic "
                "shared memory limit first");
  const Params p{x,         pe,       loc,      S,        as_change,
                 iters,     data,     n_data,   unif3,    n01,
                 fx,        fpe,      fas,      C,        n_rows,
                 n_steps,   n_frames, thinning, i0,       num_warmup,
                 max_trips, adapt,    lr_decay, eps,      sqrt_d,
                 seed};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  constexpr int kBlock = block_threads<P::D>();
  const int blocks = (C + kBlock - 1) / kBlock;
  asss_fused_kernel<P><<<blocks, kBlock, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class P>
int launch_potential(const float* x, float* out, const float* data,
                     int n_data, int C, int D, void* stream_ptr) {
  if (D != P::D || !P::data_ok(n_data) || data == nullptr || C < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = (C + kThreads - 1) / kThreads;
  potential_kernel<P><<<blocks, kThreads, 0, stream>>>(x, out, data, n_data,
                                                       C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry point per device potential, asss_fused_<tag> (the tag of
// Target.device_potential), and asss_fused_potential_<tag> for the potential
// alone.  Each returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue for a D or data length that is not the
// potential's, or bad arguments.
#define AMT_ASSS_FUSED_ENTRY(TAG, POLICY)                                     \
  extern "C" int asss_fused_##TAG(                                            \
      float* x, float* pe, float* loc, float* S, float* as_change,            \
      int* iters, const float* data, int n_data, const float* unif3,          \
      const float* n01, float* fx, float* fpe, float* fas, int C, int D,      \
      int n_rows, int n_steps, int n_frames, int thinning, int i0,            \
      int num_warmup, int max_trips, int adapt, float lr_decay, float eps,    \
      float sqrt_d, unsigned long long seed, void* stream_ptr) {              \
    return launch<POLICY>(x, pe, loc, S, as_change, iters, data, n_data,      \
                          unif3, n01, fx, fpe, fas, C, D, n_rows, n_steps,    \
                          n_frames, thinning, i0, num_warmup, max_trips,      \
                          adapt, lr_decay, eps, sqrt_d, seed, stream_ptr);    \
  }                                                                           \
  extern "C" int asss_fused_potential_##TAG(const float* x, float* out,       \
                                            const float* data, int n_data,    \
                                            int C, int D, void* stream_ptr) { \
    return launch_potential<POLICY>(x, out, data, n_data, C, D, stream_ptr);  \
  }

AMT_ASSS_FUSED_ENTRY(eight_schools_noncentered, amt::EightSchoolsNoncentered)
AMT_ASSS_FUSED_ENTRY(eight_schools_centered, amt::EightSchoolsCentered)
AMT_ASSS_FUSED_ENTRY(kidiq, amt::Kidiq)
AMT_ASSS_FUSED_ENTRY(diamonds_ss, amt::DiamondsSuffStats)
