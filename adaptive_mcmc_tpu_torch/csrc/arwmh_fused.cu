// Kernel K2: the fused ARWMH sweep on Hopper (sm_90a), for every target
// with a device potential: eight schools noncentered and centered
// (d = 10), kidiq (d = 4) and diamonds in its sufficient-statistic form
// (d = 26).
//
// Replaces the Pallas TPU kernel built by build_fused_arwmh in
// adaptive_mcmc_tpu/ops/pallas/arwmh_fused.py (_make_kernel / _one_step),
// which traces a target's potential into the kernel; here the potential is
// a policy P of csrc/common.cuh and the kernel a template on it.  Plain
// PyTorch version: fused_arwmh_reference in
// adaptive_mcmc_tpu_torch/ops/cuda/arwmh_fused.py, whose operation order
// this kernel follows.
//
// One launch runs n_steps whole ARWMH transitions.  A chain keeps its whole
// state in registers for the launch: x and loc (d each), the lower half of
// L, pe, the running mean acceptance and log step size.  d = P::D is a
// template parameter, so every loop over d unrolls and all indexing is
// static.  Per step:
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
// What bounds it: latency, not bytes or operations.  The state is read and
// written once per launch and frames are a small thinned stream; each step
// is a dependent chain of a few thousand operations per chain (divisions
// and square roots of the column recursion, exp/log/log1p of the
// potential, Philox rounds), with few warps per SM to hide it.  The design
// keeps every operand in registers and, where a chain's own path is the
// limit, shortens it with a group of lanes (common.cuh), in blocks of one
// warp:
//   * eight schools (d = 10) and diamonds (d = 26), the rows layout:
//     coordinate i lives on lane i % G of the chain's group, in slot i / G,
//     with loc_i and row i of L.  The proposal is a row per coordinate
//     against z_j broadcast by shuffles, the potential's sums gather in
//     coordinate order, the rank-1 update and the NaN guard are common.cuh's
//     rank1_rows, the MH test runs alike on every lane.  Diamonds takes a
//     warp: 2 x 351 factor floats do not fit one thread's registers, a row
//     and its update (2 x 26) fit a lane's.  Eight schools takes one thread
//     (G = 1, every slot on lane 0: the one-thread loop of earlier versions,
//     instruction for instruction): every group of 2 to 32 lanes was slower
//     on an H100, since each of its lanes repeats the column scalars of the
//     rank-1 update, the longest part of a step at d = 10 (PERF.md §6);
//   * kidiq (d = 4): 16 lanes per chain, the state replicated, the
//     434-term data sum split into its 14 running sums.
// Build without fast math: IEEE division and sqrt keep the NaN of an
// indefinite update, and no FMA contraction keeps rounding close to the
// plain version.

#include "common.cuh"

namespace {

using amt::bits01;
using amt::Group;
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

// frame index of step s, or -1 when step s records none
__device__ __forceinline__ int frame_of(const Params& p, int s) {
  const int f = (s + 1) / p.thinning - 1;
  return p.n_frames > 0 && (s + 1) % p.thinning == 0 && f < p.n_frames ? f
                                                                        : -1;
}

// ---- replicated layout: every lane of the group holds the whole chain ----

template <class P>
__global__ void __launch_bounds__(kThreads)
    arwmh_replicated_kernel(const Params p) {
  constexpr int D = P::D;
  constexpr int NL = D * (D + 1) / 2;
  constexpr int kNormalBlocks = (D + 3) / 4;
  int c;
  const Group<P::kLanes> g = amt::this_group<P::kLanes>(&c);
  if (c >= p.C) return;
  const bool writer = g.lane == 0;
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
    float pe_prop = P::potential(xp, data, g);
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
    const float2 ck = amt::adapt_clock(i_glob, p.num_warmup, p.lr_decay);
    const float nf = ck.x, gamma = ck.y;
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
    const int f = frame_of(p, s);
    if (f >= 0 || s == p.n_steps - 1) {
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
    if (f >= 0 && writer) {
#pragma unroll
      for (int i = 0; i < D; ++i) p.fx[(f * D + i) * C + c] = x[i];
      p.fpe[f * C + c] = pe;
      p.fas[f * C + c] = as_chg;
    }
  }

  if (!writer) return;
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

// ---- rows layout: a group of P::kLanes lanes per chain, slot r of lane l
// holding coordinate i = l + kLanes r (x_i, loc_i, z_i and row i of L) for
// i < D ----------------------------------------------------------------------

template <class P>
__global__ void __launch_bounds__(kThreads) arwmh_rows_kernel(const Params p) {
  constexpr int D = P::D;
  constexpr int G = P::kLanes;
  constexpr int S = P::kSlots;
  constexpr int kNormalBlocks = (D + 3) / 4;
  static_assert(G * S >= D, "a slot per coordinate");
  int c;
  const Group<G> g = amt::this_group<G>(&c);
  if (c >= p.C) return;
  const int l = g.lane;
  const size_t C = static_cast<size_t>(p.C);

  typename P::RowData data;
  P::load_row(p.data, p.n_data, l, &data);

  float x[S], loc[S], row[S][D];
#pragma unroll
  for (int r = 0; r < S; ++r) {
    const int i = l + G * r;
    x[r] = loc[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) row[r][j] = 0.0f;
    if (i < D) {
      x[r] = p.x[i * C + c];
      loc[r] = p.loc[i * C + c];
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (j <= i) row[r][j] = p.L[(i * D + j) * C + c];
    }
  }
  float pe = p.pe[c], map = p.map[c], lam = p.lam[c], as_chg = 0.0f;
  const uint2 key = make_uint2(static_cast<uint32_t>(p.seed),
                               static_cast<uint32_t>(c));
  const uint32_t seed_hi = static_cast<uint32_t>(p.seed >> 32);

  for (int s = 0; s < p.n_steps; ++s) {
    const int i_glob = p.i0 + s;
    // 1. draws: each coordinate its own normal (Philox block i / 4), every
    // lane the uniform
    float z[S], u;
    if (p.noise != nullptr) {
#pragma unroll
      for (int r = 0; r < S; ++r) {
        const int i = l + G * r;
        z[r] = i < D ? p.noise[(s * D + i) * C + c] : 0.0f;
      }
      u = p.unif[s * C + c];
    } else {
      amt::philox_normals_rows<G>(static_cast<uint32_t>(i_glob), 0u, seed_hi,
                                  key, l, z);
      const uint4 b = amt::philox4x32_10(
          make_uint4(static_cast<uint32_t>(i_glob), kNormalBlocks, seed_hi,
                     0u),
          key);
      u = bits01(b.x);
    }

    // 2. proposal: row i of L e^lam against z_j broadcast from its lane,
    // after eps z_i, column by column as the plain version
    const float ss = expf(lam);
    float xp[S];
#pragma unroll
    for (int r = 0; r < S; ++r) xp[r] = p.eps * z[r];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float zj = amt::coord(g, z, j);
#pragma unroll
      for (int r = 0; r < S; ++r)
        if (G * r + G - 1 >= j && j <= l + G * r)
          xp[r] = xp[r] + (row[r][j] * ss) * zj;
    }
#pragma unroll
    for (int r = 0; r < S; ++r) xp[r] = x[r] + xp[r];

    // 3.-4. potential and MH accept, alike on every lane
    float pe_prop = P::potential_rows(g, xp, data);
    if (isnan(pe_prop)) pe_prop = CUDART_INF_F;
    const float e = expf(pe - pe_prop);
    const float ap = isnan(e) ? e : fminf(e, 1.0f);
    if (u < ap) {
#pragma unroll
      for (int r = 0; r < S; ++r) x[r] = xp[r];
      pe = pe_prop;
    }

    // 5. adaptation clock and running means
    const float2 ck = amt::adapt_clock(i_glob, p.num_warmup, p.lr_decay);
    const float nf = ck.x, gamma = ck.y;
    map = map + (ap - map) / nf;
    float w[S];
#pragma unroll
    for (int r = 0; r < S; ++r) {
      w[r] = x[r] - loc[r];
      loc[r] = loc[r] + gamma * w[r];
    }

    // 6. rank-1 update with the group's NaN guard
    float rown[S][D];
    const bool bad =
        amt::rank1_rows(g, row, w, gamma, sqrtf(1.0f - gamma), rown);
    const float lam_new = lam + gamma * (ap - p.target_ap);

    // 7. as_change on recorded / final steps (each lane's rows, then the
    // lanes by a butterfly: the plain version's torch.sum has an order of
    // its own), then commit
    const int f = frame_of(p, s);
    if (f >= 0 || s == p.n_steps - 1) {
      const float e1 = expf(lam_new), e0 = expf(lam);
      float part = 0.0f;
#pragma unroll
      for (int r = 0; r < S; ++r) {
        const int i = l + G * r;
#pragma unroll
        for (int j = 0; j < D; ++j) {
          if (j <= i && i < D) {
            const float dv = (bad ? row[r][j] : rown[r][j]) * e1 -
                             row[r][j] * e0;
            part = part + dv * dv;
          }
        }
      }
      float sum = g.xor_sum(part);
      const float zu = 0.0f * e1 - 0.0f * e0;
      sum = sum + static_cast<float>(D * (D - 1) / 2) * (zu * zu);
      as_chg = sqrtf(sum);
    }
    if (!bad) {
#pragma unroll
      for (int r = 0; r < S; ++r)
#pragma unroll
        for (int j = 0; j < D; ++j) row[r][j] = rown[r][j];
    }
    lam = lam_new;
    if (f >= 0) {
#pragma unroll
      for (int r = 0; r < S; ++r) {
        const int i = l + G * r;
        if (i < D) p.fx[(f * D + i) * C + c] = x[r];
      }
      if (l == 0) {
        p.fpe[f * C + c] = pe;
        p.fas[f * C + c] = as_chg;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < S; ++r) {
    const int i = l + G * r;
    if (i < D) {
      p.x[i * C + c] = x[r];
      p.loc[i * C + c] = loc[r];
#pragma unroll
      for (int j = 0; j < D; ++j)
        p.L[(i * D + j) * C + c] = j <= i ? row[r][j] : 0.0f;
    }
  }
  if (l == 0) {
    p.pe[c] = pe;
    p.map[c] = map;
    p.lam[c] = lam;
    p.as[c] = as_chg;
  }
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
  const int blocks = amt::blocks_for<P>(C);
  if constexpr (P::kRows)
    arwmh_rows_kernel<P><<<blocks, kThreads, 0, stream>>>(p);
  else
    arwmh_replicated_kernel<P><<<blocks, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// P's lanes per chain and threads per block, and how many blocks of its
// sweep kernel one SM holds at once, by the occupancy calculator.
template <class P>
int layout(int* lanes, int* threads, int* blocks_per_sm) {
  *lanes = P::kLanes;
  *threads = kThreads;
  cudaError_t err;
  if constexpr (P::kRows)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, arwmh_rows_kernel<P>, kThreads, 0);
  else
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, arwmh_replicated_kernel<P>, kThreads, 0);
  return static_cast<int>(err);
}

}  // namespace

// One entry point per device potential, arwmh_fused_<tag> (the tag of
// Target.device_potential), and arwmh_fused_layout_<tag> for its layout.
// Each returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a D or data length that is not the potential's,
// or bad arguments.
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
  }                                                                           \
  extern "C" int arwmh_fused_layout_##TAG(int* lanes, int* threads,           \
                                          int* blocks_per_sm) {               \
    return layout<POLICY>(lanes, threads, blocks_per_sm);                     \
  }

AMT_ARWMH_FUSED_ENTRY(eight_schools_noncentered,
                      amt::EightSchoolsNoncentered<amt::kEightSchoolsLanesK2>)
AMT_ARWMH_FUSED_ENTRY(eight_schools_centered,
                      amt::EightSchoolsCentered<amt::kEightSchoolsLanesK2>)
AMT_ARWMH_FUSED_ENTRY(kidiq, amt::Kidiq)
AMT_ARWMH_FUSED_ENTRY(diamonds_ss, amt::DiamondsSuffStats)
