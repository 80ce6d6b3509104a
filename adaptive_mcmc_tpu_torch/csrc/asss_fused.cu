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
// One launch advances every chain by n_steps ASSS transitions.  Each chain
// runs its own state machine until it has landed n_steps times: no barrier
// between chains, so a chain's iteration index is its own loop count.
// Chain state: x and loc (d each), the lower half of the scale factor S,
// pe, as_change; and the open transition: the sphere point z and the
// great-circle velocity v (d + 1 each), the slice level t, theta and its
// bracket, the trip count.  d = P::D is a template parameter, so every loop
// over d unrolls and all indexing is static.
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
// What bounds it: latency, not bytes or operations.  The state is read and
// written once per launch; an iteration is a few thousand operations per
// chain, but most of them depend on the one before (the potential's sums,
// the inverse map, and on landing the column recursion's divisions and
// square roots, the forward substitution, the Philox rounds), and the card
// holds only a few warps per SM to hide that.  So the design shortens each
// chain's dependent path by giving it a group of lanes (common.cuh), in
// blocks of one warp:
//   * eight schools (d = 10) and diamonds (d = 26), the rows layout:
//     coordinate i lives on lane i % G of the chain's group, in slot i / G,
//     with loc_i, z_i, v_i and row i of S; coordinate d holds z_d and v_d.
//     The inverse map is a row per coordinate (x_j / pole broadcast by
//     shuffles), the forward substitution and the rank-1 update go column
//     by column with the column's scalars broadcast, the NaN guard is a
//     vote of the group, and the d-sums (nsq, dot, vv and the potential's)
//     gather in coordinate order, which is the plain version's
//     left-to-right order.  Eight schools takes 16 lanes, two chains a
//     warp: 4096 chains make 2048 warps, where one thread per chain made
//     128, one warp on each SM that ran the landing and the shrinking
//     branch of its 32 chains on most iterations (16 lanes beat 1 to 32 on
//     an H100, PERF.md §6).  Diamonds takes a warp: the 351-float factor
//     and its guard copy fit no thread's registers; a lane holds two rows.
//   * kidiq (d = 4): a group of 16 lanes, two chains per warp.  The state
//     is replicated on every lane; the 434-term data sum runs as 14 lanes'
//     running sums (its plain version's sum_strided order), met in lane
//     order.  The serial sum of 434 terms becomes 31 per lane.
// The chains of one warp land on different iterations, so where a warp
// holds two (eight schools, kidiq) it runs both branches on many
// iterations; a diamonds warp never does.
// Build without fast math: IEEE division and sqrt keep the NaN of an
// indefinite update, and no FMA contraction keeps rounding equal to the
// plain version, so that near-ties of the slice test fall the same way.

#include "common.cuh"

namespace {

using amt::Group;
using amt::tri;

constexpr int kThreads = 32;

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

__device__ __forceinline__ Stream stream_of(const Params& p, int c) {
  return Stream{make_uint2(static_cast<uint32_t>(p.seed),
                           static_cast<uint32_t>(c)),
                static_cast<uint32_t>(p.seed >> 32)};
}

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

// the N velocity normals of iteration it in the rows layout: slot r of
// lane l holds coordinate l + G r's (0 past N with injected draws)
template <int N, int G, int S>
__device__ __forceinline__ void normals_rows(const Params& p, int it, int c,
                                             const Stream& st, int lane,
                                             float (&n)[S]) {
  if (p.n01 != nullptr) {
    const size_t C = static_cast<size_t>(p.C);
    const size_t row = static_cast<size_t>(min(it, p.n_rows - 1));
#pragma unroll
    for (int r = 0; r < S; ++r) {
      const int i = lane + G * r;
      n[r] = i < N ? p.n01[(row * N + i) * C + c] : 0.0f;
    }
  } else {
    amt::philox_normals_rows<G>(static_cast<uint32_t>(it), 1u, st.seed_hi,
                                st.key, lane, n);
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

__device__ __forceinline__ Slice slice_of(float pe_t, float ul, float ut) {
  Slice s;
  s.t = pe_t - logf(ul);
  s.theta = ut * amt::kTwoPi;
  s.tmin = s.theta - amt::kTwoPi;
  s.tmax = s.theta;
  return s;
}

__device__ __forceinline__ void shrink(Slice* sl, float us) {
  if (sl->theta < 0.0f) sl->tmin = sl->theta;
  if (sl->theta >= 0.0f) sl->tmax = sl->theta;
  sl->theta = sl->tmin + us * (sl->tmax - sl->tmin);
}

// ---- replicated layout: every lane of the group holds the whole chain ----

// Open a transition at (x, pe) under (loc, S): sphere point z, tangent
// velocity v, slice level and bracket.
template <int D>
__device__ __forceinline__ Slice begin(const float (&n01)[D + 1], float ul,
                                       float ut, const float (&x)[D],
                                       float pe, const float (&loc)[D],
                                       const float (&S)[D * (D + 1) / 2],
                                       float eps, float sqrt_d,
                                       float (&z)[D + 1], float (&v)[D + 1]) {
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
  return slice_of(pe_t, ul, ut);
}

template <class P>
__global__ void __launch_bounds__(kThreads)
    asss_replicated_kernel(const Params p) {
  constexpr int D = P::D;
  constexpr int NL = D * (D + 1) / 2;
  int c;
  const Group<P::kLanes> g = amt::this_group<P::kLanes>(&c);
  if (c >= p.C) return;
  const bool writer = g.lane == 0;
  const size_t C = static_cast<size_t>(p.C);
  const float eps = p.eps, sqrt_d = p.sqrt_d;

  typename P::Data data;
  P::load(p.data, p.n_data, &data);

  float x[D], loc[D], S[NL];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    x[i] = p.x[i * C + c];
    loc[i] = p.loc[i * C + c];
#pragma unroll
    for (int j = 0; j <= i; ++j) S[tri(i, j)] = p.S[(i * D + j) * C + c];
  }
  float pe = p.pe[c], as_chg = p.as[c];
  const Stream st = stream_of(p, c);

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
    float u_prop = P::potential(xp, data, g);
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
        const float gamma =
            amt::adapt_clock(p.i0 + done, p.num_warmup, p.lr_decay).y;
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
      if (writer && p.n_frames > 0 && done % p.thinning == 0) {
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
      shrink(&sl, us);
      ++trips;
    }
    ++it;
  }

  if (!writer) return;
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

// ---- rows layout: a group of P::kLanes lanes per chain, slot r of lane l
// holding coordinate i = l + kLanes r: x_i, loc_i, z_i, v_i and row i of S
// for i < D, z_D and v_D for i = D ---------------------------------------

// begin in the rows layout, each coordinate i <= D with its normal n;
// returns the slice and sets z and v.  Same operations and order as begin
// above.
template <int D, int G, int S>
__device__ __forceinline__ Slice begin_rows(const Group<G>& g,
                                            const float (&n)[S], float ul,
                                            float ut, const float (&x)[S],
                                            float pe, const float (&loc)[S],
                                            const float (&row)[S][D],
                                            float eps, float sqrt_d,
                                            float (&z)[S], float (&v)[S]) {
  const int l = g.lane;
  float ys[S], xr[S];
#pragma unroll
  for (int r = 0; r < S; ++r) {
    ys[r] = x[r] - loc[r];
    xr[r] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (l == k % G)
      xr[k / G] = ys[k / G] / ((row[k / G][k] + eps) * sqrt_d);
    const float xrk = amt::coord(g, xr, k);
#pragma unroll
    for (int r = 0; r < S; ++r) {
      const int i = l + G * r;
      if (G * r + G - 1 > k && i > k && i < D)
        ys[r] = ys[r] - (row[r][k] * sqrt_d) * xrk;
    }
  }
  float sq[S];
#pragma unroll
  for (int r = 0; r < S; ++r) sq[r] = xr[r] * xr[r];
  const float nsq = amt::ordered_sum<D>(g, sq);
  const float np1 = nsq + 1.0f;
  const float zd = (nsq - 1.0f) / np1;
  float nz[S];
#pragma unroll
  for (int r = 0; r < S; ++r) {
    const int i = l + G * r;
    z[r] = i < D ? (2.0f * xr[r]) / np1 : (i == D ? zd : 0.0f);
    nz[r] = n[r] * z[r];
  }
  const float pe_t = pe + static_cast<float>(D) * logf(1.0f - zd);
  const float dot = amt::ordered_sum<D + 1>(g, nz);
#pragma unroll
  for (int r = 0; r < S; ++r) {
    v[r] = n[r] - dot * z[r];
    sq[r] = v[r] * v[r];
  }
  const float nrm = sqrtf(amt::ordered_sum<D + 1>(g, sq));
#pragma unroll
  for (int r = 0; r < S; ++r) v[r] = v[r] / nrm;
  return slice_of(pe_t, ul, ut);
}

template <class P>
__global__ void __launch_bounds__(kThreads) asss_rows_kernel(const Params p) {
  constexpr int D = P::D;
  constexpr int G = P::kLanes;
  constexpr int S = P::kSlots;
  static_assert(G * S > D, "a slot per coordinate and the last sphere one");
  int c;
  const Group<G> g = amt::this_group<G>(&c);
  if (c >= p.C) return;
  const int l = g.lane;
  const size_t C = static_cast<size_t>(p.C);
  const float eps = p.eps, sqrt_d = p.sqrt_d;

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
        if (j <= i) row[r][j] = p.S[(i * D + j) * C + c];
    }
  }
  float pe = p.pe[c], as_chg = p.as[c];
  const Stream st = stream_of(p, c);

  float z[S], v[S], n[S];
  Slice sl{};
  int it = 0, trips = 0, done = 0;
  if (p.n_steps > 0) {
    float us, ul, ut;
    uniforms(p, 0, c, st, &us, &ul, &ut);
    normals_rows<D + 1, G>(p, 0, c, st, l, n);
    sl = begin_rows(g, n, ul, ut, x, pe, loc, row, eps, sqrt_d, z, v);
    it = 1;
  }

  while (done < p.n_steps) {
    float us, ul, ut;
    uniforms(p, it, c, st, &us, &ul, &ut);

    // 2. the potential at the inverse map of z cos(theta) + v sin(theta):
    // row i of the factor against xb_j broadcast from its lane
    const float cs = cosf(sl.theta), sn = sinf(sl.theta);
    float xb[S], xp[S];
#pragma unroll
    for (int r = 0; r < S; ++r) xb[r] = z[r] * cs + v[r] * sn;
    const float pole = 1.0f - amt::coord(g, xb, D);
#pragma unroll
    for (int r = 0; r < S; ++r) {
      xb[r] = xb[r] / pole;
      xp[r] = loc[r];
    }
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float xbj = amt::coord(g, xb, j);
#pragma unroll
      for (int r = 0; r < S; ++r) {
        const int i = l + G * r;
        if (G * r + G - 1 >= j && j <= i && i < D)
          xp[r] = xp[r] + ((i == j ? row[r][j] + eps : row[r][j]) * sqrt_d) *
                              xbj;
      }
    }
    float u_prop = P::potential_rows(g, xp, data);
    if (isnan(u_prop)) u_prop = CUDART_INF_F;

    // 3. slice test and bail-out (every lane holds the same values)
    const bool good =
        (u_prop + static_cast<float>(D) * logf(pole) <= sl.t) && (pole >= eps);
    const bool bail = trips >= p.max_trips;
    if (good || bail) {
      if (!bail) {
#pragma unroll
        for (int r = 0; r < S; ++r) x[r] = xp[r];
        pe = u_prop;
      }
      // 4. adaptation on landing
      if (p.adapt) {
        const float gamma =
            amt::adapt_clock(p.i0 + done, p.num_warmup, p.lr_decay).y;
        float w[S], dl = 0.0f;
#pragma unroll
        for (int r = 0; r < S; ++r) {
          w[r] = x[r] - loc[r];
          // the sums of squares over lanes: the plain version's torch.sum
          // has an order of its own, and as_change feeds nothing back; the
          // slots past coordinate D - 1 hold zeros
          const float dd = (loc[r] + gamma * w[r]) - loc[r];
          dl = dl + dd * dd;
        }
        float rown[S][D];
        const bool bad =
            amt::rank1_rows(g, row, w, gamma, sqrtf(1.0f - gamma), rown);
#pragma unroll
        for (int r = 0; r < S; ++r) loc[r] = loc[r] + gamma * w[r];
        float ds = 0.0f;
        if (!bad) {
#pragma unroll
          for (int r = 0; r < S; ++r)
#pragma unroll
            for (int j = 0; j < D; ++j) {
              const float e = rown[r][j] - row[r][j];
              ds = ds + e * e;
              row[r][j] = rown[r][j];
            }
          ds = g.xor_sum(ds);
        }
        as_chg = sqrtf(g.xor_sum(dl)) + sqrtf(ds);
      }
      ++done;
      if (p.n_frames > 0 && done % p.thinning == 0) {
        const int f = done / p.thinning - 1;
        if (f < p.n_frames) {
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
      if (done < p.n_steps) {
        normals_rows<D + 1, G>(p, it, c, st, l, n);
        sl = begin_rows(g, n, ul, ut, x, pe, loc, row, eps, sqrt_d, z, v);
      }
      trips = 0;
    } else {
      // 5. shrink the bracket toward theta = 0 and redraw
      shrink(&sl, us);
      ++trips;
    }
    ++it;
  }

#pragma unroll
  for (int r = 0; r < S; ++r) {
    const int i = l + G * r;
    if (i < D) {
      p.x[i * C + c] = x[r];
      p.loc[i * C + c] = loc[r];
#pragma unroll
      for (int j = 0; j < D; ++j)
        p.S[(i * D + j) * C + c] = j <= i ? row[r][j] : 0.0f;
    }
  }
  if (l == 0) {
    p.pe[c] = pe;
    p.as[c] = as_chg;
    p.iters[c] = it;
  }
}

// The device potential alone at x (D, C) into out (C,), one group per
// chain: holds each policy against its plain PyTorch version on the card.
template <class P>
__global__ void __launch_bounds__(kThreads)
    potential_kernel(const float* x, float* out, const float* raw,
                     int n_data, int C) {
  int c;
  const Group<P::kLanes> g = amt::this_group<P::kLanes>(&c);
  if (c >= C) return;
  const size_t Cs = static_cast<size_t>(C);
  float u;
  if constexpr (P::kRows) {
    typename P::RowData data;
    P::load_row(raw, n_data, g.lane, &data);
    float xs[P::kSlots];
#pragma unroll
    for (int r = 0; r < P::kSlots; ++r) {
      const int i = g.lane + P::kLanes * r;
      xs[r] = i < P::D ? x[i * Cs + c] : 0.0f;
    }
    u = P::potential_rows(g, xs, data);
  } else {
    typename P::Data data;
    P::load(raw, n_data, &data);
    float xc[P::D];
#pragma unroll
    for (int i = 0; i < P::D; ++i) xc[i] = x[i * Cs + c];
    u = P::potential(xc, data, g);
  }
  if (g.lane == 0) out[c] = u;
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
  const Params p{x,         pe,       loc,      S,        as_change,
                 iters,     data,     n_data,   unif3,    n01,
                 fx,        fpe,      fas,      C,        n_rows,
                 n_steps,   n_frames, thinning, i0,       num_warmup,
                 max_trips, adapt,    lr_decay, eps,      sqrt_d,
                 seed};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = amt::blocks_for<P>(C);
  if constexpr (P::kRows)
    asss_rows_kernel<P><<<blocks, kThreads, 0, stream>>>(p);
  else
    asss_replicated_kernel<P><<<blocks, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class P>
int launch_potential(const float* x, float* out, const float* data,
                     int n_data, int C, int D, void* stream_ptr) {
  if (D != P::D || !P::data_ok(n_data) || data == nullptr || C < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  potential_kernel<P><<<amt::blocks_for<P>(C), kThreads, 0, stream>>>(
      x, out, data, n_data, C);
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
        blocks_per_sm, asss_rows_kernel<P>, kThreads, 0);
  else
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, asss_replicated_kernel<P>, kThreads, 0);
  return static_cast<int>(err);
}

}  // namespace

// One entry point per device potential, asss_fused_<tag> (the tag of
// Target.device_potential), asss_fused_potential_<tag> for the potential
// alone and asss_fused_layout_<tag> for its layout.  Each returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a D or data length that is not the potential's,
// or bad arguments.
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
  }                                                                           \
  extern "C" int asss_fused_layout_##TAG(int* lanes, int* threads,            \
                                         int* blocks_per_sm) {                \
    return layout<POLICY>(lanes, threads, blocks_per_sm);                     \
  }

AMT_ASSS_FUSED_ENTRY(eight_schools_noncentered,
                     amt::EightSchoolsNoncentered<amt::kEightSchoolsLanesK3>)
AMT_ASSS_FUSED_ENTRY(eight_schools_centered,
                     amt::EightSchoolsCentered<amt::kEightSchoolsLanesK3>)
AMT_ASSS_FUSED_ENTRY(kidiq, amt::Kidiq)
AMT_ASSS_FUSED_ENTRY(diamonds_ss, amt::DiamondsSuffStats)
