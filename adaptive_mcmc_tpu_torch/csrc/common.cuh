// Device helpers shared by the fused sweeps K2 (arwmh_fused.cu) and K3
// (asss_fused.cu): the counter-based Philox4x32-10 generator, its uniform
// and Box-Muller normal transforms, the lane groups that run one chain
// together, the target potentials, and the rank-1 factor update of a
// factor held one row per lane.  One copy, so that both kernels draw and
// round alike.
//
// A chain runs on a group of P::kLanes lanes of one warp (Group below), in
// one of two layouts:
//   * replicated (P::kRows false): every lane of the group holds the whole
//     chain state and runs the same arithmetic; only the potential splits
//     its work across the lanes (kidiq's data sum), and lane 0 writes.
//     P::Data, filled by P::load(data, n_data, &view), and
//     P::potential(x[D], view, group), the negative log density at x;
//   * rows (P::kRows true): coordinate i < D, with row i of the d x d
//     factor, lives on lane i % kLanes in slot i / kLanes, and so does K3's
//     last sphere coordinate i = D; P::kSlots slots hold the D + 1
//     coordinates, and the slots past them idle through the same
//     instructions.  Eight schools (d = 10) runs on 16 lanes in K3 (two
//     chains a warp) and on one thread in K2 (lane 0 holds every slot);
//     diamonds (d = 26) on a whole warp, one slot a lane.
//     P::RowData, filled by P::load_row(data, n_data, lane, &view), and
//     P::potential_rows(group, x_slots, view), which every lane returns.
// D is P::D, the float count of the flat data is checked by
// P::data_ok(n_data).  The data is the target's data["kernel_data"]
// (models/targets.py).  Each potential follows its plain PyTorch version's
// operation order one rounding at a time, built without FMA contraction;
// a cross-lane sum that the plain version takes left to right is gathered
// in lane order (ordered_sum).  A Python constant is folded here in double
// in the order Python folds it, then rounded to float as PyTorch rounds a
// Python scalar.

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
// The doubles Python folds (each the repr of its Python value; the CPU tests
// hold every `constexpr double` here against its expression).
constexpr double kLog2 = 0.6931471805599453;            // math.log(2.0)
constexpr double kLogPi = 1.1447298858494002;           // math.log(math.pi)
constexpr double kLog2p5 = 0.9162907318741551;          // math.log(2.5)
constexpr double kLog3 = 1.0986122886681098;            // math.log(3.0)
constexpr double kLog10 = 2.302585092994046;            // math.log(10.0)
constexpr double kLgamma2 = 0.0;                        // math.lgamma(2.0)
constexpr double kLgamma1p5 = -0.12078223763524543;     // math.lgamma(1.5)
// half-Cauchy(2.5): log 2 - log pi - log 2.5
constexpr float kHalfCauchy2p5 = static_cast<float>(kLog2 - kLogPi - kLog2p5);
// Student-t(3, loc, 10): lgamma(2) - lgamma(1.5) - log(3) / 2 - log(pi) / 2
// - log(10)
constexpr float kStudentT3Scale10 = static_cast<float>(
    kLgamma2 - kLgamma1p5 - 0.5 * kLog3 - 0.5 * kLogPi - kLog10);

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

// Normal i of philox_normals alone, bit for bit: a lane of a row group
// draws its own coordinate's normal (block first_block + i / 4).
__device__ __forceinline__ float philox_normal_at(uint32_t ctr,
                                                  uint32_t first_block,
                                                  uint32_t seed_hi,
                                                  uint2 key, int i) {
  const uint4 r = philox4x32_10(
      make_uint4(ctr, first_block + static_cast<uint32_t>(i / 4), seed_hi,
                 0u),
      key);
  float n0, n1;
  if ((i & 3) < 2) {
    box_muller(r.x, r.y, &n0, &n1);
  } else {
    box_muller(r.z, r.w, &n0, &n1);
  }
  return (i & 1) ? n1 : n0;
}

// The normals of coordinates lane, lane + G, lane + 2 G, ... into z (the
// rows layout's slots), each philox_normals' normal of its coordinate; one
// thread (G = 1) draws each block once.
template <int G, int S>
__device__ __forceinline__ void philox_normals_rows(uint32_t ctr,
                                                    uint32_t first_block,
                                                    uint32_t seed_hi,
                                                    uint2 key, int lane,
                                                    float (&z)[S]) {
  if constexpr (G == 1) {
    philox_normals<S>(ctr, first_block, seed_hi, key, z);
  } else {
#pragma unroll
    for (int r = 0; r < S; ++r)
      z[r] = philox_normal_at(ctr, first_block, seed_hi, key, lane + G * r);
  }
}

// ---- lane groups -----------------------------------------------------------

// The G lanes of one warp that run one chain (G divides 32; G = 1 is one
// thread per chain).  A group's lanes follow one control flow: every branch
// reads values that all of them hold alike.  The other groups of the warp
// may branch otherwise (a K3 chain landing while its neighbour shrinks), so
// every shuffle and vote names the group's own lanes (mask) and never the
// warp's.
template <int G>
struct Group {
  static_assert(G == 1 || G == 2 || G == 4 || G == 8 || G == 16 || G == 32,
                "a group is a power-of-two slice of a warp");
  int lane;       // 0 .. G - 1
  unsigned mask;  // the group's lanes within the warp

  // v of lane src, to every lane of the group
  __device__ __forceinline__ float bcast(float v, int src) const {
    if constexpr (G == 1) return v;
    else return __shfl_sync(mask, v, src, G);
  }
  // whether b holds on any lane of the group
  __device__ __forceinline__ bool any(bool b) const {
    if constexpr (G == 1) return b;
    else return __any_sync(mask, b) != 0;
  }
  // the sum over the group's lanes by an xor butterfly: every lane gets
  // the same bits (each level adds the same two values in either order)
  __device__ __forceinline__ float xor_sum(float v) const {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      v = v + __shfl_xor_sync(mask, v, o, G);
    return v;
  }
};

// the group of the calling thread and its chain's index
template <int G>
__device__ __forceinline__ Group<G> this_group(int* chain) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  *chain = t / G;
  Group<G> g;
  g.lane = t % G;
  const int first = (threadIdx.x % 32) / G * G;
  g.mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << first;
  return g;
}

// ---- the rows layout ------------------------------------------------------

// A chain's coordinate i lives on lane i % G of its group, in slot i / G of
// that lane's arrays: row_slots<N, G>() slots hold N coordinates.  Every
// index into a slot array is a constant of an unrolled loop, so the arrays
// stay in registers.
template <int N, int G>
__host__ __device__ constexpr int row_slots() {
  return (N + G - 1) / G;
}

// coordinate i of the slot array v, to every lane of the group
template <int G, int S>
__device__ __forceinline__ float coord(const Group<G>& g, const float (&v)[S],
                                       int i) {
  return g.bcast(v[i / G], i % G);
}

// coordinates First, First + 1, ..., First + N - 1 of the slot array v
// summed left to right, on every lane: the order of the plain version's
// sum_in_order
template <int N, int First = 0, int G, int S>
__device__ __forceinline__ float ordered_sum(const Group<G>& g,
                                             const float (&v)[S]) {
  float s = coord(g, v, First);
#pragma unroll
  for (int k = 1; k < N; ++k) s = s + coord(g, v, First + k);
  return s;
}

// the same of one value per lane, lane i holding term i
template <int N, int First = 0, int G>
__device__ __forceinline__ float ordered_sum(const Group<G>& g, float v) {
  const float one[1] = {v};
  return ordered_sum<N, First>(g, one);
}

// ---- the adaptation clock --------------------------------------------------

// (n as float, gamma = n^-lr_decay) of global step i (0-based), n restarted
// after warm-up; gamma as exp(-r log n), or 1 / n at r = 1
__device__ __forceinline__ float2 adapt_clock(int i, int num_warmup,
                                              float lr_decay) {
  const int itr = i + 1;
  const float nf = static_cast<float>(i < num_warmup ? itr : itr - num_warmup);
  const float gamma =
      lr_decay == 1.0f ? 1.0f / nf : expf(-lr_decay * logf(nf));
  return make_float2(nf, gamma);
}

// ---- the rank-1 update of a factor held a row per coordinate -------------

// GGMS74-C1 update of sqrt(1 - gamma) S by w with coefficient gamma, for a
// factor held in the rows layout: slot r of lane l holds row i = l + G r of
// S (row[r][j], j <= i) and w_i, for i < D.  Column j runs on every lane:
// S_jj and w_j are broadcast from their lane, every lane computes the
// column's scalars alike, and each row i >= j updates its entry and w_i.
// Each element's operations and their order are those of
// chol_update_cl_reference (and of a one-thread loop).  Writes the new rows
// to out (zeros above the diagonal and past row D - 1) and returns whether
// any entry of the group's new factor is NaN (the caller then keeps the old
// factor).
template <int D, int G, int S>
__device__ __forceinline__ bool rank1_rows(const Group<G>& g,
                                           const float (&row)[S][D],
                                           const float (&w_in)[S],
                                           float gamma, float sq,
                                           float (&out)[S][D]) {
  const int l = g.lane;
  float w[S];
#pragma unroll
  for (int r = 0; r < S; ++r) w[r] = w_in[r];
  float a = gamma;
  bool bad = false;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float diag = sq * g.bcast(row[j / G][j], j % G);
    const float pj = coord(g, w, j);
    const float inv_diag = 1.0f / diag;
    const float Dj = diag * diag;
    const float Dj_new = Dj + a * pj * pj;
    const float inv_Dj_new = 1.0f / Dj_new;
    const float sqrt_Dj_new = sqrtf(Dj_new);
    const float s_w = pj * inv_diag;
    const float s_col = sqrt_Dj_new * inv_diag;
    const float s_new = (pj * a) * inv_Dj_new * sqrt_Dj_new;
    a = a * Dj * inv_Dj_new;
#pragma unroll
    for (int r = 0; r < S; ++r) {
      const int i = l + G * r;
      out[r][j] = 0.0f;
      // slots whose rows all lie above row j or past row D - 1 skip
      if (G * r + G - 1 >= j && G * r < D && i >= j && i < D) {
        const float col = sq * row[r][j];
        w[r] = w[r] - s_w * col;
        const float val = s_col * col + s_new * w[r];
        bad = bad || isnan(val);
        out[r][j] = val;
      }
    }
  }
  return g.any(bad);
}

// torch.logaddexp as ATen computes it on the card for float: the larger
// argument plus log1p(exp(-|a - b|)), and a itself for equal infinities.
__device__ __forceinline__ float logaddexp(float a, float b) {
  if (isinf(a) && a == b) return a;
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

// ---- potential policies ----------------------------------------------------

// eight schools, J = 8 schools, in the rows layout on G lanes: coordinate 0
// is mu, 1 log tau, 2 + k theta_k (or theta_base_k), and the slot of
// coordinate 2 + k also holds school k's y, sigma and log sigma.
constexpr int kEightSchoolsJ = 8;
// Lanes per eight-schools chain in each sweep, fixed by a trial of 1 to 32
// on an H100 (PERF.md §6).  K3 takes 16: two chains
// a warp, 2048 warps for 4096 chains where one thread per chain made 128.
// K2 keeps one thread per chain: each lane of a group repeats the rank-1
// update's column scalars (two divisions and a square root per column),
// which at d = 10 cost more than the group saves, and no group was faster.
constexpr int kEightSchoolsLanesK2 = 1;
constexpr int kEightSchoolsLanesK3 = 16;

template <int S>
struct EightSchoolsRows {
  float y[S], sigma[S], log_sigma[S];  // 0, 1, 0 where no school is
};

template <int G, int S>
__device__ __forceinline__ void load_eight_schools_rows(
    const float* data, int lane, EightSchoolsRows<S>* v) {
#pragma unroll
  for (int r = 0; r < S; ++r) {
    const int k = lane + G * r - 2;
    const bool school = k >= 0 && k < kEightSchoolsJ;
    v->y[r] = school ? data[k] : 0.0f;
    v->sigma[r] = school ? data[kEightSchoolsJ + k] : 1.0f;
    v->log_sigma[r] = logf(v->sigma[r]);
  }
}

// lp = normal_logpdf(mu, 0, 5) + (half_cauchy_logpdf(tau, 5) + log_tau),
// alike on every lane.  PyTorch on the card divides by a Python scalar as a
// multiply by its float reciprocal; the plain version's (x - loc) / 5.0
// does so.
__device__ __forceinline__ float eight_schools_prior(float mu, float tau,
                                                     float log_tau) {
  const float zm = (mu - 0.0f) * (1.0f / 5.0f);
  const float lp = -0.5f * (zm * zm + kLog2Pi) - kLog5;
  const float zc = tau * (1.0f / 5.0f);
  return lp + ((kHalfCauchy5 - log1pf(zc * zc)) + log_tau);
}

// eight schools noncentered, [mu, log tau, theta_base(8)]; data [y, sigma].
// Same operation order as models/targets.py (and models/base.py), the
// J-sums gathered from coordinates 2 .. 9 left to right, as sum_in_order
// runs:
//   lp  = normal_logpdf(mu, 0, 5)
//   lp += half_cauchy_logpdf(tau, 5) + log_tau
//   lp += sum normal_logpdf(theta_base)
//   lp += sum normal_logpdf(y, mu + tau theta_base, sigma)
template <int G>
struct EightSchoolsNoncentered {
  static constexpr int J = kEightSchoolsJ;
  static constexpr int D = J + 2;
  static constexpr int kLanes = G;
  static constexpr bool kRows = true;
  static constexpr int kSlots = row_slots<D + 1, kLanes>();
  using RowData = EightSchoolsRows<kSlots>;
  static bool data_ok(int n) { return n == 2 * J; }
  __device__ static void load_row(const float* data, int, int lane,
                                  RowData* v) {
    load_eight_schools_rows<kLanes>(data, lane, v);
  }
  __device__ static float potential_rows(const Group<kLanes>& g,
                                         const float (&x)[kSlots],
                                         const RowData& v) {
    const float mu = coord(g, x, 0), log_tau = coord(g, x, 1);
    const float tau = expf(log_tau);
    float lp = eight_schools_prior(mu, tau, log_tau);
    float prior[kSlots], like[kSlots];
#pragma unroll
    for (int r = 0; r < kSlots; ++r) {
      prior[r] = -0.5f * (x[r] * x[r] + kLog2Pi) - 0.0f;
      const float theta = mu + tau * x[r];
      const float zy = (v.y[r] - theta) / v.sigma[r];
      like[r] = -0.5f * (zy * zy + kLog2Pi) - v.log_sigma[r];
    }
    lp = lp + ordered_sum<J, 2>(g, prior);
    lp = lp + ordered_sum<J, 2>(g, like);
    return -lp;
  }
};

// eight schools centered, [mu, log tau, theta(8)]; data [y, sigma].  Same
// order as models/targets.py eight_schools_centered, the J-sums as above:
//   lp  = normal_logpdf(mu, 0, 5)
//   lp += half_cauchy_logpdf(tau, 5) + log_tau
//   lp += sum normal_logpdf(theta, mu, tau)
//   lp += sum normal_logpdf(y, theta, sigma)
template <int G>
struct EightSchoolsCentered {
  static constexpr int J = kEightSchoolsJ;
  static constexpr int D = J + 2;
  static constexpr int kLanes = G;
  static constexpr bool kRows = true;
  static constexpr int kSlots = row_slots<D + 1, kLanes>();
  using RowData = EightSchoolsRows<kSlots>;
  static bool data_ok(int n) { return n == 2 * J; }
  __device__ static void load_row(const float* data, int, int lane,
                                  RowData* v) {
    load_eight_schools_rows<kLanes>(data, lane, v);
  }
  __device__ static float potential_rows(const Group<kLanes>& g,
                                         const float (&x)[kSlots],
                                         const RowData& v) {
    const float mu = coord(g, x, 0), log_tau = coord(g, x, 1);
    const float tau = expf(log_tau);
    float lp = eight_schools_prior(mu, tau, log_tau);
    const float log_scale = logf(tau);
    float prior[kSlots], like[kSlots];
#pragma unroll
    for (int r = 0; r < kSlots; ++r) {
      const float z = (x[r] - mu) / tau;
      prior[r] = -0.5f * (z * z + kLog2Pi) - log_scale;
      const float zy = (v.y[r] - x[r]) / v.sigma[r];
      like[r] = -0.5f * (zy * zy + kLog2Pi) - v.log_sigma[r];
    }
    lp = lp + ordered_sum<J, 2>(g, prior);
    lp = lp + ordered_sum<J, 2>(g, like);
    return -lp;
  }
};

// kidiq, [beta(3), log sigma]; data [kid_score(N), mom_hs(N), mom_iq(N)],
// read through the pointer (3 N floats at N = 434).  The N-term sum runs as
// kKidiqLanes running sums, term n into sum n mod kKidiqLanes, then those
// left to right: models/base.py sum_strided with KIDIQ_LANES.  Lane j <
// kKidiqLanes of the chain's group runs sum j, and the sums meet in lane
// order; the d = 4 state is replicated on every lane.  Order of
// models/targets.py kidiq:
//   lp  = half_cauchy_logpdf(sigma, 2.5) + log_sigma
//   mu  = (beta0 + beta1 mom_hs) + beta2 mom_iq
//   lp += sum normal_logpdf(kid_score, mu, sigma)
constexpr int kKidiqLanes = 14;
struct Kidiq {
  static constexpr int D = 4;
  // lanes per chain: two chains per warp (faster than 32 on an H100,
  // PERF.md)
  static constexpr int kLanes = 16;
  static constexpr bool kRows = false;
  static_assert(kLanes >= kKidiqLanes, "one lane per running sum");
  struct Data {
    const float* ks;
    const float* hs;
    const float* iq;
    int n;
  };
  static bool data_ok(int n) { return n > 0 && n % 3 == 0; }
  __device__ static void load(const float* data, int n_data, Data* v) {
    v->n = n_data / 3;
    v->ks = data;
    v->hs = data + v->n;
    v->iq = data + 2 * v->n;
  }
  __device__ static float potential(const float (&x)[D], const Data& v,
                                    const Group<kLanes>& g) {
    const float b0 = x[0], b1 = x[1], b2 = x[2], log_sigma = x[3];
    const float sigma = expf(log_sigma);
    const float zc = sigma * (1.0f / 2.5f);
    const float lp = (kHalfCauchy2p5 - log1pf(zc * zc)) + log_sigma;
    const float log_scale = logf(sigma);
    float acc = 0.0f;
    if (g.lane < kKidiqLanes) {
      for (int n = g.lane; n < v.n; n += kKidiqLanes) {
        const float mu = (b0 + b1 * __ldg(v.hs + n)) + b2 * __ldg(v.iq + n);
        const float z = (__ldg(v.ks + n) - mu) / sigma;
        acc = acc + (-0.5f * (z * z + kLog2Pi) - log_scale);
      }
    }
    return -(lp + ordered_sum<kKidiqLanes>(g, acc));
  }
};

// diamonds in its sufficient-statistic form, [Intercept, b(24), log sigma];
// data [Lᵀ (24 x 24, row-major, upper triangular), b̂(24), SSE_min, N, Ȳ].
// One warp per chain, lane i holding x_i.  Lane m = 1 .. 24 also holds
// coefficient m - 1: row m - 1 of Lᵀ and b̂_{m-1}, in registers, so that it
// computes r_{m-1} = b_{m-1} - b̂_{m-1} and u_{m-1}.  Order of
// models/targets.py diamonds:
//   lp  = student_t_logpdf(a, 3, 8, 10)
//   lp += sum normal_logpdf(b)                     (lanes 1 .. 24 in order)
//   lp += folded_student_t_logpdf(sigma, 3, 0, 10) + log_sigma
//   u_i = sum_{j >= i} Lᵀ_ij r_j   (r_j broadcast from lane j + 1; the
//         plain version also adds the exact zeros of j < i first)
//   SSE = (SSE_min + (N da) da) + sum u_i², da = a - Ȳ  (lanes in order)
//   lp += (-N / 2)(log 2 pi + 2 log_sigma) - (SSE / 2) / sigma²
struct DiamondsSuffStats {
  static constexpr int Kc = 24;
  static constexpr int D = Kc + 2;
  static constexpr int kLanes = 32;
  static constexpr bool kRows = true;
  static constexpr int kSlots = row_slots<D + 1, kLanes>();
  static_assert(kSlots == 1, "a lane per coordinate");
  struct RowData {
    float lt[Kc];  // row lane - 1 of Lᵀ (zeros left of the diagonal)
    float b_hat;
    float sse_min, n, y_bar;
  };
  static bool data_ok(int n) { return n == Kc * Kc + Kc + 3; }
  __device__ static void load_row(const float* data, int, int lane,
                                  RowData* v) {
    const int i = lane - 1;
    const bool coef = i >= 0 && i < Kc;
#pragma unroll
    for (int j = 0; j < Kc; ++j)
      v->lt[j] = coef && j >= i ? data[i * Kc + j] : 0.0f;
    v->b_hat = coef ? data[Kc * Kc + i] : 0.0f;
    v->sse_min = data[Kc * Kc + Kc];
    v->n = data[Kc * Kc + Kc + 1];
    v->y_bar = data[Kc * Kc + Kc + 2];
  }
  // Student-t(3, loc, 10) log density at x as models/base.py writes it
  __device__ static float student_t3_10(float x, float loc) {
    const float z = (x - loc) * (1.0f / 10.0f);
    return kStudentT3Scale10 - 2.0f * log1pf((z * z) * (1.0f / 3.0f));
  }
  __device__ static float potential_rows(const Group<kLanes>& g,
                                         const float (&xs)[kSlots],
                                         const RowData& v) {
    const float x = xs[0];
    const float a = g.bcast(x, 0), log_sigma = g.bcast(x, D - 1);
    const float sigma = expf(log_sigma);
    float lp = student_t3_10(a, 8.0f);
    const float z = (x - 0.0f) * 1.0f;
    const float term = -0.5f * (z * z + kLog2Pi) - 0.0f;
    lp = lp + ordered_sum<Kc, 1>(g, term);
    const float folded =
        logaddexp(student_t3_10(sigma, 0.0f), student_t3_10(-sigma, 0.0f));
    lp = lp + (folded + log_sigma);
    const float r = x - v.b_hat;
    const int i = g.lane - 1;
    float u = 0.0f;
#pragma unroll
    for (int j = 0; j < Kc; ++j) {
      const float rj = g.bcast(r, j + 1);
      if (j == i) u = v.lt[j] * rj;
      if (j > i) u = u + v.lt[j] * rj;
    }
    const float uu = ordered_sum<Kc, 1>(g, u * u);
    const float da = a - v.y_bar;
    const float sse = (v.sse_min + (v.n * da) * da) + uu;
    lp = lp + ((-0.5f * v.n) * (kLog2Pi + 2.0f * log_sigma) -
               (0.5f * sse) / (sigma * sigma));
    return -lp;
  }
};

// packed lower-triangular index (i >= j), row-major
__host__ __device__ constexpr int tri(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// blocks of 32 threads for C chains of P
template <class P>
constexpr int blocks_for(int C) {
  return static_cast<int>(
      (static_cast<long long>(C) * P::kLanes + 31) / 32);
}

}  // namespace amt
