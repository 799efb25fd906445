// Kernel B5: the whole GPFW TV-Lp dual loop per fiber, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel proxtv_tpu/ops/kernels/lp_fused.py:gpfw_fused
// (pallas_call at :324, body _make_kernel :140-261).  For each row of a
// (B, n) float32 batch of CENTERED signals y it runs the hybrid dual solve
//     min_{||w||_q <= lam} 0.5 w' DD' w - w' dy,      q = p/(p-1)
// (reference GPFW_TVp, src/TVLPopt.cpp:1111): per trip one projected-
// gradient step (step 1/4) with the q-ball projection (newton_iters joint-KKT
// Newton steps, the u = s^(q-1) substitution for q < 2, then a radial
// clamp), fw_cycles - 1 Frank-Wolfe steps (closed-form Lp linear oracle,
// exact line search with Hd = D D' d), then the Holder gap
// |lam ||g||_p + w'g| and its stop test gap > max(stop_rel, 10 eps max(1,
// den)).  Outputs (w, mu, gap, it): it counts single iterations (fw_cycles
// per trip) plus 0.5 for a row still running at the cap.
//
// What bounds it on this card: device traffic is one read of (y, w0) and one
// write of w, 6 MB for a (512, 1000) batch, ~2 us at 3.35 TB/s; the work is
// a few hundred operations per element per trip (the projection's Newton
// steps and nine FW steps), times the trips the rows need, so it is
// operations-bound.  A trip is a chain of ~29 row-wide reductions, so a
// fiber's solve is latency-bound: the design cuts the crossings and keeps
// the state in registers.
//
// Design.  A fiber runs on W warps (fiber.cuh; W = 1, several fibers a
// block, for n <= 256), lane r holding the contiguous chunk j = rE .. rE +
// E - 1 of y, w and the gradient g in registers, plus the halo w_{j-1},
// w_{j+E}, y_{j+E}; lanes past n are zero, like the TPU kernel's lane
// padding.  For 256 < n <= 2048 a batch that fits the card in one wave of
// E = 4 on 4-16 warps, no register cap (4, 2, 1 fibers an SM), runs so; a
// larger batch keeps more fibers an SM (E = 8, at most 128 registers a
// thread, which spills a little).  Every crossing between warps is one
// barrier on double-buffered
// shared slots and carries everything that is known before it:
// - a row sum, or several (a Newton step's three, a line search's two);
// - a (max, power sum) pair: each warp takes its max by shuffles first and
//   sums (|v| / m_w)^e against it; across warps (M, sum_w s_w (m_w / M)^e),
//   so a norm costs one crossing, not two;
// - chunk edges each way (shuffles inside a warp, the warp edges through
//   the slot).
// A trip crosses 1 + newton_iters + 1 times in the projection (its pair with
// the z edges, the Newton sums, the radial clamp's sum with the new w's
// edges), twice per FW step (the oracle's pair with the g edges; num, den
// with the d edges) and once for the gap: 29 at the defaults, one barrier
// each (the parent kernel: ~60 crossings of two barriers).  No crossing
// exchanges w: the halo w_{j-1}, w_{j+E} is made by the same operations as
// its owner makes that element (the projection's products from the
// exchanged signed s, each FW step's fmaf from the exchanged d), so every
// gradient, the one the gap certifies included, is recomputed from w in
// registers, exactly as the plain version recomputes it (carrying it as
// g + gamma Hd would save four operations an element but accumulate
// rounding over the FW steps).  Every thread of a fiber holds the same bits
// of every row scalar, so every branch is uniform.
//
// Divides are reciprocals (rcp, within 1 ulp): one per element per Newton
// step, shared by its uses, and one per row scalar.  Powers follow the TPU
// kernel's strength reduction: an integer or half-integer exponent in
// (0, 8] is a multiply / square-root chain (sqrt.approx), any other goes to
// powf (accurate); the chain's branches, uniform over the row, are taken
// once per chunk.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fiber.cuh"

namespace {

constexpr float kTiny = 1e-30f;
constexpr int kNumPows = 13;
constexpr int kSlot = 8 * 32;        // floats per shared slot
constexpr int kFibersPerBlock = 4;   // W = 1: one warp per fiber
// Exponent slots (ops/kernels/lp_fused.py:exponents).
enum {
  kQ = 0, kIQ, kQ1, kQ2, kRR, kRRQ, kRR1, kRRQ1, kP, kIP, kQQ1, kQQ, kQQR
};

// e[i] is the exponent rounded to float32; k[i] says how to raise to it:
// 0 -> 1, -1 -> powf, k > 0 -> the square-and-multiply chain for e = k / 2.
struct Pows {
  float e[kNumPows];
  int k[kNumPows];
};

// The hardware's approximate square root (sqrt.approx): the correctly
// rounded sqrtf cost 27% of the kernel at (512, 1000), p = 1.5.
__device__ __forceinline__ float asqrt(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// out = x^e elementwise (out must not alias x) for x >= 0: 1 (k = 0), powf
// (k < 0) or the square-and-multiply chain for e = k / 2, its branches
// taken once for the N elements.
template <int N>
__device__ __forceinline__ void spow_n(const float (&x)[N], float (&out)[N],
                                       const Pows& pw, int slot) {
  const int k = pw.k[slot];
  if (k == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = 1.f;
    return;
  }
  if (k < 0) {
    const float e = pw.e[slot];
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = powf(x[i], e);
    return;
  }
  float base[N];
#pragma unroll
  for (int i = 0; i < N; ++i) base[i] = x[i];
  bool have = false;
  for (int m = k >> 1; m; ) {
    if (m & 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] = have ? out[i] * base[i] : base[i];
      have = true;
    }
    m >>= 1;
    if (m) {
#pragma unroll
      for (int i = 0; i < N; ++i) base[i] = base[i] * base[i];
    }
  }
  if (k & 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float s = asqrt(x[i]);
      out[i] = have ? out[i] * s : s;
    }
  }
}

__device__ __forceinline__ float spow(float x, const Pows& pw, int slot) {
  const float a[1] = {x};
  float r[1];
  spow_n(a, r, pw, slot);
  return r[0];
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// Reduction over the W lanes of each group lane & ~(W - 1): with every
// group holding the same W values, every lane gets the same bits.
template <int OP, int W>
__device__ __forceinline__ float group_reduce(float v) {
#pragma unroll
  for (int o = 1; o < W; o <<= 1) v = op2<OP>(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Array arguments of a crossing that may carry no values.
template <int N>
using Arr = float[N > 0 ? N : 1];

template <int E, int W>
struct Row {
  Fiber<W, kSlot> f;
  int j0, n;
  const Pows& pw;

  __device__ float valid(int k) const { return j0 + k < n - 1 ? 1.f : 0.f; }

  // One crossing of the fiber: NS row sums, NX chunk edges each way (the
  // previous chunk's last, the next chunk's first; 0 past the row's ends)
  // and, with PAIR, the (max, power sum) pair: on entry pm is the warp's
  // max and ps its sum of (|v| / pm)^e, on return the row's max M and
  // sum (|v| / M)^e, e the exponent of `slot`.
  template <bool PAIR, int NS, int NX>
  __device__ __forceinline__ void cross(float& pm, float& ps, int slot,
                                        Arr<NS>& sums, const Arr<NX>& first,
                                        const Arr<NX>& last, Arr<NX>& prev,
                                        Arr<NX>& next) {
    const int lane = f.lane;
#pragma unroll
    for (int i = 0; i < NS; ++i) sums[i] = warp_reduce<kSum>(sums[i]);
    if (PAIR) ps = warp_reduce<kSum>(ps);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      prev[i] = from_below(last[i], 1, lane);
      next[i] = from_above(first[i], 1, lane);
    }
    if constexpr (W > 1) {
      float* s = f.slot();
      const int wid = f.wid;
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < NS; ++i) s[i * 32 + wid] = sums[i];
        if (PAIR) {
          s[NS * 32 + wid] = pm;
          s[(NS + 1) * 32 + wid] = ps;
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) s[(NS + 2 + i) * 32 + wid] = first[i];
      }
      if (lane == 31) {
#pragma unroll
        for (int i = 0; i < NX; ++i) s[(NS + 2 + NX + i) * 32 + wid] = last[i];
      }
      __syncthreads();
      const int q = lane & (W - 1);
#pragma unroll
      for (int i = 0; i < NS; ++i)
        sums[i] = group_reduce<kSum, W>(s[i * 32 + q]);
      if (PAIR) {
        const float mw = s[NS * 32 + q];
        const float M = group_reduce<kMax, W>(mw);
        const float t = s[(NS + 1) * 32 + q] *
                        spow(mw * rcp(fmaxf(M, kTiny)), pw, slot);
        pm = M;
        ps = group_reduce<kSum, W>(t);
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        if (lane == 0 && wid > 0) prev[i] = s[(NS + 2 + NX + i) * 32 + wid - 1];
        if (lane == 31 && wid + 1 < W) next[i] = s[(NS + 2 + i) * 32 + wid + 1];
      }
    }
  }

  // The warp's half of a (max, power sum) pair of a >= 0 (see cross).
  __device__ __forceinline__ void warp_pair(const float (&a)[E], int slot,
                                            float& pm, float& ps) const {
    float m = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) m = fmaxf(m, a[k]);
    m = warp_reduce<kMax>(m);
    const float im = rcp(fmaxf(m, kTiny));
    float t[E], tp[E];
#pragma unroll
    for (int k = 0; k < E; ++k) t[k] = a[k] * im;
    spow_n(t, tp, pw, slot);
    ps = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) ps += tp[k];
    pm = m;
  }

  // g = grad(primal(w)) = (x_j - x_{j+1}) v_j with x = y + (w - w_{j-1}).
  __device__ __forceinline__ void grad(const float (&y)[E], float yn,
                                       const float (&w)[E], float wp,
                                       float wn, float (&g)[E]) const {
    float x[E];
#pragma unroll
    for (int k = 0; k < E; ++k) x[k] = y[k] + (w[k] - (k > 0 ? w[k - 1] : wp));
    const float xn = yn + (wn - w[E - 1]);
#pragma unroll
    for (int k = 0; k < E; ++k)
      g[k] = (x[k] - (k + 1 < E ? x[k + 1] : xn)) * valid(k);
  }

  // Holder gap |lam ||g||_p + w'g| and its cancellation magnitude.
  __device__ __forceinline__ void gap_of(const float (&w)[E],
                                         const float (&g)[E], float lam,
                                         float& gap, float& den) {
    float a[E];
    float sums[1] = {0.f};
#pragma unroll
    for (int k = 0; k < E; ++k) {
      a[k] = fabsf(g[k]);
      sums[0] += w[k] * g[k];
    }
    float pm, ps, none[1];
    warp_pair(a, kP, pm, ps);
    cross<true, 1, 0>(pm, ps, kP, sums, none, none, none, none);
    const float tv = lam * fmaxf(pm, kTiny) * spow(ps, pw, kIP);
    gap = fabsf(tv + sums[0]);
    den = tv + fabsf(sums[0]);
  }

  // w <- proj_{||.||_q <= lam}(z) (zero on invalid lanes) and its halo,
  // mu <- its KKT multiplier, warm-started from mu.
  __device__ __forceinline__ void project(const float (&z)[E], float lam,
                                          float& mu, float (&w)[E],
                                          float& wp, float& wn, bool q_ge2,
                                          int newton_iters) {
    float an[E];
#pragma unroll
    for (int k = 0; k < E; ++k) an[k] = fabsf(z[k]) * valid(k);
    float pm, ps, none[1];
    float zf[1] = {z[0]}, zl[1] = {z[E - 1]}, zp[1], zn[1];
    warp_pair(an, kQ, pm, ps);
    cross<true, 0, 1>(pm, ps, kQ, none, zf, zl, zp, zn);
    const float scale = fmaxf(pm, kTiny);
    const float nrm_s = spow(ps, pw, kIQ);  // ||z||_q / scale
    if (scale * nrm_s <= lam) {  // inside the ball: z itself
#pragma unroll
      for (int k = 0; k < E; ++k) w[k] = z[k] * valid(k);
      wp = zp[0] * valid(-1);
      wn = zn[0] * valid(E);
      return;
    }
    const float isc = rcp(scale);
#pragma unroll
    for (int k = 0; k < E; ++k) an[k] = an[k] * isc;
    const float Rn = lam * isc;
    const float T = spow(Rn, pw, kQ);
    const float fac0 = Rn * rcp(fmaxf(nrm_s, kTiny));
    const float q = pw.e[kQ];
    float s[E];
    if (q_ge2) {
#pragma unroll
      for (int k = 0; k < E; ++k) s[k] = an[k] * fac0;
      const float qq1 = q * pw.e[kQ1];
      for (int it = 0; it < newton_iters; ++it) {
        float sq1[E], sq2[E], F[E], r[E], id[E];
        spow_n(s, sq1, pw, kQ1);
        spow_n(s, sq2, pw, kQ2);
        float sums[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < E; ++k) {
          F[k] = s[k] + mu * q * sq1[k] - an[k];
          id[k] = rcp(1.f + mu * qq1 * sq2[k]);
          r[k] = q * sq1[k];
          const float rod = r[k] * id[k];
          sums[0] += s[k] * sq1[k];
          sums[1] += rod * F[k];
          sums[2] += rod * r[k];
        }
        cross<false, 3, 0>(pm, ps, 0, sums, none, none, none, none);
        const float G = sums[0] - T;
        const float dmu = (G - sums[1]) * rcp(fmaxf(sums[2], kTiny));
        const float mu_new = fmaxf(mu + dmu, 0.f);
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const float ds = -(F[k] + r[k] * dmu) * id[k];
          s[k] = an[k] > 0.f ? fminf(fmaxf(s[k] + ds, 1e-20f), an[k]) : 0.f;
        }
        mu = mu_new;
      }
    } else {
      const float rr = pw.e[kRR], rrq = pw.e[kRRQ];
      float u[E], u_hi[E], t[E];
      spow_n(an, u_hi, pw, kQ1);  // loop-invariant clip ceiling
#pragma unroll
      for (int k = 0; k < E; ++k) t[k] = an[k] * fac0;
      spow_n(t, u, pw, kQ1);
      for (int it = 0; it < newton_iters; ++it) {
        float ur[E], ur1[E], urq[E], urq1[E], F[E], id[E], gq[E];
        spow_n(u, ur, pw, kRR);
        spow_n(u, ur1, pw, kRR1);
        spow_n(u, urq, pw, kRRQ);
        spow_n(u, urq1, pw, kRRQ1);
        float sums[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < E; ++k) {
          F[k] = ur[k] + mu * q * u[k] - an[k];
          id[k] = rcp(rr * ur1[k] + mu * q);
          gq[k] = rrq * urq1[k] * id[k];
          sums[0] += urq[k];
          sums[1] += gq[k] * F[k];
          sums[2] += gq[k] * (q * u[k]);
        }
        cross<false, 3, 0>(pm, ps, 0, sums, none, none, none, none);
        const float G = sums[0] - T;
        const float dmu = (G - sums[1]) * rcp(fmaxf(sums[2], kTiny));
        const float mu_new = fmaxf(mu + dmu, 0.f);
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const float du = -(F[k] + q * u[k] * dmu) * id[k];
          u[k] = an[k] > 0.f ? fminf(fmaxf(u[k] + du, kTiny), u_hi[k]) : 0.f;
        }
        mu = mu_new;
      }
      spow_n(u, s, pw, kRR);
    }
    // Radial clamp to exact feasibility: if the Newton missed, the iterate
    // stays feasible and the gap certificate stays truthful.  The signed
    // s of the chunk edges travel with its sum, so the halo of the new w
    // is made by the same products as its owner makes it.
    float sqq[E], ts[E];
    spow_n(s, sqq, pw, kQ);
    float sums[1] = {0.f};
#pragma unroll
    for (int k = 0; k < E; ++k) {
      sums[0] += sqq[k];
      ts[k] = sgn(z[k]) * s[k];
    }
    float tf[1] = {ts[0]}, tl[1] = {ts[E - 1]}, tp[1], tn[1];
    cross<false, 1, 1>(pm, ps, 0, sums, tf, tl, tp, tn);
    const float snrm = spow(sums[0], pw, kIQ);
    const float fac = fminf(1.f, Rn * rcp(fmaxf(snrm, kTiny)));
#pragma unroll
    for (int k = 0; k < E; ++k) w[k] = ts[k] * fac * scale * valid(k);
    wp = tp[0] * fac * scale * valid(-1);
    wn = tn[0] * fac * scale * valid(E);
  }

  // One Frank-Wolfe step: g = grad(primal(w)) from w and its halo (no
  // exchange), closed-form linear oracle over the q-ball (exponent
  // qq = q/(q-1) = p), exact line search on the dual quadratic.
  __device__ __forceinline__ void fw_step(const float (&y)[E], float yn,
                                          float (&w)[E], float& wp,
                                          float& wn, float (&g)[E],
                                          float lam) {
    grad(y, yn, w, wp, wn, g);
    float a[E];
#pragma unroll
    for (int k = 0; k < E; ++k) a[k] = fabsf(g[k]);
    float pm, ps, none[1];
    float gf[1] = {g[0]}, gl[1] = {g[E - 1]}, gp[1], gn[1];
    warp_pair(a, kQQ, pm, ps);
    cross<true, 0, 1>(pm, ps, kQQ, none, gf, gl, gp, gn);
    const float imx = rcp(fmaxf(pm, kTiny));
    const float c = -lam * rcp(fmaxf(spow(ps, pw, kQQR), kTiny));
    // The direction on the chunk and its halo: element i of the arrays is
    // j0 - 1 + i.
    float ge[E + 2], we[E + 2], r[E + 2], rp[E + 2], d[E + 2];
    ge[0] = gp[0];
    we[0] = wp;
    ge[E + 1] = gn[0];
    we[E + 1] = wn;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      ge[k + 1] = g[k];
      we[k + 1] = w[k];
    }
#pragma unroll
    for (int i = 0; i < E + 2; ++i) r[i] = fabsf(ge[i]) * imx;
    spow_n(r, rp, pw, kQQ1);
#pragma unroll
    for (int i = 0; i < E + 2; ++i)
      d[i] = (c * sgn(ge[i]) * rp[i] - we[i]) * valid(i - 1);
    float Hd[E];
    float sums[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const float ad = d[k + 1] - d[k], adn = d[k + 2] - d[k + 1];
      Hd[k] = (ad - adn) * valid(k);
      sums[0] += g[k] * d[k + 1];
      sums[1] += d[k + 1] * Hd[k];
    }
    float df[1] = {d[1]}, dl[1] = {d[E]}, dp[1], dn[1];
    cross<false, 2, 1>(pm, ps, 0, sums, df, dl, dp, dn);
    const float num = -sums[0], den = sums[1];
    const float gamma =
        den > 0.f ? fminf(fmaxf(num * rcp(fmaxf(den, kTiny)), 0.f), 1.f)
                  : (num > 0.f ? 1.f : 0.f);
#pragma unroll
    for (int k = 0; k < E; ++k) w[k] = __fmaf_rn(gamma, d[k + 1], w[k]);
    wp = __fmaf_rn(gamma, dp[0], wp);
    wn = __fmaf_rn(gamma, dn[0], wn);
  }
};

template <int W>
constexpr int threads_of() { return W == 1 ? 32 * kFibersPerBlock : 32 * W; }

// MINB: the blocks an SM should hold, which caps the registers a thread.
template <int E, int W, int MINB>
__global__ void __launch_bounds__(threads_of<W>(), MINB)
gpfw_kernel(const float* __restrict__ Y, const float* __restrict__ W0,
            const float* __restrict__ LAM, const float* __restrict__ MU0,
            const float* __restrict__ RUN, float* __restrict__ Wout,
            float* __restrict__ MU, float* __restrict__ GAP,
            float* __restrict__ IT, int nrows, int n, int max_trips,
            int fw_cycles, float stop_rel, int newton_iters, int q_ge2,
            Pows pw) {
  __shared__ float slots[W > 1 ? 2 * kSlot : 1];
  Row<E, W> r{Fiber<W, kSlot>{}, 0, n, pw};
  r.f.lane = threadIdx.x & 31;
  r.f.slots = slots;
  size_t row;
  if constexpr (W == 1) {
    r.f.wid = 0;
    row = static_cast<size_t>(blockIdx.x) * kFibersPerBlock + (threadIdx.x >> 5);
    if (row >= static_cast<size_t>(nrows)) return;  // whole warps leave
  } else {
    r.f.wid = threadIdx.x >> 5;
    row = blockIdx.x;
  }
  r.j0 = r.f.rank() * E;
  const int j0 = r.j0;
  const size_t base = row * n;

  float y[E], w[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = j0 + k;
    y[k] = j < n ? Y[base + j] : 0.f;
    w[k] = (j < n ? W0[base + j] : 0.f) * r.valid(k);
  }
  // The halo: y_{j0+E}, w_{j0-1}, w_{j0+E}.
  float yn, wp, wn;
  {
    float pm = 0.f, ps = 0.f, none[1];
    float fst[2] = {y[0], w[0]}, lst[2] = {y[E - 1], w[E - 1]}, prv[2],
          nxt[2];
    r.template cross<false, 0, 2>(pm, ps, 0, none, fst, lst, prv, nxt);
    yn = nxt[0];
    wp = prv[1];
    wn = nxt[1];
  }

  const float lam = LAM[row];
  const float run_mask = RUN[row];
  float mu = fmaxf(MU0[row], kTiny);
  // 10 * float32 eps, rounded as the TPU kernel rounds the host product.
  const float ten_eps = 1.1920928955078125e-06f;

  float g[E];
  r.grad(y, yn, w, wp, wn, g);
  float gap, den;
  r.gap_of(w, g, lam, gap, den);
  bool running = run_mask > 0.f && gap > fmaxf(stop_rel, ten_eps * fmaxf(1.f, den));
  int trips = 0;
  while (running && trips < max_trips) {
    // One projected-gradient step; g holds grad(primal(w)) here.
    float z[E];
#pragma unroll
    for (int k = 0; k < E; ++k) z[k] = w[k] - 0.25f * g[k];
    r.project(z, lam, mu, w, wp, wn, q_ge2 != 0, newton_iters);
    for (int c = 1; c < fw_cycles; ++c) r.fw_step(y, yn, w, wp, wn, g, lam);
    r.grad(y, yn, w, wp, wn, g);
    r.gap_of(w, g, lam, gap, den);
    ++trips;
    running = gap > fmaxf(stop_rel, ten_eps * fmaxf(1.f, den));
  }

#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = j0 + k;
    if (j < n) Wout[base + j] = w[k] * r.valid(k);
  }
  if (r.f.rank() == 0) {
    MU[row] = mu;
    GAP[row] = gap;
    IT[row] = static_cast<float>(trips * fw_cycles) * run_mask +
              (running ? 0.5f : 0.f);
  }
}

template <int E, int W, int MINB>
int launch(const float* y, const float* w0, const float* lam, const float* mu0,
           const float* run, float* w, float* mu, float* gap, float* it,
           int B, int n, int max_trips, int fw_cycles, float stop_rel,
           int newton_iters, int q_ge2, const Pows& pw, cudaStream_t stream) {
  const int blocks = W == 1 ? (B + kFibersPerBlock - 1) / kFibersPerBlock : B;
  gpfw_kernel<E, W, MINB><<<blocks, threads_of<W>(), 0, stream>>>(
      y, w0, lam, mu0, run, w, mu, gap, it, B, n, max_trips, fw_cycles,
      stop_rel, newton_iters, q_ge2, pw);
  return static_cast<int>(cudaGetLastError());
}

// Fibers of the layout <E, W, MINB> (W > 1: one a block) that the device
// holds at once: one wave.
template <int E, int W, int MINB>
int one_wave(int device) {
  int blocks = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, gpfw_kernel<E, W, MINB>, threads_of<W>(), 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return blocks * sms;
}

}  // namespace

// y, w0, w: (B, n) float32 (w0 with a zero last column); lam, mu0, run, mu,
// gap, it: (B,) float32.  exps / codes: the 13 host exponents and their
// evaluation codes (ops/kernels/lp_fused.py:exponents, _pow_code), host
// memory.  2 <= n <= 8192 (checked by the Python wrapper).  A fiber covers
// 32 W E elements.
extern "C" int gpfw_fused(const float* y, const float* w0, const float* lam,
                          const float* mu0, const float* run, float* w,
                          float* mu, float* gap, float* it, int B, int n,
                          int max_trips, int fw_cycles, float stop_rel,
                          int newton_iters, int q_ge2, const float* exps,
                          const int* codes, cudaStream_t stream) {
  Pows pw;
  for (int i = 0; i < kNumPows; ++i) {
    pw.e[i] = exps[i];
    pw.k[i] = codes[i];
  }
  // 256 < n <= 2048 runs on more warps of E = 4 with no register cap
  // while the batch fits the card at once (one wave: at most 4, 2 and 1
  // fibers an SM for n <= 512, 1024 and 2048 at 122-127 registers); a
  // larger batch keeps more fibers an SM (E = 8, at most 128 registers a
  // thread).  The SMs are those of the card that holds y.
  cudaPointerAttributes at{};
  const cudaError_t err = cudaPointerGetAttributes(&at, y);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not sticky: clear it for the next call
    return static_cast<int>(err);
  }
  const int dev = at.device;
#define LP_LAUNCH(E, W, MINB)                                               \
  return launch<E, W, MINB>(y, w0, lam, mu0, run, w, mu, gap, it, B, n,     \
                            max_trips, fw_cycles, stop_rel, newton_iters,   \
                            q_ge2, pw, stream)
  if (n <= 128) LP_LAUNCH(4, 1, 8);
  if (n <= 256) LP_LAUNCH(8, 1, 4);
  if (n <= 512) {
    if (B <= one_wave<4, 4, 1>(dev)) LP_LAUNCH(4, 4, 1);
    LP_LAUNCH(8, 2, 8);
  }
  if (n <= 1024) {
    if (B <= one_wave<4, 8, 1>(dev)) LP_LAUNCH(4, 8, 1);
    LP_LAUNCH(8, 4, 4);
  }
  if (n <= 2048) {
    if (B <= one_wave<4, 16, 1>(dev)) LP_LAUNCH(4, 16, 1);
    LP_LAUNCH(8, 8, 2);
  }
  if (n <= 4096) LP_LAUNCH(8, 16, 1);
  if (n <= 8192) LP_LAUNCH(16, 16, 1);
#undef LP_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
