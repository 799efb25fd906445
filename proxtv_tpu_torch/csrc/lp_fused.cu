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
// ~500 operations per element per trip (the projection's 8 Newton steps
// ~250, nine FW steps ~25 each), times the trips the rows need, so it is
// operations-bound.  Each trip also runs ~50 block-wide reductions and
// neighbour exchanges, two barriers each, so a fiber's solve is latency-
// bound: the design keeps several fibers on each SM.
//
// Design: one block per fiber, so every fiber stops on its own (the TPU
// kernel's loop runs per tile of rows with every update masked per row, so
// the results are the same).  Thread t owns a contiguous chunk of E
// elements held in registers; lanes past n are zero, like the TPU kernel's
// lane padding.  Row sums and maxima are warp-butterfly + shared-memory
// reductions whose result every thread computes bitwise identically, so
// every loop branch is uniform across the block; the sums that share a pass
// (G, A, Bq of a Newton step; num, den of a line search) reduce together.
// A single exchange of each chunk's first and last element gives both
// neighbours (x_{j+1} = y_{j+1} + w_{j+1} - w_j is rebuilt from them), so
// the gradient needs one exchange and the line search's D D' d one more.
// The fractional powers follow the TPU kernel's strength reduction: an
// integer or half-integer exponent in (0, 8] is a multiply / sqrtf chain,
// any other goes to powf (accurate: no fast math).
#include <cuda_runtime.h>
#include <stdint.h>

#include "block.cuh"

namespace {

constexpr float kTiny = 1e-30f;
constexpr int kNumPows = 13;
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

__device__ __forceinline__ float spow(float x, const Pows& pw, int slot) {
  const int k = pw.k[slot];
  if (k == 0) return 1.f;
  if (k < 0) return powf(x, pw.e[slot]);
  float acc = 0.f, base = x;
  bool have = false;
  for (int m = k >> 1; m; ) {
    if (m & 1) {
      acc = have ? acc * base : base;
      have = true;
    }
    m >>= 1;
    if (m) base = base * base;
  }
  if (k & 1) {
    const float s = sqrtf(x);
    acc = have ? acc * s : s;
  }
  return acc;
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// Block-wide sums of N values at once: one barrier pair for all N.  Every
// thread gets the same bitwise result (see block.cuh).
template <int N>
__device__ void block_sums(float (&v)[N], float* red) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = warp_reduce<kSum>(v[i]);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[i * 32 + wid] = v[i];
  }
  __syncthreads();
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = warp_reduce<kSum>(lane < nw ? red[i * 32 + lane] : 0.f);
}

__device__ __forceinline__ float block_sum1(float v, float* red) {
  float a[1] = {v};
  block_sums<1>(a, red);
  return a[0];
}

// The last element of the previous thread's chunk and the first element of
// the next thread's chunk (0 past either end), in one barrier pair.
__device__ __forceinline__ void neighbours(float first, float last,
                                           float* xch, float& prev_last,
                                           float& next_first) {
  __syncthreads();
  xch[threadIdx.x] = first;
  xch[blockDim.x + threadIdx.x] = last;
  __syncthreads();
  prev_last = threadIdx.x > 0 ? xch[blockDim.x + threadIdx.x - 1] : 0.f;
  next_first = threadIdx.x + 1 < blockDim.x ? xch[threadIdx.x + 1] : 0.f;
}

template <int E>
struct Fiber {
  int j0, n;
  float* xch;
  float* red;

  __device__ float valid(int k) const { return j0 + k < n - 1 ? 1.f : 0.f; }

  // g = grad(primal(w)) = (x_j - x_{j+1}) v_j with x = y + (w - w_{j-1}).
  __device__ void grad(const float (&y)[E], float ynext0, const float (&w)[E],
                       float (&g)[E]) const {
    float wprev0, wnext0;
    neighbours(w[0], w[E - 1], xch, wprev0, wnext0);
    float x[E];
#pragma unroll
    for (int k = 0; k < E; ++k) x[k] = y[k] + (w[k] - (k > 0 ? w[k - 1] : wprev0));
    const float xnext0 = ynext0 + (wnext0 - w[E - 1]);
#pragma unroll
    for (int k = 0; k < E; ++k)
      g[k] = (x[k] - (k + 1 < E ? x[k + 1] : xnext0)) * valid(k);
  }

  // Holder gap |lam ||g||_p + w'g| and its cancellation magnitude.
  __device__ void gap_of(const float (&w)[E], const float (&g)[E], float lam,
                         const Pows& pw, float& gap, float& den) const {
    float m = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) m = fmaxf(m, fabsf(g[k]));
    const float mx = fmaxf(block_reduce<kMax>(m, red), kTiny);
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < E; ++k) {
      s[0] += spow(fabsf(g[k]) / mx, pw, kP);
      s[1] += w[k] * g[k];
    }
    block_sums<2>(s, red);
    const float tv = lam * mx * spow(s[0], pw, kIP);
    gap = fabsf(tv + s[1]);
    den = tv + fabsf(s[1]);
  }

  // w <- proj_{||.||_q <= lam}(z) (zero on invalid lanes), mu <- its KKT
  // multiplier, warm-started from mu.
  __device__ void project(const float (&z)[E], float lam, float& mu,
                          float (&w)[E], const Pows& pw, bool q_ge2,
                          int newton_iters) const {
    float an[E];
    float m = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      an[k] = fabsf(z[k]) * valid(k);
      m = fmaxf(m, an[k]);
    }
    const float mx = fmaxf(block_reduce<kMax>(m, red), kTiny);
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) sq += spow(an[k] / mx, pw, kQ);
    sq = block_sum1(sq, red);
    const float nrm = mx * spow(sq, pw, kIQ);
    if (nrm <= lam) {  // inside the ball: z itself
#pragma unroll
      for (int k = 0; k < E; ++k) w[k] = z[k] * valid(k);
      return;
    }
    const float scale = mx;
#pragma unroll
    for (int k = 0; k < E; ++k) an[k] = an[k] / scale;
    const float Rn = lam / scale;
    const float T = spow(Rn, pw, kQ);
    const float fac0 = Rn / fmaxf(spow(sq, pw, kIQ), kTiny);
    const float q = pw.e[kQ];
    float s[E];
    if (q_ge2) {
      const float q1 = pw.e[kQ1];
#pragma unroll
      for (int k = 0; k < E; ++k) s[k] = an[k] * fac0;
      for (int it = 0; it < newton_iters; ++it) {
        float F[E], r[E], d[E];
        float sums[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const float sq1 = spow(s[k], pw, kQ1);
          F[k] = s[k] + mu * q * sq1 - an[k];
          d[k] = 1.f + mu * q * q1 * spow(s[k], pw, kQ2);
          r[k] = q * sq1;
          const float rod = r[k] / d[k];
          sums[0] += s[k] * sq1;
          sums[1] += rod * F[k];
          sums[2] += rod * r[k];
        }
        block_sums<3>(sums, red);
        const float G = sums[0] - T;
        const float dmu = (G - sums[1]) / fmaxf(sums[2], kTiny);
        const float mu_new = fmaxf(mu + dmu, 0.f);
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const float ds = -(F[k] + r[k] * dmu) / d[k];
          s[k] = an[k] > 0.f ? fminf(fmaxf(s[k] + ds, 1e-20f), an[k]) : 0.f;
        }
        mu = mu_new;
      }
    } else {
      const float rr = pw.e[kRR], rrq = pw.e[kRRQ];
      float u[E], u_hi[E];
#pragma unroll
      for (int k = 0; k < E; ++k) {
        u_hi[k] = spow(an[k], pw, kQ1);  // loop-invariant clip ceiling
        u[k] = spow(an[k] * fac0, pw, kQ1);
      }
      for (int it = 0; it < newton_iters; ++it) {
        float F[E], d[E], qu[E];
        float sums[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < E; ++k) {
          F[k] = spow(u[k], pw, kRR) + mu * q * u[k] - an[k];
          d[k] = rr * spow(u[k], pw, kRR1) + mu * q;
          const float g = rrq * spow(u[k], pw, kRRQ1);
          qu[k] = q * u[k];
          sums[0] += spow(u[k], pw, kRRQ);
          sums[1] += g * F[k] / d[k];
          sums[2] += g * qu[k] / d[k];
        }
        block_sums<3>(sums, red);
        const float G = sums[0] - T;
        const float dmu = (G - sums[1]) / fmaxf(sums[2], kTiny);
        const float mu_new = fmaxf(mu + dmu, 0.f);
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const float du = -(F[k] + qu[k] * dmu) / d[k];
          u[k] = an[k] > 0.f ? fminf(fmaxf(u[k] + du, kTiny), u_hi[k]) : 0.f;
        }
        mu = mu_new;
      }
#pragma unroll
      for (int k = 0; k < E; ++k) s[k] = spow(u[k], pw, kRR);
    }
    // Radial clamp to exact feasibility: if the Newton missed, the iterate
    // stays feasible and the gap certificate stays truthful.
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) ss += spow(s[k], pw, kQ);
    const float snrm = spow(block_sum1(ss, red), pw, kIQ);
    const float fac = fminf(1.f, Rn / fmaxf(snrm, kTiny));
#pragma unroll
    for (int k = 0; k < E; ++k)
      w[k] = sgn(z[k]) * s[k] * fac * scale * valid(k);
  }

  // One Frank-Wolfe step: closed-form linear oracle over the q-ball
  // (exponent qq = q/(q-1)), exact line search on the dual quadratic.
  __device__ void fw_step(const float (&y)[E], float ynext0, float (&w)[E],
                          float lam, const Pows& pw) const {
    float g[E];
    grad(y, ynext0, w, g);
    float m = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) m = fmaxf(m, fabsf(g[k]));
    const float mx = fmaxf(block_reduce<kMax>(m, red), kTiny);
    float sr = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) sr += spow(fabsf(g[k]) / mx, pw, kQQ);
    const float den_s = fmaxf(spow(block_sum1(sr, red), pw, kQQR), kTiny);
    float d[E];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const float r = fabsf(g[k]) / mx;
      const float s = -lam * sgn(g[k]) * spow(r, pw, kQQ1) / den_s;
      d[k] = (s - w[k]) * valid(k);
    }
    float dprev0, dnext0;
    neighbours(d[0], d[E - 1], xch, dprev0, dnext0);
    float ad[E];
#pragma unroll
    for (int k = 0; k < E; ++k) ad[k] = d[k] - (k > 0 ? d[k - 1] : dprev0);
    const float adnext0 = dnext0 - d[E - 1];
    float nd[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const float Hd = (ad[k] - (k + 1 < E ? ad[k + 1] : adnext0)) * valid(k);
      nd[0] += g[k] * d[k];
      nd[1] += d[k] * Hd;
    }
    block_sums<2>(nd, red);
    const float num = -nd[0], den = nd[1];
    const float gamma =
        den > 0.f ? fminf(fmaxf(num / fmaxf(den, kTiny), 0.f), 1.f)
                  : (num > 0.f ? 1.f : 0.f);
#pragma unroll
    for (int k = 0; k < E; ++k) w[k] = w[k] + gamma * d[k];
  }
};

template <int E, int MAXT>
__global__ void __launch_bounds__(MAXT)
gpfw_kernel(const float* __restrict__ Y, const float* __restrict__ W0,
            const float* __restrict__ LAM, const float* __restrict__ MU0,
            const float* __restrict__ RUN, float* __restrict__ W,
            float* __restrict__ MU, float* __restrict__ GAP,
            float* __restrict__ IT, int n, int max_trips, int fw_cycles,
            float stop_rel, int newton_iters, int q_ge2, Pows pw) {
  __shared__ float xch[2 * MAXT];
  __shared__ float red[3 * 32];
  const size_t row = blockIdx.x;
  const size_t base = row * n;
  Fiber<E> f{static_cast<int>(threadIdx.x) * E, n, xch, red};

  float y[E], w[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = f.j0 + k;
    y[k] = j < n ? Y[base + j] : 0.f;
    w[k] = (j < n ? W0[base + j] : 0.f) * f.valid(k);
  }
  float yprev_unused, ynext0;
  neighbours(y[0], y[E - 1], xch, yprev_unused, ynext0);

  const float lam = LAM[row];
  const float run_mask = RUN[row];
  float mu = fmaxf(MU0[row], kTiny);
  // 10 * float32 eps, rounded as the TPU kernel rounds the host product.
  const float ten_eps = 1.1920928955078125e-06f;

  float g[E];
  f.grad(y, ynext0, w, g);
  float gap, den;
  f.gap_of(w, g, lam, pw, gap, den);
  bool running = run_mask > 0.f && gap > fmaxf(stop_rel, ten_eps * fmaxf(1.f, den));
  int trips = 0;
  while (running && trips < max_trips) {
    // One projected-gradient step; g holds grad(primal(w)) here.
    float z[E];
#pragma unroll
    for (int k = 0; k < E; ++k) z[k] = w[k] - 0.25f * g[k];
    f.project(z, lam, mu, w, pw, q_ge2 != 0, newton_iters);
    for (int c = 1; c < fw_cycles; ++c) f.fw_step(y, ynext0, w, lam, pw);
    f.grad(y, ynext0, w, g);
    f.gap_of(w, g, lam, pw, gap, den);
    ++trips;
    running = gap > fmaxf(stop_rel, ten_eps * fmaxf(1.f, den));
  }

#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = f.j0 + k;
    if (j < n) W[base + j] = w[k] * f.valid(k);
  }
  if (threadIdx.x == 0) {
    MU[row] = mu;
    GAP[row] = gap;
    IT[row] = static_cast<float>(trips * fw_cycles) * run_mask +
              (running ? 0.5f : 0.f);
  }
}

template <int E, int MAXT>
int launch(const float* y, const float* w0, const float* lam, const float* mu0,
           const float* run, float* w, float* mu, float* gap, float* it,
           int B, int n, int max_trips, int fw_cycles, float stop_rel,
           int newton_iters, int q_ge2, const Pows& pw, cudaStream_t stream) {
  const int threads = ((n + E - 1) / E + 31) / 32 * 32;
  gpfw_kernel<E, MAXT><<<B, threads, 0, stream>>>(
      y, w0, lam, mu0, run, w, mu, gap, it, n, max_trips, fw_cycles, stop_rel,
      newton_iters, q_ge2, pw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y, w0, w: (B, n) float32 (w0 with a zero last column); lam, mu0, run, mu,
// gap, it: (B,) float32.  exps / codes: the 13 host exponents and their
// evaluation codes (ops/kernels/lp_fused.py:exponents, _pow_code), host
// memory.  2 <= n <= 8192 (checked by the Python wrapper).
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
  if (n <= 128)
    return launch<1, 128>(y, w0, lam, mu0, run, w, mu, gap, it, B, n,
                          max_trips, fw_cycles, stop_rel, newton_iters, q_ge2,
                          pw, stream);
  if (n <= 512)
    return launch<2, 256>(y, w0, lam, mu0, run, w, mu, gap, it, B, n,
                          max_trips, fw_cycles, stop_rel, newton_iters, q_ge2,
                          pw, stream);
  if (n <= 1024)
    return launch<4, 256>(y, w0, lam, mu0, run, w, mu, gap, it, B, n,
                          max_trips, fw_cycles, stop_rel, newton_iters, q_ge2,
                          pw, stream);
  if (n <= 2048)
    return launch<8, 256>(y, w0, lam, mu0, run, w, mu, gap, it, B, n,
                          max_trips, fw_cycles, stop_rel, newton_iters, q_ge2,
                          pw, stream);
  return launch<16, 512>(y, w0, lam, mu0, run, w, mu, gap, it, B, n,
                         max_trips, fw_cycles, stop_rel, newton_iters, q_ge2,
                         pw, stream);
}
