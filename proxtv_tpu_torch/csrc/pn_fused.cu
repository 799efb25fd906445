// Kernel B1: the whole weighted TV-L1 projected-Newton prox per fiber,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel proxtv_tpu/ops/kernels/pn_fused.py:pn_tv1_fused
// (its pallas_calls at :385 / :390, body _make_kernel :137-319).  For each
// row y of a (B, n) float32 batch it solves
//     min_x 0.5 ||x - y||^2 + sum_i lam_i |x_{i+1} - x_i|
// on the dual: centering, the closed-form double-prefix-sum dual init (or a
// warm start), the inactive-set Newton loop with normalized masked PCR (a
// head of `head_steps` steps, the full-depth tail only in exact mode), the
// halving projected line search (delta = 1, then 3 + (max_armijo - 4)
// halvings) with the cancellation-free improvement, the relative duality-gap
// stop with stall promotion to exact mode, and the degenerate guards.
//
// What bounds it on this card: device traffic is one read of y (+ lam, w0)
// and one write of x (+ w) — 8 MB for a (1024, 1024) sweep — so the bytes
// bound is a few microseconds; the work is ~100 flops per element per
// Newton iteration times the iterations the data needs, and each iteration
// is a chain of ~26 block-wide barriers (reductions, neighbour exchanges,
// PCR steps), so a fiber's solve is latency-bound: the design keeps many
// fibers in flight instead of making one fast.
//
// Design: one block per fiber, so every fiber stops on its own and the TPU
// kernel's tile-wide decisions (PCR tail, line-search fallback, deep search:
// max/min over a tile of rows) become per-fiber decisions.  Thread t owns a
// contiguous chunk of E elements held in registers (the solver state y, lam,
// w, g, x, mask, direction, line-search candidates); lanes past n are zero
// and decoupled, exactly like the TPU kernel's lane padding.  Neighbour
// access at distance 1 goes through a one-float-per-thread exchange buffer;
// row sums are warp-shuffle + shared-memory reductions whose result every
// thread computes identically (so block-uniform branches never diverge);
// the PCR reduction and the prefix sums keep their arrays in shared memory
// (3 x T*E floats, 96 KB at n = 8192).
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "block.cuh"

namespace {

constexpr float kEps = 1e-10f;

// Inclusive prefix sum over the row in the TPU kernel's log-shift order
// (x += shift_right(x, sh) for sh = 1, 2, 4, ... < n).
template <int E>
__device__ void prefix_scan(float (&p)[E], float* buf, int n) {
  const int j0 = threadIdx.x * E;
  for (int sh = 1; sh < n; sh <<= 1) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < E; ++k) buf[j0 + k] = p[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int src = j0 + k - sh;
      p[k] = p[k] + (src >= 0 ? buf[src] : 0.f);
    }
  }
}

// Normalized masked PCR (pn_fused.py:40-101): solves the m-masked
// second-difference system with right-hand side g*m; identity on masked-out
// rows.  `head_steps` steps always, the remaining ones when `tail`.
template <int E>
__device__ void pcr_masked(const float (&m)[E], const float (&g)[E],
                           float (&d)[E], int n, int head_steps, bool tail,
                           float* sb, float* sc, float* sd, float* xch) {
  const int j0 = threadIdx.x * E;
  const int nw = blockDim.x * E;
  float b[E], c[E];
  const float mprev0 = from_prev(m[E - 1], xch);
#pragma unroll
  for (int k = 0; k < E; ++k) b[k] = -(m[k] * (k > 0 ? m[k - 1] : mprev0));
  const float bnext0 = from_next(b[0], xch);
#pragma unroll
  for (int k = 0; k < E; ++k) {
    c[k] = k + 1 < E ? b[k + 1] : bnext0;
    const float r = 1.f / (1.f + m[k]);
    b[k] = b[k] * r;
    c[k] = c[k] * r;
    d[k] = (m[k] * (g[k] * m[k])) * r;
  }
  int step = 0;
  for (int s = 1; s < n; s <<= 1, ++step) {
    if (step >= head_steps && !tail) break;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < E; ++k) {
      sb[j0 + k] = b[k];
      sc[j0 + k] = c[k];
      sd[j0 + k] = d[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int j = j0 + k;
      const bool lo = j - s >= 0, hi = j + s < nw;
      const float bm = lo ? sb[j - s] : 0.f, bp = hi ? sb[j + s] : 0.f;
      const float cm = lo ? sc[j - s] : 0.f, cp = hi ? sc[j + s] : 0.f;
      const float dm = lo ? sd[j - s] : 0.f, dp = hi ? sd[j + s] : 0.f;
      const float r = 1.f / (1.f - b[k] * cm - c[k] * bp);
      const float d2 = (d[k] - b[k] * dm - c[k] * dp) * r;
      b[k] = (-b[k] * bm) * r;
      c[k] = (-c[k] * cp) * r;
      d[k] = d2;
    }
  }
}

// One line-search trial at step `delta`: candidate dual aux, primal xn, and
// the cancellation-free objective improvement -(x.dx + 0.5 dx.dx).
template <int E>
__device__ float trial(float delta, const float (&w)[E], const float (&d)[E],
                       const float (&m)[E], const float (&lam)[E],
                       const float (&x)[E], float (&aux)[E], float (&xn)[E],
                       float* xch, float* red) {
  float dw[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    aux[k] = m[k] > 0.f ? fminf(fmaxf(w[k] - delta * d[k], -lam[k]), lam[k])
                        : w[k];
    dw[k] = aux[k] - w[k];
  }
  const float dwprev0 = from_prev(dw[E - 1], xch);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const float dx = dw[k] - (k > 0 ? dw[k - 1] : dwprev0);
    xn[k] = x[k] + dx;
    s += x[k] * dx + 0.5f * dx * dx;
  }
  return -block_reduce<kSum>(s, red);
}

template <int E, int MAXT>
__global__ void __launch_bounds__(MAXT)
pn_kernel(const float* __restrict__ Y, const float* __restrict__ LAM,
          float lam_scalar, const float* __restrict__ W0,
          float* __restrict__ X, float* __restrict__ WO,
          int* __restrict__ ITERS, int n, int max_iters, int max_armijo,
          float sigma, float stop_rel, int head_steps) {
  extern __shared__ float sm[];
  const int T = blockDim.x, nw = T * E;
  float* sb = sm;
  float* sc = sb + nw;
  float* sd = sc + nw;
  float* xch = sd + nw;
  float* red = xch + T;
  const int j0 = threadIdx.x * E;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;

  float y[E], lam[E], v[E], w[E], g[E], x[E];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = j0 + k;
    y[k] = j < n ? Y[base + j] : 0.f;
    v[k] = j < n - 1 ? 1.f : 0.f;
    s += y[k];
  }
  // Center (translation equivariance); lanes past n stay zero.
  const float ybar = block_reduce<kSum>(s, red) / static_cast<float>(n);
  float yy = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = j0 + k;
    y[k] = (y[k] - ybar) * (j < n ? 1.f : 0.f);
    yy += y[k] * y[k];
    const float l = LAM != nullptr ? (j < n ? LAM[base + j] : 0.f) : lam_scalar;
    lam[k] = l * v[k];
  }
  const float ynext0 = from_next(y[0], xch);
  float dy[E];
  float dymax = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    dy[k] = ((k + 1 < E ? y[k + 1] : ynext0) - y[k]) * v[k];
    dymax = fmaxf(dymax, fabsf(dy[k]));
  }
  dymax = block_reduce<kMax>(dymax, red);

  if (W0 != nullptr) {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int j = j0 + k;
      const float w0 = (j < n ? W0[base + j] : 0.f) * v[k];
      w[k] = fminf(fmaxf(w0, -lam[k]), lam[k]);
    }
  } else {
    // Closed-form unconstrained dual: w_j = S_m (j+1)/n - S_{j-1},
    // S = prefix(prefix(dy)) (pn_fused.py:119-134).
    float p[E];
#pragma unroll
    for (int k = 0; k < E; ++k) p[k] = dy[k];
    prefix_scan<E>(p, sd, n);
    float tsum = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      p[k] *= v[k];
      tsum += p[k];
    }
    const float sm_tot = block_reduce<kSum>(tsum, red);
    prefix_scan<E>(p, sd, n);
    const float sprev0 = from_prev(p[E - 1], xch);
    const float inv_n = static_cast<float>(1.0 / static_cast<double>(n));
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const float sp = k > 0 ? p[k - 1] : sprev0;
      const float idx = static_cast<float>(j0 + k + 1);
      const float w0 = (sm_tot * idx * inv_n - sp) * v[k];
      w[k] = fminf(fmaxf(w0, -lam[k]), lam[k]);
    }
  }

  // x = y + D'w, g = Dx (masked)
  {
    const float wprev0 = from_prev(w[E - 1], xch);
#pragma unroll
    for (int k = 0; k < E; ++k)
      x[k] = y[k] + (w[k] - (k > 0 ? w[k - 1] : wprev0));
    const float xnext0 = from_next(x[0], xch);
#pragma unroll
    for (int k = 0; k < E; ++k)
      g[k] = (x[k] - (k + 1 < E ? x[k + 1] : xnext0)) * v[k];
  }
  float fs = 0.f, gs = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    fs += x[k] * x[k];
    gs += fabsf(g[k]) * lam[k] + w[k] * g[k];
  }
  float fval = block_reduce<kSum>(fs, red) * 0.5f;
  const float scale = fmaxf(1.f, block_reduce<kSum>(yy, red) * 0.5f);
  const float tol = fmaxf(stop_rel, (10.f * FLT_EPSILON) * scale);
  const float eps_f = fmaxf(kEps, (10.f * FLT_EPSILON) * scale);
  const float eps_gap = fmaxf(kEps, (50.f * FLT_EPSILON) * scale);
  float gap = fabsf(block_reduce<kSum>(gs, red));

  bool running = gap > tol;
  bool mode = false;  // exact-direction mode (full-depth PCR tail)
  float gap_prev = -inf_f();
  int it = 0;
  float m[E], d[E], bw[E], bx[E], aux[E], xn[E];
  while (running && it < max_iters) {
    float msum = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const bool in = lam[k] > 0.f &&
                      ((w[k] > -lam[k] && w[k] < lam[k]) ||
                       (w[k] == -lam[k] && g[k] < -kEps) ||
                       (w[k] == lam[k] && g[k] > kEps));
      m[k] = (in ? 1.f : 0.f) * v[k];
      msum += m[k];
    }
    const bool any_inact = block_reduce<kSum>(msum, red) > 0.f;
    pcr_masked<E>(m, g, d, n, head_steps, mode, sb, sc, sd, xch);
    float grd = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      d[k] *= m[k];
      grd += g[k] * d[k] * m[k];
    }
    const float gRd = block_reduce<kSum>(grd, red);

    // delta = 1 is the exact minimizer of the reduced quadratic; the halving
    // fallback runs only when clipping broke the Armijo test.
    const float imp1 = trial<E>(1.f, w, d, m, lam, x, aux, xn, xch, red);
    bool found = imp1 >= sigma * gRd || imp1 <= eps_f;
    float f_new = found ? fval - imp1 : fval;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      bw[k] = found ? aux[k] : w[k];
      bx[k] = found ? xn[k] : x[k];
    }
    if (!found) {
      float delta = 0.5f;
      const int stages[2] = {3, max_armijo - 4};
      for (int st = 0; st < 2 && !found; ++st) {
        if (st == 1) delta = 0.0625f;
        for (int i = 0; i < stages[st] && !found; ++i, delta *= 0.5f) {
          const float imp = trial<E>(delta, w, d, m, lam, x, aux, xn, xch, red);
          if (imp >= (sigma * delta) * gRd || imp <= eps_f) {
            found = true;
            f_new = fval - imp;
#pragma unroll
            for (int k = 0; k < E; ++k) {
              bw[k] = aux[k];
              bx[k] = xn[k];
            }
          }
        }
      }
    }

    const float xnext0 = from_next(bx[0], xch);
    float gn[E];
    float gsum = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      gn[k] = (bx[k] - (k + 1 < E ? bx[k + 1] : xnext0)) * v[k];
      gsum += fabsf(gn[k]) * lam[k] + bw[k] * gn[k];
    }
    const float gap_new = fabsf(block_reduce<kSum>(gsum, red));
    float gap_prev_out = gap_prev;
    if (any_inact) {  // act = running & any_inact, running holds here
#pragma unroll
      for (int k = 0; k < E; ++k) {
        w[k] = bw[k];
        x[k] = bx[k];
        g[k] = gn[k];
      }
      fval = f_new;
      gap_prev_out = gap;
      gap = gap_new;
    }
    ++it;
    // A stalled fiber is promoted to exact-direction mode; one that stalls
    // while already exact stops (RC_STUCK).
    const bool stuck = gap > tol && fabsf(gap - gap_prev_out) <= eps_gap;
    running = any_inact && gap > tol && !(stuck && mode);
    mode = mode || (stuck && running);
    gap_prev = gap_prev_out;
  }

  // Degenerate guards: zero penalty -> identity; enormous penalty -> mean.
  float lmin = inf_f(), lsum = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    if (v[k] > 0.f) lmin = fminf(lmin, lam[k]);
    lsum += lam[k];
  }
  lmin = block_reduce<kMin>(lmin, red);
  lsum = block_reduce<kSum>(lsum, red);
  const bool allz = lsum <= 0.f;
  const bool huge = lmin >= (static_cast<float>(n) * static_cast<float>(n)) * dymax;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = j0 + k;
    if (j < n) {
      float xo = huge ? 0.f : x[k];
      xo = allz ? y[k] : xo;
      X[base + j] = xo + ybar;
      if (WO != nullptr) WO[base + j] = w[k] * v[k];
    }
  }
  if (ITERS != nullptr && threadIdx.x == 0) ITERS[blockIdx.x] = it;
}

template <int E, int MAXT>
int launch(const float* y, const float* lam, float lam_scalar, const float* w0,
           float* x, float* w, int* iters, int B, int n, int max_iters,
           int max_armijo, float sigma, float stop_rel, int head_steps,
           cudaStream_t stream) {
  const int threads = ((n + E - 1) / E + 31) / 32 * 32;
  const size_t smem = (3 * static_cast<size_t>(threads) * E + threads + 32) *
                      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      pn_kernel<E, MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  pn_kernel<E, MAXT><<<B, threads, smem, stream>>>(
      y, lam, lam_scalar, w0, x, w, iters, n, max_iters, max_armijo, sigma,
      stop_rel, head_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y, x: (B, n) float32; lam: (B, n) with a zero last column, or NULL for
// lam_scalar; w0, w: (B, n) or NULL; iters: (B,) int32 or NULL.
// 2 <= n <= 8192 (checked by the Python wrapper).
extern "C" int pn_tv1_fused(const float* y, const float* lam, float lam_scalar,
                            const float* w0, float* x, float* w, int* iters,
                            int B, int n, int max_iters, int max_armijo,
                            float sigma, float stop_rel, int head_steps,
                            cudaStream_t stream) {
  if (n <= 128)
    return launch<1, 128>(y, lam, lam_scalar, w0, x, w, iters, B, n,
                          max_iters, max_armijo, sigma, stop_rel, head_steps,
                          stream);
  if (n <= 1024)
    return launch<4, 256>(y, lam, lam_scalar, w0, x, w, iters, B, n,
                          max_iters, max_armijo, sigma, stop_rel, head_steps,
                          stream);
  if (n <= 2048)
    return launch<8, 256>(y, lam, lam_scalar, w0, x, w, iters, B, n,
                          max_iters, max_armijo, sigma, stop_rel, head_steps,
                          stream);
  return launch<8, 1024>(y, lam, lam_scalar, w0, x, w, iters, B, n, max_iters,
                         max_armijo, sigma, stop_rel, head_steps, stream);
}
