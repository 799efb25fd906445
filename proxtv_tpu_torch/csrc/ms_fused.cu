// Kernel B4: the whole More-Sorensen TV-L2 prox per fiber, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel proxtv_tpu/ops/kernels/ms_fused.py:ms_tv2_fused
// (pallas_call at :256, body _make_kernel :79-179).  For each row y of a
// (B, n) float32 batch it solves
//     min_x 0.5 ||x - y||^2 + lam ||D x||_2
// on the dual ball ||w|| <= lam: centering, a bootstrap Newton step of the
// secular equation phi(alpha) = 1/lam - 1/||w(alpha)|| (two shifted solves
// (DD' + alpha I) w = dy, (DD' + alpha I) q = w), then the safeguarded
// secant iteration (one shifted solve per step) until
// | ||w|| - lam | <= stop_boundary * lam, the interior case (x = mean), the
// zero-penalty rows (x = y) and the duality-gap certificate.  The shifted
// solves are normalized parallel cyclic reduction (ms_fused.py:45-76).
//
// What bounds it on this card: device traffic is one read of y and one
// write of x, 80 MB for a (10000, 1000) batch, ~24 us at 3.35 TB/s; the
// work is (2 + secant steps) PCR solves of ceil(log2 n) steps of ~18 flops
// per element, ~0.2 ms at 67 TFLOP/s for ~6 steps, so it is
// operations-bound.  Each PCR step is two block-wide barriers, so a fiber's
// solve is latency-bound: the design keeps several fibers on each SM.
//
// Design: one block per fiber, so every fiber stops on its own (the TPU
// kernel's loop runs per tile of rows; its updates are masked per row, so
// the results are the same).  Thread t owns a contiguous chunk of E
// elements held in registers (centered y, dy, the dual w); lanes past n are
// zero and decoupled identity rows, exactly like the TPU kernel's lane
// padding.  Row sums are warp-shuffle + shared-memory reductions whose
// result every thread computes identically, so every loop branch is
// uniform across the block.  The PCR keeps (b, c, d) in shared memory
// (3 x T*E floats: 12 KB for n <= 1024, so several fibers share an SM;
// 96 KB at n = 8192, above the 48 KB default, hence cudaFuncSetAttribute).
#include <cuda_runtime.h>
#include <stdint.h>

#include "block.cuh"

namespace {

constexpr float kEps = 1e-10f;

// Normalized PCR solve of (DD' + alpha I) w = rhs on rows 0..n-2, identity
// rows (zero right-hand side) elsewhere.  The unnormalized off-diagonals
// are -(v_j v_{j-1}) and -(v_{j+1} v_j): -1 inside, 0 at the ends.
template <int E>
__device__ void pcr_shifted(const float (&rhs)[E], float alpha, float (&d)[E],
                            int n, float* sb, float* sc, float* sd) {
  const int j0 = threadIdx.x * E;
  const int nw = blockDim.x * E;
  float b[E], c[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = j0 + k;
    const float v = j < n - 1 ? 1.f : 0.f;
    const float r = 1.f / (1.f + v * (1.f + alpha));
    b[k] = (j >= 1 && j <= n - 2 ? -1.f : 0.f) * r;
    c[k] = (j <= n - 3 ? -1.f : 0.f) * r;
    d[k] = (v * rhs[k]) * r;
  }
  for (int s = 1; s < n; s <<= 1) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < E; ++k) {
      sb[j0 + k] = b[k];
      sc[j0 + k] = c[k];
      sd[j0 + k] = d[k];
    }
    __syncthreads();
    const bool keep = 2 * s < n;  // b, c dead after the final step
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int j = j0 + k;
      const bool lo = j - s >= 0, hi = j + s < nw;
      const float bm = lo ? sb[j - s] : 0.f, bp = hi ? sb[j + s] : 0.f;
      const float cm = lo ? sc[j - s] : 0.f, cp = hi ? sc[j + s] : 0.f;
      const float dm = lo ? sd[j - s] : 0.f, dp = hi ? sd[j + s] : 0.f;
      const float r = 1.f / (1.f - b[k] * cm - c[k] * bp);
      d[k] = (d[k] - b[k] * dm - c[k] * dp) * r;
      if (keep) {
        b[k] = (-b[k] * bm) * r;
        c[k] = (-c[k] * cp) * r;
      }
    }
  }
}

template <int E, int MAXT>
__global__ void __launch_bounds__(MAXT)
ms_kernel(const float* __restrict__ Y, const float* __restrict__ LAM,
          float lam_scalar, const float* __restrict__ A0,
          float* __restrict__ X, float* __restrict__ ALPHA,
          float* __restrict__ GAP, int* __restrict__ ITERS, int n,
          int max_iters, float stop_boundary) {
  extern __shared__ float sm[];
  const int T = blockDim.x, nw = T * E;
  float* sb = sm;
  float* sc = sb + nw;
  float* sd = sc + nw;
  float* xch = sd + nw;
  float* red = xch + T;
  const int j0 = threadIdx.x * E;
  const size_t row = blockIdx.x;
  const size_t base = row * n;

  float y[E];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = j0 + k;
    y[k] = j < n ? Y[base + j] : 0.f;
    s += y[k];
  }
  // Center (translation equivariance); lanes past n stay zero.
  const float ybar = block_reduce<kSum>(s, red) / static_cast<float>(n);
#pragma unroll
  for (int k = 0; k < E; ++k) y[k] = j0 + k < n ? y[k] - ybar : 0.f;
  const float ynext0 = from_next(y[0], xch);
  float dy[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const float v = j0 + k < n - 1 ? 1.f : 0.f;
    dy[k] = ((k + 1 < E ? y[k + 1] : ynext0) - y[k]) * v;
  }

  const float lam = LAM != nullptr ? LAM[row] : lam_scalar;
  const bool zero_pen = lam <= 0.f;
  const float safe_lam = lam > 0.f ? lam : 1.f;
  const float tolb = stop_boundary * safe_lam;

  // Bootstrap: one Newton step of the secular equation from the start
  // point (reference more_TV2 update, src/TVL2opt.cpp:106-128).
  const float a_start = A0 != nullptr ? fmaxf(A0[row], 0.f) : 0.f;
  float w[E], q[E];
  pcr_shifted<E>(dy, a_start, w, n, sb, sc, sd);
  pcr_shifted<E>(w, a_start, q, n, sb, sc, sd);
  float ww = 0.f, wq = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    ww += w[k] * w[k];
    wq += w[k] * q[k];
  }
  const float nrm2_s = block_reduce<kSum>(ww, red);
  const float wq_s = block_reduce<kSum>(wq, red);
  const float nrm_s = sqrtf(nrm2_s);
  const float delta0 =
      (nrm2_s / fmaxf(wq_s, kEps)) * (nrm_s - safe_lam) / safe_lam;
  float alpha = fmaxf(a_start + delta0, 0.f);
  float aprev = a_start;
  float phiprev = 1.f / safe_lam - 1.f / fmaxf(nrm_s, kEps);
  // Interior case: ||w(0)|| <= lam means x is exactly the mean.
  bool interior = a_start <= 0.f && nrm_s <= safe_lam;
  bool running =
      !(fabsf(nrm_s - safe_lam) <= tolb || interior) && !zero_pen;
  int it = 0;
  while (running && it < max_iters) {
    float wn[E];
    pcr_shifted<E>(dy, alpha, wn, n, sb, sc, sd);
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) sq += wn[k] * wn[k];
    const float nrm = sqrtf(block_reduce<kSum>(sq, red));
    const float phi = 1.f / safe_lam - 1.f / fmaxf(nrm, kEps);
    const float denom = phi - phiprev;
    const float secant = alpha - phi * (alpha - aprev) / denom;
    const float alpha_new = fmaxf(fabsf(denom) > kEps ? secant : alpha, 0.f);
    const bool inter = alpha <= 0.f && nrm <= safe_lam;
    const bool conv = fabsf(nrm - safe_lam) <= tolb || inter;
#pragma unroll
    for (int k = 0; k < E; ++k) w[k] = wn[k];
    interior = inter;
    aprev = alpha;
    phiprev = phi;
    if (!conv) alpha = alpha_new;
    ++it;
    running = !conv;
  }

  // x = y + D'w (interior: the centered mean 0; zero penalty: y), and the
  // gap lam ||g|| + w'g with g = Dx.
  const float wprev0 = from_prev(w[E - 1], xch);
  float x[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    x[k] = y[k] + (w[k] - (k > 0 ? w[k - 1] : wprev0));
    x[k] = interior ? 0.f : x[k];
    x[k] = zero_pen ? y[k] : x[k];
  }
  const float xnext0 = from_next(x[0], xch);
  float gg = 0.f, wg = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const float v = j0 + k < n - 1 ? 1.f : 0.f;
    const float g = (x[k] - (k + 1 < E ? x[k + 1] : xnext0)) * v;
    gg += g * g;
    wg += w[k] * g;
  }
  const float gsum = block_reduce<kSum>(gg, red);
  const float wgsum = block_reduce<kSum>(wg, red);
  float gap = fabsf(lam * sqrtf(gsum) + wgsum);
  if (interior || zero_pen) gap = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = j0 + k;
    if (j < n) X[base + j] = x[k] + ybar;
  }
  if (threadIdx.x == 0) {
    ALPHA[row] = alpha;
    GAP[row] = gap;
    ITERS[row] = it;
  }
}

template <int E, int MAXT>
int launch(const float* y, const float* lam, float lam_scalar, const float* a0,
           float* x, float* alpha, float* gap, int* iters, int B, int n,
           int max_iters, float stop_boundary, cudaStream_t stream) {
  const int threads = ((n + E - 1) / E + 31) / 32 * 32;
  const size_t smem = (3 * static_cast<size_t>(threads) * E + threads + 32) *
                      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ms_kernel<E, MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ms_kernel<E, MAXT><<<B, threads, smem, stream>>>(
      y, lam, lam_scalar, a0, x, alpha, gap, iters, n, max_iters,
      stop_boundary);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y, x: (B, n) float32; lam: (B,) or NULL for lam_scalar; a0: (B,) or NULL;
// alpha, gap: (B,) float32; iters: (B,) int32.  2 <= n <= 8192 (checked by
// the Python wrapper).
extern "C" int ms_tv2_fused(const float* y, const float* lam, float lam_scalar,
                            const float* a0, float* x, float* alpha,
                            float* gap, int* iters, int B, int n,
                            int max_iters, float stop_boundary,
                            cudaStream_t stream) {
  if (n <= 128)
    return launch<1, 128>(y, lam, lam_scalar, a0, x, alpha, gap, iters, B, n,
                          max_iters, stop_boundary, stream);
  if (n <= 1024)
    return launch<4, 256>(y, lam, lam_scalar, a0, x, alpha, gap, iters, B, n,
                          max_iters, stop_boundary, stream);
  if (n <= 2048)
    return launch<8, 256>(y, lam, lam_scalar, a0, x, alpha, gap, iters, B, n,
                          max_iters, stop_boundary, stream);
  return launch<8, 1024>(y, lam, lam_scalar, a0, x, alpha, gap, iters, B, n,
                         max_iters, stop_boundary, stream);
}
