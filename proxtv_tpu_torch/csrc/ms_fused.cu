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
// zero-penalty rows (x = y) and the duality-gap certificate.  The TPU
// kernel solves the shifted systems by normalized parallel cyclic reduction
// (ms_fused.py:45-76); this one solves them exactly in O(n), see below, so
// its roundings differ from the plain version's.
//
// What bounds it on this card: device traffic is one read of y and one
// write of x, 80 MB for a (10000, 1000) batch, ~24 us at 3.35 TB/s; the
// least work of the function is, per solve, one exact tridiagonal solve
// (~10 operations per element with the alpha-only coefficients) times
// 2 + secant steps, so it is operations-bound.  A fiber's solve is a chain
// of dependent steps, so the design keeps that chain in registers and
// shuffles, and many fibers in flight.
//
// Design.  A fiber runs on W warps (W = 1 for n <= 256, more above), and
// lane r of the fiber owns the contiguous chunk j = rE .. rE + E - 1 of the
// row in registers (dy, the dual w, the solve's coefficients); lanes past
// n are zero and decoupled identity rows, like the TPU kernel's lane
// padding.  Each shifted solve is the exact partitioned solve of
// tridiag.cuh (the chunk serially in registers, the lanes by PCR over
// shuffles, the warps' boundary rows after one barrier), its coefficients
// made once per alpha.  DD' + alpha I is a diagonally dominant M-matrix and
// every pivot is a sum of nonnegative terms, so the float32 solve stays
// accurate at alpha -> 0, where the system's condition grows as n^2.
// Reciprocals take the place of divides, by the hardware's approximate rcp
// (within 1 ulp): the correctly rounded __frcp_rn cost 25% of the kernel at
// (10000, 1000).
//
// Row sums and edge exchanges cross warps through fiber.cuh's
// double-buffered slots, one barrier each, every thread holding the same
// bits.  A secant step crosses warps twice (the boundary system and ||w||).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tridiag.cuh"

namespace {

constexpr float kEps = 1e-10f;
constexpr int kSlot = 4 * 32;          // floats per shared slot
constexpr int kFibersPerBlock = 4;     // W = 1: one warp per fiber

// Threads of a block, and the blocks each SM should hold: up to 4 warps a
// fiber, at least 768 threads an SM (at most 85 registers a thread), so
// six fibers of 1000 share an SM; above, what the registers give.
template <int W>
constexpr int threads_of() { return W == 1 ? 32 * kFibersPerBlock : 32 * W; }
template <int W>
constexpr int blocks_per_sm() { return W <= 4 ? 768 / threads_of<W>() : 1; }

// (DD' + alpha I) w = rhs on rows j < m, identity rows (w = 0) from m on,
// for the chunk of E elements at j0 (tridiag.cuh): couplings
// c_j = [j + 1 < m], excess alpha inside the row.  The coefficients depend
// only on alpha, so the bootstrap's two solves share one setup.
struct ShiftCoef {
  float alpha;
  int j0, m;
  __device__ __forceinline__ bool c(int k) const { return j0 + k + 1 < m; }
  __device__ __forceinline__ bool live(int k) const { return j0 + k < m; }
  __device__ __forceinline__ float a0() const {
    return live(0) && j0 >= 1 ? 1.f : 0.f;
  }
  __device__ __forceinline__ float e(int k) const {
    const float ck = c(k) ? 1.f : 0.f;
    if (k == 0) return live(0) ? alpha + (1.f - a0()) + (1.f - ck) : 1.f;
    return live(k) ? alpha + (1.f - ck) : 1.f;
  }
};

template <int E>
struct Shifted : Tridiag<E, ShiftCoef> {
  __device__ __forceinline__ void setup(float alpha, int j0, int m) {
    this->cf = ShiftCoef{alpha, j0, m};
    Tridiag<E, ShiftCoef>::setup();
  }
};

template <int E, int W>
__global__ void __launch_bounds__(threads_of<W>(), blocks_per_sm<W>())
ms_kernel(const float* __restrict__ Y, const float* __restrict__ LAM,
          float lam_scalar, const float* __restrict__ A0,
          float* __restrict__ X, float* __restrict__ ALPHA,
          float* __restrict__ GAP, int* __restrict__ ITERS, int nrows, int n,
          int max_iters, float stop_boundary) {
  __shared__ float slots[2 * kSlot];
  Fiber<W> g;
  g.lane = threadIdx.x & 31;
  g.slots = slots;
  size_t row;
  if constexpr (W == 1) {
    g.wid = 0;
    row = static_cast<size_t>(blockIdx.x) * kFibersPerBlock + (threadIdx.x >> 5);
    if (row >= static_cast<size_t>(nrows)) return;  // whole warps leave
  } else {
    g.wid = threadIdx.x >> 5;
    row = blockIdx.x;
  }
  const int j0 = g.rank() * E, m = n - 1;
  const size_t base = row * n;

  float y[E];
  float s[1] = {0.f};
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = j0 + k;
    y[k] = j < n ? Y[base + j] : 0.f;
    s[0] += y[k];
  }
  // Center (translation equivariance); lanes past n stay zero.
  g.sum(s);
  const float ybar = s[0] / static_cast<float>(n);
#pragma unroll
  for (int k = 0; k < E; ++k) y[k] = j0 + k < n ? y[k] - ybar : 0.f;
  float yprev, ynext0;
  g.exchange(y[0], y[E - 1], yprev, ynext0);
  float dy[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const float v = j0 + k < m ? 1.f : 0.f;
    dy[k] = ((k + 1 < E ? y[k + 1] : ynext0) - y[k]) * v;
  }

  const float lam = LAM != nullptr ? LAM[row] : lam_scalar;
  const bool zero_pen = lam <= 0.f;
  const float safe_lam = lam > 0.f ? lam : 1.f;
  const float tolb = stop_boundary * safe_lam;

  // Bootstrap: one Newton step of the secular equation from the start
  // point (reference more_TV2 update, src/TVL2opt.cpp:106-128); both solves
  // share the start point's coefficients.
  const float a_start = A0 != nullptr ? fmaxf(A0[row], 0.f) : 0.f;
  Shifted<E> sys;
  sys.setup(a_start, j0, m);
  float w[E], pair[2] = {0.f, 0.f};  // ||w||^2 and w'q
  {
    float q[E];
    sys.solve(g, dy, w);
    sys.solve(g, w, q);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      pair[0] = fmaf(w[k], w[k], pair[0]);
      pair[1] = fmaf(w[k], q[k], pair[1]);
    }
  }
  g.sum(pair);
  const float nrm2_s = pair[0], wq_s = pair[1];
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
    sys.setup(alpha, j0, m);
    sys.solve(g, dy, w);
    float sq[1] = {0.f};
#pragma unroll
    for (int k = 0; k < E; ++k) sq[0] = fmaf(w[k], w[k], sq[0]);
    g.sum(sq);
    const float nrm = sqrtf(sq[0]);
    const float phi = 1.f / safe_lam - 1.f / fmaxf(nrm, kEps);
    const float denom = phi - phiprev;
    const float secant = alpha - phi * (alpha - aprev) / denom;
    const float alpha_new = fmaxf(fabsf(denom) > kEps ? secant : alpha, 0.f);
    const bool inter = alpha <= 0.f && nrm <= safe_lam;
    const bool conv = fabsf(nrm - safe_lam) <= tolb || inter;
    interior = inter;
    aprev = alpha;
    phiprev = phi;
    if (!conv) alpha = alpha_new;
    ++it;
    running = !conv;
  }

  // x = y + D'w (interior: the centered mean 0; zero penalty: y), and the
  // gap lam ||g|| + w'g with g = Dx.  y is read again (the solve's
  // registers held its place).
  float wprev0, wnext;
  g.exchange(w[0], w[E - 1], wprev0, wnext);
  float x[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = j0 + k;
    const float yc = j < n ? Y[base + j] - ybar : 0.f;
    x[k] = yc + (w[k] - (k > 0 ? w[k - 1] : wprev0));
    x[k] = interior ? 0.f : x[k];
    x[k] = zero_pen ? yc : x[k];
  }
  float xprev, xnext0;
  g.exchange(x[0], x[E - 1], xprev, xnext0);
  float gw[2] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const float v = j0 + k < m ? 1.f : 0.f;
    const float gk = (x[k] - (k + 1 < E ? x[k + 1] : xnext0)) * v;
    gw[0] = fmaf(gk, gk, gw[0]);
    gw[1] = fmaf(w[k], gk, gw[1]);
  }
  g.sum(gw);
  float gap = fabsf(lam * sqrtf(gw[0]) + gw[1]);
  if (interior || zero_pen) gap = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = j0 + k;
    if (j < n) X[base + j] = x[k] + ybar;
  }
  if (g.rank() == 0) {
    ALPHA[row] = alpha;
    GAP[row] = gap;
    ITERS[row] = it;
  }
}

template <int E, int W>
int launch(const float* y, const float* lam, float lam_scalar, const float* a0,
           float* x, float* alpha, float* gap, int* iters, int B, int n,
           int max_iters, float stop_boundary, cudaStream_t stream) {
  const int threads = threads_of<W>();
  const int blocks = W == 1 ? (B + kFibersPerBlock - 1) / kFibersPerBlock : B;
  ms_kernel<E, W><<<blocks, threads, 0, stream>>>(
      y, lam, lam_scalar, a0, x, alpha, gap, iters, B, n, max_iters,
      stop_boundary);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y, x: (B, n) float32; lam: (B,) or NULL for lam_scalar; a0: (B,) or NULL;
// alpha, gap: (B,) float32; iters: (B,) int32.  2 <= n <= 8192 (checked by
// the Python wrapper).  A fiber covers 32 W E elements.
extern "C" int ms_tv2_fused(const float* y, const float* lam, float lam_scalar,
                            const float* a0, float* x, float* alpha,
                            float* gap, int* iters, int B, int n,
                            int max_iters, float stop_boundary,
                            cudaStream_t stream) {
#define MS_LAUNCH(E, W)                                                      \
  return launch<E, W>(y, lam, lam_scalar, a0, x, alpha, gap, iters, B, n,   \
                      max_iters, stop_boundary, stream)
  if (n <= 128) MS_LAUNCH(4, 1);
  if (n <= 256) MS_LAUNCH(8, 1);
  if (n <= 512) MS_LAUNCH(8, 2);
  if (n <= 1024) MS_LAUNCH(8, 4);
  if (n <= 2048) MS_LAUNCH(8, 8);
  if (n <= 4096) MS_LAUNCH(8, 16);
  if (n <= 8192) MS_LAUNCH(16, 16);
#undef MS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
