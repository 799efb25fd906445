// Kernel B6: one K-iteration chunk of 3D anisotropic TV-L1 PDHG
// (Chambolle-Pock resolvent step, or Condat's gradient step) over three dual
// fields, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel proxtv_tpu/ops/kernels/pdhg3d_fused.py:pdhg3d_chunk
// (pallas_call at :282, body _make_kernel :76-182).  State is a set of
// (Lp, Mp, N) float32 canvases holding `count` volumes stacked along L with
// period `stride`; cells outside a volume and the last edge of each axis
// carry lam = 0, which pins their duals to 0 and exactly decouples them.  The
// validity masks come from the global layer r = l - pad_top
// (q = r mod stride), the row rm = m - pad_m and the column, as on the TPU.
// There is no certificate inside: the driver computes it between chunks.
//
// What bounds it on this card: one chunk reads 6 canvas fields (x, xbar, u1,
// u2, u3, y) and writes 5, ~98 MB at 32 x 256 x 256 — ~29 us at 3.35 TB/s,
// against ~30 flops per cell per iteration (~1 us at 67 TFLOP/s).  So it is
// bytes-bound, and K iterations run per pass over device memory.
//
// Design: the TPU kernel keeps whole N-lines of (WL, WM) bricks in VMEM; 6
// fields of even a 12 x 12 window of 256-long lines take 884 KB, beyond the
// 227 KB a block may use.  So all three axes are tiled: each block owns a
// (TL, TM, TN) core and loads a window with a halo of K cells on every side
// (zero outside the canvas, the TPU's zero fill at the canvas edges) of every
// field into shared memory, plus a 16-bit word per cell holding the three
// validity bits and the six "neighbour inside the window" bits, so the
// K steps do no index arithmetic.  The stencil reaches one cell per step in
// each direction (the dual update reads xbar one cell ahead, the primal
// update reads the duals one cell behind), so after K steps the cells K
// inside the window, the core, are exact.  Each step is two phases with a
// barrier after each (dual update in place, then primal update in place:
// each phase reads only its own cell of the fields it writes).  Every
// canvas cell is in exactly one core, so every output cell is written.  Like
// the TPU kernel, x and xbar are not sanitized: garbage outside the volumes
// stays there.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

enum : uint16_t {
  kV1 = 1, kV2 = 2, kV3 = 4,              // valid N / M / L dual edge
  kNN = 8, kNM = 16, kNL = 32,            // next cell along N / M / L in window
  kPN = 64, kPM = 128, kPL = 256,         // previous cell along N / M / L
};

__global__ void __launch_bounds__(kThreads)
pdhg3d_kernel(const float* __restrict__ sched, const float* __restrict__ X,
              const float* __restrict__ XB, const float* __restrict__ U1,
              const float* __restrict__ U2, const float* __restrict__ U3,
              const float* __restrict__ Y, float* __restrict__ XO,
              float* __restrict__ XBO, float* __restrict__ U1O,
              float* __restrict__ U2O, float* __restrict__ U3O, int Lp,
              int Mp, int N, int K, int TL, int TM, int TN, int n_valid,
              int m_valid, int l_valid, int stride, int count, int pad_top,
              int pad_m, int grad_step) {
  extern __shared__ float sm[];
  const int WL = TL + 2 * K, WM = TM + 2 * K, WN = TN + 2 * K;
  const int WP = WM * WN;  // one window layer
  const int W = WL * WP;
  float* sx = sm;
  float* sxb = sx + W;
  float* su1 = sxb + W;
  float* su2 = su1 + W;
  float* su3 = su2 + W;
  float* sy = su3 + W;
  float* ssched = sy + W;
  uint16_t* smask = reinterpret_cast<uint16_t*>(ssched + 6 * K);

  const int l0 = blockIdx.z * TL - K;  // canvas coordinates of window (0,0,0)
  const int m0 = blockIdx.y * TM - K;
  const int n0 = blockIdx.x * TN - K;
  for (int i = threadIdx.x; i < 6 * K; i += blockDim.x) ssched[i] = sched[i];
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    const int ni = c % WN, mi = (c / WN) % WM, li = c / WP;
    const int l = l0 + li, m = m0 + mi, n = n0 + ni;
    float x = 0.f, xb = 0.f, u1 = 0.f, u2 = 0.f, u3 = 0.f, y = 0.f;
    uint16_t mk = (ni + 1 < WN ? kNN : 0) | (mi + 1 < WM ? kNM : 0) |
                  (li + 1 < WL ? kNL : 0) | (ni > 0 ? kPN : 0) |
                  (mi > 0 ? kPM : 0) | (li > 0 ? kPL : 0);
    if (l >= 0 && l < Lp && m >= 0 && m < Mp && n >= 0 && n < N) {
      const size_t g = (static_cast<size_t>(l) * Mp + m) * N + n;
      x = X[g];
      xb = XB[g];
      u1 = U1[g];
      u2 = U2[g];
      u3 = U3[g];
      y = Y[g];
      const int r = l - pad_top, rm = m - pad_m;
      int q = r % stride;
      if (q < 0) q += stride;  // floor modulo, as r - (r // stride) * stride
      const bool in_img = r >= 0 && r < count * stride && q <= l_valid - 1 &&
                          rm >= 0 && rm < m_valid && n < n_valid;
      if (in_img && n < n_valid - 1) mk |= kV1;
      if (in_img && rm < m_valid - 1) mk |= kV2;
      if (in_img && q <= l_valid - 2) mk |= kV3;
    }
    sx[c] = x;
    sxb[c] = xb;
    su1[c] = u1;
    su2[c] = u2;
    su3[c] = u3;
    sy[c] = y;
    smask[c] = mk;
  }
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const float sigma = ssched[6 * k], tau = ssched[6 * k + 1];
    const float theta = ssched[6 * k + 2];
    const float lam1 = ssched[6 * k + 3];  // N-axis penalty
    const float lam2 = ssched[6 * k + 4];  // M-axis penalty
    const float lam3 = ssched[6 * k + 5];  // L-axis penalty
    // Dual update: reads xbar at the cell and one ahead on each axis.
    for (int c = threadIdx.x; c < W; c += blockDim.x) {
      const uint16_t mk = smask[c];
      const float xb = sxb[c];
      const float xn = (mk & kNN) ? sxb[c + 1] : 0.f;
      const float xm = (mk & kNM) ? sxb[c + WN] : 0.f;
      const float xl = (mk & kNL) ? sxb[c + WP] : 0.f;
      su1[c] = (mk & kV1) ? fminf(fmaxf(su1[c] + sigma * (xb - xn), -lam1), lam1)
                          : 0.f;
      su2[c] = (mk & kV2) ? fminf(fmaxf(su2[c] + sigma * (xb - xm), -lam2), lam2)
                          : 0.f;
      su3[c] = (mk & kV3) ? fminf(fmaxf(su3[c] + sigma * (xb - xl), -lam3), lam3)
                          : 0.f;
    }
    __syncthreads();
    // Primal update: reads the duals at the cell and one behind on each axis.
    for (int c = threadIdx.x; c < W; c += blockDim.x) {
      const uint16_t mk = smask[c];
      const float div = ((su1[c] - ((mk & kPN) ? su1[c - 1] : 0.f)) +
                         (su2[c] - ((mk & kPM) ? su2[c - WN] : 0.f))) +
                        (su3[c] - ((mk & kPL) ? su3[c - WP] : 0.f));
      const float x = sx[c], y = sy[c];
      const float xn = grad_step ? x - tau * ((x - y) + div)
                                 : (x - tau * div + tau * y) / (1.f + tau);
      sx[c] = xn;
      sxb[c] = xn + theta * (xn - x);
    }
    __syncthreads();
  }

  const int core = TL * TM * TN;
  for (int c = threadIdx.x; c < core; c += blockDim.x) {
    const int ni = K + c % TN, mi = K + (c / TN) % TM, li = K + c / (TN * TM);
    const int l = l0 + li, m = m0 + mi, n = n0 + ni;
    if (l >= Lp || m >= Mp || n >= N) continue;
    const int s = li * WP + mi * WN + ni;
    const size_t g = (static_cast<size_t>(l) * Mp + m) * N + n;
    XO[g] = sx[s];
    XBO[g] = sxb[s];
    U1O[g] = su1[s];
    U2O[g] = su2[s];
    U3O[g] = su3[s];
  }
}

}  // namespace

// sched: (K, 6) float32 [sigma, tau, theta, lam_N, lam_M, lam_L]; fields
// (Lp, Mp, N) float32.  Outputs must not alias inputs (neighbouring blocks
// read the pre-chunk halos).  The core is (TL, TM, TN).
extern "C" int pdhg3d_chunk(const float* sched, const float* x, const float* xb,
                            const float* u1, const float* u2, const float* u3,
                            const float* y, float* xo, float* xbo, float* u1o,
                            float* u2o, float* u3o, int Lp, int Mp, int N,
                            int K, int TL, int TM, int TN, int n_valid,
                            int m_valid, int l_valid, int stride, int count,
                            int pad_top, int pad_m, int grad_step,
                            cudaStream_t stream) {
  const size_t W = static_cast<size_t>(TL + 2 * K) * (TM + 2 * K) * (TN + 2 * K);
  const size_t smem = 6 * sizeof(float) * W + sizeof(float) * 6 * K +
                      sizeof(uint16_t) * W;
  cudaError_t e = cudaFuncSetAttribute(
      pdhg3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + TN - 1) / TN, (Mp + TM - 1) / TM, (Lp + TL - 1) / TL);
  pdhg3d_kernel<<<grid, kThreads, smem, stream>>>(
      sched, x, xb, u1, u2, u3, y, xo, xbo, u1o, u2o, u3o, Lp, Mp, N, K, TL,
      TM, TN, n_valid, m_valid, l_valid, stride, count, pad_top, pad_m,
      grad_step);
  return static_cast<int>(cudaGetLastError());
}
