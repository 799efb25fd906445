// Kernel B3: one K-iteration chunk of 2D anisotropic TV-L1 PDHG
// (Chambolle-Pock resolvent step, or Condat's gradient step), hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel proxtv_tpu/ops/kernels/pdhg_fused.py:pdhg_chunk
// (pallas_call at :348, body _make_kernel :68-245).  State is a row-padded
// (Mp, Np) float32 canvas of `count` images stacked with period `stride`;
// gap and pad rows and the invalid last dual column carry lam = 0, which pins
// their duals to 0 and exactly decouples them.  The validity masks come from
// the global row r = row - pad_top (q = r mod stride), as on the TPU.
//
// What bounds it on this card: one chunk reads 5 canvas fields (x, xbar, u1,
// u2, y; +2 weight fields) and writes 4, ~38 MB at 1024^2 — ~11 us at
// 3.35 TB/s, against ~25 flops per cell per iteration, ~3 us per iteration
// at 67 TFLOP/s.  Memory-bound per iteration, so K iterations run per pass
// over device memory (temporal blocking): after K steps a cell is exact if
// it lies at least K cells inside the window (the stencil reaches one cell
// per step), so a 2K halo makes the core, and the ring the certificate
// reads, exact.
//
// Design: the TPU kernel walks full-width row bands with DMA ping-pong; a
// full-width 1024-column band of 5 fields does not fit shared memory, so
// here the canvas is tiled in 2D: each block owns a 32x32 core, loads a
// (32 + 4K)^2 window (2K halo on all four sides, zero outside the canvas,
// exactly the TPU's zero fill at the canvas edges) of every field into
// shared memory, runs the K steps there with two barriers per step (dual
// update in place, then primal update in place: each phase reads only its
// own cell of the field it writes), and writes its core.  Every canvas cell
// is in exactly one core, so every output row is written.  The once-per-chunk
// sanitizing of the padding (where(in_img, x, 0) etc.) happens on load.
// With `GAP` set, each block also reduces its core cells' duality-gap and
// objective contributions into one partial each; the wrapper sums them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 512;

struct Masks {
  bool in_img, vr, vc;
};

__device__ __forceinline__ Masks masks(int row, int col, int n_valid,
                                       int m_valid, int stride, int count,
                                       int pad_top) {
  const int r = row - pad_top;
  int q = r % stride;
  if (q < 0) q += stride;  // floor modulo, as r - (r // stride) * stride
  Masks m;
  m.in_img = r >= 0 && r < count * stride;
  m.vr = col < n_valid - 1 && m.in_img && q <= m_valid - 1;
  m.vc = q <= m_valid - 2 && m.in_img && col < n_valid;
  return m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
  return warp_sum(v);
}

__global__ void __launch_bounds__(kThreads)
pdhg_kernel(const float* __restrict__ sched, const float* __restrict__ X,
            const float* __restrict__ XB, const float* __restrict__ U1,
            const float* __restrict__ U2, const float* __restrict__ Y,
            const float* __restrict__ WR, const float* __restrict__ WC,
            float* __restrict__ XO, float* __restrict__ XBO,
            float* __restrict__ U1O, float* __restrict__ U2O,
            float* __restrict__ GAP, float* __restrict__ OBJ, int Mp, int Np,
            int K, int n_valid, int m_valid, int stride, int count,
            int pad_top, int grad_step) {
  extern __shared__ float sm[];
  const int H = 2 * K;
  const int W = kTile + 2 * H;
  const int WW = W * W;
  float* sx = sm;
  float* sxb = sx + WW;
  float* su1 = sxb + WW;
  float* su2 = su1 + WW;
  float* sy = su2 + WW;
  float* slr = sy + WW;
  float* slc = slr + WW;
  float* ssched = slc + WW;
  float* red = ssched + 4 * K;

  const int row0 = blockIdx.y * kTile - H;  // canvas row of window row 0
  const int col0 = blockIdx.x * kTile - H;
  for (int i = threadIdx.x; i < 4 * K; i += blockDim.x) ssched[i] = sched[i];
  const float lam = sched[3];  // lam column of schedule row 0
  for (int c = threadIdx.x; c < WW; c += blockDim.x) {
    const int row = row0 + c / W, col = col0 + c % W;
    float x = 0.f, xb = 0.f, u1 = 0.f, u2 = 0.f, y = 0.f, lr = 0.f, lc = 0.f;
    if (row >= 0 && row < Mp && col >= 0 && col < Np) {
      const size_t g = static_cast<size_t>(row) * Np + col;
      const Masks m = masks(row, col, n_valid, m_valid, stride, count, pad_top);
      // Sanitize once per chunk: padding may hold garbage (NaN).
      if (m.in_img) {
        x = X[g];
        xb = XB[g];
      }
      if (m.vr) u1 = U1[g];
      if (m.vc) u2 = U2[g];
      y = Y[g];
      const float vr = m.vr ? 1.f : 0.f, vc = m.vc ? 1.f : 0.f;
      lr = (WR != nullptr ? WR[g] : lam) * vr;
      lc = (WC != nullptr ? WC[g] : lam) * vc;
    }
    sx[c] = x;
    sxb[c] = xb;
    su1[c] = u1;
    su2[c] = u2;
    sy[c] = y;
    slr[c] = lr;
    slc[c] = lc;
  }
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const float sigma = ssched[4 * k], tau = ssched[4 * k + 1];
    const float theta = ssched[4 * k + 2];
    // Dual update: reads xbar at (r, c), (r, c+1), (r+1, c); writes own u.
    for (int c = threadIdx.x; c < WW; c += blockDim.x) {
      const int lj = c % W;
      const float xb = sxb[c];
      const float xr = lj + 1 < W ? sxb[c + 1] : 0.f;
      const float xd = c + W < WW ? sxb[c + W] : 0.f;
      const float lr = slr[c], lc = slc[c];
      su1[c] = fminf(fmaxf(su1[c] + sigma * (xb - xr), -lr), lr);
      su2[c] = fminf(fmaxf(su2[c] + sigma * (xb - xd), -lc), lc);
    }
    __syncthreads();
    // Primal update: reads u at (r, c), (r, c-1), (r-1, c); writes own x.
    for (int c = threadIdx.x; c < WW; c += blockDim.x) {
      const int lj = c % W;
      const float u1 = su1[c], u2 = su2[c];
      const float div = (u1 - (lj > 0 ? su1[c - 1] : 0.f)) +
                        (u2 - (c >= W ? su2[c - W] : 0.f));
      const float x = sx[c], y = sy[c];
      const float xn = grad_step ? x - tau * ((x - y) + div)
                                 : (x - tau * div + tau * y) / (1.f + tau);
      sx[c] = xn;
      sxb[c] = xn + theta * (xn - x);
    }
    __syncthreads();
  }

  float e_gap = 0.f, e_obj = 0.f;
  for (int c = threadIdx.x; c < kTile * kTile; c += blockDim.x) {
    const int li = H + c / kTile, lj = H + c % kTile;
    const int row = row0 + li, col = col0 + lj;
    if (row >= Mp || col >= Np) continue;
    const int s = li * W + lj;
    const size_t g = static_cast<size_t>(row) * Np + col;
    XO[g] = sx[s];
    XBO[g] = sxb[s];
    U1O[g] = su1[s];
    U2O[g] = su2[s];
    if (GAP != nullptr) {
      // xhat = Y - D'u is dual-feasible; its neighbours at (r, c+1) and
      // (r+1, c) lie inside the window's exact region.
      auto xhat = [&](int t) {
        const int tj = t % W;
        return sy[t] - ((su1[t] - (tj > 0 ? su1[t - 1] : 0.f)) +
                        (su2[t] - (t >= W ? su2[t - W] : 0.f)));
      };
      const Masks m = masks(row, col, n_valid, m_valid, stride, count, pad_top);
      const float xh = xhat(s);
      const float gr = (xh - xhat(s + 1)) * (m.vr ? 1.f : 0.f);
      const float gc = (xh - xhat(s + W)) * (m.vc ? 1.f : 0.f);
      const float lr = slr[s], lc = slc[s];
      e_gap += lr * fabsf(gr) - su1[s] * gr + lc * fabsf(gc) - su2[s] * gc;
      const float dyv = xh - sy[s];
      e_obj += 0.5f * dyv * dyv * (m.in_img ? 1.f : 0.f) + lr * fabsf(gr) +
               lc * fabsf(gc);
    }
  }
  if (GAP != nullptr) {
    const float gs = block_sum(e_gap, red);
    const float os = block_sum(e_obj, red);
    if (threadIdx.x == 0) {
      const int b = blockIdx.y * gridDim.x + blockIdx.x;
      GAP[b] = gs;
      OBJ[b] = os;
    }
  }
}

dim3 grid_of(int Mp, int Np) {
  return dim3((Np + kTile - 1) / kTile, (Mp + kTile - 1) / kTile);
}

}  // namespace

// Number of per-block certificate partials for an (Mp, Np) canvas.
extern "C" int pdhg_cert_blocks(int Mp, int Np) {
  const dim3 g = grid_of(Mp, Np);
  return static_cast<int>(g.x * g.y);
}

// sched: (K, 4) float32; fields (Mp, Np) float32; wr/wc NULL when
// unweighted; gap/obj: (pdhg_cert_blocks,) or NULL.  Outputs must not alias
// inputs (neighbouring blocks read the pre-chunk halos).
extern "C" int pdhg_chunk(const float* sched, const float* x, const float* xb,
                          const float* u1, const float* u2, const float* y,
                          const float* wr, const float* wc, float* xo,
                          float* xbo, float* u1o, float* u2o, float* gap,
                          float* obj, int Mp, int Np, int K, int n_valid,
                          int m_valid, int stride, int count, int pad_top,
                          int grad_step, cudaStream_t stream) {
  const int W = kTile + 4 * K;
  const size_t smem = sizeof(float) * (7 * static_cast<size_t>(W) * W + 4 * K + 32);
  cudaError_t e = cudaFuncSetAttribute(
      pdhg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  pdhg_kernel<<<grid_of(Mp, Np), kThreads, smem, stream>>>(
      sched, x, xb, u1, u2, y, wr, wc, xo, xbo, u1o, u2o, gap, obj, Mp, Np, K,
      n_valid, m_valid, stride, count, pad_top, grad_step);
  return static_cast<int>(cudaGetLastError());
}
