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
// u2, y; +2 weight fields) and writes 4, ~40 MB at 1088 x 1024 — ~12 us at
// 3.35 TB/s, against ~22 flops per cell per iteration.  Memory-bound per
// iteration, so K iterations run per pass over device memory (temporal
// blocking) on a window that holds a core and a halo.
//
// The halo is K + 1 cells on every side, not the TPU kernel's 2K.  The dual
// step reads xbar one cell forward (r, c+1) and (r+1, c), the primal step
// reads the duals one cell back (r, c-1) and (r-1, c): each step spoils one
// more cell at each edge of the window, so after K steps a halo of K leaves
// x, xbar, u1 and u2 exact on the core, and the certificate, which reads
// xhat = Y - D'u one cell forward, needs one more
// (tests/test_torch_pdhg.py::test_pdhg_window_halo proves both on the CPU).
// Outside the canvas the window holds zeros, exactly the TPU's edge fill.
//
// Design: a block owns a window of kW = 128 columns and kWH = 64 rows
// (1024 threads); its core is the window less the halo, so the core
// shrinks as K grows and the grid follows (110 x 46 at K = 8).  Each thread owns one column
// of the window and a run of kRows consecutive rows of it, and keeps the
// whole state of its cells in registers for the chunk: x, y, xbar, u1, u2,
// the masks as bits, and lam x mask (weight fields when weighted, else one
// scalar and the bits).  Neighbours travel without shared-memory windows:
// inside a run the vertical neighbour is the thread's own register; across
// columns a warp spans 32 adjacent columns, so xbar(r, c+1) and u1(r, c-1)
// come by __shfl; only a warp's edge lanes and a run's end rows go through
// small shared buffers, so a step needs two barriers and no index
// arithmetic (every loop bound and stride is a compile-time constant).  The
// Chambolle-Pock resolvent multiplies by 1/(1 + tau_k), one division per
// step per thread (the divide per cell cost 28%).  With `GAP` set, each
// block reduces its core cells' duality-gap and objective contributions
// into one partial each; the wrapper sums them.  64 registers a thread,
// one block per SM; the weighted instances spill 180 B.  Timed on the
// H100 (tools/time_b3.py, PERF.md): a 64 x 64 window (2 blocks per SM),
// 96 x 64, 64 x 96, 64 x 48 and runs of 4 rows were slower, and so were
// float4 edge exchanges (they spill).
#include <cuda_runtime.h>
#include <stdint.h>

#include "block.cuh"

namespace {

constexpr int kWarpsX = 4;   // window width kW = 32 * kWarpsX, a thread each
constexpr int kRuns = 8;     // threads down a column: the window's runs
constexpr int kRows = 8;     // rows of a run, held in registers
constexpr int kW = 32 * kWarpsX;
constexpr int kWH = kRuns * kRows;
constexpr int kThreads = kW * kRuns;
constexpr int kMaxSteps = 16;  // largest K (the core stays >= 30 cells)
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads <= 1024 && kRows <= 32, "block or mask bits too big");
static_assert(2 * (kMaxSteps + 1) < kW && 2 * (kMaxSteps + 1) < kWH,
              "the core must keep a cell at the largest K");

__host__ __device__ constexpr int core_w(int K) { return kW - 2 * (K + 1); }
__host__ __device__ constexpr int core_h(int K) { return kWH - 2 * (K + 1); }

template <bool WEIGHTED, bool GRAD>
__global__ void __launch_bounds__(kThreads)
pdhg_kernel(const float* __restrict__ sched, const float* __restrict__ X,
            const float* __restrict__ XB, const float* __restrict__ U1,
            const float* __restrict__ U2, const float* __restrict__ Y,
            const float* __restrict__ WR, const float* __restrict__ WC,
            float* __restrict__ XO, float* __restrict__ XBO,
            float* __restrict__ U1O, float* __restrict__ U2O,
            float* __restrict__ GAP, float* __restrict__ OBJ, int nparts,
            int Mp, int Np, int K, int n_valid, int m_valid, int stride,
            int count, int pad_top) {
  __shared__ float ebx[kWarpsX][kWH];  // xbar (then xhat) of lane 0 of a warp
  __shared__ float eu1[kWarpsX][kWH];  // u1 of lane 31 of a warp
  __shared__ float rxb[kRuns][kW];     // xbar (then xhat) of a run's first row
  __shared__ float ru2[kRuns][kW];     // u2 of a run's last row
  __shared__ float ssched[4 * kMaxSteps];
  __shared__ float red[2][kThreads / 32];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int lane = tx & 31, wx = tx >> 5;
  const int tid = ty * kW + tx;
  const int H = K + 1, CW = core_w(K), CH = core_h(K);
  const int wr0 = ty * kRows;                       // window row of row 0
  const int row0 = blockIdx.y * CH - H + wr0;       // its canvas row
  const int col = blockIdx.x * CW - H + tx;         // this thread's column
  for (int i = tid; i < 4 * K; i += kThreads) ssched[i] = sched[i];
  const float lam = sched[3];  // lam column of schedule row 0

  float x[kRows], y[kRows], xb[kRows], u1[kRows], u2[kRows];
  float lrw[kRows], lcw[kRows];  // weighted only
  unsigned vrb = 0, vcb = 0, inb = 0;
  int r = row0 - pad_top;
  int q = r % stride;
  if (q < 0) q += stride;  // floor modulo, as r - (r // stride) * stride
  const bool col_in = col >= 0 && col < Np;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + i;
    float vx = 0.f, vxb = 0.f, vu1 = 0.f, vu2 = 0.f, vy = 0.f;
    float lr = 0.f, lc = 0.f;
    if (col_in && row >= 0 && row < Mp) {
      const size_t g = static_cast<size_t>(row) * Np + col;
      const bool in_img = r >= 0 && r < count * stride;
      const bool vr = col < n_valid - 1 && in_img && q <= m_valid - 1;
      const bool vc = q <= m_valid - 2 && in_img && col < n_valid;
      // Sanitize once per chunk: padding may hold garbage (NaN).
      if (in_img) {
        vx = X[g];
        vxb = XB[g];
      }
      if (vr) vu1 = U1[g];
      if (vc) vu2 = U2[g];
      vy = Y[g];
      if (WEIGHTED) {
        lr = WR[g] * (vr ? 1.f : 0.f);
        lc = WC[g] * (vc ? 1.f : 0.f);
      }
      vrb |= unsigned(vr) << i;
      vcb |= unsigned(vc) << i;
      inb |= unsigned(in_img) << i;
    }
    x[i] = vx;
    xb[i] = vxb;
    u1[i] = vu1;
    u2[i] = vu2;
    y[i] = vy;
    lrw[i] = lr;
    lcw[i] = lc;
    ++r;
    if (++q == stride) q = 0;
  }
  // lam x mask of row i: the weight field's value, or the scalar where the
  // mask holds (lam * 1 or lam * 0, as the TPU kernel multiplies).
  auto lr_of = [&](int i) {
    return WEIGHTED ? lrw[i] : ((vrb >> i) & 1u ? lam : 0.f);
  };
  auto lc_of = [&](int i) {
    return WEIGHTED ? lcw[i] : ((vcb >> i) & 1u ? lam : 0.f);
  };
  // The neighbours a thread cannot see in its registers or its warp:
  // v(r, c+1) of lane 31 and v(r+1, c) of a run's last row (zero outside
  // the window), read after the owners published them.
  auto right_of = [&](const float (&v)[kRows], int i) {
    const float s = __shfl_down_sync(kFull, v[i], 1);
    if (lane != 31) return s;
    return wx + 1 < kWarpsX ? ebx[wx + 1][wr0 + i] : 0.f;
  };
  auto below_of = [&](const float (&v)[kRows], int i) {
    if (i + 1 < kRows) return v[i + 1];
    return ty + 1 < kRuns ? rxb[ty + 1][tx] : 0.f;
  };
  // D'u at row i: u1(r, c) - u1(r, c-1) + u2(r, c) - u2(r-1, c).
  auto div_of = [&](int i) {
    float ul = __shfl_up_sync(kFull, u1[i], 1);
    if (lane == 0) ul = wx > 0 ? eu1[wx - 1][wr0 + i] : 0.f;
    const float uu = i > 0 ? u2[i - 1] : (ty > 0 ? ru2[ty - 1][tx] : 0.f);
    return (u1[i] - ul) + (u2[i] - uu);
  };
  auto publish = [&](const float (&v)[kRows]) {  // for left and upper
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) ebx[wx][wr0 + i] = v[i];
    }
    rxb[ty][tx] = v[0];
  };
  publish(xb);
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const float sigma = ssched[4 * k], tau = ssched[4 * k + 1];
    const float theta = ssched[4 * k + 2];
    // Dual update: reads xbar at (r, c), (r, c+1), (r+1, c).
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float xr = right_of(xb, i), xd = below_of(xb, i);
      const float l1 = lr_of(i), l2 = lc_of(i);
      u1[i] = fminf(fmaxf(u1[i] + sigma * (xb[i] - xr), -l1), l1);
      u2[i] = fminf(fmaxf(u2[i] + sigma * (xb[i] - xd), -l2), l2);
    }
    if (lane == 31) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) eu1[wx][wr0 + i] = u1[i];
    }
    ru2[ty][tx] = u2[kRows - 1];
    __syncthreads();
    // Primal update: reads u at (r, c), (r, c-1), (r-1, c).
    const float inv = 1.f / (1.f + tau);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float dv = div_of(i);
      float xn;
      if constexpr (GRAD)
        xn = x[i] - tau * ((x[i] - y[i]) + dv);
      else
        xn = (x[i] - tau * dv + tau * y[i]) * inv;
      xb[i] = xn + theta * (xn - x[i]);
      x[i] = xn;
    }
    publish(xb);
    __syncthreads();
  }

  const bool col_core = tx >= H && tx < H + CW && col < Np;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int li = wr0 + i;
    if (col_core && li >= H && li < H + CH && row0 + i < Mp) {
      const size_t g = static_cast<size_t>(row0 + i) * Np + col;
      XO[g] = x[i];
      XBO[g] = xb[i];
      U1O[g] = u1[i];
      U2O[g] = u2[i];
    }
  }
  if (GAP == nullptr) return;  // uniform across the grid

  // Certificate: xhat = Y - D'u is dual-feasible.  The last dual step's
  // edge values are still in eu1 / ru2; xhat is published like xbar.
  float xh[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) xh[i] = y[i] - div_of(i);
  publish(xh);
  __syncthreads();
  float e_gap = 0.f, e_obj = 0.f;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float xr = right_of(xh, i), xd = below_of(xh, i);
    const int li = wr0 + i;
    if (col_core && li >= H && li < H + CH && row0 + i < Mp) {
      const float gr = (xh[i] - xr) * ((vrb >> i) & 1u ? 1.f : 0.f);
      const float gc = (xh[i] - xd) * ((vcb >> i) & 1u ? 1.f : 0.f);
      const float l1 = lr_of(i), l2 = lc_of(i);
      e_gap += l1 * fabsf(gr) - u1[i] * gr + l2 * fabsf(gc) - u2[i] * gc;
      const float dyv = xh[i] - y[i];
      e_obj += 0.5f * dyv * dyv * ((inb >> i) & 1u ? 1.f : 0.f) +
               l1 * fabsf(gr) + l2 * fabsf(gc);
    }
  }
  e_gap = warp_reduce<kSum>(e_gap);
  e_obj = warp_reduce<kSum>(e_obj);
  if (lane == 0) {
    red[0][tid >> 5] = e_gap;
    red[1][tid >> 5] = e_obj;
  }
  __syncthreads();
  if (tid < 32) {
    const bool live = tid < kThreads / 32;
    const float gs = warp_reduce<kSum>(live ? red[0][tid] : 0.f);
    const float os = warp_reduce<kSum>(live ? red[1][tid] : 0.f);
    if (tid == 0) {
      // One partial per block; the partials past the grid (the count is
      // the grid's at kMaxSteps) are zero.
      const int nb = gridDim.x * gridDim.y;
      const int b = blockIdx.y * gridDim.x + blockIdx.x;
      GAP[b] = gs;
      OBJ[b] = os;
      for (int j = b + nb; j < nparts; j += nb) GAP[j] = OBJ[j] = 0.f;
    }
  }
}

dim3 grid_of(int Mp, int Np, int K) {
  return dim3((Np + core_w(K) - 1) / core_w(K),
              (Mp + core_h(K) - 1) / core_h(K));
}

}  // namespace

// Number of certificate partials for an (Mp, Np) canvas: the grid's blocks
// at the largest K, so one count serves every K (smaller K leave the tail 0).
extern "C" int pdhg_cert_blocks(int Mp, int Np) {
  const dim3 g = grid_of(Mp, Np, kMaxSteps);
  return static_cast<int>(g.x * g.y);
}

// Resident blocks per SM of the (weighted) instance, or a negative CUDA
// error: for the timing tool.
extern "C" int pdhg_blocks_per_sm(int weighted) {
  int n = 0;
  const cudaError_t e =
      weighted ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, pdhg_kernel<true, false>, kThreads, 0)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, pdhg_kernel<false, false>, kThreads, 0);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// sched: (K, 4) float32; fields (Mp, Np) float32; wr/wc NULL when
// unweighted; gap/obj: (pdhg_cert_blocks,) or NULL.  1 <= K <= 16.  Outputs
// must not alias inputs (neighbouring blocks read the pre-chunk halos).
extern "C" int pdhg_chunk(const float* sched, const float* x, const float* xb,
                          const float* u1, const float* u2, const float* y,
                          const float* wr, const float* wc, float* xo,
                          float* xbo, float* u1o, float* u2o, float* gap,
                          float* obj, int Mp, int Np, int K, int n_valid,
                          int m_valid, int stride, int count, int pad_top,
                          int grad_step, cudaStream_t stream) {
  if (K < 1 || K > kMaxSteps) return static_cast<int>(cudaErrorInvalidValue);
  const int nparts = pdhg_cert_blocks(Mp, Np);
  const dim3 grid = grid_of(Mp, Np, K), block(kW, kRuns);
#define PDHG_LAUNCH(W_, G_)                                                   \
  pdhg_kernel<W_, G_><<<grid, block, 0, stream>>>(                            \
      sched, x, xb, u1, u2, y, wr, wc, xo, xbo, u1o, u2o, gap, obj, nparts,   \
      Mp, Np, K, n_valid, m_valid, stride, count, pad_top)
  if (wr != nullptr) {
    if (grad_step) PDHG_LAUNCH(true, true);
    else PDHG_LAUNCH(true, false);
  } else {
    if (grad_step) PDHG_LAUNCH(false, true);
    else PDHG_LAUNCH(false, false);
  }
#undef PDHG_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
