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
// u2, u3, y) and writes 5, 92 MB at 32 x 256 x 256 — 27.5 us at 3.35 TB/s,
// against ~30 operations per cell per iteration (~1 us at 67 TFLOP/s).  So
// the bound is bytes, and K iterations run per pass over device memory
// (temporal blocking).  What held the parent kernel back was not device
// memory but the work around it: it tiled all three axes and kept six
// fields of a 12 x 12 x 36 window in 132 KB of shared memory, so one block
// ran per SM, computed 2.5x the cells it kept, and loaded, computed and
// stored in turn with nothing to overlap them.
//
// Design: a 2.5D march along L (Micikevicius's 3D stencil scheme) with the
// K steps pipelined behind each other along L (temporal blocking in the
// manner of Nguyen et al.'s 3.5D blocking, SC'10).  A block owns a (TM, TN)
// core of columns plus a halo of K cells in M and N, one thread per column
// of the (TM + 2K) x (TN + 2K) window, and walks a segment of TL layers
// (plus K layers of halo below and above it) one layer per position:
//
// *   Step s of the K runs one layer behind step s - 1.  At each march
//     position every thread holds, in registers, the state (x, xbar, u1, u2,
//     u3, y, layer bits) of its column at the layer each step is at: the
//     output of step s - 1 at the previous position is the input of step s
//     at this one, a delay line.
// *   The L-neighbour reads come from the thread's own registers: the dual
//     update of step s reads xbar one layer ahead, which step s - 1 has just
//     produced, and the divergence reads u3 one layer behind, which step s
//     produced at the previous position.
// *   Only the in-layer neighbours go through shared memory: xbar of the
//     layer (dual update, +1 along N and M) and u1, u2 (divergence, -1 along
//     N and M), 3 floats per window column, reused by every step.  Two
//     barriers per step per position.
// *   The next layer's loads are issued before the K steps of this position
//     run, so they are in flight while it computes; a block keeps 4.8 KB of
//     shared memory, so the registers alone set how many blocks share an SM.
// *   With blocks that light, the kernel is bound by its instructions, not
//     by memory: the resolvent's divide by 1 + tau is a product with a
//     reciprocal computed once per step, and the layer's place in its
//     volume is walked one layer at a time instead of divided out.
// *   The validity bits of N and M are fixed per thread; those of L ride in
//     the delay line.  Step K - 1 stores the core of its layer once that
//     layer lies inside the segment.
//
// The stencil reaches one cell per step in each direction, so after K steps
// the cells K inside the window are exact, as before; along L the march
// starts K layers below the segment and runs K layers past it, and a step's
// first layer takes a zero u3 below it (exact at the canvas's bottom edge,
// where the canvas is zero-filled, and otherwise K - s layers under the
// segment, where nothing is stored).  Every canvas cell lies in exactly one
// core of one segment, so every output cell is written.  Like the TPU
// kernel, x and xbar are not sanitized: garbage outside the volumes stays.
#include <cuda_runtime.h>

namespace {

// Threads per block (window columns) a step count allows: each thread
// carries 7 registers per step, and the cap keeps them unspilled.
__host__ __device__ constexpr int max_threads(int K) {
  return K <= 2 ? 1024 : (K <= 4 ? 768 : 640);
}
// Dynamic shared memory of a block: xbar, u1 and u2 of one layer of the
// window, reused by every step.
inline size_t smem_bytes(int threads) {
  return 3 * sizeof(float) * static_cast<size_t>(threads);
}
constexpr int kLIn = 1;   // layer lies inside a volume
constexpr int kLV3 = 2;   // layer has a valid L edge (not a volume's last)

struct Cell {  // one column's cell at one layer, as a step takes it
  float x, xb, u1, u2, u3, y;
  int lb;  // layer bits (0 outside the canvas)
};

template <int K>
__global__ void __launch_bounds__(max_threads(K))
pdhg3d_march(const float* __restrict__ sched, const float* __restrict__ X,
             const float* __restrict__ XB, const float* __restrict__ U1,
             const float* __restrict__ U2, const float* __restrict__ U3,
             const float* __restrict__ Y, float* __restrict__ XO,
             float* __restrict__ XBO, float* __restrict__ U1O,
             float* __restrict__ U2O, float* __restrict__ U3O, int Lp, int Mp,
             int N, int TL, int TM, int TN, int n_valid, int m_valid,
             int l_valid, int stride, int count, int pad_top, int pad_m,
             int grad_step) {
  __shared__ float ssched[6 * K];
  __shared__ float srcp[K];  // 1 / (1 + tau) per step
  extern __shared__ float sm[];
  const int WM = TM + 2 * K, WN = TN + 2 * K, WP = WM * WN;
  float* sxb = sm;
  float* su1 = sxb + WP;
  float* su2 = su1 + WP;

  const int tid = threadIdx.x;
  const int ni = tid % WN, mi = tid / WN;
  const int m = blockIdx.y * TM - K + mi, n = blockIdx.x * TN - K + ni;
  const int L0 = blockIdx.z * TL;
  const int l_first = L0 - K;  // layer of step 0 at march position 0
  const bool in_mn = m >= 0 && m < Mp && n >= 0 && n < N;
  const int rm = m - pad_m;
  const bool mn_img = in_mn && rm >= 0 && rm < m_valid && n < n_valid;
  const bool v1_mn = mn_img && n < n_valid - 1;
  const bool v2_mn = mn_img && rm < m_valid - 1;
  const bool has_n = ni + 1 < WN, has_m = mi + 1 < WM;
  const bool has_pn = ni > 0, has_pm = mi > 0;
  const bool core = in_mn && mi >= K && mi < K + TM && ni >= K && ni < K + TN;
  const int l_end = min(L0 + TL, Lp);
  const size_t layer = static_cast<size_t>(Mp) * N;
  const size_t g_mn = in_mn ? static_cast<size_t>(m) * N + n : 0;

  for (int i = tid; i < 6 * K; i += blockDim.x) ssched[i] = sched[i];
  if (tid < K) srcp[tid] = 1.f / (1.f + sched[6 * tid + 1]);

  // The layers are loaded in order, one per march position, so the layer's
  // place in its volume, q = (l - pad_top) mod stride, is walked, not
  // divided out.
  int l_next = l_first;
  int q_next = (l_first - pad_top) % stride;
  if (q_next < 0) q_next += stride;
  auto load_next = [&]() {
    Cell c = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0};
    const int l = l_next;
    if (in_mn && l >= 0 && l < Lp) {
      const size_t g = static_cast<size_t>(l) * layer + g_mn;
      c.x = X[g];
      c.xb = XB[g];
      c.u1 = U1[g];
      c.u2 = U2[g];
      c.u3 = U3[g];
      c.y = Y[g];
      const int r = l - pad_top;
      const bool in = r >= 0 && r < count * stride && q_next <= l_valid - 1;
      c.lb = (in ? kLIn : 0) | (in && q_next <= l_valid - 2 ? kLV3 : 0);
    }
    ++l_next;
    if (++q_next == stride) q_next = 0;
    return c;
  };

  Cell carry[K];      // carry[s]: step s's input at its layer
  float u3_below[K];  // step s's u3 one layer below its layer
#pragma unroll
  for (int s = 0; s < K; ++s) {
    carry[s] = Cell{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0};
    u3_below[s] = 0.f;
  }
  carry[0] = load_next();
  Cell ahead = load_next();

  const int positions = TL + 2 * K - 1;
  for (int t = 0; t < positions; ++t) {
    const Cell fetched = load_next();  // used from position t + 1
    float xb_up = ahead.xb;  // xbar one layer above step 0's layer
    Cell pass;               // the output of the step before
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const Cell c = carry[s];
      if (s > 0) carry[s] = pass;
      // Dual update: xbar one cell ahead along N and M from the neighbours,
      // along L from the register the step before has just written.
      sxb[tid] = c.xb;
      __syncthreads();
      const float sigma = ssched[6 * s], tau = ssched[6 * s + 1];
      const float theta = ssched[6 * s + 2];
      const float lam1 = ssched[6 * s + 3];  // N-axis penalty
      const float lam2 = ssched[6 * s + 4];  // M-axis penalty
      const float lam3 = ssched[6 * s + 5];  // L-axis penalty
      const float xn = has_n ? sxb[tid + 1] : 0.f;
      const float xm = has_m ? sxb[tid + WN] : 0.f;
      const bool in_l = c.lb & kLIn;
      const float u1 = (v1_mn && in_l)
                           ? fminf(fmaxf(c.u1 + sigma * (c.xb - xn), -lam1), lam1)
                           : 0.f;
      const float u2 = (v2_mn && in_l)
                           ? fminf(fmaxf(c.u2 + sigma * (c.xb - xm), -lam2), lam2)
                           : 0.f;
      const float u3 = (mn_img && (c.lb & kLV3))
                           ? fminf(fmaxf(c.u3 + sigma * (c.xb - xb_up), -lam3), lam3)
                           : 0.f;
      su1[tid] = u1;
      su2[tid] = u2;
      __syncthreads();
      // Primal update: the duals one cell behind along N and M from the
      // neighbours, along L from this step's previous position.  The
      // resolvent divides by 1 + tau as a product with its reciprocal.
      const float div = ((u1 - (has_pn ? su1[tid - 1] : 0.f)) +
                         (u2 - (has_pm ? su2[tid - WN] : 0.f))) +
                        (u3 - u3_below[s]);
      u3_below[s] = u3;
      const float x = c.x, y = c.y;
      const float xo = grad_step ? x - tau * ((x - y) + div)
                                 : (x - tau * div + tau * y) * srcp[s];
      const float xbo = xo + theta * (xo - x);
      pass = Cell{xo, xbo, u1, u2, u3, y, c.lb};
      xb_up = xbo;
    }
    // Step K - 1 has finished its layer: store it if the segment owns it.
    const int l_out = l_first + t - (K - 1);
    if (core && l_out >= L0 && l_out < l_end) {
      const size_t g = static_cast<size_t>(l_out) * layer + g_mn;
      XO[g] = pass.x;
      XBO[g] = pass.xb;
      U1O[g] = pass.u1;
      U2O[g] = pass.u2;
      U3O[g] = pass.u3;
    }
    carry[0] = ahead;
    ahead = fetched;
  }
}

template <int K>
int blocks_per_sm(int threads) {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, pdhg3d_march<K>, threads, smem_bytes(threads));
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

template <int K>
int launch(const float* sched, const float* x, const float* xb,
           const float* u1, const float* u2, const float* u3, const float* y,
           float* xo, float* xbo, float* u1o, float* u2o, float* u3o, int Lp,
           int Mp, int N, int TL, int TM, int TN, int n_valid, int m_valid,
           int l_valid, int stride, int count, int pad_top, int pad_m,
           int grad_step, cudaStream_t stream) {
  const int threads = (TM + 2 * K) * (TN + 2 * K);
  if (threads > max_threads(K)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(threads);  // at most 12 KB: no opt-in
  const dim3 grid((N + TN - 1) / TN, (Mp + TM - 1) / TM, (Lp + TL - 1) / TL);
  pdhg3d_march<K><<<grid, threads, smem, stream>>>(
      sched, x, xb, u1, u2, u3, y, xo, xbo, u1o, u2o, u3o, Lp, Mp, N, TL, TM,
      TN, n_valid, m_valid, l_valid, stride, count, pad_top, pad_m, grad_step);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sched: (K, 6) float32 [sigma, tau, theta, lam_N, lam_M, lam_L]; fields
// (Lp, Mp, N) float32.  Outputs must not alias inputs (neighbouring blocks
// read the pre-chunk halos).  A block owns a (TM, TN) core of columns and a
// segment of TL layers; K is one of 1, 2, 3, 4, 6, 8 (the divisors of 24 up
// to 8) and (TM + 2K)(TN + 2K) <= max_threads(K).
extern "C" int pdhg3d_chunk(const float* sched, const float* x, const float* xb,
                            const float* u1, const float* u2, const float* u3,
                            const float* y, float* xo, float* xbo, float* u1o,
                            float* u2o, float* u3o, int Lp, int Mp, int N,
                            int K, int TL, int TM, int TN, int n_valid,
                            int m_valid, int l_valid, int stride, int count,
                            int pad_top, int pad_m, int grad_step,
                            cudaStream_t stream) {
#define PDHG3D_LAUNCH(KK)                                                      \
  case KK:                                                                     \
    return launch<KK>(sched, x, xb, u1, u2, u3, y, xo, xbo, u1o, u2o, u3o, Lp, \
                      Mp, N, TL, TM, TN, n_valid, m_valid, l_valid, stride,    \
                      count, pad_top, pad_m, grad_step, stream);
  switch (K) {
    PDHG3D_LAUNCH(1)
    PDHG3D_LAUNCH(2)
    PDHG3D_LAUNCH(3)
    PDHG3D_LAUNCH(4)
    PDHG3D_LAUNCH(6)
    PDHG3D_LAUNCH(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PDHG3D_LAUNCH
}

// Blocks of the (TM, TN) core at step count K that fit one SM at once (the
// CUDA occupancy calculator: registers, shared memory and threads), or a
// negative CUDA error.
extern "C" int pdhg3d_blocks_per_sm(int K, int TM, int TN) {
  const int threads = (TM + 2 * K) * (TN + 2 * K);
  switch (K) {
    case 1: return blocks_per_sm<1>(threads);
    case 2: return blocks_per_sm<2>(threads);
    case 3: return blocks_per_sm<3>(threads);
    case 4: return blocks_per_sm<4>(threads);
    case 6: return blocks_per_sm<6>(threads);
    case 8: return blocks_per_sm<8>(threads);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
