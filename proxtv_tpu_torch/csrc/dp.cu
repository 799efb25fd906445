// Kernel D2: batched message-passing DP for the (weighted) TV-L1 prox,
// written by hand for Hopper (sm_90a).
//
// No TPU kernel: it replaces the JAX package's XLA lock-step deque machine
// proxtv_tpu/ops/tv1d_l1.py:tv1_dp (one deque operation per lane per
// while_loop step, with a device-to-host check of the loop condition on
// each), the clipped-message dynamic program of Kolmogorov, Pock & Rolinek
// (proxTV src/TVL1opt_kolmogorov.cpp:38-130).  Here the same operations
// run one after another in a plain loop: for each sample i the message
// is formed (INIT), breakpoints are popped from the front of the deque
// while the message stays below -w_i (LOWER), the lower clip bound is
// pushed (LOWER_EXIT, or both bounds when the ends meet), breakpoints are
// popped from the back while it stays above w_i (UPPER) and the upper bound
// pushed (UPPER_EXIT); then the backward pass x[i] = clip(x[i+1], lo[i],
// hi[i]).  Each operation is the plain version's (tv1_dp_plain) in the
// same order and rounding; the two multiply-adds are written with
// direct1d::mul_rn/add_rn (__fmul_rn/__fadd_rn in float, __dmul_rn/
// __dadd_rn in double) so that they do not contract into FMAs, and the
// divides are IEEE divisions.  The kernels are written for the signal's
// type T and built for float (dp_tv1) and double (dp_tv1_f64, the float64
// route of tv1_batched's DP names).
//
// What bounds it on this card: the function reads y (and the weights) once
// and writes x once, ~8 bytes an element in float32 (16 in float64), as
// D1; the deque and the clip bounds are the algorithm's workspace.  The
// operations form a dependent chain per signal, so a signal is latency:
// its chain at the latency of the memory that holds its deque.
//
// Design, two layouts by size (direct1d.cuh):
// * n <= kWarpMaxN and a batch of at most kMaxWarpWaves waves of resident
//   warps: one warp a signal, its deque arena (2n slots of
//   breakpoint and int32 slope) and clip bounds (lo, hi: n each) in shared
//   memory, 24n bytes in float32 and 40n in float64.  All 32 lanes run
//   the deque operations redundantly (broadcast reads, the same value
//   written to the same slot, uniform branches); y and the weights
//   stream through registers 32 samples at a time (lane k holds sample
//   c + k of this chunk and the next), read by shuffles.  The backward
//   pass runs on every lane out of shared memory, lane k keeping sample
//   c + k, and each 32 samples go out in one store.
// * longer signals or larger batches: one thread a signal, the arena and
//   the bounds in a global workspace that the wrapper allocates, interleaved
//   by signal
//   ([slot * B + b]), so a warp's bound writes and backward-pass reads are
//   coalesced.
#include <cuda_runtime.h>

#include "direct1d.cuh"

namespace {

using direct1d::add_rn;
using direct1d::LamT;
using direct1d::mul_rn;
using direct1d::sub_rn;
using direct1d::vmax;
using direct1d::vmin;

// A signal's shared memory in the warp layout, in elements of T: the
// breakpoints (2n), the slopes (2n int32, kSlopesT n in T), the clip bounds
// (n each).
template <class T>
constexpr int kSlopesT = 2 * sizeof(int) / sizeof(T);
template <class T>
constexpr int kWarpT = 4 + kSlopesT<T>;

// The longest signal of the warp layout: its arena and bounds take 24n
// bytes of shared memory in float32, 192 KB at 8192, and 40n in float64,
// 227 KB at 5808 (a block takes at most 227 KB).
template <class T>
constexpr int kWarpMaxN = sizeof(T) == 4 ? 8192 : 5808;
// Shared memory caps the warp layout's signals in flight (9 an SM at
// n = 1000), so a large batch runs in waves of one chain each; the thread
// layout runs every signal at once, each chain slower from global memory
// and parted by divergence.  Past this many waves the thread layout is the
// faster (H100, n = 1000, tools/time_direct.py: warp 1.549 ms at 4 waves
// against thread 1.735, 1.935 at 5 against 1.808; PERF.md).  Double
// keeps the rule: both layouts' chains carry the same events, each a
// double's latency longer, and a wave holds 40/24 fewer signals an SM.
constexpr int kMaxWarpWaves = 4;

template <class T, bool kEdge>
__global__ void __launch_bounds__(32 * direct1d::kMaxWarps)
dp_warp_kernel(const T* __restrict__ y, LamT<T> lam, T* __restrict__ x,
               int B, int n) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp
  T* pl = reinterpret_cast<T*>(smem) + (size_t)warp * kWarpT<T> * n;
  int* ps = reinterpret_cast<int*>(pl + 2 * n);  // slopes, 2n
  T* lo = pl + (2 + kSlopesT<T>) * n;            // clip bounds, n each
  T* hi = pl + (3 + kSlopesT<T>) * n;
  const T* __restrict__ yb = y + (size_t)b * n;
  T* __restrict__ xb = x + (size_t)b * n;
  const T lc = kEdge ? T(0) : lam(b, 0);  // one weight a signal
  auto W = [&](int i) { return kEdge ? lam(b, i) : lc; };
  if (direct1d::warp_degenerate([&](int i) { return __ldg(yb + i); }, W, n,
                                xb, lane))
    return;
  auto y_chunk = [&](int c) {
    const int k = c + lane;
    return k < n ? __ldg(yb + k) : T(0);
  };
  auto w_chunk = [&](int c) {
    const int k = c + lane;
    return kEdge && k < n - 1 ? lam(b, k) : T(0);
  };

  // The message at node 0 (reference :152-156).
  int L = n - 1, R = n;
  const T w0 = W(0), y0 = __ldg(yb);
  const T lo0 = -w0 + y0, hi0 = w0 + y0;
  ps[L - 1] = -1;
  pl[L] = lo0;
  ps[L] = 0;
  pl[R] = hi0;
  ps[R] = -1;
  lo[0] = lo0;
  hi[0] = hi0;
  int A = 1;
  T last_val, w_prev = w0;
  T y_cur = y_chunk(0), w_cur = w_chunk(0);
  T y_next = y_chunk(32), w_next = w_chunk(32);
  for (int i = 1;; ++i) {
    if ((i & 31) == 0) {
      y_cur = y_next;
      w_cur = w_next;
      y_next = y_chunk(i + 32);
      w_next = w_chunk(i + 32);
    }
    // INIT
    A += 1;
    const T wp = w_prev;
    const T wi = kEdge ? __shfl_sync(direct1d::kFull, w_cur, i & 31) : lc;
    const T w = i < n - 1 ? wi : T(0);
    w_prev = w;
    const T bi = __shfl_sync(direct1d::kFull, y_cur, i & 31);
    T mmin = -wp + pl[L] - bi;
    T mmax = wp + pl[R] - bi;
    int slope = 1;
    // LOWER: pop from the front while the message is below -w.
    while (mmin < -w) {
      slope = ps[L] + A;
      L += 1;
      if (L > R) break;
      mmin = add_rn(mmin, mul_rn(pl[L] - pl[L - 1], (T)slope));
    }
    // LOWER_EXIT
    if (i == n - 1) {
      last_val = pl[L > R ? L - 1 : L] - mmin / (T)slope;
      break;
    }
    L -= 1;
    ps[L - 1] = -A;
    if (L == R) {  // the ends meet: both bounds from one breakpoint
      const T p = pl[L];
      const T hm = p - (mmax - w), lm = p - (mmax + w);
      R += 1;
      ps[R] = -A;
      pl[R] = hm;
      pl[L] = lm;
      hi[i] = hm;
      lo[i] = lm;
      continue;
    }
    const T lon = pl[L + 1] - (w + mmin) / (T)slope;
    pl[L] = lon;
    lo[i] = lon;
    slope = 1;
    // UPPER: pop from the back while the message is above w.
    while (mmax > w) {
      R -= 1;
      slope = ps[R] + A;
      mmax = sub_rn(mmax, mul_rn(pl[R + 1] - pl[R], (T)slope));
      if (R == L) break;
    }
    // UPPER_EXIT
    R += 1;
    const T hu = pl[R - 1] + (w - mmax) / (T)slope;
    ps[R] = -A;
    pl[R] = hu;
    hi[i] = hu;
  }
  // Backward clamping pass (reference :216-221), 32 samples a round from
  // the top; lane k keeps sample c + k and the round stores them at once.
  T xv = last_val, mine = T(0);
  for (int c = (n - 1) & ~31; c >= 0; c -= 32) {
    for (int j = min(c + 31, n - 1); j >= c; --j) {
      if (j < n - 1) xv = vmin(vmax(xv, lo[j]), hi[j]);
      if (lane == j - c) mine = xv;
    }
    if (c + lane < n) xb[c + lane] = mine;
  }
}

// 1 when a (B, n) batch runs on the warp layout (planned into p), 0 when
// it runs on the thread layout, a negative CUDA error.
template <class T>
int warp_layout(int B, int n, bool edge, direct1d::WarpPlan* p) {
  if (n > kWarpMaxN<T>) return 0;
  const size_t per_warp = kWarpT<T> * sizeof(T) * (size_t)n;
  const cudaError_t e =
      edge ? direct1d::warp_plan(dp_warp_kernel<T, true>, per_warp, B, p)
           : direct1d::warp_plan(dp_warp_kernel<T, false>, per_warp, B, p);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return p->waves <= kMaxWarpWaves;
}

template <class T>
__global__ void __launch_bounds__(64)
dp_kernel(const T* __restrict__ y, LamT<T> lam, T* __restrict__ x,
          T* __restrict__ plam, int* __restrict__ pslope,
          T* __restrict__ lohi, int B, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T* __restrict__ yb = y + (size_t)b * n;
  T* __restrict__ xb = x + (size_t)b * n;
  if (direct1d::degenerate(yb, lam, b, n, xb)) return;

  const size_t S = (size_t)B;
#define PL(k) plam[(size_t)(k) * S + b]
#define PS(k) pslope[(size_t)(k) * S + b]
#define LO(k) lohi[(size_t)(k) * S + b]
#define HI(k) lohi[((size_t)n + (k)) * S + b]
  // The message at node 0 (reference :152-156).
  int L = n - 1, R = n;
  const T w0 = lam(b, 0), y0 = __ldg(yb);
  const T lo0 = -w0 + y0, hi0 = w0 + y0;
  PS(L - 1) = -1;
  PL(L) = lo0;
  PS(L) = 0;
  PL(R) = hi0;
  PS(R) = -1;
  LO(0) = lo0;
  HI(0) = hi0;
  int A = 1;
  T last_val;
  for (int i = 1;; ++i) {
    // INIT
    A += 1;
    const T wp = lam(b, i - 1);
    const T w = i < n - 1 ? lam(b, i) : T(0);
    const T bi = __ldg(yb + i);
    T mmin = -wp + PL(L) - bi;
    T mmax = wp + PL(R) - bi;
    int slope = 1;
    // LOWER: pop from the front while the message is below -w.
    while (mmin < -w) {
      slope = PS(L) + A;
      L += 1;
      if (L > R) break;
      mmin = add_rn(mmin, mul_rn(PL(L) - PL(L - 1), (T)slope));
    }
    // LOWER_EXIT
    if (i == n - 1) {
      last_val = PL(L > R ? L - 1 : L) - mmin / (T)slope;
      break;
    }
    L -= 1;
    PS(L - 1) = -A;
    if (L == R) {  // the ends meet: both bounds from one breakpoint
      const T pl = PL(L);
      const T hm = pl - (mmax - w), lm = pl - (mmax + w);
      R += 1;
      PS(R) = -A;
      PL(R) = hm;
      PL(L) = lm;
      HI(i) = hm;
      LO(i) = lm;
      continue;
    }
    const T lon = PL(L + 1) - (w + mmin) / (T)slope;
    PL(L) = lon;
    LO(i) = lon;
    slope = 1;
    // UPPER: pop from the back while the message is above w.
    while (mmax > w) {
      R -= 1;
      slope = PS(R) + A;
      mmax = sub_rn(mmax, mul_rn(PL(R + 1) - PL(R), (T)slope));
      if (R == L) break;
    }
    // UPPER_EXIT
    R += 1;
    const T hu = PL(R - 1) + (w - mmax) / (T)slope;
    PS(R) = -A;
    PL(R) = hu;
    HI(i) = hu;
  }
  // Backward clamping pass (reference :216-221).
  T xv = last_val;
  xb[n - 1] = xv;
  for (int j = n - 2; j >= 0; --j) {
    xv = vmin(vmax(xv, LO(j)), HI(j));
    xb[j] = xv;
  }
#undef PL
#undef PS
#undef LO
#undef HI
}

template <class T>
int run(const T* y, const T* lam, int lam_rs, int lam_cs, T lam_s, T* x,
        T* plam, int* pslope, T* lohi, int B, int n, cudaStream_t stream) {
  if (B <= 0) return 0;
  const LamT<T> l{lam, (size_t)lam_rs, (size_t)lam_cs, lam_s};
  direct1d::WarpPlan p;
  const int warp = warp_layout<T>(B, n, l.per_edge(), &p);
  if (warp < 0) return -warp;
  if (warp) {
    if (l.per_edge())
      dp_warp_kernel<T, true><<<p.blocks, 32 * p.warps, p.smem, stream>>>(
          y, l, x, B, n);
    else
      dp_warp_kernel<T, false><<<p.blocks, 32 * p.warps, p.smem, stream>>>(
          y, l, x, B, n);
    return static_cast<int>(cudaGetLastError());
  }
  if (!plam || !pslope || !lohi)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 64;
  dp_kernel<T><<<(B + threads - 1) / threads, threads, 0, stream>>>(
      y, l, x, plam, pslope, lohi, B, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y, x: (B, n) float32, row-major; lam as tautstring_tv1.  Workspace of
// the thread layout (dp_warp_layout 0; NULL otherwise), interleaved by
// signal: plam (2n x B float32), pslope (2n x B int32), lohi (2n x B
// float32: lo in rows 0..n-1, hi in rows n..2n-1).  n >= 2 (checked by the
// Python wrapper).
extern "C" int dp_tv1(const float* y, const float* lam, int lam_rs,
                      int lam_cs, float lam_s, float* x, float* plam,
                      int* pslope, float* lohi, int B, int n,
                      cudaStream_t stream) {
  return run<float>(y, lam, lam_rs, lam_cs, lam_s, x, plam, pslope, lohi, B,
                    n, stream);
}

// The same in float64: y, x, the weights, plam and lohi double.
extern "C" int dp_tv1_f64(const double* y, const double* lam, int lam_rs,
                          int lam_cs, double lam_s, double* x, double* plam,
                          int* pslope, double* lohi, int B, int n,
                          cudaStream_t stream) {
  return run<double>(y, lam, lam_rs, lam_cs, lam_s, x, plam, pslope, lohi, B,
                     n, stream);
}

// 1 when dp_tv1 (dp_tv1_f64) runs a (B, n) batch (per_edge: one weight an
// edge) on the warp layout and needs no workspace, 0 on the thread layout,
// a negative CUDA error.
extern "C" int dp_warp_layout(int B, int n, int per_edge) {
  direct1d::WarpPlan p;
  return warp_layout<float>(B, n, per_edge != 0, &p);
}
extern "C" int dp_warp_layout_f64(int B, int n, int per_edge) {
  direct1d::WarpPlan p;
  return warp_layout<double>(B, n, per_edge != 0, &p);
}

// The longest signal of the warp layout, in float32 and in float64 (a
// batch of more than four waves takes the thread layout at any n).
extern "C" int dp_warp_max_n() { return kWarpMaxN<float>; }
extern "C" int dp_warp_max_n_f64() { return kWarpMaxN<double>; }
