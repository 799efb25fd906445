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
// divides are IEEE divisions.  The float32 kernels (dp_tv1) are written
// for the signal's type T; float64 (dp_tv1_f64, the float64 route of
// tv1_batched's DP names) has layouts of its own (below).
//
// What bounds it on this card: the function reads y (and the weights) once
// and writes x once, ~8 bytes an element in float32 (16 in float64), as
// D1; the deque and the clip bounds are the algorithm's workspace.  The
// operations form a dependent chain per signal, so a signal is latency:
// its chain at the latency of the memory that holds its deque.
//
// Design in float32, two layouts by size (direct1d.cuh):
// * n <= kWarpMaxN and a batch of at most kMaxWarpWaves waves of resident
//   warps: one warp a signal, its deque arena (2n slots of
//   breakpoint and int32 slope) and clip bounds (lo, hi: n each) in shared
//   memory, 24n bytes.  All 32 lanes run
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
//
// Design in float64.  In double the float32 warp layout holds 40n bytes a
// signal (5 signals an SM at n = 1000), so a batch of 10000 took the thread
// layout, whose chain waits on the global workspace at every pop and push
// (2.7 ms, against 0.05 ms of bytes).  But the deque is short whatever the
// arena's size (8 breakpoints at most on randn signals, 55 on a ramp of
// 1000: tools/dp_depths.py), the clip bounds are written once and read
// once backward, off the forward chain, and the samples run in lock step
// (one INIT a sample; only the pop loops differ in length).  So each
// signal's deque lives in a ring of 64 slots in shared memory with its
// front and back in registers (INIT and a pop test wait on no memory), the
// bounds go to the workspace, and a signal whose deque would outgrow its
// ring runs again from the workspace by the thread layout's scan (counted
// in *reruns).  Two layouts by batch (run64):
// * one warp a signal (a batch of at most kWarp64MaxB): the float32 warp
//   layout's chain on the ring, all 32 lanes redundant, 768 bytes of
//   shared memory a warp; its latency is the batch's time;
// * one signal a lane (larger batches): K chains a warp in lock step, the
//   lanes' rings interleaved in shared memory, the bounds at [i * B + b]
//   (one coalesced store a sample), x out through a transposed tile; each
//   issued instruction advances K signals.  K is the smallest of 4, 8, 16,
//   32 that keeps about kLaneWarpsSM warps an SM: fewer signals a warp
//   part less at each pop loop, more warps an SM queue for issue slots.
// Each chain divides by a slope (a whole number) through div_count2, both
// divisions of a sample side by side; the chain is still the float32
// design's in length (0.43 ms at n = 1000 for one warp a signal, float32's
// 0.34), so one warp a signal stays latency-bound (PERF.md).
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

// The longest signal of the float32 warp layout: its arena and bounds take
// 24n bytes of shared memory, 192 KB at 8192 (a block takes at most 227
// KB; in double, 40n, the float64 layouts below keep a ring instead).
template <class T>
constexpr int kWarpMaxN = sizeof(T) == 4 ? 8192 : 5808;
// Shared memory caps the warp layout's signals in flight (9 an SM at
// n = 1000), so a large batch runs in waves of one chain each; the thread
// layout runs every signal at once, each chain slower from global memory
// and parted by divergence.  Past this many waves the thread layout is the
// faster (H100, n = 1000, tools/time_direct.py: warp 1.549 ms at 4 waves
// against thread 1.735, 1.935 at 5 against 1.808; PERF.md).
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

// The thread layout's scan (dp_kernel's, after its guards) of signal b from
// its first sample: its arena and clip bounds in the workspace, interleaved
// by signal (slot k at [k * S + b]), lo in rows 0..n-1 of lohi and hi in
// rows n..2n-1; writes x.  The float64 layouts run it again for a signal
// whose ring overflowed (dp_kernel keeps its own copy of these lines, so
// that its float32 machine code stays as it was).
template <class T>
__device__ __forceinline__ void dp_thread_scan(
    const T* __restrict__ yb, const LamT<T>& lam, T* __restrict__ xb,
    T* __restrict__ plam, int* __restrict__ pslope, T* __restrict__ lohi,
    int b, int B, int n) {
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

// ---- The float64 layouts --------------------------------------------------
//
// Both keep each signal's deque in a ring of kRing64 slots in shared memory
// (slot k at place k mod kRing64, a breakpoint as a double and its slope
// as an int32) with the deque's front and back in registers, and write the
// clip bounds to the workspace's lohi (interleaved by signal, as the thread
// layout's): no forward step reads them.  The live slots are L - 1 .. R
// (the slope below the front is written ahead of the front), and a sample
// adds at most two, so while R - L + 4 <= kRing64 at a sample's start no
// place holds two live slots; a signal that would hold more is marked,
// and after the chain it runs again from its first sample by the thread
// layout's scan (dp_thread_scan, its arena in the workspace), counted in
// *reruns.  The plain version's deques hold 8 breakpoints at most on
// randn signals of n = 1000 at lam 0.7, 13 at lam 50, 55 on a ramp of 1000
// (tools/dp_depths.py).

// The ring's slots a signal.
constexpr int kRing64 = 64;
// A batch of more than this many signals runs one signal a lane, K signals
// a warp, the smallest K of 4, 8, 16, 32 that keeps about kLaneWarpsSM
// warps an SM; up to it, one warp a signal (set by timing on an H100,
// tools/time_direct.py --layouts at n = 1000: one warp a signal 0.6387 ms
// and 4 a warp 0.7470 at 2112 signals, 0.8768 and 0.8273 at 3168; at 10000
// 4, 8, 16 a warp 1.7124 / 1.1231 / 1.2689 ms, 19, 9.5, 4.7 warps an SM).
constexpr int kWarp64MaxB = 2640;
constexpr int kLaneWarpsSM = 12;

// x / d for a whole d from 1 to 2^31 (a slope, the samples a breakpoint
// has aged), as IEEE division: d = 1 gives x itself; otherwise
// direct1d.cuh div_exact (bit for bit with IEEE division,
// tools/check_div_whole.py --dtype float64).  Two at once: both
// reciprocals and both quotients in straight code, one branch for a
// numerator outside div_exact's range.
__device__ __forceinline__ void div_count2(double x1, int d1, double x2,
                                           int d2, double& q1, double& q2) {
  const direct1d::RecipX r1 = direct1d::recip_exact((double)d1);
  const direct1d::RecipX r2 = direct1d::recip_exact((double)d2);
  double v1 = direct1d::div_exact_fast(x1, r1);
  double v2 = direct1d::div_exact_fast(x2, r2);
  if (__builtin_expect(
          !(direct1d::div_exact_ok(x1) && direct1d::div_exact_ok(x2)), 0)) {
    v1 = __ddiv_rn(x1, (double)d1);
    v2 = __ddiv_rn(x2, (double)d2);
  }
  q1 = d1 == 1 ? x1 : v1;
  q2 = d2 == 1 ? x2 : v2;
}
__device__ __forceinline__ double div_count(double x, int d) {
  const double v = direct1d::div_exact(x, direct1d::recip_exact((double)d));
  return d == 1 ? x : v;
}

// One sample of the float64 scan, the plain version's operations and
// roundings, for a deque held in a ring: fv, fs (the front's breakpoint
// and slope), fb (the slope of the slot below the front) and bv (the
// back's breakpoint) in registers, the ring read by RV / RS and written by
// SV / SS (place k mod kRing64).  bi, wp, w: this sample's value and the
// weights before and after it.  Sets lo and hi (the clip bounds of sample
// i) and returns false, or, at the last sample, sets last and returns
// true.  The order of the operations that make each value is the plain
// version's; their schedule is not: each pop's next slot is read a pop
// ahead, the back's pops run before the front's new breakpoint is divided
// out (they read it only when they pop every other breakpoint, and then
// it is made there), and the two divisions run side by side.
template <class RV, class RS, class SV, class SS>
__device__ __forceinline__ bool dp_ring_step(
    int i, int n, int& L, int& R, int A, double& fv, int& fs, int& fb,
    double& bv, double bi, double wp, double w, double& lo, double& hi,
    double& last, RV rv, RS rs, SV sv, SS ss) {
  // INIT
  double mmin = -wp + fv - bi;
  double mmax = wp + bv - bi;
  double nxv = rv(L + 1);  // the slot a front pop reaches (L < R)
  int nxs = rs(L + 1);
  int slope = 1;
  // LOWER: pop from the front while the message is below -w.
  while (mmin < -w) {
    slope = fs + A;
    fb = fs;
    L += 1;
    if (L > R) break;
    const double nv = nxv;
    fs = nxs;
    nxv = rv(L + 1);  // past R: not read
    nxs = rs(L + 1);
    mmin = add_rn(mmin, mul_rn(nv - fv, (double)slope));
    fv = nv;
  }
  // LOWER_EXIT (fv is the front after the pops, or the back when every
  // breakpoint popped)
  if (i == n - 1) {
    last = fv - mmin / (double)slope;
    return true;
  }
  L -= 1;
  fs = fb;  // the new front's slope: the last popped slot's, or the one below
  ss(L - 1, -A);
  fb = -A;
  if (L == R) {  // the ends meet: both bounds from one breakpoint
    const double p = bv;
    const double hm = p - (mmax - w), lm = p - (mmax + w);
    R += 1;
    ss(R, -A);
    sv(R, hm);
    sv(L, lm);
    fv = lm;
    bv = hm;
    lo = lm;
    hi = hm;
    return false;
  }
  // The new front's breakpoint: lon = fv - xl / sl, made below.
  const double xl = w + mmin, fn = fv;
  const int sl = slope;
  double lon = 0.0;
  bool made = false;
  double pbv = rv(R - 1);  // the slot a back pop reaches (the new front's
  int pbs = rs(R - 1);     // place when R - 1 == L: its slope is there)
  slope = 1;
  // UPPER: pop from the back while the message is above w.
  while (mmax > w) {
    R -= 1;
    slope = pbs + A;
    double nb = pbv;
    if (R == L) {  // every other breakpoint popped: the new front
      lon = fn - div_count(xl, sl);
      made = true;
      nb = lon;
    }
    pbv = rv(R - 1);  // below L: not read
    pbs = rs(R - 1);
    mmax = sub_rn(mmax, mul_rn(bv - nb, (double)slope));
    bv = nb;
    if (R == L) break;
  }
  // LOWER_EXIT's breakpoint and UPPER_EXIT's
  R += 1;
  const double xu = w - mmax;
  double ql, qu;
  div_count2(xl, sl, xu, slope, ql, qu);
  if (!made) lon = fn - ql;
  sv(L, lon);
  fv = lon;
  lo = lon;
  const double hu = bv + qu;
  ss(R, -A);
  sv(R, hu);
  bv = hu;
  hi = hu;
  return false;
}

// One warp a signal (B <= kWarp64MaxB): all 32 lanes run the chain
// redundantly with the ring of one signal in shared memory (768 bytes a
// warp); y and the weights stream through registers 32 samples at a time
// (lane k holds sample c + k), read by shuffles, as in float32; lane k
// keeps the bounds of sample c + k and the warp stores each 32 at once;
// the backward pass reads them back 32 a round and runs its clip chain
// over shuffles.
template <bool kEdge>
__global__ void __launch_bounds__(32 * direct1d::kMaxWarps)
dp_warp64_kernel(const double* __restrict__ y, LamT<double> lam,
                 double* __restrict__ x, double* __restrict__ plam,
                 int* __restrict__ pslope, double* __restrict__ lohi,
                 int* __restrict__ reruns, int B, int n) {
  __shared__ double ring_v[direct1d::kMaxWarps][kRing64];
  __shared__ int ring_s[direct1d::kMaxWarps][kRing64];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp
  const double* __restrict__ yb = y + (size_t)b * n;
  double* __restrict__ xb = x + (size_t)b * n;
  const double lc = kEdge ? 0.0 : lam(b, 0);
  auto W = [&](int i) { return kEdge ? lam(b, i) : lc; };
  if (direct1d::warp_degenerate([&](int i) { return __ldg(yb + i); }, W, n,
                                xb, lane))
    return;
  double* rvs = ring_v[warp];
  int* rss = ring_s[warp];
  constexpr int M = kRing64 - 1;
  auto rv = [&](int k) { return rvs[k & M]; };
  auto rs = [&](int k) { return rss[k & M]; };
  auto sv = [&](int k, double v) { rvs[k & M] = v; };
  auto ss = [&](int k, int v) { rss[k & M] = v; };
  auto y_chunk = [&](int c) {
    const int k = c + lane;
    return k < n ? __ldg(yb + k) : 0.0;
  };
  auto w_chunk = [&](int c) {
    const int k = c + lane;
    return kEdge && k < n - 1 ? lam(b, k) : 0.0;
  };
  const size_t S = (size_t)B;
  // Lane k's bounds of sample c + k go out at the end of each 32.
  auto flush = [&](int c, double mlo, double mhi) {
    const int k = c + lane;
    if (k < n - 1) {
      lohi[(size_t)k * S + b] = mlo;
      lohi[((size_t)n + k) * S + b] = mhi;
    }
  };

  // The message at node 0 (reference :152-156).
  int L = n - 1, R = n;
  const double w0 = W(0), y0 = __ldg(yb);
  const double lo0 = -w0 + y0, hi0 = w0 + y0;
  ss(L - 1, -1);
  sv(L, lo0);
  ss(L, 0);
  sv(R, hi0);
  ss(R, -1);
  double fv = lo0, bv = hi0;
  int fs = 0, fb = -1;
  double mlo = lo0, mhi = hi0;  // lane 0 holds sample 0
  int A = 1;
  bool over = false;
  double last = 0.0, w_prev = w0;
  double y_cur = y_chunk(0), w_cur = w_chunk(0);
  double y_next = y_chunk(32), w_next = w_chunk(32);
  for (int i = 1;; ++i) {
    if ((i & 31) == 0) {
      flush(i - 32, mlo, mhi);
      y_cur = y_next;
      w_cur = w_next;
      y_next = y_chunk(i + 32);
      w_next = w_chunk(i + 32);
    }
    A += 1;
    over |= R - L + 4 > kRing64;
    const double wi = kEdge ? __shfl_sync(direct1d::kFull, w_cur, i & 31)
                            : lc;
    const double w = i < n - 1 ? wi : 0.0;
    const double wp = w_prev;
    w_prev = w;
    const double bi = __shfl_sync(direct1d::kFull, y_cur, i & 31);
    double lo, hi;
    if (dp_ring_step(i, n, L, R, A, fv, fs, fb, bv, bi, wp, w, lo, hi, last,
                     rv, rs, sv, ss))
      break;
    if (lane == (i & 31)) {
      mlo = lo;
      mhi = hi;
    }
  }
  if (over) {  // the ring overflowed: again from the workspace, on lane 0
    if (lane == 0) {
      dp_thread_scan(yb, lam, xb, plam, pslope, lohi, b, B, n);
      if (reruns) atomicAdd(reruns, 1);
    }
    return;
  }
  flush((n - 1) & ~31, mlo, mhi);
  __syncwarp();
  // Backward clamping pass (reference :216-221), 32 samples a round from
  // the top: lane k loads the bounds of sample c + k a round ahead, the
  // chain takes them by shuffles (a whole round unrolled, so that they do
  // not wait on it), lane k keeps sample c + k and the round stores them.
  auto bound = [&](int k, size_t row) {
    return k >= 0 && k < n - 1 ? lohi[(row + k) * S + b] : 0.0;
  };
  double xv = last, mine = 0.0;
  int c = (n - 1) & ~31;
  double nl = bound(c + lane, 0), nh = bound(c + lane, n);
  for (; c >= 0; c -= 32) {
    const double bl = nl, bh = nh;
    nl = bound(c - 32 + lane, 0);
    nh = bound(c - 32 + lane, n);
    if (c + 31 < n - 1) {
#pragma unroll
      for (int t = 31; t >= 0; --t) {
        xv = vmin(vmax(xv, __shfl_sync(direct1d::kFull, bl, t)),
                  __shfl_sync(direct1d::kFull, bh, t));
        mine = lane == t ? xv : mine;
      }
    } else {
      for (int j = min(c + 31, n - 1); j >= c; --j) {
        if (j < n - 1)
          xv = vmin(vmax(xv, __shfl_sync(direct1d::kFull, bl, j - c)),
                    __shfl_sync(direct1d::kFull, bh, j - c));
        if (lane == j - c) mine = xv;
      }
    }
    if (c + lane < n) xb[c + lane] = mine;
  }
}

// One signal a lane (B > kWarp64MaxB): a warp runs K signals in lock step,
// sample after sample, each lane's own chain (only the pop loops differ in
// length).  The rings are interleaved by signal (place k of signal s at
// [k * K + s]), so the signals' slots fall in distinct banks; y and the
// weights are read three samples ahead into registers (each lane's 32-byte
// sector serves four samples from L1); the bounds go out at [i * B + b],
// K signals' in one store, and the backward pass reads them back so; x
// goes out through a transposed K x 32 tile, K rows of 32 samples a round.
// One warp a block, so a batch spreads over every SM; its shared memory,
// K (12 kRing64 + 264) bytes, lets 25 blocks share an SM at K = 8.
template <bool kEdge>
__global__ void __launch_bounds__(32)
dp_lane64_kernel(const double* __restrict__ y, LamT<double> lam,
                 double* __restrict__ x, double* __restrict__ plam,
                 int* __restrict__ pslope, double* __restrict__ lohi,
                 int* __restrict__ reruns, int B, int n, int K) {
  // K signals a warp: lane l runs signal b0 + l mod K (lanes K and up
  // repeat lanes 0 .. K - 1, so they part from them nowhere, and share
  // their ring and tile row: the same values to the same places).
  extern __shared__ __align__(16) double lane_smem[];
  double* ring_v = lane_smem;                                // C x K
  double* tile = ring_v + kRing64 * K;                       // K x 33
  int* ring_s = reinterpret_cast<int*>(tile + 33 * K);       // C x K
  const int lane = threadIdx.x;
  const int me = lane % K;
  const int b0 = blockIdx.x * K;
  const int b = b0 + me;
  const bool live = lane < K && b < B;
  const int bb = b < B ? b : B - 1;  // past the batch: row B - 1 again
  const int rows = min(K, B - b0);
  // The guards, row after row over the whole warp (coalesced reads); a
  // degenerate row is written here.
  bool deg = false;
  for (int r = 0; r < rows; ++r) {
    const int br = b0 + r;
    const double* __restrict__ yr = y + (size_t)br * n;
    const double lr = kEdge ? 0.0 : lam(br, 0);
    const bool d = direct1d::warp_degenerate(
        [&](int i) { return __ldg(yr + i); },
        [&](int i) { return kEdge ? lam(br, i) : lr; }, n,
        x + (size_t)br * n, lane);
    if (lane == r) deg = d;
  }
  const double* __restrict__ yb = y + (size_t)bb * n;
  const double lc = kEdge ? 0.0 : lam(bb, 0);
  auto W = [&](int i) { return kEdge ? lam(bb, i) : lc; };
  constexpr int M = kRing64 - 1;
  auto rv = [&](int k) { return ring_v[(k & M) * K + me]; };
  auto rs = [&](int k) { return ring_s[(k & M) * K + me]; };
  auto sv = [&](int k, double v) { ring_v[(k & M) * K + me] = v; };
  auto ss = [&](int k, int v) { ring_s[(k & M) * K + me] = v; };
  const size_t S = (size_t)B;

  // The message at node 0 (reference :152-156).
  int L = n - 1, R = n;
  const double w0 = W(0), y0 = __ldg(yb);
  const double lo0 = -w0 + y0, hi0 = w0 + y0;
  ss(L - 1, -1);
  sv(L, lo0);
  ss(L, 0);
  sv(R, hi0);
  ss(R, -1);
  if (live) {
    lohi[b] = lo0;
    lohi[(size_t)n * S + b] = hi0;
  }
  double fv = lo0, bv = hi0;
  int fs = 0, fb = -1;
  int A = 1;
  bool over = false;
  double last = 0.0, w_prev = w0;
  // y and the weights three samples ahead (a weight past n - 2 is 0).
  auto yat = [&](int k) { return k < n ? __ldg(yb + k) : 0.0; };
  auto wat = [&](int k) { return k < n - 1 ? W(k) : 0.0; };
  double y1 = yat(1), y2 = yat(2), y3 = yat(3);
  double w1 = wat(1), w2 = wat(2), w3 = wat(3);
  for (int i = 1;; ++i) {
    const double bi = y1, w = w1;
    y1 = y2;
    y2 = y3;
    y3 = yat(i + 3);
    if (kEdge) {
      w1 = w2;
      w2 = w3;
      w3 = wat(i + 3);
    } else {
      w1 = i + 1 < n - 1 ? lc : 0.0;
    }
    A += 1;
    over |= R - L + 4 > kRing64;
    const double wp = w_prev;
    w_prev = w;
    double lo, hi;
    if (dp_ring_step(i, n, L, R, A, fv, fs, fb, bv, bi, wp, w, lo, hi, last,
                     rv, rs, sv, ss))
      break;
    if (live) {
      lohi[(size_t)i * S + b] = lo;
      lohi[((size_t)n + i) * S + b] = hi;
    }
  }
  __syncwarp();
  // Backward clamping pass (reference :216-221), each lane its own chain,
  // 32 samples a round into the tile, whose rows then go out whole.
  // A round below the top sample loads its 32 bounds first, 16 at a time,
  // so that their reads are in flight together.
  const bool own = live && !deg && !over;  // rows this pass writes
  const unsigned write = __ballot_sync(direct1d::kFull, own);
  const double* __restrict__ blo = lohi + bb;
  const double* __restrict__ bhi = lohi + (size_t)n * S + bb;
  double xv = last;
  for (int c = (n - 1) & ~31; c >= 0; c -= 32) {
    const int top = min(c + 31, n - 1);
    if (top < n - 1) {
#pragma unroll
      for (int h = 16; h >= 0; h -= 16) {
        double bl[16], bh[16];
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          bl[t] = blo[(size_t)(c + h + t) * S];
          bh[t] = bhi[(size_t)(c + h + t) * S];
        }
#pragma unroll
        for (int t = 15; t >= 0; --t) {
          xv = vmin(vmax(xv, bl[t]), bh[t]);
          tile[me * 33 + h + t] = xv;
        }
      }
    } else {
      for (int j = top; j >= c; --j) {
        if (j < n - 1) xv = vmin(vmax(xv, blo[(size_t)j * S]),
                                 bhi[(size_t)j * S]);
        tile[me * 33 + (j - c)] = xv;
      }
    }
    __syncwarp();
    for (int r = 0; r < rows; ++r)
      if (((write >> r) & 1u) && c + lane <= top)
        x[(size_t)(b0 + r) * n + c + lane] = tile[r * 33 + lane];
    __syncwarp();
  }
  if (live && !deg && over) {  // the ring overflowed: again from the workspace
    dp_thread_scan(yb, lam, x + (size_t)b * n, plam, pslope, lohi, b, B, n);
    if (reruns) atomicAdd(reruns, 1);
  }
}

// The card's SMs, or a negative CUDA error.
int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  return sms;
}

// The float64 layout of a batch of B signals: 1 one warp a signal; one
// signal a lane with 4, 8, 16 or 32 signals a warp, 6, 5, 4 or 2 (run64);
// a negative CUDA error.
int layout64(int B) {
  if (B <= kWarp64MaxB) return 1;
  const int sms = sm_count();
  if (sms < 0) return sms;
  const long long per_k = (long long)sms * kLaneWarpsSM;
  return B <= 4 * per_k ? 6 : B <= 8 * per_k ? 5 : B <= 16 * per_k ? 4 : 2;
}

// layout: 0 the rule's (layout64), 1 one warp a signal, 2 one signal a
// lane with 32 signals a warp (4: 16 a warp, 5: 8, 6: 4).
int run64(const double* y, const double* lam, int lam_rs, int lam_cs,
          double lam_s, double* x, double* plam, int* pslope, double* lohi,
          int* reruns, int B, int n, int layout, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (!plam || !pslope || !lohi)
    return static_cast<int>(cudaErrorInvalidValue);
  const LamT<double> l{lam, (size_t)lam_rs, (size_t)lam_cs, lam_s};
  if (layout == 0) layout = layout64(B);
  if (layout < 0) return -layout;
  if (layout == 1) {
    // As many warps a block as spread the batch over every SM, at most 8.
    const int sms = sm_count();
    if (sms < 0) return -sms;
    const int spread = (B + sms - 1) / sms;
    const int w = spread < direct1d::kMaxWarps ? spread : direct1d::kMaxWarps;
    const int blocks = (B + w - 1) / w;
    if (l.per_edge())
      dp_warp64_kernel<true><<<blocks, 32 * w, 0, stream>>>(
          y, l, x, plam, pslope, lohi, reruns, B, n);
    else
      dp_warp64_kernel<false><<<blocks, 32 * w, 0, stream>>>(
          y, l, x, plam, pslope, lohi, reruns, B, n);
  } else if (layout == 2 || (layout >= 4 && layout <= 6)) {
    const int K = layout == 2 ? 32 : layout == 4 ? 16 : layout == 5 ? 8 : 4;
    const int blocks = (B + K - 1) / K;
    const size_t smem = (size_t)K * (kRing64 * 12 + 33 * 8);
    if (l.per_edge())
      dp_lane64_kernel<true><<<blocks, 32, smem, stream>>>(
          y, l, x, plam, pslope, lohi, reruns, B, n, K);
    else
      dp_lane64_kernel<false><<<blocks, 32, smem, stream>>>(
          y, l, x, plam, pslope, lohi, reruns, B, n, K);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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

// The same in float64: y, x, the weights, plam and lohi double; the
// workspace is needed at every B (a signal whose ring overflows runs again
// from it), and reruns (or NULL) counts those signals (an int32 on the
// card, added to).
extern "C" int dp_tv1_f64(const double* y, const double* lam, int lam_rs,
                          int lam_cs, double lam_s, double* x, double* plam,
                          int* pslope, double* lohi, int* reruns, int B,
                          int n, cudaStream_t stream) {
  return run64(y, lam, lam_rs, lam_cs, lam_s, x, plam, pslope, lohi, reruns,
               B, n, 0, stream);
}

// The same on a given layout (1 one warp a signal, 2 one signal a lane
// with 32 a warp, 4 with 16, 5 with 8, 6 with 4), for the tools and tests
// that time or hold each.
extern "C" int dp_tv1_f64_layout(const double* y, const double* lam,
                                 int lam_rs, int lam_cs, double lam_s,
                                 double* x, double* plam, int* pslope,
                                 double* lohi, int* reruns, int B, int n,
                                 int layout, cudaStream_t stream) {
  if (layout < 1 || layout == 3 || layout > 6)
    return static_cast<int>(cudaErrorInvalidValue);
  return run64(y, lam, lam_rs, lam_cs, lam_s, x, plam, pslope, lohi, reruns,
               B, n, layout, stream);
}

// 1 when dp_tv1 runs a (B, n) batch (per_edge: one weight an edge) on the
// warp layout and needs no workspace, 0 on the thread layout, a negative
// CUDA error.
extern "C" int dp_warp_layout(int B, int n, int per_edge) {
  direct1d::WarpPlan p;
  return warp_layout<float>(B, n, per_edge != 0, &p);
}
// The layout dp_tv1_f64 runs a batch of B signals on (at any n), as
// dp_tv1_f64_layout numbers them.
extern "C" int dp_layout_f64(int B) { return layout64(B); }

// The longest signal of the float32 warp layout (a batch of more than four
// waves takes the thread layout at any n); the float64 ring's slots and the
// largest batch of its warp layout.
extern "C" int dp_warp_max_n() { return kWarpMaxN<float>; }
extern "C" int dp_ring_slots_f64() { return kRing64; }
extern "C" int dp_warp_max_b_f64() { return kWarp64MaxB; }
