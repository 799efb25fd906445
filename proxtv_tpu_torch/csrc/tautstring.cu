// Kernel D1: batched weighted linearized taut string (TV-L1 prox), written
// by hand for Hopper (sm_90a).
//
// No TPU kernel: it replaces the JAX package's XLA lock-step scan
// proxtv_tpu/ops/tv1d_l1.py:tv1_tautstring (one event per lane per
// while_loop step, with a device-to-host check of the loop condition on
// each), the same function on the card's own terms.  Its events are those
// of that scan's body, in the order of the sequential scan it was made
// from (native/tv1d_host.cpp taut_string; proxTV src/TVL1Wopt.cpp:364):
// at each point the tube heights mnH/mxH advance by the current segment's
// bounds mn/mx; a violated wall closes the segment at its last touch and
// restarts right after it (a backtrack); otherwise the touched walls
// tighten mn/mx.  The end point compares with kEps, as the JAX scan does.
// Every operation is the plain version's (tv1_tautstring_plain) in the
// same order and rounding, and none can contract into an FMA, so the two
// agree bit for bit away from the degenerate guards.  The kernel is
// written for the signal's type T and built for float (tautstring_tv1)
// and double (tautstring_tv1_f64, the float64 route of tv1_batched).
//
// What bounds it on this card: the function reads y (and the weights) once
// and writes x once, ~8 bytes an element in float32 (16 in float64):
// 10000 x 1000 is 80 MB, 24 us at 3.35 TB/s.  The scan is a chain of
// dependent events (about n to 2n a signal, a backtrack re-reads earlier
// points), so a signal is latency: its chain at the latency of the memory
// its events read.
//
// Design, two layouts by n (direct1d.cuh):
// * n <= kWarpMaxN (16384 in float32, 8192 in float64), one warp a
//   signal.  The warp stages y (and a per-edge weight row) into shared
//   memory with 16-byte loads, takes the guards by warp reductions, and
//   its 32 lanes run the event chain redundantly out of shared memory:
//   every branch is uniform, so the divergence between signals that one
//   thread a signal suffers inside a warp is gone, and an event waits on
//   shared memory, not on L1.  A closed segment is written to the output
//   by the lanes, 32 elements a store.
// * n > kWarpMaxN, one thread a signal, y and the weights read from global
//   memory; each closed segment is written straight to the output.
//
// Float64 has layouts of its own (below).
#include <cuda_runtime.h>

#include "direct1d.cuh"

namespace {

using direct1d::LamT;

// The longest signal of the warp layout: at 16384 a per-edge float32
// signal stages 128 KB (y and its weights), and at 8192 a float64 one;
// auto's taut string on the card ends at 16384 (past it the long-signal
// route runs).
template <class T>
constexpr int kWarpMaxN = sizeof(T) == 4 ? 16384 : 8192;

// The warp layout's dynamic shared memory, typed (one array a type).
template <class T>
__device__ __forceinline__ T* dyn_smem();
template <>
__device__ __forceinline__ float* dyn_smem<float>() {
  extern __shared__ float smem_f[];
  return smem_f;
}
template <>
__device__ __forceinline__ double* dyn_smem<double>() {
  extern __shared__ double smem_d[];
  return smem_d;
}

template <class T, bool kEdge>
__global__ void __launch_bounds__(32 * direct1d::kMaxWarps)
tautstring_warp_kernel(const T* __restrict__ y, LamT<T> lam,
                       T* __restrict__ x, int B, int n) {
  T* smem = dyn_smem<T>();
  constexpr T kEps = direct1d::kEps<T>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp
  T* ys = smem + (size_t)warp * (kEdge ? 2 * n - 1 : n);
  T* ls = ys + n;  // per-edge weights (kEdge)
  T* __restrict__ xb = x + (size_t)b * n;
  direct1d::stage_row(y + (size_t)b * n, n, ys, lane);
  if (kEdge) direct1d::stage_lam(lam, b, n - 1, ls, lane);
  __syncwarp();
  const T lc = kEdge ? T(0) : lam(b, 0);  // one weight a signal
  auto W = [&](int i) { return kEdge ? ls[i] : lc; };
  if (direct1d::warp_degenerate([&](int i) { return ys[i]; }, W, n, xb,
                                lane))
    return;

  const T l0 = W(0);
  T mn = ys[0] - l0, mx = ys[0] + l0;  // segment value bounds
  T mnH = T(0), mxH = T(0);  // tube heights of the two bounds
  int mnB = 0, mxB = 0;        // last touches of the walls
  int last = -1;               // end of the last closed segment
  int i = 0;
  while (i < n) {
    const bool is_last = i == n - 1;
    const T yi = ys[i];
    const T li = W(min(i, n - 2));
    const T mnH1 = mnH + mn - yi;
    const T mxH1 = mxH + mx - yi;
    const bool ceil_v = is_last ? mnH1 > kEps : li < mnH1;
    const bool floor_v = !ceil_v && (is_last ? mxH1 < -kEps : -li > mxH1);
    if (ceil_v || floor_v) {
      // Close the segment at the pinned wall and restart after it.
      const int b_end = ceil_v ? mnB : mxB;
      const T b_val = ceil_v ? mn : mx;
      for (int k = last + 1 + lane; k <= b_end; k += 32) xb[k] = b_val;
      const int j = b_end + 1;
      if (j >= n) return;  // a re-break at the restarted end point
      const T yj = ys[j];
      const T lp = W(j - 1);
      const T ln = (is_last && j == n - 1) ? T(0) : W(min(j, n - 2));
      const T base = ceil_v ? yj + lp : yj - lp;
      mn = base - ln;
      mx = base + ln;
      if (is_last) {
        mnH = mxH = ceil_v ? -lp : lp;
      } else {
        mnH = -ln;
        mxH = ln;
      }
      mnB = mxB = j;
      last = b_end;
      i = is_last ? j : j + 1;
      continue;
    }
    const T denom = (T)(i - last);
    if (is_last) {
      // Tie the string to the end point and close the last segment.
      const T v = mnH1 <= T(0) ? mn + (-mnH1) / denom : mn;
      for (int k = last + 1 + lane; k < n; k += 32) xb[k] = v;
      return;
    }
    if (mxH1 >= li) {
      mx = mx + (li - mxH1) / denom;
      mxH = li;
      mxB = i;
    } else {
      mxH = mxH1;
    }
    if (mnH1 <= -li) {
      mn = mn + (-li - mnH1) / denom;
      mnH = -li;
      mnB = i;
    } else {
      mnH = mnH1;
    }
    ++i;
  }
}

template <class T, bool kEdge>
cudaError_t launch_warp(const T* y, const LamT<T>& l, T* x, int B, int n,
                        cudaStream_t stream) {
  auto kernel = tautstring_warp_kernel<T, kEdge>;
  const size_t per_warp = sizeof(T) * (kEdge ? 2 * (size_t)n - 1 : n);
  direct1d::WarpPlan p;
  const cudaError_t e = direct1d::warp_plan(kernel, per_warp, B, &p);
  if (e != cudaSuccess) return e;
  kernel<<<p.blocks, 32 * p.warps, p.smem, stream>>>(y, l, x, B, n);
  return cudaGetLastError();
}

// ---- The float64 layouts --------------------------------------------------
//
// G lanes a signal, 32 / G signals a warp.  G = 32 stages y (and the
// weight row) in shared memory as the float32 warp layout does: one warp
// a signal, for single signals and batches below kGroup64MinB.  Shared
// memory caps that layout at 28 signals an SM at n = 1000, and past 16 an
// SM the resident warps queue for issue slots, each spending 32 lanes on
// one chain (tools/time_direct.py: 0.285 ms a launch from 1 to 4 signals an
// SM, 0.449 at 24, 1.289 for 10000 signals in three waves).  A larger batch
// runs G = kGroup64 lanes a signal, 32 / kGroup64 chains advancing with
// each issued instruction, and reads y and the weights from global memory
// through L1 (the next sample read an event ahead) instead of staging them,
// so that every signal of the batch is resident at once, and takes an
// advance's wall touches by selects.  Both divide by i - last through
// direct1d.cuh div_exact, the reciprocal made at the start of each event,
// apart from the chain.

// The lanes a signal of the layout for large batches and its smallest
// batch, where it overtakes the staged layout's second wave (one wave
// holds 28 signals an SM at n = 1000; tools/time_direct.py --layouts on an
// H100 at n = 1000: 32 lanes 0.3225 ms and 8 lanes 0.4302 at 2112 signals,
// 0.5135 and 0.5563 at 3696, 0.6589 and 0.5918 at 4224, 1.2549 and 0.7606
// at 10000).
constexpr int kGroup64 = 8;
constexpr int kGroup64MinB = 3960;

// A group of G lanes copies count doubles to shared memory: 16-byte loads
// over the aligned body, 8-byte loads at the ragged ends.
template <int G>
__device__ __forceinline__ void stage_row_g(const double* __restrict__ src,
                                            int count, double* dst, int lg) {
  int head = (int)((16u - ((uintptr_t)src & 15u)) & 15u) >> 3;
  if (head > count) head = count;
  if (lg < head) dst[lg] = __ldg(src + lg);
  const int nv = (count - head) >> 1;
  const double2* __restrict__ s2 =
      reinterpret_cast<const double2*>(src + head);
  double* d = dst + head;
  for (int v = lg; v < nv; v += G) {
    const double2 q = __ldg(s2 + v);
    d[2 * v] = q.x;
    d[2 * v + 1] = q.y;
  }
  for (int k = head + 2 * nv + lg; k < count; k += G) dst[k] = __ldg(src + k);
}

// direct1d::warp_degenerate for a group of G lanes (mask gm): the same
// tests, the lanes over strided samples, combined by shuffles inside the
// group.
template <int G, class YF, class LF>
__device__ __forceinline__ bool group_degenerate(YF yv, LF lv, int n,
                                                 double* __restrict__ xb,
                                                 int lg, unsigned gm) {
  double sum = 0.0, dymax = 0.0, lmin = INFINITY;
  bool nonzero = false;
  for (int i = lg; i < n; i += G) {
    const double yi = yv(i);
    sum += yi;
    if (i + 1 < n) {
      dymax = fmax(dymax, fabs(yv(i + 1) - yi));
      const double l = lv(i);
      lmin = fmin(lmin, l);
      nonzero = nonzero || !(l <= 0.0);
    }
  }
  if (!__any_sync(gm, nonzero)) {
    for (int i = lg; i < n; i += G) xb[i] = yv(i);
    return true;
  }
  for (int o = G / 2; o; o >>= 1) {
    sum += __shfl_xor_sync(gm, sum, o);
    dymax = fmax(dymax, __shfl_xor_sync(gm, dymax, o));
    lmin = fmin(lmin, __shfl_xor_sync(gm, lmin, o));
  }
  if (lmin >= (double)n * (double)n * dymax) {
    const double m = sum / n;
    for (int i = lg; i < n; i += G) xb[i] = m;
    return true;
  }
  return false;
}

template <int G, bool kEdge>
__global__ void __launch_bounds__(32 * direct1d::kMaxWarps)
tautstring_group64_kernel(const double* __restrict__ y, LamT<double> lam,
                          double* __restrict__ x, int B, int n) {
  constexpr bool kStage = G == 32;  // one warp a signal stages y
  double* smem = dyn_smem<double>();
  constexpr double kEps = direct1d::kEps<double>;
  constexpr int K = 32 / G;  // signals a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / G, lg = lane % G;
  const unsigned gm = G == 32 ? direct1d::kFull
                              : ((1u << (G & 31)) - 1u) << (g * G);
  const int slot = warp * K + g;
  const int b = (blockIdx.x * (blockDim.x >> 5) + warp) * K + g;
  if (b >= B) return;  // the whole group
  double* yss = smem + (size_t)slot * (kStage ? (kEdge ? 2 * n - 1 : n) : 0);
  double* ls = yss + n;  // per-edge weights (kEdge)
  double* __restrict__ xb = x + (size_t)b * n;
  const double* __restrict__ yb = y + (size_t)b * n;
  if (kStage) {
    stage_row_g<G>(yb, n, yss, lg);
    if (kEdge) {
      const double* __restrict__ row = lam.p + (size_t)b * lam.rs;
      if (lam.cs == 1)
        stage_row_g<G>(row, n - 1, ls, lg);
      else
        for (int k = lg; k < n - 1; k += G)
          ls[k] = __ldg(row + (size_t)k * lam.cs);
    }
    __syncwarp(gm);
  }
  const double lc = kEdge ? 0.0 : lam(b, 0);  // one weight a signal
  auto W = [&](int i) {
    return kEdge ? (kStage ? ls[i] : lam(b, i)) : lc;
  };
  auto ys = [&](int i) { return kStage ? yss[i] : __ldg(yb + i); };
  if (group_degenerate<G>([&](int i) { return ys(i); }, W, n, xb, lg, gm))
    return;

  const double l0 = W(0);
  double mn = ys(0) - l0, mx = ys(0) + l0;  // segment value bounds
  double mnH = 0.0, mxH = 0.0;  // tube heights of the two bounds
  int mnB = 0, mxB = 0;         // last touches of the walls
  int last = -1;                // end of the last closed segment
  int i = 0;
  double yi = ys(0), li = l0;   // sample i and its weight W(min(i, n - 2))
  while (i < n) {
    // The next sample and weight read ahead, the reciprocal of i - last
    // made apart from the chain; a restart branches.
    const direct1d::RecipX q = direct1d::recip_exact((double)(i - last));
    const bool is_last = i == n - 1;
    const int i1 = min(i + 1, n - 1);
    const double y1 = ys(i1), l1 = W(min(i1, n - 2));
    const double mnH1 = mnH + mn - yi;
    const double mxH1 = mxH + mx - yi;
    const bool ceil_v = is_last ? mnH1 > kEps : li < mnH1;
    const bool floor_v = !ceil_v && (is_last ? mxH1 < -kEps : -li > mxH1);
    if (ceil_v || floor_v) {
      // Close the segment at the pinned wall and restart after it.
      const int b_end = ceil_v ? mnB : mxB;
      const double b_val = ceil_v ? mn : mx;
      for (int k = last + 1 + lg; k <= b_end; k += G) xb[k] = b_val;
      const int j = b_end + 1;
      if (j >= n) return;  // a re-break at the restarted end point
      const double yj = ys(j);
      const double lp = W(j - 1);
      const double ln = (is_last && j == n - 1) ? 0.0 : W(min(j, n - 2));
      const double base = ceil_v ? yj + lp : yj - lp;
      mn = base - ln;
      mx = base + ln;
      if (is_last) {
        mnH = mxH = ceil_v ? -lp : lp;
      } else {
        mnH = -ln;
        mxH = ln;
      }
      mnB = mxB = j;
      last = b_end;
      i = is_last ? j : j + 1;
      yi = ys(min(i, n - 1));
      li = W(min(i, n - 2));
      continue;
    }
    if (is_last) {
      // Tie the string to the end point and close the last segment.
      const double v = mnH1 <= 0.0 ? mn + direct1d::div_exact(-mnH1, q) : mn;
      for (int k = last + 1 + lg; k < n; k += G) xb[k] = v;
      return;
    }
    if constexpr (kStage) {
      // One signal a warp: a wall touch branches, uniformly, and divides
      // only where it is touched (fewer instructions where many warps
      // share an SM).
      if (mxH1 >= li) {
        mx = mx + direct1d::div_exact(li - mxH1, q);
        mxH = li;
        mxB = i;
      } else {
        mxH = mxH1;
      }
      if (mnH1 <= -li) {
        mn = mn + direct1d::div_exact(-li - mnH1, q);
        mnH = -li;
        mnB = i;
      } else {
        mnH = mnH1;
      }
    } else {
      // Several signals a warp: both walls' quotients, taken by selects,
      // so that the signals part only where one restarts.
      const bool tx = mxH1 >= li, tn = mnH1 <= -li;
      const double ax = li - mxH1, an = -li - mnH1;
      double dx = direct1d::div_exact_fast(ax, q);
      double dn = direct1d::div_exact_fast(an, q);
      if (__builtin_expect(
              !(direct1d::div_exact_ok(ax) && direct1d::div_exact_ok(an)),
              0)) {
        dx = __ddiv_rn(ax, q.d);
        dn = __ddiv_rn(an, q.d);
      }
      mx = tx ? mx + dx : mx;
      mxH = tx ? li : mxH1;
      mxB = tx ? i : mxB;
      mn = tn ? mn + dn : mn;
      mnH = tn ? -li : mnH1;
      mnB = tn ? i : mnB;
    }
    yi = y1;
    li = l1;
    ++i;
  }
}

// The float64 layout of a (B, n) batch: the lanes a signal (32 or
// kGroup64; past kWarpMaxN<double>, 0: the thread layout).
int group64(int B, int n) {
  if (n > kWarpMaxN<double>) return 0;
  return B >= kGroup64MinB ? kGroup64 : 32;
}

template <int G, bool kEdge>
cudaError_t launch_group64(const double* y, const LamT<double>& l, double* x,
                           int B, int n, cudaStream_t stream) {
  auto kernel = tautstring_group64_kernel<G, kEdge>;
  constexpr int K = 32 / G;
  const size_t per_warp =
      G == 32 ? sizeof(double) * (kEdge ? 2 * (size_t)n - 1 : n) : 0;
  direct1d::WarpPlan p;
  const cudaError_t e =
      direct1d::warp_plan(kernel, per_warp, (B + K - 1) / K, &p);
  if (e != cudaSuccess) return e;
  kernel<<<p.blocks, 32 * p.warps, p.smem, stream>>>(y, l, x, B, n);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_lanes64(const double* y, const LamT<double>& l, double* x,
                           int B, int n, cudaStream_t stream) {
  return l.per_edge() ? launch_group64<G, true>(y, l, x, B, n, stream)
                      : launch_group64<G, false>(y, l, x, B, n, stream);
}

template <class T>
__global__ void __launch_bounds__(64)
tautstring_kernel(const T* __restrict__ y, LamT<T> lam,
                  T* __restrict__ x, int B, int n) {
  constexpr T kEps = direct1d::kEps<T>;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T* __restrict__ yb = y + (size_t)b * n;
  T* __restrict__ xb = x + (size_t)b * n;
  if (direct1d::degenerate(yb, lam, b, n, xb)) return;

  const T l0 = lam(b, 0);
  T mn = __ldg(yb) - l0, mx = __ldg(yb) + l0;  // segment value bounds
  T mnH = T(0), mxH = T(0);  // tube heights of the two bounds
  int mnB = 0, mxB = 0;        // last touches of the walls
  int last = -1;               // end of the last closed segment
  int i = 0;
  while (i < n) {
    const bool is_last = i == n - 1;
    const T yi = __ldg(yb + i);
    const T li = lam(b, min(i, n - 2));
    const T mnH1 = mnH + mn - yi;
    const T mxH1 = mxH + mx - yi;
    const bool ceil_v = is_last ? mnH1 > kEps : li < mnH1;
    const bool floor_v = !ceil_v && (is_last ? mxH1 < -kEps : -li > mxH1);
    if (ceil_v || floor_v) {
      // Close the segment at the pinned wall and restart after it.
      const int b_end = ceil_v ? mnB : mxB;
      const T b_val = ceil_v ? mn : mx;
      for (int k = last + 1; k <= b_end; ++k) xb[k] = b_val;
      const int j = b_end + 1;
      if (j >= n) return;  // a re-break at the restarted end point
      const T yj = __ldg(yb + j);
      const T lp = lam(b, j - 1);
      const T ln = (is_last && j == n - 1) ? T(0) : lam(b, min(j, n - 2));
      const T base = ceil_v ? yj + lp : yj - lp;
      mn = base - ln;
      mx = base + ln;
      if (is_last) {
        mnH = mxH = ceil_v ? -lp : lp;
      } else {
        mnH = -ln;
        mxH = ln;
      }
      mnB = mxB = j;
      last = b_end;
      i = is_last ? j : j + 1;
      continue;
    }
    const T denom = (T)(i - last);
    if (is_last) {
      // Tie the string to the end point and close the last segment.
      const T v = mnH1 <= T(0) ? mn + (-mnH1) / denom : mn;
      for (int k = last + 1; k < n; ++k) xb[k] = v;
      return;
    }
    if (mxH1 >= li) {
      mx = mx + (li - mxH1) / denom;
      mxH = li;
      mxB = i;
    } else {
      mxH = mxH1;
    }
    if (mnH1 <= -li) {
      mn = mn + (-li - mnH1) / denom;
      mnH = -li;
      mnB = i;
    } else {
      mnH = mnH1;
    }
    ++i;
  }
}

// G: the lanes a signal of a float64 batch (0: the rule's, group64);
// float32 takes 0.
template <class T>
int run(const T* y, const T* lam, int lam_rs, int lam_cs, T lam_s, T* x,
        int B, int n, cudaStream_t stream, int G = 0) {
  if (B <= 0) return 0;
  const LamT<T> l{lam, (size_t)lam_rs, (size_t)lam_cs, lam_s};
  if constexpr (sizeof(T) == 8) {
    if (G == 0) G = group64(B, n);
    cudaError_t e = cudaErrorInvalidValue;
    switch (G) {
      case 32: e = launch_lanes64<32>(y, l, x, B, n, stream); break;
      case kGroup64: e = launch_lanes64<kGroup64>(y, l, x, B, n, stream); break;
      case 0:
        tautstring_kernel<T><<<(B + 63) / 64, 64, 0, stream>>>(y, l, x, B,
                                                               n);
        e = cudaGetLastError();
        break;
      default: break;
    }
    return static_cast<int>(e);
  }
  if (n <= kWarpMaxN<T>)
    return static_cast<int>(l.per_edge()
                                ? launch_warp<T, true>(y, l, x, B, n, stream)
                                : launch_warp<T, false>(y, l, x, B, n, stream));
  const int threads = 64;
  tautstring_kernel<T><<<(B + threads - 1) / threads, threads, 0, stream>>>(
      y, l, x, B, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y, x: (B, n) float32, row-major; lam: a strided (B, n-1) weight field
// (element strides lam_rs, lam_cs) or NULL for the scalar lam_s.  n >= 2
// (checked by the Python wrapper).
extern "C" int tautstring_tv1(const float* y, const float* lam, int lam_rs,
                              int lam_cs, float lam_s, float* x, int B, int n,
                              cudaStream_t stream) {
  return run<float>(y, lam, lam_rs, lam_cs, lam_s, x, B, n, stream);
}

// The same in float64: y, x and the weights double.
extern "C" int tautstring_tv1_f64(const double* y, const double* lam,
                                  int lam_rs, int lam_cs, double lam_s,
                                  double* x, int B, int n,
                                  cudaStream_t stream) {
  return run<double>(y, lam, lam_rs, lam_cs, lam_s, x, B, n, stream);
}

// The same in float64 with G lanes a signal (32 or kGroup64), for the
// tools and tests that time or hold each.
extern "C" int tautstring_tv1_f64_group(const double* y, const double* lam,
                                        int lam_rs, int lam_cs, double lam_s,
                                        double* x, int B, int n, int G,
                                        cudaStream_t stream) {
  if ((G != 32 && G != kGroup64) || n > kWarpMaxN<double>)
    return static_cast<int>(cudaErrorInvalidValue);
  return run<double>(y, lam, lam_rs, lam_cs, lam_s, x, B, n, stream, G);
}

// The longest signal the warp layout takes (the layouts' threshold), in
// float32 and in float64; the lanes a signal that tautstring_tv1_f64 gives
// a (B, n) batch (32: one warp a signal; 1: the thread layout).
extern "C" int tautstring_warp_max_n() { return kWarpMaxN<float>; }
extern "C" int tautstring_warp_max_n_f64() { return kWarpMaxN<double>; }
extern "C" int tautstring_group_f64(int B, int n) {
  const int G = group64(B, n);
  return G ? G : 1;
}
// The float64 layout for large batches: its lanes a signal and its
// smallest batch.
extern "C" int tautstring_group_lanes_f64() { return kGroup64; }
extern "C" int tautstring_group_min_b_f64() { return kGroup64MinB; }
