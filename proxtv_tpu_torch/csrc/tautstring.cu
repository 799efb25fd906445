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

template <class T>
int run(const T* y, const T* lam, int lam_rs, int lam_cs, T lam_s, T* x,
        int B, int n, cudaStream_t stream) {
  if (B <= 0) return 0;
  const LamT<T> l{lam, (size_t)lam_rs, (size_t)lam_cs, lam_s};
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

// The longest signal the warp layout takes (the layouts' threshold), in
// float32 and in float64.
extern "C" int tautstring_warp_max_n() { return kWarpMaxN<float>; }
extern "C" int tautstring_warp_max_n_f64() { return kWarpMaxN<double>; }
