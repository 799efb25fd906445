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
// same order and float32 rounding, and none can contract into an FMA, so
// the two agree bit for bit away from the degenerate guards.
//
// What bounds it on this card: the function reads y (and the weights) once
// and writes x once, ~8 bytes an element: 10000 x 1000 is 80 MB, 24 us at
// 3.35 TB/s.  The scan is a chain of dependent events (about n to 2n a
// signal, a backtrack re-reads earlier points), so a signal is latency:
// its chain at the latency of the memory its events read.
//
// Design, two layouts by n (direct1d.cuh):
// * n <= kWarpMaxN, one warp a signal.  The warp stages y (and a per-edge
//   weight row) into shared memory with 16-byte loads, takes the guards by
//   warp reductions, and its 32 lanes run the event chain redundantly out
//   of shared memory: every branch is uniform, so the divergence between
//   signals that one thread a signal suffers inside a warp is gone, and an
//   event waits on shared memory, not on L1.  A closed segment is written
//   to the output by the lanes, 32 elements a store.
// * n > kWarpMaxN, one thread a signal, y and the weights read from global
//   memory; each closed segment is written straight to the output.
#include <cuda_runtime.h>

#include "direct1d.cuh"

namespace {

using direct1d::kEps;
using direct1d::Lam;

// The longest signal of the warp layout: at 16384 a per-edge signal
// stages 128 KB (y and its weights); auto's taut string on the card ends
// there (past it the long-signal route runs).
constexpr int kWarpMaxN = 16384;

template <bool kEdge>
__global__ void __launch_bounds__(32 * direct1d::kMaxWarps)
tautstring_warp_kernel(const float* __restrict__ y, Lam lam,
                       float* __restrict__ x, int B, int n) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp
  float* ys = smem + (size_t)warp * (kEdge ? 2 * n - 1 : n);
  float* ls = ys + n;  // per-edge weights (kEdge)
  float* __restrict__ xb = x + (size_t)b * n;
  direct1d::stage_row(y + (size_t)b * n, n, ys, lane);
  if (kEdge) direct1d::stage_lam(lam, b, n - 1, ls, lane);
  __syncwarp();
  const float lc = kEdge ? 0.f : lam(b, 0);  // one weight a signal
  auto W = [&](int i) { return kEdge ? ls[i] : lc; };
  if (direct1d::warp_degenerate([&](int i) { return ys[i]; }, W, n, xb,
                                lane))
    return;

  const float l0 = W(0);
  float mn = ys[0] - l0, mx = ys[0] + l0;  // segment value bounds
  float mnH = 0.f, mxH = 0.f;  // tube heights of the two bounds
  int mnB = 0, mxB = 0;        // last touches of the walls
  int last = -1;               // end of the last closed segment
  int i = 0;
  while (i < n) {
    const bool is_last = i == n - 1;
    const float yi = ys[i];
    const float li = W(min(i, n - 2));
    const float mnH1 = mnH + mn - yi;
    const float mxH1 = mxH + mx - yi;
    const bool ceil_v = is_last ? mnH1 > kEps : li < mnH1;
    const bool floor_v = !ceil_v && (is_last ? mxH1 < -kEps : -li > mxH1);
    if (ceil_v || floor_v) {
      // Close the segment at the pinned wall and restart after it.
      const int b_end = ceil_v ? mnB : mxB;
      const float b_val = ceil_v ? mn : mx;
      for (int k = last + 1 + lane; k <= b_end; k += 32) xb[k] = b_val;
      const int j = b_end + 1;
      if (j >= n) return;  // a re-break at the restarted end point
      const float yj = ys[j];
      const float lp = W(j - 1);
      const float ln = (is_last && j == n - 1) ? 0.f : W(min(j, n - 2));
      const float base = ceil_v ? yj + lp : yj - lp;
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
    const float denom = (float)(i - last);
    if (is_last) {
      // Tie the string to the end point and close the last segment.
      const float v = mnH1 <= 0.f ? mn + (-mnH1) / denom : mn;
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

template <bool kEdge>
cudaError_t launch_warp(const float* y, const Lam& l, float* x, int B, int n,
                        cudaStream_t stream) {
  auto kernel = tautstring_warp_kernel<kEdge>;
  const size_t per_warp = sizeof(float) * (kEdge ? 2 * (size_t)n - 1 : n);
  direct1d::WarpPlan p;
  const cudaError_t e = direct1d::warp_plan(kernel, per_warp, B, &p);
  if (e != cudaSuccess) return e;
  kernel<<<p.blocks, 32 * p.warps, p.smem, stream>>>(y, l, x, B, n);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(64)
tautstring_kernel(const float* __restrict__ y, Lam lam,
                  float* __restrict__ x, int B, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* __restrict__ yb = y + (size_t)b * n;
  float* __restrict__ xb = x + (size_t)b * n;
  if (direct1d::degenerate(yb, lam, b, n, xb)) return;

  const float l0 = lam(b, 0);
  float mn = __ldg(yb) - l0, mx = __ldg(yb) + l0;  // segment value bounds
  float mnH = 0.f, mxH = 0.f;  // tube heights of the two bounds
  int mnB = 0, mxB = 0;        // last touches of the walls
  int last = -1;               // end of the last closed segment
  int i = 0;
  while (i < n) {
    const bool is_last = i == n - 1;
    const float yi = __ldg(yb + i);
    const float li = lam(b, min(i, n - 2));
    const float mnH1 = mnH + mn - yi;
    const float mxH1 = mxH + mx - yi;
    const bool ceil_v = is_last ? mnH1 > kEps : li < mnH1;
    const bool floor_v = !ceil_v && (is_last ? mxH1 < -kEps : -li > mxH1);
    if (ceil_v || floor_v) {
      // Close the segment at the pinned wall and restart after it.
      const int b_end = ceil_v ? mnB : mxB;
      const float b_val = ceil_v ? mn : mx;
      for (int k = last + 1; k <= b_end; ++k) xb[k] = b_val;
      const int j = b_end + 1;
      if (j >= n) return;  // a re-break at the restarted end point
      const float yj = __ldg(yb + j);
      const float lp = lam(b, j - 1);
      const float ln = (is_last && j == n - 1) ? 0.f : lam(b, min(j, n - 2));
      const float base = ceil_v ? yj + lp : yj - lp;
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
    const float denom = (float)(i - last);
    if (is_last) {
      // Tie the string to the end point and close the last segment.
      const float v = mnH1 <= 0.f ? mn + (-mnH1) / denom : mn;
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

}  // namespace

// y, x: (B, n) float32, row-major; lam: a strided (B, n-1) weight field
// (element strides lam_rs, lam_cs) or NULL for the scalar lam_s.  n >= 2
// (checked by the Python wrapper).
extern "C" int tautstring_tv1(const float* y, const float* lam, int lam_rs,
                              int lam_cs, float lam_s, float* x, int B, int n,
                              cudaStream_t stream) {
  if (B <= 0) return 0;
  const Lam l{lam, (size_t)lam_rs, (size_t)lam_cs, lam_s};
  if (n <= kWarpMaxN)
    return static_cast<int>(l.per_edge()
                                ? launch_warp<true>(y, l, x, B, n, stream)
                                : launch_warp<false>(y, l, x, B, n, stream));
  const int threads = 64;
  tautstring_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
      y, l, x, B, n);
  return static_cast<int>(cudaGetLastError());
}

// The longest signal the warp layout takes (the layouts' threshold).
extern "C" int tautstring_warp_max_n() { return kWarpMaxN; }
