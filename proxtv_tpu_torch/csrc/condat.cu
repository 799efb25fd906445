// Kernel D3: batched Condat direct TV-L1 prox (one lambda a signal),
// written by hand for Hopper (sm_90a).
//
// No TPU kernel: it replaces the JAX package's XLA lock-step scan
// proxtv_tpu/ops/tv1d_l1.py:tv1_condat (one event per lane per while_loop
// step, with a device-to-host check of the loop condition on each), the
// port of Condat's TV1D_denoise (proxTV src/condat_fast_tv.cpp:78).  Here
// the same events run one after another per signal: from (k, k0, kminus,
// kplus, vmin, vmax, umin, umax), the dual excursions umin/umax advance by
// the next sample; a negative (positive) jump closes the run k0..kminus
// (k0..kplus) at vmin (vmax) and restarts right after it, re-reading y
// behind the cursor; otherwise the touched bounds tighten vmin/vmax.  At
// k = n - 1 the boundary events jump the same way or close the last run.
// Each run x[k0 .. next k0 - 1] is written when it closes.  Every
// operation is the plain version's (tv1_condat_plain) in the same order and
// float32 rounding, with IEEE division; none can contract into an FMA
// (y + 2 lam is exact whether contracted or not), so the two agree bit for
// bit away from the degenerate guards (direct1d.cuh).
//
// What bounds it on this card: the function reads y once and writes x
// once, 8 bytes an element: 512 x 1000 is 4 MB, 1.2 us at 3.35 TB/s.  The
// events form a dependent chain per signal (n and more: a jump restarts
// behind the cursor), so a signal is latency: its chain at the latency of
// the memory its events read.
//
// Design, two layouts by n, as D1 (direct1d.cuh):
// * n <= kWarpMaxN, one warp a signal: the warp stages y into shared
//   memory with 16-byte loads (a jump's re-reads hit shared memory), takes
//   the guards by warp reductions, and its 32 lanes run the event chain
//   redundantly, uniform branches and broadcast reads; a closed run goes
//   out 32 elements a store.
// * n > kWarpMaxN, one thread a signal, y read from global memory.
#include <cuda_runtime.h>

#include "direct1d.cuh"

namespace {

using direct1d::Lam;

// The longest signal of the warp layout: y takes 4n bytes of shared
// memory, 64 KB at 16384 (D1's threshold; a block takes at most 227 KB).
constexpr int kWarpMaxN = 16384;

// One signal's events (tv1_condat_plain's body, one event an iteration),
// lam >= 0 and n >= 2.  yv(i) reads sample i; put(a, e, v) writes
// x[a, e) = v.  The chain ends at the terminal boundary event.
//
// A jump closes the run that starts at k0 and restarts at j = kminus + 1 or
// kplus + 1, so the run is x[k0, j).  A boundary jump leaves the other of
// kminus / kplus as it was, and in a float32 tie (vmin above vmax by an
// ulp) a later jump from that stale index lands at j <= k0: the scan goes
// back behind the run it closes.  The plain version, which marks each run's
// start and fills forward, then keeps that run from k0 up to the next
// start above it; so does run(): the run goes to the end, and later runs
// stop at its start (pin) until a run starts at or past it.
template <class YF, class PF>
__device__ __forceinline__ void condat_scan(YF yv, float lam, int n, PF put) {
  const float twolam = 2.f * lam;
  int k = 0, k0 = 0, kminus = 0, kplus = 0;
  float vmin = __fsub_rn(yv(0), lam), vmax = __fadd_rn(yv(0), lam);
  float umin = lam, umax = -lam;
  int pin = n;
  auto run = [&](int j, float v) {
    if (k0 >= pin) pin = n;
    put(k0, min(j > k0 ? j : n, pin), v);
    if (j <= k0) pin = k0;
  };
  for (;;) {
    if (k == n - 1) {
      // The boundary events (the plain version's b_neg, b_pos, b_term).
      if (umin < 0.f) {
        const int j = kminus + 1;
        const float yj = yv(min(j, n - 1));
        run(j, vmin);
        k = k0 = kminus = j;
        vmin = yj;
        umin = lam;
        umax = __fsub_rn(__fadd_rn(yj, lam), vmax);
      } else if (umax > 0.f) {
        const int j = kplus + 1;
        const float yj = yv(min(j, n - 1));
        run(j, vmax);
        k = k0 = kplus = j;
        umin = __fsub_rn(__fsub_rn(yj, lam), vmin);
        vmax = yj;
        umax = -lam;
      } else {
        run(n, __fadd_rn(vmin, umin / (float)(k - k0 + 1)));
        return;
      }
      continue;
    }
    // The main-loop events (neg, pos, or no jump).
    const float ynext = yv(k + 1);
    const float umin1 = __fsub_rn(__fadd_rn(umin, ynext), vmin);
    const float umax1 = __fsub_rn(__fadd_rn(umax, ynext), vmax);
    if (umin1 < -lam || umax1 > lam) {
      const bool neg = umin1 < -lam;
      const int j = (neg ? kminus : kplus) + 1;
      const float yj = yv(min(j, n - 1));
      run(j, neg ? vmin : vmax);
      k = k0 = kminus = kplus = j;
      vmin = neg ? yj : __fsub_rn(yj, twolam);
      vmax = neg ? __fadd_rn(yj, twolam) : yj;
      umin = lam;
      umax = -lam;
      continue;
    }
    ++k;
    const float denom = (float)(k - k0 + 1);
    if (umin1 >= lam) {
      vmin = __fadd_rn(vmin, __fsub_rn(umin1, lam) / denom);
      umin = lam;
      kminus = k;
    } else {
      umin = umin1;
    }
    if (umax1 <= -lam) {
      vmax = __fadd_rn(vmax, __fadd_rn(umax1, lam) / denom);
      umax = -lam;
      kplus = k;
    } else {
      umax = umax1;
    }
  }
}

__global__ void __launch_bounds__(32 * direct1d::kMaxWarps)
condat_warp_kernel(const float* __restrict__ y, Lam lam,
                   float* __restrict__ x, int B, int n) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp
  float* ys = smem + (size_t)warp * n;
  float* __restrict__ xb = x + (size_t)b * n;
  direct1d::stage_row(y + (size_t)b * n, n, ys, lane);
  __syncwarp();
  const float l = lam(b, 0);
  auto yv = [&](int i) { return ys[i]; };
  if (direct1d::warp_degenerate(yv, [&](int) { return l; }, n, xb, lane))
    return;
  condat_scan(yv, l, n, [&](int a, int e, float v) {
    direct1d::fill(xb, a, e, v, lane, 32);
  });
}

__global__ void __launch_bounds__(64)
condat_kernel(const float* __restrict__ y, Lam lam, float* __restrict__ x,
              int B, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* __restrict__ yb = y + (size_t)b * n;
  float* __restrict__ xb = x + (size_t)b * n;
  if (direct1d::degenerate(yb, lam, b, n, xb)) return;
  condat_scan([&](int i) { return __ldg(yb + i); }, lam(b, 0), n,
              [&](int a, int e, float v) { direct1d::fill(xb, a, e, v, 0, 1); });
}

}  // namespace

// y, x: (B, n) float32, row-major; lam: one weight a signal, lam[b * lam_rs]
// (lam_rs 0 for one shared), or NULL for the scalar lam_s.  Every weight
// >= 0 and n >= 2 (checked, and clamped, by the Python wrapper).
extern "C" int condat_tv1(const float* y, const float* lam, int lam_rs,
                          float lam_s, float* x, int B, int n,
                          cudaStream_t stream) {
  if (B <= 0) return 0;
  const Lam l{lam, (size_t)lam_rs, 0, lam_s};
  if (n <= kWarpMaxN) {
    direct1d::WarpPlan p;
    const cudaError_t e =
        direct1d::warp_plan(condat_warp_kernel, sizeof(float) * (size_t)n, B,
                            &p);
    if (e != cudaSuccess) return static_cast<int>(e);
    condat_warp_kernel<<<p.blocks, 32 * p.warps, p.smem, stream>>>(y, l, x, B,
                                                                   n);
    return static_cast<int>(cudaGetLastError());
  }
  const int threads = 64;
  condat_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(y, l, x,
                                                                     B, n);
  return static_cast<int>(cudaGetLastError());
}

// The longest signal the warp layout takes (the layouts' threshold).
extern "C" int condat_warp_max_n() { return kWarpMaxN; }
