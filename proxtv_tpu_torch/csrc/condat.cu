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
// Each closed run is recorded at its start, and x is written from the
// records after the chain (the plain version's forward fill).  Every
// operation is the plain version's (tv1_condat_plain) in the same order and
// rounding, with IEEE division; none can contract into an FMA (y + 2 lam
// is exact whether contracted or not), so the two agree bit for bit away
// from the degenerate guards (direct1d.cuh).  The kernel is written for the
// signal's type T and built for float (condat_tv1) and double
// (condat_tv1_f64, the float64 route of tv1_batched); in double both of an
// advance's divides are IEEE double divides.
//
// What bounds it on this card: the function reads y once and writes x
// once, 8 bytes an element: 512 x 1000 is 4 MB, 1.2 us at 3.35 TB/s.  The
// events form one dependent chain a signal (n and more: a jump restarts
// behind the cursor; 1473 a row on average on randn rows of 1000 at lam
// 0.7, 2970 on a walk of 1000 at lam 2), so a signal is latency: its chain,
// event after event.  One warp alone on a scheduler waits out each
// dependent latency, and every data-dependent branch of the chain costs
// more than the arithmetic: the compiler cannot tell that the 32 lanes
// agree, so it wraps each such branch in a reconvergence barrier
// (tools/probe_latency.py times the latencies and the scan's cycles an
// event on the card).  The design keeps the common event, an advance, free
// of them:
// * the advances run in an inner loop of one straight run of code whose
//   only branch leaves it: the excursions advance by the next sample (the
//   next two samples wait in registers, and the advance reads the one after
//   them for later), the two bounds' divides by k - k0 + 1 run side by
//   side with no branch (direct1d.cuh div_fast: the IEEE division's own
//   fast path, the reciprocal taken before the numerators are known), and
//   selects keep what the advance changes;
// * a jump, a boundary event or an advance whose divide needs the IEEE
//   path leaves that loop, is done out of it, and re-enters it;
// * a closed run is two shared-memory stores: its start marked and its
//   value recorded there.  The warp writes x after the chain by the forward
//   fill (direct1d.cuh warp_forward_fill), which is also the plain
//   version's rule for a jump that lands behind the run it closes.
//
// Two layouts by n, as D1 (direct1d.cuh):
// * n <= kWarpMaxN (16384 in float32, 8192 in float64), one warp a
//   signal: y (with two slots past it), the runs' values and their marks in
//   shared memory (2 (n + 1) values rounded to 16 bytes, plus n + 3 bytes
//   rounded to 32; 148 KB at 16384 in float32, 139 KB at 8192 in
//   float64); the warp stages y with
//   16-byte loads and takes the guards by warp reductions, and its 32
//   lanes run the event chain redundantly, uniform branches and broadcast
//   reads.
// * n > kWarpMaxN, one thread a signal, y read from global memory, each run
//   written as it closes (with the pin below).
#include <cuda_runtime.h>

#include "direct1d.cuh"

namespace {

using direct1d::add_rn;
using direct1d::LamT;
using direct1d::sub_rn;

// The longest signal of the warp layout (D1's threshold in each type).
template <class T>
constexpr int kWarpMaxN = sizeof(T) == 4 ? 16384 : 8192;

// A warp's shared memory: y (and two slots past it, which the scan may read
// ahead but never uses), then the runs' values, then the marks.
template <class T>
__host__ __device__ constexpr size_t warp_smem(int n) {
  return ((sizeof(T) * (2 * (size_t)n + 2) + 15) & ~(size_t)15)
         + direct1d::mark_bytes(n);
}

// One signal's events (tv1_condat_plain's body, one event an iteration),
// lam >= 0 and n >= 2.  yv(i) reads sample i; emit(k0, j, v) records the
// run that starts at k0 and closes at value v, the scan restarting at j
// (j = n for the last run).  The chain ends at the terminal boundary event.
//
// A boundary jump leaves the other of kminus / kplus as it was, and in a
// float32 tie (vmin above vmax by an ulp) a later jump from that stale
// index lands at j <= k0: the scan goes back behind the run it closes.
// The plain version, which marks each run's start and fills forward, then
// keeps that run from k0 up to the next start above it.
template <class T, class YF, class EF>
__device__ __forceinline__ void condat_scan(YF yv, T lam, int n, EF emit) {
  const T twolam = T(2) * lam;
  const int last = n - 1;
  int k = 0, k0 = 0, kminus = 0, kplus = 0;
  const T y0 = yv(0);
  T vmin = sub_rn(y0, lam), vmax = add_rn(y0, lam);
  T umin = lam, umax = -lam;
  T y1 = yv(1), y2 = yv(2);  // samples k + 1 and k + 2
  for (;;) {
    // The advances, one straight run each: the excursions advance by the
    // next sample, the touched bounds tighten by a divide by k - k0 + 1,
    // selects keep what an advance changes, and the loop's one branch
    // leaves it for every other event.
    T umin1, umax1;
    for (;;) {
      umin1 = sub_rn(add_rn(umin, y1), vmin);
      umax1 = sub_rn(add_rn(umax, y1), vmax);
      const T a = sub_rn(umin1, lam), c = add_rn(umax1, lam);
      const bool lo = umin1 >= lam, hi = umax1 <= -lam;
      const auto rd = direct1d::recip((T)(k - k0 + 2));
      const T dmin = direct1d::div_fast(a, rd);
      const T dmax = direct1d::div_fast(c, rd);
      if ((k == last) | (umin1 < -lam) | (umax1 > lam) |
          (lo & !direct1d::div_fast_ok(a)) | (hi & !direct1d::div_fast_ok(c)))
        break;
      const T y3 = yv(k + 3);
      ++k;
      vmin = lo ? add_rn(vmin, dmin) : vmin;
      umin = lo ? lam : umin1;
      kminus = lo ? k : kminus;
      vmax = hi ? add_rn(vmax, dmax) : vmax;
      umax = hi ? -lam : umax1;
      kplus = hi ? k : kplus;
      y1 = y2;
      y2 = y3;
    }
    if (k == last) {
      // The boundary events (the plain version's b_neg, b_pos, b_term).
      if (umin < T(0)) {
        const int j = kminus + 1;
        emit(k0, j, vmin);
        const T yj = yv(j);
        k = k0 = kminus = j;
        vmin = yj;
        umin = lam;
        umax = sub_rn(add_rn(yj, lam), vmax);
      } else if (umax > T(0)) {
        const int j = kplus + 1;
        emit(k0, j, vmax);
        const T yj = yv(j);
        k = k0 = kplus = j;
        umin = sub_rn(sub_rn(yj, lam), vmin);
        vmax = yj;
        umax = -lam;
      } else {
        break;
      }
    } else if (umin1 < -lam || umax1 > lam) {
      // A jump down (neg) or up (pos) closes the run at k0 and restarts
      // right after kminus or kplus.
      const bool neg = umin1 < -lam;
      const int j = (neg ? kminus : kplus) + 1;
      emit(k0, j, neg ? vmin : vmax);
      const T yj = yv(j);
      k = k0 = kminus = kplus = j;
      vmin = neg ? yj : sub_rn(yj, twolam);
      vmax = neg ? add_rn(yj, twolam) : yj;
      umin = lam;
      umax = -lam;
    } else {
      // An advance whose touched bound's divide takes the IEEE path.
      const T den = (T)(k - k0 + 2);
      const T a = sub_rn(umin1, lam), c = add_rn(umax1, lam);
      ++k;
      if (umin1 >= lam) {
        vmin = add_rn(vmin, a / den);
        umin = lam;
        kminus = k;
      } else {
        umin = umin1;
      }
      if (umax1 <= -lam) {
        vmax = add_rn(vmax, c / den);
        umax = -lam;
        kplus = k;
      } else {
        umax = umax1;
      }
    }
    y1 = yv(k + 1);
    y2 = yv(k + 2);
  }
  emit(k0, n, add_rn(vmin, umin / (T)(k - k0 + 1)));
}

template <class T>
__global__ void __launch_bounds__(32 * direct1d::kMaxWarps)
condat_warp_kernel(const T* __restrict__ y, LamT<T> lam,
                   T* __restrict__ x, int B, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp
  unsigned char* base = smem + (size_t)warp * warp_smem<T>(n);
  T* ys = reinterpret_cast<T*>(base);
  T* vs = ys + n + 2;
  unsigned char* mk = base + warp_smem<T>(n) - direct1d::mark_bytes(n);
  T* __restrict__ xb = x + (size_t)b * n;
  direct1d::stage_row(y + (size_t)b * n, n, ys, lane);
  direct1d::zero_bytes(mk, direct1d::mark_bytes(n), lane);
  __syncwarp();
  const T l = lam(b, 0);
  auto yv = [&](int i) { return ys[i]; };
  if (direct1d::warp_degenerate(yv, [&](int) { return l; }, n, xb, lane))
    return;
  const int head = direct1d::mark_head(xb);
  condat_scan(yv, l, n, [&](int k0, int, T v) {
    if (k0 < n) {
      vs[k0] = v;
      mk[head + k0] = 1;
    }
  });
  __syncwarp();
  direct1d::warp_forward_fill(mk, [&](int i) { return vs[i]; }, n, xb, lane);
}

template <class T>
__global__ void __launch_bounds__(64)
condat_kernel(const T* __restrict__ y, LamT<T> lam, T* __restrict__ x,
              int B, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T* __restrict__ yb = y + (size_t)b * n;
  T* __restrict__ xb = x + (size_t)b * n;
  if (direct1d::degenerate(yb, lam, b, n, xb)) return;
  // Each run written as it closes: to its end, or to the row's end when
  // the scan goes back behind it (j <= k0); later runs then stop at its
  // start (pin) until one starts at or past it, so that x ends as the
  // forward fill's.
  int pin = n;
  condat_scan([&](int i) { return __ldg(yb + (i < n ? i : n - 1)); },
              lam(b, 0), n,
              [&](int k0, int j, T v) {
                if (k0 >= pin) pin = n;
                direct1d::fill(xb, k0, min(j > k0 ? j : n, pin), v, 0, 1);
                if (j <= k0) pin = k0;
              });
}

template <class T>
int run(const T* y, const T* lam, int lam_rs, T lam_s, T* x, int B, int n,
        cudaStream_t stream) {
  if (B <= 0) return 0;
  const LamT<T> l{lam, (size_t)lam_rs, 0, lam_s};
  if (n <= kWarpMaxN<T>) {
    direct1d::WarpPlan p;
    const cudaError_t e =
        direct1d::warp_plan(condat_warp_kernel<T>, warp_smem<T>(n), B, &p);
    if (e != cudaSuccess) return static_cast<int>(e);
    condat_warp_kernel<T><<<p.blocks, 32 * p.warps, p.smem, stream>>>(
        y, l, x, B, n);
    return static_cast<int>(cudaGetLastError());
  }
  const int threads = 64;
  condat_kernel<T><<<(B + threads - 1) / threads, threads, 0, stream>>>(
      y, l, x, B, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y, x: (B, n) float32, row-major; lam: one weight a signal, lam[b * lam_rs]
// (lam_rs 0 for one shared), or NULL for the scalar lam_s.  Every weight
// >= 0 and n >= 2 (checked, and clamped, by the Python wrapper).
extern "C" int condat_tv1(const float* y, const float* lam, int lam_rs,
                          float lam_s, float* x, int B, int n,
                          cudaStream_t stream) {
  return run<float>(y, lam, lam_rs, lam_s, x, B, n, stream);
}

// The same in float64.
extern "C" int condat_tv1_f64(const double* y, const double* lam, int lam_rs,
                              double lam_s, double* x, int B, int n,
                              cudaStream_t stream) {
  return run<double>(y, lam, lam_rs, lam_s, x, B, n, stream);
}

// The longest signal the warp layout takes (the layouts' threshold), in
// float32 and in float64.
extern "C" int condat_warp_max_n() { return kWarpMaxN<float>; }
extern "C" int condat_warp_max_n_f64() { return kWarpMaxN<double>; }
