// Kernel D4: batched classic taut-string TV-L1 prox (one lambda a signal),
// written by hand for Hopper (sm_90a).
//
// No TPU kernel: it replaces the JAX package's XLA lock-step deque machine
// proxtv_tpu/ops/tv1d_l1.py:tv1_classic_ts (one deque event per lane per
// while_loop step, with a device-to-host check of the loop condition on
// each), the port of classicTautString_TV1 (proxTV
// src/TVL1opt_tautstring.cpp:256).  The concave majorant and the convex
// minorant of the cumulative-sum tube are deques of segments (ix samples,
// iy rise).  Here the plain version's events run one after another per
// signal, by phase: MAJ merges the pending segment into the majorant (a
// pop while it lies above the last segment's slope, then a push), MIN the
// same into the minorant; CROSS emits a knot while the hulls' first
// segments cross (a run of the output) and restarts the other hull from
// it; FLUSH emits the longer hull's segments at the end.  Each run
// [opos, opos + ix) is written when it is emitted.  Every operation is the
// plain version's (tv1_classic_ts_plain) in the same order and float32
// rounding, with IEEE division and no multiply-add, so the two agree bit
// for bit away from the degenerate guards (direct1d.cuh).  Kept from the
// plain version: the both-single guard (two single-segment hulls never
// cross: in float32 a 1-ulp tie of their merged sums at lam = 0 could
// fake a crossing that empties a deque) and the cap of 8n + 64 events, at
// which a signal stops with what it has written (its tail takes the last
// run's value, as the plain version's forward fill gives it).
//
// What bounds it on this card: the function reads y once and writes x
// once, 8 bytes an element, as D3; the deques are the algorithm's
// workspace.  The events (about 3n to 8n a signal) form a dependent chain,
// so a signal is latency: its chain at the latency of its deques' memory.
//
// Design, two layouts by n (direct1d.cuh):
// * n <= kWarpMaxN, one warp a signal: the two deques, n + 2 slots each of
//   an (int ix, float iy) pair, and y in shared memory, 20n + 32 bytes.
//   All 32 lanes run the events redundantly (broadcast reads, the same
//   value written to the same slot, uniform branches); an emitted run goes
//   out 32 elements a store.
// * n > kWarpMaxN, one thread a signal, y read from global memory and the
//   deques in a workspace that the wrapper allocates, interleaved by
//   signal (slot k of signal b at [k * B + b]) so that neighbouring
//   threads' accesses coalesce: 2 (n + 2) B pairs.
#include <cuda_runtime.h>

#include "direct1d.cuh"

namespace {

using direct1d::Lam;

// A deque slot: a hull segment of ix samples rising by iy.
struct __align__(8) Seg {
  int ix;
  float iy;
};

// The longest signal of the warp layout: its deques and y take
// 2 * 8 (n + 2) + 4n = 20n + 32 bytes of shared memory, at most the 227 KB
// a block may take: n <= 11620.
constexpr int kWarpMaxN =
    (direct1d::kMaxBlockSmem - 2 * 2 * (int)sizeof(Seg)) /
    (2 * (int)sizeof(Seg) + (int)sizeof(float));

// A warp's shared memory, rounded up to 16 bytes so that every warp's
// deques stay aligned (at n = kWarpMaxN, 20n + 32 needs no rounding).
__host__ __device__ size_t warp_smem(int n) {
  return (2 * sizeof(Seg) * ((size_t)n + 2) + sizeof(float) * (size_t)n
          + 15) & ~(size_t)15;
}

enum Phase { kMaj, kMin, kCross, kFlush, kDone };

// One signal's events (tv1_classic_ts_plain's body, one event an
// iteration), lam >= 0 and n >= 2.  yv(i) reads sample i; maj(k) and
// mnr(k) are slot k of the majorant's and the minorant's deques (n + 2
// slots; reads are clamped to them, writes to the first n + 1, as the
// plain version's arena); put(a, e, v) writes x[a, e) = v.
template <class YF, class DQ, class PF>
__device__ __forceinline__ void classic_scan(YF yv, float lam, int n, DQ maj,
                                             DQ mnr, PF put) {
  const int slots = n + 2;
  auto rd = [&](DQ& q, int k) -> Seg {
    return q(k < 0 ? 0 : (k > slots - 1 ? slots - 1 : k));
  };
  auto wr = [&](DQ& q, int k, int ix, float iy) {
    Seg& s = q(k < 0 ? 0 : (k > slots - 2 ? slots - 2 : k));
    s.ix = ix;
    s.iy = iy;
  };
  // The pending unit segment of point i: the last point enters the
  // majorant at y + lam and the minorant at y - lam.
  auto fresh = [&](int i, bool up) {
    const float yi = yv(min(i, n - 1));
    return i == n - 1 ? (up ? __fadd_rn(yi, lam) : __fsub_rn(yi, lam)) : yi;
  };
  const float y0 = yv(0);
  wr(maj, 0, 1, __fsub_rn(y0, lam));
  wr(mnr, 0, 1, __fadd_rn(y0, lam));
  int phase = kMaj, i = 1;
  int sx = 1;                   // the pending segment
  float sy = fresh(1, true);
  int mf = 0, ml = 0, nf = 0, nl = 0;  // first and last live slots
  int ox = 0, lx = 1;           // the last knot and the tube's end, x
  float oy = 0.f, ly = y0;      // ... and y
  bool flush_maj = false;
  int opos = 0, filled = 0;     // the next run's start, the end written
  float last_v = 0.f;
  auto emit = [&](int ix, float v) {
    const int a = opos < 0 ? 0 : (opos > n - 1 ? n - 1 : opos);
    int e = opos + ix < n ? opos + ix : n;
    if (e < a + 1) e = a + 1;
    put(a, e, v);
    filled = e > filled ? e : filled;
    last_v = v;
    opos += ix;
  };
  const long long cap = 8LL * n + 64;
  for (long long ev = 0; ev < cap && phase != kDone; ++ev) {
    if (phase == kMaj || phase == kMin) {
      // Merge the pending segment into a hull: pop while it lies above
      // (the majorant) or below (the minorant) the last segment's slope.
      const bool is_maj = phase == kMaj;
      DQ& q = is_maj ? maj : mnr;
      int& f = is_maj ? mf : nf;
      int& l = is_maj ? ml : nl;
      if (l - f + 1 >= 1) {
        const Seg s = rd(q, l);
        const float t = __fmul_rn((float)sx, s.iy / (float)s.ix);
        if (is_maj ? sy > t : sy < t) {
          sx += s.ix;
          sy = __fadd_rn(sy, s.iy);
          l -= 1;
          continue;
        }
      }
      wr(q, l + 1, sx, sy);
      l += 1;
      if (is_maj) {
        phase = kMin;
        sx = 1;
        sy = fresh(i, false);
      } else if (i < n - 1) {
        phase = kCross;
        lx += 1;
        ly = __fadd_rn(ly, yv(i));
      } else {
        phase = kFlush;
        flush_maj = (ml - mf) > (nl - nf);
      }
      continue;
    }
    if (phase == kCross) {
      const Seg a = rd(maj, mf), c = rd(mnr, nf);
      const bool both_single = ml - mf + 1 == 1 && nl - nf + 1 == 1;
      if (both_single || !(c.iy / (float)c.ix < a.iy / (float)a.ix)) {
        i += 1;
        phase = kMaj;
        sx = 1;
        sy = fresh(i, true);
        continue;
      }
      // A knot: the hull whose first segment is shorter gives it; the
      // other restarts as one segment from the knot to the tube's end.
      const bool take_min = c.ix < a.ix;
      const Seg knot = take_min ? c : a;
      if (take_min) {
        wr(maj, 0, lx - ox - c.ix,
           __fsub_rn(__fsub_rn(__fsub_rn(ly, lam), oy), c.iy));
        ml = mf = 0;
        nf += 1;
      } else {
        wr(mnr, 0, lx - ox - a.ix,
           __fsub_rn(__fsub_rn(__fadd_rn(ly, lam), oy), a.iy));
        nl = nf = 0;
        mf += 1;
      }
      ox += knot.ix;
      oy = __fadd_rn(oy, knot.iy);
      emit(knot.ix, knot.iy / (float)knot.ix);
      continue;
    }
    // kFlush: emit the longer hull's segments, then stop.
    int& f = flush_maj ? mf : nf;
    if (f <= (flush_maj ? ml : nl)) {
      const Seg s = rd(flush_maj ? maj : mnr, f);
      emit(s.ix, s.iy / (float)(s.ix < 1 ? 1 : s.ix));
      f += 1;
    } else {
      phase = kDone;
    }
  }
  if (filled < n) put(filled, n, last_v);
}

// Deque views: a warp's slots in shared memory, or a thread's interleaved
// slots in the workspace.
struct SmemDeque {
  Seg* s;
  __device__ __forceinline__ Seg& operator()(int k) const { return s[k]; }
};
struct GlobalDeque {
  Seg* s;
  size_t stride;  // B
  __device__ __forceinline__ Seg& operator()(int k) const {
    return s[(size_t)k * stride];
  }
};

__global__ void __launch_bounds__(32 * direct1d::kMaxWarps)
classic_ts_warp_kernel(const float* __restrict__ y, Lam lam,
                       float* __restrict__ x, int B, int n) {
  extern __shared__ Seg segs[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp
  Seg* maj = reinterpret_cast<Seg*>(reinterpret_cast<char*>(segs)
                                    + (size_t)warp * warp_smem(n));
  Seg* mnr = maj + (n + 2);
  float* ys = reinterpret_cast<float*>(mnr + (n + 2));
  float* __restrict__ xb = x + (size_t)b * n;
  direct1d::stage_row(y + (size_t)b * n, n, ys, lane);
  __syncwarp();
  const float l = lam(b, 0);
  auto yv = [&](int i) { return ys[i]; };
  if (direct1d::warp_degenerate(yv, [&](int) { return l; }, n, xb, lane))
    return;
  classic_scan(yv, l, n, SmemDeque{maj}, SmemDeque{mnr},
               [&](int a, int e, float v) {
                 direct1d::fill(xb, a, e, v, lane, 32);
               });
}

__global__ void __launch_bounds__(64)
classic_ts_kernel(const float* __restrict__ y, Lam lam, float* __restrict__ x,
                  Seg* __restrict__ ws, int B, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* __restrict__ yb = y + (size_t)b * n;
  float* __restrict__ xb = x + (size_t)b * n;
  if (direct1d::degenerate(yb, lam, b, n, xb)) return;
  const size_t S = (size_t)B;
  classic_scan([&](int i) { return __ldg(yb + i); }, lam(b, 0), n,
               GlobalDeque{ws + b, S},
               GlobalDeque{ws + ((size_t)n + 2) * S + b, S},
               [&](int a, int e, float v) {
                 direct1d::fill(xb, a, e, v, 0, 1);
               });
}

}  // namespace

// y, x: (B, n) float32, row-major; lam as condat_tv1.  ws: the thread
// layout's workspace (n > classic_ts_warp_max_n(); NULL otherwise), two
// deques of (n + 2) x B 8-byte slots, interleaved by signal.  Every weight
// >= 0 and n >= 2 (checked, and clamped, by the Python wrapper).
extern "C" int classic_ts_tv1(const float* y, const float* lam, int lam_rs,
                              float lam_s, float* x, void* ws, int B, int n,
                              cudaStream_t stream) {
  if (B <= 0) return 0;
  const Lam l{lam, (size_t)lam_rs, 0, lam_s};
  if (n <= kWarpMaxN) {
    direct1d::WarpPlan p;
    const cudaError_t e =
        direct1d::warp_plan(classic_ts_warp_kernel, warp_smem(n), B, &p);
    if (e != cudaSuccess) return static_cast<int>(e);
    classic_ts_warp_kernel<<<p.blocks, 32 * p.warps, p.smem, stream>>>(
        y, l, x, B, n);
    return static_cast<int>(cudaGetLastError());
  }
  if (!ws) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 64;
  classic_ts_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
      y, l, x, static_cast<Seg*>(ws), B, n);
  return static_cast<int>(cudaGetLastError());
}

// The longest signal the warp layout takes (the layouts' threshold).
extern "C" int classic_ts_warp_max_n() { return kWarpMaxN; }
