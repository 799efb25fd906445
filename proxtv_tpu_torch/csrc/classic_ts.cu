// Kernel D4: batched classic taut-string TV-L1 prox (one lambda a signal),
// written by hand for Hopper (sm_90a).
//
// No TPU kernel: it replaces the JAX package's XLA lock-step deque machine
// proxtv_tpu/ops/tv1d_l1.py:tv1_classic_ts (one deque event per lane per
// while_loop step, with a device-to-host check of the loop condition on
// each), the port of classicTautString_TV1 (proxTV
// src/TVL1opt_tautstring.cpp:256).  The concave majorant and the convex
// minorant of the cumulative-sum tube are deques of segments (ix samples,
// iy rise).  Each sample merges a pending segment into the majorant (a pop
// while it lies above the last segment's slope, then a push) and then into
// the minorant; then knots are emitted while the hulls' first segments
// cross (a run of the output), the other hull restarting as one segment
// from the knot to the tube's end; after the last sample the longer hull's
// segments are emitted.  Every operation is the plain version's
// (tv1_classic_ts_plain) in the same order and float32 rounding, with IEEE
// division and no multiply-add, so the two agree bit for bit away from the
// degenerate guards (direct1d.cuh).  Kept from the plain version: the
// both-single guard (two single-segment hulls never cross: in float32 a
// 1-ulp tie of their merged sums at lam = 0 could fake a crossing that
// empties a deque) and the cap of 8n + 64 events, at which a signal stops
// with the runs it has emitted (the forward fill gives its tail the last
// run's value, as the plain version's does).
//
// Why no signal reaches the cap, whatever its data (NaN too): the segments
// of each hull always tile the tube from the last knot to its end, so every
// ix is an integer in [1, n] (a knot comes from a hull of two segments or
// more: the both-single guard and the shorter-first rule see to it), every
// emitted run is at least one sample and the runs tile [0, n).  A signal
// then has 2 (n - 1) pushes, n - 2 tests that find no crossing, K knots,
// F <= n flush emissions and the end; its pops remove segments that were
// created (2 at the start, the pushes, one a knot) and that no knot
// emitted or discarded (at least 2 a knot) and that the end does not hold
// (2 at least): at most 2n - 2 - K.  So at most 6n - 5 events, well under
// 8n + 64.  The same tiling bounds every deque index by n and keeps every
// ix exact in float32 below 2^24.
//
// What bounds it on this card: the function reads y once and writes x
// once, 8 bytes an element, as D3; the deques are the algorithm's
// workspace.  The events (about 5n a signal: 4996 at n = 1000) form one
// dependent chain a signal, so a signal is latency: its chain, event after
// event, one warp alone on a scheduler waiting out each dependent latency
// and each data-dependent branch (tools/probe_latency.py).  The design
// keeps that chain short:
// * one pass a sample in the plain version's event order, with no phase
//   switch: its merges into the majorant and the minorant run at once (the
//   hulls are independent; the pops of either by selects, in one loop), a
//   push that popped nothing takes slope sy / 1 = sy with no divide, and
//   the crossing tests follow;
// * each hull's first, last and next-to-last segments live in registers,
//   so a pop test, a push and a crossing test wait on no memory read (a pop
//   loads the segment below the new last one, for the pop after it);
// * every slot caches its slope iy / ix, divided once when the slot is
//   written (direct1d.cuh div_whole: IEEE, with no branch), so no test
//   divides; a slot is 16 bytes (ix, iy, the slope, ix as float32), one
//   load or store;
// * y is read one sample ahead into a register;
// * an emitted run is two shared-memory stores, its start marked and its
//   value left at its start (over y's slot there: a run emitted at sample i
//   starts at or before i, and the scan reads y only from i + 1 on); the
//   warp writes x after the chain by the plain version's forward fill,
//   16 bytes a store (direct1d.cuh warp_forward_fill);
// * one warp a block, the signal blockIdx.x (on an H100 this ran the walk
//   of 1000 13% faster than several warps a block, where each warp's base
//   address comes from threadIdx.x).
//
// Two layouts by n (direct1d.cuh):
// * n <= kWarpMaxN, one warp a signal: the two deques (n + 2 slots of 16
//   bytes: ix, iy, the slope and ix as float32, one load or store a slot),
//   y and the run marks in shared memory, 32 (n + 2) + 4n bytes rounded to
//   16, plus n + 3 bytes rounded to 32: at most 227 KB at n = 6280.  All
//   32 lanes run the events redundantly (broadcast reads, the same value
//   written to the same slot, uniform branches).  One warp a block.
// * n > kWarpMaxN, one thread a signal, y read from global memory and the
//   deques in a workspace that the wrapper allocates, interleaved by
//   signal (slot k of signal b at [k * B + b]) so that neighbouring
//   threads' accesses coalesce: 2 (n + 2) B slots.  Its runs are written
//   as they are emitted (they come in order and tile the row).
#include <cuda_runtime.h>
#include <limits.h>

#include "direct1d.cuh"

namespace {

using direct1d::Lam;

// A hull segment in registers: ix samples (and ix as float32), rising by
// iy, at slope sl = iy / ix.
struct Seg {
  int ix;
  float ixf, iy, sl;
};

// A deque's slots, 16 bytes each (ix's bits, iy, slope, ix as float32),
// one load or store a slot; slot k at [k * step].
struct Deque {
  float4* s;
  size_t step;
  __device__ __forceinline__ Seg ld(int k) const {
    const float4 v = s[(size_t)k * step];
    return Seg{__float_as_int(v.x), v.w, v.y, v.z};
  }
  __device__ __forceinline__ void st(int k, const Seg& g) const {
    s[(size_t)k * step] = make_float4(__int_as_float(g.ix), g.iy, g.sl, g.ixf);
  }
};

// A hull: its deque, first and last live slots, and the segments of the
// first, the last and the next-to-last slot (bel, valid while the hull
// holds two segments or more).
struct Hull {
  Deque q;
  int f, l;
  Seg first, top, bel;
};
// Which hull a merge is into: the majorant pops while the pending segment
// lies above the last one, the minorant while it lies below.
struct Majorant {
  static constexpr bool kUp = true;
};
struct Minorant {
  static constexpr bool kUp = false;
};

// One signal's events (tv1_classic_ts_plain's body), lam >= 0 and n >= 2,
// at most cap of them (8n + 64 but in a test of the cap itself), counted
// in Count.  yv(i) reads sample i; emit(p, v) records a run of value v
// starting at sample p (in increasing p, from 0).  kExactSum: n < 2^24,
// so the pending segment's ix, a sum of at most n, is exact as a float32
// sum; otherwise it is converted from the int.
template <bool kExactSum, class Count, class YF, class EF>
__device__ __forceinline__ void classic_scan(YF yv, float lam, int n,
                                             Count cap, Deque maj,
                                             Deque mnr, EF emit) {
  Count ev = 0;  // events so far; the event at ev == cap never runs
  const float y0 = yv(0);
  const float a0 = __fsub_rn(y0, lam), c0 = __fadd_rn(y0, lam);
  Hull mj{maj, 0, 0}, mn{mnr, 0, 0};
  mj.top = mj.first = mj.bel = Seg{1, 1.f, a0, a0};  // iy / 1 is iy
  mn.top = mn.first = mn.bel = Seg{1, 1.f, c0, c0};
  maj.st(0, mj.top);
  mnr.st(0, mn.top);
  int lx = 1, ox = 0;       // the tube's end and the last knot, x
  float ly = y0, oy = 0.f;  // ... and y

  // Where p: a pop of h's last segment into the pending one (sx, sxf,
  // sy), by selects.  Then a push of the pending one at slope sl.
  auto pop_if = [&](bool p, Hull& h, int& sx, float& sxf, float& sy) {
    const Seg below = h.q.ld(h.l > 1 ? h.l - 2 : 0);
    sx = p ? sx + h.top.ix : sx;
    sxf = p ? (kExactSum ? __fadd_rn(sxf, h.top.ixf) : (float)sx) : sxf;
    sy = p ? __fadd_rn(sy, h.top.iy) : sy;
    h.l -= p;
    h.top = p ? h.bel : h.top;
    h.bel = p ? below : h.bel;
  };
  auto push = [&](Hull& h, int sx, float sxf, float sy, float sl) {
    h.l += 1;
    h.bel = h.top;
    h.top = Seg{sx, sxf, sy, sl};
    h.q.st(h.l, h.top);
    if (h.l == h.f) h.first = h.top;
  };
  // A push of a unit segment with no pop before it: its slope is sy / 1,
  // and the hull, which held a segment, keeps its first.
  auto push_unit = [&](Hull& h, float sy) {
    h.l += 1;
    h.bel = h.top;
    h.top = Seg{1, 1.f, sy, sy};
    h.q.st(h.l, h.top);
  };
  // The plain version's merge of the pending unit segment (1, sy) into one
  // hull, event by event against the cap: pop while it lies above (the
  // majorant) or below (the minorant) the last segment's slope, then push.
  // False when the cap stops the signal.
  auto merge = [&](auto side, Hull& h, float sy) -> bool {
    constexpr bool kUp = decltype(side)::kUp;
    int sx = 1;
    float sxf = 1.f;
    while (h.l >= h.f) {
      const float t = __fmul_rn(sxf, h.top.sl);
      if (kUp ? !(sy > t) : !(sy < t)) break;
      if (ev++ == cap) return false;
      pop_if(true, h, sx, sxf, sy);
    }
    if (ev++ == cap) return false;
    push(h, sx, sxf, sy, sy / sxf);
    return true;
  };
  // A knot from hull g (its first segment, of two or more), hull h
  // restarting as one segment from the knot to the tube's end at y_end.
  auto knot = [&](Hull& g, Hull& h, float y_end) {
    const Seg k = g.first;
    const int rx = lx - ox - k.ix;
    const float rxf = (float)rx;
    const float ry = __fsub_rn(__fsub_rn(y_end, oy), k.iy);
    h.top = h.first = Seg{rx, rxf, ry, direct1d::div_whole(ry, rxf)};
    h.q.st(0, h.top);
    h.f = h.l = 0;
    g.f += 1;
    const Seg nf = g.q.ld(g.f);
    g.first = g.f == g.l ? g.top : nf;
    emit(ox, k.sl);
    ox += k.ix;
    oy = __fadd_rn(oy, k.iy);
  };

  float ynext = yv(1);
  for (int i = 1;; ++i) {
    const bool last = i == n - 1;
    const float yi = ynext;
    if (!last) ynext = yv(i + 1);
    float sj = last ? __fadd_rn(yi, lam) : yi;  // the pending rises
    float sn = last ? __fsub_rn(yi, lam) : yi;
    if (__builtin_expect(ev + (mj.l - mj.f) + (mn.l - mn.f) + 4 <= cap, 1)) {
      // Both merges at once: the hulls are independent, and the cap cannot
      // fall among these events (at most both hulls' segments and two
      // pushes).  A hull holds a segment between samples, and the first
      // pop test compares with the last slope itself (1 * slope); a push
      // that popped nothing has slope sy / 1 = sy.
      bool pj = sj > mj.top.sl, pn = sn < mn.top.sl;
      if (pj || pn) {
        int xj = 1, xn = 1;
        float fj = 1.f, fn = 1.f;
        do {  // a pop in each hull that pops, by selects
          pop_if(pj, mj, xj, fj, sj);
          pop_if(pn, mn, xn, fn, sn);
          ev += (Count)pj + (Count)pn;
          pj = pj && mj.l >= mj.f && sj > __fmul_rn(fj, mj.top.sl);
          pn = pn && mn.l >= mn.f && sn < __fmul_rn(fn, mn.top.sl);
        } while (pj || pn);
        push(mj, xj, fj, sj, direct1d::div_whole(sj, fj));
        push(mn, xn, fn, sn, direct1d::div_whole(sn, fn));
      } else {
        push_unit(mj, sj);
        push_unit(mn, sn);
      }
      ev += 2;
    } else if (!merge(Majorant(), mj, sj) || !merge(Minorant(), mn, sn)) {
      return;
    }
    if (__builtin_expect(last, 0)) break;
    lx += 1;
    ly = __fadd_rn(ly, yi);
    for (;;) {  // knots while the first segments cross
      if (__builtin_expect(ev++ == cap, 0)) return;
      const bool both_single = mj.l == mj.f && mn.l == mn.f;
      if (both_single || !(mn.first.sl < mj.first.sl)) break;
      if (mn.first.ix < mj.first.ix)
        knot(mn, mj, __fsub_rn(ly, lam));
      else
        knot(mj, mn, __fadd_rn(ly, lam));
    }
  }
  // Emit the longer hull's segments (the minorant's on equal lengths, as
  // the plain version's test).
  const bool fm = (mj.l - mj.f) > (mn.l - mn.f);
  const Deque q = fm ? maj : mnr;
  const int l = fm ? mj.l : mn.l;
  for (int k = fm ? mj.f : mn.f; k <= l; ++k) {
    if (ev++ == cap) return;
    const Seg s = q.ld(k);
    emit(ox, s.sl);
    ox += s.ix;
  }
}

// A warp's shared memory: the deques, then y (and the runs' values),
// 16-byte aligned, then the run marks.  The warp layout takes the longest
// signal whose warp fits a block.
__host__ __device__ constexpr size_t warp_smem(int n) {
  return ((32 * ((size_t)n + 2) + 4 * (size_t)n + 15) & ~(size_t)15)
         + direct1d::mark_bytes(n);
}
constexpr int kWarpMaxN = 6280;
static_assert(warp_smem(kWarpMaxN) <= (size_t)direct1d::kMaxBlockSmem &&
                  warp_smem(kWarpMaxN + 1) > (size_t)direct1d::kMaxBlockSmem,
              "kWarpMaxN is the longest signal whose warp fits a block");

// One warp a block, as D3's (condat.cu): the signal is blockIdx.x, so the
// chain's branches need no reconvergence barrier.
__global__ void __launch_bounds__(32)
classic_ts_warp_kernel(const float* __restrict__ y, Lam lam,
                       float* __restrict__ x, int n, long long cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  unsigned char* base = smem;
  float4* w = reinterpret_cast<float4*>(base);
  const Deque maj{w, 1}, mnr{w + n + 2, 1};
  float* ys = reinterpret_cast<float*>(w + 2 * (n + 2));
  unsigned char* mk = base + warp_smem(n) - direct1d::mark_bytes(n);
  float* __restrict__ xb = x + (size_t)b * n;
  direct1d::stage_row(y + (size_t)b * n, n, ys, lane);
  direct1d::zero_bytes(mk, direct1d::mark_bytes(n), lane);
  __syncwarp();
  const float l = lam(b, 0);
  auto yv = [&](int i) { return ys[i]; };
  if (direct1d::warp_degenerate(yv, [&](int) { return l; }, n, xb, lane))
    return;
  const int head = direct1d::mark_head(xb);
  const int icap = cap < INT_MAX ? (int)cap : INT_MAX;  // at most 8n + 64
  classic_scan<true>(yv, l, n, icap, maj, mnr, [&](int p, float v) {
    ys[p] = v;
    mk[head + p] = 1;
  });
  __syncwarp();
  direct1d::warp_forward_fill(mk, yv, n, xb, lane);
}

__global__ void __launch_bounds__(64)
classic_ts_kernel(const float* __restrict__ y, Lam lam, float* __restrict__ x,
                  float* __restrict__ ws, int B, int n, long long cap) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* __restrict__ yb = y + (size_t)b * n;
  float* __restrict__ xb = x + (size_t)b * n;
  if (direct1d::degenerate(yb, lam, b, n, xb)) return;
  float4* w = reinterpret_cast<float4*>(ws) + b;
  const Deque maj{w, (size_t)B}, mnr{w + ((size_t)n + 2) * B, (size_t)B};
  int cp = 0;  // the current run's start and value
  float cv = 0.f;
  auto emit = [&](int p, float v) {
    direct1d::fill(xb, cp, p, cv, 0, 1);
    cp = p;
    cv = v;
  };
  auto yv = [&](int i) { return __ldg(yb + i); };
  if (n < (1 << 24))
    classic_scan<true>(yv, lam(b, 0), n, cap, maj, mnr, emit);
  else
    classic_scan<false>(yv, lam(b, 0), n, cap, maj, mnr, emit);
  direct1d::fill(xb, cp, n, cv, 0, 1);
}

}  // namespace

// y, x: (B, n) float32, row-major; lam as condat_tv1.  ws: the thread
// layout's workspace (n > classic_ts_warp_max_n(); NULL otherwise), two
// deques of (n + 2) x B 16-byte slots, interleaved by signal.  Every
// weight >= 0 and n >= 2 (checked, and clamped, by the Python wrapper).
// cap: the most events a signal runs
// (classic_ts_tv1 passes the plain version's 8n + 64, which no signal
// reaches; a test passes less to hold the cap's output rule).
extern "C" int classic_ts_tv1_capped(const float* y, const float* lam,
                                     int lam_rs, float lam_s, float* x,
                                     void* ws, int B, int n, long long cap,
                                     cudaStream_t stream) {
  if (B <= 0) return 0;
  const Lam l{lam, (size_t)lam_rs, 0, lam_s};
  if (n <= kWarpMaxN) {
    const cudaError_t e = cudaFuncSetAttribute(
        classic_ts_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        direct1d::kMaxBlockSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    classic_ts_warp_kernel<<<B, 32, warp_smem(n), stream>>>(y, l, x, n, cap);
    return static_cast<int>(cudaGetLastError());
  }
  if (!ws) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 64;
  classic_ts_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
      y, l, x, static_cast<float*>(ws), B, n, cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int classic_ts_tv1(const float* y, const float* lam, int lam_rs,
                              float lam_s, float* x, void* ws, int B, int n,
                              cudaStream_t stream) {
  return classic_ts_tv1_capped(y, lam, lam_rs, lam_s, x, ws, B, n,
                               8LL * n + 64, stream);
}

// The longest signal the warp layout takes (the layouts' threshold).
extern "C" int classic_ts_warp_max_n() { return kWarpMaxN; }
