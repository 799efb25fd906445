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
// (tv1_classic_ts_plain) in the same order and rounding, with IEEE
// division and no multiply-add, so the two agree bit for bit away from the
// degenerate guards (direct1d.cuh).  The kernel is written for the
// signal's type T and built for float (classic_ts_tv1) and double
// (classic_ts_tv1_f64, the float64 route of tv1_batched, whose tube is
// built from float64 prefix sums).  Kept from the plain version: the
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
//   divides; a slot is 16 bytes in float32 (ix, iy, the slope, ix as
//   float32), one load or store, and 20 in float64 (below);
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
// Layouts by n (direct1d.cuh):
// * n <= kWarpMaxN, one warp a signal: the two deques (n + 2 slots each),
//   y and the run marks in shared memory.  All 32 lanes run the events
//   redundantly (broadcast reads, the same value written to the same slot,
//   uniform branches).  One warp a block.  In float32 a slot is 16 bytes
//   (ix, iy, the slope and ix as float32, one load or store): 32 (n + 2)
//   + 4n bytes rounded to 16, plus n + 3 bytes rounded to 32, at most
//   227 KB at n = 6280.  In float64 a slot is 20 bytes, in two arrays: iy
//   and the slope as a double2 (one 16-byte load or store) and ix as an
//   int (ix as a double is made from it, exactly), so a warp takes
//   40 (n + 2) + 8n bytes rounded to 16 plus the marks: 49 KB at n = 1000
//   (four blocks an SM, 512 signals in one wave), 227 KB at n = 4741.
// * float64, kWarpMaxN < n <= kRingMaxN, one warp a signal (the ring
//   layout): as the warp layout, but each deque in a ring of kRing slots
//   (slot k at place k mod kRing).  A deque's indices grow along the
//   signal (on a ramp to n), but it holds few segments at once, and while
//   it holds at most kRing, each of its live slots is the last one written
//   to its place (a push at k + kRing while k is live leaves kRing + 1 live
//   slots; one at k - kRing pops k first).  A push that leaves a deque
//   holding more sets a flag, and the warp then runs the signal again with
//   its deques in a workspace that the wrapper allocates (the first run's
//   output is overwritten; its emits past n are dropped).  The plain
//   version's deques on ROADMAP C's n = 11621 walk (lam 1.3) hold 7 at
//   most, on randn, walks, ramps, a sine and an exponential to n = 20000
//   126 at most; a ramp whose tube is wide against its rise (n = 6000,
//   lam 1000) holds 896 (tools/classic_ts_depths.py).  Shared memory
//   40 kRing + 8n + n bytes: 227 KB at n = 23549.
// * longer signals, one thread a signal, y read from global memory and
//   the deques in a workspace that the wrapper allocates, interleaved by
//   signal (slot k of signal b at [k * B + b]) so that neighbouring
//   threads' accesses coalesce: 2 (n + 2) B slots.  Its runs are written
//   as they are emitted (they come in order and tile the row).  Past
//   kWarpMaxN in float32, past kRingMaxN in float64.
#include <cuda_runtime.h>
#include <limits.h>

#include "direct1d.cuh"

namespace {

using direct1d::add_rn;
using direct1d::LamT;
using direct1d::mul_rn;
using direct1d::sub_rn;

// A hull segment in registers: ix samples (and ix in the signal's type T),
// rising by iy, at slope sl = iy / ix.
template <class T>
struct Seg {
  int ix;
  T ixf, iy, sl;
};

// A float32 deque slot: 16 bytes (ix's bits, iy, slope, ix as float32),
// one load or store.
template <class T>
using Slot = float4;
__device__ __forceinline__ Seg<float> get(const float4& v) {
  return Seg<float>{__float_as_int(v.x), v.w, v.y, v.z};
}
__device__ __forceinline__ float4 make_slot(const Seg<float>& g) {
  return make_float4(__int_as_float(g.ix), g.iy, g.sl, g.ixf);
}

// A float32 deque's slots, slot k at [k * step].
template <class T>
struct Deque {
  Slot<T>* s;
  size_t step;
  __device__ __forceinline__ Seg<T> ld(int k) const {
    const Slot<T> v = s[(size_t)k * step];
    return get(v);
  }
  __device__ __forceinline__ void st(int k, const Seg<T>& g) const {
    s[(size_t)k * step] = make_slot(g);
  }
  __device__ __forceinline__ void pushed(int, int) const {}
};

// A float64 deque: slot k's (iy, slope) at v[k * step], its ix at
// ix[k * step]; ix as a double is made from the int (exact).
struct Deque64 {
  double2* v;
  int* ix;
  size_t step;
  __device__ __forceinline__ Seg<double> ld(int k) const {
    const double2 p = v[(size_t)k * step];
    const int x = ix[(size_t)k * step];
    return Seg<double>{x, (double)x, p.x, p.y};
  }
  __device__ __forceinline__ void st(int k, const Seg<double>& g) const {
    v[(size_t)k * step] = make_double2(g.iy, g.sl);
    ix[(size_t)k * step] = g.ix;
  }
  __device__ __forceinline__ void pushed(int, int) const {}
};

// A float64 deque in a ring of kRing slots, slot k at place k mod kRing
// (as Deque64 there); a push that leaves it holding more than kRing
// segments sets *over (its oldest live slot's place was taken).
constexpr int kRing = 512;
struct Ring64 {
  double2* v;
  int* ix;
  int* over;
  __device__ __forceinline__ Seg<double> ld(int k) const {
    const int q = k & (kRing - 1);
    const double2 p = v[q];
    const int x = ix[q];
    return Seg<double>{x, (double)x, p.x, p.y};
  }
  __device__ __forceinline__ void st(int k, const Seg<double>& g) const {
    const int q = k & (kRing - 1);
    v[q] = make_double2(g.iy, g.sl);
    ix[q] = g.ix;
  }
  __device__ __forceinline__ void pushed(int f, int l) const {
    if (l - f >= kRing) *over = 1;
  }
};

// A hull: its deque, first and last live slots, and the segments of the
// first, the last and the next-to-last slot (bel, valid while the hull
// holds two segments or more).
template <class T, class Q>
struct Hull {
  Q q;
  int f, l;
  Seg<T> first, top, bel;
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
// in Count, on the deques maj and mnr (of type Q: Deque, Deque64 or
// Ring64; Q::pushed(f, l) sees each push's live slots f .. l).  yv(i)
// reads sample i; emit(p, v) records a run of value v
// starting at sample p (in increasing p, from 0).  kExactSum: the pending
// segment's ix, a sum of at most n, is exact as a sum in T (n < 2^24 in
// float32, always in float64); otherwise it is converted from the int.
template <bool kExactSum, class T, class Count, class Q, class YF,
          class EF>
__device__ __forceinline__ void classic_scan(YF yv, T lam, int n,
                                             Count cap, Q maj, Q mnr,
                                             EF emit) {
  using S = Seg<T>;
  using H = Hull<T, Q>;
  Count ev = 0;  // events so far; the event at ev == cap never runs
  const T y0 = yv(0);
  const T a0 = sub_rn(y0, lam), c0 = add_rn(y0, lam);
  H mj{maj, 0, 0}, mn{mnr, 0, 0};
  mj.top = mj.first = mj.bel = S{1, T(1), a0, a0};  // iy / 1 is iy
  mn.top = mn.first = mn.bel = S{1, T(1), c0, c0};
  maj.st(0, mj.top);
  mnr.st(0, mn.top);
  int lx = 1, ox = 0;     // the tube's end and the last knot, x
  T ly = y0, oy = T(0);   // ... and y

  // Where p: a pop of h's last segment into the pending one (sx, sxf,
  // sy), by selects.  Then a push of the pending one at slope sl.
  auto pop_if = [&](bool p, H& h, int& sx, T& sxf, T& sy) {
    const S below = h.q.ld(h.l > 1 ? h.l - 2 : 0);
    sx = p ? sx + h.top.ix : sx;
    sxf = p ? (kExactSum ? add_rn(sxf, h.top.ixf) : (T)sx) : sxf;
    sy = p ? add_rn(sy, h.top.iy) : sy;
    h.l -= p;
    h.top = p ? h.bel : h.top;
    h.bel = p ? below : h.bel;
  };
  auto push = [&](H& h, int sx, T sxf, T sy, T sl) {
    h.l += 1;
    h.q.pushed(h.f, h.l);
    h.bel = h.top;
    h.top = S{sx, sxf, sy, sl};
    h.q.st(h.l, h.top);
    if (h.l == h.f) h.first = h.top;
  };
  // A push of a unit segment with no pop before it: its slope is sy / 1,
  // and the hull, which held a segment, keeps its first.
  auto push_unit = [&](H& h, T sy) {
    h.l += 1;
    h.q.pushed(h.f, h.l);
    h.bel = h.top;
    h.top = S{1, T(1), sy, sy};
    h.q.st(h.l, h.top);
  };
  // The plain version's merge of the pending unit segment (1, sy) into one
  // hull, event by event against the cap: pop while it lies above (the
  // majorant) or below (the minorant) the last segment's slope, then push.
  // False when the cap stops the signal.
  auto merge = [&](auto side, H& h, T sy) -> bool {
    constexpr bool kUp = decltype(side)::kUp;
    int sx = 1;
    T sxf = T(1);
    while (h.l >= h.f) {
      const T t = mul_rn(sxf, h.top.sl);
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
  auto knot = [&](H& g, H& h, T y_end) {
    const S k = g.first;
    const int rx = lx - ox - k.ix;
    const T rxf = (T)rx;
    const T ry = sub_rn(sub_rn(y_end, oy), k.iy);
    h.top = h.first = S{rx, rxf, ry, direct1d::div_whole(ry, rxf)};
    h.q.st(0, h.top);
    h.f = h.l = 0;
    g.f += 1;
    const S nf = g.q.ld(g.f);
    g.first = g.f == g.l ? g.top : nf;
    emit(ox, k.sl);
    ox += k.ix;
    oy = add_rn(oy, k.iy);
  };

  T ynext = yv(1);
  for (int i = 1;; ++i) {
    const bool last = i == n - 1;
    const T yi = ynext;
    if (!last) ynext = yv(i + 1);
    T sj = last ? add_rn(yi, lam) : yi;  // the pending rises
    T sn = last ? sub_rn(yi, lam) : yi;
    if (__builtin_expect(ev + (mj.l - mj.f) + (mn.l - mn.f) + 4 <= cap, 1)) {
      // Both merges at once: the hulls are independent, and the cap cannot
      // fall among these events (at most both hulls' segments and two
      // pushes).  A hull holds a segment between samples, and the first
      // pop test compares with the last slope itself (1 * slope); a push
      // that popped nothing has slope sy / 1 = sy.
      bool pj = sj > mj.top.sl, pn = sn < mn.top.sl;
      if (pj || pn) {
        int xj = 1, xn = 1;
        T fj = T(1), fn = T(1);
        do {  // a pop in each hull that pops, by selects
          pop_if(pj, mj, xj, fj, sj);
          pop_if(pn, mn, xn, fn, sn);
          ev += (Count)pj + (Count)pn;
          pj = pj && mj.l >= mj.f && sj > mul_rn(fj, mj.top.sl);
          pn = pn && mn.l >= mn.f && sn < mul_rn(fn, mn.top.sl);
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
    ly = add_rn(ly, yi);
    for (;;) {  // knots while the first segments cross
      if (__builtin_expect(ev++ == cap, 0)) return;
      const bool both_single = mj.l == mj.f && mn.l == mn.f;
      if (both_single || !(mn.first.sl < mj.first.sl)) break;
      if (mn.first.ix < mj.first.ix)
        knot(mn, mj, sub_rn(ly, lam));
      else
        knot(mj, mn, add_rn(ly, lam));
    }
  }
  // Emit the longer hull's segments (the minorant's on equal lengths, as
  // the plain version's test).
  const bool fm = (mj.l - mj.f) > (mn.l - mn.f);
  const Q q = fm ? maj : mnr;
  const int l = fm ? mj.l : mn.l;
  for (int k = fm ? mj.f : mn.f; k <= l; ++k) {
    if (ev++ == cap) return;
    const S s = q.ld(k);
    emit(ox, s.sl);
    ox += s.ix;
  }
}

// A float32 warp's shared memory: the deques, then y (and the runs'
// values), 16-byte aligned, then the run marks.  The warp layout takes the
// longest signal whose warp fits a block: 6280.
template <class T>
__host__ __device__ constexpr size_t warp_smem(int n) {
  return ((2 * sizeof(Slot<T>) * ((size_t)n + 2) + sizeof(T) * (size_t)n
           + 15) & ~(size_t)15)
         + direct1d::mark_bytes(n);
}
template <class T>
constexpr int kWarpMaxN = 6280;
static_assert(warp_smem<float>(kWarpMaxN<float>)
                      <= (size_t)direct1d::kMaxBlockSmem &&
                  warp_smem<float>(kWarpMaxN<float> + 1)
                      > (size_t)direct1d::kMaxBlockSmem,
              "kWarpMaxN is the longest signal whose warp fits a block");

// A float64 warp's shared memory: in the warp layout the deques' (iy,
// slope) pairs, y (and the runs' values) and the deques' ix; in the ring
// layout the rings' (iy, slope) pairs and ix, the overflow flag and y;
// 16-byte aligned, then the run marks.  The warp layout takes the longest
// signal whose warp fits a block, 4741; the ring layout the longest whose
// ring does, 23549.
__host__ __device__ constexpr size_t warp_smem64(int n, bool ring) {
  return (((ring ? 40 * (size_t)kRing + 16 : 40 * ((size_t)n + 2))
           + 8 * (size_t)n + 15) & ~(size_t)15)
         + direct1d::mark_bytes(n);
}
constexpr int kWarpMaxN64 = 4741;
constexpr int kRingMaxN64 = 23549;
static_assert(warp_smem64(kWarpMaxN64, false)
                      <= (size_t)direct1d::kMaxBlockSmem &&
                  warp_smem64(kWarpMaxN64 + 1, false)
                      > (size_t)direct1d::kMaxBlockSmem,
              "kWarpMaxN64 is the longest signal whose warp fits a block");
static_assert(warp_smem64(kRingMaxN64, true)
                      <= (size_t)direct1d::kMaxBlockSmem &&
                  warp_smem64(kRingMaxN64 + 1, true)
                      > (size_t)direct1d::kMaxBlockSmem,
              "kRingMaxN64 is the longest signal whose ring fits a block");

// One warp a block, as D3's (condat.cu): the signal is blockIdx.x, so the
// chain's branches need no reconvergence barrier.
template <class T>
__global__ void __launch_bounds__(32)
classic_ts_warp_kernel(const T* __restrict__ y, LamT<T> lam,
                       T* __restrict__ x, int n, long long cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  unsigned char* base = smem;
  Slot<T>* w = reinterpret_cast<Slot<T>*>(base);
  const Deque<T> maj{w, 1}, mnr{w + n + 2, 1};
  T* ys = reinterpret_cast<T*>(w + 2 * (n + 2));
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
  const int icap = cap < INT_MAX ? (int)cap : INT_MAX;  // at most 8n + 64
  classic_scan<true>(yv, l, n, icap, maj, mnr, [&](int p, T v) {
    ys[p] = v;
    mk[head + p] = 1;
  });
  __syncwarp();
  direct1d::warp_forward_fill(mk, yv, n, xb, lane);
}

template <class T>
__global__ void __launch_bounds__(64)
classic_ts_kernel(const T* __restrict__ y, LamT<T> lam, T* __restrict__ x,
                  Slot<T>* __restrict__ ws, int B, int n, long long cap) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T* __restrict__ yb = y + (size_t)b * n;
  T* __restrict__ xb = x + (size_t)b * n;
  if (direct1d::degenerate(yb, lam, b, n, xb)) return;
  Slot<T>* w = ws + b;
  const Deque<T> maj{w, (size_t)B}, mnr{w + ((size_t)n + 2) * B, (size_t)B};
  int cp = 0;  // the current run's start and value
  T cv = T(0);
  auto emit = [&](int p, T v) {
    direct1d::fill(xb, cp, p, cv, 0, 1);
    cp = p;
    cv = v;
  };
  auto yv = [&](int i) { return __ldg(yb + i); };
  if (sizeof(T) == 8 || n < (1 << 24))
    classic_scan<true>(yv, lam(b, 0), n, cap, maj, mnr, emit);
  else
    classic_scan<false>(yv, lam(b, 0), n, cap, maj, mnr, emit);
  direct1d::fill(xb, cp, n, cv, 0, 1);
}

// A float64 signal's warp, after its deques are laid out: as
// classic_ts_warp_kernel.
template <class Q>
__device__ __forceinline__ void warp64_signal(const double* __restrict__ y,
                                              const LamT<double>& lam,
                                              double* __restrict__ x, int n,
                                              long long cap, Q maj, Q mnr,
                                              double* ys, unsigned char* mk,
                                              int lane, int b) {
  double* __restrict__ xb = x + (size_t)b * n;
  direct1d::stage_row(y + (size_t)b * n, n, ys, lane);
  direct1d::zero_bytes(mk, direct1d::mark_bytes(n), lane);
  __syncwarp();
  const double l = lam(b, 0);
  auto yv = [&](int i) { return ys[i]; };
  if (direct1d::warp_degenerate(yv, [&](int) { return l; }, n, xb, lane))
    return;
  const int head = direct1d::mark_head(xb);
  const int icap = cap < INT_MAX ? (int)cap : INT_MAX;  // at most 8n + 64
  classic_scan<true>(yv, l, n, icap, maj, mnr, [&](int p, double val) {
    if (p < n) {  // a ring's overflowed run emits anything
      ys[p] = val;
      mk[head + p] = 1;
    }
  });
  __syncwarp();
  direct1d::warp_forward_fill(mk, yv, n, xb, lane);
}

// One warp a block, as classic_ts_warp_kernel, in float64: the warp
// layout (each deque's n + 2 slots in shared memory) or the ring layout
// (each deque a Ring64; a signal that overflows one runs again with its
// deques in the workspace ws, signal b's (iy, slope) pairs at
// [2 (n + 2) b, 2 (n + 2) (b + 1)) of its first 32 (n + 2) B bytes, its ix
// at the same indices of the ints after them).
template <bool kRingLayout>
__global__ void __launch_bounds__(32)
classic_ts_warp64_kernel(const double* __restrict__ y, LamT<double> lam,
                         double* __restrict__ x, unsigned char* ws, int B,
                         int n, long long cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  double2* v = reinterpret_cast<double2*>(smem);
  unsigned char* mk =
      smem + warp_smem64(n, kRingLayout) - direct1d::mark_bytes(n);
  if constexpr (kRingLayout) {
    int* ix = reinterpret_cast<int*>(v + 2 * kRing);
    int* over = ix + 2 * kRing;
    double* ys = reinterpret_cast<double*>(smem + 40 * kRing + 16);
    *over = 0;
    warp64_signal(y, lam, x, n, cap, Ring64{v, ix, over},
                  Ring64{v + kRing, ix + kRing, over}, ys, mk, lane, b);
    __syncwarp();
    if (*over) {
      const size_t s = (size_t)n + 2;
      double2* gv = reinterpret_cast<double2*>(ws);
      int* gix = reinterpret_cast<int*>(gv + 2 * s * B) + 2 * s * b;
      gv += 2 * s * b;
      __syncwarp();
      warp64_signal(y, lam, x, n, cap, Deque64{gv, gix, 1},
                    Deque64{gv + s, gix + s, 1}, ys, mk, lane, b);
    }
  } else {
    double* ys = reinterpret_cast<double*>(v + 2 * (n + 2));
    int* ix = reinterpret_cast<int*>(ys + n);
    warp64_signal(y, lam, x, n, cap, Deque64{v, ix, 1},
                  Deque64{v + n + 2, ix + n + 2, 1}, ys, mk, lane, b);
  }
}

// One thread a signal, as classic_ts_kernel, in float64: the deques in the
// workspace ws, interleaved by signal, (iy, slope) pairs in its first
// 32 (n + 2) B bytes and ix in the ints after them.
__global__ void __launch_bounds__(64)
classic_ts_thread64_kernel(const double* __restrict__ y, LamT<double> lam,
                           double* __restrict__ x, unsigned char* ws, int B,
                           int n, long long cap) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const double* __restrict__ yb = y + (size_t)b * n;
  double* __restrict__ xb = x + (size_t)b * n;
  if (direct1d::degenerate(yb, lam, b, n, xb)) return;
  const size_t s = ((size_t)n + 2) * B;
  double2* v = reinterpret_cast<double2*>(ws);
  int* ix = reinterpret_cast<int*>(v + 2 * s) + b;
  v += b;
  const Deque64 maj{v, ix, (size_t)B}, mnr{v + s, ix + s, (size_t)B};
  int cp = 0;  // the current run's start and value
  double cv = 0.0;
  auto emit = [&](int p, double val) {
    direct1d::fill(xb, cp, p, cv, 0, 1);
    cp = p;
    cv = val;
  };
  auto yv = [&](int i) { return __ldg(yb + i); };
  classic_scan<true>(yv, lam(b, 0), n, cap, maj, mnr, emit);
  direct1d::fill(xb, cp, n, cv, 0, 1);
}

template <class T>
int run(const T* y, const T* lam, int lam_rs, T lam_s, T* x, void* ws, int B,
        int n, long long cap, cudaStream_t stream) {
  if (B <= 0) return 0;
  const LamT<T> l{lam, (size_t)lam_rs, 0, lam_s};
  if (n <= kWarpMaxN<T>) {
    const cudaError_t e = cudaFuncSetAttribute(
        classic_ts_warp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        direct1d::kMaxBlockSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    classic_ts_warp_kernel<T><<<B, 32, warp_smem<T>(n), stream>>>(y, l, x, n,
                                                                  cap);
    return static_cast<int>(cudaGetLastError());
  }
  if (!ws) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 64;
  classic_ts_kernel<T><<<(B + threads - 1) / threads, threads, 0, stream>>>(
      y, l, x, static_cast<Slot<T>*>(ws), B, n, cap);
  return static_cast<int>(cudaGetLastError());
}

int run64(const double* y, const double* lam, int lam_rs, double lam_s,
          double* x, void* ws, int B, int n, long long cap,
          cudaStream_t stream) {
  if (B <= 0) return 0;
  const LamT<double> l{lam, (size_t)lam_rs, 0, lam_s};
  unsigned char* w = static_cast<unsigned char*>(ws);
  if (n > kWarpMaxN64 && !ws) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= kRingMaxN64) {
    const bool ring = n > kWarpMaxN64;
    const size_t smem = warp_smem64(n, ring);
    const cudaError_t e = cudaFuncSetAttribute(
        ring ? classic_ts_warp64_kernel<true>
             : classic_ts_warp64_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, direct1d::kMaxBlockSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (ring)
      classic_ts_warp64_kernel<true><<<B, 32, smem, stream>>>(y, l, x, w, B,
                                                              n, cap);
    else
      classic_ts_warp64_kernel<false><<<B, 32, smem, stream>>>(y, l, x, w, B,
                                                               n, cap);
    return static_cast<int>(cudaGetLastError());
  }
  const int threads = 64;
  classic_ts_thread64_kernel<<<(B + threads - 1) / threads, threads, 0,
                               stream>>>(y, l, x, w, B, n, cap);
  return static_cast<int>(cudaGetLastError());
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
  return run<float>(y, lam, lam_rs, lam_s, x, ws, B, n, cap, stream);
}

extern "C" int classic_ts_tv1(const float* y, const float* lam, int lam_rs,
                              float lam_s, float* x, void* ws, int B, int n,
                              cudaStream_t stream) {
  return run<float>(y, lam, lam_rs, lam_s, x, ws, B, n, 8LL * n + 64, stream);
}

// The same in float64: y, x and lam double; ws (n >
// classic_ts_warp_max_n_f64(); NULL otherwise) 40 (n + 2) B bytes, two
// deques of (n + 2) x B slots, (iy, slope) pairs then ix.
extern "C" int classic_ts_tv1_f64_capped(const double* y, const double* lam,
                                         int lam_rs, double lam_s, double* x,
                                         void* ws, int B, int n,
                                         long long cap, cudaStream_t stream) {
  return run64(y, lam, lam_rs, lam_s, x, ws, B, n, cap, stream);
}

extern "C" int classic_ts_tv1_f64(const double* y, const double* lam,
                                  int lam_rs, double lam_s, double* x,
                                  void* ws, int B, int n,
                                  cudaStream_t stream) {
  return run64(y, lam, lam_rs, lam_s, x, ws, B, n, 8LL * n + 64, stream);
}

// The longest signal the warp layout takes (the layouts' threshold), in
// float32 and in float64, and the longest float64 signal of the ring
// layout (past it the thread layout).
extern "C" int classic_ts_warp_max_n() { return kWarpMaxN<float>; }
extern "C" int classic_ts_warp_max_n_f64() { return kWarpMaxN64; }
extern "C" int classic_ts_ring_max_n_f64() { return kRingMaxN64; }
