// Kernel B1: the whole weighted TV-L1 projected-Newton prox per fiber,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel proxtv_tpu/ops/kernels/pn_fused.py:pn_tv1_fused
// (its pallas_calls at :385 / :390, body _make_kernel :137-319).  For each
// row y of a (B, n) float32 batch it solves
//     min_x 0.5 ||x - y||^2 + sum_i lam_i |x_{i+1} - x_i|
// on the dual: centering, the closed-form double-prefix-sum dual init (or a
// warm start), the inactive-set Newton loop with normalized masked PCR (a
// head of `head_steps` steps, the full-depth tail only in exact mode), the
// halving projected line search (delta = 1, then 3 + (max_armijo - 4)
// halvings) with the cancellation-free improvement, the relative duality-gap
// stop with stall promotion to exact mode, and the degenerate guards.
//
// What bounds it on this card: device traffic is one read of y (+ lam, w0)
// and one write of x (+ w) — 8 MB for a (1024, 1024) sweep — so the bytes
// bound is a few microseconds; the work is ~100 flops per element per
// Newton iteration times the iterations the data needs.  A fiber's solve is
// a chain of row sums and neighbour exchanges, so it is latency-bound: the
// design keeps the chain short and many fibers in flight.
//
// Design: every fiber stops on its own, so the TPU kernel's tile-wide
// decisions (PCR tail, line-search fallback, deep search: max/min over a
// tile of rows) become per-fiber decisions.  A thread owns a contiguous
// chunk of E elements held in registers (the solver state y, lam, w, g, x,
// mask, direction, line-search candidates); lanes past n are zero and
// decoupled, exactly like the TPU kernel's lane padding.  One solver body
// (pn_solve) runs on two thread groups:
//
// * n <= 256: one warp per fiber (WarpGroup), FPB fibers per block.  Row
//   sums are warp butterflies, neighbour values and PCR strides are
//   shuffles; the solve has no barrier and no shared memory.
// * n > 256: one block per fiber (BlockGroup).  Each row sum, neighbour
//   exchange, PCR step and prefix scan crosses warps through one barrier:
//   warp partials and warp-edge values go to double-buffered shared slots
//   (the buffer alternates per use, so a slot is written again only after
//   the next use's barrier, and no leading barrier is needed).
//
// Sums of one pass share one crossing (the gap, the objective and the
// scale at init; the mask count with the mask exchange; the directional
// derivative with the first trial's exchange).  One exchange of a chunk's
// first and last element gives both neighbours, and the next chunk's first
// primal value is rebuilt from it with the neighbour's own operations, so
// the new gradient needs no exchange.  On the usual path (head_steps = 4,
// the first trial accepted) a Newton iteration crosses 8 times and the cold
// init 5 times (the block group's barriers; the warp group has none).
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "block.cuh"

namespace {

constexpr float kEps = 1e-10f;
constexpr unsigned kFull = 0xffffffffu;

template <int OP>
__device__ __forceinline__ float ident() {
  return OP == kSum ? 0.f : (OP == kMax ? -inf_f() : inf_f());
}

// Butterfly each of v[0..] by its own operation (every lane gets the same
// bits).
template <int OP, int... REST>
__device__ __forceinline__ void warp_reduce_each(float* v) {
  v[0] = warp_reduce<OP>(v[0]);
  if constexpr (sizeof...(REST) > 0) warp_reduce_each<REST...>(v + 1);
}

// Every warp reduces the per-warp partials s[i * 32 + w] in the same order.
template <int OP, int... REST>
__device__ __forceinline__ void reduce_partials(float* v, const float* s,
                                                int lane, int nwarps) {
  v[0] = warp_reduce<OP>(lane < nwarps ? s[lane] : ident<OP>());
  if constexpr (sizeof...(REST) > 0)
    reduce_partials<REST...>(v + 1, s + 32, lane, nwarps);
}

constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

// One PCR step at stride S (pn_fused.py:40-101 step) for one element, from
// its b, c, d and those at j - S (m) and j + S (p), 0 outside the row.
__device__ __forceinline__ void pcr_update(float b, float c, float d,
                                           float bm, float cm, float dm,
                                           float bp, float cp, float dp,
                                           float& bo, float& co, float& dout) {
  const float r = 1.f / (1.f - b * cm - c * bp);
  dout = (d - b * dm - c * dp) * r;
  bo = (-b * bm) * r;
  co = (-c * cp) * r;
}

// Neighbours at distance S inside a warp whose lanes hold 32 E consecutive
// elements: for S < E from the thread's own registers or those of lane +-1,
// for S >= E register k of lane +- S/E.  Values past the warp's ends read 0.
// `edge(k, lo, bm, cm, dm)` may replace the values of element k that lie
// across the warp's start (lo) or end (!lo).
template <int E, int S, class Edge>
__device__ __forceinline__ void warp_pcr_step(float (&b)[E], float (&c)[E],
                                              float (&d)[E], int lane,
                                              Edge edge) {
  if constexpr (S < E) {
    float pb[S], pc[S], pd[S], nb[S], nc[S], nd[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      pb[i] = __shfl_up_sync(kFull, b[E - S + i], 1);
      pc[i] = __shfl_up_sync(kFull, c[E - S + i], 1);
      pd[i] = __shfl_up_sync(kFull, d[E - S + i], 1);
      nb[i] = __shfl_down_sync(kFull, b[i], 1);
      nc[i] = __shfl_down_sync(kFull, c[i], 1);
      nd[i] = __shfl_down_sync(kFull, d[i], 1);
      if (lane == 0) pb[i] = pc[i] = pd[i] = 0.f;
      if (lane == 31) nb[i] = nc[i] = nd[i] = 0.f;
      if (lane == 0) edge(i, true, pb[i], pc[i], pd[i]);
      if (lane == 31) edge(E - S + i, false, nb[i], nc[i], nd[i]);
    }
    // New values into fresh arrays: element k still reads the old ones.
    float b2[E], c2[E], d2[E];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int km = k >= S ? k - S : 0, kp = k + S < E ? k + S : 0;
      const int im = k < S ? k : 0, ip = k + S >= E ? k + S - E : 0;
      pcr_update(b[k], c[k], d[k], k >= S ? b[km] : pb[im],
                 k >= S ? c[km] : pc[im], k >= S ? d[km] : pd[im],
                 k + S < E ? b[kp] : nb[ip], k + S < E ? c[kp] : nc[ip],
                 k + S < E ? d[kp] : nd[ip], b2[k], c2[k], d2[k]);
    }
#pragma unroll
    for (int k = 0; k < E; ++k) {
      b[k] = b2[k];
      c[k] = c2[k];
      d[k] = d2[k];
    }
  } else {
    constexpr int L = S / E;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      // Every lane shuffles register k before any lane updates it.
      float bm = __shfl_up_sync(kFull, b[k], L);
      float cm = __shfl_up_sync(kFull, c[k], L);
      float dm = __shfl_up_sync(kFull, d[k], L);
      float bp = __shfl_down_sync(kFull, b[k], L);
      float cp = __shfl_down_sync(kFull, c[k], L);
      float dp = __shfl_down_sync(kFull, d[k], L);
      if (lane < L) {
        bm = cm = dm = 0.f;
        edge(k, true, bm, cm, dm);
      }
      if (lane >= 32 - L) {
        bp = cp = dp = 0.f;
        edge(k, false, bp, cp, dp);
      }
      pcr_update(b[k], c[k], d[k], bm, cm, dm, bp, cp, dp, b[k], c[k], d[k]);
    }
  }
}

// Prefix sums of a warp's 32 E elements: sequential inside the thread (p
// becomes the thread's inclusive sums), then a Hillis-Steele scan of the
// thread totals.  Returns the warp's inclusive sum at this lane; `excl` is
// the warp's sum before this lane's chunk.  This is another summation order
// than the TPU kernel's log-shift, which moves only roundings.
template <int E>
__device__ __forceinline__ float warp_scan(float (&p)[E], int lane,
                                           float& excl) {
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    run += p[k];
    p[k] = run;
  }
  float inc = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += t;
  }
  excl = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) excl = 0.f;
  return inc;
}

// ---------------------------------------------------------------------------
// One warp per fiber: 32 lanes x E elements, no shared memory, no barrier.
template <int E_>
struct WarpGroup {
  static constexpr int E = E_;
  static constexpr int kMaxSteps = ilog2(32 * E_);
  int lane;

  __device__ int rank() const { return lane; }

  template <int... OPS>
  __device__ __forceinline__ void reduce(float (&v)[sizeof...(OPS)]) {
    warp_reduce_each<OPS...>(v);
  }

  // The previous chunk's last element and the next chunk's first (0 past
  // the row's ends).
  __device__ __forceinline__ void exchange(float first, float last,
                                           float& prev_last,
                                           float& next_first) {
    prev_last = __shfl_up_sync(kFull, last, 1);
    next_first = __shfl_down_sync(kFull, first, 1);
    if (lane == 0) prev_last = 0.f;
    if (lane == 31) next_first = 0.f;
  }

  template <int... OPS>
  __device__ __forceinline__ void reduce_exchange(
      float (&v)[sizeof...(OPS)], float first, float last, float& prev_last,
      float& next_first) {
    reduce<OPS...>(v);
    exchange(first, last, prev_last, next_first);
  }

  // Inclusive prefix sum of the row in p; `excl` is the sum before this
  // chunk, `total` the row's sum.
  __device__ __forceinline__ void scan(float (&p)[E], float& excl,
                                       float& total) {
    const float inc = warp_scan(p, lane, excl);
    total = __shfl_sync(kFull, inc, 31);
#pragma unroll
    for (int k = 0; k < E; ++k) p[k] += excl;
  }

  template <int S>
  __device__ __forceinline__ void pcr_step(float (&b)[E], float (&c)[E],
                                           float (&d)[E]) {
    warp_pcr_step<E, S>(b, c, d, lane,
                        [](int, bool, float&, float&, float&) {});
  }
};

// ---------------------------------------------------------------------------
// One block per fiber: each crossing between warps is one barrier on
// double-buffered shared memory.
constexpr int kSlot = 8 * 32;  // six reduced values, first and last per warp

template <int E_, int MAXT>
struct BlockGroup {
  static constexpr int E = E_;
  static constexpr int kMaxSteps = ilog2(MAXT * E_);
  int lane, wid, nwarps, nw;  // nw = elements in the block's row
  float* slots;               // 2 x kSlot
  float* pcr;                 // 2 x 3 x nw
  int ph = 0, pp = 0;         // buffer parities (block-uniform)

  __device__ int rank() const { return threadIdx.x; }

  __device__ __forceinline__ float* slot() {
    float* s = slots + (ph & 1) * kSlot;
    ++ph;
    return s;
  }

  template <int... OPS>
  __device__ __forceinline__ void reduce(float (&v)[sizeof...(OPS)]) {
    constexpr int N = sizeof...(OPS);
    warp_reduce_each<OPS...>(v);
    float* s = slot();
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) s[i * 32 + wid] = v[i];
    }
    __syncthreads();
    reduce_partials<OPS...>(v, s, lane, nwarps);
  }

  template <int... OPS>
  __device__ __forceinline__ void reduce_exchange(
      float (&v)[sizeof...(OPS)], float first, float last, float& prev_last,
      float& next_first) {
    constexpr int N = sizeof...(OPS);
    warp_reduce_each<OPS...>(v);
    prev_last = __shfl_up_sync(kFull, last, 1);
    next_first = __shfl_down_sync(kFull, first, 1);
    float* s = slot();
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) s[i * 32 + wid] = v[i];
      s[6 * 32 + wid] = first;
    }
    if (lane == 31) s[7 * 32 + wid] = last;
    __syncthreads();
    reduce_partials<OPS...>(v, s, lane, nwarps);
    if (lane == 0) prev_last = wid > 0 ? s[7 * 32 + wid - 1] : 0.f;
    if (lane == 31) next_first = wid + 1 < nwarps ? s[6 * 32 + wid + 1] : 0.f;
  }

  __device__ __forceinline__ void exchange(float first, float last,
                                           float& prev_last,
                                           float& next_first) {
    prev_last = __shfl_up_sync(kFull, last, 1);
    next_first = __shfl_down_sync(kFull, first, 1);
    float* s = slot();
    if (lane == 0) s[6 * 32 + wid] = first;
    if (lane == 31) s[7 * 32 + wid] = last;
    __syncthreads();
    if (lane == 0) prev_last = wid > 0 ? s[7 * 32 + wid - 1] : 0.f;
    if (lane == 31) next_first = wid + 1 < nwarps ? s[6 * 32 + wid + 1] : 0.f;
  }

  // As WarpGroup::scan, then the warp totals cross through shared memory
  // (one barrier); every thread adds them in the same order.
  __device__ __forceinline__ void scan(float (&p)[E], float& excl,
                                       float& total) {
    float wex;
    const float inc = warp_scan(p, lane, wex);
    float* s = slot();
    if (lane == 31) s[wid] = inc;
    __syncthreads();
    float before = 0.f;
    total = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      const float t = s[w];
      if (w < wid) before += t;
      total += t;
    }
    excl = before + wex;
#pragma unroll
    for (int k = 0; k < E; ++k) p[k] += excl;
  }

  // Strides shorter than a warp's 32 E elements: shuffles inside the warp,
  // and only the elements within S of a warp's ends cross through shared
  // memory.  Longer strides (the exact-mode tail): the whole row.  Either
  // way one barrier (the buffer alternates per step).
  template <int S>
  __device__ __forceinline__ void pcr_step(float (&b)[E], float (&c)[E],
                                           float (&d)[E]) {
    float* sb = pcr + (pp & 1) * 3 * nw;
    ++pp;
    float* sc = sb + nw;
    float* sd = sc + nw;
    const int j0 = threadIdx.x * E;
    if constexpr (S < 32 * E) {
      constexpr int EL = (S + E - 1) / E;
      if (lane < EL || lane >= 32 - EL) {
#pragma unroll
        for (int k = 0; k < E; ++k) {
          sb[j0 + k] = b[k];
          sc[j0 + k] = c[k];
          sd[j0 + k] = d[k];
        }
      }
      __syncthreads();
      const int nwr = nw;
      warp_pcr_step<E, S>(
          b, c, d, lane,
          [&](int k, bool lo, float& vb, float& vc, float& vd) {
            const int j = j0 + k + (lo ? -S : S);
            if (lo ? j >= 0 : j < nwr) {
              vb = sb[j];
              vc = sc[j];
              vd = sd[j];
            }
          });
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k) {
        sb[j0 + k] = b[k];
        sc[j0 + k] = c[k];
        sd[j0 + k] = d[k];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int j = j0 + k;
        const bool lo = j - S >= 0, hi = j + S < nw;
        pcr_update(b[k], c[k], d[k], lo ? sb[j - S] : 0.f,
                   lo ? sc[j - S] : 0.f, lo ? sd[j - S] : 0.f,
                   hi ? sb[j + S] : 0.f, hi ? sc[j + S] : 0.f,
                   hi ? sd[j + S] : 0.f, b[k], c[k], d[k]);
      }
    }
  }
};

// The first `nsteps` PCR steps, at strides 1, 2, 4, ...: unrolled over the
// group's compile-time bound so every register index is a constant.
template <int ST, class G, int E>
__device__ __forceinline__ void pcr_steps(G& g, float (&b)[E], float (&c)[E],
                                          float (&d)[E], int nsteps) {
  if constexpr (ST < G::kMaxSteps) {
    if (ST < nsteps) {
      g.template pcr_step<(1 << ST)>(b, c, d);
      pcr_steps<ST + 1>(g, b, c, d, nsteps);
    }
  }
}

// One line-search trial at step `delta`, after its exchange: candidate dual
// aux, primal xn, the next chunk's first candidate primal, and the
// cancellation-free objective improvement -(x.dx + 0.5 dx.dx).
template <class G, int E>
__device__ __forceinline__ float trial(G& g, const float (&x)[E],
                                       const float (&dw)[E], float dwprev0,
                                       float dwnext0, float xnext,
                                       float (&xn)[E], float& xn_next) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const float dx = dw[k] - (k > 0 ? dw[k - 1] : dwprev0);
    xn[k] = x[k] + dx;
    s += x[k] * dx + 0.5f * dx * dx;
  }
  // The next chunk's xn[0], with its own operations.
  xn_next = xnext + (dwnext0 - dw[E - 1]);
  float r[1] = {s};
  g.template reduce<kSum>(r);
  return -r[0];
}

template <int E>
__device__ __forceinline__ void trial_dual(float delta, const float (&w)[E],
                                           const float (&d)[E],
                                           const float (&m)[E],
                                           const float (&lam)[E],
                                           float (&aux)[E], float (&dw)[E]) {
#pragma unroll
  for (int k = 0; k < E; ++k) {
    aux[k] = m[k] > 0.f ? fminf(fmaxf(w[k] - delta * d[k], -lam[k]), lam[k])
                        : w[k];
    dw[k] = aux[k] - w[k];
  }
}

template <class G>
__device__ __forceinline__ void pn_solve(
    G& g, const float* __restrict__ Y, const float* __restrict__ LAM,
    float lam_scalar, const float* __restrict__ W0, float* __restrict__ X,
    float* __restrict__ WO, int* __restrict__ ITERS, int fiber, int n,
    int max_iters, int max_armijo, float sigma, float stop_rel,
    float tol_eps, int head_steps) {
  constexpr int E = G::E;
  const int j0 = g.rank() * E;
  const size_t base = static_cast<size_t>(fiber) * n;

  float y[E], lam[E], v[E], w[E], gr[E], x[E];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = j0 + k;
    y[k] = j < n ? Y[base + j] : 0.f;
    v[k] = j < n - 1 ? 1.f : 0.f;
    s += y[k];
  }
  // Center (translation equivariance); lanes past n stay zero.  The raw
  // first value of the next chunk crosses with the sum and is centered
  // here as its owner centers it.
  float ynext0;
  {
    float r[1] = {s};
    float unused;
    g.template reduce_exchange<kSum>(r, y[0], y[E - 1], unused, ynext0);
    s = r[0];
  }
  const float ybar = s / static_cast<float>(n);
  ynext0 = (ynext0 - ybar) * (j0 + E < n ? 1.f : 0.f);
  float yy = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = j0 + k;
    y[k] = (y[k] - ybar) * (j < n ? 1.f : 0.f);
    yy += y[k] * y[k];
    const float l = LAM != nullptr ? (j < n ? LAM[base + j] : 0.f) : lam_scalar;
    lam[k] = l * v[k];
  }
  float dymax = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k)
    dymax = fmaxf(dymax,
                  fabsf(((k + 1 < E ? y[k + 1] : ynext0) - y[k]) * v[k]));

  if (W0 != nullptr) {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int j = j0 + k;
      const float w0 = (j < n ? W0[base + j] : 0.f) * v[k];
      w[k] = fminf(fmaxf(w0, -lam[k]), lam[k]);
    }
  } else {
    // Closed-form unconstrained dual: w_j = S_m (j+1)/n - S_{j-1},
    // S = prefix(prefix(dy)) (pn_fused.py:119-134); S_m is the second
    // scan's total and S_{j0-1} the sum before this chunk.
    float p[E];
#pragma unroll
    for (int k = 0; k < E; ++k)
      p[k] = ((k + 1 < E ? y[k + 1] : ynext0) - y[k]) * v[k];
    float excl, sm_tot;
    g.scan(p, excl, sm_tot);
#pragma unroll
    for (int k = 0; k < E; ++k) p[k] *= v[k];
    g.scan(p, excl, sm_tot);
    const float inv_n = static_cast<float>(1.0 / static_cast<double>(n));
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const float sp = k > 0 ? p[k - 1] : excl;
      const float idx = static_cast<float>(j0 + k + 1);
      const float w0 = (sm_tot * idx * inv_n - sp) * v[k];
      w[k] = fminf(fmaxf(w0, -lam[k]), lam[k]);
    }
  }

  // x = y + D'w, g = Dx (masked).  One exchange of w gives both neighbours;
  // xnext is the next chunk's x[0], as it computes it.
  float xnext;
  {
    float wprev0, wnext0;
    g.exchange(w[0], w[E - 1], wprev0, wnext0);
#pragma unroll
    for (int k = 0; k < E; ++k)
      x[k] = y[k] + (w[k] - (k > 0 ? w[k - 1] : wprev0));
    xnext = ynext0 + (wnext0 - w[E - 1]);
#pragma unroll
    for (int k = 0; k < E; ++k)
      gr[k] = (x[k] - (k + 1 < E ? x[k + 1] : xnext)) * v[k];
  }
  // One crossing: the objective, the gap, the scale, and the degenerate
  // guards' min / sum of lam and max |dy|.
  float fval, gap, scale, lmin, lsum;
  {
    float r[6] = {0.f, 0.f, yy, inf_f(), 0.f, dymax};
#pragma unroll
    for (int k = 0; k < E; ++k) {
      r[0] += x[k] * x[k];
      r[1] += fabsf(gr[k]) * lam[k] + w[k] * gr[k];
      if (v[k] > 0.f) r[3] = fminf(r[3], lam[k]);
      r[4] += lam[k];
    }
    g.template reduce<kSum, kSum, kSum, kMin, kSum, kMax>(r);
    fval = r[0] * 0.5f;
    gap = fabsf(r[1]);
    scale = fmaxf(1.f, r[2] * 0.5f);
    lmin = r[3];
    lsum = r[4];
    dymax = r[5];
  }
  const float tol = fmaxf(stop_rel, (tol_eps * FLT_EPSILON) * scale);
  const float eps_f = fmaxf(kEps, (10.f * FLT_EPSILON) * scale);
  const float eps_gap = fmaxf(kEps, (50.f * FLT_EPSILON) * scale);

  int steps = 0;
  while ((1 << steps) < n) ++steps;
  bool running = gap > tol;
  bool mode = false;  // exact-direction mode (full-depth PCR tail)
  float gap_prev = -inf_f();
  int it = 0;
  float m[E], d[E], aux[E], xn[E], dw[E];
  while (running && it < max_iters) {
    float msum = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const bool in = lam[k] > 0.f &&
                      ((w[k] > -lam[k] && w[k] < lam[k]) ||
                       (w[k] == -lam[k] && gr[k] < -kEps) ||
                       (w[k] == lam[k] && gr[k] > kEps));
      m[k] = (in ? 1.f : 0.f) * v[k];
      msum += m[k];
    }
    // Normalized masked PCR (pn_fused.py:40-101): solves the m-masked
    // second-difference system with right-hand side g*m; identity on
    // masked-out rows.  The mask count crosses with the mask's neighbours.
    bool any_inact;
    {
      float r[1] = {msum};
      float mprev0, mnext0;
      g.template reduce_exchange<kSum>(r, m[0], m[E - 1], mprev0, mnext0);
      any_inact = r[0] > 0.f;
      float b[E], c[E];
#pragma unroll
      for (int k = 0; k < E; ++k)
        b[k] = -(m[k] * (k > 0 ? m[k - 1] : mprev0));
      const float bnext0 = -(mnext0 * m[E - 1]);  // the next chunk's b[0]
#pragma unroll
      for (int k = 0; k < E; ++k) {
        c[k] = k + 1 < E ? b[k + 1] : bnext0;
        const float rr = 1.f / (1.f + m[k]);
        b[k] = b[k] * rr;
        c[k] = c[k] * rr;
        d[k] = (m[k] * (gr[k] * m[k])) * rr;
      }
      pcr_steps<0>(g, b, c, d, mode ? steps : min(max(head_steps, 0), steps));
    }
    float grd = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      d[k] *= m[k];
      grd += gr[k] * d[k] * m[k];
    }

    // delta = 1 is the exact minimizer of the reduced quadratic; the halving
    // fallback runs only when clipping broke the Armijo test.  The first
    // trial's exchange carries the directional derivative's sum.
    float gRd, imp1, xn_next;
    trial_dual<E>(1.f, w, d, m, lam, aux, dw);
    {
      float r[1] = {grd};
      float dwprev0, dwnext0;
      g.template reduce_exchange<kSum>(r, dw[0], dw[E - 1], dwprev0, dwnext0);
      gRd = r[0];
      imp1 = trial(g, x, dw, dwprev0, dwnext0, xnext, xn, xn_next);
    }
    // The search stops at the first accepted trial, so aux / xn hold it;
    // without one the step keeps w and x.
    bool found = imp1 >= sigma * gRd || imp1 <= eps_f;
    float f_new = found ? fval - imp1 : fval;
    if (!found) {
      float delta = 0.5f;
      const int stages[2] = {3, max_armijo - 4};
      for (int st = 0; st < 2 && !found; ++st) {
        if (st == 1) delta = 0.0625f;
        for (int i = 0; i < stages[st] && !found; ++i, delta *= 0.5f) {
          trial_dual<E>(delta, w, d, m, lam, aux, dw);
          float dwprev0, dwnext0;
          g.exchange(dw[0], dw[E - 1], dwprev0, dwnext0);
          const float imp =
              trial(g, x, dw, dwprev0, dwnext0, xnext, xn, xn_next);
          if (imp >= (sigma * delta) * gRd || imp <= eps_f) {
            found = true;
            f_new = fval - imp;
          }
        }
      }
    }
    if (!found) {
#pragma unroll
      for (int k = 0; k < E; ++k) {
        aux[k] = w[k];
        xn[k] = x[k];
      }
      xn_next = xnext;
    }

    // The new gradient: the next chunk's first candidate primal is known,
    // so no exchange.
    float gn[E];
    float gsum = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      gn[k] = (xn[k] - (k + 1 < E ? xn[k + 1] : xn_next)) * v[k];
      gsum += fabsf(gn[k]) * lam[k] + aux[k] * gn[k];
    }
    float gap_new;
    {
      float r[1] = {gsum};
      g.template reduce<kSum>(r);
      gap_new = fabsf(r[0]);
    }
    float gap_prev_out = gap_prev;
    if (any_inact) {  // act = running & any_inact, running holds here
#pragma unroll
      for (int k = 0; k < E; ++k) {
        w[k] = aux[k];
        x[k] = xn[k];
        gr[k] = gn[k];
      }
      xnext = xn_next;
      fval = f_new;
      gap_prev_out = gap;
      gap = gap_new;
    }
    ++it;
    // A stalled fiber is promoted to exact-direction mode; one that stalls
    // while already exact stops (RC_STUCK).
    const bool stuck = gap > tol && fabsf(gap - gap_prev_out) <= eps_gap;
    running = any_inact && gap > tol && !(stuck && mode);
    mode = mode || (stuck && running);
    gap_prev = gap_prev_out;
  }

  // Degenerate guards: zero penalty -> identity; enormous penalty -> mean.
  // The centered y is read again rather than kept live through the loop.
  const bool allz = lsum <= 0.f;
  const bool huge = lmin >= (static_cast<float>(n) * static_cast<float>(n)) * dymax;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = j0 + k;
    if (j < n) {
      float xo = huge ? 0.f : x[k];
      xo = allz ? Y[base + j] - ybar : xo;
      X[base + j] = xo + ybar;
      if (WO != nullptr) WO[base + j] = w[k] * v[k];
    }
  }
  if (ITERS != nullptr && g.rank() == 0) ITERS[fiber] = it;
}

// n <= 32 E: one warp per fiber, FPB fibers per block.
template <int E, int FPB>
__global__ void __launch_bounds__(32 * FPB)
pn_warp_kernel(const float* __restrict__ Y, const float* __restrict__ LAM,
               float lam_scalar, const float* __restrict__ W0,
               float* __restrict__ X, float* __restrict__ WO,
               int* __restrict__ ITERS, int B, int n, int max_iters,
               int max_armijo, float sigma, float stop_rel, float tol_eps,
               int head_steps) {
  const int fiber = blockIdx.x * FPB + (threadIdx.x >> 5);
  if (fiber >= B) return;  // a whole warp, before its first shuffle
  WarpGroup<E> g{static_cast<int>(threadIdx.x & 31)};
  pn_solve(g, Y, LAM, lam_scalar, W0, X, WO, ITERS, fiber, n, max_iters,
           max_armijo, sigma, stop_rel, tol_eps, head_steps);
}

// n > 256: one block per fiber.
template <int E, int MAXT>
__global__ void __launch_bounds__(MAXT)
pn_block_kernel(const float* __restrict__ Y, const float* __restrict__ LAM,
                float lam_scalar, const float* __restrict__ W0,
                float* __restrict__ X, float* __restrict__ WO,
                int* __restrict__ ITERS, int n, int max_iters, int max_armijo,
                float sigma, float stop_rel, float tol_eps, int head_steps) {
  extern __shared__ float sm[];
  BlockGroup<E, MAXT> g;
  g.lane = threadIdx.x & 31;
  g.wid = threadIdx.x >> 5;
  g.nwarps = blockDim.x >> 5;
  g.nw = blockDim.x * E;
  g.slots = sm;
  g.pcr = sm + 2 * kSlot;
  pn_solve(g, Y, LAM, lam_scalar, W0, X, WO, ITERS, blockIdx.x, n, max_iters,
           max_armijo, sigma, stop_rel, tol_eps, head_steps);
}

struct Args {
  const float *y, *lam;
  float lam_scalar;
  const float* w0;
  float *x, *w;
  int* iters;
  int B, n, max_iters, max_armijo;
  float sigma, stop_rel, tol_eps;
  int head_steps;
  cudaStream_t stream;
};

template <int E>
int launch_warp(const Args& a) {
  constexpr int FPB = 4;
  pn_warp_kernel<E, FPB><<<(a.B + FPB - 1) / FPB, 32 * FPB, 0, a.stream>>>(
      a.y, a.lam, a.lam_scalar, a.w0, a.x, a.w, a.iters, a.B, a.n,
      a.max_iters, a.max_armijo, a.sigma, a.stop_rel, a.tol_eps,
      a.head_steps);
  return static_cast<int>(cudaGetLastError());
}

template <int E, int MAXT>
int launch_block(const Args& a) {
  const int threads = ((a.n + E - 1) / E + 31) / 32 * 32;
  const size_t smem =
      (2 * kSlot + 2 * 3 * static_cast<size_t>(threads) * E) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      pn_block_kernel<E, MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  pn_block_kernel<E, MAXT><<<a.B, threads, smem, a.stream>>>(
      a.y, a.lam, a.lam_scalar, a.w0, a.x, a.w, a.iters, a.n, a.max_iters,
      a.max_armijo, a.sigma, a.stop_rel, a.tol_eps,
      a.head_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y, x: (B, n) float32; lam: (B, n) with a zero last column, or NULL for
// lam_scalar; w0, w: (B, n) or NULL; iters: (B,) int32 or NULL.  The gap
// stop is max(stop_rel, tol_eps FLT_EPSILON 0.5||y - mean||^2) (tol_eps 10
// is the TPU kernel's rule).  2 <= n <= 8192 (checked by the Python
// wrapper).
extern "C" int pn_tv1_fused(const float* y, const float* lam, float lam_scalar,
                            const float* w0, float* x, float* w, int* iters,
                            int B, int n, int max_iters, int max_armijo,
                            float sigma, float stop_rel, float tol_eps,
                            int head_steps, cudaStream_t stream) {
  const Args a{y, lam, lam_scalar, w0, x, w, iters, B, n, max_iters,
               max_armijo, sigma, stop_rel, tol_eps, head_steps, stream};
  if (n <= 32) return launch_warp<1>(a);
  if (n <= 64) return launch_warp<2>(a);
  if (n <= 128) return launch_warp<4>(a);
  if (n <= 256) return launch_warp<8>(a);
  if (n <= 1024) return launch_block<4, 256>(a);
  if (n <= 2048) return launch_block<8, 256>(a);
  return launch_block<8, 1024>(a);
}
