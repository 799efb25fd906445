// Kernel B4: the whole More-Sorensen TV-L2 prox per fiber, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel proxtv_tpu/ops/kernels/ms_fused.py:ms_tv2_fused
// (pallas_call at :256, body _make_kernel :79-179).  For each row y of a
// (B, n) float32 batch it solves
//     min_x 0.5 ||x - y||^2 + lam ||D x||_2
// on the dual ball ||w|| <= lam: centering, a bootstrap Newton step of the
// secular equation phi(alpha) = 1/lam - 1/||w(alpha)|| (two shifted solves
// (DD' + alpha I) w = dy, (DD' + alpha I) q = w), then the safeguarded
// secant iteration (one shifted solve per step) until
// | ||w|| - lam | <= stop_boundary * lam, the interior case (x = mean), the
// zero-penalty rows (x = y) and the duality-gap certificate.  The TPU
// kernel solves the shifted systems by normalized parallel cyclic reduction
// (ms_fused.py:45-76); this one solves them exactly in O(n), see below, so
// its roundings differ from the plain version's.
//
// What bounds it on this card: device traffic is one read of y and one
// write of x, 80 MB for a (10000, 1000) batch, ~24 us at 3.35 TB/s; the
// least work of the function is, per solve, one exact tridiagonal solve
// (~10 operations per element with the alpha-only coefficients) times
// 2 + secant steps, so it is operations-bound.  A fiber's solve is a chain
// of dependent steps, so the design keeps that chain in registers and
// shuffles, and many fibers in flight.
//
// Design.  A fiber runs on W warps (W = 1 for n <= 256, more above), and
// lane r of the fiber owns the contiguous chunk j = rE .. rE + E - 1 of the
// row in registers (dy, the dual w, the solve's coefficients); lanes past
// n are zero and decoupled identity rows, like the TPU kernel's lane
// padding.  Each shifted solve is partitioned ("Thomas per chunk"):
//
// 1. Each lane eliminates its chunk serially: every interior element is
//    written in terms of the chunk's first (a) and last (b) element, which
//    leaves two interface rows per lane.  The elimination coefficients
//    depend only on alpha and the position, so they are made once per
//    alpha (`setup`) and the bootstrap's two solves share them.
// 2. Inside each warp the a's are eliminated (one shuffle) and the lanes'
//    b's are solved by PCR over shuffles (5 steps, no barrier), with the
//    warp's first a and last b as two boundary columns.
// 3. The warps' boundary rows (2 per warp) are one tridiagonal system of
//    2W unknowns: one barrier gathers it, and every warp solves it by PCR
//    over shuffles.  (W = 1 gathers by shuffles, with no barrier.)
// 4. Each lane back-substitutes its b, its a and its chunk.
//
// DD' + alpha I is a diagonally dominant M-matrix and every reduced system
// above is a Schur complement of it, so elimination without pivoting is
// stable.  Every pivot is formed as (row excess) + (couplings), all terms
// nonnegative, with the row excess (the row sum, alpha inside the row)
// carried through each elimination: no pivot is a difference of nearly
// equal numbers, so the float32 solve stays accurate at alpha -> 0, where
// the system's condition grows as n^2.  Reciprocals take the place of
// divides, by the hardware's approximate rcp (within 1 ulp): the correctly
// rounded __frcp_rn cost 25% of the kernel at (10000, 1000).
//
// Row sums are butterflies within a warp; across warps, partials go to
// double-buffered shared slots (the buffer alternates per use, so one
// barrier per crossing) and every warp reduces them in the same order, so
// every thread holds the same bits and every loop branch is uniform.  A
// secant step crosses warps twice (the boundary system and ||w||).
#include <cuda_runtime.h>
#include <stdint.h>

#include "block.cuh"

namespace {

constexpr float kEps = 1e-10f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlot = 4 * 32;          // floats per shared slot
constexpr int kFibersPerBlock = 4;     // W = 1: one warp per fiber

// Threads of a block, and the blocks each SM should hold: up to 4 warps a
// fiber, at least 768 threads an SM (at most 85 registers a thread), so
// six fibers of 1000 share an SM; above, what the registers give.
template <int W>
constexpr int threads_of() { return W == 1 ? 32 * kFibersPerBlock : 32 * W; }
template <int W>
constexpr int blocks_per_sm() { return W <= 4 ? 768 / threads_of<W>() : 1; }

__device__ __forceinline__ float rcp(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// v of lane - s (0 below lane s) and of lane + s (0 at or past `width`).
__device__ __forceinline__ float from_below(float v, int s, int lane) {
  const float t = __shfl_up_sync(kFull, v, s);
  return lane >= s ? t : 0.f;
}
__device__ __forceinline__ float from_above(float v, int s, int lane,
                                            int width = 32) {
  const float t = __shfl_down_sync(kFull, v, s);
  return lane + s < width ? t : 0.f;
}

// The W warps of one fiber.  Crossings between warps (W > 1) go through
// double-buffered shared slots, one barrier each.
template <int W>
struct Fiber {
  int lane, wid;  // lane in its warp, warp in the fiber
  float* slots;   // 2 x kSlot (W > 1)
  int ph = 0;     // buffer parity (uniform across the fiber)

  __device__ int rank() const { return wid * 32 + lane; }

  __device__ __forceinline__ float* slot() {
    float* s = slots + (ph & 1) * kSlot;
    ++ph;
    return s;
  }

  // Row sums of v[0..N), the same bits in every thread of the fiber.
  template <int N>
  __device__ __forceinline__ void sum(float (&v)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = warp_reduce<kSum>(v[i]);
    if constexpr (W > 1) {
      float* s = slot();
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < N; ++i) s[i * 32 + wid] = v[i];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] = warp_reduce<kSum>(lane < W ? s[i * 32 + lane] : 0.f);
    }
  }

  // The previous chunk's last element and the next chunk's first (0 past
  // the row's ends).
  __device__ __forceinline__ void exchange(float first, float last,
                                           float& prev_last,
                                           float& next_first) {
    prev_last = from_below(last, 1, lane);
    next_first = from_above(first, 1, lane);
    if constexpr (W > 1) {
      float* s = slot();
      if (lane == 0) s[wid] = first;
      if (lane == 31) s[32 + wid] = last;
      __syncthreads();
      if (lane == 0 && wid > 0) prev_last = s[32 + wid - 1];
      if (lane == 31 && wid + 1 < W) next_first = s[wid + 1];
    }
  }

  // Gathers the warps' boundary rows (lane 0 holds its warp's a row, lane
  // 31 its b row) into lanes 0 .. 2W - 1 of every warp, in the order
  // a_0, b_0, a_1, b_1, ...; identity rows (lower, upper, excess, rhs) =
  // (0, 0, 1, 0) above.
  __device__ __forceinline__ void gather(float (&row)[4]) {
    if constexpr (W == 1) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        row[q] = __shfl_sync(kFull, row[q], lane == 1 ? 31 : 0);
    } else {
      float* s = slot();
      if (lane == 0 || lane == 31) {
        const int v = 2 * wid + (lane == 31);
#pragma unroll
        for (int q = 0; q < 4; ++q) s[4 * v + q] = row[q];
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 4; ++q) row[q] = lane < 2 * W ? s[4 * lane + q] : 0.f;
    }
    if (lane >= 2 * W) {
      row[0] = row[1] = row[3] = 0.f;
      row[2] = 1.f;
    }
  }
};

// One PCR step at stride s on normalized rows x_i - lo x_{i-s} - up x_{i+s}
// - sum_c col_c = d with row excess ex (1 = ex + lo + up + sum of the
// columns): every pivot is a sum of nonnegative terms.  NC boundary columns
// travel with the right-hand side.
template <int NC>
__device__ __forceinline__ void pcr_step(float& lo, float& up, float& ex,
                                         float& d, float* col, int s,
                                         int lane, int width) {
  const float lom = from_below(lo, s, lane);
  const float exm = from_below(ex, s, lane);
  const float dm = from_below(d, s, lane);
  const float upp = from_above(up, s, lane, width);
  const float exp_ = from_above(ex, s, lane, width);
  const float dp = from_above(d, s, lane, width);
  const float nlo = lo * lom, nup = up * upp;
  const float nex = fmaf(lo, exm, fmaf(up, exp_, ex));
  float piv = nex + nlo + nup;
  float ncol[NC > 0 ? NC : 1];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float cm = from_below(col[c], s, lane);
    const float cp = from_above(col[c], s, lane, width);
    ncol[c] = fmaf(lo, cm, fmaf(up, cp, col[c]));
    piv += ncol[c];
  }
  const float r = rcp(piv);
  d = fmaf(lo, dm, fmaf(up, dp, d)) * r;
  lo = nlo * r;
  up = nup * r;
  ex = nex * r;
#pragma unroll
  for (int c = 0; c < NC; ++c) col[c] = ncol[c] * r;
}

// (DD' + alpha I) w = rhs on rows j < m, identity rows (w = 0) from m on,
// for the chunk of E elements at j0.  Rows are written with nonnegative
// couplings: p x_j - a_j x_{j-1} - c_j x_{j+1} = r_j, a_j, c_j in {0, 1},
// with excess e_j = p - a_j - c_j (alpha inside the row).
template <int E>
struct Shifted {
  static_assert(E >= 4, "the chunk elimination needs 4 elements a lane");
  float inv[E];    // 1 / pivot of the downward pass, k = 1 .. E-1
  float G[E], H[E];  // x_k = T_k + G_k a + H_k b, k = 1 .. E-2
  float c0, La, Ua, sa, ia, la, ua, sga;  // the a row (element 0)
  float Lb, Ub, sb;               // the b row (element E-1), normalized
  int j0, m;

  __device__ __forceinline__ float C(int k) const {
    return j0 + k + 1 < m ? inv[k] : 0.f;
  }

  __device__ __forceinline__ void setup(float alpha, int j0_, int m_) {
    j0 = j0_;
    m = m_;
    // Downward: row k -> x_k - F_k x_0 - C_k x_{k+1} = S_k, excess sig_k.
    float F[E], sig[E];
#pragma unroll
    for (int k = 1; k < E; ++k) {
      const int j = j0 + k;
      const float ak = j < m ? 1.f : 0.f;  // j >= 1 here
      const float ck = j + 1 < m ? 1.f : 0.f;
      const float e = j < m ? alpha + (1.f - ck) : 1.f;
      const float s = k == 1 ? e : fmaf(ak, sig[k - 1], e);
      const float f = k == 1 ? ak : ak * F[k - 1];
      inv[k] = rcp(s + f + ck);
      F[k] = f * inv[k];
      sig[k] = s * inv[k];
    }
    // Upward: x_k - G_k x_0 - H_k x_{E-1} = T_k, excess tau.
    G[E - 2] = F[E - 2];
    H[E - 2] = C(E - 2);
    float tau = sig[E - 2];
#pragma unroll
    for (int k = E - 3; k >= 1; --k) {
      const float ck = C(k);
      G[k] = fmaf(ck, G[k + 1], F[k]);
      H[k] = ck * H[k + 1];
      tau = fmaf(ck, tau, sig[k]);
    }
    const bool act0 = j0 < m;
    La = act0 && j0 >= 1 ? 1.f : 0.f;
    c0 = j0 + 1 < m ? 1.f : 0.f;
    const float e0 = act0 ? alpha + (1.f - La) + (1.f - c0) : 1.f;
    Ua = c0 * H[1];
    sa = fmaf(c0, tau, e0);
    ia = rcp(sa + La + Ua);
    la = La * ia;
    ua = Ua * ia;
    sga = sa * ia;
    Lb = F[E - 1];
    Ub = C(E - 1);
    sb = sig[E - 1];
  }

  template <int W>
  __device__ __forceinline__ void solve(Fiber<W>& g, const float (&rhs)[E],
                                        float (&x)[E]) const {
    const int lane = g.lane;
    // 1. The chunk: downward S, upward T (T[E-1] = S[E-1] = b's rhs).
    float T[E];
#pragma unroll
    for (int k = 1; k < E; ++k) {
      const bool act = j0 + k < m;
      const float r = act ? rhs[k] : 0.f;
      T[k] = (k == 1 || !act ? r : r + T[k - 1]) * inv[k];
    }
#pragma unroll
    for (int k = E - 3; k >= 1; --k) T[k] = fmaf(C(k), T[k + 1], T[k]);
    const float Ra = fmaf(c0, T[1], j0 < m ? rhs[0] : 0.f);
    const float Rb = T[E - 1];
    const float ra = Ra * ia;

    // 2. Lanes: eliminate a_{i+1} (lane i + 1's a row) from lane i's b
    // row, and a_i too except in lane 0, whose a is the warp's boundary
    // column A; lane 30's coupling to b_31 is the boundary column B, and
    // lane 31 (B itself) is an identity row here.
    const float la_n = from_above(la, 1, lane), ua_n = from_above(ua, 1, lane);
    const float sga_n = from_above(sga, 1, lane);
    const float ra_n = from_above(ra, 1, lane);
    const bool first = lane == 0;
    const float lo = first ? 0.f : Lb * la;
    const float upc = Ub * ua_n;
    const float ex = fmaf(Ub, sga_n, first ? sb : fmaf(Lb, sga, sb));
    const float rh = fmaf(Ub, ra_n, first ? Rb : fmaf(Lb, ra, Rb));
    const float colA = first ? Lb : 0.f;
    const float ib = rcp(ex + lo + upc + colA);
    float plo = lo * ib, pup = lane == 30 ? 0.f : upc * ib;
    float pex = ex * ib, pd = rh * ib;
    float col[2] = {colA * ib, lane == 30 ? upc * ib : 0.f};
    if (lane == 31) {
      plo = pup = pd = col[0] = col[1] = 0.f;
      pex = 1.f;
    }
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) pcr_step<2>(plo, pup, pex, pd, col, s, lane, 32);
    // Now b_i = pd + col[0] A + col[1] B (lanes 0..30), excess pex.

    // 3. The warps' boundary rows: a_0 of lane 0, b_31 of lane 31 (with
    // lane 30's solution).
    const float z30 = from_below(pd, 1, lane), U30 = from_below(col[0], 1, lane);
    const float V30 = from_below(col[1], 1, lane), e30 = from_below(pex, 1, lane);
    float row[4];
    if (first) {  // a_0, coupled to b_31 of the previous warp and to B
      row[0] = La;
      row[1] = Ua * col[1];
      row[2] = fmaf(Ua, pex, sa);
      row[3] = fmaf(Ua, pd, Ra);
    } else {      // b_31 (lane 31; other lanes' values are not read)
      const float l31 = Lb * la;
      row[0] = l31 * U30;
      row[1] = Ub;
      row[2] = fmaf(Lb, fmaf(la, e30, sga), sb);
      row[3] = fmaf(l31, z30, fmaf(Lb, ra, Rb));
    }
    g.gather(row);
    {
      const float r = rcp(row[0] + row[1] + row[2]);
      float rlo = row[0] * r, rup = row[1] * r, rex = row[2] * r;
      float rd = row[3] * r;
#pragma unroll
      for (int s = 1; s < 2 * W; s <<= 1)
        pcr_step<0>(rlo, rup, rex, rd, nullptr, s, lane, 2 * W);
      row[3] = rd;
    }
    const float A = __shfl_sync(kFull, row[3], 2 * g.wid);
    const float B = __shfl_sync(kFull, row[3], 2 * g.wid + 1);

    // 4. Back-substitution.
    const float b = lane == 31 ? B : fmaf(col[0], A, fmaf(col[1], B, pd));
    const float bprev = from_below(b, 1, lane);
    const float a = first ? A : fmaf(la, bprev, fmaf(ua, b, ra));
    x[0] = a;
    x[E - 1] = b;
#pragma unroll
    for (int k = 1; k < E - 1; ++k) x[k] = fmaf(G[k], a, fmaf(H[k], b, T[k]));
  }
};

template <int E, int W>
__global__ void __launch_bounds__(threads_of<W>(), blocks_per_sm<W>())
ms_kernel(const float* __restrict__ Y, const float* __restrict__ LAM,
          float lam_scalar, const float* __restrict__ A0,
          float* __restrict__ X, float* __restrict__ ALPHA,
          float* __restrict__ GAP, int* __restrict__ ITERS, int nrows, int n,
          int max_iters, float stop_boundary) {
  __shared__ float slots[2 * kSlot];
  Fiber<W> g;
  g.lane = threadIdx.x & 31;
  g.slots = slots;
  size_t row;
  if constexpr (W == 1) {
    g.wid = 0;
    row = static_cast<size_t>(blockIdx.x) * kFibersPerBlock + (threadIdx.x >> 5);
    if (row >= static_cast<size_t>(nrows)) return;  // whole warps leave
  } else {
    g.wid = threadIdx.x >> 5;
    row = blockIdx.x;
  }
  const int j0 = g.rank() * E, m = n - 1;
  const size_t base = row * n;

  float y[E];
  float s[1] = {0.f};
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = j0 + k;
    y[k] = j < n ? Y[base + j] : 0.f;
    s[0] += y[k];
  }
  // Center (translation equivariance); lanes past n stay zero.
  g.sum(s);
  const float ybar = s[0] / static_cast<float>(n);
#pragma unroll
  for (int k = 0; k < E; ++k) y[k] = j0 + k < n ? y[k] - ybar : 0.f;
  float yprev, ynext0;
  g.exchange(y[0], y[E - 1], yprev, ynext0);
  float dy[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const float v = j0 + k < m ? 1.f : 0.f;
    dy[k] = ((k + 1 < E ? y[k + 1] : ynext0) - y[k]) * v;
  }

  const float lam = LAM != nullptr ? LAM[row] : lam_scalar;
  const bool zero_pen = lam <= 0.f;
  const float safe_lam = lam > 0.f ? lam : 1.f;
  const float tolb = stop_boundary * safe_lam;

  // Bootstrap: one Newton step of the secular equation from the start
  // point (reference more_TV2 update, src/TVL2opt.cpp:106-128); both solves
  // share the start point's coefficients.
  const float a_start = A0 != nullptr ? fmaxf(A0[row], 0.f) : 0.f;
  Shifted<E> sys;
  sys.setup(a_start, j0, m);
  float w[E], pair[2] = {0.f, 0.f};  // ||w||^2 and w'q
  {
    float q[E];
    sys.solve(g, dy, w);
    sys.solve(g, w, q);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      pair[0] = fmaf(w[k], w[k], pair[0]);
      pair[1] = fmaf(w[k], q[k], pair[1]);
    }
  }
  g.sum(pair);
  const float nrm2_s = pair[0], wq_s = pair[1];
  const float nrm_s = sqrtf(nrm2_s);
  const float delta0 =
      (nrm2_s / fmaxf(wq_s, kEps)) * (nrm_s - safe_lam) / safe_lam;
  float alpha = fmaxf(a_start + delta0, 0.f);
  float aprev = a_start;
  float phiprev = 1.f / safe_lam - 1.f / fmaxf(nrm_s, kEps);
  // Interior case: ||w(0)|| <= lam means x is exactly the mean.
  bool interior = a_start <= 0.f && nrm_s <= safe_lam;
  bool running =
      !(fabsf(nrm_s - safe_lam) <= tolb || interior) && !zero_pen;
  int it = 0;
  while (running && it < max_iters) {
    sys.setup(alpha, j0, m);
    sys.solve(g, dy, w);
    float sq[1] = {0.f};
#pragma unroll
    for (int k = 0; k < E; ++k) sq[0] = fmaf(w[k], w[k], sq[0]);
    g.sum(sq);
    const float nrm = sqrtf(sq[0]);
    const float phi = 1.f / safe_lam - 1.f / fmaxf(nrm, kEps);
    const float denom = phi - phiprev;
    const float secant = alpha - phi * (alpha - aprev) / denom;
    const float alpha_new = fmaxf(fabsf(denom) > kEps ? secant : alpha, 0.f);
    const bool inter = alpha <= 0.f && nrm <= safe_lam;
    const bool conv = fabsf(nrm - safe_lam) <= tolb || inter;
    interior = inter;
    aprev = alpha;
    phiprev = phi;
    if (!conv) alpha = alpha_new;
    ++it;
    running = !conv;
  }

  // x = y + D'w (interior: the centered mean 0; zero penalty: y), and the
  // gap lam ||g|| + w'g with g = Dx.  y is read again (the solve's
  // registers held its place).
  float wprev0, wnext;
  g.exchange(w[0], w[E - 1], wprev0, wnext);
  float x[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = j0 + k;
    const float yc = j < n ? Y[base + j] - ybar : 0.f;
    x[k] = yc + (w[k] - (k > 0 ? w[k - 1] : wprev0));
    x[k] = interior ? 0.f : x[k];
    x[k] = zero_pen ? yc : x[k];
  }
  float xprev, xnext0;
  g.exchange(x[0], x[E - 1], xprev, xnext0);
  float gw[2] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const float v = j0 + k < m ? 1.f : 0.f;
    const float gk = (x[k] - (k + 1 < E ? x[k + 1] : xnext0)) * v;
    gw[0] = fmaf(gk, gk, gw[0]);
    gw[1] = fmaf(w[k], gk, gw[1]);
  }
  g.sum(gw);
  float gap = fabsf(lam * sqrtf(gw[0]) + gw[1]);
  if (interior || zero_pen) gap = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = j0 + k;
    if (j < n) X[base + j] = x[k] + ybar;
  }
  if (g.rank() == 0) {
    ALPHA[row] = alpha;
    GAP[row] = gap;
    ITERS[row] = it;
  }
}

template <int E, int W>
int launch(const float* y, const float* lam, float lam_scalar, const float* a0,
           float* x, float* alpha, float* gap, int* iters, int B, int n,
           int max_iters, float stop_boundary, cudaStream_t stream) {
  const int threads = threads_of<W>();
  const int blocks = W == 1 ? (B + kFibersPerBlock - 1) / kFibersPerBlock : B;
  ms_kernel<E, W><<<blocks, threads, 0, stream>>>(
      y, lam, lam_scalar, a0, x, alpha, gap, iters, B, n, max_iters,
      stop_boundary);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y, x: (B, n) float32; lam: (B,) or NULL for lam_scalar; a0: (B,) or NULL;
// alpha, gap: (B,) float32; iters: (B,) int32.  2 <= n <= 8192 (checked by
// the Python wrapper).  A fiber covers 32 W E elements.
extern "C" int ms_tv2_fused(const float* y, const float* lam, float lam_scalar,
                            const float* a0, float* x, float* alpha,
                            float* gap, int* iters, int B, int n,
                            int max_iters, float stop_boundary,
                            cudaStream_t stream) {
#define MS_LAUNCH(E, W)                                                      \
  return launch<E, W>(y, lam, lam_scalar, a0, x, alpha, gap, iters, B, n,   \
                      max_iters, stop_boundary, stream)
  if (n <= 128) MS_LAUNCH(4, 1);
  if (n <= 256) MS_LAUNCH(8, 1);
  if (n <= 512) MS_LAUNCH(8, 2);
  if (n <= 1024) MS_LAUNCH(8, 4);
  if (n <= 2048) MS_LAUNCH(8, 8);
  if (n <= 4096) MS_LAUNCH(8, 16);
  if (n <= 8192) MS_LAUNCH(16, 16);
#undef MS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
