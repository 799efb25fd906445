// The exact O(n) solve of one symmetric tridiagonal system per fiber, with
// 0/1 couplings and a nonnegative row excess, shared by kernels B2 (pcr.cu)
// and B4 (ms_fused.cu).
//
// Row j of the fiber reads  p_j x_j - a_j x_{j-1} - c_j x_{j+1} = r_j  with
// couplings a_j = c_{j-1} in {0, 1} and excess e_j = p_j - a_j - c_j >= 0,
// so the matrix is a diagonally dominant M-matrix.  A coefficient policy
// Cf gives them for the lane's chunk, evaluated where the elimination
// needs them (so each kernel keeps its own arithmetic for them):
//   bool c(k)     c of chunk element k;
//   float a0()    a of element 0 (c of the previous chunk's last element);
//   float e(k)    the excess of element k;
//   bool live(k)  false where rhs[k] is to be read as 0 (identity rows).
// Lane r of the fiber (Fiber<W>, fiber.cuh) owns the chunk
// j = rE .. rE + E - 1 in registers, and the solve is partitioned ("Thomas
// per chunk"):
//
// 1. Each lane eliminates its chunk serially: every interior element is
//    written in terms of the chunk's first (a) and last (b) element, which
//    leaves two interface rows per lane.  The elimination coefficients
//    depend only on the matrix, so they are made once (`setup`) and any
//    number of right-hand sides share them (`solve`).
// 2. Inside each warp the a's are eliminated (one shuffle) and the lanes'
//    b's are solved by PCR over shuffles (5 steps, no barrier), with the
//    warp's first a and last b as two boundary columns.
// 3. The warps' boundary rows (2 per warp) are one tridiagonal system of
//    2W unknowns: one barrier gathers it, and every warp solves it by PCR
//    over shuffles.  (W = 1 gathers by shuffles, with no barrier.)
// 4. Each lane back-substitutes its b, its a and its chunk.
//
// Every reduced system above is a Schur complement of the M-matrix, so
// elimination without pivoting is stable, and every pivot is formed as
// (row excess) + (couplings), all terms nonnegative, with the excess carried
// through each elimination: no pivot is a difference of nearly equal
// numbers, so the float32 solve stays accurate where the system's condition
// grows as n^2 (no shift, long unmasked runs).  Reciprocals take the place
// of divides (rcp, within 1 ulp in float32; correctly rounded in float64).
// The solve is written for the fiber's scalar type T: float (B2 and B4), or
// double (B2's float64 instantiation).
#pragma once

#include "fiber.cuh"

namespace {

template <int E, class Cf, class T = float>
struct Tridiag {
  static_assert(E >= 4, "the chunk elimination needs 4 elements a lane");
  Cf cf;             // the coefficients
  T inv[E];          // 1 / pivot of the downward pass, k = 1 .. E-1
  T G[E], H[E];      // x_k = T_k + G_k a + H_k b, k = 1 .. E-2
  T c0, La, Ua, sa, ia, la, ua, sga;  // the a row (element 0)
  T Lb, Ub, sb;                       // the b row (element E-1), normalized

  __device__ __forceinline__ T C(int k) const {
    return cf.c(k) ? inv[k] : T(0);
  }

  // The elimination coefficients of the chunk, from cf.
  __device__ __forceinline__ void setup() {
    // Downward: row k -> x_k - F_k x_0 - C_k x_{k+1} = S_k, excess sig_k.
    T F[E], sig[E];
#pragma unroll
    for (int k = 1; k < E; ++k) {
      const T ak = cf.c(k - 1) ? T(1) : T(0);
      const T ck = cf.c(k) ? T(1) : T(0);
      const T e = cf.e(k);
      const T s = k == 1 ? e : fma_(ak, sig[k - 1], e);
      const T f = k == 1 ? ak : ak * F[k - 1];
      inv[k] = rcp(s + f + ck);
      F[k] = f * inv[k];
      sig[k] = s * inv[k];
    }
    // Upward: x_k - G_k x_0 - H_k x_{E-1} = T_k, excess tau.
    G[E - 2] = F[E - 2];
    H[E - 2] = C(E - 2);
    T tau = sig[E - 2];
#pragma unroll
    for (int k = E - 3; k >= 1; --k) {
      const T ck = C(k);
      G[k] = fma_(ck, G[k + 1], F[k]);
      H[k] = ck * H[k + 1];
      tau = fma_(ck, tau, sig[k]);
    }
    La = cf.a0();
    c0 = cf.c(0) ? T(1) : T(0);
    const T e0 = cf.e(0);
    Ua = c0 * H[1];
    sa = fma_(c0, tau, e0);
    ia = rcp(sa + La + Ua);
    la = La * ia;
    ua = Ua * ia;
    sga = sa * ia;
    Lb = F[E - 1];
    Ub = C(E - 1);
    sb = sig[E - 1];
  }

  template <int W, int SLOT>
  __device__ __forceinline__ void solve(Fiber<W, SLOT, T>& g,
                                        const T (&rhs)[E],
                                        T (&x)[E]) const {
    const int lane = g.lane;
    // 1. The chunk: downward S, upward T (Tk[E-1] = S[E-1] = b's rhs).
    T Tk[E];
#pragma unroll
    for (int k = 1; k < E; ++k) {
      const bool ak = cf.c(k - 1);
      const T r = cf.live(k) ? rhs[k] : T(0);
      Tk[k] = (k == 1 || !ak ? r : r + Tk[k - 1]) * inv[k];
    }
#pragma unroll
    for (int k = E - 3; k >= 1; --k) Tk[k] = fma_(C(k), Tk[k + 1], Tk[k]);
    const T Ra = fma_(c0, Tk[1], cf.live(0) ? rhs[0] : T(0));
    const T Rb = Tk[E - 1];
    const T ra = Ra * ia;

    // 2. Lanes: eliminate a_{i+1} (lane i + 1's a row) from lane i's b
    // row, and a_i too except in lane 0, whose a is the warp's boundary
    // column A; lane 30's coupling to b_31 is the boundary column B, and
    // lane 31 (B itself) is an identity row here.
    const T ua_n = from_above(ua, 1, lane);
    const T sga_n = from_above(sga, 1, lane);
    const T ra_n = from_above(ra, 1, lane);
    const bool first = lane == 0;
    const T lo = first ? T(0) : Lb * la;
    const T upc = Ub * ua_n;
    const T ex = fma_(Ub, sga_n, first ? sb : fma_(Lb, sga, sb));
    const T rh = fma_(Ub, ra_n, first ? Rb : fma_(Lb, ra, Rb));
    const T colA = first ? Lb : T(0);
    const T ib = rcp(ex + lo + upc + colA);
    T plo = lo * ib, pup = lane == 30 ? T(0) : upc * ib;
    T pex = ex * ib, pd = rh * ib;
    T col[2] = {colA * ib, lane == 30 ? upc * ib : T(0)};
    if (lane == 31) {
      plo = pup = pd = col[0] = col[1] = T(0);
      pex = T(1);
    }
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) pcr_step<2>(plo, pup, pex, pd, col, s, lane, 32);
    // Now b_i = pd + col[0] A + col[1] B (lanes 0..30), excess pex.

    // 3. The warps' boundary rows: a_0 of lane 0, b_31 of lane 31 (with
    // lane 30's solution).
    const T z30 = from_below(pd, 1, lane), U30 = from_below(col[0], 1, lane);
    const T e30 = from_below(pex, 1, lane);
    T row[4];
    if (first) {  // a_0, coupled to b_31 of the previous warp and to B
      row[0] = La;
      row[1] = Ua * col[1];
      row[2] = fma_(Ua, pex, sa);
      row[3] = fma_(Ua, pd, Ra);
    } else {      // b_31 (lane 31; other lanes' values are not read)
      const T l31 = Lb * la;
      row[0] = l31 * U30;
      row[1] = Ub;
      row[2] = fma_(Lb, fma_(la, e30, sga), sb);
      row[3] = fma_(l31, z30, fma_(Lb, ra, Rb));
    }
    g.gather(row);
    {
      const T r = rcp(row[0] + row[1] + row[2]);
      T rlo = row[0] * r, rup = row[1] * r, rex = row[2] * r;
      T rd = row[3] * r;
#pragma unroll
      for (int s = 1; s < 2 * W; s <<= 1)
        pcr_step<0>(rlo, rup, rex, rd, nullptr, s, lane, 2 * W);
      row[3] = rd;
    }
    const T A = __shfl_sync(kFull, row[3], 2 * g.wid);
    const T B = __shfl_sync(kFull, row[3], 2 * g.wid + 1);

    // 4. Back-substitution.
    const T b = lane == 31 ? B : fma_(col[0], A, fma_(col[1], B, pd));
    const T bprev = from_below(b, 1, lane);
    const T a = first ? A : fma_(la, bprev, fma_(ua, b, ra));
    x[0] = a;
    x[E - 1] = b;
#pragma unroll
    for (int k = 1; k < E - 1; ++k) x[k] = fma_(G[k], a, fma_(H[k], b, Tk[k]));
  }
};

}  // namespace
