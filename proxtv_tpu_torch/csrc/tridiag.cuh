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
// of divides (rcp, within 1 ulp).
#pragma once

#include "fiber.cuh"

namespace {

template <int E, class Cf>
struct Tridiag {
  static_assert(E >= 4, "the chunk elimination needs 4 elements a lane");
  Cf cf;             // the coefficients
  float inv[E];      // 1 / pivot of the downward pass, k = 1 .. E-1
  float G[E], H[E];  // x_k = T_k + G_k a + H_k b, k = 1 .. E-2
  float c0, La, Ua, sa, ia, la, ua, sga;  // the a row (element 0)
  float Lb, Ub, sb;                       // the b row (element E-1), normalized

  __device__ __forceinline__ float C(int k) const {
    return cf.c(k) ? inv[k] : 0.f;
  }

  // The elimination coefficients of the chunk, from cf.
  __device__ __forceinline__ void setup() {
    // Downward: row k -> x_k - F_k x_0 - C_k x_{k+1} = S_k, excess sig_k.
    float F[E], sig[E];
#pragma unroll
    for (int k = 1; k < E; ++k) {
      const float ak = cf.c(k - 1) ? 1.f : 0.f;
      const float ck = cf.c(k) ? 1.f : 0.f;
      const float e = cf.e(k);
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
    La = cf.a0();
    c0 = cf.c(0) ? 1.f : 0.f;
    const float e0 = cf.e(0);
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

  template <int W, int SLOT>
  __device__ __forceinline__ void solve(Fiber<W, SLOT>& g,
                                        const float (&rhs)[E],
                                        float (&x)[E]) const {
    const int lane = g.lane;
    // 1. The chunk: downward S, upward T (T[E-1] = S[E-1] = b's rhs).
    float T[E];
#pragma unroll
    for (int k = 1; k < E; ++k) {
      const bool ak = cf.c(k - 1);
      const float r = cf.live(k) ? rhs[k] : 0.f;
      T[k] = (k == 1 || !ak ? r : r + T[k - 1]) * inv[k];
    }
#pragma unroll
    for (int k = E - 3; k >= 1; --k) T[k] = fmaf(C(k), T[k + 1], T[k]);
    const float Ra = fmaf(c0, T[1], cf.live(0) ? rhs[0] : 0.f);
    const float Rb = T[E - 1];
    const float ra = Ra * ia;

    // 2. Lanes: eliminate a_{i+1} (lane i + 1's a row) from lane i's b
    // row, and a_i too except in lane 0, whose a is the warp's boundary
    // column A; lane 30's coupling to b_31 is the boundary column B, and
    // lane 31 (B itself) is an identity row here.
    const float ua_n = from_above(ua, 1, lane);
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
    const float e30 = from_below(pex, 1, lane);
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

}  // namespace
