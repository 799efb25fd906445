// Kernel D2: batched message-passing DP for the (weighted) TV-L1 prox,
// written by hand for Hopper (sm_90a).
//
// No TPU kernel: it replaces the JAX package's XLA lock-step deque machine
// proxtv_tpu/ops/tv1d_l1.py:tv1_dp (one deque operation per lane per
// while_loop step, with a device-to-host check of the loop condition on
// each), the clipped-message dynamic program of Kolmogorov, Pock & Rolinek
// (proxTV src/TVL1opt_kolmogorov.cpp:38-130).  Here the same operations
// run one after another in a plain loop: for each sample i the message
// is formed (INIT), breakpoints are popped from the front of the deque
// while the message stays below -w_i (LOWER), the lower clip bound is
// pushed (LOWER_EXIT, or both bounds when the ends meet), breakpoints are
// popped from the back while it stays above w_i (UPPER) and the upper bound
// pushed (UPPER_EXIT); then the backward pass x[i] = clip(x[i+1], lo[i],
// hi[i]).  Each operation is the plain version's (tv1_dp_plain) in the
// same order and float32 rounding; the two multiply-adds are written with
// __fmul_rn/__fadd_rn so that they do not contract into FMAs.
//
// What bounds it on this card: the function reads y (and the weights) once
// and writes x once, ~8 bytes an element, as D1; the deque and the clip
// bounds are the algorithm's workspace.  The operations form a dependent
// chain per signal, so a launch is latency: the slowest signal's chain.
//
// Design: one thread per signal.  The deque arena (2n slots of breakpoint
// and slope) and the clip bounds (lo, hi: n each) live in a global
// workspace that the wrapper allocates once per call, interleaved by
// signal ([slot * B + b]): threads of a warp step through i together, so
// their bound writes and the backward pass's reads are coalesced, and
// their deque ends, which start at the same slots and drift slowly, share
// lines.
#include <cuda_runtime.h>

#include "direct1d.cuh"

namespace {

using direct1d::Lam;

__global__ void __launch_bounds__(64)
dp_kernel(const float* __restrict__ y, Lam lam, float* __restrict__ x,
          float* __restrict__ plam, int* __restrict__ pslope,
          float* __restrict__ lohi, int B, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* __restrict__ yb = y + (size_t)b * n;
  float* __restrict__ xb = x + (size_t)b * n;
  if (direct1d::degenerate(yb, lam, b, n, xb)) return;

  const size_t S = (size_t)B;
#define PL(k) plam[(size_t)(k) * S + b]
#define PS(k) pslope[(size_t)(k) * S + b]
#define LO(k) lohi[(size_t)(k) * S + b]
#define HI(k) lohi[((size_t)n + (k)) * S + b]
  // The message at node 0 (reference :152-156).
  int L = n - 1, R = n;
  const float w0 = lam(b, 0), y0 = __ldg(yb);
  const float lo0 = -w0 + y0, hi0 = w0 + y0;
  PS(L - 1) = -1;
  PL(L) = lo0;
  PS(L) = 0;
  PL(R) = hi0;
  PS(R) = -1;
  LO(0) = lo0;
  HI(0) = hi0;
  int A = 1;
  float last_val;
  for (int i = 1;; ++i) {
    // INIT
    A += 1;
    const float wp = lam(b, i - 1);
    const float w = i < n - 1 ? lam(b, i) : 0.f;
    const float bi = __ldg(yb + i);
    float mmin = -wp + PL(L) - bi;
    float mmax = wp + PL(R) - bi;
    int slope = 1;
    // LOWER: pop from the front while the message is below -w.
    while (mmin < -w) {
      slope = PS(L) + A;
      L += 1;
      if (L > R) break;
      mmin = __fadd_rn(mmin, __fmul_rn(PL(L) - PL(L - 1), (float)slope));
    }
    // LOWER_EXIT
    if (i == n - 1) {
      last_val = PL(L > R ? L - 1 : L) - mmin / (float)slope;
      break;
    }
    L -= 1;
    PS(L - 1) = -A;
    if (L == R) {  // the ends meet: both bounds from one breakpoint
      const float pl = PL(L);
      const float hm = pl - (mmax - w), lm = pl - (mmax + w);
      R += 1;
      PS(R) = -A;
      PL(R) = hm;
      PL(L) = lm;
      HI(i) = hm;
      LO(i) = lm;
      continue;
    }
    const float lon = PL(L + 1) - (w + mmin) / (float)slope;
    PL(L) = lon;
    LO(i) = lon;
    slope = 1;
    // UPPER: pop from the back while the message is above w.
    while (mmax > w) {
      R -= 1;
      slope = PS(R) + A;
      mmax = __fsub_rn(mmax, __fmul_rn(PL(R + 1) - PL(R), (float)slope));
      if (R == L) break;
    }
    // UPPER_EXIT
    R += 1;
    const float hu = PL(R - 1) + (w - mmax) / (float)slope;
    PS(R) = -A;
    PL(R) = hu;
    HI(i) = hu;
  }
  // Backward clamping pass (reference :216-221).
  float xv = last_val;
  xb[n - 1] = xv;
  for (int j = n - 2; j >= 0; --j) {
    xv = fminf(fmaxf(xv, LO(j)), HI(j));
    xb[j] = xv;
  }
#undef PL
#undef PS
#undef LO
#undef HI
}

}  // namespace

// y, x: (B, n) float32, row-major; lam as tautstring_tv1.  Workspace,
// interleaved by signal: plam (2n x B float32), pslope (2n x B int32),
// lohi (2n x B float32: lo in rows 0..n-1, hi in rows n..2n-1).  n >= 2
// (checked by the Python wrapper).
extern "C" int dp_tv1(const float* y, const float* lam, int lam_rs,
                      int lam_cs, float lam_s, float* x, float* plam,
                      int* pslope, float* lohi, int B, int n,
                      cudaStream_t stream) {
  if (B <= 0) return 0;
  const Lam l{lam, (size_t)lam_rs, (size_t)lam_cs, lam_s};
  const int threads = 64;
  dp_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
      y, l, x, plam, pslope, lohi, B, n);
  return static_cast<int>(cudaGetLastError());
}
