// Kernel B2: batched SPD second-difference tridiagonal solve, hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel proxtv_tpu/ops/kernels/pcr.py:pcr_spd_solve_pallas
// (its three pallas_calls: plain, masked, shifted).  Solves
//     (DD' [+ shift I]) x = rhs        per row of a (B, n) float32 batch,
// masked rows becoming identity rows with zero right-hand side and a
// coupling surviving only between two unmasked rows.  The TPU kernel runs
// parallel cyclic reduction; this one solves each row exactly in O(n)
// (tridiag.cuh), so its roundings differ from the plain version's.
//
// What bounds it on this card: each row is read once and written once
// (plus the mask's bytes), so a (512, 999) batch moves ~4 MB, ~1.2 us at
// 3.35 TB/s; the exact elimination is ~10 operations per element, under
// that.  At the main path's shapes (one row of 999; 512 rows of 999 or
// 511) a launch is latency: a row's solve is a chain of dependent steps.
//
// Design: a row runs on W warps (fiber.cuh; W = 1, four rows a block, for
// n <= 256; E = 4 and 4 or 8 warps up to 1024, where a launch of one row
// is latency and the shorter serial chain wins), lane r holding the chunk
// j = rE .. rE + E - 1 of the right-hand side in registers; lanes past n
// are identity rows.  Each lane
// makes its chunk's couplings and row excesses from its own mask bytes
// (and the one on each side), so the coefficients need no exchange:
//   masked    c_j = m_j m_{j+1}, excess 1 + m_j - c_{j-1} - c_j,
//   plain     c_j = [j + 1 < n], excess [j = 0] + [j = n - 1],
//   shifted   as plain, plus the row's shift in every excess.
// Then the partitioned solve of tridiag.cuh (the chunk serially in
// registers, the lanes by PCR over shuffles, the warps' boundary rows after
// one barrier), every pivot a sum of nonnegative terms, and one step of
// iterative refinement on the same elimination, its residual formed in
// float64, so that where the unmasked system's condition grows as n^2 the
// float32 solution stays no further from the float64 one than the TPU
// kernel's float32 PCR (tests/test_torch_cuda.py holds it).
//
// The kernel is written for the system's type T: float (pcr_spd_solve) and
// double (pcr_spd_solve_f64, the Newton systems of tv1_pn on a float64
// batch), the same layouts, the same solve and the same refinement step
// (in float64 its residual is rounded like the solve's own arithmetic).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tridiag.cuh"

namespace {

// The coefficients of a row's chunk, made from its mask bytes or its shift
// (tridiag.cuh): every rhs is read (masked rows carry 0).
template <int E, class T>
struct RowCoef {
  unsigned cb;   // bit k: c of chunk element k
  T a_0;         // a of element 0
  T ex[E];       // the excesses
  __device__ __forceinline__ bool c(int k) const { return (cb >> k) & 1u; }
  __device__ __forceinline__ T a0() const { return a_0; }
  __device__ __forceinline__ T e(int k) const { return ex[k]; }
  __device__ __forceinline__ bool live(int) const { return true; }
};

constexpr int kSlot = 4 * 32;          // values per shared slot
constexpr int kRowsPerBlock = 4;       // W = 1: one warp per row

template <int W>
constexpr int threads_of() { return W == 1 ? 32 * kRowsPerBlock : 32 * W; }

template <class T, int E, int W>
__global__ void __launch_bounds__(threads_of<W>())
pcr_kernel(const T* __restrict__ rhs, const uint8_t* __restrict__ mask,
           const T* __restrict__ shift, T* __restrict__ out,
           int nrows, int n) {
  __shared__ T slots[W > 1 ? 2 * kSlot : 1];
  Fiber<W, kSlot, T> g;
  g.lane = threadIdx.x & 31;
  g.slots = slots;
  size_t row;
  if constexpr (W == 1) {
    g.wid = 0;
    row = static_cast<size_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
    if (row >= static_cast<size_t>(nrows)) return;  // whole warps leave
  } else {
    g.wid = threadIdx.x >> 5;
    row = blockIdx.x;
  }
  const int j0 = g.rank() * E;
  const size_t base = row * n;

  Tridiag<E, RowCoef<E, T>, T> sys;
  RowCoef<E, T>& cf = sys.cf;
  cf.cb = 0;
  T r[E];
  if (mask != nullptr) {
    const uint8_t* m = mask + base;
    const bool prev = j0 >= 1 && j0 - 1 < n && m[j0 - 1] != 0;
    bool cur = j0 < n && m[j0] != 0;
    cf.a_0 = prev && cur ? T(1) : T(0);
    T ak = cf.a_0;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int j = j0 + k;
      const bool nxt = j + 1 < n && m[j + 1] != 0;
      const bool ck = cur && nxt;
      cf.cb |= (ck ? 1u : 0u) << k;
      cf.ex[k] = (cur ? T(2) : T(1)) - ak - (ck ? T(1) : T(0));
      r[k] = cur ? rhs[base + j] : T(0);
      ak = ck ? T(1) : T(0);
      cur = nxt;
    }
  } else {
    const T s = shift != nullptr ? shift[row] : T(0);
    cf.a_0 = j0 >= 1 && j0 < n ? T(1) : T(0);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int j = j0 + k;
      const bool act = j < n, ck = j + 1 < n;
      const T ak = k == 0 ? cf.a_0 : (act ? T(1) : T(0));
      cf.cb |= (ck ? 1u : 0u) << k;
      cf.ex[k] = act ? s + (T(1) - ak) + (T(1) - (ck ? T(1) : T(0))) : T(1);
      r[k] = act ? rhs[base + j] : T(0);
    }
  }
  sys.setup();
  T x[E], dx[E], res[E];
  sys.solve(g, r, x);
  // One step of iterative refinement.  The residual
  // r_j - e_j x_j - a_j (x_j - x_{j-1}) - c_j (x_j - x_{j+1}) is formed in
  // float64, where the products and differences of float32 values are
  // exact, and rounded once (a float64 system's in float64 itself).
  T xp, xn;
  g.exchange(x[0], x[E - 1], xp, xn);
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const double ak = k == 0 ? cf.a0() : (cf.c(k - 1) ? 1.0 : 0.0);
    const double ck = cf.c(k) ? 1.0 : 0.0;
    const double xk = x[k];
    const double xl = k > 0 ? x[k - 1] : xp, xr = k + 1 < E ? x[k + 1] : xn;
    res[k] = static_cast<T>(static_cast<double>(r[k]) - cf.ex[k] * xk -
                            ak * (xk - xl) - ck * (xk - xr));
  }
  sys.solve(g, res, dx);
#pragma unroll
  for (int k = 0; k < E; ++k) x[k] += dx[k];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = j0 + k;
    if (j < n) out[base + j] = x[k];
  }
}

template <class T, int E, int W>
int launch(const T* rhs, const uint8_t* mask, const T* shift, T* out, int B,
           int n, cudaStream_t stream) {
  const int blocks = W == 1 ? (B + kRowsPerBlock - 1) / kRowsPerBlock : B;
  pcr_kernel<T, E, W><<<blocks, threads_of<W>(), 0, stream>>>(
      rhs, mask, shift, out, B, n);
  return static_cast<int>(cudaGetLastError());
}

// A row covers 32 W E elements.
template <class T>
int solve(const T* rhs, const uint8_t* mask, const T* shift, T* out, int B,
          int n, cudaStream_t stream) {
#define PCR_LAUNCH(E, W) \
  return launch<T, E, W>(rhs, mask, shift, out, B, n, stream)
  if (n <= 128) PCR_LAUNCH(4, 1);
  if (n <= 256) PCR_LAUNCH(8, 1);
  if (n <= 512) PCR_LAUNCH(4, 4);
  if (n <= 1024) PCR_LAUNCH(4, 8);
  if (n <= 2048) PCR_LAUNCH(8, 8);
  if (n <= 4096) PCR_LAUNCH(8, 16);
  if (n <= 8192) PCR_LAUNCH(16, 16);
#undef PCR_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" const char* proxtv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// rhs, out: (B, n) float32; mask: (B, n) uint8 or NULL; shift: (B,) or NULL.
// 2 <= n <= 8192 (checked by the Python wrapper).
extern "C" int pcr_spd_solve(const float* rhs, const uint8_t* mask,
                             const float* shift, float* out, int B, int n,
                             cudaStream_t stream) {
  return solve<float>(rhs, mask, shift, out, B, n, stream);
}

// The same in float64: rhs, out and shift double.
extern "C" int pcr_spd_solve_f64(const double* rhs, const uint8_t* mask,
                                 const double* shift, double* out, int B,
                                 int n, cudaStream_t stream) {
  return solve<double>(rhs, mask, shift, out, B, n, stream);
}
