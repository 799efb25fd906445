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
// Design (float32): a row runs on W warps (fiber.cuh; W = 1, four rows a
// block, for n <= 256; E = 4 and 4 or 8 warps up to 1024, where a launch
// of one row is latency and the shorter serial chain wins), lane r holding
// the chunk j = rE .. rE + E - 1 of the right-hand side in registers;
// lanes past n are identity rows.  Each lane makes its chunk's couplings and row excesses from its own mask bytes
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
// batch, the shifted systems of TV-L2's and the setup systems of TV-Lp's
// float64 routes).  Float64 has layouts of its own (kLayouts64), each one
// solve with no refinement step (the residual would be formed in the
// solve's own precision, and the solve alone lands within 1e-15 of the
// solution's size of the plain version at every layout edge):
// * n <= 32, one thread a row (pcr_rows_kernel): the ND drivers' fibers
//   along a 32-long axis come 65536 rows at a time, and one warp a row
//   left 24 of its 32 lanes with nothing to hold while running the lane
//   PCR over all 32; a block stages its 128 rows through shared memory
//   with coalesced loads and stores, and each thread eliminates its row
//   serially (C_j in registers);
// * longer rows on W warps as in float32, at the E / W that ran fastest
//   on an H100 at the main path's shapes (fewer warps a row, more
//   elements a lane: fewer PCR levels and less of the lanes' redundant
//   PCR work), the row staged through shared memory where that won
//   (1024 x 1023).
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

// One row's solve on W warps; kRefine: the step of iterative refinement
// after it; kStage: the row read and written through shared memory with
// coalesced loads and stores (element j at [(j mod E) P + j / E], so that
// each lane's chunk element k lies at [k P + rank], P = 32 W + 16 / E
// keeping both sides free of bank conflicts), instead of each lane
// reading and writing its chunk in global memory.
template <class T, int E, int W, bool kRefine, bool kStage = false>
__device__ __forceinline__ void pcr_row(const T* __restrict__ rhs,
                                        const uint8_t* __restrict__ mask,
                                        const T* __restrict__ shift,
                                        T* __restrict__ out, int nrows,
                                        int n) {
  __shared__ T slots[W > 1 ? 2 * kSlot : 1];
  constexpr int P = 32 * W + 16 / E;
  __shared__ T stage[kStage ? (W == 1 ? kRowsPerBlock : 1) * E * P : 1];
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
  T* sr = stage + (W == 1 ? (threadIdx.x >> 5) * E * P : 0);
  if constexpr (kStage) {
    for (int j = g.rank(); j < n; j += 32 * W)
      sr[(j % E) * P + j / E] = rhs[base + j];
    if constexpr (W == 1)
      __syncwarp();
    else
      __syncthreads();
  }
  // Chunk element k (sample j0 + k < n) of the right-hand side.
  auto rhs_k = [&](int k) {
    if constexpr (kStage)
      return sr[k * P + g.rank()];
    else
      return rhs[base + (j0 + k)];
  };

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
      r[k] = cur ? rhs_k(k) : T(0);
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
      r[k] = act ? rhs_k(k) : T(0);
    }
  }
  sys.setup();
  T x[E];
  sys.solve(g, r, x);
  if constexpr (kRefine) {
    // One step of iterative refinement.  The residual
    // r_j - e_j x_j - a_j (x_j - x_{j-1}) - c_j (x_j - x_{j+1}) is formed in
    // float64, where the products and differences of float32 values are
    // exact, and rounded once (a float64 system's in float64 itself).
    T xp, xn, dx[E], res[E];
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
  }
  if constexpr (kStage) {
#pragma unroll
    for (int k = 0; k < E; ++k) sr[k * P + g.rank()] = x[k];
    if constexpr (W == 1)
      __syncwarp();
    else
      __syncthreads();
    for (int j = g.rank(); j < n; j += 32 * W)
      out[base + j] = sr[(j % E) * P + j / E];
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int j = j0 + k;
      if (j < n) out[base + j] = x[k];
    }
  }
}

template <class T, int E, int W>
__global__ void __launch_bounds__(threads_of<W>())
pcr_kernel(const T* __restrict__ rhs, const uint8_t* __restrict__ mask,
           const T* __restrict__ shift, T* __restrict__ out,
           int nrows, int n) {
  pcr_row<T, E, W, true>(rhs, mask, shift, out, nrows, n);
}

// The same solve in float64 without the refinement step (kStage: the row
// through shared memory).
template <int E, int W, bool kStage>
__global__ void __launch_bounds__(threads_of<W>())
pcr_once_kernel(const double* __restrict__ rhs,
                const uint8_t* __restrict__ mask,
                const double* __restrict__ shift, double* __restrict__ out,
                int nrows, int n) {
  pcr_row<double, E, W, false, kStage>(rhs, mask, shift, out, nrows, n);
}

// Float64 rows of n <= NMAX, one thread a row (the row layout): a block's
// kRowsBlock rows, contiguous in the batch, are staged into shared memory
// (and their mask bytes) with coalesced loads; each thread eliminates its
// row downward in the pivots of tridiag.cuh (every pivot the row's excess
// plus its couplings, all nonnegative), keeping C_j = c_j / pivot_j in
// registers and S_j in its row's shared slots, then substitutes upward
// into those slots, and the block writes the rows back coalesced.  No
// refinement: the rows are short, the systems' condition at most ~4 NMAX^2
// / pi^2.
constexpr int kRowsBlock = 128;

template <int NMAX>
__global__ void __launch_bounds__(kRowsBlock, 4)
pcr_rows_kernel(const double* __restrict__ rhs,
                const uint8_t* __restrict__ mask,
                const double* __restrict__ shift, double* __restrict__ out,
                int nrows, int n) {
  __shared__ double st[kRowsBlock * NMAX];
  __shared__ uint8_t mk[kRowsBlock * NMAX];
  const int t = threadIdx.x;
  const size_t r0 = static_cast<size_t>(blockIdx.x) * kRowsBlock;
  const int rows = min(kRowsBlock, static_cast<int>(nrows - r0));
  const int cnt = rows * n;
  const size_t base = r0 * n;
  for (int q = t; q < cnt; q += kRowsBlock) st[q] = rhs[base + q];
  if (mask != nullptr)
    for (int q = t; q < cnt; q += kRowsBlock) mk[q] = mask[base + q];
  __syncthreads();
  if (t < rows) {
    double* row = st + t * n;
    const uint8_t* m = mk + t * n;
    const double s0 = shift != nullptr ? shift[r0 + t] : 0.0;
    double C[NMAX];
    double sig = 0.0, sp = 0.0;  // the row above's excess and S
    bool ap = false;             // a_j = c_{j-1}
    bool cur = mask == nullptr || m[0] != 0;
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      if (j < n) {
        bool c;
        double e, rj;
        if (mask != nullptr) {
          const bool nxt = j + 1 < n && m[j + 1] != 0;
          c = cur && nxt;
          e = (cur ? 2.0 : 1.0) - (ap ? 1.0 : 0.0) - (c ? 1.0 : 0.0);
          rj = cur ? row[j] : 0.0;
          cur = nxt;
        } else {
          c = j + 1 < n;
          e = s0 + (ap ? 0.0 : 1.0) + (c ? 0.0 : 1.0);
          rj = row[j];
        }
        const double sx = ap ? sig + e : e;
        const double inv = rcp(sx + (c ? 1.0 : 0.0));
        sig = sx * inv;
        sp = (ap ? rj + sp : rj) * inv;
        row[j] = sp;
        C[j] = c ? inv : 0.0;
        ap = c;
      }
    }
    double xv = 0.0;
#pragma unroll
    for (int j = NMAX - 1; j >= 0; --j) {
      if (j < n) {
        xv = fma(C[j], xv, row[j]);
        row[j] = xv;
      }
    }
  }
  __syncthreads();
  for (int q = t; q < cnt; q += kRowsBlock) out[base + q] = st[q];
}

__global__ void pcr_empty_kernel() {}

template <class T, int E, int W>
int launch(const T* rhs, const uint8_t* mask, const T* shift, T* out, int B,
           int n, cudaStream_t stream) {
  const int blocks = W == 1 ? (B + kRowsPerBlock - 1) / kRowsPerBlock : B;
  pcr_kernel<T, E, W><<<blocks, threads_of<W>(), 0, stream>>>(
      rhs, mask, shift, out, B, n);
  return static_cast<int>(cudaGetLastError());
}

template <int E, int W, bool kStage = false>
int launch_once(const double* rhs, const uint8_t* mask, const double* shift,
                double* out, int B, int n, cudaStream_t stream) {
  const int blocks = W == 1 ? (B + kRowsPerBlock - 1) / kRowsPerBlock : B;
  pcr_once_kernel<E, W, kStage><<<blocks, threads_of<W>(), 0, stream>>>(
      rhs, mask, shift, out, B, n);
  return static_cast<int>(cudaGetLastError());
}

int launch_rows(const double* rhs, const uint8_t* mask, const double* shift,
                double* out, int B, int n, cudaStream_t stream) {
  pcr_rows_kernel<32><<<(B + kRowsBlock - 1) / kRowsBlock, kRowsBlock, 0,
                        stream>>>(rhs, mask, shift, out, B, n);
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

// The float64 layouts, in the order of n they take: a name, the longest n,
// and its launch.  "rows": one thread a row; "E<e>W<w>": a row on w
// warps, e elements a lane, one solve, "s" staged (kStage).  A system of
// n takes the first layout whose longest n covers it.  Each was the
// fastest of the E/W layouts at its shapes on an H100 (tools/time_b2.py
// --dtype float64; PERF.md), the float32 layouts' refinement step
// dropped: in float64 the solve alone stays within 1e-16 to 1e-15 of the
// solution's size of the plain version (its PCR) at every layout edge.
struct Layout64 {
  const char* name;
  int max_n;
  int (*run)(const double*, const uint8_t*, const double*, double*, int,
             int, cudaStream_t);
};
#define PCR_ONCE(E, W) {"E" #E "W" #W, 32 * (E) * (W), launch_once<E, W>}
constexpr Layout64 kLayouts64[] = {
    {"rows", 32, launch_rows}, PCR_ONCE(4, 1), PCR_ONCE(8, 1),
    PCR_ONCE(8, 2), {"E8W4s", 1024, launch_once<8, 4, true>},
    PCR_ONCE(8, 8), PCR_ONCE(8, 16), PCR_ONCE(16, 16)};
#undef PCR_ONCE
constexpr int kNumLayouts64 = sizeof(kLayouts64) / sizeof(kLayouts64[0]);

int layout_of(int n) {
  for (int i = 0; i < kNumLayouts64; ++i)
    if (n <= kLayouts64[i].max_n) return i;
  return -1;
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

// The same in float64 (rhs, out and shift double), in the layout that
// pcr_f64_layout_of(n) names.
extern "C" int pcr_spd_solve_f64(const double* rhs, const uint8_t* mask,
                                 const double* shift, double* out, int B,
                                 int n, cudaStream_t stream) {
  const int i = layout_of(n);
  if (i < 0) return static_cast<int>(cudaErrorInvalidValue);
  return kLayouts64[i].run(rhs, mask, shift, out, B, n, stream);
}

// The same in the float64 layout numbered `layout` (for tools and tests
// that compare the layouts); n must be within its longest.
extern "C" int pcr_spd_solve_f64_layout(const double* rhs,
                                        const uint8_t* mask,
                                        const double* shift, double* out,
                                        int B, int n, int layout,
                                        cudaStream_t stream) {
  if (layout < 0 || layout >= kNumLayouts64 ||
      n > kLayouts64[layout].max_n)
    return static_cast<int>(cudaErrorInvalidValue);
  return kLayouts64[layout].run(rhs, mask, shift, out, B, n, stream);
}

// Float64 layout `i`'s name and longest n (NULL and 0 past the last), and
// the number of the layout a system of n takes.
extern "C" const char* pcr_f64_layout_name(int i) {
  return i >= 0 && i < kNumLayouts64 ? kLayouts64[i].name : nullptr;
}
extern "C" int pcr_f64_layout_max_n(int i) {
  return i >= 0 && i < kNumLayouts64 ? kLayouts64[i].max_n : 0;
}
extern "C" int pcr_f64_layout_of(int n) { return layout_of(n); }

// An empty kernel, launched as the solves are: the launch floor a timing
// of them is set beside.
extern "C" int pcr_empty_launch(cudaStream_t stream) {
  pcr_empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
