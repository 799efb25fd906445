// A fiber (one row of a batch) solved by W warps, each lane holding a
// contiguous chunk of the row in registers; shared by the per-fiber kernels
// B2 (pcr.cu), B4 (ms_fused.cu) and B5 (lp_fused.cu).  The crossings and
// the PCR step take the fiber's scalar type T: float, or double for B2's
// float64 instantiation (row sums are float only).
//
// Row sums are butterflies within a warp; across warps, partials go to
// double-buffered shared slots (the buffer alternates per use, so one
// barrier per crossing: crossing i + 2 reuses crossing i's buffer only after
// every thread passed crossing i + 1's barrier) and every warp reduces them
// in the same order, so every thread of the fiber holds the same bits and
// every loop branch is uniform.  W = 1 needs no barrier and no shared
// memory.
#pragma once

#include <cuda_runtime.h>

#include "block.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// The hardware's approximate reciprocal (within 1 ulp; flushes denormals);
// in double the correctly rounded one.
__device__ __forceinline__ float rcp(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ double rcp(double v) { return __drcp_rn(v); }

// a b + c rounded once.
__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}

// v of lane - s (0 below lane s) and of lane + s (0 at or past `width`).
template <class T>
__device__ __forceinline__ T from_below(T v, int s, int lane) {
  const T t = __shfl_up_sync(kFull, v, s);
  return lane >= s ? t : T(0);
}
template <class T>
__device__ __forceinline__ T from_above(T v, int s, int lane,
                                        int width = 32) {
  const T t = __shfl_down_sync(kFull, v, s);
  return lane + s < width ? t : T(0);
}

// The W warps of one fiber.  Crossings between warps (W > 1) go through
// double-buffered shared slots of SLOT values of T, one barrier each.
template <int W, int SLOT = 4 * 32, class T = float>
struct Fiber {
  int lane, wid;  // lane in its warp, warp in the fiber
  T* slots;       // 2 x SLOT (W > 1)
  int ph = 0;     // buffer parity (uniform across the fiber)

  __device__ int rank() const { return wid * 32 + lane; }

  __device__ __forceinline__ T* slot() {
    T* s = slots + (ph & 1) * SLOT;
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
  __device__ __forceinline__ void exchange(T first, T last, T& prev_last,
                                           T& next_first) {
    prev_last = from_below(last, 1, lane);
    next_first = from_above(first, 1, lane);
    if constexpr (W > 1) {
      T* s = slot();
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
  __device__ __forceinline__ void gather(T (&row)[4]) {
    if constexpr (W == 1) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        row[q] = __shfl_sync(kFull, row[q], lane == 1 ? 31 : 0);
    } else {
      T* s = slot();
      if (lane == 0 || lane == 31) {
        const int v = 2 * wid + (lane == 31);
#pragma unroll
        for (int q = 0; q < 4; ++q) s[4 * v + q] = row[q];
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 4; ++q) row[q] = lane < 2 * W ? s[4 * lane + q] : T(0);
    }
    if (lane >= 2 * W) {
      row[0] = row[1] = row[3] = T(0);
      row[2] = T(1);
    }
  }
};

// One PCR step at stride s on normalized rows x_i - lo x_{i-s} - up x_{i+s}
// - sum_c col_c = d with row excess ex (1 = ex + lo + up + sum of the
// columns): every pivot is a sum of nonnegative terms.  NC boundary columns
// travel with the right-hand side.
template <class T>
struct Same {
  using type = T;
};
template <int NC, class T>
__device__ __forceinline__ void pcr_step(T& lo, T& up, T& ex, T& d,
                                         typename Same<T>::type* col, int s,
                                         int lane, int width) {
  const T lom = from_below(lo, s, lane);
  const T exm = from_below(ex, s, lane);
  const T dm = from_below(d, s, lane);
  const T upp = from_above(up, s, lane, width);
  const T exp_ = from_above(ex, s, lane, width);
  const T dp = from_above(d, s, lane, width);
  const T nlo = lo * lom, nup = up * upp;
  const T nex = fma_(lo, exm, fma_(up, exp_, ex));
  T piv = nex + nlo + nup;
  T ncol[NC > 0 ? NC : 1];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const T cm = from_below(col[c], s, lane);
    const T cp = from_above(col[c], s, lane, width);
    ncol[c] = fma_(lo, cm, fma_(up, cp, col[c]));
    piv += ncol[c];
  }
  const T r = rcp(piv);
  d = fma_(lo, dm, fma_(up, dp, d)) * r;
  lo = nlo * r;
  up = nup * r;
  ex = nex * r;
#pragma unroll
  for (int c = 0; c < NC; ++c) col[c] = ncol[c] * r;
}

}  // namespace
