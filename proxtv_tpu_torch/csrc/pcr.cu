// Kernel B2: batched SPD second-difference tridiagonal solve by parallel
// cyclic reduction, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel proxtv_tpu/ops/kernels/pcr.py:pcr_spd_solve_pallas
// (its three pallas_calls: plain, masked, shifted).  Solves
//     (DD' [+ shift I]) x = rhs        per row of a (B, n) float32 batch,
// masked rows becoming identity rows with zero right-hand side.
//
// What bounds it on this card: each row is read once and written once
// (plus the mask), so a (10000, 1000) batch moves ~90 MB, ~27 us at
// 3.35 TB/s; the reduction does ceil(log2 n) steps of ~20 flops per
// element, ~2 GFLOP, ~30 us at 67 TFLOP/s f32 — compute-leaning.  In
// practice the shared-memory traffic of the steps (12 loads / 4 stores of
// 4 bytes per element per step) and two __syncthreads() per step set the
// pace.
//
// Design: one block per row, the four coefficient arrays (a, b, c, d) of the
// whole row resident in shared memory (4 n floats, 128 KB at n = 8192, above
// the 48 KB default, hence cudaFuncSetAttribute).  The TPU kernel double
// buffers the shifted copies in VMEM; here each step is done in place: every
// thread reads its stride neighbours into registers, the block syncs, every
// thread writes its own new values, the block syncs.  Thread t owns elements
// t, t + T, t + 2T, ... (coalesced loads/stores, up to 8 per thread).  The
// arithmetic is the TPU kernel's general (a, b, c, d) form, step for step,
// with the mask applied by the same float 0/1 algebra.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxPer = 8;  // 8192 / 1024 elements per thread

__global__ void __launch_bounds__(kMaxThreads)
pcr_kernel(const float* __restrict__ rhs, const uint8_t* __restrict__ mask,
           const float* __restrict__ shift, float* __restrict__ out, int n) {
  extern __shared__ float smem[];
  float* a = smem;
  float* b = a + n;
  float* c = b + n;
  float* d = c + n;
  const int T = blockDim.x;
  const size_t row = blockIdx.x;
  const float* r = rhs + row * n;

  if (mask != nullptr) {
    const uint8_t* mr = mask + row * n;
    for (int j = threadIdx.x; j < n; j += T) {
      const float m = mr[j] ? 1.f : 0.f;
      const float mm = (j > 0 && mr[j - 1]) ? 1.f : 0.f;
      const float mp = (j + 1 < n && mr[j + 1]) ? 1.f : 0.f;
      a[j] = 1.f + m;
      b[j] = -(m * mm);
      c[j] = (j + 1 < n) ? -(mp * m) : 0.f;
      d[j] = m * r[j];
    }
  } else {
    const float s = shift != nullptr ? shift[row] : 0.f;
    for (int j = threadIdx.x; j < n; j += T) {
      a[j] = 2.f + s;
      b[j] = j > 0 ? -1.f : 0.f;
      c[j] = j + 1 < n ? -1.f : 0.f;
      d[j] = r[j];
    }
  }
  __syncthreads();

  for (int s = 1; s < n; s <<= 1) {
    float na[kMaxPer], nb[kMaxPer], nc[kMaxPer], nd[kMaxPer];
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      const int j = threadIdx.x + k * T;
      if (j < n) {
        const bool lo = j - s >= 0, hi = j + s < n;
        const float am = lo ? a[j - s] : 1.f;
        const float ap = hi ? a[j + s] : 1.f;
        const float bm = lo ? b[j - s] : 0.f;
        const float bp = hi ? b[j + s] : 0.f;
        const float cm = lo ? c[j - s] : 0.f;
        const float cp = hi ? c[j + s] : 0.f;
        const float dm = lo ? d[j - s] : 0.f;
        const float dp = hi ? d[j + s] : 0.f;
        const float alpha = -b[j] / am;
        const float beta = -c[j] / ap;
        na[k] = a[j] + alpha * cm + beta * bp;
        nd[k] = d[j] + alpha * dm + beta * dp;
        nb[k] = alpha * bm;
        nc[k] = beta * cp;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      const int j = threadIdx.x + k * T;
      if (j < n) {
        a[j] = na[k];
        b[j] = nb[k];
        c[j] = nc[k];
        d[j] = nd[k];
      }
    }
    __syncthreads();
  }
  float* o = out + row * n;
  for (int j = threadIdx.x; j < n; j += T) o[j] = d[j] / a[j];
}

}  // namespace

extern "C" const char* proxtv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// rhs, out: (B, n) float32; mask: (B, n) uint8 or NULL; shift: (B,) or NULL.
extern "C" int pcr_spd_solve(const float* rhs, const uint8_t* mask,
                             const float* shift, float* out, int B, int n,
                             cudaStream_t stream) {
  const int threads = ((n < kMaxThreads ? n : kMaxThreads) + 31) / 32 * 32;
  const size_t smem = 4 * sizeof(float) * static_cast<size_t>(n);
  cudaError_t e = cudaFuncSetAttribute(
      pcr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  pcr_kernel<<<B, threads, smem, stream>>>(rhs, mask, shift, out, n);
  return static_cast<int>(cudaGetLastError());
}
