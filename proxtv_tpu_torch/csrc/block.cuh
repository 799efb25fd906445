// Warp- and block-wide reductions shared by the per-fiber kernels
// (pn_fused.cu, ms_fused.cu, lp_fused.cu) and the PDHG chunk (pdhg_fused.cu).
//
// Every loop branch of a fiber solve must be uniform across the block, or a
// __syncthreads() inside it deadlocks.  So the reductions here give every
// thread a bitwise-identical result: butterfly shuffles within each warp,
// then every warp reduces the per-warp partials itself.
#pragma once

#include <cuda_runtime.h>

namespace {

enum { kSum = 0, kMax = 1, kMin = 2 };

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

template <int OP>
__device__ __forceinline__ float op2(float a, float b) {
  if (OP == kSum) return a + b;
  if (OP == kMax) return fmaxf(a, b);
  return fminf(a, b);
}

template <int OP>
__device__ __forceinline__ float warp_reduce(float v) {
  // Butterfly: every lane ends with the same (commutative) pair sums, so
  // the result is bitwise identical across lanes.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = op2<OP>(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction; every thread returns the same value.  The leading
// barrier keeps the previous reduction's readers off the buffer (32 floats).
template <int OP>
__device__ float block_reduce(float v, float* red) {
  v = warp_reduce<OP>(v);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  const float ident = OP == kSum ? 0.f : (OP == kMax ? -inf_f() : inf_f());
  v = lane < nw ? red[lane] : ident;
  return warp_reduce<OP>(v);
}

}  // namespace
