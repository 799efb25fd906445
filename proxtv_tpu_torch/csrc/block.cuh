// Warp reductions shared by the per-fiber kernels (pn_fused.cu, and through
// fiber.cuh pcr.cu, ms_fused.cu, lp_fused.cu) and the PDHG chunk
// (pdhg_fused.cu).
//
// Every loop branch of a fiber solve must be uniform across the block, or a
// __syncthreads() inside it deadlocks.  So the reductions here give every
// lane a bitwise-identical result (butterfly shuffles), and the kernels
// reduce the per-warp partials the same way in every warp.
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

}  // namespace
