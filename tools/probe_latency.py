#!/usr/bin/env python3
"""Measure what one warp alone on a scheduler waits for on one CUDA card,
and what kernels D3 (Condat) and D4 (classic taut string) spend an event.

    python3 tools/probe_latency.py

One warp runs, timed by clock64() on the card: a chain of 4096 dependent
float adds, of 4096 dependent shared-memory reads, of 4096 dependent IEEE
divides, a loop of 4096 data-dependent branches, and D3's and D4's scans
(``csrc/condat.cu`` condat_scan, ``csrc/classic_ts.cu`` classic_scan, the
code the kernels run) on ``chip_smoke.py``'s random walk of 1000 at lam
2.0, out of shared memory, their runs counted and not written.  Events a
signal come from the plain versions on the CPU (``tools/time_direct.py``).
Prints
one JSON line: the card's name, power limit and clock (clock64 cycles over
the global timer's ns), cycles an operation of each chain, and each scan's
cycles and cycles an event.  Builds with ``nvcc`` into
``build/probe_latency/``.  Imports nothing of JAX.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))
SRC = r'''
#include <cuda_runtime.h>
#include <limits.h>
#include "direct1d.cuh"
namespace d3 {
#include "condat.cu"
}
namespace d4 {
#include "classic_ts.cu"
}

__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// out[0..]: cycles of each chain, the global timer's ns over the first.
__global__ void chains(const float* y, int n, float* sink, long long* out) {
  __shared__ float sm[4096];
  __shared__ int si[4096];
  for (int i = threadIdx.x; i < 4096; i += 32) {
    sm[i] = y[i % n];
    si[i] = (i * 7 + 1) & 4095;
  }
  __syncwarp();
  float a = sink[0];
  long long t0 = clock64();
  unsigned long long g0 = gtimer();
#pragma unroll 64
  for (int i = 0; i < 4096; ++i) a = __fadd_rn(a, 1.0001f);
  out[0] = clock64() - t0;
  out[1] = (long long)(gtimer() - g0);
  int p = 0;
  t0 = clock64();
  for (int i = 0; i < 4096; ++i) p = si[p];
  out[2] = clock64() - t0;
  float d = sink[0] + 1.f;
  t0 = clock64();
  for (int i = 0; i < 4096; ++i) d = __fadd_rn(d / 1.0001f, 0.5f);
  out[3] = clock64() - t0;
  float b = sink[0];
  int c = 0;
  t0 = clock64();
  for (int i = 0; i < 4096; ++i) {
    if (sm[i] > 0.f) b = __fadd_rn(b, 1.f); else c += 1;
  }
  out[4] = clock64() - t0;
  sink[1] = a + p + d + b + c;
}

__global__ void scan_d3(const float* y, int n, float lam, long long* out) {
  __shared__ float ys[4096 + 2];
  for (int i = threadIdx.x; i < n; i += 32) ys[i] = y[i];
  __syncwarp();
  int runs = 0;
  const long long t0 = clock64();
  d3::condat_scan([&](int i) { return ys[i]; }, lam, n,
                  [&](int, int, float) { ++runs; });
  out[0] = clock64() - t0;
  out[1] = runs;
}

__global__ void scan_d4(const float* y, int n, float lam, long long* out) {
  __shared__ float4 dq[2 * (1000 + 2)];  // the two deques, n <= 1000
  __shared__ float ys[1000];
  for (int i = threadIdx.x; i < n; i += 32) ys[i] = y[i];
  __syncwarp();
  int runs = 0;
  const long long t0 = clock64();
  d4::classic_scan<true>([&](int i) { return ys[i]; }, lam, n,
                         8 * n + 64, d4::Deque<float>{dq, 1},
                         d4::Deque<float>{dq + n + 2, 1},
                         [&](int, float) { ++runs; });
  out[0] = clock64() - t0;
  out[1] = runs;
}

extern "C" int probe(const float* y, int n, float lam, float* sink,
                     long long* out) {
  chains<<<1, 32>>>(y, n, sink, out);
  scan_d3<<<1, 32>>>(y, n, lam, out + 8);
  scan_d4<<<1, 32>>>(y, n, lam, out + 12);
  return (int)cudaDeviceSynchronize();
}
'''


def main():
    import torch

    import time_direct

    from proxtv_tpu_torch.ops import tv1d_l1

    if not torch.cuda.is_available():
        sys.exit("probe_latency.py needs a CUDA card")
    out_dir = os.path.join(REPO, "build", "probe_latency")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "probe.cu")
    lib_path = os.path.join(out_dir, "libprobe.so")
    with open(cu, "w") as f:
        f.write(SRC)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", os.path.join(REPO, "proxtv_tpu_torch", "csrc"), cu,
                    "-o", lib_path], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.probe.argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p, ctypes.c_void_p)
    _, walk = time_direct.main_path_inputs(1000)
    n, lam = walk.shape[1], 2.0
    y = torch.from_numpy(walk[0]).cuda()
    sink = torch.zeros(4, device="cuda")
    out = torch.zeros(16, dtype=torch.int64, device="cuda")
    for _ in range(3):  # the last of three runs
        err = lib.probe(ctypes.c_void_p(y.data_ptr()), n, lam,
                        ctypes.c_void_p(sink.data_ptr()),
                        ctypes.c_void_p(out.data_ptr()))
        if err:
            sys.exit(f"the probe failed: CUDA error {err}")
    c = out.cpu().tolist()
    ev3 = time_direct.events(tv1d_l1.tv1_condat_plain, walk, lam)[1]
    ev4 = time_direct.events(tv1d_l1.tv1_classic_ts_plain, walk, lam)[1]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "card": card, "clock_ghz": c[0] / c[1],
        "float_add_cycles": c[0] / 4096, "shared_read_cycles": c[2] / 4096,
        "ieee_divide_cycles": c[3] / 4096 - c[0] / 4096,
        "branch_loop_cycles": c[4] / 4096,
        "d3_walk": {"cycles": c[8], "runs": c[9], "events": ev3,
                    "cycles_per_event": c[8] / ev3},
        "d4_walk": {"cycles": c[12], "runs": c[13], "events": ev4,
                    "cycles_per_event": c[12] / ev4}}))


if __name__ == "__main__":
    main()
