#!/usr/bin/env python3
"""Time kernel B6 (3D PDHG chunk, ``csrc/pdhg3d_fused.cu``) per launch and
per iteration on one CUDA card, at the 32 x 256 x 256 canvas of the
``tvgen_nd`` main path, for the step counts and tiles given as K:TL,TM,TN
(or ``default`` for ``gating.pdhg3d_params``).

    python3 tools/time_b6.py default 3:32,16,16 4:32,16,16 2:16,16,16

The canvas is a randn volume at lam 0.3 per axis, six cp-acc chunks into a
solve (as ``chip_smoke.py`` phase 2).  Each variant is first held against
the plain version for cp-acc (every field within 1e-5).  Then CUDA events
time 200 launches after one untimed, every variant in turn, ROUNDS times,
so variants are compared within one call.  ``ms`` times the C entry point
alone, called with its arguments made once (the kernel's time: the launch
costs the host a few microseconds); ``wrapper_ms`` times the Python wrapper
``pdhg3d_chunk`` (argument checks, one allocation of its five outputs,
the ctypes call), which is what the 3D driver pays per launch.  Prints one JSON line
with the card's name and power limit, and each variant's ms per launch and
per iteration (one per round), its bound, threads and shared memory per
block, resident blocks per SM where the build reports it, and the
compiler's register and spill lines of the B6 source.

The package is imported from the tree this file sits in, so a copy of this
file in another checkout of the repo times that checkout's kernel (there
``tile`` means what that checkout's ``pdhg3d_chunk`` takes).  Imports
nothing of JAX.
"""
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

L, M, N, LAM = 32, 256, 256, 0.3
REPS, ROUNDS, TOL = 200, 3, 1e-5
PEAK_BYTES_S = 3.35e12  # H100 SXM data sheet


def time_ms(fn):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def ptxas_lines(log):
    """The register / shared-memory / spill lines of the B6 source."""
    part = log.split("== pdhg3d_fused.cu", 1)[-1].split("\n== ", 1)[0]
    return [ln.strip() for ln in part.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]


def main(specs):
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from proxtv_tpu_torch.ops.kernels import build, gating
    from proxtv_tpu_torch.ops.kernels import pdhg3d_fused as B6

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    build.build(force=True)  # in this process, for the compiler's lines
    lib = build.lib()
    occupancy = getattr(lib, "pdhg3d_blocks_per_sm", None)
    rng = np.random.RandomState(0)
    V = torch.from_numpy(rng.randn(L, M, N).astype(np.float32)).cuda()
    geo = dict(n_valid=N, m_valid=M, l_valid=L, stride=L, count=1)

    def sched(k):
        return torch.from_numpy(B6.make_schedule3(
            k, (LAM,) * 3, np.float32(0.5), np.float32(0.15), "cp-acc",
            4.0)).cuda()

    k0 = gating.pdhg3d_params()[0]
    st = (V, V, torch.zeros_like(V), torch.zeros_like(V), torch.zeros_like(V))
    for _ in range(6):
        st = B6.pdhg3d_chunk_plain(sched(k0), *st, V, k_steps=k0, **geo)
    st = tuple(a.contiguous() for a in st)

    variants, ok = [], True
    for spec in specs:
        if spec == "default":
            k, tile = gating.pdhg3d_params()
        else:
            ks, ts = spec.split(":")
            k, tile = int(ks), tuple(int(v) for v in ts.split(","))
        sd = sched(k)
        ref = B6.pdhg3d_chunk_plain(sd, *st, V, k_steps=k, **geo)
        out = B6.pdhg3d_chunk(sd, *st, V, k_steps=k, tile=tile, **geo)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
        ok = ok and err <= TOL
        v = {"spec": spec, "k_steps": k, "tile": list(tile),
             "max_abs_err": err, "ms": [], "ms_per_iter": [],
             "wrapper_ms": [],
             "bound_ms": L * M * N * 4 * 11 / PEAK_BYTES_S * 1e3,
             "bound_ms_per_iter": L * M * N * 4 * 11 / PEAK_BYTES_S * 1e3 / k,
             "smem_bytes": B6.smem_bytes(k, tile)}
        if hasattr(B6, "window_columns"):
            v["threads"] = B6.window_columns(k, tile)
        if occupancy is not None:
            v["blocks_per_sm"] = occupancy(k, tile[1], tile[2])
        outs = [torch.empty_like(V) for _ in range(5)]
        args = ([build.ptr(sd)] + [build.ptr(f) for f in (*st, V)]
                + [build.ptr(o) for o in outs]
                + [L, M, N, k, *tile, N, M, L, L, 1, 0, 0, 0,
                   build.stream_ptr(V.device)])
        build.check(lib.pdhg3d_chunk(*args), "pdhg3d_chunk")
        torch.cuda.synchronize()
        check = max(float((a - b).abs().max()) for a, b in zip(outs, out))
        ok = ok and check == 0.0
        variants.append((v, sd, k, tile, args))
    for _ in range(ROUNDS):
        for v, sd, k, tile, args in variants:
            ms = time_ms(lambda: lib.pdhg3d_chunk(*args))
            v["ms"].append(ms)
            v["ms_per_iter"].append(ms / k)
            v["wrapper_ms"].append(time_ms(lambda: B6.pdhg3d_chunk(
                sd, *st, V, k_steps=k, tile=tile, **geo)))
    print(json.dumps({"card": card, "canvas": [L, M, N],
                      "ptxas": ptxas_lines(build.BUILD_LOG["ptxas"] or ""),
                      "variants": [v for v, *_ in variants]}))
    if not ok:
        sys.exit("B6 disagrees with its plain version")


if __name__ == "__main__":
    main(sys.argv[1:] or ["default"])
