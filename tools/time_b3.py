#!/usr/bin/env python3
"""Time kernel B3 (2D PDHG chunk, ``csrc/pdhg_fused.cu``) per launch on one
CUDA card, at the canvases given as MxN:K[:cert][:w] (an M x N image laid
out as the 2D driver lays it, K steps a chunk, the certificate on or off,
weight fields or not).

    python3 tools/time_b3.py 1024x1024:8:cert 1024x1024:8 1024x1024:8:cert:w

The default is those three: the ``tv1_2d`` auto chunk at 1024^2 (a
1088 x 1024 canvas at K = 8), the same without the certificate, and the
weighted route's chunk.  The state is the driver's mid-solve: three
chunks of the plain version from a randn image at lam 0.3 (cp-acc, as
``chip_smoke.py`` phase 2).  Each case is first held against the plain
version on the whole canvas (every field within 1e-4, the certificate
sums within 1e-4 relative: ``chip_smoke.py`` ``TOL["pdhg"]``).  Then CUDA
events time 200 launches after one untimed, every case in turn, ROUNDS
times, so cases are compared within one call.  ``kernel_ms`` times the C
entry point alone, called with its arguments made once
(``pdhg_fused.bind``); ``ms`` times the Python wrapper ``pdhg_chunk``
(argument checks, the output allocations, the ctypes call), which is what
the 2D driver pays per launch.  Prints one JSON line with the card's name
and power limit, the compiler's register, shared-memory and spill lines of
the B3 source, the resident blocks per SM where the build reports them,
and each case's times, bound and agreement.

The package is imported from the tree this file sits in, so a copy of this
file in another checkout of the repo times that checkout's kernel; where
that checkout's ``pdhg_fused`` has no ``bind``, its C entry point (whose
signature has not changed) is called with arguments made here.  Imports
nothing of JAX.
"""
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LAM, TM, GAP_ROWS = 0.3, 32, 8
REPS, ROUNDS, TOL = 200, 3, 1e-4
PEAK_BYTES_S, PEAK_F32_FLOP_S = 3.35e12, 67e12  # H100 SXM data sheet
OPS_PER_STEP, OPS_CERT = 22, 25  # as chip_smoke.py PDHG_OPS_PER_STEP


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
    """The register / shared-memory / spill lines of the B3 source."""
    part = log.split("== pdhg_fused.cu", 1)[-1].split("\n== ", 1)[0]
    return [ln.strip() for ln in part.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]


def bind(B3, build, sched, st, y, geo, wr, wc, cert):
    """``B3.bind``, or the same C call made here for a tree without it."""
    kw = {k_: v for k_, v in geo.items() if k_ != "tm"}
    if hasattr(B3, "bind"):
        return B3.bind(sched, *st, y, wr=wr, wc=wc, cert=cert, **kw)
    import torch

    lib = build.lib()
    Mp, Np = y.shape
    outs = [torch.empty_like(y) for _ in range(4)]
    if cert:
        n = lib.pdhg_cert_blocks(Mp, Np)
        outs += [torch.empty((n, 1), device=y.device) for _ in range(2)]
    gap, obj = outs[4:] if cert else (None, None)
    args = (build.ptr(sched), *(build.ptr(f) for f in (*st, y)),
            build.ptr(wr), build.ptr(wc), *(build.ptr(o) for o in outs[:4]),
            build.ptr(gap), build.ptr(obj), Mp, Np, kw["k_steps"],
            kw["n_valid"], kw["m_valid"], kw["stride"], kw["count"],
            kw["pad_top"], 0, build.stream_ptr(y.device))
    return tuple(outs), lambda: build.check(lib.pdhg_chunk(*args),
                                            "pdhg_chunk")


def main(specs):
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from proxtv_tpu_torch.ops.kernels import build
    from proxtv_tpu_torch.ops.kernels import pdhg_fused as B3

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    build.build(force=True)  # in this process, for the compiler's lines
    lib = build.lib()
    occupancy = getattr(lib, "pdhg_blocks_per_sm", None)
    rng = np.random.RandomState(0)
    cases, ok = [], True
    for spec in specs:
        shape, k_s, *flags = spec.split(":")
        M, N = (int(v) for v in shape.split("x"))
        k, cert, weighted = int(k_s), "cert" in flags, "w" in flags
        halo, S = 2 * k, M + GAP_ROWS  # the driver's canvas (models/tv2d.py)
        Mp = -(-S // TM) * TM + 2 * halo
        Np = -(-N // 128) * 128
        y = torch.zeros((Mp, Np), device="cuda")
        y[halo:halo + M, :N] = torch.from_numpy(
            rng.randn(M, N).astype(np.float32)).cuda()
        sched = torch.from_numpy(B3.make_schedule(
            k, LAM, np.float32(0.5), np.float32(0.225), "cp-acc",
            4.0)).cuda()
        geo = dict(k_steps=k, tm=TM, n_valid=N, m_valid=M, stride=S,
                   count=1, pad_top=halo)
        st = (y, y, torch.zeros_like(y), torch.zeros_like(y))
        for _ in range(3):
            st = B3.pdhg_chunk_plain(sched, *st, y, **geo)
        st = tuple(a.contiguous() for a in st)
        wr = wc = None
        if weighted:
            wr, wc = ((0.2 + 0.3 * torch.rand((Mp, Np), device="cuda"))
                      for _ in range(2))
        ref = B3.pdhg_chunk_plain(sched, *st, y, **geo, wr=wr, wc=wc,
                                  cert=cert)
        out = B3.pdhg_chunk(sched, *st, y, **geo, wr=wr, wc=wc, cert=cert)
        outs, launch = bind(B3, build, sched, st, y, geo, wr, wc, cert)
        launch()
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(out, ref[:4]))
        rel = max((abs(float(a.sum()) - float(b.sum()))
                   / max(1.0, abs(float(b.sum()))))
                  for a, b in zip(out[4:], ref[4:])) if cert else 0.0
        same = all(bool(torch.equal(a, b)) for a, b in zip(outs, out))
        ok = ok and err <= TOL and rel <= TOL and same
        nbytes = Mp * Np * 4 * (9 + 2 * weighted)
        flops = Mp * Np * (k * OPS_PER_STEP + OPS_CERT * cert)
        c = dict(spec=spec, canvas=[Mp, Np], k_steps=k, cert=cert,
                 weighted=weighted, max_abs_err=err, cert_rel_err=rel,
                 c_entry_equals_wrapper=same, kernel_ms=[], ms=[],
                 bound_ms=max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S)
                 * 1e3)
        if occupancy is not None:
            c["blocks_per_sm"] = occupancy(int(weighted))
        cases.append((c, launch, lambda a=(sched, *st, y), g=geo, w=(wr, wc),
                      ce=cert: B3.pdhg_chunk(*a, **g, wr=w[0], wc=w[1],
                                             cert=ce)))
    for _ in range(ROUNDS):
        for c, launch, wrapper in cases:
            c["kernel_ms"].append(time_ms(launch))
            c["ms"].append(time_ms(wrapper))
    print(json.dumps({"card": card,
                      "ptxas": ptxas_lines(build.BUILD_LOG["ptxas"] or ""),
                      "cases": [c for c, *_ in cases]}))
    if not ok:
        sys.exit("B3 disagrees with its plain version")


if __name__ == "__main__":
    main(sys.argv[1:] or ["1024x1024:8:cert", "1024x1024:8",
                          "1024x1024:8:cert:w"])
