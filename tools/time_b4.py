#!/usr/bin/env python3
"""Time kernel B4 (More-Sorensen TV-L2, ``csrc/ms_fused.cu``) per launch on
one CUDA card, cold and warm, at the shapes given as FIBERSxN[@LAM]
(lam 1.0 unless given).

    python3 tools/time_b4.py 10000x1000 1024x1024@0.3 1x1000@2

Each shape's rows are randn.  Cold starts the secular iteration at
alpha = 0; warm starts from the alpha of a first solve on the same rows,
with a 0.05 randn perturbation added to the rows it solves.  Each case is
first held against the plain version (tb = 1): x within 1e-4, alpha within
1e-4 relative, iteration counts at most 1 apart on the rows under the cap
(the bars of ``chip_smoke.py`` ``TOL["ms"]`` and of the card test).  Then
CUDA events time 20 launches after one untimed, every case in turn, ROUNDS
times, so cases are compared within one call.  ``ms`` times the C entry
point alone, called with its arguments made once by ``ms_fused.bind`` (the
kernel's time); ``wrapper_ms`` times the Python wrapper ``ms_tv2_fused``
(argument checks, four allocations, the ctypes call).  Prints one JSON line with the card's
name and power limit, the compiler's register, shared-memory and spill
lines of the B4 source, and each case's times, solves per fiber and
agreement.

The package is imported from the tree this file sits in, so a copy of this
file in another checkout of the repo times that checkout's kernel (one
whose ``ms_fused`` has ``bind``).  Imports nothing of JAX.
"""
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS, ROUNDS, CAP = 20, 3, 100
TOL_X, TOL_ALPHA, TOL_ITERS = 1e-4, 1e-4, 1


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
    """The register / shared-memory / spill lines of the B4 source."""
    part = log.split("== ms_fused.cu", 1)[-1].split("\n== ", 1)[0]
    return [ln.strip() for ln in part.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]


def main(specs):
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from proxtv_tpu_torch.ops.kernels import build
    from proxtv_tpu_torch.ops.kernels import ms_fused as B4

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    build.build()  # reused if built; BUILD_LOG holds the compiler's lines
    rng = np.random.RandomState(0)
    cases, ok = [], True
    for spec in specs:
        shape, _, lam_s = spec.partition("@")
        lam = float(lam_s) if lam_s else 1.0
        B, n = (int(s) for s in shape.split("x"))
        y = torch.from_numpy(rng.randn(B, n).astype(np.float32)).cuda()
        _, a_first, _, _ = B4.ms_tv2_fused(y, lam=lam)
        y_warm = y + 0.05 * torch.from_numpy(
            rng.randn(B, n).astype(np.float32)).cuda()
        for start, yy, a0 in (("cold", y, None), ("warm", y_warm, a_first)):
            x_r, a_r, _, it_r = B4.ms_tv2_fused_plain(yy, lam=lam,
                                                      alpha_init=a0, tb=1)
            x, a, g, it = B4.ms_tv2_fused(yy, lam=lam, alpha_init=a0)
            torch.cuda.synchronize()
            ex = float((x - x_r).abs().max())
            ea = float(((a - a_r).abs() / torch.clamp(a_r.abs(), min=1.0))
                       .max())
            capped = (it >= CAP) | (it_r >= CAP)
            di = int(torch.where(capped, 0, (it - it_r).abs()).max())
            ok = ok and (ex <= TOL_X and ea <= TOL_ALPHA and di <= TOL_ITERS
                         and bool((g >= 0).all()))
            outs, launch = B4.bind(yy, lam=lam, alpha_init=a0, max_iters=CAP)
            launch()
            torch.cuda.synchronize()
            ok = ok and bool(torch.equal(outs[0], x))
            cases.append(dict(
                shape=shape, lam=lam, start=start, ms=[], wrapper_ms=[],
                max_abs_err=ex, alpha_rel_err=ea, iters_apart=di,
                rows_at_cap=int(capped.sum()),
                iters_mean=float(it.float().mean()),
                solves_per_fiber=float(it.float().mean()) + 2.0,
                _run=(launch, yy, a0, lam)))
    for _ in range(ROUNDS):
        for c in cases:
            launch, yy, a0, lam = c["_run"]
            c["ms"].append(time_ms(launch))
            c["wrapper_ms"].append(time_ms(
                lambda: B4.ms_tv2_fused(yy, lam=lam, alpha_init=a0)))
    for c in cases:
        del c["_run"]
    print(json.dumps({"card": card,
                      "ptxas": ptxas_lines(build.BUILD_LOG["ptxas"] or ""),
                      "cases": cases}))
    if not ok:
        sys.exit("B4 disagrees with its plain version")


if __name__ == "__main__":
    main(sys.argv[1:] or ["10000x1000", "1024x1024@0.3", "1x1000@2"])
