#!/usr/bin/env python3
"""Time kernel B2 (the SPD second-difference tridiagonal solve,
``csrc/pcr.cu``) per launch on one CUDA card, at the main path's launches.

    python3 tools/time_b2.py

The main path's systems, recorded from the calls that launch B2 (a tap on
the wrapper keeps each launch's inputs): ``api.tv1_1d`` pn on an n = 1000
random walk at w = 2.0 (its dual init, 1 x 999 plain, and its Newton
systems, 1 x 999 masked), the TV-Lp setup solve of ``tvp_batched`` on
512 x 1000 randn at lam 0.7, p = 1.5 (512 x 999 plain), and the per-sweep
setup solves of ``api.tvp_2d`` p = 1.5 on 512^2 randn at lam 0.3
(512 x 511 plain).  Each case is one (shape, kind) with its launches in the
order the path made them.

Each launch is first held against the plain version (float32 PCR, tb = 1):
max |kernel - plain| within 1e-3 of the solution's size (``chip_smoke.py``
``TOL["pcr_path"]``).  Both are also held against the plain version in
float64 on the same inputs, and their errors printed (``err64_kernel``,
``err64_plain``).  Then CUDA events time 20 passes over the case's launches
after one untimed, every case in turn, ROUNDS times.  ``ms`` times the C
entry point alone per launch, called with its arguments made once by
``pcr.bind`` (the kernel's time); ``wrapper_ms`` times the Python wrapper
``pcr_spd_solve``.  Prints one JSON line with the card's name and power
limit, the compiler's register, shared-memory and spill lines of the B2
source, and each case's times and agreement.

The package is imported from the tree this file sits in, so a copy of this
file in another checkout of the repo times that checkout's kernel (one
whose ``pcr`` has ``bind``).  Imports nothing of JAX.
"""
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS, ROUNDS = 20, 3
TOL_PATH = 1e-3


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


def ptxas_lines(log, source="pcr.cu"):
    """The register / shared-memory / spill lines of one source."""
    part = log.split(f"== {source}", 1)[-1].split("\n== ", 1)[0]
    return [ln.strip() for ln in part.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln
            or "stack" in ln]


def record_main_path(rng):
    """{(B, n, kind): [(rhs, mask, shift), ...]} from the main path."""
    import torch

    import proxtv_tpu_torch as ptv
    from proxtv_tpu_torch.ops import tv1d_lp
    from proxtv_tpu_torch.ops.kernels import pcr as B2

    calls, launch = {}, B2.pcr_spd_solve

    def record(rhs, mask=None, diag_shift=None):
        kind = ("masked" if mask is not None else "shifted"
                if diag_shift is not None else "plain")
        calls.setdefault((*rhs.shape, kind), []).append(
            tuple(None if v is None else v.clone()
                  for v in (rhs, mask, diag_shift)))
        return launch(rhs, mask=mask, diag_shift=diag_shift)

    y1 = np.cumsum(rng.randn(1000)) * 0.3
    Y = torch.from_numpy(rng.randn(512, 1000).astype(np.float32)).cuda()
    Y5 = rng.randn(512, 512)
    B2.pcr_spd_solve = record
    try:
        ptv.tv1_1d(y1, 2.0, method="pn")
        tv1d_lp.tvp_batched(Y, 0.7, 1.5)
        ptv.tvp_2d(Y5, 0.3, 0.3, 1.5, 1.5, max_iters=35)
    finally:
        B2.pcr_spd_solve = launch
    return calls


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from proxtv_tpu_torch.ops.kernels import build
    from proxtv_tpu_torch.ops.kernels import pcr as B2

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    build.build()  # reused if built; BUILD_LOG holds the compiler's lines
    rng = np.random.RandomState(0)
    cases, ok = [], True
    for (Bs, ns, kind), launches in record_main_path(rng).items():
        worst, e64k, e64p, launchers = 0.0, 0.0, 0.0, []
        for r_, m_, s_ in launches:
            out = B2.pcr_spd_solve(r_, mask=m_, diag_shift=s_)
            ref = B2.pcr_spd_solve_plain(r_, mask=m_, diag_shift=s_)
            ref64 = B2.pcr_spd_solve_plain(
                r_.double(), mask=m_,
                diag_shift=None if s_ is None else s_.double())
            worst = max(worst, float((out - ref).abs().max())
                        / max(1.0, float(ref.abs().max())))
            e64k = max(e64k, float((out.double() - ref64).abs().max()))
            e64p = max(e64p, float((ref.double() - ref64).abs().max()))
            outs, launch = B2.bind(r_, mask=m_, diag_shift=s_)
            launch()
            torch.cuda.synchronize()
            ok = ok and bool(torch.equal(outs, out))
            launchers.append(launch)
        ok = ok and worst <= TOL_PATH

        def replay_c(launchers=launchers):
            for launch in launchers:
                launch()

        def replay(launches=launches):
            for r_, m_, s_ in launches:
                B2.pcr_spd_solve(r_, mask=m_, diag_shift=s_)

        cases.append(dict(case=f"{Bs}x{ns} {kind}", launches=len(launches),
                          max_rel_err=worst, err64_kernel=e64k,
                          err64_plain=e64p, ms=[], wrapper_ms=[],
                          _run=(replay_c, replay)))
    for _ in range(ROUNDS):
        for c in cases:
            replay_c, replay = c["_run"]
            c["ms"].append(time_ms(replay_c) / c["launches"])
            c["wrapper_ms"].append(time_ms(replay) / c["launches"])
    for c in cases:
        del c["_run"]
    print(json.dumps({"card": card,
                      "ptxas": ptxas_lines(build.BUILD_LOG["ptxas"] or ""),
                      "cases": cases}))
    if not ok:
        sys.exit("B2 disagrees with its plain version")


if __name__ == "__main__":
    main()
