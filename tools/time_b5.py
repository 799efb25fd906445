#!/usr/bin/env python3
"""Time kernel B5 (GPFW TV-Lp, ``csrc/lp_fused.cu``) per launch on one CUDA
card, at the main path's launches and at fixed trip counts.

    python3 tools/time_b5.py            # every case below
    python3 tools/time_b5.py --trips 10,20,40,80 --rows 64,132,133,264

Main-path cases, with the inputs the GPFW driver gives the kernel
(centered rows, the projected unconstrained dual, ``tv1d_lp._start``):
``tvp_batched`` on 512 x 1000 randn at lam 0.7 for p = 1.5, 3 and 5; one
n = 1000 random walk at lam 2.0, p = 1.5 (``tvp_1d``); and the first
warm-started column pass of ``tvp_2d`` p = 1.5 on 512^2 randn at lam 0.3
(recorded from that call).  Fixed trips: 512 random walks of 1000 at lam 2,
p = 1.5, from a cold start (w = 0), capped at each ``--trips`` count of
single iterations (10 per trip): the launch's fixed cost and its cost per
trip.  Rows: the first ``--rows`` rows of the p = 1.5 batch, each count a
case, to place the switch between the kernel's layouts for a batch that
fits the card in one wave and for a larger one.

Each case is first held against the plain version (tb = 1) on its inputs:
the primal x = y + D'w within 5e-3 and its objective within 1e-5 relative
(plus 1e-4) when run to convergence, and for the fixed trips the dual
objective by ``lp_fused.fixed_trips_agree`` with the float64 run: within
1e-6 relative on the rows that ran the same trips (or no further from the
plain version's float64 run than its float32 run is at its worst row); a
row whose trip counts differ stopped earlier on one side by its test, the
other one trip later or by its test too, and its x and objective, as those
of every row both sides stopped by their test, are held at the converged
bars.  The fit of the fixed trips takes the slowest row's trips: a launch
ends when its last fiber does.
Then CUDA events time 20 launches after one untimed, every case in turn,
ROUNDS times.  ``ms`` times the C entry point alone, called with its
arguments made once by ``lp_fused.bind`` (the kernel's time);
``wrapper_ms`` times the Python wrapper ``gpfw_fused``.  Prints one JSON
line with the card's name and power limit, the compiler's register,
shared-memory and spill lines of the B5 source, and each case's times,
trips per row and agreement.

The package is imported from the tree this file sits in, so a copy of this
file in another checkout of the repo times that checkout's kernel (one
whose ``lp_fused`` has ``bind``).  Imports nothing of JAX.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS, ROUNDS = 20, 3
TOL_X, TOL_OBJ, TOL_OBJ_ABS, TOL_DUAL = 5e-3, 1e-5, 1e-4, 1e-6
FW_CYCLES = 10


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


def ptxas_lines(log, source="lp_fused.cu"):
    """The register / shared-memory / spill lines of one source."""
    part = log.split(f"== {source}", 1)[-1].split("\n== ", 1)[0]
    return [ln.strip() for ln in part.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln
            or "stack" in ln]


def primal(yc, w):
    return yc + np.diff(np.concatenate([np.zeros((yc.shape[0], 1)), w],
                                       axis=1), axis=1)


def objective(x, y, lam, p):
    g = np.abs(np.diff(x, axis=1))
    return (0.5 * np.sum((x - y) ** 2, axis=1)
            + lam * np.sum(g ** p, axis=1) ** (1.0 / p))


def agreement(B5, args, p, max_iters, fixed):
    """Kernel against the plain version on one launch's inputs."""
    import torch

    w_r, _, _, it_r = B5.gpfw_fused_plain(*args, p, max_iters, tb=1)
    w, _, g, it = B5.gpfw_fused(*args, p, max_iters)
    torch.cuda.synchronize()
    yc = args[0].double().cpu().numpy()
    lam = args[2].double().cpu().numpy()
    w, w_r = w.double().cpu().numpy(), w_r.double().cpu().numpy()
    x, x_r = primal(yc, w), primal(yc, w_r)
    F, F_r = objective(x, yc, lam, p), objective(x_r, yc, lam, p)
    itk, itp = it.cpu().numpy(), it_r.cpu().numpy()
    it, it_r = np.floor(itk), np.floor(itp)
    out = dict(max_abs_err=float(np.abs(x - x_r).max()),
               obj_rel=float(np.max(np.abs(F - F_r) / np.abs(F_r))),
               trips_mean=float(it.mean()) / FW_CYCLES,
               trips_mean_plain=float(it_r.mean()) / FW_CYCLES,
               trips_max=float(it.max()) / FW_CYCLES)
    ok = bool((g >= 0).all())
    if fixed:  # lp_fused.fixed_trips_agree, with the float64 run
        ref64 = B5.gpfw_fused_plain(*(a.double() for a in args), p,
                                    max_iters, tb=1)[::3]
        good, nums = B5.fixed_trips_agree(args[0], args[2], p, w, itk, w_r,
                                          itp, ref64=ref64, rtol=TOL_DUAL,
                                          fw_cycles=FW_CYCLES, x_atol=TOL_X,
                                          obj_rtol=TOL_OBJ,
                                          obj_atol=TOL_OBJ_ABS)
        out.update(nums)
        return out, ok and good
    ok = ok and bool(np.abs(x - x_r).max() <= TOL_X
                     and np.all(np.abs(F - F_r)
                                <= TOL_OBJ * np.abs(F_r) + TOL_OBJ_ABS))
    return out, ok


def main_path_inputs(rng, dev):
    """The kernel's inputs on the main path, by case name."""
    import torch

    import proxtv_tpu_torch as ptv
    from proxtv_tpu_torch.ops import tv1d_lp
    from proxtv_tpu_torch.ops.kernels import lp_fused as B5

    def setup(Y, lam, p):
        yc, _, B, _, dt, lamv, _, q, w0, inter, zpen = \
            tv1d_lp._common_setup(Y, lam, p)
        w_s, mu0 = tv1d_lp._start(w0, lamv, q, None, None, dt)
        return (yc.contiguous(),
                torch.cat([w_s, yc.new_zeros((B, 1))], 1).contiguous(),
                lamv.contiguous(), mu0.contiguous(),
                (~inter & ~zpen).to(dt).contiguous())

    Y = torch.from_numpy(rng.randn(512, 1000).astype(np.float32)).to(dev)
    y1 = torch.from_numpy((np.cumsum(rng.randn(1, 1000), axis=1) * 0.3)
                          .astype(np.float32)).to(dev)
    cases = {f"512x1000 p{p}": (setup(Y, 0.7, p), p, 10 ** 6)
             for p in (1.5, 3.0, 5.0)}
    cases["1x1000 p1.5 (tvp_1d)"] = (setup(y1, 2.0, 1.5), 1.5, 10 ** 6)
    seen, launch = [], B5.gpfw_fused

    def record(*a, **kw):
        seen.append((tuple(x.clone() if torch.is_tensor(x) else x
                           for x in a), kw))
        return launch(*a, **kw)

    B5.gpfw_fused = record
    try:
        ptv.tvp_2d(rng.randn(512, 512), 0.3, 0.3, 1.5, 1.5, max_iters=2)
    finally:
        B5.gpfw_fused = launch
    a, kw = seen[2]  # the first warm-started column pass
    cases["512x512 p1.5 warm (tvp_2d)"] = (a, kw["p"], kw["max_iters"])
    return cases


def main(trips, rows):
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from proxtv_tpu_torch.ops.kernels import build
    from proxtv_tpu_torch.ops.kernels import lp_fused as B5

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    build.build()  # reused if built; BUILD_LOG holds the compiler's lines
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    inputs = main_path_inputs(rng, dev)
    runs = [(name, args, p, mi, False)
            for name, (args, p, mi) in inputs.items()]
    first = inputs["512x1000 p1.5"][0]
    runs += [(f"{r}x1000 p1.5 (first rows)",
              tuple(a[:r].contiguous() for a in first), 1.5, 10 ** 6, False)
             for r in rows]
    walks = (np.cumsum(rng.randn(512, 1000), axis=1) * 0.3).astype(np.float32)
    walks -= walks.mean(axis=1, keepdims=True)
    cold = tuple(torch.from_numpy(a).to(dev) for a in (
        walks, np.zeros_like(walks), np.full(512, 2.0, np.float32),
        np.ones(512, np.float32), np.ones(512, np.float32)))
    runs += [(f"512x1000 p1.5 cold, max_iters {t}", cold, 1.5, t, True)
             for t in trips]
    cases, ok = [], True
    for name, args, p, mi, fixed in runs:
        agree, good = agreement(B5, args, p, mi, fixed)
        ok = ok and good
        outs, launch = B5.bind(*args, p, mi)
        launch()
        ref = B5.gpfw_fused(*args, p, mi)
        torch.cuda.synchronize()
        ok = ok and all(bool(torch.equal(a, b)) for a, b in zip(outs, ref))
        cases.append(dict(case=name, p=p, max_iters=mi, ok=good, ms=[],
                          wrapper_ms=[], **agree,
                          _run=(launch, args, p, mi)))
    for _ in range(ROUNDS):
        for c in cases:
            launch, args, p, mi = c["_run"]
            c["ms"].append(time_ms(launch))
            c["wrapper_ms"].append(time_ms(
                lambda: B5.gpfw_fused(*args, p, mi)))
    for c in cases:
        del c["_run"]
    fixed = [c for c in cases if "cold" in c["case"]]
    fit = None
    if len(fixed) >= 2:  # least squares: ms = fixed + per_trip * trips of
        # the slowest row (a launch ends when its last fiber does)
        t = np.array([c["trips_max"] for c in fixed])
        m = np.array([min(c["ms"]) for c in fixed])
        per_trip, fixed_ms = np.polyfit(t, m, 1)
        fit = {"fixed_ms": float(fixed_ms), "per_trip_ms": float(per_trip)}
    print(json.dumps({"card": card,
                      "ptxas": ptxas_lines(build.BUILD_LOG["ptxas"] or ""),
                      "cases": cases, "trip_fit": fit}))
    if not ok:
        sys.exit("B5 disagrees with its plain version")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trips", default="10,20,40,80",
                    help="fixed iteration caps, comma-separated ('' for "
                         "none)")
    ap.add_argument("--rows", default="",
                    help="row counts of the p = 1.5 batch, comma-separated")
    a = ap.parse_args()
    main([int(t) for t in a.trips.split(",") if t],
         [int(r) for r in a.rows.split(",") if r])
