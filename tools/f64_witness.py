#!/usr/bin/env python3
"""How far one float64 call of ``chip_smoke.py`` phase 7 parts from itself
when only the order of its sums or its tridiagonal solver's roundings
change, against how far float32 lands: the witness that sets the bars of
the phase's holds for the calls whose inner solvers stop at a tolerance
(the TV-Lp Frank-Wolfe solves, the ND combiners over them).

    python3 tools/f64_witness.py mixed --shape 8x128x128 --sweeps 35
    python3 tools/f64_witness.py mixed --shape 4x64x64 --seeds 0-9
    python3 tools/f64_witness.py mixed --shape phase7
    python3 tools/f64_witness.py tvgen --shape 32x256x256 --threads 8
    python3 tools/f64_witness.py tvp_long

Runs the call on the CPU in float64 (A), then again on the input reversed
along every axis and reverses the result back (the same problem, its
reductions and its fibers taken in another order), then with another
number of torch threads (another split of the long reductions), then
with the solves of ``tridiag.spd_second_difference_solve`` (``tv1_pn``'s
Newton systems, the TV-Lp setup) by Thomas's elimination in place of PCR
(on the card kernel B2 solves them by its own exact elimination, whose
roundings are neither), and in float32, and
prints for each how far it lands from A: max|dx| and the root mean square
of dx, both over max(1, max|y|), and the objective's relative change.
``--shape phase7`` is phase 7's small volume (4 x 64 x 64,
``chip_smoke.v64_small``); ``--seeds A-B`` runs randn volumes
of each seed in turn.  Calls: ``mixed`` (``tv_nd_batched`` pd, p = (1, 2, 1.5),
lam 0.3 on every axis), ``tvgen`` (``tvgen`` pd, p = 1), on the bench
volume of ``chip_smoke.py`` at 32 x 256 x 256 or a randn volume of another
shape (seed ``--seed``); ``tvp_long`` (``tvp_gpfw`` p = 1.5, lam 50, on
the phase's 10^6 signal).  Prints one line a comparison and one JSON line.
Imports nothing of JAX.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("call", choices=("mixed", "tvgen", "tvp_long"))
    ap.add_argument("--shape", default="32x256x256")
    ap.add_argument("--sweeps", type=int, default=35)
    ap.add_argument("--seed", type=int, default=9)
    ap.add_argument("--seeds", default=None,
                    help="A-B: randn volumes of seeds A to B in turn")
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--other-threads", type=int, default=4)
    a = ap.parse_args()
    if a.seeds is not None:
        lo, hi = (int(v) for v in a.seeds.split("-"))
        for seed in range(lo, hi + 1):
            a.seed = seed
            witness(a)
        return
    witness(a)


def witness(a):
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    from proxtv_tpu_torch.models import tvnd
    from proxtv_tpu_torch.ops import tridiag, tv1d_lp

    rng3 = np.random.RandomState(cs.SEED + 1)  # chip_smoke's volume
    if a.call == "tvp_long":
        rng3.randn(cs.L3, cs.M3, cs.N3)
        y = (np.cumsum(rng3.randn(cs.NLONG)) * 0.05 + rng3.randn(cs.NLONG)
             ).astype(np.float32).astype(np.float64)[None]
        lam, p = cs.LAMLONG, cs.PLONG

        def run(v):
            x, info = tv1d_lp.tvp_gpfw(v, lam, p)
            return x, int(info.iters.max())

        def objective(x):
            d = np.diff(x, axis=-1)
            return (0.5 * float(((x - y) ** 2).sum())
                    + lam * float((np.abs(d) ** p).sum() ** (1 / p)))
    else:
        shape = (cs.V64_SMALL if a.shape == "phase7"
                 else tuple(int(v) for v in a.shape.split("x")))
        y = (cs.v64_small() if a.shape == "phase7"
             else rng3.randn(*shape).astype(np.float32).astype(np.float64)
             if shape == (cs.L3, cs.M3, cs.N3)
             else np.random.RandomState(a.seed).randn(*shape))
        ps = cs.PS_MIXED if a.call == "mixed" else (1.0,) * 3
        lams, ds = (cs.LAM3,) * 3, (1, 2, 3)

        def run(v):
            x, info = tvnd.tv_nd_batched(v[None], lams, ds, ps, method="pd",
                                         max_iters=a.sweeps)
            return x[0], int(info.iters.max())

        def objective(x):
            X = torch.from_numpy(np.ascontiguousarray(x))
            return (0.5 * float(((x - y) ** 2).sum())
                    + float(tvnd.tv_value(X, lams, ds, ps)))

    axes = tuple(range(y.ndim))
    scale = max(1.0, float(np.abs(y).max()))

    def solve(v, threads, dtype=torch.float64, flip=False, thomas=False):
        torch.set_num_threads(threads)
        v = np.flip(v, axes) if flip else v
        t0 = time.perf_counter()
        pcr = tridiag.pcr_solve
        if thomas:
            tridiag.pcr_solve = tridiag.thomas_solve
        try:
            x, iters = run(torch.from_numpy(np.ascontiguousarray(v)).to(
                dtype))
        finally:
            tridiag.pcr_solve = pcr
        x = x.double().numpy()
        return (np.flip(x, axes) if flip else x), iters, \
            time.perf_counter() - t0

    xa, it_a, s_a = solve(y, a.threads)
    Fa = objective(xa)
    rep = {"call": a.call, "shape": list(y.shape), "sweeps": a.sweeps,
           "seed": None if a.shape == "phase7" else a.seed,
           "threads": a.threads, "iters": it_a, "seconds": s_a,
           "objective": Fa, "max_abs_y": scale, "vs": {}}
    what = "phase 7" if a.shape == "phase7" else f"seed {a.seed}"
    print(f"{a.call} {tuple(y.shape)} ({what}): A {it_a} iterations, "
          f"{s_a:.1f} s, F = {Fa:.12e}", flush=True)
    for name, kw in (("reversed", dict(flip=True)),
                     (f"{a.other_threads} threads", dict(
                         threads=a.other_threads)),
                     ("Thomas", dict(thomas=True)),
                     ("float32", dict(dtype=torch.float32))):
        kw.setdefault("threads", a.threads)
        x, it, s = solve(y, **kw)
        dx = x - xa
        r = {"max": float(np.abs(dx).max()) / scale,
             "rms": float(np.sqrt(np.mean(dx * dx))) / scale,
             "dF_over_F": (objective(x) - Fa) / abs(Fa), "iters": it,
             "seconds": s}
        rep["vs"][name] = r
        print(f"  {name}: max|dx| / max|y| = {r['max']:.3e}, rms(dx) / "
              f"max|y| = {r['rms']:.3e}, dF / F = {r['dF_over_F']:.3e}, "
              f"{it} iterations, {s:.1f} s", flush=True)
    print(json.dumps(rep))


if __name__ == "__main__":
    main()
