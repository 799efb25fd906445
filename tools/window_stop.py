#!/usr/bin/env python3
"""How far the long-signal route lands from float64 in float32 when its
windows run kernel B1's arithmetic with and without the TPU kernel's stop
floor (``pn_fused.pn_tv1_fused``'s ``tol_eps``: 10, the TPU kernel's rule,
and 0, the route's).

    python3 tools/window_stop.py

Runs on the CPU: the windows go through B1's plain version (the gate of
kind ``"pn_window"`` is forced open, as on a CUDA float32 batch) in float32,
on the bench's 10^6 walk at lam 0.7 (``bench.py:35-37``) and on ROADMAP
C2's n = 20000 walk at lam 2.0 (seed 21), against the float64 route.
Prints one line per case: max |x32 - x64|, the windows' mean Newton
iterations, the certificate's gap and rc.  Imports nothing of JAX.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch

    from proxtv_tpu_torch.ops import tv1d_long
    from proxtv_tpu_torch.ops.kernels import gating, pn_fused

    rng = np.random.RandomState(1)
    n = 1_000_000
    bench = np.cumsum(rng.randn(n)) * 0.05 + rng.randn(n)
    rng = np.random.RandomState(21)
    n = 20000
    walk = np.cumsum(rng.randn(n)) * 0.3 + rng.randn(n)
    gate, fused = gating.gate, pn_fused.pn_tv1_fused
    for name, y, lam in (("bench walk n=1e6 lam 0.7", bench, 0.7),
                         ("C2 walk n=20000 lam 2.0", walk, 2.0)):
        x64, _ = tv1d_long.tv1_long(torch.from_numpy(y), lam)  # tv1_pn
        for tol_eps in (10.0, 0.0):
            iters = []

            def windows(*a, **kw):
                kw.update(tol_eps=tol_eps, return_iters=True)
                x, w, it = fused(*a, **kw)
                iters.append(round(float(it.float().mean()), 2))
                return x, w

            gating.gate = lambda y_, kind: kind == "pn_window" or gate(y_,
                                                                       kind)
            pn_fused.pn_tv1_fused = windows
            try:
                x32, info = tv1d_long.tv1_long(torch.from_numpy(y).float(),
                                               lam)
            finally:
                gating.gate, pn_fused.pn_tv1_fused = gate, fused
            err = float((x32.double() - x64).abs().max())
            print(f"{name}, B1 plain float32, tol_eps {tol_eps:g}: max|x32 - "
                  f"x64| = {err:.3e}, window Newton iterations (mean per "
                  f"launch) {iters}, gap {float(info.gap[0]):.4e}, rc "
                  f"{int(info.rc[0])}")


if __name__ == "__main__":
    main()
