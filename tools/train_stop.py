#!/usr/bin/env python3
"""Kernel B1 against its plain version on the training cells of
``chip_smoke.py`` at three float32 stop floors (``pn_fused.pn_tv1_fused``'s
``tol_eps``: 10, the TPU kernel's rule; 1; 0, no floor).

    python3 tools/train_stop.py

Needs a CUDA card.  T2: the dr fiber launches of three gradient steps of
``TVDenoise2D`` on the 1024^2 blocky image (chip_smoke's data), each held
against the plain version on its own inputs; T1: the 10000 x 1000 blocky
batch at lam 0.01, 0.0128 and 0.7, also held against the float64 host taut
string (``runtime.native``) on its first 512 rows.  Prints per floor the
histogram of the per-fiber Newton iteration differences, the largest
|x - x_plain| or |w - w_plain| and the mean iterations.  Imports nothing
of JAX.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch

    from proxtv_tpu_torch.models.layers import TVDenoise2D
    from proxtv_tpu_torch.ops.kernels import pn_fused as B1
    from proxtv_tpu_torch.runtime import native

    dev = torch.device("cuda")
    rng = np.random.RandomState(5)  # chip_smoke.py's SEED + 5
    truth1 = np.repeat(rng.randn(10000, 20), 50, axis=1)
    noisy1 = (truth1 + 0.3 * rng.randn(10000, 1000)).astype(np.float32)
    truth2 = np.kron(rng.randn(1, 16, 16), np.ones((64, 64)))
    noisy2 = (truth2 + 0.3 * rng.randn(1, 1024, 1024)).astype(np.float32)
    tgt = torch.from_numpy(truth2.astype(np.float32)).to(dev)
    launch = B1.pn_tv1_fused

    def compare(calls):
        hist, err, its = {}, 0.0, 0.0
        for y, lf, w0, kw in calls:
            ref, wref, it_r = B1.pn_tv1_fused_plain(y, lf, w0, tb=1, **kw)
            x, w, it = launch(y, lf, w0, return_iters=True, **kw)
            d = (it - it_r).abs()
            for v, c in zip(*torch.unique(d, return_counts=True)):
                hist[int(v)] = hist.get(int(v), 0) + int(c)
            err = max(err, float((x - ref).abs().max()),
                      float((w - wref).abs().max()))
            its += float(it.float().mean())
        return dict(sorted(hist.items())), err, its / len(calls)

    for tol_eps in (10.0, 1.0, 0.0):
        calls = []

        def tap(y, lam_full=None, w_init=None, **kw):
            kw = {k: v for k, v in kw.items() if k != "return_dual"}
            kw["tol_eps"] = tol_eps
            calls.append((y.clone(), lam_full,
                          None if w_init is None else w_init.clone(), kw))
            return launch(y, lam_full, w_init, **kw)

        B1.pn_tv1_fused = tap
        try:
            Y = torch.from_numpy(noisy2).to(dev).requires_grad_(True)
            layer = TVDenoise2D(init_lam=0.3)
            for _ in range(3):
                loss = torch.mean((layer(Y) - tgt) ** 2)
                (g,) = torch.autograd.grad(loss, Y)
                with torch.no_grad():
                    Y.sub_(Y.numel() / 4 * g)
        finally:
            B1.pn_tv1_fused = launch
        hist, err, its = compare(calls)
        print(f"T2 dr fibers, tol_eps {tol_eps}: {len(calls)} launches, "
              f"|iterations kernel - plain| histogram {hist}, max|kernel - "
              f"plain| {err:.3e}, mean iterations {its:.3f}", flush=True)
        y1 = torch.from_numpy(noisy1).to(dev)
        for lam in (0.01, 0.0128, 0.7):
            kw = {"lam_scalar": lam, "tol_eps": tol_eps}
            hist, err, its = compare([(y1, None, None, kw)])
            x, _ = launch(y1, **kw)
            x64 = native.tv1_batch_host(noisy1[:512].astype(np.float64), lam)
            e64 = float(np.abs(x[:512].double().cpu().numpy() - x64).max())
            print(f"T1 10000x1000 lam {lam}, tol_eps {tol_eps}: histogram "
                  f"{hist}, max|kernel - plain| {err:.3e}, mean iterations "
                  f"{its:.3f}; kernel vs float64 (512 rows) {e64:.3e}",
                  flush=True)


if __name__ == "__main__":
    main()
