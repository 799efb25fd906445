#!/usr/bin/env python3
"""Time kernel B1 (projected-Newton TV-L1, ``csrc/pn_fused.cu``) per launch
on one CUDA card, cold and warm, at the shapes given as FIBERSxN.

    python3 tools/time_b1.py 16x5000 8x8192 10000x1000 1024x1024

Each shape's rows are randn at lam 0.7.  Cold is the closed-form dual init;
warm starts from the dual of a first solve on the same rows, with a 0.05
randn perturbation added to the rows it solves.  Each case is first held
against the plain version (tb = 1): x and w within 2e-3, Newton counts at
most 2 apart.  Then CUDA events time 20 launches after one untimed.  Prints
one JSON line with the card's name and power limit.

The package is imported from the tree this file sits in, so a copy of this
file in another checkout of the repo times that checkout's kernel.  Imports
nothing of JAX.
"""
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LAM, REPS = 0.7, 20


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


def main(shapes):
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from proxtv_tpu_torch.ops.kernels import pn_fused as B1

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    rng = np.random.RandomState(0)
    out, ok = {"card": card, "cases": []}, True
    for shape in shapes:
        B, n = (int(s) for s in shape.split("x"))
        y = torch.from_numpy(rng.randn(B, n).astype(np.float32)).cuda()
        _, w_first = B1.pn_tv1_fused(y, lam_scalar=LAM)
        y_warm = y + 0.05 * torch.randn_like(y)
        for start, yy, w0 in (("cold", y, None), ("warm", y_warm, w_first)):
            ref, wref, it_ref = B1.pn_tv1_fused_plain(yy, None, w0, tb=1,
                                                      lam_scalar=LAM)
            x, w, it = B1.pn_tv1_fused(yy, None, w0, lam_scalar=LAM,
                                       return_iters=True)
            err = max(float((x - ref).abs().max()),
                      float((w - wref).abs().max()))
            apart = int((it - it_ref).abs().max())
            ok = ok and err <= 2e-3 and apart <= 2
            ms = time_ms(lambda: B1.pn_tv1_fused(yy, None, w0, lam_scalar=LAM))
            out["cases"].append({"shape": shape, "start": start, "ms": ms,
                                 "max_abs_err": err, "iters_apart": apart,
                                 "iters_per_fiber": float(it.float().mean())})
    print(json.dumps(out))
    if not ok:
        sys.exit("B1 disagrees with its plain version")


if __name__ == "__main__":
    main(sys.argv[1:])
