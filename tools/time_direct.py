#!/usr/bin/env python3
"""Time kernels D1 (taut string, ``csrc/tautstring.cu``) and D2 (message-
passing DP, ``csrc/dp.cu``) per launch on one CUDA card, across batch sizes.

    python3 tools/time_direct.py [--rows 1,32,132,1024,10000] [--n 1000]

For each batch of B signals of length n (randn, seeded, lam 0.7) and for a
batch of 32 copies of one signal (every thread of the warp takes the same
path: the divergence-free case), each kernel is first held against its
plain version (max |kernel - plain| within 1e-5 of the data's size, the
bar of ``chip_smoke.py`` ``TOL["direct"]``), then timed by CUDA events:
20 launches of its C entry point, arguments made once by ``bind``, after
one untimed.  Prints one JSON line with the card's name and power limit
and each case's ms per launch.  Imports nothing of JAX.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS = 20
TOL = 1e-5
LAM = 0.7


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


def main(rows, n):
    import torch

    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.ops.kernels import dp, tautstring

    if not torch.cuda.is_available():
        sys.exit("time_direct.py needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    kernels = {"D1": (tautstring, tv1d_l1.tv1_tautstring_plain),
               "D2": (dp, tv1d_l1.tv1_dp_plain)}
    rng = np.random.RandomState(0)
    cases = [(f"{B}x{n}", rng.randn(B, n).astype(np.float32)) for B in rows]
    one = rng.randn(1, n).astype(np.float32)
    cases.append((f"32x{n} copies of one signal", np.repeat(one, 32, axis=0)))
    out = {"card": card, "n": n, "lam": LAM, "cases": []}
    for name, y in cases:
        yt = torch.from_numpy(y).cuda()
        rec = {"case": name}
        for kid, (mod, plain) in kernels.items():
            res, launch = mod.bind(yt, LAM)
            launch()
            ref = plain(yt, LAM)
            torch.cuda.synchronize()
            err = float((res - ref).abs().max()) / max(1.0, float(yt.abs().max()))
            if err > TOL:
                sys.exit(f"{kid} {name}: max|kernel - plain| / scale {err} > "
                         f"{TOL}")
            rec[kid + "_ms"] = time_ms(launch)
            rec[kid + "_err"] = err
        out["cases"].append(rec)
        print(f"[{name}] D1 {rec['D1_ms']:.4f} ms, D2 {rec['D2_ms']:.4f} ms "
              f"({card})", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="1,32,132,1024,10000")
    ap.add_argument("--n", type=int, default=1000)
    a = ap.parse_args()
    main([int(r) for r in a.rows.split(",")], a.n)
