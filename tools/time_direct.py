#!/usr/bin/env python3
"""Time kernels D1 (taut string, ``csrc/tautstring.cu``), D2 (message-
passing DP, ``csrc/dp.cu``), D3 (Condat, ``csrc/condat.cu``) and D4 (classic
taut string, ``csrc/classic_ts.cu``) per launch on one CUDA card, across
batch sizes.

    python3 tools/time_direct.py [--rows 1,32,132,1024,10000] [--n 1000]
                                 [--repo DIR]

For each batch of B signals of length n (randn, seeded, lam 0.7), for a
batch of 32 copies of one signal (every signal takes the same path), and
for the per-edge-weighted batches of ``chip_smoke.py``'s main path (512
and 1 signals, weights U[0, 1.4] with 5% zeroed), each kernel is first held
against its plain version on the CPU on three of its rows, the first, the
middle and the last (max |kernel - plain| within 1e-5 of the data's size,
the bar of ``chip_smoke.py`` ``TOL["direct"]``), then timed by CUDA
events: 20 launches of its C entry point, arguments made once by ``bind``,
after one untimed.  D3 and D4 take one lambda a signal and skip the
per-edge cases.  ``--repo`` times the package of another checkout (an
unpacked parent commit, say) with the same cases, so that two versions are
compared in one call on one card; a kernel that checkout lacks is left
out.  Prints one JSON line with the card's
name and power limit and each case's ms per launch.  Imports nothing of
JAX.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPS = 20
TOL = 1e-5
LAM = 0.7
LAMW, ZERO_W = 1.4, 0.05


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


def cases(rows, n):
    """(name, y, lam) of every case, from seeded numpy draws."""
    rng = np.random.RandomState(0)
    out = [(f"{B}x{n}", rng.randn(B, n).astype(np.float32), LAM)
           for B in rows]
    one = rng.randn(1, n).astype(np.float32)
    out.append((f"32x{n} copies of one signal", np.repeat(one, 32, axis=0),
                LAM))
    for B in (512, 1):
        y = rng.randn(B, n).astype(np.float32)
        w = rng.rand(B, n - 1) * LAMW
        w[rng.rand(B, n - 1) < ZERO_W] = 0.0
        out.append((f"{B}x{n} per-edge", y, w.astype(np.float32)))
    return out


def main(rows, n, repo):
    sys.path.insert(0, repo)
    import torch

    import importlib

    from proxtv_tpu_torch.ops import tv1d_l1

    if not torch.cuda.is_available():
        sys.exit("time_direct.py needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    kernels = {}
    for kid, name, plain in (("D1", "tautstring", "tv1_tautstring_plain"),
                             ("D2", "dp", "tv1_dp_plain"),
                             ("D3", "condat", "tv1_condat_plain"),
                             ("D4", "classic_ts", "tv1_classic_ts_plain")):
        try:
            mod = importlib.import_module(
                f"proxtv_tpu_torch.ops.kernels.{name}")
        except ImportError:
            continue  # a checkout before this kernel
        kernels[kid] = (mod, getattr(tv1d_l1, plain))
    out = {"card": card, "repo": os.path.abspath(repo), "n": n, "lam": LAM,
           "cases": []}
    for name, y, lam in cases(rows, n):
        yt = torch.from_numpy(y).cuda()
        lt = torch.from_numpy(lam).cuda() if isinstance(lam, np.ndarray) \
            else lam
        rec = {"case": name}
        rows_ = sorted({0, len(y) // 2, len(y) - 1})
        y_c = torch.from_numpy(y[rows_])
        lam_c = torch.from_numpy(lam[rows_]) if isinstance(lam, np.ndarray) \
            else lam
        for kid, (mod, plain) in kernels.items():
            if kid in ("D3", "D4") and isinstance(lam, np.ndarray):
                continue  # one lambda a signal: no per-edge case
            res, launch = mod.bind(yt, lt)
            launch()
            ref = plain(y_c, lam_c)
            torch.cuda.synchronize()
            err = float((res[rows_].cpu() - ref).abs().max()) / max(
                1.0, float(np.abs(y).max()))
            if err > TOL:
                sys.exit(f"{kid} {name}: max|kernel - plain| / scale {err} > "
                         f"{TOL}")
            rec[kid + "_ms"] = time_ms(launch)
            rec[kid + "_err"] = err
        out["cases"].append(rec)
        times = ", ".join(f"{k[:2]} {v:.4f} ms" for k, v in rec.items()
                          if k.endswith("_ms"))
        print(f"[{name}] {times} ({card}; {out['repo']})", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="1,32,132,1024,10000")
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose package is timed")
    a = ap.parse_args()
    main([int(r) for r in a.rows.split(",")], a.n, a.repo)
