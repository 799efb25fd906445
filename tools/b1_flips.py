#!/usr/bin/env python3
"""Kernel B1 against its plain version where their Newton counts part,
fiber by fiber, on three of ``chip_smoke.py``'s inputs.

    python3 tools/b1_flips.py [--top 5]

1. The per-image column split, ``tv1_2d_sharded(Ypi, (0.1, 0.2, 0.3, 0.5),
   mesh, method="dr", max_iters=300, shard_axis="cols")`` on a one-rank
   NCCL mesh: every B1 launch is tapped and held by ``chip_smoke.pn_hold``
   with and without ``margin`` (the float64 certificates of fibers whose
   warm start lies at the stop tolerance).
2. Cold scalar launches at 10000 x 1000: the bench batch at lam 0.7 and
   the training cell T1's noisy input at lam 0.01.  For each fiber whose
   counts part, and the two farthest apart, both sides are run on the whole launch with max_iters = k
   for k = 0 .. the larger count, and the fiber alone with the same cap:
   at each k the two sides' distance and their float64 gaps over the stop
   tolerance, and whether the fiber alone gives its row of the whole launch
   bit for bit (the rows run independently under ``max_iters``).
3. F2, ``tv1_batched(Y1, W1, method="pn")``: the rows farther than 2e-3
   from the float64 host taut string, their distance, and the same rows
   through the plain version (float32, on the card, alone).

Prints one JSON line with the card's name and power limit last.  The
package is imported from the tree this file sits in.  Imports nothing of
JAX.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def smoke_inputs():
    """chip_smoke.py's seeded inputs used here: the bench batch Y1, T1's
    noisy input, the per-image batch Ypi and F2's weights W1."""
    rng = np.random.RandomState(cs.SEED)
    rng.randn(cs.M2D, cs.N2D)
    Y1 = rng.randn(cs.B1D, cs.N1D).astype(np.float32)
    rng6 = np.random.RandomState(cs.SEED + 4)
    for shape in ((cs.BW, cs.N1D - 1), (cs.N1D - 1,)):
        rng6.rand(*shape)
        rng6.rand(*shape)
    rng6.rand(cs.M2D, cs.N2D - 1)
    rng6.rand(cs.M2D - 1, cs.N2D)
    Ypi = rng6.randn(cs.B_PI, cs.M_PI, cs.M_PI).astype(np.float32)
    rng7 = np.random.RandomState(cs.SEED + 5)
    truth = np.repeat(rng7.randn(cs.T1B, cs.T1N // cs.T1SEG), cs.T1SEG,
                      axis=1)
    noisy_t1 = (truth + cs.TNOISE * rng7.randn(cs.T1B, cs.T1N)).astype(
        np.float32)
    rng8 = np.random.RandomState(cs.SEED + 6)
    rng8.randn(1, cs.M4K, cs.N4K)
    W1 = (0.5 + rng8.rand(cs.B1D, cs.N1D - 1)).astype(np.float32)
    return Y1, noisy_t1, Ypi, W1


def per_image_split(B1, Ypi, top):
    import torch
    import torch.distributed as dist

    from proxtv_tpu_torch import parallel

    calls = []
    launch = B1.pn_tv1_fused

    def tap(y, lam_full=None, w_init=None, **kw):
        calls.append((y.clone(), lam_full.clone(),
                      None if w_init is None else w_init.clone(), dict(kw)))
        return launch(y, lam_full, w_init, **kw)

    store = tempfile.mkdtemp(prefix="b1_flips_")
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    B1.pn_tv1_fused = tap
    try:
        _, info = parallel.tv1_2d_sharded(
            Ypi, np.array(cs.LAM_PI, np.float32), parallel.make_mesh(),
            method="dr", max_iters=cs.COLS_ITERS, shard_axis="cols")
    finally:
        B1.pn_tv1_fused = launch
        dist.destroy_process_group()
    torch.cuda.synchronize()
    out = {"sweeps": info.iters.tolist(), "launches": len(calls),
           "pr16_bar_fails": 0, "margin_fails": 0, "err": 0.0,
           "err_not_at_margin": 0.0, "held": []}
    for i, (y, lf, w0, kw) in enumerate(calls):
        h = cs.pn_hold(B1, y, lf, w0, margin=True, **kw)
        out["err"] = max(out["err"], h["err"])
        out["err_not_at_margin"] = max(out["err_not_at_margin"],
                                       h["err_unheld"])
        out["pr16_bar_fails"] += int(h["err"] > cs.TOL["pn"]
                                     or h["iters_apart"] > cs.TOL["pn_iters"])
        out["margin_fails"] += int(not h["ok"])
        if h["margin"]["fibers"]:
            out["held"].append({"launch": i, **h["margin"]})
    print(f"[1] per-image column split: sweeps {out['sweeps']}, "
          f"{out['launches']} B1 launches; max|kernel - plain| "
          f"{out['err']:.3e}, {out['err_not_at_margin']:.3e} over fibers not "
          f"held at the margin; launches past PR 16's bar "
          f"{out['pr16_bar_fails']}, failing pn_hold(margin) "
          f"{out['margin_fails']}")
    for m in out["held"][:top]:
        print(f"    launch {m['launch']}: {cs.margin_text(m)}")
    return out


def trajectories(B1, y, lam, label, top):
    """Cold scalar launch: the parting fibers' steps on both sides."""
    import torch

    kw = {"lam_scalar": lam}
    xp, wp, ip = B1.pn_tv1_fused_plain(y, tb=1, **kw)
    xk, wk, ik = B1.pn_tv1_fused(y, return_iters=True, **kw)
    torch.cuda.synchronize()
    fib = torch.maximum((xk - xp).abs().amax(1), (wk - wp).abs().amax(1))
    part = torch.nonzero(ik != ip).flatten().tolist()
    lam_full = torch.full_like(y, lam)
    whole = {}  # both sides on the whole launch, by cap

    def capped(k):
        if k not in whole:
            whole[k] = (B1.pn_tv1_fused(y, max_iters=k, **kw),
                        B1.pn_tv1_fused_plain(y, tb=1, max_iters=k, **kw))
        return whole[k]

    rows = []
    worst = torch.argsort(fib, descending=True)[:2].tolist()
    for j in part[:top] + [j for j in worst if j not in part[:top]]:
        kmax = max(int(ik[j]), int(ip[j]))
        steps, independent = [], [True, True]  # kernel, plain
        for k in range(kmax + 1):
            fk, fp = capped(k)
            for side, (whole_, fn) in enumerate((
                    (fk, B1.pn_tv1_fused),
                    (fp, lambda *a, **k_: B1.pn_tv1_fused_plain(*a, tb=1,
                                                                **k_)))):
                alone = fn(y[j:j + 1], max_iters=k, **kw)
                independent[side] = independent[side] and all(
                    bool(torch.equal(alone[i], whole_[i][j:j + 1]))
                    for i in (0, 1))
            cert = [cs.pn_certificate(f[0][j:j + 1], f[1][j:j + 1],
                                      y[j:j + 1], lam_full[j:j + 1], 1e-6,
                                      10.0) for f in (fk, fp)]
            steps.append({
                "k": k, "dist": float((fk[0][j] - fp[0][j]).abs().max()),
                "gap_over_tol": [float(c[0][0] / c[1][0]) for c in cert]})
        rows.append({"fiber": j, "iters": [int(ik[j]), int(ip[j])],
                     "diff": float(fib[j]), "independent": independent,
                     "steps": steps})
    print(f"[2] {label}: {len(part)} of {y.shape[0]} fibers part in count; "
          f"fibers whose counts agree differ by at most "
          f"{float(torch.where(ik != ip, 0.0, fib).max()):.3e}")
    for r in rows:
        print(f"    fiber {r['fiber']}: Newton kernel {r['iters'][0]} / plain "
              f"{r['iters'][1]}, {r['diff']:.3e} apart where each stopped; "
              f"alone bit for bit with its row at every cap: kernel "
              f"{r['independent'][0]}, plain {r['independent'][1]}")
        for s in r["steps"]:
            print(f"      max_iters {s['k']}: {s['dist']:.3e} apart; gap/tol "
                  f"kernel {s['gap_over_tol'][0]:.5f} / plain "
                  f"{s['gap_over_tol'][1]:.5f}")
    return {"label": label, "parting": len(part), "rows": rows}


def f2_rows(B1, Y1, W1):
    import torch

    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.runtime import native

    x = tv1d_l1.tv1_batched(torch.from_numpy(Y1).cuda(),
                            torch.from_numpy(W1).cuda(), method="pn")
    X = x.cpu().numpy().astype(np.float64)
    ref = np.stack([native.tv1w_host(Y1[i], W1[i]) for i in range(len(Y1))])
    e = np.abs(X - ref).max(axis=1)
    far = np.nonzero(e > cs.TOL["pn"])[0].tolist()
    out = {}
    for i in far:
        y = torch.from_numpy(Y1[i:i + 1]).cuda()
        lf = torch.nn.functional.pad(torch.from_numpy(W1[i:i + 1]).cuda(),
                                     (0, 1))
        xp, _, ip = B1.pn_tv1_fused_plain(y, lf, tb=1)
        out[i] = {"card": float(e[i]), "plain_alone": float(
            np.abs(xp.cpu().numpy()[0] - ref[i]).max()), "plain_iters":
            int(ip[0])}
        print(f"[3] F2 row {i}: max|x - x_host64| {e[i]:.4e} on the card, "
              f"{out[i]['plain_alone']:.4e} through the plain version alone "
              f"({out[i]['plain_iters']} Newton steps)")
    print(f"[3] F2: {len(far)} of {len(Y1)} rows past {cs.TOL['pn']}")
    return out


def main():
    import torch

    from proxtv_tpu_torch.ops.kernels import pn_fused as B1

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    Y1, noisy_t1, Ypi, W1 = smoke_inputs()
    res = {"card": card,
           "per_image": per_image_split(B1, Ypi, args.top),
           "cold": [trajectories(B1, torch.from_numpy(Y1).cuda(), cs.LAM1D,
                                 f"bench batch lam {cs.LAM1D}", args.top),
                    trajectories(B1, torch.from_numpy(noisy_t1).cuda(),
                                 cs.T1LAM, f"T1 input lam {cs.T1LAM}",
                                 args.top)],
           "f2": f2_rows(B1, Y1, W1)}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
