#!/usr/bin/env python3
"""Count the message-passing DP's deque depths on the CPU: how many
breakpoints the deque holds at once, and at how many samples a ring of C
slots would overflow.

    python3 tools/dp_depths.py [--rings 16,32,64,128] [--rows 200]

Runs a sequential replica of kernel D2's scan (``csrc/dp.cu``, the plain
version's deque operations in its order and rounding, in float64) on
``chip_smoke.py`` phase 7's D2 inputs (the first ``--rows`` rows of its
10000 x 1000 batch at lam 0.7 and of its per-edge-weighted 512 x 1000
batch, drawn as the smoke draws them), on seeded randn signals at lam 0.7
and 50, walks, ramps, and on the signal that overflows a ring of 64 slots
(:func:`overflow_signal`, which the smoke and the card tests run).  For
each: the most live breakpoints (R - L + 1) and, for each ring of C slots,
the samples at whose start the kernel's float64 layouts find R - L + 4 > C
(a signal with any runs again from the workspace).  Prints one line a
signal and one JSON line.  Needs numpy only; imports nothing of JAX or
torch.
"""
import argparse
import json

import numpy as np

RING = 64       # csrc/dp.cu kRing64
LAM = 0.7       # chip_smoke.py LAM1D
LAMW, ZERO_W = 1.4, 0.05  # chip_smoke.py's per-edge weights: U[0, 1.4], 5% 0


def scan(y, lam, rings=(RING,)):
    """D2's scan of one signal y (float64) with weights lam (a scalar or
    n - 1 edge weights).  Returns (x, the most live breakpoints, {C: the
    samples at whose start R - L + 4 > C})."""
    y = np.asarray(y, np.float64)
    n = len(y)
    w_all = (np.full(n - 1, float(lam)) if np.ndim(lam) == 0
             else np.asarray(lam, np.float64))
    pl = [0.0] * (2 * n + 1)
    ps = [0] * (2 * n + 1)
    lo = [0.0] * n
    hi = [0.0] * n
    L, R = n - 1, n
    w0 = float(w_all[0])
    lo0, hi0 = -w0 + y[0], w0 + y[0]
    ps[L - 1] = -1
    pl[L], ps[L] = lo0, 0
    pl[R], ps[R] = hi0, -1
    lo[0], hi[0] = lo0, hi0
    A = 1
    most = 2
    over = {C: 0 for C in rings}
    last_val = 0.0
    for i in range(1, n):
        A += 1
        for C in rings:
            over[C] += R - L + 4 > C
        wp = float(w_all[i - 1])
        w = float(w_all[i]) if i < n - 1 else 0.0
        bi = float(y[i])
        mmin = -wp + pl[L] - bi
        mmax = wp + pl[R] - bi
        slope = 1
        while mmin < -w:
            slope = ps[L] + A
            L += 1
            if L > R:
                break
            mmin = mmin + (pl[L] - pl[L - 1]) * float(slope)
        if i == n - 1:
            last_val = pl[L - 1 if L > R else L] - mmin / float(slope)
            break
        L -= 1
        ps[L - 1] = -A
        if L == R:
            p = pl[L]
            hm, lm = p - (mmax - w), p - (mmax + w)
            R += 1
            ps[R], pl[R], pl[L] = -A, hm, lm
            hi[i], lo[i] = hm, lm
            most = max(most, R - L + 1)
            continue
        lon = pl[L + 1] - (w + mmin) / float(slope)
        pl[L] = lon
        lo[i] = lon
        slope = 1
        while mmax > w:
            R -= 1
            slope = ps[R] + A
            mmax = mmax - (pl[R + 1] - pl[R]) * float(slope)
            if R == L:
                break
        R += 1
        hu = pl[R - 1] + (w - mmax) / float(slope)
        ps[R], pl[R] = -A, hu
        hi[i] = hu
        most = max(most, R - L + 1)
    x = np.empty(n)
    xv = last_val
    x[n - 1] = xv
    for j in range(n - 2, -1, -1):
        xv = min(max(xv, lo[j]), hi[j])
        x[j] = xv
    return x, most, over


def overflow_signal():
    """The signal whose deque outgrows a ring of 64 slots: a linear ramp of
    1000 samples from 0 to 1 at lam 2 (its tube wide against its rise)
    holds 91 breakpoints at once (at lam 0.7, 55)."""
    return np.linspace(0.0, 1.0, 1000), 2.0


def phase7_rows(rows):
    """The first ``rows`` rows of chip_smoke.py phase 7's D2 batches, in
    float64: its 10000 x 1000 bench batch (lam 0.7) and its per-edge 512 x
    1000 batch with its weights."""
    rng = np.random.RandomState(0)               # chip_smoke.SEED
    rng.randn(1024, 1024)                        # the bench image
    Y1 = rng.randn(10000, 1000).astype(np.float32)
    rng_w = np.random.RandomState(0 + 4)         # chip_smoke's rng6
    Ww = rng_w.rand(512, 999) * LAMW
    Ww[rng_w.rand(512, 999) < ZERO_W] = 0.0
    Y1 = Y1.astype(np.float64)
    return ([(f"phase 7 Y1 row {k}", Y1[k], LAM) for k in range(rows)]
            + [(f"phase 7 per-edge row {k}", Y1[k],
                Ww.astype(np.float32)[k].astype(np.float64))
               for k in range(min(rows, 512))])


def signals(rows):
    yield from phase7_rows(rows)
    rng = np.random.RandomState(0)
    for n in (1000, 5000):
        yield f"randn n={n} lam 0.7", rng.randn(n), 0.7
        yield f"randn n={n} lam 50", rng.randn(n), 50.0
        yield f"walk n={n}", np.cumsum(rng.randn(n)), 0.7
        yield f"walk n={n} lam 2", np.cumsum(rng.randn(n)), 2.0
        yield f"ramp n={n}", np.linspace(0.0, 1.0, n), 0.7
    y, lam = overflow_signal()
    yield f"overflow signal n={len(y)} lam {lam}", y, lam


def main(rings, rows):
    out = []
    agg = {}
    for name, y, lam in signals(rows):
        _, most, over = scan(y, lam, rings)
        group = name.rsplit(" row ", 1)[0]
        if group != name:  # phase 7's rows: one line a batch
            a = agg.setdefault(group, {"signal": group, "rows": 0,
                                       "most": 0,
                                       "reruns": {C: 0 for C in rings}})
            a["rows"] += 1
            a["most"] = max(a["most"], most)
            for C in rings:
                a["reruns"][C] += over[C] > 0
            continue
        rec = {"signal": name, "most": most, "overflow_samples": over}
        out.append(rec)
        print(f"[{name}] most live breakpoints {most}; samples past a ring "
              f"of C: {over}", flush=True)
    for a in agg.values():
        print(f"[{a['signal']}, {a['rows']} rows] most live breakpoints "
              f"{a['most']}; rows that run again, for each ring of C: "
              f"{a['reruns']}", flush=True)
        out.append(a)
    print(json.dumps(out))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rings", default="16,32,64,128")
    ap.add_argument("--rows", type=int, default=200)
    a = ap.parse_args()
    main([int(r) for r in a.rings.split(",")], a.rows)
