#!/usr/bin/env python3
"""Count the classic taut string's deque depths on the CPU: how many
segments each hull holds at once, how far its slot index climbs, and how
many reads a ring of R slots would miss.

    python3 tools/classic_ts_depths.py [--rings 128,256,512,1024]

Runs a sequential replica of kernel D4's scan (``csrc/classic_ts.cu``
classic_scan, the plain version's events in its order, in float64) on
ROADMAP C's walk (n = 11621, ``cumsum(randn) * 0.3 + randn``, seed 15, lam
1.3), on seeded randn signals, walks, ramps, a sine and an exponential
to n = 20000, and on a ramp whose tube is wide against its rise (n =
6000, lam 1000), whose minorant overruns a ring of 512.  For each: the
events (pops, pushes, crossing tests, knots, flush emissions: the plain
version's lock-step count; the pops, the knots and the samples that pop,
whose pushes divide), and per hull the most segments it held, the highest
slot index it wrote, and the reads
(the slot below a popped one, a hull's new first after a knot, the
flush) whose ring place a later slot had taken, for each ring size.
Prints one line a signal and one JSON line.  Needs numpy only; imports
nothing of JAX or torch.
"""
import argparse
import json

import numpy as np


class Hull:
    """One hull's deque: slots written at indices, with a ring's tags."""

    def __init__(self, n, rings):
        self.ix = [0] * (n + 2)
        self.iy = [0.0] * (n + 2)
        self.f = self.l = 0
        self.most = 1
        self.top = 0
        self.tags = {R: [-1] * R for R in rings}
        self.miss = {R: 0 for R in rings}

    def st(self, k, ix, iy):
        self.ix[k], self.iy[k] = ix, iy
        self.top = max(self.top, k)
        for R, t in self.tags.items():
            t[k % R] = k

    def ld(self, k):
        for R, t in self.tags.items():
            self.miss[R] += t[k % R] != k

    def slope(self, k):
        return self.iy[k] / self.ix[k]


def scan(y, lam, rings):
    """The events of one signal and its two hulls."""
    n = len(y)
    events = 0
    kind = {"pops": 0, "knots": 0, "popped samples": 0}
    mj, mn = Hull(n, rings), Hull(n, rings)
    mj.st(0, 1, y[0] - lam)
    mn.st(0, 1, y[0] + lam)
    lx, ox, ly, oy = 1, 0, y[0], 0.0
    for i in range(1, n):
        last = i == n - 1
        popped = 0
        for h, up, sy in ((mj, True, y[i] + lam if last else y[i]),
                          (mn, False, y[i] - lam if last else y[i])):
            sx = 1
            while h.l >= h.f:
                t = sx * h.slope(h.l)
                if not (sy > t if up else sy < t):
                    break
                events += 1
                popped += 1
                if h.l > 1:
                    h.ld(h.l - 2)
                sx += h.ix[h.l]
                sy += h.iy[h.l]
                h.l -= 1
            events += 1
            h.l += 1
            h.st(h.l, sx, sy)
            h.most = max(h.most, h.l - h.f + 1)
        kind["pops"] += popped
        kind["popped samples"] += popped > 0
        if last:
            break
        lx += 1
        ly += y[i]
        while True:
            events += 1
            if mj.l == mj.f and mn.l == mn.f:
                break
            if not mn.slope(mn.f) < mj.slope(mj.f):
                break
            if mn.ix[mn.f] < mj.ix[mj.f]:
                g, h, y_end = mn, mj, ly - lam
            else:
                g, h, y_end = mj, mn, ly + lam
            kind["knots"] += 1
            kx, ky = g.ix[g.f], g.iy[g.f]
            h.st(0, lx - ox - kx, y_end - oy - ky)
            h.f = h.l = 0
            g.f += 1
            g.ld(g.f)
            ox += kx
            oy += ky
    q = mj if (mj.l - mj.f) > (mn.l - mn.f) else mn
    for k in range(q.f, q.l + 1):
        events += 1
        q.ld(k)
    return events, kind, mj, mn


def signals():
    rng15 = np.random.RandomState(15)
    n = 11621
    yield ("ROADMAP C walk n=11621", np.cumsum(rng15.randn(n)) * 0.3
           + rng15.randn(n), 1.3)
    rng = np.random.RandomState(0)
    for n in (1000, 4800, 20000):
        yield f"randn n={n}", rng.randn(n), 0.7
        yield f"walk n={n}", np.cumsum(rng.randn(n)), 0.1
        yield f"ramp n={n}", np.linspace(0.0, 1.0, n) ** 2, 1e-3
        yield f"sine n={n}", np.sin(np.linspace(0.0, 3.0, n)) * 5, 0.01
        yield f"exp n={n}", np.exp(np.linspace(0.0, 5.0, n)), 1.0
    # A tube wide against its rise: the minorant holds hundreds of
    # segments and overruns a ring of 512 (the card tests' ring case).
    yield "ramp 0..30 n=6000", np.linspace(0.0, 30.0, 6000), 1000.0


def main(rings):
    out = []
    for name, y, lam in signals():
        events, kind, mj, mn = scan(list(y), lam, rings)
        rec = {"signal": name, "lam": lam, "events": events, **kind,
               "most_segments": [mj.most, mn.most],
               "top_index": [mj.top, mn.top],
               "ring_misses": {R: mj.miss[R] + mn.miss[R] for R in rings}}
        out.append(rec)
        print(f"[{name}, lam {lam}] {events} events ({kind['pops']} pops, "
              f"{kind['knots']} knots, {kind['popped samples']} samples "
              f"that pop and so divide); most segments "
              f"(majorant, minorant) {mj.most}, {mn.most}; top index "
              f"{mj.top}, {mn.top}; ring misses {rec['ring_misses']}",
              flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rings", default="128,256,512,1024")
    a = ap.parse_args()
    main([int(r) for r in a.rings.split(",")])
