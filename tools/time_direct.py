#!/usr/bin/env python3
"""Time kernels D1 (taut string, ``csrc/tautstring.cu``), D2 (message-
passing DP, ``csrc/dp.cu``), D3 (Condat, ``csrc/condat.cu``) and D4 (classic
taut string, ``csrc/classic_ts.cu``) per launch on one CUDA card, across
batch sizes.

    python3 tools/time_direct.py [--rows 1,32,132,1024,10000] [--n 1000]
                                 [--kernels D1,D2,D3,D4] [--no-events]
                                 [--dtype float32|float64] [--repo DIR]
                                 [--wrapper] [--walk] [--layouts]

For each batch of B signals of length n (randn, seeded, lam 0.7), for a
batch of 32 copies of one signal (every signal takes the same path), for
the per-edge-weighted batches of ``chip_smoke.py``'s main path (512
and 1 signals, weights U[0, 1.4] with 5% zeroed), and for the two inputs
that main path gives D3 and D4 (the first 512 rows of its 10000 x 1000
batch at lam 0.7, and its random walk of 1000 at lam 2.0, drawn as
``chip_smoke.py`` draws them), each kernel is first held
against its plain version on the CPU on three of its rows, the first, the
middle and the last (max |kernel - plain| within 1e-5 of the data's size,
the bar of ``chip_smoke.py`` ``TOL["direct"]``), then timed by CUDA
events: 20 launches of its C entry point, arguments made once by ``bind``,
after one untimed.  D3 and D4 take one lambda a signal and skip the
per-edge cases.  On the main path's two inputs the line also gives D3's
and D4's events a signal, mean and most, counted in their plain versions
on the CPU (the lock-step step at which each signal ends), and ns an event
of the signal with the most (one signal's dependent chain sets a launch
that fits in one wave); ``--no-events`` leaves the counts out.
``--kernels`` picks the kernels timed.  ``--repo`` times the package of
another checkout (an unpacked parent commit, say) with the same cases, so
that two versions are compared in one call on one card; a kernel that
checkout lacks is left out.  ``--dtype float64`` times each kernel's
float64 instantiation on the same draws in double, held against the
float64 plain versions.  ``--wrapper`` also times each kernel's Python
wrapper (``tautstring.tautstring`` ...), in turns with its C entry (C
entry, wrapper, wrapper, C entry) on the same inputs.  Each D2 case also
records the layout it ran on, and each float64 D1 case the lanes a
signal.  ``--layouts`` (float64) also times D1 at 32 and 8 lanes a
signal and D2 on its warp layout and its lane layout at 32, 16, 8 and 4
signals a warp (``bind(..., lanes=)``, ``bind(..., layout=)``), each first
held bit for bit against the plain version on the case's three rows.  ``--walk`` (float64) adds
ROADMAP C's walk, n = 11621 at lam 1.3 (seed 15), held against the native
host taut string within 1e-9 (the plain versions take a minute there on
the CPU; ``chip_smoke.py`` phase 7 holds D4 on it bit for bit).  Prints one JSON line with the card's name and power limit
and each case's ms per launch.  Imports nothing of JAX.
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
WALK_C = "1x11621 C walk, lam 1.3"


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


def main_path_inputs(n):
    """The D3 / D4 inputs of chip_smoke.py's main path: its bench batch's
    first 512 rows (at lam 0.7) and its random walk (at lam 2.0), from the
    same seed and in the same draws."""
    rng = np.random.RandomState(0)
    rng.randn(1024, 1024)                       # the bench image
    Y1 = rng.randn(10000, n).astype(np.float32)  # the bench batch
    walk = np.cumsum(rng.randn(n)) * 0.3
    return Y1[:512], walk[None].astype(np.float32)


def events(plain, y, lam):
    """(mean, most) events a signal of a D3 / D4 plain version on the CPU:
    its lock-step scan run one step at a time, each signal's count the
    step at which it ends."""
    import torch

    from proxtv_tpu_torch.ops import tv1d_l1

    ended = {"tv1_condat_plain": lambda s: s[8],
             "tv1_classic_ts_plain": lambda s: s[0] == tv1d_l1._CT_DONE}[
        plain.__name__]
    ends = []

    def lockstep(body, state, running, cap=None):
        end = None
        step = 0
        while cap is None or step < cap:
            state = body(state)
            step += 1
            done = ended(state)
            at = torch.where(done, step, torch.iinfo(torch.int64).max)
            end = at if end is None else torch.minimum(end, at)
            if bool(done.all()):
                break
        ends.append(end)
        return state

    run = tv1d_l1._run_lockstep
    tv1d_l1._run_lockstep = lockstep
    try:
        plain(torch.from_numpy(y), lam)
    finally:
        tv1d_l1._run_lockstep = run
    e = ends[0].double()
    return float(e.mean()), int(e.max())


def cases(rows, n, walk=False):
    """(name, y, lam) of every case, from seeded numpy draws."""
    Ymain, walk1 = main_path_inputs(n)
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
    out.append((f"512x{n} main path", Ymain, LAM))
    out.append((f"1x{n} walk, lam 2.0", walk1, 2.0))
    if walk:
        rng15 = np.random.RandomState(15)
        out.append((WALK_C, (np.cumsum(rng15.randn(11621)) * 0.3
                             + rng15.randn(11621))[None], 1.3))
    return out


def main(rows, n, repo, only, count_events=True, dtype="float32",
         wrapper=False, walk=False, layouts=False):
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
        if kid in only:
            kernels[kid] = (mod, getattr(tv1d_l1, plain))
    out = {"card": card, "repo": os.path.abspath(repo), "n": n, "lam": LAM,
           "dtype": dtype, "cases": []}
    for name, y, lam in cases(rows, n, walk and dtype == "float64"):
        y = y.astype(dtype)
        if isinstance(lam, np.ndarray):
            lam = lam.astype(dtype)
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
            if kid == "D2":
                f64 = (yt.dtype,) if dtype == "float64" else ()
                if hasattr(mod, "layout"):
                    rec["D2_layout"] = mod.layout(
                        *y.shape, isinstance(lam, np.ndarray), *f64)
                else:  # a checkout before the float64 ring layouts
                    rec["D2_layout"] = "warp" if mod.warp_layout(
                        *y.shape, isinstance(lam, np.ndarray), *f64) \
                        else "thread"
            if kid == "D1" and dtype == "float64" and hasattr(mod, "lanes"):
                rec["D1_lanes"] = mod.lanes(*y.shape)
            if name == WALK_C:
                from proxtv_tpu_torch.runtime import native

                ref = torch.from_numpy(native.tv1_host(y[0], lam)[None])
            else:
                ref = plain(y_c, lam_c)
            torch.cuda.synchronize()
            err = float((res[rows_].cpu() - ref).abs().max()) / max(
                1.0, float(np.abs(y).max()))
            if err > (1e-9 if name == WALK_C else TOL):
                sys.exit(f"{kid} {name}: max|kernel - plain| / scale {err} > "
                         f"{TOL}")
            if layouts and dtype == "float64" and kid in ("D1", "D2"):
                # Every float64 layout on the same case, held first.
                for lay in ((32, 8) if kid == "D1"
                            else ("warp", "lane", "lane16", "lane8", "lane4")):
                    kw = {"lanes": lay} if kid == "D1" else {"layout": lay}
                    r_l, l_l = mod.bind(yt, lt, **kw)
                    l_l()
                    torch.cuda.synchronize()
                    e_l = float((r_l[rows_].cpu() - ref).abs().max())
                    if e_l != 0.0 and name != WALK_C:
                        sys.exit(f"{kid} {name} {lay}: not bit for bit "
                                 f"({e_l})")
                    rec[f"{kid}_{lay}_ms"] = time_ms(l_l)
            if wrapper:
                wrap = getattr(mod, {"D1": "tautstring", "D2": "dp",
                                     "D3": "condat",
                                     "D4": "classic_ts"}[kid])
                turns = [time_ms(launch), time_ms(lambda: wrap(yt, lt)),
                         time_ms(lambda: wrap(yt, lt)), time_ms(launch)]
                rec[kid + "_turns_c_w_w_c"] = turns
                rec[kid + "_wrapper_ms"] = (turns[1] + turns[2]) / 2
                rec[kid + "_ms"] = (turns[0] + turns[3]) / 2
            else:
                rec[kid + "_ms"] = time_ms(launch)
            rec[kid + "_err"] = err
            if count_events and kid in ("D3", "D4") and name.endswith(
                    ("main path", "walk, lam 2.0")):
                mean, most = events(plain, y, lam)
                rec[kid + "_events_mean"], rec[kid + "_events_max"] = (mean,
                                                                       most)
                rec[kid + "_ns_per_event"] = rec[kid + "_ms"] * 1e6 / most
        out["cases"].append(rec)
        times = ", ".join(
            f"{k[:-3]} {v:.4f} ms" + (
                f" ({rec[k[:-3] + '_events_max']} events, "
                f"{rec[k[:-3] + '_ns_per_event']:.1f} ns each)"
                if k[:-3] + "_events_max" in rec else "")
            for k, v in rec.items() if k.endswith("_ms"))
        if "D2_layout" in rec:
            times += f" (D2 {rec['D2_layout']} layout)"
        if "D1_lanes" in rec:
            times += f" (D1 {rec['D1_lanes']} lanes a signal)"
        print(f"[{name}] {times} ({dtype}; {card}; {out['repo']})",
              flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="1,32,132,1024,10000")
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--kernels", default="D1,D2,D3,D4",
                    help="the kernels to time")
    ap.add_argument("--no-events", action="store_true",
                    help="leave out D3's and D4's event counts")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose package is timed")
    ap.add_argument("--wrapper", action="store_true",
                    help="time each wrapper too, in turns with its C entry")
    ap.add_argument("--walk", action="store_true",
                    help="float64: add ROADMAP C's n = 11621 walk")
    ap.add_argument("--layouts", action="store_true",
                    help="float64: also time D1 at 32 and 8 lanes a signal "
                    "and D2 on its warp and lane layouts")
    a = ap.parse_args()
    main([int(r) for r in a.rows.split(",")], a.n, a.repo,
         a.kernels.split(","), not a.no_events, a.dtype, a.wrapper, a.walk,
         a.layouts)
