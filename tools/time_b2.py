#!/usr/bin/env python3
"""Time kernel B2 (the SPD second-difference tridiagonal solve,
``csrc/pcr.cu``) per launch on one CUDA card, at the main path's launches.

    python3 tools/time_b2.py [--dtype float32|float64] [--repo DIR]
                             [--edges]

The main path's systems, recorded from the calls that launch B2 (a tap on
the wrapper keeps each launch's inputs): ``api.tv1_1d`` pn on an n = 1000
random walk at w = 2.0 (its dual init, 1 x 999 plain, and its Newton
systems, 1 x 999 masked), the TV-Lp setup solve of ``tvp_batched`` on
512 x 1000 randn at lam 0.7, p = 1.5 (512 x 999 plain), and the per-sweep
setup solves of ``api.tvp_2d`` p = 1.5 on 512^2 randn at lam 0.3
(512 x 511 plain).  Each case is one (shape, kind) with its launches in the
order the path made them.

Each launch is first held against the plain version (float32 PCR, tb = 1):
max |kernel - plain| within 1e-3 of the solution's size (``chip_smoke.py``
``TOL["pcr_path"]``).  Both are also held against the plain version in
float64 on the same inputs, and their errors printed (``err64_kernel``,
``err64_plain``).  Then CUDA events time 20 passes over the case's launches
after one untimed, every case in turn, ROUNDS times.  ``ms`` times the C
entry point alone per launch, called with its arguments made once by
``pcr.bind`` (the kernel's time); ``wrapper_ms`` times the Python wrapper
``pcr_spd_solve``.  Prints one JSON line with the card's name and power
limit, the compiler's register, shared-memory and spill lines of the B2
source, and each case's times and agreement.

``--dtype float64`` times the float64 instantiation at the shapes of
``chip_smoke.py`` phase 7's launches, on seeded inputs of the kind each
launch has there: 1 x 999 masked (``tv1_pn``), 512 x 999 plain (the TV-Lp
setup), 256 x 255, 1024 x 1023, 8192 x 255 and 65536 x 31 masked (the 2D
and ND fibers), 196 x 6399 masked (the long route's windows) and
10000 x 999 shifted (TV-L2).  Each is held against the float64 plain
version on the card within ``chip_smoke.py`` ``TOL64["pcr"]`` of the
solution's size, times (n / 1000)^2 past n = 1000 (the bar of
``tests/test_torch_cuda.py``), then timed as above, and so is each float64
layout whose longest n covers it (``pcr.layouts_f64``, where the checkout
has them), through ``pcr.bind(layout=...)``.  Beside them: the launch floor,
an empty kernel launched through the same ctypes path and timed the same
way (``pcr_empty_launch``, where the checkout has it), and
``torch.linalg.solve`` on the dense form of each system (mask and shift
included; the dense matrices made outside the timed window), or the size
that does not fit.  ``--edges`` also prints each layout's error over its
bar at n = 2, 31, 32, 33 and every layout's longest n and one past it, B =
5, plain, masked and shifted.

``--repo`` imports the package from another checkout (an unpacked parent
commit, say), so that two trees are timed with the same cases: run
parent, change, change, parent in one call on one card.  By default the
package is imported from the tree this file sits in.  Imports nothing of
JAX.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPS, ROUNDS = 20, 3
TOL_PATH = 1e-3
TOL64 = 1e-10
# Phase 7's float64 shapes: (B, n, kind).
SHAPES64 = ((1, 999, "masked"), (512, 999, "plain"), (256, 255, "masked"),
            (1024, 1023, "masked"), (8192, 255, "masked"),
            (65536, 31, "masked"), (196, 6399, "masked"),
            (10000, 999, "shifted"))
DENSE_BYTES = 40e9  # the largest dense batch torch.linalg.solve is given


def time_ms(fn, reps=REPS):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_lines(log, source="pcr.cu"):
    """The register / shared-memory / spill lines of one source."""
    part = log.split(f"== {source}", 1)[-1].split("\n== ", 1)[0]
    return [ln.strip() for ln in part.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln
            or "stack" in ln]


def record_main_path(rng):
    """{(B, n, kind): [(rhs, mask, shift), ...]} from the main path."""
    import torch

    import proxtv_tpu_torch as ptv
    from proxtv_tpu_torch.ops import tv1d_lp
    from proxtv_tpu_torch.ops.kernels import pcr as B2

    calls, launch = {}, B2.pcr_spd_solve

    def record(rhs, mask=None, diag_shift=None):
        kind = ("masked" if mask is not None else "shifted"
                if diag_shift is not None else "plain")
        calls.setdefault((*rhs.shape, kind), []).append(
            tuple(None if v is None else v.clone()
                  for v in (rhs, mask, diag_shift)))
        return launch(rhs, mask=mask, diag_shift=diag_shift)

    y1 = np.cumsum(rng.randn(1000)) * 0.3
    Y = torch.from_numpy(rng.randn(512, 1000).astype(np.float32)).cuda()
    Y5 = rng.randn(512, 512)
    B2.pcr_spd_solve = record
    try:
        ptv.tv1_1d(y1, 2.0, method="pn")
        tv1d_lp.tvp_batched(Y, 0.7, 1.5)
        ptv.tvp_2d(Y5, 0.3, 0.3, 1.5, 1.5, max_iters=35)
    finally:
        B2.pcr_spd_solve = launch
    return calls


def inputs64(B, n, kind, rng):
    """A seeded float64 system of the given kind: (rhs, mask, shift) on the
    card; masks keep ~70% of the rows, with masked ends."""
    import torch

    rhs = torch.from_numpy(0.01 * rng.randn(B, n)).cuda()
    mask = shift = None
    if kind == "masked":
        m = rng.rand(B, n) > 0.3
        m[:, 0] = m[:, -1] = False
        mask = torch.from_numpy(m).cuda()
    elif kind == "shifted":
        shift = torch.from_numpy(rng.rand(B) + 0.5).cuda()
    return rhs, mask, shift


def dense(rhs, mask, shift):
    """The (B, n, n) matrices of the systems and their right-hand sides, as
    ``pcr.pcr_spd_solve_plain`` defines them: DD' [+ shift I], masked rows
    identity rows with zero right-hand side and a coupling only between
    two unmasked rows."""
    import torch

    B, n = rhs.shape
    if mask is None:
        m = torch.ones_like(rhs)
        diag = 2.0 + (shift.reshape(-1, 1) if shift is not None else 0.0) \
            * torch.ones_like(rhs)
        off = -torch.ones((B, n - 1), dtype=rhs.dtype, device=rhs.device)
        r = rhs
    else:
        m = mask.to(rhs.dtype)
        diag = 1.0 + m
        off = -(m[:, 1:] * m[:, :-1])
        r = m * rhs
    A = torch.diag_embed(diag) + torch.diag_embed(off, 1) \
        + torch.diag_embed(off, -1)
    return A, r.unsqueeze(-1)


def bar64(n):
    return TOL64 * max(1.0, (n / 1000) ** 2)


def err_rel(out, ref):
    return float((out - ref).abs().max()) / max(1e-300,
                                                 float(ref.abs().max()))


def main64(card, edges):
    """The float64 instantiation at phase 7's shapes (see the docstring)."""
    import ctypes

    import torch

    from proxtv_tpu_torch.ops.kernels import build
    from proxtv_tpu_torch.ops.kernels import pcr as B2

    lib = build.lib()
    layouts = B2.layouts_f64() if hasattr(B2, "layouts_f64") else {}
    stream = build.stream_ptr(torch.device("cuda"))
    floor = None
    if hasattr(lib, "pcr_empty_launch"):
        def floor(stream=stream):
            build.check(lib.pcr_empty_launch(stream), "pcr_empty_launch")
    rng = np.random.RandomState(0)
    cases, ok = [], True
    for Bs, ns, kind in SHAPES64:
        r_, m_, s_ = inputs64(Bs, ns, kind, rng)
        ref = B2.pcr_spd_solve_plain(r_, mask=m_, diag_shift=s_)
        out = B2.pcr_spd_solve(r_, mask=m_, diag_shift=s_)
        err = err_rel(out, ref)
        ok = ok and err <= bar64(ns)
        runs = {}
        o2, launch = B2.bind(r_, mask=m_, diag_shift=s_)
        runs["C entry"] = launch
        runs["wrapper"] = lambda a=(r_, m_, s_): B2.pcr_spd_solve(
            a[0], mask=a[1], diag_shift=a[2])
        errs = {}
        for name, top in layouts.items():
            if ns <= top:
                o3, launch = B2.bind(r_, mask=m_, diag_shift=s_,
                                     layout=name)
                launch()
                torch.cuda.synchronize()
                errs[name] = err_rel(o3, ref)
                ok = ok and errs[name] <= bar64(ns)
                runs[name] = launch
        if floor is not None:
            runs["launch floor"] = floor
        A = b = None
        need = Bs * ns * ns * 8
        if need <= DENSE_BYTES:
            A, b = dense(r_, m_, s_)
            x = torch.linalg.solve(A, b)[..., 0]
            errs["torch.linalg.solve"] = err_rel(x, ref)
            runs["torch.linalg.solve"] = lambda A=A, b=b: torch.linalg.solve(
                A, b)
        cases.append(dict(
            case=f"{Bs}x{ns} {kind}", err=err, bar=bar64(ns),
            layout=(B2.layout_f64(ns) if hasattr(B2, "layout_f64")
                    else None), errs=errs,
            dense=None if A is not None else
            f"does not fit: {need / 1e9:.1f} GB of dense matrices",
            ms={k: [] for k in runs}, _runs=runs, _keep=(A, b, o2)))
    for _ in range(ROUNDS):
        for c in cases:
            for k, fn in c["_runs"].items():
                c["ms"][k].append(time_ms(
                    fn, 2 if k == "torch.linalg.solve" else REPS))
    for c in cases:
        del c["_runs"], c["_keep"]
        print(f"[B2.f64 {c['case']}] layout {c['layout']}, err "
              f"{c['err']:.3e} (bar {c['bar']:.1e}); "
              + ", ".join(f"{k} {min(v):.4f}" for k, v in c["ms"].items())
              + f" ms  ({card})", flush=True)
    out = {"card": card, "repo": REPO, "dtype": "float64", "cases": cases}
    if edges and layouts:
        out["edges"] = edge_errors(layouts)
    return out, ok


def edge_errors(layouts):
    """Each float64 layout's error over its bar at the layouts' edges: n =
    2, 31, 32, 33, each layout's longest n and one past it, B = 5, plain,
    masked (long runs) and shifted, against the plain version."""
    import torch

    from proxtv_tpu_torch.ops.kernels import pcr as B2

    ns = sorted({2, 31, 32, 33, *layouts.values(),
                 *(v + 1 for v in layouts.values() if v < 8192)})
    res = {}
    for n in ns:
        rng = np.random.RandomState(n)
        d = torch.from_numpy(0.01 * rng.randn(5, n)).cuda()
        m = rng.rand(5, n) > 0.3
        m[:, n // 8: n // 2] = True
        m[:, 0] = m[:, -1] = False
        m[0] = True
        kws = ({}, {"mask": torch.from_numpy(m).cuda()},
               {"diag_shift": torch.from_numpy(rng.rand(5) + 0.5).cuda()})
        res[n] = {}
        for name, top in layouts.items():
            if n > top:
                continue
            worst = 0.0
            for kw in kws:
                ref = B2.pcr_spd_solve_plain(d, **kw)
                o, launch = B2.bind(d, layout=name, **kw)
                launch()
                torch.cuda.synchronize()
                worst = max(worst, err_rel(o, ref) / bar64(n))
            res[n][name] = worst
        print(f"[B2.f64 edge n={n}] error / bar: "
              + ", ".join(f"{k} {v:.3f}" for k, v in res[n].items()),
              flush=True)
    return res


def main(dtype="float32", edges=False):
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from proxtv_tpu_torch.ops.kernels import build
    from proxtv_tpu_torch.ops.kernels import pcr as B2

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    build.build()  # reused if built; BUILD_LOG holds the compiler's lines
    if dtype == "float64":
        out, ok = main64(card, edges)
        out["ptxas"] = ptxas_lines(build.BUILD_LOG["ptxas"] or "")
        print(json.dumps(out))
        if not ok:
            sys.exit("B2.f64 disagrees with its plain version")
        return
    rng = np.random.RandomState(0)
    cases, ok = [], True
    for (Bs, ns, kind), launches in record_main_path(rng).items():
        worst, e64k, e64p, launchers = 0.0, 0.0, 0.0, []
        for r_, m_, s_ in launches:
            out = B2.pcr_spd_solve(r_, mask=m_, diag_shift=s_)
            ref = B2.pcr_spd_solve_plain(r_, mask=m_, diag_shift=s_)
            ref64 = B2.pcr_spd_solve_plain(
                r_.double(), mask=m_,
                diag_shift=None if s_ is None else s_.double())
            worst = max(worst, float((out - ref).abs().max())
                        / max(1.0, float(ref.abs().max())))
            e64k = max(e64k, float((out.double() - ref64).abs().max()))
            e64p = max(e64p, float((ref.double() - ref64).abs().max()))
            outs, launch = B2.bind(r_, mask=m_, diag_shift=s_)
            launch()
            torch.cuda.synchronize()
            ok = ok and bool(torch.equal(outs, out))
            launchers.append(launch)
        ok = ok and worst <= TOL_PATH

        def replay_c(launchers=launchers):
            for launch in launchers:
                launch()

        def replay(launches=launches):
            for r_, m_, s_ in launches:
                B2.pcr_spd_solve(r_, mask=m_, diag_shift=s_)

        cases.append(dict(case=f"{Bs}x{ns} {kind}", launches=len(launches),
                          max_rel_err=worst, err64_kernel=e64k,
                          err64_plain=e64p, ms=[], wrapper_ms=[],
                          _run=(replay_c, replay)))
    for _ in range(ROUNDS):
        for c in cases:
            replay_c, replay = c["_run"]
            c["ms"].append(time_ms(replay_c) / c["launches"])
            c["wrapper_ms"].append(time_ms(replay) / c["launches"])
    for c in cases:
        del c["_run"]
    print(json.dumps({"card": card,
                      "ptxas": ptxas_lines(build.BUILD_LOG["ptxas"] or ""),
                      "cases": cases}))
    if not ok:
        sys.exit("B2 disagrees with its plain version")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose package is timed")
    ap.add_argument("--edges", action="store_true",
                    help="float64: each layout's error at the layouts' edges")
    a = ap.parse_args()
    REPO = os.path.abspath(a.repo)
    sys.path.insert(0, REPO)
    main(a.dtype, a.edges)
