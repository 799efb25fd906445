#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (proxtv_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (each failure ends the run with a non-zero exit and no result line):

1. build the three hand-written kernels from ``proxtv_tpu_torch/csrc`` and
   print the card (``nvidia-smi`` name and power limit) and the build time;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with the tolerances in ``TOL``;
3. drive the main path through the public entry points, counting kernel
   launches and host syncs per call: ``api.tv1_2d`` at 1024^2, lam 0.3 (auto
   -> PDHG, kernel B3; and ``dr`` -> projected Newton, B1),
   ``tv1_batched`` on 10000 x 1000 at lam 0.7 (B1), ``api.tv1_1d`` with
   ``method="pn"`` (its Newton systems -> PCR, B2), and the image demo; then
   hold the outputs against float64 references: an independent float64
   primal-dual solve on the card for 1024^2, float64 ``tv1_pn`` on the CPU
   for the 1D calls;
4. time each kernel (CUDA events, many launches after warm-up), its plain
   version, and the main-path calls, and print the ``kernels`` line.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
card line and the ``kernels`` line come before it.  Details (the report and
the compiler's register / shared-memory lines) go to ``--out``, by default
``chip_smoke_out/``.  Imports nothing of JAX or ``proxtv_tpu``.
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Kernel-vs-plain tolerances, max |kernel - plain| (see phase 2).
TOL = {
    # PCR: relative to max|plain|.  Unmasked (DD')^-1 has condition
    # ~4n^2/pi^2 ~ 4e5 at n = 1000, so two float32 roundings of the same
    # reduction may part by ~1e-4 of the solution's size; masked and shifted
    # systems are well conditioned.
    "pcr_plain": 1e-3, "pcr_masked": 1e-5, "pcr_shifted": 1e-5,
    # The tv1_1d path's own systems at (1, 999): its Newton masks leave long
    # inactive runs, conditioned like the unmasked system.
    "pcr_path": 1e-3,
    # PN: absolute, in data units (y ~ N(0, 1)): both stop on the same
    # relative duality gap, the JAX kernel test's oracle bar is 1e-3.
    "pn": 2e-3,
    # PDHG chunk: absolute on the K-step state; certificate sums relative.
    "pdhg": 1e-4, "pdhg_cert": 1e-4,
}

# The cross-method bar of tests/test_tv2d.py:64-77: the solution within
# atol 1e-3.  Its objective form: F(x) - F* <= 0.5 (1e-3)^2 M N bounds the
# RMS error by 1e-3 (F is 1-strongly convex).
XBAR = 1e-3
# float32 rounding of the 10^6 values of a 1024^2 solution moves F by about
# 1e-7 per cell; the allowance when a float32 certificate is held against a
# float64 objective.
F_ROUND = 1e-6

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, 700 W).
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12

M2D = N2D = 1024
LAM2D = 0.3
B1D, N1D = 10000, 1000
LAM1D = 0.7
SEED = 0


class Fail(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=None, target_s=0.5, max_reps=200):
    """Mean milliseconds per call of ``fn`` by CUDA events, after warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    if reps is None:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        one = max(time.perf_counter() - t0, 1e-6)
        reps = int(max(1, min(max_reps, target_s / one)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_call(fn):
    """One call under torch.profiler: wall time, summed device kernel time,
    the device's idle share and the five costliest kernels.  Where the
    profiler records no device time the shares read "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per = {}
    n = 0
    for e in prof.events():  # device-side events: kernels and copies
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        per[e.name] = per.get(e.name, 0.0) + e.device_time_total / 1e3
        n += 1
    busy = sum(per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall, "busy_ms": busy, "kernels": n,
            "idle_share": (1.0 - busy / wall) if busy > 0 else "not measured",
            "top": [(k[:60], v) for k, v in top]}


def reference_2d(Y, lam, iters):
    """Independent float64 reference for the 2D TV-L1 prox: Chambolle-Pock
    Alg. 2 (gamma = 1, uncapped acceleration) in plain PyTorch on ``Y``'s
    device, sigma0 = 0.5.  Returns (xhat = Y - D'u, certified gap
    F(xhat) - F* <= gap)."""
    import torch

    def dr(X):
        return X[:, :-1] - X[:, 1:]

    def dc(X):
        return X[:-1, :] - X[1:, :]

    def drT(U):
        z = torch.zeros_like(U[:, :1])
        return torch.cat([U, z], 1) - torch.cat([z, U], 1)

    def dcT(U):
        z = torch.zeros_like(U[:1, :])
        return torch.cat([U, z], 0) - torch.cat([z, U], 0)

    sigma = 0.5
    tau = 1.0 / (8.0 * sigma)
    x = xb = Y
    u1 = Y.new_zeros((Y.shape[0], Y.shape[1] - 1))
    u2 = Y.new_zeros((Y.shape[0] - 1, Y.shape[1]))
    for _ in range(iters):
        u1 = torch.clamp(u1 + sigma * dr(xb), -lam, lam)
        u2 = torch.clamp(u2 + sigma * dc(xb), -lam, lam)
        xn = (x - tau * (drT(u1) + dcT(u2)) + tau * Y) / (1.0 + tau)
        theta = 1.0 / math.sqrt(1.0 + 2.0 * tau)
        xb = xn + theta * (xn - x)
        x = xn
        tau *= theta
        sigma /= theta
    xh = Y - (drT(u1) + dcT(u2))
    gr, gc = dr(xh), dc(xh)
    gap = (lam * (gr.abs().sum() + gc.abs().sum()) - (u1 * gr).sum()
           - (u2 * gc).sum())
    return xh, float(gap)


def bound_ms(nbytes, flops):
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_f = flops / PEAK_F32_FLOP_S * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


# Operation counts per element, read off the CUDA sources (adds, multiplies,
# divides, compares and selects counted one each; a lower bound).
PCR_OPS_PER_STEP = 18     # 2 divides, 8 multiplies, 6 adds, 2 negations
PN_OPS_PER_ITER = 100     # mask 10, PCR init 8 + 4 head steps x 13, trial 12,
                          # gradient + gap 8, bookkeeping ~10
PN_OPS_INIT = 40          # centering, dual init (2 log-shift scans), gap
PDHG_OPS_PER_STEP = 22    # two dual updates 10, divergence 3, primal 6, xbar 3


def main(out_dir):
    import torch

    if not torch.cuda.is_available():
        raise Fail("torch.cuda.is_available() is false: this script needs "
                   "a CUDA card")
    sys.path.insert(0, REPO)
    try:
        import proxtv_tpu_torch as ptv
    except ImportError as e:
        raise Fail(f"the port (proxtv_tpu_torch) is not beside this script: "
                   f"{e}")
    from proxtv_tpu_torch.demos import demo_filter_image as demo
    from proxtv_tpu_torch.models import tv2d
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.ops.kernels import build
    from proxtv_tpu_torch.ops.kernels import pcr as B2
    from proxtv_tpu_torch.ops.kernels import pdhg_fused as B3
    from proxtv_tpu_torch.ops.kernels import pn_fused as B1
    from proxtv_tpu_torch.utils import debug
    from proxtv_tpu_torch.utils.info import RC_OK
    from proxtv_tpu_torch.utils.config import CombinerConfig, DEFAULT_COMBINER

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    report = {"card": card, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    t_all = time.perf_counter()

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.build(force=True)
    build.lib()
    report["build_s"] = time.perf_counter() - t0
    print(f"[build] 3 kernels ({', '.join(build.SOURCES)}) built in "
          f"{report['build_s']:.1f} s on {card}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        f.write(build.BUILD_LOG["ptxas"])

    rng = np.random.RandomState(SEED)
    Y2 = rng.randn(M2D, N2D).astype(np.float32)          # the bench image
    Y1 = rng.randn(B1D, N1D).astype(np.float32)          # the bench batch
    y1 = (np.cumsum(rng.randn(N1D)) * 0.3)               # one 1D signal
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    errs = {"pcr": 0.0, "pn": 0.0, "pdhg": 0.0}

    # -- 2. kernels vs plain versions at main-path shapes -----------------
    d = t((0.01 * rng.randn(B1D, N1D)).astype(np.float32))
    mask = t(rng.rand(B1D, N1D) > 0.3)
    shift = t((rng.rand(B1D) + 0.5).astype(np.float32))
    for mode, kw in (("plain", {}), ("masked", {"mask": mask}),
                     ("shifted", {"diag_shift": shift})):
        ref = B2.pcr_spd_solve_plain(d, **kw)
        out = B2.pcr_spd_solve(d, **kw)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        print(f"[B2 pcr] {mode:8s} (10000, 1000): max|kernel - plain| = "
              f"{err:.3e} (scale {scale:.3e}, tol {TOL['pcr_' + mode]} x scale)")
        check(err <= TOL["pcr_" + mode] * scale, f"PCR {mode} disagrees")
        errs["pcr"] = max(errs["pcr"], err / scale)

    # B2 at the inputs the tv1_1d main path gives it, (1, 999): its dual
    # init (unmasked) and its masked Newton systems, recorded from one call.
    seen = []
    launch_b2 = B2.pcr_spd_solve

    def record(rhs, mask=None, diag_shift=None):
        seen.append((rhs.clone(), None if mask is None else mask.clone()))
        return launch_b2(rhs, mask=mask, diag_shift=diag_shift)

    B2.pcr_spd_solve = record
    try:
        ptv.tv1_1d(y1, 2.0, method="pn")
    finally:
        B2.pcr_spd_solve = launch_b2
    check(any(m is None for _, m in seen) and any(m is not None
                                                  for _, m in seen),
          "tv1_1d gave B2 no plain and no masked system")
    worst = {"plain": 0.0, "masked": 0.0}
    for rhs, m in seen:
        ref = B2.pcr_spd_solve_plain(rhs, mask=m)
        out = B2.pcr_spd_solve(rhs, mask=m)
        err = float((out - ref).abs().max()) / max(1.0,
                                                   float(ref.abs().max()))
        mode = "plain" if m is None else "masked"
        worst[mode] = max(worst[mode], err)
        check(err <= TOL["pcr_path"], f"PCR {mode} disagrees on the tv1_1d "
              f"path ({tuple(rhs.shape)}, {err})")
        errs["pcr"] = max(errs["pcr"], err)
    print(f"[B2 pcr] tv1_1d path {tuple(seen[0][0].shape)}: {len(seen)} "
          f"systems, max|kernel - plain| / scale = plain "
          f"{worst['plain']:.3e}, masked {worst['masked']:.3e} (tol "
          f"{TOL['pcr_path']})")

    def pn_case(name, y, **kw):
        ref, wref, it_ref = B1.pn_tv1_fused_plain(y, tb=1, **kw)
        x, w, it = B1.pn_tv1_fused(y, return_iters=True, **kw)
        torch.cuda.synchronize()
        err = max(float((x - ref).abs().max()), float((w - wref).abs().max()))
        print(f"[B1 pn] {name}: max|kernel - plain| = {err:.3e} (tol "
              f"{TOL['pn']}); Newton iterations kernel mean "
              f"{float(it.float().mean()):.2f}, plain mean "
              f"{float(it_ref.float().mean()):.2f}")
        check(err <= TOL["pn"], f"PN {name} disagrees")
        errs["pn"] = max(errs["pn"], err)
        return w

    Yf = t(Y2)
    w_cold = pn_case("(1024, 1024) lam 0.3 cold", Yf, lam_scalar=LAM2D)
    pn_case("(1024, 1024) lam 0.3 warm", Yf + 0.05 * torch.randn_like(Yf),
            lam_scalar=LAM2D, w_init=w_cold)
    Y1t = t(Y1)
    pn_case("(10000, 1000) lam 0.7 scalar", Y1t, lam_scalar=LAM1D)
    lam_full = torch.cat([torch.full((B1D, N1D - 1), LAM1D, device=dev)
                          * (0.5 + torch.rand((B1D, N1D - 1), device=dev)),
                          torch.zeros((B1D, 1), device=dev)], dim=1)
    pn_case("(10000, 1000) lam (B, n)", Y1t, lam_full=lam_full)

    # B3: one chunk at the 1024^2 canvas of the auto path, mid-solve.
    k, tm = tv2d.gating.pdhg2d_params()
    halo = 2 * k
    S = M2D + 8
    Mp = -(-S // tm) * tm + 2 * halo
    Np = N2D
    ypad = torch.zeros((Mp, Np), device=dev)
    ypad[halo:halo + M2D] = Yf
    sched = torch.from_numpy(B3.make_schedule(k, LAM2D, np.float32(0.5),
                                              np.float32(0.225), "cp-acc",
                                              4.0)).to(dev)
    geo = dict(k_steps=k, tm=tm, n_valid=N2D, m_valid=M2D, stride=S,
               count=1, pad_top=halo)
    st = (ypad, ypad, torch.zeros_like(ypad), torch.zeros_like(ypad))
    for _ in range(3):  # a mid-solve state: 3 chunks of the plain version
        st = B3.pdhg_chunk_plain(sched, *st, ypad, **geo)
    st = tuple(a.contiguous() for a in st)
    wr = (0.2 + 0.3 * torch.rand((Mp, Np), device=dev)).contiguous()
    wc = (0.2 + 0.3 * torch.rand((Mp, Np), device=dev)).contiguous()
    for name, kw in (("cp cert", {"cert": True}), ("cp", {}),
                     ("condat (grad_step)", {"grad_step": True}),
                     ("weighted cert", {"cert": True, "wr": wr, "wc": wc})):
        ref = B3.pdhg_chunk_plain(sched, *st, ypad, **geo, **kw)
        out = B3.pdhg_chunk(sched, *st, ypad, **geo, **kw)
        torch.cuda.synchronize()
        core = slice(halo, Mp - halo)
        err = max(float((a[core] - b[core]).abs().max())
                  for a, b in zip(out[:4], ref[:4]))
        msg = f"[B3 pdhg] {name} (1088, 1024) K={k}: max|kernel - plain| = {err:.3e}"
        check(err <= TOL["pdhg"], f"PDHG {name} disagrees ({err})")
        if kw.get("cert"):
            for a, b in zip(out[4:], ref[4:]):
                ra, rb = float(a.sum()), float(b.sum())
                rel = abs(ra - rb) / max(1.0, abs(rb))
                msg += f"; cert sum {ra:.6e} vs {rb:.6e} (rel {rel:.1e})"
                check(rel <= TOL["pdhg_cert"], f"PDHG {name} cert disagrees")
        print(msg)
        errs["pdhg"] = max(errs["pdhg"], err)

    # -- 3. main path -------------------------------------------------------
    counters = {"B1": B1.LAUNCHES, "B2": B2.LAUNCHES, "B3": B3.LAUNCHES}
    # Per main path: the kernels it launched (the demo is listed apart).
    by_path = {k_: {} for k_ in counters}
    main = {}

    def run(name, fn, must, main_path=True):
        for c in counters.values():
            c.reset()
        debug.HOST_SYNCS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = {k_: c.value for k_, c in counters.items()}
        for k_ in counters:
            if main_path and got[k_]:
                by_path[k_][name] = got[k_]
        main[name] = {"seconds": sec, "launches": got, "main_path": main_path,
                      "host_syncs": debug.HOST_SYNCS.value}
        print(f"[main] {name}: {sec:.3f} s, launches {got}, host syncs "
              f"{debug.HOST_SYNCS.value}")
        for k_ in must:
            check(got[k_] > 0, f"{name} did not launch kernel {k_}")
        return res

    def obj2d(X, Y, lam):
        X = X.astype(np.float64)
        return (0.5 * np.sum((X - Y) ** 2)
                + lam * (np.abs(np.diff(X, axis=0)).sum()
                         + np.abs(np.diff(X, axis=1)).sum()))

    x_auto, info_auto = run("api.tv1_2d 1024^2 lam 0.3 auto",
                            lambda: ptv.tv1_2d(Y2, LAM2D, return_info=True),
                            ["B3"])
    check(int(info_auto.rc[0]) == RC_OK, "auto (PDHG) did not certify")
    x_dr, info_dr = run("api.tv1_2d 1024^2 lam 0.3 dr",
                        lambda: ptv.tv1_2d(Y2, LAM2D, method="dr",
                                           return_info=True), ["B1"])
    x1 = run("tv1_batched 10000x1000 lam 0.7 pn",
             lambda: tv1d_l1.tv1_batched(Y1t, LAM1D, method="pn"), ["B1"])
    x_1d, info_1d = run("api.tv1_1d n=1000 w 2.0 pn",
                        lambda: ptv.tv1_1d(y1, 2.0, method="pn",
                                           return_info=True), ["B2"])
    check(int(info_1d.rc[0]) == RC_OK, "tv1_1d (pn) did not certify")
    demo_res = run("demo_filter_image (dr, kolmogorov, chambolle-pock-acc)",
                   demo.main, ["B1", "B3"], main_path=False)

    # Outputs: finite and shaped.
    for name, a, shp in (("auto", x_auto, (M2D, N2D)), ("dr", x_dr, (M2D, N2D)),
                         ("tv1_batched", x1.cpu().numpy(), (B1D, N1D)),
                         ("tv1_1d", x_1d, (N1D,))):
        check(a.shape == shp and np.isfinite(a).all(),
              f"{name}: bad output {a.shape}")

    # 1024^2 against an independent float64 solve on the card (its own
    # certified gap is printed).
    t0 = time.perf_counter()
    x_ref, gap_ref = reference_2d(t(Y2.astype(np.float64)), LAM2D, 24000)
    x_ref = x_ref.cpu().numpy()
    F_ref = obj2d(x_ref, Y2, LAM2D)
    fbar = 0.5 * XBAR ** 2 * M2D * N2D
    print(f"[check] float64 reference (24000 Chambolle-Pock iterations, "
          f"{time.perf_counter() - t0:.1f} s): F* >= F_ref - {gap_ref:.3e}, "
          f"F_ref = {F_ref:.6f}")
    xc = {}

    def vs_ref(name, x, info):
        F = obj2d(x, Y2, LAM2D)
        e = float(np.abs(x.astype(np.float64) - x_ref).max())
        xc[name] = {"F_minus_F_ref": F - F_ref, "max_abs_err": e,
                    "iters": int(info.iters[0]), "rc": int(info.rc[0]),
                    "gap": float(info.gap[0])}
        print(f"[check] {name}: F - F_ref = {F - F_ref:.4e}, max|x - x_ref| "
              f"= {e:.3e}, iters {int(info.iters[0])}, rc {int(info.rc[0])}")
        return F - F_ref, e

    # The main path at its default tolerances.  auto's certificate must
    # hold: F(x_auto) - F* <= gap.  dr runs the reference's 35 sweeps and
    # certifies nothing at this size; its distance is printed.
    dF, _ = vs_ref("auto (main path, relative gap 1e-5)", x_auto, info_auto)
    gap_auto = float(info_auto.gap[0])
    check(dF <= gap_auto + gap_ref + F_ROUND * F_ref,
          f"auto's certificate does not hold ({dF} > {gap_auto})")
    vs_ref("dr (main path, 35 sweeps)", x_dr, info_dr)
    # The cross-method bar, each engine run to it through the same kernels:
    # PDHG (B3) for 1000 iterations must land within XBAR of the reference;
    # dr (B1) to a mean change of 1e-7 must certify and meet the objective
    # form of the bar (its float32 fiber solves stop on a relative gap, which
    # leaves a few cells ~6e-3 off; the max is printed).
    Ydev = t(Y2)[None]
    xa, ia = tv2d._run_pdhg_fused(Ydev, LAM2D, 1000, 1e-6, DEFAULT_COMBINER,
                                  "cp-acc", gap_tol=0.0)
    _, e = vs_ref("auto engine, 1000 iterations", xa[0].cpu().numpy(), ia)
    check(e <= XBAR, f"PDHG at 1000 iterations is {e} from the float64 "
          f"reference (bar {XBAR})")
    xd, id_ = tv2d.tv1_2d_batched(Ydev, LAM2D, method="dr", max_iters=200,
                                  cfg=CombinerConfig(stop=1e-7))
    dF, _ = vs_ref("dr engine, mean change 1e-7", xd[0].cpu().numpy(), id_)
    check(int(id_.rc[0]) == RC_OK, "dr did not certify at mean change 1e-7")
    check(dF <= fbar, f"dr: F - F_ref = {dF} over the objective form of the "
          f"bar ({fbar})")

    # The 1D calls against float64 tv1_pn on the CPU.
    xs_ref, _ = tv1d_l1.tv1_pn(Y1t[:64].double().cpu(), LAM1D)
    e1 = float((x1[:64].double().cpu() - xs_ref).abs().max())
    x1d_ref, _ = tv1d_l1.tv1_pn(torch.from_numpy(y1)[None], 2.0)
    e2 = float(np.abs(x_1d - x1d_ref[0].numpy()).max())
    print(f"[check] vs float64 tv1_pn on the CPU: tv1_batched (64 rows) "
          f"max|diff| = {e1:.3e}, tv1_1d max|diff| = {e2:.3e} (tol "
          f"{TOL['pn']})")
    check(e1 <= TOL["pn"], "tv1_batched disagrees with float64 tv1_pn")
    check(e2 <= TOL["pn"], "tv1_1d disagrees with float64 tv1_pn")
    for m_, (mse0, mse1) in demo_res.items():
        check(mse1 < mse0, f"demo {m_} did not denoise")

    # -- 4. times -----------------------------------------------------------
    # Whole calls, numpy in and out (CUDA events around host-synchronous
    # calls: wall time on the card's clock).
    times = {"tv1_2d_auto_ms": cuda_ms(lambda: ptv.tv1_2d(Y2, LAM2D), reps=3)}
    times["tv1_2d_auto_mpx_s"] = (M2D * N2D / 1e6
                                  / (times["tv1_2d_auto_ms"] / 1e3))
    times["tv1_2d_dr_ms"] = cuda_ms(
        lambda: ptv.tv1_2d(Y2, LAM2D, method="dr"), reps=1)
    times["tv1_2d_dr_mpx_s"] = M2D * N2D / 1e6 / (times["tv1_2d_dr_ms"] / 1e3)
    times["tv1_batched_ms"] = cuda_ms(
        lambda: tv1d_l1.tv1_batched(Y1t, LAM1D, method="pn"), reps=3)
    times["tv1_batched_signals_s"] = B1D / (times["tv1_batched_ms"] / 1e3)
    times["tv1_1d_ms"] = cuda_ms(lambda: ptv.tv1_1d(y1, 2.0, method="pn"),
                                 reps=3)
    for k_, v in times.items():
        print(f"[time] {k_} = {v:.4f}  ({card})")

    kern = []
    # B2, masked (the Newton-step system) at (10000, 1000).
    ms = cuda_ms(lambda: B2.pcr_spd_solve(d, mask=mask))
    plain_ms = cuda_ms(lambda: B2.pcr_spd_solve_plain(d, mask=mask), reps=3)
    steps = math.ceil(math.log2(N1D))
    b, f = bound_ms(B1D * N1D * (4 + 1 + 4),
                    B1D * N1D * (PCR_OPS_PER_STEP * steps + 5))
    kern.append(dict(name="B2 pcr_spd_solve (masked, 10000x1000)",
                     route="cuda", source="proxtv_tpu_torch/csrc/pcr.cu",
                     replaces="proxtv_tpu/ops/kernels/pcr.py:100",
                     launches=sum(by_path["B2"].values()),
                     launches_by_path=by_path["B2"], max_abs_err=errs["pcr"],
                     ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=f,
                     library_ms=None))
    # B1, scalar lam 0.7 at (10000, 1000) (the tv1_batched call), cold.
    _, _, its = B1.pn_tv1_fused(Y1t, lam_scalar=LAM1D, return_dual=False,
                                return_iters=True)
    it_sum = int(its.sum())
    ms = cuda_ms(lambda: B1.pn_tv1_fused(Y1t, lam_scalar=LAM1D,
                                         return_dual=False))
    plain_ms = cuda_ms(lambda: B1.pn_tv1_fused_plain(
        Y1t, lam_scalar=LAM1D, return_dual=False), reps=1)
    b, f = bound_ms(B1D * N1D * 8,
                    N1D * (it_sum * PN_OPS_PER_ITER + B1D * PN_OPS_INIT))
    kern.append(dict(name="B1 pn_tv1_fused (scalar lam, 10000x1000)",
                     route="cuda", source="proxtv_tpu_torch/csrc/pn_fused.cu",
                     replaces="proxtv_tpu/ops/kernels/pn_fused.py:329",
                     launches=sum(by_path["B1"].values()),
                     launches_by_path=by_path["B1"], max_abs_err=errs["pn"],
                     ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=f,
                     library_ms=None, newton_iters_mean=it_sum / B1D))
    # B3, one cert chunk of the 1024^2 auto path.
    ms = cuda_ms(lambda: B3.pdhg_chunk(sched, *st, ypad, **geo, cert=True))
    plain_ms = cuda_ms(lambda: B3.pdhg_chunk_plain(sched, *st, ypad, **geo,
                                                   cert=True), reps=3)
    b, f = bound_ms(Mp * Np * 4 * 9, Mp * Np * (k * PDHG_OPS_PER_STEP + 25))
    kern.append(dict(name=f"B3 pdhg_chunk (cert, K={k}, 1088x1024 canvas)",
                     route="cuda", source="proxtv_tpu_torch/csrc/pdhg_fused.cu",
                     replaces="proxtv_tpu/ops/kernels/pdhg_fused.py:307",
                     launches=sum(by_path["B3"].values()),
                     launches_by_path=by_path["B3"], max_abs_err=errs["pdhg"],
                     ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=f,
                     library_ms=None))
    for k_ in kern:
        print(f"[kernel] {k_['name']}: {k_['ms']:.4f} ms (plain "
              f"{k_['plain_ms']:.4f} ms, bound {k_['bound_ms']:.4f} ms by "
              f"{k_['bound_by']}), {k_['launches']} launches on the main "
              f"path {k_['launches_by_path']}  ({card})")

    # -- 5. where the time goes: device time by kernel, idle share -------
    breakdown = {}
    for name, fn in (("tv1_2d auto", lambda: ptv.tv1_2d(Y2, LAM2D)),
                     ("tv1_2d dr", lambda: ptv.tv1_2d(Y2, LAM2D, method="dr")),
                     ("tv1_1d pn", lambda: ptv.tv1_1d(y1, 2.0, method="pn"))):
        breakdown[name] = profile_call(fn)
        b_ = breakdown[name]
        top = ", ".join(f"{k_} {v:.3f} ms" for k_, v in b_["top"])
        print(f"[profile] {name}: wall {b_['wall_ms']:.3f} ms, device busy "
              f"{b_['busy_ms']:.3f} ms, idle share {b_['idle_share']}; "
              f"{b_['kernels']} kernel launches; top: {top}  ({card})")

    report.update(errors=errs, main_path=main, times=times, kernels=kern,
                  breakdown=breakdown,
                  tolerances=TOL, total_s=time.perf_counter() - t_all,
                  auto_iters=int(info_auto.iters[0]),
                  dr_sweeps=int(info_dr.iters[0]), cross_check=xc,
                  F_ref=F_ref, gap_ref=gap_ref)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"[done] {report['total_s']:.1f} s")
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chip_smoke_out",
                    help="directory for the detailed report")
    args = ap.parse_args()
    try:
        main(args.out)
    except Fail as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
