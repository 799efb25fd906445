#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (proxtv_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (each failure ends the run with a non-zero exit and no result line):

1. build the eight hand-written kernels from ``proxtv_tpu_torch/csrc`` (B1-B6
   for the TPU's Pallas kernels, D1 and D2 for the JAX package's XLA
   taut-string and DP scans) and print the card (``nvidia-smi`` name and
   power limit) and the build time;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with the tolerances in ``TOL`` (D1 and
   D2 in phase 4, at each of their main-path launches);
3. drive the main path through the public entry points, counting kernel
   launches and host syncs per call: ``api.tv1_2d`` at 1024^2, lam 0.3 (auto
   -> PDHG, kernel B3; and ``dr`` -> projected Newton, B1),
   ``tv1_batched`` on 10000 x 1000 at lam 0.7 (B1), ``api.tv1_1d`` with
   ``method="pn"`` (its Newton systems -> PCR, B2), the 3D volume
   32 x 256 x 256 at lam 0.3 per axis through ``api.tvgen_nd`` cp-acc (3D
   PDHG, B6) and ``api.tvgen`` (Parallel Dykstra, B1), TV-L2 through
   ``tv2_batched`` on 10000 x 1000 at lam 1.0, ``api.tv2_1d`` and
   ``api.tvp_2d`` with p = 2 at 1024^2 (More-Sorensen, B4), the 10^6-long
   TV-L2 signal (the spectral path, no kernel), TV-Lp through ``tvp_batched``
   on 512 x 1000 at lam 0.7 for p in {1.5, 3, 5}, ``api.tvp_1d`` and
   ``api.tv`` with p = 1.5, ``api.tvp_2d`` with p = 1.5 at 512^2, 35 sweeps
   (GPFW, B5; the setup solve on B2), the 10^6-long TV-Lp signal (the FW
   composition and the PCR composition, no kernel), the direct 1D engines
   through ``tv1_batched`` strict on 10000 x 1000 (taut string D1, DP D2)
   and on a per-edge-weighted 512 x 1000 batch, Condat and the classic taut
   string at 512 x 1000 (PyTorch ops, no kernel), ``api.tv1_1d`` and
   ``api.tv1w_1d`` auto on one signal of 1000 (on the card: B1, D1; no
   call gives way to the host) and with ``backend="host"`` (the native host
   engine), ``api.tv1w_1d`` with ``backend="cuda"`` (D1, D2, B2), the
   long-signal route of ``api.tv1_1d`` auto past n = 16384 on the bench's
   n = 10^6 signal at lam 0.7 and on ROADMAP C2's n = 20000 walk at lam 2.0
   (its windows in one B1 launch; no ``tv1_pn``), ``api.tv1w_2d`` dr
   at 1024^2 with seeded weight fields (B1 on weighted fibers), per-image
   lam on 4 x 512^2 with cp-acc (B3's weighted route), and the demos;
   then hold the outputs against float64 references: independent float64
   primal-dual solves on the card for 1024^2 (weighted too), the 512^2
   images and the volume, the same calls in float64 on the CPU for the 1D,
   TV-L2 and TV-Lp calls, the native host taut string in float64 for the
   10^6-long TV-L1 row, the
   KKT certificate of tests/test_tv1d_lp.py for the long TV-Lp signal;
   3b. hold B1 and B3 against their plain versions on every launch of the
   main path, with the inputs the path gave them (a tap on each wrapper
   records them);
   3c. lengths past the TPU's 8192 lanes, where the port takes the JAX
   package's route instead of raising: ``api.tv1_1d`` pn at n = 10000
   (the PCR composition), ``tv1_batched`` at 4 x 10000 and a dr sweep on
   16 x 9000 (``tv1_pn`` past B1's limit), non-strict ``tv1_batched`` at
   4 x 10000 and on the n = 10000 random walk (D1, as the JAX package runs
   its taut string there), ``api.tv1_2d`` auto on 64 x 9000
   (B3 at any width), each held against the same call in float64 on the
   CPU, and printed as one ``[C1]`` line each;
   3d. train, the differentiable path (``ops.diffprox``, ``models.layers``)
   at the bench's widths, counted and tapped with the main path: T1,
   ``TVDenoise1D`` pn on 10000 x 1000, 5 Adam steps on its penalty (B1 a
   forward); T2, ``TVDenoise2D`` dr on 1024^2, 3 gradient steps on the
   input (B1 on the dr fibers), and one chambolle-pock-acc VJP (B3).  It
   fails if a step leaves the card or its forward misses its kernel, if the
   loss does not fall, or if the backward on the card parts from the same
   backward in float64 on the CPU (on the card's forward output) by more
   than ``TOL["backward"]``; and prints, as a finding, the share of edges
   the float32 forward classifies differently from the float64 one at a
   reduced size (``[train]`` lines);
4. time each kernel (CUDA events, many launches after warm-up), its plain
   version, and the main-path calls, and print the ``kernels`` line; B1, B2,
   B4, B5, D1 and D2 at each of their main-path shapes, by replaying that
   shape's launches (B2's, B4's, B5's, D1's and D2's first held against
   their plain versions on each of them), through the wrapper and, for B2
   to B6, D1 and D2, through the C entry point;
5. profile the main-path calls: device time by kernel and the idle share;
6. run the training cells again, untapped: each step's forward and
   backward by CUDA events, its launches, host syncs and label trips, and
   one profiled step a cell.

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
    # ... and their Newton iteration counts per fiber at most 2 apart, the
    # bar of the card test test_pn_kernel_matches_plain.
    "pn_iters": 2,
    # PDHG chunk: absolute on the K-step state; certificate sums relative.
    "pdhg": 1e-4, "pdhg_cert": 1e-4,
    # MS (B4): absolute on x in data units, alpha relative.  Both stop on
    # the same secular test |‖w‖ - lam| <= 1e-5 lam, and the shifted systems
    # (DD' + alpha I) at these lam are well conditioned ((4 + alpha) /
    # alpha), so two float32 roundings (FMA contraction, sum order) part by
    # ~1e-6 of the solution.  Iteration counts are printed, not held: on
    # lam = 50 rows the small alpha leaves float32 noise in ||w|| at the stop
    # tolerance, so one rounding stops and the other runs on, up to the cap,
    # at the same x (PERF.md; ROADMAP C).
    "ms": 1e-4, "ms_alpha": 1e-4,
    # 3D PDHG chunk (B6): absolute on the K-step state (O(1) values, about
    # ten float32 roundings per cell per step, FMA contraction differs).
    "pdhg3d": 1e-5,
    # GPFW (B5), stated before its first smoke run.  Converged: the primal
    # x = y + D'w within 5e-3 absolute and its objective within 1e-5
    # relative (plus 1e-4 absolute), the bars of tests/test_kernels.py:366-
    # 368 (kernel against the XLA driver): both stop on the same Holder gap,
    # and float32 line searches part the iterates at ~1e-3 in directions the
    # objective barely sees (float32 against float64 of the plain version
    # parts w by 2.7e-3 at 64 x 1000, p = 1.5).  Fixed 3 trips (max_iters =
    # 30, both sides): the dual objective 0.5 ||D'w||^2 + y'D'w of every row
    # within 1e-6 relative (float32 against float64 of the plain version:
    # 1.2e-7; lp_fused.fixed_trips_agree).  Iteration counts and
    # multipliers are printed, not held.
    "lp": 5e-3, "lp_obj": 1e-5, "lp_obj_abs": 1e-4, "lp_fixed": 1e-6,
    # TV-L2 outputs against float64 on the CPU: the bar of
    # tests/test_kernels.py:197 (the fused MS kernel against its oracle).
    "tv2": 2e-3,
    # TV-Lp outputs against the same calls in float64 on the CPU: x within
    # the "lp" bars above; the 2D call's objective within 1e-4 relative of
    # the float64 run of the same 35 sweeps (max |dx| printed).
    "tvp_2d_obj": 1e-4,
    # D1 / D2 (the direct engines): relative to the data's size.  The kernel
    # runs the plain version's events in the same float32 roundings (no FMA
    # contraction), so the two agree bit for bit away from the degenerate
    # guards, whose means are summed in another order.  Against float64 on
    # the CPU they are held at TOL["pn"], the bar of the 1D TV-L1 outputs.
    "direct": 1e-5,
    # The differentiable path's backward on the card (float32) against the
    # same backward in float64 on the CPU, both on the card's forward
    # output: the same flat edges, so only the sums' rounding parts them
    # (float32 cumsum differences in 1D, index_add_ atomics in any order in
    # 2D).  Relative to max |gy| of the float64 run, and to |glam|.
    "backward": 1e-5,
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
L3, M3, N3 = 32, 256, 256   # the bench's 3D video (bench.py:40)
LAM3 = 0.3
LAML2 = 1.0                 # the bench's TV-L2 batch (bench.py:515)
NLONG, LAMLONG = 1_000_000, 50.0  # the bench's long TV-L2 row (bench.py:37-39)
BLP, LAMP = 512, 0.7        # the bench's TV-Lp rows (bench.py:516-524)
PS = (1.5, 3.0, 5.0)
M5 = N5 = 512               # the bench's general-norm 2D row (bench.py:54-55)
LAM2P, P2P = 0.3, 1.5
PLONG = 1.5                 # the bench's long TV-Lp row (bench.py:591-595)
BW, LAMW = 512, 1.4         # the per-edge-weighted batch: weights U[0, 1.4]
ZERO_W = 0.05               # ... with 5% of them zeroed
LAMW2D = 0.3                # tv1w_2d: weight fields 0.3 x U[0.5, 1.5]
NC2, LAMC2 = 20000, 2.0     # ROADMAP C2's walk (seed 21), past n = 16384
B_PI, M_PI = 4, 512         # per-image lam: 4 x 512^2 images
LAM_PI = (0.1, 0.2, 0.3, 0.5)
SEED = 0
# The training cells (phase 3d).  T1: TVDenoise1D on the bench's batched 1D
# row, the data of test_flax_layer_learns_lambda at 10000 x 1000 (20 blocks
# of 50 per row, noise 0.3), 5 Adam steps (lr 0.05) on raw_lam from lam
# 0.01.  T2: TVDenoise2D dr on the bench's 1024^2 image, a piecewise-
# constant truth of 64 x 64 blocks plus noise 0.3, 3 plain gradient steps
# on the input, Y -= (M N / 4) grad of the mean squared error, which is
# Y -= P (X - truth) / 2 with P the flat-component average; and one VJP
# with chambolle-pock-acc (B3) on the same image.
T1B, T1N, T1SEG, T1LAM, T1STEPS, T1LR = 10000, 1000, 50, 0.01, 5, 0.05
T2M, T2BLOCK, T2LAM, T2STEPS = 1024, 64, 0.3, 3
TNOISE = 0.3
T1SMALL, T2SMALL = 512, 256  # the flat-edge finding's reduced sizes


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
        # One PyTorch launch before the window: a window whose first launch
        # is a ctypes kernel (tv2_batched) recorded no device time without.
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
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
    ours = {}  # device ms of the port's kernels, by kernel id
    for name, ms in per.items():
        for kid, fn in KERNEL_FNS.items():
            if fn in name:
                ours[kid] = ours.get(kid, 0.0) + ms
    return {"wall_ms": wall, "busy_ms": busy, "kernels": n,
            "idle_share": (1.0 - busy / wall) if busy > 0 else "not measured",
            "top": [(k[:60], v) for k, v in top], "ours": ours}


# The __global__ functions of each kernel, as the profiler names them.
KERNEL_FNS = {"B1": "::pn_", "B2": "::pcr_kernel", "B3": "::pdhg_kernel",
              "B4": "::ms_kernel", "B5": "::gpfw_kernel",
              "B6": "::pdhg3d_march", "D1": "::tautstring_", "D2": "::dp_"}


def train_cells(ny1, tgt1, ny2, tgt2):
    """The training cells on the card, on the seeded data of phase 3d:
    {name: (description, run, make)}.

    ``make()`` builds a cell's model and data state and returns
    ``(one, final)``: ``one()`` takes one step and returns its record and
    the step's forward output; ``final()`` (None for the one-VJP cell) runs
    a forward after the last step.  A record holds the loss (before the
    step's update), the forward and backward ms by CUDA events, and per
    half the B1 and B3 launches (the wrappers' counters), the host syncs
    and the label-propagation trips.  ``run()`` takes a cell's steps and
    returns the records, the loss after the last step, the card's last
    forward output ``x`` and the cotangent ``g`` of the loss there.  Every
    step fails the run if its tensors leave the card or its forward misses
    its kernel."""
    import torch

    from proxtv_tpu_torch.models.layers import TVDenoise1D, TVDenoise2D
    from proxtv_tpu_torch.ops import diffprox
    from proxtv_tpu_torch.ops.kernels import pdhg_fused as B3
    from proxtv_tpu_torch.ops.kernels import pn_fused as B1
    from proxtv_tpu_torch.utils import debug

    def mse(x, tgt):
        return torch.mean((x - tgt) ** 2)

    def on_card(*ts):
        check(all(v.is_cuda for v in ts), "a training step left the card")

    def counts():
        return {"B1": B1.LAUNCHES.value, "B3": B3.LAUNCHES.value,
                "host_syncs": debug.HOST_SYNCS.value,
                "label_trips": diffprox.LABEL_TRIPS.value}

    def step(fwd, bwd, kid):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        c0 = counts()
        ev[0].record()
        x, loss = fwd()
        ev[1].record()
        c1 = counts()
        bwd(loss)
        ev[2].record()
        torch.cuda.synchronize()
        c2 = counts()
        rec = {"loss": float(loss.detach()),
               "fwd_ms": ev[0].elapsed_time(ev[1]),
               "bwd_ms": ev[1].elapsed_time(ev[2]),
               "fwd": {k: c1[k] - c0[k] for k in c0},
               "bwd": {k: c2[k] - c1[k] for k in c0}}
        on_card(x, loss)
        check(rec["fwd"][kid] >= 1, f"a training forward did not launch "
              f"{kid}")
        return rec, x.detach()

    def t1_make():
        layer = TVDenoise1D(init_lam=T1LAM, method="pn")
        opt = torch.optim.Adam(layer.parameters(), lr=T1LR)

        def fwd():
            x = layer(ny1)
            return x, mse(x, tgt1)

        def bwd(loss):
            opt.zero_grad()
            loss.backward()
            opt.step()
            st = opt.state[layer.raw_lam]
            on_card(layer.raw_lam, layer.raw_lam.grad, st["exp_avg"],
                    st["exp_avg_sq"])

        def one():
            rec, x = step(fwd, bwd, "B1")
            raw = layer.raw_lam.detach()
            rec["lam_after"] = float(torch.logaddexp(raw, torch.zeros_like(
                raw)))
            return rec, x

        def final():
            with torch.no_grad():
                return fwd()

        return one, final

    def t2_make(method):
        def make():
            layer = TVDenoise2D(init_lam=T2LAM, method=method)
            Y = ny2.clone().requires_grad_(True)
            lr = Y.numel() / 4

            def fwd():
                x = layer(Y)
                return x, mse(x, tgt2)

            def bwd(loss):
                (gY,) = torch.autograd.grad(loss, Y)
                on_card(gY)
                if method == "dr":
                    with torch.no_grad():
                        Y.sub_(lr * gY)

            def one():
                return step(fwd, bwd, "B1" if method == "dr" else "B3")

            def final():
                with torch.no_grad():
                    return fwd()

            return one, final if method == "dr" else None
        return make

    def runner(make, n, tgt):
        def run_cell():
            one, final = make()
            steps, x = [], None
            for _ in range(n):
                rec, x = one()
                steps.append(rec)
            loss = None
            if final is not None:
                x, loss = final()
                x, loss = x.detach(), float(loss)
            return {"steps": steps, "final_loss": loss, "x": x,
                    "g": 2 * (x - tgt) / x.numel()}
        return run_cell

    return {
        "T1": (f"TVDenoise1D pn {T1B}x{T1N}, {T1STEPS} Adam steps",
               runner(t1_make, T1STEPS, tgt1), t1_make),
        "T2": (f"TVDenoise2D dr {T2M}^2, {T2STEPS} gradient steps on the "
               "input", runner(t2_make("dr"), T2STEPS, tgt2), t2_make("dr")),
        "T2 cp-acc": (f"TVDenoise2D chambolle-pock-acc {T2M}^2, one VJP",
                      runner(t2_make("chambolle-pock-acc"), 1, tgt2),
                      t2_make("chambolle-pock-acc")),
    }


def reference_2d(Y, lam, iters):
    """Independent float64 reference for the 2D TV-L1 prox: Chambolle-Pock
    Alg. 2 (gamma = 1, uncapped acceleration) in plain PyTorch on ``Y``'s
    device, sigma0 = 0.5.  ``lam``: a scalar, or the weight fields
    ``(W_row (M, N-1), W_col (M-1, N))`` of the weighted prox.  Returns
    (xhat = Y - D'u, certified gap F(xhat) - F* <= gap)."""
    import torch

    lam_r, lam_c = lam if isinstance(lam, tuple) else (lam, lam)

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
        u1 = torch.clamp(u1 + sigma * dr(xb), -lam_r, lam_r)
        u2 = torch.clamp(u2 + sigma * dc(xb), -lam_c, lam_c)
        xn = (x - tau * (drT(u1) + dcT(u2)) + tau * Y) / (1.0 + tau)
        theta = 1.0 / math.sqrt(1.0 + 2.0 * tau)
        xb = xn + theta * (xn - x)
        x = xn
        tau *= theta
        sigma /= theta
    xh = Y - (drT(u1) + dcT(u2))
    gr, gc = dr(xh), dc(xh)
    gap = ((lam_r * gr.abs()).sum() + (lam_c * gc.abs()).sum()
           - (u1 * gr).sum() - (u2 * gc).sum())
    return xh, float(gap)


def reference_3d(V, lam, iters):
    """Independent float64 reference for the 3D TV-L1 prox (lam on each
    axis): Chambolle-Pock Alg. 2 (gamma = 1, uncapped acceleration) in plain
    PyTorch on ``V``'s device, sigma0 = 0.5, ||D||^2 <= 12.  Returns
    (xhat = V - D'u, certified gap F(xhat) - F* <= gap)."""
    import torch

    def d(X, a):
        k = X.shape[a] - 1
        return X.narrow(a, 0, k) - X.narrow(a, 1, k)

    def dT(U, a):
        z = torch.zeros_like(U.narrow(a, 0, 1))
        return torch.cat([U, z], a) - torch.cat([z, U], a)

    sigma = 0.5
    tau = 1.0 / (12.0 * sigma)
    x = xb = V
    us = [V.new_zeros(d(V, a).shape) for a in range(3)]
    for _ in range(iters):
        us = [torch.clamp(u + sigma * d(xb, a), -lam, lam)
              for a, u in enumerate(us)]
        div = dT(us[0], 0) + dT(us[1], 1) + dT(us[2], 2)
        xn = (x - tau * div + tau * V) / (1.0 + tau)
        theta = 1.0 / math.sqrt(1.0 + 2.0 * tau)
        xb = xn + theta * (xn - x)
        x = xn
        tau *= theta
        sigma /= theta
    xh = V - (dT(us[0], 0) + dT(us[1], 1) + dT(us[2], 2))
    gap = sum(lam * d(xh, a).abs().sum() - (u * d(xh, a)).sum()
              for a, u in enumerate(us))
    return xh, float(gap)


def bound_ms(nbytes, flops):
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_f = flops / PEAK_F32_FLOP_S * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


# Operation counts per element, read off the CUDA sources (adds, multiplies,
# divides, compares and selects counted one each; a lower bound).  The
# tridiagonal solves of B2 and B4 are counted as the least work of their
# function, one exact O(n) elimination (TRIDIAG_OPS: the pivot's subtract
# and reciprocal, forward add and multiply, backward multiply and add), and
# beside it as the TPU kernels' PCR does it (the *_PCR_* counts, kept in
# each row as bound_ms_pcr).
TRIDIAG_OPS = 6
PCR_OPS_PER_STEP = 18     # 2 divides, 8 multiplies, 6 adds, 2 negations
PCR_OPS_MASK = 2          # B2: the mask or the shift on the diagonal
PN_OPS_PER_ITER = 100     # mask 10, PCR init 8 + 4 head steps x 13, trial 12,
                          # gradient + gap 8, bookkeeping ~10
PN_OPS_INIT = 40          # centering, dual init (2 log-shift scans), gap
PN_OPS_INIT_WARM = 20     # centering, clamped warm dual, x, g, gap
PDHG_OPS_PER_STEP = 22    # two dual updates 10, divergence 3, primal 6, xbar 3
MS_PCR_OPS_PER_STEP = 16  # r: 2 mul 2 sub 1 div; d: 2 mul 2 sub 1 mul; b, c 6
MS_PCR_OPS_PER_SOLVE = 10  # normalization 6, norm and secant update 4
MS_OPS_PER_SOLVE = TRIDIAG_OPS + 2  # the solve, the norm's multiply and add
MS_OPS_PER_FIBER = 10     # mean 1, center 1, dy 1, x 2, g 1, g'g 2, w'g 2
PDHG3D_OPS_PER_STEP = 30  # three dual updates 15, divergence 6, primal 6,
                          # xbar 3
LP_NEWTON_ITERS, LP_FW_CYCLES = 8, 10  # the TV-Lp defaults B5 runs with
# D1 / D2: the guards' pass (sum, difference, max, weight min: 5) plus one
# advance of every point, the least work any data needs (D1: two height
# updates, two wall tests, two tightening tests, one divide and add: 10;
# D2: the message's two sums, the two exits' clip bounds with a divide,
# the push, the backward clamp: 14).  Backtracks and pops add to it.
TS_OPS_PER_POINT = 15
DP_OPS_PER_POINT = 19


def lp_pow_ops(e):
    """Operations of x^e as the function raises to it (lp_fused._spow): a
    multiply / sqrt chain for an integer or half-integer e in (0, 8], else
    powf, counted as its three steps (log, multiply, exp)."""
    if e in (0.0, 1.0):
        return 0
    if not (0.0 < e <= 8.0) or 2.0 * e != round(2.0 * e):
        return 3
    k = int(round(2.0 * e))
    m = k // 2
    ops = (max(m.bit_length() - 1, 0) + bin(m).count("1") - 1) if m else 0
    return ops + (k % 2) * (1 + (m > 0))


def lp_ops_per_trip(p, newton_iters=LP_NEWTON_ITERS, fw_cycles=LP_FW_CYCLES):
    """Operations per element of one GPFW trip, read off the plain version
    (gpfw_fused_plain; adds, multiplies, divides, compares and selects one
    each, powers by lp_pow_ops): the function's work, with each FW step's
    gradient recomputed from w, not the kernel's shortcuts.  The q-ball
    projection (start 8, per Newton step 20 or 21, clamp 5), fw_cycles - 1
    FW steps of 23, the trip's gradient and gap 10, plus their powers."""
    q = p / (p - 1.0)
    pw = lp_pow_ops
    start = 8 + pw(q)
    if q >= 2.0:
        newton = 20 + pw(q - 1.0) + pw(q - 2.0)
        init = 1
    else:
        rr = 1.0 / (q - 1.0)
        newton = 21 + pw(rr) + pw(rr - 1.0) + pw(rr * q) + pw(rr * q - 1.0)
        init = 1 + 2 * pw(q - 1.0) + pw(rr)
    clamp = 5 + pw(q)
    fw = 23 + pw(p) + pw(p - 1.0)
    gap = 10 + pw(p)
    return (start + init + newton_iters * newton + clamp
            + (fw_cycles - 1) * fw + gap)


def lp_ops_init(p):
    """Operations per element before the first trip: gradient and gap."""
    return 10 + lp_pow_ops(p)


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
    from proxtv_tpu_torch.demos import demo_filter_image_weighted as demo_w
    from proxtv_tpu_torch.demos import demo_filter_signal as demo_s
    from proxtv_tpu_torch.models import tv2d, tvnd
    from proxtv_tpu_torch.ops import diffprox, tv1d_l1, tv1d_l2, tv1d_lp
    from proxtv_tpu_torch.ops.kernels import build, gating
    from proxtv_tpu_torch.ops.kernels import dp as D2
    from proxtv_tpu_torch.ops.kernels import tautstring as D1
    from proxtv_tpu_torch.ops.kernels import lp_fused as B5
    from proxtv_tpu_torch.ops.kernels import ms_fused as B4
    from proxtv_tpu_torch.ops.kernels import pcr as B2
    from proxtv_tpu_torch.ops.kernels import pdhg3d_fused as B6
    from proxtv_tpu_torch.ops.kernels import pdhg_fused as B3
    from proxtv_tpu_torch.ops.kernels import pn_fused as B1
    from proxtv_tpu_torch.runtime import native
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
    print(f"[build] {len(build.SOURCES)} kernels ({', '.join(build.SOURCES)}) "
          f"built in "
          f"{report['build_s']:.1f} s on {card}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        f.write(build.BUILD_LOG["ptxas"])

    rng = np.random.RandomState(SEED)
    Y2 = rng.randn(M2D, N2D).astype(np.float32)          # the bench image
    Y1 = rng.randn(B1D, N1D).astype(np.float32)          # the bench batch
    y1 = (np.cumsum(rng.randn(N1D)) * 0.3)               # one 1D signal
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    rng3 = np.random.RandomState(SEED + 1)  # this slice's data
    V = rng3.randn(L3, M3, N3).astype(np.float32)        # the bench volume
    ylong = (np.cumsum(rng3.randn(NLONG)) * 0.05
             + rng3.randn(NLONG)).astype(np.float32)     # the long TV-L2 and
    # TV-L1 rows (bench.py:35-37, 302-304)
    noise1 = (0.05 * rng3.randn(B1D, N1D)).astype(np.float32)
    noise2 = (0.05 * rng3.randn(M2D, N2D)).astype(np.float32)
    rng4 = np.random.RandomState(SEED + 2)  # the TV-Lp slice's data
    Y5 = rng4.randn(M5, N5).astype(np.float32)           # the bench's Y5
    rng6 = np.random.RandomState(SEED + 4)  # the direct engines' slice

    def edge_weights(shape):
        """Seeded per-edge weights: U[0, LAMW] with ZERO_W of them zeroed."""
        w = rng6.rand(*shape) * LAMW
        w[rng6.rand(*shape) < ZERO_W] = 0.0
        return w.astype(np.float32)

    rng21 = np.random.RandomState(21)  # ROADMAP C2's instance
    yc2 = np.cumsum(rng21.randn(NC2)) * 0.3 + rng21.randn(NC2)
    Ww = edge_weights((BW, N1D - 1))                     # the weighted batch
    ww1 = edge_weights((N1D - 1,)).astype(np.float64)    # tv1w_1d's weights
    Wr2 = (LAMW2D * (0.5 + rng6.rand(M2D, N2D - 1))).astype(np.float32)
    Wc2 = (LAMW2D * (0.5 + rng6.rand(M2D - 1, N2D))).astype(np.float32)
    Ypi = rng6.randn(B_PI, M_PI, M_PI).astype(np.float32)
    rng7 = np.random.RandomState(SEED + 5)  # the training cells' data
    truth_t1 = np.repeat(rng7.randn(T1B, T1N // T1SEG), T1SEG, axis=1)
    noisy_t1 = (truth_t1 + TNOISE * rng7.randn(T1B, T1N)).astype(np.float32)
    truth_t2 = np.kron(rng7.randn(1, T2M // T2BLOCK, T2M // T2BLOCK),
                       np.ones((T2BLOCK, T2BLOCK)))
    noisy_t2 = (truth_t2 + TNOISE * rng7.randn(1, T2M, T2M)).astype(
        np.float32)
    errs = {"pcr": 0.0, "pn": 0.0, "pdhg": 0.0, "ms": 0.0, "pdhg3d": 0.0,
            "lp": 0.0, "direct": 0.0}

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

    def gap_over_tol(x, w, y, lam_full, lam_scalar, stop_rel, tol_eps):
        """Each row's duality gap over its stop tolerance (pn_solve's rule,
        with the launch's float32 floor tol_eps), in float64 from the
        outputs."""
        x, w, y = x.double(), w.double(), y.double()
        g = x[:, :-1] - x[:, 1:]
        lam = lam_full[:, :-1].double() if lam_full is not None else lam_scalar
        gap = (g.abs() * lam + w[:, :-1] * g).sum(1).abs()
        yc = y - y.mean(1, keepdim=True)
        scale = (0.5 * (yc * yc).sum(1)).clamp(min=1.0)
        eps = float(np.finfo(np.float32).eps)
        return gap / (tol_eps * eps * scale).clamp(min=stop_rel)

    def pn_compare(y, lam_full=None, w_init=None, **kw):
        """One B1 launch against its plain version (tb = 1), both with the
        launch's own settings: max |x - x_plain| and |w - w_plain|, the
        largest per-fiber difference of the Newton iteration counts, the
        kernel's and the plain version's counts, the kernel's w, and where
        the worst fiber lies: the largest difference among fibers whose
        counts agree and among those whose counts part, and the worst
        fiber's counts and gap over tolerance on each side."""
        kw = {k_: v for k_, v in kw.items()
              if k_ not in ("return_dual", "return_iters")}
        ref, wref, it_ref = B1.pn_tv1_fused_plain(y, lam_full, w_init, tb=1,
                                                  **kw)
        x, w, it = B1.pn_tv1_fused(y, lam_full, w_init, return_iters=True,
                                   **kw)
        torch.cuda.synchronize()
        fib = torch.maximum((x - ref).abs().amax(1), (w - wref).abs().amax(1))
        err = float(fib.max())
        di = int((it - it_ref).abs().max())
        part = it != it_ref
        j = int(fib.argmax())
        row = slice(j, j + 1)
        lf = None if lam_full is None else lam_full[row]
        args = (y[row], lf, kw.get("lam_scalar"), kw.get("stop_rel", 1e-6),
                kw.get("tol_eps", 10.0))
        where = {
            "err_counts_agree": float(torch.where(part, 0.0, fib).max()),
            "err_counts_part": float(torch.where(part, fib, 0.0).max()),
            "fibers_counts_part": int(part.sum()),
            "worst_iters": [int(it[j]), int(it_ref[j])],
            "worst_gap_over_tol": [float(gap_over_tol(x[row], w[row], *args)),
                                   float(gap_over_tol(ref[row], wref[row],
                                                      *args))],
        }
        return err, di, it, it_ref, w, where

    def pn_case(name, y, **kw):
        err, di, it, it_ref, w, _ = pn_compare(y, **kw)
        print(f"[B1 pn] {name}: max|kernel - plain| = {err:.3e} (tol "
              f"{TOL['pn']}); Newton iterations at most {di} apart (tol "
              f"{TOL['pn_iters']}), kernel mean "
              f"{float(it.float().mean()):.2f}, plain mean "
              f"{float(it_ref.float().mean()):.2f}")
        check(err <= TOL["pn"] and di <= TOL["pn_iters"],
              f"PN {name} disagrees")
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

    # B4 at the TV-L2 batch (10000, 1000), lam 1.0: scalar cold, per-row lam
    # with zero-penalty and large-penalty rows, warm from the cold alpha; and
    # at the fiber shape of the tvp_2d p = 2 path (1024 fibers x 1024), warm.
    def ms_compare(y, **kw):
        """B4 against its plain version on one launch's inputs: the kernel's
        outputs, max|dx|, max alpha relative error, the largest count apart
        on rows under the cap, and the kernel's and the plain rows at it."""
        cap = kw.get("max_iters", 100)
        x_r, a_r, _, it_r = B4.ms_tv2_fused_plain(y, tb=1, **kw)
        x, a, g, it = B4.ms_tv2_fused(y, **kw)
        torch.cuda.synchronize()
        ex = float((x - x_r).abs().max())
        ea = float(((a - a_r).abs() / torch.clamp(a_r.abs(), min=1.0)).max())
        capped = (it >= cap) | (it_r >= cap)
        di = int(torch.where(capped, 0, (it - it_r).abs()).max())
        return (x, a, g, it), ex, ea, di, (int((it >= cap).sum()),
                                           int((it_r >= cap).sum()))

    def ms_case(name, y, **kw):
        (x, a, g, it), ex, ea, di, at_cap = ms_compare(y, **kw)
        print(f"[B4 ms] {name}: max|kernel - plain| x {ex:.3e} (tol "
              f"{TOL['ms']}), alpha rel {ea:.3e} (tol {TOL['ms_alpha']}); "
              f"iterations at most {di} apart on the rows under the cap, "
              f"rows at the cap kernel {at_cap[0]}, plain {at_cap[1]}"
              f"; mean iterations kernel {float(it.float().mean()):.2f}")
        check(ex <= TOL["ms"] and ea <= TOL["ms_alpha"]
              and bool((g >= 0).all()),
              f"MS {name} disagrees")
        errs["ms"] = max(errs["ms"], ex)
        return a, it

    a_cold, _ = ms_case("(10000, 1000) lam 1.0 cold", Y1t, lam=LAML2)
    lam_rows = t(np.resize(np.array([0.0, 0.5, 1.0, 2.0, 50.0], np.float32),
                           B1D))
    ms_case("(10000, 1000) lam_rows in {0, 0.5, 1, 2, 50}", Y1t,
            lam_rows=lam_rows)
    ms_case("(10000, 1000) lam 1.0 warm from the cold alpha", Y1t + t(noise1),
            lam=LAML2, alpha_init=a_cold)
    _, a_img, _, _ = B4.ms_tv2_fused(Yf, lam=LAM2D)
    ms_case("(1024, 1024) lam 0.3 warm", Yf + t(noise2), lam=LAM2D,
            alpha_init=a_img)

    # B6: one chunk at the 32 x 256 x 256 canvas of the tvgen_nd path,
    # mid-solve, for each variant.
    k3, tile3 = gating.pdhg3d_params()
    Vc = t(V)
    geo3 = dict(k_steps=k3, n_valid=N3, m_valid=M3, l_valid=L3, stride=L3,
                count=1)

    def sched3(variant):
        return torch.from_numpy(B6.make_schedule3(
            k3, (LAM3,) * 3, np.float32(0.5), np.float32(0.15), variant,
            4.0)).to(dev)

    st3 = (Vc, Vc, torch.zeros_like(Vc), torch.zeros_like(Vc),
           torch.zeros_like(Vc))
    for _ in range(6):  # a mid-solve state: 6 chunks of the plain version
        st3 = B6.pdhg3d_chunk_plain(sched3("cp-acc"), *st3, Vc, **geo3)
    st3 = tuple(a.contiguous() for a in st3)
    for variant in ("cp", "cp-acc", "condat"):
        kw = dict(geo3, grad_step=variant == "condat")
        ref = B6.pdhg3d_chunk_plain(sched3(variant), *st3, Vc, **kw)
        out = B6.pdhg3d_chunk(sched3(variant), *st3, Vc, **kw)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
        print(f"[B6 pdhg3d] {variant} ({L3}, {M3}, {N3}) K={k3} tile "
              f"{tile3}: max|kernel - plain| = {err:.3e} (tol "
              f"{TOL['pdhg3d']})")
        check(err <= TOL["pdhg3d"], f"3D PDHG {variant} disagrees ({err})")
        errs["pdhg3d"] = max(errs["pdhg3d"], err)

    # B5 at the bench's TV-Lp batch (512 x 1000 randn, lam 0.7) for
    # p in {1.5, 3, 5} (p = 5 is the u-substitution branch), with the inputs
    # the gpfw driver gives it (centered rows, the projected unconstrained
    # dual), converged and for a fixed 3 trips; then at one warm-started
    # fiber pass of the 512^2 2D call, recorded from that call.
    Yp = Y1t[:BLP]

    def lp_inputs(Y, lam, p):
        yc, _, B, _, dt, lamv, _, q, w0, inter, zpen = tv1d_lp._common_setup(
            Y, lam, p)
        w_s, mu0 = tv1d_lp._start(w0, lamv, q, None, None, dt)
        return (yc.contiguous(), torch.cat([w_s, yc.new_zeros((B, 1))],
                                           1).contiguous(),
                lamv.contiguous(), mu0.contiguous(),
                (~inter & ~zpen).to(dt).contiguous())

    def lp_primal(yc, w):
        return yc + np.diff(np.concatenate([np.zeros((yc.shape[0], 1)), w],
                                           axis=1), axis=1)

    def lp_obj(x, y, lam, p):
        g = np.abs(np.diff(x, axis=1))
        return (0.5 * np.sum((x - y) ** 2, axis=1)
                + lam * np.sum(g ** p, axis=1) ** (1.0 / p))

    def lp_compare(args, p, max_iters=10 ** 6, **kw):
        """One B5 launch against its plain version (tb = 1) on its inputs:
        the primal x within TOL["lp"], its objective within TOL["lp_obj"]
        relative, and after a fixed count (max_iters < 10^6) the dual
        objective within TOL["lp_fixed"].  Returns (ok, numbers, it)."""
        w_r, mu_r, _, it_r = B5.gpfw_fused_plain(*args, p, max_iters, tb=1,
                                                 **kw)
        w, mu, g, it = B5.gpfw_fused(*args, p, max_iters, **kw)
        torch.cuda.synchronize()
        yc = args[0].double().cpu().numpy()
        lam = args[2].double().cpu().numpy()
        w, w_r = w.double().cpu().numpy(), w_r.double().cpu().numpy()
        x, x_r = lp_primal(yc, w), lp_primal(yc, w_r)
        ex = float(np.abs(x - x_r).max())
        F, F_r = lp_obj(x, yc, lam, p), lp_obj(x_r, yc, lam, p)
        ef = float(np.max(np.abs(F - F_r) / np.maximum(np.abs(F_r), 1e-30)))
        ok_f = bool(np.all(np.abs(F - F_r) <= TOL["lp_obj"] * np.abs(F_r)
                           + TOL["lp_obj_abs"]))
        em = float((torch.abs(mu.cpu() - mu_r.cpu())
                    / torch.clamp(mu_r.cpu().abs(), min=1e-30)).max())
        nums = dict(max_abs_err=ex, obj_rel=ef, mu_rel=em,
                    iters=float(it.float().mean()),
                    iters_plain=float(it_r.float().mean()))
        ok = ex <= TOL["lp"] and ok_f and bool((g >= 0).all())
        if max_iters < 10 ** 6:  # every row's dual objective
            ok_d, dnums = B5.fixed_trips_agree(args[0], args[2], p, w, it,
                                               w_r, it_r,
                                               rtol=TOL["lp_fixed"])
            ok = ok and ok_d
            nums.update(dnums)
        errs["lp"] = max(errs["lp"], ex)
        return ok, nums, it

    def lp_case(name, args, p, max_iters=10 ** 6):
        ok, nums, it = lp_compare(args, p, max_iters)
        msg = (f"[B5 gpfw] {name}: max|x - x_plain| {nums['max_abs_err']:.3e}"
               f" (tol {TOL['lp']}), objective rel {nums['obj_rel']:.3e} (tol "
               f"{TOL['lp_obj']}); mu rel {nums['mu_rel']:.3e}; mean "
               f"iterations kernel {nums['iters']:.3f}, plain "
               f"{nums['iters_plain']:.3f}")
        if "dual_rel" in nums:
            msg += (f"; dual objective rel {nums['dual_rel']:.3e} (tol "
                    f"{TOL['lp_fixed']})")
        print(msg)
        check(ok, f"GPFW {name} disagrees")
        return it

    lp_args = {}
    for p in PS:
        lp_args[p] = lp_inputs(Yp, LAMP, p)
        lp_case(f"({BLP}, {N1D}) lam {LAMP} p {p}", lp_args[p], p)
        lp_case(f"({BLP}, {N1D}) lam {LAMP} p {p}, 3 trips", lp_args[p], p,
                max_iters=30)
    seen5 = []
    launch_b5 = B5.gpfw_fused

    def record5(*a, **kw):
        seen5.append(tuple(x.clone() if torch.is_tensor(x) else x
                           for x in a) + (kw,))
        return launch_b5(*a, **kw)

    B5.gpfw_fused = record5
    try:
        ptv.tvp_2d(Y5, LAM2P, LAM2P, P2P, P2P, max_iters=2)
    finally:
        B5.gpfw_fused = launch_b5
    check(len(seen5) >= 3, "tvp_2d gave B5 no warm-started pass")
    *a5, kw5 = seen5[2]
    lp_case(f"tvp_2d {M5}^2 lam {LAM2P} p {P2P}, warm column pass "
            f"{tuple(a5[0].shape)}", tuple(a5), P2P, kw5["max_iters"])

    # D1 and D2 are held against their plain versions on the card at each
    # of their main-path launches (phase 4, TOL["direct"] of the data's
    # size): the 10000 x 1000 batch at lam 0.7, the per-edge-weighted
    # 512 x 1000 batch, tv1w_1d's one signal.
    Ywt, Wwt = t(Y1[:BW]), t(Ww)
    direct_plain = {"D1": (D1.tautstring, tv1d_l1.tv1_tautstring_plain),
                    "D2": (D2.dp, tv1d_l1.tv1_dp_plain)}

    def direct_compare(kid, y, lam):
        """One D1 / D2 launch against its plain version on the card: max
        |kernel - plain| over the data's size, the plain version's seconds."""
        kern_fn, plain_fn = direct_plain[kid]
        out = kern_fn(y, lam)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = plain_fn(y, lam)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        scale = max(1.0, float(y.abs().max()))
        return float((out - ref).abs().max()) / scale, sec

    # -- 3. main path -------------------------------------------------------
    counters = {"B1": B1.LAUNCHES, "B2": B2.LAUNCHES, "B3": B3.LAUNCHES,
                "B4": B4.LAUNCHES, "B5": B5.LAUNCHES, "B6": B6.LAUNCHES,
                "D1": D1.LAUNCHES, "D2": D2.LAUNCHES}
    # Per main path: the kernels it launched (the demo is listed apart).
    by_path = {k_: {} for k_ in counters}
    main = {}
    # B1 runs at four shapes on the main path, B4 at three, B2 at several.
    # A tap on each wrapper keeps each main-path launch's inputs, by (B, n),
    # and calls through; phase 3b holds B1 against its plain version on
    # them, phase 4 holds B2 and B4 against their own and replays all three
    # for the per-shape times.  B3's tap keeps every main-path chunk, which
    # phase 3b holds against the plain version.
    b1_calls = {}
    b2_calls = {}
    b3_calls = []
    b4_calls = {}
    b5_calls = {}
    d_calls = {"D1": {}, "D2": {}}
    tap_path = [None]
    launch_b1 = B1.pn_tv1_fused
    launch_b2 = B2.pcr_spd_solve
    launch_b3 = B3.pdhg_chunk
    launch_b4 = B4.ms_tv2_fused
    launch_b5 = B5.gpfw_fused
    launch_d = {"D1": D1.tautstring, "D2": D2.dp}

    def tap_direct(kid):
        def tap(y, lam):
            if tap_path[0] is not None:
                kind = ("scalar" if not torch.is_tensor(lam) or lam.ndim == 0
                        else "per-edge" if lam.shape[-1] == y.shape[-1] - 1
                        else "per-signal")
                d_calls[kid].setdefault((*y.shape, kind), []).append(
                    (tap_path[0], y.clone(), clone(lam)))
            return launch_d[kid](y, lam)
        return tap

    def clone(v):
        return v.clone() if torch.is_tensor(v) else v

    def tap_b2(rhs, mask=None, diag_shift=None):
        if tap_path[0] is not None:
            b2_calls.setdefault(tuple(rhs.shape), []).append(
                (tap_path[0], rhs.clone(), clone(mask), clone(diag_shift)))
        return launch_b2(rhs, mask=mask, diag_shift=diag_shift)

    def tap_b3(*a, **kw):
        if tap_path[0] is not None:
            b3_calls.append((tap_path[0], [clone(v) for v in a],
                             {k_: clone(v) for k_, v in kw.items()}))
        return launch_b3(*a, **kw)

    def tap_b4(y, **kw):
        if tap_path[0] is not None:
            b4_calls.setdefault(tuple(y.shape), []).append(
                (tap_path[0], y.clone(),  # keeps the .T of column passes
                 {k_: v.clone() if torch.is_tensor(v) else v
                  for k_, v in kw.items()}))
        return launch_b4(y, **kw)

    def tap_b5(*a, **kw):
        if tap_path[0] is not None:
            a_ = tuple(clone(v) for v in a[:5])
            kw_ = dict(zip(("p", "max_iters"), a[5:]), **kw)
            b5_calls.setdefault((*a[0].shape, float(kw_["p"])), []).append(
                (tap_path[0], a_, kw_))
        return launch_b5(*a, **kw)

    def tap_b1(y, lam_full=None, w_init=None, **kw):
        if tap_path[0] is not None:
            b1_calls.setdefault(tuple(y.shape), []).append(
                (tap_path[0], y.clone(),
                 None if lam_full is None else lam_full.clone(),
                 None if w_init is None else w_init.clone(), dict(kw)))
        return launch_b1(y, lam_full, w_init, **kw)

    def run(name, fn, must, main_path=True, host_route=False):
        for c in counters.values():
            c.reset()
        debug.HOST_SYNCS.reset()
        debug.HOST_ROUTE.reset()
        tap_path[0] = name if main_path else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        tap_path[0] = None
        got = {k_: c.value for k_, c in counters.items()}
        for k_ in counters:
            if main_path and got[k_]:
                by_path[k_][name] = got[k_]
        main[name] = {"seconds": sec, "launches": got, "main_path": main_path,
                      "host_syncs": debug.HOST_SYNCS.value,
                      "host_route": debug.HOST_ROUTE.value}
        print(f"[main] {name}: {sec:.3f} s, launches {got}, host syncs "
              f"{debug.HOST_SYNCS.value}, native host calls "
              f"{debug.HOST_ROUTE.value}")
        for k_ in must:
            check(got[k_] > 0, f"{name} did not launch kernel {k_}")
        if host_route:
            check(debug.HOST_ROUTE.value == 1 and not any(got.values()),
                  f"{name} did not take the native host route alone")
        else:
            check(debug.HOST_ROUTE.value == 0,
                  f"{name} gave way to the native host route")
        return res

    def obj2d(X, Y, lam):
        X = X.astype(np.float64)
        return (0.5 * np.sum((X - Y) ** 2)
                + lam * (np.abs(np.diff(X, axis=0)).sum()
                         + np.abs(np.diff(X, axis=1)).sum()))

    B1.pn_tv1_fused = tap_b1  # all five restored after the main path
    B2.pcr_spd_solve = tap_b2
    B3.pdhg_chunk = tap_b3
    B4.ms_tv2_fused = tap_b4
    B5.gpfw_fused = tap_b5
    D1.tautstring = tap_direct("D1")
    D2.dp = tap_direct("D2")
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
    x_3d, info_3d = run(
        "api.tvgen_nd 32x256x256 lam 0.3 chambolle-pock-acc",
        lambda: ptv.tvgen_nd(V, [LAM3] * 3, [1, 2, 3], [1.0] * 3,
                             method="chambolle-pock-acc", return_info=True),
        ["B6"])
    check(int(info_3d.rc[0]) == RC_OK, "tvgen_nd cp-acc did not certify")
    x_gen, info_gen = run(
        "api.tvgen 32x256x256 lam 0.3 (Parallel Dykstra)",
        lambda: ptv.tvgen(V, [LAM3] * 3, [1, 2, 3], [1.0] * 3,
                          return_info=True), ["B1"])
    x_l2, info_l2 = run(
        "tv2_batched 10000x1000 lam 1.0 ms",
        lambda: tv1d_l2.tv2_batched(Y1t, LAML2, method="ms"), ["B4"])
    check(main["tv2_batched 10000x1000 lam 1.0 ms"]["launches"]["B4"] == 1,
          "tv2_batched did not run in one B4 launch")
    check(bool((info_l2.rc == RC_OK).all()), "tv2_batched did not certify")
    x_t2, info_t2 = run("api.tv2_1d n=1000 w 2.0 mspg",
                        lambda: ptv.tv2_1d(y1, 2.0, return_info=True),
                        ["B4"])
    x_p2, info_p2 = run(
        "api.tvp_2d 1024^2 lam 0.3 p 2 (dr)",
        lambda: ptv.tvp_2d(Y2, LAM2D, LAM2D, 2, 2, return_info=True), ["B4"])
    x_long, info_long = run(
        "api.tv2_1d n=1e6 w 50 ms (spectral path, no kernel)",
        lambda: ptv.tv2_1d(ylong, LAMLONG, method="ms", return_info=True), [])
    check(int(info_long.rc[0]) == RC_OK, "long tv2_1d did not certify")
    xps = {}
    for p in PS:
        name = f"tvp_batched {BLP}x{N1D} lam {LAMP} p {p} gpfw"
        xps[p] = run(name, lambda p=p: tv1d_lp.tvp_batched(Yp, LAMP, p),
                     ["B5"])
        check(main[name]["launches"]["B5"] == 1,
              f"{name} did not run in one B5 launch")
        check(bool((xps[p][1].rc == RC_OK).all()), f"{name} did not certify")
    x_tp1, info_tp1 = run(f"api.tvp_1d n={N1D} w 2.0 p 1.5 gpfw",
                          lambda: ptv.tvp_1d(y1, 2.0, 1.5, return_info=True),
                          ["B2", "B5"])
    x_tvp, info_tvp = run(f"api.tv n={N1D} lam {LAMP} p 1.5",
                          lambda: ptv.tv(y1, LAMP, p=1.5, return_info=True),
                          ["B5"])
    x_2p, info_2p = run(
        f"api.tvp_2d {M5}^2 lam {LAM2P} p {P2P} (dr, 35 sweeps)",
        lambda: ptv.tvp_2d(Y5, LAM2P, LAM2P, P2P, P2P, max_iters=35,
                           return_info=True), ["B5"])
    x_lpl, info_lpl = run(
        f"tvp_gpfw n=1e6 lam {LAMLONG} p {PLONG} (FW and PCR compositions, "
        "no kernel)", lambda: tv1d_lp.tvp_gpfw(t(ylong)[None], LAMLONG, PLONG),
        [])
    check(int(info_lpl.rc[0]) == RC_OK, "long tvp_gpfw did not certify")
    # The long-signal route (tv1d_long.tv1_long): tv1_1d auto past 16384 on
    # the bench's 10^6 signal and on C2's walk.  Its windows run in one B1
    # launch; the glue certifies (one host sync), so tv1_pn never runs.
    pn_runs = [0]
    tv1_pn = tv1d_l1.tv1_pn

    def count_pn(*a, **kw):
        pn_runs[0] += 1
        return tv1_pn(*a, **kw)

    tv1d_l1.tv1_pn = count_pn
    try:
        x_l1, info_l1 = run(
            f"api.tv1_1d n=1e6 w {LAM1D} auto (long route)",
            lambda: ptv.tv1_1d(ylong, LAM1D, return_info=True), ["B1"])
        x_c2, info_c2 = run(
            f"api.tv1_1d n={NC2} w {LAMC2} auto (C2 walk, long route)",
            lambda: ptv.tv1_1d(yc2, LAMC2, return_info=True), ["B1"])
    finally:
        tv1d_l1.tv1_pn = tv1_pn
    check(pn_runs[0] == 0, "the long route ran tv1_pn")
    for name_, info_ in (("n=1e6", info_l1), ("C2", info_c2)):
        check(int(info_.rc[0]) == RC_OK, f"the long route ({name_}) did not "
              "certify")
    # The direct engines, the native host route and the weighted entry
    # points.
    x_d1 = run(f"tv1_batched {B1D}x{N1D} lam {LAM1D} hybridtautstring strict",
               lambda: tv1d_l1.tv1_batched(Y1t, LAM1D, method="hybridtautstring",
                                           strict=True), ["D1"])
    x_d2 = run(f"tv1_batched {B1D}x{N1D} lam {LAM1D} dp strict",
               lambda: tv1d_l1.tv1_batched(Y1t, LAM1D, method="dp",
                                           strict=True), ["D2"])
    x_d1w = run(f"tv1_batched {BW}x{N1D} per-edge weights tautstring strict",
                lambda: tv1d_l1.tv1_batched(Ywt, Wwt, method="tautstring",
                                            strict=True), ["D1"])
    x_d2w = run(f"tv1_batched {BW}x{N1D} per-edge weights dp strict",
                lambda: tv1d_l1.tv1_batched(Ywt, Wwt, method="dp",
                                            strict=True), ["D2"])
    Ycon = Y1t[:BW]
    x_con = run(f"tv1_batched {BW}x{N1D} lam {LAM1D} condat strict "
                "(PyTorch ops, no kernel)",
                lambda: tv1d_l1.tv1_batched(Ycon, LAM1D, method="condat",
                                            strict=True), [])
    x_cls = run(f"tv1_batched {BW}x{N1D} lam {LAM1D} classictautstring strict "
                "(PyTorch ops, no kernel)",
                lambda: tv1d_l1.tv1_batched(Ycon, LAM1D,
                                            method="classictautstring",
                                            strict=True), [])
    check(native.available(), "the native host engine is not available on "
          "the card machine")
    x_a1 = run(f"api.tv1_1d n={N1D} w 2.0 auto", lambda: ptv.tv1_1d(y1, 2.0),
               ["B1"])
    x_aw = run(f"api.tv1w_1d n={N1D} auto", lambda: ptv.tv1w_1d(y1, ww1),
               ["D1"])
    x_h1 = run(f"api.tv1_1d n={N1D} w 2.0 backend host (native host)",
               lambda: ptv.tv1_1d(y1, 2.0, backend="host"), [],
               host_route=True)
    x_hw = run(f"api.tv1w_1d n={N1D} backend host (native host)",
               lambda: ptv.tv1w_1d(y1, ww1, backend="host"), [],
               host_route=True)
    x_w1 = {}
    for m_, kid in (("tautstring", "D1"), ("dp", "D2"), ("pn", "B2")):
        x_w1[m_] = run(f"api.tv1w_1d n={N1D} {m_} backend cuda",
                       lambda m_=m_: ptv.tv1w_1d(y1, ww1, method=m_,
                                                 backend="cuda"), [kid])
    x_w2, info_w2 = run(
        f"api.tv1w_2d {M2D}^2 weights {LAMW2D} x U[0.5, 1.5] (dr)",
        lambda: ptv.tv1w_2d(Y2, Wc2, Wr2, return_info=True), ["B1"])
    x_pi, info_pi = run(
        f"tv1_2d_batched {B_PI}x{M_PI}^2 per-image lam {LAM_PI} "
        "chambolle-pock-acc",
        lambda: tv2d.tv1_2d_batched(t(Ypi), torch.tensor(LAM_PI, device=dev),
                                    method="chambolle-pock-acc"), ["B3"])
    check(bool((info_pi.rc == RC_OK).all()), "per-image cp-acc did not "
          "certify")
    # -- 3d. train: the differentiable path on the card ------------------
    # Each cell runs once here, counted and tapped like every main-path call
    # (phase 3b holds its B1 and B3 launches against their plain versions,
    # phase 4 adds them to the kernels line); phase 6 times it untapped.
    t_train = time.perf_counter()
    tgt_t1, ny_t1 = t(truth_t1.astype(np.float32)), t(noisy_t1)
    tgt_t2, ny_t2 = t(truth_t2.astype(np.float32)), t(noisy_t2)
    tcells = train_cells(ny_t1, tgt_t1, ny_t2, tgt_t2)
    train_main = {}
    for name_, must_ in (("T1", ["B1"]), ("T2", ["B1"]), ("T2 cp-acc", ["B3"])):
        label = f"train {name_}: {tcells[name_][0]}"
        diffprox.LABEL_TRIPS.reset()
        train_main[name_] = run(label, tcells[name_][1], must_)
        train_main[name_]["path"] = label
        train_main[name_]["label_trips"] = diffprox.LABEL_TRIPS.value
    t_train = time.perf_counter() - t_train
    demo_res = run("demo_filter_image (dr, kolmogorov, chambolle-pock-acc)",
                   demo.main, ["B1", "B3"], main_path=False)
    demo_s_res = run("demo_filter_signal (B1, D1, B4, B5)", demo_s.main,
                     ["B1", "D1", "B4", "B5"], main_path=False)
    demo_w_res = run("demo_filter_image_weighted (dr)", demo_w.main, ["B1"],
                     main_path=False)
    B1.pn_tv1_fused = launch_b1
    B2.pcr_spd_solve = launch_b2
    B3.pdhg_chunk = launch_b3
    B4.ms_tv2_fused = launch_b4
    B5.gpfw_fused = launch_b5
    D1.tautstring = launch_d["D1"]
    D2.dp = launch_d["D2"]

    # -- 3b. B1 against its plain version at the main path's own inputs ----
    # Every recorded launch, by shape: the 1024^2 dr fibers and the tvgen
    # fibers are warm-started from the duals of the sweeps before them.
    check(sum(len(v) for v in b1_calls.values())
          == sum(by_path["B1"].values()),
          "the B1 tap missed main-path launches")
    b1_shapes = {}
    for shp, calls in b1_calls.items():
        worst, di_max, its = 0.0, 0, []
        agree, part, n_part, worst_where = 0.0, 0.0, 0, None
        for _, y_, lf_, w0_, kw_ in calls:
            err, di, it, _, _, where = pn_compare(y_, lf_, w0_, **kw_)
            if worst_where is None or err > worst:
                worst_where = where
            worst, di_max = max(worst, err), max(di_max, di)
            agree = max(agree, where["err_counts_agree"])
            part = max(part, where["err_counts_part"])
            n_part += where["fibers_counts_part"]
            its.append(int(it.sum()))
        paths = sorted({c[0] for c in calls})
        warm = calls[-1][3] is not None
        b1_shapes[shp] = {"launches": len(calls), "paths": paths,
                          "warm": warm, "iters": its, "max_abs_err": worst,
                          "iters_apart": di_max,
                          "err_counts_agree": agree, "err_counts_part": part,
                          "fibers_counts_part": n_part,
                          "worst_iters": worst_where["worst_iters"],
                          "worst_gap_over_tol":
                              worst_where["worst_gap_over_tol"]}
        name = f"{shp[0]}x{shp[1]} {'warm' if warm else 'cold'}"
        print(f"[B1 pn] main path {name} ({len(calls)} launches, "
              f"{', '.join(paths)}): max|kernel - plain| = {worst:.3e} (tol "
              f"{TOL['pn']}); Newton iterations at most {di_max} apart (tol "
              f"{TOL['pn_iters']}), kernel mean per fiber "
              f"{sum(its) / (len(calls) * shp[0]):.2f}")
        wi, wg = worst_where["worst_iters"], worst_where["worst_gap_over_tol"]
        print(f"[B1 pn] main path {name}: fibers whose Newton counts agree "
              f"differ by at most {agree:.3e}; {n_part} of "
              f"{len(calls) * shp[0]} fibers part in count, differing by at "
              f"most {part:.3e}; worst fiber: iterations kernel {wi[0]} / "
              f"plain {wi[1]}, gap over stop tolerance kernel {wg[0]:.3f} / "
              f"plain {wg[1]:.3f}")
        check(worst <= TOL["pn"] and di_max <= TOL["pn_iters"],
              f"PN main path {name} disagrees")
        errs["pn"] = max(errs["pn"], worst)

    # -- 3b. B3 against its plain version at each main-path chunk ---------
    # The fields on the whole canvas within TOL["pdhg"], the certificate
    # sums within TOL["pdhg_cert"] relative, each chunk on its own inputs.
    check(len(b3_calls) == sum(by_path["B3"].values()),
          "the B3 tap missed main-path launches")
    b3_err = b3_rel = 0.0
    b3_worst = None  # the launch of the largest certificate difference
    for i_, (path_, a_, kw_) in enumerate(b3_calls):
        ref = B3.pdhg_chunk_plain(*a_, **kw_)
        out = B3.pdhg_chunk(*a_, **kw_)
        torch.cuda.synchronize()
        e_ = max(float((o - r_).abs().max())
                 for o, r_ in zip(out[:4], ref[:4]))
        b3_err = max(b3_err, e_)
        for which, o, r_ in zip(("gap", "objective"), out[4:], ref[4:]):
            ra, rb = float(o.sum()), float(r_.sum())
            rel_ = abs(ra - rb) / max(1.0, abs(rb))
            if rel_ > b3_rel:
                b3_worst = (path_, i_, which, ra, rb, e_)
            b3_rel = max(b3_rel, rel_)
    if b3_worst is not None:
        print(f"[B3 pdhg] main path: the largest certificate difference is "
              f"the {b3_worst[2]} sum of launch {b3_worst[1]} ({b3_worst[0]}"
              f"): kernel {b3_worst[3]:.6e}, plain {b3_worst[4]:.6e}; that "
              f"launch's fields differ by {b3_worst[5]:.3e}")
    print(f"[B3 pdhg] main path ({len(b3_calls)} launches, "
          f"{', '.join(sorted({c[0] for c in b3_calls}))}): max|kernel - "
          f"plain| = {b3_err:.3e} (tol {TOL['pdhg']}), certificate sums rel "
          f"{b3_rel:.1e} (tol {TOL['pdhg_cert']}); tv1_2d auto certified "
          f"after {int(info_auto.iters[0])} iterations "
          f"({int(info_auto.iters[0]) // k} chunks of K = {k})")
    check(b3_err <= TOL["pdhg"] and b3_rel <= TOL["pdhg_cert"],
          "PDHG main path disagrees with its plain version")
    errs["pdhg"] = max(errs["pdhg"], b3_err)

    # -- 3d. the training cells' checks (their B1 and B3 launches were held
    # above with the main path's) -----------------------------------------
    t0 = time.perf_counter()
    train_checks = {}
    for name_, r_ in train_main.items():
        check(bool(torch.isfinite(r_["x"]).all())
              and all(math.isfinite(s_["loss"]) for s_ in r_["steps"]),
              f"train {name_}: non-finite output or loss")
    for name_ in ("T1", "T2"):  # the loss falls
        losses = ([s_["loss"] for s_ in train_main[name_]["steps"]]
                  + [train_main[name_]["final_loss"]])
        print(f"[train] {name_}: loss before each step and after the last "
              f"{', '.join(f'{v:.6e}' for v in losses)}")
        check(losses[-1] < losses[0], f"train {name_}: the loss did not fall")

    def rel(a, b):
        a, b = a.double().cpu(), b.double().cpu()
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)

    def edges(x, dim):
        """The flat-edge classification of a forward output, on the CPU."""
        if dim == 1:
            return diffprox._boundaries(x)[1].cpu().reshape(-1)
        return torch.cat([e_.cpu().reshape(-1)
                          for e_ in diffprox._flat_edges(x)])

    # The backward alone: the card's float32 backward against the port's
    # float64 backward on the CPU, both on the card's forward output.
    for name_, dim in (("T1", 1), ("T2", 2), ("T2 cp-acc", 2)):
        x_, g_ = train_main[name_]["x"], train_main[name_]["g"]
        x64, g64 = x_.double().cpu(), g_.double().cpu()
        t1_ = time.perf_counter()
        if dim == 1:
            out, ref = diffprox._bwd(x_, g_, 0), diffprox._bwd(x64, g64, 0)
        else:
            out, ref = (diffprox._bwd2(x_, g_),), (diffprox._bwd2(x64, g64),)
        cpu_s = time.perf_counter() - t1_
        n_diff = int((edges(x_, dim) != edges(x64, dim)).sum())
        c_ = {"gy_rel": rel(out[0], ref[0]), "edges_differ": n_diff,
              "cpu_float64_s": cpu_s}
        if dim == 1:
            c_["glam_rel"] = rel(out[1], ref[1])
        train_checks[name_] = c_
        print(f"[train] {name_} backward on the card vs float64 on the CPU "
              f"(the card's forward output): gy rel {c_['gy_rel']:.3e}"
              + (f", glam rel {c_['glam_rel']:.3e} (card "
                 f"{float(out[1]):.6e}, float64 {float(ref[1]):.6e})"
                 if dim == 1 else "")
              + f" (tol {TOL['backward']}); edges classified differently "
              f"{n_diff}; the CPU backward {cpu_s:.2f} s")
        check(c_["gy_rel"] <= TOL["backward"]
              and c_.get("glam_rel", 0.0) <= TOL["backward"],
              f"train {name_}: the backward on the card disagrees with "
              "float64")
    # The flat-edge finding (printed, not held): at a reduced size the
    # card's float32 forward against the port's float64 forward on the
    # CPU; the share of edges classified differently, and how far gy and
    # glam (both in float64 on the CPU, one cotangent) part.
    lam_t1 = train_main["T1"]["steps"][-1]["lam_after"]
    ys1 = ny_t1[:T1SMALL]
    ys2 = ny_t2[:, :T2SMALL, :T2SMALL]
    for name_, dim, y_, tgt_, fwd_ in (
            (f"T1 {T1SMALL}x{T1N} lam {lam_t1:.6f}", 1, ys1,
             tgt_t1[:T1SMALL],
             lambda y: diffprox.tv1_prox(y, lam_t1)),
            (f"T2 {T2SMALL}^2 dr lam {T2LAM}", 2, ys2,
             tgt_t2[:, :T2SMALL, :T2SMALL],
             lambda y: diffprox.tv2d_prox(y, T2LAM, "dr"))):
        x32 = fwd_(y_)
        x64 = fwd_(y_.double().cpu())
        g64 = 2 * (x64 - tgt_.double().cpu()) / x64.numel()
        e32, e64 = edges(x32, dim), edges(x64, dim)
        share = float((e32 != e64).double().mean())
        if dim == 1:
            a_ = diffprox._bwd(x32.double().cpu(), g64, 0)
            b_ = diffprox._bwd(x64, g64, 0)
        else:
            a_ = (diffprox._bwd2(x32.double().cpu(), g64),)
            b_ = (diffprox._bwd2(x64, g64),)
        f_ = {"edges_differ_share": share, "edges": int(e64.numel()),
              "flat_edges_float64": int((~e64 if dim == 1 else e64).sum()),
              "max_abs_x": float((x32.double().cpu() - x64).abs().max()),
              "gy_rel": rel(a_[0], b_[0])}
        if dim == 1:
            f_["glam_rel"] = rel(a_[1], b_[1])
        train_checks[name_] = f_
        print(f"[train] flat edges, {name_}: float32 on the card vs float64 "
              f"on the CPU: {share:.4e} of {f_['edges']} edges classified "
              f"differently ({f_['flat_edges_float64']} flat in float64); "
              f"max|x32 - x64| {f_['max_abs_x']:.3e}; gy rel gap "
              f"{f_['gy_rel']:.3e}"
              + (f", glam rel gap {f_['glam_rel']:.3e}" if dim == 1 else "")
              + " (a finding, not a gate)")
    t_train += time.perf_counter() - t0

    # Outputs: finite and shaped.
    for name, a, shp in (("auto", x_auto, (M2D, N2D)), ("dr", x_dr, (M2D, N2D)),
                         ("tv1_batched", x1.cpu().numpy(), (B1D, N1D)),
                         ("tv1_1d", x_1d, (N1D,)),
                         ("tvgen_nd cp-acc", x_3d, (L3, M3, N3)),
                         ("tvgen", x_gen, (L3, M3, N3)),
                         ("tv2_batched", x_l2.cpu().numpy(), (B1D, N1D)),
                         ("tv2_1d", x_t2, (N1D,)), ("tvp_2d", x_p2, (M2D, N2D)),
                         ("tv2_1d long", x_long, (NLONG,)),
                         *((f"tvp_batched p {p}", xps[p][0].cpu().numpy(),
                            (BLP, N1D)) for p in PS),
                         ("tvp_1d", x_tp1, (N1D,)), ("tv p 1.5", x_tvp, (N1D,)),
                         ("tvp_2d p 1.5", x_2p, (M5, N5)),
                         ("tvp_gpfw long", x_lpl[0].cpu().numpy(), (NLONG,)),
                         ("D1 batch", x_d1.cpu().numpy(), (B1D, N1D)),
                         ("D2 batch", x_d2.cpu().numpy(), (B1D, N1D)),
                         ("D1 weighted", x_d1w.cpu().numpy(), (BW, N1D)),
                         ("D2 weighted", x_d2w.cpu().numpy(), (BW, N1D)),
                         ("condat", x_con.cpu().numpy(), (BW, N1D)),
                         ("classic", x_cls.cpu().numpy(), (BW, N1D)),
                         ("tv1_1d auto", x_a1, (N1D,)),
                         ("tv1w_1d auto", x_aw, (N1D,)),
                         ("tv1_1d host", x_h1, (N1D,)),
                         ("tv1w_1d host", x_hw, (N1D,)),
                         *((f"tv1w_1d {m_}", v, (N1D,))
                           for m_, v in x_w1.items()),
                         ("tv1w_2d", x_w2, (M2D, N2D)),
                         ("tv1_1d long", x_l1, (NLONG,)),
                         ("tv1_1d C2", x_c2, (NC2,)),
                         ("per-image", x_pi.cpu().numpy(),
                          (B_PI, M_PI, M_PI))):
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
    for m_ in ("tv1", "tv1w", "tv2", "tvp"):
        check(demo_s_res[m_][1] < demo_s_res[m_][0],
              f"demo_filter_signal {m_} did not denoise")
    check(demo_w_res["left"] < demo_w_res["noisy"]
          and demo_w_res["right"] < demo_w_res["noisy"],
          "demo_filter_image_weighted did not denoise")

    # The volume against an independent float64 solve on the card.  The
    # main path's certificate must hold; the engine run 1000 iterations must
    # land within XBAR elementwise, as the 2D check does; Parallel Dykstra
    # at the reference's 35 sweeps is printed.
    def obj3d(X, Y, lam):
        X = X.astype(np.float64)
        return (0.5 * np.sum((X - Y) ** 2)
                + lam * sum(np.abs(np.diff(X, axis=a)).sum()
                            for a in range(3)))

    t0 = time.perf_counter()
    x_ref3, gap_ref3 = reference_3d(t(V.astype(np.float64)), LAM3, 20000)
    x_ref3 = x_ref3.cpu().numpy()
    F3_ref = obj3d(x_ref3, V, LAM3)
    print(f"[check] float64 3D reference (20000 Chambolle-Pock iterations, "
          f"{time.perf_counter() - t0:.1f} s): F* >= F_ref - {gap_ref3:.3e}, "
          f"F_ref = {F3_ref:.6f}")

    def vs_ref3(name, x, info):
        F = obj3d(x, V, LAM3)
        e = float(np.abs(x.astype(np.float64) - x_ref3).max())
        xc[name] = {"F_minus_F_ref": F - F3_ref, "max_abs_err": e,
                    "iters": int(info.iters[0]), "rc": int(info.rc[0]),
                    "gap": float(info.gap[0])}
        print(f"[check] {name}: F - F_ref = {F - F3_ref:.4e}, max|x - x_ref| "
              f"= {e:.3e}, iters {int(info.iters[0])}, rc {int(info.rc[0])}, "
              f"gap {float(info.gap[0]):.4e}")
        return F - F3_ref, e

    dF, _ = vs_ref3("tvgen_nd cp-acc (main path, relative gap 1e-5)", x_3d,
                    info_3d)
    gap_3d = float(info_3d.gap[0])
    check(dF <= gap_3d + gap_ref3 + F_ROUND * F3_ref,
          f"tvgen_nd's certificate does not hold ({dF} > {gap_3d})")
    x3, i3 = tvnd._run_pdhg3d_fused(t(V)[None], (LAM3,) * 3, 1000,
                                    DEFAULT_COMBINER, "cp-acc", gap_tol=0.0)
    _, e = vs_ref3("3D engine, 1000 iterations", x3[0].cpu().numpy(), i3)
    check(e <= XBAR, f"3D PDHG at 1000 iterations is {e} from the float64 "
          f"reference (bar {XBAR})")
    vs_ref3("tvgen Parallel Dykstra (main path, 35 sweeps)", x_gen, info_gen)

    # TV-L2 against the same solves in float64 on the CPU.
    xs_ref, _ = tv1d_l2.tv2_ms(Y1t[:64].double().cpu(), LAML2)
    e_l2 = float((x_l2[:64].double().cpu() - xs_ref).abs().max())
    e_t2 = float(np.abs(x_t2 - ptv.tv2_1d(y1, 2.0, device="cpu")).max())
    t0 = time.perf_counter()
    x_p2_ref = ptv.tvp_2d(Y2.astype(np.float64), LAM2D, LAM2D, 2, 2,
                          device="cpu")
    e_p2 = float(np.abs(x_p2 - x_p2_ref).max())
    x_long_ref = ptv.tv2_1d(ylong.astype(np.float64), LAMLONG, method="ms",
                            device="cpu")
    e_long = float(np.abs(x_long - x_long_ref).max())
    print(f"[check] TV-L2 vs float64 on the CPU ({time.perf_counter() - t0:.1f}"
          f" s for the 2D and long references): tv2_batched (64 rows) "
          f"{e_l2:.3e}, tv2_1d {e_t2:.3e}, tvp_2d p=2 1024^2 {e_p2:.3e}, "
          f"tv2_1d n=1e6 {e_long:.3e} (tol {TOL['tv2']})")
    for name, e_ in (("tv2_batched", e_l2), ("tv2_1d", e_t2),
                     ("tvp_2d p=2", e_p2), ("tv2_1d n=1e6", e_long)):
        check(e_ <= TOL["tv2"], f"{name} disagrees with float64 on the CPU")
        xc[name + " vs float64 CPU"] = {"max_abs_err": e_}

    # TV-Lp against the same calls in float64 on the CPU (the CPU runs the
    # JAX package's composition route; the card ran B5).
    def vs_cpu_lp(name, x, ref, y, lam, p):
        x, ref = np.atleast_2d(x).astype(np.float64), np.atleast_2d(ref)
        y = np.atleast_2d(y).astype(np.float64)
        e = float(np.abs(x - ref).max())
        F, F_r = lp_obj(x, y, lam, p), lp_obj(ref, y, lam, p)
        ef = float(np.max(np.abs(F - F_r) / np.abs(F_r)))
        print(f"[check] {name} vs float64 on the CPU: max|dx| {e:.3e} (tol "
              f"{TOL['lp']}), objective rel {ef:.3e} (tol {TOL['lp_obj']})")
        check(e <= TOL["lp"] and bool(np.all(
            np.abs(F - F_r) <= TOL["lp_obj"] * np.abs(F_r)
            + TOL["lp_obj_abs"])), f"{name} disagrees with float64")
        xc[name + " vs float64 CPU"] = {"max_abs_err": e, "obj_rel": ef}

    Y64 = Yp[:64].double().cpu()
    for p in PS:
        ref, _ = tv1d_lp.tvp_batched(Y64, LAMP, p)
        vs_cpu_lp(f"tvp_batched p {p} (64 rows)",
                  xps[p][0][:64].cpu().numpy(), ref.numpy(), Y64.numpy(),
                  LAMP, p)
    vs_cpu_lp("api.tvp_1d p 1.5", x_tp1,
              ptv.tvp_1d(y1, 2.0, 1.5, device="cpu"), y1, 2.0, 1.5)
    vs_cpu_lp("api.tv p 1.5", x_tvp, ptv.tv(y1, LAMP, p=1.5, device="cpu"),
              y1, LAMP, 1.5)

    def obj_2dp(X, Y, lam, p):  # bench.py:_obj_2dp
        X = X.astype(np.float64)
        col = np.sum(np.sum(np.abs(np.diff(X, axis=0)) ** p, axis=0)
                     ** (1.0 / p))
        row = np.sum(np.sum(np.abs(np.diff(X, axis=1)) ** p, axis=1)
                     ** (1.0 / p))
        return 0.5 * np.sum((X - Y) ** 2) + lam * (col + row)

    t0 = time.time()
    x_2p_ref, info_2p_ref = ptv.tvp_2d(Y5.astype(np.float64), LAM2P, LAM2P,
                                       P2P, P2P, max_iters=35,
                                       return_info=True, device="cpu")
    t_2p_ref = time.time() - t0
    F_2p, F_2p_ref = obj_2dp(x_2p, Y5, LAM2P, P2P), obj_2dp(x_2p_ref, Y5,
                                                             LAM2P, P2P)
    e_2p = float(np.abs(x_2p - x_2p_ref).max())
    rel_2p = abs(F_2p - F_2p_ref) / abs(F_2p_ref)
    print(f"[check] tvp_2d p {P2P} {M5}^2 vs the float64 CPU run of the same "
          f"35-sweep call ({t_2p_ref:.1f} s; sweeps card "
          f"{int(info_2p.iters[0])}, CPU {int(info_2p_ref.iters[0])}): "
          f"objective {F_2p:.6f} vs {F_2p_ref:.6f}, rel {rel_2p:.3e} (tol "
          f"{TOL['tvp_2d_obj']}), max|dx| {e_2p:.3e}")
    check(rel_2p <= TOL["tvp_2d_obj"], "tvp_2d p 1.5 objective disagrees")
    xc["tvp_2d p 1.5 vs float64 CPU"] = {"obj_rel": rel_2p,
                                         "max_abs_err": e_2p,
                                         "cpu_s": t_2p_ref}
    # The long TV-Lp signal: its certificate (gap <= 1e-5 objective, the
    # bar of tests/test_tv1d_lp.py:121-141), and its objective against the
    # same call in float64 on the CPU.  The KKT residual of that test
    # (bar 1e-3 lam in float64 at n = 60000) is printed: in float32 at
    # n = 10^6 the stop floor 10 eps max(1, den) leaves a gap of ~0.5, and
    # the residual reads 1.07e-3 lam on the H100 (PERF.md).
    xl = x_lpl[0].double().cpu().numpy()
    yl = ylong.astype(np.float64)
    g = xl[:-1] - xl[1:]
    w = np.cumsum(xl - yl)[:-1]
    nrm = np.linalg.norm(g, PLONG)
    w_kkt = (-LAMLONG * np.sign(g) * np.abs(g) ** (PLONG - 1.0)
             / nrm ** (PLONG - 1.0))
    kkt = float(np.abs(w - w_kkt).max())
    F_l = float(0.5 * np.sum((xl - yl) ** 2) + LAMLONG * nrm)
    gap_l = float(info_lpl.gap[0])
    t0 = time.time()
    xl_ref, il_ref = tv1d_lp.tvp_gpfw(torch.from_numpy(yl)[None], LAMLONG,
                                      PLONG)
    t_l_ref = time.time() - t0
    xl_ref = xl_ref[0].numpy()
    F_l_ref = float(0.5 * np.sum((xl_ref - yl) ** 2)
                    + LAMLONG * np.linalg.norm(np.diff(xl_ref), PLONG))
    rel_l = abs(F_l - F_l_ref) / F_l_ref
    e_l = float(np.abs(xl - xl_ref).max())
    print(f"[check] tvp_gpfw n=1e6: iterations {int(info_lpl.iters[0])} "
          f"(float64 CPU {int(il_ref.iters[0])}, {t_l_ref:.1f} s), gap "
          f"{gap_l:.4e} vs 1e-5 x objective {1e-5 * F_l:.4e}; objective "
          f"rel {rel_l:.3e} to float64 (tol {TOL['lp_obj']}), max|dx| "
          f"{e_l:.3e}; KKT max|w - w_kkt| {kkt:.3e} (printed)")
    check(gap_l <= 1e-5 * F_l and rel_l <= TOL["lp_obj"],
          "long tvp_gpfw fails its certificate or its float64 objective")
    xc["tvp_gpfw n=1e6"] = {"gap": gap_l, "objective": F_l, "kkt": kkt,
                            "obj_rel": rel_l, "max_abs_err": e_l,
                            "iters": int(info_lpl.iters[0]),
                            "cpu_s": t_l_ref}

    # The direct engines against the same calls in float64 on the CPU
    # (TOL["pn"], the bar of the 1D TV-L1 outputs); auto on the card and the
    # host route's float32 result against the float64 projected Newton of
    # the tv1_1d pn row (tv1_1d) and the float64 taut string (tv1w_1d).
    t0 = time.perf_counter()
    Y1_64 = torch.from_numpy(Y1.astype(np.float64))
    Yw_64, Ww_64 = Y1_64[:BW], torch.from_numpy(Ww.astype(np.float64))
    direct_ref = {
        "D1 10000x1000": (x_d1, tv1d_l1.tv1_batched(
            Y1_64, LAM1D, method="hybridtautstring", strict=True)),
        "D2 10000x1000": (x_d2, tv1d_l1.tv1_batched(
            Y1_64, LAM1D, method="dp", strict=True)),
        "D1 512x1000 per-edge": (x_d1w, tv1d_l1.tv1_batched(
            Yw_64, Ww_64, method="tautstring", strict=True)),
        "D2 512x1000 per-edge": (x_d2w, tv1d_l1.tv1_batched(
            Yw_64, Ww_64, method="dp", strict=True)),
        "condat 512x1000": (x_con, tv1d_l1.tv1_batched(
            Yw_64, LAM1D, method="condat", strict=True)),
        "classictautstring 512x1000": (x_cls, tv1d_l1.tv1_batched(
            Yw_64, LAM1D, method="classictautstring", strict=True))}
    t_dref = time.perf_counter() - t0
    for name, (x_, ref_) in direct_ref.items():
        e_ = float((x_.double().cpu() - ref_).abs().max())
        print(f"[check] {name} vs float64 on the CPU: max|diff| = {e_:.3e} "
              f"(tol {TOL['pn']})")
        check(e_ <= TOL["pn"], f"{name} disagrees with float64 on the CPU")
        xc[name + " vs float64 CPU"] = {"max_abs_err": e_}
    print(f"[check] (the float64 CPU references took {t_dref:.1f} s)")
    e_h1 = float(np.abs(x_h1 - x1d_ref[0].numpy()).max())
    w1_ref = {m_: ptv.tv1w_1d(y1, ww1, method=m_, backend="cuda",
                              device="cpu") for m_ in x_w1}
    e_hw = float(np.abs(x_hw - w1_ref["tautstring"]).max())
    e_a1 = float(np.abs(x_a1 - x1d_ref[0].numpy()).max())
    e_aw = float(np.abs(x_aw - w1_ref["tautstring"]).max())
    print(f"[check] api.tv1_1d auto (card, B1) vs float64 tv1_pn: "
          f"{e_a1:.3e}; api.tv1w_1d auto (card, D1) vs float64 tautstring: "
          f"{e_aw:.3e} (tol {TOL['pn']})")
    check(e_a1 <= TOL["pn"] and e_aw <= TOL["pn"],
          "auto on the card disagrees with float64")
    print(f"[check] api.tv1_1d backend host ({x_h1.dtype}) vs float64 "
          f"tv1_pn: {e_h1:.3e}; api.tv1w_1d backend host vs float64 "
          f"tautstring: {e_hw:.3e} (tol {TOL['pn']})")
    check(x_h1.dtype == np.float32 and x_hw.dtype == np.float32,
          "the host route did not return the device route's dtype")
    check(e_h1 <= TOL["pn"] and e_hw <= TOL["pn"],
          "the host route disagrees with float64")
    xc["tv1_1d auto card vs float64 pn"] = {"max_abs_err": e_a1}
    xc["tv1w_1d auto card vs float64 tautstring"] = {"max_abs_err": e_aw}
    xc["tv1_1d host vs float64 pn"] = {"max_abs_err": e_h1}
    xc["tv1w_1d host vs float64 tautstring"] = {"max_abs_err": e_hw}
    for m_, x_ in x_w1.items():
        e_ = float(np.abs(x_ - w1_ref[m_]).max())
        print(f"[check] api.tv1w_1d {m_} (card) vs float64 on the CPU: "
              f"{e_:.3e} (tol {TOL['pn']})")
        check(e_ <= TOL["pn"], f"tv1w_1d {m_} disagrees with float64")
        xc[f"tv1w_1d {m_} vs float64 CPU"] = {"max_abs_err": e_}
    # The long route: the 10^6 row against the native host taut string in
    # float64, the C2 walk against the same call in float64 on the CPU
    # (tv1_long there too), both at TOL["pn"] with rc 0.
    t0 = time.perf_counter()
    xl1_ref = native.tv1_host(ylong.astype(np.float64), LAM1D)
    t_host = time.perf_counter() - t0
    x_c2_ref, info_c2_ref = ptv.tv1_1d(yc2, LAMC2, return_info=True,
                                       device="cpu")
    for name_, x_, ref_, info_ in (
            ("tv1_1d n=1e6 long route vs float64 host taut string", x_l1,
             xl1_ref, info_l1),
            ("tv1_1d C2 walk n=20000 long route vs float64 CPU", x_c2,
             x_c2_ref, info_c2)):
        e_ = float(np.abs(x_.astype(np.float64) - ref_).max())
        print(f"[long] {name_}: max|diff| = {e_:.3e} (tol {TOL['pn']}), "
              f"iters {int(info_.iters[0])}, gap {float(info_.gap[0]):.4e}, "
              f"rc {int(info_.rc[0])}")
        check(e_ <= TOL["pn"], f"{name_} disagrees")
        xc[name_] = {"max_abs_err": e_, "iters": int(info_.iters[0]),
                     "gap": float(info_.gap[0]), "rc": int(info_.rc[0])}
    print(f"[long] (the float64 host taut string at n = 10^6 took "
          f"{t_host * 1e3:.1f} ms; C2 float64 CPU rc "
          f"{int(info_c2_ref.rc[0])})")

    # tv1w_2d at 1024^2 against an independent float64 weighted solve on
    # the card.  dr certifies nothing: its 35 main-path sweeps are printed,
    # and the engine run to a mean change of 1e-7 must meet the objective
    # form of the cross-method bar (fbar) above the reference's own gap.
    # Per-image lam (cp-acc, B3's weighted route): each image's certificate
    # against a float64 solve of that image at its lam.
    def obj2dw(X, Y, Wr, Wc):
        X = X.astype(np.float64)
        return (0.5 * np.sum((X - Y) ** 2)
                + np.sum(Wc * np.abs(np.diff(X, axis=0)))
                + np.sum(Wr * np.abs(np.diff(X, axis=1))))

    t0 = time.perf_counter()
    Wr2_64, Wc2_64 = Wr2.astype(np.float64), Wc2.astype(np.float64)
    xw_ref, gapw_ref = reference_2d(t(Y2.astype(np.float64)),
                                    (t(Wr2_64), t(Wc2_64)), 24000)
    xw_ref = xw_ref.cpu().numpy()
    Fw_ref = obj2dw(xw_ref, Y2, Wr2_64, Wc2_64)
    print(f"[check] float64 weighted reference (24000 Chambolle-Pock "
          f"iterations, {time.perf_counter() - t0:.1f} s): F* >= F_ref - "
          f"{gapw_ref:.3e}, F_ref = {Fw_ref:.6f}")
    dFw = obj2dw(x_w2, Y2, Wr2_64, Wc2_64) - Fw_ref
    print(f"[check] api.tv1w_2d dr (main path, {int(info_w2.iters[0])} "
          f"sweeps): F - F_ref = {dFw:.4e} (printed), max|x - x_ref| = "
          f"{float(np.abs(x_w2 - xw_ref).max()):.3e}")
    xc["tv1w_2d dr main path"] = {"F_minus_F_ref": dFw,
                                  "iters": int(info_w2.iters[0])}
    xwd, iwd = tv2d.tv1w_2d_batched(t(Y2)[None], t(Wc2)[None], t(Wr2)[None],
                                    max_iters=200,
                                    cfg=CombinerConfig(stop=1e-7))
    dFw = obj2dw(xwd[0].cpu().numpy(), Y2, Wr2_64, Wc2_64) - Fw_ref
    print(f"[check] tv1w_2d dr engine, mean change 1e-7 "
          f"({int(iwd.iters[0])} sweeps, rc {int(iwd.rc[0])}): F - F_ref = "
          f"{dFw:.4e} (bar {fbar:.4e} + {gapw_ref:.3e} + "
          f"{F_ROUND * Fw_ref:.3e})")
    check(int(iwd.rc[0]) == RC_OK and dFw <= fbar + gapw_ref
          + F_ROUND * Fw_ref, "weighted dr misses its bar")
    xc["tv1w_2d dr mean change 1e-7"] = {"F_minus_F_ref": dFw,
                                         "iters": int(iwd.iters[0])}
    xpi = x_pi.cpu().numpy()
    for b_, lam_ in enumerate(LAM_PI):
        xr_, gr_ = reference_2d(t(Ypi[b_].astype(np.float64)), lam_, 12000)
        xr_ = xr_.cpu().numpy()
        Fr_ = obj2d(xr_, Ypi[b_], lam_)
        dF_ = obj2d(xpi[b_], Ypi[b_], lam_) - Fr_
        g_ = float(info_pi.gap[b_])
        print(f"[check] per-image cp-acc image {b_} lam {lam_}: F - F_ref = "
              f"{dF_:.4e} (bar: gap {g_:.4e} + {gr_:.3e} + "
              f"{F_ROUND * Fr_:.3e}), iters {int(info_pi.iters[b_])}")
        check(dF_ <= g_ + gr_ + F_ROUND * Fr_,
              f"per-image image {b_} misses its certificate")
        xc[f"per-image cp-acc image {b_}"] = {"F_minus_F_ref": dF_,
                                              "gap": g_}

    # -- 3c. past the TPU's lane limits (ROADMAP C1) -----------------------
    # Each instance on the card against the same call in float64 on the
    # CPU, at the bars the port already uses: 2e-3 on 1D TV-L1 outputs (the
    # dr sweep's too: its fibers are 1D TV-L1 solves); tv1_2d auto by the
    # certified-gap rule above against float64 chambolle-pock-acc, and its
    # first chunk against B3's plain version (TOL["pdhg"]).
    # tv1_1d at n = 10000 is also held by the certified-gap rule against
    # float64.  The card test's instance (seed 21) parts from float64 by
    # more than TOL["pn"]: the reference's float32 stop floor, 2 eps
    # 0.5||y - mean||^2, lets the solve stop early (ROADMAP C), and the JAX
    # package's float32 tv1_pn does the same.  So that instance is held
    # within TOL["pn"] of the JAX package's float32 result on its input
    # (tests/data, kept true by tests/test_torch_pn.py), its distance from
    # float64 printed.
    rng5 = np.random.RandomState(SEED + 3)  # this phase's data
    c1 = {}
    yc1 = np.cumsum(rng5.randn(10000)) * 0.3 + rng5.randn(10000)

    def obj1d(x, y, lam):
        x = x.astype(np.float64)
        return 0.5 * np.sum((x - y) ** 2) + lam * np.abs(np.diff(x)).sum()

    b2 = B2.LAUNCHES.value
    x_c, i_c = ptv.tv1_1d(yc1, 2.0, method="pn", return_info=True)
    check(B2.LAUNCHES.value == b2, "tv1_1d at n = 10000 launched B2")
    x_r, i_r = ptv.tv1_1d(yc1, 2.0, method="pn", return_info=True,
                          device="cpu")
    F_c, F_r = obj1d(x_c, yc1, 2.0), obj1d(x_r, yc1, 2.0)
    bar1 = float(i_c.gap[0]) + float(i_r.gap[0]) + F_ROUND * F_r
    print(f"[C1] tv1_1d pn n=10000: F - F_ref = {F_c - F_r:.4e} (bar "
          f"{bar1:.4e}: both certified gaps; card {int(i_c.iters[0])} "
          f"iterations, float64 {int(i_r.iters[0])})")
    check(F_c - F_r <= bar1, "tv1_1d at n = 10000 misses its certificate")
    c1["tv1_1d pn n=10000"] = (float(np.abs(x_c - x_r).max()), TOL["pn"],
                               int(i_c.rc[0]), int(i_r.rc[0]))
    rng21 = np.random.RandomState(21)  # the card test's instance
    y21 = np.cumsum(rng21.randn(10000)) * 0.3 + rng21.randn(10000)
    x21, i21 = ptv.tv1_1d(y21, 2.0, method="pn", return_info=True)
    x21_r, i21_r = ptv.tv1_1d(y21, 2.0, method="pn", return_info=True,
                              device="cpu")
    x21_j = np.load(os.path.join(REPO, "tests", "data",
                                 "tv1_pn_float32_walk21.npy"))
    F_c, F_r = obj1d(x21, y21, 2.0), obj1d(x21_r, y21, 2.0)
    bar21 = float(i21.gap[0]) + float(i21_r.gap[0]) + F_ROUND * F_r
    e21_j = float(np.abs(x21 - x21_j).max())
    e21 = float(np.abs(x21 - x21_r).max())
    print(f"[C1] tv1_1d pn n=10000 (seed 21): max|card - JAX float32| = "
          f"{e21_j:.3e} (tol {TOL['pn']}); F - F_ref = {F_c - F_r:.4e} (bar "
          f"{bar21:.4e}); max|card - float64| = {e21:.3e} (printed: the "
          f"float32 stop floor), rc card {int(i21.rc[0])} / float64 "
          f"{int(i21_r.rc[0])}")
    check(e21_j <= TOL["pn"] and F_c - F_r <= bar21
          and int(i21.rc[0]) in (RC_OK, int(i21_r.rc[0])),
          "tv1_1d at n = 10000 (seed 21) misses JAX float32 or its "
          "certificate")
    xc["C1 tv1_1d pn n=10000 seed 21"] = {
        "max_abs_err_jax_float32": e21_j, "max_abs_err_float64": e21,
        "rc": int(i21.rc[0]), "rc_ref": int(i21_r.rc[0])}
    Yc1 = rng5.randn(4, 10000)
    b1 = B1.LAUNCHES.value
    x_c = tv1d_l1.tv1_batched(t(Yc1.astype(np.float32)), LAM1D, method="pn")
    x_r = tv1d_l1.tv1_batched(torch.from_numpy(Yc1), LAM1D, method="pn")
    c1["tv1_batched pn 4x10000"] = (
        float((x_c.double().cpu() - x_r).abs().max()), TOL["pn"], None, None)
    check(B1.LAUNCHES.value == b1, "tv1_batched at n = 10000 launched B1")
    # Non-strict names past B1's limit run the taut string, D1, as the JAX
    # package runs its tv1_tautstring there: the same batch, and the card
    # test's random walk (|y| up to 61), against float64 on the CPU.
    d1 = D1.LAUNCHES.value
    x_c = tv1d_l1.tv1_batched(t(Yc1.astype(np.float32)), LAM1D)
    check(D1.LAUNCHES.value == d1 + 1 and B1.LAUNCHES.value == b1,
          "non-strict tv1_batched at n = 10000 did not take D1")
    x_r = tv1d_l1.tv1_batched(torch.from_numpy(Yc1), LAM1D)
    c1["tv1_batched hybridtautstring 4x10000 (D1)"] = (
        float((x_c.double().cpu() - x_r).abs().max()), TOL["pn"], None, None)
    x_c = tv1d_l1.tv1_batched(t(y21[None].astype(np.float32)), 2.0)
    check(D1.LAUNCHES.value == d1 + 2, "the walk at n = 10000 did not take D1")
    x_r = tv1d_l1.tv1_batched(torch.from_numpy(y21[None]), 2.0)
    c1["tv1_batched hybridtautstring walk n=10000 seed 21 (D1)"] = (
        float((x_c.double().cpu() - x_r).abs().max()), TOL["pn"], None, None)
    Yc2 = rng5.randn(1, 16, 9000)
    x_c, i_c = tv2d.tv1_2d_batched(t(Yc2.astype(np.float32)), LAM2D,
                                   method="dr", max_iters=1)
    x_r, i_r = tv2d.tv1_2d_batched(torch.from_numpy(Yc2), LAM2D, method="dr",
                                   max_iters=1)
    c1["tv1_2d dr one sweep 16x9000"] = (
        float((x_c.double().cpu() - x_r).abs().max()), TOL["pn"],
        int(i_c.rc[0]), int(i_r.rc[0]))
    Yc3 = rng5.randn(64, 9000)
    seen3 = []

    def tap_first_b3(*a, **kw):
        if not seen3:
            seen3.append(([clone(v) for v in a], dict(kw)))
        return launch_b3(*a, **kw)

    B3.pdhg_chunk = tap_first_b3
    try:
        x_c, i_c = ptv.tv1_2d(Yc3, LAM2D, return_info=True)
    finally:
        B3.pdhg_chunk = launch_b3
    a3, kw3 = seen3[0]
    out = B3.pdhg_chunk(*a3, **kw3)
    ref = B3.pdhg_chunk_plain(*a3, **{k_: v for k_, v in kw3.items()})
    torch.cuda.synchronize()
    e3 = max(float((o - r_).abs().max()) for o, r_ in zip(out[:4], ref[:4]))
    print(f"[C1] B3 first chunk of tv1_2d auto 64x9000 (canvas "
          f"{tuple(a3[1].shape)}): max|kernel - plain| = {e3:.3e} (tol "
          f"{TOL['pdhg']})")
    check(e3 <= TOL["pdhg"], "B3 at N = 9000 disagrees with its plain version")
    t0 = time.perf_counter()
    x_r, i_r = ptv.tv1_2d(Yc3, LAM2D, method="chambolle-pock-acc",
                          return_info=True, device="cpu")
    F_c, F_r = obj2d(x_c, Yc3, LAM2D), obj2d(x_r, Yc3, LAM2D)
    bar3 = float(i_c.gap[0]) + float(i_r.gap[0]) + F_ROUND * F_r
    c1["tv1_2d auto 64x9000"] = (float(np.abs(x_c - x_r).max()), None,
                                 int(i_c.rc[0]), int(i_r.rc[0]))
    print(f"[C1] tv1_2d auto 64x9000: F - F_ref = {F_c - F_r:.4e} (bar "
          f"{bar3:.4e}: both certified gaps), float64 CPU cp-acc "
          f"{time.perf_counter() - t0:.1f} s")
    check(F_c - F_r <= bar3, "tv1_2d auto at 64 x 9000 misses the bar")
    for name, (e_, bar, rc_c, rc_r) in c1.items():
        print(f"[C1] {name}: max|card - float64| = {e_:.3e}"
              + (f" (tol {bar})" if bar is not None else " (printed)")
              + (f", rc card {rc_c} / float64 {rc_r}" if rc_c is not None
                 else ""))
        check(bar is None or e_ <= bar, f"C1 {name} disagrees with float64")
        check(rc_c is None or rc_c in (RC_OK, rc_r),
              f"C1 {name}: rc {rc_c} (float64 {rc_r})")
        xc["C1 " + name] = {"max_abs_err": e_, "rc": rc_c, "rc_ref": rc_r}

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
    times["tvgen_nd_cp_acc_3d_ms"] = cuda_ms(
        lambda: ptv.tvgen_nd(V, [LAM3] * 3, [1, 2, 3], [1.0] * 3,
                             method="chambolle-pock-acc"), reps=3)
    times["tvgen_nd_cp_acc_3d_mvox_s"] = (
        L3 * M3 * N3 / 1e6 / (times["tvgen_nd_cp_acc_3d_ms"] / 1e3))
    times["tvgen_pd_3d_ms"] = cuda_ms(
        lambda: ptv.tvgen(V, [LAM3] * 3, [1, 2, 3], [1.0] * 3), reps=1)
    times["tv2_batched_ms"] = cuda_ms(
        lambda: tv1d_l2.tv2_batched(Y1t, LAML2, method="ms"), reps=3)
    times["tv2_batched_signals_s"] = B1D / (times["tv2_batched_ms"] / 1e3)
    times["tv2_1d_ms"] = cuda_ms(lambda: ptv.tv2_1d(y1, 2.0), reps=3)
    times["tvp_2d_p2_ms"] = cuda_ms(
        lambda: ptv.tvp_2d(Y2, LAM2D, LAM2D, 2, 2), reps=1)
    times["tvp_2d_p2_mpx_s"] = M2D * N2D / 1e6 / (times["tvp_2d_p2_ms"] / 1e3)
    times["tv2_1d_long_ms"] = cuda_ms(
        lambda: ptv.tv2_1d(ylong, LAMLONG, method="ms"), reps=3)
    for p in PS:
        times[f"tvp_batched_p{p}_ms"] = cuda_ms(
            lambda p=p: tv1d_lp.tvp_batched(Yp, LAMP, p), reps=3)
        times[f"tvp_batched_p{p}_signals_s"] = BLP / (
            times[f"tvp_batched_p{p}_ms"] / 1e3)
    times["tvp_1d_ms"] = cuda_ms(lambda: ptv.tvp_1d(y1, 2.0, 1.5), reps=3)
    times["tvp_2d_p1.5_ms"] = cuda_ms(
        lambda: ptv.tvp_2d(Y5, LAM2P, LAM2P, P2P, P2P, max_iters=35), reps=1)
    times["tvp_2d_p1.5_mpx_s"] = M5 * N5 / 1e6 / (times["tvp_2d_p1.5_ms"]
                                                  / 1e3)
    times["tvp_gpfw_long_ms"] = cuda_ms(
        lambda: tv1d_lp.tvp_gpfw(t(ylong)[None], LAMLONG, PLONG), reps=1)
    times["tv1_1d_long_ms"] = cuda_ms(lambda: ptv.tv1_1d(ylong, LAM1D),
                                      reps=3)
    times["tv1_1d_long_msamples_s"] = NLONG / 1e6 / (times["tv1_1d_long_ms"]
                                                     / 1e3)
    times["tv1_1d_c2_ms"] = cuda_ms(lambda: ptv.tv1_1d(yc2, LAMC2), reps=3)
    times["tv1_batched_tautstring_ms"] = cuda_ms(
        lambda: tv1d_l1.tv1_batched(Y1t, LAM1D, method="hybridtautstring",
                                    strict=True), reps=3)
    times["tv1_batched_tautstring_signals_s"] = B1D / (
        times["tv1_batched_tautstring_ms"] / 1e3)
    times["tv1_batched_dp_ms"] = cuda_ms(
        lambda: tv1d_l1.tv1_batched(Y1t, LAM1D, method="dp", strict=True),
        reps=3)
    times["tv1_batched_dp_signals_s"] = B1D / (times["tv1_batched_dp_ms"]
                                               / 1e3)
    # Condat and the classic taut string (PyTorch ops): the one main-path
    # call each, host clock around a synchronised call.
    for m_, nm_ in (("condat", "condat"), ("classic", "classictautstring")):
        times[f"tv1_batched_{m_}_{BW}_ms"] = main[
            f"tv1_batched {BW}x{N1D} lam {LAM1D} {nm_} strict (PyTorch ops, "
            "no kernel)"]["seconds"] * 1e3
    times["tv1_1d_auto_ms"] = cuda_ms(lambda: ptv.tv1_1d(y1, 2.0), reps=20)
    times["tv1w_1d_auto_ms"] = cuda_ms(lambda: ptv.tv1w_1d(y1, ww1), reps=20)
    times["tv1_1d_host_ms"] = cuda_ms(
        lambda: ptv.tv1_1d(y1, 2.0, backend="host"), reps=20)
    times["tv1w_1d_host_ms"] = cuda_ms(
        lambda: ptv.tv1w_1d(y1, ww1, backend="host"), reps=20)
    for m_ in ("tautstring", "dp", "pn"):
        times[f"tv1w_1d_{m_}_cuda_ms"] = cuda_ms(
            lambda m_=m_: ptv.tv1w_1d(y1, ww1, method=m_, backend="cuda"),
            reps=3)
    times["tv1w_2d_dr_ms"] = cuda_ms(lambda: ptv.tv1w_2d(Y2, Wc2, Wr2),
                                     reps=1)
    times["tv1w_2d_dr_mpx_s"] = M2D * N2D / 1e6 / (times["tv1w_2d_dr_ms"]
                                                   / 1e3)
    Ypi_t, lpi_t = t(Ypi), torch.tensor(LAM_PI, device=dev)
    times["per_image_cp_acc_ms"] = cuda_ms(
        lambda: tv2d.tv1_2d_batched(Ypi_t, lpi_t,
                                    method="chambolle-pock-acc"), reps=1)
    for k_, v in times.items():
        print(f"[time] {k_} = {v:.4f}  ({card})")

    kern = []
    # B2 at each main-path shape (tv1_1d's dual init and Newton systems at
    # (1, 999), the TV-Lp setup solves, tvp_2d's per-sweep setups): the
    # path's own launches, held against the plain version (TOL["pcr_path"],
    # relative to the solution's size) and replayed in order.  Bytes: rhs
    # and solution, plus the mask (1 byte a cell) or the shift (one float a
    # system) where the launch has one; the bound counts one exact
    # elimination per cell (TRIDIAG_OPS, plus the mask or shift), and
    # bound_ms_pcr the TPU kernel's PCR.
    check(sum(len(v) for v in b2_calls.values())
          == sum(by_path["B2"].values()), "the B2 tap missed main-path launches")
    for shp, calls in b2_calls.items():
        Bs, ns = shp
        worst = 0.0
        for _, r_, m_, s_ in calls:
            ref = B2.pcr_spd_solve_plain(r_, mask=m_, diag_shift=s_)
            out = B2.pcr_spd_solve(r_, mask=m_, diag_shift=s_)
            worst = max(worst, float((out - ref).abs().max())
                        / max(1.0, float(ref.abs().max())))
        paths = sorted({c[0] for c in calls})
        kinds = sorted({"masked" if c[2] is not None else "shifted"
                        if c[3] is not None else "plain" for c in calls})
        print(f"[B2 pcr] main path {Bs}x{ns} ({len(calls)} launches, "
              f"{', '.join(kinds)}): max|kernel - plain| / scale = "
              f"{worst:.3e} (tol {TOL['pcr_path']})")
        check(worst <= TOL["pcr_path"], f"PCR main path {shp} disagrees")
        errs["pcr"] = max(errs["pcr"], worst)
        launchers = []
        for _, r_, m_, s_ in calls:
            out, launch = B2.bind(r_, mask=m_, diag_shift=s_)
            launch()
            torch.cuda.synchronize()
            check(bool(torch.equal(out, B2.pcr_spd_solve(
                r_, mask=m_, diag_shift=s_))),
                "B2's C entry point and its wrapper disagree")
            launchers.append(launch)

        def replay(fn, calls=calls):
            for _, r_, m_, s_ in calls:
                fn(r_, mask=m_, diag_shift=s_)

        def replay_c(launchers=launchers):
            for launch in launchers:
                launch()

        ms = cuda_ms(lambda: replay(B2.pcr_spd_solve)) / len(calls)
        kernel_ms = cuda_ms(replay_c) / len(calls)
        plain_ms = cuda_ms(lambda: replay(B2.pcr_spd_solve_plain),
                           reps=3) / len(calls)
        nbytes = sum(Bs * ns * 8 + (Bs * ns if m_ is not None else 0)
                     + (Bs * 4 if s_ is not None else 0)
                     for _, _, m_, s_ in calls) / len(calls)
        extra = sum(PCR_OPS_MASK for c in calls if c[2] is not None
                    or c[3] is not None) / len(calls)
        b, f = bound_ms(nbytes, Bs * ns * (TRIDIAG_OPS + extra))
        b_pcr, f_pcr = bound_ms(nbytes, Bs * ns * (
            PCR_OPS_PER_STEP * math.ceil(math.log2(ns)) + 5))
        kern.append(dict(
            name=f"B2 pcr_spd_solve ({Bs}x{ns} {'/'.join(kinds)}, "
                 f"{', '.join(paths)})",
            route="cuda", source="proxtv_tpu_torch/csrc/pcr.cu",
            replaces="proxtv_tpu/ops/kernels/pcr.py:100",
            launches=len(calls),
            launches_by_path={p_: sum(1 for c in calls if c[0] == p_)
                              for p_ in paths},
            max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b,
            bound_by=f, library_ms=None, kernel_ms=kernel_ms,
            bound_ms_pcr=b_pcr, bound_by_pcr=f_pcr))
    # B1 at each main-path shape: the path's own launches replayed in order
    # (ms per launch); the bound from the iterations they ran.  Bytes: y and
    # x, plus w_init where the path passes a warm start, w where it asks for
    # the dual, and lam_full where the weights are a field (the long route's
    # windows, tv1w_2d's fibers).
    for shp, s in b1_shapes.items():
        calls = b1_calls[shp]

        def replay(fn, calls=calls):
            for _, y_, lf_, w0_, kw_ in calls:
                fn(y_, lf_, w0_, **kw_)

        ms = cuda_ms(lambda: replay(B1.pn_tv1_fused)) / len(calls)
        plain_ms = cuda_ms(lambda: replay(B1.pn_tv1_fused_plain),
                           reps=1) / len(calls)
        Bs, ns = shp
        per_el = sum(8 + 4 * (w0_ is not None) + 4 * (lf_ is not None)
                     + 4 * bool(kw_.get("return_dual", True))
                     for _, _, lf_, w0_, kw_ in calls) / len(calls)
        b, f = bound_ms(Bs * ns * per_el,
                        ns * (sum(s["iters"]) / len(calls) * PN_OPS_PER_ITER
                              + Bs * (PN_OPS_INIT_WARM if s["warm"]
                                      else PN_OPS_INIT)))
        kern.append(dict(
            name=f"B1 pn_tv1_fused ({Bs}x{ns} "
                 f"{'warm' if s['warm'] else 'cold'}, {', '.join(s['paths'])})",
            route="cuda", source="proxtv_tpu_torch/csrc/pn_fused.cu",
            replaces="proxtv_tpu/ops/kernels/pn_fused.py:329",
            launches=s["launches"],
            launches_by_path={p_: sum(1 for c in calls if c[0] == p_)
                              for p_ in s["paths"]},
            max_abs_err=s["max_abs_err"], ms=ms, plain_ms=plain_ms,
            bound_ms=b, bound_by=f, library_ms=None,
            newton_iters_mean=sum(s["iters"]) / (len(calls) * Bs),
            iters_apart=s["iters_apart"]))
    # B3, one cert chunk of the 1024^2 auto path (the shape of all its
    # main-path launches): ms through the wrapper, as the 2D driver calls
    # it; kernel_ms through the C entry point with its arguments made once
    # (pdhg_fused.bind, as tools/time_b3.py times it).  max_abs_err is the
    # main-path launches' (phase 3b).
    outs3, launch3 = B3.bind(sched, *st, ypad, cert=True, **{
        k_: v for k_, v in geo.items() if k_ != "tm"})
    launch3()
    ref3 = B3.pdhg_chunk(sched, *st, ypad, **geo, cert=True)
    torch.cuda.synchronize()
    check(all(bool(torch.equal(a, b)) for a, b in zip(outs3, ref3)),
          "B3's C entry point and its wrapper disagree")
    ms = cuda_ms(lambda: B3.pdhg_chunk(sched, *st, ypad, **geo, cert=True))
    kernel_ms = cuda_ms(launch3)
    plain_ms = cuda_ms(lambda: B3.pdhg_chunk_plain(sched, *st, ypad, **geo,
                                                   cert=True), reps=3)
    b, f = bound_ms(Mp * Np * 4 * 9, Mp * Np * (k * PDHG_OPS_PER_STEP + 25))
    kern.append(dict(name=f"B3 pdhg_chunk (cert, K={k}, {Mp}x{Np} canvas)",
                     route="cuda", source="proxtv_tpu_torch/csrc/pdhg_fused.cu",
                     replaces="proxtv_tpu/ops/kernels/pdhg_fused.py:307",
                     launches=sum(by_path["B3"].values()),
                     launches_by_path=by_path["B3"], max_abs_err=b3_err,
                     cert_rel_err=b3_rel, ms=ms, plain_ms=plain_ms,
                     bound_ms=b, bound_by=f, library_ms=None,
                     kernel_ms=kernel_ms))
    # B4 at each main-path shape (tv2_batched 10000x1000 cold, tvp_2d's
    # 1024x1024 fiber passes warm, tv2_1d's one fiber): the path's own
    # launches, held against the plain version on their inputs (the bars of
    # phase 3) and replayed in order.  ms times the wrapper per launch, as
    # every earlier kernels line did, with the tvp_2d column passes' .T
    # views as the path gives them; kernel_ms the C entry point, called with
    # its arguments made once (ms_fused.bind).  The bound from the solves
    # those launches ran (2 bootstrap solves plus the secant steps per
    # fiber): one exact tridiagonal solve each (MS_OPS_PER_SOLVE) plus the
    # fiber's own work; bound_ms_pcr counts the TPU kernel's PCR, as the
    # bound did before.
    for shp, calls in b4_calls.items():
        Bs, ns = shp
        launchers, solves, iters = [], 0, 0
        ex_max, ea_max, di_max, at_cap = 0.0, 0.0, 0, [0, 0]
        for _, y_, kw_ in calls:
            (x_, _, g_, it_), ex, ea, di, cap_ = ms_compare(y_, **kw_)
            ex_max, ea_max, di_max = max(ex_max, ex), max(ea_max, ea), max(
                di_max, di)
            at_cap = [at_cap[0] + cap_[0], at_cap[1] + cap_[1]]
            check(ex <= TOL["ms"] and ea <= TOL["ms_alpha"]
                  and bool((g_ >= 0).all()),
                  f"MS main path {shp} disagrees with its plain version")
            solves += int((it_ + 2).sum())
            iters += int(it_.sum())
            outs, launch = B4.bind(y_, **kw_)
            launch()
            torch.cuda.synchronize()
            check(bool(torch.equal(outs[0], x_)),
                  "B4's C entry point and its wrapper disagree")
            launchers.append(launch)
        errs["ms"] = max(errs["ms"], ex_max)
        paths = sorted({c[0] for c in calls})
        warm = calls[0][2].get("alpha_init") is not None
        name = (f"B4 ms_tv2_fused ({Bs}x{ns} {'warm' if warm else 'cold'}, "
                f"{', '.join(paths)})")
        print(f"[B4 ms] main path {Bs}x{ns} ({len(calls)} launches): "
              f"max|kernel - plain| x {ex_max:.3e} (tol {TOL['ms']}), alpha "
              f"rel {ea_max:.3e} (tol {TOL['ms_alpha']}); iterations at most "
              f"{di_max} apart on the rows under the cap, rows at the cap "
              f"kernel {at_cap[0]}, plain {at_cap[1]}")

        def replay(fn, calls=calls):
            for _, y_, kw_ in calls:
                fn(y_, **kw_)

        def replay_c(launchers=launchers):
            for launch in launchers:
                launch()

        ms = cuda_ms(lambda: replay(B4.ms_tv2_fused)) / len(calls)
        kernel_ms = cuda_ms(replay_c) / len(calls)
        plain_ms = cuda_ms(lambda: replay(B4.ms_tv2_fused_plain),
                           reps=1) / len(calls)
        per_launch = solves / len(calls)
        nbytes = Bs * ns * 8 + Bs * 4 * (3 + sum(
            calls[0][2].get(k_) is not None
            for k_ in ("lam_rows", "alpha_init")))
        b, f = bound_ms(nbytes, ns * (per_launch * MS_OPS_PER_SOLVE
                                      + Bs * MS_OPS_PER_FIBER))
        b_pcr, f_pcr = bound_ms(
            nbytes, ns * per_launch * (MS_PCR_OPS_PER_STEP
                                       * math.ceil(math.log2(ns))
                                       + MS_PCR_OPS_PER_SOLVE))
        kern.append(dict(
            name=name, route="cuda", source="proxtv_tpu_torch/csrc/ms_fused.cu",
            replaces="proxtv_tpu/ops/kernels/ms_fused.py:194",
            launches=len(calls),
            launches_by_path={p_: sum(1 for c in calls if c[0] == p_)
                              for p_ in paths},
            max_abs_err=ex_max, alpha_rel_err=ea_max, iters_apart=di_max,
            ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=f,
            library_ms=None, kernel_ms=kernel_ms, bound_ms_pcr=b_pcr,
            bound_by_pcr=f_pcr, secant_iters_mean=iters / (len(calls) * Bs)))
    check(sum(k_["launches"] for k_ in kern if k_["name"].startswith("B4 "))
          == sum(by_path["B4"].values()),
          "the B4 tap missed main-path launches")
    # B6, one cp-acc chunk of the 32 x 256 x 256 tvgen_nd path.  ms times
    # the wrapper, as the tvgen_nd driver calls it and as every earlier
    # kernels line did; the kernel (~0.05 ms) is about as short as the
    # wrapper's host work, so kernel_ms also times its C entry point called
    # with arguments made once (as tools/time_b6.py does).
    cells = L3 * M3 * N3
    sd3 = sched3("cp-acc")
    outs3 = torch.empty((5,) + tuple(Vc.shape), device=dev).unbind(0)
    args3 = ([build.ptr(sd3)] + [build.ptr(f_) for f_ in (*st3, Vc)]
             + [build.ptr(o) for o in outs3]
             + [L3, M3, N3, k3, *tile3, N3, M3, L3, L3, 1, 0, 0, 0,
                build.stream_ptr(dev)])
    lib = build.lib()
    build.check(lib.pdhg3d_chunk(*args3), "pdhg3d_chunk")
    ref3 = B6.pdhg3d_chunk(sd3, *st3, Vc, **geo3)
    torch.cuda.synchronize()
    check(all(bool(torch.equal(a, b)) for a, b in zip(outs3, ref3)),
          "B6's C entry point and its wrapper disagree")
    ms = cuda_ms(lambda: B6.pdhg3d_chunk(sd3, *st3, Vc, **geo3))
    kernel_ms = cuda_ms(lambda: lib.pdhg3d_chunk(*args3))
    plain_ms = cuda_ms(lambda: B6.pdhg3d_chunk_plain(sd3, *st3, Vc, **geo3),
                       reps=3)
    b, f = bound_ms(cells * 4 * 11, cells * k3 * PDHG3D_OPS_PER_STEP)
    kern.append(dict(name=f"B6 pdhg3d_chunk (K={k3}, tile {tile3}, "
                          f"32x256x256 canvas)",
                     route="cuda",
                     source="proxtv_tpu_torch/csrc/pdhg3d_fused.cu",
                     replaces="proxtv_tpu/ops/kernels/pdhg3d_fused.py:262",
                     launches=sum(by_path["B6"].values()),
                     launches_by_path=by_path["B6"],
                     max_abs_err=errs["pdhg3d"], ms=ms, plain_ms=plain_ms,
                     bound_ms=b, bound_by=f, library_ms=None, k_steps=k3,
                     ms_per_iter=ms / k3, kernel_ms=kernel_ms,
                     kernel_ms_per_iter=kernel_ms / k3))
    # B5 at each main-path shape and p (tvp_batched 512x1000 for p in
    # {1.5, 3, 5}, tvp_1d and tv on one row of 1000, tvp_2d p = 1.5's
    # 512x512 fiber passes): every launch held against the plain version
    # on its own inputs, run as the path ran it (x, objective) and for
    # three trips (dual objective), then the launches replayed in order.
    # ms times the wrapper per launch, kernel_ms the C entry point called
    # with its arguments made once (lp_fused.bind).  The bound from the
    # trips the path's rows ran: per element lp_ops_init before the first
    # trip and lp_ops_per_trip(p) each trip; bytes y, w0 and w, and six
    # floats a row (lam, mu0, run in; mu, gap, iters out).
    for (Bs, ns, p5), calls in b5_calls.items():
        launchers, worst, trips, per_row = [], {}, 0.0, 0.0
        for _, a_, kw_ in calls:
            for fixed in (False, True):
                kwf = (dict(kw_, max_iters=min(kw_["max_iters"],
                                               3 * LP_FW_CYCLES))
                       if fixed else kw_)
                ok5, nums, it5 = lp_compare(a_, **kwf)
                check(ok5, f"GPFW main path {Bs}x{ns} p {p5} disagrees "
                           f"({'3 trips' if fixed else 'converged'}): {nums}")
                for key in ("max_abs_err", "obj_rel", "dual_rel"):
                    if key in nums:
                        worst[key] = max(worst.get(key, 0.0), nums[key])
                if not fixed:
                    trips += float(torch.floor(it5).sum()) / LP_FW_CYCLES
                    per_row += float((a_[4] > 0).sum())
            outs, launch = B5.bind(*a_, **kw_)
            launch()
            ref5 = B5.gpfw_fused(*a_, **kw_)
            torch.cuda.synchronize()
            check(all(bool(torch.equal(o, r)) for o, r in zip(outs, ref5)),
                  "B5's C entry point and its wrapper disagree")
            launchers.append(launch)
        paths = sorted({c[0] for c in calls})
        print(f"[B5 gpfw] main path {Bs}x{ns} p {p5} ({len(calls)} launches"
              f", {', '.join(paths)}): max|x - x_plain| "
              f"{worst['max_abs_err']:.3e} (tol {TOL['lp']}), objective rel "
              f"{worst['obj_rel']:.3e} (tol {TOL['lp_obj']}), 3 trips dual "
              f"objective rel {worst['dual_rel']:.3e} (tol {TOL['lp_fixed']})"
              f"; trips per running row {trips / max(per_row, 1.0):.3f}")

        def replay(fn, calls=calls):
            for _, a_, kw_ in calls:
                fn(*a_, **kw_)

        def replay_c(launchers=launchers):
            for launch in launchers:
                launch()

        ms = cuda_ms(lambda: replay(B5.gpfw_fused)) / len(calls)
        kernel_ms = cuda_ms(replay_c) / len(calls)
        plain_ms = cuda_ms(lambda: replay(B5.gpfw_fused_plain),
                           reps=1) / len(calls)
        b, f = bound_ms(Bs * ns * 12 + Bs * 24,
                        ns * (trips / len(calls) * lp_ops_per_trip(p5)
                              + Bs * lp_ops_init(p5)))
        kern.append(dict(
            name=f"B5 gpfw_fused ({Bs}x{ns} p {p5}, {', '.join(paths)})",
            route="cuda", source="proxtv_tpu_torch/csrc/lp_fused.cu",
            replaces="proxtv_tpu/ops/kernels/lp_fused.py:267",
            launches=len(calls),
            launches_by_path={p_: sum(1 for c in calls if c[0] == p_)
                              for p_ in paths},
            max_abs_err=worst["max_abs_err"], obj_rel_err=worst["obj_rel"],
            dual_rel_err_3_trips=worst["dual_rel"], ms=ms, plain_ms=plain_ms,
            bound_ms=b, bound_by=f, library_ms=None, kernel_ms=kernel_ms,
            row_trips_per_launch=trips / len(calls),
            ops_per_trip=lp_ops_per_trip(p5)))
    check(sum(k_["launches"] for k_ in kern if k_["name"].startswith("B5 "))
          == sum(by_path["B5"].values()),
          "the B5 tap missed main-path launches")
    # D1 and D2 at each main-path shape (10000x1000 at lam 0.7, the
    # per-edge 512x1000 batch, tv1w_1d's one signal): every launch held
    # against its plain version on the card (TOL["direct"]), then replayed
    # in order: ms through the wrapper, kernel_ms through the C entry point
    # with its arguments (and D2's workspace) made once, plain_ms the plain
    # version's run on the card.  Bytes: y read and x written, plus the
    # weights read; the operations: TS_OPS_PER_POINT / DP_OPS_PER_POINT a
    # point, the least work any data needs.
    for kid, mod_, src_, line_, ops_pp in (
            ("D1", D1, "tautstring.cu", 334, TS_OPS_PER_POINT),
            ("D2", D2, "dp.cu", 632, DP_OPS_PER_POINT)):
        fn_name = "tautstring" if kid == "D1" else "dp"
        for (Bs, ns, kind), calls in d_calls[kid].items():
            worst, plain_s, launchers = 0.0, 0.0, []
            for _, y_, lam_ in calls:
                err, sec = direct_compare(kid, y_, lam_)
                worst, plain_s = max(worst, err), plain_s + sec
                out, launch = mod_.bind(y_, lam_)
                launch()
                torch.cuda.synchronize()
                check(bool(torch.equal(out, getattr(mod_, fn_name)(y_, lam_))),
                      f"{kid}'s C entry point and its wrapper disagree")
                launchers.append(launch)
            check(worst <= TOL["direct"], f"{kid} main path {Bs}x{ns} "
                  "disagrees with its plain version")
            errs["direct"] = max(errs["direct"], worst)
            paths = sorted({c[0] for c in calls})

            def replay(calls=calls, fn=getattr(mod_, fn_name)):
                for _, y_, lam_ in calls:
                    fn(y_, lam_)

            def replay_c(launchers=launchers):
                for launch in launchers:
                    launch()

            ms = cuda_ms(replay) / len(calls)
            kernel_ms = cuda_ms(replay_c) / len(calls)
            lam_bytes = {"scalar": 0, "per-signal": Bs * 4,
                         "per-edge": Bs * (ns - 1) * 4}[kind]
            b, f = bound_ms(Bs * ns * 8 + lam_bytes, Bs * ns * ops_pp)
            kern.append(dict(
                name=f"{kid} {fn_name}_tv1 ({Bs}x{ns} {kind}, "
                     f"{', '.join(paths)})",
                route="cuda", source=f"proxtv_tpu_torch/csrc/{src_}",
                replaces=f"proxtv_tpu/ops/tv1d_l1.py:{line_} (XLA lock-step "
                         "scan; no TPU kernel)",
                launches=len(calls),
                launches_by_path={p_: sum(1 for c in calls if c[0] == p_)
                                  for p_ in paths},
                max_abs_err=worst, ms=ms, plain_ms=plain_s * 1e3 / len(calls),
                bound_ms=b, bound_by=f, library_ms=None,
                kernel_ms=kernel_ms))
            print(f"[{kid} {fn_name}] main path {Bs}x{ns} {kind} "
                  f"({len(calls)} launches): max|kernel - plain| / scale = "
                  f"{worst:.3e} (tol {TOL['direct']})")
        check(sum(k_["launches"] for k_ in kern if k_["name"].startswith(
            kid + " ")) == sum(by_path[kid].values()),
            f"the {kid} tap missed main-path launches")
    for k_ in kern:
        extra = "".join(f", {key} {k_[key]:.4f} ms" for key in (
            "kernel_ms", "bound_ms_pcr") if key in k_)
        print(f"[kernel] {k_['name']}: {k_['ms']:.4f} ms (plain "
              f"{k_['plain_ms']:.4f} ms, bound {k_['bound_ms']:.4f} ms by "
              f"{k_['bound_by']}{extra}), {k_['launches']} launches on the "
              f"main path {k_['launches_by_path']}  ({card})")

    # -- 5. where the time goes: device time by kernel, idle share -------
    breakdown = {}
    for name, fn in (("tv1_2d auto", lambda: ptv.tv1_2d(Y2, LAM2D)),
                     ("tv1_2d dr", lambda: ptv.tv1_2d(Y2, LAM2D, method="dr")),
                     ("tv1_1d pn", lambda: ptv.tv1_1d(y1, 2.0, method="pn")),
                     ("tvgen_nd cp-acc 3d", lambda: ptv.tvgen_nd(
                         V, [LAM3] * 3, [1, 2, 3], [1.0] * 3,
                         method="chambolle-pock-acc")),
                     ("tv2_batched ms", lambda: tv1d_l2.tv2_batched(
                         Y1t, LAML2, method="ms")),
                     ("tvp_batched p 1.5", lambda: tv1d_lp.tvp_batched(
                         Yp, LAMP, 1.5)),
                     ("tvp_2d p 1.5 512^2", lambda: ptv.tvp_2d(
                         Y5, LAM2P, LAM2P, P2P, P2P, max_iters=35)),
                     ("tv1_batched pn", lambda: tv1d_l1.tv1_batched(
                         Y1t, LAM1D, method="pn")),
                     ("tvgen pd 3d", lambda: ptv.tvgen(
                         V, [LAM3] * 3, [1, 2, 3], [1.0] * 3)),
                     ("tv2_1d mspg", lambda: ptv.tv2_1d(y1, 2.0)),
                     ("tvp_2d p 2 1024^2", lambda: ptv.tvp_2d(
                         Y2, LAM2D, LAM2D, 2, 2)),
                     ("tvp_batched p 3", lambda: tv1d_lp.tvp_batched(
                         Yp, LAMP, 3.0)),
                     ("tvp_batched p 5", lambda: tv1d_lp.tvp_batched(
                         Yp, LAMP, 5.0)),
                     ("tvp_1d p 1.5", lambda: ptv.tvp_1d(y1, 2.0, 1.5)),
                     ("tv p 1.5", lambda: ptv.tv(y1, LAMP, p=1.5)),
                     ("tv1_batched tautstring D1", lambda: tv1d_l1.tv1_batched(
                         Y1t, LAM1D, method="hybridtautstring", strict=True)),
                     ("tv1_batched dp D2", lambda: tv1d_l1.tv1_batched(
                         Y1t, LAM1D, method="dp", strict=True)),
                     ("tv1_batched 512 per-edge tautstring D1",
                      lambda: tv1d_l1.tv1_batched(Ywt, Wwt, method="tautstring",
                                                  strict=True)),
                     ("tv1_batched 512 per-edge dp D2",
                      lambda: tv1d_l1.tv1_batched(Ywt, Wwt, method="dp",
                                                  strict=True)),
                     ("tv1_1d auto", lambda: ptv.tv1_1d(y1, 2.0)),
                     ("tv1_1d auto n=1e6 long route",
                      lambda: ptv.tv1_1d(ylong, LAM1D)),
                     ("tv1_1d auto C2 n=20000 long route",
                      lambda: ptv.tv1_1d(yc2, LAMC2)),
                     ("tv1w_1d auto", lambda: ptv.tv1w_1d(y1, ww1)),
                     ("tv1_1d host", lambda: ptv.tv1_1d(y1, 2.0,
                                                        backend="host")),
                     ("tv1w_1d tautstring cuda", lambda: ptv.tv1w_1d(
                         y1, ww1, method="tautstring", backend="cuda")),
                     ("tv1w_1d dp cuda", lambda: ptv.tv1w_1d(
                         y1, ww1, method="dp", backend="cuda")),
                     ("tv1w_1d pn cuda", lambda: ptv.tv1w_1d(
                         y1, ww1, method="pn", backend="cuda")),
                     ("tv1w_2d dr 1024^2", lambda: ptv.tv1w_2d(Y2, Wc2, Wr2)),
                     ("per-image cp-acc 4x512^2", lambda: tv2d.tv1_2d_batched(
                         Ypi_t, lpi_t, method="chambolle-pock-acc"))):
        breakdown[name] = profile_call(fn)
        b_ = breakdown[name]
        top = ", ".join(f"{k_} {v:.3f} ms" for k_, v in b_["top"])
        print(f"[profile] {name}: wall {b_['wall_ms']:.3f} ms, device busy "
              f"{b_['busy_ms']:.3f} ms, idle share {b_['idle_share']}; "
              f"{b_['kernels']} kernel launches; top: {top}  ({card})")

    for name_, run_, t_ in (
            ("tv1_1d auto n=1e6 long route",
             f"api.tv1_1d n=1e6 w {LAM1D} auto (long route)",
             "tv1_1d_long_ms"),
            ("tv1_1d auto C2 n=20000 long route",
             f"api.tv1_1d n={NC2} w {LAMC2} auto (C2 walk, long route)",
             "tv1_1d_c2_ms")):
        b_, m_ = breakdown[name_], main[run_]
        print(f"[long] {name_}: wall (CUDA events) {times[t_]:.4f} ms, "
              f"profiled wall {b_['wall_ms']:.3f} ms, device busy "
              f"{b_['busy_ms']:.3f} ms, idle share {b_['idle_share']}, B1 "
              f"launches {m_['launches']['B1']} (device "
              f"{b_['ours'].get('B1', 0.0):.3f} ms), host syncs "
              f"{m_['host_syncs']}  ({card})")

    # The redesign queue: each kernel's device time over one pass of every
    # main-path call that launches it (the profiled calls above), less the
    # bounds of those launches where phase 4 timed the kernel at the path's
    # own shape (B1, B2, B4 and B5 at each of their shapes, B3, B6).
    at_shape = {"B3": sum(by_path["B3"].values()),
                "B6": sum(by_path["B6"].values())}
    queue = {}
    for kid in counters:
        dev_ms = sum(b_["ours"].get(kid, 0.0) for b_ in breakdown.values())
        per_shape = kid in ("B1", "B2", "B4", "B5", "D1", "D2")
        bnd = sum(k_["bound_ms"] * (k_["launches"] if per_shape
                                    else at_shape.get(kid, 0))
                  for k_ in kern if k_["name"].startswith(kid + " "))
        queue[kid] = {"device_ms": dev_ms, "bound_ms": bnd,
                      "gap_ms": dev_ms - bnd,
                      "launches": sum(by_path[kid].values())}
    for kid, q in sorted(queue.items(), key=lambda kv: -kv[1]["gap_ms"]):
        print(f"[queue] {kid}: {q['device_ms']:.4f} ms of device time over "
              f"{q['launches']} main-path launches, bounds {q['bound_ms']:.4f}"
              f" ms: {q['gap_ms']:.4f} ms over  ({card})")

    # -- 6. train: each cell again, untapped, step by step; one profiled
    # step a cell ---------------------------------------------------------
    t0 = time.perf_counter()
    train_times = {}
    for name_, (desc_, run_cell, make_) in tcells.items():
        r_ = run_cell()
        m_ = main[train_main[name_]["path"]]
        one, _ = make_()
        prof = profile_call(lambda: one())
        train_times[name_] = {"steps": r_["steps"],
                              "final_loss": r_["final_loss"],
                              "profile": prof}
        for i_, s_ in enumerate(r_["steps"]):
            print(f"[train] {name_} step {i_}: forward {s_['fwd_ms']:.3f} "
                  f"ms, backward {s_['bwd_ms']:.3f} ms (CUDA events), loss "
                  f"{s_['loss']:.6e}; forward B1 {s_['fwd']['B1']} B3 "
                  f"{s_['fwd']['B3']} launches, host syncs forward "
                  f"{s_['fwd']['host_syncs']} backward "
                  f"{s_['bwd']['host_syncs']}, label trips "
                  f"{s_['bwd']['label_trips']}  ({card})")
        top = ", ".join(f"{k_} {v:.3f} ms" for k_, v in prof["top"])
        print(f"[train] {name_} ({desc_}): the counted run launched "
              f"{m_['launches']['B1']} B1 and {m_['launches']['B3']} B3, "
              f"{m_['host_syncs']} host syncs, "
              f"{train_main[name_]['label_trips']} label trips; one profiled "
              f"step: wall {prof['wall_ms']:.3f} ms, device busy "
              f"{prof['busy_ms']:.3f} ms, idle share {prof['idle_share']}; "
              f"{prof['kernels']} kernel launches; top: {top}  ({card})")
    t_train += time.perf_counter() - t0
    print(f"[train] phase: {t_train:.1f} s (the counted run, its checks, "
          f"the timing run and the profiles; its launches' holds in phase 3b"
          f" and replays in phase 4 not included)")
    report["train"] = {
        "main": {k_: {"steps": v["steps"], "final_loss": v["final_loss"],
                      "label_trips": v["label_trips"],
                      "launches": main[v["path"]]["launches"],
                      "host_syncs": main[v["path"]]["host_syncs"]}
                 for k_, v in train_main.items()},
        "checks": train_checks, "times": train_times, "seconds": t_train}

    report.update(errors=errs, main_path=main, times=times, kernels=kern,
                  queue=queue,
                  breakdown=breakdown,
                  tolerances=TOL, total_s=time.perf_counter() - t_all,
                  auto_iters=int(info_auto.iters[0]),
                  dr_sweeps=int(info_dr.iters[0]), cross_check=xc,
                  F_ref=F_ref, gap_ref=gap_ref, F3_ref=F3_ref,
                  gap_ref3=gap_ref3, tvgen_nd_iters=int(info_3d.iters[0]),
                  tvgen_sweeps=int(info_gen.iters[0]),
                  b1_shapes={f"{a}x{b}": v for (a, b), v in b1_shapes.items()})
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
