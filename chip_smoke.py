#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (proxtv_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (each failure ends the run with a non-zero exit and no result line):

1. build the eleven hand-written kernels from ``proxtv_tpu_torch/csrc``
   (B1-B6 for the TPU's Pallas kernels, D1-D4 for the JAX package's XLA
   taut-string, DP, Condat and classic taut-string scans, L1 for its XLA
   while_loop that labels the flat components in the 2D backward) and
   print the card (``nvidia-smi`` name and power limit) and the build time;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with the tolerances in ``TOL`` (D1-D4 and
   L1 in phase 4, at each of their main-path launches; D3, D4 and L1 bit
   for bit);
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
   string at 512 x 1000 (D3, D4) and through ``api.tv1_1d`` with
   ``method="condat"`` / ``"classictautstring"`` on one signal of 1000
   (D3, D4), ``api.tv1_1d`` and
   ``api.tv1w_1d`` auto on one signal of 1000 (on the card: B1, D1; no
   call gives way to the host) and with ``backend="host"`` (the native host
   engine), ``api.tv1w_1d`` with ``backend="cuda"`` (D1, D2, B2), the
   long-signal route of ``api.tv1_1d`` auto past n = 16384 on the bench's
   n = 10^6 signal at lam 0.7 and on ROADMAP C2's n = 20000 walk at lam 2.0
   (its windows in one B1 launch; no ``tv1_pn``), ``api.tv1w_2d`` dr
   at 1024^2 with seeded weight fields (B1 on weighted fibers), per-image
   lam on 4 x 512^2 with cp-acc (B3's weighted route), bench.py's
   configurations the card had not run (ROADMAP F): F1, 4K UHD (2160 x
   3840) through ``tv1_2d_batched`` cp-acc (B3), F2, ``tv1_batched`` pn
   on 10000 x 1000 with per-edge weights (B1), F3, ``tv1d_long.tv1_long``
   on a stream of 8 signals of 10^6 (B1, 1568 windows), each with its
   first B1 / B3 launch held against the plain version, timed by CUDA
   events and profiled (``[F]`` lines), and the demos;
   then hold the outputs against float64 references: independent float64
   primal-dual solves on the card for 1024^2 (weighted too), the 512^2
   images, the 4K image and the volume, the float64 host engine for F2 and
   F3, the same calls in float64 on the CPU for the 1D,
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
   input (B1 on the dr fibers), and one chambolle-pock-acc VJP (B3); each
   T2 backward labels the flat components with one L1 launch.  It
   fails if a step leaves the card or its forward misses its kernel, if a
   T2 backward does not launch L1 once or takes a label trip or a host
   sync, if the loss does not fall, or if the backward on the card parts
   from the same backward in float64 on the CPU (on the card's forward
   output) by more than ``TOL["backward"]``; and prints, as a finding, the
   share of edges the float32 forward classifies differently from the
   float64 one at a reduced size (``[train]`` lines);
   3e. dist, the parallel path (``proxtv_tpu_torch.parallel``) at the
   bench's widths: at world 1 on NCCL in this process, counted and tapped
   with the main path, ``tv1_2d_banded`` and ``tv1w_2d_banded`` 1024^2
   (B3), ``tv1_3d_banded`` 32 x 256 x 256 (B6), ``tv1_1d_banded`` on the
   10^6 signal (B1), ``tv1_2d_sharded_fused`` 4 x 512^2 (B3), the
   column-split ``tv1_2d_sharded(shard_axis="cols")`` of the 1024^2 image
   with dr (B1), chambolle-pock-acc (the unfused iteration, no kernel, as
   the JAX package runs it sharded) and kolmogorov (B1), and of the
   4 x 512^2 batch with per-image lam and dr (B1), each at most
   ``COLS_ITERS`` sweeps, ``tv1_1d_sharded`` 10000 x 1000 (B1), F1's 4K
   image through ``tv1_2d_banded`` (B3) and F4, the 10^7 signal through
   ``tv1_1d_banded`` (B1, 1954 windows), held against the float64
   references of phase 3 (certified-gap rule; the host taut string), bit
   for bit against the single-card calls, and the column-split calls
   within 1e-5 of the data's size of the single-card run of the same
   engine; then the first nine at world 2 on gloo, two subprocesses
   sharing the card, each holding its own first B1/B3/B6 launch against
   the plain version, held against world 1.  One ``[dist]`` line a call
   (wall, device busy, exchanges, all-reduces, gathers, bytes, staging
   copies, host syncs, launches);
4. time each kernel (CUDA events, many launches after warm-up), its plain
   version, and the main-path calls, and print the ``kernels`` line; B3 on
   the 1024^2 chunk and on F1's two 4K canvases; B1, B2,
   B4, B5, D1 and D2 at each of their main-path shapes, by replaying that
   shape's launches (B2's, B4's, B5's, D1-D4's and L1's first held against
   their plain versions on each of them), through the wrapper and, for
   B1-B6, D1-D4 and L1, through the C entry point, and B2 beside
   ``torch.linalg.solve`` on the dense form of one launch's systems (its
   yardstick, ``pcr_library``); and L1 on a flat and a serpentine 1024^2
   image, held against their known labels;
5. profile the main-path calls: device time by kernel and the idle share
   (a window that records none of the port's kernels that the call
   launched is profiled again, up to three windows; then the port's
   launches of one more call are timed by CUDA events, ``event_busy``,
   which gives each kernel the profiler missed its own device time);
6. run the training cells again, untapped: each step's forward and
   backward by CUDA events, its launches (B1, B3, L1), host syncs and label
   trips, and one profiled step a cell; then the redesign queue (each
   kernel's device time over its main-path launches, less their bounds,
   ``[queue]`` lines; each must read a device time);
7. float64, the JAX package's float64 route on the card, with B2, D1-D4
   and L1 built in double (``float64_phase``; ``[f64]`` lines): TV-L1,
   ``tv1_batched`` at 10000 x 1000 (D1; dp strict, D2), dp strict on the
   per-edge 512 x 1000 batch (D2), condat and classictautstring strict at
   512 x 1000 (D3, D4) and on ROADMAP C's n = 11621 walk (D4), ``tv1_pn``
   on the n = 1000 walk (B2), ``tv1_2d_batched`` dr at 1024^2 and every 2D
   method at 256^2 (B2 under the fiber methods; the unfused primal-dual
   iteration, no kernel); the layers above it (:func:`_route64_table`), TV-L2
   ``tv2_batched`` ms at 10000 x 1000 (its shifted solves on B2), TV-Lp
   ``tvp_batched`` at 512 x 1000 for p in {1.5, 3, 5} (the setup solve on
   B2), ``tvp_gpfw`` on the 10^6 signal (no kernel), ``tvp_2d_batched``
   p = 2 at 1024^2 and p = 1.5 at 512^2, ``tvgen`` pd and a mixed-p
   ``tv_nd_batched`` pd on the volume, each 2D / ND call again at 256^2 or
   on a 4 x 64 x 64 volume, ``tv1_long`` and ``tv1_1d_banded`` (a gloo
   world of 1) on the 10^6 signal (B2 under their windows' ``tv1_pn``),
   one ``TVDenoise2D`` dr gradient step and one cp-acc VJP at 1024^2 (L1
   in the backward), and ``tv_nd_batched`` chambolle-pock-acc, which must
   raise the JAX package's error; each call launching its double kernels
   and no float32 kernel and running no kernel's plain version on the
   card.  Then each double kernel is held at its main-path launches
   against its float64 plain version (D1-D4 bit for bit, and D1, D3, D4
   one past their float64 warp layouts, D4 also one past its ring
   layout; B2 in the float64 layout it takes at each shape, named on its
   line; L1's labels bit for bit; the
   plain versions of D1-D4 run on the CPU in six worker processes started
   after the build), the outputs against float64 witnesses (the native
   host taut string, the same route in float64 on the CPU, within
   ``TOL64["route"]`` for TV-L2 and TV-Lp rows, ``TOL64["route_long"]``
   for the 10^6 one, or by both sides' certified gaps where a row's
   iteration count parts; the ND calls at the bench's width and the 2D
   and ND calls at 256^2 and 4 x 64 x 64 within ``TOL64["combiner"]``,
   those with a TV-Lp term in ND by their objective, the 2D calls at the
   bench's width by their objective against phase 3's float64 CPU run;
   the long routes within sqrt(2 gap) of the host taut string, the
   backward within ``TOL64["backward"]``), and each double
   kernel timed through its wrapper and its C entry (``B2.f64`` at each
   shape beside ``torch.linalg.solve``, ``D1.f64``-``D4.f64`` and
   ``L1.f64`` entries of the ``kernels`` line, bounds at the float64
   rate); then the float64 queue (``[queue64]`` lines: each double
   kernel's phase 7 launches times its C entry's time less its bound);
8. the numpy API in float64 on the card (``api64_phase``; ``[api64]``
   lines): under ``torch.set_default_dtype(torch.float64)`` (restored
   after), every API row of phase 3 at its width (``tv1_2d`` auto, now dr,
   and ``tv1w_2d`` at 1024^2; ``tv1_1d`` pn, auto, condat,
   classictautstring and dp, ``tv1w_1d`` auto, dp and pn, ``tv2_1d`` and
   ``tvp_1d`` p = 1.5 at n = 1000; ``tv1_1d`` auto on the 10^6 signal and
   on C2's walk; ``tv2_1d`` ms at 10^6; ``tvp_2d`` p = 2 at 1024^2 and
   p = 1.5 at 512^2 with 35 sweeps; ``tvgen`` and ``tvgen_nd`` pd on the
   volume at 35 sweeps; ``tv_value``), each float64, launching only its
   float64 kernels (B2, D1-D4 in double) and no kernel's plain version on
   the card, bit for bit with the batched call it wraps (phase 7's output
   where phase 7 ran it), timed by CUDA events beside phase 4's float32
   API wall, and at a small size within TOL64 of the same call with
   ``device="cpu"``; ``tvgen_nd`` chambolle-pock-acc and
   ``tv1_2d_banded`` must raise, as the JAX package's do; a float32 batch
   under the float64 default keeps its kernels, counts and output.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
card line and the ``kernels`` line come before it.  Details (the report and
the compiler's register / shared-memory lines) go to ``--out``, by default
``chip_smoke_out/``.  Imports nothing of JAX or ``proxtv_tpu``.
"""
import collections
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
    # On the per-image column split's launches a fiber past "pn" whose
    # counts part is held by float64 certificates of both sides instead
    # (pn_hold's ``margin``).
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
    # D1-D4 (the direct engines): relative to the data's size.  The kernel
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
# bench.py's configurations F1-F4 (ROADMAP F), at the bench's widths.  F1:
# 4K UHD, single card (cp-acc, bench.py:487-490) and banded on a mesh of one
# (bench.py:500-510), against a float64 reference of F4K_REF_ITERS
# Chambolle-Pock iterations on the card.  F2: per-edge-weighted pn on
# 10000 x 1000, weights 0.5 + U[0, 1) (bench.py:512-514).  F3: the stream of
# S_LONG signals of 10^6 (bench.py:626-629).  F4: the 10^7-sample signal
# through tv1_1d_banded at world 1 (bench.py:53,600-624).
M4K, N4K, LAM4K, ITERS4K = 2160, 3840, 0.3, 2500
F4K_REF_ITERS = 10000
S_LONG, N_LONG7 = 8, 10_000_000
# The column-split 2D calls of the dist phase stop by mean change or at
# COLS_ITERS sweeps: kolmogorov and the unfused PDHG default to 2500
# (utils/config.py), and at world 2 each sweep's one-column halo exchanges
# and all-reduce cost ~2.5 ms apiece through gloo, so the cap keeps the
# phase inside the smoke run's time.
COLS_ITERS = 300
# The per-image column split (dist phase), whose B1 launches pn_hold takes
# with ``margin``.
COLS_PI_NAME = (f"tv1_2d_sharded cols {B_PI}x{M_PI}^2 per-image lam {LAM_PI} "
                f"dr max_iters {COLS_ITERS}")


# The float64 phase (7): the float64 route of the batched TV-L1 layers on
# the card, with kernels B2, D1, D3 and D4 built in double.  Its bars:
# D1, D3 and D4 bit for bit with their float64 plain versions (as in
# float32) on every row the guards do not take, the rest within
# 1e-12 max|y| (the guards' means summed in another order); B2 within
# 1e-10 max|plain| of its float64 plain version (the unmasked system's
# condition is ~4e5 at n = 1000); the full-width direct calls within
# 1e-10 max|y| of the native host taut string (float64), D4 on ROADMAP C's
# n = 11621 walk within 1e-9 of it (float32 lands 8.97e-3); tv1_pn within
# 5e-4 of the CPU's float64 tv1_pn (tests/test_tv1d_l1.py's oracle bar);
# dr at 256^2 within 1e-6 of the same call on the CPU, every other 2D
# method within XBAR of dr at tests/test_tv2d.py's caps.
TOL64 = {"direct_guard": 1e-12, "pcr": 1e-10, "host": 1e-10, "walk": 1e-9,
         "pn": 5e-4, "dr_cpu": 1e-6,
         # The layers above TV-L1 (ROADMAP F6.1-F6.6): TV-L2 and TV-Lp rows
         # within 1e-8 max|y| of the same route in float64 on the CPU
         # (tests/test_torch_tv2.py's port-vs-JAX bar), a row whose
         # iteration count parts at its stop tolerance within the two
         # sides' certified gaps, sqrt(2 g) each (the objective is
         # 1-strongly convex); the 10^6 TV-Lp row within 2e-6 max|y|: the
         # same call on the CPU parts from itself by up to 1.5e-7 max|y|
         # when only the order of its 10^6-term sums changes, float32 by
         # 6.7e-5 (tools/f64_witness.py tvp_long); the 2D and ND combiners
         # within 1e-6 max|y| of the same call in float64 on the CPU, at
         # 256^2 and 4 x 64 x 64 and, for the ND calls, at the bench's
         # width.  An ND combiner with a TV-Lp term (p = 1.5) parts from
         # itself on the CPU by up to 1.2e-4 max|y| when only the order of
         # its sums changes, half as far as float32 lands (2.8e-4): its
         # Frank-Wolfe fiber solves stop at a duality gap of 1e-5 and the
         # warm starts carry each difference on (tools/f64_witness.py
         # mixed, 8 x 128 x 128 and 32 x 256 x 256).  There the root mean
         # square of the parting is at most 9.2e-7 max|y| (float32 8.2e-6
         # or more) and the objective's at most 1.7e-8 relative (float32
         # 4.8e-7 or more), so those calls are held by the objective within
         # 5e-8 relative ("combiner_lp_F"), dx's root mean square within
         # 3e-6 max|y| ("combiner_lp_rms") and x within 1e-3 max|y|, the
         # scale at which those fiber solves stop ("combiner_lp_max").
         # On the small 4 x 64 x 64 volume no objective bar separates the
         # two: over it and ten randn volumes of its size (seeds 0-9) the
         # same float64 call parts from itself by up to 1.5e-7 relative in
         # the objective (float32 lands from 1.6e-8), but by at most
         # 1.09e-6 max|y| in dx's root mean square (float32 1.09e-5 or
         # more) and 8.6e-5 in max|dx| (float32 1.29e-4 to 2.21e-4)
         # (tools/f64_witness.py mixed --shape phase7 and --shape 4x64x64
         # --seeds 0-9): it is held by dx's root mean square within 3e-6
         # max|y| ("combiner_lp_small_rms"), which float32 fails, and x
         # within 2e-4 max|y| ("combiner_lp_small_max"), the objective
         # printed and not held.  The 2D backward within 1e-10 relative of
         # float64 on the CPU (tests/test_diffprox.py).
         "route": 1e-8, "route_long": 2e-6, "combiner": 1e-6,
         "combiner_lp_F": 5e-8, "combiner_lp_rms": 3e-6,
         "combiner_lp_max": 1e-3, "combiner_lp_small_rms": 3e-6,
         "combiner_lp_small_max": 2e-4,
         "backward": 1e-10}
# NVIDIA's data sheet for the H100 SXM: float64 outside the tensor cores.
PEAK_F64_FLOP_S = 34e12
N_WALK64, LAM_WALK64 = 11621, 1.3   # ROADMAP C's D4 walk (seed 15)
# D2's ring overflow: a ramp of N1D from 0 to 1 at this lam holds 91
# breakpoints at once, past D2's float64 ring of 64 (tools/dp_depths.py).
LAM_RING64 = 2.0
M64 = 256                           # the 2D methods' float64 image
# The cross-method bar's runs: tests/test_tv2d.py:72's caps (1000 sweeps
# for dr, pd and yang, 2500 iterations for the others), every method to a
# mean change of 1e-8 (at 256^2 in float64 the default 1e-6 stops pd and
# kolmogorov 1.02e-3 and 1.58e-3 from dr, and 1e-7 chambolle-pock-acc
# 1.04e-3 from dr, itself ~7e-4 from where condat, chambolle-pock and
# yang meet).
CAPS64 = {"dr": 1000, "pd": 1000, "yang": 1000, "kolmogorov": 2500,
          "condat": 2500, "chambolle-pock": 2500, "chambolle-pock-acc": 2500}
STOP64 = 1e-8
METHODS_2D = ("dr", "pd", "yang", "kolmogorov", "condat", "chambolle-pock",
              "chambolle-pock-acc")
# The first launches of each B2 float64 shape kept for its holds and its
# replays (the 1024^2 dr solve launches hundreds of 1024 x 1023 systems).
B2_KEEP = 8
# The kernels built in double (their LAUNCHES_F64 counters).
F64_KIDS = ("B2", "D1", "D2", "D3", "D4", "L1")
# Phase 7's layers above TV-L1: the ND rows' mixed-p terms, the volume at
# which the 2D and ND rows are also held against the CPU (with the 256^2
# image), the reference's sweeps of the ND combiners and of T2's dr, and
# the shorter window in which those calls are profiled (profiling a
# 35-sweep call records ~1e5 events; its wall is timed by CUDA events).
PS_MIXED = (1.0, 2.0, 1.5)
V64_SMALL = (4, 64, 64)
SEED_V64_SMALL = SEED + 12  # the small volume's own draw (v64_small)
ND_SWEEPS = 35
PROFILE_SWEEPS = 5
# Phase 8 (the API in float64): the small sizes at which each call on the
# card is held against the same call with device="cpu" (a signal of
# API64_N, an API64_M^2 image, an API64_V volume; the spectral TV-L2 path
# past 8192 lanes at API64_SPECTRAL; the long route on C2's walk).
API64_N, API64_M, API64_V, API64_SPECTRAL = 300, 64, (4, 16, 16), 9000


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


# Main-path launches of one B1 shape that phase 4 times the plain version
# on (the kernel is timed over all of them).
PLAIN_SAMPLE = 32
# Each kernel's module under proxtv_tpu_torch.ops.kernels and the wrapper
# that launches it (and counts the launch in the module's LAUNCHES).
WRAPPERS = {"B1": ("pn_fused", "pn_tv1_fused"),
            "B2": ("pcr", "pcr_spd_solve"), "B3": ("pdhg_fused", "pdhg_chunk"),
            "B4": ("ms_fused", "ms_tv2_fused"),
            "B5": ("lp_fused", "gpfw_fused"),
            "B6": ("pdhg3d_fused", "pdhg3d_chunk"),
            "D1": ("tautstring", "tautstring"), "D2": ("dp", "dp"),
            "D3": ("condat", "condat"), "D4": ("classic_ts", "classic_ts"),
            "L1": ("labels", "component_labels")}


def kernel_module(kid):
    import importlib

    return importlib.import_module(
        f"proxtv_tpu_torch.ops.kernels.{WRAPPERS[kid][0]}")


def launch_counters():
    """Every kernel's launch counter, its float32 instantiation's (``B1``
    ...) and, where built in double, its float64 one's (``B2.f64`` ...)."""
    counters = {kid: kernel_module(kid).LAUNCHES for kid in WRAPPERS}
    counters.update({kid + ".f64": kernel_module(kid).LAUNCHES_F64
                     for kid in F64_KIDS})
    return counters


def trip_plain(counter):
    """Make every kernel's plain version add one to ``counter`` when it is
    called on a CUDA tensor (the float64 route may run compositions on the
    card, never a kernel's plain version).  Returns the (module, name,
    original) triples that undo it."""
    import torch

    from proxtv_tpu_torch.ops import tv1d_l1

    saved = []

    def trip(mod, name):
        orig = getattr(mod, name)

        def f(y, *a, **k):
            counter.value += bool(torch.is_tensor(y) and y.is_cuda)
            return orig(y, *a, **k)

        saved.append((mod, name, orig))
        setattr(mod, name, f)

    for name in ("tv1_tautstring_plain", "tv1_condat_plain",
                 "tv1_classic_ts_plain", "tv1_dp_plain"):
        trip(tv1d_l1, name)
    for kid, name in (("B2", "pcr_spd_solve_plain"),
                      ("B1", "pn_tv1_fused_plain"),
                      ("B3", "pdhg_chunk_plain"),
                      ("B4", "ms_tv2_fused_plain"),
                      ("B5", "gpfw_fused_plain"),
                      ("B6", "pdhg3d_chunk_plain"),
                      ("L1", "component_labels_plain")):
        trip(kernel_module(kid), name)
    return saved


def event_busy(fn):
    """Device ms of the port's kernel launches in one call of ``fn``, by
    CUDA events around each wrapper call: ``(total, {kernel id: ms})``.
    The events also span the wrapper's own work on the stream before its
    launch, so this bounds each kernel's time from above and the call's
    device busy time from below (PyTorch's own ops are not timed)."""
    import torch

    pairs, saved = [], []
    for kid, (_, attr) in WRAPPERS.items():
        mod = kernel_module(kid)
        orig = getattr(mod, attr)
        saved.append((mod, attr, orig))

        def tap(*a, _orig=orig, _kid=kid, **kw):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = _orig(*a, **kw)
            e1.record()
            pairs.append((_kid, e0, e1))
            return out

        setattr(mod, attr, tap)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)
    per = {}
    for kid, e0, e1 in pairs:
        per[kid] = per.get(kid, 0.0) + e0.elapsed_time(e1)
    return sum(per.values()), per


def profile_call(fn, windows=3):
    """One call under torch.profiler, which keeps its events
    (``acc_events=True``): wall time, summed device kernel time, the
    device's idle share and the five costliest kernels.  A window that
    records none of the port's kernels that the call launched (their
    LAUNCHES counters) is profiled again, up to ``windows``; if none does,
    the busy time is the port's launches in one more call by CUDA events
    (event_busy, ``busy_source``), and so is the device time (``ours``) of
    each launched kernel that the profiler did not record
    (``ours_source``).  A rank of a world passes ``windows=1`` and gets no
    event timing: one more call would leave its collectives without a
    partner."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counters = {kid: kernel_module(kid).LAUNCHES for kid in WRAPPERS}
    for window in range(1, windows + 1):
        before = {kid: c.value for kid, c in counters.items()}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            # One PyTorch launch before the window: a window whose first
            # launch is a ctypes kernel (tv2_batched) recorded no device
            # time without.
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        launched = [kid for kid, c in counters.items()
                    if c.value > before[kid]]
        per = {}
        n = 0
        for e in prof.events():  # device-side events: kernels and copies
            if "CUDA" not in str(getattr(e, "device_type", "")):
                continue
            per[e.name] = per.get(e.name, 0.0) + e.device_time_total / 1e3
            n += 1
        ours = {}  # device ms of the port's kernels, by kernel id
        for name, ms in per.items():
            for kid, fn_ in KERNEL_FNS.items():
                if fn_ in name:
                    ours[kid] = ours.get(kid, 0.0) + ms
        complete = sum(per.values()) > 0 and all(k in ours
                                                 for k in launched)
        if complete:
            break
    busy, source = sum(per.values()), "profiler"
    ours_source = {kid: "profiler" for kid in ours}
    if not complete:
        if windows > 1 and launched:
            busy, by_kid = event_busy(fn)
            source = "port kernels by CUDA events"
            for kid in launched:
                if kid not in ours:
                    ours[kid] = by_kid.get(kid, 0.0)
                    ours_source[kid] = "CUDA events"
        else:
            busy, source = 0.0, "not measured"
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall, "busy_ms": busy, "kernels": n,
            "windows": window, "busy_source": source,
            "idle_share": (1.0 - busy / wall) if busy > 0 else "not measured",
            "top": [(k[:60], v) for k, v in top], "ours": ours,
            "ours_source": ours_source}


# The __global__ functions of each kernel, as the profiler names them.
KERNEL_FNS = {"B1": "::pn_", "B2": "::pcr_kernel", "B3": "::pdhg_kernel",
              "B4": "::ms_kernel", "B5": "::gpfw_kernel",
              "B6": "::pdhg3d_march", "D1": "::tautstring_", "D2": "::dp_",
              "D3": "::condat_", "D4": "::classic_ts_", "L1": "::labels_"}


# The dist phase (3e): the parallel path on a torch.distributed mesh, at
# world 1 on NCCL in this process and at world DIST_WORLD on gloo, in
# subprocesses that share the one card (both ranks on cuda:0).
DIST_WORLD = 2
DIST_TIMEOUT_S = 600
COMM = ("EXCHANGES", "ALL_REDUCES", "GATHERS", "BYTES_MOVED",
        "STAGING_COPIES")


def dist_calls(P, mesh, d, world):
    """The parallel path's calls at the bench's widths, on the global
    arrays ``d`` (every rank passes the same): (name, fn, kernel it must
    launch or None for a call that launches none of B1, B3 and B6, kind of
    check).  tv1_1d_sharded, the 4K banded image (F1) and the 10^7 signal
    (F4) only at world 1."""
    calls = [
        (f"tv1_2d_banded {M2D}^2 lam {LAM2D} cp-acc",
         lambda: P.tv1_2d_banded(d["Y2"], LAM2D, mesh), "B3", "cert2d"),
        (f"tv1w_2d_banded {M2D}^2 weights {LAMW2D} x U[0.5, 1.5] cp-acc",
         lambda: P.tv1w_2d_banded(d["Y2"], d["Wc2"], d["Wr2"], mesh), "B3",
         "cert2dw"),
        (f"tv1_3d_banded {L3}x{M3}x{N3} lam {LAM3} cp-acc",
         lambda: P.tv1_3d_banded(d["V"], LAM3, mesh), "B6", "cert3d"),
        (f"tv1_1d_banded n=1e6 lam {LAM1D} chunk 5120 overlap 640",
         lambda: P.tv1_1d_banded(d["ylong"], LAM1D, mesh), "B1", "long1d"),
        (f"tv1_2d_sharded_fused {B_PI}x{M_PI}^2 lam {LAM2D} cp-acc",
         lambda: P.tv1_2d_sharded_fused(d["Ypi"], LAM2D, mesh), "B3",
         "fused"),
    ]
    # The column-split solve (shard_axis="cols") of one 1024^2 image and of
    # the per-image 4 x 512^2 batch, COLS_ITERS sweeps at most.
    for m, kid in (("dr", "B1"), ("chambolle-pock-acc", None),
                   ("kolmogorov", "B1")):
        calls.append((
            f"tv1_2d_sharded cols {M2D}^2 lam {LAM2D} {m} max_iters "
            f"{COLS_ITERS}",
            lambda m=m: P.tv1_2d_sharded(d["Y2"][None], LAM2D, mesh,
                                         method=m, max_iters=COLS_ITERS,
                                         shard_axis="cols"), kid, "cols"))
    calls.append((
        COLS_PI_NAME,
        lambda: P.tv1_2d_sharded(d["Ypi"], np.array(LAM_PI, np.float32),
                                 mesh, method="dr", max_iters=COLS_ITERS,
                                 shard_axis="cols"), "B1", "cols_pi"))
    if world == 1:
        calls += [
            (f"tv1_1d_sharded {B1D}x{N1D} lam {LAM1D}",
             lambda: P.tv1_1d_sharded(d["Y1"], LAM1D, mesh), "B1", "tv1"),
            (f"F1 tv1_2d_banded {M4K}x{N4K} lam {LAM4K} cp-acc",
             lambda: P.tv1_2d_banded(d["Y4"][0], LAM4K, mesh), "B3",
             "cert4k"),
            (f"F4 tv1_1d_banded n=1e7 lam {LAM1D} chunk 5120 overlap 640",
             lambda: P.tv1_1d_banded(d["ylong7"], LAM1D, mesh), "B1",
             "long7"),
        ]
    return calls


def check_launches(got, must, where):
    """A dist call launched the kernel it names; one that names none
    launched none of B1, B3 and B6."""
    if must is None:
        check(all(got.get(k, 0) == 0 for k in ("B1", "B3", "B6")),
              f"{where} launched a kernel: {got}")
    else:
        check(got[must] > 0, f"{where} did not launch {must}")


def comm_counts(debug, reset=False):
    """The parallel path's traffic counters (and reset them)."""
    got = {k.lower(): getattr(debug, k).value for k in COMM}
    if reset:
        for k in COMM:
            getattr(debug, k).reset()
    return got


def _clone(v):
    return v.clone() if hasattr(v, "clone") else v


class FirstLaunch:
    """Keeps the first launch of B1, B3 and B6 under each ``label`` (the
    wrapper's arguments, cloned) and calls through; a launch made with no
    label is not kept."""

    def __init__(self, B1, B3, B6):
        self.targets = {"B1": (B1, "pn_tv1_fused"), "B3": (B3, "pdhg_chunk"),
                        "B6": (B6, "pdhg3d_chunk")}
        self.label, self.seen, self.saved = None, {}, {}

    def __enter__(self):
        for kid, (mod, attr) in self.targets.items():
            self.saved[kid] = orig = getattr(mod, attr)

            def tap(*a, _kid=kid, _orig=orig, **kw):
                key = (self.label, _kid)
                if self.label is not None and key not in self.seen:
                    self.seen[key] = ([_clone(v) for v in a],
                                      {k: _clone(v) for k, v in kw.items()})
                return _orig(*a, **kw)

            setattr(mod, attr, tap)
        return self

    def __exit__(self, *exc):
        for kid, (mod, attr) in self.targets.items():
            setattr(mod, attr, self.saved[kid])


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


def pn_certificate(x, w, y, lam, stop_rel, tol_eps):
    """Float64 checks of float32 B1 outputs, row by row (rows of ``x``,
    ``w``, ``y`` and the per-edge ``lam``, (k, n), the last column unused).

    From the dual w (clipped to |w| <= lam) the primal x64 = y + B'w and the
    duality gap G = sum lam |g| + w g, g = x64[:-1] - x64[1:], are exact in
    float64, and ||x64 - x*|| <= sqrt(2 G) for the optimum x*.  ``delta``
    bounds how far the solver's float32 stop test can read from G and tol:
    its g parts from g by the drift of the returned x from x64 and a
    rounding of each x and of the difference (dg), which moves an edge's
    term by (lam + |w|) dg, except where w sits at its bound against g's
    sign beyond dg (the term is 0 in both); each term's products round
    (2 u lam |g|); the sum and the tol's 0.5 ||y - mean||^2 take (n + 4)
    roundings.  Returns (G, tol, delta, max|x - x64|), (k,) float64 each."""
    import torch

    u = 2.0 ** -24
    x, w, y, lam = x.double(), w.double(), y.double(), lam[:, :-1].double()
    n = y.shape[1]
    wc = torch.maximum(torch.minimum(w[:, :-1], lam), -lam)
    x64 = (y + torch.nn.functional.pad(wc, (0, 1))
           - torch.nn.functional.pad(wc, (1, 0)))
    g = x64[:, :-1] - x64[:, 1:]
    G = (lam * g.abs() + wc * g).sum(1)
    yc = y - y.mean(1, keepdim=True)
    scale = (0.5 * (yc * yc).sum(1)).clamp(min=1.0)
    tol = (tol_eps * float(np.finfo(np.float32).eps) * scale).clamp(
        min=stop_rel)
    d = x - x64
    dg = (d[:, :-1] - d[:, 1:]).abs() + u * (
        x[:, :-1].abs() + x[:, 1:].abs() + g.abs())
    zero = (wc.abs() == lam) & (wc * g < 0) & (g.abs() > dg)
    delta = (torch.where(zero, 0.0, (lam + wc.abs()) * dg).sum(1)
             + 2.0 * u * (lam * g.abs()).sum(1) + (n + 4) * u * (G + tol))
    return G, tol, delta, d.abs().amax(1)


def pn_hold(B1, y, lam_full=None, w_init=None, margin=False, **kw):
    """One B1 launch against its plain version (tb = 1), both with the
    launch's own settings: every fiber's max |x - x_plain| and |w - w_plain|
    within TOL["pn"] and its Newton counts within TOL["pn_iters"].

    ``margin`` (the per-image column split's launches): a fiber past
    TOL["pn"] whose counts part is held instead by float64 checks of both
    sides (pn_certificate).  A warm start whose gap lies at the stop
    tolerance lets the float32 gap's rounding, not the arithmetic, decide
    one more Newton step, which may move x by up to sqrt(2 tol).  There
    each side's output must read G <= tol + delta (for the side that
    stopped first, at its count m) and lie within sqrt(2 (tol + delta)) +
    max|x - x64| of the float64 optimum (the host taut string); the side
    that ran on, run again on the whole launch with max_iters = m, must
    read G >= tol - delta at m.  Returns a dict: ``err``, ``iters_apart``,
    ``ok`` (the bars hold), ``it``, ``it_ref``, ``w``, where the worst
    fiber lies, and ``margin`` (the held fibers' readings, relative to
    tol)."""
    import torch

    from proxtv_tpu_torch.runtime import native

    kw = {k: v for k, v in kw.items()
          if k not in ("return_dual", "return_iters")}
    ref, wref, it_ref = B1.pn_tv1_fused_plain(y, lam_full, w_init, tb=1,
                                              **kw)
    x, w, it = B1.pn_tv1_fused(y, lam_full, w_init, return_iters=True, **kw)
    torch.cuda.synchronize()
    fib = torch.maximum((x - ref).abs().amax(1), (w - wref).abs().amax(1))
    part = it != it_ref
    di = int((it - it_ref).abs().max())
    past = fib > TOL["pn"]
    ok = di <= TOL["pn_iters"]
    held = past & part if margin else torch.zeros_like(past)
    ok = ok and not bool((past & ~held).any())
    stop_rel, tol_eps = kw.get("stop_rel", 1e-6), kw.get("tol_eps", 10.0)
    lam = (lam_full if lam_full is not None
           else torch.full_like(y, float(kw["lam_scalar"])))
    mg = {"fibers": int(held.sum()), "ran_on": math.inf, "final": -math.inf,
          "to_optimum": 0.0}
    idx = torch.nonzero(held).flatten()
    if len(idx):
        def cert(xs, ws, i):
            return pn_certificate(xs[i], ws[i], y[i], lam[i], stop_rel,
                                  tol_eps)

        low = torch.minimum(it, it_ref)
        for m in torch.unique(low[idx]).tolist():
            i = idx[low[idx] == m]
            more = it[i] > it_ref[i]  # the kernel ran on
            runs = {}  # the side that ran on, on the whole launch, at m
            if bool(more.any()):
                runs["k"] = B1.pn_tv1_fused(y, lam_full, w_init,
                                            **dict(kw, max_iters=m))[:2]
            if bool((~more).any()):
                runs["p"] = B1.pn_tv1_fused_plain(
                    y, lam_full, w_init, tb=1, **dict(kw, max_iters=m))[:2]
            for side, sel in (("k", more), ("p", ~more)):
                if not bool(sel.any()):
                    continue
                at_m = cert(*runs[side], i[sel])
                mg["ran_on"] = min(mg["ran_on"], float(
                    ((at_m[0] - at_m[1] + at_m[2]) / at_m[1]).min()))
        for xs, ws in ((x, w), (ref, wref)):
            G, tol, delta, drift = cert(xs, ws, idx)
            mg["final"] = max(mg["final"],
                              float(((G - tol - delta) / tol).max()))
            for r, jj in enumerate(idx.tolist()):
                xstar = torch.from_numpy(native.tv1w_host(
                    y[jj].cpu().numpy(), lam[jj, :-1].cpu().numpy()))
                dist_ = float((xs[jj].cpu().double() - xstar).abs().max())
                bar = math.sqrt(2.0 * float(tol[r] + delta[r])) + float(
                    drift[r])
                mg["to_optimum"] = max(mg["to_optimum"], dist_ / bar)
        ok = (ok and mg["ran_on"] >= 0.0 and mg["final"] <= 0.0
              and mg["to_optimum"] <= 1.0)
    j = int(fib.argmax())
    row = slice(j, j + 1)
    lf = None if lam_full is None else lam_full[row]
    gkw = (kw.get("lam_scalar"), stop_rel, tol_eps)
    return {
        "err": float(fib.max()), "iters_apart": di, "ok": ok,
        "it": it, "it_ref": it_ref, "w": w, "margin": mg,
        "err_counts_agree": float(torch.where(part, 0.0, fib).max()),
        "err_counts_part": float(torch.where(part, fib, 0.0).max()),
        "err_unheld": float(torch.where(held, 0.0, fib).max()),
        "fibers_counts_part": int(part.sum()),
        "worst_iters": [int(it[j]), int(it_ref[j])],
        "worst_gap_over_tol": [
            float(gap_over_tol(x[row], w[row], y[row], lf, *gkw)),
            float(gap_over_tol(ref[row], wref[row], y[row], lf, *gkw))]}


def margin_text(mg):
    """pn_hold's margin readings as a line's tail."""
    if not mg["fibers"]:
        return "no fiber held at the stop margin"
    return (f"{mg['fibers']} fibers past {TOL['pn']} held at the stop "
            f"margin: outputs (G - tol - delta) / tol at most "
            f"{mg['final']:.3e} (bar 0), the side that ran on at the other's "
            f"count (G - tol + delta) / tol at least {mg['ran_on']:.3e} (bar "
            f"0), distance to the float64 optimum over "
            f"its bar {mg['to_optimum']:.3f} (bar 1)")


def hold_first(kid, a, kw, B1, B3, B6, margin=False):
    """One recorded launch of B1, B3 or B6 against its plain version on the
    card, at TOL (B1: pn_hold's bars, ``margin`` as it takes it; B3, B6:
    the fields on the canvas less its 2K halo rows or layers at each end,
    as phase 2 holds B3).  A band's canvas may end
    inside the image: the kernel's windows carry the cells past it as zeros
    that evolve, the plain version holds them at zero, and the two part
    within the halo, which the driver refreshes before the next chunk.
    Returns the largest difference; fails the run past the bar."""
    import torch

    if kid == "B1":
        h = pn_hold(B1, *a, margin=margin, **kw)
        check(h["ok"], f"B1's first launch disagrees ({h['err']}, "
              f"{h['iters_apart']}; {margin_text(h['margin'])})")
        return h["err"]
    if kid == "B3":
        ref = B3.pdhg_chunk_plain(*a, **kw)
        out = B3.pdhg_chunk(*a, **kw)
        tol, fields = TOL["pdhg"], 4
    else:
        ref = B6.pdhg3d_chunk_plain(*a, **{k: v for k, v in kw.items()
                                           if k != "tile"})
        out = B6.pdhg3d_chunk(*a, **kw)
        tol, fields = TOL["pdhg3d"], 5
    torch.cuda.synchronize()
    h = 2 * kw["k_steps"]
    err = max(float((o[h:o.shape[0] - h] - r[h:r.shape[0] - h]).abs().max())
              for o, r in zip(out[:fields], ref[:fields]))
    check(err <= tol, f"{kid}'s first launch disagrees ({err})")
    # A certificate chunk (one image on one card): its gap and objective
    # sums as phase 3b holds them.
    for o, r in zip(out[fields:], ref[fields:]):
        rel = abs(float(o.sum()) - float(r.sum())) / max(1.0,
                                                         abs(float(r.sum())))
        check(rel <= TOL["pdhg_cert"], f"{kid}'s first launch's certificate "
              f"disagrees ({rel})")
    return err


def dist_line(world, backend, name, wall_ms, prof, comm, host_syncs,
              launches, card):
    return (f"[dist] world {world} {backend} {name}: wall {wall_ms:.3f} ms "
            f"(CUDA events), device busy {prof['busy_ms']:.3f} ms, idle "
            f"share {prof['idle_share']}; exchanges {comm['exchanges']}, "
            f"all-reduces {comm['all_reduces']}, gathers {comm['gathers']}, "
            f"bytes moved {comm['bytes_moved']}, staging copies "
            f"{comm['staging_copies']}, host syncs {host_syncs}, launches "
            f"{launches}  ({card})")


def dist_rank(rank, ddir, card):
    """One rank of the gloo world of DIST_WORLD ranks on cuda:0: the
    parallel path's calls on the inputs in ``ddir/inputs.npz``, each run
    counted (its first B1, B3 and B6 launch kept and held against the plain
    version), timed by CUDA events and profiled.  Rank 0 prints the
    ``[dist]`` lines and writes the outputs to ``ddir/world.npz``."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        raise Fail("torch.cuda.is_available() is false")
    sys.path.insert(0, REPO)
    from proxtv_tpu_torch import parallel as P
    from proxtv_tpu_torch.ops.kernels import pdhg3d_fused as B6
    from proxtv_tpu_torch.ops.kernels import pdhg_fused as B3
    from proxtv_tpu_torch.ops.kernels import pn_fused as B1
    from proxtv_tpu_torch.utils import debug

    dist.init_process_group("gloo", init_method=f"file://{ddir}/store",
                            rank=rank, world_size=DIST_WORLD)
    try:
        mesh = P.make_mesh()
        with np.load(os.path.join(ddir, "inputs.npz")) as f:
            d = {k: f[k] for k in f.files}
        counters = {"B1": B1.LAUNCHES, "B3": B3.LAUNCHES, "B6": B6.LAUNCHES}
        first = FirstLaunch(B1, B3, B6)
        out, lines = {}, []
        for i, (name, fn, must, _) in enumerate(dist_calls(P, mesh, d,
                                                           DIST_WORLD)):
            for c in counters.values():
                c.reset()
            debug.HOST_SYNCS.reset()
            comm_counts(debug, reset=True)
            with first:
                first.label = name
                res = fn()
                torch.cuda.synchronize()
                first.label = None
            comm = comm_counts(debug)
            syncs = debug.HOST_SYNCS.value
            got = {k: c.value for k, c in counters.items()}
            check_launches(got, must, f"rank {rank}: {name}")
            x, info = res
            out[f"x{i}"] = x.cpu().numpy()
            for f_ in ("iters", "gap", "rc"):
                out[f"{f_}{i}"] = getattr(info, f_).cpu().numpy()
            check(x.device == mesh.device and info.gap.device == mesh.device,
                  f"rank {rank}: {name} left the card")
            wall = cuda_ms(fn, reps=1)
            if rank == 0:
                # one window: rank 1 makes the same two calls, so a second
                # window would leave its collectives without a partner
                prof = profile_call(fn, windows=1)
            else:  # the same calls, for the collectives, unprofiled
                fn()
                fn()
                torch.cuda.synchronize()
            if rank:
                continue
            lines.append(dist_line(DIST_WORLD, "gloo", name, wall, prof, comm,
                                   syncs, got, card))
            out[f"wall{i}"] = np.array(wall)
            out[f"busy{i}"] = np.array(prof["busy_ms"])
            out[f"comm{i}"] = np.array([comm[k.lower()] for k in COMM])
            out[f"syncs{i}"] = np.array(syncs)
        holds = {}
        for (name, kid), (a, kw) in first.seen.items():
            holds[f"{name}: {kid}"] = err = hold_first(
                kid, a, kw, B1, B3, B6, margin=name == COLS_PI_NAME)
            lines.append(f"[dist] world {DIST_WORLD} rank {rank} {name}: "
                         f"first {kid} launch vs plain {err:.3e}")
        with open(os.path.join(ddir, f"holds{rank}.json"), "w") as f:
            json.dump(holds, f)
        if rank == 0:
            np.savez(os.path.join(ddir, "world.npz"), **out)
        print("\n".join(lines))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def train_cells(ny1, tgt1, ny2, tgt2):
    """The training cells on the card, on the seeded data of phase 3d:
    {name: (description, run, make)}.

    ``make()`` builds a cell's model and data state and returns
    ``(one, final)``: ``one()`` takes one step and returns its record and
    the step's forward output; ``final()`` (None for the one-VJP cell) runs
    a forward after the last step.  A record holds the loss (before the
    step's update), the forward and backward ms by CUDA events, and per
    half the B1, B3 and L1 launches (the wrappers' counters), the host syncs
    and the label-propagation trips; a 2D step fails the run unless its
    backward launched L1 once, with no label trip and no host sync.  ``run()`` takes a cell's steps and
    returns the records, the loss after the last step, the card's last
    forward output ``x`` and the cotangent ``g`` of the loss there.  Every
    step fails the run if its tensors leave the card or its forward misses
    its kernel."""
    import torch

    from proxtv_tpu_torch.models.layers import TVDenoise1D, TVDenoise2D
    from proxtv_tpu_torch.ops import diffprox
    from proxtv_tpu_torch.ops.kernels import labels as L1
    from proxtv_tpu_torch.ops.kernels import pdhg_fused as B3
    from proxtv_tpu_torch.ops.kernels import pn_fused as B1
    from proxtv_tpu_torch.utils import debug

    def mse(x, tgt):
        return torch.mean((x - tgt) ** 2)

    def on_card(*ts):
        check(all(v.is_cuda for v in ts), "a training step left the card")

    def counts():
        return {"B1": B1.LAUNCHES.value, "B3": B3.LAUNCHES.value,
                "L1": L1.LAUNCHES.value, "host_syncs": debug.HOST_SYNCS.value,
                "label_trips": diffprox.LABEL_TRIPS.value}

    def step(fwd, bwd, kid, labels=False):
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
        if labels:  # the 2D backward: one L1 launch, nothing on the host
            b_ = rec["bwd"]
            check(b_["L1"] == 1 and b_["label_trips"] == 0
                  and b_["host_syncs"] == 0,
                  f"a 2D backward on the card launched L1 {b_['L1']} times "
                  f"with {b_['label_trips']} label trips and "
                  f"{b_['host_syncs']} host syncs (want 1, 0, 0)")
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
                return step(fwd, bwd, "B1" if method == "dr" else "B3",
                            labels=True)

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


def bound_ms(nbytes, flops, peak_flop_s=PEAK_F32_FLOP_S):
    """The least time for the work: the bytes over the memory rate, the
    operations over the rate of their type (float32 unless given)."""
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_f = flops / peak_flop_s * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


# The most bytes of dense matrices torch.linalg.solve is given as B2's
# yardstick (its LU copies them once more).
DENSE_FIT_BYTES = 30e9


def pcr_library(rhs, mask=None, diag_shift=None):
    """B2's yardstick: ms of torch.linalg.solve on the dense (B, n, n) form
    of one launch's systems (``pcr.pcr_spd_solve_plain``'s: DD' plus the
    shift, masked rows identity rows with zero right-hand side, a coupling
    only between two unmasked rows), the matrices made outside the timed
    window; ``(ms, None)``, or ``(None, why)`` where they do not fit on the
    card.  The port never calls it."""
    import torch

    from proxtv_tpu_torch.ops.kernels import pcr

    B, n = rhs.shape
    need = B * n * n * rhs.element_size()
    if need > DENSE_FIT_BYTES:
        return None, (f"does not fit: {need / 1e9:.1f} GB of dense "
                      f"{rhs.dtype} matrices a launch")
    if mask is None:
        diag = torch.full_like(rhs, 2.0)
        if diag_shift is not None:
            diag = diag + diag_shift.to(rhs.dtype).reshape(-1, 1)
        off = torch.full((B, n - 1), -1.0, dtype=rhs.dtype,
                         device=rhs.device)
        r = rhs
    else:
        m = mask.to(rhs.dtype)
        diag, off, r = 1.0 + m, -(m[:, 1:] * m[:, :-1]), m * rhs
    A = (torch.diag_embed(diag) + torch.diag_embed(off, 1)
         + torch.diag_embed(off, -1))
    b = r.unsqueeze(-1)
    # Its first system in float64 against B2's float64 plain version.
    x = torch.linalg.solve(A[:1].double(), b[:1].double())[..., 0]
    ref = pcr.pcr_spd_solve_plain(
        rhs[:1].double(), mask=None if mask is None else mask[:1],
        diag_shift=None if diag_shift is None else diag_shift[:1].double())
    check(float((x - ref).abs().max()) <= 1e-8 * max(
        1.0, float(ref.abs().max())), "the dense yardstick solves another "
          "system than B2")
    ms = cuda_ms(lambda: torch.linalg.solve(A, b), target_s=0.3,
                 max_reps=50)
    del A, b
    torch.cuda.empty_cache()
    return ms, None


def obj2d(X, Y, lam):
    """The 2D TV-L1 prox objective of X for Y at lam, in float64."""
    X = X.astype(np.float64)
    return (0.5 * np.sum((X - Y) ** 2)
            + lam * (np.abs(np.diff(X, axis=0)).sum()
                     + np.abs(np.diff(X, axis=1)).sum()))


def obj_2dp(X, Y, lam, p):
    """The 2D TV-Lp prox objective (bench.py:_obj_2dp), in float64."""
    X = X.astype(np.float64)
    col = np.sum(np.sum(np.abs(np.diff(X, axis=0)) ** p, axis=0)
                 ** (1.0 / p))
    row = np.sum(np.sum(np.abs(np.diff(X, axis=1)) ** p, axis=1)
                 ** (1.0 / p))
    return 0.5 * np.sum((X - Y) ** 2) + lam * (col + row)


def obj3d(X, Y, lam):
    """The 3D TV-L1 prox objective of X for Y at lam on every axis, in
    float64."""
    X = X.astype(np.float64)
    return (0.5 * np.sum((X - Y) ** 2)
            + lam * sum(np.abs(np.diff(X, axis=a)).sum() for a in range(3)))


def obj_nd(X, Y, lam, ps):
    """The generalized TV prox objective of X for Y at lam on every axis,
    axis a penalized by the p = ps[a] norm of each fiber's differences,
    in float64."""
    X = X.astype(np.float64)
    return 0.5 * float(np.sum((X - Y) ** 2)) + lam * sum(
        float(np.sum(np.sum(np.abs(np.diff(X, axis=a)) ** p, axis=a)
                     ** (1.0 / p))) for a, p in enumerate(ps))


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
# D1-D4: the guards' pass (sum, difference, max, weight min: 5) plus one
# advance of every point, the least work any data needs (D1: two height
# updates, two wall tests, two tightening tests, one divide and add: 10;
# D2: the message's two sums, the two exits' clip bounds with a divide,
# the push, the backward clamp: 14; D3: the two excursions' sums (4), the
# two jump tests and the two touch tests: 8; D4: the majorant's and the
# minorant's merge tests (divide, multiply, compare: 6), the crossing test
# (two divides, a compare: 3), the tube's end: 1, 10).  Backtracks, jumps,
# pops and knots add to it.
TS_OPS_PER_POINT = 15
DP_OPS_PER_POINT = 19
CONDAT_OPS_PER_POINT = 13
CLASSIC_OPS_PER_POINT = 15
# L1: a pixel's right and down edges, a subtract, an abs and a compare
# each; the unions and the pointer chase add to it.
LABEL_OPS_PER_PIXEL = 6


def serpentine(M, N):
    """A float32 (M, N) image with one serpentine flat component: corridors
    of 0 on the even rows joined at alternate ends through walls of 1 on
    the odd rows (tests/torch_label_fields.py); and its labels: 0 on the
    path, each wall's first pixel's index on the wall."""
    X = np.zeros((M, N), np.float32)
    lab = np.zeros((M, N), np.int32)
    for r in range(1, M, 2):
        door = N - 1 if (r // 2) % 2 == 0 else 0
        X[r] = 1.0
        X[r, door] = 0.0
        if N > 1:
            lab[r] = r * N + (1 if door == 0 else 0)
            lab[r, door] = 0
    return X, lab


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


# A row of phase 7's table (:func:`_route64_table`).
Row64 = collections.namedtuple("Row64", "label call inputs kernels hold swept")


def _route64_table():
    """Phase 7's calls of the layers above TV-L1 (ROADMAP F6.1-F6.6), one
    table for the CPU references, the card's runs, the holds and the
    timings: key -> :class:`Row64`.  ``call(a, s)`` runs on the tensors
    ``a`` (start_cpu64's arrays named by ``inputs``, on the device they
    lie on: the card drives it, a CPU worker runs it as the card's
    reference) with ``s`` sweeps where ``swept``, and returns (x,
    SolverInfo or None); ``kernels``: the double kernels the call must
    launch on the card; ``hold``: how its result is held
    (``float64_phase``): "D2" against D2's float64 plain version,
    "phase3" against phase 3's float64 CPU run, the others against the
    same call in float64 on the CPU."""
    from proxtv_tpu_torch.models import tv2d, tvnd
    from proxtv_tpu_torch.ops import tv1d_l1, tv1d_l2, tv1d_lp

    def nd(a, s, ps):
        x, info = tvnd.tv_nd_batched(a[0][None], (LAM3,) * 3, (1, 2, 3), ps,
                                     method="pd", max_iters=s)
        return x[0], info

    vol = "{}x{}x{}".format
    b2 = ("B2.f64",)
    rows = {
        "dp": Row64(
            f"tv1_batched {B1D}x{N1D} lam {LAM1D} dp strict float64",
            lambda a, s: (tv1d_l1.tv1_batched(a[0], LAM1D, method="dp",
                                              strict=True), None),
            ("Y1",), ("D2.f64",), "D2", False),
        "dp per-edge": Row64(
            f"tv1_batched {BW}x{N1D} per-edge dp strict float64",
            lambda a, s: (tv1d_l1.tv1_batched(a[0], a[1], method="dp",
                                              strict=True), None),
            ("Ycon", "Ww"), ("D2.f64",), "D2", False),
        "tv2 ms": Row64(
            f"tv2_batched {B1D}x{N1D} lam {LAML2} ms float64",
            lambda a, s: tv1d_l2.tv2_batched(a[0], LAML2, method="ms"),
            ("Y1",), b2, "row", False),
        **{f"tvp p{p}": Row64(
            f"tvp_batched {BW}x{N1D} lam {LAMP} p {p} float64",
            lambda a, s, p=p: tv1d_lp.tvp_batched(a[0], LAMP, p),
            ("Ycon",), b2, "row", False) for p in PS},
        "tvp long": Row64(
            f"tvp_gpfw n=1e6 lam {LAMLONG} p {PLONG} float64 (setup past "
            "B2's lanes: no kernel)",
            lambda a, s: tv1d_lp.tvp_gpfw(a[0], LAMLONG, PLONG),
            ("ylong",), (), "row_long", False),
        "tvp_2d p2": Row64(
            f"tvp_2d_batched {M2D}^2 lam {LAM2D} p 2 float64",
            lambda a, s: tv2d.tvp_2d_batched(a[0], LAM2D, LAM2D, 2.0, 2.0),
            ("Y2",), b2, "phase3", False),
        "tvp_2d p1.5": Row64(
            f"tvp_2d_batched {M5}^2 lam {LAM2P} p {P2P} {ND_SWEEPS} sweeps "
            "float64", lambda a, s: tv2d.tvp_2d_batched(
                a[0], LAM2P, LAM2P, P2P, P2P, max_iters=s),
            ("Y5",), b2, "phase3", True),
        "tvp_2d p2 256": Row64(
            f"tvp_2d_batched {M64}^2 lam {LAM2D} p 2 float64",
            lambda a, s: tv2d.tvp_2d_batched(a[0], LAM2D, LAM2D, 2.0, 2.0),
            ("Y256",), b2, "combiner", False),
        "tvp_2d p1.5 256": Row64(
            f"tvp_2d_batched {M64}^2 lam {LAM2P} p {P2P} {ND_SWEEPS} sweeps "
            "float64", lambda a, s: tv2d.tvp_2d_batched(
                a[0], LAM2P, LAM2P, P2P, P2P, max_iters=s),
            ("Y256",), b2, "combiner", True),
    }
    for key, shape, name in (("", (L3, M3, N3), "V"),
                             (" small", V64_SMALL, "V_small")):
        rows["tvgen" + key] = Row64(
            f"tvgen pd {vol(*shape)} lam {LAM3} p 1 {ND_SWEEPS} sweeps "
            "float64", lambda a, s: tvnd.tvgen_dispatch(
                a[0], [LAM3] * 3, [1, 2, 3], [1] * 3, max_iters=s),
            (name,), b2, "combiner", True)
        rows["mixed" + key] = Row64(
            f"tv_nd_batched pd {vol(*shape)} lam {LAM3} p {PS_MIXED} "
            f"{ND_SWEEPS} sweeps float64",
            lambda a, s: nd(a, s, PS_MIXED), (name,), b2,
            "combiner_lp" + key.replace(" ", "_"), True)
    return rows


def _cpu_job(kind, *args):
    """One float64 reference on the CPU, in a worker process of the float64
    phase's pool: a direct engine's plain version (``tv1d_l1.<name>``) on
    (y, lam), the 2D dr solve, or a row of :func:`_route64_table` (``kind``
    "route", then its key, its arrays and the torch threads to use;
    returns x and, where the call gives one, the info's iters, gap and
    rc).  Returns its result as numpy arrays and its seconds."""
    sys.path.insert(0, REPO)
    import torch

    # The references yield the CPU to the process that drives the card.
    os.nice(19 - os.nice(0))
    torch.set_num_threads(1)
    from proxtv_tpu_torch.models import tv2d
    from proxtv_tpu_torch.ops import tv1d_l1

    t0 = time.perf_counter()
    if kind == "route":
        key, arrays, threads = args
        torch.set_num_threads(threads)
        x, info = _route64_table()[key].call(tuple(
            torch.from_numpy(np.ascontiguousarray(v)) for v in arrays),
            ND_SWEEPS)
        out = (x.numpy(),) + (() if info is None else tuple(
            v.numpy() for v in (info.iters, info.gap, info.rc)))
    elif kind == "dr":
        Y, lam = args
        x, info = tv2d.tv1_2d_batched(torch.from_numpy(Y), lam, method="dr")
        out = (x.numpy(), int(info.iters[0]), int(info.rc[0]),
               float(info.gap[0]))
    else:
        y, lam = args
        lam = torch.from_numpy(lam) if isinstance(lam, np.ndarray) else lam
        out = getattr(tv1d_l1, kind)(torch.from_numpy(y), lam).numpy()
    return out, time.perf_counter() - t0


_POOL = []  # the float64 phase's worker pool, stopped on every exit


def v64_small():
    """Phase 7's small volume, randn from a seed of its own: no other draw
    (the walks past each layout limit, whose lengths move with the
    kernels) comes before it."""
    return np.random.RandomState(SEED_V64_SMALL).randn(*V64_SMALL)


def start_cpu64(arrays, wmax, edges):
    """Start the float64 phase's CPU references in a pool of six worker
    processes, while the card runs the earlier phases: the ND rows at the
    bench's width first (two threads each; the slowest), then the plain
    versions of D1 and D2 (10000 x 1000), D3 and D4 (512 x 1000) at lam
    LAM1D on the main path's rows in float64, D2's on the
    per-edge-weighted 512 x 1000 batch, D4's on ROADMAP C's walk, D1, D3
    and D4 on two walks one past their float64 warp layouts (``wmax``), D4
    on one walk one past its float64 ring layout (``wmax["D4 thread"]``), dr
    on the 256^2 image, and every row of :func:`_route64_table` held
    against the CPU; and where D1's and D2's float64 layouts part
    (``edges``: the smallest batch of D1's layout for large batches, D2's
    largest batch of one warp a signal): D2 and D1 on the first rows of Y1
    to one past those batches, and D2 on the signal that overflows its
    ring (tools/dp_depths.py overflow_signal).  ``arrays``: the main
    path's Y1, Ww, ylong, Y2, Y5 and V.  Returns the float64 inputs and the
    pending results."""
    import multiprocessing

    rng = np.random.RandomState(SEED + 9)
    rng15 = np.random.RandomState(15)  # ROADMAP C's walk
    f64 = {k: np.asarray(v, np.float64) for k, v in arrays.items()}
    inp = {"Y1": f64["Y1"], "Ycon": f64["Y1"][:BW], "Ww": f64["Ww"],
           "ylong": f64["ylong"][None], "Y2": f64["Y2"][None],
           "Y5": f64["Y5"][None], "V": f64["V"],
           "Y256": rng.randn(1, M64, M64),
           "walk": (np.cumsum(rng15.randn(N_WALK64)) * 0.3
                    + rng15.randn(N_WALK64))[None]}
    for kid, n in wmax.items():
        if kid == "D4 thread":  # one signal, from its own seed
            r_ = np.random.RandomState(SEED + 10)
            inp["cross " + kid] = (r_.randn(1, n + 1) + np.cumsum(
                r_.randn(1, n + 1), axis=1) * 0.1)
            continue
        inp["cross " + kid] = (rng.randn(2, n + 1)
                               + np.cumsum(rng.randn(2, n + 1), axis=1) * 0.1)
    inp["V_small"] = v64_small()
    inp["cross D2 ring"] = np.linspace(0.0, 1.0, N1D)[None]
    pool = multiprocessing.get_context("spawn").Pool(6)
    _POOL.append(pool)
    rows = _route64_table()
    jobs = {}
    for key, threads in (("tvgen", 2), ("mixed", 2), ("tv2 ms", 1)):
        jobs[key] = pool.apply_async(_cpu_job, (  # the slowest first
            "route", key, [inp[k] for k in rows[key].inputs], threads))
    plain = {"D1": "tv1_tautstring_plain", "D3": "tv1_condat_plain",
             "D4": "tv1_classic_ts_plain"}
    jobs.update({
        "D2": pool.apply_async(_cpu_job, ("tv1_dp_plain", inp["Y1"], LAM1D)),
        "D2 edge": pool.apply_async(_cpu_job, ("tv1_dp_plain", inp["Ycon"],
                                               inp["Ww"])),
        "walk": pool.apply_async(_cpu_job, (plain["D4"], inp["walk"],
                                            LAM_WALK64)),
        "dr 256": pool.apply_async(_cpu_job, ("dr", inp["Y256"], LAM2D))})
    for key, row in rows.items():
        if key not in jobs and row.hold not in ("D2", "phase3"):
            jobs[key] = pool.apply_async(_cpu_job, (
                "route", key, [inp[k] for k in row.inputs], 1))
    jobs["cross D4 thread"] = pool.apply_async(
        _cpu_job, (plain["D4"], inp["cross D4 thread"], LAM1D))
    jobs["D2 rule"] = pool.apply_async(_cpu_job, (
        "tv1_dp_plain", inp["Y1"][:edges["D2 warp b"] + 1], LAM1D))
    jobs["D2 ring"] = pool.apply_async(_cpu_job, (
        "tv1_dp_plain", inp["cross D2 ring"], LAM_RING64))
    jobs["D1 rule"] = pool.apply_async(_cpu_job, (
        plain["D1"], inp["Y1"][:edges["D1 group b"]], LAM1D))
    for kid, name in plain.items():  # the slowest (D4) first
        jobs["cross " + kid] = pool.apply_async(
            _cpu_job, (name, inp["cross " + kid], LAM1D))
    for kid, y in (("D4", "Ycon"), ("D1", "Y1"), ("D3", "Ycon")):
        jobs[kid] = pool.apply_async(_cpu_job, (plain[kid], inp[y], LAM1D))
    return inp, jobs


def stop_pools():
    for pool in _POOL:
        pool.terminate()
        pool.join()
    _POOL.clear()


def float64_phase(card, inp, jobs, Y2, y1, x_ref, F_ref, x_dr32, more):
    """Phase 7: the float64 route on the card (the module docstring lists
    its calls).

    Drives, counting every kernel's launches per call (each
    instantiation's own counter: LAUNCHES in float32, LAUNCHES_F64 in
    float64) and with every kernel's plain version made to count any call
    on a CUDA tensor, the TV-L1 calls and then the layers above TV-L1
    (``more``: phase 3's inputs and float64 references).  Each call must
    launch its float64 kernels, no float32 kernel and no plain version on
    the card.  Then holds each double kernel at its main-path launches
    (and D1, D3, D4 one past their float64 warp layouts) against its
    float64 plain version, the outputs against float64 witnesses (TOL64),
    and times each double kernel through its wrapper and its C entry.
    Returns (kernels line entries, report, the outputs phase 8 reuses)."""
    import torch

    import shutil
    import tempfile

    import torch.distributed as dist

    from proxtv_tpu_torch import parallel
    from proxtv_tpu_torch.models import tv2d, tvnd
    from proxtv_tpu_torch.models.layers import TVDenoise2D
    from proxtv_tpu_torch.ops import diffprox, tv1d_l1, tv1d_long
    from proxtv_tpu_torch.ops.kernels import labels as L1
    from proxtv_tpu_torch.ops.kernels import pcr as B2
    from proxtv_tpu_torch.runtime import native
    from proxtv_tpu_torch.utils import debug
    from proxtv_tpu_torch.utils.config import CombinerConfig
    from proxtv_tpu_torch.utils.info import RC_OK

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    f64 = torch.float64
    D = {kid: kernel_module(kid) for kid in ("D1", "D2", "D3", "D4")}
    fns = {"D1": "tautstring", "D2": "dp", "D3": "condat",
           "D4": "classic_ts"}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    counters = launch_counters()
    plain_on_card = debug.Counter()
    b2_calls, l1_calls, tap_on = {}, [], [False]

    def tap_b2(rhs, mask=None, diag_shift=None):
        if tap_on[0] and rhs.dtype == f64:
            rec = b2_calls.setdefault(tuple(rhs.shape), [0, []])
            rec[0] += 1
            if len(rec[1]) < B2_KEEP:
                rec[1].append((rhs.clone(), None if mask is None
                               else mask.clone(), None if diag_shift is None
                               else diag_shift.clone()))
        return launch_b2(rhs, mask=mask, diag_shift=diag_shift)

    def tap_l1(X, tol):
        if tap_on[0] and X.dtype == f64:
            l1_calls.append((X.clone(), tol.clone()))
        return launch_l1(X, tol)

    saved = trip_plain(plain_on_card)
    launch_b2, launch_l1 = B2.pcr_spd_solve, L1.component_labels
    saved.append((B2, "pcr_spd_solve", launch_b2))
    saved.append((L1, "component_labels", launch_l1))
    B2.pcr_spd_solve, L1.component_labels = tap_b2, tap_l1
    calls, launches = {}, {k + ".f64": 0 for k in F64_KIDS}

    def run64(name, fn, must):
        for c in counters.values():
            c.reset()
        plain_on_card.reset()
        debug.HOST_SYNCS.reset()
        D["D2"].RING_RERUNS.reset()
        tap_on[0] = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        tap_on[0] = False
        got = {k: c.value for k, c in counters.items() if c.value}
        reruns = D["D2"].RING_RERUNS.value if "D2.f64" in got else 0
        calls[name] = {"seconds": sec, "launches": got,
                       "host_syncs": debug.HOST_SYNCS.value,
                       "plain_on_card": plain_on_card.value,
                       "d2_ring_reruns": reruns}
        print(f"[f64] {name}: {sec:.3f} s, launches {got}, host syncs "
              f"{debug.HOST_SYNCS.value}, plain versions on the card "
              f"{plain_on_card.value}"
              + (f", D2 ring reruns {reruns}" if "D2.f64" in got else ""))
        for k in must:
            check(got.get(k, 0) > 0, f"{name} did not launch {k}")
        check(all(k.endswith(".f64") and k in must for k in got),
              f"{name} launched {sorted(got)}, not only {must}")
        check(plain_on_card.value == 0,
              f"{name} ran a kernel's plain version on the card")
        for k in must:
            launches[k] += got[k]
        return res

    try:
        xs = {}
        Y1d, Ycon = t(inp["Y1"]), t(inp["Ycon"])
        walk = inp["walk"]
        xs["D1"] = run64(f"tv1_batched {B1D}x{N1D} lam {LAM1D} float64",
                         lambda: tv1d_l1.tv1_batched(Y1d, LAM1D), ["D1.f64"])
        xs["D3"] = run64(f"tv1_batched {BW}x{N1D} lam {LAM1D} condat strict "
                         "float64", lambda: tv1d_l1.tv1_batched(
                             Ycon, LAM1D, method="condat", strict=True),
                         ["D3.f64"])
        xs["D4"] = run64(f"tv1_batched {BW}x{N1D} lam {LAM1D} "
                         "classictautstring strict float64",
                         lambda: tv1d_l1.tv1_batched(
                             Ycon, LAM1D, method="classictautstring",
                             strict=True), ["D4.f64"])
        xs["walk"] = run64(f"tv1_batched walk n={N_WALK64} lam {LAM_WALK64} "
                           "classictautstring strict float64",
                           lambda: tv1d_l1.tv1_batched(
                               t(walk), LAM_WALK64,
                               method="classictautstring", strict=True),
                           ["D4.f64"])
        y1d = t(y1[None])
        x_pn, info_pn = run64(f"tv1_pn walk n={N1D} lam 2.0 float64",
                              lambda: tv1d_l1.tv1_pn(y1d, 2.0), ["B2.f64"])
        Y2d = t(Y2.astype(np.float64)[None])
        x_dr, info_dr = run64(f"tv1_2d_batched {M2D}^2 lam {LAM2D} dr "
                              "float64", lambda: tv2d.tv1_2d_batched(
                                  Y2d, LAM2D, method="dr"), ["B2.f64"])
        x_dr7, info_dr7 = run64(
            f"tv1_2d_batched {M2D}^2 lam {LAM2D} dr float64, mean change "
            "1e-7, max_iters 200", lambda: tv2d.tv1_2d_batched(
                Y2d, LAM2D, method="dr", max_iters=200,
                cfg=CombinerConfig(stop=1e-7)), ["B2.f64"])
        Y256 = t(inp["Y256"])
        x256 = {"dr": run64(f"tv1_2d_batched {M64}^2 lam {LAM2D} dr float64",
                            lambda: tv2d.tv1_2d_batched(Y256, LAM2D,
                                                        method="dr"),
                            ["B2.f64"])}
        for m in METHODS_2D:
            x256[m + " c"] = run64(
                f"tv1_2d_batched {M64}^2 lam {LAM2D} {m} float64, mean "
                f"change {STOP64}, max_iters {CAPS64[m]}",
                lambda m=m: tv2d.tv1_2d_batched(
                    Y256, LAM2D, method=m, max_iters=CAPS64[m],
                    cfg=CombinerConfig(stop=STOP64)),
                ["B2.f64"] if m in ("dr", "pd", "yang", "kolmogorov")
                else [])
        # -- the layers above TV-L1 (ROADMAP F6.1-F6.6) -----------------
        rows = _route64_table()
        arg = {name: t(v) for name, v in inp.items()
               if not name.startswith("cross ")}
        lay = {}  # key: (label, result)
        for key, row in rows.items():
            lay[key] = (row.label, run64(row.label, lambda c=row.call,
                                         n=row.inputs: c(tuple(
                                             arg[k] for k in n), ND_SWEEPS),
                                         list(row.kernels)))
        xs["D2"], xs["D2 edge"] = lay["dp"][1][0], lay["dp per-edge"][1][0]
        V64, ylong64 = arg["V"], arg["ylong"]
        b6 = kernel_module("B6").LAUNCHES.value
        try:
            tvnd.tv_nd_batched(V64[None], (LAM3,) * 3, (1, 2, 3), (1.0,) * 3,
                               method="chambolle-pock-acc")
            msg = None
        except ValueError as e:
            msg = str(e)
        print(f"[f64] tvgen_nd chambolle-pock-acc {L3}x{M3}x{N3} float64: "
              f"raises {msg!r}")
        check(msg is not None and "primal-dual ND methods need" in msg
              and kernel_module("B6").LAUNCHES.value == b6,
              "the float64 primal-dual ND method did not raise the JAX "
              "package's error")
        lay["long"] = (f"tv1_long n=1e6 lam {LAM1D} float64", run64(
            f"tv1_long n=1e6 lam {LAM1D} float64",
            lambda: tv1d_long.tv1_long(ylong64[0], LAM1D), ["B2.f64"]))
        ddir = tempfile.mkdtemp(prefix="proxtv_f64_")
        dist.init_process_group("gloo", init_method=f"file://{ddir}/store",
                                rank=0, world_size=1)
        try:
            mesh = parallel.make_mesh()
            lay["banded"] = (
                f"tv1_1d_banded n=1e6 lam {LAM1D} world 1 (gloo) float64",
                run64(f"tv1_1d_banded n=1e6 lam {LAM1D} world 1 (gloo) "
                      "float64", lambda: parallel.tv1_1d_banded(
                          ylong64[0], LAM1D, mesh), ["B2.f64"]))
        finally:
            dist.destroy_process_group()
            shutil.rmtree(ddir, ignore_errors=True)
        # T2 in float64: one gradient step of TVDenoise2D dr (the
        # reference's 35 sweeps) on the input and one chambolle-pock-acc
        # VJP, at 1024^2.
        ny2, tg2 = t(more["noisy_t2"].astype(np.float64)), t(
            more["truth_t2"].astype(np.float64))

        def t2_step(method, sweeps=ND_SWEEPS):
            layer = TVDenoise2D(init_lam=T2LAM, method=method, device=dev,
                                dtype=f64, max_iters=sweeps
                                if method == "dr" else 0)
            Yv = ny2.clone().requires_grad_(True)
            x = layer(Yv)
            (gY,) = torch.autograd.grad(torch.mean((x - tg2) ** 2), Yv)
            check(x.is_cuda and gY.is_cuda and x.dtype == f64,
                  "a float64 training step left the card or float64")
            return x.detach(), gY

        label = (f"train T2 TVDenoise2D dr {T2M}^2 {ND_SWEEPS} sweeps "
                 "float64, one gradient step")
        lay["T2"] = (label, run64(label, lambda: t2_step("dr"),
                                  ["B2.f64", "L1.f64"]))
        label = (f"train T2 TVDenoise2D chambolle-pock-acc {T2M}^2 float64, "
                 "one VJP")
        lay["T2 cp-acc"] = (label, run64(
            label, lambda: t2_step("chambolle-pock-acc"), ["L1.f64"]))
    finally:
        for mod, name, orig in reversed(saved):
            setattr(mod, name, orig)
    t_drive = time.perf_counter() - t_phase

    # -- holds ----------------------------------------------------------
    rep = {"calls": calls, "holds": {}}
    holds = rep["holds"]
    t0 = time.perf_counter()
    cpu = {k: j.get(timeout=900) for k, j in jobs.items()}
    t_wait = time.perf_counter() - t0

    def bit_hold(kid, y, out, ref, what, lam=LAM1D):
        """Bit for bit on the rows the guards do not take, within
        TOL64["direct_guard"] of max|y| on the rows they take."""
        out = out.cpu().numpy() if torch.is_tensor(out) else out
        n = y.shape[1]
        dy = np.abs(np.diff(y, axis=1)).max(axis=1)
        lmin = lam.min(axis=1) if np.ndim(lam) == 2 else lam
        deg = lmin >= (float(n) * n) * dy
        same = bool((out[~deg] == ref[~deg]).all())
        e = float(np.abs(out - ref).max()) / max(1.0, float(np.abs(y).max()))
        holds[f"{kid}.f64 {what}"] = {"bit_for_bit": same, "max_abs_err": e,
                                      "degenerate_rows": int(deg.sum())}
        print(f"[f64 {kid}] {what}: bit for bit with the float64 plain "
              f"version on {int((~deg).sum())} rows: {same}; max|kernel - "
              f"plain| / max|y| = {e:.3e} ({int(deg.sum())} degenerate rows)")
        check(same and e <= TOL64["direct_guard"],
              f"{kid}.f64 {what} disagrees with its plain version")
        return e

    err64 = {}
    for kid, key, y in (("D1", "D1", inp["Y1"]), ("D2", "D2", inp["Y1"]),
                        ("D2", "D2 edge", inp["Ycon"]),
                        ("D3", "D3", inp["Ycon"]),
                        ("D4", "D4", inp["Ycon"]),
                        ("D4", "walk", inp["walk"])):
        ref, _ = cpu[key]
        lam = {"walk": LAM_WALK64, "D2 edge": inp["Ww"]}.get(key, LAM1D)
        err64[key] = bit_hold(kid, y, xs[key], ref,
                              f"main path {y.shape[0]}x{y.shape[1]}"
                              + (" per-edge" if key == "D2 edge" else ""),
                              lam)
    wmax = {}
    for kid in ("D1", "D3", "D4"):
        y = inp["cross " + kid]
        wmax[kid] = D[kid].warp_max_n(f64)
        check(y.shape[1] == wmax[kid] + 1, "the crossing is not one past "
              f"{kid}'s float64 warp layout")
        out = getattr(D[kid], fns[kid])(t(y), LAM1D)
        torch.cuda.synchronize()
        ref, _ = cpu["cross " + kid]
        bit_hold(kid, y, out, ref, (
            f"ring layout {y.shape[0]}x{y.shape[1]} (warp layout to "
            f"{wmax[kid]}, ring to {D['D4'].ring_max_n()})"
            if kid == "D4" else f"thread layout {y.shape[0]}x{y.shape[1]} "
            f"(warp layout to {wmax[kid]})"))
    # D4's thread layout, one past its ring layout.
    y = inp["cross D4 thread"]
    check(y.shape[1] == D["D4"].ring_max_n() + 1, "the crossing is not "
          "one past D4's float64 ring layout")
    out = D["D4"].classic_ts(t(y), LAM1D)
    torch.cuda.synchronize()
    bit_hold("D4", y, out, cpu["cross D4 thread"][0],
             f"thread layout {y.shape[0]}x{y.shape[1]} (ring layout to "
             f"{D['D4'].ring_max_n()})")
    # D2 on each side of its float64 batch rule (one warp a signal to
    # warp_max_b signals, one signal a lane past it) and on the signal
    # whose deque outgrows its ring, alone and as a batch past the rule
    # (every copy runs again from the workspace: RING_RERUNS counts them).
    wb = D["D2"].warp_max_b()
    ref_rule = cpu["D2 rule"][0]
    for B_ in (wb, wb + 1):
        lay_ = D["D2"].layout(B_, N1D, False, f64)
        check((lay_ == "warp") == (B_ == wb),
              f"D2.f64 runs {B_} signals on its {lay_} layout")
        y = inp["Y1"][:B_]
        out = D["D2"].dp(t(y), LAM1D)
        torch.cuda.synchronize()
        bit_hold("D2", y, out, ref_rule[:B_], f"{lay_} layout {B_}x{N1D} "
                 f"(one warp a signal to {wb} signals)")
    ring = D["D2"].ring_slots()
    for B_ in (1, wb + 1):
        y = np.repeat(inp["cross D2 ring"], B_, axis=0)
        D["D2"].RING_RERUNS.reset()
        out = D["D2"].dp(t(y), LAM_RING64)
        torch.cuda.synchronize()
        reruns = D["D2"].RING_RERUNS.value
        lay_ = D["D2"].layout(B_, N1D, False, f64)
        what = (f"ring overflow {lay_} layout {B_}x{N1D} (a ramp at lam "
                f"{LAM_RING64}, past a ring of {ring})")
        bit_hold("D2", y, out, np.repeat(cpu["D2 ring"][0], B_, axis=0),
                 what, LAM_RING64)
        holds[f"D2.f64 {what}"]["ring_reruns"] = reruns
        print(f"[f64 D2] {what}: D2.RING_RERUNS {reruns} (signals run again "
              "from the workspace)")
        check(reruns == B_, f"D2.f64 {what}: {reruns} ring reruns, not {B_}")
    # D1 on each side of its float64 batch rule (one warp a signal, y
    # staged, below group_limits()'s batch; that many lanes a signal from
    # it, y read from global memory).
    g_l, g_b = D["D1"].group_limits()
    ref_rule = cpu["D1 rule"][0]
    for B_ in (g_b - 1, g_b):
        lanes = D["D1"].lanes(B_, N1D)
        check(lanes == (g_l if B_ >= g_b else 32),
              f"D1.f64 gives {B_}x{N1D} {lanes} lanes a signal")
        y = inp["Y1"][:B_]
        out = D["D1"].tautstring(t(y), LAM1D)
        torch.cuda.synchronize()
        bit_hold("D1", y, out, ref_rule[:B_],
                 f"{lanes} lanes a signal {B_}x{N1D} ({g_l} lanes from "
                 f"{g_b} signals)")
    check(native.available(), "the native host engine did not build")
    t0 = time.perf_counter()
    host = {"Y1": native.tv1_batch_host(inp["Y1"], LAM1D),
            "Ycon": native.tv1_batch_host(inp["Ycon"], LAM1D),
            "walk": native.tv1_host(walk[0], LAM_WALK64)[None]}
    t_host = time.perf_counter() - t0
    for name, x, y, key, bar in (
            ("tv1_batched (D1)", xs["D1"], inp["Y1"], "Y1", TOL64["host"]),
            ("condat strict (D3)", xs["D3"], inp["Ycon"], "Ycon",
             TOL64["host"]),
            ("classictautstring strict (D4)", xs["D4"], inp["Ycon"], "Ycon",
             TOL64["host"]),
            (f"classictautstring walk n={N_WALK64} (D4)", xs["walk"], walk,
             "walk", None)):
        e = float(np.abs(x.cpu().numpy() - host[key]).max())
        lim = TOL64["walk"] if bar is None else bar * max(
            1.0, float(np.abs(y).max()))
        holds[name + " vs host"] = {"max_abs_err": e, "bar": lim}
        print(f"[f64 check] {name} vs the float64 host taut string: "
              f"max|dx| = {e:.3e} (bar {lim:.3e})")
        check(e <= lim, f"{name} in float64 is {e} from the host engine")
    x_pn_ref, info_pn_ref = tv1d_l1.tv1_pn(torch.from_numpy(y1[None]), 2.0)
    e = float((x_pn.cpu() - x_pn_ref).abs().max())
    holds["tv1_pn vs CPU float64"] = {"max_abs_err": e,
                                      "iters": int(info_pn.iters[0]),
                                      "iters_cpu": int(info_pn_ref.iters[0])}
    print(f"[f64 check] tv1_pn n={N1D} vs the CPU's float64 tv1_pn: "
          f"max|dx| = {e:.3e} (bar {TOL64['pn']}), iterations "
          f"{int(info_pn.iters[0])} / {int(info_pn_ref.iters[0])}, rc "
          f"{int(info_pn.rc[0])}")
    check(e <= TOL64["pn"], "tv1_pn in float64 disagrees with the CPU")
    check(int(info_pn.rc[0]) == RC_OK, "tv1_pn in float64 did not certify")

    Y2d_np = Y2.astype(np.float64)
    fbar = 0.5 * XBAR ** 2 * M2D * N2D
    for name, x, info in (("dr (35 sweeps)", x_dr, info_dr),
                          ("dr, mean change 1e-7", x_dr7, info_dr7)):
        xn = x[0].cpu().numpy()
        check(np.isfinite(xn).all() and xn.shape == (M2D, N2D),
              f"dr {name}: bad output")
        dF = obj2d(xn, Y2d_np, LAM2D) - F_ref
        e = float(np.abs(xn - x_ref).max())
        holds[f"dr 1024^2 {name}"] = {
            "F_minus_F_ref": dF, "max_abs_err_ref": e,
            "iters": int(info.iters[0]), "rc": int(info.rc[0]),
            "delta": float(info.gap[0])}
        print(f"[f64 check] tv1_2d_batched {M2D}^2 {name}: certificate rc "
              f"{int(info.rc[0])}, {int(info.iters[0])} sweeps, last mean "
              f"change {float(info.gap[0]):.3e}; F - F_ref = {dF:.4e}, "
              f"max|x - x_ref| = {e:.3e} (x_ref: float64 Chambolle-Pock on "
              "the card)")
    e32 = float(np.abs(x_dr[0].cpu().numpy() - x_dr32).max())
    holds["dr 1024^2 float64 vs float32"] = {"max_abs_err": e32}
    print(f"[f64 check] dr {M2D}^2 35 sweeps, float64 vs float32 on the "
          f"card: max|dx| = {e32:.3e}")
    check(int(info_dr7.rc[0]) == RC_OK,
          "dr in float64 did not certify at mean change 1e-7")
    dF7 = holds["dr 1024^2 dr, mean change 1e-7"]["F_minus_F_ref"]
    check(dF7 <= fbar, f"dr float64: F - F_ref = {dF7} over the objective "
          f"form of the bar ({fbar})")
    (x_c, it_c, rc_c, gap_c), s_c = cpu["dr 256"]
    x_g = x256["dr"][0].cpu().numpy()
    it_g, rc_g = int(x256["dr"][1].iters[0]), int(x256["dr"][1].rc[0])
    e = float(np.abs(x_g - x_c).max())
    holds["dr 256^2 vs CPU"] = {"max_abs_err": e, "card": [it_g, rc_g,
                                float(x256["dr"][1].gap[0])],
                                "cpu": [it_c, rc_c, gap_c]}
    print(f"[f64 check] dr {M64}^2 on the card vs the same call in float64 on "
          f"the CPU ({s_c:.1f} s there): max|dx| = {e:.3e} (bar "
          f"{TOL64['dr_cpu']}); certificates: card {it_g} sweeps rc {rc_g} "
          f"mean change {float(x256['dr'][1].gap[0]):.3e}, CPU {it_c} sweeps "
          f"rc {rc_c} mean change {gap_c:.3e}")
    check(e <= TOL64["dr_cpu"], "dr 256^2 in float64 disagrees with the CPU")
    base = x256["dr c"][0].cpu().numpy()
    x_r, gap_r = reference_2d(Y256[0], LAM2D, 24000)
    x_r = x_r.cpu().numpy()
    holds["256^2 float64 reference"] = {"gap": gap_r}
    for m in METHODS_2D:
        xm, info = x256[m + " c"]
        xm = xm[0].cpu().numpy()
        e = float(np.abs(xm - base).max())
        e_r = float(np.abs(xm - x_r).max())
        holds[f"{m} 256^2 vs dr"] = {"max_abs_err": e,
                                     "max_abs_err_ref": e_r,
                                     "iters": int(info.iters[0]),
                                     "rc": int(info.rc[0])}
        print(f"[f64 check] {m} {M64}^2 (mean change {STOP64}, cap "
              f"{CAPS64[m]}: {int(info.iters[0])} iterations, rc "
              f"{int(info.rc[0])}) "
              f"vs dr at mean change {STOP64}: max|dx| = {e:.3e} (bar "
              f"{XBAR}); vs 24000 float64 Chambolle-Pock iterations on the "
              f"card (gap {gap_r:.2e}): {e_r:.3e}")
        check(np.isfinite(xm).all() and e <= XBAR,
              f"{m} in float64 is {e} from dr")

    # -- the layers above TV-L1: held ------------------------------------
    parted = {}

    def scale_of(y):
        return max(1.0, float(np.abs(y).max()))

    def row_hold(key, tol):
        """A TV-L2 / TV-Lp row against the same route in float64 on the
        CPU: within ``tol`` of max|y| where both took the same iterations,
        within the two sides' certified gaps (sqrt(2 g) each, plus that
        bar) where the counts part at the stop tolerance."""
        label, (x, info) = lay[key]
        (x_c, it_c, gap_c, rc_c), s_c = cpu[key]
        x_g = np.atleast_2d(x.cpu().numpy())
        it_g, gap_g, rc_g = (v.cpu().numpy() for v in (info.iters, info.gap,
                                                       info.rc))
        base = tol * scale_of(inp[rows[key].inputs[0]])
        d = np.abs(x_g - np.atleast_2d(x_c)).max(axis=1)
        part = it_g != it_c
        cert = (np.sqrt(2 * np.maximum(gap_g, 0.0))
                + np.sqrt(2 * np.maximum(gap_c, 0.0)))
        bar = base + np.where(part, cert, 0.0)
        parted[key] = int(part.sum())
        e = float(d.max())
        holds[label + " vs CPU"] = {
            "max_abs_err": e, "bar": base,
            "bar_parting_rows": float(bar[part].max()) if part.any()
            else None, "max_abs_err_parting_rows": float(d[part].max())
            if part.any() else None,
            "rows_parting": int(part.sum()), "iters_max": int(it_g.max()),
            "iters_max_cpu": int(it_c.max()), "rc_card": int(rc_g.max()),
            "rc_cpu": int(rc_c.max()), "cpu_s": s_c}
        print(f"[f64 check] {label} vs the same route in float64 on the CPU "
              f"({s_c:.1f} s there): max|dx| = {e:.3e} (bar {base:.3e}); rows "
              f"whose iteration count parts at the stop tolerance: "
              f"{int(part.sum())} of {len(part)}"
              + (f" (held by both sides' certified gaps, bar up to "
                 f"{float(bar[part].max()):.3e})" if part.any() else "")
              + f"; iterations max card {int(it_g.max())} / CPU "
              f"{int(it_c.max())}; rc max {int(rc_g.max())} / "
              f"{int(rc_c.max())}")
        check(bool(np.all(d <= bar)) and bool(np.all(rc_g[~part]
                                                      == rc_c[~part])),
              f"{label} disagrees with the same route on the CPU")

    def combiner_hold(key):
        """A 2D or ND combiner call against the same call in float64 on
        the CPU: x within TOL64["combiner"] of max|y|, or, with a TV-Lp
        term in ND, the objective within TOL64["combiner_lp_F"] relative,
        dx's root mean square within TOL64["combiner_lp_rms"] and x within
        TOL64["combiner_lp_max"] of max|y|; on the small volume
        ("combiner_lp_small") dx's root mean square and x alone, within
        TOL64["combiner_lp_small_rms"] and ["combiner_lp_small_max"]."""
        label, (x, info) = lay[key]
        (x_c, it_c, _, rc_c), s_c = cpu[key]
        y = inp[rows[key].inputs[0]]
        x_g = x.cpu().numpy()
        dx = x_g - x_c if x_g.shape == x_c.shape else np.inf
        e = float(np.abs(dx).max())
        rec = {"max_abs_err": e, "rms": float(np.sqrt(np.mean(dx * dx))),
               "iters": int(info.iters.max()), "iters_cpu": int(np.max(it_c)),
               "rc": int(info.rc.max()), "rc_cpu": int(np.max(rc_c)),
               "mean_change": float(info.gap.max()), "cpu_s": s_c}
        ok = bool(np.isfinite(x_g).all())
        if rows[key].hold == "combiner":
            rec["bar"] = TOL64["combiner"] * scale_of(y)
            text = f"max|dx| = {e:.3e} (bar {rec['bar']:.3e})"
            ok = ok and e <= rec["bar"]
        else:
            hold = rows[key].hold
            F_c = obj_nd(x_c, y, LAM3, PS_MIXED)
            rec.update(dF_over_F=(obj_nd(x_g, y, LAM3, PS_MIXED) - F_c)
                       / abs(F_c),
                       bar_F=None if hold.endswith("small")
                       else TOL64["combiner_lp_F"],
                       bar_rms=TOL64[hold + "_rms"] * scale_of(y),
                       bar=TOL64[hold + "_max"] * scale_of(y))
            text = (f"(F - F_cpu) / F_cpu = {rec['dF_over_F']:.3e} (bar "
                    f"{rec['bar_F']}), rms(dx) = {rec['rms']:.3e} (bar "
                    f"{rec['bar_rms']:.3e}), max|dx| = {e:.3e} (bar "
                    f"{rec['bar']:.3e})")
            ok = ok and (rec["bar_F"] is None
                         or abs(rec["dF_over_F"]) <= rec["bar_F"]) \
                and rec["rms"] <= rec["bar_rms"] and e <= rec["bar"]
        holds[label + " vs CPU"] = rec
        if rows[key].hold == "combiner":
            text += f", rms(dx) = {rec['rms']:.3e}"
        print(f"[f64 check] {label} vs the same call in float64 on the CPU "
              f"({s_c:.1f} s there): {text}; "
              f"sweeps card {rec['iters']} / CPU {rec['iters_cpu']}, rc "
              f"{rec['rc']} / {rec['rc_cpu']}, last mean change "
              f"{rec['mean_change']:.3e}")
        check(ok, f"{label} disagrees with the same call on the CPU")

    for key, row in rows.items():
        if row.hold in ("row", "row_long"):
            row_hold(key, TOL64["route" if row.hold == "row"
                                else "route_long"])
        elif row.hold.startswith("combiner"):
            combiner_hold(key)
    # tvgen at the bench's width also against phase 3's float64 3D
    # reference, which bounds the optimum from below (F* >= F_ref -
    # gap_ref): 35 sweeps of Parallel Dykstra stop short of it, as phase
    # 3's float32 run does.
    label, (x, _) = lay["tvgen"]
    dF = obj3d(x.cpu().numpy(), more["V"], LAM3) - more["F3_ref"]
    holds[label + " vs the 3D reference"] = {"F_minus_F_ref": dF}
    print(f"[f64 check] {label}: F - F_ref = {dF:.4e} (at least "
          f"-{more['gap_ref3']:.2e}; phase 3's float32 run at 35 sweeps: "
          f"{more['dF_gen32']:.4e})")
    check(dF >= -(more["gap_ref3"] + F_ROUND * more["F3_ref"]),
          f"{label} lies below the optimum's certificate")
    # At the bench's width the 2D calls by their certificates (the sweeps
    # and last mean change, printed) and by their objective against phase
    # 3's float64 CPU run of the same call, within the objective form of
    # the cross-method bar (F is 1-strongly convex: 0.5 XBAR^2 M N).
    for key, ref, y, lam, p in (
            ("tvp_2d p2", more["x_p2_ref"], Y2, LAM2D, 2.0),
            ("tvp_2d p1.5", more["x_2p_ref"], more["Y5"], LAM2P, P2P)):
        label, (x, info) = lay[key]
        xn = x[0].cpu().numpy()
        yd = y.astype(np.float64)
        dF = obj_2dp(xn, yd, lam, p) - obj_2dp(ref, yd, lam, p)
        fbar_ = 0.5 * XBAR ** 2 * xn.size
        e = float(np.abs(xn - ref).max())
        holds[label] = {"F_minus_F_cpu": dF, "bar": fbar_,
                        "max_abs_err_cpu": e, "iters": int(info.iters[0]),
                        "rc": int(info.rc[0]),
                        "mean_change": float(info.gap[0])}
        print(f"[f64 check] {label}: {int(info.iters[0])} sweeps, rc "
              f"{int(info.rc[0])}, last mean change {float(info.gap[0]):.3e}"
              f"; F - F(phase 3's float64 CPU run) = {dF:.4e} (bar "
              f"{fbar_:.3e}), max|dx| = {e:.3e}")
        check(np.isfinite(xn).all() and abs(dF) <= fbar_,
              f"{label} misses its certificate")
    for key in ("long", "banded"):
        label, (x, info) = lay[key]
        xn = x.cpu().numpy().reshape(-1)
        g = float(info.gap[0])
        e = float(np.abs(xn - more["xl1_ref"]).max())
        bar = math.sqrt(2 * max(g, 0.0)) + TOL64["host"] * float(
            np.abs(inp["ylong"]).max())
        holds[label + " vs host"] = {"max_abs_err": e, "gap": g, "bar": bar,
                                     "rc": int(info.rc[0]),
                                     "iters": int(info.iters[0])}
        print(f"[f64 check] {label}: certified by its glue's gap {g:.4e} "
              f"(rc {int(info.rc[0])}); max|x - x_host64| = {e:.3e} (bar "
              f"sqrt(2 gap) = {bar:.3e}; float32 lands 2.1e-6 away)")
        check(int(info.rc[0]) == RC_OK and e <= bar,
              f"{label} misses its certificate")
    # T2 in float64: L1.f64's labels bit for bit with the plain version on
    # the same solutions, the backward against float64 on the CPU.
    truth64 = torch.from_numpy(more["truth_t2"].astype(np.float64))
    for key in ("T2", "T2 cp-acc"):
        label, (x, gY) = lay[key]
        xc_ = x.cpu()
        g_c = 2 * (xc_ - truth64) / xc_.numel()
        ref = diffprox._bwd2(xc_, g_c)
        e = float((gY.cpu() - ref).abs().max()) / float(ref.abs().max())
        holds[label + " backward vs CPU"] = {"rel_err": e}
        print(f"[f64 check] {label}: backward vs float64 on the CPU (on the "
              f"card's forward output): max|dgY| / max|gY| = {e:.3e} (bar "
              f"{TOL64['backward']})")
        check(e <= TOL64["backward"], f"{label}: the backward disagrees")
    print(f"[f64] rows held by certified gaps (their iteration counts part "
          f"at the stop tolerance): {sum(parted.values())} ({parted})")
    rep["rows_parting"] = parted

    # -- B2.f64 at its main-path launches: held and timed ---------------
    kern = []
    for (Bs, ns), (count, kept) in sorted(b2_calls.items()):
        worst = 0.0
        launchers = []
        for r_, m_, s_ in kept:
            ref = B2.pcr_spd_solve_plain(r_, mask=m_, diag_shift=s_)
            out = B2.pcr_spd_solve(r_, mask=m_, diag_shift=s_)
            worst = max(worst, float((out - ref).abs().max())
                        / max(1e-300, float(ref.abs().max())))
            o2, launch = B2.bind(r_, mask=m_, diag_shift=s_)
            launch()
            torch.cuda.synchronize()
            check(bool(torch.equal(o2, out)),
                  "B2.f64's C entry point and its wrapper disagree")
            launchers.append(launch)
        print(f"[f64 B2] main path {Bs}x{ns} ({count} launches, {len(kept)} "
              f"held, layout {B2.layout_f64(ns)}): max|kernel - plain| / "
              f"max|plain| = {worst:.3e} (bar {TOL64['pcr']})")
        check(worst <= TOL64["pcr"], f"B2.f64 {Bs}x{ns} disagrees")

        def replay(fn, kept=kept):
            for r_, m_, s_ in kept:
                fn(r_, mask=m_, diag_shift=s_)

        def replay_c(launchers=launchers):
            for launch in launchers:
                launch()

        ms = cuda_ms(lambda: replay(B2.pcr_spd_solve)) / len(kept)
        kernel_ms = cuda_ms(replay_c) / len(kept)
        plain_ms = cuda_ms(lambda: replay(B2.pcr_spd_solve_plain),
                           reps=3) / len(kept)
        nbytes = sum(Bs * ns * 16 + (Bs * ns if m_ is not None else 0)
                     + (Bs * 8 if s_ is not None else 0)
                     for _, m_, s_ in kept) / len(kept)
        b, f = bound_ms(nbytes, Bs * ns * TRIDIAG_OPS, PEAK_F64_FLOP_S)
        lib_ms, lib_note = pcr_library(*kept[0])
        kern.append(dict(
            name=f"B2.f64 pcr_spd_solve_f64 ({Bs}x{ns})", route="cuda",
            source="proxtv_tpu_torch/csrc/pcr.cu",
            replaces="proxtv_tpu/ops/kernels/pcr.py:100",
            launches=count, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
            bound_ms=b, bound_by=f, library_ms=lib_ms, library_note=lib_note,
            library_call="torch.linalg.solve, dense, first launch",
            kernel_ms=kernel_ms, dtype="float64", layout=B2.layout_f64(ns)))
    check(sum(k_["launches"] for k_ in kern) == launches["B2.f64"],
          "the B2.f64 tap missed main-path launches")

    # -- D1.f64-D4.f64: timed at their main-path shapes -------------------
    ops_pp = {"D1": TS_OPS_PER_POINT, "D2": DP_OPS_PER_POINT,
              "D3": CONDAT_OPS_PER_POINT, "D4": CLASSIC_OPS_PER_POINT}
    line = {"D1": 334, "D2": 632, "D3": 468, "D4": 854}
    for kid, key, y, lam, what in (
            ("D1", "D1", Y1d, LAM1D, f"{B1D}x{N1D} scalar"),
            ("D2", "D2", Y1d, LAM1D, f"{B1D}x{N1D} scalar"),
            ("D2", "D2 edge", Ycon, arg["Ww"], f"{BW}x{N1D} per-edge"),
            ("D3", "D3", Ycon, LAM1D, f"{BW}x{N1D} scalar"),
            ("D4", "D4", Ycon, LAM1D, f"{BW}x{N1D} scalar"),
            ("D4", "walk", t(walk), LAM_WALK64, f"1x{N_WALK64} scalar")):
        mod, fn = D[kid], getattr(D[kid], fns[kid])
        out, launch = mod.bind(y, lam)
        launch()
        torch.cuda.synchronize()
        check(bool(torch.equal(out, fn(y, lam))),
              f"{kid}.f64's C entry point and its wrapper disagree")
        ms = cuda_ms(lambda: fn(y, lam))
        kernel_ms = cuda_ms(launch)
        Bs, ns = y.shape
        lam_bytes = Bs * (ns - 1) * 8 if torch.is_tensor(lam) else 0
        b, f = bound_ms(Bs * ns * 16 + lam_bytes, Bs * ns * ops_pp[kid],
                        PEAK_F64_FLOP_S)
        src = {"D1": "tautstring", "D2": "dp", "D3": "condat",
               "D4": "classic_ts"}[kid]
        if kid == "D2":
            what += f", {D['D2'].layout(Bs, ns, torch.is_tensor(lam), f64)} "
            what += "layout"
        if kid == "D1":
            what += f", {D['D1'].lanes(Bs, ns)} lanes a signal"
        if kid == "D4":
            what += (", warp layout" if ns <= D["D4"].warp_max_n(f64)
                     else ", ring layout" if ns <= D["D4"].ring_max_n()
                     else ", thread layout")
        kern.append(dict(
            name=f"{kid}.f64 {fns[kid]}_tv1_f64 ({what})",
            route="cuda", source=f"proxtv_tpu_torch/csrc/{src}.cu",
            replaces=f"proxtv_tpu/ops/tv1d_l1.py:{line[kid]} (XLA lock-step "
                     "scan; no TPU kernel)",
            launches=1, max_abs_err=err64[key], ms=ms,
            plain_ms=cpu[key][1] * 1e3, plain_device="cpu", bound_ms=b,
            bound_by=f, library_ms=None, kernel_ms=kernel_ms,
            dtype="float64"))
    # -- L1.f64 at its main-path launches (the T2 backwards): held bit for
    # bit against the plain version on the card, timed through the wrapper
    # and the C entry; bound: X read and the labels written, 12 bytes a
    # pixel.
    l1_shapes = {}
    for X_, tol_ in l1_calls:
        l1_shapes.setdefault(tuple(X_.shape), []).append((X_, tol_))
    for (Bs, Ms, Ns), got in l1_shapes.items():
        launchers, plain_s, same = [], 0.0, True
        for X_, tol_ in got:
            out = L1.component_labels(X_, tol_)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = L1.component_labels_plain(X_, tol_)
            torch.cuda.synchronize()
            plain_s += time.perf_counter() - t0
            same = same and bool(torch.equal(out, ref))
            lab_, launch = L1.bind(X_, tol_)
            launch()
            torch.cuda.synchronize()
            check(bool(torch.equal(lab_, out)),
                  "L1.f64's C entry point and its wrapper disagree")
            launchers.append(launch)
        print(f"[f64 L1] main path {Bs}x{Ms}x{Ns} ({len(got)} launches): "
              f"labels bit for bit with the float64 plain version: {same}")
        check(same, f"L1.f64 {Bs}x{Ms}x{Ns} parts from its plain version")
        ms = cuda_ms(lambda got=got: [L1.component_labels(*c_)
                                      for c_ in got]) / len(got)
        kernel_ms = cuda_ms(lambda ls=launchers: [l_() for l_ in ls]) / len(
            got)
        px = Bs * Ms * Ns
        b, f = bound_ms(px * 12, px * LABEL_OPS_PER_PIXEL, PEAK_F64_FLOP_S)
        kern.append(dict(
            name=f"L1.f64 component_labels_f64 ({Bs}x{Ms}x{Ns})",
            route="cuda", source="proxtv_tpu_torch/csrc/labels.cu",
            replaces="proxtv_tpu/ops/diffprox.py:105 (XLA while_loop; no "
                     "TPU kernel)", launches=len(got), max_abs_err=0.0,
            ms=ms, plain_ms=plain_s * 1e3 / len(got), bound_ms=b,
            bound_by=f, library_ms=None, kernel_ms=kernel_ms,
            dtype="float64"))
    for kid in ("D1", "D2", "D3", "D4", "L1"):
        n_kern = sum(k_["launches"] for k_ in kern
                     if k_["name"].startswith(kid + ".f64 "))
        check(n_kern == launches[kid + ".f64"],
              f"{kid}.f64: {n_kern} timed launches, "
              f"{launches[kid + '.f64']} on the path")
    for k_ in kern:
        lib = ("" if "library_call" not in k_ else
               f", torch.linalg.solve {k_['library_ms']:.4f} ms"
               if k_["library_ms"] is not None else
               f", torch.linalg.solve {k_['library_note']}")
        print(f"[f64 time] {k_['name']}: wrapper {k_['ms']:.4f} ms, C entry "
              f"{k_['kernel_ms']:.4f} ms, bound {k_['bound_ms']:.6f} ms "
              f"({k_['bound_by']}){lib}, plain "
              + f"{k_['plain_ms']:.1f} ms"
              + (" (CPU)" if k_.get("plain_device") == "cpu" else "")
              + f", launches {k_['launches']}  ({card})")
    # Wall of each float64 main-path call by CUDA events (name: call,
    # repetitions), and the device's share of it (one profiled call each).
    timed = {
        "tv1_batched 10000x1000 D1.f64": (lambda: tv1d_l1.tv1_batched(
            Y1d, LAM1D), 20),
        "tv1_batched 512x1000 condat D3.f64": (lambda: tv1d_l1.tv1_batched(
            Ycon, LAM1D, method="condat", strict=True), 20),
        "tv1_batched 512x1000 classictautstring D4.f64": (
            lambda: tv1d_l1.tv1_batched(Ycon, LAM1D,
                                        method="classictautstring",
                                        strict=True), 20),
        "tv1_pn n=1000 B2.f64": (lambda: tv1d_l1.tv1_pn(y1d, 2.0), 20),
        "tv1_2d_batched 1024^2 dr B2.f64": (lambda: tv2d.tv1_2d_batched(
            Y2d, LAM2D, method="dr"), 3),
    }
    # The table's calls at the bench's width (the slowest take seconds),
    # each profiled in a window of PROFILE_SWEEPS sweeps where the call's
    # depth is its sweeps.
    short = {}
    for row in rows.values():
        if row.inputs[0] not in ("Y256", "V_small"):
            a_ = tuple(arg[k] for k in row.inputs)
            timed[row.label] = (lambda c=row.call, a_=a_: c(a_, ND_SWEEPS),
                                20 if row.hold == "D2" else 1)
            if row.swept:
                short[row.label] = lambda c=row.call, a_=a_: c(
                    a_, PROFILE_SWEEPS)
    timed[lay["long"][0]] = (lambda: tv1d_long.tv1_long(ylong64[0], LAM1D),
                             1)
    timed[lay["T2"][0]] = (lambda: t2_step("dr"), 1)
    short[lay["T2"][0]] = lambda: t2_step("dr", PROFILE_SWEEPS)
    timed[lay["T2 cp-acc"][0]] = (lambda: t2_step("chambolle-pock-acc"), 1)
    walls = {}
    for name, (fn, reps) in timed.items():
        ms_ = cuda_ms(fn, reps=reps)
        prof = profile_call(short.get(name, fn), windows=1)
        walls[name] = {"ms": ms_, "profile": prof, "profile_sweeps":
                       PROFILE_SWEEPS if name in short else None}
        busy = prof["busy_ms"]
        busy = busy if isinstance(busy, str) else f"{busy:.3f}"
        print(f"[f64 time] {name}: {ms_:.4f} ms by CUDA events; profiled "
              + (f"at {PROFILE_SWEEPS} sweeps: " if name in short else "")
              + f"wall {prof['wall_ms']:.3f} ms, device busy {busy} ms, "
              f"idle share {prof['idle_share']}  ({card})")
    rep.update(walls=walls, seconds={
        "drive": t_drive, "wait_cpu": t_wait, "host_engine": t_host,
        "cpu_jobs": {k: v[1] for k, v in cpu.items()},
        "phase": time.perf_counter() - t_phase})
    print(f"[f64] phase: {rep['seconds']['phase']:.1f} s (driving "
          f"{t_drive:.1f} s, then waiting {t_wait:.1f} s for the CPU "
          "references, which ran in six worker processes beside the "
          "earlier phases)")
    outs = {"dr": x_dr[0], "pn": x_pn[0], "long": lay["long"][1][0],
            "tvgen": lay["tvgen"][1][0],
            **{k: lay[k][1][0][0] for k in ("tvp_2d p2", "tvp_2d p1.5")}}
    return kern, rep, outs


def direct64_api_kernels(card, y1, ww1, rep):
    """The kernels line's entries of D1.f64 and D2.f64 at phase 8's
    single-signal launches (``tv1_1d`` auto and dp on the walk y1 at lam
    2.0, ``tv1w_1d`` auto and dp with the weights ww1): each C entry held
    bit for bit against the float64 plain version on the CPU, then timed
    with its wrapper by CUDA events; launches: phase 8's counted call of
    the API row (``rep``, api64_phase's report)."""
    import torch

    from proxtv_tpu_torch.ops import tv1d_l1

    dev = torch.device("cuda")
    kern = []
    y = torch.from_numpy(np.asarray(y1, np.float64)[None]).to(dev)
    w = torch.from_numpy(np.asarray(ww1, np.float64)[None]).to(dev)
    for kid, mod, fn, plain, lam, label in (
            ("D1", kernel_module("D1"), "tautstring", "tv1_tautstring_plain",
             2.0, f"api.tv1_1d n={N1D} w 2.0 auto"),
            ("D1", kernel_module("D1"), "tautstring", "tv1_tautstring_plain",
             w, f"api.tv1w_1d n={N1D} auto"),
            ("D2", kernel_module("D2"), "dp", "tv1_dp_plain", 2.0,
             f"api.tv1_1d n={N1D} w 2.0 dp"),
            ("D2", kernel_module("D2"), "dp", "tv1_dp_plain", w,
             f"api.tv1w_1d n={N1D} dp")):
        launches = rep["calls"][label]["launches"].get(kid + ".f64", 0)
        out, launch = mod.bind(y, lam)
        launch()
        torch.cuda.synchronize()
        lam_c = lam.cpu() if torch.is_tensor(lam) else lam
        t0 = time.perf_counter()
        ref = getattr(tv1d_l1, plain)(y.cpu(), lam_c)
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((out.cpu() - ref).abs().max())
        wrap = getattr(mod, fn)
        ms = cuda_ms(lambda: wrap(y, lam))
        kernel_ms = cuda_ms(launch)
        edge = torch.is_tensor(lam)
        b, f = bound_ms(N1D * 16 + ((N1D - 1) * 8 if edge else 0),
                        N1D * (TS_OPS_PER_POINT if kid == "D1"
                               else DP_OPS_PER_POINT), PEAK_F64_FLOP_S)
        what = (f"1x{N1D} {'per-edge' if edge else 'scalar'}, " + (
            f"{mod.lanes(1, N1D)} lanes a signal" if kid == "D1"
            else f"{mod.layout(1, N1D, edge, torch.float64)} layout")
            + f", phase 8 {label}")
        print(f"[f64 {kid}] {what}: bit for bit with the float64 plain "
              f"version: {err == 0.0}; wrapper {ms:.4f} ms, C entry "
              f"{kernel_ms:.4f} ms, bound {b:.7f} ms ({f}), launches "
              f"{launches}  ({card})")
        check(err == 0.0, f"{kid}.f64 {what} parts from its plain version")
        check(launches == 1, f"{label} launched {kid}.f64 {launches} times")
        kern.append(dict(
            name=f"{kid}.f64 {fn}_tv1_f64 ({what})", route="cuda",
            source=f"proxtv_tpu_torch/csrc/{fn}.cu",
            replaces=f"proxtv_tpu/ops/tv1d_l1.py:{334 if kid == 'D1' else 632}"
                     " (XLA lock-step scan; no TPU kernel)",
            launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            plain_device="cpu", bound_ms=b, bound_by=f, library_ms=None,
            kernel_ms=kernel_ms, dtype="float64"))
    return kern


# Phase 8's calls: the numpy API at PERF.md section 2's widths in float64
# on the card (torch's default dtype float64).  A row: its label; the
# API call; the batched call it wraps (a key of phase 7's outputs, or a
# function run here on the card in float64 on the same input); the float64
# kernels it must launch (and no others); the key of phase 4's float32
# API wall (None: timed here); the same call at a small size (run on the
# card and with device="cpu") and the TOL64 bar of its family there, with
# whether the bar is relative to max|y| (phase 7's holds).
Api64 = collections.namedtuple(
    "Api64", "label call twin kernels f32_key small bar relative")


def _api64_table(ptv, x):
    """Phase 8's rows (:class:`Api64`), on main's inputs ``x``."""
    import torch

    from proxtv_tpu_torch.models import tv2d, tvnd
    from proxtv_tpu_torch.ops import tv1d_l1, tv1d_l2, tv1d_long, tv1d_lp
    from proxtv_tpu_torch.utils.config import TV1Config

    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(  # noqa: E731  float64 on the card
        np.ascontiguousarray(a, dtype=np.float64)).to(dev)
    rng = np.random.RandomState(SEED + 10)  # this phase's small inputs
    ys = np.cumsum(rng.randn(API64_N)) * 0.3 + 0.2 * rng.randn(API64_N)
    ws = rng.rand(API64_N - 1) * LAMW
    Xs = rng.randn(API64_M, API64_M)
    Wcs = LAMW2D * (0.5 + rng.rand(API64_M - 1, API64_M))
    Wrs = LAMW2D * (0.5 + rng.rand(API64_M, API64_M - 1))
    Vs = rng.randn(*API64_V)
    y9 = np.cumsum(rng.randn(API64_SPECTRAL)) * 0.05 + rng.randn(
        API64_SPECTRAL)
    y1, ww1, Y2, Y5, V = x["y1"], x["ww1"], x["Y2"], x["Y5"], x["V"]
    cfg = TV1Config(sigma=0.05)
    b2, nd = {"B2.f64"}, dict(max_iters=ND_SWEEPS)
    rows = [
        Api64(f"api.tv1_2d {M2D}^2 lam {LAM2D} auto (dr)",
              lambda **k: ptv.tv1_2d(Y2, LAM2D, **k), "dr", b2,
              "tv1_2d_auto_ms", lambda **k: ptv.tv1_2d(Xs, LAM2D, **k),
              "dr_cpu", False),
        Api64(f"api.tv1w_2d {M2D}^2 dr",
              lambda **k: ptv.tv1w_2d(Y2, x["Wc2"], x["Wr2"], **k),
              lambda: tv2d.tv1w_2d_batched(t(Y2)[None], t(x["Wc2"])[None],
                                           t(x["Wr2"])[None])[0][0],
              b2, "tv1w_2d_dr_ms",
              lambda **k: ptv.tv1w_2d(Xs, Wcs, Wrs, **k), "dr_cpu", False),
        Api64(f"api.tv1_1d n={N1D} w 2.0 pn",
              lambda **k: ptv.tv1_1d(y1, 2.0, method="pn", **k), "pn", b2,
              "tv1_1d_ms", lambda **k: ptv.tv1_1d(ys, 2.0, method="pn", **k),
              "pn", False),
        Api64(f"api.tv1_1d n={N1D} w 2.0 auto",
              lambda **k: ptv.tv1_1d(y1, 2.0, **k),
              lambda: tv1d_l1.tv1_batched(t(y1)[None], 2.0, strict=False)[0],
              {"D1.f64"}, "tv1_1d_auto_ms",
              lambda **k: ptv.tv1_1d(ys, 2.0, **k), "host", True),
    ]
    for m, kid, key in (("condat", "D3", "tv1_1d_condat_ms"),
                        ("classictautstring", "D4", "tv1_1d_classic_ms"),
                        ("dp", "D2", None)):
        rows.append(Api64(
            f"api.tv1_1d n={N1D} w 2.0 {m}",
            lambda m=m, **k: ptv.tv1_1d(y1, 2.0, method=m, **k),
            lambda m=m: tv1d_l1.tv1_batched(t(y1)[None], 2.0, method=m,
                                            strict=True)[0],
            {kid + ".f64"}, key,
            lambda m=m, **k: ptv.tv1_1d(ys, 2.0, method=m, **k),
            "direct_guard", True))
    rows += [
        Api64(f"api.tv1_1d n=1e6 lam {LAM1D} auto (long route)",
              lambda **k: ptv.tv1_1d(x["ylong"], LAM1D, **k), "long", b2,
              "tv1_1d_long_ms",
              lambda **k: ptv.tv1_1d(x["yc2"], LAMC2, **k), "combiner",
              True),
        Api64(f"api.tv1_1d n={NC2} w {LAMC2} auto (C2 walk, long route)",
              lambda **k: ptv.tv1_1d(x["yc2"], LAMC2, **k),
              lambda: tv1d_long.tv1_long(t(x["yc2"]), LAMC2)[0], b2,
              "tv1_1d_c2_ms",
              lambda **k: ptv.tv1_1d(x["yc2"], LAMC2, **k), "combiner",
              True),
        Api64(f"api.tv1w_1d n={N1D} auto",
              lambda **k: ptv.tv1w_1d(y1, ww1, **k),
              lambda: tv1d_l1.tv1_tautstring(t(y1)[None], t(ww1)[None])[0],
              {"D1.f64"}, "tv1w_1d_auto_ms",
              lambda **k: ptv.tv1w_1d(ys, ws, **k), "host", True),
        Api64(f"api.tv1w_1d n={N1D} dp",
              lambda **k: ptv.tv1w_1d(y1, ww1, method="dp", **k),
              lambda: tv1d_l1.tv1_dp(t(y1)[None], t(ww1)[None])[0],
              {"D2.f64"}, "tv1w_1d_dp_cuda_ms",
              lambda **k: ptv.tv1w_1d(ys, ws, method="dp", **k),
              "direct_guard", True),
        Api64(f"api.tv1w_1d n={N1D} pn",
              lambda **k: ptv.tv1w_1d(y1, ww1, method="pn", **k),
              lambda: tv1d_l1.tv1_pn(t(y1)[None], t(ww1)[None],
                                     cfg=cfg)[0][0],
              b2, "tv1w_1d_pn_cuda_ms",
              lambda **k: ptv.tv1w_1d(ys, ws, method="pn", **k), "pn",
              False),
        Api64(f"api.tv2_1d n={N1D} w 2.0 mspg",
              lambda **k: ptv.tv2_1d(y1, 2.0, **k),
              lambda: tv1d_l2.tv2_batched(t(y1)[None], 2.0)[0][0], b2,
              "tv2_1d_ms", lambda **k: ptv.tv2_1d(ys, 2.0, **k), "route",
              True),
        Api64(f"api.tv2_1d n=1e6 w {LAMLONG} ms (spectral)",
              lambda **k: ptv.tv2_1d(x["ylong"], LAMLONG, method="ms", **k),
              lambda: tv1d_l2.tv2_batched(t(x["ylong"])[None], LAMLONG,
                                          method="ms")[0][0],
              set(), "tv2_1d_long_ms",
              lambda **k: ptv.tv2_1d(y9, LAMLONG, method="ms", **k),
              "route", True),
        Api64(f"api.tvp_1d n={N1D} w 2.0 p 1.5 gpfw",
              lambda **k: ptv.tvp_1d(y1, 2.0, 1.5, **k),
              lambda: tv1d_lp.tvp_batched(t(y1)[None], 2.0, 1.5)[0][0], b2,
              "tvp_1d_ms", lambda **k: ptv.tvp_1d(ys, 2.0, 1.5, **k),
              "route", True),
        Api64(f"api.tvp_2d {M2D}^2 lam {LAM2D} p 2",
              lambda **k: ptv.tvp_2d(Y2, LAM2D, LAM2D, 2, 2, **k),
              "tvp_2d p2", b2, "tvp_2d_p2_ms",
              lambda **k: ptv.tvp_2d(Xs, LAM2D, LAM2D, 2, 2, **k),
              "combiner", True),
        Api64(f"api.tvp_2d {M5}^2 lam {LAM2P} p {P2P} {ND_SWEEPS} sweeps",
              lambda **k: ptv.tvp_2d(Y5, LAM2P, LAM2P, P2P, P2P, **nd, **k),
              "tvp_2d p1.5", b2, "tvp_2d_p1.5_ms",
              lambda **k: ptv.tvp_2d(Xs, LAM2P, LAM2P, P2P, P2P, **nd, **k),
              "combiner", True),
        Api64(f"api.tvgen {L3}x{M3}x{N3} lam {LAM3} p 1 {ND_SWEEPS} sweeps "
              "(pd)", lambda **k: ptv.tvgen(V, [LAM3] * 3, [1, 2, 3],
                                            [1.0] * 3, **nd, **k),
              "tvgen", b2, "tvgen_pd_3d_ms",
              lambda **k: ptv.tvgen(Vs, [LAM3] * 3, [1, 2, 3], [1.0] * 3,
                                    **nd, **k), "combiner", True),
        Api64(f"api.tvgen_nd pd {L3}x{M3}x{N3} lam {LAM3} p 1 {ND_SWEEPS} "
              "sweeps", lambda **k: ptv.tvgen_nd(V, [LAM3] * 3, [1, 2, 3],
                                                 [1.0] * 3, **nd, **k),
              "tvgen", b2, None,
              lambda **k: ptv.tvgen_nd(Vs, [LAM3] * 3, [1, 2, 3], [1.0] * 3,
                                       **nd, **k), "combiner", True),
        Api64(f"api.tv_value {L3}x{M3}x{N3} ws {PS_MIXED} p {PS_MIXED}",
              lambda **k: ptv.tv_value(V, list(PS_MIXED), [1, 2, 3],
                                       list(PS_MIXED), **k),
              lambda: float(tvnd.tv_value(t(V), list(PS_MIXED), [1, 2, 3],
                                          list(PS_MIXED))), set(), None,
              lambda **k: ptv.tv_value(Vs, list(PS_MIXED), [1, 2, 3],
                                       list(PS_MIXED), **k), "route", True),
    ]
    return rows


def api64_phase(card, ptv, x, outs64, times):
    """Phase 8: the numpy API in float64 on the card.  Under a float64
    default dtype (restored before it returns), each row of
    :func:`_api64_table` at the bench's width must give a float64 result,
    launch its float64 kernels and no other kernel (no float32 kernel, no
    kernel's plain version on the card), and be bit for bit the batched
    call it wraps on the same input (phase 7's output ``outs64`` where
    phase 7 ran that call); the same call at a small size on the card must
    land within its family's TOL64 bar of the call with device="cpu".
    tvgen_nd with a primal-dual ND method and the banded 2D driver must
    raise, as the JAX package's do, and a float32 batch under the float64
    default must take the float32 route unchanged.  Each row's wall by
    CUDA events beside phase 4's float32 API wall (or one timed here).
    Returns the report."""
    import torch

    from proxtv_tpu_torch import parallel
    from proxtv_tpu_torch.models import tv2d
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.parallel.comm import Mesh
    from proxtv_tpu_torch.utils import debug

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rows = _api64_table(ptv, x)
    counters = launch_counters()
    plain_on_card = debug.Counter()
    rep = {"calls": {}, "small": {}}
    f32_ms = {}
    for row in rows:  # the float32 API walls phase 4 did not time
        if row.f32_key is None:
            f32_ms[row.label] = cuda_ms(row.call, reps=3)

    def counted(fn):
        for c in counters.values():
            c.reset()
        plain_on_card.reset()
        debug.HOST_SYNCS.reset()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        torch.cuda.synchronize()
        got = {k: c.value for k, c in counters.items() if c.value}
        return res, start.elapsed_time(end), got, debug.HOST_SYNCS.value

    saved = trip_plain(plain_on_card)
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        for row in rows:
            out, ms, got, syncs = counted(row.call)
            reps = 1
            if ms < 500.0:  # a few repetitions for the short calls
                reps = 5
                ms = cuda_ms(row.call, reps=reps)
            twin = (outs64[row.twin] if isinstance(row.twin, str)
                    else row.twin())
            if torch.is_tensor(twin):
                same = (isinstance(out, np.ndarray) and out.dtype == np.float64
                        and np.array_equal(out, twin.cpu().numpy()))
            else:
                same = isinstance(out, float) and out == twin
            ms32 = (times[row.f32_key] if row.f32_key is not None
                    else f32_ms[row.label])
            where = "phase 7" if isinstance(row.twin, str) else "run here"
            rep["calls"][row.label] = {
                "ms": ms, "reps": reps, "float32_ms": ms32,
                "launches": got, "host_syncs": syncs,
                "plain_on_card": plain_on_card.value,
                "bit_for_bit_with_batched": bool(same)}
            print(f"[api64] {row.label}: {ms:.4f} ms float64 by CUDA events "
                  f"({reps} rep{'s' if reps > 1 else ''}; float32 API "
                  f"{ms32:.4f} ms, {ms / ms32:.1f}x), launches {got}, host "
                  f"syncs {syncs}, plain versions on the card "
                  f"{plain_on_card.value}; bit for bit with the batched "
                  f"call it wraps ({where}): "
                  f"{bool(same)}  ({card})")
            check(set(got) == set(row.kernels),
                  f"{row.label} launched {sorted(got)}, not "
                  f"{sorted(row.kernels)}")
            check(plain_on_card.value == 0,
                  f"{row.label} ran a kernel's plain version on the card")
            check(same, f"{row.label} is not float64 bit for bit with the "
                  "batched call it wraps")
            # (d) at a small size: the card within TOL64 of the CPU.
            small = row.small()
            ref = row.small(device="cpu")
            if isinstance(small, float):
                err = abs(small - ref) / abs(ref)
                lim = TOL64[row.bar]
            else:
                check(small.dtype == np.float64, f"{row.label}: the small "
                      "call on the card is not float64")
                err = float(np.abs(small - ref).max())
                lim = TOL64[row.bar] * (max(1.0, float(np.abs(ref).max()))
                                        if row.relative else 1.0)
            rep["small"][row.label] = {"max_abs_err": err, "bar": lim,
                                       "family": row.bar}
            print(f"[api64 small] {row.label} at a small size: max|card - "
                  f"cpu| = {err:.3e} (TOL64[{row.bar!r}]: {lim:.3e})")
            check(err <= lim, f"{row.label}: the small call on the card is "
                  f"{err} from the CPU's")
        # What raises as the JAX package's does, before any launch.
        for c in counters.values():
            c.reset()
        msgs = {}
        for name, fn in (
                ("tvgen_nd chambolle-pock-acc", lambda: ptv.tvgen_nd(
                    x["V"], [LAM3] * 3, [1, 2, 3], [1.0] * 3,
                    method="chambolle-pock-acc")),
                ("tv1_2d_banded", lambda: parallel.tv1_2d_banded(
                    x["Y2"].astype(np.float64), LAM2D,
                    Mesh(group=None, axis="x", device=dev)))):
            try:
                fn()
                msgs[name] = None
            except ValueError as e:
                msgs[name] = str(e)
            print(f"[api64] {name} float64 on the card: raises "
                  f"{msgs[name]!r}")
        check(msgs["tvgen_nd chambolle-pock-acc"] is not None
              and "primal-dual ND methods need"
              in msgs["tvgen_nd chambolle-pock-acc"],
              "tvgen_nd cp-acc in float64 did not raise the JAX error")
        check(msgs["tv1_2d_banded"] is not None and "banded driver takes "
              "float32 only" in msgs["tv1_2d_banded"],
              "tv1_2d_banded in float64 on the card did not refuse")
        check(not any(c.value for c in counters.values()),
              "a refused float64 call launched a kernel")
        rep["raises"] = msgs
    finally:
        torch.set_default_dtype(before)
        for mod, name, orig in reversed(saved):
            setattr(mod, name, orig)
    # A float32 batch under a float64 default: the float32 route, its
    # launches and its output unchanged.
    Y1t = torch.from_numpy(x["Y1"]).to(dev)
    Y2t = torch.from_numpy(x["Y2"]).to(dev)[None]
    f32 = {"tv1_batched pn (B1)": lambda: tv1d_l1.tv1_batched(
               Y1t, LAM1D, method="pn"),
           "tv1_2d_batched cp-acc (B3)": lambda: tv2d.tv1_2d_batched(
               Y2t, LAM2D, method="chambolle-pock-acc")[0]}
    for name, fn in f32.items():
        res = []
        for default in (torch.float32, torch.float64):
            torch.set_default_dtype(default)
            try:
                out, _, got, _ = counted(fn)
            finally:
                torch.set_default_dtype(before)
            res.append((out, got))
        same = bool(res[1][0].dtype == torch.float32
                    and torch.equal(res[0][0], res[1][0]))
        rep["calls"][name + " float32 under a float64 default"] = {
            "launches": res[1][1], "launches_float32_default": res[0][1],
            "bit_for_bit": same}
        print(f"[api64] {name}, a float32 batch under a float64 default: "
              f"launches {res[1][1]} (under float32: {res[0][1]}), bit for "
              f"bit: {same}")
        check(same and res[0][1] == res[1][1] and res[0][1]
              and all("." not in k for k in res[0][1]),
              f"{name}: a float32 batch moved under a float64 default")
    rep["seconds"] = time.perf_counter() - t_phase
    print(f"[api64] phase: {rep['seconds']:.1f} s")
    return rep


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
    from proxtv_tpu_torch.ops import (diffprox, tv1d_l1, tv1d_l2,
                                      tv1d_long, tv1d_lp)
    from proxtv_tpu_torch.ops.kernels import build, gating
    from proxtv_tpu_torch.ops.kernels import classic_ts as D4
    from proxtv_tpu_torch.ops.kernels import condat as D3
    from proxtv_tpu_torch.ops.kernels import dp as D2
    from proxtv_tpu_torch.ops.kernels import tautstring as D1
    from proxtv_tpu_torch.ops.kernels import labels as L1
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

    def stamp(what):
        """A line with the run's seconds so far, at each phase's end."""
        print(f"[t] {what}: {time.perf_counter() - t_all:.1f} s")

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
    rng8 = np.random.RandomState(SEED + 6)  # bench.py's F1-F4 (ROADMAP F)
    Y4 = rng8.randn(1, M4K, N4K).astype(np.float32)     # 4K UHD
    W1 = (0.5 + rng8.rand(B1D, N1D - 1)).astype(np.float32)  # F2's weights
    Ylong = (np.cumsum(rng8.randn(S_LONG, NLONG), axis=1) * 0.05
             + rng8.randn(S_LONG, NLONG)).astype(np.float32)  # F3's stream
    ylong7 = (np.cumsum(rng8.randn(N_LONG7)) * 0.05
              + rng8.randn(N_LONG7)).astype(np.float32)       # F4's signal
    errs = {"pcr": 0.0, "pn": 0.0, "pdhg": 0.0, "ms": 0.0, "pdhg3d": 0.0,
            "lp": 0.0, "direct": 0.0}
    # The float64 phase's CPU references start now, in worker processes.
    inp64, jobs64 = start_cpu64(dict(Y1=Y1, Ww=Ww, ylong=ylong, Y2=Y2,
                                     Y5=Y5, V=V), {
        **{kid: kernel_module(kid).warp_max_n(torch.float64)
           for kid in ("D1", "D3", "D4")},
        "D4 thread": kernel_module("D4").ring_max_n()}, {
        "D1 group b": kernel_module("D1").group_limits()[1],
        "D2 warp b": kernel_module("D2").warp_max_b()})

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
        h = pn_hold(B1, y, **kw)
        print(f"[B1 pn] {name}: max|kernel - plain| = {h['err']:.3e} (tol "
              f"{TOL['pn']}); Newton iterations at most "
              f"{h['iters_apart']} apart (tol {TOL['pn_iters']}), kernel mean "
              f"{float(h['it'].float().mean()):.2f}, plain mean "
              f"{float(h['it_ref'].float().mean()):.2f}")
        check(h["ok"], f"PN {name} disagrees")
        errs["pn"] = max(errs["pn"], h["err"])
        return h["w"]

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

    # D1-D4 are held against their plain versions on the card at each of
    # their main-path launches (phase 4, TOL["direct"] of the data's size):
    # the 10000 x 1000 batch at lam 0.7 (D1, D2), the per-edge-weighted
    # 512 x 1000 batch (D1, D2), its signals at lam 0.7 (D3, D4), and
    # tv1_1d's / tv1w_1d's one signal.
    Ywt, Wwt = t(Y1[:BW]), t(Ww)
    direct_plain = {"D1": (D1.tautstring, tv1d_l1.tv1_tautstring_plain),
                    "D2": (D2.dp, tv1d_l1.tv1_dp_plain),
                    "D3": (D3.condat, tv1d_l1.tv1_condat_plain),
                    "D4": (D4.classic_ts, tv1d_l1.tv1_classic_ts_plain)}

    def direct_compare(kid, y, lam):
        """One D1-D4 launch against its plain version on the card: max
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

    stamp("phase 2 done")
    # -- 3. main path -------------------------------------------------------
    counters = {"B1": B1.LAUNCHES, "B2": B2.LAUNCHES, "B3": B3.LAUNCHES,
                "B4": B4.LAUNCHES, "B5": B5.LAUNCHES, "B6": B6.LAUNCHES,
                "D1": D1.LAUNCHES, "D2": D2.LAUNCHES, "D3": D3.LAUNCHES,
                "D4": D4.LAUNCHES, "L1": L1.LAUNCHES}
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
    d_calls = {"D1": {}, "D2": {}, "D3": {}, "D4": {}}
    l1_calls = []  # L1's main-path launches: (path, X, tol)
    tap_path = [None]
    launch_b1 = B1.pn_tv1_fused
    launch_b2 = B2.pcr_spd_solve
    launch_b3 = B3.pdhg_chunk
    launch_b4 = B4.ms_tv2_fused
    launch_b5 = B5.gpfw_fused
    launch_d = {"D1": D1.tautstring, "D2": D2.dp, "D3": D3.condat,
                "D4": D4.classic_ts}
    launch_l1 = L1.component_labels

    def tap_l1(X, tol):
        if tap_path[0] is not None:
            l1_calls.append((tap_path[0], X.clone(), tol.clone()))
        return launch_l1(X, tol)

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
            kind = "scalar" if lam_full is None else "field"
            b1_calls.setdefault((*y.shape, kind), []).append(
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

    B1.pn_tv1_fused = tap_b1  # all five restored after the main path
    B2.pcr_spd_solve = tap_b2
    B3.pdhg_chunk = tap_b3
    B4.ms_tv2_fused = tap_b4
    B5.gpfw_fused = tap_b5
    D1.tautstring = tap_direct("D1")
    D2.dp = tap_direct("D2")
    D3.condat = tap_direct("D3")
    D4.classic_ts = tap_direct("D4")
    L1.component_labels = tap_l1
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
    x_con = run(f"tv1_batched {BW}x{N1D} lam {LAM1D} condat strict",
                lambda: tv1d_l1.tv1_batched(Ycon, LAM1D, method="condat",
                                            strict=True), ["D3"])
    x_cls = run(f"tv1_batched {BW}x{N1D} lam {LAM1D} classictautstring strict",
                lambda: tv1d_l1.tv1_batched(Ycon, LAM1D,
                                            method="classictautstring",
                                            strict=True), ["D4"])
    for name_, kid in ((f"tv1_batched {BW}x{N1D} lam {LAM1D} condat strict",
                        "D3"),
                       (f"tv1_batched {BW}x{N1D} lam {LAM1D} "
                        "classictautstring strict", "D4")):
        check(main[name_]["launches"][kid] == 1
              and sum(main[name_]["launches"].values()) == 1,
              f"{name_} did not run in one {kid} launch")
    x_ac = run(f"api.tv1_1d n={N1D} w 2.0 condat",
               lambda: ptv.tv1_1d(y1, 2.0, method="condat"), ["D3"])
    x_at = run(f"api.tv1_1d n={N1D} w 2.0 classictautstring",
               lambda: ptv.tv1_1d(y1, 2.0, method="classictautstring"),
               ["D4"])
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
    # bench.py's F1-F3 on one card, counted and tapped with the main path
    # (phase 3b holds every B1 and B3 launch against its plain version);
    # the first B1 / B3 launch of each is also kept and held as the dist
    # calls' are (hold_first).  Checked against float64 after the dist
    # phase; timed and profiled in phases 4 and 5.
    first_f = FirstLaunch(B1, B3, B6)
    Y4t, W1t, Ylong_t = t(Y4), t(W1), t(Ylong)
    f_calls = {
        "F1": (f"F1 tv1_2d_batched {M4K}x{N4K} lam {LAM4K} "
               f"chambolle-pock-acc max_iters {ITERS4K}",
               lambda: tv2d.tv1_2d_batched(Y4t, LAM4K,
                                           method="chambolle-pock-acc",
                                           max_iters=ITERS4K), "B3"),
        "F2": (f"F2 tv1_batched {B1D}x{N1D} per-edge weights 0.5 + U[0, 1) "
               "pn", lambda: tv1d_l1.tv1_batched(Y1t, W1t, method="pn"),
               "B1"),
        "F3": (f"F3 tv1_long {S_LONG}x1e6 lam {LAM1D}",
               lambda: tv1d_long.tv1_long(Ylong_t, LAM1D), "B1"),
    }
    f_out = {}
    with first_f:
        for key_, (name_, fn_, must_) in f_calls.items():
            first_f.label = name_
            f_out[key_] = run(name_, fn_, [must_])
            first_f.label = None
    x_f1, info_f1 = f_out["F1"]
    check(int(info_f1.rc[0]) == RC_OK, "F1 (4K cp-acc) did not certify")
    x_f3, info_f3 = f_out["F3"]
    check(bool((info_f3.rc == RC_OK).all()), "F3 (tv1_long) did not certify")
    stamp("the main path's calls done")
    # -- 3e. dist, world 1: the parallel path on a one-rank NCCL mesh ------
    # Counted and tapped with the main path (phase 3b holds its B1 and B3
    # launches, phase 4 replays them); the first B1, B3 and B6 launch of
    # each call is kept apart and held below, where the references exist.
    import tempfile

    import torch.distributed as dist
    from proxtv_tpu_torch import parallel

    t_dist = time.perf_counter()
    ddir = tempfile.mkdtemp(prefix="proxtv_dist_")
    dist.init_process_group("nccl", init_method=f"file://{ddir}/store1",
                            rank=0, world_size=1)
    mesh1 = parallel.make_mesh()
    d_in = {"Y2": Y2, "Wc2": Wc2, "Wr2": Wr2, "V": V, "ylong": ylong,
            "Ypi": Ypi, "Y1": Y1, "Y4": Y4, "ylong7": ylong7}
    first1 = FirstLaunch(B1, B3, B6)
    dist1 = {}
    with first1:
        for name_, fn_, must_, kind_ in dist_calls(parallel, mesh1, d_in, 1):
            comm_counts(debug, reset=True)
            first1.label = name_
            res_ = run(f"dist world 1 {name_}", fn_,
                       [must_] if must_ else [])
            first1.label = None
            check_launches(main[f"dist world 1 {name_}"]["launches"], must_,
                           f"dist world 1 {name_}")
            dist1[name_] = {"res": res_, "comm": comm_counts(debug),
                            "fn": fn_, "kind": kind_}
    t_dist = time.perf_counter() - t_dist
    # -- 3d. train: the differentiable path on the card ------------------
    # Each cell runs once here, counted and tapped like every main-path call
    # (phase 3b holds its B1 and B3 launches against their plain versions,
    # phase 4 adds them to the kernels line); phase 6 times it untapped.
    t_train = time.perf_counter()
    tgt_t1, ny_t1 = t(truth_t1.astype(np.float32)), t(noisy_t1)
    tgt_t2, ny_t2 = t(truth_t2.astype(np.float32)), t(noisy_t2)
    tcells = train_cells(ny_t1, tgt_t1, ny_t2, tgt_t2)
    train_main = {}
    for name_, must_ in (("T1", ["B1"]), ("T2", ["B1", "L1"]),
                         ("T2 cp-acc", ["B3", "L1"])):
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
    D3.condat = launch_d["D3"]
    D4.classic_ts = launch_d["D4"]
    L1.component_labels = launch_l1

    stamp("train and dist (world 1) calls done")
    # -- 3b. B1 against its plain version at the main path's own inputs ----
    # Every recorded launch, by shape: the 1024^2 dr fibers and the tvgen
    # fibers are warm-started from the duals of the sweeps before them.
    check(sum(len(v) for v in b1_calls.values())
          == sum(by_path["B1"].values()),
          "the B1 tap missed main-path launches")
    b1_shapes = {}
    for shp, calls in b1_calls.items():
        worst, di_max, its, ok = 0.0, 0, [], True
        agree, part, unheld, n_part, worst_where = 0.0, 0.0, 0.0, 0, None
        mg = {"fibers": 0, "ran_on": math.inf, "final": -math.inf,
              "to_optimum": 0.0}
        for path_, y_, lf_, w0_, kw_ in calls:
            where = pn_hold(B1, y_, lf_, w0_,
                            margin=path_.endswith(COLS_PI_NAME), **kw_)
            err, di = where["err"], where["iters_apart"]
            if worst_where is None or err > worst:
                worst_where = where
            worst, di_max = max(worst, err), max(di_max, di)
            ok = ok and where["ok"]
            agree = max(agree, where["err_counts_agree"])
            part = max(part, where["err_counts_part"])
            unheld = max(unheld, where["err_unheld"])
            n_part += where["fibers_counts_part"]
            m_ = where["margin"]
            mg = {"fibers": mg["fibers"] + m_["fibers"],
                  "ran_on": min(mg["ran_on"], m_["ran_on"]),
                  "final": max(mg["final"], m_["final"]),
                  "to_optimum": max(mg["to_optimum"], m_["to_optimum"])}
            its.append(int(where["it"].sum()))
        paths = sorted({c[0] for c in calls})
        warm = calls[-1][3] is not None
        b1_shapes[shp] = {"launches": len(calls), "paths": paths,
                          "warm": warm, "iters": its, "max_abs_err": worst,
                          "iters_apart": di_max,
                          "err_counts_agree": agree, "err_counts_part": part,
                          "err_not_at_margin": unheld, "margin": mg,
                          "fibers_counts_part": n_part,
                          "worst_iters": worst_where["worst_iters"],
                          "worst_gap_over_tol":
                              worst_where["worst_gap_over_tol"]}
        name = f"{shp[0]}x{shp[1]} {shp[2]} {'warm' if warm else 'cold'}"
        print(f"[B1 pn] main path {name} ({len(calls)} launches, "
              f"{', '.join(paths)}): max|kernel - plain| = {worst:.3e} (tol "
              f"{TOL['pn']}; {unheld:.3e} over fibers not held at the stop "
              f"margin); Newton iterations at most {di_max} apart (tol "
              f"{TOL['pn_iters']}), kernel mean per fiber "
              f"{sum(its) / (len(calls) * shp[0]):.2f}")
        wi, wg = worst_where["worst_iters"], worst_where["worst_gap_over_tol"]
        print(f"[B1 pn] main path {name}: fibers whose Newton counts agree "
              f"differ by at most {agree:.3e}; {n_part} of "
              f"{len(calls) * shp[0]} fibers part in count, differing by at "
              f"most {part:.3e}; {margin_text(mg)}; worst fiber: iterations "
              f"kernel {wi[0]} / plain {wi[1]}, gap over stop tolerance "
              f"kernel {wg[0]:.3f} / plain {wg[1]:.3f}")
        check(ok, f"PN main path {name} disagrees")
        errs["pn"] = max(errs["pn"], worst)

    # -- 3b. B3 against its plain version at each main-path chunk ---------
    # The fields on the whole canvas within TOL["pdhg"], the certificate
    # sums within TOL["pdhg_cert"] relative, each chunk on its own inputs.
    check(len(b3_calls) == sum(by_path["B3"].values()),
          "the B3 tap missed main-path launches")
    b3_err = b3_rel = 0.0
    b3_by_path = {}  # the largest field difference of each path's launches
    b3_worst = None  # the launch of the largest certificate difference
    for i_, (path_, a_, kw_) in enumerate(b3_calls):
        ref = B3.pdhg_chunk_plain(*a_, **kw_)
        out = B3.pdhg_chunk(*a_, **kw_)
        torch.cuda.synchronize()
        e_ = max(float((o - r_).abs().max())
                 for o, r_ in zip(out[:4], ref[:4]))
        b3_err = max(b3_err, e_)
        b3_by_path[path_] = max(b3_by_path.get(path_, 0.0), e_)
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
                         ("tv1_1d condat", x_ac, (N1D,)),
                         ("tv1_1d classictautstring", x_at, (N1D,)),
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
    for m_, x_ in (("condat", x_ac), ("classictautstring", x_at)):
        e_ = float(np.abs(x_ - x1d_ref[0].numpy()).max())
        print(f"[check] api.tv1_1d {m_} (card) vs float64 tv1_pn: {e_:.3e} "
              f"(tol {TOL['pn']})")
        check(e_ <= TOL["pn"], f"api.tv1_1d {m_} disagrees with float64")
        xc[f"tv1_1d {m_} card vs float64 pn"] = {"max_abs_err": e_}
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

    def obj1(z, y, lam):
        """The 1D TV-L1 objective in float64."""
        z = np.asarray(z, np.float64)
        return (0.5 * np.sum((z - y) ** 2)
                + lam * np.sum(np.abs(np.diff(z))))

    # bench.py's F1-F3 (ROADMAP F) against float64: F1 by the certified-gap
    # rule against float64 Chambolle-Pock on the card (F4K_REF_ITERS
    # iterations; the banded F1 of the dist phase too), F2 and F3 by the
    # same rule against the float64 host engine, every signal of F3
    # certified.
    t0 = time.perf_counter()
    x4k_ref, gap4k_ref = reference_2d(t(Y4[0].astype(np.float64)), LAM4K,
                                      F4K_REF_ITERS)
    x4k_ref = x4k_ref.cpu().numpy()
    F4k_ref = obj2d(x4k_ref, Y4[0], LAM4K)
    print(f"[F] float64 4K reference ({F4K_REF_ITERS} Chambolle-Pock "
          f"iterations, {time.perf_counter() - t0:.1f} s): F* >= F_ref - "
          f"{gap4k_ref:.3e}, F_ref = {F4k_ref:.6f}")
    f_checks = {}
    X = x_f1[0].cpu().numpy()
    dF, g_ = obj2d(X, Y4[0], LAM4K) - F4k_ref, float(info_f1.gap[0])
    print(f"[F] {f_calls['F1'][0]}: F - F_ref = {dF:.4e} (bar: gap "
          f"{g_:.4e} + {gap4k_ref:.3e} + {F_ROUND * F4k_ref:.3e}), iters "
          f"{int(info_f1.iters[0])}, max|x - x_ref| = "
          f"{float(np.abs(X - x4k_ref).max()):.3e}")
    check(x_f1.is_cuda and dF <= g_ + gap4k_ref + F_ROUND * F4k_ref,
          "F1 (4K cp-acc) misses its certificate")
    f_checks["F1"] = {"F_minus_F_ref": dF, "gap": g_,
                      "iters": int(info_f1.iters[0])}
    # F2 by the certified-gap rule row by row: B1 stops where its float32
    # duality gap falls under tol = max(1e-6, 10 eps 0.5 ||y - mean||^2)
    # (the TPU kernel's floor, which tv1_batched keeps), so each row's
    # objective lies within that tol of the float64 optimum, plus the
    # float32 rounding of x (F_ROUND).  The floor lets x itself land up to
    # sqrt(2 tol) from the optimum, so max|x - x_host64| is printed, not
    # held (ROADMAP C, "The float32 stop floors").
    t1 = time.perf_counter()
    x_f2 = f_out["F2"]
    ref_ = np.stack([native.tv1w_host(Y1[i_], W1[i_]) for i_ in range(B1D)])
    X = x_f2.cpu().numpy().astype(np.float64)
    e_row = np.abs(X - ref_).max(axis=1)
    e_ = float(e_row.max())
    far = np.nonzero(e_row > TOL["pn"])[0]
    W64 = W1.astype(np.float64)

    def obj1w(Z):
        return (0.5 * np.sum((Z - Y1) ** 2, axis=1)
                + np.sum(W64 * np.abs(np.diff(Z, axis=1)), axis=1))

    F_, Fr_ = obj1w(X), obj1w(ref_)
    yc_ = Y1.astype(np.float64) - Y1.mean(axis=1, keepdims=True)
    tol_ = np.maximum(1e-6, 10.0 * float(np.finfo(np.float32).eps)
                      * np.maximum(1.0, 0.5 * np.sum(yc_ * yc_, axis=1)))
    over = F_ - Fr_ - tol_ - F_ROUND * Fr_
    k_ = int(np.argmax(over))
    print(f"[F] {f_calls['F2'][0]}: F - F_ref per row at most "
          f"{float(np.max(F_ - Fr_)):.4e}; the worst row against its bar: "
          f"{F_[k_] - Fr_[k_]:.4e} (bar: stop tol {tol_[k_]:.4e} + "
          f"{F_ROUND * Fr_[k_]:.3e}); max|x - x_host64| = {e_:.3e} "
          f"({len(far)} of {B1D} rows past {TOL['pn']}, printed: "
          f"{', '.join(f'row {i_} {e_row[i_]:.4e}' for i_ in far)}); the "
          f"float64 "
          f"host taut string, {B1D} signals, took "
          f"{time.perf_counter() - t1:.1f} s")
    check(x_f2.is_cuda and float(np.max(over)) <= 0.0,
          "F2 misses the certified-gap rule against float64")
    f_checks["F2"] = {"max_abs_err": e_,
                      "rows_past_tol_pn": {int(i_): float(e_row[i_])
                                           for i_ in far},
                      "F_minus_F_ref_max": float(np.max(F_ - Fr_)),
                      "worst_over_bar": float(np.max(over))}
    # F3 by the certified-gap rule signal by signal: the long route stops
    # when the glued dual's gap is under 2 eps 0.5 ||y - mean||^2 (the JAX
    # package's tv1_long, ~95 on these walks), and each signal's objective
    # lies within its gap of the float64 optimum, plus rounding.  Its x may
    # land several 1e-2 away on a few signals, as the JAX package's float32
    # tv1_long does on the same signals (tests/test_torch_bench_rows.py):
    # printed, not held.
    t1 = time.perf_counter()
    X = x_f3.cpu().numpy().astype(np.float64)
    g3 = info_f3.gap.cpu().numpy().astype(np.float64)
    e_s, over_s = [], []
    for s_ in range(S_LONG):
        ref_ = native.tv1_host(Ylong[s_].astype(np.float64), LAM1D)
        e_s.append(float(np.abs(X[s_] - ref_).max()))
        Fr_ = obj1(ref_, Ylong[s_], LAM1D)
        over_s.append(obj1(X[s_], Ylong[s_], LAM1D) - Fr_ - g3[s_]
                      - F_ROUND * Fr_)
    print(f"[F] {f_calls['F3'][0]}: F - F_ref - gap - {F_ROUND} F_ref per "
          f"signal {', '.join(f'{v:.4e}' for v in over_s)} (bar 0); gaps "
          f"{', '.join(f'{v:.4e}' for v in g3)}; max|x - x_host64| "
          f"{', '.join(f'{v:.3e}' for v in e_s)} (printed; "
          f"{time.perf_counter() - t1:.1f} s on the host)")
    check(x_f3.is_cuda and max(over_s) <= 0.0,
          "F3 misses the certified-gap rule against float64")
    f_checks["F3"] = {"max_abs_err": e_s, "gap": g3.tolist(),
                      "over_bar": over_s}
    for (name_, kid), (a_, kw_) in first_f.seen.items():
        err_ = hold_first(kid, a_, kw_, B1, B3, B6)
        f_checks[f"first {kid} launch vs plain: {name_}"] = err_
        print(f"[F] {name_}: first {kid} launch vs plain {err_:.3e}")
    # Each call's wall by CUDA events, one profiled call (device busy, idle
    # share), and the counted run's launches and host syncs.
    f_prof = {}
    for key_, (name_, fn_, must_) in f_calls.items():
        wall_ = cuda_ms(fn_, reps=3)
        prof_ = f_prof[name_] = profile_call(fn_)
        m_ = main[name_]
        print(f"[F] {name_}: wall {wall_:.3f} ms (CUDA events), device busy "
              f"{prof_['busy_ms']:.3f} ms, idle share "
              f"{prof_['idle_share']}, {must_} device "
              f"{prof_['ours'].get(must_, 0.0):.3f} ms; launches "
              f"{m_['launches'][must_]} {must_} (counted run), host syncs "
              f"{m_['host_syncs']}  ({card})")
        f_checks[key_].update(wall_ms=wall_, busy_ms=prof_["busy_ms"],
                              idle_share=prof_["idle_share"],
                              launches=m_["launches"][must_],
                              host_syncs=m_["host_syncs"])
    xc["bench F1-F3"] = f_checks

    stamp("phase 3's checks done")
    # -- 3e. dist: world 1 held against the references, timed; then the
    # gloo world of DIST_WORLD ranks on this card, held against world 1 ----
    # By kind (dist_calls): 2D and 3D by the certified-gap rule against the
    # float64 references (the 4K image against F1's); the 10^6 and 10^7
    # walks against the float64 host taut string at TOL["pn"]; the
    # batch-split calls bit for bit against the single-card calls that make
    # the same launches; the column-split calls within 1e-5 of the data's
    # size of the port's single-card run of the same engine, method and
    # max_iters (for cp-acc the unfused iteration, tv2d._run_pdhg, which is
    # what the column split runs, as the JAX package does under sharding).
    # The first B1, B3 and B6 launch of each call against its plain version
    # (hold_first).
    t0 = time.perf_counter()
    report["dist"] = {"world1": {}, "world2": {}}
    Wr64, Wc64 = Wr2.astype(np.float64), Wc2.astype(np.float64)
    per_img = tv2d.tv1_2d_batched(t(Ypi), LAM2D,
                                  method="chambolle-pock-acc")[0]
    single = {"fused": per_img.cpu().numpy(),
              "tv1": tv1d_l1.tv1_batched(Y1t, LAM1D).cpu().numpy()}
    Y2b, lam32 = t(Y2)[None], tv2d._scalar(LAM2D, torch.float32)
    cols_single = {
        "dr": tv2d.tv1_2d_batched(Y2b, LAM2D, method="dr",
                                  max_iters=COLS_ITERS)[0],
        "chambolle-pock-acc": tv2d._run_pdhg(
            Y2b, lam32, lam32, COLS_ITERS, DEFAULT_COMBINER.stop,
            DEFAULT_COMBINER, "cp-acc")[0],
        "kolmogorov": tv2d.tv1_2d_batched(Y2b, LAM2D, method="kolmogorov",
                                          max_iters=COLS_ITERS)[0],
        "per-image": tv2d.tv1_2d_batched(
            t(Ypi), torch.tensor(LAM_PI, device=dev), method="dr",
            max_iters=COLS_ITERS)[0]}
    cols_single = {k_: v.cpu().numpy() for k_, v in cols_single.items()}
    t1 = time.perf_counter()
    xl7_ref = native.tv1_host(ylong7.astype(np.float64), LAM1D)
    print(f"[dist] (the float64 host taut string at n = 10^7 took "
          f"{time.perf_counter() - t1:.1f} s)")

    def cols_ref(name_):
        """The single-card solve a column-split call is held against, and
        the data's size."""
        if "per-image" in name_:
            return cols_single["per-image"], float(np.abs(Ypi).max())
        m_ = next(m_ for m_ in ("chambolle-pock-acc", "kolmogorov", "dr")
                  if f" {m_} " in name_)
        return cols_single[m_], float(np.abs(Y2).max())

    def dist_objective(kind_, X):
        """(objective, float64 reference objective, reference gap) of a
        certified call, per image for the batch call."""
        if kind_ == "cert2d":
            return obj2d(X, Y2, LAM2D), F_ref, gap_ref
        if kind_ == "cert2dw":
            return obj2dw(X, Y2, Wr64, Wc64), Fw_ref, gapw_ref
        if kind_ == "cert3d":
            return obj3d(X, V, LAM3), F3_ref, gap_ref3
        if kind_ == "cert4k":
            return obj2d(X, Y4[0], LAM4K), F4k_ref, gap4k_ref
        return np.array([obj2d(X[b_], Ypi[b_], LAM2D)
                         for b_ in range(B_PI)]), None, None

    w1_out, dist_prof = {}, {}
    for name_, e_ in dist1.items():
        res_, kind_ = e_["res"], e_["kind"]
        x_, info_ = res_ if isinstance(res_, tuple) else (res_, None)
        X = x_.cpu().numpy()
        w1_out[name_] = (X, info_)
        rec = {"launches": main[f"dist world 1 {name_}"]["launches"],
               "host_syncs": main[f"dist world 1 {name_}"]["host_syncs"],
               **e_["comm"]}
        if kind_.startswith("cert"):
            F_, Fr_, gr_ = dist_objective(kind_, X)
            g_ = float(info_.gap[0])
            print(f"[dist] world 1 nccl {name_}: F - F_ref = {F_ - Fr_:.4e} "
                  f"(bar: gap {g_:.4e} + {gr_:.3e} + {F_ROUND * Fr_:.3e}), "
                  f"iters {int(info_.iters[0])}, rc {int(info_.rc[0])}")
            check(int(info_.rc[0]) == RC_OK and F_ - Fr_ <= g_ + gr_
                  + F_ROUND * Fr_, f"dist world 1 {name_} misses its "
                  "certificate")
            rec.update(F_minus_F_ref=F_ - Fr_, gap=g_,
                       iters=int(info_.iters[0]))
        elif kind_ == "long1d":
            e_l = float(np.abs(X.astype(np.float64) - xl1_ref).max())
            print(f"[dist] world 1 nccl {name_}: max|x - x_host64| = "
                  f"{e_l:.3e} (tol {TOL['pn']}), rc {int(info_.rc[0])}, gap "
                  f"{float(info_.gap[0]):.4e}")
            check(int(info_.rc[0]) == RC_OK and e_l <= TOL["pn"],
                  f"dist world 1 {name_} disagrees")
            rec.update(max_abs_err=e_l)
        elif kind_ == "long7":
            # F4 by the certified-gap rule, as F3: its x printed
            e_l = float(np.abs(X.astype(np.float64) - xl7_ref).max())
            g_ = float(info_.gap[0])
            Fr_ = obj1(xl7_ref, ylong7, LAM1D)
            dF = obj1(X, ylong7, LAM1D) - Fr_
            print(f"[dist] world 1 nccl {name_}: F - F_ref = {dF:.4e} (bar: "
                  f"gap {g_:.4e} + {F_ROUND * Fr_:.3e}), rc "
                  f"{int(info_.rc[0])}, max|x - x_host64| = {e_l:.3e} "
                  f"(printed)")
            check(int(info_.rc[0]) == RC_OK and dF <= g_ + F_ROUND * Fr_,
                  f"dist world 1 {name_} misses the certified-gap rule")
            rec.update(max_abs_err=e_l, F_minus_F_ref=dF, gap=g_)
        elif kind_ in ("cols", "cols_pi"):
            ref_, scale_ = cols_ref(name_)
            e_c = float(np.abs(X - ref_).max())
            its = info_.iters.cpu().numpy().tolist()
            print(f"[dist] world 1 nccl {name_}: max|x - x_single| = "
                  f"{e_c:.3e} (bar 1e-5 x {scale_:.3e}), sweeps {its}, rc "
                  f"{info_.rc.cpu().numpy().tolist()}")
            check(bool(np.isfinite(X).all()) and e_c <= 1e-5 * scale_,
                  f"dist world 1 {name_} parts from the single-card solve")
            rec.update(max_abs_err=e_c, iters=its)
        else:
            same = bool(np.array_equal(X, single[kind_]))
            print(f"[dist] world 1 nccl {name_}: bit for bit with the "
                  f"single-card call: {same}")
            check(same, f"dist world 1 {name_} parts from the single-card "
                  "call")
        wall_ = cuda_ms(e_["fn"], reps=3)
        prof_ = dist_prof[name_] = profile_call(e_["fn"])
        print(dist_line(1, "nccl", name_, wall_, prof_, e_["comm"],
                        rec["host_syncs"], rec["launches"], card))
        rec.update(wall_ms=wall_, busy_ms=prof_["busy_ms"],
                   idle_share=prof_["idle_share"])
        report["dist"]["world1"][name_] = rec
    report["dist"]["world1_first_launch_vs_plain"] = {}
    for (name_, kid), (a_, kw_) in first1.seen.items():
        err_ = hold_first(kid, a_, kw_, B1, B3, B6,
                          margin=name_ == COLS_PI_NAME)
        report["dist"]["world1_first_launch_vs_plain"][f"{name_}: {kid}"] = (
            err_)
        print(f"[dist] world 1 {name_}: first {kid} launch vs plain "
              f"{err_:.3e}")
    dist.destroy_process_group()

    import shutil

    np.savez(os.path.join(ddir, "inputs.npz"), Y2=Y2, Wc2=Wc2, Wr2=Wr2, V=V,
             ylong=ylong, Ypi=Ypi)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-rank", str(r_),
         "--dist-dir", ddir], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r_ in range(DIST_WORLD)]
    logs = []
    try:
        for p_ in procs:
            logs.append(p_.communicate(timeout=DIST_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        raise Fail(f"the gloo world of {DIST_WORLD} did not end within "
                   f"{DIST_TIMEOUT_S} s")
    finally:
        for p_ in procs:
            if p_.poll() is None:
                p_.kill()
                p_.wait()
    for r_, (p_, log_) in enumerate(zip(procs, logs)):
        print(log_.rstrip())
        check(p_.returncode == 0, f"dist rank {r_} failed ({p_.returncode})")
    with np.load(os.path.join(ddir, "world.npz")) as f_:
        w2 = {k_: f_[k_] for k_ in f_.files}
    for r_ in range(DIST_WORLD):
        with open(os.path.join(ddir, f"holds{r_}.json")) as f_:
            report["dist"][f"world2_rank{r_}_first_launch_vs_plain"] = (
                json.load(f_))
    shutil.rmtree(ddir)
    ymax = float(np.abs(ylong).max())
    for i_, (name_, _, _, kind_) in enumerate(
            dist_calls(parallel, None, {}, DIST_WORLD)):
        X1, info1 = w1_out[name_]
        X2, g2, rc2 = w2[f"x{i_}"], w2[f"gap{i_}"], w2[f"rc{i_}"]
        g1 = info1.gap.cpu().numpy()
        rec = {"wall_ms": float(w2[f"wall{i_}"]),
               "busy_ms": float(w2[f"busy{i_}"]),
               "comm": dict(zip((k_.lower() for k_ in COMM),
                                w2[f"comm{i_}"].tolist())),
               "host_syncs": int(w2[f"syncs{i_}"]), "rc": rc2.tolist()}
        if kind_ in ("long1d", "cols", "cols_pi"):
            scale_ = ymax if kind_ == "long1d" else cols_ref(name_)[1]
            e_ = float(np.abs(X2.astype(np.float64) - X1).max())
            print(f"[dist] world {DIST_WORLD} {name_}: max|x - x_world1| = "
                  f"{e_:.3e} (bar 1e-5 x {scale_:.3e}), rc {rc2.tolist()}, "
                  f"sweeps {w2[f'iters{i_}'].tolist()} (world 1 "
                  f"{info1.iters.cpu().numpy().tolist()})")
            check(e_ <= 1e-5 * scale_ and (kind_ != "long1d"
                                           or int(rc2[0]) == RC_OK),
                  f"dist world {DIST_WORLD} {name_} parts from world 1")
            rec.update(max_abs_err=e_)
        else:
            F1, Fr_, gr_ = dist_objective(kind_, X1)
            F2, _, _ = dist_objective(kind_, X2)
            F1, F2 = np.atleast_1d(F1), np.atleast_1d(F2)
            rnd = F_ROUND * np.abs(F1)
            ok = (np.all(F2 - F1 <= g2 + rnd) and np.all(F1 - F2 <= g1 + rnd)
                  and np.all(rc2 == RC_OK))
            msg = (f"[dist] world {DIST_WORLD} {name_}: F - F_world1 = "
                   f"{', '.join(f'{v:.4e}' for v in F2 - F1)} (bars: gaps "
                   f"{', '.join(f'{v:.4e}' for v in g2)} / world 1 "
                   f"{', '.join(f'{v:.4e}' for v in g1)})")
            if Fr_ is not None:
                ok = ok and F2[0] - Fr_ <= g2[0] + gr_ + F_ROUND * Fr_
                msg += f"; F - F_ref = {F2[0] - Fr_:.4e}"
            print(msg)
            check(ok, f"dist world {DIST_WORLD} {name_} misses the "
                  "certified-gap rule")
            rec.update(F_minus_F_world1=(F2 - F1).tolist())
        report["dist"]["world2"][name_] = rec
    t_dist += time.perf_counter() - t0
    report["dist"]["seconds"] = t_dist
    print(f"[dist] phase: {t_dist:.1f} s (world 1 counted in phase 3, its "
          f"checks, timing and profiles, and the gloo world of "
          f"{DIST_WORLD} on this card)")

    stamp("the dist phase done")
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

    stamp("phase 3c done")
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
    # Condat (D3) and the classic taut string (D4): the 512 x 1000 batch
    # and one signal through the API, CUDA events around the whole call
    # (the C entry point's times are phase 4's D3 / D4 rows).
    for m_, nm_ in (("condat", "condat"), ("classic", "classictautstring")):
        times[f"tv1_batched_{m_}_{BW}_ms"] = cuda_ms(
            lambda nm_=nm_: tv1d_l1.tv1_batched(Ycon, LAM1D, method=nm_,
                                                strict=True), reps=20)
        times[f"tv1_batched_{m_}_{BW}_signals_s"] = BW / (
            times[f"tv1_batched_{m_}_{BW}_ms"] / 1e3)
        times[f"tv1_1d_{m_}_ms"] = cuda_ms(
            lambda nm_=nm_: ptv.tv1_1d(y1, 2.0, method=nm_), reps=20)
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
        lib_ms, lib_note = pcr_library(*calls[0][1:])
        kern.append(dict(
            name=f"B2 pcr_spd_solve ({Bs}x{ns} {'/'.join(kinds)}, "
                 f"{', '.join(paths)})",
            route="cuda", source="proxtv_tpu_torch/csrc/pcr.cu",
            replaces="proxtv_tpu/ops/kernels/pcr.py:100",
            launches=len(calls),
            launches_by_path={p_: sum(1 for c in calls if c[0] == p_)
                              for p_ in paths},
            max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b,
            bound_by=f, library_ms=lib_ms, library_note=lib_note,
            library_call="torch.linalg.solve, dense, first launch",
            kernel_ms=kernel_ms, bound_ms_pcr=b_pcr, bound_by_pcr=f_pcr))
    # B1 at each main-path shape: the path's own launches replayed in order
    # (ms per launch through the wrapper; kernel_ms through the C entry
    # point with each launch's arguments made once, pn_fused.bind); the
    # bound from the iterations they ran.  Bytes: y and x, plus w_init
    # where the path passes a warm start, w where it asks for the dual, and
    # lam_full where the weights are a field (the long route's windows,
    # tv1w_2d's fibers).
    for shp, s in b1_shapes.items():
        calls = b1_calls[shp]

        def replay(fn, calls=calls):
            for _, y_, lf_, w0_, kw_ in calls:
                fn(y_, lf_, w0_, **kw_)

        ms = cuda_ms(lambda: replay(B1.pn_tv1_fused)) / len(calls)
        launchers = [B1.bind(y_, lf_, w0_, **kw_)[1]
                     for _, y_, lf_, w0_, kw_ in calls]
        kernel_ms = cuda_ms(lambda: [f() for f in launchers]) / len(calls)
        del launchers
        # the plain version over the shape's first PLAIN_SAMPLE launches:
        # at ~25 ms a launch it would take ~30 s over the 1024^2 fibers'
        # several hundred
        sample = calls[:PLAIN_SAMPLE]
        plain_ms = cuda_ms(lambda: replay(B1.pn_tv1_fused_plain, sample),
                           reps=1) / len(sample)
        Bs, ns, lam_kind = shp
        per_el = sum(8 + 4 * (w0_ is not None) + 4 * (lf_ is not None)
                     + 4 * bool(kw_.get("return_dual", True))
                     for _, _, lf_, w0_, kw_ in calls) / len(calls)
        b, f = bound_ms(Bs * ns * per_el,
                        ns * (sum(s["iters"]) / len(calls) * PN_OPS_PER_ITER
                              + Bs * (PN_OPS_INIT_WARM if s["warm"]
                                      else PN_OPS_INIT)))
        kern.append(dict(
            name=f"B1 pn_tv1_fused ({Bs}x{ns} {lam_kind} lam "
                 f"{'warm' if s['warm'] else 'cold'}, {', '.join(s['paths'])})",
            route="cuda", source="proxtv_tpu_torch/csrc/pn_fused.cu",
            replaces="proxtv_tpu/ops/kernels/pn_fused.py:329",
            launches=s["launches"],
            launches_by_path={p_: sum(1 for c in calls if c[0] == p_)
                              for p_ in s["paths"]},
            max_abs_err=s["max_abs_err"], ms=ms, plain_ms=plain_ms,
            bound_ms=b, bound_by=f, library_ms=None, kernel_ms=kernel_ms,
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
    # The 4K paths (F1) have rows of their own below; this row keeps the
    # other main-path launches.
    f1_paths = [f_calls["F1"][0]] + [f"dist world 1 {n_}" for n_ in dist1
                                     if dist1[n_]["kind"] == "cert4k"]
    b3_rest = {p_: n_ for p_, n_ in by_path["B3"].items()
               if p_ not in f1_paths}
    kern.append(dict(name=f"B3 pdhg_chunk (cert, K={k}, {Mp}x{Np} canvas)",
                     route="cuda", source="proxtv_tpu_torch/csrc/pdhg_fused.cu",
                     replaces="proxtv_tpu/ops/kernels/pdhg_fused.py:307",
                     launches=sum(b3_rest.values()),
                     launches_by_path=b3_rest,
                     max_abs_err=max(v for p_, v in b3_by_path.items()
                                     if p_ not in f1_paths),
                     cert_rel_err=b3_rel, ms=ms, plain_ms=plain_ms,
                     bound_ms=b, bound_by=f, library_ms=None,
                     kernel_ms=kernel_ms))
    # B3 on the 4K canvases (F1: the single-card certificate chunks, the
    # banded image's plain chunks, transposed to 3840 x 2160): each path's
    # first main-path chunk through the wrapper, the C entry point and the
    # plain version; max_abs_err over all of that path's launches (3b).
    for p_ in f1_paths:
        _, a_, kw_ = next(c_ for c_ in b3_calls if c_[0] == p_)
        Mp_, Np_ = a_[1].shape
        k_, cert_ = kw_["k_steps"], bool(kw_.get("cert"))
        outs_, launch_ = B3.bind(*a_, **{k2: v for k2, v in kw_.items()
                                         if k2 != "tm"})
        launch_()
        ref_ = B3.pdhg_chunk(*a_, **kw_)
        torch.cuda.synchronize()
        check(all(bool(torch.equal(u_, v_)) for u_, v_ in zip(outs_, ref_)),
              "B3's C entry point and its wrapper disagree at 4K")
        ms_ = cuda_ms(lambda: B3.pdhg_chunk(*a_, **kw_))
        kms_ = cuda_ms(launch_)
        pms_ = cuda_ms(lambda: B3.pdhg_chunk_plain(*a_, **kw_), reps=3)
        del outs_, launch_, ref_
        fields_ = 9 + 2 * (kw_.get("wr") is not None)
        b_, f_ = bound_ms(Mp_ * Np_ * 4 * fields_, Mp_ * Np_ * (
            k_ * PDHG_OPS_PER_STEP + 25 * cert_))
        kern.append(dict(
            name=f"B3 pdhg_chunk ({'cert, ' if cert_ else ''}K={k_}, "
                 f"{Mp_}x{Np_} canvas, {p_})",
            route="cuda", source="proxtv_tpu_torch/csrc/pdhg_fused.cu",
            replaces="proxtv_tpu/ops/kernels/pdhg_fused.py:307",
            launches=by_path["B3"].get(p_, 0),
            launches_by_path={p_: by_path["B3"].get(p_, 0)},
            max_abs_err=b3_by_path.get(p_, 0.0), ms=ms_, plain_ms=pms_,
            bound_ms=b_, bound_by=f_, library_ms=None, kernel_ms=kms_))
        print(f"[B3 pdhg] {p_}: {Mp_}x{Np_} canvas, K = {k_}, "
              f"{by_path['B3'].get(p_, 0)} launches; {ms_:.4f} ms a chunk "
              f"(C entry {kms_:.4f}, plain {pms_:.3f}, bound {b_:.4f} by "
              f"{f_})  ({card})")
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
    # D1-D4 at each main-path shape (10000x1000 at lam 0.7, the per-edge
    # 512x1000 batch, its signals at lam 0.7, tv1_1d's and tv1w_1d's one
    # signal): every launch held against its plain version on the card
    # (TOL["direct"]), then replayed in order: ms through the wrapper,
    # kernel_ms through the C entry point with its arguments (and D2's
    # workspace) made once, plain_ms the plain version's run on the card.
    # Bytes: y read and x written, plus the weights read; the operations:
    # *_OPS_PER_POINT a point, the least work any data needs.
    for kid, mod_, src_, line_, ops_pp, fn_name in (
            ("D1", D1, "tautstring.cu", 334, TS_OPS_PER_POINT, "tautstring"),
            ("D2", D2, "dp.cu", 632, DP_OPS_PER_POINT, "dp"),
            ("D3", D3, "condat.cu", 468, CONDAT_OPS_PER_POINT, "condat"),
            ("D4", D4, "classic_ts.cu", 854, CLASSIC_OPS_PER_POINT,
             "classic_ts")):
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
            # D3 and D4 run the plain versions' events in the same float32
            # roundings: bit for bit (no main-path row is degenerate).
            check(kid not in ("D3", "D4") or worst == 0.0,
                  f"{kid} main path {Bs}x{ns} is not bit for bit with its "
                  "plain version")
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
    # L1 (the 2D backward's flat-component labelling) at its main-path
    # launches (the T2 cells' backwards, 1 x 1024 x 1024): every launch held
    # against its plain version on the card, bit for bit on the int32
    # labels, then replayed in order: ms through the wrapper, kernel_ms
    # through the C entry point (bind), plain_ms the plain version's run on
    # the card (its trips, one host read each).  Bound: X read and the
    # labels written, 8 bytes a pixel.
    check(len(l1_calls) == sum(by_path["L1"].values()),
          "the L1 tap missed main-path launches")
    l1_shapes = {}
    for c_ in l1_calls:
        l1_shapes.setdefault(tuple(c_[1].shape), []).append(c_)
    for (Bs, Ms, Ns), calls in l1_shapes.items():
        launchers, plain_s, trips, worst = [], 0.0, 0, 0
        for _, X_, tol_ in calls:
            out = L1.component_labels(X_, tol_)
            torch.cuda.synchronize()
            L1.LABEL_TRIPS.reset()
            t0 = time.perf_counter()
            ref = L1.component_labels_plain(X_, tol_)
            torch.cuda.synchronize()
            plain_s += time.perf_counter() - t0
            trips += L1.LABEL_TRIPS.value
            worst = max(worst, int((out.long() - ref.long()).abs().max()))
            lab_, launch = L1.bind(X_, tol_)
            launch()
            torch.cuda.synchronize()
            check(bool(torch.equal(lab_, out)),
                  "L1's C entry point and its wrapper disagree")
            launchers.append(launch)
        check(worst == 0, f"L1 main path {Bs}x{Ms}x{Ns}: labels part from "
              f"the plain version's by up to {worst}")
        paths = sorted({c_[0] for c_ in calls})

        def replay(calls=calls):
            for _, X_, tol_ in calls:
                L1.component_labels(X_, tol_)

        def replay_c(launchers=launchers):
            for launch in launchers:
                launch()

        ms = cuda_ms(replay) / len(calls)
        kernel_ms = cuda_ms(replay_c) / len(calls)
        px = Bs * Ms * Ns
        b, f = bound_ms(8 * px, LABEL_OPS_PER_PIXEL * px)
        kern.append(dict(
            name=f"L1 component_labels ({Bs}x{Ms}x{Ns}, {', '.join(paths)})",
            route="cuda", source="proxtv_tpu_torch/csrc/labels.cu",
            replaces="proxtv_tpu/ops/diffprox.py:105 (XLA while_loop; no "
                     "TPU kernel)",
            launches=len(calls),
            launches_by_path={p_: sum(1 for c in calls if c[0] == p_)
                              for p_ in paths},
            max_abs_err=float(worst), ms=ms,
            plain_ms=plain_s * 1e3 / len(calls), bound_ms=b, bound_by=f,
            library_ms=None, kernel_ms=kernel_ms,
            plain_trips_per_launch=trips / len(calls)))
        print(f"[L1 labels] main path {Bs}x{Ms}x{Ns} ({len(calls)} launches)"
              f": labels equal to the plain version's (max |difference| "
              f"{worst}); the plain version took {trips / len(calls):.1f} "
              f"trips a launch")
    # L1's stress images at 1024^2, off the main path: a flat image (one
    # component of 2^20 pixels) and a serpentine one (one path through half
    # the image), each held against its known labels; the flat one also
    # against the plain version (~1000 trips), the serpentine's plain run
    # (2^18 trips) is not measured.
    l1_stress = {}
    for name_, (X_np, lab_np) in (
            (f"flat {M2D}^2", (np.zeros((M2D, N2D), np.float32),
                               np.zeros((M2D, N2D), np.int32))),
            (f"serpentine {M2D}^2", serpentine(M2D, N2D))):
        X_ = t(X_np[None])
        tol_ = diffprox._seg_tol(X_)
        out = L1.component_labels(X_, tol_)
        torch.cuda.synchronize()
        check(bool(torch.equal(out.cpu(), torch.from_numpy(lab_np[None]))),
              f"L1 on the {name_} image: wrong labels")
        plain_ms = None
        if name_.startswith("flat"):
            L1.LABEL_TRIPS.reset()
            t0 = time.perf_counter()
            ref = L1.component_labels_plain(X_, tol_)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            check(bool(torch.equal(out, ref)), f"L1 on the {name_} image "
                  "parts from the plain version")
        _, launch = L1.bind(X_, tol_)
        b, f = bound_ms(8 * M2D * N2D, LABEL_OPS_PER_PIXEL * M2D * N2D)
        l1_stress[name_] = {
            "ms": cuda_ms(lambda: L1.component_labels(X_, tol_)),
            "kernel_ms": cuda_ms(launch), "plain_ms": plain_ms,
            "plain_trips": L1.LABEL_TRIPS.value if plain_ms else None,
            "bound_ms": b, "bound_by": f}
        r_ = l1_stress[name_]
        print(f"[L1 labels] {name_} (off the main path): {r_['ms']:.4f} ms "
              f"(C entry {r_['kernel_ms']:.4f} ms, bound {b:.4f} ms by {f}, "
              f"plain " + (f"{plain_ms:.4f} ms, {r_['plain_trips']} trips"
                           if plain_ms else "not measured") + f")  ({card})")
    report["l1_stress"] = l1_stress
    for k_ in kern:
        extra = "".join(f", {key} {k_[key]:.4f} ms" for key in (
            "kernel_ms", "bound_ms_pcr", "library_ms")
            if k_.get(key) is not None)
        if k_.get("library_note"):
            extra += f", library {k_['library_note']}"
        print(f"[kernel] {k_['name']}: {k_['ms']:.4f} ms (plain "
              f"{k_['plain_ms']:.4f} ms, bound {k_['bound_ms']:.4f} ms by "
              f"{k_['bound_by']}{extra}), {k_['launches']} launches on the "
              f"main path {k_['launches_by_path']}  ({card})")

    stamp("phase 4 done")
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
                     ("tv1_batched 512 condat D3",
                      lambda: tv1d_l1.tv1_batched(Ycon, LAM1D, method="condat",
                                                  strict=True)),
                     ("tv1_batched 512 classictautstring D4",
                      lambda: tv1d_l1.tv1_batched(
                          Ycon, LAM1D, method="classictautstring",
                          strict=True)),
                     ("tv1_1d condat D3", lambda: ptv.tv1_1d(
                         y1, 2.0, method="condat")),
                     ("tv1_1d classictautstring D4", lambda: ptv.tv1_1d(
                         y1, 2.0, method="classictautstring")),
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
              f"{b_['busy_ms']:.3f} ms ({b_['busy_source']}), idle share "
              f"{b_['idle_share']}; "
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

    stamp("phase 5 done")
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
                  f"{s_['fwd']['B3']} launches, backward L1 "
                  f"{s_['bwd']['L1']} launches, host syncs forward "
                  f"{s_['fwd']['host_syncs']} backward "
                  f"{s_['bwd']['host_syncs']}, label trips "
                  f"{s_['bwd']['label_trips']}  ({card})")
        top = ", ".join(f"{k_} {v:.3f} ms" for k_, v in prof["top"])
        print(f"[train] {name_} ({desc_}): the counted run launched "
              f"{m_['launches']['B1']} B1, {m_['launches']['B3']} B3 and "
              f"{m_['launches']['L1']} L1, {m_['host_syncs']} host syncs, "
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

    # The redesign queue: each kernel's device time over one pass of every
    # main-path call that launches it (the profiled calls of phase 5 and the
    # dist phase's world-1 calls, profiled in phase 3e), less the
    # bounds of those launches where phase 4 timed the kernel at the path's
    # own shape (B1, B2, B4, B5, D1-D4 and L1 at each of their shapes, B3,
    # B6).  L1 runs only in the training cells' backwards: its device time
    # is the profiled step's (one launch, phase 6) times the cell's
    # main-path launches.
    # A kernel that no profiler window recorded is timed by CUDA events
    # around its wrapper calls (profile_call; "events" on its line).
    at_shape = {"B6": sum(by_path["B6"].values())}
    queue = {}
    for kid in counters:
        profs = (*breakdown.values(), *dist_prof.values(), *f_prof.values())
        dev_ms = sum(b_["ours"].get(kid, 0.0) for b_ in profs)
        src = {b_.get("ours_source", {}).get(kid) for b_ in profs} - {None}
        if kid == "L1":
            dev_ms = sum(v["profile"]["ours"].get("L1", 0.0)
                         * by_path["L1"].get(train_main[c_]["path"], 0)
                         for c_, v in train_times.items())
            src = {v["profile"].get("ours_source", {}).get("L1")
                   for v in train_times.values()} - {None}
        per_shape = kid in ("B1", "B2", "B3", "B4", "B5", "D1", "D2", "D3",
                            "D4", "L1")
        bnd = sum(k_["bound_ms"] * (k_["launches"] if per_shape
                                    else at_shape.get(kid, 0))
                  for k_ in kern if k_["name"].startswith(kid + " "))
        queue[kid] = {"device_ms": dev_ms, "bound_ms": bnd,
                      "gap_ms": dev_ms - bnd,
                      "launches": sum(by_path[kid].values()),
                      "source": sorted(src)}
    for kid, q in sorted(queue.items(), key=lambda kv: -kv[1]["gap_ms"]):
        print(f"[queue] {kid}: {q['device_ms']:.4f} ms of device time over "
              f"{q['launches']} main-path launches, bounds {q['bound_ms']:.4f}"
              f" ms: {q['gap_ms']:.4f} ms over ("
              + (" and ".join(q["source"]) or "no profiled call")
              + f")  ({card})")
        check(q["launches"] == 0 or q["device_ms"] > 0,
              f"[queue] {kid}: no device time over its main-path launches")

    stamp("phase 6 done")
    # -- 7. float64 on the card ------------------------------------------
    kern64, report["float64"], outs64 = float64_phase(
        card, inp64, jobs64, Y2, y1, x_ref, F_ref, x_dr, dict(
            V=V, Y5=Y5, noisy_t2=noisy_t2, truth_t2=truth_t2,
            x_p2_ref=x_p2_ref, x_2p_ref=x_2p_ref, x_ref3=x_ref3,
            F3_ref=F3_ref, gap_ref3=gap_ref3, xl1_ref=xl1_ref,
            dF_gen32=xc["tvgen Parallel Dykstra (main path, 35 sweeps)"][
                "F_minus_F_ref"]))
    kern += kern64
    stop_pools()
    stamp("phase 7 done")
    # -- 8. the numpy API in float64 on the card --------------------------
    report["api64"] = api64_phase(card, ptv, dict(
        y1=y1, ww1=ww1, Y1=Y1, Y2=Y2, Wc2=Wc2, Wr2=Wr2, Y5=Y5, V=V,
        ylong=ylong, yc2=yc2), outs64, times)
    del outs64
    kern_api = direct64_api_kernels(card, y1, ww1, report["api64"])
    kern += kern_api
    kern64 += kern_api
    # The float64 queue: each double kernel's launches in phases 7 and 8
    # times its C entry's time less its bound, summed over its shapes.
    queue64 = {}
    for k_ in kern64:
        kid = k_["name"].split(" ", 1)[0]
        q = queue64.setdefault(kid, {"gap_ms": 0.0, "launches": 0,
                                     "shapes": 0})
        q["gap_ms"] += k_["launches"] * (k_["kernel_ms"] - k_["bound_ms"])
        q["launches"] += k_["launches"]
        q["shapes"] += 1
    for kid, q in sorted(queue64.items(), key=lambda kv: -kv[1]["gap_ms"]):
        print(f"[queue64] {kid}: {q['launches']} phase-7 and phase-8 launches "
              f"x (C entry - bound), over {q['shapes']} shapes: "
              f"{q['gap_ms']:.4f} ms  ({card})")
    for k_ in kern64:
        kid = k_["name"].split(" ", 1)[0]
        if kid in ("D1.f64", "D2.f64"):
            print(f"[queue64 {kid}] {k_['name']}: {k_['launches']} launches "
                  f"x ({k_['kernel_ms']:.4f} - {k_['bound_ms']:.7f}) ms  "
                  f"({card})")
    report["queue64"] = queue64
    stamp("phase 8 done")

    report.update(errors=errs, main_path=main, times=times, kernels=kern,
                  queue=queue,
                  breakdown=breakdown,
                  tolerances=TOL, total_s=time.perf_counter() - t_all,
                  auto_iters=int(info_auto.iters[0]),
                  dr_sweeps=int(info_dr.iters[0]), cross_check=xc,
                  F_ref=F_ref, gap_ref=gap_ref, F3_ref=F3_ref,
                  gap_ref3=gap_ref3, tvgen_nd_iters=int(info_3d.iters[0]),
                  tvgen_sweeps=int(info_gen.iters[0]),
                  b1_shapes={f"{a}x{b} {c}": v
                             for (a, b, c), v in b1_shapes.items()})
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
    ap.add_argument("--dist-rank", type=int, default=None,
                    help="run one rank of the dist phase's gloo world "
                         "(started by the dist phase itself)")
    ap.add_argument("--dist-dir", default=None,
                    help="the dist phase's working directory")
    args = ap.parse_args()
    try:
        if args.dist_rank is not None:
            dist_rank(args.dist_rank, args.dist_dir, card_line())
        else:
            main(args.out)
    except Fail as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
    finally:
        stop_pools()
