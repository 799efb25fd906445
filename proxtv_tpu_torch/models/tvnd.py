"""Batched ND generalized-TV proximity combiners (port of
``proxtv_tpu.models.tvnd``).

Solves, for a batch of K-dimensional tensors,

    min_X 0.5 ||X - Y||^2 + sum_i w_i * TV_{p_i}(X along dim d_i)

for a list of penalty terms (w_i, d_i, p_i), p_i >= 1 — the reference's
generalized-TV problem (``src/TVNDopt.cpp``, ``TVgenopt.cpp:25-34``).  Each
term's prox is a batched 1D prox over every fiber along its dimension
(kernel B1 for p = 1, B4 for p = 2, B5 for TV-Lp inside its gate on the
card; for a float64 CUDA stack the JAX package's float64 route of
``tv2d._prox1d_ws``: ``tv1_pn`` and the TV-L2 and TV-Lp compositions, their
systems on kernel B2 in float64).

Engines:

*   :func:`tv_nd_batched` with ``method='pd'`` — Parallel Proximal Dykstra
    (reference ``PD_TV``, src/TVNDopt.cpp:48); ``'pd2'`` — sequential
    Dykstra for two terms (``PD2_TV``, src/TV2Dopt.cpp:59); ``'pdr'`` —
    Parallel Douglas-Rachford (``PDR_TV``, src/TVNDopt.cpp:280); ``'yang'`` —
    consensus ADMM with rho = 10 (``Yang3_TV``, src/TVNDopt.cpp:678);
    ``'condat'`` / ``'chambolle-pock'`` / ``'chambolle-pock-acc'`` — the
    chunked 3D primal-dual solve over kernel B6, for (B, L, M, N) float32
    volumes on the card penalized on all three dims with p = 1 (a float64
    volume raises the JAX package's error: it has no float64 primal-dual
    ND route).
*   :func:`tv_value` — the generalized TV penalty value (reference
    ``TVval``, src/TVNDopt.cpp:524).
*   :func:`tvgen_dispatch` — the intended dispatch rule (MATLAB
    ``matlab/solveTVgen.cpp:90-97``): 2D signal penalized on both dims -> 2D
    dr; two terms -> sequential Dykstra; more -> Parallel Dykstra.

Dimension indices ``ds`` are 1-based over the signal dimensions: ``d=1``
penalizes fibers along the first signal axis.  All entry points take
(B, *signal_dims) stacks.  The loops are Python loops: each combiner sweep
and each primal-dual certificate reads one small value to the host.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kernels import gating
from ..utils import debug
from ..utils.config import DEFAULT_COMBINER, CombinerConfig
from ..utils.info import RC_ITERS, RC_OK, make_info
from ..utils.lpnorms import lp_norm
from . import tv2d


def _fibers(X, dim: int):
    """(B, *dims) -> (fibers, n) along signal dim ``dim`` (1-based), and the
    function that puts a (fibers, n) result back."""
    Xm = torch.movedim(X, dim, -1)
    lead = Xm.shape[:-1]
    n = Xm.shape[-1]

    def back(out):
        return torch.movedim(out.reshape(lead + (n,)), -1, dim)

    return Xm.reshape(-1, n), back


def _prox_along(X, dim: int, lam, p: float, method: str = "pn"):
    """Batched 1D prox along signal dim ``dim`` (1-based) of (B, *dims) X."""
    Y2, back = _fibers(X, dim)
    return back(tv2d._prox1d(Y2, lam, p, method))


def _prox_along_ws(X, dim: int, lam, p: float, method: str, state):
    """Stateful (warm-started) fiber prox along ``dim``; the state is the
    per-fiber dual (p = 1), secular alpha (p = 2) or TV-Lp (dual, KKT
    multiplier) pair, carried across sweeps."""
    Y2, back = _fibers(X, dim)
    out, state = tv2d._prox1d_ws(Y2, lam, p, method, state)
    return back(out), state


def _state_init(X, dim: int, p: float = 1.0):
    n = X.shape[dim]
    return tv2d._prox_state_init(X.numel() // n, n, p, X.dtype, X.device)


def _norm_along(X, dim: int, p: float):
    """Sum over fibers of ||D fiber||_p along signal dim ``dim`` (per batch)."""
    Xm = torch.movedim(X, dim, -1)
    d = Xm[..., 1:] - Xm[..., :-1]
    return torch.sum(lp_norm(d, p).reshape(X.shape[0], -1), dim=-1)


def tv_value(X, ws, ds: Sequence[int], ps):
    """Generalized TV penalty value of a single (unbatched) tensor
    (reference TVval, src/TVNDopt.cpp:524); a 0-d tensor."""
    X = X[None]
    tot = torch.zeros((), dtype=X.dtype, device=X.device)
    for w, d, p in zip(ws, ds, ps):
        tot = tot + w * _norm_along(X, int(d), float(p))[0]
    return tot


def _mean_abs_change(x, x_last):
    B = x.shape[0]
    return torch.mean(torch.abs(x - x_last).reshape(B, -1), dim=-1)


def _loop(body, init_state, x_of, cap, tol):
    """Per-tensor diagnostics (reference per-solve info[],
    src/general.h:58-61): ``iters`` counts the sweeps each batch element ran
    before its own mean change dropped below tol.  Unlike the 2D combiner
    loop, converged elements keep sweeping with the rest (the JAX package's
    lock-step loop)."""
    x_last = x_of(init_state)
    B = x_last.shape[0]
    dev = x_last.device
    state = init_state
    delta = torch.full((B,), float("inf"), dtype=x_last.dtype, device=dev)
    iters_img = torch.zeros((B,), dtype=torch.int32, device=dev)
    running = torch.ones((B,), dtype=torch.bool, device=dev)
    iters = 0
    while iters < cap and debug.host(torch.any(running)):
        state = body(state)
        x = x_of(state)
        delta = torch.where(running, _mean_abs_change(x, x_last), delta)
        iters_img = iters_img + running.to(torch.int32)
        running = running & (delta > tol)
        iters += 1
        debug.dprint("ND combiner iter {i}: max mean-change {d}", i=iters,
                     d=torch.amax(delta))
        x_last = x
    rc = torch.where((iters_img >= cap) & (delta > tol), RC_ITERS, RC_OK)
    return x_of(state), make_info(iters_img, delta, rc)


# ---------------------------------------------------------------------------
# Chunked 3D primal-dual solve (kernel B6)
# ---------------------------------------------------------------------------


def _pdhg3d_fused_ok(Y, ds, ps):
    """The 3D primal-dual engines need (B, L, M, N) volumes penalized on all
    three signal dims with p = 1, on the card: True there, False on the CPU
    and for a float64 volume (the JAX gate's answer); a CUDA volume the
    kernel cannot take otherwise (another dtype, N outside 1..2048) raises
    in ``gating.gate``."""
    return (Y.ndim == 4 and tuple(sorted(ds)) == (1, 2, 3)
            and all(p == 1.0 for p in ps) and gating.gate(Y, "pdhg3d"))


def _run_pdhg3d_fused(Y, lams_by_dim, cap, cfg, variant: str, gap_tol=None,
                      obj_target=None, schedule_override=None,
                      k_steps: int = None, tile=None):
    """Chunked 3D PDHG solve over the chunk kernel: the volumes are stacked
    along L into one (B*L, M, N) canvas (the last layer of each volume
    carries lam = 0 on its L edge, which decouples it from the next), and
    stops on the per-volume duality-gap certificate (see
    ``tv2d._run_pdhg_fused``: the same contract with three dual fields).

    ``lams_by_dim``: (lam_L, lam_M, lam_N) scalar penalties per signal dim.
    ``schedule_override``: optional (sigma0, cap_mult) replacing the
    auto-tuned cp-acc schedule (cap_mult only acts with ``'cp-acc'``).
    ``k_steps``/``tile``: chunk length and the kernel's block, a (tm, tn)
    core of columns that marches along segments of tl layers (default
    :func:`gating.pdhg3d_params`; pinning ``k_steps`` to the JAX package's
    value reproduces its certificate cadence).  The JAX driver's rotation of
    the best lane axis into last place and its canvas padding (TPU lane and
    sublane rules) are dropped: the CUDA kernel tiles M and N and marches
    along L, so any canvas fits it.

    The certificate runs between chunks, every ~24 iterations, as a torch
    composition: from the duals, xhat = Y - D'u is dual-feasible and
    gap(xhat, u) >= 0 bounds the objective suboptimality of xhat, the
    returned iterate.  One host read per certificate.
    Reference algorithm covered: Yang3_TV (src/TVNDopt.cpp:678-781),
    re-posed primal-dual and fused.
    """
    from ..ops.kernels import pdhg3d_fused as PK3

    B, L, M, N = Y.shape
    dt, dev = Y.dtype, Y.device
    npd = tv2d._np_dtype(dt)
    k_auto, tile_auto = gating.pdhg3d_params()
    k_steps = k_steps or k_auto
    tile = tile or tile_auto
    lam_L, lam_M, lam_N = [npd(v) for v in lams_by_dim]

    if schedule_override is not None:
        sigma0, cap_mult = [npd(v) for v in schedule_override]
    elif variant == "cp-acc":
        lam_eff = max(lam_L, lam_M, lam_N)
        s0_t, cap_t = tv2d._pdhg_sigma_schedule(Y, lam_eff, dt)
        s0_h, cap_h = debug.host(torch.stack([s0_t, cap_t]))
        sigma0, cap_mult = npd(s0_h), npd(cap_h)
    else:
        sigma0, cap_mult = npd(cfg.cp_sigma), 2.0
    tau0 = npd(0.9) / (npd(12.0) * sigma0)  # ||D||^2 <= 12, three axes

    Ypad = Y.reshape(B * L, M, N).contiguous()
    geo = dict(n_valid=N, m_valid=M, l_valid=L, stride=L, count=B)
    v1, v2, v3 = PK3.masks3(Ypad.shape, device=dev, **geo)
    zero = torch.zeros((), dtype=dt, device=dev)
    lam1 = float(lam_N) * v1.to(dt)
    lam2 = float(lam_M) * v2.to(dt)
    lam3 = float(lam_L) * v3.to(dt)

    def dT(U, dim):
        return U - PK3._prev(U, dim)

    def d_(X, dim):
        return X - PK3._next(X, dim)

    def per_vol(E):
        return torch.sum(E.reshape(B, -1), dim=-1)

    def gap_and_primal(u1, u2, u3):
        """Per-volume duality gap; where(), not *mask, so garbage cannot
        leak in (0 * NaN = NaN)."""
        u1 = torch.where(v1, u1, zero)
        u2 = torch.where(v2, u2, zero)
        u3 = torch.where(v3, u3, zero)
        xhat = Ypad - (dT(u1, 2) + dT(u2, 1) + dT(u3, 0))
        g1 = d_(xhat, 2) * v1
        g2 = d_(xhat, 1) * v2
        g3 = d_(xhat, 0) * v3
        e = (lam1 * torch.abs(g1) - u1 * g1 + lam2 * torch.abs(g2) - u2 * g2
             + lam3 * torch.abs(g3) - u3 * g3)
        gap_b = per_vol(e)
        obj_b = (0.5 * per_vol((xhat - Ypad) ** 2)
                 + per_vol(lam1 * torch.abs(g1) + lam2 * torch.abs(g2)
                           + lam3 * torch.abs(g3)))
        return gap_b, obj_b, xhat

    feps = npd(np.finfo(npd).eps)
    gtol = (max(npd(cfg.pdhg_gap_tol), npd(64.0) * feps) if gap_tol is None
            else npd(gap_tol))
    obj_tgt = (np.full((B,), -np.inf, npd) if obj_target is None
               else np.broadcast_to(np.asarray(obj_target, npd), (B,)))

    def still_running(gap_b, obj_b):
        return (gap_b > gtol * np.maximum(npd(1.0), obj_b)) & (obj_b > obj_tgt)

    def chunk_call(sd, x, xb, u1, u2, u3):
        sd_t = torch.from_numpy(sd).to(dev)
        return PK3.pdhg3d_chunk(sd_t, x, xb, u1, u2, u3, Ypad,
                                k_steps=k_steps, grad_step=variant == "condat",
                                tile=tile, **geo)

    # Certificate every ~24 iterations; the gap-stall restart controller of
    # the 2D solver (tv2d.py:640-716 of the JAX package): the stall statistic
    # is the gap summed over still-running volumes.
    cpc = max(1, 24 // k_steps)
    cap_pad = -(-cap // (cpc * k_steps)) * (cpc * k_steps)
    sig0f, tau0f = np.float32(sigma0), np.float32(tau0)
    lams_f = (lam_N, lam_M, lam_L)
    restart = variant == "cp-acc"
    LOOK, DECAY, GROW = 3, np.float32(0.7), np.float32(4.0)

    x = xb = Ypad
    u1 = u2 = u3 = torch.zeros_like(Ypad)
    sc = (sig0f, tau0f)
    cap_mult_d = np.float32(cap_mult)
    hist = [np.float32(np.inf)] * LOOK
    t = 0
    gap_b = np.full((B,), np.inf, npd)
    iters_img = np.zeros((B,), np.int32)
    running = np.ones((B,), bool)
    while t < cap_pad and running.any():
        for _ in range(cpc):
            sd, sc = PK3.sched_chunk3(sc, k_steps, lams_f, sig0f, cap_mult_d,
                                      variant)
            x, xb, u1, u2, u3 = chunk_call(sd, x, xb, u1, u2, u3)
            t += k_steps
        iters_img = iters_img + np.int32(cpc * k_steps) * running
        g_t, o_t, _ = gap_and_primal(u1, u2, u3)
        g_h, o_h = debug.host(torch.stack([g_t, o_t]))
        gap_new = np.asarray(g_h, npd)
        obj_b = np.asarray(o_h, npd)
        if restart:
            gsum = np.float32(np.sum(np.where(running, gap_new, npd(0.0))))
            if gsum > DECAY * hist[0]:
                sc = (sig0f, tau0f)
                with np.errstate(over="ignore"):  # float32 inf, as in JAX
                    cap_mult_d = np.float32(cap_mult_d * GROW)
            hist = hist[1:] + [gsum]
        gap_b = np.where(running, gap_new, gap_b)
        running = running & still_running(gap_b, obj_b)
        debug.dprint("3D PDHG iter {t}: gaps {g}", t=t, g=gap_b)

    gap_t, obj_t, xhat = gap_and_primal(u1, u2, u3)
    out = xhat.reshape(B, L, M, N)
    rc = torch.where((gap_t > float(gtol) * torch.clamp(obj_t, min=1.0))
                     & (obj_t > torch.from_numpy(obj_tgt.copy()).to(dev)),
                     RC_ITERS, RC_OK)
    return out, make_info(torch.from_numpy(iters_img).to(dev), gap_t, rc)


def _run_pdhg3d_fused_banded(Yl, lam, *, cap, cfg, variant: str, mesh,
                             L: int, M: int, N: int, k_steps: int, tile,
                             gap_tol=None):
    """Chunked 3D PDHG solve of ONE volume layer-banded over a mesh (port
    of the JAX package's ``_run_pdhg3d_fused_banded``, ``tvnd.py:342``;
    the exactness argument is the 2D one, ``tv2d._run_pdhg_fused_banded``).

    Runs on every rank of ``mesh``: ``Yl`` is this rank's
    (local_layers, M, N) slab of the volume, padded after layer L.  Before
    every K-step chunk of kernel B6 the five fields' 2K-layer halos are
    refreshed from the neighbours' core layers (``pad_top = 2K - rank *
    local_layers``); the certificate is summed over the core layers and
    all-reduced every ~24 iterations (one host sync).  The schedule is the
    JAX driver's precomputed one, without the gap-stall restart.  ``tile``
    is B6's block on the card.  Returns this rank's (local_layers, M, N)
    layers of the solution and the volume's (1,)-shaped ``SolverInfo``.
    """
    from ..ops.kernels import pdhg3d_fused as PK3
    from ..parallel import comm

    local, _, _ = Yl.shape
    hl = 2 * k_steps
    dt, dev = Yl.dtype, Yl.device
    npd = tv2d._np_dtype(dt)
    d = mesh.rank
    loff = hl - d * local
    lam = npd(lam)

    if variant == "cp-acc":
        # The schedule from global statistics, all-reduced (the single-card
        # driver's rule, as the JAX driver inlines it).
        gl = torch.arange(local, device=dev) + d * local
        vlay = (gl < L).to(dt)[:, None, None]
        dY = Yl[:, :, 1:N] - Yl[:, :, :N - 1]
        ssum, cnt = [npd(v) for v in comm.reduce_host(mesh, torch.stack([
            torch.sum(dY * dY * vlay),
            torch.sum(torch.broadcast_to(vlay, dY.shape))]))]
        noise = np.sqrt(max(ssum / max(cnt, npd(1.0)) * npd(0.5),
                            npd(1e-12)))
        lam_rel = npd(lam / noise)
        sigma0 = npd(0.5) * max(npd(1.0), lam_rel)
        cap_mult = npd(max(npd(1.0), (lam_rel / npd(0.3)) ** npd(1.5))
                       / sigma0)
    else:
        sigma0, cap_mult = npd(cfg.cp_sigma), 2.0
    tau0 = npd(0.9) / (npd(12.0) * sigma0)

    cpc = max(1, 24 // k_steps)
    cap_pad = -(-cap // (cpc * k_steps)) * (cpc * k_steps)
    sched = PK3.make_schedule3(cap_pad, (lam, lam, lam), sigma0, tau0,
                               variant, cap_mult=cap_mult)

    # The data canvas with the neighbours' layers in its L halo (a zero
    # halo would shift the boundary layers' fixed point).
    Ypad = comm.halo_exchange(
        mesh, [F.pad(Yl, (0, 0, 0, 0, hl, hl)).contiguous()], hl, local)[0]
    gl = (torch.arange(2 * hl + local, device=dev)[:, None, None] - hl
          + d * local)
    rm = torch.arange(M, device=dev)[None, :, None]
    col = torch.arange(N, device=dev)[None, None, :]
    in_vol = (gl >= 0) & (gl < L)
    v1 = in_vol & (col < N - 1)
    v2 = in_vol & (rm < M - 1)
    v3 = in_vol & (gl < L - 1)
    lam1, lam2, lam3 = (float(lam) * v.to(dt) for v in (v1, v2, v3))
    core = ((gl >= d * local) & (gl < (d + 1) * local)).to(dt)
    zero = torch.zeros((), dtype=dt, device=dev)

    def dT(U, dim):
        return U - PK3._prev(U, dim)

    def d_(X, dim):
        return X - PK3._next(X, dim)

    def gap_and_primal(u1, u2, u3):
        u1 = torch.where(v1, u1, zero)
        u2 = torch.where(v2, u2, zero)
        u3 = torch.where(v3, u3, zero)
        xhat = Ypad - (dT(u1, 2) + dT(u2, 1) + dT(u3, 0))
        g1 = d_(xhat, 2) * v1
        g2 = d_(xhat, 1) * v2
        g3 = d_(xhat, 0) * v3
        e = (lam1 * torch.abs(g1) - u1 * g1 + lam2 * torch.abs(g2) - u2 * g2
             + lam3 * torch.abs(g3) - u3 * g3)
        obj = (0.5 * (xhat - Ypad) ** 2 * in_vol + lam1 * torch.abs(g1)
               + lam2 * torch.abs(g2) + lam3 * torch.abs(g3))
        gap, ob = comm.reduce_host(mesh, torch.stack(
            [torch.sum(e * core), torch.sum(obj * core)]))
        return npd(gap), npd(ob), xhat

    feps = npd(np.finfo(npd).eps)
    gtol = (max(npd(cfg.pdhg_gap_tol), npd(64.0) * feps) if gap_tol is None
            else npd(gap_tol))
    geo = dict(k_steps=k_steps, n_valid=N, m_valid=M, l_valid=L, stride=L,
               count=1, pad_top=loff, pad_m=0,
               grad_step=variant == "condat", tile=tile)
    x, xb = Ypad.clone(), Ypad.clone()
    u1, u2, u3 = (torch.zeros_like(Ypad) for _ in range(3))
    t, iters, gap_b, running = 0, 0, npd(np.inf), True
    while t < cap_pad and running:
        for _ in range(cpc):
            comm.halo_exchange(mesh, [x, xb, u1, u2, u3], hl, local)
            sd = torch.from_numpy(sched[t:t + k_steps]).to(dev)
            x, xb, u1, u2, u3 = PK3.pdhg3d_chunk(sd, x, xb, u1, u2, u3, Ypad,
                                                 **geo)
            t += k_steps
        iters += cpc * k_steps
        comm.halo_exchange(mesh, [u1, u2, u3], hl, local)
        gap_b, obj, _ = gap_and_primal(u1, u2, u3)
        running = bool(gap_b > gtol * max(npd(1.0), obj))
        debug.dprint("banded 3D PDHG iter {t}: gap {g}", t=t, g=float(gap_b))

    comm.halo_exchange(mesh, [u1, u2, u3], hl, local)
    gap_b, obj, xhat = gap_and_primal(u1, u2, u3)
    rc = RC_ITERS if gap_b > gtol * max(npd(1.0), obj) else RC_OK
    info = make_info(torch.tensor([iters], device=dev),
                     torch.tensor([gap_b], dtype=dt, device=dev),
                     torch.tensor([rc], device=dev))
    return xhat[hl:hl + local], info


# ---------------------------------------------------------------------------
# Public batched entry points
# ---------------------------------------------------------------------------

_PD_VARIANTS = {"condat": "condat", "chambolle-pock": "cp",
                "chambolle-pock-acc": "cp-acc"}


def tv_nd_batched(Y, ws, ds, ps, max_iters: int = 0, method: str = "pd",
                  inner_method: str = "pn",
                  cfg: CombinerConfig = DEFAULT_COMBINER):
    """Batched generalized ND TV prox on a (B, *dims) tensor stack, on
    whatever device ``Y`` lies.

    Args:
        Y: (B, *dims) tensor stack.
        ws: penalty weights.
        ds: 1-based penalized dimensions.
        ps: norm degrees, each >= 1.
        method: 'pd' (Parallel Proximal Dykstra, default), 'pd2' (sequential
            Dykstra, exactly two terms), 'pdr' (Parallel Douglas-Rachford),
            'yang' (consensus ADMM), or — for (B, L, M, N) float32 volumes on
            the card penalized on all dims with p = 1 — the primal-dual
            engines 'condat' / 'chambolle-pock' / 'chambolle-pock-acc'
            (kernel B6; anything else raises ``ValueError``, on the CPU
            too, as the JAX package does off its accelerator).

    Returns (X, SolverInfo) with per-tensor iters / gap / rc.
    """
    ws = tuple(float(w) for w in ws)
    ds = tuple(int(d) for d in ds)
    ps = tuple(float(p) for p in ps)
    npen = len(ws)
    tol = cfg.stop

    def prox_i(i, V, scale, st):
        return _prox_along_ws(V, ds[i], ws[i] * scale, ps[i], inner_method,
                              st)

    if npen == 1:
        x, _ = prox_i(0, Y, 1.0, _state_init(Y, ds[0], ps[0]))
        B = Y.shape[0]
        return x, make_info(
            torch.zeros((B,), dtype=torch.int32, device=Y.device),
            torch.zeros((B,), dtype=Y.dtype, device=Y.device),
            torch.zeros((B,), dtype=torch.int32, device=Y.device))

    method = method.lower()
    if method in _PD_VARIANTS:
        if not _pdhg3d_fused_ok(Y, ds, ps):
            raise ValueError(
                "primal-dual ND methods need (B, L, M, N) float32 volumes on "
                "the card penalized on dims (1, 2, 3) with p = 1; use "
                "method='pd', 'pdr' or 'yang'")
        lam_by = {d: w for w, d in zip(ws, ds)}
        cap = max_iters or cfg.max_iters_condat
        return _run_pdhg3d_fused(Y, (lam_by[1], lam_by[2], lam_by[3]), cap,
                                 cfg, _PD_VARIANTS[method])

    states0 = tuple(_state_init(Y, ds[i], ps[i]) for i in range(npen))
    if method == "pd2":
        # Sequential Proximal Dykstra for exactly two terms (reference
        # PD2_TV, src/TV2Dopt.cpp:59): alternating proxes with p/q
        # correction terms, no lambda rescale and no averaging.
        if npen != 2:
            raise ValueError("method 'pd2' (sequential Dykstra) requires "
                             "exactly 2 penalty terms")
        cap = max_iters or cfg.max_iters_pd

        def body(state):
            x, p, q, s1, s2 = state
            xp, s1 = prox_i(0, x + p, 1.0, s1)
            p = x + p - xp
            x2, s2 = prox_i(1, xp + q, 1.0, s2)
            q = xp + q - x2
            return x2, p, q, s1, s2

        z = torch.zeros_like(Y)
        return _loop(body, (Y, z, z, states0[0], states0[1]),
                     lambda s: s[0], cap, tol)

    if method == "pd":
        # Parallel Dykstra: z_i staging, lambda_i * npen rescale, mean
        # combine (reference src/TVNDopt.cpp:100-101, 212-214).
        cap = max_iters or cfg.max_iters_pd

        def body(state):
            x, zs, sts = state
            outs = [prox_i(i, zs[i], float(npen), sts[i])
                    for i in range(npen)]
            prox_out = [o[0] for o in outs]
            x_new = sum(prox_out) / npen
            zs_new = tuple(x_new + zs[i] - prox_out[i] for i in range(npen))
            return x_new, zs_new, tuple(o[1] for o in outs)

        return _loop(body, (Y, tuple(Y for _ in range(npen)), states0),
                     lambda s: s[0], cap, tol)

    if method == "pdr":
        # Product-space Douglas-Rachford: each component prox carries 1/npen
        # of the quadratic term (reference PDR_TV, src/TVNDopt.cpp:465-468).
        cap = max_iters or cfg.max_iters_dr
        gamma = 1.0
        a = gamma / npen

        def prox_g(i, v, st):
            t = (v + a * Y) / (1.0 + a)
            return prox_i(i, t, gamma / (1.0 + a), st)

        def body(state):
            zs, sts = state
            x = sum(zs) / npen
            outs = [prox_g(i, 2.0 * x - zs[i], sts[i]) for i in range(npen)]
            return (tuple(zs[i] + outs[i][0] - x for i in range(npen)),
                    tuple(o[1] for o in outs))

        return _loop(body, (tuple(Y for _ in range(npen)), states0),
                     lambda s: sum(s[0]) / npen, cap, tol)

    if method == "yang":
        # Consensus ADMM, rho = 10 (reference Yang2/Yang3).
        cap = max_iters or cfg.max_iters_yang
        rho = cfg.yang_rho

        def body(state):
            x, zs, us, sts = state
            zs_new, us_new, sts_new = [], [], []
            for i in range(npen):
                z, st = prox_i(i, x + us[i], 1.0 / rho, sts[i])
                us_new.append(us[i] + x - z)
                zs_new.append(z)
                sts_new.append(st)
            x_new = (Y + rho * sum(z - u for z, u in zip(zs_new, us_new))) / (
                1.0 + npen * rho)
            return x_new, tuple(zs_new), tuple(us_new), tuple(sts_new)

        zero = torch.zeros_like(Y)
        return _loop(body, (Y, tuple(Y for _ in range(npen)),
                            tuple(zero for _ in range(npen)), states0),
                     lambda s: s[0], cap, tol)

    raise ValueError(f"Unknown ND method: {method!r}")


def tvgen_dispatch(X, ws, ds, ps, max_iters: int = 0,
                   cfg: CombinerConfig = DEFAULT_COMBINER):
    """Unbatched generalized-TV entry with the intended (MATLAB) dispatch
    (matlab/solveTVgen.cpp:90-97): a 2D signal with both dims penalized ->
    2D dr; two terms -> sequential Proximal Dykstra (``pd2``); more ->
    Parallel Proximal Dykstra.  Returns (x, info) for a single tensor."""
    ws = tuple(float(w) for w in ws)
    ds = tuple(int(d) for d in ds)
    ps = tuple(float(p) for p in ps)
    if X.ndim == 2 and len(ws) == 2 and set(ds) == {1, 2}:
        i_col = ds.index(1)
        i_row = ds.index(2)
        x, info = tv2d.tvp_2d_batched(X[None], ws[i_col], ws[i_row],
                                      ps[i_col], ps[i_row],
                                      max_iters=max_iters, cfg=cfg)
        return x[0], info
    method = "pd2" if len(ws) == 2 else "pd"
    x, info = tv_nd_batched(X[None], ws, ds, ps, max_iters=max_iters,
                            method=method, cfg=cfg)
    return x[0], info
