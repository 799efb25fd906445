"""Batched 2D anisotropic-TV proximity combiners (port of
``proxtv_tpu.models.tv2d``: the TV-L1 methods with scalar, per-image or
per-edge weights, and TV-Lp for any p >= 1 by dr).

Solves, for every image in a batch,

    min_X 0.5 ||X - Y||_F^2 + w_col * colTV_p(X) + w_row * rowTV_p(X)

where colTV/rowTV are sums of 1D TV penalties over every column/row fiber.
Fibers are a batch axis: each row/column pass is ONE batched 1D prox call on
a (B*fibers, len) tensor.  Every splitting engine carries the warm-start
state of every fiber across outer iterations (the projected-Newton dual for
p = 1, the More-Sorensen alpha for p = 2, the TV-Lp dual and KKT multiplier
otherwise: the reference's Workspace warm restart, src/utils.h:30-33).

Engines (method strings of the reference Python layer,
prox_tv/__init__.py:355-443): ``pd`` (Proximal Dykstra, src/TV2Dopt.cpp:59),
``dr`` (Davis-Yin splitting in the role of DR2_TV, src/TV2Dopt.cpp:352),
``yang`` (consensus ADMM, src/TV2Dopt.cpp:787), ``condat`` /
``chambolle-pock`` / ``chambolle-pock-acc`` (primal-dual,
src/TV2Dopt.cpp:587) and ``kolmogorov`` (exact column prox + dualized rows,
src/TV2Dopt.cpp:907).

On the card the fiber passes run kernel B1 (p = 1), B4 (p = 2) or B5
(other p with q = p/(p-1) in [1.12, 3.1]; the rest run the TV-Lp torch
composition, as the JAX package does) and the primal-dual engines run the
chunked PDHG solve over kernel B3.  A fiber longer than 8192 runs the
composition the JAX package runs there (``tv1_pn`` for p = 1).  A float64
CUDA input takes the JAX package's float64 route: the p = 1 fibers by
``tv1_pn`` (its Newton systems on kernel B2 in float64), the p = 2 fibers
by the More-Sorensen composition (its shifted solves on B2 in float64),
the other p by the TV-Lp compositions (the setup solve on B2 in float64),
warm starts included, and the primal-dual methods by the unfused
iteration (:func:`_run_pdhg`, no kernel); the weighted primal-dual
methods raise there, as the JAX package's do off its fused path.  A CUDA
input the kernels cannot take otherwise (a dtype other than float32 or
float64, a side of 1) raises.  On the CPU the
plain compositions run.  The loops are Python loops: each combiner sweep
and each PDHG certificate reads one small value to the host.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import tv1d_l1, tv1d_l2, tv1d_lp
from ..ops.kernels import gating
from ..utils import debug
from ..utils.config import DEFAULT_COMBINER, CombinerConfig
from ..utils.info import RC_ITERS, RC_OK, make_info

def _np_dtype(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _scalar(v, dtype):
    """A host scalar rounded to the solve's dtype (the JAX package's 0-d
    array of Y.dtype), so scalar arithmetic rounds as it does there."""
    return _np_dtype(dtype)(v)


# ---------------------------------------------------------------------------
# Fiber passes: batched 1D prox along rows / columns of (B, M, N) stacks
# ---------------------------------------------------------------------------


def _is_scalar(lam):
    return np.ndim(lam) == 0 if not torch.is_tensor(lam) else lam.ndim == 0


def _lam_padded(lam, K, n, dtype, device):
    """Penalty as a (K, n) tensor with a zero final column (kernel layout)."""
    lam = torch.as_tensor(lam, dtype=dtype, device=device)
    if lam.ndim == 2:  # (K, n-1) per-edge weights
        body = lam
    else:
        body = torch.broadcast_to(lam.reshape(-1, 1) if lam.ndim else lam,
                                  (K, n - 1))
    return torch.cat([body, torch.zeros((K, 1), dtype=dtype, device=device)],
                     dim=-1)


def _prox1d(Y2, lam, p: float, method: str):
    """Batched 1D prox on (K, n) with penalty lam (scalar or (K, n-1)) and
    norm p (the JAX package tests p == 1 exactly, so p = 1.001 is TV-Lp)."""
    if p == 1.0:
        if method == "pn":
            if gating.gate(Y2, "pn"):
                from ..ops.kernels import pn_fused
                K, n = Y2.shape
                if _is_scalar(lam):
                    x, _ = pn_fused.pn_tv1_fused(Y2, lam_scalar=float(lam),
                                                 return_dual=False)
                    return x
                lam_full = _lam_padded(lam, K, n, Y2.dtype, Y2.device)
                x, _ = pn_fused.pn_tv1_fused(Y2, lam_full, return_dual=False)
                return x
            return tv1d_l1.tv1_pn(Y2, lam)[0]
        return tv1d_l1.tv1_batched(Y2, lam, method=method)
    if p == 2.0:
        return tv1d_l2.tv2_ms(Y2, lam)[0]
    return tv1d_lp.tvp_batched(Y2, lam, p, method="gpfw")[0]


def _prox_state_init(K, n, p: float, dtype, device):
    """Warm-start state per fiber: the projected-Newton dual (p = 1), the
    More-Sorensen secular multiplier (p = 2), or the TV-Lp (dual, KKT
    multiplier) pair — the reference's Workspace warm restart
    (src/utils.h:30-33, src/TVL2opt.cpp:255-257)."""
    if p == 1.0:
        return torch.zeros((K, n - 1), dtype=dtype, device=device)
    if p == 2.0:
        return torch.zeros((K,), dtype=dtype, device=device)
    return (torch.zeros((K, n - 1), dtype=dtype, device=device),
            torch.ones((K,), dtype=dtype, device=device))


def _prox1d_ws(Y2, lam, p: float, method: str, state, tol_eps=10.0):
    """Stateful variant: returns (x, state), warm-starting projected Newton
    from its dual, TV-L2 More-Sorensen from its alpha and TV-Lp GPFW from its
    dual and KKT multiplier; direct engines pass the state through.
    ``tol_eps``: kernel B1's float32 stop floor (``pn_tv1_fused``)."""
    if p == 1.0 and method == "pn":
        if gating.gate(Y2, "pn"):
            from ..ops.kernels import pn_fused
            K, n = Y2.shape
            w0p = torch.cat([state, state.new_zeros((K, 1))], dim=-1)
            if _is_scalar(lam):
                x, w = pn_fused.pn_tv1_fused(Y2, lam_scalar=float(lam),
                                             w_init=w0p, tol_eps=tol_eps)
                return x, w[:, :-1]
            lam_full = _lam_padded(lam, K, n, Y2.dtype, Y2.device)
            x, w = pn_fused.pn_tv1_fused(Y2, lam_full, w_init=w0p,
                                         tol_eps=tol_eps)
            return x, w[:, :-1]
        x, _, w = tv1d_l1.tv1_pn(Y2, lam, w_init=state, return_dual=True)
        return x, w
    if p == 2.0:
        x, _, alpha = tv1d_l2.tv2_ms(Y2, lam, alpha_init=state,
                                     return_alpha=True)
        return x, alpha
    if p != 1.0:
        w0, mu0 = state
        x, _, st = tv1d_lp.tvp_gpfw(Y2, lam, p, w_init=w0, mu_init=mu0,
                                    return_state=True)
        return x, st
    return _prox1d(Y2, lam, p, method), state


def prox_rows(X, lam, p: float = 1.0, method: str = "pn", w_edges=None):
    """1D prox along the last axis of (B, M, N): B*M independent rows.
    ``w_edges``: optional per-edge weights (B, M, N-1)."""
    B, M, N = X.shape
    lam2 = w_edges.reshape(B * M, N - 1) if w_edges is not None else lam
    return _prox1d(X.reshape(B * M, N), lam2, p, method).reshape(B, M, N)


def prox_cols(X, lam, p: float = 1.0, method: str = "pn", w_edges=None):
    """1D prox along the middle axis of (B, M, N): B*N column fibers.
    ``w_edges``: optional per-edge weights (B, M-1, N)."""
    B, M, N = X.shape
    Xt = X.transpose(1, 2).reshape(B * N, M)
    lam2 = (w_edges.transpose(1, 2).reshape(B * N, M - 1)
            if w_edges is not None else lam)
    out = _prox1d(Xt, lam2, p, method)
    return out.reshape(B, N, M).transpose(1, 2)


def _make_row_prox(B, M, N, lam, p, method, w_edges, dtype, device,
                   tol_eps=10.0):
    """Stateful row-pass closure: (V, state) -> (X, state)."""
    lam2 = w_edges.reshape(B * M, N - 1) if w_edges is not None else lam

    def prox(V, s):
        out, s2 = _prox1d_ws(V.reshape(B * M, N), lam2, p, method, s,
                             tol_eps)
        return out.reshape(B, M, N), s2

    return prox, _prox_state_init(B * M, N, p, dtype, device)


def _make_col_prox(B, M, N, lam, p, method, w_edges, dtype, device,
                   tol_eps=10.0):
    """Stateful column-pass closure: (V, state) -> (X, state)."""
    lam2 = (w_edges.transpose(1, 2).reshape(B * N, M - 1)
            if w_edges is not None else lam)

    def prox(V, s):
        Vt = V.transpose(1, 2).reshape(B * N, M)
        out, s2 = _prox1d_ws(Vt, lam2, p, method, s, tol_eps)
        return out.reshape(B, N, M).transpose(1, 2), s2

    return prox, _prox_state_init(B * N, M, p, dtype, device)


# ---------------------------------------------------------------------------
# Difference stencils along rows / cols (for the primal-dual engines)
# ---------------------------------------------------------------------------


def _drow(X):
    """(B, M, N) -> (B, M, N-1): x[..., i] - x[..., i+1]."""
    return X[..., :-1] - X[..., 1:]


def _drow_t(U):
    """Adjoint of _drow: (B, M, N-1) -> (B, M, N)."""
    z = torch.zeros_like(U[..., :1])
    return torch.cat([U, z], dim=-1) - torch.cat([z, U], dim=-1)


def _dcol(X):
    return X[:, :-1, :] - X[:, 1:, :]


def _dcol_t(U):
    z = torch.zeros_like(U[:, :1, :])
    return torch.cat([U, z], dim=1) - torch.cat([z, U], dim=1)


def _mean_abs_change(x, x_last):
    return torch.mean(torch.abs(x - x_last), dim=(1, 2))


# ---------------------------------------------------------------------------
# Engine loops: a loop with per-image mean-change stopping (reference
# STOP_PD 1e-6) and an iteration cap.
# ---------------------------------------------------------------------------


def _make_info(iters, delta, cap, tol):
    rc = torch.where((iters >= cap) & (delta > tol), RC_ITERS, RC_OK)
    return make_info(iters, delta, rc)


def _freeze_tree(new, old, running, B):
    """Per-image select between the post-sweep state ``new`` and the
    pre-sweep state ``old``: images with ``running[b] == False`` keep their
    old state.  Every non-scalar leaf is image-major with a leading dim that
    is a multiple of B; 0-d leaves (shared schedule scalars) pass through."""
    if isinstance(new, (tuple, list)):
        return type(new)(_freeze_tree(n, o, running, B)
                         for n, o in zip(new, old))
    if new.ndim == 0:
        return new
    if new.shape[0] % B != 0:
        raise ValueError(
            f"combiner state leaf of shape {tuple(new.shape)} violates the "
            f"image-major contract (leading dim must be a multiple of B={B}, "
            f"or the leaf must be a 0-d shared scalar)")
    m = torch.repeat_interleave(running, new.shape[0] // B)
    return torch.where(m.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)


def _loop(body, init_state, x_of, cap, tol, mean_change=_mean_abs_change):
    """Generic combiner loop: runs until mean |x - x_last| < tol for every
    image or ``cap`` sweeps.  Converged images are frozen (their whole state,
    fiber warm-start duals included, stops updating), so their inner solves
    converge at once; ``iters`` counts each image's own sweeps.
    ``mean_change`` computes the per-image statistic (the column-split
    solve of ``parallel.sharded`` all-reduces it)."""
    x_last = x_of(init_state)
    B = x_last.shape[0]
    dev = x_last.device
    state = init_state
    delta = torch.full((B,), float("inf"), dtype=x_last.dtype, device=dev)
    iters_img = torch.zeros((B,), dtype=torch.int32, device=dev)
    running = torch.ones((B,), dtype=torch.bool, device=dev)
    iters = 0
    while iters < cap and debug.host(torch.any(running)):
        state = _freeze_tree(body(state), state, running, B)
        x = x_of(state)
        delta = torch.where(running, mean_change(x, x_last), delta)
        iters_img = iters_img + running.to(torch.int32)
        running = running & (delta > tol)
        iters += 1
        debug.dprint("combiner iter {i}: max mean-change {d}", i=iters,
                     d=torch.amax(delta))
        x_last = x
    return x_of(state), _make_info(iters_img, delta, cap, tol)


# -- Proximal Dykstra (reference PD2_TV) ------------------------------------


def _run_pd(Y, prox1, s1_0, prox2, s2_0, cap, tol,
            mean_change=_mean_abs_change):
    def body(state):
        x, p, q, s1, s2 = state
        xp, s1 = prox1(x + p, s1)
        p = x + p - xp
        x, s2 = prox2(xp + q, s2)
        q = xp + q - x
        return x, p, q, s1, s2

    z = torch.zeros_like(Y)
    return _loop(body, (Y, z, z, s1_0, s2_0), lambda s: s[0], cap, tol,
                 mean_change)


# -- Davis-Yin three-operator splitting (reference DR2_TV role) -------------


def _run_dr(Y, prox1, s1_0, prox2, s2_0, cap, tol, gamma=1.0,
            mean_change=_mean_abs_change):
    """Fixed point: x* = prox of (f1 + f2 + 0.5||.-Y||^2); the smooth term
    enters by its gradient (x - Y), the proxes of f1/f2 scaled by gamma."""

    def body(state):
        z, _, s1, s2 = state
        xb, s1 = prox1(z, s1)
        zh = 2.0 * xb - z - gamma * (xb - Y)
        xa, s2 = prox2(zh, s2)
        z = z + xa - xb
        return z, xb, s1, s2

    return _loop(body, (Y, Y, s1_0, s2_0), lambda s: s[1], cap, tol,
                 mean_change)


# -- Consensus ADMM (reference Yang2_TV) ------------------------------------


def _run_yang(Y, prox1, s1_0, prox2, s2_0, cap, tol, rho,
              mean_change=_mean_abs_change):
    def body(state):
        x, z1, z2, u1, u2, s1, s2 = state
        # Rotated ADMM sweep (z, u first) so the first iterate moves.
        z1, s1 = prox1(x + u1, s1)
        z2, s2 = prox2(x + u2, s2)
        u1 = u1 + x - z1
        u2 = u2 + x - z2
        x = (Y + rho * (z1 - u1) + rho * (z2 - u2)) / (1.0 + 2.0 * rho)
        return x, z1, z2, u1, u2, s1, s2

    zero = torch.zeros_like(Y)
    return _loop(body, (Y, Y, Y, zero, zero, s1_0, s2_0), lambda s: s[0],
                 cap, tol, mean_change)


# -- Primal-dual (reference CondatChambollePock2_TV) ------------------------


def _pdhg_sigma_schedule(Y, lam_eff, dtype, dY=None, mean=torch.mean):
    """(sigma0, cap_mult) of the accelerated schedule, scale-invariant in
    (Y, lam): lam relative to the data's noise scale (white noise of std s
    has mean(dY^2) = 2 s^2); the best terminal sigma follows
    (lam_rel/0.3)^1.5 (the JAX package's 1024^2 sweep).  0-d tensors.
    ``dY``: Y's differences along its last axis, if the caller has them
    (either sign); ``mean``: their mean over the whole image (the
    column-split solve all-reduces it)."""
    if dY is None:
        dY = Y[..., 1:] - Y[..., :-1]
    noise = torch.sqrt(torch.clamp(mean(dY * dY) * 0.5, min=1e-12))
    lam_rel = torch.as_tensor(lam_eff, dtype=dtype, device=Y.device) / noise
    sigma0 = 0.5 * torch.clamp(lam_rel, min=1.0)
    sigma_max = torch.clamp((lam_rel / 0.3) ** 1.5, min=1.0)
    return sigma0, sigma_max / sigma0


def _run_pdhg(Y, w_row, w_col, cap, tol, cfg, variant: str, drow=_drow,
              drow_t=_drow_t, edge_mean=torch.mean,
              mean_change=_mean_abs_change, row_edges=None):
    """Unfused primal-dual: one iteration per sweep (the composition that
    runs on the CPU, and the column-split solve's on every device, as the
    JAX package runs it under sharding).  Reference constants sigma = 10,
    tau = 0.9/(8 sigma) (src/TV2Dopt.cpp:609-618).

    ``drow``/``drow_t``: the row differences and their adjoint; ``edge_mean``
    the mean of a row-edge field over the image; ``mean_change`` as
    :func:`_loop` takes it; ``row_edges``: the row edges ``drow`` gives
    (N - 1 by default).  ``parallel.sharded`` passes versions that reach
    across the ranks' column blocks."""
    dt = Y.dtype
    B, M, N = Y.shape
    if variant == "cp-acc":
        sigma0, cap_mult = _pdhg_sigma_schedule(
            Y, torch.mean(torch.as_tensor(w_row, dtype=dt)), dt, drow(Y),
            edge_mean)
    else:
        sigma0 = torch.tensor(cfg.cp_sigma, dtype=dt, device=Y.device)
        cap_mult = 2.0
    tau0 = 0.9 / (8.0 * sigma0)
    w_row = float(w_row)
    w_col = float(w_col)

    def body(state):
        x, xbar, u1, u2, tau, sigma = state
        u1 = torch.clamp(u1 + sigma * drow(xbar), -w_row, w_row)
        u2 = torch.clamp(u2 + sigma * _dcol(xbar), -w_col, w_col)
        div = drow_t(u1) + _dcol_t(u2)
        if variant == "condat":
            x_new = x - tau * ((x - Y) + div)
        else:  # cp / cp-acc: resolvent of 0.5||.-Y||^2
            x_new = (x - tau * div + tau * Y) / (1.0 + tau)
        if variant == "cp-acc":
            # Chambolle-Pock Alg. 2 (gamma = 1) with sigma capped.
            theta = torch.where(sigma < cap_mult * sigma0,
                                1.0 / torch.sqrt(1.0 + 2.0 * tau),
                                torch.ones_like(tau))
            tau_n = tau * theta
            sigma_n = sigma / theta
        else:
            theta = torch.ones_like(tau)
            tau_n, sigma_n = tau, sigma
        xbar = x_new + theta * (x_new - x)
        return x_new, xbar, u1, u2, tau_n, sigma_n

    z1 = Y.new_zeros((B, M, N - 1 if row_edges is None else row_edges))
    z2 = Y.new_zeros((B, M - 1, N))
    init = (Y, Y, z1, z2, tau0, sigma0)
    return _loop(body, init, lambda s: s[0], cap, tol, mean_change)


# -- Temporally-blocked fused PDHG (kernel B3) ------------------------------


def _run_pdhg_fused(Y, lam, cap, tol, cfg, variant: str,
                    W_col=None, W_row=None, x0=None, gap_tol=None,
                    sigma0=None, sigma_cap_mult=None, obj_target=None,
                    u0=None, return_duals: bool = False,
                    k_steps: int = None, tm: int = None):
    """Chunked PDHG solve over the chunk kernel: stacks the image batch vertically
    with decoupled (lam = 0) gap rows and runs K-iteration chunks.

    Stopping is a per-image duality-gap certificate between chunks: from the
    duals (u1, u2), xhat = Y - D'u is dual-feasible and
    gap(xhat, u) = sum lam|D xhat| - u . D xhat >= 0 bounds the objective
    suboptimality of xhat, which is the returned iterate.  Each image stops
    when its gap falls below ``cfg.pdhg_gap_tol`` relative to its objective
    (or ``gap_tol``; 0 runs to ``cap``), or its objective reaches
    ``obj_target``.  With one image the kernel reduces the certificate
    itself every chunk; a batch is certified every ~24 iterations.  cp-acc
    restarts its (sigma, tau) ramp when the gap stalls (gap > 0.7x the gap
    3 checks earlier), raising the sigma cap 4x.

    ``W_col`` (B, M-1, N) / ``W_row`` (B, M, N-1): per-edge weight fields.
    ``x0``: primal warm start.  ``u0``: (u_row, u_col) dual warm start,
    box-clipped on entry; ``return_duals`` appends the final dual pair.
    ``k_steps``/``tm``: chunk length and canvas tile height (default
    :func:`gating.pdhg2d_params`; pinning them to the JAX package's values
    reproduces its certificate cadence).  The JAX solver's image
    transposition (a TPU lane-width decision) is dropped: the CUDA kernel
    tiles in 2D, so both orientations cost the same.

    One host read per certificate: the gap (and objective) decide the stop
    and the restart on the host; the schedule is computed on the host in
    float32 and uploaded each chunk.
    """
    from ..ops.kernels import pdhg_fused as PK

    B, M, N = Y.shape
    dt, dev = Y.dtype, Y.device
    npd = _np_dtype(dt)
    weighted = W_row is not None
    k_auto, tm_auto = gating.pdhg2d_params()
    k_steps = k_steps or k_auto
    tm = tm or tm_auto
    halo = 2 * k_steps
    gap_rows = 8
    S = M + gap_rows
    Np = -(-N // 128) * 128
    tiles = max(1, -(-(B * S) // tm))
    Mp = tiles * tm + 2 * halo

    if sigma0 is None:
        if variant == "cp-acc":
            lam_eff = (torch.mean(torch.as_tensor(W_row, dtype=dt, device=dev))
                       if weighted else torch.as_tensor(lam, dtype=dt))
            s0_t, cap_t = _pdhg_sigma_schedule(Y, lam_eff, dt)
            s0_h, cap_h = debug.host(torch.stack([s0_t, cap_t]))
            sigma0 = npd(s0_h)
            if sigma_cap_mult is None:
                sigma_cap_mult = npd(cap_h)
        else:
            sigma0 = npd(cfg.cp_sigma)
    if sigma_cap_mult is None:
        sigma_cap_mult = 2.0
    sigma0 = npd(sigma0)
    tau0 = npd(0.9) / (npd(8.0) * sigma0)

    def canvas(A):
        """(B, rows<=M, cols<=N) field -> tall padded (Mp, Np) canvas."""
        _, rows, cols = A.shape
        A = F.pad(A, (0, Np - cols, 0, S - rows))
        return F.pad(A.reshape(B * S, Np), (0, 0, halo, Mp - halo - B * S))

    Ypad = canvas(Y).contiguous()
    r = torch.arange(Mp, device=dev)[:, None] - halo
    q = r % S
    col = torch.arange(Np, device=dev)[None, :]
    in_img = (r >= 0) & (r < B * S)
    vr = ((col < N - 1) & in_img & (q <= M - 1)).to(dt)
    vc = ((col < N) & in_img & (q <= M - 2)).to(dt)
    if weighted:
        lamr = canvas(torch.as_tensor(W_row, dtype=dt, device=dev)) * vr
        lamc = canvas(torch.as_tensor(W_col, dtype=dt, device=dev)) * vc
        wr, wc = lamr.contiguous(), lamc.contiguous()
        lam_f = np.float32(1.0)  # schedule lam column unused
    else:
        lam_s = float(npd(lam))
        lamr = lam_s * vr
        lamc = lam_s * vc
        wr = wc = None
        lam_f = np.float32(lam)

    use_kcert = B == 1
    cpc = 1 if use_kcert else max(1, 24 // k_steps)
    cap_pad = -(-cap // (cpc * k_steps)) * (cpc * k_steps)
    sig0f = np.float32(sigma0)
    tau0f = np.float32(tau0)

    def dr_(X):
        return X - torch.cat([X[:, 1:], torch.zeros_like(X[:, :1])], dim=1)

    def drT_(U):
        return U - torch.cat([torch.zeros_like(U[:, :1]), U[:, :-1]], dim=1)

    def dc_(X):
        return X - torch.cat([X[1:, :], torch.zeros_like(X[:1, :])], dim=0)

    def dcT_(U):
        return U - torch.cat([torch.zeros_like(U[:1, :]), U[:-1, :]], dim=0)

    def per_image(E):
        """Sum an (Mp, Np) field per stacked image -> (B,)."""
        return torch.sum(E[halo:halo + B * S].reshape(B, S, Np), dim=(1, 2))

    def gap_and_primal(u1, u2):
        """Duality-gap certificate per image; where(), not *mask, so
        garbage in padding cannot leak in (0 * NaN = NaN)."""
        zero = torch.zeros((), dtype=dt, device=dev)
        u1 = torch.where(vr > 0, u1, zero)
        u2 = torch.where(vc > 0, u2, zero)
        xhat = Ypad - (drT_(u1) + dcT_(u2))
        gr = dr_(xhat) * vr
        gc = dc_(xhat) * vc
        e = lamr * torch.abs(gr) - u1 * gr + lamc * torch.abs(gc) - u2 * gc
        gap_b = per_image(e)
        obj_b = (0.5 * per_image((xhat - Ypad) ** 2)
                 + per_image(lamr * torch.abs(gr) + lamc * torch.abs(gc)))
        return gap_b, obj_b, xhat

    feps = npd(np.finfo(npd).eps)
    gtol = (max(npd(cfg.pdhg_gap_tol), npd(64.0) * feps) if gap_tol is None
            else npd(gap_tol))
    obj_tgt = (np.full((B,), -np.inf, npd) if obj_target is None
               else np.broadcast_to(np.asarray(obj_target, npd), (B,)))

    def still_running(gap_b, obj_b):
        return (gap_b > gtol * np.maximum(npd(1.0), obj_b)) & (obj_b > obj_tgt)

    def chunk_call(sd, x, xb, u1, u2, cert):
        sd_t = torch.from_numpy(sd).to(dev)
        return PK.pdhg_chunk(sd_t, x, xb, u1, u2, Ypad, k_steps=k_steps,
                             tm=tm, n_valid=N, m_valid=M, stride=S, count=B,
                             pad_top=halo, grad_step=(variant == "condat"),
                             wr=wr, wc=wc, cert=cert)

    # Gap-stall restarted acceleration (the JAX solver's controller,
    # tv2d.py:640-716): when the gap fails to decay 0.7x over the last LOOK
    # checks, rewind (sigma, tau) to (sigma0, tau0) and raise the cap 4x.
    # The window keeps sliding through restarts, as there.
    restart = variant == "cp-acc"
    LOOK, DECAY, GROW = 3, np.float32(0.7), np.float32(4.0)

    zeros = torch.zeros_like(Ypad)
    x = canvas(x0).contiguous() if x0 is not None else Ypad
    if u0 is not None:
        u1 = torch.clamp(canvas(torch.as_tensor(u0[0], dtype=dt, device=dev)),
                         -lamr, lamr).contiguous()
        u2 = torch.clamp(canvas(torch.as_tensor(u0[1], dtype=dt, device=dev)),
                         -lamc, lamc).contiguous()
        if x0 is None:
            # Consistent primal for a dual start: xhat = Y - D'u.
            x = (Ypad - (drT_(u1) + dcT_(u2))).contiguous()
    else:
        u1 = u2 = zeros
    xb = x
    sc = (sig0f, tau0f)
    cap_mult_d = np.float32(sigma_cap_mult)
    hist = [np.float32(np.inf)] * LOOK
    t = 0
    gap_b = np.full((B,), np.inf, npd)
    iters_img = np.zeros((B,), np.int32)
    running = np.ones((B,), bool)
    while t < cap_pad and running.any():
        if use_kcert:
            sd, sc = PK.sched_chunk(sc, k_steps, lam_f, sig0f, cap_mult_d,
                                    variant)
            x, xb, u1, u2, gp, op = chunk_call(sd, x, xb, u1, u2, True)
            t += k_steps
            g_h, o_h = debug.host(torch.stack([gp.sum(), op.sum()]))
            gap_new = np.full((1,), g_h, npd)
            obj_b = np.full((1,), o_h, npd)
            gsum = np.float32(gap_new[0])
        else:
            for _ in range(cpc):
                sd, sc = PK.sched_chunk(sc, k_steps, lam_f, sig0f, cap_mult_d,
                                        variant)
                x, xb, u1, u2 = chunk_call(sd, x, xb, u1, u2, False)
                t += k_steps
            g_t, o_t, _ = gap_and_primal(u1, u2)
            g_h, o_h = debug.host(torch.stack([g_t, o_t]))
            gap_new = np.asarray(g_h, npd)
            obj_b = np.asarray(o_h, npd)
            # One global (sigma, tau) for the canvas: the stall statistic is
            # the gap summed over still-running images.
            gsum = np.float32(np.sum(np.where(running, gap_new, npd(0.0))))
        if restart:
            if gsum > DECAY * hist[0]:
                sc = (sig0f, tau0f)
                with np.errstate(over="ignore"):  # float32 inf, as in JAX
                    cap_mult_d = np.float32(cap_mult_d * GROW)
            hist = hist[1:] + [gsum]
        iters_img = iters_img + np.int32(cpc * k_steps) * running
        gap_b = np.where(running, gap_new, gap_b)
        running = running & still_running(gap_b, obj_b)

    gap_t, obj_t, xhat = gap_and_primal(u1, u2)
    out = xhat[halo:halo + B * S].reshape(B, S, Np)[:, :M, :N]
    rc = torch.where((gap_t > float(gtol) * torch.clamp(obj_t, min=1.0))
                     & (obj_t > torch.from_numpy(obj_tgt.copy()).to(dev)),
                     RC_ITERS, RC_OK)
    info = make_info(torch.from_numpy(iters_img).to(dev), gap_t, rc)
    if return_duals:
        u1_img = u1[halo:halo + B * S].reshape(B, S, Np)[:, :M, :N - 1]
        u2_img = u2[halo:halo + B * S].reshape(B, S, Np)[:, :M - 1, :N]
        return out, info, (u1_img, u2_img)
    return out, info


def _run_pdhg_fused_banded(Yl, lam, Wr=None, Wc=None, *, cap, cfg,
                           variant: str, mesh, M: int, N: int, k_steps: int,
                           tm: int, gap_tol=None):
    """Chunked PDHG solve of ONE image row-banded over a mesh (port of the
    JAX package's ``_run_pdhg_fused_banded``, ``tv2d.py:751``).

    Runs on every rank of ``mesh``: ``Yl`` is this rank's
    (local_rows, Np) slab of the row-padded image (image rows [0, M) valid,
    the padding after row M).  The rank keeps a canvas of its band and a
    2K-row halo on each side; before every K-step chunk of kernel B3 the
    four fields' halos are refreshed from the neighbours' core rows
    (``comm.halo_exchange``), which keeps the core rows exact for K steps,
    as B3's own windows do on one card.  Edge ranks receive zeros, which
    the kernel's masks pin (``pad_top = 2K - rank * local_rows``, negative
    past the first band).  The certificate is summed over this rank's core
    rows in PyTorch ops and all-reduced, so every rank reads the same gap
    and takes the same stop and restart branch (one host sync each).

    ``Wr``/``Wc``: (local_rows, Np) slabs of the per-edge weight canvases,
    exchanged once.  Returns this rank's (local_rows, Np) rows of the
    solution and the image's (1,)-shaped ``SolverInfo``.
    """
    from ..ops.kernels import pdhg_fused as PK
    from ..parallel import comm

    weighted = Wr is not None
    local_rows, Np = Yl.shape
    halo = 2 * k_steps
    dt, dev = Yl.dtype, Yl.device
    npd = _np_dtype(dt)
    d = mesh.rank
    roff = halo - d * local_rows
    rows = 2 * halo + local_rows

    def canvas(A):
        """(local_rows, Np) slab -> canvas with the neighbours' halo rows."""
        C = F.pad(A, (0, 0, halo, halo)).contiguous()
        return comm.halo_exchange(mesh, [C], halo, local_rows)[0]

    # The data canvas needs the neighbours' rows in its halo: the kernel's
    # in-chunk primal updates at halo rows read Y there, and zeros would
    # shift the boundary rows' fixed point.
    Ypad = canvas(Yl)
    r = torch.arange(rows, device=dev)[:, None] - halo + d * local_rows
    col = torch.arange(Np, device=dev)[None, :]
    in_img = (r >= 0) & (r < M)
    vr = ((col < N - 1) & in_img).to(dt)
    vc = ((col < N) & in_img & (r < M - 1)).to(dt)
    core = ((r >= d * local_rows) & (r < (d + 1) * local_rows)).to(dt)
    if weighted:
        Wrpad, Wcpad = canvas(Wr), canvas(Wc)
        lamr, lamc = Wrpad * vr, Wcpad * vc
        lam_f = np.float32(1.0)  # schedule lam column unused
    else:
        Wrpad = Wcpad = None
        lam_s = float(npd(lam))
        lamr, lamc = lam_s * vr, lam_s * vc
        lam_f = np.float32(lam)

    if variant == "cp-acc":
        # The schedule from global statistics, all-reduced so that every
        # rank runs the same one.
        dY = Yl[:, 1:N] - Yl[:, :N - 1]
        gr = torch.arange(local_rows, device=dev) + d * local_rows
        vrow = (gr < M).to(dt)[:, None]
        parts = [torch.sum(dY * dY * vrow),
                 torch.sum(torch.broadcast_to(vrow, dY.shape))]
        if weighted:
            parts.append(torch.sum(Wr[:, :N - 1] * vrow))
        sums = [npd(v) for v in comm.reduce_host(mesh, torch.stack(parts))]
        ssum, cnt = sums[0], sums[1]
        noise = np.sqrt(max(ssum / max(cnt, npd(1.0)) * npd(0.5),
                            npd(1e-12)))
        lam_eff = sums[2] / max(cnt, npd(1.0)) if weighted else npd(lam)
        lam_rel = npd(lam_eff / noise)
        sigma0 = npd(0.5) * max(npd(1.0), lam_rel)
        cap_mult = npd(max(npd(1.0), (lam_rel / npd(0.3)) ** npd(1.5))
                       / sigma0)
    else:
        sigma0, cap_mult = npd(cfg.cp_sigma), 2.0
    tau0 = npd(0.9) / (npd(8.0) * sigma0)

    def dr_(X):
        return X - torch.cat([X[:, 1:], torch.zeros_like(X[:, :1])], dim=1)

    def drT_(U):
        return U - torch.cat([torch.zeros_like(U[:, :1]), U[:, :-1]], dim=1)

    def dc_(X):
        return X - torch.cat([X[1:, :], torch.zeros_like(X[:1, :])], dim=0)

    def dcT_(U):
        return U - torch.cat([torch.zeros_like(U[:1, :]), U[:-1, :]], dim=0)

    def gap_and_primal(u1, u2):
        """The image's gap and objective, summed over this rank's core rows
        with fresh halos and all-reduced (one host sync)."""
        zero = torch.zeros((), dtype=dt, device=dev)
        u1 = torch.where(vr > 0, u1, zero)
        u2 = torch.where(vc > 0, u2, zero)
        xhat = Ypad - (drT_(u1) + dcT_(u2))
        g_r = dr_(xhat) * vr
        g_c = dc_(xhat) * vc
        e = lamr * torch.abs(g_r) - u1 * g_r + lamc * torch.abs(g_c) - u2 * g_c
        obj = (0.5 * (xhat - Ypad) ** 2 * in_img
               + lamr * torch.abs(g_r) + lamc * torch.abs(g_c))
        gap, ob = comm.reduce_host(mesh, torch.stack(
            [torch.sum(e * core), torch.sum(obj * core)]))
        return npd(gap), npd(ob), xhat

    feps = npd(np.finfo(npd).eps)
    gtol = (max(npd(cfg.pdhg_gap_tol), npd(64.0) * feps) if gap_tol is None
            else npd(gap_tol))

    cpc = max(1, 24 // k_steps)
    cap_pad = -(-cap // (cpc * k_steps)) * (cpc * k_steps)
    sig0f, tau0f = np.float32(sigma0), np.float32(tau0)
    # The gap-stall restart of the single-card driver, at the certificate
    # cadence: the stall window spans LOOK checks.
    restart = variant == "cp-acc"
    LOOK, DECAY, GROW = 3, np.float32(0.7), np.float32(4.0)

    x, xb = Ypad.clone(), Ypad.clone()
    u1, u2 = torch.zeros_like(Ypad), torch.zeros_like(Ypad)
    sc = (sig0f, tau0f)
    cap_mult_d = np.float32(cap_mult)
    hist = [np.float32(np.inf)] * LOOK
    t, iters, gap_b, running = 0, 0, npd(np.inf), True
    while t < cap_pad and running:
        for _ in range(cpc):
            comm.halo_exchange(mesh, [x, xb, u1, u2], halo, local_rows)
            sd, sc = PK.sched_chunk(sc, k_steps, lam_f, sig0f, cap_mult_d,
                                    variant)
            x, xb, u1, u2 = PK.pdhg_chunk(
                torch.from_numpy(sd).to(dev), x, xb, u1, u2, Ypad,
                k_steps=k_steps, tm=tm, n_valid=N, m_valid=M, stride=M,
                count=1, pad_top=roff, grad_step=(variant == "condat"),
                wr=Wrpad, wc=Wcpad)
            t += k_steps
        iters += cpc * k_steps
        comm.halo_exchange(mesh, [u1, u2], halo, local_rows)
        gap_new, obj, _ = gap_and_primal(u1, u2)
        if restart:
            if np.float32(gap_new) > DECAY * hist[0]:
                sc = (sig0f, tau0f)
                with np.errstate(over="ignore"):  # float32 inf, as in JAX
                    cap_mult_d = np.float32(cap_mult_d * GROW)
            hist = hist[1:] + [np.float32(gap_new)]
        gap_b = gap_new
        running = bool(gap_b > gtol * max(npd(1.0), obj))
        debug.dprint("banded PDHG iter {t}: gap {g}", t=t, g=float(gap_b))

    comm.halo_exchange(mesh, [u1, u2], halo, local_rows)
    gap_b, obj, xhat = gap_and_primal(u1, u2)
    rc = RC_ITERS if gap_b > gtol * max(npd(1.0), obj) else RC_OK
    info = make_info(torch.tensor([iters], device=dev),
                     torch.tensor([gap_b], dtype=dt, device=dev),
                     torch.tensor([rc], device=dev))
    return xhat[halo:halo + local_rows], info


# -- Column-exact primal-dual (reference Kolmogorov2_TV) --------------------


def _run_kolmogorov(Y, w_row, w_col, cap, tol, inner_method: str,
                    tol_eps=10.0, drow=_drow, drow_t=_drow_t,
                    mean_change=_mean_abs_change, row_edges=None):
    """PDHG with G(x) = 0.5||x-Y||^2 + w_col*colTV (proximable exactly via
    the batched 1D solver + Moreau scaling) and the row term dualized.

    ``w_row``: a scalar or a (B, M, N-1) per-edge field (it enters only the
    dual clip); ``w_col``: a scalar or a (B, M-1, N) per-edge field
    (reshaped to per-column-fiber weights for the exact 1D prox).
    ``drow``/``drow_t``/``mean_change``/``row_edges``: as
    :func:`_run_pdhg` takes them;
    the column prox acts on whole columns, so a column-split solve runs it
    on its own block."""
    B, M, N = Y.shape
    sigma0, tau0 = 1.0, 0.9 / (4.0 * 1.0)  # ||D_row||^2 <= 4
    s0 = _prox_state_init(B * N, M, 1.0, Y.dtype, Y.device)
    wc = (w_col.transpose(1, 2).reshape(B * N, M - 1)
          if torch.is_tensor(w_col) and w_col.ndim == 3 else w_col)
    wr = w_row if torch.is_tensor(w_row) else float(w_row)

    def prox_G(v, tau, s):
        # prox_{tau G}(v) = prox_{(tau w_col/(1+tau)) colTV}((v + tau Y)/(1+tau))
        t = (v + tau * Y) / (1.0 + tau)
        Vt = t.transpose(1, 2).reshape(B * N, M)
        out, s = _prox1d_ws(Vt, tau * wc / (1.0 + tau), 1.0,
                            inner_method, s, tol_eps)
        return out.reshape(B, N, M).transpose(1, 2), s

    def body(state):
        x, xbar, u, s = state
        u = torch.clamp(u + sigma0 * drow(xbar), -wr, wr)
        x_new, s = prox_G(x - tau0 * drow_t(u), tau0, s)
        # Fixed steps, theta = 1.
        xbar = 2.0 * x_new - x
        return x_new, xbar, u, s

    z = Y.new_zeros((B, M, N - 1 if row_edges is None else row_edges))
    return _loop(body, (Y, Y, z, s0), lambda s: s[0], cap, tol, mean_change)


# ---------------------------------------------------------------------------
# Public batched entry point
# ---------------------------------------------------------------------------


def _dispatch(Y, cfgs, method, max_iters, cfg):
    """Shared splitting-method dispatch over stateful prox factories."""
    (pcol, s1_0), (prow, s2_0) = cfgs
    tol = cfg.stop
    if method == "pd":
        return _run_pd(Y, pcol, s1_0, prow, s2_0,
                       max_iters or cfg.max_iters_pd, tol)
    if method == "dr":
        return _run_dr(Y, pcol, s1_0, prow, s2_0,
                       max_iters or cfg.max_iters_dr, tol)
    raise ValueError(f"Unknown 2D method: {method!r}")


_PDHG_VARIANTS = {"condat": "condat", "chambolle-pock": "cp",
                  "chambolle-pock-acc": "cp-acc"}


_PER_IMAGE_METHODS = ("pd", "dr", "yang", "condat", "chambolle-pock",
                      "chambolle-pock-acc")


def tv1_2d_batched(Y, lam, method: str = "dr", max_iters: int = 0,
                   inner_method: str = "pn",
                   cfg: CombinerConfig = DEFAULT_COMBINER,
                   tol_eps: float = 10.0):
    """Batched 2D anisotropic TV-L1 prox on a (B, M, N) image tensor, on
    whatever device ``Y`` lies.

    Methods: dr (default), pd, yang, condat, chambolle-pock,
    chambolle-pock-acc, kolmogorov (reference prox_tv/__init__.py:355-443).
    ``lam`` is a scalar, or a (B,) per-image penalty, which runs the
    weighted solver :func:`tv1w_2d_batched` on uniform weight fields (pd,
    dr, yang and the primal-dual methods; the latter only on the card, as
    the JAX package's only on its accelerator).  The device decides the
    path: CUDA runs the kernels, the CPU the plain compositions.
    ``tol_eps`` is kernel B1's float32 stop floor in the fiber passes (10,
    the TPU kernel's, by default; ``diffprox.tv2d_prox`` passes 0).

    Returns (X, SolverInfo) with per-image iters / gap / rc.
    """
    B, M, N = Y.shape
    method = method.lower()
    lam_nd = lam.ndim if torch.is_tensor(lam) else np.ndim(lam)
    if lam_nd == 1:
        if method not in _PER_IMAGE_METHODS:
            raise ValueError(
                f"method {method!r} does not support per-image penalties; "
                "use a scalar lam or one of pd/dr/yang/condat/chambolle-pock/"
                "chambolle-pock-acc")
        lam_t = torch.as_tensor(lam, dtype=Y.dtype, device=Y.device)
        Wc = torch.broadcast_to(lam_t[:, None, None], (B, M - 1, N))
        Wr = torch.broadcast_to(lam_t[:, None, None], (B, M, N - 1))
        return tv1w_2d_batched(Y, Wc, Wr, max_iters=max_iters, method=method,
                               inner_method=inner_method, cfg=cfg,
                               tol_eps=tol_eps)
    if torch.is_tensor(lam):
        lam = debug.host(lam)
    lam = _scalar(lam, Y.dtype)
    tol = cfg.stop
    dev = Y.device

    if method in ("pd", "dr"):
        cfgs = (_make_col_prox(B, M, N, lam, 1.0, inner_method, None, Y.dtype,
                               dev, tol_eps),
                _make_row_prox(B, M, N, lam, 1.0, inner_method, None, Y.dtype,
                               dev, tol_eps))
        return _dispatch(Y, cfgs, method, max_iters, cfg)
    if method == "yang":
        rho = cfg.yang_rho
        lr = lam / _scalar(rho, Y.dtype)
        pcol, s1 = _make_col_prox(B, M, N, lr, 1.0, inner_method, None,
                                  Y.dtype, dev, tol_eps)
        prow, s2 = _make_row_prox(B, M, N, lr, 1.0, inner_method, None,
                                  Y.dtype, dev, tol_eps)
        return _run_yang(Y, pcol, s1, prow, s2,
                         max_iters or cfg.max_iters_yang, tol, rho)
    if method in _PDHG_VARIANTS:
        cap = max_iters or cfg.max_iters_condat
        variant = _PDHG_VARIANTS[method]
        if gating.gate(Y, "pdhg2d"):
            return _run_pdhg_fused(Y, lam, cap, tol, cfg, variant)
        return _run_pdhg(Y, lam, lam, cap, tol, cfg, variant)
    if method == "kolmogorov":
        cap = max_iters or cfg.max_iters_kolmogorov
        return _run_kolmogorov(Y, lam, lam, cap, tol, inner_method, tol_eps)
    raise ValueError(f"Unknown 2D method: {method!r}")


def tv1w_2d_batched(Y, W_col, W_row, max_iters: int = 0, method: str = "dr",
                    inner_method: str = "pn",
                    cfg: CombinerConfig = DEFAULT_COMBINER,
                    tol_eps: float = 10.0):
    """Batched weighted 2D TV-L1 prox (reference DR2L1W_TV,
    src/TV2DWopt.cpp:46), on whatever device ``Y`` lies.

    Args:
        Y: (B, M, N) images.
        W_col: (B, M-1, N) per-edge weights along columns.
        W_row: (B, M, N-1) per-edge weights along rows.
        method: dr (default), pd, yang, kolmogorov (weighted fiber passes:
            kernel B1 with per-edge weights on the card), or condat /
            chambolle-pock / chambolle-pock-acc (kernel B3's weighted route;
            the card only: elsewhere they raise, as the JAX package's raise
            off its accelerator).
        tol_eps: kernel B1's float32 stop floor in the fiber passes.
    """
    B, M, N = Y.shape
    method = method.lower()
    W_col = torch.as_tensor(W_col, dtype=Y.dtype, device=Y.device)
    W_row = torch.as_tensor(W_row, dtype=Y.dtype, device=Y.device)
    if method in _PDHG_VARIANTS:
        if gating.gate(Y, "pdhg2d"):
            cap = max_iters or cfg.max_iters_condat
            return _run_pdhg_fused(Y, 0.0, cap, cfg.stop, cfg,
                                   _PDHG_VARIANTS[method], W_col=W_col,
                                   W_row=W_row)
        raise ValueError("weighted primal-dual requires the fused kernel on "
                         "the card; use method='dr' or 'pd'")
    if method == "yang":
        rho = _scalar(cfg.yang_rho, Y.dtype)
        pcol, s1 = _make_col_prox(B, M, N, None, 1.0, inner_method,
                                  W_col / rho, Y.dtype, Y.device, tol_eps)
        prow, s2 = _make_row_prox(B, M, N, None, 1.0, inner_method,
                                  W_row / rho, Y.dtype, Y.device, tol_eps)
        return _run_yang(Y, pcol, s1, prow, s2,
                         max_iters or cfg.max_iters_yang, cfg.stop,
                         cfg.yang_rho)
    if method == "kolmogorov":
        return _run_kolmogorov(Y, W_row, W_col,
                               max_iters or cfg.max_iters_kolmogorov,
                               cfg.stop, inner_method, tol_eps)
    if method not in ("pd", "dr"):
        raise ValueError(f"Unknown weighted 2D method: {method!r}")
    cfgs = (_make_col_prox(B, M, N, None, 1.0, inner_method, W_col, Y.dtype,
                           Y.device, tol_eps),
            _make_row_prox(B, M, N, None, 1.0, inner_method, W_row, Y.dtype,
                           Y.device, tol_eps))
    return _dispatch(Y, cfgs, method, max_iters, cfg)


def tvp_2d_batched(Y, w_col, w_row, p_col: float, p_row: float,
                   max_iters: int = 0, cfg: CombinerConfig = DEFAULT_COMBINER):
    """Batched general-norm 2D TV prox by the dr splitting (reference DR2_TV
    with p arguments), on whatever device ``Y`` lies, for any p >= 1.  On
    the card the fiber passes run kernel B1 (p = 1), B4 (p = 2, warm started
    from each fiber's alpha) or B5 (TV-Lp GPFW, warm started from each
    fiber's dual and KKT multiplier)."""
    B, M, N = Y.shape
    w_col = _scalar(w_col, Y.dtype)
    w_row = _scalar(w_row, Y.dtype)
    cfgs = (_make_col_prox(B, M, N, w_col, p_col, "pn", None, Y.dtype,
                           Y.device),
            _make_row_prox(B, M, N, w_row, p_row, "pn", None, Y.dtype,
                           Y.device))
    return _dispatch(Y, cfgs, "dr", max_iters, cfg)
