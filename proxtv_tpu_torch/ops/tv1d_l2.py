"""Batched 1D TV-L2 (grouped-norm) proximity solvers (port of
``proxtv_tpu.ops.tv1d_l2``).

Solves, for every signal in a batch,

    min_x 0.5 ||x - y||^2 + lam ||D x||_2

where ``(Dx)_i = x_i - x_{i+1}``.  The dual is a Euclidean-ball-constrained
quadratic

    min_{||w|| <= lam} 0.5 w' DD' w - w' dy,      dy_i = y_{i+1} - y_i,

(reference ``src/TVL2opt.cpp``), solved by three engines:

*   :func:`tv2_ms` — More-Sorensen secular iteration (reference ``more_TV2``,
    src/TVL2opt.cpp:35).  On a CUDA float32 batch with n <= 8192 it is one
    launch of kernel B4 (:mod:`.kernels.ms_fused`).  For n > 8192 both
    devices solve the secular equation in the DST-I eigenbasis of DD' with
    ``torch.fft`` (the JAX package's spectral path, which has no kernel
    there either); at n <= 8192 the CPU and a float64 CUDA batch (the JAX
    package's float64 route) run the plain composition
    (:func:`_tv2_ms_plain`), its shifted solves on kernel B2 on the card.
*   :func:`tv2_pg` — projected gradient with fixed step 1/4 (reference
    ``PG_TV2``, src/TVL2opt.cpp:446).
*   :func:`tv2_mspg` — the reference default hybrid (``morePG_TV2``,
    src/TVL2opt.cpp:190): PG steps first, MS for the rows still above
    tolerance.  Where B4 runs it goes straight to :func:`tv2_ms`, as the JAX
    package does on its accelerator.

Duality gap (stopping criterion): gap = lam * ||g||_2 + w'g with
g = Dx = D(y + D'w).  The loops are Python loops; each trip reads one flag
to the host.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import debug, diffs
from ..utils.config import DEFAULT_TV2, EPSILON, TV2Config
from ..utils.info import RC_ITERS, RC_OK, make_info
from . import tridiag
from .kernels import gating


def _gap_tv2(w, g, lam):
    """Duality gap: lam * ||g||_2 + w'g (>= 0, == 0 at the optimum)."""
    return torch.abs(lam * torch.linalg.vector_norm(g, dim=-1)
                     + torch.sum(w * g, dim=-1))


def _dst1(x):
    """Orthonormal DST-I along the last axis (involutory), via an
    odd-extension real FFT: FFT([0, x, 0, -reverse(x)])_k = -2i DST1(x)_k.
    DD' is the Dirichlet discrete Laplacian, which DST-I diagonalizes
    (eigenvalues 4 sin^2(k pi / (2(m+1)))), so shifted solves become
    elementwise in this basis."""
    m = x.shape[-1]
    zero = x.new_zeros(x.shape[:-1] + (1,))
    ext = torch.cat([zero, x, zero, -torch.flip(x, dims=[-1])], dim=-1)
    F = torch.fft.rfft(ext, dim=-1)
    return (-0.5 * np.sqrt(2.0 / (m + 1))) * F.imag[..., 1:m + 1].to(x.dtype)


def _smooth23(L: int) -> int:
    """Smallest 2-3-smooth integer >= L."""
    best = 1
    while best < L:
        best *= 2
    t = 3
    while t < best:
        c = t
        while c < L:
            c *= 2
        best = min(best, c)
        t *= 3
    return best


@functools.lru_cache(maxsize=8)
def _chirp_consts(m: int, is64: bool, device: str):
    """Chirp-z constants for an arbitrary-length DST-I (Bluestein): phase
    tables and the FFT of the chirp kernel, computed on the host exact in
    integer arithmetic (j^2 reduced mod 4(m+1), the chirp's phase period) so
    float32 runs keep full phase accuracy at j ~ 1e6, then moved to
    ``device`` once per (length, dtype, device)."""
    M = m + 1
    alpha = np.pi / (2.0 * M)
    j = np.arange(1, m + 1, dtype=np.int64)
    wj = np.exp(1j * alpha * ((j * j) % (4 * M)))          # e^{i a j^2}
    u = np.arange(2 * m - 1, dtype=np.int64) - (m - 1)
    q = np.exp(-1j * alpha * ((u * u) % (4 * M)))          # e^{-i a t^2}
    L = _smooth23(2 * m - 1)
    qhat = np.fft.fft(q, n=L)
    scale = float(np.sqrt(2.0 / M))
    cdt = np.complex128 if is64 else np.complex64
    return (torch.from_numpy(wj.astype(cdt)).to(device),
            torch.from_numpy(qhat.astype(cdt)).to(device), L, scale)


def _dst1_chirp(x):
    """Orthonormal DST-I along the last axis at any length via the chirp-z
    identity jk = (j^2 + k^2 - (k-j)^2)/2:

        DST1(x)_k = Im[ e^{i a k^2} sum_j (x_j e^{i a j^2}) e^{-i a (k-j)^2} ],

    a = pi/(2(m+1)): a linear convolution with the fixed chirp kernel, by two
    same-size FFTs at the nearest 2-3-smooth length >= 2m-1."""
    m = x.shape[-1]
    wj, qhat, L, scale = _chirp_consts(m, x.dtype == torch.float64,
                                       str(x.device))
    a = torch.complex(x * wj.real, x * wj.imag)
    A = torch.fft.fft(a, n=L, dim=-1)
    conv = torch.fft.ifft(A * qhat, dim=-1)[..., m - 1:2 * m - 1]
    # S'_k sits at conv index k-1 (correlation offset m-1); the output
    # chirp e^{i a k^2} equals wj since k ranges over 1..m too.
    s = conv.imag * wj.real + conv.real * wj.imag
    return (scale * s).to(x.dtype)


def _spectral_secular(dy, lamv, safe_lam, tolb, max_iters, zero_pen,
                      alpha_init=None, dst=None, return_w=True):
    """Solve the secular equation ||w(alpha)|| = lam in the DST-I eigenbasis
    of DD': with s = DST(dy) and eigenvalues mu_k,
    ||w(alpha)||^2 = sum_k s_k^2 / (mu_k + alpha)^2, so every Newton step is
    elementwise plus a reduction.  Returns (alpha, aprev, phi_prev, w, iters):
    the root, the previous iterate pair (seeding the real-space secant
    fallback), the dual in real space (None without ``return_w``) and the
    per-row iteration count.  Zero-penalty rows and rows whose constraint is
    inactive at alpha = 0 never iterate; ``alpha_init`` warm-starts the rest;
    the budget is per row."""
    m = dy.shape[-1]
    dtype, dev = dy.dtype, dy.device
    theta = torch.arange(1, m + 1, dtype=dtype, device=dev) * (np.pi / (m + 1))
    mu = 4.0 * torch.sin(0.5 * theta) ** 2
    if dst is None:
        dst = _dst1
    s = dst(dy)
    s2 = s * s

    def norm_phi(alpha):
        denom = mu + alpha[:, None]
        t2 = s2 / (denom * denom)
        P = torch.sum(t2, dim=-1)
        nrm = torch.sqrt(P)
        phi = 1.0 / safe_lam - 1.0 / torch.clamp(nrm, min=EPSILON)
        dphi = -torch.sum(t2 / denom, dim=-1) / torch.clamp(P * nrm,
                                                            min=EPSILON)
        return nrm, phi, dphi

    def newton(alpha, phi, dphi):
        return torch.clamp(alpha - phi / torch.where(
            dphi < -EPSILON, dphi, torch.full_like(dphi, -EPSILON)), min=0.0)

    B = dy.shape[0]
    zero = torch.zeros((B,), dtype=dtype, device=dev)
    nrm0, _, _ = norm_phi(zero)
    # Interior and zero-penalty rows have no positive root: excluded up
    # front so they cannot spend a per-row budget.
    needs_root = (torch.abs(nrm0 - lamv) > tolb) & (nrm0 > lamv) & ~zero_pen
    if alpha_init is None:
        a0 = zero
    else:
        a0 = torch.where(needs_root, torch.clamp(torch.as_tensor(
            alpha_init, dtype=dtype, device=dev), min=0.0), zero)
    nrm_b, phi_b, dphi_b = norm_phi(a0)
    running = needs_root & (torch.abs(nrm_b - lamv) > tolb)
    alpha = torch.where(running, newton(a0, phi_b, dphi_b), a0)
    aprev, phiprev = a0, phi_b
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    while debug.host(torch.any(running & (iters < max_iters))):
        act = running & (iters < max_iters)
        nrm, phi, dphi = norm_phi(alpha)
        alpha_new = newton(alpha, phi, dphi)
        conv = torch.abs(nrm - lamv) <= tolb
        aprev = torch.where(act, alpha, aprev)
        phiprev = torch.where(act, phi, phiprev)
        alpha = torch.where(act & ~conv, alpha_new, alpha)
        iters = iters + act.to(torch.int32)
        running = running & ~(act & conv)
    # The dual in real space by the inverse DST (involutory), or None when
    # the caller recovers it with one exact tridiagonal solve at the root.
    w = dst(s / (mu + alpha[:, None])) if return_w else None
    return alpha, aprev, phiprev, w, iters


def _lam_vec(lam, B, dtype, device):
    lam = torch.as_tensor(lam, dtype=dtype, device=device)
    if lam.ndim == 0:
        return torch.broadcast_to(lam, (B,))
    return lam.reshape(B)


def _fft_friendly(L: int) -> bool:
    """True when the direct odd-extension FFT length is 2-3-smooth up to a
    factor of at most 5 (the JAX package's rule; other lengths take the
    chirp-z DST)."""
    while L % 2 == 0:
        L //= 2
    while L % 3 == 0:
        L //= 3
    return L <= 5


def _ms_kernel_ok(y):
    """Route to kernel B4: True for a float32 CUDA tensor with n <= 8192
    (anything else there the kernel cannot take raises in
    ``gating.gate``); False on the CPU, for a float32 CUDA tensor with
    n > 8192, where the secular iteration runs spectrally, and for a
    float64 CUDA tensor, which takes the composition as in the JAX
    package."""
    return gating.gate(y, "ms")


def tv2_ms(y, lam, cfg: TV2Config = DEFAULT_TV2, alpha_init=None,
           return_alpha: bool = False):
    """Batched More-Sorensen TV-L2 prox: kernel B4 on CUDA float32 with
    n <= 8192, the composition :func:`_tv2_ms_plain` elsewhere (a float64
    CUDA batch among them; see there for the contract)."""
    if _ms_kernel_ok(y):
        from .kernels import ms_fused

        B = y.shape[0]
        kw = dict(max_iters=cfg.max_iters,
                  stop_boundary=float(cfg.stop_boundary))
        if np.ndim(lam) == 0:
            x, alpha, gap, iters = ms_fused.ms_tv2_fused(
                y, lam=float(lam), alpha_init=alpha_init, **kw)
        else:
            x, alpha, gap, iters = ms_fused.ms_tv2_fused(
                y, lam_rows=torch.as_tensor(lam, dtype=y.dtype,
                                            device=y.device).reshape(B),
                alpha_init=alpha_init, **kw)
        rc = torch.where(iters >= cfg.max_iters, RC_ITERS, RC_OK)
        info = make_info(iters, gap, rc)
        if return_alpha:
            return x, info, alpha
        return x, info
    return _tv2_ms_plain(y, lam, cfg=cfg, alpha_init=alpha_init,
                         return_alpha=return_alpha)


def _tv2_ms_plain(y, lam, cfg: TV2Config = DEFAULT_TV2, alpha_init=None,
                  return_alpha: bool = False):
    """Batched More-Sorensen TV-L2 prox, the composition.

    Args:
        y: (B, n) batch of signals.
        lam: scalar or (B,) nonnegative penalties.
        cfg: tolerances (defaults mirror reference src/TVopt.h:36-39).
        alpha_init: optional (B,) secular-multiplier warm start (the
            reference's Workspace warm restart, src/TVL2opt.cpp:255-257);
            combiners carry each fiber's alpha across outer sweeps.
        return_alpha: also return the final multiplier.

    Returns:
        (x, info) or (x, info, alpha).
    """
    B, n = y.shape
    dtype, dev = y.dtype, y.device
    if n == 1:
        info1 = make_info(torch.zeros((B,), dtype=torch.int32, device=dev),
                          torch.zeros((B,), dtype=dtype, device=dev),
                          torch.zeros((B,), dtype=torch.int32, device=dev))
        if return_alpha:
            return y, info1, torch.zeros((B,), dtype=dtype, device=dev)
        return y, info1
    lamv = _lam_vec(lam, B, dtype, dev)
    # Center (translation equivariance; the dual is unchanged).
    ybar = torch.mean(y, dim=-1, keepdim=True)
    y = y - ybar
    dy = diffs.forward_diff(y)

    zero_pen = lamv <= 0
    safe_lam = torch.where(lamv > 0, lamv, torch.ones_like(lamv))
    tolb = cfg.stop_boundary * safe_lam

    def solve(rhs, alpha):
        # The JAX package's accelerator branch (tv1d_l2.py:301-308): on the
        # card (a float64 batch, or a float32 one past B4's lanes) kernel
        # B2 with a per-row shift up to 8192 lanes.  The CPU, longer
        # systems and one-lane systems (n = 2) take the normalized PCR,
        # which solves one lane in closed form on either device.
        if rhs.shape[-1] > 1 and gating.gate(rhs, "pcr"):
            return tridiag.spd_second_difference_solve(
                rhs, diag_shift=alpha[:, None])
        return tridiag.spd_shifted_solve_normalized(rhs, alpha[:, None])

    if n > 8192:
        # Large fibers: the secular equation in the DST-I eigenbasis of DD'.
        # 2-3-smooth lengths use the direct odd-extension rfft both ways;
        # every other length takes the chirp-z DST forward and recovers the
        # dual with one exact tridiagonal solve at the root.  The secant
        # loop below runs only if FFT rounding left the real-space norm
        # outside tolerance (seeded with the spectral iterate pair).
        friendly = _fft_friendly(2 * n)
        alpha1, a_start, phi_s, w_s, it0 = _spectral_secular(
            dy, lamv, safe_lam, tolb, cfg.max_iters, zero_pen,
            alpha_init=alpha_init, dst=_dst1 if friendly else _dst1_chirp,
            return_w=friendly)
        if w_s is None:
            w_s = solve(dy, alpha1)
        nrm_s = torch.linalg.vector_norm(w_s, dim=-1)
        interior0 = (alpha1 <= 0) & (nrm_s <= lamv) & ~zero_pen
    else:
        # Bootstrap: one Newton step of phi(alpha) = 1/lam - 1/||w(alpha)||
        # (reference more_TV2 update, src/TVL2opt.cpp:106-128), then the
        # secant iteration (one solve per step), as kernel B4 runs it.
        if alpha_init is None:
            a_start = torch.zeros((B,), dtype=dtype, device=dev)
        else:
            a_start = torch.clamp(torch.as_tensor(alpha_init, dtype=dtype,
                                                  device=dev), min=0.0)
        w_s = solve(dy, a_start)
        q_s = solve(w_s, a_start)
        nrm_s = torch.linalg.vector_norm(w_s, dim=-1)
        wq_s = torch.sum(w_s * q_s, dim=-1)
        delta0 = ((nrm_s * nrm_s / torch.clamp(wq_s, min=EPSILON))
                  * (nrm_s - safe_lam) / safe_lam)
        alpha1 = torch.clamp(a_start + delta0, min=0.0)
        phi_s = 1.0 / safe_lam - 1.0 / torch.clamp(nrm_s, min=EPSILON)
        # Interior case: alpha at 0 with ||w|| <= lam (x is the mean).
        interior0 = (a_start <= 0) & (nrm_s <= lamv) & ~zero_pen
        it0 = torch.zeros((B,), dtype=torch.int32, device=dev)
    conv0 = (torch.abs(nrm_s - lamv) <= tolb) | interior0
    running = ~conv0 & ~zero_pen

    alpha, aprev, phiprev, w, interior, iters = (alpha1, a_start, phi_s, w_s,
                                                 interior0, it0)
    while debug.host(torch.any(running & (iters < cfg.max_iters))):
        # Per-row budget: a row that exhausted cfg.max_iters freezes (and
        # exits with RC_ITERS) without starving rows that still converge.
        act = running & (iters < cfg.max_iters)
        w_new = solve(dy, alpha)
        nrm = torch.linalg.vector_norm(w_new, dim=-1)
        phi = 1.0 / safe_lam - 1.0 / torch.clamp(nrm, min=EPSILON)
        denom = phi - phiprev
        secant = alpha - phi * (alpha - aprev) / denom
        alpha_new = torch.clamp(
            torch.where(torch.abs(denom) > EPSILON, secant, alpha), min=0.0)
        inter = (alpha <= 0) & (nrm <= lamv)
        conv = (torch.abs(nrm - lamv) <= tolb) | inter
        w = torch.where(act[:, None], w_new, w)
        interior = torch.where(act, inter, interior)
        aprev = torch.where(act, alpha, aprev)
        phiprev = torch.where(act, phi, phiprev)
        alpha = torch.where(act & ~conv, alpha_new, alpha)
        iters = iters + act.to(torch.int32)
        running = running & ~(act & conv)

    x = diffs.dual2primal(w, y)
    x = torch.where(interior[:, None], torch.zeros_like(x), x)
    x = torch.where(zero_pen[:, None], y, x)
    g = diffs.primal2grad(x)
    gap = torch.where(interior | zero_pen, torch.zeros_like(lamv),
                      _gap_tv2(w, g, lamv))
    rc = torch.where(running, RC_ITERS, RC_OK)
    info = make_info(iters, gap, rc)
    if return_alpha:
        return x + ybar, info, alpha
    return x + ybar, info


def tv2_pg(y, lam, cfg: TV2Config = DEFAULT_TV2, max_iters: int | None = None):
    """Batched projected-gradient TV-L2 prox (reference PG_TV2,
    src/TVL2opt.cpp:446): fixed step 1/L, L = 4 = lambda_max(DD'), and the
    ball projection as a radial shrink."""
    B, n = y.shape
    dtype, dev = y.dtype, y.device
    if n == 1:
        return y, make_info(torch.zeros((B,), dtype=torch.int32, device=dev),
                            torch.zeros((B,), dtype=dtype, device=dev),
                            torch.zeros((B,), dtype=torch.int32, device=dev))
    lamv = _lam_vec(lam, B, dtype, dev)
    ybar = torch.mean(y, dim=-1, keepdim=True)
    y = y - ybar
    dy = diffs.forward_diff(y)
    cap = int(max_iters) if max_iters else cfg.pg_max_iters
    step = cfg.pg_step
    # Reference-parity absolute tolerance with a dtype-achievability floor:
    # in float64 tol == cfg.stop; in float32 the floor ~10 eps ||y||^2 keeps
    # the loop from chasing gaps the dtype cannot resolve.
    scale = torch.clamp(0.5 * torch.sum(y * y, dim=-1), min=1.0)
    tol = torch.clamp(10.0 * torch.finfo(dtype).eps * scale, min=cfg.stop)

    def proj_ball(w):
        nrm = torch.linalg.vector_norm(w, dim=-1)
        s = torch.where(nrm > lamv, lamv / torch.clamp(nrm, min=EPSILON),
                        torch.ones_like(nrm))
        return w * s[:, None]

    def grad(w):
        # DD'w - dy, where DD' is the second-difference (2,-1) matrix.
        return diffs.primal2grad(diffs.adjoint_diff(w)) - dy

    w = torch.zeros((B, n - 1), dtype=dtype, device=dev)
    gap = _gap_tv2(w, diffs.primal2grad(y), lamv)
    running = (gap > tol) & (lamv > 0)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    it = 0
    while it < cap and debug.host(torch.any(running)):
        w_new = proj_ball(w - step * grad(w))
        g = diffs.primal2grad(diffs.dual2primal(w_new, y))
        gap_new = _gap_tv2(w_new, g, lamv)
        w = torch.where(running[:, None], w_new, w)
        gap = torch.where(running, gap_new, gap)
        iters = iters + running.to(torch.int32)
        running = running & (gap > tol)
        it += 1
    x = diffs.dual2primal(w, y) + ybar
    rc = torch.where(running, RC_ITERS, RC_OK)
    return x, make_info(iters, gap, rc)


def tv2_mspg(y, lam, cfg: TV2Config = DEFAULT_TV2):
    """Hybrid PG-then-MS TV-L2 prox (reference morePG_TV2,
    src/TVL2opt.cpp:190): up to ``cfg.mspg_pg_iters`` PG steps; rows that
    have not converged are finished with More-Sorensen.  Where kernel B4
    runs, the hybrid goes straight to it: both reach the same fixed point,
    and the kernel alone is cheaper than the PG burst it would skip."""
    if _ms_kernel_ok(y):
        return tv2_ms(y, lam, cfg=cfg)
    x_pg, info_pg = tv2_pg(y, lam, cfg=cfg, max_iters=cfg.mspg_pg_iters)
    yc = y - torch.mean(y, dim=-1, keepdim=True)
    scale = torch.clamp(0.5 * torch.sum(yc ** 2, dim=-1), min=1.0)
    need_ms = info_pg.gap > torch.clamp(
        10.0 * torch.finfo(y.dtype).eps * scale, min=cfg.stop)
    x_ms, info_ms = tv2_ms(y, lam, cfg=cfg)
    x = torch.where(need_ms[:, None], x_ms, x_pg)
    iters = info_pg.iters + torch.where(need_ms, info_ms.iters,
                                        torch.zeros_like(info_ms.iters))
    gap = torch.where(need_ms, info_ms.gap, info_pg.gap)
    rc = torch.where(need_ms, info_ms.rc, info_pg.rc)
    return x, make_info(iters, gap, rc)


def tv2_batched(y, lam, method: str = "mspg", cfg: TV2Config = DEFAULT_TV2):
    """Method dispatch mirroring the reference (prox_tv/__init__.py:257-309)."""
    method = method.lower()
    if method == "ms":
        return tv2_ms(y, lam, cfg=cfg)
    if method == "pg":
        return tv2_pg(y, lam, cfg=cfg)
    if method == "mspg":
        return tv2_mspg(y, lam, cfg=cfg)
    raise ValueError(f"Unknown TV-L2 method: {method!r}")
