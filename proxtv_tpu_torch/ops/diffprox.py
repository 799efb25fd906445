"""Differentiable TV proximity operators (``torch.autograd.Function``), the
port's counterpart of ``proxtv_tpu.ops.diffprox``.

The iterative solvers are Python loops over kernel launches and are not
recorded by autograd: the forward runs them on detached tensors.  The
*solution map* of the TV-L1 prox has a closed-form generalized Jacobian:

    x* = prox_{lam TV}(y) is piecewise constant; on each constant segment S
    the optimality conditions pin x*_S = mean(y_S) + (boundary dual terms
    independent of y_S to first order), so  dx*/dy = P = block-diagonal
    averaging over the segments of x*.   P is symmetric (P = P^T), hence the
    VJP of g is also the segment-mean of g.

d/d lam: on each segment, d x*_S / d lam = (s_out - s_in)/|S| where s_in/s_out
in {-1, 0, +1} are the signs of the jumps into/out of the segment (0 at the
ends) — the standard taut-string sensitivity.  Both derivatives are exact a.e.
(the solution map is piecewise affine in (y, lam)).

The backward passes are PyTorch ops on the tensor's device (the JAX package
computes them outside any Pallas kernel too), except the 2D backward's
labelling of the flat components: on the card one call of kernel L1
(:func:`.kernels.labels.component_labels`, no host read); on the CPU its
plain version, min-label propagation with one host read a trip
(:data:`proxtv_tpu_torch.utils.debug.HOST_SYNCS`), the trips counted in
:data:`LABEL_TRIPS`.
"""
from __future__ import annotations

import torch

from ..utils import debug
from . import tv1d_l1
from .kernels import labels as label_kernel

_SEG_TOL = 1e-6       # 1D: engines are exact to solver tolerance
_SEG_TOL_2D = 1e-4    # 2D: combiners stop at mean-change 1e-6, leaving
                      # truly-flat edges at ~1e-5 residual jumps — classify
                      # relative to that convergence level, not exactness.

# Kernel B1's float32 stop floor in the forward (``pn_tv1_fused``'s
# ``tol_eps``; the TPU kernel's is 10).  The backward classifies edges at
# _SEG_TOL of the scale, so the 1D forward certifies without a floor; the
# 2D fiber passes, inside a splitting that itself stops at a mean change of
# 1e-6, stop at the float32 resolution of each fiber's objective (1 eps):
# there B1 and its plain version part by at most one Newton iteration and
# 2e-4, against two and 1.1e-4 with no floor and 1.3e-3 with the TPU's
# (tools/train_stop.py on an H100).
_TOL_EPS_1D = 0.0
_TOL_EPS_2D = 1.0

# Trips of the 2D backward's label propagation on the CPU (two hops each).
LABEL_TRIPS = label_kernel.LABEL_TRIPS


def _segment_mean(v, seg_start):
    """Per-row segment means: seg_start (B, n) bool marks segment heads.

    Returns (mean, seg_len, head, tail_excl): each element's segment mean
    and length, the index of its segment's head, and the first head index
    past it (int64)."""
    B, n = v.shape
    idx = torch.arange(n, device=v.device).expand(B, n)
    head_idx = torch.where(seg_start, idx, 0)
    head = torch.cummax(head_idx, dim=1).values   # segment head of each elem
    cs = torch.cumsum(v, dim=1)
    cs0 = torch.cat([v.new_zeros((B, 1)), cs[:, :-1]], dim=1)
    # tail: next head - 1 (a reverse min of the head indices of successors)
    nxt_head = torch.cat([torch.where(seg_start[:, 1:], idx[:, 1:], n),
                          torch.full((B, 1), n, device=v.device)], dim=1)
    tail_excl = torch.flip(torch.cummin(torch.flip(nxt_head, [1]), dim=1)
                           .values, [1])            # first head index > i
    last = torch.clamp(tail_excl - 1, 0, n - 1)
    seg_sum = torch.gather(cs, 1, last) - torch.gather(cs0, 1, head)
    seg_len = (tail_excl - head).to(v.dtype)
    return seg_sum / seg_len, seg_len, head, tail_excl


def _boundaries(x):
    """The jumps of the 1D solution ``x`` (B, n) and where they count as
    segment boundaries (B, n-1): over _SEG_TOL of the row's scale."""
    scale = torch.clamp(x.abs().amax(dim=1, keepdim=True), min=1.0)
    jump = x[:, 1:] - x[:, :-1]
    return jump, jump.abs() > _SEG_TOL * scale


def _bwd(x, g, lam_ndim):
    """VJP of the 1D prox at its solution ``x``: (gy, glam), glam summed
    over rows for a 0-d lam and per row for a (B,) lam."""
    B, n = x.shape
    jump, is_boundary = _boundaries(x)
    seg_start = torch.cat([torch.ones((B, 1), dtype=torch.bool,
                                      device=x.device), is_boundary], dim=1)
    gmean, seg_len, head, tail_excl = _segment_mean(g, seg_start)
    gy = gmean  # P^T g = P g (averaging projector, symmetric)

    # d x / d lam per element: (sign(jump_out) - sign(jump_in)) / |S|
    sj = torch.sign(jump) * is_boundary
    zero = x.new_zeros((B, 1))
    s_in = torch.cat([zero, sj], dim=1)
    s_out = torch.cat([sj, zero], dim=1)
    s_in_h = torch.gather(s_in, 1, head)
    s_out_t = torch.gather(s_out, 1, torch.clamp(tail_excl - 1, 0, n - 1))
    dxdlam = (s_out_t - s_in_h) / seg_len
    glam_b = torch.sum(g * dxdlam, dim=1)
    glam = torch.sum(glam_b) if lam_ndim == 0 else glam_b
    return gy, glam


def _host_lam(lam):
    """A 0-d tensor penalty read to the host (one counted sync): the solvers
    take a scalar penalty as a number."""
    if torch.is_tensor(lam) and lam.ndim == 0:
        return debug.host(lam.detach())
    return lam.detach() if torch.is_tensor(lam) else lam


class _TV1Prox(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, lam, method):
        x = tv1d_l1.tv1_batched(y.detach(), _host_lam(lam), method=method,
                                tol_eps=_TOL_EPS_1D)
        ctx.save_for_backward(x)
        ctx.lam_ndim = lam.ndim if torch.is_tensor(lam) else 0
        ctx.lam_dtype = lam.dtype if torch.is_tensor(lam) else None
        return x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        gy, glam = _bwd(x, g, ctx.lam_ndim)
        if not ctx.needs_input_grad[1]:
            glam = None
        elif ctx.lam_dtype is not None:
            glam = glam.to(ctx.lam_dtype)
        return gy, glam, None


def tv1_prox(y, lam, method: str = "pn"):
    """Differentiable batched 1D TV-L1 prox: (B, n), scalar/batched lam.

    Forward = ``tv1d_l1.tv1_batched(y, lam, method=method)`` on the detached
    input; backward = exact generalized Jacobian (segment averaging for y;
    jump-sign sensitivity for lam, summed over rows for a 0-d lam and per
    row for a (B,) lam).  A 0-d tensor lam is read to the host once a
    forward.

    On the card the forward asks kernel B1 for no stop floor
    (``tol_eps=0``): B1's TPU floor (gap <= 10 eps 0.5 ||y - mean(y)||^2 in
    float32) lets a small lam stop far from the solution — at lam 0.01 on
    1000-sample rows of unit scale 1.4e-2 from float64, more than lam
    itself, where the backward classifies segments at 1e-6 of the row's
    scale; without the floor it lands 2.3e-4 away, in less than one Newton
    iteration more per row.
    """
    return _TV1Prox.apply(y, lam, method)


# ---------------------------------------------------------------------------
# 2D: the anisotropic TV-L1 solution is piecewise constant on 4-connected flat
# components; the same stationarity argument gives dX*/dY = component-wise
# averaging (symmetric projector), so the VJP is the component mean of g.
# ---------------------------------------------------------------------------


def _component_mean(g, labels):
    """Mean of g over each labeled component (labels = per-image linear ids)."""
    B, M, N = g.shape
    offs = torch.arange(B, device=g.device, dtype=torch.int64) * (M * N)
    ids = (labels.reshape(B, -1).to(torch.int64) + offs[:, None]).reshape(-1)
    v = g.reshape(-1)
    sums = torch.zeros(B * M * N, dtype=g.dtype, device=g.device)
    sums.index_add_(0, ids, v)
    cnts = torch.zeros(B * M * N, dtype=g.dtype, device=g.device)
    cnts.index_add_(0, ids, torch.ones_like(v))
    return (sums[ids] / cnts[ids]).reshape(B, M, N)


def _seg_tol(X):
    """The flat-edge tolerance of each image of ``X`` (B, M, N): (B,),
    _SEG_TOL_2D of the image's scale."""
    scale = torch.clamp(X.reshape(X.shape[0], -1).abs().amax(dim=1), min=1.0)
    return _SEG_TOL_2D * scale


def _flat_edges(X):
    """The edges of the 2D solution ``X`` (B, M, N) that count as flat
    (within _SEG_TOL_2D of the image's scale): (flat_r (B, M, N-1),
    flat_c (B, M-1, N))."""
    return label_kernel.flat_edges(X, _seg_tol(X))


def _bwd2(X, g):
    """VJP of the 2D prox at its solution ``X`` (B, M, N) for the input."""
    return _component_mean(g, label_kernel.component_labels(X.contiguous(),
                                                            _seg_tol(X)))


class _TV2DProx(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Y, lam, method, max_iters):
        from ..models import tv2d

        lam_arg = lam.detach() if torch.is_tensor(lam) else lam
        X = tv2d.tv1_2d_batched(Y.detach(), lam_arg, method=method,
                                max_iters=max_iters,
                                tol_eps=_TOL_EPS_2D)[0]
        ctx.save_for_backward(X)
        ctx.lam_like = lam_arg if torch.is_tensor(lam) else None
        return X

    @staticmethod
    def backward(ctx, g):
        (X,) = ctx.saved_tensors
        gY = _bwd2(X, g)
        glam = (torch.zeros_like(ctx.lam_like)
                if ctx.needs_input_grad[1] else None)
        return gY, glam, None, None


def tv2d_prox(Y, lam, method: str = "dr", max_iters: int = 0):
    """Differentiable batched 2D anisotropic TV-L1 prox on (B, M, N).

    Forward = ``models.tv2d.tv1_2d_batched(Y, lam, method, max_iters)[0]``
    on the detached input, its fiber passes on kernel B1 with a float32 stop
    floor of 1 eps (``_TOL_EPS_2D``) in place of the TPU's 10; backward =
    exact generalized Jacobian (4-connected flat-component averaging).  lam
    receives no gradient (zeros, as ``jax.grad`` gives through the JAX
    package's VJP) — use :func:`tv1_prox` for 1D lam sensitivity or finite
    differences for 2D hyperparameter tuning.
    """
    return _TV2DProx.apply(Y, lam, method, max_iters)
