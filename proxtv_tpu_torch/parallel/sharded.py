"""Multi-card entry points on a ``torch.distributed`` mesh (port of
``proxtv_tpu.parallel.sharded``).

Every rank of the mesh's process group calls the same function with the
same global array, as every host of a JAX program calls the same jitted
function, and gets the whole result back, on its device, with the
``SolverInfo`` the JAX function returns.

*   **Batch parallelism** (``tv1_1d_sharded``, ``tv2_1d_sharded``,
    ``tvp_1d_sharded``, ``tv1_2d_sharded(shard_axis="batch")``,
    ``tv1_2d_sharded_fused``, ``tv1w_2d_sharded_fused``,
    ``tv_nd_sharded``): each rank solves its rows with the single-card
    engine and the results are all-gathered at the end; nothing moves
    during the solve, and each rank stops on its own rows' certificates.
*   **Fiber parallelism** (``tv1_2d_sharded(shard_axis="cols")``): one
    image's columns spread over the ranks; the column pass runs on whole
    columns, the row pass on whole rows, with an all-to-all transpose
    between them.
*   **Banded solves** (``tv1_2d_banded``, ``tv1w_2d_banded``,
    ``tv1_3d_banded``, ``tv1_1d_banded``): one image, volume or signal
    spans the mesh; each rank holds its band plus halos, runs kernel B3, B6
    or B1 on it, exchanges halos with its neighbours and all-reduces the
    certificate.  The band is gathered only at the end.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import tv2d, tvnd
from ..ops import tv1d_l1, tv1d_l2, tv1d_long_banded, tv1d_lp
from ..ops.kernels import gating
from ..utils.config import DEFAULT_COMBINER
from ..utils.info import SolverInfo, make_info
from . import comm
from .comm import Mesh, make_mesh  # noqa: F401

def _host(Y):
    """The caller's global array as a tensor where it lies (a numpy array
    stays on the host: only the rank's part moves to its device)."""
    return torch.as_tensor(np.asarray(Y) if not torch.is_tensor(Y) else Y)


def _gather_tree(mesh, out, counts):
    """All-gather each rank's leading-dim slice of every tensor in ``out``
    (a tensor, a ``SolverInfo`` or a tuple of them); ``counts`` are the
    ranks' row counts, padded to the largest for the gather."""
    if isinstance(out, SolverInfo):
        return SolverInfo(*(_gather_tree(mesh, f, counts)
                            for f in (out.iters, out.gap, out.rc)))
    if isinstance(out, (tuple, list)):
        return type(out)(_gather_tree(mesh, o, counts) for o in out)
    share = max(counts)
    mine = counts[mesh.rank]
    pad = out[:mine]
    if share > mine:
        pad = torch.cat([pad, pad.new_zeros((share - mine,) + out.shape[1:])])
    full = comm.all_gather(mesh, pad)
    return torch.cat([full[r * share: r * share + c]
                      for r, c in enumerate(counts)])


def _batch_sharded(fn, mesh, *arrays):
    """Run ``fn`` on this rank's rows of the global ``arrays`` (split as
    ``torch.tensor_split`` splits them) and gather the results.  A rank
    with no rows solves its first row's zeros to learn the output's shape,
    and contributes nothing."""
    B = arrays[0].shape[0]
    counts = [len(c) for c in torch.tensor_split(torch.arange(B), mesh.size)]
    start = sum(counts[:mesh.rank])
    mine = counts[mesh.rank]
    if mine:
        parts = [_host(a)[start:start + mine] for a in arrays]
    else:
        parts = [torch.zeros_like(_host(a)[:1]) for a in arrays]
    parts = [p.to(mesh.device) for p in parts]
    return _gather_tree(mesh, fn(*parts), counts)


def tv1_1d_sharded(Y, lam, mesh: Mesh, method: str = "hybridtautstring"):
    """Batched 1D TV-L1 with the batch split over the mesh (``tv1_batched``
    per rank: B1 or D1 on the card)."""
    return _batch_sharded(lambda y: tv1d_l1.tv1_batched(y, lam, method=method),
                          mesh, Y)


def tv2_1d_sharded(Y, lam, mesh: Mesh, method: str = "mspg"):
    """Batched 1D TV-L2 with the batch split over the mesh (B4 per rank)."""
    return _batch_sharded(lambda y: tv1d_l2.tv2_batched(y, lam, method=method),
                          mesh, Y)


def tvp_1d_sharded(Y, lam, p: float, mesh: Mesh, method: str = "gpfw"):
    """Batched 1D TV-Lp with the batch split over the mesh (B5 and B2 per
    rank)."""
    return _batch_sharded(
        lambda y: tv1d_lp.tvp_batched(y, lam, p, method=method), mesh, Y)


def tv1_2d_sharded(Y, lam, mesh: Mesh, method: str = "dr", max_iters: int = 0,
                   shard_axis: str = "batch"):
    """Batched 2D TV-L1 prox over the mesh.

    ``shard_axis="batch"``: the images split over the ranks.
    ``shard_axis="cols"``: every image's columns split over the ranks
    (fiber parallelism for one large image), for every method, as the JAX
    package shards them:

    *   pd, dr, yang: the column pass runs on the rank's whole columns, the
        row pass on whole rows after an all-to-all transpose; ``lam`` is a
        scalar or a (B,) per-image penalty (uniform per-edge weights, B1's
        weighted fibers on the card).
    *   condat, chambolle-pock, chambolle-pock-acc: the unfused primal-dual
        iteration (one sweep a step, plain tensor ops, no kernel), as the
        JAX package runs it under sharding; the row differences reach the
        neighbour's column through a one-column halo exchange.
    *   kolmogorov: the exact column prox on the rank's own columns (B1 on
        the card), the row dual with the same one-column halos.

    The stop's mean change and the schedule's statistic are all-reduced, so
    every rank takes the same branch.  A per-image ``lam`` with a
    primal-dual method or kolmogorov raises ``ValueError``, as in the JAX
    package.  For one large image :func:`tv1_2d_banded` is the fast route:
    kernel B3 on each rank's band, a halo exchange every K steps instead of
    every step, and a duality-gap certificate.
    """
    if shard_axis == "batch":
        return _batch_sharded(lambda y: tv2d.tv1_2d_batched(
            y, lam, method=method, max_iters=max_iters), mesh, Y)
    if shard_axis != "cols":
        raise ValueError(f"shard_axis must be 'batch' or 'cols', got "
                         f"{shard_axis!r}")
    return _tv1_2d_cols(_host(Y), lam, mesh, method.lower(), max_iters)


_SPLITTING = ("pd", "dr", "yang")


def _tv1_2d_cols(Y, lam, mesh, method, max_iters, cfg=DEFAULT_COMBINER):
    """Fiber-parallel 2D solve: the state lives column-split, (B, M, N_r) a
    rank; the splitting methods' row pass transposes to (B, M_r, N) and
    back, the primal-dual methods exchange one column with each
    neighbour."""
    if method not in _SPLITTING + ("kolmogorov",) + tuple(tv2d._PDHG_VARIANTS):
        raise ValueError(f"Unknown 2D method: {method!r}")
    per_image = (lam.ndim if torch.is_tensor(lam) else np.ndim(lam)) == 1
    if per_image and method in tv2d._PDHG_VARIANTS:
        raise ValueError("weighted primal-dual requires the fused kernel on "
                         "one card; shard_axis='cols' runs it unfused, so "
                         "use method='dr' or 'pd'")
    if per_image and method not in _SPLITTING:
        raise ValueError(f"method {method!r} does not support per-image "
                         "penalties; use a scalar lam or one of pd/dr/yang")
    B, M, N = Y.shape
    P, r = mesh.size, mesh.rank
    cols = [len(c) for c in torch.tensor_split(torch.arange(N), P)]
    c0 = sum(cols[:r])
    Yl = Y[:, :, c0:c0 + cols[r]].to(mesh.device)
    dt, dev = Yl.dtype, mesh.device
    if per_image:
        lam = torch.as_tensor(lam, dtype=dt).to(dev)
    else:
        lam = tv2d._scalar(float(lam), dt)

    def mean_change(x, x_last):
        """Per-image mean |x - x_last| over the whole image, all-reduced."""
        part = torch.sum(torch.abs(x - x_last), dim=(1, 2))
        return comm.all_reduce(mesh, part) / (M * N)

    tol = cfg.stop
    if method in _SPLITTING:
        x, info = _cols_splitting(Yl, lam, mesh, method, max_iters, cfg,
                                  cols, M, N, mean_change)
    else:
        if min(cols) == 0:
            raise ValueError(f"shard_axis='cols' with {method!r} needs a "
                             f"column on every rank: {N} columns over "
                             f"{P} ranks")
        drow, drow_t = _row_differences(mesh, r == P - 1)
        row_edges = cols[r] - (r == P - 1)  # the row edges this rank holds

        def edge_mean(t):
            """The mean of a row-edge field over the whole image."""
            return comm.all_reduce(mesh, torch.sum(t)) / (B * M * (N - 1))

        if method == "kolmogorov":
            x, info = tv2d._run_kolmogorov(
                Yl, lam, lam, max_iters or cfg.max_iters_kolmogorov, tol,
                "pn", drow=drow, drow_t=drow_t, mean_change=mean_change,
                row_edges=row_edges)
        else:
            x, info = tv2d._run_pdhg(
                Yl, lam, lam, max_iters or cfg.max_iters_condat, tol, cfg,
                tv2d._PDHG_VARIANTS[method], drow=drow, drow_t=drow_t,
                edge_mean=edge_mean, mean_change=mean_change,
                row_edges=row_edges)
    # the column blocks, padded to the widest, gathered column-major
    w = max(cols)
    full = comm.all_gather(mesh, torch.nn.functional.pad(
        x, (0, w - x.shape[2])).permute(2, 0, 1).contiguous())
    x = torch.cat([full[j * w: j * w + cols[j]] for j in range(P)])
    return x.permute(1, 2, 0), info


def _row_differences(mesh, last: bool):
    """The row differences of a column-split field and their adjoint.

    A rank holds the row edges that start in its columns: N_r of them, and
    N_r - 1 on the last rank, whose last column ends the image.  ``drow``
    reaches into the first column of the rank to the right, ``drow_t`` into
    the last edge of the rank to the left (``comm.column_halo``, one
    exchange each); every entry is the single-card stencil's own
    difference, so a one-rank mesh gives ``tv2d._drow`` / ``_drow_t`` bit
    for bit."""

    def drow(X):
        nxt = comm.column_halo(mesh, X[..., :1], -1)
        return tv2d._drow(X if last else torch.cat([X, nxt], dim=-1))

    def drow_t(U):
        n = U.shape[-1] + last  # the rank's columns
        tail = U[..., -1:] if U.shape[-1] else U.new_zeros(
            U.shape[:-1] + (1,))
        prev = comm.column_halo(mesh, tail, 1)
        cur = torch.cat([U, torch.zeros_like(tail)], dim=-1) if last else U
        return cur - torch.cat([prev, U[..., :n - 1]], dim=-1)

    return drow, drow_t


def _cols_splitting(Yl, lam, mesh, method, max_iters, cfg, cols, M, N,
                    mean_change):
    """pd, dr or yang on the rank's (B, M, N_r) column block: the column
    pass on its own columns, the row pass on (B, M_r, N) rows after an
    all-to-all.  ``lam``: a scalar, or a (B,) tensor of per-image
    penalties, which the passes take as uniform per-edge weight fields."""
    B = Yl.shape[0]
    P, r = mesh.size, mesh.rank
    rows = [len(c) for c in torch.tensor_split(torch.arange(M), P)]
    dt, dev = Yl.dtype, mesh.device

    def to_rows(V):
        """(B, M, N_r) column-split -> (B, M_r, N) row-split."""
        sends = [V[:, sum(rows[:j]):sum(rows[:j + 1])] for j in range(P)]
        got = comm.all_to_all(mesh, sends,
                              [(B, rows[r], cols[j]) for j in range(P)])
        return torch.cat(got, dim=2)

    def to_cols(V):
        """(B, M_r, N) row-split -> (B, M, N_r) column-split."""
        sends = [V[:, :, sum(cols[:j]):sum(cols[:j + 1])] for j in range(P)]
        got = comm.all_to_all(mesh, sends,
                              [(B, rows[j], cols[r]) for j in range(P)])
        return torch.cat(got, dim=1)

    def stateful(make, m, n, edges, scale):
        """A fiber pass on the rank's (B, m, n) block; nothing to do on an
        empty one (its state is empty too).  ``edges``: the block's edge
        count along the pass, for per-image weights."""
        if B * m * n == 0:
            return (lambda V, s: (V, s)), Yl.new_zeros((0,))
        if torch.is_tensor(lam):
            w = torch.broadcast_to(lam[:, None, None] / scale, (B,) + edges)
            return make(B, m, n, None, 1.0, "pn", w, dt, dev)
        return make(B, m, n, lam / scale, 1.0, "pn", None, dt, dev)

    def passes(scale):
        pc, s1 = stateful(tv2d._make_col_prox, M, cols[r],
                          (M - 1, cols[r]), scale)
        pr, s2 = stateful(tv2d._make_row_prox, rows[r], N,
                          (rows[r], N - 1), scale)

        def prow(V, s):
            out, s = pr(to_rows(V), s)
            return to_cols(out), s

        return pc, s1, prow, s2

    tol = cfg.stop
    if method == "yang":
        rho = cfg.yang_rho
        pc, s1, prow, s2 = passes(tv2d._scalar(rho, dt))
        return tv2d._run_yang(Yl, pc, s1, prow, s2,
                              max_iters or cfg.max_iters_yang, tol, rho,
                              mean_change=mean_change)
    pc, s1, prow, s2 = passes(tv2d._scalar(1.0, dt))
    run = tv2d._run_pd if method == "pd" else tv2d._run_dr
    cap = max_iters or (cfg.max_iters_pd if method == "pd"
                        else cfg.max_iters_dr)
    return run(Yl, pc, s1, prow, s2, cap, tol, mean_change=mean_change)


def tv1_2d_sharded_fused(Y, lam, mesh: Mesh,
                         method: str = "chambolle-pock-acc",
                         max_iters: int = 0):
    """Batch-split 2D TV-L1 with the chunked PDHG solve per rank (B3 on
    the card): each rank solves its own (B/P, M, N) sub-batch, stops on its
    own images' certificates and communicates only in the final gather.
    B must be divisible by the mesh size."""
    B = _host(Y).shape[0]
    if B % mesh.size:
        raise ValueError(f"batch {B} not divisible by mesh size {mesh.size}")
    return _batch_sharded(lambda y: tv2d.tv1_2d_batched(
        y, lam, method=method, max_iters=max_iters), mesh, Y)


def tv1w_2d_sharded_fused(Y, W_col, W_row, mesh: Mesh,
                          method: str = "chambolle-pock-acc",
                          max_iters: int = 0):
    """Weighted variant of :func:`tv1_2d_sharded_fused`: the per-edge
    weight fields split with the batch."""
    Y = _host(Y)
    if Y.shape[0] % mesh.size:
        raise ValueError(f"batch {Y.shape[0]} not divisible by mesh size "
                         f"{mesh.size}")
    W_col = _host(W_col).to(Y.dtype)
    W_row = _host(W_row).to(Y.dtype)
    return _batch_sharded(lambda y, wc, wr: tv2d.tv1w_2d_batched(
        y, wc, wr, method=method, max_iters=max_iters), mesh, Y, W_col, W_row)


def _band(A, start: int, rows: int, shape_pad):
    """Rows [start, start + rows) of ``A`` zero-padded to ``rows`` and to
    the trailing shape ``shape_pad``: a rank's band of the padded canvas,
    cut before it moves."""
    part = A[start:start + rows]
    pads = []
    for have, want in zip(reversed(part.shape[1:]), reversed(shape_pad)):
        pads += [0, want - have]
    return torch.nn.functional.pad(part, pads + [0, rows - part.shape[0]])


def tv1_2d_banded(Y, lam, mesh: Mesh, method: str = "chambolle-pock-acc",
                  max_iters: int = 0, k_steps: int = None, tm: int = None,
                  gap_tol=None, W_col=None, W_row=None):
    """ONE image solved by the chunked PDHG of kernel B3 spanning the mesh.

    The image rows are banded over the ranks; each rank runs B3 on its band
    and exchanges 2K-row halos of the four state fields with its neighbours
    before every K-step chunk; the certificate is all-reduced.

    Args:
        Y: (M, N) image (float32 on the card).  lam: scalar penalty (it
            scales ``W_col``/``W_row`` when they are given).
        k_steps/tm: chunk length and band granularity (default
            ``gating.pdhg2d_params``, K shrunk to fit the band; explicit
            values pin the geometry, a K that needs a taller halo than the
            band raises).
        W_col/W_row: optional (M-1, N) / (M, N-1) per-edge weights; use
            :func:`tv1w_2d_banded`.
    Returns:
        (x, info): the (M, N) solution on this rank's device and the
        (1,)-shaped ``SolverInfo``.
    """
    Y = _host(Y)
    gating.refuse_banded_f64("tv1_2d_banded", "pdhg2d", mesh.device, Y.dtype)
    M, N = Y.shape
    # Orientation: with the auto geometry a wide image runs transposed, so
    # that the longer axis is banded.  The exchange moves 2K rows of N per
    # neighbour and the canvas recomputes 4K halo rows of each band, both
    # against M / P core rows, so the taller band costs less; B3's 64 x 128
    # windows tile either orientation alike (the JAX package's rule weighs
    # TPU lanes instead).
    if k_steps is None and tm is None and M < N:
        x_t, info = tv1_2d_banded(
            Y.T, lam, mesh, method=method, max_iters=max_iters,
            gap_tol=gap_tol,
            W_col=None if W_row is None else _host(W_row).T,
            W_row=None if W_col is None else _host(W_col).T)
        return x_t.T, info
    P, r = mesh.size, mesh.rank
    Np = -(-N // 128) * 128
    explicit_k = k_steps is not None
    k_auto, tm_auto = gating.pdhg2d_params()
    k_steps = k_steps or k_auto
    tm = tm or tm_auto
    # Geometry: every rank gets local_rows rows of the padded canvas (the
    # padding after row M is masked invalid); tm shrinks to the fair share.
    share = -(-M // P)
    if tm > share:
        tm = max(8, -(-share // 8) * 8)
    local_rows = -(-share // tm) * tm
    # The exchange refreshes 2K halo rows from ONE neighbour band, so the
    # band must be that tall.
    if 2 * k_steps > local_rows:
        k_fit = max(1, local_rows // 2)
        if explicit_k:
            raise ValueError(
                f"k_steps={k_steps} needs a 2*k_steps={2 * k_steps}-row halo "
                f"but each band has only {local_rows} rows; use k_steps<="
                f"{k_fit} or omit it for auto-tuning")
        k_steps = k_fit
    variant = tv2d._PDHG_VARIANTS[method.lower()]
    cap = int(max_iters) or DEFAULT_COMBINER.max_iters_condat
    r0 = r * local_rows
    Yl = _band(Y, r0, local_rows, (Np,)).to(mesh.device)
    if W_row is not None:
        # lam scales the weight fields: the per-edge penalty is lam * W.
        s = float(lam)
        Wr = _band(_host(W_row).to(Y.dtype) * s, r0, local_rows,
                   (Np,)).to(mesh.device)
        Wc = _band(_host(W_col).to(Y.dtype) * s, r0, local_rows,
                   (Np,)).to(mesh.device)
        x, info = tv2d._run_pdhg_fused_banded(
            Yl, 1.0, Wr, Wc, cap=cap, cfg=DEFAULT_COMBINER, variant=variant,
            mesh=mesh, M=M, N=N, k_steps=k_steps, tm=tm, gap_tol=gap_tol)
    else:
        x, info = tv2d._run_pdhg_fused_banded(
            Yl, lam, cap=cap, cfg=DEFAULT_COMBINER, variant=variant,
            mesh=mesh, M=M, N=N, k_steps=k_steps, tm=tm, gap_tol=gap_tol)
    return comm.all_gather(mesh, x.contiguous())[:M, :N], info


def tv1w_2d_banded(Y, W_col, W_row, mesh: Mesh,
                   method: str = "chambolle-pock-acc", max_iters: int = 0,
                   k_steps: int = None, tm: int = None, gap_tol=None):
    """ONE weighted image spanning the mesh (the weighted counterpart of
    :func:`tv1_2d_banded`): the weight canvases band with the image and
    their halos are exchanged once.

    Args:
        Y: (M, N) image.  W_col: (M-1, N) column-edge weights.
        W_row: (M, N-1) row-edge weights.
    """
    W_col, W_row = _host(W_col), _host(W_row)
    M, N = _host(Y).shape
    if tuple(W_col.shape) != (M - 1, N) or tuple(W_row.shape) != (M, N - 1):
        raise ValueError(f"weight shapes {tuple(W_col.shape)}/"
                         f"{tuple(W_row.shape)} do not match image ({M}, {N})")
    return tv1_2d_banded(Y, 1.0, mesh, method=method, max_iters=max_iters,
                         k_steps=k_steps, tm=tm, gap_tol=gap_tol,
                         W_col=W_col, W_row=W_row)


def tv1_3d_banded(Y, lam, mesh: Mesh, method: str = "chambolle-pock-acc",
                  max_iters: int = 0, k_steps: int = None, tl: int = None,
                  tm: int = None, gap_tol=None):
    """ONE volume solved by the chunked 3D PDHG of kernel B6 spanning the
    mesh: layer-banded along its leading axis, 2K-layer halos of the five
    fields exchanged before every K-step chunk, the certificate
    all-reduced.

    Args:
        Y: (L, M, N) volume (float32 on the card).  lam: scalar penalty on
            all three axes.
        k_steps/tl/tm: chunk length, the band's layer granularity and B6's
            block rows (default ``gating.pdhg3d_params``; K shrinks to fit
            the band unless given).
    Returns:
        (x, info): the (L, M, N) solution and the (1,)-shaped info.
    """
    Y = _host(Y)
    gating.refuse_banded_f64("tv1_3d_banded", "pdhg3d", mesh.device, Y.dtype)
    P = mesh.size
    # Band the longer of L and M: the exchange moves whole cross-sections
    # of the banded axis, so a shallow band is all halo.  One lam on all
    # axes makes the swap free.
    if Y.shape[1] > Y.shape[0] and P > 1:
        x, info = tv1_3d_banded(Y.transpose(0, 1), lam, mesh, method=method,
                                max_iters=max_iters, k_steps=k_steps, tl=tl,
                                tm=tm, gap_tol=gap_tol)
        return x.transpose(0, 1), info
    L, M, N = Y.shape
    explicit_k = k_steps is not None
    k_auto, (tl_auto, tm_auto, tn) = gating.pdhg3d_params()
    k_steps = k_steps or k_auto
    tl = tl or tl_auto
    tm = tm or tm_auto
    share = -(-L // P)
    if tl > share:
        tl = share
    local = -(-share // tl) * tl
    # The exchange refreshes 2K layers from ONE neighbour band, so every
    # band holds at least 2 layers (validity-masked padding).
    local = max(local, 2)
    if 2 * k_steps > local:
        k_fit = max(1, local // 2)
        if explicit_k:
            raise ValueError(
                f"k_steps={k_steps} needs a {2 * k_steps}-layer halo but each "
                f"band has only {local} layers; use k_steps<={k_fit} or omit "
                "it for auto-tuning")
        k_steps = k_fit
    cap = int(max_iters) or DEFAULT_COMBINER.max_iters_condat
    Yl = _band(Y, mesh.rank * local, local, (M, N)).to(mesh.device)
    x, info = tvnd._run_pdhg3d_fused_banded(
        Yl, lam, cap=cap, cfg=DEFAULT_COMBINER,
        variant=tv2d._PDHG_VARIANTS[method.lower()], mesh=mesh, L=L, M=M, N=N,
        k_steps=k_steps, tile=(tl, tm, tn), gap_tol=gap_tol)
    return comm.all_gather(mesh, x.contiguous())[:L], info


def tv1_1d_banded(y, lam, mesh: Mesh, chunk: int = 5120, overlap: int = 640):
    """ONE long 1D TV-L1 signal spanning the mesh: contiguous bands, each
    rank's overlapped windows in one B1 launch after ``overlap``-sample
    halo exchanges, the glued dual's gap all-reduced, and the escalation
    rank-resident (:mod:`proxtv_tpu_torch.ops.tv1d_long_banded`).

    Args:
        y: (n,) signal.  lam: scalar penalty or (n-1,) per-edge weights.
        chunk/overlap: window geometry (as ``tv1d_long.tv1_long``).
    Returns:
        (x, info): the (n,) solution and its (1,)-shaped certificate; rc =
        RC_ITERS only when even the polish fails to certify.
    """
    if not 1 <= overlap < chunk:
        raise ValueError(f"overlap ({overlap}) must be in [1, chunk) "
                         f"(chunk = {chunk})")
    y = _host(y)
    (n,) = y.shape
    P = mesh.size
    Kl = max(1, -(-n // (chunk * P)))
    B_l = Kl * chunk
    if chunk // 2 + overlap > B_l:
        raise ValueError("band too small for the jitter halo: need "
                         f"chunk//2 + overlap <= {B_l}")
    start = mesh.rank * B_l
    yl = _band(y, start, B_l, ()).to(mesh.device)
    lam_t = _host(lam).to(y.dtype)
    if lam_t.ndim >= 1:
        if tuple(lam_t.shape) != (n - 1,):
            raise ValueError(f"per-edge weights must be (n-1,) = ({n - 1},), "
                             f"got {tuple(lam_t.shape)}")
        lam_l = _band(lam_t, start, B_l, ()).to(mesh.device)
    else:
        lam_l = lam_t.to(mesh.device)
    x, gap, iters, rc = tv1d_long_banded.run_banded(
        yl, lam_l, mesh=mesh, n=n, chunk=chunk, overlap=overlap)
    dev = mesh.device
    info = make_info(torch.tensor([iters], device=dev),
                     torch.tensor([gap], dtype=y.dtype, device=dev),
                     torch.tensor([rc], device=dev))
    return comm.all_gather(mesh, x.contiguous())[:n], info


def tv_nd_sharded(Y, ws, ds, ps, mesh: Mesh, max_iters: int = 0,
                  method: str = "pd"):
    """Batched ND generalized TV with the batch split over the mesh."""
    return _batch_sharded(lambda y: tvnd.tv_nd_batched(
        y, tuple(ws), tuple(ds), tuple(ps), max_iters=max_iters,
        method=method), mesh, Y)

