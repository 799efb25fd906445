"""Card-only tests of the port's hand-written CUDA kernels against their
plain PyTorch versions.  They skip without a CUDA card (the kernels have no
CPU mode).  This file imports neither JAX nor the JAX package, so on a
machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from proxtv_tpu_torch.ops.kernels import ms_fused as MSK
from proxtv_tpu_torch.ops.kernels import pcr as PK
from proxtv_tpu_torch.ops.kernels import pdhg3d_fused as P3K
from proxtv_tpu_torch.ops.kernels import pdhg_fused as PPK
from proxtv_tpu_torch.ops.kernels import pn_fused as PPF
from proxtv_tpu_torch.ops.kernels import tautstring as TSK

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["plain", "masked", "shifted"])
def test_pcr_kernel_matches_plain(mode, dev):
    rng = np.random.RandomState(3)
    B, n = 300, 1000
    d = torch.from_numpy((0.01 * rng.randn(B, n)).astype(np.float32))
    mask = torch.from_numpy(rng.rand(B, n) > 0.3)
    sh = torch.from_numpy((rng.rand(B) + 0.5).astype(np.float32))
    kw = {"masked": {"mask": mask}, "shifted": {"diag_shift": sh},
          "plain": {}}[mode]
    ref = PK.pcr_spd_solve_plain(d, **kw).numpy()
    before = PK.LAUNCHES.value
    out = PK.pcr_spd_solve(d.to(dev), **{k: v.to(dev) for k, v in kw.items()})
    torch.cuda.synchronize()
    assert PK.LAUNCHES.value == before + 1
    # (DD')^-1 has condition ~4n^2/pi^2 unmasked: the two roundings may part
    # by ~1e-4 of the solution's size there; the masked/shifted systems are
    # well conditioned.
    rel = 1e-4 if mode == "plain" else 1e-5
    np.testing.assert_allclose(out.cpu().numpy(), ref,
                               atol=rel * max(1.0, float(np.abs(ref).max())))


def _pcr_masks(rng, B, n):
    """Random masks with an all-active run, an all-masked run and masked
    ends in every row; row 0 all active and row 1 all masked where B
    allows."""
    m = rng.rand(B, n) > 0.3
    m[:, n // 8: n // 2] = True
    m[:, n // 2: n // 2 + max(1, n // 8)] = False
    m[:, 0] = m[:, -1] = False
    if B > 1:
        m[0] = True
    if B > 2:
        m[1] = False
    return torch.from_numpy(m)


@pytest.mark.parametrize("B", [1, 5, 300])
@pytest.mark.parametrize("n", [2, 3, 31, 32, 33, 255, 256, 257, 512, 513,
                               999, 1000, 4097, 8192])
def test_pcr_kernel_layouts_match_plain_and_float64(n, B, dev):
    """B2 in all three modes at every edge of its layouts (E elements a
    lane x W warps a row: 4 x 1 to 128, 8 x 1 to 256, 4 x 4 to 512, 4 x 8
    to 1024, ..., 16 x 16 above) and partial blocks of the one-warp layout
    (4 rows a block): against the float32 plain version (PCR) at the bars
    of the main path (1e-3 of the solution's size unmasked and where long
    all-active runs condition the system like the unmasked one, 1e-5
    shifted and masked with short runs, as test_pcr_kernel_matches_plain),
    and against the plain version in float64, where its error is no larger
    than the float32 plain version's on the same input."""
    rng = np.random.RandomState(1000 * n + B)
    d = torch.from_numpy((0.01 * rng.randn(B, n)).astype(np.float32))
    sh = torch.from_numpy((rng.rand(B) + 0.5).astype(np.float32))
    long_runs = _pcr_masks(rng, B, n)
    short = rng.rand(B, n) > 0.3  # runs of ~20 at most, masked ends
    short[:, 0] = short[:, -1] = False
    for mode, kw in (("plain", {}), ("masked", {"mask": long_runs}),
                     ("masked_short", {"mask": torch.from_numpy(short)}),
                     ("shifted", {"diag_shift": sh})):
        ref = PK.pcr_spd_solve_plain(d, **kw)
        ref64 = PK.pcr_spd_solve_plain(
            d.double(), **{k: (v.double() if k == "diag_shift" else v)
                           for k, v in kw.items()})
        out = PK.pcr_spd_solve(d.to(dev), **{k: v.to(dev)
                                             for k, v in kw.items()})
        torch.cuda.synchronize()
        out = out.cpu()
        rel = 1e-3 if mode in ("plain", "masked") else 1e-5
        np.testing.assert_allclose(
            out.numpy(), ref.numpy(),
            atol=rel * max(1.0, float(ref.abs().max())), err_msg=mode)
        err_k = float((out.double() - ref64).abs().max())
        err_p = float((ref.double() - ref64).abs().max())
        assert err_k <= err_p, (mode, err_k, err_p)


def test_pcr_and_lp_bind_launch_what_the_wrappers_do(dev):
    """pcr.bind's and lp_fused.bind's launches (the timing tools' and
    chip_smoke.py's calls of the C entry points) give the wrappers' outputs
    bit for bit and do not count in LAUNCHES."""
    from proxtv_tpu_torch.ops.kernels import lp_fused as LPK

    rng = np.random.RandomState(8)
    d = torch.from_numpy(rng.randn(6, 700).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.rand(6, 700) > 0.2).to(dev)
    ref = PK.pcr_spd_solve(d, mask=mask)
    before = PK.LAUNCHES.value
    out, launch = PK.bind(d, mask=mask)
    launch()
    torch.cuda.synchronize()
    assert PK.LAUNCHES.value == before and torch.equal(out, ref)
    y = d - d.mean(dim=1, keepdim=True)
    args = (y, torch.zeros_like(y), torch.full((6,), 0.7, device=dev),
            torch.ones(6, device=dev), torch.ones(6, device=dev))
    ref = LPK.gpfw_fused(*args, 1.5, 1000)
    before = LPK.LAUNCHES.value
    outs, launch = LPK.bind(*args, 1.5, 1000)
    launch()
    torch.cuda.synchronize()
    assert LPK.LAUNCHES.value == before
    for o, r in zip(outs, ref):
        assert torch.equal(o, r)


def test_kernels_raise_on_unsupported_cuda_input(dev):
    y64 = torch.zeros((4, 16), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        PK.pcr_spd_solve(y64)
    with pytest.raises(ValueError):
        PPF.pn_tv1_fused(y64, lam_scalar=0.5)
    with pytest.raises(ValueError):
        PK.pcr_spd_solve(torch.zeros((4, 9000), device=dev))
    with pytest.raises(ValueError):
        PPF.pn_tv1_fused(torch.zeros((4, 1), device=dev), lam_scalar=0.5)


def _lam_full(W):
    return np.concatenate([W, np.zeros((W.shape[0], 1), W.dtype)], axis=1)


@pytest.mark.parametrize("mode", ["scalar", "lam_full", "warm", "long",
                                  "short_rows", "search_warp",
                                  "search_block"])
def test_pn_kernel_matches_plain(mode, dev, monkeypatch):
    rng = np.random.RandomState(8)
    B, n = {"long": (16, 5000), "short_rows": (4 * 5 + 3, 32),
            "search_warp": (32, 200), "search_block": (16, 300)}.get(
        mode, (64, 1000))
    Y = torch.from_numpy(rng.randn(B, n).astype(np.float32))
    fallbacks = []
    if mode.startswith("search"):
        # Random walks at lam 3: some rows' full Newton step breaks the
        # Armijo test, so the halving search runs (counted on the plain
        # version's tile decisions), in the warp and in the block kernel.
        Y = torch.from_numpy((np.cumsum(rng.randn(B, n), 1) * 0.3
                              + rng.randn(B, n)).astype(np.float32))
        tile_all = PPF._tile_all

        def spy(flag, tb):
            out = tile_all(flag, tb)
            fallbacks.append(int((out < 1.0).sum()))
            return out

        monkeypatch.setattr(PPF, "_tile_all", spy)
    lf = torch.from_numpy(_lam_full((rng.rand(B, n - 1) * 1.2)
                                    .astype(np.float32)))
    if mode == "short_rows":
        # The warp-per-fiber kernel (4 fibers per block) on a batch that is
        # not a multiple of 4: per-row lam, so the rows stop at different
        # iterations; row 0 has zero penalty (identity guard), row 1 a huge
        # one (mean guard: lam >= n^2 max|dy|), both in the first block.
        # Row 1 is scaled down so that lam * (rounding of g) stays under the
        # stop tolerance: at lam 1e6 on O(1) data the gap is float32 noise
        # and the iteration count is chance.
        per = (rng.rand(B) * 1.5).astype(np.float32)
        per[0], per[1] = 0.0, 10.0
        Y[1] *= 1e-3
        lf = torch.from_numpy(_lam_full(np.repeat(per[:, None], n - 1, 1)))
    kw = ({"lam_full": lf} if mode in ("lam_full", "warm", "short_rows")
          else {"lam_scalar": 3.0 if mode.startswith("search") else 0.7})
    if mode == "warm":
        kw["w_init"] = PPF.pn_tv1_fused_plain(Y * 0.9, lf)[1]
    ref, wref, it_ref = PPF.pn_tv1_fused_plain(Y, tb=1, **kw)
    kw = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in kw.items()}
    x, w, iters = PPF.pn_tv1_fused(Y.to(dev), return_iters=True, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(x.cpu().numpy(), ref.numpy(), atol=2e-3)
    np.testing.assert_allclose(w.cpu().numpy(), wref.numpy(), atol=2e-3)
    assert np.abs(iters.cpu().numpy() - it_ref.numpy()).max() <= 2
    if mode.startswith("search"):
        assert sum(fallbacks) > 0
    if mode == "short_rows":
        xs = x.cpu().numpy()
        np.testing.assert_allclose(xs[0], Y[0].numpy(), atol=1e-6)
        np.testing.assert_allclose(xs[1], float(Y[1].mean()), atol=1e-6)
        assert len(set(iters.cpu().numpy().tolist())) > 2


def _canvas_state(rng, Mp, Np, M, N, stride, count, halo):
    f = [rng.randn(Mp, Np).astype(np.float32) for _ in range(5)]
    for a in f[:4]:
        a[:halo] = np.nan
    r = np.arange(Mp)[:, None] - halo
    in_img = (r >= 0) & (r < count * stride) & ((r % stride) < M)
    f[4] = np.where(in_img & (np.arange(Np)[None, :] < N), f[4], 0.0)
    return [torch.from_numpy(a.astype(np.float32)) for a in f]


# case: (mode, K, M, N, count, Np, rows of the canvas past a multiple of the
# kernel's core height, or None for the driver's layout).  At K = 8 the core
# is 46 x 46, so Np = 128 is no multiple of it.
_PDHG_CASES = {
    "cp_cert": ("cp_cert", 8, 100, 90, 2, 128, None),
    "cp": ("cp", 8, 100, 90, 2, 128, None),
    "condat": ("condat", 8, 100, 90, 2, 128, None),
    "weighted_cert": ("weighted_cert", 8, 100, 90, 2, 128, None),
    "k1": ("cp_cert", 1, 100, 90, 2, 128, None),
    "k2": ("condat", 2, 100, 90, 2, 128, None),
    "k14": ("cp_cert", 14, 100, 90, 2, 128, None),
    "k14_weighted": ("weighted_cert", 14, 100, 90, 2, 128, None),
    "core_rows_plus_one": ("cp_cert", 8, 100, 90, 2, 128, 1),
    "image_shorter_than_core": ("cp_cert", 8, 5, 12, 3, 128, None),
    "canvas_9088_wide": ("cp_cert", 8, 40, 9000, 1, 9088, None),
}


@pytest.mark.parametrize("case", list(_PDHG_CASES))
def test_pdhg_kernel_matches_plain(case, dev):
    """B3 against its plain version on the whole canvas (every row, NaN
    padding included): the four fields within 1e-4, the certificate sums
    within 1e-4 relative."""
    mode, k, M, N, count, Np, over = _PDHG_CASES[case]
    rng = np.random.RandomState(4)
    tm = 32
    halo = 2 * k
    stride = M + 8
    tiles = -(-(count * stride) // tm)
    Mp = tiles * tm + 2 * halo
    if over is not None:
        rows, cols = PPK.WINDOW
        core_h = rows - 2 * PPK.window_halo(k)
        Mp = -(-Mp // core_h) * core_h + over
        # The window PPK.WINDOW names is the kernel's: its grid at the
        # largest K is the number of certificate partials.
        from proxtv_tpu_torch.ops.kernels import build
        h = PPK.window_halo(PPK.MAX_STEPS)
        assert build.lib().pdhg_cert_blocks(Mp, Np) == (
            -(-Np // (cols - 2 * h)) * -(-Mp // (rows - 2 * h)))
    t = _canvas_state(rng, Mp, Np, M, N, stride, count, halo)
    sched = torch.from_numpy(PPK.make_schedule(k, 0.4, np.float32(0.6),
                                               np.float32(0.2), "cp-acc"))
    w = [None, None]
    if mode == "weighted_cert":
        w = [torch.from_numpy((0.2 + 0.3 * rng.rand(Mp, Np))
                              .astype(np.float32)) for _ in range(2)]
    kw = dict(k_steps=k, tm=tm, n_valid=N, m_valid=M, stride=stride,
              count=count, pad_top=halo, grad_step=mode == "condat",
              cert=mode.endswith("cert"))
    ref = PPK.pdhg_chunk_plain(sched, *t, wr=w[0], wc=w[1], **kw)
    before = PPK.LAUNCHES.value
    out = PPK.pdhg_chunk(sched.to(dev), *(a.to(dev) for a in t),
                         wr=None if w[0] is None else w[0].to(dev),
                         wc=None if w[1] is None else w[1].to(dev), **kw)
    torch.cuda.synchronize()
    assert PPK.LAUNCHES.value == before + 1
    for a, b in zip(out[:4], ref[:4]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4)
    if kw["cert"]:
        for a, b in zip(out[4:], ref[4:]):
            np.testing.assert_allclose(float(a.sum()), float(b.sum()),
                                       rtol=1e-4)


@pytest.mark.parametrize("n", [2, 3, 32, 33, 64, 65, 128, 129, 256, 257,
                               1024, 1025, 2049, 8192])
def test_kernels_across_the_lane_range(n, dev):
    """PN and PCR at the edges of 2..8192 and at every edge of PN's template
    instances (one warp per fiber up to 32, 64, 128 and 256; one block per
    fiber up to 1024, 2048 and 8192)."""
    rng = np.random.RandomState(n)
    B = 8
    Y = torch.from_numpy(rng.randn(B, n).astype(np.float32))
    ref, wref, _ = PPF.pn_tv1_fused_plain(Y, lam_scalar=0.5)
    x, w = PPF.pn_tv1_fused(Y.to(dev), lam_scalar=0.5)
    torch.cuda.synchronize()
    np.testing.assert_allclose(x.cpu().numpy(), ref.numpy(), atol=2e-3)
    np.testing.assert_allclose(w.cpu().numpy(), wref.numpy(), atol=2e-3)
    d = torch.from_numpy((0.01 * rng.randn(B, n)).astype(np.float32))
    mask = torch.from_numpy(rng.rand(B, n) > 0.3)
    for kw in ({}, {"mask": mask}):
        ref = PK.pcr_spd_solve_plain(d, **kw).numpy()
        out = PK.pcr_spd_solve(d.to(dev), **{k: v.to(dev)
                                             for k, v in kw.items()})
        torch.cuda.synchronize()
        np.testing.assert_allclose(
            out.cpu().numpy(), ref,
            atol=1e-3 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("method", ["dr", "pd", "yang", "kolmogorov",
                                    "condat", "chambolle-pock",
                                    "chambolle-pock-acc"])
def test_tv1_2d_batched_on_card_matches_cpu_float64(method, dev):
    """Every method through the card's kernels (B = 2: the PDHG solver's
    multi-image certificate) against the float64 CPU composition, at the
    cross-method bar of tests/test_tv2d.py (1e-3)."""
    from proxtv_tpu_torch.models import tv2d
    from proxtv_tpu_torch.ops.kernels import pn_fused

    rng = np.random.RandomState(11)
    Y = rng.randn(2, 40, 36)
    cap = 1000 if method in ("dr", "pd", "yang") else 2500
    ref, _ = tv2d.tv1_2d_batched(torch.from_numpy(Y), 0.35, method="pd",
                                 max_iters=1000)
    b1, b3 = pn_fused.LAUNCHES.value, PPK.LAUNCHES.value
    x, info = tv2d.tv1_2d_batched(torch.from_numpy(Y).float().to(dev), 0.35,
                                  method=method, max_iters=cap)
    torch.cuda.synchronize()
    if method in ("condat", "chambolle-pock", "chambolle-pock-acc"):
        assert PPK.LAUNCHES.value > b3
    else:
        assert pn_fused.LAUNCHES.value > b1
    np.testing.assert_allclose(x.cpu().double().numpy(), ref.numpy(),
                               atol=1e-3)


@pytest.mark.parametrize("case", ["tv1_batched_f64", "tv1_pn_f64",
                                  "tv2d_dr_f64", "tv2d_cp_acc_f64",
                                  "tv2d_dr_n1", "pcr_mask_and_shift",
                                  "pcr_thomas", "switch_off"])
def test_call_sites_raise_instead_of_running_plain_on_the_card(case, dev):
    """Every call site that holds a kernel launches it for a CUDA tensor or
    raises; none runs the plain composition on the card."""
    from proxtv_tpu_torch.models import tv2d
    from proxtv_tpu_torch.ops import tridiag, tv1d_l1
    from proxtv_tpu_torch.ops.kernels import gating

    y64 = torch.randn((4, 32), dtype=torch.float64, device=dev)
    y32 = y64.float()
    mask = torch.ones((4, 32), dtype=torch.bool, device=dev)
    calls = {
        "tv1_batched_f64": lambda: tv1d_l1.tv1_batched(y64, 0.5, method="pn"),
        "tv1_pn_f64": lambda: tv1d_l1.tv1_pn(y64, 0.5),
        "tv2d_dr_f64": lambda: tv2d.tv1_2d_batched(y64[None], 0.5),
        "tv2d_cp_acc_f64": lambda: tv2d.tv1_2d_batched(
            y64[None], 0.5, method="chambolle-pock-acc"),
        "tv2d_dr_n1": lambda: tv2d.tv1_2d_batched(y32[None, :, :1], 0.5),
        "pcr_mask_and_shift": lambda: tridiag.spd_second_difference_solve(
            y32, diag_shift=0.5, mask=mask),
        "pcr_thomas": lambda: tridiag.spd_second_difference_solve(
            y32, method="thomas"),
    }
    if case == "switch_off":
        with gating.fused_ctx(False), pytest.raises(RuntimeError):
            tv1d_l1.tv1_batched(y32, 0.5, method="pn")
        return
    with pytest.raises(ValueError):
        calls[case]()


def _obj2d(X, Y, lam):
    return (0.5 * np.sum((X - Y) ** 2)
            + lam * (np.abs(np.diff(X, axis=0)).sum()
                     + np.abs(np.diff(X, axis=1)).sum()))


@pytest.mark.parametrize("case", ["tv1_1d_pn", "tv1_1d_auto", "tv1_batched",
                                  "dr_sweep", "tv1_2d_auto"])
def test_past_the_tpu_lane_limits_matches_cpu_float64(case, dev, monkeypatch):
    """Lengths past the TPU's 8192 lanes take the JAX package's route on the
    card instead of raising: tv1_pn's tridiagonal solves run the PCR
    composition past B2's limit, fibers past B1's run tv1_pn (method "pn")
    or the taut string, kernel D1 (tv1_1d auto, which returns info and so
    takes the device route), and B3 takes any width.  Each call is held
    against the same call in float64 on the CPU: 2e-3 on 1D TV-L1 outputs; tv1_2d auto by the certified-gap rule of
    chip_smoke.py against float64 chambolle-pock-acc, and its first chunk
    against B3's plain version (1e-4).  tv1_1d pn at n = 10000 misses 2e-3
    against float64 by the reference's own float32 stop floor (ROADMAP C:
    2 eps 0.5||y||^2 = 0.57 here; the JAX package's float32 tv1_pn parts
    from float64 by the same 1.097e-2): it is held by the certified-gap
    rule against float64, and within 2e-3 of the JAX package's float32
    tv1_pn on the same input (``tests/data``, kept true by
    test_torch_pn.py)."""
    from proxtv_tpu_torch import api
    from proxtv_tpu_torch.models import tv2d
    from proxtv_tpu_torch.ops import tv1d_l1

    rng = np.random.RandomState(21)
    b1, b2 = PPF.LAUNCHES.value, PK.LAUNCHES.value
    if case == "tv1_1d_auto":
        # auto with return_info takes the device route: past B1's lane
        # limit the taut string, kernel D1 (exact; held against float64).
        y = np.cumsum(rng.randn(10000)) * 0.3 + rng.randn(10000)
        ts = TSK.LAUNCHES.value
        x, info = api.tv1_1d(y, 2.0, return_info=True)
        ref = api.tv1_1d(y, 2.0, backend="cuda", device="cpu")
        assert TSK.LAUNCHES.value == ts + 1 and PPF.LAUNCHES.value == b1
        assert int(info.rc[0]) == 0
        np.testing.assert_allclose(x, ref, atol=2e-3)
        return
    if case == "tv1_1d_pn":
        y = np.cumsum(rng.randn(10000)) * 0.3 + rng.randn(10000)
        method = "pn"
        x, info = api.tv1_1d(y, 2.0, method=method, return_info=True)
        ref, info_ref = api.tv1_1d(y, 2.0, method=method, return_info=True,
                                   device="cpu")
        assert PK.LAUNCHES.value == b2  # n - 1 > 8192: the composition
        assert int(info.rc[0]) in (0, int(info_ref.rc[0]))
        xj = np.load(os.path.join(os.path.dirname(__file__), "data",
                                  "tv1_pn_float32_walk21.npy"))
        np.testing.assert_allclose(x, xj, atol=2e-3)

        def F(v):
            v = v.astype(np.float64)
            return 0.5 * np.sum((v - y) ** 2) + 2.0 * np.abs(np.diff(v)).sum()

        assert F(x) - F(ref) <= (float(info.gap[0]) + float(info_ref.gap[0])
                                 + 1e-6 * F(ref))
        return
    if case == "tv1_batched":
        Y = rng.randn(4, 10000)
        x = tv1d_l1.tv1_batched(torch.from_numpy(Y).float().to(dev), 0.7,
                                method="pn")
        ref = tv1d_l1.tv1_batched(torch.from_numpy(Y), 0.7, method="pn")
        assert PPF.LAUNCHES.value == b1  # n > 8192: tv1_pn, not B1
        np.testing.assert_allclose(x.cpu().double().numpy(), ref.numpy(),
                                   atol=2e-3)
        return
    if case == "dr_sweep":
        Y = rng.randn(1, 16, 9000)
        x, _ = tv2d.tv1_2d_batched(torch.from_numpy(Y).float().to(dev), 0.3,
                                   method="dr", max_iters=1)
        ref, _ = tv2d.tv1_2d_batched(torch.from_numpy(Y), 0.3, method="dr",
                                     max_iters=1)
        assert PPF.LAUNCHES.value > b1  # the 16-long columns run B1
        np.testing.assert_allclose(x.cpu().double().numpy(), ref.numpy(),
                                   atol=2e-3)
        return
    Y = rng.randn(64, 9000)
    seen = []
    chunk = PPK.pdhg_chunk

    def tap(*a, **kw):
        if not seen:
            seen.append(([v.clone() if torch.is_tensor(v) else v for v in a],
                         {k_: (v.clone() if torch.is_tensor(v) else v)
                          for k_, v in kw.items()}))
        return chunk(*a, **kw)

    monkeypatch.setattr(PPK, "pdhg_chunk", tap)
    x, info = api.tv1_2d(Y, 0.3, return_info=True)
    monkeypatch.setattr(PPK, "pdhg_chunk", chunk)
    a, kw = seen[0]
    out = PPK.pdhg_chunk(*a, **kw)
    ref = PPK.pdhg_chunk(*(v.cpu() if torch.is_tensor(v) else v for v in a),
                         **{k_: (v.cpu() if torch.is_tensor(v) else v)
                            for k_, v in kw.items()})  # the plain version
    torch.cuda.synchronize()
    for o, r in zip(out[:4], ref[:4]):
        np.testing.assert_allclose(o.cpu().numpy(), r.numpy(), atol=1e-4)
    xr, ir = api.tv1_2d(Y, 0.3, method="chambolle-pock-acc",
                        return_info=True, device="cpu")
    assert int(info.rc[0]) == 0 and int(ir.rc[0]) == 0
    F, F_ref = _obj2d(x.astype(np.float64), Y, 0.3), _obj2d(xr, Y, 0.3)
    assert F - F_ref <= float(info.gap[0]) + float(ir.gap[0]) + 1e-6 * F_ref


def test_small_image_runs_the_pdhg_kernel(dev):
    """An image shorter than a PDHG tile (M = 5) still takes kernel B3."""
    from proxtv_tpu_torch.models import tv2d

    rng = np.random.RandomState(12)
    Y = rng.randn(1, 5, 12)
    ref, _ = tv2d.tv1_2d_batched(torch.from_numpy(Y), 0.35, method="pd",
                                 max_iters=1000)
    b3 = PPK.LAUNCHES.value
    x, info = tv2d.tv1_2d_batched(torch.from_numpy(Y).float().to(dev), 0.35,
                                  method="chambolle-pock-acc", max_iters=2500)
    torch.cuda.synchronize()
    assert PPK.LAUNCHES.value > b3
    np.testing.assert_allclose(x.cpu().double().numpy(), ref.numpy(),
                               atol=1e-3)


def _ms_inputs(rng, mode, B, n):
    Y = torch.from_numpy(rng.randn(B, n).astype(np.float32))
    kw = {"lam": 1.0}
    if mode in ("rows", "warm"):
        lams = np.resize(np.array([0.0, 0.4, 1.0, 2.0, 50.0, 1e6],
                                  np.float32), B)
        kw = {"lam_rows": torch.from_numpy(lams)}
    if mode == "warm":
        kw["alpha_init"] = MSK.ms_tv2_fused_plain(Y * 0.9, **kw)[1]
    if mode == "warm_image":  # the tvp_2d p = 2 fiber pass at lam 0.3
        kw = {"lam": 0.3, "alpha_init": MSK.ms_tv2_fused_plain(Y, 0.3)[1]}
        Y = Y + torch.from_numpy(0.05 * rng.randn(B, n).astype(np.float32))
    return Y, kw


@pytest.mark.parametrize("mode,B,n", [
    ("scalar", 64, 1000), ("rows", 64, 1000), ("warm", 64, 1000),
    ("scalar", 8, 2), ("scalar", 8, 3), ("rows", 12, 129), ("warm", 8, 1025),
    ("scalar", 8, 2049), ("rows", 6, 8192),
    # every edge of the kernel's layouts (E elements a lane, W warps a
    # fiber: 4 x 1 to 128, 8 x 1 to 256, 8 x 2 to 512, 8 x 4 to 1024,
    # 8 x 8 to 2048, 8 x 16 to 4096, 16 x 16 above), partial blocks of the
    # one-warp layout (4 fibers a block), one fiber, the 1024^2 warm pass
    ("rows", 5, 32), ("scalar", 7, 33), ("warm", 6, 128), ("scalar", 9, 256),
    ("rows", 6, 257), ("warm", 6, 512), ("scalar", 6, 513),
    ("rows", 6, 1024), ("scalar", 1, 1000), ("warm", 4, 2048),
    ("rows", 4, 4096), ("scalar", 4, 4097), ("warm_image", 6, 1024)])
def test_ms_kernel_matches_plain(mode, B, n, dev):
    """B4 against its plain version (tb = 1), across every layout edge:
    x to 1e-4 in data units, alpha to 1e-4 relative, iteration counts at
    most one apart (the stop test can sit at rounding noise)."""
    rng = np.random.RandomState(n)
    Y, kw = _ms_inputs(rng, mode, B, n)
    ref, a_ref, g_ref, it_ref = MSK.ms_tv2_fused_plain(Y, tb=1, **kw)
    before = MSK.LAUNCHES.value
    x, a, g, it = MSK.ms_tv2_fused(
        Y.to(dev), **{k: (v.to(dev) if torch.is_tensor(v) else v)
                      for k, v in kw.items()})
    torch.cuda.synchronize()
    assert MSK.LAUNCHES.value == before + 1
    np.testing.assert_allclose(x.cpu().numpy(), ref.numpy(), atol=1e-4)
    np.testing.assert_allclose(a.cpu().numpy(), a_ref.numpy(), rtol=1e-4,
                               atol=1e-6)
    it_k, it_p = it.cpu().numpy(), it_ref.numpy().copy()
    # Where the float32 plain version runs to the cap, its stop test sits at
    # rounding noise (its PCR at a small alpha: lam = 50 rows at n = 129 and
    # 257); there the counts are held against the plain version in float64,
    # the same algorithm without that noise, and so is the solution: x
    # within the same 1e-4 and the objective within both certified gaps
    # (ROADMAP C).
    noisy = it_p >= 100
    if noisy.any():
        sel = torch.from_numpy(noisy)
        kw64 = {k: (v[sel].double() if torch.is_tensor(v) else v)
                for k, v in kw.items()}
        y64 = Y[sel].double()
        x64, _, g64, it64 = MSK.ms_tv2_fused_plain(y64, tb=1, **kw64)
        it_p[noisy] = it64.numpy()
        xk = x.cpu()[sel].double()
        np.testing.assert_allclose(xk.numpy(), x64.numpy(), atol=1e-4)
        lam = kw64["lam_rows"] if "lam_rows" in kw64 else kw64["lam"]

        def obj(z):
            return (0.5 * ((z - y64) ** 2).sum(1)
                    + lam * torch.linalg.vector_norm(z.diff(dim=1), dim=1))

        bar = g.cpu()[sel].double() + g64 + 1e-6 * obj(x64)
        assert bool((obj(xk) - obj(x64) <= bar).all())
    assert np.abs(it_k - it_p).max() <= 1
    assert np.all(g.cpu().numpy() >= 0)


@pytest.mark.parametrize("mode", ["scalar", "warm"])
def test_ms_bind_launches_what_the_wrapper_does(mode, dev):
    """ms_fused.bind's launch (the timing tools' call of the C entry point)
    gives the wrapper's outputs bit for bit, on a column pass's .T view as
    tvp_2d gives it, and does not count in LAUNCHES."""
    rng = np.random.RandomState(7)
    Y, kw = _ms_inputs(rng, mode, 48, 300)
    kw = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in kw.items()}
    yT = Y.T.contiguous().to(dev).T  # (48, 300) with column strides
    ref = MSK.ms_tv2_fused(yT, **kw)
    before = MSK.LAUNCHES.value
    outs, launch = MSK.bind(yT, **kw)
    launch()
    launch()
    torch.cuda.synchronize()
    assert MSK.LAUNCHES.value == before
    for o, r in zip(outs, ref):
        assert torch.equal(o, r)


def test_bind_launch_keeps_its_outputs_alive(dev):
    """A launch made by bind writes into the outputs bind allocated, so it
    keeps them alive after the caller drops them: the caching allocator
    must not hand their memory to a new tensor while the launch can still
    write it (B2, B4 and B5; the timing replays drop the outputs)."""
    from proxtv_tpu_torch.ops.kernels import lp_fused as LPK

    rng = np.random.RandomState(9)
    y = torch.from_numpy(rng.randn(8, 300).astype(np.float32)).to(dev)
    ones = torch.ones(8, device=dev)
    for make in (lambda: PK.bind(y),
                 lambda: MSK.bind(y, lam=1.0),
                 lambda: LPK.bind(y, torch.zeros_like(y), ones, ones, ones,
                                  1.5, 100)):
        outs, launch = make()
        held = {t.data_ptr() for t in (outs if isinstance(outs, tuple)
                                       else (outs,))}
        del outs
        fresh = [torch.empty_like(y) for _ in range(8)]
        fresh += [torch.empty(8, device=dev) for _ in range(8)]
        assert held.isdisjoint(t.data_ptr() for t in fresh)
        launch()
        torch.cuda.synchronize()


def _canvas3(rng, Lp, Mp, N, hl):
    f = [rng.randn(Lp, Mp, N).astype(np.float32) for _ in range(6)]
    for a in f[:5]:
        a[:hl] = np.nan  # garbage the kernel must keep out of the volumes
    return [torch.from_numpy(a) for a in f]


@pytest.mark.parametrize("variant,k,tile", [
    ("cp", None, None), ("cp-acc", None, None), ("condat", None, None),
    ("cp-acc", 2, (3, 5, 7)), ("cp", 1, (2, 3, 5)), ("condat", 3, (5, 4, 7)),
    ("cp-acc", 4, (7, 6, 5)), ("cp", 6, (4, 4, 4)), ("cp-acc", 8, (5, 2, 2))])
def test_pdhg3d_kernel_matches_plain(variant, k, tile, dev):
    """B6 against its plain version on a padded canvas of two stacked
    volumes (gap layers, M offset, NaN in the leading layers): every cell,
    NaN where the plain version has NaN.  Every step count the kernel is
    built for; ``tile`` is (L segment, M core, N core).  Lp = 36 and
    Mp = 18, N = 37 are multiples of no segment or core, and the segment
    boundaries fall inside the volumes, where the K layers under a segment
    carry valid L edges."""
    rng = np.random.RandomState(5)
    L, M, N, count = 12, 11, 37, 2
    k = k or P3K.pdhg3d_params()[0]
    stride, hl, hm = L + 2, 4, 3
    Lp, Mp = count * stride + 2 * hl, M + 2 * hm + 1
    t = _canvas3(rng, Lp, Mp, N, hl)
    sched = torch.from_numpy(P3K.make_schedule3(
        k, (0.3, 0.4, 0.35), np.float32(0.6), np.float32(0.1), variant, 4.0))
    kw = dict(k_steps=k, n_valid=N - 2, m_valid=M, l_valid=L, stride=stride,
              count=count, pad_top=hl, pad_m=hm,
              grad_step=variant == "condat")
    ref = P3K.pdhg3d_chunk_plain(sched, *t, **kw)
    before = P3K.LAUNCHES.value
    out = P3K.pdhg3d_chunk(sched.to(dev), *(a.to(dev) for a in t), tile=tile,
                           **kw)
    torch.cuda.synchronize()
    assert P3K.LAUNCHES.value == before + 1
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-5)


@pytest.mark.parametrize("k,tile", [(5, (4, 4, 4)), (2, (4, 32, 32))])
def test_pdhg3d_c_entry_rejects_what_it_cannot_launch(k, tile, dev):
    """The step counts and the thread cap per K live in the C entry point
    alone: K = 5 is not built, and a 32 x 32 core at K = 2 needs 1296
    threads.  It reports an invalid argument, the wrapper raises, and
    nothing is launched or counted."""
    f = [torch.zeros((8, 8, 8), device=dev) for _ in range(6)]
    sched = torch.zeros((k, 6), device=dev)
    before = P3K.LAUNCHES.value
    with pytest.raises(RuntimeError, match="pdhg3d_chunk"):
        P3K.pdhg3d_chunk(sched, *f, k_steps=k, n_valid=8, m_valid=8,
                         l_valid=8, stride=8, count=1, tile=tile)
    assert P3K.LAUNCHES.value == before


def test_tv2_and_tvnd_on_card_match_cpu_float64(dev):
    """The new call sites through their kernels against the float64 CPU
    compositions: tv2_ms (B4), the spectral path (n > 8192, no kernel),
    tvp_2d_batched with p = 2 (warm-started B4) and the 3D cp-acc engine
    (B6) against Parallel Dykstra, at the JAX tests' bars."""
    from proxtv_tpu_torch.models import tv2d, tvnd
    from proxtv_tpu_torch.ops import tv1d_l2

    rng = np.random.RandomState(13)
    Y = rng.randn(16, 300)
    lams = torch.from_numpy(np.resize([0.0, 0.7, 3.0, 1e4], 16))
    ref, _ = tv1d_l2.tv2_ms(torch.from_numpy(Y), lams)
    b4 = MSK.LAUNCHES.value
    x, info = tv1d_l2.tv2_ms(torch.from_numpy(Y).float().to(dev),
                             lams.float().to(dev))
    assert MSK.LAUNCHES.value == b4 + 1
    np.testing.assert_allclose(x.cpu().double().numpy(), ref.numpy(),
                               atol=2e-3)
    ylong = np.cumsum(rng.randn(1, 12289)) * 0.05 + rng.randn(1, 12289)
    ref, _ = tv1d_l2.tv2_ms(torch.from_numpy(ylong), 8.0)
    x, info = tv1d_l2.tv2_ms(torch.from_numpy(ylong).float().to(dev), 8.0)
    assert int(info.rc[0]) == 0
    np.testing.assert_allclose(x.cpu().double().numpy(), ref.numpy(),
                               atol=2e-3)
    X = rng.randn(1, 20, 24)
    ref, _ = tv2d.tvp_2d_batched(torch.from_numpy(X), 0.4, 0.3, 2.0, 2.0,
                                 max_iters=300)
    b4 = MSK.LAUNCHES.value
    x, _ = tv2d.tvp_2d_batched(torch.from_numpy(X).float().to(dev), 0.4, 0.3,
                               2.0, 2.0, max_iters=300)
    assert MSK.LAUNCHES.value > b4
    np.testing.assert_allclose(x.cpu().double().numpy(), ref.numpy(),
                               atol=2e-3)
    V = rng.randn(1, 4, 10, 9)
    ref, _ = tvnd.tv_nd_batched(torch.from_numpy(V), (0.3,) * 3, (1, 2, 3),
                                (1.0,) * 3, max_iters=600, method="pd")
    b6 = P3K.LAUNCHES.value
    x, info = tvnd.tv_nd_batched(torch.from_numpy(V).float().to(dev),
                                 (0.3,) * 3, (1, 2, 3), (1.0,) * 3,
                                 method="chambolle-pock-acc")
    assert P3K.LAUNCHES.value > b6 and int(info.rc[0]) == 0
    np.testing.assert_allclose(x.cpu().double().numpy(), ref.numpy(),
                               atol=2e-3)


@pytest.mark.parametrize("case", ["tv2_ms_f64", "tv2_mspg_f64", "tvnd_cp_f64",
                                  "tvnd_wide_n", "ms_n1"])
def test_new_call_sites_raise_on_the_card(case, dev):
    """B4's and B6's call sites launch their kernel for a CUDA tensor or
    raise; none runs the plain composition on the card."""
    from proxtv_tpu_torch.models import tvnd
    from proxtv_tpu_torch.ops import tv1d_l2

    y64 = torch.randn((4, 32), dtype=torch.float64, device=dev)
    calls = {
        "tv2_ms_f64": lambda: tv1d_l2.tv2_ms(y64, 0.5),
        "tv2_mspg_f64": lambda: tv1d_l2.tv2_mspg(y64, 0.5),
        "tvnd_cp_f64": lambda: tvnd.tv_nd_batched(
            torch.randn((1, 3, 4, 5), dtype=torch.float64, device=dev),
            (0.3,) * 3, (1, 2, 3), (1.0,) * 3, method="chambolle-pock-acc"),
        "tvnd_wide_n": lambda: tvnd.tv_nd_batched(
            torch.randn((1, 2, 3, 2049), device=dev), (0.3,) * 3, (1, 2, 3),
            (1.0,) * 3, method="chambolle-pock-acc"),
        "ms_n1": lambda: tv1d_l2.tv2_ms(y64[:, :1].float(), 0.5),
    }
    with pytest.raises(ValueError):
        calls[case]()


def _lp_obj(x, y, lam, p):
    """Primal TV-Lp objective per row, in float64."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    g = np.abs(np.diff(x, axis=1))
    return (0.5 * np.sum((x - y) ** 2, axis=1)
            + np.asarray(lam) * np.sum(g ** p, axis=1) ** (1.0 / p))


@pytest.mark.parametrize("p,B,n", [
    (1.5, 64, 1000), (3.0, 64, 1000), (5.0, 64, 1000), (1.5, 8, 2),
    (3.0, 8, 3), (5.0, 12, 129), (1.5, 16, 300), (3.0, 8, 1025),
    (1.5, 6, 2049), (5.0, 4, 8192),
    # every edge of the kernel's layouts (E elements a lane x W warps a
    # fiber: 4 x 1 to 128, 8 x 1 to 256; a batch in one wave (B <= 528,
    # 264, 132 on an H100) 4 x 4 to 512, 4 x 8 to 1024, 4 x 16 to 2048;
    # larger batches 8 x 2, 8 x 4, 8 x 8; then 8 x 16 to 4096, 16 x 16
    # above), each layout with all three p, partial blocks of the one-warp
    # layout (4 fibers a block)
    (1.5, 5, 32), (3.0, 7, 33), (5.0, 6, 128), (1.5, 5, 200),
    (3.0, 9, 256), (1.5, 6, 257), (3.0, 6, 400), (5.0, 6, 512),
    (3.0, 6, 513), (1.5, 6, 1024), (1.5, 4, 1500), (5.0, 4, 2048),
    (1.5, 528, 257), (3.0, 529, 512), (5.0, 265, 513), (1.5, 265, 1024),
    (3.0, 136, 1025), (5.0, 133, 2048),
    (3.0, 4, 4096), (5.0, 4, 3000), (1.5, 3, 4097), (3.0, 3, 6000)])
def test_lp_kernel_matches_plain(p, B, n, dev):
    """B5 against its plain version (tb = 1) across every template instance
    and warp boundary and both Newton branches (q >= 2 for p = 1.5, the
    u-substitution for p = 3, 5), with per-row lam, a frozen row and a warm
    multiplier: the primal x = y + D'w within 5e-3 and its objective within
    rtol 1e-5 (the bars of tests/test_kernels.py:366-368; float32 line
    searches part the iterates at ~1e-3, in directions the objective barely
    sees), the frozen row bitwise unchanged."""
    from proxtv_tpu_torch.ops.kernels import lp_fused as LPK

    rng = np.random.RandomState(n)
    y = rng.randn(B, n).astype(np.float32)
    y -= y.mean(axis=1, keepdims=True)
    lam = np.resize(np.array([0.7, 0.3, 1.0, 2.0], np.float32), B)
    run = np.ones(B, np.float32)
    run[1] = 0.0
    w0 = np.zeros((B, n), np.float32)
    w0[1, :-1] = rng.rand(n - 1).astype(np.float32) * 0.01
    mu0 = np.resize(np.array([1.0, 0.5], np.float32), B)
    args = [torch.from_numpy(a) for a in (y, w0, lam, mu0, run)]
    w_r, mu_r, g_r, it_r = LPK.gpfw_fused_plain(*args, p, 100000, tb=1)
    before = LPK.LAUNCHES.value
    w, mu, g, it = LPK.gpfw_fused(*[a.to(dev) for a in args], p, 100000)
    torch.cuda.synchronize()
    assert LPK.LAUNCHES.value == before + 1
    w, g, it = w.cpu().numpy(), g.cpu().numpy(), it.cpu().numpy()

    def primal(wk):
        return y + np.diff(np.concatenate([np.zeros((B, 1)), wk], 1), axis=1)

    x, x_r = primal(w), primal(w_r.numpy())
    np.testing.assert_allclose(x, x_r, atol=5e-3)
    np.testing.assert_allclose(_lp_obj(x, y, lam, p), _lp_obj(x_r, y, lam, p),
                               rtol=1e-5, atol=1e-4)
    assert np.array_equal(w[1], w0[1]) and it[1] == 0.0
    assert np.all(np.isfinite(w)) and np.all(g >= 0)
    assert np.all(it[run > 0] == np.floor(it[run > 0]))  # none at the cap


@pytest.mark.parametrize("B,n", [(32, 1000), (5, 2), (7, 128), (6, 129),
                                 (6, 256), (6, 257), (6, 512), (6, 513),
                                 (4, 1024), (4, 1025), (4, 2048), (4, 2049),
                                 (529, 257), (265, 513), (265, 1000),
                                 (133, 2048),
                                 (3, 4096), (3, 4097), (3, 8192)])
def test_lp_kernel_fixed_trips_match_plain(B, n, dev):
    """Three trips on both sides (max_iters = 30) from a cold start on
    random walks at lam 2 (p = 1.5 does not converge in three trips), the
    kernel held against its plain version by ``lp_fused.fixed_trips_agree``.
    At 32 x 1000 every row's dual objective 0.5 ||D'w||^2 + y'D'w is within
    1e-6 relative (float32 line searches part the iterates, not the
    objective: float32 against float64 of the plain version parts it by
    1.2e-7).  At both edges of every other layout of the kernel, where on
    some rows any float32 run, the plain version's too, is further than
    1e-6 from the float64 run (the plain version up to 6.8e-6 at 529 x 257,
    p = 1.5), a row that ran the same trips is within 1e-6 of the plain
    version or no further from the float64 run than the float32 plain
    version's largest error on the batch; a row whose gap
    lands at the stop tolerance after a trip may stop on one side and run on
    on the other: the side that stopped did so by its stop test, the other
    ran one trip more or stopped by its test too, and the row's x and
    objective are held at test_lp_kernel_matches_plain's bars."""
    from proxtv_tpu_torch.ops.kernels import lp_fused as LPK

    rng = np.random.RandomState(21)
    y = (np.cumsum(rng.randn(B, n), axis=1) * 0.3).astype(np.float32)
    y -= y.mean(axis=1, keepdims=True)
    args = [torch.from_numpy(a) for a in (
        y, np.zeros((B, n), np.float32), np.full(B, 2.0, np.float32),
        np.ones(B, np.float32), np.ones(B, np.float32))]
    strict = (B, n) == (32, 1000)
    for p in (1.5, 3.0, 5.0):
        w_r, _, _, it_r = LPK.gpfw_fused_plain(*args, p, 30, tb=1)
        ref64 = None if strict else LPK.gpfw_fused_plain(
            *[a.double() for a in args], p, 30, tb=1)[::3]
        w, _, _, it = LPK.gpfw_fused(*[a.to(dev) for a in args], p, 30)
        torch.cuda.synchronize()
        ok, nums = LPK.fixed_trips_agree(args[0], args[2], p, w, it, w_r,
                                         it_r, ref64=ref64)
        assert ok, (p, nums)
        assert int(it.max()) <= 30 and int(it_r.max()) <= 30


def test_tvp_paths_on_card_match_cpu_float64(dev):
    """The TV-Lp call sites on the card against the float64 CPU
    compositions at the JAX tests' bar (5e-3 on x): tvp_batched gpfw
    (one B5 launch), the 2D dr with warm-started B5 fiber passes, p outside
    B5's gate (the torch composition, B2 for its setup solve) and a signal
    longer than 8192 (the PCR composition for the setup solve, no kernel)."""
    from proxtv_tpu_torch.models import tv2d
    from proxtv_tpu_torch.ops import tv1d_lp
    from proxtv_tpu_torch.ops.kernels import lp_fused as LPK
    from proxtv_tpu_torch.ops.kernels import pcr as PCRK

    rng = np.random.RandomState(22)
    Y = rng.randn(16, 300)
    for p in (1.5, 3.0, 5.0):
        ref, _ = tv1d_lp.tvp_batched(torch.from_numpy(Y), 0.7, p)
        b5 = LPK.LAUNCHES.value
        x, info = tv1d_lp.tvp_batched(torch.from_numpy(Y).float().to(dev),
                                      0.7, p)
        assert LPK.LAUNCHES.value == b5 + 1
        assert np.all(info.rc.cpu().numpy() == 0)
        np.testing.assert_allclose(x.cpu().double().numpy(), ref.numpy(),
                                   atol=5e-3)
    for p in (1.25,):  # q outside [1.12, 3.1]: the composition
        ref, _ = tv1d_lp.tvp_batched(torch.from_numpy(Y[:4]), 0.7, p)
        b5, b2 = LPK.LAUNCHES.value, PCRK.LAUNCHES.value
        x, _ = tv1d_lp.tvp_batched(torch.from_numpy(Y[:4]).float().to(dev),
                                   0.7, p)
        assert LPK.LAUNCHES.value == b5 and PCRK.LAUNCHES.value == b2 + 1
        np.testing.assert_allclose(x.cpu().double().numpy(), ref.numpy(),
                                   atol=5e-3)
    X = rng.randn(1, 24, 20)
    ref, _ = tv2d.tvp_2d_batched(torch.from_numpy(X), 0.4, 0.3, 1.5, 3.0,
                                 max_iters=100)
    b5 = LPK.LAUNCHES.value
    x, _ = tv2d.tvp_2d_batched(torch.from_numpy(X).float().to(dev), 0.4, 0.3,
                               1.5, 3.0, max_iters=100)
    assert LPK.LAUNCHES.value > b5
    np.testing.assert_allclose(x.cpu().double().numpy(), ref.numpy(),
                               atol=5e-3)
    ylong = np.cumsum(rng.randn(1, 9000), axis=1) * 0.05 + rng.randn(1, 9000)
    ref, _ = tv1d_lp.tvp_gpfw(torch.from_numpy(ylong), 5.0, 1.5)
    x, info = tv1d_lp.tvp_gpfw(torch.from_numpy(ylong).float().to(dev), 5.0,
                               1.5)
    assert int(info.rc[0]) == 0
    np.testing.assert_allclose(x.cpu().double().numpy(), ref.numpy(),
                               atol=5e-3)


@pytest.mark.parametrize("case", ["gpfw_f64", "fw_f64", "switch_off"])
def test_lp_call_sites_raise_on_the_card(case, dev):
    """B5's call site launches it for a CUDA tensor or raises (float64, the
    switch off); the composition's setup solve raises at B2's call site."""
    from proxtv_tpu_torch.ops import tv1d_lp
    from proxtv_tpu_torch.ops.kernels import gating

    y64 = torch.randn((4, 32), dtype=torch.float64, device=dev)
    if case == "switch_off":
        with gating.fused_ctx(False), pytest.raises(RuntimeError):
            tv1d_lp.tvp_gpfw(y64.float(), 0.5, 1.5)
        return
    with pytest.raises(ValueError):
        if case == "gpfw_f64":
            tv1d_lp.tvp_gpfw(y64, 0.5, 1.5)
        else:
            tv1d_lp.tvp_batched(y64, 0.5, 1.5, method="fw")


# -- D1 (taut string) and D2 (message-passing DP): the direct 1D engines ----

def _direct_lam(kind, rng, B, n):
    """The weights of the direct-kernel card tests: scalar, per signal,
    per edge (uniform in [0, 1.4], 5% zeroed), all zero, huge."""
    if kind == "scalar":
        return 0.7
    if kind == "row":
        return torch.from_numpy((rng.rand(B) * 1.4).astype(np.float32))
    if kind == "edge":
        w = rng.rand(B, n - 1) * 1.4
        w[rng.rand(B, n - 1) < 0.05] = 0.0
        return torch.from_numpy(w.astype(np.float32))
    if kind == "zero":
        return torch.zeros((B, n - 1), dtype=torch.float32)
    return 1e7  # huge: the mean


@pytest.mark.parametrize("kernel", ["tautstring", "dp"])
@pytest.mark.parametrize("B,n,kind", [
    (1, 2, "scalar"), (1, 2, "edge"), (37, 2, "row"), (1, 1000, "scalar"),
    (37, 1000, "row"), (37, 1000, "edge"), (33, 257, "zero"),
    (33, 257, "huge"), (70, 300, "edge"), (1, 8193, "edge"),
    (1, 10000, "scalar")])
def test_direct_kernels_match_plain(kernel, B, n, kind, dev):
    """D1 and D2 against their plain versions in float32 (the same events
    in the same float32 roundings: 1e-5 of the data's size, the degenerate
    guards' means summed in another order) and in float64 (2e-3, the bar of
    the 1D TV-L1 outputs on the card), at B = 1, B not a multiple of 32,
    n = 2, past B1's lane limit, per-signal, per-edge, zero and huge
    weights; each call launches its kernel once."""
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.ops.kernels import dp as DPK
    from proxtv_tpu_torch.ops.kernels import tautstring as TSK

    mod, plain = {"tautstring": (TSK, tv1d_l1.tv1_tautstring_plain),
                  "dp": (DPK, tv1d_l1.tv1_dp_plain)}[kernel]
    rng = np.random.RandomState(n + B)
    y = rng.randn(B, n) + np.cumsum(rng.randn(B, n), axis=1) * 0.1
    yt = torch.from_numpy(y.astype(np.float32))
    lam = _direct_lam(kind, rng, B, n)
    before = mod.LAUNCHES.value
    out = getattr(mod, kernel)(yt.to(dev), lam.to(dev) if torch.is_tensor(lam)
                               else lam)
    torch.cuda.synchronize()
    assert mod.LAUNCHES.value == before + 1
    ref = plain(yt, lam)
    scale = max(1.0, float(np.abs(y).max()))
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(),
                               atol=1e-5 * scale)
    ref64 = plain(torch.from_numpy(y), lam.double() if torch.is_tensor(lam)
                  else lam)
    np.testing.assert_allclose(out.cpu().double().numpy(), ref64.numpy(),
                               atol=2e-3)
    if kind == "zero":
        np.testing.assert_array_equal(out.cpu().numpy(), yt.numpy())


def _layout_case(rng, B, n, kind):
    """Signals and weights of a layout case: walks plus noise, a constant
    row (degenerate: its mean) and, with a per-signal or per-edge field, a
    zero-weight row (the identity) and a huge-weight row (the mean).
    Returns (y, lam, the degenerate rows)."""
    y = (rng.randn(B, n)
         + np.cumsum(rng.randn(B, n), axis=1) * 0.1).astype(np.float32)
    deg = []
    if B > 2:
        y[1] = y[1, 0]
        deg.append(1)
    if kind == "scalar":
        return y, 0.7, deg
    if kind == "vector":
        return y, torch.from_numpy((rng.rand(n - 1) * 1.4).astype(
            np.float32)), deg
    w = rng.rand(B) * 1.4 if kind == "row" else rng.rand(B, n - 1) * 1.4
    if kind == "edge":
        w[rng.rand(B, n - 1) < 0.05] = 0.0
    if B > 2:
        w[0], w[2] = 0.0, 1e7
        deg += [0, 2]
    return y, torch.from_numpy(w.astype(np.float32)), deg


def test_direct_layout_thresholds(dev):
    """The warp layouts end where the layout cases below cross them: D1 at
    n = 16384, D2 at n = 8192 and, at n = 1000, past a batch of four waves
    of its resident warps."""
    from proxtv_tpu_torch.ops.kernels import dp as DPK

    assert TSK.warp_max_n() == 16384
    for per_edge in (False, True):
        assert DPK.warp_layout(1, 8192, per_edge)
        assert not DPK.warp_layout(1, 8193, per_edge)
        assert DPK.warp_layout(512, 1000, per_edge)
        assert not DPK.warp_layout(10000, 1000, per_edge)


@pytest.mark.parametrize("side", ["warp", "thread"])
def test_dp_batch_layouts_match_plain_bit_for_bit(side, dev):
    """D2 on either side of its batch rule at n = 1000 (the largest batch
    of the warp layout and one more signal), bit for bit with its plain
    version on 40 spread rows (the rows are independent)."""
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.ops.kernels import dp as DPK

    n, lo, hi = 1000, 1, 20000
    while hi - lo > 1:  # the largest B of the warp layout
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if DPK.warp_layout(mid, n, False) else (lo, mid)
    B = lo if side == "warp" else lo + 1
    assert DPK.warp_layout(B, n, False) == (side == "warp")
    rng = np.random.RandomState(B)
    y, lam, _ = _layout_case(rng, B, n, "scalar")
    out = DPK.dp(torch.from_numpy(y).to(dev), lam)
    torch.cuda.synchronize()
    rows = np.unique(np.linspace(3, B - 1, 40).astype(int))
    ref = tv1d_l1.tv1_dp_plain(torch.from_numpy(y[rows]), lam).numpy()
    np.testing.assert_array_equal(out.cpu().numpy()[rows], ref)


@pytest.mark.parametrize("kernel,B,n,kind", [
    *((k, B, 300, kind) for k in ("tautstring", "dp")
      for B, kind in ((1, "scalar"), (31, "vector"), (32, "row"),
                      (33, "edge"), (133, "scalar"), (133, "vector"),
                      (133, "row"), (133, "edge"))),
    ("tautstring", 10000, 64, "scalar"), ("dp", 10000, 64, "row"),
    ("tautstring", 1, 16384, "vector"), ("tautstring", 1, 16385, "scalar"),
    ("dp", 1, 8192, "vector")])
def test_direct_layouts_match_plain_bit_for_bit(kernel, B, n, kind, dev):
    """D1 and D2 at the edges of their layouts (one warp a signal up to
    warp_max_n, one thread a signal past it; B = 1, 31, 32, 33, 133 and
    10000): bit for bit with their plain versions on every row that is
    not degenerate, and within 1e-5 of the data's size on the degenerate
    rows, whose mean the kernels sum in another order.  The other side of
    D2's threshold in n (8193, 10000) is test_direct_kernels_match_plain's,
    in B test_dp_batch_layouts_match_plain_bit_for_bit's."""
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.ops.kernels import dp as DPK

    mod, plain = {"tautstring": (TSK, tv1d_l1.tv1_tautstring_plain),
                  "dp": (DPK, tv1d_l1.tv1_dp_plain)}[kernel]
    rng = np.random.RandomState(7 * n + B)
    y, lam, deg = _layout_case(rng, B, n, kind)
    yt = torch.from_numpy(y)
    before = mod.LAUNCHES.value
    out = getattr(mod, kernel)(yt.to(dev), lam.to(dev)
                               if torch.is_tensor(lam) else lam)
    torch.cuda.synchronize()
    assert mod.LAUNCHES.value == before + 1
    out = out.cpu().numpy()
    ref = plain(yt, lam).numpy()
    rest = np.setdiff1d(np.arange(B), deg)
    np.testing.assert_array_equal(out[rest], ref[rest])
    if deg:
        np.testing.assert_allclose(out[deg], ref[deg],
                                   atol=1e-5 * max(1.0, float(
                                       np.abs(y).max())))
        if kind in ("row", "edge"):
            np.testing.assert_array_equal(out[0], y[0])  # zero weights


def test_pn_kernel_on_long_signal_windows(dev):
    """B1 on the long-signal route's windows: (3, 6400) of C2's walk, per
    edge (the first window's left margin and the last window's tail cut off
    by zero weights), cold and warm from the cold dual in the (K, win)
    layout, with the route's tol_eps = 0; against its plain version (x
    within 2e-3, Newton counts at most 2 apart: the bars of
    test_pn_kernel_matches_plain)."""
    from proxtv_tpu_torch.ops import tv1d_long as TL

    rng = np.random.RandomState(21)
    n, chunk, overlap = 14000, 5120, 640
    y = np.cumsum(rng.randn(n)) * 0.3 + rng.randn(n)
    K, win = -(-n // chunk), chunk + 2 * overlap
    Yw = TL._windows(torch.from_numpy(y).float()[None], K, chunk,
                     overlap).reshape(K, win)
    lam = torch.from_numpy((2.0 * (0.5 + rng.rand(1, n - 1))).astype(
        np.float32))
    lam_w = TL._window_weights(lam, True, 1, K, chunk, overlap, win, 0, n - 1,
                               torch.float32, torch.device("cpu"))
    lam_full = torch.cat([lam_w, torch.zeros((K, 1))], dim=1)
    assert bool((lam_full[0, :overlap] == 0).all())
    assert bool((lam_full[-1, n - 1 - (K - 1) * chunk + overlap:] == 0).all())
    w_init = None
    for _ in range(2):
        ref, wref, it_ref = PPF.pn_tv1_fused_plain(Yw, lam_full, w_init,
                                                   tb=1, tol_eps=0.0)
        before = PPF.LAUNCHES.value
        x, w, it = PPF.pn_tv1_fused(
            Yw.to(dev), lam_full.to(dev),
            None if w_init is None else w_init.to(dev), return_iters=True,
            tol_eps=0.0)
        torch.cuda.synchronize()
        assert PPF.LAUNCHES.value == before + 1
        np.testing.assert_allclose(x.cpu().numpy(), ref.numpy(), atol=2e-3)
        assert int((it.cpu() - it_ref).abs().max()) <= 2
        w_init = w.cpu()


@pytest.mark.parametrize("case", ["f64", "switch_off"])
def test_long_route_raises_instead_of_running_plain_on_the_card(case, dev):
    """tv1_long's windows launch B1 or raise: float64 on the card and the
    switch off raise at the window call site, as every kernel call site
    does (the JAX package's respect_flag=False guards a jit cache the port
    does not have)."""
    from proxtv_tpu_torch.ops import tv1d_long as TL
    from proxtv_tpu_torch.ops.kernels import gating

    y = torch.randn(3000, dtype=torch.float64, device=dev)
    b1 = PPF.LAUNCHES.value
    if case == "f64":
        with pytest.raises(ValueError):
            TL.tv1_long(y, 0.7, chunk=512, overlap=64)
    else:
        with gating.fused_ctx(False), pytest.raises(RuntimeError):
            TL.tv1_long(y.float(), 0.7, chunk=512, overlap=64)
    assert PPF.LAUNCHES.value == b1


@pytest.mark.parametrize("weighted", [False, True])
def test_long_route_on_the_card(weighted, dev):
    """tv1_1d and tv1w_1d auto past n = 16384 on the card (ROADMAP C2's
    instance, n = 20000, lam 2.0; weights 2 x U[0.5, 1.5]): the long-signal
    route, its windows on kernel B1 (not D1), with rc 0.  tv1_1d lands
    within 2e-3 of the same call in float64 on the CPU.  tv1w_1d is held by
    the certified-gap rule against float64 (F - F_ref <= gap + gap_ref +
    1e-6 F_ref): on this walk the float32 certificate (2 eps 0.5||y -
    mean||^2 = 1.5) admits a solution 8.2e-2 from float64 on 15 of 20000
    samples, in the JAX package's float32 tv1_long too (ROADMAP C)."""
    from proxtv_tpu_torch import api

    rng = np.random.RandomState(21)
    n = 20000
    y = np.cumsum(rng.randn(n)) * 0.3 + rng.randn(n)
    w = 2.0 * (0.5 + rng.rand(n - 1))
    b1, ts = PPF.LAUNCHES.value, TSK.LAUNCHES.value
    if weighted:
        x, info = api.tv1w_1d(y, w, return_info=True)
        ref, info_ref = api.tv1w_1d(y, w, return_info=True, device="cpu")
    else:
        x, info = api.tv1_1d(y, 2.0, return_info=True)
        ref, info_ref = api.tv1_1d(y, 2.0, return_info=True, device="cpu")
    assert PPF.LAUNCHES.value > b1 and TSK.LAUNCHES.value == ts
    assert x.dtype == np.float32 and int(info.rc[0]) == 0
    assert int(info_ref.rc[0]) == 0
    if not weighted:
        np.testing.assert_allclose(x, ref, atol=2e-3)
        return

    def F(v):
        v = v.astype(np.float64)
        return 0.5 * np.sum((v - y) ** 2) + np.sum(w * np.abs(np.diff(v)))

    assert F(x) - F(ref) <= (float(info.gap[0]) + float(info_ref.gap[0])
                             + 1e-6 * F(ref))


@pytest.mark.parametrize("kernel", ["tautstring", "dp"])
def test_direct_bind_launches_what_the_wrapper_does(kernel, dev):
    """bind's launch gives the wrapper's output bit for bit, does not count
    in LAUNCHES, and keeps its outputs (and D2's workspace) alive after the
    caller drops them."""
    from proxtv_tpu_torch.ops.kernels import dp as DPK
    from proxtv_tpu_torch.ops.kernels import tautstring as TSK

    mod = {"tautstring": TSK, "dp": DPK}[kernel]
    rng = np.random.RandomState(10)
    y = torch.from_numpy(rng.randn(40, 500).astype(np.float32)).to(dev)
    lam = torch.from_numpy(rng.rand(40, 499).astype(np.float32)).to(dev)
    ref = getattr(mod, kernel)(y, lam)
    before = mod.LAUNCHES.value
    out, launch = mod.bind(y, lam)
    launch()
    torch.cuda.synchronize()
    assert mod.LAUNCHES.value == before and torch.equal(out, ref)
    held = out.data_ptr()
    del out
    fresh = [torch.empty_like(y) for _ in range(8)]
    fresh += [torch.empty((1000, 40), device=dev) for _ in range(8)]
    assert held not in {t.data_ptr() for t in fresh}
    launch()
    torch.cuda.synchronize()


def test_direct_kernels_raise_on_unsupported_cuda_input(dev):
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.ops.kernels import gating

    y64 = torch.zeros((4, 16), dtype=torch.float64, device=dev)
    for fn in (tv1d_l1.tv1_tautstring, tv1d_l1.tv1_dp):
        with pytest.raises(ValueError):
            fn(y64, 0.5)
        with gating.fused_ctx(False), pytest.raises(RuntimeError):
            fn(y64.float(), 0.5)
    with pytest.raises(ValueError):
        tv1d_l1.tv1_batched(y64, 0.5, method="tautstring", strict=True)


@pytest.mark.parametrize("method", ["hybridtautstring", "dp", "condat",
                                    "classictautstring"])
def test_tv1_batched_routes_on_the_card(method, dev):
    """Non-strict names run B1 up to its lane limit and the named engine
    past it (D1, D2, or PyTorch ops for Condat and the classic taut
    string), as the JAX package's table; strict names run the named
    engine at any length.  Each held against float64 on the CPU (2e-3)."""
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.ops.kernels import dp as DPK
    from proxtv_tpu_torch.ops.kernels import tautstring as TSK

    rng = np.random.RandomState(11)
    named = {"hybridtautstring": TSK.LAUNCHES, "dp": DPK.LAUNCHES}.get(method)
    # Condat and the classic taut string run as PyTorch ops, a few launches
    # per event: past the lane limit they take one signal just past it.
    past = (9000, 3) if named is not None else (8193, 1)
    for n, strict in ((500, False), (500, True), (past[0], False)):
        Y = rng.randn(3 if n <= 8192 else past[1], n)
        counts = (PPF.LAUNCHES.value, TSK.LAUNCHES.value, DPK.LAUNCHES.value)
        x = tv1d_l1.tv1_batched(torch.from_numpy(Y).float().to(dev), 0.7,
                                method=method, strict=strict)
        torch.cuda.synchronize()
        b1 = PPF.LAUNCHES.value - counts[0]
        direct = (TSK.LAUNCHES.value - counts[1]
                  + DPK.LAUNCHES.value - counts[2])
        if n <= 8192 and not strict:
            assert b1 == 1 and direct == 0
        else:
            assert b1 == 0
            assert direct == (1 if named is not None else 0)
        ref = tv1d_l1.tv1_batched(torch.from_numpy(Y), 0.7, method=method,
                                  strict=True)
        np.testing.assert_allclose(x.cpu().double().numpy(), ref.numpy(),
                                   atol=2e-3)


def test_native_host_engine_on_the_card_machine(dev):
    """The machine with the card has a C++ compiler (nvcc's host compiler),
    so the host route is available; the build is atomic (a temporary file
    renamed into place, never native/libproxtv_host.so).  The API's auto
    keeps a short signal on the card (B1), and backend='host' takes the
    host engine, float32 as the card route."""
    from proxtv_tpu_torch import api
    from proxtv_tpu_torch.runtime import native
    from proxtv_tpu_torch.utils import debug

    assert native.available()
    path = native.build()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert not any(".tmp" in f for f in os.listdir(native.BUILD_DIR)
                   if f.startswith("libproxtv_host"))
    y = np.cumsum(np.random.RandomState(12).randn(1000)) * 0.3
    before = debug.HOST_ROUTE.value
    b1 = PPF.LAUNCHES.value
    xd = api.tv1_1d(y, 2.0)
    assert debug.HOST_ROUTE.value == before and PPF.LAUNCHES.value == b1 + 1
    x = api.tv1_1d(y, 2.0, backend="host")
    assert debug.HOST_ROUTE.value == before + 1 and x.dtype == np.float32
    ref = api.tv1_1d(y, 2.0, backend="cuda", method="hybridtautstring",
                     device="cpu")
    np.testing.assert_allclose(x, ref, atol=1e-5)
    np.testing.assert_allclose(xd, ref, atol=2e-3)


def _diff_cells(dev):
    """Small seeded inputs of the differentiable path: a blocky 1D batch and
    a blocky 2D image with noise, float32 on the card."""
    rng = np.random.RandomState(13)
    t1 = np.repeat(rng.randn(64, 20), 25, axis=1)
    t2 = np.kron(rng.randn(1, 4, 4), np.ones((32, 32)))
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    return (f(t1 + 0.3 * rng.randn(*t1.shape)), f(t1),
            f(t2 + 0.3 * rng.randn(*t2.shape)), f(t2))


@pytest.mark.parametrize("case", ["tv1 pn", "tv2 dr", "tv2 cp-acc"])
def test_diffprox_on_the_card_launches_kernels(case, dev):
    """tv1_prox and tv2d_prox on CUDA float32: the forward launches B1 (B3
    for chambolle-pock-acc), and the output and the gradients stay on the
    card."""
    from proxtv_tpu_torch.ops import diffprox

    y1, t1, y2, t2 = _diff_cells(dev)
    b1, b3 = PPF.LAUNCHES.value, PPK.LAUNCHES.value
    if case == "tv1 pn":
        y = y1.clone().requires_grad_(True)
        lam = torch.tensor(0.3, device=dev, requires_grad=True)
        x = diffprox.tv1_prox(y, lam)
        loss = torch.mean((x - t1) ** 2)
        gy, glam = torch.autograd.grad(loss, (y, lam))
        assert glam.is_cuda and glam.shape == () and float(glam) != 0.0
    else:
        method = "dr" if case == "tv2 dr" else "chambolle-pock-acc"
        y = y2.clone().requires_grad_(True)
        x = diffprox.tv2d_prox(y, 0.3, method)
        loss = torch.mean((x - t2) ** 2)
        (gy,) = torch.autograd.grad(loss, y)
    assert x.is_cuda and x.dtype == torch.float32 and gy.is_cuda
    assert bool(torch.isfinite(gy).all())
    if case == "tv2 cp-acc":
        assert PPK.LAUNCHES.value > b3
    else:
        assert PPF.LAUNCHES.value > b1


@pytest.mark.parametrize("dim", ["1d", "2d"])
def test_diffprox_backward_on_the_card_matches_float64(dim, dev):
    """The backward on the card against the same backward in float64 on the
    CPU, both on the card's forward output: the same flat edges, so gy (and
    glam) agree to 1e-5 relative (float32 sums in another order)."""
    from proxtv_tpu_torch.ops import diffprox

    y1, t1, y2, t2 = _diff_cells(dev)
    if dim == "1d":
        x = diffprox.tv1_prox(y1, 0.3)
        g = 2 * (x - t1) / x.numel()
        outs = diffprox._bwd(x, g, 0)
        refs = diffprox._bwd(x.double().cpu(), g.double().cpu(), 0)
    else:
        x = diffprox.tv2d_prox(y2, 0.3, "dr")
        g = 2 * (x - t2) / x.numel()
        outs = (diffprox._bwd2(x, g),)
        refs = (diffprox._bwd2(x.double().cpu(), g.double().cpu()),)
    for out, ref in zip(outs, refs):
        assert out.is_cuda
        err = float((out.double().cpu() - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), err


def test_layer_step_stays_on_the_card(dev):
    """One Adam step of TVDenoise1D on the card: the weight, its gradient,
    the optimizer's moments and the output are all CUDA tensors, and the
    step moves the weight."""
    from proxtv_tpu_torch.models.layers import TVDenoise1D

    y1, t1, _, _ = _diff_cells(dev)
    layer = TVDenoise1D(init_lam=0.01)
    assert layer.raw_lam.is_cuda and layer.raw_lam.dtype == torch.float32
    opt = torch.optim.Adam(layer.parameters(), lr=0.05)
    before = float(layer.raw_lam.detach())
    x = layer(y1)
    loss = torch.mean((x - t1) ** 2)
    opt.zero_grad()
    loss.backward()
    opt.step()
    assert x.is_cuda and loss.is_cuda and layer.raw_lam.grad.is_cuda
    (state,) = opt.state.values()  # Adam keeps its step count on the host
    assert state["exp_avg"].is_cuda and state["exp_avg_sq"].is_cuda
    assert float(layer.raw_lam.detach()) != before
