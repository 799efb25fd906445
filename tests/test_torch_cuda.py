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

from proxtv_tpu_torch.ops.kernels import labels as LBK
from proxtv_tpu_torch.ops.kernels import ms_fused as MSK
from proxtv_tpu_torch.ops.kernels import pcr as PK
from proxtv_tpu_torch.ops.kernels import pdhg3d_fused as P3K
from proxtv_tpu_torch.ops.kernels import pdhg_fused as PPK
from proxtv_tpu_torch.ops.kernels import pn_fused as PPF
from proxtv_tpu_torch.ops.kernels import tautstring as TSK

import torch_label_fields as LF

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
    """B1 has no float64 form (it raises for float64); B2 is built in
    float32 and float64 and raises for any other dtype."""
    y64 = torch.zeros((4, 16), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        PK.pcr_spd_solve(y64.half())
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
def test_call_sites_raise_instead_of_running_plain_on_the_card(case, dev,
                                                              monkeypatch):
    """Every call site that holds a kernel launches it for a CUDA tensor or
    raises; none runs a kernel's plain version on the card.  A float64
    tensor takes the JAX package's float64 route: tv1_pn with its Newton
    systems on B2 in float64 (no B1), the primal-dual methods by the
    unfused iteration (no B3)."""
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
    if case.endswith("_f64"):
        _no_plain_on_the_card(monkeypatch)
        counts = (PPF.LAUNCHES.value, PPK.LAUNCHES.value,
                  PK.LAUNCHES_F64.value)
        out = calls[case]()
        torch.cuda.synchronize()
        x = out[0] if isinstance(out, tuple) else out
        assert x.dtype == torch.float64 and x.is_cuda
        assert PPF.LAUNCHES.value == counts[0]  # no B1
        assert PPK.LAUNCHES.value == counts[1]  # no B3
        assert (PK.LAUNCHES_F64.value > counts[2]) == (case != "tv2d_cp_acc_f64")
        return
    with pytest.raises(ValueError):
        calls[case]()


def _no_plain_on_the_card(monkeypatch):
    """Make every kernel's plain version fail on a CUDA tensor (the float64
    route may run compositions there, never a kernel's plain version)."""
    from proxtv_tpu_torch.ops import tv1d_l1

    def trip(mod, name):
        orig = getattr(mod, name)

        def f(y, *a, **k):
            assert not y.is_cuda, f"{name} ran on the card"
            return orig(y, *a, **k)

        monkeypatch.setattr(mod, name, f)

    for name in ("tv1_tautstring_plain", "tv1_condat_plain",
                 "tv1_classic_ts_plain", "tv1_dp_plain"):
        trip(tv1d_l1, name)
    trip(PK, "pcr_spd_solve_plain")
    trip(PPF, "pn_tv1_fused_plain")
    trip(PPK, "pdhg_chunk_plain")
    trip(MSK, "ms_tv2_fused_plain")
    trip(P3K, "pdhg3d_chunk_plain")
    trip(LBK, "component_labels_plain")


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


@pytest.mark.parametrize("mode", ["scalar", "field warm", "long"])
def test_pn_bind_launches_what_the_wrapper_does(mode, dev):
    """pn_fused.bind's launch (chip_smoke.py's and the timing tools' call
    of B1's C entry point) gives the wrapper's outputs bit for bit (x, the
    dual, the Newton counts), does not count in LAUNCHES, and keeps its
    outputs alive after the caller drops them: a scalar lam at n = 1000
    (one warp a fiber), a weight field with a warm start at n = 200, and a
    field at n = 1000 with tol_eps 0 and no dual (the long route's
    windows)."""
    rng = np.random.RandomState(17)
    n = 200 if mode == "field warm" else 1000
    y = torch.from_numpy(rng.randn(40, n).astype(np.float32)).to(dev)
    lam = torch.from_numpy((rng.rand(40, n) * 1.4).astype(np.float32)).to(dev)
    lam[:, -1] = 0.0
    kw = {"scalar": dict(lam_scalar=0.7),
          "field warm": dict(lam_full=lam, w_init=0.5 * lam),
          "long": dict(lam_full=lam, tol_eps=0.0, return_dual=False)}[mode]
    ref = PPF.pn_tv1_fused(y, return_iters=True, **kw)
    before = PPF.LAUNCHES.value
    outs, launch = PPF.bind(y, return_iters=True, **kw)
    launch()
    torch.cuda.synchronize()
    assert PPF.LAUNCHES.value == before
    for o, r in zip(outs, ref):
        assert (o is None and r is None) or torch.equal(o, r)
    held = {t.data_ptr() for t in outs if t is not None}
    del outs
    fresh = [torch.empty_like(y) for _ in range(8)]
    assert held.isdisjoint(t.data_ptr() for t in fresh)
    launch()
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="CUDA"):
        PPF.bind(y.cpu(), lam_scalar=0.7)


def test_bind_launch_keeps_its_outputs_alive(dev):
    """A launch made by bind writes into the outputs bind allocated, so it
    keeps them alive after the caller drops them: the caching allocator
    must not hand their memory to a new tensor while the launch can still
    write it (B2, B4, B5 and L1; the timing replays drop the outputs)."""
    from proxtv_tpu_torch.ops.kernels import lp_fused as LPK

    rng = np.random.RandomState(9)
    y = torch.from_numpy(rng.randn(8, 300).astype(np.float32)).to(dev)
    ones = torch.ones(8, device=dev)
    for make in (lambda: PK.bind(y),
                 lambda: MSK.bind(y, lam=1.0),
                 lambda: LBK.bind(y[None], ones[:1]),
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
def test_new_call_sites_raise_on_the_card(case, dev, monkeypatch):
    """B4's and B6's call sites launch their kernel for a CUDA tensor or
    raise; none runs a kernel's plain version on the card.  A float64
    tensor takes the JAX package's float64 route: TV-L2 the More-Sorensen
    composition (no B4) with its shifted solves on B2 in float64, the ND
    primal-dual methods the JAX package's refusal."""
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
    if case.startswith("tv2_"):
        _no_plain_on_the_card(monkeypatch)
        b4, b2 = MSK.LAUNCHES.value, PK.LAUNCHES_F64.value
        x, _ = calls[case]()
        torch.cuda.synchronize()
        assert x.dtype == torch.float64 and x.is_cuda
        assert MSK.LAUNCHES.value == b4 and PK.LAUNCHES_F64.value > b2
        return
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
def test_lp_call_sites_raise_on_the_card(case, dev, monkeypatch):
    """B5's call site launches it for a CUDA tensor or raises (the switch
    off); a float64 tensor takes the JAX package's float64 route, the
    compositions (no B5) with the setup solve on B2 in float64, and no
    kernel's plain version runs on the card."""
    from proxtv_tpu_torch.ops import tv1d_lp
    from proxtv_tpu_torch.ops.kernels import gating
    from proxtv_tpu_torch.ops.kernels import lp_fused as LPK

    y64 = torch.randn((4, 32), dtype=torch.float64, device=dev)
    if case == "switch_off":
        with gating.fused_ctx(False), pytest.raises(RuntimeError):
            tv1d_lp.tvp_gpfw(y64.float(), 0.5, 1.5)
        return
    _no_plain_on_the_card(monkeypatch)
    b5, b2 = LPK.LAUNCHES.value, PK.LAUNCHES_F64.value
    if case == "gpfw_f64":
        x, _ = tv1d_lp.tvp_gpfw(y64, 0.5, 1.5)
    else:
        x, _ = tv1d_lp.tvp_batched(y64, 0.5, 1.5, method="fw")
    torch.cuda.synchronize()
    assert x.dtype == torch.float64 and x.is_cuda
    assert LPK.LAUNCHES.value == b5 and PK.LAUNCHES_F64.value > b2


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
    ("dp", 1, 8192, "vector"),
    *((k, B, 300, kind) for k in ("condat", "classic_ts")
      for B, kind in ((1, "scalar"), (132, "row"), (133, "scalar"),
                      (133, "row"), (512, "scalar"), (512, "row"))),
    *((k, 1, n, "scalar") for k in ("condat", "classic_ts")
      for n in ("warp_max_n", "warp_max_n + 1"))])
def test_direct_layouts_match_plain_bit_for_bit(kernel, B, n, kind, dev):
    """D1-D4 at the edges of their layouts (one warp a signal up to
    warp_max_n, one thread a signal past it; B = 1, 31, 32, 33, 132, 133,
    512 and 10000; D3 and D4 at n = warp_max_n() and one more, named so
    because the threshold is read from the library): bit for bit with
    their plain versions on every row that is not degenerate, and within
    1e-5 of the data's size on the degenerate rows, whose mean the kernels
    sum in another order.  The other side of D2's threshold in n (8193,
    10000) is test_direct_kernels_match_plain's, in B
    test_dp_batch_layouts_match_plain_bit_for_bit's."""
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.ops.kernels import classic_ts as CTK
    from proxtv_tpu_torch.ops.kernels import condat as CDK
    from proxtv_tpu_torch.ops.kernels import dp as DPK

    mod, plain = {"tautstring": (TSK, tv1d_l1.tv1_tautstring_plain),
                  "dp": (DPK, tv1d_l1.tv1_dp_plain),
                  "condat": (CDK, tv1d_l1.tv1_condat_plain),
                  "classic_ts": (CTK, tv1d_l1.tv1_classic_ts_plain)}[kernel]
    if isinstance(n, str):
        n = mod.warp_max_n() + n.endswith("+ 1")
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
def test_long_route_raises_instead_of_running_plain_on_the_card(case, dev,
                                                                monkeypatch):
    """tv1_long's windows launch B1 or raise: the switch off raises at the
    window call site, as every kernel call site does (the JAX package's
    respect_flag=False guards a jit cache the port does not have); float64
    takes the JAX package's float64 route, its windows by tv1_pn on B2 in
    float64 (no B1, no plain version on the card), within 1e-6 of the same
    call on the CPU."""
    from proxtv_tpu_torch.ops import tv1d_long as TL
    from proxtv_tpu_torch.ops.kernels import gating

    y = torch.randn(3000, dtype=torch.float64, device=dev)
    b1 = PPF.LAUNCHES.value
    if case == "f64":
        _no_plain_on_the_card(monkeypatch)
        b2 = PK.LAUNCHES_F64.value
        x, info = TL.tv1_long(y, 0.7, chunk=512, overlap=64)
        torch.cuda.synchronize()
        assert PK.LAUNCHES_F64.value > b2 and int(info.rc[0]) == 0
        ref, _ = TL.tv1_long(y.cpu(), 0.7, chunk=512, overlap=64)
        assert float((x.cpu() - ref).abs().max()) <= 1e-6
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


@pytest.mark.parametrize("kernel", ["tautstring", "dp", "condat",
                                    "classic_ts"])
def test_direct_bind_launches_what_the_wrapper_does(kernel, dev):
    """bind's launch gives the wrapper's output bit for bit, does not count
    in LAUNCHES, and keeps its outputs (and D2's workspace) alive after the
    caller drops them (per-edge weights for D1 and D2, one a signal for the
    unweighted D3 and D4)."""
    from proxtv_tpu_torch.ops.kernels import classic_ts as CTK
    from proxtv_tpu_torch.ops.kernels import condat as CDK
    from proxtv_tpu_torch.ops.kernels import dp as DPK
    from proxtv_tpu_torch.ops.kernels import tautstring as TSK

    mod = {"tautstring": TSK, "dp": DPK, "condat": CDK,
           "classic_ts": CTK}[kernel]
    rng = np.random.RandomState(10)
    y = torch.from_numpy(rng.randn(40, 500).astype(np.float32)).to(dev)
    lam = torch.from_numpy(rng.rand(40, 499).astype(np.float32)).to(dev)
    if kernel in ("condat", "classic_ts"):
        lam = lam[:, 0].contiguous()
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
    """D1-D4 take float32 and float64 on the card; another dtype, the
    switch off and per-edge weights for the unweighted D3 and D4 raise."""
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.ops.kernels import gating

    y64 = torch.zeros((4, 16), dtype=torch.float64, device=dev)
    y16 = y64.half()
    for fn in (tv1d_l1.tv1_tautstring, tv1d_l1.tv1_dp, tv1d_l1.tv1_condat,
               tv1d_l1.tv1_classic_ts):
        with pytest.raises(ValueError):
            fn(y16, 0.5)
        with gating.fused_ctx(False), pytest.raises(RuntimeError):
            fn(y64.float(), 0.5)
        with gating.fused_ctx(False), pytest.raises(RuntimeError):
            fn(y64, 0.5)
    assert tv1d_l1.tv1_dp(y64, 0.5).dtype == torch.float64
    for fn in (tv1d_l1.tv1_condat, tv1d_l1.tv1_classic_ts):
        with pytest.raises(ValueError, match="unweighted"):
            fn(y64.float(), torch.ones((4, 15), device=dev))
        with pytest.raises(ValueError, match="unweighted"):
            fn(y64, torch.ones((4, 15), dtype=torch.float64, device=dev))
    for m in ("tautstring", "condat", "classictautstring"):
        with pytest.raises(ValueError):
            tv1d_l1.tv1_batched(y16, 0.5, method=m, strict=True)


@pytest.mark.parametrize("method", ["hybridtautstring", "dp", "condat",
                                    "classictautstring"])
def test_tv1_batched_routes_on_the_card(method, dev):
    """Non-strict names run B1 up to its lane limit and the named engine
    past it (D1, D2, D3 for Condat, D4 for the classic taut string), as the
    JAX package's table; strict names run the named engine at any length,
    one launch of its kernel.  Each held against float64 on the CPU
    (2e-3)."""
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.ops.kernels import classic_ts as CTK
    from proxtv_tpu_torch.ops.kernels import condat as CDK
    from proxtv_tpu_torch.ops.kernels import dp as DPK
    from proxtv_tpu_torch.ops.kernels import tautstring as TSK

    rng = np.random.RandomState(11)
    direct_counters = (TSK.LAUNCHES, DPK.LAUNCHES, CDK.LAUNCHES,
                       CTK.LAUNCHES)
    named = {"hybridtautstring": TSK.LAUNCHES, "dp": DPK.LAUNCHES,
             "condat": CDK.LAUNCHES,
             "classictautstring": CTK.LAUNCHES}[method]
    for n, strict in ((500, False), (500, True), (9000, False)):
        Y = rng.randn(3, n)
        counts = [c.value for c in (PPF.LAUNCHES, named, *direct_counters)]
        x = tv1d_l1.tv1_batched(torch.from_numpy(Y).float().to(dev), 0.7,
                                method=method, strict=strict)
        torch.cuda.synchronize()
        b1 = PPF.LAUNCHES.value - counts[0]
        own = named.value - counts[1]
        direct = sum(c.value - c0 for c, c0 in zip(direct_counters,
                                                    counts[2:]))
        if n <= 8192 and not strict:
            assert b1 == 1 and direct == 0
        else:
            assert b1 == 0 and own == 1 and direct == 1
        ref = tv1d_l1.tv1_batched(torch.from_numpy(Y), 0.7, method=method,
                                  strict=True)
        np.testing.assert_allclose(x.cpu().double().numpy(), ref.numpy(),
                                   atol=2e-3)


# -- D3 (Condat) and D4 (classic taut string): one lambda a signal ------

UNWEIGHTED = ["512x1000", "row", "one", "copies", "adversarial", "tie",
              "guards", "walk", "adversarial (CPU test's)", "behind"]


def _unweighted_case(case, rng):
    """Signals (float32) and the lams of an unweighted card case: the main
    path's 512 x 1000 batch at 0.7, per-signal lams, one signal of 1000,
    32 copies of one signal, the adversarial rows of the CPU tests (ties,
    plateaus, alternation, staircases, a jump of 2 lam; drawn here, and as
    test_condat_adversarial_patterns_match_jax draws them), the float32
    tie row at lam 0 and 1e-7, the guards (lam 0: the identity; huge: the
    mean), chip_smoke.py's main-path walk at lam 2.0 (drawn as it draws
    it), and two rows on which a float32 tie makes Condat jump behind the
    run it closes (found by a search of tie-heavy rows)."""
    walk = lambda B, n: (rng.randn(B, n) + np.cumsum(  # noqa: E731
        rng.randn(B, n), axis=1) * 0.1)
    if case == "512x1000":
        y, lams = walk(512, 1000), [0.7]
    elif case == "row":
        y = walk(37, 1000)
        lams = [torch.from_numpy((rng.rand(37) * 1.4).astype(np.float32))]
    elif case == "one":
        y, lams = walk(1, 1000), [2.0]
    elif case == "copies":
        y, lams = np.repeat(walk(1, 1000), 32, axis=0), [0.7]
    elif case == "adversarial":
        n, lam = 120, 0.5
        y = np.stack([
            np.zeros(n), np.repeat(rng.randn(n // 8), 8),
            np.tile([1.0, -1.0], n // 2), np.arange(n, dtype=float),
            np.concatenate([np.full(n // 2, 1.0), np.full(n - n // 2, -1.0)]),
            np.cumsum(np.tile([2 * lam, -2 * lam], n // 2))[:n]])
        lams = [lam, 0.25, 1.0]
    elif case == "adversarial (CPU test's)":
        n, lam = 120, 0.5
        r4 = np.random.RandomState(4)
        y = np.stack([
            np.zeros(n), np.repeat(r4.randn(n // 8), 8),
            np.tile([1.0, -1.0], n // 2), np.arange(n, dtype=float),
            np.concatenate([np.full(n // 2, 1.0), np.full(n - n // 2, -1.0)]),
            np.cumsum(np.tile([2 * lam, -2 * lam], n // 2))[:n]])
        lams = [lam, 0.0, 1e-7]
    elif case == "walk":
        r0 = np.random.RandomState(0)  # chip_smoke.py's SEED and draws
        r0.randn(1024, 1024)
        r0.randn(10000, 1000)
        y, lams = (np.cumsum(r0.randn(1000)) * 0.3)[None], [2.0]
    elif case == "behind":
        y = np.array([
            [1, 0, 0, -1, 0, -1, -1, -1, -1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 1, 1,
             2, 2, 3, 3, 3, 1, 2, 2, 3, 3, 2, 0, 0, -2, 0, 1, 1, 2, -1, -1, 0,
             -1, 0, 0, 1, 1, 0, 0, -1, 0, 0, -1, 0, 1, 1, 2, 2, 1, 0, 1, 1, 1,
             1, 1],
            [1, 2, -1, 0, -1, 0, -1, -1, 0, 0, 0, -1, 0, 1, -1, 1, 0, 2, 1,
             -3, 1, 0, -2, 1, 0, 1, -1, 0, 1, -1, 1, 0, -1, -1, 0, 1, 0, 2,
             -3, 0, 0, 0, 2, 1, -1, -1, -1, 0, 1, 1, 0, -1, -2, 1, 0, 0, -1,
             1, 0, -1, 2, 0, 0, -1]]) / 10
        lams = [0.1 * 1.0000001]
    elif case == "tie":
        t = np.random.RandomState(5)
        truth = np.repeat(t.randn(6), 30)
        y = (truth + 0.3 * t.randn(truth.size))[None]
        lams = [0.0, 1e-7, 0.5]
    else:
        y, lams = walk(33, 257), [0.0, 1e7]
    return y.astype(np.float32), lams


def _degenerate_rows(y, lam):
    """The rows the guards take (the identity or the mean), as float32
    tests them."""
    lv = np.broadcast_to(np.asarray(lam.numpy() if torch.is_tensor(lam)
                                    else lam, np.float32), (len(y),))
    n = y.shape[1]
    dy = np.abs(np.diff(y, axis=1)).max(axis=1)
    return (lv <= 0) | (lv >= np.float32(n * n) * dy)


@pytest.mark.parametrize("kernel", ["condat", "classic_ts"])
@pytest.mark.parametrize("case", UNWEIGHTED)
def test_unweighted_kernels_match_plain(kernel, case, dev):
    """D3 and D4 against their plain versions in float32: bit for bit on
    every row the guards do not take (the same events in the same float32
    roundings), within 1e-5 of the data's size on the rows they take (the
    mean summed in another order); one launch a call; the identity at
    lam 0."""
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.ops.kernels import classic_ts as CTK
    from proxtv_tpu_torch.ops.kernels import condat as CDK

    mod, plain = {"condat": (CDK, tv1d_l1.tv1_condat_plain),
                  "classic_ts": (CTK, tv1d_l1.tv1_classic_ts_plain)}[kernel]
    y, lams = _unweighted_case(case, np.random.RandomState(14))
    yt = torch.from_numpy(y)
    scale = max(1.0, float(np.abs(y).max()))
    for lam in lams:
        before = mod.LAUNCHES.value
        out = getattr(mod, kernel)(yt.to(dev), lam.to(dev)
                                   if torch.is_tensor(lam) else lam)
        torch.cuda.synchronize()
        assert mod.LAUNCHES.value == before + 1
        out = out.cpu().numpy()
        ref = plain(yt, lam).numpy()
        deg = _degenerate_rows(y, lam)
        np.testing.assert_array_equal(out[~deg], ref[~deg], err_msg=str(lam))
        np.testing.assert_allclose(out, ref, atol=1e-5 * scale, rtol=0)
        if not torch.is_tensor(lam) and lam == 0.0:
            np.testing.assert_array_equal(out, y)


@pytest.mark.parametrize("kernel", ["condat", "classic_ts"])
def test_unweighted_thread_layout_matches_float64(kernel, dev):
    """D3 and D4 one signal past their warp layouts (n = warp_max_n() + 1:
    one thread a signal, D4's deques in the wrapper's workspace): bit for
    bit with their float32 plain versions on the CPU, and against the
    float64 prox (the native host taut string) within 2e-3, the bar of the
    1D TV-L1 outputs on the card; for the classic taut string within 2e-3
    plus 4 ulp of its largest float32 prefix sum, of which it builds the
    tube (8.97e-3, 2.3 of those ulp, on such a signal of 11621, in the
    plain version as in the kernel; ROADMAP C)."""
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.ops.kernels import classic_ts as CTK
    from proxtv_tpu_torch.ops.kernels import condat as CDK
    from proxtv_tpu_torch.runtime import native

    mod, plain = {"condat": (CDK, tv1d_l1.tv1_condat_plain),
                  "classic_ts": (CTK, tv1d_l1.tv1_classic_ts_plain)}[kernel]
    assert (CDK.warp_max_n(), CTK.warp_max_n()) == (16384, 6280)
    n = mod.warp_max_n() + 1
    rng = np.random.RandomState(15)
    y = np.cumsum(rng.randn(n)) * 0.3 + rng.randn(n)
    y32 = torch.from_numpy(y[None].astype(np.float32))
    before = mod.LAUNCHES.value
    out = getattr(mod, kernel)(y32.to(dev), 1.3)
    torch.cuda.synchronize()
    assert mod.LAUNCHES.value == before + 1
    out = out.cpu()
    assert torch.equal(out, plain(y32, 1.3))
    assert native.available()
    ref = native.tv1_host(y, 1.3)
    bar = 2e-3
    if kernel == "classic_ts":
        bar += 4 * float(np.spacing(np.abs(np.cumsum(y32[0].numpy())).max()))
    np.testing.assert_allclose(out.double().numpy()[0], ref, atol=bar)


@pytest.mark.parametrize("side", ["warp", "thread"])
def test_classic_ts_cap_matches_plain(side, dev, monkeypatch):
    """D4's cap of 8n + 64 events, which no signal reaches (its events are
    at most 7n - 3: csrc/classic_ts.cu), held by a constructed case: the
    kernel run through classic_ts.bind with a smaller cap and the plain
    version with the same cap on its lock-step loop stop at the same
    event and give the same x bit for bit (the runs emitted so far, the
    last one filled forward, 0 where none), in both layouts."""
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.ops.kernels import classic_ts as CTK

    n = 40 if side == "warp" else CTK.warp_max_n() + 1
    rng = np.random.RandomState(16)
    y = (rng.randn(6, n) + np.cumsum(rng.randn(6, n), axis=1) * 0.3).astype(
        np.float32)
    lam = torch.from_numpy(np.array([0.1, 0.5, 1.0, 3.0, 0.7, 0.05],
                                    np.float32))
    run = tv1d_l1._run_lockstep
    caps = (0, 1, 2, 5, 17, 60, 150, 400)  # past the last event at n = 40
    for cap in caps if side == "thread" else caps + (8 * n + 64,):
        monkeypatch.setattr(tv1d_l1, "_run_lockstep",
                            lambda body, state, running, cap=None, c=cap:
                            run(body, state, running, cap=c))
        ref = tv1d_l1.tv1_classic_ts_plain(torch.from_numpy(y), lam).numpy()
        out, launch = CTK.bind(torch.from_numpy(y).to(dev), lam.to(dev),
                               cap=cap)
        launch()
        torch.cuda.synchronize()
        np.testing.assert_array_equal(out.cpu().numpy(), ref,
                                      err_msg=f"cap {cap}")


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


def _label_cases(case, dev):
    """The fields of test_label_kernel_matches_plain: a list of (X, tol)
    on the card, float32, tol as the backward computes it."""
    from proxtv_tpu_torch.ops import diffprox

    tiles = [(31, 33), (32, 32), (33, 31), (63, 65), (65, 64), (97, 1),
             (1, 97)]
    if case in ("p0.5", "p0.8", "serpentine"):
        kinds = (["serpentine", "serpentine_t"] if case == "serpentine"
                 else [case] * 2)
        xs = [LF.batch(kinds, M, N, seed=M + N) for M, N in tiles]
    elif case == "B = 3 mixed":
        xs = [LF.batch(["p0.5", "p0.8", "flat"], 70, 50, seed=7),
              LF.batch(["none", "p0.5", "serpentine"], 33, 65, seed=8)]
    elif case == "1024x1000 p0.5":
        xs = [LF.batch(["p0.5"], 1024, 1000, seed=9)]
    elif case == "flat 1024^2":
        xs = [LF.batch(["flat"], 1024, 1024)]
    else:  # a dr solve of the blocky image of _diff_cells
        _, _, y2, _ = _diff_cells(dev)
        xs = [diffprox.tv2d_prox(y2, 0.3, "dr").contiguous()]
    out = []
    for X in xs:
        X = (X if torch.is_tensor(X)
             else torch.from_numpy(X.astype(np.float32)).to(dev))
        out.append((X, diffprox._seg_tol(X)))
    return out


@pytest.mark.parametrize("case", ["p0.5", "p0.8", "serpentine", "B = 3 mixed",
                                  "1024x1000 p0.5", "flat 1024^2", "T2 dr"])
def test_label_kernel_matches_plain(case, dev):
    """Kernel L1 against its plain version on the card, bit for bit on the
    int32 labels: fields near and above the percolation threshold, a
    serpentine (one path through half the image) and its transpose at tile
    (32) +-1 sizes and on single rows and columns, a batch of mixed
    densities, 1024 x 1000, a flat 1024^2 image (one component of 2^20
    pixels) and a dr solution; one launch a call, no label trip."""
    for X, tol in _label_cases(case, dev):
        ref = LBK.component_labels_plain(X, tol)
        before, trips = LBK.LAUNCHES.value, LBK.LABEL_TRIPS.value
        out = LBK.component_labels(X, tol)
        torch.cuda.synchronize()
        assert LBK.LAUNCHES.value == before + 1
        assert LBK.LABEL_TRIPS.value == trips
        assert out.dtype == torch.int32 and out.is_cuda
        assert torch.equal(out, ref), (
            f"{tuple(X.shape)}: {int((out != ref).sum())} labels differ")


def test_tv2d_backward_on_the_card_runs_l1_without_host_sync(dev):
    """tv2d_prox's backward on the card: one L1 launch, no label trip and
    no host sync; L1's wrapper (and so the backward) takes float64 too
    (its double instantiation, counted apart), and raises for X and tol of
    two dtypes, for float16 and for a non-contiguous X."""
    from proxtv_tpu_torch.ops import diffprox
    from proxtv_tpu_torch.utils import debug

    _, _, y2, t2 = _diff_cells(dev)
    y = y2.clone().requires_grad_(True)
    x = diffprox.tv2d_prox(y, 0.3, "dr")
    loss = torch.mean((x - t2) ** 2)
    torch.cuda.synchronize()
    c0 = (LBK.LAUNCHES.value, LBK.LABEL_TRIPS.value, debug.HOST_SYNCS.value)
    (gy,) = torch.autograd.grad(loss, y)
    torch.cuda.synchronize()
    c1 = (LBK.LAUNCHES.value, LBK.LABEL_TRIPS.value, debug.HOST_SYNCS.value)
    assert (c1[0] - c0[0], c1[1] - c0[1], c1[2] - c0[2]) == (1, 0, 0)
    assert gy.is_cuda and bool(torch.isfinite(gy).all())
    X = x.detach().contiguous()
    tol = diffprox._seg_tol(X)
    f64 = LBK.LAUNCHES_F64.value
    gy64 = diffprox._bwd2(X.double(), X.double())
    torch.cuda.synchronize()
    assert LBK.LAUNCHES_F64.value == f64 + 1 and gy64.dtype == torch.float64
    with pytest.raises(TypeError):
        LBK.component_labels(X.double(), tol)
    with pytest.raises(TypeError):
        LBK.component_labels(X.half(), tol.half())
    with pytest.raises(ValueError):
        LBK.component_labels(X.transpose(1, 2), tol)
    assert LBK.LAUNCHES.value == c1[0]
    assert LBK.LAUNCHES_F64.value == f64 + 1


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


def test_banded_2d_world1_nccl_matches_the_single_card_solve(dev, tmp_path):
    """tv1_2d_banded on a one-rank NCCL mesh: B3 on the rank's band, the
    result on the card, rc 0, and the single-card cp-acc solve's objective
    by the certified-gap rule (F - F' <= gap + 1e-6 F' both ways); its
    first chunk against B3's plain version."""
    import torch.distributed as dist

    from proxtv_tpu_torch import parallel
    from proxtv_tpu_torch.models import tv2d

    rng = np.random.RandomState(5)
    Y = rng.randn(300, 260).astype(np.float32)
    seen = []
    launch = PPK.pdhg_chunk

    def tap(*a, **kw):
        if not seen:
            seen.append(([v.clone() if torch.is_tensor(v) else v for v in a],
                         dict(kw)))
        return launch(*a, **kw)

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = parallel.make_mesh()
        PPK.pdhg_chunk = tap
        try:
            b3 = PPK.LAUNCHES.value
            x, info = parallel.tv1_2d_banded(Y, 0.3, mesh)
            assert PPK.LAUNCHES.value > b3
        finally:
            PPK.pdhg_chunk = launch
    finally:
        dist.destroy_process_group()
    assert x.is_cuda and int(info.rc[0]) == 0
    xs, info_s = tv2d.tv1_2d_batched(torch.from_numpy(Y).to(dev)[None], 0.3,
                                     method="chambolle-pock-acc")

    def F(v):
        v = v.double().cpu().numpy()
        return (0.5 * np.sum((v - Y) ** 2)
                + 0.3 * (np.abs(np.diff(v, axis=0)).sum()
                         + np.abs(np.diff(v, axis=1)).sum()))

    Fb, Fs = F(x), F(xs[0])
    gb, gs = float(info.gap[0]), float(info_s.gap[0])
    assert Fb - Fs <= gb + 1e-6 * Fs and Fs - Fb <= gs + 1e-6 * Fs
    (a, kw), = seen
    out, ref = PPK.pdhg_chunk(*a, **kw), PPK.pdhg_chunk_plain(*a, **kw)
    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    assert err <= 1e-4, err


def test_banded_world2_gloo_shares_the_card(dev, tmp_path):
    """Two gloo ranks on one card run the banded 2D, 3D and long-1D solves:
    every rank gets the same whole result on the card, the kernels launch
    on each rank, halos travel through counted host copies, and each
    result meets the single-card solve (the certified-gap rule in 2D and
    3D, 1e-5 of the data's scale for the long signal)."""
    import torch_dist_worker as W
    from proxtv_tpu_torch.models import tv2d, tvnd
    from proxtv_tpu_torch.ops import tv1d_long

    rng = np.random.RandomState(6)
    inp = dict(Y=rng.randn(300, 260).astype(np.float32),
               V=rng.randn(16, 40, 48).astype(np.float32),
               y=(np.cumsum(rng.randn(20000)) * 0.05
                  + rng.randn(20000)).astype(np.float32))
    res = W.run("card", 2, str(tmp_path), timeout=600, **inp)
    out = res[0]
    for key in out:
        if not key.endswith("_counts"):
            np.testing.assert_array_equal(res[1][key], out[key], key)
    for r in res:
        for name in ("b2d", "b3d", "b1d"):
            launches, exchanges, staged = r[name + "_counts"]
            assert launches > 0 and exchanges > 0 and staged > 0, name
            assert int(r[name + "_rc"][0]) == 0, name
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    xs, info_s = tv2d.tv1_2d_batched(t(inp["Y"])[None], 0.3,
                                     method="chambolle-pock-acc")
    vs, info_v = tvnd.tv_nd_batched(t(inp["V"])[None], (0.3,) * 3, (1, 2, 3),
                                    (1.0,) * 3, method="chambolle-pock-acc")
    for name, Y, ref, g_ref in (("b2d", inp["Y"], xs[0], info_s.gap[0]),
                                ("b3d", inp["V"], vs[0], info_v.gap[0])):
        def F(v, Y=Y):
            v = np.asarray(v, np.float64)
            return (0.5 * np.sum((v - Y) ** 2)
                    + 0.3 * sum(np.abs(np.diff(v, axis=a)).sum()
                                for a in range(Y.ndim)))

        Fb, Fs = F(out[name]), F(ref.cpu().numpy())
        assert Fb - Fs <= float(out[name + "_gap"][0]) + 1e-6 * Fs, name
        assert Fs - Fb <= float(g_ref) + 1e-6 * Fs, name
    xl, _ = tv1d_long.tv1_long(t(inp["y"]), 0.7, chunk=1024, overlap=128)
    err = float(np.abs(out["b1d"] - xl.cpu().numpy()).max())
    assert err <= 1e-5 * float(np.abs(inp["y"]).max()), err


@pytest.mark.parametrize("method", ["dr", "chambolle-pock-acc", "kolmogorov"])
def test_cols_sharded_world1_nccl_matches_the_single_card_solve(method, dev,
                                                                tmp_path):
    """tv1_2d_sharded(shard_axis="cols") on a one-rank NCCL mesh: the result
    on the card within 1e-5 of the data's size of the single-card run of
    the same engine and sweep cap (for chambolle-pock-acc the unfused
    iteration, tv2d._run_pdhg, which the column split runs); dr and
    kolmogorov launch B1, chambolle-pock-acc none of B1, B3 and B6."""
    import torch.distributed as dist

    from proxtv_tpu_torch import parallel
    from proxtv_tpu_torch.models import tv2d
    from proxtv_tpu_torch.utils.config import DEFAULT_COMBINER as cfg

    rng = np.random.RandomState(7)
    Y = rng.randn(1, 300, 260).astype(np.float32)
    before = {k: m.LAUNCHES.value for k, m in (("B1", PPF), ("B3", PPK),
                                               ("B6", P3K))}
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        x, info = parallel.tv1_2d_sharded(Y, 0.3, parallel.make_mesh(),
                                          method=method, max_iters=100,
                                          shard_axis="cols")
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    got = {k: m.LAUNCHES.value - before[k]
           for k, m in (("B1", PPF), ("B3", PPK), ("B6", P3K))}
    if method == "chambolle-pock-acc":
        assert got == {"B1": 0, "B3": 0, "B6": 0}, got
    else:
        assert got["B1"] > 0 and got["B3"] == got["B6"] == 0, got
    assert x.is_cuda and info.iters.is_cuda
    Yt = torch.from_numpy(Y).to(dev)
    if method == "chambolle-pock-acc":
        lam = tv2d._scalar(0.3, torch.float32)
        ref, _ = tv2d._run_pdhg(Yt, lam, lam, 100, cfg.stop, cfg, "cp-acc")
    else:
        ref, _ = tv2d.tv1_2d_batched(Yt, 0.3, method=method, max_iters=100)
    err = float((x - ref).abs().max())
    assert err <= 1e-5 * float(np.abs(Y).max()), err


@pytest.mark.parametrize("case", ["windows 1568x6400", "per-edge 10000x1000"])
def test_pn_kernel_at_the_bench_long_and_per_edge_shapes(case, dev):
    """B1 against its plain version (both on the card) at two of bench.py's
    shapes: the long-signal route's 1568 windows of 6400 for a stream of 8
    signals of 10^6 at lam 0.7 (tol_eps = 0, as the route runs them), and
    10000 x 1000 with per-edge weights 0.5 + U[0, 1); the bars of
    test_pn_kernel_matches_plain (x and w within 2e-3, Newton counts at
    most 2 apart)."""
    from proxtv_tpu_torch.ops import tv1d_long as TL

    rng = np.random.RandomState(9)
    kw = {}
    if case.startswith("windows"):
        S, n, chunk, overlap = 8, 1_000_000, 5120, 640
        K, win = -(-n // chunk), chunk + 2 * overlap
        y = torch.from_numpy((np.cumsum(rng.randn(S, n), axis=1) * 0.05
                              + rng.randn(S, n)).astype(np.float32)).to(dev)
        Y = TL._windows(y, K, chunk, overlap).reshape(S * K, win)
        lam_w = TL._window_weights(torch.tensor(0.7, device=dev), False, S,
                                   K, chunk, overlap, win, 0, n - 1,
                                   torch.float32, dev)
        assert tuple(Y.shape) == (1568, 6400)
        kw["tol_eps"] = 0.0
    else:
        Y = torch.from_numpy(rng.randn(10000, 1000).astype(np.float32)).to(
            dev)
        lam_w = torch.from_numpy((0.5 + rng.rand(10000, 999)).astype(
            np.float32)).to(dev)
    lf = torch.cat([lam_w, lam_w.new_zeros((lam_w.shape[0], 1))], dim=1)
    ref, wref, it_ref = PPF.pn_tv1_fused_plain(Y, lf, tb=1, **kw)
    before = PPF.LAUNCHES.value
    x, w, it = PPF.pn_tv1_fused(Y, lf, return_iters=True, **kw)
    torch.cuda.synchronize()
    assert PPF.LAUNCHES.value == before + 1
    assert float((x - ref).abs().max()) <= 2e-3
    assert float((w - wref).abs().max()) <= 2e-3
    assert int((it - it_ref).abs().max()) <= 2


def test_pdhg_kernel_on_the_4k_canvas(dev):
    """B3 against its plain version on the 4K UHD (2160 x 3840) image's
    canvas: the cp-acc driver's third certificate chunk, mid-solve, taken
    from the driver (the four fields within 1e-4, the certificate sums
    within 1e-4 relative: the bars of test_pdhg_kernel_matches_plain)."""
    from proxtv_tpu_torch.models import tv2d

    Y = torch.from_numpy(np.random.RandomState(10).randn(1, 2160, 3840)
                         .astype(np.float32)).to(dev)
    seen = []
    launch = PPK.pdhg_chunk

    def tap(*a, **kw):
        out = launch(*a, **kw)
        if len(seen) < 3:
            seen.append(([v.clone() if torch.is_tensor(v) else v for v in a],
                         dict(kw)))
        return out

    PPK.pdhg_chunk = tap
    try:
        tv2d.tv1_2d_batched(Y, 0.3, method="chambolle-pock-acc",
                            max_iters=24)
    finally:
        PPK.pdhg_chunk = launch
    a, kw = seen[-1]
    assert a[1].shape[1] == 3840 and kw["cert"]
    ref = PPK.pdhg_chunk_plain(*a, **kw)
    out = PPK.pdhg_chunk(*a, **kw)
    torch.cuda.synchronize()
    for o, r in zip(out[:4], ref[:4]):
        assert float((o - r).abs().max()) <= 1e-4
    for o, r in zip(out[4:], ref[4:]):
        assert abs(float(o.sum()) - float(r.sum())) <= 1e-4 * abs(
            float(r.sum()))



# -- float64 on the card: B2, D1, D3 and D4 built in double -----------------

def _f64_rows(rng, B, n):
    """Float64 signals of a float64 card case: walks plus noise, and (B > 2)
    a constant row (degenerate: its mean); returns (y, degenerate rows)."""
    y = rng.randn(B, n) + np.cumsum(rng.randn(B, n), axis=1) * 0.1
    deg = []
    if B > 2:
        y[1] = y[1, 0]
        deg.append(1)
    return y, deg


def test_float64_thresholds_and_counters(dev):
    """Each float64 warp layout ends at its own n (D1 and D3 at 8192, half
    their float32 16384; D4 at 4741, the longest whose 20-byte double slots
    fit a block, and its ring layout at 23549), the float32 ones where
    they were; D2's float64 layouts take any n, one warp a signal to a
    batch of DP_WARP_MAX_B and one signal a lane past it, its deque in a
    ring of 64; D1's float64 batches of TS_GROUP_MIN_B signals or more run
    8 lanes a signal to n = 8192; a float32 launch counts in LAUNCHES and a
    float64 one in LAUNCHES_F64 only, L1's too."""
    from proxtv_tpu_torch.ops.kernels import classic_ts as CTK
    from proxtv_tpu_torch.ops.kernels import condat as CDK
    from proxtv_tpu_torch.ops.kernels import dp as DPK

    f64 = torch.float64
    assert (TSK.warp_max_n(), CDK.warp_max_n(), CTK.warp_max_n(),
            DPK.warp_max_n()) == (16384, 16384, 6280, 8192)
    assert (TSK.warp_max_n(f64), CDK.warp_max_n(f64),
            CTK.warp_max_n(f64), DPK.warp_max_n(f64)) == (8192, 8192, 4741,
                                                          None)
    assert CTK.ring_max_n() == 23549
    for edge in (False, True):
        assert DPK.warp_layout(1, 8192, edge)
        assert not DPK.warp_layout(1, 8193, edge)
        assert DPK.warp_layout(512, 1000, edge)
        assert not DPK.warp_layout(10000, 1000, edge)
        for n in (1000, 20000):
            assert DPK.layout(DP_WARP_MAX_B, n, edge, f64) == "warp"
            assert DPK.layout(DP_WARP_MAX_B + 1, n, edge, f64) != "warp"
    assert (DPK.ring_slots(), DPK.warp_max_b()) == (64, DP_WARP_MAX_B)
    assert TSK.group_limits() == (8, TS_GROUP_MIN_B)
    assert (TSK.lanes(TS_GROUP_MIN_B - 1, 1000), TSK.lanes(TS_GROUP_MIN_B,
                                                           1000),
            TSK.lanes(TS_GROUP_MIN_B, 8192), TSK.lanes(TS_GROUP_MIN_B, 8193),
            TSK.lanes(1, 8192), TSK.lanes(1, 8193)) == (32, 8, 8, 1, 32, 1)
    y = torch.randn((3, 100), dtype=f64, device=dev)
    for mod, fn in ((TSK, TSK.tautstring), (CDK, CDK.condat),
                    (CTK, CTK.classic_ts), (PK, PK.pcr_spd_solve),
                    (DPK, DPK.dp),
                    (LBK, lambda t, v: LBK.component_labels(
                        t[None].contiguous(), torch.full(
                            (1,), v, dtype=t.dtype, device=t.device)))):
        for t, hit in ((y.float(), "LAUNCHES"), (y, "LAUNCHES_F64")):
            before = (mod.LAUNCHES.value, mod.LAUNCHES_F64.value)
            out = fn(t) if mod is PK else fn(t, 0.5)
            torch.cuda.synchronize()
            assert out.dtype == (torch.int32 if mod is LBK else t.dtype)
            after = (mod.LAUNCHES.value, mod.LAUNCHES_F64.value)
            want = (1, 0) if hit == "LAUNCHES" else (0, 1)
            assert tuple(a - b for a, b in zip(after, before)) == want


@pytest.mark.parametrize("kernel", ["tautstring", "condat", "classic_ts",
                                    "dp"])
@pytest.mark.parametrize("case", ["64x1000", "row", "warp_max_n",
                                  "warp_max_n + 1"])
def test_direct_kernels_f64_match_plain(kernel, case, dev):
    """D1, D2, D3 and D4 in float64 against their float64 plain versions
    (on the CPU): bit for bit on every row the guards do not take (the same
    events in the same float64 roundings), within 1e-12 of the data's size
    on the rows they take (the mean summed in another order); on 64 x 1000
    at lam 0.7, per-signal weights (D1 and D2 also per edge), and one row
    each side of the float64 warp layout's end (one warp a signal up to
    warp_max_n(float64), one thread a signal past it; D4's deques then in
    the wrapper's float64 workspace; D2, whose float64 layouts take any n,
    at its float32 end, 8192 and 8193)."""
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.ops.kernels import classic_ts as CTK
    from proxtv_tpu_torch.ops.kernels import condat as CDK
    from proxtv_tpu_torch.ops.kernels import dp as DPK

    mod, plain = {"tautstring": (TSK, tv1d_l1.tv1_tautstring_plain),
                  "condat": (CDK, tv1d_l1.tv1_condat_plain),
                  "classic_ts": (CTK, tv1d_l1.tv1_classic_ts_plain),
                  "dp": (DPK, tv1d_l1.tv1_dp_plain)}[kernel]
    rng = np.random.RandomState(40 + len(case))
    lams = [0.7]
    if case == "64x1000":
        y, deg = _f64_rows(rng, 64, 1000)
    elif case == "row":
        y, deg = _f64_rows(rng, 37, 1000)
        lams = [torch.from_numpy(rng.rand(37) * 1.4)]
        if kernel in ("tautstring", "dp"):
            lams.append(torch.from_numpy(rng.rand(37, 999) * 1.4))
    else:  # D2's float64 layouts take any n: one past its float32 one
        n = (mod.warp_max_n(torch.float64) or DPK.warp_max_n()) \
            + case.endswith("+ 1")
        y, deg = _f64_rows(rng, 3, n)
    yt = torch.from_numpy(y)
    scale = max(1.0, float(np.abs(y).max()))
    rest = np.setdiff1d(np.arange(len(y)), deg)
    for lam in lams:
        before = mod.LAUNCHES_F64.value
        out = getattr(mod, kernel)(yt.to(dev), lam.to(dev)
                                   if torch.is_tensor(lam) else lam)
        torch.cuda.synchronize()
        assert mod.LAUNCHES_F64.value == before + 1
        out = out.cpu().numpy()
        ref = plain(yt, lam).numpy()
        np.testing.assert_array_equal(out[rest], ref[rest])
        np.testing.assert_allclose(out, ref, atol=1e-12 * scale, rtol=0)


@pytest.mark.parametrize("n", [2, 33, 128, 129, 256, 257, 512, 513, 999,
                               1024, 1025, 2048, 2049, 4096, 4097, 8192])
def test_pcr_kernel_f64_matches_plain(n, dev):
    """B2 in float64 at every edge of its layouts, plain, masked and
    shifted, against its float64 plain version (PCR, on the CPU): within
    1e-10 of the solution's size up to n = 1000, where the unmasked
    system's condition is ~4e5, and 1e-10 (n / 1000)^2 above it (the
    condition grows as n^2)."""
    rng = np.random.RandomState(n)
    B = 5
    d = torch.from_numpy(0.01 * rng.randn(B, n))
    mask = _pcr_masks(rng, B, n)
    sh = torch.from_numpy(rng.rand(B) + 0.5)
    bar = 1e-10 * max(1.0, (n / 1000) ** 2)
    for kw in ({}, {"mask": mask}, {"diag_shift": sh}):
        ref = PK.pcr_spd_solve_plain(d, **kw).numpy()
        before = PK.LAUNCHES_F64.value
        out = PK.pcr_spd_solve(d.to(dev), **{k: v.to(dev)
                                             for k, v in kw.items()})
        torch.cuda.synchronize()
        assert PK.LAUNCHES_F64.value == before + 1
        assert out.dtype == torch.float64
        np.testing.assert_allclose(
            out.cpu().numpy(), ref, rtol=0,
            atol=bar * max(1.0, float(np.abs(ref).max())), err_msg=str(kw))


def _pcr_f64_cases(rng, B, n):
    """Plain, masked (long runs) and shifted float64 systems of (B, n)."""
    d = torch.from_numpy(0.01 * rng.randn(B, n))
    return d, ({}, {"mask": _pcr_masks(rng, B, n)},
               {"diag_shift": torch.from_numpy(rng.rand(B) + 0.5)})


@pytest.mark.parametrize("B,n", [(4099, 2), (4099, 3), (4099, 31),
                                 (4099, 32), (4099, 33), (300, 255),
                                 (300, 256), (300, 257), (64, 512),
                                 (64, 513), (64, 1023), (64, 1024),
                                 (64, 1025)])
def test_pcr_f64_layout_edges(B, n, dev):
    """B2 in float64 through its wrapper at the edges of its layouts (the
    row layout, one thread a row, to n = 32; one warp a row to 256; the
    block layouts above, the staged E8W4s from 513 to 1024), on batches
    that leave a block part full: plain, masked and shifted within 1e-10
    of the solution's size of the float64 plain version, as
    test_pcr_kernel_f64_matches_plain."""
    rng = np.random.RandomState(7 * n + B)
    d, kws = _pcr_f64_cases(rng, B, n)
    bar = 1e-10 * max(1.0, (n / 1000) ** 2)
    for kw in kws:
        ref = PK.pcr_spd_solve_plain(d, **kw).numpy()
        before = PK.LAUNCHES_F64.value
        out = PK.pcr_spd_solve(d.to(dev), **{k: v.to(dev)
                                             for k, v in kw.items()})
        torch.cuda.synchronize()
        assert PK.LAUNCHES_F64.value == before + 1
        np.testing.assert_allclose(
            out.cpu().numpy(), ref, rtol=0,
            atol=bar * max(1.0, float(np.abs(ref).max())),
            err_msg=f"{PK.layout_f64(n)} {list(kw)}")


def test_pcr_f64_every_layout_matches_plain(dev):
    """Each float64 layout of B2 (``pcr.layouts_f64``), forced through
    ``bind(layout=...)`` at n = 2, 31 and its longest n, B = 7: plain,
    masked and shifted within the bar of test_pcr_kernel_f64_matches_plain
    of the float64 plain version; each n takes the first layout that
    covers it; a layout named for a float32 batch or past its longest n
    raises."""
    layouts = PK.layouts_f64()
    assert list(layouts) == ["rows", "E4W1", "E8W1", "E8W2", "E8W4s",
                             "E8W8", "E8W16", "E16W16"]
    assert [PK.layout_f64(n) for n in (32, 33, 1024, 1025, 8192)] == [
        "rows", "E4W1", "E8W4s", "E8W8", "E16W16"]
    for name, top in layouts.items():
        for n in sorted({2, min(31, top), top}):
            rng = np.random.RandomState(n)
            d, kws = _pcr_f64_cases(rng, 7, n)
            bar = 1e-10 * max(1.0, (n / 1000) ** 2)
            for kw in kws:
                ref = PK.pcr_spd_solve_plain(d, **kw).numpy()
                out, launch = PK.bind(d.to(dev), layout=name,
                                      **{k: v.to(dev) for k, v in kw.items()})
                launch()
                torch.cuda.synchronize()
                np.testing.assert_allclose(
                    out.cpu().numpy(), ref, rtol=0,
                    atol=bar * max(1.0, float(np.abs(ref).max())),
                    err_msg=f"{name} n={n} {list(kw)}")
    with pytest.raises(ValueError):
        PK.bind(torch.zeros((2, 8), device=dev), layout="rows")
    out, launch = PK.bind(torch.zeros((2, 33), dtype=torch.float64,
                                      device=dev), layout="rows")
    with pytest.raises(RuntimeError):
        launch()


def test_pcr_f64_composes_past_its_lane_limit(dev):
    """Past n = 8192 a float64 system takes the composition the JAX package
    runs there (its XLA pcr_solve) on the card, as float32 does: no B2
    launch, the same values as on the CPU."""
    from proxtv_tpu_torch.ops import tridiag

    rng = np.random.RandomState(9)
    d = torch.from_numpy(0.01 * rng.randn(2, 8193))
    before = PK.LAUNCHES_F64.value + PK.LAUNCHES.value
    out = tridiag.spd_second_difference_solve(d.to(dev))
    torch.cuda.synchronize()
    assert PK.LAUNCHES_F64.value + PK.LAUNCHES.value == before
    ref = tridiag.spd_second_difference_solve(d)
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=1e-9 * float(ref.abs().max()))


@pytest.mark.parametrize("method", ["hybridtautstring", "condat",
                                    "classictautstring", "pn"])
def test_tv1_batched_float64_routes_on_the_card(method, dev, monkeypatch):
    """A float64 CUDA batch takes the JAX package's float64 route, strict or
    not: the named engine's kernel in float64 (D1, D3, D4; pn: tv1_pn with
    its systems on B2 in float64), never B1 and never a kernel's plain
    version on the card; against the same call in float64 on the CPU
    (1e-12 of the data's size the direct engines, 5e-4 pn)."""
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.ops.kernels import classic_ts as CTK
    from proxtv_tpu_torch.ops.kernels import condat as CDK

    _no_plain_on_the_card(monkeypatch)
    own = {"hybridtautstring": TSK, "condat": CDK,
           "classictautstring": CTK, "pn": PK}[method]
    rng = np.random.RandomState(12)
    Y = rng.randn(40, 700) + np.cumsum(rng.randn(40, 700), axis=1) * 0.1
    for strict in (False, True):
        b1, o = PPF.LAUNCHES.value, own.LAUNCHES_F64.value
        x = tv1d_l1.tv1_batched(torch.from_numpy(Y).to(dev), 0.7,
                                method=method, strict=strict)
        torch.cuda.synchronize()
        assert PPF.LAUNCHES.value == b1 and own.LAUNCHES_F64.value > o
        if method != "pn":
            assert own.LAUNCHES_F64.value == o + 1
        ref = tv1d_l1.tv1_batched(torch.from_numpy(Y), 0.7, method=method,
                                  strict=strict)
        bar = 5e-4 if method == "pn" else 1e-12 * float(np.abs(Y).max())
        np.testing.assert_allclose(x.cpu().numpy(), ref.numpy(), atol=bar,
                                   rtol=0)


@pytest.mark.parametrize("case", ["ring overrun", "ring_max_n",
                                  "ring_max_n + 1"])
def test_classic_ts_f64_ring_and_thread_layouts(case, dev):
    """D4 in float64 past its warp layout, bit for bit with its float64
    plain version (on the CPU): the ring layout (each deque in a ring of
    512 slots) on a ramp whose minorant holds 896 segments, which
    overflows its ring, so the warp runs the signal again with its deques
    in the workspace (tools/classic_ts_depths.py), at its longest n, and
    the thread layout one past it."""
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.ops.kernels import classic_ts as CTK

    if case == "ring overrun":
        y, lam = np.linspace(0.0, 30.0, 6000)[None], 1000.0
    else:
        n = CTK.ring_max_n() + case.endswith("+ 1")
        y, _ = _f64_rows(np.random.RandomState(n), 1, n)
        lam = 0.7
    before = CTK.LAUNCHES_F64.value
    out = CTK.classic_ts(torch.from_numpy(y).to(dev), lam)
    torch.cuda.synchronize()
    assert CTK.LAUNCHES_F64.value == before + 1
    ref = tv1d_l1.tv1_classic_ts_plain(torch.from_numpy(y), lam).numpy()
    np.testing.assert_array_equal(out.cpu().numpy(), ref)


def test_classic_ts_f64_on_the_long_walk(dev):
    """D4 in float64 on the n = 11621 walk of ROADMAP C (seed 15, lam 1.3;
    its thread layout): within 1e-9 of the float64 host taut string, where
    float32 lands 8.97e-3 (its tube's float32 prefix sums)."""
    from proxtv_tpu_torch.ops.kernels import classic_ts as CTK
    from proxtv_tpu_torch.runtime import native

    n = 11621
    rng = np.random.RandomState(15)
    y = np.cumsum(rng.randn(n)) * 0.3 + rng.randn(n)
    x = CTK.classic_ts(torch.from_numpy(y[None]).to(dev), 1.3)
    torch.cuda.synchronize()
    assert native.available()
    ref = native.tv1_host(y, 1.3)
    np.testing.assert_allclose(x.cpu().numpy()[0], ref, atol=1e-9, rtol=0)


def _f64_layout_case(rng, B, n, kind):
    """Float64 signals and weights of a D1 / D2 layout case: walks plus
    noise and, B > 2, a constant row (its mean); the weights scalar, per
    signal or per edge (U[0, 1.4], 5% zeroed; with B > 3 a zero-weight row,
    the identity, and a huge one, the mean), all zero or huge.  Returns
    (y, lam, degenerate rows)."""
    y, deg = _f64_rows(rng, B, n)
    if kind == "scalar":
        return y, 0.7, deg
    if kind == "zero":
        return y, torch.zeros((B, n - 1), dtype=torch.float64), list(range(B))
    if kind == "huge":
        return y, 1e7, list(range(B))
    w = rng.rand(B) * 1.4 if kind == "row" else rng.rand(B, n - 1) * 1.4
    if kind == "edge":
        w[rng.rand(B, n - 1) < 0.05] = 0.0
    if B > 3:
        w[0], w[2] = 0.0, 1e7
        deg += [0, 2]
    return y, torch.from_numpy(w), sorted(set(deg))


# D1's and D2's float64 batch rules (csrc/tautstring.cu kGroup64MinB,
# csrc/dp.cu kWarp64MaxB), which the thresholds test holds the library to.
TS_GROUP_MIN_B, DP_WARP_MAX_B = 3960, 2640


@pytest.mark.parametrize("kind", ["scalar", "row", "edge", "zero", "huge"])
@pytest.mark.parametrize("B", [1, 31, 32, 33, 132, 133])
@pytest.mark.parametrize("kernel,layout", [
    ("dp", "warp"), ("dp", "lane"), ("dp", "lane16"), ("dp", "lane8"),
    ("dp", "lane4"), ("tautstring", 32), ("tautstring", 8)])
def test_direct_f64_layouts_match_plain_bit_for_bit(kernel, layout, B, kind,
                                                    dev):
    """D2's float64 layouts (one warp a signal; one signal a lane, 32, 16,
    8 or 4 signals a warp) and D1's float64 layouts (32 lanes a signal, y
    staged; 8 lanes a signal, y from global memory), each forced through
    ``bind``, bit for bit with the float64 plain version on every row the
    guards do not take, within 1e-12 of the data's size on the rows they
    take (the mean summed in another order): scalar, per-signal,
    per-edge, zero and huge weights, at B = 1, 31, 32, 33, 132 and 133
    (n = 200)."""
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.ops.kernels import dp as DPK

    mod, plain, kw = {
        "dp": (DPK, tv1d_l1.tv1_dp_plain, {"layout": layout}),
        "tautstring": (TSK, tv1d_l1.tv1_tautstring_plain,
                       {"lanes": layout})}[kernel]
    n = 200
    y, lam, deg = _f64_layout_case(np.random.RandomState(B + n), B, n, kind)
    out, launch = mod.bind(torch.from_numpy(y).to(dev), lam.to(dev)
                           if torch.is_tensor(lam) else lam, **kw)
    launch()
    torch.cuda.synchronize()
    out = out.cpu().numpy()
    ref = plain(torch.from_numpy(y), lam).numpy()
    rest = np.setdiff1d(np.arange(B), deg)
    np.testing.assert_array_equal(out[rest], ref[rest])
    np.testing.assert_allclose(out, ref, atol=1e-12 * max(
        1.0, float(np.abs(y).max())), rtol=0)


@pytest.mark.parametrize("kernel,side", [
    ("dp", "warp"), ("dp", "lane"), ("dp", "10000"),
    ("tautstring", "batch below"), ("tautstring", "batch")])
def test_direct_f64_batch_rules_match_plain_bit_for_bit(kernel, side, dev):
    """D2 and D1 in float64 through their wrappers on each side of their
    batch rules (D2: warp_max_b() signals on one warp a signal, one more on
    the lane layout, and 10000 signals; D1: one signal below the smallest
    batch of its layout for large batches on 32 lanes a signal, that batch
    on its lanes), bit for bit with the float64 plain version on 40 spread
    rows (the rows are independent)."""
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.ops.kernels import dp as DPK

    g_l, g_b = TSK.group_limits()
    n = 1000
    if kernel == "dp":
        B = {"warp": DPK.warp_max_b(), "lane": DPK.warp_max_b() + 1,
             "10000": 10000}[side]
        assert (DPK.layout(B, n, False, torch.float64) == "warp") == (
            side == "warp")
    else:
        B = g_b - (side == "batch below")
        assert TSK.lanes(B, n) == (g_l if side == "batch" else 32)
    y, _ = _f64_rows(np.random.RandomState(B + n), B, n)
    mod, fn, plain = {"dp": (DPK, DPK.dp, tv1d_l1.tv1_dp_plain),
                      "tautstring": (TSK, TSK.tautstring,
                                     tv1d_l1.tv1_tautstring_plain)}[kernel]
    before = mod.LAUNCHES_F64.value
    out = fn(torch.from_numpy(y).to(dev), 0.7)
    torch.cuda.synchronize()
    assert mod.LAUNCHES_F64.value == before + 1
    rows = np.unique(np.linspace(2, B - 1, 40).astype(int))
    ref = plain(torch.from_numpy(y[rows]), 0.7).numpy()
    np.testing.assert_array_equal(out.cpu().numpy()[rows], ref)


@pytest.mark.parametrize("layout", ["warp", "lane"])
def test_dp_f64_ring_overflow_runs_again(layout, dev):
    """D2 in float64 on the signal whose deque outgrows its ring of 64
    slots (a ramp of 1000 from 0 to 1 at lam 2: 91 breakpoints at once,
    tools/dp_depths.py overflow_signal), in a batch of 40 among randn rows
    at lam 2 on each layout: the ramp's rows run again from the workspace,
    counted in RING_RERUNS (and no other row), and every row is bit for
    bit with the float64 plain version."""
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.ops.kernels import dp as DPK

    rng = np.random.RandomState(64)
    y = rng.randn(40, 1000)
    ramp = [3, 17, 39]
    y[ramp] = np.linspace(0.0, 1.0, 1000)
    DPK.RING_RERUNS.reset()
    out, launch = DPK.bind(torch.from_numpy(y).to(dev), 2.0, layout=layout)
    launch()
    torch.cuda.synchronize()
    assert DPK.RING_RERUNS.value == len(ramp)
    ref = tv1d_l1.tv1_dp_plain(torch.from_numpy(y), 2.0).numpy()
    np.testing.assert_array_equal(out.cpu().numpy(), ref)


def test_direct_f64_missing_entry_raises(dev, monkeypatch):
    """A float64 launch of D1 or D2 whose C entry the library lacks raises;
    no wrapper falls back to its plain version on a CUDA tensor."""
    from proxtv_tpu_torch.ops.kernels import build
    from proxtv_tpu_torch.ops.kernels import dp as DPK

    lib = build.lib()

    class Lacking:
        def __getattr__(self, name):
            if name in ("dp_tv1_f64", "tautstring_tv1_f64"):
                raise AttributeError(name)
            return getattr(lib, name)

    monkeypatch.setattr(build, "lib", lambda: Lacking())
    y = torch.randn((3, 50), dtype=torch.float64, device=dev)
    for fn in (DPK.dp, TSK.tautstring):
        with pytest.raises(AttributeError):
            fn(y, 0.7)


@pytest.mark.parametrize("method", ["dr", "pd", "yang", "kolmogorov",
                                    "condat", "chambolle-pock",
                                    "chambolle-pock-acc"])
def test_tv1_2d_batched_float64_on_the_card(method, dev, monkeypatch):
    """Every 2D method on a float64 CUDA image takes the JAX package's
    float64 route: the fiber methods tv1_pn on B2 in float64 (no B1), the
    primal-dual methods the unfused iteration (no B3, no B2); within 1e-6 of
    the same call in float64 on the CPU."""
    from proxtv_tpu_torch.models import tv2d

    _no_plain_on_the_card(monkeypatch)
    rng = np.random.RandomState(13)
    Y = rng.randn(2, 40, 36)
    b1, b3, b2 = (PPF.LAUNCHES.value, PPK.LAUNCHES.value,
                  PK.LAUNCHES_F64.value)
    x, info = tv2d.tv1_2d_batched(torch.from_numpy(Y).to(dev), 0.35,
                                  method=method)
    torch.cuda.synchronize()
    assert PPF.LAUNCHES.value == b1 and PPK.LAUNCHES.value == b3
    fibers = method in ("dr", "pd", "yang", "kolmogorov")
    assert (PK.LAUNCHES_F64.value > b2) == fibers
    ref, info_ref = tv2d.tv1_2d_batched(torch.from_numpy(Y), 0.35,
                                        method=method)
    np.testing.assert_allclose(x.cpu().numpy(), ref.numpy(), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(info.iters.cpu().numpy(),
                                  info_ref.iters.numpy())


@pytest.mark.parametrize("kind", ["pdhg3d", "banded2d", "banded3d", "B1",
                                  "B3", "L1"])
def test_float64_queued_kinds_raise_on_the_card(kind, dev):
    """What refuses float64 on the card: the ND primal-dual methods raise
    the JAX package's own error (no float64 primal-dual ND route), the
    banded 2D and 3D drivers raise naming B3 and B6 before any exchange
    (the JAX package's banded drivers take float32 only), and the wrappers
    with no double instantiation (B1, B3) refuse one handed to them; L1,
    built in double since, takes it (one LAUNCHES_F64)."""
    from proxtv_tpu_torch.models import tvnd
    from proxtv_tpu_torch.parallel import sharded
    from proxtv_tpu_torch.parallel.comm import Mesh

    y = torch.randn((3, 40), dtype=torch.float64, device=dev)
    if kind == "L1":
        before = LBK.LAUNCHES_F64.value
        lab = LBK.component_labels(
            y[None], torch.zeros(1, dtype=torch.float64, device=dev))
        torch.cuda.synchronize()
        assert LBK.LAUNCHES_F64.value == before + 1
        assert lab.dtype == torch.int32 and lab.is_cuda
        return
    mesh = Mesh(group=None, axis="x", device=dev)
    calls = {
        "pdhg3d": (lambda: tvnd.tv_nd_batched(
            torch.randn((1, 3, 4, 5), dtype=torch.float64, device=dev),
            (0.3,) * 3, (1, 2, 3), (1.0,) * 3, method="chambolle-pock-acc"),
            "primal-dual ND methods need"),
        "banded2d": (lambda: sharded.tv1_2d_banded(
            np.zeros((64, 64)), 0.3, mesh), "B3"),
        "banded3d": (lambda: sharded.tv1_3d_banded(
            np.zeros((8, 16, 16)), 0.3, mesh), "B6"),
        "B1": (lambda: PPF.pn_tv1_fused(y, lam_scalar=0.5), "PN kernel"),
        "B3": (lambda: PPK.pdhg_chunk(
            torch.zeros((8, 4), device=dev),
            *([torch.zeros((32, 128), dtype=torch.float64, device=dev)] * 5),
            8, 32, 128, 32, 128, 1), "PDHG"),
    }
    fn, name = calls[kind]
    b6 = P3K.LAUNCHES.value
    with pytest.raises((ValueError, TypeError)) as e:
        fn()
    assert name in str(e.value)
    assert P3K.LAUNCHES.value == b6
    if kind.startswith("banded"):
        assert "banded driver takes float32 only" in str(e.value)


@pytest.mark.parametrize("case", ["p0.5", "serpentine", "B = 3 mixed",
                                  "1024x1000 p0.5", "T2 dr"])
def test_label_kernel_f64_matches_plain(case, dev):
    """L1 in float64 against its float64 plain version on the card's
    fields in double (tests/torch_label_fields.py's seeded fields, the
    serpentine and its transpose at tile +-1 sizes, a mixed batch, 1024 x
    1000, and a float64 dr solution): the int32 labels bit for bit, one
    LAUNCHES_F64 a call, no label trip."""
    from proxtv_tpu_torch.ops import diffprox

    if case == "T2 dr":
        _, _, y2, _ = _diff_cells(dev)
        X = diffprox.tv2d_prox(y2.double(), 0.3, "dr").contiguous()
        fields = [(X, diffprox._seg_tol(X))]
    else:
        fields = [(X.double(), diffprox._seg_tol(X.double()))
                  for X, _ in _label_cases(case, dev)]
    for X, tol in fields:
        assert X.dtype == torch.float64
        ref = LBK.component_labels_plain(X, tol)
        before, trips = LBK.LAUNCHES_F64.value, LBK.LABEL_TRIPS.value
        out = LBK.component_labels(X, tol)
        torch.cuda.synchronize()
        assert LBK.LAUNCHES_F64.value == before + 1
        assert LBK.LABEL_TRIPS.value == trips
        assert torch.equal(out, ref), (
            f"{tuple(X.shape)}: {int((out != ref).sum())} labels differ")


def _f64_layer_counts():
    from proxtv_tpu_torch.ops.kernels import dp as DPK
    from proxtv_tpu_torch.ops.kernels import lp_fused as LPK

    return {"B1": PPF.LAUNCHES.value, "B3": PPK.LAUNCHES.value,
            "B4": MSK.LAUNCHES.value, "B5": LPK.LAUNCHES.value,
            "B6": P3K.LAUNCHES.value, "B2.f64": PK.LAUNCHES_F64.value,
            "D2.f64": DPK.LAUNCHES_F64.value, "L1.f64": LBK.LAUNCHES_F64.value}


@pytest.mark.parametrize("layer", ["dp", "tv2_ms", "tv2_mspg", "tvp_gpfw",
                                   "tvp_fista", "tvp_2d", "tv_nd_pd",
                                   "tv1_long", "tv2d_backward"])
def test_float64_layers_on_the_card(layer, dev, monkeypatch):
    """The float64 route of the layers above TV-L1 on a float64 CUDA
    tensor: the DP's names on D2 in float64; TV-L2 on the More-Sorensen
    composition (B4 never) with its shifted solves on B2 in float64; TV-Lp
    on its compositions (B5 never; the setup solve on B2 in float64); the
    2D and ND combiners over them; the long route's windows by tv1_pn on
    B2 in float64 (B1 never); tv2d_prox's backward on L1 in float64.  No
    kernel's plain version runs on the card.  Each against the same call
    in float64 on the CPU: the DP at 1e-12 of the data's size, TV-L2 and
    TV-Lp at 1e-8, the 2D and ND combiners (the ND one with a TV-Lp term)
    and the long route at 1e-6 (chip_smoke.py TOL64["combiner"]), the
    backward at 1e-10 relative."""
    from proxtv_tpu_torch.models import tv2d, tvnd
    from proxtv_tpu_torch.ops import diffprox, tv1d_l1, tv1d_l2, tv1d_long
    from proxtv_tpu_torch.ops import tv1d_lp

    _no_plain_on_the_card(monkeypatch)
    rng = np.random.RandomState(21)
    Y = rng.randn(24, 300) + np.cumsum(rng.randn(24, 300), axis=1) * 0.2
    img = rng.randn(2, 48, 40)
    vol = rng.randn(1, 6, 20, 24)
    walk = np.cumsum(rng.randn(1, 20000), axis=1) * 0.05 + rng.randn(1, 20000)
    lams = rng.rand(24) * 3
    calls = {
        "dp": (lambda d: tv1d_l1.tv1_batched(
            torch.from_numpy(Y).to(d), 0.7, method="kolmogorov",
            strict=True), {"D2.f64"}, 1e-12),
        "tv2_ms": (lambda d: tv1d_l2.tv2_ms(torch.from_numpy(Y).to(d),
                                            torch.from_numpy(lams).to(d))[0],
                   {"B2.f64"}, 1e-8),
        "tv2_mspg": (lambda d: tv1d_l2.tv2_batched(
            torch.from_numpy(Y).to(d), 1.0)[0], {"B2.f64"}, 1e-8),
        "tvp_gpfw": (lambda d: tv1d_lp.tvp_batched(
            torch.from_numpy(Y[:8]).to(d), 0.7, 1.5)[0], {"B2.f64"}, 1e-8),
        "tvp_fista": (lambda d: tv1d_lp.tvp_batched(
            torch.from_numpy(Y[:8]).to(d), 0.7, 3.0, method="fista")[0],
            {"B2.f64"}, 1e-8),
        "tvp_2d": (lambda d: tv2d.tvp_2d_batched(
            torch.from_numpy(img).to(d), 0.3, 0.3, 2.0, 2.0,
            max_iters=20)[0], {"B2.f64"}, 1e-6),
        "tv_nd_pd": (lambda d: tvnd.tv_nd_batched(
            torch.from_numpy(vol).to(d), (0.3, 0.3, 0.3), (1, 2, 3),
            (1.0, 2.0, 1.5), max_iters=15)[0], {"B2.f64"}, 1e-6),
        "tv1_long": (lambda d: tv1d_long.tv1_long(
            torch.from_numpy(walk).to(d), 0.7)[0], {"B2.f64"}, 1e-6),
    }
    if layer == "tv2d_backward":
        X = torch.from_numpy(img)
        x = tv2d.tv1_2d_batched(X.to(dev), 0.3, method="dr")[0]
        g = torch.from_numpy(rng.randn(*img.shape))
        c0 = _f64_layer_counts()
        out = diffprox._bwd2(x, g.to(dev))
        torch.cuda.synchronize()
        c1 = _f64_layer_counts()
        assert {k for k in c0 if c1[k] != c0[k]} == {"L1.f64"}
        assert c1["L1.f64"] == c0["L1.f64"] + 1
        ref = diffprox._bwd2(x.cpu(), g)
        err = float((out.cpu() - ref).abs().max())
        assert err <= 1e-10 * float(ref.abs().max()), err
        return
    fn, moved, bar = calls[layer]
    c0 = _f64_layer_counts()
    out = fn(dev)
    torch.cuda.synchronize()
    c1 = _f64_layer_counts()
    assert {k for k in c0 if c1[k] != c0[k]} == moved, (c0, c1)
    assert out.is_cuda and out.dtype == torch.float64
    ref = fn(torch.device("cpu"))
    scale = max(1.0, float(ref.abs().max()))
    err = float((out.cpu() - ref).abs().max())
    assert err <= bar * scale, err


def test_float64_two_sample_signals_on_the_card(dev, monkeypatch):
    """Signals of two samples on a float64 CUDA batch: tv1_pn, TV-L2 and
    TV-Lp solve their one-lane systems in closed form, as the JAX
    package does below the PCR kernel's lower limit (no kernel launch, no
    kernel's plain version on the card), and tvp_2d_batched on a 2 x 9
    image runs its columns so and its rows on B2 in float64; within 1e-10
    (the 1D calls) and 1e-8 (TV-L2 and TV-Lp's bar, the image) of the
    same call in float64 on the CPU."""
    from proxtv_tpu_torch.models import tv2d
    from proxtv_tpu_torch.ops import tv1d_l1, tv1d_l2, tv1d_lp

    _no_plain_on_the_card(monkeypatch)
    rng = np.random.RandomState(12)
    Y = torch.from_numpy(rng.randn(8, 2) * 2)
    X = torch.from_numpy(rng.randn(1, 2, 9))
    for fn, moved, bar in (
            (lambda d: tv1d_l1.tv1_pn(Y.to(d), 0.3)[0], set(), 1e-10),
            (lambda d: tv1d_l2.tv2_batched(Y.to(d), 0.8)[0], set(), 1e-10),
            (lambda d: tv1d_lp.tvp_batched(Y.to(d), 0.8, 1.5)[0], set(),
             1e-10),
            *((lambda d, p=p: tv2d.tvp_2d_batched(X.to(d), 0.3, 0.2, p,
                                                   p)[0], {"B2.f64"}, 1e-8)
              for p in (1.0, 2.0, 1.5))):
        c0 = _f64_layer_counts()
        out = fn(dev)
        torch.cuda.synchronize()
        c1 = _f64_layer_counts()
        assert {k for k in c0 if c1[k] != c0[k]} == moved, (c0, c1)
        assert out.is_cuda and out.dtype == torch.float64
        ref = fn(torch.device("cpu"))
        err = float((out.cpu() - ref).abs().max())
        assert err <= bar * max(1.0, float(ref.abs().max())), err


def test_tv1_prox_float64_on_the_card(dev):
    """The differentiable 1D prox on a float64 CUDA batch: its forward takes
    the float64 route (tv1_pn on B2 in float64, no B1) and its backward is
    tensor ops; the output within 5e-4 and the input's gradient within 1e-6
    of the same step in float64 on the CPU."""
    from proxtv_tpu_torch.ops import diffprox

    rng = np.random.RandomState(17)
    Y = rng.randn(8, 200) + np.cumsum(rng.randn(8, 200), axis=1) * 0.2
    out = {}
    for d in (dev, torch.device("cpu")):
        y = torch.from_numpy(Y).to(d).requires_grad_(True)
        b1, b2 = PPF.LAUNCHES.value, PK.LAUNCHES_F64.value
        x = diffprox.tv1_prox(y, 0.5)
        (x ** 2).sum().backward()
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert PPF.LAUNCHES.value == b1 and PK.LAUNCHES_F64.value > b2
        out[d.type] = (x.detach().cpu().numpy(), y.grad.cpu().numpy())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=5e-4,
                               rtol=0)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], atol=1e-6,
                               rtol=0)


# -- the numpy API in float64 on the card (torch's default dtype float64) --

@pytest.fixture
def default64():
    """torch's default dtype float64 for the test (the API then solves in
    float64 on the card), restored after it."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(before)


def _all_counts():
    """Every kernel's launch counter: float32 (``B1`` ...) and, where built
    in double, float64 (``B2.f64`` ...)."""
    from proxtv_tpu_torch.ops.kernels import classic_ts as CTK
    from proxtv_tpu_torch.ops.kernels import condat as CDK
    from proxtv_tpu_torch.ops.kernels import dp as DPK
    from proxtv_tpu_torch.ops.kernels import lp_fused as LPK

    mods = {"B1": PPF, "B2": PK, "B3": PPK, "B4": MSK, "B5": LPK, "B6": P3K,
            "D1": TSK, "D2": DPK, "D3": CDK, "D4": CTK, "L1": LBK}
    out = {k: m.LAUNCHES.value for k, m in mods.items()}
    out.update({k + ".f64": m.LAUNCHES_F64.value for k, m in mods.items()
                if hasattr(m, "LAUNCHES_F64")})
    return out


def _api64_cases():
    """name -> (API call, the batched call it wraps on a tensor ``t`` of the
    same input (a function of the device), the kernels its float64 route
    launches, chip_smoke.py's TOL64 bar of its family against the same
    call with device="cpu", relative to max|y|)."""
    import proxtv_tpu_torch as P
    from proxtv_tpu_torch.models import tv2d, tvnd
    from proxtv_tpu_torch.ops import tv1d_l1, tv1d_l2, tv1d_long, tv1d_lp
    from proxtv_tpu_torch.utils.config import TV1Config

    rng = np.random.RandomState(50)
    y = np.cumsum(rng.randn(300)) * 0.3 + 0.2 * rng.randn(300)
    w = rng.rand(299) * 1.5
    ylong = np.cumsum(rng.randn(20000)) * 0.3 + rng.randn(20000)
    y9 = np.cumsum(rng.randn(9000)) * 0.05 + rng.randn(9000)
    X = rng.randn(64, 64)
    Wc, Wr = 0.3 * (0.5 + rng.rand(63, 64)), 0.3 * (0.5 + rng.rand(64, 63))
    V = rng.randn(4, 16, 16)
    cfg = TV1Config(sigma=0.05)

    def t(a, d):
        return torch.from_numpy(np.ascontiguousarray(a)).to(d)

    b1 = lambda fn: (lambda d: fn(d)[0])  # noqa: E731  the row of a batch
    return {
        "tv1_1d auto": (lambda **k: P.tv1_1d(y, 2.0, **k), b1(
            lambda d: tv1d_l1.tv1_batched(t(y[None], d), 2.0, strict=False)),
            {"D1.f64"}, 1e-12),
        "tv1_1d auto long": (lambda **k: P.tv1_1d(ylong, 2.0, **k),
                             lambda d: tv1d_long.tv1_long(t(ylong, d),
                                                          2.0)[0],
                             {"B2.f64"}, 1e-6),
        "tv1_1d pn": (lambda **k: P.tv1_1d(y, 2.0, method="pn", **k), b1(
            lambda d: tv1d_l1.tv1_pn(t(y[None], d), 2.0, cfg=cfg)[0]),
            {"B2.f64"}, 5e-4),
        **{f"tv1_1d {m}": (lambda m=m, **k: P.tv1_1d(y, 2.0, method=m, **k),
                           b1(lambda d, m=m: tv1d_l1.tv1_batched(
                               t(y[None], d), 2.0, method=m, strict=True)),
                           {kid}, 1e-12)
           for m, kid in (("condat", "D3.f64"),
                          ("classictautstring", "D4.f64"),
                          ("dp", "D2.f64"))},
        "tv1w_1d auto": (lambda **k: P.tv1w_1d(y, w, **k), b1(
            lambda d: tv1d_l1.tv1_tautstring(t(y[None], d), t(w[None], d))),
            {"D1.f64"}, 1e-12),
        "tv1w_1d dp": (lambda **k: P.tv1w_1d(y, w, method="dp", **k), b1(
            lambda d: tv1d_l1.tv1_dp(t(y[None], d), t(w[None], d))),
            {"D2.f64"}, 1e-12),
        "tv1w_1d pn": (lambda **k: P.tv1w_1d(y, w, method="pn", **k), b1(
            lambda d: tv1d_l1.tv1_pn(t(y[None], d), t(w[None], d),
                                     cfg=cfg)[0]), {"B2.f64"}, 5e-4),
        "tv2_1d": (lambda **k: P.tv2_1d(y, 2.0, **k), b1(
            lambda d: tv1d_l2.tv2_batched(t(y[None], d), 2.0,
                                          method="mspg")[0]),
            {"B2.f64"}, 1e-8),
        "tv2_1d ms spectral": (lambda **k: P.tv2_1d(y9, 50.0, method="ms",
                                                    **k), b1(
            lambda d: tv1d_l2.tv2_batched(t(y9[None], d), 50.0,
                                          method="ms")[0]), set(), 1e-8),
        "tvp_1d": (lambda **k: P.tvp_1d(y, 2.0, 1.5, **k), b1(
            lambda d: tv1d_lp.tvp_batched(t(y[None], d), 2.0, 1.5)[0]),
            {"B2.f64"}, 1e-8),
        "tv1_2d auto": (lambda **k: P.tv1_2d(X, 0.3, **k), b1(
            lambda d: tv2d.tv1_2d_batched(t(X[None], d), 0.3,
                                          method="dr")[0]),
            {"B2.f64"}, 1e-6),
        "tv1w_2d": (lambda **k: P.tv1w_2d(X, Wc, Wr, **k), b1(
            lambda d: tv2d.tv1w_2d_batched(t(X[None], d), t(Wc[None], d),
                                           t(Wr[None], d))[0]),
            {"B2.f64"}, 1e-6),
        "tvp_2d p2": (lambda **k: P.tvp_2d(X, 0.3, 0.3, 2, 2, **k), b1(
            lambda d: tv2d.tvp_2d_batched(t(X[None], d), 0.3, 0.3, 2.0,
                                          2.0)[0]), {"B2.f64"}, 1e-6),
        "tvp_2d p1.5": (lambda **k: P.tvp_2d(X, 0.3, 0.3, 1.5, 1.5,
                                             max_iters=35, **k), b1(
            lambda d: tv2d.tvp_2d_batched(t(X[None], d), 0.3, 0.3, 1.5, 1.5,
                                          max_iters=35)[0]),
            {"B2.f64"}, 1e-6),
        "tvgen": (lambda **k: P.tvgen(V, [0.3] * 3, [1, 2, 3], [1] * 3,
                                      max_iters=35, **k),
                  lambda d: tvnd.tvgen_dispatch(t(V, d), [0.3] * 3,
                                                [1, 2, 3], [1] * 3,
                                                max_iters=35)[0],
                  {"B2.f64"}, 1e-6),
        "tvgen_nd pd": (lambda **k: P.tvgen_nd(V, [0.3] * 3, [1, 2, 3],
                                               [1.0] * 3, max_iters=35, **k),
                        b1(lambda d: tvnd.tv_nd_batched(
                            t(V[None], d), (0.3,) * 3, (1, 2, 3),
                            (1.0,) * 3, max_iters=35, method="pd")[0]),
                        {"B2.f64"}, 1e-6),
        "tv_value": (lambda **k: P.tv_value(V, [0.3, 0.2, 0.4], [1, 2, 3],
                                            [1.0, 2.0, 1.5], **k),
                     lambda d: float(tvnd.tv_value(
                         t(V, d), [0.3, 0.2, 0.4], [1, 2, 3],
                         [1.0, 2.0, 1.5])), set(), 1e-8),
    }


@pytest.mark.parametrize("entry", ["tv1_1d auto", "tv1_1d auto long",
                                   "tv1_1d pn", "tv1_1d condat",
                                   "tv1_1d classictautstring", "tv1_1d dp",
                                   "tv1w_1d auto", "tv1w_1d dp",
                                   "tv1w_1d pn", "tv2_1d",
                                   "tv2_1d ms spectral", "tvp_1d",
                                   "tv1_2d auto", "tv1w_2d", "tvp_2d p2",
                                   "tvp_2d p1.5", "tvgen", "tvgen_nd pd",
                                   "tv_value"])
def test_api_float64_on_the_card(entry, dev, default64, monkeypatch):
    """Each entry point of the numpy API under a float64 default on the
    card: a float64 result, only its route's float64 kernels (no float32
    kernel, no kernel's plain version on the card), bit for bit with the
    batched call it wraps on the same input in float64 on the card, and
    within chip_smoke.py's TOL64 bar of its family of the same call with
    device="cpu"."""
    _no_plain_on_the_card(monkeypatch)
    call, twin, kernels, bar = _api64_cases()[entry]
    c0 = _all_counts()
    out = call()
    torch.cuda.synchronize()
    c1 = _all_counts()
    assert {k for k in c0 if c1[k] != c0[k]} == kernels, (c0, c1)
    ref = call(device="cpu")
    got = twin(dev)
    if entry == "tv_value":
        assert isinstance(out, float) and out == got
        assert abs(out - ref) <= bar * abs(ref)
        return
    assert out.dtype == np.float64
    np.testing.assert_array_equal(out, got.cpu().numpy())
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(out - ref).max()) <= bar * scale


def test_api_float64_on_the_card_raises_where_jax_does(dev, default64):
    """Under a float64 default: tvgen_nd with a primal-dual ND method raises
    the JAX package's error, and the banded 2D driver on a float64 image
    refuses before any exchange, naming B3; neither launches a kernel."""
    import proxtv_tpu_torch as P
    from proxtv_tpu_torch import parallel
    from proxtv_tpu_torch.parallel.comm import Mesh

    c0 = _all_counts()
    with pytest.raises(ValueError, match="primal-dual ND methods need"):
        P.tvgen_nd(np.zeros((4, 8, 8)), [0.3] * 3, [1, 2, 3], [1.0] * 3,
                   method="chambolle-pock-acc")
    mesh = Mesh(group=None, axis="x", device=dev)
    with pytest.raises(ValueError, match="banded driver takes float32 only"):
        parallel.tv1_2d_banded(np.zeros((64, 64)), 0.3, mesh)
    assert _all_counts() == c0


def test_float32_batches_under_a_float64_default_on_the_card(dev):
    """A float32 CUDA batch under a float64 default takes the float32 route
    unchanged: the same kernels with the same launch counts, and bit for
    bit the output it gives under a float32 default (B1, B3, B4, B5, B6,
    D1 and the API's float32 call, tv1_2d auto on B3)."""
    import proxtv_tpu_torch as P
    from proxtv_tpu_torch.models import tv2d, tvnd
    from proxtv_tpu_torch.ops import tv1d_l1, tv1d_l2, tv1d_lp

    rng = np.random.RandomState(51)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa
    Y = f(rng.randn(40, 500) + np.cumsum(rng.randn(40, 500), axis=1) * 0.1)
    img, vol = f(rng.randn(1, 64, 64)), f(rng.randn(1, 8, 32, 32))
    lams = [0.5 + 0.05 * i for i in range(40)]
    X = rng.randn(64, 64)
    calls = {
        "pn": lambda: tv1d_l1.tv1_batched(Y, 0.7, method="pn"),
        "tautstring": lambda: tv1d_l1.tv1_batched(Y, 0.7,
                                                  method="tautstring",
                                                  strict=True),
        "cp-acc": lambda: tv2d.tv1_2d_batched(
            img, 0.3, method="chambolle-pock-acc")[0],
        "ms per-row": lambda: tv1d_l2.tv2_batched(Y, lams, method="ms")[0],
        "gpfw": lambda: tv1d_lp.tvp_batched(Y, lams, 1.5)[0],
        "cp-acc 3d": lambda: tvnd.tv_nd_batched(
            vol, (0.3,) * 3, (1, 2, 3), (1.0,) * 3,
            method="chambolle-pock-acc")[0],
    }
    before = torch.get_default_dtype()
    runs = []
    try:
        for default in (torch.float32, torch.float64):
            torch.set_default_dtype(default)
            res = {}
            for name, fn in calls.items():
                c0 = _all_counts()
                x = fn()
                torch.cuda.synchronize()
                c1 = _all_counts()
                res[name] = (x.cpu(), {k: c1[k] - c0[k] for k in c0
                                       if c1[k] != c0[k]})
            if default == torch.float32:
                c0 = _all_counts()
                res["api"] = (torch.from_numpy(P.tv1_2d(X, 0.3)),
                              {k: v - c0[k] for k, v in _all_counts().items()
                               if v != c0[k]})
            runs.append(res)
    finally:
        torch.set_default_dtype(before)
    f32, f64 = runs
    for name in calls:
        x32, n32 = f32[name]
        x64, n64 = f64[name]
        assert n32 == n64 and n32 and all("." not in k for k in n32), (
            name, n32, n64)
        assert x64.dtype == torch.float32 and torch.equal(x32, x64), name
    assert f32["api"][0].dtype == torch.float32
    assert set(f32["api"][1]) == {"B3"}
