"""Port vs JAX package: the public API, solver state carried across packages
through ``proxtv_tpu_torch.utils.interop``, and the port's isolation."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import proxtv_tpu as jptv
import proxtv_tpu_torch as ptv
from proxtv_tpu.ops import tv1d_l1 as JL
from proxtv_tpu.utils import config as JCONF
from proxtv_tpu_torch.ops import tv1d_l1 as PL
from proxtv_tpu_torch.utils import config as PCONF
from proxtv_tpu_torch.utils import interop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_api_tv1_2d_auto_matches_jax():
    """On the CPU auto is 'dr' in both packages."""
    rng = np.random.RandomState(0)
    X = rng.randn(14, 11)
    xj, ij = jptv.tv1_2d(X, 0.3, return_info=True)
    xp, ip = ptv.tv1_2d(X, 0.3, return_info=True, device="cpu")
    assert xp.dtype == np.float64 and xp.shape == X.shape
    np.testing.assert_allclose(xp, xj, atol=1e-8)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))


@pytest.mark.parametrize("method", ["pn", "auto"])
def test_api_tv1_1d_matches_jax_pn(method):
    """pn, and auto with return_info (the device route: on the CPU the taut
    string in both packages, with the zero info of a direct engine)."""
    rng = np.random.RandomState(1)
    x = np.cumsum(rng.randn(200)) * 0.3
    xj, ij = jptv.tv1_1d(x, 2.0, method=method, return_info=True)
    xp, ip = ptv.tv1_1d(x, 2.0, method=method, return_info=True,
                        device="cpu")
    np.testing.assert_allclose(xp, xj, atol=1e-8)
    assert int(ip.rc[0]) == int(np.asarray(ij.rc)[0]) == 0


def test_api_direct_method_raises_until_ported():
    """The direct methods are ported: each explicit method string runs its
    engine and matches the JAX package (1e-12; pn 1e-8), through the host
    engine (backend auto) and the device route (backend cuda, the JAX
    package's "tpu"); an unknown method or backend still raises."""
    rng = np.random.RandomState(3)
    x = np.cumsum(rng.randn(90)) * 0.3 + rng.randn(90)
    for m in sorted(ptv.api._TV1_METHODS):
        for bp, bj in (("auto", "auto"), ("cuda", "tpu")):
            xp = ptv.tv1_1d(x, 0.9, method=m, backend=bp, device="cpu")
            xj = jptv.tv1_1d(x, 0.9, method=m, backend=bj)
            assert xp.dtype == np.float64
            np.testing.assert_allclose(xp, xj, atol=1e-8 if m == "pn"
                                       else 1e-12, err_msg=f"{m} {bp}")
    with pytest.raises(AssertionError):
        ptv.tv1_1d(x, 0.9, method="nope", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        ptv.tv1_1d(x, 0.9, backend="tpu", device="cpu")


@pytest.mark.parametrize("method", ["auto", "tautstring", "pn", "dp"])
@pytest.mark.parametrize("backend", ["auto", "cuda"])
def test_api_tv1w_1d_matches_jax(method, backend):
    """Every weighted method against the JAX package (the bar of
    tests/test_api.py:18-24 is 1e-3 against an oracle; the direct engines
    and the host engine agree to 1e-12, pn to 1e-8), with a zero weight;
    return_info of a direct engine is the zero info."""
    rng = np.random.RandomState(11)
    x = rng.randn(40)
    w = rng.rand(39) * 1.2
    w[7] = 0.0
    bj = "tpu" if backend == "cuda" else "auto"
    xj = jptv.tv1w_1d(x, w, method=method, backend=bj)
    xp = ptv.tv1w_1d(x, w, method=method, backend=backend, device="cpu")
    assert xp.dtype == np.float64
    np.testing.assert_allclose(xp, xj, atol=1e-8 if method == "pn" else 1e-12)
    xi, info = ptv.tv1w_1d(x, w, method=method, return_info=True,
                           device="cpu")
    np.testing.assert_allclose(xi, xj, atol=1e-8 if method == "pn" else 1e-12)
    if method != "pn":
        assert int(info.iters[0]) == 0 and int(info.rc[0]) == 0
    with pytest.raises(AssertionError):
        ptv.tv1w_1d(x, w[:-1], method=method, device="cpu")
    with pytest.raises(AssertionError):
        ptv.tv1w_1d(x, -w, method=method, device="cpu")


def test_api_host_route_dtype_and_counter():
    """The native host engine serves a taut-string solve (counted in
    debug.HOST_ROUTE) only when the caller asks for the host: backend
    'auto' with device='cpu' (the JAX package's policy: a short signal, no
    return_info; float64), or backend='host' on any device (the device
    route's dtype: float32 unless device='cpu').  return_info,
    backend='cuda' and non-taut-string methods take the device route;
    backend='host' refuses what the host engine cannot run."""
    from proxtv_tpu_torch.runtime import native
    from proxtv_tpu_torch.utils import debug

    if not native.available():
        pytest.skip("no C++ compiler here")
    x = np.cumsum(np.random.RandomState(12).randn(300))
    before = debug.HOST_ROUTE.value
    out = ptv.tv1_1d(x, 1.0, device="cpu")
    assert debug.HOST_ROUTE.value == before + 1 and out.dtype == np.float64
    np.testing.assert_allclose(out, native.tv1_host(x, 1.0), atol=0)
    ptv.tv1_1d(x, 1.0, return_info=True, device="cpu")
    ptv.tv1_1d(x, 1.0, backend="cuda", device="cpu")
    ptv.tv1_1d(x, 1.0, method="dp", device="cpu")
    ptv.tv1_1d(x, 1.0, maxbacktracks=5, device="cpu")  # auto -> dp
    ptv.tv1w_1d(x, np.ones(299), method="pn", device="cpu")
    assert debug.HOST_ROUTE.value == before + 1
    ptv.tv1w_1d(x, np.ones(299), device="cpu")
    assert debug.HOST_ROUTE.value == before + 2
    # backend='host' needs no card and returns the card route's float32.
    o32 = ptv.tv1_1d(x, 1.0, backend="host")
    w32 = ptv.tv1w_1d(x, np.ones(299), backend="host")
    assert debug.HOST_ROUTE.value == before + 4
    assert o32.dtype == w32.dtype == np.float32
    np.testing.assert_array_equal(o32, out.astype(np.float32))
    for bad in (lambda: ptv.tv1_1d(x, 1.0, method="dp", backend="host"),
                lambda: ptv.tv1_1d(x, 1.0, backend="host", return_info=True),
                lambda: ptv.tv1w_1d(x, np.ones(299), method="pn",
                                    backend="host")):
        with pytest.raises(ValueError, match="backend='host'"):
            bad()
    assert debug.HOST_ROUTE.value == before + 4


def test_api_auto_on_the_card_takes_the_device_route(monkeypatch):
    """Without device='cpu', backend='auto' never takes the host engine:
    tv1_1d, tv1w_1d and tv's 1D branches go to the card (here a stand-in
    for tv1_batched / the taut string records the call)."""
    from proxtv_tpu_torch.ops import tv1d_l1
    from proxtv_tpu_torch.utils import debug

    seen = []
    monkeypatch.setattr(ptv.api, "_device",
                        lambda device: (torch.device("cpu"), torch.float32))
    monkeypatch.setattr(tv1d_l1, "tv1_batched", lambda y, lam, method, strict:
                        seen.append(("batched", method, strict)) or y)
    monkeypatch.setattr(tv1d_l1, "tv1_tautstring",
                        lambda y, lam: seen.append(("tautstring",)) or y)
    x = np.cumsum(np.random.RandomState(5).randn(64))
    before = debug.HOST_ROUTE.value
    ptv.tv1_1d(x, 1.0)
    ptv.tv1_1d(x, 1.0, method="linearizedtautstring")
    ptv.tv1w_1d(x, np.ones(63))
    ptv.tv(x, np.ones(63))
    ptv.tv(x, 1.0)
    assert debug.HOST_ROUTE.value == before
    assert seen == [("batched", "hybridtautstring", False),
                    ("batched", "linearizedtautstring", True),
                    ("tautstring",), ("tautstring",),
                    ("batched", "hybridtautstring", False)]


def test_api_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptv.tv1_2d(np.zeros((8, 8)), 0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptv.tv1_1d(np.zeros(8), 0.1)
    for call in (lambda: ptv.tv1w_1d(np.zeros(8), np.ones(7)),
                 lambda: ptv.tv1w_2d(np.zeros((8, 8)), np.ones((7, 8)),
                                     np.ones((8, 7))),
                 lambda: ptv.tv(np.zeros(8), np.ones(7)),
                 lambda: ptv.tv2_1d(np.zeros(8), 0.1),
                 lambda: ptv.tvp_2d(np.zeros((8, 8)), 0.1, 0.1, 2, 2),
                 lambda: ptv.tvgen(np.zeros((3, 4, 5)), [0.1] * 3, [1, 2, 3],
                                   [1] * 3),
                 lambda: ptv.tv(np.zeros(8), 0.1, p=2),
                 lambda: ptv.tvp_1d(np.zeros(8), 0.1, 1.5),
                 lambda: ptv.tv_value(np.zeros(8), [1.0], [1], [1.0])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_pn_dual_warm_start_carried_from_jax():
    """JAX tv1_pn's dual, through interop, warm-starts the port's tv1_pn to
    the same solution in at most one iteration."""
    rng = np.random.RandomState(2)
    Y = rng.randn(6, 40)
    W = rng.rand(6, 39) + 0.1
    xj, ij, wj = JL.tv1_pn(jnp.asarray(Y), jnp.asarray(W), return_dual=True)
    w0 = interop.pn_dual(np.asarray(wj), device="cpu")
    xp, ip = PL.tv1_pn(interop.tensor(Y), interop.tensor(W), w_init=w0)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-8)
    assert int(ip.iters.max()) <= 1


def test_interop_roundtrips_info_and_config():
    _, ij = JL.tv1_pn(jnp.asarray(np.random.RandomState(3).randn(3, 9)), 0.5)
    info = interop.info_from(ij)
    d = interop.info_to_dict(info)
    for k in ("iters", "gap", "rc"):
        np.testing.assert_array_equal(d[k], np.asarray(getattr(ij, k)))
    assert info.iters.dtype == torch.int32
    jcfg = JCONF.CombinerConfig(max_iters_dr=7, pdhg_gap_tol=3e-5)
    pcfg = interop.config_from(PCONF.CombinerConfig, jcfg)
    assert interop.config_to_dict(pcfg) == interop.config_to_dict(jcfg)
    assert interop.config_from(PCONF.TV1Config, {"sigma": 0.1}).sigma == 0.1
    u = interop.pdhg_duals((np.ones((1, 4, 3)), np.ones((1, 3, 4))))
    assert u[0].shape == (1, 4, 3) and u[1].shape == (1, 3, 4)


def test_config_defaults_match_jax():
    for name in ("TV1Config", "TV2Config", "TVpConfig", "LPpConfig",
                 "CombinerConfig"):
        assert (interop.config_to_dict(getattr(PCONF, name)())
                == interop.config_to_dict(getattr(JCONF, name)()))
    assert PCONF.EPSILON == JCONF.EPSILON


def test_port_imports_neither_jax_nor_reference_package():
    code = (
        "import sys\n"
        "import proxtv_tpu_torch, proxtv_tpu_torch.api\n"
        "from proxtv_tpu_torch.models import tv2d, tvnd\n"
        "from proxtv_tpu_torch.ops import lp, tv1d_l2, tv1d_lp\n"
        "from proxtv_tpu_torch.ops import tv1d_l1, tv1d_long, diffprox\n"
        "from proxtv_tpu_torch.models import layers\n"
        "import proxtv_tpu_torch.__main__\n"
        "from proxtv_tpu_torch.ops.kernels import build, pcr, pn_fused, "
        "pdhg_fused, ms_fused, pdhg3d_fused, lp_fused, tautstring, dp, "
        "direct1d\n"
        "from proxtv_tpu_torch.runtime import native\n"
        "from proxtv_tpu_torch.utils import interop, debug, lpnorms, "
        "checkpoint\n"
        "from proxtv_tpu_torch.demos import demo_filter_image, "
        "demo_filter_signal, demo_filter_image_weighted, "
        "demo_filter_image_batched, demo_filter_image_color\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', "
        "'optax', 'orbax', 'proxtv_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_demo_runs_through_port(monkeypatch):
    from proxtv_tpu_torch.demos import demo_filter_image as demo

    monkeypatch.setattr(demo, "load_image",
                        lambda: (demo.make_image(24), "synthetic"))
    res = demo.main(device="cpu", methods=("dr", "chambolle-pock-acc"))
    for noisy, den in res.values():
        assert den < noisy


@pytest.mark.parametrize("method", ["ms", "pg", "mspg"])
def test_api_tv2_1d_matches_jax(method):
    rng = np.random.RandomState(4)
    x = np.cumsum(rng.randn(150)) * 0.3
    xj, ij = jptv.tv2_1d(x, 2.0, method=method, return_info=True)
    xp, ip = ptv.tv2_1d(x, 2.0, method=method, return_info=True,
                        device="cpu")
    assert xp.dtype == np.float64 and xp.shape == x.shape
    np.testing.assert_allclose(xp, xj, atol=1e-8)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))


def test_api_tvp_2d_tvgen_and_tvgen_nd_match_jax():
    rng = np.random.RandomState(5)
    X = rng.randn(9, 8)
    V = rng.randn(4, 5, 6)
    np.testing.assert_allclose(
        ptv.tvp_2d(X, 0.3, 0.2, 2, 1, device="cpu"),
        jptv.tvp_2d(X, 0.3, 0.2, 2, 1), atol=1e-8)
    np.testing.assert_allclose(
        ptv.tvgen(V, [0.3, 0.2, 0.25], [1, 2, 3], [1, 2, 1], device="cpu"),
        jptv.tvgen(V, [0.3, 0.2, 0.25], [1, 2, 3], [1, 2, 1]), atol=1e-8)
    xp, ip = ptv.tvgen_nd(V, [0.3] * 3, [1, 2, 3], [1, 1, 2], method="pdr",
                          return_info=True, device="cpu")
    xj, ij = jptv.tvgen_nd(V, [0.3] * 3, [1, 2, 3], [1, 1, 2], method="pdr",
                           return_info=True)
    np.testing.assert_allclose(xp, xj, atol=1e-8)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))


@pytest.mark.parametrize("case", ["1d_p1", "1d_p2", "2d", "3d_p2"])
def test_api_tv_dispatch_matches_jax(case):
    rng = np.random.RandomState(6)
    y, p = {"1d_p1": (np.cumsum(rng.randn(60)), 1), "1d_p2":
            (np.cumsum(rng.randn(60)), 2), "2d": (rng.randn(8, 7), 1),
            "3d_p2": (rng.randn(4, 5, 3), 2)}[case]
    ref = (jptv.tv1_1d(y, 0.8, method="pn") if case == "1d_p1"
           else jptv.tv(y, 0.8, p=p))
    np.testing.assert_allclose(ptv.tv(y, 0.8, p=p, device="cpu"), ref,
                               atol=1e-8)


def test_api_tv_unported_branches_raise():
    """The pair and vector branches are ported: they raise the JAX
    package's ValueErrors on what the reference refuses."""
    y = np.zeros((6, 5))
    pair = [np.ones((5, 5)), np.ones((6, 4))]
    for bad in (lambda: ptv.tv(np.zeros(6), pair, device="cpu"),
                lambda: ptv.tv(np.zeros((2, 3, 4)), pair * 2, device="cpu"),
                lambda: ptv.tv(y, pair, p=2, device="cpu"),
                lambda: ptv.tv(y, np.ones(5), device="cpu"),
                lambda: ptv.tv(np.zeros(6), np.ones(4), device="cpu"),
                lambda: ptv.tv(np.zeros(6), np.ones(5), p=2, device="cpu")):
        with pytest.raises(ValueError):
            bad()
    for bad in (lambda: jptv.tv(np.zeros(6), pair),
                lambda: jptv.tv(y, np.ones(5))):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("branch", ["pair", "vector"])
def test_api_tv_weighted_branches_match_jax(branch):
    rng = np.random.RandomState(13)
    if branch == "pair":
        y = rng.randn(9, 8)
        lam = [rng.rand(8, 8) * 0.6, rng.rand(9, 7) * 0.6]
        kw = {"max_iters": 60}
        atol = 1e-8
    else:
        y = np.cumsum(rng.randn(50))
        lam = rng.rand(49) * 2
        kw = {}
        atol = 1e-12
    np.testing.assert_allclose(ptv.tv(y, lam, device="cpu", **kw),
                               jptv.tv(y, lam, **kw), atol=atol)


@pytest.mark.parametrize("method", ["dr", "pd", "yang", "kolmogorov"])
def test_api_tv1w_2d_matches_jax(method):
    """tv1w_2d_batched against the JAX package for the weighted splitting
    methods (the CPU runs their compositions in both packages), with zero
    weights on some edges."""
    from proxtv_tpu.models import tv2d as J2
    from proxtv_tpu_torch.models import tv2d as P2

    rng = np.random.RandomState(14)
    Y = rng.randn(2, 9, 8)
    Wc = rng.rand(2, 8, 8) * 0.7
    Wr = rng.rand(2, 9, 7) * 0.7
    Wc[:, 3] = 0.0
    xj, ij = J2.tv1w_2d_batched(jnp.asarray(Y), jnp.asarray(Wc),
                                jnp.asarray(Wr), method=method, max_iters=80)
    xp, ip = P2.tv1w_2d_batched(torch.from_numpy(Y), torch.from_numpy(Wc),
                                torch.from_numpy(Wr), method=method,
                                max_iters=80)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-8)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))


def test_api_tv1w_2d_uniform_weights_match_tv1_2d():
    """tests/test_api.py:51-57: uniform weight fields give tv1_2d (1e-5),
    and the API matches the JAX package's."""
    rng = np.random.RandomState(15)
    X = rng.randn(8, 9)
    lam = 0.5
    W_col = np.full((7, 9), lam)
    W_row = np.full((8, 8), lam)
    xw = ptv.tv1w_2d(X, W_col, W_row, max_iters=400, device="cpu")
    xu = ptv.tv1_2d(X, lam, max_iters=400, device="cpu")
    np.testing.assert_allclose(xw, xu, atol=1e-5)
    np.testing.assert_allclose(xw, jptv.tv1w_2d(X, W_col, W_row,
                                                max_iters=400), atol=1e-8)


def test_per_image_lam_matches_jax():
    """Per-image lam runs the weighted solver on uniform fields in both
    packages (dr, pd, yang); kolmogorov raises the JAX package's
    ValueError."""
    from proxtv_tpu.models import tv2d as J2
    from proxtv_tpu_torch.models import tv2d as P2

    rng = np.random.RandomState(16)
    Y = rng.randn(3, 8, 7)
    lam = np.array([0.1, 0.3, 0.6])
    for method in ("dr", "pd", "yang"):
        xj, ij = J2.tv1_2d_batched(jnp.asarray(Y), jnp.asarray(lam),
                                   method=method, max_iters=60)
        xp, ip = P2.tv1_2d_batched(torch.from_numpy(Y), torch.from_numpy(lam),
                                   method=method, max_iters=60)
        np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-8,
                                   err_msg=method)
        np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))
    for mod, arr in ((P2, torch.from_numpy), (J2, jnp.asarray)):
        with pytest.raises(ValueError, match="per-image"):
            mod.tv1_2d_batched(arr(Y), arr(lam), method="kolmogorov")


def test_weighted_cp_acc_plain_matches_jax_weighted_dr():
    """B3's weighted route (the chunked primal-dual with weight fields) on
    a CPU tensor runs B3's plain version; the JAX package raises for
    weighted primal-dual on the CPU, so it is held against JAX's weighted
    dr, both run to a tight stop, at the cross-method bar of 1e-3.  The
    port's public weighted cp-acc raises the JAX package's ValueError on
    the CPU."""
    from proxtv_tpu.models import tv2d as J2
    from proxtv_tpu.utils.config import CombinerConfig as JC
    from proxtv_tpu_torch.models import tv2d as P2
    from proxtv_tpu_torch.utils.config import DEFAULT_COMBINER

    rng = np.random.RandomState(17)
    Y = rng.randn(1, 12, 10)
    Wc = 0.2 + rng.rand(1, 11, 10) * 0.4
    Wr = 0.2 + rng.rand(1, 12, 9) * 0.4
    xp, ip = P2._run_pdhg_fused(torch.from_numpy(Y), 0.0, 3000, 1e-6,
                                DEFAULT_COMBINER, "cp-acc",
                                W_col=torch.from_numpy(Wc),
                                W_row=torch.from_numpy(Wr), gap_tol=1e-10)
    xj, _ = J2.tv1w_2d_batched(jnp.asarray(Y), jnp.asarray(Wc),
                               jnp.asarray(Wr), method="dr", max_iters=2000,
                               cfg=JC(stop=1e-10))
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-3)
    for m in ("chambolle-pock-acc", "condat"):
        with pytest.raises(ValueError, match="primal-dual"):
            P2.tv1w_2d_batched(torch.from_numpy(Y), torch.from_numpy(Wc),
                               torch.from_numpy(Wr), method=m)
        with pytest.raises(ValueError, match="primal-dual"):
            J2.tv1w_2d_batched(jnp.asarray(Y), jnp.asarray(Wc),
                               jnp.asarray(Wr), method=m)


def test_weighted_demos_run_through_port():
    from proxtv_tpu_torch.demos import demo_filter_image_weighted as dw
    from proxtv_tpu_torch.demos import demo_filter_signal as ds

    res = ds.main(device="cpu")
    for k in ("tv1", "tv1w", "tv2", "tvp"):
        assert res[k][1] < res[k][0], k
    assert res["jump"] > 1.5  # the unpenalized edge keeps its jump
    r2 = dw.main(device="cpu", n=64)
    assert r2["left"] < r2["noisy"] and r2["right"] < r2["noisy"]


def test_api_tv_value_matches_jax():
    X = np.random.RandomState(7).randn(4, 5, 6)
    args = ([1.0, 2.0, 0.5], [1, 3, 2], [2.0, 1.0, 1.5])
    np.testing.assert_allclose(ptv.tv_value(X, *args, device="cpu"),
                               jptv.tv_value(X, *args), rtol=1e-12)
