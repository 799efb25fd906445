"""Port vs JAX package: the 1D TV-Lp engines of ``ops/tv1d_lp.py``, kernel
B5's plain version against the Pallas kernel, and the TV-Lp entry points of
the API (``tvp_1d``, ``tv``, ``tvp_2d``, ``tvgen``).

Everything runs in float64 on the CPU; the JAX Pallas kernel runs in
interpret mode.  Tolerances: where both packages run the same arithmetic
(the joint-KKT projection, the closed forms, the kernel's loop) the
solutions agree to 1e-10 with equal iteration counts.  Where the q-ball
projection takes the nested root-find (q = p/(p-1) outside [1.05, 3.6],
here p = 1.25), its bracket resolution (tests/test_torch_lp.py) parts the
trajectories, so the two are held to the cross-method bar of
tests/test_tv1d_lp.py (1e-3) and their objectives to 2e-5 (both within the
1e-5 duality-gap stop of the optimum).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import proxtv_tpu as jptv
import proxtv_tpu_torch as ptv
from proxtv_tpu.ops import tv1d_lp as JLP
from proxtv_tpu.utils.config import DEFAULT_TVP as JCFG
from proxtv_tpu_torch.ops import tv1d_l1 as PL1
from proxtv_tpu_torch.ops import tv1d_lp as PLP
from proxtv_tpu_torch.ops.kernels import lp_fused as PK
from proxtv_tpu_torch.utils import debug, interop
from proxtv_tpu_torch.utils.config import DEFAULT_TVP as PCFG
from proxtv_tpu_torch.utils.diffs import tvp_objective

# Tier-1 runs several test processes on the machine's cores at once: one
# intra-op thread each, or every process's spinning thread pool slows the
# others' many small tensor ops (by ~20x under load).
torch.set_num_threads(1)

METHODS = ["gp", "ogp", "fista", "fw", "gpfw"]


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _obj(X, Y, lam, p):
    return tvp_objective(_t(X), _t(Y), lam, p).numpy()


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("p", [1.25, 1.5, 3.0, 6.0, 10.5, 150.0,
                               float("inf")])
def test_engines_match_jax(p, method):
    """Every engine at every p regime: the joint projection (1.5 - 10.5),
    the nested one (1.25), the L1-ball dual of p >= 100, and the GP
    fallback of gpfw above p = 10.  The cap of 2000 iterations holds one
    slow pure-FW row at p >= 100 to the same count in both packages."""
    Y = np.random.RandomState(0).randn(6, 16) * 2
    xj, ij = JLP.tvp_batched(jnp.asarray(Y), 0.8, p, method=method,
                             max_iters=2000)
    xp, ip = PLP.tvp_batched(_t(Y), 0.8, p, method=method, max_iters=2000)
    xj = np.asarray(xj)
    if p == 1.25:
        np.testing.assert_allclose(xp.numpy(), xj, atol=1e-3)
        np.testing.assert_allclose(_obj(xp, Y, 0.8, p), _obj(xj, Y, 0.8, p),
                                   rtol=0, atol=2e-5)
        return
    np.testing.assert_allclose(xp.numpy(), xj, atol=1e-10)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))
    np.testing.assert_array_equal(ip.rc.numpy(), np.asarray(ij.rc))
    np.testing.assert_allclose(ip.gap.numpy(), np.asarray(ij.gap), atol=1e-10)


def test_single_sample_identity_and_max_iters():
    """n = 1 is the identity for every engine; max_iters is honoured (a
    1-iteration GP run reports iters <= 1, as the JAX package)."""
    rng = np.random.RandomState(1)
    y1 = rng.randn(3, 1)
    for m in METHODS:
        x, info = PLP.tvp_batched(_t(y1), 1.0, 1.5, method=m)
        np.testing.assert_array_equal(x.numpy(), y1)
        assert np.all(info.rc.numpy() == 0) and np.all(info.iters.numpy() == 0)
    Y = rng.randn(2, 20) * 2
    for m, cap in (("gp", 1), ("gpfw", 3), ("fw", 5)):
        _, ij = JLP.tvp_batched(jnp.asarray(Y), 0.8, 3.0, method=m,
                                max_iters=cap)
        _, ip = PLP.tvp_batched(_t(Y), 0.8, 3.0, method=m, max_iters=cap)
        assert np.all(ip.iters.numpy() <= cap)
        np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))
        np.testing.assert_array_equal(ip.rc.numpy(), np.asarray(ij.rc))


@pytest.mark.parametrize("p", [1.0, 1.001])
def test_p_near_one_runs_projected_newton(p):
    """p <= 1.002: both packages run their taut string (on the card the
    port's is kernel D1): the JAX taut string's result, equal to the
    port's tv1_batched (whose default name runs the taut string on the
    CPU), with the zero SolverInfo."""
    Y = np.random.RandomState(2).randn(4, 12) * 2
    xj, _ = JLP.tvp_batched(jnp.asarray(Y), 0.7, p)
    xp, ip = PLP.tvp_batched(_t(Y), 0.7, p)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-6)
    np.testing.assert_array_equal(xp.numpy(),
                                  PL1.tv1_batched(_t(Y), 0.7).numpy())
    for f in (ip.iters, ip.gap, ip.rc):
        assert np.all(f.numpy() == 0)


def _b5_inputs(rng, B, n, lam, dtype=np.float64):
    y = rng.randn(B, n).astype(dtype)
    y -= y.mean(axis=1, keepdims=True)
    return (y, np.zeros((B, n), dtype), np.broadcast_to(
        np.asarray(lam, dtype), (B,)).copy(), np.ones(B, dtype),
        np.ones(B, dtype))


@pytest.mark.parametrize("p", [1.5, 3.0, 5.0])
def test_gpfw_plain_matches_pallas_kernel(p):
    """B5's plain version at the JAX tile (tb = 8) against the Pallas kernel
    in interpret mode, float64, at the JAX test's shape (16 x 300, lam 0.7):
    a fixed 3-trip trajectory and the converged solve to 1e-10 with equal
    counts; tb = 1 (the CUDA kernel's per-fiber loop) gives the same."""
    from proxtv_tpu.ops.kernels import lp_fused as JK

    args = _b5_inputs(np.random.RandomState(3), 16, 300, 0.7)
    for cap in (30, 100000):
        wj, mj, gj, ij = JK.gpfw_fused(*map(jnp.asarray, args), p=p,
                                       max_iters=cap, tb=8)
        wp, mp, gp, ip = PK.gpfw_fused_plain(*map(_t, args), p, cap, tb=8)
        np.testing.assert_allclose(wp.numpy(), np.asarray(wj), atol=1e-10)
        np.testing.assert_allclose(mp.numpy(), np.asarray(mj), rtol=1e-10)
        np.testing.assert_allclose(gp.numpy(), np.asarray(gj), atol=1e-10)
        np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    w1, m1, g1, i1 = PK.gpfw_fused(*map(_t, args), p, 100000)  # CPU: tb = 1
    np.testing.assert_allclose(w1.numpy(), wp.numpy(), atol=1e-12)
    np.testing.assert_array_equal(i1.numpy(), ip.numpy())


def test_gpfw_plain_degenerate_rows_and_cap_marker():
    """Frozen rows (run_mask 0) come back bitwise unchanged with zero
    iterations; a row still running at the cap carries the 0.5 marker, as
    in the Pallas kernel."""
    from proxtv_tpu.ops.kernels import lp_fused as JK

    y, w0, lam, mu0, run = _b5_inputs(np.random.RandomState(4), 8, 64,
                                      [0.0, 0.3, 1.0, 3.0, 0.5, 2.0, 0.7,
                                       1e5])
    run[[0, 7]] = 0.0
    w0[0, :-1] = 0.01
    args = (y, w0, lam, mu0, run)
    # stop_rel 0: only the float64 floor stops a row, so rows reach the cap.
    wj, _, _, ij = JK.gpfw_fused(*map(jnp.asarray, args), p=3.0, max_iters=10,
                                 stop_rel=0.0, tb=8)
    wp, _, _, ip = PK.gpfw_fused_plain(*map(_t, args), 3.0, 10, stop_rel=0.0,
                                       tb=8)
    np.testing.assert_array_equal(wp.numpy()[0], w0[0])
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), atol=1e-10)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    assert ip[0] == 0.0 and ip[7] == 0.0 and np.any(ip.numpy() == 10.5)


def test_run_gpfw_fused_matches_jax():
    """The driver around B5 (setup solve, interior and zero-penalty exits,
    finalize) against the JAX driver with the Pallas kernel, and against
    the composition it replaces (_run_fw) at the JAX test's bars."""
    Y = np.random.RandomState(0).randn(16, 300)
    lam = 0.7
    for p in (1.5, 3.0, 5.0):
        xj, ij = JLP._run_gpfw_fused(jnp.asarray(Y), lam, p, JCFG, 0)
        xp, ip = PLP._run_gpfw_fused(_t(Y), lam, p, PCFG, 0)
        np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-10)
        np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))
        assert np.all(ip.rc.numpy() == 0)
        xf, _ = PLP._run_fw(_t(Y), lam, p, PCFG, 0, PCFG.fw_cycles)
        np.testing.assert_allclose(_obj(xp, Y, lam, p), _obj(xf, Y, lam, p),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(xp.numpy(), xf.numpy(), atol=5e-3)


def test_run_gpfw_fused_degenerate_and_warm_match_jax():
    """lam = 0 -> identity; huge lam -> the mean; per-row lam with a zero
    row; a warm restart from the converged state (carried from the JAX
    package through interop) certifies in 0 iterations."""
    rng = np.random.RandomState(0)
    Y = rng.randn(8, 64)
    x0, _ = PLP._run_gpfw_fused(_t(Y), 0.0, 1.5, PCFG, 0)
    np.testing.assert_allclose(x0.numpy(), Y, atol=1e-12)
    xh, _ = PLP._run_gpfw_fused(_t(Y), 1e6, 1.5, PCFG, 0)
    np.testing.assert_allclose(xh.numpy(), np.broadcast_to(
        Y.mean(axis=1, keepdims=True), Y.shape), atol=1e-10)
    lamv = np.array([0.0, 0.3, 1.0, 3.0, 0.5, 2.0, 0.7, 1e5])
    xm, im = PLP._run_gpfw_fused(_t(Y), _t(lamv), 3.0, PCFG, 0)
    xmj, imj = JLP._run_gpfw_fused(jnp.asarray(Y), jnp.asarray(lamv), 3.0,
                                   JCFG, 0)
    np.testing.assert_allclose(xm.numpy(), np.asarray(xmj), atol=1e-10)
    np.testing.assert_allclose(xm.numpy()[0], Y[0], atol=1e-12)
    assert np.all(im.rc.numpy() == 0)
    _, _, (wj, mj) = JLP._run_gpfw_fused(jnp.asarray(Y), 0.5, 1.5, JCFG, 0,
                                         return_state=True)
    w0, mu0 = interop.lp_state(np.asarray(wj), np.asarray(mj))
    x1, _ = JLP._run_gpfw_fused(jnp.asarray(Y), 0.5, 1.5, JCFG, 0)
    x2, i2 = PLP._run_gpfw_fused(_t(Y), 0.5, 1.5, PCFG, 0, w_init=w0,
                                 mu_init=mu0)
    assert int(i2.iters.max()) == 0
    np.testing.assert_allclose(x2.numpy(), np.asarray(x1), atol=1e-6)
    with pytest.raises(ValueError):
        interop.lp_state(np.zeros((2, 3)), np.zeros(3))


def test_fw_warm_state_and_host_sync_cadence():
    """The composition driver threads (w, mu) like the JAX one, and reads
    the running flags once every fw_cycles iterations (plus the joint
    projection's accept flag once per GP step)."""
    Y = np.random.RandomState(5).randn(4, 40) * 2
    xj, ij, (wj, mj) = JLP.tvp_gpfw(jnp.asarray(Y), 0.6, 1.5,
                                    return_state=True)
    debug.HOST_SYNCS.reset()
    xp, ip, (wp, mp) = PLP.tvp_gpfw(_t(Y), 0.6, 1.5, return_state=True)
    syncs = debug.HOST_SYNCS.value
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-10)
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), atol=1e-10)
    np.testing.assert_allclose(mp.numpy(), np.asarray(mj), rtol=1e-8)
    # The loop runs L = n_it rounded up to a multiple of fw_cycles (the
    # extra iterations are masked no-ops): one read for the start
    # projection, one per GP step (L / c), one running check per block of c
    # iterations and the final one.
    c = PCFG.fw_cycles
    n_blocks = -(-int(ip.iters.max()) // c)
    assert syncs == 2 + 2 * n_blocks
    x2, i2 = PLP.tvp_gpfw(_t(Y), 0.6, 1.5, w_init=wp, mu_init=mp)
    assert int(i2.iters.max()) <= 1
    np.testing.assert_allclose(x2.numpy(), xp.numpy(), atol=1e-8)


def test_long_signal_setup_runs_the_composition():
    """n - 1 > 8192: the setup solve is the PCR composition (the JAX
    package's XLA solve); the certified solve matches the JAX one."""
    rng = np.random.RandomState(6)
    n = 8200
    y = np.cumsum(rng.randn(n)) * 0.05 + rng.randn(n)
    w0j = np.asarray(JLP.tridiag.spd_second_difference_solve(
        jnp.asarray(np.diff(y)[None])))
    np.testing.assert_allclose(
        PLP.tridiag.spd_second_difference_solve(_t(np.diff(y)[None])).numpy(),
        w0j, atol=1e-9 * max(1.0, float(np.abs(w0j).max())))
    xj, ij = JLP.tvp_gpfw(jnp.asarray(y)[None], 5.0, 1.5)
    xp, ip = PLP.tvp_gpfw(_t(y[None]), 5.0, 1.5)
    assert int(ip.rc[0]) == 0
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-8)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))


@pytest.mark.parametrize("method", METHODS)
def test_api_tvp_1d_matches_jax(method):
    """Pure FW needs ~130 iterations on this random walk and its exact line
    search amplifies last-bit differences, so its stop lands a few
    iterations apart: it is held to the cross-method bar (1e-3) and the
    objectives to 2e-5 (both within the 1e-5 gap stop of the optimum); the
    other methods to 1e-10."""
    x = np.cumsum(np.random.RandomState(7).randn(60)) * 0.3
    xj, ij = jptv.tvp_1d(x, 1.5, 1.5, method=method, return_info=True)
    xp, ip = ptv.tvp_1d(x, 1.5, 1.5, method=method, return_info=True,
                        device="cpu")
    assert xp.dtype == np.float64 and xp.shape == x.shape
    if method == "fw":
        np.testing.assert_allclose(xp, xj, atol=1e-3)
        np.testing.assert_allclose(_obj(xp[None], x[None], 1.5, 1.5),
                                   _obj(np.asarray(xj)[None], x[None], 1.5,
                                        1.5), rtol=0, atol=2e-5)
        return
    np.testing.assert_allclose(xp, xj, atol=1e-10)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))


def test_api_tv_tvp_2d_and_tvgen_with_p_1_5_match_jax():
    """tv with a 1D signal and p = 1.5 (-> tvp_1d, max_iters forwarded) to
    1e-10; tvp_2d with p = 1.5 on both axes, tvgen with a TV-Lp term (2D:
    dr) and tvgen_nd pdr to the cross-method bar 1e-3: their first fiber
    pass projects a zero dual, where the JAX package's multiplier turns NaN
    and the port keeps the warm one (ROADMAP C;
    test_zero_row_projection_keeps_a_finite_multiplier)."""
    rng = np.random.RandomState(8)
    y = np.cumsum(rng.randn(50))
    np.testing.assert_allclose(ptv.tv(y, 0.8, p=1.5, device="cpu"),
                               jptv.tv(y, 0.8, p=1.5), atol=1e-10)
    np.testing.assert_allclose(ptv.tv(y, 0.8, p=3, max_iters=4, device="cpu"),
                               jptv.tv(y, 0.8, p=3, max_iters=4), atol=1e-10)
    X = rng.randn(9, 8)
    xp, ip = ptv.tvp_2d(X, 0.3, 0.2, 1.5, 1.5, return_info=True,
                        device="cpu")
    xj, ij = jptv.tvp_2d(X, 0.3, 0.2, 1.5, 1.5, return_info=True)
    np.testing.assert_allclose(xp, xj, atol=1e-3)
    assert int(ip.rc[0]) == 0
    Z = rng.randn(6, 7)
    np.testing.assert_allclose(
        ptv.tvgen(Z, [0.3, 0.2], [1, 2], [1.5, 1], device="cpu"),
        jptv.tvgen(Z, [0.3, 0.2], [1, 2], [1.5, 1]), atol=1e-3)
    V = rng.randn(4, 5, 6)
    np.testing.assert_allclose(
        ptv.tvgen_nd(V, [0.3, 0.2], [1, 3], [1.5, 2], method="pdr",
                     device="cpu"),
        jptv.tvgen_nd(V, [0.3, 0.2], [1, 3], [1.5, 2], method="pdr"),
        atol=1e-3)


def test_zero_row_projection_keeps_a_finite_multiplier():
    """Deviation (ROADMAP C): projecting a zero row (inside every ball) with
    a warm multiplier, the JAX package returns mu = NaN (its joint Newton
    starts from 0 * inf); the port returns the warm multiplier, 1 cold, and
    the same x.  Other rows are untouched."""
    from proxtv_tpu.ops import lp as JL

    from proxtv_tpu_torch.ops import lp as PL

    z = np.zeros((2, 6))
    z[1] = np.arange(6.0)
    for mu0 in (np.array([0.7, 1.0]), None):
        xj, mj = JL.lp_ball_project_ws(jnp.asarray(z), jnp.full(2, 0.3), 3.0,
                                       None if mu0 is None
                                       else jnp.asarray(mu0))
        xp, mp = PL.lp_ball_project_ws(_t(z), _t(np.full(2, 0.3)), 3.0,
                                       None if mu0 is None else _t(mu0))
        assert np.isnan(np.asarray(mj)[0])
        assert float(mp[0]) == (1.0 if mu0 is None else 0.7)
        np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-12)
        assert float(mp[1]) == float(np.asarray(mj)[1])


def test_tvp_batched_unknown_method_raises():
    with pytest.raises(ValueError):
        PLP.tvp_batched(torch.zeros((2, 5), dtype=torch.float64), 1.0, 1.5,
                        method="nope")


def test_lp_bind_refuses_a_cpu_batch():
    """lp_fused.bind makes the C call for a CUDA batch only: a CPU tensor
    raises before anything is built or launched."""
    z = torch.zeros((2, 8), dtype=torch.float32)
    with pytest.raises(ValueError):
        PK.bind(z, z, torch.ones(2), torch.ones(2), torch.ones(2), 1.5, 30)


@pytest.mark.parametrize("with_float64", [False, True])
def test_fixed_trips_agree_holds_the_dual_objective(with_float64):
    """lp_fused.fixed_trips_agree, the rule by which the card test and
    chip_smoke.py hold B5's fixed-trip launches: the plain version's tiled
    loop (tb = 4) passes against tb = 1; a dual 1e-4 off fails; a row one
    trip apart passes with the plain version's dual and fails with an
    element 1e-2 off (held by its x with the float64 run, by its dual
    objective without)."""
    rng = np.random.RandomState(21)
    B, n = 6, 200
    y = np.cumsum(rng.randn(B, n), axis=1) * 0.3
    y = (y - y.mean(axis=1, keepdims=True)).astype(np.float32)
    args = [_t(a) for a in (y, np.zeros((B, n), np.float32),
                            np.full(B, 2.0, np.float32),
                            np.ones(B, np.float32), np.ones(B, np.float32))]
    w_r, _, _, it_r = PK.gpfw_fused_plain(*args, 3.0, 30, tb=1)
    w4, _, _, it4 = PK.gpfw_fused_plain(*args, 3.0, 30, tb=4)
    ref64 = (PK.gpfw_fused_plain(*[a.double() for a in args], 3.0, 30,
                                 tb=1)[::3] if with_float64 else None)
    assert float(it_r[0]) == 20.0  # row 0 stops by its test after 2 trips

    def agree(w, it):
        return PK.fixed_trips_agree(args[0], args[2], 3.0, w, it, w_r, it_r,
                                    ref64=ref64)[0]

    assert agree(w4, it4)
    assert not agree(w_r * (1 + 1e-4), it_r)
    apart = it_r.clone()
    apart[0] = 30.5  # still running at the cap, one trip later
    assert agree(w_r, apart)
    off = w_r.clone()
    off[0, n // 2] += 1e-2
    assert not agree(off, apart)
