"""Port vs JAX package: the Lp-norm primitives of ``ops/lp.py`` (ball
projections, proxes, the linear oracle, the joint-KKT fast path and its
nested fallback), in float64 on the CPU.

Tolerances: the closed forms and the joint-KKT Newton are the same
arithmetic in both packages and agree to 1e-12 of the data's scale.  The
nested root-find (p outside the joint path's range, or the fallback) returns
the midpoint of each coordinate's safeguarded bracket, whose width after 18
bisections is 2^-18 of the max-normalized data; a one-ulp difference in a
comparison can keep one end of it from moving, so the two packages part by
up to ~2e-6 of the scale.  It is held at 2e-5 of the scale, inside the
5e-5 joint-vs-nested bar of tests/test_lp.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from proxtv_tpu.ops import lp as JLP
from proxtv_tpu_torch.ops import lp as PLP
from proxtv_tpu_torch.utils import debug

# Tier-1 runs several test processes on the machine's cores at once: one
# intra-op thread each, or every process's spinning thread pool slows the
# others' many small tensor ops (by ~20x under load).
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("p", [1.5, 2.0, 3.0, 5.0])
def test_ball_projection_general_matches_jax(p):
    """p = 1.5, 3 take the joint path, p = 5 (q outside [1.05, 3.6]) the
    nested root-find, p = 2 the radial shrink."""
    Y = np.random.RandomState(1).randn(6, 12) * 3
    xj = np.asarray(JLP.lp_ball_project(jnp.asarray(Y), 1.5, p))
    xp = PLP.lp_ball_project(_t(Y), 1.5, p).numpy()
    tol = 2e-5 if p == 5.0 else 1e-12
    np.testing.assert_allclose(xp, xj, atol=tol * np.abs(Y).max())
    assert np.all(np.sum(np.abs(xp) ** p, axis=1) <= 1.5 ** p * (1 + 1e-8))


def test_l1_linf_and_zero_radius_projections_match_jax():
    rng = np.random.RandomState(2)
    Y = rng.randn(8, 15) * 2
    for R in (2.0, rng.rand(8) * 3):
        np.testing.assert_allclose(
            PLP.l1_ball_project(_t(Y), _t(R) if np.ndim(R) else R).numpy(),
            np.asarray(JLP.l1_ball_project(jnp.asarray(Y), jnp.asarray(R))),
            atol=1e-12)
    small = Y * 1e-3  # inside the ball: identity
    np.testing.assert_array_equal(PLP.l1_ball_project(_t(small), 2.0).numpy(),
                                  small)
    np.testing.assert_allclose(PLP.linf_ball_project(_t(Y), 1.0).numpy(),
                               np.clip(Y, -1, 1))
    np.testing.assert_allclose(PLP.soft_threshold(_t(Y), 0.5).numpy(),
                               np.asarray(JLP.soft_threshold(jnp.asarray(Y),
                                                             0.5)))
    # R == 0 projects onto {0}: the Duchi rho index must not wrap.
    for p in (1.0, 1.5, 2.0, 3.0, 150.0):
        np.testing.assert_allclose(PLP.lp_ball_project(_t(Y), 0.0, p).numpy(),
                                   0.0, atol=1e-12, err_msg=str(p))
    for p in (1.0, 1.5, 2.0, 150.0):  # the prox of a 0-weighted norm
        np.testing.assert_allclose(PLP.lp_prox(_t(Y), 0.0, p).numpy(), Y,
                                   atol=1e-12, err_msg=str(p))


def test_prox_moreau_consistency_matches_jax():
    """prox_{t||.||_p}(y) + proj_{||.||_q <= t}(y) == y, the prox beats
    random perturbations in objective, and it matches the JAX prox."""
    rng = np.random.RandomState(3)
    Y = rng.randn(4, 10) * 2
    t = 0.8
    for p in (1.5, 2.0, 3.0, 150.0):
        P = PLP.lp_prox(_t(Y), t, p).numpy()
        np.testing.assert_allclose(P, np.asarray(JLP.lp_prox(jnp.asarray(Y),
                                                             t, p)),
                                   atol=1e-12)
        if p < 100:
            q = PLP.dual_p(p)
            np.testing.assert_allclose(
                P + PLP.lp_ball_project(_t(Y), t, q).numpy(), Y, atol=1e-12)
        pp = np.inf if p >= 100 else p
        for k in range(4):
            obj = 0.5 * np.sum((P[k] - Y[k]) ** 2) + t * np.linalg.norm(P[k],
                                                                         pp)
            for _ in range(10):
                z = P[k] + 0.01 * rng.randn(10)
                assert obj <= (0.5 * np.sum((z - Y[k]) ** 2)
                               + t * np.linalg.norm(z, pp) + 1e-10)


@pytest.mark.parametrize("p", [1.0, 1.5, 2.0, 3.0, 120.0])
def test_linear_oracle_matches_jax(p):
    """The oracle equals the JAX one and minimizes s'g over the ball."""
    rng = np.random.RandomState(4)
    G = rng.randn(5, 11)
    S = PLP.solve_linear_lp(_t(G), 1.3, p).numpy()
    np.testing.assert_allclose(S, np.asarray(JLP.solve_linear_lp(
        jnp.asarray(G), 1.3, p)), atol=1e-12)
    pp = np.inf if p >= 100.0 else p
    for k in range(5):
        assert np.linalg.norm(S[k], pp) <= 1.3 * (1 + 1e-6)
        z = rng.randn(30, 11)
        z = z / np.linalg.norm(z, pp, axis=1, keepdims=True) * 1.3
        assert np.dot(S[k], G[k]) <= (z @ G[k]).min() + 1e-8


@pytest.mark.parametrize("p", [1.3, 2.5, 3.0])
def test_joint_vs_nested_and_warm_restart_match_jax(p):
    """The joint path and the nested root-find each against JAX, across
    scales, cold and warm-started from the converged multiplier, and against
    each other at the bar of tests/test_lp.py."""
    rng = np.random.RandomState(5)
    tol = 1e-12
    for _ in range(2):
        Y = rng.randn(8, 40) * 10.0 ** rng.uniform(-2, 2)
        R = np.abs(rng.randn(8)) * 10.0 ** rng.uniform(-2, 1)
        scale = np.abs(Y).max()
        xj, mj = JLP._lp_ball_project_general(jnp.asarray(Y), jnp.asarray(R),
                                              p)
        xp, mp = PLP._lp_ball_project_general(_t(Y), _t(R), p)
        np.testing.assert_allclose(xp.numpy(), np.asarray(xj),
                                   atol=tol * scale)
        np.testing.assert_allclose(mp.numpy(), np.asarray(mj), rtol=1e-9)
        xnj, _ = JLP._lp_ball_project_nested(jnp.asarray(Y), jnp.asarray(R),
                                             p, mj)
        xnp, _ = PLP._lp_ball_project_nested(_t(Y), _t(R), p, mp)
        np.testing.assert_allclose(xnp.numpy(), np.asarray(xnj),
                                   atol=2e-5 * scale)
        np.testing.assert_allclose(xnp.numpy(), xp.numpy(), atol=5e-5 * scale)
        xw, _ = PLP._lp_ball_project_general(_t(Y), _t(R), p, mu0=mp)
        np.testing.assert_allclose(xw.numpy(), xp.numpy(), atol=1e-9 * scale)


def test_joint_rejection_merges_per_lane(monkeypatch):
    """One rejected lane takes the nested answer, the others keep the joint
    answer exactly; the decision is one counted host read."""
    p = 2.5
    Y = _t(np.random.RandomState(6).randn(6, 24) * 2)
    R = _t(np.full(6, 1.1))
    x_acc, mu_acc = PLP._lp_ball_project_general(Y, R, p)
    x_nest, mu_nest = PLP._lp_ball_project_nested(Y, R, p)
    real = PLP._joint_kkt_newton

    def fake(an, Rn, T, pp, mu_init, iters):
        s, mu, Fres, Gres = real(an, Rn, T, pp, mu_init, iters)
        Fres = Fres.clone()
        Fres[0] = 1.0  # reject lane 0 only
        return s, mu, Fres, Gres

    monkeypatch.setattr(PLP, "_joint_kkt_newton", fake)
    debug.HOST_SYNCS.reset()
    x_mix, mu_mix = PLP._lp_ball_project_general(Y, R, p)
    assert debug.HOST_SYNCS.value == 1
    np.testing.assert_array_equal(x_mix.numpy()[1:], x_acc.numpy()[1:])
    np.testing.assert_array_equal(mu_mix.numpy()[1:], mu_acc.numpy()[1:])
    np.testing.assert_array_equal(x_mix.numpy()[0], x_nest.numpy()[0])
    assert float(mu_mix[0]) == float(mu_nest[0])


def test_joint_projection_certificate_float32_gate():
    """Accepted joint solutions satisfy the KKT system to near machine
    precision; float32 gates the joint path to [1.12, 3.1] (p = 1.1 there
    takes the nested root-find)."""
    p = 2.5
    Y = np.random.RandomState(7).randn(8, 40) * 2
    x, mu = PLP._lp_ball_project_general(_t(Y), 1.2, p)
    x, mu = x.numpy(), mu.numpy()
    for k in range(8):
        assert np.sum(np.abs(x[k]) ** p) ** (1 / p) <= 1.2 * (1 + 1e-10)
        scale = np.abs(Y[k]).max()
        res = (np.abs(Y[k]) - np.abs(x[k])
               - mu[k] * p * np.abs(x[k]) ** (p - 1.0) * scale ** (2.0 - p))
        assert np.abs(res).max() < 1e-8 * scale
    Y32 = _t(Y.astype(np.float32))
    xn, _ = PLP._lp_ball_project_nested(Y32, 1.2, 1.1)
    xg, _ = PLP._lp_ball_project_general(Y32, 1.2, 1.1)
    np.testing.assert_array_equal(xg.numpy(), xn.numpy())


@pytest.mark.parametrize("p", [1.5, 3.0, 5.0])
def test_fw_gradient_by_update_matches_recomputed(p):
    """What kernel B5's exact line search rests on, in float64: along
    w + gamma d the gradient grad(primal(w)) is g + gamma Hd with
    Hd = D D' d, so the dual's curvature along d is d'Hd and the gradient
    at the step is known without an exchange.  Over one trip of
    fw_cycles - 1 = 9 steps, carrying the updated gradient, it reproduces
    the recomputed one to 1e-12 of its scale.  (In float32 the carried
    gradient drifts, so the kernel recomputes g from w and its halo, which
    its crossings keep exact.)"""
    from proxtv_tpu_torch.ops.kernels import lp_fused as LPK
    from proxtv_tpu_torch.ops.kernels.common import shift_left, shift_right

    rng = np.random.RandomState(int(p * 10))
    B, n, lam = 3, 40, 0.7
    y = _t(rng.randn(B, n))
    y = y - y.mean(dim=1, keepdim=True)
    v = (torch.arange(n) < n - 1).double().expand(B, n)
    q = p / (p - 1.0)
    w = torch.cat([PLP.lp_ball_project(_t(rng.randn(B, n - 1)), lam, q),
                   torch.zeros((B, 1), dtype=torch.float64)], dim=1)

    def grad(wk):
        x = y + (wk - shift_right(wk, 1, 0.0))
        return (x - shift_left(x, 1, 0.0)) * v

    g = grad(w)
    for _ in range(9):
        ag = g.abs()
        r = ag / ag.amax(dim=1, keepdim=True)
        den = (LPK._spow(r, p).sum(dim=1, keepdim=True)) ** ((p - 1.0) / p)
        d = (-lam * torch.sign(g) * LPK._spow(r, p - 1.0) / den - w) * v
        ad = d - shift_right(d, 1, 0.0)
        Hd = (ad - shift_left(ad, 1, 0.0)) * v
        num = -(g * d).sum(dim=1, keepdim=True)
        gamma = torch.clamp(num / (d * Hd).sum(dim=1, keepdim=True), 0.0, 1.0)
        w = w + gamma * d
        g = g + gamma * Hd
        g_new = grad(w)
        np.testing.assert_allclose(g.numpy(), g_new.numpy(),
                                   atol=1e-12 * float(g_new.abs().max()))


@pytest.mark.parametrize("p", [1.5, 3.0, 5.0])
def test_max_power_sum_pair_merge_matches_two_pass(p):
    """What kernel B5's one-crossing norms rest on, in float64: each warp
    takes the max m_w of its chunk and s_w = sum (|v| / m_w)^e against it;
    merged across warps as (M, sum_w s_w (m_w / M)^e), M = max m_w, the
    pair equals the two-pass (max, sum (|v| / max)^e) to 1e-12 relative,
    for the gap's and the oracle's exponent p and the projection's q, with
    a warp of zeros (its max clamped to 1e-30, as the kernel clamps it)."""
    from proxtv_tpu_torch.ops.kernels import lp_fused as LPK

    rng = np.random.RandomState(int(p * 10) + 1)
    W, per_warp = 8, 32 * 4
    a = np.abs(rng.randn(W, per_warp)) * np.logspace(-3, 2, W)[:, None]
    a[3] = 0.0
    for e in (p, p / (p - 1.0)):
        flat = _t(a.reshape(-1))
        M2 = flat.max()
        S2 = LPK._spow(flat / M2, e).sum()
        m = _t(a.max(axis=1))
        s = LPK._spow(_t(a) / torch.clamp(m, min=1e-30)[:, None], e).sum(1)
        M = m.max()
        S = (s * LPK._spow(m / torch.clamp(M, min=1e-30), e)).sum()
        assert float(M) == float(M2)
        np.testing.assert_allclose(float(S), float(S2), rtol=1e-12)
