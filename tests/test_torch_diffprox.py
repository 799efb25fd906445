"""The port's differentiable prox path (``proxtv_tpu_torch.ops.diffprox``,
``models.layers``) against the JAX package's (``proxtv_tpu.ops.diffprox``,
the flax layers), on the CPU in float64, at the shapes of
tests/test_diffprox.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from proxtv_tpu.ops import diffprox as jdp
from proxtv_tpu_torch.models import layers
from proxtv_tpu_torch.ops import diffprox
from proxtv_tpu_torch.utils import interop

F64 = torch.float64


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=F64, requires_grad=grad)


@pytest.mark.parametrize("lam_kind", ["scalar", "per_row"])
def test_tv1_prox_matches_jax_and_finite_differences(lam_kind):
    """Forward, gy and glam against the JAX VJP to 1e-10; then the
    finite-difference check of test_vjp_matches_finite_differences (2e-4)."""
    rng = np.random.RandomState(0)
    B, n = 3, 24
    Y = rng.randn(B, n)
    g = rng.randn(B, n)
    lam = np.float64(0.6) if lam_kind == "scalar" else np.array([0.3, 0.6,
                                                                 1.1])

    def fj(y, lam_):
        return jnp.sum(jdp.tv1_prox(y, lam_) * g)

    xj = np.asarray(jdp.tv1_prox(jnp.asarray(Y), jnp.asarray(lam)))
    gyj, glj = jax.grad(fj, argnums=(0, 1))(jnp.asarray(Y), jnp.asarray(lam))
    y_t, lam_t = _t(Y, True), _t(lam, True)
    x = diffprox.tv1_prox(y_t, lam_t)
    (x * _t(g)).sum().backward()
    np.testing.assert_allclose(x.detach().numpy(), xj, atol=1e-10)
    np.testing.assert_allclose(y_t.grad.numpy(), np.asarray(gyj), atol=1e-10)
    assert lam_t.grad.shape == lam_t.shape
    np.testing.assert_allclose(lam_t.grad.numpy(), np.asarray(glj),
                               atol=1e-10)

    def f(y, lam_):
        with torch.no_grad():
            return float((diffprox.tv1_prox(y, lam_) * _t(g)).sum())

    eps = 1e-5
    Yt, lt = _t(Y), _t(lam)
    for _ in range(5):
        d = rng.randn(B, n)
        d = _t(d / np.linalg.norm(d))
        num = (f(Yt + eps * d, lt) - f(Yt - eps * d, lt)) / (2 * eps)
        np.testing.assert_allclose(num, float((y_t.grad * d).sum()),
                                   atol=2e-4)
    num = (f(Yt, lt + eps) - f(Yt, lt - eps)) / (2 * eps)
    np.testing.assert_allclose(num, float(lam_t.grad.sum()), atol=2e-4)


@pytest.mark.parametrize("dim", ["1d", "2d"])
def test_vjp_projector_properties(dim):
    """J is an averaging projector: J(Jg) == Jg, and (1D) J ones == ones, as
    tests/test_diffprox.py holds the JAX VJPs (1e-10 / 1e-8)."""
    rng = np.random.RandomState(0)
    if dim == "1d":
        Y = _t(rng.randn(2, 30))
        g = _t(rng.randn(2, 30))
        fn, atol = (lambda y: diffprox.tv1_prox(y, 0.8)), 1e-10
    else:
        Y = _t(rng.randn(1, 8, 8))
        g = _t(rng.randn(1, 8, 8))
        fn, atol = (lambda y: diffprox.tv2d_prox(y, 0.6, "dr", 300)), 1e-8

    def apply_jt(v):
        y = Y.clone().requires_grad_(True)
        (gy,) = torch.autograd.grad(fn(y), y, grad_outputs=v)
        return gy

    jg = apply_jt(g)
    np.testing.assert_allclose(apply_jt(jg).numpy(), jg.numpy(), atol=atol)
    if dim == "1d":
        ones = torch.ones_like(Y)
        np.testing.assert_allclose(apply_jt(ones).numpy(), ones.numpy(),
                                   atol=atol)


@pytest.mark.parametrize("method,iters", [("pd", 2000), ("dr", 300)])
def test_tv2d_prox_vjp_matches_jax(method, iters):
    """The 2D VJP against JAX's to 1e-8 (the shape of
    test_2d_vjp_matches_finite_differences); lam gets zeros, as jax.grad
    gives; the finite-difference check (5e-4) on the pd case."""
    rng = np.random.RandomState(0)
    B, M, N = 2, 10, 9
    Y = rng.randn(B, M, N)
    g = rng.randn(B, M, N)

    def fj(y, lam_):
        return jnp.sum(jdp.tv2d_prox(y, lam_, method, iters) * g)

    gyj, glj = jax.grad(fj, argnums=(0, 1))(jnp.asarray(Y), jnp.asarray(0.5))
    y_t, lam_t = _t(Y, True), _t(0.5, True)
    x = diffprox.tv2d_prox(y_t, lam_t, method, iters)
    (x * _t(g)).sum().backward()
    np.testing.assert_allclose(y_t.grad.numpy(), np.asarray(gyj), atol=1e-8)
    assert float(lam_t.grad) == float(glj) == 0.0
    if method != "pd":
        return

    def f(y):
        with torch.no_grad():
            return float((diffprox.tv2d_prox(y, 0.5, method, iters)
                          * _t(g)).sum())

    eps = 1e-5
    for _ in range(4):
        d = rng.randn(B, M, N)
        d = _t(d / np.linalg.norm(d))
        num = (f(_t(Y) + eps * d) - f(_t(Y) - eps * d)) / (2 * eps)
        np.testing.assert_allclose(num, float((y_t.grad * d).sum()),
                                   atol=5e-4)


def test_gradcheck_tv1_prox():
    """torch.autograd.gradcheck of the 1D VJP (y and a (B,) lam) on a small
    input whose segments stay put under the check's perturbations."""
    rng = np.random.RandomState(1)
    y = _t(np.repeat(rng.randn(2, 4), 3, axis=1) + 0.05 * rng.randn(2, 12),
           True)
    lam = _t([0.2, 0.3], True)
    assert torch.autograd.gradcheck(
        lambda y_, l_: diffprox.tv1_prox(y_, l_), (y, lam), eps=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("dim", ["1d", "2d"])
def test_layers_match_flax(dim):
    """TVDenoise1D / TVDenoise2D against the flax layers, from the same
    raw_lam carried by interop.layer_state: forward and gradients to 1e-10;
    then (1D) 10 Adam steps on raw_lam against optax.adam(0.05), raw_lam
    within 1e-9 at every step, and the loss falls (as
    test_flax_layer_learns_lambda)."""
    import optax
    from proxtv_tpu.models import layers as jlayers

    rng = np.random.RandomState(0)
    if dim == "1d":
        truth = np.repeat(rng.randn(5), 10)[None, :]
        jl, tl = jlayers.TVDenoise1D(init_lam=0.01), layers.TVDenoise1D(
            init_lam=0.01, device="cpu")
    else:
        truth = np.repeat(np.repeat(rng.randn(1, 3, 3), 4, 1), 4, 2)
        jl = jlayers.TVDenoise2D(init_lam=0.3, max_iters=300)
        tl = layers.TVDenoise2D(init_lam=0.3, max_iters=300, device="cpu")
    noisy = truth + 0.3 * rng.randn(*truth.shape)
    params = jl.init(jax.random.PRNGKey(0), jnp.asarray(noisy))
    params = {"params": {"raw_lam": params["params"]["raw_lam"] + 0.1}}
    tl.load_state_dict(interop.layer_state(params, device="cpu"))
    assert tl.raw_lam.dtype == F64

    def jloss(p, y):
        return jnp.mean((jl.apply(p, y) - truth) ** 2)

    def tloss(y):
        return torch.mean((tl(y) - _t(truth)) ** 2)

    y_t = _t(noisy, True)
    lt = tloss(y_t)
    lt.backward()
    lj, (gpj, gyj) = jax.value_and_grad(jloss, argnums=(0, 1))(
        params, jnp.asarray(noisy))
    np.testing.assert_allclose(float(lt.detach()), float(lj), atol=1e-10)
    np.testing.assert_allclose(y_t.grad.numpy(), np.asarray(gyj), atol=1e-10)
    np.testing.assert_allclose(float(tl.raw_lam.grad),
                               float(gpj["params"]["raw_lam"]), atol=1e-10)
    back = interop.layer_params(tl)["params"]["raw_lam"]
    np.testing.assert_array_equal(back,
                                  np.asarray(params["params"]["raw_lam"]))
    if dim == "2d":
        return
    opt = optax.adam(0.05)
    state = opt.init(params)
    topt = torch.optim.Adam(tl.parameters(), lr=0.05)
    y0 = _t(noisy)
    l0 = float(tloss(y0).detach())
    for _ in range(10):
        g = jax.grad(jloss)(params, jnp.asarray(noisy))
        upd, state = opt.update(g, state)
        params = optax.apply_updates(params, upd)
        topt.zero_grad()
        tloss(y0).backward()
        topt.step()
        np.testing.assert_allclose(float(tl.raw_lam.detach()),
                                   float(params["params"]["raw_lam"]),
                                   atol=1e-9)
    assert float(tloss(y0).detach()) < l0
