"""Port vs JAX package: the banded solves of ``proxtv_tpu_torch.parallel``
(one image, volume or signal spanning the mesh: the 2D and 3D PDHG drivers
over kernels B3 and B6, the long-1D route over B1, on their plain versions
here).

The port runs in spawned gloo worlds (``tests/torch_dist_worker.py``,
JAX-free) of 3 ranks, and of 1 for the world-invariance checks; the JAX
package runs the same calls on a 3-device mesh of the virtual CPU mesh,
with Pallas in interpret mode.  Tolerances are ``tests/test_banded.py``'s:
2e-5 in float32 for the 2D and 3D solves (1e-5 for single-layer bands),
objectives within 1e-3 of the float64 dr / Parallel-Dykstra engines, 1e-12
between worlds for the long signal, 1e-10 against ``tv1_long`` and 1e-9
for the distributed PCR.
"""
import numpy as np
import pytest

import jax.numpy as jnp
from jax.experimental import pallas as pl

import torch_dist_worker as W
from proxtv_tpu.models import tv2d as J2
from proxtv_tpu.models import tvnd as JND
from proxtv_tpu.ops import tridiag as JT
from proxtv_tpu.ops import tv1d_l1 as J1
from proxtv_tpu.ops import tv1d_long as JLONG
from proxtv_tpu.parallel import sharded as JS

WORLD = 3


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield


def _same_on_every_rank(res, skip=("_counts",)):
    for key in res[0]:
        if not key.endswith(skip):
            for other in res[1:]:
                np.testing.assert_array_equal(other[key], res[0][key], key)
    return res[0]


def _inputs_2d():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(
        A=f(72, 40), U=f(50, 33), F1=f(17, 9), F2=f(9, 130), F3=f(33, 40),
        WIDE=f(40, 72), W=f(56, 30),
        W_c=(0.2 + 0.6 * rng.rand(55, 30)).astype(np.float32),
        W_r=(0.2 + 0.6 * rng.rand(56, 29)).astype(np.float32),
        WU=f(48, 24), WW=f(24, 64),
        WW_c=(0.5 + rng.rand(23, 64)).astype(np.float32),
        WW_r=(0.5 + rng.rand(24, 63)).astype(np.float32))


@pytest.fixture(scope="module")
def world_2d(tmp_path_factory):
    inp = _inputs_2d()
    return inp, _same_on_every_rank(W.run(
        "banded2d", WORLD, str(tmp_path_factory.mktemp("b2d")), **inp))


def _obj(X, Y, Wc, Wr):
    X = np.asarray(X, np.float64)
    return (0.5 * np.sum((X - Y) ** 2) + np.sum(Wc * np.abs(np.diff(X, axis=0)))
            + np.sum(Wr * np.abs(np.diff(X, axis=1))))


def test_banded_2d_matches_jax(world_2d):
    """Unweighted (tall, uneven rows, M below the mesh, N past a lane
    boundary) and weighted images against the JAX banded solve on the same
    mesh size, K = 2 and tm = 8 pinned; certified; the objective of the
    float64 dr engine within 1e-3; a K too tall for the band raises."""
    inp, out = world_2d
    mesh = JS.make_mesh(WORLD)
    for name, (key, lam, kw) in W.BANDED_2D.items():
        if name == "wide":
            continue
        xj, ij = JS.tv1_2d_banded(inp[key], lam, mesh, **kw)
        np.testing.assert_allclose(out[name], np.asarray(xj), atol=2e-5,
                                   err_msg=name)
        assert out[name].shape == inp[key].shape
    Y = inp["A"]
    assert out["a_rc"][0] == 0, out["a_gap"]
    xr, _ = J2.tv1_2d_batched(jnp.asarray(Y, jnp.float64)[None], 0.4,
                              method="dr", max_iters=300)
    one = lambda s: np.full(s, 0.4)  # noqa: E731
    M, N = Y.shape
    assert (_obj(out["a"], Y, one((M - 1, N)), one((M, N - 1)))
            <= _obj(np.asarray(xr)[0], Y, one((M - 1, N)), one((M, N - 1)))
            * (1 + 1e-3))
    Y, Wc, Wr = inp["W"], inp["W_c"], inp["W_r"]
    xj, _ = JS.tv1w_2d_banded(Y, Wc, Wr, mesh, k_steps=2, tm=8,
                              max_iters=600)
    np.testing.assert_allclose(out["w"], np.asarray(xj), atol=2e-5)
    assert out["w_rc"][0] == 0, out["w_gap"]
    xr, _ = J2.tv1w_2d_batched(jnp.asarray(Y, jnp.float64)[None],
                               jnp.asarray(Wc, jnp.float64)[None],
                               jnp.asarray(Wr, jnp.float64)[None],
                               method="dr", max_iters=300)
    assert _obj(out["w"], Y, Wc, Wr) <= _obj(np.asarray(xr)[0], Y, Wc,
                                             Wr) * (1 + 1e-3)
    # uniform weight fields are the scalar penalty; lam scales the fields
    assert out["wu_w_rc"][0] == 0
    np.testing.assert_allclose(out["wu_w"], out["wu_u"], atol=2e-5)
    np.testing.assert_allclose(out["wu_s"], out["wu_u"], atol=2e-5)
    assert "k_steps=64" in str(out["k_error"])


def test_banded_2d_world_invariance_and_orientation(world_2d, tmp_path):
    """Three ranks equal one (the JAX tests' invariance bar); a wide image
    runs transposed with the auto geometry (the longer axis banded) and
    equals the tall solve of its transpose; weighted too, where the weight
    fields swap with the orientation (objectives of the float64 dr
    engine)."""
    inp, out = world_2d
    one = W.run("banded2d", 1, str(tmp_path), **inp)[0]
    for key in ("a", "u", "f1", "f2", "f3", "w", "wide", "ww"):
        np.testing.assert_allclose(out[key], one[key], atol=2e-5,
                                   err_msg=key)
    np.testing.assert_allclose(out["wide"], out["wide_t"].T, atol=2e-5)
    Y = inp["WIDE"]
    M, N = Y.shape
    ref, _ = J2.tv1_2d_batched(jnp.asarray(Y)[None], 0.4, method="dr",
                               max_iters=300, use_fused=False)
    full = lambda s: np.full(s, 0.4)  # noqa: E731
    assert (_obj(out["wide"], Y, full((M - 1, N)), full((M, N - 1)))
            <= _obj(np.asarray(ref)[0], Y, full((M - 1, N)),
                    full((M, N - 1))) * (1 + 1e-3))
    Y, Wc, Wr = inp["WW"], inp["WW_c"], inp["WW_r"]
    ref, _ = J2.tv1w_2d_batched(jnp.asarray(Y)[None], jnp.asarray(Wc)[None],
                                jnp.asarray(Wr)[None], method="dr",
                                max_iters=300, use_fused=False)
    assert _obj(out["ww"], Y, Wc, Wr) <= _obj(np.asarray(ref)[0], Y, Wc,
                                              Wr) * (1 + 1e-3)


def test_banded_3d_matches_jax(tmp_path):
    """A tall volume, one banded along M (the longer axis, by the
    transpose) and one of single-layer bands grown to two, against the JAX
    banded solve on the same mesh size; the tall one certified and within
    1e-3 of the float64 Parallel-Dykstra objective."""
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    inp = dict(V=f(24, 10, 9), VM=f(9, 24, 10), VS=f(3, 3, 40))
    out = _same_on_every_rank(W.run("banded3d", WORLD, str(tmp_path), **inp))
    mesh = JS.make_mesh(WORLD)
    for name, key, kw, tol in (
            ("v", "V", dict(k_steps=1, tl=3, tm=8, max_iters=480), 2e-5),
            ("m", "VM", dict(k_steps=1, tl=3, tm=8, max_iters=480), 2e-5),
            ("s", "VS", dict(max_iters=96), 1e-5)):
        xj, ij = JS.tv1_3d_banded(inp[key], 0.3, mesh, **kw)
        np.testing.assert_allclose(out[name], np.asarray(xj), atol=tol,
                                   err_msg=name)
        np.testing.assert_array_equal(out[name + "_iters"],
                                      np.asarray(ij.iters))
    assert out["v_rc"][0] == 0 and out["m_rc"][0] == 0
    Y = inp["V"]
    xr, _ = JND.tv_nd_batched(jnp.asarray(Y, jnp.float64)[None],
                              (0.3, 0.3, 0.3), (1, 2, 3), (1.0, 1.0, 1.0),
                              method="pd", max_iters=300)

    def obj3(X):
        X = np.asarray(X, np.float64)
        return (0.5 * np.sum((X - Y) ** 2)
                + 0.3 * sum(np.abs(np.diff(X, axis=a)).sum()
                            for a in range(3)))

    assert obj3(out["v"]) <= obj3(np.asarray(xr)[0]) * (1 + 1e-3)


def _obj1(x, y, lam):
    return 0.5 * ((x - y) ** 2).sum() + (lam * np.abs(np.diff(x))).sum()


def test_banded_long1d_matches_jax(tmp_path):
    """A walk (certified by the glue) and a per-edge-weighted odd length:
    3 ranks equal 1 and the JAX banded solve on 3 devices to 1e-12, the
    walk the single-card ``tv1_long`` to 1e-10; the distributed PCR of the
    polish equals the masked single-card solve to 1e-9; overlap = 0
    raises."""
    rng = np.random.RandomState(0)
    n = 30000
    y = np.cumsum(rng.randn(n)) * 0.05 + rng.randn(n)
    n2 = 10011
    yw = np.cumsum(rng.randn(n2)) * 0.05 + rng.randn(n2)
    w = 0.5 + rng.rand(n2 - 1)
    nr = 64 * WORLD
    inp = dict(y=y, yw=yw, w=w, rhs=rng.randn(nr), mask=rng.rand(nr) > 0.3)
    out = _same_on_every_rank(W.run("long1d", WORLD, str(tmp_path), **inp))
    one = W.run("long1d", 1, str(tmp_path), y=y, yw=yw, w=w)[0]
    mesh = JS.make_mesh(WORLD)
    xj, ij = JS.tv1_1d_banded(jnp.asarray(y), 0.7, mesh, chunk=1024,
                              overlap=128)
    assert out["walk_rc"][0] == 0
    np.testing.assert_allclose(out["walk"], one["walk"], atol=1e-12)
    np.testing.assert_allclose(out["walk"], np.asarray(xj), atol=1e-12)
    xs, _ = JLONG.tv1_long(jnp.asarray(y), 0.7, chunk=1024, overlap=128)
    np.testing.assert_allclose(out["walk"], np.asarray(xs), atol=1e-10)
    xj, _ = JS.tv1_1d_banded(jnp.asarray(yw), jnp.asarray(w), mesh, chunk=512,
                             overlap=64)
    assert out["weighted_rc"][0] == 0
    np.testing.assert_allclose(out["weighted"], one["weighted"], atol=1e-12)
    np.testing.assert_allclose(out["weighted"], np.asarray(xj), atol=1e-12)
    ref = np.asarray(J1.tv1_tautstring(jnp.asarray(yw)[None],
                                       jnp.asarray(w)[None]))[0]
    assert _obj1(out["weighted"], yw, w) <= _obj1(ref, yw, w) * (1 + 1e-10)
    pcr = np.asarray(JT.spd_second_difference_solve(
        jnp.asarray(inp["rhs"])[None], mask=jnp.asarray(inp["mask"])[None]))[0]
    np.testing.assert_allclose(out["pcr"], np.where(inp["mask"], pcr, 0.0),
                               atol=1e-9)
    assert "overlap (0)" in str(out["overlap_error"])


def test_banded_long1d_escalation_matches_jax(tmp_path):
    """The escalation on the band: every window seam inside a flat (the
    shifted grid, the pinned-edge stitch on distributed segment minima,
    the PGD steps and the snaps) and a heavy penalty whose segments span
    many windows (also the warm projected-Newton polish on the distributed
    PCR): rc = 0, the JAX banded solve on 3 devices to 1e-12 with the same
    polish count, and the taut string's objective."""
    rng = np.random.RandomState(1)
    chunk, flat = 512, 200
    n = 32 * chunk
    yp = (np.repeat(rng.randn(-(-n // flat)), flat)[:n]
          + 0.1 * rng.randn(n))
    yh = rng.randn(4000)
    out = _same_on_every_rank(W.run("long1d", WORLD, str(tmp_path), yp=yp,
                                    yh=yh))
    mesh = JS.make_mesh(WORLD)
    for name, y, lam, chunk, overlap, rel in (
            ("plateau", yp, 5.0, 512, 64, 1e-8),
            ("heavy", yh, 25.0, 256, 64, 1e-10)):
        xj, ij = JS.tv1_1d_banded(jnp.asarray(y), lam, mesh, chunk=chunk,
                                  overlap=overlap)
        assert out[name + "_rc"][0] == 0, (name, out[name + "_gap"])
        np.testing.assert_allclose(out[name], np.asarray(xj), atol=1e-12,
                                   err_msg=name)
        np.testing.assert_array_equal(out[name + "_iters"],
                                      np.asarray(ij.iters))
        ref = np.asarray(J1.tv1_tautstring(jnp.asarray(y)[None],
                                           jnp.asarray(lam)))[0]
        assert (_obj1(out[name], y, lam) - _obj1(ref, y, lam)
                <= rel * _obj1(ref, y, lam)), name
    assert out["heavy_iters"][0] > 0  # the polish ran
