"""The port's long-signal route (``proxtv_tpu_torch.ops.tv1d_long``) against
the JAX package's ``tv1_long`` on the CPU, and the API routes that reach it:
``tv1_1d`` / ``tv1w_1d`` / ``tv`` auto past n = 16384.

The instances are those of ``tests/test_tv1d_long.py`` (the same seeds,
shapes, chunk and overlap), held at that file's bars in float64: 1e-8, 1e-6
for heavy smoothing, rc 0.  Each JAX shape compiles once (about ten seconds
on one core), so the n = 20000 instance is shared through module fixtures.

The checks are grouped into five tests on purpose.  pytest-xdist's loadfile
queue orders files by their number of tests; at five this file comes after
every other file but one, so the other files keep the order they had.  In
that order ``tests/test_native.py`` and ``tests/test_tv1d_long.py`` land on
different workers; run in one process after the JAX package's 1D tests,
that pair crashes XLA's compiler (ROADMAP C).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import proxtv_tpu as J
import proxtv_tpu_torch as P
from proxtv_tpu.ops import tv1d_long as JL
from proxtv_tpu_torch.ops import tv1d_l1
from proxtv_tpu_torch.ops import tv1d_long as TL
from proxtv_tpu_torch.ops.kernels import gating
from proxtv_tpu_torch.utils import debug

# Tier-1 runs several test processes on the machine's cores at once: one
# intra-op thread each, or every process's spinning thread pool slows the
# others' many small tensor ops (by ~20x under load).
torch.set_num_threads(1)


def _instance(name):
    """(Y, lam, chunk, overlap, atol) of the JAX test of the same name,
    drawn as it draws them from RandomState(0)."""
    rng = np.random.RandomState(0)
    if name == "matches_scan":
        n = 5000
        y = np.cumsum(rng.randn(n)) * 0.05 + rng.randn(n)
        return y, 0.7, 512, 128, 1e-8
    if name == "weighted":
        n = 3000
        y = np.cumsum(rng.randn(n)) * 0.05 + rng.randn(n)
        return y, 0.5 + rng.rand(n - 1), 512, 128, 1e-8
    if name == "heavy_smoothing":
        return rng.randn(4000), 25.0, 256, 64, 1e-6
    if name == "batched":
        n, S = 3000, 3
        Y = np.cumsum(rng.randn(S, n), axis=1) * 0.05 + rng.randn(S, n)
        return Y, 0.7, 512, 128, 1e-8
    if name == "batched_per_edge_weights":
        n, S = 2000, 2
        Y = np.cumsum(rng.randn(S, n), axis=1) * 0.05 + rng.randn(S, n)
        return Y, 0.5 + rng.rand(S, n - 1), 512, 128, 1e-8
    if name == "short_input_passthrough":
        return rng.randn(100), 0.5, 5120, 640, 1e-8
    if name == "plateau_seams":
        n = 20000
        y = np.repeat(rng.randn(n // 200), 200) + 0.1 * rng.randn(n)
        return y, 5.0, 512, 64, 1e-8
    if name == "plateau_every_seam_in_flat":
        chunk, flat = 512, 200
        n = 16 * chunk
        y = (np.repeat(rng.randn(-(-n // flat)), flat)[:n]
             + 0.1 * rng.randn(n))
        return y, 5.0, chunk, 64, 1e-8
    assert name == "batched_shared_weight_vector"
    S, n = 3, 4096
    Y = np.cumsum(rng.randn(S, n), axis=1) * 0.05 + rng.randn(S, n)
    return Y, 0.3 + rng.rand(n - 1), 512, 64, 1e-8


_INSTANCES = ["matches_scan", "weighted", "heavy_smoothing", "batched",
              "batched_per_edge_weights", "short_input_passthrough",
              "plateau_seams", "plateau_every_seam_in_flat",
              "batched_shared_weight_vector"]


def _port_lam(lam):
    return torch.from_numpy(lam) if isinstance(lam, np.ndarray) else lam


def test_tv1_long_matches_jax():
    """The port's tv1_long against the JAX package's in float64 on each
    instance of tests/test_tv1d_long.py, rc 0 on both."""
    for name in _INSTANCES:
        y, lam, chunk, overlap, atol = _instance(name)
        xj, ij = JL.tv1_long(jnp.asarray(y),
                             jnp.asarray(lam) if isinstance(lam, np.ndarray)
                             else lam, chunk=chunk, overlap=overlap)
        x, info = TL.tv1_long(torch.from_numpy(y), _port_lam(lam),
                              chunk=chunk, overlap=overlap)
        assert x.shape == y.shape and x.dtype == torch.float64, name
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=atol,
                                   err_msg=name)
        assert np.all(np.asarray(ij.rc) == 0), name
        assert torch.all(info.rc == 0), (name, info.gap)
        assert info.rc.shape == (1 if y.ndim == 1 else y.shape[0],), name


def test_windows_on_kernel_b1_layout_match_jax(monkeypatch):
    """The card's window route (kernel B1 with lam_full, a zero final
    column, and (K, win) warm starts) through B1's plain version on the
    CPU, forced by the gate: the same solution as the JAX package on the
    weighted instance and on the escalating plateau instance."""
    gate = gating.gate
    monkeypatch.setattr(gating, "gate", lambda y, kind: (
        True if kind == "pn_window" else gate(y, kind)))
    from proxtv_tpu_torch.ops.kernels import pn_fused

    launches = []
    fused = pn_fused.pn_tv1_fused

    def spy(Yw, lam_full, w_init=None, **kw):
        assert lam_full.shape == Yw.shape and torch.all(lam_full[:, -1] == 0)
        assert w_init is None or w_init.shape == Yw.shape
        assert kw["tol_eps"] == 0.0
        launches.append(w_init is not None)
        return fused(Yw, lam_full, w_init=w_init, **kw)

    monkeypatch.setattr(pn_fused, "pn_tv1_fused", spy)
    for name in ("weighted", "plateau_every_seam_in_flat"):
        y, lam, chunk, overlap, atol = _instance(name)
        xj, _ = JL.tv1_long(jnp.asarray(y),
                            jnp.asarray(lam) if isinstance(lam, np.ndarray)
                            else lam, chunk=chunk, overlap=overlap)
        x, info = TL.tv1_long(torch.from_numpy(y), _port_lam(lam),
                              chunk=chunk, overlap=overlap)
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=atol)
        assert torch.all(info.rc == 0)
    assert launches[0] is False and any(launches)  # cold, then warm resumes


def test_windows_and_their_gate():
    """_windows: window k covers [k chunk - overlap, (k+1) chunk + overlap)
    with zeros outside the array, batched over leading axes.  Kind
    "pn_window" has B1's lanes and, like kind "pn", composes past them
    (tv1_pn); a CPU tensor takes the plain route."""
    a = torch.arange(1.0, 11.0)
    w = TL._windows(a[None], 3, 4, 2)[0]
    assert w.shape == (3, 8)
    for k in range(3):
        for j in range(8):
            g = k * 4 - 2 + j
            assert float(w[k, j]) == (float(a[g]) if 0 <= g < 10 else 0.0)
    assert gating.lane_limits("pn_window") == gating.lane_limits("pn")
    assert not gating.gate(torch.zeros((2, 6400)), "pn_window")
    assert gating._KIND_LANE_LIMITS["pn_window"][2]


@pytest.fixture(scope="module")
def c2():
    """ROADMAP C2's instance: a random walk x 0.3 plus noise, seed 21,
    n = 20000 (past 16384), lam 2.0; and seeded weights for tv1w_1d."""
    rng = np.random.RandomState(21)
    n = 20000
    y = np.cumsum(rng.randn(n)) * 0.3 + rng.randn(n)
    w = 2.0 * (0.5 + rng.rand(n - 1))
    return y, w


@pytest.fixture(scope="module")
def c2_jax(c2):
    """The JAX package's auto routes on the C2 instance in float64 (its
    tv1_long): tv1_1d and tv1w_1d, with their SolverInfo."""
    y, w = c2
    return (J.tv1_1d(y, 2.0, return_info=True),
            J.tv1w_1d(y, w, return_info=True))


def test_float32_on_the_c2_walk(c2, c2_jax):
    """The fault C2: past 16384 the float32 solve must land within 2e-3 of
    float64 with rc 0 (float32 tv1_pn stopped 1.4e-2 away here; the JAX
    package's float32 tv1_long lands 7.4e-6 away).  With the weights the
    float32 certificate (2 eps 0.5||y - mean||^2) admits a solution 8.2e-2
    from float64 on a few samples, rc 0: the JAX package's float32
    tv1_long lands there too, and the port follows it within float32
    rounding (1e-4)."""
    y, w = c2
    (xj, _), (xwj, _) = c2_jax
    x32, info = TL.tv1_long(torch.from_numpy(y).float(), 2.0)
    assert x32.dtype == torch.float32 and int(info.rc[0]) == 0
    np.testing.assert_allclose(x32.double().numpy(), np.asarray(xj),
                               atol=2e-3)
    xj32, ij32 = JL.tv1_long(jnp.asarray(y, jnp.float32),
                             jnp.asarray(w, jnp.float32))
    xw32, iw32 = TL.tv1_long(torch.from_numpy(y).float(),
                             torch.from_numpy(w).float())
    assert int(iw32.rc[0]) == int(np.asarray(ij32.rc)[0]) == 0
    np.testing.assert_allclose(xw32.double().numpy(),
                               np.asarray(xj32, np.float64), atol=1e-4)
    e = np.abs(xw32.double().numpy() - np.asarray(xwj))
    ej = np.abs(np.asarray(xj32, np.float64) - np.asarray(xwj))
    assert abs(float(e.max()) - float(ej.max())) <= 1e-4


def _same_info(info, info_j, y):
    assert int(info.iters[0]) == int(np.asarray(info_j.iters)[0])
    assert int(info.rc[0]) == int(np.asarray(info_j.rc)[0]) == 0
    yc = y - y.mean()
    tol = max(1e-6, 2.0 * np.finfo(np.float64).eps
              * max(1.0, 0.5 * float(yc @ yc)))
    g, gj = float(info.gap[0]), float(np.asarray(info_j.gap)[0])
    assert 0.0 <= g <= tol and 0.0 <= gj <= tol


def test_auto_routes_past_16384_match_jax(c2, c2_jax, monkeypatch):
    """tv1_1d and tv1w_1d auto past 16384 run tv1_long on the CPU device
    route as the JAX package does: its x and SolverInfo (iterations, rc,
    gap within the tolerance), no host engine; tv follows, with a scalar
    and with the weight vector; maxbacktracks does not change that.  An
    explicit method keeps its own engine."""
    y, w = c2
    (xj, ij), (xwj, iwj) = c2_jax
    before = debug.HOST_ROUTE.value
    x, info = P.tv1_1d(y, 2.0, return_info=True, device="cpu")
    np.testing.assert_allclose(x, np.asarray(xj), atol=1e-8)
    _same_info(info, ij, y)
    for x_ in (P.tv1_1d(y, 2.0, device="cpu"), P.tv(y, 2.0, device="cpu"),
               P.tv1_1d(y, 2.0, maxbacktracks=4, device="cpu")):
        np.testing.assert_allclose(x_, np.asarray(xj), atol=1e-8)
    xw, infow = P.tv1w_1d(y, w, return_info=True, device="cpu")
    np.testing.assert_allclose(xw, np.asarray(xwj), atol=1e-8)
    _same_info(infow, iwj, y)
    np.testing.assert_allclose(P.tv(y, w, device="cpu"), np.asarray(xwj),
                               atol=1e-8)
    assert debug.HOST_ROUTE.value == before

    def no_long(*a, **k):
        raise AssertionError("an explicit method reached tv1_long")

    monkeypatch.setattr(TL, "tv1_long", no_long)
    seen = []
    pn = tv1d_l1.tv1_pn
    monkeypatch.setattr(tv1d_l1, "tv1_pn",
                        lambda *a, **k: seen.append(1) or pn(*a, **k))
    x, info = P.tv1_1d(y, 2.0, method="pn", return_info=True, device="cpu")
    assert seen and int(info.rc[0]) == 0
