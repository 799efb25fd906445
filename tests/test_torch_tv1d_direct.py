"""Port vs JAX package: the direct 1D TV-L1 engines (taut string, message-
passing DP, Condat, classic taut string), ``tv1_batched``'s routing table
and the native host engine, float64 on the CPU.

On the CPU the port runs each engine's plain version, the JAX package's
lock-step scan event for event, so the two agree to rounding: the bar is
1e-12 (the JAX package's direct engines are at <= 8.9e-16 from the C
reference, PARITY_r05).  Inputs are made from seeds with numpy.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from proxtv_tpu.ops import tv1d_l1 as J
from proxtv_tpu_torch.ops import tv1d_l1 as P

# Tier-1 runs several test processes on the machine's cores at once: one
# intra-op thread each, or every process's spinning thread pool slows the
# others' many small tensor ops (by ~20x under load).
torch.set_num_threads(1)

BAR = 1e-12
ENGINES = {"tautstring": (J.tv1_tautstring, P.tv1_tautstring),
           "dp": (J.tv1_dp, P.tv1_dp),
           "condat": (J.tv1_condat, P.tv1_condat),
           "classic_ts": (J.tv1_classic_ts, P.tv1_classic_ts)}
WEIGHTED = ("tautstring", "dp")


def _signals(seed, B, n):
    rng = np.random.RandomState(seed)
    return rng, rng.randn(B, n) * 2 + np.cumsum(rng.randn(B, n), axis=1) * 0.3


def _lam(kind, rng, B, n):
    if kind == "scalar":
        return float(rng.rand() + 0.3)
    if kind == "row":
        return rng.rand(B) * 1.5 + 0.05
    return rng.rand(B, n - 1) * 1.5  # per edge


def _both(engine, Y, lam):
    fj, fp = ENGINES[engine]
    lj = lam if np.ndim(lam) == 0 else jnp.asarray(lam)
    lp = lam if np.ndim(lam) == 0 else torch.from_numpy(np.asarray(lam))
    xj = np.asarray(fj(jnp.asarray(Y), lj))
    xp = fp(torch.from_numpy(Y), lp)
    assert xp.dtype == torch.float64 and tuple(xp.shape) == Y.shape
    return xp.numpy(), xj


@pytest.mark.parametrize("n", [1, 2, 3, 17, 257, 1000])
@pytest.mark.parametrize("engine,kind", [
    (e, k) for e in ENGINES for k in ("scalar", "row", "edge")
    if k != "edge" or e in WEIGHTED])
def test_engine_matches_jax(engine, kind, n):
    """Scalar, per-signal and per-edge weights (the last for the weighted
    engines; Condat and the classic taut string take one lambda)."""
    B = 5
    rng, Y = _signals(n + 7, B, n)
    xp, xj = _both(engine, Y, _lam(kind, rng, B, n))
    np.testing.assert_allclose(xp, xj, atol=BAR, rtol=0)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_degenerate_penalties(engine):
    """lam = 0 is the identity and a huge lam the mean, in both packages."""
    _, Y = _signals(1, 4, 40)
    x0, xj0 = _both(engine, Y, 0.0)
    np.testing.assert_array_equal(x0, Y)
    np.testing.assert_allclose(x0, xj0, atol=BAR)
    xh, xjh = _both(engine, Y, 1e9)
    np.testing.assert_allclose(xh, np.broadcast_to(Y.mean(1, keepdims=True),
                                                   Y.shape), atol=1e-12)
    np.testing.assert_allclose(xh, xjh, atol=BAR)


@pytest.mark.parametrize("engine", WEIGHTED)
def test_zero_weight_edges_match_jax(engine):
    """Edges of weight 0 decouple the signal (30% of them, and whole
    signals): the identity where every weight is 0, the JAX engine's result
    everywhere."""
    rng, Y = _signals(2, 8, 24)
    W = rng.rand(8, 23) * 1.5
    W[rng.rand(8, 23) < 0.3] = 0.0
    W[:2] = 0.0
    xp, xj = _both(engine, Y, W)
    np.testing.assert_array_equal(xp[:2], Y[:2])
    np.testing.assert_allclose(xp, xj, atol=BAR)


@pytest.mark.parametrize("engine", WEIGHTED)
def test_uniform_weights_equal_per_signal_lam(engine):
    """Per-edge weights that are uniform along each signal give the
    per-signal result (reference test_tv1w_1d_uniform_weights)."""
    rng, Y = _signals(3, 6, 30)
    lam = rng.rand(6) * 3
    fp = ENGINES[engine][1]
    a = fp(torch.from_numpy(Y), torch.from_numpy(np.repeat(lam[:, None], 29,
                                                           axis=1)))
    b = fp(torch.from_numpy(Y), torch.from_numpy(lam))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-10)


def test_condat_adversarial_patterns_match_jax():
    """Ties, plateaus, alternation, staircases and a jump of exactly 2 lam
    (tests/test_tv1d_l1.py's adversarial set) through both packages'
    Condat and taut-string engines."""
    n, lam = 120, 0.5
    rng = np.random.RandomState(4)
    cases = [np.zeros(n), np.repeat(rng.randn(n // 8), 8),
             np.tile([1.0, -1.0], n // 2), np.arange(n, dtype=float),
             np.concatenate([np.full(n // 2, 1.0), np.full(n - n // 2, -1.0)]),
             np.cumsum(np.tile([2 * lam, -2 * lam], n // 2))[:n]]
    Y = np.stack(cases)
    for engine in ("condat", "tautstring", "classic_ts"):
        xp, xj = _both(engine, Y, lam)
        np.testing.assert_allclose(xp, xj, atol=BAR, err_msg=engine)


def test_classic_tautstring_float32_tie_no_hang():
    """The float32 tie of tests/test_tv1d_l1.py:213: at lam = 0 on plateau
    data the two hulls' merged sums round differently, and a 1-ulp slope
    tie could fake a crossing of two single-segment hulls that empties a
    deque; the both-single guard keeps the scan finite.  Held against the
    port's taut string (1e-4, as there) and the identity at lam = 0."""
    rng = np.random.RandomState(5)
    truth = np.repeat(rng.randn(6), 30)
    noisy = (truth + 0.3 * rng.randn(truth.size)).astype(np.float32)
    y = torch.from_numpy(noisy[None])
    for lam in (0.0, 1e-7, 0.5):
        x = P.tv1_classic_ts(y, lam)
        xs = P.tv1_tautstring(y, torch.full((1, noisy.size - 1), lam))
        np.testing.assert_allclose(x.numpy(), xs.numpy(), atol=1e-4)
    np.testing.assert_array_equal(P.tv1_classic_ts(y, 0.0).numpy(),
                                  noisy[None])


def test_classic_tautstring_events_stay_under_the_cap(monkeypatch):
    """The classic taut string's cap of 8n + 64 events, which kernel D4
    keeps, is out of reach: on ties at lam 0 and 1e-7, plateaus,
    alternation, a NaN and an inf, walks and noise, its plain version's
    lock-step scan (run a step at a time here, each row's count the step at
    which it ends) ends every row within 6n - 5 events, the bound that
    csrc/classic_ts.cu derives for any data."""
    counts = []

    def counted(body, state, running, cap=None):
        steps = torch.zeros_like(state[0])
        for _ in range(cap):
            steps += state[0] != P._CT_DONE
            state = body(state)
            if not bool(running(state)):
                break
        counts.append(steps)
        return state

    monkeypatch.setattr(P, "_run_lockstep", counted)
    rng = np.random.RandomState(16)
    for n in (2, 3, 17, 64):
        y = np.concatenate([
            rng.randn(8, n), np.cumsum(rng.randn(8, n), axis=1),
            np.round(rng.randn(8, n) * 2) / 2,
            np.repeat(np.round(rng.randn(8, n // 4 + 1)), 4, axis=1)[:, :n],
            np.tile([1.0, -1.0], (4, n))[:, :n], np.zeros((1, n))])
        y[0, n // 2], y[1, -1] = np.nan, np.inf
        for lam in (0.0, 1e-7, 0.3, 2.0):
            counts.clear()
            P.tv1_classic_ts_plain(torch.from_numpy(y.astype(np.float32)),
                                   lam)
            assert int(counts[0].max()) <= 6 * n - 5 < 8 * n + 64, (n, lam)


PLAIN = {"condat": (J.tv1_condat, P.tv1_condat_plain),
         "classic_ts": (J.tv1_classic_ts, P.tv1_classic_ts_plain)}


@pytest.mark.parametrize("engine", list(PLAIN))
def test_plain_versions_match_jax(engine):
    """Kernels D3 and D4's plain versions (the lock-step scans the card
    holds the kernels against) equal the JAX engines, scalar and per-signal
    lam, and a negative lam clamped to 0 (the identity)."""
    fj, fp = PLAIN[engine]
    for n, kind in ((2, "scalar"), (64, "row")):
        rng, Y = _signals(n + 11, 4, n)
        lam = _lam(kind, rng, 4, n)
        lp = lam if np.ndim(lam) == 0 else torch.from_numpy(lam)
        lj = lam if np.ndim(lam) == 0 else jnp.asarray(lam)
        np.testing.assert_allclose(fp(torch.from_numpy(Y), lp).numpy(),
                                   np.asarray(fj(jnp.asarray(Y), lj)),
                                   atol=BAR, rtol=0)
    np.testing.assert_array_equal(fp(torch.from_numpy(Y), -0.5).numpy(), Y)


@pytest.mark.parametrize("kernel", ["condat", "classic_ts"])
def test_unweighted_kernel_wrappers_on_the_cpu(kernel):
    """The D3 / D4 wrappers on a CPU tensor return the plain version bit
    for bit (float32 and float64, scalar and per-signal lam); their bind
    refuses a CPU tensor (the kernels have no CPU mode); the C entry's
    weight arguments refuse a per-edge field and clamp a negative lam to 0
    as the plain versions do."""
    import importlib

    from proxtv_tpu_torch.ops.kernels import direct1d

    mod = importlib.import_module(f"proxtv_tpu_torch.ops.kernels.{kernel}")
    wrap, plain = getattr(mod, kernel), PLAIN[kernel][1]
    rng, Y = _signals(12, 5, 12)
    for yt in (torch.from_numpy(Y), torch.from_numpy(Y).float()):
        for lam in (0.8, torch.from_numpy(rng.rand(5)).to(yt.dtype)):
            ref = plain(yt, lam)
            assert torch.equal(wrap(yt, lam), ref)
            assert torch.equal(getattr(P, "tv1_" + kernel)(yt, lam), ref)
    with pytest.raises(ValueError, match="CUDA"):
        mod.bind(torch.from_numpy(Y).float(), 0.8)
    with pytest.raises(ValueError, match="unweighted"):
        wrap(torch.from_numpy(Y), torch.ones(5, 11, dtype=torch.float64))
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="unweighted"):
        direct1d.signal_lam_args(torch.ones(5, 39), 5, 40, cpu, kernel,
                                 mod.REF)
    assert direct1d.signal_lam_args(-0.5, 5, 40, cpu, kernel,
                                    mod.REF) == (None, 0, 0.0)
    field, rs, s = direct1d.signal_lam_args(
        torch.tensor([0.5, -1.0, 2.0, 0.0, 3.0]), 5, 40, cpu, kernel, mod.REF)
    assert s == 0.0 and field.shape == (5, 39) and field.stride() == (rs, 0)
    assert field[:, 0].tolist() == [0.5, 0.0, 2.0, 0.0, 3.0]


@pytest.mark.parametrize("method", ["condat", "classictautstring"])
def test_unweighted_methods_per_edge_policy(method):
    """Per-edge weights: strict raises (the named algorithm is unweighted);
    non-strict runs the taut string, as in the JAX package."""
    rng, Y = _signals(6, 4, 64)
    W = 0.5 + rng.rand(4, 63)
    x = P.tv1_batched(torch.from_numpy(Y), torch.from_numpy(W), method=method)
    ref = J.tv1_batched(jnp.asarray(Y), jnp.asarray(W), method=method)
    np.testing.assert_allclose(x.numpy(), np.asarray(ref), atol=BAR)
    with pytest.raises(ValueError):
        P.tv1_batched(torch.from_numpy(Y), torch.from_numpy(W), method=method,
                      strict=True)
    for fn in (P.tv1_condat, P.tv1_classic_ts):
        with pytest.raises(ValueError):
            fn(torch.from_numpy(Y), torch.from_numpy(W))


METHODS = ["classictautstring", "linearizedtautstring", "hybridtautstring",
           "pn", "condat", "dp", "condattautstring", "kolmogorov", "johnson",
           "tautstring"]


@pytest.mark.parametrize("strict", [False, True])
def test_tv1_batched_matches_jax_on_the_cpu(strict):
    """Every method name, strict or not, through both packages' tv1_batched
    on the CPU (where neither gate opens): the named engine runs."""
    _, Y = _signals(7, 3, 50)
    for m in METHODS:
        x = P.tv1_batched(torch.from_numpy(Y), 0.6, method=m, strict=strict)
        ref = J.tv1_batched(jnp.asarray(Y), 0.6, method=m, strict=strict)
        atol = 1e-8 if m == "pn" else BAR
        np.testing.assert_allclose(x.numpy(), np.asarray(ref), atol=atol,
                                   err_msg=m)


def test_tv1_batched_routing_contract(monkeypatch):
    """Which engine runs for every (method, strict, gate) combination,
    mirroring tests/test_tv1d_l1.py's contract for the JAX package: the gate
    is monkeypatched to simulate a CUDA float32 batch inside B1's lane
    limit (open) or the CPU / past the limit (closed); the engines are
    stubbed with recorders."""
    from proxtv_tpu_torch.ops.kernels import gating, pn_fused

    y = torch.randn(2, 16, dtype=torch.float64)
    calls = []

    def rec(name, ret):
        def f(*a, **k):
            calls.append(name)
            return ret
        return f

    monkeypatch.setattr(P, "tv1_tautstring", rec("scan", y))
    monkeypatch.setattr(P, "tv1_dp", rec("dp", y))
    monkeypatch.setattr(P, "tv1_condat", rec("condat", y))
    monkeypatch.setattr(P, "tv1_classic_ts", rec("classic", y))
    monkeypatch.setattr(P, "tv1_pn", rec("pn", (y, None)))
    monkeypatch.setattr(pn_fused, "pn_tv1_fused", rec("pn_fused", (y, None)))

    def run(method, strict, gate_open):
        calls.clear()
        monkeypatch.setattr(gating, "gate", lambda *a, **k: gate_open)
        P.tv1_batched(y, 0.5, method=method, strict=strict)
        assert len(calls) == 1, (method, strict, gate_open, calls)
        return calls[0]

    for m in ["hybridtautstring", "condattautstring", "linearizedtautstring",
              "tautstring"]:
        assert run(m, strict=False, gate_open=True) == "pn_fused"
        assert run(m, strict=True, gate_open=True) == "scan"
    for m in ["dp", "kolmogorov", "johnson"]:
        assert run(m, strict=False, gate_open=True) == "pn_fused"
        assert run(m, strict=True, gate_open=True) == "dp"
    assert run("condat", strict=False, gate_open=True) == "pn_fused"
    assert run("condat", strict=True, gate_open=True) == "condat"
    assert run("classictautstring", strict=False, gate_open=True) == "pn_fused"
    assert run("classictautstring", strict=True, gate_open=True) == "classic"
    assert run("pn", strict=False, gate_open=True) == "pn_fused"
    assert run("pn", strict=True, gate_open=True) == "pn_fused"
    for strict in (False, True):
        assert run("hybridtautstring", strict, gate_open=False) == "scan"
        assert run("dp", strict, gate_open=False) == "dp"
        assert run("condat", strict, gate_open=False) == "condat"
        assert run("classictautstring", strict, gate_open=False) == "classic"
        assert run("pn", strict, gate_open=False) == "pn"
    with pytest.raises(ValueError, match="Unknown"):
        P.tv1_batched(y, 0.5, method="nope")


def test_native_loader_matches_jax_native():
    """The port's own loader of native/tv1d_host.cpp (built into
    build/proxtv_tpu_torch/) against the JAX package's loader of the same
    source, scalar and per-edge weights."""
    from proxtv_tpu.runtime import native as JN
    from proxtv_tpu_torch.runtime import native as PN

    if not JN.available():
        pytest.skip("the JAX package's native library did not build here")
    assert PN.available()
    rng = np.random.RandomState(8)
    for n in (1, 2, 3, 100, 5000):
        y = np.cumsum(rng.randn(n)) * 0.4 + rng.randn(n)
        w = rng.rand(max(n - 1, 0)) * 2
        np.testing.assert_allclose(PN.tv1_host(y, 1.3), JN.tv1_host(y, 1.3),
                                   atol=BAR)
        if n > 1:
            np.testing.assert_allclose(PN.tv1w_host(y, w),
                                       JN.tv1w_host(y, w), atol=BAR)
    path = PN.build()
    assert path.startswith(PN.BUILD_DIR) and "libproxtv_host_" in path
    with pytest.raises(ValueError):
        PN.tv1w_host(np.zeros(5), np.ones(3))


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that fails raises with its log; it is not reported as
    "unavailable".  No compiler at all is."""
    from proxtv_tpu_torch.runtime import native as PN

    bad = tmp_path / "cxx"
    bad.write_text("#!/bin/sh\necho broken compiler >&2\nexit 1\n")
    bad.chmod(0o755)
    monkeypatch.setattr(PN, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(PN, "_lib", None)
    monkeypatch.setenv("CXX", str(bad))
    with pytest.raises(RuntimeError, match="broken compiler"):
        PN.available()
    assert not any(p.name.endswith(".so") for p in tmp_path.rglob("*"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert PN.available() is False


@pytest.mark.parametrize("n", [3183, 4742])
def test_classic_ts_plain_matches_jax_at_the_float64_layout_edges(n):
    """Kernel D4's plain version, which the card holds the float64 kernel
    against bit for bit, against the JAX package's float64
    ``tv1_classic_ts`` one signal one past the old float64 warp layout
    (3182) and one past the new one (4741, the longest signal whose 20-byte
    slots fit a block: the ring layout's first n), within 1e-12.  The
    plain version's lock-step scan takes 15-30 s a signal here."""
    rng, Y = _signals(n, 1, n)
    lam = float(rng.rand() + 0.3)
    xj = np.asarray(J.tv1_classic_ts(jnp.asarray(Y), lam))
    xp = P.tv1_classic_ts_plain(torch.from_numpy(Y), lam)
    assert xp.dtype == torch.float64
    np.testing.assert_allclose(xp.numpy(), xj, atol=BAR, rtol=0)


# The float64 batch rules of kernels D1 and D2, which the card reads from
# its library (csrc/tautstring.cu kGroup64MinB, csrc/dp.cu kWarp64MaxB):
# the CPU builds no library, so they are written here.
TS_GROUP_MIN_B, DP_WARP_MAX_B = 3960, 2640


def _dp_depths():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "dp_depths.py")
    spec = importlib.util.spec_from_file_location("dp_depths", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", ["randn", "walk lam 2", "per-edge", "ramp"])
def test_dp_depths_replica_matches_plain(case):
    """``tools/dp_depths.py``'s replica of kernel D2's scan, which sets the
    float64 ring's slots, gives the float64 plain version's output bit for
    bit on short signals (n <= 300; the plain version's lock-step scan is
    slow here), per-edge weights with zeros and a ramp among them; its
    live-breakpoint count is at least the two of a fresh deque."""
    dd = _dp_depths()
    rng = np.random.RandomState(len(case))
    n = 300
    if case == "randn":
        y, lam = rng.randn(n), 0.7
    elif case == "walk lam 2":
        y, lam = np.cumsum(rng.randn(n)), 2.0
    elif case == "per-edge":
        y = rng.randn(n) + np.cumsum(rng.randn(n)) * 0.1
        lam = rng.rand(n - 1) * 1.4
        lam[rng.rand(n - 1) < 0.05] = 0.0
    else:
        y, lam = np.linspace(0.0, 1.0, n), 0.7
    x, most, over = dd.scan(y, lam)
    lp = lam if np.ndim(lam) == 0 else torch.from_numpy(lam[None])
    ref = P.tv1_dp_plain(torch.from_numpy(y[None]), lp)[0].numpy()
    np.testing.assert_array_equal(x, ref)
    assert most >= 2 and over[dd.RING] == 0


@pytest.mark.parametrize("engine,case", [
    ("tautstring", "batch of the layout for large batches"),
    ("dp", "batch past the warp layout"),
    ("dp", "ring overflow")])
def test_direct_plain_matches_jax_at_the_float64_layout_edges(engine, case):
    """Kernels D1's and D2's plain versions, which the card holds their
    float64 layouts against bit for bit, against the JAX package's float64
    ``tv1_tautstring`` / ``tv1_dp`` within 1e-12 where those layouts part:
    the smallest batch of D1's layout for large batches (3960 signals of
    n = 8, per-edge weights), D2's smallest batch past one warp a signal
    (2641 signals of n = 8), and the signal whose deque outgrows D2's ring
    of 64 slots (``tools/dp_depths.py`` overflow_signal: a ramp of 1000 at
    lam 2, 91 breakpoints at once)."""
    if case == "ring overflow":
        y, lam = _dp_depths().overflow_signal()
        Y = y[None]
    else:
        B = TS_GROUP_MIN_B if engine == "tautstring" else DP_WARP_MAX_B + 1
        rng, Y = _signals(B, B, 8)
        lam = rng.rand(B, 7) * 1.5
    xp, xj = _both(engine, Y, lam)
    np.testing.assert_allclose(xp, xj, atol=BAR, rtol=0)
