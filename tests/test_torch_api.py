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
    rng = np.random.RandomState(1)
    x = np.cumsum(rng.randn(200)) * 0.3
    xj, ij = jptv.tv1_1d(x, 2.0, method="pn", return_info=True)
    xp, ip = ptv.tv1_1d(x, 2.0, method=method, return_info=True,
                        device="cpu")
    np.testing.assert_allclose(xp, xj, atol=1e-8)
    assert int(ip.rc[0]) == int(np.asarray(ij.rc)[0]) == 0


def test_api_direct_method_raises_until_ported():
    with pytest.raises(NotImplementedError, match="A8"):
        ptv.tv1_1d(np.zeros(8), 1.0, method="condat", device="cpu")


def test_api_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptv.tv1_2d(np.zeros((8, 8)), 0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptv.tv1_1d(np.zeros(8), 0.1)


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
        "from proxtv_tpu_torch.models import tv2d\n"
        "from proxtv_tpu_torch.ops.kernels import build, pcr, pn_fused, "
        "pdhg_fused\n"
        "from proxtv_tpu_torch.utils import interop, debug\n"
        "from proxtv_tpu_torch.demos import demo_filter_image\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'proxtv_tpu' or m.startswith('proxtv_tpu.')]\n"
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
