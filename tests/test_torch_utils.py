"""Port vs JAX package: the utils layer (difference operators and
objectives), and the port's gating switch and profiling hook."""
import os
import threading
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from proxtv_tpu.utils import diffs as JD
from proxtv_tpu_torch.ops.kernels import gating
from proxtv_tpu_torch.utils import debug
from proxtv_tpu_torch.utils import diffs as PD


@pytest.mark.parametrize("fn", ["forward_diff", "primal2grad",
                                "adjoint_diff", "dual2primal",
                                "dual_objective", "tv1_objective",
                                "tv1w_objective"])
def test_diffs_match_jax(fn):
    rng = np.random.RandomState(0)
    y, x = rng.randn(3, 9), rng.randn(3, 9)
    w = rng.randn(3, 8)
    args = {"forward_diff": (y,), "primal2grad": (y,), "adjoint_diff": (w,),
            "dual2primal": (w, y), "dual_objective": (w, y),
            "tv1_objective": (x, y, 0.7),
            "tv1w_objective": (x, y, np.abs(w))}[fn]
    out_j = getattr(JD, fn)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                              else a for a in args))
    out_p = getattr(PD, fn)(*(torch.from_numpy(a) if isinstance(a, np.ndarray)
                              else a for a in args))
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), atol=1e-12)


def test_gate_refuses_cpu_and_follows_the_switch():
    y = torch.zeros((4, 64), dtype=torch.float32)
    for kind in ("pn", "pcr", "pdhg2d"):
        assert gating.gate(y, kind) is False  # CPU tensors never launch
    assert gating.lane_limits("pn") == (2, 8192)
    seen = {}

    def off_thread():
        with gating.fused_ctx(False):
            seen["inside"] = gating._fused_flag.get()
        seen["after"] = gating._fused_flag.get()

    th = threading.Thread(target=off_thread)
    th.start()
    th.join(timeout=20)
    assert not th.is_alive()
    assert seen == {"inside": False, "after": True}
    assert gating._fused_flag.get() is True


@pytest.mark.parametrize("case", ["float64", "lane_too_long", "lane_too_short",
                                  "switch_off"])
def test_gate_raises_for_cuda_input_the_kernel_cannot_take(case):
    """A CUDA tensor takes its kernel or raises; it never takes the plain
    composition.  The gate reads only device, dtype and shape, so a stand-in
    with those attributes plays the card tensor here."""
    n = {"lane_too_long": 9000, "lane_too_short": 1}.get(case, 64)
    dtype = torch.float64 if case == "float64" else torch.float32
    y = types.SimpleNamespace(is_cuda=True, dtype=dtype, shape=(4, n))
    err = RuntimeError if case == "switch_off" else ValueError
    with gating.fused_ctx(case != "switch_off"):
        with pytest.raises(err, match="pn kernel"):
            gating.gate(y, "pn")
    ok = types.SimpleNamespace(is_cuda=True, dtype=torch.float32,
                               shape=(4, 64))
    assert gating.gate(ok, "pn") is True


def test_profile_ctx_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("PROXTV_TPU_PROFILE", str(tmp_path))
    with debug.profile_ctx("unit"):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "unit.json") > 0
    monkeypatch.setenv("PROXTV_TPU_PROFILE", "")
    with debug.profile_ctx("off"):
        pass
    assert not (tmp_path / "off.json").exists()


def test_dprint_and_host_sync_counter(capsys, monkeypatch):
    debug.HOST_SYNCS.reset()
    assert debug.host(torch.tensor([1, 2])) == [1, 2]
    assert debug.HOST_SYNCS.value == 1
    monkeypatch.setenv("PROXTV_TPU_DEBUG", "1")
    debug.dprint("it {i}: {d}", i=3, d=torch.tensor(0.5))
    assert capsys.readouterr().out.strip() == "it 3: 0.5"
    monkeypatch.setenv("PROXTV_TPU_DEBUG", "0")
    debug.dprint("silent {i}", i=1)
    assert capsys.readouterr().out == ""
