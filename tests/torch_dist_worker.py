"""Runs the port's parallel path in a spawned gloo world (JAX-free).

    python tests/torch_dist_worker.py SUITE WORLD RANK STORE IN OUT

Each rank joins a ``torch.distributed`` gloo group of WORLD ranks (a file
store at STORE), builds the mesh (on the CPU; on the card for the suite
``card``, every rank on ``cuda:<rank mod cards>``), runs the cases of SUITE on the
inputs in the ``.npz`` file IN and writes what it got to OUT with its rank
appended (``OUT.<rank>.npz``): every rank gets the whole result, so the
test compares the ranks too.  :func:`run` starts a world from a test.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(suite, world, tmp_path, timeout=300, **inputs):
    """Start a world of ``world`` ranks on ``inputs`` (numpy arrays) and
    return each rank's outputs (a list of dicts), after every rank exited
    with 0 inside ``timeout`` seconds."""
    tag = f"{suite}{world}"
    src = os.path.join(tmp_path, f"{tag}.in.npz")
    out = os.path.join(tmp_path, f"{tag}.out")
    store = os.path.join(tmp_path, f"{tag}.store")
    np.savez(src, **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), suite, str(world),
         str(r), store, src, out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(logs)
    res = []
    for r in range(world):
        with np.load(f"{out}.{r}.npz") as f:
            res.append({k: f[k] for k in f.files})
    return res


def _np(t):
    return t.detach().cpu().numpy()


def _info(prefix, info, out):
    out[prefix + "_iters"] = _np(info.iters)
    out[prefix + "_gap"] = _np(info.gap)
    out[prefix + "_rc"] = _np(info.rc)


def _counters():
    from proxtv_tpu_torch.utils import debug

    return {k: getattr(debug, k).value for k in (
        "EXCHANGES", "ALL_REDUCES", "GATHERS", "HOST_SYNCS")}


def _reset():
    from proxtv_tpu_torch.utils import debug

    for k in ("EXCHANGES", "ALL_REDUCES", "GATHERS", "BYTES_MOVED",
              "STAGING_COPIES", "HOST_SYNCS"):
        getattr(debug, k).reset()


# The column-split 2D solves beside dr: every other method on a scalar lam,
# the per-image lam of the splitting methods, and the methods that raise on
# a per-image lam, as the JAX package's raise.
COLS_METHODS = ("pd", "yang", "condat", "chambolle-pock",
                "chambolle-pock-acc", "kolmogorov")
COLS_PER_IMAGE = ("pd", "dr", "yang")
COLS_PER_IMAGE_RAISE = ("chambolle-pock", "kolmogorov")


def suite_batch(mesh, inp):
    """The batch-split entry points and the column-split 2D combiner."""
    from proxtv_tpu_torch import parallel as P

    out = {}
    out["tv1"] = _np(P.tv1_1d_sharded(inp["Y1"], 0.7, mesh))
    x, info = P.tv2_1d_sharded(inp["Y1"], 0.8, mesh)
    out["tv2"] = _np(x)
    _info("tv2", info, out)
    x, _ = P.tvp_1d_sharded(inp["Y1"], 0.5, 1.5, mesh)
    out["tvp"] = _np(x)
    x, _ = P.tv_nd_sharded(inp["Y4"], (0.3, 0.3, 0.3), (1, 2, 3),
                           (1.0, 1.0, 1.0), mesh, max_iters=20)
    out["nd"] = _np(x)
    x, info = P.tv1_2d_sharded(inp["Y2"], 0.4, mesh, max_iters=40)
    out["b2d"] = _np(x)
    _info("b2d", info, out)
    x, info = P.tv1_2d_sharded(inp["Yc"], 0.4, mesh, max_iters=40,
                               shard_axis="cols")
    out["cols"] = _np(x)
    _info("cols", info, out)
    for m in COLS_METHODS:
        _reset()
        x, info = P.tv1_2d_sharded(inp["Yc2"], 0.4, mesh, method=m,
                                   max_iters=40, shard_axis="cols")
        out["cols_" + m] = _np(x)
        _info("cols_" + m, info, out)
        out["cols_" + m + "_exchanges"] = np.array(_counters()["EXCHANGES"])
    for m in COLS_PER_IMAGE:
        x, info = P.tv1_2d_sharded(inp["Yc2"], inp["lam_pi"], mesh, method=m,
                                   max_iters=40, shard_axis="cols")
        out["cols_pi_" + m] = _np(x)
        _info("cols_pi_" + m, info, out)
    for m in COLS_PER_IMAGE_RAISE:
        try:
            P.tv1_2d_sharded(inp["Yc2"], inp["lam_pi"], mesh, method=m,
                             max_iters=40, shard_axis="cols")
            out["cols_pi_error_" + m] = np.array("")
        except ValueError as e:
            out["cols_pi_error_" + m] = np.array(str(e))
    _reset()
    x, info = P.tv1_2d_sharded_fused(inp["Yf"], 0.4, mesh,
                                     method="chambolle-pock", max_iters=200)
    c = _counters()
    out["fused"] = _np(x)
    _info("fused", info, out)
    out["fused_counts"] = np.array([c["EXCHANGES"], c["ALL_REDUCES"],
                                    c["GATHERS"]])
    x, info = P.tv1w_2d_sharded_fused(inp["Yw"], inp["Wc"], inp["Wr"], mesh,
                                      method="dr", max_iters=40)
    out["fusedw"] = _np(x)
    _info("fusedw", info, out)
    try:
        P.tv1_2d_sharded_fused(inp["Yf"][:mesh.size + 1], 0.4, mesh)
        out["divisible_error"] = np.array("")
    except ValueError as e:
        out["divisible_error"] = np.array(str(e))
    try:
        P.make_mesh(mesh.size + 1, device="cpu")
        out["n_devices_error"] = np.array("")
    except ValueError as e:
        out["n_devices_error"] = np.array(str(e))
    return out


# The banded 2D cases: (input key, lam, solver arguments); the geometry of
# the JAX package's tests/test_banded.py.
BANDED_2D = {
    "a": ("A", 0.4, dict(k_steps=2, tm=8, max_iters=600)),
    "u": ("U", 0.3, dict(k_steps=2, tm=8, max_iters=480)),
    "f1": ("F1", 0.3, dict(k_steps=2, tm=8, max_iters=240)),
    "f2": ("F2", 0.3, dict(k_steps=2, tm=8, max_iters=240)),
    "f3": ("F3", 0.3, dict(k_steps=2, tm=8, max_iters=240)),
    "wide": ("WIDE", 0.4, dict(max_iters=300)),
}


def suite_banded2d(mesh, inp):
    """The banded 2D PDHG, unweighted and weighted."""
    from proxtv_tpu_torch import parallel as P

    out = {}
    for name, (key, lam, kw) in BANDED_2D.items():
        x, info = P.tv1_2d_banded(inp[key], lam, mesh, **kw)
        out[name] = _np(x)
        _info(name, info, out)
    x, _ = P.tv1_2d_banded(inp["WIDE"].T.copy(), 0.4, mesh, max_iters=300)
    out["wide_t"] = _np(x)
    x, info = P.tv1w_2d_banded(inp["W"], inp["W_c"], inp["W_r"], mesh,
                               k_steps=2, tm=8, max_iters=600)
    out["w"] = _np(x)
    _info("w", info, out)
    Y = inp["WU"]
    M, N = Y.shape
    kw = dict(k_steps=2, tm=8, max_iters=480)
    x, info = P.tv1w_2d_banded(Y, np.full((M - 1, N), 0.4, np.float32),
                               np.full((M, N - 1), 0.4, np.float32), mesh,
                               **kw)
    out["wu_w"] = _np(x)
    _info("wu_w", info, out)
    out["wu_u"] = _np(P.tv1_2d_banded(Y, 0.4, mesh, **kw)[0])
    out["wu_s"] = _np(P.tv1_2d_banded(
        Y, 0.4, mesh, W_col=np.ones((M - 1, N), np.float32),
        W_row=np.ones((M, N - 1), np.float32), **kw)[0])
    x, _ = P.tv1w_2d_banded(inp["WW"], inp["WW_c"], inp["WW_r"], mesh,
                            max_iters=300)
    out["ww"] = _np(x)
    try:
        P.tv1_2d_banded(inp["A"], 0.4, mesh, k_steps=64, tm=8)
        out["k_error"] = np.array("")
    except ValueError as e:
        out["k_error"] = np.array(str(e))
    return out


def suite_banded3d(mesh, inp):
    """The banded 3D PDHG: a tall volume, one banded along M, and one of
    single-layer bands."""
    from proxtv_tpu_torch import parallel as P

    out = {}
    for name, key, kw in (
            ("v", "V", dict(k_steps=1, tl=3, tm=8, max_iters=480)),
            ("m", "VM", dict(k_steps=1, tl=3, tm=8, max_iters=480)),
            ("s", "VS", dict(max_iters=96))):
        x, info = P.tv1_3d_banded(inp[key], 0.3, mesh, **kw)
        out[name] = _np(x)
        _info(name, info, out)
    return out


def suite_long1d(mesh, inp):
    """The banded long 1D solve: a walk (the pass-1 certificate), the
    weighted odd length and the adversarial plateaus (the whole
    escalation), and the distributed PCR."""
    import torch

    from proxtv_tpu_torch import parallel as P
    from proxtv_tpu_torch.ops import tv1d_long_banded as LB

    out = {}
    cases = []
    if "y" in inp:
        cases.append(("walk", "y", 0.7, 1024, 128))
    if "yw" in inp:
        cases.append(("weighted", "yw", inp["w"], 512, 64))
    if "yp" in inp:
        cases.append(("plateau", "yp", 5.0, 512, 64))
    if "yh" in inp:
        cases.append(("heavy", "yh", 25.0, 256, 64))
    for name, key, lam, chunk, overlap in cases:
        _reset()
        x, info = P.tv1_1d_banded(inp[key], lam, mesh, chunk=chunk,
                                  overlap=overlap)
        out[name] = _np(x)
        _info(name, info, out)
        c = _counters()
        out[name + "_counts"] = np.array([c["EXCHANGES"], c["ALL_REDUCES"],
                                          c["GATHERS"], c["HOST_SYNCS"]])
    if "rhs" in inp:
        n_l = inp["rhs"].shape[0] // mesh.size
        sl = slice(mesh.rank * n_l, (mesh.rank + 1) * n_l)
        d = LB._pcr_masked_banded(torch.from_numpy(inp["rhs"][sl]),
                                  torch.from_numpy(inp["mask"][sl]), mesh)
        out["pcr"] = _np(P.sharded.comm.all_gather(mesh, d))
    try:
        P.tv1_1d_banded(np.zeros(4096, np.float32), 1.0, mesh, chunk=256,
                        overlap=0)
        out["overlap_error"] = np.array("")
    except ValueError as e:
        out["overlap_error"] = np.array(str(e))
    return out


def suite_segscan(mesh, inp):
    """Segment mean and minimum over the band, for each flag layout."""
    import torch

    from proxtv_tpu_torch.parallel import comm, segscan

    out = {}
    x = torch.from_numpy(inp["x"])
    n_l = x.shape[0] // mesh.size
    sl = slice(mesh.rank * n_l, (mesh.rank + 1) * n_l)
    for i, starts in enumerate(inp["starts"]):
        s = torch.from_numpy(starts[sl].astype(np.float64))
        nxt = comm.permute(mesh, [(s[:1], -1)])[0]
        tail = torch.ones(1, dtype=s.dtype) if mesh.rank == mesh.size - 1 \
            else nxt
        se = torch.cat([s[1:], tail])
        m = segscan.segment_mean(x[sl], s, mesh, se)
        mn = segscan.segment_min(x[sl], s, mesh, se)
        out[f"mean{i}"] = _np(comm.all_gather(mesh, m))
        out[f"min{i}"] = _np(comm.all_gather(mesh, mn))
    return out


def suite_card(mesh, inp):
    """The banded 2D, 3D and long-1D solves on the card (both ranks may
    share it), with each call's launches and traffic."""
    import torch

    from proxtv_tpu_torch import parallel as P
    from proxtv_tpu_torch.ops.kernels import pdhg3d_fused as B6
    from proxtv_tpu_torch.ops.kernels import pdhg_fused as B3
    from proxtv_tpu_torch.ops.kernels import pn_fused as B1
    from proxtv_tpu_torch.utils import debug

    out = {}
    for name, kid, call in (
            ("b2d", B3, lambda: P.tv1_2d_banded(inp["Y"], 0.3, mesh)),
            ("b3d", B6, lambda: P.tv1_3d_banded(inp["V"], 0.3, mesh)),
            ("b1d", B1, lambda: P.tv1_1d_banded(inp["y"], 0.7, mesh,
                                                chunk=1024, overlap=128))):
        _reset()
        before = kid.LAUNCHES.value
        x, info = call()
        torch.cuda.synchronize()
        assert x.device == mesh.device and info.gap.device == mesh.device
        out[name] = _np(x)
        _info(name, info, out)
        out[name + "_counts"] = np.array([
            kid.LAUNCHES.value - before, debug.EXCHANGES.value,
            debug.STAGING_COPIES.value])
    return out


SUITES = {"batch": suite_batch, "banded2d": suite_banded2d,
          "banded3d": suite_banded3d, "long1d": suite_long1d,
          "segscan": suite_segscan, "card": suite_card}


def main(argv):
    suite, world, rank, store, src, out = argv
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=int(rank), world_size=int(world))
    try:
        from proxtv_tpu_torch.parallel import make_mesh

        mesh = make_mesh() if suite == "card" else make_mesh(device="cpu")
        with np.load(src) as f:
            inp = {k: f[k] for k in f.files}
        res = SUITES[suite](mesh, inp)
        np.savez(f"{out}.{rank}.npz", **res)
    finally:
        dist.destroy_process_group()
    if "jax" in sys.modules:
        raise SystemExit("the port's parallel path imported JAX")


if __name__ == "__main__":
    main(sys.argv[1:])
