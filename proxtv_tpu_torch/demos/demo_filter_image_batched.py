"""Demo: batched image denoising through the port — the counterpart of the
reference's thread-scaling demo (prox_tv/demos/demo_filter_image_threads.py)
and of the JAX package's batched demo.

The reference sweeps 1-8 OpenMP threads on one image; on the card the
scaling axis is the *batch*: many images denoised by one call of
``models.tv2d.tv1_2d_batched`` (kolmogorov: alternating fiber passes, kernel
B1 on the card).  Prints throughput vs batch size.

    python -m proxtv_tpu_torch.demos.demo_filter_image_batched [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from proxtv_tpu_torch.api import _device
from proxtv_tpu_torch.models import tv2d


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main(device=None, n=256, batches=(1, 4, 16)):
    """Returns {B: (ms per call, Mpx/s)}."""
    dev, dt = _device(device)
    rng = np.random.RandomState(4)
    res = {}
    for B in batches:
        Y = torch.from_numpy(rng.randn(B, n, n).astype(np.float32)).to(
            device=dev, dtype=dt)
        tv2d.tv1_2d_batched(Y, 0.4, method="kolmogorov")  # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        X, info = tv2d.tv1_2d_batched(Y, 0.4, method="kolmogorov")
        _sync(dev)
        dt_s = time.perf_counter() - t0
        res[B] = (dt_s * 1e3, B * n * n / 1e6 / dt_s)
        print("B=%-3d %6.1f ms  %8.2f Mpx/s" % (B, *res[B]))
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    main(ap.parse_args().device)
