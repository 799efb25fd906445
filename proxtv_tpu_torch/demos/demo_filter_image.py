"""Demo: 2D grayscale image denoising with anisotropic TV-L1, through the port.

Mirrors the reference demo (prox_tv/demos/demo_filter_image.py:12-20, which
filters a noisy QR code) and the JAX package's demo: reads the QR asset of
the JAX package (``proxtv_tpu/demos/assets/qr.png``, as read-only data, by
path), adds Gaussian noise, and denoises with several 2D TV-L1 engines.
Without PIL or the asset a synthetic piecewise-constant image is used.

    python -m proxtv_tpu_torch.demos.demo_filter_image [--device cpu]
"""
import argparse
import os

import numpy as np

import proxtv_tpu_torch as ptv

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "proxtv_tpu", "demos", "assets", "qr.png")


def load_image():
    try:
        from PIL import Image
    except ImportError:
        return make_image(), "synthetic"
    if not os.path.exists(ASSET):
        return make_image(), "synthetic"
    img = np.asarray(Image.open(ASSET).convert("L"), dtype=np.float64)
    return img / 255.0, "qr.png"


def make_image(n=256):
    img = np.zeros((n, n))
    img[: n // 2, :] = 1.0
    img[:, 2 * n // 3:] += 2.0
    img[n // 4: n // 2, n // 8: n // 4] = 3.0
    return img


def main(device=None, methods=("dr", "kolmogorov", "chambolle-pock-acc")):
    """Denoise with each method; returns {method: (mse_noisy, mse_denoised)}."""
    rng = np.random.RandomState(2)
    truth, src = load_image()
    noisy = truth + 0.3 * rng.randn(*truth.shape) * truth.std()
    print(f"image: {src} {truth.shape}")
    res = {}
    for method in methods:
        den = ptv.tv1_2d(noisy, 0.25 * truth.std(), method=method,
                         device=device)
        res[method] = (float(np.mean((noisy - truth) ** 2)),
                       float(np.mean((den - truth) ** 2)))
        print("%-20s MSE %.4f -> %.4f" % (method, *res[method]))
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    main(ap.parse_args().device)
