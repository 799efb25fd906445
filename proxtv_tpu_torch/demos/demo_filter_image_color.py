"""Demo: color (3D) image denoising via the generalized TV prox, through the
port.

Mirrors the reference demo (prox_tv/demos/demo_filter_image_color.py:23-33,
which filters colors.png) and the JAX package's: loads the RGB test card
of the JAX package (``proxtv_tpu/demos/assets/colors.png``, read-only data,
by path), penalizes the two spatial dimensions with TV-L1, and optionally
couples the color channels with an L2 penalty on the channel dimension.
Pass an output directory to save PNGs; without PIL or the asset the JAX
demo's synthetic image is used.

    python -m proxtv_tpu_torch.demos.demo_filter_image_color [--device cpu]
"""
import argparse
import os

import numpy as np

import proxtv_tpu_torch as ptv

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "proxtv_tpu", "demos", "assets",
    "colors.png")


def make_image(n=96):
    """The JAX demo's synthetic RGB image (n x n x 3)."""
    truth = np.zeros((n, n, 3))
    truth[: n // 2, :, 0] = 1.0
    truth[:, n // 3:, 1] = 0.8
    truth[n // 4:, : n // 2, 2] = 0.6
    return truth


def load_image():
    try:
        from PIL import Image
    except ImportError:
        return make_image(), "synthetic"
    if not os.path.exists(ASSET):
        return make_image(), "synthetic"
    img = np.asarray(Image.open(ASSET).convert("RGB"), dtype=np.float64)
    return img / 255.0, "colors.png"


def _save(arr, path):
    from PIL import Image

    Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8), "RGB").save(
        path)


def main(device=None, out_dir=None):
    """Returns {"spatial": (mse_noisy, mse_denoised), "coupled": (...)}."""
    rng = np.random.RandomState(3)
    truth, src = load_image()
    noisy = truth + 0.15 * rng.randn(*truth.shape)
    print(f"image: {src} {truth.shape}")
    mse0 = float(np.mean((noisy - truth) ** 2))
    res = {}

    # Spatial TV only (each channel independent).
    den = ptv.tvgen(noisy, [0.1, 0.1], [1, 2], [1, 1], device=device)
    res["spatial"] = (mse0, float(np.mean((den - truth) ** 2)))
    print("spatial TV      : MSE %.4f -> %.4f" % res["spatial"])

    # Spatial TV + L2 coupling across color channels (the reference's
    # demo_filter_image_color.py:29-33 variant).
    den2 = ptv.tvgen(noisy, [0.1, 0.1, 0.02], [1, 2, 3], [1, 1, 2],
                     device=device)
    res["coupled"] = (mse0, float(np.mean((den2 - truth) ** 2)))
    print("spatial+color TV: MSE %.4f -> %.4f" % res["coupled"])
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        _save(noisy, os.path.join(out_dir, "color_noisy.png"))
        _save(den, os.path.join(out_dir, "color_denoised_spatial.png"))
        _save(den2, os.path.join(out_dir, "color_denoised_coupled.png"))
        print(f"saved PNGs to {out_dir}")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    main(args.device, args.out_dir)
