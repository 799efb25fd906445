"""Demo: spatially varying weighted 2D TV denoising, through the port.

Mirrors the reference demo (prox_tv/demos/demo_filter_image_weighted.py)
and the JAX package's: weight fields that smooth one half of the image
strongly and the other half weakly.

    python -m proxtv_tpu_torch.demos.demo_filter_image_weighted [--device cpu]
"""
import argparse

import numpy as np

import proxtv_tpu_torch as ptv


def main(device=None, n=128):
    """Returns {"noisy": mse, "left": mse, "right": mse} of the image, the
    weighted prox's strongly smoothed left half and weakly smoothed right
    half, against the truth."""
    rng = np.random.RandomState(5)
    truth = np.kron(rng.rand(4, 4), np.ones((n // 4, n // 4)))
    noisy = truth + 0.2 * rng.randn(n, n)

    # Strong smoothing on the left half, weak on the right.
    W_col = np.full((n - 1, n), 0.05)
    W_row = np.full((n, n - 1), 0.05)
    W_col[:, : n // 2] = 0.5
    W_row[:, : n // 2 - 1] = 0.5

    den = ptv.tv1w_2d(noisy, W_col, W_row, device=device)
    res = {"noisy": float(np.mean((noisy - truth) ** 2)),
           "left": float(np.mean((den[:, : n // 2] - truth[:, : n // 2])
                                 ** 2)),
           "right": float(np.mean((den[:, n // 2:] - truth[:, n // 2:])
                                  ** 2))}
    print("weighted 2D: MSE left(smoothed) %.4f, right(preserved) %.4f"
          % (res["left"], res["right"]))
    print("noisy      : MSE %.4f" % res["noisy"])
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    main(ap.parse_args().device)
