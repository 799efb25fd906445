"""Demo: 1D signal filtering with TV-L1, weighted TV-L1 and TV-L2 proxes,
through the port.

Mirrors the reference demo (prox_tv/demos/demo_filter_signal.py) and the
JAX package's: a blocky signal and a sinusoid corrupted by noise, denoised
with the three 1D prox families.  Prints the MSE before and after.

    python -m proxtv_tpu_torch.demos.demo_filter_signal [--device cpu]
"""
import argparse

import numpy as np

import proxtv_tpu_torch as ptv


def main(device=None):
    """Returns {name: (mse_noisy, mse_denoised)} and, under "jump", the
    step the weighted prox keeps at the unpenalized edge."""
    rng = np.random.RandomState(1)
    res = {}

    # Blocky (piecewise-constant) signal -> TV-L1.
    truth = np.repeat([1.0, 3.0, -2.0, 0.5, 2.0, -1.0], 60)
    noisy = truth + 0.5 * rng.randn(truth.size)
    mse0 = float(np.mean((noisy - truth) ** 2))
    den = ptv.tv1_1d(noisy, 2.0, device=device)
    res["tv1"] = (mse0, float(np.mean((den - truth) ** 2)))
    print("TV-L1  blocky: MSE %.4f -> %.4f" % res["tv1"])

    # Weighted TV-L1: protect a known jump by zeroing its edge weight.
    w = np.full(truth.size - 1, 2.0)
    w[59] = 0.0  # do not penalize the first block boundary
    den_w = ptv.tv1w_1d(noisy, w, device=device)
    res["tv1w"] = (mse0, float(np.mean((den_w - truth) ** 2)))
    res["jump"] = float(den_w[60] - den_w[59])
    print("TV-L1w blocky: MSE %.4f -> %.4f (edge 59 jump preserved: %.2f)"
          % (*res["tv1w"], res["jump"]))

    # Smooth signal -> TV-L2 keeps it smooth instead of staircasing.
    t = np.linspace(0, 4 * np.pi, 400)
    smooth = np.sin(t)
    noisy_s = smooth + 0.3 * rng.randn(t.size)
    mse_s = float(np.mean((noisy_s - smooth) ** 2))
    den_l2 = ptv.tv2_1d(noisy_s, 3.0, device=device)
    res["tv2"] = (mse_s, float(np.mean((den_l2 - smooth) ** 2)))
    print("TV-L2  smooth: MSE %.4f -> %.4f" % res["tv2"])

    # General-p norm.
    den_p = ptv.tvp_1d(noisy_s, 1.0, 1.5, device=device)
    res["tvp"] = (mse_s, float(np.mean((den_p - smooth) ** 2)))
    print("TV-Lp  p=1.5 : MSE %.4f -> %.4f" % res["tvp"])
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    main(ap.parse_args().device)
