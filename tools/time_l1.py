#!/usr/bin/env python3
"""Time kernel L1 (the 2D backward's flat-component labelling,
``csrc/labels.cu``) per call on one CUDA card.

    python3 tools/time_l1.py [--dtype float32|float64] [--repo DIR]

Cases, all one image: the dr solution (``diffprox.tv2d_prox``, lam 0.3) of
a blocky 1024^2 image (64 x 64 blocks of randn plus 0.3 randn, seed 0),
the flat-edge fields of ``tests/torch_label_fields.py`` at 1024 x 1000
(densities 0.52 and 0.78), and the flat and serpentine 1024^2 images of
``chip_smoke.py``.  Each case is first held against its plain version on
the card (the min-label propagation; its trips are printed) or, for the
flat and serpentine images, against their known labels, bit for bit; then
the C entry point (``labels.bind``, arguments made once) is timed by CUDA
events, 20 calls after one untimed.  ``--repo`` times the package of
another checkout with the same cases, so that two versions are compared in
one call on one card.  ``--dtype float64`` labels the same images in
double (the dr solution a float64 solve), on L1's float64 instantiation.
Prints one line a case and one JSON line with the card's name and power
limit.  Imports nothing of JAX.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPS = 20
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = 0.75e-4  # tests/torch_label_fields.py: flat where |dk| <= 1


def time_ms(fn):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main(repo, dtype="float32"):
    sys.path.insert(0, HERE)
    from chip_smoke import serpentine

    sys.path.insert(0, repo)
    import torch

    from proxtv_tpu_torch.ops import diffprox
    from proxtv_tpu_torch.ops.kernels import labels as L1

    if not torch.cuda.is_available():
        sys.exit("time_l1.py needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    rng = np.random.RandomState(0)
    truth = np.kron(rng.randn(16, 16), np.ones((64, 64)))
    Y = torch.from_numpy((truth + 0.3 * rng.randn(1024, 1024))[None]
                         .astype(dtype)).cuda()
    X_dr = diffprox.tv2d_prox(Y, 0.3, "dr").contiguous()
    cases = [("dr solution 1024^2", X_dr, None),
             ("p0.52 1024x1000", STEP * rng.randint(0, 5, (1024, 1000)), None),
             ("p0.78 1024x1000", STEP * rng.randint(0, 3, (1024, 1000)), None),
             ("flat 1024^2", np.zeros((1024, 1024)),
              np.zeros((1024, 1024), np.int32)),
             ("serpentine 1024^2", *serpentine(1024, 1024))]
    out = {"card": card, "repo": os.path.abspath(repo), "dtype": dtype,
           "cases": []}
    for name, X, known in cases:
        if not torch.is_tensor(X):
            X = torch.from_numpy(X[None].astype(dtype)).cuda()
        tol = diffprox._seg_tol(X)
        labels, launch = L1.bind(X, tol)
        launch()
        trips = None
        if known is None:
            L1.LABEL_TRIPS.reset()
            ref = L1.component_labels_plain(X, tol)
            trips = L1.LABEL_TRIPS.value
        else:
            ref = torch.from_numpy(known[None]).cuda()
        torch.cuda.synchronize()
        if not torch.equal(labels, ref):
            sys.exit(f"{name}: {int((labels != ref).sum())} labels differ")
        rec = {"case": name, "ms": time_ms(launch), "plain_trips": trips,
               "components": int(torch.unique(labels).numel())}
        out["cases"].append(rec)
        print(f"[{name}] L1 C entry {rec['ms']:.4f} ms, {rec['components']} "
              f"components, plain trips {trips} ({dtype}; {card}; "
              f"{out['repo']})",
              flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE,
                    help="checkout whose package is timed")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    a = ap.parse_args()
    main(a.repo, a.dtype)
