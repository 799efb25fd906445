"""Command-line skin for proxtv_tpu_torch (the port's counterpart of
``python -m proxtv_tpu``; the reference's second skin is its MATLAB MEX
layer, matlab/*.cpp).

Usage:
    python -m proxtv_tpu_torch demo <signal|image|color|batched|weighted>
    python -m proxtv_tpu_torch bench [chip_smoke.py arguments]
    python -m proxtv_tpu_torch denoise1d <in.npy> <out.npy> --lam 1.0 [--method m]
    python -m proxtv_tpu_torch denoise2d <in.npy> <out.npy> --lam 0.3 [--method m]
    python -m proxtv_tpu_torch tv <in.npy> <out.npy> --lam <scalar | w.npy | wcol.npy wrow.npy> [--p 1]

Every subcommand takes ``--device`` (default: the card; ``cpu`` solves in
float64 on the CPU).  ``bench`` runs the port's own harness,
``chip_smoke.py`` at the root of the repo, which needs a card.
"""
import argparse
import os
import subprocess
import sys

import numpy as np

_DEMOS = {
    "signal": "demo_filter_signal",
    "image": "demo_filter_image",
    "color": "demo_filter_image_color",
    "batched": "demo_filter_image_batched",
    "weighted": "demo_filter_image_weighted",
}


def main(argv=None):
    p = argparse.ArgumentParser(prog="proxtv_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demo", help="run a demo scenario")
    d.add_argument("which", choices=sorted(_DEMOS))
    d.add_argument("--device", default=None)

    sub.add_parser("bench", help="run the port's harness (chip_smoke.py)",
                   add_help=False)

    for name in ("denoise1d", "denoise2d"):
        s = sub.add_parser(name)
        s.add_argument("infile")
        s.add_argument("outfile")
        s.add_argument("--lam", type=float, required=True)
        s.add_argument("--method", default=None)
        s.add_argument("--device", default=None)

    t = sub.add_parser("tv", help="polymorphic TV front end (reference "
                                  "matlab/TV.m): --lam may be a scalar, a "
                                  "weight-vector .npy, or two weight-matrix "
                                  ".npy files (weighted 2D)")
    t.add_argument("infile")
    t.add_argument("outfile")
    t.add_argument("--lam", nargs="+", required=True,
                   help="scalar | weights.npy | wcol.npy wrow.npy")
    t.add_argument("--p", type=float, default=1.0)
    t.add_argument("--max-iters", type=int, default=0)
    t.add_argument("--device", default=None)

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["bench"]:
        script = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py")
        return subprocess.run([sys.executable, script, *argv[1:]]).returncode
    args = p.parse_args(argv)

    if args.cmd == "demo":
        import importlib

        importlib.import_module(
            f"proxtv_tpu_torch.demos.{_DEMOS[args.which]}").main(
                device=args.device)
        return 0

    import proxtv_tpu_torch as ptv

    x = np.load(args.infile)
    if args.cmd == "tv":
        if len(args.lam) == 2:  # two weight matrices -> weighted 2D
            lam = [np.load(args.lam[0]), np.load(args.lam[1])]
        elif args.lam[0].endswith(".npy"):  # weight vector -> weighted 1D
            lam = np.load(args.lam[0])
        else:
            lam = float(args.lam[0])
        out = ptv.tv(x, lam, p=args.p, max_iters=args.max_iters,
                     device=args.device)
    else:
        kw = {"method": args.method} if args.method else {}
        fn = ptv.tv1_1d if args.cmd == "denoise1d" else ptv.tv1_2d
        out = fn(x, args.lam, device=args.device, **kw)
    np.save(args.outfile, np.asarray(out))
    print(f"wrote {args.outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
