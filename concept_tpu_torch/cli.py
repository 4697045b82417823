"""Command-line interface of the port (the run surface of
concept_tpu/cli.py; reference launcher concept:854-1315).

Usage:
  python -m concept_tpu_torch -p params.py [-c "extra=1"] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given.  The utilities
(-u), multi-device (-n), custom mains (-m), job submission and the
interactive shell of the JAX CLI are not ported yet.
"""

from __future__ import annotations

import argparse
import sys


def make_parser():
    p = argparse.ArgumentParser(
        prog="concept-tpu-torch",
        description="Cosmological N-body simulation on PyTorch/CUDA "
                    "(port of concept_tpu)",
    )
    p.add_argument("-p", "--param", help="parameter file (executable Python)")
    p.add_argument("-c", "--command-line-params", action="append", default=[],
                   help="extra parameter statements, run after the parameter file")
    p.add_argument("--seed", type=int, default=None, help="override primordial seed")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to run (default: the CUDA card)")
    p.add_argument("--float64", action="store_true",
                   help="float64 end to end (CPU only; same as enable_float64 = True)")
    p.add_argument("--version", action="store_true")
    return p


def main(argv=None):
    args = make_parser().parse_args(sys.argv[1:] if argv is None else argv)
    if args.version:
        from concept_tpu_torch import __version__

        print(f"concept_tpu_torch {__version__}")
        return 0
    if not args.param and not args.command_line_params:
        print("nothing to do (pass -p/--param or -c)", file=sys.stderr)
        return 1
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    cfg = load_params(args.param, overrides=args.command_line_params)
    if args.float64:
        cfg.enable_float64 = True
    print(f"concept_tpu_torch run on {args.device}")
    run(cfg, seed=args.seed, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
