"""Command-line interface of the port (port of concept_tpu/cli.py;
reference launcher concept:854-1315 for the options, 2737-2747 for the
run and its log).

Usage:
  python -m concept_tpu_torch -p params.py [-c "extra=1"] [--device cpu]
  python -m concept_tpu_torch -u powerspec|bispec|info|convert|... <args>

Runs on the CUDA card unless ``--device cpu`` is given.  Every long
option's default can also come from the environment as CONCEPT_<name>
(dashes as underscores).  A run's output is tee'd to job/<id>/log.
JAX's ``--pure-python`` (no jit) has no counterpart here.
"""

from __future__ import annotations

import argparse
import os
import sys
from contextlib import contextmanager


def _env_default(long_name: str, default, action=None):
    """The CONCEPT_<name> mirror of a long option's default (reference
    concept:1017-1035), e.g. CONCEPT_param, CONCEPT_device."""
    val = os.environ.get("CONCEPT_" + long_name.lstrip("-").replace("-", "_"))
    if val is None:
        return default
    if action == "store_true":
        return val.strip().lower() in ("1", "true", "t", "yes", "y", "on")
    if action == "append":
        return [val]
    return val


def make_parser():
    p = argparse.ArgumentParser(
        prog="concept-tpu-torch",
        description="Cosmological N-body simulation on PyTorch/CUDA "
                    "(port of concept_tpu)",
    )
    add = p.add_argument

    def add_argument(*names, **kwargs):
        long = next((n for n in names if n.startswith("--")), None)
        if long is not None and kwargs.get("nargs") is not argparse.REMAINDER:
            kwargs["default"] = _env_default(long, kwargs.get("default"),
                                             kwargs.get("action"))
        return add(*names, **kwargs)

    p.add_argument = add_argument
    p.add_argument("-p", "--param", help="parameter file (executable Python)")
    p.add_argument("-c", "--command-line-params", action="append", default=[],
                   help="extra parameter statements, run after the parameter file")
    p.add_argument("-u", "--utility", nargs=argparse.REMAINDER,
                   help="run a utility: powerspec|bispec|info|convert|gadget|watch|"
                        "play|update <args>")
    p.add_argument("-n", "--nprocs", default="1",
                   help="ranks: N processes, one a card (with --device cpu, on the "
                        "CPU), each holding 1/N of the particles and grids; AxB = A·B "
                        "ranks whose global-step PM and P³M kicks run on the 2D "
                        "pencils of an A x B mesh (e.g. 2x2); 0 = every visible card")
    p.add_argument("-m", "--main", dest="main_script", default=None,
                   help="run a Python script instead of the time loop, with the "
                        "loaded RunConfig as `cfg` and the unit system as `units`")
    p.add_argument("-t", "--test", nargs="?", const="all", default=None,
                   help="run the port's tests (tests/test_torch_*.py), or those of "
                        "one file or -k pattern")
    p.add_argument("--seed", type=int, default=None, help="override primordial seed")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to run (default: the CUDA card)")
    p.add_argument("--float64", action="store_true",
                   help="float64 end to end (same as enable_float64 = True)")
    p.add_argument("--version", action="store_true")
    p.add_argument("--submit", action="store_true",
                   help="write a Slurm/TORQUE-PBS batch script under job/<id>/jobscript "
                        "and submit it (reference concept:2315-2660)")
    p.add_argument("-q", "--queue", default=None,
                   help="scheduler queue/partition for --submit")
    p.add_argument("-w", "--walltime", default=None,
                   help="walltime for --submit (e.g. 12:00:00)")
    p.add_argument("--memory", default=None, help="memory request for --submit (e.g. 64G)")
    p.add_argument("-J", "--job-name", default=None,
                   help="job name for --submit (default: param file stem)")
    p.add_argument("--job-directive", action="append", default=[],
                   help="extra raw scheduler directive line(s) for --submit")
    p.add_argument("--local", action="store_true",
                   help="run in this process even when a scheduler is present")
    p.add_argument("-i", "--interactive", action="store_true",
                   help="after the run (or with no run), an interactive Python "
                        "session with cfg/units (and sim/state/a after a run)")
    return p


def _run_tests(target: str) -> int:
    import glob
    import subprocess

    tests = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "tests")
    cmd = [sys.executable, "-m", "pytest", "-q"]
    if target == "all":
        cmd += sorted(glob.glob(os.path.join(tests, "test_torch_*.py")))
    elif os.path.exists(target):
        cmd.append(target)
    else:
        cmd += [*sorted(glob.glob(os.path.join(tests, "test_torch_*.py"))), "-k", target]
    return subprocess.call(cmd)


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    args = make_parser().parse_args(argv)
    if args.submit and not args.local:
        from concept_tpu_torch.submit import submit

        return submit(args, list(argv))
    if args.version:
        from concept_tpu_torch import __version__

        print(f"concept_tpu_torch {__version__}")
        return 0
    if args.test is not None:
        return _run_tests(args.test)
    if args.utility:
        from concept_tpu_torch.utilities import delegate

        return delegate(args.utility, args)
    if (not args.param and not args.command_line_params
            and not args.main_script and not args.interactive):
        print("nothing to do (pass -p/--param, -u/--utility, -m SCRIPT or -i)",
              file=sys.stderr)
        return 1
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run
    from concept_tpu_torch.units import UnitSystem

    cfg = load_params(args.param, overrides=args.command_line_params)
    if args.float64:
        cfg.enable_float64 = True
    units = cfg.units or UnitSystem(cfg.unit_length, cfg.unit_time, cfg.unit_mass)
    if args.main_script:
        # the reference's `-m MAIN` (its tests' analyze.py pattern)
        ns = {"__name__": "__main__", "__file__": os.path.abspath(args.main_script),
              "cfg": cfg, "units": units}
        with open(args.main_script) as f:
            code = compile(f.read(), args.main_script, "exec")
        exec(code, ns)  # noqa: S102 — the user's script, by request
        return 0
    with job_logging() as jobid:
        print(f"concept_tpu_torch run on {args.device}, job {jobid}")
        result = None
        # `-i` with only -c statements: configure and inspect, no run
        if args.param or (args.command_line_params and not args.interactive):
            result = run(cfg, seed=args.seed, device=args.device, n_devices=args.nprocs)
        if args.interactive:
            import code

            ns = {"cfg": cfg, "units": units}
            if result is not None:
                ns["sim"], ns["state"], ns["a"] = result
            code.interact(banner="concept_tpu_torch interactive session "
                                 f"(in scope: {', '.join(sorted(ns))})", local=ns)
    return 0


class _Tee:
    def __init__(self, *streams):
        self.streams = streams

    def write(self, data):
        for s in self.streams:
            s.write(data)

    def flush(self):
        for s in self.streams:
            s.flush()

    def isatty(self):
        return self.streams[0].isatty()

    def close(self):
        # only the log file: the real stdout/stderr stay open
        for s in self.streams[1:]:
            s.close()


@contextmanager
def job_logging(job_dir: str = "job"):
    """Tee stdout/stderr to job/<jobid>/{log,log_err}, jobid one past the
    largest there (reference concept:2703-2747)."""
    os.makedirs(job_dir, exist_ok=True)
    jobid = max((int(d) for d in os.listdir(job_dir) if d.isdigit()), default=-1) + 1
    d = os.path.join(job_dir, str(jobid))
    os.makedirs(d, exist_ok=True)
    so, se = sys.stdout, sys.stderr
    with open(os.path.join(d, "log"), "w") as out, open(os.path.join(d, "log_err"), "w") as err:
        sys.stdout = _Tee(so, out)
        sys.stderr = _Tee(se, err)
        try:
            yield jobid
        finally:
            sys.stdout, sys.stderr = so, se


if __name__ == "__main__":
    sys.exit(main())
