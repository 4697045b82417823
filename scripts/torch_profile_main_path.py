"""Where the time of the port's main path goes, on one NVIDIA card.

    python3 scripts/torch_profile_main_path.py [--N 64**3] [--mesh 128]
        [--a-end 1.0] [--gravity p3m|pm] [--out profile.json]

Builds the kernels, warms up with a short run, then runs
param/example_basic.py (with the given particle count, grid, final a and
gravity: P³M with rungs as shipped, or PM only, whose global steps run
the block kernels of PERF.md rows 10-11) through the port's ``run`` twice: once plain, for the host wall time,
and once under ``torch.profiler`` (CPU and CUDA activities), for the
device time of every kernel, copy and fill.  Prints the device time by
group (the pair sweep, the CIC deposit and gather on cells and on PM blocks,
cuFFT, sorts, and all other PyTorch kernels), the top kernels, and the device busy share: the
profiled run's device time over the plain run's wall time, both of the
whole run (realization, evolution, output).  The profiler slows the
host, so its own wall time would understate the share; the two runs are
not identical (the deposit's atomics sum in no fixed order, and the
trajectories drift apart), so the share is an estimate.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PARAM = os.path.join(ROOT, "param", "example_basic.py")

GROUPS = (("pair_sweep", ("pair_sweep_kernel",)),
          ("deposit_cells", ("deposit_tile_kernel",)),
          ("gather_cells", ("gather_tile_kernel", "gather_columns_kernel")),
          ("deposit_pm", ("pm_deposit_kernel",)),
          ("gather_pm", ("pm_gather_kernel",)),
          ("cufft", ("fft", "FFT")),
          ("sort", ("Sort", "sort")))


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def _wall(sim) -> float:
    return sum(sim.timings.values())


def _run(overrides, outdir):
    import torch

    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    cfg = load_params(PARAM, overrides=overrides + [f"output_dirs='{outdir}'"])
    sim, _, a = run(cfg, device="cuda")
    torch.cuda.synchronize()
    return sim, a


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--N", default="64**3")
    p.add_argument("--mesh", type=int, default=128)
    p.add_argument("--a-end", type=float, default=1.0)
    p.add_argument("--gravity", choices=("p3m", "pm"), default="p3m")
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from concept_tpu_torch import _build

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    overrides = [f"initial_conditions={{'species':'matter','N':{args.N}}}",
                 f"potential_options={args.mesh}",
                 f"output_times={{'powerspec': [{args.a_end}]}}"]
    if args.gravity == "pm":
        overrides.append("select_forces={'all': {'gravity': 'pm'}}")
    _build.build_all()
    with tempfile.TemporaryDirectory() as outdir:
        _run(overrides[:2] + overrides[3:] + ["output_times={'powerspec': [0.021]}"],
             outdir)
        sim, a = _run(overrides, outdir)
        wall = _wall(sim)
        steps = sim.hysteresis["step_count"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sim_p, _ = _run(overrides, outdir)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    total_us = sum(e.device_time_total for e in events)
    groups = {}
    for e in events:
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + e.device_time_total
    top = sorted(events, key=lambda e: -e.device_time_total)[:args.top]
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    # rung runs count substeps; global steps are their own substeps
    stats, stats_p = (getattr(x, "inner", x).stats for x in (sim, sim_p))
    res = {
        "card": smi, "N": args.N, "mesh": args.mesh, "gravity": args.gravity, "a_end": a,
        "base_steps": steps, "substeps": stats.get("substeps", steps),
        "max_rung": stats.get("max_rung", 0), "run_wall_s": wall, "timings": sim.timings,
        "profiled_run_wall_s": _wall(sim_p),
        "profiled_substeps": stats_p.get("substeps", stats_p.get("steps")),
        "device_s": total_us / 1e6,
        "device_s_by_group": {g: v / 1e6 for g, v in sorted(groups.items())},
        "top_kernels": [{"name": e.key[:90], "calls": e.count,
                         "device_s": e.device_time_total / 1e6} for e in top],
    }
    res["device_busy_share"] = res["device_s"] / wall
    print(f"{smi}: N = {args.N}, mesh {args.mesh}, gravity {args.gravity}, a → {a:.4g}: "
          f"{steps} base steps, "
          f"{res['substeps']} substeps, max rung {res['max_rung']}")
    print(f"run wall {wall:.3f} s unprofiled ({sim.timings}); profiled run: "
          f"{res['profiled_substeps']} substeps, device time {total_us / 1e6:.3f} s; "
          f"busy share ≈ {res['device_busy_share']:.3f}")
    for g, v in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:14s} {v / 1e6:9.4f} s  {100 * v / total_us:5.1f} %")
    for e in top:
        print(f"  {e.device_time_total / 1e3:10.2f} ms  {e.count:7d}×  {e.key[:90]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
