"""Runs over N ranks against one rank, through ``run()`` (what
``python -m concept_tpu_torch -p param/example_basic.py -n N`` calls),
one case a layout (``--layouts``):

  8      the rung run on the 8-mesh-cell layout: example_basic as shipped
         (64³, grid 128: 16 planes of cells) to a = 0.1, and 256³ on grid
         512 (64 planes) to a = 0.023;
  4      the 4-mesh-cell layout: 62³ on grid 124 (31 planes) to a = 0.1;
  tight  the tight layout: 63³ on grid 126 (20 planes) to a = 0.1;
  pm     global-step PM (``select_forces = {'all': {'gravity': 'pm'}}``),
         64³ on grid 128 to a = 0.1;
  p3m    global-step P³M (``N_rungs = 1``), 64³ on grid 128 to a = 0.1;

each with -n 1 and every N given (an N the case cannot take is reported
with its error).  Prints one JSON line: per run the steps, the
evolution's seconds (the first collectives' set-up included), the ms of
each rung base step or global step on rank 0's clock between device
synchronisations (the first, and the median of the rest), the highest
rung, and against the -n 1 run the spectrum's largest relative
difference and the mean and largest |Δx|/box of the final positions (by
id).

    python3 scripts/ranks_rungs.py --ranks 2 4 [--layouts 8 4 tight pm p3m]
        [--device cpu] [--small]

``--ranks 2 4`` needs four cards.  ``--small`` runs 8³ on grid 32 and
16³ on grid 64 for the 8-mesh-cell case, and 8³ on grid 28, 32 and 32
for the others (the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PARAM = os.path.join(ROOT, "param", "example_basic.py")


# layout: [(n, grid, a_end, more overrides)], and the same at --small
CASES = {
    "8": ([(64, 128, 0.1, ()), (256, 512, 0.023, ())], [(8, 32, 0.05, ()), (16, 64, 0.03, ())]),
    "4": ([(62, 124, 0.1, ())], [(8, 28, 0.05, ("N_rungs=4",))]),
    "tight": ([(63, 126, 0.1, ())], [(8, 30, 0.05, ("N_rungs=4",))]),
    "pm": ([(64, 128, 0.1, ("select_forces={'all': {'gravity': 'pm'}}",))],
           [(8, 32, 0.05, ("select_forces={'all': {'gravity': 'pm'}}",))]),
    "p3m": ([(64, 128, 0.1, ("N_rungs=1",))], [(8, 32, 0.05, ("N_rungs=1",))]),
}


def _run(n: int, mesh: int, a_end: float, more, ranks: int, device: str, outdir: str):
    import numpy as np

    import torch

    from concept_tpu_torch import p3mrungs, sim as global_sim
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    cfg = load_params(PARAM, overrides=[
        f"initial_conditions={{'species':'matter','N':{n}**3}}", f"potential_options={mesh}",
        f"output_times={{'powerspec': [{a_end}]}}", f"output_dirs='{outdir}'", *more])
    # this process is rank 0: its rung base steps or global steps, each
    # between synchronisations
    hooks = ((p3mrungs.P3MRungSimulation, "base_step"), (global_sim.Simulation, "step"))
    saved, ms = [getattr(c, f) for c, f in hooks], []

    def timed(step):
        def wrapped(self, *args, **kw):
            sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
            sync()
            t0 = time.perf_counter()
            out = step(self, *args, **kw)
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
            return out
        return wrapped

    for (c, f), step in zip(hooks, saved):
        setattr(c, f, timed(step))
    try:
        sim, state, _ = run(cfg, device=device, n_devices=ranks)
    finally:
        for (c, f), step in zip(hooks, saved):
            setattr(c, f, step)
    inner = getattr(sim, "inner", None)
    stats = inner.stats if inner is not None else {}
    order = (state.ids.argsort() if state.ids is not None
             else torch.arange(state.pos.shape[0], device=state.pos.device))
    pk = np.loadtxt(os.path.join(outdir, f"powerspec_a={a_end:.4g}.txt"))
    return dict(steps=len(ms), base_steps=stats.get("base_steps"),
                max_rung=stats.get("max_rung"), evolve_s=sim.timings["evolve_s"],
                first_step_ms=ms[0], step_ms=float(np.median(ms[1:])),
                layout_cells=None if inner is None else inner.ucb,
                planes_of_cells=None if inner is None else inner.nc,
                deficit=stats.get("pm_mass_deficit_max"),
                pos=state.pos[order].double().cpu().numpy(), power=pk[:, 2]), cfg.boxsize


def main(argv=None) -> int:
    import numpy as np

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, nargs="+", default=[2, 4])
    p.add_argument("--layouts", nargs="+", default=["8"], choices=sorted(CASES))
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    p.add_argument("--out", help="also write the JSON line to this file")
    a = p.parse_args(argv)
    if a.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()
        print("\n".join(smi))
    results = {}
    for layout in a.layouts:
        for n, mesh, a_end, more in CASES[layout][int(a.small)]:
            tag = f"{layout}: {n}^3/grid{mesh}"
            runs, refused = {}, {}
            for ranks in [1, *a.ranks]:
                outdir = tempfile.mkdtemp(prefix="ranks_rungs_")
                try:
                    runs[ranks], box = _run(n, mesh, a_end, more, ranks, a.device, outdir)
                except ValueError as e:
                    refused[ranks] = str(e)
                    print(f"{tag} -n {ranks}: refused: {e}", flush=True)
                finally:
                    shutil.rmtree(outdir, ignore_errors=True)
            one = runs[1]
            for ranks, r in runs.items():
                dx = r["pos"] - one["pos"]
                dx -= box * np.round(dx / box)
                d = np.sqrt((dx**2).sum(1)) / box
                r.update(mean_dx=float(d.mean()), max_dx=float(d.max()),
                         spectrum_max_rel=float(np.abs(r["power"] / one["power"] - 1).max()))
                print(f"{tag} -n {ranks}: {r['steps']} steps, {r['evolve_s']:.2f} s of "
                      f"evolution; a step {r['step_ms']:.1f} ms (median; the first "
                      f"{r['first_step_ms']:.1f}), highest rung {r['max_rung']}, layout "
                      f"cells {r['layout_cells']} ({r['planes_of_cells']} planes); against "
                      f"-n 1: spectrum {r['spectrum_max_rel']:.3g}, mean |Δx|/box "
                      f"{r['mean_dx']:.3g}, max {r['max_dx']:.3g}", flush=True)
            results[tag] = {str(k): {f: v for f, v in r.items() if f not in ("pos", "power")}
                            for k, r in runs.items()}
            results[tag].update({str(k): {"refused": e} for k, e in refused.items()})
    line = json.dumps(results)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
