"""Global-step runs on the 2D pencils of ``-n AxB`` against one rank,
through ``run()`` (what ``python -m concept_tpu_torch -p
param/example_basic.py -n AxB`` calls): example_basic with ``N_rungs =
1``, PM (``select_forces = {'all': {'gravity': 'pm'}}``) and P³M, at 64³
on grid 128 to a = 0.1 and 256³ on grid 512 to a = 0.023, each at -n 1,
again at -n 1 (the card's own run-to-run spread: its deposits add with
atomics), and at every layout given (default: 4 2x2 1x4 4x1 2x1 1x2;
-n 4 is the 1D slab decomposition over the same four ranks).

Prints one JSON line: per run the steps, the evolution's seconds (the
first collectives' set-up included), the ms of each global step on rank
0's clock between device synchronisations (the first, and the median of
the rest), each rank's peak device memory over the run
(``sim.rank_peak_bytes``), and against the first -n 1 run the largest
relative difference of the power spectrum, with the k and the mode
count of its bin.

    python3 scripts/ranks_pencils.py [--layouts 4 2x2 1x4 4x1 2x1 1x2]
        [--cases pm p3m] [--device cpu] [--small] [--out FILE]

The default layouts need four cards.  ``--small`` runs 8³ on grid 16 and
16³ on grid 32 (the CPU).
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
METHODS = {"pm": ("N_rungs=1", "select_forces={'all': {'gravity': 'pm'}}"),
           "p3m": ("N_rungs=1",)}
# (n, grid, a_end), and at --small
SIZES = ([(64, 128, 0.1), (256, 512, 0.023)], [(8, 16, 0.05), (16, 32, 0.03)])


def _run(n: int, mesh: int, a_end: float, more, layout, device: str, outdir: str) -> dict:
    import numpy as np
    import torch

    from concept_tpu_torch import sim as global_sim
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    cfg = load_params(PARAM, overrides=[
        f"initial_conditions={{'species':'matter','N':{n}**3}}", f"potential_options={mesh}",
        f"output_times={{'powerspec': [{a_end}]}}", f"output_dirs='{outdir}'", *more])
    step, ms = global_sim.Simulation.step, []

    def timed(self, *args, **kw):
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        out = step(self, *args, **kw)
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
        return out

    global_sim.Simulation.step = timed
    try:
        sim, _, _ = run(cfg, device=device, n_devices=layout)
    finally:
        global_sim.Simulation.step = step
    pk = np.loadtxt(os.path.join(outdir, f"powerspec_a={a_end:.4g}.txt"))
    return dict(steps=len(ms), evolve_s=sim.timings["evolve_s"], first_step_ms=ms[0],
                step_ms=float(np.median(ms[1:])), rank_peak_bytes=sim.rank_peak_bytes,
                pm_mass_deficit_max=sim.stats["pm_mass_deficit_max"], spectrum=pk[:, :3])


def main(argv=None) -> int:
    import numpy as np

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--layouts", nargs="+", default=["4", "2x2", "1x4", "4x1", "2x1", "1x2"])
    p.add_argument("--cases", nargs="+", default=list(METHODS), choices=list(METHODS))
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    p.add_argument("--out", help="also write the JSON line to this file")
    a = p.parse_args(argv)
    results = {}
    if a.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()
        print("\n".join(smi))
        results["nvidia_smi"] = smi
    for method in a.cases:
        for n, mesh, a_end in SIZES[int(a.small)]:
            tag = f"{method}: {n}^3/grid{mesh}"
            runs, refused = {}, {}
            for layout in ["1", "1 again", *a.layouts]:
                outdir = tempfile.mkdtemp(prefix="ranks_pencils_")
                try:
                    runs[layout] = _run(n, mesh, a_end, METHODS[method],
                                        "1" if layout == "1 again" else layout, a.device,
                                        outdir)
                except ValueError as e:
                    refused[layout] = str(e)
                    print(f"{tag} -n {layout}: refused: {e}", flush=True)
                finally:
                    shutil.rmtree(outdir, ignore_errors=True)
            one = runs["1"]["spectrum"]
            for layout, r in runs.items():
                P = r.pop("spectrum")
                rel = np.abs(P[:, 2] / one[:, 2] - 1)
                i = int(np.argmax(rel))
                r.update(spectrum_max_rel=float(rel[i]), bin_k=float(P[i, 0]),
                         bin_modes=int(P[i, 1]))
                peaks = ", ".join(f"{b / 2**30:.3f}" for b in r["rank_peak_bytes"])
                print(f"{tag} -n {layout}: {r['steps']} steps, {r['evolve_s']:.2f} s of "
                      f"evolution; a step {r['step_ms']:.2f} ms (median; the first "
                      f"{r['first_step_ms']:.1f}), peak a rank {peaks} GiB; spectrum against "
                      f"-n 1 {r['spectrum_max_rel']:.3g} (k {r['bin_k']:.4g}, "
                      f"{r['bin_modes']} modes)", flush=True)
            results[tag] = {**runs, **{k: {"refused": e} for k, e in refused.items()}}
    line = json.dumps(results)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
