"""The default rung run over N ranks against one rank, through ``run()``
(what ``python -m concept_tpu_torch -p param/example_basic.py -n N``
calls): example_basic as shipped (64³, grid 128: 16 planes of cells) to
a = 0.1, and 256³ on grid 512 (64 planes) to a = 0.023, each with -n 1
and every N given.  Prints one JSON line: per run the base steps, the
evolution's seconds (the first collectives' set-up included), the ms of
each base step on rank 0's clock between device synchronisations (the
first, and the median of the rest), the highest rung, and against the
-n 1 run the spectrum's largest relative difference and the mean and
largest |Δx|/box of the final positions (by id).

    python3 scripts/ranks_rungs.py --ranks 2 4 [--device cpu] [--small]

``--ranks 2 4`` needs four cards.  ``--small`` runs 8³ on grid 32 and
16³ on grid 64 (the CPU).
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


def _run(n: int, mesh: int, a_end: float, ranks: int, device: str, outdir: str):
    import numpy as np

    import torch

    from concept_tpu_torch import p3mrungs
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    cfg = load_params(PARAM, overrides=[
        f"initial_conditions={{'species':'matter','N':{n}**3}}", f"potential_options={mesh}",
        f"output_times={{'powerspec': [{a_end}]}}", f"output_dirs='{outdir}'"])
    # this process is rank 0: its base steps, each between synchronisations
    step, ms = p3mrungs.P3MRungSimulation.base_step, []

    def timed(self, *args, **kw):
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        out = step(self, *args, **kw)
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
        return out

    p3mrungs.P3MRungSimulation.base_step = timed
    try:
        sim, state, _ = run(cfg, device=device, n_devices=ranks)
    finally:
        p3mrungs.P3MRungSimulation.base_step = step
    stats = sim.inner.stats
    order = state.ids.argsort()
    pk = np.loadtxt(os.path.join(outdir, f"powerspec_a={a_end:.4g}.txt"))
    return dict(base_steps=stats["base_steps"], max_rung=stats["max_rung"],
                evolve_s=sim.timings["evolve_s"], first_base_step_ms=ms[0],
                base_step_ms=float(np.median(ms[1:])),
                layout_cells=sim.inner.ucb, deficit=stats["pm_mass_deficit_max"],
                pos=state.pos[order].double().cpu().numpy(), power=pk[:, 2]), cfg.boxsize


def main(argv=None) -> int:
    import numpy as np

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, nargs="+", default=[2, 4])
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    p.add_argument("--out", help="also write the JSON line to this file")
    a = p.parse_args(argv)
    cases = ((8, 32, 0.05), (16, 64, 0.03)) if a.small else ((64, 128, 0.1), (256, 512, 0.023))
    if a.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()
        print("\n".join(smi))
    results = {}
    for n, mesh, a_end in cases:
        tag = f"{n}^3/grid{mesh}"
        runs = {}
        for ranks in [1, *a.ranks]:
            outdir = tempfile.mkdtemp(prefix="ranks_rungs_")
            try:
                runs[ranks], box = _run(n, mesh, a_end, ranks, a.device, outdir)
            finally:
                shutil.rmtree(outdir, ignore_errors=True)
        one = runs[1]
        for ranks, r in runs.items():
            dx = r["pos"] - one["pos"]
            dx -= box * np.round(dx / box)
            d = np.sqrt((dx**2).sum(1)) / box
            r.update(mean_dx=float(d.mean()), max_dx=float(d.max()),
                     spectrum_max_rel=float(np.abs(r["power"] / one["power"] - 1).max()))
            print(f"{tag} -n {ranks}: {r['base_steps']} base steps, {r['evolve_s']:.2f} s of "
                  f"evolution; a base step {r['base_step_ms']:.1f} ms (median; the first "
                  f"{r['first_base_step_ms']:.1f}), highest rung {r['max_rung']}, "
                  f"layout cells {r['layout_cells']}; against -n 1: spectrum "
                  f"{r['spectrum_max_rel']:.3g}, mean |Δx|/box {r['mean_dx']:.3g}, max "
                  f"{r['max_dx']:.3g}", flush=True)
        results[tag] = {str(k): {f: v for f, v in r.items() if f not in ("pos", "power")}
                        for k, r in runs.items()}
    line = json.dumps(results)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
