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

``--realize`` first realizes example_basic's particles through
``RungSimulationAdapter(dist=...).initial_state`` (what ``run()`` calls;
the rung layout of grid 2n, at least 32) at -n 1 and every N given: by
2LPT 256³ and 512³, 62³ (planes that do not split evenly over 4), the
bcc lattice 2·240³ (in float32 the unshifted sites of planes 60 and 120
lie just below their centres, so that at -n 2 and 4 their clouds reach
the row before the rank's planes), 512³ by 3LPT with the 3/2 dealiasing
(grid 768 for the products), and 1024³ by 2LPT over the largest N alone (one 80 GB card
cannot realize it).  Each realization is made
twice (the first makes the cuFFT plans); the second's seconds (rank 0's
clock, from the call to the last rank's synchronisation) and each rank's
peak device memory above what it held before are reported, and each
rank's shard is held by id against the -n 1 realization (sent to rank 0
for that, after the measurement): positions within 1e-5 of the largest
displacement plus 2·box·2⁻²⁴, momenta within 1e-5 of the largest, each
rank exactly its shard's ids.  ``--small`` realizes 8³, 16³, 6³, bcc
2·8³, 3LPT 8³ (and 24³ over the largest N).
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


# (lattice n, lattice, LPT order, the rank counts besides -n 1 it runs at:
# None for every N given, "max" for the largest alone, with no -n 1
# reference), and at --small
REALIZE = ([(256, "sc", 2, None), (512, "sc", 2, None), (62, "sc", 2, None),
            (240, "bcc", 2, None), (512, "sc", 3, None), (1024, "sc", 2, "max")],
           [(8, "sc", 2, None), (16, "sc", 2, None), (6, "sc", 2, None),
            (8, "bcc", 2, None), (8, "sc", 3, None), (24, "sc", 2, "max")])
PER_SITE = {"sc": 1, "bcc": 2, "fcc": 4}


def _realize_once(n: int, lattice: str, lpt: int, device, dist):
    """example_basic's particles on the n³ sc, bcc or fcc lattice by LPT
    of order ``lpt`` (3: with the 3/2 dealiasing) through the adapter's
    initial_state on grid 2n, twice: (flat state, seconds, peak bytes) of
    the second."""
    import torch

    from concept_tpu_torch.p3mrungs import RungSimulationAdapter
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import build_components, build_cosmology
    from concept_tpu_torch.sim import SimConfig

    # the grid of example_basic's ratio, at least 32 (the CPU's tight layout
    # needs 3 cells a side)
    mesh = max(2 * n, 32)
    N = PER_SITE[lattice] * n**3
    cfg = load_params(PARAM, overrides=[f"initial_conditions={{'species':'matter','N':{N}}}",
                                        f"potential_options={mesh}"])
    _, consts, bg, lin = build_cosmology(cfg)
    spec, _ = build_components(cfg, bg, consts)[0]
    config = SimConfig(boxsize=cfg.boxsize, potential_gridsize=mesh, device=device,
                       G=consts.G_Newton)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for _ in range(2):
        adapter = RungSimulationAdapter(spec, config, bg, lin, N_rungs=cfg.N_rungs, dist=dist)
        flat = None
        sync()
        if dist is not None:
            torch.distributed.barrier(group=dist.group)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if cuda else 0
        t0 = time.perf_counter()
        flat = adapter.initial_state(cfg.a_begin, seed=0, lpt_order=lpt, dealias=lpt == 3)
        sync()
        if dist is not None:
            torch.distributed.barrier(group=dist.group)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base if cuda else 0
    return adapter, flat, seconds, peak, cfg.boxsize


def _check_shard(flat, ref, box: float, n: int, lattice: str) -> dict:
    """A state by id against the -n 1 flat state of the n³ lattice."""
    import torch

    from concept_tpu_torch.components import lattice_positions

    q = lattice_positions(n, box, lattice, torch.float64, ref.pos.device)
    disp = ref.pos.double() - q
    disp -= box * torch.round(disp / box)
    pos_tol = 1e-5 * float(disp.abs().max()) + 2 * box * 2.0**-24
    del q, disp
    ids = flat.ids.long().to(ref.pos.device)
    dx = flat.pos.double().to(ref.pos.device) - ref.pos.double()[ids]
    dx -= box * torch.round(dx / box)
    dpos = float(dx.abs().max())
    dmom = float((flat.mom.double().to(ref.pos.device) - ref.mom.double()[ids]).abs().max())
    mom_tol = 1e-5 * float(ref.mom.abs().max())
    return dict(max_dpos=dpos, pos_tol=pos_tol, max_dmom=dmom, mom_tol=mom_tol,
                ok=dpos <= pos_tol and dmom <= mom_tol)


def _realize_rank(n: int, lattice: str, lpt: int, ranks: int, device: str, ref, rank):
    """A rank's part of ``--realize`` at -n ``ranks``: the realization,
    the ranks' seconds and peaks to rank 0, and the shards by id against
    ``ref`` (rank 0's -n 1 state, None elsewhere or where there is none)
    on rank 0.  Returns (on rank 0) the case's results."""
    import torch
    import torch.distributed as tdist

    from concept_tpu_torch.grid.fft import GridDistribution
    from concept_tpu_torch.parallel.ranks import init_rank

    dev = init_rank(rank[0], ranks, rank[1], torch.device(device))
    dist = GridDistribution()
    adapter, flat, seconds, peak, box = _realize_once(n, lattice, lpt, dev, dist)
    lo, hi = dist.split(PER_SITE[lattice] * n**3)
    ids_ok = bool(torch.equal(flat.ids.long(), torch.arange(lo, hi, device=flat.ids.device)))
    finite = bool(torch.isfinite(flat.pos).all() and torch.isfinite(flat.mom).all())
    stats = torch.tensor([seconds, peak, float(ids_ok and finite)], dtype=torch.float64,
                         device=dev)
    every = [torch.empty_like(stats) for _ in range(ranks)]
    tdist.all_gather(every, stats)
    has_ref = torch.tensor([int(ref is not None)], device=dev)
    tdist.broadcast(has_ref, 0)
    out = dict(seconds=float(every[0][0]), peak_bytes=[int(e[1]) for e in every],
               shards_ok=all(bool(e[2]) for e in every))
    if bool(has_ref):
        whole = adapter.whole(flat, root=0)
        del flat
        if rank[0] == 0:
            out.update(_check_shard(whole, ref, box, n, lattice))
    return out


def _realize(n: int, lattice: str, lpt: int, ranks: int, device: str, ref):
    """-n ``ranks`` of ``--realize``: this process is rank 0."""
    import torch

    from concept_tpu_torch.parallel.ranks import Ranks

    with Ranks(ranks, torch.device(device)) as started:
        started.start(_realize_rank, n, lattice, lpt, ranks, device, None)
        return _realize_rank(n, lattice, lpt, ranks, device, ref, rank=(0, started.store))


def realize(rank_counts: list, device: str, small: bool) -> dict:
    """``--realize``: every case at -n 1 and over the ranks."""
    import torch

    results = {}
    for n, lattice, lpt, which in REALIZE[int(small)]:
        tag = f"realize {lpt}LPT {'' if lattice == 'sc' else f'{lattice} '}{n}^3"
        res = {}
        ref = None
        if which is None:
            _, ref, seconds, peak, _ = _realize_once(n, lattice, lpt, torch.device(device), None)
            res["1"] = dict(seconds=seconds, peak_bytes=[peak])
            print(f"{tag} -n 1: {seconds:.3f} s, peak {peak / 2**30:.3f} GiB", flush=True)
        for ranks in rank_counts if which is None else [max(rank_counts)]:
            r = _realize(n, lattice, lpt, ranks, device, ref)
            res[str(ranks)] = r
            worst = max(r["peak_bytes"])
            line = (f"{tag} -n {ranks}: {r['seconds']:.3f} s, peak a rank "
                    f"{worst / 2**30:.3f} GiB (ranks: "
                    f"{', '.join(f'{b / 2**30:.3f}' for b in r['peak_bytes'])})")
            if ref is not None:
                line += (f", {worst / max(res['1']['peak_bytes'][0], 1):.3f} of -n 1's; "
                         f"max |Δx| {r['max_dpos']:.3g} (bound {r['pos_tol']:.3g}), max |Δp| "
                         f"{r['max_dmom']:.3g} (bound {r['mom_tol']:.3g})")
            print(line + f"; shards {'ok' if r['shards_ok'] else 'WRONG'}", flush=True)
            if not r["shards_ok"] or not r.get("ok", True):
                raise SystemExit(f"{tag} -n {ranks} differs from -n 1")
        del ref
        results[tag] = res
    return results


def main(argv=None) -> int:
    import numpy as np

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, nargs="+", default=[2, 4])
    p.add_argument("--layouts", nargs="+", default=["8"], choices=sorted(CASES))
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    p.add_argument("--realize", action="store_true",
                   help="first the realizations at -n 1 and over the ranks")
    p.add_argument("--out", help="also write the JSON line to this file")
    a = p.parse_args(argv)
    if a.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()
        print("\n".join(smi))
    results = realize(a.ranks, a.device, a.small) if a.realize else {}
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
