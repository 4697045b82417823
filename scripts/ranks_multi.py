"""Runs of several components and fluids over N ranks against one rank,
through ``run()`` (what ``python -m concept_tpu_torch -p <param> -n N``
calls), each rank holding its particle shards and its x-rows of every
fluid grid (sim_multi.MultiSimulation(dist=...)):

  nonlinnu        param/example_nonlinnu.py as shipped (80³ matter, P³M
                  grid 40, the ν fluid on grid 40 at order 1, KT), the
                  light Einstein-Boltzmann settings, for ``--steps``
                  global steps (the ν Courant limit sets Δt);
  cdm_baryon      example_basic with 64³ cold dark matter and 32³
                  baryons on grid 128 to a = 0.1;
  twins           the same with 64³ baryons, -n 1 twice: the two
                  components are realized as twins (the same lattice and
                  displacements), which at softening 0 separate at the
                  rounding of rows 6 and 2 and then feel forces no two
                  summation orders share, so that two runs on one card
                  differ (its deposit adds with atomics) as a run over
                  ranks does;
  relativistic    param/example_relativistic.py as shipped (128³ matter,
                  the radiation on grid 128 re-realized at every kick) to
                  a = 0.02;
  nonlinnu256     example_nonlinnu with ``_size = 256`` (256³ matter, the
                  ν fluid on grid 128, P³M grid 128) for ``--big-steps``
                  steps, at -n 1 and the largest N only;

each at -n 1 and every N given (a case the ranks cannot run is reported
with its error).  Prints one JSON line: per run the steps, the
evolution's seconds and ms a step (rank 0's clock; the first
collectives' set-up included), each rank's peak device memory over the
run (``sim.stats['rank_peak_bytes']``), and against -n 1 the largest
relative difference of every power spectrum the run wrote (each
component, each pair, the fluid's δ) with the k and the mode count of
the bin where it lies.

    python3 scripts/ranks_multi.py --ranks 2 4 [--cases ...] [--device cpu]
        [--small] [--out ranks_multi.json]

``--ranks 2 4`` needs four cards.  ``--small`` runs 8³ (the ν fluid on
grid 8, potential 16; 4³ baryons; the radiation on grid 16; 16³ on grid
32 for the big case) for the CPU; the ν runs solve their light tables
(8 modes) once a size.  ``--diagnose`` (one card) runs
:func:`diagnose` instead of the runs over ranks.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "eb", "eb_5c2f1bb77ed40020.npz")
NU_OPTIONS = "'modes_per_decade':3,'rtol':1e-4,'n_q':4,'l_max_ncdm':6,'l_max_ur':10,'k_max':3.0"
ALL_PAIRS = "powerspec_select={'all': True, 'all combinations': True}"


def _param(name: str) -> str:
    return os.path.join(ROOT, "param", name)


def _nu(n: int, grid: int, nu_grid: int, cache: str) -> list:
    return [f"initial_conditions=[{{'species':'matter','N':{n}**3}},{{'species':'neutrino',"
            f"'gridsize':{nu_grid},'boltzmann order':1}}]", f"potential_options={grid}",
            ALL_PAIRS, f"boltzmann_options={{{NU_OPTIONS},'cache_dir':'{cache}'}}"]


def _cb(n_b: int, small: bool) -> list:
    n, n_b, grid = (8, n_b // 8, 16) if small else (64, n_b, 128)
    return [f"initial_conditions=[{{'species':'cold dark matter','N':{n}**3}},"
            f"{{'species':'baryon','N':{n_b}**3}}]", f"potential_options={grid}",
            "output_times={'powerspec': [0.1]}", ALL_PAIRS]


def _rel(small: bool) -> list:
    if not small:
        return ["output_times={'powerspec': [0.02]}"]
    return ["initial_conditions=[{'species':'matter','N':8**3},{'name':'linear','species':"
            "'radiation','gridsize':16,'boltzmann order':-1,'boltzmann closure':'class'}]",
            "potential_options=16", "output_times={'powerspec': [0.02]}"]


def _a_after(param: str, overrides: list, steps: int, device: str) -> float:
    """The a at the middle of global step ``steps`` of a configuration
    (planned on the host, as the run plans its steps)."""
    from concept_tpu_torch.device import resolve_device, resolve_dtype
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import build_components, build_cosmology, make_multi

    cfg = load_params(param, overrides=overrides)
    units, consts, bg, lin = build_cosmology(cfg)
    dev = resolve_device(device)
    plan = make_multi(cfg, build_components(cfg, bg, consts), units, consts, bg, lin, dev,
                      resolve_dtype(dev))
    for i, (t, dt, _, _) in enumerate(plan.schedule(cfg.a_begin, 1.0)):
        if i == steps - 1:
            return float(bg.a_of_t_np(t + 0.5 * dt))
    raise ValueError(f"fewer than {steps} steps to a = 1")


def _cases(names, small: bool, steps: int, big_steps: int, cache: str, device: str) -> dict:
    """name → (parameter file, overrides, the rank counts it runs at:
    None for every N given, 'max' for the largest, 'twice' for -n 1 a
    second time and every N), for the cases ``names``."""
    nu = _nu(*((8, 16, 8) if small else (80, 40, 40)), cache)
    nu256 = _nu(*((16, 32, 16) if small else (256, 128, 128)), cache)
    out = {}
    for name, ovr, st, which in (("nonlinnu", nu, steps, None),
                                 ("nonlinnu256", nu256, big_steps, "max")):
        if name not in names:
            continue
        a_end = _a_after(_param("example_nonlinnu.py"), ovr, st, device)
        out[name] = (_param("example_nonlinnu.py"),
                     ovr + [f"output_times={{'powerspec': [{a_end!r}]}}"], which)
    out["cdm_baryon"] = (_param("example_basic.py"), _cb(32, small), None)
    out["twins"] = (_param("example_basic.py"), _cb(64, small), "twice")
    out["relativistic"] = (_param("example_relativistic.py"), _rel(small), None)
    return out


def _run(param: str, overrides: list, ranks: int, device: str, outdir: str) -> dict:
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    cfg = load_params(param, overrides=overrides + [f"output_dirs='{outdir}'"])
    sim, _, a = run(cfg, device=device, n_devices=ranks)
    steps = sim.hysteresis["step_count"]
    spectra = {os.path.basename(f).split("_a=")[0]: np.loadtxt(f)[:, :3]
               for f in glob.glob(os.path.join(outdir, "powerspec_*"))}
    return dict(a_end=a, steps=steps, evolve_s=sim.timings["evolve_s"],
                realize_s=sim.timings["realize_s"],
                ms_per_step=1e3 * sim.timings["evolve_s"] / max(steps, 1),
                rank_peak_bytes=sim.stats["rank_peak_bytes"],
                pm_mass_deficit_max=sim.stats["pm_mass_deficit_max"], spectra=spectra)


def _max_rel(P, ref) -> tuple:
    """The largest relative difference of spectrum columns (k, modes, P)
    from ref's, with the k and the modes of its bin."""
    rel = np.abs(P[:, 2] / ref[:, 2] - 1)
    i = int(np.argmax(rel))
    return float(rel[i]), float(P[i, 0]), int(P[i, 1])


def diagnose(cases: dict, names, device: str) -> dict:
    """On one card, where the spectra of a run over ranks part from -n
    1's: at a_begin, the spectra (run.dump_multi) of one device's
    realization measured on one device and measured over a world of one
    rank (the slab deposit and FFT), and of the realization over that
    rank measured there; at the case's last output, one device's steps
    from the realization over the rank, and the rank's steps from it,
    each against one device's steps from its own realization; then two
    -n 1 runs of each case, the second against the first (the card's
    run-to-run spread: its deposits add with atomics)."""
    import torch
    import torch.distributed as tdist

    from concept_tpu_torch.device import resolve_device, resolve_dtype
    from concept_tpu_torch.grid.fft import GridDistribution
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import (
        build_components, build_cosmology, dump_multi, make_multi, realize_multi_component,
    )
    from concept_tpu_torch.sim_multi import MultiState

    store = tempfile.mkdtemp(prefix="ranks_multi_store_")
    tdist.init_process_group("nccl" if device == "cuda" else "gloo",
                             store=tdist.FileStore(os.path.join(store, "store"), 1), rank=0,
                             world_size=1)
    out = {}
    try:
        dist = GridDistribution()
        for name in names:
            param, overrides, _ = cases[name]
            cfg = load_params(param, overrides=overrides)
            units, consts, bg, lin = build_cosmology(cfg)
            comps = build_components(cfg, bg, consts)
            dev = resolve_device(device)
            seed = int(cfg.random_seeds.get("primordial amplitudes", 0))
            sims = {tag: make_multi(cfg, comps, units, consts, bg, lin, dev, resolve_dtype(dev),
                                    dist=dd) for tag, dd in (("one", None), ("rank", dist))}
            states = {tag: MultiState(*({s.name: realize_multi_component(
                cfg, sim, s, cfg.a_begin, seed) for s in specs.values()}
                for specs in (sim.pspecs, sim.fspecs))) for tag, sim in sims.items()}
            spectra = {}
            for real, meas in (("one", "one"), ("one", "rank"), ("rank", "rank")):
                d = tempfile.mkdtemp(prefix="ranks_multi_diag_")
                cfg.output_dirs = {**cfg.output_dirs, "powerspec": d}
                dump_multi(cfg, sims[meas], states[real], cfg.a_begin, "powerspec", units, lin)
                spectra[real, meas] = {os.path.basename(f).split("_a=")[0]: np.loadtxt(f)[:, :3]
                                       for f in glob.glob(os.path.join(d, "powerspec_*"))}
                shutil.rmtree(d, ignore_errors=True)
            ref = spectra["one", "one"]
            res = {f"{real} realized, {meas} measured": {
                k: _max_rel(P, ref[k]) for k, P in spectra[real, meas].items()}
                for real, meas in (("one", "rank"), ("rank", "rank"))}
            # evolved to the case's last output: one device from either
            # realization, and over the rank from its own
            a_end = max(cfg.output_times["a"]["powerspec"])
            for real, step in (("one", "one"), ("rank", "one"), ("rank", "rank")):
                st, a = sims[step].evolve(states[real], cfg.a_begin, a_end)
                d = tempfile.mkdtemp(prefix="ranks_multi_diag_")
                cfg.output_dirs = {**cfg.output_dirs, "powerspec": d}
                dump_multi(cfg, sims[step], st, a, "powerspec", units, lin)
                spectra[real, step, "end"] = {
                    os.path.basename(f).split("_a=")[0]: np.loadtxt(f)[:, :3]
                    for f in glob.glob(os.path.join(d, "powerspec_*"))}
                shutil.rmtree(d, ignore_errors=True)
            ref = spectra["one", "one", "end"]
            res.update({f"at a = {a_end:.6g}, {real} realized, stepped on {step}": {
                k: _max_rel(P, ref[k]) for k, P in spectra[real, step, "end"].items()}
                for real, step in (("rank", "one"), ("rank", "rank"))})
            del states, sims
            twice = []
            for _ in range(2):
                d = tempfile.mkdtemp(prefix="ranks_multi_")
                try:
                    twice.append(_run(param, overrides, 1, device, d)["spectra"])
                finally:
                    shutil.rmtree(d, ignore_errors=True)
            res["-n 1 against -n 1 again"] = {k: _max_rel(P, twice[0][k])
                                              for k, P in twice[1].items()}
            out[name] = res
            print(f"diagnose {name}: {json.dumps(res)}", flush=True)
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, nargs="+", default=[2, 4])
    p.add_argument("--cases", nargs="+", default=["nonlinnu", "cdm_baryon", "twins",
                                                  "relativistic", "nonlinnu256"])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--big-steps", type=int, default=20)
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    p.add_argument("--diagnose", action="store_true",
                   help="one card: where the spectra part from -n 1's (see diagnose)")
    p.add_argument("--out", help="also write the JSON line to this file")
    a = p.parse_args(argv)
    results = {}
    if a.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()
        print("\n".join(smi))
        results["nvidia_smi"] = smi
    cache = tempfile.mkdtemp(prefix="ranks_multi_eb_")
    # the fixture's rows of the light settings, under the key of
    # example_nonlinnu's (tests/test_torch_multi_runs.py); other sizes solve
    shutil.copy(FIXTURE, os.path.join(cache, "eb_41b37a4fde5ce466.npz"))
    try:
        cases = _cases(a.cases, a.small, a.steps, a.big_steps, cache, a.device)
        if a.diagnose:
            results["diagnose"] = diagnose(cases, [c for c in a.cases if c in (
                "nonlinnu", "cdm_baryon", "relativistic")], a.device)
        for name in (() if a.diagnose else a.cases):
            param, overrides, which = cases[name]
            counts = {None: [1, *a.ranks], "max": [1, max(a.ranks)],
                      "twice": [1, "1 again", *a.ranks]}[which]
            runs, refused = {}, {}
            for ranks in counts:
                outdir = tempfile.mkdtemp(prefix="ranks_multi_")
                try:
                    runs[ranks] = _run(param, overrides, 1 if ranks == "1 again" else ranks,
                                       a.device, outdir)
                except ValueError as e:
                    refused[ranks] = str(e)
                    print(f"{name} -n {ranks}: refused: {e}", flush=True)
                finally:
                    shutil.rmtree(outdir, ignore_errors=True)
            one = runs[1]
            for ranks, r in runs.items():
                r["spectrum_max_rel"], r["spectrum_max_rel_bin"] = {}, {}
                for k, P in r["spectra"].items():
                    rel = np.abs(P[:, 2] / one["spectra"][k][:, 2] - 1)
                    i = int(np.argmax(rel))
                    r["spectrum_max_rel"][k] = float(rel[i])
                    # the bin of the largest difference: k and its modes
                    r["spectrum_max_rel_bin"][k] = (float(P[i, 0]), int(P[i, 1]))
                peaks = ", ".join(f"{b / 2**30:.3f}" for b in r["rank_peak_bytes"])
                print(f"{name} -n {ranks}: {r['steps']} steps to a = {r['a_end']:.6g}, "
                      f"{r['evolve_s']:.2f} s of evolution ({r['ms_per_step']:.2f} ms a step), "
                      f"peak a rank {peaks} GiB; spectra against -n 1: "
                      f"{json.dumps({k: float(f'{v:.3g}') for k, v in r['spectrum_max_rel'].items()})}",
                      flush=True)
            results[name] = {str(k): {f: v for f, v in r.items() if f != "spectra"}
                             for k, r in runs.items()}
            results[name].update({str(k): {"refused": e} for k, e in refused.items()})
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    line = json.dumps(results)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
