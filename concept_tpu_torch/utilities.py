"""The utilities of ``python -m concept_tpu_torch -u <name> ...`` (port of
concept_tpu/utilities.py; reference src/utilities.py: delegate :67,
powerspec :465, info :617, convert :125, and the util/* wrappers).

The measurements (powerspec, bispec) and the renders' deposits
(render2D, render3D) run on the device the CLI names (``--device``, the
card by default); class and the images run on the host.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from concept_tpu_torch.utils.terminal import abort, masterprint


def delegate(util_args: list[str], cli_args) -> int:
    name, *rest = util_args
    fn = {
        "powerspec": util_powerspec, "bispec": util_bispec, "info": util_info,
        "convert": util_convert, "render2D": util_render2d,
        "render3D": util_render3d, "class": util_class, "play": util_play,
        "watch": util_watch, "gadget": util_gadget, "update": util_update,
    }.get(name)
    if fn is None:
        abort(f"unknown utility {name!r} (have: powerspec, bispec, info, convert, "
              f"render2D, render3D, class, play, watch, gadget, update)")
    return fn(rest, cli_args)


def _device(cli_args):
    from concept_tpu_torch.device import resolve_device

    return resolve_device(getattr(cli_args, "device", None))


def _positions(state, dev, keep_dtype: bool = False):
    """A snapshot's positions on ``dev``, as float32 (the JAX utilities'
    jnp.float32) unless ``keep_dtype``."""
    import torch

    pos = torch.as_tensor(np.asarray(state.pos), device=dev)
    return pos if keep_dtype else pos.to(torch.float32)


def util_info(paths: list[str], cli_args) -> int:
    """Print snapshot metadata (reference utilities.py:617); with
    --generate-params also write <snapshot>.params.py, a parameter file
    that starts a run from the snapshot."""
    from concept_tpu_torch.io import snapshot as snap

    paths = list(paths)
    generate = "--generate-params" in paths
    if generate:
        paths.remove("--generate-params")
    for path in paths:
        kind = snap.snapshot_type(path)
        if kind is None:
            print(f"{path}: not a recognized snapshot")
            continue
        meta, comps = snap.load(path)
        print(f"{path}: {kind} snapshot")
        print(f"  a = {meta.a}, boxsize = {meta.boxsize}, H0 = {meta.H0}")
        print(f"  Ωb = {meta.Omega_b}, Ωcdm = {meta.Omega_cdm}")
        for name, (spec, _) in comps.items():
            if spec.representation == "fluid":
                print(f"  component {name!r}: species={spec.species}, fluid gridsize="
                      f"{spec.gridsize}, w={spec.w}, boltzmann order={spec.boltzmann_order} "
                      f"({spec.boltzmann_closure})")
            else:
                print(f"  component {name!r}: species={spec.species}, N={spec.N}, "
                      f"mass={spec.mass}")
        if generate:
            pf = path + ".params.py"
            with open(pf, "w") as f:
                f.write(f"# Parameter file generated from {path}\n"
                        f"initial_conditions = {path!r}\n"
                        f"boxsize = {meta.boxsize!r}\n"
                        f"H0 = {meta.H0!r}\n"
                        f"Ωb = {meta.Omega_b!r}\n"
                        f"Ωcdm = {meta.Omega_cdm!r}\n"
                        f"a_begin = {meta.a!r}\n"
                        f"unit_length = {meta.unit_length!r}\n"
                        f"unit_time = {meta.unit_time!r}\n"
                        f"unit_mass = {meta.unit_mass!r}\n")
            print(f"  wrote {pf}")
    return 0


def util_powerspec(paths: list[str], cli_args) -> int:
    """P(k) of snapshots into <snapshot>_powerspec_<component>.txt
    (reference utilities.py:465), with the powerspec_options of `-p
    PARAM` (gridsize, interpolation, interlace, bins per decade, k_max)."""
    from concept_tpu_torch.analysis.output import save_powerspec_txt
    from concept_tpu_torch.analysis.powerspec import powerspec
    from concept_tpu_torch.io import snapshot as snap
    from concept_tpu_torch.run import _bpd

    opts = {}
    if getattr(cli_args, "param", None):
        from concept_tpu_torch.param import load_params

        opts = load_params(cli_args.param).powerspec_options or {}
    dev = _device(cli_args)
    for path in paths:
        meta, comps = snap.load(path)
        for name, (spec, state) in comps.items():
            pk = powerspec(_positions(state, dev),
                           int(opts.get("gridsize") or 2 * round(spec.N ** (1 / 3))),
                           meta.boxsize, spec.N, order=opts.get("interpolation", 4),
                           interlace=bool(opts.get("interlace", True)),
                           bins_per_decade=_bpd(opts), k_max=opts.get("k_max"))
            out = path + f"_powerspec_{name}.txt"
            save_powerspec_txt(out, pk, meta.a, meta.boxsize)
            masterprint(f"Saved {out}")
    return 0


def util_bispec(paths: list[str], cli_args) -> int:
    """B(k1, k2, k3) of snapshots, 10 equilateral triangles, into
    <snapshot>_bispec_<component>.txt (reference utilities.py:511)."""
    from concept_tpu_torch.analysis.bispec import bispec
    from concept_tpu_torch.io import snapshot as snap

    dev = _device(cli_args)
    for path in paths:
        meta, comps = snap.load(path)
        for name, (spec, state) in comps.items():
            out = bispec([_positions(state, dev)], [1.0], 2 * round(spec.N ** (1 / 3)),
                         meta.boxsize, configuration="equilateral 10")
            fn = path + f"_bispec_{name}.txt"
            np.savetxt(fn, np.column_stack([out["triangles"], out["n_triangles"], out["B"]]),
                       header="k1 k2 k3 triangles B")
            masterprint(f"Saved {fn}")
    return 0


def util_render2d(paths: list[str], cli_args) -> int:
    """Project snapshots onto a grid of N^⅓ cells a side: a PNG and its
    HDF5 data, <snapshot>_render2D_<component>.png/.hdf5 (reference
    utilities.py:557)."""
    from concept_tpu_torch.graphics.render import render2D
    from concept_tpu_torch.io import snapshot as snap

    dev = _device(cli_args)
    for path in paths:
        meta, comps = snap.load(path)
        for name, (spec, state) in comps.items():
            render2D(_positions(state, dev), round(spec.N ** (1 / 3)), meta.boxsize,
                     filename=path + f"_render2D_{name}.png", save_data=True)
            masterprint(f"Saved {path}_render2D_{name}.png")
    return 0


def util_render3d(paths: list[str], cli_args) -> int:
    """Render snapshots as 3D scatter PNGs, <snapshot>_render3D_<component>.png
    (reference utilities.py:557)."""
    from concept_tpu_torch.graphics.render import render3D
    from concept_tpu_torch.io import snapshot as snap

    dev = _device(cli_args)
    for path in paths:
        meta, comps = snap.load(path)
        for name, (spec, state) in comps.items():
            fn = render3D(_positions(state, dev, keep_dtype=True), meta.boxsize,
                          path + f"_render3D_{name}.png")
            masterprint(f"Saved {fn}")
    return 0


def util_class(args: list[str], cli_args) -> int:
    """Dump the processed background + linear perturbations to HDF5
    (reference utilities.py:923 'class' utility; option surface of
    util/class: --kmin/--kmax/--modes/--times/--gauge).  Uses the
    configured Boltzmann backend (classy / internal EB solver / EH), on
    the host.  Needs h5py."""
    import argparse

    import h5py

    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import build_cosmology

    ap = argparse.ArgumentParser(prog="-u class", add_help=False)
    ap.add_argument("output", nargs="?", default="class_processed.hdf5")
    ap.add_argument("--kmin", type=float, default=None,
                    help="minimum k in 1/<unit_length> (default 1e-4/Mpc)")
    ap.add_argument("--kmax", type=float, default=None,
                    help="maximum k (default 10/Mpc)")
    ap.add_argument("--modes", type=int, default=256,
                    help="number of log-spaced k modes")
    ap.add_argument("--times", default="0.01,0.1,0.5,1.0",
                    help="comma-separated scale factors to dump at")
    ap.add_argument("--gauge", default=None,
                    choices=("nbody", "synchronous"),
                    help="realization gauge override for the tables")
    ns = ap.parse_args(args)

    overrides = []
    if ns.gauge:
        overrides.append(
            f"realization_options = {{'gauge': {ns.gauge!r}}}"
        )
    cfg = (load_params(cli_args.param, overrides=overrides)
           if cli_args.param else load_params(
               text="H0 = 67*km/(s*Mpc)\nΩb = 0.049\nΩcdm = 0.27\n"
                    + "\n".join(overrides)))
    units_, consts, bg, lin = build_cosmology(cfg)
    out = ns.output
    kmin = ns.kmin if ns.kmin is not None else 1e-4 / units_.Mpc
    kmax = ns.kmax if ns.kmax is not None else 10 / units_.Mpc
    nk = ns.modes
    a_outs = [float(x) for x in str(ns.times).split(",") if x]
    k = np.exp(np.linspace(np.log(kmin), np.log(kmax), nk))
    k32 = k.astype(np.float32)  # the JAX package evaluates at float32 k
    with h5py.File(out, "w") as f:
        f.attrs["H0"] = cfg.H0
        f.attrs["Ωb"] = cfg.Omega_b
        f.attrs["Ωcdm"] = cfg.Omega_cdm
        f.attrs["gauge"] = ns.gauge or str(
            (cfg.realization_options or {}).get("gauge", "nbody"))
        bgrp = f.create_group("background")
        a_tab = np.exp(np.linspace(np.log(1e-6), 0, 512))
        bgrp.create_dataset("a", data=a_tab)
        bgrp.create_dataset("t", data=bg.t_of_a_np(a_tab))
        bgrp.create_dataset("H", data=bg.hubble_np(a_tab))
        bgrp.create_dataset("D1", data=bg.growth_np("D1", a_tab))
        bgrp.create_dataset("f1", data=bg.growth_np("f1", a_tab))
        pgrp = f.create_group("perturbations")
        pgrp.create_dataset("k", data=k)
        for a_out in a_outs:
            g = pgrp.create_group(f"a={a_out}")
            g.create_dataset(
                "delta_m",
                data=np.asarray(lin.transfer_delta(k32, a_out), np.float32),
            )
            g.create_dataset(
                "theta_m",
                data=np.asarray(lin.transfer_theta(k32, a_out), np.float32),
            )
    masterprint(f"Saved {out}")
    return 0



def util_play(args: list[str], cli_args) -> int:
    """Replay the ANSI terminal renders of a log file (reference
    util/play).  usage: -u play <log> [--fps=5]"""
    import time

    path = args[0]
    fps = 5.0
    for a in args[1:]:
        if a.startswith("--fps="):
            fps = float(a.split("=", 1)[1])
    with open(path, errors="replace") as f:
        lines = f.read().splitlines()
    frames, current = [], []
    for ln in lines:
        if "\x1b[38;2;" in ln:
            current.append(ln)
        elif current:
            frames.append("\n".join(current))
            current = []
    if current:
        frames.append("\n".join(current))
    if not frames:
        masterprint("no terminal renders found in log")
        return 1
    for frame in frames:
        print("\x1b[2J\x1b[H" + frame)
        time.sleep(1.0 / fps)
    return 0


def util_convert(args: list[str], cli_args) -> int:
    """Convert snapshots between formats (reference utilities.py:125).
    usage: -u convert <path> ... [snapshot_type=gadget|concept]; writes
    <path>.gadget or <path>.hdf5."""
    from concept_tpu_torch.io import snapshot as snap
    from concept_tpu_torch.units import units

    paths = [a for a in args if "=" not in a]
    opts = dict(a.split("=", 1) for a in args if "=" in a)
    target = opts.get("snapshot_type", "concept")
    for path in paths:
        meta, comps = snap.load(path)
        if target == "gadget":
            if len(comps) == 1:
                ((_, (spec, state)),) = comps.items()
                out = snap.save_gadget(path + ".gadget", meta, spec, state, units)
            else:
                out = snap.save_gadget_components(path + ".gadget", meta, comps, units)
        else:
            out = snap.save_concept(path + ".hdf5", meta, comps)
        masterprint(f"Converted {path} → {out}")
    return 0


def util_watch(args: list[str], cli_args) -> int:
    """Follow a job's log (reference util/watch): the newest job under
    job/, or the one given.  usage: -u watch [jobid] [timeout=SECONDS]"""
    import time

    opts = dict(a.split("=", 1) for a in args if "=" in a)
    ids = [a for a in args if "=" not in a]
    job_dir = "job"
    if not os.path.isdir(job_dir):
        masterprint("no job directory found")
        return 1
    if ids:
        jobid = ids[0]
    else:
        existing = sorted((int(d) for d in os.listdir(job_dir) if d.isdigit()), reverse=True)
        if not existing:
            masterprint("no jobs found")
            return 1
        jobid = str(existing[0])
    log = os.path.join(job_dir, jobid, "log")
    if not os.path.exists(log):
        masterprint(f"no log for job {jobid}")
        return 1
    masterprint(f"Watching job {jobid} ({log})")
    timeout = float(opts.get("timeout", 0)) or None
    t0 = time.time()
    with open(log, encoding="utf-8", errors="replace") as f:
        for line in f:
            print(line, end="")
        while True:
            line = f.readline()
            if line:
                print(line, end="")
                continue
            if timeout is not None and time.time() - t0 > timeout:
                return 0
            time.sleep(0.5)


def util_gadget(args: list[str], cli_args) -> int:
    """Write a GADGET-2 parameter file and output list matched to a
    parameter file, for running GADGET-2 beside this code (reference
    util/gadget).  usage: -u gadget <param_file> [ic=<snapshot>]
    [output=<dir>]"""
    from concept_tpu_torch.param import load_params

    paths = [a for a in args if "=" not in a]
    opts = dict(a.split("=", 1) for a in args if "=" in a)
    if not paths:
        abort("usage: -u gadget <param_file> [ic=<snapshot>] [output=<dir>]")
    cfg = load_params(paths[0])
    outdir = opts.get("output", "gadget_run")
    os.makedirs(outdir, exist_ok=True)
    ic = opts.get("ic", "<path to initial condition file>")

    def flatten(obj):
        if isinstance(obj, dict):
            for v in obj.values():
                yield from flatten(v)
        elif isinstance(obj, (list, tuple, set)):
            for v in obj:
                yield from flatten(v)
        else:
            try:
                yield float(obj)
            except (TypeError, ValueError):
                pass

    a_out = sorted(set(flatten(cfg.output_times))) or [1.0]
    outputlist = os.path.join(outdir, "outputlist.txt")
    np.savetxt(outputlist, np.asarray(a_out))
    pot = cfg.potential_options or {}
    mesh = pot.get("gridsize") or (pot.get("gridsize_per_method") or {}).get("p3m") or 128
    # PMGRID from the mesh; ASMTH and RCUT from the P³M split
    param_path = os.path.join(outdir, "gadget.param")
    with open(param_path, "w", encoding="utf-8") as f:
        f.write(f"""% GADGET-2 parameter file generated by the concept_tpu_torch gadget utility
% matched to {paths[0]}
InitCondFile       {ic}
OutputDir          {outdir}
OutputListFilename {outputlist}
OutputListOn       1
SnapFormat         2
ICFormat           2
TimeBegin          {cfg.a_begin}
TimeMax            {max(a_out)}
Omega0             {cfg.Omega_b + cfg.Omega_cdm}
OmegaLambda        {1 - cfg.Omega_b - cfg.Omega_cdm}
OmegaBaryon        {cfg.Omega_b}
HubbleParam        {cfg.h}
BoxSize            {cfg.boxsize}
ComovingIntegrationOn 1
PeriodicBoundariesOn  1
TypeOfTimestepCriterion 0
ErrTolIntAccuracy  0.025
MaxSizeTimestep    0.03
MinSizeTimestep    0.0
ErrTolTheta        0.5
TypeOfOpeningCriterion 1
ErrTolForceAcc     0.005
PMGRID             {mesh}
ASMTH              1.25
RCUT               4.5
""")
    masterprint(f"Wrote {param_path} and {outputlist}")
    masterprint(f"Build GADGET-2 with PMGRID set as above and run: Gadget2 {param_path}")
    return 0


def util_update(args: list[str], cli_args) -> int:
    """Update the code (reference util/update): a fast-forward `git
    pull` of the checkout that holds the package."""
    import subprocess

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if not os.path.isdir(os.path.join(pkg_root, ".git")):
        masterprint(f"{pkg_root} is not a git checkout; nothing to update")
        return 1
    masterprint(f"Updating {pkg_root} ...")
    r = subprocess.run(["git", "-C", pkg_root, "pull", "--ff-only"],
                       capture_output=True, text=True)
    print(r.stdout, end="")
    if r.returncode != 0:
        print(r.stderr, end="", file=sys.stderr)
        return r.returncode
    masterprint("done")
    return 0
