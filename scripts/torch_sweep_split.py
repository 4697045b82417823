"""Where the global pair-sweep kernel's time goes (PERF.md rows 6 and 2),
on the card.

    python3 scripts/torch_sweep_split.py [--out FILE.json] [--reps N]

Builds csrc/pair_sweep.cu as shipped and as variants (nvcc with -D flags
into a temporary directory, all at once): PAIR_SWEEP_SPLIT=1 tests every
pair but runs no force path, =2 only stages the neighbourhoods; GW_RMAX
= 1, 4 receivers a lane (as shipped: 2), and GW_STAGE_BYTES = 4096 with
GW_BLOCKS_F32 = 8 (as shipped: 8192 bytes of staging a warp, 5 blocks an
SM; the smaller staging lets 8 blocks fit, at fewer registers).  On each shape it times, in turns, the shipped kernel,
each variant, row 1's kernel (``pair_sweep``) with the same bounds and
without bounds (what rows 6 and 2 launched before they had a kernel of
their own), and the shipped kernel again, between CUDA events; the
variants' outputs are not checked (the split ones compute no force).
Shapes: the global stepper's slots of a realized 128³ state on grid 256
and 256³ on grid 512, the final slots of example_basic with N_rungs = 1
(64³, grid 128, a = 1: deep clustered columns), ``P3MSimulation``'s slots
at 256³ / grid 512 after 2LPT and evolution to a = 0.025, and row 2 on
the final state of CDM + baryons (64³ each, grid 128, a = 1: CDM
receivers against baryon suppliers).  Prints the card's name and power
limit.  Needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from concept_tpu_torch import _build  # noqa: E402
from concept_tpu_torch.forces import cuda_shortrange as sr  # noqa: E402

# name → (-D flags, receivers a lane at most)
VARIANTS = {
    "no_force": (["-DPAIR_SWEEP_SPLIT=1"], 2),
    "staging_only": (["-DPAIR_SWEEP_SPLIT=2"], 2),
    "R1": (["-DGW_RMAX=1"], 1),
    "R4": (["-DGW_RMAX=4"], 4),
    "stage4k_8blocks": (["-DGW_STAGE_BYTES=4096", "-DGW_BLOCKS_F32=8"], 2),
}


def build_variants(tmp: str) -> dict:
    """{name: ctypes library} of every variant, nvcc runs all at once."""
    src = os.path.join(_build.CSRC, "pair_sweep.cu")
    procs = {}
    for name, (flags, _) in VARIANTS.items():
        out = os.path.join(tmp, f"pair_sweep_{name}.so")
        cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", *flags, "-o", out, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for the variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(out)
    return libs


def _with_library(lib, item_rows: int, fn):
    """fn() with the wrapper loading ``lib`` as pair_sweep's library and
    building items of ``item_rows`` rows."""
    shipped = _build.load("pair_sweep")
    item_rows_shipped = sr.GLOBAL_ITEM_ROWS
    _build._libs["pair_sweep"] = lib
    sr.GLOBAL_ITEM_ROWS = item_rows
    try:
        return fn()
    finally:
        _build._libs["pair_sweep"] = shipped
        sr.GLOBAL_ITEM_ROWS = item_rows_shipped


def split_shape(tag: str, recv, sup, geom, rext, sext, libs: dict, reps: int) -> dict:
    import torch

    from concept_tpu_torch.forces.shortrange import dtype_square

    args = (geom.nc, geom.boxsize, geom.scale, dtype_square(geom.cutoff, recv.dtype),
            dtype_square(geom.softening, recv.dtype), geom.softening_kernel)
    row2 = sup is not recv
    wrapper = sr.pair_sweep_subset if row2 else sr.pair_sweep_global

    def shipped():
        return wrapper(recv, sup, *args, rext=rext, sext=sext)

    calls = {"shipped": shipped,
             "row1_bounded": lambda: sr.pair_sweep(recv, sup, *args, rext=rext, sext=sext),
             "row1_unbounded": lambda: sr.pair_sweep(recv, sup, *args)}
    for name, lib in libs.items():
        calls[name] = (lambda lib=lib, rows=32 * VARIANTS[name][1]:
                       _with_library(lib, rows, shipped))
    ms = {}
    for name in ["shipped", *libs, "row1_bounded", "row1_unbounded"]:
        ms[name] = cs._time_ms(calls[name], reps)
    ms["shipped_again"] = cs._time_ms(shipped, reps)
    # the outputs that must agree: R and staging variants, row 1 bounded
    ref = shipped()
    same = {name: bool(torch.equal(calls[name](), ref))
            for name in ("R1", "R4", "stage4k_8blocks", "row1_bounded")}
    C = recv.shape[2]
    rb = torch.clamp(rext.long(), max=recv.shape[1])
    items = int((-(-rb // sr.GLOBAL_ITEM_ROWS)).sum())
    tested, within, _, n_valid = cs._pair_work(recv, geom.nc, geom.boxsize, args[3], args[4],
                                               sr.OFFSETS_27, sup if row2 else None)
    out = {"K_r": recv.shape[1], "K_s": sup.shape[1], "C": C, "columns_live": int((rb > 0).sum()),
           "items": items, "deepest": int(rb.max()), "pairs_tested": tested,
           "pairs_in_cutoff": within, "valid_slots": n_valid, "ms": ms,
           "bitwise_equal_shipped": same}
    print(f"{tag}: K_r {out['K_r']}, K_s {out['K_s']}, {out['columns_live']} of {C} columns "
          f"live, {items} items, deepest {out['deepest']}; {tested} pair tests, {within} in "
          f"the cutoff; ms " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; equal to the shipped output bit for bit: {same}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", help="write the numbers to this JSON file")
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)

    import torch

    from concept_tpu_torch.p3msim import P3MSimulation
    from concept_tpu_torch.ic import realize_particles

    if not torch.cuda.is_available():
        print("torch_sweep_split: needs the card", file=sys.stderr)
        return 2
    smi = cs._nvidia_smi()
    print(smi)
    cs.build()
    tmp = tempfile.mkdtemp(prefix="sweep_split_")
    libs = build_variants(tmp)
    results = {"nvidia_smi": smi}

    def global_shape(tag, sim, pos):
        slots, _ = cs._global_sweep_slots(sim, pos)
        ext = cs._occ(slots, sim.config.boxsize)
        results[tag] = split_shape(tag, slots, slots, cs._sweep_geometry(sim), ext, ext,
                                   libs, args.reps)

    for N, mesh in ((128**3, 256), (256**3, 512)):
        sim, flat = cs._global_sim(N, mesh, "cuda")
        global_shape(f"global_{round(N ** (1 / 3))}_realized", sim, flat.pos)
        del sim, flat
    outdir = tempfile.mkdtemp(prefix="sweep_split_run_")
    try:
        sim, state, _, _, _ = cs._run(["N_rungs=1"], outdir, cs.GLOBAL_KERNELS)
        global_shape("global_64_final", sim, state.pos)
        del sim, state
        msim, mstate, _, _, _, _ = cs._multi_run(
            cs.PARAM, ["initial_conditions=[{'species':'cold dark matter','N':64**3},"
                       "{'species':'baryon','N':64**3}]", "potential_options=128",
                       cs.ALL_PAIRS], outdir, cs.PAIR_ROWS)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    cdm = cs._component_slots(msim, mstate.particles["cold dark matter"].pos)
    bar = cs._component_slots(msim, mstate.particles["baryon"].pos)
    geom = cs._sweep_geometry(msim)
    results["row2_cdm_baryon_final"] = split_shape(
        "row2_cdm_baryon_final", cdm, bar, geom, cs._occ(cdm, geom.boxsize),
        cs._occ(bar, geom.boxsize), libs, args.reps)
    del cdm, bar, msim, mstate

    cfg, consts, bg, lin, spec, soft = cs._example(256, 512)
    st0 = realize_particles(lin, spec, cfg.boxsize, 0.02, seed=0, lpt_order=2, device="cuda")
    psim = P3MSimulation(256, cfg.boxsize, spec.mass, consts.G_Newton, mesh=512, bg=bg,
                         softening=soft, softening_kernel=cfg.softening_kernel)
    pstate = psim.init_state(st0.pos.T.unbind(0), st0.mom.T.unbind(0))
    del st0
    pstate = psim.evolve(pstate, float(bg.t_of_a_np(0.02)), float(bg.t_of_a_np(0.025)))
    from concept_tpu_torch.forces.shortrange import SENTINEL

    slots = torch.where(pstate.valid[None], pstate.pos, SENTINEL * cfg.boxsize).contiguous()
    ext = psim._extents(pstate)
    results["p3m_256_final"] = split_shape("p3m_256_final", slots, slots, psim, ext, ext,
                                           libs, args.reps)
    del slots, pstate, psim
    shutil.rmtree(tmp, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
