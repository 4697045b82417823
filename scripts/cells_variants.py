"""Time variants of the slot-layout CIC kernels (PERF.md rows 3, 4, 8 and
9) on one NVIDIA card.

    python3 scripts/cells_variants.py [--clustered] [--flagship] [--out variants.json]
    python3 scripts/cells_variants.py --row4 [--out variants.json]

Builds scripts/cells_variants.cu (csrc/cells.cu's kernels as built, the
first design of one thread per slot as "before", other tile shapes and
chunk depths, and splits that leave one part of the work out) with nvcc
for sm_90a, then times every deposit variant and every gather variant
(D = 3, the three force components) of a layout on its slots, the as-built
kernels also with per-column extents (1 + each column's last live row),
and the mesh's zeroing alone:

- the table's shapes: a realized 128³ state on grid 256 in the rung
  stepper's cells 8 and 4 mesh cells wide, and in the global stepper's
  2-mesh-cell blocks;
- with --clustered, the final slots of example_basic's runs: the rungs
  (64³, grid 128, cb 8), the 4-mesh-cell layout (62³, grid 124, cb 4), the
  tight layout (63³, grid 126, blocks) and global steps (``N_rungs = 1``,
  blocks), and of the bucket stepper's sustained 256³ run;
- with --flagship, bench.py's flagship 512³ lattice on grid 512 (8 full
  slots a block); then its bucket step with the first design's kernels
  and with the kernels as built, timed in turns (before, built, built,
  before) and split by kernel with torch.profiler;
- with --row4 instead, the cells' gather (row 4) alone, on the states its
  design was chosen on: the 128³ / grid 256 check in cells 8 and 4 mesh
  cells wide, the final slots of example_basic's 8- and 4-mesh-cell runs,
  the lean kick's realized 384³ / grid 768 slots at D = 1 and 3, and a
  realized (2LPT) 256³ / grid 512 state in 8-mesh-cell cells, also cut
  to its first 16 and 24 rows.

Each variant is timed twice in turn (CUDA events, 20 launches after a
warm-up; the deposit's time includes zeroing the mesh, as the wrapper's
does); the complete ones are held against the plain versions (rtol 2e-5,
atol 1e-5·max|ref|).
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


def _build():
    from concept_tpu_torch import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib = os.path.join(_build.BUILD_DIR, "cells_variants.so")
    src = os.path.join(ROOT, "scripts", "cells_variants.cu")
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
    lib = ctypes.CDLL(lib)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.deposit_variant_run.argtypes = [I, P, P, P, P, I, I, F, P, P, P]
    lib.gather_variant_run.argtypes = [I, P, P, P, P, I, I, F, P, P, I, P, P]
    for kind in ("deposit", "gather"):
        getattr(lib, f"{kind}_variant_name").restype = ctypes.c_char_p
    return lib


def _variants(lib, kind: str, cb: int, zmajor: bool) -> list[tuple[int, str]]:
    """(id, name) of the variants of ``kind`` on the layout (cb, zmajor)."""
    layout = 2 * cb + int(zmajor)
    return [(v, getattr(lib, f"{kind}_variant_name")(v).decode())
            for v in range(getattr(lib, f"{kind}_variants")())
            if getattr(lib, f"{kind}_variant_layout")(v) == layout]


def _takes_ext(lib, kind: str, v: int) -> bool:
    """Whether variant v runs with the per-column extents."""
    return kind == "gather" and bool(lib.gather_variant_ext(v))


def _extents(valid):
    """1 + each column's last live row, (C,) int32."""
    import torch

    K = valid.shape[0]
    rows1 = torch.arange(1, K + 1, dtype=torch.int32, device=valid.device)[:, None]
    return torch.where(valid, rows1, 0).max(dim=0).values.contiguous()


def _deposit(lib, v: int, pos3, w, mesh: int, box: float, cb: int, ext=None):
    """Deposit variant v on the slots pos3 (three (K, C) rows-contiguous
    tensors) of weights w into a zeroed mesh."""
    import torch

    K, C = w.shape
    grid = torch.zeros((mesh, mesh, mesh), device="cuda")
    err = lib.deposit_variant_run(v, *(p.data_ptr() for p in pos3), w.data_ptr(), K,
                                  mesh // cb, float(mesh / box),
                                  ext.data_ptr() if ext is not None else None,
                                  grid.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"deposit variant {v}: cudaError_t {err}")
    return grid


def _gather(lib, v: int, pos3, w, grids, mesh: int, box: float, cb: int, ext=None):
    """Gather variant v of the D grids at the slots: (D, K, C)."""
    import torch

    K, C = w.shape
    out = torch.empty((grids.shape[0], K, C), device="cuda")
    err = lib.gather_variant_run(v, *(p.data_ptr() for p in pos3), w.data_ptr(), K,
                                 mesh // cb, float(mesh / box),
                                 ext.data_ptr() if ext is not None else None,
                                 grids.data_ptr(), grids.shape[0], out.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gather variant {v}: cudaError_t {err}")
    return out


def _time_variants(lib, tag: str, pos, valid, mesh: int, box: float, cb: int,
                   kinds=("deposit", "gather"), widths=(3,)) -> dict:
    """Every variant of ``kinds`` of the layout on the slots, the gathers
    at each of D = ``widths``, each timed twice in turn."""
    import torch

    import chip_smoke as cs

    from concept_tpu_torch.grid.cuda_cells import deposit_cells_plain, gather_cells_plain

    zmajor = cb == 2
    _, K, C = pos.shape
    ext = _extents(valid)
    w = valid.to(torch.float32).contiguous()
    grids = torch.randn((max(widths), mesh, mesh, mesh), device="cuda")

    def close(got, ref):
        return bool(torch.allclose(got, ref, rtol=2e-5, atol=1e-5 * float(ref.abs().max())))

    print(f"{tag}: {K} slot rows × {C} columns {cb} mesh cells wide, {int(valid.sum())} "
          f"live, deepest column {int(ext.max())}, mesh {mesh}")
    res = {"shape": {"K": K, "C": C, "cb": cb, "live": int(valid.sum()),
                     "deepest": int(ext.max()), "mesh": mesh}}
    runs = []
    if "deposit" in kinds:
        runs.append(("deposit", lambda v, e=None: _deposit(lib, v, pos, w, mesh, box, cb, e),
                     deposit_cells_plain(pos, w, mesh, box, cb, zmajor)))
    if "gather" in kinds:
        for D in widths:
            g = grids[:D].contiguous()
            runs.append((f"gather D={D}" if widths != (3,) else "gather",
                         lambda v, e=None, g=g: _gather(lib, v, pos, w, g, mesh, box, cb, e),
                         gather_cells_plain(pos, w, g, mesh, box, cb, zmajor)))
    for kind, run, ref in runs:
        kk = kind.split()[0]
        cases = [(name, (lambda v=v: run(v, ext if _takes_ext(lib, kk, v) else None)))
                 for v, name in _variants(lib, kk, cb, zmajor)]
        built = next(v for v, name in _variants(lib, kk, cb, zmajor)
                     if name.startswith("as built"))
        cases.insert(1, ("as built, with extents", lambda: run(built, ext)))
        if kind == "deposit":
            cases.append(("split: zero the mesh only",
                          lambda: torch.zeros((mesh, mesh, mesh), device="cuda")))
        for name, fn in cases:
            got = fn()
            torch.cuda.synchronize()
            if not name.startswith("split") and not close(got, ref):
                raise SystemExit(f"{tag}: {kind} variant {name!r} disagrees with the plain "
                                 "version")
        times = {name: [] for name, _ in cases}
        for _ in range(2):
            for name, fn in cases:
                times[name].append(cs._time_ms(fn, 20))
        for name, ms in times.items():
            print(f"  {kind:10s} {name:40s} " + " ".join(f"{t:.4f}" for t in ms) + " ms")
        res[kind] = times
        del ref
    return res


def _row4_states(lib) -> dict:
    """The cells' gather on the states of its choice (module docstring)."""
    import torch

    import chip_smoke as cs

    out = {}
    gather = ("gather",)
    for cb in (8, 4):
        adapter, state = cs._realized_layout(128**3, 256, "cuda", unified_cb=cb)
        inner = adapter.inner
        K = inner._K_occ
        out[f"check_cb{cb}"] = _time_variants(lib, f"128³ / grid 256, cb {cb}",
                                              state.pos[:, :K], state.valid[:K], 256,
                                              inner.boxsize, cb, gather)
        del adapter, state
    for tag, overrides, kernels in (
            ("rungs, cb 8", [], cs.RUNG_KERNELS),
            ("rungs, cb 4", ["initial_conditions={'species':'matter','N':62**3}",
                             "potential_options=124"], cs.REACH_KERNELS)):
        outdir = tempfile.mkdtemp(prefix="cells_variants_")
        try:
            sim, state, _, _, _ = cs._run(overrides, outdir, kernels)
        finally:
            shutil.rmtree(outdir, ignore_errors=True)
        inner = sim.inner
        pos, valid, cb, _ = cs._rung_pm_slots(inner, sim._to_layout(state))
        out[f"clustered {tag}"] = _time_variants(
            lib, f"example_basic final slots, {tag}", pos, valid, inner.mesh, inner.boxsize,
            cb, gather)
        del sim, state, pos, valid
    for tag, n, mesh, lpt, widths in (("lean 384³ / grid 768", 384, 768, 1, (1, 3)),
                                      ("256³ / grid 512, 2LPT", 256, 512, 2, (3,))):
        adapter, state = cs._realized_layout(n**3, mesh, "cuda", unified_cb=8, lpt_order=lpt)
        inner = adapter.inner
        K = inner._K_occ
        out[tag] = _time_variants(lib, tag, state.pos[:, :K], state.valid[:K], mesh,
                                  inner.boxsize, 8, gather, widths)
        if n == 256:  # shallow columns, as at the start of a run
            for k in (16, 24):
                out[f"{tag}, first {k} rows"] = _time_variants(
                    lib, f"{tag}, its first {k} rows", state.pos[:, :k].contiguous(),
                    state.valid[:k], mesh, inner.boxsize, 8, gather)
        del adapter, state
        torch.cuda.empty_cache()
    return out


def _check_states(lib) -> dict:
    """The table's shapes: 128³ / grid 256 in cells of 8 and 4 mesh cells
    and in the global stepper's blocks."""
    import chip_smoke as cs

    out = {}
    for cb in (8, 4):
        adapter, state = cs._realized_layout(128**3, 256, "cuda", unified_cb=cb)
        inner = adapter.inner
        K = inner._K_occ
        out[f"cells_cb{cb}"] = _time_variants(lib, f"128³ / grid 256, cb {cb}",
                                              state.pos[:, :K], state.valid[:K], 256,
                                              inner.boxsize, cb)
        del adapter, state
    sim, flat = cs._global_sim(128**3, 256, "cuda")
    pos, valid, _ = cs._global_pm_slots(sim, flat.pos)
    out["blocks"] = _time_variants(lib, "128³ / grid 256, global blocks", pos, valid, 256,
                                   sim.config.boxsize, 2)
    return out


def _clustered_states(lib) -> dict:
    """The final slots of example_basic's runs and of the bucket stepper's
    sustained run."""
    import chip_smoke as cs

    out = {}
    for tag, overrides, kernels in (
            ("rungs, cb 8", [], cs.RUNG_KERNELS),
            ("rungs, cb 4", ["initial_conditions={'species':'matter','N':62**3}",
                             "potential_options=124"], cs.REACH_KERNELS),
            ("rungs, tight", ["initial_conditions={'species':'matter','N':63**3}",
                              "potential_options=126"], cs.TIGHT_KERNELS),
            ("global", ["N_rungs=1"], cs.GLOBAL_KERNELS)):
        outdir = tempfile.mkdtemp(prefix="cells_variants_")
        try:
            sim, state, _, _, _ = cs._run(overrides, outdir, kernels)
        finally:
            shutil.rmtree(outdir, ignore_errors=True)
        if tag == "global":
            pos, valid, _ = cs._global_pm_slots(sim, state.pos)
            mesh, box, cb = sim.config.potential_gridsize, sim.config.boxsize, 2
        else:
            inner = sim.inner
            pos, valid, cb, _ = cs._rung_pm_slots(inner, sim._to_layout(state))
            mesh, box = inner.mesh, inner.boxsize
        out[tag] = _time_variants(lib, f"example_basic final slots, {tag}", pos, valid,
                                  mesh, box, cb)
        del sim, state, pos, valid
    state, box = _sustained_state()
    out["bucket sustained"] = _time_variants(lib, "bucket sustained 256³ final slots",
                                             state.pos, state.valid, 256, box, 2)
    return out


def _sustained_state():
    """chip_smoke's bucket_sustained final state: (BucketState, box)."""
    import torch

    import chip_smoke as cs
    from concept_tpu_torch.bucketsim import BucketSimulation
    from concept_tpu_torch.ic import realize_particles
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import build_components, build_cosmology

    n = 256
    cfg = load_params(cs.PARAM, overrides=[
        f"initial_conditions={{'species':'matter','N':{n}**3}}", f"boxsize={n}*Mpc"])
    _, consts, bg, lin = build_cosmology(cfg)
    spec, _ = build_components(cfg, bg, consts)[0]
    sim = BucketSimulation(n, cfg.boxsize, spec.mass, consts.G_Newton, bg=bg, capacity=16)
    st0 = realize_particles(lin, spec, cfg.boxsize, 0.02, seed=0, lpt_order=1, device="cuda")
    state = sim.init_state(st0.pos, st0.mom)
    del st0
    state = sim.evolve(state, float(bg.t_of_a_np(0.02)), float(bg.t_of_a_np(0.12)))
    state = sim.maybe_rebucket(state)
    torch.cuda.synchronize()
    return state, cfg.boxsize


def _flagship(lib, n: int = 512) -> dict:
    """bench.py's flagship lattice: the variants on its slots, then its
    bucket step with the first design's kernels and as built, in turns,
    each split by kernel."""
    import torch

    import chip_smoke as cs
    from concept_tpu_torch import bucketsim
    from concept_tpu_torch.bucketsim import BucketSimulation
    from concept_tpu_torch.components import periodic_wrap

    box, N = 512.0, n**3
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    lin = (torch.arange(n, device=dev, dtype=torch.float32) + 0.5) * (box / n)
    axes = (lin[:, None, None], lin[None, :, None], lin[None, None, :])
    pos = tuple(periodic_wrap(ax.expand(n, n, n).reshape(-1) + 0.3 * box / n * (
        2 * torch.rand(N, generator=gen, device=dev) - 1), box) for ax in axes)
    mom = tuple(torch.zeros(N, device=dev) for _ in range(3))
    sim = BucketSimulation(n, box, 2.0, 1.0, capacity=8)
    state = sim.init_state(pos, mom)
    del pos, mom
    out = {"variants": _time_variants(lib, f"flagship {n}³ lattice, grid {n}", state.pos,
                                      state.valid, n, box, 2)}

    # the step with the first design's kernels (variant "before") or as built
    def kernels(name):
        vd = next(v for v, m in _variants(lib, "deposit", 2, True) if m.startswith(name))
        vg = next(v for v, m in _variants(lib, "gather", 2, True) if m.startswith(name))
        return (lambda px, py, pz, w, mesh, box: _deposit(lib, vd, (px, py, pz), w, mesh,
                                                          box, 2),
                lambda px, py, pz, w, grids, mesh, box: _gather(lib, vg, (px, py, pz), w,
                                                                grids, mesh, box, 2))

    groups = (("deposit_blocks", ("deposit_tile_kernel", "deposit_slots_kernel")),
              ("gather_blocks", ("gather_tile_kernel", "gather_cells_kernel")),
              ("cuFFT", ("fft", "FFT")))
    built = (bucketsim.deposit_blocks, bucketsim.gather_blocks)
    steps = {}
    try:
        for name in ("before", "as built", "as built", "before"):
            bucketsim.deposit_blocks, bucketsim.gather_blocks = (
                kernels(name) if name == "before" else built)
            state, _ = sim.step(state, 1e-3, 1e-3)
            state, dt, _ = cs._timed_steps(sim, state, 1e-3, 1e-3, 5, rebucket=False)
            print(f"  flagship step, kernels {name}: {1e3 * dt:.2f} ms")
            split = cs._step_split(sim, state, 3, groups)
            steps.setdefault(name, []).append({"ms_per_step": 1e3 * dt,
                                               "device_ms_by_group": split})
    finally:
        bucketsim.deposit_blocks, bucketsim.gather_blocks = built
    out["step"] = steps
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--clustered", action="store_true")
    p.add_argument("--flagship", action="store_true")
    p.add_argument("--row4", action="store_true",
                   help="the cells' gather alone, on the states of its choice")
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs

    print(cs._nvidia_smi())
    lib = _build()
    torch.manual_seed(0)
    if args.row4:
        out = {"card": cs._nvidia_smi(), "row4": _row4_states(lib)}
    else:
        out = {"card": cs._nvidia_smi(), "check": _check_states(lib)}
    if args.clustered:
        out["clustered"] = _clustered_states(lib)
    if args.flagship:
        out["flagship"] = _flagship(lib)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
