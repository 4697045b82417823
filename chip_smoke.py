"""Smoke run of the PyTorch/CUDA port (concept_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Phases, each of which fails loudly:

1. Build every CUDA kernel from ``concept_tpu_torch/csrc`` (one nvcc per
   source, all started together) and print the build time.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes of a realized 128³-particle state on the mesh-256 cell layout:
   the pair sweep with its occupancy row bounds and without bounds, the
   CIC deposit, and the CIC gather of the three PM force components.
   Prints each kernel's error and time, the plain version's time, the
   least time the card could take (its bound) and, for the deposit and
   the gather, the time of the one PyTorch library call that does their
   work (``index_add_`` of precomputed corners, ``grid_sample``).
3. The default run, ``param/example_basic.py`` as shipped (64³ particles,
   P³M grid 128, a = 0.02 → 1), through ``load_params`` and ``run``, the
   two calls ``python -m concept_tpu_torch -p param/example_basic.py``
   makes.  Every kernel's launch count is set to 0 just before and read
   just after; each must be > 0, the deposit may have lost at most half
   a particle's mass at any base step, and the power spectrum must be
   finite.  Then the sweep kernel is held against its plain version on
   the run's final, clustered layout (deep columns).
4. The realistic size through the same calls: 256³ particles, P³M grid
   512, to an early output time that takes a few base steps.  Prints ms
   per base step, particle updates per second and peak device memory.

Before its last line it prints one JSON object ``{"kernels": [...]}`` and
the card's name and power limit as nvidia-smi reports them; the last line
is ``{"ok": true, "device": {...}}``.  Without CUDA it exits with 2 and
prints no result.
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

ROOT = os.path.dirname(os.path.abspath(__file__))
PARAM = os.path.join(ROOT, "param", "example_basic.py")

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and FP32
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# Pair-sweep operation count: the distance test of a supplier row (3 sub,
# 1 mul, 2 FMA) and the force of a pair inside the cutoff (rsqrt, the
# degree-10 Horner screening, the force factor and 3 FMA accumulations).
FLOPS_PER_TESTED_PAIR = 8
FLOPS_PER_PAIR_IN_CUTOFF = 40


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _time_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls, after a warm-up
    call, between CUDA events."""
    import torch

    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _max_rel(got, ref) -> tuple[float, float]:
    """(max |got − ref|, that over max |ref|)."""
    err = float((got - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _counters():
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep
    from concept_tpu_torch.grid.cuda_cells import deposit_cells, gather_cells

    return {"pair_sweep": pair_sweep, "deposit_cells": deposit_cells,
            "gather_cells": gather_cells}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


# --------------------------------------------------------------------- #
def build() -> dict:
    from concept_tpu_torch import _build

    t0 = time.time()
    logs = _build.build_all()
    seconds = time.time() - t0
    print(f"build: {len(logs)} CUDA sources in {seconds:.1f} s "
          f"(nvcc for sm_90a, into {os.path.relpath(_build.BUILD_DIR, ROOT)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    return {"build_s": seconds}


def _realized_layout(N: int, mesh: int, device: str):
    """A realized example_basic state at N particles on the mesh-`mesh`
    8-mesh-cell layout: (adapter, RungState)."""
    import torch

    from concept_tpu_torch.p3mrungs import RungSimulationAdapter
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import build_components, build_cosmology, softening_length
    from concept_tpu_torch.device import resolve_device
    from concept_tpu_torch.sim import SimConfig

    n = round(N ** (1 / 3))
    cfg = load_params(PARAM, overrides=[
        f"initial_conditions={{'species':'matter','N':{n}**3}}",
        f"potential_options={mesh}"])
    _, consts, bg, lin = build_cosmology(cfg)
    spec, _ = build_components(cfg, bg, consts)[0]
    dev = resolve_device(device)
    config = SimConfig(boxsize=cfg.boxsize, potential_gridsize=mesh, device=dev,
                       G=consts.G_Newton, softening=softening_length(cfg, spec, mesh),
                       softening_kernel=cfg.softening_kernel)
    adapter = RungSimulationAdapter(spec, config, bg, lin, N_rungs=cfg.N_rungs)
    flat = adapter.initial_state(cfg.a_begin, seed=0)
    return adapter, adapter._to_layout(flat)


def _pair_work(recv, sup, n, boxsize, cutoff2, soft2, rext, sext):
    """(supplier rows tested, pairs inside the cutoff, of those the pairs
    inside the spline's near field r² < (2.8ε)²) of a bounded or
    unbounded sweep on these inputs: the work its bound counts."""
    import torch

    from concept_tpu_torch.forces.cuda_shortrange import _OFFSETS, _bounds

    _, K_r, C = recv.shape
    K_s = sup.shape[1]
    dev = recv.device
    rb, sb = _bounds(rext, sext, n, K_r, K_s, dev)
    tested = 27 * int((rb * sb).sum())
    cells = torch.arange(C, device=dev)
    ci, cj, ck = cells // (n * n), (cells // n) % n, cells % n
    rows_r = torch.arange(K_r, device=dev)[:, None]
    rows_s = torch.arange(K_s, device=dev)[:, None]
    within = near = 0
    ch = max(1, (1 << 24) // (K_r * K_s))
    for c0 in range(0, C, ch):
        cols = slice(c0, min(C, c0 + ch))
        own = recv[:, :, cols][:, :, None, :]
        rmask = (rows_r < rb[cols][None])[:, None, :]
        smask = (rows_s < sb[cols][None])[None]
        for di, dj, dk in _OFFSETS:
            ids, shift = [], []
            for c, d in ((ci, di), (cj, dj), (ck, dk)):
                m = c[cols] + d
                shift.append(((m >= n).float() - (m < 0).float()) * boxsize)
                ids.append(torch.remainder(m, n))
            col = (ids[0] * n + ids[1]) * n + ids[2]
            nb = sup[:, :, col] + torch.stack(shift)[:, None, :]
            d = own - nb[:, None]
            r2 = (d * d).sum(0)
            m = (r2 < cutoff2) & (r2 > 0) & rmask & smask
            within += int(m.sum())
            near += int((m & (r2 < 7.84 * soft2)).sum())
    return tested, within, near


def _check_sweep(tag: str, pos_s, sim, bounds, reps: int, plain_reps: int) -> dict:
    """The pair sweep kernel against its plain version on the slot
    positions pos_s (3, K, C) of `sim`'s layout, with row bounds
    (rext, sext) or (None, None): errors, times and bound.  Fails on a
    disagreement beyond max|Δ|/max|ref| ≤ 1e-5."""
    from concept_tpu_torch.forces.cuda_shortrange import _bounds, pair_sweep, pair_sweep_plain
    from concept_tpu_torch.forces.shortrange import f32_square

    args = (sim.nc, sim.boxsize, sim.scale, f32_square(sim.cutoff),
            f32_square(sim.softening), sim.softening_kernel)

    def kern():
        return pair_sweep(pos_s, pos_s, *args, rext=bounds[0], sext=bounds[1])

    def plain():
        return pair_sweep_plain(pos_s, pos_s, *args, rext=bounds[0], sext=bounds[1])

    got, ref = kern(), plain()
    _sync()
    err, rel = _max_rel(got, ref)
    ok = rel <= 1e-5
    del got, ref
    ms, plain_ms = _time_ms(kern, reps), _time_ms(plain, plain_reps)
    _, K, C = pos_s.shape
    rb, sb = _bounds(*bounds, sim.nc, K, K, pos_s.device)
    tested, within, near = _pair_work(pos_s, pos_s, sim.nc, sim.boxsize, args[3],
                                      args[4], *bounds)
    flops = FLOPS_PER_TESTED_PAIR * tested + FLOPS_PER_PAIR_IN_CUTOFF * within
    nbytes = 4 * 2 * pos_s.numel() + (8 * bounds[0].numel() if bounds[0] is not None else 0)
    bound_ms = 1e3 * max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
    print(f"  pair_sweep ({tag}): max |Δ| {err:.3e}, max|Δ|/max|ref| {rel:.3e} "
          f"(tol 1e-5) {'ok' if ok else 'FAIL'}; {ms:.3f} ms, plain {plain_ms:.1f} ms, "
          f"bound {bound_ms:.3f} ms; {tested} pairs tested, {within} in the cutoff, "
          f"{near} in the spline near field; deepest receiver bound {int(rb.max())}, "
          f"supplier bound {int(sb.max())} rows")
    if not ok:
        raise SystemExit(f"pair_sweep ({tag}) disagrees with its plain version")
    return dict(
        max_abs_err=err, max_rel_err=rel, tol_rel=1e-5, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="operations" if flops / FP32_FLOPS >
        nbytes / HBM_BYTES_PER_S else "bytes", flops=flops, bytes=nbytes,
        pairs_tested=tested, pairs_in_cutoff=within, pairs_near_field=near,
        K_rows=K, max_receiver_bound=int(rb.max()), max_supplier_bound=int(sb.max()))


def _sentineled(state, K: int, sentinel: float):
    """The leading K slot rows' positions (3, K, C), invalid slots at the
    far sentinel: the sweep's input."""
    import torch

    return torch.where(state.valid[:K][None], state.pos[:, :K], sentinel).contiguous()


def _deposit_library(pos, w, mesh: int, box: float):
    """The deposit's scatter as one library call: ``index_add_`` of the 8
    CIC corner indices and weights of every depositing slot, computed
    beforehand (the call does not form them).  Returns the call."""
    import torch

    from concept_tpu_torch.grid.cuda_cells import _corners, cell_geometry

    nc = mesh // 8
    anchors, fracs, in_halo = cell_geometry(pos, slice(0, nc**3), nc, 8, mesh / box)
    q = w * in_halo
    keep = q != 0
    idx, vals = zip(*((i[keep], (wt * q)[keep]) for i, wt in _corners(anchors, fracs, mesh)))
    idx, vals = torch.cat(idx), torch.cat(vals)
    return lambda: torch.zeros(mesh**3, device=pos.device).index_add_(
        0, idx, vals).reshape(mesh, mesh, mesh)


def _gather_library(pos, wv, grids, mesh: int, box: float):
    """The gather as one library call: trilinear ``grid_sample`` (CIC
    interpolation) of the D grids, padded periodically by one cell
    beforehand, at every slot.  Returns (call, mask of the slots the
    gather kernel serves: valid and inside the cell's halo)."""
    import torch
    import torch.nn.functional as F

    from concept_tpu_torch.grid.cuda_cells import cell_geometry

    D = grids.shape[0]
    _, K, C = pos.shape
    nc = mesh // 8
    _, _, in_halo = cell_geometry(pos, slice(0, C), nc, 8, mesh / box)
    padded = F.pad(grids[None], (1, 1, 1, 1, 1, 1), mode="circular")
    # padded mesh index of the cell-centred CIC, normalised so that
    # -1 and 1 are the padded grid's first and last points; grid_sample
    # takes (x, y, z) = (last, middle, first) axis
    u = (pos * (mesh / box) + 0.5) * (2.0 / (mesh + 1)) - 1.0
    coords = u.flip(0).permute(1, 2, 0).reshape(1, 1, 1, K * C, 3).contiguous()
    mask = (wv != 0) & in_halo

    def call():
        return F.grid_sample(padded, coords, mode="bilinear", padding_mode="border",
                             align_corners=True).reshape(D, K, C)

    return call, mask


def check_kernels(N: int = 128**3, mesh: int = 256, device: str = "cuda") -> dict:
    """Each kernel against its plain version at the shapes of a realized
    N-particle state on the mesh-`mesh` layout."""
    import torch

    from concept_tpu_torch.forces.pm import gravity_potential_slab
    from concept_tpu_torch.forces.shortrange import SENTINEL
    from concept_tpu_torch.grid import fourier
    from concept_tpu_torch.grid.cuda_cells import (
        deposit_cells, deposit_cells_plain, gather_cells, gather_cells_plain,
    )
    from concept_tpu_torch.grid.fft import irfft3, rfft3

    adapter, state = _realized_layout(N, mesh, device)
    sim = adapter.inner
    K = sim._K_occ
    nc, box = sim.nc, sim.boxsize
    pos = state.pos[:, :K]
    valid = state.valid[:K]
    pos_s = _sentineled(state, K, SENTINEL * box)
    ext = sim._ext_occ
    print(f"kernels vs plain: {N} particles, mesh {mesh}, {nc}³ cells, "
          f"{K} slot rows (capacity {sim.capacity})")
    out = {"shape": {"N": N, "mesh": mesh, "nc": nc, "K_rows": K}}

    # A: the pair sweep, with the occupancy bounds and without bounds
    for tag, bounds in (("bounded", (ext, ext)), ("unbounded", (None, None))):
        out[f"pair_sweep_{tag}"] = _check_sweep(tag, pos_s, sim, bounds, 10, 2)

    # B: the CIC deposit of w = mass·valid
    w = (valid.to(pos.dtype) * sim.mass).contiguous()
    got = deposit_cells(pos, w, mesh, box)
    ref = deposit_cells_plain(pos, w, mesh, box)
    _sync()
    err, rel = _max_rel(got, ref)
    ok = bool(torch.allclose(got, ref, rtol=2e-5, atol=1e-5 * float(ref.abs().max())))
    ms = _time_ms(lambda: deposit_cells(pos, w, mesh, box), 20)
    plain_ms = _time_ms(lambda: deposit_cells_plain(pos, w, mesh, box), 2)
    nbytes = 4 * (pos.numel() + w.numel() + mesh**3)
    n_valid = int(valid.sum())
    flops = 60 * n_valid  # geometry (~12) + 8 corners × (weight, product, add)
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
    library = _deposit_library(pos, w, mesh, box)
    _, lib_rel = _max_rel(library(), ref)
    library_ms = _time_ms(library, 20)
    del library
    out["deposit_cells"] = dict(
        max_abs_err=err, max_rel_err=rel, tol="rtol 2e-5, atol 1e-5·max|ref|", ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", bytes=nbytes, flops=flops,
        mass_sum=float(got.sum()), mass_expected=n_valid * sim.mass,
        library_ms=library_ms, library="index_add_ of precomputed corners",
        library_max_rel_err=lib_rel)
    print(f"  deposit_cells: max |Δ| {err:.3e} ({rel:.3e} of max) {'ok' if ok else 'FAIL'}; "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.3f} ms; library "
          f"(index_add_ of precomputed corners) {library_ms:.3f} ms, {lib_rel:.1e} of max off")
    if not ok:
        raise SystemExit("deposit_cells disagrees with its plain version")

    # C: the CIC gather of the three PM force components
    slab = rfft3(got / (box / mesh) ** 3)
    phi = gravity_potential_slab(slab, mesh, box, sim.G, deconv_order=4,
                                 longrange_scale=sim.scale)
    grads = torch.stack([irfft3(fourier.fourier_diff(phi, mesh, box, d), mesh)
                         for d in range(3)]).contiguous()
    del slab, phi
    wv = valid.to(pos.dtype).contiguous()
    got = gather_cells(pos, wv, grads, mesh, box)
    ref = gather_cells_plain(pos, wv, grads, mesh, box)
    _sync()
    err, rel = _max_rel(got, ref)
    ok = bool(torch.allclose(got, ref, rtol=2e-5, atol=1e-5 * float(ref.abs().max())))
    ms = _time_ms(lambda: gather_cells(pos, wv, grads, mesh, box), 20)
    plain_ms = _time_ms(lambda: gather_cells_plain(pos, wv, grads, mesh, box), 2)
    nbytes = 4 * (pos.numel() + wv.numel() + grads.numel() + got.numel())
    flops = (12 + 3 * 8 * 3) * n_valid
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
    library, mask = _gather_library(pos, wv, grads, mesh, box)
    _, lib_rel = _max_rel(library() * mask, ref)
    library_ms = _time_ms(library, 20)
    del library, mask
    out["gather_cells"] = dict(
        max_abs_err=err, max_rel_err=rel, tol="rtol 2e-5, atol 1e-5·max|ref|", ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", bytes=nbytes, flops=flops,
        library_ms=library_ms, library="grid_sample on the periodically padded grids",
        library_max_rel_err=lib_rel)
    print(f"  gather_cells (D = 3): max |Δ| {err:.3e} ({rel:.3e} of max) "
          f"{'ok' if ok else 'FAIL'}; {ms:.3f} ms, plain {plain_ms:.1f} ms, "
          f"bound {bound_ms:.3f} ms; library (grid_sample on padded grids) "
          f"{library_ms:.3f} ms, {lib_rel:.1e} of max off")
    if not ok:
        raise SystemExit("gather_cells disagrees with its plain version")
    return out


def _run(overrides: list, outdir: str, device: str = "cuda"):
    """load_params + run on the card, as the CLI does; returns
    (sim, final state, a, launch counts, host seconds).  Fails when the
    deposit lost more than half a particle's mass at any base step."""
    import torch

    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    cfg = load_params(PARAM, overrides=overrides + [f"output_dirs='{outdir}'"])
    _reset_counts()
    t0 = time.time()
    sim, state, a = run(cfg, device=device)
    _sync()
    seconds = time.time() - t0
    counts = _read_counts()
    files = [f for f in os.listdir(outdir) if f.startswith("powerspec")]
    if not files:
        raise SystemExit(f"no power spectrum written to {outdir}")
    import numpy as np

    data = np.loadtxt(os.path.join(outdir, sorted(files)[-1]))
    if data.ndim != 2 or not np.all(np.isfinite(data[:, :3])):
        raise SystemExit("the power spectrum is not finite")
    if not torch.isfinite(state.pos).all() or not torch.isfinite(state.mom).all():
        raise SystemExit("the final state is not finite")
    stats = sim.inner.stats
    if stats.get("pm_mass_warnings", 0):
        raise SystemExit(f"the PM deposit lost mass {stats['pm_mass_warnings']} times")
    if stats["pm_mass_deficit_max"] > 0.5:
        raise SystemExit(f"the PM deposit lost {stats['pm_mass_deficit_max']:.3g} "
                         "particle masses at a base step")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise SystemExit(f"kernels never launched on this path: {missing}")
    return sim, state, a, counts, seconds


def main_path() -> dict:
    """example_basic as shipped; then the sweep kernel against its plain
    version on the run's final, clustered layout, whose deep columns take
    the kernel's extra receiver passes and supplier tiles."""
    from concept_tpu_torch.forces.shortrange import SENTINEL

    outdir = tempfile.mkdtemp(prefix="chip_smoke_main_")
    try:
        sim, state, a, counts, seconds = _run([], outdir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    st = sim.inner.stats
    steps = sim.hysteresis.get("step_count", 0)
    print(f"main path (example_basic, 64³, grid 128, a 0.02 → {a:.4g}): "
          f"{steps} base steps, {st['substeps']} substeps, max rung {st['max_rung']}, "
          f"wall {seconds:.1f} s (evolution {sim.timings['evolve_s']:.1f} s), "
          f"largest deposit deficit {st['pm_mass_deficit_max']:.3g} particle masses, "
          f"launches {counts}")
    inner = sim.inner
    layout = sim._to_layout(state)
    K = inner._K_occ
    pos_s = _sentineled(layout, K, SENTINEL * inner.boxsize)
    print(f"kernel vs plain on the final layout: {inner.nc}³ cells, {K} slot rows")
    clustered = _check_sweep("clustered, bounded", pos_s, inner,
                             (inner._ext_occ, inner._ext_occ), 10, 1)
    return {"a_end": a, "base_steps": steps, "substeps": st["substeps"],
            "max_rung": st["max_rung"], "wall_s": seconds,
            "evolve_s": sim.timings["evolve_s"], "launches": counts,
            "pm_mass_deficit_max": st["pm_mass_deficit_max"],
            "pair_sweep_clustered": clustered}


def realistic(a_end: float = 0.023) -> dict:
    import torch

    torch.cuda.reset_peak_memory_stats()
    outdir = tempfile.mkdtemp(prefix="chip_smoke_big_")
    try:
        sim, _, a, counts, seconds = _run([
            "initial_conditions={'species':'matter','N':256**3}",
            "potential_options=512",
            f"output_times={{'powerspec': [{a_end}]}}"], outdir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    steps = sim.hysteresis.get("step_count", 0)
    if steps < 3:
        raise SystemExit(f"the realistic run took {steps} base steps (< 3)")
    N = sim.spec.N
    ev = sim.timings["evolve_s"]
    peak = torch.cuda.max_memory_allocated()
    st = sim.inner.stats
    print(f"realistic (256³, grid 512, a 0.02 → {a:.4g}): {steps} base steps, "
          f"{st['substeps']} substeps, {1e3 * ev / steps:.1f} ms per base step, "
          f"{N * steps / ev:.4g} particle updates/s, peak device memory "
          f"{peak / 2**30:.2f} GiB, realization {sim.timings['realize_s']:.1f} s, "
          f"largest deposit deficit {st['pm_mass_deficit_max']:.3g} particle masses")
    print("realistic-size launches: " + ", ".join(f"{k}={v}" for k, v in counts.items()))
    return {"a_end": a, "base_steps": steps, "substeps": st["substeps"],
            "max_rung": st["max_rung"], "evolve_s": ev, "ms_per_base_step": 1e3 * ev / steps,
            "particle_updates_per_s": N * steps / ev, "peak_bytes": peak,
            "realize_s": sim.timings["realize_s"], "launches": counts,
            "pm_mass_deficit_max": st["pm_mass_deficit_max"]}


KERNELS = (
    ("pair_sweep", "pair_sweep_bounded", "concept_tpu_torch/csrc/pair_sweep.cu",
     "concept_tpu/forces/pallas_shortrange.py:287"),
    ("deposit_cells", "deposit_cells", "concept_tpu_torch/csrc/cells.cu",
     "concept_tpu/grid/pallas_cells.py:162"),
    ("gather_cells", "gather_cells", "concept_tpu_torch/csrc/cells.cu",
     "concept_tpu/grid/pallas_cells.py:206"),
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", help="also write every measured number to this JSON file")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke run needs a card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _nvidia_smi()
    results = {"nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda}
    results.update(build())
    results["check"] = check_kernels()
    results["main_path"] = main_path()
    results["realistic"] = realistic()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    chk = results["check"]
    kernels = []
    for name, key, source, replaces in KERNELS:
        c = chk[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": results["main_path"]["launches"][name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c.get("library_ms"),
        })
    unb = chk["pair_sweep_unbounded"]
    kernels[0].update(unbounded_max_abs_err=unb["max_abs_err"], unbounded_ms=unb["ms"],
                      unbounded_plain_ms=unb["plain_ms"], unbounded_bound_ms=unb["bound_ms"])
    clu = results["main_path"]["pair_sweep_clustered"]
    kernels[0].update(clustered_max_abs_err=clu["max_abs_err"], clustered_ms=clu["ms"],
                      clustered_plain_ms=clu["plain_ms"], clustered_bound_ms=clu["bound_ms"])
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
