"""Smoke run of the PyTorch/CUDA port (concept_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Phases, each of which fails loudly:

1. Build every CUDA kernel from ``concept_tpu_torch/csrc`` (one nvcc per
   source, all started together) and print the build time.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes of a realized 128³-particle state on the mesh-256 cell layout:
   the pair sweep with its per-column occupancy row bounds and without
   bounds, the CIC deposit, and the CIC gather of the three PM force
   components.  Prints each kernel's error and time (for the sweeps also
   the row pairs the launch visits beside the pair tests the slots
   need), the plain version's time, the
   least time the card could take (its bound) and, for the deposit and
   the gather, the time of the one PyTorch library call that does their
   work (``index_add_`` of precomputed corners, ``grid_sample``).
3. The default run, ``param/example_basic.py`` as shipped (64³ particles,
   P³M grid 128, a = 0.02 → 1), through ``load_params`` and ``run``, the
   two calls ``python -m concept_tpu_torch -p param/example_basic.py``
   makes.  Every kernel's launch count is set to 0 just before and read
   just after; each must be > 0, the deposit may have lost at most half
   a particle's mass at any base step, and the power spectrum must be
   finite.  Then the sweep kernel, the deposit and the gather are held
   against their plain versions on the run's final, clustered layout
   (deep columns), the two PM kernels with their library calls.
4. The realistic size through the same calls: 256³ particles, P³M grid
   512, to an early output time that takes a few base steps.  Prints ms
   per base step, particle updates per second and peak device memory.

Then the same for the global stepper (``N_rungs = 1``):

2b. Each of its kernels against its plain version at the shapes of a
    realized 128³ state on grid 256: the global pair sweep (row 6) on the
    45³-cell slot layout (receivers = suppliers, with the layout's
    occupancy bounds, as the stepper launches it), and the CIC
    deposit and gather (D = 3) on the 128³ blocks of 2³ mesh cells, with
    the library calls as in 2.
3b. ``param/example_basic.py`` with ``-c "N_rungs=1"`` (64³, grid 128,
    a = 0.02 → 1) through ``load_params`` and ``run``: it must launch the
    sweep and both block kernels and neither cell-layout PM kernel,
    exceed no budget, lose at most half a particle's mass in any deposit
    and write a finite spectrum.  The same run again under torch.profiler
    gives the device time by group of kernels; then the sweep, and the
    block deposit and gather on the PM blocks, are held against their
    plain versions on the counted run's final, clustered state.
4b. 256³ particles on grid 512 with ``N_rungs = 1`` for at least 3 global
    steps.

Then the rung stepper's two other layouts:

2c. The reach-2 sweep (117 kept offsets), one-sided (receivers at the
    negative sentinel) with per-column occupancy bounds, as the stepper
    launches it, and without, and two-sided (``sweep_reach``, no
    bounds), and the cell deposit and gather at cb = 4, each against its
    plain version at the shapes of a realized 128³ state on mesh 256 with
    ``unified_cb = 4`` (64³ cells), with the library calls as in 2.
3c. ``param/example_basic.py`` at 62³ particles on grid 124 (the
    4-mesh-cell layout), a = 0.02 → 1: it must launch the reach sweep and
    the cell deposit and gather and no other kernel; then the reach sweep
    is held against its plain version on the run's final slots, with
    their per-column bounds, and the cell deposit and gather (cb = 4).
3d. The same at 63³ on grid 126 (the tight layout, 19³ cells): the
    bounded ±1 sweep and the block deposit and gather, the latter two
    held on the blocks the final slots fill.
4c, 4d. 250³ particles on grid 500 (4-mesh-cell layout) and 255³ on grid
    510 (tight layout) for at least 3 base steps each.

Then PM-only gravity (``select_forces = {'all': {'gravity': 'pm'}}``):

2e. The PM-only block kernels (rows 10 and 11: deposit and gather from
    block-sorted particles) against their plain versions at the shapes of
    a realized 256³ state on PM grid 256 (128³ blocks): the gather at
    D = 3, as the kick gathers its three gradient components in one
    launch, and at D = 1, with bounds and library calls as in 2.
3e. ``param/example_basic.py`` with PM gravity (64³, grid 128, a = 0.02 →
    1) through ``load_params`` and ``run`` with the default
    ``deposit_method``: it must launch rows 10 and 11 and no other kernel,
    lose at most half a particle's mass in any deposit and write a finite
    spectrum.  Then rows 10 and 11 are held against their plain versions
    on the run's final state, sorted as the kick sorts it (deep blocks).
    Where its time goes is scripts/torch_profile_main_path.py's work.
4e. 512³ particles on PM grid 512 through ``run`` for at least 3 steps,
    then the device memory of one kick on its final state, piece by
    piece (block sort, deposit, potential and gradients, gather), and of
    the power spectrum its output writes.
4f. ``BucketSimulation``, the persistent-bucket PM stepper: bench.py's
    flagship shape (a 512³ lattice with a 0.3-cell jitter, capacity 8, 5
    timed steps after a warm-up) and its sustained shape (256³ with 2LPT
    initial conditions evolved to a = 0.12, then one rebucket cadence of
    16 steps and a rebucket).  Each launches only rows 8 and 9; the
    flagship's device time a step is split by kernel (rows 8, 9, cuFFT,
    the rest; torch.profiler over 3 steps); rows 8 and 9 are then held
    against their plain versions on the sustained run's rebucketed final
    slots.

Then the persistent P³M stepper, global-step rungs, the lean PM kick and
the LPT initial conditions:

5a. ``P3MSimulation`` at bench.py's persistent shape (bench_p3m_persistent)
    in example_basic's cosmology: 256³ particles on grid 512, 2LPT
    initial conditions at a = 0.02 evolved to a = 0.025, one
    ``autotune_margin`` over its three candidates, 5 timed steps; only
    rows 6, 8 and 9 may launch.  Then rows 6, 8 and 9 against their plain
    versions on the final slots.
5b. ``rungs.evolve_rungs_p3m`` on example_basic (64³, grid 128) from 2LPT
    initial conditions, base step by base step until a rung above 0 and
    two steps more: the long range through rows 10-11,
    the rungs' probe through row 6, the substeps through
    ``shortrange_momentum_updates_on_subset`` (row 2); then row 2 against
    its plain version on the last substep's receivers.
5c. One memory-lean PM kick (rows 3 and 4, stencil gradients one at a
    time) as the rung stepper's dispatch takes it at grid 768, and one
    spectral kick, on a realized 384³ state on the 8-mesh-cell layout:
    peak device memory of each and their rms difference; the lean kick
    again through the plain deposit and gather (within 2e-5 of the
    largest change), and rows 3-4 against their plain versions there.
5d. The 2LPT and 3LPT realizations at 256³ (time, peak memory), and
    ``param/example_pm_quick.py`` (2LPT) to a = 1 with its outputs cut to
    the power spectra, through ``load_params`` and ``run``.

Then the run's files, at the realistic size of the main path:

6.  ``files``: 256³ particles of example_basic from 2LPT at a = 0.02,
    written as GADGET-2 (format 2, float32, two files; also as
    CONCEPT-HDF5 where h5py imports) and read back exactly (seconds,
    GB/s, peak host and device memory); ``run`` from that file on grid 512
    to a = 0.023 with a snapshot, power spectrum and bispectrum dump,
    twice (the atomics' noise floor); the same run with SIGTERM raised
    after base step 2, which must exit with 143 and leave an autosave, and
    its resume, which must end within max(10 × the floor, 1e-5) of the box
    of the uninterrupted run; ``-u info`` and ``-u powerspec`` through
    ``cli.main`` on the card; the bispectrum at grid 512 alone.  Every run
    launches rows 1, 3 and 4 only.

Then float64 (``enable_float64 = True``: every kernel's double
instantiation) and PP gravity:

7a. Rows 1-11 in double against their float64 plain versions at the
    shapes of 2, 2b, 2c and 2e (states realized in float64), within 1e-10
    of the largest plain value; bounds at the FP64 rate (34 TFLOP/s) and
    with 8-byte values; the library calls in float64.
7b. example_basic in float64 through ``load_params`` and ``run`` with
    rungs, with ``N_rungs = 1``, with PM gravity and at 62³ / grid 124:
    each launches its rows in double and no float kernel, passes the
    checks of 3 and writes a finite spectrum, printed beside the float32
    run's evolution seconds; then the float64 and the float32 rung run
    with the 'distributed' noise (one draw in both dtypes): their spectra's
    largest relative difference below a quarter of the Nyquist frequency.
    Then global rungs (5b) in float64, and 256³ / grid 512 for 5 base
    steps (ms per base step, peak memory) in float64.
7c. PP gravity (``select_forces = {'all': {'gravity': 'pp'}}``) at
    example_basic's box and cosmology with 32³ particles in float64 to an
    early output time (no kernel: PP is plain PyTorch); one PP kick timed
    (pairs a second); one P³M kick (rows 6, 8, 9 in double) against one
    PP + Ewald kick on a realized 32³ state and on a clustered one (a 32³
    float64 rung run to a = 1), rms under 0.05.

Then the rest of the cosmology:

8.  ``nu``: ``param/example_nonlinnu.py``'s matter component as the param
    gives it (80³ particles, grid 40, Σmν = 0.5 eV, 8 rungs) with the
    internal Einstein-Boltzmann tables at the light settings of
    tests/test_cli_e2e.py (8 modes).  The tables are solved on the host
    into an empty cache directory through the process pool (seconds and
    host CPUs printed), built again from that cache (read and gauge
    transform timed), and the run goes from them on the card through
    ``load_params`` and ``run``, a = 0.02 → ``NU_A_END``: it must launch
    rows 1, 3 and 4 only and pass the checks of 3.  Prints σ8 of the
    tables, the realized spectrum at a = 0.02 over the tables' linear
    one in the lowest bins (their weighted mean must lie within a factor
    of 2), and the ms per base step beside the same run without the
    neutrinos on the analytic backend (EH).

Then several components and fluids:

9.  ``multi``: three runs through ``load_params`` and ``run`` at the
    widths of their parameter files, each launching its rows only and
    passing the checks of 3 (for every component and fluid).
    (a) ``param/example_nonlinnu.py`` whole (80³ matter on P³M grid 40,
    the ν fluid on grid 40 at Boltzmann order 1, KT), on the tables of
    phase 8's cache, for ``MULTI_STEPS`` global steps (the ν Courant limit
    sets Δt; the run's end is planned on the host, as is the count of
    steps to a = 1): row 6 only; ms a step, then ``SPLIT_STEPS`` more
    steps split by part (the PM kick, the row-6 sweep, the KT drift, the
    host scalars; a sync between parts); the ν fluid's Σϱ within 1e-5;
    row 6 against its plain version on the final slots (the first 64 rows
    of each column: ~1500 a column), in float within twice the float32
    plain version's own distance from float64 there, and in double.
    (b) example_basic with cold dark matter and baryons, 64³ each, grid
    128, to a = 1: rows 6 and 2 only; the spectra of each and of the
    pair; rows 6 and 2 against their plain versions on the final state at
    the run's softening 0 ('plummer'), and row 6 with 'spline' at
    softening 0, in float and in double.  (c)
    ``param/example_relativistic.py`` whole (128³ matter, the linear
    radiation on grid 128 at order −1, re-realized at every kick) to
    a = 0.02: row 6 only; the backend and any Einstein-Boltzmann solve's
    seconds; the matter spectrum over that of the same matter without
    the radiation (global steps, unfixed amplitudes) below k_Nyquist/4.

Then the renders and the first part of multi-GPU, on the 256³ / grid 512
state of phase 4 (example_basic realized at a = 0.02):

10. ``render``: the projected density at grid 512 on the card against
    the same function on a CPU copy of the positions, and the 3D render's
    per-particle density of 1M particles against the JAX package's numpy
    arithmetic (seconds and peak memory of each); then the files that
    matplotlib and h5py allow here, each made or named as not made.
11. ``parallel``: a world of one ``nccl`` rank: sort_to_slabs, the halo
    deposit, the slab FFT, a PM and a P³M step through
    ``Simulation(dist=...)`` against one device's (the P³M step launches
    row 6 only), the ms of the PM kick over the ranks beside one
    device's, and ``-n 2`` raising ValueError on one card.
12. ``parallel_rungs``: the rung stepper over ranks on a world of one
    ``nccl`` rank: rows 1, 3 and 4 over the rank's planes at the realized
    256³ / grid 512 layout (the sweep at nx = 66 between the neighbour
    planes, the cells on the slab with a halo row a side) against their
    plain versions and the launches on the whole layout; 3 base steps of
    ``P3MRungSimulation(dist=...)`` against one device's (mean |Δx|/box
    < 1e-5, momenta 1e-5 of the largest; ms a base step and peak memory
    both ways; rows 1, 3, 4 launched); the same at 62³ / grid 124 (the
    4-mesh-cell layout: row 5 at nx = nc + 4 against its plain version
    and, its planes' rows bit for bit, the whole launch; rows 5, 3, 4)
    and at 63³ / grid 126 (the tight layout: row 1 over planes, rows 8
    and 9 over the PM blocks' planes against their plain versions and
    the whole mesh's; rows 1, 8, 9); example_basic 64³ / grid 128 from
    a = 0.02 to 0.1 through ``RungSimulationAdapter(dist=...)``, its
    spectrum within 1e-4 of one device's; ``-n 2`` raising ValueError.
    The base steps start from the realization over the ranks.
13. ``parallel_realize``: the realization over ranks on a world of one
    ``nccl`` rank: 256³ by 2LPT and 3LPT through
    ``RungSimulationAdapter(dist=...).initial_state`` against one
    device's, per id (positions within 1e-5 of the largest displacement
    plus a float32 position's rounding, momenta within 1e-5 of the
    largest, every id once); seconds and peak device memory both ways.

Then several components and fluids over ranks:

14. ``parallel_multi``: on a world of one ``nccl`` rank,
    ``MultiSimulation(dist=...)`` (each rank holding its particle shards
    and its x-rows of every fluid grid) from the realization over the
    rank: (a) example_nonlinnu at its parameter file's width for
    ``MULTI_STEPS`` steps against one device's from the same state
    (positions, momenta, the ν fluid's ϱ and J, Σϱ_ν; row 6 only; ms a
    step by part and peak memory both ways); (b) CDM + baryons, 64³
    each, grid 128, for a few steps (rows 6 and 2 only, each held per
    receiver against its plain version on the rank's receivers, in float
    and in double); (c) example_relativistic at 128³ for 3 steps, the
    radiation re-realized on the rank's rows, against one device's; (d)
    ``-n 2`` raising ValueError on one card.

Then the 2D pencils of ``-n AxB``:

15. ``parallel_pencils``: on a world of one ``nccl`` rank as a 1 × 1
    mesh of pencils (their groups and transposes run), from one realized
    256³ state on grid 512: (a) the pencil FFT round trip against
    ``rfftn``; (b) one global PM kick and one global P³M kick through
    ``Simulation`` on the pencils against one device's (momenta within
    1e-5 of the largest; ms a kick and peak memory both ways; rows 10
    and 11, and row 6 for P³M, launched and no other kernel); (c) rows
    10, 11 and 6 held against their plain versions on the kick's block
    sort and slots; (d) ``-n 2x1`` raising ValueError on one card.

Wherever rows 6 and 2 (the global kernel) are held against their plain
version, they are also held bit for bit against the unbounded launch of
row 1's kernel (what they launched before they had a kernel of their
own) on the rows below the receiver bounds, that launch is timed beside
them, and the row pairs the launch visits are printed beside the pair
tests the slots need.

Before its last line it prints one JSON object ``{"kernels": [...]}`` and
the card's name and power limit as nvidia-smi reports them (each kernel
with its double instantiation's numbers under ``f64_*``); the last line
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
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
PARAM = os.path.join(ROOT, "param", "example_basic.py")

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and FP32
# and FP64 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12
# Pair-sweep operation count: the distance test of a supplier row (3 sub,
# 1 mul, 2 FMA) and the force of a pair inside the cutoff (rsqrt, the
# degree-10 Horner screening, the force factor and 3 FMA accumulations).
# The double kernel evaluates the exact screening instead: erfc (~25
# operations in CUDA's libdevice) and exp (~15) besides the rest.
FLOPS_PER_TESTED_PAIR = 8
FLOPS_PER_PAIR_IN_CUTOFF = 40
FLOPS_PER_PAIR_IN_CUTOFF_F64 = 80
# The float64 kernels' check: max |Δ| within 1e-10 of the largest plain
# value (atomics and summation order in double).
F64_TOL = 1e-10


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


def _once_ms(fn):
    """(fn(), its device milliseconds): one call between CUDA events, for
    the plain versions that take seconds."""
    import torch

    _sync()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def _max_rel(got, ref) -> tuple[float, float]:
    """(max |got − ref|, that over max |ref|)."""
    err = float((got - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def _max_rel_recv(got, ref) -> float:
    """max over the receivers i of |Δ_i| / max(|ref_i|, median |ref|), with
    |·| the norm of a receiver's force (the leading axis of (3, K, C)) and
    the median over the receivers that feel one: each force judged on its
    own scale, the weak ones on the median force's.  (At softening 0 one
    near pair can make max |ref| exceed the ordinary forces by ten orders
    of magnitude, and max|Δ|/max|ref| then sees nothing else.)"""
    d = (got - ref).double().norm(dim=0)
    r = ref.double().norm(dim=0)
    live = r[r > 0]
    med = float(live.median()) if live.numel() else 1e-300
    return float((d / r.clamp(min=med)).max())


def _float32_floor(recv, sup, args, rext=None) -> float:
    """The float32 plain sweep's own per-receiver distance (_max_rel_recv)
    from the float64 plain sweep on the same slots and arguments: what
    float32 sums alone leave on these forces."""
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep_plain

    p32 = pair_sweep_plain(recv, sup, *args, rext=rext)
    p64 = pair_sweep_plain(recv.double(), sup.double(), *args, rext=rext)
    return _max_rel_recv(p32, p64)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _counters():
    from concept_tpu_torch.forces.cuda_shortrange import (
        pair_sweep, pair_sweep_global, pair_sweep_reach, pair_sweep_subset,
    )
    from concept_tpu_torch.forces.shortrange import sweep_reach
    from concept_tpu_torch.grid.cuda_blocks import deposit_blocks, gather_blocks
    from concept_tpu_torch.grid.cuda_cells import deposit_cells, gather_cells
    from concept_tpu_torch.grid.cuda_pm import deposit_pm, gather_pm

    return {"pair_sweep": pair_sweep, "pair_sweep_reach": pair_sweep_reach,
            "sweep_reach": sweep_reach, "deposit_cells": deposit_cells,
            "gather_cells": gather_cells, "deposit_blocks": deposit_blocks,
            "gather_blocks": gather_blocks, "deposit_pm": deposit_pm,
            "gather_pm": gather_pm, "pair_sweep_subset": pair_sweep_subset,
            "pair_sweep_global": pair_sweep_global}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = fn.launches_f64 = 0


def _read_counts() -> dict:
    """The float kernels' launch counts."""
    return {name: fn.launches for name, fn in _counters().items()}


def _read_counts_f64() -> dict:
    """The double kernels' launch counts."""
    return {name: fn.launches_f64 for name, fn in _counters().items()}


def _fp_peak(dtype) -> float:
    import torch

    return FP64_FLOPS if dtype == torch.float64 else FP32_FLOPS


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


def _example(n: int, mesh: int, extra=()):
    """example_basic at n³ particles on grid `mesh`: (cfg, consts, bg, lin,
    spec, softening length)."""
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import build_components, build_cosmology, softening_length

    cfg = load_params(PARAM, overrides=[
        f"initial_conditions={{'species':'matter','N':{n}**3}}",
        f"potential_options={mesh}", *extra])
    _, consts, bg, lin = build_cosmology(cfg)
    spec, _ = build_components(cfg, bg, consts)[0]
    return cfg, consts, bg, lin, spec, softening_length(cfg, spec, mesh)


def _realized_layout(N: int, mesh: int, device: str, unified_cb: int | None = None,
                     dtype=None, lpt_order: int = 1):
    """A realized example_basic state at N particles on the mesh-`mesh`
    rung layout (the device's choice, or the unified layout with cells
    `unified_cb` mesh cells wide), in float32 or ``dtype``, realized by
    ``lpt_order``-LPT on the device: (adapter, RungState)."""
    import torch

    from concept_tpu_torch.p3mrungs import P3MRungSimulation, RungSimulationAdapter
    from concept_tpu_torch.device import resolve_device
    from concept_tpu_torch.sim import SimConfig

    n = round(N ** (1 / 3))
    cfg, consts, bg, lin, spec, soft = _example(n, mesh)
    dev = resolve_device(device)
    config = SimConfig(boxsize=cfg.boxsize, potential_gridsize=mesh, device=dev,
                       dtype=dtype or torch.float32, G=consts.G_Newton, softening=soft,
                       softening_kernel=cfg.softening_kernel)
    adapter = RungSimulationAdapter(spec, config, bg, lin, N_rungs=cfg.N_rungs)
    if unified_cb is not None:
        adapter.inner = P3MRungSimulation(
            n, cfg.boxsize, spec.mass, consts.G_Newton, mesh=mesh, bg=bg,
            N_rungs=cfg.N_rungs, softening=config.softening,
            softening_kernel=config.softening_kernel, unified=True,
            unified_cb=unified_cb, device=dev)
    flat = adapter.initial_state(cfg.a_begin, seed=0, lpt_order=lpt_order)
    return adapter, adapter._to_layout(flat)


def _pair_work(pos_s, n, boxsize, cutoff2, soft2, offsets, sup_s=None):
    """The work a sweep with receivers = suppliers = the sentinel-filled
    slots pos_s (3, K, C) needs (or with the suppliers ``sup_s``),
    whatever rows its launch visits: (pair tests between valid slots of
    neighbouring cells, Σ_c n_c·Σ_nb n_nb over the neighbour cells
    nb = c + d, d in ``offsets``, of each cell c; pairs inside the
    cutoff; of those the pairs inside the spline's near field
    r² < (2.8ε)²; valid slots, the suppliers' too where they differ)."""
    import torch

    from concept_tpu_torch.forces.shortrange import SENTINEL

    _, K, C = pos_s.shape
    dev = pos_s.device
    valid = pos_s[0].abs() < 0.5 * SENTINEL * boxsize
    occ = valid.sum(0).reshape(n, n, n).to(torch.int64)
    sup = pos_s if sup_s is None else sup_s
    sup_valid = sup[0].abs() < 0.5 * SENTINEL * boxsize
    sup_occ = sup_valid.sum(0).reshape(n, n, n).to(torch.int64)
    nbsum = sum(torch.roll(sup_occ, (-di, -dj, -dk), (0, 1, 2)) for di, dj, dk in offsets)
    tested = int((occ * nbsum).sum())
    cells = torch.arange(C, device=dev)
    ci, cj, ck = cells // (n * n), (cells // n) % n, cells % n
    within = near = 0
    ch = max(1, (1 << 24) // (K * sup.shape[1]))
    for c0 in range(0, C, ch):
        cols = slice(c0, min(C, c0 + ch))
        own = pos_s[:, :, cols][:, :, None, :]
        vr = valid[:, cols][:, None, :]
        for di, dj, dk in offsets:
            ids, shift = [], []
            for c, d in ((ci, di), (cj, dj), (ck, dk)):
                m = c[cols] + d
                shift.append(((m >= n).float() - (m < 0).float()) * boxsize)
                ids.append(torch.remainder(m, n))
            col = (ids[0] * n + ids[1]) * n + ids[2]
            nb = sup[:, :, col] + torch.stack(shift)[:, None, :]
            d = own - nb[:, None]
            r2 = (d * d).sum(0)
            m = (r2 < cutoff2) & (r2 > 0) & vr & sup_valid[:, col][None]
            within += int(m.sum())
            near += int((m & (r2 < 7.84 * soft2)).sum())
    n_valid = int(valid.sum()) + (0 if sup_s is None else int(sup_valid.sum()))
    return tested, within, near, n_valid


def _occ(pos_s, box: float):
    """The per-column occupancy extents (C,) int32 of sentinel-filled
    slots (3, K, C): the row bounds the global callers pass (min(counts,
    K) of a bucketize, p3mrungs._column_occ_ext of a persistent layout)."""
    from concept_tpu_torch.forces.shortrange import SENTINEL
    from concept_tpu_torch.p3mrungs import _column_occ_ext

    return _column_occ_ext(pos_s[0].abs() < 0.5 * SENTINEL * box)


def _visited(rb, sb, n: int, offsets) -> int:
    """Row pairs a sweep launch visits under per-column bounds rb, sb (C,):
    Σ_c rb[c]·Σ_d sb[c + d] over the offsets d (periodic)."""
    import torch

    s3 = sb.reshape(n, n, n)
    nbsum = sum(torch.roll(s3, (-di, -dj, -dk), (0, 1, 2)) for di, dj, dk in offsets)
    return int((rb.reshape(n, n, n) * nbsum).sum())


def _check_sweep(tag: str, pos_s, sim, bounds, reps: int, plain_reps: int,
                 reach: str | None = None, sup_s=None, tol: float | None = None,
                 per_receiver: bool = False) -> dict:
    """The pair sweep kernel against its plain version on the slot
    positions pos_s (3, K, C) of a layout with `sim`'s geometry (nc,
    boxsize, scale, cutoff, softening, softening_kernel), receivers =
    suppliers, with per-column row bounds (rext, sext) or (None, None):
    errors, times and bound.  ``reach`` = "global" sweeps the ±1 columns
    through pair_sweep_global (row 6), "subset" through pair_sweep_subset
    (row 2): both are also held bit for bit against the unbounded launch
    of row 1's kernel (pair_sweep without bounds, which rows 6 and 2
    launched before they had a kernel of their own) on the rows below the
    receiver bounds, with 0 beyond them, and that launch is timed beside
    them.  "one-sided" or
    "two-sided" sweeps `sim`'s reach-2 offsets (the 4-mesh-cell layout)
    instead of the ±1 columns: one-sided through pair_sweep_reach with the
    receivers at the negative sentinel, two-sided through sweep_reach (no
    bounds).  ``sup_s``: the suppliers of the "subset" sweep where they
    are not pos_s (one component's slots against another's).
    ``per_receiver``: judge the disagreement receiver by receiver
    (_max_rel_recv) instead of by max|Δ|/max|ref|.
    The bound counts the work the function needs on these slots (see
    _pair_work), which row bounds do not change; the row pairs the launch
    visits are Σ_c rb[c]·Σ_d sb[c + d].  Fails on a disagreement beyond
    max|Δ|/max|ref| (or the per-receiver measure) ≤ 1e-5, or in float64
    (the double kernel) 1e-10, or ``tol`` where given."""
    import torch

    from concept_tpu_torch.forces.cuda_shortrange import (
        OFFSETS_27, column_bounds, pair_sweep, pair_sweep_global, pair_sweep_plain,
        pair_sweep_reach, pair_sweep_subset,
    )
    from concept_tpu_torch.forces.shortrange import SENTINEL, dtype_square, sweep_reach

    dtype = pos_s.dtype
    f64 = dtype == torch.float64
    args = (sim.nc, sim.boxsize, sim.scale, dtype_square(sim.cutoff, dtype),
            dtype_square(sim.softening, dtype), sim.softening_kernel)
    pm1 = (None, "global", "subset")
    offsets = OFFSETS_27 if reach in pm1 else sim.offsets
    sup = pos_s if sup_s is None else sup_s
    if reach in pm1:
        def kern():
            if reach == "subset":
                return pair_sweep_subset(pos_s, sup, *args, rext=bounds[0], sext=bounds[1])
            if reach == "global":
                return pair_sweep_global(pos_s, pos_s, *args, rext=bounds[0], sext=bounds[1])
            return pair_sweep(pos_s, pos_s, *args, rext=bounds[0], sext=bounds[1])

        def plain():
            return pair_sweep_plain(pos_s, sup, *args, rext=bounds[0], sext=bounds[1])
    elif reach == "one-sided":
        recv = torch.where(pos_s.abs() < 0.5 * SENTINEL * sim.boxsize, pos_s,
                           -SENTINEL * sim.boxsize)

        def kern():
            return pair_sweep_reach(recv, pos_s, *args[:5], offsets, kernel=args[5],
                                    rext=bounds[0], sext=bounds[1])

        def plain():
            return pair_sweep_plain(recv, pos_s, *args, rext=bounds[0], sext=bounds[1],
                                    offsets=offsets)
    else:
        from concept_tpu_torch.p3mrungs import UNIFIED_SWEEP_MARGIN

        valid = pos_s[0].abs() < 0.5 * SENTINEL * sim.boxsize
        cw = sim.boxsize / sim.nc

        def kern():
            return sweep_reach(*pos_s, valid, sim.nc, sim.boxsize, sim.scale, sim.cutoff,
                               sim.softening, cw, UNIFIED_SWEEP_MARGIN * cw / 4.0,
                               kernel=args[5])

        def plain():
            return pair_sweep_plain(pos_s, pos_s, *args, offsets=offsets)

    got, ref = kern(), plain()
    _sync()
    err, rel_max = _max_rel(got, ref)
    rel = _max_rel_recv(got, ref) if per_receiver else rel_max
    tol = tol or (F64_TOL if f64 else 1e-5)
    ok = rel <= tol
    del ref
    _, K, C = pos_s.shape
    rb, sb = (torch.full((C,), k, device=pos_s.device) if e is None else
              torch.clamp(column_bounds(e, sim.nc).to(torch.int64), max=k)
              for e, k in zip(bounds, (K, sup.shape[1])))
    vs_unbounded = {}
    if reach in ("global", "subset"):
        def unbounded():
            return pair_sweep(pos_s, sup, *args)

        below = torch.arange(K, device=pos_s.device)[:, None] < rb[None, :]
        ub = torch.where(below[None], unbounded(), 0)
        d = float((got - ub).abs().max())
        vs_unbounded = dict(bitwise_equal_unbounded=bool(torch.equal(got, ub)),
                            max_abs_vs_unbounded=d, unbounded_ms=_time_ms(unbounded, reps))
        del ub, below
    del got
    ms, plain_ms = _time_ms(kern, reps), _time_ms(plain, plain_reps)
    visited = _visited(rb, sb, sim.nc, offsets)
    tested, within, near, n_valid = _pair_work(pos_s, sim.nc, sim.boxsize, args[3], args[4],
                                               offsets, sup_s)
    flops = FLOPS_PER_TESTED_PAIR * tested + (
        FLOPS_PER_PAIR_IN_CUTOFF_F64 if f64 else FLOPS_PER_PAIR_IN_CUTOFF) * within
    # valid positions read, the whole (3, K, C) result written, bounds read
    nbytes = pos_s.element_size() * (3 * n_valid + pos_s.numel()) + sum(
        4 * e.numel() for e in bounds if e is not None)
    peak = _fp_peak(dtype)
    bound_ms = 1e3 * max(flops / peak, nbytes / HBM_BYTES_PER_S)
    name = {None: "pair_sweep", "global": "pair_sweep_global",
            "subset": "pair_sweep_subset"}.get(reach, "reach sweep")
    measure = (f"max|Δ|/max|ref| {rel_max:.3e}, per receiver {rel:.3e}" if per_receiver
               else f"max|Δ|/max|ref| {rel:.3e}")
    against = (f"; against the unbounded launch {vs_unbounded['unbounded_ms']:.3f} ms: "
               f"{'bit for bit' if vs_unbounded['bitwise_equal_unbounded'] else 'DIFFERS'}"
               f" (max |Δ| {vs_unbounded['max_abs_vs_unbounded']:.3e})" if vs_unbounded else "")
    print(f"  {name} ({tag}{', float64' if f64 else ''}): max |Δ| {err:.3e}, {measure} "
          f"(tol {tol:g}) {'ok' if ok else 'FAIL'}; {ms:.3f} ms, plain {plain_ms:.1f} ms, "
          f"bound {bound_ms:.3f} ms; {tested} pair tests needed ({n_valid} valid "
          f"slots), {within} in the cutoff, {near} in the spline near field; the "
          f"launch visits {visited} row pairs (deepest receiver bound {int(rb.max())}, "
          f"supplier bound {int(sb.max())} rows){against}")
    if not ok:
        raise SystemExit(f"{name} ({tag}) disagrees with its plain version")
    return dict(**vs_unbounded,
        max_abs_err=err, max_rel_err=rel, tol_rel=tol, per_receiver=per_receiver,
        max_rel_err_of_max=rel_max, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="operations" if flops / peak >
        nbytes / HBM_BYTES_PER_S else "bytes", flops=flops, bytes=nbytes,
        pairs_tested=tested, pairs_in_cutoff=within, pairs_near_field=near,
        valid_slots=n_valid, row_pairs_visited=visited, K_rows=K,
        max_receiver_bound=int(rb.max()), max_supplier_bound=int(sb.max()))


def _sentineled(state, K: int, sentinel: float):
    """The leading K slot rows' positions (3, K, C), invalid slots at the
    far sentinel: the sweep's input."""
    import torch

    return torch.where(state.valid[:K][None], state.pos[:, :K], sentinel).contiguous()


def _deposit_library(pos, w, mesh: int, box: float, cb: int = 8, zmajor: bool = False):
    """The deposit's scatter as one library call: ``index_add_`` of the 8
    CIC corner indices and weights of every depositing slot, computed
    beforehand (the call does not form them).  Columns are cb mesh cells
    wide, ids x-major (or z-major).  Returns the call."""
    import torch

    from concept_tpu_torch.grid.cuda_cells import cell_geometry
    from concept_tpu_torch.grid.interp import cic_corners

    nc = mesh // cb
    anchors, fracs, in_halo = cell_geometry(pos, slice(0, nc**3), nc, cb, mesh / box,
                                            zmajor)
    q = w * in_halo
    keep = q != 0
    idx, vals = zip(*((i[keep], (wt * q)[keep]) for i, wt in cic_corners(anchors, fracs, mesh)))
    idx, vals = torch.cat(idx), torch.cat(vals)
    return lambda: torch.zeros(mesh**3, dtype=vals.dtype, device=pos.device).index_add_(
        0, idx, vals).reshape(mesh, mesh, mesh)


def _gather_library(pos, wv, grids, mesh: int, box: float, cb: int = 8,
                    zmajor: bool = False):
    """The gather as one library call: trilinear ``grid_sample`` (CIC
    interpolation) of the D grids, padded periodically by one cell
    beforehand, at every slot.  Returns (call, mask of the slots the
    gather kernel serves: valid and inside the cell's halo)."""
    import torch
    import torch.nn.functional as F

    from concept_tpu_torch.grid.cuda_cells import cell_geometry

    D = grids.shape[0]
    _, K, C = pos.shape
    nc = mesh // cb
    _, _, in_halo = cell_geometry(pos, slice(0, C), nc, cb, mesh / box, zmajor)
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


def check_kernels(N: int = 128**3, mesh: int = 256, device: str = "cuda", dtype=None) -> dict:
    """Each kernel against its plain version at the shapes of a realized
    N-particle state on the mesh-`mesh` layout (float32, or ``dtype``)."""
    from concept_tpu_torch.forces.shortrange import SENTINEL

    adapter, state = _realized_layout(N, mesh, device, dtype=dtype)
    sim = adapter.inner
    K = sim._K_occ
    nc, box = sim.nc, sim.boxsize
    pos = state.pos[:, :K]
    valid = state.valid[:K]
    pos_s = _sentineled(state, K, SENTINEL * box)
    ext = sim._ext_occ
    print(f"kernels vs plain: {N} particles, mesh {mesh}, {nc}³ cells, "
          f"{K} slot rows (capacity {sim.capacity}), {pos.dtype}")
    out = {"shape": {"N": N, "mesh": mesh, "nc": nc, "K_rows": K}}

    # A: the pair sweep, with the occupancy bounds and without bounds
    for tag, bounds in (("bounded", (ext, ext)), ("unbounded", (None, None))):
        out[f"pair_sweep_{tag}"] = _check_sweep(tag, pos_s, sim, bounds, 10,
                                                1 if dtype else 2)

    # B, C: the CIC deposit of w = mass·valid and the gather of the three
    # PM force components
    out.update(_check_slot_pm("cells", pos, valid, sim.mass, sim.G, sim.scale, mesh, box, 8,
                              ext))
    return out


def _check_pm_kernels(names, pos, valid, mass: float, G: float, scale: float | None,
                      mesh: int, box: float, cb: int, zmajor: bool,
                      dep, dep_plain, gat, gat_plain, nbytes=None, libraries=None,
                      D=3, dtype=None) -> dict:
    """A CIC deposit kernel and its gather twin against their plain
    versions on the slots pos (3, K, C) of columns cb mesh cells wide
    (x-major or z-major ids): the deposit of w = mass·valid, then the
    gather of the first D force components of that deposit (long-range
    with the split scale, PM-only with ``scale`` None).  dep(w), gat(wv,
    grads) call a kernel; the *_plain twins its plain version.  Each is
    timed beside its bound and its library call.  ``nbytes`` (deposit's
    bytes, the gather's as a function of D) and ``libraries`` (deposit's
    call of w, gather's (call, mask) of wv and grads) replace the
    position-based defaults.  ``D`` may be a tuple of widths: the gather
    is checked at each, under ``names[1]`` for the first and
    ``names[1]_D<width>`` for the others.  Fails on a disagreement beyond
    rtol 2e-5, atol 1e-5·max|ref|, or in float64 (``dtype``, the double
    kernels) beyond max|Δ| ≤ 1e-10·max|ref|."""
    import torch

    from concept_tpu_torch.forces.pm import gravity_potential_slab
    from concept_tpu_torch.grid import fourier
    from concept_tpu_torch.grid.fft import irfft3, rfft3

    f64 = dtype == torch.float64
    b = 8 if f64 else 4  # bytes of a position, weight or mesh value
    tol = "max|Δ| ≤ 1e-10·max|ref|" if f64 else "rtol 2e-5, atol 1e-5·max|ref|"

    def compare(name, got, ref):
        err, rel = _max_rel(got, ref)
        ok = (rel <= F64_TOL if f64 else
              bool(torch.allclose(got, ref, rtol=2e-5, atol=1e-5 * float(ref.abs().max()))))
        print(f"  {name}: max |Δ| {err:.3e} ({rel:.3e} of max) {'ok' if ok else 'FAIL'}",
              end="; ")
        if not ok:
            print()
            raise SystemExit(f"{name} disagrees with its plain version")
        return err, rel

    out = {}
    n_valid = int(valid.sum())
    w = (valid.to(dtype or torch.float32) * mass).contiguous()
    got, ref = dep(w), dep_plain(w)
    _sync()
    err, rel = compare(names[0], got, ref)
    ms = _time_ms(lambda: dep(w), 20)
    plain_ms = _time_ms(lambda: dep_plain(w), 2)
    # w read in full, valid slots' positions read, the mesh written
    dep_bytes = nbytes[0] if nbytes else b * (w.numel() + 3 * n_valid + mesh**3)
    flops = 60 * n_valid  # geometry (~12) + 8 corners × (weight, product, add)
    bound_ms = 1e3 * max(dep_bytes / HBM_BYTES_PER_S, flops / _fp_peak(w.dtype))
    library = (libraries[0](w) if libraries
               else _deposit_library(pos, w, mesh, box, cb, zmajor))
    _, lib_rel = _max_rel(library(), ref)
    library_ms = _time_ms(library, 20)
    del library
    out[names[0]] = dict(
        max_abs_err=err, max_rel_err=rel, tol=tol, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", bytes=dep_bytes, flops=flops,
        mass_sum=float(got.sum(dtype=torch.float64)), mass_expected=n_valid * mass,
        library_ms=library_ms, library="index_add_ of precomputed corners",
        library_max_rel_err=lib_rel)
    print(f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.3f} ms; library "
          f"(index_add_ of precomputed corners) {library_ms:.3f} ms, {lib_rel:.1e} of max off")

    widths = D if isinstance(D, tuple) else (D,)
    slab = rfft3(got / (box / mesh) ** 3)
    phi = gravity_potential_slab(slab, mesh, box, G, deconv_order=4, longrange_scale=scale)
    all_grads = torch.stack([irfft3(fourier.fourier_diff(phi, mesh, box, d), mesh)
                             for d in range(max(widths))])
    del slab, phi, got, ref
    wv = valid.to(w.dtype).contiguous()
    for k, width in enumerate(widths):
        grads = all_grads[:width].contiguous()
        name = names[1] if k == 0 else f"{names[1]}_D{width}"
        got, ref = gat(wv, grads), gat_plain(wv, grads)
        _sync()
        err, rel = compare(f"{names[1]} (D = {width})", got, ref)
        ms = _time_ms(lambda: gat(wv, grads), 20)
        plain_ms = _time_ms(lambda: gat_plain(wv, grads), 2)
        gat_bytes = nbytes[1](width) if nbytes else b * (
            wv.numel() + 3 * n_valid + grads.numel() + got.numel())
        flops = (12 + width * 8 * 3) * n_valid
        bound_ms = 1e3 * max(gat_bytes / HBM_BYTES_PER_S, flops / _fp_peak(w.dtype))
        library, mask = (libraries[1](wv, grads) if libraries
                         else _gather_library(pos, wv, grads, mesh, box, cb, zmajor))
        _, lib_rel = _max_rel(library() * mask, ref)
        library_ms = _time_ms(library, 20)
        del library, mask, got, ref
        out[name] = dict(
            max_abs_err=err, max_rel_err=rel, tol=tol, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", bytes=gat_bytes,
            flops=flops, D=width, library_ms=library_ms,
            library="grid_sample on the periodically padded grids",
            library_max_rel_err=lib_rel)
        print(f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.3f} ms; library "
              f"(grid_sample on padded grids) {library_ms:.3f} ms, {lib_rel:.1e} of max off")
    return out


def _global_sim(N: int, mesh: int, device: str, dtype=None, method: str = "p3m"):
    """A global-stepper Simulation of example_basic at N particles on
    grid `mesh` (``N_rungs = 1``; gravity ``method``), in float32 or
    ``dtype``, and its realized initial state."""
    import torch

    from concept_tpu_torch.device import resolve_device
    from concept_tpu_torch.sim import SimConfig, Simulation

    cfg, consts, bg, lin, spec, soft = _example(round(N ** (1 / 3)), mesh, ("N_rungs=1",))
    config = SimConfig(boxsize=cfg.boxsize, potential_gridsize=mesh,
                       device=resolve_device(device), dtype=dtype or torch.float32,
                       G=consts.G_Newton, softening=soft, method=method,
                       softening_kernel=cfg.softening_kernel)
    sim = Simulation(spec, config, bg, lin)
    return sim, sim.initial_state(cfg.a_begin, seed=0)


def _sweep_geometry(sim) -> SimpleNamespace:
    """The short-range geometry of a global-stepper Simulation, in the
    attribute names _check_sweep reads."""
    return SimpleNamespace(nc=sim._sr_ncells, boxsize=sim.config.boxsize,
                           scale=sim._sr_scale, cutoff=sim._sr_range,
                           softening=sim.config.softening,
                           softening_kernel=sim.config.softening_kernel)


def _global_sweep_slots(sim, pos):
    """The global stepper's sweep input: the sentinel-filled (3, K, C)
    short-range slots of positions pos (N, 3) at the current capacity,
    and the number of stragglers beyond it."""
    import torch

    from concept_tpu_torch.forces.shortrange import SENTINEL, bucketize

    comps = tuple(pos[:, d].contiguous() for d in range(3))
    b = bucketize(comps, sim.config.boxsize, sim._sr_ncells, sim._sr_capacity)
    slots = torch.where(b["valid"][None], torch.stack([b["hx"], b["hy"], b["hz"]]),
                        SENTINEL * sim.config.boxsize).contiguous()
    return slots, pos.shape[0] - int(b["valid"].sum())


def check_global_kernels(N: int = 128**3, mesh: int = 256, device: str = "cuda",
                         dtype=None) -> dict:
    """The global stepper's kernels against their plain versions at the
    shapes of a realized N-particle state on grid `mesh`: the two-sided
    sweep on the short-range slots (row 6, with their occupancy bounds),
    the deposit and gather on the PM blocks.  In float64 (``dtype``) also
    row 2, the one-sided sweep of ``pair_sweep_subset``, on the same
    slots."""
    sim, flat = _global_sim(N, mesh, device, dtype)
    box = sim.config.boxsize
    slots, n_over = _global_sweep_slots(sim, flat.pos)
    K = slots.shape[1]
    print(f"global-stepper kernels vs plain: {N} particles, mesh {mesh}, "
          f"{sim._sr_ncells}³ short-range cells, K = {K} ({n_over} stragglers); "
          f"{mesh // 2}³ PM blocks, K = {sim._k_pm}")
    out = {"shape": {"N": N, "mesh": mesh, "nc": sim._sr_ncells, "K_rows": K,
                     "stragglers": n_over, "nb": mesh // 2, "k_pm": sim._k_pm}}
    ext = _occ(slots, box)
    out["pair_sweep_two_sided"] = _check_sweep("two-sided", slots, _sweep_geometry(sim),
                                               (ext, ext), 10, 1 if dtype else 2,
                                               reach="global")
    if dtype is not None:
        out["subset_sweep"] = _check_sweep("one-sided", slots, _sweep_geometry(sim),
                                           (ext, ext), 10, 1, reach="subset")
    del slots
    pos, valid, ext = _global_pm_slots(sim, flat.pos)
    out.update(_check_slot_pm("PM blocks", pos, valid, sim.spec.mass, sim.config.G,
                              sim._sr_scale, mesh, box, 2, ext))
    return out


def check_reach_kernels(N: int = 128**3, mesh: int = 256, device: str = "cuda",
                        dtype=None) -> dict:
    """The 4-mesh-cell layout's kernels against their plain versions at
    the shapes of a realized N-particle state on mesh `mesh` with
    ``unified_cb = 4``: the reach sweep one-sided with per-column
    occupancy bounds and without, and two-sided, the cell deposit and
    gather at cb = 4."""
    from concept_tpu_torch.forces.shortrange import SENTINEL

    adapter, state = _realized_layout(N, mesh, device, unified_cb=4, dtype=dtype)
    sim = adapter.inner
    K = sim._K_occ
    nc, box = sim.nc, sim.boxsize
    pos = state.pos[:, :K]
    valid = state.valid[:K]
    pos_s = _sentineled(state, K, SENTINEL * box)
    print(f"4-mesh-cell kernels vs plain: {N} particles, mesh {mesh}, {nc}³ cells, "
          f"{K} slot rows (capacity {sim.capacity}), {len(sim.offsets)} kept offsets")
    out = {"shape": {"N": N, "mesh": mesh, "nc": nc, "K_rows": K,
                     "offsets": len(sim.offsets)}}
    ext = sim._ext_occ
    out["reach_one_sided"] = _check_sweep("one-sided, bounded", pos_s, sim, (ext, ext), 10, 1,
                                          reach="one-sided")
    for reach in ("one-sided", "two-sided"):
        out[f"reach_{reach.replace('-', '_')}_unbounded"] = _check_sweep(
            reach, pos_s, sim, (None, None), 10, 1, reach=reach)
    del pos_s
    pm = _check_slot_pm("cells", pos, valid, sim.mass, sim.G, sim.scale, mesh, box, 4, ext)
    out.update({f"{k}_cb4": v for k, v in pm.items()})
    return out


def _check_slot_pm(tag: str, pos, valid, mass: float, G: float, scale, mesh: int,
                   box: float, cb: int, ext=None, D=3) -> dict:
    """The slot-layout deposit and gather (at D, as in _check_pm_kernels)
    against their plain versions on the slots pos (3, K, C): the cells'
    kernels (rows 3-4) for cb 8 or 4 with x-major ids, the blocks' (rows
    8-9) for cb 2 with z-major ids, with the per-column row extents
    ``ext`` where the caller passes them as its path does (the blocks'
    deposit and gather, the cells' gather), with bounds and library calls
    as in 2."""
    from concept_tpu_torch.grid.cuda_blocks import (
        deposit_blocks, deposit_blocks_plain, gather_blocks, gather_blocks_plain,
    )
    from concept_tpu_torch.grid.cuda_cells import (
        deposit_cells, deposit_cells_plain, gather_cells, gather_cells_plain,
    )

    _, K, C = pos.shape
    print(f"  {tag}: {K} slot rows × {C} columns {cb} mesh cells wide, "
          f"{int(valid.sum())} live slots")
    if cb == 2:
        kernels = ("deposit_blocks", "gather_blocks",
                   lambda w: deposit_blocks(*pos, w, mesh, box, ext),
                   lambda w: deposit_blocks_plain(*pos, w, mesh, box),
                   lambda wv, g: gather_blocks(*pos, wv, g, mesh, box, ext),
                   lambda wv, g: gather_blocks_plain(*pos, wv, g, mesh, box))
    else:
        kernels = ("deposit_cells", "gather_cells",
                   lambda w: deposit_cells(pos, w, mesh, box, cb),
                   lambda w: deposit_cells_plain(pos, w, mesh, box, cb),
                   lambda wv, g: gather_cells(pos, wv, g, mesh, box, cb, ext),
                   lambda wv, g: gather_cells_plain(pos, wv, g, mesh, box, cb))
    nbytes = None
    if ext is not None:
        # with extents the kernels read the extents and the live rows' w
        # (the cells' deposit takes none: all of w)
        live = int(valid.sum())
        b = pos.element_size()
        dep_w = live if cb == 2 else K * C
        nbytes = (4 * C * (cb == 2) + b * (dep_w + 3 * live + mesh**3),
                  lambda D: 4 * C + b * (4 * live + D * mesh**3 + D * K * C))
    out = _check_pm_kernels(kernels[:2], pos, valid, mass, G, scale, mesh, box, cb, cb == 2,
                            *kernels[2:], nbytes=nbytes, D=D, dtype=pos.dtype)
    out["slots"] = {"K_rows": K, "columns": C, "cb": cb, "live": int(valid.sum())}
    return out


def _rung_pm_slots(inner, layout):
    """The slots the rung stepper's PM kick deposits from on a layout: its
    leading K_occ rows on the cell layouts (cb = ucb), or on the tight
    layout the valid slots in the 2-mesh-cell blocks of
    p3msim.pm_gradient_layout.  Returns (pos (3, K, C), valid, cb, the row
    extents the kick passes: the cells' occupancy extents, the blocks'
    counts)."""
    from concept_tpu_torch.forces.p3m import block_layout

    K = inner._K_occ
    pos, valid = layout.pos[:, :K], layout.valid[:K]
    if inner.ucb:
        return pos, valid, inner.ucb, inner._ext_occ
    flat = pos.reshape(3, -1)[:, valid.reshape(-1)]
    lay = block_layout(*flat, inner.mesh, inner.boxsize, inner.k_pm)
    return lay["slots"], lay["valid"], 2, lay["ext"]


def _global_pm_slots(sim, pos):
    """The global stepper's PM block slots of positions pos (N, 3):
    (slots (3, K, C), valid, row extents)."""
    from concept_tpu_torch.forces.p3m import block_layout

    lay = block_layout(*(pos[:, d].contiguous() for d in range(3)),
                       sim.config.potential_gridsize, sim.config.boxsize, sim._k_pm)
    return lay["slots"], lay["valid"], lay["ext"]


def _pm_only_libraries(sb, mesh: int):
    """The library calls of rows 10 and 11 on the block-sorted particles
    sb: a function making the deposit's call (``index_add_`` of the 8 CIC
    corners of every particle, computed beforehand) and one of the
    gather's (call, mask): trilinear ``grid_sample`` of the periodically
    padded grids at the particles' padded mesh coordinates, anchor +
    fraction + 1."""
    import torch
    import torch.nn.functional as F

    from concept_tpu_torch.grid.cuda_pm import _geometry
    from concept_tpu_torch.grid.interp import cic_corners

    N = sb["lidx"].shape[0]
    anchors, fracs, _ = _geometry(sb["lidx"], sb["fx"], sb["fy"], sb["fz"], sb["starts"],
                                  sb["counts"], mesh // 2, slice(0, N))

    def deposit_library(w):
        idx, vals = zip(*((i, wt * w) for i, wt in cic_corners(anchors, fracs, mesh)))
        idx, vals = torch.cat(idx), torch.cat(vals)
        return lambda: torch.zeros(mesh**3, dtype=vals.dtype, device=w.device).index_add_(
            0, idx, vals).reshape(mesh, mesh, mesh)

    def gather_library(wv, grids):
        D = grids.shape[0]
        padded = F.pad(grids[None], (1, 1, 1, 1, 1, 1), mode="circular")
        u = torch.stack([a + f + 1.0 for a, f in zip(anchors, fracs)]) * (2.0 / (mesh + 1)) - 1.0
        coords = u.flip(0).T.reshape(1, 1, 1, N, 3).contiguous()

        def call():
            return F.grid_sample(padded, coords, mode="bilinear", padding_mode="border",
                                 align_corners=True).reshape(D, N)

        return call, wv != 0

    return deposit_library, gather_library


def _check_pm_buckets(pos, mass: float, G: float, mesh: int, box: float) -> dict:
    """Rows 10 and 11 against their plain versions on the particles pos
    (N, 3) sorted by block on PM grid `mesh`, as the PM-only kick sorts
    them: the deposit, and the gather at D = 3 (the kick's three gradient
    components in one launch) and at D = 1 (one component a launch, as
    the kick gathered in the padded-slot design).  The bounds count each
    input read once and each output written once: 20 bytes in a particle
    (lidx, fx, fy, fz, q) and the mesh written (deposit); 16 bytes in and
    4·D out a particle and the D meshes read (gather); in float64 the
    fractions, weights and meshes take 8 bytes a value."""
    import torch

    from concept_tpu_torch.grid.bucketed import sort_blocks
    from concept_tpu_torch.grid.cuda_pm import (
        deposit_pm, deposit_pm_plain, gather_pm, gather_pm_plain,
    )

    N = pos.shape[0]
    sb = sort_blocks(pos, mesh, box)
    b = pos.element_size()
    deepest = int(sb["counts"].max())
    print(f"  {N} particles, mesh {mesh}, {mesh // 2}³ blocks, deepest block {deepest}")
    out = {"shape": {"N": N, "mesh": mesh, "nb": mesh // 2, "deepest_block": deepest}}
    args = (sb["lidx"], sb["fx"], sb["fy"], sb["fz"])
    blocks = (sb["starts"], sb["counts"])
    out.update(_check_pm_kernels(
        ("deposit_pm", "gather_pm"), None, torch.ones(N, dtype=torch.bool, device=pos.device),
        mass, G, None, mesh, box, 2, False,
        lambda w: deposit_pm(*args, w, *blocks, mesh),
        lambda w: deposit_pm_plain(*args, w, *blocks, mesh),
        lambda wv, g: gather_pm(*args, *blocks, g, mesh),
        lambda wv, g: gather_pm_plain(*args, *blocks, g, mesh),
        nbytes=((4 + 4 * b) * N + b * mesh**3,
                lambda D: (4 + 3 * b) * N + b * D * N + b * D * mesh**3),
        libraries=_pm_only_libraries(sb, mesh), D=(3, 1), dtype=pos.dtype))
    return out


def check_pm_only_kernels(N: int = 256**3, mesh: int = 256, device: str = "cuda",
                          dtype=None) -> dict:
    """Rows 10 and 11 against their plain versions at the shapes of a
    realized N-particle state on PM grid `mesh`."""
    sim, flat = _global_sim(N, mesh, device, dtype)
    print("PM-only block kernels vs plain, realized state:")
    return _check_pm_buckets(flat.pos, sim.spec.mass, sim.config.G, mesh,
                             sim.config.boxsize)


RUNG_KERNELS = ("pair_sweep", "deposit_cells", "gather_cells")
GLOBAL_KERNELS = ("pair_sweep_global", "deposit_blocks", "gather_blocks")
REACH_KERNELS = ("pair_sweep_reach", "deposit_cells", "gather_cells")
TIGHT_KERNELS = ("pair_sweep", "deposit_blocks", "gather_blocks")
PM_KERNELS = ("deposit_pm", "gather_pm")
BUCKET_KERNELS = ("deposit_blocks", "gather_blocks")
PM_ONLY = "select_forces={'all': {'gravity': 'pm'}}"


def _run(overrides: list, outdir: str, kernels=RUNG_KERNELS, device: str = "cuda",
         param: str = PARAM, f64: bool = False, spectrum: dict | None = None):
    """load_params + run on the card, as the CLI does; returns
    (sim, final state, a, launch counts, host seconds).  Fails unless each
    of ``kernels`` launched and no other kernel did, when a budget was
    exceeded or when the deposit lost more than half a particle's mass at
    any step.  With ``f64`` the run is ``enable_float64 = True``: its
    state must be float64 and ``kernels`` must launch in double only (the
    counts returned are the double kernels').  ``spectrum`` receives the
    last power spectrum's columns under "data"."""
    import torch

    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    cfg = load_params(param, overrides=overrides + ["enable_float64=True"] * f64
                      + [f"output_dirs='{outdir}'"])
    _reset_counts()
    t0 = time.time()
    sim, state, a = run(cfg, device=device)
    _sync()
    seconds = time.time() - t0
    counts, counts64 = _read_counts(), _read_counts_f64()
    files = [f for f in os.listdir(outdir) if f.startswith("powerspec")]
    if not files:
        raise SystemExit(f"no power spectrum written to {outdir}")
    import numpy as np

    data = np.loadtxt(os.path.join(outdir, sorted(files)[-1]))
    if data.ndim != 2 or not np.all(np.isfinite(data[:, :3])):
        raise SystemExit("the power spectrum is not finite")
    if spectrum is not None:
        spectrum["data"] = data
    if not torch.isfinite(state.pos).all() or not torch.isfinite(state.mom).all():
        raise SystemExit("the final state is not finite")
    stats = getattr(sim, "inner", sim).stats
    if stats.get("pm_mass_warnings", 0):
        raise SystemExit(f"the PM deposit lost mass {stats['pm_mass_warnings']} times")
    if stats.get("budget_warnings", 0):
        raise SystemExit(f"an overflow budget was exceeded {stats['budget_warnings']} times")
    if stats["pm_mass_deficit_max"] > 0.5:
        raise SystemExit(f"the PM deposit lost {stats['pm_mass_deficit_max']:.3g} "
                         "particle masses at a step")
    if f64:
        if state.pos.dtype != torch.float64:
            raise SystemExit(f"an enable_float64 run ended in {state.pos.dtype}")
        _check_launches(counts, ())
        _check_launches(counts64, kernels)
        return sim, state, a, counts64, seconds
    _check_launches(counts64, ())
    _check_launches(counts, kernels)
    return sim, state, a, counts, seconds


def _check_launches(counts: dict, kernels):
    """Fail unless each of ``kernels`` launched and no other kernel did."""
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise SystemExit(f"kernels never launched on this path: {missing}")
    stray = [k for k, v in counts.items() if v and k not in kernels]
    if stray:
        raise SystemExit(f"kernels of another path launched: {stray}")


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
    del pos_s
    pos, valid, cb, ext = _rung_pm_slots(inner, layout)
    pm = _check_slot_pm("PM kernels vs plain on the final layout", pos, valid, inner.mass,
                        inner.G, inner.scale, inner.mesh, inner.boxsize, cb, ext)
    return {"a_end": a, "base_steps": steps, "substeps": st["substeps"],
            "max_rung": st["max_rung"], "wall_s": seconds,
            "evolve_s": sim.timings["evolve_s"], "launches": counts,
            "pm_mass_deficit_max": st["pm_mass_deficit_max"],
            "pair_sweep_clustered": clustered, "pm_clustered": pm}


def _layout_main_path(tag: str, n: int, mesh: int, ucb: int, kernels) -> dict:
    """example_basic at n³ particles on grid `mesh`, a = 0.02 → 1, which
    must take the rung layout with cells `ucb` mesh cells wide (0: tight)
    and launch `kernels` only; then the run's sweep against its plain
    version on the final, clustered slots with their per-column bounds
    (the reach sweep one-sided on the 4-mesh-cell layout, the ±1 sweep on
    the tight one)."""
    from concept_tpu_torch.forces.shortrange import SENTINEL

    outdir = tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_")
    try:
        sim, state, a, counts, seconds = _run([
            f"initial_conditions={{'species':'matter','N':{n}**3}}",
            f"potential_options={mesh}"], outdir, kernels)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    inner = sim.inner
    if inner.ucb != ucb:
        raise SystemExit(f"{tag}: grid {mesh} took the layout ucb = {inner.ucb}, "
                         f"not {ucb}")
    st = inner.stats
    steps = sim.hysteresis.get("step_count", 0)
    print(f"{tag} path (example_basic, {n}³, grid {mesh}, {inner.nc}³ cells, ucb = {ucb}, "
          f"a 0.02 → {a:.4g}): {steps} base steps, {st['substeps']} substeps, max rung "
          f"{st['max_rung']}, wall {seconds:.1f} s (evolution {sim.timings['evolve_s']:.1f} s), "
          f"largest deposit deficit {st['pm_mass_deficit_max']:.3g} particle masses, PM "
          f"overflow budget {inner.pm_max_overflow}, launches {counts}")
    layout = sim._to_layout(state)
    K = inner._K_occ
    pos_s = _sentineled(layout, K, SENTINEL * inner.boxsize)
    print(f"kernel vs plain on the final layout: {inner.nc}³ cells, {K} slot rows")
    if ucb == 4:
        clustered = _check_sweep("one-sided, clustered, bounded", pos_s, inner,
                                 (inner._ext_occ, inner._ext_occ), 10, 1, reach="one-sided")
    else:
        clustered = _check_sweep("clustered, bounded", pos_s, inner,
                                 (inner._ext_occ, inner._ext_occ), 10, 1)
    del pos_s
    pos, valid, cb, ext = _rung_pm_slots(inner, layout)
    pm = _check_slot_pm("PM kernels vs plain on the final layout", pos, valid, inner.mass,
                        inner.G, inner.scale, inner.mesh, inner.boxsize, cb, ext)
    return {"N": n**3, "mesh": mesh, "nc": inner.nc, "ucb": ucb, "a_end": a,
            "base_steps": steps, "substeps": st["substeps"], "max_rung": st["max_rung"],
            "wall_s": seconds, "evolve_s": sim.timings["evolve_s"], "launches": counts,
            "pm_mass_deficit_max": st["pm_mass_deficit_max"],
            "budget_warnings": st["budget_warnings"], "sweep_clustered": clustered,
            "pm_clustered": pm}


def realistic(a_end: float = 0.023, n: int = 256, mesh: int = 512, ucb: int = 8,
              kernels=RUNG_KERNELS, f64: bool = False, check_pm: bool = False) -> dict:
    """The realistic size of a rung layout: n³ particles on grid `mesh`
    (example_basic's widths) to an early output time (in float64 with
    ``f64``); with ``check_pm``, the PM deposit and gather against their
    plain versions on the run's final slots."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    outdir = tempfile.mkdtemp(prefix="chip_smoke_big_")
    try:
        sim, state, a, counts, seconds = _run([
            f"initial_conditions={{'species':'matter','N':{n}**3}}",
            f"potential_options={mesh}",
            f"output_times={{'powerspec': [{a_end}]}}"], outdir, kernels, f64=f64)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    if sim.inner.ucb != ucb:
        raise SystemExit(f"grid {mesh} took the layout ucb = {sim.inner.ucb}, not {ucb}")
    steps = sim.hysteresis.get("step_count", 0)
    if steps < 3:
        raise SystemExit(f"the realistic run took {steps} base steps (< 3)")
    N = sim.spec.N
    ev = sim.timings["evolve_s"]
    peak = torch.cuda.max_memory_allocated()
    st = sim.inner.stats
    print(f"realistic ({n}³, grid {mesh}, {sim.inner.nc}³ cells, ucb = {ucb}"
          f"{', float64' if f64 else ''}, a 0.02 → "
          f"{a:.4g}): {steps} base steps, "
          f"{st['substeps']} substeps, {1e3 * ev / steps:.1f} ms per base step, "
          f"{N * steps / ev:.4g} particle updates/s, peak device memory "
          f"{peak / 2**30:.2f} GiB, realization {sim.timings['realize_s']:.1f} s, "
          f"largest deposit deficit {st['pm_mass_deficit_max']:.3g} particle masses")
    print("realistic-size launches: " + ", ".join(f"{k}={v}" for k, v in counts.items()))
    out = {"a_end": a, "base_steps": steps, "substeps": st["substeps"],
           "max_rung": st["max_rung"], "evolve_s": ev, "ms_per_base_step": 1e3 * ev / steps,
           "particle_updates_per_s": N * steps / ev, "peak_bytes": peak,
           "realize_s": sim.timings["realize_s"], "launches": counts,
           "pm_mass_deficit_max": st["pm_mass_deficit_max"],
           "budget_warnings": st["budget_warnings"]}
    if check_pm:
        inner = sim.inner
        pos, valid, cb, ext = _rung_pm_slots(inner, sim._to_layout(state))
        del state
        out["pm_final"] = _check_slot_pm("PM kernels vs plain on the final slots", pos, valid,
                                         inner.mass, inner.G, inner.scale, inner.mesh,
                                         inner.boxsize, cb, ext)
    return out


# device-time groups of a profiled run, by kernel name (first match)
PROFILE_GROUPS = (("pair_sweep", ("pair_sweep_kernel", "pair_sweep_global_kernel")),
                  ("CIC deposit", ("deposit_tile_kernel",)),
                  ("CIC gather", ("gather_tile_kernel", "gather_columns_kernel")),
                  ("cuFFT", ("fft", "FFT")),
                  ("sort", ("Sort", "sort")),
                  ("index, scatter, gather", ("index", "scatter", "gather")))


def _device_split(fn, groups=PROFILE_GROUPS, kernels: dict | None = None) -> tuple:
    """Device seconds of fn() by group of kernels (torch.profiler, CUDA
    activity; a kernel joins the first group one of whose keys its name
    holds, else "other"), and fn's result: (groups, result).  ``kernels``,
    a dict, receives the seconds of each kernel by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.device_time_total <= 0:
            continue
        g = next((g for g, keys in groups if any(k in e.key for k in keys)), "other")
        out[g] = out.get(g, 0.0) + e.device_time_total / 1e6
        if kernels is not None:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.device_time_total / 1e6
    return out, res


def _profiled(overrides: list, outdir: str) -> dict:
    """The device time of one run by group of kernels, and the run's host
    seconds.  The profiler slows the host, so this run's wall time
    overstates the unprofiled run's."""
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    cfg = load_params(PARAM, overrides=overrides + [f"output_dirs='{outdir}'"])
    groups, (sim, _, _) = _device_split(lambda: run(cfg, device="cuda"))
    return {"device_s": sum(groups.values()), "device_s_by_group": groups,
            "host_s": dict(sim.timings)}


def global_main_path() -> dict:
    """example_basic with N_rungs = 1; then the same run again under the
    profiler (where the device time goes), and the sweep kernel against
    its plain version on the counted run's final, clustered slots."""
    outdir = tempfile.mkdtemp(prefix="chip_smoke_global_")
    try:
        sim, state, a, counts, seconds = _run(["N_rungs=1"], outdir, GLOBAL_KERNELS)
        prof = _profiled(["N_rungs=1"], outdir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    st = sim.stats
    steps = st["steps"]
    ev = sim.timings["evolve_s"]
    print(f"global main path (example_basic, N_rungs = 1, 64³, grid 128, a 0.02 → "
          f"{a:.4g}): {steps} steps, {1e3 * ev / steps:.2f} ms per step, wall "
          f"{seconds:.1f} s (evolution {ev:.1f} s), largest K {st['capacity_max']}, "
          f"largest straggler count {st['sr_overflow_max']}, largest PM overflow "
          f"{st['pm_overflow_max']}, largest deposit deficit "
          f"{st['pm_mass_deficit_max']:.3g} particle masses, launches {counts}")
    wall = sum(sim.timings.values())
    dev_s = prof["device_s"]
    print(f"  profiled rerun: device time {dev_s:.3f} s, busy share of the counted "
          f"run's {wall:.3f} s ≈ {dev_s / wall:.3f}; by group: " + ", ".join(
              f"{g} {v:.3f} s ({100 * v / max(dev_s, 1e-30):.1f} %)" for g, v in
              sorted(prof["device_s_by_group"].items(), key=lambda kv: -kv[1])))
    slots, n_over = _global_sweep_slots(sim, state.pos)
    print(f"kernel vs plain on the final slots: {sim._sr_ncells}³ cells, "
          f"K = {slots.shape[1]}, {n_over} stragglers")
    ext = _occ(slots, sim.config.boxsize)
    clustered = _check_sweep("two-sided, clustered", slots, _sweep_geometry(sim),
                             (ext, ext), 10, 1, reach="global")
    del slots
    pos, valid, ext = _global_pm_slots(sim, state.pos)
    pm = _check_slot_pm("PM kernels vs plain on the final blocks", pos, valid,
                        sim.spec.mass, sim.config.G, sim._sr_scale,
                        sim.config.potential_gridsize, sim.config.boxsize, 2, ext)
    return {"a_end": a, "steps": steps, "wall_s": seconds, "evolve_s": ev,
            "ms_per_step": 1e3 * ev / steps, "launches": counts,
            "stats": dict(st), "profile": prof, "device_busy_share": dev_s / wall,
            "pair_sweep_clustered": clustered, "pm_clustered": pm}


def global_realistic(a_end: float = 0.025) -> dict:
    import torch

    torch.cuda.reset_peak_memory_stats()
    outdir = tempfile.mkdtemp(prefix="chip_smoke_global_big_")
    try:
        sim, _, a, counts, seconds = _run([
            "initial_conditions={'species':'matter','N':256**3}",
            "potential_options=512", "N_rungs=1",
            f"output_times={{'powerspec': [{a_end}]}}"], outdir, GLOBAL_KERNELS)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    st = sim.stats
    steps = st["steps"]
    if steps < 3:
        raise SystemExit(f"the realistic global run took {steps} steps (< 3)")
    N = sim.spec.N
    ev = sim.timings["evolve_s"]
    peak = torch.cuda.max_memory_allocated()
    print(f"global realistic (256³, grid 512, N_rungs = 1, a 0.02 → {a:.4g}): {steps} "
          f"steps, {1e3 * ev / steps:.1f} ms per step, {N * steps / ev:.4g} particle "
          f"updates/s, peak device memory {peak / 2**30:.2f} GiB, realization "
          f"{sim.timings['realize_s']:.1f} s, K {st['capacity_max']}, stragglers "
          f"{st['sr_overflow_max']}, PM overflow {st['pm_overflow_max']}, largest "
          f"deposit deficit {st['pm_mass_deficit_max']:.3g} particle masses; launches "
          + ", ".join(f"{k}={v}" for k, v in counts.items()))
    return {"a_end": a, "steps": steps, "evolve_s": ev, "ms_per_step": 1e3 * ev / steps,
            "particle_updates_per_s": N * steps / ev, "peak_bytes": peak,
            "realize_s": sim.timings["realize_s"], "launches": counts, "stats": dict(st)}


def pm_only_main_path() -> dict:
    """example_basic with PM gravity (64³, grid 128, a = 0.02 → 1) through
    load_params and run with the default deposit_method (where its time
    goes: scripts/torch_profile_main_path.py --gravity pm); then rows 10
    and 11 against their plain versions on the run's final, clustered
    buckets (deep blocks, many particles beyond the capacity)."""
    outdir = tempfile.mkdtemp(prefix="chip_smoke_pm_")
    try:
        sim, state, a, counts, seconds = _run([PM_ONLY], outdir, PM_KERNELS)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    st = sim.stats
    steps = st["steps"]
    ev = sim.timings["evolve_s"]
    print(f"PM-only main path (example_basic, gravity pm, 64³, grid "
          f"{sim.config.potential_gridsize}, a 0.02 → {a:.4g}): {steps} steps, "
          f"{1e3 * ev / steps:.2f} ms per step, wall {seconds:.1f} s (evolution {ev:.1f} s), "
          f"largest block overflow {st['pm_overflow_max']} particles, largest deposit "
          f"deficit {st['pm_mass_deficit_max']:.3g} particle masses, launches {counts}")
    print("PM-only block kernels vs plain, the run's final state:")
    clustered = _check_pm_buckets(state.pos, sim.spec.mass, sim.config.G,
                                  sim.config.potential_gridsize, sim.config.boxsize)
    return {"a_end": a, "steps": steps, "wall_s": seconds, "evolve_s": ev,
            "ms_per_step": 1e3 * ev / steps, "launches": counts, "stats": dict(st),
            "clustered": clustered}


def pm_only_realistic(a_end: float = 0.025, n: int = 512, mesh: int = 512) -> dict:
    """n³ particles on PM grid `mesh` through run, to an early output time;
    then one kick's device memory on the final state."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    outdir = tempfile.mkdtemp(prefix="chip_smoke_pm_big_")
    try:
        sim, state, a, counts, seconds = _run([
            f"initial_conditions={{'species':'matter','N':{n}**3}}",
            f"potential_options={mesh}", PM_ONLY,
            f"output_times={{'powerspec': [{a_end}]}}"], outdir, PM_KERNELS)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    st = sim.stats
    steps = st["steps"]
    if steps < 3:
        raise SystemExit(f"the realistic PM-only run took {steps} steps (< 3)")
    N = sim.spec.N
    ev = sim.timings["evolve_s"]
    peak = torch.cuda.max_memory_allocated()
    print(f"PM-only realistic ({n}³, grid {mesh}, a 0.02 → {a:.4g}): {steps} steps, "
          f"{1e3 * ev / steps:.1f} ms per step, {N * steps / ev:.4g} particle updates/s, "
          f"peak device memory {peak / 2**30:.2f} GiB, realization "
          f"{sim.timings['realize_s']:.1f} s, output {sim.timings['dump_s']:.1f} s, largest "
          f"block overflow {st['pm_overflow_max']}, largest deposit deficit "
          f"{st['pm_mass_deficit_max']:.3g} particle masses; launches "
          + ", ".join(f"{k}={v}" for k, v in counts.items()))
    memory = _pm_kick_memory(sim, state)
    return {"a_end": a, "steps": steps, "evolve_s": ev, "ms_per_step": 1e3 * ev / steps,
            "particle_updates_per_s": N * steps / ev, "peak_bytes": peak,
            "realize_s": sim.timings["realize_s"], "launches": counts, "stats": dict(st),
            "kick_memory": memory}


def _pm_kick_memory(sim, state) -> dict:
    """Device memory (bytes) of one PM-only kernel-path kick on the state:
    allocated before; the peak of the whole kick; then the kick's pieces
    one by one, each with its peak and what it leaves allocated: the
    block sort, the row-10 deposit, the potential and its three gradient
    grids, the row-11 gather (D = 3) and its unsort; and, beside the kick,
    the power spectrum the run's output writes (PCS, interlaced, on the
    PM grid: example_basic's powerspec defaults)."""
    import torch

    from concept_tpu_torch.analysis.powerspec import powerspec
    from concept_tpu_torch.forces.pm import (
        gravity_potential_slab, pm_gravity_momentum_updates, potential_gradient_grids,
    )
    from concept_tpu_torch.grid.bucketed import deposit_bucketed, gather_bucketed, sort_blocks
    from concept_tpu_torch.grid.fft import rfft3

    cfg = sim.config
    n, box, m = cfg.potential_gridsize, cfg.boxsize, sim.spec.mass
    _sync()
    out = {"before": torch.cuda.memory_allocated()}

    def piece(name, fn):
        _sync()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        _sync()
        out[name] = {"peak": torch.cuda.max_memory_allocated(),
                     "after": torch.cuda.memory_allocated()}
        return res

    piece("kick", lambda: pm_gravity_momentum_updates(
        [state.pos], [m], n, box, cfg.G, 1e-3, deposit_method="pallas"))
    sb = piece("sort_blocks", lambda: sort_blocks(state.pos, n, box))
    grid = piece("deposit", lambda: deposit_bucketed(sb, m, n))
    grads = piece("potential_gradients", lambda: potential_gradient_grids(
        gravity_potential_slab(rfft3(grid / (box / n) ** 3), n, box, cfg.G, deconv_order=4),
        n, box))
    del grid
    piece("gather", lambda: gather_bucketed(sb, grads, n))
    del sb, grads
    piece("powerspec", lambda: powerspec(state.pos, n, box, sim.spec.N))
    gib = {k: (v if isinstance(v, int) else v["peak"]) / 2**30 for k, v in out.items()}
    print("  one kick's device memory, GiB (allocated before, then each piece's peak): "
          + ", ".join(f"{k} {v:.2f}" for k, v in gib.items()))
    return out


def _timed_steps(sim, state, int1: float, int2: float, n_steps: int, rebucket: bool):
    """n_steps bucket steps (a rebucket after every sim.rebucket_every-th
    when ``rebucket``) between two syncs: (state, seconds per step, the
    stragglers of each step)."""
    _sync()
    stragglers = []
    t0 = time.perf_counter()
    for i in range(n_steps):
        state, ns = sim.step(state, int1, int2)
        stragglers.append(ns)
        if rebucket and (i + 1) % sim.rebucket_every == 0:
            state = sim.maybe_rebucket(state)
    _sync()
    return state, (time.perf_counter() - t0) / n_steps, stragglers


def bucket_flagship(n: int = 512) -> dict:
    """bench.py's flagship shape (bench.py:33-75): an n³ lattice with a
    uniform ±0.3-cell jitter on grid n (every block holds 8 particles),
    capacity 8, zero momenta, a warm-up step and 5 timed steps of ᔑ = 1e-3."""
    import torch

    from concept_tpu_torch.bucketsim import BucketSimulation
    from concept_tpu_torch.components import periodic_wrap

    box, N = 512.0, n**3
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    lin = (torch.arange(n, device=dev, dtype=torch.float32) + 0.5) * (box / n)
    axes = (lin[:, None, None], lin[None, :, None], lin[None, None, :])
    jit = 0.3 * box / n
    pos = tuple(periodic_wrap(ax.expand(n, n, n).reshape(-1) + jit * (
        2 * torch.rand(N, generator=gen, device=dev) - 1), box) for ax in axes)
    mom = tuple(torch.zeros(N, device=dev) for _ in range(3))
    sim = BucketSimulation(n, box, 2.0, 1.0, capacity=8)
    state = sim.init_state(pos, mom)
    del pos, mom
    if int(state.valid.sum()) != N or sim.capacity != 8:
        raise SystemExit(f"the flagship lattice did not fit capacity 8 ({sim.capacity})")
    _reset_counts()
    state, _ = sim.step(state, 1e-3, 1e-3)
    state, dt, stragglers = _timed_steps(sim, state, 1e-3, 1e-3, 5, rebucket=False)
    counts = _read_counts()
    _check_launches(counts, BUCKET_KERNELS)
    if not torch.isfinite(state.pos).all():
        raise SystemExit("the flagship state is not finite")
    peak = torch.cuda.max_memory_allocated()
    print(f"BucketSimulation flagship ({n}³ jittered lattice, grid {n}, capacity 8): "
          f"{1e3 * dt:.2f} ms per step, {N / dt:.4g} particle updates/s, peak device "
          f"memory {peak / 2**30:.2f} GiB, stragglers {stragglers}, launches {counts}")
    split = _step_split(sim, state, 3)
    return {"N": N, "ms_per_step": 1e3 * dt, "particle_updates_per_s": N / dt,
            "peak_bytes": peak, "stragglers": stragglers, "launches": counts,
            "device_ms_per_step_by_group": split}


# device-time groups of a bucket step: rows 8 and 9, and the rest
STEP_GROUPS = (("deposit_blocks", ("deposit_tile_kernel",)),
               ("gather_blocks", ("gather_tile_kernel",)),
               ("cuFFT", ("fft", "FFT")))


def _step_split(sim, state, n_steps: int, groups=STEP_GROUPS) -> dict:
    """Device milliseconds a bucket step by group of kernels, over n_steps
    profiled steps (torch.profiler); prints the 6 costliest kernels too."""
    kernels = {}
    split, _ = _device_split(lambda: _timed_steps(sim, state, 1e-3, 1e-3, n_steps,
                                                  rebucket=False), groups, kernels)
    split = {g: 1e3 * v / n_steps for g, v in split.items()}
    total = sum(split.values())
    print(f"  device time a step {total:.2f} ms: " + ", ".join(
        f"{g} {v:.2f} ms ({100 * v / total:.1f} %)"
        for g, v in sorted(split.items(), key=lambda kv: -kv[1])))
    print("  costliest kernels, ms a step: " + "; ".join(
        f"{1e3 * v / n_steps:.2f} {k[:70]}"
        for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]))
    return split


def bucket_sustained(n: int = 256, a_end: float = 0.12) -> dict:
    """bench.py's sustained shape (bench.py:318-385): n³ particles in a box
    n Mpc wide (example_basic's cosmology), 2LPT initial conditions at
    a = 0.02, as bench.py:349 takes them, evolved to
    a_end on grid n, the capacity settled (rebucket, step, rebucket,
    step), then one rebucket cadence (16 steps and a rebucket) timed; then
    rows 8 and 9 against their plain versions on the rebucketed final
    slots."""
    import torch

    from concept_tpu_torch.bucketsim import BucketSimulation
    from concept_tpu_torch.ic import realize_particles
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import build_components, build_cosmology

    cfg = load_params(PARAM, overrides=[
        f"initial_conditions={{'species':'matter','N':{n}**3}}", f"boxsize={n}*Mpc"])
    _, consts, bg, lin = build_cosmology(cfg)
    spec, _ = build_components(cfg, bg, consts)[0]
    torch.cuda.reset_peak_memory_stats()
    sim = BucketSimulation(n, cfg.boxsize, spec.mass, consts.G_Newton, bg=bg, capacity=16)
    st0 = realize_particles(lin, spec, cfg.boxsize, 0.02, seed=0, lpt_order=2, device="cuda")
    state = sim.init_state(st0.pos, st0.mom)
    del st0
    _reset_counts()
    t0 = time.perf_counter()
    state = sim.evolve(state, float(bg.t_of_a_np(0.02)), float(bg.t_of_a_np(a_end)))
    _sync()
    evolve_s = time.perf_counter() - t0
    evolve_steps = sim.stats["steps"]
    t_now = float(bg.t_of_a_np(a_end))
    int1 = bg.integrals_np(t_now, t_now * 1.01, keys=("a**(-1)",))["a**(-1)"]
    int2 = bg.integrals_np(t_now, t_now * 1.01, keys=("a**(-2)",))["a**(-2)"]
    for _ in range(2):
        state = sim.maybe_rebucket(state)
        state, _ = sim.step(state, int1, int2)
    state, dt, stragglers = _timed_steps(sim, state, int1, int2, sim.rebucket_every,
                                         rebucket=True)
    counts = _read_counts()
    _check_launches(counts, BUCKET_KERNELS)
    if not torch.isfinite(state.pos).all() or int(state.valid.sum()) != spec.N:
        raise SystemExit("the sustained state lost particles or is not finite")
    peak = torch.cuda.max_memory_allocated()
    print(f"BucketSimulation sustained ({n}³, grid {n}, 2LPT, a 0.02 → {a_end}: "
          f"{evolve_steps} steps in {evolve_s:.1f} s): {1e3 * dt:.2f} ms per step over "
          f"{sim.rebucket_every} steps and a rebucket, {spec.N / dt:.4g} particle "
          f"updates/s, capacity {sim.capacity}, spilled {sim._n_spilled}, stragglers "
          f"{stragglers}, peak device memory {peak / 2**30:.2f} GiB, launches {counts}")
    final = _check_slot_pm("block kernels vs plain on the final slots", state.pos,
                           state.valid, spec.mass, consts.G_Newton, None, n, cfg.boxsize, 2)
    return {"N": spec.N, "evolve_steps": evolve_steps, "evolve_s": evolve_s,
            "ms_per_step": 1e3 * dt, "particle_updates_per_s": spec.N / dt,
            "capacity": sim.capacity, "spilled": sim._n_spilled, "stragglers": stragglers,
            "peak_bytes": peak, "launches": counts, "final_slots": final}


P3M_KERNELS = ("pair_sweep_global", "deposit_blocks", "gather_blocks")
RUNGS_GLOBAL_KERNELS = ("pair_sweep_global", "pair_sweep_subset", "deposit_pm", "gather_pm")
LEAN_KERNELS = ("deposit_cells", "gather_cells")


def p3m_persistent(n: int = 256, mesh: int = 512, a_end: float = 0.025,
                   n_steps: int = 5, device: str = "cuda") -> dict:
    """bench.py's persistent P³M shape (bench_p3m_persistent) in
    example_basic's cosmology and box at n³ on grid `mesh`: 2LPT initial
    conditions at a = 0.02, ``P3MSimulation.evolve`` to a_end, one
    ``autotune_margin`` over its three candidates, then n_steps timed
    steps.  Only rows 6, 8 and 9 may launch.  Then rows 6, 8 and 9
    against their plain versions on the final slots: the sweep on the
    stored layout, the deposit and gather on the PM blocks its valid
    slots fill."""
    import torch

    from concept_tpu_torch.forces.shortrange import SENTINEL
    from concept_tpu_torch.ic import realize_particles
    from concept_tpu_torch.p3msim import P3MSimulation, autotune_margin

    cfg, consts, bg, lin, spec, soft = _example(n, mesh)
    box, m, G = cfg.boxsize, spec.mass, consts.G_Newton
    _sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st0 = realize_particles(lin, spec, box, 0.02, seed=0, lpt_order=2, device=device)
    sim = P3MSimulation(n, box, m, G, mesh=mesh, bg=bg, softening=soft,
                        softening_kernel=cfg.softening_kernel)
    state = sim.init_state(st0.pos.T.unbind(0), st0.mom.T.unbind(0))
    del st0
    _sync()
    setup_s = time.perf_counter() - t0
    peaks = {}

    def stage_peak(name):  # the peak device memory of a stage, then reset
        _sync()
        peaks[name] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    stage_peak("realize_and_bucketize")
    _reset_counts()
    t0 = time.perf_counter()
    state = sim.evolve(state, float(bg.t_of_a_np(0.02)), float(bg.t_of_a_np(a_end)))
    _sync()
    evolve_s = time.perf_counter() - t0
    evolve_steps = sim.stats["steps"]
    stage_peak("evolve")
    state, tune = autotune_margin(sim, state)
    stage_peak("autotune")
    t_now = float(bg.t_of_a_np(a_end))
    dt = sim._timestep(a_end, 0.0)
    int1 = bg.integrals_np(t_now, t_now + 0.5 * dt, keys=("a**(-1)",))["a**(-1)"]
    int2 = bg.integrals_np(t_now, t_now + dt, keys=("a**(-2)",))["a**(-2)"]
    state, _ = sim.step(state, int1, int2)
    _sync()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, _ = sim.step(state, int1, int2)
        if sim.needs_rebucket:
            state = sim.rebucket(state)
    _sync()
    step_s = (time.perf_counter() - t0) / n_steps
    stage_peak("timed_steps")
    counts = _read_counts()
    _check_launches(counts, P3M_KERNELS)
    st = sim.stats
    if st["pm_mass_warnings"] or st["budget_warnings"]:
        raise SystemExit(f"P3MSimulation: {st['pm_mass_warnings']} mass warnings, "
                         f"{st['budget_warnings']} budgets exceeded")
    if not torch.isfinite(state.pos).all() or int(state.valid.sum()) != n**3:
        raise SystemExit("the P3MSimulation state lost particles or is not finite")
    peak = max(peaks.values())
    print(f"P3MSimulation ({n}³, grid {mesh}, 2LPT, a 0.02 → {a_end}: {evolve_steps} "
          f"steps in {evolve_s:.2f} s; setup {setup_s:.1f} s): autotune "
          f"{ {k: round(1e3 * v, 2) for k, v in tune.items()} } ms a step → margin "
          f"{sim.margin_frac} ({sim.nc}³ cells, K {sim.capacity}); {1e3 * step_s:.2f} ms "
          f"per step over {n_steps}, {n**3 / step_s:.4g} particle updates/s, peak device "
          f"memory {peak / 2**30:.2f} GiB (" + ", ".join(
              f"{k} {v / 2**30:.2f}" for k, v in peaks.items()) +
          f"), rebuckets {st['rebuckets']}, binding refreshes "
          f"{st['binding_refreshes']}, largest PM overflow {st['pm_overflow_max']}, "
          f"launches {counts}")
    pos_s = torch.where(state.valid[None], state.pos, SENTINEL * box).contiguous()
    print(f"kernels vs plain on the final slots: {sim.nc}³ cells, K = {sim.capacity}")
    ext = sim._extents(state)
    sweep = _check_sweep("two-sided, final", pos_s, sim, (ext, ext), 5, 1, reach="global")
    del pos_s
    flat = state.pos.reshape(3, -1)[:, state.valid.reshape(-1)]
    from concept_tpu_torch.forces.p3m import block_layout

    lay = block_layout(*flat, mesh, box, sim.k_pm)
    del flat, state
    pm = _check_slot_pm("PM blocks of the final slots", lay["slots"], lay["valid"], m, G,
                        sim.scale, mesh, box, 2, lay["ext"])
    return {"N": n**3, "mesh": mesh, "evolve_steps": evolve_steps, "evolve_s": evolve_s,
            "autotune_s_per_step": tune, "margin_frac": sim.margin_frac, "nc": sim.nc,
            "capacity": sim.capacity, "ms_per_step": 1e3 * step_s,
            "particle_updates_per_s": n**3 / step_s, "peak_bytes": peak,
            "peak_bytes_by_stage": peaks, "stats": dict(st), "launches": counts,
            "sweep_final": sweep, "pm_final": pm}


def global_rungs(n: int = 64, mesh: int = 128, extra_steps: int = 2,
                 device: str = "cuda", dtype=None) -> dict:
    """``rungs.evolve_rungs_p3m`` on example_basic (n³, grid `mesh`, its
    N_rungs) from 2LPT initial conditions at a = 0.02, one base step a
    call, until a particle takes a rung above 0 and then `extra_steps`
    more (no entry point runs this stepper yet, so the phase stays
    short): the long range through rows 10-11 each base step, the rungs
    from the two-sided sweep (row 6), the substeps through
    ``on_subset`` (row 2's ``pair_sweep_subset``).  Then row 2 against
    its plain version on the last substep's receiver set (every particle:
    the last substep fires rung 0).  In float64 (``dtype``) the same rows
    must launch in double only."""
    import torch

    from concept_tpu_torch.device import resolve_device
    from concept_tpu_torch.forces.shortrange import SENTINEL, bucketize, cell_counts
    from concept_tpu_torch.rungs import evolve_rungs_p3m
    from concept_tpu_torch.sim import SimConfig, Simulation

    cfg, consts, bg, lin, spec, soft = _example(n, mesh)
    config = SimConfig(boxsize=cfg.boxsize, potential_gridsize=mesh,
                       device=resolve_device(device), dtype=dtype or torch.float32,
                       G=consts.G_Newton, softening=soft,
                       softening_kernel=cfg.softening_kernel)
    sim = Simulation(spec, config, bg, lin)
    state = sim.initial_state(cfg.a_begin, seed=0, lpt_order=2)
    stats = {}
    _reset_counts()
    t0 = time.perf_counter()
    a, calls, left = cfg.a_begin, 0, extra_steps
    while left and a < 1.0:
        t = float(bg.t_of_a_np(a))
        a_next = min(1.0, float(bg.a_of_t_np(t + sim.timestep_size(a))))
        # max_steps 3: the a(t) round trip may leave a sliver step
        state, a = evolve_rungs_p3m(sim, state, a, a_next, N_rungs=cfg.N_rungs,
                                    max_steps=3, stats=stats)
        calls += 1
        left -= stats["max_rung"] > 0
    _sync()
    seconds = time.perf_counter() - t0
    counts, counts64 = _read_counts(), _read_counts_f64()
    if dtype == torch.float64:
        _check_launches(counts, ())
        counts = counts64
    else:
        _check_launches(counts64, ())
    _check_launches(counts, RUNGS_GLOBAL_KERNELS)
    if not torch.isfinite(state.pos).all() or not torch.isfinite(state.mom).all():
        raise SystemExit("the global-rungs state is not finite")
    print(f"global rungs (example_basic, {n}³, grid {mesh}, 2LPT, {state.pos.dtype}, "
          f"a {cfg.a_begin} → "
          f"{a:.4g} in {calls} base steps, N_rungs {cfg.N_rungs}): {seconds:.2f} s, "
          f"max rung {stats['max_rung']}, "
          f"receiver rows {stats['receiver_rows']} of {stats['full_rows']} "
          f"({stats['receiver_rows'] / stats['full_rows']:.3f}), launches {counts}")
    cap = max(8, -(-(int(cell_counts(state.pos, cfg.boxsize, sim._sr_ncells).max()) + 1)
                   // 8) * 8)
    b = bucketize(state.pos.unbind(1), cfg.boxsize, sim._sr_ncells, cap)
    slots = torch.where(b["valid"][None], torch.stack([b["hx"], b["hy"], b["hz"]]),
                        SENTINEL * cfg.boxsize).contiguous()
    print(f"row 2 vs plain on the last substep's receivers: {sim._sr_ncells}³ cells, "
          f"K = {cap}")
    ext = _occ(slots, cfg.boxsize)
    sweep = _check_sweep("one-sided, substep", slots, _sweep_geometry(sim), (ext, ext), 10, 1,
                         reach="subset")
    return {"a_end": a, "base_steps": calls, "seconds": seconds, "stats": stats,
            "launches": counts, "subset_sweep": sweep}


def lean_kick(n: int = 384, mesh: int = 768, device: str = "cuda") -> dict:
    """One memory-lean PM kick (``pm_kick_cells_lean``: order-4 stencil
    gradients one at a time, rows 3 and 4, the gather at D = 1 three
    times), as the rung stepper's dispatch takes it at mesh ≥ 768 on the
    card, and one spectral kick (``pm_gradient_cells``) on a copy of the
    same realized n³ state on the mesh-`mesh` 8-mesh-cell layout: each
    kick's peak device memory and the rms difference of the momentum
    changes relative to the spectral kick's rms.  Then the lean kick
    through the plain deposit and gather on the same state, held to the
    kernels' one within max|Δ| ≤ 2e-5·max|ref| (so that the rms difference
    from the spectral kick is the stencil's, not the kernels'), and rows 3
    and 4 (the gather at D = 1 and 3) against their plain versions on the
    layout."""
    from unittest import mock

    import torch

    from concept_tpu_torch import p3msim
    from concept_tpu_torch.grid.cuda_cells import cut_rows, deposit_cells_plain, gather_cells_plain
    from concept_tpu_torch.p3mrungs import pm_kick_rungs

    adapter, state = _realized_layout(n**3, mesh, device)
    inner = adapter.inner
    if inner.ucb != 8 or inner.pm_lean is not None:
        raise SystemExit(f"grid {mesh}: layout ucb {inner.ucb}, pm_lean {inner.pm_lean}")
    K = inner._K_occ
    int_pm = 1e-3
    base = torch.cuda.memory_allocated()
    out = {"N": n**3, "mesh": mesh, "K_rows": K, "state_bytes": base}
    dmom = {}
    for name, lean in (("lean", None), ("spectral", False)):
        state.mom.zero_()  # the kick alone, without cancellation against the momenta
        _sync()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        if lean is None:  # the stepper's own dispatch
            state, _, mass_sum = inner._pm_kick(state, int_pm, k_rows=K)
        else:
            state, _, mass_sum = pm_kick_rungs(
                state, inner.mass, inner.G, int_pm, inner.boxsize, mesh, inner.scale,
                cells_cb=8, k_rows=K, lean=False)
        _sync()
        counts = _read_counts()
        _check_launches(counts, LEAN_KERNELS)
        expect = {"lean": (1, 3), "spectral": (1, 1)}[name]
        if (counts["deposit_cells"], counts["gather_cells"]) != expect:
            raise SystemExit(f"{name} kick launched {counts}, not {expect}")
        # in masses of a particle as the float32 deposit holds it
        m32 = float(torch.tensor(inner.mass, dtype=torch.float32))
        deficit = abs(float(mass_sum) / m32 - inner.N)
        if deficit > 0.5:
            raise SystemExit(f"the {name} kick's deposit lost {deficit:.3g} masses")
        dmom[name] = state.mom[:, :K].to("cpu", copy=True)  # off the card: the next peak is its own
        out[name] = {"seconds": time.perf_counter() - t0,
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "peak_above_state_bytes": torch.cuda.max_memory_allocated() - base,
                     "launches": counts, "mass_deficit": deficit}
    out["launches"] = out["lean"]["launches"]
    # the same lean kick through the plain deposit and gather: what the
    # kernels add to its difference from the spectral kick
    state.mom.zero_()
    def gather_plain(pos3, w, grids, n, box, cb, ext=None, planes=None):
        return gather_cells_plain(pos3, cut_rows(w, ext), grids, n, box, cb, planes=planes)

    with mock.patch.object(p3msim, "deposit_cells", deposit_cells_plain), \
            mock.patch.object(p3msim, "gather_cells", gather_plain):
        _reset_counts()
        state, _, _ = inner._pm_kick(state, int_pm, k_rows=K)
        _check_launches(_read_counts(), ())
    dmom["lean_plain"] = state.mom[:, :K].to("cpu", copy=True)
    valid = state.valid[:K].cpu()
    d = {k: v[:, valid] for k, v in dmom.items()}
    del dmom

    def rms_rel(a, b):
        return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())

    rel = out["rms_diff_rel"] = rms_rel(d["lean"], d["spectral"])
    rel_plain = out["plain_rms_diff_rel"] = rms_rel(d["lean_plain"], d["spectral"])
    _, kern_rel = _max_rel(d["lean"], d["lean_plain"])
    out["kernels_vs_plain_max_rel"] = kern_rel
    kern_rms = out["kernels_vs_plain_rms_rel"] = rms_rel(d["lean"], d["lean_plain"])
    del d
    if not 0 < rel < 0.2:
        raise SystemExit(f"the lean kick differs from the spectral one by {rel:.3g} rms")
    if not kern_rel <= 2e-5:
        raise SystemExit(f"the lean kick through rows 3-4 differs from the one through "
                         f"their plain versions by {kern_rel:.3g} of the largest")
    print(f"lean PM kick ({n}³, grid {mesh}, cb 8, K {K}): peak device memory lean "
          f"{out['lean']['peak_bytes'] / 2**30:.2f} GiB against spectral "
          f"{out['spectral']['peak_bytes'] / 2**30:.2f} GiB (state {base / 2**30:.2f} GiB); "
          f"{out['lean']['seconds']:.3f} s against {out['spectral']['seconds']:.3f} s; rms "
          f"of the difference {rel:.3e} of the spectral kick's ({rel_plain:.3e} through "
          f"the plain deposit and gather); the kernels' lean kick against the plain one: "
          f"max|Δ|/max|ref| {kern_rel:.3e} (tol 2e-5), rms {kern_rms:.3e}; launches lean "
          f"{out['lean']['launches']}, spectral {out['spectral']['launches']}")
    # rows 3 and 4 against their plain versions on this layout, the gather
    # at the lean kick's D = 1 and at the spectral kick's D = 3
    out.update(_check_slot_pm("cells of the lean kick", state.pos[:, :K], state.valid[:K],
                              inner.mass, inner.G, inner.scale, mesh, inner.boxsize, 8,
                              inner._ext_occ, D=(1, 3)))
    return out


def lpt(n: int = 256, device: str = "cuda") -> dict:
    """The 2LPT and 3LPT realizations of example_basic at n³ (time and
    peak device memory each, after a 1LPT warm-up), then the CLI's two
    calls on param/example_pm_quick.py (2LPT, 32³, PM grid 64,
    interlaced) to a = 1 with its outputs cut to the power spectra: its
    interlaced PM takes no hand kernel, and none may launch."""
    import torch

    from concept_tpu_torch.ic import realize_particles

    cfg, _, bg, lin, spec, _ = _example(n, 2 * n)
    out = {"N": n**3}
    for order in (1, 2, 3):
        _sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st = realize_particles(lin, spec, cfg.boxsize, cfg.a_begin, seed=0,
                               lpt_order=order, device=device)
        _sync()
        seconds = time.perf_counter() - t0
        if not torch.isfinite(st.pos).all() or not torch.isfinite(st.mom).all():
            raise SystemExit(f"the {order}LPT realization is not finite")
        out[f"lpt{order}"] = {"seconds": seconds,
                              "peak_bytes": torch.cuda.max_memory_allocated()}
        del st
    print(f"LPT realizations ({n}³, example_basic, a {cfg.a_begin}): " + ", ".join(
        f"{o}LPT {out[f'lpt{o}']['seconds']:.3f} s, peak "
        f"{out[f'lpt{o}']['peak_bytes'] / 2**30:.2f} GiB" for o in (1, 2, 3)))
    outdir = tempfile.mkdtemp(prefix="chip_smoke_pm_quick_")
    try:
        sim, _, a, counts, seconds = _run(
            ["output_times={'powerspec': [0.1, 0.3, 1.0]}"], outdir, kernels=(),
            device=device, param=os.path.join(ROOT, "param", "example_pm_quick.py"))
        spectra = sorted(f for f in os.listdir(outdir) if f.startswith("powerspec"))
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    print(f"example_pm_quick (2LPT, 32³, PM grid 64, interlaced, a → {a:.4g}): "
          f"{sim.stats['steps']} steps, wall {seconds:.1f} s, {len(spectra)} power "
          f"spectra, launches {counts}")
    out["pm_quick"] = {"a_end": a, "steps": sim.stats["steps"], "wall_s": seconds,
                       "spectra": spectra, "launches": counts}
    return out


class _HostPeak:
    """The peak resident host memory of the process above its size at
    entry, sampled every 2 ms from /proc/self/statm by a thread."""

    def __enter__(self):
        import threading

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.base = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def _sample(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, self._rss())
        self.bytes = self.peak - self.base


def _timed_io(fn):
    """(result, seconds, peak host bytes above the start) of fn()."""
    _sync()
    with _HostPeak() as hp:
        t0 = time.perf_counter()
        out = fn()
        seconds = time.perf_counter() - t0
    return out, seconds, hp.bytes


def _npz_concept(snap):
    """A numpy .npz stand-in for snap.save_concept / snap.load_concept,
    for a machine without h5py: the same arguments and results, the file
    at the same name."""
    import numpy as np

    from concept_tpu_torch.components import ComponentSpec, ParticleState

    def save_concept(filename, meta, components, select=None):
        ((name, (spec, st)),) = components.items()
        arrays = {k: snap._host(v) for k, v in st._asdict().items() if v is not None}
        with open(filename, "wb") as f:
            np.savez(f, **arrays, meta=json.dumps(meta.__dict__),
                     spec=json.dumps([name, spec.species, spec.N, spec.mass]))
        return filename

    def load_concept(filename):
        with np.load(filename) as z:
            name, species, N, mass = json.loads(str(z["spec"]))
            st = ParticleState(**{k: z[k] for k in ("pos", "mom", "ids", "rungs") if k in z})
            meta = snap.SnapshotMeta(**json.loads(str(z["meta"])))
        return meta, {name: (ComponentSpec(name, species, N=N, mass=mass), st)}

    return save_concept, load_concept


def _sigterm_after_base_step(n: int):
    """Wrap P3MRungSimulation.base_step so that SIGTERM is raised in this
    process after its n-th call; returns the function that unwraps it."""
    import signal

    from concept_tpu_torch.p3mrungs import P3MRungSimulation

    step = P3MRungSimulation.base_step
    calls = [0]

    def hooked(self, *args, **kw):
        out = step(self, *args, **kw)
        calls[0] += 1
        if calls[0] == n:
            signal.raise_signal(signal.SIGTERM)
        return out

    P3MRungSimulation.base_step = hooked
    return lambda: setattr(P3MRungSimulation, "base_step", step)


def _dx(a, b, box: float) -> tuple[float, float]:
    """(max, mean) |Δx| / box between two id-sorted position tensors,
    periodic."""
    import torch

    d = (a - b).abs()
    r = torch.minimum(d, box - d).norm(dim=1)
    return float(r.max()) / box, float(r.mean()) / box


def files(n: int = 256, mesh: int = 512, a_end: float = 0.023, device: str = "cuda") -> dict:
    """The run's files at the main path's realistic size: n³ particles on
    grid `mesh` (the 8-mesh-cell rung layout), example_basic's box and
    cosmology, 2LPT at a = 0.02.

    (a) The realized state written as GADGET-2 (format 2, float32, two
        files) and, where h5py imports, as CONCEPT-HDF5, and read back:
        the CONCEPT file gives the float32 state exactly, the GADGET file
        what its float32 kpc/h and km/s hold (the conversion done again
        with numpy) exactly.  Seconds, GB/s, sizes, peak host and device
        memory of each.
    (b) ``run`` from the GADGET file to a_end, dumping a snapshot, a power
        spectrum and a bispectrum ('equilateral 10'), twice: the two
        uninterrupted runs' distance is the atomics' noise floor.
    (c) The same run with SIGTERM raised after base step 2 (a hook around
        the stepper, no timer): it must exit with 128 + 15 and leave an
        autosave; resumed, it must end within max(10 × the floor, 1e-5)
        of the box of (b).  Without h5py the autosave is a .npz
        stand-in for save_concept/load_concept, inside this phase only.
    (d) ``-u info`` and ``-u powerspec`` of the GADGET file through
        ``cli.main``, on the card.
    (e) The bispectrum at grid `mesh` alone: seconds and peak device
        memory.
    Every run launches rows 1, 3 and 4 only."""
    import numpy as np
    import torch

    from concept_tpu_torch import cli
    from concept_tpu_torch.analysis.bispec import bispec
    from concept_tpu_torch.ic import realize_particles
    from concept_tpu_torch.io import snapshot as snap
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import autosave_path, run

    try:
        import h5py  # noqa: F401

        have_h5py = True
    except ImportError:
        have_h5py = False
        print("files: no h5py on this machine; the autosave used a .npz stand-in")
    cfg, _, bg, lin, spec, _ = _example(n, mesh)
    box, units = cfg.boxsize, cfg.units
    N = n**3
    st = realize_particles(lin, spec, box, 0.02, seed=0, lpt_order=2, device=device)
    st = st._replace(ids=torch.arange(N, dtype=torch.int32, device=device))
    meta = snap.SnapshotMeta(a=0.02, boxsize=box, H0=cfg.H0, Omega_b=cfg.Omega_b,
                             Omega_cdm=cfg.Omega_cdm)
    root = tempfile.mkdtemp(prefix="chip_smoke_files_")
    out = {"N": N, "mesh": mesh, "h5py": have_h5py}
    try:
        # (a) write and read
        base = os.path.join(root, "ic")
        torch.cuda.reset_peak_memory_stats()
        files_written, w_s, w_host = _timed_io(lambda: snap.save_gadget_multifile(
            base, meta, spec, st, units, particles_per_file=N // 2))
        size = sum(os.path.getsize(f) for f in files_written)
        (rmeta, comps), r_s, r_host = _timed_io(lambda: snap.load(base, units))
        ((_, (rspec, rst)),) = comps.items()
        # what the file holds: x/(kpc/h) and mom/(a^1.5·m)/(km/s) in float32
        _, kpc_h, _, kms = snap._gadget_units(cfg.H0, units)
        pos32 = st.pos.cpu().numpy()
        want_pos = (pos32.astype(np.float64) / kpc_h).astype(np.float32).astype(np.float64) * kpc_h
        vel = (st.mom.cpu().numpy().astype(np.float64) / (0.02**1.5 * spec.mass) / kms)
        want_mom = vel.astype(np.float32).astype(np.float64) * kms * 0.02**1.5 * rspec.mass
        if not (np.array_equal(rst.pos, want_pos) and np.array_equal(rst.mom, want_mom)
                and np.array_equal(rst.ids, np.arange(N)) and rspec.N == N):
            raise SystemExit("files: the GADGET file does not read back what it holds")
        f32_err = float(np.abs(rst.pos.astype(np.float32) - pos32).max()) / box
        out["gadget"] = {"write_s": w_s, "read_s": r_s, "bytes": size,
                         "write_GBps": size / w_s / 1e9, "read_GBps": size / r_s / 1e9,
                         "write_host_peak_bytes": w_host, "read_host_peak_bytes": r_host,
                         "pos_float32_max_err_over_box": f32_err,
                         "device_peak_bytes": torch.cuda.max_memory_allocated()}
        del rst, comps, want_pos, want_mom, vel
        line = (f"files ({n}³, a = 0.02, 2LPT): GADGET-2 format 2 float32 in 2 files, "
                f"{size / 1e9:.3f} GB: write {w_s:.2f} s ({size / w_s / 1e9:.2f} GB/s, "
                f"host peak +{w_host / 2**30:.2f} GiB), read {r_s:.2f} s "
                f"({size / r_s / 1e9:.2f} GB/s, host peak +{r_host / 2**30:.2f} GiB), "
                f"exact against its float32 kpc/h (max |x_read − x|/box {f32_err:.2e})")
        if have_h5py:
            fn = os.path.join(root, "ic.hdf5")
            _, cw_s, cw_host = _timed_io(lambda: snap.save_concept(
                fn, meta, {spec.name: (spec, st)}))
            csize = os.path.getsize(fn)
            (_, comps), cr_s, cr_host = _timed_io(lambda: snap.load_concept(fn))
            ((_, (_, cst)),) = comps.items()
            if not (np.array_equal(cst.pos.astype(np.float32), pos32)
                    and np.array_equal(cst.mom.astype(np.float32), st.mom.cpu().numpy())):
                raise SystemExit("files: the CONCEPT-HDF5 file does not read back exactly")
            out["concept"] = {"write_s": cw_s, "read_s": cr_s, "bytes": csize,
                              "write_GBps": csize / cw_s / 1e9, "read_GBps": csize / cr_s / 1e9,
                              "write_host_peak_bytes": cw_host,
                              "read_host_peak_bytes": cr_host}
            del cst, comps
            line += (f"; CONCEPT-HDF5 {csize / 1e9:.3f} GB: write {cw_s:.2f} s "
                     f"({csize / cw_s / 1e9:.2f} GB/s), read {cr_s:.2f} s "
                     f"({csize / cr_s / 1e9:.2f} GB/s), exact")
        print(line + f"; device peak {out['gadget']['device_peak_bytes'] / 2**30:.2f} GiB")
        del st, pos32

        # (b) two uninterrupted runs from the file
        overrides = [f"initial_conditions='{base}'", f"potential_options={mesh}",
                     f"output_times={{'powerspec': [{a_end}], 'snapshot': [{a_end}], "
                     f"'bispec': [{a_end}]}}",
                     "snapshot_type='gadget'", f"gadget_snapshot_params={{'particles per file': "
                     f"{N // 2}}}"]
        runs = []
        for i in range(2):
            outdir = os.path.join(root, f"run{i}")
            sim, state, a, counts, seconds = _run(overrides, outdir, device=device)
            if sim.inner.ucb != 8:
                raise SystemExit(f"files: grid {mesh} took ucb = {sim.inner.ucb}, not 8")
            dumped = sorted(os.listdir(outdir))
            pk = np.loadtxt(os.path.join(outdir, f"powerspec_a={a_end:.4g}.txt"))
            bk = np.loadtxt(os.path.join(outdir, f"bispec_a={a_end:.4g}.txt"))
            if not (np.all(np.isfinite(bk[:, :5])) and len(bk) == 10):
                raise SystemExit("files: the bispectrum is not 10 finite triangles")
            runs.append({"pos": state.pos, "pk": pk, "launches": counts, "wall_s": seconds,
                         "steps": sim.hysteresis["step_count"],
                         "max_rung": sim.inner.stats["max_rung"], "dump_s": sim.timings["dump_s"],
                         "evolve_s": sim.timings["evolve_s"], "files": dumped})
            shutil.rmtree(outdir, ignore_errors=True)
        floor, floor_mean = _dx(runs[0]["pos"], runs[1]["pos"], box)
        print(f"files: run from the GADGET file to a = {a_end} (snapshot, power spectrum, "
              f"bispectrum): {runs[0]['steps']} base steps, max rung {runs[0]['max_rung']}, "
              f"wall {runs[0]['wall_s']:.1f} / {runs[1]['wall_s']:.1f} s (dumps "
              f"{runs[0]['dump_s']:.1f} s), wrote {runs[0]['files']}; two uninterrupted "
              f"runs part by max |Δx|/box {floor:.3e} (mean {floor_mean:.3e}); launches "
              f"{runs[0]['launches']}")

        # (c) SIGTERM after base step 2, then the resume
        outdir = os.path.join(root, "interrupted")
        save, load = snap.save_concept, snap.load_concept
        if not have_h5py:
            snap.save_concept, snap.load_concept = _npz_concept(snap)
        unhook = _sigterm_after_base_step(2)
        try:
            rcfg = load_params(PARAM, overrides=overrides + [f"output_dirs='{outdir}'"])
            _reset_counts()
            try:
                run(rcfg, device=device)
                raise SystemExit("files: the run went on after SIGTERM")
            except SystemExit as e:
                code = e.code
            finally:
                unhook()
            counts_int = _read_counts()
            _check_launches(counts_int, RUNG_KERNELS)
            aux_path = os.path.join(autosave_path(rcfg), "auxiliary.json")
            if code != 128 + 15 or not os.path.exists(aux_path):
                raise SystemExit(f"files: SIGTERM gave exit code {code} and autosave "
                                 f"{os.path.exists(aux_path)} (want 143 and an autosave)")
            with open(aux_path) as f:
                aux = json.load(f)
            sim, state, a, counts_res, seconds = _run(overrides, outdir, device=device)
            if os.path.exists(aux_path):
                raise SystemExit("files: the finished resume left its autosave")
        finally:
            snap.save_concept, snap.load_concept = save, load
        pk = np.loadtxt(os.path.join(outdir, f"powerspec_a={a_end:.4g}.txt"))
        dx, dx_mean = _dx(state.pos, runs[0]["pos"], box)
        pk_rel = float(np.max(np.abs(pk[:, 2] / runs[0]["pk"][:, 2] - 1)))
        pk_floor = float(np.max(np.abs(runs[1]["pk"][:, 2] / runs[0]["pk"][:, 2] - 1)))
        allowed = max(10 * floor, 1e-5)
        print(f"files: SIGTERM after base step 2 → exit {code}, autosave at a = "
              f"{aux['a']:.6g} (step {aux['step_total']}, t_mom ≠ t); resumed to a = {a:.4g} "
              f"in {seconds:.1f} s: max |Δx|/box {dx:.3e} (mean {dx_mean:.3e}) from the "
              f"uninterrupted run "
              f"(allowed {allowed:.1e}), power spectrum largest relative difference "
              f"{pk_rel:.2e} (between the uninterrupted runs {pk_floor:.2e}); launches "
              f"interrupted {counts_int}, resumed {counts_res}")
        if dx > allowed:
            raise SystemExit(f"files: the resume ended {dx:.3e} of the box from the "
                             f"uninterrupted run (allowed {allowed:.1e})")
        out["runs"] = [{k: v for k, v in r.items() if k not in ("pos", "pk")} for r in runs]
        out["launches"] = runs[0]["launches"]
        out["resume"] = {"exit_code": code, "autosave_a": aux["a"],
                         "autosave_step": aux["step_total"], "max_dx_over_box": dx,
                         "mean_dx_over_box": dx_mean, "floor_max_dx_over_box": floor,
                         "floor_mean_dx_over_box": floor_mean, "allowed": allowed,
                         "pk_max_rel": pk_rel, "floor_pk_max_rel": pk_floor,
                         "launches_interrupted": counts_int, "launches_resumed": counts_res}
        del runs, state

        # (d) the utilities on the card
        _reset_counts()
        t0 = time.perf_counter()
        dev_flag = [] if device == "cuda" else ["--device", device]  # the card by default
        if (cli.main([*dev_flag, "-u", "info", base]) != 0
                or cli.main([*dev_flag, "-u", "powerspec", base]) != 0):
            raise SystemExit("files: -u info / -u powerspec failed")
        _sync()
        util_s = time.perf_counter() - t0
        pk = np.loadtxt(f"{base}_powerspec_GADGET halo.txt")
        if not np.all(np.isfinite(pk[:, :3])):
            raise SystemExit("files: -u powerspec wrote a spectrum that is not finite")
        _check_launches(_read_counts(), ())
        out["utilities_s"] = util_s
        print(f"files: -u info and -u powerspec (grid {2 * n}) of the GADGET file on the "
              f"card: {util_s:.1f} s")

        # (e) the bispectrum at grid `mesh`
        pos = torch.as_tensor(snap.load(base, units)[1]["GADGET halo"][1].pos,
                              device=device).to(torch.float32)
        bispec([pos], [1.0], mesh, box, configuration="equilateral 10")  # warm-up
        _sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        bk = bispec([pos], [1.0], mesh, box, configuration="equilateral 10")
        _sync()
        out["bispec"] = {"seconds": time.perf_counter() - t0,
                         "peak_bytes": torch.cuda.max_memory_allocated(),
                         "finite": bool(np.all(np.isfinite(bk["B"])))}
        print(f"files: bispectrum ({n}³, grid {mesh}, equilateral 10): "
              f"{out['bispec']['seconds']:.2f} s, peak device memory "
              f"{out['bispec']['peak_bytes'] / 2**30:.2f} GiB")
        if not out["bispec"]["finite"]:
            raise SystemExit("files: the bispectrum is not finite")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out

# --------------------------------------------------------------------- #
# float64 (enable_float64) and PP gravity

def check_f64() -> dict:
    """Each of rows 1-11 in double against its float64 plain version, at
    the float check's shapes (realized 128³ states on grid 256: the
    8-mesh-cell and 4-mesh-cell rung layouts, the global stepper's slots
    and blocks, and 256³ sorted by PM block on grid 256), within 1e-10 of
    the largest plain value, with bounds at the FP64 rate and 8-byte
    values, and the library calls in float64."""
    import torch

    f64 = torch.float64
    print("float64: each kernel's double instantiation against its float64 plain version")
    return {"rungs": check_kernels(dtype=f64), "global": check_global_kernels(dtype=f64),
            "reach": check_reach_kernels(dtype=f64), "pm_only": check_pm_only_kernels(dtype=f64)}


def _pk_rel(pk64, pk32, mesh: int) -> float:
    """Largest |P64/P32 − 1| at k below a quarter of the Nyquist
    frequency (k_f·mesh/8, k_f the first bin's k)."""
    import numpy as np

    a, b = np.asarray(pk64), np.asarray(pk32)
    sel = a[:, 0] < a[:, 0].min() * mesh / 8
    return float(np.max(np.abs(a[sel, 2] / b[sel, 2] - 1)))


# (tag, overrides, kernels, float32 phase with its evolution seconds)
F64_PATHS = (
    ("rungs", [], RUNG_KERNELS, "main_path"),
    ("global", ["N_rungs=1"], GLOBAL_KERNELS, "global_main_path"),
    ("pm_only", [PM_ONLY], PM_KERNELS, "pm_only_main_path"),
    ("reach", ["initial_conditions={'species':'matter','N':62**3}", "potential_options=124"],
     REACH_KERNELS, "reach_main_path"),
)


def f64_main_paths(results: dict) -> dict:
    """example_basic with ``enable_float64 = True`` through load_params and
    run, a = 0.02 → 1: with rungs (64³, grid 128: rows 1, 3, 4), with
    N_rungs = 1 (rows 6, 8, 9), with PM gravity (rows 10, 11) and at 62³ /
    grid 124 (the 4-mesh-cell layout: rows 5, 3, 4).  Each must launch its
    rows in double and no float kernel, pass the mass-deficit and budget
    checks and write a finite spectrum; beside it the float32 run's
    evolution seconds.  The 'simple' noise of a float64 run is its own
    draw (float64 normals, as the JAX package draws them under x64), so
    the spectra are compared on a pair of rung runs, float32 and float64,
    with the 'distributed' noise, whose uniforms are float32 in both: the
    largest relative difference below a quarter of the Nyquist
    frequency."""
    out = {}
    for tag, over, kernels, ref in F64_PATHS:
        outdir = tempfile.mkdtemp(prefix=f"chip_smoke_f64_{tag}_")
        try:
            sim, state, a, counts, seconds = _run(over, outdir, kernels, f64=True)
        finally:
            shutil.rmtree(outdir, ignore_errors=True)
        steps = sim.hysteresis.get("step_count", 0)
        st = getattr(sim, "inner", sim).stats
        ev, ev32 = sim.timings["evolve_s"], results[ref]["evolve_s"]
        print(f"float64 {tag} path (example_basic{', ' + ', '.join(over) if over else ''}, "
              f"a 0.02 → {a:.4g}): {steps} steps, evolution {ev:.2f} s against float32's "
              f"{ev32:.2f} s ({ev / ev32:.2f}×), largest deposit deficit "
              f"{st['pm_mass_deficit_max']:.3g} particle masses; double launches {counts}")
        out[tag] = {"a_end": a, "steps": steps, "wall_s": seconds, "evolve_s": ev,
                    "evolve_s_f32": ev32, "launches": counts,
                    "pm_mass_deficit_max": st["pm_mass_deficit_max"],
                    "budget_warnings": st["budget_warnings"]}
    spectra = {}
    for f64 in (False, True):
        outdir = tempfile.mkdtemp(prefix="chip_smoke_f64_noise_")
        spectra[f64] = {}
        try:
            _run(["primordial_noise_imprinting='distributed'"], outdir, f64=f64,
                 spectrum=spectra[f64])
        finally:
            shutil.rmtree(outdir, ignore_errors=True)
    rel = _pk_rel(spectra[True]["data"], spectra[False]["data"], 128)
    print(f"float64 against float32 (example_basic with rungs, 'distributed' noise, a = 1): "
          f"spectra within {rel:.3e} below a quarter of the Nyquist frequency")
    out["pk_max_rel_f64_vs_f32"] = rel
    return out


def _kick_of(sim, pos):
    """One kick of the global stepper ``sim`` at unit kick integral on
    positions pos with zero momenta (P³M: its short-range capacity
    refreshed first, as ``evolve`` does, and no overflow budget exceeded):
    the Δmom (N, 3)."""
    import torch

    from concept_tpu_torch.components import ParticleState

    state = sim.kick(ParticleState(pos=pos.clone(), mom=torch.zeros_like(pos)), 1.0)
    if sim.stats["budget_warnings"]:
        raise SystemExit("an overflow budget was exceeded in a P³M kick")
    return state.mom


def _p3m_vs_pp(tag: str, pos, p3m, pp) -> dict:
    """The global P³M kick (rows 6, 8, 9 in double) against the PP + Ewald
    kick on the same positions: rms of the difference over the rms of PP
    (the JAX package's test bound, 0.05)."""
    import torch

    _reset_counts()
    d_p3m = _kick_of(p3m, pos)
    _sync()
    _check_launches(_read_counts(), ())
    _check_launches(_read_counts_f64(), GLOBAL_KERNELS)
    _reset_counts()
    d_pp = _kick_of(pp, pos)
    _sync()
    _check_launches(_read_counts_f64(), ())
    rms = float(torch.sqrt(((d_p3m - d_pp) ** 2).mean()) / torch.sqrt((d_pp**2).mean()))
    print(f"  P³M kick against PP + Ewald ({tag}, {pos.shape[0]} particles, float64): rms "
          f"difference {rms:.4e} of the PP rms (bound 0.05)")
    if not rms < 0.05:
        raise SystemExit(f"P³M against PP ({tag}): rms {rms:.4e} ≥ 0.05")
    return {"rms_rel": rms}


def pp_phase(n: int = 32, a_end: float = 0.023, device: str = "cuda") -> dict:
    """PP gravity ('pp', Ewald gridsize 64) through load_params and run at
    example_basic's box and cosmology with n³ particles in float64, a =
    0.02 → a_end (≥ 3 steps, no kernel: PP is plain PyTorch in the port,
    as it is XLA in the JAX package); one PP kick on its final state
    timed (pairs a second, every ordered pair counted); then one P³M kick
    (grid 2n, rows 6, 8, 9 in double) against one PP kick on a realized
    n³ state and on a clustered one (an n³ rung run in float64 to a = 1,
    rows 1, 3, 4 in double)."""
    import torch

    from concept_tpu_torch.forces.ewald import tabulate_ewald_correction
    from concept_tpu_torch.forces.pp import pp_momentum_updates

    cache = tempfile.mkdtemp(prefix="chip_smoke_ewald_")
    old = os.environ.get("CONCEPT_TPU_CACHE")
    os.environ["CONCEPT_TPU_CACHE"] = cache
    outdir = tempfile.mkdtemp(prefix="chip_smoke_pp_")
    try:
        # the Ewald table (gridsize 64, float64 on the card), tabulated
        # into the empty cache; the run reads it from there
        t0 = time.perf_counter()
        tabulate_ewald_correction(64, device)
        _sync()
        table_s = time.perf_counter() - t0
        sim, state, a, counts, seconds = _run([
            f"initial_conditions={{'species':'matter','N':{n}**3}}",
            "select_forces={'all': {'gravity': 'pp'}}",
            f"output_times={{'powerspec': [{a_end}]}}"], outdir, (), device, f64=True)
        shutil.rmtree(outdir, ignore_errors=True)
        steps = sim.stats["steps"]
        if steps < 3:
            raise SystemExit(f"the PP run took {steps} steps (< 3)")
        cfg = sim.config
        N = sim.spec.N

        def kick():
            return pp_momentum_updates(state.pos, sim.spec.mass, cfg.boxsize, 1.0, cfg.G,
                                       softening=cfg.softening, ewald_table=sim._ewald_table,
                                       softening_kernel=cfg.softening_kernel)

        torch.cuda.reset_peak_memory_stats()
        ms = _time_ms(kick, 3)
        peak = torch.cuda.max_memory_allocated()
        ev = sim.timings["evolve_s"]
        print(f"PP (example_basic, {n}³, gravity pp, float64, a 0.02 → {a:.4g}): {steps} "
              f"steps, {1e3 * ev / steps:.1f} ms per step; one PP kick {ms:.1f} ms "
              f"({N * N / (ms / 1e3):.4g} pairs/s, {N * N} ordered pairs), peak device memory "
              f"{peak / 2**30:.2f} GiB; the Ewald table (65³ points) tabulated in "
              f"{table_s:.2f} s")
        out = {"a_end": a, "steps": steps, "evolve_s": ev, "ms_per_step": 1e3 * ev / steps,
               "kick_ms": ms, "pairs_per_s": N * N / (ms / 1e3), "kick_peak_bytes": peak,
               "ewald_table_s": table_s}
        p3m, flat = _global_sim(N, 2 * n, device, torch.float64)
        pp, _ = _global_sim(N, n, device, torch.float64, method="pp")
        out["realized"] = _p3m_vs_pp("realized at a = 0.02", flat.pos, p3m, pp)
        outdir = tempfile.mkdtemp(prefix="chip_smoke_pp_clustered_")
        _, late, a_late, _, _ = _run([f"initial_conditions={{'species':'matter','N':{n}**3}}",
                                      f"potential_options={2 * n}"], outdir, RUNG_KERNELS,
                                     device, f64=True)
        out["clustered"] = _p3m_vs_pp(f"clustered, a = {a_late:.3g}", late.pos, p3m, pp)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
        shutil.rmtree(cache, ignore_errors=True)
        if old is None:
            os.environ.pop("CONCEPT_TPU_CACHE", None)
        else:
            os.environ["CONCEPT_TPU_CACHE"] = old
    return out


NU_PARAM = os.path.join(ROOT, "param", "example_nonlinnu.py")
# the light Boltzmann settings of tests/test_cli_e2e.py (8 modes,
# k = 0.0105-3.0 /Mpc)
NU_A_END = 0.2  # to a = 1 the 5³ cells of grid 40 clustered take ~3 min on an H100
NU_OPTIONS = ("'modes_per_decade':3,'rtol':1e-4,'n_q':4,'l_max_ncdm':6,'l_max_ur':10,"
              "'k_max':3.0")


class _Timed:
    """Adds the seconds of each call of ``owner.name`` to ``self.seconds``
    while the context is open."""

    def __init__(self, owner, name: str):
        self.owner, self.name, self.seconds = owner, name, 0.0

    def __enter__(self):
        fn = self.orig = getattr(self.owner, self.name)

        def timed(*args, **kw):
            t0 = time.time()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds += time.time() - t0

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def _build_timed(overrides: list) -> tuple:
    """build_cosmology of example_nonlinnu: (lin, its seconds, the seconds
    of tabulate_eb (the solve, or the cache's read), of to_gauge)."""
    from concept_tpu_torch.cosmology import boltzmann, ebsolver
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import build_cosmology

    cfg = load_params(NU_PARAM, overrides=overrides)
    t0 = time.time()
    with _Timed(ebsolver, "tabulate_eb") as tab, \
            _Timed(boltzmann.TransferTables, "to_gauge") as gauge:
        _, _, _, lin = build_cosmology(cfg)
    return lin, time.time() - t0, tab.seconds, gauge.seconds


def nu_cosmology(a_end: float = NU_A_END, n: int = 80, device: str = "cuda",
                 cache: str | None = None) -> dict:
    """Phase 8: param/example_nonlinnu.py's matter component (80³
    particles, grid 40, Σmν = 0.5 eV, 8 rungs) with the internal
    Einstein-Boltzmann tables at the light settings of
    tests/test_cli_e2e.py.  The tables are solved on the host into an
    empty cache directory (the process pool over the 8 modes), built
    again from that cache, and the run reads them on the card, a = 0.02
    → ``a_end``; then the same run with the massive neutrinos removed and
    the analytic backend (EH).  Fails unless both runs launch rows 1, 3
    and 4 only, or where the realized spectrum's lowest bins stray from
    the tables' linear spectrum by more than a factor of 2.  ``n`` other
    than 80 takes the grid n/2, as the param does.  ``cache``: an empty
    directory for the tables, which the caller keeps (the ``multi``
    phase reads them); else a temporary one."""
    import math

    import numpy as np

    own_cache = cache is None
    cache = cache or tempfile.mkdtemp(prefix="chip_smoke_eb_")
    outdir = tempfile.mkdtemp(prefix="chip_smoke_nu_")
    eh_dir = tempfile.mkdtemp(prefix="chip_smoke_nu_eh_")
    out = {"a_end": a_end, "host_cpus": os.cpu_count(),
           "eb_workers": min(int(os.environ.get("CONCEPT_TPU_EB_WORKERS",
                                                os.cpu_count() or 1)), 8)}
    try:
        grid = [] if n == 80 else [f"potential_options={n // 2}"]
        overrides = [f"initial_conditions={{'species':'matter','N':{n}**3}}", *grid,
                     f"output_times={{'powerspec': [0.02, {a_end}]}}",
                     f"boltzmann_options={{{NU_OPTIONS},'cache_dir':'{cache}'}}"]
        lin, out["build_s"], out["solve_s"], out["gauge_s"] = _build_timed(overrides)
        if len(os.listdir(cache)) != 1:
            raise SystemExit(f"the EB solve left {os.listdir(cache)} in its cache")
        _, out["rebuild_s"], out["read_s"], out["regauge_s"] = _build_timed(overrides)
        n_modes = len(lin.tables.k)
        print(f"nu: EB tables of {n_modes} modes × {len(lin.tables.a)} scale factors "
              f"solved on the host in {out['solve_s']:.1f} s ({out['host_cpus']} CPUs, "
              f"{out['eb_workers']} workers), gauge transform "
              f"{out['gauge_s'] * 1e3:.0f} ms, build_cosmology {out['build_s']:.1f} s; "
              f"from the cache: read {out['read_s'] * 1e3:.0f} ms, gauge transform "
              f"{out['regauge_s'] * 1e3:.0f} ms, build_cosmology {out['rebuild_s']:.2f} s")
        t0 = time.time()
        sim, _, a, counts, seconds = _run(overrides, outdir, RUNG_KERNELS, device,
                                          param=NU_PARAM)
        if sim.lin.tables is None or a < a_end * (1 - 1e-9):
            raise SystemExit(f"the ν run ended at a = {a} without tables")
        steps = sim.hysteresis.get("step_count", 0)
        out.update(phase_run_s=time.time() - t0, wall_s=seconds,
                   evolve_s=sim.timings["evolve_s"], base_steps=steps,
                   ms_per_base_step=1e3 * sim.timings["evolve_s"] / max(steps, 1),
                   launches=counts, sigma8=sim.lin.sigma8(),
                   pm_mass_deficit_max=sim.inner.stats["pm_mass_deficit_max"])
        # the raw spectrum (a lattice has no Poisson shot noise) against
        # the P_linear column, which the run computes from the tables
        first = np.loadtxt(os.path.join(outdir, "powerspec_a=0.02.txt"))
        k, modes, P, P_lin = first[:4, 0], first[:4, 1], first[:4, 2], first[:4, 4]
        ratio = P / P_lin
        out["lowest_bins"] = {"k_per_Mpc": k.tolist(), "modes": modes.tolist(),
                              "P_over_P_linear": ratio.tolist()}
        mean = float(np.sum(modes * ratio) / np.sum(modes))
        out["P_over_P_linear_mean"] = mean
        if not (0.5 < mean < 2.0 and np.all(np.isfinite(ratio))):
            raise SystemExit(f"the realized spectrum strays from the tables': {ratio}")
        sim_eh, _, _, counts_eh, seconds_eh = _run(
            [f"initial_conditions={{'species':'matter','N':{n}**3}}",
             f"output_times={{'powerspec': [{a_end}]}}", "class_params={}",
             "boltzmann_backend='eh'", *grid], eh_dir, RUNG_KERNELS, device, param=NU_PARAM)
        steps_eh = sim_eh.hysteresis.get("step_count", 0)
        out["eh"] = {"wall_s": seconds_eh, "evolve_s": sim_eh.timings["evolve_s"],
                     "base_steps": steps_eh, "launches": counts_eh,
                     "ms_per_base_step": 1e3 * sim_eh.timings["evolve_s"] / max(steps_eh, 1),
                     "sigma8": sim_eh.lin.sigma8()}
        print(f"nu: example_nonlinnu's matter ({n}³, grid {n // 2}, Σmν = 0.5 eV) on {device}, "
              f"a 0.02 → {a:.4g}: {steps} base steps, {out['evolve_s']:.2f} s of evolution "
              f"({out['ms_per_base_step']:.1f} ms per base step; without ν, EH: "
              f"{steps_eh} steps, {out['eh']['ms_per_base_step']:.1f} ms per base step), "
              f"wall {seconds:.1f} s, launches {counts}; σ8 {out['sigma8']:.4f} from the "
              f"tables ({out['eh']['sigma8']:.4f} without ν, EH); realized P / linear P at "
              f"a = 0.02 in the lowest bins {[round(r, 3) for r in ratio]} "
              f"(modes {modes.astype(int).tolist()}, weighted mean {mean:.3f})")
        if not math.isfinite(out["sigma8"]):
            raise SystemExit("σ8 of the tables is not finite")
    finally:
        for d in [outdir, eh_dir] + [cache] * own_cache:
            shutil.rmtree(d, ignore_errors=True)
    return out


REL_PARAM = os.path.join(ROOT, "param", "example_relativistic.py")
MULTI_STEPS = 200  # example_nonlinnu's global steps from a_begin (the ν Courant limit)
SPLIT_STEPS = 16  # steps timed part by part after the counted run
SWEEP_ROWS = ("pair_sweep_global",)
PAIR_ROWS = ("pair_sweep_global", "pair_sweep_subset")
ALL_PAIRS = "powerspec_select={'all': True, 'all combinations': True}"


def _range_split(prof, steps: int) -> dict:
    """ms a step of each ``multi.*`` record_function range of
    MultiSimulation (pm, sweep, drift, host) from a torch.profiler run
    over ``steps`` steps, no sync between parts: ``device_ms`` the time
    of the device's kernels, copies and fills that start inside the
    range's span on the device timeline (its gpu_user_annotation; the
    kernels launched through ctypes have no CPU op to hang on),
    ``span_ms`` that span, ``host_ms`` the range's host time under the
    profiler."""
    import bisect

    from torch.autograd import DeviceType

    spans, work, split = [], [], {}
    for e in prof.events():
        if e.name.startswith("multi."):
            part = split.setdefault(e.name[6:], {"device_ms": 0.0, "span_ms": 0.0,
                                                 "host_ms": 0.0})
            if e.device_type == DeviceType.CPU:
                part["host_ms"] += e.cpu_time_total / 1e3 / steps
            else:
                part["span_ms"] += e.time_range.elapsed_us() / 1e3 / steps
                spans.append((e.time_range.start, e.time_range.end, e.name[6:]))
        elif e.device_type == DeviceType.CUDA:
            work.append((e.time_range.start, e.time_range.elapsed_us()))
    spans.sort()
    starts = [s0 for s0, _, _ in spans]
    for t0, us in work:
        i = bisect.bisect_right(starts, t0) - 1
        if i >= 0 and t0 < spans[i][1]:
            split[spans[i][2]]["device_ms"] += us / 1e3 / steps
    return split


def _multi_run(param: str, overrides: list, outdir: str, kernels, device: str = "cuda"):
    """load_params + run of a configuration of several components, as the
    CLI does: (sim, final MultiState, a, launch counts, host seconds,
    {power spectrum file: columns}).  Fails unless each of ``kernels``
    launched (in float) and no other kernel did, when
    the deposit lost more than half a particle's mass at a step, or when
    a spectrum or the final state is not finite.  (The multi path has no
    overflow budget: its buckets hold each component's deepest cell.)"""
    import numpy as np
    import torch

    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    cfg = load_params(param, overrides=overrides + [f"output_dirs='{outdir}'"])
    _reset_counts()
    t0 = time.time()
    sim, state, a = run(cfg, device=device)
    _sync()
    seconds = time.time() - t0
    counts, counts64 = _read_counts(), _read_counts_f64()
    if torch.device(device).type == "cuda":
        _check_launches(counts64, ())
        _check_launches(counts, kernels)
    spectra = {}
    for f in sorted(os.listdir(outdir)):
        if f.startswith("powerspec"):
            data = np.loadtxt(os.path.join(outdir, f))
            if data.ndim != 2 or not np.all(np.isfinite(data[:, :3])):
                raise SystemExit(f"the power spectrum {f} is not finite")
            spectra[f] = data
    if not spectra:
        raise SystemExit(f"no power spectrum written to {outdir}")
    grids = [x for ps in state.particles.values() for x in (ps.pos, ps.mom)]
    grids += [x for fs in state.fluids.values() for x in fs if x is not None]
    if not all(bool(torch.isfinite(x).all()) for x in grids):
        raise SystemExit("the final state is not finite")
    if sim.stats["pm_mass_deficit_max"] > 0.5:
        raise SystemExit(f"the PM deposit lost {sim.stats['pm_mass_deficit_max']:.3g} "
                         "particle masses at a step")
    return sim, state, a, counts, seconds, spectra


def _component_slots(sim, pos):
    """The sentinel-filled (3, K, C) short-range slots of one component's
    positions pos (N, 3) on the run's cells, K its deepest cell."""
    import torch

    from concept_tpu_torch.forces.shortrange import SENTINEL, bucketize, cell_counts

    box, n = sim.config.boxsize, sim._sr_ncells
    K = int(cell_counts(pos, box, n).max())
    b = bucketize(pos.unbind(1), box, n, K)
    return torch.where(b["valid"][None], torch.stack([b["hx"], b["hy"], b["hz"]]),
                       SENTINEL * box).contiguous()


def _multi_nonlinnu(cache: str, device: str = "cuda", steps: int = MULTI_STEPS,
                    n: int = 80, mesh: int | None = None) -> dict:
    """(a) param/example_nonlinnu.py whole (80³ matter on P³M grid 40, the
    ν fluid on grid 40 at Boltzmann order 1 with KT, the EB tables of
    ``cache``) for ``steps`` global steps from a_begin: the run ends at
    the middle of step ``steps`` (planned on the host), so it takes
    exactly that many.  Then SPLIT_STEPS more steps under the profiler,
    split by part, and row 6 on the final slots against its plain
    version and the double kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from concept_tpu_torch import sim_multi
    from concept_tpu_torch.device import resolve_device, resolve_dtype
    from concept_tpu_torch.forces.cuda_shortrange import pair_sweep_global
    from concept_tpu_torch.forces.shortrange import dtype_square
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import build_components, build_cosmology, make_multi

    mesh = mesh or n // 2
    base = [f"boltzmann_options={{{NU_OPTIONS},'cache_dir':'{cache}'}}"]
    if n != 80 or mesh != 40:
        base += [f"initial_conditions=[{{'species':'matter','N':{n}**3}},{{'species':"
                 f"'neutrino','gridsize':{n // 2},'boltzmann order':1}}]",
                 f"potential_options={mesh}"]
    cfg = load_params(NU_PARAM, overrides=base)
    units, consts, bg, lin = build_cosmology(cfg)
    dev = resolve_device(device)
    plan = make_multi(cfg, build_components(cfg, bg, consts), units, consts, bg, lin, dev,
                      resolve_dtype(dev))
    t0 = time.perf_counter()
    to_one = plan.count_steps(cfg.a_begin, 1.0)
    count_s = time.perf_counter() - t0
    dt0, limiter = plan.timestep_limiter(cfg.a_begin)
    for i, (t, dt, _, _) in enumerate(plan.schedule(cfg.a_begin, 1.0)):
        if i == steps - 1:
            a_out = float(bg.a_of_t_np(t + 0.5 * dt))
            break
    # Σϱ of the ν fluid as the run realizes it (the same call, seed, grid
    # and dtype)
    nu = plan.fspecs["neutrino"]
    rho0 = float(sim_multi.realize_fluid_from_linear(
        lin, nu, cfg.boxsize, cfg.a_begin, plan.fluid_Omegas[nu.name] * plan.rho_crit,
        seed=int(cfg.random_seeds.get("primordial amplitudes", 0)), dtype=torch.float32,
        device=dev, eos=plan.eos[nu.name]).varrho.double().sum())
    outdir = tempfile.mkdtemp(prefix="chip_smoke_multi_nu_")
    try:
        sim, state, a, counts, seconds, spectra = _multi_run(
            NU_PARAM, base + [f"output_times={{'powerspec': [{a_out!r}]}}", ALL_PAIRS],
            outdir, SWEEP_ROWS, device)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    done = sim.hysteresis["step_count"]
    if done != steps or sim.lin.tables is None:
        raise SystemExit(f"the ν run took {done} steps (planned {steps}) "
                         f"{'with' if sim.lin.tables is not None else 'without'} tables")
    drift = abs(float(state.fluids["neutrino"].varrho.double().sum()) / rho0 - 1)
    if drift > 1e-5:
        raise SystemExit(f"Σϱ of the ν fluid drifted by {drift:.3e} over {steps} steps")
    ms_step = 1e3 * sim.timings["evolve_s"] / steps
    # the split: SPLIT_STEPS more steps under the profiler, read from
    # MultiSimulation's record_function ranges
    t_now = float(bg.t_of_a_np(a))
    a2 = float(bg.a_of_t_np(t_now + (SPLIT_STEPS + 0.5) * sim.timestep_size(a)))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = sim.evolve(state, a, a2, resume=dict(sim.hysteresis))
        _sync()
    split_steps = sim.hysteresis["step_count"] - done
    split = _range_split(prof, split_steps)
    del prof
    # row 6 on the final slots.  Near the lattice each force is a sum of
    # ~6000 pairs in the cutoff that nearly cancel: the float32 sums carry
    # a floor of their own, which the plain float32 version's distance
    # from its float64 version measures on the first 64 rows of each
    # column.  The float32 launch bounded to those rows is held to its
    # plain version, and the run's own launch (every occupied row) to
    # the double kernel's on the same slots, each within twice that floor
    # (or 1e-5, the larger); the double kernel is held at 1e-10 of its
    # plain version.  Every measure is per receiver (_max_rel_recv).
    slots = _component_slots(sim, state.particles["matter"].pos)
    geom = _sweep_geometry(sim)
    K = slots.shape[1]
    ext = _occ(slots, geom.boxsize)
    rows = torch.clamp(ext, max=64)
    args = (geom.nc, geom.boxsize, geom.scale, dtype_square(geom.cutoff, slots.dtype),
            dtype_square(geom.softening, slots.dtype), geom.softening_kernel)
    floor = _float32_floor(slots, slots, args, rext=rows)
    tol = max(1e-5, 2 * floor)
    tag = f"ν run's final slots, the first {min(64, K)} rows of each column"
    check = _check_sweep(tag, slots, geom, (rows, ext), 3, 1, reach="global", tol=tol,
                         per_receiver=True)
    check["float32_floor"] = floor
    s64 = slots.double()
    check_f64 = _check_sweep(tag, s64, geom, (rows, ext), 3, 1, reach="global",
                             per_receiver=True)
    args64 = args[:3] + (dtype_square(geom.cutoff, s64.dtype),
                         dtype_square(geom.softening, s64.dtype), geom.softening_kernel)
    full = _max_rel_recv(pair_sweep_global(slots, slots, *args, rext=ext, sext=ext).double(),
                         pair_sweep_global(s64, s64, *args64, rext=ext, sext=ext))
    del s64
    check["all_rows_vs_f64_kernel"] = full
    check["ms_all_rows"] = _time_ms(
        lambda: pair_sweep_global(slots, slots, *args, rext=ext, sext=ext), 3)
    print(f"multi (a) example_nonlinnu whole ({n}³ matter, P³M grid {mesh}, ν "
          f"fluid grid {n // 2}, KT RK2) on {device}: {steps} global steps a {cfg.a_begin} → "
          f"{a:.6g}, {sim.timings['evolve_s']:.2f} s of evolution ({ms_step:.2f} ms a step), "
          f"wall {seconds:.1f} s; Δt set by '{limiter}' ({dt0:.3e} Gyr at a_begin); "
          f"{to_one} steps to a = 1 (counted on the host in {count_s:.1f} s); Σϱ_ν drift "
          f"{drift:.2e}; launches {counts}; ms a step by part over {split_steps} more steps "
          f"(profiled: device time and span of each part's work, host time): "
          f"{json.dumps({k: {q: round(v, 3) for q, v in d.items()} for k, d in split.items()})}; "
          f"row 6 on the final slots (K = {K}, {geom.nc}³ cells): every row, as the run "
          f"launches it, {check['ms_all_rows']:.3f} ms a launch, per receiver {full:.3e} from "
          f"the double kernel (tol {tol:g}; the float32 plain version's own distance from "
          f"float64 on the first 64 rows {floor:.2e})")
    if not full <= tol:
        raise SystemExit("row 6's float32 launch over every row of the ν run's slots "
                         "disagrees with the double kernel")
    return {"a_end": a, "steps": steps, "evolve_s": sim.timings["evolve_s"],
            "ms_per_step": ms_step, "wall_s": seconds, "limiter": limiter,
            "dt_limit_at_a_begin": dt0, "steps_to_a1": to_one, "count_s": count_s,
            "nu_rho_drift": drift, "launches": counts, "ms_per_step_by_part": split,
            "split_steps": split_steps, "spectra": sorted(spectra), "row6_final": check,
            "row6_final_f64": check_f64,
            "pm_mass_deficit_max": sim.stats["pm_mass_deficit_max"]}


def _multi_cdm_baryon(device: str = "cuda", n: int = 64, mesh: int = 128) -> dict:
    """(b) param/example_basic.py with cold dark matter and baryons, n³
    particles each, P³M on grid `mesh`, to a = 1: the self sweeps (row 6)
    and the component-pair sweeps (row 2) only.  Then rows 6 and 2
    against their plain versions on the final state at the run's
    softening 0 ('plummer'), in float and in double (the slots cast), and
    row 6 with the 'spline' kernel at softening 0 in both dtypes, each
    receiver judged on its own scale."""
    from concept_tpu_torch.forces.shortrange import dtype_square

    outdir = tempfile.mkdtemp(prefix="chip_smoke_multi_cb_")
    try:
        sim, state, a, counts, seconds, spectra = _multi_run(
            PARAM, [f"initial_conditions=[{{'species':'cold dark matter','N':{n}**3}},"
                    f"{{'species':'baryon','N':{n}**3}}]", f"potential_options={mesh}",
                    ALL_PAIRS], outdir, PAIR_ROWS, device)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    steps = sim.hysteresis["step_count"]
    if a < 1 - 1e-9 or len(spectra) != 3:
        raise SystemExit(f"the CDM + baryon run ended at a = {a} with spectra {sorted(spectra)}")
    geom = _sweep_geometry(sim)
    cdm = _component_slots(sim, state.particles["cold dark matter"].pos)
    bar = _component_slots(sim, state.particles["baryon"].pos)
    out = {"a_end": a, "steps": steps, "wall_s": seconds, "evolve_s": sim.timings["evolve_s"],
           "ms_per_step": 1e3 * sim.timings["evolve_s"] / max(steps, 1), "launches": counts,
           "spectra": sorted(spectra), "pm_mass_deficit_max": sim.stats["pm_mass_deficit_max"],
           "K_cdm": cdm.shape[1], "K_baryon": bar.shape[1]}
    print(f"multi (b) CDM + baryons ({n}³ each, P³M grid {mesh}, {geom.nc}³ short-range "
          f"cells) on {device}: a 0.02 → {a:.4g} in {steps} global steps, "
          f"{out['evolve_s']:.2f} s of evolution ({out['ms_per_step']:.1f} ms a step), wall "
          f"{seconds:.1f} s; finite spectra {sorted(spectra)}; launches {counts}; rows 6 and "
          f"2 on the final state at softening 0 (K = {cdm.shape[1]} / {bar.shape[1]}):")
    # each receiver on its own scale (_max_rel_recv): CDM-baryon twins at
    # rounding distance feel ~1e15 where the ordinary forces are ~1e4.
    # float32 at 1e-5, float64 at 1e-10; the float32 plain version's own
    # distance from float64 on the same slots is recorded beside
    spline = SimpleNamespace(**{**vars(geom), "softening_kernel": "spline"})
    cases = (("row6_final", "CDM's final slots, softening 0", geom, "global"),
             ("row2_final", "CDM receivers, baryon suppliers, softening 0", geom, "subset"),
             ("row6_spline", "CDM's final slots, spline at softening 0", spline, "global"))
    e_cdm, e_bar = _occ(cdm, geom.boxsize), _occ(bar, geom.boxsize)
    for key, tag, g, reach in cases:
        row2 = reach == "subset"
        sup = bar if row2 else cdm
        bounds = (e_cdm, e_bar if row2 else e_cdm)
        args = (g.nc, g.boxsize, g.scale, dtype_square(g.cutoff, cdm.dtype),
                dtype_square(g.softening, cdm.dtype), g.softening_kernel)
        floor = _float32_floor(cdm, sup, args)
        out[key] = _check_sweep(tag, cdm, g, bounds, 3, 1, reach=reach,
                                sup_s=bar if row2 else None, per_receiver=True)
        out[key]["float32_floor"] = floor
        out[f"{key}_f64"] = _check_sweep(tag, cdm.double(), g, bounds, 3, 1,
                                         reach=reach, sup_s=bar.double() if row2 else None,
                                         per_receiver=True)
    return out


def _multi_relativistic(device: str = "cuda", a_end: float = 0.02, n: int = 128) -> dict:
    """(c) param/example_relativistic.py whole (128³ matter on P³M grid
    128, the linear radiation component on grid 128 at Boltzmann order
    −1 with the 'class' closure, re-realized at every kick) to
    ``a_end``: row 6 only.  Its backend is what build_cosmology selects
    (the seconds of any Einstein-Boltzmann solve are printed).  Then the
    same matter without the radiation (one component: the global
    stepper, N_rungs = 1, with the multi path's unfixed amplitudes), and
    the ratio of the matter spectra below a quarter of the Nyquist
    wavenumber."""
    import numpy as np

    from concept_tpu_torch.cosmology import ebsolver

    size = [] if n == 128 else [
        f"initial_conditions=[{{'species':'matter','N':{n}**3}},{{'name':'linear','species':"
        f"'radiation','gridsize':{n},'boltzmann order':-1,'boltzmann closure':'class'}}]",
        f"potential_options={n}"]
    outdir = tempfile.mkdtemp(prefix="chip_smoke_multi_rel_")
    single = tempfile.mkdtemp(prefix="chip_smoke_multi_rel1_")
    try:
        with _Timed(ebsolver, "tabulate_eb") as eb:
            sim, state, a, counts, seconds, spectra = _multi_run(
                REL_PARAM, [f"output_times={{'powerspec': [{a_end}]}}", *size], outdir,
                SWEEP_ROWS, device)
        got = {}
        _run([f"output_times={{'powerspec': [{a_end}]}}", "N_rungs=1",
              "primordial_amplitude_fixed=False", *size[1:],
              f"initial_conditions={{'species':'matter','N':{n}**3}}"], single, GLOBAL_KERNELS,
             device, param=REL_PARAM, spectrum=got)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
        shutil.rmtree(single, ignore_errors=True)
    steps = sim.hysteresis["step_count"]
    P = spectra[f"powerspec_matter_a={a_end:.4g}.txt"]
    P1 = got["data"]
    k_quarter = 0.25 * np.pi * sim.config.potential_gridsize / 1024  # the box is 1024 Mpc
    sel = P[:, 0] <= k_quarter
    if not np.allclose(P[:, 0], P1[:, 0], rtol=1e-6) or sel.sum() < 2:
        raise SystemExit("the two relativistic runs binned k differently")
    ratio = P[sel, 2] / P1[sel, 2]
    backend = "eb" if sim.lin.tables is not None else "eh"
    print(f"multi (c) example_relativistic whole ({n}³ matter, radiation grid {n}, order −1 "
          f"'class') on {device}: a 0.01 → {a:.4g} in {steps} global steps, "
          f"{sim.timings['evolve_s']:.2f} s of evolution, wall {seconds:.1f} s; backend "
          f"{backend} (Einstein-Boltzmann solve {eb.seconds:.1f} s); launches {counts}; "
          f"P(k) over the run without the radiation below k_Nyquist/4: min {ratio.min():.6f}, "
          f"max {ratio.max():.6f} ({int(sel.sum())} bins)")
    return {"a_end": a, "steps": steps, "wall_s": seconds, "evolve_s": sim.timings["evolve_s"],
            "backend": backend, "eb_solve_s": eb.seconds, "launches": counts,
            "ratio_to_matter_only": ratio.tolist(), "k_per_Mpc": P[sel, 0].tolist(),
            "pm_mass_deficit_max": sim.stats["pm_mass_deficit_max"]}


def multi(cache: str, device: str = "cuda") -> dict:
    """Phase 9: several components and fluids through ``load_params`` and
    ``run``, at the widths of their parameter files: (a)
    example_nonlinnu, (b) CDM + baryons, (c) example_relativistic."""
    t0 = time.time()
    out = {"nonlinnu": _multi_nonlinnu(cache, device),
           "cdm_baryon": _multi_cdm_baryon(device),
           "relativistic": _multi_relativistic(device)}
    out["seconds"] = time.time() - t0
    print(f"multi: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------- #
# the renders, and the slab decomposition at world size 1
def _cic_density_numpy(p, gridsize: int, boxsize: float):
    """concept_tpu/graphics/render.py:_cic_density_at_particles, the JAX
    package's host arithmetic (np.add.at over the 8 corners), copied: this
    script imports nothing of the JAX package."""
    import numpy as np

    n = gridsize
    u = p / (boxsize / n) - 0.5
    i0 = np.floor(u).astype(np.int64)
    f = u - i0
    grid = np.zeros((n, n, n))
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                w = ((1 - f[:, 0] if cx == 0 else f[:, 0])
                     * (1 - f[:, 1] if cy == 0 else f[:, 1])
                     * (1 - f[:, 2] if cz == 0 else f[:, 2]))
                np.add.at(grid, ((i0[:, 0] + cx) % n, (i0[:, 1] + cy) % n,
                                 (i0[:, 2] + cz) % n), w)
    idx = np.clip(np.round(u).astype(np.int64), 0, None) % n
    return grid[idx[:, 0], idx[:, 1], idx[:, 2]]


def _timed_peak(fn):
    """(fn(), host seconds to a synchronised end, peak device bytes above
    what was allocated before)."""
    import torch

    _sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    _sync()
    return out, time.time() - t0, torch.cuda.max_memory_allocated() - base


def render(sim, state, mesh: int = 512, n_sub: int = 1_000_000) -> dict:
    """Phase 10: the renders' device work on the 256³ state of phase 4
    (example_basic realized at a = 0.02): the projected density at grid
    ``mesh`` against the same function on a CPU copy of the positions
    (max |Δ| within mesh·2⁻²⁴ of the largest pixel: the bound of a float32
    sum of the mesh cells along the axis, which both devices sum in
    another order; the image sums to N within half a particle), the per-particle
    CIC density of 1M particles (render3D's subsample and density grid)
    against the JAX package's numpy arithmetic (within 1e-12 of the
    largest: float64 atomics in another order), each with its seconds and
    peak device memory; then the files that matplotlib and h5py allow on
    this machine (no exception of a render is caught)."""
    import importlib.util

    import numpy as np
    import torch

    from concept_tpu_torch.analysis.powerspec import powerspec
    from concept_tpu_torch.graphics import render as r

    pos, box, N = state.pos, sim.config.boxsize, state.pos.shape[0]
    img, s_img, peak_img = _timed_peak(lambda: r.project_density(pos, mesh, box))
    t0 = time.time()
    ref = r.project_density(pos.cpu(), mesh, box)
    s_cpu = time.time() - t0
    err_img = float(np.abs(img - ref).max() / np.abs(ref).max())
    total = float(img.sum(dtype=np.float64))
    if err_img > mesh * 2.0**-24 or abs(total - N) > 0.5:
        raise SystemExit(f"project_density: max |Δ| {err_img:.3g} of the largest pixel "
                         f"(bound {mesh * 2.0**-24:.3g}), sum − N = {total - N:.4g}")
    idx = np.random.default_rng(0).choice(N, n_sub, replace=False)
    sub = pos[torch.as_tensor(idx, device=pos.device)]
    ng = max(16, min(128, round(n_sub ** (1 / 3))))
    rho, s_rho, peak_rho = _timed_peak(lambda: r._cic_density_at_particles(sub, ng, box))
    t0 = time.time()
    rho_np = _cic_density_numpy(sub.cpu().numpy(), ng, box)
    s_np = time.time() - t0
    err_rho = float(np.abs(rho.cpu().numpy() - rho_np).max() / np.abs(rho_np).max())
    if err_rho > 1e-12:
        raise SystemExit(f"_cic_density_at_particles: max |Δ| {err_rho:.3g} of the largest")
    print(f"render: project_density {N} particles on grid {mesh}: {s_img:.3f} s, peak "
          f"{peak_img / 2**30:.2f} GiB above the state (the CPU copy {s_cpu:.2f} s), max |Δ| "
          f"{err_img:.3g} of the largest pixel, sum − N = {total - N:.3g}; "
          f"_cic_density_at_particles {n_sub} particles on grid {ng} (float64): {s_rho:.3f} s, "
          f"peak {peak_rho / 2**20:.0f} MiB (numpy {s_np:.2f} s), max |Δ| {err_rho:.3g}")
    mpl = importlib.util.find_spec("matplotlib") is not None
    h5 = importlib.util.find_spec("h5py") is not None
    outdir = tempfile.mkdtemp(prefix="chip_smoke_render_")
    made, not_made = [], []
    try:
        fn = os.path.join(outdir, "render2D.png")
        if mpl or h5:
            enhanced = r.render2D(pos, mesh, box, filename=fn if mpl else None, save_data=h5,
                                  data_filename=fn.replace(".png", ".hdf5"))
            made += ["render2D PNG"] * mpl + ["render2D HDF5 data"] * h5
        if mpl:
            made.append(f"terminal image ({len(r.terminal_render(enhanced, 80))} characters)")
            r.render3D(pos, box, os.path.join(outdir, "render3D.png"), resolution=1080)
            pk = powerspec(pos, mesh, box, N)
            r.plot_powerspec(pk, os.path.join(outdir, "powerspec.png"), a=0.02)
            made += ["render3D PNG", "power-spectrum plot"]
        else:
            not_made += [f"{what} (no matplotlib)" for what in (
                "render2D PNG", "terminal image", "render3D PNG", "spectrum plots")]
        if not h5:
            not_made.append("render2D HDF5 data (no h5py)")
        made_files = sorted(os.listdir(outdir))
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    print(f"render outputs made: {made or 'none'} {made_files}; not made: {not_made or 'none'}")
    return {"project_density_s": s_img, "project_density_peak_bytes": peak_img,
            "project_density_cpu_s": s_cpu, "project_density_max_rel_err": err_img,
            "project_density_sum_minus_N": total - N, "cic_density_s": s_rho,
            "cic_density_peak_bytes": peak_rho, "cic_density_numpy_s": s_np,
            "cic_density_max_rel_err": err_rho, "made": made, "not_made": not_made}


def parallel(sim, state) -> dict:
    """Phase 11: the slab decomposition on a world of one ``nccl`` rank
    (built here: ``make_distribution(1)`` gives None), on the 256³ /
    grid 512 state of phase 10: sort_to_slabs (every particle, in index
    order), the halo deposit against the one-device deposit (1e-5 of the
    largest cell; the mass within half a particle), the slab FFT round
    trip (1e-5 of the largest mode / value), and one PM step through
    ``Simulation(dist=...)`` against the one-device step (the row 10-11
    kernels) at the JAX test's float32 tolerance (positions atol 1e-4,
    momenta 1e-5 of the largest; tests/test_distributed.py:36-43), with
    the ms and peak memory of each kick; then one P³M step through
    ``Simulation(dist=...)``, which must launch row 6 (the sweep over the
    all-gathered positions) and no other kernel, against the one-device
    fused step; and ``run`` with ``-n 2`` on this one card must raise
    ValueError.  Two ranks on one card are not shown: NCCL refuses two
    ranks on one GPU."""
    import dataclasses

    import torch
    import torch.distributed as tdist

    from concept_tpu_torch.components import ParticleState
    from concept_tpu_torch.forces.pm import pm_gravity_momentum_updates
    from concept_tpu_torch.grid.fft import GridDistribution, irfft3, rfft3
    from concept_tpu_torch.grid.interp import deposit
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.parallel import step
    from concept_tpu_torch.run import run
    from concept_tpu_torch.sim import Simulation

    cfg, bg, m = sim.config, sim.bg, sim.spec.mass
    pos, box, mesh, N = state.pos, cfg.boxsize, cfg.potential_gridsize, state.pos.shape[0]
    t0, t1 = float(bg.t_of_a_np(0.02)), float(bg.t_of_a_np(0.021))
    int1 = bg.integrals_np(t0, t1, keys=("a**(-1)",))["a**(-1)"]
    int2 = bg.integrals_np(t0, t1, keys=("a**(-2)",))["a**(-2)"]
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    tdist.init_process_group("nccl", store=tdist.FileStore(os.path.join(store, "store"), 1),
                             rank=0, world_size=1)
    try:
        dist = GridDistribution()
        out = {"sort_ms": _time_ms(lambda: step.sort_to_slabs(pos, dist, box), 3)}
        slabbed, w, idx, n_over = step.sort_to_slabs(pos, dist, box)
        if n_over or not torch.equal(idx, torch.arange(N, device=idx.device)):
            raise SystemExit("sort_to_slabs at world size 1 lost or reordered particles")
        grid = step.deposit_distributed_halo(slabbed, w, m, mesh, box, 2, dist)
        _, out["deposit_max_rel_err"] = _max_rel(grid, deposit(pos, m, mesh, box))
        # in particle masses as the deposit holds them (m in float32)
        deficit = abs(float(grid.sum(dtype=torch.float64))
                      / float(torch.tensor(m, dtype=pos.dtype)) - N)
        slab = rfft3(grid, dist)
        _, out["fft_max_rel_err"] = _max_rel(slab, torch.fft.rfftn(grid))
        _, out["ifft_max_rel_err"] = _max_rel(irfft3(slab, mesh, dist), grid)
        del grid, slab, slabbed, w, idx
        if (out["deposit_max_rel_err"] > 1e-5 or deficit > 0.5
                or max(out["fft_max_rel_err"], out["ifft_max_rel_err"]) > 1e-5):
            raise SystemExit(f"the slab deposit or FFT disagrees: {out}, deficit {deficit:.3g}")
        kicks = {
            "distributed": lambda: step.pm_momentum_updates_distributed_halo(
                pos, m, mesh, box, cfg.G, int1, dist),
            "single": lambda: pm_gravity_momentum_updates([pos], [m], mesh, box, cfg.G, int1,
                                                          deposit_method="auto")}
        for name, kick in kicks.items():
            _, _, out[f"{name}_kick_peak_bytes"] = _timed_peak(kick)
            out[f"{name}_kick_ms"] = _time_ms(kick, 5)
        steps = {}
        for method in ("pm", "p3m"):
            config = dataclasses.replace(cfg, method=method)
            for tag, dd in (("single", None), ("distributed", dist)):
                s = Simulation(sim.spec, config, bg, sim.lin, dist=dd)
                st = ParticleState(pos=pos.clone(), mom=state.mom.clone())
                _reset_counts()
                st, seconds, _ = _timed_peak(lambda s=s, st=st: s.step(st, int1, int2))
                steps[method, tag] = (st, seconds, _read_counts())
            (p1, s1, _), (pd, sd, counts) = steps[method, "single"], steps[method, "distributed"]
            d = (pd.pos - p1.pos).abs()
            dpos = float(torch.minimum(d, box - d).max())
            _, dmom = _max_rel(pd.mom, p1.mom)
            out[method] = {"step_s": sd, "single_step_s": s1, "max_dpos": dpos,
                           "max_dmom_rel": dmom, "launches": counts}
            if dpos > 1e-4 or dmom > 1e-5:
                raise SystemExit(f"the {method} step over the ranks differs from one device's: "
                                 f"positions {dpos:.3g}, momenta {dmom:.3g} of the largest")
            _check_launches(counts, ("pair_sweep_global",) if method == "p3m" else ())
        del steps
        try:
            run(load_params(PARAM), n_devices=2)
        except ValueError as e:
            out["n2_error"] = str(e)
        else:
            raise SystemExit("-n 2 on one card did not raise ValueError")
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    print(f"parallel (world of 1 nccl rank, {N} particles, grid {mesh}): sort_to_slabs "
          f"{out['sort_ms']:.2f} ms; halo deposit max |Δ| {out['deposit_max_rel_err']:.3g}, "
          f"slab FFT {out['fft_max_rel_err']:.3g} / {out['ifft_max_rel_err']:.3g}; PM kick "
          f"{out['distributed_kick_ms']:.2f} ms over the ranks against "
          f"{out['single_kick_ms']:.2f} ms on one device (peak "
          f"{out['distributed_kick_peak_bytes'] / 2**30:.2f} / "
          f"{out['single_kick_peak_bytes'] / 2**30:.2f} GiB); steps over the ranks against one "
          f"device: PM {out['pm']['step_s']:.3f} / {out['pm']['single_step_s']:.3f} s "
          f"(Δpos {out['pm']['max_dpos']:.3g}, Δmom {out['pm']['max_dmom_rel']:.3g}), P³M "
          f"{out['p3m']['step_s']:.3f} / {out['p3m']['single_step_s']:.3f} s (Δpos "
          f"{out['p3m']['max_dpos']:.3g}, Δmom {out['p3m']['max_dmom_rel']:.3g}, launches "
          f"{out['p3m']['launches']}); -n 2: ValueError({out['n2_error']!r})")
    print("parallel: two ranks are not run on this one card: NCCL refuses two ranks on one "
          "GPU (tests/test_torch_parallel_ranks.py runs 2 and 4 gloo ranks on the CPU)")
    return out


def _planes_sweep(tag: str, pos_s, sim, ext, dist) -> dict:
    """Row 1 (the ±1 sweep), or row 5 (the reach-2 sweep over
    ``sim.offsets``, the 4-mesh-cell layout), over a rank's planes of the
    layout pos_s (3, K, C) at world size 1: the nc planes between their
    neighbour planes (one a side for row 1, nx = nc + 2; two for row 5,
    nx = nc + 4, receivers at the negative sentinel; the planes wrapped
    and shifted by ∓box, receiver bounds 0 there), against its plain
    version at phase 2's tolerance (max|Δ|/max|ref| ≤ 1e-5), and its own
    planes' rows against the launch at nx = nc (bit for bit expected)."""
    import torch

    from concept_tpu_torch.forces.cuda_shortrange import (
        OFFSETS_27, pair_sweep, pair_sweep_plain, pair_sweep_reach,
    )
    from concept_tpu_torch.forces.shortrange import SENTINEL, dtype_square
    from concept_tpu_torch.parallel import step

    nc, box = sim.nc, sim.boxsize
    reach = sim.offsets is not None
    width = 2 if reach else 1
    W = width * nc * nc
    nx = nc + 2 * width
    _, K, C = pos_s.shape
    big = SENTINEL * box
    args = (nc, box, sim.scale, dtype_square(sim.cutoff, pos_s.dtype),
            dtype_square(sim.softening, pos_s.dtype))
    kind = sim.softening_kernel
    sup = step.halo_planes(pos_s, nc, box, dist, width=width)
    zeros = torch.zeros((W,), dtype=torch.int32, device=pos_s.device)
    rb = torch.cat([zeros, ext, zeros])
    prev, nxt = step.neighbour_planes(ext, W, dist)
    sb = torch.cat([prev, ext, nxt])
    if reach:
        offsets = sim.offsets
        recv = torch.where(pos_s.abs() < 0.5 * big, pos_s, -big)
        rcv = torch.full((3, K, nx * nc * nc), -big, dtype=pos_s.dtype, device=pos_s.device)
        rcv[:, :, W:W + C] = recv

        def kern():
            return pair_sweep_reach(rcv, sup, *args, offsets, kernel=kind, rext=rb, sext=sb,
                                    nx=nx)

        def plain():
            return pair_sweep_plain(rcv, sup, *args, kind, rb, sb, offsets, nx=nx)

        def whole_launch():
            return pair_sweep_reach(recv, pos_s, *args, offsets, kernel=kind, rext=ext,
                                    sext=ext)
    else:
        offsets = OFFSETS_27

        def kern():
            return pair_sweep(sup, sup, *args, kind, rext=rb, sext=sb, nx=nx)

        def plain():
            return pair_sweep_plain(sup, sup, *args, kind, rext=rb, sext=sb, nx=nx)

        def whole_launch():
            return pair_sweep(pos_s, pos_s, *args, kind, rext=ext, sext=ext)
    name = "pair_sweep_reach" if reach else "pair_sweep"
    got = kern()
    ref, plain_ms = _once_ms(plain)
    whole = whole_launch()
    _sync()
    err, rel = _max_rel(got, ref)
    bitwise = bool(torch.equal(got[:, :, W:W + C], whole))
    _, rel_whole = _max_rel(got[:, :, W:W + C], whole)
    del got, ref, whole
    ms = _time_ms(kern, 10)
    whole_ms = _time_ms(whole_launch, 10)
    tested, within, _, n_valid = _pair_work(pos_s, nc, box, args[3], args[4], offsets)
    flops = FLOPS_PER_TESTED_PAIR * tested + FLOPS_PER_PAIR_IN_CUTOFF * within
    # the valid slots of the planes and their neighbour planes read, the
    # (3, K, nx·nc²) result written, the bounds read
    n_sup = int((sup[0].abs() < 0.5 * big).sum())
    nbytes = pos_s.element_size() * (3 * n_sup + 3 * K * (C + 2 * W)) + 8 * (C + 2 * W)
    bound_ms = 1e3 * max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
    ok = rel <= 1e-5 and rel_whole <= 1e-5
    print(f"  {name} over planes ({tag}, nx = {nx}): max |Δ| {err:.3e}, "
          f"max|Δ|/max|ref| {rel:.3e} (tol 1e-5) {'ok' if ok else 'FAIL'}; its planes "
          f"against nx = {nc}: {rel_whole:.3e} of max, bit for bit {bitwise}; {ms:.3f} ms "
          f"(nx = {nc}: {whole_ms:.3f} ms), plain {plain_ms:.1f} ms, bound {bound_ms:.3f} ms")
    if not ok:
        raise SystemExit(f"{name} over planes disagrees")
    return dict(max_abs_err=err, max_rel_err=rel, vs_whole_rel=rel_whole,
                bitwise_vs_whole=bitwise, ms=ms, whole_ms=whole_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="operations" if flops / FP32_FLOPS >
                nbytes / HBM_BYTES_PER_S else "bytes", nx=nx)


def _planes_blocks(layout, sim, dist) -> dict:
    """Rows 8 and 9 on the tight layout's PM blocks as its kick over the
    ranks lays them out, at world size 1: the valid slots in the planes of
    all n/2 block planes (z-major ids over the planes, the same slots as
    the whole layout's at one rank), the deposit onto the slab mesh with a
    halo row a side against its plain version and, moved onto the slab
    (parallel/step.add_span_rows), against the launch on the whole mesh;
    the gather (D = 3 gradients) from the slab rows brought back
    (step.span_rows) against its plain version and the whole mesh's
    gather.  Phase 2's tolerance: rtol 2e-5, atol 1e-5·max|ref|."""
    import torch

    from concept_tpu_torch.forces.p3m import block_layout
    from concept_tpu_torch.grid.cuda_blocks import (
        deposit_blocks, deposit_blocks_plain, gather_blocks, gather_blocks_plain,
    )
    from concept_tpu_torch.grid.cuda_cells import cut_rows
    from concept_tpu_torch.parallel import step

    box, mesh = sim.boxsize, sim.mesh
    nb = mesh // 2
    K = sim._K_occ
    flat = layout.pos[:, :K].reshape(3, -1)[:, layout.valid[:K].reshape(-1)]
    planes = step.rank_planes(nb, dist)
    spans = [step.plane_rows(nb, 2, dist, r) for r in range(dist.n_devices)]
    lay = block_layout(*flat, mesh, box, sim.k_pm, planes=planes)
    pos, ext = lay["slots"], lay["ext"]
    w = (lay["valid"].to(pos.dtype) * sim.mass).contiguous()
    wv = lay["valid"].to(pos.dtype).contiguous()
    b, live = pos.element_size(), int(lay["valid"].sum())
    _, Kb, C = pos.shape

    def close(got, ref):
        err, rel = _max_rel(got, ref)
        return err, rel, bool(torch.allclose(got, ref, rtol=2e-5,
                                             atol=1e-5 * float(ref.abs().max())))

    out = {}
    slab = deposit_blocks(*pos, w, mesh, box, ext, planes=planes)
    ref, plain_ms = _once_ms(lambda: deposit_blocks_plain(*pos, cut_rows(w, ext), mesh, box,
                                                          planes))
    err, rel, ok = close(slab, ref)
    del ref
    whole = deposit_blocks(*pos, w, mesh, box, ext)
    _, rel_whole, ok_whole = close(step.add_span_rows(slab, spans, dist), whole)
    rows = mesh + 2
    dep_bytes = 4 * C + b * (live + 3 * live + rows * mesh**2)
    out["deposit_blocks"] = dict(
        max_abs_err=err, max_rel_err=rel, vs_whole_rel=rel_whole,
        ms=_time_ms(lambda: deposit_blocks(*pos, w, mesh, box, ext, planes=planes), 20),
        whole_ms=_time_ms(lambda: deposit_blocks(*pos, w, mesh, box, ext), 20),
        plain_ms=plain_ms,
        bound_ms=1e3 * max(dep_bytes / HBM_BYTES_PER_S, 60 * live / FP32_FLOPS),
        bound_by="bytes", ok=ok and ok_whole)
    # three distinct fields for the gather: the deposit rolled along each axis
    grads = torch.stack([torch.roll(whole, k, dims=k) for k in range(3)]).contiguous()
    del slab, whole
    g_slab = step.span_rows(grads, spans, dist).contiguous()
    got = gather_blocks(*pos, wv, g_slab, mesh, box, ext, planes=planes)
    ref, plain_ms = _once_ms(lambda: gather_blocks_plain(*pos, cut_rows(wv, ext), g_slab, mesh,
                                                         box, planes))
    err, rel, ok = close(got, ref)
    _, rel_whole, ok_whole = close(got, gather_blocks(*pos, wv, grads, mesh, box, ext))
    del got, ref
    gat_bytes = 4 * C + b * (4 * live + 3 * rows * mesh**2 + 3 * Kb * C)
    out["gather_blocks"] = dict(
        max_abs_err=err, max_rel_err=rel, vs_whole_rel=rel_whole,
        ms=_time_ms(lambda: gather_blocks(*pos, wv, g_slab, mesh, box, ext, planes=planes),
                    20),
        whole_ms=_time_ms(lambda: gather_blocks(*pos, wv, grads, mesh, box, ext), 20),
        plain_ms=plain_ms,
        bound_ms=1e3 * max(gat_bytes / HBM_BYTES_PER_S, (12 + 72) * live / FP32_FLOPS),
        bound_by="bytes", ok=ok and ok_whole)
    for name, c in out.items():
        print(f"  {name} over block planes ({rows}-row slab, {Kb} rows × {C} blocks, "
              f"{live} live): max |Δ| {c['max_abs_err']:.3e} "
              f"({c['max_rel_err']:.3e} of max), "
              f"against the whole mesh's {c['vs_whole_rel']:.3e} "
              f"{'ok' if c['ok'] else 'FAIL'}; {c['ms']:.3f} ms (whole mesh "
              f"{c['whole_ms']:.3f} ms), plain {c['plain_ms']:.1f} ms, bound "
              f"{c['bound_ms']:.3f} ms")
        if not c["ok"]:
            raise SystemExit(f"{name} over block planes disagrees")
    return out


def _planes_cells(pos, valid, sim, ext, dist) -> dict:
    """Rows 3 and 4 on a rank's planes at world size 1: the deposit into
    the slab with a halo row a side (the nc planes, n + 2 rows), against
    its plain version and, halo rows added, against the launch on the
    whole mesh; the gather (D = 3 gradients) from the slab with the
    neighbours' halo rows, against its plain version and the whole mesh's
    gather.  Phase 2's tolerance: rtol 2e-5, atol 1e-5·max|ref|."""
    import torch

    from concept_tpu_torch.grid.cuda_cells import (
        cut_rows, deposit_cells, deposit_cells_plain, gather_cells, gather_cells_plain,
    )
    from concept_tpu_torch.parallel import step

    nc, box, mesh = sim.nc, sim.boxsize, sim.mesh
    planes = (0, nc)
    w = (valid.to(pos.dtype) * sim.mass).contiguous()
    wv = valid.to(pos.dtype).contiguous()
    b, live = pos.element_size(), int(valid.sum())
    _, K, C = pos.shape

    def close(got, ref):
        err, rel = _max_rel(got, ref)
        return err, rel, bool(torch.allclose(got, ref, rtol=2e-5,
                                             atol=1e-5 * float(ref.abs().max())))

    out = {}
    slab = deposit_cells(pos, w, mesh, box, 8, planes=planes)
    ref, plain_ms = _once_ms(lambda: deposit_cells_plain(pos, w, mesh, box, 8, planes=planes))
    err, rel, ok = close(slab, ref)
    del ref
    whole = deposit_cells(pos, w, mesh, box, 8)
    spans = [step.plane_rows(nc, 8, dist, r) for r in range(dist.n_devices)]
    _, rel_whole, ok_whole = close(step.add_span_rows(slab, spans, dist), whole)
    rows = mesh + 2
    dep_bytes = b * (w.numel() + 3 * live + rows * mesh**2)
    out["deposit_cells"] = dict(
        max_abs_err=err, max_rel_err=rel, vs_whole_rel=rel_whole,
        ms=_time_ms(lambda: deposit_cells(pos, w, mesh, box, 8, planes=planes), 20),
        whole_ms=_time_ms(lambda: deposit_cells(pos, w, mesh, box, 8), 20), plain_ms=plain_ms,
        bound_ms=1e3 * max(dep_bytes / HBM_BYTES_PER_S, 60 * live / FP32_FLOPS),
        bound_by="bytes", ok=ok and ok_whole)
    # three distinct fields for the gather: the deposit rolled along each axis
    grads = torch.stack([torch.roll(whole, k, dims=k) for k in range(3)]).contiguous()
    del slab, whole
    g_slab = step.span_rows(grads, spans, dist).contiguous()
    got = gather_cells(pos, wv, g_slab, mesh, box, 8, ext=ext, planes=planes)
    ref, plain_ms = _once_ms(lambda: gather_cells_plain(pos, cut_rows(wv, ext), g_slab, mesh,
                                                        box, 8, planes=planes))
    err, rel, ok = close(got, ref)
    _, rel_whole, ok_whole = close(got, gather_cells(pos, wv, grads, mesh, box, 8, ext=ext))
    del got, ref
    gat_bytes = 4 * C + b * (4 * live + 3 * rows * mesh**2 + 3 * K * C)
    out["gather_cells"] = dict(
        max_abs_err=err, max_rel_err=rel, vs_whole_rel=rel_whole,
        ms=_time_ms(lambda: gather_cells(pos, wv, g_slab, mesh, box, 8, ext=ext,
                                         planes=planes), 20),
        whole_ms=_time_ms(lambda: gather_cells(pos, wv, grads, mesh, box, 8, ext=ext), 20),
        plain_ms=plain_ms,
        bound_ms=1e3 * max(gat_bytes / HBM_BYTES_PER_S, (12 + 72) * live / FP32_FLOPS),
        bound_by="bytes", ok=ok and ok_whole)
    for name, c in out.items():
        print(f"  {name} over planes ({mesh + 2}-row slab): max |Δ| {c['max_abs_err']:.3e} "
              f"({c['max_rel_err']:.3e} of max), against the whole mesh's "
              f"{c['vs_whole_rel']:.3e} {'ok' if c['ok'] else 'FAIL'}; {c['ms']:.3f} ms "
              f"(whole mesh {c['whole_ms']:.3f} ms), plain {c['plain_ms']:.1f} ms, bound "
              f"{c['bound_ms']:.3f} ms")
        if not c["ok"]:
            raise SystemExit(f"{name} over planes disagrees")
    return out


def _rung_base_steps(sim, flat, a0: float, n_steps: int):
    """``n_steps`` base steps of the rung stepper ``sim`` from the flat
    state, as its evolve takes them (first rungs assigned, a rebucket when
    the margin is spent): (layout, ms per base step, peak device bytes)."""
    import torch

    bg = sim.bg
    st = sim.init_state(tuple(flat.pos[:, k] for k in range(3)),
                        tuple(flat.mom[:, k] for k in range(3)), ids=flat.ids)
    t = t_mom = float(bg.t_of_a_np(a0))
    st = sim.assign_initial_rungs(st, sim._timestep(a0, 0.0))
    v, seconds = 0.0, []
    _sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _ in range(n_steps):
        a = float(bg.a_of_t_np(t))
        dt = sim._timestep(a, v)
        t0 = time.time()
        st, vmax = sim.base_step(st, t, dt, t_mom)
        if sim.needs_rebucket:
            st = sim.rebucket(st)
        _sync()
        seconds.append(time.time() - t0)
        t_mom, t = t + 0.5 * dt, t + dt
        v = vmax / (float(bg.a_of_t_np(t)) * sim.mass)
    return st, 1e3 * sum(seconds) / n_steps, torch.cuda.max_memory_allocated() - base


def _by_id(layout, field):
    import torch

    v = layout.valid.reshape(-1)
    vals = getattr(layout, field).reshape(3, -1)[:, v].T
    return vals[torch.argsort(layout.ids.reshape(-1)[v])]


def _tight_pm_over_ranks(layout, sim, dist) -> dict:
    """The tight layout's PM over the ranks as its kick runs it (the block
    PM on the ranks' planes of blocks: rows 8 and 9, the exchange to the
    block planes and back, the row mover, the slab FFT;
    p3msim.pm_gradient_layout with ``dist``) against one device's block
    PM and against the global steps' generic halo PM over the ranks
    (``index_add_``, parallel/step.pm_momentum_updates_distributed_halo)
    on the same particles: each call's ms (mean of 5 after a warm-up) and
    the momentum updates' largest difference from one device's over the
    largest (the PM bound of tests/test_distributed.py:40-43, 1e-5, for
    the path's)."""
    from concept_tpu_torch.p3msim import pm_gradient_layout
    from concept_tpu_torch.parallel.step import pm_momentum_updates_distributed_halo

    K = sim._K_occ
    pos, valid = layout.pos[:, :K], layout.valid[:K]
    args = (sim.mass, sim.G, sim.scale, sim.boxsize, sim.mesh)
    sel = valid.reshape(-1)
    flat = pos.reshape(3, -1)[:, sel].T.contiguous()

    def ranks():
        return pm_gradient_layout(pos, valid, *args, k_pm=sim.k_pm, dist=dist)[0]

    def one():
        return pm_gradient_layout(pos, valid, *args, k_pm=sim.k_pm)[0]

    def generic():
        return pm_momentum_updates_distributed_halo(flat, sim.mass, sim.mesh, sim.boxsize,
                                                    sim.G, 1.0, dist, order=2,
                                                    longrange_scale=sim.scale)[0]

    ref = (-sim.mass * one().reshape(3, -1)[:, sel]).T
    _, rel = _max_rel((-sim.mass * ranks().reshape(3, -1)[:, sel]).T, ref)
    _, rel_generic = _max_rel(generic(), ref)
    out = {"max_rel_err": rel, "generic_max_rel_err": rel_generic}
    out.update({f"{k}_ms": _time_ms(f, 5) for k, f in (("ranks", ranks), ("one_device", one),
                                                        ("generic", generic))})
    print(f"  tight PM over the ranks (block PM, rows 8-9): {out['ranks_ms']:.3f} ms a "
          f"gradient against {out['one_device_ms']:.3f} on one device, {rel:.3g} of the "
          f"largest update off (tol 1e-5); the generic halo PM (index_add_) "
          f"{out['generic_ms']:.3f} ms, {rel_generic:.3g} off")
    if not rel <= 1e-5:
        raise SystemExit("the tight layout's PM over the ranks differs from one device's")
    return out


# phase 12's other layouts over planes: (tag, n, grid, cells' width in mesh
# cells (0: tight), the kernels their base steps launch)
PLANES_LAYOUTS = (("reach", 62, 124, 4, REACH_KERNELS), ("tight", 63, 126, 0, TIGHT_KERNELS))


def _steps_over_ranks(n: int, mesh: int, sim, flat, dist, n_steps: int, ucb: int,
                      kernels) -> dict:
    """``n_steps`` base steps of ``P3MRungSimulation(dist=...)`` against the
    one-device stepper from the flat state, each way twice in turn (the
    first pair warms up; the second is reported): mean |Δx|/box < 1e-5
    (tests/test_distributed_rungs.py:88), momenta within 1e-5 of the
    largest, the layout ``ucb`` taken; ms a base step and peak memory both
    ways; ``kernels`` launched and no other."""
    import torch

    from concept_tpu_torch.p3mrungs import P3MRungSimulation

    steps, first = {}, {}
    for tag, dd in (("single", None), ("ranks", dist)) * 2:
        if tag in steps:
            first[tag] = steps[tag][2:4]
        s = P3MRungSimulation(n, sim.boxsize, sim.mass, sim.G, mesh=mesh, bg=sim.bg,
                              N_rungs=sim.NR, softening=sim.softening,
                              softening_kernel=sim.softening_kernel, device="cuda",
                              dist=dd)
        _reset_counts()
        layout, ms, peak = _rung_base_steps(s, flat, 0.02, n_steps)
        steps[tag] = (_by_id(layout, "pos"), _by_id(layout, "mom"), ms, peak,
                      _read_counts(), s.ucb)
        del layout, s
    (p1, m1, ms1, pk1, _, _), (pd, md, msd, pkd, counts, got_ucb) = (steps["single"],
                                                                      steps["ranks"])
    box = sim.boxsize
    d = (pd - p1).abs().double()
    d = torch.minimum(d, box - d).norm(dim=1) / box
    _, dmom = _max_rel(md, m1)
    bs = dict(steps=n_steps, mean_dx=float(d.mean()), max_dx=float(d.max()), max_dmom_rel=dmom,
              ms_per_step=msd, single_ms_per_step=ms1, peak_bytes=pkd, single_peak_bytes=pk1,
              first_ms_and_peak={k: list(v) for k, v in first.items()}, launches=counts,
              ucb=got_ucb)
    print(f"  {n}³ / grid {mesh}: {n_steps} base steps over the ranks against one device: "
          f"mean |Δx|/box {bs['mean_dx']:.3g}, max {bs['max_dx']:.3g}, max |Δp| {dmom:.3g} "
          f"of "
          f"the largest; {msd:.1f} ms a base step against {ms1:.1f}, peak "
          f"{pkd / 2**30:.2f} / {pk1 / 2**30:.2f} GiB; launches {counts}")
    if bs["mean_dx"] >= 1e-5 or dmom > 1e-5 or got_ucb != ucb:
        raise SystemExit("the rung stepper over the ranks differs from one device's")
    _check_launches(counts, kernels)
    return bs


def _rung_adapter(n: int, mesh: int, dist):
    """example_basic's ``RungSimulationAdapter`` at n³ particles on the
    mesh-``mesh`` rung layout over the ranks of ``dist``: (adapter, its
    a_begin)."""
    import torch

    from concept_tpu_torch.p3mrungs import RungSimulationAdapter
    from concept_tpu_torch.sim import SimConfig

    cfg, consts, bg, lin, spec, soft = _example(n, mesh)
    config = SimConfig(boxsize=cfg.boxsize, potential_gridsize=mesh,
                       device=torch.device("cuda"), dtype=torch.float32, G=consts.G_Newton,
                       softening=soft, softening_kernel=cfg.softening_kernel)
    return (RungSimulationAdapter(spec, config, bg, lin, N_rungs=cfg.N_rungs, dist=dist),
            cfg.a_begin)


def _realized_over_ranks(n: int, mesh: int, dist, lpt_order: int = 1):
    """example_basic's n³ particles realized over the ranks of ``dist``
    through ``RungSimulationAdapter(dist=...).initial_state`` on the
    mesh-``mesh`` rung layout: the rank's flat index shard."""
    adapter, a_begin = _rung_adapter(n, mesh, dist)
    return adapter.initial_state(a_begin, seed=0, lpt_order=lpt_order)


def parallel_realize(n: int = 256, mesh: int = 512) -> dict:
    """Phase 13: the realization over ranks on a world of one ``nccl``
    rank.  example_basic's n³ particles by 2LPT and 3LPT through
    ``RungSimulationAdapter(dist=...).initial_state`` (the noise of the
    rank's x-rows, the slab FFT, its lattice planes, the hand-off to its
    index shard) against one device's ``initial_state``, per id:
    positions within 1e-5 of one device's largest displacement |x − q|
    plus 2·box·2⁻²⁴ (a stored float32 position's rounding), momenta
    within 1e-5 of the largest, every id once.  Prints the seconds and
    the peak device memory of each realization (the second of two calls
    each way: the first makes the cuFFT plans)."""
    import torch
    import torch.distributed as tdist

    from concept_tpu_torch.components import lattice_positions
    from concept_tpu_torch.grid.fft import GridDistribution

    t_phase = time.time()
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    tdist.init_process_group("nccl", store=tdist.FileStore(os.path.join(store, "store"), 1),
                             rank=0, world_size=1)
    out = {"N": n**3}
    try:
        dist = GridDistribution()
        box = _example(n, mesh)[0].boxsize
        for order in (2, 3):
            runs = {}
            for tag, dd in (("single", None), ("ranks", dist)) * 2:
                adapter, a_begin = _rung_adapter(n, mesh, dd)
                runs.pop(tag, None)
                _sync()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                flat = adapter.initial_state(a_begin, seed=0, lpt_order=order)
                _sync()
                runs[tag] = (flat, time.perf_counter() - t0,
                             torch.cuda.max_memory_allocated() - base)
                del flat
            (one, s1, pk1), (got, sd, pkd) = runs["single"], runs["ranks"]
            q = lattice_positions(n, box, "sc", torch.float64, "cuda")
            disp = one.pos.double() - q
            disp -= box * torch.round(disp / box)
            pos_tol = 1e-5 * float(disp.abs().max()) + 2 * box * 2.0**-24
            del q, disp
            ids = got.ids.long()
            dx = got.pos.double() - one.pos.double()[ids]
            dx -= box * torch.round(dx / box)
            dpos = float(dx.abs().max())
            dmom = _max_rel(got.mom.double(), one.mom.double()[ids])[1]
            ids_ok = bool(torch.equal(ids, torch.arange(n**3, device=ids.device)))
            del dx, got, one
            res = dict(seconds=sd, single_seconds=s1, peak_bytes=pkd, single_peak_bytes=pk1,
                       max_dpos=dpos, pos_tol=pos_tol, max_dmom_rel=dmom, ids_ok=ids_ok)
            out[f"lpt{order}"] = res
            print(f"parallel_realize: {n}³ {order}LPT over a world of one rank: "
                  f"{sd:.3f} s, peak {pkd / 2**30:.2f} GiB (one device {s1:.3f} s, "
                  f"{pk1 / 2**30:.2f} GiB); max |Δx| {dpos:.3g} (bound {pos_tol:.3g}), "
                  f"max |Δp| {dmom:.3g} of the largest; ids {'in order' if ids_ok else 'WRONG'}")
            if not (dpos <= pos_tol and dmom <= 1e-5 and ids_ok):
                raise SystemExit("the realization over the ranks differs from one device's")
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    out["seconds"] = time.time() - t_phase
    return out


def parallel_rungs(n: int = 256, mesh: int = 512, n_steps: int = 3) -> dict:
    """Phase 12: the rung stepper over ranks on a world of one ``nccl``
    rank (built here: ``make_distribution(1)`` gives None).  (a) On the
    realized n³ / grid ``mesh`` layout: rows 1, 3 and 4 over the rank's
    planes (the sweep at nx = nc + 2, the cells on the slab with a halo
    row a side) against their plain versions and the launches on the
    whole layout.  (b) ``n_steps`` base steps of
    ``P3MRungSimulation(dist=...)`` against the one-device stepper from the
    same state: mean |Δx|/box < 1e-5 (tests/test_distributed_rungs.py:88),
    momenta within 1e-5 of the largest; ms a base step and peak memory
    both ways; rows 1, 3 and 4 launched (:func:`_steps_over_ranks`).  (e)
    The 4-mesh-cell layout at 62³ / grid 124 (31 planes): row 5 over the
    rank's planes between two neighbour planes a side (nx = nc + 4)
    against its plain version and, bit for bit, the whole launch; 3 base
    steps as in (b), rows 5, 3, 4 launched.  (f) The tight layout at 63³ /
    grid 126 (19 planes): row 1 over planes as in (a), rows 8 and 9 over
    the planes of the PM blocks (:func:`_planes_blocks`), its PM over the
    ranks beside one device's and the generic halo PM
    (:func:`_tight_pm_over_ranks`), 3 base steps, rows 1, 8, 9 launched.
    (c) ``param/example_basic.py`` from a = 0.02 to 0.1 through
    ``RungSimulationAdapter(dist=...)``: its spectrum within 1e-4 of the
    one-device adapter's; every count set to 0 just before, read just
    after.  (d) ``-n 2`` on this one card raises ValueError.  Two ranks
    are not run: NCCL refuses two ranks on one GPU."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    from concept_tpu_torch.analysis.powerspec import powerspec
    from concept_tpu_torch.forces.shortrange import SENTINEL
    from concept_tpu_torch.grid.fft import GridDistribution
    from concept_tpu_torch.p3mrungs import RungSimulationAdapter
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run
    from concept_tpu_torch.sim import SimConfig

    t_phase = time.time()
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    tdist.init_process_group("nccl", store=tdist.FileStore(os.path.join(store, "store"), 1),
                             rank=0, world_size=1)
    try:
        dist = GridDistribution()
        # (a) the kernels over the planes
        adapter, state = _realized_layout(n**3, mesh, "cuda")
        sim = adapter.inner
        K, ext = sim._K_occ, sim._ext_occ
        print(f"parallel_rungs (world of 1 nccl rank): {n}³ particles, grid {mesh}, "
              f"{sim.nc}³ cells, {K} slot rows")
        pos_s = _sentineled(state, K, SENTINEL * sim.boxsize)
        out = {"pair_sweep": _planes_sweep("realized", pos_s, sim, ext, dist)}
        del pos_s
        out.update(_planes_cells(state.pos[:, :K], state.valid[:K], sim, ext, dist))
        del state, adapter
        # (b) base steps over the ranks against one device, from the
        # realization over the ranks
        flat = _realized_over_ranks(n, mesh, dist)
        out["base_steps"] = _steps_over_ranks(n, mesh, sim, flat, dist, n_steps, 8,
                                              RUNG_KERNELS)
        del flat
        # (e) the 4-mesh-cell layout (row 5 over planes: nx = nc + 4) and
        # (f) the tight one (row 1 over planes, rows 8 and 9 over the
        # blocks' planes), each on a realized layout and for base steps
        for tag, nn, mm, ucb, kernels in PLANES_LAYOUTS:
            adapter, state = _realized_layout(nn**3, mm, "cuda")
            lsim = adapter.inner
            K, ext = lsim._K_occ, lsim._ext_occ
            print(f"parallel_rungs, {tag} layout: {nn}³ particles, grid {mm}, {lsim.nc}³ "
                  f"cells, {K} slot rows")
            if lsim.ucb != ucb:
                raise SystemExit(f"grid {mm} took cells {lsim.ucb} mesh cells wide, not {ucb}")
            pos_s = _sentineled(state, K, SENTINEL * lsim.boxsize)
            res = {"pair_sweep_reach" if ucb else "pair_sweep":
                   _planes_sweep(f"{tag}, realized", pos_s, lsim, ext, dist)}
            del pos_s
            if not ucb:
                res.update(_planes_blocks(state, lsim, dist))
                res["pm"] = _tight_pm_over_ranks(state, lsim, dist)
            del state, adapter
            flat = _realized_over_ranks(nn, mm, dist)
            res["base_steps"] = _steps_over_ranks(nn, mm, lsim, flat, dist, n_steps, ucb,
                                                  kernels)
            del flat
            out[tag] = res
        # (c) example_basic through the adapter over the ranks
        cfg, consts, bg, lin, spec, soft = _example(64, 128)
        config = SimConfig(boxsize=cfg.boxsize, potential_gridsize=128,
                           device=torch.device("cuda"), dtype=torch.float32,
                           G=consts.G_Newton, softening=soft,
                           softening_kernel=cfg.softening_kernel)
        spectra = {}
        for tag, dd in (("single", None), ("ranks", dist)):
            ad = RungSimulationAdapter(spec, config, bg, lin, N_rungs=cfg.N_rungs,
                                       fac_rung=cfg.Delta_t_rung_factor, dist=dd)
            flat = ad.initial_state(0.02, seed=0)
            _reset_counts()
            t0 = time.time()
            flat, _ = ad.evolve(flat, 0.02, 0.1)
            _sync()
            seconds, counts = time.time() - t0, _read_counts()
            pos = ad.whole(flat).pos
            pk = powerspec(pos, 128, cfg.boxsize, spec.N)
            spectra[tag] = (np.asarray(pk["power"]), seconds, counts,
                            ad.inner.stats["base_steps"], ad.inner.stats["max_rung"])
        (P1, s1, _, n1, _), (Pd, sd, counts, nd, rung) = spectra["single"], spectra["ranks"]
        good = np.isfinite(P1) & (P1 > 0)
        rel = float(np.abs(Pd[good] / P1[good] - 1).max())
        out["example_basic"] = dict(spectrum_max_rel=rel, seconds=sd, single_seconds=s1,
                                    base_steps=nd, single_base_steps=n1, max_rung=rung,
                                    launches=counts)
        print(f"  example_basic 64³ / grid 128, a = 0.02 → 0.1 through the adapter over the "
              f"ranks: {nd} base steps in {sd:.2f} s (one device: {n1} in {s1:.2f} s), "
              f"highest rung {rung}, spectrum within {rel:.3g} of one device's; launches "
              f"{counts}")
        if not rel <= 1e-4 or not np.isfinite(Pd[good]).all():
            raise SystemExit("the spectrum over the ranks differs from one device's")
        _check_launches(counts, RUNG_KERNELS)
        # (d)
        try:
            run(load_params(PARAM), n_devices=2)
        except ValueError as e:
            out["n2_error"] = str(e)
        else:
            raise SystemExit("-n 2 on one card did not raise ValueError")
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    out["seconds"] = time.time() - t_phase
    print(f"parallel_rungs: -n 2 on one card: ValueError({out['n2_error']!r}); "
          f"{out['seconds']:.1f} s")
    print("parallel_rungs: multi-rank NCCL is not run on one H100 (NCCL refuses two ranks "
          "on one card); tests/test_torch_parallel_rungs.py runs 2 and 4 gloo ranks on the CPU")
    return out


# --------------------------------------------------------------------- #
# several components and fluids over ranks
PARALLEL_MULTI_CB_STEPS = 4  # CDM + baryon steps over the rank


def _multi_world(param: str, overrides: list, device: str = "cuda"):
    """load_params, build_cosmology and the components of a configuration
    of several components: (cfg, a function of ``dist`` that makes its
    MultiSimulation (``run.make_multi``) over those ranks, or on one
    device where ``dist`` is None)."""
    from concept_tpu_torch.device import resolve_device, resolve_dtype
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import build_components, build_cosmology, make_multi

    cfg = load_params(param, overrides=overrides)
    units, consts, bg, lin = build_cosmology(cfg)
    comps = build_components(cfg, bg, consts)
    dev = resolve_device(device)
    return cfg, lambda dist: make_multi(cfg, comps, units, consts, bg, lin, dev,
                                        resolve_dtype(dev), dist=dist)


def _realize_multi(cfg, sim):
    """The components of a run at a_begin as run.run_multi realizes them
    (over the rank of ``sim.dist``: its part alone)."""
    from concept_tpu_torch.run import realize_multi_component
    from concept_tpu_torch.sim_multi import MultiState

    seed = int(cfg.random_seeds.get("primordial amplitudes", 0))
    return MultiState(*({s.name: realize_multi_component(cfg, sim, s, cfg.a_begin, seed)
                         for s in specs.values()} for specs in (sim.pspecs, sim.fspecs)))


def _clone_multi(state):
    from concept_tpu_torch.sim_multi import MultiState

    def clone(t):
        return type(t)(*(None if x is None else x.clone() for x in t))

    return MultiState(particles={k: clone(v) for k, v in state.particles.items()},
                      fluids={k: clone(v) for k, v in state.fluids.items()})


def _a_after_steps(sim, a_begin: float, steps: int) -> float:
    """The a at the middle of global step ``steps`` from a_begin (planned on
    the host): an evolve to it takes exactly that many steps."""
    for i, (t, dt, _, _) in enumerate(sim.schedule(a_begin, 1.0)):
        if i == steps - 1:
            return float(sim.bg.a_of_t_np(t + 0.5 * dt))
    raise SystemExit(f"fewer than {steps} steps to a = 1")


def _evolve_measured(sim, state, a0: float, a1: float):
    """sim.evolve from a0 to a1: (state, a, seconds, peak device bytes
    above what was allocated before).  The caller sets the counts."""
    import torch

    _sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state, a = sim.evolve(state, a0, a1)
    _sync()
    return state, a, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base


def _split_steps(sim, state, a: float, steps: int = SPLIT_STEPS) -> dict:
    """ms a step by part (the ``multi.*`` ranges, :func:`_range_split`)
    over ``steps`` more steps from a copy of state at a, under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    done = sim.hysteresis["step_count"]
    t_now = float(sim.bg.t_of_a_np(a))
    a2 = float(sim.bg.a_of_t_np(t_now + (steps + 0.5) * sim.timestep_size(a)))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.evolve(_clone_multi(state), a, a2, resume=dict(sim.hysteresis))
        _sync()
    return _range_split(prof, sim.hysteresis["step_count"] - done)


def _multi_against_one(tag: str, got, want, box: float, fluid_tols: dict) -> dict:
    """Each particle component's positions (mean |Δx|/box ≤ 1e-5,
    tests/test_distributed_rungs.py:88) and momenta (max |Δ| ≤ 1e-5 of
    the largest) and each fluid's grids (``fluid_tols``: field → bound
    of the largest value) over the rank against one device's."""
    out = {}
    for name, ps in want.particles.items():
        dx = got.particles[name].pos.double() - ps.pos.double()
        dx -= box * (dx / box).round()
        mean_dx = float(dx.norm(dim=1).mean()) / box
        dmom = _max_rel(got.particles[name].mom.double(), ps.mom.double())[1]
        out[name] = {"mean_dx_over_box": mean_dx, "max_dmom_rel": dmom}
        if not (mean_dx <= 1e-5 and dmom <= 1e-5):
            raise SystemExit(f"{tag}: {name} over the rank differs from one device's "
                             f"(mean |Δx|/box {mean_dx:.3e}, max |Δp| {dmom:.3e})")
    for name, fs in want.fluids.items():
        for field, tol in fluid_tols.items():
            w = getattr(fs, field)
            if w is None:
                continue
            rel = _max_rel(getattr(got.fluids[name], field).double(), w.double())[1]
            out[f"{name}.{field}"] = rel
            if not rel <= tol:
                raise SystemExit(f"{tag}: {name}'s {field} over the rank differs from one "
                                 f"device's by {rel:.3e} of its largest (bound {tol:g})")
    return out


def _over_rank_and_one(tag: str, param: str, overrides: list, dist, steps: int,
                       kernels, split: bool = False) -> dict:
    """A configuration of several components realized over the rank, then
    ``steps`` global steps through ``MultiSimulation(dist=...)`` (every
    count set to 0 just before, read just after: ``kernels`` only) and
    through one device's MultiSimulation from the same state; with
    ``split`` SPLIT_STEPS more steps each way under the profiler.  Returns
    the runs' numbers, with their sims and final states under '_sims' and
    '_states' (over the rank, one device)."""
    cfg, make = _multi_world(param, overrides)
    sim_d, sim_1 = make(dist), make(None)
    state = _realize_multi(cfg, sim_d)
    a_end = _a_after_steps(sim_d, cfg.a_begin, steps)
    sums0 = {k: float(f.varrho.double().sum()) for k, f in state.fluids.items()}
    one = _evolve_measured(sim_1, _clone_multi(state), cfg.a_begin, a_end)
    _reset_counts()
    got = _evolve_measured(sim_d, state, cfg.a_begin, a_end)
    counts, counts64 = _read_counts(), _read_counts_f64()
    _check_launches(counts64, ())
    _check_launches(counts, kernels)
    if sim_d.hysteresis["step_count"] != steps or sim_1.hysteresis["step_count"] != steps:
        raise SystemExit(f"{tag}: {sim_d.hysteresis['step_count']} steps over the rank, "
                         f"{sim_1.hysteresis['step_count']} on one device (planned {steps})")
    out = {"steps": steps, "a_begin": cfg.a_begin, "a_end": got[1], "launches": counts,
           "seconds": got[2], "single_seconds": one[2],
           "ms_per_step": 1e3 * got[2] / steps, "single_ms_per_step": 1e3 * one[2] / steps,
           "peak_bytes": got[3], "single_peak_bytes": one[3],
           "fluid_sum_drift": {k: abs(float(got[0].fluids[k].varrho.double().sum()) / v - 1)
                               for k, v in sums0.items()},
           "pm_mass_deficit_max": sim_d.stats["pm_mass_deficit_max"],
           "_sims": (sim_d, sim_1), "_states": (got[0], one[0]), "_box": cfg.boxsize}
    if sim_d.stats["pm_mass_deficit_max"] > 0.5:
        raise SystemExit(f"{tag}: the deposit over the rank lost "
                         f"{sim_d.stats['pm_mass_deficit_max']:.3g} particle masses")
    if split:
        out["ms_per_step_by_part"] = _split_steps(sim_d, got[0], got[1])
        out["single_ms_per_step_by_part"] = _split_steps(sim_1, one[0], one[1])
    return out


def _public(res: dict) -> dict:
    return {k: v for k, v in res.items() if not k.startswith("_")}


def parallel_multi(cache: str, steps: int = MULTI_STEPS) -> dict:
    """Phase 14: several components and fluids over ranks, on a world of
    one ``nccl`` rank (``MultiSimulation(dist=...)``: each rank holds its
    particle shards and its x-rows of every fluid grid).  (a)
    example_nonlinnu at the width of its parameter file (80³ matter, P³M
    grid 40, the ν fluid on grid 40 at order 1 with KT, phase 8's tables)
    from the realization over the rank, ``steps`` global steps against
    one device's from the same state: mean |Δx|/box ≤ 1e-5, momenta 1e-5
    of the largest, ν ϱ 2e-6 and J 2e-5 of their largest, Σϱ_ν within
    1e-5; row 6 only; ms a step by part (the ``multi.*`` ranges) and peak
    memory both ways.  (b) CDM + baryons, 64³ each, grid 128, for
    PARALLEL_MULTI_CB_STEPS steps: rows 6 and 2 only, each then held per
    receiver against its plain version on the rank's receivers (phase 9
    (b)'s measure; float 1e-5, double 1e-10).  (c) example_relativistic
    at 128³ / grid 128 for 3 steps, the radiation re-realized on the
    rank's rows at every kick, against one device's.  (d) ``-n 2`` on one
    card raises ValueError.  NCCL refuses two ranks on one card:
    scripts/ranks_multi.py runs 2 and 4 cards."""
    import torch
    import torch.distributed as tdist

    from concept_tpu_torch.grid.fft import GridDistribution
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.parallel.step import replicate
    from concept_tpu_torch.run import run

    t_phase = time.time()
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    tdist.init_process_group("nccl", store=tdist.FileStore(os.path.join(store, "store"), 1),
                             rank=0, world_size=1)
    out = {}
    try:
        dist = GridDistribution()
        # (a)
        nu = _over_rank_and_one(
            "ν over the rank", NU_PARAM,
            [f"boltzmann_options={{{NU_OPTIONS},'cache_dir':'{cache}'}}"], dist, steps,
            SWEEP_ROWS, split=True)
        nu["against_one"] = _multi_against_one("ν over the rank", *nu["_states"], nu["_box"],
                                               {"varrho": 2e-6, "J": 2e-5})
        drift = nu["fluid_sum_drift"]["neutrino"]
        if not drift <= 1e-5:
            raise SystemExit(f"Σϱ of the ν fluid over the rank drifted by {drift:.3e}")
        out["nonlinnu"] = _public(nu)
        print(f"parallel_multi (a) example_nonlinnu (80³ matter, P³M grid 40, ν grid 40, KT) "
              f"over a world of one nccl rank: {steps} steps a {nu['a_begin']} → "
              f"{nu['a_end']:.6g}, {nu['ms_per_step']:.2f} ms a step, peak "
              f"{nu['peak_bytes'] / 2**30:.3f} GiB (one device {nu['single_ms_per_step']:.2f} "
              f"ms, {nu['single_peak_bytes'] / 2**30:.3f} GiB); against one device "
              f"{json.dumps(nu['against_one'])}; Σϱ_ν drift {drift:.2e}; launches "
              f"{nu['launches']}; ms a step by part over {SPLIT_STEPS} more steps, over the "
              f"rank {json.dumps(_rounded(nu['ms_per_step_by_part']))}, one device "
              f"{json.dumps(_rounded(nu['single_ms_per_step_by_part']))}")
        del nu
        # (b)
        cb = _over_rank_and_one(
            "CDM + baryons over the rank", PARAM,
            ["initial_conditions=[{'species':'cold dark matter','N':64**3},"
             "{'species':'baryon','N':64**3}]", "potential_options=128"], dist,
            PARALLEL_MULTI_CB_STEPS, PAIR_ROWS)
        sim = cb["_sims"][0]
        final = cb["_states"][0]
        geom = _sweep_geometry(sim)
        # the rank's CDM receivers; its sweeps read the all-gathered
        # positions of each component (the whole at world size 1)
        cdm = _component_slots(sim, final.particles["cold dark matter"].pos)
        cdm_all = _component_slots(sim, replicate(final.particles["cold dark matter"].pos,
                                                  dist))
        bar = _component_slots(sim, replicate(final.particles["baryon"].pos, dist))
        print(f"parallel_multi (b) CDM + baryons (64³ each, P³M grid 128) over the rank: "
              f"{PARALLEL_MULTI_CB_STEPS} steps, {cb['ms_per_step']:.2f} ms a step, peak "
              f"{cb['peak_bytes'] / 2**30:.3f} GiB (one device {cb['single_ms_per_step']:.2f} "
              f"ms, {cb['single_peak_bytes'] / 2**30:.3f} GiB); launches {cb['launches']}; "
              f"rows 6 and 2 on the final state at softening 0:")
        box = geom.boxsize
        for key, tag, recv, reach in (
                ("row6", "the whole CDM over the rank, softening 0", cdm_all, "global"),
                ("row2", "the rank's CDM receivers, all baryons, softening 0", cdm, "subset")):
            row2 = reach == "subset"
            bounds = (_occ(recv, box), _occ(bar if row2 else recv, box))
            cb[key] = _check_sweep(tag, recv, geom, bounds, 3, 1, reach=reach,
                                   sup_s=bar if row2 else None, per_receiver=True)
            cb[f"{key}_f64"] = _check_sweep(tag, recv.double(), geom, bounds, 3, 1,
                                            reach=reach,
                                            sup_s=bar.double() if row2 else None,
                                            per_receiver=True)
        del cdm, cdm_all, bar, sim, final
        out["cdm_baryon"] = _public(cb)
        del cb
        # (c)
        rel = _over_rank_and_one("example_relativistic over the rank", REL_PARAM, [], dist, 3,
                                 SWEEP_ROWS)
        rel["against_one"] = _multi_against_one("example_relativistic over the rank",
                                                *rel["_states"], rel["_box"],
                                                {"varrho": 2e-6})
        out["relativistic"] = _public(rel)
        print(f"parallel_multi (c) example_relativistic (128³ matter, radiation grid 128 "
              f"re-realized at every kick) over the rank: 3 steps, {rel['ms_per_step']:.2f} "
              f"ms a step, peak {rel['peak_bytes'] / 2**30:.3f} GiB (one device "
              f"{rel['single_ms_per_step']:.2f} ms, {rel['single_peak_bytes'] / 2**30:.3f} "
              f"GiB); against one device {json.dumps(rel['against_one'])}; launches "
              f"{rel['launches']}")
        del rel
        # (d)
        try:
            run(load_params(NU_PARAM), n_devices=2)
        except ValueError as e:
            out["n2_error"] = str(e)
        else:
            raise SystemExit("-n 2 on one card did not raise ValueError")
        torch.cuda.empty_cache()
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    out["seconds"] = time.time() - t_phase
    print(f"parallel_multi: -n 2 on one card: ValueError({out['n2_error']!r}); "
          f"{out['seconds']:.1f} s")
    return out


def parallel_pencils(n: int = 256, mesh: int = 512) -> dict:
    """Phase 15: the 2D pencils of ``-n AxB`` on a world of one ``nccl``
    rank as a 1 × 1 mesh (``grid/fft.make_pencils(1, 1)``: its B- and
    A-groups and both transposes run; ``-n 1x1`` itself is one device, as
    in the JAX package), from one realized n³ state on grid ``mesh``: (a)
    the pencil FFT round trip against ``torch.fft.rfftn`` (1e-5 of the
    largest mode / value) and its ms both ways; (b) one global PM kick and
    one global P³M kick through ``Simulation`` on the pencils (the whole
    local deposit through row 10 over the block sort, the two
    reduce-scatters, the pencil FFT, the gradients made whole, row 11; for
    P³M row 6 on the all-gathered positions) against one device's
    (momenta within 1e-5 of the largest), ms a kick and peak device
    memory both ways, each kernel of the path launched and no other; (c)
    rows 10 and 11 held against their plain versions on the kick's block
    sort (D = 3 and 1), row 6 on its short-range slots; (d) ``-n 2x1`` on
    one card raises ValueError.  NCCL refuses two ranks on one card:
    scripts/ranks_pencils.py runs 2 and 4 cards."""
    import dataclasses

    import torch
    import torch.distributed as tdist

    from concept_tpu_torch.components import ParticleState
    from concept_tpu_torch.grid.fft import irfft3, make_pencils, rfft3
    from concept_tpu_torch.grid.interp import deposit
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run
    from concept_tpu_torch.sim import Simulation

    t_phase = time.time()
    sim, state = _global_sim(n**3, mesh, "cuda", method="p3m")
    cfg, bg, m = sim.config, sim.bg, sim.spec.mass
    pos, box = state.pos, cfg.boxsize
    t0, t1 = float(bg.t_of_a_np(0.02)), float(bg.t_of_a_np(0.021))
    int1 = bg.integrals_np(t0, t1, keys=("a**(-1)",))["a**(-1)"]
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    tdist.init_process_group("nccl", store=tdist.FileStore(os.path.join(store, "store"), 1),
                             rank=0, world_size=1)
    out = {"shape": {"N": n**3, "mesh": mesh}}
    try:
        pencils = make_pencils(1, 1)
        # (a)
        grid = deposit(pos, m, mesh, box)
        f = rfft3(grid, pencils)
        _, out["fft_max_rel_err"] = _max_rel(f[..., :mesh // 2 + 1], torch.fft.rfftn(grid))
        _, out["ifft_max_rel_err"] = _max_rel(irfft3(f, mesh, pencils), grid)
        out["fft_ms"] = _time_ms(lambda: rfft3(grid, pencils), 3)
        out["rfftn_ms"] = _time_ms(lambda: torch.fft.rfftn(grid), 3)
        del grid, f
        if max(out["fft_max_rel_err"], out["ifft_max_rel_err"]) > 1e-5:
            raise SystemExit(f"the pencil FFT disagrees with rfftn: {out}")
        # (b)
        for method in ("pm", "p3m"):
            config = dataclasses.replace(cfg, method=method)
            res = {}
            for tag, dd in (("single", None), ("pencils", pencils)):
                s = Simulation(sim.spec, config, bg, sim.lin, dist=dd)

                def kick(s=s):
                    st = ParticleState(pos=pos, mom=torch.zeros_like(pos))
                    return s.kick(st, int1).mom

                _reset_counts()
                dmom, seconds, peak = _timed_peak(kick)
                res[tag] = dict(dmom=dmom, counts=_read_counts(), peak_bytes=peak,
                                first_s=seconds, sim=s)
                res[tag]["ms"] = _time_ms(kick, 3)
            _, err = _max_rel(res["pencils"]["dmom"], res["single"]["dmom"])
            counts = res["pencils"]["counts"]
            out[method] = {"max_dmom_rel": err, "launches": counts,
                           "ms": res["pencils"]["ms"], "single_ms": res["single"]["ms"],
                           "peak_bytes": res["pencils"]["peak_bytes"],
                           "single_peak_bytes": res["single"]["peak_bytes"],
                           "single_launches": res["single"]["counts"]}
            if err > 1e-5:
                raise SystemExit(f"the {method} kick on the pencils differs from one "
                                 f"device's by {err:.3g} of the largest momentum change")
            _check_launches(counts, PM_KERNELS + (("pair_sweep_global",) if method == "p3m"
                                                  else ()))
            if method == "p3m":
                pencil_sim = res["pencils"]["sim"]
            del res
        # (c) the kernels on the path's inputs: the kick's block sort and
        # its short-range slots (of the all-gathered positions, the whole
        # state at world size 1)
        out["pm_kernels"] = _check_pm_buckets(pos, m, cfg.G, mesh, box)
        slots, n_over = _global_sweep_slots(pencil_sim, pos)
        ext = _occ(slots, box)
        out["pair_sweep"] = _check_sweep("two-sided, on the pencils' kick", slots,
                                         _sweep_geometry(pencil_sim), (ext, ext), 3, 1,
                                         reach="global")
        out["pair_sweep"]["stragglers"] = n_over
        del slots, pencil_sim
        # (d)
        try:
            run(load_params(PARAM), n_devices="2x1")
        except ValueError as e:
            out["n2x1_error"] = str(e)
        else:
            raise SystemExit("-n 2x1 on one card did not raise ValueError")
        torch.cuda.empty_cache()
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    out["seconds"] = time.time() - t_phase
    print(f"parallel_pencils (world of 1 nccl rank as 1 x 1 pencils, {n}³ particles, grid "
          f"{mesh}): pencil FFT {out['fft_max_rel_err']:.3g} / {out['ifft_max_rel_err']:.3g} "
          f"of rfftn, {out['fft_ms']:.2f} ms against {out['rfftn_ms']:.2f}; kicks on the "
          f"pencils against one device: " + "; ".join(
              f"{k.upper()} {out[k]['ms']:.2f} ms against {out[k]['single_ms']:.2f}, peak "
              f"{out[k]['peak_bytes'] / 2**30:.2f} / {out[k]['single_peak_bytes'] / 2**30:.2f} "
              f"GiB, Δmom {out[k]['max_dmom_rel']:.3g}, launches {out[k]['launches']}"
              for k in ("pm", "p3m"))
          + f"; -n 2x1: ValueError({out['n2x1_error']!r}); {out['seconds']:.1f} s")
    return out


def _rounded(split: dict) -> dict:
    return {k: {q: round(v, 3) for q, v in d.items()} for k, d in split.items()}


# (name, counter, phase with its check, key, source, the TPU kernel's
# definition, the newest path that launches the kernel (its launch count)
# or None where no path runs it)
SWEEP_SRC = "concept_tpu_torch/csrc/pair_sweep.cu"
CELLS_SRC = "concept_tpu_torch/csrc/cells.cu"
PM_SRC = "concept_tpu_torch/csrc/pm_blocks.cu"
KERNELS = (
    ("pair_sweep", "pair_sweep", "check", "pair_sweep_bounded", SWEEP_SRC,
     "concept_tpu/forces/pallas_shortrange.py:287", "main_path"),
    ("pair_sweep_subset", "pair_sweep_subset", "global_rungs", "subset_sweep", SWEEP_SRC,
     "concept_tpu/forces/pallas_shortrange.py:540", "multi_cdm_baryon"),
    ("deposit_cells", "deposit_cells", "lean_kick", "deposit_cells", CELLS_SRC,
     "concept_tpu/grid/pallas_cells.py:162", "lean_kick"),
    ("gather_cells", "gather_cells", "lean_kick", "gather_cells", CELLS_SRC,
     "concept_tpu/grid/pallas_cells.py:206", "lean_kick"),
    ("pair_sweep_reach", "pair_sweep_reach", "check_reach", "reach_one_sided", SWEEP_SRC,
     "concept_tpu/forces/pallas_shortrange.py:976", "reach_main_path"),
    ("pair_sweep_global", "pair_sweep_global", "check_global", "pair_sweep_two_sided",
     SWEEP_SRC, "concept_tpu/forces/pallas_shortrange.py:220", "p3m_persistent"),
    ("sweep_reach", "sweep_reach", "check_reach", "reach_two_sided_unbounded", SWEEP_SRC,
     "concept_tpu/forces/pallas_shortrange.py:831", None),
    ("deposit_blocks", "deposit_blocks", "check_global", "deposit_blocks", CELLS_SRC,
     "concept_tpu/grid/pallas_pm.py:210", "p3m_persistent"),
    ("gather_blocks", "gather_blocks", "check_global", "gather_blocks", CELLS_SRC,
     "concept_tpu/grid/pallas_pm.py:245", "p3m_persistent"),
    ("deposit_pm", "deposit_pm", "check_pm_only", "deposit_pm", PM_SRC,
     "concept_tpu/grid/pallas_pm.py:54", "pm_only_main_path"),
    ("gather_pm", "gather_pm", "check_pm_only", "gather_pm", PM_SRC,
     "concept_tpu/grid/pallas_pm.py:81", "pm_only_main_path"),
)


def _timed(seconds: dict, name: str, fn, *args, **kw):
    """fn(*args, **kw), its wall seconds printed and kept in ``seconds``."""
    t0 = time.time()
    out = fn(*args, **kw)
    seconds[name] = time.time() - t0
    print(f"[{name}: {seconds[name]:.1f} s]")
    return out


def kernels_line(results: dict) -> list:
    """The ``kernels`` list of the line before the last, from the phases'
    results (every row of KERNELS, with the numbers of each path that
    runs it)."""
    kernels = []
    for name, counter, phase, key, source, replaces, path in KERNELS:
        c = results[phase][key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            # a kernel no path runs: its launches in the 4-mesh-cell run (0)
            "launches": results[path or "reach_main_path"]["launches"][counter],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c.get("library_ms"),
        })
    byname = {k["name"]: k for k in kernels}
    for name in ("deposit_cells", "gather_cells"):
        c = results["check_reach"][f"{name}_cb4"]
        byname[name].update(
            cb4_max_abs_err=c["max_abs_err"], cb4_ms=c["ms"], cb4_plain_ms=c["plain_ms"],
            cb4_bound_ms=c["bound_ms"], cb4_library_ms=c["library_ms"],
            cb4_launches=results["reach_main_path"]["launches"][name])
    # rows 3-4 on the first path's check (128³, grid 256, D = 3), and the
    # gather at D = 3 on the lean kick's layout
    for name, prefix, c in (
            ("deposit_cells", "check", results["check"]["deposit_cells"]),
            ("gather_cells", "check", results["check"]["gather_cells"]),
            ("gather_cells", "D3", results["lean_kick"]["gather_cells_D3"])):
        byname[name].update({f"{prefix}_{k}": c[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")})
    byname["pair_sweep"].update(tight_launches=results["tight_main_path"]["launches"]
                                ["pair_sweep"])
    # the snapshot-started run of the files phase and the ν run (rows 1, 3, 4)
    for name in RUNG_KERNELS:
        byname[name]["files_launches"] = results["files"]["launches"][name]
        byname[name]["nu_launches"] = results["nu"]["launches"][name]
    # the earlier paths' launches of the kernels whose newest path is above
    for name, counter, phase in (("deposit_cells", "deposit_cells", "main_path"),
                                 ("gather_cells", "gather_cells", "main_path"),
                                 ("pair_sweep_global", "pair_sweep_global", "global_main_path"),
                                 ("deposit_blocks", "deposit_blocks", "global_main_path"),
                                 ("gather_blocks", "gather_blocks", "global_main_path")):
        byname[name][f"{phase}_launches"] = results[phase]["launches"][counter]
    byname["pair_sweep_global"]["global_rungs_launches"] = (
        results["global_rungs"]["launches"]["pair_sweep_global"])
    byname["pair_sweep_subset"]["global_rungs_launches"] = (
        results["global_rungs"]["launches"]["pair_sweep_subset"])
    # the multi phase: rows 6 and 2 launched by its three runs, and held
    # against their plain versions on the runs' final slots at softening 0
    # (the run's 'plummer', and 'spline'), in float and in double
    mp = results["multi"]
    for run_name in ("nonlinnu", "cdm_baryon", "relativistic"):
        byname["pair_sweep_global"][f"multi_{run_name}_launches"] = (
            mp[run_name]["launches"]["pair_sweep_global"])
        byname["pair_sweep_subset"][f"multi_{run_name}_launches"] = (
            mp[run_name]["launches"]["pair_sweep_subset"])
    for name, prefix, run_name, key in (
            ("pair_sweep_global", "multi_nonlinnu_final", "nonlinnu", "row6_final"),
            ("pair_sweep_global", "multi_soft0", "cdm_baryon", "row6_final"),
            ("pair_sweep_global", "multi_soft0_spline", "cdm_baryon", "row6_spline"),
            ("pair_sweep_global", "f64_multi_soft0", "cdm_baryon", "row6_final_f64"),
            ("pair_sweep_global", "f64_multi_soft0_spline", "cdm_baryon",
             "row6_spline_f64"),
            ("pair_sweep_subset", "multi_soft0", "cdm_baryon", "row2_final"),
            ("pair_sweep_subset", "f64_multi_soft0", "cdm_baryon", "row2_final_f64")):
        c = mp[run_name][key]
        byname[name].update({f"{prefix}_{k}": c[k] for k in (
            "max_abs_err", "max_rel_err", "tol_rel", "ms", "plain_ms", "bound_ms")})
    byname["pair_sweep_global"]["parallel_launches"] = (
        results["parallel"]["p3m"]["launches"]["pair_sweep_global"])
    # phase 14: rows 6 and 2 launched by the three runs over the rank, and
    # held per receiver on the CDM + baryon run's final state there
    pmu = results["parallel_multi"]
    for run_name in ("nonlinnu", "cdm_baryon", "relativistic"):
        for name, counter in (("pair_sweep_global", "pair_sweep_global"),
                              ("pair_sweep_subset", "pair_sweep_subset")):
            byname[name][f"parallel_multi_{run_name}_launches"] = (
                pmu[run_name]["launches"][counter])
    for name, key in (("pair_sweep_global", "row6"), ("pair_sweep_subset", "row2")):
        for suffix, prefix in (("", "parallel_multi_soft0"), ("_f64", "f64_parallel_multi_soft0")):
            c = pmu["cdm_baryon"][key + suffix]
            byname[name].update({f"{prefix}_{k}": c[k] for k in (
                "max_abs_err", "max_rel_err", "tol_rel", "ms", "plain_ms", "bound_ms")})
    # phase 15: rows 10, 11 and 6 launched by the PM and P³M kicks on the
    # 1 x 1 pencils, and held on the kick's block sort and slots
    pp = results["parallel_pencils"]
    for name, counter in (("deposit_pm", "deposit_pm"), ("gather_pm", "gather_pm"),
                          ("pair_sweep_global", "pair_sweep_global")):
        for method in ("pm", "p3m"):
            byname[name][f"parallel_pencils_{method}_launches"] = pp[method]["launches"][counter]
    for name, c in (("deposit_pm", pp["pm_kernels"]["deposit_pm"]),
                    ("gather_pm", pp["pm_kernels"]["gather_pm"]),
                    ("pair_sweep_global", pp["pair_sweep"])):
        byname[name].update({f"parallel_pencils_{k}": c.get(k) for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")})
    # rows 1, 3 and 4 over a rank's planes (phase 12): their checks, and
    # their launches by the base steps and by example_basic over the ranks
    pr = results["parallel_rungs"]
    planes_keys = ("max_abs_err", "max_rel_err", "ms", "whole_ms", "plain_ms", "bound_ms")
    for name in RUNG_KERNELS:
        byname[name].update({f"planes_{k}": pr[name][k] for k in planes_keys})
        byname[name]["planes_launches"] = pr["example_basic"]["launches"][name]
        byname[name]["planes_base_steps_launches"] = pr["base_steps"]["launches"][name]
    byname["deposit_blocks"]["tight_pm_over_ranks"] = pr["tight"]["pm"]
    # rows 5, 1, 8 and 9 over the planes of the 4-mesh-cell and tight
    # layouts (prefixes planes_reach_, planes_tight_), and the launches of
    # their base steps over the ranks (rows 3 and 4 at cb = 4 too)
    for tag, names in (("reach", REACH_KERNELS), ("tight", TIGHT_KERNELS)):
        for name in names:
            if name in pr[tag]:
                byname[name].update({f"planes_{tag}_{k}": pr[tag][name][k]
                                     for k in planes_keys})
            byname[name][f"planes_{tag}_base_steps_launches"] = (
                pr[tag]["base_steps"]["launches"][name])
    byname["pair_sweep_global"]["multi_nonlinnu_all_rows_vs_f64_kernel"] = (
        mp["nonlinnu"]["row6_final"]["all_rows_vs_f64_kernel"])
    for name in ("deposit_pm", "gather_pm"):
        byname[name]["global_rungs_launches"] = results["global_rungs"]["launches"][name]
    for name, phase, key in (("pair_sweep", "check", "pair_sweep_unbounded"),
                             ("pair_sweep_reach", "check_reach",
                              "reach_one_sided_unbounded")):
        unb = results[phase][key]
        byname[name].update(
            unbounded_max_abs_err=unb["max_abs_err"], unbounded_ms=unb["ms"],
            unbounded_plain_ms=unb["plain_ms"], unbounded_bound_ms=unb["bound_ms"])
    for name, prefix, phase, key in (
            ("pair_sweep", "clustered", "main_path", "pair_sweep_clustered"),
            ("pair_sweep_global", "clustered", "global_main_path", "pair_sweep_clustered"),
            ("pair_sweep_global", "p3m_final", "p3m_persistent", "sweep_final"),
            ("pair_sweep_reach", "clustered", "reach_main_path", "sweep_clustered")):
        clu = results[phase][key]
        byname[name].update({f"{prefix}_{k}": clu[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms")})
    # row 11 at D = 1 beside the kick's D = 3
    for key, c in (("D1", results["check_pm_only"]["gather_pm_D1"]),
                   ("clustered_D1", results["pm_only_main_path"]["clustered"]["gather_pm_D1"])):
        byname["gather_pm"].update({
            f"{key}_max_abs_err": c["max_abs_err"], f"{key}_ms": c["ms"],
            f"{key}_plain_ms": c["plain_ms"], f"{key}_bound_ms": c["bound_ms"],
            f"{key}_library_ms": c["library_ms"]})
    # each kernel on the final, clustered slots of the runs that launch it
    # (prefix "clustered_": the bucket sustained run for rows 8-9)
    for name, prefix, phase, key in (
            ("deposit_pm", "clustered", "pm_only_main_path", "clustered"),
            ("gather_pm", "clustered", "pm_only_main_path", "clustered"),
            ("deposit_cells", "clustered", "main_path", "pm_clustered"),
            ("gather_cells", "clustered", "main_path", "pm_clustered"),
            ("deposit_cells", "cb4_clustered", "reach_main_path", "pm_clustered"),
            ("gather_cells", "cb4_clustered", "reach_main_path", "pm_clustered"),
            ("deposit_cells", "realistic", "realistic", "pm_final"),
            ("gather_cells", "realistic", "realistic", "pm_final"),
            ("deposit_blocks", "clustered", "bucket_sustained", "final_slots"),
            ("gather_blocks", "clustered", "bucket_sustained", "final_slots"),
            ("deposit_blocks", "global_clustered", "global_main_path", "pm_clustered"),
            ("gather_blocks", "global_clustered", "global_main_path", "pm_clustered"),
            ("deposit_blocks", "tight_clustered", "tight_main_path", "pm_clustered"),
            ("gather_blocks", "tight_clustered", "tight_main_path", "pm_clustered"),
            ("deposit_blocks", "p3m_final", "p3m_persistent", "pm_final"),
            ("gather_blocks", "p3m_final", "p3m_persistent", "pm_final")):
        clu = results[phase][key][name]
        byname[name].update({f"{prefix}_{k}": clu[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")})
    byname["deposit_blocks"].update(
        bucket_launches=results["bucket_sustained"]["launches"]["deposit_blocks"],
        flagship_device_ms_per_step=results["bucket_flagship"]["device_ms_per_step_by_group"])
    # the double instantiations: their float64 check, and their launches
    # on the float64 path that runs them (0 for row 7, which none does)
    f64p = results["f64_paths"]
    for name, (group, key, launches) in {
            "pair_sweep": ("rungs", "pair_sweep_bounded", f64p["rungs"]["launches"]["pair_sweep"]),
            "pair_sweep_subset": ("global", "subset_sweep",
                                  results["f64_global_rungs"]["launches"]["pair_sweep_subset"]),
            "deposit_cells": ("rungs", "deposit_cells", f64p["rungs"]["launches"]["deposit_cells"]),
            "gather_cells": ("rungs", "gather_cells", f64p["rungs"]["launches"]["gather_cells"]),
            "pair_sweep_reach": ("reach", "reach_one_sided",
                                 f64p["reach"]["launches"]["pair_sweep_reach"]),
            "pair_sweep_global": ("global", "pair_sweep_two_sided",
                                     f64p["global"]["launches"]["pair_sweep_global"]),
            "sweep_reach": ("reach", "reach_two_sided_unbounded",
                            f64p["reach"]["launches"]["sweep_reach"]),
            "deposit_blocks": ("global", "deposit_blocks",
                               f64p["global"]["launches"]["deposit_blocks"]),
            "gather_blocks": ("global", "gather_blocks", f64p["global"]["launches"]["gather_blocks"]),
            "deposit_pm": ("pm_only", "deposit_pm", f64p["pm_only"]["launches"]["deposit_pm"]),
            "gather_pm": ("pm_only", "gather_pm", f64p["pm_only"]["launches"]["gather_pm"]),
    }.items():
        c = results["check_f64"][group][key]
        byname[name].update({f"f64_{k}": c.get(k) for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        byname[name]["f64_launches"] = launches
    # rows 6 and 2 on every shape that checks them: the row pairs the
    # global kernel visited beside the pair tests needed, and the
    # unbounded launch of row 1's kernel (what rows 6 and 2 launched
    # before) bit for bit and its time
    pmc = pmu["cdm_baryon"]
    for name, prefix, c in (
            ("pair_sweep_global", "check", results["check_global"]["pair_sweep_two_sided"]),
            ("pair_sweep_global", "clustered", results["global_main_path"]["pair_sweep_clustered"]),
            ("pair_sweep_global", "p3m_final", results["p3m_persistent"]["sweep_final"]),
            ("pair_sweep_global", "multi_nonlinnu_final", mp["nonlinnu"]["row6_final"]),
            ("pair_sweep_global", "multi_soft0", mp["cdm_baryon"]["row6_final"]),
            ("pair_sweep_global", "multi_soft0_spline", mp["cdm_baryon"]["row6_spline"]),
            ("pair_sweep_global", "parallel_multi_soft0", pmc["row6"]),
            ("pair_sweep_global", "parallel_pencils", pp["pair_sweep"]),
            ("pair_sweep_global", "f64", results["check_f64"]["global"]["pair_sweep_two_sided"]),
            ("pair_sweep_subset", "check", results["global_rungs"]["subset_sweep"]),
            ("pair_sweep_subset", "multi_soft0", mp["cdm_baryon"]["row2_final"]),
            ("pair_sweep_subset", "parallel_multi_soft0", pmc["row2"]),
            ("pair_sweep_subset", "f64", results["check_f64"]["global"]["subset_sweep"])):
        byname[name].update({f"{prefix}_{k}": c[k] for k in (
            "row_pairs_visited", "pairs_tested", "bitwise_equal_unbounded",
            "max_abs_vs_unbounded", "unbounded_ms")})
    return kernels


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
    seconds = results["phase_seconds"] = {}
    results.update(build())
    results["check"] = _timed(seconds, "check", check_kernels)
    results["main_path"] = _timed(seconds, "main_path", main_path)
    results["realistic"] = _timed(seconds, "realistic", realistic, check_pm=True)
    results["check_global"] = _timed(seconds, "check_global", check_global_kernels)
    results["global_main_path"] = _timed(seconds, "global_main_path", global_main_path)
    results["global_realistic"] = _timed(seconds, "global_realistic", global_realistic)
    results["check_reach"] = _timed(seconds, "check_reach", check_reach_kernels)
    results["reach_main_path"] = _timed(
        seconds, "reach_main_path", _layout_main_path, "reach", 62, 124, 4, REACH_KERNELS)
    results["tight_main_path"] = _timed(
        seconds, "tight_main_path", _layout_main_path, "tight", 63, 126, 0, TIGHT_KERNELS)
    results["reach_realistic"] = _timed(
        seconds, "reach_realistic", realistic, n=250, mesh=500, ucb=4, kernels=REACH_KERNELS)
    results["tight_realistic"] = _timed(
        seconds, "tight_realistic", realistic, n=255, mesh=510, ucb=0, kernels=TIGHT_KERNELS)
    results["check_pm_only"] = _timed(seconds, "check_pm_only", check_pm_only_kernels)
    results["pm_only_main_path"] = _timed(seconds, "pm_only_main_path", pm_only_main_path)
    results["pm_only_realistic"] = _timed(seconds, "pm_only_realistic", pm_only_realistic)
    results["bucket_flagship"] = _timed(seconds, "bucket_flagship", bucket_flagship)
    results["bucket_sustained"] = _timed(seconds, "bucket_sustained", bucket_sustained)
    results["p3m_persistent"] = _timed(seconds, "p3m_persistent", p3m_persistent)
    results["global_rungs"] = _timed(seconds, "global_rungs", global_rungs)
    results["lean_kick"] = _timed(seconds, "lean_kick", lean_kick)
    results["lpt"] = _timed(seconds, "lpt", lpt)
    results["files"] = _timed(seconds, "files", files)
    results["check_f64"] = _timed(seconds, "check_f64", check_f64)
    results["f64_paths"] = _timed(seconds, "f64_paths", f64_main_paths, results)
    results["f64_global_rungs"] = _timed(
        seconds, "f64_global_rungs", global_rungs, dtype=torch.float64)
    results["f64_realistic"] = _timed(seconds, "f64_realistic", realistic, f64=True)
    results["pp"] = _timed(seconds, "pp", pp_phase)
    cache = tempfile.mkdtemp(prefix="chip_smoke_eb_")
    try:
        results["nu"] = _timed(seconds, "nu", nu_cosmology, cache=cache)
        results["multi"] = _timed(seconds, "multi", multi, cache)
        results["multi_cdm_baryon"] = results["multi"]["cdm_baryon"]
        sim, state = _global_sim(256**3, 512, "cuda", method="pm")
        results["render"] = _timed(seconds, "render", render, sim, state)
        results["parallel"] = _timed(seconds, "parallel", parallel, sim, state)
        del sim, state
        results["parallel_rungs"] = _timed(seconds, "parallel_rungs", parallel_rungs)
        results["parallel_realize"] = _timed(seconds, "parallel_realize", parallel_realize)
        # phase 14 reads phase 8's ν tables
        results["parallel_multi"] = _timed(seconds, "parallel_multi", parallel_multi, cache)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    results["parallel_pencils"] = _timed(seconds, "parallel_pencils", parallel_pencils)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    kernels = kernels_line(results)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
