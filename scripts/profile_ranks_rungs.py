"""Where a rung base step over N ranks spends its time: example_basic
realized at n³ on grid ``mesh`` (256³ / 512 by default), stepped by
``P3MRungSimulation(dist=...)`` over N ranks of their own processes
(parallel/ranks.Ranks: ``nccl`` on ``cuda:r``), ``--steps`` base steps
timed on the host clock between device synchronisations, then ``--steps``
more under torch.profiler on rank 0.  Prints per N the ms of each base
step and rank 0's costliest operations by host time and by device time.

    python3 scripts/profile_ranks_rungs.py --ranks 1 2 4 [--device cpu --n 16 --mesh 64]

N = 1 is a world of one rank (the ranks path at world size 1); N > 1
needs N cards.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _work(n_ranks: int, n: int, mesh: int, steps: int, device: str, rank):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from concept_tpu_torch.grid.fft import GridDistribution
    from concept_tpu_torch.p3mrungs import RungSimulationAdapter
    from concept_tpu_torch.parallel.ranks import init_rank
    from concept_tpu_torch.sim import SimConfig

    r, store = rank
    dev = init_rank(r, n_ranks, store, torch.device(device))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda d: None)
    dist = GridDistribution()
    cfg, consts, bg, lin, spec, soft = cs._example(n, mesh)
    config = SimConfig(boxsize=cfg.boxsize, potential_gridsize=mesh, device=dev,
                       dtype=torch.float32, G=consts.G_Newton, softening=soft,
                       softening_kernel=cfg.softening_kernel)
    ad = RungSimulationAdapter(spec, config, bg, lin, N_rungs=cfg.N_rungs,
                               fac_rung=cfg.Delta_t_rung_factor, dist=dist)
    flat = ad.initial_state(cfg.a_begin, seed=0)
    sim = ad.inner
    st = sim.init_state(tuple(flat.pos[:, k] for k in range(3)),
                        tuple(flat.mom[:, k] for k in range(3)), ids=flat.ids)
    del flat
    t = t_mom = float(bg.t_of_a_np(cfg.a_begin))
    st = sim.assign_initial_rungs(st, sim._timestep(cfg.a_begin, 0.0))
    v = 0.0

    def step():
        nonlocal st, t, t_mom, v
        dt = sim._timestep(float(bg.a_of_t_np(t)), v)
        st, vmax = sim.base_step(st, t, dt, t_mom)
        if sim.needs_rebucket:
            st = sim.rebucket(st)
        t_mom, t = t + 0.5 * dt, t + dt
        v = vmax / (float(bg.a_of_t_np(t)) * sim.mass)

    ms = []
    for _ in range(steps):
        sync(dev)
        t0 = time.perf_counter()
        step()
        sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        for _ in range(steps):
            step()
        sync(dev)
    if r == 0:
        print(f"== {n}³ / grid {mesh} over {n_ranks} rank(s): ms a base step "
              f"{[round(x, 1) for x in ms]}; rebuckets and rungs {sim.stats}", flush=True)
        ka = prof.key_averages()
        print(ka.table(sort_by="self_cpu_time_total", row_limit=15, max_name_column_width=60),
              flush=True)
        if dev.type == "cuda":
            print(ka.table(sort_by="self_cuda_time_total", row_limit=10,
                           max_name_column_width=60), flush=True)


def main(argv=None) -> int:
    import torch

    from concept_tpu_torch.parallel.ranks import Ranks

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--mesh", type=int, default=512)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    for n_ranks in a.ranks:
        with Ranks(n_ranks, torch.device(a.device)) as started:
            started.start(_work, n_ranks, a.n, a.mesh, a.steps, a.device)
            _work(n_ranks, a.n, a.mesh, a.steps, a.device, rank=(0, started.store))
    return 0


if __name__ == "__main__":
    sys.exit(main())
