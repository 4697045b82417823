"""Adaptive per-particle rungs on the global stepper: short-range kicks at
power-of-two sub-cadences of the base step (port of concept_tpu/rungs.py;
reference species.py:2340-2597 rung bookkeeping, main.py:1347-1443
driftkick cadence, main.py:2433 the fac_softening rung criterion).

The state is a flat ``ParticleState``.  Each base step kicks the long
range over the whole step, assigns the rungs from a probe of the
short-range field, sorts the particles by rung so that the rungs a
substep fires form a suffix, and drifts through 2^max_rung substeps; at
each the suffix of fired rungs is swept as receivers against every
particle as suppliers (``forces/shortrange.shortrange_momentum_updates_on_subset``,
the global kernel of PERF.md row 2 on the card, within each set's
occupancy bounds), each scaled
by its own rung's kick integral.  The rung stepper on the persistent cell
layout (p3mrungs.py) is the production path; this one serves
``Simulation`` states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FAC_SOFTENING = 0.025  # reference main.py:2433 (GADGET ErrTolIntAccuracy analogue)


def assign_rungs(dmom_short, mass: float, kick_integral: float, dt_base: float,
                 softening: float, N_rungs: int = 8, fac: float = FAC_SOFTENING):
    """Per-particle rung from the short-range momentum updates dmom_short
    (N, 3) over kick_integral: Δt_i = fac·√(ε/|ẍ_i|), rung_i =
    clip(⌈log2(Δt_base/Δt_i)⌉, 0, N_rungs − 1), int8."""
    acc = torch.sqrt((dmom_short * dmom_short).sum(dim=1)) / (
        mass * max(kick_integral, 1e-30))
    dt_i = fac * torch.sqrt(softening / torch.clamp(acc, min=1e-30))
    rung = torch.ceil(torch.log2(torch.clamp(dt_base / dt_i, min=1e-30)))
    return torch.clamp(rung, 0, N_rungs - 1).to(torch.int8)


def rung_kick_schedule(max_rung: int):
    """The rungs kicked at each substep boundary i + 1 (i = 0 ..
    2^max_rung − 1): {k : (i+1) mod 2^(max_rung−k) == 0}."""
    return [[k for k in range(max_rung + 1) if (i + 1) % (1 << (max_rung - k)) == 0]
            for i in range(1 << max_rung)]


def _pad_suffix(m: int, n: int, quantum: int = 256) -> int:
    """The active suffix's size rounded up to a quantum (the JAX package
    bounds its compile variants with it; kept so that both sweep the same
    receivers)."""
    return min(n, ((m + quantum - 1) // quantum) * quantum) if m else 0


def evolve_rungs_p3m(sim, state, a_begin: float, a_end: float,
                     N_rungs: int = 4, max_steps: int = 10000,
                     stats: dict | None = None):
    """Evolve the flat ``state`` of the global stepper ``sim``
    (``sim.Simulation`` with P³M gravity) from a_begin to a_end with
    adaptive rungs: the long range at the base cadence, the short range
    subcycled with per-rung compaction (see the module docstring).

    ``stats`` receives receiver_rows (Σ over substeps of the receiver
    rows swept), full_rows (N a substep: what a full sweep would take)
    and max_rung.  Returns (state with its rungs, a).  The short range
    uses ``sim.config.softening_kernel``, where the JAX package's takes
    its functions' default, 'plummer', whatever the configuration says."""
    from concept_tpu_torch.forces.pm import pm_gravity_momentum_updates
    from concept_tpu_torch.forces.shortrange import (
        cell_counts, shortrange_momentum_updates, shortrange_momentum_updates_on_subset,
    )

    cfg = sim.config
    bg = sim.bg
    mass = sim.spec.mass
    N = state.pos.shape[0]
    t = float(bg.t_of_a_np(a_begin))
    t_end = float(bg.t_of_a_np(a_end))
    a = a_begin
    eps = cfg.softening if cfg.softening > 0 else cfg.boxsize / cfg.potential_gridsize
    sr = dict(n_cells=sim._sr_ncells, softening=cfg.softening, G=cfg.G,
              softening_kernel=cfg.softening_kernel)

    def short_dmom(pos, kick_int):
        dm, _ = shortrange_momentum_updates(
            pos.unbind(1), mass, cfg.boxsize, sim._sr_scale, sim._sr_range,
            kick_int, capacity=sim._sr_capacity, **sr)
        return torch.stack(dm, dim=1)

    def long_dmom(pos, kick_int):
        (dmom,) = pm_gravity_momentum_updates(
            [pos], [mass], cfg.potential_gridsize, cfg.boxsize, cfg.G,
            kick_int, order=cfg.interpolation_order, deconvolve=cfg.deconvolve,
            differentiation=cfg.differentiation, deposit_method=cfg.deposit_method,
            longrange_scale=sim._sr_scale, interlace=cfg.interlace)
        return dmom

    def cap_of(pos_subset) -> int:
        top = int(cell_counts(pos_subset, cfg.boxsize, sim._sr_ncells).max())
        return max(8, int(math.ceil((top + 1) / 8)) * 8)

    rungs = state.rungs
    steps = 0
    if stats is not None:
        stats.setdefault("receiver_rows", 0)
        stats.setdefault("full_rows", 0)
    while t < t_end - 1e-12 * abs(t_end):
        dt = min(sim.timestep_size(a), t_end - t)
        int_long = bg.integrals_np(t, t + dt, keys=("a**(-1)",))["a**(-1)"]
        state = state._replace(mom=state.mom + long_dmom(state.pos, int_long))
        # rungs from the current short-range field
        probe_int = bg.integrals_np(t, t + 0.01 * dt, keys=("a**(-1)",))["a**(-1)"]
        rungs = assign_rungs(short_dmom(state.pos, probe_int), mass, probe_int, dt,
                             eps, N_rungs=N_rungs)
        rungs_np = rungs.cpu().numpy()
        max_rung = int(rungs_np.max())
        if stats is not None:
            stats["max_rung"] = max(stats.get("max_rung", 0), max_rung)
        # sorted by rung, the fired rungs of a substep form a suffix
        order = torch.argsort(rungs, stable=True)
        state = state._replace(pos=state.pos[order], mom=state.mom[order],
                               ids=None if state.ids is None else state.ids[order])
        rungs = rungs[order]
        rungs_np = rungs_np[order.cpu().numpy()]
        m_pad = [_pad_suffix(int((rungs_np >= k).sum()), N) for k in range(max_rung + 1)]
        sup_cap = cap_of(state.pos)

        n_sub = 1 << max_rung
        sub_edges = np.linspace(t, t + dt, n_sub + 1)
        rung_idx = rungs.to(torch.int64)
        for i, fired in enumerate(rung_kick_schedule(max_rung)):
            int_drift = bg.integrals_np(sub_edges[i], sub_edges[i + 1],
                                        keys=("a**(-2)",))["a**(-2)"]
            state = sim._drift(state, float(int_drift))
            kmin = min(fired)
            per_rung = np.zeros(N_rungs, dtype=np.float64)
            for k in fired:
                lo = sub_edges[i + 1 - (1 << (max_rung - k))]
                per_rung[k] = bg.integrals_np(lo, sub_edges[i + 1],
                                              keys=("a**(-1)",))["a**(-1)"]
            Mp = m_pad[kmin]
            if stats is not None:
                stats["receiver_rows"] += Mp
                stats["full_rows"] += N
            if Mp == 0:
                continue
            recv = state.pos[N - Mp:]
            dm_unit = shortrange_momentum_updates_on_subset(
                recv, state.pos, mass, cfg.boxsize, sim._sr_scale, sim._sr_range,
                capacity_recv=min(sup_cap, cap_of(recv)), capacity_sup=sup_cap, **sr)
            # each row's own rung interval; the padding rows (rung < kmin) get 0
            scale = torch.as_tensor(per_rung, dtype=cfg.dtype,
                                    device=recv.device)[rung_idx[N - Mp:]]
            state.mom[N - Mp:] += dm_unit * scale[:, None]
        t += dt
        a = float(bg.a_of_t_np(t))
        steps += 1
        if steps >= max_steps:
            raise RuntimeError("max_steps exceeded")
    return state._replace(rungs=rungs), a
