"""Run configuration, the time-step limiter constants and the global
stepper (port of ``SimConfig``, the ``FAC_*`` / ``DELTA_A_MAX_*``
constants and ``Simulation`` for PM, P³M and PP, on one device or over
the 1D slab decomposition, concept_tpu/sim.py; reference
main.py:214-461, 697-996, 2345-2433).

The global stepper is leapfrog KDK with exact time integrals (reference
integration.py:712):

    kick:  mom ← mom − m ∇φ · ᔑ a⁻¹ dt
    drift: pos ← pos + mom/m · ᔑ a⁻² dt

Every particle takes the same Δt.  A P³M kick with CIC, Fourier
gradients, no interlacing and deconvolution of order 4 is the fused kick
of forces/p3m.py; every other PM or P³M kick is the generic PM of
forces/pm.py (plus, for P³M, the short-range sweep); 'pp' and
'ppnonperiodic' sum every pair directly (forces/pp.py, with the Ewald
correction for 'pp').  The host advances
the scalars (t, a, Δt, the Δt hysteresis of timestep.py) and the
fixed-size budgets.

With ``dist`` (grid/fft.GridDistribution, ``-n N``) each rank steps its
index shard of the particles, which it realizes on its slab
(parallel/step.realize_shard), and every quantity that sets Δt or a
budget is reduced over the ranks, so that all ranks take the same steps.
The PM part of a kick is ``parallel.step.pm_momentum_updates_
distributed_halo`` (CIC or any order, Fourier gradients, no
interlacing; the JAX package's condition), else the generic PM over the
ranks.  The short-range and PP parts run on every rank over the
all-gathered positions, and each rank keeps its own rows: the P³M sweep
(PERF.md row 6 on the card) is computed d times (ROADMAP Queue 2).

With the 2D pencils of ``-n AxB`` (grid/fft.GridDistribution2D) the
ranks step as the A·B ranks of ``-n A·B`` do (``self.dist`` is the
pencils' ``flat``), and the PM part of a PM or P³M kick with Fourier
gradients and no interlacing is ``parallel.step.pm_momentum_updates_
distributed_2d`` on the pencils (the JAX package's branch,
concept_tpu/sim.py:191-225); an interlaced or stencil kick runs the
1D paths over ``flat`` (the JAX package's reads the 1D ``dist.axis``
there, which its pencils lack: ROADMAP Queue 3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

import torch.distributed as tdist

from concept_tpu_torch.components import ParticleState, periodic_wrap
from concept_tpu_torch.forces.pm import interlace_pair, pm_gravity_momentum_updates
from concept_tpu_torch.forces.shortrange import shortrange_momentum_updates
from concept_tpu_torch.grid.fft import GridDistribution2D, check_distribution
from concept_tpu_torch.grid.interp import interpolation_order
from concept_tpu_torch.parallel.step import (
    pm_momentum_updates_distributed_2d, pm_momentum_updates_distributed_halo, realize_shard,
    reduce, replicate, rows_to_root,
)
from concept_tpu_torch.utils.terminal import warn

# Reference numeric defaults (main.py:2345-2433)
FAC_DYNAMICAL = 0.056
FAC_HUBBLE = 0.031
FAC_PM = 0.13
FAC_P3M = 0.14
DELTA_A_MAX_EARLY = 0.00153
DELTA_A_MAX_LATE = 0.022
DT_INCREASE_MAX_FAC = 1.5

METHODS = ("p3m", "pm", "pp", "ppnonperiodic")


@dataclass(frozen=True)
class SimConfig:
    """Static configuration of a single-component run."""

    boxsize: float
    potential_gridsize: int
    device: torch.device
    dtype: torch.dtype = torch.float32
    G: float = 1.0
    method: str = "p3m"
    # potential options (reference potential_options,
    # param/example_explanatory:163-208)
    interpolation_order: int = 2  # CIC
    deconvolve: tuple = (True, True)  # (upstream/deposit, downstream/gather)
    differentiation: object = "fourier"  # 'fourier' or a stencil order 2/4/6/8
    interlace: object = False  # a lattice name, a bool or an (up, down) pair
    # 'auto' | 'scatter' | 'sort' | 'sorted' | 'pallas' (grid/interp.py)
    deposit_method: str = "auto"
    softening: float = 0.0
    # 'plummer' | 'spline' (GADGET-2 cubic spline, the reference default)
    # | 'none' (reference softening_kernel, example_explanatory:372)
    softening_kernel: str = "spline"
    # P³M split scale rₛ and cutoff range (reference defaults:
    # scale = 1.25·boxsize/gridsize, range = 4.5·scale,
    # param/example_explanatory:211-218); None → derived defaults
    shortrange_scale: float | None = None
    shortrange_range: float | None = None
    shortrange_capacity: int = 0  # 0 → auto from the mean density
    ewald_gridsize: int = 64  # reference default (example_explanatory:210)
    # Δt limiter prefactors (reference Δt_base_background_factor /
    # Δt_base_nonlinear_factor, main.py:2401-2424)
    dt_base_background_factor: float = 1.0
    dt_base_nonlinear_factor: float = 1.0
    # Δa per-step bounds (reference Δa_max_early/late, commons.py:3883)
    da_max_early: float = DELTA_A_MAX_EARLY
    da_max_late: float = DELTA_A_MAX_LATE

    def derived_shortrange(self):
        scale = self.shortrange_scale
        if scale is None:
            scale = 1.25 * self.boxsize / self.potential_gridsize
        rng = self.shortrange_range
        if rng is None:
            rng = 4.5 * scale
        return scale, rng


class Simulation:
    """One matter-like particle component with PM, P³M or PP gravity and
    global time stepping, on one device or over the ranks of ``dist``."""

    def __init__(self, spec, config: SimConfig, bg, lin=None, dist=None):
        from concept_tpu_torch.forces.p3m import pm_block_capacity
        from concept_tpu_torch.forces.shortrange import auto_capacity, cell_grid_shape

        if config.method not in METHODS:
            raise ValueError(f"gravity has no method {config.method!r} "
                             f"(available: {', '.join(METHODS)})")
        self.spec = spec
        self.config = config
        self.bg = bg
        self.lin = lin
        # the pencils of -n AxB (None otherwise); everything but their PM
        # kick runs over the A·B ranks as -n A·B does
        self.pencils = dist if isinstance(check_distribution(dist), GridDistribution2D) else None
        self.dist = dist.flat if self.pencils is not None else dist
        cap = 0
        self._ewald_table = None
        if config.method == "pp":
            from concept_tpu_torch.forces.pp import make_ewald_table

            self._ewald_table = make_ewald_table(config.ewald_gridsize, config.device)
        if config.method == "p3m":
            # short-range state: PM-only steps have no short-range cells
            scale, rng = config.derived_shortrange()
            self._sr_scale, self._sr_range = scale, rng
            self._sr_ncells = cell_grid_shape(config.boxsize, rng)
            cap = config.shortrange_capacity
            if cap == 0 and spec.N:
                cap = auto_capacity(spec.N, self._sr_ncells)
            self._sr_capacity = cap
            self._sr_max_overflow = max(2048, (spec.N or 0) // 1024)
        self._pm_max_overflow = 65536
        self._k_pm = pm_block_capacity(spec.N, config.potential_gridsize)
        self._fused = (config.method == "p3m" and dist is None
                       and interpolation_order(config.interpolation_order) == 2
                       and config.differentiation in ("fourier", 0)
                       and interlace_pair(config.interlace) == ("sc", "sc")
                       and tuple(config.deconvolve) == (True, True))
        # steps and kicks of the run, the largest capacity K, the largest
        # straggler and PM-overflow counts of a kick, budget warnings, and
        # the largest PM deposit deficit |deposited/m − N| in particle
        # masses (m rounded to the state's dtype, as the deposit holds it)
        self.stats = {"steps": 0, "kicks": 0, "capacity_max": cap,
                      "sr_overflow_max": 0, "pm_overflow_max": 0,
                      "budget_warnings": 0, "pm_mass_deficit_max": 0.0}
        self.hysteresis = {}

    # ------------------------------------------------------------------ #
    def initial_state(self, a_begin: float, seed: int = 0, lpt_order: int = 1,
                      with_ids: bool = False, **kw) -> ParticleState:
        """The realized state (parallel/step.realize_shard): over the
        ranks each realizes its slab of the lattice and hands its
        particles to the ranks of their ids."""
        if self.dist is not None:
            self.dist.shard(self.spec.N)  # N/d particles a rank, or ValueError
        return realize_shard(self.lin, self.spec, self.config.boxsize, a_begin, self.dist,
                             with_ids=with_ids, seed=seed, lpt_order=lpt_order,
                             dtype=self.config.dtype, device=self.config.device, **kw)

    def shard(self, state: ParticleState) -> ParticleState:
        """This rank's index shard of a whole state (the state itself on
        one device): a snapshot's or an autosave's, which every rank
        reads whole."""
        if self.dist is None:
            return state
        lo, hi = self.dist.shard(state.pos.shape[0])
        return ParticleState(*(None if x is None else x[lo:hi].contiguous() for x in state))

    def whole(self, state: ParticleState, root: int | None = None) -> ParticleState:
        """The whole state from the ranks' shards, on every rank, or with
        ``root`` on that rank alone (the others get no rows: what a dump
        writes there); the state itself on one device."""
        if self.dist is None:
            return state
        if root is not None:
            return rows_to_root(state, self.dist, root)
        return ParticleState(*(None if x is None else replicate(x, self.dist)
                               for x in state))

    def _whole_pos(self, pos):
        return pos if self.dist is None else replicate(pos, self.dist)

    def reduce(self, x: torch.Tensor, op=tdist.ReduceOp.SUM) -> torch.Tensor:
        """x reduced over the ranks (x itself on one device)."""
        return reduce(x, self.dist, op)

    # ------------------------------------------------------------------ #
    def _kick(self, state: ParticleState, int_a1: float):
        """One kick, in place on the momenta: the fused P³M kick, or the
        generic PM of forces/pm.py (plus the short-range sweep for P³M).
        Returns (state, (n_sr_overflow, n_pm_overflow)), the counts that
        have a budget: the generic PM's block overflow is exact at any
        count and has none (0 here; its count is in the stats)."""
        cfg = self.config
        pos = state.pos
        # the pair forces of a rank's particles need every position
        own = slice(None)
        if self.dist is not None:
            own = slice(*self.dist.shard(pos.shape[0] * self.dist.n_devices))
        if cfg.method in ("pp", "ppnonperiodic"):
            from concept_tpu_torch.forces.pp import pp_momentum_updates

            state.mom.add_(pp_momentum_updates(
                self._whole_pos(pos), self.spec.mass, cfg.boxsize, int_a1, cfg.G,
                softening=cfg.softening, ewald_table=self._ewald_table,
                periodic=cfg.method == "pp", softening_kernel=cfg.softening_kernel)[own])
            self.stats["kicks"] += 1
            return state, (0, 0)
        comps = (pos[:, 0], pos[:, 1], pos[:, 2])
        n_sr = 0
        if self._fused:
            from concept_tpu_torch.forces.p3m import p3m_kick_components

            dmom, n_sr, n_pm, mass_sum = p3m_kick_components(
                *comps, self.spec.mass, cfg.boxsize,
                self._sr_scale, self._sr_range, int_a1, cfg.potential_gridsize,
                self._sr_ncells, self._sr_capacity, k_pm=self._k_pm,
                softening=cfg.softening, G=cfg.G,
                max_overflow=self._sr_max_overflow,
                pm_max_overflow=self._pm_max_overflow,
                softening_kernel=cfg.softening_kernel,
            )
            budget_pm = n_pm
        else:
            info = {}
            p3m = cfg.method == "p3m"
            scale = self._sr_scale if p3m else None
            spectral = (cfg.differentiation in ("fourier", 0)
                        and interlace_pair(cfg.interlace) == ("sc", "sc"))
            if self.pencils is not None and spectral:
                # the pencil kick: whole local deposits and gradients
                d = pm_momentum_updates_distributed_2d(
                    pos, self.spec.mass, cfg.potential_gridsize, cfg.boxsize, cfg.G,
                    int_a1, self.pencils, order=cfg.interpolation_order,
                    deconvolve=cfg.deconvolve, longrange_scale=scale,
                    deposit_method=cfg.deposit_method, info=info)
            elif self.dist is not None and spectral:
                # the halo-resident kick: nothing replicated
                d, _ = pm_momentum_updates_distributed_halo(
                    pos, self.spec.mass, cfg.potential_gridsize, cfg.boxsize, cfg.G,
                    int_a1, self.dist, order=cfg.interpolation_order,
                    deconvolve=cfg.deconvolve, longrange_scale=scale, info=info)
            else:
                (d,) = pm_gravity_momentum_updates(
                    [pos], [self.spec.mass], cfg.potential_gridsize, cfg.boxsize, cfg.G,
                    int_a1, order=cfg.interpolation_order, deconvolve=cfg.deconvolve,
                    differentiation=cfg.differentiation,
                    deposit_method=cfg.deposit_method, longrange_scale=scale,
                    interlace=cfg.interlace, info=info, dist=self.dist)
            dmom = d.unbind(1)
            if p3m:
                if self.dist is not None:
                    whole = self._whole_pos(pos)
                    comps = (whole[:, 0], whole[:, 1], whole[:, 2])
                dsr, n_sr = shortrange_momentum_updates(
                    comps, self.spec.mass, cfg.boxsize, self._sr_scale, self._sr_range,
                    int_a1, n_cells=self._sr_ncells, capacity=self._sr_capacity,
                    softening=cfg.softening, G=cfg.G,
                    max_overflow=self._sr_max_overflow,
                    softening_kernel=cfg.softening_kernel)
                dmom = tuple(a + b[own] for a, b in zip(dmom, dsr))
            n_pm, mass_sum, budget_pm = info["n_overflow"], info["mass_sum"], 0
        for d in range(3):
            state.mom[:, d] += dmom[d]
        st = self.stats
        st["kicks"] += 1
        st["sr_overflow_max"] = max(st["sr_overflow_max"], n_sr)
        st["pm_overflow_max"] = max(st["pm_overflow_max"], n_pm)
        m = float(torch.tensor(self.spec.mass, dtype=pos.dtype))
        st["pm_mass_deficit_max"] = max(
            st["pm_mass_deficit_max"], abs(float(mass_sum) / m - self.spec.N))
        return state, (n_sr, budget_pm)

    def _drift(self, state: ParticleState, int_a2: float) -> ParticleState:
        fac = int_a2 / self.spec.mass
        return state._replace(
            pos=periodic_wrap(state.pos + state.mom * fac, self.config.boxsize))

    def kick(self, state: ParticleState, int_a1: float) -> ParticleState:
        """One kick alone, as ``evolve`` begins it: for P³M the
        short-range capacity is refreshed first, and the kick's overflow
        counts are checked against the budgets.  The momenta are updated
        in place."""
        if self.config.method == "p3m":
            self._refresh_shortrange_capacity(state)
        state, (n_sr, n_pm) = self._kick(state, int_a1)
        self._check_overflow_budgets(n_sr, n_pm)
        return state

    def step(self, state: ParticleState, int_a1: float, int_a2: float):
        """One KDK-ordered update: kick(int_a1), then drift(int_a2).  The
        momenta are updated in place.  The kick's overflow counts are
        checked against the budgets at once (the JAX package keeps them
        and checks the last step's at period boundaries only, so a
        truncation mid-period goes unreported there)."""
        state, (n_sr, n_pm) = self._kick(state, int_a1)
        self._check_overflow_budgets(n_sr, n_pm)
        return self._drift(state, int_a2)

    def _check_overflow_budgets(self, n_sr: int, n_pm: int):
        """Compare a kick's overflow counts with the fixed budgets (the
        integers of the JAX package's check).  A count beyond its budget
        means forces were truncated at that kick: warn and grow the
        budget so it cannot recur."""
        if self.config.method == "p3m" and n_sr > self._sr_max_overflow:
            warn(f"short-range overflow {n_sr} exceeded the straggler "
                 f"budget {self._sr_max_overflow}: pair forces were "
                 f"truncated this step; growing the budget")
            self._sr_max_overflow = 2 * n_sr + 1024
            self.stats["budget_warnings"] += 1
        if n_pm > self._pm_max_overflow:
            warn(f"PM deposit-block overflow {n_pm} exceeded the budget "
                 f"{self._pm_max_overflow}: deposit mass was truncated "
                 f"this step; growing the budget")
            self._pm_max_overflow = 2 * n_pm + 1024
            self.stats["budget_warnings"] += 1
        elif n_pm > self._pm_max_overflow // 2:
            # keep the exact fallback comfortable (≤ half full)
            self._pm_max_overflow = 2 * n_pm + 1024

    def _refresh_shortrange_capacity(self, state: ParticleState,
                                     cap_max: int = 1024):
        """Grow the short-range bucket capacity (and the straggler budget)
        as clustering raises cell occupancies (reference runtime tile
        refinement, species.py:4170-4428).  Correctness does not depend
        on it: overflow beyond the capacity is exact through the
        straggler path while its budget holds; this keeps the budget at
        most half full."""
        from concept_tpu_torch.forces.shortrange import cell_counts

        counts = self.reduce(cell_counts(state.pos, self.config.boxsize,
                                          self._sr_ncells)).cpu().numpy()
        changed = False
        K = self._sr_capacity
        budget = self._sr_max_overflow // 2
        while K < cap_max and int(np.maximum(counts - K, 0).sum()) > budget:
            K = int(math.ceil((K * 2) / 8) * 8)
            changed = True
        overflow = int(np.maximum(counts - K, 0).sum())
        if overflow > budget:
            self._sr_max_overflow = 2 * overflow + 1024
            changed = True
        if changed and K != self._sr_capacity:
            self._sr_capacity = min(K, cap_max)
        self.stats["capacity_max"] = max(self.stats["capacity_max"],
                                         self._sr_capacity)

    # ------------------------------------------------------------------ #
    def base_timestep_size(self, a: float, v_max: float | None = None
                           ) -> tuple[float, str]:
        """Base Δt_max and its bottleneck (reference
        get_base_timestep_size, main.py:697-996): dynamical time, Hubble
        time, Δa_max and, with the largest particle speed, the P³M
        displacement bound fac_p3m·split scale per step, or for PM and PP
        fac_pm·mesh cell."""
        bg = self.bg
        cfg = self.config
        H = float(bg.hubble_np(a))
        rho = (self.spec.mass * self.spec.N / cfg.boxsize**3 / a**3
               if self.spec.N else 0.0)
        fac_bg = cfg.dt_base_background_factor
        fac_nl = cfg.dt_base_nonlinear_factor
        limits: list[tuple[float, str]] = []
        if rho > 0:
            limits.append((fac_bg * FAC_DYNAMICAL / math.sqrt(cfg.G * rho),
                           "the dynamical time scale"))
        if H > 0:
            limits.append((fac_bg * FAC_HUBBLE / H, "the Hubble time"))
            # Δa limiters: Δt ≈ Δa/(aH)
            da_max = cfg.da_max_early if a < 0.1 else cfg.da_max_late
            limits.append((da_max / (a * H), "Δa"))
        if v_max is not None and v_max > 0:
            # comoving drift speed ẋ = v_pec/a; displacement per step
            # bounded by a fraction of the split scale (P³M) or of the
            # mesh cell (PM)
            if cfg.method == "p3m":
                limits.append((fac_nl * FAC_P3M * self._sr_scale / (v_max / a),
                               "the P³M split scale"))
            else:
                cell = cfg.boxsize / cfg.potential_gridsize
                limits.append((fac_nl * FAC_PM * cell / (v_max / a), "the PM grid"))
        if not limits:
            return float("inf"), ""
        return min(limits, key=lambda lb: lb[0])

    def timestep_size(self, a: float, v_max: float | None = None) -> float:
        return self.base_timestep_size(a, v_max=v_max)[0]

    def evolve_static(self, state: ParticleState, t_total: float, n_steps: int):
        """Static-universe (enable_Hubble = False) leapfrog over cosmic
        time t_total in n_steps equal steps (the reference's test/
        drift_nohubble and kick_pp_without_ewald): a ≡ 1, so the kick and
        drift integrals are plain Δt.  A half kick and a full drift, then
        n_steps − 1 whole steps, then the closing half kick."""
        dt = t_total / n_steps
        state = self.step(state, 0.5 * dt, dt)
        for _ in range(n_steps - 1):
            state = self.step(state, dt, dt)
        return self.step(state, 0.5 * dt, 0.0)

    def evolve(self, state: ParticleState, a_begin: float, a_end: float,
               max_steps: int = 100000, static_dt=None,
               resume: dict | None = None, callback=None):
        """Leapfrog KDK from a_begin to a_end, the momenta synchronised at
        both ends: the first kick covers Δt/2, each later one the
        straddling interval, and a closing kick the last half step.

        Δt follows the reference's hysteresis (main.py:920-983): it starts
        at Δt_initial_fac·Δt_max, is reduced at once when a limiter binds,
        and may increase only once DT_PERIOD steps have passed since the
        last change.  ``static_dt`` (timestep.prepare_static_timestepping)
        records or replays the stepping.  ``resume`` (the ``hysteresis``
        of the previous segment, or of an autosave) carries Δt, Δt_min,
        the step counters and the kick sync point t_mom of the state,
        and, from a mid-segment autosave, the v_max of the last period
        boundary.  The hysteresis after a segment holds t_mom = a_end,
        where its closing kick synchronised the momenta (the JAX package
        keeps the last step's t_mom there and so kicks [t_mom, t_end]
        twice across a dump; ROADMAP Queue 3).  ``callback(flat_state, t,
        a, step_count)`` runs after every step; ``flat_state()`` returns
        the state, whose momenta then sit at ``hysteresis['t_mom']``.
        Returns (state, a)."""
        from concept_tpu_torch import timestep as ts

        bg = self.bg
        t = float(bg.t_of_a_np(a_begin))
        t_end = float(bg.t_of_a_np(a_end))
        a = a_begin
        step_count = 0
        t_mom = t  # the momenta are synchronised at t
        replay = static_dt is not None and static_dt.applies
        records = static_dt is not None and static_dt.records

        def dt_max_at(a_now, v_now):
            """(Δt_max, bottleneck); static replay overrides the
            limiters (reference main.py:787-800)."""
            if replay:
                a_next = a_now + static_dt.delta_a(a_now)
                if a_next > 1.0:
                    # Δt = ∞ once a + Δa passes 1 (main.py:615); the t_end
                    # clamp bounds the actual step
                    return float("inf"), "static time-stepping"
                return (float(bg.t_of_a_np(a_next)) - float(bg.t_of_a_np(a_now)),
                        "static time-stepping")
            return self.base_timestep_size(a_now, v_max=v_now)

        def refresh_v(a_now, st):
            # velocity-based limiters, refreshed at period boundaries
            # (reference main.py:2380)
            v2 = self.reduce((st.mom * st.mom).sum(dim=1).max(), tdist.ReduceOp.MAX)
            return math.sqrt(float(v2)) / (a_now * self.spec.mass)

        def record(a_now, dt_max):
            if records and math.isfinite(dt_max):
                static_dt.record(
                    a_now, float(bg.a_of_t_np(min(t + dt_max, t_end))) - a_now)

        p3m = self.config.method == "p3m"
        v_max = refresh_v(a, state)
        if p3m:
            self._refresh_shortrange_capacity(state)
        dt_max, _ = dt_max_at(a, v_max)
        record(a, dt_max)
        dt = ts.DT_INITIAL_FAC * dt_max if math.isfinite(dt_max) else t_end - t
        dt_min = 1e-4 * dt  # reference Δt_min = 1e-4·Δt_begin (main.py:192)
        step_last_sync = 0
        if resume:
            dt = float(resume.get("dt", dt))
            dt_min = float(resume.get("dt_min", dt_min))
            step_count = int(resume.get("step_count", 0))
            step_last_sync = int(resume.get("step_last_sync", step_count))
            if resume.get("t_mom") is not None:
                t_mom = float(resume["t_mom"])
            if resume.get("v_max") is not None:
                v_max = float(resume["v_max"])
        self.hysteresis = {"dt": dt, "dt_min": dt_min, "step_count": step_count,
                           "step_last_sync": step_last_sync, "t_mom": t_mom,
                           "v_max": v_max}
        while t < t_end - 1e-12 * abs(t_end):
            if step_count and (step_count - step_last_sync) >= ts.DT_PERIOD:
                # period boundary: full limiter refresh, Δt may increase
                v_max = refresh_v(a, state)
                if p3m:
                    self._refresh_shortrange_capacity(state)
                dt_max, bn = dt_max_at(a, v_max)
                record(a, dt_max)
                if dt > dt_max or dt_max > ts.DT_INCREASE_MIN_FAC * dt:
                    dt, _ = ts.update_base_timestep_size(
                        dt, dt_min, dt_max, bn, step_count - step_last_sync,
                        dt_increase_max_factor=DT_INCREASE_MAX_FAC,
                        tolerate_danger=replay)
                    step_last_sync = step_count
            else:
                # mid-period: reduction only
                dt_max, bn = dt_max_at(a, v_max)
                if dt > dt_max:
                    dt, _ = ts.update_base_timestep_size(
                        dt, dt_min, dt_max, bn, allow_increase=False,
                        tolerate_danger=replay)
                    step_last_sync = step_count
            dt = min(dt, t_end - t)
            # kick target: the midpoint of the coming drift
            t_mid = min(t + 0.5 * dt, t_end)
            int_a1 = bg.integrals_np(t_mom, t_mid, keys=("a**(-1)",))["a**(-1)"]
            int_a2 = bg.integrals_np(t, t + dt, keys=("a**(-2)",))["a**(-2)"]
            state = self.step(state, int_a1, int_a2)
            t_mom = t_mid
            t += dt
            a = float(bg.a_of_t_np(t))
            step_count += 1
            self.stats["steps"] += 1
            self.hysteresis = {"dt": dt, "dt_min": dt_min,
                               "step_count": step_count,
                               "step_last_sync": step_last_sync, "t_mom": t_mom,
                               "v_max": v_max}
            if callback is not None:
                callback(lambda st=state: st, t, a, step_count)
            if step_count >= max_steps:
                raise RuntimeError("max_steps exceeded")
        # the closing half kick synchronises the momenta at t_end
        if t_mom < t_end - 1e-12 * abs(t_end):
            int_a1 = bg.integrals_np(t_mom, t_end, keys=("a**(-1)",))["a**(-1)"]
            state = self.step(state, int_a1, 0.0)
        # the next segment refreshes v_max at its start, as this one did
        self.hysteresis.update(t_mom=t_end, v_max=None)
        return state, a
