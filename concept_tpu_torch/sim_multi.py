"""Several components: particles and self-gravitating fluids (port of
concept_tpu/sim_multi.py; reference main.py:214-461 with the fluid kicks
of interactions.py:2359 and the fluid drifts of fluid.py).

Gravity coupling (reference conventions, interactions.py:2854-2961):
  potential sources: each particle component deposits its mass; fluids
  contribute their ϱ grid times a^{−3w_eff} at the kick's scale factor
  (resampled in k-space where the fluid grid differs from the potential
  grid).
  particle kick: Δmom = −m ∇φ ᔑa⁻¹dt (P³M components take the screened
                 long range, plus their self and component-pair sweeps)
  fluid kick:    ΔJᵐ  = −(ϱ + c⁻²𝒫) ∂ᵐφ ᔑa⁻¹dt
  fluid drift:   the Kurganov-Tadmor (or MacCormack) flux terms, fluid.py
  lapse force:   the fictitious 'lapse' fluid's potential kicks the
                 decaying components ∝ ᔑa^{−3w_eff}·Γ/H dt

Every component steps with one global Δt (leapfrog KDK with exact time
integrals).  The host computes the per-step scalars (the integrals, the
fluids' w and w_eff, the decay factors) as the JAX package does, and
the device runs the kick and the drift: the PM deposit and gather are
``index_add_`` and plain gathers (grid/interp.py), the P³M sweeps the
CUDA kernels of PERF.md rows 6 and 2 (forces/shortrange.py).

Departures from the JAX package: the vacuum warning of the MacCormack
path reads its count on the host (one sync, that path only); a
per-step ``callback`` lets the run autosave after any step.

Over the ranks of a ``-n N`` run (``dist``, grid/fft.GridDistribution;
:func:`shard_multi_state`) each rank holds the index shard of every
particle component (N/d particles) and its x-rows of every fluid grid
(``dist.rows``, which need not split evenly), and no rank holds a whole
grid or component during the steps.  A kick sends each particle
component's shard to the x-slabs (parallel/step.sort_to_slabs), deposits
it with the halo deposit, adds the components and the fluids' rows
(their slab FFTs, resampled by ``copy_modes(dist=)``) on the rank's
y-slab, takes the potentials and gradients there, gathers each
component's kick from the gradient slabs with the halo gather and sends
it back to its index shard; each fluid takes its gradient on its own
rows.  The P³M sweeps run on the component's positions all-gathered:
row 6 over the whole component, each rank keeping its own receivers'
rows, as sim.Simulation does (d times the work), row 2 with the rank's
own receivers against the supplier's whole positions (no repeated
work).  The drift runs the fluid solvers on each rank's rows with their
halo (fluid.py), and every quantity a decision reads (the bucket
capacities, the vacuum density and its residual count, the deposit's
mass) is reduced over the ranks, so that every rank takes the same
steps.  The JAX package shards the same state and lets GSPMD insert
these collectives (concept_tpu/sim_multi.py:42).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as tdist
from torch.profiler import record_function

from concept_tpu_torch import timestep as tstep
from concept_tpu_torch.components import (
    ComponentSpec, EquationOfState, FluidState, periodic_wrap,
)
from concept_tpu_torch.fluid import (
    kt_step, maccormack_step, vacuum_correct, vacuum_redistribute,
)
from concept_tpu_torch.forces.pm import gravity_potential_slab
from concept_tpu_torch.forces.registry import find_interactions
from concept_tpu_torch.forces.shortrange import (
    cell_counts, cell_grid_shape, shortrange_momentum_updates,
    shortrange_momentum_updates_on_subset,
)
from concept_tpu_torch.grid import fourier
from concept_tpu_torch.grid.fft import check_distribution, exchange, irfft3, rfft3
from concept_tpu_torch.grid.interp import deposit, gather
from concept_tpu_torch.ic import displacement_from_delta, realize_delta_slab, realize_sigma_grids
from concept_tpu_torch.parallel.step import (
    deposit_distributed_halo, gather_distributed_halo, gather_rows, reduce, replicate,
    rows_to_root, slab_gradient, sort_to_slabs, to_shard_order,
)
from concept_tpu_torch.param import is_selected
from concept_tpu_torch.sim import (
    DT_INCREASE_MAX_FAC, FAC_DYNAMICAL, FAC_HUBBLE, SimConfig,
)
from concept_tpu_torch.utils.terminal import masterwarn


class MultiState(NamedTuple):
    particles: dict  # name → ParticleState (may be empty)
    fluids: dict  # name → FluidState


def _x_rows(f: FluidState, fn) -> FluidState:
    """fn applied to each grid of a fluid with its x axis (−3) first, the
    axis moved back after."""
    return FluidState(*(None if x is None else fn(x.movedim(-3, 0)).movedim(0, -3)
                        for x in f))


def shard_multi_state(state: MultiState, dist) -> MultiState:
    """A whole MultiState (a snapshot's, an autosave's, a test's) → this
    rank's part of it over the ranks of ``dist`` (the state itself where
    ``dist`` is None): each particle component's index shard
    (:meth:`GridDistribution.shard`, N/d a rank) and each fluid grid's
    x-rows (:meth:`GridDistribution.rows`, even or not).  The port's
    counterpart of concept_tpu/sim_multi.py:42, which places the same
    pieces on the devices of a mesh."""
    if check_distribution(dist) is None:
        return state
    particles = {}
    for name, ps in state.particles.items():
        lo, hi = dist.shard(ps.pos.shape[0])
        particles[name] = ps._replace(**{k: v[lo:hi].contiguous()
                                         for k, v in ps._asdict().items() if v is not None})
    fluids = {}
    for name, f in state.fluids.items():
        x0, rows = dist.rows(f.varrho.shape[-1])
        fluids[name] = _x_rows(f, lambda x: x[x0:x0 + rows].contiguous())
    return MultiState(particles=particles, fluids=fluids)


def _first(sel, default):
    """A selector dict's first value, or the value itself."""
    if isinstance(sel, dict):
        return next(iter(sel.values()), default)
    return sel if sel is not None else default


def _options(fluid_options, scheme: str) -> dict:
    """The fluid_options block of ``scheme`` ('kurganovtadmor' or
    'maccormack'), spelt with or without hyphens."""
    out = {}
    for key, val in (fluid_options or {}).items():
        if key.lower().replace("-", "") == scheme:
            out = val
    return out


class MultiSimulation:
    """Particle components (PM or P³M gravity) and fluid components
    (constant or splined w) on one device or over the ranks of ``dist``
    (each holding its part of the state, :func:`shard_multi_state`), one
    global Δt."""

    def __init__(self, particle_specs, fluid_specs, config: SimConfig, bg, lin=None,
                 light_speed: float = 1.0, fluid_Omegas: dict | None = None,
                 rho_crit: float | None = None, eos: dict | None = None,
                 fluid_seeds: dict | None = None, fluid_options: dict | None = None,
                 fluid_scheme_select: dict | None = None,
                 approximations: dict | None = None, dist=None):
        self.dist = check_distribution(dist)
        if particle_specs is None:
            particle_specs = []
        elif isinstance(particle_specs, ComponentSpec):
            particle_specs = [particle_specs]
        self.pspecs = {s.name: s for s in particle_specs}
        self.fspecs = {s.name: s for s in fluid_specs}
        self.hysteresis = {}
        self.config = config
        self.bg = bg
        self.lin = lin
        self.light_speed = light_speed
        self.fluid_Omegas = fluid_Omegas or {}
        self.rho_crit = rho_crit
        # each fluid's equation of state: a spline (exact Fermi-Dirac for
        # ν) or the spec's constant w (reference species.py:2940-3526)
        self.eos = {name: (eos or {}).get(name) or EquationOfState.constant(s.w)
                    for name, s in self.fspecs.items()}
        self._fluid_seeds = fluid_seeds or {}
        # per-fluid 'P=wρ' approximation (reference select_approximations,
        # species.py:1320-1351): 𝒫 = w·c²·ϱ of the nonlinear ϱ
        self.P_eq_wrho = dict(approximations or {})
        # the gravitating components through the registry (reference
        # find_interactions, interactions.py:2456-2645); specs that select
        # no force (hand-built setups) all gravitate
        all_specs = list(self.pspecs.values()) + list(self.fspecs.values())
        names = {s.name for (force, _m, recv, _s) in find_interactions(all_specs, "long-range")
                 if force == "gravity" for s in recv}
        self.gravitating = names or {s.name for s in all_specs}
        # Kurganov-Tadmor options (reference fluid_options, example_explanatory:406-429)
        kt_opts = _options(fluid_options, "kurganovtadmor")
        self._kt_rk_order = int(_first(kt_opts.get("Runge-Kutta order"), 2))
        self._kt_limiter = str(_first(kt_opts.get("flux_limiter_select"), "mc"))
        self.fluid_scheme = {}
        for name, s in self.fspecs.items():
            scheme = is_selected(s, fluid_scheme_select or {}, default="kurganovtadmor")
            scheme = str(scheme).lower().replace("-", "").replace(" ", "")
            if scheme not in ("kurganovtadmor", "maccormack"):
                raise ValueError(f"unknown fluid scheme {scheme!r} for component {name!r}")
            self.fluid_scheme[name] = scheme
        mc_opts = _options(fluid_options, "maccormack")

        def _mc(key, default):
            # ours ('smoothing') and the reference's selector form ('smoothing_select')
            return _first(mc_opts.get(key, mc_opts.get(f"{key}_select")), default)

        self._mc_vacuum = bool(_mc("vacuum_corrections", True))
        passes = _mc("max_vacuum_corrections", 2)
        if isinstance(passes, (tuple, list)):
            # the reference's (1, 'gridsize') form: take the numeric entry
            passes = next((p for p in passes if isinstance(p, (int, float))), 2)
        self._mc_vacuum_passes = int(passes)
        self._mc_smoothing = float(_mc("smoothing", 1.0))
        self._vacuum_warned: set = set()
        if _mc("foresight", None) is not None:
            masterwarn("fluid_options MacCormack 'foresight' has no effect: vacuum "
                       "handling here is conservative redistribution per step, not "
                       "look-ahead detection")
        # per-particle-component gravity method: P³M components take the
        # screened long range and the pair sweeps
        self.p_methods = {name: (s.force_method("gravity") or "pm")
                          for name, s in self.pspecs.items()}
        self.p3m_names = [n for n, m in self.p_methods.items() if m == "p3m"]
        if self.p3m_names:
            self._sr_scale = 1.25 * config.boxsize / config.potential_gridsize
            self._sr_range = 4.5 * self._sr_scale
            self._sr_ncells = cell_grid_shape(config.boxsize, self._sr_range)
            self._sr_caps = {}  # per component, refreshed on the host
        # the lapse force (reference interactions.py:2963-3037) is supplied
        # by the fictitious 'lapse' fluid alone
        self.lapse_supplier = next(
            (n for n, s in self.fspecs.items() if s.species == "lapse"), None)
        # the largest PM deposit deficit |deposited/m − N| in particle
        # masses, read from the device at the end of each evolve
        self.stats = {"pm_mass_deficit_max": 0.0}
        self._deficit = None

    def _refresh_sr_capacities(self, state: MultiState):
        """The P³M buckets' capacity of each component: the largest cell
        occupancy + 1, rounded up to 8 (at least 8), never shrinking.
        Over the ranks the occupancies are the whole component's (the
        ranks' counts summed), so that every rank takes the same."""
        for name in self.p3m_names:
            if name not in state.particles:
                continue
            counts = self.reduce(cell_counts(state.particles[name].pos, self.config.boxsize,
                                              self._sr_ncells))
            need = max(8, int(math.ceil((int(counts.max()) + 1) / 8)) * 8)
            if need > self._sr_caps.get(name, 0):
                self._sr_caps[name] = need

    def reduce(self, x, op=tdist.ReduceOp.SUM):
        """x reduced over the ranks (x itself on one device)."""
        return reduce(x, self.dist, op)

    def _y_rows(self, n: int):
        """The kj rows of this rank's y-slab of an n-grid (None on one
        device)."""
        return None if self.dist is None else self.dist.rows(n)

    def _fluid_slab(self, rho, n: int):
        """rfft of a fluid's ϱ grid (with ``dist`` its x-rows) resampled
        onto the potential's n-grid (this rank's y-slab of it)."""
        nf = rho.shape[-1]
        rho_k = rfft3(rho, self.dist)
        return rho_k if nf == n else fourier.copy_modes(rho_k, nf, n, dist=self.dist)

    def shard(self, state: MultiState) -> MultiState:
        """This rank's part of a whole state (:func:`shard_multi_state`)."""
        return shard_multi_state(state, self.dist)

    def whole(self, state: MultiState, root: int | None = None) -> MultiState:
        """The whole state from the ranks' parts, on every rank, or with
        ``root`` on that rank alone (the others get no rows: what a dump or
        an autosave writes there); the state itself on one device."""
        dist = self.dist
        if dist is None:
            return state
        if root is not None:
            def rows(x):
                dest = torch.full((x.shape[0],), root, dtype=torch.int64, device=x.device)
                return exchange([x], dest, dist)[0]

            particles = {k: rows_to_root(ps, dist, root) for k, ps in state.particles.items()}
        else:
            def rows(x):
                return gather_rows([x], dist)[0]

            particles = {k: ps._replace(**{f: replicate(v, dist)
                                           for f, v in ps._asdict().items() if v is not None})
                         for k, ps in state.particles.items()}
        return MultiState(particles=particles,
                          fluids={k: _x_rows(f, rows) for k, f in state.fluids.items()})

    # ------------------------------------------------------------------ #
    def _density_slab(self, state: MultiState, a: float, weff: dict, slabbed=None):
        """The combined source slab Σ_s a^{−3w_eff,s}ϱ_s(k) (the a⁻¹ of the
        Poisson factor is in the kick integral); with ``dist`` this rank's
        y-slab of it, the particle components deposited from their
        slab-resident particles ``slabbed`` (name → :func:`sort_to_slabs`'
        result) onto the rank's x-slab."""
        cfg = self.config
        n = cfg.potential_gridsize
        cell_volume = (cfg.boxsize / n) ** 3
        slab = None
        grid_p = None
        for name, pstate in state.particles.items():
            if name not in self.gravitating:
                continue
            spec = self.pspecs[name]
            if self.dist is None:
                g = deposit(pstate.pos, spec.mass, n, cfg.boxsize,
                            order=cfg.interpolation_order)
            else:
                pos_s, w_s, _, _ = slabbed[name]
                g = deposit_distributed_halo(pos_s, w_s, spec.mass, n, cfg.boxsize,
                                             cfg.interpolation_order, self.dist)
            m = float(torch.tensor(spec.mass, dtype=g.dtype))
            deficit = (self.reduce(g.sum(dtype=torch.float64)) / m - spec.N).abs()
            self._deficit = deficit if self._deficit is None else torch.maximum(
                self._deficit, deficit)
            grid_p = g if grid_p is None else grid_p + g
        if grid_p is not None:
            # the upstream deconvolution applies to the particle deposits
            # only (reference interactions.py:2060-2080)
            slab = rfft3(grid_p / cell_volume, self.dist) * fourier.deconvolution_factor(
                n, cfg.interpolation_order, grid_p.dtype, grid_p.device, self._y_rows(n))
        for name, f in state.fluids.items():
            if name not in self.gravitating:
                continue
            rho_k = self._fluid_slab(f.varrho * a ** (-3 * weff[name]), n)
            slab = rho_k if slab is None else slab + rho_k
        return slab

    # ------------------------------------------------------------------ #
    def _realize_linear(self, name: str, a: float, weff_val: float, w_val: float,
                        f: FluidState, want_J: bool) -> FluidState:
        """The fluid's grids re-realized from linear theory at a
        (reference realize_if_linear, species.py:2101): ϱ always, J with
        ``want_J``, on the component's own noise, so that realizations at
        different a share their phases."""
        spec = self.fspecs[name]
        cfg = self.config
        n = f.varrho.shape[-1]
        rho_mean = self._fluid_rho_mean(name)
        delta_k = realize_delta_slab(self.lin, n, cfg.boxsize, a,
                                     seed=self._fluid_seeds.get(name, 0), dtype=cfg.dtype,
                                     device=f.varrho.device,
                                     species=fluid_species_key(spec.species), dist=self.dist)
        varrho = rho_mean * (1.0 + irfft3(delta_k, n, self.dist))
        J = f.J
        if want_J and f.J is not None:
            # the linear continuity closure θ = −aHf₁δ ⇒ J = ϱ̄ a^{2−3w_eff}Hf₁ψ
            H = float(self.bg.hubble_np(a))
            f1 = float(self.bg.growth_np("f1", a))
            psi = displacement_from_delta(delta_k, n, cfg.boxsize, self.dist)
            J = (rho_mean * a ** (2 - 3 * weff_val) * H * f1) * psi
        P = f.P
        if P is not None:
            P = (w_val * self.light_speed**2) * varrho
        return FluidState(varrho=varrho.to(cfg.dtype),
                          J=None if J is None else J.to(cfg.dtype), P=P, sigma=f.sigma)

    def _apply_realize_if_linear(self, state: MultiState, a: float, weff: dict, w: dict):
        """Re-realize the linear fluid variables before the force (the
        reference's kick_long → realize_if_linear cadence, main.py:1104):
        'class' closure at boltzmann_order −1: ϱ; order 0: ϱ and J;
        order 1: the linear 𝒫 (or 𝒫 = wc²ϱ under 'P=wρ') and ς."""
        new_fluids = dict(state.fluids)
        for name, f in state.fluids.items():
            spec = self.fspecs[name]
            if spec.boltzmann_closure != "class":
                continue
            if spec.boltzmann_order in (-1, 0):
                new_fluids[name] = self._realize_linear(name, a, weff[name], w[name], f,
                                                        want_J=spec.boltzmann_order == 0)
            elif spec.boltzmann_order == 1 and f.P is not None:
                if self.P_eq_wrho.get(name):
                    new_fluids[name] = f._replace(P=(w[name] * self.light_speed**2) * f.varrho)
                    continue
                lin_state = self._realize_linear(
                    name, a, weff[name], w[name],
                    FluidState(varrho=f.varrho, J=None, P=f.P, sigma=None), want_J=False)
                sigma = realize_sigma_grids(
                    self.lin, f.varrho.shape[-1], self.config.boxsize, a,
                    self._fluid_rho_mean(name) * (1.0 + w[name]),
                    seed=self._fluid_seeds.get(name, 0), dtype=self.config.dtype,
                    device=f.varrho.device, species=fluid_species_key(spec.species),
                    dist=self.dist)
                new_fluids[name] = f._replace(P=lin_state.P,
                                              sigma=sigma if sigma is not None else f.sigma)
        return MultiState(particles=state.particles, fluids=new_fluids)

    def _apply_internal_sources(self, state: MultiState, decay_fac: dict, decay_gain: dict):
        """Decaying species (reference apply_internal_sources,
        species.py:2812): ϱ, J, 𝒫 times e^{−ΓΔt}, the lost energy credited
        to the ``decay_to`` companion as Γ·ϱ_d·ᔑa·e^{−Γ(t−t₀)}dt."""
        if not decay_fac:
            return state
        new_fluids = dict(state.fluids)
        for name, fac in decay_fac.items():
            f = new_fluids[name]
            new_fluids[name] = f._replace(varrho=f.varrho * fac,
                                          J=None if f.J is None else f.J * fac,
                                          P=None if f.P is None else f.P * fac)
            target = self.fspecs[name].decay_to
            if target and target in new_fluids:
                g = new_fluids[target]
                new_fluids[target] = g._replace(varrho=g.varrho + decay_gain[name] * f.varrho)
        return MultiState(particles=state.particles, fluids=new_fluids)

    def _fluid_rho_mean(self, name: str) -> float:
        Omega = self.fluid_Omegas.get(name)
        if Omega is None or self.rho_crit is None:
            raise ValueError(f"linear re-realization of {name!r} needs fluid_Omegas "
                             f"and rho_crit")
        return Omega * self.rho_crit

    def _fluid_grad(self, phi, nf: int, d: int):
        """∂_d φ on a fluid grid of size nf (φ resampled where nf differs;
        with ``dist`` from this rank's y-slab of φ to its x-rows of the
        nf-grid)."""
        cfg = self.config
        n = cfg.potential_gridsize
        phi_f = phi if nf == n else fourier.copy_modes(phi, n, nf, norm=True, dist=self.dist)
        return irfft3(fourier.fourier_diff(phi_f, nf, cfg.boxsize, d, self._y_rows(nf)), nf,
                      self.dist)

    def _grad(self, phi, d: int):
        """∂_d φ on the potential's grid (with ``dist`` this rank's x-slab)."""
        cfg = self.config
        n = cfg.potential_gridsize
        if self.dist is None:
            return irfft3(fourier.fourier_diff(phi, n, cfg.boxsize, d), n)
        return slab_gradient(phi, n, cfg.boxsize, d, self.dist)

    def _interpolate(self, grid, name: str, pstate, slabbed):
        """A potential-grid field at a particle component's positions (with
        ``dist`` at its slab-resident particles, from the rank's x-slab
        with the halo rows of its neighbours)."""
        cfg = self.config
        if self.dist is None:
            return gather(grid, pstate.pos, cfg.boxsize, order=cfg.interpolation_order)
        pos_s, w_s, _, _ = slabbed[name]
        return gather_distributed_halo(grid, pos_s, w_s, cfg.boxsize, cfg.interpolation_order,
                                       self.dist)

    def _to_shard(self, vals, name: str, pstate, slabbed):
        """Per-particle rows (M, …) from :meth:`_interpolate` → the
        component's rows in its index order (with ``dist``: sent back from
        the slabs to the index shard)."""
        if self.dist is None:
            return vals
        return to_shard_order(vals, slabbed[name][2], pstate.pos.shape[0], self.dist)

    def _kick(self, state: MultiState, int_kick: float, a: float, weff: dict, w: dict,
              lapse_ints=None) -> MultiState:
        cfg = self.config
        n = cfg.potential_gridsize
        c2inv = 1.0 / self.light_speed**2
        y_rows = self._y_rows(n)
        with record_function("multi.pm"):
            state = self._apply_realize_if_linear(state, a, weff, w)
            # over the ranks each particle component's shard goes to the
            # x-slabs once a kick: its deposit and its gathers read it there
            slabbed = None if self.dist is None else {
                name: sort_to_slabs(ps.pos, self.dist, cfg.boxsize)
                for name, ps in state.particles.items()}
            slab = self._density_slab(state, a, weff, slabbed)
            phi = gravity_potential_slab(slab, n, cfg.boxsize, cfg.G, deconv_order=0,
                                         y_rows=y_rows)
            deconv = fourier.deconvolution_factor(n, cfg.interpolation_order, phi.real.dtype,
                                                  phi.device, y_rows)
            # the downstream deconvolution applies to the particles'
            # gather only; P³M receivers take the screened long range
            methods = {self.p_methods.get(nm) for nm in state.particles}
            phi_p = phi * deconv if methods - {"p3m"} else None
            phi_p3m = (gravity_potential_slab(slab, n, cfg.boxsize, cfg.G, deconv_order=0,
                                              longrange_scale=self._sr_scale,
                                              y_rows=y_rows) * deconv
                       if "p3m" in methods else None)
            dmom = {name: [] for name in state.particles}
            fluid_dJ = {name: [] for name in state.fluids}
            for d in range(3):
                grads = {m: self._grad(p, d) for m, p in (("pm", phi_p), ("p3m", phi_p3m))
                         if p is not None}
                for name, pstate in state.particles.items():
                    g = grads["p3m" if self.p_methods.get(name) == "p3m" else "pm"]
                    comp = self._interpolate(g, name, pstate, slabbed)
                    dmom[name].append((-self.pspecs[name].mass * int_kick) * comp)
                for name, f in state.fluids.items():
                    if name not in self.gravitating or f.J is None:
                        fluid_dJ[name] = None
                        continue
                    gradf = self._fluid_grad(phi, f.varrho.shape[-1], d)
                    P = f.P if f.P is not None else (w[name] * self.light_speed**2) * f.varrho
                    fluid_dJ[name].append(-(f.varrho + c2inv * P) * gradf * int_kick)
            dmom = {name: self._to_shard(torch.stack(v, 1), name, state.particles[name],
                                         slabbed) for name, v in dmom.items()}
        # P³M short range: each component's self sweep (row 6) and its
        # sweeps against every other P³M component (row 2); over the ranks
        # on the all-gathered positions, each rank's receivers its own
        p3m_live = [nm for nm in state.particles if self.p_methods.get(nm) == "p3m"]
        with record_function("multi.sweep"):
            whole = {nm: state.particles[nm].pos if self.dist is None
                     else replicate(state.particles[nm].pos, self.dist) for nm in p3m_live}
            for r in p3m_live:
                m_r = self.pspecs[r].mass
                cap_r = self._sr_caps.get(r, 8)
                own = slice(None) if self.dist is None else slice(
                    *self.dist.shard(whole[r].shape[0]))
                for s_name in p3m_live:
                    if s_name == r:
                        dm, _ = shortrange_momentum_updates(
                            whole[r].unbind(1), m_r, cfg.boxsize, self._sr_scale,
                            self._sr_range, int_kick, n_cells=self._sr_ncells, capacity=cap_r,
                            softening=cfg.softening, G=cfg.G,
                            softening_kernel=cfg.softening_kernel)
                        dmom[r] = dmom[r] + torch.stack(dm, 1)[own]
                    else:
                        dmom[r] = dmom[r] + shortrange_momentum_updates_on_subset(
                            state.particles[r].pos, whole[s_name], m_r, cfg.boxsize,
                            self._sr_scale, self._sr_range, n_cells=self._sr_ncells,
                            capacity_recv=cap_r, capacity_sup=self._sr_caps.get(s_name, 8),
                            softening=cfg.softening, G=cfg.G,
                            softening_kernel=cfg.softening_kernel,
                            mass_sup=self.pspecs[s_name].mass) * int_kick
        # the lapse force: the lapse component's potential alone, each
        # decaying receiver kicked by its own ᔑa^{−3w_eff}·Γ/H dt
        if self.lapse_supplier and lapse_ints and self.lapse_supplier in state.fluids:
            with record_function("multi.pm"):
                fl = state.fluids[self.lapse_supplier]
                slab_l = self._fluid_slab(fl.varrho * a ** (-3 * weff[self.lapse_supplier]), n)
                phi_l = gravity_potential_slab(slab_l, n, cfg.boxsize, cfg.G, deconv_order=0,
                                               y_rows=y_rows)
                lapse_p = {name: [] for name in lapse_ints if name in state.particles}
                for d in range(3):
                    grad_l = self._grad(phi_l, d)
                    for name, li in lapse_ints.items():
                        if name in state.fluids and name != self.lapse_supplier:
                            f = state.fluids[name]
                            if f.J is None or fluid_dJ.get(name) is None:
                                continue
                            nf = f.varrho.shape[-1]
                            gl = grad_l if nf == n else self._fluid_grad(phi_l, nf, d)
                            P = f.P if f.P is not None else (
                                w[name] * self.light_speed**2) * f.varrho
                            fluid_dJ[name][d] = fluid_dJ[name][d] - (f.varrho + c2inv * P) * gl * li
                        elif name in state.particles:
                            comp = self._interpolate(grad_l, name, state.particles[name],
                                                     slabbed)
                            lapse_p[name].append((-self.pspecs[name].mass * li) * comp)
                for name, v in lapse_p.items():
                    dmom[name] = dmom[name] + self._to_shard(
                        torch.stack(v, 1), name, state.particles[name], slabbed)
        new_particles = {name: ps._replace(mom=ps.mom + dmom[name])
                         for name, ps in state.particles.items()}
        new_fluids = dict(state.fluids)
        for name, f in state.fluids.items():
            if f.J is not None and fluid_dJ.get(name):
                new_fluids[name] = f._replace(J=f.J + torch.stack(fluid_dJ[name]))
        return MultiState(particles=new_particles, fluids=new_fluids)

    def _drift(self, state: MultiState, int_a2: float, dt: float, coef_flux: dict,
               coef_pressure: dict, a: float, w: dict, parity: int = 0) -> MultiState:
        cfg = self.config
        particles = {name: ps._replace(pos=periodic_wrap(
            ps.pos + ps.mom * (int_a2 / self.pspecs[name].mass), cfg.boxsize))
            for name, ps in state.particles.items()}
        new_fluids = {}
        for name, f in state.fluids.items():
            if f.J is None:
                new_fluids[name] = f
                continue
            spec = self.fspecs[name]
            # 𝒫 per boltzmann_order and closure (reference species.py:880-928):
            # an evolved or realized 𝒫 (order ≥ 2, or order 1 'class') enters
            # the fluxes as stored, else the P = wϱc² approximation
            own_P = (spec.boltzmann_order >= 2 or (
                spec.boltzmann_order == 1 and spec.boltzmann_closure == "class")
            ) and f.P is not None
            P_in = f.P if f.P is not None else (w[name] * self.light_speed**2) * f.varrho
            if self.fluid_scheme.get(name) == "maccormack":
                rho, J, P = maccormack_step(
                    f.varrho, f.J, P_in, dt, coef_flux[name], coef_pressure[name],
                    cfg.boxsize, 1.0 / self.light_speed**2, step_parity=parity,
                    approx_P_eq_wrho=not own_P, w=w[name], light_speed=self.light_speed,
                    dist=self.dist)
                if self._mc_vacuum:
                    if self.dist is None:
                        rho_mean = rho.mean()
                    else:
                        rho_mean = self.reduce(rho.sum()) / rho.shape[-1] ** 3
                    rho_vac = 1e-2 * rho_mean  # the reference's ρ_vacuum scale
                    rho, J = vacuum_redistribute(rho, J, rho_vac, smoothing=self._mc_smoothing,
                                                 passes=self._mc_vacuum_passes, dist=self.dist)
                    if name not in self._vacuum_warned:
                        self._warn_vacuum_residual(
                            int(self.reduce((rho < rho_vac).sum())), name)
                    rho, J = vacuum_correct(rho, J, 1e-6 * rho_mean)
            else:
                rho, J, P = kt_step(
                    f.varrho, f.J, P_in, dt, coef_flux[name], coef_pressure[name],
                    cfg.boxsize, self.light_speed * math.sqrt(abs(w[name])) / a,
                    1.0 / self.light_speed**2, limiter=self._kt_limiter,
                    rk_order=self._kt_rk_order, approx_P_eq_wrho=not own_P, w=w[name],
                    light_speed=self.light_speed, sigma=f.sigma, dist=self.dist)
            if own_P and spec.boltzmann_order >= 2:
                P = f.P  # frozen: no 𝒫 evolution equation (reference)
            new_fluids[name] = FluidState(varrho=rho, J=J, P=P, sigma=f.sigma)
        return MultiState(particles=particles, fluids=new_fluids)

    def _warn_vacuum_residual(self, n_bad: int, name: str):
        """Cells still below ρ_vacuum after the redistribution passes are
        about to be floor-clamped, which is not conservative: warn once
        per component (the reference's "Vacuum detected", fluid.py:1079)."""
        if n_bad > 0:
            self._vacuum_warned.add(name)
            masterwarn(f"Vacuum detected in fluid component '{name}': {n_bad} cells below "
                       f"the vacuum density after {self._mc_vacuum_passes} redistribution "
                       f"passes — floor-clamping (non-conservative); raise "
                       f"max_vacuum_corrections or the grid resolution (warned once per "
                       f"component)")

    def _step(self, state, int_kick, int_a2, dt, coef_flux, coef_pressure, a, weff, w,
              decay_fac=None, decay_gain=None, parity: int = 0, lapse_ints=None):
        state = self._apply_internal_sources(state, decay_fac or {}, decay_gain or {})
        state = self._kick(state, int_kick, a, weff, w, lapse_ints=lapse_ints)
        with record_function("multi.drift"):
            return self._drift(state, int_a2, dt, coef_flux, coef_pressure, a, w,
                               parity=parity)

    # ------------------------------------------------------------------ #
    def lapse_step_scalars(self, t0: float, t1: float) -> dict:
        """Per receiver, the lapse kick integral ᔑa^{−3w_eff}·Γ/H dt over
        [t0, t1] (reference key ('a**(-3*w_eff)*Γ/H', 'component'),
        interactions.py:3027)."""
        if not self.lapse_supplier:
            return {}
        out = {}
        for name, spec in self.fspecs.items():
            if spec.decay_rate <= 0:
                continue
            e = self.eos[name]
            out[name] = self.bg.integral_custom_np(
                t0, t1, lambda av: av ** (-3 * np.vectorize(e.w_eff_np)(av))
                * spec.decay_rate / self.bg.hubble_np(av))
        return out

    def timestep_limits(self, a: float) -> dict:
        """The Δt limiters at a, by name: the dynamical time of the
        particles, the Hubble time, Δa_max, and each dynamically evolved
        fluid's Courant limit, computed as the JAX package does
        (concept_tpu/sim_multi.py:724-725), whose factor a² the KT sound
        speed does not justify (ROADMAP Queue 3)."""
        cfg = self.config
        H = float(self.bg.hubble_np(a))
        limits = {}
        rho_tot = sum(sp.mass * sp.N / cfg.boxsize**3 / a**3
                      for sp in self.pspecs.values() if sp.N)
        if rho_tot > 0:
            limits["dynamical"] = FAC_DYNAMICAL / math.sqrt(cfg.G * rho_tot)
        if H > 0:
            limits["hubble"] = FAC_HUBBLE / H
            da_max = cfg.da_max_early if a < 0.1 else cfg.da_max_late
            limits["delta_a"] = da_max / (a * H)
        # only fluids whose grids the KT solver evolves: linear (order −1)
        # and frozen-ϱ (order 0 'truncate') components have no Courant limit
        for name, spec in self.fspecs.items():
            if spec.boltzmann_order < 1 and not (
                    spec.boltzmann_order == 0 and spec.boltzmann_closure == "class"):
                continue
            dx = cfg.boxsize / (spec.gridsize or cfg.potential_gridsize)
            cs = self.light_speed * math.sqrt(abs(self.eos[name].w_np(a))) / max(a, 1e-12)
            if cs > 0:
                limits[f"courant {name}"] = 0.21 * dx / cs * a * a
        return limits

    def timestep_size(self, a: float) -> float:
        return min(self.timestep_limits(a).values(), default=float("inf"))

    def timestep_limiter(self, a: float) -> tuple[float, str]:
        """(Δt_max, the name of the limiter that sets it) at a."""
        limits = self.timestep_limits(a)
        if not limits:
            return float("inf"), ""
        name = min(limits, key=limits.get)
        return limits[name], name

    def fluid_step_scalars(self, t0: float, t1: float, a_kick: float, dt: float):
        """Each fluid's exact step coefficients, with its own w_eff(a) in
        the integrand (reference per-component keys, main.py:1002-1025):
        (coef_flux, coef_pressure, w_eff, w) as name → float dicts."""
        bg = self.bg
        coef_flux, coef_pressure, weff, wv = {}, {}, {}, {}
        for name in self.fspecs:
            e = self.eos[name]
            if e.is_constant:
                w0 = e.w_eff_np(a_kick)
                cf = bg.integral_power_np(t0, t1, 3 * w0 - 2) / dt
                cp = bg.integral_power_np(t0, t1, -3 * w0) / dt
            else:
                cf = bg.integral_custom_np(
                    t0, t1, lambda av: av ** (3 * np.vectorize(e.w_eff_np)(av) - 2)) / dt
                cp = bg.integral_custom_np(
                    t0, t1, lambda av: av ** (-3 * np.vectorize(e.w_eff_np)(av))) / dt
            coef_flux[name], coef_pressure[name] = cf, cp
            weff[name], wv[name] = e.w_eff_np(a_kick), e.w_np(a_kick)
        return coef_flux, coef_pressure, weff, wv

    def decay_step_scalars(self, t0: float, t1: float):
        """Per decaying fluid, the factor e^{−ΓΔt} and the credit
        Γ·ᔑa dt·e^{−ΓΔt/2} over [t0, t1] (see _apply_internal_sources)."""
        decay_fac, decay_gain = {}, {}
        for name, spec in self.fspecs.items():
            if spec.decay_rate <= 0:
                continue
            G = spec.decay_rate
            dt = t1 - t0
            decay_fac[name] = math.exp(-G * dt)
            decay_gain[name] = G * self.bg.integral_custom_np(
                t0, t1, lambda av: av) * math.exp(-0.5 * G * dt)
        return decay_fac, decay_gain

    # ------------------------------------------------------------------ #
    def schedule(self, a_begin: float, a_end: float, static_dt=None,
                 resume: dict | None = None, max_steps: int = 100000):
        """The global steps from a_begin to a_end, as ``evolve`` takes
        them (the Δt hysteresis of reference main.py:920-983; Δt does not
        depend on the state): yields (t, Δt, t_mom, t_mid) per step, with
        ``self.hysteresis`` already that after the step; ``self._end`` holds
        (t, a, t_mom) when it ends.  Iterated alone it counts the steps
        on the host."""
        bg = self.bg
        t = float(bg.t_of_a_np(a_begin))
        t_end = float(bg.t_of_a_np(a_end))
        a = a_begin
        t_mom = t
        steps = 0
        replay = static_dt is not None and static_dt.applies

        def dt_max_at(a_now):
            if replay:
                a_next = a_now + static_dt.delta_a(a_now)
                if a_next > 1.0:
                    return float("inf")  # reference: Δt = ထ once a+Δa passes 1
                return float(bg.t_of_a_np(a_next)) - float(bg.t_of_a_np(a_now))
            return self.timestep_size(a_now)

        def record(a_now, dt_max):
            if static_dt is not None and static_dt.records and math.isfinite(dt_max):
                static_dt.record(a_now, float(bg.a_of_t_np(min(t + dt_max, t_end))) - a_now)

        dt_max = dt_max_at(a)
        record(a, dt_max)
        dt = tstep.DT_INITIAL_FAC * dt_max if math.isfinite(dt_max) else t_end - t
        dt_min = 1e-4 * dt
        step_last_sync = 0
        if resume:
            dt = float(resume.get("dt", dt))
            dt_min = float(resume.get("dt_min", dt_min))
            steps = int(resume.get("step_count", 0))
            step_last_sync = int(resume.get("step_last_sync", steps))
            if resume.get("t_mom") is not None:
                t_mom = float(resume["t_mom"])

        def keep():
            self.hysteresis = {"dt": dt, "dt_min": dt_min, "step_count": steps,
                               "step_last_sync": step_last_sync, "t_mom": t_mom}

        keep()
        while t < t_end - 1e-12 * abs(t_end):
            dt_max = dt_max_at(a)
            at_period = steps and (steps - step_last_sync) >= tstep.DT_PERIOD
            if at_period:
                record(a, dt_max)
            if dt > dt_max or (at_period and dt_max > tstep.DT_INCREASE_MIN_FAC * dt):
                dt, _ = tstep.update_base_timestep_size(
                    dt, dt_min, dt_max, "fluid/background limiter", steps - step_last_sync,
                    dt_increase_max_factor=DT_INCREASE_MAX_FAC, allow_increase=at_period,
                    tolerate_danger=replay)
                step_last_sync = steps
            dt = min(dt, t_end - t)
            t_mid = min(t + 0.5 * dt, t_end)
            this = (t, dt, t_mom, t_mid)
            # kept before the step is taken, so that what runs after it
            # (evolve's callback: the trap's autosave) saves the
            # hysteresis of the state it saves
            t_mom = t_mid
            t += dt
            a = float(bg.a_of_t_np(t))
            steps += 1
            keep()
            yield this
            if steps >= max_steps:
                raise RuntimeError("max_steps exceeded")
        self._end = (t, a, t_mom, t_end)

    def count_steps(self, a_begin: float, a_end: float, max_steps: int = 10**7) -> int:
        """The number of global steps from a_begin to a_end, counted on
        the host without stepping (``self.hysteresis`` is left as it was)."""
        kept = self.hysteresis
        try:
            return sum(1 for _ in self.schedule(a_begin, a_end, max_steps=max_steps))
        finally:
            self.hysteresis = kept

    def evolve(self, state: MultiState, a_begin: float, a_end: float,
               max_steps: int = 100000, static_dt=None, resume: dict | None = None,
               callback=None):
        """Step from a_begin to a_end; returns (state, a_end).  ``resume``:
        a hysteresis dict as kept in ``self.hysteresis`` after every step
        (Δt, Δt_min, the step counters and the kick sync point t_mom), so
        that a segment boundary or an autosave resume continues exactly
        (reference auxiliary file, main.py:1821-1927).  The momenta end
        synchronised at a_end by a closing half kick, which, as the JAX
        package's, takes no lapse force (ROADMAP Queue 3).
        ``callback(state, t, a, steps)`` runs after each step."""
        bg = self.bg
        for t, dt, t_mom, t_mid in self.schedule(a_begin, a_end, static_dt, resume, max_steps):
            with record_function("multi.host"):
                a_kick = float(bg.a_of_t_np(t_mid))
                int_kick = bg.integral_power_np(t_mom, t_mid, -1.0)
                int_a2 = bg.integral_power_np(t, t + dt, -2.0)
                coef_flux, coef_pressure, weff, wv = self.fluid_step_scalars(t, t + dt,
                                                                             a_kick, dt)
                decay_fac, decay_gain = self.decay_step_scalars(t, t + dt)
                lapse_ints = self.lapse_step_scalars(t_mom, t_mid)
                if self.p3m_names:
                    self._refresh_sr_capacities(state)
            state = self._step(state, int_kick, int_a2, dt, coef_flux, coef_pressure,
                               a_kick, weff, wv, decay_fac, decay_gain,
                               parity=(self.hysteresis["step_count"] - 1) & 1,
                               lapse_ints=lapse_ints)
            if callback is not None:
                callback(state, t + dt, float(bg.a_of_t_np(t + dt)),
                         self.hysteresis["step_count"])
        t, a, t_mom, t_end = self._end
        if t_mom < t_end - 1e-12 * abs(t_end):
            # the closing half kick (the JAX package's: no decay, no lapse)
            int_kick = bg.integral_power_np(t_mom, t_end, -1.0)
            coef_flux, coef_pressure, weff, wv = self.fluid_step_scalars(
                t_mom, t_end, a, t_end - t_mom)
            if self.p3m_names:
                self._refresh_sr_capacities(state)
            state = self._step(state, int_kick, 0.0, 0.0, coef_flux, coef_pressure, a,
                               weff, wv)
            self.hysteresis["t_mom"] = t_end
        if self._deficit is not None:
            self.stats["pm_mass_deficit_max"] = max(self.stats["pm_mass_deficit_max"],
                                                    float(self._deficit))
            self._deficit = None
        return state, a


def fluid_species_key(species: str) -> str:
    """A component's species → the transfer-function species key."""
    if "neutrino" in species:
        return "nu"
    if "radiation" in species or "photon" in species:
        return "radiation"
    if species in ("lapse", "metric"):
        # fictitious GR-correction species: δ from the Boltzmann aux tables
        return species
    return "matter"


def realize_fluid_from_linear(lin, spec: ComponentSpec, boxsize: float, a: float,
                              rho_mean: float, seed: int = 0, dtype=torch.float32,
                              device="cpu", eos=None, dist=None) -> FluidState:
    """A fluid component's grids from linear theory (reference ic.py:400
    realize_fluid): ϱ = ϱ̄(1+δ), 𝒫 = w c² ϱ, and for boltzmann_order > −1
    J = ϱ̄·a^{2−3w_eff}·H·f₁·ψ (the linear continuity relation θ = −aHf₁δ,
    ψ(k) = ik δ/k²); order ≥ 1 adds the linear shear ς = ϱ̄(1+w)σⁱⱼ from
    the Boltzmann tables (None without them).  Order −1 holds ϱ only.
    With ``dist`` the rank realizes its x-rows of each grid alone: the
    noise of its rows, δ and ψ on its y-slab, the slab FFT back
    (ic.realize_delta_slab, ic.displacement_from_delta,
    ic.realize_sigma_grids with ``dist``)."""
    n = spec.gridsize
    species = fluid_species_key(spec.species)
    w = eos.w_np(a) if eos is not None else spec.w
    w_eff = eos.w_eff_np(a) if eos is not None else spec.w_eff
    delta_k = realize_delta_slab(lin, n, boxsize, a, seed=seed, dtype=dtype, device=device,
                                 species=species, dist=dist)
    varrho = (rho_mean * (1.0 + irfft3(delta_k, n, dist))).to(dtype)
    if spec.boltzmann_order <= -1:
        return FluidState(varrho=varrho)
    P = (w * lin.light_speed**2 * varrho).to(dtype)
    H = float(lin.bg.hubble_np(a))
    f1 = float(lin.bg.growth_np("f1", a))
    J = (rho_mean * a ** (2 - 3 * w_eff) * H * f1
         * displacement_from_delta(delta_k, n, boxsize, dist)).to(dtype)
    sigma = None
    if spec.boltzmann_order >= 1:
        # order 1 'class' re-realizes it continuously; order ≥ 2 keeps this
        # realization frozen (reference species.py:880-928)
        sigma = realize_sigma_grids(lin, n, boxsize, a, rho_mean * (1.0 + w), seed=seed,
                                    dtype=dtype, device=device, species=species, dist=dist)
    return FluidState(varrho=varrho, J=J, P=P, sigma=sigma)
