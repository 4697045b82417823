"""The run: from a RunConfig to a finished simulation with its output
dumps (port of the single-component path of concept_tpu/run.py;
reference main.py:1676-2188).

The port runs one matter particle component with P³M gravity, stepped
by adaptive rungs (the default run, ``N_rungs > 1``:
p3mrungs.RungSimulationAdapter) or globally (``N_rungs = 1``:
sim.Simulation), or with PM gravity, stepped globally whatever
``N_rungs`` says (as the JAX package does).  Multi-component and fluid
runs, snapshot input and output, autosave and the PP methods raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import math
import os
import time as _time
from types import SimpleNamespace

import numpy as np

from concept_tpu_torch.components import ComponentSpec, particle_mass
from concept_tpu_torch.cosmology.background import Background
from concept_tpu_torch.cosmology.backend import select_backend
from concept_tpu_torch.cosmology.linear import LinearCosmology
from concept_tpu_torch.cosmology.primordial import PrimordialSpectrum
from concept_tpu_torch.device import resolve_device, resolve_dtype
from concept_tpu_torch.param import RunConfig, is_selected
from concept_tpu_torch.sim import METHOD_ITEMS, SimConfig, Simulation
from concept_tpu_torch.units import UnitSystem
from concept_tpu_torch.utils.terminal import masterprint

_EXOTIC_KEYS = ("N_ncdm", "Omega_k", "Omega_fld", "w0_fld", "wa_fld",
                "Omega_dcdm", "Gamma_dcdm", "Omega_ini_dcdm", "Omega_Lambda")


def build_cosmology(cfg: RunConfig):
    """Units, constants, background and linear layer (EH transfer)."""
    units = cfg.units or UnitSystem(cfg.unit_length, cfg.unit_time, cfg.unit_mass)
    c = units.constants()
    cp = cfg.class_params or {}
    exotic = [k for k in _EXOTIC_KEYS if k in cp]
    if exotic:
        raise NotImplementedError(
            f"class_params {exotic}: massive neutrinos and exotic sectors "
            f"(ROADMAP Queue 1 item 5)")
    bg = Background(H0=cfg.H0, Omega_m=cfg.Omega_m,
                    enable_Hubble=cfg.enable_Hubble)
    prim = PrimordialSpectrum(
        A_s=cfg.primordial["A_s"], n_s=cfg.primordial["n_s"],
        alpha_s=cfg.primordial.get("alpha_s", 0.0),
        pivot=cfg.primordial.get("pivot") or 0.05 / units.Mpc,
    )
    lin = LinearCosmology(bg, prim, Omega_b=cfg.Omega_b,
                          Omega_cdm=cfg.Omega_cdm, light_speed=c.light_speed,
                          Mpc=units.Mpc)
    masterprint(f"Linear backend: {select_backend(cfg)}")
    return units, c, bg, lin


def is_selected_force(cfg: RunConfig, name: str, species: str) -> str:
    s = SimpleNamespace(name=name, species=species, representation="particles")
    sel = is_selected(s, cfg.select_forces, default={"gravity": "p3m"})
    return sel.get("gravity", "p3m") if isinstance(sel, dict) else "p3m"


def build_components(cfg: RunConfig, bg, constants):
    """cfg.initial_conditions → [(ComponentSpec, 'realize')] for particle
    components; fluids and snapshot paths raise."""
    ics = cfg.initial_conditions
    if ics is None:
        raise ValueError("no initial_conditions specified")
    entries = ics if isinstance(ics, (list, tuple)) else [ics]
    rho_crit = bg.rho_crit_of(constants.G_Newton)
    out = []
    for entry in entries:
        if isinstance(entry, str):
            raise NotImplementedError(
                "initial conditions from a snapshot (ROADMAP Queue 1 item 7: "
                "snapshot I/O)")
        species = entry["species"]
        name = entry.get("name", species)
        N = entry.get("N")
        if not N:
            raise NotImplementedError(
                f"component {name!r} without N: fluids (ROADMAP Queue 1 item 12)")
        Omega = cfg.Omega_m if species == "matter" else (
            cfg.Omega_cdm if species in ("cdm", "cold dark matter") else cfg.Omega_b)
        mass = entry.get("mass", particle_mass(Omega, rho_crit, cfg.boxsize, N))
        out.append((ComponentSpec(
            name=name, species=species, N=int(N), mass=float(mass),
            forces=(("gravity", is_selected_force(cfg, name, species)),),
        ), "realize"))
    return out


def shortrange_overrides(cfg: RunConfig, boxsize: float, gridsize: int) -> dict:
    """Evaluate shortrange_params['gravity'] scale/range expressions
    (reference: scale = '1.25*boxsize/gridsize', range = '4.5*scale',
    param/example_explanatory:211-218)."""
    params = (cfg.shortrange_params or {}).get("gravity", cfg.shortrange_params or {})
    out = {}
    ns = {"boxsize": boxsize, "gridsize": gridsize}
    scale = params.get("scale")
    if scale is not None:
        scale = eval(scale, ns) if isinstance(scale, str) else float(scale)  # noqa: S307
        out["shortrange_scale"] = float(scale)
        ns["scale"] = float(scale)
    rng = params.get("range")
    if rng is not None:
        ns.setdefault("scale", 1.25 * boxsize / gridsize)
        rng = eval(rng, ns) if isinstance(rng, str) else float(rng)  # noqa: S307
        out["shortrange_range"] = float(rng)
    return out


def softening_length(cfg: RunConfig, spec, gridsize: int) -> float:
    """Evaluate the select_softening_length selector for a component
    (reference: {'particles': '0.025*boxsize/cbrt(N)'},
    param/example_explanatory:373-375)."""
    expr = is_selected(spec, cfg.select_softening_length or {},
                       default="0.025*boxsize/cbrt(N)")
    if isinstance(expr, (int, float)):
        return float(expr)
    ns = {"boxsize": cfg.boxsize, "N": spec.N, "gridsize": gridsize,
          "cbrt": lambda x: x ** (1.0 / 3.0), "sqrt": math.sqrt}
    if cfg.units is not None:
        ns.update(cfg.units.namespace())
    return float(eval(expr, {"__builtins__": {}}, ns))  # noqa: S307


def run(cfg: RunConfig, max_steps: int = 100000, seed: int | None = None,
        device=None, deposit_method: str | None = None):
    """Run the simulation described by cfg on ``device`` (default: the
    CUDA card; a missing card raises).  ``deposit_method`` (default
    'auto') is the generic PM's, as in the JAX package: 'pallas' names the
    block kernels of PERF.md rows 10-11 (CUDA on the card, their plain
    versions on the CPU); 'auto' takes them on the card wherever they
    apply and 'scatter' elsewhere (grid/interp.py).  Returns (sim, state,
    a); the host seconds of realization, evolution and output are in
    ``sim.timings``."""
    from concept_tpu_torch.p3mrungs import RungSimulationAdapter
    from concept_tpu_torch.timestep import prepare_static_timestepping
    from concept_tpu_torch.utils.terminal import set_formatting, set_suppress_output

    dev = resolve_device(device)
    dtype = resolve_dtype(dev, cfg.enable_float64)
    if cfg.suppress_output:
        set_suppress_output(cfg.suppress_output)
    if not cfg.enable_terminal_formatting:
        set_formatting(False)
    if math.isfinite(cfg.autosave_interval):
        raise NotImplementedError("autosave (ROADMAP Queue 1 item 7)")
    units, consts, bg, lin = build_cosmology(cfg)
    comps = build_components(cfg, bg, consts)
    if len(comps) > 1:
        raise NotImplementedError("multi-component runs (ROADMAP Queue 1 item 12)")
    spec, _ = comps[0]
    method = spec.force_method("gravity") or "p3m"
    if method not in ("pm", "p3m"):
        raise NotImplementedError(
            f"gravity {method!r} ({METHOD_ITEMS.get(method, 'not a method')})")
    pot = cfg.potential_options
    gridsize = int(pot.get("gridsize_per_method", {}).get(method)
                   or pot.get("gridsize")
                   or (2 if method == "p3m" else 1) * round(spec.N ** (1 / 3)))
    overrides = shortrange_overrides(cfg, cfg.boxsize, gridsize)
    rungs = method == "p3m" and cfg.N_rungs > 1
    static_dt = prepare_static_timestepping(cfg.static_timestepping)
    if rungs:
        scale = 1.25 * cfg.boxsize / gridsize
        if not (math.isclose(overrides.get("shortrange_scale", scale), scale)
                and math.isclose(overrides.get("shortrange_range", 4.5 * scale),
                                 4.5 * scale)):
            raise NotImplementedError(
                f"shortrange_params {overrides}: the rung stepper uses scale = "
                f"1.25·boxsize/gridsize and range = 4.5·scale")
        if static_dt is not None and static_dt.records:
            raise NotImplementedError(
                "recording static_timestepping with rungs: the rung stepper "
                "replays a recorded file, the global stepper (N_rungs = 1) "
                "records it")
    if dev.type == "cuda":
        masterprint(f"Device: {dev} ({_device_name(dev)})")
    sim_config = SimConfig(
        boxsize=cfg.boxsize, potential_gridsize=gridsize, device=dev,
        dtype=dtype, G=consts.G_Newton, method=method,
        interpolation_order=pot.get("interpolation", 2),
        deconvolve=tuple(pot.get("deconvolve", (True, True))),
        differentiation=pot.get("differentiation", "fourier"),
        interlace=pot.get("interlace", False),
        deposit_method=deposit_method or "auto",
        softening=softening_length(cfg, spec, gridsize),
        softening_kernel=cfg.softening_kernel,
        dt_base_background_factor=cfg.Delta_t_base_background_factor,
        dt_base_nonlinear_factor=cfg.Delta_t_base_nonlinear_factor,
        da_max_early=cfg.Delta_a_max_early, da_max_late=cfg.Delta_a_max_late,
        **overrides,
    )
    if rungs:
        sim = RungSimulationAdapter(spec, sim_config, bg, lin,
                                    N_rungs=cfg.N_rungs,
                                    fac_rung=cfg.Delta_t_rung_factor)
    else:
        sim = Simulation(spec, sim_config, bg, lin)
    seed_val = seed if seed is not None else int(
        cfg.random_seeds.get("primordial amplitudes", 0))
    lpt = int(cfg.realization_options.get("lpt", 1))
    masterprint(f"Realizing {spec.name} ({spec.N} particles, {lpt}LPT) ...")
    t_realize = _time.time()
    state = sim.initial_state(
        a_begin=cfg.a_begin, seed=seed_val, lpt_order=lpt,
        with_ids=bool(is_selected(spec, cfg.select_particle_id, default=False)),
        fixed_amplitude=cfg.primordial_amplitude_fixed,
        phase_shift=cfg.primordial_phase_shift,
        scheme=cfg.primordial_noise_imprinting,
        nongaussianity=float(cfg.realization_options.get("nongaussianity", 0.0)),
        dealias=bool(cfg.realization_options.get("dealias", False)),
        backscale=bool(cfg.realization_options.get("backscale", False)),
    )
    t_realize = _time.time() - t_realize
    masterprint("done")

    # dump schedule: a-values across all kinds
    events = []
    for kind, times in cfg.output_times.get("a", {}).items():
        events += [(float(t), kind) for t in times]
    for kind, times in cfg.output_times.get("t", {}).items():
        events += [(float(bg.a_of_t_np(tt)), kind) for tt in times]
    events.sort()
    a = cfg.a_begin
    for _, kind in [e for e in events if e[0] <= a + 1e-12]:
        dump(cfg, sim, state, a, kind, units, lin)
    events = [e for e in events if e[0] > a + 1e-12]

    t_wall0 = _time.time()
    t_evolve = t_dump = 0.0
    hysteresis = None
    while events:
        a_next = events[0][0]
        masterprint(f"Evolving to a = {a_next:.4g} ...")
        t0 = _time.time()
        state, a = sim.evolve(state, a, a_next, max_steps=max_steps,
                              static_dt=static_dt, resume=hysteresis)
        # Δt and the step counter stay continuous across dumps
        hysteresis = dict(sim.hysteresis)
        t_evolve += _time.time() - t0
        masterprint("done")
        t0 = _time.time()
        while events and events[0][0] <= a + 1e-9:
            _, kind = events.pop(0)
            dump(cfg, sim, state, a, kind, units, lin)
        t_dump += _time.time() - t0
    step_total = sim.hysteresis.get("step_count", 0)
    wall = _time.time() - t_wall0
    if step_total:
        masterprint(
            f"Time-step summary: {step_total} steps, {t_evolve:.1f} s evolution "
            f"({1e3 * t_evolve / step_total:.0f} ms/step), {t_dump:.1f} s output")
    masterprint(f"Simulation complete: a = {a:.6g}, wall time {wall:.1f} s")
    sim.timings = {"realize_s": t_realize, "evolve_s": t_evolve, "dump_s": t_dump}
    return sim, state, a


def _device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev)


def dump(cfg: RunConfig, sim, state, a, kind, units, lin):
    """Write one scheduled output; only 'powerspec' is ported."""
    if kind != "powerspec":
        raise NotImplementedError(f"{kind!r} output (ROADMAP Queue 1 items 7, 13)")
    from concept_tpu_torch.analysis.output import save_powerspec_txt
    from concept_tpu_torch.analysis.powerspec import powerspec, powerspec_sigma

    base = cfg.output_bases.get(kind, kind)
    dirname = cfg.output_dirs.get(kind, "output")
    tag = f"a={a:.4g}" if cfg.enable_Hubble else f"t={a:.4g}"
    opts = cfg.powerspec_options or {}
    if opts.get("plot", False):
        raise NotImplementedError("power spectrum plots (ROADMAP Queue 1 item 13)")
    gridsize = int(opts.get("gridsize") or sim.config.potential_gridsize)
    bpd = opts.get("bins per decade", opts.get("bins_per_decade", 40))
    pk = powerspec(
        state.pos, gridsize, cfg.boxsize, sim.spec.N,
        order=opts.get("interpolation", 4),
        interlace=bool(opts.get("interlace", True)),
        bins_per_decade=bpd if isinstance(bpd, dict) else int(bpd),
        k_max=opts.get("k_max"),
    )
    lin_col = np.asarray(lin.power_delta(pk["k"], a)) if lin is not None else None
    R = float(opts.get("tophat", 8 / cfg.h * units.Mpc))
    sigma = powerspec_sigma(pk["k"], pk["power_corrected"], R)
    sigma_lin = lin.sigma_R(R, a) if lin is not None else None
    fn = os.path.join(dirname, f"{base}_{tag}.txt")
    save_powerspec_txt(fn, pk, a, cfg.boxsize, cfg.unit_length, sigma, R,
                       lin_col, sigma_linear=sigma_lin,
                       significant_figures=int(opts.get("significant figures", 18)))
    masterprint(f"Saved power spectrum: {fn}")
