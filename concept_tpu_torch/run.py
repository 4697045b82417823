"""The run: from a RunConfig to a finished simulation with its output
files (port of the single-component path of concept_tpu/run.py;
reference main.py:1676-2188).

The port runs one matter particle component with P³M gravity, stepped
by adaptive rungs (the default run, ``N_rungs > 1``:
p3mrungs.RungSimulationAdapter) or globally (``N_rungs = 1``:
sim.Simulation), or with PM gravity, stepped globally whatever
``N_rungs`` says (as the JAX package does).  It starts from realized
initial conditions or from a snapshot (CONCEPT-HDF5, GADGET-2, TIPSY),
dumps power spectra, bispectra and snapshots, autosaves (periodically
and on SIGINT/SIGTERM) and resumes from an autosave.  PP gravity ('pp'
with Ewald, 'ppnonperiodic') steps globally, as in the JAX package.
The cosmology (:func:`build_cosmology`) takes massive neutrinos,
curvature, a CPL dark-energy fluid and decaying dark matter from
``class_params``, and the linear Boltzmann tables of the resolved
backend (the internal Einstein-Boltzmann solver where the run needs
species-resolved transfer functions).  Multi-component and fluid runs
and the renders raise ``NotImplementedError`` naming the ROADMAP item
that brings them.
"""

from __future__ import annotations

import json
import math
import os
import signal
import time as _time
from types import SimpleNamespace

import numpy as np

from concept_tpu_torch.components import (
    ComponentSpec, ParticleState, particle_mass, periodic_wrap,
)
from concept_tpu_torch.cosmology.background import Background
from concept_tpu_torch.cosmology.backend import build_tables
from concept_tpu_torch.cosmology.linear import LinearCosmology
from concept_tpu_torch.cosmology.neutrino import NeutrinoBackground
from concept_tpu_torch.cosmology.primordial import PrimordialSpectrum
from concept_tpu_torch.device import resolve_device, resolve_dtype
from concept_tpu_torch.param import RunConfig, is_selected
from concept_tpu_torch.sim import METHODS, SimConfig, Simulation
from concept_tpu_torch.units import UnitSystem
from concept_tpu_torch.utils.terminal import abort, masterprint

MULTI_ITEM = "multi-component runs (ROADMAP Queue 1 item 12)"

def build_cosmology(cfg: RunConfig):
    """Units, constants, background and linear layer, with the Boltzmann
    tables of the resolved backend installed (port of
    concept_tpu/run.py:28-107)."""
    units = cfg.units or UnitSystem(cfg.unit_length, cfg.unit_time, cfg.unit_mass)
    c = units.constants()
    # massive neutrinos from class_params (reference cosmology passthrough,
    # param/example_nonlinnu: N_ncdm/deg_ncdm/m_ncdm): the exact
    # Fermi-Dirac background (cosmology/neutrino.py) supplies Ω_ν and
    # w(a)/w_eff(a), in the Friedmann equation and not lumped into Ω_m
    nubg = None
    Omega_nu = 0.0
    cp = cfg.class_params or {}
    if cp.get("N_ncdm"):
        deg = int(cp.get("deg_ncdm", 1))
        m_ncdm = float(cp.get("m_ncdm", 0.0))
        nubg = NeutrinoBackground(m_nu_eV=m_ncdm, N_nu=deg)
        km_per_s = c.light_speed / 299792.458
        h = cfg.H0 / (100 * km_per_s / units.Mpc)
        Omega_nu = nubg.omega_nu_h2() / h**2
    # Exotic sectors via class_params, CLASS key conventions (reference
    # passes these straight to CLASS, linear.py:3517-3595): Omega_k,
    # Omega_fld/w0_fld/wa_fld (with Omega_Lambda: 0 to trade Λ for the
    # fluid), Omega_dcdm or Omega_ini_dcdm + Gamma_dcdm [km/s/Mpc].
    km_s_Mpc = (c.light_speed / 299792.458) / units.Mpc
    exotic = dict(
        Omega_k=float(cp.get("Omega_k", 0.0)),
        Omega_fld=float(cp.get("Omega_fld", 0.0)),
        w0_fld=float(cp.get("w0_fld", -1.0)),
        wa_fld=float(cp.get("wa_fld", 0.0)),
        Omega_dcdm=float(cp.get("Omega_dcdm", 0.0)),
        Gamma_dcdm=float(cp.get("Gamma_dcdm", 0.0)) * km_s_Mpc,
        Omega_ini_dcdm=(
            float(cp["Omega_ini_dcdm"]) if "Omega_ini_dcdm" in cp else None
        ),
    )
    if "Omega_Lambda" in cp:
        OL = float(cp["Omega_Lambda"])
        if OL == 0.0 and not exotic["Omega_fld"]:
            # CLASS convention: Omega_Lambda: 0 with fld unspecified ⇒
            # the fld closes the budget
            if exotic["Gamma_dcdm"]:
                # the budget would also need the decay radiation Ω_dr at
                # a=1, which is only known after solving the dcdm decay
                # history — silently omitting it overcloses the
                # background, so reject the combination explicitly
                raise ValueError(
                    "Omega_Lambda: 0 fld-closure cannot be combined with "
                    "Gamma_dcdm > 0 (the closure budget would need the "
                    "solved decay-radiation Omega_dr); give Omega_fld "
                    "explicitly instead"
                )
            exotic["Omega_fld"] = (
                1.0 - cfg.Omega_m - Omega_nu - exotic["Omega_k"]
                - exotic["Omega_dcdm"]
            )
        exotic["Omega_lambda"] = OL
    bg = Background(H0=cfg.H0, Omega_m=cfg.Omega_m,
                    Omega_nu=Omega_nu, nu_background=nubg,
                    enable_Hubble=cfg.enable_Hubble, **exotic)
    prim = PrimordialSpectrum(
        A_s=cfg.primordial["A_s"], n_s=cfg.primordial["n_s"],
        alpha_s=cfg.primordial.get("alpha_s", 0.0),
        pivot=cfg.primordial.get("pivot") or 0.05 / units.Mpc,
    )
    lin = LinearCosmology(
        bg, prim, Omega_b=cfg.Omega_b, Omega_cdm=cfg.Omega_cdm,
        light_speed=c.light_speed, Mpc=units.Mpc,
        Omega_nu=Omega_nu, N_nu=int(cp.get("deg_ncdm", 3)) if nubg else 3,
    )
    lin.nu_background = nubg
    # the linear Boltzmann backend (cosmology/backend.py): classy where it
    # imports, else the internal Einstein-Boltzmann solver for runs that
    # need species-resolved tables, else the analytic EH layer; installed
    # tables override the analytic transfer path of LinearCosmology
    backend = build_tables(cfg, units, c, bg, lin, nubg=nubg)
    masterprint(f"Linear backend: {backend}")
    return units, c, bg, lin


def is_selected_force(cfg: RunConfig, name: str, species: str) -> str:
    s = SimpleNamespace(name=name, species=species, representation="particles")
    sel = is_selected(s, cfg.select_forces, default={"gravity": "p3m"})
    return sel.get("gravity", "p3m") if isinstance(sel, dict) else "p3m"


def build_components(cfg: RunConfig, bg, constants):
    """cfg.initial_conditions → [(ComponentSpec, 'realize')] for particle
    components and [(None, path)] for a snapshot (its file names the
    components); fluids raise."""
    ics = cfg.initial_conditions
    if ics is None:
        raise ValueError("no initial_conditions specified")
    entries = ics if isinstance(ics, (list, tuple)) else [ics]
    rho_crit = bg.rho_crit_of(constants.G_Newton)
    out = []
    for entry in entries:
        if isinstance(entry, str):
            out.append((None, entry))
            continue
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


def autosave_path(cfg: RunConfig) -> str:
    """<output_dirs['autosave']>/<param_name>, the JAX package's layout."""
    return os.path.join(cfg.output_dirs.get("autosave", "output/autosave"),
                        cfg.param_name)


def _snapshot_meta(cfg: RunConfig, a: float):
    from concept_tpu_torch.io.snapshot import SnapshotMeta

    return SnapshotMeta(a=a, boxsize=cfg.boxsize, H0=cfg.H0, Omega_b=cfg.Omega_b,
                        Omega_cdm=cfg.Omega_cdm, unit_length=cfg.unit_length,
                        unit_time=cfg.unit_time, unit_mass=cfg.unit_mass)


def write_autosave(cfg: RunConfig, sim, state, a: float, events,
                   hysteresis: dict | None = None, step_total: int = 0):
    """An autosave: the state as a CONCEPT snapshot, <dir>/snapshot.hdf5,
    and <dir>/auxiliary.json with a, the events still to come, the step
    total and the time-stepping state (Δt, Δt_min, the step counters,
    the momenta's kick sync point t_mom and the v_max that bounds the
    next Δt), so that a resumed run continues where this one stood,
    mid-segment included (reference auxiliary file, main.py:1821-1927)."""
    from concept_tpu_torch.io import snapshot as snap

    d = autosave_path(cfg)
    os.makedirs(d, exist_ok=True)
    snap.save_concept(os.path.join(d, "snapshot.hdf5"), _snapshot_meta(cfg, a),
                      {sim.spec.name: (sim.spec, state)})
    aux = {"a": a, "events": events, "step_total": int(step_total)}
    if hysteresis:
        aux["hysteresis"] = {k: None if v is None else float(v)
                             if k in ("dt", "dt_min", "t_mom", "v_max") else int(v)
                             for k, v in hysteresis.items()}
    with open(os.path.join(d, "auxiliary.json"), "w") as f:
        json.dump(aux, f)
    masterprint(f"Autosaved at a = {a:.6g} → {d}")


def check_autosave(cfg: RunConfig):
    """The autosave to resume from (reference main.py:1928-2010):
    (ParticleState of numpy arrays, a, remaining events, hysteresis, step
    total), or None where there is none.  A multi-component autosave is
    not resumed by this path."""
    from concept_tpu_torch.io import snapshot as snap

    d = autosave_path(cfg)
    fn = os.path.join(d, "snapshot.hdf5")
    aux = os.path.join(d, "auxiliary.json")
    if not (os.path.exists(fn) and os.path.exists(aux)):
        return None
    with open(aux) as f:
        info = json.load(f)
    if info.get("multi"):
        masterprint(f"Not resuming from {d}: a multi-component autosave ({MULTI_ITEM})")
        return None
    _, comps = snap.load_concept(fn)
    (_, (_, state)), = comps.items()
    return (state, float(info["a"]), [tuple(e) for e in info["events"]],
            info.get("hysteresis"), int(info.get("step_total", 0)))


def clear_autosave(cfg: RunConfig):
    import shutil

    d = autosave_path(cfg)
    if os.path.isdir(d):
        shutil.rmtree(d, ignore_errors=True)


class SignalTrap:
    """SIGINT and SIGTERM while the time loop runs.  The handler only
    records the signal; the loop, at the end of the base step in flight,
    writes the autosave from that step's state and time-stepping state
    and exits with 128 + signum.  So the autosave never holds a step
    half done, and state and hysteresis belong to one step.  A second
    signal exits at once.  Outside the main thread no handler can be
    set and the signals keep their handlers."""

    def __init__(self):
        self.signum = None
        self._old = {}

    def __enter__(self):
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                self._old[sig] = signal.signal(sig, self._record)
            except ValueError:  # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        for sig, handler in self._old.items():
            signal.signal(sig, handler)
        self._old.clear()

    def _record(self, signum, frame):
        if self.signum is not None:
            raise SystemExit(128 + signum)
        self.signum = signum

    def exit_if_signalled(self, save):
        """Call ``save()`` and exit with 128 + signum if a signal came."""
        if self.signum is None:
            return
        masterprint(f"Received signal {signal.Signals(self.signum).name}: "
                    f"writing an autosave before exiting ...")
        save()
        masterprint("done")
        raise SystemExit(128 + self.signum)


def load_snapshot_component(cfg: RunConfig, path: str, units):
    """The one particle component of the snapshot ``path`` →
    (ComponentSpec with the configured gravity, ParticleState of numpy
    arrays); sets cfg.a_begin, and cfg.boxsize where the file's differs.
    Particles outside the box are wrapped under snapshot_wrap, else the
    run aborts (reference out_of_bounds_check, snapshot.py:3359-3410)."""
    from concept_tpu_torch.io import snapshot as snap

    meta, loaded = snap.load(path, units, boxsize=cfg.boxsize, H0=cfg.H0)
    if len(loaded) != 1:
        raise NotImplementedError(f"{path} holds {len(loaded)} components: {MULTI_ITEM}")
    (name, (spec, st)), = loaded.items()
    pos = st.pos
    # a float32 file may round a position up onto the box edge (it does
    # for example_basic's box in kpc/h): that is the edge, which the wrap
    # in _to_device takes to 0, not a particle out of the box
    edge = meta.boxsize * (1 + 2.0**-23)
    if pos.size and (pos.min() < 0 or pos.max() >= edge):
        if not cfg.snapshot_wrap:
            abort(f"Snapshot {path!r} has particles outside [0, {meta.boxsize:g}); set "
                  f"snapshot_wrap = True to wrap them around the periodic box")
        st = st._replace(pos=np.mod(pos, meta.boxsize))
        masterprint(f"Wrapped out-of-bounds particles of {name!r} into the box "
                    f"(snapshot_wrap)")
    spec = ComponentSpec(name=spec.name, species=spec.species, N=spec.N, mass=spec.mass,
                         forces=(("gravity", is_selected_force(cfg, name, spec.species)),))
    cfg.a_begin = meta.a
    if abs(meta.boxsize - cfg.boxsize) > 1e-6 * cfg.boxsize:
        masterprint(f"Note: boxsize from snapshot ({meta.boxsize}) overrides parameter "
                    f"file ({cfg.boxsize})")
        cfg.boxsize = meta.boxsize
    return spec, st


def _to_device(st, dev, dtype, boxsize: float) -> ParticleState:
    """A ParticleState of numpy arrays → tensors on ``dev``: positions and
    momenta in ``dtype`` (a position that rounds up to the box edge
    wraps to 0), ids as int32; rungs are not carried (the stepper
    assigns them anew)."""
    import torch

    pos = periodic_wrap(torch.as_tensor(np.asarray(st.pos), device=dev).to(dtype), boxsize)
    ids = None if st.ids is None else torch.as_tensor(
        np.asarray(st.ids).astype(np.int32), device=dev)
    return ParticleState(pos=pos, mom=torch.as_tensor(np.asarray(st.mom), device=dev).to(dtype),
                         ids=ids)


def run(cfg: RunConfig, max_steps: int = 100000, seed: int | None = None,
        device=None, deposit_method: str | None = None, n_devices=1):
    """Run the simulation described by cfg on ``device`` (default: the
    CUDA card; a missing card raises).  ``deposit_method`` (default
    'auto') is the generic PM's, as in the JAX package: 'pallas' names the
    block kernels of PERF.md rows 10-11 (CUDA on the card, their plain
    versions on the CPU); 'auto' takes them on the card wherever they
    apply and 'scatter' elsewhere (grid/interp.py).  ``n_devices``: 1 or
    0 (all, which is the one card); more devices raise.  Returns (sim,
    state, a); the host seconds of realization, evolution and output are
    in ``sim.timings``.

    An autosave of this parameter file (see :func:`autosave_path`) is
    resumed.  SIGINT and SIGTERM during the time loop write an autosave
    and exit with 128 + signum (:class:`SignalTrap`).

    Departures from the JAX package, which ignores both settings without
    a word when it steps by rungs (``N_rungs > 1``): the rung stepper
    raises ``NotImplementedError``, before anything is realized, for
    ``shortrange_params`` whose scale or range differ from its own
    (1.25·boxsize/gridsize and 4.5·scale), and for a
    ``static_timestepping`` that records (a file that does not exist
    yet); replaying a recorded file works.  The component is realized
    with its own species' transfer function (``spec.species``) where
    the JAX package's single-component run takes 'matter' for every
    component; the two agree for species 'matter'."""
    from concept_tpu_torch.p3mrungs import RungSimulationAdapter
    from concept_tpu_torch.timestep import prepare_static_timestepping
    from concept_tpu_torch.utils.terminal import set_formatting, set_suppress_output

    if str(n_devices) not in ("0", "1"):
        raise NotImplementedError(
            f"-n {n_devices}: multi-GPU runs (ROADMAP Queue 1 item 14)")
    dev = resolve_device(device)
    dtype = resolve_dtype(dev, cfg.enable_float64)
    if cfg.suppress_output:
        set_suppress_output(cfg.suppress_output)
    if not cfg.enable_terminal_formatting:
        set_formatting(False)
    units, consts, bg, lin = build_cosmology(cfg)
    comps = build_components(cfg, bg, consts)
    if len(comps) > 1:
        raise NotImplementedError(MULTI_ITEM)
    spec, source = comps[0]
    loaded = None
    if source != "realize":
        spec, loaded = load_snapshot_component(cfg, source, units)
    method = spec.force_method("gravity") or "p3m"
    if method not in METHODS:
        raise ValueError(f"gravity has no method {method!r} (available: {', '.join(METHODS)})")
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
        ewald_gridsize=cfg.ewald_gridsize,
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

    t_realize = _time.time()
    resume = check_autosave(cfg)
    hysteresis = None
    if resume is not None:
        saved, a, events, hysteresis, _ = resume
        state = _to_device(saved, dev, dtype, cfg.boxsize)
        masterprint(f"Resumed from autosave at a = {a:.6g}")
    elif loaded is not None:
        state = _to_device(loaded, dev, dtype, cfg.boxsize)
        masterprint(f"Loaded initial conditions from snapshot at a = {cfg.a_begin:.6g}")
    else:
        seed_val = seed if seed is not None else int(
            cfg.random_seeds.get("primordial amplitudes", 0))
        lpt = int(cfg.realization_options.get("lpt", 1))
        masterprint(f"Realizing {spec.name} ({spec.N} particles, {lpt}LPT) ...")
        state = sim.initial_state(
            a_begin=cfg.a_begin, seed=seed_val, lpt_order=lpt,
            with_ids=bool(is_selected(spec, cfg.select_particle_id, default=False)),
            fixed_amplitude=cfg.primordial_amplitude_fixed,
            phase_shift=cfg.primordial_phase_shift,
            scheme=cfg.primordial_noise_imprinting,
            nongaussianity=float(cfg.realization_options.get("nongaussianity", 0.0)),
            dealias=bool(cfg.realization_options.get("dealias", False)),
            backscale=bool(cfg.realization_options.get("backscale", False)),
            species=spec.species,
        )
        masterprint("done")
    t_realize = _time.time() - t_realize

    if resume is None:
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

    t_wall0 = last_autosave = _time.time()
    t_evolve = t_dump = 0.0
    with SignalTrap() as trap:
        def on_step(flat_state, t, a_now, steps):
            # after a whole base step: its state, momenta at its t_mom
            trap.exit_if_signalled(lambda: write_autosave(
                cfg, sim, flat_state(), a_now, events, dict(sim.hysteresis), steps))

        while events:
            a_next = events[0][0]
            masterprint(f"Evolving to a = {a_next:.4g} ...")
            t0 = _time.time()
            state, a = sim.evolve(state, a, a_next, max_steps=max_steps,
                                  static_dt=static_dt, resume=hysteresis,
                                  callback=on_step)
            # Δt and the step counter stay continuous across dumps and
            # across an autosave and its resume
            hysteresis = dict(sim.hysteresis)
            t_evolve += _time.time() - t0
            masterprint("done")
            t0 = _time.time()
            while events and events[0][0] <= a + 1e-9:
                _, kind = events.pop(0)
                dump(cfg, sim, state, a, kind, units, lin)
            t_dump += _time.time() - t0
            steps = hysteresis.get("step_count", 0)
            trap.exit_if_signalled(lambda: write_autosave(
                cfg, sim, state, a, events, hysteresis, steps))
            if events and _time.time() - last_autosave > cfg.autosave_interval:
                write_autosave(cfg, sim, state, a, events, hysteresis, steps)
                last_autosave = _time.time()
    clear_autosave(cfg)
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


def _bpd(opts):
    """powerspec_options 'bins per decade': an int, or the reference's
    running dict form {k_or_expr: bins} (param/example_explanatory:242)."""
    v = opts.get("bins per decade", opts.get("bins_per_decade", 40))
    return v if isinstance(v, dict) else int(v)


def _output_flags(spec, selector, keys, primary):
    """An output ``*_select`` selector of a component → {flag: bool}
    (reference bispec_select/render2D_select/render3D_select,
    param/example_explanatory:77-159).  A bool switches the primary
    output and its columns on or off (plots stay off); a dict sets
    flags, the others off, and the primary on where it names none."""
    val = is_selected(spec, selector, default=True)
    flags = {k: False for k in keys}
    if isinstance(val, dict):
        low = {str(k).lower(): bool(v) for k, v in val.items()}
        for k in keys:
            flags[k] = low.get(k, False)
        if not any(k in low for k in keys):
            flags[primary] = True
    else:
        flags[primary] = bool(val)
        if flags[primary]:
            for k in keys:
                if k not in ("plot", "terminal image"):
                    flags[k] = True
    return flags


def dump(cfg: RunConfig, sim, state, a, kind, units, lin):
    """Write one scheduled output: 'powerspec', 'bispec' or 'snapshot'.
    The renders and the plots raise (ROADMAP Queue 1 item 13)."""
    base = cfg.output_bases.get(kind, kind)
    dirname = cfg.output_dirs.get(kind, "output")
    tag = f"a={a:.4g}" if cfg.enable_Hubble else f"t={a:.4g}"
    if kind == "powerspec":
        _dump_powerspec(cfg, sim, state, a, os.path.join(dirname, f"{base}_{tag}.txt"),
                        units, lin)
    elif kind == "bispec":
        _dump_bispec(cfg, sim, state, a, os.path.join(dirname, f"{base}_{tag}.txt"), lin)
    elif kind == "snapshot":
        from concept_tpu_torch.io import snapshot as snap

        meta = _snapshot_meta(cfg, a)
        if cfg.snapshot_type == "gadget":
            fn = os.path.join(dirname, f"{base}_{tag}")
            gp = cfg.gadget_snapshot_params or {}
            snap.save_gadget_multifile(
                fn, meta, sim.spec, state, units,
                particles_per_file=int(gp.get("particles per file",
                                              gp.get("particles_per_file", 2**31))),
                snapformat=int(gp.get("snapformat", 2)),
                single_precision=int(gp.get("dataformat", 32)) == 32,
                header_overrides=gp.get("header"))
        else:
            fn = os.path.join(dirname, f"{base}_{tag}.hdf5")
            snap.save_concept(fn, meta, {sim.spec.name: (sim.spec, state)},
                              select=(cfg.snapshot_select or {}).get("save"))
        masterprint(f"Saved snapshot: {fn}")
    else:
        raise NotImplementedError(f"{kind!r} output (ROADMAP Queue 1 item 13: renders)")


def _dump_powerspec(cfg, sim, state, a, fn, units, lin):
    from concept_tpu_torch.analysis.output import save_powerspec_txt
    from concept_tpu_torch.analysis.powerspec import powerspec, powerspec_sigma

    opts = cfg.powerspec_options or {}
    if opts.get("plot", False):
        raise NotImplementedError("power spectrum plots (ROADMAP Queue 1 item 13)")
    gridsize = int(opts.get("gridsize") or sim.config.potential_gridsize)
    pk = powerspec(
        state.pos, gridsize, cfg.boxsize, sim.spec.N,
        order=opts.get("interpolation", 4),
        interlace=bool(opts.get("interlace", True)),
        bins_per_decade=_bpd(opts), k_max=opts.get("k_max"),
    )
    lin_col = np.asarray(lin.power_delta(pk["k"], a)) if lin is not None else None
    R = float(opts.get("tophat", 8 / cfg.h * units.Mpc))
    sigma = powerspec_sigma(pk["k"], pk["power_corrected"], R)
    sigma_lin = lin.sigma_R(R, a) if lin is not None else None
    save_powerspec_txt(fn, pk, a, cfg.boxsize, cfg.unit_length, sigma, R,
                       lin_col, sigma_linear=sigma_lin,
                       significant_figures=int(opts.get("significant figures", 18)))
    masterprint(f"Saved power spectrum: {fn}")


def _dump_bispec(cfg, sim, state, a, fn, lin):
    from concept_tpu_torch.analysis.bispec import bispec, bispec_treelevel

    flags = _output_flags(sim.spec, cfg.bispec_select,
                          ("data", "reduced", "treelevel", "plot"), "data")
    opts = cfg.bispec_options or {}
    if flags["plot"] or opts.get("plot", False):
        raise NotImplementedError("bispectrum plots (ROADMAP Queue 1 item 13)")
    if not flags["data"]:
        return
    out = bispec([state.pos], [1.0],
                 int(opts.get("gridsize") or sim.config.potential_gridsize), cfg.boxsize,
                 configuration=opts.get("configuration", "equilateral 10"),
                 antialias=cfg.bispec_antialiasing,
                 shellthickness=opts.get("shellthickness"))
    cols = [out["triangles"], out["n_triangles"][:, None], out["B"][:, None]]
    header = "k1 k2 k3 triangles B"
    if flags["reduced"]:
        cols.append(out["Q"][:, None])
        header += " Q_reduced"
    if lin is not None and flags["treelevel"]:
        cols.append(bispec_treelevel(lin, out["triangles"], a)[:, None])
        header += " B_treelevel"
    os.makedirs(os.path.dirname(os.path.abspath(fn)), exist_ok=True)
    np.savetxt(fn, np.column_stack(cols), header=header)
    masterprint(f"Saved bispectrum: {fn}")
