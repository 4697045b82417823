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
species-resolved transfer functions).  Several components, fluids
among them, run through :func:`run_multi` (sim_multi.MultiSimulation).
It dumps the renders (2D projections with their data and terminal
images, 3D scatter renders) and the spectra's plots (graphics/render.py).
``-n N`` runs one component over N ranks (:func:`make_distribution`,
parallel/ranks.py): global steps (PM, P³M with ``N_rungs = 1``, PP), or
the rung stepper on every layout, each rank stepping its own x-planes of
cells (p3mrungs.py), from a realization that each rank makes of its slab
of the lattice (ic.py); and runs of several components and fluids, each
rank holding its particle shards and its x-rows of every fluid grid
(sim_multi.py).  ``-n AxB`` runs the same over A·B ranks, the global
stepper's PM and P³M kicks on the 2D pencils of an A × B mesh
(grid/fft.GridDistribution2D, parallel/step.pm_momentum_updates_
distributed_2d).
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
    ComponentSpec, EquationOfState, FluidState, ParticleState, particle_mass,
    periodic_wrap,
)
from concept_tpu_torch.cosmology.background import Background
from concept_tpu_torch.cosmology.backend import build_tables
from concept_tpu_torch.cosmology.linear import LinearCosmology
from concept_tpu_torch.cosmology.neutrino import NeutrinoBackground
from concept_tpu_torch.cosmology.primordial import PrimordialSpectrum
from concept_tpu_torch.device import resolve_device, resolve_dtype
from concept_tpu_torch.forces.pm import interlace_pair
from concept_tpu_torch.param import RunConfig, is_selected
from concept_tpu_torch.sim import METHODS, SimConfig, Simulation
from concept_tpu_torch.units import UnitSystem
from concept_tpu_torch.utils.terminal import abort, masterprint


def pencil_shape(n_devices):
    """(A, B) of ``-n AxB`` (A, B ≥ 1), None for an integer ``-n``."""
    if not (isinstance(n_devices, str) and "x" in n_devices.lower()):
        return None
    try:
        na, nb = (int(v) for v in n_devices.lower().split("x"))
    except ValueError:
        raise ValueError(f"-n {n_devices}: expected N or AxB") from None
    if na < 1 or nb < 1:
        raise ValueError(f"-n {n_devices}: A and B must be at least 1")
    return na, nb


def rank_count(n_devices, device) -> int:
    """The ranks of ``-n``: an integer N (0: every visible card, or the
    CPU's cores on the CPU), or A·B for the 2D pencils 'AxB'; more than
    are visible raise ValueError."""
    from concept_tpu_torch.parallel.ranks import visible_devices

    shape = pencil_shape(n_devices)
    n = shape[0] * shape[1] if shape else int(n_devices)
    avail = visible_devices(device)
    if n == 0 and not shape:
        n = avail
    if n < 1 or n > avail:
        raise ValueError(f"-n {n_devices} requested but only {avail} device(s) available"
                         f" ({device.type})")
    return n


def make_distribution(n_devices, device="cuda"):
    """`-n N` → None for one rank, else the GridDistribution over the
    process group of the N ranks that this process is one of; `-n AxB`
    → the GridDistribution2D of an A × B mesh of those ranks (every rank
    makes its groups here), None for 1x1 (the JAX package builds a device
    mesh here, concept_tpu/run.py:398-440)."""
    import torch.distributed as tdist

    from concept_tpu_torch.grid.fft import GridDistribution, make_pencils

    n = rank_count(n_devices, resolve_device(device))
    if n == 1:
        return None
    if not (tdist.is_initialized() and tdist.get_world_size() == n):
        raise RuntimeError(f"-n {n_devices}: this process is no rank of a group of {n} "
                           f"(run() starts the ranks)")
    shape = pencil_shape(n_devices)
    return make_pencils(*shape) if shape else GridDistribution()


def check_pencil_layout(n_devices, gridsize: int, N: int, mesh: str | None):
    """Raise ValueError where one component cannot run on the pencils of
    ``-n AxB``, before anything is realized: where the kick runs on the
    pencils (``mesh`` 'pencils'), a potential grid that A or B does not
    divide (the pencil FFT's tiled transposes); where it takes the 1D
    slab paths over the A·B ranks ('slabs': rungs, interlacing, a
    stencil), a grid that A·B does not divide (their slabs); and an N
    that A·B does not divide (the particles' index shards).  PP (``mesh``
    None) has no grid."""
    na, nb = pencil_shape(n_devices)
    split = {"pencils": (("A", na), ("B", nb)), "slabs": (("A·B", na * nb),), None: ()}[mesh]
    for what, p in split:
        if gridsize % p:
            raise ValueError(f"the potential grid {gridsize} does not split over {what} = "
                             f"{p} of -n {n_devices}")
    if N % (na * nb):
        raise ValueError(f"{N} particles do not split evenly over the {na * nb} ranks of "
                         f"-n {n_devices}")


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
    components, [(ComponentSpec, 'realize-fluid')] for fluids (an entry
    with a gridsize) and [(None, path)] for a snapshot (its file names the
    components)."""
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
        gridsize = entry.get("gridsize")
        if N:
            Omega = cfg.Omega_m if species == "matter" else (
                cfg.Omega_cdm if species in ("cdm", "cold dark matter") else cfg.Omega_b)
            mass = entry.get("mass", particle_mass(Omega, rho_crit, cfg.boxsize, N))
            out.append((ComponentSpec(
                name=name, species=species, N=int(N), mass=float(mass),
                forces=(("gravity", is_selected_force(cfg, name, species)),),
            ), "realize"))
        elif gridsize:
            out.append((_fluid_spec(cfg, entry, name, species, int(gridsize), constants),
                        "realize-fluid"))
        else:
            raise ValueError(f"component entry needs N or gridsize: {entry}")
    return out


def _fluid_spec(cfg: RunConfig, entry: dict, name: str, species: str, gridsize: int,
                constants) -> ComponentSpec:
    """A fluid entry of initial_conditions (reference gridsize form,
    param/example_explanatory:18-25) → its ComponentSpec.  The selectors
    select_eos_w, select_boltzmann_order / _closure fill in what the
    entry does not give (reference species.py:2940-3526)."""
    s = SimpleNamespace(name=name, species=species, representation="fluid")
    w = entry.get("w")
    if w is None:
        w_sel = is_selected(s, cfg.select_eos_w, default="default")
        if isinstance(w_sel, (int, float)):
            w = float(w_sel)
        elif isinstance(w_sel, str) and w_sel not in ("default", "class"):
            w = float(eval(w_sel, {"__builtins__": {}}, {}))  # noqa: S307
        else:
            # 'default' / 'class': the species' constant w (ν gets the
            # exact Fermi-Dirac spline in run_multi)
            w = 1.0 / 3.0 if ("radiation" in species or "photon" in species) else 0.0
    border = entry.get("boltzmann order", entry.get("boltzmann_order"))
    if border is None:
        border = is_selected(s, cfg.select_boltzmann_order, default=1)
    bclosure = entry.get("boltzmann closure", entry.get("boltzmann_closure"))
    if bclosure is None:
        bclosure = is_selected(s, cfg.select_boltzmann_closure, default="truncate")
    # decaying cold dark matter: Γ from the entry or from class_params'
    # Gamma_dcdm [km/s/Mpc] (reference linear.py:3552-3560)
    decay_rate = float(entry.get("decay rate", entry.get("decay_rate", 0.0)))
    if not decay_rate and ("dcdm" in species or "decaying" in species):
        gam = cfg.class_params.get("Gamma_dcdm")
        if gam:
            decay_rate = float(gam) * (constants.light_speed / 299792.458) / cfg.units.Mpc
    return ComponentSpec(name=name, species=species, representation="fluid",
                         gridsize=gridsize, w=float(w), boltzmann_order=int(border),
                         boltzmann_closure=str(bclosure), decay_rate=decay_rate,
                         decay_to=entry.get("decay to", entry.get("decay_to")))


def p_eq_wrho_selected(cfg: RunConfig, spec) -> bool:
    """select_approximations 'P=wρ' of a component (reference
    species.py:1320-1351 spellings, :1657-1665: True where 𝒫 is no
    variable of its own).  Default False (example_explanatory:367-371)."""
    sel = is_selected(spec, cfg.select_approximations, default={})
    val = False
    if isinstance(sel, dict):
        for key, v in sel.items():
            k = str(key)
            for ch in " *×^":
                k = k.replace(ch, "")
            for alias in ("\\rho", "rho"):
                k = k.replace(alias, "ρ")
            if k in ("P=wρ", "P=ρw", "wρ=P", "ρw=P"):
                val = bool(v)
    elif isinstance(sel, bool):
        val = sel
    if spec.boltzmann_order < 0 or (
            spec.boltzmann_order == 0 and spec.boltzmann_closure == "truncate"):
        return True
    return val


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
    :func:`check_autosave_multi`'s."""
    from concept_tpu_torch.io import snapshot as snap

    d = autosave_path(cfg)
    fn = os.path.join(d, "snapshot.hdf5")
    aux = os.path.join(d, "auxiliary.json")
    if not (os.path.exists(fn) and os.path.exists(aux)):
        return None
    with open(aux) as f:
        info = json.load(f)
    if info.get("multi"):
        masterprint(f"Not resuming from {d} in a run of one component: a "
                    f"multi-component autosave")
        return None
    _, comps = snap.load_concept(fn)
    (_, (_, state)), = comps.items()
    return (state, float(info["a"]), [tuple(e) for e in info["events"]],
            info.get("hysteresis"), int(info.get("step_total", 0)))


def write_autosave_multi(cfg: RunConfig, sim, state, a: float, events,
                         hysteresis: dict | None = None):
    """The autosave of a run of several components: every particle and
    fluid component in one CONCEPT snapshot, <dir>/snapshot.hdf5, and
    <dir>/auxiliary.json with a, the events still to come (activations
    and terminations among them), the time-stepping state and
    ``"multi": true`` (reference main.py:1821-1927)."""
    from concept_tpu_torch.io import snapshot as snap

    d = autosave_path(cfg)
    os.makedirs(d, exist_ok=True)
    comps = {name: (sim.pspecs[name], ps) for name, ps in state.particles.items()}
    comps.update({name: (sim.fspecs[name], fs) for name, fs in state.fluids.items()})
    snap.save_concept(os.path.join(d, "snapshot.hdf5"), _snapshot_meta(cfg, a), comps)
    aux = {"a": a, "events": [[e[0], list(e[1])] if isinstance(e[1], tuple) else [e[0], e[1]]
                              for e in events], "multi": True}
    if hysteresis:
        aux["hysteresis"] = {k: float(v) if k in ("dt", "dt_min", "t_mom") else int(v)
                             for k, v in hysteresis.items()}
    with open(os.path.join(d, "auxiliary.json"), "w") as f:
        json.dump(aux, f)
    masterprint(f"Autosaved at a = {a:.6g} → {d}")


def check_autosave_multi(cfg: RunConfig):
    """A multi-component autosave to resume from: ({name: (spec, state of
    numpy arrays)}, a, events, hysteresis), or None."""
    from concept_tpu_torch.io import snapshot as snap

    d = autosave_path(cfg)
    fn = os.path.join(d, "snapshot.hdf5")
    aux = os.path.join(d, "auxiliary.json")
    if not (os.path.exists(fn) and os.path.exists(aux)):
        return None
    with open(aux) as f:
        info = json.load(f)
    if not info.get("multi"):
        return None
    _, comps = snap.load_concept(fn)
    events = [(float(e0), tuple(e1) if isinstance(e1, list) else e1)
              for e0, e1 in info["events"]]
    return comps, float(info["a"]), events, info.get("hysteresis")


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

    def exit_if_signalled(self, save, agree=None):
        """Call ``save()`` and exit with 128 + signum if a signal came
        (over the ranks of a run: to any of them, ``agree`` taking the
        largest signal number of the ranks)."""
        signum = self.signum if agree is None else int(agree(self.signum or 0)) or None
        if signum is None:
            return
        masterprint(f"Received signal {signal.Signals(signum).name}: "
                    f"writing an autosave before exiting ...")
        save()
        masterprint("done")
        raise SystemExit(128 + signum)


def load_snapshot_component(cfg: RunConfig, path: str, units):
    """The one particle component of the snapshot ``path`` →
    (ComponentSpec with the configured gravity, ParticleState of numpy
    arrays); sets cfg.a_begin, and cfg.boxsize where the file's differs.
    Particles outside the box are wrapped under snapshot_wrap, else the
    run aborts (reference out_of_bounds_check, snapshot.py:3359-3410)."""
    from concept_tpu_torch.io import snapshot as snap

    meta, loaded = snap.load(path, units, boxsize=cfg.boxsize, H0=cfg.H0)
    if len(loaded) != 1:
        # as in the JAX package, which unpacks the one component
        raise ValueError(f"{path} holds {len(loaded)} components: a run starts from "
                         f"a snapshot of one particle component")
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
        device=None, deposit_method: str | None = None, n_devices=1, rank=None):
    """Run the simulation described by cfg on ``device`` (default: the
    CUDA card; a missing card raises).  ``deposit_method`` (default
    'auto') is the generic PM's, as in the JAX package: 'pallas' names the
    block kernels of PERF.md rows 10-11 (CUDA on the card, their plain
    versions on the CPU); 'auto' takes them on the card wherever they
    apply and 'scatter' elsewhere (grid/interp.py).  Returns (sim,
    state, a); the host seconds of realization, evolution and output are
    in ``sim.timings``, each rank's peak device memory in
    ``sim.rank_peak_bytes``.

    ``n_devices`` (``-n``): the ranks of the run (see :func:`rank_count`).
    With N > 1 this process becomes rank 0 on ``cuda:0`` (or the CPU) and
    starts ranks 1 … N−1 (``rank``, (r, store), is theirs; parallel/
    ranks.py); each realizes its slab of the single run's lattice on the
    slab FFT and hands the particles to the ranks whose index shards hold
    their ids (ic.realize_particles(dist=), parallel/step.hand_off), and
    the run steps globally (PM, P³M with ``N_rungs =
    1``, PP) through ``Simulation(dist=...)``, or by rungs through
    ``RungSimulationAdapter(dist=...)`` (the layout of one device, each
    rank stepping its x-planes of cells, which need not split evenly).
    ``-n AxB`` runs the A·B ranks as ``-n A·B`` does, but for the global
    stepper's PM and P³M kicks with Fourier gradients and no
    interlacing, which deposit, transform and differentiate on the 2D
    pencils of an A × B mesh of the ranks (``1x1``: one device, as in
    the JAX package); a grid that A or B does not divide, and an N that
    A·B does not divide, raise ValueError before anything is realized
    (:func:`check_pencil_layout`).
    Rank 0 writes every file under the single run's names (the dumps and
    autosaves send it the rows it writes); every rank returns the whole
    state.  Before anything is realized, rungs over ranks that
    cannot run raise ValueError (p3mrungs.check_rank_layout: a grid the
    ranks do not divide, too few planes of cells a rank for the sweep's
    reach, a tight layout below 3 cells a side), and so do runs of
    several components that cannot (:func:`check_multi_layout`); the
    other ranks are then ended.  Several components and fluids run over
    the ranks through :func:`run_multi`.

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
    from concept_tpu_torch.p3mrungs import RungSimulationAdapter, check_rank_layout
    from concept_tpu_torch.timestep import prepare_static_timestepping
    from concept_tpu_torch.utils.terminal import set_formatting, set_suppress_output

    dev = resolve_device(device)
    n_ranks = rank_count(n_devices, dev)
    if n_ranks > 1 and rank is None:
        # the ranks start first (a spawned process takes seconds to import
        # torch); each then checks what it can run, rank 0 in this process
        from concept_tpu_torch.parallel.ranks import Ranks

        with Ranks(n_ranks, dev) as ranks:
            ranks.start(run, cfg, max_steps, seed, device, deposit_method, n_devices)
            return run(cfg, max_steps, seed, device, deposit_method, n_devices,
                       rank=(0, ranks.store))
    dtype = resolve_dtype(dev, cfg.enable_float64)
    if cfg.suppress_output:
        set_suppress_output(cfg.suppress_output)
    if not cfg.enable_terminal_formatting:
        set_formatting(False)
    units, consts, bg, lin = build_cosmology(cfg)
    comps = build_components(cfg, bg, consts)
    if any(src == "realize-fluid" for _, src in comps) or len(comps) > 1:
        return run_multi(cfg, comps, units, consts, bg, lin, dev, dtype,
                         max_steps=max_steps, seed=seed, n_devices=n_devices, rank=rank)
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
        if n_ranks > 1:
            check_rank_layout(gridsize, n_ranks, dev.type, boxsize=cfg.boxsize)
    if n_ranks > 1 and pencil_shape(n_devices):
        # the kicks that Simulation runs on the pencils; the others take
        # the slabs of the A·B ranks
        mesh = None if method not in ("pm", "p3m") else "pencils" if (
            not rungs and pot.get("differentiation", "fourier") in ("fourier", 0)
            and interlace_pair(pot.get("interlace", False)) == ("sc", "sc")) else "slabs"
        check_pencil_layout(n_devices, gridsize, spec.N, mesh)
    dist = pencils = None
    if n_ranks > 1:
        from concept_tpu_torch.parallel.ranks import init_rank

        dev = init_rank(rank[0], n_ranks, rank[1], dev)
        dist = make_distribution(n_devices, dev)
        if pencil_shape(n_devices):
            # the global stepper's PM kick runs on the pencils, everything
            # else over the A·B ranks as -n A·B does
            pencils, dist = dist, dist.flat
        masterprint(f"Ranks: {n_devices if pencils else n_ranks} "
                    f"({'nccl' if dev.type == 'cuda' else 'gloo'})")
        if dist.rank and static_dt is not None and static_dt.records:
            static_dt = None  # rank 0 records the steps, which all ranks take
    if dev.type == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats(dev)
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
                                    fac_rung=cfg.Delta_t_rung_factor, dist=dist)
    else:
        sim = Simulation(spec, sim_config, bg, lin, dist=pencils or dist)
    rank0 = dist is None or dist.rank == 0

    def agree(value: float) -> float:
        """The largest of the ranks' values (the value on one device):
        the ranks take each decision that leads to a collective together."""
        if dist is None:
            return value
        import torch

        return float(sim.reduce(torch.tensor(float(value), device=dev),
                                 torch.distributed.ReduceOp.MAX))

    def autosave(st, a_now, events, hyst, steps):
        if dist is not None:
            st = sim.whole(st, root=0)
        if rank0:
            write_autosave(cfg, sim, st, a_now, events, hyst, steps)

    t_realize = _time.time()
    resume = check_autosave(cfg)
    if dist is not None:
        # every rank has read the autosave before rank 0 can clear it
        # (a resume at the last output reaches the clear with no
        # collective on the way)
        import torch.distributed as tdist

        tdist.barrier(group=dist.group)
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
    if dist is not None and (resume is not None or loaded is not None):
        # every rank read the whole file; initial_state realizes each
        # rank's shard alone
        state = sim.shard(state)
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
            trap.exit_if_signalled(lambda: autosave(
                flat_state(), a_now, events, dict(sim.hysteresis), steps), agree)

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
            trap.exit_if_signalled(lambda: autosave(state, a, events, hysteresis, steps),
                                   agree)
            if events and agree(_time.time() - last_autosave > cfg.autosave_interval):
                autosave(state, a, events, hysteresis, steps)
                last_autosave = _time.time()
    if rank0:
        clear_autosave(cfg)
    sim.rank_peak_bytes = _rank_peaks(dev, dist)
    if dist is not None:
        state = sim.whole(state)
    step_total = sim.hysteresis.get("step_count", 0)
    wall = _time.time() - t_wall0
    if step_total:
        masterprint(
            f"Time-step summary: {step_total} steps, {t_evolve:.1f} s evolution "
            f"({1e3 * t_evolve / step_total:.0f} ms/step), {t_dump:.1f} s output")
    masterprint(f"Simulation complete: a = {a:.6g}, wall time {wall:.1f} s")
    sim.timings = {"realize_s": t_realize, "evolve_s": t_evolve, "dump_s": t_dump}
    return sim, state, a


def _rank_peaks(dev, dist) -> list:
    """Each rank's peak device memory over the run (0 on the CPU), on
    every rank, taken before the state is gathered."""
    import torch

    from concept_tpu_torch.parallel.step import replicate

    peak = torch.tensor([float(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
                         else 0.0], device=dev)
    return [int(x) for x in (peak if dist is None else replicate(peak, dist)).tolist()]


def _state_to_device(st, dev, dtype, boxsize: float):
    """A ParticleState or FluidState of numpy arrays (a snapshot's, an
    autosave's) → tensors on ``dev`` in ``dtype``."""
    import torch

    if hasattr(st, "pos"):
        return _to_device(st, dev, dtype, boxsize)
    return FluidState(*(None if x is None else torch.as_tensor(np.asarray(x), device=dev).to(dtype)
                        for x in st))


def make_multi(cfg: RunConfig, comps, units, consts, bg, lin, dev, dtype,
               seed: int | None = None, dist=None):
    """The MultiSimulation of a run of several components (the first
    half of :func:`run_multi`): each component's life from select_lives,
    the shared potential grid, softening 0 with the Plummer kernel (as
    the JAX package's run_multi), and per fluid its Ω, EoS and noise
    seed; over the ranks of ``dist``."""
    from concept_tpu_torch.sim_multi import MultiSimulation

    def with_life(spec):
        life = is_selected(spec, cfg.select_lives, default=(0.0, float("inf")))
        return ComponentSpec(**{**spec.__dict__, "life": tuple(life)})

    pspecs = [with_life(s) for s, src in comps
              if src == "realize" and s.representation == "particles"]
    fspecs = [with_life(s) for s, src in comps if src == "realize-fluid"]
    pot = cfg.potential_options
    # the shared potential takes the 'pm' per-method size where one is
    # given (reference multigrid, param/example_nonlinnu)
    gridsize = int(pot.get("gridsize_per_method", {}).get("pm") or pot.get("gridsize")
                   or max([2 * round(s.N ** (1 / 3)) for s in pspecs]
                          + [s.gridsize for s in fspecs]))
    sim_config = SimConfig(
        boxsize=cfg.boxsize, potential_gridsize=gridsize, device=dev, dtype=dtype,
        G=consts.G_Newton, interpolation_order=pot.get("interpolation", 2),
        interlace=bool(pot.get("interlace", False)),
        softening=0.0, softening_kernel="plummer",
        da_max_early=cfg.Delta_a_max_early, da_max_late=cfg.Delta_a_max_late)
    rho_crit = bg.rho_crit_of(consts.G_Newton)
    seed_val = seed if seed is not None else int(
        cfg.random_seeds.get("primordial amplitudes", 0))
    # per fluid: Ω, the EoS (ν: the exact Fermi-Dirac spline of
    # build_cosmology) and the noise seed of its linear re-realizations
    km_per_s = consts.light_speed / 299792.458
    h = cfg.H0 / (100 * km_per_s / units.Mpc)
    Omega_r = 4.15e-5 / h**2  # photons + massless ν (T_CMB = 2.7255)
    nubg = getattr(lin, "nu_background", None)
    fluid_Omegas, eos = {}, {}
    for s in fspecs:
        if "neutrino" in s.species and nubg is not None:
            fluid_Omegas[s.name] = lin.Omega_nu
            eos[s.name] = EquationOfState.from_neutrino(nubg)
        elif "radiation" in s.species or "photon" in s.species:
            fluid_Omegas[s.name] = Omega_r
            eos[s.name] = EquationOfState.constant(1.0 / 3.0)
        else:
            fluid_Omegas[s.name] = cfg.Omega_m
    return MultiSimulation(
        pspecs, fspecs, sim_config, bg, lin, light_speed=consts.light_speed,
        fluid_Omegas=fluid_Omegas, rho_crit=rho_crit, eos=eos,
        fluid_seeds={s.name: seed_val for s in fspecs},
        fluid_options=cfg.fluid_options, fluid_scheme_select=cfg.fluid_scheme_select,
        approximations={s.name: p_eq_wrho_selected(cfg, s) for s in fspecs}, dist=dist)


def check_multi_layout(sim, d: int, powerspec_gridsize: int | None = None):
    """Raise ValueError where a run of several components cannot run over
    d ranks, before anything is realized: a potential grid (or a power
    spectrum's grid) that d does not divide (the PM's slabs), a particle
    component whose N the ranks do not share evenly (its index shards),
    and a fluid grid that leaves a rank fewer x-rows than its stencil
    reaches along x (parallel/step.halo_rows takes the halo from the
    neighbours alone: 2 rows for Kurganov-Tadmor and the MacCormack
    vacuum passes, 1 for MacCormack without them; a fluid that does not
    drift, boltzmann order −1, needs none)."""
    from concept_tpu_torch.grid.fft import row_starts

    for what, n in (("potential grid", sim.config.potential_gridsize),
                    ("power spectrum grid", powerspec_gridsize)):
        if n and n % d:
            raise ValueError(f"the {what} {n} does not split over {d} ranks")
    for name, spec in sim.pspecs.items():
        if spec.N % d:
            raise ValueError(f"{spec.N} particles of {name!r} do not split evenly over "
                             f"{d} ranks")
    for name, spec in sim.fspecs.items():
        if spec.boltzmann_order < 0:
            continue
        reach = 1 if sim.fluid_scheme[name] == "maccormack" and not sim._mc_vacuum else 2
        starts = row_starts(spec.gridsize, d)
        fewest = min(b - a for a, b in zip(starts, starts[1:]))
        if fewest < reach:
            raise ValueError(f"fluid grid {spec.gridsize} of {name!r} over {d} ranks leaves "
                             f"a rank {fewest} rows; its stencil reaches {reach}")


def realize_multi_component(cfg: RunConfig, sim, spec, a: float, seed: int):
    """One component of a run of several (``sim`` its MultiSimulation) at
    scale factor a, as :func:`run_multi` realizes it at the start and at
    its activation: particles by ``parallel/step.realize_shard``, a fluid
    by ``sim_multi.realize_fluid_from_linear``, in float32 and then in
    the run's dtype, and over the ranks of ``sim.dist`` this rank's part
    alone."""
    import torch

    from concept_tpu_torch import sim_multi
    from concept_tpu_torch.parallel.step import realize_shard

    dev, dtype = sim.config.device, sim.config.dtype
    if spec.representation == "particles":
        masterprint(f"Realizing {spec.name} ({spec.N} particles) at a = {a:.4g} ...")
        st = realize_shard(
            sim.lin, spec, cfg.boxsize, a, sim.dist, seed=seed,
            lpt_order=int(cfg.realization_options.get("lpt", 1)), dtype=torch.float32,
            device=dev, scheme=cfg.primordial_noise_imprinting,
            dealias=bool(cfg.realization_options.get("dealias", False)),
            backscale=bool(cfg.realization_options.get("backscale", False)))
        masterprint("done")
        return st._replace(pos=st.pos.to(dtype), mom=st.mom.to(dtype))
    masterprint(f"Realizing fluid {spec.name} (gridsize {spec.gridsize}) at a = {a:.4g} ...")
    st = sim_multi.realize_fluid_from_linear(
        sim.lin, spec, cfg.boxsize, a, sim.fluid_Omegas[spec.name] * sim.rho_crit, seed=seed,
        dtype=torch.float32, device=dev, eos=sim.eos[spec.name], dist=sim.dist)
    masterprint("done")
    return FluidState(*(None if x is None else x.to(dtype) for x in st))


def run_multi(cfg: RunConfig, comps, units, consts, bg, lin, dev, dtype,
              max_steps: int = 100000, seed: int | None = None, n_devices=1, rank=None):
    """A run of several components, particles and fluids coupled through
    one PM potential (port of concept_tpu/run.py:729-975; reference
    general component loop, main.py:214-461), with the components'
    lives (activation and termination events in life_output_order),
    the periodic autosave and its resume, and the signal trap.  Returns
    (sim, MultiState, a); the host seconds are in ``sim.timings``, each
    rank's peak device memory in ``sim.stats['rank_peak_bytes']``.

    As in the JAX package the P³M sweeps take softening 0 and the
    Plummer kernel whatever the parameter file says, the particle
    components are realized with the matter transfer function and the
    fluids without ``primordial_amplitude_fixed`` (ROADMAP Queue 3).
    As the JAX package's, the components are realized in float32 (its
    noise and arithmetic) and then take the run's dtype.  Departures: an
    autosave resumes in the run's dtype (the JAX package in float32); the
    signal trap writes the state of the last whole step, as
    :func:`run`'s does (the JAX package's that of the last segment).

    Over the ranks of ``-n N`` (``rank``: this process's (r, store), as
    :func:`run` starts them) each rank holds the index shard of every
    particle component and its x-rows of every fluid grid
    (sim_multi.MultiSimulation(dist=...)): it realizes its part alone
    (parallel/step.realize_shard, realize_fluid_from_linear(dist=)), at
    the start and at each activation.  What cannot run over the ranks
    raises ValueError first (:func:`check_multi_layout`).  The ranks agree
    on every decision that leads to a collective (a signal to any rank,
    the autosave's interval), the dumps and autosaves send rank 0 the
    rows it writes, and the returned state is gathered on every rank.
    A resume reads the whole autosave on every rank and keeps its part
    (reading by rank is ROADMAP Queue 1 item 14g)."""
    import torch

    from concept_tpu_torch.sim_multi import MultiState
    from concept_tpu_torch.timestep import prepare_static_timestepping

    dist = None
    n_ranks = 1 if rank is None else rank_count(n_devices, dev)
    if n_ranks > 1:
        from concept_tpu_torch.parallel.ranks import init_rank

        dev = init_rank(rank[0], n_ranks, rank[1], dev)
        dist = make_distribution(n_devices, dev)
        # several components run over the A·B ranks of -n AxB as -n A·B
        dist = getattr(dist, "flat", dist)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sim = make_multi(cfg, comps, units, consts, bg, lin, dev, dtype, seed=seed, dist=dist)
    opts = cfg.powerspec_options or {}
    if dist is not None:
        check_multi_layout(sim, n_ranks, int(opts.get("gridsize") or 0) or None)
        masterprint(f"Ranks: {n_ranks} ({'nccl' if dev.type == 'cuda' else 'gloo'})")
    if dev.type == "cuda":
        masterprint(f"Device: {dev} ({_device_name(dev)})")
    rank0 = dist is None or dist.rank == 0
    seed_val = seed if seed is not None else int(
        cfg.random_seeds.get("primordial amplitudes", 0))
    pspecs, fspecs = list(sim.pspecs.values()), list(sim.fspecs.values())

    def agree(value: float) -> float:
        """The largest of the ranks' values (the value on one device)."""
        if dist is None:
            return value
        return float(sim.reduce(torch.tensor(float(value), device=dev),
                                 torch.distributed.ReduceOp.MAX))

    def autosave(st, a_now, events, hyst):
        if dist is not None:
            st = sim.whole(st, root=0)
        if rank0:
            write_autosave_multi(cfg, sim, st, a_now, events, hysteresis=hyst)

    t_realize = _time.time()
    resume = check_autosave_multi(cfg)
    if dist is not None:
        # every rank has read the autosave before rank 0 can clear it
        torch.distributed.barrier(group=dist.group)
    hysteresis = None
    if resume is not None:
        saved, a_resume, events_resume, hysteresis = resume
        particles, fluids = {}, {}
        for name, (_, st) in saved.items():
            target = particles if hasattr(st, "pos") else fluids
            target[name] = _state_to_device(st, dev, dtype, cfg.boxsize)
        # every rank read the whole autosave and keeps its part
        state = sim.shard(MultiState(particles=particles, fluids=fluids))
        masterprint(f"Resumed from autosave at a = {a_resume:.6g}")
    else:
        state = MultiState(*({s.name: realize_multi_component(cfg, sim, s, cfg.a_begin, seed_val)
                              for s in specs if s.life[0] <= cfg.a_begin}
                             for specs in (pspecs, fspecs)))
    t_realize = _time.time() - t_realize

    # events: the output dumps and the components' activations and
    # terminations (reference activate_terminate, main.py:1726-1803),
    # coincident ones in life_output_order
    events = [(float(t), kind) for kind, times in cfg.output_times.get("a", {}).items()
              for t in times]
    for s in pspecs + fspecs:
        if cfg.a_begin < s.life[0] < float("inf"):
            events.append((float(s.life[0]), ("__activate__", s.name)))
        if s.life[1] < float("inf"):
            events.append((float(s.life[1]), ("__terminate__", s.name)))
    order = {act: i for i, act in enumerate(cfg.life_output_order)}

    def event_key(e):
        act = "dump" if isinstance(e[1], str) else e[1][0].strip("_")
        return (e[0], order.get(act, len(order)))

    events.sort(key=event_key)
    if resume is not None:
        a, events = a_resume, events_resume
    else:
        a = cfg.a_begin
        for _, kind in [e for e in events if e[0] <= a + 1e-12]:
            if isinstance(kind, str):
                dump_multi(cfg, sim, state, a, kind, units, lin)
        events = [e for e in events if e[0] > a + 1e-12]
    all_specs = {s.name: s for s in pspecs + fspecs}
    static_dt = prepare_static_timestepping(cfg.static_timestepping)
    if dist is not None and dist.rank and static_dt is not None and static_dt.records:
        static_dt = None  # rank 0 records the steps, which all ranks take

    t_wall0 = last_save = _time.time()
    t_evolve = t_dump = 0.0
    with SignalTrap() as trap:
        def on_step(st, t, a_now, steps):
            trap.exit_if_signalled(lambda: autosave(st, a_now, events, dict(sim.hysteresis)),
                                   agree)

        while events:
            a_next = events[0][0]
            masterprint(f"Evolving to a = {a_next:.4g} ...")
            t0 = _time.time()
            state, a = sim.evolve(state, a, a_next, max_steps=max_steps,
                                  static_dt=static_dt, resume=hysteresis, callback=on_step)
            # Δt hysteresis carries across segments and into autosaves
            hysteresis = dict(sim.hysteresis)
            t_evolve += _time.time() - t0
            masterprint("done")
            if agree(_time.time() - last_save > cfg.autosave_interval):
                autosave(state, a, events, hysteresis)
                last_save = _time.time()
            t0 = _time.time()
            while events and events[0][0] <= a + 1e-9:
                _, kind = events.pop(0)
                if isinstance(kind, str):
                    dump_multi(cfg, sim, state, a, kind, units, lin)
                    continue
                action, name = kind
                s = all_specs[name]
                if action == "__activate__":
                    part = realize_multi_component(cfg, sim, s, a, seed_val)
                    if s.representation == "particles":
                        state = state._replace(particles={**state.particles, name: part})
                    else:
                        state = state._replace(fluids={**state.fluids, name: part})
                else:
                    masterprint(f"Terminating component {name} at a = {a:.4g}")
                    state = MultiState(
                        particles={k: v for k, v in state.particles.items() if k != name},
                        fluids={k: v for k, v in state.fluids.items() if k != name})
            t_dump += _time.time() - t0
            trap.exit_if_signalled(lambda: autosave(state, a, events, hysteresis), agree)
    if rank0:
        clear_autosave(cfg)
    sim.stats["rank_peak_bytes"] = _rank_peaks(dev, dist)
    if dist is not None:
        state = sim.whole(state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    step_total = sim.hysteresis.get("step_count", 0)
    wall = _time.time() - t_wall0
    if step_total:
        masterprint(
            f"Time-step summary: {step_total} steps, {t_evolve:.1f} s evolution "
            f"({1e3 * t_evolve / step_total:.0f} ms/step), {t_dump:.1f} s output")
    masterprint(f"Simulation complete: a = {a:.6g}, wall time {wall:.1f} s")
    sim.timings = {"realize_s": t_realize, "evolve_s": t_evolve, "dump_s": t_dump}
    return sim, state, a


def _sel_on(val) -> bool:
    """A powerspec_select value → on or off (a dict: its 'data' flag)."""
    if isinstance(val, dict):
        return bool(val.get("data", True))
    return bool(val)


def dump_multi(cfg: RunConfig, sim, state, a, kind, units, lin):
    """Write one scheduled output of a run of several components (port
    of concept_tpu/run.py:977-1188): 'powerspec' (each particle
    component, each selected pair of components and each fluid's δ),
    'bispec' (each particle component, with its plot), 'snapshot'
    (CONCEPT-HDF5 of every component), 'render2D' (each particle
    component) or 'render3D' (the particle components blended).  Over
    ranks every rank calls it: the spectra are measured over the ranks
    (each component's shard and each fluid's rows), the other outputs
    from the whole state, which rank 0 alone receives, and rank 0
    writes."""
    base = cfg.output_bases.get(kind, kind)
    dirname = cfg.output_dirs.get(kind, "output")
    tag = f"a={a:.4g}"
    if kind == "powerspec":
        _dump_powerspec_multi(cfg, sim, state, a, base, dirname, tag, units)
        return
    if sim.dist is not None:
        state = sim.whole(state, root=0)
        if sim.dist.rank:
            return
    if kind == "bispec":
        for name, pstate in state.particles.items():
            _dump_bispec(cfg, sim, pstate, a, os.path.join(dirname, f"{base}_{name}_{tag}.txt"),
                         lin, spec=sim.pspecs[name])
    elif kind == "snapshot":
        from concept_tpu_torch.io import snapshot as snap

        fn = os.path.join(dirname, f"{base}_{tag}.hdf5")
        comps = {name: (sim.pspecs[name], ps) for name, ps in state.particles.items()}
        comps.update({name: (sim.fspecs[name], fs) for name, fs in state.fluids.items()})
        snap.save_concept(fn, _snapshot_meta(cfg, a), comps,
                          select=(cfg.snapshot_select or {}).get("save"))
        masterprint(f"Saved snapshot: {fn}")
    elif kind == "render2D":
        from concept_tpu_torch.graphics.render import render2D

        n = sim.config.potential_gridsize
        for name, pstate in state.particles.items():
            flags = _output_flags(sim.pspecs[name], cfg.render2D_select,
                                  ("data", "image", "terminal image"), "image")
            if not any(flags.values()):
                continue
            fn = os.path.join(dirname, f"{base}_{name}_{tag}.png")
            os.makedirs(dirname, exist_ok=True)
            render2D(pstate.pos, n, cfg.boxsize, filename=fn if flags["image"] else None,
                     terminal=flags["terminal image"], save_data=flags["data"],
                     data_filename=fn.replace(".png", ".hdf5"))
            masterprint(f"Saved render2D ({name}): {fn}")
    elif kind == "render3D":
        from concept_tpu_torch.graphics.render import render3D

        opts = cfg.render3D_options or {}
        fn = os.path.join(dirname, f"{base}_{tag}.png")
        # particle components blended with distinct colormaps (reference
        # multi-component render3D declarations, graphics.py:2230-2248)
        cmaps = ("inferno", "viridis", "cividis", "plasma")
        comps = {name: (pstate.pos, cmaps[i % len(cmaps)])
                 for i, (name, pstate) in enumerate(state.particles.items())
                 if _output_flags(sim.pspecs[name], cfg.render3D_select, ("image",),
                                  "image")["image"]}
        if comps:
            render3D(None, cfg.boxsize, fn, components=comps,
                     resolution=int(opts.get("resolution", 1080)),
                     background=opts.get("background", "black"), label=f"a = {a:.4g}")
            masterprint(f"Saved render3D: {fn}")
    else:
        raise ValueError(f"unknown output kind {kind!r}")


def _dump_powerspec_multi(cfg, sim, state, a, base, dirname, tag, units):
    import itertools

    from concept_tpu_torch.analysis.output import save_powerspec_txt
    from concept_tpu_torch.analysis.powerspec import (
        combined_powerspec, combined_shotnoise, grid_powerspec, powerspec, powerspec_sigma,
    )

    opts = cfg.powerspec_options or {}
    gridsize = int(opts.get("gridsize") or sim.config.potential_gridsize)
    R = float(opts.get("tophat", 8 / cfg.h * units.Mpc))
    dist = sim.dist

    def save(fn, pk, what):
        if dist is not None and dist.rank:
            return
        save_powerspec_txt(fn, pk, a, cfg.boxsize, cfg.unit_length,
                           powerspec_sigma(pk["k"], pk.get("power_corrected", pk["power"]), R),
                           R)
        masterprint(f"Saved {what}: {fn}")

    for name, pstate in state.particles.items():
        spec = sim.pspecs[name]
        if _sel_on(is_selected(spec, cfg.powerspec_select, default=True)):
            pk = powerspec(pstate.pos, gridsize, cfg.boxsize, spec.N,
                           bins_per_decade=_bpd(opts), k_max=opts.get("k_max"), dist=dist)
            save(os.path.join(dirname, f"{base}_{name}_{tag}.txt"), pk,
                 f"power spectrum ({name})")
    # the spectra of selected pairs of components (reference
    # powerspec_select set keys / 'all combinations'): one mass-weighted
    # field of the pair
    all_specs = {**sim.pspecs, **sim.fspecs}
    for na, nb in itertools.combinations(list(all_specs), 2):
        if not _sel_on(is_selected((all_specs[na], all_specs[nb]), cfg.powerspec_select,
                                   default=False)):
            continue
        p_names = [nm for nm in (na, nb) if nm in state.particles]
        f_names = [nm for nm in (na, nb) if nm in state.fluids]
        shot = None
        if p_names and not f_names:
            shot = combined_shotnoise([sim.pspecs[nm].mass for nm in p_names],
                                      [sim.pspecs[nm].N for nm in p_names], cfg.boxsize)
        pk = combined_powerspec(
            [state.particles[nm].pos for nm in p_names],
            [float(sim.pspecs[nm].mass) for nm in p_names],
            [state.fluids[nm].varrho for nm in f_names], gridsize, cfg.boxsize,
            order=int(opts.get("interpolation", 4)),
            interlace=bool(opts.get("interlace", True)), bins_per_decade=_bpd(opts),
            k_max=opts.get("k_max"), shotnoise=shot, dist=dist)
        save(os.path.join(dirname, f"{base}_{na}+{nb}_{tag}.txt"), pk,
             f"combined power spectrum ({na}+{nb})")
    for name, f in state.fluids.items():
        if _sel_on(is_selected(sim.fspecs[name], cfg.powerspec_select, default=True)):
            if dist is None:
                mean = f.varrho.mean()
            else:
                mean = sim.reduce(f.varrho.sum()) / f.varrho.shape[-1] ** 3
            pk = grid_powerspec(f.varrho / mean - 1.0, cfg.boxsize, dist=dist)
            save(os.path.join(dirname, f"{base}_{name}_{tag}.txt"), pk,
                 f"fluid power spectrum ({name})")


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
    """Write one scheduled output: 'powerspec' (with its plot),
    'bispec', 'snapshot', 'render2D' or 'render3D'.  Over ranks every
    rank calls it: the spectrum is measured over the ranks, the other
    outputs from the whole state, which rank 0 alone receives, and rank 0
    writes."""
    base = cfg.output_bases.get(kind, kind)
    dirname = cfg.output_dirs.get(kind, "output")
    tag = f"a={a:.4g}" if cfg.enable_Hubble else f"t={a:.4g}"
    dist = getattr(sim, "dist", None)
    if kind == "powerspec":
        _dump_powerspec(cfg, sim, state, a, os.path.join(dirname, f"{base}_{tag}.txt"),
                        units, lin)
        return
    if dist is not None:
        state = sim.whole(state, root=0)
        if dist.rank:
            return
    if kind == "bispec":
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
    elif kind == "render2D":
        from concept_tpu_torch.graphics.render import render2D

        flags = _output_flags(sim.spec, cfg.render2D_select,
                              ("data", "image", "terminal image"), "image")
        opts = cfg.render2D_options or {}
        terminal = flags["terminal image"] or bool(
            opts.get("terminal image", opts.get("terminal", False)))
        save_data = flags["data"] or bool(opts.get("data", False))
        if not (flags["image"] or terminal or save_data):
            return
        gridsize = int(opts.get("gridsize") or sim.config.potential_gridsize)
        fn = os.path.join(dirname, f"{base}_{tag}.png")
        render2D(state.pos, gridsize, cfg.boxsize,
                 filename=fn if flags["image"] else None,
                 axis={"x": 0, "y": 1, "z": 2}.get(opts.get("axis", "z"), 2),
                 colormap=opts.get("colormap", "inferno"), terminal=terminal,
                 terminal_resolution=int(opts.get("terminal resolution", 80)),
                 save_data=save_data, data_filename=fn.replace(".png", ".hdf5"),
                 extent=opts.get("extent"), enhancement=bool(opts.get("enhancement", True)))
        masterprint(f"Saved render2D: {fn}")
    elif kind == "render3D":
        from concept_tpu_torch.graphics.render import render3D

        if not _output_flags(sim.spec, cfg.render3D_select, ("image",), "image")["image"]:
            return
        opts = cfg.render3D_options or {}
        fn = os.path.join(dirname, f"{base}_{tag}.png")
        enh = opts.get("enhancement", 0.15)
        render3D(state.pos, cfg.boxsize, fn,
                 resolution=int(opts.get("resolution", 1080)),
                 elevation=float(opts.get("elevation", 20.0)),
                 azimuth=float(opts.get("azimuth", -60.0)), roll=float(opts.get("roll", 0.0)),
                 zoom=float(opts.get("zoom", 1.0)),
                 projection=str(opts.get("projection", "persp")), color=opts.get("color"),
                 colormap=opts.get("colormap", "inferno"),
                 background=opts.get("background", "black"),
                 depthshade=bool(opts.get("depthshade", True)),
                 enhance_target=float((enh or {}).get("brightness", 0.15)
                                      if isinstance(enh, dict) else enh),
                 label=f"a = {a:.4g}")
        masterprint(f"Saved render3D: {fn}")
    else:
        raise ValueError(f"unknown output kind {kind!r}")


def _dump_powerspec(cfg, sim, state, a, fn, units, lin):
    from concept_tpu_torch.analysis.output import save_powerspec_txt
    from concept_tpu_torch.analysis.powerspec import powerspec, powerspec_sigma

    opts = cfg.powerspec_options or {}
    gridsize = int(opts.get("gridsize") or sim.config.potential_gridsize)
    dist = getattr(sim, "dist", None)
    pk = powerspec(
        state.pos, gridsize, cfg.boxsize, sim.spec.N,
        order=opts.get("interpolation", 4),
        interlace=bool(opts.get("interlace", True)),
        bins_per_decade=_bpd(opts), k_max=opts.get("k_max"), dist=dist,
    )
    if dist is not None and dist.rank:
        return
    lin_col = np.asarray(lin.power_delta(pk["k"], a)) if lin is not None else None
    R = float(opts.get("tophat", 8 / cfg.h * units.Mpc))
    sigma = powerspec_sigma(pk["k"], pk["power_corrected"], R)
    sigma_lin = lin.sigma_R(R, a) if lin is not None else None
    save_powerspec_txt(fn, pk, a, cfg.boxsize, cfg.unit_length, sigma, R,
                       lin_col, sigma_linear=sigma_lin,
                       significant_figures=int(opts.get("significant figures", 18)))
    masterprint(f"Saved power spectrum: {fn}")
    if opts.get("plot", False):
        from concept_tpu_torch.graphics.render import plot_powerspec

        plot_powerspec(pk, fn.replace(".txt", ".png"), linear=lin_col, a=a)


def _dump_bispec(cfg, sim, state, a, fn, lin, spec=None):
    """The bispectrum's columns, and its plot where selected (the JAX
    package's single-component dump plots B whatever
    ``bispec_plot_prefer`` says; the port honours it in both runs)."""
    from concept_tpu_torch.analysis.bispec import bispec, bispec_treelevel

    flags = _output_flags(spec or sim.spec, cfg.bispec_select,
                          ("data", "reduced", "treelevel", "plot"), "data")
    opts = cfg.bispec_options or {}
    if not (flags["data"] or flags["plot"]):
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
    tree = None
    if lin is not None and flags["treelevel"]:
        tree = bispec_treelevel(lin, out["triangles"], a)
        cols.append(tree[:, None])
        header += " B_treelevel"
    os.makedirs(os.path.dirname(os.path.abspath(fn)), exist_ok=True)
    np.savetxt(fn, np.column_stack(cols), header=header)
    masterprint(f"Saved bispectrum: {fn}")
    if flags["plot"] or opts.get("plot", False):
        from concept_tpu_torch.graphics.render import plot_bispec

        plot_bispec(out, fn.replace(".txt", ".png"), treelevel=tree, a=a,
                    prefer=cfg.bispec_plot_prefer)
