"""Parameter system: executable-Python parameter files.

TPU-native counterpart of reference src/commons.py:1757-2045 (Param class,
double exec with units in scope), type coercion (commons.py:3493),
component selectors with 'all'/tuples/ellipsis (commons.py:2142, 2983),
and inferred parameters (commons.py:4358-4430).

A parameter file is ordinary Python executed with the unit system,
constants, numpy and a `param` magic object in scope.  It is executed
twice: the first pass resolves H0 so that `h` (= H0/(100 km/s/Mpc)) is
available in the second pass (the reference does the same to support
`Mpc/h` literals).  The result is canonicalized into a RunConfig.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np

from concept_tpu_torch.units import UnitSystem


_OUTPUT_KINDS = ("snapshot", "powerspec", "bispec", "render2D", "render3D", "autosave")


@dataclass
class RunConfig:
    """Canonicalized run configuration (everything downstream needs)."""

    # cosmology
    H0: float = 0.0
    Omega_b: float = 0.049
    Omega_cdm: float = 0.27
    a_begin: float = 0.02
    t_begin: float | None = None
    primordial: dict = field(default_factory=lambda: dict(A_s=2.1e-9, n_s=0.96, alpha_s=0.0, pivot=None))
    enable_Hubble: bool = True
    enable_class_background: bool = False
    class_params: dict = field(default_factory=dict)
    # linear Boltzmann backend: 'auto' | 'eb' | 'class' | 'eh'
    boltzmann_backend: str = "auto"
    boltzmann_options: dict = field(default_factory=dict)
    # numerics
    boxsize: float = 0.0
    potential_options: dict = field(default_factory=dict)
    shortrange_params: dict = field(default_factory=dict)
    powerspec_options: dict = field(default_factory=dict)
    powerspec_select: dict = field(default_factory=lambda: {"all": True})
    bispec_options: dict = field(default_factory=dict)
    bispec_select: dict = field(default_factory=lambda: {"all": True})
    render2D_select: dict = field(default_factory=lambda: {"all": True})
    render3D_select: dict = field(default_factory=lambda: {"all": True})
    ewald_gridsize: int = 64
    # input/output
    initial_conditions: object = None
    output_dirs: dict = field(default_factory=dict)
    output_bases: dict = field(default_factory=dict)
    output_times: dict = field(default_factory=dict)
    autosave_interval: float = float("inf")
    snapshot_type: str = "concept"
    snapshot_select: dict = field(default_factory=dict)
    snapshot_wrap: bool = False
    gadget_snapshot_params: dict = field(default_factory=dict)
    select_particle_id: dict = field(default_factory=dict)
    life_output_order: tuple = ("terminate", "activate", "dump")
    # physics
    select_forces: dict = field(default_factory=dict)
    select_softening_length: dict = field(default_factory=dict)
    select_eos_w: dict = field(default_factory=dict)
    select_boltzmann_order: dict = field(default_factory=dict)
    select_boltzmann_closure: dict = field(default_factory=dict)
    realization_options: dict = field(default_factory=dict)
    select_lives: dict = field(default_factory=dict)
    select_approximations: dict = field(default_factory=dict)
    softening_kernel: str = "spline"
    # simulation
    N_rungs: int = 8
    Delta_a_max_early: float = 0.00153
    Delta_a_max_late: float = 0.022
    Delta_t_base_background_factor: float = 1.0
    Delta_t_base_nonlinear_factor: float = 1.0
    Delta_t_rung_factor: float = 1.0
    static_timestepping: object = None
    random_seeds: dict = field(default_factory=lambda: dict({"primordial amplitudes": 0, "primordial phases": 0}))
    primordial_amplitude_fixed: bool = False
    primordial_phase_shift: float = 0.0
    primordial_noise_imprinting: str = "simple"
    cell_centered: bool = True
    fluid_scheme_select: dict = field(default_factory=lambda: {"all": "kurganovtadmor"})
    fluid_options: dict = field(default_factory=dict)
    # graphics / debugging
    render2D_options: dict = field(default_factory=dict)
    render3D_options: dict = field(default_factory=dict)
    terminal_width: int = 80
    suppress_output: set = field(default_factory=set)
    print_load_imbalance: bool = True
    enable_terminal_formatting: bool = True
    bispec_antialiasing: bool = True
    bispec_plot_prefer: str = "bispec"   # or 'reduced'
    # float64 end-to-end (the reference is f64 throughout; here f32 is
    # the TPU performance default and f64 the validation tier)
    enable_float64: bool = False
    # units
    unit_length: str = "Mpc"
    unit_time: str = "Gyr"
    unit_mass: str = "10**10 m_sun"
    # bookkeeping
    param_name: str = "params"
    param_path: str | None = None
    units: UnitSystem | None = None

    @property
    def Omega_m(self) -> float:
        return self.Omega_b + self.Omega_cdm

    @property
    def h(self) -> float:
        u = self.units or UnitSystem(self.unit_length, self.unit_time, self.unit_mass)
        return self.H0 / (100 * u.km / (u.s * u.Mpc))


def _exec_namespace(units: UnitSystem, h: float, param_name: str, param_path: str | None):
    ns = dict(units.namespace())
    ns.update(
        np=np,
        numpy=np,
        math=math,
        pi=math.pi,
        h=h,
        param=SimpleNamespace(
            name=param_name,
            path=param_path,
            dir=os.path.dirname(param_path) if param_path else os.getcwd(),
        ),
        path=SimpleNamespace(
            output_dir="output",
            ic_dir="ic",
        ),
        # Graceful builtins subset
        __builtins__=__builtins__,
    )
    return ns


def load_params(
    path: str | None = None,
    overrides: list[str] | str = (),
    text: str | None = None,
) -> RunConfig:
    """Execute a parameter file (and -c override snippets) → RunConfig.

    Reference behavior: param file is Python exec'd twice with units in
    scope (commons.py:1921-2045); `-c` snippets run after the file
    (concept CLI option -c, concept:1040-1315).
    """
    if text is None and path is not None:
        with open(path) as f:
            text = f.read()
    text = text or ""
    if isinstance(overrides, str):
        overrides = [overrides]
    override_text = "\n".join(overrides)
    param_name = os.path.splitext(os.path.basename(path))[0] if path else "params"

    # pass 1: default units, h placeholder from default H0.  Tolerant:
    # parameter files may reference later-defined names (the reference
    # execs files twice with prior names in scope, commons.py:1757-2045),
    # so statements raising NameError are skipped on the first pass.
    units1 = UnitSystem()
    raw = _exec_pass(text, override_text, units1, h=0.67,
                     param_name=param_name, param_path=path, tolerant=True)
    # units from pass 1
    units2 = UnitSystem(
        str(raw.get("unit_length", "Mpc")),
        str(raw.get("unit_time", "Gyr")),
        str(raw.get("unit_mass", "10**10 m_sun")),
    )
    H0_1 = raw.get("H0", 67 * units2.km / (units2.s * units2.Mpc))
    h_1 = H0_1 / (100 * units2.km / (units2.s * units2.Mpc))
    # pass 2: correct h/units in scope + pass-1 names preseeded (forward
    # references like output_times = {...: [a_begin, 1]} now resolve)
    raw = _exec_pass(text, override_text, units2, h=h_1,
                     param_name=param_name, param_path=path, preseed=raw)
    return canonicalize(raw, units2, param_name, path)


def _exec_pass(text, override_text, units, h, param_name, param_path,
               tolerant=False, preseed=None):
    import ast

    ns = _exec_namespace(units, h, param_name, param_path)
    base = set(ns)
    if preseed:
        ns.update(preseed)
    filename = param_path or "<params>"
    if tolerant:
        tree = ast.parse(text, filename)
        for node in tree.body:
            mod = ast.Module(body=[node], type_ignores=[])
            try:
                exec(compile(mod, filename, "exec"), ns)  # noqa: S102
            except NameError:
                continue
    else:
        exec(compile(text, filename, "exec"), ns)  # noqa: S102
    if override_text:
        exec(compile(override_text, "<command-line>", "exec"), ns)  # noqa: S102
    return {k: v for k, v in ns.items() if k not in base and not k.startswith("_")}


# Reference parameters that are deliberately NOT supported — setting one
# warns with the reason instead of silently ignoring it (VERDICT r2
# item 10: document descopes, no silently-dead config).
DESCOPED_PARAMS = {
    "random_generator": "noise is counter-based and mode-indexed by design"
        " (device-count- and gridsize-invariant); there is no stream RNG"
        " to select",
    "fourier_structure_caching": "realization noise is recomputed (cheap"
        " counter-based kernel); no noise cache exists",
    "particle_reordering": "particles are deterministically re-sorted"
        " into the persistent cell layout every rebucketize by design",
    "fftw_wisdom_rigor": "XLA compiles the FFT; there is no FFTW wisdom",
    "fftw_wisdom_reuse": "XLA compiles the FFT; there is no FFTW wisdom",
    "fftw_wisdom_share": "XLA compiles the FFT; there is no FFTW wisdom",
    "enable_warm_dark_matter": "WDM needs a patched-CLASS backend; use"
        " boltzmann_backend='class' with your own class_params instead",
    "allow_snapshot_multifile_singleload": "multi-file GADGET sets are"
        " always loaded whole (single-controller I/O)",
    "enable_debugging": "use --pure-python (eager mode) and the test"
        " suite's debug helpers instead",
    "class_extra_background": "extra CLASS columns need the classy"
        " pipeline; use `-u class` to dump the processed tables instead",
    "class_extra_perturbations": "extra CLASS columns need the classy"
        " pipeline; use `-u class` to dump the processed tables instead",
    "class_plot_perturbations": "use `-u class` to dump the tables and"
        " plot them yourself",
}


def canonicalize(raw: dict, units: UnitSystem, param_name: str, param_path) -> RunConfig:
    from concept_tpu_torch.utils.terminal import masterwarn

    for key in sorted(set(raw) & set(DESCOPED_PARAMS)):
        masterwarn(
            f"parameter {key!r} is not supported in concept_tpu_torch and has "
            f"no effect: {DESCOPED_PARAMS[key]}"
        )
    cfg = RunConfig(param_name=param_name, param_path=param_path, units=units)
    cfg.unit_length = str(raw.get("unit_length", "Mpc"))
    cfg.unit_time = str(raw.get("unit_time", "Gyr"))
    cfg.unit_mass = str(raw.get("unit_mass", "10**10 m_sun"))
    # cosmology
    cfg.H0 = float(raw.get("H0", 67 * units.km / (units.s * units.Mpc)))
    cfg.Omega_b = float(raw.get("Ωb", raw.get("Omega_b", 0.049)))
    cfg.Omega_cdm = float(raw.get("Ωcdm", raw.get("Omega_cdm", 0.27)))
    cfg.a_begin = float(raw.get("a_begin", 1.0))
    cfg.t_begin = raw.get("t_begin")
    prim = dict(A_s=2.1e-9, n_s=0.96, alpha_s=0.0, pivot=0.05 / units.Mpc)
    user_prim = raw.get("primordial_spectrum", {})
    for key, val in user_prim.items():
        key = {"α_s": "alpha_s", "alpha_s": "alpha_s", "A_s": "A_s", "n_s": "n_s", "pivot": "pivot"}.get(key, key)
        prim[key] = val
    cfg.primordial = prim
    cfg.enable_Hubble = bool(raw.get("enable_Hubble", True))
    cfg.enable_class_background = bool(raw.get("enable_class_background", False))
    cfg.class_params = dict(raw.get("class_params", {}))
    cfg.boltzmann_backend = str(raw.get("boltzmann_backend", "auto"))
    if cfg.boltzmann_backend not in ("auto", "eb", "class", "eh"):
        raise ValueError(
            f"boltzmann_backend must be auto/eb/class/eh, "
            f"got {cfg.boltzmann_backend!r}"
        )
    cfg.boltzmann_options = dict(raw.get("boltzmann_options", {}))
    # reference-name aliases so reference parameter files port cleanly
    # (class_modes_per_decade, class_k_max, class_reuse —
    # param/example_explanatory:289-293, 429-431)
    if "class_modes_per_decade" in raw:
        mpd = raw["class_modes_per_decade"]
        if isinstance(mpd, dict):  # reference k-dependent dict: use max
            mpd = max(mpd.values())
        cfg.boltzmann_options.setdefault("modes_per_decade", int(mpd))
    if "class_k_max" in raw:
        cfg.boltzmann_options.setdefault("k_max", float(raw["class_k_max"]))
    if "class_reuse" in raw and not bool(raw["class_reuse"]):
        cfg.boltzmann_options.setdefault("cache_dir", "")
    # numerics
    cfg.boxsize = float(raw.get("boxsize", 512 * units.Mpc))
    cfg.potential_options = canonicalize_potential_options(
        raw.get("potential_options", {}), cfg
    )
    cfg.shortrange_params = raw.get("shortrange_params", {})
    cfg.powerspec_options = raw.get("powerspec_options", {}) if isinstance(raw.get("powerspec_options", {}), dict) else {"gridsize": raw.get("powerspec_options")}
    cfg.powerspec_select = raw.get("powerspec_select", {"all": True})
    cfg.bispec_options = raw.get("bispec_options", {})
    cfg.bispec_select = raw.get("bispec_select", {"all": True})
    cfg.render2D_select = raw.get("render2D_select", {"all": True})
    cfg.render3D_select = raw.get("render3D_select", {"all": True})
    cfg.ewald_gridsize = int(raw.get("ewald_gridsize", 64))
    # io
    cfg.initial_conditions = raw.get("initial_conditions")
    od = raw.get("output_dirs", "output")
    if isinstance(od, str):
        od = {kind: od for kind in _OUTPUT_KINDS}
    else:
        od = _expand_ellipsis_dict(od, _OUTPUT_KINDS)
    cfg.output_dirs = od
    ob = raw.get("output_bases", {})
    cfg.output_bases = {k: ob.get(k, k) for k in _OUTPUT_KINDS} if isinstance(ob, dict) else {k: ob for k in _OUTPUT_KINDS}
    cfg.output_times = canonicalize_output_times(raw.get("output_times", {}))
    cfg.autosave_interval = float(raw.get("autosave_interval", float("inf")))
    cfg.snapshot_type = str(raw.get("snapshot_type", "concept"))
    cfg.snapshot_select = raw.get("snapshot_select", {})
    cfg.snapshot_wrap = bool(raw.get("snapshot_wrap", False))
    cfg.gadget_snapshot_params = raw.get("gadget_snapshot_params", {})
    cfg.select_particle_id = raw.get("select_particle_id", {})
    cfg.life_output_order = _canonicalize_life_output_order(
        raw.get("life_output_order", ()))
    # physics
    cfg.select_forces = raw.get(
        "select_forces", {"all": {"gravity": "p3m"}}
    )
    cfg.select_softening_length = raw.get(
        "select_softening_length", {"particles": "0.025*boxsize/cbrt(N)"}
    )
    cfg.select_eos_w = raw.get("select_eos_w", {})
    cfg.select_boltzmann_order = raw.get("select_boltzmann_order", {})
    cfg.select_boltzmann_closure = raw.get("select_boltzmann_closure", {})
    cfg.realization_options = raw.get("realization_options", {})
    cfg.select_lives = raw.get("select_lives", {})
    cfg.select_approximations = raw.get("select_approximations", {})
    cfg.softening_kernel = raw.get("softening_kernel", "spline")
    # simulation
    cfg.N_rungs = int(raw.get("N_rungs", 8))
    cfg.Delta_t_base_background_factor = float(raw.get("Δt_base_background_factor", raw.get("Delta_t_base_background_factor", 1)))
    cfg.Delta_t_base_nonlinear_factor = float(raw.get("Δt_base_nonlinear_factor", raw.get("Delta_t_base_nonlinear_factor", 1)))
    cfg.Delta_t_rung_factor = float(raw.get("Δt_rung_factor", raw.get("Delta_t_rung_factor", 1)))
    cfg.Delta_a_max_early = float(raw.get("Δa_max_early", raw.get("Delta_a_max_early", 0.00153)))
    cfg.Delta_a_max_late = float(raw.get("Δa_max_late", raw.get("Delta_a_max_late", 0.022)))
    cfg.static_timestepping = raw.get("static_timestepping")
    cfg.random_seeds = raw.get("random_seeds", {"primordial amplitudes": 0, "primordial phases": 0})
    cfg.primordial_amplitude_fixed = bool(raw.get("primordial_amplitude_fixed", False))
    cfg.primordial_phase_shift = float(raw.get("primordial_phase_shift", 0.0))
    cfg.primordial_noise_imprinting = str(raw.get("primordial_noise_imprinting", "simple"))
    cfg.cell_centered = bool(raw.get("cell_centered", True))
    cfg.fluid_scheme_select = raw.get("fluid_scheme_select", {"all": "kurganovtadmor"})
    cfg.fluid_options = raw.get("fluid_options", {})
    # graphics / debugging
    cfg.render2D_options = raw.get("render2D_options", {})
    cfg.render3D_options = raw.get("render3D_options", {})
    cfg.terminal_width = int(raw.get("terminal_width", 80))
    # suppress_output: set of regexes, or {'out': {...}, 'err': {...}}
    # (reference commons.py:935: matching lines are swallowed)
    sup = raw.get("suppress_output", set())
    if isinstance(sup, dict):
        flat = set()
        for v in sup.values():
            flat |= set(v if isinstance(v, (set, list, tuple)) else [v])
        sup = flat
    elif isinstance(sup, str):
        sup = {sup}
    cfg.suppress_output = set(sup)
    cfg.print_load_imbalance = bool(raw.get("print_load_imbalance", True))
    cfg.enable_terminal_formatting = bool(raw.get("enable_terminal_formatting", True))
    cfg.bispec_antialiasing = bool(raw.get("bispec_antialiasing", True))
    cfg.bispec_plot_prefer = str(raw.get("bispec_plot_prefer", "bispec"))
    cfg.enable_float64 = bool(raw.get("enable_float64", False))
    return cfg


def _canonicalize_life_output_order(value) -> tuple:
    """Normalize life_output_order exactly as the reference does
    (commons.py:2912-2929): case-insensitive prefixes term/deact →
    'terminate', act → 'activate', dump/out → 'dump'; missing actions
    appended in the default order ('terminate', 'activate', 'dump');
    anything else is an error."""
    order = []
    for act in value or ():
        act = str(act).lower()
        if act.startswith(("term", "deact")):
            act = "terminate"
        elif act.startswith("act"):
            act = "activate"
        elif act.startswith(("dump", "out")):
            act = "dump"
        order.append(act)
    for act in ("terminate", "activate", "dump"):
        if act not in order:
            order.append(act)
    if set(order) != {"terminate", "activate", "dump"} or len(order) != 3:
        raise ValueError(f"life_output_order = {tuple(value)} not understood")
    return tuple(order)


def canonicalize_potential_options(value, cfg: RunConfig) -> dict:
    """potential_options may be an int (the global grid size), or a dict
    (reference param/example_explanatory:163-208).  Canonical form:
    {'gridsize': int, 'gridsize_per_method': {'pm': int, 'p3m': int},
    'interpolation': order, 'deconvolve': (bool,bool),
    'interlace': (bool,bool), 'differentiation': order}.

    Per-method grid sizes (reference 'gridsize': {'global': {'gravity':
    {'pm': n1, 'p3m': n2}}}) are preserved so the PM potential of a
    mixed run and the P³M long-range mesh can differ (reference
    multigrid semantics, mesh.py:808/1018)."""
    out = dict(
        gridsize=None,
        gridsize_per_method={},
        interpolation=2,
        deconvolve=(True, True),
        interlace=False,
        differentiation="fourier",
    )
    if isinstance(value, (int, float)) and value:
        out["gridsize"] = int(value)
    elif isinstance(value, dict):
        gs = value.get("gridsize", None)
        if isinstance(gs, dict):
            # walk nested dicts collecting per-method sizes
            per_method = {}

            def walk(d):
                for k, v in d.items():
                    if isinstance(v, dict):
                        walk(v)
                    elif isinstance(v, (int, float)) and str(k) in (
                        "pm", "p3m", "pp", "ppnonperiodic"
                    ):
                        per_method[str(k)] = int(v)
            walk(gs)
            out["gridsize_per_method"] = per_method
            ints = [v for v in _flatten(gs) if isinstance(v, (int, float))]
            out["gridsize"] = int(max(ints)) if ints else None
        elif gs is not None:
            out["gridsize"] = int(gs)
        for key in ("interpolation", "deconvolve", "interlace", "differentiation"):
            if key in value:
                out[key] = value[key]
    return out


def canonicalize_output_times(value) -> dict:
    """→ {'a': {kind: sorted tuple}, 't': {kind: sorted tuple}}.

    Accepts the reference's flexible forms: plain {kind: times} means
    a-times (reference param/example_explanatory:40-56)."""
    out = {"a": {}, "t": {}}
    if not isinstance(value, dict):
        return out
    if "a" in value or "t" in value:
        for basis in ("a", "t"):
            for kind, times in (value.get(basis) or {}).items():
                out[basis][kind] = _astuple(times)
    else:
        for kind, times in value.items():
            out["a"][kind] = _astuple(times)
    return out


def _astuple(times):
    if times is None:
        return ()
    if isinstance(times, (int, float)):
        return (float(times),)
    return tuple(sorted(float(t) for t in times))


def _expand_ellipsis_dict(d: dict, keys) -> dict:
    """{'snapshot': x, 'powerspec': ...} — ellipsis repeats the previous
    value (reference ellipsis expansion, commons.py:2142)."""
    out = {}
    last = None
    for k in keys:
        if k in d:
            v = d[k]
            if v is Ellipsis:
                v = last
            out[k] = v
            last = v
    for k in keys:
        out.setdefault(k, last if last is not None else "output")
    return out


def _flatten(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _flatten(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _flatten(v)
    else:
        yield obj


# --------------------------------------------------------------------- #
# Component selector matching (reference commons.py:2983 canonicalization,
# is_selected semantics used throughout)
# --------------------------------------------------------------------- #
def is_selected(spec, selector: dict, default=None):
    """Match a ComponentSpec (or a SEQUENCE of them) against a selector
    dict — reference commons.py:5471 is_selected semantics:

    Single component: keys matched with precedence (higher wins)
      'default' < 'all' < representation < species part < species < name,
    case-insensitively; a str key that matches nothing directly is tried
    as a full regular-expression match against each attribute.

    Component combination (tuple/list of specs): keys that are
    tuples/sets are matched as SETS of names/species/representations
    covering exactly the given components; 'all combinations' is the
    wildcard (reference powerspec_select pair keys etc.)."""
    if not isinstance(selector, dict):
        return selector
    import re

    if isinstance(spec, (tuple, list)):
        specs = list(spec)
        attr_sets = []
        for attr in ("name", "species", "representation"):
            vals = {str(getattr(s, attr, "") or "").lower() for s in specs}
            attr_sets.append(vals)
        best = None  # (precedence, value)
        for key, val in selector.items():
            if isinstance(key, (tuple, list, set, frozenset)):
                kset = {str(k).lower() for k in key}
                for prec, vals in ((4, attr_sets[0]), (3, attr_sets[1]),
                                   (2, attr_sets[2])):
                    if kset == vals and (best is None or prec > best[0]):
                        best = (prec, val)
            elif str(key).lower() == "all combinations":
                if best is None or 1 > best[0]:
                    best = (1, val)
            elif str(key).lower() == "default":
                if best is None or 0 > best[0]:
                    best = (0, val)
        return best[1] if best is not None else default

    name = str(spec.name or "").lower()
    species = str(spec.species or "").lower()
    parts = [p.strip() for p in species.split("+")]
    rep = str(getattr(spec, "representation", "") or "").lower()
    # precedence: higher index wins
    ladder = (["default", "all", rep] + ([] if len(parts) < 2 else parts)
              + [species, name])
    best = None
    for key, val in selector.items():
        if isinstance(key, (tuple, list, set, frozenset)):
            kl = {str(k).lower() for k in key}
            # any-of shorthand for single components (established usage)
            if name in kl or species in kl:
                prec = ladder.index(name) if name in kl else ladder.index(species)
                if best is None or prec > best[0]:
                    best = (prec, val)
            continue
        k = str(key).lower()
        prec = None
        if k in ladder:
            prec = len(ladder) - 1 - ladder[::-1].index(k)  # last occurrence
        else:
            # regex fallback (reference: full-string match per attribute)
            try:
                pat = re.compile(k)
            except re.error:
                continue
            for i, attr in enumerate(ladder[2:], start=2):
                if attr and pat.fullmatch(attr):
                    prec = i
                    break
        if prec is not None and (best is None or prec > best[0]):
            best = (prec, val)
    return best[1] if best is not None else default
