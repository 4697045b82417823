"""Linear Boltzmann backend selection and table construction (port of
concept_tpu/cosmology/backend.py).

The reference always sources its linear layer from embedded CLASS
(commons.py:4647 call_class; linear.py:56-1480 CosmoResults).  Here the
backend is pluggable, selected by the ``boltzmann_backend`` parameter:

  'class'  classy (CLASS python wrapper) via cosmology/class_bridge.py,
           when importable;
  'eb'     the internal Einstein-Boltzmann solver
           (cosmology/ebsolver.py) — full synchronous-gauge hierarchy
           integration, disk-cached like the reference's
           .reusable/class HDF5 (commons.py:5593);
  'eh'     analytic Eisenstein-Hu transfer (no tables; LinearCosmology
           falls back to its closed-form path);
  'auto'   'class' if classy is importable, else 'eb' whenever the run
           involves physics that needs species-resolved transfer
           functions (massive ν, photon/ur fluids, metric/lapse GR
           corrections, boltzmann_order ≥ 1 fluids), else 'eh'.

Tables are built per unit primordial curvature ζ in synchronous gauge
and transformed to the realization gauge (default 'nbody', reference
realization_options gauge) before being installed on the
LinearCosmology.  When initial conditions include the fictitious
'metric'/'lapse' species, their δ tables are constructed from the
backend's H_Tʹ/φ/ψ aux tables (reference construct_delta_metric /
construct_delta_lapse, linear.py:845-985).
"""

from __future__ import annotations

import math

import numpy as np

from concept_tpu_torch.utils.terminal import masterprint, masterwarn


def _classy_available() -> bool:
    try:
        import classy  # noqa: F401

        return True
    except Exception:
        return False


def _ic_entries(cfg):
    ics = cfg.initial_conditions
    if ics is None:
        return []
    entries = ics if isinstance(ics, (list, tuple)) else [ics]
    return [e for e in entries if isinstance(e, dict)]


def needs_species_tables(cfg) -> bool:
    """True when the run involves physics the analytic EH layer cannot
    represent faithfully: massive ν, linear photon/ur fluids, GR
    metric/lapse corrections, or Boltzmann-order ≥ 1 fluids."""
    if (cfg.class_params or {}).get("N_ncdm"):
        return True
    for e in _ic_entries(cfg):
        sp = str(e.get("species", ""))
        if any(t in sp for t in ("neutrino", "photon", "metric", "lapse")):
            return True
        border = e.get("boltzmann order", e.get("boltzmann_order"))
        if border is not None and int(border) >= 1:
            return True
    for v in (cfg.select_boltzmann_order or {}).values():
        try:
            if int(v) >= 1:
                return True
        except (TypeError, ValueError):
            pass
    return False


def select_backend(cfg) -> str:
    """Resolve 'auto' to a concrete backend name."""
    b = cfg.boltzmann_backend
    if b != "auto":
        if b == "class" and not _classy_available():
            masterwarn("boltzmann_backend='class' but classy is not importable; "
                       "using the internal Einstein-Boltzmann solver instead")
            return "eb"
        return b
    if _classy_available():
        return "class"
    return "eb" if needs_species_tables(cfg) else "eh"


# --------------------------------------------------------------------- #
def _k_range(cfg, units_):
    """Tabulation k range (internal units) covering every mesh the run
    can touch: fundamental/2 up to 1.1×√3×k_Nyquist of the largest grid."""
    n_max = 64
    for e in _ic_entries(cfg):
        if e.get("gridsize"):
            n_max = max(n_max, int(e["gridsize"]))
        elif e.get("N"):
            n_max = max(n_max, round(int(e["N"]) ** (1 / 3)) * 2)
    po = cfg.potential_options or {}
    gs = po.get("gridsize")
    if isinstance(gs, dict):
        for v in gs.values():
            if isinstance(v, dict):
                for vv in v.values():
                    try:
                        n_max = max(n_max, int(vv))
                    except (TypeError, ValueError):
                        pass
            else:
                try:
                    n_max = max(n_max, int(v))
                except (TypeError, ValueError):
                    pass
    elif gs:
        n_max = max(n_max, int(gs))
    box = cfg.boxsize
    k_min = 0.5 * 2 * math.pi / box
    k_max = 1.1 * math.sqrt(3.0) * math.pi * n_max / box
    return k_min, k_max


def _gauge_callables(lin, nubg, cp=None):
    """Per-species w(a) callables for the gauge transform (w = 0 matter
    default is handled inside to_gauge)."""
    w_of_a = {"photon": lambda a: 1.0 / 3.0, "ur": lambda a: 1.0 / 3.0,
              "dr": lambda a: 1.0 / 3.0}
    if nubg is not None:
        w_of_a["nu"] = lambda a: float(nubg.w(a))
    if cp and cp.get("Omega_fld"):
        w0 = float(cp.get("w0_fld", -1.0))
        wa = float(cp.get("wa_fld", 0.0))
        w_of_a["fld"] = lambda a: w0 + wa * (1.0 - a)
    return w_of_a


def build_tables(cfg, units_, consts, bg, lin, nubg=None, verbose=True):
    """Build TransferTables for the resolved backend and install them on
    lin (lin.tables).  Returns the backend name actually used ('eh'
    installs nothing — the analytic path serves directly)."""
    backend = select_backend(cfg)
    if backend == "eh":
        return backend
    gauge = str((cfg.realization_options or {}).get("gauge", "nbody"))
    a_begin = min(cfg.a_begin, 1e-2)
    a_out = np.logspace(math.log10(a_begin / 5.0), 0.0, 96)
    k_min, k_max = _k_range(cfg, units_)

    if backend == "class":
        from concept_tpu_torch.cosmology.class_bridge import ClassBridge

        bridge = ClassBridge(cfg.class_params)
        tables = bridge.build_tables(lin, a=a_out)
    else:
        from concept_tpu_torch.cosmology.ebsolver import EBParams, tabulate_eb
        from concept_tpu_torch.cosmology.boltzmann import k_grid_log

        opts = cfg.boltzmann_options or {}
        cp = cfg.class_params or {}
        h = lin.h_value
        n_ncdm = int(cp.get("N_ncdm", 0) or 0)
        deg = int(cp.get("deg_ncdm", 1)) if n_ncdm else 0
        m_ncdm = float(cp.get("m_ncdm", 0.0)) if n_ncdm else 0.0
        n_species = n_ncdm * deg
        N_ur = float(cp.get(
            "N_ur", 3.046 if n_species == 0
            else max(3.046 - 1.0132 * n_species, 0.0)
        ))
        # exotic sectors (CLASS key conventions; Gamma_dcdm given in
        # km/s/Mpc → 1/Mpc via /c)
        p = EBParams(
            h=h, Omega_b=cfg.Omega_b, Omega_cdm=cfg.Omega_cdm,
            T_cmb=float(cp.get("T_cmb", 2.7255)),
            N_ur=N_ur, m_ncdm=m_ncdm, N_ncdm=n_species,
            Omega_k=float(cp.get("Omega_k", 0.0)),
            Omega_fld=float(cp.get("Omega_fld", 0.0)),
            w0_fld=float(cp.get("w0_fld", -1.0)),
            wa_fld=float(cp.get("wa_fld", 0.0)),
            Omega_dcdm=float(cp.get("Omega_dcdm", 0.0)),
            Gamma_dcdm=float(cp.get("Gamma_dcdm", 0.0)) / 299792.458,
            l_max_g=int(opts.get("l_max_g", 12)),
            l_max_pol=int(opts.get("l_max_pol", 10)),
            l_max_ur=int(opts.get("l_max_ur", 14)),
            l_max_ncdm=int(opts.get("l_max_ncdm", 8)),
            l_max_dr=int(opts.get("l_max_dr", 14)),
            n_q=int(opts.get("n_q", 8)),
        )
        mpd = int(opts.get("modes_per_decade", 10))
        k_min = float(opts.get("k_min", k_min))
        k_max = float(opts.get("k_max", k_max))
        k_int = k_grid_log(k_min, k_max, mpd)
        cache_dir = str(opts.get("cache_dir", ".reusable/eb"))
        rtol = float(opts.get("rtol", 1e-5))
        if verbose:
            masterprint(
                f"Solving linear Einstein-Boltzmann system "
                f"({len(k_int)} modes, cached in {cache_dir}) ..."
            )
        tables = tabulate_eb(
            p, k_int, Mpc=units_.Mpc, light_speed=consts.light_speed,
            a_out=a_out, rtol=rtol, cache_dir=cache_dir,
            verbose=verbose,
        )
        if verbose:
            masterprint("done")

    # fictitious GR-correction species requested by the ICs
    species_wanted = {str(e.get("species", "")) for e in _ic_entries(cfg)}
    rho_crit = bg.rho_crit_of(consts.G_Newton)
    rho_mean = cfg.Omega_m * rho_crit
    from concept_tpu_torch.cosmology.boltzmann import (
        construct_metric_delta, construct_lapse_delta,
    )

    if "metric" in species_wanted and "H_T_prime" in tables.aux:
        construct_metric_delta(tables, bg, consts.G_Newton,
                               consts.light_speed, rho_mean)
    if "lapse" in species_wanted and "H_T_prime" in tables.aux:
        construct_lapse_delta(tables, bg, consts.G_Newton,
                              consts.light_speed, rho_mean)

    tables = tables.to_gauge(gauge, bg, consts.light_speed,
                             w_of_a=_gauge_callables(lin, nubg,
                                                     cfg.class_params))
    lin.tables = tables
    return backend
